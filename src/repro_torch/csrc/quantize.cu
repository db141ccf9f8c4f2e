// Row-scaled wire quantization of the packed [R, C] payload, for Hopper
// (sm_90a).
//
// rowabs replaces repro/kernels/quantize/quantize.py:rowabs_pallas:
//   out[r] = max_c |x[r, c]|
// quantize_rows replaces quantize.py:quantize_rows_pallas (via _rows_call):
//   codes[r, c] = clip(floor(x[r, c] / delta[r] + 0.5), -qmax - 1, qmax)
// quantize_rows_mixed replaces quantize.py:quantize_rows_mixed_pallas: the
// same codes with qmax read per row from a [R] column, so the int16
// prototype rows and the int4 student rows of a mixed-width wire share one
// launch.
// rowabs_sum replaces quantize.py:rowabs_sum_pallas, the absmax sweep of the
// error-feedback codec:
//   out[r] = max_c |x[r, c] + decay * res[r, c]|
// quantize_rows_ef replaces quantize.py:quantize_rows_ef_pallas, the
// error-feedback sweep in one launch:
//   eff = x + decay * res;  codes = clip(floor(eff / delta[r] + 0.5),
//   -qmax[r] - 1, qmax[r]);  new_res = eff - codes * delta[r]
//
// mix_packed replaces quantize.py:mix_packed_pallas (body _mix_packed_kernel),
// the receiver side of the mesh exchange: the senders' wire codes are
// dequantized and folded into the gossip mix in one pass,
//   out[m] = w_self[m] * own[m] + sum_j w_rows[m, j] * (codes[j] * delta[j])
// with int32 codes, or fp32 "codes" (raw buffers at unit delta) that never
// round-trip through an int.
//
// What bounds them on the H100: bytes.  rowabs reads 4 B per element and
// writes 4 B per row; quantize_rows reads 4 B and writes a 4 B int32 code
// per element (narrowing straight to the int16 wire type is later work);
// quantize_rows_mixed the same plus 4 B per row; rowabs_sum reads 8 B per
// element; quantize_rows_ef reads 8 B and writes 8 B per element; mix_packed
// reads 4 B of own and 4 B of code per sender for each output and writes 4 B.
// Design: the row reductions give each row to one warp — lanes stride the
// row, so loads coalesce, and a shuffle reduction takes the max; no block
// ever needs a partial from another (the TPU kernels masked out-of-bounds
// lanes of their edge blocks; here the loop bound does).  rowabs_sum adds
// the residual in registers, so the effective payload never lands in
// memory.  The code sweeps are grid-stride elementwise loops with the
// row's delta (and qmax) indexed by i / cols; quantize_rows_ef writes the
// codes and the new residual from the same registers.  Every operation is
// a _rn intrinsic in the plain version's order — the division is the IEEE
// one (__fdiv_rn), not a reciprocal multiply, the + 0.5 rounds on its own,
// and with -fmad=false no multiply fuses into an add — so codes and
// residuals are bit-identical to the plain versions.  fmaxf ignores a NaN
// where torch.amax would propagate it; wire payloads are finite.
// mix_packed is a grid-stride sweep over the M * R * C outputs: each thread
// keeps its accumulator in a register and walks the senders in order, in
// the Pallas body's order (acc = w_self * own, then acc + w * (code * delta)
// per sender, each product and sum rounded on its own), so it is
// bit-identical to mix_packed_ref.  It reads a sender's codes once per
// receiver (from L2 at the mesh round's sizes); reading each code once for
// all M receivers is later work.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void rowabs_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int64_t rows,
                              int cols) {
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float* r = x + row * cols;
  float m = 0.f;
  for (int c = lane; c < cols; c += 32) m = fmaxf(m, fabsf(r[c]));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[row] = m;
}

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const float* __restrict__ row_delta,
                                     int* __restrict__ codes, int64_t n,
                                     int cols, float qmax) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float q = floorf(__fadd_rn(__fdiv_rn(x[i], row_delta[i / cols]), 0.5f));
    q = fminf(fmaxf(q, -qmax - 1.f), qmax);
    codes[i] = (int)q;
  }
}

__global__ void quantize_rows_mixed_kernel(const float* __restrict__ x,
                                           const float* __restrict__ row_delta,
                                           const float* __restrict__ row_qmax,
                                           int* __restrict__ codes, int64_t n,
                                           int cols) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = i / cols;
    const float qmax = row_qmax[r];
    float q = floorf(__fadd_rn(__fdiv_rn(x[i], row_delta[r]), 0.5f));
    q = fminf(fmaxf(q, __fsub_rn(-qmax, 1.f)), qmax);
    codes[i] = (int)q;
  }
}

__global__ void rowabs_sum_kernel(const float* __restrict__ x,
                                  const float* __restrict__ res,
                                  float* __restrict__ out, int64_t rows,
                                  int cols, float decay) {
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float* xr = x + row * cols;
  const float* rr = res + row * cols;
  float m = 0.f;
  for (int c = lane; c < cols; c += 32)
    m = fmaxf(m, fabsf(__fadd_rn(xr[c], __fmul_rn(decay, rr[c]))));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[row] = m;
}

__global__ void quantize_rows_ef_kernel(const float* __restrict__ x,
                                        const float* __restrict__ res,
                                        const float* __restrict__ row_delta,
                                        const float* __restrict__ row_qmax,
                                        int* __restrict__ codes,
                                        float* __restrict__ new_res,
                                        int64_t n, int cols, float decay) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t r = i / cols;
    const float delta = row_delta[r];
    const float qmax = row_qmax[r];
    const float eff = __fadd_rn(x[i], __fmul_rn(decay, res[i]));
    float q = floorf(__fadd_rn(__fdiv_rn(eff, delta), 0.5f));
    q = fminf(fmaxf(q, __fsub_rn(-qmax, 1.f)), qmax);
    codes[i] = (int)q;
    new_res[i] = __fsub_rn(eff, __fmul_rn(q, delta));
  }
}

template <typename CodeT>
__global__ void mix_packed_kernel(const float* __restrict__ own,
                                  const CodeT* __restrict__ codes,
                                  const float* __restrict__ row_delta,
                                  const float* __restrict__ w_self,
                                  const float* __restrict__ w_rows,
                                  float* __restrict__ out, int m, int s,
                                  int64_t rows, int cols) {
  const int64_t per = rows * cols;  // one receiver's (or sender's) buffer
  const int64_t n = (int64_t)m * per;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t recv = i / per;
    const int64_t e = i - recv * per;
    const int64_t row = e / cols;
    float acc = __fmul_rn(w_self[recv], own[i]);
    for (int j = 0; j < s; ++j) {
      const float deq = __fmul_rn((float)codes[j * per + e],
                                  row_delta[j * rows + row]);
      acc = __fadd_rn(acc, __fmul_rn(w_rows[recv * s + j], deq));
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" int rowabs(const float* x, float* out, int64_t rows, int cols,
                      cudaStream_t stream) {
  if (rows > 0) {
    const int threads = 256;  // 8 rows per block
    const int64_t blocks = (rows + 7) / 8;
    rowabs_kernel<<<(unsigned)blocks, threads, 0, stream>>>(x, out, rows,
                                                             cols);
  }
  return (int)cudaGetLastError();
}

extern "C" int quantize_rows(const float* x, const float* row_delta,
                             int* codes, int64_t rows, int cols, float qmax,
                             cudaStream_t stream) {
  const int64_t n = rows * cols;
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    quantize_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        x, row_delta, codes, n, cols, qmax);
  }
  return (int)cudaGetLastError();
}

static int64_t sweep_blocks(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return blocks > 132 * 32 ? 132 * 32 : blocks;
}

extern "C" int quantize_rows_mixed(const float* x, const float* row_delta,
                                   const float* row_qmax, int* codes,
                                   int64_t rows, int cols,
                                   cudaStream_t stream) {
  const int64_t n = rows * cols;
  if (n > 0)
    quantize_rows_mixed_kernel<<<(unsigned)sweep_blocks(n, 256), 256, 0,
                                 stream>>>(x, row_delta, row_qmax, codes, n,
                                           cols);
  return (int)cudaGetLastError();
}

extern "C" int rowabs_sum(const float* x, const float* res, float* out,
                          int64_t rows, int cols, float decay,
                          cudaStream_t stream) {
  if (rows > 0)
    rowabs_sum_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        x, res, out, rows, cols, decay);
  return (int)cudaGetLastError();
}

extern "C" int quantize_rows_ef(const float* x, const float* res,
                                const float* row_delta, const float* row_qmax,
                                int* codes, float* new_res, int64_t rows,
                                int cols, float decay, cudaStream_t stream) {
  const int64_t n = rows * cols;
  if (n > 0)
    quantize_rows_ef_kernel<<<(unsigned)sweep_blocks(n, 256), 256, 0,
                              stream>>>(x, res, row_delta, row_qmax, codes,
                                        new_res, n, cols, decay);
  return (int)cudaGetLastError();
}

extern "C" int mix_packed(const float* own, const void* codes,
                          const float* row_delta, const float* w_self,
                          const float* w_rows, float* out, int m, int s,
                          int64_t rows, int cols, int float_codes,
                          cudaStream_t stream) {
  const int64_t n = (int64_t)m * rows * cols;
  if (n > 0) {
    const unsigned blocks = (unsigned)sweep_blocks(n, 256);
    if (float_codes)
      mix_packed_kernel<float><<<blocks, 256, 0, stream>>>(
          own, (const float*)codes, row_delta, w_self, w_rows, out, m, s,
          rows, cols);
    else
      mix_packed_kernel<int><<<blocks, 256, 0, stream>>>(
          own, (const int*)codes, row_delta, w_self, w_rows, out, m, s, rows,
          cols);
  }
  return (int)cudaGetLastError();
}
