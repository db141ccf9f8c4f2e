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
// The per-leaf and per-tensor codec:
// quantize_dequantize_rows replaces quantize.py:quantize_dequantize_rows_pallas
// (the dequant branch of _rows_call): the quantize_rows sweep writing
//   out[r, c] = codes[r, c] * delta[r]   (fp32; the codes never land)
// dequantize_rows replaces quantize.py:dequantize_rows_pallas:
//   out[r, c] = codes[r, c] * delta[r]   (int32 codes in)
// dequantize replaces quantize.py:dequantize_pallas: the same with one
// scalar delta, read from device memory (it comes from fused_quantize on
// the card, so no host round trip).
// fused_quantize and fused_quantize_dequantize replace
// quantize.py:fused_quantize_pallas and fused_quantize_dequantize_pallas
// (body _fused_quantize_kernel), the whole-tensor scalar-delta codec:
//   delta = max(max|x| / qmax, FLT_MIN);  codes = clip(floor(x / delta +
//   0.5), -qmax - 1, qmax);  out = codes (int32) or codes * delta (fp32)
//
// What bounds them on the H100: bytes.  rowabs reads 4 B per element and
// writes 4 B per row; quantize_rows reads 4 B and writes a 4 B int32 code
// per element (narrowing straight to the int16 wire type is later work);
// quantize_rows_mixed the same plus 4 B per row; rowabs_sum reads 8 B per
// element; quantize_rows_ef reads 8 B and writes 8 B per element; mix_packed
// reads 4 B of own and 4 B of code per sender for each output and writes 4 B;
// quantize_dequantize_rows, dequantize_rows and dequantize read 4 B and
// write 4 B per element; fused_quantize(_dequantize) must read 4 B and
// write 4 B per element too, but reads x twice (see below).
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
// quantize_dequantize_rows is quantize_rows' body with the output type a
// template parameter (float: write code * delta, rounded on its own, as
// mix_packed's code type is one).  dequantize_rows and dequantize share
// one grid-stride body, templated on whether delta is per row.
// fused_quantize(_dequantize) needs a grid-wide max before any code can be
// written, and blocks cannot wait on each other outside a cooperative
// launch, so it takes two launches on one stream: cudaMemsetAsync zeroes a
// device word; launch 1 reduces |x| per block (grid-stride, warp shuffles,
// then one warp over the block's warp maxima) and atomicMax-es the bits of
// the block's non-negative maximum into that word (unsigned order is float
// order for non-negative floats, and max is order-free, so the result is
// bit-exact whatever order the blocks land in); launch 2 has every thread
// derive delta from the word (one IEEE division) and sweep the codes, and
// thread 0 of block 0 writes delta out.  The sweep reads x a second time
// (from L2 while x fits its 50 MB).  A cooperative launch with grid.sync()
// would save the second launch; two plain launches need no occupancy
// guarantee and no cooperative-launch API, and are what this first version
// takes.
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <type_traits>

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

// OutT int: the codes; OutT float: the round trip code * delta
template <typename OutT>
__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     const float* __restrict__ row_delta,
                                     OutT* __restrict__ out, int64_t n,
                                     int cols, float qmax) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float delta = row_delta[i / cols];
    float q = floorf(__fadd_rn(__fdiv_rn(x[i], delta), 0.5f));
    q = fminf(fmaxf(q, -qmax - 1.f), qmax);
    if constexpr (std::is_same<OutT, float>::value)
      out[i] = __fmul_rn(q, delta);
    else
      out[i] = (int)q;
  }
}

// PerRow: delta[i / cols]; else the scalar delta[0]
template <bool PerRow>
__global__ void dequantize_kernel(const int* __restrict__ codes,
                                  const float* __restrict__ delta,
                                  float* __restrict__ out, int64_t n,
                                  int cols) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __fmul_rn((float)codes[i], delta[PerRow ? i / cols : 0]);
}

// launch 1 of the fused codec: the grid-wide max|x| into *amax_bits
// (zeroed before the launch); blockDim.x a multiple of 32, at most 1024
__global__ void absmax_kernel(const float* __restrict__ x,
                              unsigned* __restrict__ amax_bits, int64_t n) {
  __shared__ float warp_max[32];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float m = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    m = fmaxf(m, fabsf(x[i]));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(amax_bits, __float_as_uint(m));
  }
}

// launch 2 of the fused codec: delta from the max, then the codes (OutT
// int) or the round trip (OutT float)
template <typename OutT>
__global__ void fused_quantize_kernel(const float* __restrict__ x,
                                      const unsigned* __restrict__ amax_bits,
                                      OutT* __restrict__ out,
                                      float* __restrict__ delta_out,
                                      int64_t n, float qmax) {
  const float delta =
      fmaxf(__fdiv_rn(__uint_as_float(*amax_bits), qmax), FLT_MIN);
  if (blockIdx.x == 0 && threadIdx.x == 0) *delta_out = delta;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float q = floorf(__fadd_rn(__fdiv_rn(x[i], delta), 0.5f));
    q = fminf(fmaxf(q, -qmax - 1.f), qmax);
    if constexpr (std::is_same<OutT, float>::value)
      out[i] = __fmul_rn(q, delta);
    else
      out[i] = (int)q;
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

static int64_t sweep_blocks(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return blocks > 132 * 32 ? 132 * 32 : blocks;
}

extern "C" int quantize_rows(const float* x, const float* row_delta,
                             int* codes, int64_t rows, int cols, float qmax,
                             cudaStream_t stream) {
  const int64_t n = rows * cols;
  if (n > 0)
    quantize_rows_kernel<int><<<(unsigned)sweep_blocks(n, 256), 256, 0,
                                stream>>>(x, row_delta, codes, n, cols, qmax);
  return (int)cudaGetLastError();
}

extern "C" int quantize_dequantize_rows(const float* x,
                                        const float* row_delta, float* out,
                                        int64_t rows, int cols, float qmax,
                                        cudaStream_t stream) {
  const int64_t n = rows * cols;
  if (n > 0)
    quantize_rows_kernel<float><<<(unsigned)sweep_blocks(n, 256), 256, 0,
                                  stream>>>(x, row_delta, out, n, cols, qmax);
  return (int)cudaGetLastError();
}

extern "C" int dequantize_rows(const int* codes, const float* row_delta,
                               float* out, int64_t rows, int cols,
                               cudaStream_t stream) {
  const int64_t n = rows * cols;
  if (n > 0)
    dequantize_kernel<true><<<(unsigned)sweep_blocks(n, 256), 256, 0,
                              stream>>>(codes, row_delta, out, n, cols);
  return (int)cudaGetLastError();
}

extern "C" int dequantize(const int* codes, const float* delta, float* out,
                          int64_t n, cudaStream_t stream) {
  if (n > 0)
    dequantize_kernel<false><<<(unsigned)sweep_blocks(n, 256), 256, 0,
                               stream>>>(codes, delta, out, n, 1);
  return (int)cudaGetLastError();
}

// the fused codec's two launches; scratch is one device word
template <typename OutT>
static int fused_quantize_launch(const float* x, OutT* out, float* delta,
                                 unsigned* scratch, int64_t n, float qmax,
                                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;  // no max of nothing
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)sweep_blocks(n, 256);
  absmax_kernel<<<blocks, 256, 0, stream>>>(x, scratch, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_quantize_kernel<OutT><<<blocks, 256, 0, stream>>>(x, scratch, out,
                                                          delta, n, qmax);
  return (int)cudaGetLastError();
}

extern "C" int fused_quantize(const float* x, int* codes, float* delta,
                              void* scratch, int64_t n, float qmax,
                              cudaStream_t stream) {
  return fused_quantize_launch<int>(x, codes, delta, (unsigned*)scratch, n,
                                    qmax, stream);
}

extern "C" int fused_quantize_dequantize(const float* x, float* out,
                                         float* delta, void* scratch,
                                         int64_t n, float qmax,
                                         cudaStream_t stream) {
  return fused_quantize_launch<float>(x, out, delta, (unsigned*)scratch, n,
                                      qmax, stream);
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
