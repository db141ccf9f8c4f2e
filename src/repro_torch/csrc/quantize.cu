// Row-scaled wire quantization of the packed [R, C] payload, for Hopper
// (sm_90a).
//
// rowabs replaces repro/kernels/quantize/quantize.py:rowabs_pallas:
//   out[r] = max_c |x[r, c]|
// quantize_rows replaces quantize.py:quantize_rows_pallas (via _rows_call):
//   codes[r, c] = clip(floor(x[r, c] / delta[r] + 0.5), -qmax - 1, qmax)
//
// What bounds them on the H100: bytes.  rowabs reads 4 B per element and
// writes 4 B per row; quantize_rows reads 4 B and writes a 4 B int32 code
// per element (narrowing straight to the int16 wire type is later work).
// Design: rowabs gives each row to one warp — lanes stride the row, so loads
// coalesce, and a shuffle reduction takes the max; no block ever needs a
// partial from another (the TPU kernel masked out-of-bounds lanes of its
// edge blocks; here the loop bound does).  quantize_rows is a grid-stride
// elementwise sweep with the row's delta indexed by i / cols.  The division
// is the IEEE one (__fdiv_rn), not a reciprocal multiply, and the + 0.5
// rounds on its own, so the codes are bit-identical to the plain version.
// fmaxf ignores a NaN where torch.amax would propagate it; wire payloads
// are finite.
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
