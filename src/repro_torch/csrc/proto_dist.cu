// Eq. 5 pairwise squared prototype distances, for Hopper (sm_90a).
//
// Replaces repro/kernels/proto_dist/proto_dist.py:proto_dist_pallas.
//   d2[n, c] = max(||x_n||^2 - 2 x_n.p_c + ||p_c||^2, 0)
// x [N, P] and protos [C, P], both fp32 or both bf16 (cast to fp32 on load,
// as the TPU kernel does), d2 [N, C] fp32.
//
// What bounds it on the H100: at Eq. 5's shapes (a test split of 640
// features against 10 or 100 classes, P = 128 or 256) it reads under 1 MB and
// does a few MFLOP, so launch latency, not bytes or flops.  Design, simple
// and right: one block of 32x8 threads per 32x32 output tile; x's and p's
// tile rows are staged through shared memory in 32-wide chunks of P and each
// thread keeps 4 outputs of one column, its rows' ||x||^2 and its column's
// ||p||^2 in fp32 registers (the norms are recomputed per thread: 5 extra
// multiply-adds per 4 outputs).  The cross term is this loop's own (no
// cuBLAS, no TF32), as the Pallas body's dot_general is its own; each
// product is a correctly rounded fmaf.  Ragged N and C are bounds-checked in
// the kernel: out-of-range rows stage zeros and store nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 32;                  // output rows and columns a block
constexpr int kRowsPerPass = 8;            // blockDim.y
constexpr int kRows = kTile / kRowsPerPass;  // outputs a thread
constexpr int kChunk = 32;                 // P elements staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void proto_dist_kernel(const T* __restrict__ x,
                                  const T* __restrict__ p,
                                  float* __restrict__ out, int n, int c,
                                  int p_dim) {
  __shared__ float xs[kTile][kChunk + 1];
  __shared__ float ps[kTile][kChunk + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * kTile + tx;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int64_t col0 = (int64_t)blockIdx.y * kTile;
  float xc[kRows], x2[kRows], p2 = 0.f;
#pragma unroll
  for (int q = 0; q < kRows; ++q) xc[q] = x2[q] = 0.f;

  for (int k0 = 0; k0 < p_dim; k0 += kChunk) {
    // stage both [32, 32] tiles: each thread loads 4 elements of each,
    // neighbouring threads along P
    for (int e = t; e < kTile * kChunk; e += kTile * kRowsPerPass) {
      const int r = e / kChunk, k = k0 + e % kChunk;
      const bool in_k = k < p_dim;
      xs[r][e % kChunk] = (in_k && row0 + r < n)
                              ? to_f32(x[(row0 + r) * p_dim + k]) : 0.f;
      ps[r][e % kChunk] = (in_k && col0 + r < c)
                              ? to_f32(p[(col0 + r) * p_dim + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float pv = ps[tx][k];
      p2 = fmaf(pv, pv, p2);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const float xv = xs[ty + q * kRowsPerPass][k];  // warp broadcast
        xc[q] = fmaf(xv, pv, xc[q]);
        x2[q] = fmaf(xv, xv, x2[q]);
      }
    }
    __syncthreads();
  }

  const int64_t col = col0 + tx;
  if (col >= c) return;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int64_t row = row0 + ty + q * kRowsPerPass;
    if (row < n)
      out[row * c + col] = fmaxf(x2[q] - 2.f * xc[q] + p2, 0.f);
  }
}

template <typename T>
int launch(const void* x, const void* p, float* out, int n, int c, int p_dim,
           cudaStream_t stream) {
  if (n > 0 && c > 0) {
    dim3 grid((n + kTile - 1) / kTile, (c + kTile - 1) / kTile);
    proto_dist_kernel<T><<<grid, dim3(kTile, kRowsPerPass), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(p), out, n, c, p_dim);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: x and protos are bf16, else fp32.
extern "C" int proto_dist(const void* x, const void* protos, float* out,
                          int n, int c, int p_dim, int bf16,
                          cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(x, protos, out, n, c, p_dim, stream)
              : launch<float>(x, protos, out, n, c, p_dim, stream);
}
