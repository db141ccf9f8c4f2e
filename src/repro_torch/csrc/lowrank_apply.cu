// Fused low-rank apply of the adapter-rank wire, for Hopper (sm_90a).
//
// Replaces repro/kernels/lowrank_apply/lowrank_apply.py:lowrank_apply_pallas.
// For every receiver i, lead slice l and output element (row, col):
//   dot_j = sum_t B[j, l, row, t] * A[(i,) j, l, t, col]      (t in order)
//   out   = w + sum_j c[i, j] * dot_j                          (j in order)
// A is shared [S, L, r, k] (naive merge) or per receiver [N, S, L, r, k]
// (RegMean).  S = 0 copies w.  Every operation is an _rn intrinsic and the
// file is built with -fmad=false, so the result is bit-identical to the
// plain version (kernels/lowrank_apply/ref.py), which spells the same
// operations in the same order.
//
// What bounds it on the H100, at fc1's shapes (N = S = 20, d = 1568,
// k = 128, r = 8), with 33 MB of reads and writes (0.010 ms): per receiver
// (RegMean) the function needs N*d*k*S*(2r+2) = 1.45 GFLOP of fp32, 0.022 ms,
// so operations; with A shared each B_j @ A_j serves every receiver, so it
// needs 0.23 GFLOP and is bound by its bytes.  This kernel does the 1.45
// GFLOP in both variants (each sender's product once per receiver), and
// its multiplies and adds stay unfused for bit-exactness, so the card's
// FMA rate halves: 0.043 ms at best.
// Design: one block per (receiver, lead slice, 64x32 output tile), 256
// threads; a thread owns 8 consecutive rows of one column, a warp 32
// neighbouring columns, and keeps its 8 outputs in registers across all
// senders.  For each sender the block stages B's [64, r] tile transposed
// ([r][64]) and A's [r, 32] tile in shared memory (the rank axis is
// never split).  Per rank step t a thread then reads one A value and its 8
// B values as two 16-byte broadcast loads, for 16 flops: shared memory
// keeps up with the fp32 units.  The per-sender [d, k] product never
// reaches device memory.  w and out are [N, L, d, k] with any distance
// between nodes (a row span of the parameter plane) and may be the same
// memory: each element is read and then written by one thread.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileD = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 256;
constexpr int kRows = kTileD / (kThreads / kTileK);   // 8 rows a thread

__global__ void lowrank_apply_kernel(const float* w, float* out,
                                     const float* __restrict__ coeffs,
                                     const float* __restrict__ b,
                                     const float* __restrict__ a,
                                     int n_send, int lead, int d, int k,
                                     int r, int per_recv, int64_t w_stride,
                                     int64_t out_stride, int tiles_k) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                     // [r][kTileD], B transposed
  float* as = smem + r * kTileD;        // [r][kTileK]
  const int i = blockIdx.z;
  const int l = blockIdx.y;
  const int d0 = (blockIdx.x / tiles_k) * kTileD;
  const int k0 = (blockIdx.x % tiles_k) * kTileK;
  const int tx = threadIdx.x % kTileK;
  const int row0 = (threadIdx.x / kTileK) * kRows;    // within the tile
  float acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.f;

  for (int j = 0; j < n_send; ++j) {
    const float cij = coeffs[(int64_t)i * n_send + j];
    const float* bj = b + ((int64_t)j * lead + l) * d * r;
    const int64_t a_slot = (per_recv ? (int64_t)i * n_send : 0) + j;
    const float* aj = a + (a_slot * lead + l) * r * k;
    __syncthreads();  // the previous sender's tiles are consumed
    // t-major, so that the index math is shifts (no division by r) and
    // the shared-memory stores are consecutive; the strided global reads
    // of one B row hit the same sectors across t (L1)
    for (int e = threadIdx.x; e < r * kTileD; e += kThreads) {
      const int t = e / kTileD, row = e % kTileD;
      bs[t * kTileD + row] =
          d0 + row < d ? bj[(int64_t)(d0 + row) * r + t] : 0.f;
    }
    for (int e = threadIdx.x; e < r * kTileK; e += kThreads) {
      const int col = k0 + e % kTileK;
      as[e] = col < k ? aj[(int64_t)(e / kTileK) * k + col] : 0.f;
    }
    __syncthreads();
    // dot[q] = sum_t B[row q, t] * A[t, col], from the t = 0 product
    float dot[kRows];
    {
      const float at = as[tx];
      const float4 lo = *reinterpret_cast<const float4*>(bs + row0);
      const float4 hi = *reinterpret_cast<const float4*>(bs + row0 + 4);
      const float bv[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = 0; q < kRows; ++q) dot[q] = __fmul_rn(bv[q], at);
    }
    for (int t = 1; t < r; ++t) {
      const float at = as[t * kTileK + tx];
      const float* bt = bs + t * kTileD + row0;
      const float4 lo = *reinterpret_cast<const float4*>(bt);
      const float4 hi = *reinterpret_cast<const float4*>(bt + 4);
      const float bv[kRows] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        dot[q] = __fadd_rn(dot[q], __fmul_rn(bv[q], at));
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float term = __fmul_rn(cij, dot[q]);
      acc[q] = j == 0 ? term : __fadd_rn(acc[q], term);
    }
  }

  const int col = k0 + tx;
  if (col >= k) return;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = d0 + row0 + q;
    if (row < d) {
      const int64_t off = ((int64_t)l * d + row) * k + col;
      const float wv = w[i * w_stride + off];
      out[i * out_stride + off] = n_send > 0 ? __fadd_rn(wv, acc[q]) : wv;
    }
  }
}

}  // namespace

extern "C" int lowrank_apply(const float* w, float* out, const float* coeffs,
                             const float* b, const float* a, int n_nodes,
                             int n_send, int lead, int d, int k, int r,
                             int per_recv, int64_t w_stride,
                             int64_t out_stride, cudaStream_t stream) {
  if (n_nodes > 0 && lead > 0 && d > 0 && k > 0 && r > 0) {
    const int tiles_k = (k + kTileK - 1) / kTileK;
    const int tiles_d = (d + kTileD - 1) / kTileD;
    dim3 grid(tiles_d * tiles_k, lead, n_nodes);
    const size_t smem = (size_t)(kTileD + kTileK) * r * sizeof(float);
    lowrank_apply_kernel<<<grid, kThreads, smem, stream>>>(
        w, out, coeffs, b, a, n_send, lead, d, k, r, per_recv, w_stride,
        out_stride, tiles_k);
  }
  return (int)cudaGetLastError();
}
