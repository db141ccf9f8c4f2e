// Eq. 3 per-class feature sums and counts, for Hopper (sm_90a).
//
// Replaces repro/kernels/proto_accum/proto_accum.py:proto_accum_pallas.
//   sums[n, c, :] = sum_b 1[labels[n, b] == c] * f1[n, b, :]
//   counts[n, c]  = sum_b 1[labels[n, b] == c]
// Labels outside [0, C) match nothing (the TPU wrapper pads with label C).
//
// What bounds it on the H100: at the main path's shapes (N=20, B=32, P=128,
// C=10) it moves ~0.4 MB, so launch latency, not bytes or flops.  Design: no
// [B, C] one-hot and no atomics.  One block per (node, 64-column chunk of P);
// each thread owns one column and walks the batch in order, adding the row
// into its class's slot of a [C, 64] tile in shared memory — the sequential
// batch-tile order of the TPU kernel, so the result is deterministic.  Row
// reads coalesce across the block's threads.  Block x == 0 also counts
// labels, one thread per class.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunk = 64;

__global__ void proto_accum_kernel(const float* __restrict__ f1,
                                   const int* __restrict__ labels,
                                   float* __restrict__ sums,
                                   float* __restrict__ counts, int batch,
                                   int p_dim, int n_classes) {
  extern __shared__ float tile[];  // [n_classes][kChunk]
  const int node = blockIdx.y;
  const int t = threadIdx.x;
  const int col = blockIdx.x * kChunk + t;
  for (int c = 0; c < n_classes; ++c) tile[c * kChunk + t] = 0.f;
  const float* f = f1 + (int64_t)node * batch * p_dim;
  const int* lab = labels + (int64_t)node * batch;
  if (col < p_dim) {
    // each thread reads and writes only its own column of the tile
    for (int b = 0; b < batch; ++b) {
      const int c = lab[b];
      if (c >= 0 && c < n_classes)
        tile[c * kChunk + t] =
            __fadd_rn(tile[c * kChunk + t], f[(int64_t)b * p_dim + col]);
    }
    for (int c = 0; c < n_classes; ++c)
      sums[((int64_t)node * n_classes + c) * p_dim + col] =
          tile[c * kChunk + t];
  }
  if (blockIdx.x == 0) {
    for (int c = t; c < n_classes; c += blockDim.x) {
      float cnt = 0.f;
      for (int b = 0; b < batch; ++b) cnt += (lab[b] == c) ? 1.f : 0.f;
      counts[(int64_t)node * n_classes + c] = cnt;
    }
  }
}

}  // namespace

extern "C" int proto_accum(const float* f1, const int* labels, float* sums,
                           float* counts, int n_nodes, int batch, int p_dim,
                           int n_classes, cudaStream_t stream) {
  if (n_nodes > 0 && p_dim > 0 && n_classes > 0) {
    dim3 grid((p_dim + kChunk - 1) / kChunk, n_nodes);
    const size_t smem = (size_t)n_classes * kChunk * sizeof(float);
    proto_accum_kernel<<<grid, kChunk, smem, stream>>>(
        f1, labels, sums, counts, batch, p_dim, n_classes);
  }
  return (int)cudaGetLastError();
}
