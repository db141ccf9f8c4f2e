// Eq. 3 per-class feature sums and counts, for Hopper (sm_90a).
//
// Replaces repro/kernels/proto_accum/proto_accum.py:proto_accum_pallas.
//   sums[n, c, :] = sum_b 1[labels[n, b] == c] * f1[n, b, :]
//   counts[n, c]  = sum_b 1[labels[n, b] == c]
// Labels outside [0, C) match nothing (the TPU wrapper pads with label C).
//
// What bounds it on the H100: at the main path's shapes (N=20, B=32, P=128,
// C=10) it moves ~0.4 MB, so latency: the launch, and inside the kernel the
// trips to device memory and the dependent steps of the walk.  Design: no
// [B, C] one-hot and no atomics.  One block of kThreads per (node,
// kCols-column chunk of P) stages its node's labels and its [rows, kCols]
// slab of f1 into shared memory with cp.async, every copy started before the
// first is waited on (16-byte copies where the rows are aligned), so the
// staging is one trip to device memory.  Then each thread owns (class,
// column) pairs and walks the batch in order, adding the rows of its class
// into a register: no shared-memory store inside the walk, so its loads
// run ahead, and a warp's 32 pairs share one class, so the label test does
// not diverge.  The adds are those of the plain version
// proto_accum_batch_order (ref.py), in its order, so the sums are
// bit-identical to it.  The pair's column-0 thread counts.  A batch longer
// than kRows is staged in chunks of kRows rows, the next chunk in flight
// while this one is walked; a pair's sum waits in shared memory between
// chunks.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kCols = 32;        // columns a block owns
constexpr int kThreads = 128;
constexpr int kRows = 128;       // batch rows a staged chunk

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The rows a staged chunk holds, and the chunk buffers (one when the batch
// fits one chunk, else two).
__host__ __device__ inline int chunk_rows(int batch) {
  return batch < kRows ? batch : kRows;
}
__host__ __device__ inline int chunk_bufs(int batch) {
  return batch > kRows ? 2 : 1;
}

// Rows [b0, b0 + rows) of the node's labels and of f1's columns
// [c0, c0 + kCols) into one chunk buffer.
__device__ __forceinline__ void stage_chunk(float* slab, int* labs,
                                            const float* f, const int* lab,
                                            int b0, int rows, int p_dim,
                                            int c0, bool vec) {
  if (vec) {   // p_dim % 4 == 0 and f1 16-byte aligned: whole 16-byte quads
    for (int e = threadIdx.x; e < rows * (kCols / 4); e += kThreads) {
      const int row = e / (kCols / 4), c4 = (e % (kCols / 4)) * 4;
      if (c0 + c4 < p_dim)
        cp_async16(slab + row * kCols + c4,
                   f + (int64_t)(b0 + row) * p_dim + c0 + c4);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kCols; e += kThreads) {
      const int row = e / kCols, c = e % kCols;
      if (c0 + c < p_dim)
        cp_async4(slab + e, f + (int64_t)(b0 + row) * p_dim + c0 + c);
    }
  }
  for (int e = threadIdx.x; e < rows; e += kThreads)
    cp_async4(labs + e, lab + b0 + e);
}

__global__ void __launch_bounds__(kThreads)
proto_accum_kernel(const float* __restrict__ f1,
                   const int* __restrict__ labels, float* __restrict__ sums,
                   float* __restrict__ counts, int batch, int p_dim,
                   int n_classes) {
  extern __shared__ __align__(16) float smem[];
  const int rows_max = chunk_rows(batch), bufs = chunk_bufs(batch);
  float* slab = smem;                                  // [bufs][rows][kCols]
  float* tile = slab + bufs * rows_max * kCols;        // [C][kCols]
  float* cnt = tile + n_classes * kCols;               // [C]
  int* labs = reinterpret_cast<int*>(cnt + n_classes); // [bufs][rows]
  const int node = blockIdx.y;
  const int c0 = blockIdx.x * kCols;
  const float* f = f1 + (int64_t)node * batch * p_dim;
  const int* lab = labels + (int64_t)node * batch;
  const bool vec = p_dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(f1) % 16 == 0;
  const int n_chunks = (batch + kRows - 1) / kRows;
  const int pairs = n_classes * kCols;

  if (n_chunks > 0)
    stage_chunk(slab, labs, f, lab, 0, chunk_rows(batch), p_dim, c0, vec);
  cp_async_commit();
  // tile slot p and cnt[p / kCols] belong to the thread that owns pair p
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    tile[p] = 0.f;
    if (p % kCols == 0) cnt[p / kCols] = 0.f;
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int b0 = ch * kRows;
    const int rows = min(kRows, batch - b0);
    if (ch + 1 < n_chunks) {
      const int nb = (ch + 1) % bufs;
      stage_chunk(slab + nb * rows_max * kCols, labs + nb * rows_max, f, lab,
                  b0 + kRows, min(kRows, batch - b0 - kRows), p_dim, c0, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this chunk's copies (this thread's) ...
    __syncthreads();      // ... and everyone's
    const float* s = slab + (ch % bufs) * rows_max * kCols;
    const int* lb = labs + (ch % bufs) * rows_max;
    // a warp holds 32 columns of one class: the label test is uniform
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int c = p / kCols, col = p % kCols;
      float acc = tile[p], n = 0.f;
      for (int b = 0; b < rows; ++b) {
        if (lb[b] == c) {
          acc = __fadd_rn(acc, s[b * kCols + col]);
          n += 1.f;
        }
      }
      tile[p] = acc;
      if (col == 0) cnt[c] += n;   // whole numbers: exact in any grouping
    }
    __syncthreads();      // the walk is done with this chunk's buffer
  }

  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int c = p / kCols, col = c0 + p % kCols;
    if (col < p_dim)
      sums[((int64_t)node * n_classes + c) * p_dim + col] = tile[p];
    if (blockIdx.x == 0 && p % kCols == 0)
      counts[(int64_t)node * n_classes + c] = cnt[c];
  }
}

}  // namespace

extern "C" int proto_accum(const float* f1, const int* labels, float* sums,
                           float* counts, int n_nodes, int batch, int p_dim,
                           int n_classes, cudaStream_t stream) {
  if (n_nodes > 0 && p_dim > 0 && n_classes > 0) {
    // the layout of proto_accum_kernel's shared memory; the wrapper's
    // MAX_CLASSES (kernels/proto_accum/proto_accum.py) keeps it in a block
    const size_t smem =
        sizeof(float) * ((size_t)chunk_bufs(batch) * chunk_rows(batch) *
                             (kCols + 1) +
                         (size_t)n_classes * (kCols + 1));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          proto_accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((p_dim + kCols - 1) / kCols, n_nodes);
    proto_accum_kernel<<<grid, kThreads, smem, stream>>>(
        f1, labels, sums, counts, batch, p_dim, n_classes);
  }
  return (int)cudaGetLastError();
}
