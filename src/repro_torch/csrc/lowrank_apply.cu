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
// k = 128, r = 8), with 33 MB of reads and writes (0.010 ms): with A shared
// each B_j @ A_j serves every receiver, so the function needs 0.23 GFLOP
// and is bound by its bytes; per receiver every B_j @ A~_ij is its own,
// N*d*k*S*(2r+2) = 1.45 GFLOP, 0.022 ms at the fp32 peak, so operations --
// and the multiplies and adds stay unfused for bit-exactness, which halves
// the rate: 0.043 ms at best.
//
// Two designs; the launch plan (kernels/lowrank_apply/lowrank_apply.py,
// lowrank_plan) picks one, its ring depth and its dynamic shared memory.
// Both stage each sender's B tile (read in memory order, stored transposed,
// [r][rows + kPad]) and A tile ([r][cols]) with cp.async into a ring of
// 2 to kMaxStages buffers (the deepest that fits beside the rest at this
// rank), so the next senders' tiles are in flight while one sender
// computes (one __syncthreads a sender).
//
// * bank (A shared, rows 16-byte aligned): one block per (lead slice,
//   32x16 output tile), for every receiver.  Phase 1 walks the senders and
//   writes each B_j @ A_j of the tile into a bank D[S][tile] in shared
//   memory, once for all receivers.  A thread owns four consecutive columns
//   of one row in both phases, so D is its own and phase 2 needs no
//   barrier.  Phase 2 sweeps the receivers in groups of kRecv: per sender
//   one read of D serves the group; w of the next group is loaded while
//   this group computes (the first group's during phase 1), 16 bytes a
//   thread.  The two phases still follow each other in every block, so the
//   kernel takes about phase 1's time plus phase 2's
//   (benchmarks/torch_lowrank_phases.py).
// * groups (A per receiver, or a bank that does not fit S senders, rows
//   that are not 16-byte aligned, or too few tiles to fill the card): one
//   block per (lead slice, 64x32 output tile, kGroup receivers).  A thread
//   owns eight rows of one column for each receiver of the group; per rank
//   step it reads its eight B values once (two 16-byte broadcast loads) for
//   the whole group.  With A shared (receiver stride 0) the sender's
//   product is computed once for the group.  Rank 8, the adapter wire's,
//   has its own instantiation, whose rank loop the compiler unrolls.
//
// w and out are [N, L, d, k] with any distance between nodes (a row span of
// the parameter plane) and may be the same memory: each element is read
// and then written by one thread.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxStages = 4;           // cp.async ring depth (senders), most
constexpr int kPad = 4;                 // staged B^T row pitch: rows + kPad
constexpr int kBankRows = 32;           // bank: output tile rows
constexpr int kBankCols = 16;           // bank: output tile columns
constexpr int kBankTile = kBankRows * kBankCols;
constexpr int kBankThreads = kBankTile / 4;   // four columns a thread
constexpr int kRecv = 8;                // bank: receivers a phase-2 group
constexpr int kGroup = 4;               // groups: receivers a block
constexpr int kRowsPerThread = 8;       // groups: rows of a thread's column
constexpr int kGroupCols = 32;          // groups: output tile columns
constexpr int kGroupThreads = 256;
constexpr int kGroupRows = kRowsPerThread * (kGroupThreads / kGroupCols);
constexpr int64_t kMaxSmem = 232448;    // a block's shared memory on sm_90

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Wait for the oldest sender's copies in a ring of `stages` buffers: all
// but this thread's stages - 2 newest groups.
__device__ __forceinline__ void cp_async_wait_oldest(int stages) {
  if (stages >= 4)
    cp_async_wait<2>();
  else if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// A ring of `stages` buffers of `size` floats from `base`: `at` is the
// buffer of the sender computing now, `ahead` the one stage_sender fills
// next (stages - 1 senders on); both step one buffer a sender.
struct Ring {
  float* base;
  float* end;
  int size;
  float* at;
  float* ahead;
  __device__ Ring(float* base, int stages, int size)
      : base(base), end(base + stages * size), size(size), at(base),
        ahead(base + (stages - 1) * size) {}
  __device__ float* wrap(float* p) const { return p == end ? base : p; }
  __device__ void step() {
    at = wrap(at + size);
    ahead = wrap(ahead + size);
  }
};

// Where a thread's first element of a staged B tile lies, and how far one
// step of the staging loop moves it: (row, t) of e = threadIdx.x, and of
// THREADS, in a [rows, r] tile read row by row.
struct BWalk {
  int row, t, step_row, step_t;
  __device__ BWalk(int r, int threads)
      : row(threadIdx.x / r), t(threadIdx.x % r), step_row(threads / r),
        step_t(threads % r) {}
};

// Stage sender j's B tile transposed ([r][ROWS + kPad], zero past d) and
// its A tiles ([n_a][r][COLS], zero past k) into one ring buffer.  The
// global reads walk B's rows in memory order (a warp reads 128 contiguous
// bytes), and the pitch ROWS + kPad spreads the transposed stores of a
// warp over the banks.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_sender(
    float* buf, const float* __restrict__ b, const float* __restrict__ a,
    int j, int l, int lead, int d, int k, int r, int d0, int k0, int i0,
    int n_a, int n_recv, int64_t a_recv_stride, BWalk w) {
  constexpr int kPitch = ROWS + kPad;
  const float* bt = b + (((int64_t)j * lead + l) * d + d0) * r;
  for (int e = threadIdx.x; e < r * ROWS; e += THREADS) {
    if (d0 + w.row < d)
      cp_async4(buf + w.t * kPitch + w.row, bt + e);
    else
      buf[w.t * kPitch + w.row] = 0.f;
    w.row += w.step_row;
    w.t += w.step_t;
    if (w.t >= r) {
      w.t -= r;
      ++w.row;
    }
  }
  float* as = buf + r * kPitch;
  for (int ia = 0; ia < n_a; ++ia) {
    const int i = min(i0 + ia, n_recv - 1);
    const float* aj = a + i * a_recv_stride + ((int64_t)j * lead + l) * r * k;
    for (int e = threadIdx.x; e < r * COLS; e += THREADS) {
      const int t = e / COLS, col = e % COLS;
      if (k0 + col < k)
        cp_async4(as + ia * r * COLS + e, aj + (int64_t)t * k + k0 + col);
      else
        as[ia * r * COLS + e] = 0.f;
    }
  }
}

// Four consecutive floats from global memory, 16 bytes.  The load is
// volatile asm so that it starts here, ahead of the work that hides it,
// and is not sunk to its first use.
__device__ __forceinline__ void load4(float (&x)[4], const float* p) {
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
               : "l"(p));
}

// One rank step of phase 1: dot[u] (+)= B[row, t] * A[t, col + u];
// `bt` and `at` point at row t of the staged tiles.
template <bool FIRST>
__device__ __forceinline__ void bank_rank_step(float (&dot)[4],
                                               const float* bt,
                                               const float* at, int row,
                                               int col) {
  const float bv = bt[row];
  const float4 v = *reinterpret_cast<const float4*>(at + col);
  const float av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float p = __fmul_rn(bv, av[u]);
    dot[u] = FIRST ? p : __fadd_rn(dot[u], p);
  }
}

// Phase 1 for one sender staged at `stage`: B @ A on this tile for a
// thread's four columns, each dot from the t = 0 product in t order, into
// the sender's bank `dj`.
__device__ __forceinline__ void bank_dot(float* dj, const float* stage,
                                         int r, int row, int col) {
  constexpr int kPitch = kBankRows + kPad;
  const float* as = stage + r * kPitch;
  float dot[4];
  bank_rank_step<true>(dot, stage, as, row, col);
#pragma unroll 2
  for (int t = 1; t < r; ++t)
    bank_rank_step<false>(dot, stage + t * kPitch, as + t * kBankCols, row,
                          col);
  *reinterpret_cast<float4*>(dj + row * kBankCols + col) =
      make_float4(dot[0], dot[1], dot[2], dot[3]);
}

__global__ void __launch_bounds__(kBankThreads)
lowrank_bank_kernel(const float* w, float* out,
                    const float* __restrict__ coeffs,
                    const float* __restrict__ b,
                    const float* __restrict__ a, int n_recv, int n_send,
                    int lead, int d, int k, int r, int stages,
                    int64_t w_stride, int64_t out_stride, int tiles_k) {
  extern __shared__ __align__(16) float smem[];
  float* bank = smem;                                   // [S][kBankTile]
  Ring ring(smem + (int64_t)n_send * kBankTile, stages,  // [stages][..]
            r * (kBankRows + kPad + kBankCols));
  const BWalk walk(r, kBankThreads);
  const int l = blockIdx.y;
  const int d0 = (blockIdx.x / tiles_k) * kBankRows;
  const int k0 = (blockIdx.x % tiles_k) * kBankCols;
  // a thread's four consecutive columns of one row; k is a multiple of 4,
  // so they lie all inside the leaf or all past it
  const int row = threadIdx.x * 4 / kBankCols;
  const int col = threadIdx.x * 4 % kBankCols;
  const bool ok = d0 + row < d && k0 + col < k;
  const int64_t off = ((int64_t)l * d + d0 + row) * k + k0 + col;

  // the first receivers' w is in flight during phase 1
  float wv[kRecv][4];
#pragma unroll
  for (int g = 0; g < kRecv; ++g)
    if (ok && g < n_recv) load4(wv[g], w + g * w_stride + off);

  // phase 1: D[j] = B_j @ A_j on this tile, senders in order, through a
  // ring of `stages`: sender j + stages - 1 in flight while j computes
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_send)
      stage_sender<kBankRows, kBankCols, kBankThreads>(
          ring.base + s * ring.size, b, a, s, l, lead, d, k, r, d0, k0, 0, 1,
          n_recv, 0, walk);
    cp_async_commit();
  }
  for (int j = 0; j < n_send; ++j) {
    cp_async_wait_oldest(stages);   // sender j's copies (this thread's)
    __syncthreads();                // ... everyone's; stage j-1 is free
    const int jn = j + stages - 1;
    if (jn < n_send)
      stage_sender<kBankRows, kBankCols, kBankThreads>(
          ring.ahead, b, a, jn, l, lead, d, k, r, d0, k0, 0, 1, n_recv, 0,
          walk);
    cp_async_commit();
    bank_dot(bank + (int64_t)j * kBankTile, ring.at, r, row, col);
    ring.step();
  }

  // phase 2: the receivers, kRecv at a time; D is this thread's own
  for (int i0 = 0; i0 < n_recv; i0 += kRecv) {
    float wn[kRecv][4];
#pragma unroll
    for (int g = 0; g < kRecv; ++g)
      if (ok && i0 + kRecv + g < n_recv)
        load4(wn[g], w + (i0 + kRecv + g) * w_stride + off);
    // the sums start at -0.0f: -0.0f + x == x for every x, so the sum is
    // the j = 0 term after one sender, and w + acc is w when there is none
    float acc[kRecv][4];
#pragma unroll
    for (int g = 0; g < kRecv; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[g][u] = -0.0f;
    const float* crow[kRecv];
#pragma unroll
    for (int g = 0; g < kRecv; ++g)
      crow[g] = coeffs + (int64_t)min(i0 + g, n_recv - 1) * n_send;
    for (int j = 0; j < n_send; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          bank + (int64_t)j * kBankTile + row * kBankCols + col);
      const float dv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int g = 0; g < kRecv; ++g) {
        const float c = __ldg(crow[g] + j);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[g][u] = __fadd_rn(acc[g][u], __fmul_rn(c, dv[u]));
      }
    }
#pragma unroll
    for (int g = 0; g < kRecv; ++g) {
      if (ok && i0 + g < n_recv)
        *reinterpret_cast<float4*>(out + (i0 + g) * out_stride + off) =
            make_float4(__fadd_rn(wv[g][0], acc[g][0]),
                        __fadd_rn(wv[g][1], acc[g][1]),
                        __fadd_rn(wv[g][2], acc[g][2]),
                        __fadd_rn(wv[g][3], acc[g][3]));
#pragma unroll
      for (int u = 0; u < 4; ++u) wv[g][u] = wn[g][u];
    }
  }
}

// One rank step of the groups design: dot[g][q] (+)= B[row0 + q, t] *
// A_g[t, col] for eight rows and kA A tiles; `bt` points at B's staged
// row t (at row0), `at` at A_0's staged row t (at the thread's column).
template <int kA, bool FIRST>
__device__ __forceinline__ void group_rank_step(
    float (&dot)[kA][kRowsPerThread], const float* bt, const float* at,
    int r) {
  float bv[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; q += 4) {
    const float4 v = *reinterpret_cast<const float4*>(bt + q);
    bv[q] = v.x; bv[q + 1] = v.y; bv[q + 2] = v.z; bv[q + 3] = v.w;
  }
#pragma unroll
  for (int g = 0; g < kA; ++g) {
    const float av = at[g * r * kGroupCols];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const float p = __fmul_rn(bv[q], av);
      dot[g][q] = FIRST ? p : __fadd_rn(dot[g][q], p);
    }
  }
}

// R > 0: the rank is R, known to the compiler; R == 0: any rank r.
template <bool SHARED_A, int R>
__global__ void __launch_bounds__(kGroupThreads, 2)
lowrank_group_kernel(const float* w, float* out,
                     const float* __restrict__ coeffs,
                     const float* __restrict__ b,
                     const float* __restrict__ a, int n_recv, int n_send,
                     int lead, int d, int k, int r, int stages,
                     int64_t a_recv_stride, int64_t w_stride,
                     int64_t out_stride, int tiles_k) {
  if (R > 0) r = R;   // a rank the compiler knows: the rank loop unrolls
  constexpr int kA = SHARED_A ? 1 : kGroup;   // A tiles a stage
  extern __shared__ __align__(16) float smem[];
  constexpr int kPitch = kGroupRows + kPad;
  Ring ring(smem, stages, r * (kPitch + kA * kGroupCols));
  const BWalk walk(r, kGroupThreads);
  const int i0 = blockIdx.z * kGroup;
  const int l = blockIdx.y;
  const int d0 = (blockIdx.x / tiles_k) * kGroupRows;
  const int k0 = (blockIdx.x % tiles_k) * kGroupCols;
  const int tx = threadIdx.x % kGroupCols;
  const int row0 = (threadIdx.x / kGroupCols) * kRowsPerThread;
  // the sums start at -0.0f, as in the bank design
  float acc[kGroup][kRowsPerThread];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[g][q] = -0.0f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_send)
      stage_sender<kGroupRows, kGroupCols, kGroupThreads>(
          ring.base + s * ring.size, b, a, s, l, lead, d, k, r, d0, k0, i0,
          kA, n_recv, a_recv_stride, walk);
    cp_async_commit();
  }
  for (int j = 0; j < n_send; ++j) {
    cp_async_wait_oldest(stages);
    __syncthreads();
    const int jn = j + stages - 1;
    if (jn < n_send)
      stage_sender<kGroupRows, kGroupCols, kGroupThreads>(
          ring.ahead, b, a, jn, l, lead, d, k, r, d0, k0, i0, kA, n_recv,
          a_recv_stride, walk);
    cp_async_commit();
    const float* bs = ring.at;                              // [r][pitch]
    const float* as = bs + r * kPitch;                      // [kA][r][32]
    // dot[g][q] = sum_t B[row q, t] * A_g[t, col], from the t = 0 product
    float dot[kA][kRowsPerThread];
    group_rank_step<kA, true>(dot, bs + row0, as + tx, r);
    if constexpr (R > 0) {
#pragma unroll
      for (int t = 1; t < R; ++t)
        group_rank_step<kA, false>(dot, bs + t * kPitch + row0,
                                   as + t * kGroupCols + tx, r);
    } else {
#pragma unroll 2
      for (int t = 1; t < r; ++t)
        group_rank_step<kA, false>(dot, bs + t * kPitch + row0,
                                   as + t * kGroupCols + tx, r);
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float c =
          __ldg(coeffs + (int64_t)min(i0 + g, n_recv - 1) * n_send + j);
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[g][q] =
            __fadd_rn(acc[g][q], __fmul_rn(c, dot[SHARED_A ? 0 : g][q]));
    }
    ring.step();
  }

  const int col = k0 + tx;
  if (col >= k) return;
  // every w value is loaded before the first store: out may be w, so a
  // load after a store would wait for it
  float wv[kGroup][kRowsPerThread];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      if (i0 + g < n_recv && d0 + row0 + q < d)
        wv[g][q] = w[(i0 + g) * w_stride +
                     ((int64_t)l * d + d0 + row0 + q) * k + col];
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      if (i0 + g < n_recv && d0 + row0 + q < d)
        out[(i0 + g) * out_stride +
            ((int64_t)l * d + d0 + row0 + q) * k + col] =
            __fadd_rn(wv[g][q], acc[g][q]);
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// kernel's limit first where it exceeds the default 48 KB.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, int64_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, (size_t)smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The rank the groups design is specialised for (the adapter wire's rank
// 8); any other rank runs the general instantiation.
constexpr int kRank = 8;

template <bool SHARED_A>
int launch_groups(const float* w, float* out, const float* coeffs,
                  const float* b, const float* a, int n_nodes, int n_send,
                  int lead, int d, int k, int r, int stages,
                  int64_t a_recv_stride, int64_t w_stride,
                  int64_t out_stride, int64_t smem, cudaStream_t stream) {
  const int tiles_k = (k + kGroupCols - 1) / kGroupCols;
  const int tiles_d = (d + kGroupRows - 1) / kGroupRows;
  const dim3 grid(tiles_d * tiles_k, lead, (n_nodes + kGroup - 1) / kGroup);
  if (r == kRank)
    return launch(lowrank_group_kernel<SHARED_A, kRank>, grid, kGroupThreads,
                  smem, stream, w, out, coeffs, b, a, n_nodes, n_send, lead,
                  d, k, r, stages, a_recv_stride, w_stride, out_stride,
                  tiles_k);
  return launch(lowrank_group_kernel<SHARED_A, 0>, grid, kGroupThreads, smem,
                stream, w, out, coeffs, b, a, n_nodes, n_send, lead, d, k, r,
                stages, a_recv_stride, w_stride, out_stride, tiles_k);
}

}  // namespace

// design 0: bank (tile 32x16, A shared, every row of w and out 16-byte
// aligned); design 1: groups (tile 64x32, `group` receivers a block;
// a_recv_stride is A's distance between receivers in floats, 0 when A is
// shared).  `stages` (2 to kMaxStages) and smem_bytes are the launch plan's;
// a plan that gives less than the design needs, or more than a block may
// have, is refused with cudaErrorInvalidValue before anything launches.
extern "C" int lowrank_apply(const float* w, float* out, const float* coeffs,
                             const float* b, const float* a, int n_nodes,
                             int n_send, int lead, int d, int k, int r,
                             int64_t a_recv_stride, int64_t w_stride,
                             int64_t out_stride, int design, int tile_d,
                             int tile_k, int group, int stages,
                             int64_t smem_bytes, cudaStream_t stream) {
  if (n_nodes <= 0 || lead <= 0 || d <= 0 || k <= 0 || r <= 0)
    return (int)cudaGetLastError();
  if (stages < 2 || stages > kMaxStages) return (int)cudaErrorInvalidValue;
  const int64_t f = sizeof(float);
  if (design == 0) {
    const int64_t need =
        (int64_t)n_send * kBankTile * f +
        (int64_t)stages * r * (kBankRows + kPad + kBankCols) * f;
    // 16-byte rows: every node's row starts on a 16-byte boundary
    const bool aligned = k % 4 == 0 && w_stride % 4 == 0 &&
                         out_stride % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (tile_d != kBankRows || tile_k != kBankCols || group != n_nodes ||
        smem_bytes < need || smem_bytes > kMaxSmem || a_recv_stride != 0 ||
        !aligned)
      return (int)cudaErrorInvalidValue;
    const int tiles_k = (k + kBankCols - 1) / kBankCols;
    const dim3 grid((d + kBankRows - 1) / kBankRows * tiles_k, lead);
    return launch(lowrank_bank_kernel, grid, kBankThreads, smem_bytes, stream,
                  w, out, coeffs, b, a, n_nodes, n_send, lead, d, k, r,
                  stages, w_stride, out_stride, tiles_k);
  }
  if (design != 1 || tile_d != kGroupRows || tile_k != kGroupCols ||
      group != kGroup)
    return (int)cudaErrorInvalidValue;
  const bool shared_a = a_recv_stride == 0;
  const int64_t need =
      (int64_t)stages * r *
      (kGroupRows + kPad + (shared_a ? 1 : kGroup) * kGroupCols) * f;
  if (smem_bytes < need || smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (shared_a)
    return launch_groups<true>(w, out, coeffs, b, a, n_nodes, n_send, lead, d,
                               k, r, stages, a_recv_stride, w_stride,
                               out_stride, smem_bytes, stream);
  return launch_groups<false>(w, out, coeffs, b, a, n_nodes, n_send, lead, d,
                              k, r, stages, a_recv_stride, w_stride,
                              out_stride, smem_bytes, stream);
}
