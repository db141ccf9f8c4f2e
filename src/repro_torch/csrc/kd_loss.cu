// Fused temperature-KD loss per row, for Hopper (sm_90a).
//
// Replaces repro/kernels/kd_loss/kd_loss.py:kd_loss_rows_pallas.
//   out[r] = KL(softmax(yt[r] / T) || softmax(ys[r] / T)) * T^2
// ys, yt [R, V], both fp32 or both bf16 (cast to fp32 on load), out [R] fp32,
// in one pass over the logits: neither [R, V] probability tensor is made.
// Online state (the Pallas body's, kd_loss.py:47-62), in the log2 domain:
//   m_t, l_t  teacher running max of y * scale (scale = inv_t * log2 e) and
//             normaliser sum 2^(yt * scale - m_t)
//   u         running sum of 2^(yt * scale - m_t) * (yt - ys), in the
//             logits' own units
//   m_s, l_s  student running max and normaliser
// finished as  ln 2 * (u * scale / l_t - (m_t - m_s) - (log2 l_t - log2 l_s)),
// divided by inv_t^2 (the TPU kernel multiplies by inv_t = 1/T and divides by
// inv_t^2).  A logit enters its exponent by one fmaf, y * scale - m.  Each
// exp2 is the SFU's ex2.approx.ftz.f32, the approximation CUDA's exp2f is
// built on (exp2f: at most 2 ulp, the bound expf has), with results below
// 2^-126 flushed to 0: terms under 1e-38 of the row's largest, which is 1.
// log2f is the library's (1 ulp).  The plain version's own rounding (a
// softmax of y / T, then a sum of terms of the size of max|y| / T) sets
// kd_tol = 1e-5 T (T + max|y|); on the card this kernel stays within 3 % of
// it at every case of chip_smoke.py phase 3.
//
// What bounds it on the H100: at an LM vocabulary (256 rows x V = 202,048)
// it must read 207 MB in bf16 (0.062 ms at 3.35 TB/s), 413 MB in fp32, so
// bytes, as long as a logit costs few enough instructions; at the ProFe KD
// term ([320, 10] fp32, 25.6 KB) nothing but one launch and one round trip
// to memory.  Three designs, picked in Python (kernels/kd_loss/kd_loss.py:
// kd_plan) and checked by the launcher:
// - segments (V <= 256): a row takes a segment of `lanes` lanes of a warp
//   (a power of two, `__shfl_xor_sync` within it) and a block many rows, so
//   [320, 10] is 20 one-warp blocks of 16 rows.  A lane loads its <= 8
//   logits a side (scalar loads: such rows are rarely on 16 bytes) before
//   it uses any; the row's max is taken first, so each logit takes one exp2
//   a side and the state needs no rescale.
// - blocks (V > 256, rows >= SMs): a block a row.  A thread walks tiles of
//   kTile = 16 logits a side, 16-byte loads (4 fp32 or 2 bf16 loads a side)
//   all issued before any is used, a block's width apart, kept as the words
//   they arrive in; then the tile's maxima, one rescale of its state, and
//   one exp2 a logit a side, with no branch a logit.  fp32 loads are
//   ld.global.nc, bf16 ld.global.nc.L1::no_allocate (each timed the faster
//   for its type on the card).  A row whose base is not on 16 bytes, or
//   whose length is not a whole number of vectors, takes VEC = 1 (16 scalar
//   loads a side); nothing is padded, and the last tile of a thread masks
//   what lies beyond its range.  The threads' states merge by xor shuffles,
//   then over the warps in warp 0, with the Pallas rescaling: l = l_a
//   2^(m_a - m) + l_b 2^(m_b - m), u likewise.  Timed on the card and
//   dropped: 32 bf16 logits a tile (spills at 64 registers; slower at 128),
//   256-thread blocks, a 2-block split of V at 250-256 rows, and L2 bulk
//   prefetch of the next tile.
// - clusters (V > 256, rows < SMs: one block a row would leave SMs idle): a
//   thread-block cluster of `splits` (<= 8) blocks a row, each the blocks
//   design on a span of V; after cluster.sync() block 0 merges the others'
//   states from their shared memory (distributed shared memory) in rank
//   order, and a second cluster.sync() keeps them until it has.
// No atomics: every merge runs in a fixed order, so repeated calls give the
// same bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;  // the TPU kernel's initial max
constexpr float kLn2 = 0.693147180559945309f;
constexpr int kTile = 16;          // logits a thread a side a tile
constexpr int kLaneElems = 8;      // logits a lane a side, segments design
constexpr int kSegThreads = 128;   // a segments block at most
constexpr int kMaxThreads = 512;   // a rows block at most
constexpr int kMaxSplits = 8;      // blocks a cluster (the portable size)
constexpr int kSegments = 0, kBlocks = 1, kClusters = 2;  // kd_plan designs

struct State {
  float mt, lt, u, ms, ls;
};

__device__ __forceinline__ State empty_state() {
  return State{kNegInf, 0.f, 0.f, kNegInf, 0.f};
}

// exp2 by the SFU's approximation, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// b folded into a with the Pallas rescaling
__device__ __forceinline__ void merge(State& a, const State& b) {
  const float mt = fmaxf(a.mt, b.mt);
  const float ca = ex2(a.mt - mt), cb = ex2(b.mt - mt);
  a.lt = a.lt * ca + b.lt * cb;
  a.u = a.u * ca + b.u * cb;
  a.mt = mt;
  const float ms = fmaxf(a.ms, b.ms);
  a.ls = a.ls * ex2(a.ms - ms) + b.ls * ex2(b.ms - ms);
  a.ms = ms;
}

// the warp's states folded by xor shuffles; every lane ends with the fold
__device__ __forceinline__ void warp_merge(State& st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    State o;
    o.mt = __shfl_xor_sync(0xffffffffu, st.mt, off);
    o.lt = __shfl_xor_sync(0xffffffffu, st.lt, off);
    o.u = __shfl_xor_sync(0xffffffffu, st.u, off);
    o.ms = __shfl_xor_sync(0xffffffffu, st.ms, off);
    o.ls = __shfl_xor_sync(0xffffffffu, st.ls, off);
    merge(st, o);
  }
}

__device__ __forceinline__ float finish(const State& st, float scale,
                                        float inv_t_sq) {
  const float kl2 = st.u * scale / st.lt - (st.mt - st.ms) -
                    (log2f(st.lt) - log2f(st.ls));
  return kl2 * kLn2 / inv_t_sq;
}

// one logit as fp32, read once
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// A thread's loads of one side of a tile: kU loads of VEC logits each, kept
// as the words they arrive in (an fp32 logit, or two bf16, a word) and
// converted where they are used.  VEC > 1: 16-byte loads.
template <typename T, int VEC>
struct Tile {
  static constexpr int kE = kTile;     // logits
  static constexpr int kU = kE / VEC;  // loads
  static constexpr int kWords = VEC == 1 ? 1 : 4;
  uint32_t w[kU][kWords];

  __device__ __forceinline__ void load(int k, const T* __restrict__ p) {
    if constexpr (VEC == 1) {
      w[k][0] = __float_as_uint(load1(p));
    } else {
      static_assert(VEC * sizeof(T) == 16, "vectors are 16 bytes");
      if constexpr (std::is_same<T, float>::value)
        asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(w[k][0]), "=r"(w[k][1]), "=r"(w[k][2]),
                       "=r"(w[k][3])
                     : "l"(p));
      else
        asm volatile(
            "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(w[k][0]), "=r"(w[k][1]), "=r"(w[k][2]), "=r"(w[k][3])
            : "l"(p));
    }
  }
  __device__ __forceinline__ void zero(int k) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) w[k][j] = 0u;
  }
  // logit e (k = e / VEC, j = e % VEC) as fp32; bf16 little-endian: the
  // even element of a word is its low half
  __device__ __forceinline__ float operator[](int e) const {
    const int k = e / VEC, j = e % VEC;
    if constexpr (VEC == 8)
      return __uint_as_float(j & 1 ? w[k][j >> 1] & 0xffff0000u
                                   : w[k][j >> 1] << 16);
    else
      return __uint_as_float(w[k][j]);
  }
};

// A tile of logit pairs into the state: the tile's maxima, one rescale,
// one exp2 a logit a side.  kMask: only the first n logits are the row's
// (the rest are zeros and count for nothing).
template <bool kMask, typename TileT>
__device__ __forceinline__ void tile_update(State& st, const TileT& ys,
                                            const TileT& yt, int n,
                                            float scale) {
  constexpr int E = TileT::kE;
  float rt = kNegInf, rs = kNegInf;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (!kMask || e < n) {
      rt = fmaxf(rt, yt[e]);
      rs = fmaxf(rs, ys[e]);
    }
  // scale > 0, so the scaled max is the max of the scaled logits
  const float mt = fmaxf(st.mt, rt * scale), ms = fmaxf(st.ms, rs * scale);
  float lt = 0.f, u = 0.f, ls = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    float pt = ex2(__fmaf_rn(yt[e], scale, -mt));
    float ps = ex2(__fmaf_rn(ys[e], scale, -ms));
    if (kMask && e >= n) pt = ps = 0.f;
    lt += pt;
    u = __fmaf_rn(pt, yt[e] - ys[e], u);
    ls += ps;
  }
  const float ct = ex2(st.mt - mt), cs = ex2(st.ms - ms);
  st.lt = __fmaf_rn(st.lt, ct, lt);
  st.u = __fmaf_rn(st.u, ct, u);
  st.ls = __fmaf_rn(st.ls, cs, ls);
  st.mt = mt;
  st.ms = ms;
}

// segments design: row r is segment r % (blockDim.x / lanes) of block
// r / (blockDim.x / lanes); lane q of it holds logits q + k * lanes
template <typename T>
__global__ void __launch_bounds__(kSegThreads) kd_segments_kernel(
    const T* __restrict__ ys, const T* __restrict__ yt,
    float* __restrict__ out, int64_t rows, int v, int lanes, float scale,
    float inv_t_sq) {
  const int q = threadIdx.x & (lanes - 1);
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;
  const T* __restrict__ s = ys + (live ? row : 0) * v;
  const T* __restrict__ t = yt + (live ? row : 0) * v;
  float a[kLaneElems], b[kLaneElems];
#pragma unroll
  for (int k = 0; k < kLaneElems; ++k) {
    const int j = q + k * lanes;
    a[k] = live && j < v ? load1(s + j) : 0.f;
    b[k] = live && j < v ? load1(t + j) : 0.f;
  }
  float rt = kNegInf, rs = kNegInf;
#pragma unroll
  for (int k = 0; k < kLaneElems; ++k)
    if (q + k * lanes < v) {
      rt = fmaxf(rt, b[k]);
      rs = fmaxf(rs, a[k]);
    }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    rt = fmaxf(rt, __shfl_xor_sync(0xffffffffu, rt, off));
    rs = fmaxf(rs, __shfl_xor_sync(0xffffffffu, rs, off));
  }
  State st{rt * scale, 0.f, 0.f, rs * scale, 0.f};
#pragma unroll
  for (int k = 0; k < kLaneElems; ++k)
    if (q + k * lanes < v) {
      const float pt = ex2(__fmaf_rn(b[k], scale, -st.mt));
      st.lt += pt;
      st.u = __fmaf_rn(pt, b[k] - a[k], st.u);
      st.ls += ex2(__fmaf_rn(a[k], scale, -st.ms));
    }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    st.lt += __shfl_xor_sync(0xffffffffu, st.lt, off);
    st.u += __shfl_xor_sync(0xffffffffu, st.u, off);
    st.ls += __shfl_xor_sync(0xffffffffu, st.ls, off);
  }
  if (live && q == 0) out[row] = finish(st, scale, inv_t_sq);
}

// blocks and clusters designs: block b takes row b / splits and, of its
// v / VEC vectors, the span from (b % splits) * span (the last to the
// row's end); thread x takes vectors x + k * blockDim.x (k < kU) of each
// tile of blockDim.x * kU
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2) kd_rows_kernel(
    const T* __restrict__ ys, const T* __restrict__ yt,
    float* __restrict__ out, int64_t v, int splits, int64_t span,
    float scale, float inv_t_sq) {
  constexpr int kU = Tile<T, VEC>::kU;  // loads a thread a side a tile
  __shared__ State warp_st[kMaxThreads / 32];
  __shared__ State block_st;
  const int split = (int)(blockIdx.x % (unsigned)splits);
  const int64_t row = blockIdx.x / (unsigned)splits;
  const int64_t nvec = v / VEC;
  const int64_t lo = split * span;
  const int64_t hi = lo + span < nvec ? lo + span : nvec;
  const T* __restrict__ s = ys + row * v;
  const T* __restrict__ t = yt + row * v;
  const int64_t step = blockDim.x;
  State st = empty_state();
  int64_t i = lo + threadIdx.x;
  for (; i + (kU - 1) * step < hi; i += kU * step) {
    Tile<T, VEC> a, b;
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      a.load(k, s + (i + k * step) * VEC);
      b.load(k, t + (i + k * step) * VEC);
    }
    tile_update<false>(st, a, b, 0, scale);
  }
  if (i < hi) {  // fewer than kU vectors of this thread left
    Tile<T, VEC> a, b;
    int n = 0;
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      if (i + k * step < hi) {
        a.load(k, s + (i + k * step) * VEC);
        b.load(k, t + (i + k * step) * VEC);
        n += VEC;
      } else {
        a.zero(k);
        b.zero(k);
      }
    }
    tile_update<true>(st, a, b, n, scale);
  }

  warp_merge(st);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_st[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < (int)(blockDim.x >> 5) ? warp_st[lane] : empty_state();
    warp_merge(st);
    if (lane == 0) {
      if (splits == 1)
        out[row] = finish(st, scale, inv_t_sq);
      else
        block_st = st;
    }
  }
  if (splits > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's state is in its shared memory
    if (split == 0 && threadIdx.x == 0) {
      State acc = block_st;
      for (int k = 1; k < splits; ++k)
        merge(acc, *cluster.map_shared_rank(&block_st, k));
      out[row] = finish(acc, scale, inv_t_sq);
    }
    cluster.sync();  // no block leaves before block 0 has read it
  }
}

template <typename T, int VEC>
cudaError_t rows_launch(const T* s, const T* t, float* out, int64_t v,
                        int threads, int splits, int64_t span, int64_t grid,
                        float scale, float inv_t_sq, cudaStream_t stream) {
  if (splits == 1) {
    kd_rows_kernel<T, VEC><<<(unsigned)grid, threads, 0, stream>>>(
        s, t, out, v, splits, span, scale, inv_t_sq);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kd_rows_kernel<T, VEC>, s, t, out, v,
                            splits, span, scale, inv_t_sq);
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the launch, after checking its plan (kernels/kd_loss/kd_loss.py:kd_plan):
// every row by one segment or one block (cluster), every logit of it by one
// lane; 16-byte vectors only on 16-byte aligned bases whose rows are whole
// vectors
template <typename T>
int launch(const void* ys, const void* yt, float* out, int64_t rows,
           int64_t v, float scale, float inv_t_sq, int design, int vec,
           int threads, int lanes, int splits, int64_t span, int64_t grid,
           cudaStream_t stream) {
  constexpr int kWide = 16 / (int)sizeof(T);
  const T* s = static_cast<const T*>(ys);
  const T* t = static_cast<const T*>(yt);
  if (rows <= 0 || v <= 0 || grid <= 0 || grid > INT32_MAX || threads < 32 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (design == kSegments) {
    const int64_t per_block = lanes > 0 ? threads / lanes : 0;
    if (vec != 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
        (int64_t)lanes * kLaneElems < v || threads > kSegThreads ||
        splits != 1 || span != (v + lanes - 1) / lanes ||
        grid != (rows + per_block - 1) / per_block)
      return (int)cudaErrorInvalidValue;
    kd_segments_kernel<T><<<(unsigned)grid, threads, 0, stream>>>(
        s, t, out, rows, (int)v, lanes, scale, inv_t_sq);
  } else {
    const int64_t nvec = vec > 0 ? v / vec : 0;
    if ((design != kBlocks && design != kClusters) ||
        (design == kBlocks) != (splits == 1) ||
        !(vec == 1 || (vec == kWide && v % kWide == 0 && aligned16(ys) &&
                       aligned16(yt))) ||
        threads > kMaxThreads || lanes != 0 || splits < 1 ||
        splits > kMaxSplits || span < 1 || (splits - 1) * span >= nvec ||
        splits * span < nvec || grid != rows * splits)
      return (int)cudaErrorInvalidValue;
    if (vec == 1)
      err = rows_launch<T, 1>(s, t, out, v, threads, splits, span, grid,
                              scale, inv_t_sq, stream);
    else
      err = rows_launch<T, kWide>(s, t, out, v, threads, splits, span, grid,
                                  scale, inv_t_sq, stream);
  }
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// bf16 != 0: the logits are bf16, else fp32.  scale = inv_t * log2 e.
extern "C" int kd_loss_rows(const void* ys, const void* yt, float* out,
                            int64_t rows, int64_t v, float scale,
                            float inv_t_sq, int bf16, int design, int vec,
                            int threads, int lanes, int splits, int64_t span,
                            int64_t grid, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(ys, yt, out, rows, v, scale, inv_t_sq,
                                      design, vec, threads, lanes, splits,
                                      span, grid, stream)
              : launch<float>(ys, yt, out, rows, v, scale, inv_t_sq, design,
                              vec, threads, lanes, splits, span, grid,
                              stream);
}
