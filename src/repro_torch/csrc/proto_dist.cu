// Eq. 5 pairwise squared prototype distances, for Hopper (sm_90a).
//
// Replaces repro/kernels/proto_dist/proto_dist.py:proto_dist_pallas.
//   d2[n, c] = max(||x_n||^2 - 2 x_n.p_c + ||p_c||^2, 0)
// x [N, P] and protos [C, P], both fp32 or both bf16 (cast to fp32 on load,
// as the TPU kernel does), d2 [N, C] fp32.
//
// What bounds it on the H100: at Eq. 5's shapes (a test split of 640
// features against 10 or 100 classes, P = 128 or 256) it reads under 1 MB and
// does a few MFLOP, so launch latency and the kernel's own critical path:
// round trips to memory, barriers and dependent multiply-add chains.
// Design: a warp owns 1, 2 or 4 rows of x (RW, a template parameter) and a
// block 4, 8 or 16 warps (blockIdx.x) and a tile of up to 16 prototypes
// (blockIdx.y; the plan sizes the tile to C: C = 10 is one tile of 10, C =
// 100 seven of 15), so N = 640 at C = 10 is 160 blocks.  P is cut into
// chunks of 256.  A block stages a chunk of its x rows and of its prototype
// rows in shared memory with cp.async, every copy issued before any is
// waited for and none through a register: 16-byte vectors (4 fp32, or 8
// bf16) where P is a multiple of the vector and both bases lie on 16 bytes,
// else one element a copy (VEC = 1; a bf16 element, 2 bytes, below
// cp.async's least, by a plain load and store); elements beyond P and rows
// beyond N stage zeros.  The paths' P (128, 256) is one chunk: one round
// trip and one barrier.  A longer P is double-buffered: the next chunk's
// copies are issued before the current one is folded.  Lane l folds the 8
// elements (v * 32 + l) * VEC + j of a chunk into a partial dot of each of
// its rows with each of the tile's prototypes (so a chain of P / 32 fmaf
// an output), a partial ||x||^2 of each row and, for the prototypes its
// warp owns (every warps-th one), a partial ||p||^2; each norm is so
// computed once a block.  A prototype vector read from shared memory
// serves all RW rows: every row reads the whole tile, N * C * P elements
// over the card, and at C = 100 those reads, not the copies, set the time,
// so the plan raises RW with that volume.  After the last chunk the owned
// ||p||^2 are folded by shuffles into shared memory (a second barrier),
// ||x||^2 by shuffles, and the 16 partial dots of a row by a halving
// shuffle exchange (16 shuffles, not 16 x 5): lanes 2i and 2i + 1 end with
// prototype i's dot, and the even lane writes its d2.  fp32 fmaf only (no
// tensor cores, no TF32), as the Pallas body's dot_general is fp32; the sum
// runs in another order than the plain versions', so it agrees with them to
// a stated tolerance, not bit for bit.  The launch plan (vector width, rows
// a warp, warps a block, column tile, grid) is picked in Python
// (kernels/proto_dist/proto_dist.py:proto_dist_plan); the launcher checks it
// and returns the CUDA error otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kColTile = 16;      // prototypes a block at most
constexpr int kChunk = 256;       // P elements staged at a time
constexpr int kMinThreads = 128;  // 4 warps: the smallest block
constexpr int kMaxThreads = 512;  // 16 warps: the largest block
constexpr int kOwned = kColTile / (kMinThreads / 32);  // norms a warp owns
constexpr int kSmemMax = 48 * 1024;  // dynamic shared memory, no opt-in

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC consecutive elements of T at src (device or shared memory) as fp32:
// one 16-byte load (float4, or 8 bf16) when VEC > 1
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* __restrict__ src,
                                         float* v) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*src);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(VEC == 4, "fp32 vectors are float4");
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 elements");
    const uint4 t = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // little-endian: the low half first
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* q) {
  return (uint32_t)__cvta_generic_to_shared(q);
}

// VEC elements of T from device memory to shared memory without a register:
// cp.async of 16 bytes (a vector) or 4 (one fp32), zeros where !valid (a
// source size of 0 reads nothing); one bf16 element (2 bytes, below
// cp.async's least) by a plain load and store.
template <typename T, int VEC>
__device__ __forceinline__ void stage_vec(T* dst, const T* src, bool valid) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  } else {
    *dst = valid ? *src : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// One halving step of the exchange: a lane keeps the H values of v's first
// 2H that its lane bit 2H selects, and adds its partner's copies of them.
template <int H>
__device__ __forceinline__ void fold_half(float (&v)[kColTile], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = up ? v[i + H] : v[i];
    const float send = up ? v[i] : v[i + H];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 2 * H));
  }
}

// The warp's sums of v[0..16): lane l returns the sum of v[(l >> 1) & 15]
// over the 32 lanes, in 16 shuffles.
__device__ __forceinline__ float reduce_scatter(float (&v)[kColTile],
                                                int lane) {
  static_assert(kColTile == 16, "the exchange folds 16 values");
  fold_half<8>(v, lane);
  fold_half<4>(v, lane);
  fold_half<2>(v, lane);
  fold_half<1>(v, lane);
  return __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
}

// Warp w of block (bx, by) owns rows (bx * warps + w) * RW + q, q < RW,
// against prototypes [by * col_tile, + col_tile) (fewer in a last tile).
// A staged chunk is the block's warps * RW rows of x, then the tile's
// prototype rows, kChunk elements of T each; lane l folds the elements (v *
// 32 + l) * VEC + j, v < kChunk / (32 VEC), j < VEC, of its rows and of each
// prototype row, so each prototype vector read from shared memory serves
// RW rows.  Chunk ch is staged in buffer ch & 1 (one buffer when P fits one
// chunk).
template <typename T, int VEC, int RW>
__global__ void __launch_bounds__(kMaxThreads) proto_dist_kernel(
    const T* __restrict__ x, const T* __restrict__ p, float* __restrict__ out,
    int n, int c, int p_dim, int col_tile) {
  constexpr int kGroup = 32 * VEC;          // elements a warp-wide vector
  constexpr int kGroups = kChunk / kGroup;  // vectors a lane a chunk
  constexpr int kRowVecs = kChunk / VEC;    // vectors a staged row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float p2s[kColTile];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int x_rows = warps * RW;  // staged rows of x
  const int64_t row0 = (int64_t)blockIdx.x * x_rows;
  const int64_t wrow = row0 + warp * RW;  // the warp's first row
  const bool has_row = wrow < n;
  const int col0 = blockIdx.y * col_tile;
  const int ct = min(col_tile, c - col0);
  const int buf_elems = (x_rows + col_tile) * kChunk;

  // the warp-wide vectors of the chunk at k0 that hold elements below P
  auto groups = [&](int k0) {
    return min(kGroups, (p_dim - k0 + kGroup - 1) / kGroup);
  };
  // every load of the chunk at k0 into buffer buf, issued, then committed
  auto stage = [&](int k0, int buf) {
    const int glen = groups(k0);
    T* dst = sm + buf * buf_elems;
    for (int u = threadIdx.x; u < (x_rows + ct) * kRowVecs;
         u += blockDim.x) {
      const int r = u / kRowVecs, kv = u % kRowVecs;
      if (kv >= glen * 32) continue;
      const int k = k0 + kv * VEC;
      const bool is_x = r < x_rows;
      const int64_t src_row = is_x ? row0 + r : (int64_t)col0 + r - x_rows;
      const bool valid = (!is_x || src_row < n) && k < p_dim;
      const T* base = is_x ? x : p;
      stage_vec<T, VEC>(dst + r * kChunk + kv * VEC,
                        valid ? base + src_row * p_dim + k : base, valid);
    }
    cp_commit();
  };

  float acc[RW][kColTile], pp[kOwned], x2[RW];
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    x2[q] = 0.f;
#pragma unroll
    for (int i = 0; i < kColTile; ++i) acc[q][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kOwned; ++i) pp[i] = 0.f;

  const int n_chunks = (p_dim + kChunk - 1) / kChunk;
  if (n_chunks > 0) stage(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < n_chunks) {  // the next chunk in flight while this folds
      stage((ch + 1) * kChunk, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int glen = groups(ch * kChunk);
    const T* xs = sm + buf * buf_elems + warp * RW * kChunk;
    const T* ps = sm + buf * buf_elems + x_rows * kChunk;
#pragma unroll
    for (int v = 0; v < kGroups; ++v) {
      if (v >= glen) break;  // uniform across the block
      const int e0 = (v * 32 + lane) * VEC;
      if (has_row) {  // rows beyond N were staged as zeros
        float xv[RW][VEC];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          load_f32<T, VEC>(xs + q * kChunk + e0, xv[q]);
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            x2[q] = fmaf(xv[q][j], xv[q][j], x2[q]);
        }
#pragma unroll
        for (int cc = 0; cc < kColTile; ++cc) {
          if (cc < ct) {
            float pv[VEC];
            load_f32<T, VEC>(ps + cc * kChunk + e0, pv);
#pragma unroll
            for (int q = 0; q < RW; ++q)
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                acc[q][cc] = fmaf(xv[q][j], pv[j], acc[q][cc]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kOwned; ++i) {
        const int cc = warp + i * warps;
        if (cc < ct) {
          float pv[VEC];
          load_f32<T, VEC>(ps + cc * kChunk + e0, pv);
#pragma unroll
          for (int j = 0; j < VEC; ++j) pp[i] = fmaf(pv[j], pv[j], pp[i]);
        }
      }
    }
    if (ch + 2 < n_chunks) __syncthreads();  // buf is staged again next
  }

  // each prototype's ||p||^2, folded by the warp that owns it
#pragma unroll
  for (int i = 0; i < kOwned; ++i) {
    const int cc = warp + i * warps;
    if (cc < ct) {
      const float s = warp_sum(pp[i]);
      if (lane == 0) p2s[cc] = s;
    }
  }
  __syncthreads();
  const int cc = (lane >> 1) & (kColTile - 1);
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    if (wrow + q >= n) break;  // uniform across the warp
    const float xx = warp_sum(x2[q]);
    const float xc = reduce_scatter(acc[q], lane);
    if (!(lane & 1) && cc < ct)
      out[(wrow + q) * c + col0 + cc] = fmaxf(
          __fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, xc)), p2s[cc]), 0.f);
  }
}

template <typename T, int VEC, int RW>
void launch(const void* x, const void* p, float* out, int n, int c, int p_dim,
            int warps, int col_tile, int grid_x, int grid_y, int smem,
            cudaStream_t stream) {
  proto_dist_kernel<T, VEC, RW>
      <<<dim3(grid_x, grid_y), 32 * warps, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(p), out, n, c,
          p_dim, col_tile);
}

template <typename T, int VEC>
void launch_rows(int warp_rows, const void* x, const void* p, float* out,
                 int n, int c, int p_dim, int warps, int col_tile,
                 int grid_x, int grid_y, int smem, cudaStream_t stream) {
  if (warp_rows == 1)
    launch<T, VEC, 1>(x, p, out, n, c, p_dim, warps, col_tile, grid_x,
                      grid_y, smem, stream);
  else if (warp_rows == 2)
    launch<T, VEC, 2>(x, p, out, n, c, p_dim, warps, col_tile, grid_x,
                      grid_y, smem, stream);
  else
    launch<T, VEC, 4>(x, p, out, n, c, p_dim, warps, col_tile, grid_x,
                      grid_y, smem, stream);
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

}  // namespace

// bf16 != 0: x and protos are bf16, else fp32.  The plan (kernels/
// proto_dist/proto_dist.py:proto_dist_plan) is checked: every row by one
// warp and every prototype by one column tile, no block empty; 16-byte
// vectors only where P is a multiple of the vector and both bases lie on
// 16 bytes; the staged chunk (two buffers when P spans chunks) within the
// dynamic shared memory a block has without opting in.
extern "C" int proto_dist(const void* x, const void* protos, float* out,
                          int n, int c, int p_dim, int bf16, int vec,
                          int warps, int warp_rows, int col_tile, int grid_x,
                          int grid_y, cudaStream_t stream) {
  const int wide = bf16 ? 8 : 4;
  const int64_t rows = (int64_t)warps * warp_rows;  // rows a block
  const int64_t smem = (p_dim > kChunk ? 2 : 1) * (rows + col_tile) * kChunk
                       * (bf16 ? 2 : 4);
  const bool ok =
      n > 0 && c > 0 && p_dim >= 0 &&
      (warps == 4 || warps == 8 || warps == 16) &&
      (warp_rows == 1 || warp_rows == 2 || warp_rows == 4) &&
      col_tile >= 1 && col_tile <= kColTile && smem <= kSmemMax &&
      grid_x > 0 && grid_x * rows >= n && (grid_x - 1) * rows < n &&
      grid_y > 0 && grid_y <= 65535 && (int64_t)grid_y * col_tile >= c &&
      (int64_t)(grid_y - 1) * col_tile < c &&
      (vec == 1 || (vec == wide && p_dim % vec == 0 && aligned16(x) &&
                    aligned16(protos)));
  if (!ok) return (int)cudaErrorInvalidValue;
  const int sm = (int)smem;
  if (bf16) {
    if (vec == 1)
      launch_rows<__nv_bfloat16, 1>(warp_rows, x, protos, out, n, c, p_dim,
                                    warps, col_tile, grid_x, grid_y, sm,
                                    stream);
    else
      launch_rows<__nv_bfloat16, 8>(warp_rows, x, protos, out, n, c, p_dim,
                                    warps, col_tile, grid_x, grid_y, sm,
                                    stream);
  } else {
    if (vec == 1)
      launch_rows<float, 1>(warp_rows, x, protos, out, n, c, p_dim, warps,
                            col_tile, grid_x, grid_y, sm, stream);
    else
      launch_rows<float, 4>(warp_rows, x, protos, out, n, c, p_dim, warps,
                            col_tile, grid_x, grid_y, sm, stream);
  }
  return (int)cudaGetLastError();
}
