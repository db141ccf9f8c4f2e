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
// must read 4 B of own per output, 4 B of code per sender and column, and
// write 4 B per output;
// quantize_dequantize_rows, dequantize_rows and dequantize read 4 B and
// write 4 B per element; fused_quantize(_dequantize) must read 4 B and
// write 4 B per element too, and reads x from device memory once where the
// grid can stage it (see below).
// Design: rowabs and rowabs_sum share one body, row_absmax_kernel<kRes,
// VEC>, in the row codec's layout (below) with one warp across a row: rows
// on blockIdx.y, no index divided, and a lane's kRowUnroll 16-byte vectors
// of a 512-column step (x, and res when kRes) all loaded before any is
// folded, so a path's 512-wide row is one round trip; wider rows take more
// steps.  A shuffle fold takes the row's max, and no block ever needs a
// partial from another (the TPU kernels masked out-of-bounds lanes of their
// edge blocks; here the loop bound does).  rowabs_sum adds the residual in
// registers, so the effective payload never lands in memory.  A max is
// order-free, so the body is bit-identical to the plain versions.  A column
// count that is not a multiple of 4, or an x or res whose base is not
// 16-byte aligned, takes one column a vector (VEC = 1).  The plan is
// picked in Python (kernels/quantize/quantize.py:absmax_plan, rows_plan cut
// to one warp a row); the launcher checks it.
// quantize_rows_ef is a grid-stride elementwise loop with the row's delta
// and qmax indexed by i / cols; it writes the codes and the new residual
// from the same registers (at half its bound, it is left so).  Every
// operation is
// a _rn intrinsic in the plain version's order — the division is the IEEE
// one (__fdiv_rn), not a reciprocal multiply, the + 0.5 rounds on its own,
// and with -fmad=false no multiply fuses into an add — so codes and
// residuals are bit-identical to the plain versions.  fmaxf ignores a NaN
// where torch.amax would propagate it; wire payloads are finite.
// mix_packed gives each thread one 16-byte vector (4 columns) of one row and
// a group of up to 8 receivers (G, a template parameter: 1, 2, 4 or 8): row
// tiles on blockIdx.y, column vectors on the threads, receiver groups on
// blockIdx.z, so no index is divided.  A block first copies its group's
// w_self and w_rows into shared memory.  The thread reads each receiver's
// own vector once; then for each sender in order one 16-byte load of its
// codes (int4, or float4 for fp32 codes) and one of its row's delta, four
// senders' loads issued before any is folded; each code times delta is
// folded into all G receivers' register accumulators, and each receiver's
// vector is written once.  So a sender's codes are read once per receiver
// group, own is read once and out written once.  The plan halves the group
// while a launch would have too few threads to keep the card's memory busy:
// at the mesh round's 8 x 8 (R = 416) it takes groups of 4, whose second
// read of a sender's codes is served by L2.  A column count that is not a
// multiple of 4, or a buffer whose base is not 16-byte aligned, takes the
// same kernel with one column a thread (VEC = 1).  Each receiver's
// accumulator keeps the Pallas body's order (acc = w_self * own, then acc +
// w * (code * delta) per sender, each product and sum rounded on its own),
// so it is bit-identical to mix_packed_ref.  The launch plan (group, vector
// width, block, grid) is picked in Python (kernels/quantize/quantize.py:
// mix_plan); the launcher checks it and returns the CUDA error otherwise.
// quantize_rows, quantize_rows_mixed, quantize_dequantize_rows and
// dequantize_rows share one body, row_codec_kernel<InT, OutT, VEC,
// kRowQmax>: fp32 x in and int32 codes or the fp32 round trip code * delta
// out (rounded on its own), or int32 codes in and fp32 out; with kRowQmax
// (quantize_rows_mixed) the thread reads its row's qmax beside its delta,
// once, and the clip is the same fminf(fmaxf(q, -qmax - 1), qmax).  Their
// bytes sit in a grid-stride loop's way when each element divides its index
// by cols for its row's delta and one 4-byte load is in flight a thread; so
// rows go on blockIdx.y (a row stride beyond 65,535 row tiles) and a thread
// takes kRowUnroll 16-byte column vectors of its row, a block row's width
// apart: at each step a warp reads 512 contiguous bytes, and at the paths'
// 512 columns a warp takes one row.
// The thread reads its row's delta once into a register, issues all its
// vectors' loads before it converts any, and writes int4 / float4 stores;
// no index is divided.  A column count that is not a multiple of 4, or an x
// or out whose base is not 16-byte aligned, takes the same kernel with one
// column a thread (VEC = 1).  The plan (vector width, block, grid) is
// picked in Python (kernels/quantize/quantize.py:rows_plan); the launcher
// checks it and returns the CUDA error otherwise.
// dequantize sweeps the flat codes as adafactor_apply sweeps its plane
// (csrc/opt_update.cu): a scalar head up to the first 16-byte address, int4
// loads and float4 stores, kFlatUnroll vectors a thread with all loads
// issued first, a scalar tail of at most 3 elements, and a grid sized to
// the work.  delta is read once a thread from device memory.  Codes and
// out at different offsets from 16 bytes share no aligned body, and every
// element is a vector of one.  The split is picked in Python
// (kernels/sweep.py:sweep_plan, shared with adafactor_apply); the launcher
// checks it.
// fused_quantize(_dequantize) needs a grid-wide max before any code can be
// written.  H100 blocks cannot wait on each other outside a cooperative
// launch, so it is one cooperative launch (cudaLaunchCooperativeKernel:
// every block resident at once) with one cooperative_groups grid sync:
// each block owns one contiguous span of x (the plan's `span` elements,
// its interior ends on 16-byte addresses) and copies the 16-byte-aligned
// part of it, up to the plan's `stage` elements, into dynamic shared
// memory in 16 KB chunks, cp.async.bulk into an mbarrier per chunk (one
// thread issues them all; 16-byte cp.async per thread timed the same).
// While the chunks land the block reads its streamed elements (the
// unaligned head and tail, and whatever of its span is beyond `stage`)
// with plain loads; then it takes |x| of each chunk as it lands,
// folds the block's max by warp shuffles and writes it to its own slot of
// a [grid] partials buffer (no zeroing, no atomics).  After the grid sync
// every block folds the grid's partials (max is order-free, so every
// block gets the same bits; a grid of one block, as tiny tensors take,
// skips the buffer and the sync), derives delta with one IEEE division, and
// writes its codes (or code * delta) from shared memory, 16-byte stores
// where out is aligned; the streamed elements are read from device memory
// a second time.  Block 0 writes delta.  So x is read from device memory
// once when the grid stages it whole (the ResNet18 teacher's 9.44 MB leaf
// fills 132 SMs to a third of their shared memory), and the call is one
// launch.  The launch plan (grid, span, stage) is picked in Python
// (kernels/quantize/quantize.py:fused_plan); the launcher checks it
// covers x and that the grid is co-resident at its shared memory, and
// returns the CUDA error otherwise.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

namespace {

// VEC consecutive elements: one 16-byte load or store (float4 / int4) when
// VEC is 4 (the launchers check the alignment), a scalar one when VEC is 1
template <typename T>
using Vec4 = std::conditional_t<std::is_same<T, float>::value, float4, int4>;

template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         T (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const Vec4<T> t = *reinterpret_cast<const Vec4<T>*>(src);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *src;
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ dst,
                                          const T (&v)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<Vec4<T>*>(dst) = Vec4<T>{v[0], v[1], v[2], v[3]};
  else
    *dst = v[0];
}

__host__ __device__ __forceinline__ bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

// -- the whole-tensor codec: one cooperative launch --------------------------
constexpr int kFusedThreads = 512;
constexpr int kChunk = 4096;     // floats a staging chunk (16 KB)
constexpr int kMaxChunks = 16;   // 256 KB: more than a block's shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one arrival (the thread that issues the copy) and the copy's bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {  // phase 0
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// one thread: `bytes` (a multiple of 16, both ends 16-byte aligned) from
// device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                        fmaxf(fabsf(v.z), fabsf(v.w))));
}

template <typename OutT>
struct Codec {
  float delta, qmax;
  __device__ __forceinline__ OutT operator()(float v) const {
    float q = floorf(__fadd_rn(__fdiv_rn(v, delta), 0.5f));
    q = fminf(fmaxf(q, -qmax - 1.f), qmax);
    if constexpr (std::is_same<OutT, float>::value)
      return __fmul_rn(q, delta);
    else
      return (int)q;
  }
  // four codes to out[0..3]; one 16-byte store when `vec`
  __device__ __forceinline__ void store4(OutT* out, float4 v,
                                         bool vec) const {
    const OutT a = (*this)(v.x), b = (*this)(v.y), c = (*this)(v.z),
               d = (*this)(v.w);
    if (vec) {
      if constexpr (std::is_same<OutT, float>::value)
        *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
      else
        *reinterpret_cast<int4*>(out) = make_int4(a, b, c, d);
    } else {
      out[0] = a;
      out[1] = b;
      out[2] = c;
      out[3] = d;
    }
  }
};

// -- the row codec: quantize_rows, quantize_dequantize_rows, dequantize_rows
constexpr int kRowThreads = 256;  // threads a block at most
constexpr int kRowUnroll = 4;     // vectors of its row a thread

// InT float: x quantized at its row's delta, OutT int the codes, OutT float
// the round trip; InT int: codes dequantized at their row's delta.  A
// thread owns kRowUnroll VEC-wide column vectors of one row, a block row's
// width apart; rows beyond the grid's row tiles are walked by a stride.
// kRowQmax (quantize_rows_mixed): each row clips to its own qmax, read from
// row_qmax beside its delta, once a thread a row; else every row clips to
// the scalar qmax.
template <typename InT, typename OutT, int VEC, bool kRowQmax>
__global__ void __launch_bounds__(kRowThreads) row_codec_kernel(
    const InT* __restrict__ x, const float* __restrict__ row_delta,
    const float* __restrict__ row_qmax, OutT* __restrict__ out,
    int64_t rows, int cols, float qmax) {
  const int c0 = (blockIdx.x * blockDim.x * kRowUnroll + threadIdx.x) * VEC;
  const int step = blockDim.x * VEC;
  for (int64_t row = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
       row < rows; row += (int64_t)gridDim.y * blockDim.y) {
    const Codec<OutT> codec{row_delta[row], kRowQmax ? row_qmax[row] : qmax};
    const InT* __restrict__ xr = x + row * cols;
    OutT* __restrict__ outr = out + row * cols;
    InT v[kRowUnroll][VEC];
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k)
      if (c0 + k * step < cols) load_vec<VEC>(xr + c0 + k * step, v[k]);
#pragma unroll
    for (int k = 0; k < kRowUnroll; ++k) {
      if (c0 + k * step < cols) {
        OutT o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if constexpr (std::is_same<InT, int>::value)
            o[j] = __fmul_rn((float)v[k][j], codec.delta);
          else
            o[j] = codec(v[k][j]);
        }
        store_vec<VEC>(outr + c0 + k * step, o);
      }
    }
  }
}

// -- the row absmax: rowabs, and rowabs_sum with the residual added -------
// VEC consecutive floats read once: ld.global.nc.L1::no_allocate (read-only,
// not kept in L1; timed faster than plain loads on the card, and unlike an
// evict-first load it leaves L2's policy alone for the row codec's second
// read of the payload)
template <int VEC>
__device__ __forceinline__ void load_once(const float* __restrict__ src,
                                          float (&v)[VEC]) {
  if constexpr (VEC == 4)
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, "
                 "[%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "l"(src));
  else
    asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n"
                 : "=f"(v[0])
                 : "l"(src));
}

// A warp owns a row (rows on the grid's y axis, a stride beyond 65,535 row
// tiles, as row_codec_kernel lays them out with one warp across a row) and
// walks it in steps of kRowUnroll VEC-wide vectors a lane, 32 * kRowUnroll *
// VEC columns a step: every load of a step (x, and res when kRes) is issued
// before any is folded; then a shuffle fold, and lane 0 writes the max.
template <bool kRes, int VEC>
__global__ void __launch_bounds__(kRowThreads) row_absmax_kernel(
    const float* __restrict__ x, const float* __restrict__ res,
    float* __restrict__ out, int64_t rows, int cols, float decay) {
  const int lane = threadIdx.x;  // blockDim.x is one warp
  constexpr int kStep = 32 * kRowUnroll * VEC;
  for (int64_t row = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
       row < rows; row += (int64_t)gridDim.y * blockDim.y) {
    const float* __restrict__ xr = x + row * cols;
    const float* __restrict__ rr = kRes ? res + row * cols : nullptr;
    float m = 0.f;
    for (int c0 = lane * VEC; c0 < cols; c0 += kStep) {
      float v[kRowUnroll][VEC], r[kRowUnroll][VEC];
#pragma unroll
      for (int k = 0; k < kRowUnroll; ++k) {
        if (c0 + k * 32 * VEC < cols) {
          load_once<VEC>(xr + c0 + k * 32 * VEC, v[k]);
          if constexpr (kRes) load_once<VEC>(rr + c0 + k * 32 * VEC, r[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kRowUnroll; ++k) {
        if (c0 + k * 32 * VEC < cols) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float e = v[k][j];
            if constexpr (kRes) e = __fadd_rn(e, __fmul_rn(decay, r[k][j]));
            m = fmaxf(m, fabsf(e));
          }
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) out[row] = m;
  }
}

// -- dequantize: the flat sweep at one scalar delta ---------------------------
constexpr int kFlatThreads = 256;
constexpr int kFlatUnroll = 4;  // vectors a thread

// head scalar elements, body VEC-wide vectors, tail scalar elements
template <int VEC>
__global__ void __launch_bounds__(kFlatThreads) dequantize_kernel(
    const int* __restrict__ codes, const float* __restrict__ delta,
    float* __restrict__ out, int64_t head, int64_t body, int tail) {
  const float d = *delta;
  const int64_t gid = (int64_t)blockIdx.x * kFlatThreads + threadIdx.x;
  if (gid < head) out[gid] = __fmul_rn((float)codes[gid], d);
  if (gid < tail) {
    const int64_t i = head + VEC * body + gid;
    out[i] = __fmul_rn((float)codes[i], d);
  }
  const int* __restrict__ c = codes + head;
  float* __restrict__ o = out + head;
  const int64_t v0 =
      (int64_t)blockIdx.x * (kFlatThreads * kFlatUnroll) + threadIdx.x;
  int cv[kFlatUnroll][VEC];
#pragma unroll
  for (int k = 0; k < kFlatUnroll; ++k) {
    const int64_t v = v0 + k * kFlatThreads;
    if (v < body) load_vec<VEC>(c + VEC * v, cv[k]);
  }
#pragma unroll
  for (int k = 0; k < kFlatUnroll; ++k) {
    const int64_t v = v0 + k * kFlatThreads;
    if (v < body) {
      float ov[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) ov[j] = __fmul_rn((float)cv[k][j], d);
      store_vec<VEC>(o + VEC * v, ov);
    }
  }
}

// Block b owns x[lo, hi): the elements at 16-byte address slots
// [b * span, (b + 1) * span) counted from x's 16-byte boundary below it.
// It stages [s_lo, s_hi) (16-byte aligned, at most `stage` elements) and
// streams [lo, s_lo) and [s_hi, hi).  OutT int: the codes; float: the round
// trip.
template <typename OutT>
__global__ void __launch_bounds__(kFusedThreads, 2)
    fused_codec_kernel(const float* __restrict__ x, OutT* __restrict__ out,
                       float* __restrict__ delta_out,
                       float* __restrict__ partials, int64_t n, float qmax,
                       int64_t span, int stage) {
  extern __shared__ __align__(16) float staged[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float warp_max[kFusedThreads / 32];
  __shared__ float amax;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t p = (int64_t)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int64_t lo = max((int64_t)0, (int64_t)blockIdx.x * span - p);
  const int64_t hi = min(n, ((int64_t)blockIdx.x + 1) * span - p);
  const int64_t s_lo = min(hi, ((lo + p + 3) & ~(int64_t)3) - p);
  const int64_t s_hi =
      max(s_lo, min(((hi + p) & ~(int64_t)3) - p, s_lo + stage));
  const int n_staged = (int)(s_hi - s_lo);  // a multiple of 4
  const int n_chunks = (n_staged + kChunk - 1) / kChunk;
  const int64_t r_vec = s_hi + ((hi - s_hi) & ~(int64_t)3);

  if (tid == 0) {
    for (int c = 0; c < n_chunks; ++c) mbar_init(&bars[c]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int c = 0; c < n_chunks; ++c) {
      const int base = c * kChunk;
      bulk_copy(staged + base, x + s_lo + base,
                4u * min(kChunk, n_staged - base), &bars[c]);
    }
  }
  __syncthreads();

  // pass 1: the streamed elements while the chunks land, then each chunk
  float m = 0.f;
  for (int64_t i = lo + tid; i < s_lo; i += nt) m = fmaxf(m, fabsf(x[i]));
  for (int64_t i = s_hi + 4 * tid; i < r_vec; i += 4 * nt)
    m = absmax4(m, *reinterpret_cast<const float4*>(x + i));
  for (int64_t i = r_vec + tid; i < hi; i += nt) m = fmaxf(m, fabsf(x[i]));
  for (int c = 0; c < n_chunks; ++c) {
    mbar_wait(&bars[c]);
    const int base = c * kChunk, len = min(kChunk, n_staged - base);
    for (int v = 4 * tid; v < len; v += 4 * nt)
      m = absmax4(m, *reinterpret_cast<const float4*>(staged + base + v));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  const bool one = gridDim.x == 1;  // a lone block's max is the grid's
  if (warp == 0) {
    m = lane < nt / 32 ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) *(one ? &amax : partials + blockIdx.x) = m;
  }
  if (!one) {
    cooperative_groups::this_grid().sync();
    if (warp == 0) {
      m = 0.f;
      for (int b = lane; b < (int)gridDim.x; b += 32)
        m = fmaxf(m, __ldcg(partials + b));
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) amax = m;
    }
  }
  __syncthreads();

  // pass 2: delta from the grid's max, then the codes
  const Codec<OutT> codec{fmaxf(__fdiv_rn(amax, qmax), FLT_MIN), qmax};
  if (blockIdx.x == 0 && tid == 0) *delta_out = codec.delta;
  // s_lo and s_hi lie a multiple of 4 elements apart in every block
  const bool vec = (reinterpret_cast<uintptr_t>(out + s_lo) & 15) == 0;
  for (int v = 4 * tid; v < n_staged; v += 4 * nt)
    codec.store4(out + s_lo + v, *reinterpret_cast<const float4*>(staged + v),
                 vec);
  for (int64_t i = lo + tid; i < s_lo; i += nt) out[i] = codec(x[i]);
  for (int64_t i = s_hi + 4 * tid; i < r_vec; i += 4 * nt)
    codec.store4(out + i, *reinterpret_cast<const float4*>(x + i), vec);
  for (int64_t i = r_vec + tid; i < hi; i += nt) out[i] = codec(x[i]);
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

constexpr int kMixThreads = 128;   // threads a block at most
constexpr int kMixBatch = 4;       // senders whose loads a thread issues
                                   // before it folds them

// One thread owns VEC consecutive columns of one row for the G receivers
// [blockIdx.z * G, + G) (fewer in a last, partial group): it reads each
// receiver's own vector once, then each sender's code vector and delta
// once for all of them, and writes each receiver's vector once.
template <typename CodeT, int G, int VEC>
__global__ void __launch_bounds__(kMixThreads) mix_packed_kernel(
    const float* __restrict__ own, const CodeT* __restrict__ codes,
    const float* __restrict__ row_delta, const float* __restrict__ w_self,
    const float* __restrict__ w_rows, float* __restrict__ out, int m, int s,
    int rows, int cols) {
  extern __shared__ float w_sh[];  // [G] self weights, then [G, s] rows
  const int m0 = blockIdx.z * G;
  const int mg = min(G, m - m0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (tid < mg) w_sh[tid] = w_self[m0 + tid];
  for (int i = tid; i < mg * s; i += nthreads)
    w_sh[G + i] = w_rows[(int64_t)m0 * s + i];
  __syncthreads();
  const float* ws = w_sh;
  const float* wr = w_sh + G;

  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c >= cols) return;
  const int64_t per = (int64_t)rows * cols;  // one node's buffer
  for (int row = blockIdx.y * blockDim.y + threadIdx.y; row < rows;
       row += gridDim.y * blockDim.y) {
    const int64_t e = (int64_t)row * cols + c;
    float acc[G][VEC];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k < mg) {
        float o[VEC];
        load_vec<VEC>(own + (m0 + k) * per + e, o);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[k][v] = __fmul_rn(ws[k], o[v]);
      }
    }
    for (int j0 = 0; j0 < s; j0 += kMixBatch) {
      // issue a batch of senders' loads, then fold them in sender order
      CodeT cd[kMixBatch][VEC];
      float d[kMixBatch];
#pragma unroll
      for (int b = 0; b < kMixBatch; ++b) {
        if (j0 + b < s) {
          load_vec<VEC>(codes + (j0 + b) * per + e, cd[b]);
          d[b] = row_delta[(int64_t)(j0 + b) * rows + row];
        }
      }
#pragma unroll
      for (int b = 0; b < kMixBatch; ++b) {
        if (j0 + b < s) {
          float deq[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            deq[v] = __fmul_rn((float)cd[b][v], d[b]);
#pragma unroll
          for (int k = 0; k < G; ++k) {
            if (k < mg) {
              const float w = wr[k * s + j0 + b];
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                acc[k][v] = __fadd_rn(acc[k][v], __fmul_rn(w, deq[v]));
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k < mg) store_vec<VEC>(out + (m0 + k) * per + e, acc[k]);
  }
}

}  // namespace

static int64_t sweep_blocks(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return blocks > 132 * 32 ? 132 * 32 : blocks;
}

// the row codec's launch, after checking its plan (kernels/quantize/
// quantize.py:rows_plan): the column vectors and the rows covered, each
// element by exactly one thread and no block empty; 16-byte vectors only on
// 16-byte aligned x and out whose rows are whole vectors.  A row_qmax column
// (quantize_rows_mixed) takes the kernel's per-row clip.
template <bool kRowQmax = false, typename InT, typename OutT>
static int row_launch(const InT* x, const float* row_delta,
                      const float* row_qmax, OutT* out, int64_t rows,
                      int cols, float qmax, int vec, int block_x,
                      int block_y, int grid_x, int grid_y,
                      cudaStream_t stream) {
  const int64_t span = (int64_t)block_x * kRowUnroll * vec;  // a block's
  if (rows <= 0 || cols <= 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && (cols % 4 || !aligned16(x) || !aligned16(out))) ||
      block_x <= 0 || block_y <= 0 || block_x * block_y > kRowThreads ||
      grid_x <= 0 || (int64_t)grid_x * span < cols ||
      (int64_t)(grid_x - 1) * span >= cols ||
      (int64_t)grid_x * span > INT32_MAX || grid_y <= 0 || grid_y > 65535 ||
      grid_y > (rows + block_y - 1) / block_y || (kRowQmax && !row_qmax))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  if (vec == 4)
    row_codec_kernel<InT, OutT, 4, kRowQmax><<<grid, block, 0, stream>>>(
        x, row_delta, row_qmax, out, rows, cols, qmax);
  else
    row_codec_kernel<InT, OutT, 1, kRowQmax><<<grid, block, 0, stream>>>(
        x, row_delta, row_qmax, out, rows, cols, qmax);
  return (int)cudaGetLastError();
}

extern "C" int quantize_rows(const float* x, const float* row_delta,
                             int* codes, int64_t rows, int cols, float qmax,
                             int vec, int block_x, int block_y, int grid_x,
                             int grid_y, cudaStream_t stream) {
  return row_launch(x, row_delta, nullptr, codes, rows, cols, qmax, vec,
                    block_x, block_y, grid_x, grid_y, stream);
}

extern "C" int quantize_dequantize_rows(const float* x,
                                        const float* row_delta, float* out,
                                        int64_t rows, int cols, float qmax,
                                        int vec, int block_x, int block_y,
                                        int grid_x, int grid_y,
                                        cudaStream_t stream) {
  return row_launch(x, row_delta, nullptr, out, rows, cols, qmax, vec,
                    block_x, block_y, grid_x, grid_y, stream);
}

extern "C" int dequantize_rows(const int* codes, const float* row_delta,
                               float* out, int64_t rows, int cols, int vec,
                               int block_x, int block_y, int grid_x,
                               int grid_y, cudaStream_t stream) {
  return row_launch(codes, row_delta, nullptr, out, rows, cols, 0.f, vec,
                    block_x, block_y, grid_x, grid_y, stream);
}

// dequantize's launch, after checking its split (kernels/sweep.py:
// sweep_plan): head, body and tail cover [0, n) once, the body starts on a
// 16-byte address of both codes and out where it is vectors of 4, and the
// grid holds the body's vectors with no block empty
extern "C" int dequantize(const int* codes, const float* delta, float* out,
                          int64_t n, int vec, int head, int64_t body,
                          int grid, cudaStream_t stream) {
  const int64_t tail = n - head - (int64_t)vec * body;
  const int64_t tile = (int64_t)kFlatThreads * kFlatUnroll;
  const int64_t blocks = body > 0 ? (body + tile - 1) / tile : 1;
  const bool ok =
      n > 0 && head >= 0 && body >= 0 && grid == blocks &&
      ((vec == 4 && head <= 3 && tail >= 0 && tail <= 3 &&
        aligned16(codes + head) && aligned16(out + head)) ||
       (vec == 1 && head == 0 && tail == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (vec == 4)
    dequantize_kernel<4><<<grid, kFlatThreads, 0, stream>>>(
        codes, delta, out, head, body, (int)tail);
  else
    dequantize_kernel<1><<<grid, kFlatThreads, 0, stream>>>(codes, delta,
                                                            out, 0, body, 0);
  return (int)cudaGetLastError();
}

// The co-resident limit of one instantiation at `smem` bytes of dynamic
// shared memory (the SM count times the occupancy query's blocks an SM),
// queried once per (device, kernel, smem) and cached: the queries would
// otherwise cost host time on every call.  The kernel's shared-memory
// opt-in is only ever raised, so every cached size stays launchable.
static cudaError_t fused_resident(const void* fn, int smem, int* limit) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> opted;
  static std::map<std::tuple<int, const void*, int>, int> resident;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, fn, smem);
  const auto hit = resident.find(key);
  if (hit != resident.end()) {
    *limit = hit->second;
    return cudaSuccess;
  }
  int& opt = opted[std::make_pair(dev, fn)];
  if (smem > opt) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    opt = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kFusedThreads, smem);
  if (err != cudaSuccess) return err;
  *limit = resident[key] = sms * per_sm;
  return cudaSuccess;
}

// the fused codec's one cooperative launch, after checking its plan: the
// spans cover x with no block empty, the staged part fits the shared
// memory, and the grid is co-resident at that shared memory
template <typename OutT>
static int fused_launch(const float* x, OutT* out, float* delta,
                        float* partials, int64_t n, float qmax, int grid,
                        int64_t span, int stage, cudaStream_t stream) {
  const int64_t p = (int64_t)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  if (n <= 0 || grid <= 0 || span <= 0 || span % 4 || stage < 0 ||
      stage % 4 || stage > kMaxChunks * kChunk ||
      (int64_t)grid * span < n + p || (int64_t)(grid - 1) * span >= n + p)
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)fused_codec_kernel<OutT>;
  const int smem = 4 * stage;
  int limit = 0;
  cudaError_t err = fused_resident(fn, smem, &limit);
  if (err == cudaSuccess && grid > limit)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err == cudaSuccess) {
    void* args[] = {(void*)&x,    (void*)&out, (void*)&delta,
                    (void*)&partials, (void*)&n, (void*)&qmax,
                    (void*)&span, (void*)&stage};
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kFusedThreads),
                                      args, (size_t)smem, stream);
  }
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return (int)(err != cudaSuccess ? err : last);
}

extern "C" int fused_quantize(const float* x, int* codes, float* delta,
                              float* partials, int64_t n, float qmax,
                              int grid, int64_t span, int stage,
                              cudaStream_t stream) {
  return fused_launch<int>(x, codes, delta, partials, n, qmax, grid, span,
                           stage, stream);
}

extern "C" int fused_quantize_dequantize(const float* x, float* out,
                                         float* delta, float* partials,
                                         int64_t n, float qmax, int grid,
                                         int64_t span, int stage,
                                         cudaStream_t stream) {
  return fused_launch<float>(x, out, delta, partials, n, qmax, grid, span,
                             stage, stream);
}

// the row codec with each row clipped to its own qmax (row_qmax [R])
extern "C" int quantize_rows_mixed(const float* x, const float* row_delta,
                                   int* codes, int64_t rows, int cols,
                                   const float* row_qmax, int vec,
                                   int block_x, int block_y, int grid_x,
                                   int grid_y, cudaStream_t stream) {
  return row_launch<true>(x, row_delta, row_qmax, codes, rows, cols, 0.f,
                          vec, block_x, block_y, grid_x, grid_y, stream);
}

// the row absmax's launch, after checking its plan (kernels/quantize/
// quantize.py:absmax_plan): one warp across a row, every row by exactly one
// warp, no block empty; 16-byte vectors only on 16-byte aligned x (and res)
// whose rows are whole vectors
template <bool kRes>
static int absmax_launch(const float* x, const float* res, float* out,
                         int64_t rows, int cols, float decay, int vec,
                         int block_x, int block_y, int grid_x, int grid_y,
                         cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && (cols % 4 || !aligned16(x) || (kRes && !aligned16(res)))) ||
      block_x != 32 || block_y <= 0 || block_x * block_y > kRowThreads ||
      grid_x != 1 || grid_y <= 0 || grid_y > 65535 ||
      grid_y > (rows + block_y - 1) / block_y)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  if (vec == 4)
    row_absmax_kernel<kRes, 4><<<grid, block, 0, stream>>>(x, res, out, rows,
                                                           cols, decay);
  else
    row_absmax_kernel<kRes, 1><<<grid, block, 0, stream>>>(x, res, out, rows,
                                                           cols, decay);
  return (int)cudaGetLastError();
}

extern "C" int rowabs(const float* x, float* out, int64_t rows, int cols,
                      int vec, int block_x, int block_y, int grid_x,
                      int grid_y, cudaStream_t stream) {
  return absmax_launch<false>(x, nullptr, out, rows, cols, 0.f, vec, block_x,
                              block_y, grid_x, grid_y, stream);
}

extern "C" int rowabs_sum(const float* x, const float* res, float* out,
                          int64_t rows, int cols, float decay, int vec,
                          int block_x, int block_y, int grid_x, int grid_y,
                          cudaStream_t stream) {
  return absmax_launch<true>(x, res, out, rows, cols, decay, vec, block_x,
                             block_y, grid_x, grid_y, stream);
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

// mix_packed's launch, after checking its plan (kernels/quantize/
// quantize.py:mix_plan): the receiver groups, the column vectors and the
// rows covered, each output by exactly one thread; 16-byte vectors only on
// 16-byte aligned buffers whose rows are whole vectors; the weights fit
// the static shared-memory limit
template <typename CodeT, int G, int VEC>
static void mix_launch(dim3 grid, dim3 block, int smem, const float* own,
                       const void* codes, const float* row_delta,
                       const float* w_self, const float* w_rows, float* out,
                       int m, int s, int rows, int cols,
                       cudaStream_t stream) {
  mix_packed_kernel<CodeT, G, VEC><<<grid, block, smem, stream>>>(
      own, (const CodeT*)codes, row_delta, w_self, w_rows, out, m, s, rows,
      cols);
}

template <typename CodeT, int VEC>
static int mix_group(int group, dim3 grid, dim3 block, int smem,
                     const float* own, const void* codes,
                     const float* row_delta, const float* w_self,
                     const float* w_rows, float* out, int m, int s, int rows,
                     int cols, cudaStream_t stream) {
  switch (group) {
    case 1: mix_launch<CodeT, 1, VEC>(grid, block, smem, own, codes,
                                      row_delta, w_self, w_rows, out, m, s,
                                      rows, cols, stream); break;
    case 2: mix_launch<CodeT, 2, VEC>(grid, block, smem, own, codes,
                                      row_delta, w_self, w_rows, out, m, s,
                                      rows, cols, stream); break;
    case 4: mix_launch<CodeT, 4, VEC>(grid, block, smem, own, codes,
                                      row_delta, w_self, w_rows, out, m, s,
                                      rows, cols, stream); break;
    case 8: mix_launch<CodeT, 8, VEC>(grid, block, smem, own, codes,
                                      row_delta, w_self, w_rows, out, m, s,
                                      rows, cols, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int mix_packed(const float* own, const void* codes,
                          const float* row_delta, const float* w_self,
                          const float* w_rows, float* out, int m, int s,
                          int64_t rows, int cols, int float_codes, int group,
                          int vec, int block_x, int block_y, int grid_x,
                          int grid_y, int grid_z, cudaStream_t stream) {
  if (m <= 0 || rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  const int smem = 4 * group * (s + 1);
  const int64_t span = (int64_t)block_x * vec;  // columns a block row
  if (s < 0 || rows > INT32_MAX || (vec != 1 && vec != 4) ||
      (vec == 4 && (cols % 4 || !aligned16(own) || !aligned16(codes) ||
                    !aligned16(out))) ||
      block_x <= 0 || block_y <= 0 || block_x * block_y > kMixThreads ||
      grid_x <= 0 || (int64_t)grid_x * span < cols ||
      (int64_t)(grid_x - 1) * span >= cols || grid_y <= 0 ||
      grid_y > 65535 || grid_y > (rows + block_y - 1) / block_y ||
      grid_z <= 0 || grid_z > 65535 || (int64_t)grid_z * group < m ||
      (int64_t)(grid_z - 1) * group >= m || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y, grid_z), block(block_x, block_y);
  const int r = (int)rows;
  if (float_codes)
    return vec == 4 ? mix_group<float, 4>(group, grid, block, smem, own,
                                          codes, row_delta, w_self, w_rows,
                                          out, m, s, r, cols, stream)
                    : mix_group<float, 1>(group, grid, block, smem, own,
                                          codes, row_delta, w_self, w_rows,
                                          out, m, s, r, cols, stream);
  return vec == 4 ? mix_group<int, 4>(group, grid, block, smem, own, codes,
                                      row_delta, w_self, w_rows, out, m, s,
                                      r, cols, stream)
                  : mix_group<int, 1>(group, grid, block, smem, own, codes,
                                      row_delta, w_self, w_rows, out, m, s,
                                      r, cols, stream);
}
