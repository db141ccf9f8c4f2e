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
// write 4 B per element too, and reads x from device memory once where the
// grid can stage it (see below).
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
