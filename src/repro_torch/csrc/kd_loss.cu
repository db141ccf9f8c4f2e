// Fused temperature-KD loss per row, for Hopper (sm_90a).
//
// Replaces repro/kernels/kd_loss/kd_loss.py:kd_loss_rows_pallas.
//   out[r] = KL(softmax(yt[r] / T) || softmax(ys[r] / T)) * T^2
// ys, yt [R, V], both fp32 or both bf16 (cast to fp32 on load), out [R] fp32,
// in one pass over the logits: neither [R, V] probability tensor is made.
// Online state (the Pallas body's, kd_loss.py:47-62):
//   m_t, l_t  teacher running max and normaliser
//   u         running sum of exp(yt - m_t) * (yt - ys)
//   m_s, l_s  student running max and normaliser
// finished as  u / l_t - (m_t - m_s) - (log l_t - log l_s),  divided by
// inv_t^2 (the TPU kernel multiplies by inv_t = 1/T and divides by inv_t^2).
//
// What bounds it on the H100: at an LM vocabulary (256 rows x V = 202,048) it
// must read 207 MB in bf16 (0.062 ms at 3.35 TB/s) and do about 2 exp per
// logit and side, so bytes.  Design, simple and right: one block per row; each
// thread walks a strided range of the vocabulary, four elements' loads issued
// before their updates, and keeps its own online state, updated per element
// with the Pallas rescaling (a tile of one element: the side whose max moves
// rescales by exp(m_old - m_new) and adds exp(0) = 1, else adds exp(y - m)).
// The per-thread states merge through warp shuffles and then shared memory
// with the same rescaling: l = l_a e^(m_a - m) + l_b e^(m_b - m), u likewise.
// expf and logf are the accurate ones (no fast math).  Ragged V needs no
// padding: the walk stops at V.  One block per row leaves 256 blocks on 132
// SMs at the LM shape; splitting V over blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's initial max
constexpr int kUnroll = 4;

struct State {
  float mt, lt, u, ms, ls;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one logit pair, already scaled by inv_t
__device__ __forceinline__ void update(State& st, float ys, float yt) {
  if (yt > st.mt) {
    const float corr = expf(st.mt - yt);
    st.lt = st.lt * corr + 1.f;
    st.u = st.u * corr + (yt - ys);
    st.mt = yt;
  } else {
    const float pt = expf(yt - st.mt);
    st.lt = st.lt + pt;
    st.u = st.u + pt * (yt - ys);
  }
  if (ys > st.ms) {
    st.ls = st.ls * expf(st.ms - ys) + 1.f;
    st.ms = ys;
  } else {
    st.ls = st.ls + expf(ys - st.ms);
  }
}

__device__ __forceinline__ void merge(State& a, const State& b) {
  const float mt = fmaxf(a.mt, b.mt);
  const float ca = expf(a.mt - mt), cb = expf(b.mt - mt);
  a.lt = a.lt * ca + b.lt * cb;
  a.u = a.u * ca + b.u * cb;
  a.mt = mt;
  const float ms = fmaxf(a.ms, b.ms);
  a.ls = a.ls * expf(a.ms - ms) + b.ls * expf(b.ms - ms);
  a.ms = ms;
}

__device__ __forceinline__ void warp_merge(State& st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    State o;
    o.mt = __shfl_down_sync(0xffffffffu, st.mt, off);
    o.lt = __shfl_down_sync(0xffffffffu, st.lt, off);
    o.u = __shfl_down_sync(0xffffffffu, st.u, off);
    o.ms = __shfl_down_sync(0xffffffffu, st.ms, off);
    o.ls = __shfl_down_sync(0xffffffffu, st.ls, off);
    merge(st, o);
  }
}

// blockDim.x is a multiple of 32, at most 1024
template <typename T>
__global__ void kd_loss_kernel(const T* __restrict__ ys,
                               const T* __restrict__ yt,
                               float* __restrict__ out, int64_t v,
                               float inv_t, float inv_t_sq) {
  __shared__ State warps[32];
  const T* s = ys + (int64_t)blockIdx.x * v;
  const T* t = yt + (int64_t)blockIdx.x * v;
  const int64_t step = blockDim.x;
  State st{kNegInf, 0.f, 0.f, kNegInf, 0.f};
  int64_t j = threadIdx.x;
  for (; j + (kUnroll - 1) * step < v; j += kUnroll * step) {
    float a[kUnroll], b[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      a[q] = to_f32(s[j + q * step]);
      b[q] = to_f32(t[j + q * step]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) update(st, a[q] * inv_t, b[q] * inv_t);
  }
  for (; j < v; j += step)
    update(st, to_f32(s[j]) * inv_t, to_f32(t[j]) * inv_t);

  warp_merge(st);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warps[warp] = st;
  __syncthreads();
  if (warp != 0) return;
  st = lane < (int)(blockDim.x / 32) ? warps[lane]
                                     : State{kNegInf, 0.f, 0.f, kNegInf, 0.f};
  warp_merge(st);
  if (lane == 0) {
    const float kl = st.u / st.lt - (st.mt - st.ms) -
                     (logf(st.lt) - logf(st.ls));
    out[blockIdx.x] = kl / inv_t_sq;
  }
}

template <typename T>
int launch(const void* ys, const void* yt, float* out, int64_t rows,
           int64_t v, float inv_t, float inv_t_sq, cudaStream_t stream) {
  if (rows > 0 && v > 0) {
    // about 8 logits a thread or more, in whole warps, at most 1024 threads
    int64_t threads = ((v + 7) / 8 + 31) / 32 * 32;
    threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
    kd_loss_kernel<T><<<(unsigned)rows, (unsigned)threads, 0, stream>>>(
        static_cast<const T*>(ys), static_cast<const T*>(yt), out, v, inv_t,
        inv_t_sq);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: the logits are bf16, else fp32.
extern "C" int kd_loss_rows(const void* ys, const void* yt, float* out,
                            int64_t rows, int64_t v, float inv_t,
                            float inv_t_sq, int bf16, cudaStream_t stream) {
  return bf16 ? launch<__nv_bfloat16>(ys, yt, out, rows, v, inv_t, inv_t_sq,
                                      stream)
              : launch<float>(ys, yt, out, rows, v, inv_t, inv_t_sq, stream);
}
