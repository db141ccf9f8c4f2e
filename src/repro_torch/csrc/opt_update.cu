// Fused optimizer sweeps over the flat parameter plane, for Hopper (sm_90a):
// clip + adamw, clip + sgd with momentum, and the adafactor apply.
//
// adamw_update replaces
// repro/kernels/opt_update/opt_update.py:adamw_update_pallas.
// What bounds it on the H100: bytes.  Per element it reads g, p, mu, nu
// and writes p, mu, nu (7 x 4 B) for ~20 flops, far below the card's
// ~20 flop/B balance point.  Design: one launch sweeps all N nodes' planes
// (the TPU ran one vmapped call) as a vectorized per-node sweep:
// blockIdx.y is the node, so no index is divided, and a thread reads the
// runtime scalar lr and its node's clip scale and bias corrections bc1,
// bc2 (each node keeps its own step counter) once from device memory, so
// the step never waits on the host.  Along the node's plane a thread owns
// one 16-byte float4 vector and loads its g, p, mu and nu before any
// arithmetic, in blocks of 256 threads; the grid is sized to the work (no
// grid-stride loop), with 32-bit in-node indices where they fit.  On the
// H100 one vector a thread timed faster than 2 or 4 at every path's plane,
// at the speed of a same-byte copy_, and cache hints on g or on the stores
// timed no faster.  Where a buffer is not 16-byte aligned, or a node's
// plane is not a whole number of vectors (so a vector would span two
// nodes), the same kernel runs with one element a vector.  The plan
// (vector width, grid) is picked in Python
// (kernels/opt_update/opt_update.py:adamw_plan); the launcher checks it.
// Updates p, mu and nu IN PLACE.
//
// The per-node mask: where `active` is given (one byte a node), the blocks
// of a node whose byte is 0 return before any load, nothing of its planes
// read or written, so its parameters and moments leave the step
// bit-unchanged (a padded step of a node with fewer local batches).  With
// `active` null (every iid step) no mask is read.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic in the
// order of the plain PyTorch version (kernels/opt_update/ref.py); with
// -fmad=false nothing contracts into an FMA, so the kernel is bit-identical
// to the plain version on the same inputs.
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

// One element's step, every operation rounded on its own in the plain
// version's order
struct AdamW {
  float lr, s, c1, c2, b1, one_m_b1, b2, one_m_b2, eps, wd;
  __device__ __forceinline__ void operator()(float g, float& p, float& mu,
                                             float& nu) const {
    const float g32 = __fmul_rn(g, s);
    const float m = __fadd_rn(__fmul_rn(b1, mu), __fmul_rn(one_m_b1, g32));
    const float v = __fadd_rn(__fmul_rn(b2, nu),
                              __fmul_rn(one_m_b2, __fmul_rn(g32, g32)));
    const float mh = __fdiv_rn(m, c1);
    const float vh = __fdiv_rn(v, c2);
    const float upd = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), eps)),
                                __fmul_rn(wd, p));
    mu = m;
    nu = v;
    p = __fsub_rn(p, __fmul_rn(lr, upd));
  }
  __device__ __forceinline__ void operator()(float4 g, float4& p, float4& mu,
                                             float4& nu) const {
    (*this)(g.x, p.x, mu.x, nu.x);
    (*this)(g.y, p.y, mu.y, nu.y);
    (*this)(g.z, p.z, mu.z, nu.z);
    (*this)(g.w, p.w, mu.w, nu.w);
  }
};

constexpr int kAdamThreads = 256;  // threads a block

// Node blockIdx.y's plane, from its element 0, in VEC-wide vectors: a
// thread owns one vector of it and loads its g, p, mu and nu before any
// arithmetic.  IndexT indexes within the node.
template <int VEC, typename IndexT>
__global__ void __launch_bounds__(kAdamThreads) adamw_update_kernel(
    const float* __restrict__ g, float* __restrict__ p, float* __restrict__ mu,
    float* __restrict__ nu, const float* __restrict__ lr,
    const float* __restrict__ scale, const float* __restrict__ bc1,
    const float* __restrict__ bc2, const uint8_t* __restrict__ active,
    int64_t node_elems, float b1, float one_m_b1, float b2, float one_m_b2,
    float eps, float wd) {
  using V = std::conditional_t<VEC == 4, float4, float>;
  const int node = blockIdx.y;
  if (active != nullptr && !active[node]) return;
  const IndexT v = (IndexT)blockIdx.x * kAdamThreads + threadIdx.x;
  if (v >= (IndexT)(node_elems / VEC)) return;
  const AdamW step{*lr,     scale[node], bc1[node], bc2[node], b1,
                   one_m_b1, b2,         one_m_b2,  eps,       wd};
  const int64_t base = (int64_t)node * node_elems;
  const V* __restrict__ gv = reinterpret_cast<const V*>(g + base);
  V* __restrict__ pv = reinterpret_cast<V*>(p + base);
  V* __restrict__ mv = reinterpret_cast<V*>(mu + base);
  V* __restrict__ nv = reinterpret_cast<V*>(nu + base);
  V gk = gv[v], pk = pv[v], mk = mv[v], nk = nv[v];
  step(gk, pk, mk, nk);
  mv[v] = mk;
  nv[v] = nk;
  pv[v] = pk;
}

// sgd_update replaces repro/kernels/opt_update/opt_update.py:
// sgd_update_pallas.  Bytes bound it: per element it reads g, p, mu and
// writes p, mu (5 x 4 B) for 6 flops.  One launch over all N nodes' planes,
// a node per blockIdx.y, its clip scale and lr read once a thread, the
// blocks of a node running a grid-stride loop over its plane one element a
// thread (sweep_grid, below), the same per-node mask as adamw_update, p and
// mu updated IN PLACE, every operation a _rn intrinsic in the plain
// version's order:
//   mu' = momentum * mu + g * scale;  p' = p - lr * (mu' + wd * p).
__global__ void sgd_update_kernel(const float* __restrict__ g,
                                  float* __restrict__ p,
                                  float* __restrict__ mu,
                                  const float* __restrict__ lr,
                                  const float* __restrict__ scale,
                                  const uint8_t* __restrict__ active,
                                  int64_t node_elems, float momentum,
                                  float wd) {
  const int node = blockIdx.y;
  if (active != nullptr && !active[node]) return;
  const float lr_v = *lr;
  const float s = scale[node];
  const int64_t base = (int64_t)node * node_elems;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j < node_elems; j += stride) {
    const int64_t i = base + j;
    const float g32 = __fmul_rn(g[i], s);
    const float m = __fadd_rn(__fmul_rn(momentum, mu[i]), g32);
    const float pi = p[i];
    mu[i] = m;
    p[i] = __fsub_rn(pi, __fmul_rn(lr_v, __fadd_rn(m, __fmul_rn(wd, pi))));
  }
}

// adafactor_apply replaces repro/kernels/opt_update/opt_update.py:
// adafactor_apply_pallas.  Bytes bound it: it reads upd and p and writes p
// (3 x 4 B) for 4 flops.  The factored moments and the per-leaf RMS clip are
// shape-dependent and stay per plane segment upstream (kernels/opt_update/
// ops.py); this is the one elementwise pass over all N nodes' planes:
//   p' = p - lr * (upd + wd * p), IN PLACE.
// Design: a vectorized sweep.  The body is 16-byte float4 loads and stores
// from the first 16-byte aligned element on; a scalar head (at most 3
// elements, before that address) and tail (at most 3, after the body) are
// done by the first threads of the grid.  Each thread issues the loads of all
// its kAdaUnroll vectors, a block's tile apart, before any arithmetic, so
// 2 * kAdaUnroll 16-byte loads are in flight; the grid is sized to the work
// (no grid-stride loop), with 32-bit indices below 2^30 elements.  lr is
// read once a thread.  Where upd and p do not share their offset from a
// 16-byte boundary there is no common aligned body, and the same kernel
// runs with one element a vector.  The split (vector width, head, body in
// vectors, grid) is picked in Python (kernels/opt_update/opt_update.py:
// adafactor_plan, through kernels/sweep.py:sweep_plan, which the scalar-delta
// dequantize in csrc/quantize.cu shares); the launcher checks it.  The
// per-node mask of adamw_update applies here too: an element's node is
// i / node_elems, and where `active` is given a vector of a node that skips
// the step is neither read nor written (no float4 vector spans two nodes:
// the wrapper checks the node size and the head against the vector width).
constexpr int kAdaThreads = 256;
constexpr int kAdaUnroll = 4;  // vectors a thread

__device__ __forceinline__ float adafactor_step(float u, float pi, float lr,
                                                float wd) {
  return __fsub_rn(pi, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, pi))));
}

__device__ __forceinline__ float4 adafactor_step(float4 u, float4 pi,
                                                 float lr, float wd) {
  return make_float4(adafactor_step(u.x, pi.x, lr, wd),
                     adafactor_step(u.y, pi.y, lr, wd),
                     adafactor_step(u.z, pi.z, lr, wd),
                     adafactor_step(u.w, pi.w, lr, wd));
}

// Whether element i's node takes the step: always without a mask.
template <typename IndexT>
__device__ __forceinline__ bool node_on(const uint8_t* __restrict__ active,
                                        IndexT i, IndexT node_elems) {
  return active == nullptr || active[i / node_elems] != 0;
}

template <int VEC, typename IndexT>
__global__ void __launch_bounds__(kAdaThreads) adafactor_apply_kernel(
    const float* __restrict__ upd, float* __restrict__ p,
    const float* __restrict__ lr, const uint8_t* __restrict__ active,
    IndexT node_elems, IndexT head, IndexT body, int tail, float wd) {
  using V = std::conditional_t<VEC == 4, float4, float>;
  const float lr_v = *lr;
  const IndexT gid = (IndexT)blockIdx.x * kAdaThreads + threadIdx.x;
  if (gid < head && node_on(active, gid, node_elems))
    p[gid] = adafactor_step(upd[gid], p[gid], lr_v, wd);
  if (gid < tail) {
    const IndexT i = head + (IndexT)VEC * body + gid;
    if (node_on(active, i, node_elems))
      p[i] = adafactor_step(upd[i], p[i], lr_v, wd);
  }
  const V* __restrict__ u = reinterpret_cast<const V*>(upd + head);
  V* __restrict__ q = reinterpret_cast<V*>(p + head);
  const IndexT v0 =
      (IndexT)blockIdx.x * (kAdaThreads * kAdaUnroll) + threadIdx.x;
  // a vector never straddles two nodes (the wrapper checks it), so its
  // first element's node is its node
  bool on[kAdaUnroll];
  V uv[kAdaUnroll], pv[kAdaUnroll];
#pragma unroll
  for (int k = 0; k < kAdaUnroll; ++k) {
    const IndexT v = v0 + k * kAdaThreads;
    on[k] = v < body && node_on(active, head + (IndexT)VEC * v, node_elems);
    if (on[k]) {
      uv[k] = u[v];
      pv[k] = q[v];
    }
  }
#pragma unroll
  for (int k = 0; k < kAdaUnroll; ++k) {
    const IndexT v = v0 + k * kAdaThreads;
    if (on[k]) q[v] = adafactor_step(uv[k], pv[k], lr_v, wd);
  }
}

// The grid of sgd_update: a node per grid row (at most
// 65,535), each node's blocks covering its plane one element a thread, at
// most 132 * 32 blocks in all (a grid-stride loop beyond that).  Returns
// false where the planes do not fit.
bool sweep_grid(int64_t n, int64_t node_elems, int threads, dim3* grid) {
  if (node_elems <= 0 || n % node_elems != 0) return false;
  const int64_t planes = n / node_elems;
  if (planes > 65535) return false;
  int64_t per_node = (node_elems + threads - 1) / threads;
  int64_t cap = (int64_t)132 * 32 / planes;
  if (cap < 1) cap = 1;
  if (per_node > cap) per_node = cap;
  *grid = dim3((unsigned)per_node, (unsigned)planes);
  return true;
}

}  // namespace

extern "C" int sgd_update(const float* g, float* p, float* mu,
                          const float* lr, const float* scale,
                          const uint8_t* active, int64_t n,
                          int64_t node_elems, float momentum, float wd,
                          cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    dim3 grid;
    if (!sweep_grid(n, node_elems, threads, &grid))
      return (int)cudaErrorInvalidValue;
    sgd_update_kernel<<<grid, threads, 0, stream>>>(
        g, p, mu, lr, scale, active, node_elems, momentum, wd);
  }
  return (int)cudaGetLastError();
}

// adafactor_apply's launch, after checking its plan: head, body and tail
// cover [0, n) once, the body starts on a 16-byte address of both upd and p
// where it is float4, and the grid holds the body's vectors with no block
// empty
template <int VEC, typename IndexT>
static void adafactor_launch(const float* upd, float* p, const float* lr,
                             const uint8_t* active, int64_t node_elems,
                             int64_t head, int64_t body, int tail, float wd,
                             int grid, cudaStream_t stream) {
  adafactor_apply_kernel<VEC, IndexT><<<grid, kAdaThreads, 0, stream>>>(
      upd, p, lr, active, (IndexT)node_elems, (IndexT)head, (IndexT)body,
      tail, wd);
}

extern "C" int adafactor_apply(const float* upd, float* p, const float* lr,
                               const uint8_t* active, int64_t node_elems,
                               int64_t n, float wd, int vec, int head,
                               int64_t body, int grid, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto aligned16 = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const int64_t tail = n - head - (int64_t)vec * body;
  const int64_t tile = (int64_t)kAdaThreads * kAdaUnroll;
  const int64_t blocks = body > 0 ? (body + tile - 1) / tile : 1;
  const bool ok =
      head >= 0 && body >= 0 && grid == blocks &&
      ((vec == 4 && head <= 3 && tail >= 0 && tail <= 3 &&
        aligned16(upd + head) && aligned16(p + head)) ||
       (vec == 1 && head == 0 && tail == 0)) &&
      node_elems > 0 &&
      // with a mask, no vector spans two nodes
      (active == nullptr || vec == 1 || n <= node_elems ||
       (node_elems % 4 == 0 && head == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const bool narrow = n < (int64_t(1) << 30);  // 32-bit indices
  if (vec == 4) {
    if (narrow)
      adafactor_launch<4, int>(upd, p, lr, active, node_elems, head, body,
                               (int)tail, wd, grid, stream);
    else
      adafactor_launch<4, int64_t>(upd, p, lr, active, node_elems, head,
                                   body, (int)tail, wd, grid, stream);
  } else {
    if (narrow)
      adafactor_launch<1, int>(upd, p, lr, active, node_elems, head, body, 0,
                               wd, grid, stream);
    else
      adafactor_launch<1, int64_t>(upd, p, lr, active, node_elems, head,
                                   body, 0, wd, grid, stream);
  }
  return (int)cudaGetLastError();
}

template <int VEC>
static void adamw_launch(dim3 grid, bool narrow, const float* g, float* p,
                         float* mu, float* nu, const float* lr,
                         const float* scale, const float* bc1,
                         const float* bc2, const uint8_t* active,
                         int64_t node_elems, float b1, float one_m_b1,
                         float b2, float one_m_b2, float eps, float wd,
                         cudaStream_t stream) {
  if (narrow)
    adamw_update_kernel<VEC, int><<<grid, kAdamThreads, 0, stream>>>(
        g, p, mu, nu, lr, scale, bc1, bc2, active, node_elems, b1, one_m_b1,
        b2, one_m_b2, eps, wd);
  else
    adamw_update_kernel<VEC, int64_t><<<grid, kAdamThreads, 0, stream>>>(
        g, p, mu, nu, lr, scale, bc1, bc2, active, node_elems, b1, one_m_b1,
        b2, one_m_b2, eps, wd);
}

// adamw_update's launch, after checking its plan (kernels/opt_update/
// opt_update.py:adamw_plan): a node a grid row, each node's vectors held by
// its grid_x blocks with none empty, 16-byte vectors only where all four
// buffers start on 16-byte addresses and no vector spans two nodes
extern "C" int adamw_update(const float* g, float* p, float* mu, float* nu,
                            const float* lr, const float* scale,
                            const float* bc1, const float* bc2,
                            const uint8_t* active, int64_t n,
                            int64_t node_elems, float b1, float one_m_b1,
                            float b2, float one_m_b2, float eps, float wd,
                            int vec, int grid_x, int grid_y,
                            cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto aligned16 = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const bool ok =
      node_elems > 0 && n % node_elems == 0 && grid_y == n / node_elems &&
      grid_y <= 65535 && (vec == 1 || vec == 4) &&
      (vec == 1 || (node_elems % 4 == 0 && aligned16(g) && aligned16(p) &&
                    aligned16(mu) && aligned16(nu)));
  if (!ok) return (int)cudaErrorInvalidValue;
  const int64_t vecs = node_elems / vec;
  if (grid_x != (vecs + kAdamThreads - 1) / kAdamThreads)
    return (int)cudaErrorInvalidValue;
  // 32-bit in-node indices while the last thread's vector fits
  const bool narrow = (int64_t)grid_x * kAdamThreads < (int64_t(1) << 31);
  const dim3 grid(grid_x, grid_y);
  if (vec == 4)
    adamw_launch<4>(grid, narrow, g, p, mu, nu, lr, scale, bc1, bc2, active,
                    node_elems, b1, one_m_b1, b2, one_m_b2, eps, wd, stream);
  else
    adamw_launch<1>(grid, narrow, g, p, mu, nu, lr, scale, bc1, bc2, active,
                    node_elems, b1, one_m_b1, b2, one_m_b2, eps, wd, stream);
  return (int)cudaGetLastError();
}
