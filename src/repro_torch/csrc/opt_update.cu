// Fused optimizer sweeps over the flat parameter plane, for Hopper (sm_90a):
// clip + adamw, clip + sgd with momentum, and the adafactor apply.
//
// adamw_update replaces
// repro/kernels/opt_update/opt_update.py:adamw_update_pallas.
// What bounds it on the H100: bytes.  Per element it reads g, p, mu, nu
// and writes p, mu, nu (7 x 4 B) for ~20 flops, far below the card's
// ~20 flop/B balance point.  Design: one grid-stride elementwise sweep over
// all N nodes' planes at once (the TPU ran one vmapped call), neighbouring
// threads on neighbouring addresses so every load and store coalesces.  The
// runtime scalars lr, bc1, bc2 are read once per thread from device memory
// and the per-node clip scale is indexed by i / node_elems, so the step never
// waits on the host.  Updates p, mu and nu IN PLACE.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic in the
// order of the plain PyTorch version (kernels/opt_update/ref.py); with
// -fmad=false nothing contracts into an FMA, so the kernel is bit-identical
// to the plain version on the same inputs.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void adamw_update_kernel(
    const float* __restrict__ g, float* __restrict__ p, float* __restrict__ mu,
    float* __restrict__ nu, const float* __restrict__ lr,
    const float* __restrict__ scale, const float* __restrict__ bc1,
    const float* __restrict__ bc2, int64_t n, int64_t node_elems, float b1,
    float one_m_b1, float b2, float one_m_b2, float eps, float wd) {
  const float lr_v = *lr;
  const float c1 = *bc1;
  const float c2 = *bc2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g32 = __fmul_rn(g[i], scale[i / node_elems]);
    const float m = __fadd_rn(__fmul_rn(b1, mu[i]), __fmul_rn(one_m_b1, g32));
    const float v = __fadd_rn(__fmul_rn(b2, nu[i]),
                              __fmul_rn(one_m_b2, __fmul_rn(g32, g32)));
    const float pi = p[i];
    const float mh = __fdiv_rn(m, c1);
    const float vh = __fdiv_rn(v, c2);
    const float upd = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), eps)),
                                __fmul_rn(wd, pi));
    mu[i] = m;
    nu[i] = v;
    p[i] = __fsub_rn(pi, __fmul_rn(lr_v, upd));
  }
}

// sgd_update replaces repro/kernels/opt_update/opt_update.py:
// sgd_update_pallas.  Bytes bound it: per element it reads g, p, mu and
// writes p, mu (5 x 4 B) for 6 flops.  The same design as adamw_update: one
// grid-stride sweep over all N nodes' planes, the per-node clip scale at
// i / node_elems, lr from device memory, p and mu updated IN PLACE, every
// operation a _rn intrinsic in the plain version's order:
//   mu' = momentum * mu + g * scale;  p' = p - lr * (mu' + wd * p).
__global__ void sgd_update_kernel(const float* __restrict__ g,
                                  float* __restrict__ p,
                                  float* __restrict__ mu,
                                  const float* __restrict__ lr,
                                  const float* __restrict__ scale, int64_t n,
                                  int64_t node_elems, float momentum,
                                  float wd) {
  const float lr_v = *lr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g32 = __fmul_rn(g[i], scale[i / node_elems]);
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
__global__ void adafactor_apply_kernel(const float* __restrict__ upd,
                                       float* __restrict__ p,
                                       const float* __restrict__ lr,
                                       int64_t n, float wd) {
  const float lr_v = *lr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    p[i] = __fsub_rn(pi, __fmul_rn(lr_v, __fadd_rn(upd[i], __fmul_rn(wd, pi))));
  }
}

int64_t sweep_blocks(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return blocks > 132 * 32 ? 132 * 32 : blocks;  // grid-stride beyond that
}

}  // namespace

extern "C" int sgd_update(const float* g, float* p, float* mu,
                          const float* lr, const float* scale, int64_t n,
                          int64_t node_elems, float momentum, float wd,
                          cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    sgd_update_kernel<<<(unsigned)sweep_blocks(n, threads), threads, 0,
                        stream>>>(g, p, mu, lr, scale, n, node_elems,
                                  momentum, wd);
  }
  return (int)cudaGetLastError();
}

extern "C" int adafactor_apply(const float* upd, float* p, const float* lr,
                               int64_t n, float wd, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    adafactor_apply_kernel<<<(unsigned)sweep_blocks(n, threads), threads, 0,
                             stream>>>(upd, p, lr, n, wd);
  }
  return (int)cudaGetLastError();
}

extern "C" int adamw_update(const float* g, float* p, float* mu, float* nu,
                            const float* lr, const float* scale,
                            const float* bc1, const float* bc2, int64_t n,
                            int64_t node_elems, float b1, float one_m_b1,
                            float b2, float one_m_b2, float eps, float wd,
                            cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    adamw_update_kernel<<<(unsigned)sweep_blocks(n, threads), threads, 0,
                          stream>>>(
        g, p, mu, nu, lr, scale, bc1, bc2, n, node_elems, b1, one_m_b1, b2,
        one_m_b2, eps, wd);
  }
  return (int)cudaGetLastError();
}
