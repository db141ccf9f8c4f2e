"""Plain PyTorch version of the fused clip+adamw plane sweep.

``repro``'s ``adamw_update_ref`` expression for expression, over any
``[N, R, C]`` (or ``[R, C]``) plane buffer with a per-node clip scale
``[N]``: the moment EMAs on the clipped grad, bias correction by the
``bc1``/``bc2`` tensors, the decayed parameter step.  Each operation is
a separate PyTorch op (one rounding each), which is exactly what the
CUDA kernel (``csrc/opt_update.cu``) computes.  Scalars that divide are
tensors on the operands' device: PyTorch would turn a division by a
host scalar on the card into a reciprocal multiply.

The square root is :func:`sqrt_rn`: PyTorch's vectorized CPU
``torch.sqrt`` (SLEEF, 0.5001 ulp) is not always correctly rounded,
while JAX's, ``sqrtf`` on the card and the kernel's ``__fsqrt_rn`` are.
"""
from __future__ import annotations

import torch


def sqrt_rn(x):
    """IEEE (correctly rounded) fp32 square root on any device: the root
    in float64 rounded once to float32 is exact rounding, since
    53 >= 2 * 24 + 2 bits."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def adamw_update_ref(g, p, mu, nu, *, lr, scale, bc1, bc2, b1: float,
                     b2: float, eps: float, weight_decay: float):
    """Returns ``(new_p, new_mu, new_nu)``; ``scale`` holds one clip
    factor per ``[R, C]`` plane of the leading axes."""
    g32 = g * scale.reshape(tuple(g.shape[:-2]) + (1, 1))
    mu = b1 * mu + (1 - b1) * g32
    nu = b2 * nu + (1 - b2) * torch.square(g32)
    mh = mu / bc1
    vh = nu / bc2
    newp = p - lr * (mh / (sqrt_rn(vh) + eps) + weight_decay * p)
    return newp, mu, nu
