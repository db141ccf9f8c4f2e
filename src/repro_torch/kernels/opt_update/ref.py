"""Plain PyTorch versions of the fused plane sweeps: clip+sgd,
clip+adamw and the adafactor apply.

``repro``'s ``sgd_update_ref``, ``adamw_update_ref`` and
``adafactor_apply_ref`` expression for expression, over any ``[N, R,
C]`` (or ``[R, C]``) plane buffer; sgd and adamw take a per-node clip
scale ``[N]``, adamw per-node bias corrections (``[N]``, or one for
every node).  Each takes an optional per-node mask ``active`` ``[N]``
(bool): a node whose entry is false comes back bit-unchanged, as
``repro``'s ``_masked_select`` keeps a padded step's node.  Each operation is a separate PyTorch op (one rounding
each), which is exactly what the CUDA kernels (``csrc/opt_update.cu``)
compute.  Runtime scalars (``lr``, the bias corrections ``bc1``/``bc2``)
are tensors on the operands' device: PyTorch would turn a division by a
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


def per_node(x, like):
    """``x`` (0-d, or one entry per node of ``like``'s leading axis)
    shaped to broadcast against ``like``."""
    return x.reshape(tuple(x.shape) + (1,) * (like.dim() - x.dim()))


def keep_masked(active, new, old):
    """``new`` on the nodes ``active`` (``[N]`` bool or uint8) selects,
    ``old`` elsewhere; all of ``new`` when ``active`` is None."""
    if active is None:
        return new
    return torch.where(per_node(active.to(torch.bool), old), new, old)


def sgd_update_ref(g, p, mu, *, lr, scale, momentum: float,
                   weight_decay: float, active=None):
    """One clipped sgd+momentum step over ``[N, R, C]`` planes with a
    per-node clip scale ``[N]``: ``mu' = momentum·mu + g·scale``,
    ``p' = p - lr·(mu' + wd·p)``.  Returns ``(new_p, new_mu)``."""
    g = g * per_node(scale, g)
    new_mu = momentum * mu + g
    newp = p - lr * (new_mu + weight_decay * p)
    return keep_masked(active, newp, p), keep_masked(active, new_mu, mu)


def adafactor_apply_ref(upd, p, *, lr, weight_decay: float, active=None):
    """The adafactor apply over a plane buffer: ``p' = p - lr·(upd +
    wd·p)``, where ``upd`` is the packed per-segment clipped update."""
    return keep_masked(active, p - lr * (upd + weight_decay * p), p)


def adamw_update_ref(g, p, mu, nu, *, lr, scale, bc1, bc2, b1: float,
                     b2: float, eps: float, weight_decay: float,
                     active=None):
    """Returns ``(new_p, new_mu, new_nu)``; ``scale`` holds one clip
    factor per ``[R, C]`` plane of the leading axes, ``bc1`` and ``bc2``
    one bias correction per plane (or one for all)."""
    g32 = g * per_node(scale, g)
    new_mu = b1 * mu + (1 - b1) * g32
    new_nu = b2 * nu + (1 - b2) * torch.square(g32)
    mh = new_mu / per_node(bc1, g)
    vh = new_nu / per_node(bc2, g)
    newp = p - lr * (mh / (sqrt_rn(vh) + eps) + weight_decay * p)
    return (keep_masked(active, newp, p), keep_masked(active, new_mu, mu),
            keep_masked(active, new_nu, nu))
