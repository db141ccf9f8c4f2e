"""Dispatch over the fused plane-update sweeps: the CUDA kernel for
tensors on the card, the plain version for tensors on the CPU.  There
is no fallback: a CUDA tensor the kernel does not take raises.

Every sweep updates the plane buffers in place, for all N nodes of a
``[N, R, C]`` plane in one launch.  ``active`` (``[N]`` bool on the
planes' device, or None) masks nodes out of the step: a masked node's
parameters and moments come back bit-unchanged (the kernels neither read
nor write its rows)."""
from __future__ import annotations

import torch

from repro_torch.kernels.opt_update.opt_update import (adafactor_apply_cuda,
                                                       adamw_update_cuda,
                                                       sgd_update_cuda)
from repro_torch.kernels.opt_update.ref import (adafactor_apply_ref,
                                                adamw_update_ref,
                                                keep_masked, sgd_update_ref)


def fused_sgd_update(g, p, mu, lr, scale, *, momentum: float,
                     weight_decay: float, active=None) -> None:
    """Fused clipped sgd+momentum over plane buffers ``[N, R, C]``;
    updates ``p`` and ``mu`` in place.  ``scale`` is the per-node
    global-norm clip factor ``[N]``, ``lr`` a scalar tensor."""
    if p.is_cuda:
        sgd_update_cuda(g, p, mu, lr, scale, momentum=momentum,
                        weight_decay=weight_decay, active=active)
        return
    newp, newmu = sgd_update_ref(g, p, mu, lr=lr, scale=scale,
                                 momentum=momentum,
                                 weight_decay=weight_decay, active=active)
    p.copy_(newp)
    mu.copy_(newmu)


def fused_adamw_update(g, p, mu, nu, lr, scale, bc1, bc2, *, b1: float,
                       b2: float, eps: float, weight_decay: float,
                       active=None) -> None:
    """Fused clipped adamw over plane buffers ``[N, R, C]``; updates
    ``p``, ``mu`` and ``nu`` in place.  ``scale`` is the per-node
    global-norm clip factor ``[N]``; ``bc1``/``bc2`` the per-node bias
    corrections ``[N]`` of each node's own step, ``lr`` a scalar
    tensor."""
    if p.is_cuda:
        adamw_update_cuda(g, p, mu, nu, lr, scale, bc1, bc2, b1=b1, b2=b2,
                          eps=eps, weight_decay=weight_decay, active=active)
        return
    newp, newmu, newnu = adamw_update_ref(
        g, p, mu, nu, lr=lr, scale=scale, bc1=bc1, bc2=bc2, b1=b1, b2=b2,
        eps=eps, weight_decay=weight_decay, active=active)
    p.copy_(newp)
    mu.copy_(newmu)
    nu.copy_(newnu)


def fused_adafactor_update(g, p, fac, lr, scale, beta, *, recipe,
                           eps: float = 1e-30, clip_threshold: float = 1.0,
                           weight_decay: float = 0.0, active=None) -> tuple:
    """Plane-backed adafactor over ``[N, R, C]`` buffers: updates ``p``
    in place and returns the new ``fac``.

    ``fac`` is a tuple of moment dicts aligned with the ``recipe``'s
    leaves (``PlaneMeta.recipe``), one per buffer *segment*, each with
    the leading node axis: ``{"vr", "vc"}`` where the leaf factors,
    dense ``{"v"}`` otherwise.  The moment EMAs, the row factor and the
    per-leaf RMS clip are shape-dependent, so they run per segment view
    for all nodes at once, with the clip ``scale`` ``[N]`` folded into
    the gradient (:func:`~repro_torch.optim.optimizers.adafactor_leaf_update`,
    the per-leaf optimizer's own expressions).  The clipped update is
    packed into a zero-padded ``[N, R, C]`` buffer, and the parameter
    step is ONE elementwise apply over every node's plane.  ``beta`` is
    the second-moment decay, one per node (``[N]``) or one for all; a
    node masked out by ``active`` keeps its ``fac`` moments
    (``torch.where``) and its parameters (the apply skips it)."""
    from repro_torch.optim.optimizers import adafactor_leaf_update
    from repro_torch.optim.plane import _leaf_view
    lead = tuple(p.shape[:-2])
    upd_buf = torch.zeros_like(p)
    new_fac = []
    for (_, _, shape, row, r_leaf), v in zip(recipe, fac):
        s = scale.reshape(lead + (1,) * len(shape))
        upd, nv = adafactor_leaf_update(
            _leaf_view(g, shape, row, r_leaf) * s, v, beta, lead=len(lead),
            eps=eps, clip_threshold=clip_threshold)
        _leaf_view(upd_buf, shape, row, r_leaf).copy_(upd)
        new_fac.append({k: keep_masked(active, x, v[k])
                        for k, x in nv.items()})
    if p.is_cuda:
        adafactor_apply_cuda(upd_buf, p, lr, weight_decay=weight_decay,
                             active=active)
    else:
        p.copy_(adafactor_apply_ref(upd_buf, p, lr=lr,
                                    weight_decay=weight_decay,
                                    active=active))
    return tuple(new_fac)
