"""Dispatch over the fused plane-update sweep: the CUDA kernel for
tensors on the card, the plain version for tensors on the CPU.  There
is no fallback: a CUDA tensor the kernel does not take raises."""
from __future__ import annotations

from repro_torch.kernels.opt_update.opt_update import adamw_update_cuda
from repro_torch.kernels.opt_update.ref import adamw_update_ref


def fused_adamw_update(g, p, mu, nu, lr, scale, bc1, bc2, *, b1: float,
                       b2: float, eps: float, weight_decay: float) -> None:
    """Fused clipped adamw over plane buffers ``[N, R, C]``; updates
    ``p``, ``mu`` and ``nu`` in place.  ``scale`` is the per-node
    global-norm clip factor ``[N]``; ``lr``/``bc1``/``bc2`` are scalar
    tensors of the current step."""
    if p.is_cuda:
        adamw_update_cuda(g, p, mu, nu, lr, scale, bc1, bc2, b1=b1, b2=b2,
                          eps=eps, weight_decay=weight_decay)
        return
    newp, newmu, newnu = adamw_update_ref(
        g, p, mu, nu, lr=lr, scale=scale, bc1=bc1, bc2=bc2, b1=b1, b2=b2,
        eps=eps, weight_decay=weight_decay)
    p.copy_(newp)
    mu.copy_(newmu)
    nu.copy_(newnu)
