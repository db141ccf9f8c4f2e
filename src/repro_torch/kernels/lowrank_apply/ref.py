"""Plain PyTorch version of the fused low-rank apply.

Per matrix leaf, after an adapter-wire exchange,

    out[i] = w[i] + Σ_j coeffs[i, j] · (B[j] @ A[j])         (naive)
    out[i] = w[i] + Σ_j coeffs[i, j] · (B[j] @ Ã[i, j])      (RegMean)

The order of every operation is fixed, as in the CUDA kernel
(``csrc/lowrank_apply.cu``), so that the two agree bit for bit on the
card: ``dot = Σ_t B[.., t]·A[t, ..]`` in ``t`` order from the ``t = 0``
product, ``term = c[i, j]·dot``, the delta accumulates the terms in
``j`` order from the ``j = 0`` term, then one add onto ``w``.  It is
spelled in elementwise ops (no ``matmul``), each rounded once in fp32
on the CPU and on the card alike.
"""
from __future__ import annotations

import torch


def lowrank_delta_ref(coeffs: torch.Tensor, b: torch.Tensor,
                      a: torch.Tensor) -> torch.Tensor:
    """The merged delta ``Σ_j coeffs[:, j]·(B_j @ A_j)`` alone:
    ``coeffs`` [N, S]; ``b`` [S, *lead, d, r]; ``a`` [S, *lead, r, k]
    (shared) or [N, S, *lead, r, k] (per receiver) -> [N, *lead, d, k]
    (None when S = 0)."""
    n = coeffs.shape[0]
    per_recv = a.dim() == b.dim() + 1
    delta = None
    for j in range(b.shape[0]):
        bj = b[j].float()                          # [*lead, d, r]
        aj = (a[:, j] if per_recv else a[j]).float()   # [(N,) *lead, r, k]
        dot = bj[..., :, 0, None] * aj[..., 0, None, :]
        for t in range(1, bj.shape[-1]):
            dot = dot + bj[..., :, t, None] * aj[..., t, None, :]
        c = coeffs[:, j].float().reshape((n,) + (1,) * (b.dim() - 1))
        term = c * dot                             # [N, *lead, d, k]
        delta = term if delta is None else delta + term
    return delta


def lowrank_apply_ref(w: torch.Tensor, coeffs: torch.Tensor,
                      b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``w`` [N, *lead, d, k] plus :func:`lowrank_delta_ref` of the
    factor bank -> merged [N, *lead, d, k]; ``w`` itself when S = 0."""
    w = w.float()
    delta = lowrank_delta_ref(coeffs, b, a)
    return w.clone() if delta is None else w + delta
