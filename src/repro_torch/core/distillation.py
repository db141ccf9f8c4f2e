"""Knowledge distillation losses (paper Sec. III-A).

    p_s = log_softmax(y_s / T),  p_t = softmax(y_t / T)
    L_KD = KL(p_t || p_s) * T^2

plus the professor-importance decay of Sec. III-A.1: the distillation
weight halves every round and snaps to zero below ``alpha_limit``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import shard_act


def kd_loss(student_logits, teacher_logits, temperature: float = 1.0,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(p_t || p_s) * T^2, mean over all leading dims."""
    ys = student_logits.float() / temperature
    yt = teacher_logits.float() / temperature
    log_ps = torch.log_softmax(ys, dim=-1)
    log_pt = torch.log_softmax(yt, dim=-1)
    pt = torch.exp(log_pt)
    kl = torch.sum(pt * (log_pt - log_ps), dim=-1)
    if mask is not None:
        kl = kl * mask
        denom = torch.clamp_min(torch.sum(mask), 1.0)
        return torch.sum(kl) / denom * temperature ** 2
    return torch.mean(kl) * temperature ** 2


def ce_loss(logits, labels, mask: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Cross-entropy with integer labels (Eq. 1), mean-reduced, through
    the same logsumexp minus one-hot contraction as ``repro``."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[..., None] == classes).float()
    if onehot.ndim == 3:
        onehot = shard_act(onehot, "btv")   # vocab-sharded like the logits
    nll = lse - torch.sum(logits32 * onehot, dim=-1)
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def repr_mse_loss(f_student, f_teacher) -> torch.Tensor:
    """L_MSE between intermediate representations (Sec. III-C)."""
    d = f_student.float() - f_teacher.float()
    return torch.mean(torch.square(d))


def alpha_at_round(alpha0: float, alpha_limit: float, round_idx
                   ) -> torch.Tensor:
    """Professor importance decay on a device round counter (any shape)."""
    a = alpha0 * torch.pow(0.5, round_idx.float())
    return torch.where(a < alpha_limit, torch.zeros_like(a), a)


def teacher_active(alpha0: float, alpha_limit: float, round_idx: int) -> bool:
    """Host-side check (for skipping teacher compute entirely)."""
    return float(alpha0 * (0.5 ** round_idx)) >= alpha_limit
