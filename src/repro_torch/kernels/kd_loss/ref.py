"""Plain PyTorch version of the fused temperature-KD kernel (paper Sec.
III-A formulas), the direct form that materializes both softmaxes."""
from __future__ import annotations

import torch


def kd_loss_rows_ref(student_logits, teacher_logits,
                     temperature: float) -> torch.Tensor:
    """Per-row ``KL(p_t || p_s) * T^2`` of ``[R, V]`` logits -> ``[R]``
    fp32."""
    ys = student_logits.float() / temperature
    yt = teacher_logits.float() / temperature
    log_ps = torch.log_softmax(ys, dim=-1)
    log_pt = torch.log_softmax(yt, dim=-1)
    pt = torch.exp(log_pt)
    return torch.sum(pt * (log_pt - log_ps), dim=-1) * temperature ** 2
