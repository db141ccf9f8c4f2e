"""The KD loss over logits of any leading shape: the CUDA kernel for
tensors on the card, its plain version for tensors on the CPU.  No
padding: the kernel masks ragged V itself.  ``core/distillation.kd_loss``
(the loss the ProFe step differentiates) stays plain: the kernel has no
backward."""
from __future__ import annotations

import torch

from repro_torch.kernels.kd_loss.kd_loss import DTYPES, kd_loss_rows_cuda
from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref


def kd_loss(student_logits, teacher_logits, temperature: float = 1.0):
    """Mean over all rows of ``KL(p_t || p_s)·T²``; shapes ``[..., V]``.
    Logits of another type than fp32 or bf16, or of two types, go to the
    kernel as fp32."""
    v = student_logits.shape[-1]
    ys = student_logits.reshape(-1, v)
    yt = teacher_logits.reshape(-1, v)
    if ys.is_cuda:
        if ys.dtype != yt.dtype or ys.dtype not in DTYPES:
            ys, yt = ys.float(), yt.float()
        per_row = kd_loss_rows_cuda(ys.contiguous(), yt.contiguous(),
                                    temperature)
    else:
        per_row = kd_loss_rows_ref(ys, yt, temperature)
    return torch.mean(per_row)


def kd_loss_ref_mean(student_logits, teacher_logits,
                     temperature: float = 1.0):
    """The same mean through the plain per-row version, on any device."""
    v = student_logits.shape[-1]
    return torch.mean(kd_loss_rows_ref(student_logits.reshape(-1, v),
                                       teacher_logits.reshape(-1, v),
                                       temperature))
