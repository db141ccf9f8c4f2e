"""Hopper kernel: the fused temperature-KD loss per row.

Replaces ``repro/kernels/kd_loss/kd_loss.py:kd_loss_rows_pallas`` (the
CUDA source is ``csrc/kd_loss.cu``): ``[R, V] x [R, V]`` logits, fp32 or
bf16 -> per-row ``KL(softmax(y_t/T) || softmax(y_s/T))·T²`` ``[R]`` fp32,
in one pass with the Pallas body's online maxima and normalisers, so
neither probability tensor is made.  Bound on the H100: at an LM
vocabulary (256 × 202,048) by its bytes (207 MB in bf16, 0.062 ms).
Design: one block per row, each thread a strided range of the vocabulary
with its own online state, merged through warp shuffles and shared
memory with the same rescaling; ragged V is masked by the walk, never
padded.  Its plain version is
:func:`~repro_torch.kernels.kd_loss.ref.kd_loss_rows_ref` (the direct
softmax form; the finish subtracts terms of the size of ``max|y|/T``, so
the two agree to an absolute tolerance scaled by it).  No backward, as
in ``repro``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref  # noqa: F401  the plain version

KD_LOSS_LAUNCHES = LaunchCounter("kd_loss")

# the input types the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


def kd_loss_rows_cuda(student_logits, teacher_logits, temperature: float):
    """``[R, V]`` student and teacher logits on the card, both fp32 or
    both bf16 -> per-row KD loss ``[R]`` fp32 (already ``* T²``)."""
    if student_logits.dim() != 2:
        raise ValueError(f"kd_loss: logits must be [R, V], got "
                         f"{tuple(student_logits.shape)}")
    rows, v = student_logits.shape
    if v == 0:
        raise ValueError("kd_loss: empty vocabulary")
    if student_logits.dtype not in DTYPES:
        raise ValueError(f"kd_loss: expected float32 or bfloat16, got "
                         f"{student_logits.dtype}")
    require(student_logits, "kd_loss student_logits", student_logits.dtype)
    require(teacher_logits, "kd_loss teacher_logits", student_logits.dtype,
            (rows, v))
    # the TPU kernel's scalars: inv_t = 1/T, and the finish divides by
    # inv_t * inv_t taken in double; ctypes rounds both to fp32
    inv_t = 1.0 / temperature
    out = torch.empty((rows,), dtype=torch.float32,
                      device=student_logits.device)
    rc = library().kd_loss_rows(
        student_logits.data_ptr(), teacher_logits.data_ptr(),
        out.data_ptr(), rows, v, inv_t, inv_t * inv_t,
        int(student_logits.dtype == torch.bfloat16),
        stream_of(student_logits))
    check(rc, "kd_loss")
    KD_LOSS_LAUNCHES.count += 1
    return out
