"""Hopper kernels of the packed wire codec's uniform-width path.

``rowabs_cuda`` replaces ``repro/kernels/quantize/quantize.py:rowabs_pallas``
and ``quantize_rows_cuda`` replaces ``quantize_rows_pallas`` (its
``_rows_call``); the CUDA source is ``csrc/quantize.cu``.  Bound on the
H100: bytes — rowabs reads 4 B per element, quantize_rows reads 4 B and
writes a 4 B int32 code per element.  Design: one warp per 512-wide row
with a shuffle max for rowabs; a grid-stride elementwise sweep with an
IEEE division for the codes, bit-identical to the plain versions in
``ref.py`` (:func:`~repro_torch.kernels.quantize.ref.rowabs_ref`,
:func:`~repro_torch.kernels.quantize.ref.quantize_rows_ref`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.quantize.ref import (_qmaxf,  # noqa: F401  plain versions
                                              quantize_rows_ref, rowabs_ref)

ROWABS_LAUNCHES = LaunchCounter("rowabs")
QUANTIZE_ROWS_LAUNCHES = LaunchCounter("quantize_rows")


def rowabs_cuda(x2d):
    """``[R, C]`` fp32 on the card -> per-row ``max|x|`` ``[R, 1]``."""
    if x2d.dim() != 2:
        raise ValueError(f"rowabs: expected [R, C], got {tuple(x2d.shape)}")
    require(x2d, "rowabs x", torch.float32)
    r, c = x2d.shape
    out = torch.empty((r, 1), dtype=torch.float32, device=x2d.device)
    rc = library().rowabs(x2d.data_ptr(), out.data_ptr(), r, c,
                          stream_of(x2d))
    check(rc, "rowabs")
    ROWABS_LAUNCHES.count += 1
    return out


def quantize_rows_cuda(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32 and ``[R, 1]`` deltas on the card -> int32 codes."""
    if x2d.dim() != 2:
        raise ValueError(f"quantize_rows: expected [R, C], got "
                         f"{tuple(x2d.shape)}")
    require(x2d, "quantize_rows x", torch.float32)
    r, c = x2d.shape
    require(row_delta, "quantize_rows row_delta", torch.float32, (r, 1))
    codes = torch.empty((r, c), dtype=torch.int32, device=x2d.device)
    rc = library().quantize_rows(x2d.data_ptr(), row_delta.data_ptr(),
                                 codes.data_ptr(), r, c, _qmaxf(bits),
                                 stream_of(x2d))
    check(rc, "quantize_rows")
    QUANTIZE_ROWS_LAUNCHES.count += 1
    return codes
