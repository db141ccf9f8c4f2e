"""Plain PyTorch versions of the row-scaled wire quantization kernels.

``codes = clip(floor(x / delta_row + 0.5), -qmax - 1, qmax)``: a true
division and ``floor(. + 0.5)`` — never ``torch.round``, which rounds
half to even.  ``row_delta`` must be a tensor on ``x``'s device, so the
division stays IEEE on the card too.
"""
from __future__ import annotations

import torch


def _qmaxf(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def rowabs_ref(x2d):
    """``[R, C]`` -> per-row ``max|x|`` ``[R, 1]``."""
    return torch.amax(torch.abs(x2d.to(torch.float32)), dim=1, keepdim=True)


def quantize_rows_ref(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32, ``[R, 1]`` per-row delta -> int32 codes."""
    qmax = _qmaxf(bits)
    codes = torch.floor(x2d.to(torch.float32) / row_delta + 0.5)
    return torch.clamp(codes, -qmax - 1, qmax).to(torch.int32)
