"""Plain PyTorch versions of the row-scaled wire quantization kernels.

``codes = clip(floor(x / delta_row + 0.5), -qmax - 1, qmax)``: a true
division and ``floor(. + 0.5)`` — never ``torch.round``, which rounds
half to even.  ``row_delta`` (and ``row_qmax``, ``decay``) must be
tensors on ``x``'s device, so the division stays IEEE on the card too.

The error-feedback (``+ef``) versions quantize the effective payload
``eff = x + decay·res`` and return the fresh error
``new_res = eff - codes·delta`` — each a separately rounded fp32
operation in that order, as ``repro``'s eager jnp path computes them.

``mix_packed_ref`` is the receiver side of the mesh exchange,
``out[m] = w_self[m]·own[m] + Σ_j w_rows[m, j]·(codes[j]·Δ[j])``, with
the sum taken sender by sender in the Pallas kernel's order, each
product and sum rounded on its own.

The per-leaf and per-tensor tiers: ``quantize_dequantize_rows_ref``
(the row-scaled round trip, ``codes·Δ_row`` without the codes) and
``dequantize_rows_ref``; the whole-tensor scalar-Δ codec
``fused_quantize_ref`` / ``fused_quantize_dequantize_ref`` with
``Δ = max(max|x| / qmax, tiny)`` (``qmax`` an fp32 tensor on ``x``'s
device, so the division is IEEE on the card) and ``dequantize_ref``.

Codes become integers through :func:`as_codes`, which saturates as the
card's ``cvt.rzi.s32.f32`` and XLA's convert do: at 32 bits ``qmax``
rounds to 2^31 in fp32, which a plain cast wraps to -2^31.
"""
from __future__ import annotations

import torch


_TINY = float(torch.finfo(torch.float32).tiny)


def _qmaxf(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def as_codes(codes, dtype=torch.int32):
    """fp32 codes, already clipped to ``[-qmax - 1, qmax]``, as
    ``dtype``; int32 saturates at 2^31 - 1 (see the module's doc)."""
    if dtype != torch.int32:
        return codes.to(dtype)
    return codes.to(torch.int64).clamp_(max=(1 << 31) - 1).to(torch.int32)


def rowabs_ref(x2d):
    """``[R, C]`` -> per-row ``max|x|`` ``[R, 1]``."""
    return torch.amax(torch.abs(x2d.to(torch.float32)), dim=1, keepdim=True)


def quantize_rows_ref(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32, ``[R, 1]`` per-row delta -> int32 codes."""
    qmax = _qmaxf(bits)
    codes = torch.floor(x2d.to(torch.float32) / row_delta + 0.5)
    return as_codes(torch.clamp(codes, -qmax - 1, qmax))


def quantize_rows_mixed_ref(x2d, row_delta, row_qmax):
    """``[R, C]`` fp32, ``[R, 1]`` per-row delta and qmax -> int32
    codes, each row clipped to its own width."""
    codes = torch.floor(x2d.to(torch.float32) / row_delta + 0.5)
    return as_codes(torch.clamp(codes, -row_qmax - 1, row_qmax))


def _effective(x2d, res2d, decay):
    return x2d.to(torch.float32) + decay * res2d.to(torch.float32)


def rowabs_sum_ref(x2d, res2d, decay):
    """``[R, C]`` payload and residual, fp32 scalar tensor ``decay`` ->
    per-row ``max|x + decay·res|`` ``[R, 1]``."""
    return rowabs_ref(_effective(x2d, res2d, decay))


def quantize_rows_ef_ref(x2d, res2d, row_delta, row_qmax, decay):
    """The error-feedback sweep: ``(int32 codes, new residual fp32)``
    of the effective payload at per-row delta and qmax ``[R, 1]``."""
    eff = _effective(x2d, res2d, decay)
    codes = torch.clamp(torch.floor(eff / row_delta + 0.5),
                        -row_qmax - 1, row_qmax)
    return as_codes(codes), eff - codes * row_delta


def mix_packed_ref(own, codes, row_delta, w_self, w_rows):
    """``own [M, R, C]`` fp32, ``codes [S, R, C]`` (int32, or fp32 raw
    buffers), ``row_delta [S, R]``, ``w_self [M]``, ``w_rows [M, S]`` ->
    the mixed ``[M, R, C]`` fp32 buffer: ``acc = w_self·own``, then per
    sender ``acc = acc + w_rows[:, j]·(codes[j]·Δ[j])``."""
    acc = w_self.to(torch.float32)[:, None, None] * own.to(torch.float32)
    for j in range(codes.shape[0]):
        deq = codes[j].to(torch.float32) * \
            row_delta[j].to(torch.float32)[:, None]
        acc = acc + w_rows[:, j].to(torch.float32)[:, None, None] * \
            deq[None]
    return acc


def quantize_dequantize_rows_ref(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32, ``[R, 1]`` per-row delta -> the fp32 round trip
    ``codes·Δ_row`` (the codes are never returned)."""
    qmax = _qmaxf(bits)
    codes = torch.floor(x2d.to(torch.float32) / row_delta + 0.5)
    return torch.clamp(codes, -qmax - 1, qmax) * row_delta


def dequantize_rows_ref(codes2d, row_delta):
    """``[R, C]`` integer codes, ``[R, 1]`` per-row delta -> fp32."""
    return codes2d.to(torch.float32) * row_delta


def _fused_codes(x, qmax):
    x = x.to(torch.float32)
    delta = torch.clamp_min(torch.amax(torch.abs(x)) / qmax, _TINY)
    codes = torch.clamp(torch.floor(x / delta + 0.5), -qmax - 1, qmax)
    return codes, delta


def fused_quantize_ref(x, qmax):
    """Whole-tensor codec: ``x`` (any shape) and a 0-d fp32 ``qmax`` ->
    ``(int32 codes of x's shape, 0-d Δ)``."""
    codes, delta = _fused_codes(x, qmax)
    return as_codes(codes), delta


def fused_quantize_dequantize_ref(x, qmax):
    """Whole-tensor round trip -> ``(codes·Δ fp32, 0-d Δ)``."""
    codes, delta = _fused_codes(x, qmax)
    return codes * delta, delta


def dequantize_ref(codes, delta):
    """Integer codes (any shape) and a 0-d fp32 Δ -> fp32 ``codes·Δ``."""
    return codes.to(torch.float32) * delta
