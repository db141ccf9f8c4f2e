"""Hopper kernels of the packed wire codec.

``rowabs_cuda`` replaces ``repro/kernels/quantize/quantize.py:rowabs_pallas``,
``quantize_rows_cuda`` replaces ``quantize_rows_pallas`` (its
``_rows_call``), ``quantize_rows_mixed_cuda`` replaces
``quantize_rows_mixed_pallas``, and the error-feedback pair
``rowabs_sum_cuda`` / ``quantize_rows_ef_cuda`` replaces
``rowabs_sum_pallas`` / ``quantize_rows_ef_pallas``, and
``mix_packed_cuda`` replaces ``mix_packed_pallas`` (the receiver side of
the mesh exchange); the per-leaf and per-tensor codec:
``quantize_dequantize_rows_cuda`` replaces
``quantize_dequantize_rows_pallas``, ``dequantize_rows_cuda``
``dequantize_rows_pallas``, ``fused_quantize_cuda`` /
``fused_quantize_dequantize_cuda`` ``fused_quantize_pallas`` /
``fused_quantize_dequantize_pallas`` and ``dequantize_cuda``
``dequantize_pallas``.  The CUDA source is ``csrc/quantize.cu``.  Bound on
the H100: bytes — rowabs reads 4 B per
element, quantize_rows reads 4 B and writes a 4 B int32 code per element
(the mixed variant adds a 4 B qmax per row), rowabs_sum reads 8 B per
element, quantize_rows_ef reads 8 B and writes 8 B per element,
mix_packed reads 4 B of its own buffer and 4 B of code per sender for
each output and writes 4 B; the per-leaf and per-tensor sweeps read 4 B
and write 4 B per element.  Design: one warp per 512-wide row with a
shuffle max for the row reductions; a grid-stride elementwise sweep with
an IEEE division for the codes (and the new residual, or the round trip);
for the mix, a grid-stride sweep whose thread walks the senders in order
with its accumulator in a register; for the whole-tensor codec, a block
max folded into one device word by ``atomicMax`` on its bits, then the
sweep (two launches, one call).  All are bit-identical to the plain
versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.quantize.ref import (_qmaxf,  # noqa: F401  plain versions
                                              mix_packed_ref,
                                              quantize_rows_ef_ref,
                                              quantize_rows_mixed_ref,
                                              quantize_rows_ref,
                                              rowabs_ref, rowabs_sum_ref)

ROWABS_LAUNCHES = LaunchCounter("rowabs")
QUANTIZE_ROWS_LAUNCHES = LaunchCounter("quantize_rows")
QUANTIZE_ROWS_MIXED_LAUNCHES = LaunchCounter("quantize_rows_mixed")
ROWABS_SUM_LAUNCHES = LaunchCounter("rowabs_sum")
QUANTIZE_ROWS_EF_LAUNCHES = LaunchCounter("quantize_rows_ef")
MIX_PACKED_LAUNCHES = LaunchCounter("mix_packed")
QUANTIZE_DEQUANTIZE_ROWS_LAUNCHES = LaunchCounter("quantize_dequantize_rows")
DEQUANTIZE_ROWS_LAUNCHES = LaunchCounter("dequantize_rows")
FUSED_QUANTIZE_LAUNCHES = LaunchCounter("fused_quantize")
FUSED_QUANTIZE_DEQUANTIZE_LAUNCHES = LaunchCounter(
    "fused_quantize_dequantize")
DEQUANTIZE_LAUNCHES = LaunchCounter("dequantize")


def _rows(x2d, name: str):
    if x2d.dim() != 2:
        raise ValueError(f"{name}: expected [R, C], got {tuple(x2d.shape)}")
    require(x2d, f"{name} x", torch.float32)
    return x2d.shape


def rowabs_cuda(x2d):
    """``[R, C]`` fp32 on the card -> per-row ``max|x|`` ``[R, 1]``."""
    r, c = _rows(x2d, "rowabs")
    out = torch.empty((r, 1), dtype=torch.float32, device=x2d.device)
    rc = library().rowabs(x2d.data_ptr(), out.data_ptr(), r, c,
                          stream_of(x2d))
    check(rc, "rowabs")
    ROWABS_LAUNCHES.count += 1
    return out


def quantize_rows_cuda(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32 and ``[R, 1]`` deltas on the card -> int32 codes."""
    r, c = _rows(x2d, "quantize_rows")
    require(row_delta, "quantize_rows row_delta", torch.float32, (r, 1))
    codes = torch.empty((r, c), dtype=torch.int32, device=x2d.device)
    rc = library().quantize_rows(x2d.data_ptr(), row_delta.data_ptr(),
                                 codes.data_ptr(), r, c, _qmaxf(bits),
                                 stream_of(x2d))
    check(rc, "quantize_rows")
    QUANTIZE_ROWS_LAUNCHES.count += 1
    return codes


def quantize_rows_mixed_cuda(x2d, row_delta, row_qmax):
    """``[R, C]`` fp32 and ``[R, 1]`` deltas and qmax on the card ->
    int32 codes, each row clipped to its own width."""
    r, c = _rows(x2d, "quantize_rows_mixed")
    require(row_delta, "quantize_rows_mixed row_delta", torch.float32,
            (r, 1))
    require(row_qmax, "quantize_rows_mixed row_qmax", torch.float32, (r, 1))
    codes = torch.empty((r, c), dtype=torch.int32, device=x2d.device)
    rc = library().quantize_rows_mixed(x2d.data_ptr(), row_delta.data_ptr(),
                                       row_qmax.data_ptr(), codes.data_ptr(),
                                       r, c, stream_of(x2d))
    check(rc, "quantize_rows_mixed")
    QUANTIZE_ROWS_MIXED_LAUNCHES.count += 1
    return codes


def quantize_dequantize_rows_cuda(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32 and ``[R, 1]`` deltas on the card -> the fp32
    round trip ``codes·Δ_row``, the codes never stored."""
    r, c = _rows(x2d, "quantize_dequantize_rows")
    require(row_delta, "quantize_dequantize_rows row_delta", torch.float32,
            (r, 1))
    out = torch.empty((r, c), dtype=torch.float32, device=x2d.device)
    rc = library().quantize_dequantize_rows(
        x2d.data_ptr(), row_delta.data_ptr(), out.data_ptr(), r, c,
        _qmaxf(bits), stream_of(x2d))
    check(rc, "quantize_dequantize_rows")
    QUANTIZE_DEQUANTIZE_ROWS_LAUNCHES.count += 1
    return out


def dequantize_rows_cuda(codes2d, row_delta):
    """``[R, C]`` int32 codes and ``[R, 1]`` deltas on the card -> fp32
    ``codes·Δ_row``."""
    if codes2d.dim() != 2:
        raise ValueError(f"dequantize_rows: expected [R, C], got "
                         f"{tuple(codes2d.shape)}")
    r, c = codes2d.shape
    require(codes2d, "dequantize_rows codes", torch.int32)
    require(row_delta, "dequantize_rows row_delta", torch.float32, (r, 1))
    out = torch.empty((r, c), dtype=torch.float32, device=codes2d.device)
    rc = library().dequantize_rows(codes2d.data_ptr(), row_delta.data_ptr(),
                                   out.data_ptr(), r, c, stream_of(codes2d))
    check(rc, "dequantize_rows")
    DEQUANTIZE_ROWS_LAUNCHES.count += 1
    return out


def _fused_call(x, bits: int, dequant: bool):
    name = "fused_quantize_dequantize" if dequant else "fused_quantize"
    require(x, f"{name} x", torch.float32)
    if x.numel() == 0:
        raise ValueError(f"{name}: an empty tensor has no absmax")
    out = torch.empty(x.shape, device=x.device,
                      dtype=torch.float32 if dequant else torch.int32)
    delta = torch.empty((), dtype=torch.float32, device=x.device)
    scratch = torch.empty((1,), dtype=torch.int32, device=x.device)
    rc = getattr(library(), name)(x.data_ptr(), out.data_ptr(),
                                  delta.data_ptr(), scratch.data_ptr(),
                                  x.numel(), _qmaxf(bits), stream_of(x))
    check(rc, name)
    return out, delta


def fused_quantize_cuda(x, *, bits: int = 16):
    """fp32 ``x`` (any shape) on the card -> ``(int32 codes of x's shape,
    0-d Δ)``: the absmax and the codes in one call (two launches)."""
    out = _fused_call(x, bits, dequant=False)
    FUSED_QUANTIZE_LAUNCHES.count += 1
    return out


def fused_quantize_dequantize_cuda(x, *, bits: int = 16):
    """fp32 ``x`` (any shape) on the card -> ``(codes·Δ fp32, 0-d Δ)``,
    the codes never stored."""
    out = _fused_call(x, bits, dequant=True)
    FUSED_QUANTIZE_DEQUANTIZE_LAUNCHES.count += 1
    return out


def dequantize_cuda(codes, delta):
    """int32 codes (any shape) and a 0-d fp32 Δ on the card -> fp32
    ``codes·Δ``; Δ is read on the card (no host sync)."""
    require(codes, "dequantize codes", torch.int32)
    require(delta, "dequantize delta", torch.float32, ())
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    rc = library().dequantize(codes.data_ptr(), delta.data_ptr(),
                              out.data_ptr(), codes.numel(),
                              stream_of(codes))
    check(rc, "dequantize")
    DEQUANTIZE_LAUNCHES.count += 1
    return out


def rowabs_sum_cuda(x2d, res2d, decay: float):
    """``[R, C]`` fp32 payload and residual on the card -> per-row
    ``max|x + decay·res|`` ``[R, 1]`` (``decay`` rounds to fp32)."""
    r, c = _rows(x2d, "rowabs_sum")
    require(res2d, "rowabs_sum res", torch.float32, (r, c))
    out = torch.empty((r, 1), dtype=torch.float32, device=x2d.device)
    rc = library().rowabs_sum(x2d.data_ptr(), res2d.data_ptr(),
                              out.data_ptr(), r, c, float(decay),
                              stream_of(x2d))
    check(rc, "rowabs_sum")
    ROWABS_SUM_LAUNCHES.count += 1
    return out


def quantize_rows_ef_cuda(x2d, res2d, row_delta, row_qmax, decay: float):
    """``[R, C]`` fp32 payload and residual, ``[R, 1]`` deltas and qmax
    on the card -> ``(int32 codes, new residual fp32)`` in one launch
    (``decay`` rounds to fp32)."""
    r, c = _rows(x2d, "quantize_rows_ef")
    require(res2d, "quantize_rows_ef res", torch.float32, (r, c))
    require(row_delta, "quantize_rows_ef row_delta", torch.float32, (r, 1))
    require(row_qmax, "quantize_rows_ef row_qmax", torch.float32, (r, 1))
    codes = torch.empty((r, c), dtype=torch.int32, device=x2d.device)
    new_res = torch.empty((r, c), dtype=torch.float32, device=x2d.device)
    rc = library().quantize_rows_ef(x2d.data_ptr(), res2d.data_ptr(),
                                    row_delta.data_ptr(), row_qmax.data_ptr(),
                                    codes.data_ptr(), new_res.data_ptr(), r,
                                    c, float(decay), stream_of(x2d))
    check(rc, "quantize_rows_ef")
    QUANTIZE_ROWS_EF_LAUNCHES.count += 1
    return codes, new_res


def mix_packed_cuda(own, codes, row_delta, w_self, w_rows):
    """``own [M, R, C]`` fp32, ``codes [S, R, C]`` int32 or fp32,
    ``row_delta [S, R]``, ``w_self [M]`` and ``w_rows [M, S]`` fp32 on
    the card -> the mixed ``[M, R, C]`` fp32 buffer."""
    if own.dim() != 3 or codes.dim() != 3:
        raise ValueError(f"mix_packed: expected own [M, R, C] and codes "
                         f"[S, R, C], got {tuple(own.shape)} and "
                         f"{tuple(codes.shape)}")
    m, r, c = own.shape
    s = codes.shape[0]
    if codes.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"mix_packed codes: expected int32 or float32, got "
                         f"{codes.dtype}")
    require(own, "mix_packed own", torch.float32)
    require(codes, "mix_packed codes", codes.dtype, (s, r, c))
    require(row_delta, "mix_packed row_delta", torch.float32, (s, r))
    require(w_self, "mix_packed w_self", torch.float32, (m,))
    require(w_rows, "mix_packed w_rows", torch.float32, (m, s))
    out = torch.empty((m, r, c), dtype=torch.float32, device=own.device)
    rc = library().mix_packed(own.data_ptr(), codes.data_ptr(),
                              row_delta.data_ptr(), w_self.data_ptr(),
                              w_rows.data_ptr(), out.data_ptr(), m, s, r, c,
                              int(codes.dtype == torch.float32),
                              stream_of(own))
    check(rc, "mix_packed")
    MIX_PACKED_LAUNCHES.count += 1
    return out
