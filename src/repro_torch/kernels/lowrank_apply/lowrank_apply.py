"""Hopper kernel: the fused low-rank apply of the adapter-rank wire.

Replaces ``repro/kernels/lowrank_apply/lowrank_apply.py:lowrank_apply_pallas``
(the CUDA source is ``csrc/lowrank_apply.cu``).  One launch serves one
matrix leaf of every receiver: ``out[i] = w[i] + Σ_j c[i, j]·(B_j @ A_j)``,
``A`` shared ``[S, L, r, k]`` or per receiver ``[N, S, L, r, k]`` (the
RegMean factors), with a leaf's lead axes (a conv kernel's 3×3) folded
into ``L``.  Bound on the H100, at fc1's shapes (N = S = 20, d = 1568,
k = 128, r = 8), against about ``4·(2·N·L·d·k)`` bytes: with ``A`` shared
each ``B_j @ A_j`` is the same for every receiver, so the function needs
only ``S·L·d·k·2r + N·L·d·k·(2S + 1)`` fp32 flops and is bound by its
bytes; per receiver every ``B_j @ Ã_ij`` is its own, ``N·L·d·k·S·(2r+2)``
flops, and the flops take twice the bytes' time.  This kernel computes
each sender's product once per receiver in both variants.
Design: one block per (receiver, lead slice, 64×32 output tile); each
sender's ``B`` tile ``[64, r]`` (transposed) and ``A`` tile ``[r, 32]``
are staged in shared memory (the rank axis is never split) and each
thread keeps eight outputs of one column in registers across the
senders, reading its eight ``B`` values per rank step as two 16-byte
loads, so the dense per-sender ``[d, k]`` product never reaches device
memory.  ``w`` may
be a strided view of the plane (its nodes any distance apart) and
``out`` may be ``w`` itself: the merge writes the plane in place.  Its
plain version is :func:`~repro_torch.kernels.lowrank_apply.ref.lowrank_apply_ref`
(bit-exact: the same fp32 operations in the same order).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref  # noqa: F401  the plain version

LOWRANK_APPLY_LAUNCHES = LaunchCounter("lowrank_apply")

# the B tile [r][64] and the A tile [r][32] must fit 48 KB of shared memory
MAX_RANK = 48 * 1024 // ((64 + 32) * 4)


def _node_stride(t, name: str) -> int:
    """The stride between nodes of ``[N, *lead, d, k]`` fp32 on the
    card whose every node slice is contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected {torch.float32}, got {t.dtype}")
    if t.dim() < 3:
        raise ValueError(f"{name}: expected [N, *lead, d, k], got "
                         f"{tuple(t.shape)}")
    inner = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != inner:
            raise ValueError(f"{name}: each node's slice must be "
                             f"contiguous, got strides {t.stride()}")
        inner *= size
    return t.stride(0)


def lowrank_apply_cuda(w, coeffs, b, a, *, out=None):
    """``w`` [N, *lead, d, k], ``coeffs`` [N, S], ``b`` [S, *lead, d, r]
    and ``a`` [S, *lead, r, k] or [N, S, *lead, r, k], fp32 on the card
    -> ``out`` [N, *lead, d, k] (a new tensor, or the ``out`` given,
    which may be ``w``)."""
    n, lead_shape, (d, k) = w.shape[0], tuple(w.shape[1:-2]), w.shape[-2:]
    s, r = b.shape[0], b.shape[-1]
    lead = math.prod(lead_shape)
    per_recv = a.dim() == b.dim() + 1
    w_stride = _node_stride(w, "lowrank_apply w")
    if out is None:
        out = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    elif tuple(out.shape) != tuple(w.shape):
        raise ValueError(f"lowrank_apply: out {tuple(out.shape)} is not "
                         f"shaped like w {tuple(w.shape)}")
    out_stride = _node_stride(out, "lowrank_apply out")
    require(coeffs, "lowrank_apply coeffs", torch.float32, (n, s))
    require(b, "lowrank_apply b", torch.float32, (s,) + lead_shape + (d, r))
    require(a, "lowrank_apply a", torch.float32,
            ((n,) if per_recv else ()) + (s,) + lead_shape + (r, k))
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"lowrank_apply: rank must be in [1, {MAX_RANK}], "
                         f"got {r}")
    if n > 65535 or lead > 65535:
        raise ValueError(f"lowrank_apply: {n} nodes x {lead} lead slices "
                         f"exceed the grid")
    rc = library().lowrank_apply(w.data_ptr(), out.data_ptr(),
                                 coeffs.data_ptr(), b.data_ptr(),
                                 a.data_ptr(), n, s, lead, d, k, r,
                                 int(per_recv), w_stride, out_stride,
                                 stream_of(w))
    check(rc, "lowrank_apply")
    LOWRANK_APPLY_LAUNCHES.count += 1
    return out
