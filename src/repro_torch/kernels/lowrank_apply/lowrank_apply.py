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
flops, and the flops take twice the bytes' time.

Design (:func:`lowrank_plan` picks it): with ``A`` shared, the *bank*
design computes each sender's product once per 32×16 output tile into a
shared-memory bank ``D[S][tile]`` and then sweeps every receiver out of
it; per receiver (or when the bank cannot hold S senders, the rows are
not 16-byte aligned, or its blocks would not fill the card) the *groups*
design gives a block a 64×32 tile of four receivers and reads each
sender's ``B`` tile once for all four.  Both stream the senders' tiles
through a ring of ``cp.async`` buffers, 2 to ``MAX_STAGES`` deep: the
deepest that fits beside the rest of the block's shared memory at this
rank.
``w`` may be a strided view of the plane (its nodes any distance apart)
and ``out`` may be ``w`` itself: the merge writes the plane in place.
Its plain version is
:func:`~repro_torch.kernels.lowrank_apply.ref.lowrank_apply_ref`
(bit-exact: the same fp32 operations in the same order).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref  # noqa: F401  the plain version

LOWRANK_APPLY_LAUNCHES = LaunchCounter("lowrank_apply")

SMEM_MAX = 232_448          # shared memory a block may opt in to (sm_90)
SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_STAGES = 4              # cp.async ring depth, in senders, at most
PAD = 4                     # a staged B^T row holds tile rows + PAD floats
BANK_TILE = (32, 16)        # bank: rows, cols (four columns a thread)
GROUP_TILE = (64, 32)       # groups: rows, cols (eight rows a thread)
GROUP = 4                   # groups: receivers a block
DESIGNS = {"bank": 0, "groups": 1}


def max_rank(per_recv: bool) -> int:
    """The largest rank the kernels take: the groups design's ring of two
    stages (a ``B`` tile and one ``A`` tile, or ``GROUP`` per receiver)
    within a block's shared memory.  The bank design gives way to it
    where its own does not fit."""
    n_a = GROUP if per_recv else 1
    return SMEM_MAX // (4 * 2 * (GROUP_TILE[0] + PAD + n_a * GROUP_TILE[1]))


MAX_RANK = max_rank(True)   # the rank both variants take


@dataclass(frozen=True)
class LowrankPlan:
    """One launch: the design, its output tile, receivers a block
    (``group``, all N for the bank), threads a block, senders in the
    ``cp.async`` ring (``stages``), the grid ``(tiles, lead, receiver
    groups)`` and its dynamic shared memory in bytes."""
    design: str
    tile_d: int
    tile_k: int
    group: int
    threads: int
    stages: int
    grid: Tuple[int, int, int]
    smem: int


def _tiles(d: int, k: int, tile_d: int, tile_k: int) -> int:
    return -(-d // tile_d) * -(-k // tile_k)


def _stages(fixed: int, per_stage: int) -> int:
    """The deepest ring, 2 to ``MAX_STAGES`` senders of ``per_stage``
    bytes, that fits beside ``fixed`` bytes; 0 if none does."""
    for stages in range(MAX_STAGES, 1, -1):
        if fixed + stages * per_stage <= SMEM_MAX:
            return stages
    return 0


def lowrank_plan(n: int, s: int, lead: int, d: int, k: int, r: int,
                 per_recv: bool, *, aligned: bool = True) -> LowrankPlan:
    """The launch of ``lowrank_apply`` for N receivers, S senders,
    ``lead`` folded lead slices, a ``[d, k]`` leaf and rank r: the bank
    design when ``A`` is shared, the rows are 16-byte aligned (``k`` a
    multiple of 4 and ``aligned``: ``w`` and ``out`` start and step
    between nodes on 16 bytes), its bank and a ring of two stages fit and
    its blocks fill the card (``SMS`` or more), else the groups design
    (``A``'s receiver stride 0 when shared).  Raises for a rank the
    kernels do not take."""
    top = max_rank(per_recv)
    if not 0 < r <= top:
        raise ValueError(f"lowrank_apply: rank must be in [1, {top}], "
                         f"got {r}")
    if not per_recv and aligned and k % 4 == 0:
        td, tk = BANK_TILE
        tiles, bank, ring = _tiles(d, k, td, tk), 4 * s * td * tk, \
            4 * r * (td + PAD + tk)
        stages = _stages(bank, ring)
        if stages and lead * tiles >= SMS:
            return LowrankPlan("bank", td, tk, n, td * tk // 4, stages,
                               (tiles, lead, 1), bank + stages * ring)
    td, tk = GROUP_TILE
    ring = 4 * r * (td + PAD + (GROUP if per_recv else 1) * tk)
    stages = _stages(0, ring)
    return LowrankPlan("groups", td, tk, GROUP, td * tk // 8, stages,
                       (_tiles(d, k, td, tk), lead, -(-n // GROUP)),
                       stages * ring)


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
    aligned = all(t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0
                  for t in (w, out) if t is not None)
    plan = lowrank_plan(n, s, lead, d, k, r, per_recv, aligned=aligned)
    if n > 65535 or lead > 65535:
        raise ValueError(f"lowrank_apply: {n} nodes x {lead} lead slices "
                         f"exceed the grid")
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
    a_recv_stride = s * lead * r * k if per_recv else 0
    rc = library().lowrank_apply(
        w.data_ptr(), out.data_ptr(), coeffs.data_ptr(), b.data_ptr(),
        a.data_ptr(), n, s, lead, d, k, r, a_recv_stride, w_stride,
        out_stride, DESIGNS[plan.design], plan.tile_d, plan.tile_k,
        plan.group, plan.stages, plan.smem, stream_of(w))
    check(rc, "lowrank_apply")
    LOWRANK_APPLY_LAUNCHES.count += 1
    return out
