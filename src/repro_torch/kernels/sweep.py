"""The split of a flat elementwise sweep over two buffers (one read, one
written, or both read) into 16-byte vectors, shared by the kernels that
sweep a flat buffer this way: ``adafactor_apply``
(:func:`~repro_torch.kernels.opt_update.opt_update.adafactor_plan`) and
the scalar-Δ ``dequantize``
(:func:`~repro_torch.kernels.quantize.quantize.dequantize_cuda`).

The kernels run ``grid`` blocks of ``threads`` threads: thread ``gid``
does head element ``gid`` and tail element ``gid`` where those exist,
then the vectors ``v0 + k·threads`` (``k < unroll``) of its block's
tile, ``v0 = block·threads·unroll + thread``, all their loads issued
before any result is computed.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SweepPlan:
    """One launch over ``n`` elements: ``head`` scalar elements, then
    ``body`` vectors of ``vec`` elements (16-byte ``float4`` / ``int4``
    when ``vec`` is 4), then ``tail`` scalar elements, in ``grid``
    blocks."""
    vec: int
    head: int
    body: int
    tail: int
    grid: int


def sweep_plan(n: int, align_a: int, align_b: int, *, threads: int,
               unroll: int, name: str) -> SweepPlan:
    """The split of ``[0, n)`` for two buffers whose first elements lie
    ``align_a`` and ``align_b`` 4-byte elements past a 16-byte boundary:
    where the two agree, a scalar head up to the first 16-byte address,
    4-element vectors, and a scalar tail of at most 3 elements; where
    they differ there is no common aligned body, and every element is a
    vector of one.  The grid holds the body's vectors, ``threads·unroll``
    a block, with no block empty (one block when there is no body)."""
    if n < 1:
        raise ValueError(f"{name}: n must be positive, got {n}")
    if align_a not in range(4) or align_b not in range(4):
        raise ValueError(f"{name}: offsets {align_a}, {align_b}")
    if align_a == align_b:
        head = min(n, -align_b % 4)
        body = (n - head) // 4
        vec, tail = 4, n - head - 4 * body
    else:
        vec, head, body, tail = 1, 0, n, 0
    grid = max(1, -(-body // (threads * unroll)))
    return SweepPlan(vec, head, body, tail, grid)
