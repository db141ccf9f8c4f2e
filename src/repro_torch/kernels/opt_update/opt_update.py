"""Hopper kernels: the fused optimizer sweeps over the flat parameter
plane (the CUDA source is ``csrc/opt_update.cu``).

* ``adamw_update_cuda`` replaces
  ``repro/kernels/opt_update/opt_update.py:adamw_update_pallas``; bytes
  bound it — 7 x 4 B per element (read g, p, mu, nu; write p, mu, nu).
* ``sgd_update_cuda`` replaces ``sgd_update_pallas``; 5 x 4 B per
  element (read g, p, mu; write p, mu).
* ``adafactor_apply_cuda`` replaces ``adafactor_apply_pallas``; 3 x 4 B
  per element (read upd, p; write p).

Design: one elementwise sweep over every node's plane at once, runtime
scalars, the per-node clip scale and (adamw) the per-node bias
corrections in device memory; an optional per-node mask (``active``, one
byte a node) skips a node whole, so a padded step of a node with fewer
local batches leaves its rows bit-unchanged.  For adamw a vectorized
per-node sweep: a node a grid row (its scalars read once a thread, a
masked node's blocks return before any load), 16-byte vectors of its
plane (one a thread, as timed fastest) with every load of g, p, mu and
nu issued before any arithmetic, and a grid sized to the work
(:func:`adamw_plan`; a node plane that is not whole vectors, or an
unaligned buffer, takes one element a vector); for sgd a node a grid
row and a grid-stride loop over its plane; for the adafactor apply,
16-byte vectors from the first 16-byte address on, several a thread with
all their loads issued first, a scalar head and tail, and a grid sized
to the work (:func:`adafactor_plan`).  Explicit round-to-nearest operations and
``-fmad=false`` make each bit-identical to its plain version in
:mod:`~repro_torch.kernels.opt_update.ref`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.opt_update.ref import (  # noqa: F401  the plain versions
    adafactor_apply_ref, adamw_update_ref, sgd_update_ref)
from repro_torch.kernels.sweep import SweepPlan, sweep_plan

ADAMW_LAUNCHES = LaunchCounter("adamw_update")
SGD_LAUNCHES = LaunchCounter("sgd_update")
ADAFACTOR_LAUNCHES = LaunchCounter("adafactor_apply")


def _require_scalar(t, name: str) -> None:
    require(t, name, torch.float32)
    if t.numel() != 1:
        raise ValueError(f"{name}: expected one element")


def _node_scale(p, scale, name: str):
    """Elements per ``R x C`` plane, checking one clip scale per plane."""
    node_elems = p.shape[-2] * p.shape[-1]
    require(scale, f"{name} scale", torch.float32,
            (p.numel() // node_elems,))
    return node_elems


def _active_ptr(active, planes: int, name: str):
    """The per-node mask's address (None: no mask): one bool / uint8 a
    plane, contiguous on the card."""
    if active is None:
        return None
    if active.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"{name} active: expected bool or uint8, got "
                         f"{active.dtype}")
    require(active, f"{name} active", active.dtype, (planes,))
    return active.data_ptr()


# -- adamw's launch plan ------------------------------------------------------
ADAMW_MAX_GRID_Y = 65535    # nodes a launch (the grid's y axis)
# One vector a thread, 256 threads a block (the kernel's own): on the H100
# that timed faster than 2 or 4 vectors a thread at every path's plane, at
# the speed of a same-byte copy_, and 128 threads no faster on the
# smallest planes
ADAMW_THREADS = 256


@dataclass(frozen=True)
class AdamwPlan:
    """One launch of ``adamw_update`` over ``planes`` nodes' planes of
    ``node_elems`` elements: ``vec`` elements a vector (one 16-byte
    ``float4`` when 4), one vector a thread, :data:`ADAMW_THREADS` a
    block, ``grid`` ``(blocks a node, planes)``."""
    vec: int
    grid: Tuple[int, int]


def adamw_plan(planes: int, node_elems: int, aligned: bool) -> AdamwPlan:
    """The launch of ``adamw_update`` over ``[planes, node_elems]``:
    16-byte vectors where ``aligned`` (g, p, mu and nu all start on
    16-byte addresses) and ``node_elems`` is a multiple of 4 (so no
    vector spans two nodes), else one element a vector; each node's
    vectors held by its blocks, one a thread, with none empty."""
    if planes < 1 or node_elems < 1:
        raise ValueError(f"adamw_plan: [{planes}, {node_elems}] is empty")
    if planes > ADAMW_MAX_GRID_Y:
        raise ValueError(f"adamw_plan: {planes} planes exceed "
                         f"{ADAMW_MAX_GRID_Y}")
    vec = 4 if aligned and node_elems % 4 == 0 else 1
    blocks = -(-(node_elems // vec) // ADAMW_THREADS)
    return AdamwPlan(vec, (blocks, planes))


def adamw_update_cuda(g, p, mu, nu, lr, scale, bc1, bc2, *, b1: float,
                      b2: float, eps: float, weight_decay: float,
                      active=None) -> None:
    """Launch the kernel: updates ``p``, ``mu``, ``nu`` (``[..., R, C]``
    fp32, contiguous, on the card) in place, as :func:`adamw_plan` lays
    it out.  ``lr`` is a one-element fp32 device tensor; ``scale``,
    ``bc1`` and ``bc2`` have one entry per ``R x C`` plane (each node its
    own step counter); ``active`` (bool or uint8, one a plane) masks
    whole planes out of the step."""
    shape = tuple(p.shape)
    bufs = (("g", g), ("p", p), ("mu", mu), ("nu", nu))
    for name, t in bufs:
        require(t, f"adamw_update {name}", torch.float32, shape)
    node_elems = _node_scale(p, scale, "adamw_update")
    planes = p.numel() // node_elems
    _require_scalar(lr, "adamw_update lr")
    for name, t in (("bc1", bc1), ("bc2", bc2)):
        require(t, f"adamw_update {name}", torch.float32, (planes,))
    mask = _active_ptr(active, planes, "adamw_update")
    if p.numel() == 0:
        return
    plan = adamw_plan(planes, node_elems,
                      all(t.data_ptr() % 16 == 0 for _, t in bufs))
    rc = library().adamw_update(
        g.data_ptr(), p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        lr.data_ptr(), scale.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
        mask, p.numel(), node_elems, b1, 1 - b1, b2, 1 - b2, eps,
        weight_decay, plan.vec, *plan.grid,
        stream_of(p))
    check(rc, "adamw_update")
    ADAMW_LAUNCHES.count += 1
    ADAMW_LAUNCHES.last_plan = plan


def sgd_update_cuda(g, p, mu, lr, scale, *, momentum: float,
                    weight_decay: float, active=None) -> None:
    """Launch the kernel: updates ``p`` and ``mu`` (``[..., R, C]`` fp32,
    contiguous, on the card) in place.  ``lr`` is a one-element fp32
    device tensor, ``scale`` has one entry per ``R x C`` plane, and
    ``active`` (bool or uint8, one a plane) masks whole planes out."""
    shape = tuple(p.shape)
    for name, t in (("g", g), ("p", p), ("mu", mu)):
        require(t, f"sgd_update {name}", torch.float32, shape)
    node_elems = _node_scale(p, scale, "sgd_update")
    _require_scalar(lr, "sgd_update lr")
    mask = _active_ptr(active, p.numel() // node_elems, "sgd_update")
    rc = library().sgd_update(
        g.data_ptr(), p.data_ptr(), mu.data_ptr(), lr.data_ptr(),
        scale.data_ptr(), mask, p.numel(), node_elems, momentum,
        weight_decay, stream_of(p))
    check(rc, "sgd_update")
    SGD_LAUNCHES.count += 1


# -- the adafactor apply's launch plan ----------------------------------------
ADA_THREADS = 256      # threads a block (kAdaThreads)
ADA_UNROLL = 4         # vectors a thread (kAdaUnroll)


def adafactor_plan(n: int, align_upd: int, align_p: int) -> SweepPlan:
    """The split of ``[0, n)`` for ``upd`` and ``p`` whose first
    elements lie ``align_upd`` and ``align_p`` floats past a 16-byte
    boundary (:func:`~repro_torch.kernels.sweep.sweep_plan`, in blocks
    of ``ADA_THREADS`` threads, ``ADA_UNROLL`` vectors a thread)."""
    return sweep_plan(n, align_upd, align_p, threads=ADA_THREADS,
                      unroll=ADA_UNROLL, name="adafactor_apply")


def adafactor_apply_cuda(upd, p, lr, *, weight_decay: float,
                         active=None) -> None:
    """Launch the kernel: ``p <- p - lr·(upd + wd·p)`` in place over
    ``[..., R, C]`` fp32 planes (or any contiguous fp32 buffer) on the
    card, as :func:`adafactor_plan` splits it; ``lr`` is a one-element
    fp32 device tensor.  ``active`` (bool or uint8, one entry per
    ``R x C`` plane) masks whole planes out of the step; it needs planes
    that no 16-byte vector of the plan spans two of, and raises
    otherwise."""
    for name, t in (("upd", upd), ("p", p)):
        require(t, f"adafactor_apply {name}", torch.float32, tuple(p.shape))
    _require_scalar(lr, "adafactor_apply lr")
    if p.numel() == 0:
        return
    plan = adafactor_plan(p.numel(), upd.data_ptr() // 4 % 4,
                          p.data_ptr() // 4 % 4)
    node_elems, mask = p.numel(), None
    if active is not None:
        if p.dim() < 2:
            raise ValueError("adafactor_apply active: needs [..., R, C] "
                             "planes")
        node_elems = p.shape[-2] * p.shape[-1]
        planes = p.numel() // node_elems
        mask = _active_ptr(active, planes, "adafactor_apply")
        if plan.vec == 4 and planes > 1 and (node_elems % 4 or plan.head):
            raise ValueError(
                f"adafactor_apply active: a 16-byte vector would span two "
                f"planes ({node_elems} elements a plane, head {plan.head})")
    rc = library().adafactor_apply(upd.data_ptr(), p.data_ptr(),
                                   lr.data_ptr(), mask, node_elems,
                                   p.numel(), weight_decay, plan.vec,
                                   plan.head, plan.body, plan.grid,
                                   stream_of(p))
    check(rc, "adafactor_apply")
    ADAFACTOR_LAUNCHES.count += 1
