"""Flat parameter plane: one contiguous fp32 buffer per model.

Every leaf of a parameter tree lands in ONE ``[R, 512]`` fp32 row buffer
(node-stacked: ``[N, R, 512]``), laid out exactly like ``repro``'s plane
and the wire codec: leaves in flatten order (dict keys sorted), each
leaf's ``prod(shape)`` elements padded to a multiple of 512 columns, and
trailing rows padding R to a multiple of 8.  A :class:`PlaneMeta` recipe
maps leaves to row spans, so :func:`as_tree` hands the forward pass
slice+reshape views of the buffer, and the wire path splices the
student's rows straight off it (``kernels/quantize/ops.pack_plane_payload``).

Gradients need no custom backward here: the buffer is one autograd leaf,
so differentiating a loss of its views lands every gradient in one
``[..., R, 512]`` tensor whose padding lanes are exactly zero — the same
padding-lane-zero invariant ``repro``'s custom vjp builds by hand.
``g = 0, p = 0`` is a fixed point of the sgd, adamw and adafactor
sweeps, so padding never leaks into parameters or moments.

:func:`make_plane_optimizer` fuses the global-norm clip and the
optimizer update into one sweep over the whole buffer: ONE kernel launch
per training step for every node (``kernels/opt_update``), with the
per-node clip scale and the step scalars kept in device memory.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.opt_update.ref import keep_masked
from repro_torch.kernels.quantize.ops import _COLS
from repro_torch.optim.optimizers import (Optimizer, adafactor_beta,
                                          adafactor_moments, advance)

# the optimizers with a fused plane sweep (kernels/opt_update)
PLANE_OPTIMIZERS = ("sgd", "adamw", "adafactor")
from repro_torch.tree import (register_buffer_node, tree_empties,
                              tree_from_paths, tree_paths)


class PlaneMeta(NamedTuple):
    """Static recipe mapping tree leaves to plane rows: ``recipe``
    entries are ``("leaf", path, shape, row, r_leaf)`` — the leaf at
    ``path`` occupies rows ``[row, row + r_leaf)``; ``rows`` is the
    8-aligned row count of the buffer; ``empties`` the tree's empty
    subtrees (:func:`~repro_torch.tree.tree_empties`), which hold no
    rows but come back in :func:`as_tree`."""
    recipe: Tuple
    rows: int
    empties: Tuple = ()


class Plane(NamedTuple):
    """One model's parameters as a ``[R, 512]`` fp32 buffer
    (``[N, R, 512]`` when node-stacked) plus its static recipe."""
    buf: torch.Tensor
    meta: PlaneMeta


register_buffer_node(Plane, "buf")     # a state's leaf: the buffer


def plane_from_tree(tree) -> Plane:
    """Pack a parameter tree (no node axis) into a :class:`Plane`."""
    parts, recipe = [], []
    row = 0
    for path, leaf in tree_paths(tree):
        if not leaf.dtype.is_floating_point:
            raise ValueError(f"plane leaves must be float, {path} is "
                             f"{leaf.dtype}")
        per = leaf.numel()
        flat = F.pad(leaf.reshape(-1).float(), (0, (-per) % _COLS))
        rows = flat.reshape(-1, _COLS)
        recipe.append(("leaf", path, tuple(leaf.shape), row, rows.shape[0]))
        parts.append(rows)
        row += rows.shape[0]
    if not parts:
        raise ValueError("plane needs at least one float leaf")
    buf = torch.cat(parts, dim=0)
    buf = F.pad(buf, (0, 0, 0, (-buf.shape[0]) % 8))
    return Plane(buf, PlaneMeta(tuple(recipe), buf.shape[0],
                                tree_empties(tree)))


def _leaf_view(buf: torch.Tensor, shape, row: int, r_leaf: int):
    """``buf[..., row:row+r, :]`` reinterpreted as the leaf shape under
    any leading axes (a view while the span is contiguous)."""
    lead = tuple(buf.shape[:-2])
    per = 1
    for s in shape:
        per *= s
    v = buf[..., row:row + r_leaf, :].reshape(lead + (-1,))
    return v[..., :per].reshape(lead + tuple(shape))


def as_tree(plane):
    """Tree view of a plane: slice+reshape views of its buffer, with the
    leading node axis when the buffer is stacked.  Differentiable — the
    gradient of a loss of the views is one buffer-shaped tensor.  Any
    other tree (a per-leaf student) passes through, as ``repro``'s."""
    if not isinstance(plane, Plane):
        return plane
    return tree_from_paths(
        ((path, _leaf_view(plane.buf, shape, row, r_leaf))
         for _, path, shape, row, r_leaf in plane.meta.recipe),
        plane.meta.empties)


def plane_global_norm(grads: Plane) -> torch.Tensor:
    """Global grad norm over a plane, summed per leaf VIEW in recipe
    order like ``repro``'s per-leaf reduction; a stacked ``[N, R, C]``
    buffer gives one norm per node ``[N]``."""
    buf = grads.buf
    lead = buf.dim() - 2
    total = 0.0
    for _, _, shape, row, r_leaf in grads.meta.recipe:
        sq = torch.square(_leaf_view(buf, shape, row, r_leaf).float())
        total = total + sq.sum(dim=tuple(range(lead, sq.dim())))
    return torch.sqrt(total)


def make_plane_optimizer(name: str, lr: float, *,
                         weight_decay: float = 0.01, momentum: float = 0.9,
                         b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8,
                         grad_clip: float = 0.0) -> Optimizer:
    """Fused clip+update optimizer over :class:`Plane` params: ``"sgd"``,
    ``"adamw"`` or ``"adafactor"``.

    ``update(grads, state, params)`` takes the gradient as a Plane,
    computes the per-node pre-clip norm and clip scale
    ``min(1, clip / max(norm, 1e-9))``, and sweeps the buffer once
    through ``kernels/opt_update`` — the CUDA kernel for tensors on the
    card, its plain version on the CPU — updating the parameters and the
    moments IN PLACE.  sgd keeps ``mu`` and adamw ``mu``/``nu`` as
    sibling planes; adafactor keeps its factored second moment per leaf
    *segment* (``fac``, a tuple aligned with the recipe, each entry with
    the node axis: ``vr``/``vc`` for factored shapes, dense ``v``
    otherwise; ``decay=0.8, eps=1e-30, clip_threshold=1.0`` as the
    per-leaf optimizer) and rides one fused apply sweep.  ``lr``, the
    clip scale and the step scalars stay device tensors: the step path
    never synchronizes with the host.  sgd reads the lr before its step
    counter advances, adamw and adafactor after (``repro``'s order; the
    lr is constant here).  The returned state reports the pre-clip norm
    under ``"gnorm"``."""
    from repro_torch.kernels.opt_update.ops import (fused_adafactor_update,
                                                    fused_adamw_update,
                                                    fused_sgd_update)
    if name not in PLANE_OPTIMIZERS:
        raise ValueError(f"plane optimizer supports {PLANE_OPTIMIZERS}, "
                         f"got {name!r}")

    def init(params: Plane):
        buf = params.buf
        lead = tuple(buf.shape[:-2])
        state = {"step": torch.zeros(lead, dtype=torch.int32,
                                     device=buf.device),
                 "gnorm": torch.zeros(lead, dtype=torch.float32,
                                      device=buf.device)}
        if name == "adafactor":
            state["fac"] = tuple(
                adafactor_moments(lead + shape, len(lead), buf.device)
                for _, _, shape, _, _ in params.meta.recipe)
            return state
        state["mu"] = torch.zeros_like(buf, dtype=torch.float32)
        if name == "adamw":
            state["nu"] = torch.zeros_like(buf, dtype=torch.float32)
        return state

    @torch.no_grad()
    def update(grads: Plane, state, params: Plane, active=None):
        gnorm = plane_global_norm(grads)
        if grad_clip and grad_clip > 0:
            scale = torch.clamp_max(
                torch.full_like(gnorm, grad_clip)
                / torch.clamp_min(gnorm, 1e-9), 1.0)
        else:
            scale = torch.ones_like(gnorm)
        scale = scale.reshape(-1)
        # one step count a plane: a 0-d counter (one for every node)
        # broadcasts to the planes
        step = (state["step"] + 1).expand(scale.shape).contiguous()
        lr_t = torch.full((), lr, dtype=torch.float32, device=step.device)
        if name == "sgd":
            fused_sgd_update(grads.buf, params.buf, state["mu"], lr_t, scale,
                             momentum=momentum, weight_decay=weight_decay,
                             active=active)
        elif name == "adamw":
            bc1 = 1.0 - b1 ** step.float()
            bc2 = 1.0 - b2 ** step.float()
            fused_adamw_update(grads.buf, params.buf, state["mu"],
                               state["nu"], lr_t, scale, bc1, bc2, b1=b1,
                               b2=b2, eps=eps, weight_decay=weight_decay,
                               active=active)
        else:
            state["fac"] = fused_adafactor_update(
                grads.buf, params.buf, state["fac"], lr_t, scale,
                adafactor_beta(step), recipe=params.meta.recipe,
                weight_decay=weight_decay, active=active)
        state["step"] = advance(state["step"], active)
        state["gnorm"] = keep_masked(active, gnorm, state["gnorm"])
        return params, state

    return Optimizer(init, update)
