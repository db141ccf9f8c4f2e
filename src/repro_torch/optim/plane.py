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
``g = 0, p = 0`` is a fixed point of the adamw sweep, so padding never
leaks into parameters or moments.

:func:`make_plane_optimizer` fuses the global-norm clip and the adamw
update into one sweep over the whole buffer: ONE kernel launch per
training step for every node (``kernels/opt_update``), with the per-node
clip scale and the step scalars kept in device memory.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize.ops import _COLS
from repro_torch.optim.optimizers import Optimizer, _unported
from repro_torch.tree import tree_from_paths, tree_paths


class PlaneMeta(NamedTuple):
    """Static recipe mapping tree leaves to plane rows: ``recipe``
    entries are ``("leaf", path, shape, row, r_leaf)`` — the leaf at
    ``path`` occupies rows ``[row, row + r_leaf)``; ``rows`` is the
    8-aligned row count of the buffer."""
    recipe: Tuple
    rows: int


class Plane(NamedTuple):
    """One model's parameters as a ``[R, 512]`` fp32 buffer
    (``[N, R, 512]`` when node-stacked) plus its static recipe."""
    buf: torch.Tensor
    meta: PlaneMeta


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
    return Plane(buf, PlaneMeta(tuple(recipe), buf.shape[0]))


def _leaf_view(buf: torch.Tensor, shape, row: int, r_leaf: int):
    """``buf[..., row:row+r, :]`` reinterpreted as the leaf shape under
    any leading axes (a view while the span is contiguous)."""
    lead = tuple(buf.shape[:-2])
    per = 1
    for s in shape:
        per *= s
    v = buf[..., row:row + r_leaf, :].reshape(lead + (-1,))
    return v[..., :per].reshape(lead + tuple(shape))


def as_tree(plane: Plane):
    """Tree view of a plane: slice+reshape views of its buffer, with the
    leading node axis when the buffer is stacked.  Differentiable — the
    gradient of a loss of the views is one buffer-shaped tensor."""
    return tree_from_paths(
        (path, _leaf_view(plane.buf, shape, row, r_leaf))
        for _, path, shape, row, r_leaf in plane.meta.recipe)


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
    """Fused clip+adamw over :class:`Plane` params.

    ``update(grads, state, params)`` takes the gradient as a Plane,
    computes the per-node pre-clip norm and clip scale
    ``min(1, clip / max(norm, 1e-9))``, and sweeps the buffer once
    through ``kernels/opt_update`` — the CUDA kernel for tensors on the
    card, its plain version on the CPU — updating params, ``mu`` and
    ``nu`` IN PLACE.  ``lr``, the clip scale and the bias corrections
    ``1 - b**step`` (fp32, from the device step counter) stay device
    tensors: the step path never synchronizes with the host.  The
    returned state reports the pre-clip norm under ``"gnorm"``."""
    from repro_torch.kernels.opt_update.ops import fused_adamw_update
    if name != "adamw":
        raise _unported(f"plane optimizer {name!r}")

    def init(params: Plane):
        buf = params.buf
        lead = tuple(buf.shape[:-2])
        return {"mu": torch.zeros_like(buf, dtype=torch.float32),
                "nu": torch.zeros_like(buf, dtype=torch.float32),
                "step": torch.zeros((), dtype=torch.int32, device=buf.device),
                "gnorm": torch.zeros(lead, dtype=torch.float32,
                                     device=buf.device)}

    @torch.no_grad()
    def update(grads: Plane, state, params: Plane):
        gnorm = plane_global_norm(grads)
        if grad_clip and grad_clip > 0:
            scale = torch.clamp_max(
                torch.full_like(gnorm, grad_clip)
                / torch.clamp_min(gnorm, 1e-9), 1.0)
        else:
            scale = torch.ones_like(gnorm)
        step = state["step"] + 1
        lr_t = torch.full((), lr, dtype=torch.float32, device=step.device)
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        fused_adamw_update(grads.buf, params.buf, state["mu"], state["nu"],
                           lr_t, scale.reshape(-1), bc1, bc2, b1=b1, b2=b2,
                           eps=eps, weight_decay=weight_decay)
        state["step"] = step
        state["gnorm"] = gnorm
        return params, state

    return Optimizer(init, update)
