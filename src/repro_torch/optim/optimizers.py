"""Per-leaf optimizers as ``(init, update)`` pairs over nested dicts of
tensors — the teacher's optimizer, in plain tensor ops.

The expressions are ``repro.optim.optimizers``' term for term.  Leaves
may carry ``lead`` leading node axes (the stacked engine's ``[N, ...]``
teacher): every reduction is then per node, as ``jax.vmap`` makes it in
``repro``.  ``update`` writes the new parameters and moments into the
given tensors in place (they are autograd leaves that the next step
differentiates again) and returns them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels.opt_update.ref import sqrt_rn
from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue 1 item 3 "
        f"(sgd / adafactor) and Queue 2 (their plane kernels)")


def clip_by_global_norm(grads, max_norm: float, *, lead: int = 0):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    The norm sums leaf by leaf in flatten order; with ``lead`` node axes
    each node is clipped on its own.  Returns ``(clipped, norm)``."""
    leaves = tree_leaves(grads)
    total = 0.0
    for g in leaves:
        sq = torch.square(g.float())
        total = total + (sq.sum(dim=tuple(range(lead, g.dim())))
                         if g.dim() > lead else sq)
    gn = torch.sqrt(total)
    scale = torch.clamp_max(
        torch.full_like(gn, max_norm) / torch.clamp_min(gn, 1e-9), 1.0)

    def apply(g):
        s = scale.reshape(scale.shape + (1,) * (g.dim() - lead))
        return g * s.to(g.dtype)
    return tree_map(apply, grads), gn


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        return {
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = torch.full((), lr, dtype=torch.float32, device=step.device)
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            g32 = g.float()
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * torch.square(g32)
            mh = m_new / bc1
            vh = v_new / bc2
            p32 = p.float()
            newp = p32 - lr_t * (mh / (sqrt_rn(vh) + eps)
                                 + weight_decay * p32)
            p.copy_(newp.to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
        state["step"] = step
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, *, weight_decay: float = 0.01,
                   momentum: float = 0.9) -> Optimizer:
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    if name in ("sgd", "adafactor"):
        raise _unported(f"optimizer {name!r}")
    raise ValueError(f"unknown optimizer {name!r}")
