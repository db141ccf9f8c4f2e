"""Per-leaf optimizers as ``(init, update)`` pairs over trees of
tensors — the teacher's optimizer, in plain tensor ops: ``sgd`` (with
momentum and decoupled weight decay), ``adamw`` and ``adafactor``.

The expressions are ``repro.optim.optimizers``' term for term.
``update(grads, state, params, lead=0, active=None)``: leaves may carry
``lead`` leading node axes (the stacked engine's ``[N, ...]`` teacher),
and every reduction is then per node, as ``jax.vmap`` makes it in
``repro`` (only adafactor reduces: its factored moments and its RMS
clip).  ``init`` takes unstacked parameters, with a 0-d ``step``; a
stacked state (``lead=1``) keeps one counter a node, ``[N]`` int32, so
each node's bias corrections (adafactor: its decay) follow its own
steps.  ``active`` (``[N]`` bool, ``lead=1``) masks nodes out of the
step: a masked node's parameters, moments and counter come back
bit-unchanged (``torch.where``), as ``repro``'s ``_masked_select``
keeps a padded step's node; None is every node.  ``update`` writes the
new parameters and moments into the given tensors in place (they are
autograd leaves that the next step differentiates again) and returns
them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels.opt_update.ref import keep_masked, per_node, sqrt_rn
from repro_torch.sharding import broadcast_like, place_like
from repro_torch.tree import (tree_empties, tree_from_paths, tree_leaves,
                              tree_map, tree_paths)


def advance(step: torch.Tensor, active) -> torch.Tensor:
    """The step counter after one step: one more on every active node."""
    return keep_masked(active, step + 1, step)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)


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


def sgd(lr: float, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD with momentum: ``mu' = momentum·mu + g``,
    ``p' = p - lr·(mu' + wd·p)``; the lr is read before the step counter
    advances (``repro`` reads ``sched(state["step"])``)."""
    def init(params):
        return {
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params, lead: int = 0, active=None):
        lr_t = torch.full((), lr, dtype=torch.float32,
                          device=state["step"].device)
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["mu"])):
            m_new = momentum * m + g.float()
            newp = (p - lr_t * (m_new + weight_decay * p)).to(p.dtype)
            p.copy_(keep_masked(active, newp, p))
            m.copy_(keep_masked(active, m_new, m))
        state["step"] = advance(state["step"], active)
        return params, state

    return Optimizer(init, update)


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
    def update(grads, state, params, lead: int = 0, active=None):
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
            mh = m_new / per_node(bc1, m_new)
            vh = v_new / per_node(bc2, v_new)
            p32 = p.float()
            newp = p32 - lr_t * (mh / (sqrt_rn(vh) + eps)
                                 + weight_decay * p32)
            p.copy_(keep_masked(active, newp.to(p.dtype), p))
            m.copy_(keep_masked(active, m_new, m))
            v.copy_(keep_masked(active, v_new, v))
        state["step"] = advance(state["step"], active)
        return params, state

    return Optimizer(init, update)


def factored(shape) -> bool:
    """Adafactor factors a leaf's second moment when its own shape (no
    node axes) has two trailing dims > 1: ``vr`` over the last axis,
    ``vc`` over the one before."""
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_moments(shape, lead: int, device):
    """Zero second moments of one leaf of ``shape`` whose first ``lead``
    dims are node axes: ``{"vr", "vc"}`` if it factors, else ``{"v"}``."""
    shape = tuple(shape)
    if factored(shape[lead:]):
        return {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device),
                "vc": torch.zeros(shape[:-2] + shape[-1:],
                                  dtype=torch.float32, device=device)}
    return {"v": torch.zeros(shape, dtype=torch.float32, device=device)}


def adafactor_leaf_update(g32, v, beta, *, lead: int, eps: float,
                          clip_threshold: float):
    """One leaf's adafactor moments and RMS-clipped update ``(upd,
    new_v)`` from its fp32 gradient ``g32`` (``lead`` node axes first):
    ``repro.optim.optimizers.adafactor``'s ``upd`` for every node at
    once.  The RMS and the row factor's mean reduce over the leaf's own
    dims only, so nodes never mix.  ``beta`` is 0-d or one decay a node
    (``[N]``, ``lead=1``).  Shared by the per-leaf optimizer and the
    plane's per-segment sweep, which is then bit-identical to it."""
    shape = tuple(g32.shape[lead:])
    g2 = torch.square(g32) + eps
    one_m_beta = 1 - beta

    def ema(old, new):
        return per_node(beta, old) * old + per_node(one_m_beta, new) * new
    # under an in-node layout each moment is reduced straight into its
    # state's shards and the update into the gradient's (the placements
    # JAX's jit pins the new state to)
    if factored(shape):
        vr = ema(v["vr"], place_like(g2.mean(dim=-1), v["vr"]))
        vc = ema(v["vc"], place_like(g2.mean(dim=-2), v["vc"]))
        rfac = broadcast_like((vr / vr.mean(dim=-1, keepdim=True))[..., None],
                              g32)
        upd = g32 * torch.rsqrt(rfac * vc[..., None, :] + eps)
        new_v = {"vr": vr, "vc": vc}
    else:
        nv = ema(v["v"], place_like(g2, v["v"]))
        upd = g32 * torch.rsqrt(nv + eps)
        new_v = {"v": nv}
    own = tuple(range(lead, upd.dim()))
    rms = torch.sqrt(torch.square(upd).mean(dim=own, keepdim=True) + 1e-12)
    clip = torch.full((), clip_threshold, dtype=torch.float32,
                      device=upd.device)
    return upd / torch.clamp_min(rms / clip, 1.0), new_v


def adafactor_beta(step: torch.Tensor, decay: float = 0.8) -> torch.Tensor:
    """The second-moment decay of step ``step`` (already advanced):
    ``1 - (step + 1)^(-decay)``, in fp32."""
    return 1.0 - (step.float() + 1.0) ** (-decay)


def adafactor(lr: float, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored Adam (Shazeer & Stern 2018), no momentum; the state is
    ``{"v": tree of {vr, vc} | {v}, "step"}``."""
    def init(params):
        return {
            "v": tree_map(lambda p: adafactor_moments(p.shape, 0, p.device),
                          params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(grads, state, params, lead: int = 0, active=None):
        step = state["step"] + 1
        lr_t = torch.full((), lr, dtype=torch.float32, device=step.device)
        beta = adafactor_beta(step, decay)
        paths = [path for path, _ in tree_paths(params)]
        new_v = []
        for path, p, g in zip(paths, tree_leaves(params),
                              tree_leaves(grads)):
            v = state["v"]
            for k in path:
                v = v[k]
            upd, nv = adafactor_leaf_update(
                g.float(), v, beta, lead=lead, eps=eps,
                clip_threshold=clip_threshold)
            p32 = p.float()
            newp = (p32 - lr_t * (upd + weight_decay * p32)).to(p.dtype)
            p.copy_(keep_masked(active, newp, p))
            new_v.append((path, {k: keep_masked(active, x, v[k])
                                 for k, x in nv.items()}))
        state["v"] = tree_from_paths(new_v, tree_empties(params))
        state["step"] = advance(state["step"], active)
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, *, weight_decay: float = 0.01,
                   momentum: float = 0.9) -> Optimizer:
    if name == "sgd":
        return sgd(lr, momentum=momentum, weight_decay=weight_decay)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    if name == "adafactor":
        return adafactor(lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
