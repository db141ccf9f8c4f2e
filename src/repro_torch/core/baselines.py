"""Literature baselines the paper compares against (Sec. IV).

* **FedAvg** — plain decentralized averaging of the full (teacher-size)
  model: :func:`make_fedavg_step` is its node-local step, with the same
  ``NodeState`` layout as ProFe (unused slots hold empty trees).

FedProto, FML and FedGPD, and the engine wiring of all four (what each
ships, the per-leaf student, the fp32 wire), are ROADMAP.md Queue 1
item 9.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core.profe import NodeState, task_ce
from repro_torch.models import forward
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_from_paths, tree_paths


def make_fedavg_step(cfg: ModelConfig, opt: Optimizer, *,
                     grad_clip: float = 1.0):
    """Returns ``step(state, batch, teacher_on=False) -> (state,
    metrics)`` for one node: the forward, ``task_ce + aux ·
    router_aux_weight``, one backward, the global-norm clip and the
    per-leaf ``opt.update``.  ``state.student`` is a per-leaf parameter
    tree (not a Plane) and ``state.opt_s`` its ``opt`` state; both are
    updated in place (the leaves become autograd leaves).  Metrics:
    ``loss_s`` and ``grad_norm_s``."""

    def step(state: NodeState, batch, teacher_on: bool = False):
        paths, leaves = zip(*tree_paths(state.student))
        for leaf in leaves:
            leaf.requires_grad_(True)
        out = forward(cfg, state.student, batch)
        loss = task_ce(cfg, out.logits, batch) \
            + out.aux * getattr(cfg, "router_aux_weight", 0.0)
        grads = tree_from_paths(zip(paths,
                                    torch.autograd.grad(loss, leaves)))
        grads, gn = clip_by_global_norm(grads, grad_clip)
        opt.update(grads, state.opt_s, state.student)
        return state, {"loss_s": loss.detach(), "grad_norm_s": gn}

    return step


def _unported(name: str):
    def make_step(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md Queue 1 item 9 (paper "
            f"baselines)")
    make_step.__name__ = name
    return make_step


make_fedproto_step = _unported("make_fedproto_step")
make_fml_step = _unported("make_fml_step")
make_fedgpd_step = _unported("make_fedgpd_step")
