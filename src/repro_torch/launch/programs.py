"""The ProFe train program with gradient accumulation.

:func:`make_profe_train_fn` is one node's joint step (the teacher's
Eq. 9 and the student's Eq. 8 distilling from it, both optimizers) on
an unstacked per-leaf :class:`~repro_torch.core.profe.NodeState`
(``init_node_state(..., plane=False)``), with ``TrainConfig.microbatches``
splitting the batch so that a step holds the activations of one
microbatch at a time.  The math is ``core/profe.py``'s; the program is
plain PyTorch, per leaf, and launches no kernel of its own.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.config import FederationConfig, TrainConfig
from repro_torch.config.base import ModelConfig
from repro_torch.core import distillation as D
from repro_torch.core.profe import NodeState, student_loss, teacher_loss
from repro_torch.models import ModelOutput
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.tree import (tree_empties, tree_from_paths, tree_map,
                              tree_paths)


def _grads(loss, params) -> Any:
    """``d loss / d params`` as a tree like ``params``; a leaf the loss
    never reads gets zeros, as under ``jax.grad``."""
    paths, leaves = zip(*tree_paths(params))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_from_paths(
        ((p, torch.zeros_like(x) if g is None else g)
         for p, x, g in zip(paths, leaves, got)), tree_empties(params))


def _split(batch: Dict[str, torch.Tensor], m: int
           ) -> List[Dict[str, torch.Tensor]]:
    """``m`` microbatches of consecutive rows of every batch leaf."""
    rows = {int(v.shape[0]) for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % m:
        raise ValueError(f"microbatches={m} does not divide the batch's "
                         f"leading dims {sorted(rows)}")
    b = next(iter(rows)) // m
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            for i in range(m)]


def make_profe_train_fn(teacher_cfg: ModelConfig, student_cfg: ModelConfig,
                        fed: FederationConfig, train: TrainConfig):
    """Returns ``(train_step, (opt_s, opt_t))``, the JAX package's
    ``launch/programs.make_profe_train_fn``:
    ``train_step(state, batch) -> (state, metrics)`` on one node's
    unstacked per-leaf state, ``batch`` leaves ``[B, ...]``.

    α is taken at ``state.round_idx``.  With ``train.microbatches = m >
    1`` the batch splits into m microbatches of ``B / m`` rows (a batch
    that m does not divide raises ``ValueError``); each runs the
    teacher's forward and backward, then the student's (``train.remat``,
    the router term included), and the gradients are summed in each
    parameter's dtype (bf16 parameters accumulate in bf16), then
    gradients and losses scaled by 1/m.  Both gradients are clipped at
    ``train.grad_clip`` by their global norm and the optimizers
    (``train.optimizer``) update parameters and moments in place.
    Metrics: ``loss_s``, ``loss_t``, ``grad_norm_s`` (before the clip)
    and ``alpha``."""
    opt_s = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay)
    opt_t = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay)

    def micro_grads(teacher, student, state: NodeState, batch, alpha):
        """Teacher and student gradients and losses of one microbatch."""
        lt, tout = teacher_loss(teacher_cfg, teacher, batch,
                                state.global_protos, state.proto_mask,
                                fed.beta_t, remat=train.remat)
        gt = _grads(lt, teacher)
        tout = ModelOutput(tout.logits.detach(), tout.f1.detach(),
                           tout.aux.detach())
        ls, _ = student_loss(student_cfg, student, batch,
                             state.global_protos, state.proto_mask, alpha,
                             fed.beta_s, fed.kd_temperature, tout,
                             remat=train.remat)
        return gt, _grads(ls, student), lt.detach(), ls.detach()

    def train_step(state: NodeState, batch):
        alpha = D.alpha_at_round(fed.alpha_s, fed.alpha_limit,
                                 state.round_idx)
        # aliases of the parameters that autograd differentiates; the
        # optimizers update the parameters themselves, in place
        teacher = tree_map(lambda x: x.detach().requires_grad_(True),
                           state.teacher)
        student = tree_map(lambda x: x.detach().requires_grad_(True),
                           state.student)
        m = train.microbatches
        if m <= 1:
            gt, gs, lt, ls = micro_grads(teacher, student, state, batch,
                                         alpha)
        else:
            gt = tree_map(torch.zeros_like, state.teacher)
            gs = tree_map(torch.zeros_like, state.student)
            lt = torch.zeros((), dtype=torch.float32,
                             device=state.round_idx.device)
            ls = torch.zeros_like(lt)
            for mb in _split(batch, m):
                g_t, g_s, l_t, l_s = micro_grads(teacher, student, state, mb,
                                                 alpha)
                gt = tree_map(lambda a, g: a + g.to(a.dtype), gt, g_t)
                gs = tree_map(lambda a, g: a + g.to(a.dtype), gs, g_s)
                lt, ls = lt + l_t, ls + l_s
                del g_t, g_s
            scale = 1.0 / m
            gt = tree_map(lambda g: g * scale, gt)
            gs = tree_map(lambda g: g * scale, gs)
            lt, ls = lt * scale, ls * scale
        gt, _ = clip_by_global_norm(gt, train.grad_clip)
        opt_t.update(gt, state.opt_t, state.teacher)
        gs, gn = clip_by_global_norm(gs, train.grad_clip)
        opt_s.update(gs, state.opt_s, state.student)
        metrics = {"loss_s": ls, "loss_t": lt, "grad_norm_s": gn,
                   "alpha": alpha}
        return state, metrics

    return train_step, (opt_s, opt_t)
