"""Literature baselines the paper compares against (Sec. IV):

* **FedAvg** — plain decentralized averaging of the full (teacher-size)
  model, fp32 on the wire.
* **FedProto** [9] — local model trained with CE + prototype-MSE; ONLY
  prototypes travel.
* **FML** [8] — personalized (large) + meme (small) models trained with
  Deep Mutual Learning (bidirectional KD); the meme model travels fp32.
* **FedGPD** [10] — CE + global-prototype distillation on one model;
  model + prototypes travel fp32.

Each maker returns ``step(state, batch, teacher_on, active=None) ->
(state, metrics)`` over **stacked** node state with the ProFe ``NodeState``
layout (unused slots hold empty dicts), as ``make_profe_step`` does:
``batch`` leaves are ``[N, B, ...]``, the per-node forwards run in a
Python loop, their losses sum into one backward, and each node's
gradients are clipped on their own (``clip_by_global_norm(lead=1)``)
before the per-leaf ``opt.update(lead=1)``, which writes parameters and
moments in place; ``active`` (``[N]`` bool) masks nodes out of every
update, as in ``make_profe_step``.  What travels, and at what precision, is declared per
algorithm in ``federation._algo_wiring``.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import FederationConfig, ModelConfig
from repro_torch.core import distillation as D
from repro_torch.core import prototypes as P
from repro_torch.core.profe import (NodeState, node_batches, node_params,
                                    proto_labels, router_aux, stacked_update,
                                    task_ce)
from repro_torch.models import forward
from repro_torch.optim import Optimizer


def make_fedavg_step(cfg: ModelConfig, opt: Optimizer, *,
                     grad_clip: float = 1.0, remat: bool = True):
    """``task_ce + aux · router_aux_weight`` on the stacked per-leaf
    ``state.student``.  Metrics: ``loss_s`` and ``grad_norm_s`` ``[N]``."""

    def step(state: NodeState, batch, teacher_on: bool = False,
             active=None):
        losses = []
        for i, b in enumerate(node_batches(batch, len(state.round_idx))):
            out = forward(cfg, node_params(state.student, i), b,
                          remat=remat)
            losses.append(task_ce(cfg, out.logits, b) + router_aux(cfg, out))
        loss = torch.stack(losses)
        gn = stacked_update(state.student, loss.sum(), opt, state.opt_s,
                            grad_clip, active)
        return state, {"loss_s": loss.detach(), "grad_norm_s": gn}

    return step


def _make_proto_step(cfg: ModelConfig, fed: FederationConfig,
                     opt: Optimizer, grad_clip: float, *, gpd: bool,
                     remat: bool = True):
    """FedProto's step, and with ``gpd`` FedGPD's (its prototype CE on
    top).  Metrics: ``loss_s``, ``grad_norm_s`` and the loss forward's
    ``f1`` ``[N, B, P]``."""

    def loss_fn(p, b, gp, mask):
        out = forward(cfg, p, b, remat=remat)
        labels_p = proto_labels(cfg, b)
        l = task_ce(cfg, out.logits, b)
        l = l + fed.beta_s * P.proto_mse_loss(out.f1, gp, labels_p, mask)
        if gpd:
            # negative squared distances to the global prototypes as
            # logits; classes without one at float32's lowest value (not
            # -inf, whose logsumexp gradient would be NaN), and no term at
            # all before any prototype is set (torch.where's backward
            # gives the unused branch zero, never 0·inf)
            d2 = P.pairwise_sq_dists(out.f1, gp)
            logits = torch.where(mask[None, :] > 0, -d2,
                                 torch.finfo(torch.float32).min)
            pce = torch.where(mask.sum() > 0, D.ce_loss(logits, labels_p),
                              torch.zeros((), device=d2.device))
            l = l + 0.5 * pce
        return l + router_aux(cfg, out), out.f1

    def step(state: NodeState, batch, teacher_on: bool = False,
             active=None):
        losses, f1 = [], []
        for i, b in enumerate(node_batches(batch, len(state.round_idx))):
            l, f = loss_fn(node_params(state.student, i), b,
                           state.global_protos[i], state.proto_mask[i])
            losses.append(l)
            f1.append(f.detach())
        loss = torch.stack(losses)
        gn = stacked_update(state.student, loss.sum(), opt, state.opt_s,
                            grad_clip, active)
        return state, {"loss_s": loss.detach(), "grad_norm_s": gn,
                       "f1": torch.stack(f1)}

    return step


def make_fedproto_step(cfg: ModelConfig, fed: FederationConfig,
                       opt: Optimizer, *, grad_clip: float = 1.0,
                       remat: bool = True):
    """CE + beta_s · prototype MSE (FedProto; beta = 1 per paper Sec.
    III-B)."""
    return _make_proto_step(cfg, fed, opt, grad_clip, gpd=False,
                            remat=remat)


def make_fedgpd_step(cfg: ModelConfig, fed: FederationConfig, opt: Optimizer,
                     *, grad_clip: float = 1.0, remat: bool = True):
    """Global-prototype distillation: CE + MSE(f1, C̄(j)) + 0.5 ·
    proto-CE, where proto-CE treats the negative squared distances to the
    global prototypes as logits."""
    return _make_proto_step(cfg, fed, opt, grad_clip, gpd=True,
                            remat=remat)


def make_fml_step(big_cfg: ModelConfig, meme_cfg: ModelConfig,
                  fed: FederationConfig, opt_big: Optimizer,
                  opt_meme: Optimizer, *, grad_clip: float = 1.0,
                  remat: bool = True):
    """Deep Mutual Learning: L_big = CE + alpha_s·KD(big <- meme), then
    L_meme = CE + alpha_s·KD(meme <- big).  ``student`` is the meme (it
    travels) under ``opt_meme``, ``teacher`` the personalized big model
    under ``opt_big``.  The big model updates first, distilling from a
    detached forward of the current meme; the meme then distils from the
    big model's logits of that same (pre-update) forward.  Metrics:
    ``loss_s``, ``loss_t`` and ``grad_norm_s``."""

    def step(state: NodeState, batch, teacher_on: bool = True,
             active=None):
        per_node = node_batches(batch, len(state.round_idx))
        with torch.no_grad():
            meme_logits = [forward(meme_cfg, node_params(state.student, i),
                                   b).logits
                           for i, b in enumerate(per_node)]
        big_losses, big_logits = [], []
        for i, b in enumerate(per_node):
            out = forward(big_cfg, node_params(state.teacher, i), b,
                          remat=remat)
            l = task_ce(big_cfg, out.logits, b)
            l = l + fed.alpha_s * D.kd_loss(out.logits, meme_logits[i],
                                            fed.kd_temperature)
            big_losses.append(l + router_aux(big_cfg, out))
            big_logits.append(out.logits.detach())
        lb = torch.stack(big_losses)
        stacked_update(state.teacher, lb.sum(), opt_big, state.opt_t,
                       grad_clip, active)

        meme_losses = []
        for i, b in enumerate(per_node):
            out = forward(meme_cfg, node_params(state.student, i), b,
                          remat=remat)
            l = task_ce(meme_cfg, out.logits, b)
            l = l + fed.alpha_s * D.kd_loss(out.logits, big_logits[i],
                                            fed.kd_temperature)
            meme_losses.append(l + router_aux(meme_cfg, out))
        lm = torch.stack(meme_losses)
        gn = stacked_update(state.student, lm.sum(), opt_meme, state.opt_s,
                            grad_clip, active)
        return state, {"loss_s": lm.detach(), "loss_t": lb.detach(),
                       "grad_norm_s": gn}

    return step
