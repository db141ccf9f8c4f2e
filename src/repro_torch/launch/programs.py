"""The programs of the compile report (one per input-shape kind) and
their input stand-ins, as the JAX package's ``launch/programs.py``:

* ``train_4k``    -> :func:`make_profe_train_fn`, the ProFe joint step
                     (the teacher's Eq. 9 and the student's Eq. 8
                     distilling from it, both optimizers) with gradient
                     accumulation over ``TrainConfig.microbatches``
* ``prefill_32k`` -> :func:`make_prefill_fn`, the teacher's forward
                     building the decode cache
* ``decode_32k``  -> :func:`make_serve_fn`, one token against a full KV
                     cache
* ``long_500k``   -> :func:`make_serve_fn`, one token on the
                     sub-quadratic path (the native state of ssm /
                     hybrid; a rolling window for the rest)

The stand-ins (:func:`batch_struct`, :func:`decode_struct`,
:func:`node_state_struct`) are tensors on the ``meta`` device: shapes
and dtypes with no storage, the counterpart of ``jax.ShapeDtypeStruct``
and ``jax.eval_shape``.  The train program runs on an unstacked
per-leaf :class:`~repro_torch.core.profe.NodeState`
(``init_node_state(..., plane=False)``); the math is ``core/profe.py``'s,
plain PyTorch, and no program launches a kernel of its own.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.profiler import record_function

from repro_torch.config import FederationConfig, TrainConfig
from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.core import distillation as D
from repro_torch.core.profe import NodeState, student_loss, teacher_loss
from repro_torch.models import (ModelOutput, decode_step, init_cache,
                                init_params, prefill)
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.sharding import place_like
from repro_torch.tree import (tree_empties, tree_from_paths, tree_map,
                              tree_paths)


# ---------------------------------------------------------------------------
# input stand-ins (meta tensors)
# ---------------------------------------------------------------------------

def sds(shape, dtype, device="meta") -> torch.Tensor:
    """A stand-in: a tensor of ``shape`` and ``dtype`` with no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 device="meta") -> Dict[str, torch.Tensor]:
    """Model inputs for a training / prefill batch: int32 ``tokens``
    ``[B, S]`` (and for training ``labels`` ``[B, S]``, ``domains``
    ``[B]``), bf16 ``image_embed`` / ``audio_embed`` for the VLM and
    audio families."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32, device)}
    if shape.kind == "train":
        batch["labels"] = sds((b, s), torch.int32, device)
        batch["domains"] = sds((b,), torch.int32, device)
    if cfg.family == "vlm":
        batch["image_embed"] = sds((b, cfg.num_image_tokens, cfg.d_model),
                                   torch.bfloat16, device)
    if cfg.family == "audio":
        batch["audio_embed"] = sds((b, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16, device)
    return batch


def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """long_500k takes the sub-quadratic path: the native state of ssm /
    hybrid, a rolling ``sliding_window_serve`` KV cache for the
    full-attention families."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return cfg.sliding_window_serve
    return shape.seq_len


def decode_rolling(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return shape.name == "long_500k" and not cfg.subquadratic


def decode_struct(cfg: ModelConfig, shape: ShapeConfig,
                  device="meta") -> Dict[str, Any]:
    """One decode step's inputs: ``token`` int32 ``[B, 1]``, ``index``
    (a 0-d int32 stand-in of the position: the port's step takes it as a
    Python int, since the cache write is a slice), the bf16 ``cache`` of
    :func:`decode_cache_len` slots, and for the VLM and audio families
    the bf16 cross-attention ``memory``."""
    b = shape.global_batch
    d: Dict[str, Any] = {
        "token": sds((b, 1), torch.int32, device),
        "index": sds((), torch.int32, device),
        "cache": init_cache(cfg, b, decode_cache_len(cfg, shape),
                            torch.bfloat16, device),
    }
    if cfg.family == "vlm":
        d["memory"] = sds((b, cfg.num_image_tokens, cfg.d_model),
                          torch.bfloat16, device)
    if cfg.family == "audio":
        d["memory"] = sds((b, cfg.encoder_seq, cfg.d_model),
                          torch.bfloat16, device)
    return d


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, Any]:
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_struct(cfg, shape, device)}
    return decode_struct(cfg, shape, device)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

def _grads(loss, params) -> Any:
    """``d loss / d params`` as a tree like ``params``; a leaf the loss
    never reads gets zeros, as under ``jax.grad``.  Under an in-node
    layout each gradient is placed as its parameter (a partial sum over
    the batch's ranks reduce-scattered to the parameter's shards, as the
    state's shardings make XLA do)."""
    paths, leaves = zip(*tree_paths(params))
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_from_paths(
        ((p, torch.zeros_like(x) if g is None else place_like(g, x))
         for p, x, g in zip(paths, leaves, got)), tree_empties(params))


def _rows(batch: Dict[str, torch.Tensor], m: int) -> int:
    """The rows of each of ``m`` microbatches (consecutive rows of every
    batch leaf)."""
    rows = {int(v.shape[0]) for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % m:
        raise ValueError(f"microbatches={m} does not divide the batch's "
                         f"leading dims {sorted(rows)}")
    return next(iter(rows)) // m


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
    and ``alpha``.  The teacher's and the student's work run in
    ``record_function`` spans ``"teacher"`` and ``"student"``, each
    microbatch's in a span ``"microbatch"``: a profiler trace shows them,
    and an op count (``launch/op_analysis``) splits by them."""
    opt_s = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay)
    opt_t = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay)

    def micro_grads(teacher, student, state: NodeState, batch, alpha):
        """Teacher and student gradients and losses of one microbatch."""
        with record_function("teacher"):
            lt, tout = teacher_loss(teacher_cfg, teacher, batch,
                                    state.global_protos, state.proto_mask,
                                    fed.beta_t, remat=train.remat)
            gt = _grads(lt, teacher)
            tout = ModelOutput(tout.logits.detach(), tout.f1.detach(),
                               tout.aux.detach())
        with record_function("student"):
            ls, _ = student_loss(student_cfg, student, batch,
                                 state.global_protos, state.proto_mask,
                                 alpha, fed.beta_s, fed.kd_temperature,
                                 tout, remat=train.remat)
            gs = _grads(ls, student)
        return gt, gs, lt.detach(), ls.detach()

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
            with record_function("teacher"):
                gt = tree_map(torch.zeros_like, state.teacher)
            with record_function("student"):
                gs = tree_map(torch.zeros_like, state.student)
            lt = torch.zeros((), dtype=torch.float32,
                             device=state.round_idx.device)
            ls = torch.zeros_like(lt)
            rows = _rows(batch, m)
            for i in range(m):
                with record_function("microbatch"):
                    mb = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    g_t, g_s, l_t, l_s = micro_grads(teacher, student, state,
                                                     mb, alpha)
                    with record_function("teacher"):
                        gt = tree_map(lambda a, g: a + g.to(a.dtype), gt,
                                      g_t)
                    with record_function("student"):
                        gs = tree_map(lambda a, g: a + g.to(a.dtype), gs,
                                      g_s)
                    lt, ls = lt + l_t, ls + l_s
                    del g_t, g_s, mb
            scale = 1.0 / m
            with record_function("teacher"):
                gt = tree_map(lambda g: g * scale, gt)
            with record_function("student"):
                gs = tree_map(lambda g: g * scale, gs)
            lt, ls = lt * scale, ls * scale
        with record_function("teacher"):
            gt, _ = clip_by_global_norm(gt, train.grad_clip)
            opt_t.update(gt, state.opt_t, state.teacher)
        with record_function("student"):
            gs, gn = clip_by_global_norm(gs, train.grad_clip)
            opt_s.update(gs, state.opt_s, state.student)
        metrics = {"loss_s": ls, "loss_t": lt, "grad_norm_s": gn,
                   "alpha": alpha}
        return state, metrics

    return train_step, (opt_s, opt_t)


def make_prefill_fn(cfg: ModelConfig):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch)
    return prefill_step


def make_serve_fn(cfg: ModelConfig, shape: ShapeConfig):
    """``serve_step(params, token, index, cache, memory=None) -> (logits,
    cache)``: one decode step, rolling on ``long_500k`` for the
    full-attention families (:func:`decode_rolling`); ``index`` is the
    token's position (an int), the cache is written in place."""
    rolling = decode_rolling(cfg, shape)

    def serve_step(params, token, index, cache, memory=None):
        return decode_step(cfg, params, token, index, cache, memory,
                           rolling=rolling)
    return serve_step


def node_state_struct(teacher_cfg: ModelConfig, student_cfg: ModelConfig,
                      train: TrainConfig, n_classes: int,
                      device="meta") -> NodeState:
    """One node's full ProFe state on ``device`` (``meta``: shapes only):
    teacher and per-leaf student in their configs' parameter dtype, both
    optimizers' states (``make_optimizer(train.optimizer, lr)``), fp32
    prototypes ``[C, proto_dim]`` and mask ``[C]``, the int32 round."""
    opt_s = make_optimizer(train.optimizer, train.learning_rate)
    opt_t = make_optimizer(train.optimizer, train.learning_rate)
    gen = torch.Generator().manual_seed(0)
    teacher = init_params(teacher_cfg, gen, device=device)
    student = init_params(student_cfg, gen, device=device)
    return NodeState(
        student=student, teacher=teacher,
        opt_s=opt_s.init(student), opt_t=opt_t.init(teacher),
        global_protos=torch.zeros((n_classes, student_cfg.proto_dim),
                                  dtype=torch.float32, device=device),
        proto_mask=torch.zeros((n_classes,), dtype=torch.float32,
                               device=device),
        round_idx=torch.zeros((), dtype=torch.int32, device=device))
