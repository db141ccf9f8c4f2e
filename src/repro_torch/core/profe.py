"""ProFe node-local training step (paper Sec. III-C, Eq. 8/9).

Each node holds a *teacher* (the full architecture, never communicated)
and a *student* (the aggregation model).  Per batch:

    L_s = L_CE(y_s, y) + β_s L_MSE(f_s1, C̄(j))
          + α_s [ L_KD(y_s, y_t) + L_MSE(f_s1, f_t1) ]          (Eq. 8)
    L_t = L_CE(y_t, y) + β_t L_MSE(f_t1, C̄(j))                 (Eq. 9)

The round engine runs the step over **stacked** node state: every tensor
carries a leading ``[N]`` node axis, the student lives in one
``[N, R, 512]`` plane buffer (or, off the plane, in ``[N, ...]`` leaves)
and the teacher in ``[N, ...]`` leaves.  The per-node forwards run in a
Python loop; their losses sum into one backward (node i's parameters
only see node i's loss), so on the plane the student optimizer (sgd,
adamw or adafactor) is ONE fused sweep per step over the whole plane.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.config.base import FederationConfig, ModelConfig
from repro_torch.core import distillation as D
from repro_torch.core import prototypes as P
from repro_torch.core.wire_state import CodecState
from repro_torch.kernels.proto_accum.ops import proto_accumulate_nodes
from repro_torch.models import ModelOutput, forward, params_from_numpy
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
from repro_torch.sharding import replicate
from repro_torch.tree import (tree_empties, tree_from_paths, tree_leaves,
                              tree_map, tree_paths)


class NodeState(NamedTuple):
    # Plane or per-leaf tree: buf [R, 512] ([N, R, 512] stacked), or off
    # the plane (param_plane="off", every baseline of core/baselines.py)
    # a dict tree of [...] ([N, ...] stacked) autograd leaves
    student: Any
    # dict tree of [...] ([N, ...] stacked); an empty dict where the
    # algorithm has no teacher (fedavg, fedproto, fedgpd), and opt_t too
    teacher: Any
    # the optimizers' own states (``make_plane_optimizer`` and the
    # per-leaf ``make_optimizer``):
    #   opt_s  sgd {"mu", "step", "gnorm"}, adamw {"mu", "nu", "step",
    #          "gnorm"}, adafactor {"fac", "step", "gnorm"}
    #   opt_t  sgd {"mu", "step"}, adamw {"mu", "nu", "step"},
    #          adafactor {"v": tree of {vr, vc} | {v}, "step"}
    opt_s: Dict[str, Any]
    opt_t: Dict[str, Any]
    global_protos: torch.Tensor  # [C, P]
    proto_mask: torch.Tensor     # [C]
    round_idx: torch.Tensor      # int32 scalar ([N] stacked)
    # error-feedback codec state (None unless the WireSpec has +ef): a
    # core.wire_state.CodecState whose residual mirrors the wire
    # payload {"protos", "student": Plane}
    wire_state: Any = None
    # the prototype EMA carry (None unless FederationConfig.proto_ema >
    # 0): last round's raw Eq. 3 accumulators ``(sums [C, P], counts
    # [C])`` fp32 (``[N, ...]`` stacked), decayed into the next round's
    # accumulation before the normalization
    proto_acc: Any = None
    # adapter-rank wire state (None unless FederationConfig.adapter_rank):
    # {"ref": {leaf: W}, ["grams": {leaf: G}]} — the round-start matrix
    # leaves the next delta is taken against (copies, never views of the
    # plane) and the carried gram statistics (core/adapters.py)
    adapter_state: Any = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  With no card and no explicit request it raises —
    the port never carries on quietly on the CPU.  On the card it turns
    TF32 off for matmuls and cuDNN convolutions, so float32 stays
    float32 as in the JAX reference."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def proto_labels(cfg: ModelConfig, batch) -> torch.Tensor:
    """The prototype class of each example: the true label for
    classifiers, the sequence's domain tag (``batch["domains"]``) for
    the LM families."""
    if cfg.family in ("cnn", "resnet"):
        return batch["label"]
    return batch["domains"]


# Under an in-node layout each loss term is a DTensor scalar, reduced
# whole (``sharding.replicate``) before the terms are summed: a partial
# sum and a partial mean do not add (torch 2.11's DTensor refuses to
# turn one into the other)


def task_ce(cfg: ModelConfig, logits, batch) -> torch.Tensor:
    """Task cross-entropy: classification CE, or next-token CE for LMs."""
    if cfg.family in ("cnn", "resnet"):
        return D.ce_loss(logits, batch["label"])
    return replicate(D.ce_loss(logits, batch["labels"]))


def router_aux(cfg: ModelConfig, out: ModelOutput) -> torch.Tensor:
    """The MoE load-balance term ``aux · router_aux_weight`` (0 for a
    model without a router)."""
    return replicate(out.aux) * getattr(cfg, "router_aux_weight", 0.0)


def student_loss(student_cfg: ModelConfig, sp, batch, global_protos,
                 proto_mask, alpha, beta_s: float, temperature: float,
                 teacher_out: Optional[ModelOutput] = None, *,
                 remat: bool = True):
    """Eq. 8 for one node, plus the router term. ``teacher_out=None``:
    the professor has decayed away.  ``remat`` recomputes each period of
    an LM stack in the backward (``models.forward``)."""
    out = forward(student_cfg, sp, batch, remat=remat)
    loss = task_ce(student_cfg, out.logits, batch)
    loss = loss + beta_s * replicate(P.proto_mse_loss(
        out.f1, global_protos, proto_labels(student_cfg, batch), proto_mask))
    if teacher_out is not None:
        kd = replicate(D.kd_loss(out.logits, teacher_out.logits,
                                 temperature))
        rep = replicate(D.repr_mse_loss(out.f1, teacher_out.f1))
        loss = loss + alpha * (kd + rep)
    return loss + router_aux(student_cfg, out), out


def teacher_loss(teacher_cfg: ModelConfig, tp, batch, global_protos,
                 proto_mask, beta_t: float, *, remat: bool = True):
    """Eq. 9 for one node, plus the router term:
    L_t = L_CE + beta_t * L_MSE(f_t1, C̄(j)) + aux · router_aux_weight."""
    out = forward(teacher_cfg, tp, batch, remat=remat)
    loss = task_ce(teacher_cfg, out.logits, batch)
    loss = loss + beta_t * replicate(P.proto_mse_loss(
        out.f1, global_protos, proto_labels(teacher_cfg, batch), proto_mask))
    return loss + router_aux(teacher_cfg, out), out


def node_params(params, i: int):
    """Node ``i``'s parameter tree of stacked ``params``: views of a
    Plane's buffer, or each ``[N, ...]`` leaf's slice ``i``."""
    if isinstance(params, Plane):
        return as_tree(Plane(params.buf[i], params.meta))
    return tree_map(lambda x: x[i], params)


def node_batches(batch, n: int) -> List[Dict[str, torch.Tensor]]:
    """``[N, B, ...]`` batch leaves -> one ``[B, ...]`` batch a node."""
    return [{k: v[i] for k, v in batch.items()} for i in range(n)]


def stacked_update(params, loss, opt: Optimizer, opt_state,
                   grad_clip: float, active=None) -> torch.Tensor:
    """One backward of ``loss`` (the sum of the nodes' losses) to the
    stacked per-leaf ``params``, each node's global-norm clip at
    ``grad_clip`` and the per-leaf ``opt.update`` over the node axis, in
    place; ``active`` (``[N]`` bool) masks nodes out of the update.
    Returns the nodes' pre-clip gradient norms ``[N]``."""
    paths, leaves = zip(*tree_paths(params))
    # a leaf the loss never reads (an LM's proto_proj under FedAvg) has
    # a zero gradient, as under jax.grad
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    clipped, gn = clip_by_global_norm(
        tree_from_paths(zip(paths, grads), tree_empties(params)), grad_clip,
        lead=1)
    opt.update(clipped, opt_state, params, lead=1, active=active)
    return gn


def make_profe_step(teacher_cfg: ModelConfig, student_cfg: ModelConfig,
                    fed: FederationConfig, opt_s: Optimizer,
                    opt_t: Optimizer, *, grad_clip: float = 1.0,
                    remat: bool = True):
    """Returns ``step(state, batch, teacher_on, active=None) -> (state,
    metrics)`` over stacked node state; ``batch`` leaves are ``[N, B,
    ...]``.  ``remat`` recomputes each period of an LM stack in the
    backward instead of keeping its activations (the result is the
    same).  Parameters and optimizer moments update in place.  On the
    plane ``opt_s`` is a plane optimizer, whose fused sweep clips at
    ``grad_clip`` itself; a per-leaf student is clipped per node and
    updated by the per-leaf ``opt_s``.  ``active`` (``[N]`` bool) masks
    nodes out of both optimizers' updates: a node with fewer local
    batches leaves a padded step with its parameters, moments and step
    counters unchanged."""

    def step(state: NodeState, batch, teacher_on: bool, active=None):
        n = state.round_idx.shape[0]
        alpha = D.alpha_at_round(fed.alpha_s, fed.alpha_limit,
                                 state.round_idx)                  # [N]
        metrics: Dict[str, torch.Tensor] = {}
        per_node = node_batches(batch, n)

        teacher_out: Optional[List[ModelOutput]] = None
        if teacher_on:
            outs, losses = [], []
            for i, b in enumerate(per_node):
                l, out = teacher_loss(teacher_cfg,
                                      node_params(state.teacher, i), b,
                                      state.global_protos[i],
                                      state.proto_mask[i], fed.beta_t,
                                      remat=remat)
                outs.append(out)
                losses.append(l)
            lt = torch.stack(losses)
            stacked_update(state.teacher, lt.sum(), opt_t, state.opt_t,
                           grad_clip, active)
            metrics["loss_t"] = lt.detach()
            teacher_out = [ModelOutput(o.logits.detach(), o.f1.detach(),
                                       o.aux) for o in outs]

        losses, f1s = [], []
        for i, b in enumerate(per_node):
            l, out = student_loss(
                student_cfg, node_params(state.student, i), b,
                state.global_protos[i], state.proto_mask[i], alpha[i],
                fed.beta_s, fed.kd_temperature,
                teacher_out[i] if teacher_out is not None else None,
                remat=remat)
            losses.append(l)
            f1s.append(out.f1.detach())
        ls = torch.stack(losses)
        if isinstance(state.student, Plane):
            (gbuf,) = torch.autograd.grad(ls.sum(), [state.student.buf])
            opt_s.update(Plane(gbuf, state.student.meta), state.opt_s,
                         state.student, active=active)
            gnorm = state.opt_s["gnorm"]
        else:
            gnorm = stacked_update(state.student, ls.sum(), opt_s,
                                   state.opt_s, grad_clip, active)
        # the f1 the loss used (before this step's update) rides out for
        # the fused Eq. 3 pass (proto_pass="fused")
        metrics.update(loss_s=ls.detach(), grad_norm_s=gnorm, alpha=alpha,
                       f1=torch.stack(f1s))
        return state, metrics

    return step


def init_node_state(teacher_cfg: ModelConfig, student_cfg: ModelConfig,
                    gen: torch.Generator, opt_s: Optimizer, opt_t: Optimizer,
                    n_classes: int, *, plane: bool = True,
                    proto_ema: float = 0.0, device=None) -> NodeState:
    """One node's fresh state: teacher and student initialized from
    ``gen`` (on the CPU, then moved), the student packed into a plane
    (``opt_s`` must then be a plane optimizer), or with ``plane=False``
    kept a per-leaf tree for the per-leaf ``opt_s``.  ``proto_ema`` > 0
    allocates the zero prototype EMA carry.  Runs on ``cuda`` unless
    ``device`` names another device."""
    from repro_torch.models import init_params
    device = resolve_device(device)
    teacher = tree_map(lambda x: x.to(device), init_params(teacher_cfg, gen))
    student = tree_map(lambda x: x.to(device), init_params(student_cfg, gen))
    if plane:
        student = plane_from_tree(student)
    return NodeState(
        student=student, teacher=teacher,
        opt_s=opt_s.init(student), opt_t=opt_t.init(teacher),
        global_protos=torch.zeros((n_classes, student_cfg.proto_dim),
                                  dtype=torch.float32, device=device),
        proto_mask=torch.zeros((n_classes,), dtype=torch.float32,
                               device=device),
        round_idx=torch.zeros((), dtype=torch.int32, device=device),
        proto_acc=zero_proto_acc(n_classes, student_cfg.proto_dim, device)
        if proto_ema and proto_ema > 0 else None)


def zero_proto_acc(n_classes: int, proto_dim: int, device):
    """A zero prototype EMA carry ``(sums [C, P], counts [C])`` fp32."""
    return (torch.zeros((n_classes, proto_dim), dtype=torch.float32,
                        device=device),
            torch.zeros((n_classes,), dtype=torch.float32, device=device))


def node_state_from_numpy(student, teacher, opt_s, opt_t, global_protos,
                          proto_mask, round_idx=0, *, plane: bool = True,
                          residual=None, seq=0, proto_acc=None,
                          adapter_state=None, device=None) -> NodeState:
    """One node's state carried over from the JAX package.

    ``student`` and ``teacher`` are parameter trees (nested dicts and
    lists of numpy arrays — for a plane-backed JAX student, its leaf
    views); ``opt_s`` is the JAX plane optimizer state and ``opt_t`` the
    per-leaf optimizer state, of sgd, adamw or adafactor, as numpy trees
    (see :class:`NodeState`; a plane's ``mu``/``nu`` are ``[R, 512]`` in
    the port's layout, adafactor's ``fac`` is aligned with its recipe).
    With ``plane=False`` the student stays a per-leaf tree and ``opt_s``
    is its per-leaf optimizer state.  ``teacher`` and ``opt_t`` are empty
    dicts where the algorithm has no teacher.  Each array keeps its
    dtype (the step counters 0-d int32: one node's slice of JAX's
    per-node counters).  ``global_protos`` ``[C, P]``,
    ``proto_mask`` ``[C]`` and ``round_idx`` as the JAX ``NodeState``
    holds them.  ``residual`` and ``seq`` carry an error-feedback
    ``CodecState``: ``{"protos": [C, P], "student": [R, 512]}`` for a
    plane student (its residual in the plane's layout), or any tree of
    numpy arrays mirroring the payload's float leaves (a per-leaf
    student's ``{"protos", "student": tree}``, the adapter wire's
    ``{"adapters", "protos", "student": rest[, "grams"]}``), fp32, its
    empty subtrees kept.  ``adapter_state`` (``{"ref": {leaf: W}[,
    "grams": {leaf: G}]}``) carries the adapter wire's reference and
    gram statistics, fp32; ``proto_acc`` (``(sums [C, P], counts
    [C])``) the prototype EMA carry.  Runs on ``cuda`` unless ``device``
    names another device."""
    device = resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)

    def f32_tree(tree):
        return tree_map(lambda x: None if x is None else t(x), tree)
    student = params_from_numpy(student, device)
    wire_state = None
    if plane:
        student = plane_from_tree(student)
        shape = tuple(student.buf.shape)
        for key in ("mu", "nu"):
            if key in opt_s and tuple(np.shape(opt_s[key])) != shape:
                raise ValueError(f"opt_s {key} {np.shape(opt_s[key])} does "
                                 f"not match the plane {shape}")
        if "fac" in opt_s and len(opt_s["fac"]) != len(student.meta.recipe):
            raise ValueError(f"opt_s fac has {len(opt_s['fac'])} segments, "
                             f"the plane {len(student.meta.recipe)} leaves")
    if residual is not None:
        res_s = residual.get("student")
        if plane and hasattr(res_s, "shape"):
            if tuple(res_s.shape) != tuple(student.buf.shape):
                raise ValueError(f"student residual {tuple(res_s.shape)} "
                                 f"does not match the plane "
                                 f"{tuple(student.buf.shape)}")
            res = {"protos": t(residual["protos"]),
                   "student": Plane(t(res_s), student.meta)}
        else:
            res = f32_tree(residual)
        wire_state = CodecState(res, t(seq, torch.int32))
    return NodeState(
        student=student,
        teacher=params_from_numpy(teacher, device),
        opt_s=params_from_numpy(opt_s, device),
        opt_t=params_from_numpy(opt_t, device),
        global_protos=t(global_protos), proto_mask=t(proto_mask),
        round_idx=t(round_idx, torch.int32), wire_state=wire_state,
        proto_acc=None if proto_acc is None
        else (t(proto_acc[0]), t(proto_acc[1])),
        adapter_state=None if adapter_state is None
        else f32_tree(adapter_state))


def stack_states(states: List[NodeState]) -> NodeState:
    """Per-node states -> one stacked state.  Parameters (a Plane's
    buffer, or a per-leaf student's leaves) become autograd leaves; every
    other tensor of the optimizer states stacks on a new node axis,
    whatever the optimizer keeps: the 0-d step counters become one
    ``[N]`` counter a node, each keeping its node's value (nodes with
    unequal batch counts step unequally); an empty teacher and
    ``opt_t`` (the baselines without one) stay empty.  An
    error-feedback ``wire_state`` stacks too (its ``seq`` becomes an
    ``[N]`` vector), and so do a ``proto_acc`` and an ``adapter_state``;
    either every state carries one or none does."""
    def stack(*xs):
        return torch.stack(xs)

    def leaf(*xs):
        return torch.stack(xs).detach().requires_grad_(True)

    for key in ("wire_state", "proto_acc", "adapter_state"):
        if len({getattr(s, key) is None for s in states}) != 1:
            raise ValueError(f"some node states carry a {key} and some "
                             f"do not")
    def opt(key):
        s0 = getattr(states[0], key)
        return {k: tree_map(stack, *(getattr(s, key)[k] for s in states))
                for k in s0}

    def stack_res(*xs):
        # a residual tree: a Plane stacks its buffer, None stays None
        if xs[0] is None:
            return None
        if isinstance(xs[0], Plane):
            return Plane(stack(*(x.buf for x in xs)), xs[0].meta)
        return stack(*xs)

    s0 = states[0]
    wire_state = None
    if s0.wire_state is not None:
        ws = [s.wire_state for s in states]
        wire_state = CodecState(
            tree_map(stack_res, *(w.residual for w in ws)),
            stack(*(w.seq for w in ws)))
    if isinstance(s0.student, Plane):
        student = Plane(leaf(*(s.student.buf for s in states)),
                        s0.student.meta)
    else:
        student = tree_map(leaf, *(s.student for s in states))
    return NodeState(
        student=student,
        teacher=tree_map(leaf, *(s.teacher for s in states)),
        opt_s=opt("opt_s"), opt_t=opt("opt_t"),
        global_protos=stack(*(s.global_protos for s in states)),
        proto_mask=stack(*(s.proto_mask for s in states)),
        round_idx=stack(*(s.round_idx for s in states)),
        wire_state=wire_state,
        proto_acc=None if s0.proto_acc is None else tree_map(
            stack, *(s.proto_acc for s in states)),
        adapter_state=None if s0.adapter_state is None else tree_map(
            stack, *(s.adapter_state for s in states)))


def normalize_protos(sums, counts):
    """Eq. 3 class means from raw accumulators: ``sums / max(counts, 1)``."""
    return sums / torch.clamp_min(counts, 1.0)[..., None]


@torch.no_grad()
def compute_local_prototypes(cfg: ModelConfig, params, batches,
                             n_classes: int, *, raw: bool = False):
    """Stream a node's local data once and accumulate Eq. 3: per batch,
    the forward and one ``proto_accumulate_nodes`` on a ``[1, B, P]``
    view (the ``proto_accum`` kernel on the card), the partial sums
    added in batch order.  ``params`` is a parameter tree or a Plane;
    ``batches`` an iterable of dicts of arrays or tensors (moved to the
    parameters' device).  Returns ``(protos [C, P], counts [C])``, or
    with ``raw=True`` the un-normalized ``(sums, counts)``; an empty
    stream gives zeros."""
    if isinstance(params, Plane):
        params = as_tree(params)
    dev = tree_leaves(params)[0].device
    sums = torch.zeros((n_classes, cfg.proto_dim), dtype=torch.float32,
                       device=dev)
    counts = torch.zeros((n_classes,), dtype=torch.float32, device=dev)
    for b in batches:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        f1 = forward(cfg, params, batch).f1
        s_add, c_add = proto_accumulate_nodes(
            f1[None], proto_labels(cfg, batch)[None], n_classes)
        sums = sums + s_add[0]
        counts = counts + c_add[0]
    if raw:
        return sums, counts
    return normalize_protos(sums, counts), counts
