"""Decentralized-federated-learning simulator: the stacked round engine
and the per-node loop engine, for ProFe and the paper baselines (FedAvg,
FedProto, FML, FedGPD).

Runs N nodes over a :class:`~repro_torch.core.topology.TopologySchedule`
for R rounds of E local epochs.  Node state is *stacked* (every tensor
carries a leading ``[N]`` node axis) and one round is:

1. local training: a Python loop over the pre-stacked ``[T, N, B, ...]``
   batches, each step training every node (``core/profe.py``,
   ``core/baselines.py``) and updating a plane student in ONE fused
   sgd, adamw or adafactor sweep (a per-leaf student, the baselines' and
   ``param_plane="off"``'s, through the per-leaf optimizer); a node with
   fewer local batches is padded and masked out of its padded steps
   (``valid``: the sweeps and optimizers skip it, its step counter stays),
2. Eq. 3, where the algorithm shares prototypes, accumulated per class
   by ``kernels/proto_accum``: the exact pass (``proto_pass="exact"``, a
   post-training forward over a second batch stream) or the fused one
   (``"fused"``: each training step's own ``f1``, no second forward);
   with ``proto_ema`` the raw sums and counts carry across rounds in
   ``NodeState.proto_acc``,
3. share: the round's payload (``{protos, student}`` for ProFe) round-
   trips the packed wire codec (``kernels/quantize``) at the
   ``WireSpec``'s widths (uniform, or mixed such as ``4/16``), with the
   error-feedback residual carried in ``NodeState.wire_state`` when the
   spec has ``+ef`` (mirroring the payload: a plane, or a tree of its
   float leaves); a per-leaf student rides the tree codec; on the
   fp32 wire (``quantize_bits=0``, every baseline) the payload passes
   unquantized; on the adapter-rank wire (``FederationConfig.adapter_rank``,
   ``core/adapters.py``) the matrix leaves travel as rank-r factors of
   their round delta instead, ``{adapters, protos, student: rest[,
   grams]}`` through the per-leaf tree codec,
4. mix: size-weighted gossip of the shared model (a node's own copy
   unquantized) and Eq. 4 aggregation per neighbourhood; on the adapter
   wire the received low-rank deltas merge onto every receiver's plane
   in place (``kernels/lowrank_apply``, RegMean with grams) and only the
   dense rest is gossiped.

The sequential driver runs the four in order each round; the pipelined
one (``run_federation(overlap=...)``) drives the same three phase
functions, either in order (``"none"``) or stale-by-one (``"rounds"``:
round t mixes what round t-1 shared, optionally with a floored
self-weight, ``stale_self_floor``).  Communication is metered
analytically from the same schedule (Table II) and the global-test
macro-F1 of node 0 (or, with ``eval_all_nodes``, the mean over nodes)
is recorded per round (Fig. 2).  Where node datasets are too ragged to
stack (a node smaller than one batch) ``run_federation`` falls back to
:func:`run_federation_loop`, the per-node reference engine.  The code
follows ``repro.core.federation``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.config.base import FederationConfig, ModelConfig, TrainConfig
from repro_torch.core import round_ops as R
from repro_torch.core import topology as T
from repro_torch.core import baselines as B
from repro_torch.core.adapters import (adapter_layout,
                                       adapter_payload_template,
                                       init_adapter_state, split_student,
                                       zero_wire_payload)
from repro_torch.core.aggregation import (weighted_plane_mean,
                                          weighted_tree_mean)
from repro_torch.core.comm import (CommMeter, ScheduleCommAccountant,
                                   packed_copy_bytes)
from repro_torch.core.distillation import teacher_active
from repro_torch.core.metrics import accuracy, macro_f1
from repro_torch.core.profe import (NodeState, compute_local_prototypes,
                                    init_node_state, make_profe_step,
                                    node_params, normalize_protos,
                                    proto_labels, resolve_device,
                                    stack_states, zero_proto_acc)
from repro_torch.core.prototypes import aggregate_prototypes
from repro_torch.core.quantization import (quantize_dequantize_tree,
                                           tree_wire_bytes)
from repro_torch.core.wire_state import (ef_quantize_dequantize_plane,
                                         init_codec_state)
from repro_torch.data.loader import batch_index_lists, batches
from repro_torch.kernels.lowrank_apply.ops import (adapter_apply_plane,
                                                   adapter_apply_tree)
from repro_torch.kernels.proto_accum.ops import proto_accumulate_nodes
from repro_torch.kernels.quantize.ops import quantize_dequantize_plane_rows
from repro_torch.models import derive_student, forward, init_params
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim.plane import PLANE_OPTIMIZERS, Plane, as_tree
from repro_torch.tree import (ShapeDtypeStruct, keyed_leaves, rebuild,
                              tree_from_paths, tree_leaves, tree_map)
from repro_torch.wirespec import WireSpec

PROTO_PASSES = ("exact", "fused")
OVERLAPS = (None, "none", "rounds")
PLANE_MODES = ("auto", "on", "off")


@dataclass
class FederationResult:
    f1_per_round: List[float] = field(default_factory=list)
    acc_per_round: List[float] = field(default_factory=list)
    comm: Optional[ScheduleCommAccountant] = None
    elapsed_s: float = 0.0
    algorithm: str = ""
    extras: Dict[str, Any] = field(default_factory=dict)
    # the stacked NodeState after the last round (save it with
    # repro_torch.checkpoint; run_federation(start_round=) resumes it)
    state: Any = None


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                               f"{item}")


def _n_proto_classes(cfg: ModelConfig) -> int:
    return cfg.num_classes if cfg.family in ("cnn", "resnet") \
        else cfg.n_proto_classes


def _first_leaf(params) -> torch.Tensor:
    return params.buf if isinstance(params, Plane) else tree_leaves(params)[0]


def _eval_classes(cfg: ModelConfig) -> int:
    """The macro-F1's classes: a classifier's, or for an LM's next-token
    predictions ``min(vocab_size, 4096)`` (``repro``'s)."""
    return _n_proto_classes(cfg) if cfg.family in ("cnn", "resnet") \
        else int(min(cfg.vocab_size, 4096))


def _eval_truth(cfg: ModelConfig, test_data) -> np.ndarray:
    """The test targets, flattened: labels, or an LM's next tokens."""
    key = "label" if cfg.family in ("cnn", "resnet") else "labels"
    return test_data[key].cpu().numpy().reshape(-1)


@torch.no_grad()
def _eval_params(cfg: ModelConfig, params, test_data, batch_size: int = 256):
    """Global-test ``(macro-F1, accuracy)`` of the classifier head, or
    for an LM of the next-token argmax (every position); ``test_data``
    holds tensors on the model's device."""
    preds = []
    n = len(next(iter(test_data.values())))
    for i in range(0, n, batch_size):
        batch = {k: v[i:i + batch_size] for k, v in test_data.items()}
        preds.append(forward(cfg, params, batch).logits.argmax(-1)
                     .reshape(-1))
    y_pred = torch.cat(preds).cpu().numpy()
    y_true = _eval_truth(cfg, test_data)
    return (macro_f1(y_true, y_pred, _eval_classes(cfg)),
            accuracy(y_true, y_pred))


@torch.no_grad()
def _eval_params_batched(cfg: ModelConfig, stacked_students, test_data,
                         batch_size: int = 256):
    """Every node's global-test ``(macro-F1, accuracy)`` from stacked
    students: per test batch, each node's forward, the ``[N, B]``
    predictions (``[N, B·S]`` for an LM) copied to the host once a batch
    (``repro``'s batched evaluation; equal to :func:`_eval_params` node
    by node)."""
    n_nodes = _first_leaf(stacked_students).shape[0]
    preds = []
    n = len(next(iter(test_data.values())))
    for i in range(0, n, batch_size):
        batch = {k: v[i:i + batch_size] for k, v in test_data.items()}
        preds.append(torch.stack([
            forward(cfg, node_params(stacked_students, j), batch)
            .logits.argmax(-1).reshape(-1) for j in range(n_nodes)])
            .cpu().numpy())
    y_pred = np.concatenate(preds, axis=1)                   # [N, total]
    y_true = _eval_truth(cfg, test_data)
    ncls = _eval_classes(cfg)
    return [(macro_f1(y_true, y_pred[i], ncls), accuracy(y_true, y_pred[i]))
            for i in range(n_nodes)]


def _eval_nodes(eval_cfg, students_of, n_nodes: int, test_data,
                eval_all_nodes: bool, extras: Dict[str, Any],
                *, stacked_students=None):
    """Per-round evaluation, as ``repro``'s: node 0 by default (exact on
    full graphs, where every node ends identical); with
    ``eval_all_nodes`` every node, returning the mean, with the per-node
    curves and their spread in ``extras`` (``f1_per_round_nodes``,
    ``acc_per_round_nodes``, ``f1_std_per_round``).  Given
    ``stacked_students`` the nodes go through
    :func:`_eval_params_batched`, else node by node through
    ``students_of(i)``."""
    if not eval_all_nodes:
        return _eval_params(eval_cfg, students_of(0), test_data)
    if stacked_students is not None:
        per_node = _eval_params_batched(eval_cfg, stacked_students,
                                        test_data)
    else:
        per_node = [_eval_params(eval_cfg, students_of(i), test_data)
                    for i in range(n_nodes)]
    f1s = [p[0] for p in per_node]
    accs = [p[1] for p in per_node]
    extras.setdefault("f1_per_round_nodes", []).append(f1s)
    extras.setdefault("acc_per_round_nodes", []).append(accs)
    extras.setdefault("f1_std_per_round", []).append(float(np.std(f1s)))
    return float(np.mean(f1s)), float(np.mean(accs))


def _algo_wiring(algo: str, teacher_cfg: ModelConfig,
                 student_cfg: ModelConfig, fed: FederationConfig,
                 train: TrainConfig, opt_s, opt_t):
    """Returns ``(step, wire_model, share_protos, wire, model_cfgs)``:
    ``wire_model`` names the model slot that travels (None: no model),
    ``share_protos`` whether prototypes travel, ``wire`` the payload's
    :class:`WireSpec` (None: the fp32 wire) and ``model_cfgs`` the
    (teacher-slot, student-slot) configs."""
    kw = dict(grad_clip=train.grad_clip, remat=train.remat)
    if algo == "profe":
        step = make_profe_step(teacher_cfg, student_cfg, fed, opt_s, opt_t,
                               **kw)
        # adapter-rank wire: the factor (and gram) payload groups get
        # their own widths when configured; bits_for falls back to the
        # student's
        overrides = []
        if fed.adapter_rank and fed.adapter_quantize_bits:
            overrides.append(("adapters", fed.adapter_quantize_bits))
        if fed.adapter_rank and fed.adapter_grams and fed.gram_quantize_bits:
            overrides.append(("grams", fed.gram_quantize_bits))
        wire = WireSpec(student_bits=fed.quantize_bits,
                        proto_bits=fed.proto_quantize_bits,
                        error_feedback=fed.error_feedback,
                        ef_decay=fed.error_feedback_decay,
                        overrides=tuple(overrides)) \
            if fed.quantize_bits else None
        if fed.adapter_rank and wire is None:
            raise ValueError("adapter_rank needs the quantized wire codec "
                             "(set fed.quantize_bits)")
        return step, "student", True, wire, (teacher_cfg, student_cfg)
    # the baselines ride the fp32 wire; the "student" slot holds the
    # model that trains (and, but for FedProto, travels)
    if algo == "fedavg":
        step = B.make_fedavg_step(teacher_cfg, opt_s, **kw)
        return step, "student", False, None, (teacher_cfg, teacher_cfg)
    if algo == "fedproto":
        step = B.make_fedproto_step(teacher_cfg, fed, opt_s, **kw)
        return step, None, True, None, (teacher_cfg, teacher_cfg)
    if algo == "fml":
        step = B.make_fml_step(teacher_cfg, student_cfg, fed, opt_t, opt_s,
                               **kw)
        return step, "student", False, None, (teacher_cfg, student_cfg)
    if algo == "fedgpd":
        step = B.make_fedgpd_step(teacher_cfg, fed, opt_s, **kw)
        return step, "student", True, None, (teacher_cfg, teacher_cfg)
    raise ValueError(f"unknown algorithm {algo!r}")


def _check_slice(fed: FederationConfig, *, overlap,
                 stale_self_floor) -> None:
    """``repro``'s option checks."""
    if overlap not in OVERLAPS:
        raise ValueError(f"overlap must be one of {OVERLAPS}, "
                         f"got {overlap!r}")
    if fed.proto_pass not in PROTO_PASSES:
        raise ValueError(f"proto_pass must be one of {PROTO_PASSES}, "
                         f"got {fed.proto_pass!r}")
    if stale_self_floor is not None and overlap != "rounds":
        raise ValueError("stale_self_floor only applies to the "
                         "stale-by-one pipeline (overlap='rounds'), "
                         f"got overlap={overlap!r}")


def _apply_self_floor(w_self_st, w_neigh_st, floor: float):
    """Floor every node's self-weight in the lowered gossip stacks
    ``[R, N]`` / ``[R, N, N]`` (numpy float32, ``repro``'s operations in
    its order, so the weights are its bit for bit): a node with
    neighbours keeps ``max(w_self, floor)`` and its neighbour weights
    are rescaled by ``(1 - new_self) / sum(w_neigh)``, so rows still sum
    to 1 while the stale mass of ``overlap="rounds"`` stays bounded; an
    isolated node (self-weight 1) passes unchanged."""
    if not 0.0 < floor < 1.0:
        raise ValueError(f"stale_self_floor must be in (0, 1), "
                         f"got {floor!r}")
    w_self = np.asarray(w_self_st, np.float32)          # [R, N]
    w_neigh = np.asarray(w_neigh_st, np.float32)        # [R, N, N]
    neigh_sum = w_neigh.sum(axis=-1)
    has_neigh = neigh_sum > 0
    new_self = np.where(has_neigh, np.maximum(w_self, floor), w_self)
    scale = np.where(has_neigh, (1.0 - new_self)
                     / np.maximum(neigh_sum, 1e-12), 0.0)
    return new_self, w_neigh * scale[..., None]


def _plane_mode(fed: FederationConfig, train: TrainConfig, algo: str,
                student_cfg: ModelConfig) -> bool:
    """Resolve ``fed.param_plane`` as ``repro``'s ``_plane_mode`` does:
    ``"auto"`` puts the student on the flat fp32 plane for the profe
    student under sgd/adamw/adafactor with fp32 parameters, ``"on"``
    raises where those conditions fail, ``"off"`` (and ``"auto"`` where
    they fail) means the per-leaf student."""
    mode = fed.param_plane
    if mode not in PLANE_MODES:
        raise ValueError(f"param_plane must be one of {PLANE_MODES}, "
                         f"got {mode!r}")
    if mode == "off":
        return False
    why = None
    if algo != "profe":
        why = f"algorithm {algo!r} (the plane is wired through the " \
              "profe student)"
    elif train.optimizer not in PLANE_OPTIMIZERS:
        why = f"optimizer {train.optimizer!r} (no fused plane update " \
              "in kernels/opt_update)"
    elif student_cfg.param_dtype != "float32":
        why = "student has non-float32 leaves (the plane buffer is fp32)"
    if why is None:
        return True
    if mode == "on":
        raise ValueError(f"param_plane='on' is unsupported here: {why}")
    return False


def _init_states(algo: str, model_cfgs, fed: FederationConfig, opt_s,
                 opt_t, ncls: int, device, *, plane: bool
                 ) -> List[NodeState]:
    """Fresh per-node states, node i seeded ``fed.seed * 1000 + i`` (the
    JAX package's key derivation; torch draws other numbers).  ProFe and
    FML hold a teacher; the other baselines one per-leaf model in the
    student slot, with an empty teacher and ``opt_t``.  With
    ``fed.proto_ema`` > 0 each carries a zero ``proto_acc``."""
    states = []
    ema = bool(fed.proto_ema and fed.proto_ema > 0)
    for i in range(fed.num_nodes):
        gen = torch.Generator().manual_seed(fed.seed * 1000 + i)
        if algo in ("profe", "fml"):
            states.append(init_node_state(model_cfgs[0], model_cfgs[1], gen,
                                          opt_s, opt_t, ncls, plane=plane,
                                          proto_ema=fed.proto_ema,
                                          device=device))
            continue
        params = tree_map(lambda x: x.to(device),
                          init_params(model_cfgs[0], gen))
        states.append(NodeState(
            student=params, teacher={}, opt_s=opt_s.init(params), opt_t={},
            global_protos=torch.zeros((ncls, model_cfgs[0].proto_dim),
                                      dtype=torch.float32, device=device),
            proto_mask=torch.zeros((ncls,), dtype=torch.float32,
                                   device=device),
            round_idx=torch.zeros((), dtype=torch.int32, device=device),
            proto_acc=zero_proto_acc(ncls, model_cfgs[0].proto_dim, device)
            if ema else None))
    return states


def _payload_template(wire_model, share_protos, stacked: NodeState,
                      ncls: int, proto_dim: int, *, adapter_rank: int = 0,
                      adapter_grams: bool = False) -> Dict[str, Any]:
    """Shape/dtype skeleton of one node's wire payload: the student by
    its LEAF shapes (a plane's never by its padded buffer; a per-leaf
    student's without the node axis), prototypes and counts.  With
    ``adapter_rank`` > 0 the matrix leaves leave ``"model"`` and meter as
    their ``"adapters"`` factors (and ``"grams"``)."""
    payload: Dict[str, Any] = {}
    if wire_model is not None:
        if isinstance(stacked.student, Plane):
            meta = stacked.student.meta
            model = tree_from_paths(
                ((path, ShapeDtypeStruct(shape, np.dtype(np.float32)))
                 for _, path, shape, _row, _r in meta.recipe), meta.empties)
        else:
            model = tree_map(lambda x: ShapeDtypeStruct(
                tuple(x.shape[1:]), x.dtype), stacked.student)
        if adapter_rank:
            layout = adapter_layout(model, adapter_rank)
            payload.update(adapter_payload_template(layout,
                                                    grams=adapter_grams))
            _, model = split_student(layout, model)
        payload["model"] = model
    if share_protos:
        payload["protos"] = ShapeDtypeStruct((ncls, proto_dim),
                                             np.dtype(np.float32))
        payload["counts"] = ShapeDtypeStruct((ncls,), np.dtype(np.float32))
    return payload


def _packed_sent_gb(sched, rounds: int, packed_per_copy: int,
                    n_nodes: int) -> float:
    """Average per-node GB the packed exchange moves over a run."""
    edges = sched.directed_edge_counts()
    copies = sum(int(edges[sched.phase_index(rnd)])
                 for rnd in range(rounds))
    return float(copies * packed_per_copy / max(n_nodes, 1) / 1e9)


def _stack_round_batches(node_data, batch_size: int, seeds, epochs: int
                         ) -> Optional[Tuple[Dict[str, np.ndarray],
                                             np.ndarray]]:
    """Every node's round batches as ``[T, N, B, ...]`` numpy arrays plus
    a ``[T, N]`` validity mask (nodes with fewer batches are padded with
    their first batch, masked out).  None when batch shapes are ragged."""
    per_node = []
    for data, seed in zip(node_data, seeds):
        n = len(next(iter(data.values())))
        per_node.append(batch_index_lists(n, batch_size, seed, epochs=epochs))
    if any(not idxs for idxs in per_node):
        return None
    lens = {idx.shape[0] for idxs in per_node for idx in idxs}
    if len(lens) != 1:
        return None
    n_steps = max(len(idxs) for idxs in per_node)
    valid = np.zeros((n_steps, len(node_data)), np.float32)
    for i, idxs in enumerate(per_node):
        valid[:len(idxs), i] = 1.0
        while len(idxs) < n_steps:
            idxs.append(idxs[0])
    stacked = {
        k: np.stack([np.stack([node_data[i][k][per_node[i][t]]
                               for i in range(len(node_data))])
                     for t in range(n_steps)])
        for k in node_data[0]
    }
    return stacked, valid


def _to_device(staged, device):
    batches, valid = staged
    return ({k: torch.as_tensor(v, device=device) for k, v in
             batches.items()}, torch.as_tensor(valid, device=device))


def _make_proto_pass(proto_cfg: ModelConfig, ncls: int):
    """The exact (post-training) Eq. 3 pass over a stacked ``[T, N, B,
    ...]`` proto batch stream: per batch, every node's student forward
    (a Plane or a per-leaf tree), then ONE ``proto_accumulate_nodes``
    over ``[N, B, P]``."""

    @torch.no_grad()
    def proto_pass(students, pxb, pvalid):
        n_nodes = pvalid.shape[1]
        dev = _first_leaf(students).device
        sums = torch.zeros((n_nodes, ncls, proto_cfg.proto_dim),
                           dtype=torch.float32, device=dev)
        counts = torch.zeros((n_nodes, ncls), dtype=torch.float32,
                             device=dev)
        for t in range(pvalid.shape[0]):
            batch = {k: v[t] for k, v in pxb.items()}
            f1 = torch.stack([
                forward(proto_cfg, node_params(students, i),
                        {k: v[i] for k, v in batch.items()}).f1
                for i in range(n_nodes)])
            s_add, c_add = proto_accumulate_nodes(
                f1, proto_labels(proto_cfg, batch), ncls)
            v = pvalid[t]
            sums = sums + s_add * v[:, None, None]
            counts = counts + c_add * v[:, None]
        return sums, counts

    return proto_pass


def _make_round_parts(step: Callable, proto_cfg: ModelConfig, ncls: int, *,
                      bits, share_protos: bool = True,
                      wire_model: Optional[str] = "student",
                      proto_pass: str = "exact", proto_ema: float = 0.0,
                      adapter_rank: int = 0,
                      adapter_grams: bool = False,
                      shared: Optional[Dict[str, Any]] = None):
    """The three phases of one stacked round:

    * ``train_phase`` — local epochs + Eq. 3 ->
      ``(state, protos, counts)`` (both None where no prototypes
      travel),
    * ``share_phase`` — the wire codec round-trip of the payload ->
      ``(state, recv_student, protos_rx)`` (None for what does not
      travel); with ``+ef`` it carries ``state.wire_state`` (the
      residual and ``seq``) forward,
    * ``mix_phase`` — gossip on the received views + Eq. 4 -> ``state``.

    ``proto_pass="exact"`` streams the proto batches through the trained
    student after the epochs; ``"fused"`` accumulates each training
    step's own ``f1`` (the forward the loss used, before the step's
    update), masked by the step's ``valid``, and ignores ``pxb`` /
    ``pvalid``.  ``proto_ema`` > 0 carries the raw accumulators in
    ``state.proto_acc``: the fused pass starts from ``proto_ema ×`` the
    carry, the exact pass adds it after the pass, and either stores the
    blend back before normalizing.

    ``bits`` is the :class:`WireSpec` that ``_algo_wiring`` returns (an
    int is the uniform spec), so per-group widths and ``+ef`` survive;
    None is the fp32 wire, where the payload travels unquantized.
    ``share_protos`` and ``wire_model`` are ``_algo_wiring``'s.
    With ``adapter_rank`` the share sends the adapter payload (carrying
    ``state.adapter_state`` forward) and ``recv_student`` is its
    receiver-side view ``{"adapters", "student"[, "grams"]}``; the mix
    merges it into the plane in place.  A ``shared`` dict receives each
    share's factors under ``"adapters"`` (the sender side, before the
    codec), so the last round's stay there.
    """
    if proto_pass not in PROTO_PASSES:
        raise ValueError(f"proto_pass must be one of {PROTO_PASSES}, "
                         f"got {proto_pass!r}")
    spec = WireSpec.from_bits(bits) if bits else None
    fused = share_protos and proto_pass == "fused"
    ema = bool(proto_ema and proto_ema > 0)
    exact_pass = _make_proto_pass(proto_cfg, ncls) \
        if share_protos and not fused else None

    def decayed(acc):
        return torch.tensor(proto_ema, dtype=torch.float32,
                            device=acc.device) * acc

    def train_phase(state: NodeState, xb, valid, pxb, pvalid,
                    teacher_on: bool, all_valid: bool = False):
        if fused:
            n_nodes = valid.shape[1]
            if ema:
                sums = decayed(state.proto_acc[0])
                counts = decayed(state.proto_acc[1])
            else:
                sums = torch.zeros((n_nodes, ncls, proto_cfg.proto_dim),
                                   dtype=torch.float32, device=valid.device)
                counts = torch.zeros((n_nodes, ncls), dtype=torch.float32,
                                     device=valid.device)
        for t in range(valid.shape[0]):
            batch = {k: v[t] for k, v in xb.items()}
            # a node with fewer local batches sits out its padded steps
            # (repro's _masked_select); all_valid: every node steps
            active = None if all_valid else valid[t] > 0
            state, metrics = step(state, batch, teacher_on, active)
            if fused:
                s_add, c_add = proto_accumulate_nodes(
                    metrics["f1"], proto_labels(proto_cfg, batch), ncls)
                v = valid[t]
                sums = sums + s_add * v[:, None, None]
                counts = counts + c_add * v[:, None]
        state = state._replace(round_idx=state.round_idx + 1)
        if not share_protos:
            return state, None, None
        if not fused:
            sums, counts = exact_pass(state.student, pxb, pvalid)
            if ema:
                sums = sums + decayed(state.proto_acc[0])
                counts = counts + decayed(state.proto_acc[1])
        if ema:
            state = state._replace(proto_acc=(sums, counts))
        return state, normalize_protos(sums, counts), counts

    @torch.no_grad()
    def share_phase(state: NodeState, protos):
        if spec is None:
            # the fp32 wire: what travels arrives as it was sent
            return state, (state.student if wire_model else None), protos
        if adapter_rank:
            # the matrix leaves' round delta leaves as rank-r factors and
            # the reference advances to the just-shared student
            groups, new_ad, _ = R.adapter_share_nodes(
                state.student, state.adapter_state, rank=adapter_rank,
                grams=adapter_grams)
            if shared is not None:
                shared["adapters"] = groups["adapters"]
            state = state._replace(adapter_state=new_ad)
            payload = dict(groups, protos=protos)
            if spec.error_feedback:
                # the residual mirrors the adapter payload's structure
                recv, new_ws = R.quantize_dequantize_per_node(
                    payload, spec=spec, state=state.wire_state)
                state = state._replace(wire_state=new_ws)
            else:
                recv = R.quantize_dequantize_per_node(payload, spec=spec)
            recv = dict(recv)
            protos_rx = recv.pop("protos")
            return state, recv, protos_rx
        payload = {"protos": protos, "student": state.student}
        if spec.error_feedback:
            recv, new_ws = R.quantize_dequantize_per_node(
                payload, spec=spec, state=state.wire_state)
            state = state._replace(wire_state=new_ws)
        else:
            recv = R.quantize_dequantize_per_node(payload, spec=spec)
        return state, recv["student"], recv["protos"]

    @torch.no_grad()
    def mix_phase(state: NodeState, recv_student, protos_rx, counts,
                  w_self, w_neigh, include) -> NodeState:
        if adapter_rank:
            # a plane merges in place; a per-leaf tree comes back new
            merged = R.adapter_merge_nodes(state.student, recv_student,
                                           w_self, w_neigh,
                                           rank=adapter_rank,
                                           grams=adapter_grams)
            if merged is not state.student:
                _copy_into(state.student, merged)
        elif wire_model is not None:
            # every mixed leaf is computed before any is written back: on
            # the fp32 wire recv_student IS the student
            _copy_into(state.student, R.mix_node_trees(
                w_self, w_neigh, state.student, recv_student))
        if not share_protos:
            return state
        gp, mask = R.neighborhood_prototype_aggregate(include, protos_rx,
                                                      counts)
        return state._replace(global_protos=gp, proto_mask=mask)

    return train_phase, share_phase, mix_phase


def _make_round_fn(step: Callable, proto_cfg: ModelConfig, ncls: int, *,
                   bits, share_protos: bool = True,
                   wire_model: Optional[str] = "student",
                   proto_pass: str = "exact", proto_ema: float = 0.0,
                   adapter_rank: int = 0, adapter_grams: bool = False,
                   shared: Optional[Dict[str, Any]] = None):
    """One full round over stacked node state: train -> Eq. 3 -> share
    -> mix.  The gossip/include matrices are this round's slices of the
    lowered schedule.  The keywords are as in :func:`_make_round_parts`."""
    train_phase, share_phase, mix_phase = _make_round_parts(
        step, proto_cfg, ncls, bits=bits, share_protos=share_protos,
        wire_model=wire_model, proto_pass=proto_pass, proto_ema=proto_ema,
        adapter_rank=adapter_rank, adapter_grams=adapter_grams,
        shared=shared)

    def round_fn(state: NodeState, xb, valid, pxb, pvalid, w_self, w_neigh,
                 include, teacher_on: bool, all_valid: bool = False
                 ) -> NodeState:
        state, protos, counts = train_phase(state, xb, valid, pxb, pvalid,
                                            teacher_on, all_valid)
        state, recv_student, protos_rx = share_phase(state, protos)
        return mix_phase(state, recv_student, protos_rx, counts, w_self,
                         w_neigh, include)

    return round_fn


def _make_phase_fns(step: Callable, proto_cfg: ModelConfig, ncls: int,
                    **kwargs):
    """The pipelined driver's three phases: the very callables
    :func:`_make_round_fn` composes (``repro`` jits each; the port's
    phases launch their kernels eagerly), so splitting the round changes
    the order the driver calls them in, never the math."""
    return _make_round_parts(step, proto_cfg, ncls, **kwargs)


def _held(recv):
    """A copy of what the fp32 wire delivered (the sender's live
    tensors), for the stale-by-one pipeline to mix a round later."""
    if recv is None:
        return None
    if isinstance(recv, Plane):
        return Plane(recv.buf.detach().clone(), recv.meta)
    return tree_map(lambda x: x.detach().clone(), recv)


class _Wiring(NamedTuple):
    """What both engines derive from the configs (:func:`_wiring`)."""
    sched: Any
    ncls: int
    sizes: List[int]
    opt_s: Any
    opt_t: Any
    use_plane: bool
    step: Callable
    wire_model: Any
    share_protos: bool
    bits: Optional[WireSpec]
    model_cfgs: Tuple
    adapters_on: bool
    ef_on: bool
    ema: bool


def _wiring(teacher_cfg: ModelConfig, fed: FederationConfig,
            train: TrainConfig, node_data) -> _Wiring:
    """What both engines derive from the configs, read by name.  On the
    flat parameter plane the student optimizer is the fused clip + update
    sweep over the ``[N, R, 512]`` buffer; off it, the per-leaf optimizer
    the teacher uses (it holds no state of its own).  As in ``repro``, the
    adapter wire runs only for a model and prototypes on the quantized
    wire, ``+ef`` only on a quantized wire."""
    n_nodes = fed.num_nodes
    if len(node_data) != n_nodes:
        raise ValueError(f"{len(node_data)} node datasets for "
                         f"{n_nodes} nodes")
    algo = fed.algorithm
    student_cfg = derive_student(teacher_cfg)
    sched = T.make_schedule(n_nodes, fed.topology, rounds=fed.rounds,
                            seed=fed.seed)
    ncls = _n_proto_classes(teacher_cfg)
    sizes = [len(next(iter(d.values()))) for d in node_data]
    opt_t = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay,
                           momentum=train.momentum)
    use_plane = _plane_mode(fed, train, algo, student_cfg)
    opt_s = make_plane_optimizer(train.optimizer, train.learning_rate,
                                 weight_decay=train.weight_decay,
                                 momentum=train.momentum,
                                 grad_clip=train.grad_clip) \
        if use_plane else opt_t
    step, wire_model, share_protos, bits, model_cfgs = _algo_wiring(
        algo, teacher_cfg, student_cfg, fed, train, opt_s, opt_t)
    adapters_on = bool(fed.adapter_rank) and wire_model is not None \
        and share_protos and bits is not None
    ef_on = bits is not None and bits.error_feedback
    ema = bool(fed.proto_ema and fed.proto_ema > 0)
    return _Wiring(sched=sched, ncls=ncls, sizes=sizes, opt_s=opt_s,
                   opt_t=opt_t, use_plane=use_plane, step=step,
                   wire_model=wire_model, share_protos=share_protos,
                   bits=bits, model_cfgs=model_cfgs, adapters_on=adapters_on,
                   ef_on=ef_on, ema=ema)


def _new_result(meter, algo: str, fed: FederationConfig, use_plane: bool,
                adapters_on: bool, payload, bits, sched) -> FederationResult:
    """A run's result before its first round: the options it resolved
    and the per-copy wire bytes of its payload (logical and packed) with
    the packed bytes a node sends over the run."""
    result = FederationResult(comm=meter, algorithm=algo)
    extras = result.extras
    extras["proto_pass"] = fed.proto_pass
    extras["param_plane"] = use_plane
    if adapters_on:
        extras["adapter_rank"] = fed.adapter_rank
        extras["adapter_grams"] = fed.adapter_grams
    if fed.proto_ema:
        extras["proto_ema"] = fed.proto_ema
    extras["wire_bytes_per_copy"] = tree_wire_bytes(payload, bits)
    extras["wire_bytes_packed_per_copy"] = packed_copy_bytes(payload, bits)
    extras["avg_sent_packed_gb"] = _packed_sent_gb(
        sched, fed.rounds, extras["wire_bytes_packed_per_copy"],
        fed.num_nodes)
    return result


def _with_carries(stacked: NodeState, fed: FederationConfig, bits, device,
                  ncls: int, proto_dim: int, *, use_plane: bool,
                  adapters_on: bool, ef_on: bool, ema: bool) -> NodeState:
    """Check a stacked state against the run and give it the carries the
    run needs and it lacks: the zero prototype EMA carry, the adapter
    wire's reference snapshot (the initial student), the zero
    error-feedback residual."""
    n_nodes = stacked.round_idx.shape[0]
    if isinstance(stacked.student, Plane) != use_plane:
        raise ValueError(f"param_plane resolved to {use_plane}, but the "
                         f"initial states' student is "
                         f"{'not ' if use_plane else ''}a Plane")
    on = _first_leaf(stacked.student).device
    if on.type != device.type:
        raise ValueError(f"initial states live on {on}, not {device}")
    if stacked.wire_state is not None and not ef_on:
        wire = "the fp32 wire" if bits is None else f"the wire {bits.arg()!r}"
        raise ValueError(f"initial states carry a wire_state but {wire} "
                         f"has no error feedback")
    if stacked.adapter_state is not None and not adapters_on:
        raise ValueError("initial states carry an adapter_state but the "
                         "run has no adapter_rank")
    if stacked.proto_acc is not None and not ema:
        raise ValueError("initial states carry a proto_acc but the run "
                         "has no proto_ema")
    if ema and stacked.proto_acc is None:
        stacked = stacked._replace(proto_acc=tuple(
            torch.stack([x] * n_nodes)
            for x in zero_proto_acc(ncls, proto_dim, device)))
    if adapters_on and stacked.adapter_state is None:
        tree = as_tree(stacked.student)
        stacked = stacked._replace(adapter_state=init_adapter_state(
            adapter_layout(tree, fed.adapter_rank, node_axis=True), tree,
            grams=fed.adapter_grams))
    if ef_on and stacked.wire_state is None:
        # the residual mirrors the payload: {protos, student} (a plane,
        # or a per-leaf student's tree), or on the adapter wire factor-
        # shaped zeros, the dense rest (and gram zeros)
        ef_payload = {"protos": torch.zeros((n_nodes, ncls, proto_dim),
                                            dtype=torch.float32,
                                            device=device)}
        if adapters_on:
            tree = as_tree(stacked.student)
            ef_payload.update(zero_wire_payload(
                adapter_layout(tree, fed.adapter_rank, node_axis=True),
                tree, grams=fed.adapter_grams))
        else:
            ef_payload["student"] = stacked.student
        stacked = stacked._replace(wire_state=init_codec_state(
            ef_payload, n_nodes=n_nodes))
    return stacked


def run_federation(teacher_cfg: ModelConfig, fed: FederationConfig,
                   train: TrainConfig, node_data: List[Dict[str, np.ndarray]],
                   test_data: Dict[str, np.ndarray],
                   *, verbose: bool = False,
                   eval_all_nodes: bool = False,
                   overlap: Optional[str] = None,
                   stale_self_floor: Optional[float] = None,
                   initial_states=None, start_round: int = 0,
                   device=None) -> FederationResult:
    """Run one algorithm (``fed.algorithm``: ProFe or a paper baseline)
    end to end on the stacked engine.  Nodes may hold unequal numbers of
    batches (``partition(..., "noniid40")``, ``"dirichlet"``): each round
    runs as many steps as the largest node has, the others masked out of
    their padded steps.  Where a node holds fewer samples than one batch
    the run falls back to :func:`run_federation_loop`, as ``repro``'s
    does (``overlap`` and ``stale_self_floor`` are ignored there).

    Runs on ``cuda`` unless ``device`` names another device (the tests
    pass ``"cpu"``); with no card and no explicit device it raises.
    ``initial_states`` (per-node states, e.g. carried from the JAX
    package by ``core.profe.node_state_from_numpy``) replaces the seeded
    initialization, so both packages can start from the same weights.
    It may also be one stacked state (``result.state`` of a run, or a
    checkpoint of one), which the run then updates in place; with
    ``start_round`` = k the run resumes at round k, staging, scheduling
    and metering rounds k.. ``fed.rounds`` - 1 exactly as an
    uninterrupted run does (not with ``overlap="rounds"``, whose pending
    payload no state holds).  ``result.state`` is the stacked state after
    the last round.
    With error feedback (``fed.error_feedback``) every node starts from
    a zero residual unless its initial state carries one, and
    ``extras["wire_state"]`` holds the stacked ``CodecState`` after the
    last round.  On the adapter-rank wire every node takes its initial
    student as the first reference unless its initial state carries an
    ``adapter_state``, and ``extras["adapter_factors"]`` holds the last
    round's shared factors ``{leaf: {"A", "B"}}`` (stacked over nodes).

    ``fed.proto_pass`` selects Eq. 3: ``"exact"`` (the post-training
    pass over its own batch stream) or ``"fused"`` (each training step's
    ``f1``; no proto stream is staged).  ``fed.proto_ema`` > 0 carries
    the raw accumulators across rounds (``NodeState.proto_acc``, zero
    unless the initial states carry one).  ``eval_all_nodes`` evaluates
    every node's student each round and reports the mean (the per-node
    values in ``extras``), as ``repro``'s ``_eval_nodes``.

    ``overlap`` selects the round pipeline, as in ``repro``:

    * ``None`` — the sequential driver: each round stages its batches,
      then trains, shares and mixes;
    * ``"none"`` — the three phases in the same order, with round
      ``t + 1``'s batches staged on the host before round ``t`` is
      evaluated (while the card runs what was launched); bit-identical to
      the sequential driver;
    * ``"rounds"`` — stale-by-one: round ``t`` mixes the payload shared
      at round ``t - 1`` into its trained state, then shares its own
      (round 0 skips the mix; R rounds apply R - 1 mixes, and the last
      payload is metered but never consumed).  ``stale_self_floor``
      floors every node's self-weight (:func:`_apply_self_floor`).
    """
    device = resolve_device(device)
    _check_slice(fed, overlap=overlap, stale_self_floor=stale_self_floor)
    if not 0 <= start_round < fed.rounds:
        raise ValueError(f"start_round {start_round} is outside the run's "
                         f"{fed.rounds} rounds")
    if start_round and overlap == "rounds":
        raise ValueError("overlap='rounds' cannot resume: the payload "
                         "shared a round before is in no state")
    algo = fed.algorithm
    n_nodes = fed.num_nodes
    w = _wiring(teacher_cfg, fed, train, node_data)
    sched, ncls, sizes, step = w.sched, w.ncls, w.sizes, w.step
    opt_s, opt_t, use_plane = w.opt_s, w.opt_t, w.use_plane
    wire_model, share_protos, bits = w.wire_model, w.share_protos, w.bits
    model_cfgs, adapters_on, ef_on, ema = (w.model_cfgs, w.adapters_on,
                                           w.ef_on, w.ema)

    probe = _stack_round_batches(
        node_data, train.batch_size,
        [fed.seed + 0 * 997 + i for i in range(n_nodes)], fed.local_epochs)
    if probe is None:
        # ragged node datasets (some node smaller than one batch): the
        # per-node reference engine, always sequential, as repro does
        return run_federation_loop(
            teacher_cfg, fed, train, node_data, test_data, verbose=verbose,
            eval_all_nodes=eval_all_nodes, initial_states=initial_states,
            start_round=start_round, device=device)

    meter = ScheduleCommAccountant(sched)
    if initial_states is None:
        initial_states = _init_states(algo, model_cfgs, fed, opt_s, opt_t,
                                      ncls, device, plane=use_plane)
    if isinstance(initial_states, NodeState):
        stacked = initial_states
        given = stacked.round_idx.shape[0]
    else:
        stacked, given = None, len(initial_states)
    if given != n_nodes:
        raise ValueError(f"{given} initial states for {n_nodes} nodes")
    if stacked is None:
        stacked = stack_states(initial_states)
    # the per-node states were copied into the stack: drop this frame's
    # hold on them (at full width they are a second copy of the model)
    del initial_states
    # the model evaluated (and the Eq. 3 pass's) is the one that travels
    eval_cfg = proto_cfg = model_cfgs[1] if algo in ("profe", "fml") \
        else model_cfgs[0]
    stacked = _with_carries(stacked, fed, bits, device, ncls,
                            proto_cfg.proto_dim, use_plane=use_plane,
                            adapters_on=adapters_on, ef_on=ef_on, ema=ema)

    def dev(x):
        return torch.as_tensor(x, device=device)
    w_self_np, w_neigh_np, include_np = sched.lower(sizes)
    if stale_self_floor is not None:
        w_self_np, w_neigh_np = _apply_self_floor(w_self_np, w_neigh_np,
                                                  stale_self_floor)
    w_self_st, w_neigh_st, include_st = map(
        dev, (w_self_np, w_neigh_np, include_np))
    shared: Dict[str, Any] = {}
    rank = fed.adapter_rank if adapters_on else 0
    parts_kw = dict(bits=bits, share_protos=share_protos,
                    wire_model=wire_model, proto_pass=fed.proto_pass,
                    proto_ema=fed.proto_ema, adapter_rank=rank,
                    adapter_grams=fed.adapter_grams, shared=shared)
    payload = _payload_template(wire_model, share_protos, stacked, ncls,
                                proto_cfg.proto_dim, adapter_rank=rank,
                                adapter_grams=fed.adapter_grams)
    test_dev = {k: dev(v) for k, v in test_data.items()}

    result = _new_result(meter, algo, fed, use_plane, adapters_on, payload,
                         bits, sched)
    if stale_self_floor is not None:
        result.extras["stale_self_floor"] = stale_self_floor
    round_times: List[float] = []
    result.extras["round_times_s"] = round_times
    t0 = time.time()

    # fused mode stages no proto stream, nor does an algorithm whose
    # prototypes do not travel: the empty placeholder repro stages
    stream_protos = share_protos and fed.proto_pass != "fused"
    empty = ({}, np.zeros((0, n_nodes), np.float32))

    def stage(rnd: int):
        """Round ``rnd``'s training batches and proto stream (numpy)."""
        staged = probe if rnd == 0 else _stack_round_batches(
            node_data, train.batch_size,
            [fed.seed + rnd * 997 + i for i in range(n_nodes)],
            fed.local_epochs)
        proto_staged = _stack_round_batches(
            node_data, train.batch_size, [fed.seed + rnd] * n_nodes, 1) \
            if stream_protos else empty
        return staged, proto_staged

    if overlap is None:
        round_fn = _make_round_fn(step, proto_cfg, ncls, **parts_kw)
    else:
        train_phase, share_phase, mix_phase = _make_phase_fns(
            step, proto_cfg, ncls, **parts_kw)
    staged_next = stage(start_round)
    recv_prev = None
    for rnd in range(start_round, fed.rounds):
        t_r = time.time()
        t_on = teacher_active(fed.alpha_s, fed.alpha_limit, rnd) \
            if algo == "profe" else algo == "fml"
        # the sequential driver stages each round as it starts; the
        # pipelined one staged it while the card ran the round before
        staged, proto_staged = staged_next if overlap is not None \
            or rnd == start_round else stage(rnd)
        all_valid = bool(np.all(staged[1] == 1.0))
        xb, valid = _to_device(staged, device)
        pxb, pvalid = _to_device(proto_staged, device)
        p = sched.phase_index(rnd)
        weights = (w_self_st[p], w_neigh_st[p], include_st[p])
        if overlap is None:
            stacked = round_fn(stacked, xb, valid, pxb, pvalid, *weights,
                               teacher_on=t_on, all_valid=all_valid)
        else:
            stacked, protos, counts = train_phase(
                stacked, xb, valid, pxb, pvalid, t_on, all_valid)
            if overlap == "rounds":
                # stale-by-one: mix what round t-1 shared into this
                # round's trained state, then share this round's payload
                if recv_prev is not None:
                    stacked = mix_phase(stacked, *recv_prev, *weights)
                stacked, recv_student, protos_rx = share_phase(stacked,
                                                               protos)
                if bits is None:
                    recv_student = _held(recv_student)
                recv_prev = (recv_student, protos_rx, counts)
            else:
                stacked, recv_student, protos_rx = share_phase(stacked,
                                                               protos)
                stacked = mix_phase(stacked, recv_student, protos_rx,
                                    counts, *weights)
        if overlap is not None and rnd + 1 < fed.rounds:
            # round t+1's batches, staged on the host while the card runs
            # what round t launched
            staged_next = stage(rnd + 1)
        meter.record_round(payload, kind=algo, round_idx=rnd, bits=bits)

        f1, acc = _eval_nodes(
            eval_cfg, lambda i: node_params(stacked.student, i), n_nodes,
            test_dev, eval_all_nodes, result.extras,
            stacked_students=stacked.student)
        result.f1_per_round.append(f1)
        result.acc_per_round.append(acc)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        round_times.append(time.time() - t_r)
        if verbose:
            tag = algo if overlap is None else f"{algo}/overlap={overlap}"
            print(f"[{tag}] round {rnd + 1}/{fed.rounds} "
                  f"f1={f1:.4f} acc={acc:.4f} "
                  f"sent={meter.avg_sent_gb():.4f}GB")

    result.elapsed_s = time.time() - t0
    result.state = stacked
    if ef_on:
        # the error-feedback state after the last round (residual, seq)
        result.extras["wire_state"] = stacked.wire_state
    if adapters_on and "adapters" in shared:
        result.extras["adapter_factors"] = shared["adapters"]
    result.extras["avg_sent_gb"] = meter.avg_sent_gb()
    result.extras["avg_received_gb"] = meter.avg_received_gb()
    return result


# ---------------------------------------------------------------------------
# the per-node reference engine
# ---------------------------------------------------------------------------

def _split_nodes(stacked: NodeState) -> List[NodeState]:
    """A stacked state as one one-node stack (``[1, ...]`` leaves) a
    node: copies, parameters autograd leaves again."""
    leaves = [x for _, x in keyed_leaves(stacked)]
    return [rebuild(stacked, iter(
        x[i:i + 1].detach().clone().requires_grad_(x.requires_grad)
        for x in leaves)) for i in range(stacked.round_idx.shape[0])]


def _join_nodes(states: List[NodeState]) -> NodeState:
    """One-node stacks joined into one stacked state (copies)."""
    per_node = [[x for _, x in keyed_leaves(st)] for st in states]
    return rebuild(states[0], iter(
        torch.cat([x.detach() for x in xs]).requires_grad_(
            xs[0].requires_grad) for xs in zip(*per_node)))


def _copy_into(model, new) -> None:
    """Write the mixed ``new`` (a Plane or a tree) into ``model``'s own
    tensors, which stay the autograd leaves the next step trains."""
    if isinstance(model, Plane):
        model.buf.copy_(new.buf)
        return
    for own, x in zip(tree_leaves(model), tree_leaves(new)):
        own.copy_(x)


def run_federation_loop(teacher_cfg: ModelConfig, fed: FederationConfig,
                        train: TrainConfig,
                        node_data: List[Dict[str, np.ndarray]],
                        test_data: Dict[str, np.ndarray],
                        *, verbose: bool = False,
                        eval_all_nodes: bool = False, initial_states=None,
                        start_round: int = 0,
                        device=None) -> FederationResult:
    """The per-node round engine, ``repro``'s ``run_federation_loop``:
    the reference semantics of a round, node by node, and the engine
    ``run_federation`` falls back to where node datasets are too ragged
    to stack (a node smaller than one batch).

    Each node's state is a one-node stack (``[1, ...]`` leaves, ``[1]``
    step counters), so the stacked step makers and plane sweeps serve it
    unchanged.  A round: every node trains on its own minibatches
    (``data.batches``, seed ``fed.seed + rnd·997 + i``), with Eq. 3 fused
    into the steps (``proto_pass="fused"``) or after them over its own
    stream (seed ``fed.seed + rnd``, ``compute_local_prototypes``); the
    adapter wire factorizes each node's round delta; each node's payload
    is metered per edge (``CommMeter.record_broadcast``) and
    round-tripped on its own: the plane through
    ``quantize_dequantize_plane_rows`` (``+ef``:
    ``wire_state.ef_quantize_dequantize_plane``), a per-leaf student,
    the prototypes and the adapter groups through the per-tensor codec;
    prototypes aggregate per neighbourhood (Eq. 4), models mix by
    dataset size (``weighted_plane_mean`` / ``weighted_tree_mean``, a
    node's own copy unquantized), and on the adapter wire every receiver
    merges its neighbours' low-rank deltas in place, one
    ``lowrank_apply`` a matrix leaf a receiver.

    Runs on ``cuda`` unless ``device`` names another device.
    ``initial_states`` (per-node states, or one stacked state) replaces
    the seeded initialization, ``start_round`` resumes at that round,
    and ``result.state`` is the stacked state after the last round, as
    in ``run_federation``."""
    device = resolve_device(device)
    _check_slice(fed, overlap=None, stale_self_floor=None)
    if not 0 <= start_round < fed.rounds:
        raise ValueError(f"start_round {start_round} is outside the run's "
                         f"{fed.rounds} rounds")
    algo = fed.algorithm
    n_nodes = fed.num_nodes
    fused = fed.proto_pass == "fused"
    w = _wiring(teacher_cfg, fed, train, node_data)
    sched, ncls, sizes, step = w.sched, w.ncls, w.sizes, w.step
    opt_s, opt_t, use_plane = w.opt_s, w.opt_t, w.use_plane
    wire_model, share_protos, bits = w.wire_model, w.share_protos, w.bits
    model_cfgs, adapters_on, ef_on, ema = (w.model_cfgs, w.adapters_on,
                                           w.ef_on, w.ema)
    ef_on = ef_on and wire_model is not None and share_protos
    meter = CommMeter(n_nodes)
    if initial_states is None:
        initial_states = _init_states(algo, model_cfgs, fed, opt_s, opt_t,
                                      ncls, device, plane=use_plane)
    if isinstance(initial_states, NodeState):
        states = _split_nodes(initial_states)
    else:
        states = [stack_states([s]) for s in initial_states]
    if len(states) != n_nodes:
        raise ValueError(f"{len(states)} initial states for {n_nodes} nodes")
    eval_cfg = proto_cfg = model_cfgs[1] if algo in ("profe", "fml") \
        else model_cfgs[0]
    states = [_with_carries(st, fed, bits, device, ncls, proto_cfg.proto_dim,
                            use_plane=use_plane, adapters_on=adapters_on,
                            ef_on=ef_on, ema=ema) for st in states]
    rank = fed.adapter_rank if adapters_on else 0
    payload_t = _payload_template(wire_model, share_protos, states[0], ncls,
                                  proto_cfg.proto_dim, adapter_rank=rank,
                                  adapter_grams=fed.adapter_grams)
    layout = adapter_layout(as_tree(states[0].student), rank,
                            node_axis=True) if adapters_on else None
    test_dev = {k: torch.as_tensor(v, device=device)
                for k, v in test_data.items()}

    result = _new_result(meter, algo, fed, use_plane, adapters_on,
                         payload_t, bits, sched)
    round_times: List[float] = []
    result.extras["round_times_s"] = round_times
    t0 = time.time()

    def decayed(acc):
        return torch.tensor(fed.proto_ema, dtype=torch.float32,
                            device=acc.device) * acc

    def unstack(tree):
        return tree_map(lambda x: x[0], tree)

    shared = None
    for rnd in range(start_round, fed.rounds):
        t_r = time.time()
        adj = sched.adjacency_at(rnd)
        t_on = teacher_active(fed.alpha_s, fed.alpha_limit, rnd) \
            if algo == "profe" else algo == "fml"
        # 1) local training (the fused pass streams each step's f1 into
        #    the Eq. 3 accumulators)
        protos, counts = [], []
        for i in range(n_nodes):
            st = states[i]
            if fused and share_protos:
                if ema:
                    sums_i, counts_i = map(decayed, st.proto_acc)
                else:
                    sums_i, counts_i = (x[None] for x in zero_proto_acc(
                        ncls, proto_cfg.proto_dim, device))
            for batch in batches(node_data[i], train.batch_size,
                                 seed=fed.seed + rnd * 997 + i,
                                 epochs=fed.local_epochs, device=device):
                st, m = step(st, {k: v[None] for k, v in batch.items()},
                             t_on)
                if fused and share_protos:
                    s_add, c_add = proto_accumulate_nodes(
                        m["f1"], proto_labels(proto_cfg, batch)[None], ncls)
                    sums_i = sums_i + s_add
                    counts_i = counts_i + c_add
            st = st._replace(round_idx=torch.full(
                (1,), rnd + 1, dtype=torch.int32, device=device))
            if fused and share_protos:
                if ema:
                    st = st._replace(proto_acc=(sums_i, counts_i))
                protos.append(normalize_protos(sums_i, counts_i))
                counts.append(counts_i)
            states[i] = st

        # 2) Eq. 3 after training, over each node's own proto stream
        if share_protos and not fused:
            for i in range(n_nodes):
                sums_i, ct = compute_local_prototypes(
                    proto_cfg, node_params(states[i].student, 0),
                    batches(node_data[i], train.batch_size,
                            seed=fed.seed + rnd, device=device), ncls,
                    raw=True)
                sums_i, ct = sums_i[None], ct[None]
                if ema:
                    sums_i = sums_i + decayed(states[i].proto_acc[0])
                    ct = ct + decayed(states[i].proto_acc[1])
                    states[i] = states[i]._replace(proto_acc=(sums_i, ct))
                protos.append(normalize_protos(sums_i, ct))
                counts.append(ct)

        with torch.no_grad():
            # 3) share: the adapter wire's factors (the reference
            #    advances to the just-shared student), then every node's
            #    payload metered per edge and round-tripped on its own
            adapter_pay = []
            if adapters_on:
                for i in range(n_nodes):
                    groups, new_ad, _ = R.adapter_share_nodes(
                        states[i].student, states[i].adapter_state,
                        rank=rank, grams=fed.adapter_grams)
                    states[i] = states[i]._replace(adapter_state=new_ad)
                    adapter_pay.append(groups)
                shared = {n: {k: torch.cat([g["adapters"][n][k]
                                            for g in adapter_pay])
                              for k in ("A", "B")}
                          for n in layout.mat_names}
            ef_recv = []
            if ef_on:
                # every node's payload through the error-feedback codec
                # once a round: the plane's row sweeps, or the tree codec
                # on a tree payload (a per-leaf student, or the adapter
                # groups; a one-node stack scales each leaf whole, as
                # repro's per-leaf reference), its residual mirroring the
                # payload
                for i in range(n_nodes):
                    if adapters_on:
                        pay_i = dict(adapter_pay[i], protos=protos[i])
                    else:
                        pay_i = {"protos": protos[i],
                                 "student": states[i].student}
                    if use_plane and not adapters_on:
                        recv_i, new_ws = ef_quantize_dequantize_plane(
                            pay_i, bits, states[i].wire_state)
                    else:
                        recv_i, new_ws = R.quantize_dequantize_per_node(
                            pay_i, spec=bits, state=states[i].wire_state)
                    states[i] = states[i]._replace(wire_state=new_ws)
                    ef_recv.append(recv_i)
            recv_models = [[] for _ in range(n_nodes)]
            recv_sizes = [[] for _ in range(n_nodes)]
            recv_pay = []
            for i in range(n_nodes):
                neigh = T.neighbors(adj, i)
                payload = {}
                if adapters_on:
                    payload["adapters"] = unstack(adapter_pay[i]["adapters"])
                    payload["model"] = unstack(adapter_pay[i]["student"])
                    if fed.adapter_grams:
                        payload["grams"] = unstack(adapter_pay[i]["grams"])
                elif wire_model is not None:
                    payload["model"] = node_params(states[i].student, 0)
                if share_protos:
                    payload["protos"] = protos[i][0]
                    payload["counts"] = counts[i][0]
                meter.record_broadcast(i, neigh, payload, kind=algo,
                                       round_idx=rnd, bits=bits)
                if adapters_on:
                    recv_pay.append(
                        {k: v for k, v in ef_recv[i].items()
                         if k != "protos"} if ef_on else
                        {k: quantize_dequantize_tree(v, bits.bits_for(k))
                         for k, v in adapter_pay[i].items()})
                elif wire_model is not None:
                    if ef_on:
                        model_rx = ef_recv[i]["student"]
                    elif bits is None:
                        model_rx = states[i].student
                    elif use_plane:
                        model_rx = quantize_dequantize_plane_rows(
                            states[i].student, bits.bits_for("student"))
                    else:
                        model_rx = quantize_dequantize_tree(
                            states[i].student, bits.bits_for("student"))
                    for j in neigh:
                        recv_models[j].append(model_rx)
                        recv_sizes[j].append(sizes[i])

            # 4) Eq. 4 per neighbourhood, then the mix
            if share_protos:
                protos_rx = [r["protos"] for r in ef_recv] if ef_on else [
                    quantize_dequantize_tree(p, bits.bits_for("protos"))
                    if bits is not None else p for p in protos]
                all_p = torch.cat(protos_rx)
                all_c = torch.cat(counts)
                for i in range(n_nodes):
                    idx = torch.as_tensor(T.neighbors(adj, i) + [i],
                                          device=device)
                    gp, mask = aggregate_prototypes(all_p[idx], all_c[idx])
                    states[i] = states[i]._replace(global_protos=gp[None],
                                                   proto_mask=mask[None])
            if adapters_on:
                _adapter_merge_loop(states, recv_pay, layout, adj, sizes,
                                    grams=fed.adapter_grams, device=device)
            elif wire_model is not None:
                # every node's mix is computed before any is written
                # back: on the fp32 wire the received models ARE the
                # senders' students
                mixed = [None if not recv_models[i] else
                         (weighted_plane_mean if use_plane
                          else weighted_tree_mean)(
                             [states[i].student] + recv_models[i],
                             [sizes[i]] + recv_sizes[i])
                         for i in range(n_nodes)]
                for st, new in zip(states, mixed):
                    if new is not None:
                        _copy_into(st.student, new)

        # 5) evaluation
        f1, acc = _eval_nodes(eval_cfg,
                              lambda i: node_params(states[i].student, 0),
                              n_nodes, test_dev, eval_all_nodes,
                              result.extras)
        result.f1_per_round.append(f1)
        result.acc_per_round.append(acc)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        round_times.append(time.time() - t_r)
        if verbose:
            print(f"[{algo}/loop] round {rnd + 1}/{fed.rounds} "
                  f"f1={f1:.4f} acc={acc:.4f} "
                  f"sent={meter.avg_sent_gb():.4f}GB")

    result.elapsed_s = time.time() - t0
    result.state = _join_nodes(states)
    if ef_on:
        result.extras["wire_state"] = result.state.wire_state
    if shared is not None:
        result.extras["adapter_factors"] = shared
    result.extras["avg_sent_gb"] = meter.avg_sent_gb()
    result.extras["avg_received_gb"] = meter.avg_received_gb()
    return result


def _adapter_merge_loop(states: List[NodeState], recv_pay, layout, adj,
                        sizes, *, grams: bool, device) -> None:
    """The loop engine's adapter merge, ``repro``'s: every receiver with
    neighbours adds its neighbours' dequantized low-rank deltas onto its
    own current student IN PLACE (no self term: its own training delta
    is already in W), ``W_i += Σ_j c_ij·B_j @ Ã_j`` with ``c_ij =
    size_j / (size_i + Σ_neigh size)`` over all senders' factor banks
    (zero coefficient off the neighbourhood), RegMean-adjusted per
    receiver with grams: one ``lowrank_apply`` a matrix leaf a receiver.
    The dense rest takes the size-weighted mean, own copy unquantized."""
    from repro_torch.core.aggregation import regmean_adjust
    n_nodes = len(states)
    bank = {n: {k: torch.cat([p["adapters"][n][k] for p in recv_pay])
                for k in ("A", "B")} for n in layout.mat_names}
    g_bank = {n: torch.cat([p["grams"][n] for p in recv_pay])
              for n in layout.mat_names} if grams else None
    coeffs_np = np.zeros((n_nodes, n_nodes), np.float32)
    for i in range(n_nodes):
        neigh = T.neighbors(adj, i)
        tot = sizes[i] + sum(sizes[j] for j in neigh)
        for j in neigh:
            coeffs_np[i, j] = sizes[j] / tot
    coeffs = torch.as_tensor(coeffs_np, device=device)
    for i in range(n_nodes):
        neigh = T.neighbors(adj, i)
        if not neigh:
            continue
        _, rest_i = split_student(layout, as_tree(states[i].student))
        rest_mix = weighted_tree_mean(
            [rest_i] + [recv_pay[j]["student"] for j in neigh],
            [sizes[i]] + [sizes[j] for j in neigh])
        factors = {}
        for n in layout.mat_names:
            a_use = bank[n]["A"]
            if grams:
                a_use = regmean_adjust(a_use, g_bank[n], coeffs[i][None],
                                       per_recv=False)[0]
            factors[n] = {"A": a_use, "B": bank[n]["B"]}
        student = states[i].student
        if isinstance(student, Plane):
            adapter_apply_plane(student, layout, coeffs[i:i + 1], factors,
                                rest_mix)
        else:
            _copy_into(student, adapter_apply_tree(
                student, layout, coeffs[i:i + 1], factors, rest_mix))
