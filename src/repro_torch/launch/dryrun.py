"""The compile report and the wire audit.

**The compile report** (``--shape``): one node's program for an
(arch, input shape), traced on the ``meta`` device (nothing runs, as the
JAX package's mode lowers without running) and priced at the H100's
published peaks (:mod:`repro_torch.launch.roofline`)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k [--mesh pod1|pod2] [--microbatches M] \\
        [--cards-per-node D [--layout auto|tp|fsdp] [--no-fsdp] \\
        [--node-mesh DxM]] [--no-federate] [--json PATH]

prints the program's FLOPs (by dtype), bytes and collective bytes per
card, the peak memory it needs, the compute, memory and collective terms
and which one dominates, ``6ND`` against the counted FLOPs and whether
it fits the card.  The counts come from
:mod:`repro_torch.launch.op_analysis` (an op-level trace of the torch
program in place of XLA's HLO): each combo is traced at small trip
counts (periods of the stacks, causal self-attention blocks,
microbatches), fitted exactly and checked against one more trace.

A node is one card by default (``layout: "one card"``, no collective).
With ``--cards-per-node D`` (2, 4 or 8: one HGX board over NVLink) the
node's program is one rank's of D under an in-node layout, the JAX
package's ``lower_combo`` placements (:class:`NodeLayout`): the state,
batch and caches are DTensors placed by ``repro_torch.sharding``'s specs
on a ``data × model`` mesh (:mod:`repro_torch.launch.mesh`, default
``2 × D/2`` under ``tp``, ``D × 1`` under ``fsdp``) over a fake process
group of D ranks, this process rank 0;
DTensor's sharding propagation partitions the program as XLA's SPMD
partitioner does JAX's, and the count reads rank 0's shards and the
collectives of its redistributions, priced at NVLink.  ``--layout auto``
(the default) picks ``fsdp`` for a small arch's training step and ``tp``
otherwise (:func:`resolve_layout`).  ``--layout``, ``--no-fsdp`` and
``--node-mesh`` without ``--cards-per-node`` > 1 are refused (exit 2).

``pod1`` is one node; ``pod2`` is two nodes: its per-card numbers are
one node's (one rank's under a layout), and on ``train_4k`` it adds
``federate``, ProFe's 16-bit gossip bytes (packed, and the per-leaf
``gather``) against FedAvg's fp32 teacher round, at full width, from
``launch/wire``'s predictions.  Runs on the CPU; no card is needed.

**The wire audit** (``--topology``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mnist-cnn \\
        --topology ring --pods 4x2 [--bits 4/16] [--ef] [--adapters 8] \\
        [--adapter-grams] [--adapter-frac F] [--json PATH] [--device cpu]

runs one round of each exchange (the per-leaf ``gather``, the packed
all-gather, the ``ppermute`` permute steps, and the full-graph
all-gather reference) on ``R·C`` spawned gloo ranks — R federation
nodes of C ranks each (``--pods RxC``) — at the architecture's student
shapes, and asserts the bytes each node hands to its collectives against
``ScheduleCommAccountant``'s prediction: within 10 %, below half the
full-graph gather on a sparse regular graph (2·degree ≤ R), and with
C > 1 (the row-sharded permute) or ``--adapters`` the pod permute bytes
equal to the prediction exactly.  Sub-int16 specs are also held to the
int16 round's code-buffer bytes by the spec's ratio, ``+ef`` to its
stateless twin's bytes (zero overhead), ``--adapters`` to below
``--adapter-frac`` of the dense round.  It runs on the card unless
``--device cpu`` is given (and raises with no card).

Both print the report as JSON and exit 0 only when it is ``ok``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import traceback
from typing import Any, Dict, Optional

MESHES = {"pod1": 1, "pod2": 2}     # nodes, one card each
# causal self-attention is traced at its own blocks up to this many
# blocks a side; beyond, its blocks are a fitted trip count
J_DIRECT = 4
J_CANDIDATES = (1, 2, 4)      # query blocks a side in the fit's traces
REP_CANDIDATES = (2, 3, 4, 5)  # train samples 2-4


def resolve_layout(cfg, shape, layout: str = "auto") -> str:
    """``layout="auto"`` as the JAX package's ``lower_combo`` resolves it:
    ``fsdp`` (pure FSDP, the batch over every card) for a training step of
    an arch under 1e10 parameters with a vocabulary of at most 100k (at
    one row a card the ``[1, S, V]`` loss temporaries replicate), else
    ``tp`` (FSDP over data × TP over model; a decode step stays TP:
    per-token weight gathers would cost its latency)."""
    from repro_torch.launch.roofline import approx_params
    if layout != "auto":
        return layout
    return "fsdp" if (shape.kind == "train" and approx_params(cfg) < 1e10
                      and cfg.vocab_size <= 100_000) else "tp"


def resolve_microbatches(cfg, shape, microbatches: int = 0,
                         layout: str = "auto") -> int:
    """The train program's microbatches as the JAX package's
    ``lower_combo`` resolves them: the whole batch in one microbatch under
    ``fsdp``, else 16, unless ``microbatches`` is given."""
    if shape.kind != "train":
        return 1
    if microbatches:
        return microbatches
    return 1 if resolve_layout(cfg, shape, layout) == "fsdp" else 16


@dataclasses.dataclass(frozen=True)
class NodeLayout:
    """One node of ``cards`` cards on a ``data × model`` mesh under a
    layout, the JAX package's ``lower_combo`` placements:

    * ``fsdp`` — a training step's weights and moments over ``("data",
      "model")`` (no tensor parallelism), the batch over every card;
    * ``tp`` — weights over data (FSDP; ``fsdp=False`` leaves their data
      dim replicated) and model (TP), the batch over data, the activation
      constraints of :func:`repro_torch.sharding.shard_act` on the model
      axis.

    A prefill or decode step takes the default parameter specs (data and
    model) under either, its batch and caches over data; its activations
    take the layout's constraints, as in the JAX package."""
    name: str
    cards: int
    data: int
    model: int
    fsdp: bool = True

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def act_dp(self) -> tuple:
        """The activations' batch axes."""
        return ("data", "model") if self.name == "fsdp" else ("data",)

    def batch_dp(self, kind: str) -> tuple:
        return self.act_dp if kind == "train" else ("data",)

    def weight_axes(self, kind: str) -> Dict[str, Any]:
        if kind != "train":
            return {}
        if self.name == "fsdp":
            return {"data_axis": ("data", "model"), "model_axis": None}
        return {"data_axis": "data" if self.fsdp else None,
                "model_axis": "model"}

    @contextlib.contextmanager
    def active(self, mesh):
        """The activation constraints on ``mesh`` and DTensor's implicit
        replication of plain tensors (masks, positions) for the block."""
        import logging

        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.sharding import (clear_activation_sharding,
                                          set_activation_sharding)
        # DTensor warns at every two-step redistribution of a dim over
        # both axes; the count records them
        log = logging.getLogger("torch.distributed.tensor._redistribute")
        level = log.level
        log.setLevel(logging.ERROR)
        set_activation_sharding(
            mesh, dp_axes=self.act_dp,
            model_axis=None if self.name == "fsdp" else "model")
        try:
            with implicit_replication():
                yield
        finally:
            clear_activation_sharding()
            log.setLevel(level)

    def place_state(self, state, teacher_cfg, student_cfg, optimizer, mesh):
        """A :class:`NodeState` of tensors as DTensors under the layout
        (prototypes, mask and round replicated)."""
        from repro_torch.sharding import (distribute, opt_state_specs,
                                          param_specs)
        ax = self.weight_axes("train")
        ms = self.mesh_shape
        sps = param_specs(student_cfg, state.student, ms, **ax)
        tps = param_specs(teacher_cfg, state.teacher, ms, **ax)
        rep = lambda t: distribute(t, (None,) * t.dim(), mesh)  # noqa: E731
        return state._replace(
            student=distribute(state.student, sps, mesh),
            teacher=distribute(state.teacher, tps, mesh),
            opt_s=distribute(state.opt_s, opt_state_specs(
                optimizer, sps, state.student), mesh),
            opt_t=distribute(state.opt_t, opt_state_specs(
                optimizer, tps, state.teacher), mesh),
            global_protos=rep(state.global_protos),
            proto_mask=rep(state.proto_mask),
            round_idx=rep(state.round_idx))

    def place_batch(self, batch, kind: str, mesh):
        from repro_torch.sharding import batch_specs, distribute
        return distribute(batch, batch_specs(batch, self.mesh_shape,
                                             dp_axes=self.batch_dp(kind)),
                          mesh)

    def place_params(self, cfg, params, mesh):
        from repro_torch.sharding import distribute, param_specs
        return distribute(params, param_specs(cfg, params, self.mesh_shape),
                          mesh)

    def place_cache(self, cache, mesh):
        from repro_torch.sharding import cache_specs, distribute
        return distribute(cache, cache_specs(cache, self.mesh_shape), mesh)


def node_layout(cfg, shape, cards: int, layout: str = "auto",
                fsdp: bool = True, node_mesh=None) -> NodeLayout:
    """The :class:`NodeLayout` of a combo on a node of ``cards`` cards:
    ``node_mesh`` (``(data, model)`` or ``"DxM"``) or the layout's
    default (``launch.mesh.default_node_shape``)."""
    from repro_torch.launch.mesh import default_node_shape, parse_node_mesh
    layout = resolve_layout(cfg, shape, layout)
    if node_mesh is None:
        data, model = default_node_shape(cards, layout)
    elif isinstance(node_mesh, str):
        data, model = parse_node_mesh(node_mesh, cards)
    else:
        data, model = node_mesh
        parse_node_mesh(f"{data}x{model}", cards)
    return NodeLayout(layout, cards, data, model, fsdp)


def _cut(cfg, reps: int, encoder: Optional[int] = None):
    """``cfg`` with ``reps`` periods of its stack (its remainder kept) and,
    for the audio family, ``encoder`` encoder layers."""
    from repro_torch.models.transformer import block_sequence, split_periods
    period, _, rem = split_periods(block_sequence(cfg))
    kw = {"num_layers": len(period) * reps + len(rem)}
    if encoder is not None:
        kw["encoder_layers"] = encoder
    out = cfg.replace(**kw)
    if split_periods(block_sequence(out)) != (period, reps, rem):
        raise ValueError(f"{cfg.name}: {reps} periods do not keep the "
                         f"block pattern")
    return out


def _reps(cfg) -> int:
    from repro_torch.models.transformer import block_sequence, split_periods
    return split_periods(block_sequence(cfg))[1]


def _causal_blocks(cfg, shape) -> Optional[int]:
    """Causal self-attention's blocks a side at ``shape`` (None where the
    program has none: decode, an attention-free stack)."""
    from repro_torch.models.transformer import block_sequence
    if shape.kind == "decode" or not (
            {"attn", "lattn", "cross"} & set(block_sequence(cfg))):
        return None
    if cfg.q_block != cfg.kv_block:
        raise ValueError(f"{cfg.name}: q_block {cfg.q_block} != kv_block "
                         f"{cfg.kv_block}")
    return -(-shape.seq_len // cfg.q_block)


def _stack(point: Dict[str, int], var: str, real: int,
           offset: int = 0) -> int:
    """A stack's periods in a trace: the point's (plus the stack's
    ``offset``), where the program has two or more (one period is its own
    regime and stays as it is)."""
    return point[var] + offset if real >= REP_CANDIDATES[0] else real


def traced_microbatches(m: int) -> int:
    """The microbatches a trace runs: two of the program's where it has
    more than one (every microbatch runs the same ops, and a count scales
    one microbatch's work by the real number: ``op_analysis.microbatch``),
    else its one."""
    return min(m, 2)


def _program(cfg, student_cfg, shape, fed, train, point: Dict[str, int],
             layout: Optional[NodeLayout] = None, mesh=None,
             offsets: Optional[Dict[str, int]] = None):
    """``(fn, args, arg_parts)`` of the combo's program at the trip counts
    ``point`` (``X`` the stacks' periods, ``E`` whisper's encoder
    layers, ``j`` the decoder's attention blocks: ``q_block`` and
    ``kv_block`` of S / j, so causal self-attention runs j blocks a side
    and cross-attention j query blocks against the memory's own) on
    ``meta``; a training step runs :func:`traced_microbatches`.  The
    costs are exact polynomials in ``j``, the results those of any
    blocking.  Under ``layout`` the arguments are DTensors on ``mesh``,
    one rank's shards.  ``offsets`` adds to the student's stacks (a
    layout's fit, :func:`count_plan`)."""
    import torch

    from repro_torch.config.base import ShapeConfig
    from repro_torch.launch import programs as PR
    from repro_torch.launch.op_analysis import MICRO
    from repro_torch.models import init_params
    audio = cfg.family == "audio"

    def cut(c, off=None):
        off = off or {}
        c = _cut(c, _stack(point, "X", _reps(c), off.get("X", 0)),
                 _stack(point, "E", c.encoder_layers, off.get("E", 0))
                 if audio and "E" in point else None)
        if "j" in point:
            block = shape.seq_len // point["j"]
            c = c.replace(q_block=block, kv_block=block)
        return c
    if shape.kind == "train":
        t, s = cut(cfg), cut(student_cfg, offsets)
        m = traced_microbatches(train.microbatches)
        tr = dataclasses.replace(train, microbatches=m)
        step, _ = PR.make_profe_train_fn(t, s, fed, tr)
        state = PR.node_state_struct(t, s, tr, cfg.n_proto_classes)
        per = shape.global_batch // train.microbatches
        batch = PR.batch_struct(cfg, ShapeConfig(
            shape.name, shape.seq_len, per * m, "train"))
        if layout is not None:
            state = layout.place_state(state, t, s, tr.optimizer, mesh)
            batch = layout.place_batch(batch, "train", mesh)
        return step, (state, batch), {
            "teacher": (state.teacher, state.opt_t),
            "student": (state.student, state.opt_s),
            MICRO: batch}
    c = cut(cfg)
    params = init_params(c, torch.Generator().manual_seed(0),
                         device="meta")
    if layout is not None:
        params = layout.place_params(c, params, mesh)
    if shape.kind == "prefill":
        fn = PR.make_prefill_fn(c)
        batch = PR.batch_struct(c, shape)
        if layout is not None:
            batch = layout.place_batch(batch, shape.kind, mesh)
        return torch.no_grad()(fn), (params, batch), {}
    d = PR.decode_struct(c, shape)
    if layout is not None:
        d = dict(d, cache=layout.place_cache(d["cache"], mesh),
                 **layout.place_batch({k: d[k] for k in ("token", "memory")
                                       if k in d}, shape.kind, mesh))
    fn = PR.make_serve_fn(c, shape)
    # the last position of a full cache
    index = PR.decode_cache_len(c, shape) - 1
    args = (params, d["token"], index, d["cache"])
    if "memory" in d:
        args += (d["memory"],)
    return torch.no_grad()(fn), args, {}


def count_plan(cfg, student_cfg, shape, modulus: int = 1):
    """The trip-count fit of a combo: ``(candidates, monomials,
    peak_monomials, real, part_vars, offsets)``.  Variables: ``X`` (the periods
    of every stack: the model's, or in training the teacher's and the
    student's together, told apart by part), ``E`` (whisper's encoder
    layers, likewise) and ``j`` (attention's query blocks, where the
    program's causal self-attention has more than :data:`J_DIRECT` a
    side).  Counts are linear in ``X`` and ``E`` (quadratic in training,
    where every period's slice of a stacked parameter gets a dense
    gradient of the whole stack) and quadratic in ``j``; every stack is
    traced at two periods or more (one period is its own regime).  Peaks
    are fitted linear in each count, and in ``1/j`` and ``1/j²`` (the
    attention's temporaries scale with its blocks).

    Under an in-node layout (``modulus`` its cards) a training step's
    whole-stack ops (the gradients' accumulation, the clip, the
    optimizer) see the stacked period dim, which DTensor may shard where
    a mesh axis divides it: their collectives are polynomial only among
    period counts alike modulo the cards.  The teacher's stacks are then
    traced at ``r, r + M, r + 2M, …`` (r its real count modulo M, at
    least 2), the student's at the same plus ``offsets`` (its real count
    less the teacher's, modulo M), and the student is evaluated at its
    real count less its offset."""
    audio = cfg.family == "audio"
    j_real = _causal_blocks(cfg, shape)
    fit_j = j_real is not None and j_real > J_DIRECT
    if fit_j and shape.seq_len % max(J_CANDIDATES):
        raise ValueError(f"sequence {shape.seq_len} is not a multiple of "
                         f"{max(J_CANDIDATES)}")
    train = shape.kind == "train"
    models = {"teacher": cfg, "student": student_cfg} if train \
        else {"": cfg}
    enc = audio and shape.kind != "decode"
    real = {p: dict(X=_reps(c), **({"E": c.encoder_layers} if enc else {}))
            for p, c in models.items()}
    fixed = any(v < REP_CANDIDATES[0] for r in real.values()
                for v in r.values())
    variables = ["X"] + (["E"] if enc else [])
    cand: Dict[str, tuple] = {v: REP_CANDIDATES for v in variables}
    offsets: Dict[str, int] = {}
    if train and modulus > 1:
        for v in variables:
            r = real["teacher"][v] % modulus
            while r < REP_CANDIDATES[0]:
                r += modulus
            cand[v] = tuple(r + k * modulus for k in range(4))
            if real["student"][v] >= REP_CANDIDATES[0]:
                offsets[v] = (real["student"][v] - real["teacher"][v]) \
                    % modulus
                real["student"][v] -= offsets[v]
    monos = [{}]
    for v in variables:
        monos += [{v: 1}] + ([{v: 2}] if train else [])
    peak = [{}] + [{v: 1} for v in variables]
    if fit_j:
        cand["j"] = J_CANDIDATES
        monos += [{"X": 1, "j": d} for d in (1, 2)]
        if fixed or offsets:
            # a stack that no variable moves, or one offset from X,
            # runs attention blocks off X's multiples
            monos += [{"j": d} for d in (1, 2)]
        peak += [{"j": -1}, {"j": -2}]
        for r in real.values():
            r["j"] = j_real
    if train:
        real[""] = dict(real["teacher"])
    part_vars = {"": ("j",)} if train else None
    return cand, monos, peak, real, part_vars, offsets


def count_combo(cfg, student_cfg, shape, fed, train,
                layout: Optional[NodeLayout] = None, mesh=None):
    """One node's counts of the combo at its real trip counts, by the
    exact fit of :func:`count_plan` (:func:`op_analysis.fit_counts`);
    under ``layout`` (on ``mesh``, a node mesh of
    :func:`launch.mesh.make_node_mesh`) one rank's."""
    from fractions import Fraction

    from repro_torch.launch.op_analysis import (MICRO, PARTS, count_ops,
                                                design, fit_counts)
    cand, monos, peak, real, part_vars, offsets = count_plan(
        cfg, student_cfg, shape, layout.cards if layout is not None else 1)

    def cost(p):
        return (p["X"] + p.get("E", 0)) * (1 + 0.05 * p.get("j", 1) ** 2)

    # the held-out trace takes the periods beyond the samples where the
    # counts are linear in them (cheap) or nothing else varies; in
    # training with attention blocks fitted, the samples span three
    # period counts and the held-out point checks the cross terms (under
    # a layout beyond the samples' periods too: DTensor's plan is checked
    # where the fit extrapolates)
    samples, held = design(cand, monos, cost, beyond=(
        () if shape.kind == "train" and "j" in cand and layout is None
        else ("X", "E")))

    def trace(point):
        fn, args, parts = _program(cfg, student_cfg, shape, fed, train,
                                   point, layout, mesh, offsets)
        with (layout.active(mesh) if layout is not None
              else contextlib.nullcontext()):
            c = count_ops(fn, *args, arg_parts=parts)
        if shape.kind == "train" and not set(PARTS) <= {
                p.replace(MICRO, "") for p in c.parts}:
            raise ValueError(f"the train program's spans {PARTS} were not "
                             f"seen by the count (parts {sorted(c.parts)})")
        return c
    m = train.microbatches if shape.kind == "train" else 1
    return fit_counts(trace, monos, samples, held, real,
                      peak_monomials=peak, part_vars=part_vars,
                      microbatches=Fraction(m, traced_microbatches(m)))


@functools.lru_cache(maxsize=None)
def _counted(arch: str, shape_name: str, microbatches: int,
             layout: Optional[NodeLayout] = None):
    """:func:`count_combo` of one node's program (under ``layout``, one
    rank's, traced on a fake process group of its cards), once a
    process: the meshes share it (``pod2``'s per-device numbers are one
    node's)."""
    from repro_torch.config import (FederationConfig, TrainConfig,
                                    get_config, get_shape)
    from repro_torch.launch.mesh import fake_group, make_node_mesh
    from repro_torch.models import derive_student
    cfg = get_config(arch)
    train = TrainConfig(optimizer=cfg.optimizer, remat=True,
                        microbatches=microbatches)
    args = (cfg, derive_student(cfg), get_shape(shape_name),
            FederationConfig(), train)
    if layout is None:
        return count_combo(*args)
    with fake_group(layout.cards):
        mesh = make_node_mesh(layout.cards, layout.data, layout.model)
        return count_combo(*args, layout=layout, mesh=mesh)


def fedavg_round_bytes(teacher_struct, n_nodes: int) -> int:
    """The bytes a node hands gloo in FedAvg's round on a full graph of
    ``n_nodes`` as ``make_fedavg_round`` runs it (``exchange="auto"``
    without an adjacency: one all-gather of the packed fp32 teacher):
    its packed fp32 copy to each neighbour."""
    from repro_torch.core.comm import packed_copy_bytes
    return (n_nodes - 1) * int(packed_copy_bytes({"model": teacher_struct},
                                                 None))


def federate_report(arch: str, n_nodes: int = 2) -> Dict[str, Any]:
    """``pod2``'s gossip round at full width, per node on a full graph of
    ``n_nodes``: ProFe's packed 16-bit exchange and its per-leaf
    ``gather`` (``launch/wire.exchange_predictions``), FedAvg's fp32
    teacher round (:func:`fedavg_round_bytes`), and
    ``wire_reduction_vs_fedavg``."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.launch.wire import exchange_predictions
    from repro_torch.models import init_params
    from repro_torch.tree import ShapeDtypeStruct, tree_map
    pred = exchange_predictions(arch, n_nodes, "full", bits=16, full=True)
    teacher = init_params(get_config(arch), torch.Generator().manual_seed(0),
                          device="meta")
    fedavg = fedavg_round_bytes(tree_map(
        lambda x: ShapeDtypeStruct(tuple(x.shape), x.dtype), teacher),
        n_nodes)

    def entry(total):
        return {"total": total, "by_kind": {"all-gather": total}}
    out = {"nodes": n_nodes, "topology": "full",
           "profe_collective_bytes": entry(pred["packed_pred_bytes_per_node"]),
           "profe_collective_bytes_gather": entry(
               pred["logical_bytes_per_node"]),
           "fedavg_collective_bytes": entry(fedavg)}
    pb = out["profe_collective_bytes"]["total"]
    out["wire_reduction_vs_fedavg"] = 1.0 - pb / fedavg if fedavg else None
    return out


def lower_combo(arch: str, shape_name: str, mesh_kind: str = "pod1", *,
                include_federate: bool = True, microbatches: int = 0,
                smi: Optional[str] = None, cards_per_node: int = 1,
                layout: Optional[str] = None, fsdp: bool = True,
                node_mesh=None) -> Dict[str, Any]:
    """The compile report of one (arch, shape, mesh) (module docstring).
    With ``cards_per_node`` 1 a node is one card (``layout: "one
    card"``); with D of 2, 4 or 8 the node's program is one rank's of a
    D-card node under ``layout`` (``auto``, ``tp`` or ``fsdp``: default
    ``auto``, :func:`resolve_layout`) on ``node_mesh`` (``"DxM"``;
    default ``launch.mesh.default_node_shape``), ``fsdp=False`` leaving a ``tp``
    training step's weights replicated over data.  The microbatches by
    :func:`resolve_microbatches`.  ``smi`` is the card's ``nvidia-smi``
    name and power limit to carry (read here where a card is present)."""
    import time

    from repro_torch.config import get_config, get_shape
    from repro_torch.launch.roofline import card, roofline_report
    if mesh_kind not in MESHES:
        raise ValueError(f"mesh must be one of {sorted(MESHES)}")
    if cards_per_node == 1 and (layout is not None or not fsdp
                                or node_mesh is not None):
        raise ValueError("a layout needs cards_per_node of 2, 4 or 8")
    t0 = time.time()
    cfg, shape = get_config(arch), get_shape(shape_name)
    lay = None if cards_per_node == 1 else node_layout(
        cfg, shape, cards_per_node, layout or "auto", fsdp, node_mesh)
    m = resolve_microbatches(cfg, shape, microbatches,
                             lay.name if lay else "auto")
    fit = _counted(arch, shape_name, m, lay)
    chips = MESHES[mesh_kind] * cards_per_node
    report: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_devices": chips, "cards_per_node": cards_per_node,
        "layout": lay.name if lay else "one card",
        "microbatches": m}
    if lay is not None:
        report["node_mesh"] = {"data": lay.data, "model": lay.model}
        report["fsdp"] = lay.fsdp
    report.update(roofline_report(cfg, shape, fit.count, chips=chips,
                                  smi=smi if smi is not None else card()))
    report["trip_count_fit"] = fit.as_dict()
    report["by_op"] = {k: v for k, v in sorted(
        fit.count.by_op.items(), key=lambda kv: -kv[1].get("bytes", 0))}
    if mesh_kind == "pod2" and include_federate and shape.kind == "train":
        report["federate"] = federate_report(arch, MESHES[mesh_kind])
    report["count_wall_s"] = time.time() - t0
    return report


def topology_report(arch: str, topology: str, pods, bits="16",
                    ef: bool = False, adapters: int = 0,
                    adapter_grams: bool = False,
                    adapter_frac: Optional[float] = None,
                    device=None) -> Dict[str, Any]:
    """The ``--topology`` audit: the exchanges' bytes on ``pods`` (``"R"``
    or ``"RxC"``) with the gates of the module docstring; raises
    ``AssertionError`` at the first that fails.  The spec's report and
    the references its gates need (the stateless twin of an ``+ef`` spec,
    the dense wire of an adapter rank, the int16 wire of a narrower spec)
    are measured on one spawn of ranks
    (:func:`launch.wire.measure_exchange_rows`)."""
    from repro_torch.core import topology as T
    from repro_torch.launch.wire import (check_adapter_reduction,
                                         check_bits_reduction,
                                         check_ef_zero_overhead,
                                         check_topology_bytes,
                                         measure_exchange_rows, parse_pods)
    from repro_torch.wirespec import WireSpec, resolve_spec
    pods, inner = parse_pods(pods)
    if adapters and inner > 1:
        raise ValueError("--adapters does not support multi-axis pods "
                         "('RxC') — the adapter wire has no row-sharded "
                         "permute lowering; use --pods R")
    spec = WireSpec.parse(bits) if isinstance(bits, str) \
        else resolve_spec(bits)
    if ef and not spec.error_feedback:
        spec = dataclasses.replace(spec, error_feedback=True)
    adj = T.make_schedule(pods, topology, rounds=1, seed=0).adjacency_at(0)
    deg = int(adj.sum(axis=1).max())
    regular = T.is_regular(adj)
    wire = dict(adapter_rank=adapters, adapter_grams=adapter_grams)
    rows = {"spec": dict(bits=spec, **wire)}
    # error feedback must be wire-free on every graph; ppermute is
    # checked too where the graph is regular
    ef_exs = ("packed", "ppermute") if regular else ("packed",)
    if spec.error_feedback:
        rows["stateless"] = dict(bits=spec.stateless(), exchanges=ef_exs,
                                 **wire)
    if regular and adapters:
        rows["dense"] = dict(bits=spec.stateless(), exchanges=("ppermute",))
    if regular and spec.stateless() != WireSpec.from_bits(16):
        rows["int16"] = dict(bits=16, exchanges=("ppermute",), **wire)
    reports = dict(zip(rows, measure_exchange_rows(
        arch, pods, topology, rows=list(rows.values()), inner=inner,
        device=device)))
    report = reports["spec"]
    if spec.error_feedback:
        report_sl = reports["stateless"]
        report["stateless_reference"] = {
            "bits": report_sl["bits"], "exchanges": report_sl["exchanges"]}
        for ex in ef_exs:
            check_ef_zero_overhead(report, report_sl, exchange=ex)
    if regular:
        # a regular graph takes ppermute and must pass the byte gate
        # (a recorded error fails it); a sparse one must also beat the
        # full gather by the margin its degree implies.  On the adapter
        # wire there is no full gather and the gate is exact
        frac = None if adapters else (0.5 if 2 * deg <= pods else None)
        check_topology_bytes(report, exchange="ppermute", rel_tol=0.10,
                             gather_frac=frac,
                             exact=bool(adapters) or inner > 1)
        if adapters:
            report_dense = reports["dense"]
            report["dense_reference"] = {
                "bits": report_dense["bits"],
                "packed_pred_bytes_per_node":
                    report_dense["packed_pred_bytes_per_node"],
                "exchanges": report_dense["exchanges"]}
            # the gram group rides at full [*, k, k] a leaf: unless the
            # caller pins a fraction, gram mode's ratio is recorded only
            check_adapter_reduction(
                report, report_dense, exchange="ppermute",
                frac=(adapter_frac if adapter_frac is not None
                      else (None if adapter_grams else 0.15)))
        if "int16" in reports:
            report16 = reports["int16"]
            report["int16_reference"] = {
                "packed_pred_bytes_per_node":
                    report16["packed_pred_bytes_per_node"],
                "exchanges": report16["exchanges"]}
            check_bits_reduction(report, report16, exchange="ppermute")
    return report


def _refused(args) -> Optional[str]:
    """Why the compile report's layout flags are refused, or None."""
    from repro_torch.launch.mesh import NODE_CARDS, parse_node_mesh
    cards = args.cards_per_node
    if cards == 1:
        if args.layout is not None or args.no_fsdp or args.node_mesh:
            return ("--layout, --no-fsdp and --node-mesh shard a node over "
                    "several cards: give --cards-per-node 2, 4 or 8")
        return None
    if cards not in NODE_CARDS:
        return (f"--cards-per-node {cards}: a node is 1 card or one NVLink "
                f"board of {', '.join(map(str, NODE_CARDS))}")
    if args.layout not in (None, "auto", "tp", "fsdp"):
        return f"--layout {args.layout}: auto, tp or fsdp"
    if args.node_mesh is not None:
        try:
            parse_node_mesh(args.node_mesh, cards)
        except ValueError as e:
            return str(e)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="compile report (--shape) or wire audit (--topology)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="train_4k | prefill_32k | decode_32k | long_500k: "
                         "the compile report")
    ap.add_argument("--mesh", default="pod1", choices=sorted(MESHES),
                    help="pod1: one node on one card; pod2: two nodes, "
                         "one card each (adds federate on train_4k)")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--no-federate", action="store_true")
    ap.add_argument("--cards-per-node", type=int, default=1,
                    help="cards of one node: 1 (the node on one card) or "
                         "2, 4, 8 (one rank's program under --layout)")
    ap.add_argument("--layout", default=None,
                    help="auto | tp | fsdp (with --cards-per-node > 1; "
                         "default auto)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="tp: leave the weights' data dim replicated (with "
                         "--cards-per-node > 1)")
    ap.add_argument("--node-mesh", default=None, metavar="DxM",
                    help="the node's data x model mesh (with "
                         "--cards-per-node > 1; default under tp 2 x D/2, "
                         "1 x 2 at D = 2; under fsdp D x 1)")
    ap.add_argument("--json", default=None, help="write report JSON here")
    ap.add_argument("--topology", default=None,
                    help="gossip graph spec: one round of each exchange, "
                         "its collective bytes held to the accountant's")
    ap.add_argument("--pods", default="8",
                    help="'R' or 'RxC': R nodes x C ranks a node (C > 1: "
                         "the row-sharded permute, gated exactly)")
    ap.add_argument("--bits", default="16",
                    help="wire spec: 16 | 8 | 4 or <student>/<protos> "
                         "(e.g. 4/16); +ef (or --ef) for error feedback")
    ap.add_argument("--ef", action="store_true",
                    help="error-feedback codec, held to its stateless "
                         "twin's bytes")
    ap.add_argument("--adapters", type=int, default=0, metavar="RANK",
                    help="adapter-rank wire: rank-r delta factors, gated "
                         "exactly and below --adapter-frac x the dense "
                         "exchange")
    ap.add_argument("--adapter-grams", action="store_true",
                    help="ship RegMean gram statistics (with --adapters)")
    ap.add_argument("--adapter-frac", type=float, default=None,
                    help="required adapter-vs-dense byte fraction "
                         "(default 0.15; recorded only with "
                         "--adapter-grams unless set)")
    ap.add_argument("--device", default=None,
                    help="--topology: 'cpu' to run off the card "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    refused = _refused(args)
    if refused:
        print(f"repro_torch.launch.dryrun: {refused}", file=sys.stderr)
        return 2
    if args.topology is None:
        if args.shape is None:
            print("repro_torch.launch.dryrun: --shape or --topology is "
                  "required", file=sys.stderr)
            return 2
        try:
            report = lower_combo(args.arch, args.shape, args.mesh,
                                 include_federate=not args.no_federate,
                                 microbatches=args.microbatches,
                                 cards_per_node=args.cards_per_node,
                                 layout=args.layout, fsdp=not args.no_fsdp,
                                 node_mesh=args.node_mesh)
            report["status"] = "ok"
        except Exception as e:      # the report carries the failure
            report = {"arch": args.arch, "shape": args.shape,
                      "mesh": args.mesh, "status": "error",
                      "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()}
    else:
        from repro_torch.core.profe import resolve_device
        device = resolve_device(args.device)        # no card: raises
        try:
            report = topology_report(args.arch, args.topology, args.pods,
                                     bits=args.bits, ef=args.ef,
                                     adapters=args.adapters,
                                     adapter_grams=args.adapter_grams,
                                     adapter_frac=args.adapter_frac,
                                     device=str(device))
            report["status"] = "ok"
        except Exception as e:          # the report carries the failed gate
            report = {"arch": args.arch, "topology": args.topology,
                      "status": "error", "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()}
    print(json.dumps(report, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, default=str)
    return 0 if report["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
