"""Microbenchmark on the PyTorch port: one full federation round, the
seed's per-node Python loop against the stacked round
(``repro_torch/core/federation.py``'s round engine).  The port of
``benchmarks/round_step.py``, with its modes, flags, defaults and report
keys.

The seed trained N nodes in nested Python loops: a step call per batch
per node, an Eq. 3 pass per node and per-node gossip.  The stacked
round trains every node in one step a batch (``[N, B, ...]`` batches, one
plane sweep for all nodes), runs one Eq. 3 pass over ``[N, B, P]`` and
mixes every node at once (``core/round_ops.py``).  JAX's seed also
re-traced a jitted Eq. 3 closure every round and node; the port runs
eagerly and has no jit, so its seed loop is the per-node Python loop
without the re-trace.  The stacked round's time keeps the JAX key
``jitted_ms`` so that one reader reads both packages' reports; here it
names the stacked round's milliseconds.

    PYTHONPATH=src python -m benchmarks.torch_round_step --nodes 2 4 8

Round 0 is the warm-up (cuDNN's search, the allocator); then ``--rounds``
timed rounds, each read on the host clock after
``torch.cuda.synchronize()``, and their median.

**Per-phase breakdown** (``--phases``): the stacked round's train /
Eq. 3 (the exact pass, and the fused pass's marginal: fused train time
minus train time, clamped at 0) / codec (the wire round trip) / mix
(gossip and Eq. 4) phases from ``F._make_round_parts`` and
``F._make_proto_pass``, exact and fused whole rounds, and four A/B
pairs, each pair's two sides interleaved (:func:`_paired_ms`):

* update: the per-leaf clip and ``make_optimizer``'s update against the
  fused plane sweep (``make_plane_optimizer``, the ``adamw_update``
  kernel);
* grad: autograd through ``optim/plane.as_tree`` views of the plane
  (every gradient lands in one ``[N, R, 512]`` buffer) against autograd
  through per-leaf copies whose gradients are rebuilt into planes by
  ``plane_from_tree``: the port's counterparts of JAX's custom-vjp plane
  and its slice-transpose repack;
* mix: ``round_ops.mix_node_trees`` over the leaf views plus the
  ``plane_from_tree`` rebuild against ``w_self·buf + tensordot(w_neigh,
  buf)`` on the plane;
* apply: ``kernels/lowrank_apply/ops.adapter_apply_tree`` plus the plane
  rebuild against ``adapter_apply_plane`` (the ``lowrank_apply`` kernel
  on the plane's spans, in place).

The port's phases update the state in place (the sweeps, the mix), so a
timed repetition continues from the one before: the same shapes and the
same work, not the same values.

    PYTHONPATH=src python -m benchmarks.torch_round_step --nodes 2 4 8 \\
        --phases

**Wire-exchange microbench** (``--wire``): the per-leaf reference codec
against the packed codec (``round_ops.quantize_dequantize_per_node``,
``packed=False`` / ``True``; a ``+ef`` spec carries its ``CodecState``),
and the mesh round's exchanges (``gather``, ``packed``, ``ppermute``)
on gloo ranks, each with its bytes as ``launch/wire.py`` counts them and
its ``round_ms`` (the median round, a round as long as its slowest
rank).  All rows of a pod shape run on ONE spawn of ranks
(``launch/wire.measure_exchange_rows``); the ranks are spawned, so JAX's
re-exec with forced host devices has no counterpart.

    PYTHONPATH=src python -m benchmarks.torch_round_step --wire

Reports go to ``--out`` (``BENCH_torch_round_step.json``, with
``--wire`` ``BENCH_torch_wire_exchange.json``); the JAX package's
``BENCH_round_step.json`` and ``BENCH_wire_exchange.json`` are refused.
Runs on the card unless ``--device cpu`` is given (and raises with no
card).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.core import federation as F
from repro_torch.core import round_ops as R
from repro_torch.core import topology as T
from repro_torch.core.aggregation import weighted_tree_mean
from repro_torch.core.profe import (compute_local_prototypes, node_params,
                                    normalize_protos, resolve_device,
                                    stack_states)
from repro_torch.core.prototypes import aggregate_prototypes
from repro_torch.core.quantization import quantize_dequantize_tree
from repro_torch.data import batches, make_image_dataset, partition
from repro_torch.models import derive_student
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               make_plane_optimizer)
from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.wirespec import WireSpec, resolve_bits

JAX_REPORTS = ("BENCH_round_step.json", "BENCH_wire_exchange.json")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> str | None:
    """The card's ``nvidia-smi`` name and power limit (None off it)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.splitlines()[0].strip()


def _setup(n_nodes: int, samples_per_node: int, batch_size: int,
           channels=(8, 16)):
    # a reduced CNN keeps the round dispatch-bound, as the JAX script
    # chose: per-batch compute is small, so the gap measured is the
    # per-node multiplier of the seed loop, not the convolutions' speed
    cfg = get_config("mnist-cnn").replace(cnn_channels=tuple(channels))
    fed = FederationConfig(num_nodes=n_nodes, rounds=1, local_epochs=1,
                           algorithm="profe")
    train = TrainConfig(batch_size=batch_size, learning_rate=1e-3,
                        optimizer="adamw", remat=False)
    data = make_image_dataset(0, samples_per_node * n_nodes, cfg.input_hw,
                              cfg.num_classes)
    parts = partition(data["label"], n_nodes, "iid", 0)
    node_data = [{k: v[i] for k, v in data.items()} for i in parts]
    return cfg, fed, train, node_data


def _wiring(cfg, fed, train, device, *, plane=None):
    """``run_federation``'s wiring: ``plane=None`` resolves
    ``fed.param_plane`` as the engines do (the timed stacked round runs
    the fused clip + update sweep a real run would), ``plane=False`` pins
    the per-leaf student (the seed loop's).  The states are per node."""
    student_cfg = derive_student(cfg)
    opt = make_optimizer(train.optimizer, train.learning_rate,
                         weight_decay=train.weight_decay,
                         momentum=train.momentum)
    use_plane = (F._plane_mode(fed, train, fed.algorithm, student_cfg)
                 if plane is None else plane)
    opt_s = opt
    if use_plane:
        opt_s = make_plane_optimizer(train.optimizer, train.learning_rate,
                                     weight_decay=train.weight_decay,
                                     momentum=train.momentum,
                                     grad_clip=train.grad_clip)
    step, _wire_model, _share, bits, model_cfgs = F._algo_wiring(
        fed.algorithm, cfg, student_cfg, fed, train, opt_s, opt)
    ncls = F._n_proto_classes(cfg)
    states = F._init_states(fed.algorithm, model_cfgs, fed, opt_s, opt, ncls,
                            device, plane=use_plane)
    return step, bits, ncls, model_cfgs, states, student_cfg


def legacy_round(step, states, node_data, cfg, student_cfg, fed, train,
                 adj, sizes, ncls, bits, rnd: int, device):
    """One round as the seed ran it: per-node Python loops over one-node
    stacks (``states``, ``[1, ...]`` leaves, a per-leaf student): each
    node's steps, each node's Eq. 3 pass (``compute_local_prototypes``),
    each node's per-leaf wire round trip (``core/quantization``), and
    per-node Eq. 4 and size-weighted mixing.  Updates ``states`` and
    returns it."""
    n_nodes = fed.num_nodes
    for i in range(n_nodes):
        st = states[i]
        for batch in batches(node_data[i], train.batch_size,
                             seed=fed.seed + rnd * 997 + i,
                             epochs=fed.local_epochs, device=device):
            st, _ = step(st, {k: v[None] for k, v in batch.items()}, True)
        states[i] = st._replace(round_idx=torch.full(
            (1,), rnd + 1, dtype=torch.int32, device=device))

    protos, counts = [], []
    for i in range(n_nodes):
        p, c = compute_local_prototypes(
            student_cfg, node_params(states[i].student, 0),
            batches(node_data[i], train.batch_size, seed=fed.seed + rnd,
                    device=device), ncls)
        protos.append(p)
        counts.append(c)

    with torch.no_grad():
        recv = [[] for _ in range(n_nodes)]
        recv_sz = [[] for _ in range(n_nodes)]
        for i in range(n_nodes):
            rx = quantize_dequantize_tree(states[i].student,
                                          resolve_bits(bits, "student"))
            for j in T.neighbors(adj, i):
                recv[j].append(rx)
                recv_sz[j].append(sizes[i])
        all_p = torch.stack([quantize_dequantize_tree(
            p, resolve_bits(bits, "protos")) for p in protos])
        all_c = torch.stack(counts)
        for i in range(n_nodes):
            neigh = torch.as_tensor(T.neighbors(adj, i) + [i], device=device)
            gp, mask = aggregate_prototypes(all_p[neigh], all_c[neigh])
            new_student = weighted_tree_mean([states[i].student] + recv[i],
                                             [sizes[i]] + recv_sz[i])
            # the received copies are the codec's own tensors, so node i's
            # student may take its mix in place (its leaves stay the
            # autograd leaves its optimizer updates)
            F._copy_into(states[i].student, new_student)
            states[i] = states[i]._replace(global_protos=gp[None],
                                           proto_mask=mask[None])
    _sync(device)
    return states


def _gossip(adj, sizes, device):
    w_self, w_neigh = R.gossip_matrix(adj, sizes)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (w_self, w_neigh, R.include_matrix(adj)))


def _round_inputs(node_data, batch_size, fed, rnd: int, device):
    """Round ``rnd``'s stacked training batches and exact Eq. 3 stream on
    ``device``, and whether every node steps every batch."""
    staged = F._stack_round_batches(
        node_data, batch_size,
        [fed.seed + rnd * 997 + i for i in range(fed.num_nodes)],
        fed.local_epochs)
    pstaged = F._stack_round_batches(node_data, batch_size,
                                     [fed.seed + rnd] * fed.num_nodes, 1)
    xb, valid = F._to_device(staged, device)
    pxb, pvalid = F._to_device(pstaged, device)
    return xb, valid, pxb, pvalid, bool(np.all(staged[1] == 1.0))


def measure(n_nodes: int, *, samples_per_node: int, batch_size: int,
            rounds: int, jitted_only: bool = False, device=None):
    """The seed loop's and the stacked round's median round ms at one
    node count; ``jitted_only`` skips the seed loop."""
    dev = resolve_device(device)
    cfg, fed, train, node_data = _setup(n_nodes, samples_per_node, batch_size)
    adj = T.adjacency(n_nodes, fed.topology)
    sizes = [len(d["label"]) for d in node_data]
    n_steps = sum(len(d["label"]) // batch_size for d in node_data)

    # --- the seed's per-node Python loop ----------------------------------
    t_legacy = []
    if not jitted_only:
        step, bits, ncls, _cfgs, states, student_cfg = _wiring(
            cfg, fed, train, dev, plane=False)
        states = [stack_states([s]) for s in states]
        states = legacy_round(step, states, node_data, cfg, student_cfg, fed,
                              train, adj, sizes, ncls, bits, 0, dev)  # warm-up
        for rnd in range(1, rounds + 1):
            t0 = time.perf_counter()
            states = legacy_round(step, states, node_data, cfg, student_cfg,
                                  fed, train, adj, sizes, ncls, bits, rnd,
                                  dev)
            t_legacy.append((time.perf_counter() - t0) * 1e3)
        del states

    # --- the stacked round ------------------------------------------------
    step_p, bits, ncls, _cfgs, states, student_cfg = _wiring(cfg, fed, train,
                                                             dev)
    stacked = stack_states(states)
    w_self, w_neigh, include = _gossip(adj, sizes, dev)
    round_fn = F._make_round_fn(step_p, student_cfg, ncls, share_protos=True,
                                wire_model="student", bits=bits)

    def stacked_round(stacked, rnd):
        xb, valid, pxb, pvalid, av = _round_inputs(node_data, batch_size,
                                                   fed, rnd, dev)
        out = round_fn(stacked, xb, valid, pxb, pvalid, w_self, w_neigh,
                       include, teacher_on=True, all_valid=av)
        _sync(dev)
        return out

    stacked = stacked_round(stacked, 0)                       # warm-up
    t_stacked = []
    for rnd in range(1, rounds + 1):
        t0 = time.perf_counter()
        stacked = stacked_round(stacked, rnd)
        t_stacked.append((time.perf_counter() - t0) * 1e3)

    stacked_ms = statistics.median(t_stacked)
    out = {
        "jitted_ms": round(stacked_ms, 2),
        "local_steps_per_round": n_steps,
        "steps_per_s_jitted": round(n_steps / (stacked_ms / 1e3), 1),
    }
    if not jitted_only:
        legacy_ms = statistics.median(t_legacy)
        out.update({
            "legacy_ms": round(legacy_ms, 2),
            "speedup": round(legacy_ms / stacked_ms, 2),
            "steps_per_s_legacy": round(n_steps / (legacy_ms / 1e3), 1),
        })
    return out


# ---------------------------------------------------------------------------
# per-phase breakdown (--phases)
# ---------------------------------------------------------------------------

def _node_planes(tree, n_nodes: int) -> torch.Tensor:
    """Stacked per-leaf ``[N, ...]`` tree -> ``[N, R, 512]``: every node's
    leaves packed by ``plane_from_tree`` (the rebuild a per-leaf path
    pays at the round boundary)."""
    return torch.stack([plane_from_tree(node_params(tree, i)).buf
                        for i in range(n_nodes)])


def _sum_sin(tree):
    return sum(torch.sum(torch.sin(x) * x) for x in tree_leaves(tree))


def measure_phases(n_nodes: int, *, samples_per_node: int, batch_size: int,
                   rounds: int, device=None):
    """Phase timings of the stacked round at one node count; every phase
    body comes from ``F._make_round_parts``, the code both engines run.
    ``proto_fused_ms`` is the marginal cost of folding Eq. 3 into the
    training loop: the fused train phase's time less the plain one's,
    clamped at 0 (the fused pass has no phase of its own)."""
    dev = resolve_device(device)
    cfg, fed, train, node_data = _setup(n_nodes, samples_per_node,
                                        batch_size)
    adj = T.adjacency(n_nodes, fed.topology)
    sizes = [len(d["label"]) for d in node_data]
    step_p, bits, ncls, _cfgs, states, student_cfg = _wiring(cfg, fed, train,
                                                             dev)
    stacked = stack_states(states)
    w_self, w_neigh, include = _gossip(adj, sizes, dev)
    xb, valid, pxb, pvalid, av = _round_inputs(node_data, batch_size, fed, 1,
                                               dev)
    e0, e1 = {}, torch.zeros((0, n_nodes), dtype=torch.float32, device=dev)

    def parts(proto_pass, share=True):
        return F._make_round_parts(step_p, student_cfg, ncls,
                                   share_protos=share,
                                   wire_model="student", bits=bits,
                                   proto_pass=proto_pass)

    def compose(p3):
        tr, sh, mx = p3

        def round_fn(state, xb, valid, pxb, pvalid, teacher_on,
                     all_valid=False):
            state, protos, counts = tr(state, xb, valid, pxb, pvalid,
                                       teacher_on, all_valid)
            state, rs, prx = sh(state, protos)
            return mx(state, rs, prx, counts, w_self, w_neigh, include)

        return round_fn

    train_only = parts("exact", share=False)[0]
    _, share_fn, mix_fn = parts("exact")
    train_fused = parts("fused")[0]
    proto_fn = F._make_proto_pass(student_cfg, ncls)

    # the fused proto cost is a DIFFERENCE of two train-sized timings:
    # interleaved, so drift hits both sides of each pair alike
    train_ms, fused_train_ms = _paired_ms(
        lambda: train_only(stacked, xb, valid, e0, e1, True, av),
        lambda: train_fused(stacked, xb, valid, e0, e1, True, av),
        rounds=max(rounds, 5), device=dev)
    proto_exact_ms = _median_ms(
        lambda: proto_fn(stacked.student, pxb, pvalid), rounds=rounds,
        device=dev)
    sums, counts = proto_fn(stacked.student, pxb, pvalid)
    protos = normalize_protos(sums, counts)
    codec_ms = _median_ms(lambda: share_fn(stacked, protos), rounds=rounds,
                          device=dev)
    _st, recv_student, protos_rx = share_fn(stacked, protos)
    mix_ms = _median_ms(
        lambda: mix_fn(stacked, recv_student, protos_rx, counts, w_self,
                       w_neigh, include), rounds=rounds, device=dev)
    round_exact = compose(parts("exact"))
    round_fused = compose(parts("fused"))
    round_exact_ms, round_fused_ms = _paired_ms(
        lambda: round_exact(stacked, xb, valid, pxb, pvalid, True, av),
        lambda: round_fused(stacked, xb, valid, e0, e1, True, av),
        rounds=max(rounds, 5), device=dev)

    # the A/B pairs run on copies of the trained plane; each side updates
    # its own copy in place
    planes = stacked.student
    meta = planes.meta

    def plane_copy():
        return Plane(planes.buf.detach().clone(), meta)

    def leaf_copy():
        return tree_map(lambda x: x.detach().clone(), as_tree(planes))

    # optimizer sweep alone: the fused plane clip + update (one sweep of
    # [N, R, 512], row 1) against the per-leaf clip and update; a copy of
    # the weights doubles as the gradient (same shapes, realistic
    # magnitudes)
    opt_leaf = make_optimizer(train.optimizer, train.learning_rate,
                              weight_decay=train.weight_decay,
                              momentum=train.momentum)
    opt_plane = make_plane_optimizer(train.optimizer, train.learning_rate,
                                     weight_decay=train.weight_decay,
                                     momentum=train.momentum,
                                     grad_clip=train.grad_clip)
    leaf_p, leaf_g = leaf_copy(), leaf_copy()
    plane_p, plane_g = plane_copy(), plane_copy()
    leaf_state = opt_leaf.init(leaf_p)
    plane_state = opt_plane.init(plane_p)

    def upd_leaf():
        g, _ = clip_by_global_norm(leaf_g, train.grad_clip, lead=1)
        return opt_leaf.update(g, leaf_state, leaf_p, lead=1)

    def upd_fused():
        return opt_plane.update(plane_g, plane_state, plane_p)

    update_per_leaf_ms, update_fused_ms = _paired_ms(
        upd_leaf, upd_fused, rounds=max(rounds, 10), device=dev)

    # the gradient's path into one buffer: autograd through the plane's
    # views lands it in the [N, R, 512] buffer directly; through per-leaf
    # copies it is rebuilt into planes leaf by leaf
    grad_buf = planes.buf.detach().clone().requires_grad_(True)
    grad_leaves = tree_map(lambda x: x.requires_grad_(True), leaf_copy())

    def grad_plane():
        (g,) = torch.autograd.grad(_sum_sin(as_tree(Plane(grad_buf, meta))),
                                   [grad_buf])
        return g

    def grad_repack():
        leaves = tree_leaves(grad_leaves)
        gs = iter(torch.autograd.grad(_sum_sin(grad_leaves), leaves))
        return _node_planes(tree_map(lambda _: next(gs), grad_leaves),
                            n_nodes)

    # both grad / mix pairs are sub-ms launch-bound ops: 100 pairs keep
    # their medians outside the host clock's spread
    grad_repack_ms, grad_plane_ms = _paired_ms(
        grad_repack, grad_plane, rounds=max(rounds, 100), device=dev)

    # the gossip mix on the stacked buffer against the tree mix over the
    # leaf views plus the rebuild the plane path does not pay
    @torch.no_grad()
    def mix_plane():
        buf = planes.buf
        return w_self[:, None, None] * buf + torch.tensordot(w_neigh, buf,
                                                             dims=1)

    @torch.no_grad()
    def mix_tree():
        v = as_tree(planes)
        return _node_planes(R.mix_node_trees(w_self, w_neigh, v, v), n_nodes)

    mix_tree_ms, mix_plane_ms = _paired_ms(
        mix_tree, mix_plane, rounds=max(rounds, 100), device=dev)

    # the adapter wire's merge: lowrank_apply over the plane's matrix
    # spans (row 16, in place) against the per-leaf apply plus the plane
    # rebuild, on the same factors; references at 0.9x the weights give
    # every leaf a nonzero delta, the rest leaves pass through
    from repro_torch.core.adapters import (adapter_layout, factorize_deltas,
                                           split_student)
    from repro_torch.kernels.lowrank_apply.ops import (adapter_apply_plane,
                                                       adapter_apply_tree)
    with torch.no_grad():
        views = as_tree(planes)
        a_layout = adapter_layout(views, 8, node_axis=True)
        a_mats, a_rest = split_student(a_layout, views)
        a_factors = factorize_deltas(a_layout, a_mats,
                                     {k: 0.9 * v for k, v in a_mats.items()})
    apply_target = plane_copy()

    def apply_dense():
        tree = adapter_apply_tree(as_tree(planes), a_layout, w_neigh,
                                  a_factors, a_rest)
        return _node_planes(tree, n_nodes)

    def apply_fused():
        return adapter_apply_plane(apply_target, a_layout, w_neigh,
                                   a_factors, a_rest).buf

    apply_dense_ms, apply_fused_ms = _paired_ms(
        apply_dense, apply_fused, rounds=max(rounds, 100), device=dev)
    return {
        "train_ms": train_ms,
        "proto_exact_ms": proto_exact_ms,
        "proto_fused_ms": round(max(0.0, fused_train_ms - train_ms), 3),
        "codec_ms": codec_ms,
        "mix_ms": mix_ms,
        "update_per_leaf_ms": update_per_leaf_ms,
        "update_fused_ms": update_fused_ms,
        "grad_repack_ms": grad_repack_ms,
        "grad_plane_ms": grad_plane_ms,
        "mix_tree_ms": mix_tree_ms,
        "mix_plane_ms": mix_plane_ms,
        "apply_dense_ms": apply_dense_ms,
        "apply_fused_ms": apply_fused_ms,
        "round_exact_ms": round_exact_ms,
        "round_fused_ms": round_fused_ms,
        "fused_round_speedup": round(round_exact_ms
                                     / max(round_fused_ms, 1e-9), 3),
    }


# ---------------------------------------------------------------------------
# wire-exchange microbench (--wire)
# ---------------------------------------------------------------------------

def _median_ms(fn, *args, rounds: int = 20, device):
    fn(*args)                                           # warm-up
    _sync(device)
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return round(statistics.median(ts), 3)


def _paired_ms(fn_a, fn_b, *args, rounds: int = 20, device):
    """Interleaved A/B timing: one loop alternates the two callables so
    drift on the host hits both samples of every pair alike.  Returns
    ``(median_a_ms, median_b_ms)``."""
    fn_a(*args)                                         # warm-up
    fn_b(*args)
    _sync(device)
    ta, tb = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn_a(*args)
        _sync(device)
        ta.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        fn_b(*args)
        _sync(device)
        tb.append((time.perf_counter() - t0) * 1e3)
    return (round(statistics.median(ta), 3),
            round(statistics.median(tb), 3))


def codec_payload(n_nodes: int = 8, *, arch: str = "mnist-cnn",
                  adapter_rank: int = 0, device=None):
    """The codec pair's payload: one round's stacked ``{protos,
    student}`` (per-leaf students drawn from seeds 0..N-1, prototypes
    from ``default_rng(0)``), or with ``adapter_rank`` > 0 the adapter
    wire's factored groups and the prototypes (the reference snapshot
    drawn from seeds 1000..)."""
    from repro_torch.launch.wire import student_setup
    from repro_torch.models import init_params

    dev = resolve_device(device)
    _cfg, student_cfg, _struct, ncls = student_setup(arch)

    def stacked_params(seed0):
        trees = [tree_map(lambda x: x.to(dev), init_params(
            student_cfg, torch.Generator().manual_seed(seed0 + i)))
            for i in range(n_nodes)]
        return tree_map(lambda *xs: torch.stack(xs), *trees)

    students = stacked_params(0)
    protos = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (n_nodes, ncls, student_cfg.proto_dim)), dtype=torch.float32,
        device=dev)
    if not adapter_rank:
        return {"protos": protos, "student": students}
    from repro_torch.core.adapters import adapter_layout, init_adapter_state
    layout = adapter_layout(students, adapter_rank, node_axis=True)
    ast = init_adapter_state(layout, stacked_params(1000))
    groups, _, _ = R.adapter_share_nodes(students, ast, rank=adapter_rank)
    return dict(groups, protos=protos)


def measure_codec(n_nodes: int = 8, *, arch: str = "mnist-cnn", bits="16",
                  rounds: int = 20, adapter_rank: int = 0, device=None):
    """The per-leaf reference codec against the packed codec on
    :func:`codec_payload`, interleaved; ``adapter_rank`` > 0 times the
    adapter wire's factored payload groups, and a ``+ef`` spec the
    stateful codec (the residual replayed each call).  Returns
    ``{"per_leaf_ms", "packed_ms"}``."""
    dev = resolve_device(device)
    spec = WireSpec.parse(bits)
    payload = codec_payload(n_nodes, arch=arch, adapter_rank=adapter_rank,
                            device=dev)
    kw = {}
    if spec.error_feedback:
        from repro_torch.core.wire_state import init_codec_state
        kw["state"] = init_codec_state(payload, n_nodes)
    with torch.no_grad():
        leaf_ms, packed_ms = _paired_ms(
            lambda: R.quantize_dequantize_per_node(payload, spec=spec,
                                                   packed=False, **kw),
            lambda: R.quantize_dequantize_per_node(payload, spec=spec, **kw),
            rounds=rounds, device=dev)
    return {"per_leaf_ms": leaf_ms, "packed_ms": packed_ms}


def measure_wire(n_nodes: int = 8, topology: str = "ring", *,
                 arch: str = "mnist-cnn", rows=(("16", 0),),
                 rounds: int = 20, inner: int = 1, device=None):
    """Each row ``(bits, adapter_rank)``: the codec pair
    (:func:`measure_codec`) and the exchanges' bytes and round ms on one
    spawn of ``n_nodes · inner`` gloo ranks for all rows
    (``launch/wire.measure_exchange_rows``; ``inner`` > 1 shapes each
    node as ``inner`` ranks, the row-sharded permute).  Returns ``[{"codec",
    "exchange"}]`` in row order."""
    from repro_torch.launch.wire import measure_exchange_rows

    if inner > 1 and any(rank for _, rank in rows):
        raise ValueError("adapter rows need --pods R (no row-sharded "
                         "permute for the adapter wire)")
    reports = measure_exchange_rows(
        arch, n_nodes, topology,
        rows=[dict(bits=b, adapter_rank=r) for b, r in rows],
        inner=inner, timed_rounds=rounds, device=device)
    return [{"codec": measure_codec(n_nodes, arch=arch, bits=b,
                                    rounds=rounds, adapter_rank=r,
                                    device=device),
             "exchange": rep} for (b, r), rep in zip(rows, reports)]


def _wire_bits_sweep(n_nodes, topology, wire_bits, rounds, inner,
                     adapter_ranks=(), adapter_bits=("4",), device=None):
    rows = [(b, 0) for b in wire_bits]
    if inner == 1:
        # adapter rows, labeled "<bits>+adapters<rank>"; several ranks a
        # node have no row-sharded permute for the adapter wire, so RxC
        # shapes skip them
        rows += [(b, r) for r in adapter_ranks if r for b in adapter_bits]
    per_bits = {}
    results = measure_wire(n_nodes, topology, rows=rows, rounds=rounds,
                           inner=inner, device=device)
    for (b, rank), res in zip(rows, results):
        label = f"{b}+adapters{rank}" if rank else b
        per_bits[label] = res
        ex = res["exchange"]["exchanges"]
        print(f"== bits={label} ==")
        print(f"codec qdq: per-leaf {res['codec']['per_leaf_ms']:7.2f} ms   "
              f"packed {res['codec']['packed_ms']:7.2f} ms")
        for name, rep in ex.items():
            if "error" in rep:
                print(f"  {name:9s} {rep['error']}")
                continue
            print(f"  {name:9s} {rep['collective_bytes_per_node']/1e3:9.1f} "
                  f"KB/node   "
                  f"{rep.get('round_ms', float('nan')):7.2f} ms/round")
        if "ppermute" in ex and "error" not in ex["ppermute"]:
            full = res["exchange"].get("full_gather_bytes_per_node") or 0
            if full:
                frac = ex["ppermute"]["collective_bytes_per_node"] / full
                res["ppermute_vs_full_gather"] = round(frac, 4)
                print(f"  ppermute wire = {frac:.2%} of the full-graph "
                      f"all-gather exchange")
    base = per_bits.get("16", {}).get("exchange", {}).get(
        "exchanges", {}).get("ppermute", {}).get("collective_bytes_per_node")
    if base:
        for res in per_bits.values():
            p = res["exchange"]["exchanges"].get("ppermute", {})
            if "collective_bytes_per_node" in p:
                res["ppermute_vs_int16"] = round(
                    p["collective_bytes_per_node"] / base, 4)
    return per_bits


def run_wire(args) -> dict:
    from repro_torch.launch.wire import parse_pods
    dev = resolve_device(args.device)
    shapes = [parse_pods(p) for p in args.pods]
    out = {
        "benchmark": "wire exchange: packed single-buffer codec vs "
                     "per-leaf, gather vs ppermute neighbor collectives "
                     f"({args.wire_topology}, pods={list(args.pods)}, "
                     "mnist-cnn student+protos payload), per wire spec",
        "backend": str(dev),
        "card": card(dev),
        "config": {"nodes": shapes[0][0],
                   "topology": args.wire_topology,
                   "timed_rounds": args.rounds,
                   "bits": list(args.wire_bits),
                   "pods": list(args.pods),
                   "adapter_ranks": list(args.wire_adapters),
                   "adapter_bits": list(args.wire_adapter_bits)},
        "per_pods": {},
    }
    for pods_str, (n, inner) in zip(args.pods, shapes):
        print(f"==== pods={pods_str} ({n} nodes x {inner} ranks) ====")
        out["per_pods"][pods_str] = _wire_bits_sweep(
            n, args.wire_topology, args.wire_bits, args.rounds, inner,
            adapter_ranks=args.wire_adapters,
            adapter_bits=args.wire_adapter_bits, device=dev)
    # the first pod shape also under the JAX report's top-level key
    out["per_bits"] = out["per_pods"][args.pods[0]]
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    return out


def parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (but ``--out``'s, the port's
    own report), plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", nargs="+", type=int, default=[2, 4, 8])
    ap.add_argument("--samples-per-node", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default="BENCH_torch_round_step.json")
    ap.add_argument("--phases", action="store_true",
                    help="also record the per-phase breakdown "
                         "(train/proto/codec/mix, exact vs fused round) "
                         "under nodes[n]['phases']")
    ap.add_argument("--wire", action="store_true",
                    help="wire-exchange microbench instead of the round "
                         "step (writes BENCH_torch_wire_exchange.json)")
    ap.add_argument("--wire-nodes", type=int, default=8)
    ap.add_argument("--wire-topology", default="ring")
    ap.add_argument("--wire-bits", nargs="+",
                    default=["16", "8", "4", "4/16"],
                    help="wire specs to sweep: 16 | 8 | 4 (uniform) or "
                         "<student>/<protos> (mixed)")
    ap.add_argument("--wire-adapters", nargs="+", type=int, default=[8],
                    metavar="RANK",
                    help="adapter ranks to add as extra --wire rows "
                         "(labeled '<bits>+adapters<rank>'); [] skips "
                         "them")
    ap.add_argument("--wire-adapter-bits", nargs="+", default=["4"],
                    help="wire specs the adapter rows run at")
    ap.add_argument("--pods", nargs="+", default=None,
                    help="pod shapes to sweep in --wire mode: 'R' or "
                         "'RxC' (R nodes x C ranks a node; C > 1 rows "
                         "record the row-sharded permute's pod bytes).  "
                         "Default: --wire-nodes as a single (R, 1) shape")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    return ap


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)

    if args.wire:
        if args.pods is None:
            args.pods = [str(args.wire_nodes)]
        if args.out == "BENCH_torch_round_step.json":
            args.out = "BENCH_torch_wire_exchange.json"
    if Path(args.out).name in JAX_REPORTS:
        ap.error(f"--out {args.out} is the JAX package's report")
    if args.wire:
        args.rounds = max(args.rounds, 10)
        return run_wire(args)

    dev = resolve_device(args.device)
    results = {}
    for n in args.nodes:
        print(f"== N={n} nodes ==")
        r = measure(n, samples_per_node=args.samples_per_node,
                    batch_size=args.batch_size, rounds=args.rounds,
                    device=dev)
        results[str(n)] = r
        print(f"  legacy {r['legacy_ms']:8.1f} ms/round   "
              f"stacked {r['jitted_ms']:8.1f} ms/round   "
              f"speedup {r['speedup']:.2f}x")
        if args.phases:
            ph = measure_phases(n, samples_per_node=args.samples_per_node,
                                batch_size=args.batch_size,
                                rounds=args.rounds, device=dev)
            r["phases"] = ph
            print(f"  phases: train {ph['train_ms']:7.1f}  "
                  f"proto exact {ph['proto_exact_ms']:6.1f} / "
                  f"fused +{ph['proto_fused_ms']:5.1f}  "
                  f"codec {ph['codec_ms']:6.1f}  mix {ph['mix_ms']:6.1f} ms")
            print(f"  update: per-leaf {ph['update_per_leaf_ms']:6.2f}  "
                  f"fused {ph['update_fused_ms']:6.2f} ms")
            print(f"  grad: repack {ph['grad_repack_ms']:6.2f}  "
                  f"plane {ph['grad_plane_ms']:6.2f} ms   "
                  f"mix: tree {ph['mix_tree_ms']:6.2f}  "
                  f"plane {ph['mix_plane_ms']:6.2f} ms")
            print(f"  apply: dense {ph['apply_dense_ms']:6.2f}  "
                  f"fused {ph['apply_fused_ms']:6.2f} ms")
            print(f"  round: exact {ph['round_exact_ms']:7.1f}  "
                  f"fused {ph['round_fused_ms']:7.1f} ms  "
                  f"({ph['fused_round_speedup']:.2f}x)")

    out = {
        "benchmark": "one full ProFe federation round (train + Eq.3 protos "
                     "+ gossip + aggregate), reduced mnist-cnn (8,16), "
                     "dispatch-bound regime",
        "backend": str(dev),
        "card": card(dev),
        "config": {"samples_per_node": args.samples_per_node,
                   "batch_size": args.batch_size,
                   "timed_rounds": args.rounds,
                   "algorithm": "profe", "local_epochs": 1},
        "nodes": results,
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
