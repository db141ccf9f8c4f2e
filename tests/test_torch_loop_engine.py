"""The port's per-node loop engine (``run_federation_loop``) and its
helpers, held against the JAX package on the CPU.

* The helpers, bit for bit: ``data.batches``,
  ``CommMeter.record_broadcast``, ``aggregation.weighted_tree_mean`` /
  ``neighborhood_aggregate`` / ``weighted_plane_mean``,
  ``kernels/quantize/ops.quantize_dequantize_plane_rows`` (4, 8 and 16
  bits, an unstacked plane and a one-node stack), and
  ``wire_state.ef_quantize_dequantize_plane`` against ``repro``'s eager
  call (its jitted call, the JAX loop engine's, divides by qmax as a
  multiply by the reciprocal and contracts the residual's
  multiply-subtract into an FMA on XLA:CPU, so against that the views
  are held to ``rtol=1e-6`` and the residual to ``RES_ATOL``);
  ``round_ops.weighted_node_mean`` to ``rtol=1e-6`` (two
  tensordots that may sum in other orders).
* Whole ``run_federation_loop`` runs of both packages from the same
  carried states (``repro``'s own ``_init_states``) on a ragged split (4
  nodes of a tiny mnist-cnn, fp32, node 0 cut to 10 images, under one
  batch of 16, so its one batch is short): the plane and a per-leaf
  student, the ``16``, ``4/16+ef`` and adapter wires (naive and
  RegMean), the fused pass with the prototype EMA, and FedProto with
  every node evaluated.
  ``avg_sent_gb``, ``comm.sent``, ``comm.received``, ``comm.by_round``
  and the byte extras exactly; after every round every node's student
  (read where both engines evaluate it) to ``atol=2e-5`` (as
  ``tests/test_torch_federation.py``), but for at most
  ``MAX_EPS_ELEMENTS`` parameters in Adam's eps regime, each within
  ``atol + 2·lr`` (``tests/test_torch_baselines.py``); per-round F1 and
  accuracy exactly.
* ``run_federation`` falls back to the loop engine for a ragged split
  (its result the loop's, bit for bit), and the loop engine against the
  port's own stacked engine on an equal split: bytes exactly, the final
  stacked state to the same tolerances (the stacked mix sums its
  senders in one tensordot, the loop one sender after another), step
  counters, masks and round counters exactly.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import aggregation as jagg
from repro.core import comm as jcomm
from repro.core import federation as JF
from repro.core import round_ops as jround
from repro.core import wire_state as jws
from repro.data import loader as jloader
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.config import base as tbase
from repro_torch.core import aggregation as tagg
from repro_torch.core import comm as tcomm
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import round_ops as tround
from repro_torch.core import wire_state as tws
from repro_torch.data import (batches, make_image_dataset, partition,
                              train_test_split)
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.optim import plane as tplane
from repro_torch.tree import keyed_leaves, tree_leaves
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 4
RES_ATOL = 2e-6             # EF student residual against the jitted codec
MAX_EPS_ELEMENTS = 2        # parameters in Adam's eps regime, a round
LR = 1e-3                   # TrainConfig's learning rate


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _bits(x) -> bytes:
    return _a(x).tobytes()


# -- the helpers -----------------------------------------------------------------

def test_batches_match_jax():
    rng = np.random.default_rng(0)
    data = {"image": rng.standard_normal((37, 4)).astype(np.float32),
            "label": rng.integers(0, 10, 37).astype(np.int32)}
    for n, kw in ((37, dict(epochs=2)), (10, {})):
        d = {k: v[:n] for k, v in data.items()}
        got = list(batches(d, 16, seed=5, **kw))
        want = list(jloader.batches(d, 16, seed=5, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in d:
                assert _bits(g[k]) == np.asarray(w[k]).tobytes()


def test_record_broadcast_matches_jax():
    payload = {"model": {"w": np.zeros((5, 7), np.float32),
                         "b": np.zeros((7,), np.float32)},
               "protos": np.zeros((10, 16), np.float32),
               "counts": np.zeros((10,), np.float32)}
    tpay = jax.tree_util.tree_map(torch.from_numpy, payload)
    meters = (tcomm.CommMeter(3), jcomm.CommMeter(3))
    for bits_t, bits_j in ((WireSpec(4, 16), JWireSpec(4, 16)),
                           (None, None)):
        for rnd, (sender, recv) in enumerate(((0, [1, 2]), (2, [0]))):
            nt = meters[0].record_broadcast(sender, recv, tpay, "profe",
                                            rnd, bits_t)
            nj = meters[1].record_broadcast(sender, recv, payload, "profe",
                                            rnd, bits_j)
            assert nt == nj
    for key in ("sent", "received", "by_kind", "by_round"):
        assert dict(getattr(meters[0], key)) == dict(getattr(meters[1], key))
    assert meters[0].summary() == meters[1].summary()


def test_weighted_means_match_jax():
    rng = np.random.default_rng(1)
    trees = [{"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": [rng.standard_normal((4,)).astype(np.float32)]}
             for _ in range(3)]
    sizes = [37.0, 12.5, 50.0]
    tt = [jax.tree_util.tree_map(torch.from_numpy, t) for t in trees]
    # JAX arrays, as the JAX engine mixes them (numpy leaves would take
    # numpy's float64 products)
    trees = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    want = jagg.weighted_tree_mean(trees, sizes)
    got = tagg.weighted_tree_mean(tt, sizes)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert _bits(g) == np.asarray(w).tobytes()
    want = jagg.neighborhood_aggregate(0, trees[0], trees[1:], sizes[0],
                                       sizes[1:])
    got = tagg.neighborhood_aggregate(0, tt[0], tt[1:], sizes[0], sizes[1:])
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert _bits(g) == np.asarray(w).tobytes()
    # the plane mean: on the buffers, bit-identical to JAX's
    tplanes = [tplane.plane_from_tree(t) for t in tt]
    jplanes = [jplane.plane_from_tree(t) for t in trees]
    got = tagg.weighted_plane_mean(tplanes, sizes)
    want = jagg.weighted_plane_mean(jplanes, sizes)
    assert got.meta == tplanes[0].meta
    assert _bits(got.buf) == np.asarray(want.buf).tobytes()
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    stacked = {"a": jnp.stack([t["a"] for t in trees])}
    got = tround.weighted_node_mean(
        torch.from_numpy(w), {"a": torch.from_numpy(np.asarray(stacked["a"]))})
    want = jround.weighted_node_mean(jnp.asarray(w), stacked)
    np.testing.assert_allclose(_a(got["a"]), np.asarray(want["a"]),
                               rtol=1e-6, atol=0)


def _student_tree(seed: int):
    cfg = jbase.get_config("mnist-cnn").replace(cnn_channels=(4, 8),
                                                proto_dim=16)
    return _np_tree(jmodel.init_params(jmodel.derive_student(cfg),
                                       jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["plane", "one-node stack"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_dequantize_plane_rows_matches_jax(bits, stacked):
    tree = _student_tree(bits)
    jp = jplane.plane_from_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    tp = tplane.plane_from_tree(jax.tree_util.tree_map(torch.from_numpy,
                                                       tree))
    assert tp.meta.rows > sum(r[4] for r in tp.meta.recipe)  # alignment rows
    want = np.asarray(jqops.quantize_dequantize_plane_rows(jp, bits).buf)
    if stacked:
        tp = tplane.Plane(tp.buf[None], tp.meta)
    got = tqops.quantize_dequantize_plane_rows(tp, bits)
    assert got.meta == tp.meta and tuple(got.buf.shape) == tuple(
        tp.buf.shape)
    assert _bits(got.buf.reshape(want.shape)) == want.tobytes()
    with pytest.raises(ValueError, match="one node"):
        tqops.quantize_dequantize_plane_rows(
            tplane.Plane(torch.cat([tp.buf.reshape((1,) + want.shape)] * 2),
                         tp.meta), bits)


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_ef_quantize_dequantize_plane_matches_jax(decay):
    """Two rounds of the per-node ``+ef`` codec (``4/16``): against
    ``repro``'s eager call bit for bit (receiver views, residuals,
    ``seq``); against its jitted call (the loop engine's) the views
    bit for bit in round 1 and the residual to ``RES_ATOL``."""
    spec_t = WireSpec(4, 16, error_feedback=True, ef_decay=decay)
    spec_j = JWireSpec(4, 16, error_feedback=True, ef_decay=decay)
    rng = np.random.default_rng(2)
    tree = _student_tree(3)
    jp = jplane.plane_from_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    tp = tplane.plane_from_tree(jax.tree_util.tree_map(torch.from_numpy,
                                                       tree))
    jst = jws.init_codec_state({"protos": jnp.zeros((10, 16), jnp.float32),
                                "student": jp})
    tst = tws.CodecState({"protos": torch.zeros((10, 16)),
                          "student": tplane.Plane(torch.zeros_like(tp.buf),
                                                  tp.meta)},
                         torch.zeros((), dtype=torch.int32))
    jit_qdq = jax.jit(lambda t, s: jws.ef_quantize_dequantize_plane(
        t, spec_j, s))
    jst_jit = jst
    for rnd in range(2):
        protos = rng.standard_normal((10, 16)).astype(np.float32)
        jpay = {"protos": jnp.asarray(protos), "student": jp}
        jrecv, jst = jws.ef_quantize_dequantize_plane(jpay, spec_j, jst)
        jrecv_jit, jst_jit = jit_qdq(jpay, jst_jit)
        trecv, tst = tws.ef_quantize_dequantize_plane(
            {"protos": torch.from_numpy(protos), "student": tp}, spec_t, tst)
        assert _bits(trecv["protos"]) == np.asarray(jrecv["protos"]).tobytes()
        assert _bits(trecv["student"].buf) == \
            np.asarray(jrecv["student"].buf).tobytes()
        assert _bits(tst.residual["protos"]) == \
            np.asarray(jst.residual["protos"]).tobytes()
        assert _bits(tst.residual["student"].buf) == \
            np.asarray(jst.residual["student"].buf).tobytes()
        assert int(tst.seq) == int(jst.seq) == rnd + 1
        np.testing.assert_allclose(_a(trecv["student"].buf),
                                   np.asarray(jrecv_jit["student"].buf),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            _a(tst.residual["student"].buf),
            np.asarray(jst_jit.residual["student"].buf), rtol=0,
            atol=RES_ATOL)
        # the residual's padding lanes and alignment rows stay zero
        rows = sum(r[4] for r in tp.meta.recipe)
        assert not _a(tst.residual["student"].buf)[rows:].any()


# -- whole runs against the JAX loop engine ------------------------------------

WIRES = {"16": {}, "fp32": dict(quantize_bits=0),
         "4/16+ef": dict(quantize_bits=4, proto_quantize_bits=16,
                         error_feedback=True),
         "adapters8": dict(quantize_bits=4, adapter_rank=8),
         "adapters8+grams": dict(quantize_bits=4, adapter_rank=8,
                                 adapter_grams=True)}


def _setup(wire, *, ragged=True, rounds=2, per_node=56, batch=16,
           channels=(4, 8), **fed):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=channels, proto_dim=16, dtype="float32")
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    if ragged:
        parts[0] = parts[0][:10]            # under one batch of 16
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full",
              **WIRES[wire], **fed)
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg)), node_data,
            test_d, jbase.FederationConfig(**kw),
            tbase.FederationConfig(**kw), jbase.TrainConfig(**train_kw),
            tbase.TrainConfig(**train_kw))


def _jax_states(jcfg, jfed, jtrain):
    algo = jfed.algorithm
    scfg = jmodel.derive_student(jcfg)
    plane = JF._plane_mode(jfed, jtrain, algo, scfg)
    opt_t = jmake_optimizer("adamw", jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    opt_s = jplane.make_plane_optimizer(
        "adamw", jtrain.learning_rate, weight_decay=jtrain.weight_decay,
        grad_clip=jtrain.grad_clip) if plane else opt_t
    _, _, _, _, cfgs = JF._algo_wiring(algo, jcfg, scfg, jfed, jtrain,
                                       opt_s, opt_t, jit=False)
    return JF._init_states(algo, cfgs, jfed, opt_s, opt_t, 10,
                           plane=plane), plane


def _carry(st, plane: bool):
    acc = None if st.proto_acc is None else tuple(np.asarray(x)
                                                  for x in st.proto_acc)
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), plane=plane, proto_acc=acc, device="cpu")


def _recording_eval(pkg, rounds, leaves):
    """Wrap ``pkg._eval_nodes`` so that every round's students of every
    node (the models both engines evaluate) are recorded as numpy."""
    inner = pkg._eval_nodes

    def eval_nodes(eval_cfg, students_of, n_nodes, *args, **kwargs):
        rounds.append([[_a(x) for x in leaves(students_of(i))]
                       for i in range(n_nodes)])
        return inner(eval_cfg, students_of, n_nodes, *args, **kwargs)
    return eval_nodes


def _assert_students_close(t_rounds, j_rounds, eps_elements, atol=2e-5):
    assert len(t_rounds) == len(j_rounds)
    for t_nodes, j_nodes in zip(t_rounds, j_rounds):
        beyond, gap = 0, 0.0
        for t, j in zip(t_nodes, j_nodes):
            assert len(t) == len(j) > 0
            for a, b in zip(t, j):
                a = a.reshape(b.shape)
                d = np.abs(a - b)
                beyond += int(np.count_nonzero(d > atol))
                gap = max(gap, float(d.max(initial=0.0)))
        assert beyond <= eps_elements and gap <= atol + 2 * LR, (beyond,
                                                                 gap)


LOOP_RUNS = {
    "plane/16": ("16", {}),
    "plane/4/16+ef": ("4/16+ef", {}),
    "plane/adapters8": ("adapters8", dict(channels=(24, 32))),
    "plane/adapters8+grams": ("adapters8+grams",
                              dict(channels=(24, 32), rounds=1)),
    "per-leaf/16/fused+ema": ("16", dict(param_plane="off",
                                         proto_pass="fused",
                                         proto_ema=0.5)),
    "fedproto/fp32/all-nodes": ("fp32", dict(algorithm="fedproto",
                                             eval_all_nodes=True)),
}


@pytest.mark.parametrize("case", list(LOOP_RUNS))
def test_run_federation_loop_matches_jax(case, monkeypatch):
    wire, kw = LOOP_RUNS[case]
    kw = dict(kw)
    setup_kw = {k: kw.pop(k) for k in ("channels", "rounds") if k in kw}
    run_kw = {k: kw.pop(k) for k in ("eval_all_nodes",) if k in kw}
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        wire, **setup_kw, **kw)
    jrounds, trounds = [], []
    monkeypatch.setattr(JF, "_eval_nodes", _recording_eval(
        JF, jrounds, lambda t: jax.tree_util.tree_leaves(t)))
    monkeypatch.setattr(TF, "_eval_nodes", _recording_eval(
        TF, trounds, tree_leaves))
    jres = JF.run_federation_loop(jcfg, jfed, jtrain, node_data, test_d,
                                  **run_kw)
    jstates, plane = _jax_states(jcfg, jfed, jtrain)
    tres = TF.run_federation_loop(
        tcfg, tfed, ttrain, node_data, test_d,
        initial_states=[_carry(s, plane) for s in jstates], device="cpu",
        **run_kw)
    assert tres.extras["param_plane"] is plane
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    for key in ("sent", "received", "by_round", "by_kind"):
        assert dict(getattr(tres.comm, key)) == dict(getattr(jres.comm, key))
    _assert_students_close(trounds, jrounds, MAX_EPS_ELEMENTS)
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round
    if run_kw:
        for key in ("f1_per_round_nodes", "acc_per_round_nodes",
                    "f1_std_per_round"):
            assert tres.extras[key] == jres.extras[key], key
    st = tres.state
    n_batches = [max(len(d["label"]) // 16, 1) for d in node_data]
    assert st.opt_s["step"].tolist() == [tfed.rounds * b for b in n_batches]
    assert st.round_idx.tolist() == [tfed.rounds] * N_NODES
    if wire.endswith("+ef"):
        assert tres.extras["wire_state"].seq.tolist() == \
            [tfed.rounds] * N_NODES
    if tfed.adapter_rank:
        f = tres.extras["adapter_factors"]
        assert len(f) == 3 and all(
            x["A"].shape[0] == N_NODES and float(x["A"].abs().max()) > 0
            for x in f.values())


def test_run_federation_falls_back_to_the_loop_engine():
    """A ragged split (node 0 under one batch) through ``run_federation``
    is the loop engine's run, bit for bit; ``overlap`` is ignored."""
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup("16", rounds=1)
    loop = TF.run_federation_loop(tcfg, tfed, ttrain, node_data, test_d,
                                  device="cpu")
    via = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                            overlap="none", device="cpu")
    assert via.f1_per_round == loop.f1_per_round
    assert dict(via.comm.sent) == dict(loop.comm.sent)
    for (ka, a), (kb, b) in zip(keyed_leaves(via.state),
                                keyed_leaves(loop.state)):
        assert ka == kb and _bits(a) == _bits(b)
    assert isinstance(via.comm, tcomm.CommMeter) and \
        not isinstance(via.comm, tcomm.ScheduleCommAccountant)


def test_loop_engine_resumes_from_a_stacked_state_bit_for_bit():
    """The loop engine's ``result.state`` (its one-node stacks joined) fed
    back as ``initial_states`` with ``start_round=1`` (split into one-node
    stacks again) ends bit-identical to the uninterrupted run, on the
    ragged ``4/16+ef`` split (the residual and ``seq`` carried)."""
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup("4/16+ef")
    full = TF.run_federation_loop(tcfg, tfed, ttrain, node_data, test_d,
                                  device="cpu")
    one = TF.run_federation_loop(tcfg, dataclasses.replace(tfed, rounds=1),
                                 ttrain, node_data, test_d, device="cpu")
    assert one.state.opt_s["step"].tolist() == [1, 3, 3, 3]
    resumed = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                                initial_states=one.state, start_round=1,
                                device="cpu")
    for (ka, a), (kb, b) in zip(keyed_leaves(resumed.state),
                                keyed_leaves(full.state)):
        assert ka == kb and _bits(a) == _bits(b), ka
    assert resumed.f1_per_round == full.f1_per_round[1:]
    assert resumed.state.wire_state.seq.tolist() == [2] * N_NODES


@pytest.mark.parametrize("wire", ["16", "4/16+ef"])
def test_loop_engine_matches_the_stacked_engine(wire):
    """On an equal split: the port's loop engine against its stacked
    engine, 2 rounds from the same seeded states.  Bytes exactly; the
    final state to the tolerances above (the Adam moments 1e-6 and
    1e-8, the Eq. 4 prototypes 1e-4, the ``+ef`` residual ``RES_ATOL``),
    counters and masks exactly."""
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup(wire,
                                                            ragged=False)
    stacked = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                                device="cpu")
    loop = TF.run_federation_loop(tcfg, tfed, ttrain, node_data, test_d,
                                  device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert loop.extras[key] == stacked.extras[key], key
    for key in ("sent", "received", "by_round"):
        assert dict(getattr(loop.comm, key)) == \
            dict(getattr(stacked.comm, key))
    a, b = loop.state, stacked.state
    for x, y in ((a.student.buf, b.student.buf),
                 *zip(tree_leaves(a.teacher), tree_leaves(b.teacher))):
        np.testing.assert_allclose(_a(x), _a(y), rtol=0, atol=2e-5)
    for key, atol in (("mu", 1e-6), ("nu", 1e-8)):
        for opt in ("opt_s", "opt_t"):
            for x, y in zip(tree_leaves(getattr(a, opt)[key]),
                            tree_leaves(getattr(b, opt)[key])):
                np.testing.assert_allclose(_a(x), _a(y), rtol=0, atol=atol)
    for opt in ("opt_s", "opt_t"):
        assert getattr(a, opt)["step"].tolist() == \
            getattr(b, opt)["step"].tolist()
    np.testing.assert_allclose(_a(a.global_protos), _a(b.global_protos),
                               rtol=0, atol=1e-4)
    assert _bits(a.proto_mask) == _bits(b.proto_mask)
    assert a.round_idx.tolist() == b.round_idx.tolist()
    if wire.endswith("+ef"):
        assert a.wire_state.seq.tolist() == b.wire_state.seq.tolist()
        np.testing.assert_allclose(_a(a.wire_state.residual["student"].buf),
                                   _a(b.wire_state.residual["student"].buf),
                                   rtol=0, atol=RES_ATOL)


# -- chip_smoke.py's non-iid paths ----------------------------------------------

def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["16/noniid40", "cifar10/sgd/dirichlet",
                                  "16/ragged", "4/16+ef/ragged",
                                  "adapters8/ragged"])
def test_chip_smoke_noniid_paths_bytes_match_jax(name):
    """The N = 20 constants ``chip_smoke.py`` holds its non-iid paths to,
    from ``repro``'s accountants over the full-width payload: its
    per-edge ``CommMeter`` over the full graph (the loop engine's meter)
    and its ``ScheduleCommAccountant`` (the stacked engine's) give the
    path's ``avg_sent_gb`` over its rounds; ``packed_copy_bytes`` and
    ``tree_wire_bytes`` its per-copy bytes.  The split moves none of
    them.  The ragged paths' split has a node under one batch (the loop
    engine), the others every node at one batch or more."""
    smoke = _chip_smoke_module()
    model, _, wire, rounds, want = smoke.PATHS[name]
    split = smoke.PATH_SPLIT[name]
    n = smoke.N_NODES
    jspec = JWireSpec.parse(wire)
    fed = dict(smoke.PATH_FED.get(name, {}))
    cfg = jbase.get_config(model)
    scfg = jmodel.derive_student(cfg)
    ncls, pdim = cfg.num_classes, cfg.proto_dim
    jpay = {"model": jax.eval_shape(lambda: jmodel.init_params(
        scfg, jax.random.PRNGKey(0))),
        "protos": jax.ShapeDtypeStruct((ncls, pdim), np.dtype(np.float32)),
        "counts": jax.ShapeDtypeStruct((ncls,), np.dtype(np.float32))}
    if fed.get("adapter_rank"):
        from repro.core import adapters as jadapters
        layout = jadapters.adapter_layout(jpay["model"], fed["adapter_rank"])
        jpay.update(jadapters.adapter_payload_template(layout, grams=False))
        jpay["model"] = jadapters.split_student(layout, jpay["model"])[1]
    from repro.core import topology as jtopo
    from repro.core import quantization as jquant
    sched = jtopo.make_schedule(n, "full", rounds=rounds)
    edge = jcomm.CommMeter(n)
    acct = jcomm.ScheduleCommAccountant(sched)
    for rnd in range(rounds):
        adj = sched.adjacency_at(rnd)
        for i in range(n):
            edge.record_broadcast(i, jtopo.neighbors(adj, i), jpay, "profe",
                                  rnd, jspec)
        acct.record_round(jpay, "profe", rnd, jspec)
    assert edge.avg_sent_gb() == acct.avg_sent_gb() == want[0]
    assert jcomm.packed_copy_bytes(jpay, jspec) == want[1]
    assert jquant.tree_wire_bytes(jpay, jspec) == want[2]
    # the split: the loop engine exactly where a node is under one batch
    data = make_image_dataset(0, 7040, smoke.IMAGE_SHAPE[model], 10)
    train_d, _ = train_test_split(data, 1 / 11, 0)
    parts = partition(train_d["label"], n,
                      "iid" if split == "ragged" else split, 0)
    sizes = [len(p) for p in parts]
    if split == "ragged":
        sizes[0] = smoke.RAGGED_IMAGES
    assert (min(sizes) < 32) == (split == "ragged")
    batches_a_node = sorted(s // 32 for s in sizes)
    if split == "noniid40":
        assert (batches_a_node[0], batches_a_node[-1]) == (7, 12)
    elif split == "dirichlet":
        assert (batches_a_node[0], batches_a_node[-1]) == (4, 19)
