"""Error feedback on a tree payload in the port, held against the JAX
package on the CPU: the stateful tree codec, the adapter merge off the
plane, and whole runs of the adapter wire with ``+ef`` and of a per-leaf
student with ``+ef`` or on the adapter wire, on both engines.

What is compared, and how:

* the stateful tree codec (``quantize_tree_packed_nodes(residual=)``,
  ``quantize_dequantize_tree_packed_nodes(residual=)`` and
  ``round_ops.quantize_dequantize_per_node(state=)``) on the adapter
  payload and on a per-leaf student's ``{protos, student}``: codes,
  scales, the reconstruction and the new residual bit for bit against
  ``repro``'s eager chain (``use_kernels=False``, not jitted: the jitted
  chain contracts ``eff - codes·Δ`` into an FMA on XLA:CPU).  The port's
  round trip, through the buffer, equals ``repro``'s leaf-local one bit
  for bit, and a residual of another layout raises;
* ``adapter_apply_tree`` against ``repro``'s (``rtol=1e-6``, ``atol``
  1e-6 of the largest delta entry, as ``tests/test_torch_adapters.py``
  holds ``lowrank_apply``: XLA sums each ``B @ A`` in its own order);
* whole 2-round runs on a small mnist-cnn (channels (4, 8), proto_dim
  16, fp32; its student factors fc1 and fc2 at rank 8), 3 nodes on a
  ring, from ``repro``'s own initial states carried through numpy, on
  the stacked engine (``run_federation``) and the per-node loop engine
  (``run_federation_loop``): every byte extra exactly, per-round F1 and
  accuracy exactly, every node's student after every round (read where
  both engines evaluate it) to ``atol=2e-5`` but for at most
  ``MAX_EPS_ELEMENTS`` parameters, each within ``atol + 2·lr`` (the rule
  of ``tests/test_torch_baselines.py``); a RegMean run to that ``atol``
  plus ``REGMEAN_RTOL`` of the round's largest step (the ridge solve
  amplifies last-bit gaps up to ~1e3, ``tests/test_torch_adapters.py``);
  ``seq`` exactly;
* a checkpoint of the ``adapters8+ef`` state after round 1 (a tree
  residual and the adapter state), resumed for round 2, bit-identical to
  the uninterrupted run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import adapters as JA
from repro.core import federation as JF
from repro.core import round_ops as jround
from repro.core.wire_state import CodecState as JCodecState
from repro.kernels.lowrank_apply import ops as jlow_ops
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import base as tbase
from repro_torch.core import adapters as TA
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import round_ops as tround
from repro_torch.core.wire_state import CodecState, init_codec_state
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels.lowrank_apply import ops as tlow_ops
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.tree import keyed_leaves, tree_leaves, tree_paths
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

N_NODES = 3
MAX_EPS_ELEMENTS = 2
LR = 1e-3
ATOL = 2e-5
REGMEAN_RTOL = 1e-3


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _to(tree, fn):
    return jax.tree_util.tree_map(fn, tree)


def _payload(kind, seed, n=N_NODES):
    """A stacked wire payload and a residual of the size error feedback
    leaves: the adapter wire's (factors of a conv and a matrix leaf,
    grams, the dense rest, prototypes) or a per-leaf student's
    ``{protos, student}`` (with an empty subtree)."""
    rng = np.random.default_rng(seed)
    if kind == "adapters":
        pay = {"adapters": {
            "['conv2']['kernel']": {"A": _normal(rng, n, 3, 3, 8, 16),
                                    "B": _normal(rng, n, 3, 3, 12, 8)},
            "['fc1']['kernel']": {"A": _normal(rng, n, 8, 16),
                                  "B": _normal(rng, n, 300, 8)}},
            "grams": {"['conv2']['kernel']": _normal(rng, n, 3, 3, 16, 16),
                      "['fc1']['kernel']": _normal(rng, n, 16, 16)},
            "protos": _normal(rng, n, 10, 16, scale=0.1),
            "student": {"['conv1']['bias']": _normal(rng, n, 12),
                        "['fc1']['bias']": _normal(rng, n, 16) * 0}}
    else:
        pay = {"protos": _normal(rng, n, 10, 16, scale=0.1),
               "student": {"w": _normal(rng, n, 33, 20),
                           "b": _normal(rng, n, 7),
                           "rem": []}}
    res = jax.tree_util.tree_map(lambda x: x * np.float32(1e-2) *
                                 _normal(rng, *x.shape), pay)
    return pay, res


CODEC_CASES = {
    "adapters8+ef": ("adapters", "4,adapters=8+ef", 1.0),
    "4/16+ef/per-leaf": ("per-leaf", "4/16+ef", 1.0),
    "4/16+ef/per-leaf/decay0.5": ("per-leaf", "4/16+ef", 0.5),
    "16+ef/adapters": ("adapters", "16+ef", 1.0),
}


def _specs(wire, decay):
    j, t = JWireSpec.parse(wire), WireSpec.parse(wire)
    return (dataclasses.replace(j, ef_decay=decay),
            dataclasses.replace(t, ef_decay=decay))


def _assert_trees_equal(t, j):
    tl = tree_paths(t)
    jl = jax.tree_util.tree_flatten_with_path(j)[0]
    assert len(tl) == len(jl)
    for (_, a), (_, b) in zip(tl, jl):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_stateful_tree_codec_matches_jax_bit_for_bit(name):
    """Codes, scales, the reconstruction and the new residual of the
    stateful tree codec against ``repro``'s eager chain; the port's
    round trip (the buffer) against ``repro``'s leaf-local one; the
    per-node entry point with a ``CodecState``."""
    kind, wire, decay = CODEC_CASES[name]
    pay, res = _payload(kind, 11)
    jspec, tspec = _specs(wire, decay)
    bits = tspec.uniform_bits or 16
    jpay = jqops.quantize_tree_packed_nodes(
        _to(pay, jnp.asarray), bits, spec=jspec, use_kernels=False,
        residual=_to(res, jnp.asarray))
    tpay = tqops.quantize_tree_packed_nodes(_to(pay, _t), bits, spec=tspec,
                                            residual=_to(res, _t))
    for key in ("codes", "scales"):
        np.testing.assert_array_equal(_np(tpay[key]), np.asarray(jpay[key]))
    np.testing.assert_array_equal(tpay["seg_ids"], jpay["seg_ids"])
    _assert_trees_equal(tpay["ef_residual"], jpay["ef_residual"])
    assert float(max(x.abs().max() for x in tree_leaves(
        tpay["ef_residual"]))) > 0
    # the receiver's view: the buffer, and repro's leaf-local round trip
    trecv = tqops.dequantize_tree_packed_nodes(tpay)
    jrecv = jqops.dequantize_tree_packed_nodes(jpay)
    _assert_trees_equal(trecv, jrecv)
    trt, trt_res = tqops.quantize_dequantize_tree_packed_nodes(
        _to(pay, _t), bits, spec=tspec, residual=_to(res, _t))
    jrt, jrt_res = jqops.quantize_dequantize_tree_packed_nodes(
        _to(pay, jnp.asarray), bits, spec=jspec, use_kernels=False,
        residual=_to(res, jnp.asarray))
    _assert_trees_equal(trt, jrt)
    _assert_trees_equal(trt_res, jrt_res)
    if kind == "per-leaf":
        assert trt["student"]["rem"] == [] and \
            trt_res["student"]["rem"] == []
    # the per-node entry point, as the stacked engine calls it
    jgot, jstate = jround.quantize_dequantize_per_node(
        _to(pay, jnp.asarray), spec=jspec, use_kernels=False,
        state=JCodecState(_to(res, jnp.asarray), jnp.zeros((N_NODES,),
                                                            jnp.int32)))
    tgot, tstate = tround.quantize_dequantize_per_node(
        _to(pay, _t), spec=tspec,
        state=CodecState(_to(res, _t), torch.zeros(N_NODES,
                                                   dtype=torch.int32)))
    _assert_trees_equal(tgot, jgot)
    _assert_trees_equal(tstate.residual, jstate.residual)
    assert tstate.seq.tolist() == np.asarray(jstate.seq).tolist() == \
        [1] * N_NODES


def test_stateful_tree_codec_refuses_a_mismatched_residual():
    """A residual of another layout raises in the codec and in its round
    trip alike; an error-feedback spec with no residual raises."""
    pay, res = _payload("per-leaf", 12)
    spec = WireSpec.parse("4/16+ef")
    short = {"protos": _t(res["protos"]),
             "student": {"w": _t(res["student"]["w"])}}
    wide = _to(res, _t)
    wide["student"]["w"] = torch.zeros(N_NODES, 33, 21)
    for bad in (short, wide):
        with pytest.raises(ValueError, match="residual"):
            tqops.quantize_tree_packed_nodes(_to(pay, _t), spec=spec,
                                             residual=bad)
        with pytest.raises(ValueError, match="residual"):
            tqops.quantize_dequantize_tree_packed_nodes(_to(pay, _t),
                                                        spec=spec,
                                                        residual=bad)
    with pytest.raises(ValueError, match="error_feedback"):
        tqops.quantize_dequantize_tree_packed_nodes(_to(pay, _t), spec=spec)
    with pytest.raises(ValueError, match="CodecState"):
        tround.quantize_dequantize_per_node(_to(pay, _t), spec=spec)


def test_init_codec_state_mirrors_a_tree_payload():
    """Zero fp32 residuals for every float leaf, None for a non-float
    one, the empty subtrees kept, an ``[N]`` zero ``seq``."""
    pay, _ = _payload("per-leaf", 13)
    tpay = _to(pay, _t)
    tpay["student"]["steps"] = torch.zeros(N_NODES, dtype=torch.int32)
    st = init_codec_state(tpay, N_NODES)
    assert st.seq.tolist() == [0] * N_NODES
    assert st.residual["student"]["rem"] == []
    assert st.residual["student"]["steps"] is None
    for (p, r), (q, x) in zip(tree_paths(st.residual), tree_paths(tpay)):
        assert p == q
        if r is not None:
            assert r.dtype == torch.float32 and not r.any()
            assert r.shape == x.shape


@pytest.mark.parametrize("per_recv", [False, True], ids=["naive", "regmean"])
def test_adapter_apply_tree_matches_jax(per_recv):
    """The merge on a per-leaf student tree: the matrix leaves through
    ``lowrank_apply``, the rest replaced by its mixed value."""
    rng = np.random.default_rng(14)
    n = N_NODES
    tree = {"conv": {"kernel": _normal(rng, n, 3, 3, 12, 16),
                     "bias": _normal(rng, n, 16)},
            "fc": {"kernel": _normal(rng, n, 40, 24)}, "rem": []}
    jlayout = JA.adapter_layout(_to(tree, jnp.asarray), 8, node_axis=True)
    tlayout = TA.adapter_layout(_to(tree, _t), 8, node_axis=True)
    assert tlayout.names == jlayout.names
    coeffs = np.abs(_normal(rng, n, n)) / n
    factors = {}
    for name, shape, m in zip(tlayout.names, tlayout.shapes,
                              tlayout.is_mat):
        if m:
            lead, (d, k) = shape[:-2], shape[-2:]
            a_lead = (n, n) if per_recv else (n,)
            factors[name] = {"A": _normal(rng, *a_lead, *lead, 8, k),
                             "B": _normal(rng, n, *lead, d, 8)}
    rest = {"['conv']['bias']": _normal(rng, n, 16)}
    jout = jlow_ops.adapter_apply_tree(
        _to(tree, jnp.asarray), jlayout, jnp.asarray(coeffs),
        _to(factors, jnp.asarray), _to(rest, jnp.asarray))
    tout = tlow_ops.adapter_apply_tree(_to(tree, _t), tlayout, _t(coeffs),
                                       _to(factors, _t), _to(rest, _t))
    assert tout["rem"] == []
    assert torch.equal(tout["conv"]["bias"], _t(rest["['conv']['bias']"]))
    for key in (("conv", "kernel"), ("fc", "kernel")):
        got = _np(tout[key[0]][key[1]])
        want = np.asarray(jout[key[0]][key[1]])
        delta = np.abs(want - tree[key[0]][key[1]]).max()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * delta)


# -- whole runs ----------------------------------------------------------------

RUNS = {"adapters8+ef": dict(quantize_bits=4, adapter_rank=8,
                             error_feedback=True),
        "adapters8+grams+ef": dict(quantize_bits=4, adapter_rank=8,
                                   adapter_grams=True, error_feedback=True),
        "4/16+ef/per-leaf": dict(quantize_bits=4, proto_quantize_bits=16,
                                 error_feedback=True, param_plane="off"),
        "adapters8/per-leaf": dict(quantize_bits=4, adapter_rank=8,
                                   param_plane="off")}


def _setup(name, rounds=2, per_node=56, batch=16):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32")
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    kw = dict(num_nodes=N_NODES, rounds=rounds, topology="ring", **RUNS[name])
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tcfg, node_data, test_d, jbase.FederationConfig(**kw),
            tbase.FederationConfig(**kw), jbase.TrainConfig(**train_kw),
            tbase.TrainConfig(**train_kw))


def _jax_states(jcfg, jfed, jtrain):
    scfg = jmodel.derive_student(jcfg)
    plane = JF._plane_mode(jfed, jtrain, "profe", scfg)
    opt_t = jmake_optimizer("adamw", jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    opt_s = jplane.make_plane_optimizer(
        "adamw", jtrain.learning_rate, weight_decay=jtrain.weight_decay,
        grad_clip=jtrain.grad_clip) if plane else opt_t
    return JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                           plane=plane), plane


def _carry(st, plane):
    return tprofe.node_state_from_numpy(
        _to(jplane.as_tree(st.student), np.asarray),
        _to(st.teacher, np.asarray), _to(st.opt_s, np.asarray),
        _to(st.opt_t, np.asarray), np.asarray(st.global_protos),
        np.asarray(st.proto_mask), int(st.round_idx), plane=plane,
        device="cpu")


def _recording_eval(pkg, rounds, leaves):
    """Record every round's students of every node, as both engines
    evaluate them."""
    inner = pkg._eval_nodes

    def eval_nodes(eval_cfg, students_of, n_nodes, *args, **kwargs):
        rounds.append([[_np(x) for x in leaves(students_of(i))]
                       for i in range(n_nodes)])
        return inner(eval_cfg, students_of, n_nodes, *args, **kwargs)
    return eval_nodes


def _assert_students_close(t_rounds, j_rounds, before, regmean: bool):
    assert len(t_rounds) == len(j_rounds) == 2
    for t_nodes, j_nodes in zip(t_rounds, j_rounds):
        step = max(float(np.abs(b - p).max())
                   for j, q in zip(j_nodes, before) for b, p in zip(j, q))
        atol = ATOL + (REGMEAN_RTOL * step if regmean else 0.0)
        beyond, gap = 0, 0.0
        for t, j in zip(t_nodes, j_nodes):
            assert len(t) == len(j) > 0
            for a, b in zip(t, j):
                d = np.abs(a.reshape(b.shape) - b)
                beyond += int(np.count_nonzero(d > atol))
                gap = max(gap, float(d.max(initial=0.0)))
        assert beyond <= MAX_EPS_ELEMENTS and gap <= atol + 2 * LR, \
            (beyond, gap)
        before = j_nodes


@pytest.mark.parametrize("engine", ["stacked", "loop"])
@pytest.mark.parametrize("name", list(RUNS))
def test_run_matches_jax(name, engine, monkeypatch):
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(name)
    jrounds, trounds = [], []
    monkeypatch.setattr(JF, "_eval_nodes", _recording_eval(
        JF, jrounds, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_eval_nodes", _recording_eval(
        TF, trounds, tree_leaves))
    run = {"stacked": "run_federation", "loop": "run_federation_loop"}[engine]
    jres = getattr(JF, run)(jcfg, jfed, jtrain, node_data, test_d)
    jstates, plane = _jax_states(jcfg, jfed, jtrain)
    assert plane == (tfed.param_plane != "off")
    tres = getattr(TF, run)(tcfg, tfed, ttrain, node_data, test_d,
                            initial_states=[_carry(s, plane)
                                            for s in jstates],
                            device="cpu")
    assert tres.extras["param_plane"] is jres.extras["param_plane"] is plane
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    before = [[_np(x) for x in tree_leaves(_carry(s, False).student)]
              for s in jstates]
    _assert_students_close(trounds, jrounds, before,
                           regmean=bool(tfed.adapter_grams))
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round
    if tfed.error_feedback:
        ws = tres.extras["wire_state"]
        assert ws.seq.tolist() == [2] * N_NODES
        assert all(bool(torch.isfinite(r).all())
                   for r in tree_leaves(ws.residual) if r is not None)
        if tfed.adapter_rank:
            # the residual mirrors the adapter payload, not the student
            assert sorted(ws.residual) == sorted(
                ["adapters", "protos", "student"] +
                (["grams"] if tfed.adapter_grams else []))
    if tfed.adapter_rank:
        f = tres.extras["adapter_factors"]
        assert len(f) == 2 and all(float(x["A"].abs().max()) > 0
                                   for x in f.values())


def _bits(x) -> bytes:
    x = x.detach().cpu().contiguous()
    return x.view(torch.uint8).numpy().tobytes() if x.numel() else b""


def test_adapters8_ef_resumes_from_a_checkpoint_bit_for_bit(tmp_path):
    """Round 1 of the ``adapters8+ef`` run, saved (its tree residual, the
    adapter references), restored and resumed for round 2
    (``start_round=1``), ends bit-identical to the uninterrupted run."""
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup("adapters8+ef")
    full = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             device="cpu")
    one = TF.run_federation(tcfg, dataclasses.replace(tfed, rounds=1),
                            ttrain, node_data, test_d, device="cpu")
    path = str(tmp_path / "round1")
    save_checkpoint(path, one.state, metadata={"round": 1})
    restored = load_checkpoint(path, one.state)
    for (ka, a), (kb, b) in zip(keyed_leaves(restored),
                                keyed_leaves(one.state)):
        assert ka == kb and _bits(a) == _bits(b), ka
    assert any(".wire_state/.residual/adapters" in k
               for k, _ in keyed_leaves(restored))
    resumed = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                                initial_states=restored, start_round=1,
                                device="cpu")
    for (ka, a), (kb, b) in zip(keyed_leaves(resumed.state),
                                keyed_leaves(full.state)):
        assert ka == kb and _bits(a) == _bits(b), ka
    assert resumed.f1_per_round == full.f1_per_round[1:]
    assert resumed.state.wire_state.seq.tolist() == [2] * N_NODES


def test_node_state_from_numpy_carries_tree_residuals_and_adapter_state():
    """A per-leaf student's residual tree and the adapter wire's
    (``repro``'s ``zero_wire_payload`` shape) with its adapter state,
    carried from numpy as fp32 tensors, stack into the engine's state."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, _ = _setup(
        "adapters8/per-leaf")
    jstates, plane = _jax_states(jcfg, jfed, jtrain)
    st = jstates[0]
    layout = JA.adapter_layout(st.student, 8)
    ast = JA.init_adapter_state(layout, st.student, grams=True)
    res = {"protos": np.ones((10, 16), np.float32)}
    res.update(_to(JA.zero_wire_payload(layout, st.student, grams=True),
                   np.asarray))
    carried = tprofe.node_state_from_numpy(
        _to(st.student, np.asarray), _to(st.teacher, np.asarray),
        _to(st.opt_s, np.asarray), _to(st.opt_t, np.asarray),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        plane=False, residual=res, seq=3,
        adapter_state=_to(ast, np.asarray), device="cpu")
    ws = carried.wire_state
    assert ws.seq.tolist() == 3 and sorted(ws.residual) == \
        ["adapters", "grams", "protos", "student"]
    assert torch.equal(ws.residual["protos"], torch.ones(10, 16))
    for (p, a), (q, b) in zip(
            tree_paths(carried.adapter_state),
            jax.tree_util.tree_flatten_with_path(ast)[0]):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    stacked = tprofe.stack_states([carried, carried])
    assert stacked.wire_state.seq.tolist() == [3, 3]
    assert stacked.wire_state.residual["protos"].shape == (2, 10, 16)
    assert stacked.adapter_state["grams"]["['fc1']['kernel']"].shape[0] == 2


# -- chip_smoke.py's new paths ---------------------------------------------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NEW_PATHS = ("adapters8+ef", "adapters8+grams+ef", "4/16+ef/per-leaf",
             "adapters8/per-leaf", "adapters8+ef/ragged")


@pytest.mark.parametrize("name", NEW_PATHS)
def test_chip_smoke_new_paths_match_jax(name):
    """The N = 20 constants ``chip_smoke.py`` holds each new phase-10 path
    to (``avg_sent_gb`` over its rounds, ``packed_copy_bytes``,
    ``tree_wire_bytes``) against the JAX package's accountants on its
    engine's payload template at mnist-cnn's full width; and the path's
    ``FederationConfig`` fields make the wire spec it names on both
    packages."""
    import types

    from repro.core import comm as jcomm
    from repro.core import quantization as jquant
    from repro.core import topology as jtopo
    smoke = _chip_smoke()
    model, _, wire, rounds, want = smoke.PATHS[name]
    fed_kw = dict(smoke.PATH_FED[name])
    fed_kw.update(smoke.wire_fields(smoke.parse_wire(wire)))
    jcfg = jbase.get_config(model)
    scfg = jmodel.derive_student(jcfg)
    jfed = jbase.FederationConfig(num_nodes=smoke.N_NODES, rounds=rounds,
                                  topology="full", **fed_kw)
    tfed = tbase.FederationConfig(num_nodes=smoke.N_NODES, rounds=rounds,
                                  topology="full", **fed_kw)
    jtrain = jbase.TrainConfig()
    plane = JF._plane_mode(jfed, jtrain, "profe", scfg)
    assert plane == (fed_kw.get("param_plane") != "off")
    opt_t = jmake_optimizer("adamw", 1e-3)
    opt_s = jplane.make_plane_optimizer("adamw", 1e-3) if plane else opt_t
    _, wm, share, jbits, cfgs = JF._algo_wiring(
        "profe", jcfg, scfg, jfed, jtrain, opt_s, opt_t, jit=False)
    _, _, _, tbits, _ = TF._algo_wiring(
        "profe", tbase.ModelConfig(**dataclasses.asdict(jcfg)),
        tbase.ModelConfig(**dataclasses.asdict(scfg)), tfed,
        tbase.TrainConfig(), None, None)
    assert tbits == WireSpec.parse(wire)
    assert jbits.describe() == tbits.describe()
    st = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype),
        jax.eval_shape(lambda: jmodel.init_params(cfgs[1],
                                                  jax.random.PRNGKey(0))))
    pay = JF._payload_template(wm, share, types.SimpleNamespace(student=st),
                               jcfg.num_classes, cfgs[1].proto_dim,
                               adapter_rank=jfed.adapter_rank,
                               adapter_grams=jfed.adapter_grams)
    meter = jcomm.ScheduleCommAccountant(
        jtopo.make_schedule(smoke.N_NODES, "full", rounds=rounds))
    for r in range(rounds):
        meter.record_round(pay, "profe", r, jbits)
    assert (meter.avg_sent_gb(), jcomm.packed_copy_bytes(pay, jbits),
            jquant.tree_wire_bytes(pay, jbits)) == want
    assert smoke.PATH_SPLIT.get(name, "iid") == (
        "ragged" if name.endswith("/ragged") else "iid")
