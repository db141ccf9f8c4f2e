"""Error feedback on a tree payload in the port against the JAX package on
the CPU: the stateful tree codec, the adapter merge off the plane, whole
runs of a per-leaf student with ``+ef`` or on the adapter wire on both
engines, the resume from a checkpoint and ``chip_smoke.py``'s paths.

The helpers and the tolerances, with their reasons, are in
``tests/torch_tree_ef_helpers.py``.
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
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import base as tbase
from repro_torch.core import adapters as TA
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import round_ops as tround
from repro_torch.core.wire_state import CodecState, init_codec_state
from repro_torch.kernels.lowrank_apply import ops as tlow_ops
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.tree import keyed_leaves, tree_leaves, tree_paths
from repro_torch.wirespec import WireSpec

from torch_tree_ef_helpers import (CODEC_CASES, NEW_PATHS, N_NODES, RUNS,
                                   _assert_trees_equal, _bits, _chip_smoke,
                                   _jax_states, _normal, _np, _payload,
                                   _setup, _specs, _t, _to, check_run)

torch.set_num_threads(2)

RUN_NAMES = tuple(k for k in RUNS if "per-leaf" in k)


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


@pytest.mark.parametrize("engine", ["stacked", "loop"])
@pytest.mark.parametrize("name", list(RUN_NAMES))
def test_run_matches_jax(name, engine, monkeypatch):
    check_run(name, engine, monkeypatch)


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
