"""The port's slice as a whole, held against the JAX package on the CPU:
the stacked ProFe round program driven for 2 rounds, and a 2-round
``run_federation``, both started from weights carried over from
``repro``.

The round programs run under an fp32 ``dtype`` override with
``run_federation``'s per-round staging (training seeds
``seed + rnd*997 + i``, the proto stream ``[seed + rnd]*N``, the
schedule slice of each round), so the two frameworks differ only in
summation order.  After each round: the mixed student plane and the
teacher to ``atol=2e-5`` (Adam steps of ``lr=1e-3`` that agree to a few
ulp, plus a 16-bit wire code that may flip by one where the two trained
students straddle a rounding boundary: one Δ ≈ 3e-6, weighted by the
gossip weight); Eq. 4 prototypes to ``atol=1e-4``; the Adam moments to
``atol=1e-6`` (mu) and ``1e-8`` (nu); masks, round counters and step
counters exactly; node 0's test logits to ``atol=1e-5`` and its
predictions exactly.  Whole runs: the wire bytes exactly; per-round
node-0 macro-F1 and accuracy exactly in fp32, and accuracy within one of
the 64 test predictions in the default bf16 (the two frameworks round
bf16 convolutions differently).
"""
import ast
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import comm as jcomm
from repro.core import distillation as jdist
from repro.core import federation as JF
from repro.core import quantization as jquant
from repro.core import topology as jtopo
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.models import forward, init_params
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
from repro_torch.tree import tree_leaves
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(st):
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), device="cpu")


def _setup(rounds=2, per_node=56, batch=16, dtype="float32"):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype=dtype)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed_kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full")
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tcfg, node_data, test_d,
            jbase.FederationConfig(**fed_kw), tbase.FederationConfig(**fed_kw),
            jbase.TrainConfig(**train_kw), tbase.TrainConfig(**train_kw))


def _jax_states(jcfg, jfed, jtrain):
    """The per-node states JAX's run_federation initializes itself."""
    scfg = jmodel.derive_student(jcfg)
    opt_s = jplane.make_plane_optimizer("adamw", jtrain.learning_rate,
                                        weight_decay=jtrain.weight_decay,
                                        grad_clip=jtrain.grad_clip)
    opt_t = jmake_optimizer("adamw", jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    states = JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                             plane=True)
    return scfg, opt_s, opt_t, states


def _snapshot(state, logits, leaves):
    """numpy copies of a stacked state (the port updates in place)."""
    def a(x):
        return np.array(x.detach() if isinstance(x, torch.Tensor) else x)
    return {"student": a(state.student.buf),
            "teacher": [a(x) for x in leaves(state.teacher)],
            "mu_s": a(state.opt_s["mu"]), "nu_s": a(state.opt_s["nu"]),
            "mu_t": [a(x) for x in leaves(state.opt_t["mu"])],
            "nu_t": [a(x) for x in leaves(state.opt_t["nu"])],
            "steps": (int(np.ravel(a(state.opt_s["step"]))[0]),
                      int(np.ravel(a(state.opt_t["step"]))[0])),
            "global_protos": a(state.global_protos),
            "proto_mask": a(state.proto_mask),
            "round_idx": a(state.round_idx).tolist(),
            "logits": np.asarray(logits, np.float32)}


@pytest.fixture(scope="module")
def two_rounds():
    """Both packages' round programs, driven for 2 rounds from the same
    carried states as ``run_federation`` stages them; per-round
    snapshots ``(port, jax)`` plus the batches each staged."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup()
    scfg, j_opt_s, j_opt_t, jstates = _jax_states(jcfg, jfed, jtrain)
    step, wire_model, share, bits, _ = JF._algo_wiring(
        "profe", jcfg, scfg, jfed, jtrain, j_opt_s, j_opt_t, jit=False)
    j_round = JF._make_round_fn(step, scfg, 10, share_protos=share,
                                wire_model=wire_model, bits=bits)
    t_opt_s = make_plane_optimizer("adamw", ttrain.learning_rate,
                                   grad_clip=ttrain.grad_clip)
    t_opt_t = make_optimizer("adamw", ttrain.learning_rate)
    tscfg = tbase.ModelConfig(**dataclasses.asdict(scfg))
    tstep, _, _, tbits, _ = TF._algo_wiring("profe", tcfg, tscfg, tfed,
                                            ttrain, t_opt_s, t_opt_t)
    t_round = TF._make_round_fn(tstep, tscfg, 10, bits=tbits)

    sizes = [len(d["label"]) for d in node_data]
    jsched = jtopo.make_schedule(N_NODES, jfed.topology, rounds=jfed.rounds,
                                 seed=jfed.seed)
    jw = jsched.lower(sizes)
    tw = [torch.from_numpy(x) for x in ttopo.make_schedule(
        N_NODES, tfed.topology, rounds=tfed.rounds, seed=tfed.seed
    ).lower(sizes)]
    jst = JF._stack_states(jstates)
    tst = tprofe.stack_states([_carry(s) for s in jstates])
    jtest = {k: jnp.asarray(v) for k, v in test_d.items()}
    ttest = {k: torch.from_numpy(v) for k, v in test_d.items()}

    rounds, staged_pairs = [], []
    for rnd in range(jfed.rounds):
        t_on = jdist.teacher_active(jfed.alpha_s, jfed.alpha_limit, rnd)
        seeds = [jfed.seed + rnd * 997 + i for i in range(N_NODES)]
        proto_seeds = [jfed.seed + rnd] * N_NODES
        js = JF._stack_round_batches(node_data, jtrain.batch_size, seeds,
                                     jfed.local_epochs)
        jp = JF._stack_round_batches(node_data, jtrain.batch_size,
                                     proto_seeds, 1)
        ts = TF._stack_round_batches(node_data, ttrain.batch_size, seeds,
                                     tfed.local_epochs)
        tp = TF._stack_round_batches(node_data, ttrain.batch_size,
                                     proto_seeds, 1)
        staged_pairs.append(((ts, tp), (js, jp)))
        p = jsched.phase_index(rnd)
        jst = j_round(jst, *js, *jp, jw[0][p], jw[1][p], jw[2][p],
                      teacher_on=t_on, all_valid=True)
        tst = t_round(tst, *TF._to_device(ts, "cpu"),
                      *TF._to_device(tp, "cpu"), tw[0][p], tw[1][p],
                      tw[2][p], teacher_on=t_on, all_valid=True)
        j_logits = jmodel.forward(
            scfg, jax.tree_util.tree_map(lambda x: x[0],
                                         jplane.as_tree(jst.student)),
            jtest, remat=False).logits
        with torch.no_grad():
            t_logits = forward(tscfg, as_tree(Plane(tst.student.buf[0],
                                                    tst.student.meta)),
                               ttest).logits
        rounds.append((_snapshot(tst, t_logits, tree_leaves),
                       _snapshot(jst, j_logits, jax.tree_util.tree_leaves)))
    return rounds, staged_pairs, tst.student.meta


def _assert_round_matches(t, j):
    np.testing.assert_allclose(t["student"], j["student"], rtol=0, atol=2e-5)
    assert len(t["teacher"]) == len(j["teacher"])
    for a, b in zip(t["teacher"], j["teacher"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(t["mu_s"], j["mu_s"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["nu_s"], j["nu_s"], rtol=0, atol=1e-8)
    for a, b in zip(t["mu_t"] + t["nu_t"], j["mu_t"] + j["nu_t"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
    assert t["round_idx"] == j["round_idx"]
    assert t["steps"] == j["steps"]
    np.testing.assert_allclose(t["logits"], j["logits"], rtol=0, atol=1e-5)
    assert (t["logits"].argmax(-1) == j["logits"].argmax(-1)).all()


def test_one_round_matches_the_jax_round_program(two_rounds):
    rounds, staged_pairs, meta = two_rounds
    (ts, tp), (js, jp) = staged_pairs[0]
    for a, b in zip(jax.tree_util.tree_leaves((ts, tp)),
                    jax.tree_util.tree_leaves((js, jp))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    t, j = rounds[0]
    _assert_round_matches(t, j)
    assert t["round_idx"] == [1] * N_NODES
    assert t["steps"] == (3, 3)
    # padding lanes of the mixed plane stay exactly zero
    real = np.zeros(t["student"].shape[1:], dtype=bool)
    for _, _, shape, row, r_leaf in meta.recipe:
        real[row:row + r_leaf].reshape(-1)[:int(np.prod(shape))] = True
    assert not t["student"][:, ~real].any()


def test_two_rounds_match_the_jax_round_program(two_rounds):
    """Round 2 runs on round 1's state: the per-round training and proto
    stream seeds, step counters and bias corrections past the first
    round, the teacher gate and round 1's Eq. 4 prototypes and mask."""
    rounds, staged_pairs, _ = two_rounds
    (ts, tp), (js, jp) = staged_pairs[1]
    for a, b in zip(jax.tree_util.tree_leaves((ts, tp)),
                    jax.tree_util.tree_leaves((js, jp))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # round 2 draws other batches than round 1
    assert np.asarray(ts[0]["label"]).tobytes() != \
        np.asarray(staged_pairs[0][0][0][0]["label"]).tobytes()
    t1, j1 = rounds[0]
    assert j1["proto_mask"].any()       # round 2 trains against Eq. 4
    t, j = rounds[1]
    _assert_round_matches(t, j)
    assert t["round_idx"] == [2] * N_NODES
    assert t["steps"] == (6, 6)


def _recording(make_round_fn, calls, leaves):
    """Wrap a package's ``_make_round_fn`` so that every round
    ``run_federation`` drives is recorded: its staged inputs, flags and
    (copied) output state."""
    def make(*args, **kwargs):
        fn = make_round_fn(*args, **kwargs)

        def round_fn(state, *inputs, teacher_on, all_valid=False):
            out = fn(state, *inputs, teacher_on=teacher_on,
                     all_valid=all_valid)
            calls.append({
                "inputs": [np.array(x) for x in
                           jax.tree_util.tree_leaves(inputs)],
                "flags": (teacher_on, all_valid),
                "state": _snapshot(out, np.zeros(()), leaves)})
            return out
        return round_fn
    return make


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_federation_matches_jax_from_carried_states(dtype, monkeypatch):
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        dtype=dtype)
    jcalls, tcalls = [], []
    monkeypatch.setattr(JF, "_make_round_fn", _recording(
        JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_make_round_fn", _recording(
        TF._make_round_fn, tcalls, tree_leaves))
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
    _, _, _, jstates = _jax_states(jcfg, jfed, jtrain)
    tres = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             initial_states=[_carry(s) for s in jstates],
                             device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    assert tres.comm.summary() == jres.comm.summary()
    # every round: the same staged batches, proto stream, schedule slice
    # and flags, so run_federation's own per-round staging agrees
    assert len(tcalls) == len(jcalls) == 2
    for t, j in zip(tcalls, jcalls):
        assert t["flags"] == j["flags"]
        # image, label, valid; proto image, label, valid; 3 matrices
        assert len(t["inputs"]) == len(j["inputs"]) == 9
        for a, b in zip(t["inputs"], j["inputs"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert len(tres.f1_per_round) == len(jres.f1_per_round) == 2
    if dtype == "float32":
        for t, j in zip(tcalls, jcalls):
            t["state"]["logits"] = j["state"]["logits"]
            _assert_round_matches(t["state"], j["state"])
        assert tres.f1_per_round == jres.f1_per_round
        assert tres.acc_per_round == jres.acc_per_round
    else:
        n_test = len(test_d["label"])
        np.testing.assert_allclose(tres.acc_per_round, jres.acc_per_round,
                                   rtol=0, atol=1 / n_test + 1e-12)


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_federation_full_width_bytes_match_jax_accounting():
    """The 20-node mnist-cnn wire numbers chip_smoke.py holds the card
    run to: the port's accountants and the JAX package's, from the same
    payload template shapes, equal each other and the script's
    constants."""
    smoke = _chip_smoke_module()
    n, rounds = smoke.N_NODES, smoke.ROUNDS
    cfg = tbase.get_config("mnist-cnn")
    student = plane_from_tree(init_params(TF.derive_student(cfg),
                                          torch.Generator().manual_seed(0)))
    state = tprofe.NodeState(student, None, None, None, None, None, None)
    tpay = TF._payload_template("student", True, state, 10, 128)
    tmeter = TF.ScheduleCommAccountant(ttopo.make_schedule(n, "full",
                                                           rounds=rounds))
    for r in range(rounds):
        tmeter.record_round(tpay, "profe", r, WireSpec(16))

    jscfg = jmodel.derive_student(jbase.get_config("mnist-cnn"))
    jpay = {"model": jax.eval_shape(lambda: jmodel.init_params(
        jscfg, jax.random.PRNGKey(0))),
        "protos": jax.ShapeDtypeStruct((10, 128), np.dtype(np.float32)),
        "counts": jax.ShapeDtypeStruct((10,), np.dtype(np.float32))}
    assert [tuple(x.shape) for x in tree_leaves(tpay)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jpay)]
    jmeter = jcomm.ScheduleCommAccountant(jtopo.make_schedule(
        n, "full", rounds=rounds))
    for r in range(rounds):
        jmeter.record_round(jpay, "profe", r, JWireSpec(16))

    assert tmeter.avg_sent_gb() == jmeter.avg_sent_gb() == \
        smoke.EXPECTED_AVG_SENT_GB
    assert TF.packed_copy_bytes(tpay, WireSpec(16)) == \
        jcomm.packed_copy_bytes(jpay, JWireSpec(16)) == \
        smoke.EXPECTED_PACKED_PER_COPY
    assert TF.tree_wire_bytes(tpay, WireSpec(16)) == \
        jquant.tree_wire_bytes(jpay, JWireSpec(16)) == \
        smoke.EXPECTED_LOGICAL_PER_COPY


@pytest.mark.parametrize("fed_kw,train_kw,run_kw", [
    (dict(algorithm="fedavg"), {}, {}),
    (dict(proto_pass="fused"), {}, {}),
    (dict(error_feedback=True, quantize_bits=4), {}, {}),
    (dict(quantize_bits=4, proto_quantize_bits=16), {}, {}),
    (dict(adapter_rank=4), {}, {}),
    (dict(proto_ema=0.5), {}, {}),
    ({}, dict(optimizer="sgd"), {}),
    ({}, {}, dict(overlap="rounds")),
    ({}, {}, dict(eval_all_nodes=True)),
])
def test_options_outside_the_slice_raise(fed_kw, train_kw, run_kw):
    _, tcfg, node_data, test_d, _, _, _, _ = _setup(per_node=16)
    fed = tbase.FederationConfig(num_nodes=N_NODES, rounds=1, **fed_kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TF.run_federation(tcfg, fed, tbase.TrainConfig(**train_kw),
                          node_data, test_d, device="cpu", **run_kw)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup(per_node=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprofe.init_node_state(tcfg, TF.derive_student(tcfg),
                               torch.Generator(), make_plane_optimizer(
                                   "adamw", 1e-3), make_optimizer(
                                   "adamw", 1e-3), 10)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(alone)], capture_output=True,
                           text=True, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")],
            capture_output=True, text=True, timeout=120, cwd=ROOT))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
