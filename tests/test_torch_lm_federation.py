"""LM federations on the port's stacked engine held against the JAX
package on the CPU, from carried weights: whole 2-round
``run_federation`` runs at N = 2 (full graph, 16-bit wire, batch 4,
``make_token_dataset(0, 24, 16, vocab, 8)``: 8 sequences a node, 8 for
the test split) of ProFe on yi-6b and mamba2-130m with the student on
the plane, yi-6b with the per-leaf student (``param_plane="off"``),
FedAvg on yi-6b, and grok-1 (bf16 leaves, adafactor: the per-leaf
student), each config at ``.smoke()`` with ``dtype="float32"``.  Also:
the LM evaluation (next-token macro-F1 over ``min(vocab, 4096)``
classes) against JAX's, ``TrainConfig.remat`` reaching the step, and
``chip_smoke.py``'s LM constants and its train phase on the CPU.

Tolerances, each with its reason:

* the round inputs (batches, gossip weights) byte-equal; ``avg_sent_gb``,
  every byte extra and ``comm.summary()`` exactly (shapes and the
  schedule alone decide them); F1 and accuracy per round exactly (an
  argmax over 512 logits; the nodes' predictions agree);
* after each round the fp32 parameters (student and teacher) to
  ``atol=2e-5``, a student on the 16-bit wire to ``atol`` plus one code
  at its largest magnitude (``max|x| / 32767``): a code flips where the
  two trained students straddle a rounding boundary
  (``tests/test_torch_baselines.py``), and an LM's leaves (norm scales,
  embeddings) reach 1, so a code is 3.1e-5 (mamba2-130m: 9 and 47
  elements a round); at most ``MAX_EPS_ELEMENTS`` elements a state
  beyond that, in Adam's eps regime, within ``atol + 2·lr``
  (``tests/test_torch_lm_train.py``; mamba2-130m's teacher: 3 a round,
  the largest 5.1e-5), the
  moments to ``1e-6`` (first) and ``1e-8`` (second), the Eq. 4
  prototypes to ``1e-4``, masks and counters exactly;
* grok-1's bf16 run: bytes exactly, its F1 and state finite (its bf16
  leaves round each step apart where the gradients do, see
  ``tests/test_torch_lm_train.py``).
"""
import dataclasses
import functools
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import comm as jcomm
from repro.core import federation as JF
from repro.core import quantization as jquant
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.data import make_token_dataset
from repro_torch.models import model as tm
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_NODES, ROUNDS, BATCH, SEQ = 2, 2, 4, 16
ATOL = 2e-5
LR = 1e-3
MAX_EPS_ELEMENTS = 4
# name -> (arch, FederationConfig fields, optimizer)
RUNS = {"yi-6b/plane": ("yi-6b", {}, "adamw"),
        "mamba2-130m/plane": ("mamba2-130m", {}, "adamw"),
        "yi-6b/per-leaf": ("yi-6b", dict(param_plane="off"), "adamw"),
        "yi-6b/fedavg": ("yi-6b", dict(algorithm="fedavg"), "adamw"),
        "grok-1/per-leaf": ("grok-1-314b", {}, "adafactor")}
FP32_RUNS = tuple(k for k in RUNS if not k.startswith("grok"))


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _a(x):
    if isinstance(x, torch.Tensor):
        # a copy: the port's states update in place
        return np.array(x.detach().float())
    return np.asarray(x, np.float32)


def _data(jcfg):
    data = make_token_dataset(0, N_NODES * 8 + 8, SEQ, jcfg.vocab_size,
                              jcfg.n_proto_classes)
    node_data = [{k: v[i * 8:(i + 1) * 8] for k, v in data.items()}
                 for i in range(N_NODES)]
    return node_data, {k: v[N_NODES * 8:] for k, v in data.items()}


def _configs(name):
    arch, fed_kw, optimizer = RUNS[name]
    jcfg = jbase.get_config(arch).smoke().replace(dtype="float32")
    kw = dict(num_nodes=N_NODES, rounds=ROUNDS, topology="full", **fed_kw)
    train = dict(batch_size=BATCH, optimizer=optimizer)
    return (jcfg, jbase.FederationConfig(**kw), jbase.TrainConfig(**train),
            tbase.FederationConfig(**kw), tbase.TrainConfig(**train))


def _initial_states(jcfg, jfed, jtrain, plane):
    """``repro``'s own initial states and the port's carry of them."""
    algo = jfed.algorithm
    scfg = jmodel.derive_student(jcfg)
    opt_t = jmake_optimizer(jtrain.optimizer, jtrain.learning_rate)
    opt_s = jplane.make_plane_optimizer(
        jtrain.optimizer, jtrain.learning_rate, grad_clip=jtrain.grad_clip) \
        if plane else opt_t
    _, _, _, _, cfgs = JF._algo_wiring(algo, jcfg, scfg, jfed, jtrain, opt_s,
                                       opt_t, jit=False)
    states = JF._init_states(algo, cfgs, jfed, opt_s, opt_t,
                             jcfg.n_proto_classes, plane=plane)
    return [tprofe.node_state_from_numpy(
        _np(jplane.as_tree(st.student)), _np(st.teacher), _np(st.opt_s),
        _np(st.opt_t), np.asarray(st.global_protos),
        np.asarray(st.proto_mask), int(st.round_idx), plane=plane,
        device="cpu") for st in states]


def _snapshot(state, leaves):
    def moments(opt):
        return [_a(x) for x in leaves({k: v for k, v in opt.items()
                                       if k not in ("step", "gnorm")})]
    student = state.student
    student = student.buf if hasattr(student, "buf") else student
    return {"student": [_a(x) for x in leaves(student)],
            "teacher": [_a(x) for x in leaves(state.teacher)],
            "opt_s": moments(state.opt_s), "opt_t": moments(state.opt_t),
            "steps": [np.asarray(_a(state.opt_s["step"])).tolist()],
            "global_protos": _a(state.global_protos),
            "proto_mask": _a(state.proto_mask),
            "round_idx": np.asarray(_a(state.round_idx)).tolist()}


def _recording(make_round_fn, calls, leaves):
    def make(*args, **kwargs):
        fn = make_round_fn(*args, **kwargs)

        def round_fn(state, *inputs, teacher_on, all_valid=False):
            out = fn(state, *inputs, teacher_on=teacher_on,
                     all_valid=all_valid)
            calls.append({"inputs": [np.array(x) for x in
                                     jax.tree_util.tree_leaves(inputs)],
                          "flags": (teacher_on, all_valid),
                          "state": _snapshot(out, leaves)})
            return out
        return round_fn
    return make


@functools.lru_cache(maxsize=None)
def _runs(name):
    """Both packages' whole runs of ``name``, every round recorded."""
    jcfg, jfed, jtrain, tfed, ttrain = _configs(name)
    node_data, test = _data(jcfg)
    jcalls, tcalls = [], []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JF, "_make_round_fn", _recording(
            JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
        mp.setattr(TF, "_make_round_fn", _recording(
            TF._make_round_fn, tcalls, tree_leaves))
        jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test)
        plane = JF._plane_mode(jfed, jtrain, jfed.algorithm,
                               jmodel.derive_student(jcfg))
        tres = TF.run_federation(
            _tcfg(jcfg), tfed, ttrain, node_data, test,
            initial_states=_initial_states(jcfg, jfed, jtrain, plane),
            device="cpu")
    finally:
        mp.undo()
    return {"plane": plane, "j": jres, "t": tres, "jcalls": jcalls,
            "tcalls": tcalls}


@pytest.mark.parametrize("name", list(RUNS))
def test_lm_run_bytes_match_jax(name):
    """What travels: the resolved student (plane or per-leaf, as
    ``repro``'s ``_plane_mode``), ``avg_sent_gb`` and every byte extra,
    and the meter's summary, exactly."""
    run = _runs(name)
    tres, jres = run["t"], run["j"]
    want_plane = name.endswith("/plane")
    assert run["plane"] is want_plane
    assert tres.extras["param_plane"] is jres.extras["param_plane"] \
        is want_plane
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    assert tres.comm.summary() == jres.comm.summary()


@pytest.mark.parametrize("name", list(RUNS))
def test_lm_run_f1_matches_jax(name):
    """Node 0's next-token macro-F1 and accuracy each round (grok-1's
    bf16 run: finite)."""
    tres, jres = _runs(name)["t"], _runs(name)["j"]
    assert len(tres.f1_per_round) == len(jres.f1_per_round) == ROUNDS
    assert all(np.isfinite(tres.f1_per_round))
    if name in FP32_RUNS:
        assert tres.f1_per_round == jres.f1_per_round
        assert tres.acc_per_round == jres.acc_per_round


def _assert_params_close(t, j, quantized: bool):
    """``{"student": [...], "teacher": [...]}`` arrays within ATOL (a
    quantized student's plus one code), but for MAX_EPS_ELEMENTS."""
    beyond, gap = 0, 0.0
    for key in ("student", "teacher"):
        assert len(t[key]) == len(j[key]), key
        for a, b in zip(t[key], j[key]):
            assert a.shape == b.shape
            # one 16-bit code of the tensor's largest magnitude: what a
            # flipped code moves a mixed student element by at most
            flip = float(np.abs(b).max()) / 32767 \
                if key == "student" and quantized else 0.0
            over = np.abs(a - b)[np.abs(a - b) > ATOL + flip]
            beyond += over.size
            gap = max(gap, float(over.max(initial=0.0)))
    assert beyond <= MAX_EPS_ELEMENTS and gap <= ATOL + 2 * LR, (beyond, gap)


def _assert_state_close(t, j, quantized: bool):
    _assert_params_close(t, j, quantized)
    for key in ("opt_s", "opt_t"):
        assert len(t[key]) == len(j[key]), key
        half = len(t[key]) // 2
        for k, (a, b) in enumerate(zip(t[key], j[key])):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 if k < half else 1e-8)
    np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                               rtol=0, atol=1e-4)
    assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
    assert t["round_idx"] == j["round_idx"]
    assert t["steps"] == j["steps"]


@pytest.mark.parametrize("name", FP32_RUNS)
def test_lm_run_states_match_jax(name):
    """Every round's inputs byte-equal and its state (the plane buffer
    or the per-leaf student, the teacher, the moments, the prototypes)
    within the tolerances."""
    run = _runs(name)
    tcalls, jcalls = run["tcalls"], run["jcalls"]
    assert len(tcalls) == len(jcalls) == ROUNDS
    for t, j in zip(tcalls, jcalls):
        assert t["flags"] == j["flags"]
        assert len(t["inputs"]) == len(j["inputs"])
        for a, b in zip(t["inputs"], j["inputs"]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        _assert_state_close(t["state"], j["state"],
                            quantized=not name.endswith("/fedavg"))
    if name.endswith("/fedavg"):
        assert run["t"].state.teacher == {}


def test_lm_bf16_run_is_finite_and_keeps_bf16():
    """grok-1's per-leaf run: every leaf of the final state finite, the
    student's and teacher's leaves still bf16, each round's gossip
    weights and batches the JAX run's."""
    run = _runs("grok-1/per-leaf")
    st = run["t"].state
    for tree in (st.student, st.teacher):
        for x in tree_leaves(tree):
            assert x.dtype == torch.bfloat16
            assert bool(torch.isfinite(x).all())
    for x in tree_leaves(st.opt_s) + tree_leaves(st.opt_t):
        assert bool(torch.isfinite(x.float()).all())
    for t, j in zip(run["tcalls"], run["jcalls"]):
        assert all(a.tobytes() == b.tobytes()
                   for a, b in zip(t["inputs"], j["inputs"]))


def _recording_eval(pkg, rounds, leaves):
    """Wrap ``pkg._eval_nodes`` so that every round's students of every
    node (what both loop engines evaluate) are recorded as numpy."""
    inner = pkg._eval_nodes

    def eval_nodes(eval_cfg, students_of, n_nodes, *args, **kwargs):
        rounds.append([[_a(x) for x in leaves(students_of(i))]
                       for i in range(n_nodes)])
        return inner(eval_cfg, students_of, n_nodes, *args, **kwargs)
    return eval_nodes


@pytest.mark.parametrize("name", ["yi-6b/plane", "yi-6b/fedavg"])
def test_lm_loop_engine_matches_jax(name, monkeypatch):
    """``run_federation_loop`` (the per-node engine) on an LM teacher
    against ``repro``'s: the meter's bytes, every node's student each
    round (as the stacked runs' students), F1 and accuracy."""
    jcfg, jfed, jtrain, tfed, ttrain = _configs(name)
    node_data, test = _data(jcfg)
    jrounds, trounds = [], []
    monkeypatch.setattr(JF, "_eval_nodes", _recording_eval(
        JF, jrounds, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_eval_nodes", _recording_eval(
        TF, trounds, tree_leaves))
    jres = JF.run_federation_loop(jcfg, jfed, jtrain, node_data, test)
    plane = name.endswith("/plane")
    tres = TF.run_federation_loop(
        _tcfg(jcfg), tfed, ttrain, node_data, test,
        initial_states=_initial_states(jcfg, jfed, jtrain, plane),
        device="cpu")
    assert tres.extras["param_plane"] is jres.extras["param_plane"] is plane
    for key in ("avg_sent_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy"):
        assert tres.extras[key] == jres.extras[key], key
    for key in ("sent", "received", "by_round", "by_kind"):
        assert dict(getattr(tres.comm, key)) == dict(getattr(jres.comm, key))
    assert len(trounds) == len(jrounds) == ROUNDS
    for t_nodes, j_nodes in zip(trounds, jrounds):
        for t, j in zip(t_nodes, j_nodes):
            _assert_params_close(
                {"student": [a.reshape(b.shape) for a, b in zip(t, j)],
                 "teacher": []}, {"student": j, "teacher": []},
                quantized=plane)
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round


# -- LM evaluation ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _eval_case(arch):
    jcfg = jbase.get_config(arch).smoke().replace(dtype="float32")
    params = [jmodel.init_params(jcfg, jax.random.PRNGKey(i))
              for i in range(N_NODES)]
    _, test = _data(jcfg)
    return jcfg, params, test


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m", "whisper-small"])
def test_lm_eval_matches_jax(arch):
    """``_eval_params`` on an LM: next-token argmax at every position
    against ``labels``, macro-F1 over ``min(vocab, 4096)`` classes, as
    ``repro``'s (whisper-small's test batches carry no audio: its
    ``build_memory`` needs ``audio_embed``, so it gets zeros)."""
    jcfg, params, test = _eval_case(arch)
    if jcfg.family == "audio":
        test = dict(test, audio_embed=np.zeros(
            (len(test["tokens"]), jcfg.encoder_seq, jcfg.d_model),
            np.float32))
    want = JF._eval_params(jcfg, params[0], test)
    tparams = tm.params_from_numpy(_np(params[0]))
    got = TF._eval_params(_tcfg(jcfg), tparams,
                          {k: torch.from_numpy(v) for k, v in test.items()})
    assert got == want
    assert TF._eval_classes(_tcfg(jcfg)) == min(jcfg.vocab_size, 4096)


def test_lm_batched_eval_matches_jax_and_the_node_loop():
    """``_eval_params_batched`` on stacked LM students: every node's
    metrics equal ``repro``'s batched evaluation and the port's node by
    node one."""
    jcfg, params, test = _eval_case("yi-6b")
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *params)
    want = JF._eval_params_batched(jcfg, stacked, test)
    tstack = tm.params_from_numpy(_np(stacked))
    ttest = {k: torch.from_numpy(v) for k, v in test.items()}
    got = TF._eval_params_batched(_tcfg(jcfg), tstack, ttest)
    assert got == want
    assert got == [TF._eval_params(_tcfg(jcfg), tree_map(
        lambda x: x[i], tstack), ttest) for i in range(N_NODES)]


# -- TrainConfig.remat --------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_train_remat_reaches_the_step(remat, monkeypatch):
    """``run_federation`` passes ``TrainConfig.remat`` to the step: with
    it on each period of the stack runs under
    ``torch.utils.checkpoint`` (its forward and its recomputation), off
    never; the round's state is the same bits either way."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    jcfg, jfed, jtrain, tfed, ttrain = _configs("yi-6b/plane")
    node_data, test = _data(jcfg)
    fed = dataclasses.replace(tfed, rounds=1)
    states = _initial_states(jcfg, dataclasses.replace(jfed, rounds=1),
                             jtrain, True)
    res = TF.run_federation(_tcfg(jcfg), fed,
                            dataclasses.replace(ttrain, remat=remat),
                            node_data, test, initial_states=states,
                            device="cpu")
    assert (len(calls) > 0) is remat
    base = _runs("yi-6b/plane")["tcalls"][0]["state"]["student"]
    # the recorded JAX-compared run ran with remat on (TrainConfig's
    # default): the same bits
    assert [a.tobytes() for a in base] == \
        [_a(res.state.student.buf).tobytes()]


# -- chip_smoke.py's LM constants and its train phase -----------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_count(cfg):
    shapes = jax.eval_shape(lambda: jmodel.init_params(
        cfg, jax.random.PRNGKey(0)))
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes))


@pytest.mark.parametrize("arch", list(_chip_smoke().TRAIN_FULL))
def test_chip_smoke_train_counts_match_jax(arch):
    """``TRAIN_FULL``'s teacher and student parameter counts are the JAX
    package's at that depth (from shapes), and the port's (``meta``)."""
    layers, n_teacher, n_student = _chip_smoke().TRAIN_FULL[arch]
    jcfg = jbase.get_config(arch)
    if layers is not None:
        jcfg = jcfg.replace(num_layers=layers)
    assert _jax_count(jcfg) == n_teacher
    assert _jax_count(jmodel.derive_student(jcfg)) == n_student
    gen = torch.Generator()
    tcfg = _tcfg(jcfg)
    assert tm.param_count(tm.init_params(tcfg, gen, "meta")) == n_teacher
    assert tm.param_count(tm.init_params(tm.derive_student(tcfg), gen,
                                         "meta")) == n_student


@pytest.mark.parametrize("name", list(_chip_smoke().LM_PATHS))
def test_chip_smoke_lm_path_bytes_match_jax(name):
    """``LM_PATHS``' byte constants: both packages' accountants on their
    payload templates (the port's from its state layout on ``meta``,
    ``repro``'s from shapes), the path's nodes, rounds and 16-bit wire."""
    smoke = _chip_smoke()
    arch, small, optimizer, nodes, rounds, _, plane, want = \
        smoke.LM_PATHS[name]
    jcfg = jbase.get_config(arch)
    if small:
        jcfg = jcfg.smoke()
    scfg = jmodel.derive_student(jcfg)
    jfed = jbase.FederationConfig(num_nodes=nodes, rounds=rounds)
    jtrain = jbase.TrainConfig(optimizer=optimizer)
    assert JF._plane_mode(jfed, jtrain, "profe", scfg) is plane
    assert TF._plane_mode(tbase.FederationConfig(num_nodes=nodes),
                          tbase.TrainConfig(optimizer=optimizer), "profe",
                          _tcfg(scfg)) is plane
    ncls, pdim = jcfg.n_proto_classes, scfg.proto_dim
    jstudent = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype),
        jax.eval_shape(lambda: jmodel.init_params(scfg,
                                                  jax.random.PRNGKey(0))))
    jpay = JF._payload_template("student", True,
                                types.SimpleNamespace(student=jstudent),
                                ncls, pdim)
    params = tm.init_params(_tcfg(scfg), torch.Generator(), "meta")
    from repro_torch.optim.plane import plane_from_tree
    student = plane_from_tree(params) if plane else \
        tree_map(lambda x: x[None], params)
    tpay = TF._payload_template("student", True,
                                types.SimpleNamespace(student=student),
                                ncls, pdim)
    jbits = JWireSpec(student_bits=16)
    from repro_torch.wirespec import WireSpec
    tbits = WireSpec(student_bits=16)

    def sent(pkg_meter, pkg_sched, pay, bits):
        meter = pkg_meter(pkg_sched(nodes, "full", rounds=rounds))
        for r in range(rounds):
            meter.record_round(pay, "profe", r, bits)
        return meter.avg_sent_gb()
    from repro.core import topology as jtopo
    from repro_torch.core import topology as ttopo
    assert sent(jcomm.ScheduleCommAccountant, jtopo.make_schedule, jpay,
                jbits) == sent(TF.ScheduleCommAccountant,
                               ttopo.make_schedule, tpay, tbits) == want[0]
    assert jcomm.packed_copy_bytes(jpay, jbits) == \
        TF.packed_copy_bytes(tpay, tbits) == want[1]
    assert jquant.tree_wire_bytes(jpay, jbits) == \
        TF.tree_wire_bytes(tpay, tbits) == want[2]


def test_chip_smoke_train_phase_on_cpu(capsys):
    """``run_train`` on the CPU: the ten smoke configs' steps with remat
    on and off bit-identical, ``full``'s loop at the smoke size, and the
    grok-1 per-leaf LM federation with its bytes (the plain versions
    run on the CPU, so no kernel launches)."""
    smoke = _chip_smoke()
    from repro_torch.config import get_config
    cfg = get_config("mamba2-130m").smoke()
    gen = torch.Generator()
    full = {"mamba2-130m": (None, tm.param_count(tm.init_params(cfg, gen)),
                            tm.param_count(tm.init_params(
                                tm.derive_student(cfg), gen)))}
    counts = smoke.run_train(torch, "cpu", device="cpu", full=full,
                             lm_paths=("lm/grok-1/per-leaf",),
                             full_smoke=True)
    out = capsys.readouterr().out
    assert out.count("remat on and off bit-identical") == 10
    assert 'train {"arch": "mamba2-130m"' in out
    assert 'lm path {"path": "lm/grok-1/per-leaf"' in out
    assert not any(counts["lm/grok-1/per-leaf"].values())
