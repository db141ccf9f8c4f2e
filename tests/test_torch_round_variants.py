"""The round variants of the port's stacked engine, held against the JAX
package on the CPU: the fused Eq. 3 pass, the prototype EMA, the
pipelined drivers (``overlap="none"`` and the stale-by-one
``"rounds"``), the self-weight floor and the all-node evaluation.

Whole runs start both packages from the same carried states (``repro``'s
own ``_init_states`` through ``node_state_from_numpy``, the EMA carry
included) on a tiny mnist-cnn (channels (4, 8), proto_dim 16, fp32; the
adapter wire on channels (24, 32) so its student factors at rank 8), 3
nodes, 2 or 3 rounds.  Each round's staged inputs are held byte-equal,
and the state after each round's last phase to the tolerances of
``tests/test_torch_federation.py``: parameters ``atol=2e-5`` (Adam steps
that agree to a few ulp, plus a 16-bit wire code that may flip where the
two trained students straddle a rounding boundary), the Adam moments
``1e-6`` (mu) and ``1e-8`` (nu), the Eq. 4 prototypes ``1e-4``, masks,
counters and ``seq`` exactly.  The EMA carry: its sums to ``1e-4`` (sums
of up to 48 f1 rows, each within a few ulp of ``repro``'s), its counts
exactly.  The ``+ef`` residual: student part ``RES_ATOL``, prototype
part ``PROTO_RES_ATOL`` away from an int16 prototype code flip, and at
most ``MAX_INT16_PROTO_FLIPS`` flips a round, each within
``PROTO_RES_ATOL`` plus one of the port's own prototype Δ (the bounds of
``tests/test_torch_federation.py``: the pre-share prototypes differ by
up to 8.3e-7 between the frameworks against a Δ of about 2.5e-5, so a
prototype may round to the neighbouring code).  Parameters in Adam's eps
regime: at most ``MAX_EPS_ELEMENTS`` may leave the atol, each within
``atol + 2·lr`` (``tests/test_torch_baselines.py``: where clipped
gradients reach eps, the frameworks' summation gap moves a weight by up
to one lr; seen once, a teacher conv2 weight 4.3e-5 apart in round 3 of
the stale-by-one adapter run).  Per-round F1 and accuracy (and with
``eval_all_nodes`` every node's) exactly.

``overlap="none"`` is also held bit for bit to the port's own sequential
engine, and ``_apply_self_floor`` bit for bit to ``repro``'s on the
lowered stacks.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import federation as JF
from repro.core import topology as jtopo
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

N_NODES = 3
RES_ATOL = 2e-6             # EF student residual
PROTO_RES_ATOL = 1.5e-6     # EF prototype residual, away from flips
MAX_INT16_PROTO_FLIPS = 24  # per round, of N·C·P prototype codes
MAX_EPS_ELEMENTS = 2        # parameters in Adam's eps regime, a round
LR = 1e-3                   # TrainConfig's learning rate
WIRES = {"16": {},
         "4/16+ef": dict(quantize_bits=4, proto_quantize_bits=16,
                         error_feedback=True),
         "adapters8": dict(quantize_bits=4, adapter_rank=8)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _setup(fed_kw, rounds=2, per_node=56, batch=16, channels=(4, 8),
           topology="full"):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=channels, proto_dim=16, dtype="float32")
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    kw = dict(num_nodes=N_NODES, rounds=rounds, topology=topology, **fed_kw)
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg)), node_data,
            test_d, jbase.FederationConfig(**kw),
            tbase.FederationConfig(**kw), jbase.TrainConfig(**train_kw),
            tbase.TrainConfig(**train_kw))


def _jax_states(jcfg, jfed, jtrain):
    """The per-node states ``repro``'s ``run_federation`` initializes, and
    whether its student rides the plane."""
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
    """One JAX node state (with its EMA carry) as the port's."""
    acc = None if st.proto_acc is None else tuple(np.asarray(x)
                                                  for x in st.proto_acc)
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), plane=plane, proto_acc=acc, device="cpu")


def _snapshot(state, leaves):
    """numpy copies of a stacked state of either package (the port's
    updates in place)."""
    def moments(opt):
        return [_a(x) for x in leaves({k: v for k, v in opt.items()
                                       if k not in ("step", "gnorm")})]

    def step(opt):
        return int(np.ravel(_a(opt["step"]))[0]) if opt else None
    student = state.student
    student = student.buf if hasattr(student, "buf") else student
    ws = state.wire_state
    return {
        "student": [_a(x) for x in leaves(student)],
        "teacher": [_a(x) for x in leaves(state.teacher)],
        "opt_s": moments(state.opt_s), "opt_t": moments(state.opt_t),
        "steps": (step(state.opt_s), step(state.opt_t)),
        "global_protos": _a(state.global_protos),
        "proto_mask": _a(state.proto_mask),
        "round_idx": _a(state.round_idx).tolist(),
        "proto_acc": None if state.proto_acc is None
        else tuple(_a(x) for x in state.proto_acc),
        "residual": None if ws is None else (
            _a(ws.residual["protos"]), _a(ws.residual["student"].buf)),
        "seq": None if ws is None else _a(ws.seq).tolist(),
        "adapter_ref": None if state.adapter_state is None else
        [_a(state.adapter_state["ref"][k])
         for k in sorted(state.adapter_state["ref"])]}


def _record(monkeypatch, pkg, calls, leaves):
    """Record every round ``pkg.run_federation`` drives, sequential or
    pipelined: its staged inputs, flags, the phases it called in order,
    the weights its mix received and (copied) the state after its last
    phase."""
    make_round, make_phases = pkg._make_round_fn, pkg._make_phase_fns

    def inputs_of(tree):
        return [np.array(x) for x in jax.tree_util.tree_leaves(tree)]

    def round_maker(*args, **kwargs):
        fn = make_round(*args, **kwargs)

        def round_fn(state, *inputs, teacher_on, all_valid=False):
            out = fn(state, *inputs, teacher_on=teacher_on,
                     all_valid=all_valid)
            calls.append({"inputs": inputs_of(inputs[:4]),
                          "weights": inputs_of(inputs[4:]),
                          "flags": (teacher_on, all_valid),
                          "phases": ["round"],
                          "state": _snapshot(out, leaves)})
            return out
        return round_fn

    def phase_maker(*args, **kwargs):
        train, share, mix = make_phases(*args, **kwargs)

        def train_fn(state, xb, valid, pxb, pvalid, teacher_on,
                     all_valid=False):
            out = train(state, xb, valid, pxb, pvalid,
                        teacher_on=teacher_on, all_valid=all_valid)
            calls.append({"inputs": inputs_of((xb, valid, pxb, pvalid)),
                          "weights": None,
                          "flags": (teacher_on, all_valid),
                          "phases": ["train"],
                          "state": _snapshot(out[0], leaves)})
            return out

        def share_fn(state, protos):
            out = share(state, protos)
            calls[-1]["phases"].append("share")
            calls[-1]["state"] = _snapshot(out[0], leaves)
            return out

        def mix_fn(state, *rest):
            out = mix(state, *rest)
            calls[-1]["phases"].append("mix")
            calls[-1]["weights"] = inputs_of(rest[-3:])
            calls[-1]["state"] = _snapshot(out, leaves)
            return out
        return train_fn, share_fn, mix_fn

    monkeypatch.setattr(pkg, "_make_round_fn", round_maker)
    monkeypatch.setattr(pkg, "_make_phase_fns", phase_maker)


def _assert_state_close(t, j, proto_delta=None):
    """A round's state against ``repro``'s; ``proto_delta`` ``[N]`` is the
    port's prototype Δ of the round's share (the ``+ef`` wire)."""
    gaps = []
    for key in ("student", "teacher"):
        assert len(t[key]) == len(j[key]), key
        for a, b in zip(t[key], j[key]):
            assert a.shape == b.shape
            gap = np.abs(a - b)
            gaps.append(gap[gap > 2e-5])
    assert len(t["student"]) > 0
    gaps = np.concatenate(gaps)
    assert gaps.size <= MAX_EPS_ELEMENTS, gaps
    assert (gaps <= 2e-5 + 2 * LR).all(), gaps
    for key in ("opt_s", "opt_t"):
        assert len(t[key]) == len(j[key]), key
        half = len(t[key]) // 2          # adamw: mu, then nu
        for k, (a, b) in enumerate(zip(t[key], j[key])):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 if k < half else 1e-8)
    np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                               rtol=0, atol=1e-4)
    assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
    for key in ("round_idx", "steps", "seq"):
        assert t[key] == j[key], key
    assert (t["proto_acc"] is None) == (j["proto_acc"] is None)
    if t["proto_acc"] is not None:
        np.testing.assert_allclose(t["proto_acc"][0], j["proto_acc"][0],
                                   rtol=0, atol=1e-4)
        assert t["proto_acc"][1].tobytes() == j["proto_acc"][1].tobytes()
    assert (t["residual"] is None) == (j["residual"] is None)
    if t["residual"] is not None:
        n = t["residual"][0].shape[0]
        gap = np.abs(t["residual"][0] - j["residual"][0]).reshape(n, -1)
        off = gap > PROTO_RES_ATOL
        assert np.count_nonzero(off) <= MAX_INT16_PROTO_FLIPS
        assert np.all(gap <= PROTO_RES_ATOL + off * proto_delta[:, None])
        np.testing.assert_allclose(t["residual"][1], j["residual"][1],
                                   rtol=0, atol=RES_ATOL)
    assert (t["adapter_ref"] is None) == (j["adapter_ref"] is None)
    for a, b in zip(t["adapter_ref"] or (), j["adapter_ref"] or ()):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def _run_pair(monkeypatch, fed_kw, run_kw=None, **setup_kw):
    """Both packages' ``run_federation`` from the same carried states,
    each round recorded: ``(tres, jres, tcalls, jcalls, carried)``."""
    run_kw = run_kw or {}
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        fed_kw, **setup_kw)
    jcalls, tcalls = [], []
    _record(monkeypatch, JF, jcalls, jax.tree_util.tree_leaves)
    _record(monkeypatch, TF, tcalls, tree_leaves)
    proto_deltas = []       # the port's prototype Δ per node, each share
    quantize = tqops.quantize_packed_buffer

    def quantize_packed_buffer(*args, **kwargs):
        out = quantize(*args, **kwargs)
        proto_deltas.append(np.array(out[1][:, 0]))     # segment 0: protos
        return out
    monkeypatch.setattr(tqops, "quantize_packed_buffer",
                        quantize_packed_buffer)
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d,
                             **run_kw)
    jstates, plane = _jax_states(jcfg, jfed, jtrain)
    carried = [_carry(s, plane) for s in jstates]
    tres = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             initial_states=carried, device="cpu", **run_kw)
    assert tres.extras["param_plane"] is jres.extras["param_plane"] is plane
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb",
                "proto_pass", "proto_ema", "stale_self_floor"):
        assert tres.extras.get(key) == jres.extras.get(key), key
    assert tres.comm.summary() == jres.comm.summary()
    assert len(tcalls) == len(jcalls) == tfed.rounds
    if tfed.error_feedback:
        assert len(proto_deltas) == tfed.rounds
    for rnd, (t, j) in enumerate(zip(tcalls, jcalls)):
        assert t["flags"] == j["flags"]
        assert t["phases"] == j["phases"]
        for key in ("inputs", "weights"):
            assert (t[key] is None) == (j[key] is None), key
            for a, b in zip(t[key] or (), j[key] or ()):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes(), key
        _assert_state_close(t["state"], j["state"],
                            proto_deltas[rnd] if tfed.error_feedback
                            else None)
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round
    return tres, jres, tcalls, jcalls, carried


# -- the fused Eq. 3 pass ------------------------------------------------------

FUSED = {"profe": {}, "profe/per-leaf": dict(param_plane="off"),
         "fedproto": dict(algorithm="fedproto"),
         "fedgpd": dict(algorithm="fedgpd")}


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_run_matches_jax(name, monkeypatch):
    """``proto_pass="fused"``: no proto stream is staged (the ``[0, N]``
    placeholder alone), and every round's state, prototypes, F1 and
    accuracy agree with ``repro``'s."""
    tres, _, tcalls, _, _ = _run_pair(
        monkeypatch, dict(proto_pass="fused", **FUSED[name]))
    assert tres.extras["proto_pass"] == "fused"
    for t in tcalls:
        # image, label, valid and the empty proto stream's valid
        assert [a.shape for a in t["inputs"]][3] == (0, N_NODES)
        assert len(t["inputs"]) == 4
        assert t["state"]["proto_mask"].all()


def test_fused_and_exact_prototypes_differ_and_step_reports_its_f1():
    """The fused pass accumulates the f1 each step's loss used (before
    that step's update): the ProFe step's ``metrics["f1"]`` equals a
    forward of the pre-step student, detached."""
    from repro_torch.models import derive_student, forward
    _, tcfg, node_data, _, _, tfed, _, ttrain = _setup({})
    scfg = derive_student(tcfg)
    opt_t = make_optimizer("adamw", 1e-3)
    opt_s = make_plane_optimizer("adamw", 1e-3, grad_clip=1.0)
    states = [tprofe.init_node_state(tcfg, scfg,
                                     torch.Generator().manual_seed(i),
                                     opt_s, opt_t, 10, device="cpu")
              for i in range(N_NODES)]
    stacked = tprofe.stack_states(states)
    step = tprofe.make_profe_step(tcfg, scfg, tfed, opt_s, opt_t)
    batch = {k: torch.as_tensor(np.stack([d[k][:16] for d in node_data]))
             for k in node_data[0]}
    with torch.no_grad():
        want = torch.stack([
            forward(scfg, tprofe.node_params(stacked.student, i),
                    {k: v[i] for k, v in batch.items()}).f1
            for i in range(N_NODES)])
    before = stacked.student.buf.detach().clone()
    stacked, metrics = step(stacked, batch, True)
    assert not torch.equal(stacked.student.buf, before)
    assert not metrics["f1"].requires_grad
    assert torch.equal(metrics["f1"], want)


# -- the prototype EMA ---------------------------------------------------------

@pytest.mark.parametrize("proto_pass", ["exact", "fused"])
def test_proto_ema_run_matches_jax(proto_pass, monkeypatch):
    """``proto_ema=0.5``: the raw accumulators carried in
    ``NodeState.proto_acc`` agree with ``repro``'s every round, and the
    carried counts grow as ``c_t + 0.5·acc_{t-1}``: after round 2 exactly
    1.5× one round's (every round counts the same samples)."""
    tres, _, tcalls, _, carried = _run_pair(
        monkeypatch, dict(proto_pass=proto_pass, proto_ema=0.5), rounds=3)
    assert all(s.proto_acc is not None for s in carried)
    counts = [t["state"]["proto_acc"][1].sum(-1) for t in tcalls]
    assert (counts[0] > 0).all()
    np.testing.assert_array_equal(counts[1], 1.5 * counts[0])
    np.testing.assert_array_equal(counts[2], counts[0] + 0.5 * counts[1])
    assert tres.extras["proto_ema"] == 0.5


def test_proto_acc_rides_the_node_state():
    """``init_node_state(proto_ema=)`` allocates the zero carry,
    ``node_state_from_numpy(proto_acc=)`` carries one over,
    ``stack_states`` stacks it (all or none), and ``run_federation``
    refuses a carry the run has no EMA for."""
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup({})
    from repro_torch.models import derive_student
    scfg = derive_student(tcfg)
    opt_t = make_optimizer("adamw", 1e-3)
    opt_s = make_plane_optimizer("adamw", 1e-3, grad_clip=1.0)

    def fresh(i, ema):
        return tprofe.init_node_state(tcfg, scfg,
                                      torch.Generator().manual_seed(i),
                                      opt_s, opt_t, 10, proto_ema=ema,
                                      device="cpu")
    st = fresh(0, 0.5)
    assert [tuple(x.shape) for x in st.proto_acc] == [(10, 16), (10,)]
    assert all(x.dtype == torch.float32 and not x.any()
               for x in st.proto_acc)
    assert fresh(0, 0.0).proto_acc is None
    stacked = tprofe.stack_states([fresh(i, 0.5) for i in range(N_NODES)])
    assert [tuple(x.shape) for x in stacked.proto_acc] == \
        [(N_NODES, 10, 16), (N_NODES, 10)]
    with pytest.raises(ValueError, match="proto_acc"):
        tprofe.stack_states([fresh(0, 0.5), fresh(1, 0.0)])
    sums = np.arange(160, dtype=np.float32).reshape(10, 16)
    counts = np.arange(10, dtype=np.float32)
    jcfg, _, _, _, jfed, _, jtrain, _ = _setup(dict(proto_ema=0.5))
    jst = _jax_states(jcfg, jfed, jtrain)[0][0]
    assert all(not np.asarray(x).any() for x in jst.proto_acc)
    carried = _carry(jst._replace(proto_acc=(sums, counts)), True)
    assert torch.equal(carried.proto_acc[0], torch.from_numpy(sums))
    assert torch.equal(carried.proto_acc[1], torch.from_numpy(counts))
    with pytest.raises(ValueError, match="proto_acc"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                          initial_states=[fresh(i, 0.5)
                                          for i in range(N_NODES)],
                          device="cpu")


# -- the pipelined drivers -----------------------------------------------------

@pytest.mark.parametrize("wire", ["16", "4/16+ef"])
def test_overlap_none_matches_jax_and_the_sequential_engine(wire,
                                                            monkeypatch):
    """``overlap="none"``: train, share and mix in order each round,
    against ``repro``'s pipelined driver; and against the port's own
    sequential engine from the same states, bit for bit (every round's
    state, F1, accuracy and byte extras)."""
    tres, _, tcalls, _, carried = _run_pair(monkeypatch, WIRES[wire],
                                            dict(overlap="none"))
    for t in tcalls:
        assert t["phases"] == ["train", "share", "mix"]
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup(WIRES[wire])
    seq_calls = []
    monkeypatch.undo()              # record the sequential run alone
    _record(monkeypatch, TF, seq_calls, tree_leaves)
    # stack_states copies: the carried per-node states are as they were
    seq = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                            initial_states=carried, device="cpu")
    assert len(seq_calls) == len(tcalls) == 2
    for s, t in zip(seq_calls, tcalls):
        assert s["phases"] == ["round"]
        for key in ("inputs", "weights"):
            for a, b in zip(s[key], t[key]):
                assert a.tobytes() == b.tobytes()
        for key, a in s["state"].items():
            b = t["state"][key]
            assert len(_leaves_np(a)) == len(_leaves_np(b)), key
            for x, y in zip(_leaves_np(a), _leaves_np(b)):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), \
                    key
    assert seq.f1_per_round == tres.f1_per_round
    assert seq.acc_per_round == tres.acc_per_round
    for key in ("avg_sent_gb", "wire_bytes_packed_per_copy",
                "wire_bytes_per_copy"):
        assert seq.extras[key] == tres.extras[key]


def _leaves_np(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [y for sub in x for y in _leaves_np(sub)]
    return [x]


@pytest.mark.parametrize("case", ["16", "4/16+ef", "adapters8",
                                  "16+floor"])
def test_overlap_rounds_matches_jax(case, monkeypatch):
    """``overlap="rounds"``, 3 rounds: round 0 trains and shares, later
    rounds mix the payload shared a round before, then share their own
    (R rounds, R - 1 mixes).  With ``+ef`` the residual and ``seq`` (one
    a share) agree with ``repro``'s; on the adapter wire the reference
    snapshot advances at share time; ``16+floor`` floors the
    self-weight at 0.5 and the mixes receive ``repro``'s floored
    weights byte for byte."""
    wire = case.split("+floor")[0]
    run_kw = dict(overlap="rounds")
    if case.endswith("+floor"):
        run_kw["stale_self_floor"] = 0.5
    setup_kw = dict(channels=(24, 32), per_node=48) \
        if wire == "adapters8" else {}
    tres, _, tcalls, _, _ = _run_pair(monkeypatch, WIRES[wire], run_kw,
                                      rounds=3, **setup_kw)
    assert [t["phases"] for t in tcalls] == \
        [["train", "share"]] + [["train", "mix", "share"]] * 2
    if wire == "4/16+ef":
        assert tcalls[-1]["state"]["seq"] == [3] * N_NODES
        assert tres.extras["wire_state"].seq.tolist() == [3] * N_NODES
    if case.endswith("+floor"):
        w_self = tcalls[1]["weights"][0]
        np.testing.assert_array_equal(w_self, np.full(N_NODES, 0.5,
                                                      np.float32))
    if wire == "adapters8":
        assert sorted(tres.extras["adapter_factors"]) == [
            "['conv2']['kernel']", "['fc1']['kernel']", "['fc2']['kernel']"]


def test_overlap_rounds_on_the_fp32_wire_mixes_what_was_shared(monkeypatch):
    """On the fp32 wire the share hands over the sender's live student;
    the stale-by-one mix must see it as it was shared, not as the next
    round's training left it (``repro``'s arrays are immutable)."""
    _run_pair(monkeypatch, dict(quantize_bits=0), dict(overlap="rounds"),
              rounds=3)


# -- the self-weight floor -----------------------------------------------------

FLOOR_TOPOLOGIES = ["full", "ring", "star", "random-k2", "er-0.3",
                    "dynamic:ring,star"]


@pytest.mark.parametrize("topology", FLOOR_TOPOLOGIES)
@pytest.mark.parametrize("floor", [0.3, 0.5, 0.9])
def test_apply_self_floor_matches_jax(topology, floor):
    """``_apply_self_floor`` on the lowered ``[R, N]`` / ``[R, N, N]``
    stacks of 8 nodes (unequal dataset sizes) equals ``repro``'s bit for
    bit; rows still sum to 1 and no self-weight falls below the floor
    where a node has neighbours."""
    n = 8
    sizes = [10 + 7 * i for i in range(n)]
    ts, tn, _ = ttopo.make_schedule(n, topology, rounds=2, seed=3).lower(
        sizes)
    js, jn, _ = jtopo.make_schedule(n, topology, rounds=2, seed=3).lower(
        sizes)
    assert ts.tobytes() == np.asarray(js).tobytes()
    t_self, t_neigh = TF._apply_self_floor(ts, tn, floor)
    j_self, j_neigh = JF._apply_self_floor(js, jn, floor)
    assert t_self.dtype == t_neigh.dtype == np.float32
    assert t_self.tobytes() == np.asarray(j_self).tobytes()
    assert t_neigh.tobytes() == np.asarray(j_neigh).tobytes()
    np.testing.assert_allclose(t_self + t_neigh.sum(-1), 1.0, rtol=0,
                               atol=1e-6)
    has = tn.sum(-1) > 0
    assert (t_self[has] >= np.float32(floor)).all()


def test_apply_self_floor_leaves_an_isolated_node_and_raises():
    """A node without neighbours keeps self-weight 1 and no neighbour
    weight; a floor outside (0, 1) raises ``ValueError``, as does a floor
    without the stale-by-one pipeline (both packages)."""
    adj = np.zeros((4, 4), bool)
    adj[0, 1] = adj[1, 0] = adj[1, 2] = adj[2, 1] = True     # node 3 alone
    ws, wn, _ = ttopo.from_stack(adj).lower([5, 6, 7, 8])
    s, n = TF._apply_self_floor(ws, wn, 0.6)
    js, jn = JF._apply_self_floor(ws, wn, 0.6)
    assert s.tobytes() == np.asarray(js).tobytes()
    assert n.tobytes() == np.asarray(jn).tobytes()
    assert s[0, 3] == ws[0, 3] == 1.0 and not n[0, 3].any()
    for bad in (0.0, 1.0, -0.5, 1.5):
        for pkg in (TF, JF):
            with pytest.raises(ValueError, match="stale_self_floor"):
                pkg._apply_self_floor(ws, wn, bad)
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup({}, rounds=1)
    for overlap in (None, "none"):
        with pytest.raises(ValueError, match="overlap='rounds'"):
            TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                              overlap=overlap, stale_self_floor=0.5,
                              device="cpu")
    with pytest.raises(ValueError, match=r"\(0, 1\)"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                          overlap="rounds", stale_self_floor=1.0,
                          device="cpu")
    with pytest.raises(ValueError, match="overlap must be one of"):
        TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                          overlap="epochs", device="cpu")


# -- all-node evaluation ---------------------------------------------------------

def test_eval_all_nodes_matches_jax(monkeypatch):
    """``eval_all_nodes`` on a star (the nodes differ after a round):
    the mean F1 and accuracy per round, the per-node curves and their
    spread in ``extras`` equal ``repro``'s."""
    tres, jres, _, _, _ = _run_pair(monkeypatch, {},
                                    dict(eval_all_nodes=True),
                                    topology="star")
    for key in ("f1_per_round_nodes", "acc_per_round_nodes",
                "f1_std_per_round"):
        assert tres.extras[key] == jres.extras[key], key
    nodes = tres.extras["f1_per_round_nodes"]
    assert len(nodes) == 2 and all(len(r) == N_NODES for r in nodes)
    assert tres.f1_per_round == [float(np.mean(r)) for r in nodes]


def test_batched_eval_equals_the_per_node_loop():
    """``_eval_params_batched`` over stacked students equals
    ``_eval_params`` node by node, and ``_eval_nodes`` gives the same
    with and without the stacked students (``repro``'s assertion)."""
    _, tcfg, _, test_d, _, _, _, _ = _setup({})
    from repro_torch.models import derive_student
    scfg = derive_student(tcfg)
    opt_t = make_optimizer("adamw", 1e-3)
    opt_s = make_plane_optimizer("adamw", 1e-3, grad_clip=1.0)
    stacked = tprofe.stack_states([
        tprofe.init_node_state(tcfg, scfg, torch.Generator().manual_seed(i),
                               opt_s, opt_t, 10, device="cpu")
        for i in range(N_NODES)])
    test = {k: torch.as_tensor(v) for k, v in test_d.items()}
    per_node = [TF._eval_params(scfg, tprofe.node_params(stacked.student, i),
                                test, batch_size=24)
                for i in range(N_NODES)]
    assert TF._eval_params_batched(scfg, stacked.student, test,
                                   batch_size=24) == per_node
    assert len({p for p in per_node}) > 1            # the nodes differ
    a, b = {}, {}
    got = TF._eval_nodes(scfg, lambda i: tprofe.node_params(
        stacked.student, i), N_NODES, test, True, a,
        stacked_students=stacked.student)
    want = TF._eval_nodes(scfg, lambda i: tprofe.node_params(
        stacked.student, i), N_NODES, test, True, b)
    assert got == want and a == b
    assert a["f1_per_round_nodes"] == [[p[0] for p in per_node]]
    assert TF._eval_nodes(scfg, lambda i: tprofe.node_params(
        stacked.student, i), N_NODES, test, False, {}) == per_node[0]


# -- chip_smoke.py's round-variant paths -----------------------------------------

def _chip_smoke_module():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VARIANT_PATHS = {"16/fused": "16", "16/fused+ema": "16", "16/none": "16",
                 "16/rounds+floor": "16", "4/16+ef/rounds": "4/16+ef",
                 "adapters8/rounds": "adapters8"}


@pytest.mark.parametrize("name", list(VARIANT_PATHS))
def test_chip_smoke_variant_paths(name):
    """The round variants leave what travels as it is: each path's N = 20
    constants are its base path's (which
    ``tests/test_torch_federation.py`` holds to the JAX package's
    accountants), its model, optimizer, wire, rounds and wire fields the
    base's, and its options are ones ``run_federation`` takes."""
    smoke = _chip_smoke_module()
    base = VARIANT_PATHS[name]
    assert smoke.PATHS[name] == smoke.PATHS[base]
    fed_kw = dict(smoke.PATH_FED.get(name, {}))
    for key, value in smoke.PATH_FED.get(base, {}).items():
        assert fed_kw.pop(key) == value
    assert set(fed_kw) <= {"proto_pass", "proto_ema"}
    run_kw = smoke.PATH_RUN.get(name, {})
    assert set(run_kw) <= {"eval_all_nodes", "overlap", "stale_self_floor"}
    assert fed_kw or run_kw
    tbase.FederationConfig(**fed_kw)
    TF._check_slice(tbase.FederationConfig(**fed_kw),
                    overlap=run_kw.get("overlap"),
                    stale_self_floor=run_kw.get("stale_self_floor"))
    assert (name in smoke.DETERMINISTIC_PATHS) == (name == "16/none")
