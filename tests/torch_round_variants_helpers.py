"""The shared helpers of the round-variant tests
(tests/test_torch_round_variants.py, test_torch_overlap.py).

The round variants of the port's stacked engine, held against the JAX
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
import torch

from repro.config import base as jbase
from repro.core import federation as JF
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels.quantize import ops as tqops
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


# -- the pipelined drivers -----------------------------------------------------


def _leaves_np(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [y for sub in x for y in _leaves_np(sub)]
    return [x]


# -- the self-weight floor -----------------------------------------------------

FLOOR_TOPOLOGIES = ["full", "ring", "star", "random-k2", "er-0.3",
                    "dynamic:ring,star"]


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
