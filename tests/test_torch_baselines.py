"""The paper baselines (FedAvg, FedProto, FML, FedGPD), ProFe's per-leaf
student (``param_plane="off"``) and ProFe's fp32 wire (``quantize_bits=0``)
on the port's stacked engine, held against the JAX package on the CPU
from the same carried weights, at 3 nodes on a small mnist-cnn (channels
(4, 8), proto_dim 16, fp32).

Tolerances, each with its reason:

* The stacked steps against ``repro``'s ``jit=False`` step vmapped over
  the nodes: parameters to ``atol=2e-6`` after one adamw step and
  ``2e-5`` after eight (``test_fedavg_step_matches_jax``'s bounds: the
  frameworks sum the convolutions' gradients in other orders), losses
  within ``rtol=1e-5``, gradient norms ``rtol=1e-4``, the Adam moments
  ``atol=1e-6`` (mu) and ``1e-8`` (nu), step counters exactly, and the
  ``f1`` FedProto and FedGPD return ``atol=1e-5``.  FedProto and FedGPD
  run with a partial prototype mask and with an all-zero one (round 1,
  where FedGPD's prototype CE must add nothing and no NaN), under adamw
  and sgd; under adamw at most ``MAX_EPS_ELEMENTS`` parameters in Adam's
  eps regime may leave the atol, each within ``atol + 2·lr`` (the reason
  and the measured case are at ``MAX_EPS_ELEMENTS``).
* Whole 2-round ``run_federation`` runs: the round inputs byte-equal;
  after each round the shared model and the teacher to ``atol=2e-5``
  (as ``tests/test_torch_federation.py``: on the 16-bit wire a code may
  flip where the two trained students straddle a rounding boundary),
  the Eq. 4 prototypes to ``atol=1e-4``, the moments as above, masks and
  counters exactly; per-round F1 and accuracy exactly; every byte extra
  and ``comm.summary()`` exactly.
* The port's ProFe per-leaf run against its own plane run from the same
  weights: bit for bit (the per-leaf adamw and the plane sweep's plain
  version round every operation alike, and the tree codec's segments
  are the plane codec's).
* Bytes (Table II at N = 4 and ``chip_smoke.py``'s N = 20 constants)
  exactly.
"""
import dataclasses
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import comm as jcomm
from repro.core import federation as JF
from repro.core import quantization as jquant
from repro.core import topology as jtopo
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.models import init_params
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 3
ALGOS = ("fedavg", "fedproto", "fml", "fedgpd")
# the whole runs: name -> FederationConfig fields
RUNS = {"fedavg": dict(algorithm="fedavg"),
        "fedproto": dict(algorithm="fedproto"),
        "fml": dict(algorithm="fml"),
        "fedgpd": dict(algorithm="fedgpd"),
        "profe/per-leaf": dict(param_plane="off"),
        "profe/fp32": dict(quantize_bits=0)}
# reports/table2_comm.json, mnist-cnn, N = 4, full graph, 2 rounds: GB
# sent per node
TABLE2 = {"fedavg": 0.010119408, "fedgpd": 0.010150368, "fml": 0.004966128,
          "fedproto": 3.096e-05, "profe": 0.002498784}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small_cfg():
    return jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32")


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _fed_pair(**kw):
    return jbase.FederationConfig(**kw), tbase.FederationConfig(**kw)


def _train_pair(**kw):
    return jbase.TrainConfig(**kw), tbase.TrainConfig(**kw)


def _opt_pair(train, plane: bool):
    """Both packages' ``(opt_s, opt_t)`` as their engines make them."""
    jt = jmake_optimizer(train.optimizer, train.learning_rate,
                         weight_decay=train.weight_decay,
                         momentum=train.momentum)
    tt = make_optimizer(train.optimizer, train.learning_rate,
                        weight_decay=train.weight_decay,
                        momentum=train.momentum)
    if not plane:
        return (jmake_optimizer(train.optimizer, train.learning_rate,
                                weight_decay=train.weight_decay,
                                momentum=train.momentum), jt), \
            (make_optimizer(train.optimizer, train.learning_rate,
                            weight_decay=train.weight_decay,
                            momentum=train.momentum), tt)
    kw = dict(weight_decay=train.weight_decay, momentum=train.momentum,
              grad_clip=train.grad_clip)
    return ((jplane.make_plane_optimizer(train.optimizer,
                                         train.learning_rate, **kw), jt),
            (make_plane_optimizer(train.optimizer, train.learning_rate,
                                  **kw), tt))


def _carry(st, plane: bool):
    """One JAX node state as the port's."""
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), plane=plane, device="cpu")


def _jax_states(algo, jcfg, jfed, jtrain, plane: bool):
    scfg = jmodel.derive_student(jcfg)
    (opt_s, opt_t), _ = _opt_pair(jtrain, plane)
    _, _, _, _, cfgs = JF._algo_wiring(algo, jcfg, scfg, jfed, jtrain, opt_s,
                                       opt_t, jit=False)
    return JF._init_states(algo, cfgs, jfed, opt_s, opt_t, 10, plane=plane)


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _snapshot(state, leaves):
    """numpy copies of a stacked state (the port updates in place):
    the student's leaves (a plane's buffer), the teacher's, the
    optimizers' tensors but step and norm in flatten order, counters,
    prototypes and mask."""
    def moments(opt):
        return [_a(x) for x in leaves({k: v for k, v in opt.items()
                                       if k not in ("step", "gnorm")})]

    def step(opt):
        return int(np.ravel(_a(opt["step"]))[0]) if opt else None
    student = state.student
    student = student.buf if hasattr(student, "buf") else student
    return {"student": [_a(x) for x in leaves(student)],
            "teacher": [_a(x) for x in leaves(state.teacher)],
            "opt_s": moments(state.opt_s), "opt_t": moments(state.opt_t),
            "steps": (step(state.opt_s), step(state.opt_t)),
            "global_protos": _a(state.global_protos),
            "proto_mask": _a(state.proto_mask),
            "round_idx": _a(state.round_idx).tolist()}


def _beyond(t, j, atol):
    """Parameter elements (student and teacher) beyond ``atol``: their
    count and largest gap."""
    gaps = [np.abs(a - b)[np.abs(a - b) > atol]
            for key in ("student", "teacher") for a, b in zip(t[key], j[key])]
    gaps = np.concatenate([g.ravel() for g in gaps] + [np.zeros(0)])
    return gaps.size, float(gaps.max(initial=0.0))


def _assert_state_close(t, j, *, atol=2e-5, optimizer="adamw",
                        eps_elements=0, lr=1e-3):
    """A round's (or a step's) state against ``repro``'s; an empty
    teacher and ``opt_t`` must be empty in both.  Parameters to ``atol``
    but for at most ``eps_elements`` elements in Adam's eps regime (see
    ``MAX_EPS_ELEMENTS``), each within ``atol + 2·lr``."""
    for key in ("student", "teacher"):
        assert len(t[key]) == len(j[key]), key
        for a, b in zip(t[key], j[key]):
            assert a.shape == b.shape
    assert len(t["student"]) > 0
    n, gap = _beyond(t, j, atol)
    assert n <= eps_elements and gap <= atol + 2 * lr, (n, gap)
    for key in ("opt_s", "opt_t"):
        assert len(t[key]) == len(j[key]), key
        # adamw: mu (atol 1e-6) then nu (1e-8); sgd: mu
        half = len(t[key]) // 2 if optimizer == "adamw" else len(t[key])
        for k, (a, b) in enumerate(zip(t[key], j[key])):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 if k < half else 1e-8)
    np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                               rtol=0, atol=1e-4)
    assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
    assert t["round_idx"] == j["round_idx"]
    assert t["steps"] == j["steps"]


# -- the stacked steps ---------------------------------------------------------

def _images(seed, n):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _node_batch(seed, n=16):
    """``[N, B, ...]``: one batch a node."""
    per = [_images(seed * 10 + i, n) for i in range(N_NODES)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


def _with_protos(states, mask):
    """The states with random global prototypes and the mask ``mask``
    (``"partial"``: classes 0-5 set, differently per node; ``"zero"``:
    none, as in round 1)."""
    if mask is None:
        return states
    out = []
    for i, st in enumerate(states):
        rng = np.random.default_rng(100 + i)
        m = np.zeros(10, np.float32)
        if mask == "partial":
            m[:6 - i] = 1.0
        out.append(st._replace(
            global_protos=jnp.asarray(rng.standard_normal((10, 16)),
                                      jnp.float32) * m[:, None],
            proto_mask=jnp.asarray(m)))
    return out


# Adam's eps regime: adamw moves an element by lr·m/(sqrt(v) + eps), in
# its first step lr·g/(|g| + 1e-8).  Where a node's clipped gradient
# element is itself near eps, the frameworks' gradient gap (about 2e-6
# of the largest gradient, summation order) shifts that fraction, and the
# element by up to 2·lr.  FedGPD under a partial mask has pre-clip norms
# of 50-180 (the prototype CE of classes with no prototype), so its
# clipped gradients reach that regime: one fc1 weight of 56,448
# parameters, clipped gradient 1.49e-9 / 1.85e-9 (mu) in the two
# packages, moves 5.1e-5 apart in step 1 and stays so; under sgd the same
# run stays within 1.5e-8.  Such elements are counted, at most this many
# a state, each within atol + 2·lr; ``f1`` (the forward of the
# parameters before a step) is held to its atol up to the first step
# that follows one.  FedProto and FedGPD also run under sgd, which has
# no such regime.  (FedAvg and FML run under adamw only: sgd's momentum
# keeps a gradient as it is, and where a ReLU's input sits at the
# frameworks' last-bit gap a gradient element flips whole -- FML's
# teacher momentum, one conv2 element 1.1e-3 apart after step 2 of 8.)
MAX_EPS_ELEMENTS = 2
STEP_CASES = [(a, m, s, o) for a in ALGOS
              for m in ((None,) if a in ("fedavg", "fml")
                        else ("partial", "zero"))
              for s in (1, 8)
              for o in (("adamw",) if a in ("fedavg", "fml")
                        else ("adamw", "sgd"))]


@pytest.mark.parametrize("algo,mask,steps,optimizer", STEP_CASES,
                         ids=[f"{a}-{m or 'nomask'}-{s}-{o}"
                              for a, m, s, o in STEP_CASES])
def test_stacked_step_matches_jax(algo, mask, steps, optimizer):
    """Each baseline's stacked step against ``repro``'s per-node step
    vmapped over 3 nodes, from the same carried state, under adamw and
    sgd."""
    jcfg = _small_cfg()
    scfg = jmodel.derive_student(jcfg)
    jfed, tfed = _fed_pair(num_nodes=N_NODES, algorithm=algo)
    jtrain, ttrain = _train_pair(batch_size=16, remat=False,
                                 optimizer=optimizer)
    (j_opt_s, j_opt_t), (t_opt_s, t_opt_t) = _opt_pair(jtrain, False)
    jstep, *_ = JF._algo_wiring(algo, jcfg, scfg, jfed, jtrain, j_opt_s,
                                j_opt_t, jit=False)
    tstep, *_ = TF._algo_wiring(algo, _tcfg(jcfg), _tcfg(scfg), tfed,
                                ttrain, t_opt_s, t_opt_t)
    jstates = _with_protos(_jax_states(algo, jcfg, jfed, jtrain, False),
                           mask)
    jst = JF._stack_states(jstates)
    tst = tprofe.stack_states([_carry(s, False) for s in jstates])
    t_on = algo == "fml"
    atol = 2e-6 if steps == 1 else 2e-5
    eps_elements = MAX_EPS_ELEMENTS if optimizer == "adamw" else 0
    jvstep = jax.jit(jax.vmap(lambda s, b: jstep(s, b, t_on)))
    apart = 0               # parameter elements beyond atol before a step
    for k in range(steps):
        b = _node_batch(k)
        jst, jm = jvstep(jst, b)
        tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in b.items()},
                        t_on)
        assert set(tm) == set(jm) - {"alpha"}
        for key in ("loss_s", "loss_t"):
            if key in jm:
                assert tuple(tm[key].shape) == (N_NODES,)
                np.testing.assert_allclose(_a(tm[key]), np.asarray(jm[key]),
                                           rtol=1e-5)
        np.testing.assert_allclose(_a(tm["grad_norm_s"]),
                                   np.asarray(jm["grad_norm_s"]), rtol=1e-4)
        if "f1" in jm:
            assert tm["f1"].shape == jm["f1"].shape
            if not apart:
                np.testing.assert_allclose(_a(tm["f1"]),
                                           np.asarray(jm["f1"]), rtol=0,
                                           atol=1e-5)
        tsnap = _snapshot(tst, tree_leaves)
        jsnap = _snapshot(jst, jax.tree_util.tree_leaves)
        _assert_state_close(tsnap, jsnap, atol=atol, optimizer=optimizer,
                            eps_elements=eps_elements,
                            lr=ttrain.learning_rate)
        apart, _ = _beyond(tsnap, jsnap, atol)
    assert all(np.isfinite(x).all() for x in
               tree_leaves(tree_map(_a, tst.student)))
    if algo != "fml":
        assert tst.teacher == {} and tst.opt_t == {}


def test_fedgpd_adds_no_prototype_term_before_any_prototype():
    """With no prototype set, FedGPD's step is FedAvg's (the prototype
    CE and MSE add nothing, the gradients stay finite)."""
    jcfg = _small_cfg()
    tfed = tbase.FederationConfig(num_nodes=N_NODES)
    ttrain = tbase.TrainConfig(batch_size=16)
    jfed, _ = _fed_pair(num_nodes=N_NODES, algorithm="fedgpd")
    jstates = _jax_states("fedgpd", jcfg, jfed, jbase.TrainConfig(), False)
    b = {k: torch.from_numpy(v) for k, v in _node_batch(7).items()}
    out = []
    for algo in ("fedgpd", "fedavg"):
        (_, _), (opt_s, opt_t) = _opt_pair(ttrain, False)
        step, *_ = TF._algo_wiring(algo, _tcfg(jcfg), None,
                                   dataclasses.replace(tfed, algorithm=algo),
                                   ttrain, opt_s, opt_t)
        st = tprofe.stack_states([_carry(s, False) for s in jstates])
        st, m = step(st, b, False)
        out.append((m["loss_s"], [_a(x) for x in tree_leaves(st.student)]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert np.isfinite(a).all() and a.tobytes() == b.tobytes()


# -- whole runs ----------------------------------------------------------------

def _setup(fed_kw, rounds=2, per_node=56, batch=16):
    jcfg = _small_cfg()
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    jfed, tfed = _fed_pair(num_nodes=N_NODES, rounds=rounds, topology="full",
                           **fed_kw)
    jtrain, ttrain = _train_pair(batch_size=batch, remat=False)
    return jcfg, node_data, test_d, jfed, tfed, jtrain, ttrain


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
                "state": _snapshot(out, leaves)})
            return out
        return round_fn
    return make


def _plane_of(jfed, jtrain, jcfg):
    return JF._plane_mode(jfed, jtrain, jfed.algorithm,
                          jmodel.derive_student(jcfg))


@pytest.mark.parametrize("name", list(RUNS))
def test_run_federation_matches_jax_from_carried_states(name, monkeypatch):
    """Whole 2-round runs of both packages from the same carried weights
    (``repro``'s own ``_init_states``): every round's inputs, state,
    F1 and accuracy, and every byte count."""
    jcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(RUNS[name])
    jcalls, tcalls = [], []
    monkeypatch.setattr(JF, "_make_round_fn", _recording(
        JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_make_round_fn", _recording(
        TF._make_round_fn, tcalls, tree_leaves))
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
    plane = _plane_of(jfed, jtrain, jcfg)
    assert plane == (name == "profe/fp32")
    jstates = _jax_states(jfed.algorithm, jcfg, jfed, jtrain, plane)
    tres = TF.run_federation(_tcfg(jcfg), tfed, ttrain, node_data, test_d,
                             initial_states=[_carry(s, plane)
                                             for s in jstates],
                             device="cpu")
    assert tres.extras["param_plane"] is jres.extras["param_plane"] is plane
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    assert tres.comm.summary() == jres.comm.summary()
    assert len(tcalls) == len(jcalls) == 2
    protos = name not in ("fedavg", "fml")
    for t, j in zip(tcalls, jcalls):
        assert t["flags"] == j["flags"]
        if not name.startswith("profe"):
            assert t["flags"] == (name == "fml", True)
        # image, label, valid; proto image, label, valid (or the empty
        # [0, N] placeholder alone); the 3 gossip / include matrices
        assert len(t["inputs"]) == len(j["inputs"]) == (9 if protos else 7)
        for a, b in zip(t["inputs"], j["inputs"]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        _assert_state_close(t["state"], j["state"])
        assert bool(t["state"]["proto_mask"].any()) == protos
    assert len(tres.f1_per_round) == 2
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round


def test_profe_per_leaf_run_equals_the_plane_run(monkeypatch):
    """The port's ProFe with ``param_plane="off"`` against its own plane
    run from the same weights, on the 16-bit wire, bit for bit: each
    round's student (the plane's leaf views), teacher, moments,
    prototypes and mask; F1, accuracy and every byte extra."""
    jcfg, node_data, test_d, jfed, _, jtrain, ttrain = _setup({})
    calls = {True: [], False: []}
    make = TF._make_round_fn
    plane = True

    def record(*args, **kwargs):
        fn = make(*args, **kwargs)

        def round_fn(state, *inputs, **kw):
            st = fn(state, *inputs, **kw)
            student, mu = st.student, st.opt_s["mu"]
            if plane:
                student, mu = as_tree(student), as_tree(Plane(mu, st.student.meta))
            calls[plane].append([_a(x) for x in tree_leaves(
                (student, mu, st.teacher, st.opt_t, st.global_protos,
                 st.proto_mask))])
            return st
        return round_fn
    monkeypatch.setattr(TF, "_make_round_fn", record)
    res = {}
    for plane in (True, False):
        tfed = tbase.FederationConfig(num_nodes=N_NODES, rounds=2,
                                      topology="full",
                                      param_plane="auto" if plane else "off")
        states = [_carry(s, plane) for s in
                  _jax_states("profe", jcfg, jfed, jtrain, plane)]
        res[plane] = TF.run_federation(_tcfg(jcfg), tfed, ttrain, node_data,
                                       test_d, initial_states=states,
                                       device="cpu")
        res[plane].extras.pop("round_times_s")
        assert res[plane].extras.pop("param_plane") is plane
    assert res[True].extras == res[False].extras
    assert res[True].f1_per_round == res[False].f1_per_round
    assert res[True].acc_per_round == res[False].acc_per_round
    assert len(calls[True]) == len(calls[False]) == 2
    for p_round, f_round in zip(calls[True], calls[False]):
        assert len(p_round) == len(f_round)
        for a, b in zip(p_round, f_round):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()


# -- state plumbing ------------------------------------------------------------

@pytest.mark.parametrize("algo", ["fedavg", "fml"])
def test_stack_states_and_carry_per_leaf_and_empty_teacher(algo):
    """``node_state_from_numpy(plane=False)`` and ``stack_states`` equal
    ``repro``'s stacked state bit for bit: a per-leaf student and opt_s,
    an empty teacher and opt_t (fedavg) or a per-leaf teacher (fml),
    the step counters stacked one a node as ``repro`` stacks them."""
    jcfg = _small_cfg()
    jfed, _ = _fed_pair(num_nodes=N_NODES, algorithm=algo)
    jstates = _jax_states(algo, jcfg, jfed, jbase.TrainConfig(), False)
    want = JF._stack_states(jstates)
    got = tprofe.stack_states([_carry(s, False) for s in jstates])
    assert not isinstance(got.student, Plane)
    assert (got.teacher == {}) == (got.opt_t == {}) == (algo == "fedavg")
    for key in ("student", "teacher", "opt_s", "opt_t", "global_protos",
                "proto_mask", "round_idx"):
        t, j = getattr(got, key), getattr(want, key)
        if key.startswith("opt") and j:
            assert t["step"].tolist() == [0] * N_NODES
        tl, jl = tree_leaves(t), jax.tree_util.tree_leaves(j)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert _a(a).dtype == np.asarray(b).dtype
            assert _a(a).tobytes() == np.asarray(b).tobytes(), key
    for x in tree_leaves((got.student, got.teacher)):
        assert x.requires_grad and x.is_leaf


def test_stack_states_refuses_unequal_steps_and_per_leaf_residuals():
    """Unequal step counters are no longer refused: nodes with unequal
    batch counts step unequally, so ``stack_states`` stacks the counters
    one a node, each keeping its node's value, as ``repro``'s
    ``_stack_states`` does.  Nor is error feedback on a per-leaf student
    refused any more: its residual tree is carried as fp32 tensors and
    stacks leaf by leaf."""
    jcfg = _small_cfg()
    jfed, _ = _fed_pair(num_nodes=2, algorithm="fedavg")
    jstates = _jax_states("fedavg", jcfg, jfed, jbase.TrainConfig(), False)
    states = [_carry(s, False) for s in jstates]
    states[1].opt_s["step"] = states[1].opt_s["step"] + 1
    jstates[1] = jstates[1]._replace(opt_s=dict(
        jstates[1].opt_s, step=jstates[1].opt_s["step"] + 1))
    got = tprofe.stack_states(states)
    assert got.opt_s["step"].dtype == torch.int32
    assert got.opt_s["step"].tolist() == [0, 1]
    assert _a(got.opt_s["step"]).tobytes() == np.asarray(
        JF._stack_states(jstates).opt_s["step"]).tobytes()
    st = jstates[0]
    residual = {"protos": np.ones((10, 16), np.float32),
                "student": jax.tree_util.tree_map(
                    lambda x: np.full(x.shape, 0.5, np.float32), st.student)}
    carried = [tprofe.node_state_from_numpy(
        _np_tree(st.student), {}, _np_tree(st.opt_s), {},
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        plane=False, device="cpu", residual=residual, seq=1)
        for _ in range(2)]
    stacked = tprofe.stack_states(carried).wire_state
    assert stacked.seq.tolist() == [1, 1]
    for r, x in zip(tree_leaves(stacked.residual["student"]),
                    tree_leaves(states[0].student)):
        assert r.dtype == torch.float32 and r.shape == (2,) + x.shape
        assert bool((r == 0.5).all())


def test_init_states_of_every_algorithm():
    """``_init_states``: a teacher for ProFe and FML only, the student
    on the plane only where ``_plane_mode`` resolves it, the teacher-size
    model in the student slot of fedavg, fedproto and fedgpd."""
    jcfg = _small_cfg()
    tcfg, scfg = _tcfg(jcfg), _tcfg(jmodel.derive_student(jcfg))
    ttrain = tbase.TrainConfig()
    for algo in ALGOS + ("profe",):
        fed = tbase.FederationConfig(num_nodes=2, algorithm=algo)
        plane = TF._plane_mode(fed, ttrain, algo, scfg)
        assert plane == (algo == "profe")
        _, (opt_s, opt_t) = _opt_pair(ttrain, plane)
        _, _, _, _, cfgs = TF._algo_wiring(algo, tcfg, scfg, fed, ttrain,
                                           opt_s, opt_t)
        st = tprofe.stack_states(TF._init_states(algo, cfgs, fed, opt_s,
                                                 opt_t, 10, "cpu",
                                                 plane=plane))
        want = init_params(cfgs[1] if algo in ("profe", "fml") else cfgs[0],
                           torch.Generator().manual_seed(0))
        student = as_tree(st.student) if plane else st.student
        assert [tuple(x.shape[1:]) for x in tree_leaves(student)] == \
            [tuple(x.shape) for x in tree_leaves(want)]
        assert (st.teacher != {}) == (algo in ("profe", "fml"))
        assert tuple(st.global_protos.shape) == (2, 10, 16)


def test_init_states_seed_each_node_apart():
    jcfg = _small_cfg()
    tcfg = _tcfg(jcfg)
    fed = tbase.FederationConfig(num_nodes=2, algorithm="fedavg")
    _, (opt_s, opt_t) = _opt_pair(tbase.TrainConfig(), False)
    a, b = TF._init_states("fedavg", (tcfg, tcfg), fed, opt_s, opt_t, 10,
                           "cpu", plane=False)
    assert not torch.equal(a.student["fc1"]["kernel"],
                           b.student["fc1"]["kernel"])
    assert a.teacher == {} and a.opt_t == {}


def test_per_leaf_student_refuses_error_feedback_and_adapters():
    """A per-leaf student is no longer refused error feedback or the
    adapter wire: each runs a round on both engines, keeps its student
    per-leaf, and carries its residual (a tree mirroring the payload) or
    its adapter reference (whole runs against JAX:
    ``tests/test_torch_tree_ef.py``)."""
    jcfg, node_data, test_d, *_ = _setup({}, per_node=16)
    for kw in (dict(quantize_bits=4, error_feedback=True),
               dict(quantize_bits=4, adapter_rank=4)):
        fed = tbase.FederationConfig(num_nodes=N_NODES, rounds=1,
                                     param_plane="off", **kw)
        for run in (TF.run_federation, TF.run_federation_loop):
            res = run(_tcfg(jcfg), fed, tbase.TrainConfig(), node_data,
                      test_d, device="cpu")
            assert res.extras["param_plane"] is False
            assert not isinstance(res.state.student, Plane)
            if fed.error_feedback:
                ws = res.state.wire_state
                assert ws.seq.tolist() == [1] * N_NODES
                assert isinstance(ws.residual["student"], dict)
            else:
                assert res.state.adapter_state is not None


def test_unknown_algorithm_raises():
    jcfg, node_data, test_d, *_ = _setup({}, per_node=16)
    fed = tbase.FederationConfig(num_nodes=N_NODES, rounds=1,
                                 algorithm="fedsgd")
    with pytest.raises(ValueError, match="unknown algorithm"):
        TF.run_federation(_tcfg(jcfg), fed, tbase.TrainConfig(), node_data,
                          test_d, device="cpu")


# -- bytes -----------------------------------------------------------------------

def _templates(algo, model, **fed_kw):
    """Both packages' payload templates and wire specs for ``algo`` at
    the full width of ``model``, from ``_algo_wiring``'s wiring: the
    port's from its state layout (plane or per-leaf), ``repro``'s from
    shape skeletons with a node axis."""
    jcfg = jbase.get_config(model)
    scfg = jmodel.derive_student(jcfg)
    jfed, tfed = _fed_pair(algorithm=algo, **fed_kw)
    jtrain, ttrain = _train_pair()
    plane = TF._plane_mode(tfed, ttrain, algo, _tcfg(scfg))
    (j_opt_s, j_opt_t), (t_opt_s, t_opt_t) = _opt_pair(jtrain, plane)
    _, wire_model, share, jbits, cfgs = JF._algo_wiring(
        algo, jcfg, scfg, jfed, jtrain, j_opt_s, j_opt_t, jit=False)
    _, t_wire_model, t_share, tbits, tcfgs = TF._algo_wiring(
        algo, _tcfg(jcfg), _tcfg(scfg), tfed, ttrain, t_opt_s, t_opt_t)
    assert (t_wire_model, t_share) == (wire_model, share)
    assert (tbits is None) == (jbits is None)
    if jbits is not None:
        assert tbits.describe() == jbits.describe()
    cfg = 1 if algo in ("profe", "fml") else 0
    params = init_params(tcfgs[cfg], torch.Generator().manual_seed(0))
    student = plane_from_tree(params) if plane else \
        tree_map(lambda x: x[None], params)
    state = types.SimpleNamespace(student=student)
    ncls, pdim = jcfg.num_classes, cfgs[cfg].proto_dim
    tpay = TF._payload_template(wire_model, share, state, ncls, pdim)
    jstudent = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype),
        jax.eval_shape(lambda: jmodel.init_params(cfgs[cfg],
                                                  jax.random.PRNGKey(0))))
    jpay = JF._payload_template(wire_model, share,
                                types.SimpleNamespace(student=jstudent),
                                ncls, pdim)
    assert [tuple(x.shape) for x in tree_leaves(tpay)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jpay)]
    return tpay, tbits, jpay, jbits


def _sent(pkg, pay, bits, n, rounds):
    meter = pkg.ScheduleCommAccountant(pkg.make_schedule(n, "full",
                                                         rounds=rounds))
    for r in range(rounds):
        meter.record_round(pay, "x", r, bits)
    return meter.avg_sent_gb()


_TPKG = types.SimpleNamespace(ScheduleCommAccountant=TF.ScheduleCommAccountant,
                              make_schedule=ttopo.make_schedule)
_JPKG = types.SimpleNamespace(
    ScheduleCommAccountant=jcomm.ScheduleCommAccountant,
    make_schedule=jtopo.make_schedule)


@pytest.mark.parametrize("algo", list(TABLE2))
def test_table2_bytes_match_the_report(algo):
    """Table II (``reports/table2_comm.json``): mnist-cnn at full width,
    N = 4, full graph, 2 rounds, GB sent per node, from both packages'
    accountants on their engines' own payload templates."""
    import json
    report = json.loads((ROOT / "reports" / "table2_comm.json").read_text())
    assert report["mnist-cnn"][algo]["sent_gb"] == TABLE2[algo]
    tpay, tbits, jpay, jbits = _templates(algo, "mnist-cnn")
    assert _sent(_TPKG, tpay, tbits, 4, 2) == \
        _sent(_JPKG, jpay, jbits, 4, 2) == TABLE2[algo]


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BASELINE_PATHS = ("fedavg", "fedproto", "fml", "fedgpd", "16/per-leaf",
                  "fp32")


@pytest.mark.parametrize("name", BASELINE_PATHS)
def test_chip_smoke_baseline_bytes_match_jax(name):
    """The N = 20 constants ``chip_smoke.py`` holds each new path to:
    ``avg_sent_gb`` over the path's rounds, ``packed_copy_bytes`` (on
    the fp32 wire ``bits=None``) and ``tree_wire_bytes``, from the
    port's and ``repro``'s accountants, equal each other and the
    script's constants."""
    smoke = _chip_smoke_module()
    model, _, wire, rounds, want = smoke.PATHS[name]
    fed_kw = dict(smoke.PATH_FED.get(name, {}))
    algo = fed_kw.pop("algorithm", "profe")
    assert algo == (name if name in ALGOS else "profe")
    fed_kw.update(smoke.wire_fields(smoke.parse_wire(wire)))
    tpay, tbits, jpay, jbits = _templates(algo, model, **fed_kw)
    assert (tbits is None) == (wire == "fp32") == (jbits is None)
    assert _sent(_TPKG, tpay, tbits, smoke.N_NODES, rounds) == \
        _sent(_JPKG, jpay, jbits, smoke.N_NODES, rounds) == want[0]
    assert TF.packed_copy_bytes(tpay, tbits) == \
        jcomm.packed_copy_bytes(jpay, jbits) == want[1]
    assert TF.tree_wire_bytes(tpay, tbits) == \
        jquant.tree_wire_bytes(jpay, jbits) == want[2]


@pytest.mark.parametrize("algo", list(TABLE2))
def test_packed_copy_bytes_fp32_wire_matches_jax(algo):
    """``packed_copy_bytes(payload, None)``: ``rows · 512 · 4`` plus the
    raw ``counts`` sidecar, as ``repro``'s, for each algorithm's
    template (and the 16-bit count of the same template for contrast)."""
    tpay, _, jpay, _ = _templates(algo, "mnist-cnn")
    from repro_torch.kernels.quantize.ops import packed_wire_rows
    got = TF.packed_copy_bytes(tpay, None)
    assert got == jcomm.packed_copy_bytes(jpay, None)
    floats = {k: v for k, v in tpay.items() if k != "counts"}
    rows, _ = packed_wire_rows(floats)
    raw = 40 if "counts" in tpay else 0
    assert got == rows * 512 * 4 + raw
    assert TF.packed_copy_bytes(tpay, 16) == \
        jcomm.packed_copy_bytes(jpay, 16)


def test_initial_states_must_match_the_resolved_plane_mode():
    """Plane states for a run that resolves the per-leaf student (and
    per-leaf states for a plane run) are refused, not converted."""
    jcfg, node_data, test_d, jfed, _, jtrain, ttrain = _setup({}, rounds=1,
                                                              per_node=16)
    for plane, mode in ((True, "off"), (False, "auto")):
        states = [_carry(s, plane) for s in
                  _jax_states("profe", jcfg, jfed, jtrain, plane)]
        fed = tbase.FederationConfig(num_nodes=N_NODES, rounds=1,
                                     param_plane=mode)
        with pytest.raises(ValueError, match="param_plane resolved"):
            TF.run_federation(_tcfg(jcfg), fed, ttrain, node_data, test_d,
                              initial_states=states, device="cpu")
