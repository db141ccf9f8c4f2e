"""Non-iid federations on the port's stacked engine, held against the JAX
package on the CPU: nodes with unequal local batch counts step through
masked steps, each node with its own optimizer step counter.

* The plain masked plane sweeps (rows 1, 5 and 6 of ``PERF.md``:
  ``adamw_update_ref``, ``sgd_update_ref``, ``adafactor_apply_ref``) and
  the per-leaf optimizers: a masked node comes back bit-unchanged
  (parameters, moments, counter), an active node bit-equal to a one-node
  update at that node's own counter; an all-on mask is the unmasked
  arithmetic bit for bit.  The plane optimizers stay bit-identical to the
  per-leaf ones under a mask.  The CUDA wrappers' mask checks raise
  before any launch.
* Whole ``run_federation`` runs of both packages from the same carried
  states (``repro``'s own ``_init_states``) on ``noniid40`` and
  ``dirichlet`` splits of a tiny mnist-cnn (channels (4, 8), proto_dim
  16, fp32, 4 nodes of 2-4 batches of 16): adamw, sgd and adafactor, the
  exact and fused Eq. 3 pass, ProFe and FedAvg, the ``16`` and
  ``4/16+ef`` wires.  Bytes and ``comm.summary()`` exactly; every
  round's staged inputs (the ``valid`` mask included) byte-equal; after
  every round the per-node step counters exactly, masks and round
  counters exactly, parameters ``atol=2e-5`` (steps that agree to a few
  ulp, plus a 16-bit wire code that may flip where the two trained
  students straddle a rounding boundary; under adamw at most
  ``MAX_EPS_ELEMENTS`` in Adam's eps regime may leave it, each within
  ``atol + 2·lr``), the moments to ``MOMENT_TOL`` (Adam's mu 1e-6 and
  nu 1e-8, as ``tests/test_torch_federation.py``; sgd's momentum 1e-6;
  adafactor's second moments rtol 1e-5; under adamw as many moments as
  ``MAX_EPS_ELEMENTS`` may leave it, each within twice it), the Eq. 4
  prototypes ``1e-4``; the ``+ef`` residual as
  ``tests/test_torch_federation.py`` holds it (student ``RES_ATOL``,
  prototypes ``PROTO_RES_ATOL`` but for at most
  ``MAX_INT16_PROTO_FLIPS`` int16 code flips a round, each within one of
  the port's prototype Δ more); per-round F1 and accuracy exactly.
* A resume from a checkpoint of a ``noniid40`` run, bit for bit against
  the uninterrupted run; and a checkpoint whose step counters are one
  0-d counter for all nodes (the stacked state's layout before per-node
  counters) loads with the counter broadcast and resumes bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import federation as JF
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels.opt_update import opt_update as tkopt
from repro_torch.kernels.opt_update.ops import (fused_adamw_update,
                                                fused_sgd_update)
from repro_torch.kernels.opt_update.ref import (adafactor_apply_ref,
                                                adamw_update_ref,
                                                sgd_update_ref)
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               make_plane_optimizer)
from repro_torch.optim import plane as tplane
from repro_torch.tree import keyed_leaves, tree_leaves, tree_map

torch.set_num_threads(2)

N_NODES = 4
RES_ATOL = 2e-6             # EF student residual
PROTO_RES_ATOL = 1.5e-6     # EF prototype residual, away from flips
MAX_INT16_PROTO_FLIPS = 24  # per round, of N·C·P prototype codes
# the moments: Adam's mu and nu (and sgd's momentum) as
# tests/test_torch_federation.py holds them; adafactor's second moments
# are squares of the gradient, held relative to their size (a few ulp)
MOMENT_TOL = {"mu": dict(atol=1e-6), "nu": dict(atol=1e-8),
              "fac": dict(rtol=1e-5, atol=1e-8),
              "v": dict(rtol=1e-5, atol=1e-8)}
# Adam's eps regime (tests/test_torch_baselines.py MAX_EPS_ELEMENTS):
# where a node's clipped gradient element is itself near eps, the
# frameworks' gradient gap shifts its step lr·m/(sqrt(v) + eps) by up to
# 2·lr.  Under adamw at most this many parameters a state may leave the
# atol, each within atol + 2·lr, and as many moments their tolerance,
# each within twice it (seen: one of 25,088 teacher fc1 weights of the
# noniid40 ProFe run, node 0, 7.7e-5 apart in round 1, and the teacher
# fc2 momentum on that weight's hidden unit, 1.3e-6 apart; the port's
# masked steps themselves equal per-node steps bit for bit).
MAX_EPS_ELEMENTS = 2
LR = 1e-3
HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
SGD_HP = dict(momentum=0.9, weight_decay=0.01)
STEPS = [3, 1, 7, 2]                       # each node's counter
MASKS = {"mixed": [True, False, True, False], "all": [True] * 4,
         "none": [False] * 4}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x) -> bytes:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x
                      ).tobytes()


# -- the plain masked sweeps ---------------------------------------------------

def _planes(seed: int, n=N_NODES, r=16, c=512):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((n, r, c)) * 1e-2).astype(np.float32)
    p = (rng.standard_normal((n, r, c)) * 0.1).astype(np.float32)
    mu = (rng.standard_normal((n, r, c)) * 1e-3).astype(np.float32)
    nu = (rng.random((n, r, c)) * 1e-5).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return [_t(x) for x in (g, p, mu, nu, scale)]


def _bc(steps):
    s = torch.tensor(steps, dtype=torch.float32)
    return 1.0 - 0.9 ** s, 1.0 - 0.999 ** s


def _sweep(kernel, g, p, mu, nu, scale, bc1, bc2, active):
    lr = torch.tensor(1e-3)
    if kernel == "adamw":
        return adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale, bc1=bc1,
                                bc2=bc2, active=active, **HP)
    if kernel == "sgd":
        return sgd_update_ref(g, p, mu, lr=lr, scale=scale, active=active,
                              **SGD_HP)
    return (adafactor_apply_ref(g, p, lr=lr, weight_decay=0.01,
                                active=active),)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kernel", ["adamw", "sgd", "adafactor"])
def test_masked_sweep_plain_versions(kernel, mask):
    """Rows 1, 5 and 6's plain versions with a per-node mask and (adamw)
    per-node bias corrections: a masked node's planes come back
    bit-unchanged, an active node's bit-equal to a one-node sweep at its
    own counter; an all-on mask equals no mask bit for bit."""
    g, p, mu, nu, scale = _planes(1)
    bc1, bc2 = _bc(STEPS)
    active = torch.tensor(MASKS[mask])
    got = _sweep(kernel, g, p, mu, nu, scale, bc1, bc2, active)
    before = (p, mu, nu)
    for i in range(N_NODES):
        one = _sweep(kernel, g[i:i + 1], p[i:i + 1], mu[i:i + 1],
                     nu[i:i + 1], scale[i:i + 1], bc1[i:i + 1],
                     bc2[i:i + 1], None)
        for k, out in enumerate(got):
            want = one[k][0] if MASKS[mask][i] else before[k][i]
            assert _bits(out[i]) == _bits(want), (kernel, i, k)
    if mask == "all":
        for a, b in zip(got, _sweep(kernel, g, p, mu, nu, scale, bc1, bc2,
                                    None)):
            assert _bits(a) == _bits(b)


def test_masked_dispatch_updates_in_place_on_the_cpu():
    """``fused_adamw_update`` / ``fused_sgd_update`` with a mask on CPU
    tensors: the plain versions, in place."""
    g, p, mu, nu, scale = _planes(2)
    bc1, bc2 = _bc(STEPS)
    active = torch.tensor(MASKS["mixed"])
    lr = torch.tensor(1e-3)
    want = adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale, bc1=bc1,
                            bc2=bc2, active=active, **HP)
    pp, mm, vv = p.clone(), mu.clone(), nu.clone()
    fused_adamw_update(g, pp, mm, vv, lr, scale, bc1, bc2, active=active,
                       **HP)
    assert all(torch.equal(a, b) for a, b in zip((pp, mm, vv), want))
    want = sgd_update_ref(g, p, mu, lr=lr, scale=scale, active=active,
                          **SGD_HP)
    pp, mm = p.clone(), mu.clone()
    fused_sgd_update(g, pp, mm, lr, scale, active=active, **SGD_HP)
    assert all(torch.equal(a, b) for a, b in zip((pp, mm), want))


@pytest.fixture
def card_tensors(monkeypatch):
    """CPU tensors that pass the wrappers' device check, so their mask
    checks are reached (each raises before any launch)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))


@pytest.mark.parametrize("bad", ["adamw bc shape", "adamw active dtype",
                                 "sgd active shape",
                                 "adafactor straddles", "adafactor flat"])
def test_masked_wrappers_raise(card_tensors, bad):
    x = torch.zeros((2, 4, 8))
    lr, scale = torch.ones(()), torch.ones(2)
    on = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError):
        if bad == "adamw bc shape":
            tkopt.adamw_update_cuda(x, x, x, x, lr, scale, torch.ones(()),
                                    torch.ones(()), **HP)
        elif bad == "adamw active dtype":
            tkopt.adamw_update_cuda(x, x, x, x, lr, scale, torch.ones(2),
                                    torch.ones(2), active=torch.ones(2),
                                    **HP)
        elif bad == "sgd active shape":
            tkopt.sgd_update_cuda(x, x, x, lr, scale, active=on[:1],
                                  **SGD_HP)
        elif bad == "adafactor straddles":
            # 3 x 5 elements a plane: a float4 vector would span two
            y = torch.zeros((2, 3, 5))
            tkopt.adafactor_apply_cuda(y, y, lr, weight_decay=0.01,
                                       active=on)
        else:
            tkopt.adafactor_apply_cuda(torch.zeros(16), torch.zeros(16), lr,
                                       weight_decay=0.01, active=on)


# -- the per-leaf and plane optimizers under a mask ---------------------------

def _leaf_tree(seed: int, n=N_NODES, sc=0.1):
    """A small node-stacked tree: a conv kernel, a bias, a dense kernel
    (factored and unfactored adafactor leaves), in a list and dicts."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return _t((rng.standard_normal((n,) + shape) * sc)
                  .astype(np.float32))
    return {"conv": {"kernel": r(3, 3, 2, 4), "bias": r(4)},
            "dense": [r(24, 10)]}


def _stacked_opt(opt, params, steps):
    """Per-node ``opt.init`` stacked as ``stack_states`` stacks it, the
    counters set to ``steps``."""
    inits = [opt.init(tree_map(lambda x: x[i], params))
             for i in range(len(steps))]
    st = {k: tree_map(lambda *xs: torch.stack(xs), *(s[k] for s in inits))
          for k in inits[0]}
    st["step"] = torch.tensor(steps, dtype=torch.int32)
    return st


def _node(tree, i):
    """Node ``i`` of a stacked tree as a one-node stack (a copy)."""
    return tree_map(lambda x: x[i:i + 1].clone(), tree)


PER_LEAF_MASKS = ([True, False, True, False], [False, True, True, False])


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_per_leaf_optimizer_masked_step(name):
    """The per-leaf optimizer (``lead=1``) with per-node counters and a
    mask, over 2 steps with other masks: masked nodes keep parameters,
    moments and counter bit for bit, active ones equal a one-node update
    at their own counter bit for bit."""
    opt = make_optimizer(name, 1e-2, weight_decay=0.01, momentum=0.9)
    params = _leaf_tree(3)
    state = _stacked_opt(opt, params, STEPS)
    opt.update(_leaf_tree(4, sc=1e-2), state, params, lead=1)   # warm up
    for t, mask in enumerate(PER_LEAF_MASKS):
        grads = _leaf_tree(5 + t, sc=1e-2)
        want = []
        for i in range(N_NODES):
            p_i = _node(params, i)
            s_i = {k: _node(v, i) for k, v in state.items()}
            if mask[i]:
                opt.update(_node(grads, i), s_i, p_i, lead=1)
            want.append((p_i, s_i))
        opt.update(grads, state, params, lead=1, active=torch.tensor(mask))
        for i, (p_i, s_i) in enumerate(want):
            for a, b in zip(tree_leaves(params), tree_leaves(p_i)):
                assert _bits(a[i:i + 1]) == _bits(b)
            for k in state:
                for a, b in zip(tree_leaves(state[k]), tree_leaves(s_i[k])):
                    assert _bits(a[i:i + 1]) == _bits(b), (name, k, i)
    assert state["step"].tolist() == [
        s + 1 + sum(m[i] for m in PER_LEAF_MASKS)
        for i, s in enumerate(STEPS)]


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_plane_optimizer_masked_bit_identical_to_per_leaf(name):
    """The fused plane optimizer and the per-leaf optimizer after the
    per-node clip, under per-node counters and a mask that changes each
    step, bit for bit: parameters, moments, counters; a masked node keeps
    its ``gnorm``."""
    clip = 0.5
    tp = _leaf_tree(6)
    leaf_opt = make_optimizer(name, 1e-2, weight_decay=0.01, momentum=0.9)
    plane_opt = make_plane_optimizer(name, 1e-2, weight_decay=0.01,
                                     momentum=0.9, grad_clip=clip)
    planes = [tplane.plane_from_tree(tree_map(lambda x: x[i], tp))
              for i in range(N_NODES)]
    meta = planes[0].meta
    pl = tplane.Plane(torch.stack([p.buf for p in planes]), meta)
    inits = [plane_opt.init(p) for p in planes]
    pst = {k: tree_map(lambda *xs: torch.stack(xs), *(s[k] for s in inits))
           for k in inits[0]}
    pst["step"] = torch.tensor(STEPS, dtype=torch.int32)
    lst = _stacked_opt(leaf_opt, tp, STEPS)
    masks = ([True, True, True, True], [True, False, True, False],
             [False, True, True, False], [False] * 4)
    for k, mask in enumerate(masks):
        active = torch.tensor(mask)
        g = _leaf_tree(7 + k, sc=0.05 * (k + 1))
        gc, gn = clip_by_global_norm(g, clip, lead=1)
        leaf_opt.update(gc, lst, tp, lead=1, active=active)
        gp = torch.stack([tplane.plane_from_tree(tree_map(
            lambda x: x[i], g)).buf for i in range(N_NODES)])
        gnorm_before = pst["gnorm"].clone()
        plane_opt.update(tplane.Plane(gp, meta), pst, pl, active=active)
        assert torch.equal(pst["gnorm"], torch.where(active, gn,
                                                     gnorm_before))
        for a, b in zip(tree_leaves(tplane.as_tree(pl)), tree_leaves(tp)):
            assert torch.equal(a, b), f"step {k}"
        assert torch.equal(pst["step"], lst["step"])
        if name == "adafactor":
            for a, b in zip(tree_leaves(pst["fac"]), tree_leaves(lst["v"])):
                assert torch.equal(a, b)
        else:
            for path, shape, row, r_leaf in (r[1:] for r in meta.recipe):
                want = lst["mu"]
                for key in path:
                    want = want[key]
                assert torch.equal(tplane._leaf_view(pst["mu"], shape, row,
                                                     r_leaf), want)
    assert pst["step"].tolist() == [s + n for s, n in zip(
        STEPS, np.sum(masks, axis=0).tolist())]


def test_per_leaf_sgd_masked_matches_jax_masked_select():
    """The per-leaf sgd under a mask against ``repro``'s vmapped update
    merged by ``_masked_select``, bit for bit (counters included)."""
    params = {k: np.asarray(v) for k, v in
              {"a": np.random.default_rng(8).standard_normal(
                  (N_NODES, 6, 5)).astype(np.float32)}.items()}
    grads = {"a": (np.random.default_rng(9).standard_normal(
        (N_NODES, 6, 5)) * 1e-2).astype(np.float32)}
    mask = np.asarray(MASKS["mixed"], np.float32)
    jopt = jmake_optimizer("sgd", 1e-2, weight_decay=0.01, momentum=0.9)
    jst = jax.vmap(jopt.init)(params)
    jst = dict(jst, step=jax.numpy.asarray(STEPS, jax.numpy.int32))
    jnew_p, jnew_s = jax.vmap(jopt.update)(grads, jst, params)
    jp = JF._masked_select(jax.numpy.asarray(mask), jnew_p, params)
    js = JF._masked_select(jax.numpy.asarray(mask), jnew_s, jst)
    topt = make_optimizer("sgd", 1e-2, weight_decay=0.01, momentum=0.9)
    tp = {"a": _t(params["a"].copy())}
    tst = _stacked_opt(topt, tp, STEPS)
    topt.update({"a": _t(grads["a"])}, tst, tp, lead=1,
                active=torch.tensor(mask > 0))
    assert _bits(tp["a"]) == _bits(jp["a"])
    assert _bits(tst["mu"]["a"]) == _bits(js["mu"]["a"])
    assert _bits(tst["step"]) == _bits(js["step"])


# -- whole runs against the JAX package ----------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _a(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


WIRES = {"16": {}, "fp32": dict(quantize_bits=0),
         "4/16+ef": dict(quantize_bits=4, proto_quantize_bits=16,
                         error_feedback=True)}


def _setup(split, optimizer, wire, rounds=2, per_node=56, batch=16, **fed):
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32")
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, split, 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full",
              **WIRES[wire], **fed)
    train_kw = dict(batch_size=batch, remat=False, optimizer=optimizer)
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
    kw = dict(weight_decay=jtrain.weight_decay, momentum=jtrain.momentum)
    opt_t = jmake_optimizer(jtrain.optimizer, jtrain.learning_rate, **kw)
    opt_s = jplane.make_plane_optimizer(
        jtrain.optimizer, jtrain.learning_rate, grad_clip=jtrain.grad_clip,
        **kw) if plane else opt_t
    _, _, _, _, cfgs = JF._algo_wiring(algo, jcfg, scfg, jfed, jtrain,
                                       opt_s, opt_t, jit=False)
    return JF._init_states(algo, cfgs, jfed, opt_s, opt_t, 10,
                           plane=plane), plane


def _carry(st, plane: bool):
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), plane=plane, device="cpu")


def _snapshot(state, leaves):
    """numpy copies of a stacked state of either package."""
    def moments(opt):
        return {k: [_a(x) for x in leaves(v)] for k, v in opt.items()
                if k not in ("step", "gnorm")}

    def steps(opt):
        return _a(opt["step"]).tolist() if opt else None
    student = state.student
    student = student.buf if hasattr(student, "buf") else student
    ws = state.wire_state
    return {"student": [_a(x) for x in leaves(student)],
            "teacher": [_a(x) for x in leaves(state.teacher)],
            "opt_s": moments(state.opt_s), "opt_t": moments(state.opt_t),
            "steps": (steps(state.opt_s), steps(state.opt_t)),
            "global_protos": _a(state.global_protos),
            "proto_mask": _a(state.proto_mask),
            "round_idx": _a(state.round_idx).tolist(),
            "residual": None if ws is None else (
                _a(ws.residual["protos"]), _a(ws.residual["student"].buf)),
            "seq": None if ws is None else _a(ws.seq).tolist()}


def _recording(make_round_fn, calls, leaves):
    """Wrap a package's ``_make_round_fn``: every round ``run_federation``
    drives is recorded, its staged inputs, flags and (copied) state."""
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


def _assert_state_close(t, j, p_delta=None, eps_elements=0, atol=2e-5):
    beyond, gap = 0, 0.0
    for key in ("student", "teacher"):
        assert len(t[key]) == len(j[key])
        for a, b in zip(t[key], j[key]):
            assert a.shape == b.shape
            d = np.abs(a - b)
            beyond += int(np.count_nonzero(d > atol))
            gap = max(gap, float(d.max(initial=0.0)))
    assert beyond <= eps_elements and gap <= atol + 2 * LR, (beyond, gap)
    beyond = 0
    for key in ("opt_s", "opt_t"):
        assert sorted(t[key]) == sorted(j[key])
        for k in t[key]:
            assert len(t[key][k]) == len(j[key][k]) > 0
            tol = dict(rtol=0.0)
            tol.update(MOMENT_TOL[k])
            for a, b in zip(t[key][k], j[key][k]):
                bound = tol["atol"] + tol["rtol"] * np.abs(b)
                d = np.abs(a - b)
                beyond += int(np.count_nonzero(d > bound))
                assert np.all(d <= 2 * bound), (key, k)
    assert beyond <= eps_elements, beyond
    assert t["steps"] == j["steps"]
    np.testing.assert_allclose(t["global_protos"], j["global_protos"],
                               rtol=0, atol=1e-4)
    assert t["proto_mask"].tobytes() == j["proto_mask"].tobytes()
    assert t["round_idx"] == j["round_idx"]
    assert t["seq"] == j["seq"]
    if t["residual"] is not None:
        (tp_res, ts_res), (jp_res, js_res) = t["residual"], j["residual"]
        np.testing.assert_allclose(ts_res, js_res, rtol=0, atol=RES_ATOL)
        gap = np.abs(tp_res - jp_res).reshape(N_NODES, -1)
        off = gap > PROTO_RES_ATOL
        assert np.count_nonzero(off) <= MAX_INT16_PROTO_FLIPS
        assert np.all(gap <= PROTO_RES_ATOL + off * p_delta[:, None])


RUNS = [("noniid40", "adamw", "exact", "profe", "16"),
        ("dirichlet", "adamw", "fused", "profe", "16"),
        ("noniid40", "sgd", "exact", "profe", "4/16+ef"),
        ("dirichlet", "adafactor", "exact", "profe", "16"),
        ("noniid40", "adamw", "exact", "fedavg", "fp32")]


@pytest.mark.parametrize("split,optimizer,proto_pass,algo,wire", RUNS,
                         ids=["/".join(r) for r in RUNS])
def test_run_federation_matches_jax_on_unequal_splits(
        split, optimizer, proto_pass, algo, wire, monkeypatch):
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        split, optimizer, wire, proto_pass=proto_pass, algorithm=algo)
    n_batches = [len(d["label"]) // 16 for d in node_data]
    assert len(set(n_batches)) > 1          # the split is unequal
    jcalls, tcalls = [], []
    monkeypatch.setattr(JF, "_make_round_fn", _recording(
        JF._make_round_fn, jcalls, jax.tree_util.tree_leaves))
    monkeypatch.setattr(TF, "_make_round_fn", _recording(
        TF._make_round_fn, tcalls, tree_leaves))
    proto_deltas = []       # the port's prototype Δ per node, each round

    def quantize_packed_buffer(*args, **kwargs):
        out = quantize(*args, **kwargs)
        proto_deltas.append(np.array(out[1][:, 0]))     # segment 0: protos
        return out
    quantize = tqops.quantize_packed_buffer
    monkeypatch.setattr(tqops, "quantize_packed_buffer",
                        quantize_packed_buffer)
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
    jstates, plane = _jax_states(jcfg, jfed, jtrain)
    tres = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             initial_states=[_carry(s, plane)
                                             for s in jstates],
                             device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    assert tres.comm.summary() == jres.comm.summary()
    assert len(tcalls) == len(jcalls) == 2
    for rnd, (t, j) in enumerate(zip(tcalls, jcalls)):
        assert t["flags"] == j["flags"] and t["flags"][1] is False
        assert len(t["inputs"]) == len(j["inputs"])
        for a, b in zip(t["inputs"], j["inputs"]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        _assert_state_close(
            t["state"], j["state"],
            proto_deltas[rnd] if wire.endswith("+ef") else None,
            eps_elements=MAX_EPS_ELEMENTS if optimizer == "adamw" else 0)
        # each node stepped its own batch count every round
        assert t["state"]["steps"][0] == [(rnd + 1) * b for b in n_batches]
    assert tres.state.opt_s["step"].tolist() == \
        [2 * b for b in n_batches]
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round


# -- resume ------------------------------------------------------------------

def _states_equal(a, b) -> bool:
    ia, ib = keyed_leaves(a), keyed_leaves(b)
    return [k for k, _ in ia] == [k for k, _ in ib] and all(
        _bits(x) == _bits(y) and x.shape == y.shape
        for (_, x), (_, y) in zip(ia, ib))


@pytest.mark.parametrize("layout", ["per-node", "shared counter"])
def test_resume_from_a_checkpoint_is_bit_identical(layout, tmp_path):
    """A ``noniid40`` run's state after round 1 (unequal per-node
    counters) saved, loaded and resumed for round 2 equals the
    uninterrupted run bit for bit.  ``shared counter``: an iid run's
    state saved with every step counter one 0-d tensor, the layout of a
    checkpoint from before per-node counters, loads with the counter
    broadcast to every node and resumes bit for bit."""
    split = "noniid40" if layout == "per-node" else "iid"
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup(
        split, "adamw", "4/16+ef")
    full = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             device="cpu")
    one = TF.run_federation(tcfg, dataclasses.replace(tfed, rounds=1),
                            ttrain, node_data, test_d, device="cpu")
    steps = one.state.opt_s["step"].tolist()
    assert (len(set(steps)) > 1) == (layout == "per-node")
    saved = one.state
    if layout == "shared counter":
        saved = saved._replace(
            opt_s=dict(saved.opt_s, step=saved.opt_s["step"][0]),
            opt_t=dict(saved.opt_t, step=saved.opt_t["step"][0]))
    path = str(tmp_path / "round1")
    save_checkpoint(path, saved)
    back = load_checkpoint(path, one.state)
    assert _states_equal(back, one.state)
    resumed = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                                initial_states=back, start_round=1,
                                device="cpu")
    assert _states_equal(resumed.state, full.state)
    assert resumed.f1_per_round == full.f1_per_round[1:]
