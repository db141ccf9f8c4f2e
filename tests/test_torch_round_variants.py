"""Round variants of the port's stacked engine against the JAX package on
the CPU: the fused Eq. 3 pass, the prototype EMA, the self-weight floor,
the all-node evaluation and ``chip_smoke.py``'s variant paths.

The helpers and the tolerances, with their reasons, are in
``tests/torch_round_variants_helpers.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import federation as JF
from repro.core import topology as jtopo
from repro_torch.config import base as tbase
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.optim import make_optimizer, make_plane_optimizer

from torch_round_variants_helpers import (FLOOR_TOPOLOGIES, FUSED, N_NODES,
                                          VARIANT_PATHS, _carry,
                                          _chip_smoke_module, _jax_states,
                                          _run_pair, _setup)

torch.set_num_threads(2)


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
