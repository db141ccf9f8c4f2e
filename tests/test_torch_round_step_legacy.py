"""The round-step microbenchmark's rounds on the CPU: the seed's per-node
``legacy_round`` against the JAX script's, and the stacked round as the
script wires it against the port's own ``legacy_round``.

The helpers and the tolerances, with their reasons, are in
``tests/torch_round_step_helpers.py``.
"""
import jax
import numpy as np
import torch

# the helpers put the repository root on sys.path for ``benchmarks``
from torch_round_step_helpers import (ATOL, BATCH, N, PROTO_ATOL, SAMPLES, _a,
                                      _assert_students_close, _carry, _f32,
                                      _port_setup)

from benchmarks import round_step as JR
from benchmarks import torch_round_step as S
from repro.core import topology as jtopo
from repro_torch.core import profe as tprofe
from repro_torch.core import topology as ttopo
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)


def test_legacy_round_matches_the_jax_scripts():
    jcfg, jfed, jtrain, jdata = JR._setup(N, SAMPLES, BATCH)
    jcfg = _f32(jcfg)
    jstep, jbits, ncls, _, jstates, jscfg = JR._wiring(jcfg, jfed, jtrain,
                                                       jit=True, plane=False)
    carried = [_carry(s) for s in jstates]
    adj = jtopo.adjacency(N, jfed.topology)
    sizes = [len(d["label"]) for d in jdata]
    jstates = JR.legacy_round(jstep, jstates, jdata, jcfg, jscfg, jfed,
                              jtrain, adj, sizes, ncls, jbits, 0)

    cfg, fed, train, node_data = _port_setup()
    dev = torch.device("cpu")
    step, bits, tncls, _, _, scfg = S._wiring(cfg, fed, train, dev,
                                              plane=False)
    assert tncls == ncls
    tadj = ttopo.adjacency(N, fed.topology)
    assert (tadj == adj).all()
    tstates = S.legacy_round(step, carried, node_data, cfg, scfg, fed, train,
                             tadj, sizes, ncls, bits, 0, dev)
    _assert_students_close(
        [[_a(x) for x in tree_leaves(s.student)] for s in tstates],
        [[np.asarray(x) for x in jax.tree_util.tree_leaves(s.student)]
         for s in jstates])
    for t, j in zip(tstates, jstates):
        np.testing.assert_allclose(_a(t.global_protos[0]),
                                   np.asarray(j.global_protos), rtol=0,
                                   atol=PROTO_ATOL)
        assert _a(t.proto_mask[0]).tobytes() == \
            np.asarray(j.proto_mask).tobytes()
        assert int(t.round_idx[0]) == int(j.round_idx) == 1


def test_stacked_round_matches_the_ports_legacy_round():
    cfg, fed, train, node_data = _port_setup()
    dev = torch.device("cpu")
    adj = ttopo.adjacency(N, fed.topology)
    sizes = [len(d["label"]) for d in node_data]

    step, bits, ncls, _, states, scfg = S._wiring(cfg, fed, train, dev,
                                                  plane=False)
    legacy = S.legacy_round(step, [tprofe.stack_states([s]) for s in states],
                            node_data, cfg, scfg, fed, train, adj, sizes,
                            ncls, bits, 0, dev)

    step_p, bits_p, _, _, states_p, _ = S._wiring(cfg, fed, train, dev)
    stacked = tprofe.stack_states(states_p)
    assert isinstance(stacked.student, S.Plane)
    round_fn = S.F._make_round_fn(step_p, scfg, ncls, share_protos=True,
                                  wire_model="student", bits=bits_p)
    xb, valid, pxb, pvalid, av = S._round_inputs(node_data, BATCH, fed, 0,
                                                 dev)
    stacked = round_fn(stacked, xb, valid, pxb, pvalid,
                       *S._gossip(adj, sizes, dev), teacher_on=True,
                       all_valid=av)

    _assert_students_close(
        [[_a(x) for x in tree_leaves(tprofe.node_params(stacked.student, i))]
         for i in range(N)],
        [[_a(x[0]) for x in tree_leaves(s.student)] for s in legacy])
    for i, s in enumerate(legacy):
        for a, b in zip(tree_leaves(tprofe.node_params(stacked.teacher, i)),
                        tree_leaves(s.teacher)):
            np.testing.assert_allclose(_a(a), _a(b[0]), rtol=0, atol=ATOL)
        for key, atol in (("mu", 1e-6), ("nu", 1e-8)):
            for a, b in zip(tree_leaves(s.opt_t[key]),
                            tree_leaves(stacked.opt_t[key])):
                np.testing.assert_allclose(_a(a[0]), _a(b[i]), rtol=0,
                                           atol=atol)
        assert int(s.opt_s["step"][0]) == int(stacked.opt_s["step"][i])
        assert int(s.opt_t["step"][0]) == int(stacked.opt_t["step"][i])
        np.testing.assert_allclose(_a(s.global_protos[0]),
                                   _a(stacked.global_protos[i]), rtol=0,
                                   atol=PROTO_ATOL)
        assert _a(s.proto_mask[0]).tobytes() == \
            _a(stacked.proto_mask[i]).tobytes()
        assert int(s.round_idx[0]) == int(stacked.round_idx[i]) == 1
