"""Whole ``run_federation_loop`` runs of the port against the JAX package's
on the CPU: the ``4/16+ef`` plane, the adapter wire with its grams, the
per-leaf student with the fused pass and the prototype EMA, and FedProto
with every node evaluated; the loop engine resumed from a stacked state
and against the stacked engine.

The helpers and the tolerances, with their reasons, are in
``tests/torch_loop_engine_helpers.py``.
"""
import torch
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import federation as JF
from repro_torch.core import federation as TF
from repro_torch.tree import keyed_leaves, tree_leaves

from torch_loop_engine_helpers import (LOOP_RUNS, MAX_EPS_ELEMENTS, N_NODES,
                                       RES_ATOL, _a, _assert_students_close,
                                       _bits, _carry, _jax_states,
                                       _recording_eval, _setup)

torch.set_num_threads(2)

CASES = tuple(k for k in LOOP_RUNS
              if k not in ("plane/16", "plane/adapters8"))


@pytest.mark.parametrize("case", list(CASES))
def test_run_federation_loop_matches_jax(case, monkeypatch):
    wire, kw = LOOP_RUNS[case]
    kw = dict(kw)
    setup_kw = {k: kw.pop(k) for k in ("channels", "rounds") if k in kw}
    run_kw = {k: kw.pop(k) for k in ("eval_all_nodes",) if k in kw}
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        wire, **setup_kw, **kw)
    jrounds, trounds = [], []
    monkeypatch.setattr(JF, "_eval_nodes", _recording_eval(
        JF, jrounds, lambda t: jax.tree_util.tree_leaves(t)))
    monkeypatch.setattr(TF, "_eval_nodes", _recording_eval(
        TF, trounds, tree_leaves))
    jres = JF.run_federation_loop(jcfg, jfed, jtrain, node_data, test_d,
                                  **run_kw)
    jstates, plane = _jax_states(jcfg, jfed, jtrain)
    tres = TF.run_federation_loop(
        tcfg, tfed, ttrain, node_data, test_d,
        initial_states=[_carry(s, plane) for s in jstates], device="cpu",
        **run_kw)
    assert tres.extras["param_plane"] is plane
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert tres.extras[key] == jres.extras[key], key
    for key in ("sent", "received", "by_round", "by_kind"):
        assert dict(getattr(tres.comm, key)) == dict(getattr(jres.comm, key))
    _assert_students_close(trounds, jrounds, MAX_EPS_ELEMENTS)
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round
    if run_kw:
        for key in ("f1_per_round_nodes", "acc_per_round_nodes",
                    "f1_std_per_round"):
            assert tres.extras[key] == jres.extras[key], key
    st = tres.state
    n_batches = [max(len(d["label"]) // 16, 1) for d in node_data]
    assert st.opt_s["step"].tolist() == [tfed.rounds * b for b in n_batches]
    assert st.round_idx.tolist() == [tfed.rounds] * N_NODES
    if wire.endswith("+ef"):
        assert tres.extras["wire_state"].seq.tolist() == \
            [tfed.rounds] * N_NODES
    if tfed.adapter_rank:
        f = tres.extras["adapter_factors"]
        assert len(f) == 3 and all(
            x["A"].shape[0] == N_NODES and float(x["A"].abs().max()) > 0
            for x in f.values())


def test_loop_engine_resumes_from_a_stacked_state_bit_for_bit():
    """The loop engine's ``result.state`` (its one-node stacks joined) fed
    back as ``initial_states`` with ``start_round=1`` (split into one-node
    stacks again) ends bit-identical to the uninterrupted run, on the
    ragged ``4/16+ef`` split (the residual and ``seq`` carried)."""
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup("4/16+ef")
    full = TF.run_federation_loop(tcfg, tfed, ttrain, node_data, test_d,
                                  device="cpu")
    one = TF.run_federation_loop(tcfg, dataclasses.replace(tfed, rounds=1),
                                 ttrain, node_data, test_d, device="cpu")
    assert one.state.opt_s["step"].tolist() == [1, 3, 3, 3]
    resumed = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                                initial_states=one.state, start_round=1,
                                device="cpu")
    for (ka, a), (kb, b) in zip(keyed_leaves(resumed.state),
                                keyed_leaves(full.state)):
        assert ka == kb and _bits(a) == _bits(b), ka
    assert resumed.f1_per_round == full.f1_per_round[1:]
    assert resumed.state.wire_state.seq.tolist() == [2] * N_NODES


@pytest.mark.parametrize("wire", ["16", "4/16+ef"])
def test_loop_engine_matches_the_stacked_engine(wire):
    """On an equal split: the port's loop engine against its stacked
    engine, 2 rounds from the same seeded states.  Bytes exactly; the
    final state to the tolerances above (the Adam moments 1e-6 and
    1e-8, the Eq. 4 prototypes 1e-4, the ``+ef`` residual ``RES_ATOL``),
    counters and masks exactly."""
    _, tcfg, node_data, test_d, _, tfed, _, ttrain = _setup(wire,
                                                            ragged=False)
    stacked = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                                device="cpu")
    loop = TF.run_federation_loop(tcfg, tfed, ttrain, node_data, test_d,
                                  device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb"):
        assert loop.extras[key] == stacked.extras[key], key
    for key in ("sent", "received", "by_round"):
        assert dict(getattr(loop.comm, key)) == \
            dict(getattr(stacked.comm, key))
    a, b = loop.state, stacked.state
    for x, y in ((a.student.buf, b.student.buf),
                 *zip(tree_leaves(a.teacher), tree_leaves(b.teacher))):
        np.testing.assert_allclose(_a(x), _a(y), rtol=0, atol=2e-5)
    for key, atol in (("mu", 1e-6), ("nu", 1e-8)):
        for opt in ("opt_s", "opt_t"):
            for x, y in zip(tree_leaves(getattr(a, opt)[key]),
                            tree_leaves(getattr(b, opt)[key])):
                np.testing.assert_allclose(_a(x), _a(y), rtol=0, atol=atol)
    for opt in ("opt_s", "opt_t"):
        assert getattr(a, opt)["step"].tolist() == \
            getattr(b, opt)["step"].tolist()
    np.testing.assert_allclose(_a(a.global_protos), _a(b.global_protos),
                               rtol=0, atol=1e-4)
    assert _bits(a.proto_mask) == _bits(b.proto_mask)
    assert a.round_idx.tolist() == b.round_idx.tolist()
    if wire.endswith("+ef"):
        assert a.wire_state.seq.tolist() == b.wire_state.seq.tolist()
        np.testing.assert_allclose(_a(a.wire_state.residual["student"].buf),
                                   _a(b.wire_state.residual["student"].buf),
                                   rtol=0, atol=RES_ATOL)
