"""The port's stacked ProFe round program driven for 1 and 2 rounds, and a
2-round ``run_federation`` of the mnist-cnn pair, against the JAX
package on the CPU from carried weights, on the 16-bit and the
``4/16+ef`` wires.

The helpers and the tolerances, with their reasons, are in
``tests/torch_federation_helpers.py``.
"""
import torch
import jax
import numpy as np
import pytest

from repro.core import federation as JF
from repro_torch.core import federation as TF
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.tree import tree_leaves

from torch_federation_helpers import (MAX_INT16_PROTO_FLIPS, N_NODES,
                                      PROTO_RES_ATOL, RES_ATOL, WIRES,
                                      _assert_codecs_agree,
                                      _assert_round_matches, _carry,
                                      _ef_codec, _jax_states, _recording,
                                      _setup, two_rounds)

torch.set_num_threads(2)


def test_one_round_matches_the_jax_round_program(two_rounds):
    wire, rounds, staged_pairs, codecs, meta = two_rounds
    (ts, tp), (js, jp) = staged_pairs[0]
    for a, b in zip(jax.tree_util.tree_leaves((ts, tp)),
                    jax.tree_util.tree_leaves((js, jp))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    t, j = rounds[0]
    _assert_codecs_agree(wire, codecs[0])
    _assert_round_matches(t, j, _ef_codec(wire, codecs[0]))
    assert t["round_idx"] == [1] * N_NODES
    assert t["steps"] == (3, 3)
    # padding lanes of the mixed plane (and of the EF residual) stay zero
    real = np.zeros(t["student"].shape[1:], dtype=bool)
    for _, _, shape, row, r_leaf in meta.recipe:
        real[row:row + r_leaf].reshape(-1)[:int(np.prod(shape))] = True
    assert not t["student"][:, ~real].any()
    if wire.endswith("+ef"):
        assert t["seq"] == j["seq"] == [1] * N_NODES
        res = t["residual"][1]
        assert not res[:, ~real].any() and np.abs(res).max() > 0


def test_two_rounds_match_the_jax_round_program(two_rounds):
    """Round 2 runs on round 1's state: the per-round training and proto
    stream seeds, step counters and bias corrections past the first
    round, the teacher gate and round 1's Eq. 4 prototypes and mask."""
    wire, rounds, staged_pairs, codecs, _ = two_rounds
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
    _assert_codecs_agree(wire, codecs[1])
    _assert_round_matches(t, j, _ef_codec(wire, codecs[1]))
    assert t["round_idx"] == [2] * N_NODES
    assert t["steps"] == (6, 6)
    if wire.endswith("+ef"):
        # round 2 quantized x + residual: the carried error re-entered
        assert t["seq"] == j["seq"] == [2] * N_NODES
        assert not np.array_equal(t["residual"][1], t1["residual"][1])


@pytest.mark.parametrize("dtype,wire", [
    ("float32", "16"), ("bfloat16", "16"), ("float32", "4/16+ef")],
    ids=["float32", "bfloat16", "float32-4/16+ef"])
def test_run_federation_matches_jax_from_carried_states(dtype, wire,
                                                        monkeypatch):
    """Whole runs from the same carried weights; on the +ef wire both
    start from run_federation's own zero residual."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        dtype=dtype, **WIRES[wire])
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
        assert len(proto_deltas) == len(tcalls)
        for t, j, p_delta in zip(tcalls, jcalls, proto_deltas):
            t["state"]["logits"] = j["state"]["logits"]
            _assert_round_matches(t["state"], j["state"])
            if wire.endswith("+ef"):
                assert t["state"]["seq"] == j["state"]["seq"]
                (tp_res, ts_res), (jp_res, js_res) = (
                    t["state"]["residual"], j["state"]["residual"])
                np.testing.assert_allclose(ts_res, js_res, rtol=0,
                                           atol=RES_ATOL)
                # an int16 prototype flip moves one residual by one Δ:
                # counted, and held to PROTO_RES_ATOL plus that Δ
                gap = np.abs(tp_res - jp_res).reshape(N_NODES, -1)
                off = gap > PROTO_RES_ATOL
                assert np.count_nonzero(off) <= MAX_INT16_PROTO_FLIPS
                assert np.all(gap <= PROTO_RES_ATOL + off * p_delta[:, None])
        assert ("wire_state" in tres.extras) == wire.endswith("+ef")
        if wire.endswith("+ef"):
            assert tres.extras["wire_state"].seq.tolist() == [2] * N_NODES
        assert tres.f1_per_round == jres.f1_per_round
        assert tres.acc_per_round == jres.acc_per_round
    else:
        n_test = len(test_d["label"])
        np.testing.assert_allclose(tres.acc_per_round, jres.acc_per_round,
                                   rtol=0, atol=1 / n_test + 1e-12)
