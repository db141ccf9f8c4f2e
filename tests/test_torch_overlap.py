"""The pipelined drivers of the port's stacked engine against the JAX
package on the CPU: ``overlap="none"`` (also against the sequential
engine) and the stale-by-one ``"rounds"``, on the 16-bit, ``4/16+ef``,
adapter and fp32 wires and with the self-weight floor.

The helpers and the tolerances, with their reasons, are in
``tests/torch_round_variants_helpers.py``.
"""
import torch
import numpy as np
import pytest

from repro_torch.core import federation as TF
from repro_torch.tree import tree_leaves

from torch_round_variants_helpers import (N_NODES, WIRES, _leaves_np, _record,
                                          _run_pair, _setup)

torch.set_num_threads(2)


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
