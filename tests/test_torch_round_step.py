"""The port of the round-step microbenchmark (``benchmarks/torch_round_step.py``)
against the JAX script (``benchmarks/round_step.py``) on the CPU: its setup,
``main``'s keys, the ``--wire`` sweep's bytes on 4 gloo ranks, its flags
and refusals.

The helpers and the tolerances, with their reasons, are in
``tests/torch_round_step_helpers.py``.
"""
import json

import numpy as np
import pytest
import torch

# the helpers put the repository root on sys.path for ``benchmarks``
from torch_round_step_helpers import (BATCH, N, SAMPLES, _dict_keys,
                                      _jax_flags)

from benchmarks import round_step as JR
from benchmarks import torch_round_step as S

torch.set_num_threads(2)


def test_setup_is_the_jax_scripts():
    jcfg, jfed, jtrain, jdata = JR._setup(N, SAMPLES, BATCH)
    cfg, fed, train, node_data = S._setup(N, SAMPLES, BATCH)
    assert cfg.cnn_channels == jcfg.cnn_channels == (8, 16)
    assert (fed.num_nodes, fed.local_epochs, fed.algorithm, fed.topology,
            fed.seed) == (jfed.num_nodes, jfed.local_epochs,
                          jfed.algorithm, jfed.topology, jfed.seed)
    assert (train.batch_size, train.learning_rate, train.optimizer) == \
        (jtrain.batch_size, jtrain.learning_rate, jtrain.optimizer)
    for t, j in zip(node_data, jdata):
        for k in j:
            assert np.asarray(t[k]).tobytes() == np.asarray(j[k]).tobytes()


def test_main_writes_the_jax_keys(tmp_path, capsys):
    out = tmp_path / "rs.json"
    got = S.main(["--nodes", str(N), "--rounds", "1", "--phases",
                  "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert set(got) == {"benchmark", "backend", "card", "config", "nodes"}
    assert (got["backend"], got["card"]) == ("cpu", None)
    assert set(got["nodes"]) == {str(N)}
    row = got["nodes"][str(N)]
    phases = row.pop("phases")
    assert set(row) == _dict_keys("measure")
    assert set(phases) == _dict_keys("measure_phases")
    for v in list(row.values()) + list(phases.values()):
        assert np.isfinite(v) and v >= 0
    _, _, _, jdata = JR._setup(N, SAMPLES, BATCH)
    assert row["local_steps_per_round"] == sum(
        len(d["label"]) // BATCH for d in jdata) == 8
    assert "speedup" in capsys.readouterr().out


def test_wire_sweep_bytes_match_jax(tmp_path):
    """One spawn of 4 ranks: ``16``, ``4/16+ef`` and the int4 adapter
    row; each row's ``ppermute``, ``packed`` and full-gather bytes the
    JAX package's; every exchange timed."""
    from repro.launch.wire import measure_exchange_bytes as jmeasure
    out = tmp_path / "wire.json"
    got = S.main(["--wire", "--wire-nodes", "4", "--wire-bits", "16",
                  "4/16+ef", "--wire-adapters", "8", "--rounds", "2",
                  "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == got
    assert got["config"]["timed_rounds"] == 10      # --wire takes >= 10
    rows = got["per_bits"]
    assert list(rows) == ["16", "4/16+ef", "4+adapters8"]
    assert got["per_pods"] == {"4": rows}
    for label, (bits, rank) in (("16", ("16", 0)),
                                ("4/16+ef", ("4/16+ef", 0)),
                                ("4+adapters8", ("4", 8))):
        rep = rows[label]["exchange"]
        want = jmeasure("mnist-cnn", 4, "ring", bits=bits, adapter_rank=rank)
        assert rep["full_gather_bytes_per_node"] == \
            want["full_gather_bytes_per_node"], label
        for ex in ("ppermute", "packed"):
            assert rep["exchanges"][ex]["collective_bytes_per_node"] == \
                want["exchanges"][ex]["collective_bytes_per_node"], (label,
                                                                      ex)
        for ex, entry in rep["exchanges"].items():
            assert entry["round_ms"] > 0, (label, ex)
            # no kernel launches off the card, in the timed rounds either
            assert entry["timed_launches"] == {}, (label, ex)
        assert rep["full_gather_launches"] == {}, label
        codec = rows[label]["codec"]
        assert codec["per_leaf_ms"] > 0 and codec["packed_ms"] > 0
    assert rows["16"]["ppermute_vs_full_gather"] == 0.5   # degree 2 of 4
    assert rows["4+adapters8"]["ppermute_vs_int16"] < 0.05


def test_exchange_entry_times_the_slowest_rank():
    """A round lasts as long as its slowest rank; ``round_ms`` is the
    median of those rounds, and the timed rounds' launches are summed
    over the ranks beside the warm-up's."""
    from repro_torch.launch.wire import _exchange_entry
    records = [{"pod": {}, "inner": {}, "launches": {"rowabs": 1},
                "round_ms": [1.0, 5.0, 2.0], "timed_launches": {"rowabs": 3}},
               {"pod": {}, "inner": {}, "launches": {"rowabs": 1},
                "round_ms": [3.0, 1.0, 2.5], "timed_launches": {"rowabs": 3}}]
    entry = _exchange_entry(records, n_nodes=2, inner=1)
    assert entry["round_ms"] == 3.0              # median of 3, 5 and 2.5
    assert entry["launches"] == {"rowabs": 2}
    assert entry["timed_launches"] == {"rowabs": 6}
    untimed = [{k: v for k, v in r.items()
                if k not in ("round_ms", "timed_launches")} for r in records]
    assert "round_ms" not in _exchange_entry(untimed, n_nodes=2, inner=1)


def test_every_jax_flag_with_its_default():
    want = _jax_flags()
    assert len(want) == 13
    got = {a.option_strings[0]: a.default for a in S.parser()._actions
           if a.option_strings and a.option_strings[0] != "-h"}
    assert set(got) == set(want) | {"--device"}
    for flag, default in want.items():
        if flag == "--out":
            assert (default, got[flag]) == ("BENCH_round_step.json",
                                            "BENCH_torch_round_step.json")
            continue
        assert got[flag] == default, flag
    assert got["--device"] is None


@pytest.mark.parametrize("argv", [
    ["--out", "BENCH_round_step.json"],
    ["--wire", "--out", "BENCH_wire_exchange.json"],
    ["--wire", "--out", "BENCH_round_step.json"],
    ["--out", "reports/BENCH_wire_exchange.json"],
])
def test_jax_report_names_are_refused(argv, capsys):
    with pytest.raises(SystemExit):
        S.main(argv + ["--device", "cpu"])
    assert "JAX package's report" in capsys.readouterr().err


def test_no_card_and_no_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.main(["--nodes", "2", "--out", str(tmp_path / "rs.json")])
