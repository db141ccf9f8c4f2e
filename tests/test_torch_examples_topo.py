"""The port's topology byte-gate suite (``benchmarks/torch_dryrun_topo.py``)
and its mesh demo (``examples/torch_mesh_federation_demo.py``) on the
CPU, held against the JAX package's scripts and committed reports.

* ``TOPO_SUITE`` equals ``benchmarks/dryrun_all.py``'s; the shape-derived
  keys of all four rows from ``launch/wire.exchange_predictions`` (no
  spawn) equal ``reports/dryrun/topology_*.json`` exactly, and one yi-6b
  adapter row's spawned ``ppermute`` bytes too;
* the suite script's comparison and exit code on reports that agree
  with the JAX reports and on reports that do not;
* demo parts (a)-(c) on 2 gloo ranks: the aggregate within the 16-bit
  step of the exact weighted mean, C̄[0,0] 1.5, the bytes a rank.
"""
import copy
import json
import sys
import types
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "examples"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch_mesh_federation_demo as demo  # noqa: E402
from benchmarks import torch_dryrun_topo as topo  # noqa: E402


def test_topo_suite_equals_jax():
    from benchmarks.dryrun_all import TOPO_SUITE
    assert topo.TOPO_SUITE == TOPO_SUITE

def _row_args(extra):
    """A suite row's dryrun flags as ``(spec, adapter rank, grams)``."""
    import argparse
    import dataclasses

    from repro_torch.wirespec import WireSpec
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", default="16")
    ap.add_argument("--ef", action="store_true")
    ap.add_argument("--adapters", type=int, default=0)
    ap.add_argument("--adapter-grams", action="store_true")
    a = ap.parse_args(extra)
    spec = WireSpec.parse(a.bits)
    if a.ef:
        spec = dataclasses.replace(spec, error_feedback=True)
    return spec, a.adapters, a.adapter_grams


def _jax_report(tag):
    return json.loads((topo.JAX_REPORTS / f"topology_{tag}.json")
                      .read_text())


@pytest.mark.parametrize("row", topo.TOPO_SUITE, ids=lambda r: r[4])
def test_topo_suite_shape_keys_equal_jax_reports(row):
    from repro_torch.launch.wire import exchange_predictions
    arch, topology, pods, extra, tag = row
    spec, rank, grams = _row_args(extra)
    got = exchange_predictions(arch, int(pods), topology, spec,
                               adapter_rank=rank, adapter_grams=grams)
    want = _jax_report(tag)
    assert set(got) == set(topo.SHAPE_KEYS)
    for key in topo.SHAPE_KEYS:
        assert got[key] == want[key], (tag, key)
    assert want["bits"] == spec.describe()


def test_yi6b_adapter_row_ppermute_bytes_equal_jax_report():
    """The yi-6b ring-8 int4 adapter row's permute, on 8 spawned ranks:
    its bytes a node the JAX report's and the accountant's."""
    from repro_torch.launch.wire import measure_exchange_bytes
    arch, topology, pods, extra, tag = topo.TOPO_SUITE[2]
    spec, rank, grams = _row_args(extra)
    got = measure_exchange_bytes(arch, int(pods), topology, bits=spec,
                                 exchanges=("ppermute",), adapter_rank=rank,
                                 adapter_grams=grams, device="cpu")
    want = _jax_report(tag)
    perm = got["exchanges"]["ppermute"]
    assert perm["collective_bytes_per_node"] == \
        want["exchanges"]["ppermute"]["collective_bytes_per_node"] == \
        got["packed_pred_bytes_per_node"] == 37112
    assert perm["by_kind"] == {"collective-permute": 37112.0}
    assert perm["launches"] == {}           # no kernel off the card
    # the adapter wire has no full-graph reference
    assert got["full_gather_bytes_per_node"] is None


def _agreeing_reports(out_dir: Path, device: str = "cpu"):
    """The JAX reports as the port's passed reports in ``out_dir``."""
    digest = topo.source_digest()
    for _, _, _, _, tag in topo.TOPO_SUITE:
        rep = dict(_jax_report(tag), device=device, source_digest=digest)
        (out_dir / f"topology_{tag}.json").write_text(json.dumps(rep))


def test_dryrun_topo_script_holds_reports(tmp_path, capsys):
    """The script reuses passed reports in ``--out-dir`` and holds each to
    the JAX report: the JAX reports themselves pass (exit 0); a changed
    ppermute, reference or shape key fails its row (exit 1), and so
    does a missing reference."""
    _agreeing_reports(tmp_path)
    assert topo.main(["--out-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("[OK]") == 4 and "0 failures" in out
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["ok"] and summary["device"] == "cpu"
    assert [r["tag"] for r in summary["rows"]] == \
        [t for *_, t in topo.TOPO_SUITE]
    for row in summary["rows"]:
        assert row["ok"] and all(g == w for _, g, w in row["compared"])
    for tag, path in (
            ("mnist-cnn_ring8", ("exchanges", "ppermute",
                                 "collective_bytes_per_node")),
            ("mnist-cnn_ring8_int4ef", ("int16_reference", "exchanges",
                                        "ppermute",
                                        "collective_bytes_per_node")),
            ("yi-6b_ring8_int4_adapters8", ("packed_copy_bytes",)),
            ("yi-6b_ring8_int4_adapters8_grams", ("dense_reference",))):
        _agreeing_reports(tmp_path)
        f = tmp_path / f"topology_{tag}.json"
        rep = json.loads(f.read_text())
        d = rep
        for k in path[:-1]:
            d = d[k]
        if path[-1] == "dense_reference":
            del d[path[-1]]
        else:
            d[path[-1]] += 8
        f.write_text(json.dumps(rep))
        res = topo.run(str(tmp_path), device="cpu")
        assert [r["tag"] for r in res["rows"] if not r["ok"]] == [tag]
        assert topo.main(["--out-dir", str(tmp_path), "--device",
                          "cpu"]) == 1
        assert "MISMATCH" in capsys.readouterr().out


def test_dryrun_topo_reruns_reports_of_other_sources(tmp_path,
                                                     monkeypatch):
    """A passed report is reused only with the sources' digest it was
    measured with: a report from other sources (or without a digest)
    runs its audit again, here a stub that fails, so every row fails."""
    calls = []

    def audit(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(returncode=3, stderr="stub")
    monkeypatch.setattr(topo.subprocess, "run", audit)
    _agreeing_reports(tmp_path)
    for i, (*_, tag) in enumerate(topo.TOPO_SUITE):
        f = tmp_path / f"topology_{tag}.json"
        rep = json.loads(f.read_text())
        if i % 2:
            rep["source_digest"] = "0" * 64
        else:
            del rep["source_digest"]
        f.write_text(json.dumps(rep))
    res = topo.run(str(tmp_path), device="cpu")
    assert len(calls) == 4 and not any(r["ok"] for r in res["rows"])
    assert all("exit 3" in r["error"] for r in res["rows"])


def test_dryrun_topo_compares_the_listed_keys():
    want = _jax_report("yi-6b_ring8_int4_adapters8")
    keys = [k for k, _, _ in topo.compared(copy.deepcopy(want), want)]
    assert keys == list(topo.SHAPE_KEYS) + [
        "exchanges.ppermute", "dense_reference.exchanges.ppermute",
        "int16_reference.exchanges.ppermute"]
    plain = _jax_report("mnist-cnn_ring8")
    assert len(topo.compared(plain, plain)) == len(topo.SHAPE_KEYS) + 1


# -- the mesh demo ------------------------------------------------------------------

def test_mesh_demo_parts_a_to_c_on_two_ranks():
    """Parts (a)-(c) on 2 spawned gloo ranks (part (d) is the audit of
    ``tests/test_torch_dryrun.py``): the aggregate within the 16-bit
    step of 0.25·s0 + 0.75·s1, C̄[0,0] 1.5, ProFe's bytes a rank the
    packed copy's, FedAvg's the teacher's fp32 rows, the star graph's
    nodes apart but within a step of each other."""
    from repro_torch.launch.wire import exchange_predictions, spawn_ranks
    recs = spawn_ranks({"device": "cpu"}, 2, main=demo._rank)
    copy16 = exchange_predictions("yi-6b", 2, "full", 16)[
        "packed_copy_bytes"]
    for rec in recs:
        assert 0 < rec["aggregate_err_over_step"] <= 0.5 + 1e-3
        assert rec["aggregate_max_err"] < 1e-4
        assert abs(rec["c_bar_00"] - 1.5) <= 2 / demo.QMAX16
        assert rec["profe_bytes_per_rank"] == copy16 == 565336
        assert rec["fedavg_bytes_per_rank"] == rec["fedavg_pred_bytes"]
        assert rec["star_protos_shape"] == [2, 8, 128]
        assert 0 < rec["star_divergence"] < 1e-4
        assert rec["launches"] == {}
    assert recs[0]["star_divergence"] == recs[1]["star_divergence"]
