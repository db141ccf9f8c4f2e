"""The port's regression gate (``benchmarks/torch_check_regression.py``)
held against the JAX gate (``benchmarks/check_regression.py``) on the
CPU, and the port's committed baselines.

* Verdict for verdict: both gates read the same synthetic baselines (the
  JAX package's committed ``BENCH_round_step.json`` and
  ``BENCH_wire_exchange.json`` with a ``card`` of None, doctored per
  case) and the same fresh numbers: ``measure``, ``measure_phases`` and
  ``subprocess.run`` patched in both modules (the fake wire bench writes
  the case's fresh report to the ``--out`` it is given).  Every printed
  line but the port's ``card:`` lines and the exit code are equal.
  Cases: all OK; a round 1.31× the committed one; each invariant broken
  in turn; a fresh proto pass and a codec 1.31×; a node count the
  baseline lacks; a fresh wire row missing; one byte of drift in each
  byte field; an exchange the baseline recorded as an ``error``
  (``UNCHECKED``); a pre-phase baseline; a pods baseline (``8`` and
  ``4x2``, with ``by_axis`` and ``pod_by_kind_per_node``) and drift in
  each of those; a pre-pods baseline; a wire bench that fails.
* The fake wire bench's argv parses, under ``torch_round_step``'s
  parser, to the baseline's own settings.
* ``main`` end to end on the CPU against a baseline written by
  ``torch_round_step`` at N = 2, one timed round.
* The JAX gate's flags and defaults (its parser, caught as it parses),
  plus ``--device``; the JAX baselines refused by name and by backend; no
  card and no ``--device cpu`` raises.
* The committed ``BENCH_torch_*.json``: from an NVIDIA card, every row's
  bytes the JAX package's committed bytes (``gather`` apart: the port's
  gather moves its own tensors), and ``chip_smoke.py``'s gate holding
  them (``GATE_KNOWN_FAILING`` the committed invariants that fail; a
  byte of drift or a missing row refused).
"""
import argparse
import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the JAX gate imports its sibling as ``round_step``
if str(ROOT / "benchmarks") not in sys.path:
    sys.path.append(str(ROOT / "benchmarks"))

import check_regression as JC  # noqa: E402  (the JAX gate)
from benchmarks import torch_check_regression as G  # noqa: E402
from benchmarks import torch_round_step as RS  # noqa: E402

torch.set_num_threads(2)

JAX_RS = json.loads((ROOT / "BENCH_round_step.json").read_text())
JAX_WIRE = json.loads((ROOT / "BENCH_wire_exchange.json").read_text())
PORT_RS = json.loads((ROOT / "BENCH_torch_round_step.json").read_text())
PORT_WIRE = json.loads((ROOT / "BENCH_torch_wire_exchange.json").read_text())
SLOW = 1.31                    # just above the default 1.3x threshold


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic():
    """(round baseline, wire baseline, fresh): the JAX package's committed
    reports as the port's (``card`` None), the fresh side equal."""
    base = dict(copy.deepcopy(JAX_RS), card=None)
    wire = dict(copy.deepcopy(JAX_WIRE), card=None)
    fresh = {"round": {n: r["jitted_ms"] for n, r in base["nodes"].items()},
             "proto": base["nodes"]["8"]["phases"]["proto_exact_ms"],
             "wire": copy.deepcopy(wire)}
    return base, wire, fresh


def _pods(base, wire, fresh):
    """Add a ``4x2`` pod shape (the plane rows, two ranks a node: the
    node-group bytes apart) to the baseline and the fresh report."""
    wire["config"]["pods"] = ["8", "4x2"]
    rows = {}
    for bits, row in wire["per_pods"]["8"].items():
        if "+adapters" in bits:
            continue
        row = copy.deepcopy(row)
        row["exchange"].update(n_nodes=4, inner=2)
        for ex in row["exchange"]["exchanges"].values():
            total = ex["collective_bytes_per_node"]
            ex["by_axis"] = {"pod": {"all-gather": 4 * total},
                             "node": {"all-gather": total / 2}}
            ex["pod_by_kind_per_node"] = {"all-gather": total}
        rows[bits] = row
    wire["per_pods"]["4x2"] = rows
    fresh["wire"] = copy.deepcopy(wire)


def _phase(n, key, scale, of=None):
    def edit(base, wire, fresh):
        ph = base["nodes"][n]["phases"]
        ph[key] = scale * ph[of or key]
    return edit


def _exchange(row, ex, key, drift=1):
    def edit(base, wire, fresh):
        rep = fresh["wire"]["per_pods"]["8"][row]["exchange"]["exchanges"][ex]
        if isinstance(rep[key], dict):
            kind = next(iter(rep[key]))
            rep[key][kind] += drift
        else:
            rep[key] += drift
    return edit


def _field(row, key, drift=1):
    def edit(base, wire, fresh):
        fresh["wire"]["per_pods"]["8"][row]["exchange"][key] += drift
    return edit


def _slow_round(base, wire, fresh):
    fresh["round"]["4"] *= SLOW


def _slow_proto(base, wire, fresh):
    fresh["proto"] *= SLOW


def _slow_codec(base, wire, fresh):
    fresh["wire"]["per_pods"]["8"]["4/16"]["codec"]["packed_ms"] *= SLOW


def _missing_row(base, wire, fresh):
    del fresh["wire"]["per_pods"]["8"]["4"]


def _error_exchange(base, wire, fresh):
    wire["per_pods"]["8"]["8"]["exchange"]["exchanges"]["gather"] = {
        "error": "RuntimeError: no such exchange"}


def _pre_phase(base, wire, fresh):
    for row in base["nodes"].values():
        del row["phases"]


def _pre_pods(base, wire, fresh):
    del wire["per_pods"], wire["config"]["pods"]


def _pods_axis_drift(base, wire, fresh):
    _pods(base, wire, fresh)
    ex = fresh["wire"]["per_pods"]["4x2"]["16"]["exchange"]["exchanges"]
    ex["ppermute"]["by_axis"]["node"]["all-gather"] += 1


def _pods_kind_drift(base, wire, fresh):
    _pods(base, wire, fresh)
    ex = fresh["wire"]["per_pods"]["4x2"]["8"]["exchange"]["exchanges"]
    ex["packed"]["pod_by_kind_per_node"]["all-gather"] += 1


BYTE_FIELDS = ("logical_bytes_per_node", "packed_pred_bytes_per_node",
               "packed_copy_bytes", "packed_copy_bytes_int16",
               "packed_sidecar_bytes_per_copy", "full_gather_bytes_per_node")

# (case id, edit, argv beyond the baselines, the word the case must print;
# None: every verdict OK)
CASES = [
    ("ok", None, [], None),
    ("round-1.31x", _slow_round, [], "REGRESSION"),
    ("round-fused-not-cheaper", _phase("8", "round_fused_ms", 1.0,
                                       "round_exact_ms"), [],
     "FUSED-NOT-CHEAPER"),
    ("round-fused-regressed", _phase("2", "round_fused_ms", 1.06,
                                     "round_exact_ms"), [],
     "FUSED-REGRESSED"),
    ("update", _phase("4", "update_fused_ms", 1.0, "update_per_leaf_ms"), [],
     "FUSED-UPDATE-NOT-CHEAPER"),
    ("grad", _phase("2", "grad_plane_ms", 1.01, "grad_repack_ms"), [],
     "PLANE-GRAD-NOT-CHEAPER"),
    ("mix", _phase("8", "mix_plane_ms", 1.0, "mix_tree_ms"), [],
     "PLANE-MIX-NOT-CHEAPER"),
    ("apply", _phase("4", "apply_fused_ms", 2.0, "apply_dense_ms"), [],
     "FUSED-APPLY-NOT-CHEAPER"),
    ("proto-marginal", _phase("8", "proto_fused_ms", 0.51,
                              "proto_exact_ms"), [],
     "FUSED-MARGINAL-TOO-HIGH"),
    ("proto-1.31x", _slow_proto, [], "REGRESSION"),
    ("codec-1.31x", _slow_codec, [], "REGRESSION"),
    ("node-not-in-baseline", None, ["--nodes", "2", "3"], "skipping"),
    ("missing-wire-row", _missing_row, [], "missing from fresh run"),
    *[(f"drift-{k}", _field("16", k), [], "WIRE-FORMAT DRIFT")
      for k in BYTE_FIELDS],
    *[(f"drift-{ex}-{k}", _exchange("16", ex, k), [], "WIRE-FORMAT DRIFT")
      for ex in ("gather", "packed", "ppermute")
      for k in ("collective_bytes_per_node", "by_kind")],
    ("drift-adapter-row", _exchange("4+adapters8", "ppermute",
                                    "collective_bytes_per_node"), [],
     "WIRE-FORMAT DRIFT"),
    ("error-exchange", _error_exchange, [], "UNCHECKED"),
    ("pre-phase", _pre_phase, [], None),
    ("pods", _pods, [], None),
    ("pods-by-axis-drift", _pods_axis_drift, [], "WIRE-FORMAT DRIFT"),
    ("pods-by-kind-drift", _pods_kind_drift, [], "WIRE-FORMAT DRIFT"),
    ("pre-pods", _pre_pods, [], None),
    ("skip-wire", None, ["--skip-wire"], None),
]


def _run_both(tmp_path, monkeypatch, capsys, base, wire, fresh, extra=(),
              wire_rc=0):
    """Both gates on the same baselines and fresh numbers: ``(jax rc, jax
    lines, port rc, port lines, the port's wire argv)``."""
    bp, wp = tmp_path / "rs.json", tmp_path / "wire.json"
    bp.write_text(json.dumps(base))
    wp.write_text(json.dumps(wire))
    calls = []

    def fake_run(argv, **kw):
        calls.append(list(argv))
        out = argv[argv.index("--out") + 1]
        Path(out).write_text(json.dumps(fresh["wire"]))
        return subprocess.CompletedProcess(argv, wire_rc, "the bench's out",
                                           "the bench's err")

    def measure(n, **kw):
        assert kw["jitted_only"]
        return {"jitted_ms": fresh["round"][str(n)]}

    def measure_phases(n, **kw):
        return {"proto_exact_ms": fresh["proto"]}

    monkeypatch.setattr(subprocess, "run", fake_run)
    for mod in (JC, G.RS):
        monkeypatch.setattr(mod, "measure", measure)
        monkeypatch.setattr(mod, "measure_phases", measure_phases)
    argv = ["--baseline", str(bp), "--wire-baseline", str(wp), *extra]
    monkeypatch.setattr(sys, "argv", ["check_regression.py", *argv])
    capsys.readouterr()
    rc_jax = JC.main()
    out_jax = capsys.readouterr().out
    jax_calls = len(calls)
    rc = G.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    cards = [ln for ln in out.splitlines() if ln.startswith("card: ")]
    assert len(cards) == 1 + ("--skip-wire" not in extra)
    assert all("from None (cpu); this run None (cpu)" in ln for ln in cards)
    return (rc_jax, out_jax.splitlines(), rc,
            [ln for ln in out.splitlines() if ln not in cards],
            calls[jax_calls:])


@pytest.mark.parametrize("case,edit,extra,word", CASES,
                         ids=[c[0] for c in CASES])
def test_verdicts_equal_the_jax_gates(case, edit, extra, word, tmp_path,
                                      monkeypatch, capsys):
    base, wire, fresh = _synthetic()
    if edit is not None:
        edit(base, wire, fresh)
    rc_jax, jax_lines, rc, lines, _ = _run_both(
        tmp_path, monkeypatch, capsys, base, wire, fresh, extra)
    assert lines == jax_lines
    assert rc == rc_jax
    if word is None:
        assert rc == 0 and lines[-1].startswith("all measurements within")
    else:
        assert any(word in ln for ln in lines), lines
        assert rc == (0 if word in ("skipping", "UNCHECKED") else 1)


def test_a_failed_wire_bench_fails_both(tmp_path, monkeypatch, capsys):
    base, wire, fresh = _synthetic()
    rc_jax, jax_lines, rc, lines, _ = _run_both(
        tmp_path, monkeypatch, capsys, base, wire, fresh, wire_rc=1)
    assert (rc, lines) == (rc_jax, jax_lines) and rc == 1
    assert "wire bench failed to run:" in lines


@pytest.mark.parametrize("shape", ["default", "pods", "pre-pods"])
def test_wire_bench_runs_at_the_baselines_settings(shape, tmp_path,
                                                   monkeypatch, capsys):
    base, wire, fresh = _synthetic()
    {"default": lambda *a: None, "pods": _pods, "pre-pods": _pre_pods}[
        shape](base, wire, fresh)
    *_, calls = _run_both(tmp_path, monkeypatch, capsys, base, wire, fresh)
    (argv,) = calls
    assert Path(argv[1]) == ROOT / "benchmarks" / "torch_round_step.py"
    args = RS.parser().parse_args(argv[2:])
    cfg = wire["config"]
    assert args.wire and args.device == "cpu"
    assert (args.wire_nodes, args.wire_topology, args.wire_bits,
            args.wire_adapters, args.wire_adapter_bits, args.rounds) == (
        cfg["nodes"], cfg["topology"], cfg["bits"], cfg["adapter_ranks"],
        cfg["adapter_bits"], cfg["timed_rounds"])
    assert args.pods == cfg.get("pods", [str(cfg["nodes"])])


def test_main_end_to_end_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "rs.json"
    report = RS.main(["--device", "cpu", "--nodes", "2", "--rounds", "1",
                      "--phases", "--out", str(out)])
    assert (report["backend"], report["card"]) == ("cpu", None)
    capsys.readouterr()
    rc = G.main(["--device", "cpu", "--nodes", "2", "--skip-wire",
                 "--rounds", "1", "--baseline", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"card: {out} from None (cpu); this run None (cpu)"
    assert lines[1].startswith("N=2: jitted ")
    invariants = [ln for ln in lines if ": committed " in ln]
    assert len(invariants) == 6 and all(ln.startswith("N=2:")
                                        for ln in invariants)
    assert lines[-3].startswith("N=2: proto phase ")
    verdicts = lines[1:-2]
    assert len(verdicts) == 8
    failed = [ln for ln in verdicts if not ln.endswith("  OK")]
    assert rc == (1 if failed else 0)
    assert lines[-1] == ("all measurements within 1.3x of the committed "
                         "baselines" if rc == 0 else
                         f"FAIL: regression vs the committed baselines "
                         f"({out}, BENCH_torch_wire_exchange.json)")


def _jax_parser(monkeypatch):
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            JC.main()
    return seen["parser"]


def _defaults(ap):
    return {a.option_strings[0]: (a.default, a.type, a.nargs)
            for a in ap._actions if a.option_strings[0] != "-h"}


def test_every_jax_flag_with_its_default(monkeypatch):
    want = _defaults(_jax_parser(monkeypatch))
    got = _defaults(G.parser())
    assert set(want) == {"--baseline", "--wire-baseline", "--threshold",
                         "--nodes", "--rounds", "--skip-wire"}
    assert set(got) == set(want) | {"--device"}
    for flag in ("--baseline", "--wire-baseline"):
        assert got[flag][0] == want[flag][0].replace("BENCH_", "BENCH_torch_")
    for flag in set(want) - {"--baseline", "--wire-baseline"}:
        assert got[flag] == want[flag], flag
    assert got["--device"][0] is None


@pytest.mark.parametrize("flag,name", [
    ("--baseline", "BENCH_round_step.json"),
    ("--baseline", "BENCH_wire_exchange.json"),
    ("--wire-baseline", "BENCH_wire_exchange.json"),
])
def test_jax_baselines_are_refused_by_name(flag, name, capsys):
    with pytest.raises(SystemExit):
        G.main([flag, str(ROOT / name), "--device", "cpu"])
    assert "JAX package's report" in capsys.readouterr().err


@pytest.mark.parametrize("flag,report", [
    ("--baseline", JAX_RS), ("--wire-baseline", JAX_WIRE),
    ("--baseline", dict(PORT_RS, backend="tpu"))])
def test_jax_baselines_are_refused_by_backend(flag, report, tmp_path,
                                              capsys):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(report))
    argv = [flag, str(path), "--device", "cpu"]
    if flag == "--wire-baseline":
        argv += ["--baseline", str(ROOT / "BENCH_torch_round_step.json")]
    with pytest.raises(SystemExit):
        G.main(argv)
    assert "not the port's report" in capsys.readouterr().err


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.main(["--baseline", str(ROOT / "BENCH_torch_round_step.json"),
                "--skip-wire"])


# -- the committed baselines ---------------------------------------------------

def test_committed_baselines_name_an_nvidia_card():
    for report in (PORT_RS, PORT_WIRE):
        assert G.is_port_report(report)
        assert report["backend"] == "cuda"
        assert report["card"].startswith("NVIDIA ")
        assert report["card"].endswith(" W")
    assert sorted(PORT_RS["nodes"], key=int) == ["2", "4", "8"]
    assert all("phases" in row for row in PORT_RS["nodes"].values())
    assert PORT_WIRE["config"] == JAX_WIRE["config"]


@pytest.mark.parametrize("row", list(JAX_WIRE["per_bits"]))
def test_committed_wire_bytes_equal_the_jax_packages(row):
    for pods, rows in JAX_WIRE["per_pods"].items():
        jax_rep = rows[row]["exchange"]
        rep = PORT_WIRE["per_pods"][pods][row]["exchange"]
        keys = [k for k in jax_rep if "bytes" in k and k != "exchanges"]
        assert keys
        assert {k: rep[k] for k in keys} == {k: jax_rep[k] for k in keys}
        assert set(rep["exchanges"]) == set(jax_rep["exchanges"])
        # the port's gather moves its own tensors (a deliberate divergence)
        for ex in ("packed", "ppermute"):
            for k in ("collective_bytes_per_node", "by_kind"):
                assert rep["exchanges"][ex][k] == jax_rep["exchanges"][ex][k]
    assert PORT_WIRE["per_bits"][row] == PORT_WIRE["per_pods"]["8"][row]


def test_chip_smoke_gate_holds_the_committed_baselines(capsys):
    smoke = _chip_smoke()
    committed = {"nodes": PORT_RS, "wire": PORT_WIRE}
    failing = tuple((v.row, v.word) for v in G.check_invariants(PORT_RS)
                    if v.failed)
    assert failing == smoke.GATE_KNOWN_FAILING
    summary = smoke.hold_regression_gate(committed, copy.deepcopy(committed),
                                         "NVIDIA H100 80GB HBM3, 700.00 W")
    assert set(summary["round"].values()) == {1.0}
    assert set(summary["codec"].values()) == {1.0}
    assert summary["over_threshold"] == []
    line = capsys.readouterr().out.splitlines()[-1]
    assert json.loads(line[len("regression_gate "):]) == json.loads(
        json.dumps(summary))


def _drift(fresh):
    fresh["wire"]["per_pods"]["8"]["4/16"]["exchange"][
        "packed_copy_bytes"] += 1


def _drop_row(fresh):
    del fresh["wire"]["per_pods"]["8"]["4+adapters8"]


def _slow(fresh):
    for row in fresh["nodes"]["nodes"].values():
        row["jitted_ms"] *= 2
        row["phases"]["grad_plane_ms"] *= 3


@pytest.mark.parametrize("edit,error", [
    (_drift, "wire bytes"), (_drop_row, "codec verdicts"), (_slow, None)])
def test_chip_smoke_gate_refuses_drift_not_time(edit, error):
    smoke = _chip_smoke()
    committed = {"nodes": PORT_RS, "wire": PORT_WIRE}
    fresh = copy.deepcopy(committed)
    edit(fresh)
    if error is None:
        summary = smoke.hold_regression_gate(committed, fresh, "card")
        assert set(summary["round"].values()) == {2.0}
        assert len(summary["over_threshold"]) == 3
        assert len(summary["fresh_invariants_failing"]) == 3
        return
    with pytest.raises(RuntimeError, match=error):
        smoke.hold_regression_gate(committed, fresh, "card")
