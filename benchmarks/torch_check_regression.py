"""The regression gate of the PyTorch port: the round-step and
wire-exchange measurements of ``benchmarks/torch_round_step.py`` held
against the port's committed baselines, ``BENCH_torch_round_step.json``
and ``BENCH_torch_wire_exchange.json``.  The port of
``benchmarks/check_regression.py``, with its three gates, flags, defaults
and verdict lines, plus ``--device``.

* **Round gate.**  For each node count of the baseline (or ``--nodes``)
  the stacked round is re-measured (``measure(jitted_only=True)``; the
  report's ``jitted_ms`` names the stacked round's ms) and fails above
  ``--threshold`` (1.3×) the committed ``jitted_ms``.
* **Phase gate.**  Where the baseline has ``phases`` rows (``--phases``),
  its committed numbers must keep the invariants the JAX gate keeps:
  ``round_fused_ms < round_exact_ms`` at the largest N (at most 1.05× on
  the smaller rows); ``update_fused_ms < update_per_leaf_ms``,
  ``grad_plane_ms < grad_repack_ms``, ``mix_plane_ms < mix_tree_ms`` and
  ``apply_fused_ms < apply_dense_ms`` at every N (a row without the
  sub-phase is skipped); ``proto_fused_ms <= 0.5 · proto_exact_ms`` at
  the largest N.  Then a fresh ``measure_phases`` at the largest N holds
  ``proto_exact_ms`` within the threshold.
* **Wire gate.**  ``torch_round_step.py --wire`` runs in a subprocess at
  the baseline's own nodes, topology, specs, adapter rows, pods and timed
  rounds; the packed codec's ``packed_ms`` stays within the threshold,
  and every ``*bytes*`` field of a row's report, every exchange's
  ``collective_bytes_per_node`` and its ``by_kind`` / ``by_axis`` /
  ``pod_by_kind_per_node`` equal the baseline's exactly (``WIRE-FORMAT
  DRIFT`` otherwise).  An exchange whose baseline recorded an ``error``
  is ``UNCHECKED``.

Each gate is a pure function over ``(baseline, fresh, threshold)``
returning :class:`Verdict` records; only :func:`main` measures.

    PYTHONPATH=src python benchmarks/torch_check_regression.py

exits 1 on any failed verdict.  It runs on the card unless ``--device
cpu`` is given, and raises with no card.  The times are the card's, and
a card's times differ by host, so the baselines' ``card`` (its
``nvidia-smi`` name and power limit) is printed beside the running
card's.  The JAX package's baselines are refused, by name and by their
``backend``.  Refresh the baselines on the card after an intentional
change, and commit both reports as they come:

    PYTHONPATH=src python benchmarks/torch_round_step.py --nodes 2 4 8 \\
        --phases
    PYTHONPATH=src python benchmarks/torch_round_step.py --wire
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import NamedTuple

from repro_torch.core.profe import resolve_device

if __package__:
    from . import torch_round_step as RS
else:                           # run as a script: benchmarks/ is on the path
    import torch_round_step as RS

THRESHOLD = 1.3
SCRIPT = Path(__file__).resolve().with_name("torch_round_step.py")


class Verdict(NamedTuple):
    """One gate line: the row it is of (``N=<n>`` or ``[pods=<p>
    bits=<b>]``), the printed line, its last word (``OK``,
    ``UNCHECKED``, ``SKIPPED`` or the failure's) and, for a fresh time
    held against a committed one, their ratio."""
    row: str
    line: str
    word: str
    ratio: float | None = None

    @property
    def failed(self) -> bool:
        return self.word not in ("OK", "UNCHECKED", "SKIPPED")


def _timed(row: str, text: str, fresh: float, committed: float,
           threshold: float) -> Verdict:
    ratio = fresh / committed
    word = "OK" if ratio <= threshold else "REGRESSION"
    return Verdict(row, f"{text}  ({ratio:.2f}x)  {word}", word, ratio)


def is_port_report(report: dict) -> bool:
    """The port's reports carry ``card`` (None off the card) and name a
    torch device as ``backend``; the JAX package's carry no ``card`` and
    name a JAX platform."""
    return "card" in report and \
        str(report.get("backend")).split(":")[0] in ("cuda", "cpu")


def check_round(baseline: dict, fresh: dict, threshold: float) -> list:
    """The round gate: ``fresh`` maps a node count (a string) to its
    re-measured ``jitted_ms`` (None where the baseline lacks it)."""
    out = []
    for n, ms in fresh.items():
        row = f"N={n}"
        if n not in baseline["nodes"]:
            out.append(Verdict(row, f"N={n}: not in baseline, skipping",
                               "SKIPPED"))
            continue
        committed = baseline["nodes"][n]["jitted_ms"]
        out.append(_timed(row, f"N={n}: jitted {ms:8.1f} ms/round vs "
                               f"committed {committed:8.1f} ms", ms,
                          committed, threshold))
    return out


def _phased(report: dict) -> dict:
    return {n: row["phases"] for n, row in report["nodes"].items()
            if "phases" in row}


def phase_node(report: dict) -> str | None:
    """The largest node count with a ``phases`` row (None: a pre-phase
    report)."""
    phased = _phased(report)
    return max(phased, key=int) if phased else None


# (fused key, reference key, the two sides' labels, failure word) of the
# every-N invariants; a row without the fused key is skipped
PAIRS = (("update_fused_ms", "update_per_leaf_ms", "update fused",
          "per-leaf", "FUSED-UPDATE-NOT-CHEAPER"),
         ("grad_plane_ms", "grad_repack_ms", "grad plane", "repack",
          "PLANE-GRAD-NOT-CHEAPER"),
         ("mix_plane_ms", "mix_tree_ms", "mix plane", "tree",
          "PLANE-MIX-NOT-CHEAPER"),
         ("apply_fused_ms", "apply_dense_ms", "apply fused", "dense",
          "FUSED-APPLY-NOT-CHEAPER"))


def check_invariants(report: dict) -> list:
    """The committed invariants over ``report``'s ``phases`` rows (none
    for a pre-phase report): the single-pass round cheaper than the exact
    one at the largest N and at most 1.05× it below (at small N the saved
    pass is inside the timer's noise), the four fused or plane paths
    cheaper than their references at every N, and the fused Eq. 3
    marginal at most half the exact pass at the largest N."""
    phased = _phased(report)
    if not phased:
        return []
    n_big = phase_node(report)
    rows = sorted(phased.items(), key=lambda kv: int(kv[0]))
    out = []
    for n, ph in rows:
        if n == n_big:
            ok = ph["round_fused_ms"] < ph["round_exact_ms"]
            tag = "FUSED-NOT-CHEAPER"
        else:
            ok = ph["round_fused_ms"] <= 1.05 * ph["round_exact_ms"]
            tag = "FUSED-REGRESSED"
        word = "OK" if ok else tag
        out.append(Verdict(
            f"N={n}", f"N={n}: committed round fused "
                      f"{ph['round_fused_ms']:7.1f} ms vs exact "
                      f"{ph['round_exact_ms']:7.1f} ms  {word}", word))
    for fused, ref, label, ref_label, tag in PAIRS:
        for n, ph in rows:
            if fused not in ph:
                continue
            word = "OK" if ph[fused] < ph[ref] else tag
            out.append(Verdict(
                f"N={n}", f"N={n}: committed {label} {ph[fused]:6.2f} ms vs "
                          f"{ref_label} {ph[ref]:6.2f} ms  {word}", word))
    big = phased[n_big]
    word = "OK" if big["proto_fused_ms"] <= 0.5 * big["proto_exact_ms"] \
        else "FUSED-MARGINAL-TOO-HIGH"
    out.append(Verdict(
        f"N={n_big}", f"N={n_big}: committed proto fused marginal "
                      f"{big['proto_fused_ms']:6.1f} ms vs 0.5 x exact "
                      f"{big['proto_exact_ms']:6.1f} ms  {word}", word))
    return out


def check_proto(baseline: dict, fresh_phases: dict,
                threshold: float) -> Verdict:
    """The fresh exact Eq. 3 pass at the baseline's largest phased N
    against its committed ``proto_exact_ms``."""
    n = phase_node(baseline)
    ms = fresh_phases["proto_exact_ms"]
    committed = _phased(baseline)[n]["proto_exact_ms"]
    return _timed(f"N={n}", f"N={n}: proto phase {ms:7.1f} ms vs committed "
                            f"{committed:7.1f} ms", ms, committed, threshold)


def _pods(report: dict, cfg: dict) -> dict:
    # a pre-pods report has only the flat "per_bits" view
    return report.get("per_pods", {cfg.get("nodes", 8): report["per_bits"]})


def wire_argv(baseline: dict, out: str) -> list:
    """``torch_round_step.py``'s flags that re-run the wire baseline's
    rows at its own settings: nodes, topology, the specs, the adapter rows
    (labeled ``<bits>+adapters<rank>``), the pod shapes and the timed
    rounds."""
    cfg = baseline["config"]
    labels = list(baseline["per_bits"])
    bits = [b for b in labels if "+adapters" not in b]
    adapted = [b.split("+adapters") for b in labels if "+adapters" in b]
    if adapted:
        ranks = [str(r) for r in cfg.get("adapter_ranks", [])] or \
            sorted({r for _, r in adapted})
        ad_bits = [str(b) for b in cfg.get("adapter_bits", [])] or \
            sorted({b for b, _ in adapted})
        adapter = ["--wire-adapters", *ranks, "--wire-adapter-bits", *ad_bits]
    else:
        adapter = ["--wire-adapters", "0"]      # rank 0: no adapter rows
    pods = [str(p) for p in cfg["pods"]] if "pods" in cfg \
        else [str(cfg["nodes"])]
    rounds = ["--rounds", str(cfg["timed_rounds"])] \
        if "timed_rounds" in cfg else []
    return ["--wire", "--wire-nodes", str(cfg["nodes"]),
            "--wire-topology", cfg["topology"], "--wire-bits", *bits,
            *adapter, "--pods", *pods, *rounds, "--out", out]


def check_wire(baseline: dict, fresh: dict, threshold: float) -> list:
    """The wire gate over every pod shape and spec row of the baseline:
    the packed codec's ms within ``threshold``, and the row's bytes
    exactly the baseline's (the codec, the byte encoding and the
    exchanges are deterministic, so any drift is a wire-format change
    that needs a deliberate refresh)."""
    cfg = baseline["config"]
    fresh_pods = _pods(fresh, cfg)
    out = []
    for pods, base_bits in _pods(baseline, cfg).items():
        fresh_bits = fresh_pods.get(str(pods), {})
        for bits, brow in base_bits.items():
            tag = f"[pods={pods} bits={bits}]"
            frow = fresh_bits.get(bits, {})
            f_ms = frow.get("codec", {}).get("packed_ms")
            if f_ms is None:
                out.append(Verdict(tag, f"{tag} missing from fresh run  "
                                        f"REGRESSION", "REGRESSION"))
                continue
            b_ms = brow["codec"]["packed_ms"]
            out.append(_timed(tag, f"{tag} wire codec: packed qdq "
                                   f"{f_ms:7.2f} ms vs committed "
                                   f"{b_ms:7.2f} ms", f_ms, b_ms, threshold))
            bex, fex = brow["exchange"], frow.get("exchange", {})
            for key, bv in bex.items():
                if key == "exchanges" or "bytes" not in key:
                    continue
                fv = fex.get(key)
                word = "OK" if fv == bv else "WIRE-FORMAT DRIFT"
                out.append(Verdict(tag, f"{tag} {key}: {fv} vs committed "
                                        f"{bv}  {word}", word))
            for ex, rep in bex["exchanges"].items():
                if "error" in rep:
                    out.append(Verdict(
                        tag, f"{tag} wire bytes [{ex}]: UNCHECKED (baseline "
                             f"recorded {rep['error']!r} — refresh "
                             f"BENCH_wire_exchange.json)", "UNCHECKED"))
                    continue
                fr = fex.get("exchanges", {}).get(ex, {})
                fb = rep["collective_bytes_per_node"]
                ff = fr.get("collective_bytes_per_node")
                word = "OK" if ff == fb else "WIRE-FORMAT DRIFT"
                out.append(Verdict(tag, f"{tag} wire bytes [{ex}]: {ff} vs "
                                        f"committed {fb}  {word}", word))
                for key in ("by_kind", "by_axis", "pod_by_kind_per_node"):
                    if key in rep and fr.get(key) != rep[key]:
                        out.append(Verdict(
                            tag, f"{tag} wire bytes [{ex}].{key}: "
                                 f"{fr.get(key)} vs committed {rep[key]}  "
                                 f"WIRE-FORMAT DRIFT", "WIRE-FORMAT DRIFT"))
    return out


def _report(verdicts) -> bool:
    """Print each verdict's line; True when any failed."""
    for v in verdicts:
        print(v.line)
    return any(v.failed for v in verdicts)


def measure_wire(baseline: dict, device) -> dict | None:
    """The wire baseline's rows re-run by ``torch_round_step.py`` in a
    subprocess (its ranks are spawned); None, after printing its output,
    when it fails."""
    fd, out = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    dev = ["--device", device] if device else []
    try:
        r = subprocess.run([sys.executable, str(SCRIPT),
                            *wire_argv(baseline, out), *dev],
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(f"wire bench failed to run:\n{r.stdout}\n{r.stderr}")
            return None
        with open(out) as f:
            return json.load(f)
    finally:
        os.unlink(out)


def _load(ap, path: str, what: str) -> dict:
    if Path(path).name in RS.JAX_REPORTS:
        ap.error(f"{what} {path} is the JAX package's report")
    with open(path) as f:
        report = json.load(f)
    if not is_port_report(report):
        ap.error(f"{what} {path} is not the port's report (backend "
                 f"{report.get('backend')!r}, card "
                 f"{report.get('card', 'absent')!r})")
    return report


def parser() -> argparse.ArgumentParser:
    """The JAX gate's flags and defaults (the baselines the port's own),
    plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="BENCH_torch_round_step.json")
    ap.add_argument("--wire-baseline",
                    default="BENCH_torch_wire_exchange.json")
    ap.add_argument("--threshold", type=float, default=THRESHOLD,
                    help="fail when a fresh time > threshold x committed")
    ap.add_argument("--nodes", nargs="+", type=int, default=None,
                    help="subset of baseline node counts to check "
                         "(default: all)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed rounds per node count (median)")
    ap.add_argument("--skip-wire", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    baseline = _load(ap, args.baseline, "--baseline")
    wire = not args.skip_wire and os.path.exists(args.wire_baseline)
    wire_base = _load(ap, args.wire_baseline, "--wire-baseline") \
        if wire else None
    dev = resolve_device(args.device)
    here = f"{RS.card(dev)} ({dev})"
    for path, rep in ((args.baseline, baseline),
                      (args.wire_baseline, wire_base)):
        if rep is not None:
            print(f"card: {path} from {rep['card']} ({rep['backend']}); "
                  f"this run {here}")

    cfg = baseline["config"]
    kw = dict(samples_per_node=cfg["samples_per_node"],
              batch_size=cfg["batch_size"], rounds=args.rounds, device=dev)
    node_counts = [str(n) for n in args.nodes] if args.nodes \
        else sorted(baseline["nodes"], key=int)
    failed = False
    for n in node_counts:
        ms = RS.measure(int(n), jitted_only=True, **kw)["jitted_ms"] \
            if n in baseline["nodes"] else None
        failed |= _report(check_round(baseline, {n: ms}, args.threshold))

    failed |= _report(check_invariants(baseline))
    n_big = phase_node(baseline)
    if n_big is not None:
        fresh = RS.measure_phases(int(n_big), **kw)
        failed |= _report([check_proto(baseline, fresh, args.threshold)])

    if wire:
        fresh = measure_wire(wire_base, args.device)
        failed |= fresh is None or _report(
            check_wire(wire_base, fresh, args.threshold))

    if failed:
        print(f"\nFAIL: regression vs the committed baselines "
              f"({args.baseline}, {args.wire_baseline})")
        return 1
    print(f"\nall measurements within {args.threshold:.1f}x of the "
          f"committed baselines")
    return 0


if __name__ == "__main__":
    sys.exit(main())
