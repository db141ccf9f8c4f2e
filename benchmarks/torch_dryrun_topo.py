"""The federation-topology byte-gate suite on the PyTorch port: the four
``TOPO_SUITE`` rows of ``dryrun_all.py --topo`` (exchange modes against
the accountant, with the yi-6b ring-8 adapter-rank rows), each through
``python -m repro_torch.launch.dryrun`` in its own subprocess, each
report held to the JAX package's committed one.

    PYTHONPATH=src python -m benchmarks.torch_dryrun_topo \\
        [--out-dir build/dryrun] [--force] [--device cpu]

A row passes when its audit exits 0 within ``TIMEOUT_S`` (every gate of
``launch/dryrun.py`` held) and its report equals
``reports/dryrun/topology_<tag>.json`` exactly on the shape-derived keys
(``SHAPE_KEYS``), on ``exchanges.ppermute.collective_bytes_per_node``
and, where the JAX report has them, on the ``ppermute`` bytes of
``dense_reference`` and ``int16_reference``.  The ``gather`` and
``packed`` exchanges are printed beside JAX's but not compared: they
are the port's own tensors (ROADMAP.md, Queue 3).  Prints ``[OK]`` or
``[FAIL]`` a row and exits 1 on any failure.  Reports go to
``--out-dir``, with ``summary.json`` (each row's verdict, compared keys
and kernel launches); a row whose report there passed on the same
device and the same sources (``source_digest``: ``src/repro_torch`` and
this script) is reused unless ``--force``.

The arch × shape compile sweep of ``dryrun_all.py`` is
``benchmarks/torch_dryrun_all.py`` (whose ``--topo`` runs this suite).
Runs on the card unless ``--device cpu`` is given (and raises with no
card).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_REPORTS = ROOT / "reports" / "dryrun"
OUT_DIR = "build/dryrun"
TIMEOUT_S = 600

# (arch, topology, pods, extra dryrun args, report tag): dryrun_all.py's
TOPO_SUITE = [
    ("mnist-cnn", "ring", "8", [], "mnist-cnn_ring8"),
    ("mnist-cnn", "ring", "8", ["--bits", "4", "--ef"],
     "mnist-cnn_ring8_int4ef"),
    ("yi-6b", "ring", "8", ["--bits", "4", "--adapters", "8"],
     "yi-6b_ring8_int4_adapters8"),
    ("yi-6b", "ring", "8",
     ["--bits", "4", "--adapters", "8", "--adapter-grams"],
     "yi-6b_ring8_int4_adapters8_grams"),
]
SHAPE_KEYS = ("degree", "logical_bytes_per_node",
              "packed_pred_bytes_per_node", "packed_copy_bytes",
              "packed_copy_bytes_int16", "packed_sidecar_bytes_per_copy")
REFERENCES = ("dense_reference", "int16_reference")
PRINTED = ("gather", "packed", "ppermute")


def _ppermute(report: dict):
    return report.get("exchanges", {}).get("ppermute", {}).get(
        "collective_bytes_per_node")


def compared(report: dict, want: dict) -> list:
    """``(key, port's, JAX's)`` for every compared key of a row: the
    shape-derived keys, the ``ppermute`` bytes, and those of each
    reference the JAX report has."""
    rows = [(k, report.get(k), want[k]) for k in SHAPE_KEYS]
    rows.append(("exchanges.ppermute", _ppermute(report), _ppermute(want)))
    for ref in REFERENCES:
        if ref in want:
            rows.append((f"{ref}.exchanges.ppermute",
                         _ppermute(report.get(ref, {})), _ppermute(want[ref])))
    return rows


def source_digest(script=None) -> str:
    """sha256 of the port's sources and ``script`` (this one by default):
    a report measured with other code is not reused."""
    h = hashlib.sha256()
    files = sorted(p for p in (ROOT / "src" / "repro_torch").rglob("*")
                   if p.suffix in (".py", ".cu", ".h", ".cuh"))
    for p in files + [Path(script or __file__).resolve()]:
        h.update(str(p.relative_to(ROOT)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def launches(report: dict) -> dict:
    """The kernel launches of a report's exchanges and its references'."""
    out: dict = {}
    for part in [report] + [v for v in report.values()
                            if isinstance(v, dict) and "exchanges" in v]:
        for ex in part["exchanges"].values():
            for k, v in ex.get("launches", {}).items():
                out[k] = out.get(k, 0) + v
    return out


def run_row(arch: str, topology: str, pods: str, extra, tag: str,
            out_dir: Path, device: str, digest: str,
            force: bool = False) -> dict:
    """One row: its audit in a subprocess (or its passed report in
    ``out_dir`` from the same device and sources), held to the JAX
    report.  Returns ``{"tag", "ok", "seconds", "report", "mismatches",
    "error"}``."""
    path = out_dir / f"topology_{tag}.json"
    want = json.loads((JAX_REPORTS / f"topology_{tag}.json").read_text())
    t0 = time.time()
    report, error = None, None
    if not force and path.exists():
        report = json.loads(path.read_text())
        if report.get("status") != "ok" or report.get("device") != device \
                or report.get("source_digest") != digest:
            report = None
    if report is None:
        path.unlink(missing_ok=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]))
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--topology", topology, "--pods", pods,
               *extra, "--json", str(path), "--device", device]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  env=env, cwd=ROOT, timeout=TIMEOUT_S)
            if path.exists():
                report = json.loads(path.read_text())
            if proc.returncode != 0:
                error = (report or {}).get("error") or \
                    f"exit {proc.returncode}: {proc.stderr[-2000:]}"
            elif report is not None:
                report["source_digest"] = digest
                path.write_text(json.dumps(report, indent=2))
        except subprocess.TimeoutExpired:
            error = f"timed out after {TIMEOUT_S} s"
    mismatches = [] if report is None else \
        [(k, got, exp) for k, got, exp in compared(report, want)
         if got != exp]
    ok = error is None and report is not None and \
        report.get("status") == "ok" and not mismatches
    return {"tag": tag, "ok": ok, "seconds": time.time() - t0,
            "report": report, "want": want, "mismatches": mismatches,
            "error": error}


def run(out_dir: str = OUT_DIR, force: bool = False, device=None,
        verbose: bool = False) -> dict:
    """The suite's four rows.  Returns ``{"ok", "device", "rows":
    [run_row's results]}``; writes ``summary.json`` to ``out_dir``."""
    from repro_torch.core.profe import resolve_device
    dev = str(resolve_device(device))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    digest = source_digest()
    rows = []
    for arch, topology, pods, extra, tag in TOPO_SUITE:
        row = run_row(arch, topology, pods, extra, tag, out, dev, digest,
                      force=force)
        rows.append(row)
        if verbose:
            _print_row(row)
    res = {"ok": all(r["ok"] for r in rows), "device": dev, "rows": rows}
    (out / "summary.json").write_text(json.dumps({
        "ok": res["ok"], "device": dev, "source_digest": digest,
        "rows": [{"tag": r["tag"], "ok": r["ok"], "seconds": r["seconds"],
                  "error": r["error"],
                  "compared": compared(r["report"] or {}, r["want"]),
                  "launches": launches(r["report"] or {"exchanges": {}})}
                 for r in rows]}, indent=2))
    return res


def _print_row(row: dict) -> None:
    rep = row["report"] or {}
    checks = len(rep.get("checks", []))
    n = len(compared(rep, row["want"]))
    print(f"[{'OK' if row['ok'] else 'FAIL'}] topology {row['tag']:36s} "
          f"{checks} checks, {n - len(row['mismatches'])}/{n} keys equal "
          f"to the JAX report ({row['seconds']:.0f}s)", flush=True)
    for ex in PRINTED:
        got = rep.get("exchanges", {}).get(ex, {})
        got = got.get("collective_bytes_per_node", got.get("error"))
        want = row["want"]["exchanges"].get(ex, {})
        print(f"    {ex:9s} port {got}  JAX "
              f"{want.get('collective_bytes_per_node')}")
    for key, got, want in row["mismatches"]:
        print(f"    MISMATCH {key}: port {got} != JAX {want}")
    if row["error"]:
        print(f"    error: {row['error'][:400]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topo", action="store_true",
                    help="the topology byte-gate suite (the only mode "
                         "ported; accepted for dryrun_all.py's CLI)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--force", action="store_true",
                    help="rerun rows whose report in --out-dir passed")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    res = run(args.out_dir, args.force, device=args.device, verbose=True)
    failures = [r["tag"] for r in res["rows"] if not r["ok"]]
    print(f"\n{len(failures)} failures")
    for tag in failures:
        print("  FAIL:", tag)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
