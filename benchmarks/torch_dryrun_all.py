"""The compile-report sweep on the PyTorch port: 10 archs x 4 shapes x
{pod1, pod2}, as ``dryrun_all.py`` sweeps the JAX package's.

    PYTHONPATH=src python -m benchmarks.torch_dryrun_all \\
        [--mesh pod1 pod2] [--arch ...] [--shape ...] [--force] \\
        [--cards-per-node D] [--out-dir reports/torch_dryrun]

Each combo is ``launch/dryrun.lower_combo`` in this process (one node's
program traced on ``meta`` and fitted; the two meshes share that count),
its report in ``<out-dir>/<arch>_<shape>_<mesh>.json``.  With
``--cards-per-node D`` (2, 4 or 8) a node is D cards: each combo is one
rank's program at ``layout="auto"`` on its layout's default node mesh
(``tp``: data 2 × model D/2; ``fsdp``: D × 1), its report ``<arch>_<shape>_<mesh>_<D>cards.json``;
``--jobs N`` runs the combos on N spawned processes (a node's trace is
bound by DTensor's host-side sharding propagation, one core each).  A
report
that is ``ok`` and was made from the same sources (``source_digest``:
``src/repro_torch`` and this script) is reused unless ``--force``.
Prints one line a combo and exits 1 on any failure.  Runs on the CPU;
where a card is present its ``nvidia-smi`` name and power limit ride in
each report.

``--topo`` runs the federation-topology byte-gate suite instead
(``benchmarks/torch_dryrun_topo.py``: the exchanges against the
accountant on spawned gloo ranks, on the card unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ARCHS = [
    "mamba2-130m", "whisper-small", "yi-6b", "recurrentgemma-9b",
    "qwen3-14b", "starcoder2-15b", "llama4-scout-17b-a16e",
    "llama-3.2-vision-90b", "qwen1.5-110b", "grok-1-314b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = ["pod1", "pod2"]
OUT_DIR = "reports/torch_dryrun"


def report_name(arch: str, shape: str, mesh: str, cards: int = 1) -> str:
    return f"{arch}_{shape}_{mesh}" + (f"_{cards}cards" if cards > 1
                                       else "") + ".json"


def run_one(arch: str, shape: str, mesh: str, out_dir: Path, digest: str,
            force: bool = False, smi=None, cards: int = 1) -> dict:
    """One combo's report (reused from ``out_dir`` where it passed on the
    same sources), written there."""
    from repro_torch.launch.dryrun import lower_combo
    path = out_dir / report_name(arch, shape, mesh, cards)
    if not force and path.exists():
        rep = json.loads(path.read_text())
        if rep.get("status") == "ok" and rep.get("source_digest") == digest:
            return rep
    t0 = time.time()
    try:
        rep = lower_combo(arch, shape, mesh, smi=smi, cards_per_node=cards)
        rep["status"] = "ok"
    except Exception as e:          # the report carries the failure
        rep = {"arch": arch, "shape": shape, "mesh": mesh,
               "cards_per_node": cards, "status": "error",
               "error": f"{type(e).__name__}: {e}"}
    rep["wall_s"] = time.time() - t0
    rep["source_digest"] = digest
    path.write_text(json.dumps(rep, indent=2, default=str))
    return rep


def run_meshes(arch: str, shape: str, meshes, *args) -> list:
    """:func:`run_one` of one (arch, shape) on each of ``meshes``, in one
    process: the meshes share its count."""
    return [run_one(arch, shape, mesh, *args) for mesh in meshes]


def line(rep: dict) -> str:
    ok = rep.get("status") == "ok"
    fits = rep.get("memory_analysis", {}).get("fits_80gb_hbm")
    ratio = rep.get("useful_flops_ratio")
    cards = rep.get("cards_per_node", 1)
    node = f" {cards} cards {rep.get('layout', '?')}" if cards > 1 else ""
    return (f"[{'OK' if ok else 'FAIL'}] {rep['arch']:24s} "
            f"{rep['shape']:12s} {rep['mesh']}{node}  "
            f"dom={rep.get('dominant', '?')} "
            f"6ND/counted={'-' if ratio is None else f'{ratio:.3f}'} "
            f"fits={fits} ({rep.get('wall_s', 0):.1f}s)")


def _worker_init() -> None:
    import torch
    torch.set_num_threads(1)


def run(archs=ARCHS, shapes=SHAPES, meshes=MESHES, out_dir: str = OUT_DIR,
        force: bool = False, verbose: bool = True, cards: int = 1,
        jobs: int = 1, skip=()) -> dict:
    """Every combo but the ``(arch, shape)`` pairs in ``skip`` (on
    ``jobs`` spawned processes, an (arch, shape) with all its meshes a
    task, the costliest first: training steps, then the archs by size);
    returns ``{"ok", "reports"}``, the reports in the order of the
    arguments."""
    from benchmarks.torch_dryrun_topo import source_digest
    from repro_torch.launch.roofline import card
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    digest = source_digest(Path(__file__))
    smi = card()
    combos = [(arch, shape, mesh) for mesh in meshes for arch in archs
              for shape in shapes if (arch, shape) not in skip]
    if jobs <= 1:
        reports = []
        for c in combos:
            reports.append(run_one(*c, out, digest, force, smi, cards))
            if verbose:
                print(line(reports[-1]), flush=True)
    else:
        import concurrent.futures as cf
        import multiprocessing as mp
        groups = sorted({c[:2] for c in combos}, key=lambda g: (
            g[1] != "train_4k", -ARCHS.index(g[0]) if g[0] in ARCHS else 0))
        done = {}
        with cf.ProcessPoolExecutor(jobs, mp.get_context("spawn"),
                                    initializer=_worker_init) as pool:
            futures = [pool.submit(run_meshes, arch, shape,
                                   [m for m in meshes
                                    if (arch, shape, m) in combos],
                                   out, digest, force, smi, cards)
                       for arch, shape in groups]
            for f in cf.as_completed(futures):
                for rep in f.result():
                    done[rep["arch"], rep["shape"], rep["mesh"]] = rep
                    if verbose:
                        print(line(rep), flush=True)
        reports = [done[c] for c in combos]
    return {"ok": all(r.get("status") == "ok" for r in reports),
            "reports": reports}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", nargs="+", default=MESHES)
    ap.add_argument("--arch", nargs="+", default=ARCHS)
    ap.add_argument("--shape", nargs="+", default=SHAPES)
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cards-per-node", type=int, default=1,
                    help="cards of a node: 1, or 2, 4, 8 (one rank's "
                         "program at layout auto)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the combos on this many processes")
    ap.add_argument("--topo", action="store_true",
                    help="run the federation-topology byte-gate suite "
                         "(benchmarks/torch_dryrun_topo.py) instead")
    ap.add_argument("--device", default=None,
                    help="--topo: 'cpu' to run off the card")
    args = ap.parse_args(argv)
    if args.topo:
        from benchmarks import torch_dryrun_topo
        return torch_dryrun_topo.main(
            (["--force"] if args.force else [])
            + (["--device", args.device] if args.device else []))
    res = run(args.arch, args.shape, args.mesh, args.out_dir, args.force,
              cards=args.cards_per_node, jobs=args.jobs)
    failures = [r for r in res["reports"] if r.get("status") != "ok"]
    print(f"\n{len(failures)} failures")
    for r in failures:
        print("  FAIL:", r["arch"], r["shape"], r["mesh"],
              r.get("error", "")[:200])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
