"""Table III on the PyTorch port: elapsed wall time per algorithm
(% vs FedAvg).

The paper used 2x RTX 3080; the claim under test is the ORDERING and the
ProFe overhead band (~+18-20 % on CIFAR-scale, ~0 % on MNIST-scale) vs
the FedProto floor (~-65 %).  Round times are host-clock seconds after
``torch.cuda.synchronize()`` (``run_federation``'s ``round_times_s``);
``pct_vs_fedavg`` compares ``elapsed_s``.

``--full`` runs the paper's N=20 protocol on the stacked round engine.
``--topologies`` sweeps gossip graphs (any ``core/topology.make_schedule``
spec).  ``--overlap`` records the pipelined-round modes next to the
sequential reference, and ``--stale-floor F`` adds just the
``overlap="rounds"`` + self-weight-floor row, scored against the
sequential row already in the report.  Every run merges into its
``--out`` (by default ``reports/torch_table3_time.json``) per (dataset,
topology); it reads and writes no other report.

    PYTHONPATH=src python -m benchmarks.torch_table3_time [--full] \\
        [--topologies full ring star] [--overlap] [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises with no
card).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
from pathlib import Path

from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.core.federation import run_federation, run_federation_loop
from repro_torch.core.profe import resolve_device
from repro_torch.data import image_federation

ROOT = Path(__file__).resolve().parents[1]
JAX_REPORT = ROOT / "reports" / "table3_time.json"

ALGOS = ["fedavg", "fedgpd", "fml", "fedproto", "profe"]


def _setting(dataset: str, nodes: int, n_samples: int, seed: int):
    cfg = get_config(dataset)
    node_data, test_d = image_federation(cfg, n_samples, nodes, "iid", seed)
    train = TrainConfig(batch_size=64, learning_rate=1e-3, optimizer="adamw",
                        remat=False)
    return cfg, node_data, test_d, train


def _median(times):
    return round(statistics.median(times), 4) if times else None


def _curve_row(res) -> dict:
    times = res.extras.get("round_times_s", [])
    return {
        "elapsed_s": res.elapsed_s,
        "median_round_s": _median(times),
        "round_times_s": [round(t, 4) for t in times],
        "f1_per_round": [round(f, 4) for f in res.f1_per_round],
    }


def _against(row: dict, seq: dict) -> None:
    if seq.get("median_round_s") and row["median_round_s"]:
        row["round_speedup_vs_sequential"] = round(
            seq["median_round_s"] / row["median_round_s"], 4)
    row["f1_final_abs_diff"] = round(
        abs(row["f1_per_round"][-1] - seq["f1_per_round"][-1]), 4)


def measure(dataset: str, *, nodes: int, rounds: int, n_samples: int,
            seed: int = 0, engine: str = "stacked", topology: str = "full",
            device=None):
    dev = resolve_device(device)
    cfg, node_data, test_d, train = _setting(dataset, nodes, n_samples, seed)
    run = run_federation if engine == "stacked" else run_federation_loop
    rows = {}
    for algo in ALGOS:
        fed = FederationConfig(num_nodes=nodes, rounds=rounds, local_epochs=1,
                               algorithm=algo, seed=seed, topology=topology)
        res = run(cfg, fed, train, node_data, test_d, device=dev)
        times = res.extras.get("round_times_s", [])
        rows[algo] = {
            "elapsed_s": res.elapsed_s,
            "round_times_s": [round(t, 4) for t in times],
            "median_round_s": _median(times),
        }
    base = rows["fedavg"]["elapsed_s"]
    for algo in ALGOS:
        rows[algo]["pct_vs_fedavg"] = 100.0 * (rows[algo]["elapsed_s"] / base - 1)
    return rows


def measure_overlap(dataset: str, *, nodes: int, rounds: int, n_samples: int,
                    seed: int = 0, topology: str = "full", device=None):
    """Sequential vs pipelined ProFe round drivers on the same protocol:
    ``overlap=None`` (each round staged, then trained, shared and mixed),
    ``"none"`` (the same phases with the next round's batches staged on
    the host while the card runs; bit-identical outputs) and ``"rounds"``
    (stale-by-one gossip).  Records each mode's per-round times and F1
    and, against the sequential row, ``round_speedup_vs_sequential`` and
    ``f1_final_abs_diff``."""
    dev = resolve_device(device)
    cfg, node_data, test_d, train = _setting(dataset, nodes, n_samples, seed)
    out = {}
    for mode in (None, "none", "rounds"):
        fed = FederationConfig(num_nodes=nodes, rounds=rounds,
                               local_epochs=1, algorithm="profe", seed=seed,
                               topology=topology)
        res = run_federation(cfg, fed, train, node_data, test_d,
                             overlap=mode, device=dev)
        out["sequential" if mode is None else mode] = _curve_row(res)
    for mode in ("none", "rounds"):
        _against(out[mode], out["sequential"])
    return out


def measure_floor(dataset: str, *, nodes: int, rounds: int, n_samples: int,
                  floor: float, seq_ref: dict | None, seed: int = 0,
                  topology: str = "full", device=None):
    """Only ``overlap="rounds"`` with ``stale_self_floor=floor``, scored
    against ``seq_ref`` (the report's sequential row, where it has one)."""
    dev = resolve_device(device)
    cfg, node_data, test_d, train = _setting(dataset, nodes, n_samples, seed)
    fed = FederationConfig(num_nodes=nodes, rounds=rounds, local_epochs=1,
                           algorithm="profe", seed=seed, topology=topology)
    res = run_federation(cfg, fed, train, node_data, test_d,
                         overlap="rounds", stale_self_floor=floor,
                         device=dev)
    row = dict(_curve_row(res), stale_self_floor=floor)
    if seq_ref is not None:
        _against(row, seq_ref)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's N=20 protocol on the stacked engine")
    ap.add_argument("--datasets", nargs="+", default=["mnist-cnn"])
    ap.add_argument("--topologies", nargs="+", default=["full"],
                    help="gossip graphs to sweep (any "
                         "core/topology.make_schedule spec)")
    ap.add_argument("--engine", choices=["stacked", "loop"],
                    default="stacked",
                    help="round engine: stacked rounds (default) or the "
                         "per-node reference loop")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined-round comparison instead of the "
                         "algorithm table: sequential vs overlap='none' "
                         "(bit-identical phase split) vs 'rounds' "
                         "(stale-by-one gossip), per-round times + F1 "
                         "(merged into the same JSON under 'overlap')")
    ap.add_argument("--stale-floor", type=float, default=None,
                    metavar="F",
                    help="run ONLY overlap='rounds' with "
                         "stale_self_floor=F and merge it as the "
                         "'rounds+floor' row under 'overlap', scored "
                         "against the report's sequential row")
    ap.add_argument("--out", default="reports/torch_table3_time.json")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    if Path(args.out).resolve() == JAX_REPORT:
        ap.error(f"--out {args.out} is the JAX package's report")

    results = {}
    if os.path.exists(args.out):
        # --overlap and the algorithm table share the report file:
        # merge per (dataset, topology) instead of clobbering
        with open(args.out) as f:
            results = json.load(f)
    for ds in args.datasets:
        nodes, rounds, n = (20, 10, 20000) if args.full else (3, 2, 900)
        results.setdefault(ds, {})
        for topo in args.topologies:
            print(f"== {ds} ({nodes} nodes, topology={topo}) ==", flush=True)
            results[ds].setdefault(topo, {})
            if args.stale_floor is not None:
                seq_ref = results[ds][topo].get("overlap", {}) \
                    .get("sequential")
                row = measure_floor(ds, nodes=nodes, rounds=rounds,
                                    n_samples=n, topology=topo,
                                    floor=args.stale_floor, seq_ref=seq_ref,
                                    device=args.device)
                results[ds][topo].setdefault("overlap", {})
                results[ds][topo]["overlap"]["rounds+floor"] = row
                extra = ""
                if "f1_final_abs_diff" in row:
                    extra = (f"  |dF1| {row['f1_final_abs_diff']} vs "
                             f"the report's sequential row")
                print(f"  rounds+floor({args.stale_floor}) median "
                      f"{row['median_round_s']}s/round  final f1 "
                      f"{row['f1_per_round'][-1]}{extra}")
                continue
            if args.overlap:
                rows = measure_overlap(ds, nodes=nodes, rounds=rounds,
                                       n_samples=n, topology=topo,
                                       device=args.device)
                results[ds][topo]["overlap"] = rows
                for mode, r in rows.items():
                    extra = ""
                    if "round_speedup_vs_sequential" in r:
                        extra = (f"  {r['round_speedup_vs_sequential']:.2f}x"
                                 f" round vs sequential, |dF1| "
                                 f"{r['f1_final_abs_diff']}")
                    print(f"  {mode:10s} median "
                          f"{r['median_round_s']}s/round{extra}")
                continue
            rows = measure(ds, nodes=nodes, rounds=rounds, n_samples=n,
                           engine=args.engine, topology=topo,
                           device=args.device)
            results[ds][topo].update(rows)
            for algo, r in rows.items():
                print(f"  {algo:9s} {r['elapsed_s']:8.1f}s "
                      f"({r['pct_vs_fedavg']:+.0f}% vs FedAvg, "
                      f"median {r['median_round_s']}s/round)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
