"""The paper's experiments on the PyTorch port, one script each:

    PYTHONPATH=src python -m benchmarks.torch_run [--full] \\
        [--only fig2 table2 table3] [--device cpu]

* fig2   — F1 vs rounds, ProFe vs FedAvg/FedProto/FML/FedGPD   (Fig. 2)
* table2 — bytes sent/received per node, % vs FedAvg           (Table II)
* table3 — wall time, % vs FedAvg                              (Table III)
* roofline — renders the compile-report roofline table if the sweep's
  reports exist (``benchmarks/torch_dryrun_all.py`` first)

Each script's ``main(argv)`` runs at its own defaults (the scaled-down
protocol), or with ``--full`` at the paper's 20-node one, and writes its
``reports/torch_*.json``.  Runs on the card unless ``--device cpu`` is
given (and raises with no card); ``roofline`` reads reports only.
"""
from __future__ import annotations

import argparse
import os
import time

SCRIPTS = {"fig2": ("torch_fig2_f1", "reports/torch_fig2_f1.json"),
           "table2": ("torch_table2_comm", "reports/torch_table2_comm.json"),
           "table3": ("torch_table3_time", "reports/torch_table3_time.json")}
ROOFLINE_REPORTS = "reports/torch_dryrun"


def main(argv=None) -> dict:
    """Run the scripts named by ``--only``; returns each one's report (as
    its ``main`` returns it) by name, and the roofline tables under
    ``"roofline"`` where they were rendered."""
    import importlib
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", nargs="+",
                    default=list(SCRIPTS) + ["roofline"])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    unknown = [s for s in args.only if s not in SCRIPTS
               and s != "roofline"]
    if unknown:
        ap.error(f"unknown --only {unknown}; choose from {list(SCRIPTS)}")

    script_argv = (["--full"] if args.full else []) + \
        (["--device", args.device] if args.device else [])
    t0 = time.time()
    reports = {}
    print("name,seconds,artifact")
    for key, (module, artifact) in SCRIPTS.items():
        if key not in args.only:
            continue
        mod = importlib.import_module(f"benchmarks.{module}")
        t = time.time()
        reports[key] = mod.main(list(script_argv))
        print(f"{module[len('torch_'):]},{time.time() - t:.1f},{artifact}")
    if "roofline" in args.only:
        from benchmarks import torch_roofline_table
        if os.path.isdir(ROOFLINE_REPORTS) and os.listdir(ROOFLINE_REPORTS):
            t = time.time()
            reports["roofline"] = torch_roofline_table.main(
                ["--reports", ROOFLINE_REPORTS])
            print(f"roofline_table,{time.time() - t:.1f},"
                  f"{ROOFLINE_REPORTS}/")
        else:
            print("roofline_table,skipped (run benchmarks.torch_dryrun_all "
                  "first),-")
    print(f"total,{time.time() - t0:.1f},-")
    return reports


if __name__ == "__main__":
    main()
