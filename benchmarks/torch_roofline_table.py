"""Render the port's roofline table from the compile-report sweep's
reports (``benchmarks/torch_dryrun_all.py``, in ``reports/torch_dryrun/``),
as ``roofline_table.py`` renders the JAX package's.

    PYTHONPATH=src python -m benchmarks.torch_roofline_table \\
        [--reports reports/torch_dryrun]

Per (arch x shape x mesh): the three roofline terms in seconds at the
H100's published peaks (``launch/roofline.py``), the dominant term,
``6ND`` over the counted FLOPs, whether the program's peak fits the
card's 80 GB, and for ``pod2``'s training steps ProFe's gossip bytes
a node against FedAvg's.  Reports of a node of several cards
(``torch_dryrun_all.py --cards-per-node D``) make a second table: per
card, the memory, compute and collective seconds, the dominant term, the
layout and whether the rank's peak fits 80 GB.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

REPORTS = "reports/torch_dryrun"


def load_reports(path: str = REPORTS) -> List[Dict]:
    reports = []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            reports.append(json.load(fh))
    return reports


def _fits(r: Dict) -> str:
    mem = r.get("memory_analysis", {})
    fits = mem.get("fits_80gb_hbm")
    if fits is None:
        return "-"
    return "yes" if fits else "NO"


def render(reports: List[Dict], mesh: str = "pod1") -> str:
    rows = [r for r in reports if r.get("mesh") == mesh
            and r.get("status") == "ok" and r.get("cards_per_node", 1) == 1]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant "
        "| 6ND/counted | fits 80GB |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        t = r["terms_s"]
        ratio = r.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3g} "
            f"| {t['memory_s']:.3g} | {t['collective_s']:.3g} "
            f"| **{r['dominant']}** "
            f"| {'-' if ratio is None else f'{ratio:.2f}'} "
            f"| {_fits(r)} |")
    return "\n".join(lines)


def render_node(reports: List[Dict], cards: int, mesh: str = "pod1") -> str:
    """The combos of a node of ``cards`` cards, per card."""
    rows = [r for r in reports if r.get("mesh") == mesh
            and r.get("status") == "ok"
            and r.get("cards_per_node", 1) == cards]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    lines = [
        "| arch | shape | layout | memory_s | compute_s | collective_s "
        "| dominant | fits 80GB |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        t = r["terms_s"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['layout']} "
            f"| {t['memory_s']:.3g} | {t['compute_s']:.3g} "
            f"| {t['collective_s']:.3g} | **{r['dominant']}** "
            f"| {_fits(r)} |")
    return "\n".join(lines)


def render_federate(reports: List[Dict]) -> str:
    lines = ["| arch | ProFe wire B/node | FedAvg wire B/node | reduction |",
             "|---|---|---|---|"]
    for r in sorted(reports, key=lambda r: r.get("arch", "")):
        fed = r.get("federate")
        if not fed or r.get("mesh") != "pod2" or \
                r.get("cards_per_node", 1) != 1:
            continue
        p = fed["profe_collective_bytes"]["total"]
        f = fed["fedavg_collective_bytes"]["total"]
        red = fed.get("wire_reduction_vs_fedavg")
        lines.append(f"| {r['arch']} | {p / 1e6:.1f} MB | {f / 1e6:.1f} MB "
                     f"| {red:.1%} |")
    return "\n".join(lines)


def main(argv=None) -> Dict[str, str]:
    """Print the tables; returns them by name (``pod1``, ``pod2``,
    ``federate``, and ``<D> cards`` for each node of D cards reported)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--reports", default=REPORTS)
    args = ap.parse_args(argv)
    reports = load_reports(args.reports)
    ok = sum(1 for r in reports if r.get("status") == "ok")
    print(f"{ok}/{len(reports)} combos ok\n")
    tables = {}
    for mesh in ("pod1", "pod2"):
        tables[mesh] = render(reports, mesh)
        print(f"### mesh {mesh}\n")
        print(tables[mesh])
        print()
    tables["federate"] = render_federate(reports)
    print("### ProFe vs FedAvg gossip (pod2)\n")
    print(tables["federate"])
    for cards in sorted({r.get("cards_per_node", 1) for r in reports} - {1}):
        name = f"{cards} cards"
        tables[name] = render_node(reports, cards)
        print(f"\n### one node of {cards} cards (pod1), per card\n")
        print(tables[name])
    return tables


if __name__ == "__main__":
    main()
