"""The wire audit: physical against logical gossip bytes per topology.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mnist-cnn \\
        --topology ring --pods 4x2 [--bits 4/16] [--ef] [--adapters 8] \\
        [--adapter-grams] [--adapter-frac F] [--json PATH] [--device cpu]

runs one round of each exchange (the per-leaf ``gather``, the packed
all-gather, the ``ppermute`` permute steps, and the full-graph
all-gather reference) on ``R·C`` spawned gloo ranks — R federation
nodes of C ranks each (``--pods RxC``) — at the architecture's student
shapes, and asserts the bytes each node hands to its collectives against
``ScheduleCommAccountant``'s prediction: within 10 %, below half the
full-graph gather on a sparse regular graph (2·degree ≤ R), and with
C > 1 (the row-sharded permute) or ``--adapters`` the pod permute bytes
equal to the prediction exactly.  Sub-int16 specs are also held to the
int16 round's code-buffer bytes by the spec's ratio, ``+ef`` to its
stateless twin's bytes (zero overhead), ``--adapters`` to below
``--adapter-frac`` of the dense round.  Prints the report as JSON and
exits 0 only when every gate passes.

Runs on the card unless ``--device cpu`` is given (and raises with no
card).  The JAX package's compile reports of this launcher's other mode
(``--shape``: XLA's memory and cost analyses of TPU meshes) are not
ported; without ``--topology`` it exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from typing import Any, Dict, Optional


def topology_report(arch: str, topology: str, pods, bits="16",
                    ef: bool = False, adapters: int = 0,
                    adapter_grams: bool = False,
                    adapter_frac: Optional[float] = None,
                    device=None) -> Dict[str, Any]:
    """The ``--topology`` audit: the exchanges' bytes on ``pods`` (``"R"``
    or ``"RxC"``) with the gates of the module docstring; raises
    ``AssertionError`` at the first that fails.  The spec's report and
    the references its gates need (the stateless twin of an ``+ef`` spec,
    the dense wire of an adapter rank, the int16 wire of a narrower spec)
    are measured on one spawn of ranks
    (:func:`launch.wire.measure_exchange_rows`)."""
    from repro_torch.core import topology as T
    from repro_torch.launch.wire import (check_adapter_reduction,
                                         check_bits_reduction,
                                         check_ef_zero_overhead,
                                         check_topology_bytes,
                                         measure_exchange_rows, parse_pods)
    from repro_torch.wirespec import WireSpec, resolve_spec
    pods, inner = parse_pods(pods)
    if adapters and inner > 1:
        raise ValueError("--adapters does not support multi-axis pods "
                         "('RxC') — the adapter wire has no row-sharded "
                         "permute lowering; use --pods R")
    spec = WireSpec.parse(bits) if isinstance(bits, str) \
        else resolve_spec(bits)
    if ef and not spec.error_feedback:
        spec = dataclasses.replace(spec, error_feedback=True)
    adj = T.make_schedule(pods, topology, rounds=1, seed=0).adjacency_at(0)
    deg = int(adj.sum(axis=1).max())
    regular = T.is_regular(adj)
    wire = dict(adapter_rank=adapters, adapter_grams=adapter_grams)
    rows = {"spec": dict(bits=spec, **wire)}
    # error feedback must be wire-free on every graph; ppermute is
    # checked too where the graph is regular
    ef_exs = ("packed", "ppermute") if regular else ("packed",)
    if spec.error_feedback:
        rows["stateless"] = dict(bits=spec.stateless(), exchanges=ef_exs,
                                 **wire)
    if regular and adapters:
        rows["dense"] = dict(bits=spec.stateless(), exchanges=("ppermute",))
    if regular and spec.stateless() != WireSpec.from_bits(16):
        rows["int16"] = dict(bits=16, exchanges=("ppermute",), **wire)
    reports = dict(zip(rows, measure_exchange_rows(
        arch, pods, topology, rows=list(rows.values()), inner=inner,
        device=device)))
    report = reports["spec"]
    if spec.error_feedback:
        report_sl = reports["stateless"]
        report["stateless_reference"] = {
            "bits": report_sl["bits"], "exchanges": report_sl["exchanges"]}
        for ex in ef_exs:
            check_ef_zero_overhead(report, report_sl, exchange=ex)
    if regular:
        # a regular graph takes ppermute and must pass the byte gate
        # (a recorded error fails it); a sparse one must also beat the
        # full gather by the margin its degree implies.  On the adapter
        # wire there is no full gather and the gate is exact
        frac = None if adapters else (0.5 if 2 * deg <= pods else None)
        check_topology_bytes(report, exchange="ppermute", rel_tol=0.10,
                             gather_frac=frac,
                             exact=bool(adapters) or inner > 1)
        if adapters:
            report_dense = reports["dense"]
            report["dense_reference"] = {
                "bits": report_dense["bits"],
                "packed_pred_bytes_per_node":
                    report_dense["packed_pred_bytes_per_node"],
                "exchanges": report_dense["exchanges"]}
            # the gram group rides at full [*, k, k] a leaf: unless the
            # caller pins a fraction, gram mode's ratio is recorded only
            check_adapter_reduction(
                report, report_dense, exchange="ppermute",
                frac=(adapter_frac if adapter_frac is not None
                      else (None if adapter_grams else 0.15)))
        if "int16" in reports:
            report16 = reports["int16"]
            report["int16_reference"] = {
                "packed_pred_bytes_per_node":
                    report16["packed_pred_bytes_per_node"],
                "exchanges": report16["exchanges"]}
            check_bits_reduction(report, report16, exchange="ppermute")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="wire audit: physical vs logical gossip bytes")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--json", default=None, help="write report JSON here")
    ap.add_argument("--topology", default=None,
                    help="gossip graph spec: one round of each exchange, "
                         "its collective bytes held to the accountant's")
    ap.add_argument("--pods", default="8",
                    help="'R' or 'RxC': R nodes x C ranks a node (C > 1: "
                         "the row-sharded permute, gated exactly)")
    ap.add_argument("--bits", default="16",
                    help="wire spec: 16 | 8 | 4 or <student>/<protos> "
                         "(e.g. 4/16); +ef (or --ef) for error feedback")
    ap.add_argument("--ef", action="store_true",
                    help="error-feedback codec, held to its stateless "
                         "twin's bytes")
    ap.add_argument("--adapters", type=int, default=0, metavar="RANK",
                    help="adapter-rank wire: rank-r delta factors, gated "
                         "exactly and below --adapter-frac x the dense "
                         "exchange")
    ap.add_argument("--adapter-grams", action="store_true",
                    help="ship RegMean gram statistics (with --adapters)")
    ap.add_argument("--adapter-frac", type=float, default=None,
                    help="required adapter-vs-dense byte fraction "
                         "(default 0.15; recorded only with "
                         "--adapter-grams unless set)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    if args.topology is None:
        print("repro_torch.launch.dryrun: only the --topology audit is "
              "ported; the JAX package's XLA compile reports (--shape) "
              "are not (ROADMAP.md)", file=sys.stderr)
        return 2
    from repro_torch.core.profe import resolve_device
    device = resolve_device(args.device)        # no card: raises
    try:
        report = topology_report(args.arch, args.topology, args.pods,
                                 bits=args.bits, ef=args.ef,
                                 adapters=args.adapters,
                                 adapter_grams=args.adapter_grams,
                                 adapter_frac=args.adapter_frac,
                                 device=str(device))
        report["status"] = "ok"
    except Exception as e:          # the report carries the failed gate
        report = {"arch": args.arch, "topology": args.topology,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()}
    print(json.dumps(report, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, default=str)
    return 0 if report["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
