"""Fig. 2 on the PyTorch port: average node F1 per round (mean ± spread
over nodes), ProFe vs the literature, across data splits.

Every node is evaluated each round (``eval_all_nodes=True``): the curve
is the node MEAN and the JSON carries the per-node curves and their
std.  Every row also carries its spec's wire bytes (logical and packed
per copy, and GB per node for the whole run), so bytes against F1 is
one artifact.  ``--bits ... --ef`` adds the error-feedback twin of each
sub-int16 spec (same bytes); ``--proto-pass both`` adds a ``+fused``
twin per proto-sharing spec; ``--proto-ema <decay>`` an ``+ema`` twin
(Eq. 3 accumulators carried across rounds with that decay);
``--adapter-rank`` runs the ProFe rows on the adapter-rank wire.

The default is the scaled-down protocol (4 nodes, MNIST-like synthetic
images, 3 rounds, 3 splits); ``--full`` runs the paper's (20 nodes, 10
rounds, 20,000 images).

    PYTHONPATH=src python -m benchmarks.torch_fig2_f1 [--full] \\
        [--splits iid noniid40 dirichlet] [--bits 16 4/16 --ef] \\
        [--device cpu]

Writes ``reports/torch_fig2_f1.json`` by default.  Runs on the card
unless ``--device cpu`` is given (and raises with no card).
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.core.federation import run_federation
from repro_torch.core.profe import resolve_device
from repro_torch.data import image_federation
from repro_torch.wirespec import WireSpec

ROOT = Path(__file__).resolve().parents[1]
JAX_REPORTS = ROOT / "reports"

ALGOS = ["fedavg", "fedproto", "fml", "fedgpd", "profe"]


_OVERRIDE_FIELDS = {"adapters": "adapter_quantize_bits",
                    "grams": "gram_quantize_bits"}


def _bits_fed_kwargs(bits: str):
    """CLI wire spec -> FederationConfig quantization fields.  Named
    group overrides (``"4/16,adapters=8,grams=16"``) map onto the
    matching per-group quantize fields; an override for a group the
    config has no field for is a spec typo, not a silent no-op."""
    spec = WireSpec.parse(bits)
    kwargs = {"quantize_bits": spec.student_bits,
              "proto_quantize_bits": spec.proto_bits,
              "error_feedback": spec.error_feedback}
    for group, b in spec.overrides:
        field = _OVERRIDE_FIELDS.get(group)
        if field is None:
            raise ValueError(
                f"wire spec {bits!r}: no FederationConfig field for "
                f"group {group!r} (known: {sorted(_OVERRIDE_FIELDS)})")
        kwargs[field] = b
    return kwargs


def _sub_int16(bits: str) -> bool:
    spec = WireSpec.parse(bits)
    return spec.student_bits < 16 or (spec.proto_bits or 16) < 16


def _jobs(algos, bits, proto_pass, proto_ema):
    """``(row name, algorithm, wire spec, Eq. 3 pass, EMA decay)`` per
    run: ProFe once per wire spec, the proto-sharing algorithms once per
    pass mode, each with an ``+ema`` twin when ``proto_ema`` is set."""
    jobs = []
    for algo in algos:
        sharing = algo in ("profe", "fedproto", "fedgpd")
        passes = proto_pass if sharing else ("exact",)
        for pp in passes:
            suffix = "+fused" if pp == "fused" else ""
            emas = (0.0, proto_ema) if proto_ema and sharing else (0.0,)
            for em in emas:
                esuf = "+ema" if em else ""
                if algo == "profe":
                    jobs += [(f"profe@{b}{suffix}{esuf}"
                              if len(bits) > 1 or b != "16" or suffix
                              or esuf else "profe", algo, b, pp, em)
                             for b in bits]
                else:
                    jobs.append((f"{algo}{suffix}{esuf}", algo, "16", pp,
                                 em))
    return jobs


def run(dataset: str, split: str, *, nodes: int, rounds: int, epochs: int,
        n_samples: int, algos=ALGOS, seed: int = 0, verbose=False,
        topology: str = "full", bits=("16",), proto_pass=("exact",),
        proto_ema: float = 0.0, adapter_rank: int = 0,
        adapter_grams: bool = False, device=None):
    dev = resolve_device(device)
    cfg = get_config(dataset)
    # the paper: 10 % of the images as the global test split
    node_data, test_d = image_federation(cfg, n_samples, nodes, split, seed)
    train = TrainConfig(batch_size=64, learning_rate=1e-3, optimizer="adamw",
                        remat=False)
    out = {}
    for name, algo, b, pp, em in _jobs(algos, bits, proto_pass, proto_ema):
        # the adapter-rank wire applies to ProFe's student gossip only;
        # the baselines keep their dense exchanges for comparison
        ad = {"adapter_rank": adapter_rank,
              "adapter_grams": adapter_grams} \
            if adapter_rank and algo == "profe" else {}
        fed = FederationConfig(num_nodes=nodes, rounds=rounds,
                               local_epochs=epochs, algorithm=algo,
                               split=split, seed=seed, topology=topology,
                               proto_pass=pp, proto_ema=em,
                               **_bits_fed_kwargs(b), **ad)
        res = run_federation(cfg, fed, train, node_data, test_d,
                             verbose=verbose, eval_all_nodes=True,
                             device=dev)
        out[name] = {
            "f1_per_round": res.f1_per_round,           # mean over nodes
            "f1_std_per_round": res.extras.get("f1_std_per_round", []),
            "f1_per_round_nodes": res.extras.get("f1_per_round_nodes", []),
            "avg_sent_gb": res.extras["avg_sent_gb"],
            "wire_bytes_per_copy": res.extras.get("wire_bytes_per_copy"),
            "wire_bytes_packed_per_copy":
                res.extras.get("wire_bytes_packed_per_copy"),
            "avg_sent_packed_gb": res.extras.get("avg_sent_packed_gb"),
            "elapsed_s": res.elapsed_s,
            "proto_pass": pp,
        }
        if em:
            out[name]["proto_ema"] = em
        if algo == "profe":
            out[name]["bits"] = WireSpec.parse(b).describe()
            if adapter_rank:
                out[name]["adapter_rank"] = adapter_rank
                out[name]["adapter_grams"] = adapter_grams
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper protocol (20 nodes, 10 rounds)")
    ap.add_argument("--datasets", nargs="+", default=["mnist-cnn"])
    ap.add_argument("--splits", nargs="+",
                    default=["iid", "noniid40", "dirichlet"])
    ap.add_argument("--algos", nargs="+", default=ALGOS)
    ap.add_argument("--topology", default="full",
                    help="gossip graph spec — sparse graphs make the "
                         "per-node spread non-zero")
    ap.add_argument("--bits", nargs="+", default=["16"],
                    help="wire specs for the profe bits column, e.g. "
                         "--bits 16 8 4 4/16 (mixed = int4 student + "
                         "int16 prototypes); a +ef suffix enables the "
                         "stateful error-feedback codec")
    ap.add_argument("--proto-pass", choices=["exact", "fused", "both"],
                    default="exact",
                    help="Eq. 3 pass mode for proto-sharing algos; "
                         "'both' adds a '+fused' twin row per spec")
    ap.add_argument("--proto-ema", type=float, default=0.0,
                    help="add an '+ema' twin row per proto-sharing spec "
                         "with this Eq. 3 accumulator decay (0 = off)")
    ap.add_argument("--adapter-rank", type=int, default=0,
                    help="run the profe rows on the adapter-rank wire: "
                         "matrix leaves gossip rank-r delta factors "
                         "instead of dense parameters; 0 = dense gossip")
    ap.add_argument("--adapter-grams", action="store_true",
                    help="with --adapter-rank: ship RegMean gram "
                         "statistics and merge gram-weighted")
    ap.add_argument("--ef", action="store_true",
                    help="add an error-feedback twin row (spec+ef, zero "
                         "extra wire bytes) for every sub-int16 spec")
    ap.add_argument("--out", default="reports/torch_fig2_f1.json")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if out.parent == JAX_REPORTS and out.name.startswith("fig2_f1"):
        ap.error(f"--out {args.out} is the JAX package's report")

    bits = list(args.bits)
    if args.ef:
        bits += [b + "+ef" for b in args.bits
                 if _sub_int16(b) and not b.endswith("+ef")
                 and b + "+ef" not in bits]
    args.bits = bits
    nodes, rounds, epochs, n = (20, 10, 1, 20000) if args.full \
        else (4, 3, 1, 2400)
    results = {}
    for ds in args.datasets:
        for split in args.splits:
            key = f"{ds}/{split}"
            print(f"== {key} (topology={args.topology}) ==", flush=True)
            passes = ("exact", "fused") if args.proto_pass == "both" \
                else (args.proto_pass,)
            results[key] = run(ds, split, nodes=nodes, rounds=rounds,
                               epochs=epochs, n_samples=n, algos=args.algos,
                               topology=args.topology, bits=args.bits,
                               proto_pass=passes,
                               proto_ema=args.proto_ema,
                               adapter_rank=args.adapter_rank,
                               adapter_grams=args.adapter_grams,
                               device=args.device)
            for algo, r in results[key].items():
                curve = " ".join(
                    f"{x:.3f}±{s:.3f}"
                    for x, s in zip(r["f1_per_round"],
                                    r["f1_std_per_round"]))
                print(f"  {algo:9s} f1: {curve}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
