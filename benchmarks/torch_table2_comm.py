"""Table II on the PyTorch port: network bytes sent/received per node
(GB) and % vs FedAvg, per algorithm — logical (accountant) next to
physical (spawned gloo ranks) wire bytes per topology.

Byte counts are analytic serialized payload sizes (exact), so the table
needs no long training: a run of real models meters the exact payload
every round.  ``--full`` uses the paper's 20-node / 10-20-80-round
protocol.  ``--topology`` accepts any ``core/topology.make_schedule``
spec.

``--physical`` also runs one gossip round of each exchange on spawned
gloo ranks (``launch/wire.measure_exchange_bytes``) and prints the bytes
each node hands to collectives beside the accountant's prediction.  The
``ppermute`` bytes are the JAX package's (its compiled HLO's) exactly;
``gather`` and ``packed`` are counted on the port's own tensors, which
differ from the JAX package's where ``EXCHANGE_COUNTS`` says so.  Each
exchange entry is the port audit's: kernel ``launches`` summed over the
ranks where the JAX report has its HLO collectives' ``counts``.

    PYTHONPATH=src python -m benchmarks.torch_table2_comm [--full] \\
        [--datasets mnist-cnn] [--bits 16,4/16] [--physical] \\
        [--adapters 8 [--adapter-grams]] [--device cpu]

Writes ``reports/torch_table2_comm.json`` by default.  Runs on the card
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

ROOT = Path(__file__).resolve().parents[1]
JAX_REPORT = ROOT / "reports" / "table2_comm.json"

ALGOS = ["fedavg", "fedgpd", "fml", "fedproto", "profe"]
PAPER_ROUNDS = {"mnist-cnn": 10, "cifar10-resnet18": 20,
                "cifar100-resnet32": 80}
# what each physical exchange's bytes are, against the JAX package's
EXCHANGE_COUNTS = {
    "ppermute": "the JAX package's HLO bytes exactly",
    "packed": "the port's count: the JAX package's at one rank a node; "
              "several ranks a node gather the spec-width copy "
              "replicated, where the JAX package gathers the container "
              "width row-sharded",
    "gather": "the port's count: it gathers each leaf's codes and scale, "
              "where the JAX package's compiled gather moves wider "
              "tensors",
}


def measure(dataset: str, *, nodes: int, rounds: int,
            n_samples: int = 1200, seed: int = 0, topology: str = "full",
            device=None):
    dev = resolve_device(device)
    cfg = get_config(dataset)
    node_data, test_d = image_federation(cfg, n_samples, nodes, "iid", seed)
    train = TrainConfig(batch_size=64, learning_rate=1e-3, optimizer="adamw",
                        remat=False)
    rows = {}
    for algo in ALGOS:
        fed = FederationConfig(num_nodes=nodes, rounds=rounds,
                               local_epochs=1, algorithm=algo, seed=seed,
                               topology=topology)
        res = run_federation(cfg, fed, train, node_data, test_d, device=dev)
        rows[algo] = {
            "sent_gb": res.extras["avg_sent_gb"],
            "received_gb": res.extras["avg_received_gb"],
        }
    base = rows["fedavg"]["sent_gb"]
    for algo in ALGOS:
        rows[algo]["pct_vs_fedavg"] = 100.0 * (rows[algo]["sent_gb"] / base - 1)
    return rows


def physical_wire(dataset: str, nodes: int, topology: str, bits="16",
                  adapter_rank: int = 0, adapter_grams: bool = False,
                  device=None):
    """One ProFe gossip round per exchange mode on ``nodes`` spawned gloo
    ranks; per-node collective bytes beside the accountant's, each
    exchange labelled with what its count is (``EXCHANGE_COUNTS``)."""
    from repro_torch.launch.wire import measure_exchange_bytes
    rep = measure_exchange_bytes(dataset, nodes, topology, bits=bits,
                                 adapter_rank=adapter_rank,
                                 adapter_grams=adapter_grams, device=device)
    for ex, entry in rep["exchanges"].items():
        entry["counted_as"] = EXCHANGE_COUNTS[ex]
    return rep


def logical_wire(dataset: str, nodes: int, topology: str, bits="16",
                 adapter_rank: int = 0, adapter_grams: bool = False):
    """Accountant-only per-bits wire bytes (no training, no ranks):
    logical (Table II) and packed-codec predictions for one gossip round,
    from the same ``accountant_payload`` the wire audit is held to."""
    from repro_torch.core import topology as T
    from repro_torch.core.comm import ScheduleCommAccountant
    from repro_torch.launch.wire import accountant_payload, student_setup
    from repro_torch.wirespec import WireSpec
    spec = WireSpec.parse(bits)
    sched = T.make_schedule(nodes, topology, rounds=1, seed=0)
    _cfg, student_cfg, struct, ncls = student_setup(dataset)
    payload = accountant_payload(struct, ncls, student_cfg.proto_dim,
                                 adapter_rank=adapter_rank,
                                 adapter_grams=adapter_grams)
    acct = ScheduleCommAccountant(sched)
    return {
        "bits": spec.describe(),
        "logical_bytes_per_node": int(acct.predicted_node_bytes(
            payload, 0, spec, wire="dense").max()),
        "packed_pred_bytes_per_node": int(acct.predicted_node_bytes(
            payload, 0, spec, wire="packed").max()),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--datasets", nargs="+", default=["mnist-cnn"])
    ap.add_argument("--topology", default="full",
                    help="gossip graph spec (core/topology.make_schedule)")
    ap.add_argument("--physical", action="store_true",
                    help="also run one gossip round per exchange mode on "
                         "spawned gloo ranks and print the bytes handed "
                         "to collectives")
    ap.add_argument("--bits", default="16",
                    help="comma list of wire specs for the per-bits wire "
                         "column, e.g. 16,8,4 or 16,4/16 (the first is "
                         "the headline row)")
    ap.add_argument("--adapters", type=int, default=0, metavar="RANK",
                    help="adapter-rank wire for the wire columns: matrix "
                         "leaves ride as rank-r delta factors "
                         "('adapters' payload group) instead of dense "
                         "parameters")
    ap.add_argument("--adapter-grams", action="store_true",
                    help="with --adapters: add the RegMean gram "
                         "statistics payload group")
    ap.add_argument("--out", default="reports/torch_table2_comm.json")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    if Path(args.out).resolve() == JAX_REPORT:
        ap.error(f"--out {args.out} is the JAX package's report")

    nodes = 20 if args.full else 4
    bits_list = [b.strip() for b in args.bits.split(",") if b.strip()]
    results = {}
    for ds in args.datasets:
        rounds = PAPER_ROUNDS.get(ds, 10) if args.full else 2
        print(f"== {ds} ({nodes} nodes, {rounds} rounds, "
              f"topology={args.topology}) ==", flush=True)
        rows = measure(ds, nodes=nodes, rounds=rounds,
                       n_samples=20000 if args.full else 1200,
                       topology=args.topology, device=args.device)
        results[ds] = rows
        print(f"  {'algo':9s} {'sent GB':>10s} {'recv GB':>10s} {'% vs FedAvg':>12s}")
        for algo, r in rows.items():
            print(f"  {algo:9s} {r['sent_gb']:10.4f} {r['received_gb']:10.4f} "
                  f"{r['pct_vs_fedavg']:+11.1f}%")
        rows["wire_bits"] = {}
        for b in bits_list:
            if args.physical:
                wire = physical_wire(ds, nodes, args.topology, bits=b,
                                     adapter_rank=args.adapters,
                                     adapter_grams=args.adapter_grams,
                                     device=args.device)
            else:
                wire = logical_wire(ds, nodes, args.topology, bits=b,
                                    adapter_rank=args.adapters,
                                    adapter_grams=args.adapter_grams)
            if args.adapters:
                wire["adapter_rank"] = args.adapters
                wire["adapter_grams"] = args.adapter_grams
            rows["wire_bits"][b] = wire
            print(f"  profe wire @ bits={b}, per round per node "
                  f"(topology={args.topology}):")
            print(f"    logical (accountant)  "
                  f"{wire['logical_bytes_per_node']/1e6:9.3f} MB   "
                  f"packed codec {wire['packed_pred_bytes_per_node']/1e6:9.3f} MB")
            for ex, rep in wire.get("exchanges", {}).items():
                if "error" in rep:
                    print(f"    physical [{ex:8s}]  {rep['error']}")
                    continue
                print(f"    physical [{ex:8s}]  "
                      f"{rep['collective_bytes_per_node']/1e6:9.3f} MB "
                      f"({', '.join(rep['by_kind'])}; {rep['counted_as']})")
        rows["wire"] = rows["wire_bits"][bits_list[0]]   # headline row
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
