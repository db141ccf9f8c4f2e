"""Topology sweep for the PyTorch port: how the gossip graph trades
communication for convergence on CIFAR-style synthetic data — logical
accountant bytes printed NEXT TO the physical bytes the multi-node
exchange hands to its collectives.

Runs the same ProFe federation (stacked round engine) over a
fully-connected graph, a ring, a time-varying ring/star schedule and a
random 2-regular graph: ``TopologySchedule`` lowers each to per-round
gossip matrices.  The logical bytes are ``run_federation``'s
``avg_sent_gb`` (Table II math); the physical bytes of each single-phase
topology come from ``repro_torch.launch.wire.measure_exchange_bytes``,
one round of each exchange on spawned gloo ranks (one a node, all on
this run's device) — on a ring the ``ppermute`` exchange moves
O(degree), not O(N), bytes a node.

    PYTHONPATH=src python examples/torch_topology_sweep.py [--rounds 2] \\
        [--nodes 4] [--topologies full ring] [--bits 16 4/16+ef] \\
        [--no-physical] [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises with no
card).
"""
from __future__ import annotations

import argparse

from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.core import topology as T
from repro_torch.core.federation import run_federation
from repro_torch.core.profe import resolve_device
from repro_torch.data import image_federation
from repro_torch.wirespec import WireSpec

TOPOLOGIES = ("full", "ring", "dynamic:ring,star", "random-k2")
ARCH = "cifar10-resnet18"


def run(topologies=TOPOLOGIES, bits=("16",), nodes: int = 4,
        rounds: int = 2, samples: int = 1200, physical: bool = True,
        device=None, verbose: bool = False) -> dict:
    """ProFe on cifar10-resnet18 over each topology at each wire spec of
    ``bits``.  Returns ``{"runs": [...]}``, one entry a (topology, spec):
    its phases and directed edges a round, F1 a round, ``avg_sent_gb``,
    seconds and, for a single-phase topology with ``physical``, the
    audit's report (``"physical"``) or why it was skipped
    (``"physical_skipped"``)."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)
    node_data, test_d = image_federation(cfg, samples, nodes)
    train = TrainConfig(batch_size=32, learning_rate=1e-3,
                        optimizer="adamw", remat=False)
    runs = []
    for topo in topologies:
        sched = T.make_schedule(nodes, topo, rounds=rounds, seed=0)
        edges = sched.directed_edge_counts().tolist()
        if verbose:
            print(f"== {topo}: {sched.num_phases} phase(s), {edges} "
                  f"directed edges/round ==")
        for b in bits:
            spec = WireSpec.parse(b)
            tag = f"{topo} @ {spec.describe()}"
            fed = FederationConfig(num_nodes=nodes, rounds=rounds,
                                   local_epochs=1, algorithm="profe",
                                   topology=topo,
                                   quantize_bits=spec.student_bits,
                                   proto_quantize_bits=spec.proto_bits,
                                   error_feedback=spec.error_feedback)
            res = run_federation(cfg, fed, train, node_data, test_d,
                                 verbose=verbose, device=dev)
            entry = {"topology": topo, "bits": spec.describe(),
                     "phases": sched.num_phases, "edges": edges,
                     "f1": list(res.f1_per_round),
                     "avg_sent_gb": res.extras["avg_sent_gb"],
                     "elapsed_s": res.elapsed_s}
            runs.append(entry)
            if verbose:
                print(f"[{tag}] final F1 {res.f1_per_round[-1]:.3f} | "
                      f"{res.extras['avg_sent_gb'] * 1e3:.1f} MB sent/node "
                      f"(logical) | {res.elapsed_s:.0f}s")
            if not physical or sched.num_phases != 1:
                continue
            from repro_torch.launch.wire import measure_exchange_bytes
            try:
                wire = measure_exchange_bytes(ARCH, nodes, topo, bits=spec,
                                              device=str(dev))
            except RuntimeError as e:
                entry["physical_skipped"] = str(e)
                if verbose:
                    print(f"[{tag}] physical bytes skipped: {e}\n")
                continue
            entry["physical"] = wire
            if verbose:
                print(f"[{tag}] wire per round/node: "
                      f"logical {wire['logical_bytes_per_node'] / 1e6:.2f} "
                      f"MB | " + " | ".join(
                          f"physical {ex} "
                          f"{rep['collective_bytes_per_node'] / 1e6:.2f} MB"
                          for ex, rep in wire["exchanges"].items()
                          if "error" not in rep))
        if verbose:
            print()
    return {"device": str(dev), "nodes": nodes, "rounds": rounds,
            "runs": runs}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--samples", type=int, default=1200)
    ap.add_argument("--topologies", nargs="+", default=list(TOPOLOGIES))
    ap.add_argument("--bits", nargs="+", default=["16"],
                    help="wire specs to sweep per topology (16 | 8 | 4 "
                         "| <student>/<protos>, e.g. 4/16; +ef suffix "
                         "= stateful error-feedback codec): quantifies "
                         "the F1 cost of the comm-reduction knob")
    ap.add_argument("--no-physical", action="store_true",
                    help="skip the per-topology physical-bytes audit")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    run(args.topologies, args.bits, args.nodes, args.rounds, args.samples,
        physical=not args.no_physical, device=args.device, verbose=True)


if __name__ == "__main__":
    main()
