"""Quickstart for the PyTorch port: ProFe on a 4-node federation.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Trains the paper's MNIST-style setup (2-layer CNN teacher, half-channel
student) with ProFe and FedAvg through
``repro_torch.core.federation.run_federation``, then prints the final F1
of each, the communication saving and the wall times — the paper's two
headline numbers.  Runs on the card unless ``--device cpu`` is given
(and raises with no card).
"""
from __future__ import annotations

import argparse

from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.core.federation import run_federation
from repro_torch.core.profe import resolve_device
from repro_torch.data import image_federation

ALGORITHMS = ("profe", "fedavg")
NODES = 4


def run(rounds: int = 3, samples: int = 2400, device=None,
        verbose: bool = False) -> dict:
    """ProFe, then FedAvg, on mnist-cnn: ``samples`` images, a 0.1 test
    split, ``NODES`` iid nodes, ``rounds`` rounds each.  Returns each
    algorithm's ``{"f1": [...], "avg_sent_gb", "elapsed_s"}``, the node
    sizes and the ProFe byte reduction."""
    dev = resolve_device(device)
    cfg = get_config("mnist-cnn")
    node_data, test_d = image_federation(cfg, samples, NODES)
    train = TrainConfig(batch_size=64, learning_rate=1e-3,
                        optimizer="adamw", remat=False)
    out = {"model": cfg.name, "channels": list(cfg.cnn_channels),
           "device": str(dev), "node_sizes": [len(d["label"]) for d in node_data]}
    for algo in ALGORITHMS:
        fed = FederationConfig(num_nodes=NODES, rounds=rounds,
                               algorithm=algo)
        if verbose:
            print(f"\n=== {algo} ===")
        res = run_federation(cfg, fed, train, node_data, test_d,
                             verbose=verbose, device=dev)
        out[algo] = {"f1": list(res.f1_per_round),
                     "avg_sent_gb": res.extras["avg_sent_gb"],
                     "elapsed_s": res.elapsed_s}
    out["reduction"] = 1 - out["profe"]["avg_sent_gb"] / \
        out["fedavg"]["avg_sent_gb"]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    print(f"teacher: mnist-cnn  channels="
          f"{tuple(get_config('mnist-cnn').cnn_channels)}")
    out = run(device=args.device, verbose=True)
    p, f = out["profe"], out["fedavg"]
    print("\n----- summary -----")
    print(f"F1 (ProFe)  : {p['f1'][-1]:.3f}")
    print(f"F1 (FedAvg) : {f['f1'][-1]:.3f}")
    print(f"bytes/node  : {p['avg_sent_gb'] * 1e3:.2f} MB vs "
          f"{f['avg_sent_gb'] * 1e3:.2f} MB  (-{out['reduction']:.0%})")
    print(f"wall time   : {p['elapsed_s']:.0f}s vs {f['elapsed_s']:.0f}s "
          f"({p['elapsed_s'] / f['elapsed_s'] - 1:+.0%})")


if __name__ == "__main__":
    main()
