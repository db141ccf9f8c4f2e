"""ProFe ablations on the PyTorch port (beyond the paper's tables): which
of the three ingredients buys what?

* wire precision: 32 / 16 (paper) / 8 bit — ``quantize_bits=32`` is the
  uniform 32-bit codec, as the JAX package resolves it
  (``wirespec.resolve_bits``), not the raw fp32 wire
* professor-importance decay: paper schedule vs alpha fixed vs alpha=0
  (no distillation at all)
* prototypes: on vs off (beta_s = beta_t = 0)

Each cell reports final F1, bytes/node, and wall time on the scaled-down
MNIST-style protocol.

    PYTHONPATH=src python -m benchmarks.torch_ablations [--rounds 3] \\
        [--split iid] [--out reports/torch_ablations.json] [--device cpu]

Runs on the card unless ``--device cpu`` is given (and raises with no
card).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.config import FederationConfig, TrainConfig, get_config
from repro_torch.core.federation import run_federation
from repro_torch.core.profe import resolve_device
from repro_torch.data import image_federation


def setting(n_nodes=4, n=2400, split="iid", seed=0):
    cfg = get_config("mnist-cnn")
    node_data, test_d = image_federation(cfg, n, n_nodes, split, seed)
    return cfg, node_data, test_d


ABLATIONS = {
    "paper (16-bit, decay, protos)": dict(),
    "32-bit wire": dict(quantize_bits=32),
    "8-bit wire": dict(quantize_bits=8),
    "no decay (alpha fixed)": dict(alpha_limit=0.0),
    "no distillation (alpha=0)": dict(alpha_s=0.0, alpha_limit=1.0),
    "no prototypes (beta=0)": dict(beta_s=0.0, beta_t=0.0),
}


def run(rounds: int = 3, split: str = "iid", n_nodes: int = 4,
        n: int = 2400, device=None, verbose: bool = False) -> dict:
    """Every row of ``ABLATIONS`` on :func:`setting`'s federation:
    name -> ``{"f1", "f1_curve", "mb_per_node", "avg_sent_gb",
    "elapsed_s"}``."""
    dev = resolve_device(device)
    cfg, node_data, test_d = setting(n_nodes=n_nodes, n=n, split=split)
    train = TrainConfig(batch_size=64, learning_rate=1e-3,
                        optimizer="adamw", remat=False)
    results = {}
    if verbose:
        print(f"{'ablation':34s} {'final F1':>9s} {'MB/node':>9s} "
              f"{'time s':>7s}")
    for name, overrides in ABLATIONS.items():
        fed = FederationConfig(num_nodes=len(node_data), rounds=rounds,
                               algorithm="profe", split=split, **overrides)
        res = run_federation(cfg, fed, train, node_data, test_d, device=dev)
        row = {
            "f1": res.f1_per_round[-1],
            "f1_curve": list(res.f1_per_round),
            "mb_per_node": res.extras["avg_sent_gb"] * 1e3,
            "avg_sent_gb": res.extras["avg_sent_gb"],
            "elapsed_s": res.elapsed_s,
        }
        results[name] = row
        if verbose:
            print(f"{name:34s} {row['f1']:9.3f} {row['mb_per_node']:9.2f} "
                  f"{row['elapsed_s']:7.1f}", flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--split", default="iid")
    ap.add_argument("--out", default="reports/torch_ablations.json")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run off the card (default: cuda)")
    args = ap.parse_args(argv)
    results = run(args.rounds, args.split, device=args.device, verbose=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
