#!/usr/bin/env python3
"""Times of the port's three plane sweeps on the card, without and with
a per-node mask.

    python3 benchmarks/torch_masked_sweeps.py [--src DIR] [--label L]

Needs one CUDA card (exits 2 without one).  Imports ``repro_torch`` from
``--src`` (default: this checkout's ``src/``), so one call can time two
trees of the port in turns (before, after, after, before); its kernels
are built into that tree's own ``build/``.  Times with
``chip_smoke.py``'s ``Timer`` (median of 50 launches, L2 flushed, the
card kept busy) through the wrappers, at the paths' shapes:
``adamw_update`` on 20 nodes' mnist-cnn student planes ``[20, 416,
512]``, ``sgd_update`` and ``adafactor_apply`` on the ResNet8 student's
``[20, 208, 512]``.  Unmasked on every tree (adamw with the bias
corrections its wrapper takes: one for all nodes, or one a node); where
the wrappers take ``active``, also with every third node masked out (14
of 20 on) and with none on.  Prints each time beside one launch (a
one-element add), the card's ``nvidia-smi`` name and power limit, and
one JSON object last.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_masked_sweeps: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import Timer
    import repro_torch
    from repro_torch.kernels.build import library
    from repro_torch.kernels.opt_update.opt_update import (
        adafactor_apply_cuda, adamw_update_cuda, sgd_update_cuda)
    library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: repro_torch from {Path(repro_torch.__file__).parent}"
          f"; {smi}")
    masks = "active" in inspect.signature(adamw_update_cuda).parameters
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    one = torch.zeros(1, device="cuda")
    res["launch"] = timer(lambda: torch.add(one, 1.0, out=one))
    print(f"one launch (1-element add): {res['launch']:.4f} ms")

    def bufs(rows, k):
        return [torch.randn((N_NODES, rows, 512), generator=gen,
                            device="cuda").abs() * 1e-3 for _ in range(k)]
    lr = torch.full((), 1e-3, device="cuda")
    scale = torch.rand((N_NODES,), generator=gen, device="cuda") + 0.1
    step = torch.full((N_NODES,) if masks else (), 3.0, device="cuda")
    bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    g, p, mu, nu = bufs(416, 4)
    gs, ps, mus = bufs(208, 3)
    upd, pa = bufs(208, 2)
    calls = {
        "adamw_update": lambda **m: adamw_update_cuda(
            g, p, mu, nu, lr, scale, bc1, bc2, **hp, **m),
        "sgd_update": lambda **m: sgd_update_cuda(
            gs, ps, mus, lr, scale, momentum=0.9, weight_decay=0.01, **m),
        "adafactor_apply": lambda **m: adafactor_apply_cuda(
            upd, pa, lr, weight_decay=0.01, **m)}
    cases = {"unmasked": None}
    if masks:
        cases["14 of 20 on"] = torch.tensor(
            [i % 3 != 2 for i in range(N_NODES)], device="cuda")
        cases["none on"] = torch.zeros(N_NODES, dtype=torch.bool,
                                       device="cuda")
    for name, call in calls.items():
        res[name] = {}
        for case, mask in cases.items():
            kw = {} if mask is None else {"active": mask}
            res[name][case] = timer(lambda: call(**kw))
            print(f"{name} {case}: {res[name][case]:.4f} ms")
    print(smi)
    print(json.dumps({"label": args.label, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
