#!/usr/bin/env python3
"""Where the time of the port's ``lowrank_apply`` kernel goes, on the card.

    python3 benchmarks/torch_lowrank_phases.py

Needs one CUDA card (exits 2 without one).  Times the kernel with
``chip_smoke.py``'s ``Timer`` (median of 50 launches, L2 flushed, the card
kept busy) at fc1's shape of the adapter merge (``w [N, 1568, 128]``,
rank 8) with the receivers N and senders S cut one at a time, so the
bank design's two phases show apart: S senders' products into the bank
with N = 1 (phase 1), N receivers swept from a bank of S = 1 (phase 2,
about the bytes of ``w`` and ``out``), and both at N = S = 20; the groups
design (``A`` per receiver) at S = 20 and S = 1.  Beside them, the floor
of one launch (a one-element add) and a 16 MB copy (``w``'s bytes read
and written once).  Prints each time, the card's ``nvidia-smi`` name and
power limit, and one JSON object last.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N, S, D, K, R = 20, 20, 1568, 128, 8


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_lowrank_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import Timer
    from repro_torch.kernels.build import library
    from repro_torch.kernels.lowrank_apply.lowrank_apply import (
        lowrank_apply_cuda, lowrank_plan)
    library()
    timer = Timer(torch)
    gen = torch.Generator().manual_seed(0)

    def inputs(n, s, per_recv):
        w = (torch.randn((n, D, K), generator=gen) * 0.05).cuda()
        c = (torch.rand((n, s), generator=gen) / s).cuda()
        b = (torch.randn((s, D, R), generator=gen) / math.sqrt(D)).cuda()
        a = (torch.randn(((n,) if per_recv else ()) + (s, R, K),
                         generator=gen) * 1e-3).cuda()
        return w, c, b, a

    res = {}
    for label, n, s, per_recv in (("shared N=20 S=20", N, S, False),
                                  ("shared N=1 S=20 (phase 1)", 1, S, False),
                                  ("shared N=20 S=1 (phase 2)", N, 1, False),
                                  ("per_recv N=20 S=20", N, S, True),
                                  ("per_recv N=20 S=1", N, 1, True)):
        w, c, b, a = inputs(n, s, per_recv)
        out = torch.empty_like(w)
        plan = lowrank_plan(n, s, 1, D, K, R, per_recv)
        ms = timer(lambda: lowrank_apply_cuda(w, c, b, a, out=out))
        res[label] = dict(ms=ms, design=plan.design,
                          tile=[plan.tile_d, plan.tile_k],
                          stages=plan.stages, grid=plan.grid)
        print(f"{label}: {ms:.4f} ms ({plan.design} {plan.tile_d}x"
              f"{plan.tile_k}, ring of {plan.stages}, grid {plan.grid})")
    one = torch.zeros(1, device="cuda")
    res["one launch (1-element add)"] = dict(ms=timer(lambda: one.add_(1)))
    x = torch.empty((N, D, K), device="cuda")
    y = torch.empty_like(x)
    res["16 MB copy"] = dict(ms=timer(lambda: y.copy_(x)))
    for label in ("one launch (1-element add)", "16 MB copy"):
        print(f"{label}: {res[label]['ms']:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"card": smi, "times": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
