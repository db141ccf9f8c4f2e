#!/usr/bin/env python3
"""Times of the port's ``adamw_update`` and ``quantize_rows_ef`` on the
card, at every shape their paths give them.

    python3 benchmarks/torch_sweep_ef_phases.py [--src DIR] [--label L]
                                                [--plans]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src/``), so one call can time two trees of the port in turns (before,
after, after, before); its kernels are built into that tree's own
``build/``.  Times with ``chip_smoke.py``'s ``Timer`` (median of 50
launches, L2 flushed, the card kept busy) through the wrappers, on
seeded random fp32 buffers:

* ``adamw_update`` on ``[N, R, 512]`` planes: the main path's ``[20,
  416, 512]`` unmasked and with 14 of 20 nodes on, a rank's node ``[1,
  416, 512]``, the round-step's ``[N, 112, 512]`` at N = 2, 4, 8, the
  cifar100 paper script's ``[4, 22144, 512]`` and the LM plane ``[4,
  164832, 512]`` (4 nodes of 84.4 M elements);
* ``quantize_rows_ef`` on ``[R, 512]`` at decay 1.0, Δ each row's absmax
  of ``x + res`` over 7, qmax 7: the ``4/16+ef`` payload's ``[8320,
  512]``, the tree payload's ``[960, 512]`` and a rank's node ``[416,
  512]``;
* one launch (a one-element add), and for each case a ``copy_`` that
  moves the bytes its bound counts (half read, half written), and that
  bound at the H100's memory rate.

Each result is held bit for bit to its plain version first.  The adamw
kernel's one shape, a float4 a thread in blocks of 256, is the one that
timed fastest or level here at every case against 2 and 4 vectors a
thread and blocks of 128.  With ``--plans`` it
prints the launch plan of each case as this tree's ``adamw_plan`` and
``rows_plan`` pick it, and exits; that needs no card.  Otherwise it
needs one CUDA card (exits 2 without one), and prints each time, the
card's ``nvidia-smi`` name and power limit, and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COLS = 512
# adamw_update's cases: name -> [nodes, rows, 512]
ADAMW_CASES = {
    "main path [20, 416, 512]": (20, 416),
    "a rank's node [1, 416, 512]": (1, 416),
    "round-step [2, 112, 512]": (2, 112),
    "round-step [4, 112, 512]": (4, 112),
    "round-step [8, 112, 512]": (8, 112),
    "cifar100 [4, 22144, 512]": (4, 22144),
    "LM plane [4, 164832, 512]": (4, 164832),
}
MASKED = "main path [20, 416, 512]"     # also timed with 14 of 20 on
# quantize_rows_ef's cases: name -> rows of 512
EF_CASES = {
    "4/16+ef [8320, 512]": 8320,
    "tree payload [960, 512]": 960,
    "a rank's node [416, 512]": 416,
}
HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


def print_plans() -> dict:
    """Each case's launch plan as this tree picks it (no card)."""
    from repro_torch.kernels.opt_update.opt_update import adamw_plan
    from repro_torch.kernels.quantize.quantize import rows_plan
    plans = {}
    for name, (n, r) in ADAMW_CASES.items():
        plans[f"adamw_update {name}"] = asdict(adamw_plan(n, r * COLS, True))
    for name, r in EF_CASES.items():
        plans[f"quantize_rows_ef {name}"] = asdict(rows_plan(r, COLS, True))
    for name, plan in plans.items():
        print(f"{name}: {plan}")
    print(json.dumps({"plans": plans}))
    return plans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.plans:
        print_plans()
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_sweep_ef_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import HBM_BYTES_PER_S, Timer, copy_ms, ulp_diff
    import repro_torch
    from repro_torch.kernels.build import library
    from repro_torch.kernels.opt_update import opt_update as OU
    from repro_torch.kernels.opt_update.ref import adamw_update_ref
    from repro_torch.kernels.quantize.quantize import quantize_rows_ef_cuda
    from repro_torch.kernels.quantize.ref import quantize_rows_ef_ref
    library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: repro_torch from {Path(repro_torch.__file__).parent}"
          f"; {smi}", flush=True)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.zeros(1, device="cuda")
    res = {"launch": timer(lambda: torch.add(one, 1.0, out=one))}
    print(f"one launch (1-element add): {res['launch']:.4f} ms")

    def held(what, ok):
        if not ok:
            raise RuntimeError(f"{what} is not bit-exact with its plain "
                               f"version")

    def case_row(ms, nbytes):
        return dict(ms=ms, copy_ms=copy_ms(torch, timer, nbytes),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)

    lr = torch.full((), 1e-3, device="cuda")
    for name, (n, r) in ADAMW_CASES.items():
        shape = (n, r, COLS)
        g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        p = torch.randn(shape, generator=gen, device="cuda")
        mu = torch.randn(shape, generator=gen, device="cuda") * 1e-4
        nu = torch.rand(shape, generator=gen, device="cuda") * 1e-7
        scale = torch.rand((n,), generator=gen, device="cuda") + 0.1
        step = torch.tensor([3.0 + i % 5 for i in range(n)], device="cuda")
        bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
        masks = {"": None}
        if name == MASKED:
            masks[", 14 of 20 on"] = torch.tensor(
                [i % 3 != 2 for i in range(n)], device="cuda")
        for tag, mask in masks.items():
            kw = {} if mask is None else {"active": mask}
            got = [p.clone(), mu.clone(), nu.clone()]
            OU.adamw_update_cuda(g, *got, lr, scale, bc1, bc2, **HP, **kw)
            want = adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale,
                                    bc1=bc1, bc2=bc2, **HP, **kw)
            held(f"adamw_update {name}{tag}",
                 max(ulp_diff(torch, a, b) for a, b in zip(got, want)) == 0)
            del want
            on = n if mask is None else int(mask.sum())
            row = case_row(timer(lambda: OU.adamw_update_cuda(
                g, *got, lr, scale, bc1, bc2, **HP, **kw)),
                7 * 4 * on * r * COLS)
            res[f"adamw_update {name}{tag}"] = row
            print(f"adamw_update {name}{tag}: {row}", flush=True)
            del got
        del g, p, mu, nu
        torch.cuda.empty_cache()
    for name, r in EF_CASES.items():
        x = torch.randn((r, COLS), generator=gen, device="cuda")
        rs = torch.randn((r, COLS), generator=gen, device="cuda") * 0.05
        rd = ((x + rs).abs().amax(dim=1, keepdim=True) / 7.0).contiguous()
        qm = torch.full((r, 1), 7.0, device="cuda")
        dec = torch.ones((), device="cuda")
        c_got, r_got = quantize_rows_ef_cuda(x, rs, rd, qm, 1.0)
        c_want, r_want = quantize_rows_ef_ref(x, rs, rd, qm, dec)
        held(f"quantize_rows_ef {name}",
             torch.equal(c_got, c_want) and ulp_diff(torch, r_got, r_want)
             == 0)
        row = case_row(timer(lambda: quantize_rows_ef_cuda(x, rs, rd, qm,
                                                           1.0)),
                       16 * r * COLS + 8 * r)
        res[f"quantize_rows_ef {name}"] = row
        print(f"quantize_rows_ef {name}: {row}", flush=True)
    print(smi)
    print(json.dumps({"label": args.label, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
