#!/usr/bin/env python3
"""Times of the port's ``mix_packed`` and ``adafactor_apply`` on the card,
split into launch and data time.

    python3 benchmarks/torch_mix_adafactor_phases.py [--src DIR] [--label L]
                                                     [--plans]

Needs one CUDA card (exits 2 without one).  Imports ``repro_torch`` from
``--src`` (default: this checkout's ``src/``), so one call can time two
trees of the port in turns (before, after, after, before); its kernels
are built into that tree's own ``build/``.  Times with
``chip_smoke.py``'s ``Timer`` (median of 50 launches, L2 flushed, the
card kept busy) through the wrappers:

* ``mix_packed`` at the mesh paths' R = 416 rows of 512, random int32
  codes: the ring (own ``[1, R, 512]``, 2 senders), full-packed (1
  receiver, 8 senders, ``w_self`` 0), one rank of 8 nodes (8×8) and the
  accumulate form (1 sender at weight one);
* ``adafactor_apply`` on ``[20, 208, 512]`` fp32 (the CIFAR paths'
  student planes), beside ``torch._fused_sgd_`` (momentum 0: the same
  function) and ``torch.add(p, upd, out=p)`` (the same bytes, one
  launch);
* one launch (a one-element add), and for each case a ``copy_`` that
  moves the bytes its bound counts (half read, half written).

Each case's data time is its time less one launch.  With ``--plans``
(a tree that has ``mix_plan``) it also times the mix cases through the C
entry point at other launch plans than the wrapper's: receiver groups of
8, 4, 2 and 1, and blocks of 128 threads on one row, 64 on each of 2
rows, 32 on each of 4.  Prints each time,
the card's ``nvidia-smi`` name and power limit, and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS, COLS = 416, 512
N_NODES = 20
PLANE_ROWS = 208


def time_plans(torch, timer, cases, res):
    """The mix cases through the C entry point at plans of the
    benchmark's own (the launcher checks each)."""
    from repro_torch.kernels.build import check, library, stream_of
    from repro_torch.kernels.quantize.quantize import MixPlan, mix_plan
    lib = library()
    for name, (o, c, d, ws, wr) in cases.items():
        m, s = o.shape[0], c.shape[0]
        out = torch.empty_like(o)
        base = mix_plan(m, s, ROWS, COLS, True)
        for group in (8, 4, 2, 1):
            if group > base.group:
                continue
            for bx, by in ((128, 1), (64, 2), (32, 4)):
                plan = MixPlan(group, 4, (bx, by),
                               (COLS // 4 // bx, -(-ROWS // by),
                                -(-m // group)))

                def call(plan=plan):
                    check(lib.mix_packed(
                        o.data_ptr(), c.data_ptr(), d.data_ptr(),
                        ws.data_ptr(), wr.data_ptr(), out.data_ptr(), m, s,
                        ROWS, COLS, 0, plan.group, plan.vec, *plan.block,
                        *plan.grid, stream_of(o)), "mix_packed")
                ms = timer(call)
                res[f"{name} group {group} block {bx}x{by}"] = dict(ms=ms)
                print(f"{name} at group {group}, block {bx}x{by}: "
                      f"{ms:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_mix_adafactor_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import HBM_BYTES_PER_S, Timer
    from repro_torch.kernels.build import library
    from repro_torch.kernels.opt_update.opt_update import \
        adafactor_apply_cuda
    from repro_torch.kernels.quantize.quantize import mix_packed_cuda
    import repro_torch
    library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: repro_torch from {Path(repro_torch.__file__).parent}"
          f"; {smi}")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}

    one = torch.zeros(1, device="cuda")
    launch_ms = timer(lambda: torch.add(one, 1.0, out=one))
    res["launch"] = dict(ms=launch_ms)
    print(f"one launch (1-element add): {launch_ms:.4f} ms")

    def record(name, ms, nbytes):
        src = torch.empty(nbytes // 8, dtype=torch.float32, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = timer(lambda: dst.copy_(src))
        res[name] = dict(ms=ms, data_ms=ms - launch_ms, bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         copy_ms=copy_ms)
        print(f"{name}: {ms:.4f} ms (data {ms - launch_ms:.4f} beyond one "
              f"launch); same-byte copy_ {copy_ms:.4f} ms; "
              f"{nbytes / 1e6:.2f} MB")

    own = torch.randn((8, ROWS, COLS), generator=gen, device="cuda")
    codes = torch.randint(-32768, 32768, (8, ROWS, COLS), generator=gen,
                          device="cuda", dtype=torch.int32)
    delta = torch.rand((8, ROWS), generator=gen, device="cuda") * 1e-4
    w = torch.rand((8, 9), generator=gen, device="cuda")
    w = w / w.sum(dim=1, keepdim=True)
    w_self, w_rows = w[:, 0].contiguous(), w[:, 1:].contiguous()
    cases = {
        "mix_packed ring": (own[:1], codes[:2], delta[:2], w_self[:1],
                            w_rows[:1, :2].contiguous()),
        "mix_packed full-packed": (own[:1], codes, delta,
                                   torch.zeros(1, device="cuda"),
                                   w_rows[:1].contiguous()),
        "mix_packed 8x8": (own, codes, delta, w_self, w_rows),
        "mix_packed accumulate": (own[:1], codes[:1], delta[:1],
                                  torch.ones(1, device="cuda"),
                                  w_rows[:1, :1].contiguous()),
    }
    for name, (o, c, d, ws, wr) in cases.items():
        ms = timer(lambda: mix_packed_cuda(o, c, d, ws, wr))
        record(name, ms, 4 * (2 * o.numel() + c.numel() + d.numel()
                              + ws.numel() + wr.numel()))
    if args.plans:
        time_plans(torch, timer, cases, res)

    shape = (N_NODES, PLANE_ROWS, COLS)
    upd = torch.randn(shape, generator=gen, device="cuda")
    p = torch.randn(shape, generator=gen, device="cuda")
    lr = torch.full((), 1e-3, device="cuda")
    ms = timer(lambda: adafactor_apply_cuda(upd, p, lr, weight_decay=0.01))
    record("adafactor_apply", ms, 3 * 4 * p.numel())
    res["adafactor_apply"]["stream_ms"] = timer(
        lambda: torch.add(p, upd, out=p))
    res["adafactor_apply"]["library_ms"] = timer(lambda: torch._fused_sgd_(
        [p], [upd], [], weight_decay=0.01, momentum=0.0, lr=1e-3,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False))
    print(f"adafactor_apply yardsticks: torch.add(out=p) "
          f"{res['adafactor_apply']['stream_ms']:.4f} ms, _fused_sgd_ "
          f"{res['adafactor_apply']['library_ms']:.4f} ms")
    print(smi)
    print(json.dumps({"label": args.label, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
