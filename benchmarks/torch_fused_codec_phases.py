#!/usr/bin/env python3
"""Where the time of the port's whole-tensor codec goes, on the card.

    python3 benchmarks/torch_fused_codec_phases.py

Needs one CUDA card (exits 2 without one).  Times ``fused_quantize`` and
``fused_quantize_dequantize`` (one cooperative launch each, x staged in
shared memory) with ``chip_smoke.py``'s ``Timer`` (median of 50 launches,
L2 flushed, the card kept busy) at the ResNet18 teacher's
``[3, 3, 512, 512]`` leaf: through the wrappers at the plan they pick
(two blocks an SM), and through the C entry points at plans of its own:
the grid cut to one block an SM, nothing staged (x read twice), and 4
elements a block at grids of 1, one and two blocks an SM (the launch and
the grid sync alone); and through the wrappers at mnist-cnn's fc1,
conv2 and fc2-bias leaves (``[1568, 128]``, ``[3, 3, 16, 32]``,
``[10]``).  Beside them, the floor of one launch (a one-element add)
and a same-size ``copy_`` (x read once and written once).  Then it
counts the device operations of one call of each under
``torch.profiler``, with their device time (it fails unless that is one
kernel and no memset), and those of the copy and the add; and the host
time a call takes to enqueue, through the wrapper and through the C
entry point alone.  Prints each time, the card's ``nvidia-smi`` name and
power limit, and one JSON object last.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import asdict, replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STUDENT_LEAVES = ((1568, 128), (3, 3, 16, 32), (10,))


def device_ops(torch, fn):
    """``[name, device µs]`` of each device operation one call of ``fn``
    runs, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.name, e.time_range.elapsed_us()] for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def host_us(torch, fn, reps: int = 200) -> float:
    """Host microseconds a call takes to enqueue (no synchronize inside
    the loop; the kernel is shorter than the host's work for it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fused_codec_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import Timer, teacher_leaf
    from repro_torch.kernels.build import check, library, stream_of
    from repro_torch.kernels.quantize.quantize import (
        FusedPlan, fused_plan, fused_quantize_cuda,
        fused_quantize_dequantize_cuda)
    lib = library()
    timer = Timer(torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = {"fused_quantize": fused_quantize_cuda,
               "fused_quantize_dequantize": fused_quantize_dequantize_cuda}
    out_dtype = {"fused_quantize": torch.int32,
                 "fused_quantize_dequantize": torch.float32}

    x = teacher_leaf(torch)
    n = x.numel()
    res = {}

    def record(label, name, ms, plan):
        res[f"{name} {label}"] = dict(ms=ms, plan=dict(
            asdict(plan), smem=plan.smem, staged=plan.staged))
        print(f"{name} {label}: {ms:.4f} ms (grid {plan.grid}, stage "
              f"{plan.stage}, {plan.staged} of {plan.n} staged)")

    def time_wrappers(label, t):
        """The wrappers, at the plan they pick."""
        plan = fused_plan(t.numel(), t.data_ptr() // 4 % 4, sms)
        for name, fn in kernels.items():
            record(label, name, timer(lambda: fn(t, bits=16)), plan)

    def time_plan(label, t, plan):
        """The C entry points at a plan of the benchmark's own, on
        buffers made once (the launcher checks the plan)."""
        for name in kernels:
            out = torch.empty(t.shape, dtype=out_dtype[name], device="cuda")
            delta = torch.empty((), device="cuda")
            partials = torch.empty((plan.grid,), device="cuda")
            args = (t.data_ptr(), out.data_ptr(), delta.data_ptr(),
                    partials.data_ptr(), t.numel(), 32767.0, plan.grid,
                    plan.span, plan.stage, stream_of(t))
            fn = getattr(lib, name)
            check(fn(*args), name)
            record(label, name, timer(lambda: fn(*args)), plan)

    plan = fused_plan(n, 0, sms)
    time_wrappers("teacher default", x)
    # one block an SM: the span doubles, and still fits shared memory
    per_block = -(-n // sms)
    span1 = -(-per_block // 4) * 4
    time_plan("teacher 1/SM", x, FusedPlan(n, 0, -(-n // span1), span1,
                                           span1))
    # nothing staged: every block streams its span and reads it again
    # after the grid sync (from L2, which holds the 9.44 MB)
    time_plan("teacher stage 0", x, replace(plan, stage=0))
    # the barrier alone: 4 elements a block, one bulk chunk of 16 bytes
    for grid in (1, sms, 2 * sms):
        t = torch.randn(4 * grid, generator=torch.Generator().manual_seed(2)
                        ).cuda()
        time_plan(f"4 elements a block, grid {grid}", t,
                  FusedPlan(4 * grid, 0, grid, 4, 4))
    for shape in STUDENT_LEAVES:
        t = torch.randn(shape, generator=torch.Generator().manual_seed(1)
                        ).cuda()
        time_wrappers(f"mnist-cnn {list(shape)}", t)
    one = torch.zeros(1, device="cuda")
    res["one launch (1-element add)"] = dict(ms=timer(lambda: one.add_(1)))
    y = torch.empty_like(x)
    res["teacher copy_"] = dict(ms=timer(lambda: y.copy_(x)))
    for label in ("one launch (1-element add)", "teacher copy_"):
        print(f"{label}: {res[label]['ms']:.4f} ms")

    host = {"fused_plan": host_us(torch, lambda: fused_plan(n, 0, sms))}
    for name, fn in kernels.items():
        host[name] = host_us(torch, lambda: fn(x, bits=16))
    # the C entry point alone (its plan checks, the cached co-residency
    # limit, the launch), on buffers made once
    codes = torch.empty(x.shape, dtype=torch.int32, device="cuda")
    delta = torch.empty((), device="cuda")
    partials = torch.empty((plan.grid,), device="cuda")
    args = (x.data_ptr(), codes.data_ptr(), delta.data_ptr(),
            partials.data_ptr(), n, 32767.0, plan.grid, plan.span,
            plan.stage, stream_of(x))
    host["fused_quantize, the C call alone"] = host_us(
        torch, lambda: lib.fused_quantize(*args))
    for label, us in host.items():
        print(f"host time a call, {label}: {us:.1f} µs")
    res["host_us"] = host
    ops = {name: device_ops(torch, lambda: fn(x, bits=16))
           for name, fn in kernels.items()}
    for name, names in ops.items():
        print(f"{name}: device operations of one call: {names}")
        if len(names) != 1 or any("emset" in s for s, _ in names):
            raise RuntimeError(f"{name}: one call ran {names}, not one "
                               f"kernel")
    ops["teacher copy_"] = device_ops(torch, lambda: y.copy_(x))
    ops["one launch (1-element add)"] = device_ops(torch,
                                                   lambda: one.add_(1))
    for label in ("teacher copy_", "one launch (1-element add)"):
        print(f"{label}: device operations {ops[label]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"card": smi, "sms": sms, "times": res,
                      "device_ops": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
