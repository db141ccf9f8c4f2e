#!/usr/bin/env python3
"""Times of the port's ``quantize_rows_mixed`` and ``kd_loss`` on the card,
beside one launch, a same-byte ``copy_`` and (for the mixed codes) the
uniform-width row codec on the same rows.

    python3 benchmarks/torch_mixed_kd_phases.py [--src DIR] [--label L]

Needs one CUDA card (exits 2 without one).  Imports ``repro_torch`` from
``--src`` (default: this checkout's ``src/``), so one call can time two
trees of the port in turns (before, after, after, before); its kernels
are built into that tree's own ``build/``.  Only the wrappers are called,
so any tree of the port since both kernels were ported can be timed.
Times with ``chip_smoke.py``'s ``Timer`` (median of 50 launches, L2
flushed, the card kept busy):

* ``quantize_rows_mixed`` on the ``4/16`` path's payload (``[20·416,
  512]``: ``chip_smoke.payload_buffer`` with its Δ and qmax from
  ``chip_smoke.mixed_rows``), and on seeded random ``[20·416, 512]`` rows
  with the same row widths and each row's absmax over its qmax as Δ;
  beside ``quantize_rows`` (16 bits) on the same rows and Δ;
* ``kd_loss_rows`` at every ``chip_smoke.KD_CASES`` shape (the ProFe KD
  term ``[320, 10]`` fp32, llama4-scout's vocabulary ``[256, 202048]``
  bf16 and fp32, a ragged ``[250, 50280]`` bf16, 16 rows of 202,048 bf16
  in the split regime), at T = 1 and 3, on ``chip_smoke.kd_logits``;
* one launch (a one-element add), and for each case a ``copy_`` that
  moves the bytes its bound counts (half read, half written).

Each result is held to its plain version first (the codes bit for bit,
the KD loss within ``chip_smoke.kd_tol``).  Each case's data time is its
time less one launch.  Prints each time, the card's ``nvidia-smi`` name
and power limit, and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_ROWS = 20 * 416        # the main path's packed payload, N = 20
COLS = 512


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_mixed_kd_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (KD_CASES, Timer, bits_equal, bound, copy_ms,
                            expect, kd_logits, kd_tol, mixed_rows,
                            payload_buffer)
    import repro_torch
    from repro_torch.config import get_config
    from repro_torch.kernels.build import library
    from repro_torch.kernels.kd_loss import kd_loss as KD
    from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref
    from repro_torch.kernels.quantize import quantize as Q
    from repro_torch.kernels.quantize import ref as R
    from repro_torch.models import derive_student
    library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{args.label}: repro_torch from {Path(repro_torch.__file__).parent}"
          f"; {smi}")
    timer = Timer(torch)
    res = {}

    one = torch.zeros(1, device="cuda")
    launch_ms = timer(lambda: torch.add(one, 1.0, out=one))
    res["launch"] = dict(ms=launch_ms)
    print(f"one launch (1-element add): {launch_ms:.4f} ms")

    def record(name, fn, nbytes, nops, **extra):
        ms = timer(fn)
        c_ms = copy_ms(torch, timer, nbytes)
        b_ms, b_by = bound(nbytes, nops)
        res[name] = dict(ms=ms, data_ms=ms - launch_ms, bytes=nbytes,
                         bound_ms=b_ms, bound_by=b_by, copy_ms=c_ms,
                         tb_s=nbytes / max(ms - launch_ms, 1e-6) / 1e9,
                         **extra)
        print(f"{name}: {ms:.4f} ms (data {ms - launch_ms:.4f} beyond one "
              f"launch, {res[name]['tb_s']:.2f} TB/s); same-byte copy_ "
              f"{c_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
              f"{nbytes / 1e6:.3f} MB")

    # -- quantize_rows_mixed and quantize_rows on the same rows ------------
    buf, seg_ids, _, plane, protos = payload_buffer(
        torch, torch.Generator().manual_seed(0),
        derive_student(get_config("mnist-cnn")))
    px = buf.reshape(MAIN_ROWS, COLS).contiguous()
    prd, qm = mixed_rows(torch, buf, seg_ids, plane, protos)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((MAIN_ROWS, COLS), generator=gen, device="cuda")
    rd = (x.abs().amax(1, keepdim=True) / qm).contiguous()
    for what, t, d in (("the 4/16 path's payload", px, prd),
                       ("random rows", x, rd)):
        expect(bits_equal(torch, Q.quantize_rows_mixed_cuda(t, d, qm),
                          R.quantize_rows_mixed_ref(t, d, qm)),
               f"quantize_rows_mixed is not bit-exact at {what}")
        expect(bits_equal(torch, Q.quantize_rows_cuda(t, d, bits=16),
                          R.quantize_rows_ref(t, d, bits=16)),
               f"quantize_rows is not bit-exact at {what}")
        n = t.numel()
        record(f"quantize_rows_mixed [{MAIN_ROWS}, {COLS}] {what}",
               lambda: Q.quantize_rows_mixed_cuda(t, d, qm),
               8 * n + 8 * MAIN_ROWS, 5 * n)
        record(f"quantize_rows (16 bits) [{MAIN_ROWS}, {COLS}] {what}",
               lambda: Q.quantize_rows_cuda(t, d, bits=16),
               8 * n + 4 * MAIN_ROWS, 4 * n)

    # -- kd_loss at KD_CASES ----------------------------------------------
    plan_of = getattr(KD, "kd_plan", None)
    for what, r, v, dtype, temp in KD_CASES:
        ys, yt = kd_logits(torch, gen, r, v, dtype)
        got = KD.kd_loss_rows_cuda(ys, yt, temp)
        want = kd_loss_rows_ref(ys, yt, temp)
        ymax = max(float(ys.float().abs().max()),
                   float(yt.float().abs().max()))
        err = float((got - want).abs().max())
        expect(err <= kd_tol(ymax, temp) and bool(torch.isfinite(got).all()),
               f"kd_loss {what} [{r}, {v}] {dtype} T={temp}: error {err:.3e}")
        plan = (str(plan_of(r, v, ys.element_size(), True,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count))
                if plan_of else "one block a row")
        record(f"kd_loss {what} [{r}, {v}] {dtype} T={temp}",
               lambda: KD.kd_loss_rows_cuda(ys, yt, temp),
               2 * ys.element_size() * r * v + 4 * r, 11 * r * v,
               max_abs_err=err, tol=kd_tol(ymax, temp), plan=plan)
        del ys, yt, got, want
    print(smi)
    print(json.dumps({"label": args.label, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
