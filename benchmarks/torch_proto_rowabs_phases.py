#!/usr/bin/env python3
"""Times of the port's ``proto_dist`` and row absmax (``rowabs``,
``rowabs_sum``) on the card, beside one launch, a same-byte ``copy_`` and
the library calls.

    python3 benchmarks/torch_proto_rowabs_phases.py [--src DIR] [--label L]

Needs one CUDA card (exits 2 without one).  Imports ``repro_torch`` from
``--src`` (default: this checkout's ``src/``), so one call can time two
trees of the port in turns (before, after, after, before); its kernels
are built into that tree's own ``build/``.  Only the wrappers are called,
so any tree of the port since ``proto_dist`` was ported can be timed.
Times with ``chip_smoke.py``'s ``Timer`` (median of 50 launches, L2
flushed, the card kept busy) at phase 3's shapes, on seeded random
inputs:

* ``proto_dist`` at ``chip_smoke.PD_CASES`` (Eq. 5's ``[640, 128] x
  [10, 128]``, P = 256 at C = 10 and 100, a ragged ``[1001, 200] x [37,
  200]``), fp32 and bf16, beside ``torch.cdist`` (fp32 copies for bf16);
  each held to both plain versions within ``chip_smoke.pd_close`` and to
  the oracle's argmin away from ties;
* ``rowabs`` on ``[20·416, 512]`` random rows and on the main path's
  payload (``chip_smoke.payload_buffer``), beside
  ``torch.linalg.vector_norm(ord=inf)``;
* ``rowabs_sum`` on ``[20·416, 512]`` rows and a residual of half a step,
  at decay 1.0 and 0.9 (no library call adds the residual inside the
  reduction);
* one launch (a one-element add), and for each case a ``copy_`` that
  moves the bytes its bound counts (half read, half written).

``rowabs`` and ``rowabs_sum`` are held bit for bit to their plain
versions first.  Each case's data time is its time less one launch.
Prints each time, the card's ``nvidia-smi`` name and power limit, and one
JSON object last.
"""
from __future__ import annotations

import argparse
import json
import math
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
        print("torch_proto_rowabs_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (HBM_BYTES_PER_S, PD_CASES, Timer, bits_equal,
                            bound, clear_of_ties, copy_ms, expect, pd_close,
                            payload_buffer)
    import repro_torch
    from repro_torch.config import get_config
    from repro_torch.kernels.build import library
    from repro_torch.kernels.proto_dist.proto_dist import proto_dist_cuda
    from repro_torch.kernels.proto_dist.ref import (proto_dist_expand,
                                                    proto_dist_ref)
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}

    one = torch.zeros(1, device="cuda")
    launch_ms = timer(lambda: torch.add(one, 1.0, out=one))
    res["launch"] = dict(ms=launch_ms)
    print(f"one launch (1-element add): {launch_ms:.4f} ms")

    def record(name, fn, nbytes, nops, library_fn):
        ms = timer(fn)
        c_ms = copy_ms(torch, timer, nbytes)
        lib_ms = timer(library_fn) if library_fn else None
        b_ms, b_by = bound(nbytes, nops)
        res[name] = dict(ms=ms, data_ms=ms - launch_ms, bytes=nbytes,
                         bound_ms=b_ms, bound_by=b_by, copy_ms=c_ms,
                         library_ms=lib_ms,
                         tb_s=nbytes / (ms - launch_ms) / 1e9)
        print(f"{name}: {ms:.4f} ms (data {ms - launch_ms:.4f} beyond one "
              f"launch, {res[name]['tb_s']:.2f} TB/s); same-byte copy_ "
              f"{c_ms:.4f} ms; library {lib_ms} ms; bound {b_ms:.4f} ms "
              f"({b_by}); {nbytes / 1e6:.3f} MB")

    for what, n, p_dim, c in PD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((n, p_dim), generator=gen, device="cuda").to(dtype)
            protos = torch.randn((c, p_dim), generator=gen,
                                 device="cuda").to(dtype)
            got = proto_dist_cuda(x, protos)
            direct = proto_dist_ref(x, protos)
            for plain in (proto_dist_expand(x, protos), direct):
                ok, tol = pd_close(torch, got, plain, x, protos)
                expect(ok, f"proto_dist {what} {dtype}: beyond {tol:.3e}")
            clear = clear_of_ties(torch, direct, tol)
            expect(torch.equal(got.argmin(-1)[clear],
                               direct.argmin(-1)[clear]),
                   f"proto_dist {what} {dtype}: argmin differs")
            x32, p32 = x.float(), protos.float()
            record(f"proto_dist {what} [{n}, {p_dim}] x [{c}, {p_dim}] "
                   f"{str(dtype)[6:]}", lambda: proto_dist_cuda(x, protos),
                   x.element_size() * (n + c) * p_dim + 4 * n * c,
                   2 * n * c * p_dim + 2 * (n + c) * p_dim + 4 * n * c,
                   lambda: torch.cdist(x32, p32))

    x = torch.randn((MAIN_ROWS, COLS), generator=gen, device="cuda")
    buf = payload_buffer(torch, torch.Generator().manual_seed(0),
                         derive_student(get_config("mnist-cnn")))[0]
    px = buf.reshape(MAIN_ROWS, COLS).contiguous()
    for what, t in (("random rows", x), ("the main path's payload", px)):
        expect(bits_equal(torch, Q.rowabs_cuda(t), R.rowabs_ref(t)),
               f"rowabs is not bit-exact at {what}")
        record(f"rowabs [{MAIN_ROWS}, {COLS}] {what}",
               lambda: Q.rowabs_cuda(t), 4 * t.numel() + 4 * MAIN_ROWS,
               t.numel(), lambda: torch.linalg.vector_norm(t, ord=math.inf,
                                                           dim=1))
    step = x.abs().amax() / 32767
    resid = (torch.rand(x.shape, generator=gen, device="cuda") - 0.5) * step
    for decay in (1.0, 0.9):
        dec = torch.tensor(decay, dtype=torch.float32, device="cuda")
        expect(bits_equal(torch, Q.rowabs_sum_cuda(x, resid, decay),
                          R.rowabs_sum_ref(x, resid, dec)),
               f"rowabs_sum is not bit-exact at decay {decay}")
        record(f"rowabs_sum [{MAIN_ROWS}, {COLS}] decay {decay}",
               lambda: Q.rowabs_sum_cuda(x, resid, decay),
               8 * x.numel() + 4 * MAIN_ROWS, 4 * x.numel(), None)
    print(f"(HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s in the bound)")
    print(smi)
    print(json.dumps({"label": args.label, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
