#!/usr/bin/env python3
"""Times of the port's row codec (``quantize_rows``,
``quantize_dequantize_rows``, ``dequantize_rows``) and of the scalar-Δ
``dequantize`` on the card, split into launch and data time.

    python3 benchmarks/torch_row_codec_phases.py [--src DIR] [--label L]

Needs one CUDA card (exits 2 without one).  Imports ``repro_torch`` from
``--src`` (default: this checkout's ``src/``), so one call can time two
trees of the port in turns (before, after, after, before); its kernels
are built into that tree's own ``build/``.  Times with
``chip_smoke.py``'s ``Timer`` (median of 50 launches, L2 flushed, the
card kept busy) through the wrappers, at the paths' shapes, on seeded
random fp32 rows whose Δ is each row's absmax over 32767:

* ``quantize_rows`` on ``[20·416, 512]`` (the main path's packed
  payload), beside ``torch.quantize_per_channel`` (``qint32``); and
  again with 80 rows zero at the least normal Δ (as the payload's empty
  rows are), with the last 12 columns of each row zero (the payload's
  share of zero padding lanes), and on the main path's own payload
  (``chip_smoke.payload_buffer``, the data phase 3 times);
* ``quantize_dequantize_rows`` on the mnist-cnn per-leaf payload as
  phase 3 makes it (``chip_smoke.codec_payload``, ``pack_tree``);
* ``quantize_dequantize_rows`` on ``[8240, 512]`` (the mnist-cnn
  per-leaf payload), beside ``torch.fake_quantize_per_channel_affine``;
* ``dequantize_rows`` on its codes, beside ``torch.mul(codes, Δ)``;
* ``dequantize`` on the ResNet18 teacher leaf's ``[3, 3, 512, 512]``
  codes at a 0-d Δ on the card, beside ``torch.mul(codes, Δ)``;
* one launch (a one-element add), and for each case a ``copy_`` that
  moves the bytes its bound counts (half read, half written).

Each result is held bit for bit to its plain version first.  Each
case's data time is its time less one launch.  Prints each time, the
card's ``nvidia-smi`` name and power limit, and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_ROWS = 20 * 416        # the main path's packed payload, N = 20
LEAF_ROWS = 8240            # the mnist-cnn per-leaf payload, N = 20
COLS = 512
TEACHER = (3, 3, 512, 512)  # the ResNet18 teacher's largest leaf


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("torch_row_codec_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (HBM_BYTES_PER_S, Timer, bits_equal,
                            codec_payload, expect, payload_buffer)
    from repro_torch.config import get_config
    from repro_torch.kernels.build import library
    from repro_torch.kernels.quantize.ops import (_node_row_deltas,
                                                  _segment_deltas, pack_tree)
    from repro_torch.models import derive_student
    from repro_torch.kernels.quantize import quantize as Q
    from repro_torch.kernels.quantize import ref as R
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

    def record(name, fn, plain, nbytes, library_fn):
        expect(bits_equal(torch, fn(), plain()),
               f"{name} is not bit-exact with its plain version")
        ms = timer(fn)
        src = torch.empty(nbytes // 8, dtype=torch.float32, device="cuda")
        dst = torch.empty_like(src)
        copy_ms = timer(lambda: dst.copy_(src))
        lib_ms = timer(library_fn) if library_fn else None
        res[name] = dict(ms=ms, data_ms=ms - launch_ms, bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         copy_ms=copy_ms, library_ms=lib_ms)
        print(f"{name}: {ms:.4f} ms (data {ms - launch_ms:.4f} beyond one "
              f"launch); same-byte copy_ {copy_ms:.4f} ms; library "
              f"{lib_ms} ms; {nbytes / 1e6:.2f} MB")

    def rows_input(rows):
        x = torch.randn((rows, COLS), generator=gen, device="cuda")
        rd = (x.abs().amax(1, keepdim=True) / 32767.0).contiguous()
        return (x, rd, rd[:, 0].contiguous(),
                torch.zeros(rows, dtype=torch.int32, device="cuda"))

    x, rd, scales, zero = rows_input(MAIN_ROWS)
    record("quantize_rows", lambda: Q.quantize_rows_cuda(x, rd, bits=16),
           lambda: R.quantize_rows_ref(x, rd, bits=16),
           8 * x.numel() + 4 * MAIN_ROWS,
           lambda: torch.quantize_per_channel(x, scales, zero.long(), 0,
                                              torch.qint32))

    # the main path's payload has 80 empty rows (Δ clamped to the least
    # normal float) and 2.3 % zero elements (padding lanes)
    tiny = torch.finfo(torch.float32).tiny
    xz, rdz = x.clone(), rd.clone()
    xz[::MAIN_ROWS // 80] = 0.0
    rdz[::MAIN_ROWS // 80] = tiny
    record("quantize_rows, 80 empty rows at the least normal Δ",
           lambda: Q.quantize_rows_cuda(xz, rdz, bits=16),
           lambda: R.quantize_rows_ref(xz, rdz, bits=16),
           8 * x.numel() + 4 * MAIN_ROWS, None)
    xz = x.clone()
    xz[:, -12:] = 0.0
    record("quantize_rows, 12 zero columns a row",
           lambda: Q.quantize_rows_cuda(xz, rd, bits=16),
           lambda: R.quantize_rows_ref(xz, rd, bits=16),
           8 * x.numel() + 4 * MAIN_ROWS, None)

    # the paths' own payloads, as phase 3 of chip_smoke.py makes them
    buf, seg_ids, meta, _, _ = payload_buffer(
        torch, torch.Generator().manual_seed(0),
        derive_student(get_config("mnist-cnn")))
    px = buf.reshape(MAIN_ROWS, COLS).contiguous()
    _, prd = _node_row_deltas(buf, seg_ids, meta[1], 16, meta[3])
    prd = prd.reshape(-1, 1).contiguous()
    record("quantize_rows at the main path's payload",
           lambda: Q.quantize_rows_cuda(px, prd, bits=16),
           lambda: R.quantize_rows_ref(px, prd, bits=16),
           8 * px.numel() + 4 * MAIN_ROWS, None)
    lx, seg_ids, meta = pack_tree(codec_payload(torch, "mnist-cnn", 3),
                                  node_axis=True)
    _, lrd = _segment_deltas(lx, seg_ids, meta[1], 16)
    lrd = lrd.contiguous()
    record("quantize_dequantize_rows at the per-leaf payload",
           lambda: Q.quantize_dequantize_rows_cuda(lx, lrd, bits=16),
           lambda: R.quantize_dequantize_rows_ref(lx, lrd, bits=16),
           8 * lx.numel() + 4 * LEAF_ROWS, None)

    x, rd, scales, zero = rows_input(LEAF_ROWS)
    record("quantize_dequantize_rows",
           lambda: Q.quantize_dequantize_rows_cuda(x, rd, bits=16),
           lambda: R.quantize_dequantize_rows_ref(x, rd, bits=16),
           8 * x.numel() + 4 * LEAF_ROWS,
           lambda: torch.fake_quantize_per_channel_affine(
               x, scales, zero, 0, -32768, 32767))
    codes = R.quantize_rows_ref(x, rd, bits=16)
    record("dequantize_rows", lambda: Q.dequantize_rows_cuda(codes, rd),
           lambda: R.dequantize_rows_ref(codes, rd),
           8 * codes.numel() + 4 * LEAF_ROWS,
           lambda: torch.mul(codes, rd))

    leaf = torch.randn(TEACHER, generator=gen, device="cuda")
    delta = (leaf.abs().amax() / 32767.0).reshape(())
    tcodes = R.quantize_rows_ref(leaf.reshape(1, -1), delta.reshape(1, 1),
                                 bits=16).reshape(TEACHER)
    record("dequantize", lambda: Q.dequantize_cuda(tcodes, delta),
           lambda: R.dequantize_ref(tcodes, delta),
           8 * tcodes.numel() + 4, lambda: torch.mul(tcodes, delta))
    print(smi)
    print(json.dumps({"label": args.label, "device": smi, "results": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
