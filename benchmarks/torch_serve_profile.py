#!/usr/bin/env python3
"""Where a decode step's time goes when the PyTorch port serves an LM on
the card: host time a step, device-busy time a step, the device's idle
share, device activities (kernels, copies, fills) a step and the
activities with the most time.

    python3 benchmarks/torch_serve_profile.py [--steps 8] [--arch NAME]

Each run serves the full-width config as ``chip_smoke.py``'s serve phase
does (batch 4, bf16 activations and cache, fp32 weights drawn on the
card; llama4-scout cut to 2 of its 48 layers): a 16-token prompt fed a
token a step, 3 steps more as warm-up, then ``--steps`` decode steps
timed on the host clock (synchronized) and the same number under
``torch.profiler`` (CPU and CUDA activities).  The idle share is
``1 - busy / unprofiled host time`` (the profiler's own host overhead
inflates the profiled time).  One JSON line a config, beside the card's
``nvidia-smi`` name and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
CONFIGS = {"yi-6b": None, "mamba2-130m": None, "whisper-small": None,
           "llama4-scout-17b-a16e": 2}
BATCH, PROMPT, WARM = 4, 16, 3
TOP = 8


def profile_decode(torch, arch: str, layers, steps: int, smi: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import (build_memory, decode_step, init_cache,
                                    init_params)

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    req = serve_batch(cfg, BATCH, PROMPT, 0, torch.device("cuda"))
    total = PROMPT + WARM + 2 * steps
    cache = init_cache(cfg, BATCH, total, torch.bfloat16, "cuda")
    pos, tok = 0, req["tokens"][:, :1]

    def run(n: int):
        nonlocal cache, pos, tok
        for _ in range(n):
            logits, cache = decode_step(cfg, params, tok, pos, cache, memory)
            tok = (req["tokens"][:, pos + 1:pos + 2] if pos + 1 < PROMPT
                   else torch.argmax(logits, dim=-1)[:, None])
            pos += 1
        torch.cuda.synchronize()

    with torch.inference_mode():
        memory = build_memory(cfg, params, req)
        run(PROMPT + WARM)
        t0 = time.perf_counter()
        run(steps)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(steps)
            prof_ms = (time.perf_counter() - t0) * 1e3 / steps

    by_name: dict = {}
    busy_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        calls, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, tot + us)
    if busy_us <= 0:
        raise RuntimeError("the profiler saw no device activity")
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)[:TOP]
    busy_ms = busy_us / 1e3 / steps
    return {"arch": arch, "layers": cfg.num_layers,
            "reduced": None if layers is None else
            f"{layers} of {get_config(arch).num_layers} layers",
            "batch": BATCH, "steps": steps,
            "host_ms_per_step": host_ms,
            "host_ms_per_step_profiled": prof_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / host_ms,
            "device_activities_per_step":
                sum(c for c, _ in by_name.values()) / steps,
            "top_device_activities": [
                {"name": n[:120], "calls_per_step": c / steps,
                 "device_ms_per_step": us / 1e3 / steps}
                for n, (c, us) in top],
            "card": smi}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--arch", choices=sorted(CONFIGS), action="append")
    args = ap.parse_args()
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.profe import resolve_device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    for arch in args.arch or CONFIGS:
        line = profile_decode(torch, arch, CONFIGS[arch], args.steps, smi)
        print("decode profile: " + json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
