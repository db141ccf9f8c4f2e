#!/usr/bin/env python3
"""Where a ProFe training step's time goes when the PyTorch port trains
an LM on the card: host time a step, device-busy time a step, the
device's idle share, device activities a step and the activities with
the most time; and, with ``--stubs``, the teacher's gradient on zero
against normal frontend stubs.

    python3 benchmarks/torch_train_profile.py [--steps 3] [--arch NAME] \
        [--stubs]

Each run trains the full-width config as ``chip_smoke.py``'s train phase
does (``repro_torch.launch.train``: one node, batch 4 × 256, remat on,
frontend stubs normal(0.02); yi-6b cut to 2 of its 32 layers): 2 steps
of warm-up, then ``--steps`` steps timed on the host clock
(synchronized; ``train`` times the steps alone) and the same number
under ``torch.profiler`` (CPU and CUDA activities; the batches made
before the steps add host events only).  The idle share is
``1 - busy / unprofiled host time``.  ``--stubs`` takes one teacher
backward of whisper-small at full width (one step's batch) with zero
audio stubs and with normal(0.02) ones, at 2 and at 12 encoder
layers, and reports the non-finite gradient leaves and the largest
gradient.  One JSON line a run, beside
the card's ``nvidia-smi`` name and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
CONFIGS = {"mamba2-130m": None, "whisper-small": None, "yi-6b": 2}
BATCH, SEQ, WARM, SCALE = 4, 256, 2, 0.02
TOP = 8


def profile_steps(torch, arch: str, layers, steps: int, smi: str) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.launch import train as launch_train

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    state = launch_train.train_state(cfg, device="cuda")

    def run(n: int) -> dict:
        """``n`` steps; their mean host ms (``train`` times the steps
        alone, the batches made before) and the peak memory."""
        out = launch_train.train(cfg, state, steps=n, batch=BATCH, seq=SEQ,
                                 frontend_scale=SCALE, verbose=False)
        if not all(math.isfinite(x) for x in out["loss_s"] + out["loss_t"]):
            raise RuntimeError(f"{arch}: non-finite losses")
        later = out["step_ms"] * (n - 1) if n > 1 else 0.0
        return {"ms": (out["first_step_ms"] + later) / n,
                "peak": out["peak_bytes"]}

    run(WARM)
    timed = run(steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = run(steps)
    host_ms, prof_ms, peak = timed["ms"], profiled["ms"], timed["peak"]

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
            "batch": BATCH, "seq": SEQ, "steps": steps,
            "host_ms_per_step": host_ms,
            "host_ms_per_step_profiled": prof_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / host_ms,
            "device_activities_per_step":
                sum(c for c, _ in by_name.values()) / steps,
            "peak_bytes": peak,
            "top_device_activities": [
                {"name": n[:120], "calls_per_step": c / steps,
                 "device_ms_per_step": us / 1e3 / steps}
                for n, (c, us) in top],
            "card": smi}


def stub_gradients(torch, encoder_layers: int, scale: float,
                   smi: str) -> dict:
    """One teacher backward (Eq. 9, remat on) of whisper-small at full
    width with ``encoder_layers`` encoder layers and frontend stubs of
    ``scale`` (0: zeros)."""
    from repro_torch.config import get_config
    from repro_torch.core.profe import teacher_loss
    from repro_torch.launch.train import token_batches
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map, tree_paths

    cfg = get_config("whisper-small").replace(encoder_layers=encoder_layers)
    params = tree_map(lambda x: x.requires_grad_(True), init_params(
        cfg, torch.Generator("cuda").manual_seed(0)))
    batch = {k: v[0] for k, v in token_batches(
        cfg, 1, BATCH, SEQ, "cuda", frontend_scale=scale)[0].items()}
    protos = torch.zeros((cfg.n_proto_classes, cfg.proto_dim), device="cuda")
    mask = torch.zeros((cfg.n_proto_classes,), device="cuda")
    loss, _ = teacher_loss(cfg, params, batch, protos, mask, 1.0)
    paths, leaves = zip(*tree_paths(params))
    grads = torch.autograd.grad(loss, leaves)
    bad = ["/".join(map(str, p)) for p, g in zip(paths, grads)
           if not bool(torch.isfinite(g).all())]
    finite = [float(g.float().abs().max()) for g in grads
              if bool(torch.isfinite(g).all())]
    return {"arch": "whisper-small", "encoder_layers": encoder_layers,
            "frontend_scale": scale, "loss": float(loss.detach()),
            "nonfinite_leaves": len(bad), "of": len(grads),
            "first_nonfinite": bad[:3],
            "largest_finite_grad": max(finite, default=None), "card": smi}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--arch", choices=sorted(CONFIGS), action="append")
    ap.add_argument("--stubs", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.profe import resolve_device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    if args.stubs:
        for layers in (2, 12):
            for scale in (0.0, SCALE):
                line = stub_gradients(torch, layers, scale, smi)
                print("stub grads: " + json.dumps(line), flush=True)
                torch.cuda.empty_cache()
    for arch in args.arch or CONFIGS:
        line = profile_steps(torch, arch, CONFIGS[arch], args.steps, smi)
        print("train profile: " + json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
