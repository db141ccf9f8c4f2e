"""Serving launcher: batched autoregressive decoding with a KV cache (or
a constant recurrent state) for any assigned architecture.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        [--full-config] [--batch 4] [--prompt-len 16] [--tokens 32] \
        [--rolling] [--layers N] [--device cpu] [--seed 0]

Runs on the card unless ``--device cpu`` is given (and raises with no
card).  Without ``--full-config`` the reduced (smoke) config runs.  As
in the JAX package's launcher, the prompt is fed a token a step into a
fixed cache of ``prompt_len + tokens`` slots (``sliding_window_serve``
with ``--rolling``), then each step's argmax is the next token.  The
weights are random, drawn on the device from ``--seed``; the frontends
of the audio and VLM families are stubs (zero embeddings).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.config.base import ModelConfig
from repro_torch.core.profe import resolve_device
from repro_torch.models import build_memory, decode_step, init_cache, \
    init_params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The prompt tokens (from ``seed``) and the stubbed frontend
    embeddings of one request batch."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len))).to(device)}
    if cfg.family == "vlm":
        out["image_embed"] = torch.zeros(
            (batch, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.family == "audio":
        out["audio_embed"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    return out


@torch.inference_mode()
def serve(cfg: ModelConfig, params, req: Dict[str, torch.Tensor], *,
          tokens: int, rolling: bool = False) -> Dict[str, Any]:
    """Decode ``tokens`` new tokens after the prompt ``req["tokens"]``.

    Returns the generated tokens ``[B, tokens]`` and the host-clock
    times (the device synchronized): ``memory_ms`` (the encoder or
    image projection), ``first_step_ms`` (one-off library set-up
    included), ``step_ms`` (the mean of every later step) and
    ``tokens_per_s`` (``B`` tokens a step at ``step_ms``)."""
    prompt = req["tokens"]
    b, prompt_len = prompt.shape
    device = prompt.device
    total = prompt_len + tokens
    cache_len = cfg.sliding_window_serve if rolling else total
    cache = init_cache(cfg, b, cache_len, torch.bfloat16, device)
    t0 = time.perf_counter()
    memory = build_memory(cfg, params, req)
    _sync(device)
    t1 = time.perf_counter()
    tok = prompt[:, :1]
    generated = []
    stamps = []
    for i in range(total - 1):
        logits, cache = decode_step(cfg, params, tok, i, cache, memory,
                                    rolling=rolling)
        if i + 1 < prompt_len:
            tok = prompt[:, i + 1:i + 2]
        else:
            tok = torch.argmax(logits, dim=-1)[:, None]
            generated.append(tok)
        if i == 0:
            _sync(device)
            stamps.append(time.perf_counter())
    _sync(device)
    t2 = time.perf_counter()
    steps = total - 2
    step_ms = (t2 - stamps[0]) * 1e3 / steps if steps else float("nan")
    return {"generated": torch.cat(generated, dim=1),
            "last_logits": logits,
            "memory_ms": (t1 - t0) * 1e3,
            "first_step_ms": (stamps[0] - t1) * 1e3,
            "step_ms": step_ms,
            "tokens_per_s": b * 1e3 / step_ms}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--rolling", action="store_true",
                    help="sliding-window KV (the long_500k serving path)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a config "
                         "whose full depth does not fit the card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.prompt_len < 1 or args.tokens < 1:
        ap.error("--prompt-len and --tokens must be at least 1")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the launcher; returns :func:`serve`'s result with the config,
    the parameters and the request batch beside it."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    print(f"serving {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"family={cfg.family} subquadratic={cfg.subquadratic} "
          f"on {device}", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    _sync(device)
    init_s = time.perf_counter() - t0
    req = serve_batch(cfg, args.batch, args.prompt_len, args.seed, device)
    out = serve(cfg, params, req, tokens=args.tokens, rolling=args.rolling)
    print(f"decoded {args.tokens} tokens x batch {args.batch} after a "
          f"{args.prompt_len}-token prompt: {out['step_ms']:.3f} ms a decode "
          f"step, {out['tokens_per_s']:.1f} tokens/s on {device} (first "
          f"step {out['first_step_ms']:.1f} ms, memory "
          f"{out['memory_ms']:.1f} ms, init {init_s:.1f} s)", flush=True)
    return dict(out, cfg=cfg, params=params, req=req, init_s=init_s)


if __name__ == "__main__":
    main()
