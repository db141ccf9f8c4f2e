"""Serving example for the PyTorch port: batched autoregressive decoding
with a KV cache on a reduced assigned architecture — the prompt through
one ``prefill`` into a cache sized for the whole reply, then a token a
step — including the sliding-window path (``--rolling``), whose window
must hold the prompt.

    PYTHONPATH=src python examples/torch_serve_decode.py --arch yi-6b \
        [--tokens 32] [--rolling] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch.config import get_config
from repro_torch.core.profe import resolve_device
from repro_torch.launch.serve import serve_batch
from repro_torch.models import (build_memory, decode_step, init_params,
                                prefill)


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--rolling", action="store_true",
                    help="sliding-window cache (long-context serving path)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    print(f"serving reduced {args.arch}: {cfg.num_layers}L d={cfg.d_model} "
          f"family={cfg.family} on {device}")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    req = serve_batch(cfg, args.batch, args.prompt_len, 0, device)

    total = args.prompt_len + args.tokens
    cache_len = cfg.sliding_window_serve if args.rolling else total
    memory = build_memory(cfg, params, req)

    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, req, cache_len=cache_len)
    generated = []
    for i in range(args.prompt_len, total):
        tok = torch.argmax(logits, dim=-1)[:, None]
        generated.append(tok)
        if i + 1 < total:
            logits, cache = decode_step(cfg, params, tok, i, cache, memory,
                                        rolling=args.rolling)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gen = torch.cat(generated, dim=1)
    print(f"generated {gen.shape[1]} tokens x{args.batch} in {dt:.2f} s "
          f"on {device}")
    print("sample:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()
