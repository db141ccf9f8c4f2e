"""Training launcher: ProFe steps (teacher and student trained jointly,
Eq. 8/9) on one node of any assigned architecture.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        [--steps 5] [--batch 2] [--seq 64] [--lr 1e-3] [--full-config] \
        [--layers N] [--checkpoint PATH] [--device cpu] [--seed 0] \
        [--frontend-scale 0.02]

Runs on the card unless ``--device cpu`` is given (and raises with no
card).  Without ``--full-config`` the reduced (smoke) config runs;
``--layers`` cuts the teacher's depth (the student is derived from the
cut teacher).  As in the JAX package's launcher, one node's state (a
per-leaf student, both models under ``make_optimizer(cfg.optimizer,
lr)``) takes ``--steps`` steps over ``make_token_dataset(0, steps ·
batch, seq, vocab, n_proto_classes)``, the audio and VLM frontends
stubbed with zero embeddings (``--frontend-scale`` draws them from a
normal instead: on zeros an encoder's residual stream stays exactly 0,
so each LayerNorm's backward scales the gradient by ``1/sqrt(eps)``,
and whisper-small's 24 encoder norms overflow it to NaN in the first
step); the node is a stack of one (``core/profe.make_profe_step``).
The weights are random, drawn on the device from ``--seed``.
``--checkpoint`` saves the student through
``repro_torch.checkpoint.save_checkpoint``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import FederationConfig, get_config
from repro_torch.config.base import ModelConfig
from repro_torch.core.profe import (NodeState, init_node_state,
                                    make_profe_step, resolve_device,
                                    stack_states)
from repro_torch.data import make_token_dataset
from repro_torch.models import derive_student
from repro_torch.optim import make_optimizer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_state(cfg: ModelConfig, *, lr: float = 1e-3, seed: int = 0,
                device=None) -> NodeState:
    """One node's fresh state, stacked as N = 1: the teacher ``cfg`` and
    its derived student (per-leaf), drawn on ``device`` from ``seed``,
    with ``make_optimizer(cfg.optimizer, lr)`` states for both."""
    device = resolve_device(device)
    opt = make_optimizer(cfg.optimizer, lr)
    gen = torch.Generator(device=device).manual_seed(seed)
    one = init_node_state(cfg, derive_student(cfg), gen, opt, opt,
                          cfg.n_proto_classes, plane=False, device=device)
    state = stack_states([one])
    del one
    return state


def token_batches(cfg: ModelConfig, steps: int, batch: int, seq: int,
                  device, *, frontend_scale: float = 0.0,
                  seed: int = 0) -> list:
    """``steps`` batches ``{tokens, labels, domains[, image_embed |
    audio_embed]}``, each leaf ``[1, batch, ...]`` (one node).  The
    stubbed frontend embeddings (bf16) are zeros, or with
    ``frontend_scale`` > 0 normal draws of that scale from ``seed``."""
    data = make_token_dataset(0, steps * batch, seq, cfg.vocab_size,
                              cfg.n_proto_classes)
    rng = np.random.default_rng(seed)
    frames = {"vlm": ("image_embed", cfg.num_image_tokens),
              "audio": ("audio_embed", cfg.encoder_seq)}.get(cfg.family)
    out = []
    for i in range(steps):
        sl = slice(i * batch, (i + 1) * batch)
        b = {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(device)
             for k, v in data.items()}
        if frames is not None:
            key, n = frames
            emb = torch.zeros((batch, n, cfg.d_model), dtype=torch.bfloat16,
                              device=device)
            if frontend_scale > 0:
                emb.copy_(torch.from_numpy((rng.standard_normal(
                    (batch, n, cfg.d_model)) * frontend_scale)
                    .astype(np.float32)))
            b[key] = emb
        out.append({k: v[None] for k, v in b.items()})
    return out


def train(cfg: ModelConfig, state: NodeState, *, steps: int = 5,
          batch: int = 2, seq: int = 64, lr: float = 1e-3,
          remat: bool = True, frontend_scale: float = 0.0,
          verbose: bool = True) -> Dict[str, Any]:
    """``steps`` ProFe steps of ``state`` (:func:`train_state`, updated
    in place), the teacher on in every step, over :func:`token_batches`
    (``frontend_scale`` as there).

    Returns the losses a step (``loss_s``, ``loss_t``), ``first_step_ms``
    (one-off library set-up included), ``step_ms`` (the mean of the later
    steps, the device synchronized; ``nan`` for one step) and, on the
    card, ``peak_bytes`` (``torch.cuda.max_memory_allocated`` over the
    steps)."""
    device = state.round_idx.device
    student_cfg = derive_student(cfg)
    opt = make_optimizer(cfg.optimizer, lr)
    step = make_profe_step(cfg, student_cfg, FederationConfig(), opt, opt,
                           remat=remat)
    batches = token_batches(cfg, steps, batch, seq, device,
                            frontend_scale=frontend_scale)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses_s, losses_t, stamps = [], [], []
    _sync(device)
    t0 = time.perf_counter()
    for i, b in enumerate(batches):
        state, metrics = step(state, b, True)
        losses_s.append(float(metrics["loss_s"][0]))
        losses_t.append(float(metrics["loss_t"][0]))
        _sync(device)
        stamps.append(time.perf_counter())
        if verbose:
            print(f"step {i}: loss_s={losses_s[-1]:.4f} "
                  f"loss_t={losses_t[-1]:.4f} ({stamps[-1] - t0:.1f}s)",
                  flush=True)
    later = steps - 1
    return {"state": state, "loss_s": losses_s, "loss_t": losses_t,
            "first_step_ms": (stamps[0] - t0) * 1e3,
            "step_ms": (stamps[-1] - stamps[0]) * 1e3 / later if later
            else float("nan"),
            "peak_bytes": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a config "
                         "whose full depth does not fit the card)")
    ap.add_argument("--checkpoint", default=None,
                    help="save the trained student here (.npz)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frontend-scale", type=float, default=0.0,
                    help="draw the audio / image frontend stubs from a "
                         "normal of this scale (default 0: zeros)")
    args = ap.parse_args(argv)
    if args.steps < 1 or args.batch < 1 or args.seq < 1:
        ap.error("--steps, --batch and --seq must be at least 1")
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the launcher; returns :func:`train`'s result with the config
    beside it."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    student_cfg = derive_student(cfg)
    print(f"teacher {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"on {device}", flush=True)
    print(f"student {student_cfg.name}: {student_cfg.num_layers}L "
          f"d_ff={student_cfg.d_ff}", flush=True)
    state = train_state(cfg, lr=args.lr, seed=args.seed, device=device)
    out = train(cfg, state, steps=args.steps, batch=args.batch,
                seq=args.seq, lr=args.lr,
                frontend_scale=args.frontend_scale)
    if args.checkpoint:
        from repro_torch.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, out["state"].student,
                        metadata={"arch": args.arch, "steps": args.steps})
        print(f"saved student -> {args.checkpoint}", flush=True)
    return dict(out, cfg=cfg)


if __name__ == "__main__":
    main()
