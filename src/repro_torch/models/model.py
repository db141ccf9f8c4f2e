"""Unified model API over every family (``repro.models.model``).

Every model — CNN, ResNet, or any transformer family — exposes:

* ``init_params(cfg, gen[, device])`` — parameters from an explicit
  ``torch.Generator``, in ``cfg.param_dtype``; an LM is drawn on
  ``device`` (default: the generator's), ``"meta"`` for shapes only,
* ``forward(cfg, params, batch, *, remat=False)`` -> :class:`ModelOutput`
  (logits, f1, aux),
* ``prefill(cfg, params, batch)`` -> (last logits, cache)      [LM families]
* ``init_cache`` / ``decode_step(cfg, params, token, index, cache, ...)``
  [LM families; the cache is updated in place],
* ``derive_student(cfg)`` — the ProFe student config,
* ``params_from_numpy(tree)`` — carry a JAX package parameter tree
  (nested dicts and lists of numpy arrays) over in the same layouts.
  ``torch`` cannot reproduce ``jax.random``, so every comparison with
  ``repro`` starts from carried weights.

``f1`` is the ProFe prototype representation f_1(x): the first-linear-layer
output for CNN/ResNet (paper Sec. III-B) and the projected mean-pooled
final hidden state for LM families.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.cnn import cnn_forward, compute_dtype, init_cnn
from repro_torch.models.resnet import init_resnet, resnet_forward
from repro_torch.sharding import shard_act
from repro_torch.tree import tree_leaves, tree_map


class ModelOutput(NamedTuple):
    logits: torch.Tensor   # [B,S,V] (LM) or [B,K] (classifier)
    f1: torch.Tensor       # [B, proto_dim] prototype representation
    aux: torch.Tensor      # scalar auxiliary loss (MoE load balance)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """Whisper encoder: bidirectional attention stack over frame embeddings."""
    return cfg.replace(family="dense", block_pattern=("battn",),
                       num_layers=cfg.encoder_layers, num_experts=0)


def _init_norm(cfg: ModelConfig, dt, device):
    return (L.init_rmsnorm(cfg.d_model, dt, device) if cfg.norm == "rms"
            else L.init_layernorm(cfg.d_model, dt, device))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

_IMAGE_INITS = {"cnn": init_cnn, "resnet": init_resnet}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Dict[str, Any]:
    if cfg.family in _IMAGE_INITS:
        if device is not None and torch.device(device) != gen.device:
            raise ValueError(f"{cfg.family} parameters are drawn on the "
                             f"generator's device ({gen.device})")
        return _IMAGE_INITS[cfg.family](cfg, gen)
    dt = compute_dtype(cfg.param_dtype)
    device = L.init_device(gen, device)
    params: Dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                  device),
        "stack": T.init_stack(cfg, gen, device),
        "final_norm": _init_norm(cfg, dt, device),
        "proto_proj": L.init_dense(gen, cfg.d_model, cfg.proto_dim,
                                   bias=True, dtype=dt, device=device),
    }
    if cfg.family == "audio":
        params["encoder"] = {
            "stack": T.init_stack(_encoder_cfg(cfg), gen, device),
            "norm": _init_norm(cfg, dt, device),
        }
    if cfg.family == "vlm":
        params["img_proj"] = L.init_dense(gen, cfg.d_model, cfg.d_model,
                                          dtype=dt, device=device)
    return params


# ---------------------------------------------------------------------------
# memory (cross-attention source) from stubbed frontends
# ---------------------------------------------------------------------------

def build_memory(cfg: ModelConfig, params, batch, *,
                 remat: bool = False) -> Optional[torch.Tensor]:
    if cfg.family == "vlm":
        img = batch["image_embed"].to(compute_dtype(cfg.dtype))
        return L.dense(params["img_proj"], img)
    if cfg.family == "audio":
        x = batch["audio_embed"].to(compute_dtype(cfg.dtype))
        pos = torch.arange(x.shape[1], device=x.device)
        x, _ = T.stack_forward(_encoder_cfg(cfg), params["encoder"]["stack"],
                               x, pos, remat=remat)
        return T.apply_norm(cfg, params["encoder"]["norm"], x)
    return None


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------

def _head(cfg, params, h):
    h = T.apply_norm(cfg, params["final_norm"], h)
    pooled = torch.mean(h.float(), dim=1)
    f1 = F.relu(L.dense(params["proto_proj"], pooled.to(h.dtype))).float()
    return shard_act(L.unembed(params["embed"], h), "btv"), f1


_IMAGE_FORWARDS = {"cnn": cnn_forward, "resnet": resnet_forward}


def forward(cfg: ModelConfig, params, batch, *,
            remat: bool = False) -> ModelOutput:
    """Logits, ``f1`` and the router's aux loss of one batch.  ``remat``
    recomputes each period of an LM stack (the encoder's too) in the
    backward instead of keeping its activations: training passes it
    (``TrainConfig.remat``), serving and evaluation keep ``False``."""
    if cfg.family in _IMAGE_FORWARDS:
        logits, f1 = _IMAGE_FORWARDS[cfg.family](cfg, params, batch["image"])
        return ModelOutput(logits, f1, torch.zeros((), device=logits.device))
    tokens = batch["tokens"]
    x = shard_act(L.embed(params["embed"], tokens, compute_dtype(cfg.dtype)),
                  "btd")
    positions = batch.get("positions",
                          torch.arange(tokens.shape[1], device=tokens.device))
    memory = build_memory(cfg, params, batch, remat=remat)
    x, aux = T.stack_forward(cfg, params["stack"], x, positions, memory,
                             remat=remat)
    logits, f1 = _head(cfg, params, x)
    return ModelOutput(logits, f1, aux)


def _pad_len(t: torch.Tensor, length: int, axis: int) -> torch.Tensor:
    extra = length - t.shape[axis]
    if extra < 0:
        raise ValueError(f"a prefill of {t.shape[axis]} tokens does not fit "
                         f"a cache of {length}")
    pad = [0, 0] * (t.ndim - 1 - axis) + [0, extra]
    return F.pad(t, pad)


def _grow_caches(cfg: ModelConfig, cache, cache_len: int):
    """Prefill's KV caches (one slot a prompt token) padded with zeros
    to the length :func:`init_cache` gives them, for decoding on."""
    period, _, rem = T.split_periods(T.block_sequence(cfg))

    def grow(kind, entry, axis):
        if "kv" not in entry:
            return entry
        length = min(cache_len, cfg.local_window) if kind == "lattn" \
            else cache_len
        return {"kv": {n: _pad_len(t, length, axis)
                       for n, t in entry["kv"].items()}}

    scan = None if cache["scan"] is None else {
        f"b{i}": grow(kind, cache["scan"][f"b{i}"], 2)
        for i, kind in enumerate(period)}
    return {"scan": scan,
            "rem": [grow(kind, c, 1) for kind, c in zip(rem, cache["rem"])]}


def prefill(cfg: ModelConfig, params, batch,
            cache_len: Optional[int] = None):
    """Forward + decode-cache build. Returns (last_logits [B,V], cache).

    The KV caches hold one slot a prompt token, as in the JAX package;
    ``cache_len`` pads them to that length so decoding can go on."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, compute_dtype(cfg.dtype))
    positions = batch.get("positions",
                          torch.arange(tokens.shape[1], device=tokens.device))
    memory = build_memory(cfg, params, batch)
    x, cache = T.stack_prefill(cfg, params["stack"], x, positions, memory)
    logits, _ = _head(cfg, params, x[:, -1:, :])
    if cache_len is not None:
        cache = _grow_caches(cfg, cache, cache_len)
    return logits[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None):
    return T.init_stack_cache(cfg, batch, cache_len, dtype, device)


def decode_step(cfg: ModelConfig, params, token, index: int, cache,
                memory: Optional[torch.Tensor] = None, *,
                rolling: bool = False):
    """token: [B,1] int; index: the absolute position of the token.

    Returns (logits [B,V], cache): ``cache`` is updated in place and must
    not be used again as the state before this step.  ``rolling=True``
    = sliding-window serving (long_500k on full-attention archs).
    """
    x = L.embed(params["embed"], token, compute_dtype(cfg.dtype))
    x, cache = T.stack_decode(cfg, params["stack"], cache, x, index, memory,
                              rolling=rolling)
    logits, _ = _head(cfg, params, x)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# ProFe student derivation
# ---------------------------------------------------------------------------

_STUDENT_OVERRIDES = {
    # paper pairs: ResNet18 -> ResNet8, ResNet32 -> ResNet18
    "cifar10-resnet18": dict(resnet_blocks=(1, 1, 1), resnet_width=16),
    "cifar100-resnet32": dict(resnet_blocks=(2, 2, 2, 2), resnet_width=64),
}


def derive_student(cfg: ModelConfig) -> ModelConfig:
    """The paper's smaller aggregation model, same family as the teacher."""
    if cfg.family == "cnn":
        return cfg.replace(
            name=cfg.name + "-student",
            cnn_channels=tuple(max(c // 2, 1) for c in cfg.cnn_channels))
    if cfg.family == "resnet":
        ov = _STUDENT_OVERRIDES.get(cfg.name, dict(
            resnet_blocks=tuple(max(b // 2, 1) for b in cfg.resnet_blocks)))
        return cfg.replace(name=cfg.name + "-student", **ov)
    s = cfg.student_scale
    n_layers = max(int(round(cfg.num_layers * s)), 2)
    if cfg.block_pattern:
        # keep whole periods so the pattern stays valid
        p = len(cfg.block_pattern)
        n_layers = max((n_layers // p) * p, p)
    kw: Dict[str, Any] = dict(
        name=cfg.name + "-student",
        num_layers=n_layers,
        d_ff=max(int(cfg.d_ff * s), 128) if cfg.d_ff else cfg.d_ff,
    )
    if cfg.is_moe and not cfg.student_moe:
        kw.update(num_experts=0, num_experts_per_tok=0)
    if cfg.encoder_layers:
        kw["encoder_layers"] = max(int(round(cfg.encoder_layers * s)), 2)
    return cfg.replace(**kw)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params)
               if isinstance(t, torch.Tensor))


def param_bytes(params, bytes_per_param: int = 4) -> int:
    return param_count(params) * bytes_per_param


# ---------------------------------------------------------------------------
# carrying JAX package weights across
# ---------------------------------------------------------------------------

def _from_numpy(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy has no bfloat16 (ml_dtypes); through float32,
        # which holds every bfloat16 value exactly
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device: torch.device | str = "cpu"):
    """JAX package parameters (nested dicts and lists of numpy or JAX
    arrays, ``None`` where the JAX tree has one) -> the port's (the same
    tree of tensors, same shapes, layouts and dtypes)."""
    return tree_map(lambda x: _from_numpy(x, device), tree)
