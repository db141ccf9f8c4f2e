"""Functional building blocks over plain dicts of tensors.

Conventions follow the JAX package: ``init_*`` functions take an
explicit ``torch.Generator`` first and return a dict of tensors in the
JAX layouts (dense kernels ``[in, out]``); apply functions take
``(params, x)`` and cast parameters to the activation dtype per op.

Tensors are made on ``device`` (default: the generator's own device),
drawing from the generator there, so a full-width model is drawn on
the card and never staged in host memory.  ``device="meta"`` makes
shapes only, with no draw (the counterpart of ``jax.eval_shape``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import embed_on_shards, matmul, on_shards


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def init_device(gen: torch.Generator, device=None) -> torch.device:
    return torch.device(device) if device is not None else gen.device


def truncated_normal_init(gen: torch.Generator, shape, stddev,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    device = init_device(gen, device)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev).to(dtype)


def lecun_init(gen, shape, fan_in: Optional[int] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return truncated_normal_init(gen, shape,
                                 1.0 / math.sqrt(max(fan_in, 1)), dtype,
                                 device)


def he_init(gen, shape, fan_in: Optional[int] = None,
            dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else math.prod(shape[:-1])
    return truncated_normal_init(gen, shape,
                                 math.sqrt(2.0 / max(fan_in, 1)), dtype,
                                 device)


def uniform_init(gen, shape, low: float, high: float, device=None):
    device = init_device(gen, device)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if device.type != "meta":
        t.uniform_(low, high, generator=gen)
    return t


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def init_dense(gen, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype=torch.float32, device=None):
    p = {"kernel": lecun_init(gen, (in_dim, out_dim), in_dim, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype,
                                device=init_device(gen, device))
    return p


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def init_embedding(gen, vocab: int, dim: int, dtype=torch.float32,
                   device=None):
    return {"table": truncated_normal_init(gen, (vocab, dim), 1.0, dtype,
                                           device)}


def embed(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    table = params["table"]
    if on_shards(table) and table.requires_grad:
        return embed_on_shards(table, tokens).to(dtype)
    return table[tokens].to(dtype)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied read-out: logits = x @ table^T, fp32 products of the
    operands in ``x``'s dtype (exact upcasts: JAX's
    ``preferred_element_type=float32``)."""
    table = params["table"].to(x.dtype)
    return matmul(x.float(), table.float().T)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "relu": F.relu,
    "tanh": torch.tanh,
}


def activation(name: str):
    return _ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., S, H, D] (D even), positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # [D/2]
    angles = positions[..., :, None].float() * freqs            # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                       # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def causal_mask(q_len: int, kv_len: int, *, q_offset: int = 0,
                window: int = 0, device=None) -> torch.Tensor:
    """[q_len, kv_len] boolean mask. ``window>0`` = local/sliding attention."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= q_pos
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return mask


def decode_mask(kv_len: int, cache_index: int, *, window: int = 0,
                device=None) -> torch.Tensor:
    """[1, kv_len] mask for single-token decode at position ``cache_index``."""
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = k_pos <= cache_index
    if window > 0:
        mask = mask & (k_pos > cache_index - window)
    return mask
