"""Grouped-query attention with RoPE, qk-norm, KV-cache and sliding windows.

Supports the attention variants used by the assigned architectures:

* GQA with arbitrary ``num_kv_heads`` (qwen3, starcoder2, yi, llama4, ...)
* optional qk-norm (qwen3) and QKV bias (qwen1.5)
* local / sliding-window masks (recurrentgemma local-attn layers, and the
  long-context serving path for dense archs)
* cross-attention against an encoder memory (whisper, llama-3.2-vision)
* single-token decode against a (optionally rolling) KV cache, written
  in place
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.blockwise import blockwise_attention
from repro_torch.sharding import gqa_on_shards, on_shards, reshape, shard_act


def init_attention(gen, d_model: int, num_heads: int, num_kv_heads: int,
                   head_dim: int, *, qkv_bias: bool = False,
                   qk_norm: bool = False, dtype=torch.float32, device=None):
    device = L.init_device(gen, device)
    p = {
        "wq": L.init_dense(gen, d_model, num_heads * head_dim, bias=qkv_bias,
                           dtype=dtype, device=device),
        "wk": L.init_dense(gen, d_model, num_kv_heads * head_dim,
                           bias=qkv_bias, dtype=dtype, device=device),
        "wv": L.init_dense(gen, d_model, num_kv_heads * head_dim,
                           bias=qkv_bias, dtype=dtype, device=device),
        "wo": L.init_dense(gen, num_heads * head_dim, d_model, dtype=dtype,
                           device=device),
    }
    if qk_norm:
        p["q_norm"] = L.init_rmsnorm(head_dim, dtype, device)
        p["k_norm"] = L.init_rmsnorm(head_dim, dtype, device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int):
    return reshape(x, x.shape[:-1] + (n_heads, head_dim))


def project_q(params, x, positions, *, num_heads, head_dim, rope_theta,
              use_rope=True, norm_eps=1e-6):
    q = shard_act(_split_heads(L.dense(params["wq"], x), num_heads,
                               head_dim), "bthd")
    if "q_norm" in params:
        q = L.rmsnorm(params["q_norm"], q, norm_eps)
    if use_rope:
        q = L.apply_rope(q, positions, rope_theta)
    return q


def project_kv(params, x, positions, *, num_kv_heads, head_dim, rope_theta,
               use_rope=True, norm_eps=1e-6):
    k = shard_act(_split_heads(L.dense(params["wk"], x), num_kv_heads,
                               head_dim), "bthd")
    v = shard_act(_split_heads(L.dense(params["wv"], x), num_kv_heads,
                               head_dim), "bthd")
    if "k_norm" in params:
        k = L.rmsnorm(params["k_norm"], k, norm_eps)
    if use_rope:
        k = L.apply_rope(k, positions, rope_theta)
    return k, v


def gqa_scores(q, k, scale: float):
    """q: [B,S,NQ,HD], k: [B,T,NKV,HD] -> fp32 scores [B,NKV,G,S,T]
    (exact upcasts of the operands)."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale


def gqa_context(scores, v, mask: Optional[torch.Tensor], dtype):
    """The masked softmax of ``scores`` [B,NKV,G,S,T] (to ``dtype``) against
    v [B,T,NKV,HD] -> [B,S,NKV,G,HD]."""
    if mask is not None:
        m = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
        scores = torch.where(m, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    dt = torch.promote_types(dtype, v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(dt), v.to(dt))


def gqa_attend(q, k, v, mask: Optional[torch.Tensor]):
    """q: [B,S,NQ,HD], k/v: [B,T,NKV,HD], mask [S,T] or [B|1,S|1,T].

    Scores and softmax in fp32 (exact upcasts of the operands); the
    probabilities go back to ``q``'s dtype before the product with v.
    Under an in-node layout each rank runs it on its shards
    (:func:`repro_torch.sharding.gqa_on_shards`)."""
    b, s, nq, hd = q.shape
    if on_shards(q):
        ctx = gqa_on_shards(gqa_scores, gqa_context, q, k, v, mask)
        return reshape(ctx, (b, s, nq * hd))
    ctx = gqa_context(gqa_scores(q, k, hd ** -0.5), v, mask, q.dtype)
    return ctx.reshape(b, s, nq * hd)


def cross_attention(params, x, memory, *, num_heads, num_kv_heads, head_dim,
                    norm_eps=1e-6, q_block: int = 512):
    """Cross-attention: queries from ``x``, keys/values from ``memory``.

    No RoPE and no causal mask (encoder memory is fully visible).
    Runs blockwise above 1024 queries so the [S, T_mem] score tensor
    never materialises: the queries in blocks of ``q_block``, the memory
    in blockwise's own.
    """
    b, s, _ = x.shape
    q = project_q(params, x, None, num_heads=num_heads, head_dim=head_dim,
                  rope_theta=1.0, use_rope=False, norm_eps=norm_eps)
    k, v = project_kv(params, memory, None, num_kv_heads=num_kv_heads,
                      head_dim=head_dim, rope_theta=1.0, use_rope=False,
                      norm_eps=norm_eps)
    if s > 1024:
        ctx = blockwise_attention(q, k, v, causal=False,
                                  q_block=q_block).reshape(b, s, -1)
    else:
        ctx = gqa_attend(q, k, v, None)
    return L.dense(params["wo"], ctx)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, num_kv_heads: int,
                  head_dim: int, dtype, device=None):
    shape = (batch, cache_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x, cache, cache_index: int, *, num_heads,
                     num_kv_heads, head_dim, rope_theta=10_000.0,
                     use_rope=True, norm_eps=1e-6, rolling: bool = False):
    """One-token decode. ``x``: [B,1,D]; ``cache_index``: the absolute
    position of the new token. Returns ``(out, cache)``: the new K/V are
    written into ``cache`` in place, so a cache is consumed by the step.

    ``rolling=True`` treats the cache as a circular window buffer of
    length ``cache["k"].shape[1]`` (sliding-window serving).
    """
    cache_len = cache["k"].shape[1]
    pos = torch.full((1,), cache_index, dtype=torch.int32, device=x.device)
    q = project_q(params, x, pos, num_heads=num_heads, head_dim=head_dim,
                  rope_theta=rope_theta, use_rope=use_rope, norm_eps=norm_eps)
    k_new, v_new = project_kv(params, x, pos, num_kv_heads=num_kv_heads,
                              head_dim=head_dim, rope_theta=rope_theta,
                              use_rope=use_rope, norm_eps=norm_eps)
    slot = cache_index % cache_len if rolling else cache_index
    if not 0 <= slot < cache_len:
        raise IndexError(f"position {cache_index} is outside a cache of "
                         f"{cache_len} (pass rolling=True for a window)")
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    j = torch.arange(cache_len, device=x.device)[None, :]
    mask = j <= cache_index
    if rolling:
        # once the buffer has wrapped every slot is valid
        mask = mask | (cache_index >= cache_len)
    ctx = gqa_attend(q, cache["k"], cache["v"], mask[None])
    return L.dense(params["wo"], ctx), cache
