"""Unified transformer stack for all assigned families.

A model is a sequence of *blocks* drawn from:

* ``attn``  — self-attention (+ FFN / MoE)
* ``lattn`` — local (windowed) self-attention (+ FFN)
* ``battn`` — bidirectional self-attention (+ FFN; the whisper encoder)
* ``rec``   — RG-LRU recurrent block (+ FFN)
* ``ssm``   — Mamba-2 SSD mixer (no separate FFN, as in mamba2)
* ``cross`` — self-attention + cross-attention on a memory (+ FFN)

The block sequence is derived from the config (``block_pattern`` for
hybrids, ``cross_attn_every`` for VLM/enc-dec, plain repetition for
dense/MoE/SSM).  Repeated *periods* keep the JAX package's stacked
layout — every leaf of ``params["scan"]`` (and of the scan caches) has a
leading ``reps`` axis — and run as a Python loop over ``reps`` on views
of the stacked leaves; a non-multiple remainder runs after it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.blockwise import blockwise_attention
from repro_torch.models.cnn import compute_dtype
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.sharding import reshape, shard_act
from repro_torch.tree import tree_map

ATTN_KINDS = ("attn", "lattn", "cross", "battn")


# ---------------------------------------------------------------------------
# pattern derivation
# ---------------------------------------------------------------------------

def block_sequence(cfg: ModelConfig) -> List[str]:
    if cfg.family == "ssm":
        return ["ssm"] * cfg.num_layers
    if cfg.block_pattern:  # hybrid, explicit periodic pattern
        pat = list(cfg.block_pattern)
        return (pat * (cfg.num_layers // len(pat) + 1))[: cfg.num_layers]
    if cfg.family == "vlm" and cfg.cross_attn_every:
        k = cfg.cross_attn_every
        return [("cross" if (i + 1) % k == 0 else "attn")
                for i in range(cfg.num_layers)]
    if cfg.family == "audio":
        return ["cross"] * cfg.num_layers  # whisper decoder layers
    return ["attn"] * cfg.num_layers


def split_periods(seq: List[str]) -> Tuple[List[str], int, List[str]]:
    """Smallest period p such that seq[i] == period[i % p] for all i.

    Returns (period, full_repetitions, remainder) — the remainder is the
    truncated tail (e.g. recurrentgemma's 38 = 12*(rec,rec,attn) + (rec,rec)).
    """
    n = len(seq)
    for p in range(1, n + 1):
        period = seq[:p]
        if all(seq[i] == period[i % p] for i in range(n)):
            return period, n // p, seq[(n // p) * p:]
    return seq, 1, []


# ---------------------------------------------------------------------------
# per-block init
# ---------------------------------------------------------------------------

def _init_norm(cfg, dtype, device):
    return L.init_rmsnorm(cfg.d_model, dtype, device) if cfg.norm == "rms" \
        else L.init_layernorm(cfg.d_model, dtype, device)


def apply_norm(cfg, p, x):
    return L.rmsnorm(p, x, cfg.norm_eps) if cfg.norm == "rms" \
        else L.layernorm(p, x, cfg.norm_eps)


def _init_ffn(cfg, gen, dtype, device):
    if cfg.is_moe:
        return init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, dtype,
                        device)
    if cfg.ffn == "gated":
        return F.init_gated_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return F.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype, device=device)


def _apply_ffn(cfg, p, x, *, no_drop: bool = False):
    """Returns (out, aux).  ``no_drop`` is the MoE serving contract:
    decode steps must never capacity-drop the token being decoded."""
    if cfg.is_moe:
        return moe_ffn(p, x, num_experts=cfg.num_experts,
                       top_k=cfg.num_experts_per_tok,
                       capacity_factor=cfg.capacity_factor,
                       act_name=cfg.activation, no_drop=no_drop)
    if cfg.ffn == "gated":
        return F.gated_ffn(p, x, cfg.activation), 0.0
    return F.mlp(p, x, cfg.activation), 0.0


def init_block(cfg: ModelConfig, kind: str, gen,
               device=None) -> Dict[str, Any]:
    dt = compute_dtype(cfg.param_dtype)
    device = L.init_device(gen, device)
    p: Dict[str, Any] = {"ln1": _init_norm(cfg, dt, device)}
    if kind in ATTN_KINDS:
        p["attn"] = A.init_attention(gen, cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.head_dim,
                                     qkv_bias=cfg.qkv_bias,
                                     qk_norm=cfg.qk_norm, dtype=dt,
                                     device=device)
        p["ln2"] = _init_norm(cfg, dt, device)
        p["ffn"] = _init_ffn(cfg, gen, dt, device)
        if kind == "cross":
            p["lnx"] = _init_norm(cfg, dt, device)
            p["xattn"] = A.init_attention(gen, cfg.d_model, cfg.num_heads,
                                          cfg.num_kv_heads, cfg.head_dim,
                                          dtype=dt, device=device)
    elif kind == "rec":
        p["rec"] = R.init_recurrent_block(gen, cfg.d_model, cfg.d_model,
                                          conv_width=cfg.conv_width,
                                          dtype=dt, device=device)
        p["ln2"] = _init_norm(cfg, dt, device)
        p["ffn"] = _init_ffn(cfg, gen, dt, device)
    elif kind == "ssm":
        p["mixer"] = S.init_mamba2(gen, cfg.d_model, cfg.ssm_state,
                                   expand=cfg.ssm_expand,
                                   conv_width=cfg.conv_width, dtype=dt,
                                   device=device)
    else:
        raise ValueError(kind)
    return p


# ---------------------------------------------------------------------------
# per-block forward (full sequence)
# ---------------------------------------------------------------------------

def _self_attention(cfg: ModelConfig, p, x, positions, *, window: int,
                    causal: bool = True):
    q = A.project_q(p, x, positions, num_heads=cfg.num_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    norm_eps=cfg.norm_eps)
    k, v = A.project_kv(p, x, positions, num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                        norm_eps=cfg.norm_eps)
    # the decoder's sequence takes the config's blocks; the encoder's
    # frames (a fixed encoder_seq) blockwise's own, as cross-attention's
    # keys over them do
    blocks = dict(q_block=cfg.q_block, kv_block=cfg.kv_block) if causal \
        else {}
    ctx = blockwise_attention(q, k, v, causal=causal, window=window, **blocks)
    b, s = ctx.shape[:2]
    return L.dense(p["wo"], reshape(ctx, (b, s, -1))), (k, v)


def block_forward(cfg: ModelConfig, kind: str, p, x, positions,
                  memory: Optional[torch.Tensor], *,
                  want_cache: bool = False):
    """Returns (x_out, aux_loss, cache_entry_or_None)."""
    aux = torch.zeros((), device=x.device)
    cache = None
    if kind in ATTN_KINDS:
        window = cfg.local_window if kind == "lattn" else 0
        h, (k, v) = _self_attention(cfg, p["attn"],
                                    apply_norm(cfg, p["ln1"], x),
                                    positions, window=window,
                                    causal=kind != "battn")
        if want_cache:
            if kind == "lattn":
                k, v = k[:, -cfg.local_window:], v[:, -cfg.local_window:]
            cache = {"kv": {"k": k, "v": v}}
        x = x + h
        if kind == "cross":
            h = A.cross_attention(p["xattn"], apply_norm(cfg, p["lnx"], x),
                                  memory, num_heads=cfg.num_heads,
                                  num_kv_heads=cfg.num_kv_heads,
                                  head_dim=cfg.head_dim, norm_eps=cfg.norm_eps,
                                  q_block=cfg.q_block)
            x = x + h
        h, a = _apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))
        aux = aux + a
        x = x + h
    elif kind == "rec":
        xin = apply_norm(cfg, p["ln1"], x)
        h, st = R.recurrent_block_forward(p["rec"], xin,
                                          want_state=want_cache)
        if want_cache:
            cache = {"rec": st}
        x = x + h
        h, a = _apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x))
        aux = aux + a
        x = x + h
    elif kind == "ssm":
        h, st = S.mamba2_forward(p["mixer"], apply_norm(cfg, p["ln1"], x),
                                 d_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
                                 want_state=want_cache)
        if want_cache:
            cache = {"ssm": st}
        x = x + h
    return x, aux, cache


# ---------------------------------------------------------------------------
# per-block decode (one token, stateful)
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     dtype, device=None) -> Dict[str, Any]:
    if kind in ("attn", "lattn", "cross"):
        length = min(cache_len, cfg.local_window) if kind == "lattn" \
            else cache_len
        return {"kv": A.init_kv_cache(batch, length, cfg.num_kv_heads,
                                      cfg.head_dim, dtype, device)}
    if kind == "rec":
        return {"rec": R.init_recurrent_state(batch, cfg.d_model,
                                              conv_width=cfg.conv_width,
                                              dtype=dtype, device=device)}
    if kind == "ssm":
        return {"ssm": S.init_mamba2_state(batch, cfg.d_model, cfg.ssm_state,
                                           expand=cfg.ssm_expand,
                                           conv_width=cfg.conv_width,
                                           dtype=dtype, device=device)}
    raise ValueError(kind)


def block_decode(cfg: ModelConfig, kind: str, p, x, cache, index: int,
                 memory: Optional[torch.Tensor], *, rolling: bool):
    """One token through one block; returns ``(x, cache entry)``.  A KV
    cache is written in place, a recurrent or SSM state comes back new.
    As in the JAX package, a ``lattn`` block decodes on its rolling
    window buffer with no window mask of its own."""
    if kind in ("attn", "lattn", "cross"):
        roll = rolling or kind == "lattn"
        h, kv = A.decode_attention(p["attn"], apply_norm(cfg, p["ln1"], x),
                                   cache["kv"], index,
                                   num_heads=cfg.num_heads,
                                   num_kv_heads=cfg.num_kv_heads,
                                   head_dim=cfg.head_dim,
                                   rope_theta=cfg.rope_theta,
                                   norm_eps=cfg.norm_eps, rolling=roll)
        x = x + h
        if kind == "cross":
            h = A.cross_attention(p["xattn"], apply_norm(cfg, p["lnx"], x),
                                  memory, num_heads=cfg.num_heads,
                                  num_kv_heads=cfg.num_kv_heads,
                                  head_dim=cfg.head_dim, norm_eps=cfg.norm_eps,
                                  q_block=cfg.q_block)
            x = x + h
        h, _ = _apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x),
                          no_drop=True)
        return x + h, {"kv": kv}
    if kind == "rec":
        h, st = R.recurrent_block_decode(p["rec"],
                                         apply_norm(cfg, p["ln1"], x),
                                         cache["rec"])
        x = x + h
        h, _ = _apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["ln2"], x),
                          no_drop=True)
        return x + h, {"rec": st}
    if kind == "ssm":
        h, st = S.mamba2_decode_step(p["mixer"], apply_norm(cfg, p["ln1"], x),
                                     cache["ssm"], d_state=cfg.ssm_state)
        return x + h, {"ssm": st}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# whole-stack init / forward / decode
# ---------------------------------------------------------------------------

def _rep(stacked, r: int):
    """Rep ``r`` of a stacked tree: views, not copies."""
    return tree_map(lambda t: t[r], stacked)


def _write(dst, src) -> None:
    """Copy a cache entry into its (stacked) slot, leaf by leaf; a leaf
    that is already the slot (a KV cache written in place) is skipped."""
    tree_map(lambda d, s: None if s is d else d.copy_(s), dst, src)


def init_stack(cfg: ModelConfig, gen, device=None):
    """Stacked periods + remainder.  The stacked leaves are allocated
    once and filled a period at a time, so the peak is the model plus
    one period (a full-width model is never held twice)."""
    seq = block_sequence(cfg)
    period, reps, rem = split_periods(seq)
    stacked = None
    for r in range(reps):
        one = {f"b{i}": init_block(cfg, kind, gen, device)
               for i, kind in enumerate(period)}
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((reps,) + t.shape), one)
        _write(_rep(stacked, r), one)
    rem_params = [init_block(cfg, kind, gen, device) for kind in rem]
    return {"scan": stacked, "rem": rem_params}


def _period_forward(cfg, period, pparams, x, positions, memory,
                    want_cache=False):
    aux = torch.zeros((), device=x.device)
    caches = {}
    for i, kind in enumerate(period):
        x = shard_act(x, "btd")
        x, a, c = block_forward(cfg, kind, pparams[f"b{i}"], x, positions,
                                memory, want_cache=want_cache)
        aux = aux + a
        if want_cache:
            caches[f"b{i}"] = c
    return x, aux, caches


def stack_forward(cfg: ModelConfig, params, x, positions,
                  memory: Optional[torch.Tensor] = None, *,
                  remat: bool = False):
    """The stacked periods, then the remainder blocks.  ``remat`` (while
    autograd records) wraps each period in ``torch.utils.checkpoint``
    (``jax.checkpoint`` per period, nothing saved): its activations are
    recomputed in the backward, which gives the same gradients."""
    seq = block_sequence(cfg)
    period, reps, rem = split_periods(seq)
    aux = torch.zeros((), device=x.device)
    remat = remat and torch.is_grad_enabled()
    if params["scan"] is not None:
        for r in range(reps):
            args = (cfg, period, _rep(params["scan"], r), x, positions,
                    memory)
            if remat:
                x, a, _ = torch.utils.checkpoint.checkpoint(
                    _period_forward, *args, use_reentrant=False)
            else:
                x, a, _ = _period_forward(*args)
            aux = aux + a
    for kind, p in zip(rem, params["rem"]):
        x, a, _ = block_forward(cfg, kind, p, x, positions, memory)
        aux = aux + a
    return x, aux


def stack_prefill(cfg: ModelConfig, params, x, positions,
                  memory: Optional[torch.Tensor] = None):
    """Forward pass that also returns the decode cache (KV / states)."""
    seq = block_sequence(cfg)
    period, reps, rem = split_periods(seq)
    scan_caches = None
    if params["scan"] is not None:
        per_rep = []
        for r in range(reps):
            x, _, caches = _period_forward(cfg, period,
                                           _rep(params["scan"], r), x,
                                           positions, memory, want_cache=True)
            per_rep.append(caches)
        scan_caches = tree_map(lambda *ts: torch.stack(ts), *per_rep)
    rem_caches = []
    for kind, p in zip(rem, params["rem"]):
        x, _, c = block_forward(cfg, kind, p, x, positions, memory,
                                want_cache=True)
        rem_caches.append(c)
    return x, {"scan": scan_caches, "rem": rem_caches}


def init_stack_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                     device=None):
    seq = block_sequence(cfg)
    period, reps, rem = split_periods(seq)
    one = {f"b{i}": init_block_cache(cfg, kind, batch, cache_len, dtype,
                                     device)
           for i, kind in enumerate(period)}
    stacked = tree_map(lambda t: t.new_zeros((reps,) + t.shape), one) \
        if reps > 0 else None
    rem_caches = [init_block_cache(cfg, kind, batch, cache_len, dtype, device)
                  for kind in rem]
    return {"scan": stacked, "rem": rem_caches}


def stack_decode(cfg: ModelConfig, params, caches, x, index: int,
                 memory: Optional[torch.Tensor] = None, *, rolling: bool):
    """One token through the stack; ``caches`` is updated in place and
    returned (a cache is consumed by the step)."""
    seq = block_sequence(cfg)
    period, reps, rem = split_periods(seq)
    if params["scan"] is not None:
        for r in range(reps):
            pparams, pcache = _rep(params["scan"], r), _rep(caches["scan"], r)
            for i, kind in enumerate(period):
                x, c = block_decode(cfg, kind, pparams[f"b{i}"], x,
                                    pcache[f"b{i}"], index, memory,
                                    rolling=rolling)
                _write(pcache[f"b{i}"], c)
    for kind, p, c in zip(rem, params["rem"], caches["rem"]):
        x, nc = block_decode(cfg, kind, p, x, c, index, memory,
                             rolling=rolling)
        _write(c, nc)
    return x, caches
