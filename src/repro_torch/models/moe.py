"""Mixture-of-Experts FFN: top-k router + capacity-based einsum dispatch.

GShard/Switch-style dense dispatch, grouped so the dispatch tensor stays
small (``group_size`` tokens per group => capacity scales with the group,
and the dispatch footprint is O(N * k * cf) whatever the sequence
length), as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import cumsum, einsum, reshape, shard_act

DEFAULT_GROUP = 2048


def init_moe(gen, d_model: int, d_ff: int, num_experts: int,
             dtype=torch.float32, device=None):
    e = num_experts
    return {
        "router": L.lecun_init(gen, (d_model, e), d_model, dtype, device),
        "wi_gate": L.lecun_init(gen, (e, d_model, d_ff), d_model, dtype,
                                device),
        "wi_up": L.lecun_init(gen, (e, d_model, d_ff), d_model, dtype, device),
        "wo": L.lecun_init(gen, (e, d_ff, d_model), d_ff, dtype, device),
    }


def route_top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (``torch.topk`` promises no order on ties; a stable
    descending sort keeps it)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def moe_ffn(params, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, act_name: str = "silu",
            group_size: int = DEFAULT_GROUP,
            no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D], aux load-balance loss scalar).

    ``no_drop=True`` sizes capacity to cover every routing slot so no
    token is ever dropped — the serving contract: a decode step must
    not drop the very token being decoded.  The decode path sets it;
    training keeps the configured capacity.
    """
    B, S, D = x.shape
    E, K = num_experts, top_k
    tokens = reshape(x, (-1, D))
    N = tokens.shape[0]
    g = min(group_size, N)
    # pad N to a multiple of g
    pad = (-N) % g
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    G = tokens.shape[0] // g
    xt = shard_act(reshape(tokens, (G, g, D)), "gtd")

    router = params["router"].to(x.dtype)
    logits = einsum("gtd,de->gte", xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)                        # [G,g,E] f32
    w, idx = route_top_k(probs, K)                               # [G,g,K]
    w = w / torch.sum(w, dim=-1, keepdim=True)

    onehot = F.one_hot(idx, E).float()                           # [G,g,K,E]
    flat = reshape(onehot, (G, g * K, E))
    pos = cumsum(flat, dim=1) - 1.0                              # [G,gK,E]
    if no_drop:
        C = g * K                      # serving: cover every routing slot
    else:
        C = max(int(math.ceil(g * K / E * capacity_factor)), 1)
        # Tiny-group floor: with <=64 tokens the cf-based capacity is so
        # quantized that "dropping" is sampling noise, and forward /
        # prefill must route identically to a no-drop decode for the
        # serving invariant to hold at small batch.
        if g <= 64:
            C = g * K
    keep = (pos < C) & (flat > 0)                                # [G,gK,E]
    pos = reshape(pos, (G, g, K, E))
    keep = reshape(keep, (G, g, K, E))

    c_iota = torch.arange(C, dtype=torch.float32, device=x.device)
    # token-granular dispatch/combine: sum over the K routing slots
    disp_k = keep[..., None] & (pos[..., None] == c_iota)        # [G,g,K,E,C]
    disp = disp_k.to(x.dtype)
    dispatch = shard_act(torch.sum(disp, dim=2), "gtec")         # [G,g,E,C]
    combine = shard_act(
        torch.sum(disp * w[..., None, None].to(x.dtype), dim=2), "gtec")

    expert_in = shard_act(einsum("gtec,gtd->egcd", dispatch, xt),
                          "egcd")                                # [E,G,C,D]
    act = L.activation(act_name)
    wi_g = params["wi_gate"].to(x.dtype)
    wi_u = params["wi_up"].to(x.dtype)
    wo = params["wo"].to(x.dtype)
    h = act(einsum("egcd,edf->egcf", expert_in, wi_g)) * \
        einsum("egcd,edf->egcf", expert_in, wi_u)
    expert_out = shard_act(einsum("egcf,efd->egcd", h, wo), "egcd")
    out = einsum("gtec,egcd->gtd", combine, expert_out)

    out = reshape(reshape(out, (-1, D))[:N], (B, S, D))

    # Switch load-balance auxiliary loss: E * sum_e f_e * p_e
    frac = torch.mean(onehot[..., 0, :] if K == 1 else onehot.amax(dim=2),
                      dim=(0, 1))                                # [E]
    mean_prob = torch.mean(probs, dim=(0, 1))                    # [E]
    aux = E * torch.sum(frac * mean_prob)
    return out, aux
