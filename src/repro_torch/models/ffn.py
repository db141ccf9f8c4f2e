"""Feed-forward blocks: gated (SwiGLU-style) and plain MLP."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.sharding import shard_act


def init_gated_ffn(gen, d_model: int, d_ff: int, dtype=torch.float32,
                   device=None):
    return {
        "wi_gate": L.init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
        "wi_up": L.init_dense(gen, d_model, d_ff, dtype=dtype, device=device),
        "wo": L.init_dense(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def gated_ffn(params, x: torch.Tensor, act_name: str = "silu"):
    act = L.activation(act_name)
    gate = act(shard_act(L.dense(params["wi_gate"], x), "btf"))
    up = shard_act(L.dense(params["wi_up"], x), "btf")
    return L.dense(params["wo"], gate * up)


def init_mlp(gen, d_model: int, d_ff: int, *, bias: bool = True,
             dtype=torch.float32, device=None):
    return {
        "wi": L.init_dense(gen, d_model, d_ff, bias=bias, dtype=dtype,
                           device=device),
        "wo": L.init_dense(gen, d_ff, d_model, bias=bias, dtype=dtype,
                           device=device),
    }


def mlp(params, x: torch.Tensor, act_name: str = "gelu"):
    act = L.activation(act_name)
    return L.dense(params["wo"], act(shard_act(L.dense(params["wi"], x),
                                               "btf")))
