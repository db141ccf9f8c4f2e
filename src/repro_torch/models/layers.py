"""Functional building blocks over plain dicts of tensors.

Conventions follow the JAX package: ``init_*`` functions take an
explicit ``torch.Generator`` first and return a dict of fp32 tensors in
the JAX layouts (dense kernels ``[in, out]``); apply functions take
``(params, x)`` and cast parameters to the activation dtype per op.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def truncated_normal_init(gen: torch.Generator, shape, stddev,
                          dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * stddev).to(dtype)


def lecun_init(gen, shape, fan_in: Optional[int] = None,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return truncated_normal_init(gen, shape,
                                 1.0 / math.sqrt(max(fan_in, 1)), dtype)


def he_init(gen, shape, fan_in: Optional[int] = None,
            dtype=torch.float32) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else math.prod(shape[:-1])
    return truncated_normal_init(gen, shape,
                                 math.sqrt(2.0 / max(fan_in, 1)), dtype)


def init_dense(gen, in_dim: int, out_dim: int, *, bias: bool = False,
               dtype=torch.float32):
    p = {"kernel": lecun_init(gen, (in_dim, out_dim), in_dim, dtype)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype)
    return p


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y
