"""RG-LRU recurrent block (RecurrentGemma / Griffin). [arXiv:2402.19427]

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  (diagonal decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sequence forward runs the recurrence as a log-step doubling scan
(Hillis-Steele, the JAX package's ``combine``): ceil(log2 S) elementwise
passes over [B, S, W] in fp32.  It adds in another order than JAX's
``associative_scan``, so the two agree to fp32 rounding, not bit for bit.
Decode is a single constant-size state update.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.ssm import causal_conv
from repro_torch.sharding import einsum

_C = 8.0


def init_rglru(gen, width: int, dtype=torch.float32, device=None):
    # Lambda init so a^c spans ~[0.9, 0.999]
    lam = L.uniform_init(gen, (width,), 0.0001, 0.1, device)
    return {
        "lambda_param": torch.log(torch.expm1(lam)).to(dtype),  # inv softplus
        "w_a": L.init_dense(gen, width, width, bias=True, dtype=dtype,
                            device=device),
        "w_x": L.init_dense(gen, width, width, bias=True, dtype=dtype,
                            device=device),
    }


def _gates(params, x):
    r = torch.sigmoid(L.dense(params["w_a"], x).float())
    i = torch.sigmoid(L.dense(params["w_x"], x).float())
    lam = F.softplus(params["lambda_param"].float())
    log_a = -_C * lam * r                       # [B,S,W], <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                         1e-12)) * (i * x.float())
    return a, gated_x


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 from h_{-1} = 0, by
    doubling: after the pass at shift d every (a, b) spans 2d steps."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]],
                      dim=1)
        a = torch.cat([a[:, :shift], a_prev * a[:, shift:]], dim=1)
        shift *= 2
    return b


def rglru_forward(params, x, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,W] -> (y [B,S,W], h_final [B,W])."""
    a, b = _gates(params, x)
    if h0 is not None:
        # fold the carried state into the first step's additive term
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1, :].to(x.dtype)


def rglru_decode_step(params, x, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,1,W], h: [B,W] -> (y [B,1,W], h')."""
    a, b = _gates(params, x)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(x.dtype)[:, None, :], h_new.to(x.dtype)


# ---------------------------------------------------------------------------
# Griffin recurrent block: conv + RG-LRU + GeLU gate branch
# ---------------------------------------------------------------------------

def init_recurrent_block(gen, d_model: int, width: int, *,
                         conv_width: int = 4, dtype=torch.float32,
                         device=None):
    device = L.init_device(gen, device)
    return {
        "in_rec": L.init_dense(gen, d_model, width, dtype=dtype,
                               device=device),
        "in_gate": L.init_dense(gen, d_model, width, dtype=dtype,
                                device=device),
        "conv": {"kernel": L.lecun_init(gen, (conv_width, width), conv_width,
                                        dtype, device),
                 "bias": torch.zeros((width,), dtype=dtype, device=device)},
        "rglru": init_rglru(gen, width, dtype, device),
        "out": L.init_dense(gen, width, d_model, dtype=dtype, device=device),
    }


def recurrent_block_forward(params, x, state=None, *,
                            want_state: bool = False):
    """x: [B,S,D] -> (y [B,S,D], decode_state {h, conv} | None)."""
    gelu = L.activation("gelu")
    pre = L.dense(params["in_rec"], x)
    rec = causal_conv(params["conv"], pre)
    gate = gelu(L.dense(params["in_gate"], x))
    h0 = state["h"] if state is not None else None
    rec, h_final = rglru_forward(params["rglru"], rec, h0)
    y = L.dense(params["out"], rec * gate)
    if not (want_state or state is not None):
        return y, None
    width = params["conv"]["kernel"].shape[0]
    if x.shape[1] < width - 1:
        pre = F.pad(pre, (0, 0, width - 1 - x.shape[1], 0))
    conv_tail = pre[:, pre.shape[1] - (width - 1):, :]
    return y, {"h": h_final, "conv": conv_tail}


def init_recurrent_state(batch: int, width: int, *, conv_width: int = 4,
                         dtype=torch.bfloat16, device=None):
    return {
        "h": torch.zeros((batch, width), dtype=dtype, device=device),
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                            device=device),
    }


def recurrent_block_decode(params, x, state):
    """One-token decode. x: [B,1,D]; returns a new state."""
    gelu = L.activation("gelu")
    pre = L.dense(params["in_rec"], x)                       # [B,1,W]
    window = torch.cat([state["conv"], pre], dim=1)          # [B,W_c,W]
    w = params["conv"]["kernel"].to(x.dtype)
    rec = einsum("bwc,wc->bc", window, w) + \
        params["conv"]["bias"].to(x.dtype)
    rec = rec[:, None, :]
    gate = gelu(L.dense(params["in_gate"], x))
    rec, h_new = rglru_decode_step(params["rglru"], rec, state["h"])
    y = L.dense(params["out"], rec * gate)
    return y, {"h": h_new, "conv": window[:, 1:, :]}
