"""Mamba-2 (SSD — state-space duality) block. [arXiv:2405.21060]

Chunk-parallel SSD algorithm: within a chunk the quadratic
(attention-dual) form runs as matmuls; across chunks a linear recurrence
over per-chunk states runs as a loop.  Decode keeps a constant-size
state [B, H, N, P].

ngroups = 1 (B/C shared across heads), headdim P = 64, as in mamba2-130m.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import (conv_on_shards, cumsum, einsum,
                                  factory_like, on_shards, reshape,
                                  whole_dims)

HEADDIM = 64


def init_mamba2(gen, d_model: int, d_state: int, *, expand: int = 2,
                conv_width: int = 4, dtype=torch.float32, device=None):
    device = L.init_device(gen, device)
    d_inner = expand * d_model
    nheads = d_inner // HEADDIM
    conv_ch = d_inner + 2 * d_state  # x, B, C all pass the causal conv
    a = torch.linspace(1.0, 16.0, nheads, device=device).to(dtype)
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": L.init_dense(gen, d_model,
                                2 * d_inner + 2 * d_state + nheads,
                                dtype=dtype, device=device),
        "conv": {"kernel": L.lecun_init(gen, (conv_width, conv_ch),
                                        conv_width, dtype, device),
                 "bias": torch.zeros((conv_ch,), dtype=dtype, device=device)},
        "a_log": torch.log(a),
        "dt_bias": torch.zeros((nheads,), dtype=dtype, device=device),
        "d_skip": torch.ones((nheads,), dtype=dtype, device=device),
        "norm": L.init_rmsnorm(d_inner, dtype, device),
        "out_proj": L.init_dense(gen, d_inner, d_model, dtype=dtype,
                                 device=device),
    }


def _split_proj(zxbcdt, d_inner: int, d_state: int, nheads: int):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    b = zxbcdt[..., 2 * d_inner:2 * d_inner + d_state]
    c = zxbcdt[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    return z, x, b, c, dt


def causal_conv(params, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. u: [B, S, C]; the taps summed in order.
    Under an in-node layout each rank convolves its shards, the sequence
    whole (:func:`repro_torch.sharding.conv_on_shards`)."""
    if on_shards(u):
        return conv_on_shards(causal_conv, params, u)
    w = params["kernel"].to(u.dtype)      # [W, C]
    width, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + params["bias"].to(u.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., Q] -> [..., Q, Q] lower-tri cumulative sums (exclusive)."""
    q = a.shape[-1]
    cs = cumsum(a, dim=-1)
    # segsum[l, s] = sum_{s < r <= l} a_r  = cs[l] - cs[s]
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x, dt, a_log, b, c, *, chunk: int):
    """SSD core.

    x: [B,S,H,P]  dt: [B,S,H]  a_log: [H] (A = -exp(a_log))
    b, c: [B,S,N]  (ngroups=1, broadcast over heads)
    Returns y: [B,S,H,P] and final state [B,H,N,P].
    """
    B_, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    S_p = x.shape[1]
    nc = S_p // Q

    A = -torch.exp(a_log.float())                            # [H]
    da = dt.float() * A                                      # [B,S,H] (<=0)
    xd = x * dt[..., None].to(x.dtype)

    # chunk views
    xc = reshape(xd, (B_, nc, Q, H, P))
    dac = reshape(da, (B_, nc, Q, H)).permute(0, 1, 3, 2)   # [B,nc,H,Q]
    bc = reshape(b, (B_, nc, Q, N))
    cc = reshape(c, (B_, nc, Q, N))

    # 1. intra-chunk (attention-dual) term
    Lmat = torch.exp(_segsum(dac))                           # [B,nc,H,Q,Q]
    scores = einsum("bzln,bzsn->bzls", cc.float(), bc.float())
    att = scores[:, :, None] * Lmat                          # [B,nc,H,Q,Q]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    att = torch.where(tri, att, 0.0)
    y_diag = einsum("bzhls,bzshp->bzlhp", att.to(x.dtype), xc)

    # 2. per-chunk final states
    cum = cumsum(dac, dim=-1)                                # [B,nc,H,Q]
    decay_states = torch.exp(cum[..., -1:] - cum)            # [B,nc,H,Q]
    states = einsum("bzsn,bzhs,bzshp->bzhnp",
                          bc, decay_states.to(x.dtype), xc)  # [B,nc,H,N,P]

    # 3. inter-chunk recurrence (a loop over chunks; under a layout the
    # chunks whole on each rank, gathered once, not once a step)
    states = whole_dims(states, (1,))
    chunk_decay = whole_dims(torch.exp(cum[..., -1]), (1,))  # [B,nc,H]
    s = factory_like(lambda sh: torch.zeros(sh, dtype=x.dtype,
                                            device=x.device),
                     (B_, H, N, P), states, (0, 2, 3, 4))
    prev = []
    for z in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, z, :, None, None].to(s.dtype) + states[:, z]
    prev_states = torch.stack(prev, dim=1)                   # [B,nc,H,N,P]

    # 4. inter-chunk contribution: C_t @ state_in * exp(cum_t)
    state_decay = torch.exp(cum)                             # [B,nc,H,Q]
    y_off = einsum("bzln,bzhnp,bzhl->bzlhp",
                         cc, prev_states, state_decay.to(x.dtype))
    y = reshape(y_diag + y_off, (B_, S_p, H, P))
    return y[:, :S], s


def mamba2_forward(params, x, *, d_state: int, chunk: int = 128,
                   want_state: bool = False):
    """Full-sequence forward. x: [B,S,D] -> (y [B,S,D], decode_state|None).

    ``want_state=True`` returns the decode-compatible state dict
    ({"ssm": [B,H,N,P], "conv": [B,W-1,C]}) so prefill can hand off to
    :func:`mamba2_decode_step`.
    """
    B_, S, D = x.shape
    d_inner = params["norm"]["scale"].shape[0]
    nheads = params["a_log"].shape[0]
    z, xi, b, c, dt = _split_proj(L.dense(params["in_proj"], x),
                                  d_inner, d_state, nheads)
    conv_in = torch.cat([xi, b, c], dim=-1)
    conv_out = F.silu(causal_conv(params["conv"], conv_in))
    xi = conv_out[..., :d_inner]
    b = conv_out[..., d_inner:d_inner + d_state]
    c = conv_out[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    xh = reshape(xi, (B_, S, nheads, HEADDIM))
    y, state = ssd_chunked(xh, dt, params["a_log"], b, c, chunk=chunk)
    y = y + params["d_skip"].to(x.dtype)[None, None, :, None] * xh
    y = reshape(y, (B_, S, d_inner))
    y = L.rmsnorm(params["norm"], y * F.silu(z))
    out = L.dense(params["out_proj"], y)
    if not want_state:
        return out, None
    width = params["conv"]["kernel"].shape[0]
    if S < width - 1:
        conv_in = F.pad(conv_in, (0, 0, width - 1 - S, 0))
    conv_tail = conv_in[:, conv_in.shape[1] - (width - 1):, :]
    return out, {"ssm": state, "conv": conv_tail}


def init_mamba2_state(batch: int, d_model: int, d_state: int, *,
                      expand: int = 2, conv_width: int = 4,
                      dtype=torch.bfloat16, device=None):
    d_inner = expand * d_model
    nheads = d_inner // HEADDIM
    conv_ch = d_inner + 2 * d_state
    return {
        "ssm": torch.zeros((batch, nheads, d_state, HEADDIM), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba2_decode_step(params, x, state, *, d_state: int):
    """One-token decode. x: [B,1,D]; constant-size state (a new one is
    returned; ``state`` is left as it was)."""
    B_ = x.shape[0]
    d_inner = params["norm"]["scale"].shape[0]
    nheads = params["a_log"].shape[0]
    z, xi, b, c, dt = _split_proj(L.dense(params["in_proj"], x),
                                  d_inner, d_state, nheads)
    conv_in = torch.cat([xi, b, c], dim=-1)                  # [B,1,C]
    window = torch.cat([state["conv"], conv_in], dim=1)      # [B,W,C]
    w = params["conv"]["kernel"].to(x.dtype)
    conv_out = einsum("bwc,wc->bc", window, w) + \
        params["conv"]["bias"].to(x.dtype)
    conv_out = F.silu(conv_out)[:, None, :]
    new_conv = window[:, 1:, :]
    xi = conv_out[..., :d_inner]
    b = conv_out[..., d_inner:d_inner + d_state]
    c = conv_out[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + params["dt_bias"].float())  # [B,1,H]
    A = -torch.exp(params["a_log"].float())
    da = torch.exp(dt[:, 0] * A)                             # [B,H]
    xh = reshape(xi, (B_, nheads, HEADDIM))
    s = state["ssm"]
    s = s * da[..., None, None].to(s.dtype) + \
        einsum("bn,bhp,bh->bhnp", b[:, 0], xh, dt[:, 0].to(x.dtype))
    y = einsum("bn,bhnp->bhp", c[:, 0], s)
    y = y + params["d_skip"].to(x.dtype)[None, :, None] * xh
    y = reshape(y, (B_, 1, d_inner))
    y = L.rmsnorm(params["norm"], y * F.silu(z))
    out = L.dense(params["out_proj"], y)
    return out, {"ssm": s, "conv": new_conv}
