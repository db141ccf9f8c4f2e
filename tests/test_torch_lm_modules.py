"""The port's LM building blocks held against the JAX package on the CPU:
the same numpy inputs (and carried weights) through ``repro.models`` and
``repro_torch.models``.

Tolerances: in fp32 every output agrees within ``1e-5 * max|out|`` (the
two frameworks sum matmuls and reductions in other orders; the RG-LRU's
doubling scan adds in another order than ``associative_scan``).  bf16
cases agree within ``2e-2 * max|out|``: bf16 keeps 8 bits, and the two
round at the same places but may differ by an ulp where a sum's order
moves a value across a rounding boundary.  MoE routing is compared
exactly (expert choice and capacity slots): the router's probabilities
from random weights do not tie, and the padded rows, which do tie, take
the lower index in both (``moe.route_top_k`` is ``lax.top_k``'s order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import blockwise as JB
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.models import attention as TA
from repro_torch.models import blockwise as TB
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models.model import params_from_numpy
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _rng(seed: int):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a: np.ndarray, dtype: str = "float32"):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _close(want, got, tol=F32_TOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert want.shape == got.shape, (want.shape, got.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(want - got)))
    assert err <= tol * scale, f"max err {err:.3e} > {tol} * {scale:.3e}"


def _carry(jparams):
    """A JAX parameter tree and its port twin (fp32 carried)."""
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_numpy(nparams)


# ---------------------------------------------------------------------------
# layers: norms, RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norms_match_jax(norm, dtype):
    rng = _rng(0)
    jx, tx = _both(_normal(rng, (3, 5, 24), 2.0) + 0.5, dtype)
    scale, bias = _normal(rng, (24,)) + 1.0, _normal(rng, (24,))
    if norm == "rms":
        p = {"scale": scale}
        want = JL.rmsnorm(p, jx, 1e-6)
        got = TL.rmsnorm(params_from_numpy(p), tx, 1e-6)
    else:
        p = {"scale": scale, "bias": bias}
        want = JL.layernorm(p, jx, 1e-5)
        got = TL.layernorm(params_from_numpy(p), tx, 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    _close(want, got, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_apply_rope_matches_jax(theta, dtype):
    rng = _rng(1)
    jx, tx = _both(_normal(rng, (2, 9, 3, 16)), dtype)
    pos = np.arange(3, 12, dtype=np.int32)
    want = JL.apply_rope(jx, jnp.asarray(pos), theta)
    got = TL.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(want, got, DTYPES[dtype][2])


def test_masks_match_jax():
    for q, k, off, w in [(5, 5, 0, 0), (4, 9, 5, 0), (8, 8, 0, 3)]:
        np.testing.assert_array_equal(
            np.asarray(JL.causal_mask(q, k, q_offset=off, window=w)),
            TL.causal_mask(q, k, q_offset=off, window=w).numpy())
    for idx, w in [(0, 0), (6, 0), (6, 3)]:
        np.testing.assert_array_equal(
            np.asarray(JL.decode_mask(9, idx, window=w)),
            TL.decode_mask(9, idx, window=w).numpy())


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_gqa_attend_matches_jax(masked, groups, dtype):
    rng = _rng(2 + groups)
    b, s, t, nkv, hd = 2, 7, 7, 2, 16
    jq, tq = _both(_normal(rng, (b, s, nkv * groups, hd)), dtype)
    jk, tk = _both(_normal(rng, (b, t, nkv, hd)), dtype)
    jv, tv = _both(_normal(rng, (b, t, nkv, hd)), dtype)
    mask = np.array(JL.causal_mask(s, t, window=3)) if masked else None
    want = JA.gqa_attend(jq, jk, jv, None if mask is None
                         else jnp.asarray(mask))
    got = TA.gqa_attend(tq, tk, tv, None if mask is None
                        else torch.from_numpy(mask))
    assert got.dtype == DTYPES[dtype][1]
    _close(want, got, DTYPES[dtype][2])


@pytest.mark.parametrize("s,t,window,q_offset", [
    (16, 16, 0, 0), (33, 33, 0, 0), (32, 32, 8, 0), (16, 48, 0, 0),
    (8, 24, 0, 16), (13, 29, 5, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax(s, t, window, q_offset, causal):
    """The JAX package's cases (``test_models.py``) and two with a query
    offset; 33 and 13 / 29 pad a block, non-causal takes every block."""
    rng = _rng(s + t)
    b, nq, nkv, hd = 2, 4, 2, 16
    jq, tq = _both(_normal(rng, (b, s, nq, hd)))
    jk, tk = _both(_normal(rng, (b, t, nkv, hd)))
    jv, tv = _both(_normal(rng, (b, t, nkv, hd)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=8,
              kv_block=8)
    _close(JB.blockwise_attention(jq, jk, jv, **kw),
           TB.blockwise_attention(tq, tk, tv, **kw))


def _attn_params(rng, d, nh, nkv, hd, *, qkv_bias=False, qk_norm=False):
    p = JA.init_attention(jax.random.PRNGKey(int(rng.integers(1 << 30))), d,
                          nh, nkv, hd, qkv_bias=qkv_bias, qk_norm=qk_norm)
    if qkv_bias:
        for name in ("wq", "wk", "wv"):
            p[name]["bias"] = jnp.asarray(_normal(rng, p[name]["bias"].shape,
                                                  0.1))
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name]["scale"] = jnp.asarray(
                _normal(rng, p[name]["scale"].shape, 0.1) + 1.0)
    return _carry(p)


@pytest.mark.parametrize("rolling,cache_len,steps", [
    (False, 9, 9), (True, 5, 12)])
@pytest.mark.parametrize("variant", ["plain", "qk_norm+bias"])
def test_decode_attention_matches_jax(variant, rolling, cache_len, steps):
    """Token after token through the KV cache; the rolling cache wraps
    more than twice. The port writes its cache in place; JAX returns a
    new one — both are carried on, and compared after every step."""
    rng = _rng(7)
    d, nh, nkv, hd, b = 32, 4, 2, 8, 2
    flags = dict(qkv_bias=True, qk_norm=True) if variant != "plain" else {}
    jp, tp = _attn_params(rng, d, nh, nkv, hd, **flags)
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=hd,
              rope_theta=10_000.0, rolling=rolling)
    jc = JA.init_kv_cache(b, cache_len, nkv, hd, jnp.float32)
    tc = TA.init_kv_cache(b, cache_len, nkv, hd, torch.float32)
    for i in range(steps):
        jx, tx = _both(_normal(rng, (b, 1, d)))
        want, jc = JA.decode_attention(jp, jx, jc, jnp.int32(i), **kw)
        got, tc = TA.decode_attention(tp, tx, tc, i, **kw)
        _close(want, got)
        _close(jc["k"], tc["k"])
        _close(jc["v"], tc["v"])


def test_decode_attention_refuses_a_position_past_the_cache():
    rng = _rng(8)
    _, tp = _attn_params(rng, 16, 2, 1, 8)
    tc = TA.init_kv_cache(1, 3, 1, 8, torch.float32)
    with pytest.raises(IndexError, match="rolling=True"):
        TA.decode_attention(tp, torch.zeros(1, 1, 16), tc, 3, num_heads=2,
                            num_kv_heads=1, head_dim=8)


@pytest.mark.parametrize("s,t", [(6, 11), (1100, 20)])
def test_cross_attention_matches_jax(s, t):
    """At most 1024 queries through ``gqa_attend``; more through the
    blockwise route (three 512-query blocks, the last padded)."""
    rng = _rng(9)
    d, nh, nkv, hd, b = 16, 4, 2, 4, 1
    jp, tp = _attn_params(rng, d, nh, nkv, hd)
    jx, tx = _both(_normal(rng, (b, s, d)))
    jm, tm = _both(_normal(rng, (b, t, d)))
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=hd)
    _close(JA.cross_attention(jp, jx, jm, **kw),
           TA.cross_attention(tp, tx, tm, **kw))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(n_tokens, dtype="float32", e=4, d=16, f=24, seed=10):
    rng = _rng(seed)
    jp, tp = _carry(JM.init_moe(jax.random.PRNGKey(seed), d, f, e))
    jx, tx = _both(_normal(rng, (2, n_tokens // 2, d)), dtype)
    return jp, tp, jx, tx


@pytest.mark.parametrize("case", [
    # (tokens, top_k, no_drop, group_size): capacity from cf (g > 64,
    # tokens dropped), no_drop, the tiny-group floor (g <= 64), and
    # groups padded with all-zero rows whose probabilities tie
    (96, 2, False, 2048), (96, 1, False, 2048), (96, 2, True, 2048),
    (40, 2, False, 2048), (96, 2, False, 40), (96, 1, True, 40)])
def test_moe_ffn_matches_jax(case):
    n, k, no_drop, group = case
    jp, tp, jx, tx = _moe_case(n)
    kw = dict(num_experts=4, top_k=k, capacity_factor=1.25,
              group_size=group, no_drop=no_drop)
    jout, jaux = JM.moe_ffn(jp, jx, **kw)
    tout, taux = TM.moe_ffn(tp, tx, **kw)
    _close(jout, tout)
    assert abs(float(jaux) - float(taux)) <= F32_TOL * abs(float(jaux))


def test_moe_ffn_bf16_matches_jax():
    jp, tp, jx, tx = _moe_case(32, "bfloat16")
    kw = dict(num_experts=4, top_k=2, no_drop=True)
    jout, jaux = JM.moe_ffn(jp, jx, **kw)
    tout, taux = TM.moe_ffn(tp, tx, **kw)
    assert tout.dtype == torch.bfloat16
    _close(jout, tout, BF16_TOL)
    assert abs(float(jaux) - float(taux)) <= F32_TOL * abs(float(jaux))


def test_route_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    jw, jidx = jax.lax.top_k(jnp.asarray(probs), 2)
    tw, tidx = TM.route_top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(np.asarray(jidx), tidx.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(11, 4), (8, 8), (5, 16)])
def test_ssd_chunked_matches_jax(s, chunk):
    """S not a multiple of the chunk pads the last chunk (11 / 4), one
    chunk exactly, and a chunk longer than S."""
    rng = _rng(11)
    b, h, p, n = 2, 3, 8, 6
    jx, tx = _both(_normal(rng, (b, s, h, p)))
    jdt, tdt = _both(np.abs(_normal(rng, (b, s, h), 0.5)))
    ja, ta = _both(np.log(np.linspace(1.0, 4.0, h)).astype(np.float32))
    jb, tb = _both(_normal(rng, (b, s, n)))
    jc, tc = _both(_normal(rng, (b, s, n)))
    jy, jst = JS.ssd_chunked(jx, jdt, ja, jb, jc, chunk=chunk)
    ty, tst = TS.ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk)
    _close(jy, ty)
    _close(jst, tst)


def _mamba_params(seed, d=64, n=16):
    jp = JS.init_mamba2(jax.random.PRNGKey(seed), d, n)
    rng = _rng(seed)
    jp["dt_bias"] = jnp.asarray(_normal(rng, jp["dt_bias"].shape, 0.5))
    jp["conv"]["bias"] = jnp.asarray(_normal(rng, jp["conv"]["bias"].shape,
                                             0.1))
    return _carry(jp)


@pytest.mark.parametrize("s", [2, 9])
def test_mamba2_forward_state_and_decode_match_jax(s):
    """``want_state`` (S below and above the conv width) hands off to
    three decode steps; outputs and both state halves are compared
    after each."""
    d, n = 64, 16
    jp, tp = _mamba_params(12, d, n)
    rng = _rng(13)
    jx, tx = _both(_normal(rng, (2, s, d)))
    jy, jst = JS.mamba2_forward(jp, jx, d_state=n, chunk=4, want_state=True)
    ty, tst = TS.mamba2_forward(tp, tx, d_state=n, chunk=4, want_state=True)
    _close(jy, ty)
    for key in ("ssm", "conv"):
        _close(jst[key], tst[key])
    for _ in range(3):
        jx, tx = _both(_normal(rng, (2, 1, d)))
        jy, jst = JS.mamba2_decode_step(jp, jx, jst, d_state=n)
        ty, tst = TS.mamba2_decode_step(tp, tx, tst, d_state=n)
        _close(jy, ty)
        for key in ("ssm", "conv"):
            _close(jst[key], tst[key])


# ---------------------------------------------------------------------------
# RG-LRU and the recurrent block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7, 16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_forward_matches_jax(with_h0, s):
    rng = _rng(14)
    w = 24
    jp, tp = _carry(JR.init_rglru(jax.random.PRNGKey(14), w))
    jx, tx = _both(_normal(rng, (2, s, w)))
    jh, th = _both(_normal(rng, (2, w)))
    jy, jhf = JR.rglru_forward(jp, jx, jh if with_h0 else None)
    ty, thf = TR.rglru_forward(tp, tx, th if with_h0 else None)
    _close(jy, ty)
    _close(jhf, thf)


def test_linear_scan_matches_the_recurrence():
    rng = _rng(15)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 5)).astype(np.float32))
    b = torch.from_numpy(_normal(rng, (2, 13, 5)))
    h, want = torch.zeros(2, 5), []
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(torch.stack(want, 1).numpy(), TR.linear_scan(a, b))


def test_recurrent_block_forward_and_decode_match_jax():
    d, w = 32, 32
    jp = JR.init_recurrent_block(jax.random.PRNGKey(16), d, w)
    jp["conv"]["bias"] = jnp.asarray(_normal(_rng(16), (w,), 0.1))
    jp, tp = _carry(jp)
    rng = _rng(17)
    jx, tx = _both(_normal(rng, (2, 6, d)))
    jy, jst = JR.recurrent_block_forward(jp, jx, want_state=True)
    ty, tst = TR.recurrent_block_forward(tp, tx, want_state=True)
    _close(jy, ty)
    for key in ("h", "conv"):
        _close(jst[key], tst[key])
    # a carried state folds into the next chunk's first step
    jx, tx = _both(_normal(rng, (2, 3, d)))
    _close(JR.recurrent_block_forward(jp, jx, jst)[0],
           TR.recurrent_block_forward(tp, tx, tst)[0])
    for _ in range(3):
        jx, tx = _both(_normal(rng, (2, 1, d)))
        jy, jst = JR.recurrent_block_decode(jp, jx, jst)
        ty, tst = TR.recurrent_block_decode(tp, tx, tst)
        _close(jy, ty)
        for key in ("h", "conv"):
            _close(jst[key], tst[key])


def test_lm_init_draws_on_the_generators_device_or_meta():
    """``device="meta"`` makes the shapes with no draw; the CPU stream
    draws the same values whatever the call's ``device`` spelling."""
    gen = torch.Generator().manual_seed(0)
    meta = TA.init_attention(gen, 16, 2, 1, 8, device="meta")
    assert all(t.is_meta for t in tree_leaves(meta))
    a = TA.init_attention(torch.Generator().manual_seed(3), 16, 2, 1, 8)
    b = TA.init_attention(torch.Generator().manual_seed(3), 16, 2, 1, 8,
                          device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
