"""The port's kernels, held against the JAX package's on the CPU.

Each plain PyTorch version (what a CPU tensor runs; what the CUDA kernel
is held to on the card by ``chip_smoke.py``) gets the same numpy inputs
as the JAX Pallas kernel run in interpret mode and as the JAX ``ref.py``.
Tolerances: adamw against the JAX ``ref.py``, row maxima and codes
exact; proto sums ``rtol=1e-6`` (einsum and kernel sum in different
orders), counts exact.  The interpret-mode adamw Pallas kernel is not
bit-identical even to the JAX ``ref.py``: XLA:CPU contracts its moment
EMAs ``b*m + (1-b)*g`` into fused multiply-adds, while the JAX ref, the
plain version and the CUDA kernel round the products first.  Against it
the moments are held to one ulp of the larger term and the parameters
to ``4e-8`` (that last-bit change carried through the step of size lr).

The mesh exchange's wire byte codec (``encode_wire``/``decode_wire``,
``nibble_pack``) and ``wire_buffer_bytes`` are bit-exact against the
JAX package's.  ``mix_packed``'s plain version rounds every product and
sum on its own, in the Pallas body's order; the interpret-mode
``mix_packed_pallas`` is held bit-exactly to the arithmetic XLA:CPU
gives it: the self term and the first sender's term contracted into
one FMA, ``fma(w_self, own, w_0·deq_0)``, then ``fma(w_j, deq_j, acc)``
per further sender (each FMA emulated in float64 and rounded once).
With one sender at weight one in the accumulate form that arithmetic
is the plain one, and the two are bit-identical.

The mixed-width and error-feedback codec: row maxima, codes and scales
are bit-exact against the interpret-mode Pallas kernels and against an
eager (un-jitted) ``repro`` ``quantize_packed_buffer(use_kernels=False)``;
the new residual is bit-exact against the eager call.  The
interpret-mode ``quantize_rows_ef_pallas`` contracts both multiply-adds
(``x + decay·res`` and ``eff - codes·Δ``) into FMAs, so its residual is
held bit-exactly to that arithmetic instead: the same terms in float64,
each FMA rounded once to fp32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.opt_update.opt_update import (adafactor_apply_pallas,
                                                 adamw_update_pallas,
                                                 sgd_update_pallas)
from repro.kernels.opt_update.ref import adafactor_apply_ref as jax_ada_ref
from repro.kernels.opt_update.ref import adamw_update_ref as jax_adamw_ref
from repro.kernels.opt_update.ref import sgd_update_ref as jax_sgd_ref
from repro.kernels.proto_accum.ops import \
    proto_accumulate_nodes as jax_proto_nodes
from repro.kernels.proto_accum.ref import proto_accum_ref as jax_proto_ref
from repro import wirespec as jwire
from repro.config import base as jbase
from repro.kernels.quantize import ops as jqops
from repro.kernels.quantize.quantize import (mix_packed_pallas,
                                             quantize_rows_ef_pallas,
                                             quantize_rows_mixed_pallas,
                                             quantize_rows_pallas,
                                             rowabs_pallas,
                                             rowabs_sum_pallas)
from repro.models import model as jmodel
from repro.optim import plane as jplane
from repro_torch import wirespec as twire
from repro_torch.kernels import build
from repro_torch.kernels.opt_update.ops import (fused_adafactor_update,
                                                fused_adamw_update,
                                                fused_sgd_update)
from repro_torch.kernels.opt_update.opt_update import (adafactor_apply_cuda,
                                                       adamw_update_cuda,
                                                       sgd_update_cuda)
from repro_torch.kernels.opt_update.ref import (adafactor_apply_ref,
                                                adamw_update_ref,
                                                sgd_update_ref)
from repro_torch.kernels.proto_accum.ops import proto_accumulate_nodes
from repro_torch.kernels.proto_accum.proto_accum import proto_accum_cuda
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize.ops import (quantize_rows,
                                              quantize_rows_ef,
                                              quantize_rows_mixed, rowabs,
                                              rowabs_sum)
from repro_torch.kernels.quantize.quantize import (mix_packed_cuda,
                                                   quantize_rows_cuda,
                                                   quantize_rows_ef_cuda,
                                                   quantize_rows_mixed_cuda,
                                                   rowabs_cuda,
                                                   rowabs_sum_cuda)
from repro_torch.models import model as tmodel
from repro_torch.optim import plane as tplane

torch.set_num_threads(2)

HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


def _adamw_inputs(seed, n=3, r=16, c=512):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((n, r, c)) * 1e-2).astype(np.float32)
    g[:, :, -7:] = 0.0                        # plane padding lanes
    g[0, 0, :5] = [1e-9, -1e-9, 1e-12, 0.0, 3e-8]   # |g| near eps
    p = (rng.standard_normal((n, r, c)) * 0.1).astype(np.float32)
    p[:, :, -7:] = 0.0
    mu = (rng.standard_normal((n, r, c)) * 1e-3).astype(np.float32)
    nu = (rng.random((n, r, c)) * 1e-5).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return g, p, mu, nu, scale


@pytest.mark.parametrize("step", [1, 7])
def test_adamw_plain_matches_jax_kernel_and_ref(step):
    g, p, mu, nu, scale = _adamw_inputs(step)
    lr = np.float32(1e-3)
    bc1 = np.float32(1.0) - np.float32(0.9) ** np.float32(step)
    bc2 = np.float32(1.0) - np.float32(0.999) ** np.float32(step)
    t = torch.from_numpy
    got = adamw_update_ref(t(g), t(p), t(mu), t(nu), lr=t(np.array(lr)),
                           scale=t(scale), bc1=t(np.array(bc1)),
                           bc2=t(np.array(bc2)), **HP)
    s11 = lambda x: jnp.full((1, 1), x, jnp.float32)  # noqa: E731
    ulp = np.float32(2.0 ** -23)
    for i in range(g.shape[0]):
        ref = jax_adamw_ref(g[i], p[i], mu[i], nu[i], lr=lr, scale=scale[i],
                            bc1=bc1, bc2=bc2, **HP)
        for ours, b in zip(got, ref):
            np.testing.assert_array_equal(ours[i].numpy(), np.asarray(b))
        pallas = adamw_update_pallas(
            g[i], p[i], mu[i], nu[i], s11(lr), s11(scale[i]), s11(bc1),
            s11(bc2), interpret=True, **HP)
        g32 = g[i] * scale[i]
        terms = (np.abs(np.float32(0.9) * mu[i]) + np.abs(0.1 * g32),
                 np.abs(np.float32(0.999) * nu[i]) + np.abs(1e-3 * g32 * g32))
        for k in (1, 2):
            diff = np.abs(got[k][i].numpy() - np.asarray(pallas[k]))
            assert np.all(diff <= ulp * terms[k - 1])
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(pallas[0]),
                                   rtol=0, atol=4e-8)
    # padding lanes (g = 0, p = 0, mu = 0, nu = 0) stay a fixed point
    pad = (t(g)[..., -7:], t(p)[..., -7:], t(mu)[..., -7:] * 0,
           t(nu)[..., -7:] * 0)
    out = adamw_update_ref(*pad, lr=t(np.array(lr)), scale=t(scale),
                           bc1=t(np.array(bc1)), bc2=t(np.array(bc2)), **HP)
    assert all(float(o.abs().max()) == 0.0 for o in out)


def test_fused_adamw_update_cpu_dispatch_is_in_place_plain():
    g, p, mu, nu, scale = _adamw_inputs(3)
    t = torch.from_numpy
    args = dict(lr=torch.tensor(1e-3), scale=t(scale),
                bc1=torch.tensor(0.1), bc2=torch.tensor(0.001))
    want = adamw_update_ref(t(g), t(p), t(mu), t(nu), **args, **HP)
    pp, mm, vv = t(p.copy()), t(mu.copy()), t(nu.copy())
    fused_adamw_update(t(g), pp, mm, vv, args["lr"], args["scale"],
                       args["bc1"], args["bc2"], **HP)
    for a, b in zip((pp, mm, vv), want):
        assert torch.equal(a, b)


SGD_HP = dict(momentum=0.9, weight_decay=0.01)


def _fma(a, b, c):
    """``a·b + c`` rounded once to fp32 (an FMA; the product of two fp32
    values is exact in float64)."""
    return (np.float64(a) * b + c).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_sgd_plain_matches_jax_kernel_and_ref(seed):
    g, p, mu, _, scale = _adamw_inputs(seed)
    lr = np.float32(1e-3)
    t = torch.from_numpy
    got = sgd_update_ref(t(g), t(p), t(mu), lr=t(np.array(lr)),
                         scale=t(scale), **SGD_HP)
    s11 = lambda x: jnp.full((1, 1), x, jnp.float32)  # noqa: E731
    ulp = np.float32(2.0 ** -23)
    m32, wd32 = np.float32(0.9), np.float32(0.01)
    for i in range(g.shape[0]):
        ref = jax_sgd_ref(g[i], p[i], mu[i], lr=lr, scale=scale[i], **SGD_HP)
        for ours, b in zip(got, ref):
            assert ours[i].numpy().tobytes() == np.asarray(b).tobytes()
        pallas = [np.asarray(x) for x in sgd_update_pallas(
            g[i], p[i], mu[i], s11(lr), s11(scale[i]), interpret=True,
            **SGD_HP)]
        g32 = (g[i] * scale[i]).astype(np.float32)
        m = _fma(m32, mu[i], g32)
        newp = _fma(-lr, _fma(wd32, p[i], m), p[i])
        np.testing.assert_array_equal(pallas[1], m)
        np.testing.assert_array_equal(pallas[0], newp)
        diff = np.abs(got[1][i].numpy() - pallas[1])
        assert np.all(diff <= ulp * (np.abs(m32 * mu[i]) + np.abs(g32)))
    # padding lanes (g = 0, p = 0, mu = 0) stay a fixed point
    z = torch.zeros((3, 2, 512))
    out = sgd_update_ref(z, z, z, lr=t(np.array(lr)), scale=t(scale),
                         **SGD_HP)
    assert all(float(o.abs().max()) == 0.0 for o in out)


def test_adafactor_apply_plain_matches_jax_kernel_and_ref():
    rng = np.random.default_rng(5)
    upd = rng.standard_normal((3, 16, 512)).astype(np.float32)
    p = (rng.standard_normal((3, 16, 512)) * 0.1).astype(np.float32)
    upd[:, :, -7:] = p[:, :, -7:] = 0.0       # plane padding lanes
    lr = np.float32(1e-3)
    got = adafactor_apply_ref(torch.from_numpy(upd), torch.from_numpy(p),
                              lr=torch.tensor(lr), weight_decay=0.01)
    assert not got[:, :, -7:].any()
    for i in range(3):
        ref = jax_ada_ref(upd[i], p[i], lr=lr, weight_decay=0.01)
        assert got[i].numpy().tobytes() == np.asarray(ref).tobytes()
        pallas = adafactor_apply_pallas(upd[i], p[i],
                                        jnp.full((1, 1), lr, jnp.float32),
                                        weight_decay=0.01, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(pallas),
            _fma(-lr, _fma(np.float32(0.01), p[i], upd[i]), p[i]))


def test_fused_sgd_and_adafactor_cpu_dispatch_is_in_place_plain():
    g, p, mu, _, scale = _adamw_inputs(4)
    t = torch.from_numpy
    lr = torch.tensor(1e-3)
    want = sgd_update_ref(t(g), t(p), t(mu), lr=lr, scale=t(scale),
                          **SGD_HP)
    pp, mm = t(p.copy()), t(mu.copy())
    fused_sgd_update(t(g), pp, mm, lr, t(scale), **SGD_HP)
    assert torch.equal(pp, want[0]) and torch.equal(mm, want[1])
    # adafactor: one dense segment of 5 values at row 0, zero elsewhere
    recipe = (("leaf", ("b",), (5,), 0, 1),)
    pp = t(p.copy())
    pp[:, 1:] = 0.0
    pp[:, 0, 5:] = 0.0
    before = pp.clone()
    fac = ({"v": torch.zeros((3, 5))},)
    new = fused_adafactor_update(t(g), pp, fac, lr, t(scale),
                                 torch.tensor(0.5), recipe=recipe,
                                 weight_decay=0.01)
    assert new[0]["v"].shape == (3, 5) and float(new[0]["v"].min()) > 0
    assert torch.equal(pp[:, :, 5:], before[:, :, 5:])   # padding stays 0
    assert not torch.equal(pp[:, 0, :5], before[:, 0, :5])


def _proto_inputs(seed, n=3, b=20, p=24, c=5):
    rng = np.random.default_rng(seed)
    f1 = np.maximum(rng.standard_normal((n, b, p)), 0).astype(np.float32)
    labels = rng.integers(0, c, (n, b)).astype(np.int32)
    labels[0, :3] = [c, c + 4, -1]            # match no class
    return f1, labels, c


@pytest.mark.parametrize("seed", [0, 1])
def test_proto_accum_plain_matches_jax_kernel_and_ref(seed):
    f1, labels, c = _proto_inputs(seed)
    sums, counts = proto_accumulate_nodes(torch.from_numpy(f1),
                                          torch.from_numpy(labels), c)
    js, jc = jax_proto_nodes(f1, labels, c, use_kernels=True)  # interpret
    for i in range(f1.shape[0]):
        rs, rc = jax_proto_ref(f1[i], labels[i], c)
        np.testing.assert_allclose(sums[i].numpy(), np.asarray(rs),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(rc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))


def _payload_rows(seed, r=24, c=512):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, c))
         * rng.uniform(1e-4, 10.0, (r, 1))).astype(np.float32)
    x[3] = 0.0                                # an all-zero (padding) row
    x[5, :] = np.linspace(-2, 2, c, dtype=np.float32)
    return x


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_rowabs_and_codes_match_jax_kernels_exactly(bits):
    x = _payload_rows(bits)
    amax = rowabs(torch.from_numpy(x))
    np.testing.assert_array_equal(amax.numpy(),
                                  np.asarray(rowabs_pallas(x,
                                                           interpret=True)))
    qmax = np.float32((1 << (bits - 1)) - 1)
    delta = np.maximum(amax.numpy() / qmax,
                       np.finfo(np.float32).tiny).astype(np.float32)
    # exact half-way points: x / delta lands on k + 0.5
    x[7, :4] = (np.array([0.5, 1.5, -0.5, -2.5], np.float32) * delta[7, 0])
    codes = quantize_rows(torch.from_numpy(x), torch.from_numpy(delta),
                          bits=bits)
    want = quantize_rows_pallas(x, delta, bits=bits, interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    assert codes.dtype == torch.int32
    # floor(v + 0.5), not round-half-to-even
    assert codes[7, :4].tolist() == [1, 2, 0, -2]


def test_cuda_wrappers_reject_cpu_tensors():
    """A CUDA wrapper launches its kernel or raises: it never computes a
    CPU tensor (the ops dispatch sends those to the plain versions)."""
    x = torch.zeros((8, 512))
    with pytest.raises(ValueError, match="CUDA"):
        rowabs_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_rows_cuda(x, torch.ones((8, 1)))
    q = torch.ones((8, 1))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_rows_mixed_cuda(x, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rowabs_sum_cuda(x, x, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_rows_ef_cuda(x, x, q, q, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        proto_accum_cuda(torch.zeros((1, 4, 8)),
                         torch.zeros((1, 4), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA"):
        adamw_update_cuda(x, x, x, x, torch.ones(()), torch.ones(1),
                          torch.ones(()), torch.ones(()), **HP)


@pytest.mark.parametrize("kernel", ["sgd_update", "adafactor_apply"])
def test_optimizer_sweep_wrappers_reject_cpu_tensors(kernel):
    x = torch.zeros((2, 8, 512))
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "sgd_update":
            sgd_update_cuda(x, x, x, torch.ones(()), torch.ones(2), **SGD_HP)
        else:
            adafactor_apply_cuda(x, x, torch.ones(()), weight_decay=0.01)


def test_nvcc_commands_target_hopper_without_fast_math(tmp_path):
    cc = build.compile_command("nvcc", build.CSRC / "quantize.cu",
                               tmp_path / "q.o")
    link = build.link_command("nvcc", [tmp_path / "q.o"], tmp_path / "l.so")
    for cmd in (cc, link):
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert "-fmad=false" in cc and "-O3" in cc and "-std=c++17" in cc
    assert "-shared" in link
    for name in build.SOURCES:
        assert (build.CSRC / name).is_file()
    # the sources' C entry points are the ones the ctypes binding declares
    text = "".join((build.CSRC / s).read_text() for s in build.SOURCES)
    for fn in build.SIGNATURES:
        assert f'extern "C" int {fn}(' in text


def test_launch_counters_are_registered_and_reset():
    counts = build.launch_counts()
    assert set(counts) >= {"adamw_update", "proto_accum", "rowabs",
                           "quantize_rows", "quantize_rows_mixed",
                           "rowabs_sum", "quantize_rows_ef", "sgd_update",
                           "adafactor_apply", "mix_packed"}
    build.COUNTERS["rowabs"].count += 3
    build.reset_launch_counts()
    assert all(v == 0 for v in build.launch_counts().values())


# -- the mixed-width and error-feedback codec --------------------------------

I4, I16 = np.float32(7), np.float32(32767)


def _ef_rows(seed, r=24, c=512):
    """Payload rows, residuals, and per-row Δ and qmax: int16 and int4
    rows, rows whose Δ is too small for their absmax (codes clip at both
    edges of int4 and int16), an all-zero row, and a row of exact
    half-way points (Δ a power of two, zero residual)."""
    x = _payload_rows(seed, r, c)
    rng = np.random.default_rng(seed + 100)
    res = (rng.standard_normal((r, c)) * 0.3 * np.abs(x).max(1, keepdims=True)
           ).astype(np.float32)
    res[3] = 0.0
    qmax = np.where(np.arange(r) % 2 == 0, I16, I4).astype(np.float32)[:, None]
    return x, res, qmax


def _ef_deltas(amax, qmax, x, res):
    delta = np.maximum(amax / qmax, np.finfo(np.float32).tiny
                       ).astype(np.float32)
    delta[8:12] /= np.float32(4.0)            # int16 / int4 rows that clip
    delta[13] = np.float32(2.0 ** -10)        # int4: 7.5, -8.5, -9 steps
    x[13, :6] = np.array([0.5, 1.5, -0.5, -2.5, 7.5, -8.5]) * 2.0 ** -10
    x[13, 6] = -9.0 * 2.0 ** -10
    res[13] = 0.0
    return delta


def _fma_model(x, res, delta, qmax, decay):
    """The interpret-mode error-feedback kernels' arithmetic: XLA:CPU
    fuses ``x + decay·res`` and ``eff - codes·Δ`` into FMAs, emulated
    here in float64 with each FMA rounded once to fp32 (the products are
    exact in float64).  Returns ``(row absmax, codes, new residual)``."""
    f64 = np.float64
    eff = (x.astype(f64) + f64(np.float32(decay)) * res).astype(np.float32)
    codes = np.clip(np.floor(eff / delta + np.float32(0.5)), -qmax - 1, qmax)
    new_res = (eff.astype(f64) - codes.astype(f64) * delta).astype(
        np.float32)
    return np.abs(eff).max(1, keepdims=True), codes.astype(np.int32), new_res


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_ef_and_mixed_rows_match_jax_kernels(decay):
    """The three plain versions against the interpret-mode Pallas
    kernels and eager ``repro`` arithmetic.  At ``decay=1`` the product
    ``1·res`` is exact, so row maxima and codes equal the interpret
    kernels'; at 0.9 the kernels' fused ``x + decay·res`` rounds once
    where the plain versions and eager ``repro`` round twice, so there
    the interpret kernels are held to :func:`_fma_model`."""
    x, res, qmax = _ef_rows(int(decay * 10))
    tx, tres, tq = map(torch.from_numpy, (x, res, qmax))
    amax = rowabs_sum(tx, tres, decay).numpy()
    eff = jnp.asarray(x) + jnp.float32(decay) * jnp.asarray(res)   # eager
    np.testing.assert_array_equal(amax, np.asarray(
        jnp.max(jnp.abs(eff), axis=1, keepdims=True)))
    j_amax = np.asarray(rowabs_sum_pallas(x, res, decay=decay,
                                          interpret=True))
    delta = _ef_deltas(amax, qmax, x, res)
    tx, tres, td = map(torch.from_numpy, (x, res, delta))
    eff = jnp.asarray(x) + jnp.float32(decay) * jnp.asarray(res)
    model = _fma_model(x, res, delta, qmax, decay)

    codes, new_res = quantize_rows_ef(tx, tres, td, tq, decay)
    assert codes.dtype == torch.int32 and new_res.dtype == torch.float32
    jcodes = jnp.clip(jnp.floor(eff / delta + 0.5), -qmax - 1, qmax)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert new_res.numpy().tobytes() == \
        np.asarray(eff - jcodes * delta).tobytes()
    jc, jr = quantize_rows_ef_pallas(x, res, delta, qmax, decay=decay,
                                     interpret=True)
    np.testing.assert_array_equal(np.asarray(jc), model[1])
    np.testing.assert_array_equal(np.asarray(jr), model[2])
    if decay == 1.0:
        np.testing.assert_array_equal(amax, j_amax)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    # the edges: floor(v + 0.5) rounds half up, and int4 clips to [-8, 7]
    assert codes[13, :7].tolist() == [1, 2, 0, -2, 7, -8, -8]
    for row, q in ((8, I16), (9, I4)):
        assert int(codes[row].max()) == int(q)
        assert int(codes[row].min()) == -int(q) - 1
    assert not codes[3].any() and not new_res[3].any()

    mixed = quantize_rows_mixed(tx, td, tq)
    np.testing.assert_array_equal(
        mixed.numpy(), np.asarray(quantize_rows_mixed_pallas(
            x, delta, qmax, interpret=True)))
    assert mixed[13, :7].tolist() == [1, 2, 0, -2, 7, -8, -8]
    assert int(mixed[9].max()) == 7 and int(mixed[8].max()) == 32767


def _small_planes(n=3, scale_node=1):
    """``n`` nodes' small mnist-cnn student planes, as JAX and torch
    planes over one numpy buffer (node ``scale_node`` scaled x40)."""
    scfg = jmodel.derive_student(jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32"))
    trees = [jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(scfg, jax.random.PRNGKey(i)))
        for i in range(n)]
    trees[scale_node] = jax.tree_util.tree_map(lambda v: v * 40.0,
                                               trees[scale_node])
    buf = np.stack([np.asarray(jplane.plane_from_tree(t).buf)
                    for t in trees])
    jmeta = jplane.plane_from_tree(trees[0]).meta
    tmeta = tplane.plane_from_tree(tmodel.params_from_numpy(trees[0])).meta
    return scfg, buf, jmeta, tmeta


def _real_lanes(meta, rows):
    """``[rows, 512]`` mask of a plane's real (non-padding) lanes."""
    real = np.zeros((rows, 512), dtype=bool)
    for _, _, shape, row, r_leaf in meta.recipe:
        real[row:row + r_leaf].reshape(-1)[:int(np.prod(shape))] = True
    return real


@pytest.mark.parametrize("ef,decay", [(False, 1.0), (True, 1.0),
                                      (True, 0.9)])
def test_packed_buffer_mixed_width_matches_jax(ef, decay):
    """A ``4/16`` packed buffer (int16 prototype rows, int4 student
    rows, alignment rows tagged with the last, int4, segment) quantized
    by the port and by ``repro`` eagerly — codes, scales and residual
    bit-exact — and in interpret mode, whose codes and scales equal the
    port's where its fused ``x + decay·res`` cannot differ (no residual,
    or ``decay=1``)."""
    scfg, buf, jmeta, tmeta = _small_planes()
    n = buf.shape[0]
    rng = np.random.default_rng(7)
    protos = rng.standard_normal((n, 10, scfg.proto_dim)).astype(np.float32)
    protos[2] = 0.0                           # an all-zero segment -> tiny Δ
    jspec, tspec = jwire.WireSpec(4, 16), twire.WireSpec(4, 16)
    jb, jids, jm, _, _ = jqops.pack_plane_payload(
        jnp.asarray(protos), jplane.Plane(jnp.asarray(buf), (), jmeta), jspec)
    tb, tids, tm, _, _ = tqops.pack_plane_payload(
        torch.from_numpy(protos),
        tplane.Plane(torch.from_numpy(buf.copy()), tmeta), tspec)
    assert tb.numpy().tobytes() == np.asarray(jb).tobytes()
    seg_bits = tm[3]
    assert seg_bits.tolist() == jm[4].tolist()
    assert seg_bits[0] == 16 and set(seg_bits[1:].tolist()) == {4}
    n_align = int(np.sum(tids == tm[1] - 1)) - tmeta.recipe[-1][-1]
    assert n_align > 0                        # alignment rows exist
    kw = {}
    if ef:
        res = (rng.standard_normal(tb.shape) * 0.05).astype(np.float32)
        res[:, -n_align:] = 50.0 * rng.standard_normal(
            (n, n_align, 512)).astype(np.float32)  # drive the last Δ
        kw = dict(residual=res, ef_decay=decay)
    out = tqops.quantize_packed_buffer(
        tb, tids, tm[1], 16, seg_bits=seg_bits,
        **{k: (torch.from_numpy(v) if k == "residual" else v)
           for k, v in kw.items()})
    eager = jqops.quantize_packed_buffer(jb, jids, jm[2], 16, seg_bits=jm[4],
                                         use_kernels=False, **kw)
    interp = jqops.quantize_packed_buffer(jb, jids, jm[2], 16,
                                          seg_bits=jm[4], use_kernels=True,
                                          **kw)              # interpret
    assert out[0].dtype == torch.int16        # the 4/16 container
    for ref in (eager, interp) if decay == 1.0 else (eager,):
        assert out[0].numpy().dtype == np.asarray(ref[0]).dtype
        assert out[0].numpy().tobytes() == np.asarray(ref[0]).tobytes()
        assert out[1].numpy().tobytes() == np.asarray(ref[1]).tobytes()
    if ef:
        assert out[2].numpy().tobytes() == np.asarray(eager[2]).tobytes()
    codes = out[0].numpy()
    # the prototype rows carry int16; the alignment rows the last
    # segment's int4 (their large residual sets that segment's Δ)
    assert np.abs(codes[:, :tm[0][0][4]]).max() > 7
    if ef:
        assert np.abs(codes[:, -n_align:]).max() in (7, 8)


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_plane_payload_ef_matches_jax(decay):
    """``quantize_dequantize_plane_payload(residual=)`` on a ``4/16+ef``
    spec against ``repro``'s, eagerly, for two carried calls: the
    receiver view and the new residual, both with zero padding lanes."""
    scfg, buf, jmeta, tmeta = _small_planes()
    n, rows = buf.shape[0], buf.shape[1]
    real = _real_lanes(tmeta, rows)
    rng = np.random.default_rng(11)
    protos = rng.standard_normal((n, 10, scfg.proto_dim)).astype(np.float32)
    jspec = jwire.WireSpec(4, 16, error_feedback=True, ef_decay=decay)
    tspec = twire.WireSpec(4, 16, error_feedback=True, ef_decay=decay)
    res_p = np.zeros_like(protos)
    res_s = np.zeros_like(buf)
    for call in range(2):
        trecv, tres = tqops.quantize_dequantize_plane_payload(
            {"protos": torch.from_numpy(protos),
             "student": tplane.Plane(torch.from_numpy(buf.copy()), tmeta)},
            16, spec=tspec,
            residual={"protos": torch.from_numpy(res_p),
                      "student": tplane.Plane(torch.from_numpy(res_s),
                                              tmeta)})
        jrecv, jres = jqops.quantize_dequantize_plane_payload(
            {"protos": jnp.asarray(protos),
             "student": jplane.Plane(jnp.asarray(buf), (), jmeta)},
            16, spec=jspec, use_kernels=False,
            residual={"protos": jnp.asarray(res_p),
                      "student": jplane.Plane(jnp.asarray(res_s), (),
                                              jmeta)})
        pairs = ((trecv["protos"], jrecv["protos"]),
                 (trecv["student"].buf, jrecv["student"].buf),
                 (tres["protos"], jres["protos"]),
                 (tres["student"].buf, jres["student"].buf))
        for t, j in pairs:
            assert t.numpy().tobytes() == np.asarray(j).tobytes()
        assert tres["student"].meta == tmeta
        assert tuple(tres["student"].buf.shape) == buf.shape
        for plane in (trecv["student"].buf, tres["student"].buf):
            assert not plane.numpy()[:, ~real].any()
        res_p = tres["protos"].numpy().copy()
        res_s = tres["student"].buf.numpy().copy()
        assert np.abs(res_s).max() > 0          # the int4 error is carried
        # the next call sees another payload: the trained students moved
        buf = (buf * np.float32(1.01)) * real


def test_ef_codec_needs_a_residual():
    scfg, buf, _, tmeta = _small_planes()
    payload = {"protos": torch.zeros((buf.shape[0], 10, scfg.proto_dim)),
               "student": tplane.Plane(torch.from_numpy(buf), tmeta)}
    with pytest.raises(ValueError, match="residual"):
        tqops.quantize_dequantize_plane_payload(
            payload, spec=twire.WireSpec(4, 16, error_feedback=True))
    # a stochastic spec needs a key (repro's ValueError), and with one
    # the payload round-trips
    spec = twire.WireSpec(4, stochastic_rounding=True)
    with pytest.raises(ValueError, match="rng"):
        tqops.quantize_dequantize_plane_payload(payload, spec=spec)
    recv = tqops.quantize_dequantize_plane_payload(payload, spec=spec,
                                                   rng=(0, 7))
    assert recv["student"].buf.shape == payload["student"].buf.shape


# -- the mesh exchange: the wire byte codec and the fused mix ----------------

@pytest.mark.parametrize("wire", ["16", "8", "4", "4/16"])
def test_wire_codec_matches_jax(wire):
    """Codes of a packed plane payload serialized to the wire bytes by
    both packages: the same bytes, the same decoded codes, the same
    ``wire_buffer_bytes``; int4 rows take half a byte a code."""
    scfg, buf, jmeta, tmeta = _small_planes()
    n = buf.shape[0]
    protos = np.random.default_rng(5).standard_normal(
        (n, 10, scfg.proto_dim)).astype(np.float32)
    jspec, tspec = jwire.WireSpec.parse(wire), twire.WireSpec.parse(wire)
    jb, jids, jm, _, _ = jqops.pack_plane_payload(
        jnp.asarray(protos), jplane.Plane(jnp.asarray(buf), (), jmeta), jspec)
    tb, tids, tm, _, _ = tqops.pack_plane_payload(
        torch.from_numpy(protos),
        tplane.Plane(torch.from_numpy(buf.copy()), tmeta), tspec)
    jcodes, _ = jqops.quantize_packed_buffer(jb, jids, jm[2], seg_bits=jm[4],
                                             use_kernels=False)
    tcodes, _ = tqops.quantize_packed_buffer(tb, tids, tm[1],
                                             seg_bits=tm[3])
    jenc = np.asarray(jqops.encode_wire(jcodes, jids, seg_bits=jm[4]))
    tenc = tqops.encode_wire(tcodes, tids, seg_bits=tm[3])
    assert tenc.dtype == torch.int8
    assert tenc.numpy().tobytes() == jenc.tobytes()
    nbytes = tqops.wire_buffer_bytes(tids, seg_bits=tm[3])
    assert nbytes == jqops.wire_buffer_bytes(jids, seg_bits=jm[4])
    assert tuple(tenc.shape) == (n, nbytes)
    rows_bits = tm[3][tids]
    assert nbytes == int(np.sum(rows_bits)) * 512 // 8
    dec = tqops.decode_wire(tenc, tids, seg_bits=tm[3])
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), tcodes.numpy())
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jqops.decode_wire(jnp.asarray(jenc), jids,
                                                  seg_bits=jm[4])))


def test_nibble_pack_matches_jax_on_every_code():
    codes = np.stack([np.repeat(np.arange(-8, 8), 16),
                      np.tile(np.arange(-8, 8), 16)]).astype(np.int8)
    codes = codes.T.reshape(2, 256)                # every (lo, hi) pair
    packed = tqops.nibble_pack(torch.from_numpy(codes))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (2, 128)
    assert packed.numpy().tobytes() == np.asarray(
        jqops.nibble_pack(jnp.asarray(codes))).tobytes()
    np.testing.assert_array_equal(tqops.nibble_unpack(packed).numpy(), codes)
    with pytest.raises(ValueError, match="even"):
        tqops.nibble_pack(torch.zeros((2, 3), dtype=torch.int8))


def _mix_inputs(m, s, float_codes, rows=24, seed=0):
    rng = np.random.default_rng(seed)
    own = rng.standard_normal((m, rows, 512)).astype(np.float32)
    if float_codes:              # raw buffers at unit delta
        codes = rng.standard_normal((s, rows, 512)).astype(np.float32)
        delta = np.ones((s, rows), np.float32)
    else:
        codes = rng.integers(-32768, 32768, (s, rows, 512)).astype(np.int32)
        delta = (rng.random((s, rows)) * 1e-4).astype(np.float32)
    w_self = rng.random(m).astype(np.float32)
    w_rows = rng.random((m, s)).astype(np.float32)
    w_rows[:, 0] = 0.0 if s > 1 else w_rows[:, 0]   # a zero weight
    return own, codes, delta, w_self, w_rows


def _rn(x):
    return x.astype(np.float32)


@pytest.mark.parametrize("m,s,float_codes", [(1, 2, False), (8, 8, False),
                                             (8, 8, True)],
                         ids=["ring-int32", "8x8-int32", "8x8-fp32"])
def test_mix_packed_plain_matches_jax_kernel(m, s, float_codes):
    own, codes, delta, w_self, w_rows = _mix_inputs(m, s, float_codes)
    got = tqops.mix_packed(*map(torch.from_numpy,
                                (own, codes, delta, w_self, w_rows)))
    assert got.dtype == torch.float32 and tuple(got.shape) == own.shape
    deq = [_rn(codes[j].astype(np.float32) * delta[j][:, None])
           for j in range(s)]
    w = [w_rows[:, j][:, None, None] for j in range(s)]
    # the plain arithmetic: every product and sum rounded on its own
    plain = _rn(w_self[:, None, None] * own)
    for j in range(s):
        plain = _rn(plain + _rn(w[j] * deq[j][None]))
    np.testing.assert_array_equal(got.numpy(), plain)
    # the interpret kernel's: XLA:CPU contracts into FMAs
    fused = _rn(w_self[:, None, None].astype(np.float64) * own
                + _rn(w[0] * deq[0][None]))
    for j in range(1, s):
        fused = _rn(fused.astype(np.float64)
                    + w[j].astype(np.float64) * deq[j][None])
    want = np.asarray(mix_packed_pallas(own, codes, delta, w_self, w_rows,
                                        interpret=True))
    np.testing.assert_array_equal(want, fused)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * np.spacing(np.abs(want).max()))


def test_mix_packed_accumulate_matches_jax_kernel():
    """The step-wise form: init then one step at a time, as the
    pipelined ppermute exchange folds its two ring steps."""
    own, codes, delta, w_self, w_rows = _mix_inputs(1, 2, False, seed=1)
    t = [torch.from_numpy(x) for x in (own, codes, delta, w_self, w_rows)]
    acc = tqops.mix_packed_init(t[0], t[3])
    jacc = jqops.mix_packed_init(jnp.asarray(own), jnp.asarray(w_self))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    for j in range(2):
        acc = tqops.mix_packed_accumulate(acc, t[1][j:j + 1], t[2][j:j + 1],
                                          t[4][:, j:j + 1])
        jacc = mix_packed_pallas(jacc, codes[j:j + 1], delta[j:j + 1],
                                 np.ones(1, np.float32), w_rows[:, j:j + 1],
                                 interpret=True)
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # one launch a step on the card: it rounds like the stacked mix
    np.testing.assert_array_equal(
        acc.numpy(), tqops.mix_packed(*t).numpy())


def test_mix_packed_cuda_rejects_cpu_tensors_and_bad_codes():
    own = torch.zeros((1, 8, 512))
    codes = torch.zeros((2, 8, 512), dtype=torch.int32)
    args = (torch.ones((2, 8)), torch.ones(1), torch.ones((1, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        mix_packed_cuda(own, codes, *args)
    with pytest.raises(ValueError, match="int32 or float32"):
        mix_packed_cuda(own, codes.to(torch.int16), *args)
    with pytest.raises(ValueError, match="expected own"):
        mix_packed_cuda(own[0], codes, *args)
