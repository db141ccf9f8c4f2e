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
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.opt_update.opt_update import adamw_update_pallas
from repro.kernels.opt_update.ref import adamw_update_ref as jax_adamw_ref
from repro.kernels.proto_accum.ops import \
    proto_accumulate_nodes as jax_proto_nodes
from repro.kernels.proto_accum.ref import proto_accum_ref as jax_proto_ref
from repro.kernels.quantize.quantize import (quantize_rows_pallas,
                                             rowabs_pallas)
from repro_torch.kernels import build
from repro_torch.kernels.opt_update.ops import fused_adamw_update
from repro_torch.kernels.opt_update.opt_update import adamw_update_cuda
from repro_torch.kernels.opt_update.ref import adamw_update_ref
from repro_torch.kernels.proto_accum.ops import proto_accumulate_nodes
from repro_torch.kernels.proto_accum.proto_accum import proto_accum_cuda
from repro_torch.kernels.quantize.ops import quantize_rows, rowabs
from repro_torch.kernels.quantize.quantize import (quantize_rows_cuda,
                                                   rowabs_cuda)

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
    with pytest.raises(ValueError, match="CUDA"):
        proto_accum_cuda(torch.zeros((1, 4, 8)),
                         torch.zeros((1, 4), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA"):
        adamw_update_cuda(x, x, x, x, torch.ones(()), torch.ones(1),
                          torch.ones(()), torch.ones(()), **HP)


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
                           "quantize_rows"}
    build.COUNTERS["rowabs"].count += 3
    build.reset_launch_counts()
    assert all(v == 0 for v in build.launch_counts().values())
