"""The per-tensor wire codec against the JAX package on the CPU, bit for
bit: the five plain versions against the Pallas kernels they replace
(interpret mode) and the per-tensor tier (``quantize`` / ``dequantize``
/ ``quantize_dequantize``) against ``repro``'s ops.

The helpers and the tolerances, with their reasons, are in
``tests/torch_codec_helpers.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.quantize import ops as jqops
from repro.kernels.quantize.quantize import (dequantize_pallas,
                                             dequantize_rows_pallas,
                                             fused_quantize_dequantize_pallas,
                                             fused_quantize_pallas,
                                             quantize_dequantize_rows_pallas)
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize import ref as tref

from torch_codec_helpers import (_qmax, _rows_input, _same)

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(257, 33), (300, 777), (129, 513), (1,)])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_plain_versions_match_pallas_kernels(shape, bits):
    x2d, delta = _rows_input(shape, bits, seed=bits + len(shape))
    t = torch.from_numpy
    # row 7: the row-scaled round trip; row 12: codes · Δ_row
    got = tref.quantize_dequantize_rows_ref(t(x2d), t(delta), bits=bits)
    _same(got, quantize_dequantize_rows_pallas(x2d, delta, bits=bits,
                                               interpret=True))
    codes = tref.quantize_rows_ref(t(x2d), t(delta), bits=bits)
    _same(tref.dequantize_rows_ref(codes, t(delta)),
          dequantize_rows_pallas(codes.numpy(), delta, interpret=True))
    # rows 13 and 14: the whole-tensor codec, qmax a runtime (1, 1) input
    qm2d = jnp.full((1, 1), _qmax(bits), jnp.float32)
    qm = torch.tensor(_qmax(bits))
    tc, td = tref.fused_quantize_ref(t(x2d), qm)
    jc, jd = fused_quantize_pallas(x2d, qm2d, bits=bits, interpret=True)
    _same(tc, jc)
    _same(td, jd)
    assert tc.dtype == torch.int32 and td.dim() == 0
    to, td2 = tref.fused_quantize_dequantize_ref(t(x2d), qm)
    jo, jd2 = fused_quantize_dequantize_pallas(x2d, qm2d, bits=bits,
                                               interpret=True)
    _same(to, jo)
    _same(td2, jd2)
    # row 15: codes · Δ with a scalar Δ
    _same(tref.dequantize_ref(tc, td),
          dequantize_pallas(np.asarray(jc), jd, interpret=True))
    _same(tref.dequantize_ref(tc, td), to)
    if x2d.shape[1] >= 4:          # floor(v + 0.5), not half to even
        assert codes[0, :4].tolist() == [1, 2, 0, -2]


@pytest.mark.parametrize("shape", [(16,), (1000,), (3, 7, 11), (257, 33),
                                   (1,), (129, 513)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_tensor_ops_match_jax(shape, dtype):
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    x32 = (rng.standard_normal(shape) * 3).astype(np.float32)
    jx = jnp.asarray(x32, getattr(jnp, dtype))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    _same(tx.float(), jnp.asarray(jx, jnp.float32))   # the same bf16 input
    for bits in (8, 16):
        tc, td = tqops.quantize(tx, bits)
        jc, jd = jqops.quantize(jx, bits)
        _same(tc, jc)
        _same(td, jd)
        assert tc.shape == tx.shape and tc.dtype == torch.int32
        tqd = tqops.quantize_dequantize(tx, bits)
        assert tqd.dtype == tx.dtype and tqd.shape == tx.shape
        _same(tqd.float(), jnp.asarray(jqops.quantize_dequantize(jx, bits),
                                       jnp.float32))
        # int16 codes are cast to int32 before the sweep
        _same(tqops.dequantize(tc.to(torch.int16), td),
              jqops.dequantize(jc.astype(jnp.int16), jd))
        _same(tqops.dequantize(tc, td), tref.dequantize_ref(tc, td))
