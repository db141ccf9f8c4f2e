"""The shared helpers of the per-leaf and per-tensor codec tests
(tests/test_torch_codec.py, test_torch_codec_per_tensor.py).

The per-leaf and per-tensor wire codec, held against the JAX package
on the CPU.

Every comparison is bit-exact (0 ulp), because the reference claims
bit-identity for all of them:

* the five new plain versions (``quantize_dequantize_rows_ref``,
  ``dequantize_rows_ref``, ``fused_quantize_ref``,
  ``fused_quantize_dequantize_ref``, ``dequantize_ref``) against the
  Pallas kernels they replace, in interpret mode, at odd shapes and
  widths 4 / 8 / 16 (the fused kernels get qmax as a runtime ``(1, 1)``
  array, as ``repro``'s ``ops._qmax_arr`` passes it);
* the per-tensor tier (``quantize`` / ``dequantize`` /
  ``quantize_dequantize``) and the packed-tree tier (``pack_tree`` …
  ``quantize_dequantize_tree_packed``, both ``node_axis`` settings)
  against ``repro``'s ops;
* ``core/quantization``'s per-tensor codec, ``round_ops``'
  ``quantize_leaf_per_node`` / ``dequantize_leaf``, ``wire_state``'s
  ``ef_quantize_dequantize_tree`` and
  ``quantize_dequantize_per_node(packed=False)`` against the eager JAX
  functions, and ``packed=False`` against the port's own packed codec;
* the slice as a whole: a test-size mnist-cnn stacked payload, its
  weights carried from JAX, through both packages' ``packed=False``
  codecs.

The CUDA wrappers launch their kernels or raise; here they raise on CPU
tensors, and ``chip_smoke.py`` holds them against the plain versions on
the card.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.core import wire_state as JW
from repro_torch.core import wire_state as TW

torch.set_num_threads(2)

NEW_KERNELS = ("quantize_dequantize_rows", "dequantize_rows",
               "fused_quantize", "fused_quantize_dequantize", "dequantize")


def _qmax(bits):
    return float((1 << (bits - 1)) - 1)


def _same(t, j):
    """Bit-identical values (and shape); ``t`` a tensor, ``j`` an array."""
    a = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert a.tobytes() == b.tobytes()
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _pairs(tleaves, jtree):
    jleaves = jax.tree_util.tree_leaves(jtree)
    assert len(tleaves) == len(jleaves)
    return zip(tleaves, jleaves)


def _rows_input(shape, bits, seed):
    """``[R, C]`` fp32 rows (one all zero), per-row Δ from their absmax
    (some rows' Δ too small, so codes clip at both ends), and exact
    half-way points in row 0."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x2d = x.reshape(shape[0], -1) if len(shape) > 1 else x.reshape(1, -1)
    qm = np.float32(_qmax(bits))
    delta = np.maximum(np.abs(x2d).max(1, keepdims=True) / qm,
                       np.finfo(np.float32).tiny).astype(np.float32)
    if x2d.shape[0] > 3:
        x2d[2] = 0.0
        delta[3] /= np.float32(4.0)
    if x2d.shape[1] >= 4:
        x2d[0, :4] = np.array([0.5, 1.5, -0.5, -2.5], np.float32) * delta[0]
    return np.ascontiguousarray(x2d), delta


# -- the packed tree ----------------------------------------------------------

def _mixed_tree(seed=42):
    """``repro``'s test tree: an int leaf, a 0-d scalar, a bf16 leaf."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((33, 17)).astype(np.float32)
    v = (rng.standard_normal((1000,)) * 10).astype(np.float32)
    aligned = rng.standard_normal((8, 128)).astype(np.float32)
    jt = {"w": jnp.asarray(w),
          "nested": {"v": jnp.asarray(v, jnp.bfloat16),
                     "idx": jnp.arange(7, dtype=jnp.int32),
                     "scalar": jnp.float32(3.5)},
          "aligned": jnp.asarray(aligned)}
    tt = {"w": torch.from_numpy(w),
          "nested": {"v": torch.from_numpy(v).to(torch.bfloat16),
                     "idx": torch.arange(7, dtype=torch.int32),
                     "scalar": torch.tensor(3.5)},
          "aligned": torch.from_numpy(aligned)}
    return jt, tt


# -- round_ops: per node ------------------------------------------------------

def _stacked(seed=0, n=4):
    rng = np.random.default_rng(seed)
    arrs = {"w": rng.standard_normal((n, 33, 9)) * 2,
            "b": rng.standard_normal((n, 5)),
            "s": rng.standard_normal((n,)),
            "h": rng.standard_normal((n, 3, 700)) * 5}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    arrs["w"][1] *= 40.0                        # one node far louder
    arrs["b"][2] = 0.0                          # an all-zero node slice
    return arrs


def _payload(seed=3, n=4):
    """A stacked wire payload ``{"protos", "student"}`` as numpy: the
    student a tree of ``[N, ...]`` leaves."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((n, 10, 16)).astype(np.float32)
    return protos, _stacked(seed, n)


def _to(tree, lib):
    if lib == "jax":
        return jax.tree_util.tree_map(jnp.asarray, tree)
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _state_pair(protos, student, seed, decay_scale=0.1):
    rng = np.random.default_rng(seed)
    res = {"protos": (rng.standard_normal(protos.shape) * decay_scale
                      ).astype(np.float32),
           "student": {k: (rng.standard_normal(v.shape) * decay_scale
                           * np.abs(v).max()).astype(np.float32)
                       for k, v in student.items()}}
    seq = np.array([2, 2, 2, 2], np.int32)
    return (TW.CodecState(_to(res, "torch"), torch.from_numpy(seq)),
            JW.CodecState(_to(res, "jax"), jnp.asarray(seq)), res)
