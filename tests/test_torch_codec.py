"""The per-leaf and per-tensor wire codec, held against the JAX package
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
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import wirespec as jwire
from repro.config import base as jbase
from repro.core import quantization as JQ
from repro.core import round_ops as JR
from repro.core import wire_state as JW
from repro.kernels.quantize import ops as jqops
from repro.kernels.quantize.quantize import (dequantize_pallas,
                                             dequantize_rows_pallas,
                                             fused_quantize_dequantize_pallas,
                                             fused_quantize_pallas,
                                             quantize_dequantize_rows_pallas)
from repro.models import model as jmodel
from repro.optim import plane as jplane
from repro_torch import wirespec as twire
from repro_torch.core import quantization as TQ
from repro_torch.core import round_ops as TR
from repro_torch.core import wire_state as TW
from repro_torch.kernels import build
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize import ref as tref
from repro_torch.kernels.quantize.quantize import (
    dequantize_cuda, dequantize_rows_cuda, fused_quantize_cuda,
    fused_quantize_dequantize_cuda, quantize_dequantize_rows_cuda)
from repro_torch.models import model as tmodel
from repro_torch.optim import plane as tplane
from repro_torch.tree import tree_leaves

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


# -- the five plain versions against their Pallas kernels --------------------

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


def test_new_cuda_wrappers_reject_cpu_tensors():
    """Each wrapper launches its kernel or raises: on a CPU tensor it
    raises (the ops dispatch sends those to the plain versions)."""
    x = torch.zeros((8, 512))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_dequantize_rows_cuda(x, torch.ones((8, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_rows_cuda(torch.zeros((8, 512), dtype=torch.int32),
                             torch.ones((8, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        fused_quantize_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_quantize_dequantize_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        dequantize_cuda(torch.zeros((8,), dtype=torch.int32),
                        torch.ones(()))


def test_new_kernels_are_bound_and_counted():
    """The five entry points are declared for ctypes and exported by
    ``csrc/quantize.cu``; the CPU dispatch launches nothing."""
    src = (build.CSRC / "quantize.cu").read_text()
    for name in NEW_KERNELS:
        assert name in build.SIGNATURES
        assert f'extern "C" int {name}(' in src
        assert name in build.launch_counts()
    build.reset_launch_counts()
    x = torch.randn((16, 512))
    codes, delta = tqops.quantize(x)
    tqops.dequantize(codes, delta)
    tqops.quantize_dequantize(x)
    tqops.quantize_dequantize_tree_packed({"a": x}, 8)
    tqops.dequantize_tree_packed(tqops.quantize_tree_packed({"a": x}))
    assert all(v == 0 for v in build.launch_counts().values())


# -- the per-tensor tier ------------------------------------------------------

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


@pytest.mark.parametrize("node_axis", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_packed_tree_matches_jax(node_axis, bits):
    jt, tt = _mixed_tree()
    jbuf, jseg, jmeta = jqops.pack_tree(jt, node_axis=node_axis)
    tbuf, tseg, tmeta = tqops.pack_tree(tt, node_axis=node_axis)
    _same(tbuf, jbuf)
    _same(torch.from_numpy(tseg), jseg)
    assert tmeta[1] == jmeta[2]                      # segment count
    # the int leaf rides in the meta untouched
    raw = [it for it in tmeta[0] if it[0] == "raw"]
    assert len(raw) == 1 and raw[0][2] is tt["nested"]["idx"]
    back = tqops.unpack_tree(tbuf, tmeta)
    for t, j in _pairs(tree_leaves(back), jqops.unpack_tree(jbuf, jmeta)):
        _same(t, j)

    tp = tqops.quantize_tree_packed(tt, bits, node_axis=node_axis)
    jp = jqops.quantize_tree_packed(jt, bits, node_axis=node_axis)
    _same(tp["codes"], jp["codes"])
    _same(tp["scales"], jp["scales"])
    assert tp["codes"].dtype == torch.int32
    assert tuple(tp["scales"].shape) == (tmeta[1],)
    deq = tqops.dequantize_tree_packed(tp)
    for t, j in _pairs(tree_leaves(deq), jqops.dequantize_tree_packed(jp)):
        _same(t, j)
    rt = tqops.quantize_dequantize_tree_packed(tt, bits, node_axis=node_axis)
    jrt = jqops.quantize_dequantize_tree_packed(jt, bits,
                                                node_axis=node_axis)
    for t, j, d in zip(tree_leaves(rt), jax.tree_util.tree_leaves(jrt),
                       tree_leaves(deq)):
        _same(t, j)
        _same(t, d.numpy())
    if not node_axis:    # whole-leaf segments == the per-tensor codec
        for t, w in zip(tree_leaves(rt),
                        tree_leaves(TQ.quantize_dequantize_tree(tt, bits))):
            _same(t, w.numpy())


def test_pack_tree_without_float_leaves():
    for tree in ({}, {"idx": torch.arange(3)}):
        buf, seg, meta = tqops.pack_tree(tree)
        jbuf, jseg, jmeta = jqops.pack_tree(
            {k: jnp.asarray(v.numpy()) for k, v in tree.items()})
        _same(buf, jbuf)
        _same(torch.from_numpy(seg), jseg)
        assert tuple(buf.shape) == (8, 512) and meta[1] == jmeta[2] == 1


# -- core/quantization --------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8, 16])
def test_core_quantization_matches_jax(bits):
    jt, tt = _mixed_tree(seed=bits)
    tp = TQ.quantize_tree(tt, bits)
    jp = JQ.quantize_tree(jt, bits)
    assert tp["bits"] == jp["bits"] == bits
    for t, j in _pairs(tree_leaves(tp["codes"]), jp["codes"]):
        _same(t, j)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)   # containers
    for t, j in _pairs(tree_leaves(tp["scales"]), jp["scales"]):
        _same(t, j)
    for t, j in _pairs(tree_leaves(TQ.dequantize_tree(tp)),
                       JQ.dequantize_tree(jp)):
        _same(t, j)
        assert t.dtype == torch.float32
    for t, j in _pairs(tree_leaves(TQ.quantize_dequantize_tree(tt, bits)),
                       JQ.quantize_dequantize_tree(jt, bits)):
        _same(t, j)
    c, d = TQ.quantize_array(tt["nested"]["idx"], bits)
    assert c is tt["nested"]["idx"] and float(d) == 1.0
    _same(TQ.dequantize_array(tt["w"], d, torch.bfloat16).float(),
          JQ.dequantize_array(jt["w"], 1.0, jnp.bfloat16).astype(
              jnp.float32))
    # stochastic rounding: a threefry key gives repro's codes bit for
    # bit; a torch.Generator cannot reproduce its stream and raises
    key = jax.random.PRNGKey(bits)
    for t, j in zip(TQ.quantize_array(tt["w"], bits, rng=np.asarray(key)),
                    JQ.quantize_array(jt["w"], bits, rng=key)):
        _same(t, j)
    with pytest.raises(TypeError, match="Generator"):
        TQ.quantize_array(tt["w"], bits, rng=torch.Generator())


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


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_leaf_per_node_matches_jax(bits):
    for name, x in _stacked(bits).items():
        for dtype in ("float32", "bfloat16"):
            tx = torch.from_numpy(x).to(getattr(torch, dtype))
            jx = jnp.asarray(x, getattr(jnp, dtype))
            tc, td = TR.quantize_leaf_per_node(tx, bits)
            jc, jd = JR.quantize_leaf_per_node(jx, bits)
            _same(tc, jc)
            _same(td, jd)
            assert str(tc.dtype).split(".")[-1] == str(jc.dtype)
            assert tuple(td.shape) == (x.shape[0],)
            _same(TR.dequantize_leaf(tc, td), JR.dequantize_leaf(jc, jd))


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


@pytest.mark.parametrize("wire", ["16", "8", "4/16"])
def test_per_node_packed_false_matches_jax(wire):
    """``packed=False`` against JAX's per-leaf codec (``use_kernels=
    False``) and against the port's own packed codec."""
    protos, student = _payload()
    tpay = _to({"protos": protos, "student": student}, "torch")
    jpay = _to({"protos": protos, "student": student}, "jax")
    tspec, jspec = twire.WireSpec.parse(wire), jwire.WireSpec.parse(wire)
    got = TR.quantize_dequantize_per_node(tpay, spec=tspec, packed=False)
    want = JR.quantize_dequantize_per_node(jpay, spec=jspec, packed=False,
                                           use_kernels=False)
    packed = TR.quantize_dequantize_per_node(tpay, spec=tspec)
    for t, j, p in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                       tree_leaves(packed)):
        _same(t, j)
        _same(t, p.numpy())
    assert sorted(got) == ["protos", "student"]


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


@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_per_node_packed_false_ef_matches_jax(decay):
    """``4/16+ef`` with ``packed=False``: the receiver view, the new
    residual and ``seq`` over two carried calls, against JAX's per-leaf
    codec; and against the port's packed EF codec on the same values
    laid out as a student plane (one segment per node and leaf either
    way)."""
    protos, student = _payload(seed=5)
    tspec = twire.WireSpec(4, 16, error_feedback=True, ef_decay=decay)
    jspec = jwire.WireSpec(4, 16, error_feedback=True, ef_decay=decay)
    tstate, jstate, res = _state_pair(protos, student, seed=6)
    tpay = _to({"protos": protos, "student": student}, "torch")
    jpay = _to({"protos": protos, "student": student}, "jax")
    # the plane layout of the same student and residual
    n = protos.shape[0]
    planes = [tplane.plane_from_tree({k: torch.as_tensor(v[i])
                                      for k, v in student.items()})
              for i in range(n)]
    meta = planes[0].meta
    rplanes = [tplane.plane_from_tree({k: torch.as_tensor(v[i])
                                       for k, v in res["student"].items()})
               for i in range(n)]
    pstate = TW.CodecState(
        {"protos": torch.from_numpy(res["protos"]),
         "student": tplane.Plane(torch.stack([p.buf for p in rplanes]),
                                 meta)}, tstate.seq)
    ppay = {"protos": tpay["protos"],
            "student": tplane.Plane(torch.stack([p.buf for p in planes]),
                                    meta)}
    for _ in range(2):
        trecv, tstate = TR.quantize_dequantize_per_node(
            tpay, spec=tspec, packed=False, state=tstate)
        jrecv, jstate = JR.quantize_dequantize_per_node(
            jpay, spec=jspec, packed=False, use_kernels=False, state=jstate)
        for t, j in _pairs(tree_leaves(trecv), jrecv):
            _same(t, j)
        for t, j in _pairs(tree_leaves(tstate.residual), jstate.residual):
            _same(t, j)
        _same(tstate.seq, jstate.seq)
        precv, pstate = TR.quantize_dequantize_per_node(
            ppay, spec=tspec, state=pstate)
        pv = {"protos": precv["protos"],
              "student": tplane.as_tree(precv["student"])}
        pr = {"protos": pstate.residual["protos"],
              "student": tplane.as_tree(pstate.residual["student"])}
        for t, p in zip(tree_leaves(trecv), tree_leaves(pv)):
            _same(t, p.numpy())
        for t, p in zip(tree_leaves(tstate.residual), tree_leaves(pr)):
            _same(t, p.numpy())
        _same(tstate.seq, pstate.seq.numpy())
    assert tstate.seq.tolist() == [4] * n


def test_per_node_packed_false_on_a_plane_student():
    """A Plane student under ``packed=False`` is one float leaf, its
    ``[N, R, 512]`` buffer: one segment per node over the whole plane,
    as JAX flattens a Plane; it comes back a Plane of the same recipe.
    With error feedback the plane residual rides the same way."""
    protos, student = _payload(seed=7, n=3)
    tree0 = {k: v[0] for k, v in student.items()}
    jmeta = jplane.plane_from_tree(tree0).meta
    tmeta = tplane.plane_from_tree(tmodel.params_from_numpy(tree0)).meta
    buf = np.stack([np.asarray(jplane.plane_from_tree(
        {k: v[i] for k, v in student.items()}).buf) for i in range(3)])
    tpay = {"protos": torch.from_numpy(protos),
            "student": tplane.Plane(torch.from_numpy(buf), tmeta)}
    jpay = {"protos": jnp.asarray(protos),
            "student": jplane.Plane(jnp.asarray(buf), (), jmeta)}
    got = TR.quantize_dequantize_per_node(tpay, 16, packed=False)
    want = JR.quantize_dequantize_per_node(jpay, 16, packed=False,
                                           use_kernels=False)
    assert isinstance(got["student"], tplane.Plane)
    assert got["student"].meta == tmeta
    _same(got["student"].buf, want["student"].buf)
    _same(got["protos"], want["protos"])
    # one Δ per node over the whole buffer, not per leaf
    whole = TR.dequantize_leaf(*TR.quantize_leaf_per_node(
        torch.from_numpy(buf), 16))
    _same(got["student"].buf, whole.numpy())
    per_leaf = TR.quantize_dequantize_per_node(tpay, 16)
    assert not torch.equal(per_leaf["student"].buf, got["student"].buf)

    spec = twire.WireSpec(4, 16, error_feedback=True)
    jspec = jwire.WireSpec(4, 16, error_feedback=True)
    rng = np.random.default_rng(8)
    rp = (rng.standard_normal(protos.shape) * 0.1).astype(np.float32)
    rs = (rng.standard_normal(buf.shape) * 0.01).astype(np.float32)
    tstate = TW.CodecState({"protos": torch.from_numpy(rp),
                            "student": tplane.Plane(torch.from_numpy(rs),
                                                    tmeta)},
                           torch.zeros(3, dtype=torch.int32))
    jstate = JW.CodecState({"protos": jnp.asarray(rp),
                            "student": jplane.Plane(jnp.asarray(rs), (),
                                                    jmeta)},
                           jnp.zeros(3, jnp.int32))
    trecv, tnew = TR.quantize_dequantize_per_node(tpay, spec=spec,
                                                  packed=False, state=tstate)
    jrecv, jnew = JR.quantize_dequantize_per_node(
        jpay, spec=jspec, packed=False, use_kernels=False, state=jstate)
    assert isinstance(tnew.residual["student"], tplane.Plane)
    _same(trecv["student"].buf, jrecv["student"].buf)
    _same(tnew.residual["student"].buf, jnew.residual["student"].buf)
    _same(tnew.residual["protos"], jnew.residual["protos"])
    _same(tnew.seq, jnew.seq)


def test_per_node_packed_false_refusals():
    protos, student = _payload()
    tpay = _to({"protos": protos, "student": student}, "torch")
    with pytest.raises(ValueError, match="stochastic rounding"):
        TR.quantize_dequantize_per_node(
            tpay, spec=twire.WireSpec(16, stochastic_rounding=True),
            packed=False)
    with pytest.raises(ValueError, match="CodecState"):
        TR.quantize_dequantize_per_node(
            tpay, spec=twire.WireSpec(4, 16, error_feedback=True),
            packed=False)


# -- wire_state: the per-leaf error-feedback reference -------------------------

@pytest.mark.parametrize("node_axis", [True, False])
def test_ef_quantize_dequantize_tree_matches_jax(node_axis):
    protos, student = _payload(seed=9)
    student["idx"] = np.arange(4, dtype=np.int32)   # a non-float leaf
    tpay = _to({"protos": protos, "student": student}, "torch")
    jpay = _to({"protos": protos, "student": student}, "jax")
    tstate, jstate, _ = _state_pair(
        protos, {k: v for k, v in student.items() if k != "idx"}, seed=10)
    tstate.residual["student"]["idx"] = None
    jstate.residual["student"]["idx"] = None
    spec = dict(student_bits=4, proto_bits=16, error_feedback=True,
                ef_decay=0.9)
    trecv, tnew = TW.ef_quantize_dequantize_tree(
        tpay, twire.WireSpec(**spec), tstate, node_axis=node_axis)
    jrecv, jnew = JW.ef_quantize_dequantize_tree(
        jpay, jwire.WireSpec(**spec), jstate, node_axis=node_axis)
    assert trecv["student"]["idx"] is tpay["student"]["idx"]
    for t, j in _pairs(tree_leaves(trecv), jrecv):
        _same(t, j)
    assert tnew.residual["student"]["idx"] is None
    for t, j in _pairs([r for r in tree_leaves(tnew.residual)
                        if r is not None], jnew.residual):
        _same(t, j)
    _same(tnew.seq, jnew.seq)
    # the alignment and shape checks
    bad = TW.CodecState({"protos": tstate.residual["protos"]}, tstate.seq)
    with pytest.raises(ValueError, match="residual leaves"):
        TW.ef_quantize_dequantize_tree(tpay, twire.WireSpec(**spec), bad)
    wrong = dict(tstate.residual, protos=tstate.residual["protos"][:, :3])
    with pytest.raises(ValueError, match="residual shape"):
        TW.ef_quantize_dequantize_tree(tpay, twire.WireSpec(**spec),
                                       TW.CodecState(wrong, tstate.seq))


# -- the slice as a whole -----------------------------------------------------

@pytest.mark.parametrize("wire", ["16", "4/16", "4/16+ef"])
def test_slice_mnist_payload_matches_jax(wire):
    """A test-size mnist-cnn federation's wire payload: 3 nodes' student
    weights from JAX's ``init_params`` (carried with
    ``params_from_numpy``) stacked beside seeded prototypes, through both
    packages' ``packed=False`` codecs; the port's packed codec agrees."""
    jcfg = jmodel.derive_student(jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32"))
    n = 3
    trees = [jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(i)))
        for i in range(n)]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    rng = np.random.default_rng(12)
    protos = rng.standard_normal((n, 10, jcfg.proto_dim)).astype(np.float32)
    tpay = {"protos": torch.from_numpy(protos),
            "student": tmodel.params_from_numpy(stacked)}
    jpay = {"protos": jnp.asarray(protos),
            "student": jax.tree_util.tree_map(jnp.asarray, stacked)}
    tspec, jspec = twire.WireSpec.parse(wire), jwire.WireSpec.parse(wire)
    kw_t, kw_j = {}, {}
    if tspec.error_feedback:            # a carried, non-zero residual
        res = jax.tree_util.tree_map(
            lambda x: np.full_like(x, np.float32(1e-3)), stacked)
        kw_t["state"] = TW.CodecState(
            {"protos": torch.zeros(protos.shape),
             "student": tmodel.params_from_numpy(res)},
            torch.zeros(n, dtype=torch.int32))
        kw_j["state"] = JW.init_codec_state(jpay, n_nodes=n)._replace(
            residual={"protos": jnp.zeros(protos.shape),
                      "student": jax.tree_util.tree_map(jnp.asarray, res)})
    got = TR.quantize_dequantize_per_node(tpay, spec=tspec, packed=False,
                                          **kw_t)
    want = JR.quantize_dequantize_per_node(jpay, spec=jspec, packed=False,
                                           use_kernels=False, **kw_j)
    if tspec.error_feedback:
        (got, tst), (want, jst) = got, want
        for t, j in _pairs(tree_leaves(tst.residual), jst.residual):
            _same(t, j)
        _same(tst.seq, jst.seq)
    else:
        packed = TR.quantize_dequantize_per_node(tpay, spec=tspec)
        for t, p in zip(tree_leaves(got), tree_leaves(packed)):
            _same(t, p.numpy())
    if tspec.uniform_bits is not None:   # the card's route for packed=False
        tree_rt = tqops.quantize_dequantize_tree_packed(
            tpay, tspec.uniform_bits, node_axis=True)
        for t, p in zip(tree_leaves(got), tree_leaves(tree_rt)):
            _same(t, p.numpy())
    for t, j in _pairs(tree_leaves(got), want):
        _same(t, j)
    assert sorted(got["student"]) == sorted(stacked)
