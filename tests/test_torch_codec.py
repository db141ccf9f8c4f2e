"""The per-leaf wire codec against the JAX package on the CPU, bit for bit:
the packed-tree tier, ``core/quantization``, ``round_ops``' per-node
codec, ``packed=False`` and the error feedback on a tree, the slice's
mnist-cnn payloads, and the new CUDA wrappers' refusals and counters.

The helpers and the tolerances, with their reasons, are in
``tests/torch_codec_helpers.py``.
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
from repro.models import model as jmodel
from repro.optim import plane as jplane
from repro_torch import wirespec as twire
from repro_torch.core import quantization as TQ
from repro_torch.core import round_ops as TR
from repro_torch.core import wire_state as TW
from repro_torch.kernels import build
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize.quantize import (
    dequantize_cuda, dequantize_rows_cuda, fused_quantize_cuda,
    fused_quantize_dequantize_cuda, quantize_dequantize_rows_cuda)
from repro_torch.models import model as tmodel
from repro_torch.optim import plane as tplane
from repro_torch.tree import tree_leaves

from torch_codec_helpers import (NEW_KERNELS, _mixed_tree, _pairs, _payload,
                                 _same, _stacked, _state_pair, _to)

torch.set_num_threads(2)


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
