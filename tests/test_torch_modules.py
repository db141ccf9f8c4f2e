"""The port's modules held against the JAX package on the CPU: configs and
wire specs, data, topology, metrics, the small mnist-cnn forward from
carried weights, the plane's layout, gradient and norm, and the wire
codec and its byte accounting.

The helpers and the tolerances, with their reasons, are in
``tests/torch_modules_helpers.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import wirespec as jwire
from repro.config import base as jbase
from repro.core import comm as jcomm
from repro.core import metrics as jmetrics
from repro.core import quantization as jquant
from repro.core import round_ops as jround_ops
from repro.core import topology as jtopo
from repro.data import loader as jloader
from repro.data.partition import partition as jpartition
from repro.data import synthetic as jsyn
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import plane as jplane
from repro_torch import wirespec as twire
from repro_torch.config import base as tbase
from repro_torch.core import comm as tcomm
from repro_torch.core import metrics as tmetrics
from repro_torch.core import profe as tprofe
from repro_torch.core import quantization as tquant
from repro_torch.core import round_ops as tround_ops
from repro_torch.core import wire_state as twire_state
from repro_torch.core import topology as ttopo
from repro_torch.data import loader as tloader
from repro_torch.data.partition import partition as tpartition
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.models import model as tmodel
from repro_torch.optim import plane as tplane
from repro_torch.tree import ShapeDtypeStruct, tree_leaves

from torch_modules_helpers import (_carried_params, _carried_resnet,
                                   _ef_states, _images, _np_tree, _small_cfg,
                                   _tcfg, carry_state)

torch.set_num_threads(2)


def test_configs_and_wirespec_match():
    for name in ("mnist-cnn", "cifar10-resnet18", "cifar100-resnet32"):
        assert dataclasses.asdict(tbase.get_config(name)) == \
            dataclasses.asdict(jbase.get_config(name))
        assert dataclasses.asdict(tmodel.derive_student(
            tbase.get_config(name))) == dataclasses.asdict(
            jmodel.derive_student(jbase.get_config(name)))
    assert dataclasses.asdict(tbase.FederationConfig()) == \
        dataclasses.asdict(jbase.FederationConfig())
    assert dataclasses.asdict(tbase.TrainConfig()) == \
        dataclasses.asdict(jbase.TrainConfig())
    for s in ("16", "8", "4", "4/16", "4/16,adapters=8", "4+ef",
              "4,adapters=8,grams=16+ef"):
        a, b = twire.WireSpec.parse(s), jwire.WireSpec.parse(s)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.arg() == b.arg() == s
        for g in ("student", "protos", "model", "adapters", "counts"):
            assert a.bits_for(g) == b.bits_for(g)
        assert a.uniform_bits == b.uniform_bits


def test_data_modules_are_byte_identical():
    for hw, k in (((28, 28, 1), 10), ((8, 8, 3), 7)):
        a = tsyn.make_image_dataset(3, 50, hw, k)
        b = jsyn.make_image_dataset(3, 50, hw, k)
        for key in b:
            assert a[key].tobytes() == b[key].tobytes()
    data = jsyn.make_image_dataset(0, 200, (8, 8, 1), 10)
    for x, y in zip(tsyn.train_test_split(data, 0.1, 4),
                    jsyn.train_test_split(data, 0.1, 4)):
        for key in y:
            assert x[key].tobytes() == y[key].tobytes()
    for split in ("iid", "noniid60", "noniid20", "dirichlet"):
        pa = tpartition(data["label"], 5, split, 2)
        pb = jpartition(data["label"], 5, split, 2)
        assert [p.tobytes() for p in pa] == [p.tobytes() for p in pb]
    for n, bs, ep in ((100, 32, 1), (70, 8, 2), (5, 8, 1)):
        la = tloader.batch_index_lists(n, bs, 7, epochs=ep)
        lb = jloader.batch_index_lists(n, bs, 7, epochs=ep)
        assert [x.tobytes() for x in la] == [x.tobytes() for x in lb]


@pytest.mark.parametrize("spec", ["full", "ring", "star", "random-k2",
                                  "er-0.4", "dynamic:ring,full",
                                  "resample:random-k2"])
def test_topology_schedule_and_lowering_are_byte_identical(spec):
    sizes = [30, 41, 25, 60, 33, 48]
    a = ttopo.make_schedule(6, spec, rounds=3, seed=5)
    b = jtopo.make_schedule(6, spec, rounds=3, seed=5)
    assert a.stack.tobytes() == b.stack.tobytes()
    for x, y in zip(a.lower(sizes), b.lower(sizes)):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a.directed_edge_counts().tolist() == \
        b.directed_edge_counts().tolist()
    assert [a.phase_index(r) for r in range(7)] == \
        [b.phase_index(r) for r in range(7)]
    assert a.permutation_rounds_at(1) == b.permutation_rounds_at(1)


def test_metrics_match():
    rng = np.random.default_rng(0)
    for _ in range(5):
        yt = rng.integers(0, 10, 300)
        yp = np.where(rng.random(300) < 0.6, yt, rng.integers(0, 10, 300))
        assert tmetrics.macro_f1(yt, yp, 12) == jmetrics.macro_f1(yt, yp, 12)
        assert tmetrics.accuracy(yt, yp) == jmetrics.accuracy(yt, yp)


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-5, 1e-5),
                                             ("bfloat16", 0.0, 0.1)])
def test_forward_matches_with_carried_weights(dtype, rtol, atol):
    jcfg = _small_cfg(dtype)
    jp, tp = _carried_params(jcfg, 1)
    img, lab = _images(2, 6)
    jo = jmodel.forward(jcfg, jp, {"image": img, "label": lab}, remat=False)
    to = tmodel.forward(_tcfg(jcfg), tp, {"image": torch.from_numpy(img)})
    assert to.logits.dtype == to.f1.dtype == torch.float32
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(to.f1.numpy(), np.asarray(jo.f1), rtol=rtol,
                               atol=atol)


def test_full_width_resnet_student_plane_layout_matches():
    """The ResNet8 student of cifar10-resnet18: 27 leaves (``stages`` a
    list of lists) in a [208, 512] plane, at the JAX package's row
    offsets, identical buffer bytes; the views come back as lists."""
    jp, tp = _carried_resnet("cifar10-resnet18", True)
    jpl = jplane.plane_from_tree(jp)
    tpl = tplane.plane_from_tree(tp)
    assert tuple(tpl.buf.shape) == (208, 512) == tuple(jpl.buf.shape)
    assert len(tpl.meta.recipe) == 27
    assert sum(int(np.prod(r[2])) for r in tpl.meta.recipe) == 96410
    assert [(r[2], r[3], r[4]) for r in tpl.meta.recipe] == \
        [(r[1], r[3], r[4]) for r in jpl.meta.recipe]
    assert tpl.buf.numpy().tobytes() == np.asarray(jpl.buf).tobytes()
    views = tplane.as_tree(tpl)
    assert isinstance(views["stages"], list) and \
        [len(st) for st in views["stages"]] == [1, 1, 1]
    for a, b in zip(tree_leaves(views), jax.tree_util.tree_leaves(jp)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    teacher = _carried_resnet("cifar10-resnet18", False)[1]
    assert len(tree_leaves(teacher)) == 58
    assert sum(x.numel() for x in tree_leaves(teacher)) == 11300938


def test_full_width_student_plane_layout_matches():
    """The mnist-cnn student's plane: [416, 512], leaves sorted by key at
    the JAX package's row offsets, identical buffer bytes."""
    jcfg = jbase.get_config("mnist-cnn")
    scfg = jmodel.derive_student(jcfg)
    jp, tp = _carried_params(scfg, 0)
    jpl = jplane.plane_from_tree(jp)
    tpl = tplane.plane_from_tree(tp)
    assert tuple(tpl.buf.shape) == (416, 512) == tuple(jpl.buf.shape)
    assert [(r[2], r[3], r[4]) for r in tpl.meta.recipe] == \
        [(r[1], r[3], r[4]) for r in jpl.meta.recipe]
    assert [r[1] for r in tpl.meta.recipe] == [
        ("conv1", "bias"), ("conv1", "kernel"), ("conv2", "bias"),
        ("conv2", "kernel"), ("fc1", "bias"), ("fc1", "kernel"),
        ("fc2", "bias"), ("fc2", "kernel")]
    assert tpl.buf.numpy().tobytes() == np.asarray(jpl.buf).tobytes()
    views = tplane.as_tree(tpl)
    for a, b in zip(tree_leaves(views), jax.tree_util.tree_leaves(jp)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    _, _, _, row, r_leaf = tpl.meta.recipe[-1]
    assert row + r_leaf == jplane.student_row_span(jpl.meta) == 409


def test_plane_gradient_lands_in_one_buffer_with_zero_padding():
    jcfg = _small_cfg()
    jp, tp = _carried_params(jcfg, 3)
    tpl = tplane.plane_from_tree(tp)
    buf = tpl.buf.clone().requires_grad_(True)
    img, lab = _images(4, 8)
    out = tmodel.forward(_tcfg(jcfg), tplane.as_tree(
        tplane.Plane(buf, tpl.meta)), {"image": torch.from_numpy(img)})
    (g,) = torch.autograd.grad(out.logits.square().mean(), [buf])
    assert g.shape == buf.shape
    mask = torch.zeros_like(g, dtype=torch.bool)
    for _, _, shape, row, r_leaf in tpl.meta.recipe:
        mask[row:row + r_leaf].view(-1)[:int(np.prod(shape))] = True
    assert float(g[~mask].abs().max()) == 0.0
    assert float(g[mask].abs().max()) > 0.0

    jpl = jplane.plane_from_tree(jp)

    def loss(pl):
        o = jmodel.forward(jcfg, jplane.plane_view_tree(pl),
                           {"image": img, "label": lab}, remat=False)
        return jnp.mean(jnp.square(o.logits))
    jg = jax.grad(loss)(jpl).buf
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)


def test_plane_global_norm_matches():
    rng = np.random.default_rng(0)
    jp, tp = _carried_params(_small_cfg(), 5)
    grads = jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
    jn = jplane.plane_global_norm(jplane.plane_from_tree(grads))
    tn = tplane.plane_global_norm(tplane.plane_from_tree(
        tmodel.params_from_numpy(grads)))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)


@pytest.mark.parametrize("bits", [16, 8])
def test_plane_payload_codec_is_bit_exact(bits):
    jcfg = _small_cfg()
    scfg = jmodel.derive_student(jcfg)
    n = 3
    rng = np.random.default_rng(bits)
    trees = [_np_tree(jmodel.init_params(scfg, jax.random.PRNGKey(i)))
             for i in range(n)]
    trees[1] = jax.tree_util.tree_map(lambda x: x * 40.0, trees[1])
    jbuf = np.stack([np.asarray(jplane.plane_from_tree(t).buf)
                     for t in trees])
    meta = jplane.plane_from_tree(trees[0]).meta
    jpl = jplane.Plane(jnp.asarray(jbuf), (), meta)
    tpl = tplane.Plane(torch.from_numpy(jbuf.copy()),
                       tplane.plane_from_tree(
                           tmodel.params_from_numpy(trees[0])).meta)
    protos = rng.standard_normal((n, 10, scfg.proto_dim)).astype(np.float32)
    protos[2] = 0.0                           # an all-zero segment -> tiny Δ
    spec_j, spec_t = jwire.WireSpec(bits), twire.WireSpec(bits)

    jb, jids, jmeta, jr, jspan = jqops.pack_plane_payload(
        jnp.asarray(protos), jpl, spec_j)
    tb, tids, tmeta, tr, tspan = tqops.pack_plane_payload(
        torch.from_numpy(protos), tpl, spec_t)
    assert tb.numpy().tobytes() == np.asarray(jb).tobytes()
    assert tids.tobytes() == np.asarray(jids).tobytes()
    assert (tr, tspan, tmeta[1], tmeta[3].tolist()) == \
        (jr, jspan, jmeta[2], jmeta[4].tolist())

    tc, ts = tqops.quantize_packed_buffer(tb, tids, tmeta[1], bits,
                                          seg_bits=tmeta[3])
    for use_kernels in (False, True):         # jnp, and Pallas interpret
        jc, js = jqops.quantize_packed_buffer(jb, jids, jmeta[2], bits,
                                              seg_bits=jmeta[4],
                                              use_kernels=use_kernels)
        assert tc.numpy().dtype == np.asarray(jc).dtype
        assert tc.numpy().tobytes() == np.asarray(jc).tobytes()
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()

    trecv = tqops.quantize_dequantize_plane_payload(
        {"protos": torch.from_numpy(protos), "student": tpl}, bits,
        spec=spec_t)
    jrecv = jqops.quantize_dequantize_plane_payload(
        {"protos": jnp.asarray(protos), "student": jpl}, bits, spec=spec_j,
        use_kernels=False)
    assert trecv["protos"].numpy().tobytes() == \
        np.asarray(jrecv["protos"]).tobytes()
    assert trecv["student"].buf.numpy().tobytes() == \
        np.asarray(jrecv["student"].buf).tobytes()


def test_wire_byte_accounting_matches():
    """Logical (Table II) and packed bytes per copy, and the accountant,
    at full mnist-cnn width for every uniform width."""
    scfg = jmodel.derive_student(jbase.get_config("mnist-cnn"))
    jtree = jax.eval_shape(lambda: jmodel.init_params(
        scfg, jax.random.PRNGKey(0)))
    jpay = {"model": jtree,
            "protos": jax.ShapeDtypeStruct((10, 128), np.dtype(np.float32)),
            "counts": jax.ShapeDtypeStruct((10,), np.dtype(np.float32))}
    tpay = {"model": jax.tree_util.tree_map(
        lambda x: ShapeDtypeStruct(tuple(x.shape), np.dtype(x.dtype)),
        jtree),
        "protos": ShapeDtypeStruct((10, 128), np.dtype(np.float32)),
        "counts": ShapeDtypeStruct((10,), np.dtype(np.float32))}
    for bits in (16, 8, 4, jwire.WireSpec(16), jwire.WireSpec(4, 16)):
        tb = twire.WireSpec(**dataclasses.asdict(bits)) \
            if isinstance(bits, jwire.WireSpec) else bits
        assert tquant.tree_wire_bytes(tpay, tb) == \
            jquant.tree_wire_bytes(jpay, bits)
        assert tcomm.packed_copy_bytes(tpay, tb) == \
            jcomm.packed_copy_bytes(jpay, bits)
    assert tcomm.packed_copy_bytes(tpay, twire.WireSpec(16)) == 426060
    ts, js = ttopo.make_schedule(6, "ring"), jtopo.make_schedule(6, "ring")
    ta, ja = tcomm.ScheduleCommAccountant(ts), jcomm.ScheduleCommAccountant(js)
    for r in range(3):
        assert ta.record_round(tpay, "profe", r, twire.WireSpec(16)) == \
            ja.record_round(jpay, "profe", r, jwire.WireSpec(16))
    assert ta.summary() == ja.summary()


def test_codec_state_carries_and_stacks_like_jax():
    """``init_codec_state``, ``node_state_from_numpy(residual=)`` and
    ``stack_states`` against ``repro``'s state of the same shapes."""
    scfg, jstates, jst, zero, jws, _ = _ef_states()
    n = len(jstates)
    tstates = [tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t), np.asarray(st.global_protos),
        np.asarray(st.proto_mask), int(st.round_idx),
        residual={"protos": np.asarray(jws.residual["protos"][i]),
                  "student": np.asarray(jws.residual["student"].buf[i])},
        seq=int(jws.seq[i]), device="cpu") for i, st in enumerate(jstates)]
    tst = tprofe.stack_states(tstates)
    tws = tst.wire_state
    assert tws.residual["protos"].numpy().tobytes() == \
        np.asarray(jws.residual["protos"]).tobytes()
    assert tws.residual["student"].buf.numpy().tobytes() == \
        np.asarray(jws.residual["student"].buf).tobytes()
    assert tws.residual["student"].meta == tst.student.meta
    assert tws.seq.dtype == torch.int32 and tws.seq.tolist() == [4] * n
    assert twire_state.next_seq(tws.seq).tolist() == [5] * n

    tzero = twire_state.init_codec_state(
        {"protos": torch.zeros((n, 10, scfg.proto_dim)),
         "student": tst.student}, n_nodes=n)
    for t, j in ((tzero.residual["protos"], zero.residual["protos"]),
                 (tzero.residual["student"].buf, zero.residual["student"].buf),
                 (tzero.seq, zero.seq)):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
        assert t.numpy().dtype == np.asarray(j).dtype
    with pytest.raises(ValueError, match="wire_state"):
        tprofe.stack_states([tstates[0], carry_state(jstates[1])])


@pytest.mark.parametrize("decay", [1.0, 0.5])
def test_round_ops_ef_codec_matches_jax(decay):
    """``quantize_dequantize_per_node(state=)`` on a ``4/16+ef`` spec:
    the receiver view and the new ``CodecState`` (residual bit for bit,
    ``seq`` advanced by one) against ``repro``'s, eagerly."""
    scfg, jstates, jst, _, jws, real = _ef_states(seq=2)
    n = len(jstates)
    rng = np.random.default_rng(9)
    protos = rng.standard_normal((n, 10, scfg.proto_dim)).astype(np.float32)
    tmeta = carry_state(jstates[0]).student.meta
    buf = np.asarray(jst.student.buf)
    tpay = {"protos": torch.from_numpy(protos),
            "student": tplane.Plane(torch.from_numpy(buf.copy()), tmeta)}
    tws = twire_state.CodecState(
        {"protos": torch.from_numpy(np.array(jws.residual["protos"])),
         "student": tplane.Plane(torch.from_numpy(np.array(
             jws.residual["student"].buf)), tmeta)},
        torch.from_numpy(np.array(jws.seq)))
    tspec = twire.WireSpec(4, 16, error_feedback=True, ef_decay=decay)
    jspec = jwire.WireSpec(4, 16, error_feedback=True, ef_decay=decay)
    trecv, tnew = tround_ops.quantize_dequantize_per_node(tpay, spec=tspec,
                                                          state=tws)
    jrecv, jnew = jround_ops.quantize_dequantize_per_node(
        {"protos": jnp.asarray(protos), "student": jst.student}, spec=jspec,
        use_kernels=False, state=jws)
    for t, j in ((trecv["protos"], jrecv["protos"]),
                 (trecv["student"].buf, jrecv["student"].buf),
                 (tnew.residual["protos"], jnew.residual["protos"]),
                 (tnew.residual["student"].buf, jnew.residual["student"].buf)):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    assert tnew.seq.tolist() == np.asarray(jnew.seq).tolist() == [3] * n
    assert not tnew.residual["student"].buf.numpy()[:, ~real].any()
    with pytest.raises(ValueError, match="CodecState"):
        tround_ops.quantize_dequantize_per_node(tpay, spec=tspec)
