"""The port's adapter-rank wire, held against the JAX package on the CPU.

Every case feeds the same numpy inputs, made from a seed, to the JAX
function and to its port.  Tolerances and why:

* the layout (names, ``is_mat``, shapes) and the threefry bits behind Ω
  exactly; Ω itself within 4 ulp (numpy's fp32 ``log1p`` and XLA's round
  differently in the last bits of the ``erfinv`` argument);
* ``orthonormalize`` on the same sketch ``rtol=1e-5``; the factors of a
  delta (which also see Ω's few-ulp gap) and the gram carry ``rtol=1e-5``
  with ``atol`` 1e-5 of the array's largest entry (entries near zero
  have no relative precision); a zero delta gives exactly zero factors;
* ``regmean_adjust`` ``rtol=1e-4`` (the ridge amplifies last-bit
  differences of the solve's inputs up to ~1e3);
* the plain ``lowrank_apply`` against JAX's ``ref.py`` and the
  interpret-mode Pallas kernel ``rtol=1e-6`` (an ulp of ``w + delta``)
  and ``atol`` 1e-6 of the largest delta entry (those sum each
  ``B @ A`` in XLA's order, with fused multiply-adds);
* the per-leaf tree codec: codes, scales and the reconstruction bit for
  bit (the same sweeps on the same buffer);
* share / merge on a stacked student: factors as above, the merged plane
  ``atol=2e-6`` (naive) or 1e-4 of the merge's largest step (RegMean, as
  ``regmean_adjust``);
* whole runs from carried states: bytes exactly, node 0's F1 and
  accuracy exactly in fp32, the student plane after each round within
  ``RUN_ATOL`` (see there); with the factor groups at their own widths,
  a bounded count of factor code flips and, beyond ``RUN_ATOL``, what
  those flips can move the merge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import adapters as JA
from repro.core import aggregation as jagg
from repro.core import federation as JF
from repro.core import round_ops as jround
from repro.kernels.lowrank_apply import ops as jlow_ops
from repro.kernels.lowrank_apply.lowrank_apply import lowrank_apply_pallas
from repro.kernels.lowrank_apply.ref import lowrank_apply_ref as jlow_ref
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro.wirespec import WireSpec as JWireSpec
from repro_torch.config import base as tbase
from repro_torch.core import adapters as TA
from repro_torch.core import aggregation as tagg
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import round_ops as tround
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.kernels import build
from repro_torch.kernels.lowrank_apply import ops as tlow_ops
from repro_torch.kernels.lowrank_apply.lowrank_apply import \
    lowrank_apply_cuda
from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.models import init_params
from repro_torch.optim.plane import Plane, _leaf_view, as_tree, plane_from_tree
from repro_torch.tree import keystr, tree_from_paths, tree_leaves, tree_paths
from repro_torch.wirespec import WireSpec

torch.set_num_threads(2)

N_NODES = 4


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _close(got, want, rtol=1e-5, scale=1e-5):
    """``rtol`` plus an ``atol`` of ``scale`` times the largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


# -- layout and Ω -------------------------------------------------------------

def _student_shapes(model):
    if model == "mnist":
        cfg = jbase.get_config("mnist-cnn")
    else:
        cfg = jbase.get_config("cifar10-resnet18").replace(
            resnet_blocks=(2, 2), resnet_width=16)
    jscfg = jmodel.derive_student(cfg)
    jtree = jax.eval_shape(lambda: jmodel.init_params(jscfg,
                                                      jax.random.PRNGKey(0)))
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jscfg))
    ttree = init_params(tcfg, torch.Generator().manual_seed(0))
    return jtree, ttree


@pytest.mark.parametrize("model", ["mnist", "resnet"])
def test_layout_and_names_match_jax(model):
    """The layout of the full-width mnist student and of a small ResNet
    student (1x1 projections, lists of stages): names, matrix flags and
    shapes as JAX's, and ``keystr`` renders every path as JAX does."""
    jtree, ttree = _student_shapes(model)
    for rank in (4, 8):
        jl = JA.adapter_layout(jtree, rank)
        tl = TA.adapter_layout(ttree, rank)
        assert tl.names == jl.names
        assert tl.is_mat == jl.is_mat
        assert tl.shapes == jl.shapes
        assert tl.mat_names == jl.mat_names and tl.n_mats > 0
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [keystr(p) for p, _ in tree_paths(ttree)] == jpaths
    if model == "mnist":
        assert TA.adapter_layout(ttree, 8).mat_names == (
            "['conv2']['kernel']", "['fc1']['kernel']", "['fc2']['kernel']")
    # split / merge round-trip the tree
    tl = TA.adapter_layout(ttree, 8)
    mats, rest = TA.split_student(tl, ttree)
    back = TA.merge_student(tl, mats, rest)
    assert [keystr(p) for p, _ in tree_paths(back)] == jpaths
    assert all(a is b for a, b in zip(tree_leaves(back), tree_leaves(ttree)))


def test_threefry_bits_match_jax():
    """The key derivation and the random bits exactly."""
    key = jax.random.fold_in(jax.random.PRNGKey(0xADA), 123456)
    tkey = TA._fold_in((0, 0xADA), 123456)
    assert tkey == tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    want = np.asarray(jax.random.bits(key, (37, 5), jnp.uint32)).ravel()
    np.testing.assert_array_equal(TA._random_bits(tkey, 37 * 5), want)


@pytest.mark.parametrize("name,k,rank", [
    ("['fc1']['kernel']", 128, 8), ("['conv2']['kernel']", 32, 8),
    ("['fc2']['kernel']", 10, 8), ("['stages'][1][0]['proj']['kernel']",
                                   64, 4)])
def test_omega_within_4_ulp_of_jax(name, k, rank):
    want = np.asarray(JA._omega(name, k, rank))
    got = TA._omega(name, k, rank).numpy()
    assert got.dtype == np.float32 and got.shape == (k, rank)
    u = _ulps(got, want)
    assert int(u.max()) <= 4
    assert np.mean(u == 0) > 0.9      # most entries are bit-equal


# -- factors ------------------------------------------------------------------

def test_orthonormalize_matches_jax_and_keeps_zero_columns():
    rng = _rng(1)
    y = _normal(rng, 3, 2, 40, 8)
    y[1, 0, :, 5] = 0.0                       # an exactly-zero column
    want = np.asarray(JA.orthonormalize(jnp.asarray(y)))
    got = TA.orthonormalize(_t(y)).numpy()
    _close(got, want)
    assert not got[1, 0, :, 5].any()
    q = got[0, 1]
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-5)


@pytest.mark.parametrize("lead", [(), (3, 3)], ids=["matrix", "conv"])
def test_factorize_and_gram_update_match_jax(lead):
    rng = _rng(2)
    name = "['conv2']['kernel']" if lead else "['fc1']['kernel']"
    delta = _normal(rng, N_NODES, *lead, 40, 24, scale=0.01)
    jb, ja = JA.factorize_delta(jnp.asarray(delta), name, 8)
    tb, ta = TA.factorize_delta(_t(delta), name, 8)
    assert tuple(tb.shape) == (N_NODES,) + lead + (40, 8)
    assert tuple(ta.shape) == (N_NODES,) + lead + (8, 24)
    _close(tb.numpy(), jb)
    _close(ta.numpy(), ja)
    prev = _normal(rng, N_NODES, *lead, 24, 24, scale=1e-4)
    jg = JA.gram_update({name: {"A": ja}}, {name: jnp.asarray(prev)})
    tg = TA.gram_update({name: {"A": _t(np.asarray(ja))}}, {name: _t(prev)})
    _close(tg[name].numpy(), jg[name])
    # a zero delta makes exactly zero factors
    zb, za = TA.factorize_delta(torch.zeros_like(_t(delta)), name, 8)
    assert not zb.any() and not za.any()


def test_init_state_template_and_zero_payload_match_jax():
    """On a stacked full-width mnist student: the initial adapter state
    (references, zero grams), the zero wire payload and the per-copy
    payload template, key for key and shape for shape as JAX's."""
    jtree, ttree = _student_shapes("mnist")
    rng = _rng(3)
    arrays = [_normal(rng, N_NODES, *x.shape)
              for x in jax.tree_util.tree_leaves(jtree)]
    jst = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jtree), [jnp.asarray(a) for a in arrays])
    tst = tree_from_paths((p, _t(a)) for (p, _), a in
                          zip(tree_paths(ttree), arrays))
    jl = JA.adapter_layout(jst, 8, node_axis=True)
    tl = TA.adapter_layout(tst, 8, node_axis=True)
    for grams in (False, True):
        js = JA.init_adapter_state(jl, jst, grams=grams)
        ts = TA.init_adapter_state(tl, tst, grams=grams)
        assert sorted(ts) == sorted(js)
        for key in ts:
            assert sorted(ts[key]) == sorted(js[key])
            for n in ts[key]:
                np.testing.assert_array_equal(ts[key][n].numpy(),
                                              np.asarray(js[key][n]))
        jz = JA.zero_wire_payload(jl, jst, grams=grams)
        tz = TA.zero_wire_payload(tl, tst, grams=grams)
        assert [keystr(p) for p, _ in tree_paths(tz)] == [
            jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jz)[0]]
        assert [tuple(x.shape) for x in tree_leaves(tz)] == [
            x.shape for x in jax.tree_util.tree_leaves(jz)]
        assert not any(x.any() for x in tree_leaves(tz))
        jt = JA.adapter_payload_template(jl, grams=grams)
        tt = TA.adapter_payload_template(tl, grams=grams)
        assert [(keystr(p), tuple(x.shape)) for p, x in tree_paths(tt)] == [
            (jax.tree_util.keystr(p), x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(jt)[0]]


def test_reference_snapshot_does_not_alias_the_plane():
    """The port updates the student plane in place, so the reference
    the next delta is taken against must be a copy: after an in-place
    step the delta is non-zero, and the share's new reference keeps the
    shared weights while the plane moves on."""
    rng = _rng(4)
    cfg = tbase.get_config("mnist-cnn").replace(cnn_channels=(24, 32),
                                                proto_dim=16)
    scfg = TF.derive_student(cfg)
    planes = [plane_from_tree(init_params(scfg, torch.Generator()
                                          .manual_seed(i)))
              for i in range(N_NODES)]
    plane = Plane(torch.stack([p.buf for p in planes]).requires_grad_(),
                  planes[0].meta)
    tree = as_tree(plane)
    layout = TA.adapter_layout(tree, 8, node_axis=True)
    assert layout.n_mats == 3
    state = TA.init_adapter_state(layout, tree)
    step = _t(_normal(rng, *plane.buf.shape, scale=1e-3))
    with torch.no_grad():
        plane.buf.add_(step)                   # an optimizer's in-place step
    groups, new_state, _ = tround.adapter_share_nodes(plane, state, rank=8)
    for n, f in groups["adapters"].items():
        assert f["A"].abs().max() > 0 and f["B"].abs().max() > 0
    shared = {n: v.clone() for n, v in new_state["ref"].items()}
    with torch.no_grad():
        plane.buf.add_(step)
    mats, _ = TA.split_student(layout, as_tree(plane))
    for n, ref in new_state["ref"].items():
        assert torch.equal(ref, shared[n])
        assert not torch.equal(ref, mats[n])
        assert ref.untyped_storage().data_ptr() != \
            plane.buf.untyped_storage().data_ptr()


# -- RegMean ------------------------------------------------------------------

@pytest.mark.parametrize("per_recv,lead", [(False, ()), (False, (3, 3)),
                                           (True, ()), (True, (2,))])
def test_regmean_adjust_matches_jax(per_recv, lead):
    rng = _rng(5)
    s, n, r, k = 3, 4, 5, 12
    recv = (n,) if per_recv else ()
    a = _normal(rng, *recv, s, *lead, r, k)
    m = _normal(rng, *recv, s, *lead, k, k)
    grams = (np.swapaxes(m, -1, -2) @ m / k).astype(np.float32)
    coeffs = (rng.random((n, s)) + 0.1).astype(np.float32)
    coeffs[1, 2] = 0.0                        # a non-neighbour
    want = jagg.regmean_adjust(jnp.asarray(a), jnp.asarray(grams),
                               jnp.asarray(coeffs), per_recv=per_recv)
    got = tagg.regmean_adjust(_t(a), _t(grams), _t(coeffs),
                              per_recv=per_recv)
    assert tuple(got.shape) == tuple(want.shape) == (n, s) + lead + (r, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


# -- lowrank_apply ------------------------------------------------------------

def _apply_inputs(seed, n, s, lead, d, k, r, per_recv):
    rng = _rng(seed)
    w = _normal(rng, n, *lead, d, k)
    coeffs = (rng.random((n, s)) / s).astype(np.float32)
    b = _normal(rng, s, *lead, d, r, scale=0.3)
    a = _normal(rng, *((n,) if per_recv else ()), s, *lead, r, k, scale=0.1)
    return w, coeffs, b, a


@pytest.mark.parametrize("per_recv", [False, True], ids=["shared",
                                                         "per_recv"])
@pytest.mark.parametrize("lead", [(), (3, 3)], ids=["matrix", "conv"])
def test_lowrank_apply_plain_matches_jax_ref_and_kernel(per_recv, lead):
    """The plain version against JAX's ``ref.py`` and against the
    interpret-mode Pallas kernel (lead axes through JAX's batched
    dispatch), at odd tile edges (d = 70, k = 40)."""
    n, s, d, k, r = 3, 4, 70, 40, 8
    w, coeffs, b, a = _apply_inputs(6, n, s, lead, d, k, r, per_recv)
    got = lowrank_apply_ref(_t(w), _t(coeffs), _t(b), _t(a)).numpy()
    delta_max = float(np.abs(got - w).max())
    args = tuple(map(jnp.asarray, (w, coeffs, b, a)))
    for want in (jlow_ref(*args),
                 jlow_ops.lowrank_apply(*args, use_kernels=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * delta_max)
    if not lead:
        want = lowrank_apply_pallas(*args, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * delta_max)


def test_lowrank_apply_fixes_its_order_of_operations():
    """The plain version IS the kernel's arithmetic: per element, the
    rank sum from the t = 0 product, the sender terms from the j = 0
    term, one add onto w — replayed here in numpy fp32 scalars.  No
    senders returns w."""
    n, s, d, k, r = 2, 3, 5, 4, 3
    w, coeffs, b, a = _apply_inputs(7, n, s, (), d, k, r, True)
    got = lowrank_apply_ref(_t(w), _t(coeffs), _t(b), _t(a)).numpy()
    f32 = np.float32
    for i in range(n):
        for x in range(d):
            for y in range(k):
                acc = None
                for j in range(s):
                    dot = f32(b[j, x, 0] * a[i, j, 0, y])
                    for t in range(1, r):
                        dot = f32(dot + f32(b[j, x, t] * a[i, j, t, y]))
                    term = f32(coeffs[i, j] * dot)
                    acc = term if acc is None else f32(acc + term)
                assert got[i, x, y] == f32(w[i, x, y] + acc)
    empty = lowrank_apply_ref(_t(w), _t(coeffs[:, :0]), _t(b[:0]),
                              _t(a[:, :0]))
    assert torch.equal(empty, _t(w))


def test_lowrank_apply_cpu_dispatch_writes_a_strided_plane_view():
    """``ops.lowrank_apply(out=view)`` on a CPU plane span: the result
    lands in the buffer, padding lanes and other rows untouched."""
    n, s, d, k, r = 3, 3, 12, 10, 4
    w, coeffs, b, a = _apply_inputs(8, n, s, (), d, k, r, False)
    buf = torch.zeros((n, 4, 512))
    per = d * k                                    # 120 of 512 lanes
    buf[:, 1].view(n, -1)[:, :per] = _t(w).reshape(n, -1)
    view = buf[:, 1:2].reshape(n, -1)[:, :per].reshape(n, d, k)
    want = lowrank_apply_ref(_t(w), _t(coeffs), _t(b), _t(a))
    out = tlow_ops.lowrank_apply(view, _t(coeffs), _t(b), _t(a), out=view)
    assert out is view
    assert torch.equal(buf[:, 1, :per].reshape(n, d, k), want)
    assert not buf[:, 1, per:].any() and not buf[:, [0, 2, 3]].any()


def test_lowrank_apply_wrapper_rejects_cpu_tensors_and_counts():
    x = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        lowrank_apply_cuda(x, torch.ones((2, 1)), torch.zeros((1, 8, 2)),
                           torch.zeros((1, 2, 8)))
    assert "lowrank_apply" in build.launch_counts()
    assert "lowrank_apply.cu" in build.SOURCES
    assert 'extern "C" int lowrank_apply(' in \
        (build.CSRC / "lowrank_apply.cu").read_text()


# -- the per-leaf tree codec ---------------------------------------------------

def _adapter_payload(seed, grams=False):
    """A stacked adapter-wire payload: factors of a conv and a matrix
    leaf, prototypes, the dense rest (and grams)."""
    rng = _rng(seed)
    pay = {
        "adapters": {
            "['conv2']['kernel']": {"A": _normal(rng, N_NODES, 3, 3, 8, 16),
                                    "B": _normal(rng, N_NODES, 3, 3, 12, 8)},
            "['fc1']['kernel']": {"A": _normal(rng, N_NODES, 8, 16),
                                  "B": _normal(rng, N_NODES, 300, 8)}},
        "protos": _normal(rng, N_NODES, 10, 16, scale=0.1),
        "student": {"['conv1']['bias']": _normal(rng, N_NODES, 12),
                    "['fc1']['bias']": _normal(rng, N_NODES, 16) * 0}}
    if grams:
        pay["grams"] = {"['conv2']['kernel']":
                        _normal(rng, N_NODES, 3, 3, 16, 16),
                        "['fc1']['kernel']": _normal(rng, N_NODES, 16, 16)}
    return pay


def _to(tree, fn):
    return jax.tree_util.tree_map(fn, tree)


@pytest.mark.parametrize("wire,grams", [("4", False), ("4", True),
                                        ("4/16,adapters=8", True),
                                        ("4,adapters=8,grams=16", True)])
def test_tree_codec_matches_jax_bit_for_bit(wire, grams):
    """Codes, scales, segment widths and the reconstruction of the
    adapter payload bit-exact against ``repro``'s packed node codec
    (eager, its plain sweeps) and its leaf-local round trip, uniform and
    with per-group widths; the per-node entry point gives the same view,
    and an error-feedback spec without its residual raises (error
    feedback itself: ``tests/test_torch_tree_ef.py``)."""
    pay = _adapter_payload(9, grams)
    jspec, tspec = JWireSpec.parse(wire), WireSpec.parse(wire)
    bits = tspec.uniform_bits or 16
    jpay = jqops.quantize_tree_packed_nodes(
        _to(pay, jnp.asarray), bits, spec=jspec, use_kernels=False)
    tpay = tqops.quantize_tree_packed_nodes(_to(pay, _t), bits, spec=tspec)
    assert tpay["codes"].dtype == {4: torch.int8, 8: torch.int8,
                                   16: torch.int16}[tspec.max_bits]
    np.testing.assert_array_equal(tpay["codes"].numpy(),
                                  np.asarray(jpay["codes"]))
    np.testing.assert_array_equal(tpay["scales"].numpy(),
                                  np.asarray(jpay["scales"]))
    np.testing.assert_array_equal(tpay["seg_ids"], jpay["seg_ids"])
    np.testing.assert_array_equal(tpay["seg_bits"], jpay["seg_bits"])
    trecv = tqops.dequantize_tree_packed_nodes(tpay)
    jrecv = jqops.quantize_dequantize_tree_packed_nodes(
        _to(pay, jnp.asarray), bits, spec=jspec, use_kernels=False)
    tl = tree_paths(trecv)
    jl = jax.tree_util.tree_flatten_with_path(jrecv)[0]
    assert [keystr(p) for p, _ in tl] == [jax.tree_util.keystr(p)
                                          for p, _ in jl]
    for (_, a), (_, b) in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = tround.quantize_dequantize_per_node(_to(pay, _t), spec=tspec)
    for a, (_, b) in zip(tree_leaves(again), tl):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no residual"):
        tqops.quantize_tree_packed_nodes(
            _to(pay, _t), bits, spec=WireSpec.parse(wire + "+ef"))


# -- share and merge on a stacked student ------------------------------------

def _stacked_student(seed, channels=(24, 32), proto_dim=16):
    """A node-stacked student as numpy leaves, the port's plane and
    JAX's plane of them."""
    cfg = tbase.get_config("mnist-cnn").replace(cnn_channels=channels,
                                                proto_dim=proto_dim)
    scfg = TF.derive_student(cfg)
    trees = [init_params(scfg, torch.Generator().manual_seed(seed + i))
             for i in range(N_NODES)]
    paths = [p for p, _ in tree_paths(trees[0])]
    leaves = [np.stack([_np(x) for x in xs])
              for xs in zip(*map(tree_leaves, trees))]
    planes = [plane_from_tree(t) for t in trees]
    tplane = Plane(torch.stack([p.buf for p in planes]), planes[0].meta)
    jtree = {}
    for p, x in zip(paths, leaves):
        jtree.setdefault(p[0], {})[p[1]] = jnp.asarray(x)
    return leaves, tplane, jax.vmap(jplane.plane_from_tree)(jtree)


@pytest.mark.parametrize("grams", [False, True], ids=["naive", "regmean"])
def test_share_and_merge_match_jax(grams):
    """``adapter_share_nodes`` (factors, the new reference, grams) and
    ``adapter_merge_nodes`` (the merged plane, naive and RegMean) on the
    same stacked student, reference and received view."""
    rng = _rng(10)
    _, tplane, jplane_ = _stacked_student(11)
    tl = TA.adapter_layout(as_tree(tplane), 8, node_axis=True)
    refs = {n: _np(m) + _normal(rng, *m.shape, scale=1e-2)
            for n, m in TA.split_student(tl, as_tree(tplane))[0].items()}
    prev = {}                                 # earlier rounds' grams
    for n, r in refs.items():
        a = _normal(rng, *r.shape[:-2], 8, r.shape[-1], scale=1e-2)
        prev[n] = np.swapaxes(a, -1, -2) @ a
    jst = {"ref": _to(refs, jnp.asarray)}
    tst = {"ref": _to(refs, _t)}
    if grams:
        jst["grams"], tst["grams"] = _to(prev, jnp.asarray), _to(prev, _t)
    jgroups, jnew, _ = jround.adapter_share_nodes(jplane_, jst, rank=8,
                                                  grams=grams)
    tgroups, tnew, _ = tround.adapter_share_nodes(tplane, tst, rank=8,
                                                  grams=grams)
    assert sorted(tgroups) == sorted(jgroups)
    for n in tl.mat_names:
        for key in ("A", "B"):
            _close(tgroups["adapters"][n][key].numpy(),
                   jgroups["adapters"][n][key])
        np.testing.assert_array_equal(tnew["ref"][n].numpy(),
                                      np.asarray(jnew["ref"][n]))
        if grams:
            _close(tgroups["grams"][n].numpy(), jgroups["grams"][n])
    for n, x in tgroups["student"].items():
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(jgroups["student"][n]))

    # the merge, from one received view (JAX's groups through numpy)
    recv = _to({k: v for k, v in jgroups.items()}, np.asarray)
    w_self, w_neigh = tround.gossip_matrix(1.0 - np.eye(N_NODES),
                                           [5, 6, 7, 8])
    jmerged = jround.adapter_merge_nodes(
        jplane_, _to(recv, jnp.asarray), jnp.asarray(w_self),
        jnp.asarray(w_neigh), rank=8, grams=grams)
    before = tplane.buf.numpy().copy()
    tmerged = tround.adapter_merge_nodes(tplane, _to(recv, _t), _t(w_self),
                                         _t(w_neigh), rank=8, grams=grams)
    assert tmerged is tplane                  # merged in place
    # RegMean: the solve's ~1e3 amplification of last-bit gaps, relative
    # to the merge's largest step (as regmean_adjust's rtol=1e-4)
    step = float(np.abs(np.asarray(jmerged.buf) - before).max())
    np.testing.assert_allclose(tplane.buf.numpy(), np.asarray(jmerged.buf),
                               rtol=0, atol=1e-4 * step if grams else 2e-6)
    # the padding lanes stay zero
    real = torch.zeros(tplane.buf.shape[1:], dtype=torch.bool)
    for _, _, shape, row, r_leaf in tplane.meta.recipe:
        real[row:row + r_leaf].view(-1)[:int(np.prod(shape))] = True
    assert not tplane.buf[:, ~real].any()


def test_merge_takes_only_a_plane():
    """The merge writes a stacked student plane in place and returns it;
    a per-leaf student tree (``param_plane="off"``) is merged into a new
    tree through the same ``lowrank_apply`` a matrix leaf, bit-identical
    to the plane's leaf views, and left as it was."""
    _, tplane, _ = _stacked_student(13)
    tree = jax.tree_util.tree_map(lambda x: x.clone(), as_tree(tplane))
    tl = TA.adapter_layout(tree, 8, node_axis=True)
    mats, rest = TA.split_student(tl, tree)
    recv = {"adapters": TA.factorize_deltas(
        tl, mats, {n: m * 0.9 for n, m in mats.items()}), "student": rest}
    w_self, w_neigh = (_t(x) for x in tround.gossip_matrix(
        1.0 - np.eye(N_NODES), [1, 2, 3, 4]))
    before = [x.clone() for x in tree_leaves(tree)]
    merged = tround.adapter_merge_nodes(tree, recv, w_self, w_neigh, rank=8)
    assert merged is not tree
    for a, b in zip(tree_leaves(tree), before):
        assert torch.equal(a, b)
    out = tround.adapter_merge_nodes(tplane, recv, w_self, w_neigh, rank=8)
    assert out is tplane
    for a, b in zip(tree_leaves(merged), tree_leaves(as_tree(tplane))):
        assert torch.equal(a, b)


# -- whole runs ----------------------------------------------------------------

def _setup(rounds=2, per_node=48, batch=16, **fed_extra):
    """mnist-cnn with teacher channels (24, 32) and proto_dim 16, so that
    its student factors conv2 (3x3 lead), fc1 and fc2 at rank 8."""
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=(24, 32), proto_dim=16, dtype="float32")
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed_kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full",
                  quantize_bits=4, adapter_rank=8, **fed_extra)
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tcfg, node_data, test_d,
            jbase.FederationConfig(**fed_kw), tbase.FederationConfig(**fed_kw),
            jbase.TrainConfig(**train_kw), tbase.TrainConfig(**train_kw))


def _carry(st):
    return tprofe.node_state_from_numpy(
        _to(jplane.as_tree(st.student), np.asarray),
        _to(st.teacher, np.asarray), _to(st.opt_s, np.asarray),
        _to(st.opt_t, np.asarray), np.asarray(st.global_protos),
        np.asarray(st.proto_mask), int(st.round_idx), device="cpu")


def _recording(make_round_fn, planes):
    """Wrap a package's ``_make_round_fn``: record the student plane
    after every round."""
    def make(*args, **kwargs):
        fn = make_round_fn(*args, **kwargs)

        def round_fn(state, *inputs, **kw):
            out = fn(state, *inputs, **kw)
            planes.append(_np(out.student.buf))
            return out
        return round_fn
    return make


# The student plane after each round, fp32.  The adapter factors ride
# int4: one code step is max|A| / 7 or max|B| / 7, so a code that flips
# between the frameworks (the trained students differ by a few ulp, Ω by
# a few ulp) would move a merged weight by ~1e-3; none flips in the
# naive run, and the three conv2 B codes that flip in the RegMean run's
# second round stay inside its REGMEAN_RTOL term.
# Naive merge: the planes differ by those last bits carried through the
# factorization and the merge — RUN_ATOL.  RegMean: the ridge of the
# solve amplifies the same gaps up to ~1e3 (REGMEAN_EPS), so the planes
# are held to RUN_ATOL plus REGMEAN_RTOL of the round's largest step
# |plane after - plane before| (largest gap seen 2.6e-4 of it).
RUN_ATOL = 2e-6
REGMEAN_RTOL = 1e-3
# With their own widths (8-bit factors, 16-bit grams) the factor codes
# are 18x finer than int4, and factors whose last bits differ between
# the frameworks now and then round to neighbouring codes: one code step,
# 1/127 of the sender's largest entry of that factor.  Such flips are
# counted per round (an entry that differs by more than FLIP_REL of its
# sender's largest; at most MAX_ADAPTER_FLIPS of the ~3.5e4 factor
# codes, 41 seen), and the planes may differ beyond the bound above by
# what the two received views' difference can move the merge
# (_merge_allowance), carried into the later rounds.
FLIP_REL = 1e-3
MAX_ADAPTER_FLIPS = 64


def _record_views(monkeypatch):
    """Record each round's receiver-side factors (and grams) of both
    packages as numpy (``repro``'s from inside its jitted round)."""
    jviews, tviews = [], []
    jqdq = jround.quantize_dequantize_per_node
    tqdq = tround.quantize_dequantize_per_node

    def keep(views, out):
        views.append({g: _to(out[g], np.array)
                      for g in ("adapters", "grams") if g in out})

    def jwrap(tree, *args, **kwargs):
        out = jqdq(tree, *args, **kwargs)
        jax.debug.callback(lambda o: keep(jviews, o), out)
        return out

    def twrap(tree, *args, **kwargs):
        out = tqdq(tree, *args, **kwargs)
        keep(tviews, out)
        return out
    monkeypatch.setattr(jround, "quantize_dequantize_per_node", jwrap)
    monkeypatch.setattr(tround, "quantize_dequantize_per_node", twrap)
    return jviews, tviews


def _count_flips(tview, jview):
    """Factor entries of one round's received views that differ by more
    than ``FLIP_REL`` of their sender's largest entry."""
    flips = 0
    for name, f in jview["adapters"].items():
        for key, want in f.items():
            s = want.shape[0]
            gap = np.abs(tview["adapters"][name][key] - want).reshape(s, -1)
            top = np.abs(want).reshape(s, -1).max(axis=1, keepdims=True)
            flips += int(np.count_nonzero(gap > FLIP_REL * top))
    return flips


def _merge_allowance(tview, jview, coeffs, meta, names, grams, like):
    """How far the two merges of one round may differ, per plane lane,
    because their received views differ: per receiver ``i`` and matrix
    leaf, ``Σ_j c_ij·(|B_j - B'_j| @ |Ã_ij| + |B'_j| @ |Ã_ij - Ã'_ij|)``
    (``Ã`` = ``A``, or the port's RegMean adjustment of each view)."""
    c = torch.as_tensor(coeffs, dtype=torch.float32)
    allow = torch.zeros(like.shape, dtype=torch.float64)
    for name, (_, _, shape, row, r_leaf) in zip(names, meta.recipe):
        if name not in jview["adapters"]:
            continue
        bt, at, bj, aj = (torch.as_tensor(v["adapters"][name][key])
                          for v in (tview, jview) for key in ("B", "A"))
        if grams:
            at = tagg.regmean_adjust(at, torch.as_tensor(tview["grams"][name]),
                                     c, per_recv=False)
            aj = tagg.regmean_adjust(aj, torch.as_tensor(jview["grams"][name]),
                                     c, per_recv=False)
        else:
            at, aj = at[None], aj[None]         # shared by every receiver
        at, aj, bt, bj = (x.double() for x in (at, aj, bt, bj))
        per = (bt - bj).abs() @ at.abs() + bj.abs() @ (at - aj).abs()
        per = per.expand((c.shape[0],) + tuple(per.shape[1:]))
        _leaf_view(allow, shape, row, r_leaf).copy_(
            torch.einsum("is,is...->i...", c.double(), per))
    return allow.numpy()


@pytest.mark.parametrize("grams,widths", [
    (False, {}), (True, {}), (False, dict(adapter_quantize_bits=8)),
    (True, dict(adapter_quantize_bits=8, gram_quantize_bits=16))],
    ids=["naive", "regmean", "naive-adapters8", "regmean-adapters8-grams16"])
def test_run_federation_adapter_wire_matches_jax(grams, widths, monkeypatch):
    """``run_federation`` with ``adapter_rank=8`` on the int4 wire, naive
    and with grams, 4 nodes, 2 rounds, from JAX's own initial states
    carried through numpy: bytes exactly, the plane after each round to
    ``RUN_ATOL`` (RegMean: plus ``REGMEAN_RTOL`` of the round's step), F1
    and accuracy per round exactly.  ``widths`` gives the factor (and
    gram) groups their own wire widths (``FederationConfig.
    adapter_quantize_bits`` / ``gram_quantize_bits``): the student rest
    stays int4, so the share takes the mixed-width codec.  The last
    round's factors come back finite and non-zero in ``extras``."""
    jcfg, tcfg, node_data, test_d, jfed, tfed, jtrain, ttrain = _setup(
        adapter_grams=grams, **widths)
    if widths:
        jviews, tviews = _record_views(monkeypatch)
    jplanes, tplanes = [], []
    monkeypatch.setattr(JF, "_make_round_fn",
                        _recording(JF._make_round_fn, jplanes))
    monkeypatch.setattr(TF, "_make_round_fn",
                        _recording(TF._make_round_fn, tplanes))
    jres = JF.run_federation(jcfg, jfed, jtrain, node_data, test_d)
    scfg = jmodel.derive_student(jcfg)
    opt_s = jplane.make_plane_optimizer("adamw", jtrain.learning_rate,
                                        weight_decay=jtrain.weight_decay,
                                        grad_clip=jtrain.grad_clip)
    opt_t = jmake_optimizer("adamw", jtrain.learning_rate,
                            weight_decay=jtrain.weight_decay)
    jstates = JF._init_states("profe", (jcfg, scfg), jfed, opt_s, opt_t, 10,
                              plane=True)
    tres = TF.run_federation(tcfg, tfed, ttrain, node_data, test_d,
                             initial_states=[_carry(s) for s in jstates],
                             device="cpu")
    for key in ("avg_sent_gb", "avg_received_gb", "wire_bytes_per_copy",
                "wire_bytes_packed_per_copy", "avg_sent_packed_gb",
                "adapter_rank", "adapter_grams"):
        assert tres.extras[key] == jres.extras[key], key
    assert len(tplanes) == len(jplanes) == 2
    before = np.stack([_np(_carry(s).student.buf) for s in jstates])
    if widths:
        jax.effects_barrier()
        assert len(tviews) == len(jviews) == 2
        meta = _carry(jstates[0]).student.meta
        names = TA.adapter_layout(as_tree(_carry(jstates[0]).student),
                                  8).names
        w_neigh = tround.gossip_matrix(
            1.0 - np.eye(N_NODES), [len(d["label"]) for d in node_data])[1]
    carried = 0.0
    for rnd, (t, j) in enumerate(zip(tplanes, jplanes)):
        step = float(np.abs(j - before).max())
        assert step > 1e-3                       # the round moved the plane
        atol = RUN_ATOL + (REGMEAN_RTOL * step if grams else 0.0)
        if widths:
            flips = _count_flips(tviews[rnd], jviews[rnd])
            assert flips <= MAX_ADAPTER_FLIPS, f"{flips} factor code flips"
            carried = carried + _merge_allowance(
                tviews[rnd], jviews[rnd], w_neigh, meta, names, grams, t)
            gap = np.abs(t - j)
            assert np.all(gap <= atol + carried), \
                float((gap - atol - carried).max())
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=atol)
        before = j
    assert tres.f1_per_round == jres.f1_per_round
    assert tres.acc_per_round == jres.acc_per_round
    factors = tres.extras["adapter_factors"]
    assert sorted(factors) == sorted(TA.adapter_layout(
        as_tree(_carry(jstates[0]).student), 8).mat_names)
    for f in factors.values():
        assert torch.isfinite(f["A"]).all() and torch.isfinite(f["B"]).all()
        assert float((f["B"] @ f["A"]).abs().max()) > 0
