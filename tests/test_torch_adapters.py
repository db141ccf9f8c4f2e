"""The port's adapter-rank wire against the JAX package on the CPU: the
layout, Ω, the factorization and its grams, ``regmean_adjust``, the
plain ``lowrank_apply`` and its wrapper, and whole runs of the adapter
wire.

The helpers and the tolerances, with their reasons, are in
``tests/torch_adapters_helpers.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adapters as JA
from repro.core import aggregation as jagg
from repro.core import federation as JF
from repro.kernels.lowrank_apply import ops as jlow_ops
from repro.kernels.lowrank_apply.lowrank_apply import lowrank_apply_pallas
from repro.kernels.lowrank_apply.ref import lowrank_apply_ref as jlow_ref
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import adapters as TA
from repro_torch.core import aggregation as tagg
from repro_torch.core import federation as TF
from repro_torch.core import round_ops as tround
from repro_torch.kernels import build
from repro_torch.kernels.lowrank_apply import ops as tlow_ops
from repro_torch.kernels.lowrank_apply.lowrank_apply import \
    lowrank_apply_cuda
from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref
from repro_torch.models import init_params
from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
from repro_torch.tree import keystr, tree_from_paths, tree_leaves, tree_paths

from torch_adapters_helpers import (MAX_ADAPTER_FLIPS, N_NODES, REGMEAN_RTOL,
                                    RUN_ATOL, _apply_inputs, _carry, _close,
                                    _count_flips, _merge_allowance, _normal,
                                    _np, _record_views, _recording, _rng,
                                    _setup, _student_shapes, _t, _ulps)

torch.set_num_threads(2)


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
