"""The port's modules held against the JAX package on the CPU: the same
numpy inputs (and carried weights) through ``repro`` and ``repro_torch``.

Tolerances: data, topology, configs, metrics, plane layout, wire codes,
scales, reconstructions and byte counts are exact.  Forward outputs
agree to ``rtol=1e-5`` under an fp32 ``dtype`` override; in bf16 the two
frameworks round convolutions and matmuls at different places, so
logits agree to ``atol=0.1`` there (bf16 keeps 8 bits).  One ProFe step
(fp32): losses and gradients to ``rtol=1e-4`` (summation order), and the
post-Adam parameters to ``atol=2e-6``.  Adam's first step is about
``lr * g / (|g| + eps)``: where ``|g|`` is near ``eps=1e-8`` a tiny
gradient difference moves it by a large fraction of ``lr=1e-3``, so
``2e-6`` holds only because the gradients agree far better than
``eps`` (it is not a bound on the sign flips themselves).
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
from repro.core import profe as jprofe
from repro.core import federation as jfed_mod
from repro.core import quantization as jquant
from repro.core import round_ops as jround_ops
from repro.core import wire_state as jwire_state
from repro.core import topology as jtopo
from repro.data import loader as jloader
from repro.data.partition import partition as jpartition
from repro.data import synthetic as jsyn
from repro.kernels.quantize import ops as jqops
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
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
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim import plane as tplane
from repro_torch.optim.optimizers import \
    clip_by_global_norm as tclip_by_global_norm
from repro_torch.tree import ShapeDtypeStruct, tree_leaves, tree_map

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small_cfg(dtype="float32"):
    return jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype=dtype)


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _small_resnet(dtype="float32", hw=(8, 8, 3)):
    """A two-stage ResNet (blocks (2, 2), width 4; its student (1, 1)):
    every block kind — stride-2 projection, identity — at test size."""
    return jbase.get_config("cifar10-resnet18").replace(
        name="small-resnet", resnet_blocks=(2, 2), resnet_width=4,
        proto_dim=16, input_hw=hw, dtype=dtype)


# -- pure modules: byte-identical -------------------------------------------

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


# -- models ------------------------------------------------------------------

def _carried_params(jcfg, seed):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tmodel.params_from_numpy(_np_tree(jp))


def _images(seed, n, hw=(28, 28, 1)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + hw).astype(np.float32), \
        rng.integers(0, 10, n).astype(np.int32)


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


_JAX_PARAMS = {}


def _carried_resnet(name, student):
    """JAX parameters of a CIFAR config (or its student) at full width,
    initialized once per module, and the port's carried copy."""
    key = (name, student)
    if key not in _JAX_PARAMS:
        jcfg = jbase.get_config(name)
        if student:
            jcfg = jmodel.derive_student(jcfg)
        _JAX_PARAMS[key] = _carried_params(jcfg, 0)
    return _JAX_PARAMS[key]


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-5, 1e-5),
                                             ("bfloat16", 0.0, 0.1)])
@pytest.mark.parametrize("name,student", [
    ("cifar10-resnet18", False), ("cifar10-resnet18", True),
    ("cifar100-resnet32", False), ("cifar100-resnet32", True)],
    ids=["resnet18", "resnet8", "resnet32", "resnet18-student"])
def test_resnet_forward_matches_with_carried_weights(name, student, dtype,
                                                     rtol, atol):
    """The paper's CIFAR teachers and students at full width, batch 2."""
    jp, tp = _carried_resnet(name, student)
    jcfg = jbase.get_config(name).replace(dtype=dtype)
    if student:
        jcfg = jmodel.derive_student(jcfg)
    img = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    jo = jmodel.forward(jcfg, jp, {"image": img}, remat=False)
    to = tmodel.forward(_tcfg(jcfg), tp, {"image": torch.from_numpy(img)})
    assert to.logits.dtype == to.f1.dtype == torch.float32
    assert tuple(to.f1.shape) == (2, 256)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(to.f1.numpy(), np.asarray(jo.f1), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("side", [7, 9])
def test_resnet_forward_matches_on_odd_sides(side):
    """Odd input sides: SAME pads of the stride-2 convs become (1, 1),
    stride-1 convs (1, 1), and a 1x1 stride-2 projection (0, 0)."""
    from repro_torch.models.resnet import same_pads
    assert same_pads(8, 3, 2) == (0, 1) and same_pads(7, 3, 2) == (1, 1)
    assert same_pads(8, 1, 2) == (0, 0) == same_pads(7, 1, 2)
    jcfg = _small_resnet(hw=(side, side, 3))
    jp, tp = _carried_params(jcfg, 2)
    img = np.random.default_rng(side).standard_normal(
        (3, side, side, 3)).astype(np.float32)
    jo = jmodel.forward(jcfg, jp, {"image": img}, remat=False)
    to = tmodel.forward(_tcfg(jcfg), tp, {"image": torch.from_numpy(img)})
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to.f1.numpy(), np.asarray(jo.f1), rtol=1e-5,
                               atol=1e-5)


def test_resnet_identity_stride_shortcut_matches():
    """The stride-2 identity shortcut ``x[:, ::2, ::2]`` (a block without
    ``proj``), which the paper's configs never reach."""
    from repro.models import resnet as jres
    from repro_torch.models import resnet as tres
    rng = np.random.default_rng(1)
    p = {k: {"kernel": (rng.standard_normal((3, 3, 4, 4)) * 0.3).astype(
        np.float32)} for k in ("conv1", "conv2")}
    p.update({k: {"scale": np.ones(4, np.float32),
                  "bias": np.full(4, 0.1, np.float32)} for k in ("gn1",
                                                               "gn2")})
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    want = jres._basic_block(p, jnp.asarray(x), 2)
    got = tres._basic_block(tmodel.params_from_numpy(p),
                            torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


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


# -- sgd and adafactor, per leaf and on the plane ----------------------------

def _random_like(tree, rng, sc, n=None):
    """numpy arrays shaped like ``tree``'s leaves (with a leading ``n``)."""
    lead = () if n is None else (n,)
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(lead + tuple(np.shape(x))) * sc
                   ).astype(np.float32), tree)


def _stack_opt(states):
    """Per-node optimizer states stacked as the engine stacks them."""
    return {k: states[0][k] if k == "step" else
            tree_map(lambda *xs: torch.stack(xs), *(s[k] for s in states))
            for k in states[0]}


@pytest.mark.parametrize("name", ["sgd", "adafactor"])
def test_per_leaf_optimizer_matches_jax_vmapped(name):
    """The port's per-leaf sgd / adafactor over a node-stacked ResNet tree
    (``lead=1``) against ``repro``'s vmapped per-leaf optimizer, 3 steps
    from random gradients.  sgd is bit-exact.  adafactor's moments agree
    to ``rtol=1e-5`` and its parameters to ``rtol=1e-5, atol=1e-8``: the
    frameworks' ``rsqrt``, means and ``pow`` (the decay ``beta``) round
    differently, which moves a parameter by a few of its ulps (at most 4
    seen) and a near-zero parameter by a few ulps of ``lr·|upd|``."""
    n = 3
    rng = np.random.default_rng(11)
    tree = _np_tree(jmodel.init_params(_small_resnet(),
                                       jax.random.PRNGKey(0)))
    params = _random_like(tree, rng, 0.1, n)
    jopt = jmake_optimizer(name, 1e-2, weight_decay=0.01, momentum=0.9)
    topt = make_optimizer(name, 1e-2, weight_decay=0.01, momentum=0.9)
    jst, jp = jax.vmap(jopt.init)(params), params
    tp = tmodel.params_from_numpy(params)
    tst = _stack_opt([topt.init(tree_map(lambda x: x[i], tp))
                      for i in range(n)])
    tol = {} if name == "sgd" else dict(rtol=1e-5, atol=1e-8)
    for _ in range(3):
        grads = _random_like(tree, rng, 1e-2, n)
        jp, jst = jax.vmap(jopt.update)(grads, jst, jp)
        topt.update(tmodel.params_from_numpy(grads), tst, tp, lead=1)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            if name == "sgd":
                assert a.numpy().tobytes() == np.asarray(b).tobytes()
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
        tm = tree_leaves({k: v for k, v in tst.items() if k != "step"})
        jm = jax.tree_util.tree_leaves(
            {k: v for k, v in jst.items() if k != "step"})
        assert len(tm) == len(jm) >= len(tree_leaves(tree))
        for a, b in zip(tm, jm):
            assert tuple(a.shape) == np.shape(b)
            if name == "sgd":
                assert a.numpy().tobytes() == np.asarray(b).tobytes()
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=0)
        assert int(tst["step"]) == int(jst["step"][0])


@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_plane_optimizer_bit_identical_to_per_leaf(name):
    """The fused plane optimizer (per-node clip + one sweep) against the
    port's per-leaf optimizer after ``clip_by_global_norm``, over 5
    carried steps on node-stacked ResNet parameters (lists in the tree),
    bit for bit — ``repro``'s ``tests/test_plane.py`` claim, for all N
    nodes at once.  The clip binds on some steps, not on others."""
    n, clip = 3, 0.5
    rng = np.random.default_rng(3)
    tree = _np_tree(jmodel.init_params(_small_resnet(),
                                       jax.random.PRNGKey(1)))
    tp = tmodel.params_from_numpy(_random_like(tree, rng, 0.1, n))
    leaf_opt = make_optimizer(name, 1e-2, weight_decay=0.01, momentum=0.9)
    plane_opt = make_plane_optimizer(name, 1e-2, weight_decay=0.01,
                                     momentum=0.9, grad_clip=clip)
    planes = [tplane.plane_from_tree(tree_map(lambda x: x[i], tp))
              for i in range(n)]
    meta = planes[0].meta
    pl = tplane.Plane(torch.stack([p.buf for p in planes]), meta)
    pst = _stack_opt([plane_opt.init(p) for p in planes])
    lst = _stack_opt([leaf_opt.init(tree_map(lambda x: x[i], tp))
                      for i in range(n)])
    clipped = []
    size = sum(np.size(x) for x in jax.tree_util.tree_leaves(tree))
    for i in range(5):           # norms about 0.3, 0.6, ... 1.5
        g = tmodel.params_from_numpy(_random_like(
            tree, rng, 0.3 * (i + 1) / np.sqrt(size), n))
        gc, gn = tclip_by_global_norm(g, clip, lead=1)
        clipped.append(bool((gn > clip).any()))
        leaf_opt.update(gc, lst, tp, lead=1)
        gp = torch.stack([tplane.plane_from_tree(tree_map(
            lambda x: x[k], g)).buf for k in range(n)])
        plane_opt.update(tplane.Plane(gp, meta), pst, pl)
        assert torch.equal(pst["gnorm"], gn)
        for a, b in zip(tree_leaves(tplane.as_tree(pl)), tree_leaves(tp)):
            assert torch.equal(a, b), f"step {i}"
        if name == "adafactor":
            for a, b in zip(tree_leaves(pst["fac"]), tree_leaves(lst["v"])):
                assert torch.equal(a, b)
        else:
            for path, shape, row, r_leaf in (r[1:] for r in meta.recipe):
                assert torch.equal(tplane._leaf_view(pst["mu"], shape, row,
                                                     r_leaf),
                                   _at(lst["mu"], path))
    assert any(clipped) and not all(clipped)
    assert int(pst["step"]) == int(lst["step"]) == 5


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", ["sgd", "adafactor"])
def test_node_states_carry_and_stack_like_jax(name):
    """JAX node states under sgd / adafactor (plane student, per-leaf
    ResNet teacher with lists) carried over and stacked: every optimizer
    tensor equals ``repro``'s ``_stack_states`` bit for bit, the step
    counters too (one int32 counter a node, as ``repro`` stacks them)."""
    jcfg = _small_resnet()
    scfg = jmodel.derive_student(jcfg)
    j_opt_s = jplane.make_plane_optimizer(name, 1e-3, grad_clip=1.0)
    j_opt_t = jmake_optimizer(name, 1e-3)
    rng = np.random.default_rng(2)
    jstates = [_jax_state(jcfg, scfg, j_opt_s, j_opt_t, i, rng)
               for i in range(3)]
    jstates[1] = jstates[1]._replace(opt_s=jax.tree_util.tree_map(
        lambda x: x + 1 if x.dtype == jnp.float32 else x, jstates[1].opt_s))
    jst = jfed_mod._stack_states(jstates)
    tst = tprofe.stack_states([carry_state(s) for s in jstates])
    assert set(tst.opt_s) == set(jst.opt_s) and \
        set(tst.opt_t) == set(jst.opt_t)
    for key in ("opt_s", "opt_t"):
        t_tree = {k: v for k, v in getattr(tst, key).items() if k != "step"}
        j_tree = {k: v for k, v in getattr(jst, key).items() if k != "step"}
        tl, jl = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
        assert len(tl) == len(jl) > 0
        for a, b in zip(tl, jl):
            assert a.dtype == torch.float32
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        assert getattr(tst, key)["step"].shape == (3,)
        assert getattr(tst, key)["step"].dtype == torch.int32
        assert getattr(tst, key)["step"].numpy().tobytes() == \
            np.asarray(getattr(jst, key)["step"]).tobytes()
    assert isinstance(tst.teacher["stages"], list)


# -- one ProFe step ----------------------------------------------------------

def _jax_state(jcfg, scfg, opt_s, opt_t, seed, rng):
    st = jprofe.init_node_state(jcfg, scfg, jax.random.PRNGKey(seed), opt_s,
                                opt_t, 10, plane=True)
    protos = rng.standard_normal((10, scfg.proto_dim)).astype(np.float32)
    mask = (rng.random(10) < 0.7).astype(np.float32)
    return st._replace(global_protos=jnp.asarray(protos),
                       proto_mask=jnp.asarray(mask))


def carry_state(st):
    """A JAX plane-backed NodeState -> the port's, through numpy."""
    return tprofe.node_state_from_numpy(
        _np_tree(jplane.as_tree(st.student)), _np_tree(st.teacher),
        _np_tree(st.opt_s), _np_tree(st.opt_t),
        np.asarray(st.global_protos), np.asarray(st.proto_mask),
        int(st.round_idx), device="cpu")


@pytest.mark.parametrize("teacher_on", [True, False])
def test_profe_step_matches(teacher_on):
    jcfg = _small_cfg()
    scfg = jmodel.derive_student(jcfg)
    fed = jbase.FederationConfig(num_nodes=2)
    lr, n = 1e-3, 2
    j_opt_s = jplane.make_plane_optimizer("adamw", lr, grad_clip=1.0)
    j_opt_t = jmake_optimizer("adamw", lr)
    jstep = jprofe.make_profe_step(jcfg, scfg, fed, j_opt_s, j_opt_t,
                                   grad_clip=1.0, remat=False, jit=True)
    rng = np.random.default_rng(7)
    jstates = [_jax_state(jcfg, scfg, j_opt_s, j_opt_t, 10 + i, rng)
               for i in range(n)]
    tstate = tprofe.stack_states([carry_state(s) for s in jstates])
    batches = [dict(zip(("image", "label"), _images(20 + i, 8)))
               for i in range(n)]

    t_opt_s = make_plane_optimizer("adamw", lr, grad_clip=1.0)
    t_opt_t = make_optimizer("adamw", lr)
    tfed = tbase.FederationConfig(num_nodes=2)
    tcfg, tscfg = _tcfg(jcfg), _tcfg(scfg)

    # gradients of Eq. 8 / Eq. 9 for node 0 at the carried state
    b0 = batches[0]
    tb0 = {k: torch.from_numpy(v) for k, v in b0.items()}
    s_tree = tmodel.params_from_numpy(_np_tree(jplane.as_tree(
        jstates[0].student)))
    for leaf in tree_leaves(s_tree):
        leaf.requires_grad_(True)
    tl, _ = tprofe.student_loss(tscfg, s_tree, tb0, tstate.global_protos[0],
                                tstate.proto_mask[0], torch.tensor(0.7),
                                1.0, 3.0)
    tg = torch.autograd.grad(tl, tree_leaves(s_tree))
    jl, jg = jax.value_and_grad(lambda sp: jprofe.student_loss(
        scfg, sp, b0, jstates[0].global_protos, jstates[0].proto_mask, 0.7,
        1.0, 3.0, remat=False)[0])(jplane.as_tree(jstates[0].student))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(tg, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)

    tstep = tprofe.make_profe_step(tcfg, tscfg, tfed, t_opt_s, t_opt_t,
                                   grad_clip=1.0)
    stacked_batch = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
                     for k in batches[0]}
    tstate, tm = tstep(tstate, stacked_batch, teacher_on)
    for i in range(n):
        jnew, jm = jstep(jstates[i], batches[i], teacher_on)
        np.testing.assert_allclose(float(tm["loss_s"][i]),
                                   float(jm["loss_s"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm_s"][i]),
                                   float(jm["grad_norm_s"]), rtol=1e-5)
        if teacher_on:
            np.testing.assert_allclose(float(tm["loss_t"][i]),
                                       float(jm["loss_t"]), rtol=1e-5)
        np.testing.assert_allclose(tstate.student.buf[i].detach().numpy(),
                                   np.asarray(jnew.student.buf), rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(tstate.opt_s["mu"][i].numpy(),
                                   np.asarray(jnew.opt_s["mu"]), rtol=1e-4,
                                   atol=1e-9)
        for a, b in zip(tree_leaves(tstate.teacher),
                        jax.tree_util.tree_leaves(jnew.teacher)):
            np.testing.assert_allclose(a[i].detach().numpy(), np.asarray(b),
                                       rtol=0, atol=2e-6)
    assert tstate.opt_s["step"].tolist() == [1] * n
    assert tstate.opt_t["step"].tolist() == [1 if teacher_on else 0] * n


# ProFe step on a small ResNet pair, fp32: atol of (parameters, moments)
# beside rtol=1e-4 on the moments, per optimizer.  The gradients agree to
# rtol 1e-4 / atol 1e-7 (summation order).  sgd: the momentum is the
# gradient, and the step of lr=1e-3 moves a parameter by at most one ulp
# of |p| < 0.5 (largest gaps seen 3.0e-8 and 6.2e-8).  adafactor
# normalizes each update to about ±1, so a gradient's relative gap of
# 1e-4 moves the parameter by about lr·1e-4 (largest seen 1.2e-7); its
# moments are squares of the gradient (largest gap beyond rtol 4.7e-11).
RESNET_STEP_ATOL = {"sgd": (6e-8, 1e-7), "adafactor": (2e-7, 1e-9)}


@pytest.mark.parametrize("teacher_on", [True, False])
@pytest.mark.parametrize("name", ["sgd", "adafactor"])
def test_profe_step_matches_resnet(name, teacher_on):
    """One ProFe step on a small ResNet pair (teacher blocks (2, 2),
    student (1, 1)) under the sgd / adafactor plane and per-leaf
    optimizers, against ``repro``'s jitted step from carried states:
    losses and grad norms to ``rtol=1e-5``, parameters and moments to
    ``RESNET_STEP_ATOL``, counters exactly."""
    jcfg = _small_resnet()
    scfg = jmodel.derive_student(jcfg)
    fed = jbase.FederationConfig(num_nodes=2)
    lr, n = 1e-3, 2
    j_opt_s = jplane.make_plane_optimizer(name, lr, grad_clip=1.0)
    j_opt_t = jmake_optimizer(name, lr)
    jstep = jprofe.make_profe_step(jcfg, scfg, fed, j_opt_s, j_opt_t,
                                   grad_clip=1.0, remat=False, jit=True)
    rng = np.random.default_rng(17)
    jstates = [_jax_state(jcfg, scfg, j_opt_s, j_opt_t, 30 + i, rng)
               for i in range(n)]
    tstate = tprofe.stack_states([carry_state(s) for s in jstates])
    batches = [dict(zip(("image", "label"), _images(40 + i, 8, (8, 8, 3))))
               for i in range(n)]
    tstep = tprofe.make_profe_step(
        _tcfg(jcfg), _tcfg(scfg), tbase.FederationConfig(num_nodes=2),
        make_plane_optimizer(name, lr, grad_clip=1.0),
        make_optimizer(name, lr), grad_clip=1.0)
    stacked_batch = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
                     for k in batches[0]}
    tstate, tm = tstep(tstate, stacked_batch, teacher_on)
    p_atol, m_atol = RESNET_STEP_ATOL[name]
    for i in range(n):
        jnew, jm = jstep(jstates[i], batches[i], teacher_on)
        for key in ("loss_s", "grad_norm_s") + (("loss_t",) if teacher_on
                                                 else ()):
            np.testing.assert_allclose(float(tm[key][i]), float(jm[key]),
                                       rtol=1e-5)
        np.testing.assert_allclose(tstate.student.buf[i].detach().numpy(),
                                   np.asarray(jnew.student.buf), rtol=0,
                                   atol=p_atol)
        for a, b in zip(tree_leaves(tstate.teacher),
                        jax.tree_util.tree_leaves(jnew.teacher)):
            np.testing.assert_allclose(a[i].detach().numpy(), np.asarray(b),
                                       rtol=0, atol=p_atol)
        for key in ("opt_s", "opt_t"):
            tl = tree_leaves({k: v for k, v in getattr(tstate, key).items()
                              if k not in ("step", "gnorm")})
            jl = jax.tree_util.tree_leaves(
                {k: v for k, v in getattr(jnew, key).items()
                 if k not in ("step", "gnorm")})
            assert len(tl) == len(jl) > 0
            for a, b in zip(tl, jl):
                np.testing.assert_allclose(a[i].numpy(), np.asarray(b),
                                           rtol=1e-4, atol=m_atol)
    assert tstate.opt_s["step"].tolist() == [1] * n
    assert tstate.opt_t["step"].tolist() == [1 if teacher_on else 0] * n


# -- the wire: codec and byte accounting -------------------------------------

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


# -- the error-feedback codec state ------------------------------------------

def _ef_states(n=3, seq=4):
    """``n`` JAX node states stacked, and a JAX ``CodecState`` as after
    ``seq`` rounds: a random residual, zero on the plane's padding
    lanes (the codec keeps them zero)."""
    jcfg = _small_cfg()
    scfg = jmodel.derive_student(jcfg)
    j_opt_s = jplane.make_plane_optimizer("adamw", 1e-3, grad_clip=1.0)
    j_opt_t = jmake_optimizer("adamw", 1e-3)
    rng = np.random.default_rng(seq)
    jstates = [_jax_state(jcfg, scfg, j_opt_s, j_opt_t, i, rng)
               for i in range(n)]
    jst = jfed_mod._stack_states(jstates)
    zero = jwire_state.init_codec_state(
        {"protos": jnp.zeros((n, 10, scfg.proto_dim), jnp.float32),
         "student": jst.student}, n_nodes=n)
    meta = jst.student.meta
    real = np.zeros(jst.student.buf.shape[1:], dtype=bool)
    for _, shape, _dtype, row, r_leaf in meta.recipe:    # repro's recipe
        real[row:row + r_leaf].reshape(-1)[:int(np.prod(shape))] = True
    res_s = (rng.standard_normal(jst.student.buf.shape) * 1e-3 * real
             ).astype(np.float32)
    res_p = (rng.standard_normal((n, 10, scfg.proto_dim)) * 1e-5
             ).astype(np.float32)
    jws = jwire_state.CodecState(
        {"protos": jnp.asarray(res_p),
         "student": jplane.Plane(jnp.asarray(res_s), (), meta)},
        seq=jnp.full((n,), seq, jnp.int32))
    return scfg, jstates, jst, zero, jws, real


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
