"""The port's optimizers held against the JAX package on the CPU: the
per-leaf sgd and adafactor against ``repro``'s vmapped ones, the fused
plane optimizer against the per-leaf one, and node states carried and
stacked like ``repro``'s.

The helpers and the tolerances, with their reasons, are in
``tests/torch_modules_helpers.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federation as jfed_mod
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.core import profe as tprofe
from repro_torch.models import model as tmodel
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.optim import plane as tplane
from repro_torch.optim.optimizers import \
    clip_by_global_norm as tclip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map

from torch_modules_helpers import (_at, _jax_state, _np_tree, _random_like,
                                   _small_resnet, _stack_opt, carry_state)

torch.set_num_threads(2)


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
