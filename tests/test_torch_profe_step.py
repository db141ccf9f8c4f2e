"""One ProFe step of the port held against ``repro``'s jitted step on the
CPU, from carried states: the small mnist-cnn under adamw (with the
gradients of Eq. 8), and a small ResNet pair under sgd and adafactor,
teacher on and off.

The helpers and the tolerances, with their reasons, are in
``tests/torch_modules_helpers.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.core import profe as jprofe
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import profe as tprofe
from repro_torch.models import model as tmodel
from repro_torch.optim import make_optimizer, make_plane_optimizer
from repro_torch.tree import tree_leaves

from torch_modules_helpers import (RESNET_STEP_ATOL, _images, _jax_state,
                                   _np_tree, _small_cfg, _small_resnet, _tcfg,
                                   carry_state)

torch.set_num_threads(2)


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
