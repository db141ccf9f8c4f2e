"""The shared helpers of the port's module tests
(tests/test_torch_modules.py, test_torch_resnet.py,
test_torch_optimizers.py, test_torch_profe_step.py).

The port's modules held against the JAX package on the CPU: the same
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
import torch

from repro.config import base as jbase
from repro.core import profe as jprofe
from repro.core import federation as jfed_mod
from repro.core import wire_state as jwire_state
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import profe as tprofe
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_map

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


# -- models ------------------------------------------------------------------

def _carried_params(jcfg, seed):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tmodel.params_from_numpy(_np_tree(jp))


def _images(seed, n, hw=(28, 28, 1)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) + hw).astype(np.float32), \
        rng.integers(0, 10, n).astype(np.int32)


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


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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


# ProFe step on a small ResNet pair, fp32: atol of (parameters, moments)
# beside rtol=1e-4 on the moments, per optimizer.  The gradients agree to
# rtol 1e-4 / atol 1e-7 (summation order).  sgd: the momentum is the
# gradient, and the step of lr=1e-3 moves a parameter by at most one ulp
# of |p| < 0.5 (largest gaps seen 3.0e-8 and 6.2e-8).  adafactor
# normalizes each update to about ±1, so a gradient's relative gap of
# 1e-4 moves the parameter by about lr·1e-4 (largest seen 1.2e-7); its
# moments are squares of the gradient (largest gap beyond rtol 4.7e-11).
RESNET_STEP_ATOL = {"sgd": (6e-8, 1e-7), "adafactor": (2e-7, 1e-9)}


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
