"""The port's ResNets held against the JAX package on the CPU: the paper's
CIFAR teachers and students at full width from carried weights (fp32
and bf16), odd input sides and the stride-2 identity shortcut.

The helpers and the tolerances, with their reasons, are in
``tests/torch_modules_helpers.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.models import model as jmodel
from repro_torch.models import model as tmodel

from torch_modules_helpers import (_carried_params, _carried_resnet,
                                   _small_resnet, _tcfg)

torch.set_num_threads(2)


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
