"""Unified model API (the ``cnn`` and ``resnet`` families of
``repro.models.model``).

* ``init_params(cfg, gen)`` — fp32 parameters from an explicit
  ``torch.Generator``,
* ``forward(cfg, params, batch)`` -> :class:`ModelOutput`,
* ``derive_student(cfg)`` — the ProFe student config,
* ``params_from_numpy(tree)`` — carry a JAX package parameter tree
  (nested dicts of numpy arrays) over in the same layouts.  ``torch``
  cannot reproduce ``jax.random``, so every comparison with ``repro``
  starts from carried weights.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.models.resnet import init_resnet, resnet_forward
from repro_torch.tree import tree_map


class ModelOutput(NamedTuple):
    logits: torch.Tensor   # [B, K]
    f1: torch.Tensor       # [B, proto_dim] prototype representation
    aux: torch.Tensor      # scalar auxiliary loss (zero for CNN, ResNet)


def _unported(cfg: ModelConfig):
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: ROADMAP.md "
        f"Queue 1 item 14 (model zoo)")


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    if cfg.family == "cnn":
        return init_cnn(cfg, gen)
    if cfg.family == "resnet":
        return init_resnet(cfg, gen)
    raise _unported(cfg)


_FORWARDS = {"cnn": cnn_forward, "resnet": resnet_forward}


def forward(cfg: ModelConfig, params, batch) -> ModelOutput:
    if cfg.family not in _FORWARDS:
        raise _unported(cfg)
    logits, f1 = _FORWARDS[cfg.family](cfg, params, batch["image"])
    return ModelOutput(logits, f1, torch.zeros((), device=logits.device))


_STUDENT_OVERRIDES = {
    # paper pairs: ResNet18 -> ResNet8, ResNet32 -> ResNet18
    "cifar10-resnet18": dict(resnet_blocks=(1, 1, 1), resnet_width=16),
    "cifar100-resnet32": dict(resnet_blocks=(2, 2, 2, 2), resnet_width=64),
}


def derive_student(cfg: ModelConfig) -> ModelConfig:
    """The paper's smaller aggregation model, same family as the teacher."""
    if cfg.family == "cnn":
        return cfg.replace(
            name=cfg.name + "-student",
            cnn_channels=tuple(max(c // 2, 1) for c in cfg.cnn_channels))
    if cfg.family == "resnet":
        ov = _STUDENT_OVERRIDES.get(cfg.name, dict(
            resnet_blocks=tuple(max(b // 2, 1) for b in cfg.resnet_blocks)))
        return cfg.replace(name=cfg.name + "-student", **ov)
    raise _unported(cfg)


def params_from_numpy(tree, device: torch.device | str = "cpu"):
    """JAX package parameters (nested dicts and lists of numpy arrays) ->
    the port's (the same tree of tensors, same shapes and layouts)."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(device),
                    tree)

