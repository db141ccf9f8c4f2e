"""CIFAR-style ResNets (ResNet-8 / ResNet-18 / ResNet-32 — the paper's
CIFAR10/100 teachers and students).

``resnet_blocks`` gives the basic-block count per stage; widths start at
``resnet_width`` and double per stage.  ``f_1(x)`` is the projected
global-average-pooled feature.  Parameters keep the JAX package's
layouts (conv kernels HWIO, ``"stages"`` a list of lists of block
dicts), so the plane and the wire bytes are identical to ``repro``'s.
The forward permutes each conv kernel to OIHW as a view and runs the
activations NCHW in ``cfg.dtype`` on fp32 parameters cast per op.

Two details follow ``repro`` (XLA) rather than PyTorch's habits:

* ``padding="SAME"``: XLA pads ``max((ceil(in/s) - 1)·s + k - in, 0)``
  in total, the smaller half low.  A 3x3 stride-2 conv on an even input
  pads (0, 1), not the (1, 1) of ``padding=1``.
* GroupNorm statistics and affine in fp32 (``F.group_norm`` without
  weights on the fp32-cast activation, then ``y·scale + bias``), cast
  back to the compute dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.cnn import compute_dtype


def _conv(gen, k, cin, cout, dtype):
    return {"kernel": L.he_init(gen, (k, k, cin, cout), k * k * cin, dtype)}


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: ``(low, high)``."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _apply_conv(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    k = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)        # HWIO -> OIHW
    (h0, h1), (w0, w1) = (same_pads(x.shape[2], k.shape[2], stride),
                          same_pads(x.shape[3], k.shape[3], stride))
    if h0 == h1 and w0 == w1:                # symmetric: the conv pads
        return F.conv2d(x, k, stride=stride, padding=(h0, w0))
    return F.conv2d(F.pad(x, (w0, w1, h0, h1)), k, stride=stride)


def _init_gn(c, dtype):
    return {"scale": torch.ones((c,), dtype=dtype),
            "bias": torch.zeros((c,), dtype=dtype)}


def gn_groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def _groupnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over contiguous channel groups of NCHW ``x``."""
    c = x.shape[1]
    y = F.group_norm(x.float(), gn_groups(c), eps=eps)
    y = y * p["scale"].float()[:, None, None] + p["bias"].float()[:, None,
                                                                  None]
    return y.to(x.dtype)


def _init_basic_block(gen, cin, cout, dtype):
    p = {"conv1": _conv(gen, 3, cin, cout, dtype), "gn1": _init_gn(cout, dtype),
         "conv2": _conv(gen, 3, cout, cout, dtype), "gn2": _init_gn(cout, dtype)}
    if cin != cout:
        p["proj"] = _conv(gen, 1, cin, cout, dtype)
    return p


def _basic_block(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(_groupnorm(p["gn1"], _apply_conv(p["conv1"], x, stride)))
    h = _groupnorm(p["gn2"], _apply_conv(p["conv2"], h))
    sc = x
    if "proj" in p:
        sc = _apply_conv(p["proj"], x, stride)
    elif stride != 1:
        sc = x[:, :, ::stride, ::stride]
    return F.relu(h + sc)


def init_resnet(cfg: ModelConfig, gen: torch.Generator):
    dt = compute_dtype(cfg.param_dtype)
    _, _, cin = cfg.input_hw
    width = cfg.resnet_width
    params = {"stem": _conv(gen, 3, cin, width, dt),
              "gn0": _init_gn(width, dt), "stages": []}
    c = width
    for si, n in enumerate(cfg.resnet_blocks):
        cout = width * (2 ** si)
        stage = []
        for _ in range(n):
            stage.append(_init_basic_block(gen, c, cout, dt))
            c = cout
        params["stages"].append(stage)
    params["proto_proj"] = L.init_dense(gen, c, cfg.proto_dim, bias=True,
                                        dtype=dt)
    params["fc"] = L.init_dense(gen, cfg.proto_dim, cfg.num_classes,
                                bias=True, dtype=dt)
    return params


def resnet_forward(cfg: ModelConfig, params, image: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image: [B,H,W,C] -> (logits [B,K], f1 [B, proto_dim])."""
    x = image.to(compute_dtype(cfg.dtype)).permute(0, 3, 1, 2)   # NCHW
    x = F.relu(_groupnorm(params["gn0"], _apply_conv(params["stem"], x)))
    for si, stage in enumerate(params["stages"]):
        for bi, block in enumerate(stage):
            x = _basic_block(block, x, 2 if (si > 0 and bi == 0) else 1)
    pooled = x.mean(dim=(2, 3))
    f1 = F.relu(L.dense(params["proto_proj"], pooled))
    logits = L.dense(params["fc"], f1).float()
    return logits, f1.float()
