"""Two-layer CNN (the paper's MNIST teacher/student).

Parameters keep the JAX package's layouts — conv kernels HWIO, dense
kernels ``[in, out]`` — so the flat parameter plane and the wire bytes
are identical to ``repro``'s.  The forward permutes each conv kernel to
PyTorch's OIHW as a view and runs the activations NCHW; before ``fc1``
it permutes back to NHWC, because ``repro`` flattens NHWC and ``fc1``'s
rows are in HWC order.  Compute runs in ``cfg.dtype`` (bf16 by default)
on fp32 parameters cast per op; ``f1`` and the logits come back fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def compute_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _conv(gen, h, w, cin, cout, dtype):
    return {"kernel": L.he_init(gen, (h, w, cin, cout), h * w * cin, dtype),
            "bias": torch.zeros((cout,), dtype=dtype)}


def _apply_conv(p, x: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv at stride 1 (a symmetric pad of 1) on NCHW ``x``;
    the bias adds after the conv's own rounding, as in ``repro``."""
    k = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)        # HWIO -> OIHW
    y = F.conv2d(x, k, padding=1)
    return y + p["bias"].to(x.dtype)[None, :, None, None]


def init_cnn(cfg: ModelConfig, gen: torch.Generator):
    dt = compute_dtype(cfg.param_dtype)
    h, w, cin = cfg.input_hw
    c1, c2 = cfg.cnn_channels
    flat = (h // 4) * (w // 4) * c2
    return {
        "conv1": _conv(gen, 3, 3, cin, c1, dt),
        "conv2": _conv(gen, 3, 3, c1, c2, dt),
        "fc1": L.init_dense(gen, flat, cfg.proto_dim, bias=True, dtype=dt),
        "fc2": L.init_dense(gen, cfg.proto_dim, cfg.num_classes, bias=True,
                            dtype=dt),
    }


def cnn_forward(cfg: ModelConfig, params, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image: [B,H,W,C] -> (logits [B,K], f1 [B, proto_dim])."""
    x = image.to(compute_dtype(cfg.dtype)).permute(0, 3, 1, 2)   # NCHW
    x = F.max_pool2d(F.relu(_apply_conv(params["conv1"], x)), 2, 2)
    x = F.max_pool2d(F.relu(_apply_conv(params["conv2"], x)), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)            # NHWC flat
    f1 = F.relu(L.dense(params["fc1"], x))
    logits = L.dense(params["fc2"], f1).float()
    return logits, f1.float()
