"""Hopper kernel: fused clip + adamw sweep over the flat parameter plane.

Replaces ``repro/kernels/opt_update/opt_update.py:adamw_update_pallas``
(the CUDA source is ``csrc/opt_update.cu``).  Bound on the H100: bytes —
7 x 4 B per element (read g, p, mu, nu; write p, mu, nu).  Design: one
grid-stride elementwise sweep over every node's plane at once, runtime
scalars and the per-node clip scale in device memory; explicit
round-to-nearest operations and ``-fmad=false`` make it bit-identical to
its plain version, :func:`~repro_torch.kernels.opt_update.ref.adamw_update_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.opt_update.ref import adamw_update_ref  # noqa: F401  the plain version

ADAMW_LAUNCHES = LaunchCounter("adamw_update")


def adamw_update_cuda(g, p, mu, nu, lr, scale, bc1, bc2, *, b1: float,
                      b2: float, eps: float, weight_decay: float) -> None:
    """Launch the kernel: updates ``p``, ``mu``, ``nu`` (``[..., R, C]``
    fp32, contiguous, on the card) in place.  ``lr``, ``bc1``, ``bc2``
    are one-element fp32 device tensors, ``scale`` has one entry per
    ``R x C`` plane."""
    shape = tuple(p.shape)
    for name, t in (("g", g), ("p", p), ("mu", mu), ("nu", nu)):
        require(t, f"adamw_update {name}", torch.float32, shape)
    node_elems = shape[-2] * shape[-1]
    n_nodes = p.numel() // node_elems
    require(scale, "adamw_update scale", torch.float32, (n_nodes,))
    for name, t in (("lr", lr), ("bc1", bc1), ("bc2", bc2)):
        require(t, f"adamw_update {name}", torch.float32)
        if t.numel() != 1:
            raise ValueError(f"adamw_update {name}: expected one element")
    rc = library().adamw_update(
        g.data_ptr(), p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        lr.data_ptr(), scale.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
        p.numel(), node_elems, b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
        stream_of(p))
    check(rc, "adamw_update")
    ADAMW_LAUNCHES.count += 1
