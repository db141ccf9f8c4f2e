"""Hopper kernel: Eq. 5 pairwise squared prototype distances.

Replaces ``repro/kernels/proto_dist/proto_dist.py:proto_dist_pallas``
(the CUDA source is ``csrc/proto_dist.cu``):
``d2[n, c] = max(||x_n||^2 - 2 x_n·p_c + ||p_c||^2, 0)``, ``[N, P] x
[C, P] -> [N, C]`` fp32, inputs fp32 or bf16.  Bound on the H100: at
Eq. 5's shapes (640 features, 10–100 classes, P = 128–256) under 1 MB
and a few MFLOP, so launch latency.  Design: one block per 32×32 output
tile, x and p rows staged through shared memory in 32-wide chunks of P,
the cross term and both norms accumulated in fp32 registers by the
kernel's own loop (no cuBLAS, no TF32); ragged N and C are masked in the
kernel, so nothing is padded or copied.  Its plain version is
:func:`~repro_torch.kernels.proto_dist.ref.proto_dist_expand` (the same
expansion; the two sum in different orders, so they agree to a stated
tolerance, not bit for bit).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.proto_dist.ref import proto_dist_expand  # noqa: F401  the plain version

PROTO_DIST_LAUNCHES = LaunchCounter("proto_dist")

# the input types the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


def proto_dist_cuda(x, protos):
    """x ``[N, P]`` and protos ``[C, P]`` on the card, both fp32 or both
    bf16 -> d2 ``[N, C]`` fp32."""
    if x.dim() != 2 or protos.dim() != 2 or x.shape[1] != protos.shape[1]:
        raise ValueError(f"proto_dist: x must be [N, P] and protos [C, P], "
                         f"got {tuple(x.shape)} and {tuple(protos.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"proto_dist: expected float32 or bfloat16, got "
                         f"{x.dtype}")
    n, p_dim = x.shape
    c = protos.shape[0]
    require(x, "proto_dist x", x.dtype)
    require(protos, "proto_dist protos", x.dtype)
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rc = library().proto_dist(x.data_ptr(), protos.data_ptr(),
                              out.data_ptr(), n, c, p_dim,
                              int(x.dtype == torch.bfloat16), stream_of(x))
    check(rc, "proto_dist")
    PROTO_DIST_LAUNCHES.count += 1
    return out
