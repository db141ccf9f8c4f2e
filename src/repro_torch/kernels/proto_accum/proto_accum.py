"""Hopper kernel: Eq. 3 per-class feature sums and counts.

Replaces ``repro/kernels/proto_accum/proto_accum.py:proto_accum_pallas``
(the CUDA source is ``csrc/proto_accum.cu``).  Bound on the H100: at
the main path's shapes (N=20, B=32, P=128, C=10) launch latency, not
bytes.  Design: no ``[B, C]`` one-hot and no atomics — one block per
(node, 64-column chunk); each thread walks the batch in order and adds
its column of each row into a ``[C, 64]`` shared-memory tile, so sums
are deterministic.  Its plain version is
:func:`~repro_torch.kernels.proto_accum.ref.proto_accum_ref` (sums
agree to summation order, counts exactly).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.proto_accum.ref import proto_accum_ref  # noqa: F401  the plain version

PROTO_ACCUM_LAUNCHES = LaunchCounter("proto_accum")

# the [C, 64] fp32 tile must fit the 48 KB of static shared memory
MAX_CLASSES = 48 * 1024 // (64 * 4)


def proto_accum_cuda(f1, labels, n_classes: int):
    """f1 ``[N, B, P]`` fp32 and labels ``[N, B]`` int32 on the card ->
    (sums ``[N, C, P]``, counts ``[N, C]``) fp32."""
    if f1.dim() != 3:
        raise ValueError(f"proto_accum: f1 must be [N, B, P], got "
                         f"{tuple(f1.shape)}")
    n, b, p_dim = f1.shape
    require(f1, "proto_accum f1", torch.float32)
    require(labels, "proto_accum labels", torch.int32, (n, b))
    if not 0 < n_classes <= MAX_CLASSES:
        raise ValueError(f"proto_accum: n_classes must be in "
                         f"[1, {MAX_CLASSES}], got {n_classes}")
    sums = torch.empty((n, n_classes, p_dim), dtype=torch.float32,
                       device=f1.device)
    counts = torch.empty((n, n_classes), dtype=torch.float32,
                         device=f1.device)
    rc = library().proto_accum(f1.data_ptr(), labels.data_ptr(),
                               sums.data_ptr(), counts.data_ptr(), n, b,
                               p_dim, n_classes, stream_of(f1))
    check(rc, "proto_accum")
    PROTO_ACCUM_LAUNCHES.count += 1
    return sums, counts
