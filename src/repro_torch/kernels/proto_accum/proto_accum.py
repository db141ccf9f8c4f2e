"""Hopper kernel: Eq. 3 per-class feature sums and counts.

Replaces ``repro/kernels/proto_accum/proto_accum.py:proto_accum_pallas``
(the CUDA source is ``csrc/proto_accum.cu``).  Bound on the H100: at
the main path's shapes (N=20, B=32, P=128, C=10) latency — the launch
and the trips to device memory — not bytes.  Design: no ``[B, C]``
one-hot and no atomics — one block per (node, 32-column chunk) stages
its labels and its ``[B, 32]`` slab of f1 in shared memory with every
copy in flight at once (chunks of 128 rows, the next in flight, for a
longer batch), then each thread walks the batch in order for its
(class, column) pairs, summing in a register.  The sums are bit-identical to
:func:`~repro_torch.kernels.proto_accum.ref.proto_accum_batch_order`
(the same adds in the same order) and agree with the plain einsum
:func:`~repro_torch.kernels.proto_accum.ref.proto_accum_ref` to
summation order; counts are exact.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.proto_accum.ref import (  # noqa: F401  the plain versions
    proto_accum_batch_order, proto_accum_ref)

PROTO_ACCUM_LAUNCHES = LaunchCounter("proto_accum")

SMEM_MAX = 232_448     # shared memory a block may opt in to (sm_90)
COLS = 32              # columns of P a block owns
THREADS = 128          # a block's threads
ROWS = 128             # batch rows a staged chunk


def proto_accum_smem(batch: int, n_classes: int) -> int:
    """The kernel's dynamic shared memory: one or two staged chunks of
    ``[rows, 32]`` f1 and ``[rows]`` labels, the ``[C, 32]`` tile and
    ``[C]`` counts (``csrc/proto_accum.cu``)."""
    rows = min(batch, ROWS)
    bufs = 2 if batch > ROWS else 1
    return 4 * (bufs * rows * (COLS + 1) + n_classes * (COLS + 1))


# the most classes whose tile fits beside two full chunks
MAX_CLASSES = (SMEM_MAX - proto_accum_smem(2 * ROWS, 0)) // (4 * (COLS + 1))


def proto_accum_cuda(f1, labels, n_classes: int):
    """f1 ``[N, B, P]`` fp32 and labels ``[N, B]`` int32 on the card ->
    (sums ``[N, C, P]``, counts ``[N, C]``) fp32."""
    if f1.dim() != 3:
        raise ValueError(f"proto_accum: f1 must be [N, B, P], got "
                         f"{tuple(f1.shape)}")
    if not 0 < n_classes <= MAX_CLASSES:
        raise ValueError(f"proto_accum: n_classes must be in "
                         f"[1, {MAX_CLASSES}], got {n_classes}")
    n, b, p_dim = f1.shape
    require(f1, "proto_accum f1", torch.float32)
    require(labels, "proto_accum labels", torch.int32, (n, b))
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
