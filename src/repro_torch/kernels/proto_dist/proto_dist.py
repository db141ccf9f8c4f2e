"""Hopper kernel: Eq. 5 pairwise squared prototype distances.

Replaces ``repro/kernels/proto_dist/proto_dist.py:proto_dist_pallas``
(the CUDA source is ``csrc/proto_dist.cu``):
``d2[n, c] = max(||x_n||^2 - 2 x_n·p_c + ||p_c||^2, 0)``, ``[N, P] x
[C, P] -> [N, C]`` fp32, inputs fp32 or bf16.  Bound on the H100: at
Eq. 5's shapes (640 features, 10–100 classes, P = 128–256) under 1 MB
and a few MFLOP, so launch latency and the kernel's critical path.
Design: a warp owns 1, 2 or 4 rows of x, a block 4, 8 or 16 warps and a
tile of up to 16 prototypes sized to C; P goes in chunks of 256, the
block staging a chunk of its x rows and prototype rows in shared memory
by ``cp.async``, every 16-byte copy of a chunk issued before any is
waited for (one round trip and one barrier at the paths' P; a longer P
double-buffered).  A lane folds 8 elements of a chunk into partial dots
of its rows with all the tile's prototypes, each prototype vector read
once for all its rows, and into ``||x||^2`` and the ``||p||^2`` its warp
owns (each norm once a block); shuffles fold the partials, the 16 dots
of a row in one halving exchange; fp32 ``fmaf`` only (no cuBLAS, no
TF32).  :func:`proto_dist_plan` picks the vector width, the rows a warp,
the warps a block, the column tile and the grid; ragged N, C and P are
masked in the kernel, so nothing is padded or copied.  Its plain
version is :func:`~repro_torch.kernels.proto_dist.ref.proto_dist_expand`
(the same
expansion; the two sum in different orders, so they agree to a stated
tolerance, not bit for bit).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.proto_dist.ref import proto_dist_expand  # noqa: F401  the plain version

PROTO_DIST_LAUNCHES = LaunchCounter("proto_dist")

# the input types the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)

PD_COL_TILE = 16            # prototypes a block at most (kColTile)
PD_CHUNK = 256              # P elements staged at a time (kChunk)
PD_WARPS = (16, 8, 4)       # warps a block, largest first
PD_WARP_ROWS = (1, 2, 4)    # rows a warp (the kernel's template RW)
# blocks a launch should have: two on each of the H100's 132 SMs.  More
# rows a block stage each prototype tile fewer times, fewer fill the card.
PD_MIN_BLOCKS = 2 * 132
PD_SMEM_MAX = 48 * 1024     # dynamic shared memory a block, no opt-in
# prototype bytes a SM's warps should read from shared memory: a warp
# reads the whole tile once for its RW rows, so N·C·P elements over the
# card at one row a warp (496 KB a SM at Eq. 5's C = 100, fp32, where the
# reads, not the copies, set the time: bf16 with half the bytes is faster)
PD_SMEM_READS = 128 * 1024
SMS = 132
MAX_GRID_Y = 65535


def proto_dist_smem(rows: int, col_tile: int, p: int, dtype) -> int:
    """Dynamic shared memory of a block of ``rows`` rows, in bytes: a
    chunk of its x rows and prototype rows, two buffers when P spans more
    than one chunk."""
    size = 2 if dtype == torch.bfloat16 else 4
    return (2 if p > PD_CHUNK else 1) * (rows + col_tile) * PD_CHUNK * size


@dataclass(frozen=True)
class ProtoDistPlan:
    """One launch of ``proto_dist``: ``vec`` elements a load (a 16-byte
    vector when 4 for fp32 or 8 for bf16), ``warps`` warps a block
    (``32·warps`` threads) of ``warp_rows`` rows each, ``col_tile``
    prototypes a block, P in
    ``chunks`` chunks of ``PD_CHUNK``; ``grid`` ``(row tiles, column
    tiles)``; ``smem`` bytes of dynamic shared memory a block
    (:func:`proto_dist_smem`)."""
    vec: int
    warps: int
    warp_rows: int
    col_tile: int
    chunks: int
    grid: Tuple[int, int]
    smem: int


def proto_dist_plan(n: int, c: int, p: int, dtype,
                    aligned: bool) -> ProtoDistPlan:
    """The launch of ``proto_dist`` over x ``[n, p]`` and protos ``[c,
    p]`` of ``dtype`` (fp32 or bf16): 16-byte vectors where ``p`` is a
    multiple of the vector and ``aligned`` (both bases on 16 bytes), else
    one element a load; the fewest column tiles of at most
    ``PD_COL_TILE`` that hold C, as even as can be; the fewest rows a warp
    (1, 2, 4) that keep each SM's reads of prototype rows from shared
    memory within ``PD_SMEM_READS`` (fewer where 4 warps' staged chunk
    would overflow ``PD_SMEM_MAX``); the most warps a block (16, 8, 4)
    whose staged chunk fits and that leave the grid ``PD_MIN_BLOCKS``
    blocks, else 4."""
    if n < 1 or c < 1 or p < 0:
        raise ValueError(f"proto_dist_plan: x [{n}, {p}], protos [{c}, {p}]")
    if dtype not in DTYPES:
        raise ValueError(f"proto_dist_plan: expected float32 or bfloat16, "
                         f"got {dtype}")
    size = 2 if dtype == torch.bfloat16 else 4
    wide = 16 // size           # elements of a 16-byte vector
    vec = wide if aligned and p % wide == 0 else 1
    tiles = -(-c // PD_COL_TILE)
    col_tile = -(-c // tiles)
    grid_y = -(-c // col_tile)
    if grid_y > MAX_GRID_Y:
        raise ValueError(f"proto_dist_plan: {c} prototypes need {grid_y} "
                         f"column tiles")
    reads = n * c * p * size / SMS
    rw = next((r for r in PD_WARP_ROWS if reads / r <= PD_SMEM_READS),
              PD_WARP_ROWS[-1])
    while rw > 1 and proto_dist_smem(PD_WARPS[-1] * rw, col_tile, p,
                                     dtype) > PD_SMEM_MAX:
        rw //= 2

    def fits(w):
        return (-(-n // (w * rw)) * grid_y >= PD_MIN_BLOCKS
                and proto_dist_smem(w * rw, col_tile, p, dtype)
                <= PD_SMEM_MAX)
    warps = next((w for w in PD_WARPS if fits(w)), PD_WARPS[-1])
    return ProtoDistPlan(vec, warps, rw, col_tile, -(-p // PD_CHUNK),
                         (-(-n // (warps * rw)), grid_y),
                         proto_dist_smem(warps * rw, col_tile, p, dtype))


def proto_dist_cuda(x, protos):
    """x ``[N, P]`` and protos ``[C, P]`` on the card, both fp32 or both
    bf16 -> d2 ``[N, C]`` fp32, in one launch laid out by
    :func:`proto_dist_plan`."""
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
    if out.numel():
        plan = proto_dist_plan(n, c, p_dim, x.dtype, x.data_ptr() % 16 == 0
                               and protos.data_ptr() % 16 == 0)
        rc = library().proto_dist(x.data_ptr(), protos.data_ptr(),
                                  out.data_ptr(), n, c, p_dim,
                                  int(x.dtype == torch.bfloat16), plan.vec,
                                  plan.warps, plan.warp_rows, plan.col_tile,
                                  *plan.grid, stream_of(x))
        check(rc, "proto_dist")
        PROTO_DIST_LAUNCHES.count += 1
    return out
