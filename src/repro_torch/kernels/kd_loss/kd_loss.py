"""Hopper kernel: the fused temperature-KD loss per row.

Replaces ``repro/kernels/kd_loss/kd_loss.py:kd_loss_rows_pallas`` (the
CUDA source is ``csrc/kd_loss.cu``): ``[R, V] x [R, V]`` logits, fp32 or
bf16 -> per-row ``KL(softmax(y_t/T) || softmax(y_s/T))·T²`` ``[R]`` fp32,
in one pass with the Pallas body's online maxima and normalisers (in the
log2 domain: the logits scaled by ``log2 e / T``, the SFU's ``exp2``
and ``log2f``), so neither probability tensor is made.  What bounds it on the
H100, and the design :func:`kd_plan` picks for it:

* small V (``V <= KD_SMALL_V``; the ProFe KD term, ``[320, 10]`` fp32,
  25.6 KB): one launch and one round trip to memory.  A row takes a
  segment of a warp (``lanes`` lanes, a power of two) and a block many
  rows; a lane holds at most ``KD_LANE_ELEMS`` logits a side, so the
  row's max comes first and each logit takes one ``exp2`` a side, with no
  rescale ("segments").
* large V with a row for each SM or more (``[256, 202048]``, ``[250,
  50280]``): bytes (207 MB in bf16 at llama4-scout's vocabulary, 0.062
  ms), if a logit costs few instructions.  A block a row ("blocks"); a
  thread walks tiles of ``KD_TILE`` logits a side, 16-byte loads (4
  fp32 or 8 bf16 logits a load) all issued before any is used, kept as
  the words they arrive in, the tile's maxima, one
  rescale of its state a tile and one ``exp2`` a logit a side, no branch
  a logit; a row off 16 bytes or not a whole number of vectors takes one
  logit a load (``vec`` 1).  States merge by shuffles and over the warps
  with the Pallas rescaling.
* large V with fewer rows than SMs: a thread-block cluster of ``splits``
  (<= ``KD_MAX_SPLITS``) blocks a row, each the blocks design on a span
  of V, whose states block 0 merges in rank order through distributed
  shared memory ("clusters").

Every merge runs in a fixed order and nothing is atomic, so repeated
calls give the same bits.  Its plain version is
:func:`~repro_torch.kernels.kd_loss.ref.kd_loss_rows_ref` (the direct
softmax form; the finish subtracts terms of the size of ``max|y|/T``, so
the two agree to an absolute tolerance scaled by it).  No backward, as
in ``repro``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref  # noqa: F401  the plain version

KD_LOSS_LAUNCHES = LaunchCounter("kd_loss")

# the input types the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)

# -- the launch plan (the constants of csrc/kd_loss.cu) ------------------------
KD_LANE_ELEMS = 8           # logits a lane a side, segments (kLaneElems)
KD_SMALL_V = 32 * KD_LANE_ELEMS   # the widest row a warp holds
KD_SEG_THREADS = 128        # a segments block at most (kSegThreads)
KD_TILE = 16                # logits a thread a side a tile (kTile)
KD_THREADS = 512            # a rows block at most (kMaxThreads)
KD_MAX_SPLITS = 8           # blocks a cluster (kMaxSplits)
H100_SMS = 132
DESIGNS = ("segments", "blocks", "clusters")   # the launcher's 0, 1, 2
MAX_GRID = 2 ** 31 - 1


@dataclass(frozen=True)
class KdPlan:
    """One launch of ``kd_loss_rows``.  ``design`` "segments": a row takes
    ``lanes`` lanes of a warp, each holding ``span`` logits a side
    (logits ``q + k·lanes`` of lane ``q``), a block ``threads // lanes``
    rows.  "blocks" / "clusters": a row takes ``splits`` blocks (one
    cluster), block ``k`` of it the row's ``vec``-wide vectors ``[k·span,
    (k + 1)·span)``, walked in tiles of :func:`tile_loads` vectors a
    thread, ``threads`` apart.  ``grid`` blocks in all."""
    design: str
    vec: int
    threads: int
    lanes: int
    splits: int
    span: int
    grid: int


def tile_loads(vec: int) -> int:
    """Loads a thread issues a side a tile of ``KD_TILE`` logits: 4
    16-byte fp32 vectors, 2 bf16 ones, or 16 single logits (``vec`` 1)."""
    return KD_TILE // vec


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def kd_plan(rows: int, v: int, elem_bytes: int, aligned: bool,
            sms: int = H100_SMS) -> KdPlan:
    """The launch over ``[rows, v]`` logits of ``elem_bytes`` (4 or 2)
    whose two bases are on 16 bytes when ``aligned``, on a card of
    ``sms`` SMs: segments up to ``KD_SMALL_V`` logits a row (the fewest
    lanes that hold a row at ``KD_LANE_ELEMS`` a lane; blocks halved from
    ``KD_SEG_THREADS`` toward one warp while the grid has fewer blocks
    than SMs); else a block a row, 16-byte vectors where aligned and ``v``
    is a whole number of them, the fewest threads (whole warps, a power
    of two, at most ``KD_THREADS``) whose tile holds the row, and below
    ``sms`` rows a cluster of up to ``KD_MAX_SPLITS`` blocks a row, no
    more than the row has tiles, the span split evenly."""
    if rows < 1 or v < 1:
        raise ValueError(f"kd_plan: [{rows}, {v}] is empty")
    if elem_bytes not in (2, 4):
        raise ValueError(f"kd_plan: {elem_bytes}-byte logits")
    if v >= 2 ** 31:
        raise ValueError(f"kd_plan: V = {v} exceeds 2^31 - 1")
    if v <= KD_SMALL_V:
        lanes = _pow2_at_least(-(-v // KD_LANE_ELEMS))
        threads = KD_SEG_THREADS
        while threads > 32 and -(-rows // (threads // lanes)) < sms:
            threads //= 2
        grid = -(-rows // (threads // lanes))
        if grid > MAX_GRID:
            raise ValueError(f"kd_plan: {rows} rows exceed the grid")
        return KdPlan("segments", 1, threads, lanes, 1, -(-v // lanes),
                      grid)
    wide = 16 // elem_bytes
    vec = wide if aligned and v % wide == 0 else 1
    nvec = v // vec
    per = tile_loads(vec)
    threads = min(KD_THREADS, max(32, _pow2_at_least(-(-nvec // per))))
    tiles = -(-nvec // (threads * per))
    splits = (1 if rows >= sms
              else max(1, min(KD_MAX_SPLITS, -(-sms // rows), tiles)))
    grid = rows * splits
    if grid > MAX_GRID:
        raise ValueError(f"kd_plan: {rows} rows exceed the grid")
    return KdPlan("clusters" if splits > 1 else "blocks", vec, threads, 0,
                  splits, -(-nvec // splits), grid)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kd_loss_rows_cuda(student_logits, teacher_logits, temperature: float):
    """``[R, V]`` student and teacher logits on the card, both fp32 or
    both bf16 -> per-row KD loss ``[R]`` fp32 (already ``* T²``)."""
    if student_logits.dim() != 2:
        raise ValueError(f"kd_loss: logits must be [R, V], got "
                         f"{tuple(student_logits.shape)}")
    rows, v = student_logits.shape
    if v == 0:
        raise ValueError("kd_loss: empty vocabulary")
    if student_logits.dtype not in DTYPES:
        raise ValueError(f"kd_loss: expected float32 or bfloat16, got "
                         f"{student_logits.dtype}")
    require(student_logits, "kd_loss student_logits", student_logits.dtype)
    require(teacher_logits, "kd_loss teacher_logits", student_logits.dtype,
            (rows, v))
    out = torch.empty((rows,), dtype=torch.float32,
                      device=student_logits.device)
    if rows == 0:
        return out
    plan = kd_plan(rows, v, student_logits.element_size(),
                   student_logits.data_ptr() % 16 == 0
                   and teacher_logits.data_ptr() % 16 == 0,
                   _sm_count(student_logits.device.index))
    # the TPU kernel's scalars: inv_t = 1/T, and the finish divides by
    # inv_t * inv_t taken in double; the exponents are in the log2 domain,
    # y · inv_t · log2 e.  ctypes rounds both to fp32.
    inv_t = 1.0 / temperature
    rc = library().kd_loss_rows(
        student_logits.data_ptr(), teacher_logits.data_ptr(),
        out.data_ptr(), rows, v, inv_t * math.log2(math.e), inv_t * inv_t,
        int(student_logits.dtype == torch.bfloat16),
        DESIGNS.index(plan.design), plan.vec, plan.threads, plan.lanes,
        plan.splits, plan.span, plan.grid, stream_of(student_logits))
    check(rc, "kd_loss")
    KD_LOSS_LAUNCHES.count += 1
    return out
