"""Hopper kernels of the packed wire codec.

``rowabs_cuda`` replaces ``repro/kernels/quantize/quantize.py:rowabs_pallas``,
``quantize_rows_cuda`` replaces ``quantize_rows_pallas`` (its
``_rows_call``), ``quantize_rows_mixed_cuda`` replaces
``quantize_rows_mixed_pallas``, and the error-feedback pair
``rowabs_sum_cuda`` / ``quantize_rows_ef_cuda`` replaces
``rowabs_sum_pallas`` / ``quantize_rows_ef_pallas``, and
``mix_packed_cuda`` replaces ``mix_packed_pallas`` (the receiver side of
the mesh exchange); the per-leaf and per-tensor codec:
``quantize_dequantize_rows_cuda`` replaces
``quantize_dequantize_rows_pallas``, ``dequantize_rows_cuda``
``dequantize_rows_pallas``, ``fused_quantize_cuda`` /
``fused_quantize_dequantize_cuda`` ``fused_quantize_pallas`` /
``fused_quantize_dequantize_pallas`` and ``dequantize_cuda``
``dequantize_pallas``.  The CUDA source is ``csrc/quantize.cu``.  Bound on
the H100: bytes — rowabs reads 4 B per
element, quantize_rows reads 4 B and writes a 4 B int32 code per element
(the mixed variant adds a 4 B qmax per row), rowabs_sum reads 8 B per
element, quantize_rows_ef reads 8 B and writes 8 B per element,
mix_packed must read 4 B of its own buffer per output, 4 B of code per
sender and column, and write 4 B per output; the per-leaf and per-tensor
sweeps read 4 B and write 4 B per element. Design: for the row absmax
(``rowabs``, ``rowabs_sum``), one body with one warp across a row, its
16-byte vectors of a 512-column step all loaded before any is folded,
then a shuffle max (:func:`absmax_plan`); for the row codec
(``quantize_rows``, ``quantize_rows_mixed``, ``quantize_rows_ef``,
``quantize_dequantize_rows``, ``dequantize_rows``), rows on the grid's y
axis and several 16-byte column vectors of one row a thread, its row's Δ
(and for the mixed widths and the error feedback its qmax) read once,
every load issued before any is converted (:func:`rows_plan`; a column
tail or an unaligned buffer takes one column a thread); the
error-feedback codes are the row codec's residual case, which loads the
residual's vectors beside x's and writes the new residual beside the
codes, with an IEEE division as the plain version has it; for
``dequantize``, 16-byte vectors between a scalar head and tail
(:func:`~repro_torch.kernels.sweep.sweep_plan`); for the mix, a thread
owns one 16-byte vector of one row for a group of up to 8 receivers
(their accumulators in registers, the group's weights in shared memory)
and walks the senders in order, so each sender's codes are read once per
receiver group, as 16-byte loads (:func:`mix_plan` picks the group, the
vector width and the grid; a column tail or an unaligned buffer takes
one column a thread); for the whole-tensor codec, one cooperative launch
whose blocks stage their spans of x in shared memory, write their maxima
to a partials buffer, meet at a grid sync and write the codes from
shared memory (:func:`fused_plan` picks the grid, the spans and what
each block stages). All are bit-identical to the plain versions in
``ref.py``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.kernels.build import (LaunchCounter, check, library,
                                       require, stream_of)
from repro_torch.kernels.sweep import SweepPlan, sweep_plan
from repro_torch.kernels.quantize.ref import (_qmaxf,  # noqa: F401  plain versions
                                              mix_packed_ref,
                                              quantize_rows_ef_ref,
                                              quantize_rows_mixed_ref,
                                              quantize_rows_ref,
                                              rowabs_ref, rowabs_sum_ref)

ROWABS_LAUNCHES = LaunchCounter("rowabs")
QUANTIZE_ROWS_LAUNCHES = LaunchCounter("quantize_rows")
QUANTIZE_ROWS_MIXED_LAUNCHES = LaunchCounter("quantize_rows_mixed")
ROWABS_SUM_LAUNCHES = LaunchCounter("rowabs_sum")
QUANTIZE_ROWS_EF_LAUNCHES = LaunchCounter("quantize_rows_ef")
MIX_PACKED_LAUNCHES = LaunchCounter("mix_packed")
QUANTIZE_DEQUANTIZE_ROWS_LAUNCHES = LaunchCounter("quantize_dequantize_rows")
DEQUANTIZE_ROWS_LAUNCHES = LaunchCounter("dequantize_rows")
FUSED_QUANTIZE_LAUNCHES = LaunchCounter("fused_quantize")
FUSED_QUANTIZE_DEQUANTIZE_LAUNCHES = LaunchCounter(
    "fused_quantize_dequantize")
DEQUANTIZE_LAUNCHES = LaunchCounter("dequantize")


def _rows(x2d, name: str):
    if x2d.dim() != 2:
        raise ValueError(f"{name}: expected [R, C], got {tuple(x2d.shape)}")
    require(x2d, f"{name} x", torch.float32)
    return x2d.shape


# -- the row codec's launch plan ----------------------------------------------
ROW_THREADS = 256           # threads a block (kRowThreads)
ROW_UNROLL = 4              # column vectors of its row a thread (kRowUnroll)
MAX_GRID_YZ = 65535


@dataclass(frozen=True)
class RowsPlan:
    """One launch of the row codec over ``[rows, cols]``: ``vec``
    columns a vector (one 16-byte vector when 4), ``ROW_UNROLL`` vectors
    of one row a thread, a block row's width apart; ``block`` ``(x:
    threads along a row, y: rows)``, ``grid`` ``(column tiles, row
    tiles)``; row tiles beyond the grid's are walked by a stride of
    ``grid[1]·block[1]`` rows, so a thread takes ``rows_a_thread``
    rows."""
    vec: int
    block: Tuple[int, int]
    grid: Tuple[int, int]
    rows_a_thread: int


def rows_plan(rows: int, cols: int, aligned: bool) -> RowsPlan:
    """The launch of ``quantize_rows``, ``quantize_rows_mixed``,
    ``quantize_rows_ef``, ``quantize_dequantize_rows`` or
    ``dequantize_rows`` over ``[rows, cols]``: 16-byte vectors where
    ``cols`` is a multiple of 4 and ``aligned`` (the inputs and the
    outputs start on 16-byte addresses), else one column a thread; the
    fewest whole warps along a row that hold its vectors at
    ``ROW_UNROLL`` a thread, up to ``ROW_THREADS``, the rest of a
    block's threads on rows."""
    if rows < 1 or cols < 1:
        raise ValueError(f"rows_plan: [{rows}, {cols}] is empty")
    if cols > 2 ** 30:
        raise ValueError(f"rows_plan: {cols} columns exceed 2^30")
    vec = 4 if aligned and cols % 4 == 0 else 1
    units = -(-cols // vec)
    bx = min(ROW_THREADS, -(-units // (32 * ROW_UNROLL)) * 32)
    by = ROW_THREADS // bx
    grid = (-(-units // (bx * ROW_UNROLL)), min(-(-rows // by), MAX_GRID_YZ))
    return RowsPlan(vec, (bx, by), grid, -(-rows // (grid[1] * by)))


def _row_codec(name: str, x2d, row_delta, out, *qmax) -> None:
    """Launch the row codec's entry point ``name`` over ``x2d`` into
    ``out`` (both contiguous ``[R, C]``, neither empty) as
    :func:`rows_plan` lays it out; ``qmax`` is the scalar qmax, or for
    ``quantize_rows_mixed`` the address of the ``[R]`` qmax column."""
    r, c = x2d.shape
    plan = rows_plan(r, c, x2d.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0)
    rc = getattr(library(), name)(
        x2d.data_ptr(), row_delta.data_ptr(), out.data_ptr(), r, c, *qmax,
        plan.vec, *plan.block, *plan.grid, stream_of(x2d))
    check(rc, name)


def quantize_rows_cuda(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32 and ``[R, 1]`` deltas on the card -> int32 codes."""
    r, c = _rows(x2d, "quantize_rows")
    require(row_delta, "quantize_rows row_delta", torch.float32, (r, 1))
    codes = torch.empty((r, c), dtype=torch.int32, device=x2d.device)
    if codes.numel():
        _row_codec("quantize_rows", x2d, row_delta, codes, _qmaxf(bits))
        QUANTIZE_ROWS_LAUNCHES.count += 1
    return codes


def quantize_rows_mixed_cuda(x2d, row_delta, row_qmax):
    """``[R, C]`` fp32 and ``[R, 1]`` deltas and qmax on the card ->
    int32 codes, each row clipped to its own width."""
    r, c = _rows(x2d, "quantize_rows_mixed")
    require(row_delta, "quantize_rows_mixed row_delta", torch.float32,
            (r, 1))
    require(row_qmax, "quantize_rows_mixed row_qmax", torch.float32, (r, 1))
    codes = torch.empty((r, c), dtype=torch.int32, device=x2d.device)
    if codes.numel():
        _row_codec("quantize_rows_mixed", x2d, row_delta, codes,
                   row_qmax.data_ptr())
        QUANTIZE_ROWS_MIXED_LAUNCHES.count += 1
    return codes


def quantize_dequantize_rows_cuda(x2d, row_delta, *, bits: int = 16):
    """``[R, C]`` fp32 and ``[R, 1]`` deltas on the card -> the fp32
    round trip ``codes·Δ_row``, the codes never stored."""
    r, c = _rows(x2d, "quantize_dequantize_rows")
    require(row_delta, "quantize_dequantize_rows row_delta", torch.float32,
            (r, 1))
    out = torch.empty((r, c), dtype=torch.float32, device=x2d.device)
    if out.numel():
        _row_codec("quantize_dequantize_rows", x2d, row_delta, out,
                   _qmaxf(bits))
        QUANTIZE_DEQUANTIZE_ROWS_LAUNCHES.count += 1
    return out


def dequantize_rows_cuda(codes2d, row_delta):
    """``[R, C]`` int32 codes and ``[R, 1]`` deltas on the card -> fp32
    ``codes·Δ_row``."""
    if codes2d.dim() != 2:
        raise ValueError(f"dequantize_rows: expected [R, C], got "
                         f"{tuple(codes2d.shape)}")
    r, c = codes2d.shape
    require(codes2d, "dequantize_rows codes", torch.int32)
    require(row_delta, "dequantize_rows row_delta", torch.float32, (r, 1))
    out = torch.empty((r, c), dtype=torch.float32, device=codes2d.device)
    if out.numel():
        _row_codec("dequantize_rows", codes2d, row_delta, out)
        DEQUANTIZE_ROWS_LAUNCHES.count += 1
    return out


# -- the row absmax: rowabs and rowabs_sum ------------------------------------
@dataclass(frozen=True)
class AbsmaxPlan(RowsPlan):
    """One launch of the row absmax over ``[rows, cols]``: a
    :class:`RowsPlan` with one warp across a row (``block`` ``(32, 8)``,
    ``grid`` ``(1, row tiles)``), whose lanes walk the row in ``steps``
    steps of ``32·ROW_UNROLL·vec`` columns."""
    steps: int


def absmax_plan(rows: int, cols: int, aligned: bool) -> AbsmaxPlan:
    """The launch of ``rowabs`` or ``rowabs_sum`` over ``[rows, cols]``:
    16-byte vectors where ``cols`` is a multiple of 4 and ``aligned`` (x,
    and res for ``rowabs_sum``, start on 16-byte addresses), else one
    column a vector; :func:`rows_plan` laid out for one step of a row
    (at most ``32·ROW_UNROLL`` vectors, so one warp across it), and the
    steps that cover ``cols``."""
    if rows < 1 or cols < 1:
        raise ValueError(f"absmax_plan: [{rows}, {cols}] is empty")
    vec = 4 if aligned and cols % 4 == 0 else 1
    step = 32 * ROW_UNROLL * vec
    base = rows_plan(rows, min(cols, step), vec == 4)
    return AbsmaxPlan(base.vec, base.block, base.grid, base.rows_a_thread,
                      -(-cols // step))


def _row_absmax(name: str, x2d, res2d, out, *decay) -> None:
    """Launch ``rowabs`` (``res2d`` None) or ``rowabs_sum`` over ``x2d``
    (contiguous ``[R, C]``, R > 0) into ``out`` as :func:`absmax_plan`
    lays it out."""
    r, c = x2d.shape
    bufs = (x2d,) if res2d is None else (x2d, res2d)
    plan = absmax_plan(r, c, all(t.data_ptr() % 16 == 0 for t in bufs))
    rc = getattr(library(), name)(
        *(t.data_ptr() for t in bufs), out.data_ptr(), r, c, *decay,
        plan.vec, *plan.block, *plan.grid, stream_of(x2d))
    check(rc, name)


def rowabs_cuda(x2d):
    """``[R, C]`` fp32 on the card -> per-row ``max|x|`` ``[R, 1]``."""
    r, c = _rows(x2d, "rowabs")
    out = torch.empty((r, 1), dtype=torch.float32, device=x2d.device)
    if r:
        _row_absmax("rowabs", x2d, None, out)
        ROWABS_LAUNCHES.count += 1
    return out


def rowabs_sum_cuda(x2d, res2d, decay: float):
    """``[R, C]`` fp32 payload and residual on the card -> per-row
    ``max|x + decay·res|`` ``[R, 1]`` (``decay`` rounds to fp32)."""
    r, c = _rows(x2d, "rowabs_sum")
    require(res2d, "rowabs_sum res", torch.float32, (r, c))
    out = torch.empty((r, 1), dtype=torch.float32, device=x2d.device)
    if r:
        _row_absmax("rowabs_sum", x2d, res2d, out, float(decay))
        ROWABS_SUM_LAUNCHES.count += 1
    return out


# -- the whole-tensor codec's launch plan -----------------------------------
FUSED_CHUNK = 4096          # floats a staging chunk, one mbarrier each
FUSED_MAX_CHUNKS = 16       # staging barriers a block (kMaxChunks)
MIN_SPAN = 8192             # elements a block at least: tiny tensors, 1 block
BLOCKS_PER_SM = 2           # blocks an SM (the kernel's __launch_bounds__)
SMEM_MAX = 232_448          # shared memory a block may opt in to (sm_90)
SMEM_SM = 233_472           # shared memory of an SM
SMEM_RESERVED = 1024        # the runtime's share of it for each block
SMEM_STATIC = 512           # the kernel's static shared memory, at most


@dataclass(frozen=True)
class FusedPlan:
    """One launch of the whole-tensor codec over ``n`` elements whose
    first lies ``align`` floats past a 16-byte boundary: ``grid`` blocks
    of 512 threads; block b owns the 16-byte address slots
    ``[b·span, (b+1)·span)`` (counted from that boundary), stages up to
    ``stage`` of its elements in dynamic shared memory (filled by
    ``cp.async.bulk``) and streams the rest."""
    n: int
    align: int
    grid: int
    span: int
    stage: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory a block, in bytes."""
        return 4 * self.stage

    @property
    def staged(self) -> int:
        """Elements staged in shared memory, all blocks together (the
        rest, ``n - staged``, stream)."""
        return sum(s_hi - s_lo for _, s_lo, s_hi, _ in fused_spans(self))


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def fused_spans(plan: FusedPlan) -> List[Tuple[int, int, int, int]]:
    """Each block's ``(lo, s_lo, s_hi, hi)``, as the kernel computes them:
    it owns elements ``[lo, hi)``, stages ``[s_lo, s_hi)`` (both ends on
    16-byte addresses) and streams ``[lo, s_lo)`` and ``[s_hi, hi)``."""
    n, align, span = plan.n, plan.align, plan.span
    out = []
    for b in range(plan.grid):
        lo = max(0, b * span - align)
        hi = min(n, (b + 1) * span - align)
        s_lo = min(hi, _round4(lo + align) - align)
        s_hi = max(s_lo, min((hi + align) // 4 * 4 - align,
                             s_lo + plan.stage))
        out.append((lo, s_lo, s_hi, hi))
    return out


def fused_plan(n: int, align: int, sms: int) -> FusedPlan:
    """The launch of ``fused_quantize(_dequantize)``: one block for every
    ``MIN_SPAN`` elements, at most ``BLOCKS_PER_SM`` on each of ``sms``
    SMs; the span a multiple of 4 (so every block's interior ends lie on
    16-byte addresses); each block stages its span or as much of it as
    its share of an SM's shared memory holds, and streams the rest (read
    again after the grid sync)."""
    if n < 1:
        raise ValueError("fused_quantize: an empty tensor has no absmax")
    if align not in range(4) or sms < 1:
        raise ValueError(f"fused_plan: align {align}, {sms} SMs")
    slots = n + align
    grid = min(sms * BLOCKS_PER_SM, -(-slots // MIN_SPAN))
    span = _round4(-(-slots // grid))
    grid = -(-slots // span)
    cap = min(SMEM_MAX, SMEM_SM // BLOCKS_PER_SM - SMEM_RESERVED
              - SMEM_STATIC, 4 * FUSED_CHUNK * FUSED_MAX_CHUNKS) // 16 * 4
    return FusedPlan(n, align, grid, span, min(span, cap))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fused_call(x, bits: int, dequant: bool):
    name = "fused_quantize_dequantize" if dequant else "fused_quantize"
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected {torch.float32}, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{name}: an empty tensor has no absmax")
    require(x, f"{name} x", torch.float32)
    plan = fused_plan(x.numel(), x.data_ptr() // 4 % 4, _sms(x.device.index))
    out = torch.empty(x.shape, device=x.device,
                      dtype=torch.float32 if dequant else torch.int32)
    delta = torch.empty((), dtype=torch.float32, device=x.device)
    partials = torch.empty((plan.grid,), dtype=torch.float32,
                           device=x.device)
    rc = getattr(library(), name)(
        x.data_ptr(), out.data_ptr(), delta.data_ptr(), partials.data_ptr(),
        x.numel(), _qmaxf(bits), plan.grid, plan.span, plan.stage,
        stream_of(x))
    check(rc, name)
    return out, delta

def fused_quantize_cuda(x, *, bits: int = 16):
    """fp32 ``x`` (any shape) on the card -> ``(int32 codes of x's shape,
    0-d Δ)``: the absmax and the codes in one cooperative launch, as
    :func:`fused_plan` lays it out."""
    out = _fused_call(x, bits, False)
    FUSED_QUANTIZE_LAUNCHES.count += 1
    return out


def fused_quantize_dequantize_cuda(x, *, bits: int = 16):
    """fp32 ``x`` (any shape) on the card -> ``(codes·Δ fp32, 0-d Δ)``,
    the codes never stored; one cooperative launch."""
    out = _fused_call(x, bits, True)
    FUSED_QUANTIZE_DEQUANTIZE_LAUNCHES.count += 1
    return out


DEQ_THREADS = 256           # threads a block (kFlatThreads)
DEQ_UNROLL = 4              # vectors a thread (kFlatUnroll)


def dequantize_plan(n: int, align_codes: int, align_out: int) -> SweepPlan:
    """The split of ``dequantize``'s ``n`` elements for codes and out
    whose first elements lie ``align_codes`` and ``align_out`` elements
    past a 16-byte boundary (:func:`~repro_torch.kernels.sweep.
    sweep_plan`, in blocks of ``DEQ_THREADS``, ``DEQ_UNROLL`` vectors a
    thread)."""
    return sweep_plan(n, align_codes, align_out, threads=DEQ_THREADS,
                      unroll=DEQ_UNROLL, name="dequantize")


def _dequantize(codes, delta, out) -> None:
    """Launch ``dequantize`` over ``codes`` into ``out`` (both
    contiguous, neither empty) as :func:`dequantize_plan` splits it."""
    plan = dequantize_plan(codes.numel(), codes.data_ptr() // 4 % 4,
                           out.data_ptr() // 4 % 4)
    rc = library().dequantize(codes.data_ptr(), delta.data_ptr(),
                              out.data_ptr(), codes.numel(), plan.vec,
                              plan.head, plan.body, plan.grid,
                              stream_of(codes))
    check(rc, "dequantize")


def dequantize_cuda(codes, delta):
    """int32 codes (any shape) and a 0-d fp32 Δ on the card -> fp32
    ``codes·Δ``; Δ is read on the card (no host sync).  One launch, as
    :func:`dequantize_plan` splits it."""
    require(codes, "dequantize codes", torch.int32)
    require(delta, "dequantize delta", torch.float32, ())
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if out.numel():
        _dequantize(codes, delta, out)
        DEQUANTIZE_LAUNCHES.count += 1
    return out


def quantize_rows_ef_cuda(x2d, res2d, row_delta, row_qmax, decay: float):
    """``[R, C]`` fp32 payload and residual, ``[R, 1]`` deltas and qmax
    on the card -> ``(int32 codes, new residual fp32)`` in one launch of
    the row codec's residual case, as :func:`rows_plan` lays it out
    (``decay`` rounds to fp32; 16-byte vectors where x, res, the codes
    and the new residual all start on 16-byte addresses)."""
    r, c = _rows(x2d, "quantize_rows_ef")
    require(res2d, "quantize_rows_ef res", torch.float32, (r, c))
    require(row_delta, "quantize_rows_ef row_delta", torch.float32, (r, 1))
    require(row_qmax, "quantize_rows_ef row_qmax", torch.float32, (r, 1))
    codes = torch.empty((r, c), dtype=torch.int32, device=x2d.device)
    new_res = torch.empty((r, c), dtype=torch.float32, device=x2d.device)
    if codes.numel():
        bufs = (x2d, res2d, codes, new_res)
        plan = rows_plan(r, c, all(t.data_ptr() % 16 == 0 for t in bufs))
        rc = library().quantize_rows_ef(
            x2d.data_ptr(), res2d.data_ptr(), row_delta.data_ptr(),
            row_qmax.data_ptr(), codes.data_ptr(), new_res.data_ptr(), r, c,
            float(decay), plan.vec, *plan.block, *plan.grid, stream_of(x2d))
        check(rc, "quantize_rows_ef")
        QUANTIZE_ROWS_EF_LAUNCHES.count += 1
        QUANTIZE_ROWS_EF_LAUNCHES.last_plan = plan
    return codes, new_res


# -- the mix's launch plan ----------------------------------------------------
MIX_THREADS = 128           # threads a block (kMixThreads)
MIX_GROUPS = (1, 2, 4, 8)   # receivers a thread (the kernel's template G)
MIX_SMEM = 48 * 1024        # the group's weights: static shared-memory limit
# threads a launch should have: 24 warps on each of 132 SMs.  At the mesh
# round's 8 x 8 (R = 416) groups of 8 leave 53,248 threads and time
# 0.0173 ms, groups of 4 106,496 threads and 0.0150 ms (the second read
# of a sender's codes comes from L2), groups of 2 0.0170 ms
# (benchmarks/torch_mix_adafactor_phases.py --plans, H100 SXM)
MIX_MIN_THREADS = 132 * 768


@dataclass(frozen=True)
class MixPlan:
    """One launch of ``mix_packed``: ``group`` receivers a thread,
    ``vec`` columns a thread (one 16-byte vector when 4), ``block``
    ``(x: column vectors, y: rows)``, ``grid`` ``(column tiles, row
    tiles, receiver groups)``; row tiles beyond the grid's are walked
    by a stride of ``grid[1]·block[1]`` rows."""
    group: int
    vec: int
    block: Tuple[int, int]
    grid: Tuple[int, int, int]

    def smem(self, s: int) -> int:
        """Shared memory a block for ``s`` senders: the group's
        ``w_self`` and ``w_rows``, in bytes."""
        return 4 * self.group * (s + 1)


def mix_plan(m: int, s: int, rows: int, cols: int,
             aligned: bool) -> MixPlan:
    """The launch of ``mix_packed`` for M receivers, S senders and
    ``[rows, cols]`` buffers: 16-byte vectors where ``cols`` is a
    multiple of 4 and ``aligned`` (own, codes and out start on 16-byte
    addresses), else one column a thread; receiver groups of the least
    of 1, 2, 4, 8 that holds min(M, 8), halved while the launch has
    fewer than ``MIX_MIN_THREADS`` threads or the group's weights
    overflow ``MIX_SMEM``; up to ``MIX_THREADS`` threads along a row
    and the rest of a block's on rows."""
    if m < 1 or s < 0 or rows < 1 or cols < 1:
        raise ValueError(f"mix_packed: {m} receivers, {s} senders, "
                         f"[{rows}, {cols}] buffers")
    if rows > 2 ** 31 - 1:
        raise ValueError(f"mix_packed: {rows} rows exceed 32 bits")
    vec = 4 if aligned and cols % 4 == 0 else 1
    units = -(-cols // vec)
    group = next(g for g in MIX_GROUPS if g >= min(m, MIX_GROUPS[-1]))
    while group > 1 and (4 * group * (s + 1) > MIX_SMEM or rows * units
                         * -(-m // group) < MIX_MIN_THREADS):
        group //= 2
    if 4 * group * (s + 1) > MIX_SMEM:
        raise ValueError(f"mix_packed: {s} senders' weights overflow "
                         f"{MIX_SMEM} B of shared memory")
    bx = min(MIX_THREADS, -(-units // 32) * 32)
    by = MIX_THREADS // bx
    grid = (-(-units // bx), min(-(-rows // by), MAX_GRID_YZ),
            -(-m // group))
    if grid[2] > MAX_GRID_YZ:
        raise ValueError(f"mix_packed: {m} receivers need {grid[2]} "
                         f"groups")
    return MixPlan(group, vec, (bx, by), grid)


def mix_packed_cuda(own, codes, row_delta, w_self, w_rows):
    """``own [M, R, C]`` fp32, ``codes [S, R, C]`` int32 or fp32,
    ``row_delta [S, R]``, ``w_self [M]`` and ``w_rows [M, S]`` fp32 on
    the card -> the mixed ``[M, R, C]`` fp32 buffer, in one launch laid
    out by :func:`mix_plan`."""
    if own.dim() != 3 or codes.dim() != 3:
        raise ValueError(f"mix_packed: expected own [M, R, C] and codes "
                         f"[S, R, C], got {tuple(own.shape)} and "
                         f"{tuple(codes.shape)}")
    m, r, c = own.shape
    s = codes.shape[0]
    if codes.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"mix_packed codes: expected int32 or float32, got "
                         f"{codes.dtype}")
    require(own, "mix_packed own", torch.float32)
    require(codes, "mix_packed codes", codes.dtype, (s, r, c))
    require(row_delta, "mix_packed row_delta", torch.float32, (s, r))
    require(w_self, "mix_packed w_self", torch.float32, (m,))
    require(w_rows, "mix_packed w_rows", torch.float32, (m, s))
    out = torch.empty((m, r, c), dtype=torch.float32, device=own.device)
    if out.numel() == 0:
        return out
    plan = mix_plan(m, s, r, c, all(t.data_ptr() % 16 == 0
                                    for t in (own, codes, out)))
    rc = library().mix_packed(own.data_ptr(), codes.data_ptr(),
                              row_delta.data_ptr(), w_self.data_ptr(),
                              w_rows.data_ptr(), out.data_ptr(), m, s, r, c,
                              int(codes.dtype == torch.float32), plan.group,
                              plan.vec, *plan.block, *plan.grid,
                              stream_of(own))
    check(rc, "mix_packed")
    MIX_PACKED_LAUNCHES.count += 1
    return out
