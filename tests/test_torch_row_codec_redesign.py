"""The Hopper redesign of the row codec (``quantize_rows``,
``quantize_dequantize_rows``, ``dequantize_rows``) and of the scalar-Δ
``dequantize``, held on the CPU where it can be: their launch plans, the
wrappers' limits, and the plain versions against the Pallas kernels they
replace.  That the CUDA kernels are bit-identical to their plain versions
is held on the card only (``chip_smoke.py`` phase 3: the paths' shapes
and the edge cases of ``row_codec_cases`` and ``dequantize_cases``).

* ``rows_plan`` over rows in {1, 5, 416, 8240, 70000, 600000} and cols in
  {512, 510, 10, 8, 4, 3, 1, 8192}, aligned or not: every element written
  by exactly one thread (columns by exactly one vector of one thread of a
  block row, rows by exactly one step of the row stride), 16-byte vectors
  exactly where the buffers are aligned and cols is a multiple of 4, the
  block and grid within the card's limits, no block empty.
* The flat split, shared by ``dequantize`` and ``adafactor_apply``
  (``kernels/sweep.py``): every element covered once for offsets 0-3
  and n from 1 to 7 up to the teacher leaf's 2,359,296, the body on
  16-byte addresses of both buffers, one element a vector exactly when
  the offsets differ.
* The four wrappers raise on CPU tensors, wrong dtypes and wrong shapes.
* The plain versions against ``quantize_rows_pallas``,
  ``quantize_dequantize_rows_pallas``, ``dequantize_rows_pallas`` and
  ``dequantize_pallas`` in interpret mode, bit for bit, at odd cols, one
  row, 70,000 rows of 8, views at storage offsets 1-3, widths 16, 8 and
  4 with exact half-steps and codes beyond ±qmax, and all zeros; inputs
  from a numpy seed.
"""
import numpy as np
import pytest
import torch

from repro.kernels.quantize.quantize import (dequantize_pallas,
                                             dequantize_rows_pallas,
                                             quantize_dequantize_rows_pallas,
                                             quantize_rows_pallas)
from repro_torch.kernels.opt_update import opt_update as OU
from repro_torch.kernels.quantize import ops as tqops
from repro_torch.kernels.quantize import quantize as Q
from repro_torch.kernels.quantize import ref as tref
from repro_torch.kernels.sweep import sweep_plan

torch.set_num_threads(2)

ROWS = (1, 5, 416, 8240, 70000, 600000)
COLS = (512, 510, 10, 8, 4, 3, 1, 8192)
TINY = np.finfo(np.float32).tiny


# -- (a) the row codec's launch plan -------------------------------------------

def plan_indices(plan, rows, cols):
    """What the plan's threads write, axis by axis: the rows of each row
    thread and step of the row stride, and the columns of each vector of
    each thread of a block row (thread ``tx`` of column tile ``bx``
    takes vectors ``bx·block_x·ROW_UNROLL + tx + k·block_x``)."""
    bx, by = plan.block
    gx, gy = plan.grid
    threads = gy * by
    row = (np.arange(threads)[:, None]
           + threads * np.arange(-(-rows // threads))[None]).ravel()
    row = row[row < rows]
    tile, tx, k = np.meshgrid(np.arange(gx), np.arange(bx),
                              np.arange(Q.ROW_UNROLL), indexing="ij")
    first = (tile * bx * Q.ROW_UNROLL + tx + k * bx).ravel() * plan.vec
    first = first[first < cols]
    col = (first[:, None] + np.arange(plan.vec)[None]).ravel()
    return row, col


def _once(idx, n):
    return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("cols", COLS)
def test_rows_plan_covers_each_element_once(rows, cols):
    for aligned in (True, False):
        plan = Q.rows_plan(rows, cols, aligned)
        what = (rows, cols, aligned, plan)
        assert plan.vec == (4 if aligned and cols % 4 == 0 else 1), what
        bx, by = plan.block
        assert bx % 32 == 0 and bx * by == Q.ROW_THREADS, what
        gx, gy = plan.grid
        assert gx >= 1 and 1 <= gy <= Q.MAX_GRID_YZ, what
        span = bx * Q.ROW_UNROLL * plan.vec
        assert (gx - 1) * span < cols <= gx * span, what   # no tile empty
        assert (gy - 1) * by < rows, what
        # the fewest whole warps that hold a row's vectors
        units = -(-cols // plan.vec)
        assert bx == Q.ROW_THREADS or bx - 32 < -(-units // Q.ROW_UNROLL), \
            what
        row, col = plan_indices(plan, rows, cols)
        assert _once(row, rows) and _once(col, cols), what
        assert plan.rows_a_thread == -(-rows // (gy * by)), what


def test_rows_plan_at_the_paths_shapes_and_limits():
    # the paths' 512 columns: one warp a row, 8 rows a block
    for rows in (8240, 8320, 4184):
        plan = Q.rows_plan(rows, 512, True)
        assert (plan.vec, plan.block) == (4, (32, 8))
        assert plan.grid == (1, -(-rows // 8)) and plan.rows_a_thread == 1
    assert Q.rows_plan(8240, 512, False).vec == 1
    assert Q.rows_plan(8240, 510, True).vec == 1
    # beyond 65,535 row tiles the rows are walked by a stride
    big = Q.rows_plan(600000, 8, True)
    assert big.grid[1] == Q.MAX_GRID_YZ and big.rows_a_thread == 2
    assert Q.rows_plan(70000, 8, True).rows_a_thread == 1
    for bad in ((0, 512), (5, 0), (5, 2 ** 30 + 4)):
        with pytest.raises(ValueError):
            Q.rows_plan(*bad, True)


# -- (b) the flat split, shared by dequantize and adafactor_apply -------------

def flat_cover(plan, n, threads, unroll):
    """How often the kernel's threads touch each element of ``[0, n)``:
    thread ``gid`` does head element ``gid`` and tail element ``gid``
    where those exist, then vectors ``v0 + k·threads``, ``k < unroll``,
    of its block's tile."""
    gid = np.arange(plan.grid * threads)
    hits = [gid[gid < plan.head],
            plan.head + plan.vec * plan.body + gid[gid < plan.tail]]
    block, t = np.divmod(gid, threads)
    v = (block * threads * unroll + t)[:, None] + threads * np.arange(unroll)
    v = v.ravel()
    v = v[v < plan.body]
    hits.append((plan.head + plan.vec * v[:, None]
                 + np.arange(plan.vec)).ravel())
    return np.bincount(np.concatenate(hits), minlength=n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 100003, 2359296])
@pytest.mark.parametrize("align", [0, 1, 2, 3])
def test_dequantize_split_covers_once(n, align):
    plan = Q.dequantize_plan(n, align, align)
    what = (n, align, plan)
    assert plan.vec == 4 and 0 <= plan.head <= 3 and 0 <= plan.tail <= 3, \
        what
    assert plan.head + 4 * plan.body + plan.tail == n, what
    if plan.body:
        assert (align + plan.head) % 4 == 0, what   # the body on 16 bytes
    tile = Q.DEQ_THREADS * Q.DEQ_UNROLL
    assert plan.grid == max(1, -(-plan.body // tile)), what
    hits = flat_cover(plan, n, Q.DEQ_THREADS, Q.DEQ_UNROLL)
    assert len(hits) == n and (hits == 1).all(), what


@pytest.mark.parametrize("aligns", [(0, 1), (1, 0), (3, 2), (2, 1)])
@pytest.mark.parametrize("n", [1, 7, 100003])
def test_dequantize_split_without_a_common_body(aligns, n):
    plan = Q.dequantize_plan(n, *aligns)
    assert (plan.vec, plan.head, plan.body, plan.tail) == (1, 0, n, 0)
    assert (flat_cover(plan, n, Q.DEQ_THREADS, Q.DEQ_UNROLL) == 1).all()


def test_the_flat_split_is_one_helper():
    # both wrappers' plans are sweep_plan's, at their own block sizes
    assert Q.sweep_plan is OU.sweep_plan is sweep_plan
    for n, a, b in ((1, 0, 0), (4099, 1, 1), (2129919, 1, 2), (17, 3, 3)):
        assert Q.dequantize_plan(n, a, b) == sweep_plan(
            n, a, b, threads=Q.DEQ_THREADS, unroll=Q.DEQ_UNROLL,
            name="dequantize")
        assert OU.adafactor_plan(n, a, b) == sweep_plan(
            n, a, b, threads=OU.ADA_THREADS, unroll=OU.ADA_UNROLL,
            name="adafactor_apply")
    with pytest.raises(ValueError, match="dequantize: n must be positive"):
        Q.dequantize_plan(0, 0, 0)
    for bad in ((4, 0), (0, -1)):
        with pytest.raises(ValueError, match="offsets"):
            Q.dequantize_plan(8, *bad)


# -- (c) the wrappers' limits -------------------------------------------------

@pytest.fixture
def card_tensors(monkeypatch):
    """CPU tensors that pass the wrappers' device check, so their dtype
    and shape checks can be reached (each raises before any launch)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))


def test_wrappers_raise_on_cpu_tensors():
    x, rd = torch.zeros((8, 512)), torch.ones((8, 1))
    codes = torch.zeros((8, 512), dtype=torch.int32)
    for call in (lambda: Q.quantize_rows_cuda(x, rd),
                 lambda: Q.quantize_dequantize_rows_cuda(x, rd),
                 lambda: Q.dequantize_rows_cuda(codes, rd),
                 lambda: Q.dequantize_cuda(codes, torch.ones(()))):
        with pytest.raises(ValueError, match="CUDA"):
            call()


ROW_WRAPPERS = {"quantize_rows": Q.quantize_rows_cuda,
                "quantize_dequantize_rows": Q.quantize_dequantize_rows_cuda,
                "dequantize_rows": Q.dequantize_rows_cuda}


@pytest.mark.parametrize("name", sorted(ROW_WRAPPERS))
@pytest.mark.parametrize("bad", ["x dtype", "x rank", "delta shape",
                                 "delta dtype", "x strided"])
def test_row_wrappers_raise_on_dtype_and_shape(card_tensors, name, bad):
    xdt = torch.int32 if name == "dequantize_rows" else torch.float32
    x, rd = torch.zeros((8, 512), dtype=xdt), torch.ones((8, 1))
    if bad == "x dtype":
        x = x.to(torch.float64 if xdt == torch.float32 else torch.int64)
    elif bad == "x rank":
        x = x.reshape(-1)
    elif bad == "delta shape":
        rd = torch.ones((8,))
    elif bad == "delta dtype":
        rd = rd.double()
    else:
        x = torch.zeros((8, 1024), dtype=xdt)[:, ::2]
    with pytest.raises(ValueError):
        ROW_WRAPPERS[name](x, rd)


@pytest.mark.parametrize("bad", ["codes dtype", "delta shape",
                                 "delta dtype", "codes strided"])
def test_dequantize_wrapper_raises_on_dtype_and_shape(card_tensors, bad):
    codes, delta = torch.zeros((3, 5), dtype=torch.int32), torch.ones(())
    if bad == "codes dtype":
        codes = codes.to(torch.int16)
    elif bad == "delta shape":
        delta = torch.ones(1)
    elif bad == "delta dtype":
        delta = delta.double()
    else:
        codes = torch.zeros((3, 10), dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError):
        Q.dequantize_cuda(codes, delta)


# -- (d) the plain versions against the Pallas kernels -------------------------

def edge_rows(rows, cols, bits, seed, zero=False):
    """``([rows, cols] fp32, [rows, 1] Δ)`` as ``chip_smoke.edge_rows``
    makes them, from a numpy seed: Δ from each row's absmax; on rows 1,
    4, 7, ... Δ a power of two and every third column on an exact
    half-step ``(k + 1/2)·Δ`` over the whole code range; on rows 2, 5,
    8, ... Δ a quarter of that, so codes beyond ±qmax clip."""
    if zero:
        return (np.zeros((rows, cols), np.float32),
                np.full((rows, 1), TINY, np.float32))
    rng = np.random.default_rng(seed)
    qm = (1 << (bits - 1)) - 1
    x = (rng.standard_normal((rows, cols)) * 3).astype(np.float32)
    delta = np.maximum(np.abs(x).max(1, keepdims=True) / np.float32(qm),
                       TINY).astype(np.float32)
    delta[1::3] = np.exp2(np.floor(np.log2(delta[1::3])))
    k = rng.integers(-qm - 1, qm + 1, (rows, cols)).astype(np.float32)
    x[1::3, ::3] = ((k + np.float32(0.5)) * delta)[1::3, ::3]
    delta[2::3] /= np.float32(4)
    return x, delta


def at_offset(a, off):
    """``a`` as a torch view whose first element lies ``off`` elements
    into its storage."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    buf = torch.zeros(t.numel() + off, dtype=t.dtype)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    assert view.storage_offset() == off and view.is_contiguous()
    return view


def _same(t, j):
    a, b = t.numpy(), np.asarray(j)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


ROW_CASES = [(257, 510, 16, 0), (257, 10, 16, 0), (1, 512, 16, 0),
             (1, 10, 16, 0), (70000, 8, 16, 0), (257, 512, 16, 1),
             (257, 512, 16, 2), (257, 512, 16, 3), (257, 512, 8, 0),
             (257, 512, 4, 0), (33, 33, 4, 1)]


@pytest.mark.parametrize("rows,cols,bits,off", ROW_CASES,
                         ids=[f"{r}x{c}-int{b}-off{o}"
                              for r, c, b, o in ROW_CASES])
def test_row_codec_plain_versions_match_pallas(rows, cols, bits, off):
    x, delta = edge_rows(rows, cols, bits, seed=rows + cols + bits)
    tx, td = at_offset(x, off), torch.from_numpy(delta)
    codes = tref.quantize_rows_ref(tx, td, bits=bits)
    _same(codes, quantize_rows_pallas(x, delta, bits=bits, interpret=True))
    _same(tref.quantize_dequantize_rows_ref(tx, td, bits=bits),
          quantize_dequantize_rows_pallas(x, delta, bits=bits,
                                          interpret=True))
    tc = at_offset(codes.numpy(), off)
    _same(tref.dequantize_rows_ref(tc, td),
          dequantize_rows_pallas(codes.numpy(), delta, interpret=True))
    qm = (1 << (bits - 1)) - 1
    c = codes.numpy()
    assert c.min() >= -qm - 1 and c.max() <= qm
    if rows >= 3 and cols >= 4:
        assert c[2].min() == -qm - 1 or c[2].max() == qm   # a clipped row
        # the half-steps round up: floor(k + 1/2 + 1/2) = k + 1, clipped
        k = np.floor(x[1, ::3] / delta[1, 0]).astype(np.int64)
        np.testing.assert_array_equal(c[1, ::3], np.minimum(k + 1, qm))


def test_row_codec_plain_versions_match_pallas_on_zeros():
    x, delta = edge_rows(9, 512, 16, seed=0, zero=True)
    codes = tref.quantize_rows_ref(torch.from_numpy(x),
                                   torch.from_numpy(delta))
    assert not codes.any()
    _same(codes, quantize_rows_pallas(x, delta, interpret=True))
    _same(tref.quantize_dequantize_rows_ref(torch.from_numpy(x),
                                            torch.from_numpy(delta)),
          quantize_dequantize_rows_pallas(x, delta, interpret=True))
    _same(tref.dequantize_rows_ref(codes, torch.from_numpy(delta)),
          dequantize_rows_pallas(codes.numpy(), delta, interpret=True))


@pytest.mark.parametrize("n,off", [(n, 0) for n in range(1, 8)]
                         + [(100003, o) for o in (1, 2, 3)] + [(5, 3)])
def test_dequantize_plain_version_matches_pallas(n, off):
    rng = np.random.default_rng(n + off)
    codes = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    codes[0] = 0
    delta = np.float32(rng.random() * 1e-4)
    got = tref.dequantize_ref(at_offset(codes, off), torch.tensor(delta))
    _same(got, np.asarray(dequantize_pallas(codes.reshape(1, n), delta,
                                            interpret=True)).reshape(n))


def test_dequantize_plain_version_matches_pallas_on_zeros():
    codes = np.zeros((3, 512), np.int32)
    got = tref.dequantize_ref(torch.from_numpy(codes), torch.tensor(0.25))
    assert not got.any()
    _same(got, dequantize_pallas(codes, np.float32(0.25), interpret=True))


# -- (e) the slice: the codec's ops on offset views ----------------------------

@pytest.mark.parametrize("off", [1, 3])
def test_codec_ops_on_offset_views_match_pallas(off):
    """The ops that dispatch to the four kernels, on CPU views at a
    storage offset (the wrappers would get such views' contiguous
    copies or the views themselves), against the Pallas kernels."""
    x, delta = edge_rows(40, 510, 16, seed=off)
    tx, td = at_offset(x, off), torch.from_numpy(delta)
    codes = tqops.quantize_rows(tx, td, bits=16)
    _same(codes, quantize_rows_pallas(x, delta, interpret=True))
    _same(tqops.quantize_dequantize_rows(tx, td, bits=16),
          quantize_dequantize_rows_pallas(x, delta, interpret=True))
    _same(tqops.dequantize_rows(at_offset(codes.numpy(), off), td),
          dequantize_rows_pallas(codes.numpy(), delta, interpret=True))
    flat = at_offset(codes.numpy().reshape(-1), off)
    d = torch.tensor(delta[0, 0])
    _same(tqops.dequantize(flat, d),
          np.asarray(dequantize_pallas(codes.numpy(), delta[0, 0],
                                       interpret=True)).reshape(-1))
