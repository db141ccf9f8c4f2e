"""The Hopper redesign of ``proto_dist`` and of the row absmax (``rowabs``,
``rowabs_sum``), held on the CPU where it can be: their launch plans, the
wrappers' limits, and the plain versions against the Pallas kernels they
replace.  A CPU test holds the plans and the plain versions, not the
``.cu`` file: where a test replays a kernel's index arithmetic it checks
that replay, and that the CUDA kernels agree with their plain versions
(``rowabs`` and ``rowabs_sum`` bit for bit, ``proto_dist`` within
``PD_RTOL`` + ``pd_atol``, its argmin away from ties) is held on the card
only (``chip_smoke.py`` phase 3: the paths' shapes, ``absmax_cases`` and
``PD_EDGE``).

* ``proto_dist_plan`` for N in {1, 31, 640, 1001, 70000}, C in {1, 10,
  37, 100}, P in {1, 3, 128, 200, 256, 2048}, fp32 and bf16, aligned or
  not: every output written by exactly one lane (rows by exactly one warp
  of one row tile, prototypes by exactly one even lane of one column
  tile), every element of P folded by exactly one lane of one chunk, 16-
  byte vectors exactly where P is a multiple of the vector and the bases
  are aligned, the staged chunk within 48 KB, the block and grid within
  the card's limits, the fewest rows a warp that keep each SM's reads of
  prototype rows within ``PD_SMEM_READS``, and the most warps a block
  that keep the grid at ``PD_MIN_BLOCKS``.
* ``absmax_plan`` for rows in {1, 5, 8320, 600000} and cols in {1, 3,
  10, 510, 512, 8192}, aligned or not: ``rows_plan`` cut to one warp
  across a row, every row reduced by exactly one warp (a row stride
  beyond 65,535 row tiles), every column of it by exactly one lane of one
  step.
* The three wrappers raise on CPU tensors, wrong dtypes and wrong shapes.
* ``rowabs_ref`` and ``rowabs_sum_ref`` against ``rowabs_pallas`` and
  ``rowabs_sum_pallas`` in interpret mode, bit for bit, at odd cols, one
  row, views at storage offsets 1-3, all zeros and rows zero but for one
  element.  At decay 0.9 XLA:CPU fuses the interpret kernel's ``x +
  decay·res`` into one FMA where the plain version (and eager ``repro``)
  rounds the product first, so there the plain version is held bit for
  bit to eager ``repro`` and the interpret kernel bit for bit to the
  fused arithmetic (as ``tests/test_torch_kernels.py`` does).
* ``proto_dist_expand`` against ``proto_dist_pallas`` in interpret mode
  within ``chip_smoke.py``'s tolerance (``PD_RTOL`` 1e-4 plus ``1e-5·(max
  ||x||² + max ||p||²)``), argmin equal away from ties: C = 1, P = 3, one
  row, bf16, Eq. 5's ``[640, 128] × [10, 128]``.  Inputs from a numpy
  seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.proto_dist.proto_dist import proto_dist_pallas
from repro.kernels.quantize.quantize import rowabs_pallas, rowabs_sum_pallas
from repro_torch.kernels.proto_dist import proto_dist as PD
from repro_torch.kernels.proto_dist.ref import (proto_dist_expand,
                                                proto_dist_ref)
from repro_torch.kernels.quantize import quantize as Q
from repro_torch.kernels.quantize import ref as tref

torch.set_num_threads(2)

NS = (1, 31, 640, 1001, 70000)
CS = (1, 10, 37, 100)
PS = (1, 3, 128, 200, 256, 2048)
DTYPES = (torch.float32, torch.bfloat16)
ROWS = (1, 5, 8320, 600000)
COLS = (1, 3, 10, 510, 512, 8192)
PD_RTOL = 1e-4      # chip_smoke.PD_RTOL


def _once(idx, n):
    return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


# -- (a) proto_dist's launch plan ----------------------------------------------

def pd_plan_indices(plan, n, c, p):
    """What the plan's lanes write and fold, axis by axis: the rows of
    each warp of each row tile (``(blockIdx.x · warps + warp) · warp_rows
    + q``, ``q < warp_rows``), the prototypes of each even lane of each
    column tile (``blockIdx.y · col_tile + (lane >> 1)``, below the
    tile's count), and the elements of P of each lane of each chunk (``ch
    · 256 + (v · 32 + lane) · vec + j``, below P)."""
    gx, gy = plan.grid
    warp = (np.arange(gx)[:, None] * plan.warps
            + np.arange(plan.warps)[None]).ravel()
    row = (warp[:, None] * plan.warp_rows
           + np.arange(plan.warp_rows)[None]).ravel()
    row = row[row < n]
    lane = np.arange(0, 32, 2)
    col0 = np.arange(gy) * plan.col_tile
    ct = np.minimum(plan.col_tile, c - col0)
    cc = lane >> 1
    keep = cc[None] < ct[:, None]
    col = (col0[:, None] + cc[None])[keep]
    per_lane = PD.PD_CHUNK // (32 * plan.vec)
    ch, v, ln, j = np.meshgrid(np.arange(plan.chunks), np.arange(per_lane),
                               np.arange(32), np.arange(plan.vec),
                               indexing="ij")
    elem = (ch * PD.PD_CHUNK + (v * 32 + ln) * plan.vec + j).ravel()
    return row, col, elem[elem < p]


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("n", NS)
def test_proto_dist_plan_covers_each_output_once(n, c, p):
    for dtype in DTYPES:
        for aligned in (True, False):
            plan = PD.proto_dist_plan(n, c, p, dtype, aligned)
            what = (n, c, p, dtype, aligned, plan)
            wide = 8 if dtype == torch.bfloat16 else 4
            assert plan.vec == (wide if aligned and p % wide == 0 else 1), \
                what
            assert plan.warps in PD.PD_WARPS, what
            assert plan.warp_rows in PD.PD_WARP_ROWS, what
            assert 32 * plan.warps <= 1024, what
            rows = plan.warps * plan.warp_rows      # a block's
            gx, gy = plan.grid
            assert 1 <= gx <= 2 ** 31 - 1 and 1 <= gy <= PD.MAX_GRID_Y, what
            assert (gx - 1) * rows < n <= gx * rows, what
            # the fewest column tiles of at most 16, as even as can be
            assert gy == -(-c // PD.PD_COL_TILE), what
            assert 1 <= plan.col_tile <= PD.PD_COL_TILE, what
            assert (gy - 1) * plan.col_tile < c <= gy * plan.col_tile, what
            assert plan.chunks == -(-p // PD.PD_CHUNK), what
            size = 2 if dtype == torch.bfloat16 else 4
            assert plan.smem == ((2 if p > PD.PD_CHUNK else 1)
                                 * (rows + plan.col_tile)
                                 * PD.PD_CHUNK * size), what
            assert plan.smem <= PD.PD_SMEM_MAX, what
            # the fewest rows a warp that keep each SM's reads of
            # prototype rows within PD_SMEM_READS, unless 4 warps' staged
            # chunk would overflow
            reads = n * c * p * size / PD.SMS
            rw = plan.warp_rows
            assert rw == 1 or reads / (rw // 2) > PD.PD_SMEM_READS, what
            assert (reads / rw <= PD.PD_SMEM_READS or rw == 4
                    or PD.proto_dist_smem(8 * rw, plan.col_tile, p, dtype)
                    > PD.PD_SMEM_MAX), what
            # the most warps a block that keep PD_MIN_BLOCKS blocks and fit
            fits = [w for w in PD.PD_WARPS
                    if -(-n // (w * rw)) * gy >= PD.PD_MIN_BLOCKS
                    and PD.proto_dist_smem(w * rw, plan.col_tile, p, dtype)
                    <= PD.PD_SMEM_MAX]
            assert plan.warps == (fits[0] if fits else 4), what
            row, col, elem = pd_plan_indices(plan, n, c, p)
            assert _once(row, n) and _once(col, c), what
            assert _once(elem, p) if p else elem.size == 0, what


def test_proto_dist_plan_at_the_paths_shapes_and_limits():
    f32, bf16 = torch.float32, torch.bfloat16
    # Eq. 5 at mnist-cnn and the ResNet8 student: 160 blocks of 4 warps
    # of one row, one tile of 10, one chunk
    for p in (128, 256):
        for dtype, vec in ((f32, 4), (bf16, 8)):
            plan = PD.proto_dist_plan(640, 10, p, dtype, True)
            assert (plan.vec, plan.warps, plan.warp_rows, plan.col_tile,
                    plan.chunks, plan.grid) == (vec, 4, 1, 10, 1, (160, 1))
    # C = 100: seven tiles of 15; four rows a warp in fp32, two in bf16
    plan = PD.proto_dist_plan(640, 100, 256, f32, True)
    assert (plan.warps, plan.warp_rows, plan.col_tile, plan.grid) == (
        4, 4, 15, (40, 7))
    plan = PD.proto_dist_plan(640, 100, 256, bf16, True)
    assert (plan.warps, plan.warp_rows, plan.grid) == (8, 2, (40, 7))
    # P beyond a chunk: two buffers, so fp32 takes two rows a warp, not 4
    plan = PD.proto_dist_plan(640, 100, 2048, f32, True)
    assert (plan.chunks, plan.warps, plan.warp_rows) == (8, 4, 2)
    assert plan.smem == 2 * (8 + 15) * 256 * 4
    assert PD.proto_dist_plan(640, 10, 130, f32, True).vec == 1
    assert PD.proto_dist_plan(640, 10, 132, bf16, True).vec == 1
    assert PD.proto_dist_plan(640, 10, 128, f32, False).vec == 1
    for bad in ((0, 10, 8), (5, 0, 8), (5, 10, -1)):
        with pytest.raises(ValueError):
            PD.proto_dist_plan(*bad, f32, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PD.proto_dist_plan(5, 10, 8, torch.float16, True)
    with pytest.raises(ValueError, match="column tiles"):
        PD.proto_dist_plan(5, 16 * 65535 + 1, 8, f32, True)


# -- (b) the row absmax's launch plan ------------------------------------------

def absmax_indices(plan, rows, cols):
    """What the plan's warps reduce: the rows of each warp (``blockIdx.y ·
    8 + threadIdx.y``, then a stride of ``grid_y · 8``) and the columns
    of each lane of each step (``lane · vec + s · 32 · ROW_UNROLL · vec +
    k · 32 · vec + j``, below cols)."""
    bx, by = plan.block
    threads = plan.grid[1] * by
    row = (np.arange(threads)[:, None]
           + threads * np.arange(-(-rows // threads))[None]).ravel()
    row = row[row < rows]
    step = 32 * Q.ROW_UNROLL * plan.vec
    s, ln, k, j = np.meshgrid(np.arange(plan.steps), np.arange(32),
                              np.arange(Q.ROW_UNROLL), np.arange(plan.vec),
                              indexing="ij")
    col = (ln * plan.vec + s * step + k * 32 * plan.vec + j).ravel()
    return row, col[col < cols]


@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("rows", ROWS)
def test_absmax_plan_reduces_each_row_once(rows, cols):
    for aligned in (True, False):
        plan = Q.absmax_plan(rows, cols, aligned)
        what = (rows, cols, aligned, plan)
        assert isinstance(plan, Q.RowsPlan), what
        vec = 4 if aligned and cols % 4 == 0 else 1
        step = 32 * Q.ROW_UNROLL * vec
        # rows_plan, cut to one step of a row: one warp across it
        base = Q.rows_plan(rows, min(cols, step), vec == 4)
        assert (plan.vec, plan.block, plan.grid, plan.rows_a_thread) == (
            base.vec, base.block, base.grid, base.rows_a_thread), what
        assert plan.vec == vec and plan.block == (32, 8), what
        assert plan.grid == (1, min(-(-rows // 8), Q.MAX_GRID_YZ)), what
        assert (plan.grid[1] - 1) * 8 < rows, what
        assert plan.steps == -(-cols // step), what
        row, col = absmax_indices(plan, rows, cols)
        assert _once(row, rows) and _once(col, cols), what


def test_absmax_plan_at_the_paths_shapes_and_limits():
    for rows in (8320, 8240, 4184):
        plan = Q.absmax_plan(rows, 512, True)
        assert (plan.vec, plan.block, plan.steps) == (4, (32, 8), 1)
        assert plan.grid == (1, -(-rows // 8)) and plan.rows_a_thread == 1
    assert Q.absmax_plan(600000, 8, True).rows_a_thread == 2
    assert Q.absmax_plan(5, 8192, True).steps == 16
    assert Q.absmax_plan(5, 8192, False).steps == 64
    for bad in ((0, 512), (5, 0)):
        with pytest.raises(ValueError, match="absmax_plan"):
            Q.absmax_plan(*bad, True)


# -- (c) the wrappers' limits -------------------------------------------------

@pytest.fixture
def card_tensors(monkeypatch):
    """CPU tensors that pass the wrappers' device check, so their dtype
    and shape checks can be reached (each raises before any launch)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))


def test_wrappers_raise_on_cpu_tensors():
    x = torch.zeros((8, 512))
    for call in (lambda: Q.rowabs_cuda(x),
                 lambda: Q.rowabs_sum_cuda(x, x, 1.0),
                 lambda: PD.proto_dist_cuda(x, x[:3])):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("bad", ["x dtype", "x rank", "x strided",
                                 "res shape", "res dtype", "res strided"])
def test_absmax_wrappers_raise_on_dtype_and_shape(card_tensors, bad):
    x, res = torch.zeros((8, 512)), torch.zeros((8, 512))
    if bad == "x dtype":
        x = x.double()
    elif bad == "x rank":
        x = x.reshape(-1)
    elif bad == "x strided":
        x = torch.zeros((8, 1024))[:, ::2]
    elif bad == "res shape":
        res = torch.zeros((8, 510))
    elif bad == "res dtype":
        res = res.double()
    else:
        res = torch.zeros((8, 1024))[:, ::2]
    with pytest.raises(ValueError):
        Q.rowabs_sum_cuda(x, res, 0.9)
    if bad.startswith("x"):
        with pytest.raises(ValueError):
            Q.rowabs_cuda(x)


@pytest.mark.parametrize("bad", ["x dtype", "mixed dtypes", "P differs",
                                 "x rank", "x strided", "protos strided"])
def test_proto_dist_wrapper_raises_on_dtype_and_shape(card_tensors, bad):
    x, protos = torch.zeros((64, 128)), torch.zeros((10, 128))
    if bad == "x dtype":
        x, protos = x.half(), protos.half()
    elif bad == "mixed dtypes":
        protos = protos.bfloat16()
    elif bad == "P differs":
        protos = torch.zeros((10, 130))
    elif bad == "x rank":
        x = x.reshape(-1)
    elif bad == "x strided":
        x = torch.zeros((64, 256))[:, ::2]
    else:
        protos = torch.zeros((10, 256))[:, ::2]
    with pytest.raises(ValueError):
        PD.proto_dist_cuda(x, protos)


# -- (d) the plain versions against the Pallas kernels -------------------------

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


def absmax_rows(rows, cols, seed, kind="random"):
    """``(x, res)`` fp32 from a numpy seed: random rows (a residual of
    half a 16-bit step), all zeros, or each row zero but for one element
    of either sign (and a residual zero but for one other element)."""
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return (np.zeros((rows, cols), np.float32),) * 2
    if kind == "lone":
        x = np.zeros((rows, cols), np.float32)
        res = np.zeros((rows, cols), np.float32)
        r = np.arange(rows)
        x[r, rng.integers(0, cols, rows)] = rng.standard_normal(rows) * 3
        res[r, rng.integers(0, cols, rows)] = rng.standard_normal(rows)
        return x, res
    x = (rng.standard_normal((rows, cols)) * 3).astype(np.float32)
    scale = np.abs(x).max() / np.float32(32767)
    res = ((rng.random((rows, cols)) - 0.5) * scale).astype(np.float32)
    return x, res


def _fma_absmax(x, res, decay):
    """The interpret-mode ``rowabs_sum`` arithmetic at a decay whose
    product is inexact: ``x + decay·res`` as one FMA, emulated in float64
    (the product is exact there) and rounded once to fp32."""
    eff = (x.astype(np.float64)
           + np.float64(np.float32(decay)) * res).astype(np.float32)
    return np.abs(eff).max(1, keepdims=True)


ABS_CASES = [(257, 510, 0, "random"), (33, 3, 0, "random"),
             (1, 512, 0, "random"), (1, 10, 0, "random"),
             (257, 512, 1, "random"), (257, 512, 2, "random"),
             (257, 512, 3, "random"), (64, 512, 0, "zeros"),
             (64, 510, 1, "lone"), (300, 8192, 0, "random")]


@pytest.mark.parametrize("rows,cols,off,kind", ABS_CASES,
                         ids=[f"{r}x{c}-off{o}-{k}"
                              for r, c, o, k in ABS_CASES])
def test_row_absmax_plain_versions_match_pallas(rows, cols, off, kind):
    x, res = absmax_rows(rows, cols, seed=rows + cols + off, kind=kind)
    tx, tres = at_offset(x, off), at_offset(res, (off + 1) % 4)
    amax = tref.rowabs_ref(tx)
    _same(amax, rowabs_pallas(x, interpret=True))
    if kind == "lone":          # each row's one element, either sign
        np.testing.assert_array_equal(amax.numpy()[:, 0],
                                      np.abs(x).sum(1))
    for decay in (1.0, 0.9):
        got = tref.rowabs_sum_ref(tx, tres, torch.tensor(decay))
        jax_kernel = rowabs_sum_pallas(x, res, decay=decay, interpret=True)
        if decay == 1.0:        # 1·res is exact: no fused rounding differs
            _same(got, jax_kernel)
        else:
            eager = jnp.max(jnp.abs(jnp.asarray(x) + jnp.float32(decay)
                                    * jnp.asarray(res)), axis=1,
                            keepdims=True)
            _same(got, eager)
            _same(torch.from_numpy(_fma_absmax(x, res, decay)), jax_kernel)
    if kind == "zeros":
        assert not amax.any() and not got.any()


def pd_atol(x, protos):
    """``chip_smoke.pd_atol``: 1e-5 of max ||x||² + max ||p||²."""
    return 1e-5 * (float(x.float().square().sum(-1).max())
                   + float(protos.float().square().sum(-1).max()))


PD_CASES = [(640, 10, 128, "float32"), (640, 1, 128, "float32"),
            (128, 10, 3, "float32"), (1, 10, 128, "float32"),
            (640, 10, 128, "bfloat16"), (1, 1, 3, "bfloat16"),
            (256, 37, 200, "bfloat16")]


@pytest.mark.parametrize("n,c,p,dtype", PD_CASES,
                         ids=[f"{n}x{c}x{p}-{d}" for n, c, p, d in PD_CASES])
def test_proto_dist_plain_version_matches_pallas(n, c, p, dtype):
    rng = np.random.default_rng(n * 100 + c + p)
    tx = torch.from_numpy(rng.standard_normal((n, p)).astype(np.float32))
    tp = torch.from_numpy(rng.standard_normal((c, p)).astype(np.float32))
    tx, tp = tx.to(getattr(torch, dtype)), tp.to(getattr(torch, dtype))
    # the same (bf16-representable) values on both sides
    jx = jnp.asarray(tx.float().numpy()).astype(dtype)
    jp = jnp.asarray(tp.float().numpy()).astype(dtype)
    got = proto_dist_expand(tx, tp)
    want = np.asarray(proto_dist_pallas(jx, jp, interpret=True))
    direct = proto_dist_ref(tx, tp).numpy()
    atol = pd_atol(tx, tp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=PD_RTOL, atol=atol)
    np.testing.assert_allclose(got.numpy(), direct, rtol=PD_RTOL, atol=atol)
    assert bool((got >= 0).all())
    # the argmin away from near-ties (gaps over twice the tolerance)
    if c > 1:
        top2 = np.sort(direct, axis=-1)[:, :2]
        tol = atol + PD_RTOL * float(np.abs(direct).max())
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
        assert clear.any()
        np.testing.assert_array_equal(got.numpy().argmin(-1)[clear],
                                      want.argmin(-1)[clear])
