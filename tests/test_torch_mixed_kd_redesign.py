"""The Hopper redesign of ``quantize_rows_mixed`` (the row codec's body with
a per-row qmax) and of ``kd_loss`` (three designs picked by ``kd_plan``),
held on the CPU where it can be: the launch plans, the C entry points'
argument lists, the wrappers' limits, and the mixed-width plain version
against the Pallas kernel it replaces.  A CPU test holds the plans and the
plain versions, not the ``.cu`` files: where a test replays a kernel's
index arithmetic it checks that replay.  That the CUDA kernels agree with
their plain versions (the codes bit for bit, the KD loss within
``kd_tol``) is held on the card only (``chip_smoke.py`` phase 3:
``row_codec_cases(torch, "quantize_rows_mixed")`` and ``KD_EDGE``); the
KD kernel's algorithm is modelled in numpy by
``tests/test_torch_proto_kd.py::test_kernel_online_algorithm_matches_rows_ref``.

* ``kd_plan`` over rows in {1, 5, 16, 131, 132, 256, 70000} and V in {1,
  7, 10, 13, 256, 257, 1001, 50280, 202048}, fp32 and bf16, aligned or
  not: segments up to V = 256 (every row by one segment of one block,
  every logit by one lane, at most ``KD_LANE_ELEMS`` a lane, no block
  empty), else a block or a cluster a row (every vector of a row by one
  split, one thread and one tile of that thread's walk, the last tile
  masked), 16-byte vectors exactly where aligned and V a whole number of
  them, clusters of at most ``KD_MAX_SPLITS`` only below one row an SM;
  the regimes at the cases ``chip_smoke.py`` times; raises on empty,
  oversize and odd-width inputs.
* The mixed wrapper launches ``quantize_rows_mixed`` with ``rows_plan``'s
  plan and the qmax column's address where ``quantize_rows`` passes its
  scalar qmax; the KD wrapper launches with ``kd_plan``'s plan and the
  log2-domain scale; both argument lists match ``build.SIGNATURES`` and
  the ``extern "C"`` declarations.
* The two wrappers raise on CPU tensors, wrong dtypes and wrong shapes.
* ``quantize_rows_mixed_ref`` against ``quantize_rows_mixed_pallas`` in
  interpret mode, bit for bit, at rows of 4, 8 and 16 bits in runs of
  three, exact half-steps, codes beyond ±qmax, odd cols, one row, 70,000
  rows of 8, views at storage offsets 1-3 and all zeros at the least
  normal Δ; inputs from a numpy seed.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro.kernels.quantize.quantize import quantize_rows_mixed_pallas
from repro_torch.kernels import build
from repro_torch.kernels.kd_loss import kd_loss as KD
from repro_torch.kernels.quantize import quantize as Q
from repro_torch.kernels.quantize import ref as tref

torch.set_num_threads(2)

ROWS = (1, 5, 16, 131, 132, 256, 70000)
VS = (1, 7, 10, 13, 256, 257, 1001, 50280, 202048)
TINY = np.finfo(np.float32).tiny


# -- (a) kd_plan --------------------------------------------------------------

def _once(idx, n):
    return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


def segments_cover(plan, rows, v):
    """The rows each segment of each block takes (block · threads/lanes +
    thread / lanes, below rows) and the logits each lane of a segment
    holds (q + k·lanes, k < span, below V)."""
    per_block = plan.threads // plan.lanes
    row = np.arange(plan.grid * per_block)
    assert (plan.grid - 1) * per_block < rows <= plan.grid * per_block
    q, k = np.meshgrid(np.arange(plan.lanes), np.arange(plan.span))
    elem = (q + k * plan.lanes).ravel()
    return row[row < rows], elem[elem < v]


def rows_walk(plan, nvec):
    """The vectors of a row each block of its cluster takes, in the
    kernel's walk: split k over [k·span, min(nvec, (k+1)·span)); thread x
    whole tiles while its last vector is in range, then one masked tile.
    Returns every vector visited and the masked tiles' sizes."""
    per, step = KD.tile_loads(plan.vec), plan.threads
    seen, masked = [], []
    for k in range(plan.splits):
        lo, hi = k * plan.span, min(nvec, (k + 1) * plan.span)
        i = lo + np.arange(step)
        while True:
            full = i + (per - 1) * step < hi
            if not full.any():
                break
            seen.append((i[full][:, None] + step * np.arange(per)).ravel())
            i = np.where(full, i + per * step, i)
            if not full.all():
                i = i[~full]
                break
        tail = (i[:, None] + step * np.arange(per))
        tail = tail[(i < hi)]
        if tail.size:
            keep = tail < hi
            assert (keep.sum(1) < per).all()      # a masked tile is partial
            seen.append(tail[keep])
            masked.append(keep.sum(1))
    return np.concatenate(seen) if seen else np.zeros(0, int), masked


@pytest.mark.parametrize("v", VS)
@pytest.mark.parametrize("rows", ROWS)
def test_kd_plan_reads_every_logit_once(rows, v):
    for elem_bytes in (4, 2):
        for aligned in (True, False):
            plan = KD.kd_plan(rows, v, elem_bytes, aligned)
            what = (rows, v, elem_bytes, aligned, plan)
            assert plan.design in KD.DESIGNS and plan.grid <= KD.MAX_GRID
            assert plan.threads % 32 == 0, what
            if v <= KD.KD_SMALL_V:
                assert plan.design == "segments", what
                assert plan.vec == 1 and plan.splits == 1, what
                assert plan.lanes in (1, 2, 4, 8, 16, 32), what
                assert plan.lanes * KD.KD_LANE_ELEMS >= v, what
                assert plan.lanes == 1 or (plan.lanes // 2
                                           * KD.KD_LANE_ELEMS < v), what
                assert plan.span == -(-v // plan.lanes) <= KD.KD_LANE_ELEMS
                assert 32 <= plan.threads <= KD.KD_SEG_THREADS, what
                row, elem = segments_cover(plan, rows, v)
                assert _once(row, rows) and _once(elem, v), what
                continue
            wide = 16 // elem_bytes
            assert plan.vec == (wide if aligned and v % wide == 0 else 1)
            assert plan.lanes == 0 and 32 <= plan.threads <= KD.KD_THREADS
            assert plan.threads & (plan.threads - 1) == 0, what
            nvec = v // plan.vec
            tile = plan.threads * KD.tile_loads(plan.vec)
            # the fewest threads whose tile holds the row, up to the cap
            assert (plan.threads == KD.KD_THREADS or plan.threads == 32
                    or (plan.threads // 2) * KD.tile_loads(plan.vec) < nvec)
            assert 1 <= plan.splits <= KD.KD_MAX_SPLITS, what
            assert (plan.design == "clusters") == (plan.splits > 1), what
            if rows >= KD.H100_SMS:
                assert plan.splits == 1, what
            else:
                assert plan.splits == min(KD.KD_MAX_SPLITS,
                                          -(-KD.H100_SMS // rows),
                                          -(-nvec // tile)), what
            assert plan.grid == rows * plan.splits, what
            assert (plan.splits - 1) * plan.span < nvec <= (plan.splits
                                                            * plan.span)
            seen, _ = rows_walk(plan, nvec)
            assert _once(seen, nvec), what
            assert plan.vec == 1 or v % plan.vec == 0, what


def test_kd_plan_regimes_at_the_timed_cases():
    P = KD.kd_plan
    assert P(320, 10, 4, True) == KD.KdPlan("segments", 1, 32, 2, 1, 5, 20)
    lm16, lm32 = P(256, 202048, 2, True), P(256, 202048, 4, True)
    assert (lm16.design, lm16.vec, lm16.threads, lm16.grid) == (
        "blocks", 8, 512, 256)
    assert (lm32.design, lm32.vec, lm32.grid) == ("blocks", 4, 256)
    ragged = P(250, 50280, 2, True)
    assert (ragged.design, ragged.vec, ragged.grid) == ("blocks", 8, 250)
    for rows in (1, 16):
        split = P(rows, 202048, 2, True)
        assert (split.design, split.splits, split.grid) == (
            "clusters", 8, 8 * rows)
    # off 16 bytes, or V not a whole number of vectors: one logit a load
    assert P(250, 50280, 2, False).vec == 1
    assert P(320, 1001, 4, True).vec == 1 and P(320, 1001, 2, True).vec == 1
    assert P(64, 50280, 4, False).splits == 3
    # a card with fewer SMs splits below its own count
    assert P(120, 50280, 2, True, sms=114).design == "blocks"
    assert P(120, 50280, 2, True).design == "clusters"
    # a row of one tile is never split
    assert P(1, 300, 4, True).design == "blocks"


@pytest.mark.parametrize("bad", [(0, 10, 4), (10, 0, 4), (10, 10, 8),
                                 (10, 2 ** 31, 4), (2 ** 31, 1000, 4)])
def test_kd_plan_raises(bad):
    with pytest.raises(ValueError):
        KD.kd_plan(*bad, True)


# -- (b) the C entry points' arguments ----------------------------------------

def _declared_args(name, src):
    text = (build.CSRC / src).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, name
    return [a.strip() for a in m.group(1).split(",")]


def test_signatures_of_the_two_entry_points():
    P, I64, I32, F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
    assert build.SIGNATURES["quantize_rows_mixed"] == (
        (P, P, P, I64, I32, P) + (I32,) * 5 + (P,))
    assert build.SIGNATURES["kd_loss_rows"] == (
        (P,) * 3 + (I64, I64, F32, F32) + (I32,) * 6 + (I64, I64, P))
    # the mixed entry takes quantize_rows' arguments, the qmax column's
    # address where quantize_rows takes its scalar qmax
    mixed = _declared_args("quantize_rows_mixed", "quantize.cu")
    uniform = _declared_args("quantize_rows", "quantize.cu")
    assert len(mixed) == len(uniform) == 12
    assert mixed[5] == "const float* row_qmax" and uniform[5] == "float qmax"
    assert mixed[:5] == uniform[:5] and mixed[6:] == uniform[6:]
    kd = _declared_args("kd_loss_rows", "kd_loss.cu")
    assert len(kd) == len(build.SIGNATURES["kd_loss_rows"]) == 16
    assert [a.split()[-1] for a in kd[8:15]] == [
        "design", "vec", "threads", "lanes", "splits", "span", "grid"]
    src = (build.CSRC / "quantize.cu").read_text()
    assert "quantize_rows_mixed_kernel" not in src


class _Recorder:
    """A stand-in for the kernel library: records each entry point's
    arguments and returns 0, as a launch that succeeded."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def card_tensors(monkeypatch):
    """CPU tensors that pass the wrappers' device check; the library and
    the stream replaced, so a wrapper's launch can be read."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))
    rec = _Recorder()
    for mod in (Q, KD):
        monkeypatch.setattr(mod, "library", lambda: rec)
        monkeypatch.setattr(mod, "stream_of", lambda t: 7)
    monkeypatch.setattr(KD, "_sm_count", lambda index: KD.H100_SMS)
    return rec


def _at(shape, off, dtype=torch.float32):
    buf = torch.zeros(int(np.prod(shape)) + off, dtype=dtype)
    return buf[off:].view(shape)


@pytest.mark.parametrize("rows,cols,off", [
    (8320, 512, 0), (8320, 512, 1), (416, 512, 2), (257, 510, 0),
    (257, 10, 0), (1, 512, 0), (600000, 8, 0), (70000, 8, 3)])
def test_mixed_wrapper_launches_the_row_codec_plan(card_tensors, rows, cols,
                                                   off):
    x = _at((rows, cols), off)
    rd, qm = torch.ones((rows, 1)), torch.full((rows, 1), 7.0)
    before = Q.QUANTIZE_ROWS_MIXED_LAUNCHES.count
    codes = Q.quantize_rows_mixed_cuda(x, rd, qm)
    assert Q.QUANTIZE_ROWS_MIXED_LAUNCHES.count == before + 1
    [(name, args)] = card_tensors.calls
    assert name == "quantize_rows_mixed"
    assert len(args) == len(build.SIGNATURES[name])
    plan = Q.rows_plan(rows, cols, x.data_ptr() % 16 == 0
                       and codes.data_ptr() % 16 == 0)
    assert args == (x.data_ptr(), rd.data_ptr(), codes.data_ptr(), rows,
                    cols, qm.data_ptr(), plan.vec, *plan.block, *plan.grid,
                    7)
    assert plan.vec == (4 if off == 0 and cols % 4 == 0 else 1)
    assert codes.dtype == torch.int32 and tuple(codes.shape) == (rows, cols)
    if (rows, cols) == (8320, 512) and off == 0:   # the 4/16 path's payload
        assert plan == Q.RowsPlan(4, (32, 8), (1, 1040), 1)


@pytest.mark.parametrize("rows,v,dtype,off,temp", [
    (320, 10, torch.float32, 0, 3.0), (256, 202048, torch.bfloat16, 0, 1.0),
    (16, 202048, torch.bfloat16, 0, 1.0), (250, 50280, torch.float32, 1, 3.0),
    (320, 1001, torch.bfloat16, 0, 3.0)])
def test_kd_wrapper_launches_kd_plan(card_tensors, rows, v, dtype, off,
                                     temp):
    ys, yt = _at((rows, v), off, dtype), _at((rows, v), off, dtype)
    before = KD.KD_LOSS_LAUNCHES.count
    out = KD.kd_loss_rows_cuda(ys, yt, temp)
    assert KD.KD_LOSS_LAUNCHES.count == before + 1
    [(name, args)] = card_tensors.calls
    assert name == "kd_loss_rows"
    assert len(args) == len(build.SIGNATURES[name])
    plan = KD.kd_plan(rows, v, ys.element_size(), off == 0)
    assert args[:5] == (ys.data_ptr(), yt.data_ptr(), out.data_ptr(), rows, v)
    assert args[5] == pytest.approx(np.log2(np.e) / temp, rel=1e-12)
    assert args[6] == pytest.approx(1.0 / temp ** 2, rel=1e-12)
    assert args[7:] == (int(dtype == torch.bfloat16),
                        KD.DESIGNS.index(plan.design), plan.vec,
                        plan.threads, plan.lanes, plan.splits, plan.span,
                        plan.grid, 7)
    assert out.dtype == torch.float32 and tuple(out.shape) == (rows,)


def test_kd_wrapper_launches_nothing_for_no_rows(card_tensors):
    z = torch.zeros((0, 10))
    assert KD.kd_loss_rows_cuda(z, z, 1.0).shape == (0,)
    assert card_tensors.calls == []


# -- (c) the wrappers' limits -------------------------------------------------

def test_wrappers_raise_on_cpu_tensors():
    x, q = torch.zeros((8, 512)), torch.ones((8, 1))
    for call in (lambda: Q.quantize_rows_mixed_cuda(x, q, q),
                 lambda: KD.kd_loss_rows_cuda(x, x, 1.0),
                 lambda: KD.kd_loss_rows_cuda(x.bfloat16(), x.bfloat16(),
                                              3.0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("bad", ["x dtype", "x rank", "x strided",
                                 "delta shape", "delta dtype",
                                 "qmax shape", "qmax dtype", "qmax strided"])
def test_mixed_wrapper_raises_on_dtype_and_shape(card_tensors, bad):
    x, rd, qm = torch.zeros((8, 512)), torch.ones((8, 1)), torch.ones((8, 1))
    if bad == "x dtype":
        x = x.double()
    elif bad == "x rank":
        x = x.reshape(-1)
    elif bad == "x strided":
        x = torch.zeros((8, 1024))[:, ::2]
    elif bad == "delta shape":
        rd = torch.ones((8,))
    elif bad == "delta dtype":
        rd = rd.double()
    elif bad == "qmax shape":
        qm = torch.ones((7, 1))
    elif bad == "qmax dtype":
        qm = qm.to(torch.int32)
    else:
        qm = torch.ones((8, 2))[:, :1]
    with pytest.raises(ValueError):
        Q.quantize_rows_mixed_cuda(x, rd, qm)
    assert card_tensors.calls == []


@pytest.mark.parametrize("bad", ["rank 3", "rank 1", "no vocabulary",
                                 "float16", "two dtypes", "shapes differ",
                                 "student strided", "teacher strided"])
def test_kd_wrapper_raises_on_dtype_and_shape(card_tensors, bad):
    ys, yt = torch.zeros((8, 100)), torch.zeros((8, 100))
    if bad == "rank 3":
        ys, yt = ys.reshape(2, 4, 100), yt.reshape(2, 4, 100)
    elif bad == "rank 1":
        ys, yt = ys.reshape(-1), yt.reshape(-1)
    elif bad == "no vocabulary":
        ys, yt = torch.zeros((8, 0)), torch.zeros((8, 0))
    elif bad == "float16":
        ys, yt = ys.half(), yt.half()
    elif bad == "two dtypes":
        yt = yt.bfloat16()
    elif bad == "shapes differ":
        yt = torch.zeros((8, 101))
    elif bad == "student strided":
        ys = torch.zeros((8, 200))[:, ::2]
    else:
        yt = torch.zeros((8, 200))[:, ::2]
    with pytest.raises(ValueError):
        KD.kd_loss_rows_cuda(ys, yt, 2.0)
    assert card_tensors.calls == []


# -- (d) the mixed-width plain version against the Pallas kernel --------------

def mixed_rows(rows, cols, seed, zero=False):
    """``([rows, cols] fp32, [rows, 1] Δ, [rows, 1] qmax)`` as
    ``chip_smoke.edge_rows`` makes a mixed-width case, from a numpy seed:
    4, 8 and 16 bits in runs of three rows; Δ from each row's absmax over
    its qmax; on rows 1, 4, 7, ... Δ a power of two and every third column
    on an exact half-step ``(k + 1/2)·Δ`` over the row's code range; on
    rows 2, 5, 8, ... Δ a quarter of that, so codes beyond ±qmax clip.
    ``zero``: all zeros at the least normal Δ."""
    bits = np.array((4, 8, 16))[(np.arange(rows) // 3) % 3][:, None]
    qm = ((1 << (bits - 1)) - 1).astype(np.float32)
    if zero:
        return (np.zeros((rows, cols), np.float32),
                np.full((rows, 1), TINY, np.float32), qm)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, cols)) * 3).astype(np.float32)
    delta = np.maximum(np.abs(x).max(1, keepdims=True) / qm,
                       TINY).astype(np.float32)
    delta[1::3] = np.exp2(np.floor(np.log2(delta[1::3])))
    k = np.floor(rng.random((rows, cols)) * (2 * qm + 2)) - qm - 1
    x[1::3, ::3] = ((k.astype(np.float32) + np.float32(0.5))
                    * delta)[1::3, ::3]
    delta[2::3] /= np.float32(4)
    return x, delta, qm


def at_offset(a, off):
    """``a`` as a torch view whose first element lies ``off`` elements
    into its storage."""
    view = _at(a.shape, off, torch.from_numpy(a).dtype)
    view.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    assert view.storage_offset() == off and view.is_contiguous()
    return view


MIXED_CASES = [(257, 512, 0), (257, 510, 0), (257, 10, 0), (1, 512, 0),
               (1, 10, 0), (70000, 8, 0), (257, 512, 1), (257, 512, 2),
               (257, 512, 3), (33, 33, 1)]


@pytest.mark.parametrize("rows,cols,off", MIXED_CASES,
                         ids=[f"{r}x{c}-off{o}" for r, c, o in MIXED_CASES])
def test_mixed_plain_version_matches_pallas(rows, cols, off):
    x, delta, qm = mixed_rows(rows, cols, seed=rows + cols)
    codes = tref.quantize_rows_mixed_ref(at_offset(x, off),
                                         torch.from_numpy(delta),
                                         torch.from_numpy(qm))
    want = np.asarray(quantize_rows_mixed_pallas(x, delta, qm,
                                                 interpret=True))
    got = codes.numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (got >= -qm - 1).all() and (got <= qm).all()
    if rows >= 9 and cols >= 4:
        # each width has a clipped row (Δ a quarter) and a full-range one
        for r0 in (0, 3, 6):
            assert np.abs(got[r0 + 2]).max() >= qm[r0 + 2, 0]
        assert got[:3].max() <= 7 and np.abs(got[6:9]).max() > 127


def test_mixed_plain_version_matches_pallas_on_zeros():
    x, delta, qm = mixed_rows(257, 512, 0, zero=True)
    got = tref.quantize_rows_mixed_ref(torch.from_numpy(x),
                                       torch.from_numpy(delta),
                                       torch.from_numpy(qm)).numpy()
    want = np.asarray(quantize_rows_mixed_pallas(x, delta, qm,
                                                 interpret=True))
    assert got.tobytes() == want.tobytes() and not got.any()


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_mixed_plain_version_at_one_width_is_quantize_rows(bits):
    """A uniform qmax column gives ``quantize_rows``' codes bit for bit,
    so the row codec's one body serves both."""
    x, delta, _ = mixed_rows(257, 512, seed=bits)
    tx, td = torch.from_numpy(x), torch.from_numpy(delta)
    qm = torch.full((257, 1), tref._qmaxf(bits))
    assert torch.equal(tref.quantize_rows_mixed_ref(tx, td, qm),
                       tref.quantize_rows_ref(tx, td, bits=bits))
