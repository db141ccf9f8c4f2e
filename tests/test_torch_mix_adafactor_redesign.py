"""The Hopper redesign of ``mix_packed`` and ``adafactor_apply``, held on
the CPU where it can be: their launch plans, a tensor emulation of the
mix's new traversal, and the wrappers' limits.  That the CUDA kernels
are bit-identical to their plain versions is held on the card only
(``chip_smoke.py`` phase 3: the ring, full-packed, 8×8, 8×8 fp32-code,
accumulate, 12×12, C = 510 and offset-codes mixes, adafactor at
``[20, 208, 512]`` and on a buffer one element in).

* ``mix_plan`` for M in {1, 2, 8, 12, 20}, S in {1, 2, 8}, C in {512,
  510, 4, 3}, R in {1, 416}, aligned or not: every output written by
  exactly one thread (receivers by exactly one group, columns by exactly
  one thread of a block row, rows by exactly one step of the row
  stride), 16-byte vectors only where C is a multiple of 4 and the
  buffers are aligned, groups smaller than min(M, 8) only where larger
  ones would leave the launch under ``MIX_MIN_THREADS`` threads, the
  block and grid within the card's limits.
* The traversal (receiver groups, then senders in batches of four, in
  order) emulated with tensors over the plan's own indices equals
  ``mix_packed_ref`` bit for bit, int32 and fp32 codes; both are held to
  ``mix_packed_pallas(interpret=True)`` through the FMA arithmetic
  XLA:CPU gives it (``tests/test_torch_kernels.py``): the interpret
  kernel equals that arithmetic bit for bit, and the emulation is within
  4 ulp of the largest output of it.
* ``adafactor_plan`` for element offsets 0-3 (and two that differ) and n
  in {1, 3, 4, 5, 2129919, 2129920}: the kernel's threads (head, tail,
  ``ADA_UNROLL`` vectors each) cover ``[0, n)`` exactly once, the body
  on 16-byte addresses of both buffers.
* The wrappers raise on CPU tensors, wrong dtypes and wrong shapes.
"""
import numpy as np
import pytest
import torch

from repro.kernels.quantize.quantize import mix_packed_pallas
from repro_torch.kernels.opt_update import opt_update as OU
from repro_torch.kernels.opt_update.opt_update import (adafactor_apply_cuda,
                                                       adafactor_plan)
from repro_torch.kernels.quantize import quantize as Q
from repro_torch.kernels.quantize.quantize import mix_packed_cuda, mix_plan
from repro_torch.kernels.quantize.ref import mix_packed_ref

torch.set_num_threads(2)

MS = (1, 2, 8, 12, 20)
SS = (1, 2, 8)
CS = (512, 510, 4, 3)
RS = (1, 416)
BATCH = 4            # senders whose loads a thread issues together


# -- (a) the mix's launch plan ------------------------------------------------

def plan_indices(plan, m, rows, cols):
    """What the plan's threads write, axis by axis, in launch order:
    the receivers of each group (``blockIdx.z``), the columns of each
    thread of a block row, the rows of each row thread and step of the
    row stride.  Each is a flat array; an output is written once per
    (receiver, row, column) combination of them."""
    bx, by = plan.block
    gx, gy, gz = plan.grid
    recv = np.concatenate([np.arange(z * plan.group,
                                     min(m, (z + 1) * plan.group))
                           for z in range(gz)])
    first = np.arange(gx * bx) * plan.vec
    first = first[first < cols]
    col = (first[:, None] + np.arange(plan.vec)[None]).ravel()
    row = np.concatenate([np.arange(t, rows, gy * by)
                          for t in range(gy * by)])
    return recv, row, col


def _once(idx, n):
    return np.array_equal(np.bincount(idx, minlength=n), np.ones(n, int))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("s", SS)
@pytest.mark.parametrize("cols", CS)
@pytest.mark.parametrize("rows", RS)
def test_mix_plan_covers_each_output_once(m, s, cols, rows):
    for aligned in (True, False):
        plan = mix_plan(m, s, rows, cols, aligned)
        what = (m, s, rows, cols, aligned, plan)
        assert plan.vec == (4 if aligned and cols % 4 == 0 else 1), what
        assert plan.group in Q.MIX_GROUPS, what
        # the fewest groups, unless the launch would starve the card
        full = next(g for g in Q.MIX_GROUPS if g >= min(m, 8))
        units = -(-cols // plan.vec)
        if plan.group < full:
            assert rows * units * -(-m // (2 * plan.group)) \
                < Q.MIX_MIN_THREADS, what
        assert plan.smem(s) <= Q.MIX_SMEM, what
        bx, by = plan.block
        assert bx % 32 == 0 and bx * by == Q.MIX_THREADS, what
        gx, gy, gz = plan.grid
        assert min(plan.grid) >= 1 and max(gy, gz) <= Q.MAX_GRID_YZ, what
        assert (gz - 1) * plan.group < m, what   # no group empty
        assert (gx - 1) * bx * plan.vec < cols, what   # no block empty
        assert (gy - 1) * by < rows, what
        recv, row, col = plan_indices(plan, m, rows, cols)
        assert _once(recv, m) and _once(row, rows) and _once(col, cols), what


def test_mix_plan_limits():
    # the mesh round's shapes: one group for 8 x 8 would leave the card
    # 53,248 threads; 12 x 12 takes two groups of 8, the second partial
    assert mix_plan(8, 8, 416, 512, True).grid == (1, 416, 2)
    assert mix_plan(12, 12, 416, 512, True).group == 8
    assert mix_plan(8, 8, 4096, 512, True).group == 8
    assert mix_plan(3, 2, 4096, 512, True).group == 4   # one slot idle
    assert mix_plan(8, 3000, 4096, 512, True).group == 4  # weights: 48 KB
    assert mix_plan(8, 5000, 4096, 512, True).group == 2
    with pytest.raises(ValueError, match="shared memory"):
        mix_plan(1, 20000, 4, 8, True)
    with pytest.raises(ValueError, match="receivers"):
        mix_plan(0, 2, 4, 8, True)
    big = mix_plan(1, 2, 10 ** 6, 512, True)
    assert big.grid[1] == Q.MAX_GRID_YZ                  # rows by stride
    _, row, _ = plan_indices(big, 1, 10 ** 6, 512)
    assert _once(row, 10 ** 6)


# -- (b) the traversal, emulated over the plan's indices ----------------------

def emulate_mix(own, codes, row_delta, w_self, w_rows, aligned=True):
    """The kernel's arithmetic in its order: per receiver group, each
    receiver's ``w_self·own``, then the senders in batches of ``BATCH``
    loads, each ``code·Δ`` folded into every receiver of the group, on
    the rows and columns the plan's threads own.  Unwritten outputs stay
    NaN."""
    m, rows, cols = own.shape
    s = codes.shape[0]
    plan = mix_plan(m, s, rows, cols, aligned)
    _, row, col = plan_indices(plan, m, rows, cols)
    r_i, c_i = torch.as_tensor(row)[:, None], torch.as_tensor(col)[None]
    out = torch.full(own.shape, float("nan"))
    for z in range(plan.grid[2]):
        group = range(z * plan.group, min(m, (z + 1) * plan.group))
        acc = {k: w_self[k] * own[k][r_i, c_i] for k in group}
        for j0 in range(0, s, BATCH):
            batch = [(codes[j][r_i, c_i], row_delta[j][r_i])
                     for j in range(j0, min(s, j0 + BATCH))]
            for b, (cd, d) in enumerate(batch):
                deq = cd.to(torch.float32) * d
                for k in group:
                    acc[k] = acc[k] + w_rows[k, j0 + b] * deq
        for k in group:
            out[k][r_i, c_i] = acc[k]
    return out


def _mix_inputs(m, s, rows, cols, float_codes, seed):
    rng = np.random.default_rng(seed)
    own = rng.standard_normal((m, rows, cols)).astype(np.float32)
    if float_codes:
        codes = rng.standard_normal((s, rows, cols)).astype(np.float32)
        delta = np.ones((s, rows), np.float32)
    else:
        codes = rng.integers(-32768, 32768, (s, rows, cols)).astype(np.int32)
        delta = (rng.random((s, rows)) * 1e-4).astype(np.float32)
    w_self = rng.random(m).astype(np.float32)
    w_self[-1] = 0.0                              # full-packed's self weight
    w_rows = rng.random((m, s)).astype(np.float32)
    w_rows[0, 0] = 0.0                            # a zero weight
    return own, codes, delta, w_self, w_rows


def _rn(x):
    return x.astype(np.float32)


def _xla_fma_model(own, codes, delta, w_self, w_rows):
    """``mix_packed_pallas``' arithmetic under XLA:CPU: the self term and
    the first sender's term in one FMA, then one FMA a sender (each in
    float64, rounded once)."""
    s = codes.shape[0]
    deq = [_rn(codes[j].astype(np.float32) * delta[j][:, None])
           for j in range(s)]
    w = [w_rows[:, j][:, None, None] for j in range(s)]
    acc = _rn(w_self[:, None, None].astype(np.float64) * own
              + _rn(w[0] * deq[0][None]))
    for j in range(1, s):
        acc = _rn(acc.astype(np.float64)
                  + w[j].astype(np.float64) * deq[j][None])
    return acc


@pytest.mark.parametrize("m,s,cols", [(1, 2, 16), (1, 8, 16), (8, 8, 16),
                                      (12, 12, 6), (3, 5, 8), (20, 1, 3)],
                         ids=["ring", "full-packed", "8x8", "12x12-tail",
                              "3x5", "20x1-tail"])
@pytest.mark.parametrize("float_codes", [False, True], ids=["int32", "fp32"])
def test_mix_traversal_matches_plain_and_jax(m, s, cols, float_codes):
    own, codes, delta, w_self, w_rows = _mix_inputs(m, s, 5, cols,
                                                    float_codes, seed=m + s)
    t = [torch.from_numpy(x) for x in (own, codes, delta, w_self, w_rows)]
    want = mix_packed_ref(*t)
    for aligned in (True, False):
        got = emulate_mix(*t, aligned=aligned)
        assert got.numpy().tobytes() == want.numpy().tobytes()
    jax_out = np.asarray(mix_packed_pallas(own, codes, delta, w_self, w_rows,
                                           interpret=True))
    np.testing.assert_array_equal(
        jax_out, _xla_fma_model(own, codes, delta, w_self, w_rows))
    np.testing.assert_allclose(want.numpy(), jax_out, rtol=0,
                               atol=4 * np.spacing(np.abs(jax_out).max()))


def test_mix_traversal_accumulate_form():
    """The step-wise ring mix: the accumulator in ``own`` at weight one
    and one sender a launch; with one FMA-free term XLA's arithmetic is
    the plain one, so all three agree bit for bit."""
    own, codes, delta, _, w_rows = _mix_inputs(1, 1, 5, 16, False, seed=9)
    one = np.ones(1, np.float32)
    t = [torch.from_numpy(x) for x in (own, codes, delta, one, w_rows)]
    got = emulate_mix(*t)
    assert got.numpy().tobytes() == mix_packed_ref(*t).numpy().tobytes()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(mix_packed_pallas(own, codes, delta, one,
                                                  w_rows, interpret=True)))


# -- (c) the adafactor apply's split ------------------------------------------

def adafactor_cover(plan, n):
    """How often the kernel's threads touch each element of ``[0, n)``:
    thread ``gid`` does head element ``gid`` and tail element ``gid``
    where those exist, then vectors ``v0 + k·ADA_THREADS``, ``k <
    ADA_UNROLL``, of its block's tile."""
    threads = plan.grid * OU.ADA_THREADS
    gid = np.arange(threads)
    hits = [gid[gid < plan.head],
            plan.head + plan.vec * plan.body + gid[gid < plan.tail]]
    block, t = np.divmod(gid, OU.ADA_THREADS)
    v0 = block * OU.ADA_THREADS * OU.ADA_UNROLL + t
    v = (v0[:, None] + OU.ADA_THREADS * np.arange(OU.ADA_UNROLL)).ravel()
    v = v[v < plan.body]
    hits.append((plan.head + plan.vec * v[:, None]
                 + np.arange(plan.vec)).ravel())
    return np.bincount(np.concatenate(hits), minlength=n)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 2129919, 2129920])
@pytest.mark.parametrize("align", [0, 1, 2, 3])
def test_adafactor_split_covers_once(n, align):
    plan = adafactor_plan(n, align, align)
    what = (n, align, plan)
    assert plan.vec == 4 and 0 <= plan.head <= 3 and 0 <= plan.tail <= 3, \
        what
    assert plan.head + 4 * plan.body + plan.tail == n, what
    if plan.body:
        assert (align + plan.head) % 4 == 0, what   # the body on 16 bytes
    tile = OU.ADA_THREADS * OU.ADA_UNROLL
    assert plan.grid == max(1, -(-plan.body // tile)), what
    hits = adafactor_cover(plan, n)
    assert len(hits) == n and (hits == 1).all(), what


@pytest.mark.parametrize("aligns", [(0, 1), (3, 2)])
def test_adafactor_split_without_a_common_body(aligns):
    plan = adafactor_plan(4099, *aligns)
    assert (plan.vec, plan.head, plan.body, plan.tail) == (1, 0, 4099, 0)
    assert (adafactor_cover(plan, 4099) == 1).all()
    with pytest.raises(ValueError, match="positive"):
        adafactor_plan(0, 0, 0)


# -- (d) the wrappers' limits -------------------------------------------------

@pytest.fixture
def card_tensors(monkeypatch):
    """CPU tensors that pass the wrappers' device check, so their dtype
    and shape checks can be reached (each raises before any launch)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))


def test_wrappers_raise_on_cpu_tensors():
    own = torch.zeros((1, 8, 512))
    codes = torch.zeros((2, 8, 512), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mix_packed_cuda(own, codes, torch.ones((2, 8)), torch.ones(1),
                        torch.ones((1, 2)))
    p = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        adafactor_apply_cuda(torch.zeros(16), p, torch.ones(()),
                             weight_decay=0.01)


@pytest.mark.parametrize("bad", ["codes dtype", "own dtype", "delta shape",
                                 "w_rows shape", "codes shape", "own rank"])
def test_mix_wrapper_raises_on_dtype_and_shape(card_tensors, bad):
    args = dict(own=torch.zeros((2, 8, 512)),
                codes=torch.zeros((3, 8, 512), dtype=torch.int32),
                row_delta=torch.ones((3, 8)), w_self=torch.ones(2),
                w_rows=torch.ones((2, 3)))
    if bad == "codes dtype":
        args["codes"] = args["codes"].to(torch.int16)
    elif bad == "own dtype":
        args["own"] = args["own"].double()
    elif bad == "delta shape":
        args["row_delta"] = torch.ones((3, 9))
    elif bad == "w_rows shape":
        args["w_rows"] = torch.ones((3, 2))
    elif bad == "codes shape":
        args["codes"] = torch.zeros((3, 8, 510), dtype=torch.int32)
    else:
        args["own"] = torch.zeros((8, 512))
    with pytest.raises(ValueError):
        mix_packed_cuda(**args)


@pytest.mark.parametrize("bad", ["upd dtype", "p dtype", "upd shape",
                                 "lr shape"])
def test_adafactor_wrapper_raises_on_dtype_and_shape(card_tensors, bad):
    args = dict(upd=torch.zeros((2, 4, 8)), p=torch.zeros((2, 4, 8)),
                lr=torch.ones(()))
    if bad == "upd dtype":
        args["upd"] = args["upd"].double()
    elif bad == "p dtype":
        args["p"] = args["p"].half()
        args["upd"] = args["upd"].half()
    elif bad == "upd shape":
        args["upd"] = torch.zeros((2, 4, 9))
    else:
        args["lr"] = torch.ones(2)
    with pytest.raises(ValueError):
        adafactor_apply_cuda(**args, weight_decay=0.01)
