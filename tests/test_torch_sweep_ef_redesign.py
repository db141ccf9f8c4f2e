"""The Hopper redesign of ``adamw_update`` (a vectorized per-node sweep)
and of ``quantize_rows_ef`` (the row codec's residual case), held on the
CPU where it can be: their launch plans, the plans their wrappers pick
for the buffers they are given, the wrappers' limits, and the plain
versions against the JAX package's Pallas kernels at shapes that take
one element a vector.  That the CUDA kernels are bit-identical to their
plain versions is held on the card only (``chip_smoke.py`` phase 3: adamw
at the main path, ``[1, 416, 512]``, ``[2, 112, 512]``, an offset-1 view
and ``[3, 5, 7]``, with and without a mask and with none on; the error
feedback at ``[8320, 512]``, ``[960, 512]``, ``[416, 512]``, C = 510 and
an offset-1 x, at decay 1.0 and 0.9).

* ``adamw_plan`` at the paths' planes: each node's elements held by
  exactly one thread (vector ``b·256 + t`` for block ``b``, thread
  ``t``), no block empty, 32-bit in-node indices; one element a
  vector where ``node_elems % 4`` or an unaligned buffer would let a
  vector span two nodes; a refusal beyond 65,535 planes.
* ``rows_plan`` at the error feedback's shapes.
* The wrappers hand the C entry points the plan for their buffers'
  addresses (a recording stand-in for the library), and raise on a
  dtype, shape or mask they do not take before any launch.
* ``adamw_update_ref`` and ``quantize_rows_ef_ref`` against
  ``adamw_update_pallas`` / ``quantize_rows_ef_pallas`` (interpret
  mode) with the tolerances of ``tests/test_torch_kernels.py``: the
  moments within one ulp of the larger term and the parameters within
  ``4e-8`` (XLA:CPU contracts the moment EMAs into FMAs), the codes and
  residual bit for bit against the same arithmetic with its FMAs
  emulated.
* ``benchmarks/torch_sweep_ef_phases.py --plans`` prints each case's
  plan as ``adamw_plan`` and ``rows_plan`` pick it, without a card; with
  no card and no ``--plans`` it exits 2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.opt_update.opt_update import adamw_update_pallas
from repro.kernels.opt_update.ref import adamw_update_ref as jax_adamw_ref
from repro.kernels.quantize.quantize import quantize_rows_ef_pallas
from repro_torch.kernels.opt_update import opt_update as OU
from repro_torch.kernels.opt_update.ref import adamw_update_ref
from repro_torch.kernels.quantize import quantize as Q
from repro_torch.kernels.quantize.ref import quantize_rows_ef_ref

torch.set_num_threads(2)

HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
# [planes, rows, 512] of the paths that run adamw_update
PLANES = {"main path": (20, 416), "a rank's node": (1, 416),
          "round-step N=2": (2, 112), "round-step N=4": (4, 112),
          "round-step N=8": (8, 112), "cifar100": (4, 22144),
          "LM plane": (4, 164832)}
FULL_COVER = 1 << 22     # node planes checked element by element


# -- (a) adamw's launch plan --------------------------------------------------

def adamw_cover(plan, node_elems):
    """How often the plan's threads touch each element of one node's
    plane: block ``b``, thread ``t`` takes vector ``b·threads + t``
    below the node's vector count."""
    gx = plan.grid[0]
    b, t = np.meshgrid(np.arange(gx), np.arange(OU.ADAMW_THREADS),
                       indexing="ij")
    v = (b * OU.ADAMW_THREADS + t).ravel()
    v = v[v < node_elems // plan.vec]
    return np.bincount((v[:, None] * plan.vec
                        + np.arange(plan.vec)).ravel(), minlength=node_elems)


@pytest.mark.parametrize("case", sorted(PLANES))
def test_adamw_plan_covers_each_node_element_once(case):
    planes, rows = PLANES[case]
    node_elems = rows * 512
    plan = OU.adamw_plan(planes, node_elems, True)
    assert plan.vec == 4 and plan.grid[1] == planes, plan
    tile = OU.ADAMW_THREADS
    vecs = node_elems // plan.vec
    gx = plan.grid[0]
    assert (gx - 1) * tile < vecs <= gx * tile, plan     # no block empty
    assert gx * tile < 2 ** 31, plan                      # 32-bit indices
    if node_elems <= FULL_COVER:
        assert np.array_equal(adamw_cover(plan, node_elems),
                              np.ones(node_elems, int)), plan


def test_adamw_plan_at_the_main_path_and_the_lm_plane():
    assert OU.adamw_plan(20, 416 * 512, True) == OU.AdamwPlan(4, (208, 20))
    assert OU.adamw_plan(1, 416 * 512, True) == OU.AdamwPlan(4, (208, 1))
    lm = OU.adamw_plan(4, 164832 * 512, True)
    assert lm.vec == 4
    assert lm.grid == (164832 * 128 // 256, 4)


@pytest.mark.parametrize("planes,node_elems", [(3, 35), (1, 1), (2, 6),
                                               (4, 510)])
def test_adamw_plan_takes_one_element_a_vector_off_whole_vectors(
        planes, node_elems):
    """A node plane that is not whole 16-byte vectors would put a
    vector across two nodes: the plan takes one element a vector, and
    still holds each element once."""
    for aligned in (True, False):
        plan = OU.adamw_plan(planes, node_elems, aligned)
        assert plan.vec == 1, plan
        assert np.array_equal(adamw_cover(plan, node_elems),
                              np.ones(node_elems, int)), plan


def test_adamw_plan_unaligned_and_limits():
    assert OU.adamw_plan(20, 416 * 512, False).vec == 1
    assert OU.adamw_plan(OU.ADAMW_MAX_GRID_Y, 4, True).grid[1] == 65535
    with pytest.raises(ValueError, match="65535"):
        OU.adamw_plan(65536, 4, True)
    for bad in ((0, 4), (3, 0)):
        with pytest.raises(ValueError, match="empty"):
            OU.adamw_plan(*bad, True)


# -- (b) the row codec's plan at the error feedback's shapes ------------------

@pytest.mark.parametrize("rows,cols", [(8320, 512), (960, 512), (416, 512),
                                       (416, 510)])
def test_rows_plan_at_the_error_feedback_shapes(rows, cols):
    for aligned in (True, False):
        plan = Q.rows_plan(rows, cols, aligned)
        vec = 4 if aligned and cols % 4 == 0 else 1
        assert plan.vec == vec, plan
        units = -(-cols // vec)
        bx = min(Q.ROW_THREADS, -(-units // (32 * Q.ROW_UNROLL)) * 32)
        assert plan.block == (bx, Q.ROW_THREADS // bx), plan
        by = plan.block[1]
        assert plan.grid == (-(-units // (bx * Q.ROW_UNROLL)),
                             -(-rows // by)), plan
        assert plan.rows_a_thread == 1, plan
        span = bx * Q.ROW_UNROLL * vec
        assert (plan.grid[0] - 1) * span < cols <= plan.grid[0] * span
        # the columns of a row: each by exactly one thread's vector
        t, k = np.meshgrid(np.arange(plan.grid[0] * bx),
                           np.arange(Q.ROW_UNROLL), indexing="ij")
        first = ((t // bx) * bx * Q.ROW_UNROLL + t % bx + k * bx).ravel()
        first = first[first * vec < cols] * vec
        col = (first[:, None] + np.arange(vec)).ravel()
        assert np.array_equal(np.bincount(col, minlength=cols),
                              np.ones(cols, int))


# -- (c) the wrappers: the plan they hand the kernel, and their limits --------

@pytest.fixture
def card_tensors(monkeypatch):
    """CPU tensors that pass the wrappers' device check, so their dtype
    and shape checks can be reached (each raises before any launch)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda",
                        property(lambda self: True))


class Recorder:
    """A stand-in for the kernel library: records each entry point's
    arguments and returns 0 (no launch)."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.fixture
def recorder(card_tensors, monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(OU, "library", lambda: rec)
    monkeypatch.setattr(Q, "library", lambda: rec)
    monkeypatch.setattr(OU, "stream_of", lambda t: None)
    monkeypatch.setattr(Q, "stream_of", lambda t: None)
    return rec


def at_offset(shape, off, dtype=torch.float32):
    """A contiguous ``shape`` view ``off`` elements into a 16-byte
    aligned buffer."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 4, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[off:off + n].view(shape)


def adamw_args(shape, offs=(0, 0, 0, 0)):
    planes = shape[0]
    bufs = [at_offset(shape, o) for o in offs]
    return bufs, (torch.ones(()), torch.ones(planes), torch.ones(planes),
                  torch.ones(planes))


@pytest.mark.parametrize("which", range(4))
@pytest.mark.parametrize("off", [1, 2, 3])
def test_adamw_wrapper_takes_one_element_a_vector_off_16_bytes(
        recorder, which, off):
    offs = [0, 0, 0, 0]
    offs[which] = off
    bufs, scalars = adamw_args((2, 112, 512), offs)
    OU.adamw_update_cuda(*bufs, *scalars, **HP)
    args = recorder.calls["adamw_update"]
    plan = OU.adamw_plan(2, 112 * 512, False)
    assert plan.vec == 1
    assert args[17:20] == (plan.vec, *plan.grid)
    assert OU.ADAMW_LAUNCHES.last_plan == plan
    assert args[9:11] == (2 * 112 * 512, 112 * 512)


def test_adamw_wrapper_hands_over_its_plan(recorder):
    bufs, scalars = adamw_args((20, 416, 512))
    before = OU.ADAMW_LAUNCHES.count
    OU.adamw_update_cuda(*bufs, *scalars, **HP)
    plan = OU.adamw_plan(20, 416 * 512, True)
    assert recorder.calls["adamw_update"][17:20] == (plan.vec, *plan.grid)
    assert OU.ADAMW_LAUNCHES.count == before + 1
    assert OU.ADAMW_LAUNCHES.last_plan == plan
    bufs, scalars = adamw_args((3, 5, 7))
    OU.adamw_update_cuda(*bufs, *scalars, **HP)
    assert recorder.calls["adamw_update"][17] == 1
    assert OU.ADAMW_LAUNCHES.last_plan.vec == 1


@pytest.mark.parametrize("off", [0, 1])
def test_ef_wrapper_hands_over_the_row_plan(recorder, off):
    x = at_offset((416, 512), off)
    res = torch.zeros((416, 512))
    rd, qm = torch.ones((416, 1)), torch.full((416, 1), 7.0)
    before = Q.QUANTIZE_ROWS_EF_LAUNCHES.count
    codes, new_res = Q.quantize_rows_ef_cuda(x, res, rd, qm, 0.9)
    args = recorder.calls["quantize_rows_ef"]
    plan = Q.rows_plan(416, 512, off == 0)
    assert args[6:9] == (416, 512, 0.9)
    assert args[9:14] == (plan.vec, *plan.block, *plan.grid)
    assert args[4:6] == (codes.data_ptr(), new_res.data_ptr())
    assert Q.QUANTIZE_ROWS_EF_LAUNCHES.count == before + 1
    assert Q.QUANTIZE_ROWS_EF_LAUNCHES.last_plan == plan


def test_wrappers_raise_on_cpu_tensors():
    bufs, (lr, scale, bc1, bc2) = adamw_args((2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        OU.adamw_update_cuda(*bufs, lr, scale, bc1, bc2, **HP)
    x = torch.zeros((8, 512))
    with pytest.raises(ValueError, match="CUDA"):
        Q.quantize_rows_ef_cuda(x, x.clone(), torch.ones((8, 1)),
                                torch.ones((8, 1)), 1.0)


ADAMW_BAD = ["g dtype", "p shape", "nu strided", "lr two elements",
             "scale shape", "bc1 shape", "bc2 dtype", "active dtype",
             "active shape"]


@pytest.mark.parametrize("bad", ADAMW_BAD)
def test_adamw_wrapper_raises_on_what_it_does_not_take(recorder, bad):
    (g, p, mu, nu), (lr, scale, bc1, bc2) = adamw_args((3, 4, 8))
    active = torch.ones(3, dtype=torch.bool)
    if bad == "g dtype":
        g = g.double()
    elif bad == "p shape":
        p = torch.zeros((3, 8, 4))
    elif bad == "nu strided":
        nu = torch.zeros((3, 4, 16))[..., ::2]
    elif bad == "lr two elements":
        lr = torch.ones(2)
    elif bad == "scale shape":
        scale = torch.ones(4)
    elif bad == "bc1 shape":
        bc1 = torch.ones(())
    elif bad == "bc2 dtype":
        bc2 = bc2.double()
    elif bad == "active dtype":
        active = torch.ones(3)
    else:
        active = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        OU.adamw_update_cuda(g, p, mu, nu, lr, scale, bc1, bc2,
                             active=active, **HP)
    assert "adamw_update" not in recorder.calls


EF_BAD = ["x dtype", "x rank", "res shape", "res strided", "delta shape",
          "qmax dtype", "qmax shape"]


@pytest.mark.parametrize("bad", EF_BAD)
def test_ef_wrapper_raises_on_what_it_does_not_take(recorder, bad):
    x, res = torch.zeros((8, 512)), torch.zeros((8, 512))
    rd, qm = torch.ones((8, 1)), torch.ones((8, 1))
    if bad == "x dtype":
        x = x.double()
    elif bad == "x rank":
        x = x.reshape(-1)
    elif bad == "res shape":
        res = torch.zeros((8, 510))
    elif bad == "res strided":
        res = torch.zeros((8, 1024))[:, ::2]
    elif bad == "delta shape":
        rd = torch.ones((8,))
    elif bad == "qmax dtype":
        qm = qm.double()
    else:
        qm = torch.ones((4, 1))
    with pytest.raises(ValueError):
        Q.quantize_rows_ef_cuda(x, res, rd, qm, 1.0)
    assert "quantize_rows_ef" not in recorder.calls


# -- (d) the plain versions against the Pallas kernels at vec-1 shapes --------

@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 3, 510)])
def test_adamw_plain_matches_jax_at_one_element_a_vector(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    g[0, 0, :3] = [1e-9, 0.0, -3e-8]                  # |g| near eps
    p = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    mu = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    nu = (rng.random(shape) * 1e-5).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, shape[0]).astype(np.float32)
    steps = np.arange(1, shape[0] + 1, dtype=np.float32) * 3
    bc1 = (np.float32(1) - np.float32(0.9) ** steps).astype(np.float32)
    bc2 = (np.float32(1) - np.float32(0.999) ** steps).astype(np.float32)
    lr = np.float32(1e-3)
    t = torch.from_numpy
    got = adamw_update_ref(t(g), t(p), t(mu), t(nu), lr=t(np.array(lr)),
                           scale=t(scale), bc1=t(bc1), bc2=t(bc2), **HP)
    s11 = lambda x: jnp.full((1, 1), x, jnp.float32)  # noqa: E731
    ulp = np.float32(2.0 ** -23)
    for i in range(shape[0]):
        ref = jax_adamw_ref(g[i], p[i], mu[i], nu[i], lr=lr, scale=scale[i],
                            bc1=bc1[i], bc2=bc2[i], **HP)
        for ours, b in zip(got, ref):
            np.testing.assert_array_equal(ours[i].numpy(), np.asarray(b))
        pallas = adamw_update_pallas(
            g[i], p[i], mu[i], nu[i], s11(lr), s11(scale[i]), s11(bc1[i]),
            s11(bc2[i]), interpret=True, **HP)
        g32 = g[i] * scale[i]
        terms = (np.abs(np.float32(0.9) * mu[i]) + np.abs(0.1 * g32),
                 np.abs(np.float32(0.999) * nu[i]) + np.abs(1e-3 * g32 * g32))
        for k in (1, 2):
            diff = np.abs(got[k][i].numpy() - np.asarray(pallas[k]))
            assert np.all(diff <= ulp * terms[k - 1])
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(pallas[0]),
                                   rtol=0, atol=4e-8)


def _fma_ef(x, res, delta, qmax, decay):
    """The interpret-mode kernel's arithmetic: XLA:CPU fuses ``x +
    decay·res`` and ``eff - codes·Δ`` into FMAs, emulated in float64
    with each FMA rounded once to fp32 (the products are exact there)."""
    f64 = np.float64
    eff = (x.astype(f64) + f64(np.float32(decay)) * res).astype(np.float32)
    codes = np.clip(np.floor(eff / delta + np.float32(0.5)), -qmax - 1, qmax)
    new_res = (eff.astype(f64) - codes.astype(f64) * delta).astype(
        np.float32)
    return codes.astype(np.int32), new_res


@pytest.mark.parametrize("rows,cols", [(5, 7), (9, 510)])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_ef_plain_matches_jax_at_one_element_a_vector(rows, cols, decay):
    rng = np.random.default_rng(rows * cols)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    res = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
    res[1] = 0.0
    qmax = np.where(np.arange(rows) % 2 == 0, 32767.0, 7.0).astype(
        np.float32)[:, None]
    delta = (np.abs(x + res).max(1, keepdims=True) / qmax).astype(np.float32)
    delta[2] /= np.float32(4.0)                 # a row whose codes clip
    t = torch.from_numpy
    codes, new_res = quantize_rows_ef_ref(t(x), t(res), t(delta), t(qmax),
                                          torch.tensor(decay,
                                                       dtype=torch.float32))
    eff = jnp.asarray(x) + jnp.float32(decay) * jnp.asarray(res)   # eager
    jcodes = jnp.clip(jnp.floor(eff / delta + 0.5), -qmax - 1, qmax)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert new_res.numpy().tobytes() == \
        np.asarray(eff - jcodes * delta).tobytes()
    jc, jr = quantize_rows_ef_pallas(x, res, delta, qmax, decay=decay,
                                     interpret=True)
    model = _fma_ef(x, res, delta, qmax, decay)
    np.testing.assert_array_equal(np.asarray(jc), model[0])
    np.testing.assert_array_equal(np.asarray(jr), model[1])
    if decay == 1.0:            # 1·res is exact: the same codes as Pallas
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    assert int(codes[2].max()) == int(qmax[2, 0])
    assert int(codes[2].min()) == -int(qmax[2, 0]) - 1


# -- (e) the timing script's plans, without a card ----------------------------

def _phases_script():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "torch_sweep_ef_phases.py"
    spec = importlib.util.spec_from_file_location("torch_sweep_ef_phases",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phases_script_prints_each_cases_plan(capsys):
    import json
    S = _phases_script()
    assert S.main(["--plans"]) == 0
    plans = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    plans = plans["plans"]
    assert len(plans) == len(S.ADAMW_CASES) + len(S.EF_CASES)
    for name, (n, r) in S.ADAMW_CASES.items():
        want = OU.adamw_plan(n, r * S.COLS, True)
        got = plans[f"adamw_update {name}"]
        assert (got["vec"], tuple(got["grid"])) == (want.vec, want.grid)
    for name, r in S.EF_CASES.items():
        want = Q.rows_plan(r, S.COLS, True)
        got = plans[f"quantize_rows_ef {name}"]
        assert (got["vec"], tuple(got["block"]), tuple(got["grid"])) == \
            (want.vec, want.block, want.grid)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_phases_script_needs_a_card_to_time(capsys):
    assert _phases_script().main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
