"""Eq. 5 prototype inference, the KD loss and the modules the paper's
Claim 4 runs on, held against the JAX package on the CPU; and the port's
import rule.

Tolerances, each with its reason:

* ``proto_dists`` (the plain expansion here) against ``repro``'s Pallas
  kernel in interpret mode and against its direct oracle: JAX's own
  ``1e-4`` (fp32) and ``5e-2`` (bf16; both sides cast the same bf16
  values to fp32, so the gap is fp32 summation order, well inside it).
* ``nearest_prototype``: equal to JAX's argmin wherever the reference's
  top-2 gap exceeds ``PRED_GAP`` times the largest distance (the
  expansion and the direct oracle round differently near ties); masks,
  all-masked rows and exact ties bit for bit.
* ``pairwise_sq_dists``, ``local_prototypes``,
  ``aggregate_prototypes_strict``: ``rtol=1e-5`` (einsum / matmul
  summation order); ``pairwise_sq_dists``' gradient ``rtol=1e-4``.
* ``kd_loss`` and its per-row plain version against ``kd_loss_rows_ref``,
  ``kd_loss_ref_mean`` and ``core.distillation.kd_loss``: an absolute
  tolerance ``kd_tol`` = ``1e-5·T·(T + max|y|)``.  The KL is the
  difference of terms of the size of ``max|y|/T`` (then times T²), so a
  relative bound would be meaningless near KL = 0; identical logits must
  give 0 within it.  The Pallas kd_loss cannot run here (JAX 0.9 renamed
  ``pltpu.TPUCompilerParams``), so the oracles are the reference's plain
  functions; a numpy model of the CUDA kernel's algorithm (its three
  designs under ``kd_plan``: the segments' max-first sums, the per-thread
  tiles and their merges, the cluster's merge) is held to the same
  tolerance.
* ``compute_local_prototypes`` and ``make_fedavg_step``: from weights
  carried with ``params_from_numpy``, fp32 configs; prototypes and
  losses ``rtol=1e-5``, parameters after adamw ``atol=2e-6`` for one
  step (see ``test_torch_modules.py``), ``atol=2e-5`` after eight.
* The schedules: ``rtol=1e-6`` (``cos`` of two libraries).
* Claim 4 at ``tests/test_system.py``'s size (mnist-cnn at full width, 2
  local epochs of batch 64, the 240 test images) in fp32 (in bf16 the two
  frameworks round convolutions at different places): predictions equal
  away from near-ties, and the port's accuracy above JAX's 0.5 bar.

The CUDA wrappers launch their kernels or raise; here they raise on CPU
tensors, and ``chip_smoke.py`` holds them against the plain versions on
the card.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import base as jbase
from repro.core import baselines as JB
from repro.core import distillation as JD
from repro.core import profe as JP
from repro.core import prototypes as JPR
from repro.data import synthetic as jsyn
from repro.data.loader import batches as jbatches
from repro.data.partition import partition as jpartition
from repro.kernels.kd_loss import ops as jkd_ops
from repro.kernels.kd_loss.ref import kd_loss_rows_ref as j_kd_rows_ref
from repro.kernels.proto_dist import ops as jpd_ops
from repro.kernels.proto_dist.ref import proto_dist_ref as j_proto_dist_ref
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import schedule as JS
from repro_torch.config import base as tbase
from repro_torch.core import baselines as TB
from repro_torch.core import distillation as TD
from repro_torch.core import profe as TP
from repro_torch.core import prototypes as TPR
from repro_torch.data.loader import batch_index_lists
from repro_torch.kernels import build
from repro_torch.kernels.kd_loss import kd_loss as tkd
from repro_torch.kernels.kd_loss import ops as tkd_ops
from repro_torch.kernels.kd_loss.kd_loss import kd_loss_rows_cuda
from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref
from repro_torch.kernels.proto_dist import ops as tpd_ops
from repro_torch.kernels.proto_dist.proto_dist import proto_dist_cuda
from repro_torch.kernels.proto_dist.ref import (proto_dist_expand,
                                                proto_dist_ref)
from repro_torch.models import model as tmodel
from repro_torch.optim import make_optimizer
from repro_torch.optim import schedule as TS
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PRED_GAP = 1e-4


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tcfg(jcfg):
    return tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _pair(arr, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (``"float32"`` or ``"bfloat16"``), the same values."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def kd_tol(ys, yt, temperature):
    ymax = float(max(np.abs(_np(ys)).max(), np.abs(_np(yt)).max()))
    return 1e-5 * temperature * (temperature + ymax)


# -- the import rule ----------------------------------------------------------

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    """No module of the port and not ``chip_smoke.py`` imports ``jax``
    (or ``jaxlib``) or anything of the JAX package ``repro``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


# -- row 18: proto_dist -------------------------------------------------------

PD_SHAPES = [(64, 10, 32), (130, 100, 256), (7, 3, 64), (128, 128, 128),
             (1, 1, 8)]


@pytest.mark.parametrize("n,c,p", PD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proto_dists_match_jax_kernel_and_oracle(n, c, p, dtype):
    rng = np.random.default_rng(n * 1000 + c)
    jx, tx = _pair(rng.standard_normal((n, p)), dtype)
    jp, tp = _pair(rng.standard_normal((c, p)), dtype)
    got = tpd_ops.proto_dists(tx, tp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, c)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for want in (jpd_ops.proto_dists(jx, jp), j_proto_dist_ref(jx, jp),
                 proto_dist_ref(tx, tp)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                                   atol=tol)
    assert bool((got >= 0).all())


def _top2_gap(d2):
    s = np.sort(d2, axis=-1)
    return s[:, 1] - s[:, 0] if d2.shape[1] > 1 else np.full(len(d2), np.inf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nearest_prototype_matches_jax_away_from_ties(dtype):
    rng = np.random.default_rng(5)
    jx, tx = _pair(rng.standard_normal((200, 64)), dtype)
    jp, tp = _pair(rng.standard_normal((10, 64)), dtype)
    mask = (rng.random(10) < 0.8).astype(np.float32)
    got = tpd_ops.nearest_prototype(tx, tp, torch.from_numpy(mask)).numpy()
    want = np.asarray(jpd_ops.nearest_prototype(jx, jp, jnp.asarray(mask)))
    d2 = np.asarray(j_proto_dist_ref(jx, jp))
    d2 = np.where(mask[None] > 0, d2, np.inf)
    clear = _top2_gap(d2) > PRED_GAP * d2[np.isfinite(d2)].max()
    assert clear.sum() >= 190, f"only {clear.sum()} rows clear of ties"
    np.testing.assert_array_equal(got[clear], want[clear])
    assert set(got.tolist()) <= set(np.flatnonzero(mask).tolist())


def test_nearest_prototype_respects_mask_and_all_masked_rows():
    x = torch.zeros((4, 8))
    protos = torch.stack([torch.zeros(8), torch.ones(8) * 10])
    got = tpd_ops.nearest_prototype(x, protos, torch.tensor([0.0, 1.0]))
    assert got.tolist() == [1, 1, 1, 1]        # class 0 unseen
    got = tpd_ops.nearest_prototype(x, protos, torch.zeros(2))
    want = jpd_ops.nearest_prototype(jnp.zeros((4, 8)), jnp.asarray(
        protos.numpy()), jnp.zeros(2))
    assert got.tolist() == np.asarray(want).tolist() == [0, 0, 0, 0]


def test_nearest_prototype_ties_go_to_the_first_index():
    x = np.zeros((3, 4), np.float32)
    x[1] = 1.0
    protos = np.stack([np.ones(4), -np.ones(4), np.ones(4), -np.ones(4)]
                      ).astype(np.float32)
    mask = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    got = tpd_ops.nearest_prototype(*map(torch.from_numpy,
                                         (x, protos, mask)))
    want = jpd_ops.nearest_prototype(*map(jnp.asarray, (x, protos, mask)))
    # rows 0 and 2: classes 1-3 tie; row 1: classes 0 and 2 tie, 0 masked
    assert got.tolist() == np.asarray(want).tolist() == [1, 2, 1]


def test_proto_dist_expansion_clamps_at_zero():
    x = torch.full((2, 16), 3.0)
    d2 = proto_dist_expand(x, x[:1] + 1e-7)
    assert bool((d2 >= 0).all()) and float(d2.max()) < 1e-4


# -- core/prototypes ------------------------------------------------------------

@pytest.mark.parametrize("n,c", [(50, 10), (7, 100)])
def test_pairwise_sq_dists_and_predict_match_jax(n, c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    protos = rng.standard_normal((c, 32)).astype(np.float32)
    mask = (rng.random(c) < 0.7).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = TPR.pairwise_sq_dists(tx, torch.from_numpy(protos))
    want = JPR.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(protos))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    (g,) = torch.autograd.grad(got.sum(), [tx])
    jg = jax.grad(lambda a: JPR.pairwise_sq_dists(
        a, jnp.asarray(protos)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)
    preds = TPR.nearest_prototype_predict(
        torch.from_numpy(x), torch.from_numpy(protos), torch.from_numpy(mask))
    jpreds = np.asarray(JPR.nearest_prototype_predict(
        jnp.asarray(x), jnp.asarray(protos), jnp.asarray(mask)))
    d2 = np.where(mask[None] > 0, np.asarray(want), np.inf)
    clear = _top2_gap(d2) > PRED_GAP * d2[np.isfinite(d2)].max()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(preds.numpy()[clear], jpreds[clear])


@pytest.mark.parametrize("n,c", [(64, 10), (5, 12)])
def test_local_prototypes_match_jax(n, c):
    rng = np.random.default_rng(n)
    f1 = rng.standard_normal((n, 16)).astype(np.float32)
    labels = rng.integers(0, min(c, 8), n).astype(np.int32)   # some unseen
    got_p, got_c = TPR.local_prototypes(torch.from_numpy(f1),
                                        torch.from_numpy(labels), c)
    want_p, want_c = JPR.local_prototypes(jnp.asarray(f1),
                                          jnp.asarray(labels), c)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=1e-6)
    assert not got_p[got_c == 0].any()


def test_aggregate_prototypes_strict_matches_jax():
    rng = np.random.default_rng(3)
    protos = rng.standard_normal((4, 10, 16)).astype(np.float32)
    counts = rng.integers(0, 5, (4, 10)).astype(np.float32)
    counts[:, 7] = 0                                   # a class no node saw
    got_g, got_m = TPR.aggregate_prototypes_strict(
        torch.from_numpy(protos), torch.from_numpy(counts))
    want_g, want_m = JPR.aggregate_prototypes_strict(jnp.asarray(protos),
                                                     jnp.asarray(counts))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)
    plain, _ = TPR.aggregate_prototypes(torch.from_numpy(protos),
                                        torch.from_numpy(counts))
    knowing = (counts > 0).sum(0)
    np.testing.assert_allclose(
        got_g.numpy(), plain.numpy() / np.maximum(knowing, 1)[:, None],
        rtol=1e-6, atol=1e-7)


# -- row 17: kd_loss ----------------------------------------------------------

KD_SHAPES = [(8, 10), (2, 5, 256), (33, 1000)]


@pytest.mark.parametrize("shape", KD_SHAPES)
@pytest.mark.parametrize("temperature", [1.0, 3.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kd_loss_matches_jax(shape, temperature, dtype):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    js, ts = _pair(rng.standard_normal(shape) * 2, dtype)
    jt, tt = _pair(rng.standard_normal(shape) * 2, dtype)
    got = tkd_ops.kd_loss(ts, tt, temperature)
    assert got.dtype == torch.float32 and got.dim() == 0
    tol = kd_tol(ts, tt, temperature)
    for want in (jkd_ops.kd_loss_ref_mean(js, jt, temperature),
                 JD.kd_loss(js, jt, temperature),
                 TD.kd_loss(ts, tt, temperature),
                 tkd_ops.kd_loss_ref_mean(ts, tt, temperature)):
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=tol)
    assert float(got) > 0


@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_kd_loss_rows_ref_matches_jax_per_row(temperature):
    rng = np.random.default_rng(11)
    ys = rng.standard_normal((17, 777)).astype(np.float32) * 4
    yt = rng.standard_normal((17, 777)).astype(np.float32) * 4
    got = kd_loss_rows_ref(torch.from_numpy(ys), torch.from_numpy(yt),
                           temperature)
    want = j_kd_rows_ref(jnp.asarray(ys), jnp.asarray(yt), temperature)
    assert tuple(got.shape) == (17,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=kd_tol(ys, yt, temperature))


@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_kd_loss_is_zero_for_identical_logits(temperature):
    """JAX's ``test_kd_loss_zero_when_identical`` (which fails on JAX 0.9
    for the renamed compiler params), here within ``kd_tol`` of 0."""
    y = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, 512)).astype(np.float32) * 5)
    got = float(tkd_ops.kd_loss(y, y.clone(), temperature))
    assert abs(got) <= kd_tol(y, y, temperature)


NEG = np.float32(-1e30)          # the kernel's initial running max
F32 = np.float32


def _fma(a, b, c):
    """fmaf in numpy: the product and sum in float64, rounded once."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _merge(a, b):
    """The kernel's ``merge``: state ``b`` folded into ``a`` (tuples
    ``(mt, lt, u, ms, ls)`` of fp32 arrays) with the rescaling."""
    mt = np.maximum(a[0], b[0])
    ca, cb = np.exp2(a[0] - mt), np.exp2(b[0] - mt)
    ms = np.maximum(a[3], b[3])
    return (mt, a[1] * ca + b[1] * cb, a[2] * ca + b[2] * cb, ms,
            a[4] * np.exp2(a[3] - ms) + b[4] * np.exp2(b[3] - ms))


def _warp_merge(st):
    """``warp_merge``: the xor-shuffle tree over the last axis (32 lanes),
    every lane folding its partner's state from before the step; lane 0's
    state."""
    for off in (16, 8, 4, 2, 1):
        st = _merge(st, tuple(x[..., np.arange(32) ^ off] for x in st))
    return tuple(x[..., 0] for x in st)


def _finish(st, scale, inv_t_sq):
    mt, lt, u, ms, ls = st
    kl2 = u * scale / lt - (mt - ms) - (np.log2(lt) - np.log2(ls))
    return kl2 * F32(np.log(2.0)) / inv_t_sq


def _emulate_segments(ys, yt, scale, inv_t_sq, lanes):
    """The segments design: lane q of a row's segment holds logits q +
    k·lanes; the row's max first (a max is order-free), then each lane's
    sums in k order, folded by the xor tree within the segment."""
    r, v = ys.shape
    per = -(-v // lanes)
    idx = np.arange(lanes)[:, None] + lanes * np.arange(per)[None]
    ok = idx < v
    a = np.where(ok, ys[:, np.minimum(idx, v - 1)], 0)     # [r, lanes, per]
    b = np.where(ok, yt[:, np.minimum(idx, v - 1)], 0)
    mt = (yt.max(1) * scale).astype(F32)[:, None]
    ms = (ys.max(1) * scale).astype(F32)[:, None]
    lt, u, ls = (np.zeros((r, lanes), F32) for _ in range(3))
    for k in range(per):
        pt = np.where(ok[:, k], np.exp2(_fma(b[..., k], scale, -mt)), 0)
        ps = np.where(ok[:, k], np.exp2(_fma(a[..., k], scale, -ms)), 0)
        lt, ls = lt + pt, ls + ps
        u = _fma(pt, b[..., k] - a[..., k], u)
    off = lanes // 2
    while off:
        lt, u, ls = (x + x[:, np.arange(lanes) ^ off] for x in (lt, u, ls))
        off //= 2
    return _finish((mt[:, 0], lt[:, 0], u[:, 0], ms[:, 0], ls[:, 0]),
                   scale, inv_t_sq)


def _emulate_block(ys, yt, scale, lo, hi, plan):
    """One block of the blocks / clusters design over vectors [lo, hi) of
    each row: thread x's tiles (its vectors x + k·threads of each tile, k
    < tile_loads(vec)), each a masked max, one rescale of the thread's
    state and its exp2 sums in element order; then the warps' xor trees
    and warp 0's over the warps' states.  Returns the block's state."""
    r = ys.shape[0]
    nt, vec = plan.threads, plan.vec
    per = tkd.tile_loads(vec)
    tiles = -(-(hi - lo) // (nt * per))
    vidx = (lo + np.arange(nt)[:, None, None]
            + nt * (per * np.arange(tiles)[None, :, None]
                    + np.arange(per)[None, None, :]))  # [nt, tiles, per]
    eidx = (vidx[..., None] * vec + np.arange(vec)).reshape(nt, tiles, -1)
    ok = np.repeat(vidx < hi, vec, axis=-1)
    eidx = np.where(ok, eidx, 0)
    st = (np.full((r, nt), NEG), np.zeros((r, nt), F32),
          np.zeros((r, nt), F32), np.full((r, nt), NEG),
          np.zeros((r, nt), F32))
    for t in range(tiles):
        m = ok[:, t]                                        # [nt, E]
        a = np.where(m, ys[:, eidx[:, t]], 0).astype(F32)   # [r, nt, E]
        b = np.where(m, yt[:, eidx[:, t]], 0).astype(F32)
        rt = np.where(m, b, NEG).max(-1)
        rs = np.where(m, a, NEG).max(-1)
        mt = np.maximum(st[0], (rt * scale).astype(F32))
        ms = np.maximum(st[3], (rs * scale).astype(F32))
        lt, u, ls = (np.zeros((r, nt), F32) for _ in range(3))
        for e in range(m.shape[-1]):
            pt = np.where(m[:, e], np.exp2(_fma(b[..., e], scale, -mt)), 0)
            ps = np.where(m[:, e], np.exp2(_fma(a[..., e], scale, -ms)), 0)
            lt, ls = lt + pt, ls + ps
            u = _fma(pt, b[..., e] - a[..., e], u)
        ct, cs = np.exp2(st[0] - mt), np.exp2(st[3] - ms)
        st = (mt, _fma(st[1], ct, lt), _fma(st[2], ct, u), ms,
              _fma(st[4], cs, ls))
    warps = _warp_merge(tuple(x.reshape(r, -1, 32) for x in st))  # [r, w]
    pad = 32 - warps[0].shape[1]
    return _warp_merge(tuple(
        np.pad(x, ((0, 0), (0, pad)),
               constant_values=NEG if i in (0, 3) else 0).astype(F32)
        for i, x in enumerate(warps)))


def _emulate_kernel(ys, yt, temperature, plan):
    """numpy fp32 model of ``csrc/kd_loss.cu`` under ``plan``
    (:func:`kd_plan`): the log2-domain scalars the wrapper passes, then the
    segments design, or each block of a row's cluster (one block for the
    blocks design) and block 0's merge of the others in rank order, and
    the finish.  It models the ``.cu`` file's algorithm; it is not that
    file (which runs on the card only)."""
    inv_t = 1.0 / temperature
    scale, inv_t_sq = F32(inv_t * np.log2(np.e)), F32(inv_t * inv_t)
    if plan.design == "segments":
        return _emulate_segments(ys, yt, scale, inv_t_sq, plan.lanes)
    nvec = ys.shape[1] // plan.vec
    acc = None
    for k in range(plan.splits):
        st = _emulate_block(ys, yt, scale, k * plan.span,
                            min(nvec, (k + 1) * plan.span), plan)
        acc = st if acc is None else _merge(acc, st)
    return _finish(acc, scale, inv_t_sq)


# (rows, V, bytes a logit, SMs, the design kd_plan picks); bf16 cases hold
# bf16 values as fp32
KD_MODEL_CASES = [
    (6, 10, 4, 132, "segments"),       # the ProFe KD term's V, 2 lanes a row
    (6, 1000, 4, 6, "blocks"),         # 16-byte vectors of 4
    (6, 50280 // 8, 4, 6, "blocks"),   # V % 4 = 1: one logit a load
    (6, 7, 4, 132, "segments"),        # a lane a row
    (6, 13, 2, 132, "segments"),       # a lane one short
    (6, 256, 4, 132, "segments"),      # a warp a row
    (6, 50280, 2, 132, "clusters"),    # 7 blocks a row, vectors of 8
    (2, 202048, 2, 132, "clusters"),   # 8 blocks a row
]


@pytest.mark.parametrize("rows,v,elem_bytes,sms,design", KD_MODEL_CASES)
@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_kernel_online_algorithm_matches_rows_ref(rows, v, elem_bytes, sms,
                                                  design, temperature):
    """The kernel's algorithm (segments: the row's max, then one exp2 a
    logit and the segment's xor sums; blocks and clusters: per-thread
    tiles with one rescale each, the two-level shuffle merge, the
    cluster's merge in rank order; the log2-domain finish), modelled in
    numpy fp32 under ``kd_plan``'s plan, against the plain per-row
    version.  A model of the ``.cu`` file, not the file: the kernel is
    held on the card by ``chip_smoke.py`` phase 3."""
    plan = tkd.kd_plan(rows, v, elem_bytes, True, sms)
    assert plan.design == design, plan
    rng = np.random.default_rng(v)
    ys = (rng.standard_normal((rows, v)) * 3).astype(np.float32)
    yt = (rng.standard_normal((rows, v)) * 3).astype(np.float32)
    if elem_bytes == 2:
        ys, yt = (torch.from_numpy(x).bfloat16().float().numpy()
                  for x in (ys, yt))
    yt[0] = ys[0]                                    # a zero-KL row
    got = _emulate_kernel(ys, yt, temperature, plan)
    assert got[0] == 0
    want = kd_loss_rows_ref(torch.from_numpy(ys), torch.from_numpy(yt),
                            temperature).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=kd_tol(ys, yt, temperature))


# -- the CUDA wrappers and the build --------------------------------------------

def test_cuda_wrappers_reject_cpu_tensors():
    x = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        proto_dist_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        kd_loss_rows_cuda(x, x, 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        proto_dist_cuda(x.double(), x.double())
    with pytest.raises(ValueError, match=r"\[N, P\]"):
        proto_dist_cuda(x, torch.zeros((8, 15)))


def test_new_kernels_are_built_bound_and_counted():
    """Both sources are in the build, their entry points declared for
    ctypes and exported, their counters registered; the CPU dispatch
    launches nothing."""
    for src, name in (("proto_dist.cu", "proto_dist"),
                      ("kd_loss.cu", "kd_loss_rows")):
        assert src in build.SOURCES
        assert name in build.SIGNATURES
        assert f'extern "C" int {name}(' in (build.CSRC / src).read_text()
    assert {"proto_dist", "kd_loss"} <= set(build.launch_counts())
    build.reset_launch_counts()
    x = torch.randn((8, 16))
    tpd_ops.nearest_prototype(x, x[:3], torch.ones(3))
    tkd_ops.kd_loss(x, x.flip(0), 2.0)
    TPR.nearest_prototype_predict(x, x[:3], torch.ones(3))
    assert all(v == 0 for v in build.launch_counts().values())


# -- compute_local_prototypes ---------------------------------------------------

def _small_cfg():
    return jbase.get_config("mnist-cnn").replace(
        cnn_channels=(4, 8), proto_dim=16, dtype="float32")


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


def _carried(jcfg, seed):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, tmodel.params_from_numpy(_np_tree(jp))


@pytest.mark.parametrize("raw", [False, True])
def test_compute_local_prototypes_matches_jax(raw):
    jcfg = _small_cfg()
    jp, tp = _carried(jcfg, 4)
    data = [_images(30 + i, 12) for i in range(3)]
    data[1]["label"][:] = 3                           # classes left unseen
    want_p, want_c = JP.compute_local_prototypes(jcfg, jp, data, 10, raw=raw)
    got_p, got_c = TP.compute_local_prototypes(_tcfg(jcfg), tp, data, 10,
                                               raw=raw)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-6)
    if not raw:
        sums, _ = TP.compute_local_prototypes(_tcfg(jcfg), tp, data, 10,
                                              raw=True)
        np.testing.assert_array_equal(got_p.numpy(), TP.normalize_protos(
            sums, got_c).numpy())


def test_compute_local_prototypes_empty_stream_and_plane():
    jcfg = _small_cfg()
    _, tp = _carried(jcfg, 4)
    tcfg = _tcfg(jcfg)
    for raw in (False, True):
        p, c = TP.compute_local_prototypes(tcfg, tp, [], 10, raw=raw)
        jp_, jc = JP.compute_local_prototypes(jcfg, {}, [], 10, raw=raw)
        assert tuple(p.shape) == (10, 16) and tuple(c.shape) == (10,)
        assert not p.any() and not c.any()
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp_))
    from repro_torch.optim.plane import plane_from_tree
    data = [_images(40, 8)]
    a = TP.compute_local_prototypes(tcfg, tp, data, 10)
    b = TP.compute_local_prototypes(tcfg, plane_from_tree(tp), data, 10)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# -- make_fedavg_step -----------------------------------------------------------

def _fedavg_pair(jcfg, seed, lr=1e-3):
    """JAX's node step and state, and the port's stacked step on a
    one-node stack of the same state."""
    jp, tp = _carried(jcfg, seed)
    jopt, topt = jmake_optimizer("adamw", lr), make_optimizer("adamw", lr)
    jst = JP.NodeState(student=jp, teacher={}, opt_s=jopt.init(jp), opt_t={},
                       global_protos=jnp.zeros((10, jcfg.proto_dim)),
                       proto_mask=jnp.zeros(10),
                       round_idx=jnp.zeros((), jnp.int32))
    tst = TP.stack_states([TP.NodeState(
        student=tp, teacher={}, opt_s=topt.init(tp), opt_t={},
        global_protos=torch.zeros((10, jcfg.proto_dim)),
        proto_mask=torch.zeros(10),
        round_idx=torch.zeros((), dtype=torch.int32))])
    return (JB.make_fedavg_step(jcfg, jopt, remat=False), jst,
            TB.make_fedavg_step(_tcfg(jcfg), topt), tst)


@pytest.mark.parametrize("steps,atol", [(1, 2e-6), (8, 2e-5)])
def test_fedavg_step_matches_jax(steps, atol):
    jcfg = _small_cfg()
    jstep, jst, tstep, tst = _fedavg_pair(jcfg, 6)
    for s in range(steps):
        b = _images(50 + s, 16)
        jst, jm = jstep(jst, b)
        tst, tm = tstep(tst, {k: torch.from_numpy(v)[None]
                              for k, v in b.items()})
        assert tuple(tm["loss_s"].shape) == (1,)
        np.testing.assert_allclose(float(tm["loss_s"][0]),
                                   float(jm["loss_s"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm_s"][0]),
                                   float(jm["grad_norm_s"]), rtol=1e-4)
    for a, b in zip(tree_leaves(tst.student),
                    jax.tree_util.tree_leaves(jst.student)):
        np.testing.assert_allclose(a.detach().numpy()[0], np.asarray(b),
                                   rtol=0, atol=atol)
    assert int(tst.opt_s["step"]) == int(jst.opt_s["step"]) == steps
    assert tst.teacher == {} and tst.opt_t == {}


# -- optim/schedule -------------------------------------------------------------

SCHEDULES = [("constant", (2e-3,)), ("cosine_decay", (1e-3, 50)),
             ("cosine_decay", (1e-3, 0, 0.3)),
             ("warmup_cosine", (1e-3, 10, 60)),
             ("warmup_cosine", (5e-4, 0, 20, 0.0))]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedules_match_jax(name, args):
    jsched, tsched = getattr(JS, name)(*args), getattr(TS, name)(*args)
    for step in (0, 1, 5, 10, 25, 50, 60, 100):
        for tstep, jstep in ((step, step),
                             (torch.tensor(step, dtype=torch.int32),
                              jnp.asarray(step, jnp.int32))):
            got, want = tsched(tstep), jsched(jstep)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       err_msg=f"{name}{args} step {step}")


# -- Claim 4, the slice as a whole ----------------------------------------------

def test_claim4_prototype_inference_matches_jax():
    """``tests/test_system.py``'s Claim 4 through both packages from the
    same carried weights (fp32): 2 local epochs of FedAvg steps on node
    0, Eq. 3 over its data, Eq. 5 on the test split's 240 images."""
    jcfg = jbase.get_config("mnist-cnn").replace(dtype="float32")
    tcfg = _tcfg(jcfg)
    data = jsyn.make_image_dataset(0, 2400, jcfg.input_hw, jcfg.num_classes)
    train_d, test_d = jsyn.train_test_split(data, 0.1, 0)
    parts = jpartition(train_d["label"], 4, "iid", 0)
    node = {k: v[parts[0]] for k, v in train_d.items()}
    n = len(node["label"])
    jstep, jst, tstep, tst = _fedavg_pair(jcfg, 0)
    for _ in range(2):
        for b, idx in zip(jbatches(node, 64, seed=0),
                          batch_index_lists(n, 64, 0)):
            jst, _ = jstep(jst, b)
            tst, _ = tstep(tst, {k: torch.from_numpy(v[idx])[None]
                                 for k, v in node.items()})
    params = TP.node_params(tst.student, 0)         # the one-node stack's
    jprotos, jcounts = JP.compute_local_prototypes(
        jcfg, jst.student, jbatches(node, 64, seed=1), 10)
    protos, counts = TP.compute_local_prototypes(
        tcfg, params, ({k: v[idx] for k, v in node.items()}
                            for idx in batch_index_lists(n, 64, 1)), 10)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(protos.numpy(), np.asarray(jprotos),
                               rtol=1e-3, atol=1e-4)
    mask = (counts > 0).float()
    with torch.no_grad():
        f1 = tmodel.forward(tcfg, params,
                            {"image": torch.from_numpy(test_d["image"])}).f1
    jf1 = jmodel.forward(jcfg, jst.student, test_d).f1
    preds = TPR.nearest_prototype_predict(f1, protos, mask).numpy()
    jpreds = np.asarray(JPR.nearest_prototype_predict(
        jf1, jprotos, jnp.asarray(mask.numpy())))
    d2 = np.asarray(JPR.pairwise_sq_dists(jf1, jprotos))
    clear = _top2_gap(d2) > PRED_GAP * d2.max()
    print(f"Claim 4: {int((~clear).sum())} of {len(clear)} rows within the "
          f"tie band")
    assert clear.mean() > 0.97
    np.testing.assert_array_equal(preds[clear], jpreds[clear])
    acc = float(np.mean(preds == test_d["label"]))
    jacc = float(np.mean(jpreds == test_d["label"]))
    assert acc > 0.5, f"nearest-prototype accuracy {acc} (JAX {jacc})"
