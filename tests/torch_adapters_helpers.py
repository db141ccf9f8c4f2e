"""The shared helpers of the adapter-rank wire tests
(tests/test_torch_adapters.py, test_torch_adapter_merge.py).

The port's adapter-rank wire, held against the JAX package on the CPU.

Every case feeds the same numpy inputs, made from a seed, to the JAX
function and to its port.  Tolerances and why:

* the layout (names, ``is_mat``, shapes) and the threefry bits behind Ω
  exactly; Ω itself within 4 ulp (numpy's fp32 ``log1p`` and XLA's round
  differently in the last bits of the ``erfinv`` argument);
* ``orthonormalize`` on the same sketch ``rtol=1e-5``; the factors of a
  delta (which also see Ω's few-ulp gap) and the gram carry ``rtol=1e-5``
  with ``atol`` 1e-5 of the array's largest entry (entries near zero
  have no relative precision); a zero delta gives exactly zero factors;
* ``regmean_adjust`` ``rtol=1e-4`` (the ridge amplifies last-bit
  differences of the solve's inputs up to ~1e3);
* the plain ``lowrank_apply`` against JAX's ``ref.py`` and the
  interpret-mode Pallas kernel ``rtol=1e-6`` (an ulp of ``w + delta``)
  and ``atol`` 1e-6 of the largest delta entry (those sum each
  ``B @ A`` in XLA's order, with fused multiply-adds);
* the per-leaf tree codec: codes, scales and the reconstruction bit for
  bit (the same sweeps on the same buffer);
* share / merge on a stacked student: factors as above, the merged plane
  ``atol=2e-6`` (naive) or 1e-4 of the merge's largest step (RegMean, as
  ``regmean_adjust``);
* whole runs from carried states: bytes exactly, node 0's F1 and
  accuracy exactly in fp32, the student plane after each round within
  ``RUN_ATOL`` (see there); with the factor groups at their own widths,
  a bounded count of factor code flips and, beyond ``RUN_ATOL``, what
  those flips can move the merge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import base as jbase
from repro.core import round_ops as jround
from repro.models import model as jmodel
from repro.optim import plane as jplane
from repro_torch.config import base as tbase
from repro_torch.core import aggregation as tagg
from repro_torch.core import federation as TF
from repro_torch.core import profe as tprofe
from repro_torch.core import round_ops as tround
from repro_torch.data import make_image_dataset, partition, train_test_split
from repro_torch.models import init_params
from repro_torch.optim.plane import Plane, _leaf_view, plane_from_tree
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(2)

N_NODES = 4


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _close(got, want, rtol=1e-5, scale=1e-5):
    """``rtol`` plus an ``atol`` of ``scale`` times the largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


# -- layout and Ω -------------------------------------------------------------

def _student_shapes(model):
    if model == "mnist":
        cfg = jbase.get_config("mnist-cnn")
    else:
        cfg = jbase.get_config("cifar10-resnet18").replace(
            resnet_blocks=(2, 2), resnet_width=16)
    jscfg = jmodel.derive_student(cfg)
    jtree = jax.eval_shape(lambda: jmodel.init_params(jscfg,
                                                      jax.random.PRNGKey(0)))
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jscfg))
    ttree = init_params(tcfg, torch.Generator().manual_seed(0))
    return jtree, ttree


# -- lowrank_apply ------------------------------------------------------------

def _apply_inputs(seed, n, s, lead, d, k, r, per_recv):
    rng = _rng(seed)
    w = _normal(rng, n, *lead, d, k)
    coeffs = (rng.random((n, s)) / s).astype(np.float32)
    b = _normal(rng, s, *lead, d, r, scale=0.3)
    a = _normal(rng, *((n,) if per_recv else ()), s, *lead, r, k, scale=0.1)
    return w, coeffs, b, a


# -- the per-leaf tree codec ---------------------------------------------------

def _adapter_payload(seed, grams=False):
    """A stacked adapter-wire payload: factors of a conv and a matrix
    leaf, prototypes, the dense rest (and grams)."""
    rng = _rng(seed)
    pay = {
        "adapters": {
            "['conv2']['kernel']": {"A": _normal(rng, N_NODES, 3, 3, 8, 16),
                                    "B": _normal(rng, N_NODES, 3, 3, 12, 8)},
            "['fc1']['kernel']": {"A": _normal(rng, N_NODES, 8, 16),
                                  "B": _normal(rng, N_NODES, 300, 8)}},
        "protos": _normal(rng, N_NODES, 10, 16, scale=0.1),
        "student": {"['conv1']['bias']": _normal(rng, N_NODES, 12),
                    "['fc1']['bias']": _normal(rng, N_NODES, 16) * 0}}
    if grams:
        pay["grams"] = {"['conv2']['kernel']":
                        _normal(rng, N_NODES, 3, 3, 16, 16),
                        "['fc1']['kernel']": _normal(rng, N_NODES, 16, 16)}
    return pay


def _to(tree, fn):
    return jax.tree_util.tree_map(fn, tree)


# -- share and merge on a stacked student ------------------------------------

def _stacked_student(seed, channels=(24, 32), proto_dim=16):
    """A node-stacked student as numpy leaves, the port's plane and
    JAX's plane of them."""
    cfg = tbase.get_config("mnist-cnn").replace(cnn_channels=channels,
                                                proto_dim=proto_dim)
    scfg = TF.derive_student(cfg)
    trees = [init_params(scfg, torch.Generator().manual_seed(seed + i))
             for i in range(N_NODES)]
    paths = [p for p, _ in tree_paths(trees[0])]
    leaves = [np.stack([_np(x) for x in xs])
              for xs in zip(*map(tree_leaves, trees))]
    planes = [plane_from_tree(t) for t in trees]
    tplane = Plane(torch.stack([p.buf for p in planes]), planes[0].meta)
    jtree = {}
    for p, x in zip(paths, leaves):
        jtree.setdefault(p[0], {})[p[1]] = jnp.asarray(x)
    return leaves, tplane, jax.vmap(jplane.plane_from_tree)(jtree)


# -- whole runs ----------------------------------------------------------------

def _setup(rounds=2, per_node=48, batch=16, **fed_extra):
    """mnist-cnn with teacher channels (24, 32) and proto_dim 16, so that
    its student factors conv2 (3x3 lead), fc1 and fc2 at rank 8."""
    jcfg = jbase.get_config("mnist-cnn").replace(
        cnn_channels=(24, 32), proto_dim=16, dtype="float32")
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    data = make_image_dataset(0, N_NODES * per_node + 64, (28, 28, 1), 10)
    train_d, test_d = train_test_split(data, 64 / len(data["label"]), 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed_kw = dict(num_nodes=N_NODES, rounds=rounds, topology="full",
                  quantize_bits=4, adapter_rank=8, **fed_extra)
    train_kw = dict(batch_size=batch, remat=False)
    return (jcfg, tcfg, node_data, test_d,
            jbase.FederationConfig(**fed_kw), tbase.FederationConfig(**fed_kw),
            jbase.TrainConfig(**train_kw), tbase.TrainConfig(**train_kw))


def _carry(st):
    return tprofe.node_state_from_numpy(
        _to(jplane.as_tree(st.student), np.asarray),
        _to(st.teacher, np.asarray), _to(st.opt_s, np.asarray),
        _to(st.opt_t, np.asarray), np.asarray(st.global_protos),
        np.asarray(st.proto_mask), int(st.round_idx), device="cpu")


def _recording(make_round_fn, planes):
    """Wrap a package's ``_make_round_fn``: record the student plane
    after every round."""
    def make(*args, **kwargs):
        fn = make_round_fn(*args, **kwargs)

        def round_fn(state, *inputs, **kw):
            out = fn(state, *inputs, **kw)
            planes.append(_np(out.student.buf))
            return out
        return round_fn
    return make


# The student plane after each round, fp32.  The adapter factors ride
# int4: one code step is max|A| / 7 or max|B| / 7, so a code that flips
# between the frameworks (the trained students differ by a few ulp, Ω by
# a few ulp) would move a merged weight by ~1e-3; none flips in the
# naive run, and the three conv2 B codes that flip in the RegMean run's
# second round stay inside its REGMEAN_RTOL term.
# Naive merge: the planes differ by those last bits carried through the
# factorization and the merge — RUN_ATOL.  RegMean: the ridge of the
# solve amplifies the same gaps up to ~1e3 (REGMEAN_EPS), so the planes
# are held to RUN_ATOL plus REGMEAN_RTOL of the round's largest step
# |plane after - plane before| (largest gap seen 2.6e-4 of it).
RUN_ATOL = 2e-6
REGMEAN_RTOL = 1e-3
# With their own widths (8-bit factors, 16-bit grams) the factor codes
# are 18x finer than int4, and factors whose last bits differ between
# the frameworks now and then round to neighbouring codes: one code step,
# 1/127 of the sender's largest entry of that factor.  Such flips are
# counted per round (an entry that differs by more than FLIP_REL of its
# sender's largest; at most MAX_ADAPTER_FLIPS of the ~3.5e4 factor
# codes, 41 seen), and the planes may differ beyond the bound above by
# what the two received views' difference can move the merge
# (_merge_allowance), carried into the later rounds.
FLIP_REL = 1e-3
MAX_ADAPTER_FLIPS = 64


def _record_views(monkeypatch):
    """Record each round's receiver-side factors (and grams) of both
    packages as numpy (``repro``'s from inside its jitted round)."""
    jviews, tviews = [], []
    jqdq = jround.quantize_dequantize_per_node
    tqdq = tround.quantize_dequantize_per_node

    def keep(views, out):
        views.append({g: _to(out[g], np.array)
                      for g in ("adapters", "grams") if g in out})

    def jwrap(tree, *args, **kwargs):
        out = jqdq(tree, *args, **kwargs)
        jax.debug.callback(lambda o: keep(jviews, o), out)
        return out

    def twrap(tree, *args, **kwargs):
        out = tqdq(tree, *args, **kwargs)
        keep(tviews, out)
        return out
    monkeypatch.setattr(jround, "quantize_dequantize_per_node", jwrap)
    monkeypatch.setattr(tround, "quantize_dequantize_per_node", twrap)
    return jviews, tviews


def _count_flips(tview, jview):
    """Factor entries of one round's received views that differ by more
    than ``FLIP_REL`` of their sender's largest entry."""
    flips = 0
    for name, f in jview["adapters"].items():
        for key, want in f.items():
            s = want.shape[0]
            gap = np.abs(tview["adapters"][name][key] - want).reshape(s, -1)
            top = np.abs(want).reshape(s, -1).max(axis=1, keepdims=True)
            flips += int(np.count_nonzero(gap > FLIP_REL * top))
    return flips


def _merge_allowance(tview, jview, coeffs, meta, names, grams, like):
    """How far the two merges of one round may differ, per plane lane,
    because their received views differ: per receiver ``i`` and matrix
    leaf, ``Σ_j c_ij·(|B_j - B'_j| @ |Ã_ij| + |B'_j| @ |Ã_ij - Ã'_ij|)``
    (``Ã`` = ``A``, or the port's RegMean adjustment of each view)."""
    c = torch.as_tensor(coeffs, dtype=torch.float32)
    allow = torch.zeros(like.shape, dtype=torch.float64)
    for name, (_, _, shape, row, r_leaf) in zip(names, meta.recipe):
        if name not in jview["adapters"]:
            continue
        bt, at, bj, aj = (torch.as_tensor(v["adapters"][name][key])
                          for v in (tview, jview) for key in ("B", "A"))
        if grams:
            at = tagg.regmean_adjust(at, torch.as_tensor(tview["grams"][name]),
                                     c, per_recv=False)
            aj = tagg.regmean_adjust(aj, torch.as_tensor(jview["grams"][name]),
                                     c, per_recv=False)
        else:
            at, aj = at[None], aj[None]         # shared by every receiver
        at, aj, bt, bj = (x.double() for x in (at, aj, bt, bj))
        per = (bt - bj).abs() @ at.abs() + bj.abs() @ (at - aj).abs()
        per = per.expand((c.shape[0],) + tuple(per.shape[1:]))
        _leaf_view(allow, shape, row, r_leaf).copy_(
            torch.einsum("is,is...->i...", c.double(), per))
    return allow.numpy()
