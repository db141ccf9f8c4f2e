"""Adapter-rank wire: low-rank delta factors for the gossip payload.

With ``FederationConfig.adapter_rank = r > 0`` each *matrix* leaf of the
student gossips the low-rank factors of its per-round delta instead of
its full value,

    Δ = W − W_ref,    B = Q(QR(Δ Ω)) ∈ [d, r],    A = Bᵀ Δ ∈ [r, k],

so the wire carries O(r·(d+k)) per matrix (the ``"adapters"`` payload
group) plus the dense non-matrix rest (the ``"student"`` group).  Ω is a
fixed per-leaf Gaussian basis, a pure function of the leaf name: every
node sketches into the same subspace and ``B @ A = Q Qᵀ Δ``.

``W_ref`` is the round-start student, carried per node as
``NodeState.adapter_state = {"ref": {leaf: W}, ["grams": {leaf: G}]}``.
Receivers merge ``W ← W + Σ_j c_ij · B_j @ Ã_j`` through
``kernels/lowrank_apply`` (RegMean-adjusted ``Ã`` when grams ride the
wire, ``core/aggregation.py``).  With grams, ``G ← GRAM_EMA·G_prev +
AᵀA`` accumulates the row-space gram of the transmitted deltas.

A leaf is factored iff it is a float array whose trailing two dims both
exceed ``r``; leading axes (a conv kernel's 3×3) are batch.  This module
follows ``repro``'s ``core/adapters.py``.  Its Ω comes from the same
counter-based generator as ``jax.random.normal`` (threefry2x32, key
``fold_in(PRNGKey(0xADA), crc32(name))``), written here in numpy, so the
two packages sketch every leaf into the same basis.
"""
from __future__ import annotations

import functools
import zlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.prng import _fold_in, _random_bits
from repro_torch.tree import (ShapeDtypeStruct, is_float, keystr,
                              tree_empties, tree_from_paths, tree_map,
                              tree_paths)

# decay on the carried gram statistic: G <- GRAM_EMA * G_prev + A^T A
GRAM_EMA = 0.5

_OMEGA_SEED = 0xADA
_TINY = float(np.finfo(np.float32).tiny)


class AdapterLayout(NamedTuple):
    """Static partition of one student tree: which flatten-order leaves
    ride the adapter wire.  ``names`` are ``keystr`` paths (the wire-dict
    keys and Ω's seeds), ``paths`` the tree paths they render, ``shapes``
    the logical (node-axis-free) leaf shapes."""
    paths: Tuple[Tuple, ...]
    names: Tuple[str, ...]
    is_mat: Tuple[bool, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    rank: int
    # the tree's empty subtrees (tree_empties), for merge_student
    empties: Tuple = ()

    @property
    def mat_names(self) -> Tuple[str, ...]:
        return tuple(n for n, m in zip(self.names, self.is_mat) if m)

    @property
    def n_mats(self) -> int:
        return sum(self.is_mat)


def is_adapter_shape(shape, rank: int) -> bool:
    """Factored iff the trailing two dims are both > r; leading axes are
    batch."""
    return len(shape) >= 2 and min(shape[-2:]) > rank


def adapter_layout(tree, rank: int, *, node_axis: bool = False
                   ) -> AdapterLayout:
    """The layout of a student tree (tensors or ``ShapeDtypeStruct``s;
    ``node_axis=True`` skips a leading ``[N]`` axis)."""
    skip = 1 if node_axis else 0
    paths, names, is_mat, shapes = [], [], [], []
    for path, leaf in tree_paths(tree):
        shape = tuple(int(s) for s in leaf.shape)[skip:]
        floaty = hasattr(leaf, "dtype") and is_float(leaf)
        paths.append(path)
        names.append(keystr(path))
        is_mat.append(bool(floaty and is_adapter_shape(shape, rank)))
        shapes.append(shape)
    return AdapterLayout(tuple(paths), tuple(names), tuple(is_mat),
                         tuple(shapes), int(rank), tree_empties(tree))


def split_student(layout: AdapterLayout, tree
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The tree's leaves as (matrix dict, rest dict), keyed by name."""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    assert len(leaves) == len(layout.names)
    mats = {n: x for n, x, m in zip(layout.names, leaves, layout.is_mat)
            if m}
    rest = {n: x for n, x, m in zip(layout.names, leaves, layout.is_mat)
            if not m}
    return mats, rest


def merge_student(layout: AdapterLayout, mats: Dict[str, Any],
                  rest: Dict[str, Any]):
    """Inverse of :func:`split_student`."""
    return tree_from_paths(
        ((p, mats[n] if m else rest[n])
         for p, n, m in zip(layout.paths, layout.names, layout.is_mat)),
        layout.empties)


# -- Ω: jax.random.normal's numbers from the threefry bits of repro_torch.prng

# XLA's ErfInv32 polynomial (Giles), for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """fp32 ``erfinv`` as XLA computes it (``ErfInv32``)."""
    f32 = np.float32
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, f32(c_lt), f32(c_ge)) + p * w
    out = p * x
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, out)


def _normal(key: Tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.normal(key, (n,), float32)``: a uniform on
    ``[nextafter(-1, 0), 1)`` from the top 23 bits, then
    ``sqrt(2)·erfinv(u)``, all in fp32."""
    f32 = np.float32
    bits = _random_bits(key, n)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f32) - f32(1)
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = np.maximum(lo, f * (f32(1.0) - lo) + lo)
    return f32(np.sqrt(2)) * _erfinv32(u)


@functools.lru_cache(maxsize=None)
def _omega_on(name: str, k: int, rank: int, device) -> torch.Tensor:
    seed = zlib.crc32(name.encode()) & 0x7FFFFFFF
    key = _fold_in((0, _OMEGA_SEED), seed)
    om = _normal(key, k * rank).reshape(k, rank) / np.float32(np.sqrt(k))
    return torch.from_numpy(om.astype(np.float32)).to(device)


def _omega(name: str, k: int, rank: int, device="cpu") -> torch.Tensor:
    """The fixed projection basis Ω ``[k, r]`` of one matrix leaf — a
    pure function of its name, ``repro``'s ``_omega`` (within a few
    ulp: the two ``log1p`` round differently).  Made once per device:
    a round's factorization copies nothing to the card."""
    return _omega_on(name, int(k), int(rank), torch.device(device))


# -- factors ------------------------------------------------------------------

def orthonormalize(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the sketch columns (leading batch axes
    broadcast) by two-pass modified Gram-Schmidt, column by column; an
    exactly-zero column stays zero (the ``tiny`` guard)."""
    cols = []
    for j in range(int(y.shape[-1])):
        v = y[..., j]
        for _ in range(2):
            for q in cols:
                v = v - torch.sum(q * v, dim=-1, keepdim=True) * q
        nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        cols.append(v / torch.clamp_min(nrm, _TINY))
    return torch.stack(cols, dim=-1)


def factorize_delta(delta: torch.Tensor, name: str, rank: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomized QB of one delta (leading axes broadcast):
    ``B = Q(QR(Δ Ω))``, ``A = Bᵀ Δ``."""
    om = _omega(name, int(delta.shape[-1]), rank, delta.device)
    q = orthonormalize(delta @ om)                    # [..., d, r]
    return q, q.transpose(-1, -2) @ delta             # [..., r, k]


def factorize_deltas(layout: AdapterLayout, mats: Dict[str, Any],
                     refs: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``{leaf: {"A": [.., r, k], "B": [.., d, r]}}`` of ``W − W_ref``."""
    out = {}
    for n in layout.mat_names:
        b, a = factorize_delta(mats[n] - refs[n], n, layout.rank)
        out[n] = {"A": a, "B": b}
    return out


def gram_update(factors: Dict[str, Dict[str, Any]],
                prev: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Row-space gram carry: ``G ← GRAM_EMA·G_prev + AᵀA`` per leaf."""
    out = {}
    for n, f in factors.items():
        a = f["A"]
        g = a.transpose(-1, -2) @ a                   # [..., k, k]
        if prev is not None:
            g = g + GRAM_EMA * prev[n]
        out[n] = g
    return out


def init_adapter_state(layout: AdapterLayout, tree, *,
                       grams: bool = False) -> Dict[str, Any]:
    """Zero-round adapter carry: the reference matrices and, with
    ``grams``, zero gram statistics.  The references are copies: the
    port updates the student plane in place, and a view of it would
    follow the weights and zero every later Δ."""
    mats, _ = split_student(layout, tree)
    state: Dict[str, Any] = {"ref": {n: v.detach().float().clone()
                                     for n, v in mats.items()}}
    if grams:
        state["grams"] = {
            n: torch.zeros(tuple(v.shape[:-2]) + (int(v.shape[-1]),) * 2,
                           dtype=torch.float32, device=v.device)
            for n, v in mats.items()}
    return state


def zero_wire_payload(layout: AdapterLayout, tree, *, grams: bool = False
                      ) -> Dict[str, Any]:
    """Zero-filled model-side wire groups of one share — ``{"adapters",
    "student" [, "grams"]}`` with the tree's leading (node) axes kept."""
    mats, rest = split_student(layout, tree)
    adapters, gram_z = {}, {}
    for n in layout.mat_names:
        m = mats[n]
        lead, (d, k) = tuple(m.shape[:-2]), tuple(m.shape[-2:])

        def z(shape):
            return torch.zeros(shape, dtype=torch.float32, device=m.device)
        adapters[n] = {"A": z(lead + (layout.rank, k)),
                       "B": z(lead + (d, layout.rank))}
        gram_z[n] = z(lead + (k, k))
    out: Dict[str, Any] = {
        "adapters": adapters,
        "student": tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=x.device), rest)}
    if grams:
        out["grams"] = gram_z
    return out


def adapter_payload_template(layout: AdapterLayout, *, grams: bool
                             ) -> Dict[str, Any]:
    """Per-copy shape/dtype skeleton of the adapter payload groups (what
    the comm accountants meter): ``{"adapters": {leaf: {"A", "B"}}
    [, "grams": {leaf: G}]}``."""
    f32 = np.dtype(np.float32)
    adapters, gram_t = {}, {}
    for n, m, shape in zip(layout.names, layout.is_mat, layout.shapes):
        if not m:
            continue
        lead, (d, k) = tuple(shape[:-2]), tuple(shape[-2:])
        r = layout.rank
        adapters[n] = {"A": ShapeDtypeStruct(lead + (r, k), f32),
                       "B": ShapeDtypeStruct(lead + (d, r), f32)}
        gram_t[n] = ShapeDtypeStruct(lead + (k, k), f32)
    out: Dict[str, Any] = {"adapters": adapters}
    if grams:
        out["grams"] = gram_t
    return out
