"""Vectorized federation-round math on stacked ``[N, ...]`` node state.

* ``gossip_matrix`` / ``include_matrix`` — the topology schedule lowered
  to mixing and Eq. 4 include weights, in numpy float64 and cast to fp32
  (host-side, once per run); ``gossip_matrix_dyn`` — the same weights in
  fp32 tensor ops from runtime ``sizes`` (the mesh round's).
* ``quantize_leaf_per_node`` / ``dequantize_leaf`` — Sec. III-D wire
  quantization of each node slice of a stacked leaf on its own (one
  scale per node per tensor), shape-preserving.
* ``quantize_dequantize_per_node`` — the receiver-side reconstruction of
  a round's wire payload through the packed node codec (stateless, or
  with the error-feedback ``CodecState``), or with ``packed=False``
  through the per-leaf reference codec it is held to.
* ``weighted_node_mean`` — the global size-weighted mean over nodes.
* ``mix_node_trees`` — size-weighted gossip: a node's own copy mixes
  unquantized, its neighbours' from the dequantized view.
* ``neighborhood_prototype_aggregate`` — Eq. 4 per node neighbourhood.
* ``adapter_share_nodes`` / ``adapter_merge_nodes`` — the adapter-rank
  wire: factorize each node's round delta, then merge the received
  low-rank deltas onto every receiver (``core/adapters.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import _INT_DTYPES, _qmax
from repro_torch.kernels.quantize.ref import as_codes
from repro_torch.tree import (is_float, tree_leaves, tree_map,
                              tree_map_with_path)
from repro_torch.wirespec import WireSpec


def _is_float(x) -> bool:
    return hasattr(x, "dtype") and is_float(x)


def gossip_matrix(adj: np.ndarray, sizes) -> Tuple[np.ndarray, np.ndarray]:
    """Dataset-size-weighted neighbourhood-mean weights for a static
    ``[N, N]`` adjacency or a round-stacked ``[R, N, N]`` schedule:
    ``(w_self, w_neigh)`` with ``w_self[i] + sum_j w_neigh[i, j] == 1``,
    computed in float64 and returned as fp32 numpy arrays."""
    a = np.asarray(adj, np.float64)
    s = np.asarray(sizes, np.float64)
    squeeze = a.ndim == 2
    if squeeze:
        a = a[None]
    w = a * s[None, None, :]
    denom = w.sum(axis=2) + s[None, :]      # own weight included
    denom = np.maximum(denom, 1e-30)
    w_neigh = w / denom[:, :, None]
    w_self = s[None, :] / denom
    if squeeze:
        w_self, w_neigh = w_self[0], w_neigh[0]
    return w_self.astype(np.float32), w_neigh.astype(np.float32)


def gossip_matrix_dyn(adj: np.ndarray, sizes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gossip_matrix` in fp32 tensor ops, for the mesh round: a
    static 0/1 ``[N, N]`` adjacency and the ``[N]`` dataset sizes it
    receives at run time.  Returns ``(w_self [N], w_neigh [N, N])`` on
    ``sizes``' device."""
    s = sizes.to(torch.float32)
    a = torch.as_tensor(np.asarray(adj, np.float32), device=s.device)
    w = a * s[None, :]
    denom = torch.clamp_min(w.sum(dim=1) + s, 1e-30)
    return s / denom, w / denom[:, None]


def include_matrix(adj: np.ndarray) -> np.ndarray:
    """adj + self-loops as fp32 ``[N, N]`` (or ``[R, N, N]``): who
    contributes prototypes to whom."""
    m = np.asarray(adj, np.float64) + np.eye(np.asarray(adj).shape[-1])
    return np.minimum(m, 1.0).astype(np.float32)


def quantize_leaf_per_node(x, bits: int):
    """``x [N, ...]`` float -> ``(codes intN [N, ...], scales fp32 [N])``:
    each node's slice quantized on its own, in the narrowest int
    container that holds ``bits``.  qmax divides as an fp32 tensor on
    ``x``'s device (an IEEE division on the card too)."""
    qm = torch.tensor(float(_qmax(bits)), dtype=torch.float32,
                      device=x.device)
    a = torch.abs(x.to(torch.float32))
    amax = a if x.dim() == 1 else torch.amax(a, dim=tuple(range(1, x.dim())))
    delta = torch.clamp_min(amax / qm, torch.finfo(torch.float32).tiny)
    bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
    codes = torch.floor(x.to(torch.float32) / delta.reshape(bshape) + 0.5)
    return as_codes(torch.clamp(codes, -qm - 1, qm), _INT_DTYPES[bits]), \
        delta


def dequantize_leaf(codes, delta):
    """``codes [N, ...]`` int, ``delta [N]`` fp32 -> fp32 ``[N, ...]``."""
    bshape = (codes.shape[0],) + (1,) * (codes.dim() - 1)
    return codes.to(torch.float32) * delta.reshape(bshape)


def _roundtrip_leaf(x, bits: int):
    return dequantize_leaf(*quantize_leaf_per_node(x, bits))


def _quantize_dequantize_per_leaf(tree, bits: int, spec, state):
    """``packed=False``: the per-leaf reference codec.  A ``Plane`` is
    one float leaf, its ``[N, R, 512]`` buffer (one segment per node, as
    ``repro`` flattens a Plane to its buffer), and comes back a Plane.
    Error feedback runs ``ef_quantize_dequantize_tree`` per node slice; a
    mixed-width spec the per-leaf math at each leaf's group width; a
    uniform width the packed tree codec (``rowabs`` +
    ``quantize_dequantize_rows``) on the card and the per-leaf math on
    the CPU."""
    from repro_torch.kernels.quantize.ops import (
        _leaf_group, quantize_dequantize_tree_packed)
    from repro_torch.optim.plane import Plane

    def bufs(t):
        return tree_map(lambda x: x.buf if isinstance(x, Plane) else x, t)

    def replane(out, like):
        return tree_map(lambda x, o: Plane(o, x.meta)
                        if isinstance(x, Plane) else o, like, out)

    flat = bufs(tree)
    if state is not None:
        from repro_torch.core.wire_state import (CodecState,
                                                 ef_quantize_dequantize_tree)
        recv, new = ef_quantize_dequantize_tree(
            flat, spec if spec is not None else WireSpec.from_bits(bits),
            CodecState(bufs(state.residual), state.seq), node_axis=True)
        return replane(recv, tree), CodecState(
            replane(new.residual, state.residual), new.seq)
    if spec is not None and spec.uniform_bits is None:
        out = tree_map_with_path(
            lambda path, x: _roundtrip_leaf(
                x, spec.bits_for(_leaf_group(path))) if _is_float(x) else x,
            flat)
    elif any(_is_float(x) and x.is_cuda for x in tree_leaves(flat)):
        out = quantize_dequantize_tree_packed(flat, bits, node_axis=True)
    else:
        out = tree_map(lambda x: _roundtrip_leaf(x, bits)
                       if _is_float(x) else x, flat)
    return replane(out, tree)


def quantize_dequantize_per_node(tree, bits: int = 16, *,
                                 spec: Optional[WireSpec] = None,
                                 packed: bool = True, rng=None, state=None):
    """Receiver-side reconstruction of a stacked wire payload through the
    packed node codec: ``{"protos": [N, C, P], "student": Plane}`` splices
    the student's rows off its plane; any other tree (the adapter wire's
    ``{"adapters", "protos", "student": rest[, "grams"]}``) packs leaf by
    leaf.

    ``state`` (a :class:`~repro_torch.core.wire_state.CodecState`,
    required when ``spec.error_feedback`` is set) switches either
    payload to the error-feedback codec and returns ``(reconstruction,
    new_state)``, with ``seq`` advanced by one; its residual mirrors the
    payload (a plane-backed ``student`` residual is a Plane, any other a
    tree of the payload's float leaves).

    ``packed=False`` runs the per-leaf reference codec instead
    (:func:`_quantize_dequantize_per_leaf`), which the packed codec is
    bit-identical to for the same segments.

    ``rng`` (a threefry key, :mod:`repro_torch.prng`) rounds
    stochastically in the packed codec (``kernels/quantize/ops.py``
    ``quantize_packed_buffer``): the codes are ``repro``'s for the same
    key.  A spec with ``stochastic_rounding`` needs it, and
    ``packed=False`` refuses it (``repro``'s per-leaf path would ignore
    a key)."""
    from repro_torch.core.wire_state import CodecState, next_seq
    from repro_torch.kernels.quantize.ops import (
        quantize_dequantize_plane_payload,
        quantize_dequantize_tree_packed_nodes)
    from repro_torch.optim.plane import Plane
    if spec is not None and spec.error_feedback and state is None:
        raise ValueError("WireSpec.error_feedback is set but no CodecState "
                         "was passed: the error-feedback codec needs the "
                         "carried per-node residual")
    stochastic = rng is not None or (spec is not None
                                     and spec.stochastic_rounding)
    if stochastic and not packed:
        raise ValueError("the per-leaf reference path does not implement "
                         "stochastic rounding: use the packed codec "
                         "(silently rounding deterministically would fake "
                         "the unbiasedness)")
    if spec is not None and spec.uniform_bits is not None:
        bits = spec.uniform_bits
    if not packed:
        return _quantize_dequantize_per_leaf(tree, bits, spec, state)
    if not (isinstance(tree, dict) and isinstance(tree.get("student"),
                                                  Plane)):
        if state is None:
            return quantize_dequantize_tree_packed_nodes(tree, bits,
                                                         spec=spec, rng=rng)
        recv, new_res = quantize_dequantize_tree_packed_nodes(
            tree, bits, spec=spec, rng=rng, residual=state.residual)
        return recv, CodecState(new_res, seq=next_seq(state.seq))
    if state is None:
        return quantize_dequantize_plane_payload(tree, bits, spec=spec,
                                                 rng=rng)
    recv, new_res = quantize_dequantize_plane_payload(
        tree, bits, spec=spec, rng=rng, residual=state.residual)
    return recv, CodecState(new_res, seq=next_seq(state.seq))


def mix_node_trees(w_self, w_neigh, own_tree, recv_tree):
    """Per-node weighted mean over the node axis:
    ``w_self[i]·own[i] + Σ_j w_neigh[i,j]·recv[j]`` for every tensor of
    the trees (a Plane mixes its whole buffer)."""
    from repro_torch.optim.plane import Plane
    from repro_torch.tree import tree_map

    def mix(own, recv):
        mixed = torch.tensordot(w_neigh, recv.float(), dims=1)
        bshape = (own.shape[0],) + (1,) * (own.dim() - 1)
        mixed = mixed + w_self.reshape(bshape) * own.float()
        return mixed.to(own.dtype)
    if isinstance(own_tree, Plane):
        return Plane(mix(own_tree.buf, recv_tree.buf), own_tree.meta)
    return tree_map(mix, own_tree, recv_tree)


def weighted_node_mean(w, tree):
    """Global size-weighted mean over the node axis: leaf ``[N, ...]`` ->
    ``[...]`` (every node receives the same aggregate, the full graph's
    special case)."""
    w32 = w.float()
    return tree_map(lambda x: torch.tensordot(w32, x.float(), dims=1), tree)


def neighborhood_prototype_aggregate(include, protos, counts):
    """Eq. 4 for every node's neighbourhood at once.

    include ``[N, N]`` 0/1 (who node i listens to, itself included),
    protos ``[N, C, P]`` (the receiver-side view), counts ``[N, C]``.
    Returns ``(global_protos [N, C, P], proto_mask [N, C])``."""
    eff = include[:, :, None] * counts[None, :, :]          # [N, N, C]
    n_j = torch.sum(eff, dim=1)                             # [N, C]
    w = eff / torch.clamp_min(n_j, 1.0)[:, None, :]         # [N, N, C]
    glob = torch.einsum("ijc,jcp->icp", w, protos.float())
    mask = (n_j > 0).float()
    return glob, mask


# -- adapter-rank wire --------------------------------------------------------

def adapter_share_nodes(student, adapter_state, *, rank: int,
                        grams: bool = False):
    """Share side of the adapter wire over stacked ``[N, ...]`` state:
    factorize this round's per-matrix deltas against the carried
    reference, snapshot the reference forward to the current weights
    (copies: the plane is updated in place later), and with ``grams``
    advance the gram statistics.

    Returns ``(payload_groups, new_adapter_state, layout)`` with
    ``payload_groups = {"adapters": {leaf: {"A", "B"}}, "student":
    rest-dict [, "grams": {leaf: G}]}``."""
    from repro_torch.core.adapters import (adapter_layout, factorize_deltas,
                                           gram_update, split_student)
    from repro_torch.optim.plane import as_tree
    tree = as_tree(student)
    layout = adapter_layout(tree, rank, node_axis=True)
    mats, rest = split_student(layout, tree)
    factors = factorize_deltas(layout, mats, adapter_state["ref"])
    groups = {"adapters": factors, "student": rest}
    new_state = {"ref": {n: m.detach().clone() for n, m in mats.items()}}
    if grams:
        g = gram_update(factors, adapter_state.get("grams"))
        groups["grams"] = g
        new_state["grams"] = g
    return groups, new_state, layout


def adapter_merge_nodes(student, recv, w_self, w_neigh, *, rank: int,
                        grams: bool = False):
    """Merge side of the adapter wire: every receiver adds its
    neighbours' reconstructed low-rank deltas onto its own current
    weights, ``W_i ← W_i + Σ_j w_neigh[i, j]·B_j @ Ã_j`` (no self term:
    the receiver's own training delta is already in ``W_i``), while the
    dense rest keeps the gossip mean (own copy unquantized).  ``recv`` is
    the receiver-side view ``{"adapters", "student" [, "grams"]}``; with
    grams the factors are RegMean-adjusted per receiver.  A stacked
    student ``Plane`` is merged IN PLACE through ``kernels/lowrank_apply``
    and returned; a per-leaf student tree gives a new merged tree
    (``adapter_apply_tree``, the same kernel a matrix leaf)."""
    from repro_torch.core.adapters import adapter_layout, split_student
    from repro_torch.kernels.lowrank_apply.ops import (adapter_apply_plane,
                                                       adapter_apply_tree)
    from repro_torch.optim.plane import Plane, as_tree
    tree = as_tree(student)
    layout = adapter_layout(tree, rank, node_axis=True)
    _, rest_now = split_student(layout, tree)
    rest_mixed = mix_node_trees(w_self, w_neigh, rest_now, recv["student"])
    factors = recv["adapters"]
    if grams:
        from repro_torch.core.aggregation import regmean_adjust
        factors = {n: {"A": regmean_adjust(f["A"], recv["grams"][n],
                                           w_neigh, per_recv=False),
                       "B": f["B"]}
                   for n, f in factors.items()}
    if isinstance(student, Plane):
        return adapter_apply_plane(student, layout, w_neigh, factors,
                                   rest_mixed)
    return adapter_apply_tree(tree, layout, w_neigh, factors, rest_mixed)
