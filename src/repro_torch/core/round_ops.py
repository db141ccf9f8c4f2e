"""Vectorized federation-round math on stacked ``[N, ...]`` node state.

* ``gossip_matrix`` / ``include_matrix`` — the topology schedule lowered
  to mixing and Eq. 4 include weights, in numpy float64 and cast to fp32
  (host-side, once per run).
* ``quantize_dequantize_per_node`` — the receiver-side reconstruction of
  a round's wire payload through the packed node codec (stateless, or
  with the error-feedback ``CodecState``).
* ``mix_node_trees`` — size-weighted gossip: a node's own copy mixes
  unquantized, its neighbours' from the dequantized view.
* ``neighborhood_prototype_aggregate`` — Eq. 4 per node neighbourhood.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.wirespec import WireSpec


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


def include_matrix(adj: np.ndarray) -> np.ndarray:
    """adj + self-loops as fp32 ``[N, N]`` (or ``[R, N, N]``): who
    contributes prototypes to whom."""
    m = np.asarray(adj, np.float64) + np.eye(np.asarray(adj).shape[-1])
    return np.minimum(m, 1.0).astype(np.float32)


def quantize_dequantize_per_node(tree, bits: int = 16, *,
                                 spec: Optional[WireSpec] = None,
                                 state=None):
    """Receiver-side reconstruction of a stacked wire payload
    ``{"protos": [N, C, P], "student": Plane}`` through the packed node
    codec (the plane branch of ``repro``'s function).

    ``state`` (a :class:`~repro_torch.core.wire_state.CodecState`,
    required when ``spec.error_feedback`` is set) switches to the
    error-feedback codec and returns ``(reconstruction, new_state)``,
    with ``seq`` advanced by one."""
    from repro_torch.core.wire_state import CodecState, next_seq
    from repro_torch.kernels.quantize.ops import (
        quantize_dequantize_plane_payload)
    from repro_torch.optim.plane import Plane
    if spec is not None and spec.error_feedback and state is None:
        raise ValueError("WireSpec.error_feedback is set but no CodecState "
                         "was passed: the error-feedback codec needs the "
                         "carried per-node residual")
    if not (isinstance(tree, dict) and isinstance(tree.get("student"),
                                                  Plane)):
        raise NotImplementedError(
            "only the plane-backed {'protos', 'student'} payload is "
            "ported: ROADMAP.md Queue 1 item 4 (per-leaf wire codec)")
    if spec is not None and spec.uniform_bits is not None:
        bits = spec.uniform_bits
    if state is None:
        return quantize_dequantize_plane_payload(tree, bits, spec=spec)
    recv, new_res = quantize_dequantize_plane_payload(
        tree, bits, spec=spec, residual=state.residual)
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
