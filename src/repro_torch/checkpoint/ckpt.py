"""Checkpointing: a tree of tensors <-> ``.npz`` with key-path flattening.

The port's trees are nested dicts, lists and tuples of tensors, with
NamedTuples inside: a :class:`~repro_torch.core.profe.NodeState`, a
:class:`~repro_torch.core.wire_state.CodecState`, and a
:class:`~repro_torch.optim.plane.Plane` (whose buffer is its one leaf;
its ``PlaneMeta`` recipe comes back from the tree loaded into).  Keys are
``repro``'s (:func:`repro_torch.tree.keyed_leaves`): each path's parts
``/``-joined, a dict key as itself, a sequence item as ``#i``, a
NamedTuple field as ``.name`` and a Plane's buffer as ``buf``; a
``None`` holds nothing.  Tensors are detached and
copied to the host; bf16 is stored as fp32 (exact) and cast back.  A
``.meta.json`` sidecar holds the keys and the caller's metadata.  The
stacked engine's whole state (``NodeState`` with ``wire_state``, whose
residual is a plane or a tree mirroring the payload, ``proto_acc`` and
``adapter_state``) round-trips bit for bit, so a run resumes exactly.  Its step counters are one a node (``[N]``); a
checkpoint that holds one 0-d counter for all nodes (the stacked state's
layout before per-node counters) loads with that counter broadcast to
every node.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import keyed_leaves, rebuild


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _restore(arr: np.ndarray, like):
    """One saved array as ``like``'s kind: a tensor on its device and of
    its dtype (an autograd leaf again where ``like`` required grad), or a
    numpy array of its dtype.  A 0-d array restores into a ``like`` with
    axes as that one value broadcast (a shared step counter)."""
    if isinstance(like, torch.Tensor):
        arr = np.array(arr)
        if arr.ndim == 0 and like.dim() > 0:
            arr = np.broadcast_to(arr, tuple(like.shape)).copy()
        t = torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
        return t.requires_grad_(True) if like.requires_grad else t
    if hasattr(like, "dtype"):
        return np.asarray(arr).astype(like.dtype)
    return np.asarray(arr)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _sidecar(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def save_checkpoint(path: str, tree, *,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write ``tree`` to ``path`` (``.npz``) and its ``.meta.json``
    sidecar (the keys and ``metadata``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {key: _to_numpy(leaf) for key, leaf in keyed_leaves(tree)}
    np.savez(_npz(path), **flat)
    with open(_sidecar(path), "w") as f:
        json.dump({"keys": list(flat), "metadata": metadata or {}}, f)


def load_checkpoint(path: str, like_tree):
    """Restore the checkpoint at ``path`` in the structure of
    ``like_tree``: each leaf on ``like_tree``'s device and of its dtype,
    a Plane with ``like_tree``'s recipe.  Raises ``ValueError`` naming
    the missing and extra keys when the two differ."""
    with np.load(_npz(path)) as npz:
        saved = {k: npz[k] for k in npz.files}
    items = keyed_leaves(like_tree)
    keys = [k for k, _ in items]
    missing = sorted(set(keys) - set(saved))
    extra = sorted(set(saved) - set(keys))
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={missing[:5]} "
                         f"extra={extra[:5]}")
    return rebuild(like_tree, iter(_restore(saved[k], leaf)
                                    for k, leaf in items))
