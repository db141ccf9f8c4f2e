"""Dispatch and plane sweep of the fused low-rank apply: the CUDA
kernel for tensors on the card, its plain version for tensors on the
CPU.  There is no fallback: a CUDA tensor the kernel does not take
raises.

* :func:`lowrank_apply` — one matrix leaf of every receiver, lead axes
  folded into the launch.
* :func:`adapter_apply_tree` — the merge on a node-stacked per-leaf
  student tree: each matrix leaf through :func:`lowrank_apply`, each
  rest leaf its mixed value, a new tree.
* :func:`adapter_apply_plane` — the merge on a node-stacked plane, IN
  PLACE: every matrix leaf's row span is read and written through
  :func:`lowrank_apply` on its ``[N, *lead, d, k]`` view, every rest span
  takes its mixed value; padding lanes and alignment rows are not
  touched (zero by the plane invariant).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.lowrank_apply.lowrank_apply import lowrank_apply_cuda
from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref


def lowrank_apply(w, coeffs, b, a, *, out=None):
    """``w`` [N, *lead, d, k] + ``Σ_j coeffs[:, j]·(B_j @ A_j)`` ->
    [N, *lead, d, k] (see ``ref.py``); ``out`` (which may be ``w``)
    receives the result."""
    if w.is_cuda:
        return lowrank_apply_cuda(w, coeffs.float().contiguous(),
                                  b.float().contiguous(),
                                  a.float().contiguous(), out=out)
    res = lowrank_apply_ref(w, coeffs, b, a)
    if out is None:
        return res
    out.copy_(res)
    return out


@torch.no_grad()
def adapter_apply_tree(tree, layout, coeffs, factors: Dict[str, Dict],
                       rest_mixed: Dict[str, torch.Tensor]):
    """The merge over a node-stacked per-leaf tree (``repro``'s
    ``adapter_apply_tree``): every matrix leaf ``[N, *lead, d, k]``
    becomes ``W + Σ_j coeffs[:, j]·(B_j @ A_j)`` through
    :func:`lowrank_apply` (fp32), every other leaf its ``rest_mixed``
    value.  ``factors`` is ``{leaf: {"A", "B"}}`` stacked over senders,
    ``layout`` the tree's ``AdapterLayout``.  Returns a new tree, the
    layout's empty subtrees kept."""
    from repro_torch.tree import tree_from_paths, tree_paths
    items = []
    for name, is_mat, (path, leaf) in zip(layout.names, layout.is_mat,
                                          tree_paths(tree)):
        if is_mat:
            f = factors[name]
            leaf = lowrank_apply(leaf.detach().float().contiguous(), coeffs,
                                 f["B"], f["A"])
        else:
            leaf = rest_mixed[name]
        items.append((path, leaf))
    return tree_from_paths(items, layout.empties)


@torch.no_grad()
def adapter_apply_plane(plane, layout, coeffs, factors: Dict[str, Dict],
                        rest_mixed: Dict[str, torch.Tensor]):
    """The merge over a node-stacked plane ``[N, R, 512]``, written into
    ``plane.buf`` in place; returns ``plane``."""
    from repro_torch.optim.plane import _leaf_view
    buf = plane.buf
    for name, is_mat, (_, _path, shape, row, r_leaf) in zip(
            layout.names, layout.is_mat, plane.meta.recipe):
        view = _leaf_view(buf, shape, row, r_leaf)      # [N, *shape]
        if is_mat:
            f = factors[name]
            lowrank_apply(view, coeffs, f["B"], f["A"], out=view)
        else:
            view.copy_(rest_mixed[name])
    return plane
