"""Decentralized model aggregation (``repro``'s ``core/aggregation.py``):
the per-node loop engine's dataset-size-weighted neighbourhood mean
(:func:`weighted_tree_mean` over parameter trees,
:func:`weighted_plane_mean` straight on plane buffers), and the
merge-based aggregation of the adapter-rank wire, the RegMean
adjustment of the low-rank factors.

Receivers apply ``W += Σ_j c_ij·(B_j @ Ã_j)`` through
``kernels/lowrank_apply``.  :func:`regmean_adjust` computes the RegMean
``Ã`` — the gram-weighted least-squares merge
``(Σ_j c_j Δ_j G_j)(Σ_j c_j G_j)⁻¹`` restricted to the low-rank factors.
Without grams the merge uses the raw factors (``Ã = A``).
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_map


def _weighted_sum(weights: Sequence[float], xs) -> torch.Tensor:
    """``Σ_i w_i·x_i`` in fp32, ``repro``'s order: the weights normalized
    in float64 and rounded once to fp32, each product and sum rounded
    on its own, the sum started from 0 (as Python's ``sum``)."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    return sum(torch.tensor(float(wi), dtype=torch.float32,
                            device=x.device) * x.float()
               for wi, x in zip(w, xs))


def weighted_tree_mean(trees: Sequence[Any], weights: Sequence[float]):
    """Leaf by leaf ``Σ_i w_i·tree_i`` with the weights normalized to sum
    to 1, each leaf back in the first tree's dtype."""
    return tree_map(lambda *leaves: _weighted_sum(weights, leaves)
                    .to(leaves[0].dtype), *trees)


def neighborhood_aggregate(node: int, own_tree, received: List[Any],
                           own_size: float, received_sizes: List[float]):
    """Aggregate own + neighbour models, dataset-size weighted."""
    return weighted_tree_mean([own_tree] + received,
                              [own_size] + list(received_sizes))


def weighted_plane_mean(planes: Sequence[Any], weights: Sequence[float]):
    """:func:`weighted_tree_mean` over plane-backed models, on the
    ``[..., R, 512]`` buffers directly: bit-identical to mixing the leaf
    views and repacking (the layout only places the leaves, and every
    element sees the same weights in the same order); the padding lanes,
    zero in every input, stay zero."""
    from repro_torch.optim.plane import Plane
    first = planes[0]
    out = _weighted_sum(weights, [p.buf for p in planes])
    return Plane(out.to(first.buf.dtype), first.meta)

# Ridge strength of the RegMean solve, relative to tr(Gsum)/k.  The wire
# gram is a rank-r proxy, so Gsum is rank-deficient and the ridge sets
# the solve's conditioning: 1e-3 caps the amplification of a last-bit
# difference in Gsum at about 1e3.
REGMEAN_EPS = 1e-3


def regmean_adjust(a: torch.Tensor, grams: torch.Tensor,
                   coeffs: torch.Tensor, *, per_recv: bool,
                   eps: float = REGMEAN_EPS) -> torch.Tensor:
    """RegMean-adjusted per-receiver factors of one matrix leaf.

    ``a`` ``[S, *lead, r, k]`` per-sender factors, ``grams``
    ``[S, *lead, k, k]``, ``coeffs`` ``[N, S]`` (zero for
    non-neighbours).  Per receiver ``i``::

        Gsum_i  = Σ_j coeffs[i, j]·G_j + (eps·tr(Gsum_i)/k + 1e-6)·I
        Ã[i, j] = A_j G_j Gsum_i⁻¹

    returned as ``[N, S, *lead, r, k]``.  The stacked engine's merge
    passes ``per_recv=False``; ``per_recv=True`` takes each receiver's own
    view, ``a`` ``[N, S, *lead, r, k]`` and ``grams`` ``[N, S, *lead, k,
    k]``, as the mesh exchange (where every receiver dequantizes its own
    copy of the wire) will."""
    k = grams.shape[-1]
    a32, g32, c32 = a.float(), grams.float(), coeffs.float()
    gsum = torch.einsum("ns,ns...kl->n...kl" if per_recv
                        else "ns,s...kl->n...kl", c32, g32)
    tr = torch.diagonal(gsum, dim1=-2, dim2=-1).sum(-1) / k
    gsum = gsum + (eps * tr + 1e-6)[..., None, None] * \
        torch.eye(k, dtype=torch.float32, device=gsum.device)
    ag = a32 @ g32                          # [(N,) S, *lead, r, k]
    rhs = ag.transpose(-1, -2)              # [(N,) S, *lead, k, r]
    if not per_recv:
        rhs = rhs[None]
    # Gsum is symmetric: solve(Gsum_i, agᵀ)ᵀ == ag @ Gsum_i⁻¹; the
    # receiver's system broadcasts over its senders.  solve_ex: the ridge
    # keeps Gsum regular, and skipping the check keeps the host from
    # waiting on the card (jnp.linalg.solve checks nothing either)
    x, _ = torch.linalg.solve_ex(gsum[:, None], rhs)   # [N, S, *lead, k, r]
    return x.transpose(-1, -2)
