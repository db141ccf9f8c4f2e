"""Plain PyTorch version of the Eq. 3 accumulation: the one-hot einsum
``repro``'s CPU path runs.  Labels outside ``[0, C)`` match no class
(``repro``'s ``jax.nn.one_hot`` gives them an all-zero row)."""
from __future__ import annotations

import torch


def proto_accum_ref(f1, labels, n_classes: int):
    """f1 ``[N, B, P]``, labels ``[N, B]`` int -> (sums ``[N, C, P]``,
    counts ``[N, C]``) through the explicit ``[N, B, C]`` one-hot."""
    classes = torch.arange(n_classes, device=labels.device)
    onehot = (labels[..., None] == classes).to(torch.float32)
    sums = torch.einsum("nbc,nbp->ncp", onehot, f1.to(torch.float32))
    return sums, onehot.sum(dim=1)
