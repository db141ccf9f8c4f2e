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


def proto_accum_batch_order(f1, labels, n_classes: int):
    """The CUDA kernel's own order: ``for b: sums[n, labels[n, b]] +=
    f1[n, b]`` over the valid labels, from zeros, each add rounded once
    in fp32; counts likewise.  Bit-identical to the kernel on the card
    (``chip_smoke.py`` holds it so); a check's plain version, not the
    CPU path (a Python loop over the batch)."""
    n, batch, _ = f1.shape
    f1 = f1.to(torch.float32)
    sums = torch.zeros((n, n_classes) + f1.shape[2:], dtype=torch.float32,
                       device=f1.device)
    counts = torch.zeros((n, n_classes), dtype=torch.float32,
                         device=f1.device)
    nodes = torch.arange(n, device=f1.device)
    for b in range(batch):
        lab = labels[:, b].long()
        ok = (lab >= 0) & (lab < n_classes)
        idx, cls = nodes[ok], lab[ok]
        sums[idx, cls] = sums[idx, cls] + f1[idx, b]
        counts[idx, cls] = counts[idx, cls] + 1.0
    return sums, counts
