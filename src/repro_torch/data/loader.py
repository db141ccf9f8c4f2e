"""Minibatch index streams over numpy node datasets, and the batcher the
per-node loop engine streams them through."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


def batch_index_lists(n: int, batch_size: int, seed: int, *, epochs: int = 1,
                      drop_remainder: bool = True) -> list:
    """The per-batch index arrays of one node's shuffled epochs (the JAX
    package's RNG stream, so batch content and order match it exactly).
    The stacked round engine uses these to slice all nodes' epochs into
    one host array and ship it in a single transfer."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(epochs):
        perm = rng.permutation(n)
        end = (n // batch_size) * batch_size if drop_remainder else n
        if end == 0 and n > 0:   # tiny node datasets: one short batch
            out.append(perm)
            continue
        for i in range(0, end, batch_size):
            out.append(perm[i:i + batch_size])
    return out


def batches(data: Dict[str, np.ndarray], batch_size: int, seed: int,
            *, epochs: int = 1, drop_remainder: bool = True, device=None
            ) -> Iterator[Dict[str, torch.Tensor]]:
    """One node's shuffled minibatches (``repro``'s ``batches``: the
    index stream of :func:`batch_index_lists`), each a dict of tensors
    on ``device``."""
    n = len(next(iter(data.values())))
    for idx in batch_index_lists(n, batch_size, seed, epochs=epochs,
                                 drop_remainder=drop_remainder):
        yield {k: torch.as_tensor(v[idx], device=device)
               for k, v in data.items()}


def num_batches(n: int, batch_size: int, epochs: int = 1) -> int:
    per = max(n // batch_size, 1 if n else 0)
    return per * epochs
