"""Synthetic datasets with controllable class structure.

MNIST/CIFAR are not available offline, so the paper-faithful federated
runs use class-conditional Gaussian-mixture images with matched shapes
(28x28x1/10-class, 32x32x3/10-class, 32x32x3/100-class).  Each class has
a smooth random template; samples are template + noise, so models really
learn and F1 *trends* across IID/non-IID splits are meaningful.

LM tasks use domain-tagged token streams: each domain has its own
bigram transition table, and the domain tag is the prototype class
(DESIGN.md §5).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _smooth_template(rng: np.random.Generator, h: int, w: int, c: int,
                     freq: int = 4) -> np.ndarray:
    """Low-frequency random pattern (sum of few 2-D cosines)."""
    y = np.linspace(0, 2 * np.pi, h)[:, None, None]
    x = np.linspace(0, 2 * np.pi, w)[None, :, None]
    img = np.zeros((h, w, c), np.float32)
    for _ in range(freq):
        fy, fx = rng.integers(1, 4, 2)
        phase = rng.uniform(0, 2 * np.pi, (1, 1, c)).astype(np.float32)
        amp = rng.uniform(0.5, 1.0, (1, 1, c)).astype(np.float32)
        img += amp * np.cos(fy * y + fx * x + phase).astype(np.float32)
    return img / freq


def make_image_dataset(seed: int, n: int, hw: Tuple[int, int, int],
                       n_classes: int, noise: float = 0.35) -> Dict[str, np.ndarray]:
    """-> {"image": [n,H,W,C] f32, "label": [n] i32}"""
    rng = np.random.default_rng(seed)
    h, w, c = hw
    templates = np.stack([_smooth_template(rng, h, w, c)
                          for _ in range(n_classes)])       # [K,H,W,C]
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    images = templates[labels] + noise * rng.standard_normal(
        (n, h, w, c)).astype(np.float32)
    return {"image": images.astype(np.float32), "label": labels}


def make_token_dataset(seed: int, n_seqs: int, seq_len: int, vocab: int,
                       n_domains: int, concentration: float = 0.05
                       ) -> Dict[str, np.ndarray]:
    """Domain-conditional unigram/bigram streams.

    -> {"tokens": [n,S] i32, "labels": [n,S] i32 (next-token),
        "domains": [n] i32}
    Each domain has a sparse preferred-token distribution, giving models a
    learnable structure and prototypes a meaningful class signal.
    """
    rng = np.random.default_rng(seed)
    v_active = min(vocab, 4096)  # keep tables small; rest of vocab unused
    domains = rng.integers(0, n_domains, n_seqs).astype(np.int32)
    # per-domain unigram logits
    logits = rng.standard_normal((n_domains, v_active)).astype(np.float32) \
        / concentration ** 0.5
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    toks = np.empty((n_seqs, seq_len + 1), np.int32)
    for d in range(n_domains):
        idx = np.nonzero(domains == d)[0]
        if idx.size:
            toks[idx] = rng.choice(v_active, size=(idx.size, seq_len + 1),
                                   p=probs[d]).astype(np.int32)
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "domains": domains,
    }


def train_test_split(data: Dict[str, np.ndarray], test_frac: float,
                     seed: int) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    take = lambda idx: {k: v[idx] for k, v in data.items()}
    return take(train_idx), take(test_idx)
