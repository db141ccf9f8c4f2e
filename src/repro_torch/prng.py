"""JAX's default PRNG (threefry2x32) in numpy.

A key is the pair of uint32 words that ``jax.random.PRNGKey(seed)``
holds (``(0, seed)`` for a seed below 2^32).  :func:`random_bits` and
:func:`uniform` draw the same numbers as ``jax.random.bits`` and
``jax.random.uniform(key, shape, float32)`` under
``jax_threefry_partitionable`` (JAX's default since 0.5): word ``i`` of
the row-major flattened shape is ``out0 ^ out1`` of the cipher of the
counter ``(i >> 32, i & 0xffffffff)``.  The adapter wire's Ω
(``core/adapters.py``) and the codec's stochastic rounding
(``core/quantization.py``, ``kernels/quantize/ops.py``) draw from here,
so both match the JAX package bit for bit.  The numbers are drawn on
the host; :func:`uniform_like` copies them to a tensor's device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block cipher (20 rounds) of JAX's default PRNG on
    uint32 arrays (additions wrap mod 2^32)."""
    u32 = np.uint32
    ks = (u32(k0), u32(k1), u32(k0) ^ u32(k1) ^ u32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3]
        x1 = x1 + u32(g + 1)
    return x0, x1


def _fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: the key enciphers the count ``(0, data)``."""
    a, b = _threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                         np.full(1, data, np.uint32))
    return int(a[0]), int(b[0])


def _random_bits(key: Tuple[int, int], n: int) -> np.ndarray:
    """``n`` 32-bit words as ``jax.random.bits`` draws them."""
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = _threefry2x32(key[0], key[1], hi, lo)
    return a ^ b


def as_key(key) -> Tuple[int, int]:
    """A threefry key as two ints: anything holding exactly two uint32
    words (a ``jax.random.PRNGKey``'s array, a tuple, a numpy or torch
    array).  A ``torch.Generator`` raises ``TypeError``: its stream is
    not the reference's, so codes drawn from it could not match."""
    if isinstance(key, torch.Generator):
        raise TypeError("a torch.Generator cannot reproduce jax.random's "
                        "stream: pass a threefry key, the two uint32 "
                        "words of jax.random.PRNGKey(seed)")
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    words = np.asarray(key)
    if words.shape != (2,) or not np.issubdtype(words.dtype, np.integer):
        raise TypeError(f"a threefry key is two uint32 words, got "
                        f"{words.dtype} {words.shape}")
    if words.min() < 0 or words.max() > 0xFFFFFFFF:
        raise TypeError(f"threefry key words must be uint32, got {words}")
    return int(words[0]), int(words[1])


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 words of ``shape``."""
    shape = tuple(int(s) for s in shape)
    return _random_bits(as_key(key), int(np.prod(shape, dtype=np.int64))
                        ).reshape(shape)


def uniform(key, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32)`` on ``[0, 1)``: the top
    23 bits of each word as the mantissa of a float in ``[1, 2)``, minus
    1 (exact), as fp32 numpy."""
    f32 = np.float32
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f32) - f32(1)
    return np.maximum(f32(0), f)


def uniform_like(key, x):
    """:func:`uniform` over ``x``'s shape as an fp32 tensor on ``x``'s
    device: drawn on the host, then copied."""
    return torch.from_numpy(uniform(key, tuple(x.shape))).to(x.device)
