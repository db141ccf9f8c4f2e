"""Wire quantization (paper Sec. III-D).

    Q(x) = floor(x / Δ + 0.5) * Δ ,   Δ = max|x| / (2^(bits-1) - 1)

The integer codes ``floor(x/Δ + 0.5)`` travel (int16 for 16-bit) plus
one fp32 scale per tensor; the receiver multiplies back (``x' = q·Δ``).
This module holds the per-tensor codec in plain tensor ops
(``quantize_array`` … ``quantize_dequantize_tree``, the reference the
kernel codecs of ``kernels/quantize/ops.py`` are held to) and counts the
logical (Table II) bytes of a payload.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.quantize.ref import as_codes
from repro_torch.prng import uniform_like
from repro_torch.tree import is_float, itemsize, numel, tree_leaves, tree_map
from repro_torch.wirespec import WireSpec


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1        # 32767 for 16-bit, 7 for 4-bit


# narrowest container holding the codes; int4 codes ride int8 in memory
# (the packed wire codec nibble-packs them to true half-bytes on the wire)
_INT_DTYPES = {4: torch.int8, 8: torch.int8, 16: torch.int16,
               32: torch.int32}


def quantize_array(x, bits: int = 16, *, rng=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ``(codes intN, 0-d Δ fp32)``.  Non-float tensors pass through
    with Δ = 1.  qmax divides as an fp32 tensor on ``x``'s device, so Δ
    is an IEEE division on the card too.  ``rng`` (a threefry key, see
    :mod:`repro_torch.prng`) switches to stochastic rounding,
    ``floor(x/Δ + U[0,1))``: unbiased codes, the noise drawn on the host
    as ``jax.random.uniform(rng, x.shape)`` draws it."""
    if not x.dtype.is_floating_point:
        return x, torch.ones((), dtype=torch.float32, device=x.device)
    noise = None if rng is None else uniform_like(rng, x)
    qm = torch.tensor(float(_qmax(bits)), dtype=torch.float32,
                      device=x.device)
    x32 = x.to(torch.float32)
    delta = torch.clamp_min(torch.amax(torch.abs(x32)) / qm,
                            torch.finfo(torch.float32).tiny)
    codes = torch.floor(x32 / delta + (0.5 if noise is None else noise))
    codes = torch.clamp(codes, -qm - 1, qm)
    return as_codes(codes, _INT_DTYPES[bits]), delta


def dequantize_array(codes, delta, dtype=torch.float32) -> torch.Tensor:
    if codes.dtype.is_floating_point:
        return codes.to(dtype)
    if codes.dtype == torch.bool:
        return codes
    return (codes.to(torch.float32) * delta).to(dtype)


def quantize_tree(tree, bits: int = 16) -> Dict[str, Any]:
    """Quantize every float leaf.  Returns ``{"codes": tree, "scales":
    tree, "bits": int}`` — the wire payload."""
    pairs = []
    codes = tree_map(
        lambda x: pairs.append(quantize_array(x, bits)) or pairs[-1][0], tree)
    scales = iter([d for _, d in pairs])
    return {"codes": codes, "scales": tree_map(lambda _: next(scales), tree),
            "bits": bits}


def dequantize_tree(payload, dtype=torch.float32):
    return tree_map(lambda c, d: dequantize_array(c, d, dtype),
                    payload["codes"], payload["scales"])


def quantize_dequantize_tree(tree, bits: int = 16):
    """Round trip — what the receiver reconstructs."""
    return dequantize_tree(quantize_tree(tree, bits))


# -- wire-size accounting -----------------------------------------------------

def array_wire_bytes(x, bits: int | None = None) -> int:
    """Serialized size of one array (tensor or ShapeDtypeStruct);
    ``bits`` overrides the float width (int4 counts a true half-byte per
    value, rounded up)."""
    if is_float(x) and bits is not None:
        return -(-numel(x) * bits // 8)
    return numel(x) * itemsize(x)


def tree_wire_bytes(tree, bits: int | None | WireSpec = None) -> int:
    """Bytes on the wire for a payload tree (+4 per quantized tensor for
    the fp32 scale when ``bits`` is set).  A :class:`WireSpec` resolves
    each leaf's width from its top-level payload key."""
    if isinstance(bits, WireSpec):
        items = tree.items() if isinstance(tree, dict) else [(None, tree)]
        return sum(tree_wire_bytes(sub, bits.bits_for(key))
                   for key, sub in items)
    total = 0
    for leaf in tree_leaves(tree):
        if not hasattr(leaf, "dtype"):
            continue
        total += array_wire_bytes(leaf, bits)
        if bits is not None and is_float(leaf):
            total += 4
    return total
