"""Wire-size accounting (paper Sec. III-D).

    Q(x) = floor(x / Δ + 0.5) * Δ ,   Δ = max|x| / (2^(bits-1) - 1)

The integer codes travel (int16 for 16-bit) plus one fp32 scale per
tensor.  The codec itself lives in ``kernels/quantize/ops.py``; this
module counts the logical (Table II) bytes of a payload.
"""
from __future__ import annotations

from repro_torch.tree import is_float, itemsize, numel, tree_leaves
from repro_torch.wirespec import WireSpec


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1        # 32767 for 16-bit, 7 for 4-bit


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
