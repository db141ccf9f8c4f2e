"""The static row order of the row-sharded permute.

A node of the multi-node exchange may hold several ranks (``repro``'s
multi-axis pods): each of its M ranks permutes only its own row block
of the node's encoded wire buffer.  Every block must then hold the same
profile of row widths, so that each rank's encoded byte count is the
same static number and the blocks of two nodes line up.
"""
from __future__ import annotations

import numpy as np


def row_shard_order(row_bits, inner: int):
    """Static row permutation that splits a packed wire buffer's rows
    over ``inner`` ranks with an identical per-width row profile on
    every rank.

    ``row_bits`` is the wire width of each row (``seg_bits[seg_ids]``,
    length R).  Rank k takes the k-th equal slice of every width group,
    the groups in ascending width (the encode order).  A group whose row
    count ``inner`` does not divide is padded: ``order`` grows indices
    ``R, R+1, …``, assigned in turn over the groups in ascending width,
    which the caller materializes as appended all-zero rows before
    taking ``buf[:, order]``.  Zero codes encode to zero bytes at the
    group's width and dequantize to zero, so the mix is unchanged; the
    pad rows are wire bytes, which ``packed_copy_bytes(…, inner=…)``
    counts.

    Returns ``(order, inv_order, local_bits)``: ``buf[:, order]`` (after
    the ``len(order) - R`` zero rows are appended) is the buffer in
    shard order, ``mixed[:, inv_order]`` (length R) restores the rows
    and drops the pad rows, and each rank encodes its block against
    ``local_bits``."""
    bits = np.asarray(row_bits)
    r_orig = bits.shape[0]
    if inner <= 1:
        r = np.arange(r_orig)
        return r, r, bits
    groups = []
    next_pad = r_orig
    for b in sorted(set(int(b) for b in bits)):
        rows = np.nonzero(bits == b)[0]
        pad = (-len(rows)) % inner
        if pad:
            rows = np.concatenate([rows,
                                   np.arange(next_pad, next_pad + pad)])
            next_pad += pad
        groups.append((b, rows))
    order = np.concatenate([
        rows[k * (len(rows) // inner):(k + 1) * (len(rows) // inner)]
        for k in range(inner) for _b, rows in groups])
    local_bits = np.concatenate([
        np.full(len(rows) // inner, b, bits.dtype) for b, rows in groups])
    return order, np.argsort(order)[:r_orig], local_bits
