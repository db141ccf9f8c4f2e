"""Communication accounting — Table II, analytically.

Two accountants share one summary surface: :class:`CommMeter`, the
per-edge meter (``record_broadcast`` per sender) that the per-node loop
engine keeps, and :class:`ScheduleCommAccountant`, which derives the
same per-node sent/received bytes from a
:class:`~repro_torch.core.topology.TopologySchedule`: per-copy bytes
from the payload skeleton times the schedule's integer out/in degrees,
exact integers throughout.  :func:`packed_copy_bytes` is the
physical size of one copy under the packed node wire codec.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Union

import numpy as np

from repro_torch.core.quantization import tree_wire_bytes
from repro_torch.tree import is_float, itemsize, numel, tree_leaves
from repro_torch.wirespec import WireSpec, canonical_group

Bits = Union[int, WireSpec, None]


def packed_copy_bytes(payload_tree, bits: Bits = None, *,
                      inner: int = 1) -> int:
    """Physical bytes of ONE serialized copy under the packed node wire
    codec: quantized float leaves ride the 512-lane code buffer with one
    fp32 scale per leaf (``bits=None``, the fp32 wire: fp32 rows and no
    scales); ``counts`` (and any non-float leaf) rides raw.
    Leaves are ordered by wire group name, as the payload dict packs
    them, so the alignment rows land on the same (last) segment.

    ``inner`` is the number of ranks of a node in the row-sharded
    permute, which splits every tensor of the copy over them: each wire
    width group of the code buffer pads up to a multiple of ``inner``
    rows, the fp32 scales and each raw leaf up to a multiple of
    ``inner`` elements.  ``inner=1`` is the one-rank-per-node copy."""
    from repro_torch.kernels.quantize.ops import packed_wire_bytes_per_node

    spec = bits if isinstance(bits, WireSpec) else None
    groups = []                                   # (wire-group, leaf, bits)
    raw = 0
    items = payload_tree.items() if isinstance(payload_tree, dict) \
        else [(None, payload_tree)]
    for key, sub in items:
        for leaf in tree_leaves(sub):
            if not hasattr(leaf, "dtype"):
                continue
            if key == "counts" or not is_float(leaf):
                per = numel(leaf)
                raw += (per + (-per) % inner) * itemsize(leaf)
            else:
                g = canonical_group(key)
                groups.append((g, leaf,
                               spec.bits_for(g) if spec else bits))
    groups.sort(key=lambda t: t[0])
    packed_leaves = [leaf for _g, leaf, _b in groups]
    pad_scales = ((-len(groups)) % inner) * 4 if bits is not None else 0
    if spec is None:
        return packed_wire_bytes_per_node(packed_leaves, bits,
                                          inner=inner) + raw + pad_scales
    return packed_wire_bytes_per_node(
        packed_leaves, spec.max_bits,
        leaf_bits=[b for _g, _leaf, b in groups], inner=inner) + raw + \
        pad_scales


class CommMeter:
    def __init__(self, num_nodes: int):
        self.num_nodes = num_nodes
        self.sent: Dict[int, int] = defaultdict(int)
        self.received: Dict[int, int] = defaultdict(int)
        self.by_kind: Dict[str, int] = defaultdict(int)
        self.by_round: Dict[int, int] = defaultdict(int)

    def record_broadcast(self, sender: int, receivers, payload_tree,
                         kind: str, round_idx: int,
                         bits: Bits = None) -> int:
        """``sender`` ships ``payload_tree`` to each of ``receivers``.
        Returns bytes per copy."""
        nbytes = tree_wire_bytes(payload_tree, bits)
        for r in receivers:
            self.sent[sender] += nbytes
            self.received[r] += nbytes
            self.by_kind[kind] += nbytes
            self.by_round[round_idx] += nbytes
        return nbytes

    def avg_sent_gb(self) -> float:
        return sum(self.sent.values()) / max(self.num_nodes, 1) / 1e9

    def avg_received_gb(self) -> float:
        return sum(self.received.values()) / max(self.num_nodes, 1) / 1e9

    def summary(self) -> Dict[str, float]:
        return {
            "avg_sent_gb": self.avg_sent_gb(),
            "avg_received_gb": self.avg_received_gb(),
            "total_gb": (sum(self.sent.values())) / 1e9,
            "by_kind_gb": {k: v / 1e9 for k, v in self.by_kind.items()},
        }


class ScheduleCommAccountant(CommMeter):
    """Wire-byte accounting computed from a ``TopologySchedule``: one
    round of all-node gossip is one degree-vector multiply."""

    def __init__(self, schedule):
        super().__init__(schedule.num_nodes)
        self.schedule = schedule
        self._out = schedule.out_degrees()      # [R, N] int64
        self._in = schedule.in_degrees()        # [R, N] int64

    def record_round(self, payload_tree, kind: str, round_idx: int,
                     bits: Bits = None) -> int:
        """Every node broadcasts ``payload_tree`` to that round's
        neighbors.  Returns bytes per copy."""
        nbytes = tree_wire_bytes(payload_tree, bits)
        p = self.schedule.phase_index(round_idx)
        out_d, in_d = self._out[p], self._in[p]
        for i in np.nonzero(out_d)[0]:
            self.sent[int(i)] += nbytes * int(out_d[i])
        for i in np.nonzero(in_d)[0]:
            self.received[int(i)] += nbytes * int(in_d[i])
        edges = int(out_d.sum())
        self.by_kind[kind] += nbytes * edges
        self.by_round[round_idx] += nbytes * edges
        return nbytes

    def predicted_node_bytes(self, payload_tree, round_idx: int,
                             bits: Bits = None, wire: str = "dense", *,
                             inner: int = 1) -> np.ndarray:
        """Per-node bytes *sent* in one round, the counters untouched:
        ``out_degree × bytes-per-copy``.  ``wire="dense"`` is the logical
        Table II copy (``tree_wire_bytes``), ``wire="packed"`` the
        physical packed-codec copy (:func:`packed_copy_bytes`, with
        ``inner`` ranks a node) — what the wire audit
        (``launch/dryrun.py --topology``) holds the exchange's collective
        bytes to."""
        if wire == "packed":
            nbytes = packed_copy_bytes(payload_tree, bits, inner=inner)
        elif wire == "dense":
            nbytes = tree_wire_bytes(payload_tree, bits)
        else:
            raise ValueError(f"wire must be 'dense' or 'packed', "
                             f"got {wire!r}")
        p = self.schedule.phase_index(round_idx)
        return self._out[p].astype(np.int64) * nbytes
