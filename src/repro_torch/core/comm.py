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


def packed_copy_bytes(payload_tree, bits: Bits = None) -> int:
    """Physical bytes of ONE serialized copy under the packed node wire
    codec: quantized float leaves ride the 512-lane code buffer with one
    fp32 scale per leaf (``bits=None``, the fp32 wire: fp32 rows and no
    scales); ``counts`` (and any non-float leaf) rides raw.
    Leaves are ordered by wire group name, as the payload dict packs
    them, so the alignment rows land on the same (last) segment."""
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
                raw += numel(leaf) * itemsize(leaf)
            else:
                g = canonical_group(key)
                groups.append((g, leaf,
                               spec.bits_for(g) if spec else bits))
    groups.sort(key=lambda t: t[0])
    packed_leaves = [leaf for _g, leaf, _b in groups]
    if spec is None:
        return packed_wire_bytes_per_node(packed_leaves, bits) + raw
    return packed_wire_bytes_per_node(
        packed_leaves, spec.max_bits,
        leaf_bits=[b for _g, _leaf, b in groups]) + raw


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
