"""ProFe and FedAvg rounds over ``torch.distributed`` — the multi-node
exchange.

One federation node per rank of a process group: a rank stands for a
device of ``repro``'s ``pod`` mesh axis (``core/mesh_federation.py``).
Every rank holds its nodes' stacked state — a student :class:`Plane`
``[n_local, R, 512]`` or a per-leaf student tree (``[n_local, ...]``
leaves), prototypes ``[n_local, C, P]`` and counts ``[n_local, C]`` —
and the round moves only the encoded wire payload between ranks.

**Wire content.**  A node's whole payload, prototypes and student, is
ONE packed ``[R, 512]`` code buffer (``pack_plane_payload``: the
student's rows spliced straight off its plane; a per-leaf student packs
leaf by leaf, ``pack_tree_nodes``, into the same layout) quantized per
(node, leaf) segment and serialized by ``encode_wire`` into ``[B]`` int8
bytes — exactly the bytes of the :class:`WireSpec` (int16 rows bitcast,
int4 rows nibble-packed) — plus its segment scales ``[T]`` and the raw
class counts ``[C]``.  The receiver decodes the codes and applies its
gossip weights to them in one fused dequantize-and-mix (``mix_packed``,
one CUDA launch on the card).

**Exchanges** (``exchange=``):

* ``"ppermute"`` — sparse gossip: the adjacency is lowered by
  :func:`repro_torch.core.topology.permutation_rounds` to permutation
  steps, and each step is one ``batch_isend_irecv`` of the encoded
  buffer, its scales and its counts.  A rank moves degree × one copy a
  round, what ``ScheduleCommAccountant`` charges.  A rank that nobody
  sends to in a step receives zeros at weight 0, as ``jax.lax.ppermute``
  gives it.  With several ranks a node (``ranks_per_node=M``) it is the
  row-sharded permute: each of a node's M ranks moves only its row block
  of the encoded buffer (rows in ``sharding.row_shard_order``'s order)
  and its slices of the scales and counts, so a node moves
  ``packed_copy_bytes(…, inner=M)`` a copy; the node's ranks widen the
  received slices, sum the prototype rows and gather the mixed blocks
  among themselves.
* ``"packed"`` — one ``all_gather`` of every rank's encoded
  ``[n_local, B]`` buffer (and scales and counts), then the mix of the
  rank's own receivers over all N senders.  The node axis splits evenly
  over the ranks, as ``repro`` shards it over ``pod``, so one rank
  holding all N nodes is a valid packed run.
* ``"gather"`` — the per-leaf reference the packed exchanges are held
  to: each leaf quantized per node on its own (the packed codec's sweeps,
  bit-identical to the per-leaf math), its int codes (at their container
  width) and scales all-gathered leaf by leaf, and the mix
  ``mix_node_trees`` on the dequantized leaves.  A plane student is
  unwrapped to leaf views at the boundary and rewrapped after.
* ``"auto"`` — ``ppermute`` for a regular graph over one pod rank a
  node, else ``packed`` (never ``gather``).

**Overlap** (``overlap=True``, ppermute only): step ``s+1``'s sends and
receives are posted before step ``s``'s payload is folded into the mix
(``mix_packed_accumulate``): double buffering with the same payloads
and weights, and byte-identical traffic.

**Topologies.**  With a 0/1 ``adjacency`` students mix per node over
``{i} ∪ neigh(i)`` (own copy unquantized) and prototypes aggregate per
neighbourhood (Eq. 4); with ``adjacency=None`` (the paper's
fully-connected protocol) every node ends with the size-weighted mean of
all the quantized copies and the global Eq. 4 prototypes ``[C, P]``.

**The adapter-rank wire** (``adapter_rank=r``): every matrix leaf
gossips the rank-r factors of its round delta (``core/adapters.py``),
with gram statistics under ``adapter_grams``, on all three exchanges;
receivers merge ``W_i += Σ_j c_ij·B_j @ Ã_j`` through
``kernels/lowrank_apply`` (RegMean-adjusted ``Ã`` with grams) while the
dense rest gossips classically, and the round carries the adapter state.

**FedAvg** (:func:`make_fedavg_round`): the baseline's full model at
fp32 on the same three exchanges, the plane buffer itself the wire.

**Several ranks a node** (``ranks_per_node=M``, ``repro``'s multi-axis
pods): the world is N·M ranks, rank ``r`` the inner index ``r % M`` of
node ``r // M``.  A node's M ranks hold replicas of its state (the same
student, prototypes, counts and residual; the port shards no model
within a node).  Every rank creates one *pod group* per inner index
(``{k, M+k, 2M+k, …}``, the wire) and one *node group* per node.  ProFe's
``ppermute`` is the row-sharded permute above; every other exchange, the
adapter wire on ``packed`` and ``gather`` and FedAvg run replicated:
each pod group runs the one-rank-a-node round on the whole payload.

**Transport.**  gloo moves host tensors only, so every payload is copied
to the host before each collective and back to the compute device after;
encode, decode, the mix and Eq. 4 stay on the compute device.  Every
other backend raises — NCCL (one card per rank) is not ported.
:data:`COLLECTIVE_BYTES` counts the bytes of the tensors this process
hands to collectives: on the pod groups (the wire) and, apart, on the
node groups.

An error-feedback spec (``+ef``) adds a :class:`CodecState` operand and
result; its residual stays on the rank and never enters a collective.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import round_ops as R
from repro_torch.core import topology as T
from repro_torch.core.federation import _unported
from repro_torch.core.profe import normalize_protos
from repro_torch.core.prototypes import aggregate_prototypes
from repro_torch.core.round_ops import (dequantize_leaf, gossip_matrix_dyn,
                                        include_matrix, mix_node_trees,
                                        neighborhood_prototype_aggregate,
                                        weighted_node_mean)
from repro_torch.core.wire_state import CodecState, next_seq
from repro_torch.kernels.quantize import ops as Q
from repro_torch.optim.plane import Plane, _leaf_view, as_tree
from repro_torch.sharding import row_shard_order
from repro_torch.tree import tree_empties, tree_from_paths, tree_map, tree_paths
from repro_torch.wirespec import WireSpec

EXCHANGES = ("auto", "gather", "packed", "ppermute")
PROTO_PASSES = ("exact", "fused")
ITEM = "Queue 1 item 12 (multi-node exchange)"


class ByteCounter:
    """Bytes of the tensors this process handed to collectives (each
    rank counts its own operands): a round adds what it sends, so it can
    be held against ``ScheduleCommAccountant``.

    * ``count`` — on the pod groups, the wire between nodes (with one
      rank a node, every collective);
    * ``by_kind`` — ``count`` split by collective (``"all-gather"``,
      ``"collective-permute"``);
    * ``inner`` and ``inner_by_kind`` — on the node groups of the
      row-sharded permute (widening the received slices, the prototype
      sum, the mixed blocks): traffic within a node, never wire."""

    def __init__(self):
        self.count = 0
        self.inner = 0
        self.by_kind: Dict[str, int] = defaultdict(int)
        self.inner_by_kind: Dict[str, int] = defaultdict(int)


COLLECTIVE_BYTES = ByteCounter()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_bytes(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` as its raw bytes (int8), so that any dtype
    (int16 codes, bf16 leaves) travels as it is held: one copy, into a
    fresh tensor whose strides a byte view accepts (``contiguous()``
    keeps the stride of a size-1 dim)."""
    host = torch.empty(t.shape, dtype=t.dtype)
    host.copy_(t.detach())
    return host.reshape(-1).view(torch.int8)


class _GlooTransport:
    """The collectives of one round over a gloo process group, on host
    copies of the payload.  ``inner`` marks a node group: its bytes are
    counted apart from the wire's."""

    def __init__(self, group, *, inner: bool = False):
        self.group = group if group is not None else dist.group.WORLD
        backend = str(dist.get_backend(self.group))
        if backend != "gloo":
            raise _unported(f"the {backend!r} backend (only gloo is "
                            f"ported; NCCL, one card per rank, waits for a "
                            f"machine with several cards)", ITEM)
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)
        self.inner = inner

    def _peer(self, group_rank: int) -> int:
        return dist.get_global_rank(self.group, group_rank)

    def _charge(self, kind: str, nbytes: int) -> None:
        if self.inner:
            COLLECTIVE_BYTES.inner += nbytes
            COLLECTIVE_BYTES.inner_by_kind[kind] += nbytes
        else:
            COLLECTIVE_BYTES.count += nbytes
            COLLECTIVE_BYTES.by_kind[kind] += nbytes

    def all_gather(self, tensors: Sequence[torch.Tensor], device
                   ) -> List[torch.Tensor]:
        """Every rank's ``[n_local, ...]`` tensors concatenated in rank
        order, ``[N, ...]`` on ``device``, each in its own dtype (moved
        as its bytes)."""
        out = []
        for t in tensors:
            host = _host_bytes(t)
            parts = [torch.empty_like(host) for _ in range(self.world)]
            self._charge("all-gather", _nbytes(host))
            dist.all_gather(parts, host, group=self.group)
            out.append(torch.cat([p.view(t.dtype).reshape(t.shape)
                                  for p in parts]).to(device))
        return out

    def all_reduce_sum(self, t: torch.Tensor, device) -> torch.Tensor:
        """The sum of every rank's fp32 ``t``, on ``device``."""
        host = t.detach().to("cpu", torch.float32, copy=True)
        self._charge("all-reduce", _nbytes(host))
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
        return host.to(device)

    def post(self, step: Sequence[Tuple[int, int]], src: np.ndarray,
             host: Sequence[torch.Tensor], tag: int):
        """Start one permutation step: send ``host`` to this rank's
        destination in ``step`` and receive its source's copy into zero
        buffers (zeros stay where nobody sends).  Returns the handle that
        :meth:`wait` takes."""
        dst = dict(step).get(self.rank)
        ops = []
        if dst is not None:
            for k, t in enumerate(host):
                self._charge("collective-permute", _nbytes(t))
                ops.append(dist.P2POp(dist.isend, t, self._peer(dst),
                                      self.group, tag + k))
        recv = [torch.zeros_like(t) for t in host]
        if src[self.rank] >= 0:
            for k, t in enumerate(recv):
                ops.append(dist.P2POp(dist.irecv, t,
                                      self._peer(int(src[self.rank])),
                                      self.group, tag + k))
        return (dist.batch_isend_irecv(ops) if ops else []), recv

    @staticmethod
    def wait(handle, device) -> List[torch.Tensor]:
        works, recv = handle
        for w in works:
            w.wait()
        return [t.to(device) for t in recv]


def _resolve_exchange(exchange: str, adj: Optional[np.ndarray],
                      nodes: int) -> str:
    """The exchange a round runs; ``nodes`` is the pod groups' size (the
    world over the ranks a node)."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, "
                         f"got {exchange!r}")
    if exchange == "ppermute":
        if adj is None:
            raise ValueError("exchange='ppermute' needs an adjacency")
        if nodes != adj.shape[0]:
            raise ValueError(f"exchange='ppermute' needs one pod rank per "
                             f"node (pod={nodes}, N={adj.shape[0]})")
        return exchange
    if exchange != "auto":
        return exchange
    if adj is not None and nodes == adj.shape[0] and T.is_regular(adj):
        return "ppermute"
    return "packed"


def _transports(group, ranks_per_node: int):
    """``(pod transport, node transport or None)`` of this rank.  With
    one rank a node the pod transport is ``group`` itself.  With M > 1
    every rank creates, in the same order, the M pod groups (inner index
    k: ranks ``k, M+k, 2M+k, …`` of ``group``) and the N node groups
    (``iM … iM+M-1``), as ``torch.distributed.new_group`` needs every
    rank to, and keeps its own two."""
    base = _GlooTransport(group)
    m = int(ranks_per_node)
    if m < 1:
        raise ValueError(f"ranks_per_node must be >= 1, got {m}")
    if m == 1:
        return base, None
    if base.world % m:
        raise ValueError(f"a world of {base.world} ranks does not split "
                         f"into nodes of ranks_per_node={m}")
    glob = [base._peer(r) for r in range(base.world)]
    n = base.world // m
    pods = [dist.new_group([glob[i * m + k] for i in range(n)],
                           backend="gloo") for k in range(m)]
    nodes = [dist.new_group(glob[i * m:(i + 1) * m], backend="gloo")
             for i in range(n)]
    return (_GlooTransport(pods[base.rank % m]),
            _GlooTransport(nodes[base.rank // m], inner=True))


def _first_node(tp: _GlooTransport, n_local: int, n: int) -> int:
    """The first node of this rank: the node axis splits evenly."""
    if n != n_local * tp.world:
        raise ValueError(f"{n} nodes do not split evenly into {n_local} per "
                         f"rank over {tp.world} ranks")
    return tp.rank * n_local


def _weights(adj, sizes, lo: int, n_local: int):
    """This rank's receivers' ``(w_self [n_local], w_rows [n_local, N])``:
    the gossip weights, or with ``adj=None`` the size-weighted mean of all
    N copies (``w_self`` 0)."""
    n = sizes.shape[0]
    if adj is None:
        w = sizes / torch.sum(sizes)
        return (torch.zeros((n_local,), dtype=torch.float32,
                            device=sizes.device),
                w[None, :].expand(n_local, n))
    w_self, w_neigh = gossip_matrix_dyn(adj, sizes)
    return w_self[lo:lo + n_local], w_neigh[lo:lo + n_local]


def _full_mean(sizes, gathered, n_local: int, like=None):
    """``adjacency=None``: the size-weighted mean of all N gathered
    copies, one row for each of the rank's ``n_local`` nodes, fp32 (or
    in each leaf's dtype of ``like``)."""
    means = weighted_node_mean(sizes / torch.sum(sizes), gathered)

    def rows(m, x=None):
        dtype = torch.float32 if x is None else x.dtype
        return m[None].expand((n_local,) + tuple(m.shape)).to(dtype).clone()
    return tree_map(rows, means) if like is None else \
        tree_map(rows, means, like)


def _replane(tree, meta) -> Plane:
    """A stacked leaf tree written into a fresh zero ``[n, rows, 512]``
    plane of ``meta``'s recipe (padding lanes and alignment rows zero)."""
    leaves = [x for _, x in tree_paths(tree)]
    buf = torch.zeros((leaves[0].shape[0], meta.rows, 512),
                      dtype=torch.float32, device=leaves[0].device)
    for (_, _path, shape, row, r_leaf), x in zip(meta.recipe, leaves):
        _leaf_view(buf, shape, row, r_leaf).copy_(x)
    return Plane(buf, meta)


def _fresh(students):
    """A copy of a plane student the merge may write in place."""
    if isinstance(students, Plane):
        return Plane(students.buf.detach().clone(), students.meta)
    return students


# -- the sender side ------------------------------------------------------------

class _Sent(NamedTuple):
    """The sender side of one round on this rank."""
    buf: torch.Tensor         # [n_local, R, 512] fp32, the own payload
    seg_ids: np.ndarray       # [R]
    seg_bits: np.ndarray      # [T]
    meta: Tuple               # pack_tree_nodes' meta of the payload
    ploc: Tuple               # (row, nrows, protos shape) of the protos
    splice: Tuple             # how the mixed rows become students
    codes: torch.Tensor       # [n_local, R, 512] wire ints
    scales: torch.Tensor      # [n_local, T] fp32
    wire: torch.Tensor        # [n_local, B] int8, what travels
    state: Optional[CodecState]


def _proto_recipe(meta, key: str = "protos"):
    """``(row, nrows, shape)`` of the payload's ``key`` leaf in the
    packed buffer, found by its path in the recipe."""
    for item in meta[0]:
        if item[0] == "packed" and tuple(item[1][:1]) == (key,):
            return item[3], item[4], item[2]
    raise ValueError(f"no float leaf under {key!r} in the payload")


def _pack_payload(protos, students, wire: WireSpec):
    """Wire pack of ``{protos, student}``: ``(buf, seg_ids, meta, ploc,
    splice)``.  A plane student's rows are spliced straight off its plane
    (``splice = (plane, r_protos, span)``); a per-leaf student packs leaf
    by leaf into the same layout (``splice = (students, meta)``)."""
    if isinstance(students, Plane):
        buf, seg_ids, meta, r_p, span = Q.pack_plane_payload(protos,
                                                             students, wire)
        return (buf, seg_ids, meta, (0, r_p, tuple(protos.shape)),
                (students, r_p, span))
    buf, seg_ids, meta = Q.pack_tree_nodes(
        {"protos": protos, "student": students}, wire)
    return buf, seg_ids, meta, _proto_recipe(meta), (students, meta)


def _splice_students(mixed, splice):
    """The mixed buffer's student rows: a fresh plane (the trailing
    alignment rows zero, a fixed point of the mix), or the per-leaf tree
    unpacked in each leaf's dtype, its empty subtrees kept."""
    if isinstance(splice[0], Plane):
        plane, r_p, span = splice
        sbuf = torch.nn.functional.pad(mixed[:, r_p:r_p + span],
                                       (0, 0, 0, plane.meta.rows - span))
        return Plane(sbuf, plane.meta)
    students, meta = splice
    return tree_map(lambda new, old: new.to(old.dtype),
                    Q.unpack_tree_nodes(mixed, meta)["student"], students)


def _proto_view(codes, row_delta, ploc):
    """Receiver-side prototypes ``[n, C, P]`` straight from the codes."""
    prow, pnrows, pshape = ploc
    n = codes.shape[0]
    pdeq = codes[:, prow:prow + pnrows].to(torch.float32) * \
        row_delta[:, prow:prow + pnrows, None]
    cdim = pshape[1] * pshape[2]
    return pdeq.reshape(n, -1)[:, :cdim].reshape(n, pshape[1], pshape[2])


def _quantize_with_state(wire: WireSpec, buf, seg_ids, meta,
                         ef_state: Optional[CodecState]):
    """``(codes, scales, new_state_or_None)``: with error feedback the
    residual packs into the payload's layout (a plane-backed residual by
    the same row splice, a tree residual leaf by leaf), updates in the
    same sweep and splits back — it never feeds a collective."""
    if ef_state is None:
        codes, scales = Q.quantize_packed_buffer(buf, seg_ids, meta[1],
                                                 seg_bits=meta[3])
        return codes, scales, None
    res = ef_state.residual
    plane_res = isinstance(res.get("student"), Plane)
    if plane_res:
        res_buf, _, _, r_p, span = Q.pack_plane_payload(res["protos"],
                                                        res["student"])
    else:
        res_buf, _, res_meta = Q.pack_tree_nodes(res)
    if res_buf.shape != buf.shape:
        raise ValueError(f"residual buffer {tuple(res_buf.shape)} does not "
                         f"match the payload buffer {tuple(buf.shape)}")
    codes, scales, new_res = Q.quantize_packed_buffer(
        buf, seg_ids, meta[1], seg_bits=meta[3], residual=res_buf,
        ef_decay=wire.ef_decay)
    if not plane_res:
        return codes, scales, CodecState(Q.unpack_tree_nodes(new_res,
                                                             res_meta),
                                         next_seq(ef_state.seq))
    pr, sbuf = Q.split_plane_payload(new_res, res["protos"].shape,
                                     res["student"].meta, r_p, span)
    return codes, scales, CodecState(
        {"protos": pr, "student": Plane(sbuf, res["student"].meta)},
        next_seq(ef_state.seq))


def _send_side(protos, students, wire: WireSpec,
               ef_state: Optional[CodecState]) -> _Sent:
    """Pack, quantize (with the EF residual when given) and encode this
    rank's payload."""
    buf, seg_ids, meta, ploc, splice = _pack_payload(protos, students, wire)
    codes, scales, state = _quantize_with_state(wire, buf, seg_ids, meta,
                                                ef_state)
    enc = Q.encode_wire(codes, seg_ids, seg_bits=meta[3])
    return _Sent(buf, seg_ids, meta[3], meta, ploc, splice, codes, scales,
                 enc, state)


def _perm_lowering(adj: np.ndarray):
    """An adjacency's permutation schedule: ``(perms, srcs)`` — the step
    lists and, per step, the receiver -> sender map (``-1`` where nobody
    sends to a node in that step)."""
    n = adj.shape[0]
    perms = T.permutation_rounds(adj)
    srcs = []
    for step in perms:
        src = np.full((n,), -1, np.int64)
        for s, d in step:
            src[d] = s
        srcs.append(src)
    return perms, srcs


def _permute_steps(tp: _GlooTransport, perms, srcs,
                   tensors: Sequence[torch.Tensor], dev, overlap: bool):
    """Run the permutation steps of one round: each step sends host
    copies of ``tensors`` to this rank's destination and yields what its
    source sent (zeros where nobody sends), on ``dev``, in step order.
    With ``overlap`` step ``s+1``'s transfers are posted before step
    ``s``'s are awaited, so whatever the caller does with step ``s``
    runs while they are in flight."""
    host = [t.detach().contiguous().cpu() for t in tensors]
    k = len(host)

    def post(s):
        return tp.post(perms[s], srcs[s], host, tag=k * s)
    if not overlap:
        for s in range(len(perms)):
            yield tp.wait(post(s), dev)
        return
    inflight = post(0) if perms else None
    for s in range(len(perms)):
        handle = inflight
        if s + 1 < len(perms):
            inflight = post(s + 1)
        yield tp.wait(handle, dev)


def _step_weight(src: np.ndarray, me: int, w_row):
    """This rank's ``(valid, mix weight)`` for one permutation step:
    zero when nobody sends to it, else its ``w_neigh`` entry for the
    sender."""
    j = int(src[me])
    valid = torch.tensor(1.0 if j >= 0 else 0.0, dtype=torch.float32,
                         device=w_row.device)
    return valid, valid * w_row[0, max(j, 0)]


def _seg_index(seg_ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(seg_ids), dtype=torch.int64,
                           device=device)


# -- the ProFe round's exchanges ------------------------------------------------

def _make_packed_core(tp: _GlooTransport, wire: WireSpec,
                      adj: Optional[np.ndarray]):
    """Packed exchange: ONE all-gather of every rank's encoded buffer,
    scales and counts -> decode -> the fused mix for this rank's own
    receivers -> Eq. 4 per neighbourhood (or global)."""
    include = None if adj is None else include_matrix(adj)

    @torch.no_grad()
    def _round(students, protos, counts, sizes, ef_state):
        n_local = counts.shape[0]
        lo = _first_node(tp, n_local, sizes.shape[0])
        sent = _send_side(protos, students, wire, ef_state)
        dev = sent.buf.device
        wire_all, scales_all, counts_all = tp.all_gather(
            [sent.wire, sent.scales, counts], dev)
        codes_all = Q.decode_wire(wire_all, sent.seg_ids,
                                  seg_bits=sent.seg_bits)
        row_delta = scales_all[:, _seg_index(sent.seg_ids, dev)]  # [N, R]
        w_self, w_rows = _weights(adj, sizes.to(device=dev,
                                                dtype=torch.float32),
                                  lo, n_local)
        mixed = Q.mix_packed(sent.buf, codes_all, row_delta, w_self, w_rows)
        protos_rx = _proto_view(codes_all, row_delta, sent.ploc)
        if adj is None:
            glob, mask = aggregate_prototypes(protos_rx, counts_all)
        else:
            glob, mask = neighborhood_prototype_aggregate(
                torch.as_tensor(include[lo:lo + n_local], device=dev),
                protos_rx, counts_all)
        return _splice_students(mixed, sent.splice), glob, mask, sent.state

    return _round


def _make_ppermute_core(tp: _GlooTransport, wire: WireSpec, adj: np.ndarray,
                        overlap: bool):
    """Sparse gossip: one ``batch_isend_irecv`` of the encoded buffer,
    scales and counts per permutation step, then the fused mix — all
    steps stacked into one launch, or with ``overlap`` folded step by
    step while the next step's transfers are in flight."""
    perms, srcs = _perm_lowering(adj)
    me = tp.rank

    @torch.no_grad()
    def _round(students, protos, counts, sizes, ef_state):
        if counts.shape[0] != 1:
            raise ValueError(f"exchange='ppermute' holds one node per rank, "
                             f"got {counts.shape[0]}")
        sent = _send_side(protos, students, wire, ef_state)
        dev = sent.buf.device
        ids = _seg_index(sent.seg_ids, dev)
        w_self_v, w_neigh = gossip_matrix_dyn(
            adj, sizes.to(device=dev, dtype=torch.float32))
        w_self, w_row = w_self_v[me:me + 1], w_neigh[me:me + 1]
        # Eq. 4 over the neighbourhood, accumulated step by step; the own
        # prototypes enter quantized, like every receiver's view
        num = counts[0][:, None] * _proto_view(sent.codes, sent.scales[:, ids],
                                               sent.ploc)[0]
        den = counts[0]
        recv = []
        acc = Q.mix_packed_init(sent.buf, w_self) if overlap else None
        for (rw, rs, rcnt), src in zip(_permute_steps(
                tp, perms, srcs, (sent.wire, sent.scales, counts), dev,
                overlap), srcs):
            rc = Q.decode_wire(rw, sent.seg_ids, seg_bits=sent.seg_bits)
            rd = rs[:, ids]
            valid, w_p = _step_weight(src, me, w_row)
            recv.append((rc, rd, rcnt, valid, w_p))
            if overlap:
                acc = Q.mix_packed_accumulate(acc, rc, rd, w_p.reshape(1, 1))
        if overlap:
            mixed = acc
        else:
            mixed = Q.mix_packed(
                sent.buf, torch.cat([r[0] for r in recv]),
                torch.cat([r[1] for r in recv]), w_self,
                torch.stack([r[4] for r in recv])[None, :])
        for rc, rd, rcnt, valid, _ in recv:
            pr = _proto_view(rc, rd, sent.ploc)[0]
            num = num + valid * rcnt[0][:, None] * pr
            den = den + valid * rcnt[0]
        glob = num / torch.clamp_min(den, 1.0)[:, None]
        mask = (den > 0).to(torch.float32)
        return (_splice_students(mixed, sent.splice), glob[None], mask[None],
                sent.state)

    return _round


class _Block(NamedTuple):
    """A rank's row block of its node's payload in the row-sharded
    permute: rank k of M takes block k of the rows in
    ``row_shard_order``'s order (``R'`` rows, the pad rows zero) and
    slice k of the scales and counts, each padded to a multiple of M."""
    own: torch.Tensor         # [1, R'/M, C] fp32 payload rows
    codes: torch.Tensor       # [1, R'/M, C] their codes
    wire: torch.Tensor        # [1, B'/M] int8, the block encoded
    scales: torch.Tensor      # [1, T'/M] fp32 scale slice
    counts: torch.Tensor      # [1, C'/M] count slice
    seg: torch.Tensor         # [R'/M] int64 segment of each block row
    rows: np.ndarray          # [R'/M] payload row of each (pad rows >= R)
    local_bits: np.ndarray    # [R'/M] wire width of each block row
    inv_order: torch.Tensor   # [R] int64: shard order -> payload rows


def _row_block(buf, codes, scales, counts, seg_ids, seg_bits, m: int,
               k: int) -> _Block:
    """Rank ``k``'s :class:`_Block` of the node payload ``buf`` /
    ``codes [1, R, C]``, ``scales [1, T]`` and ``counts [1, C]``.  Pad
    rows are appended zero; each borrows a segment id of its width group
    (the first row's), assigned over the groups in ascending width as
    ``row_shard_order`` assigns them, so the receiver's scale lookup stays
    in range (its codes are zero, so the scale never matters)."""
    ids = np.asarray(seg_ids)
    row_b = np.asarray(seg_bits)[ids]
    order, inv_order, local_bits = row_shard_order(row_b, m)
    rloc = len(order) // m
    n_pad = len(order) - len(ids)
    pad_ids = []
    for b in sorted(set(row_b.tolist())):
        grp = np.nonzero(row_b == b)[0]
        pad_ids += [int(ids[grp[0]])] * ((-len(grp)) % m)
    ids_full = np.concatenate([ids, np.asarray(pad_ids, ids.dtype)])
    mine = order[k * rloc:(k + 1) * rloc]
    dev = buf.device
    take = torch.as_tensor(mine, dtype=torch.int64, device=dev)

    def block(x):
        return torch.nn.functional.pad(x, (0, 0, 0, n_pad)).index_select(
            1, take)

    def part(x):
        w = x.shape[1] + (-x.shape[1]) % m
        return torch.nn.functional.pad(x, (0, w - x.shape[1]))[
            :, k * (w // m):(k + 1) * (w // m)].contiguous()

    codes_b = block(codes)
    return _Block(block(buf), codes_b,
                  Q.encode_wire(codes_b, np.arange(rloc), seg_bits=local_bits),
                  part(scales), part(counts),
                  _seg_index(ids_full[mine], dev), mine, local_bits,
                  torch.as_tensor(inv_order, dtype=torch.int64, device=dev))


def _make_row_sharded_core(tp: _GlooTransport, node: _GlooTransport,
                           wire: WireSpec, adj: np.ndarray, overlap: bool):
    """The row-sharded permute (``repro``'s
    ``_make_profe_round_ppermute_sharded``): ``tp`` is this rank's pod
    group (rank = node), ``node`` its node group (rank = inner index k).
    Every rank packs and quantizes its node's whole payload (the replicas
    make it identical on all M ranks), then moves only its
    :class:`_Block` a permutation step to inner index k of the
    destination node.  Within the node the received scale and count
    slices are widened (one all-gather a step), the received prototype
    rows, scattered to their slots, summed (one all-reduce a round: each
    row lives on one rank, the others add zeros, so the sum is exact),
    and the mixed blocks gathered and put back in payload order.  The
    mix runs step by step (``mix_packed_init`` + one
    ``mix_packed_accumulate`` a step) on the rank's block, as
    ``repro``'s does; ``overlap`` posts step s+1 before step s is
    folded.  Every rank of a node ends with the same student, bit for
    bit."""
    perms, srcs = _perm_lowering(adj)
    me, m, k = tp.rank, node.world, node.rank

    @torch.no_grad()
    def _round(students, protos, counts, sizes, ef_state):
        if counts.shape[0] != 1:
            raise ValueError(f"exchange='ppermute' holds one node per rank, "
                             f"got {counts.shape[0]}")
        buf, seg_ids, meta, ploc, splice = _pack_payload(protos, students,
                                                         wire)
        codes, scales, state = _quantize_with_state(wire, buf, seg_ids, meta,
                                                    ef_state)
        dev = buf.device
        blk = _row_block(buf, codes, scales, counts, seg_ids, meta[3], m, k)
        prow, pnrows, pshape = ploc
        ncls = pshape[1]
        w_self_v, w_neigh = gossip_matrix_dyn(
            adj, sizes.to(device=dev, dtype=torch.float32))
        w_row = w_neigh[me:me + 1]
        # the block rows that hold prototypes, and their slots
        prot = (blk.rows >= prow) & (blk.rows < prow + pnrows)
        p_take = torch.as_tensor(np.nonzero(prot)[0], device=dev)
        p_slot = torch.as_tensor(blk.rows[prot] - prow, device=dev)
        n_sl, n_sc = blk.scales.shape[1], blk.counts.shape[1]
        acc = Q.mix_packed_init(blk.own, w_self_v[me:me + 1])
        parts, rcnts, valids = [], [], []
        for (rw, rs, rcnt), src in zip(_permute_steps(
                tp, perms, srcs, (blk.wire, blk.scales, blk.counts), dev,
                overlap), srcs):
            (side,) = node.all_gather([torch.cat([rs, rcnt], dim=1)], dev)
            side = side.reshape(m, n_sl + n_sc)
            rd = side[:, :n_sl].reshape(-1)[blk.seg]
            rc = Q.decode_wire(rw, np.arange(len(blk.rows)),
                               seg_bits=blk.local_bits)
            valid, w_p = _step_weight(src, me, w_row)
            acc = Q.mix_packed_accumulate(acc, rc, rd[None],
                                          w_p.reshape(1, 1))
            part = torch.zeros((pnrows, rc.shape[2]), dtype=torch.float32,
                               device=dev)
            part[p_slot] = rc[0, p_take].to(torch.float32) * \
                rd[p_take, None]
            parts.append(part)
            rcnts.append(side[:, n_sl:].reshape(-1)[:ncls])
            valids.append(valid)
        # Eq. 4 over the neighbourhood; the own prototypes enter
        # quantized, like every receiver's view
        num = counts[0][:, None] * _proto_view(
            codes, scales[:, _seg_index(seg_ids, dev)], ploc)[0]
        den = counts[0]
        if parts:
            full = node.all_reduce_sum(torch.stack(parts), dev)
            for pr, rcnt, valid in zip(full, rcnts, valids):
                pr = pr.reshape(-1)[:ncls * pshape[2]].reshape(ncls,
                                                               pshape[2])
                num = num + valid * rcnt[:, None] * pr
                den = den + valid * rcnt
        glob = num / torch.clamp_min(den, 1.0)[:, None]
        mask = (den > 0).to(torch.float32)
        (blocks,) = node.all_gather([acc], dev)              # [M, R'/M, C]
        mixed = blocks.reshape(1, -1, blocks.shape[2]).index_select(
            1, blk.inv_order)
        return (_splice_students(mixed, splice), glob[None], mask[None],
                state)

    return _round


def _make_gather_core(tp: _GlooTransport, wire: WireSpec,
                      adj: Optional[np.ndarray]):
    """The per-leaf reference exchange (``repro``'s gather): the payload
    ``{protos, student}`` quantized per (node, leaf) at each group's
    width (with ``+ef`` the residual replayed into each leaf first) —
    through the packed codec's sweeps, bit-identical to the per-leaf
    math — then each leaf's int codes (their container dtype) and per-node
    scales all-gathered leaf by leaf, dequantized, and mixed with
    ``mix_node_trees`` (own copy unquantized), or with ``adjacency=None``
    the size-weighted mean of all the copies.  Takes a per-leaf student
    tree; :func:`_plane_views` adapts a plane."""
    include = None if adj is None else include_matrix(adj)

    @torch.no_grad()
    def _round(students, protos, counts, sizes, ef_state):
        n_local = counts.shape[0]
        lo = _first_node(tp, n_local, sizes.shape[0])
        dev = protos.device
        buf, seg_ids, meta = Q.pack_tree_nodes(
            {"protos": protos, "student": students}, wire)
        codes, scales, new_state = _quantize_with_state(wire, buf, seg_ids,
                                                        meta, ef_state)
        # each float leaf's codes [n_local, ...] in the narrowest int
        # container of its own width, and its scale [n_local]
        items = [(item[1], item[5]) for item in meta[0]
                 if item[0] == "packed"]
        leaf_codes = [x.to(Q._wire_int_dtype(int(meta[3][seg])))
                      for (_, seg), (_, x) in zip(items, tree_paths(
                          Q.unpack_tree_nodes(codes, meta)))]
        got = tp.all_gather(leaf_codes + [scales[:, seg] for _, seg in items]
                            + [counts], dev)
        k = len(items)
        deq = tree_from_paths(
            ((path, dequantize_leaf(c, d)) for (path, _), c, d
             in zip(items, got[:k], got[k:2 * k])), tree_empties(
                {"protos": protos, "student": students}))
        counts_all = got[2 * k]
        protos_rx = deq["protos"]
        sizes = sizes.to(device=dev, dtype=torch.float32)
        if adj is None:
            glob, mask = aggregate_prototypes(protos_rx, counts_all)
            return (_full_mean(sizes, deq["student"], n_local), glob, mask,
                    new_state)
        w_self, w_rows = _weights(adj, sizes, lo, n_local)
        new_students = mix_node_trees(w_self, w_rows, students,
                                      deq["student"])
        glob, mask = neighborhood_prototype_aggregate(
            torch.as_tensor(include[lo:lo + n_local], device=dev),
            protos_rx, counts_all)
        return new_students, glob, mask, new_state

    return _round


def _plane_views(core):
    """The gather exchanges are per-leaf math end to end: a plane student
    (``core``'s first argument, and a plane residual in a
    :class:`CodecState` argument) goes in as leaf views, and the mixed
    leaves (the first result, or the only one, and the new residual)
    come back packed into fresh planes."""
    def views(x):
        if isinstance(x, CodecState) and isinstance(
                x.residual.get("student"), Plane):
            return CodecState(dict(x.residual, student=as_tree(
                x.residual["student"])), x.seq)
        return x

    def planes(x, meta):
        if isinstance(x, CodecState):
            return CodecState(dict(x.residual, student=_replane(
                x.residual["student"], meta)), x.seq)
        return x

    def _round(students, *rest):
        if not isinstance(students, Plane):
            return core(students, *rest)
        meta = students.meta
        out = core(as_tree(students), *(views(x) for x in rest))
        if not isinstance(out, tuple):
            return _replane(out, meta)
        return (_replane(out[0], meta),) + tuple(planes(x, meta)
                                                 for x in out[1:])
    return _round


def _wrap_ef(core, wire: WireSpec):
    """The round's arity follows the spec: stateless specs take
    ``(students, protos, counts, sizes)`` and return three results;
    error-feedback specs also take and return the ``CodecState``."""
    if wire.error_feedback:
        def round_fn(students, protos, counts, sizes, codec_state):
            return core(students, protos, counts, sizes, codec_state)
        return round_fn

    def round_fn(students, protos, counts, sizes):
        return core(students, protos, counts, sizes, None)[:3]
    return round_fn


# -- the adapter-rank round -----------------------------------------------------

def _make_adapter_round(tp: _GlooTransport, wire: WireSpec,
                        adj: Optional[np.ndarray], mode: str, *, rank: int,
                        grams: bool, overlap: bool, inner: int = 1):
    """The adapter-rank wire on the mesh (``repro``'s
    ``_make_profe_round_adapter``).  Each node shares the payload
    ``{"adapters", "protos", "student": rest[, "grams"]}`` of
    ``round_ops.adapter_share_nodes`` through the packed codec (``+ef``:
    its residual mirrors that payload), and every receiver merges its
    neighbours' low-rank deltas onto its own student while the rest
    gossips classically:

        round(students, protos, counts, sizes, adapter_state
              [, codec_state]) -> (students', global protos, mask,
                                   adapter_state' [, codec_state'])

    * ``gather``: the packed codes (container width) and scales
      all-gathered, dequantized, and ``round_ops.adapter_merge_nodes``
      for this rank's receivers over all N senders;
    * ``packed``: the same through the encoded wire bytes;
    * ``ppermute``: one step a neighbour; the rank's S received steps,
      re-sorted into ascending-sender order (invalid steps last, zeroed)
      so the merge sums its terms in the other exchanges' order — the
      RegMean solve magnifies a reordered sum — are the senders of one
      ``lowrank_apply`` a matrix leaf with the rank's node as its one
      receiver (with grams each step's ``A`` adjusted for it, the
      kernel's per-receiver design).  ``overlap`` double buffers the
      permutes.

    The full protocol (``adjacency=None``) raises: merge-based
    aggregation is neighbourhood-wise, every node applies deltas onto
    its own weights, so the nodes never end identical.  So does
    ``ppermute`` with several ranks a node (``inner`` > 1): the adapter
    wire has no row-sharded permute; ``packed`` and ``gather`` run
    replicated on the pod group ``tp``."""
    from repro_torch.core.adapters import split_student
    from repro_torch.core.aggregation import regmean_adjust
    from repro_torch.kernels.lowrank_apply.ops import (adapter_apply_plane,
                                                       adapter_apply_tree)
    if adj is None:
        raise ValueError("the adapter wire needs an explicit adjacency "
                         "(merge-based aggregation is neighbourhood-wise; "
                         "the full protocol's identical-output semantics "
                         "do not apply)")
    if mode == "ppermute" and inner > 1:
        raise ValueError("adapter_rank does not support the row-sharded "
                         "ppermute exchange (inner mesh axes > 1) — use "
                         "exchange='packed'")
    include = include_matrix(adj)
    perms, srcs = _perm_lowering(adj) if mode == "ppermute" else (None, None)
    me = tp.rank

    def exchange_all(codes, scales, counts, seg_ids, meta, dev):
        """gather / packed: every node's dequantized payload ``[N, ...]``
        and counts ``[N, C]``."""
        if mode == "gather":
            codes_all, scales_all, counts_all = tp.all_gather(
                [codes, scales, counts], dev)
        else:
            enc = Q.encode_wire(codes, seg_ids, seg_bits=meta[3])
            wire_all, scales_all, counts_all = tp.all_gather(
                [enc, scales, counts], dev)
            codes_all = Q.decode_wire(wire_all, seg_ids, seg_bits=meta[3])
        row_delta = scales_all[:, _seg_index(seg_ids, dev)]
        recv = dict(Q.unpack_tree_nodes(codes_all.to(torch.float32) *
                                        row_delta[:, :, None], meta))
        return recv, counts_all

    def exchange_steps(codes, scales, counts, seg_ids, meta, dev):
        """ppermute: the S received steps ``[S, R, C]`` dequantized and
        their counts ``[S, C]``, in the order the permutes ran."""
        ids = _seg_index(seg_ids, dev)
        enc = Q.encode_wire(codes, seg_ids, seg_bits=meta[3])
        dqs, cnts = [], []
        for rw, rs, rcnt in _permute_steps(tp, perms, srcs,
                                           (enc, scales, counts), dev,
                                           overlap):
            rc = Q.decode_wire(rw, seg_ids, seg_bits=meta[3])
            dqs.append(rc[0].to(torch.float32) * rs[0, ids][:, None])
            cnts.append(rcnt[0])
        return dqs, cnts

    @torch.no_grad()
    def core(students, protos, counts, sizes, ast, ef_state):
        n_local = counts.shape[0]
        lo = _first_node(tp, n_local, sizes.shape[0])
        groups, new_ast, layout = R.adapter_share_nodes(
            students, ast, rank=rank, grams=grams)
        buf, seg_ids, meta = Q.pack_tree_nodes(dict(groups, protos=protos),
                                               wire)
        codes, scales, new_ef = _quantize_with_state(wire, buf, seg_ids,
                                                     meta, ef_state)
        dev = buf.device
        sizes = sizes.to(device=dev, dtype=torch.float32)
        if mode != "ppermute":
            recv, counts_all = exchange_all(codes, scales, counts, seg_ids,
                                            meta, dev)
            protos_rx = recv.pop("protos")
            w_self, w_rows = _weights(adj, sizes, lo, n_local)
            merged = R.adapter_merge_nodes(_fresh(students), recv, w_self,
                                           w_rows, rank=rank, grams=grams)
            glob, mask = neighborhood_prototype_aggregate(
                torch.as_tensor(include[lo:lo + n_local], device=dev),
                protos_rx, counts_all)
            return merged, glob, mask, new_ast, new_ef
        if n_local != 1:
            raise ValueError(f"exchange='ppermute' holds one node per rank, "
                             f"got {n_local}")
        dqs, cnts = exchange_steps(codes, scales, counts, seg_ids, meta, dev)
        src_me = np.asarray([int(src[me]) for src in srcs])
        valid = src_me >= 0
        n = sizes.shape[0]
        order = np.argsort(np.where(valid, src_me, n), kind="stable")
        vmask = torch.as_tensor(valid[order].astype(np.float32), device=dev)
        w_self_v, w_neigh = gossip_matrix_dyn(adj, sizes)
        c_steps = vmask * w_neigh[me, torch.as_tensor(
            np.maximum(src_me[order], 0), device=dev)]           # [S]
        dq = torch.stack([dqs[k] for k in order]) * vmask[:, None, None]
        cnt = torch.stack([cnts[k] for k in order]) * vmask[:, None]
        recv = dict(Q.unpack_tree_nodes(dq, meta))                    # [S, ...]
        protos_rx = recv.pop("protos")                          # [S, C, P]
        # Eq. 4: the own prototypes enter quantized, as every receiver's
        own_p = Q.unpack_tree_nodes(
            codes.to(torch.float32) * scales[:, _seg_index(seg_ids, dev)]
            [:, :, None], meta)["protos"]                       # [1, C, P]
        num = counts[:, :, None] * own_p + \
            torch.sum(cnt[None, :, :, None] * protos_rx[None], dim=1)
        den = counts + torch.sum(cnt[None], dim=1)
        glob = num / torch.clamp_min(den, 1.0)[:, :, None]
        mask = (den > 0).to(torch.float32)
        # the merge: the rest mixes classically, each matrix leaf takes
        # the receiver's S steps through one lowrank_apply
        tree = as_tree(students)
        _, rest_own = split_student(layout, tree)
        rest_mixed = mix_node_trees(w_self_v[me:me + 1], c_steps[None],
                                    rest_own, recv["student"])
        factors = {}
        for nm in layout.mat_names:
            f = recv["adapters"][nm]
            a = f["A"]
            if grams:
                a = regmean_adjust(a[None], recv["grams"][nm][None],
                                   c_steps[None], per_recv=True)
            factors[nm] = {"A": a, "B": f["B"]}
        if isinstance(students, Plane):
            merged = adapter_apply_plane(_fresh(students), layout,
                                         c_steps[None], factors, rest_mixed)
        else:
            merged = adapter_apply_tree(tree, layout, c_steps[None], factors,
                                        rest_mixed)
        return merged, glob, mask, new_ast, new_ef

    def round_fn(students, protos, counts, sizes, adapter_state, *rest):
        if len(rest) != (1 if wire.error_feedback else 0):
            raise TypeError("the adapter round takes a codec_state exactly "
                            "when the wire spec has error feedback")
        out = core(students, protos, counts, sizes, adapter_state,
                   rest[0] if rest else None)
        return out if wire.error_feedback else out[:4]
    return round_fn


def make_profe_round(group=None, *, bits: int = 16,
                     adjacency: Optional[np.ndarray] = None,
                     exchange: str = "auto",
                     spec: Optional[WireSpec] = None,
                     overlap: bool = False,
                     proto_pass: str = "exact",
                     adapter_rank: int = 0,
                     adapter_grams: bool = False,
                     ranks_per_node: int = 1):
    """Returns ``round_fn(students, protos, counts, sizes[, codec_state])``
    for this rank of ``group`` (the default process group when None).

    ``students`` is the rank's stacked student: a :class:`Plane`
    ``[n_local, R, 512]`` or a per-leaf tree of ``[n_local, ...]``
    leaves; ``protos [n_local, C, P]`` and ``counts [n_local, C]`` its
    nodes' Eq. 3 prototypes and class counts, and ``sizes [N]`` every
    node's dataset size.  Rank ``r`` holds nodes ``r·n_local … (r+1)·
    n_local - 1``.  Returns ``(students, global protos, mask[,
    codec_state])``: with an ``adjacency`` the mixed students (a plane
    comes back a plane, a tree a tree), ``[n_local, C, P]`` prototypes
    and ``[n_local, C]`` mask of the rank's nodes; with
    ``adjacency=None`` the rank's rows of the global mean (all
    identical) and the global ``[C, P]`` prototypes and ``[C]`` mask.

    ``spec`` sets the wire format (``bits`` is the uniform shorthand);
    with error feedback the round takes and returns the rank's
    :class:`CodecState` (residual ``{protos, student}`` mirroring the
    payload, ``seq [n_local]``).  ``proto_pass="fused"`` takes the raw
    Eq. 3 sums in place of ``protos`` and normalizes them on the way in.
    ``exchange`` and ``overlap`` are as in the module docstring; every
    exchange moves the same payloads to the same mix weights.

    ``adapter_rank=r > 0`` switches to the adapter-rank wire (with
    ``adapter_grams``, RegMean): the round becomes
    ``round_fn(students, protos, counts, sizes, adapter_state[,
    codec_state])`` and also returns the new adapter state; it needs an
    adjacency (see :func:`_make_adapter_round`).

    ``ranks_per_node=M > 1`` gives every node M ranks of ``group`` (rank
    ``r`` is inner index ``r % M`` of node ``r // M``), each holding a
    replica of its node's state, ``n_local`` 1: ``ppermute`` is then the
    row-sharded permute, every other exchange runs replicated over the
    node's ranks (module docstring).  Every rank of ``group`` must make
    the call, in the same order: it creates the pod and node groups."""
    if proto_pass not in PROTO_PASSES:
        raise ValueError(f"proto_pass must be one of {PROTO_PASSES}, "
                         f"got {proto_pass!r}")
    wire = spec if spec is not None else WireSpec.from_bits(bits)
    if wire.stochastic_rounding:
        # repro's mesh round takes no noise key: its quantize step rounds
        # to nearest whatever the spec says
        raise ValueError("the mesh round takes no PRNG key: repro's mesh "
                         "round rounds to nearest even with "
                         "stochastic_rounding set, so the port refuses the "
                         "spec rather than fake unbiased codes")
    tp, node = _transports(group, ranks_per_node)
    adj = None if adjacency is None else np.asarray(adjacency)
    mode = _resolve_exchange(exchange, adj, tp.world)
    if adapter_rank:
        fn = _make_adapter_round(tp, wire, adj, mode, rank=adapter_rank,
                                 grams=adapter_grams, overlap=overlap,
                                 inner=ranks_per_node)
    else:
        if mode == "ppermute" and node is not None:
            core = _make_row_sharded_core(tp, node, wire, adj, overlap)
        elif mode == "ppermute":
            core = _make_ppermute_core(tp, wire, adj, overlap)
        elif mode == "gather":
            core = _plane_views(_make_gather_core(tp, wire, adj))
        else:
            core = _make_packed_core(tp, wire, adj)
        fn = _wrap_ef(core, wire)
    if proto_pass == "exact":
        return fn

    def fused_round(students, sums, counts, *rest):
        return fn(students, normalize_protos(sums, counts), counts, *rest)
    return fused_round


# -- the FedAvg baseline --------------------------------------------------------

def make_fedavg_round(group=None, *, adjacency: Optional[np.ndarray] = None,
                      exchange: str = "auto", ranks_per_node: int = 1):
    """FedAvg on the mesh (``repro``'s ``make_fedavg_round``): returns
    ``round_fn(models, sizes)`` for this rank of ``group``.  ``models``
    is the rank's full models at fp32, a stacked :class:`Plane`
    ``[n_local, R, 512]`` or a per-leaf tree; nothing is quantized.

    * ``packed``: ONE all-gather of the ``[n_local, R, 512]`` buffer — a
      plane's own buffer (the wire is the plane, nothing is repacked), a
      tree packed by ``pack_tree_nodes`` — then ``mix_packed`` at unit Δ
      (fp32 codes) for the rank's receivers;
    * ``ppermute``: one ``batch_isend_irecv`` of the buffer a permutation
      step, then ``mix_packed`` at unit Δ over the S received buffers;
    * ``gather``: each leaf all-gathered at its own dtype, then
      ``mix_node_trees`` (a plane as leaf views, rewrapped).

    With an ``adjacency`` the neighbourhood-weighted mix (own copy
    included at its weight); with ``adjacency=None`` the size-weighted
    mean of all N models, every node identical.  A plane comes back a
    plane, a tree a tree in its leaves' dtypes.  With
    ``ranks_per_node=M > 1`` every exchange runs replicated: each of a
    node's M ranks moves the whole model on its pod group, as
    ``repro``'s FedAvg does on a multi-axis pod."""
    tp, _ = _transports(group, ranks_per_node)
    adj = None if adjacency is None else np.asarray(adjacency)
    mode = _resolve_exchange(exchange, adj, tp.world)
    me = tp.rank
    perms, srcs = _perm_lowering(adj) if mode == "ppermute" else (None, None)

    def as_buffer(models):
        if isinstance(models, Plane):
            return models.buf.detach(), None
        buf, _, meta = Q.pack_tree_nodes(models)
        return buf, meta

    def back(models, mixed, meta):
        if isinstance(models, Plane):
            return Plane(mixed, models.meta)
        return tree_map(lambda new, old: new.to(old.dtype),
                        Q.unpack_tree_nodes(mixed, meta), models)

    @_plane_views
    @torch.no_grad()
    def gather_round(models, sizes):
        items = tree_paths(models)
        n_local = items[0][1].shape[0]
        lo = _first_node(tp, n_local, sizes.shape[0])
        dev = items[0][1].device
        got = tp.all_gather([x for _, x in items], dev)
        gathered = tree_from_paths(((p, g) for (p, _), g in zip(items, got)),
                                   tree_empties(models))
        sizes = sizes.to(device=dev, dtype=torch.float32)
        if adj is None:
            return _full_mean(sizes, gathered, n_local, like=models)
        w_self, w_rows = _weights(adj, sizes, lo, n_local)
        return mix_node_trees(w_self, w_rows, models, gathered)

    @torch.no_grad()
    def packed_round(models, sizes):
        buf, meta = as_buffer(models)
        n_local = buf.shape[0]
        lo = _first_node(tp, n_local, sizes.shape[0])
        dev = buf.device
        (gathered,) = tp.all_gather([buf], dev)      # ONE fp32 all-gather
        deltas = torch.ones(gathered.shape[:2], dtype=torch.float32,
                            device=dev)
        w_self, w_rows = _weights(adj, sizes.to(device=dev,
                                                dtype=torch.float32),
                                  lo, n_local)
        return back(models, Q.mix_packed(buf, gathered, deltas, w_self,
                                         w_rows), meta)

    @torch.no_grad()
    def ppermute_round(models, sizes):
        buf, meta = as_buffer(models)
        if buf.shape[0] != 1:
            raise ValueError(f"exchange='ppermute' holds one node per rank, "
                             f"got {buf.shape[0]}")
        dev = buf.device
        w_self_v, w_neigh = gossip_matrix_dyn(
            adj, sizes.to(device=dev, dtype=torch.float32))
        recv = [rb for (rb,) in _permute_steps(tp, perms, srcs, (buf,), dev,
                                               overlap=False)]
        ws = [_step_weight(src, me, w_neigh[me:me + 1])[1] for src in srcs]
        stack = torch.cat(recv)                        # [S, R, C] fp32
        deltas = torch.ones(stack.shape[:2], dtype=torch.float32, device=dev)
        return back(models, Q.mix_packed(buf, stack, deltas,
                                         w_self_v[me:me + 1],
                                         torch.stack(ws)[None, :]), meta)

    return {"gather": gather_round, "packed": packed_round,
            "ppermute": ppermute_round}[mode]
