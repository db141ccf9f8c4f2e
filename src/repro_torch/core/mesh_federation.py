"""ProFe round over ``torch.distributed`` — the multi-node exchange.

One federation node per rank of a process group: a rank stands for a
device of ``repro``'s ``pod`` mesh axis (``core/mesh_federation.py``).
Every rank holds its nodes' stacked state — a student :class:`Plane`
``[n_local, R, 512]``, prototypes ``[n_local, C, P]`` and counts
``[n_local, C]`` — and the round moves only the encoded wire buffer
between ranks.

**Wire content.**  A node's whole payload, prototypes and student rows,
is ONE packed ``[R, 512]`` code buffer (``pack_plane_payload``: the
student's rows spliced straight off its plane) quantized per (node,
leaf) segment and serialized by ``encode_wire`` into ``[B]`` int8 bytes
— exactly the bytes of the :class:`WireSpec` (int16 rows bitcast, int4
rows nibble-packed) — plus its segment scales ``[T]`` and the raw class
counts ``[C]``.  The receiver decodes the codes and applies its gossip
weights to them in one fused dequantize-and-mix (``mix_packed``, one
CUDA launch on the card).

**Exchanges** (``exchange=``):

* ``"ppermute"`` — sparse gossip: the adjacency is lowered by
  :func:`repro_torch.core.topology.permutation_rounds` to permutation
  steps, and each step is one ``batch_isend_irecv`` of the encoded
  buffer, its scales and its counts.  A rank moves degree × one copy a
  round, what ``ScheduleCommAccountant`` charges.  Needs one rank per
  node.  A rank that nobody sends to in a step receives zeros at weight
  0, as ``jax.lax.ppermute`` gives it.
* ``"packed"`` — one ``all_gather`` of every rank's encoded
  ``[n_local, B]`` buffer (and scales and counts), then the mix of the
  rank's own receivers over all N senders.  The node axis splits evenly
  over the ranks, as ``repro`` shards it over ``pod``, so one rank
  holding all N nodes is a valid packed run.
* ``"auto"`` — ``ppermute`` for a regular graph with one rank per node,
  else ``packed``.

**Overlap** (``overlap=True``, ppermute only): step ``s+1``'s sends and
receives are posted before step ``s``'s payload is folded into the mix
(``mix_packed_accumulate``): double buffering with the same payloads
and weights, and byte-identical traffic.

**Topologies.**  With a 0/1 ``adjacency`` students mix per node over
``{i} ∪ neigh(i)`` (own copy unquantized) and prototypes aggregate per
neighbourhood (Eq. 4); with ``adjacency=None`` (the paper's
fully-connected protocol) every node ends with the size-weighted mean of
all the quantized copies and the global Eq. 4 prototypes ``[C, P]``.

**Transport.**  gloo moves host tensors only, so the encoded buffer,
scales and counts are copied to the host before each collective and back
to the compute device after; encode, decode, the mix and Eq. 4 stay on
the compute device.  Every other backend raises — NCCL (one card per
rank) is not ported.  :data:`COLLECTIVE_BYTES` counts the bytes of the
tensors this process hands to collectives.

An error-feedback spec (``+ef``) adds a :class:`CodecState` operand and
result; its residual stays on the rank and never enters a collective.
Options outside this slice raise ``NotImplementedError`` naming their
``ROADMAP.md`` queue item.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import topology as T
from repro_torch.core.federation import _unported
from repro_torch.core.profe import normalize_protos
from repro_torch.core.prototypes import aggregate_prototypes
from repro_torch.core.round_ops import (gossip_matrix_dyn, include_matrix,
                                        neighborhood_prototype_aggregate)
from repro_torch.core.wire_state import CodecState, next_seq
from repro_torch.kernels.quantize import ops as Q
from repro_torch.optim.plane import Plane
from repro_torch.wirespec import WireSpec

EXCHANGES = ("auto", "gather", "packed", "ppermute")
PROTO_PASSES = ("exact", "fused")
ITEM = "Queue 1 item 12 (multi-node exchange)"


class ByteCounter:
    """Bytes of the tensors this process handed to collectives (each
    rank counts its own): a round adds what it sends, so it can be held
    against ``ScheduleCommAccountant``."""

    def __init__(self):
        self.count = 0


COLLECTIVE_BYTES = ByteCounter()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _GlooTransport:
    """The collectives of one round over a gloo process group, on host
    copies of the payload."""

    def __init__(self, group):
        self.group = group if group is not None else dist.group.WORLD
        backend = str(dist.get_backend(self.group))
        if backend != "gloo":
            raise _unported(f"the {backend!r} backend (only gloo is "
                            f"ported; NCCL, one card per rank, waits for a "
                            f"machine with several cards)", ITEM)
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)

    def _peer(self, group_rank: int) -> int:
        return dist.get_global_rank(self.group, group_rank)

    def all_gather(self, tensors: Sequence[torch.Tensor], device
                   ) -> List[torch.Tensor]:
        """Every rank's ``[n_local, ...]`` tensors concatenated in rank
        order, ``[N, ...]`` on ``device``."""
        out = []
        for t in tensors:
            host = t.detach().contiguous().cpu()
            parts = [torch.empty_like(host) for _ in range(self.world)]
            COLLECTIVE_BYTES.count += _nbytes(host)
            dist.all_gather(parts, host, group=self.group)
            out.append(torch.cat(parts).to(device))
        return out

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
                COLLECTIVE_BYTES.count += _nbytes(t)
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
                      world: int) -> str:
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, "
                         f"got {exchange!r}")
    if exchange == "gather":
        raise _unported("exchange='gather' (the per-leaf reference)", ITEM)
    if exchange == "ppermute":
        if adj is None:
            raise ValueError("exchange='ppermute' needs an adjacency")
        if world != adj.shape[0]:
            raise ValueError(f"exchange='ppermute' needs one rank per node "
                             f"(world={world}, N={adj.shape[0]})")
        return exchange
    if exchange != "auto":
        return exchange
    if adj is not None and world == adj.shape[0] and T.is_regular(adj):
        return "ppermute"
    return "packed"


class _Sent(NamedTuple):
    """The sender side of one round on this rank."""
    buf: torch.Tensor         # [n_local, R, 512] fp32, the own payload
    seg_ids: np.ndarray       # [R]
    seg_bits: np.ndarray      # [T]
    ploc: Tuple               # (row, nrows, protos shape) of the protos
    splice: Tuple             # (plane, r_protos, span) for the students
    codes: torch.Tensor       # [n_local, R, 512] wire ints
    scales: torch.Tensor      # [n_local, T] fp32
    wire: torch.Tensor        # [n_local, B] int8, what travels
    state: Optional[CodecState]


def _pack_payload(protos, students, wire: WireSpec):
    """Wire pack of ``{protos, student}`` with the student rows spliced
    straight off its plane: ``(buf, seg_ids, meta, ploc, splice)``."""
    if not isinstance(students, Plane):
        raise TypeError("the mesh round exchanges a stacked student Plane; "
                        f"got {type(students).__name__} (the per-leaf "
                        "student is not ported)")
    buf, seg_ids, meta, r_p, span = Q.pack_plane_payload(protos, students,
                                                         wire)
    return (buf, seg_ids, meta, (0, r_p, tuple(protos.shape)),
            (students, r_p, span))


def _splice_students(mixed, splice) -> Plane:
    """The mixed buffer's student rows as a fresh plane (the trailing
    alignment rows zero, a fixed point of the mix)."""
    plane, r_p, span = splice
    sbuf = torch.nn.functional.pad(mixed[:, r_p:r_p + span],
                                   (0, 0, 0, plane.meta.rows - span))
    return Plane(sbuf, plane.meta)


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
    plane-backed residual packs into the payload's layout, updates in
    the same sweep and splits back — it never feeds a collective."""
    if ef_state is None:
        codes, scales = Q.quantize_packed_buffer(buf, seg_ids, meta[1],
                                                 seg_bits=meta[3])
        return codes, scales, None
    res = ef_state.residual
    res_buf, _, _, r_p, span = Q.pack_plane_payload(res["protos"],
                                                    res["student"])
    if res_buf.shape != buf.shape:
        raise ValueError(f"residual buffer {tuple(res_buf.shape)} does not "
                         f"match the payload buffer {tuple(buf.shape)}")
    codes, scales, new_res = Q.quantize_packed_buffer(
        buf, seg_ids, meta[1], seg_bits=meta[3], residual=res_buf,
        ef_decay=wire.ef_decay)
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
    return _Sent(buf, seg_ids, meta[3], ploc, splice, codes, scales, enc,
                 state)


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


def _make_packed_core(tp: _GlooTransport, wire: WireSpec,
                      adj: Optional[np.ndarray]):
    """Packed exchange: ONE all-gather of every rank's encoded buffer,
    scales and counts -> decode -> the fused mix for this rank's own
    receivers -> Eq. 4 per neighbourhood (or global)."""
    include = None if adj is None else include_matrix(adj)

    @torch.no_grad()
    def _round(students, protos, counts, sizes, ef_state):
        n_local, n = counts.shape[0], sizes.shape[0]
        if n != n_local * tp.world:
            raise ValueError(f"{n} nodes do not split evenly into "
                             f"{n_local} per rank over {tp.world} ranks")
        lo = tp.rank * n_local
        sent = _send_side(protos, students, wire, ef_state)
        dev = sent.buf.device
        wire_all, scales_all, counts_all = tp.all_gather(
            [sent.wire, sent.scales, counts], dev)
        codes_all = Q.decode_wire(wire_all, sent.seg_ids,
                                  seg_bits=sent.seg_bits)
        row_delta = scales_all[:, _seg_index(sent.seg_ids, dev)]  # [N, R]
        sizes = sizes.to(device=dev, dtype=torch.float32)
        if adj is None:
            w = sizes / torch.sum(sizes)
            w_self = torch.zeros((n_local,), dtype=torch.float32, device=dev)
            w_rows = w[None, :].expand(n_local, n)
        else:
            w_self_v, w_neigh = gossip_matrix_dyn(adj, sizes)
            w_self = w_self_v[lo:lo + n_local]
            w_rows = w_neigh[lo:lo + n_local]
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
        host = [t.detach().contiguous().cpu()
                for t in (sent.wire, sent.scales, counts)]

        def post(s):
            return tp.post(perms[s], srcs[s], host, tag=3 * s)

        def receive(handle, src):
            rw, rs, rcnt = tp.wait(handle, dev)
            rc = Q.decode_wire(rw, sent.seg_ids, seg_bits=sent.seg_bits)
            valid, w_p = _step_weight(src, me, w_row)
            return rc, rs[:, ids], rcnt, valid, w_p

        if overlap:
            acc = Q.mix_packed_init(sent.buf, w_self)
            recv = []
            inflight = post(0)
            for s, src in enumerate(srcs):
                handle = inflight
                if s + 1 < len(perms):
                    inflight = post(s + 1)
                r = receive(handle, src)
                acc = Q.mix_packed_accumulate(acc, r[0], r[1],
                                              r[4].reshape(1, 1))
                recv.append(r)
            mixed = acc
        else:
            recv = [receive(post(s), src) for s, src in enumerate(srcs)]
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


def make_profe_round(group=None, *, bits: int = 16,
                     adjacency: Optional[np.ndarray] = None,
                     exchange: str = "auto",
                     spec: Optional[WireSpec] = None,
                     overlap: bool = False,
                     proto_pass: str = "exact",
                     adapter_rank: int = 0,
                     ranks_per_node: int = 1):
    """Returns ``round_fn(students, protos, counts, sizes[, codec_state])``
    for this rank of ``group`` (the default process group when None).

    ``students`` is the rank's stacked student :class:`Plane`
    ``[n_local, R, 512]``, ``protos [n_local, C, P]`` and ``counts
    [n_local, C]`` its nodes' Eq. 3 prototypes and class counts, and
    ``sizes [N]`` every node's dataset size.  Rank ``r`` holds nodes
    ``r·n_local … (r+1)·n_local - 1``.  Returns ``(students, global
    protos, mask[, codec_state])``: with an ``adjacency`` the mixed
    planes, ``[n_local, C, P]`` prototypes and ``[n_local, C]`` mask of
    the rank's nodes; with ``adjacency=None`` the rank's rows of the
    global mean (all identical) and the global ``[C, P]`` prototypes and
    ``[C]`` mask.

    ``spec`` sets the wire format (``bits`` is the uniform shorthand);
    with error feedback the round takes and returns the rank's
    :class:`CodecState` (residual ``{protos, student: Plane}``, ``seq
    [n_local]``).  ``proto_pass="fused"`` takes the raw Eq. 3 sums in
    place of ``protos`` and normalizes them on the way in.  ``exchange``
    and ``overlap`` are as in the module docstring; every exchange moves
    the same payloads to the same mix weights."""
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
    if adapter_rank:
        raise _unported("the adapter-rank mesh round", ITEM)
    if ranks_per_node != 1:
        raise _unported("the row-sharded permute (several ranks per node, "
                        "repro's multi-axis pods)", ITEM)
    tp = _GlooTransport(group)
    adj = None if adjacency is None else np.asarray(adjacency)
    if _resolve_exchange(exchange, adj, tp.world) == "ppermute":
        core = _make_ppermute_core(tp, wire, adj, overlap)
    else:
        core = _make_packed_core(tp, wire, adj)
    fn = _wrap_ef(core, wire)
    if proto_pass == "exact":
        return fn

    def fused_round(students, sums, counts, *rest):
        return fn(students, normalize_protos(sums, counts), counts, *rest)
    return fused_round


def make_fedavg_round(*args, **kwargs):
    """The FedAvg baseline on the mesh (``repro``'s
    ``make_fedavg_round``) is not ported: it needs the rest of the
    multi-node exchange."""
    raise _unported("make_fedavg_round", "Queue 1 item 12 (multi-node "
                    "exchange)")
