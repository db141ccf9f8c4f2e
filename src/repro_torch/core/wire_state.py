"""Stateful wire codec: the per-node error-feedback residual state.

Sub-byte wire widths discard a large quantization residual every round.
Error feedback keeps it on the node and replays it into the next
payload, at no extra wire bytes:

    eff_t   = x_t + decay * e_t
    wire_t  = Q(eff_t)                       (the only thing that travels)
    e_{t+1} = eff_t - deq(wire_t)            (stays on the node)

:class:`CodecState` is the carried state, as in ``repro``'s
``core/wire_state.py``: a residual mirroring the wire payload
(``{"protos": [N, C, P], "student": Plane}``, the student residual a
plane in the payload's row layout; or, for a per-leaf student or the
adapter wire's ``{"adapters", "protos", "student": rest[, "grams"]}``,
a tree of the payload's float leaves) and the sender's sequence
counter ``seq``.  It rides in :class:`repro_torch.core.profe.NodeState`'s
``wire_state`` field.  The packed sweep that updates it lives in
``kernels/quantize/ops.py`` (``quantize_packed_buffer(residual=)``);
this module holds the state, the per-leaf reference of the codec,
``ef_quantize_dequantize_tree``, which the packed sweep is held to, and
the per-node loop engine's codec on one node's plane,
``ef_quantize_dequantize_plane``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.round_ops import (_is_float, dequantize_leaf,
                                        quantize_leaf_per_node)
from repro_torch.optim.plane import Plane
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from repro_torch.wirespec import WireSpec


class CodecState(NamedTuple):
    """Per-node error-feedback state.  ``residual`` mirrors the wire
    payload; ``seq`` counts the payloads this state has quantized (an
    ``[N]`` int32 vector in the stacked engine, where all nodes advance
    together).  After quantizing payload ``t``
    (0-based) the state holds ``seq == t + 1`` and the error of payload
    ``t``.  The residuals never travel."""

    residual: Any
    seq: torch.Tensor


def next_seq(seq: torch.Tensor) -> torch.Tensor:
    """Advance a sequence counter by one quantize."""
    return seq + 1


def init_codec_state(payload, n_nodes: int) -> CodecState:
    """Zero residual state shaped like the stacked wire payload: fp32
    zeros for every float leaf (a ``Plane`` gives a zero plane with its
    recipe, ``{"protos", "student": Plane}`` the plane payload's
    residual), ``None`` for a non-float leaf, empty subtrees kept (the
    adapter payload's and a per-leaf student's tree residuals mirror
    their payloads), and an ``[n_nodes]`` zero ``seq``."""
    def zero(x):
        if isinstance(x, Plane):
            return Plane(torch.zeros(x.buf.shape, dtype=torch.float32,
                                     device=x.buf.device), x.meta)
        if not _is_float(x):
            return None
        return torch.zeros(tuple(x.shape), dtype=torch.float32,
                           device=x.device)
    leaves = [x.buf if isinstance(x, Plane) else x
              for x in tree_leaves(payload)]
    dev = next(x.device for x in leaves if isinstance(x, torch.Tensor))
    return CodecState(tree_map(zero, payload),
                      torch.zeros((n_nodes,), dtype=torch.int32, device=dev))


def residual_leaves(tree, state: CodecState):
    """The payload's float leaves paired with their residuals, in flatten
    order: ``(floats [(path, leaf)], residuals)``.  Raises unless the
    residuals are exactly as many as the float leaves, each of its
    leaf's shape."""
    floats = [(p, x) for p, x in tree_paths(tree) if _is_float(x)]
    # None marks a non-float payload leaf: it holds no residual
    res = [r for r in tree_leaves(state.residual) if r is not None]
    if len(res) != len(floats):
        raise ValueError(
            f"CodecState holds {len(res)} residual leaves for a payload "
            f"with {len(floats)} float leaves: the state was initialized "
            f"for a different payload structure")
    for (p, x), r in zip(floats, res):
        if tuple(r.shape) != tuple(x.shape):
            raise ValueError(f"residual shape {tuple(r.shape)} != payload "
                             f"leaf shape {tuple(x.shape)} at {p}")
    return floats, res


def ef_quantize_dequantize_tree(tree, spec: WireSpec, state: CodecState, *,
                                node_axis: bool = False
                                ) -> Tuple[Any, CodecState]:
    """Per-leaf reference of the error-feedback codec: the receiver-side
    view of ``tree`` and the updated state.  Per float leaf at its
    group's width: ``eff = x + decay·res`` (the product and the sum each
    rounded in fp32), its round trip ``deq``, and the new residual
    ``eff - deq``.  ``node_axis=True`` scales each node slice of a
    stacked ``[N, ...]`` leaf on its own (the stacked engine's
    convention, ``round_ops.quantize_leaf_per_node``); ``False`` scales
    whole leaves (``quantization.quantize_array``).  Non-float leaves
    pass through."""
    from repro_torch.core.quantization import quantize_array
    from repro_torch.kernels.quantize.ops import _leaf_group

    floats, res = residual_leaves(tree, state)
    deqs, new_res = [], []
    for (path, leaf), r in zip(floats, res):
        bits = spec.bits_for(_leaf_group(path))
        decay = torch.tensor(spec.ef_decay, dtype=torch.float32,
                             device=leaf.device)
        eff = leaf.to(torch.float32) + decay * r
        if node_axis:
            deq = dequantize_leaf(*quantize_leaf_per_node(eff, bits))
        else:
            codes, delta = quantize_array(eff, bits)
            deq = codes.to(torch.float32) * delta
        deqs.append(deq)
        new_res.append(eff - deq)
    it_deq, it_res = iter(deqs), iter(new_res)
    recv = tree_map(lambda x: next(it_deq) if _is_float(x) else x, tree)
    residual = tree_map(lambda r: None if r is None else next(it_res),
                        state.residual)
    return recv, CodecState(residual, next_seq(state.seq))


def ef_quantize_dequantize_plane(payload, spec: WireSpec, state: CodecState
                                 ) -> Tuple[Any, CodecState]:
    """The error-feedback codec on one node's wire payload
    ``{"protos": [C, P], "student": Plane}`` (the plane ``[R, 512]`` or a
    one-node stack ``[1, R, 512]``), its residual a plane of the same
    layout: ``repro``'s ``ef_quantize_dequantize_plane``, the per-node
    loop engine's ``+ef`` wire.  Returns ``(recv, new state)``.

    The prototypes take the plain per-tensor codec of the effective
    payload ``eff = x + decay·res`` (one Δ, the new residual
    ``eff - deq``).  The student's Δ per leaf segment comes from one
    ``rowabs_sum`` sweep (``max|x + decay·res|`` a row) and a segment
    max (``kernels/quantize/ops.plane_row_deltas``: Δ = 1 on the
    alignment rows); one ``quantize_rows_ef`` sweep writes the codes and
    the new residual, and the receiver's view is ``codes·Δ_row``.  Each
    operation is rounded on its own (``repro`` jits its version, and
    XLA:CPU fuses the residual's multiply-subtract)."""
    from repro_torch.kernels.quantize.ops import (_qmax_t, plane_row_deltas,
                                                  quantize_rows_ef,
                                                  rowabs_sum)
    plane, res_pl = payload["student"], state.residual["student"]
    dev = plane.buf.device
    decay = torch.tensor(spec.ef_decay, dtype=torch.float32, device=dev)
    tiny = torch.finfo(torch.float32).tiny

    qm_p = _qmax_t(spec.bits_for("protos"), dev)
    eff_p = payload["protos"].to(torch.float32) + \
        decay * state.residual["protos"]
    d_p = torch.clamp_min(torch.amax(torch.abs(eff_p)) / qm_p, tiny)
    deq_p = torch.clamp(torch.floor(eff_p / d_p + 0.5), -qm_p - 1,
                        qm_p) * d_p

    sb = spec.bits_for("student")
    cols = plane.buf.shape[-1]
    x2d = plane.buf.reshape(-1, cols)
    r2d = res_pl.buf.reshape(-1, cols)
    rd = plane_row_deltas(rowabs_sum(x2d, r2d, spec.ef_decay), plane.meta,
                          sb)
    qm = _qmax_t(sb, dev).expand(rd.shape).contiguous()
    codes, new_res = quantize_rows_ef(x2d, r2d, rd, qm, spec.ef_decay)
    deq = codes.to(torch.float32) * rd
    shape = plane.buf.shape
    recv = {"protos": deq_p,
            "student": Plane(deq.reshape(shape), plane.meta)}
    residual = {"protos": eff_p - deq_p,
                "student": Plane(new_res.reshape(shape), res_pl.meta)}
    return recv, CodecState(residual, next_seq(state.seq))
