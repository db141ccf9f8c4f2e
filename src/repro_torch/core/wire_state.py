"""Stateful wire codec: the per-node error-feedback residual state.

Sub-byte wire widths discard a large quantization residual every round.
Error feedback keeps it on the node and replays it into the next
payload, at no extra wire bytes:

    eff_t   = x_t + decay * e_t
    wire_t  = Q(eff_t)                       (the only thing that travels)
    e_{t+1} = eff_t - deq(wire_t)            (stays on the node)

:class:`CodecState` is the carried state, as in ``repro``'s
``core/wire_state.py``: a residual mirroring the wire payload
``{"protos": [N, C, P], "student": Plane}`` (the student residual is a
plane in the payload's row layout) and the sender's sequence counter
``seq``.  It rides in :class:`repro_torch.core.profe.NodeState`'s
``wire_state`` field.  The packed sweep that updates it lives in
``kernels/quantize/ops.py`` (``quantize_packed_buffer(residual=)``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.plane import Plane


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
    """Zero residual state shaped like the stacked wire payload
    ``{"protos": [N, C, P], "student": Plane}``: fp32 zeros for the
    prototypes, a zero plane with the student's recipe and an
    ``[n_nodes]`` zero ``seq``."""
    protos, plane = payload["protos"], payload["student"]
    dev = plane.buf.device
    residual = {
        "protos": torch.zeros(protos.shape, dtype=torch.float32, device=dev),
        "student": Plane(torch.zeros(plane.buf.shape, dtype=torch.float32,
                                     device=dev), plane.meta)}
    return CodecState(residual, torch.zeros((n_nodes,), dtype=torch.int32,
                                            device=dev))
