"""The packed node wire codec on the flat parameter plane — ``repro``'s
``kernels/quantize/ops.py``, at one width or mixed widths, stateless or
with error feedback, rounding to nearest or (given a threefry key)
stochastically.

One round's wire payload ``{"protos": [N, C, P], "student": Plane}``
packs into ONE ``[N, R, 512]`` fp32 buffer: the prototype rows first,
then the student's rows spliced straight off its plane (no repack),
then zero rows padding R to a multiple of 8 (tagged with the last
segment, so they carry its width).  Every (node, leaf) segment gets its
own scale ``Δ = max(max|x| / qmax, tiny)`` from one row-absmax sweep and
a tiny per-node scatter-max over rows; one row-scaled sweep writes the
integer codes, which narrow to the wire's int dtype; the receiver
reconstructs ``codes * Δ_row``.  A mixed-width spec (``4/16``: int4
student, int16 prototypes) clips each row to its segment's qmax in the
same sweep.  The error-feedback codec (``+ef``) quantizes the effective
payload ``x + decay·res`` instead: its absmax sweep adds the residual in
registers, and one sweep writes the codes and the new residual
``eff - codes·Δ``.  Any other node-stacked payload (the adapter wire's ``{"adapters",
"protos", "student": rest[, "grams"]}``, a per-leaf student's
``{"protos", "student"}``) packs leaf by leaf into the same buffer
layout and runs the same sweeps (the per-leaf tree codec), with error
feedback too (its residual a tree mirroring the payload's float
leaves).
The mesh exchange serializes the codes into the physical wire byte
buffer (``encode_wire``: int16 rows bitcast, int4 rows nibble-packed)
and its receivers dequantize them straight into the gossip mix
(``mix_packed``).

Two more tiers, as in ``repro``: the per-tensor codec (``quantize`` /
``dequantize`` / ``quantize_dequantize``: one scalar Δ per tensor, the
absmax and the codes in one call) and the packed tree
(``pack_tree`` / ``quantize_tree_packed`` / ``dequantize_tree_packed`` /
``quantize_dequantize_tree_packed``: every float leaf of a tree in one
``[R, 512]`` buffer, one scale segment per leaf, or per node slice of a
leaf with ``node_axis=True`` — the per-leaf reference codec of
``core/round_ops.py``).

``rowabs``, ``rowabs_sum``, ``quantize_rows``, ``quantize_rows_mixed``,
``quantize_rows_ef``, ``quantize_dequantize_rows``, ``dequantize_rows``,
``mix_packed`` and the per-tensor tier run the CUDA kernels for tensors
on the card and their plain versions on the CPU; everything else here is
host logic and plain tensor ops, as in ``repro``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize.quantize import (
    dequantize_cuda, dequantize_rows_cuda, fused_quantize_cuda,
    fused_quantize_dequantize_cuda, mix_packed_cuda,
    quantize_dequantize_rows_cuda, quantize_rows_cuda, quantize_rows_ef_cuda,
    quantize_rows_mixed_cuda, rowabs_cuda, rowabs_sum_cuda)
from repro_torch.kernels.quantize.ref import (as_codes, dequantize_ref,
                                              dequantize_rows_ref,
                                              fused_quantize_dequantize_ref,
                                              fused_quantize_ref,
                                              mix_packed_ref,
                                              quantize_dequantize_rows_ref,
                                              quantize_rows_ef_ref,
                                              quantize_rows_mixed_ref,
                                              quantize_rows_ref, rowabs_ref,
                                              rowabs_sum_ref)
from repro_torch.prng import uniform_like
from repro_torch.tree import is_float, tree_empties, tree_from_paths, \
    tree_leaves, tree_paths
from repro_torch.wirespec import WireSpec, canonical_group

_COLS = 512
_TINY = float(np.finfo(np.float32).tiny)


def _f32(x, device) -> torch.Tensor:
    """A host scalar as an fp32 tensor on ``device`` (``repro``'s
    ``jnp.float32(x)``)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def rowabs(x2d):
    """Per-row ``max|x|`` ``[R, 1]`` of an ``[R, C]`` buffer."""
    if x2d.is_cuda:
        return rowabs_cuda(x2d.contiguous())
    return rowabs_ref(x2d)


def quantize_rows(x2d, row_delta, *, bits: int = 16):
    """int32 codes of ``[R, C]`` at per-row deltas ``[R, 1]``."""
    if x2d.is_cuda:
        return quantize_rows_cuda(x2d.contiguous(), row_delta.contiguous(),
                                  bits=bits)
    return quantize_rows_ref(x2d, row_delta, bits=bits)


def quantize_rows_mixed(x2d, row_delta, row_qmax):
    """int32 codes of ``[R, C]`` at per-row deltas and qmax ``[R, 1]``."""
    if x2d.is_cuda:
        return quantize_rows_mixed_cuda(x2d.contiguous(),
                                        row_delta.contiguous(),
                                        row_qmax.contiguous())
    return quantize_rows_mixed_ref(x2d, row_delta, row_qmax)


def quantize_dequantize_rows(x2d, row_delta, *, bits: int = 16):
    """The fp32 round trip ``codes·Δ_row`` of ``[R, C]`` at per-row
    deltas ``[R, 1]``."""
    if x2d.is_cuda:
        return quantize_dequantize_rows_cuda(x2d.contiguous(),
                                             row_delta.contiguous(),
                                             bits=bits)
    return quantize_dequantize_rows_ref(x2d, row_delta, bits=bits)


def dequantize_rows(codes2d, row_delta):
    """fp32 ``codes·Δ_row`` of ``[R, C]`` integer codes (widened to
    int32) at per-row deltas ``[R, 1]``."""
    codes2d = codes2d.to(torch.int32)
    if codes2d.is_cuda:
        return dequantize_rows_cuda(codes2d.contiguous(),
                                    row_delta.contiguous())
    return dequantize_rows_ref(codes2d, row_delta)


def rowabs_sum(x2d, res2d, decay: float):
    """Per-row ``max|x + decay·res|`` ``[R, 1]`` of an ``[R, C]`` payload
    and its residual (``decay`` in fp32)."""
    if x2d.is_cuda:
        return rowabs_sum_cuda(x2d.contiguous(), res2d.contiguous(), decay)
    return rowabs_sum_ref(x2d, res2d, _f32(decay, x2d.device))


def quantize_rows_ef(x2d, res2d, row_delta, row_qmax, decay: float):
    """``(int32 codes, new residual)`` of the effective payload
    ``x + decay·res`` at per-row deltas and qmax ``[R, 1]``."""
    if x2d.is_cuda:
        return quantize_rows_ef_cuda(x2d.contiguous(), res2d.contiguous(),
                                     row_delta.contiguous(),
                                     row_qmax.contiguous(), decay)
    return quantize_rows_ef_ref(x2d, res2d, row_delta, row_qmax,
                                _f32(decay, x2d.device))


# -- the per-tensor codec: one scalar Δ per tensor ----------------------------
# ``repro`` pads each tensor to an (8, 128)-aligned 2-D block for its
# kernels; here the kernels sweep the flat tensor, and the zero padding
# changes no result (it cannot raise the absmax; its codes are cut off).

def _qmax_t(bits: int, device) -> torch.Tensor:
    """The 0-d fp32 qmax on ``device``: a tensor divisor keeps the plain
    version's Δ division IEEE on the card."""
    return _f32(float((1 << (bits - 1)) - 1), device)


def quantize(x, bits: int = 16):
    """-> ``(int32 codes of x's shape, 0-d Δ fp32)``: the absmax and the
    codes in one call, no host round trip for Δ."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    if flat.is_cuda:
        codes, delta = fused_quantize_cuda(flat, bits=bits)
    else:
        codes, delta = fused_quantize_ref(flat, _qmax_t(bits, flat.device))
    return codes.reshape(x.shape), delta


def dequantize(codes, delta):
    """Integer codes (widened to int32) and a 0-d Δ -> fp32 ``codes·Δ``
    of the codes' shape."""
    flat = codes.reshape(-1).to(torch.int32).contiguous()
    delta = delta.to(torch.float32).reshape(())
    if flat.is_cuda:
        out = dequantize_cuda(flat, delta.contiguous())
    else:
        out = dequantize_ref(flat, delta)
    return out.reshape(codes.shape)


def quantize_dequantize(x, bits: int = 16):
    """Receiver-side reconstruction in one call, back in ``x.dtype`` —
    the codes never land in memory."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    if flat.is_cuda:
        out, _ = fused_quantize_dequantize_cuda(flat, bits=bits)
    else:
        out, _ = fused_quantize_dequantize_ref(flat,
                                               _qmax_t(bits, flat.device))
    return out.reshape(x.shape).to(x.dtype)


# -- the packed tree: one [R, 512] buffer, one scale segment per leaf ---------

def _leaf_segments(leaf, node_axis: bool) -> int:
    return leaf.shape[0] if (node_axis and leaf.dim() >= 1) else 1


def _pack_leaf(leaf, node_axis: bool):
    """-> ``[rows, 512]`` fp32; ``node_axis`` packs each leading-axis
    slice into its own whole rows (rows never mix segments)."""
    if node_axis and leaf.dim() >= 1:
        n = leaf.shape[0]
        flat = leaf.reshape(n, -1).to(torch.float32)
        flat = F.pad(flat, (0, (-flat.shape[1]) % _COLS))
        return flat.reshape(-1, _COLS)
    flat = leaf.reshape(-1).to(torch.float32)
    return F.pad(flat, (0, (-flat.shape[0]) % _COLS)).reshape(-1, _COLS)


def _unpack_leaf(rows, shape, node_axis: bool):
    if node_axis and len(shape) >= 1:
        return rows.reshape(shape[0], -1)[:, :math.prod(shape[1:])] \
            .reshape(shape)
    return rows.reshape(-1)[:math.prod(shape)].reshape(shape)


def pack_tree(tree, *, node_axis: bool = False):
    """Flatten every float leaf of ``tree`` into one ``[R, 512]`` fp32
    buffer.  Returns ``(buf, seg_ids [R] int32, meta)`` with ``meta =
    (recipe, n_seg)``: ``recipe`` entries ``("packed", path, shape,
    dtype, row, n_rows, seg, n_seg_leaf)``, ``("raw", path, leaf)`` for
    a non-float leaf, which rides in the meta untouched, or ``("empty",
    path, type)`` for an empty subtree.  Alignment rows
    pad R to a multiple of 8 and carry the last segment id; a tree
    without float leaves gives an ``[8, 512]`` zero buffer."""
    parts: List[torch.Tensor] = []
    seg_parts: List[np.ndarray] = []
    recipe: List[Tuple] = []
    seg = row = 0
    for path, leaf in tree_paths(tree):
        if not (hasattr(leaf, "dtype") and is_float(leaf)):
            recipe.append(("raw", path, leaf))
            continue
        rows = _pack_leaf(leaf, node_axis)
        nseg = _leaf_segments(leaf, node_axis)
        seg_parts.append(np.repeat(np.arange(seg, seg + nseg, dtype=np.int32),
                                   rows.shape[0] // nseg))
        recipe.append(("packed", path, tuple(leaf.shape), leaf.dtype, row,
                       rows.shape[0], seg, nseg))
        parts.append(rows)
        seg += nseg
        row += rows.shape[0]
    recipe.extend(("empty", path, kind) for path, kind in tree_empties(tree))
    if not parts:
        return (torch.zeros((8, _COLS), dtype=torch.float32),
                np.zeros((8,), np.int32), (tuple(recipe), 1))
    buf = torch.cat(parts, dim=0)
    seg_ids = np.concatenate(seg_parts)
    rpad = (-buf.shape[0]) % 8
    if rpad:
        buf = F.pad(buf, (0, 0, 0, rpad))
        seg_ids = np.concatenate([seg_ids,
                                  np.full((rpad,), seg - 1, np.int32)])
    return buf, seg_ids, (tuple(recipe), seg)


def unpack_tree(buf, meta):
    """Inverse of :func:`pack_tree` (float leaves come back fp32)."""
    items, empties = [], []
    for item in meta[0]:
        if item[0] in ("raw", "empty"):
            (items if item[0] == "raw" else empties).append(item[1:])
            continue
        _, path, shape, _dtype, row, n_rows, _seg, nseg = item
        items.append((path, _unpack_leaf(buf[row:row + n_rows], shape,
                                         len(shape) >= 1 and nseg > 1)))
    return tree_from_paths(items, empties)


def _segment_deltas(buf, seg_ids, n_seg: int, bits: int):
    """Per-segment Δ ``[T]`` and per-row Δ ``[R, 1]`` of an ``[R, C]``
    buffer: one ``rowabs`` launch, then the segment max of the row maxima
    (0 for an empty segment) over the device qmax."""
    deltas, row_delta = _node_row_deltas(buf[None], seg_ids, n_seg, bits)
    return deltas[0], row_delta[0][:, None]


def quantize_tree_packed(tree, bits: int = 16, *, node_axis: bool = False
                         ) -> Dict:
    """Quantize a whole tree in two launches (row absmax, codes) plus a
    tiny segment max.  Returns ``{"codes": [R, C] int32, "scales": [T]
    fp32, "seg_ids", "meta", "bits"}``."""
    buf, seg_ids, meta = pack_tree(tree, node_axis=node_axis)
    deltas, row_delta = _segment_deltas(buf, seg_ids, meta[1], bits)
    codes = quantize_rows(buf, row_delta, bits=bits)
    return {"codes": codes, "scales": deltas, "seg_ids": seg_ids,
            "meta": meta, "bits": bits}


def dequantize_tree_packed(payload):
    """The receiver side of :func:`quantize_tree_packed`: ``codes·Δ_row``
    in one launch, unpacked into the tree."""
    ids = torch.as_tensor(payload["seg_ids"], dtype=torch.int64,
                          device=payload["codes"].device)
    buf = dequantize_rows(payload["codes"], payload["scales"][ids][:, None])
    return unpack_tree(buf, payload["meta"])


def quantize_dequantize_tree_packed(tree, bits: int = 16, *,
                                    node_axis: bool = False):
    """Receiver-side reconstruction of a whole tree: the row absmax and
    the fused row-scaled round trip, no integer codes in memory."""
    buf, seg_ids, meta = pack_tree(tree, node_axis=node_axis)
    _, row_delta = _segment_deltas(buf, seg_ids, meta[1], bits)
    return unpack_tree(quantize_dequantize_rows(buf, row_delta, bits=bits),
                       meta)


def _wire_int_dtype(bits: int) -> torch.dtype:
    """Narrowest in-memory container for intN codes (int4 rides int8)."""
    return {4: torch.int8, 8: torch.int8, 16: torch.int16,
            32: torch.int32}[bits]


def _seg_qmax(n_seg: int, bits: int, seg_bits: Optional[np.ndarray]
              ) -> np.ndarray:
    """Static per-segment qmax [T]: mixed widths from ``seg_bits``,
    else the uniform ``bits``."""
    if seg_bits is None:
        return np.full((n_seg,), (1 << (bits - 1)) - 1, np.float32)
    return ((1 << (np.asarray(seg_bits, np.int64) - 1)) - 1
            ).astype(np.float32)


def _node_row_deltas(buf, seg_ids, n_seg: int, bits: int,
                     seg_bits: Optional[np.ndarray] = None, *,
                     residual=None, ef_decay: float = 1.0):
    """Per-(node, leaf) Δ from one row-absmax sweep and a per-node
    scatter-max of the row maxima into their segments.  Returns
    ``(scales [N, T], row_delta [N, R])`` fp32.  ``residual`` takes the
    absmax of the effective payload ``buf + ef_decay·residual`` (the
    error-feedback codec).  The scatter starts from 0, which equals
    ``repro``'s ``max(segment_max, 0)`` (row maxima are >= 0); the Δ
    guard is ``finfo(float32).tiny``."""
    n, r, c = buf.shape
    qmax = torch.as_tensor(_seg_qmax(n_seg, bits, seg_bits),
                           device=buf.device)
    if residual is None:
        row_amax = rowabs(buf.reshape(n * r, c))
    else:
        row_amax = rowabs_sum(buf.reshape(n * r, c),
                              residual.reshape(n * r, c), ef_decay)
    ids = torch.as_tensor(np.asarray(seg_ids), dtype=torch.int64,
                          device=buf.device)
    seg_amax = torch.zeros((n, n_seg), dtype=torch.float32,
                           device=buf.device).scatter_reduce(
        1, ids.expand(n, r), row_amax.reshape(n, r), reduce="amax",
        include_self=True)
    deltas = torch.clamp_min(seg_amax / qmax, _TINY)
    return deltas, deltas[:, ids]


def quantize_packed_buffer(buf, seg_ids, n_seg: int, bits: int = 16, *,
                           seg_bits: Optional[np.ndarray] = None,
                           rng=None, residual=None, ef_decay: float = 1.0):
    """Quantize an already-packed ``[N, R, C]`` buffer.  Returns
    ``(codes [N, R, C] wire-intN, scales [N, T] fp32)``.

    ``seg_bits`` (``[n_seg]`` ints) quantizes each segment at its own
    width in the same sweep; the codes land in the container of the
    widest segment.  ``residual`` (``[N, R, C]`` fp32) switches to the
    error-feedback codec: the effective payload
    ``buf + ef_decay·residual`` is quantized in one sweep that also
    writes the fresh quantization error, returned third —
    ``(codes, scales, new_residual)``; the wire format is unchanged.

    ``rng`` (a threefry key, :mod:`repro_torch.prng`) switches to
    stochastic rounding, ``floor(eff/Δ + U[0,1))``, the noise drawn on
    the host over the whole ``[N, R, C]`` buffer (padding lanes
    included) as ``jax.random.uniform(rng, buf.shape)`` draws it, so the
    codes are the JAX package's bit for bit.  Δ still comes from the
    row-absmax kernel; the codes take the plain tensor ops, the route
    ``repro``'s dispatch gives a call with a key."""
    n, r, c = buf.shape
    deltas, row_delta = _node_row_deltas(buf, seg_ids, n_seg, bits,
                                         seg_bits, residual=residual,
                                         ef_decay=ef_decay)
    row_qmax = _seg_qmax(n_seg, bits, seg_bits)[np.asarray(seg_ids)]  # [R]
    max_bits = int(np.max(seg_bits)) if seg_bits is not None else bits
    wire_dtype = _wire_int_dtype(max_bits)
    if rng is not None:
        return _stochastic_codes(buf, row_delta, row_qmax, wire_dtype,
                                 deltas, rng, residual, ef_decay)
    x2d = buf.reshape(n * r, c)
    rd = row_delta.reshape(n * r, 1)

    def qmax_col():
        return torch.as_tensor(np.tile(row_qmax, n)[:, None],
                               device=buf.device)
    if residual is not None:
        codes, new_res = quantize_rows_ef(x2d, residual.reshape(n * r, c),
                                          rd, qmax_col(), ef_decay)
        return (codes.reshape(n, r, c).to(wire_dtype), deltas,
                new_res.reshape(n, r, c))
    if seg_bits is None or len(set(np.asarray(seg_bits).tolist())) == 1:
        width = int(seg_bits[0]) if seg_bits is not None else bits
        codes = quantize_rows(x2d, rd, bits=width)
    else:
        codes = quantize_rows_mixed(x2d, rd, qmax_col())
    return codes.reshape(n, r, c).to(wire_dtype), deltas


def _stochastic_codes(buf, row_delta, row_qmax, wire_dtype, deltas, rng,
                      residual, ef_decay: float):
    """The codes sweep of :func:`quantize_packed_buffer` with a key, in
    ``repro``'s order of operations: ``eff = buf + decay·res`` (each
    rounded), ``floor(eff / Δ_row + U)``, clipped to the row's qmax; with
    a residual also ``eff - codes·Δ_row``."""
    eff = buf if residual is None else \
        buf + _f32(ef_decay, buf.device) * residual
    rd = row_delta[:, :, None]
    codes = torch.floor(eff / rd + uniform_like(rng, buf))
    qm = torch.as_tensor(row_qmax, device=buf.device)[None, :, None]
    codes = torch.clamp(codes, -qm - 1, qm)
    if residual is None:
        return as_codes(codes, wire_dtype), deltas
    return as_codes(codes, wire_dtype), deltas, eff - codes * rd


def _check_rng(spec: Optional[WireSpec], rng) -> None:
    """``repro``'s refusal: a spec with stochastic rounding and no key
    (rounding to nearest instead would fake the unbiased codes)."""
    if spec is not None and spec.stochastic_rounding and rng is None:
        raise ValueError("WireSpec.stochastic_rounding is set but no rng "
                         "was passed: stochastic rounding needs an "
                         "explicit PRNG key")


def pack_plane_payload(protos, plane, spec: Optional[WireSpec] = None):
    """Pack ``{"protos": [N, C, P], "student": Plane}`` into the packed
    node wire format without repacking the student.

    Returns ``(buf [N, R, C], seg_ids [R] int32, meta, r_protos, span)``
    with ``meta = (recipe, n_seg, n_nodes, seg_bits)`` — the layout
    ``repro``'s ``pack_plane_payload`` produces: the prototype segment
    first, then one segment per student leaf in plane order."""
    n, c_cls, p_dim = protos.shape
    if plane.buf.dim() != 3 or plane.buf.shape[0] != n:
        raise ValueError(f"plane buffer {tuple(plane.buf.shape)} is not "
                         f"stacked over the payload's {n} nodes")
    per = c_cls * p_dim
    flat_p = F.pad(protos.reshape(n, per).to(torch.float32),
                   (0, (-per) % _COLS))
    rows_p = flat_p.reshape(n, -1, _COLS)                  # [N, r_p, C]
    r_p = rows_p.shape[1]

    recipe: List[Tuple] = [("packed", ("protos",), tuple(protos.shape),
                            0, r_p, 0)]
    seg_parts: List[np.ndarray] = [np.zeros((r_p,), np.int32)]
    seg_bits: List[int] = [spec.bits_for("protos")] if spec is not None \
        else []
    seg = 1
    span = 0
    for _, path, shape, prow, r_leaf in plane.meta.recipe:
        recipe.append(("packed", ("student",) + path, (n,) + tuple(shape),
                       r_p + prow, r_leaf, seg))
        seg_parts.append(np.full((r_leaf,), seg, np.int32))
        if spec is not None:
            seg_bits.append(spec.bits_for("student"))
        seg += 1
        span = max(span, prow + r_leaf)
    # the splice: the plane's leaf rows ARE the student's packed rows
    buf = torch.cat([rows_p, plane.buf[:, :span]], dim=1)
    seg_ids = np.concatenate(seg_parts)
    rpad = (-buf.shape[1]) % 8
    if rpad:
        buf = F.pad(buf, (0, 0, 0, rpad))
        seg_ids = np.concatenate([seg_ids,
                                  np.full((rpad,), seg - 1, np.int32)])
    bits_arr = np.asarray(seg_bits, np.int32) if spec is not None else None
    return buf, seg_ids, (tuple(recipe), seg, n, bits_arr), r_p, span


def split_plane_payload(buf, protos_shape, plane_meta, r_p: int, span: int):
    """Inverse of :func:`pack_plane_payload` on an ``[N, R, C]`` buffer:
    ``(protos [N, C, P], student buffer [N, rows, C])`` — the prototype
    rows reshaped, the student rows spliced into a buffer of the plane's
    row count (its trailing alignment rows zero)."""
    n = buf.shape[0]
    per = math.prod(protos_shape[1:])
    pr = buf[:, :r_p].reshape(n, -1)[:, :per]
    pr = pr.reshape((n,) + tuple(protos_shape[1:]))
    sbuf = F.pad(buf[:, r_p:r_p + span], (0, 0, 0, plane_meta.rows - span))
    return pr, sbuf


def quantize_dequantize_plane_payload(payload, bits: int = 16, *,
                                      spec: Optional[WireSpec] = None,
                                      rng=None, residual=None):
    """Receiver-side reconstruction of ``{"protos": [N, C, P],
    "student": Plane}``: pack (student rows spliced off the plane),
    quantize in one buffer sweep, dequantize ``codes * Δ_row`` in plain
    torch, and splice the student rows back into a fresh plane (its
    zero padding quantizes to zero, so the layout invariant holds).

    With ``residual`` (``{"protos", "student": Plane}`` mirroring the
    payload — the error-feedback codec) returns ``(reconstruction,
    new_residual)``, the new residual split back the same way; a zero
    padding lane stays a zero residual.  ``rng`` is
    :func:`quantize_packed_buffer`'s (stochastic rounding); a spec with
    ``stochastic_rounding`` needs it."""
    from repro_torch.optim.plane import Plane
    _check_rng(spec, rng)
    if spec is not None and spec.error_feedback and residual is None:
        raise ValueError("WireSpec.error_feedback is set but no residual "
                         "was passed: the error-feedback codec needs the "
                         "carried per-node residual (CodecState)")
    protos, plane = payload["protos"], payload["student"]
    buf, seg_ids, meta, r_p, span = pack_plane_payload(protos, plane, spec)

    def split(b):
        return split_plane_payload(b, protos.shape, plane.meta, r_p, span)

    if residual is not None:
        res_plane = residual["student"]
        res_buf = pack_plane_payload(residual["protos"], res_plane)[0]
        if res_buf.shape != buf.shape:
            raise ValueError(f"residual buffer {tuple(res_buf.shape)} does "
                             f"not match the payload buffer "
                             f"{tuple(buf.shape)}: the residual must "
                             f"mirror the payload layout")
        codes, deltas, new_res_buf = quantize_packed_buffer(
            buf, seg_ids, meta[1], bits, seg_bits=meta[3], rng=rng,
            residual=res_buf,
            ef_decay=spec.ef_decay if spec is not None else 1.0)
    else:
        codes, deltas = quantize_packed_buffer(buf, seg_ids, meta[1], bits,
                                               seg_bits=meta[3], rng=rng)
    ids = torch.as_tensor(seg_ids, dtype=torch.int64, device=buf.device)
    deq = codes.to(torch.float32) * deltas[:, ids][:, :, None]
    pr, sbuf = split(deq)
    recv = {"protos": pr, "student": Plane(sbuf, plane.meta)}
    if residual is None:
        return recv
    rp, rbuf = split(new_res_buf)
    return recv, {"protos": rp, "student": Plane(rbuf, res_plane.meta)}


def plane_row_deltas(row_amax, plane_meta, bits: int):
    """One node's per-row Δ ``[R, 1]`` of a plane from its per-row
    absmax ``[R, 1]``: one Δ = ``max(segment max / qmax, tiny)`` per leaf
    segment of the recipe (a scatter-max of the row maxima, which starts
    from 0 as the absmax does), and Δ = 1 on the trailing alignment rows
    (zeros round-trip to zeros there)."""
    rows = plane_meta.rows
    n_leaf = len(plane_meta.recipe)
    seg = np.full((rows,), n_leaf, np.int64)     # alignment rows last
    for k, (_, _path, _shape, row, r_leaf) in enumerate(plane_meta.recipe):
        seg[row:row + r_leaf] = k
    dev = row_amax.device
    ids = torch.as_tensor(seg, device=dev)
    seg_amax = torch.zeros((n_leaf + 1,), dtype=torch.float32,
                           device=dev).scatter_reduce(
        0, ids, row_amax.reshape(-1), reduce="amax", include_self=True)
    deltas = torch.clamp_min(seg_amax / _qmax_t(bits, dev), _TINY)
    deltas = torch.cat([deltas[:n_leaf],
                        torch.ones((1,), dtype=torch.float32, device=dev)])
    return deltas[ids][:, None]


def quantize_dequantize_plane_rows(plane, bits: int = 16):
    """The per-leaf round trip of one node's plane straight on its
    buffer (``[R, C]``, or a one-node stack ``[1, R, C]``): one Δ per
    leaf segment (:func:`plane_row_deltas` of one ``rowabs`` sweep;
    padding lanes are zero and cannot raise it), then one row-scaled
    round trip over the whole buffer (``quantize_dequantize_rows``).
    ``repro``'s ``quantize_dequantize_plane_rows`` (the per-node loop
    engine's wire) bit for bit: the same absmax, qmax, tiny guard,
    rounding and clip per element as the per-leaf codec on the leaf
    views.  The trailing alignment rows ride Δ = 1, so the plane's
    padding invariant survives."""
    from repro_torch.optim.plane import Plane
    buf = plane.buf
    x2d = buf.reshape(-1, buf.shape[-1])
    if x2d.shape[0] != plane.meta.rows:
        raise ValueError(f"quantize_dequantize_plane_rows takes one node's "
                         f"plane, got a buffer {tuple(buf.shape)}")
    rd = plane_row_deltas(rowabs(x2d), plane.meta, bits)
    out = quantize_dequantize_rows(x2d, rd, bits=bits)
    return Plane(out.reshape(buf.shape), plane.meta)


# -- the serialized wire byte buffer -----------------------------------------
# What the mesh exchange hands to its collectives: one node's codes as ONE
# contiguous int8 buffer of exactly the spec's bytes.  int16 rows are
# bitcast to int8 (little-endian, as XLA's bitcast on the JAX package's
# hosts), int8 rows pass through, int4 rows nibble-pack two codes a byte;
# a mixed spec concatenates its width groups in ascending width.

def _row_bits(seg_ids, bits: int, seg_bits: Optional[np.ndarray]
              ) -> np.ndarray:
    sb = np.asarray(seg_bits, np.int64) if seg_bits is not None else None
    return (sb[np.asarray(seg_ids)] if sb is not None
            else np.full((len(seg_ids),), bits, np.int64))


def nibble_pack(codes):
    """int4 codes ``[..., C]`` (C even, values in [-8, 7]) -> int8
    ``[..., C // 2]``: even columns in the low nibble, odd in the high."""
    if codes.shape[-1] % 2:
        raise ValueError(f"nibble packing needs an even trailing dim, "
                         f"got {tuple(codes.shape)}")
    c = codes.to(torch.int32)
    byte = torch.bitwise_or(torch.bitwise_and(c[..., 0::2], 0xF),
                            torch.bitwise_and(c[..., 1::2], 0xF) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def nibble_unpack(packed):
    """Inverse of :func:`nibble_pack`: int8 ``[..., B]`` ->
    sign-extended int8 codes ``[..., 2 * B]``."""
    p = packed.to(torch.int32)                  # sign-extends the byte
    lo = torch.bitwise_xor(torch.bitwise_and(p, 0xF), 8) - 8
    hi = p >> 4                                 # arithmetic: sign
    return torch.stack([lo, hi], dim=-1).reshape(
        tuple(packed.shape[:-1]) + (2 * packed.shape[-1],)).to(torch.int8)


def _bits_row_groups(seg_ids, bits: int, seg_bits: Optional[np.ndarray]):
    """Row grouping by wire width: ``[(width, row indices)]`` in
    ascending width, covering every row once."""
    rb = _row_bits(seg_ids, bits, seg_bits)
    return [(int(b), np.nonzero(rb == b)[0])
            for b in sorted(set(rb.tolist()))]


def _encode_rows(codes_b, b: int):
    """``[N, Rb, C]`` codes at width ``b`` -> ``[N, Rb·C·b/8]`` int8."""
    n = codes_b.shape[0]
    if b == 4:
        return nibble_pack(codes_b).reshape(n, -1)
    if b == 8:
        return codes_b.to(torch.int8).reshape(n, -1)
    wide = codes_b.to(_wire_int_dtype(b)).contiguous()
    return wide.view(torch.int8).reshape(n, -1)


def _decode_rows(wire_b, b: int, n_rows: int):
    """Inverse of :func:`_encode_rows` -> ``[N, n_rows, C]`` int32."""
    n = wire_b.shape[0]
    if b == 4:
        return nibble_unpack(wire_b.reshape(n, n_rows, _COLS // 2)
                             ).to(torch.int32)
    if b == 8:
        return wire_b.reshape(n, n_rows, _COLS).to(torch.int32)
    chunks = wire_b.contiguous().reshape(n, n_rows, _COLS * (b // 8))
    return chunks.view(_wire_int_dtype(b)).to(torch.int32)


def encode_wire(codes, seg_ids, bits: int = 16, *,
                seg_bits: Optional[np.ndarray] = None):
    """Serialize packed codes ``[N, R, C]`` into the physical wire byte
    buffer ``[N, B]`` int8, ``B = Σ_rows C·bits_row/8``; its layout
    follows from ``seg_ids``/``seg_bits`` alone, so :func:`decode_wire`
    inverts it without a side channel."""
    groups = _bits_row_groups(seg_ids, bits, seg_bits)
    if len(groups) == 1:
        return _encode_rows(codes, groups[0][0])
    return torch.cat(
        [_encode_rows(codes.index_select(
            1, torch.as_tensor(rows, device=codes.device)), b)
         for b, rows in groups], dim=1)


def decode_wire(wire, seg_ids, bits: int = 16, *,
                seg_bits: Optional[np.ndarray] = None):
    """Inverse of :func:`encode_wire`: ``[N, B]`` int8 -> codes
    ``[N, R, C]`` int32 in the original row order."""
    groups = _bits_row_groups(seg_ids, bits, seg_bits)
    if len(groups) == 1:
        return _decode_rows(wire, groups[0][0], len(seg_ids))
    parts, col = [], 0
    for b, rows in groups:
        nbytes = len(rows) * _COLS * b // 8
        parts.append(_decode_rows(wire[:, col:col + nbytes], b, len(rows)))
        col += nbytes
    perm = np.concatenate([rows for _, rows in groups])
    return torch.cat(parts, dim=1).index_select(
        1, torch.as_tensor(np.argsort(perm), device=wire.device))


def wire_buffer_bytes(seg_ids, bits: int = 16, *,
                      seg_bits: Optional[np.ndarray] = None) -> int:
    """Byte size B of one node's encoded wire buffer."""
    return int(np.sum(_row_bits(seg_ids, bits, seg_bits)) * _COLS // 8)


# -- the receiver side of the mesh exchange ---------------------------------

def mix_packed(own, codes, row_delta, w_self, w_rows):
    """Receiver-side gossip mix applied directly on packed codes:
    ``out[m] = w_self[m]·own[m] + Σ_j w_rows[m, j]·codes[j]·Δ[j]`` for
    ``own [M, R, C]``, ``codes [S, R, C]``, ``row_delta [S, R]``,
    ``w_self [M]``, ``w_rows [M, S]`` — one kernel launch on the card.
    fp32 "codes" (raw buffers at unit Δ) stay fp32; narrow wire ints
    widen to int32, the kernel's code type."""
    if codes.dtype != torch.float32:
        codes = codes.to(torch.int32)
    codes = codes.contiguous()
    own, row_delta, w_self, w_rows = (t.to(torch.float32).contiguous()
                                      for t in (own, row_delta, w_self,
                                                w_rows))
    if own.is_cuda:
        return mix_packed_cuda(own, codes, row_delta, w_self, w_rows)
    return mix_packed_ref(own, codes, row_delta, w_self, w_rows)


def mix_packed_init(own, w_self):
    """Open a step-wise :func:`mix_packed`: the self term
    ``w_self[m]·own[m]`` that :func:`mix_packed_accumulate` folds the
    exchange steps into, one step at a time (the ``[S, R, C]`` step stack
    is never built)."""
    return w_self.to(torch.float32)[:, None, None] * own.to(torch.float32)


def mix_packed_accumulate(acc, codes, row_delta, w_rows):
    """Fold one exchange step into a running mix:
    ``acc[m] + Σ_j w_rows[m, j]·codes[j]·Δ[j]`` — the mix kernel with
    the accumulator in the ``own`` slot at weight one (``1·acc`` is
    exact), so the step-wise mix rounds like :func:`mix_packed`."""
    return mix_packed(acc, codes, row_delta,
                      torch.ones((acc.shape[0],), dtype=torch.float32,
                                 device=acc.device), w_rows)


# -- the per-leaf tree codec over node-stacked trees ---------------------------
# A payload that is not plane-backed — the adapter wire's {"adapters",
# "grams", "protos", "student": rest} — packs leaf by leaf into the same
# [N, R, 512] buffer: every float leaf [N, ...] flattened per node and
# padded to whole rows, in flatten order (dict keys sorted), one scale
# segment per leaf, 8-alignment rows tagged with the last segment.  The
# buffer then runs the same sweeps as the plane payload.

def _leaf_group(path) -> str:
    """Top-level payload key of a leaf path — the WireSpec group."""
    key = path[0] if path and isinstance(path[0], str) else ""
    return canonical_group(key)


def pack_tree_nodes(tree, spec: Optional[WireSpec] = None):
    """Flatten every float leaf ``[N, ...]`` of ``tree`` into one
    ``[N, R, 512]`` fp32 buffer.  Returns ``(buf, seg_ids [R] int32,
    meta)`` with ``meta = (recipe, n_seg, n_nodes, seg_bits)``:
    ``recipe`` entries ``("packed", path, shape, row, r_leaf, seg)``,
    ``("raw", path, leaf)`` for a non-float leaf (it rides beside the
    buffer) or ``("empty", path, type)`` for an empty subtree;
    ``seg_bits`` each segment's width from ``spec`` by its leaf's
    top-level key (None without a spec)."""
    parts: List[torch.Tensor] = []
    seg_parts: List[np.ndarray] = []
    seg_bits: List[int] = []
    recipe: List[Tuple] = []
    n_nodes = None
    seg = row = 0
    for path, leaf in tree_paths(tree):
        if not (hasattr(leaf, "dtype") and is_float(leaf)):
            recipe.append(("raw", path, leaf))
            continue
        if leaf.dim() < 1:
            raise ValueError("packed node format needs [N, ...] leaves")
        n = leaf.shape[0]
        if n_nodes is None:
            n_nodes = n
        elif n != n_nodes:
            raise ValueError(f"inconsistent node axis: {n} vs {n_nodes}")
        per = math.prod(leaf.shape[1:])
        flat = F.pad(leaf.reshape(n, per).to(torch.float32),
                     (0, (-per) % _COLS))
        rows = flat.reshape(n, -1, _COLS)                 # [N, r_leaf, C]
        r_leaf = rows.shape[1]
        seg_parts.append(np.full((r_leaf,), seg, np.int32))
        if spec is not None:
            seg_bits.append(spec.bits_for(_leaf_group(path)))
        recipe.append(("packed", path, tuple(leaf.shape), row, r_leaf, seg))
        parts.append(rows)
        seg += 1
        row += r_leaf
    recipe.extend(("empty", path, kind) for path, kind in tree_empties(tree))
    if not parts:
        raise ValueError("packed node format needs at least one float leaf")
    buf = torch.cat(parts, dim=1)
    seg_ids = np.concatenate(seg_parts)
    rpad = (-buf.shape[1]) % 8
    if rpad:
        buf = F.pad(buf, (0, 0, 0, rpad))
        seg_ids = np.concatenate([seg_ids,
                                  np.full((rpad,), seg - 1, np.int32)])
    bits_arr = np.asarray(seg_bits, np.int32) if spec is not None else None
    return buf, seg_ids, (tuple(recipe), seg, n_nodes, bits_arr)


def unpack_tree_nodes(buf, meta):
    """Inverse of :func:`pack_tree_nodes` (float leaves come back in the
    buffer's dtype).  ``buf``'s leading axis may hold other rows than the
    packed nodes (every sender's, or one node's per-step copies): each
    leaf comes back ``[buf.shape[0], ...]``."""
    items, empties = [], []
    m = buf.shape[0]
    for item in meta[0]:
        if item[0] in ("raw", "empty"):
            (items if item[0] == "raw" else empties).append(item[1:])
            continue
        _, path, shape, row, r_leaf, _seg = item
        per = math.prod(shape[1:])
        rows = buf[:, row:row + r_leaf].reshape(m, -1)
        items.append((path, rows[:, :per].reshape((m,) + tuple(shape[1:]))))
    return tree_from_paths(items, empties)


def quantize_tree_packed_nodes(tree, bits: int = 16, *,
                               spec: Optional[WireSpec] = None,
                               rng=None, residual=None) -> Dict:
    """Quantize a node-stacked tree into ``{"codes": [N, R, C] intN,
    "scales": [N, T] fp32, "seg_ids", "seg_bits", "meta", "bits"}``,
    each leaf group at its spec width; ``rng`` is
    :func:`quantize_packed_buffer`'s (stochastic rounding).

    ``residual`` (required when ``spec.error_feedback`` is set) is the
    error-feedback residual: a tree of fp32 leaves mirroring the
    payload's float leaves, packed into the same buffer layout (a buffer
    of another shape raises).  The sweeps then quantize ``x +
    decay·res`` (the absmax adds it inside its reduction, the codes
    sweep writes the fresh error beside the codes) and the payload gains
    ``"ef_residual"``, the new residual tree, which never rides the
    wire: codes and scales keep the stateless format."""
    _check_rng(spec, rng)
    _check_residual(spec, residual)
    buf, seg_ids, meta = pack_tree_nodes(tree, spec)
    out = {"seg_ids": seg_ids, "seg_bits": meta[3], "meta": meta,
           "bits": bits}
    if residual is None:
        out["codes"], out["scales"] = quantize_packed_buffer(
            buf, seg_ids, meta[1], bits, seg_bits=meta[3], rng=rng)
        return out
    res_buf, _, res_meta = pack_tree_nodes(residual)

    def shapes(m):
        return [item[2] for item in m[0] if item[0] == "packed"]
    if res_buf.shape != buf.shape or shapes(res_meta) != shapes(meta):
        raise ValueError(f"residual buffer {tuple(res_buf.shape)} does not "
                         f"match the payload buffer {tuple(buf.shape)} leaf "
                         f"for leaf: the residual tree must mirror the "
                         f"payload's float leaves")
    out["codes"], out["scales"], new_res = quantize_packed_buffer(
        buf, seg_ids, meta[1], bits, seg_bits=meta[3], rng=rng,
        residual=res_buf, ef_decay=_ef_decay(spec))
    out["ef_residual"] = unpack_tree_nodes(new_res, res_meta)
    return out


def _check_residual(spec: Optional[WireSpec], residual) -> None:
    """``repro``'s refusal: an error-feedback spec with no residual (the
    stateful codec must not drop its state)."""
    if spec is not None and spec.error_feedback and residual is None:
        raise ValueError("WireSpec.error_feedback is set but no residual "
                         "was passed: the error-feedback codec needs the "
                         "carried per-node residual tree (CodecState)")


def _ef_decay(spec: Optional[WireSpec]) -> float:
    return spec.ef_decay if spec is not None else 1.0


def dequantize_tree_packed_nodes(payload):
    """Receiver-side reconstruction ``codes * Δ_row`` of a packed node
    payload, unpacked into its tree."""
    ids = torch.as_tensor(payload["seg_ids"], dtype=torch.int64,
                          device=payload["codes"].device)
    deq = payload["codes"].to(torch.float32) * \
        payload["scales"][:, ids][:, :, None]
    return unpack_tree_nodes(deq, payload["meta"])


def quantize_dequantize_tree_packed_nodes(tree, bits: int = 16, *,
                                          spec: Optional[WireSpec] = None,
                                          rng=None, residual=None):
    """Round trip of a node-stacked tree through the packed node codec —
    what every receiver reconstructs; with ``residual`` (the
    error-feedback codec, :func:`quantize_tree_packed_nodes`) returns
    ``(reconstruction, new residual tree)``.  Always through the buffer
    (the route ``repro`` takes with its kernels, and with a key): one
    absmax and one codes launch over the whole buffer (``rowabs_sum``
    and ``quantize_rows_ef`` with a residual)."""
    payload = quantize_tree_packed_nodes(tree, bits, spec=spec, rng=rng,
                                         residual=residual)
    recv = dequantize_tree_packed_nodes(payload)
    if residual is None:
        return recv
    return recv, payload["ef_residual"]


# -- byte accounting (shapes only) ------------------------------------------

def packed_wire_rows(tree) -> Tuple[int, int]:
    """Static layout of one copy's packed buffer: ``(R_padded, T)`` —
    rows (8-aligned) and scale-segment count of a per-copy skeleton."""
    rows = 0
    nseg = 0
    for leaf in tree_leaves(tree):
        if not (hasattr(leaf, "dtype") and is_float(leaf)):
            continue
        rows += -(-math.prod(int(d) for d in leaf.shape) // _COLS)
        nseg += 1
    return rows + ((-rows) % 8), nseg


def packed_wire_bytes_per_node(tree, bits: Optional[int] = 16, *,
                               leaf_bits: Optional[Sequence[int]] = None,
                               inner: int = 1) -> int:
    """Physical bytes one node's packed copy occupies on the wire: the
    encoded code buffer incl. 512-lane padding, plus one fp32 scale per
    leaf segment; ``bits=None`` is the fp32 wire (fp32 rows, no scales).
    ``leaf_bits`` gives each float leaf its own width; alignment rows
    carry the LAST leaf's width.  ``inner`` is the number of ranks a
    node's row-sharded permute splits the rows over: each wire width
    group's row count pads up to a multiple of ``inner`` (the zero rows
    ``sharding.row_shard_order`` appends travel as wire bytes)."""
    if bits is None or leaf_bits is None:
        rows, nseg = packed_wire_rows(tree)
        rows += (-rows) % inner              # one width group
        if bits is None:
            return rows * _COLS * 4
        return rows * _COLS * bits // 8 + nseg * 4
    rows = 0
    nseg = 0
    last_b = None
    width_rows: Dict[int, int] = {}
    floats = [leaf for leaf in tree_leaves(tree)
              if hasattr(leaf, "dtype") and is_float(leaf)]
    if len(floats) != len(leaf_bits):
        raise ValueError(f"leaf_bits has {len(leaf_bits)} entries for "
                         f"{len(floats)} float leaves")
    for leaf, b in zip(floats, leaf_bits):
        r = -(-math.prod(int(d) for d in leaf.shape) // _COLS)
        rows += r
        width_rows[int(b)] = width_rows.get(int(b), 0) + r
        nseg += 1
        last_b = b
    width_rows[int(last_b)] += (-rows) % 8
    return sum((r + (-r) % inner) * _COLS * b
               for b, r in width_rows.items()) // 8 + nseg * 4
