#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA card; without one it exits non-zero and prints no result.
Phases, in order (any failure exits non-zero; nothing is caught):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``;
3. each kernel against its plain PyTorch version on the card, at its
   path's shapes, with its time (CUDA events, median of 50 launches
   after warm-up, L2 flushed and the card busy before each, so host launch
   latency stays outside the events), its plain version's time, the
   time of one PyTorch library call computing the same function where
   there is one, and the least time the card could take (``bound_ms``).
   ``proto_accum`` is held bit for bit to its batch-order plain version
   (``proto_accum_batch_order``: the kernel's adds in its order) at the
   main path's ``[20, 32, 128]`` and at a three-chunk ``[3, 300, 100]``
   batch with labels outside ``[0, C)``, and to the one-hot einsum within
   rtol 1e-6; ``lowrank_apply`` bit for bit at fc1, conv2, in place on
   the student plane, with ``A`` shared over 300 senders, beyond the
   bank's reach, where its launch plan must take the groups design, and
   at fc1 at ranks 96 to 256, where the plan shortens the ``cp.async``
   ring to fit (the bank at rings of four and three senders, the groups
   design at three and two).  Both rows carry their
   launch plan (``plan``) and the shapes they were held at (``cases``);
4. the main path: ProFe on mnist-cnn at full width (teacher channels
   (32, 64), student (16, 32), proto_dim 128), 20 nodes on a full graph,
   2 rounds of 1 local epoch, ``TrainConfig`` defaults (batch 32, adamw,
   clip 1.0) and the 16-bit wire, through ``run_federation``;
5. the same run on the ``4/16+ef`` wire (int4 student, int16
   prototypes, error feedback): 2 rounds, the same data;
6. a 1-round run on the ``4/16`` wire without error feedback;
7. ProFe on cifar10-resnet18 at full width (ResNet18 teacher, its
   ResNet8 student: blocks (1, 1, 1), width 16, proto_dim 256), 20 nodes
   on a full graph, 1 local epoch, ``TrainConfig`` defaults but the
   optimizer (batch 32, lr 1e-3, clip 1.0, weight decay 0.01, momentum
   0.9), the 16-bit wire: 2 rounds under ``sgd``;
8. the same run for 1 round under ``adafactor``;
9. the adapter-rank wire on mnist-cnn as in 4: rank-8 factors of the
   round delta of conv2, fc1 and fc2 on the int4 wire, naive merge, 2
   rounds (``adapters8``), then with RegMean grams for 1 round
   (``adapters8+grams``); after each, the last round's factors must be
   finite and non-zero (a reference snapshot that aliased the in-place
   student would make them zero);
10. the multi-node exchange (``core/mesh_federation.py``): 8 ranks
    spawned in one gloo group, all on ``cuda:0``, one mnist-cnn node each
    at full width (``TrainConfig`` defaults, the 7040-image data iid over
    8 nodes).  Each round a rank trains its node with the stacked
    engine's ``train_phase`` (local epoch + exact Eq. 3 pass), then runs
    the mesh round: ``mesh/ring16`` (ring, ``ppermute``, 16-bit, 2
    rounds), ``mesh/ring4/16+ef`` (ring, ``ppermute`` with ``overlap``,
    ``4/16+ef``, 1 round) and ``mesh/full-packed`` (``adjacency=None``,
    ``packed``, 16-bit, 1 round).  Every rank holds its bytes handed to
    collectives to the path's copies, its launches to the path's, and its
    prototypes and student to finite values;
11. one rank holding all 8 nodes (``exchange="packed"``, ring adjacency)
    against the stacked engine's ``share_phase`` + ``mix_phase`` on the
    same post-train state: students within 4 ulp of their largest
    magnitude, prototypes and mask bit for bit;
12. ``codec``, the per-leaf and per-tensor wire codec at full width (see
    :func:`run_codec`): ``quantize_dequantize_per_node(packed=False)`` on
    the 20-node mnist-cnn and cifar10-resnet18 student payloads against
    the packed codec and the plain per-leaf math (16-bit; on mnist-cnn
    also ``4/16`` and ``4/16+ef``), the packed-tree API (one node's
    student whole-leaf, and the stacked payload per node) and the
    per-tensor API (every float leaf of one node's student and the
    ResNet18 teacher's ``[3, 3, 512, 512]`` leaf) against
    ``core/quantization``, all bit for bit, each call's launches held
    exactly;
13. ``proto-infer``, the paper's Claim 4 at full width (see
    :func:`run_proto_infer`): on mnist-cnn (2 local epochs) and
    cifar10-resnet18 (1), node 0's 320 images through
    ``make_fedavg_step`` (per-leaf adamw), ``compute_local_prototypes``
    (Eq. 3, ``proto_accum``) and ``nearest_prototype_predict`` on the
    640-image test split (Eq. 5, ``proto_dist``), the kernel's distances
    and predictions held to the plain versions and the accuracy printed;
    then the ProFe pair's KD term through ``kd_loss`` against
    ``core/distillation.kd_loss`` at T = 3 and 1;
14. with ``--profile`` only: where a round's time goes on the main path,
    the ``cifar10/sgd`` path and the ``adapters8`` path — each path's
    own run above is the warm-up, then 2 rounds without and 2 rounds
    under ``torch.profiler`` (see :func:`profile_rounds`);
15. a line ``{"kernels": [...]}`` with each kernel's launches on its
    path, error and times, then the card's ``nvidia-smi`` name and power
    limit, then the result line ``{"ok": true, "device": {...}}`` last.

Phases 4-9 each set the kernels' launch counts to 0 just before
``run_federation`` and read them just after, check finite F1 every
round, and hold the run's wire bytes to the JAX package's; phase 10
does the same on every rank around each mesh run, phase 12 around
the whole codec phase (its per-call launches are read as differences),
and phase 13 around each of its driven parts.  Phase 3's ``proto_dist``
and ``kd_loss`` rows carry every shape they were held at in ``cases``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

N_NODES = 20
ROUNDS = 2
# Wire bytes of exactly these configurations, computed once with the JAX
# package (repro) on the CPU: ScheduleCommAccountant.avg_sent_gb(),
# comm.packed_copy_bytes() and quantization.tree_wire_bytes() of
# run_federation's payload template ({model, protos, counts}) for the
# config's student, N=20, topology "full", the path's rounds and wire
# spec.  They depend only on shapes and the schedule, so the port must
# match them exactly.  The 4/16 bytes hold with or without +ef, since the
# residual never travels.
# The paths, in the order they run: name -> (model config, optimizer,
# wire spec, rounds, expected (avg_sent_gb, packed B/copy, logical
# B/copy)).  "16" is the main path.
PATHS = {
    "16": ("mnist-cnn", "adamw", "16", ROUNDS,
           (0.015825632, 426060, 416464)),
    "4/16+ef": ("mnist-cnn", "adamw", "4/16+ef", 2,
                (0.004030508, 108876, 106066)),
    "4/16": ("mnist-cnn", "adamw", "4/16", 1, (0.002015254, 108876, 106066)),
    "cifar10/sgd": ("cifar10-resnet18", "sgd", "16", 2,
                    (0.007526888, 221336, 198076)),
    "cifar10/adafactor": ("cifar10-resnet18", "adafactor", "16", 1,
                          (0.003763444, 221336, 198076)),
    # the adapter wire's payload {adapters, protos, model: rest[, grams]};
    # these numbers are also what the JAX package's run_federation reports
    # for these runs on the CPU
    "adapters8": ("mnist-cnn", "adamw", "4", 2, (0.000377188, 12376, 9926)),
    "adapters8+grams": ("mnist-cnn", "adamw", "4", 1,
                        (0.000432972, 26724, 22788)),
}
# the FederationConfig fields of a path beyond its wire spec
PATH_FED = {"adapters8": dict(adapter_rank=8),
            "adapters8+grams": dict(adapter_rank=8, adapter_grams=True)}
# matrix leaves of the mnist-cnn student at rank 8: conv2, fc1, fc2
ADAPTER_LEAVES = 3
# the student-plane sweep each optimizer launches once per training step
OPT_KERNEL = {"adamw": "adamw_update", "sgd": "sgd_update",
              "adafactor": "adafactor_apply"}
# the path whose run a kernel's "launches" are read from (phase 3's
# extra shapes -- proto_accum's three-chunk batch against its batch-order
# plain version, lowrank_apply's 300 senders beyond the bank and its ranks
# beyond the wire's -- are checks only and launch on no path)
KERNEL_PATH = {"adamw_update": "16", "proto_accum": "16", "rowabs": "16",
               "quantize_rows": "16", "quantize_rows_mixed": "4/16",
               "rowabs_sum": "4/16+ef", "quantize_rows_ef": "4/16+ef",
               "sgd_update": "cifar10/sgd",
               "adafactor_apply": "cifar10/adafactor",
               "lowrank_apply": "adapters8", "mix_packed": "mesh/ring16",
               "quantize_dequantize_rows": "codec",
               "dequantize_rows": "codec", "fused_quantize": "codec",
               "fused_quantize_dequantize": "codec", "dequantize": "codec",
               "proto_dist": "proto-infer", "kd_loss": "proto-infer"}
# the per-leaf and per-tensor codec's kernels: only the codec phase runs
# them
CODEC_KERNELS = ("quantize_dequantize_rows", "dequantize_rows",
                 "fused_quantize", "fused_quantize_dequantize", "dequantize")
# Eq. 5's and the KD loss's kernels: only the proto-infer phase runs them
PROTO_INFER_KERNELS = ("proto_dist", "kd_loss")
# the multi-node exchange (phase 10): name -> (topology, exchange, wire
# spec, overlap, rounds, collective bytes per rank and round, mix_packed
# launches per rank and round).  The bytes are the copies a rank hands to
# its collectives times packed_copy_bytes({model, protos, counts}) —
# PATHS' constants: a ring rank sends in 2 permutation steps (its
# out-degree), a packed rank hands its one copy to the all-gather.
MESH_NODES = 8
MESH_PATHS = {
    "mesh/ring16": ("ring", "ppermute", "16", False, 2, 2 * 426060, 1),
    "mesh/ring4/16+ef": ("ring", "ppermute", "4/16+ef", True, 1,
                         2 * 108876, 2),
    "mesh/full-packed": ("full", "packed", "16", False, 1, 426060, 1),
}
MESH_DEADLINE_S = 600
# the per-receiver (RegMean) variant of lowrank_apply runs on this path
PER_RECV_PATH = "adapters8+grams"
# the data of each model's paths: make_image_dataset(0, 7040, shape, 10)
# with a 1/11 test split, iid over the nodes (320 images, 10 steps each)
IMAGE_SHAPE = {"mnist-cnn": (28, 28, 1), "cifar10-resnet18": (32, 32, 3)}


def wire_fields(spec) -> dict:
    """The FederationConfig fields that select the wire ``spec``."""
    return dict(quantize_bits=spec.student_bits,
                proto_quantize_bits=spec.proto_bits,
                error_feedback=spec.error_feedback)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
L2_FLUSH_BYTES = 64 << 20        # more than the 50 MB L2
# a spin of ~0.5 ms (at ~2 GHz) before each timed launch: the host
# enqueues the start event, the launch(es) and the end event while the
# card spins, so the events time the device work, not host launch latency
SLEEP_CYCLES = 1_000_000
PROFILE_TOP = 15                 # device activities listed by --profile
# the paths --profile profiles
PROFILED = ("16", "cifar10/sgd", "adapters8")


def expect(ok, msg: str) -> None:
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(msg)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase(name):
    print(f"\n=== {name} ===", flush=True)


class Timer:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, after
    warm-up, with the L2 cache flushed and the card kept busy (so the
    host is ahead of it) before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, reps: int = 50, warmup: int = 5) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_diff(torch, a, b) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    # map the sign-magnitude float bit patterns onto a monotone line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def payload_buffer(torch, gen, student_cfg):
    """The main path's packed wire buffer: 20 nodes' random student
    planes (the init's scales) spliced behind random prototypes.
    Returns ``(buf, seg_ids, meta, plane, protos)``."""
    from repro_torch.kernels.quantize.ops import pack_plane_payload
    from repro_torch.models import init_params
    from repro_torch.optim.plane import Plane, plane_from_tree
    from repro_torch.wirespec import WireSpec
    planes = [plane_from_tree(init_params(student_cfg, gen))
              for _ in range(N_NODES)]
    plane = Plane(torch.stack([p.buf for p in planes]).cuda(),
                  planes[0].meta)
    protos = torch.rand((N_NODES, student_cfg.num_classes,
                         student_cfg.proto_dim), generator=gen).cuda()
    buf, seg_ids, meta, _, _ = pack_plane_payload(protos, plane,
                                                  WireSpec(16))
    return buf, seg_ids, meta, plane, protos


def check_kernels(torch, timer, student_cfg):
    """Phase 3: every kernel against its plain version at path shapes."""
    import numpy as np
    from repro_torch.kernels.opt_update.opt_update import adamw_update_cuda
    from repro_torch.kernels.opt_update.ref import adamw_update_ref
    from repro_torch.kernels.proto_accum.proto_accum import (
        COLS, ROWS, THREADS, proto_accum_cuda, proto_accum_smem)
    from repro_torch.kernels.proto_accum.ref import (proto_accum_batch_order,
                                                     proto_accum_ref)
    from repro_torch.kernels.quantize.ops import (_node_row_deltas,
                                                  _seg_qmax,
                                                  pack_plane_payload)
    from repro_torch.kernels.quantize.quantize import (
        quantize_rows_cuda, quantize_rows_ef_cuda, quantize_rows_mixed_cuda,
        rowabs_cuda, rowabs_sum_cuda)
    from repro_torch.kernels.quantize.ref import (quantize_rows_ef_ref,
                                                  quantize_rows_mixed_ref,
                                                  quantize_rows_ref,
                                                  rowabs_ref, rowabs_sum_ref)
    from repro_torch.wirespec import WireSpec

    gen = torch.Generator().manual_seed(0)
    rows = []

    # -- adamw over the student plane [N, R, 512] ------------------------
    buf, seg_ids, meta, plane, protos = payload_buffer(torch, gen,
                                                       student_cfg)
    shape = tuple(plane.buf.shape)
    p = plane.buf.contiguous()
    g = (torch.randn(shape, generator=gen) * 1e-3).cuda()
    mu = (torch.randn(shape, generator=gen) * 1e-4).cuda()
    nu = (torch.rand(shape, generator=gen) * 1e-7).cuda()
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    step = torch.tensor(3, dtype=torch.int32, device="cuda")
    lr = torch.full((), 1e-3, device="cuda")
    bc1 = 1.0 - 0.9 ** step.float()
    bc2 = 1.0 - 0.999 ** step.float()
    scale = torch.rand((N_NODES,), generator=gen).cuda().clamp_min(0.1)
    want = adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale, bc1=bc1,
                            bc2=bc2, **hp)
    got = [p.clone(), mu.clone(), nu.clone()]
    adamw_update_cuda(g, *got, lr, scale, bc1, bc2, **hp)
    torch.cuda.synchronize()
    ulps = max(ulp_diff(torch, a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"adamw_update {shape}: max |kernel - plain| = {err:.3e}, "
          f"max ulp difference {ulps}")
    # both compute the same sequence of IEEE-rounded fp32 operations
    # (kernel: explicit _rn intrinsics, -fmad=false), so bit-exact
    expect(ulps == 0,
           "adamw kernel is not bit-exact with its plain version")
    ms = timer(lambda: adamw_update_cuda(g, *got, lr, scale, bc1, bc2, **hp))
    plain_ms = timer(lambda: adamw_update_ref(g, p, mu, nu, lr=lr,
                                              scale=scale, bc1=bc1, bc2=bc2,
                                              **hp))
    # library yardstick: PyTorch's fused AdamW over the same plane in
    # one call.  It has no per-node clip scale, so its gradient is
    # scaled per node here, outside the timed region.
    g_scaled = (g.reshape(N_NODES, -1) * scale[:, None]).reshape(shape)
    lib = [t.detach().clone() for t in (p, mu, nu)]
    lib_step = [torch.full((), 3.0, device="cuda")]
    lib_ms = timer(lambda: torch._fused_adamw_(
        [lib[0]], [g_scaled], [lib[1]], [lib[2]], [], lib_step, lr=1e-3,
        beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False))
    n = p.numel()
    b_ms, b_by = bound(7 * 4 * n, 18 * n)
    rows.append(dict(name="adamw_update", route="cuda",
                     source="src/repro_torch/csrc/opt_update.cu",
                     replaces="src/repro/kernels/opt_update/opt_update.py:80",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

    # -- rowabs and quantize_rows on the packed payload [N*R, 512] -------
    n_nodes, r, c = buf.shape
    x2d = buf.reshape(n_nodes * r, c).contiguous()
    got = rowabs_cuda(x2d)
    want = rowabs_ref(x2d)
    torch.cuda.synchronize()
    expect(torch.equal(got, want),
           "rowabs kernel disagrees with plain")
    ms = timer(lambda: rowabs_cuda(x2d))
    plain_ms = timer(lambda: rowabs_ref(x2d))
    lib_ms = timer(lambda: torch.linalg.vector_norm(x2d, ord=math.inf,
                                                    dim=1))
    b_ms, b_by = bound(4 * x2d.numel() + 4 * x2d.shape[0], x2d.numel())
    rows.append(dict(name="rowabs", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:186",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms))
    print(f"rowabs {tuple(x2d.shape)}: bit-exact")

    _, row_delta = _node_row_deltas(buf, seg_ids, meta[1], 16, meta[3])
    rd = row_delta.reshape(-1, 1).contiguous()
    got = quantize_rows_cuda(x2d, rd, bits=16)
    want = quantize_rows_ref(x2d, rd, bits=16)
    torch.cuda.synchronize()
    expect(torch.equal(got, want),
           "quantize_rows kernel disagrees")
    ms = timer(lambda: quantize_rows_cuda(x2d, rd, bits=16))
    plain_ms = timer(lambda: quantize_rows_ref(x2d, rd, bits=16))
    # library yardstick: per-row affine quantization in one call.  It
    # rounds half to even (the kernel rounds half up) and clips to the
    # int32 range, which these codes (|code| <= 32767) never reach.
    zero = torch.zeros(rd.shape[0], dtype=torch.int64, device="cuda")
    scales = rd[:, 0].contiguous()
    lib_ms = timer(lambda: torch.quantize_per_channel(x2d, scales, zero, 0,
                                                      torch.qint32))
    b_ms, b_by = bound(8 * x2d.numel() + 4 * rd.numel(), 4 * x2d.numel())
    rows.append(dict(name="quantize_rows", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:313",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms))
    print(f"quantize_rows {tuple(x2d.shape)}: bit-exact codes")

    # -- the 4/16 wire: int16 prototype rows, int4 student rows ----------
    # No single PyTorch call computes these three functions (a per-row
    # clip width; a residual added inside the reduction or the sweep), so
    # their library_ms is null.
    _, _, mmeta, _, _ = pack_plane_payload(protos, plane, WireSpec(4, 16))
    seg_bits = mmeta[3]
    _, row_delta = _node_row_deltas(buf, seg_ids, mmeta[1], 16, seg_bits)
    rd = row_delta.reshape(-1, 1).contiguous()
    qm = torch.as_tensor(np.tile(_seg_qmax(mmeta[1], 16, seg_bits)[seg_ids],
                                 n_nodes)[:, None], device="cuda")
    got = quantize_rows_mixed_cuda(x2d, rd, qm)
    want = quantize_rows_mixed_ref(x2d, rd, qm)
    torch.cuda.synchronize()
    expect(torch.equal(got, want), "quantize_rows_mixed kernel disagrees")
    r_p = int((seg_ids == 0).sum())           # the int16 prototype rows
    by_node = got.reshape(n_nodes, r, c)
    expect(int(by_node[:, :r_p].abs().max()) > 8
           and int(by_node[:, r_p:].abs().max()) <= 8,
           "quantize_rows_mixed: row widths are not the 4/16 spec's")
    ms = timer(lambda: quantize_rows_mixed_cuda(x2d, rd, qm))
    plain_ms = timer(lambda: quantize_rows_mixed_ref(x2d, rd, qm))
    b_ms, b_by = bound(8 * x2d.numel() + 8 * rd.numel(), 5 * x2d.numel())
    rows.append(dict(name="quantize_rows_mixed", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:339",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))
    print(f"quantize_rows_mixed {tuple(x2d.shape)}: bit-exact codes")

    # a residual of the size error feedback carries: within half a Δ
    res2d = ((torch.rand(x2d.shape, generator=gen) - 0.5).cuda() * rd)
    for decay in (1.0, 0.9):        # the path's default, and a decay
        dec = torch.tensor(decay, dtype=torch.float32, device="cuda")
        got = rowabs_sum_cuda(x2d, res2d, decay)
        want = rowabs_sum_ref(x2d, res2d, dec)
        c_got, r_got = quantize_rows_ef_cuda(x2d, res2d, rd, qm, decay)
        c_want, r_want = quantize_rows_ef_ref(x2d, res2d, rd, qm, dec)
        torch.cuda.synchronize()
        expect(torch.equal(got, want),
               f"rowabs_sum kernel disagrees (decay {decay})")
        expect(torch.equal(c_got, c_want),
               f"quantize_rows_ef codes disagree (decay {decay})")
        expect(ulp_diff(torch, r_got, r_want) == 0,
               f"quantize_rows_ef residual is not bit-exact (decay {decay})")
    dec = torch.ones((), device="cuda")
    ms = timer(lambda: rowabs_sum_cuda(x2d, res2d, 1.0))
    plain_ms = timer(lambda: rowabs_sum_ref(x2d, res2d, dec))
    b_ms, b_by = bound(8 * x2d.numel() + 4 * x2d.shape[0], 4 * x2d.numel())
    rows.append(dict(name="rowabs_sum", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:224",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))
    print(f"rowabs_sum {tuple(x2d.shape)}: bit-exact at decay 1.0 and 0.9")
    ms = timer(lambda: quantize_rows_ef_cuda(x2d, res2d, rd, qm, 1.0))
    plain_ms = timer(lambda: quantize_rows_ef_ref(x2d, res2d, rd, qm, dec))
    b_ms, b_by = bound(16 * x2d.numel() + 8 * rd.numel(), 9 * x2d.numel())
    rows.append(dict(name="quantize_rows_ef", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:258",
                     max_abs_err=max(float((c_got - c_want).abs().max()),
                                     float((r_got - r_want).abs().max())),
                     ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None))
    print(f"quantize_rows_ef {tuple(x2d.shape)}: codes and residual "
          f"bit-exact at decay 1.0 and 0.9")

    # -- proto_accum at [20, 32, 128], C = 10 -----------------------------
    ncls, bsz, pdim = student_cfg.num_classes, 32, student_cfg.proto_dim
    f1 = torch.relu(torch.randn((N_NODES, bsz, pdim), generator=gen)).cuda()
    labels = torch.randint(0, ncls, (N_NODES, bsz), generator=gen,
                           dtype=torch.int32).cuda()
    s_got, c_got = proto_accum_cuda(f1, labels, ncls)
    s_bat, c_bat = proto_accum_batch_order(f1, labels, ncls)
    s_want, c_want = proto_accum_ref(f1, labels, ncls)
    torch.cuda.synchronize()
    expect(torch.equal(c_got, c_want) and torch.equal(c_got, c_bat),
           "proto_accum counts disagree")
    # the kernel adds in batch order, as its batch-order plain version does
    expect(ulp_diff(torch, s_got, s_bat) == 0,
           "proto_accum sums are not bit-identical to the batch-order plain "
           "version")
    # the plain einsum sums in cuBLAS's order, the kernel in batch order
    expect(torch.allclose(s_got, s_want, rtol=1e-6, atol=0),
           "proto_accum sums disagree beyond rtol 1e-6")
    rel = float(((s_got - s_want).abs() / s_want.abs().clamp_min(1e-30))
                .max())
    print(f"proto_accum {tuple(f1.shape)} C={ncls}: sums bit-identical to "
          f"the batch-order plain version, counts equal; einsum max rel err "
          f"{rel:.3e}")
    # a batch of three staged chunks, P not a multiple of 4 (4-byte
    # copies), labels outside [0, C)
    rf1 = torch.relu(torch.randn((3, 2 * ROWS + 44, 100), generator=gen))
    rlab = torch.randint(-1, 9, rf1.shape[:2], generator=gen,
                         dtype=torch.int32)
    r_got = proto_accum_cuda(rf1.cuda(), rlab.cuda(), 7)
    r_bat = proto_accum_batch_order(rf1.cuda(), rlab.cuda(), 7)
    torch.cuda.synchronize()
    expect(ulp_diff(torch, r_got[0], r_bat[0]) == 0
           and torch.equal(r_got[1], r_bat[1]),
           f"proto_accum at {tuple(rf1.shape)} C=7 is not bit-identical to "
           f"the batch-order plain version")
    print(f"proto_accum {tuple(rf1.shape)} C=7, labels in [-1, 8]: "
          f"bit-identical to the batch-order plain version")
    ms = timer(lambda: proto_accum_cuda(f1, labels, ncls))
    plain_ms = timer(lambda: proto_accum_ref(f1, labels, ncls))
    node_cls = (torch.arange(N_NODES, device="cuda")[:, None] * ncls
                + labels).reshape(-1)
    f1_flat = f1.reshape(-1, pdim)

    def library():
        sums = torch.zeros((N_NODES * ncls, pdim), device="cuda")
        sums.index_add_(0, node_cls, f1_flat)
        torch.bincount(node_cls, minlength=N_NODES * ncls)
    lib_ms = timer(library)
    b_ms, b_by = bound(4 * (f1.numel() + labels.numel() + s_got.numel()
                            + c_got.numel()), f1.numel() + labels.numel())
    rows.append(dict(name="proto_accum", route="cuda",
                     source="src/repro_torch/csrc/proto_accum.cu",
                     replaces="src/repro/kernels/proto_accum/"
                              "proto_accum.py:57",
                     max_abs_err=float((s_got - s_bat).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms,
                     plan=dict(cols=COLS, chunk_rows=ROWS, threads=THREADS,
                               grid=[-(-pdim // COLS), N_NODES],
                               smem=proto_accum_smem(bsz, ncls)),
                     cases=[[list(f1.shape), ncls], [list(rf1.shape), 7]]))
    for row in rows:
        print(f"  {row['name']:19s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  library {row['library_ms']}  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def check_plane_sweeps(torch, timer, student_cfg):
    """Phase 3, the sgd and adafactor sweeps: each kernel against its
    plain version on 20 nodes' ResNet8 student planes ``[20, 208, 512]``
    (the CIFAR paths' shape), bit for bit, and timed."""
    from repro_torch.kernels.opt_update.opt_update import (
        adafactor_apply_cuda, sgd_update_cuda)
    from repro_torch.kernels.opt_update.ref import (adafactor_apply_ref,
                                                    sgd_update_ref)
    from repro_torch.models import init_params
    from repro_torch.optim.plane import plane_from_tree

    gen = torch.Generator().manual_seed(1)
    planes = [plane_from_tree(init_params(student_cfg, gen))
              for _ in range(N_NODES)]
    p = torch.stack([pl.buf for pl in planes]).cuda()
    shape = tuple(p.shape)
    real = torch.zeros(shape[1:])        # 1 on leaf lanes, 0 on padding
    for _, _, leaf_shape, row, r_leaf in planes[0].meta.recipe:
        real[row:row + r_leaf].view(-1)[:math.prod(leaf_shape)] = 1.0
    real = real.cuda()
    g = (torch.randn(shape, generator=gen) * 1e-2).cuda() * real
    mu = (torch.randn(shape, generator=gen) * 1e-3).cuda() * real
    lr = torch.full((), 1e-3, device="cuda")
    scale = torch.rand((N_NODES,), generator=gen).cuda().clamp_min(0.1)
    hp = dict(momentum=0.9, weight_decay=0.01)
    n = p.numel()
    rows = []

    want = sgd_update_ref(g, p, mu, lr=lr, scale=scale, **hp)
    got = [p.clone(), mu.clone()]
    sgd_update_cuda(g, *got, lr, scale, **hp)
    torch.cuda.synchronize()
    ulps = max(ulp_diff(torch, a, b) for a, b in zip(got, want))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"sgd_update {shape}: max |kernel - plain| = {err:.3e}, max ulp "
          f"difference {ulps}")
    expect(ulps == 0, "sgd kernel is not bit-exact with its plain version")
    ms = timer(lambda: sgd_update_cuda(g, *got, lr, scale, **hp))
    plain_ms = timer(lambda: sgd_update_ref(g, p, mu, lr=lr, scale=scale,
                                            **hp))
    # library yardstick: PyTorch's fused SGD over the same plane in one
    # call, its gradient scaled per node outside the timed region.  It
    # adds the weight decay to the gradient before the momentum
    # (mu' = m·mu + g + wd·p), so it is a time yardstick only.
    g_scaled = (g.reshape(N_NODES, -1) * scale[:, None]).reshape(shape)
    lib = [p.clone(), mu.clone()]
    lib_ms = timer(lambda: torch._fused_sgd_(
        [lib[0]], [g_scaled], [lib[1]], weight_decay=0.01, momentum=0.9,
        lr=1e-3, dampening=0.0, nesterov=False, maximize=False,
        is_first_step=False))
    b_ms, b_by = bound(5 * 4 * n, 7 * n)
    rows.append(dict(name="sgd_update", route="cuda",
                     source="src/repro_torch/csrc/opt_update.cu",
                     replaces="src/repro/kernels/opt_update/opt_update.py:40",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

    # the packed clipped update of adafactor: about ±1 on the real lanes
    upd = torch.randn(shape, generator=gen).cuda() * real
    want = adafactor_apply_ref(upd, p, lr=lr, weight_decay=0.01)
    got = p.clone()
    adafactor_apply_cuda(upd, got, lr, weight_decay=0.01)
    torch.cuda.synchronize()
    ulps = ulp_diff(torch, got, want)
    err = float((got - want).abs().max())
    print(f"adafactor_apply {shape}: max |kernel - plain| = {err:.3e}, max "
          f"ulp difference {ulps}")
    expect(ulps == 0,
           "adafactor_apply kernel is not bit-exact with its plain version")
    ms = timer(lambda: adafactor_apply_cuda(upd, got, lr, weight_decay=0.01))
    plain_ms = timer(lambda: adafactor_apply_ref(upd, p, lr=lr,
                                                 weight_decay=0.01))
    # library yardstick: PyTorch's fused SGD without momentum computes the
    # same function, p - lr·(upd + wd·p), in one call
    lib = [p.clone()]
    lib_ms = timer(lambda: torch._fused_sgd_(
        lib, [upd], [], weight_decay=0.01, momentum=0.0, lr=1e-3,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False))
    b_ms, b_by = bound(3 * 4 * n, 4 * n)
    rows.append(dict(name="adafactor_apply", route="cuda",
                     source="src/repro_torch/csrc/opt_update.cu",
                     replaces="src/repro/kernels/opt_update/opt_update.py:120",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    for row in rows:
        print(f"  {row['name']:19s} kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  library {row['library_ms']}  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def check_lowrank(torch, timer, student_cfg):
    """Phase 3, the adapter merge: ``lowrank_apply`` against its plain
    version, bit for bit, at the path's shapes (20 receivers and senders,
    rank 8, the full graph's gossip weights), with ``A`` shared (naive
    merge) and per receiver (RegMean):

    * at fc1's ``w [20, 1568, 128]``, timed, beside ``baddbmm``;
    * at conv2's ``w [20, 3, 3, 16, 32]``, whose 3×3 lead axes fold into
      the launch and whose 16 rows fill a quarter of a row tile (too few
      tiles for the bank: the groups design in both variants);
    * in place on 20 nodes' real student plane, through the merge's own
      sweep ``adapter_apply_plane`` (conv2, fc1 and fc2 at their row
      spans, the rest copied): every lane of the plane against the plain
      version applied to the same views, padding included;
    * with ``A`` shared beyond the bank's reach (S = 300 senders of a
      ``[64, 32]`` leaf: the bank ``D[S][tile]`` exceeds a block's shared
      memory at every tile), where the launch plan must take the groups
      design with ``A``'s receiver stride 0;
    * at fc1 beyond the adapter wire's rank: rank 128 with ``A`` shared
      (the bank, a ring of four senders) and per receiver (the groups
      design, a ring of two), rank 96 per receiver (a ring of three) and
      rank 256 with ``A`` shared (the bank, a ring of three), each plan
      held to the design and ring depth named.

    Each case prints its launch plan (``lowrank_plan``: design, tile,
    ring depth, shared memory); the row carries the timed shapes' plans
    and every case's.  fc1 with ``A`` shared must take the bank design."""
    from dataclasses import asdict

    from repro_torch.core.adapters import adapter_layout, split_student
    from repro_torch.kernels.lowrank_apply.lowrank_apply import (
        lowrank_apply_cuda, lowrank_plan)
    from repro_torch.kernels.lowrank_apply.ops import adapter_apply_plane
    from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref
    from repro_torch.models import init_params
    from repro_torch.optim.plane import Plane, _leaf_view, as_tree, \
        plane_from_tree

    gen = torch.Generator().manual_seed(2)
    n, r = N_NODES, 8
    coeffs = ((1.0 - torch.eye(n)) / n).cuda()

    def factors(lead, d, k, scale_a, r=r):
        b = (torch.randn((n,) + lead + (d, r), generator=gen)
             / math.sqrt(d)).cuda()
        a = {"shared": (torch.randn((n,) + lead + (r, k), generator=gen)
                        * scale_a).cuda(),
             "per_recv": (torch.randn((n, n) + lead + (r, k), generator=gen)
                          * scale_a).cuda()}
        return b, a

    # fc1, timed
    d, k = 1568, 128
    w = (torch.randn((n, d, k), generator=gen) * 0.05).cuda()
    b, variants = factors((), d, k, 1e-3)
    out = torch.empty_like(w)
    rows, cases = {}, []

    def plan_of(w, s, variant, r=r):
        plan = lowrank_plan(w.shape[0], s, math.prod(w.shape[1:-2]),
                            w.shape[-2], w.shape[-1], r, variant == "per_recv")
        cases.append(dict(w=list(w.shape), senders=s, rank=r,
                          variant=variant, **asdict(plan)))
        return plan

    def says(plan):
        return (f"{plan.design} {plan.tile_d}x{plan.tile_k}, grid "
                f"{plan.grid}, {plan.threads} threads, ring of "
                f"{plan.stages}, {plan.smem} B shared")

    for variant, a in variants.items():
        plan = plan_of(w, n, variant)
        expect(plan.design == ("bank" if variant == "shared" else "groups"),
               f"lowrank_plan took {plan.design} at fc1 ({variant})")
        got = lowrank_apply_cuda(w, coeffs, b, a, out=out).clone()
        want = lowrank_apply_ref(w, coeffs, b, a)
        torch.cuda.synchronize()
        expect(ulp_diff(torch, got, want) == 0,
               f"lowrank_apply ({variant}) is not bit-exact with its plain "
               f"version")
        ms = timer(lambda: lowrank_apply_cuda(w, coeffs, b, a, out=out))
        plain_ms = timer(lambda: lowrank_apply_ref(w, coeffs, b, a))
        # library yardstick: one batched product over the stacked senders,
        # out = w + [c_i0·B_0 | ... ] @ [A_0; ...], TF32 off
        bc = (coeffs[:, :, None, None] * b[None]).permute(0, 2, 1, 3) \
            .reshape(n, d, n * r).contiguous()
        acat = a.reshape(-1, n * r, k)
        acat = acat.expand(n, n * r, k) if variant == "shared" else acat
        lib = torch.baddbmm(w, bc, acat)
        lib_ms = timer(lambda: torch.baddbmm(w, bc, acat))
        # the least work: with A shared, each sender's B_j @ A_j
        # (2r flops an element) is the same for every receiver, and
        # each receiver then scales and adds it (2 flops) before the
        # add onto w; per receiver, every B_j @ Ã_ij is its own
        ops = (n * d * k * (2 * r + 2 * n + 1) if variant == "shared"
               else n * n * d * k * (2 * r + 2))
        b_ms, b_by = bound(4 * (2 * w.numel() + b.numel() + a.numel()
                                + coeffs.numel()), ops)
        rows[variant] = dict(max_abs_err=float((got - want).abs().max()),
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms,
                             plan=asdict(plan))
        print(f"lowrank_apply {variant} w {tuple(w.shape)} a "
              f"{tuple(a.shape)} ({says(plan)}): bit-exact; baddbmm differs "
              f"by {float((lib - want).abs().max()):.3e}")

    # conv2: lead axes (3, 3), d = 16 < one 64-row tile
    lead, d, k = (3, 3), 16, 32
    w = (torch.randn((n,) + lead + (d, k), generator=gen) * 0.05).cuda()
    b, variants = factors(lead, d, k, 0.1)
    for variant, a in variants.items():
        plan = plan_of(w, n, variant)
        got = lowrank_apply_cuda(w, coeffs, b, a)
        want = lowrank_apply_ref(w, coeffs, b, a)
        torch.cuda.synchronize()
        expect(ulp_diff(torch, got, want) == 0,
               f"lowrank_apply ({variant}) at conv2's shapes is not "
               f"bit-exact with its plain version")
        print(f"lowrank_apply {variant} w {tuple(w.shape)} a "
              f"{tuple(a.shape)} ({says(plan)}): bit-exact")

    # in place on the real plane, through the merge's sweep
    planes = [plane_from_tree(init_params(student_cfg, gen))
              for _ in range(n)]
    plane = Plane(torch.stack([p.buf for p in planes]).cuda(),
                  planes[0].meta)
    layout = adapter_layout(as_tree(plane), r, node_axis=True)
    _, rest = split_student(layout, as_tree(plane))
    rest_mixed = {name: x + 0.1 for name, x in rest.items()}
    banks = {}
    for name, shape in zip(layout.names, layout.shapes):
        if name in layout.mat_names:
            banks[name] = factors(shape[:-2], shape[-2], shape[-1], 0.1)
    expect(len(banks) == ADAPTER_LEAVES,
           f"matrix leaves {sorted(banks)} of the student")
    for variant in ("shared", "per_recv"):
        fs = {name: {"B": b, "A": a[variant]}
              for name, (b, a) in banks.items()}
        want = plane.buf.clone()
        for name, (_, _, shape, row, r_leaf) in zip(layout.names,
                                                    plane.meta.recipe):
            view = _leaf_view(want, shape, row, r_leaf)
            if name in fs:
                view.copy_(lowrank_apply_ref(view, coeffs, fs[name]["B"],
                                             fs[name]["A"]))
            else:
                view.copy_(rest_mixed[name])
        got = Plane(plane.buf.clone(), plane.meta)
        adapter_apply_plane(got, layout, coeffs, fs, rest_mixed)
        torch.cuda.synchronize()
        expect(ulp_diff(torch, got.buf, want) == 0,
               f"adapter_apply_plane ({variant}) on the student plane "
               f"disagrees with the plain version on its views")
        print(f"lowrank_apply {variant} in place on the student plane "
              f"{tuple(plane.buf.shape)} ({', '.join(sorted(fs))}): "
              f"bit-exact on every lane, padding included")

    # A shared beyond the bank's reach: the groups design, receiver stride 0
    s_far, d, k = 300, 64, 32
    w = (torch.randn((n, d, k), generator=gen) * 0.05).cuda()
    c_far = (torch.rand((n, s_far), generator=gen) / s_far).cuda()
    b = (torch.randn((s_far, d, r), generator=gen) / math.sqrt(d)).cuda()
    a = (torch.randn((s_far, r, k), generator=gen) * 1e-2).cuda()
    plan = plan_of(w, s_far, "shared")
    expect(plan.design == "groups",
           f"lowrank_plan took {plan.design} for {s_far} senders with A "
           f"shared; the bank cannot hold them")
    got = lowrank_apply_cuda(w, c_far, b, a)
    want = lowrank_apply_ref(w, c_far, b, a)
    torch.cuda.synchronize()
    expect(ulp_diff(torch, got, want) == 0,
           f"lowrank_apply with A shared over {s_far} senders is not "
           f"bit-exact with its plain version")
    print(f"lowrank_apply shared w {tuple(w.shape)} a {tuple(a.shape)} "
          f"({says(plan)}): bit-exact")

    # fc1 beyond the wire's rank 8: each design at each ring depth it takes
    d, k = 1568, 128
    w = (torch.randn((n, d, k), generator=gen) * 0.05).cuda()
    for r_hi, variant, design, stages in ((128, "shared", "bank", 4),
                                          (128, "per_recv", "groups", 2),
                                          (96, "per_recv", "groups", 3),
                                          (256, "shared", "bank", 3)):
        b, variants = factors((), d, k, 1e-3, r=r_hi)
        a = variants[variant]
        plan = plan_of(w, n, variant, r=r_hi)
        expect((plan.design, plan.stages) == (design, stages),
               f"lowrank_plan took {plan.design} with a ring of "
               f"{plan.stages} at fc1, rank {r_hi} ({variant})")
        got = lowrank_apply_cuda(w, coeffs, b, a)
        want = lowrank_apply_ref(w, coeffs, b, a)
        torch.cuda.synchronize()
        expect(ulp_diff(torch, got, want) == 0,
               f"lowrank_apply ({variant}) at rank {r_hi} is not bit-exact "
               f"with its plain version")
        print(f"lowrank_apply {variant} rank {r_hi} w {tuple(w.shape)} a "
              f"{tuple(a.shape)} ({says(plan)}): bit-exact")

    row = dict(name="lowrank_apply", route="cuda",
               source="src/repro_torch/csrc/lowrank_apply.cu",
               replaces="src/repro/kernels/lowrank_apply/lowrank_apply.py:53",
               **rows["shared"], cases=cases)
    row["per_recv"] = rows["per_recv"]
    print(f"  {'lowrank_apply':19s} kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  library {row['library_ms']:.4f} ms  "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); per receiver "
          f"{rows['per_recv']['ms']:.4f} / {rows['per_recv']['plain_ms']:.4f}"
          f" / {rows['per_recv']['library_ms']:.4f} ms, bound "
          f"{rows['per_recv']['bound_ms']:.4f} ({rows['per_recv']['bound_by']})")
    return [row]


def codec_payload(torch, model: str, seed: int):
    """The per-leaf codec's payload on the card at full width:
    ``{"protos": [20, 10, P], "student": 20 nodes' seeded init_params
    stacked}``, the prototypes normal from a seeded generator."""
    from repro_torch.config import get_config
    from repro_torch.models import derive_student, init_params
    from repro_torch.tree import tree_map
    cfg = derive_student(get_config(model))
    gen = torch.Generator().manual_seed(seed)
    trees = [init_params(cfg, gen) for _ in range(N_NODES)]
    student = tree_map(lambda *xs: torch.stack(xs).float().cuda(), *trees)
    protos = torch.randn((N_NODES, cfg.num_classes, cfg.proto_dim),
                         generator=gen).cuda()
    return {"protos": protos, "student": student}


def teacher_leaf(torch):
    """The ResNet18 teacher's largest leaf, ``[3, 3, 512, 512]``, from a
    seeded init_params, on the card."""
    from repro_torch.config import get_config
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(init_params(get_config("cifar10-resnet18"),
                                     torch.Generator().manual_seed(4)))
    x = max(leaves, key=lambda t: t.numel())
    expect(tuple(x.shape) == (3, 3, 512, 512),
           f"the teacher's largest leaf is {tuple(x.shape)}")
    return x.float().cuda()


def bits_equal(torch, a, b) -> bool:
    """Same shape, dtype and bits (fp32 compared as int32 bit patterns)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = (t.contiguous().view(torch.int32) for t in (a, b))
    return torch.equal(a, b)


def check_codec_kernels(torch, timer):
    """Phase 3, the per-leaf and per-tensor codec's five kernels against
    their plain versions, bit for bit, and timed: ``quantize_dequantize_
    rows`` and ``dequantize_rows`` at the mnist-cnn per-leaf payload
    (``pack_tree(node_axis=True)``: ``[8240, 512]``, 180 segments),
    ``fused_quantize``, ``fused_quantize_dequantize`` and ``dequantize``
    at the ResNet18 teacher's ``[3, 3, 512, 512]`` leaf."""
    from repro_torch.kernels.quantize.ops import (_qmax_t, _segment_deltas,
                                                  pack_tree)
    from repro_torch.kernels.quantize.quantize import (
        dequantize_cuda, dequantize_rows_cuda, fused_quantize_cuda,
        fused_quantize_dequantize_cuda, quantize_dequantize_rows_cuda)
    from repro_torch.kernels.quantize.ref import (
        dequantize_ref, dequantize_rows_ref, fused_quantize_dequantize_ref,
        fused_quantize_ref, quantize_dequantize_rows_ref, quantize_rows_ref)

    rows = []

    def row(name, line, err, ms, plain_ms, nbytes, nops, lib_ms):
        b_ms, b_by = bound(nbytes, nops)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/quantize.cu",
                         replaces=f"src/repro/kernels/quantize/quantize.py:"
                                  f"{line}",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

    # -- rows 7 and 12 on the per-leaf payload ----------------------------
    buf, seg_ids, meta = pack_tree(codec_payload(torch, "mnist-cnn", 3),
                                   node_axis=True)
    expect(tuple(buf.shape) == (8240, 512) and meta[1] == 180,
           f"per-leaf payload {tuple(buf.shape)}, {meta[1]} segments")
    _, rd = _segment_deltas(buf, seg_ids, meta[1], 16)
    rd = rd.contiguous()
    n, r = buf.numel(), buf.shape[0]
    got = quantize_dequantize_rows_cuda(buf, rd, bits=16)
    want = quantize_dequantize_rows_ref(buf, rd, bits=16)
    torch.cuda.synchronize()
    expect(bits_equal(torch, got, want),
           "quantize_dequantize_rows is not bit-exact with its plain version")
    # library yardstick: per-row fake quantization in one call.  It
    # rounds half to even (the kernel rounds half up).
    zero = torch.zeros(r, dtype=torch.int32, device="cuda")
    scales = rd[:, 0].contiguous()
    lib = torch.fake_quantize_per_channel_affine(buf, scales, zero, 0,
                                                 -32768, 32767)
    print(f"quantize_dequantize_rows {tuple(buf.shape)}: bit-exact; "
          f"fake_quantize_per_channel_affine differs by "
          f"{float((lib - want).abs().max()):.3e}")
    row("quantize_dequantize_rows", 321, float((got - want).abs().max()),
        timer(lambda: quantize_dequantize_rows_cuda(buf, rd, bits=16)),
        timer(lambda: quantize_dequantize_rows_ref(buf, rd, bits=16)),
        8 * n + 4 * r, 5 * n,
        timer(lambda: torch.fake_quantize_per_channel_affine(
            buf, scales, zero, 0, -32768, 32767)))

    codes = quantize_rows_ref(buf, rd, bits=16)
    got = dequantize_rows_cuda(codes, rd)
    want = dequantize_rows_ref(codes, rd)
    torch.cuda.synchronize()
    expect(bits_equal(torch, got, want),
           "dequantize_rows is not bit-exact with its plain version")
    print(f"dequantize_rows {tuple(codes.shape)}: bit-exact")
    row("dequantize_rows", 417, float((got - want).abs().max()),
        timer(lambda: dequantize_rows_cuda(codes, rd)),
        timer(lambda: dequantize_rows_ref(codes, rd)), 8 * n + 4 * r, n,
        timer(lambda: torch.mul(codes, rd)))

    # -- rows 13-15 on the teacher's largest leaf --------------------------
    x = teacher_leaf(torch)
    n = x.numel()
    qm = _qmax_t(16, x.device)
    c_got, d_got = fused_quantize_cuda(x, bits=16)
    c_want, d_want = fused_quantize_ref(x, qm)
    o_got, e_got = fused_quantize_dequantize_cuda(x, bits=16)
    o_want, e_want = fused_quantize_dequantize_ref(x, qm)
    torch.cuda.synchronize()
    expect(bits_equal(torch, c_got, c_want)
           and bits_equal(torch, d_got, d_want),
           "fused_quantize codes or delta disagree with the plain version")
    expect(bits_equal(torch, o_got, o_want)
           and bits_equal(torch, e_got, e_want),
           "fused_quantize_dequantize is not bit-exact with its plain "
           "version")
    print(f"fused_quantize / fused_quantize_dequantize {tuple(x.shape)}: "
          f"codes, round trip and delta {float(d_got):.6e} bit-exact")
    # no single PyTorch call takes the absmax and writes the codes, so
    # rows 13 and 14 have no library yardstick
    row("fused_quantize", 120, float((c_got - c_want).abs().max()),
        timer(lambda: fused_quantize_cuda(x, bits=16)),
        timer(lambda: fused_quantize_ref(x, qm)), 8 * n + 4, 6 * n, None)
    row("fused_quantize_dequantize", 133, float((o_got - o_want).abs().max()),
        timer(lambda: fused_quantize_dequantize_cuda(x, bits=16)),
        timer(lambda: fused_quantize_dequantize_ref(x, qm)), 8 * n + 4,
        7 * n, None)
    got = dequantize_cuda(c_got, d_got)
    want = dequantize_ref(c_got, d_got)
    torch.cuda.synchronize()
    expect(bits_equal(torch, got, want),
           "dequantize is not bit-exact with its plain version")
    print(f"dequantize {tuple(x.shape)}: bit-exact")
    row("dequantize", 149, float((got - want).abs().max()),
        timer(lambda: dequantize_cuda(c_got, d_got)),
        timer(lambda: dequantize_ref(c_got, d_got)), 8 * n + 4, n,
        timer(lambda: torch.mul(c_got, d_got)))
    for rw in rows:
        print(f"  {rw['name']:25s} kernel {rw['ms']:.4f} ms  plain "
              f"{rw['plain_ms']:.4f} ms  library {rw['library_ms']}  "
              f"bound {rw['bound_ms']:.4f} ms ({rw['bound_by']})")
    return rows


def run_codec(torch) -> dict:
    """Phase 12, the per-leaf and per-tensor codec at full width, every
    comparison bit for bit and every call's launches held exactly:

    1. ``quantize_dequantize_per_node(payload, 16, packed=False)`` on the
       20-node mnist-cnn and cifar10-resnet18 student payloads
       (:func:`codec_payload`; ``rowabs`` + ``quantize_dequantize_rows``)
       against the packed node codec (``packed=True``) and the plain
       per-leaf math;
    2. on the mnist-cnn payload, ``4/16`` against the packed codec, and
       ``4/16+ef`` with a seeded non-zero residual against the packed EF
       codec on the same values as a student plane (reconstruction, new
       residual, ``seq``);
    3. the packed-tree API on one node's student (whole leaves: rows 3, 4
       and 12; rows 3 and 7) against ``core/quantization``, then per node
       on the stacked payload against the per-leaf math;
    4. the per-tensor API on every float leaf of that student and on the
       ResNet18 teacher's largest leaf against ``quantize_array``.

    The launch counts are set to 0 at the start and read at the end;
    returns them."""
    from repro_torch.core.quantization import (quantize_array,
                                               quantize_dequantize_tree)
    from repro_torch.core.round_ops import (dequantize_leaf,
                                            quantize_dequantize_per_node,
                                            quantize_leaf_per_node)
    from repro_torch.core.wire_state import CodecState
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.kernels.quantize import ops as Q
    from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.wirespec import WireSpec

    def launched(fn, want, what):
        before = launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launch_counts().items()
               if v != before[k]}
        expect(got == want, f"codec: {what} launched {got} != {want}")
        return out

    def same(a, b, what):
        la, lb = tree_leaves(a), tree_leaves(b)
        expect(len(la) == len(lb)
               and all(bits_equal(torch, x, y) for x, y in zip(la, lb)),
               f"codec: {what} is not bit-identical")

    def per_leaf(tree, bits):
        return tree_map(lambda x: dequantize_leaf(
            *quantize_leaf_per_node(x, bits)), tree)

    reset_launch_counts()
    per_leaf_kernels = {"rowabs": 1, "quantize_dequantize_rows": 1}
    for model, seed in (("mnist-cnn", 3), ("cifar10-resnet18", 5)):
        payload = codec_payload(torch, model, seed)
        t0 = time.time()
        got = launched(lambda: quantize_dequantize_per_node(
            payload, 16, packed=False), per_leaf_kernels,
            f"{model} packed=False")
        seconds = time.time() - t0
        same(got, launched(lambda: quantize_dequantize_per_node(payload, 16),
                           {"rowabs": 1, "quantize_rows": 1},
                           f"{model} packed"),
             f"{model}: packed=False against the packed codec")
        same(got, launched(lambda: per_leaf(payload, 16), {},
                           f"{model} per-leaf math"),
             f"{model}: packed=False against the per-leaf math")
        print(f"{model} payload ({len(tree_leaves(payload))} leaves x "
              f"{N_NODES} nodes): packed=False 16-bit bit-identical to the "
              f"packed codec and the per-leaf math ({seconds:.4f} s, host "
              f"clock)")
        if model != "mnist-cnn":
            continue
        spec = WireSpec.parse("4/16")
        same(launched(lambda: quantize_dequantize_per_node(
                 payload, spec=spec, packed=False), {},
                 "4/16 packed=False"),
             launched(lambda: quantize_dequantize_per_node(payload,
                                                           spec=spec),
                      {"rowabs": 1, "quantize_rows_mixed": 1},
                      "4/16 packed"),
             "4/16: packed=False against the packed codec")
        print("mnist-cnn 4/16: packed=False bit-identical to the packed "
              "codec")

        # 4/16+ef: the same values as a tree and as a student plane
        spec = WireSpec.parse("4/16+ef")
        gen = torch.Generator().manual_seed(6)
        student = payload["student"]
        res_s = tree_map(lambda x: (torch.randn(x.shape, generator=gen)
                                    * 1e-3).cuda(), student)
        res_p = (torch.randn(payload["protos"].shape, generator=gen)
                 * 1e-2).cuda()

        def stacked_plane(tree):
            planes = [plane_from_tree(tree_map(lambda x: x[i], tree))
                      for i in range(N_NODES)]
            return Plane(torch.stack([p.buf for p in planes]),
                         planes[0].meta)
        seq = torch.zeros(N_NODES, dtype=torch.int32, device="cuda")
        recv_t, new_t = launched(lambda: quantize_dequantize_per_node(
            payload, spec=spec, packed=False,
            state=CodecState({"protos": res_p, "student": res_s}, seq)),
            {}, "4/16+ef packed=False")
        recv_p, new_p = launched(lambda: quantize_dequantize_per_node(
            {"protos": payload["protos"], "student": stacked_plane(student)},
            spec=spec, state=CodecState(
                {"protos": res_p, "student": stacked_plane(res_s)}, seq)),
            {"rowabs_sum": 1, "quantize_rows_ef": 1}, "4/16+ef packed")
        same(recv_t, {"protos": recv_p["protos"],
                      "student": as_tree(recv_p["student"])},
             "4/16+ef: the reconstruction against the packed EF codec")
        same(new_t.residual,
             {"protos": new_p.residual["protos"],
              "student": as_tree(new_p.residual["student"])},
             "4/16+ef: the new residual against the packed EF codec")
        expect(new_t.seq.tolist() == new_p.seq.tolist() == [1] * N_NODES,
               f"4/16+ef: seq {new_t.seq.tolist()} / {new_p.seq.tolist()}")
        expect(float(new_t.residual["protos"].abs().max()) > 0,
               "4/16+ef: zero residual")
        print("mnist-cnn 4/16+ef (non-zero residual): packed=False "
              "bit-identical to the packed EF codec, reconstruction and "
              "new residual; seq advanced once")
        mnist = payload

    # the packed-tree API: one node's student whole-leaf, then per node
    one = tree_map(lambda x: x[0], mnist["student"])
    a = launched(lambda: Q.dequantize_tree_packed(
        Q.quantize_tree_packed(one, 16)),
        {"rowabs": 1, "quantize_rows": 1, "dequantize_rows": 1},
        "quantize_tree_packed + dequantize_tree_packed")
    b = launched(lambda: Q.quantize_dequantize_tree_packed(one, 16),
                 per_leaf_kernels, "quantize_dequantize_tree_packed")
    c = launched(lambda: quantize_dequantize_tree(one, 16), {},
                 "core quantize_dequantize_tree")
    same(a, b, "dequantize_tree_packed(quantize_tree_packed) against "
               "quantize_dequantize_tree_packed")
    same(a, c, "the packed tree against core quantize_dequantize_tree")
    a = launched(lambda: Q.dequantize_tree_packed(
        Q.quantize_tree_packed(mnist, 16, node_axis=True)),
        {"rowabs": 1, "quantize_rows": 1, "dequantize_rows": 1},
        "node_axis quantize + dequantize")
    b = launched(lambda: Q.quantize_dequantize_tree_packed(
        mnist, 16, node_axis=True), per_leaf_kernels,
        "node_axis quantize_dequantize_tree_packed")
    same(a, b, "node_axis: the two packed-tree routes")
    same(a, per_leaf(mnist, 16), "node_axis: the packed tree against the "
                                 "per-leaf math")
    print("packed-tree API: one node's student and the stacked payload "
          "bit-identical to core/quantization and the per-leaf math")

    # the per-tensor API
    leaves = [(str(i), x) for i, x in enumerate(tree_leaves(one))]
    for name, x in leaves + [("teacher", teacher_leaf(torch))]:
        codes, delta = launched(lambda: Q.quantize(x, 16),
                                {"fused_quantize": 1}, f"quantize {name}")
        w_codes, w_delta = quantize_array(x, 16)
        expect(bits_equal(torch, codes, w_codes.to(torch.int32))
               and bits_equal(torch, delta, w_delta),
               f"quantize of leaf {name} {tuple(x.shape)} disagrees with "
               f"quantize_array")
        rt = launched(lambda: Q.quantize_dequantize(x, 16),
                      {"fused_quantize_dequantize": 1},
                      f"quantize_dequantize {name}")
        expect(bits_equal(torch, rt, codes.to(torch.float32) * delta),
               f"quantize_dequantize of leaf {name} is not codes·Δ")
        expect(bits_equal(torch, launched(lambda: Q.dequantize(codes, delta),
                                          {"dequantize": 1},
                                          f"dequantize {name}"), rt),
               f"dequantize of leaf {name} is not quantize_dequantize")
    print(f"per-tensor API: {len(leaves)} student leaves and the teacher's "
          f"[3, 3, 512, 512] leaf bit-identical to quantize_array")
    counts = launch_counts()
    print(f"launches in the codec phase: {counts}")
    return counts


# proto_dist's relative tolerance: JAX's own for fp32 (test_kernels.py).
# It holds for bf16 inputs too (JAX allows 5e-2 there): the kernel and
# its plain versions cast the same bf16 values to fp32 first.
PD_RTOL = 1e-4
# proto_dist in phase 3: (what, N, P, C); each in fp32 and bf16, the
# first at fp32 is the kernel's row
PD_CASES = (("mnist-cnn Eq. 5", 640, 128, 10),
            ("ResNet8 student", 640, 256, 10),
            ("cifar100 classes", 640, 256, 100),
            ("ragged", 1001, 200, 37))
# 256 rows of logits at llama4-scout's vocabulary
LM_ROWS, LM_VOCAB = 256, 202048
# kd_loss in phase 3: (what, rows, V, dtype, T); the first is the row
KD_CASES = (("mnist-cnn epoch", 320, 10, "float32", 3.0),
            ("mnist-cnn epoch", 320, 10, "float32", 1.0),
            ("llama4-scout vocab", LM_ROWS, LM_VOCAB, "bfloat16", 1.0),
            ("llama4-scout vocab", LM_ROWS, LM_VOCAB, "bfloat16", 3.0),
            ("llama4-scout vocab", LM_ROWS, LM_VOCAB, "float32", 1.0),
            ("llama4-scout vocab", LM_ROWS, LM_VOCAB, "float32", 3.0),
            ("ragged", 250, 50280, "bfloat16", 1.0),
            ("ragged", 250, 50280, "bfloat16", 3.0))
# Claim 4 in phase 13: model -> local epochs of make_fedavg_step
CLAIM4_EPOCHS = {"mnist-cnn": 2, "cifar10-resnet18": 1}
KD_TEMPERATURES = (3.0, 1.0)       # FederationConfig.kd_temperature, and 1


def kd_tol(ymax: float, temperature: float) -> float:
    """|kernel - plain| bound of a per-row KD loss: the finish subtracts
    terms of the size of max|y|/T, then multiplies by T^2."""
    return 1e-5 * temperature * (temperature + ymax)


def pd_atol(x, protos) -> float:
    """Absolute d2 tolerance of ``proto_dist``: the expansion cancels
    terms of the size of max ||x||^2 + max ||p||^2 (real features lie
    close together: d2 can be 1e-4 of them), so 1e-5 of that."""
    return 1e-5 * (float(x.float().square().sum(-1).max())
                   + float(protos.float().square().sum(-1).max()))


def pd_close(torch, got, plain, x, protos):
    """Kernel against a plain version: ``PD_RTOL`` and ``pd_atol``.
    Returns ``(ok, the elementwise tolerance's largest value)``."""
    atol = pd_atol(x, protos)
    ok = torch.allclose(got, plain, rtol=PD_RTOL, atol=atol)
    return ok, atol + PD_RTOL * float(plain.abs().max())


def clear_of_ties(torch, d2, tol: float, mask=None):
    """Rows whose two smallest (unmasked) distances differ by more than
    twice the d2 tolerance: there the argmin cannot flip on rounding."""
    if mask is not None:
        d2 = torch.where(mask[None, :] > 0, d2, torch.inf)
    top2 = torch.topk(d2, 2, dim=-1, largest=False).values
    return (top2[:, 1] - top2[:, 0]) > 2 * tol


def check_proto_kd_kernels(torch, timer):
    """Phase 3, rows 18 and 17: ``proto_dist`` against its plain versions
    (the expansion and the direct oracle) within :func:`pd_close`, and
    its argmin away from near-ties, at Eq. 5's shapes in fp32 and bf16;
    ``kd_loss`` per row against ``kd_loss_rows_ref`` within
    :func:`kd_tol`, at one node's epoch of mnist-cnn logits, at
    llama4-scout's vocabulary and at a ragged shape, T = 1 and 3."""
    from repro_torch.kernels.kd_loss.kd_loss import kd_loss_rows_cuda
    from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref
    from repro_torch.kernels.proto_dist.proto_dist import proto_dist_cuda
    from repro_torch.kernels.proto_dist.ref import (proto_dist_expand,
                                                    proto_dist_ref)

    gen = torch.Generator(device="cuda").manual_seed(17)
    cases = []
    for what, n, p_dim, c in PD_CASES:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn((n, p_dim), generator=gen, device="cuda").to(dt)
            protos = torch.randn((c, p_dim), generator=gen,
                                 device="cuda").to(dt)
            got = proto_dist_cuda(x, protos)
            want = proto_dist_expand(x, protos)
            direct = proto_dist_ref(x, protos)
            torch.cuda.synchronize()
            for plain, name in ((want, "expansion"), (direct, "oracle")):
                ok, tol = pd_close(torch, got, plain, x, protos)
                expect(ok, f"proto_dist {what} {dtype}: beyond tolerance "
                           f"{tol:.3e} of the {name}")
            clear = clear_of_ties(torch, direct, tol)
            expect(torch.equal(got.argmin(-1)[clear],
                               direct.argmin(-1)[clear]),
                   f"proto_dist {what} {dtype}: argmin differs away from "
                   f"ties")
            err = float((got - want).abs().max())
            isz = x.element_size()
            b_ms, b_by = bound(isz * (n + c) * p_dim + 4 * n * c,
                               2 * n * c * p_dim + 2 * (n + c) * p_dim
                               + 4 * n * c)
            # library yardstick: torch.cdist returns the root ||x - p||,
            # not its square; it takes no bf16, so bf16 inputs are timed
            # on fp32 copies made outside the timed region
            x32, p32 = x.float(), protos.float()
            cases.append(dict(
                shape=f"[{n}, {p_dim}] x [{c}, {p_dim}]", dtype=dtype,
                max_abs_err=err, max_abs_err_oracle=float(
                    (got - direct).abs().max()),
                rows_near_ties=int((~clear).sum()),
                ms=timer(lambda: proto_dist_cuda(x, protos)),
                plain_ms=timer(lambda: proto_dist_expand(x, protos)),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timer(lambda: torch.cdist(x32, p32))))
            print(f"proto_dist {what} {cases[-1]['shape']} {dtype}: max "
                  f"|kernel - expansion| {err:.3e}, - oracle "
                  f"{cases[-1]['max_abs_err_oracle']:.3e} (tol {tol:.3e}); "
                  f"argmin equal on {int(clear.sum())} rows, "
                  f"{cases[-1]['rows_near_ties']} near ties")
    rows = [dict(name="proto_dist", route="cuda",
                 source="src/repro_torch/csrc/proto_dist.cu",
                 replaces="src/repro/kernels/proto_dist/proto_dist.py:31",
                 **cases[0], cases=cases)]

    cases = []
    for what, r, v, dtype, temp in KD_CASES:
        dt = getattr(torch, dtype)
        ys = (torch.randn((r, v), generator=gen, device="cuda") * 3)
        yt = (ys + torch.randn((r, v), generator=gen, device="cuda")).to(dt)
        ys = ys.to(dt)
        got = kd_loss_rows_cuda(ys, yt, temp)
        want = kd_loss_rows_ref(ys, yt, temp)
        torch.cuda.synchronize()
        ymax = max(float(ys.float().abs().max()), float(yt.float().abs().max()))
        tol = kd_tol(ymax, temp)
        err = float((got - want).abs().max())
        expect(err <= tol and bool(torch.isfinite(got).all()),
               f"kd_loss {what} [{r}, {v}] {dtype} T={temp}: max error "
               f"{err:.3e} > {tol:.3e}")
        isz = ys.element_size()
        b_ms, b_by = bound(2 * isz * r * v + 4 * r, 11 * r * v)
        # no library yardstick: no single PyTorch call takes raw logits to
        # the KL (F.kl_div needs both log-softmaxes made first)
        cases.append(dict(
            shape=f"[{r}, {v}]", dtype=dtype, temperature=temp,
            max_abs_err=err, tol=tol,
            ms=timer(lambda: kd_loss_rows_cuda(ys, yt, temp)),
            plain_ms=timer(lambda: kd_loss_rows_ref(ys, yt, temp)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        print(f"kd_loss {what} [{r}, {v}] {dtype} T={temp}: max |kernel - "
              f"plain| {err:.3e} (tol {tol:.3e}, max|y| {ymax:.3g}), mean "
              f"{float(want.mean()):.4f}")
        del ys, yt, got, want
    # identical logits: KL 0 within the tolerance
    y = torch.randn((LM_ROWS, LM_VOCAB), generator=gen, device="cuda").to(
        torch.bfloat16)
    for temp in KD_TEMPERATURES:
        got = kd_loss_rows_cuda(y, y, temp)
        tol = kd_tol(float(y.float().abs().max()), temp)
        expect(float(got.abs().max()) <= tol,
               f"kd_loss of identical logits (T={temp}) "
               f"{float(got.abs().max()):.3e} > {tol:.3e}")
    print(f"kd_loss identical logits [{LM_ROWS}, {LM_VOCAB}] bf16: |KL| <= "
          f"tolerance at T = {KD_TEMPERATURES}")
    del y
    rows.append(dict(name="kd_loss", route="cuda",
                     source="src/repro_torch/csrc/kd_loss.cu",
                     replaces="src/repro/kernels/kd_loss/kd_loss.py:72",
                     **{k: v for k, v in cases[0].items()
                        if k not in ("temperature", "tol")}, cases=cases))
    for row in rows:
        for cs in row["cases"]:
            print(f"  {row['name']:10s} {cs['shape']:24s} {cs['dtype']:8s} "
                  f"{'T=%g ' % cs['temperature'] if 'temperature' in cs else ''}"
                  f"kernel {cs['ms']:.4f} ms  plain {cs['plain_ms']:.4f} ms"
                  f"  library {cs['library_ms']}  bound "
                  f"{cs['bound_ms']:.4f} ms ({cs['bound_by']})")
    return rows


def run_proto_infer(torch, inputs) -> dict:
    """Phase 13, ``proto-infer``: the paper's Claim 4 (nearest-prototype
    inference, ``tests/test_system.py``) at full width on the card, and
    the ProFe pair's KD term through the ``kd_loss`` kernel.

    1. For each model of ``CLAIM4_EPOCHS`` (mnist-cnn: teacher widths
       (32, 64), proto_dim 128; cifar10-resnet18: the ResNet18, proto_dim
       256): node 0's 320 images of the paths' data, ``make_fedavg_step``
       under per-leaf adamw with ``TrainConfig`` defaults for its local
       epochs, ``compute_local_prototypes`` (Eq. 3 through
       ``proto_accum``), the forward of the 640-image test split and
       ``nearest_prototype_predict`` (Eq. 5 through ``proto_dist``).  The
       kernel's distances on those features are then held to the plain
       versions, and its predictions away from near-ties; the Eq. 5
       accuracy is printed, with no bar.
    2. The main path's node-0 initial teacher and student
       (``init_node_state``, seed ``fed.seed * 1000``) forward one local
       epoch; ``kernels/kd_loss/ops.kd_loss`` on those ``[320, 10]``
       logits is held to ``core/distillation.kd_loss`` at T = 3 and 1.

    Each driven part sets the launch counts to 0 just before and reads
    them just after, holding them exactly to its calls (the comparisons'
    launches come after and are not counted).  Returns the summed
    counts."""
    from repro_torch.core import distillation as D
    from repro_torch.core.baselines import make_fedavg_step
    from repro_torch.core.profe import (NodeState, compute_local_prototypes,
                                        init_node_state)
    from repro_torch.core.prototypes import nearest_prototype_predict
    from repro_torch.data import batch_index_lists
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.proto_dist.proto_dist import proto_dist_cuda
    from repro_torch.kernels.proto_dist.ref import (proto_dist_expand,
                                                    proto_dist_ref)
    from repro_torch.models import derive_student, forward, init_params
    from repro_torch.optim import make_optimizer, make_plane_optimizer
    from repro_torch.optim.plane import as_tree
    from repro_torch.tree import tree_map

    total: dict = {}

    def driven(fn, want, what):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        expect(got == want, f"proto-infer {what}: launched {got} != {want}")
        for k, v in launch_counts().items():
            total[k] = total.get(k, 0) + v
        return out

    def on_card(data, idx=None):
        sel = slice(None) if idx is None else torch.as_tensor(idx)
        return {k: torch.as_tensor(v)[sel].cuda() for k, v in data.items()}

    for model, epochs in CLAIM4_EPOCHS.items():
        cfg, fed, train, node_data, test_d = inputs[model]
        node, n, bsz = node_data[0], len(node_data[0]["label"]), \
            train.batch_size
        params = tree_map(lambda x: x.cuda(), init_params(
            cfg, torch.Generator().manual_seed(fed.seed)))
        opt = make_optimizer(train.optimizer, train.learning_rate,
                             weight_decay=train.weight_decay,
                             momentum=train.momentum)
        ncls = cfg.num_classes
        state = NodeState(
            student=params, teacher={}, opt_s=opt.init(params), opt_t={},
            global_protos=torch.zeros((ncls, cfg.proto_dim), device="cuda"),
            proto_mask=torch.zeros((ncls,), device="cuda"),
            round_idx=torch.zeros((), dtype=torch.int32, device="cuda"))
        step = make_fedavg_step(cfg, opt, grad_clip=train.grad_clip)
        train_batches = [on_card(node, i) for i in batch_index_lists(
            n, bsz, fed.seed, epochs=epochs)]
        proto_batches = [on_card(node, i)
                         for i in batch_index_lists(n, bsz, fed.seed + 1)]
        test = on_card(test_d)

        def claim4():
            nonlocal state
            losses = []
            for b in train_batches:
                state, m = step(state, b)
                losses.append(m["loss_s"])
            protos, counts = compute_local_prototypes(
                cfg, state.student, proto_batches, ncls)
            with torch.no_grad():
                f1 = forward(cfg, state.student, {"image": test["image"]}).f1
            mask = (counts > 0).float()
            return (torch.stack(losses), protos, counts, mask, f1,
                    nearest_prototype_predict(f1, protos, mask))

        t0 = time.time()
        losses, protos, counts, mask, f1, preds = driven(
            claim4, {"proto_accum": len(proto_batches), "proto_dist": 1},
            f"{model} Claim 4")
        seconds = time.time() - t0
        expect(bool(torch.isfinite(losses).all())
               and bool(torch.isfinite(protos).all())
               and int(counts.sum()) == len(proto_batches) * bsz,
               f"{model} Claim 4: losses, prototypes or counts wrong")
        # the comparisons: kernel distances on the same features against
        # the plain versions, and the predictions away from near-ties
        got = proto_dist_cuda(f1.contiguous(), protos.contiguous())
        want = proto_dist_expand(f1, protos)
        direct = proto_dist_ref(f1, protos)
        torch.cuda.synchronize()
        for plain, name in ((want, "expansion"), (direct, "oracle")):
            ok, tol = pd_close(torch, got, plain, f1, protos)
            expect(ok, f"{model} Claim 4: proto_dist beyond tolerance "
                       f"{tol:.3e} of the {name}")
        d2 = torch.where(mask[None, :] > 0, direct, torch.inf)
        clear = clear_of_ties(torch, direct, tol, mask)
        expect(torch.equal(preds[clear], d2.argmin(-1)[clear]),
               f"{model} Claim 4: predictions differ from the plain argmin "
               f"away from ties")
        acc = float((preds == test["label"]).float().mean())
        print(f"{model} Claim 4: {epochs} epoch(s) x {len(train_batches) // epochs} "
              f"steps, loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f};"
              f" Eq. 3 over {int(counts.sum())} images; Eq. 5 on "
              f"{len(preds)} test images: accuracy {acc:.4f}; d2 "
              f"[{f1.shape[0]}, {protos.shape[0]}] P={protos.shape[1]} max "
              f"|kernel - expansion| {float((got - want).abs().max()):.3e} "
              f"(tol {tol:.3e}, d2 in [{float(direct.min()):.4g}, "
              f"{float(direct.max()):.4g}]), predictions equal on "
              f"{int(clear.sum())} rows, "
              f"{int((~clear).sum())} near ties ({seconds:.2f} s, host "
              f"clock)")

    # the ProFe pair's KD term on node 0's initial teacher and student
    cfg, fed, train, node_data, _ = inputs["mnist-cnn"]
    scfg = derive_student(cfg)
    opt_t = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay,
                           momentum=train.momentum)
    opt_s = make_plane_optimizer(train.optimizer, train.learning_rate,
                                 weight_decay=train.weight_decay,
                                 momentum=train.momentum,
                                 grad_clip=train.grad_clip)
    st = init_node_state(cfg, scfg, torch.Generator().manual_seed(
        fed.seed * 1000), opt_s, opt_t, cfg.num_classes, device="cuda")
    n = len(node_data[0]["label"])
    with torch.no_grad():
        epoch = [on_card(node_data[0], i)
                 for i in batch_index_lists(n, train.batch_size, fed.seed)]
        yt = torch.cat([forward(cfg, st.teacher, b).logits for b in epoch])
        ys = torch.cat([forward(scfg, as_tree(st.student), b).logits
                        for b in epoch])
    got = driven(lambda: [kd_ops.kd_loss(ys, yt, t) for t in KD_TEMPERATURES],
                 {"kd_loss": len(KD_TEMPERATURES)}, "ProFe KD term")
    ymax = max(float(ys.abs().max()), float(yt.abs().max()))
    for t, g in zip(KD_TEMPERATURES, got):
        want = D.kd_loss(ys, yt, t)
        err = abs(float(g) - float(want))
        expect(err <= kd_tol(ymax, t),
               f"ProFe KD term T={t}: kernel {float(g)!r} vs "
               f"core/distillation {float(want)!r}")
        print(f"ProFe KD term {tuple(ys.shape)} T={t}: kernel {float(g):.6f}"
              f", core/distillation.kd_loss {float(want):.6f}, |diff| "
              f"{err:.3e} (tol {kd_tol(ymax, t):.3e})")
    print(f"launches in the proto-infer phase: {total}")
    return total


def path_inputs(model: str):
    """A model's paths' configuration and data: the config at full width,
    20 nodes on a full graph, 2 rounds of 1 local epoch, ``TrainConfig``
    defaults, 320 images a node (10 steps a round)."""
    from repro_torch.config import FederationConfig, TrainConfig, get_config
    from repro_torch.data import (make_image_dataset, partition,
                                  train_test_split)

    data = make_image_dataset(0, 7040, IMAGE_SHAPE[model], 10)
    train_d, test_d = train_test_split(data, 1 / 11, 0)
    parts = partition(train_d["label"], N_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed = FederationConfig(num_nodes=N_NODES, topology="full", rounds=ROUNDS,
                           local_epochs=1)
    return get_config(model), fed, TrainConfig(), node_data, test_d


def run_path(torch, inputs, name: str):
    """Phases 4-9: ProFe at full width through ``run_federation`` on the
    path ``name`` of ``PATHS`` (its model's ``inputs``, its optimizer,
    wire and rounds), with the launch counts set to 0 just before and
    read just after.  Checks finite F1 every round, the launches (every
    count exactly as the optimizer and the wire spec imply, each kernel
    of the path at least once) and the wire bytes against the JAX
    package's.  With ``+ef`` the final ``CodecState`` must have advanced
    ``seq`` once a round and carry a residual that is finite, non-zero,
    and zero on the plane's padding lanes.  On the adapter wire the last
    round's shared factors must be finite and non-zero.  Returns the
    launch counts."""
    import dataclasses

    from repro_torch.core.federation import run_federation
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.wirespec import WireSpec

    _, optimizer, wire, rounds, expected_bytes = PATHS[name]
    cfg, fed, train, node_data, test_d = inputs
    spec = WireSpec.parse(wire)
    extra = PATH_FED.get(name, {})
    fed = dataclasses.replace(fed, rounds=rounds, **wire_fields(spec),
                              **extra)
    train = dataclasses.replace(train, optimizer=optimizer)
    per_node = len(node_data[0]["label"])
    print(f"{cfg.name}: {N_NODES} nodes x {per_node} images, batch "
          f"{train.batch_size}, {optimizer}, wire {spec.describe()} "
          f"{extra or ''}")
    steps = rounds * (per_node // train.batch_size)
    ef, uniform = spec.error_feedback, spec.uniform_bits is not None
    # one plane sweep per training step, of the path's optimizer only
    launches = {k: steps if opt == optimizer else 0
                for opt, k in OPT_KERNEL.items()}
    launches.update({
        "proto_accum": steps,       # one per Eq. 3 proto batch
        # one share codec a round: amax rows, then the codes
        "rowabs": 0 if ef else rounds,
        "quantize_rows": rounds if uniform and not ef else 0,
        "quantize_rows_mixed": 0 if uniform or ef else rounds,
        "rowabs_sum": rounds if ef else 0,
        "quantize_rows_ef": rounds if ef else 0,
        # one merge launch per matrix leaf a round
        "lowrank_apply": ADAPTER_LEAVES * rounds if extra else 0,
        # the stacked engine mixes with tensordot; only the mesh exchange
        # launches the fused mix
        "mix_packed": 0})
    launches.update({k: 0 for k in CODEC_KERNELS + PROTO_INFER_KERNELS})

    reset_launch_counts()
    res = run_federation(cfg, fed, train, node_data, test_d, verbose=True)
    counts = launch_counts()

    print(f"per-round F1: {res.f1_per_round}")
    print(f"per-round seconds: {res.extras['round_times_s']}")
    print(f"avg_sent_gb: {res.extras['avg_sent_gb']!r}  "
          f"wire_bytes_packed_per_copy: "
          f"{res.extras['wire_bytes_packed_per_copy']}  "
          f"wire_bytes_per_copy: {res.extras['wire_bytes_per_copy']}")
    print(f"launches on the {name} path: {counts}")
    expect(len(res.f1_per_round) == rounds
           and all(math.isfinite(f) for f in res.f1_per_round),
           f"expected {rounds} finite F1 values, got {res.f1_per_round}")
    expect(set(counts) == set(launches),
           f"kernels {sorted(counts)} != {sorted(launches)}")
    for kernel, want in launches.items():
        expect(want == 0 or counts[kernel] > 0,
               f"{kernel} never launched on the {name} path")
        expect(counts[kernel] == want,
               f"{name} path: {kernel} launched {counts[kernel]} != {want}")
    for key, want in zip(("avg_sent_gb", "wire_bytes_packed_per_copy",
                          "wire_bytes_per_copy"), expected_bytes):
        expect(res.extras[key] == want,
               f"{name} path: {key} {res.extras[key]!r} != the JAX "
               f"package's {want!r}")

    ws = res.extras.get("wire_state")
    expect((ws is not None) == ef, f"{name}: wire_state is {ws!r}")
    if ef:
        seq = ws.seq.tolist()
        expect(seq == [rounds] * N_NODES, f"{name}: seq {seq} != {rounds}")
        protos, plane = ws.residual["protos"], ws.residual["student"]
        real = torch.zeros(plane.buf.shape[1:], dtype=torch.bool)
        for _, _, shape, row, r_leaf in plane.meta.recipe:
            real[row:row + r_leaf].view(-1)[:math.prod(shape)] = True
        res_s = plane.buf.cpu()
        for part in (protos, plane.buf):
            expect(bool(torch.isfinite(part).all())
                   and float(part.abs().max()) > 0,
                   f"{name}: residual not finite and non-zero")
        expect(not bool(res_s[:, ~real].any()),
               f"{name}: residual non-zero on padding lanes")
        print(f"residual after {rounds} rounds: seq {seq[0]} on all "
              f"{N_NODES} nodes, max |student| "
              f"{float(res_s.abs().max()):.4g}, max |protos| "
              f"{float(protos.abs().max()):.4g}, padding lanes zero")
    shared = res.extras.get("adapter_factors")
    expect((shared is not None) == bool(extra),
           f"{name}: adapter_factors is {shared!r}")
    if extra:
        expect(len(shared) == ADAPTER_LEAVES,
               f"{name}: factored leaves {sorted(shared)}")
        for leaf, f in sorted(shared.items()):
            ba = f["B"] @ f["A"]
            expect(all(bool(torch.isfinite(x).all()) for x in (f["A"], f["B"]))
                   and float(ba.abs().max()) > 0,
                   f"{name}: the last round's factors of {leaf} are not "
                   f"finite and non-zero")
            print(f"last round's factors of {leaf}: A {tuple(f['A'].shape)}, "
                  f"B {tuple(f['B'].shape)}, max |B@A| "
                  f"{float(ba.abs().max()):.4g}")
    return counts


def check_mix_packed(torch, timer, student_cfg):
    """Phase 3, the mesh exchange's fused mix: ``mix_packed`` against its
    plain version, bit for bit, on real mnist-cnn wire codes (R = 416
    rows of 512): at the ring path's shape ``own [1, R, 512]`` with 2
    senders (timed), at ``own [8, R, 512]`` with 8 senders (one rank
    holding eight nodes; timed), with fp32 "codes" (raw buffers at unit
    delta) at that shape, and in the accumulate form (the accumulator in
    ``own`` at weight one, one sender: a pipelined ring step)."""
    from repro_torch.kernels.quantize.ops import (_node_row_deltas,
                                                  mix_packed_init,
                                                  quantize_packed_buffer)
    from repro_torch.kernels.quantize.quantize import mix_packed_cuda
    from repro_torch.kernels.quantize.ref import mix_packed_ref

    gen = torch.Generator().manual_seed(3)
    buf, seg_ids, meta, _, _ = payload_buffer(torch, gen, student_cfg)
    codes, scales = quantize_packed_buffer(buf, seg_ids, meta[1],
                                           seg_bits=meta[3])
    ids = torch.as_tensor(seg_ids, dtype=torch.int64, device="cuda")
    codes = codes.to(torch.int32)
    row_delta = scales[:, ids].contiguous()
    rows = {}

    def weights(m, s):
        w = torch.rand((m, s + 1), generator=gen).cuda()
        w = w / w.sum(dim=1, keepdim=True)
        return w[:, 0].contiguous(), w[:, 1:].contiguous()

    def case(name, own, cds, rd, w_self, w_rows, timed):
        got = mix_packed_cuda(own, cds, rd, w_self, w_rows)
        want = mix_packed_ref(own, cds, rd, w_self, w_rows)
        torch.cuda.synchronize()
        ulps = ulp_diff(torch, got, want)
        expect(ulps == 0, f"mix_packed ({name}) is not bit-exact with its "
                          f"plain version: {ulps} ulp")
        print(f"mix_packed {name}: own {tuple(own.shape)} codes "
              f"{tuple(cds.shape)} {cds.dtype}: bit-exact")
        if not timed:
            return
        m, r, c = own.shape
        s = cds.shape[0]
        ms = timer(lambda: mix_packed_cuda(own, cds, rd, w_self, w_rows))
        plain_ms = timer(lambda: mix_packed_ref(own, cds, rd, w_self,
                                                w_rows))
        # each input read once, the output written once; a multiply for
        # the self term, then per sender the dequantize, the weight and
        # the add
        b_ms, b_by = bound(4 * (2 * own.numel() + cds.numel() + rd.numel()
                                + w_self.numel() + w_rows.numel()),
                           m * r * c * (1 + 3 * s))
        # no one PyTorch call computes the function: an einsum over the
        # senders needs the codes dequantized first, and the self term
        # added after
        rows[name] = dict(max_abs_err=float((got - want).abs().max()),
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)

    w_self, w_rows = weights(1, 2)
    case("ring", buf[:1].contiguous(), codes[1:3].contiguous(),
         row_delta[1:3].contiguous(), w_self, w_rows, True)
    w_self, w_rows = weights(8, 8)
    own8 = buf[:8].contiguous()
    case("8x8", own8, codes[8:16].contiguous(),
         row_delta[8:16].contiguous(), w_self, w_rows, True)
    case("8x8-fp32", own8, buf[8:16].contiguous(),
         torch.ones((8, buf.shape[1]), device="cuda"), w_self, w_rows, False)
    acc = mix_packed_init(buf[:1], w_self[:1]).contiguous()
    case("accumulate", acc, codes[1:2].contiguous(),
         row_delta[1:2].contiguous(), torch.ones(1, device="cuda"),
         w_rows[:1, :1].contiguous(), False)
    row = dict(name="mix_packed", route="cuda",
               source="src/repro_torch/csrc/quantize.cu",
               replaces="src/repro/kernels/quantize/quantize.py:374",
               **rows["ring"])
    row["m8s8"] = rows["8x8"]
    print(f"  {'mix_packed':19s} kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  library None  bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); 8x8 "
          f"{rows['8x8']['ms']:.4f} / {rows['8x8']['plain_ms']:.4f} ms, "
          f"bound {rows['8x8']['bound_ms']:.4f} ({rows['8x8']['bound_by']})")
    return [row]


def mesh_inputs(n_images: int):
    """The mesh paths' configuration and data: mnist-cnn at full width,
    ``TrainConfig`` defaults, ``make_image_dataset(0, n_images, (28, 28,
    1), 10)`` with a 1/11 test split, iid over ``MESH_NODES`` nodes."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import (make_image_dataset, partition,
                                  train_test_split)

    data = make_image_dataset(0, n_images, IMAGE_SHAPE["mnist-cnn"], 10)
    train_d, _ = train_test_split(data, 1 / 11, 0)
    parts = partition(train_d["label"], MESH_NODES, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    return get_config("mnist-cnn"), TrainConfig(), node_data


def mesh_federation_parts(torch, cfg, train, name: str, device):
    """``(fed, wire, train_phase, node states maker)`` of the mesh path
    ``name``: the stacked engine's own wiring for ``MESH_NODES`` nodes."""
    import dataclasses

    from repro_torch.config import FederationConfig
    from repro_torch.core import federation as F
    from repro_torch.core.profe import init_node_state, stack_states
    from repro_torch.core.wire_state import init_codec_state
    from repro_torch.models import derive_student
    from repro_torch.optim import make_optimizer, make_plane_optimizer
    from repro_torch.wirespec import WireSpec

    topo, _, wire, _, rounds, _, _ = MESH_PATHS[name]
    spec = WireSpec.parse(wire)
    fed = dataclasses.replace(
        FederationConfig(num_nodes=MESH_NODES, topology=topo, rounds=rounds,
                         local_epochs=1), **wire_fields(spec))
    student_cfg = derive_student(cfg)
    opt_t = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay,
                           momentum=train.momentum)
    opt_s = make_plane_optimizer(train.optimizer, train.learning_rate,
                                 weight_decay=train.weight_decay,
                                 momentum=train.momentum,
                                 grad_clip=train.grad_clip)
    step, _, _, wire_spec, _ = F._algo_wiring("profe", cfg, student_cfg, fed,
                                              train, opt_s, opt_t)
    ncls = cfg.num_classes
    parts = F._make_round_parts(step, student_cfg, ncls, bits=wire_spec)

    def states(nodes):
        """The stacked initial state of ``nodes`` (node i seeded
        ``seed * 1000 + i``, as ``run_federation`` seeds it)."""
        st = stack_states([init_node_state(
            cfg, student_cfg,
            torch.Generator().manual_seed(fed.seed * 1000 + i), opt_s,
            opt_t, ncls, device=device) for i in nodes])
        if spec.error_feedback:
            st = st._replace(wire_state=init_codec_state(
                {"protos": torch.zeros((len(nodes), ncls,
                                        student_cfg.proto_dim),
                                       device=device),
                 "student": st.student}, n_nodes=len(nodes)))
        return st

    return fed, wire_spec, parts, states


def train_nodes(fed, train, train_phase, state, node_data, nodes, rnd: int,
                device):
    """One round's local training of ``nodes`` (their data, batch seeds
    and proto stream as ``run_federation`` stages them for those nodes)
    -> ``(state, protos, counts)``."""
    from repro_torch.core import federation as F
    from repro_torch.core.distillation import teacher_active

    data = [node_data[i] for i in nodes]
    staged = F._stack_round_batches(
        data, train.batch_size, [fed.seed + rnd * 997 + i for i in nodes],
        fed.local_epochs)
    proto_staged = F._stack_round_batches(
        data, train.batch_size, [fed.seed + rnd] * len(nodes), 1)
    xb, valid = F._to_device(staged, device)
    pxb, pvalid = F._to_device(proto_staged, device)
    return train_phase(state, xb, valid, pxb, pvalid,
                       teacher_active(fed.alpha_s, fed.alpha_limit, rnd),
                       all_valid=True)


def mesh_rank(rank: int, world: int, init: str, out_dir: str, device: str,
              n_images: int) -> None:
    """Phase 10 on one spawned rank: its node through every mesh path
    (train, then the mesh round, each round), with its own checks; the
    report goes to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import mesh_federation as M
    from repro_torch.core.profe import resolve_device
    from repro_torch.core.topology import make_schedule
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        cfg, train, node_data = mesh_inputs(n_images)
        sizes = torch.tensor([len(d["label"]) for d in node_data],
                             dtype=torch.float32, device=dev)
        report = {}
        for name, (topo, exchange, _, overlap, rounds, want_bytes,
                   mix_launches) in MESH_PATHS.items():
            fed, spec, parts, states = mesh_federation_parts(
                torch, cfg, train, name, dev)
            train_phase = parts[0]
            adj = (None if topo == "full"
                   else make_schedule(MESH_NODES, topo).adjacency_at(0))
            round_fn = M.make_profe_round(adjacency=adj, exchange=exchange,
                                          spec=spec, overlap=overlap)
            state = states([rank])
            ef = spec.error_feedback
            steps = rounds * (len(node_data[rank]["label"])
                              // train.batch_size)
            t0 = time.time()
            sent, round_s = [], []
            reset_launch_counts()
            for rnd in range(rounds):
                state, protos, counts = train_nodes(
                    fed, train, train_phase, state, node_data, [rank], rnd,
                    dev)
                before = M.COLLECTIVE_BYTES.count
                t_round = time.time()
                out = round_fn(state.student, protos, counts, sizes,
                               *([state.wire_state] if ef else []))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                round_s.append(time.time() - t_round)
                sent.append(M.COLLECTIVE_BYTES.count - before)
                with torch.no_grad():
                    state.student.buf.copy_(out[0].buf)
                gp, mask = ((out[1], out[2]) if adj is not None
                            else (out[1][None], out[2][None]))
                state = state._replace(global_protos=gp, proto_mask=mask,
                                       wire_state=out[3] if ef else None)
                for what, t in (("prototypes", gp), ("student",
                                                     state.student.buf)):
                    expect(bool(torch.isfinite(t).all()),
                           f"{name} rank {rank} round {rnd}: {what} not "
                           f"finite")
                expect(float(mask.sum()) > 0,
                       f"{name} rank {rank} round {rnd}: empty mask")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            counts = launch_counts()
            want = {k: 0 for k in counts}
            want.update(adamw_update=steps, proto_accum=steps,
                        mix_packed=mix_launches * rounds)
            want.update({"rowabs_sum": rounds, "quantize_rows_ef": rounds}
                        if ef else {"rowabs": rounds,
                                    "quantize_rows": rounds})
            for kernel, n in want.items():
                expect(counts[kernel] == n,
                       f"{name} rank {rank}: {kernel} launched "
                       f"{counts[kernel]} != {n}")
            expect(sent == [want_bytes] * rounds,
                   f"{name} rank {rank}: bytes handed to collectives "
                   f"{sent} != {want_bytes} a round")
            if ef:
                expect(state.wire_state.seq.tolist() == [rounds],
                       f"{name} rank {rank}: seq "
                       f"{state.wire_state.seq.tolist()}")
            report[name] = dict(
                launches=counts, bytes_per_round=sent,
                seconds=time.time() - t0, mesh_round_s=round_s,
                student_abs_max=float(state.student.buf.detach().abs().max()),
                mask=state.proto_mask.tolist())
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run_mesh(torch, device: str = "cuda", n_images: int = 7040,
             rank_fn=mesh_rank) -> dict:
    """Phase 10: spawn ``MESH_NODES`` ranks (``spawn`` start method, a
    ``file://`` store in a temporary directory), every mesh path in the
    one spawn; a failure on any rank fails the phase, and ranks still
    running at ``MESH_DEADLINE_S`` are killed.  Returns each path's
    launches summed over the ranks."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            rank_fn, args=(MESH_NODES, f"file://{tmp}/store", tmp, device,
                           n_images),
            nprocs=MESH_NODES, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_DEADLINE_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                expect(time.monotonic() < deadline,
                       f"mesh ranks still running after {MESH_DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        reports = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                   for r in range(MESH_NODES)]
    totals = {}
    for name in MESH_PATHS:
        per = [rep[name] for rep in reports]
        totals[name] = {k: sum(p["launches"][k] for p in per)
                        for k in per[0]["launches"]}
        print(f"{name}: bytes handed to collectives per rank and round "
              f"{sorted({b for p in per for b in p['bytes_per_round']})}, "
              f"rank seconds {[round(p['seconds'], 2) for p in per]}, "
              f"mesh round seconds (pack to Eq. 4, synchronized) "
              f"{[[round(t, 4) for t in p['mesh_round_s']] for p in per]}, "
              f"max |student| {max(p['student_abs_max'] for p in per):.4g}")
        print(f"{name}: launches on rank 0 {per[0]['launches']}; summed "
              f"over {MESH_NODES} ranks {totals[name]}")
    return totals


def check_mesh_parity(torch, device: str = "cuda",
                      n_images: int = 7040) -> None:
    """Phase 11: one rank of a one-rank gloo group holds all
    ``MESH_NODES`` nodes.  After one round of local training of the
    stacked state, the packed mesh round (ring adjacency, 16-bit) and
    the stacked engine's ``share_phase`` + ``mix_phase`` run on copies
    of the same state: students within 4 ulp of their largest magnitude
    (the mix sums sender by sender, the engine's ``tensordot`` in
    cuBLAS's order, its fp32 weights rounded once from float64),
    prototypes and mask bit for bit."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import mesh_federation as M
    from repro_torch.core.profe import resolve_device
    from repro_torch.core.topology import make_schedule
    from repro_torch.optim.plane import Plane

    dev = resolve_device(device)
    cfg, train, node_data = mesh_inputs(n_images)
    nodes = list(range(MESH_NODES))
    fed, spec, parts, states = mesh_federation_parts(
        torch, cfg, train, "mesh/ring16", dev)
    train_phase, share_phase, mix_phase = parts
    state, protos, counts = train_nodes(fed, train, train_phase,
                                        states(nodes), node_data, nodes, 0,
                                        dev)
    sizes = [len(d["label"]) for d in node_data]
    sched = make_schedule(MESH_NODES, "ring")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            round_fn = M.make_profe_round(adjacency=sched.adjacency_at(0),
                                          exchange="packed", spec=spec)
            got = round_fn(Plane(state.student.buf.detach().clone(),
                                 state.student.meta), protos, counts,
                           torch.tensor(sizes, dtype=torch.float32,
                                        device=dev))
        finally:
            dist.destroy_process_group()
    st = state._replace(student=Plane(state.student.buf.detach().clone(),
                                      state.student.meta))
    st, recv_student, protos_rx = share_phase(st, protos)
    w_self, w_neigh, include = (torch.as_tensor(x[0], device=dev)
                                for x in sched.lower(sizes))
    st = mix_phase(st, recv_student, protos_rx, counts, w_self, w_neigh,
                   include)
    want = st.student.buf.detach()
    tol = 4 * float(torch.finfo(torch.float32).eps) * 2.0 ** math.floor(
        math.log2(float(want.abs().max())))
    err = float((got[0].buf - want).abs().max())
    same = (torch.equal(got[1], st.global_protos)
            and torch.equal(got[2], st.proto_mask))
    print(f"one rank, {MESH_NODES} nodes, packed ring round against "
          f"share_phase + mix_phase: max |student difference| {err:.3e} "
          f"(bound {tol:.3e}); prototypes and mask bit-exact: {same}")
    expect(err <= tol, "the one-rank mesh round's students differ from the "
                       "stacked engine's beyond 4 ulp")
    expect(same, "the one-rank mesh round's prototypes or mask differ from "
                 "the stacked engine's")


def profile_rounds(torch, inputs, name: str) -> None:
    """Phase 14 (``--profile``): where a round's time goes on the path
    ``name`` of ``PROFILED``.  After the path's own run (the warm-up:
    kernel build, cuDNN autotuning), it runs once more without the
    profiler and once under ``torch.profiler`` (CPU and CUDA
    activities).  Per round: wall
    seconds of both runs (host clock, synchronized), device-busy ms (the
    summed durations of the device activities — kernels, copies, fills
    — in the profiled run; one stream, so nothing overlaps), the device
    idle share against the unprofiled wall time (the profiler's host
    overhead inflates the profiled one), the port's kernels' launches,
    and the device activities with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.federation import run_federation
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    import dataclasses

    from repro_torch.wirespec import WireSpec

    _, optimizer, wire, rounds, _ = PATHS[name]
    cfg, fed, train, node_data, test_d = inputs
    fed = dataclasses.replace(fed, rounds=rounds,
                              **wire_fields(WireSpec.parse(wire)),
                              **PATH_FED.get(name, {}))
    train = dataclasses.replace(train, optimizer=optimizer)
    t0 = time.time()
    plain = run_federation(cfg, fed, train, node_data, test_d)
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = run_federation(cfg, fed, train, node_data, test_d)
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = launch_counts()

    by_name: dict = {}
    busy_us = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        calls, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, total + us)
    expect(busy_us > 0, "the profiler saw no device activity")
    top = sorted(by_name.items(), key=lambda kv: kv[1][1],
                 reverse=True)[:PROFILE_TOP]
    report = {
        "path": name,
        "rounds": rounds,
        "round_wall_s_unprofiled": plain.extras["round_times_s"],
        "round_wall_s_profiled": res.extras["round_times_s"],
        "wall_s_per_round_unprofiled": wall_plain / rounds,
        "wall_s_per_round_profiled": wall / rounds,
        "device_busy_ms_per_round": busy_us / 1e3 / rounds,
        "device_activities_per_round":
            sum(c for c, _ in by_name.values()) / rounds,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_plain,
        "kernel_launches_per_round":
            {k: v / rounds for k, v in counts.items()},
        "top_device_activities": [
            {"name": act[:160], "calls_per_round": c / rounds,
             "device_ms_per_round": us / 1e3 / rounds}
            for act, (c, us) in top],
    }
    print(f"round profile: {json.dumps(report)}")


def main() -> int:
    args = sys.argv[1:]
    if args not in ([], ["--profile"]):
        print(f"usage: {sys.argv[0]} [--profile]", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    phase("environment")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  device "
          f"{torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")

    phase("build")
    from repro_torch.kernels.build import build, library
    t0 = time.time()
    path, log = build()
    library()
    print(log)
    print(f"built {path.name} in {time.time() - t0:.1f} s")

    phase("kernels against their plain versions")
    from repro_torch.core.profe import resolve_device
    from repro_torch.config import get_config
    from repro_torch.models import derive_student
    resolve_device("cuda")
    timer = Timer(torch)
    rows = check_kernels(torch, timer, derive_student(get_config("mnist-cnn")))
    rows += check_plane_sweeps(torch, timer,
                               derive_student(get_config("cifar10-resnet18")))
    rows += check_lowrank(torch, timer,
                          derive_student(get_config("mnist-cnn")))
    rows += check_mix_packed(torch, timer,
                             derive_student(get_config("mnist-cnn")))
    rows += check_codec_kernels(torch, timer)
    rows += check_proto_kd_kernels(torch, timer)

    inputs = {model: path_inputs(model) for model in IMAGE_SHAPE}
    counts = {}
    for name, (model, optimizer, wire, rounds, _) in PATHS.items():
        phase(f"{'main' if name == '16' else 'path'} {name}: ProFe {model}, "
              f"{N_NODES} nodes, {rounds} round(s), {optimizer}, "
              f"{wire} wire")
        t0 = time.time()
        counts[name] = run_path(torch, inputs[model], name)
        print(f"{name} path took {time.time() - t0:.1f} s")

    # gloo binds to the loopback: the ranks share this machine, which has
    # no network
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    phase(f"mesh: {MESH_NODES} ranks on one card over gloo, "
          f"{', '.join(MESH_PATHS)}")
    t0 = time.time()
    counts.update(run_mesh(torch))
    print(f"mesh paths took {time.time() - t0:.1f} s")

    phase(f"mesh parity: one rank holding {MESH_NODES} nodes against the "
          f"stacked engine")
    check_mesh_parity(torch)

    phase("codec: the per-leaf and per-tensor wire codec at full width")
    t0 = time.time()
    counts["codec"] = run_codec(torch)
    print(f"codec phase took {time.time() - t0:.1f} s")

    phase("proto-infer: Claim 4 (Eq. 3 + Eq. 5) at full width, the ProFe "
          "KD term")
    t0 = time.time()
    counts["proto-infer"] = run_proto_infer(torch, inputs)
    print(f"proto-infer phase took {time.time() - t0:.1f} s")

    if args == ["--profile"]:
        for name in PROFILED:
            phase(f"round profile {name}: 2 rounds unprofiled, 2 profiled")
            profile_rounds(torch, inputs[PATHS[name][0]], name)

    for row in rows:
        row["path"] = KERNEL_PATH[row["name"]]
        row["launches"] = counts[row["path"]][row["name"]]
        if row["path"] in MESH_PATHS:
            row["ranks"] = MESH_NODES     # launches summed over the ranks
        if "per_recv" in row:
            row["per_recv"].update(path=PER_RECV_PATH, launches=counts[
                PER_RECV_PATH][row["name"]])
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
