#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA card; without one it exits non-zero and prints no result.
Phases, in order (any failure exits non-zero; nothing is caught):

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``;
3. each kernel against its plain PyTorch version on the card, at its
   path's shapes (the three plane sweeps also with a per-node mask:
   :func:`masked_sweep_cases`), with its time (CUDA events, median of 50 launches
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
   launch plan (``plan``) and the shapes they were held at (``cases``).
   ``fused_quantize`` and ``fused_quantize_dequantize`` (one cooperative
   launch each) are held bit for bit, codes and Δ, at the cases of
   :func:`fused_cases` (the teacher's leaf, mnist-cnn leaves, a view at
   element offset 1, 48 MB beyond what the grid stages, all zeros, a
   negative absmax); their rows carry the cases and the teacher leaf's
   launch plan (``design``).  ``mix_packed`` is held bit for bit at the
   ring, full-packed, 8×8, 8×8 fp32-code and accumulate shapes (all but
   the fp32 one timed), 12 receivers × 12 senders, a column tail
   (C = 510) and codes one element past a 16-byte address (see
   :func:`check_mix_packed`); ``adafactor_apply`` at ``[20, 208, 512]``
   and on a buffer one element in, timed beside ``torch.add(p, upd,
   out=p)`` (``stream_ms``).  One launch (a one-element add) is timed
   once and carried as ``launch_ms`` on those two rows and on rows 3, 8,
   9, 17 and 18; rows 3, 8, 9 and 18 also carry a same-byte ``copy_``
   (``copy_ms``).
   ``rowabs`` and ``rowabs_sum`` (decay 1.0 and 0.9) are held bit for bit
   at the cases of :func:`absmax_cases` too (the per-leaf payloads, odd
   cols, one row, 600,000 rows, 8192 columns, views off 16 bytes, zeros),
   ``proto_dist`` at ``PD_EDGE`` (N = 1, C = 1, P = 3, 130 and 2048, views
   off 16 bytes; fp32 and bf16).  The row codec
   (``quantize_rows``, ``quantize_rows_mixed`` with rows of 4, 8 and 16
   bits, ``quantize_dequantize_rows``, ``dequantize_rows``) is held bit
   for bit at the edge cases of :func:`row_codec_cases` too,
   ``dequantize`` at those of :func:`dequantize_cases`; their rows carry
   the cases and the launch plan of the timed shape (``design``).
   ``kd_loss`` is held within :func:`kd_tol` at ``KD_CASES`` (timed: the
   ProFe KD term, llama4-scout's vocabulary in bf16 and fp32, a ragged
   shape, 16 rows in the split regime) and ``KD_EDGE`` (V = 1, 7, 13,
   1001, views off 16 bytes, one and 16 rows of the LM vocabulary,
   logits of magnitude 1e3), a second call bit-identical to the first;
   its row carries every case with the ``kd_plan`` it took;
   :func:`check_row_block_shapes` holds ``mix_packed``'s accumulate form
   on the row-sharded permute's row blocks and ``rowabs`` /
   ``quantize_rows`` on one mamba2-130m node's payload;
   :func:`check_example_shapes`, :func:`check_paper_shapes` and
   :func:`check_round_step_shapes` hold the kernels at the shapes the
   examples (14d), paper (14e) and round-step (14f) phases give them,
   cifar100-resnet32's student plane, ``proto_accum`` at C = 100,
   table2 ``--physical``'s ``quantize_rows_mixed`` and 3- and 4-sender
   ``mix_packed``, the reduced mnist-cnn plane at N = 2, 4 and 8,
   ``lowrank_apply`` at the apply pair's leaves, the seed loop's
   one-node Eq. 3 pass and ``--wire``'s codec pair and ranks among them;
   ``proto_dist`` is also timed at P = 2048;
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
10. the paper baselines and ProFe's other student and wire on mnist-cnn
    as in 4, each through ``run_federation`` with its ``PATH_FED``
    fields: ``fedavg``, ``fedproto``, ``fml`` and ``fedgpd`` on the fp32
    wire, 2 rounds each (round 2 trains against round 1's prototypes),
    then ProFe with a per-leaf student (``16/per-leaf``,
    ``param_plane="off"``, the 16-bit wire through the tree codec) and
    ProFe on the fp32 wire (``fp32``, on the plane), 1 round each.  No
    plane sweep runs where the student is per-leaf, ``proto_accum`` runs
    where prototypes travel, the codec only on the quantized wire; then
    the round variants (``PATH_FED``, ``PATH_RUN``), 2 rounds each:
    ``16/fused`` (the fused Eq. 3 pass, every node evaluated: 20
    per-node F1s a round, their mean the F1), ``16/fused+ema`` (with
    ``proto_ema=0.5``: the carried counts 480 a node after round 2),
    ``16/none`` (the pipelined driver in order, under deterministic
    cuDNN, against a sequential leg from the same seeds: the final state
    bit-identical; the leg's train / Eq. 3 / share / mix seconds
    printed), ``16/rounds+floor`` (stale-by-one, self-weight floor 0.5),
    ``4/16+ef/rounds`` (``seq`` 2 on every node) and ``adapters8/rounds``
    (one mix: ``lowrank_apply`` 3 launches); then the non-iid paths
    (``PATH_SPLIT``): ``16/noniid40`` (2 rounds) and
    ``cifar10/sgd/dirichlet`` (1 round) on the stacked engine's masked
    steps, ``16/ragged``, ``4/16+ef/ragged`` and ``adapters8/ragged`` (1
    round each, node 0 cut under one batch) on the per-node loop engine,
    each path's launches predicted from its split and every path's
    per-node student step counters checked; then the tree
    payload's error feedback: ``adapters8+ef`` (rank 8 on the
    ``4,adapters=8+ef`` wire, its residual the adapter payload's: 2
    rounds, ``rowabs_sum`` and ``quantize_rows_ef`` once a round),
    ``adapters8+grams+ef`` (RegMean, 1 round), ``4/16+ef/per-leaf`` and
    ``adapters8/per-leaf`` (``param_plane="off"``, 1 round each) and
    ``adapters8+ef/ragged`` (the loop engine, 1 round), a tree residual
    held finite and non-zero with ``seq`` the rounds;
10a. ``loop``: ``run_federation_loop`` against ``run_federation`` on the
    main path's configuration, one round without and one with the
    gradient clip (:func:`check_loop_against_stacked`);
10b. ``checkpoint``: the ``4/16+ef`` state after round 1 saved under
    ``build/``, restored bit for bit, and resumed for round 2
    (``run_federation(start_round=1)``) against the uninterrupted run,
    the final state bit-identical (deterministic cuDNN); see
    :func:`run_checkpoint`;
10c. ``stochastic``: the main path's payload through the stochastic
    16-bit codec with a fixed key, the card's codes and reconstruction
    against the CPU's bit for bit, the mean error within 5 sigma of 0
    (:func:`run_stochastic`);
11. the multi-node exchange (``core/mesh_federation.py``): 8 ranks
    spawned in one gloo group, all on ``cuda:0``, one mnist-cnn node each
    at full width (``TrainConfig`` defaults, the 7040-image data iid over
    8 nodes).  Each round a rank trains its node with the stacked
    engine's ``train_phase`` (local epoch + exact Eq. 3 pass), then runs
    the mesh round: ``mesh/ring16`` (ring, ``ppermute``, 16-bit, 2
    rounds), ``mesh/ring4/16+ef`` (ring, ``ppermute`` with ``overlap``,
    ``4/16+ef``, 1 round), ``mesh/full-packed`` (``adjacency=None``,
    ``packed``, 16-bit, 1 round) and (``MESH_FED``)
    ``mesh/adapters8`` (the adapter round, ring ``ppermute``,
    ``4,adapters=8``, 2 rounds), ``mesh/adapters8+grams+ef/packed``
    (RegMean with ``+ef``, 1 round), ``mesh/fedavg`` (FedAvg's fp32
    model, ring ``ppermute``: ``mix_packed`` on fp32 codes) and
    ``mesh/fedavg/full-packed``, ``mesh/ring16/gather`` (the per-leaf
    reference exchange) and ``mesh/ring16/per-leaf`` (``param_plane=
    "off"``), 1 round each.  Every rank holds its bytes handed to
    collectives to the path's, its launches to :func:`mesh_launches`',
    and its student (and prototypes) to finite values; FedAvg's and
    ProFe's full-packed bytes are printed side by side (Table II on the
    mesh).  Then the same 8 ranks run as 4 nodes of 2 (``MESH_ROW_PATHS``,
    each rank a replica of its node, trained under deterministic
    algorithms): ``mesh/ring16/4x2`` (the row-sharded permute, 2 rounds),
    ``mesh/ring4/16+ef/4x2`` (with ``overlap``, pad rows, 1 round) and
    ``mesh/full-packed/4x2`` (replicated, 1 round), each rank's pod and
    node-group bytes printed and its pod bytes and launches checked, and
    the two ranks of every node ending bit-identical (a digest of the
    final student, prototypes, mask and residual);
11a. ``mesh/lm/mamba2-130m`` (:func:`run_mesh_lm`): 4 ranks on the one
    card, each holding one mamba2-130m node at full width and depth (the
    student plane ``[1, 164832, 512]``), one local pass of 2 batches of 4
    × 256 tokens, then one ring ``ppermute`` round of the 16-bit wire:
    bytes, launches, finite students and prototypes; a line ``mesh lm
    {...}`` with each rank's round seconds and peak memory; then
    ``mesh/lm/mamba2-130m/4x2``: 8 ranks as 4 such nodes of 2, one batch
    a node, the row-sharded permute (row 11 on ``[1, 82464, 512]``
    blocks), a line ``mesh lm 4x2 {...}``, the replicas bit-identical;
11b. ``audit`` (:func:`run_audit`): ``python -m repro_torch.launch.dryrun
    --arch mnist-cnn --topology ring --pods 4x2 --bits 4/16 --ef`` as a
    subprocess on the card, which must exit 0 with its pod permute bytes
    equal to its prediction; a line ``audit {...}``;
12. one rank holding all 8 nodes (``exchange="packed"``, ring adjacency)
    against the stacked engine's ``share_phase`` + ``mix_phase`` on the
    same post-train state: students within 4 ulp of their largest
    magnitude, prototypes and mask bit for bit; then the same for the
    adapter round (``mesh/adapters8``'s wiring), its new adapter
    references bit for bit too;
13. ``codec``, the per-leaf and per-tensor wire codec at full width (see
    :func:`run_codec`): ``quantize_dequantize_per_node(packed=False)`` on
    the 20-node mnist-cnn and cifar10-resnet18 student payloads against
    the packed codec and the plain per-leaf math (16-bit; on mnist-cnn
    also ``4/16`` and ``4/16+ef``), the packed-tree API (one node's
    student whole-leaf, and the stacked payload per node) and the
    per-tensor API (every float leaf of one node's student and the
    ResNet18 teacher's ``[3, 3, 512, 512]`` leaf) against
    ``core/quantization``, all bit for bit, each call's launches held
    exactly;
14. ``proto-infer``, the paper's Claim 4 at full width (see
    :func:`run_proto_infer`): on mnist-cnn (2 local epochs) and
    cifar10-resnet18 (1), node 0's 320 images through
    ``make_fedavg_step`` (per-leaf adamw, a one-node stack),
    ``compute_local_prototypes``
    (Eq. 3, ``proto_accum``) and ``nearest_prototype_predict`` on the
    640-image test split (Eq. 5, ``proto_dist``), the kernel's distances
    and predictions held to the plain versions and the accuracy printed;
    then the ProFe pair's KD term through ``kd_loss`` against
    ``core/distillation.kd_loss`` at T = 3 and 1;
14a. ``serve``, LM serving (see :func:`run_serve`; no kernel of the
    table runs on it): each of the ten assigned configs at ``.smoke()``
    in fp32 on the card, prefill of 7 tokens then decode of token 7
    against forward's last logits within the JAX package's 2e-2, and a
    20-step rolling decode (8-slot window) of yi-6b's smoke with finite
    logits; then at full width (``SERVE_FULL``) yi-6b (32 layers, 5.8 B
    parameters, fp32 weights), mamba2-130m, whisper-small (its
    1500-frame encoder) and llama4-scout-17b-a16e cut to 2 of its 48
    layers (``reduced``: 48 do not fit one card), each served through
    ``repro_torch.launch.serve`` (batch 4, prompt 16, 32 new tokens,
    bf16 activations and cache), its parameter count held to the JAX
    package's, then prefill of 15 tokens plus decode of token 15
    against forward's last logits in bf16 (``SERVE_BF16_TOL``) and in
    fp32 (``SERVE_FP32_TOL``); a line ``serve {...}`` a run with the
    card's name and power limit, peak memory, prefill and decode times;
14b. ``train``, LM training (see :func:`run_train`): each of the ten
    assigned configs at ``.smoke()`` (fp32 activations) takes one ProFe
    step through ``repro_torch.launch.train`` with ``remat`` on and off,
    under deterministic algorithms: finite losses, a changed student,
    the two states bit-identical; then at full width (``TRAIN_FULL``)
    mamba2-130m (24 layers), whisper-small (12 + 12, the 1500-frame
    encoder) and yi-6b cut to 2 of its 32 layers (``reduced``: fp32
    parameters and adamw moments of 32 layers do not fit one card), 5
    steps each at batch 4, sequence 256, ``remat`` on, their parameter
    counts held to the JAX package's; a line ``train {...}`` a run with
    the card, ms a step and peak memory; then the LM federations
    (``LM_PATHS``, :func:`run_lm_path`): ``lm/mamba2-130m`` (4 nodes,
    full graph, 2 rounds, adamw, the student on the plane, 16-bit wire)
    and ``lm/grok-1/per-leaf`` (grok-1's smoke config: bf16 leaves,
    adafactor, the per-leaf student, 1 round), each path's launches
    exactly and its bytes against the JAX package's; phase 3's
    :func:`check_lm_shapes` holds rows 1-4 at the first one's shapes;
14c. ``programs``, the microbatched train program (see
    :func:`run_programs`): yi-6b's smoke config, 4 microbatches against
    1 on one batch, then yi-6b cut to 2 layers at full width, batch
    4 × 256 in one microbatch and 16 × 256 in 4; a line ``programs
    {...}`` with ms a step and peak memory of each;
14d. ``examples``, the ported user scripts (see :func:`run_examples`):
    ``run()`` of ``examples/torch_quickstart.py``,
    ``torch_dfl_noniid_cifar.py``, ``torch_topology_sweep.py``,
    ``torch_mesh_federation_demo.py`` and ``benchmarks/torch_ablations.py``
    at their own defaults, every run's bytes the JAX package's
    (``EXAMPLE_BYTES``), quickstart's launches exactly, the sweep's and
    the demo's permute bytes the audit's prediction; then
    ``benchmarks/torch_dryrun_topo.py`` as a subprocess (its four rows
    equal to ``reports/dryrun/topology_*.json``); a line ``examples
    {...}`` with each script's seconds, bytes and F1;
14e. ``paper``, the paper's experiment scripts (see :func:`run_paper`):
    ``benchmarks/torch_run.py`` at its defaults (fig2, table2, table3 on
    mnist-cnn), table3 ``--overlap`` on a ring, table2 ``--physical`` at
    ``16`` and ``4/16``, and table2 and table3 on cifar100-resnet32,
    each ``main(argv)`` in ``build/paper/``; every run's bytes the JAX
    package's (``PAPER_BYTES``), its launches exactly, the ``ppermute``
    bytes the JAX report's, ``overlap="none"`` the sequential driver bit
    for bit; a line ``paper {...}`` with the tables' percentages and
    seconds a round;
14f. ``round-step``, the round-step microbenchmark (see
    :func:`run_round_step`): ``benchmarks/torch_round_step.py`` ``main``
    with ``--nodes 2 4 8 --phases`` (the seed loop against the stacked
    round on the reduced mnist-cnn, the phase split, the four A/B pairs)
    and ``--wire`` (the codec pair and the three exchanges on 8 spawned
    ranks at 16, 8, 4, ``4/16`` and ``4+adapters8``) in
    ``build/round_step/``; each row's ``ppermute``, ``packed`` and
    full-gather bytes the JAX package's (``ROUND_STEP_WIRE``), launches
    as predicted (the spawned ranks' warm-up and timed rounds), every
    time finite and above 0; a line ``round_step {...}``; then the
    regression gate of ``benchmarks/torch_check_regression.py`` over the
    committed ``BENCH_torch_*.json`` with those two reports as its fresh
    side (see :func:`hold_regression_gate`: bytes and the committed
    invariants' verdicts held, the times' ratios printed on a line
    ``regression_gate {...}``, not held: the two sides' hosts differ);
14g. ``roofline``, the compile-report mode (see :func:`run_roofline`):
    ``launch/dryrun.lower_combo`` for the 10 assigned archs × 4 shapes ×
    ``pod1`` / ``pod2`` on ``LAYOUT_JOBS`` processes, every combo ``ok`` (its trip-count fit checked
    against a held-out trace), a line each (the dominant term, ``6ND``
    over the counted FLOPs, whether it fits the card); then the same
    op counter (``launch/op_analysis``) over programs the earlier phases
    timed, at their own shapes: yi-6b's batch-4 decode step (14a), the
    three full-width train steps (14b) and yi-6b's microbatched program
    at both of its runs (14c), each count's compute and memory terms at
    the card's published peaks beside the measured ms: a term more than
    5 % above the measured time fails (the count would be wrong), and
    the count's ``peak_bytes_estimate`` is printed beside
    ``torch.cuda.max_memory_allocated()``; a line ``roofline {...}``
    (each combo's report is written to ``build/roofline/``);
14h. ``layouts``, the in-node layouts (see :func:`run_layouts`): the
    compile report of a node of 8 cards at layout ``auto``
    (``launch/dryrun.lower_combo(cards_per_node=8)``: one rank of the
    node traced on ``meta`` under DTensor over a fake process group) for
    the 10 assigned archs at ``train_4k`` and ``decode_32k`` but the pairs
    in ``LAYOUT_CUT``, on ``LAYOUT_JOBS`` processes, every combo ``ok`` and
    its held-out trace exact, a line each (its layout, the dominant term,
    whether the rank fits the card); then one rank of yi-6b (2 layers,
    ``train_4k`` at 4 × 256) under ``fsdp`` on 8 × 1 and ``tp`` on 2 × 4
    run on the card over the fake group (its compute runs, its collectives
    move nothing): the count's larger compute / memory term beside the
    measured ms a step (a term 5 % above it fails) and the count's
    ``peak_bytes_estimate`` beside ``max_memory_allocated()``; a line
    ``layouts {...}`` (each combo's report in ``build/layouts/``);
15. with ``--profile`` only: where a round's time goes on the main path,
    the ``cifar10/sgd`` path and the ``adapters8`` path — each path's
    own run above is the warm-up, then 2 rounds without and 2 rounds
    under ``torch.profiler`` (see :func:`profile_rounds`);
16. a line ``{"kernels": [...]}`` with each kernel's launches on its
    path, error and times, then the card's ``nvidia-smi`` name and power
    limit, then the result line ``{"ok": true, "device": {...}}`` last.

Phases 4-10 each set the kernels' launch counts to 0 just before
``run_federation`` and read them just after, check finite F1 every
round, and hold the run's wire bytes to the JAX package's; phase 11
does the same on every rank around each mesh run, phase 13 around
the whole codec phase (its per-call launches are read as differences),
phase 14 around each of its driven parts, phase 14b around each LM
federation, phases 14d and 14e around each script's run (14e around
each ``run_federation``) and phase 14f around each measurement call.
Phase 3's ``proto_dist`` and ``kd_loss`` rows carry every shape they were
held at in ``cases``.
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
    # the paper baselines on the fp32 wire: FedAvg and FedGPD ship the
    # teacher-size model (FedGPD with prototypes), FedProto prototypes
    # only, FML the meme (the student-size model); then ProFe with a
    # per-leaf student and ProFe on the fp32 wire.  These numbers are also
    # what the JAX package's run_federation reports for these runs on the
    # CPU
    "fedavg": ("mnist-cnn", "adamw", "fp32", 2,
               (0.064089584, 1703936, 1686568)),
    "fedproto": ("mnist-cnn", "adamw", "fp32", 2, (0.00019608, 16424, 5160)),
    "fml": ("mnist-cnn", "adamw", "fp32", 2, (0.031452144, 851968, 827688)),
    "fedgpd": ("mnist-cnn", "adamw", "fp32", 2,
               (0.064285664, 1703976, 1691728)),
    "16/per-leaf": ("mnist-cnn", "adamw", "16", 1,
                    (0.007912816, 426060, 416464)),
    "fp32": ("mnist-cnn", "adamw", "fp32", 1, (0.015824112, 852008, 832848)),
    # the round variants: the fused Eq. 3 pass (with all-node evaluation,
    # then with the prototype EMA), the pipelined driver in order and
    # stale-by-one (with a self-weight floor), on the wires above; the
    # round variants leave what travels as it is, so the bytes are those
    # paths'
    "16/fused": ("mnist-cnn", "adamw", "16", 2,
                 (0.015825632, 426060, 416464)),
    "16/fused+ema": ("mnist-cnn", "adamw", "16", 2,
                     (0.015825632, 426060, 416464)),
    "16/none": ("mnist-cnn", "adamw", "16", 2,
                (0.015825632, 426060, 416464)),
    "16/rounds+floor": ("mnist-cnn", "adamw", "16", 2,
                        (0.015825632, 426060, 416464)),
    "4/16+ef/rounds": ("mnist-cnn", "adamw", "4/16+ef", 2,
                       (0.004030508, 108876, 106066)),
    "adapters8/rounds": ("mnist-cnn", "adamw", "4", 2,
                         (0.000377188, 12376, 9926)),
    # the non-iid federations (PATH_SPLIT): unequal batch counts on the
    # stacked engine's masked steps, and ragged node datasets on the
    # per-node loop engine; what travels does not depend on the split, so
    # the bytes are their base paths' over their rounds
    "16/noniid40": ("mnist-cnn", "adamw", "16", 2,
                    (0.015825632, 426060, 416464)),
    "cifar10/sgd/dirichlet": ("cifar10-resnet18", "sgd", "16", 1,
                              (0.003763444, 221336, 198076)),
    "16/ragged": ("mnist-cnn", "adamw", "16", 1,
                  (0.007912816, 426060, 416464)),
    "4/16+ef/ragged": ("mnist-cnn", "adamw", "4/16+ef", 1,
                       (0.002015254, 108876, 106066)),
    "adapters8/ragged": ("mnist-cnn", "adamw", "4", 1,
                         (0.000188594, 12376, 9926)),
    # the tree payload's error feedback: the adapter wire with
    # 8-bit factors and +ef (its residual mirrors the adapter payload),
    # naive and RegMean; +ef and the adapter wire on a per-leaf student;
    # the adapter +ef wire on the loop engine.  The residual never travels,
    # so the bytes are the stateless wire's
    "adapters8+ef": ("mnist-cnn", "adamw", "4,adapters=8+ef", 2,
                     (0.00072162, 22104, 18990)),
    "adapters8+grams+ef": ("mnist-cnn", "adamw", "4,adapters=8+ef", 1,
                           (0.000605188, 36452, 31852)),
    "4/16+ef/per-leaf": ("mnist-cnn", "adamw", "4/16+ef", 1,
                         (0.002015254, 108876, 106066)),
    "adapters8/per-leaf": ("mnist-cnn", "adamw", "4", 1,
                           (0.000188594, 12376, 9926)),
    "adapters8+ef/ragged": ("mnist-cnn", "adamw", "4,adapters=8+ef", 1,
                            (0.00036081, 22104, 18990)),
}
# the FederationConfig fields of a path beyond its wire spec
PATH_FED = {"adapters8": dict(adapter_rank=8),
            "adapters8+grams": dict(adapter_rank=8, adapter_grams=True),
            "fedavg": dict(algorithm="fedavg"),
            "fedproto": dict(algorithm="fedproto"),
            "fml": dict(algorithm="fml"),
            "fedgpd": dict(algorithm="fedgpd"),
            "16/per-leaf": dict(param_plane="off"),
            "16/fused": dict(proto_pass="fused"),
            "16/fused+ema": dict(proto_pass="fused", proto_ema=0.5),
            "adapters8/rounds": dict(adapter_rank=8),
            "adapters8/ragged": dict(adapter_rank=8),
            "adapters8+ef": dict(adapter_rank=8, adapter_quantize_bits=8),
            "adapters8+grams+ef": dict(adapter_rank=8, adapter_grams=True,
                                       adapter_quantize_bits=8),
            "4/16+ef/per-leaf": dict(param_plane="off"),
            "adapters8/per-leaf": dict(adapter_rank=8, param_plane="off"),
            "adapters8+ef/ragged": dict(adapter_rank=8,
                                        adapter_quantize_bits=8)}
# the run_federation keywords of a path
PATH_RUN = {"16/fused": dict(eval_all_nodes=True),
            "16/none": dict(overlap="none"),
            "16/rounds+floor": dict(overlap="rounds", stale_self_floor=0.5),
            "4/16+ef/rounds": dict(overlap="rounds"),
            "adapters8/rounds": dict(overlap="rounds")}
# the paths held bit for bit to a second run, under deterministic cuDNN
DETERMINISTIC_PATHS = ("16/none",)
# the split of a path's training images over the nodes where it is not
# iid: partition(labels, 20, split, 0); "ragged" is iid with node 0 cut to
# RAGGED_IMAGES images, under one batch, so run_federation falls back to
# the per-node loop engine
PATH_SPLIT = {"16/noniid40": "noniid40", "cifar10/sgd/dirichlet": "dirichlet",
              "16/ragged": "ragged", "4/16+ef/ragged": "ragged",
              "adapters8/ragged": "ragged", "adapters8+ef/ragged": "ragged"}
RAGGED_IMAGES = 20
# the baselines that share prototypes (an Eq. 3 pass a round)
PROTO_BASELINES = ("fedproto", "fedgpd")
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
# the multi-node exchange (phase 11): name -> (topology, exchange, wire
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
    # the adapter round (its payload {adapters, protos, student:
    # rest[, grams]}, packed_copy_bytes at N = 8 from the JAX package:
    # 22104 B a copy, 36452 with grams) on ppermute and, RegMean with
    # +ef, packed; FedAvg's fp32 model rows (1703936 B a copy, PATHS'
    # fedavg) on ppermute, mix_packed with fp32 codes, and full-packed;
    # the per-leaf reference exchange (gather: each leaf's int16 codes,
    # 206922 elements, its 8 scales, the prototypes' codes and scale and
    # the counts); ProFe with a per-leaf student on ppermute
    "mesh/adapters8": ("ring", "ppermute", "4,adapters=8", False, 2,
                       2 * 22104, 0),
    "mesh/adapters8+grams+ef/packed": ("ring", "packed", "4,adapters=8+ef",
                                       False, 1, 36452, 0),
    "mesh/fedavg": ("ring", "ppermute", "fp32", False, 1, 2 * 1703936, 1),
    "mesh/fedavg/full-packed": ("full", "packed", "fp32", False, 1, 1703936,
                                1),
    "mesh/ring16/gather": ("ring", "gather", "16", False, 1,
                           2 * 206922 + 4 * 8 + 2 * 1280 + 4 + 4 * 10, 0),
    "mesh/ring16/per-leaf": ("ring", "ppermute", "16", False, 1, 2 * 426060,
                             1),
}
# the FederationConfig fields of a mesh path beyond its wire spec
MESH_FED = {"mesh/adapters8": dict(adapter_rank=8, adapter_quantize_bits=8),
            "mesh/adapters8+grams+ef/packed": dict(
                adapter_rank=8, adapter_grams=True, adapter_quantize_bits=8),
            "mesh/fedavg": dict(algorithm="fedavg"),
            "mesh/fedavg/full-packed": dict(algorithm="fedavg"),
            "mesh/ring16/per-leaf": dict(param_plane="off")}
MESH_DEADLINE_S = 600
# an LM student on the mesh: mamba2-130m at full width and depth, one
# node a rank on MESH_LM_RANKS ranks (ring, ppermute, 16-bit, 1 round)
# after a local pass of LM_BATCHES batches; a rank sends 2 copies of
# packed_copy_bytes({model, protos, counts}) = 168886584 B (LM_PATHS)
MESH_LM = "mesh/lm/mamba2-130m"
MESH_LM_RANKS = 4
MESH_LM_BYTES = 2 * 168886584
MESH_LM_PLANE = (1, 164832, 512)
# several ranks a node (the row-sharded permute): phase 11's 8 ranks as
# MESH_ROW_NODES nodes of MESH_RANKS_PER_NODE ranks, rank r the inner
# index r % 2 of node r // 2, each holding a replica of its node (trained
# under deterministic algorithms, so the replicas stay bit-identical);
# name -> (topology, exchange, wire spec, overlap, rounds, bytes a rank
# hands to its pod group a round, mix_packed launches a rank a round).  On
# ppermute a rank sends its row block of the copy in each of its 2 steps:
# 2 × packed_copy_bytes(inner=2) / 2 = 426,064 B at 16-bit, 110,160 at
# 4/16 (a pad row in each width group); the mix is one accumulate a step.
# full-packed runs replicated: a rank's one whole copy.  The data:
# make_image_dataset(0, MESH_ROW_IMAGES, ...) iid over the 4 nodes (800
# training images a node, as on the 8-node paths)
MESH_ROW_NODES, MESH_RANKS_PER_NODE = 4, 2
MESH_ROW_IMAGES = 3520
MESH_ROW_PATHS = {
    "mesh/ring16/4x2": ("ring", "ppermute", "16", False, 2, 426064, 2),
    "mesh/ring4/16+ef/4x2": ("ring", "ppermute", "4/16+ef", True, 1, 110160,
                             2),
    "mesh/full-packed/4x2": ("full", "packed", "16", False, 1, 426060, 1),
}
# mamba2-130m on 4 nodes of 2 ranks: a rank moves its row block
# [1, 82464, 512] of the 16-bit copy in each of 2 steps, 2 × 84,443,292 B
# (packed_copy_bytes(inner=2) of {model, protos, counts} = 168,886,584);
# its local pass is one batch of LM_BATCH × 256
MESH_LM_4X2 = "mesh/lm/mamba2-130m/4x2"
MESH_LM_4X2_BYTES = 168886584
MESH_LM_BLOCK = (1, 82464, 512)
# the audit on the card (run_audit): a subprocess, one round of each
# exchange on 8 spawned ranks, 3 measurements
AUDIT_CMD = ("-m", "repro_torch.launch.dryrun", "--arch", "mnist-cnn",
             "--topology", "ring", "--pods", "4x2", "--bits", "4/16", "--ef")
AUDIT_TIMEOUT_S = 400
# the microbatched train program (run_programs): yi-6b cut to 2 of its 32
# layers at full width, remat on, PROGRAM_STEPS steps of (batch,
# microbatches) each
PROGRAM_RUNS = ((4, 1), (16, 4))
PROGRAM_STEPS, PROGRAM_LAYERS = 3, 2
# the paths this PR adds; the kernels line lists each kernel's launches
# on them
NEW_PATHS = tuple(MESH_ROW_PATHS) + (MESH_LM_4X2,)
# the per-receiver (RegMean) variant of lowrank_apply runs on this path
PER_RECV_PATH = "adapters8+grams"
# the data of each model's paths: make_image_dataset(0, 7040, shape, 10)
# with a 1/11 test split, iid over the nodes (320 images, 10 steps each)
IMAGE_SHAPE = {"mnist-cnn": (28, 28, 1), "cifar10-resnet18": (32, 32, 3)}


def parse_wire(wire: str):
    """A path's wire: its ``WireSpec``, or None for ``"fp32"``."""
    from repro_torch.wirespec import WireSpec
    return None if wire == "fp32" else WireSpec.parse(wire)


def wire_fields(spec) -> dict:
    """The FederationConfig fields that select the wire ``spec`` (None:
    the fp32 wire)."""
    if spec is None:
        return dict(quantize_bits=0)
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


def mixed_rows(torch, buf, seg_ids, plane, protos):
    """The ``4/16`` wire's per-row Δ and qmax ``[N·R, 1]`` for the packed
    payload ``buf`` (:func:`payload_buffer`): int16 prototype rows, int4
    student rows."""
    import numpy as np
    from repro_torch.kernels.quantize.ops import (_node_row_deltas,
                                                  _seg_qmax,
                                                  pack_plane_payload)
    from repro_torch.wirespec import WireSpec
    _, _, meta, _, _ = pack_plane_payload(protos, plane, WireSpec(4, 16))
    _, row_delta = _node_row_deltas(buf, seg_ids, meta[1], 16, meta[3])
    qm = np.tile(_seg_qmax(meta[1], 16, meta[3])[seg_ids], buf.shape[0])
    return (row_delta.reshape(-1, 1).contiguous(),
            torch.as_tensor(qm[:, None], device="cuda"))


def copy_ms(torch, timer, nbytes: int) -> float:
    """The time of a ``copy_`` that moves ``nbytes`` (half read, half
    written): a sweep's yardstick beside one launch."""
    src = torch.empty(max(1, nbytes // 8), dtype=torch.float32,
                      device="cuda")
    dst = torch.empty_like(src)
    return timer(lambda: dst.copy_(src))


def absmax_cases(torch, name: str):
    """Phase 3's cases of the row absmax (``rowabs``, or ``rowabs_sum`` at
    decay 1.0 and 0.9 with a residual of half a step), each held bit for
    bit to its plain version: the per-leaf payloads of mnist-cnn
    (``[8240, 512]``) and of the ResNet8 student (``[4184, 512]``), 510
    and 10 columns, one row, 600,000 rows of 8 (beyond 65,535 row tiles:
    two rows a warp), 8192 columns (16 steps a warp), x (and res) at
    storage offsets 1-3 and res alone at offset 1, all zeros, and rows
    zero but for one element.  Returns the cases with the plan each
    took."""
    from repro_torch.kernels.quantize import quantize as Q
    from repro_torch.kernels.quantize import ref as R
    from repro_torch.kernels.quantize.ops import pack_tree
    gen = torch.Generator().manual_seed(8)
    cases = []

    def held(what, x, x_off=0, res_off=0):
        x = on_card_at(torch, x, x_off)
        rows, cols = x.shape
        bufs = [x]
        if name == "rowabs":
            got, want = [Q.rowabs_cuda(x)], [R.rowabs_ref(x)]
        else:
            res = torch.rand(x.shape, generator=gen) - 0.5
            res = on_card_at(torch, res * x.abs().amax().cpu() / 32767,
                             res_off)
            bufs.append(res)
            got, want = [], []
            for decay in (1.0, 0.9):
                dec = torch.tensor(decay, dtype=torch.float32, device="cuda")
                got.append(Q.rowabs_sum_cuda(x, res, decay))
                want.append(R.rowabs_sum_ref(x, res, dec))
        torch.cuda.synchronize()
        expect(all(map(bits_equal, [torch] * len(got), got, want)),
               f"{name} is not bit-exact with its plain version at {what}")
        plan = Q.absmax_plan(rows, cols, all(t.data_ptr() % 16 == 0
                                             for t in bufs))
        cases.append(dict(case=what, shape=[rows, cols],
                          offsets=[t.storage_offset() for t in bufs],
                          vec=plan.vec, block=list(plan.block),
                          grid=list(plan.grid),
                          rows_a_thread=plan.rows_a_thread,
                          steps=plan.steps))
        return plan

    for model, shape in (("mnist-cnn", (8240, 512)),
                         ("cifar10-resnet18", (4184, 512))):
        buf = pack_tree(codec_payload(torch, model, 3), node_axis=True)[0]
        expect(tuple(buf.shape) == shape,
               f"{model} per-leaf payload {tuple(buf.shape)}")
        expect(held(f"{model} per-leaf payload", buf).vec == 4,
               f"{name}: the {model} payload took one column a vector")
    for cols in (510, 10):
        expect(held(f"{cols} columns", torch.randn((257, cols),
                                                   generator=gen)).vec == 1,
               f"{name}: {cols} columns took 16-byte vectors")
    held("one row", torch.randn((1, 512), generator=gen))
    expect(held("600,000 rows of 8", torch.randn(
        (600000, 8), generator=gen)).rows_a_thread == 2,
           f"{name}: 600,000 rows took no row stride")
    expect(held("8192 columns", torch.randn((257, 8192),
                                            generator=gen)).steps == 16,
           f"{name}: 8192 columns took other than 16 steps")
    for off in (1, 2, 3):
        expect(held(f"at offset {off}", torch.randn((257, 512),
                                                    generator=gen),
                    off, off).vec == 1,
               f"{name}: a view off 16 bytes took 16-byte vectors")
    if name == "rowabs_sum":
        expect(held("res at offset 1", torch.randn((257, 512),
                                                   generator=gen),
                    0, 1).vec == 1,
               "rowabs_sum: res off 16 bytes took 16-byte vectors")
    held("all zeros", torch.zeros((257, 512)))
    lone = torch.zeros((257, 512))
    lone[torch.arange(257), torch.randint(0, 512, (257,), generator=gen)] = (
        torch.randn(257, generator=gen))
    held("zero but one element a row", lone)
    print(f"{name}: bit-exact at {len(cases)} cases")
    return cases


# the per-node mask of the plane sweeps (rows 1, 5, 6): every third node
# sits the step out, and each node has its own step counter
MASK_STEPS = tuple(3 + i % 5 for i in range(N_NODES))


def node_mask(torch, how: str, nodes: int = N_NODES):
    """The ``[nodes]`` bool mask of a masked-sweep case on the card:
    ``mixed`` (every third node off), ``all`` on or ``none`` on."""
    on = {"mixed": [i % 3 != 2 for i in range(nodes)],
          "all": [True] * nodes, "none": [False] * nodes}[how]
    return torch.tensor(on, device="cuda")


def masked_sweep_cases(torch, timer, name: str, launch, plain, bufs,
                       hows=("mixed", "all", "none")):
    """Phase 3, a plane sweep with a per-node mask: ``launch(*bufs,
    active=mask)`` updates copies of ``bufs`` (the buffers it writes, each
    ``[N, R, C]``) in place, ``plain(active=mask)`` returns the plain
    version's outputs.  At each mask of ``hows`` (mixed, all on, none
    on): bit for bit the plain version's, the masked nodes' rows
    bit-unchanged.  Returns ``(masked_ms, cases)``: the kernel's time at
    the first mask of ``hows``."""
    cases = []
    nodes = bufs[0].shape[0]
    for how in hows:
        mask = node_mask(torch, how, nodes)
        got = [b.clone() for b in bufs]
        launch(*got, active=mask)
        want = plain(active=mask)
        torch.cuda.synchronize()
        ulps = max(ulp_diff(torch, a, b) for a, b in zip(got, want))
        off = ~mask
        kept = all(bits_equal(torch, a[off], b[off])
                   for a, b in zip(got, bufs))
        moved = int(sum(int((a[mask] != b[mask]).any(dim=(1, 2)).sum())
                        for a, b in zip(got[:1], bufs[:1])))
        print(f"{name} masked ({how}: {int(mask.sum())} of {nodes} nodes "
              f"on): max ulp difference {ulps}, masked nodes unchanged "
              f"{kept}, active nodes moved {moved}")
        expect(ulps == 0, f"{name} with a {how} mask is not bit-exact with "
               f"its plain version")
        expect(kept, f"{name}: a masked node's rows changed ({how})")
        expect(moved == int(mask.sum()),
               f"{name}: {moved} active nodes moved ({how})")
        cases.append(dict(mask=how, nodes_on=int(mask.sum())))
    mask = node_mask(torch, hows[0], nodes)
    got = [b.clone() for b in bufs]
    masked_ms = timer(lambda: launch(*got, active=mask))
    return masked_ms, cases


def check_kernels(torch, timer, student_cfg):
    """Phase 3: every kernel against its plain version at path shapes;
    ``quantize_rows`` and ``quantize_rows_mixed`` also at the edge cases
    of :func:`row_codec_cases`, which their rows carry (``cases``) with
    the path's launch plan (``design``)."""
    from dataclasses import asdict

    from repro_torch.kernels.opt_update.opt_update import adamw_update_cuda
    from repro_torch.kernels.opt_update.ref import adamw_update_ref
    from repro_torch.kernels.proto_accum.proto_accum import (
        COLS, ROWS, THREADS, proto_accum_cuda, proto_accum_smem)
    from repro_torch.kernels.proto_accum.ref import (proto_accum_batch_order,
                                                     proto_accum_ref)
    from repro_torch.kernels.quantize.ops import _node_row_deltas
    from repro_torch.kernels.quantize.quantize import (
        absmax_plan, quantize_rows_cuda, quantize_rows_ef_cuda,
        quantize_rows_mixed_cuda, rowabs_cuda, rowabs_sum_cuda, rows_plan)
    from repro_torch.kernels.quantize.ref import (quantize_rows_ef_ref,
                                                  quantize_rows_mixed_ref,
                                                  quantize_rows_ref,
                                                  rowabs_ref, rowabs_sum_ref)

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
    step = torch.full((N_NODES,), 3, dtype=torch.int32, device="cuda")
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
    # per-node counters and a per-node mask (nodes with unequal batch
    # counts): every node its own bias corrections
    mstep = torch.tensor(MASK_STEPS, dtype=torch.float32, device="cuda")
    mbc1, mbc2 = 1.0 - 0.9 ** mstep, 1.0 - 0.999 ** mstep
    masked_ms, masked = masked_sweep_cases(
        torch, timer, "adamw_update",
        lambda pp, mm, vv, active: adamw_update_cuda(
            g, pp, mm, vv, lr, scale, mbc1, mbc2, active=active, **hp),
        lambda active: adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale,
                                        bc1=mbc1, bc2=mbc2, active=active,
                                        **hp),
        [p, mu, nu])
    print(f"adamw_update: {ms:.4f} ms unmasked, {masked_ms:.4f} ms with "
          f"{sum(i % 3 != 2 for i in range(N_NODES))} of {N_NODES} nodes on")
    b_ms, b_by = bound(7 * 4 * n, 18 * n)
    rows.append(dict(name="adamw_update", route="cuda",
                     source="src/repro_torch/csrc/opt_update.cu",
                     replaces="src/repro/kernels/opt_update/opt_update.py:80",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     masked_ms=masked_ms,
                     masked_cases=[dict(c, steps=list(MASK_STEPS))
                                   for c in masked]))

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
    nbytes = 4 * x2d.numel() + 4 * x2d.shape[0]
    b_ms, b_by = bound(nbytes, x2d.numel())
    plan = absmax_plan(*x2d.shape, x2d.data_ptr() % 16 == 0)
    expect(plan.vec == 4, f"the main path's payload took {plan}")
    rows.append(dict(name="rowabs", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:186",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms,
                     copy_ms=copy_ms(torch, timer, nbytes),
                     design=asdict(plan),
                     cases=[dict(case="main path", shape=list(x2d.shape))]
                     + absmax_cases(torch, "rowabs")))
    print(f"rowabs {tuple(x2d.shape)}: bit-exact (plan {plan})")

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
    plan = rows_plan(*x2d.shape, x2d.data_ptr() % 16 == 0)
    expect(plan.vec == 4, f"the main path's payload took {plan}")
    rows.append(dict(name="quantize_rows", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:313",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms, design=asdict(plan),
                     cases=[dict(case="main path", shape=list(x2d.shape),
                                 bits=16)]
                     + row_codec_cases(torch, "quantize_rows")))
    print(f"quantize_rows {tuple(x2d.shape)}: bit-exact codes (plan {plan})")

    # -- the 4/16 wire: int16 prototype rows, int4 student rows ----------
    # No single PyTorch call computes these three functions (a per-row
    # clip width; a residual added inside the reduction or the sweep), so
    # their library_ms is null.
    rd, qm = mixed_rows(torch, buf, seg_ids, plane, protos)
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
    plan = rows_plan(*x2d.shape, x2d.data_ptr() % 16 == 0)
    expect(plan.vec == 4, f"the 4/16 path's payload took {plan}")
    rows.append(dict(name="quantize_rows_mixed", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:339",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None,
                     copy_ms=copy_ms(torch, timer, 8 * x2d.numel()),
                     design=asdict(plan),
                     cases=[dict(case="4/16 path", shape=list(x2d.shape),
                                 bits="16 (prototypes) / 4 (student)")]
                     + row_codec_cases(torch, "quantize_rows_mixed")))
    print(f"quantize_rows_mixed {tuple(x2d.shape)}: bit-exact codes "
          f"(plan {plan})")

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
    nbytes = 8 * x2d.numel() + 4 * x2d.shape[0]
    b_ms, b_by = bound(nbytes, 4 * x2d.numel())
    rows.append(dict(name="rowabs_sum", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/kernels/quantize/quantize.py:224",
                     max_abs_err=float((got - want).abs().max()), ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None,
                     copy_ms=copy_ms(torch, timer, nbytes),
                     design=asdict(absmax_plan(
                         *x2d.shape, x2d.data_ptr() % 16 == 0
                         and res2d.data_ptr() % 16 == 0)),
                     cases=[dict(case="main path", shape=list(x2d.shape),
                                 decay=[1.0, 0.9])]
                     + absmax_cases(torch, "rowabs_sum")))
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


def check_loop_shapes(torch, timer, student_cfg, rows) -> None:
    """Phase 3 at the loop engine's shapes (paths ``16/ragged``,
    ``4/16+ef/ragged``, ``adapters8/ragged``): a node's state is a
    one-node stack, so ``adamw_update`` sweeps ``[1, R, 512]`` (one grid
    row of :func:`sweep_grid`) and the plane-row wire codes one node's
    ``[R, 512]`` rows at one Δ per leaf segment.  ``adamw_update`` with
    no mask, all on and none on; ``quantize_dequantize_plane_rows``
    (``rowabs``, then ``quantize_dequantize_rows``) at 16 and 4 bits;
    ``ef_quantize_dequantize_plane``'s student (``rowabs_sum``, then
    ``quantize_rows_ef``) at the ``4/16+ef`` spec, decay 1.0 and 0.9:
    each bit for bit its plain version (``kernels/*/ref.py`` through the
    same segment max).  Each kernel's time at that shape goes into its
    row of ``rows`` under ``loop``."""
    import dataclasses

    from repro_torch.core.wire_state import (CodecState,
                                             ef_quantize_dequantize_plane)
    from repro_torch.kernels.opt_update.opt_update import adamw_update_cuda
    from repro_torch.kernels.opt_update.ref import adamw_update_ref
    from repro_torch.kernels.quantize.ops import (
        _qmax_t, plane_row_deltas, quantize_dequantize_plane_rows)
    from repro_torch.kernels.quantize.quantize import (
        quantize_dequantize_rows_cuda, quantize_rows_ef_cuda, rowabs_cuda,
        rowabs_sum_cuda)
    from repro_torch.kernels.quantize.ref import (
        quantize_dequantize_rows_ref, quantize_rows_ef_ref, rowabs_ref,
        rowabs_sum_ref)
    from repro_torch.optim.plane import Plane

    by_name = {row["name"]: row for row in rows}
    gen = torch.Generator().manual_seed(26)
    _, _, _, plane, protos = payload_buffer(torch, gen, student_cfg)
    one = Plane(plane.buf[0:1].clone(), plane.meta)     # a one-node stack
    shape = tuple(one.buf.shape)
    x2d = one.buf.reshape(-1, shape[-1])
    r, c = x2d.shape
    n = x2d.numel()

    # -- row 1: adamw over one node's plane [1, R, 512] ------------------
    g = (torch.randn(shape, generator=gen) * 1e-3).cuda()
    mu = (torch.randn(shape, generator=gen) * 1e-4).cuda()
    nu = (torch.rand(shape, generator=gen) * 1e-7).cuda()
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    lr = torch.full((), 1e-3, device="cuda")
    step = torch.full((1,), float(MASK_STEPS[1]), device="cuda")
    bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
    scale = torch.full((1,), 0.37, device="cuda")
    p = one.buf

    def launch(pp, mm, vv, active=None):
        adamw_update_cuda(g, pp, mm, vv, lr, scale, bc1, bc2, active=active,
                          **hp)

    def plain(active=None):
        return adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale, bc1=bc1,
                                bc2=bc2, active=active, **hp)
    got = [p.clone(), mu.clone(), nu.clone()]
    launch(*got)
    want = plain()
    torch.cuda.synchronize()
    ulps = max(ulp_diff(torch, a, b) for a, b in zip(got, want))
    print(f"adamw_update {shape} (a one-node stack, no mask): max ulp "
          f"difference {ulps}")
    expect(ulps == 0, f"adamw_update at {shape} is not bit-exact with its "
           f"plain version")
    ms = timer(lambda: launch(*got))
    plain_ms = timer(plain)
    masked_ms, masked = masked_sweep_cases(torch, timer, "adamw_update",
                                           launch, plain, [p, mu, nu],
                                           hows=("all", "none"))
    b_ms, _ = bound(7 * 4 * n, 18 * n)
    g_scaled = g * scale
    lib_step = [torch.full((), float(MASK_STEPS[1]), device="cuda")]
    lib_ms = timer(lambda: torch._fused_adamw_(
        [got[0]], [g_scaled], [got[1]], [got[2]], [], lib_step, lr=1e-3,
        beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False))
    by_name["adamw_update"]["loop"] = dict(
        shape=list(shape), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        masked_ms=masked_ms, masked_cases=masked, library_ms=lib_ms)
    print(f"adamw_update {shape}: {ms:.4f} ms unmasked, {masked_ms:.4f} ms "
          f"with its mask on (plain {plain_ms:.4f} ms)")

    # -- rows 3 and 7: the plane-row round trip of one node --------------
    ra = rowabs_cuda(x2d)
    expect(torch.equal(ra, rowabs_ref(x2d)),
           f"rowabs disagrees with its plain version at {(r, c)}")
    for bits in (16, 4):
        rd = plane_row_deltas(rowabs_ref(x2d), plane.meta, bits)
        got = quantize_dequantize_plane_rows(one, bits).buf
        want = quantize_dequantize_rows_ref(x2d, rd, bits=bits)
        torch.cuda.synchronize()
        expect(tuple(got.shape) == shape and bits_equal(
            torch, got.reshape(r, c), want),
            f"quantize_dequantize_plane_rows at {bits} bits is not "
            f"bit-exact with its plain version")
        print(f"quantize_dequantize_plane_rows {shape} at {bits} bits "
              f"({len(plane.meta.recipe)} segments): bit-exact")
    rd = plane_row_deltas(ra, plane.meta, 16)
    zero = torch.zeros(r, dtype=torch.int32, device="cuda")
    scales = rd.reshape(-1).contiguous()
    by_name["rowabs"]["loop"] = dict(
        shape=[r, c], ms=timer(lambda: rowabs_cuda(x2d)),
        plain_ms=timer(lambda: rowabs_ref(x2d)),
        bound_ms=bound(4 * n + 4 * r, n)[0],
        library_ms=timer(lambda: torch.linalg.vector_norm(
            x2d, ord=math.inf, dim=1)))
    by_name["quantize_dequantize_rows"]["loop"] = dict(
        shape=[r, c], bits=[16, 4],
        ms=timer(lambda: quantize_dequantize_rows_cuda(x2d, rd, bits=16)),
        plain_ms=timer(lambda: quantize_dequantize_rows_ref(x2d, rd,
                                                            bits=16)),
        bound_ms=bound(8 * n + 4 * r, 4 * n)[0],
        library_ms=timer(lambda: torch.fake_quantize_per_channel_affine(
            x2d, scales, zero, 0, -32768, 32767)))

    # -- rows 9 and 10: the +ef plane codec of one node ------------------
    spec = parse_wire("4/16+ef")
    sb = spec.bits_for("student")
    rd0 = plane_row_deltas(ra, plane.meta, sb)
    res = Plane(((torch.rand(shape, generator=gen) - 0.5).cuda()
                 * rd0.reshape(1, r, 1)).contiguous(), plane.meta)
    r2d = res.buf.reshape(r, c)
    state = CodecState({"protos": torch.zeros_like(protos[0]),
                        "student": res}, torch.zeros((), dtype=torch.int32,
                                                     device="cuda"))
    for decay in (spec.ef_decay, 0.9):
        sp = dataclasses.replace(spec, ef_decay=decay)
        dec = torch.tensor(decay, dtype=torch.float32, device="cuda")
        recv, new = ef_quantize_dequantize_plane(
            {"protos": protos[0], "student": one}, sp, state)
        rd = plane_row_deltas(rowabs_sum_ref(x2d, r2d, dec), plane.meta, sb)
        qm = _qmax_t(sb, x2d.device).expand(rd.shape).contiguous()
        codes, res_want = quantize_rows_ef_ref(x2d, r2d, rd, qm, dec)
        torch.cuda.synchronize()
        expect(bits_equal(torch, recv["student"].buf.reshape(r, c),
                          codes.to(torch.float32) * rd)
               and bits_equal(torch, new.residual["student"].buf.reshape(
                   r, c), res_want),
               f"ef_quantize_dequantize_plane (decay {decay}) is not "
               f"bit-exact with its plain version")
        print(f"ef_quantize_dequantize_plane {shape}, {sb}-bit student, "
              f"decay {decay}: received plane and residual bit-exact")
    dec = torch.ones((), device="cuda")
    rd = plane_row_deltas(rowabs_sum_ref(x2d, r2d, dec), plane.meta, sb)
    qm = _qmax_t(sb, x2d.device).expand(rd.shape).contiguous()
    by_name["rowabs_sum"]["loop"] = dict(
        shape=[r, c], ms=timer(lambda: rowabs_sum_cuda(x2d, r2d, 1.0)),
        plain_ms=timer(lambda: rowabs_sum_ref(x2d, r2d, dec)),
        bound_ms=bound(8 * n + 4 * r, 4 * n)[0])
    by_name["quantize_rows_ef"]["loop"] = dict(
        shape=[r, c], bits=sb,
        ms=timer(lambda: quantize_rows_ef_cuda(x2d, r2d, rd, qm, 1.0)),
        plain_ms=timer(lambda: quantize_rows_ef_ref(x2d, r2d, rd, qm, dec)),
        bound_ms=bound(16 * n + 8 * r, 9 * n)[0])
    for name in ("adamw_update", "rowabs", "quantize_dequantize_rows",
                 "rowabs_sum", "quantize_rows_ef"):
        loop = by_name[name]["loop"]
        print(f"{name} at the loop shape {loop['shape']}: {loop['ms']:.4f} "
              f"ms (plain {loop['plain_ms']:.4f} ms, bound "
              f"{loop['bound_ms']:.4f} ms, library "
              f"{loop.get('library_ms')})")


def check_lm_shapes(torch, timer, rows, nodes: int = 4) -> None:
    """Phase 3 at the ``lm/mamba2-130m`` path's shapes: ``nodes`` random
    mamba2-130m students at full width on one ``[nodes, R, 512]`` plane
    (R = 164,832: 84,390,240 parameters a node), ``adamw_update`` over it;
    the 16-bit payload spliced from it behind ``[nodes, 64, 768]``
    prototypes through ``rowabs`` and ``quantize_rows`` (over 659k rows);
    ``proto_accum`` on the step's ``f1 [nodes, 4, 768]`` at C = 64 domain
    tags.  Each bit for bit its plain version (``proto_accum`` its
    batch-order one); each kernel's time at that shape goes into its row
    of ``rows`` under ``lm``."""
    from repro_torch.config import get_config
    from repro_torch.kernels.opt_update.opt_update import adamw_update_cuda
    from repro_torch.kernels.opt_update.ref import adamw_update_ref
    from repro_torch.kernels.proto_accum.proto_accum import proto_accum_cuda
    from repro_torch.kernels.proto_accum.ref import (proto_accum_batch_order,
                                                     proto_accum_ref)
    from repro_torch.kernels.quantize.ops import (_node_row_deltas,
                                                  pack_plane_payload)
    from repro_torch.kernels.quantize.quantize import (quantize_rows_cuda,
                                                       rowabs_cuda)
    from repro_torch.kernels.quantize.ref import (quantize_rows_ref,
                                                  rowabs_ref)
    from repro_torch.models import derive_student, init_params
    from repro_torch.optim.plane import Plane, plane_from_tree
    from repro_torch.wirespec import WireSpec

    by_name = {row["name"]: row for row in rows}
    cfg = get_config("mamba2-130m")
    student_cfg = derive_student(cfg)
    gen = torch.Generator(device="cuda").manual_seed(28)
    bufs, meta = [], None
    for _ in range(nodes):
        one = plane_from_tree(init_params(student_cfg, gen))
        bufs.append(one.buf)
        meta = one.meta
    plane = Plane(torch.stack(bufs), meta)
    del bufs, one
    shape = tuple(plane.buf.shape)
    n = plane.buf.numel()
    print(f"lm shapes: {nodes} mamba2-130m students on a {shape} plane "
          f"({n * 4 / 1e9:.2f} GB)")

    # -- row 1: adamw over the plane --------------------------------------
    p = plane.buf
    g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    mu = torch.randn(shape, generator=gen, device="cuda") * 1e-4
    nu = torch.rand(shape, generator=gen, device="cuda") * 1e-7
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    lr = torch.full((), 1e-3, device="cuda")
    step = torch.full((nodes,), 3.0, device="cuda")
    bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
    scale = torch.rand((nodes,), generator=gen,
                       device="cuda").clamp_min(0.1)
    want = adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale, bc1=bc1,
                            bc2=bc2, **hp)
    got = [p.clone(), mu.clone(), nu.clone()]
    adamw_update_cuda(g, *got, lr, scale, bc1, bc2, **hp)
    torch.cuda.synchronize()
    ulps = max(ulp_diff(torch, a, b) for a, b in zip(got, want))
    expect(ulps == 0, f"adamw_update at {shape} is not bit-exact with its "
           f"plain version ({ulps} ulp)")
    del want
    g_scaled = (g.reshape(nodes, -1) * scale[:, None]).reshape(shape)
    lib_step = [torch.full((), 3.0, device="cuda")]
    by_name["adamw_update"]["lm"] = dict(
        path="lm/mamba2-130m", shape=list(shape),
        ms=timer(lambda: adamw_update_cuda(g, *got, lr, scale, bc1, bc2,
                                           **hp), reps=10),
        plain_ms=timer(lambda: adamw_update_ref(
            g, p, mu, nu, lr=lr, scale=scale, bc1=bc1, bc2=bc2, **hp),
            reps=10),
        bound_ms=bound(7 * 4 * n, 18 * n)[0],
        library_ms=timer(lambda: torch._fused_adamw_(
            [got[0]], [g_scaled], [got[1]], [got[2]], [], lib_step,
            lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
            amsgrad=False, maximize=False), reps=10))
    print(f"adamw_update {shape}: bit-exact")
    del g, mu, nu, got, g_scaled

    # -- rows 3 and 4: the 16-bit payload over every node's rows ---------
    protos = torch.rand((nodes, cfg.n_proto_classes, cfg.proto_dim),
                        generator=gen, device="cuda")
    buf, seg_ids, pmeta, _, _ = pack_plane_payload(protos, plane,
                                                   WireSpec(16))
    x2d = buf.reshape(-1, buf.shape[-1]).contiguous()
    del buf
    r, c = x2d.shape
    m = x2d.numel()
    ra = rowabs_cuda(x2d)
    expect(torch.equal(ra, rowabs_ref(x2d)),
           f"rowabs disagrees with its plain version at {(r, c)}")
    _, row_delta = _node_row_deltas(x2d.reshape(nodes, -1, c), seg_ids,
                                    pmeta[1], 16, pmeta[3])
    rd = row_delta.reshape(-1, 1).contiguous()
    codes = quantize_rows_cuda(x2d, rd, bits=16)
    torch.cuda.synchronize()
    expect(torch.equal(codes, quantize_rows_ref(x2d, rd, bits=16)),
           f"quantize_rows disagrees with its plain version at {(r, c)}")
    print(f"rowabs and quantize_rows {(r, c)}: bit-exact")
    zero = torch.zeros(r, dtype=torch.int64, device="cuda")
    scales = rd[:, 0].contiguous()
    by_name["rowabs"]["lm"] = dict(
        path="lm/mamba2-130m", shape=[r, c],
        ms=timer(lambda: rowabs_cuda(x2d), reps=10),
        plain_ms=timer(lambda: rowabs_ref(x2d), reps=10),
        bound_ms=bound(4 * m + 4 * r, m)[0],
        library_ms=timer(lambda: torch.linalg.vector_norm(
            x2d, ord=math.inf, dim=1), reps=10))
    by_name["quantize_rows"]["lm"] = dict(
        path="lm/mamba2-130m", shape=[r, c], bits=16,
        ms=timer(lambda: quantize_rows_cuda(x2d, rd, bits=16), reps=10),
        plain_ms=timer(lambda: quantize_rows_ref(x2d, rd, bits=16),
                       reps=10),
        bound_ms=bound(8 * m + 4 * r, 4 * m)[0],
        library_ms=timer(lambda: torch.quantize_per_channel(
            x2d, scales, zero, 0, torch.qint32), reps=10))
    del x2d, codes, plane, p

    # -- row 2: Eq. 3 over the step's f1 and domain tags ------------------
    ncls = cfg.n_proto_classes
    f1 = torch.relu(torch.randn((nodes, LM_BATCH, cfg.proto_dim),
                                generator=gen, device="cuda"))
    labels = torch.randint(0, ncls, (nodes, LM_BATCH), generator=gen,
                           dtype=torch.int32, device="cuda")
    s_got, c_got = proto_accum_cuda(f1, labels, ncls)
    s_bat, c_bat = proto_accum_batch_order(f1, labels, ncls)
    torch.cuda.synchronize()
    expect(ulp_diff(torch, s_got, s_bat) == 0 and torch.equal(c_got, c_bat),
           f"proto_accum at {tuple(f1.shape)} C={ncls} is not bit-identical "
           f"to the batch-order plain version")
    node_cls = (torch.arange(nodes, device="cuda")[:, None] * ncls
                + labels).reshape(-1)
    f1_flat = f1.reshape(-1, cfg.proto_dim)

    def library():
        sums = torch.zeros((nodes * ncls, cfg.proto_dim), device="cuda")
        sums.index_add_(0, node_cls, f1_flat)
        torch.bincount(node_cls, minlength=nodes * ncls)
    by_name["proto_accum"]["lm"] = dict(
        path="lm/mamba2-130m", shape=list(f1.shape), classes=ncls,
        ms=timer(lambda: proto_accum_cuda(f1, labels, ncls)),
        plain_ms=timer(lambda: proto_accum_ref(f1, labels, ncls)),
        bound_ms=bound(4 * (f1.numel() + labels.numel() + s_got.numel()
                            + c_got.numel()),
                       f1.numel() + labels.numel())[0],
        library_ms=timer(library))
    print(f"proto_accum {tuple(f1.shape)} C={ncls}: bit-identical to the "
          f"batch-order plain version")
    for name in LM_KERNELS:
        lm = by_name[name]["lm"]
        print(f"{name} at the LM shape {lm['shape']}: {lm['ms']:.4f} ms "
              f"(plain {lm['plain_ms']:.4f} ms, library "
              f"{lm['library_ms']:.4f} ms, bound {lm['bound_ms']:.4f} ms)")
    torch.cuda.empty_cache()


def check_new_shapes(torch, timer, rows) -> None:
    """Phase 3 at the shapes the tree payload's error feedback and the
    adapter, FedAvg and LM mesh paths give four kernels, each bit for bit
    its plain version and timed into its row of ``rows``:

    * ``rowabs_sum`` and ``quantize_rows_ef`` (rows 9, 10) on the
      ``adapters8+ef`` tree payload: 20 nodes' rank-8 factors of the
      mnist-cnn student's conv2, fc1 and fc2 (8-bit), its dense rest and
      prototypes (4-bit), packed by ``pack_tree_nodes``, with a residual
      of up to half a code step (``tree_ef``);
    * ``mix_packed`` (row 11) on ``mesh/fedavg``'s fp32 codes: a rank's
      own FedAvg model rows ``[1, 832, 512]`` and its 2 ring neighbours'
      at unit Δ (``fedavg``), and on ``mesh/lm/mamba2-130m``'s 16-bit
      codes, own ``[1, R, 512]`` and 2 senders, R the student plane's
      164,832 rows behind the prototypes' 96 (``lm``);
    * ``lowrank_apply`` (row 16) on one rank's merge of fc1 ``[1, 1568,
      128]``: its 2 ring steps as the senders with ``A`` shared
      (``mesh/adapters8``), and 8 senders with ``A`` per receiver
      (RegMean on ``mesh/adapters8+grams+ef/packed``) (``mesh``)."""
    from dataclasses import asdict

    import numpy as np

    from repro_torch.config import get_config
    from repro_torch.core.adapters import adapter_layout, init_adapter_state
    from repro_torch.core.round_ops import adapter_share_nodes
    from repro_torch.kernels.lowrank_apply.lowrank_apply import (
        lowrank_apply_cuda, lowrank_plan)
    from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref
    from repro_torch.kernels.quantize.ops import (_node_row_deltas, _seg_qmax,
                                                  pack_plane_payload,
                                                  pack_tree_nodes,
                                                  quantize_packed_buffer)
    from repro_torch.kernels.quantize.quantize import (mix_packed_cuda,
                                                       mix_plan,
                                                       quantize_rows_ef_cuda,
                                                       rowabs_sum_cuda)
    from repro_torch.kernels.quantize.ref import (mix_packed_ref,
                                                  quantize_rows_ef_ref,
                                                  rowabs_sum_ref)
    from repro_torch.models import derive_student, init_params
    from repro_torch.optim.plane import Plane, as_tree, plane_from_tree
    from repro_torch.tree import tree_map
    from repro_torch.wirespec import WireSpec

    by_name = {row["name"]: row for row in rows}
    gen = torch.Generator(device="cuda").manual_seed(29)

    def stacked_plane(cfg, nodes):
        bufs, meta = [], None
        for _ in range(nodes):
            one = plane_from_tree(tree_map(lambda x: x.to("cuda"),
                                           init_params(cfg, gen)))
            bufs.append(one.buf)
            meta = one.meta
        return Plane(torch.stack(bufs), meta)

    # -- rows 9 and 10: the adapter wire's +ef payload ---------------------
    spec = parse_wire(PATHS["adapters8+ef"][2])
    mnist = derive_student(get_config("mnist-cnn"))
    plane = stacked_plane(mnist, N_NODES)
    tree = as_tree(plane)
    ast = init_adapter_state(adapter_layout(tree, 8, node_axis=True), tree)
    ast = {"ref": {k: v + 1e-3 * torch.randn(v.shape, generator=gen,
                                              device="cuda")
                   for k, v in ast["ref"].items()}}
    groups, _, _ = adapter_share_nodes(plane, ast, rank=8)
    protos = torch.rand((N_NODES, 10, mnist.proto_dim), generator=gen,
                        device="cuda")
    buf, seg_ids, meta = pack_tree_nodes(dict(groups, protos=protos), spec)
    n_nodes, r_rows, c = buf.shape
    _, rd0 = _node_row_deltas(buf, seg_ids, meta[1], 16, meta[3])
    res = ((torch.rand(buf.shape, generator=gen, device="cuda") - 0.5)
           * rd0[:, :, None]).contiguous()
    x2d, r2d = buf.reshape(-1, c).contiguous(), res.reshape(-1, c)
    r, n = x2d.shape[0], x2d.numel()
    dec = torch.ones((), device="cuda")
    expect(torch.equal(rowabs_sum_cuda(x2d, r2d, 1.0),
                       rowabs_sum_ref(x2d, r2d, dec)),
           f"rowabs_sum disagrees with its plain version on the adapter "
           f"payload {(r, c)}")
    _, rd = _node_row_deltas(buf, seg_ids, meta[1], 16, meta[3],
                             residual=res)
    rd = rd.reshape(-1, 1).contiguous()
    qm = torch.as_tensor(np.tile(_seg_qmax(meta[1], 16, meta[3])[
        np.asarray(seg_ids)], n_nodes)[:, None], device="cuda")
    c_got, r_got = quantize_rows_ef_cuda(x2d, r2d, rd, qm, 1.0)
    c_want, r_want = quantize_rows_ef_ref(x2d, r2d, rd, qm, dec)
    torch.cuda.synchronize()
    expect(torch.equal(c_got, c_want) and bits_equal(torch, r_got, r_want),
           f"quantize_rows_ef disagrees with its plain version on the "
           f"adapter payload {(r, c)}")
    print(f"rowabs_sum and quantize_rows_ef on the adapters8+ef payload "
          f"{(r, c)} ({sorted(set(meta[3].tolist()))}-bit rows): bit-exact")
    by_name["rowabs_sum"]["tree_ef"] = dict(
        path="adapters8+ef", shape=[r, c],
        ms=timer(lambda: rowabs_sum_cuda(x2d, r2d, 1.0)),
        plain_ms=timer(lambda: rowabs_sum_ref(x2d, r2d, dec)),
        bound_ms=bound(8 * n + 4 * r, 4 * n)[0], library_ms=None)
    by_name["quantize_rows_ef"]["tree_ef"] = dict(
        path="adapters8+ef", shape=[r, c],
        ms=timer(lambda: quantize_rows_ef_cuda(x2d, r2d, rd, qm, 1.0)),
        plain_ms=timer(lambda: quantize_rows_ef_ref(x2d, r2d, rd, qm, dec)),
        bound_ms=bound(16 * n + 8 * r, 9 * n)[0], library_ms=None)
    del plane, tree, ast, groups, buf, res, x2d, r2d

    # -- row 11: FedAvg's fp32 codes and the LM plane's 16-bit codes -------
    def mix_case(key, path, own, cds, rd):
        m, rr, cc = own.shape
        s_ = cds.shape[0]
        w = torch.rand((m, s_ + 1), generator=gen, device="cuda")
        w = w / w.sum(dim=1, keepdim=True)
        w_self, w_rows = w[:, 0].contiguous(), w[:, 1:].contiguous()
        got = mix_packed_cuda(own, cds, rd, w_self, w_rows)
        want = mix_packed_ref(own, cds, rd, w_self, w_rows)
        torch.cuda.synchronize()
        expect(ulp_diff(torch, got, want) == 0,
               f"mix_packed ({key}) is not bit-exact with its plain version")
        plan = mix_plan(m, s_, rr, cc, all(t.data_ptr() % 16 == 0
                                           for t in (own, cds, got)))
        print(f"mix_packed {key}: own {tuple(own.shape)} codes "
              f"{tuple(cds.shape)} {cds.dtype}: bit-exact (plan {plan})")
        by_name["mix_packed"][key] = dict(
            path=path, own=list(own.shape), codes=list(cds.shape),
            code_dtype=str(cds.dtype).replace("torch.", ""),
            ms=timer(lambda: mix_packed_cuda(own, cds, rd, w_self, w_rows),
                     reps=10),
            plain_ms=timer(lambda: mix_packed_ref(own, cds, rd, w_self,
                                                  w_rows), reps=10),
            bound_ms=bound(4 * (2 * own.numel() + cds.numel() + rd.numel()
                                + w_self.numel() + w_rows.numel()),
                           m * rr * cc * (1 + 3 * s_))[0],
            library_ms=None, plan=asdict(plan))

    fa = stacked_plane(get_config("mnist-cnn"), 3).buf
    mix_case("fedavg", "mesh/fedavg", fa[:1].contiguous(),
             fa[1:].contiguous(), torch.ones(fa[1:].shape[:2],
                                             device="cuda"))
    del fa
    lm_cfg = get_config("mamba2-130m")
    lm = stacked_plane(derive_student(lm_cfg), 3)
    lbuf, lids, lmeta, _, _ = pack_plane_payload(
        torch.rand((3, lm_cfg.n_proto_classes, lm_cfg.proto_dim),
                   generator=gen, device="cuda"), lm, WireSpec(16))
    del lm
    lcodes, lscales = quantize_packed_buffer(lbuf, lids, lmeta[1],
                                             seg_bits=lmeta[3])
    lrd = lscales[:, torch.as_tensor(lids, dtype=torch.int64,
                                     device="cuda")].contiguous()
    mix_case("lm", MESH_LM, lbuf[:1].contiguous(),
             lcodes[1:].to(torch.int32).contiguous(), lrd[1:].contiguous())
    del lbuf, lcodes, lscales, lrd

    # -- row 16: a rank's merge: its 2 ring steps (A shared), or 8 senders
    # -- with A per receiver (RegMean on the packed exchange) --------------
    d, k, rk = 1568, 128, 8
    w = (torch.randn((1, d, k), generator=gen, device="cuda") * 0.05)
    mesh = {}
    for variant, s_, path in (("shared", 2, "mesh/adapters8"),
                              ("per_recv", MESH_NODES,
                               "mesh/adapters8+grams+ef/packed")):
        b = torch.randn((s_, d, rk), generator=gen,
                        device="cuda") / math.sqrt(d)
        coeffs = torch.rand((1, s_), generator=gen, device="cuda") / s_
        a = torch.randn(((1,) if variant == "per_recv" else ()) +
                        (s_, rk, k), generator=gen, device="cuda") * 1e-3
        got = lowrank_apply_cuda(w, coeffs, b, a)
        torch.cuda.synchronize()
        expect(ulp_diff(torch, got, lowrank_apply_ref(w, coeffs, b, a)) == 0,
               f"lowrank_apply ({variant}) is not bit-exact with its plain "
               f"version at a rank's merge")
        plan = lowrank_plan(1, s_, 1, d, k, rk, variant == "per_recv")
        ops = (d * k * (2 * rk * s_ + 2 * s_ + 1) if variant == "shared"
               else s_ * d * k * (2 * rk + 2))
        bc = (coeffs[0, :, None, None] * b).permute(1, 0, 2) \
            .reshape(d, s_ * rk).contiguous()
        a2 = a.reshape(s_ * rk, k)
        mesh[variant] = dict(
            path=path, w=list(w.shape), senders=s_, rank=rk,
            ms=timer(lambda: lowrank_apply_cuda(w, coeffs, b, a)),
            plain_ms=timer(lambda: lowrank_apply_ref(w, coeffs, b, a)),
            bound_ms=bound(4 * (2 * w.numel() + coeffs.numel() + b.numel()
                                + a.numel()), ops)[0],
            library_ms=timer(lambda: torch.addmm(w[0], bc, a2)),
            plan=asdict(plan))
        print(f"lowrank_apply at a rank's merge ({variant}): w "
              f"{tuple(w.shape)}, {s_} senders: bit-exact (plan "
              f"{plan.design})")
    by_name["lowrank_apply"]["mesh"] = mesh
    for name, key in (("rowabs_sum", "tree_ef"), ("quantize_rows_ef",
                                                  "tree_ef"),
                      ("mix_packed", "fedavg"), ("mix_packed", "lm")):
        e = by_name[name][key]
        print(f"{name} ({key}): {e['ms']:.4f} ms (plain {e['plain_ms']:.4f} "
              f"ms, bound {e['bound_ms']:.4f} ms)")
    for variant, e in mesh.items():
        print(f"lowrank_apply (mesh, {variant}): {e['ms']:.4f} ms (plain "
              f"{e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, "
              f"bound {e['bound_ms']:.4f} ms)")
    torch.cuda.empty_cache()


def check_row_block_shapes(torch, timer, rows) -> None:
    """Phase 3 at the row-sharded permute's shapes: ``mix_packed``'s
    accumulate form (row 11: the own block at weight one and one
    sender's codes) on inner rank 0's row block of a node's 16-bit
    payload, ``[1, R'/2, 512]`` — mnist-cnn's ``[1, 208, 512]``
    (``mesh/ring16/4x2``, key ``4x2``) and mamba2-130m's ``[1, 82464,
    512]`` (``MESH_LM_4X2``, key ``lm_4x2``), the block made by the round's
    own ``_row_block``; and ``rowabs`` / ``quantize_rows`` (rows 3, 4) on
    one mamba2-130m node's whole payload ``[164928, 512]``, what a rank
    of ``MESH_LM_4X2`` quantizes.  Each bit for bit its plain version,
    timed into its row under ``row_block``."""
    from dataclasses import asdict

    from repro_torch.config import get_config
    from repro_torch.core.mesh_federation import _row_block
    from repro_torch.kernels.quantize.ops import (_node_row_deltas,
                                                  pack_plane_payload,
                                                  quantize_packed_buffer)
    from repro_torch.kernels.quantize.quantize import (mix_packed_cuda,
                                                       mix_plan,
                                                       quantize_rows_cuda,
                                                       rowabs_cuda)
    from repro_torch.kernels.quantize.ref import (mix_packed_ref,
                                                  quantize_rows_ref,
                                                  rowabs_ref)
    from repro_torch.models import derive_student, init_params
    from repro_torch.optim.plane import Plane, plane_from_tree
    from repro_torch.tree import tree_map
    from repro_torch.wirespec import WireSpec

    by_name = {row["name"]: row for row in rows}
    gen = torch.Generator(device="cuda").manual_seed(30)
    for key, arch, path in (("4x2", "mnist-cnn", "mesh/ring16/4x2"),
                            ("lm_4x2", "mamba2-130m", MESH_LM_4X2)):
        cfg = get_config(arch)
        scfg = derive_student(cfg)
        ncls = cfg.num_classes if cfg.family == "cnn" else \
            cfg.n_proto_classes
        bufs = []
        for _ in range(2):
            one = plane_from_tree(tree_map(lambda x: x.to("cuda"),
                                           init_params(scfg, gen)))
            bufs.append(one.buf)
        plane = Plane(torch.stack(bufs), one.meta)
        del bufs, one
        protos = torch.rand((2, ncls, scfg.proto_dim), generator=gen,
                            device="cuda")
        counts = torch.ones((2, ncls), device="cuda")
        buf, ids, meta, _, _ = pack_plane_payload(protos, plane, WireSpec(16))
        del plane
        codes, scales = quantize_packed_buffer(buf, ids, meta[1],
                                               seg_bits=meta[3])
        own = _row_block(buf[:1], codes[:1], scales[:1], counts[:1], ids,
                         meta[3], MESH_RANKS_PER_NODE, 0)
        sender = _row_block(buf[1:], codes[1:], scales[1:], counts[1:], ids,
                            meta[3], MESH_RANKS_PER_NODE, 0)
        acc = own.own.contiguous()
        cds = sender.codes.to(torch.int32).contiguous()
        rd = scales[1:, sender.seg].contiguous()
        one_w = torch.ones((1,), device="cuda")
        w = torch.rand((1, 1), generator=gen, device="cuda")
        got = mix_packed_cuda(acc, cds, rd, one_w, w)
        torch.cuda.synchronize()
        expect(ulp_diff(torch, got, mix_packed_ref(acc, cds, rd, one_w,
                                                   w)) == 0,
               f"mix_packed (accumulate) on the row block {tuple(acc.shape)}"
               f" is not bit-exact with its plain version")
        _, rr, cc = acc.shape
        plan = mix_plan(1, 1, rr, cc, all(t.data_ptr() % 16 == 0
                                          for t in (acc, cds, got)))
        print(f"mix_packed accumulate on {arch}'s row block "
              f"{tuple(acc.shape)}: bit-exact (plan {plan})")
        by_name["mix_packed"].setdefault("row_block", {})[key] = dict(
            path=path, own=list(acc.shape), codes=list(cds.shape),
            ms=timer(lambda: mix_packed_cuda(acc, cds, rd, one_w, w),
                     reps=10),
            plain_ms=timer(lambda: mix_packed_ref(acc, cds, rd, one_w, w),
                           reps=10),
            bound_ms=bound(4 * (2 * acc.numel() + cds.numel() + rd.numel()
                                + 2), 4 * rr * cc)[0],
            library_ms=None, plan=asdict(plan))
        if key == "lm_4x2":
            x2d = buf[0].contiguous()
            r, c = x2d.shape
            n = x2d.numel()
            expect(torch.equal(rowabs_cuda(x2d), rowabs_ref(x2d)),
                   f"rowabs disagrees with its plain version at {(r, c)}")
            _, row_delta = _node_row_deltas(buf[:1], ids, meta[1], 16,
                                            meta[3])
            rd1 = row_delta.reshape(-1, 1).contiguous()
            expect(torch.equal(quantize_rows_cuda(x2d, rd1, bits=16),
                               quantize_rows_ref(x2d, rd1, bits=16)),
                   f"quantize_rows disagrees with its plain version at "
                   f"{(r, c)}")
            print(f"rowabs and quantize_rows on one mamba2-130m node's "
                  f"payload {(r, c)}: bit-exact")
            by_name["rowabs"]["row_block"] = dict(
                path=path, shape=[r, c],
                ms=timer(lambda: rowabs_cuda(x2d), reps=10),
                plain_ms=timer(lambda: rowabs_ref(x2d), reps=10),
                bound_ms=bound(4 * n + 4 * r, n)[0],
                library_ms=timer(lambda: torch.linalg.vector_norm(
                    x2d, ord=math.inf, dim=1), reps=10))
            by_name["quantize_rows"]["row_block"] = dict(
                path=path, shape=[r, c], bits=16,
                ms=timer(lambda: quantize_rows_cuda(x2d, rd1, bits=16),
                         reps=10),
                plain_ms=timer(lambda: quantize_rows_ref(x2d, rd1, bits=16),
                               reps=10),
                bound_ms=bound(8 * n + 4 * r, 4 * n)[0],
                library_ms=timer(lambda: torch.quantize_per_channel(
                    x2d, rd1[:, 0].contiguous(),
                    torch.zeros(r, dtype=torch.int64, device="cuda"), 0,
                    torch.qint32), reps=10))
            del x2d
        del buf, codes, scales, own, sender, acc, cds, got
    for name in ("mix_packed", "rowabs", "quantize_rows"):
        blocks = by_name[name]["row_block"]
        for k, e in (blocks.items() if name == "mix_packed"
                     else [("lm_4x2", blocks)]):
            print(f"{name} (row block, {k}): {e['ms']:.4f} ms (plain "
                  f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms)")
    torch.cuda.empty_cache()


def _held(torch, timer, rows, name: str, key: str, launch, plain, *,
          nbytes: float, nops: float, check=None, library=None,
          group: str = "example_shapes", **info) -> None:
    """One phase-3 case: ``launch()`` (a kernel's wrapper) bit for bit
    ``check()`` (by default ``plain()``, its plain version), then both
    timed, and ``library`` where a PyTorch call computes the same; the
    entry goes into the row of ``name`` under ``group[key]``."""
    got, want = launch(), (check or plain)()
    torch.cuda.synchronize()
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    expect(len(got) == len(want) and all(bits_equal(torch, a, b)
                                         for a, b in zip(got, want)),
           f"{name} ({key}) is not bit-exact with its plain version")
    entry = dict(info, ms=timer(launch), plain_ms=timer(plain),
                 bound_ms=bound(nbytes, nops)[0],
                 library_ms=None if library is None else timer(library))
    row = next(r for r in rows if r["name"] == name)
    row.setdefault(group, {})[key] = entry
    print(f"{name} ({key}) {info.get('shape', '')}: bit-exact, "
          f"{entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms)", flush=True)


class ShapeCases:
    """Phase-3 cases of rows 1-4 and 11 at a later phase's shapes, each
    held bit for bit against its plain version and timed (:func:`_held`)
    into its row under ``group``; inputs drawn from ``seed`` on the
    card."""

    def __init__(self, torch, timer, rows, group: str, seed: int):
        self.torch, self.timer, self.rows, self.group = (torch, timer, rows,
                                                         group)
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def held(self, name, key, launch, plain, **kw):
        _held(self.torch, self.timer, self.rows, name, key, launch, plain,
              group=self.group, **kw)

    def stacked(self, cfg, nodes):
        """``nodes`` seeded students of ``cfg`` on one ``[N, R, 512]``
        plane."""
        from repro_torch.models import init_params
        from repro_torch.optim.plane import Plane, plane_from_tree
        from repro_torch.tree import tree_map
        ones = [plane_from_tree(tree_map(lambda x: x.to("cuda"),
                                         init_params(cfg, self.gen)))
                for _ in range(nodes)]
        return Plane(self.torch.stack([o.buf for o in ones]), ones[0].meta)

    def adamw(self, key, path, p):
        from repro_torch.kernels.opt_update.opt_update import \
            adamw_update_cuda
        from repro_torch.kernels.opt_update.ref import adamw_update_ref
        torch, gen = self.torch, self.gen
        shape, nodes, n = tuple(p.shape), p.shape[0], p.numel()
        g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        mu = torch.randn(shape, generator=gen, device="cuda") * 1e-4
        nu = torch.rand(shape, generator=gen, device="cuda") * 1e-7
        hp = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
        lr = torch.full((), 1e-3, device="cuda")
        step = torch.full((nodes,), 3.0, device="cuda")
        bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
        scale = torch.rand((nodes,), generator=gen,
                           device="cuda").clamp_min(0.1)
        got = [p.clone(), mu.clone(), nu.clone()]
        g_scaled = (g.reshape(nodes, -1) * scale[:, None]).reshape(shape)
        lib_step = [torch.full((), 3.0, device="cuda")]
        self.held(
            "adamw_update", key,
            lambda: (adamw_update_cuda(g, *got, lr, scale, bc1, bc2, **hp),
                     got)[1],
            lambda: adamw_update_ref(g, p, mu, nu, lr=lr, scale=scale,
                                     bc1=bc1, bc2=bc2, **hp),
            nbytes=7 * 4 * n, nops=18 * n,
            library=lambda: torch._fused_adamw_(
                [got[0]], [g_scaled], [got[1]], [got[2]], [], lib_step,
                lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01,
                eps=1e-8, amsgrad=False, maximize=False),
            path=path, shape=list(shape))

    def accum(self, key, path, nodes, batch, dim, ncls):
        from repro_torch.kernels.proto_accum.proto_accum import \
            proto_accum_cuda
        from repro_torch.kernels.proto_accum.ref import (
            proto_accum_batch_order, proto_accum_ref)
        torch, gen = self.torch, self.gen
        f1 = torch.relu(torch.randn((nodes, batch, dim), generator=gen,
                                    device="cuda"))
        labels = torch.randint(0, ncls, (nodes, batch), generator=gen,
                               dtype=torch.int32, device="cuda")
        node_cls = (torch.arange(nodes, device="cuda")[:, None] * ncls
                    + labels).reshape(-1)
        flat = f1.reshape(-1, dim)

        def library():
            sums = torch.zeros((nodes * ncls, dim), device="cuda")
            sums.index_add_(0, node_cls, flat)
            torch.bincount(node_cls, minlength=nodes * ncls)
        self.held("proto_accum", key,
                  lambda: proto_accum_cuda(f1, labels, ncls),
                  lambda: proto_accum_ref(f1, labels, ncls),
                  check=lambda: proto_accum_batch_order(f1, labels, ncls),
                  nbytes=4 * (f1.numel() + labels.numel()
                              + nodes * ncls * dim + nodes * ncls),
                  nops=f1.numel() + labels.numel(), library=library,
                  path=path, shape=list(f1.shape), classes=ncls)

    def codec(self, key, path, buf, ids, meta):
        """``rowabs`` and ``quantize_rows`` (at the payload's width) on
        every row of ``buf [N, R, 512]``; a mixed-width payload's codes
        through ``quantize_rows_mixed`` (:meth:`mixed`), as
        ``quantize_packed_buffer`` takes them."""
        from repro_torch.kernels.quantize.ops import _node_row_deltas
        from repro_torch.kernels.quantize.quantize import (quantize_rows_cuda,
                                                           rowabs_cuda)
        from repro_torch.kernels.quantize.ref import (quantize_rows_ref,
                                                      rowabs_ref)
        torch = self.torch
        n, r, c = buf.shape
        x2d = buf.reshape(-1, c).contiguous()
        m = x2d.numel()
        self.held("rowabs", key, lambda: rowabs_cuda(x2d),
                  lambda: rowabs_ref(x2d), nbytes=4 * m + 4 * n * r, nops=m,
                  library=lambda: torch.linalg.vector_norm(
                      x2d, ord=math.inf, dim=1),
                  path=path, shape=[n * r, c])
        widths = sorted({int(b) for b in meta[3]})
        if len(widths) > 1:
            self.mixed(key, path, buf, ids, meta)
            return
        zero = torch.zeros(n * r, dtype=torch.int64, device="cuda")
        for bits in widths:
            _, rd = _node_row_deltas(buf, ids, meta[1], bits, meta[3])
            rd = rd.reshape(-1, 1).contiguous()
            self.held("quantize_rows", f"{key}/int{bits}",
                      lambda: quantize_rows_cuda(x2d, rd, bits=bits),
                      lambda: quantize_rows_ref(x2d, rd, bits=bits),
                      nbytes=8 * m + 4 * n * r, nops=4 * m,
                      library=lambda: torch.quantize_per_channel(
                          x2d, rd[:, 0].contiguous(), zero, 0,
                          torch.qint32),
                      path=path, shape=[n * r, c], bits=bits)

    def roundtrip(self, key, path, tree, bits):
        """The per-leaf reference codec's route on the card
        (``kernels/quantize/ops.quantize_dequantize_tree_packed``,
        ``node_axis``): ``rowabs`` and ``quantize_dequantize_rows`` at
        ``bits`` on the tree's ``[R, 512]`` buffer, one segment a (node,
        leaf)."""
        from repro_torch.kernels.quantize.ops import (_segment_deltas,
                                                      pack_tree)
        from repro_torch.kernels.quantize.quantize import (
            quantize_dequantize_rows_cuda, rowabs_cuda)
        from repro_torch.kernels.quantize.ref import (
            quantize_dequantize_rows_ref, rowabs_ref)
        torch = self.torch
        x2d, ids, meta = pack_tree(tree, node_axis=True)
        r, c = x2d.shape
        m = x2d.numel()
        self.held("rowabs", f"{key}/per-leaf", lambda: rowabs_cuda(x2d),
                  lambda: rowabs_ref(x2d), nbytes=4 * m + 4 * r, nops=m,
                  library=lambda: torch.linalg.vector_norm(
                      x2d, ord=math.inf, dim=1),
                  path=path, shape=[r, c])
        _, rd = _segment_deltas(x2d, ids, meta[1], bits)
        rd = rd.contiguous()
        qmax = 2 ** (bits - 1) - 1
        zero = torch.zeros(r, dtype=torch.int32, device="cuda")
        self.held("quantize_dequantize_rows", f"{key}/int{bits}",
                  lambda: quantize_dequantize_rows_cuda(x2d, rd, bits=bits),
                  lambda: quantize_dequantize_rows_ref(x2d, rd, bits=bits),
                  nbytes=8 * m + 4 * r, nops=4 * m,
                  library=lambda: torch.fake_quantize_per_channel_affine(
                      x2d, rd[:, 0].contiguous(), zero, 0, -qmax - 1, qmax),
                  path=path, shape=[r, c], bits=bits)

    def mix(self, key, path, own, codes, rd, self_weight: bool = True):
        """``mix_packed`` of one receiver's own rows and its ``S``
        senders' codes (``own [1, R, 512]``, ``codes [S, R, 512]``);
        without ``self_weight``, ``w_self`` is 0 (the full-gather mean)."""
        from repro_torch.kernels.quantize.quantize import mix_packed_cuda
        from repro_torch.kernels.quantize.ref import mix_packed_ref
        torch = self.torch
        m, r, c = own.shape
        s = codes.shape[0]
        w = torch.rand((m, s + 1), generator=self.gen, device="cuda")
        if not self_weight:
            w[:, 0] = 0.0
        w = w / w.sum(dim=1, keepdim=True)
        w_self, w_rows = w[:, 0].contiguous(), w[:, 1:].contiguous()
        self.held("mix_packed", key,
                  lambda: mix_packed_cuda(own, codes, rd, w_self, w_rows),
                  lambda: mix_packed_ref(own, codes, rd, w_self, w_rows),
                  nbytes=4 * (2 * own.numel() + codes.numel() + rd.numel()
                              + w.numel()),
                  nops=m * r * c * (1 + 3 * s), path=path,
                  own=list(own.shape), codes=list(codes.shape))

    def mixed(self, key, path, buf, ids, meta):
        """``quantize_rows_mixed`` on every row of ``buf [N, R, 512]`` at
        its mixed-width payload's per-row Δ and qmax (``meta``'s segment
        widths), as ``quantize_packed_buffer`` gives them."""
        import numpy as np
        from repro_torch.kernels.quantize.ops import (_node_row_deltas,
                                                      _seg_qmax)
        from repro_torch.kernels.quantize.quantize import \
            quantize_rows_mixed_cuda
        from repro_torch.kernels.quantize.ref import quantize_rows_mixed_ref
        torch = self.torch
        n, r, c = buf.shape
        x2d = buf.reshape(-1, c).contiguous()
        _, rd = _node_row_deltas(buf, ids, meta[1], 16, meta[3])
        rd = rd.reshape(-1, 1).contiguous()
        qm = torch.as_tensor(np.tile(_seg_qmax(meta[1], 16, meta[3])[
            np.asarray(ids)], n)[:, None], device="cuda")
        m = x2d.numel()
        self.held("quantize_rows_mixed", key,
                  lambda: quantize_rows_mixed_cuda(x2d, rd, qm),
                  lambda: quantize_rows_mixed_ref(x2d, rd, qm),
                  nbytes=8 * m + 8 * n * r, nops=5 * m, path=path,
                  shape=[n * r, c],
                  bits=sorted({int(b) for b in meta[3]}))

    def wire_codes(self, buf, ids, meta):
        from repro_torch.kernels.quantize.ops import quantize_packed_buffer
        codes, scales = quantize_packed_buffer(buf, ids, meta[1],
                                               seg_bits=meta[3])
        rd = scales[:, self.torch.as_tensor(ids, dtype=self.torch.int64,
                                            device="cuda")].contiguous()
        return codes.to(self.torch.int32).contiguous(), rd


def _lowrank_library(torch, w, coeffs, b, a):
    """One ``baddbmm`` of a receiver's merge of one leaf (``w [1, *lead,
    d, k]``): ``w + [c_0·B_0 | c_1·B_1 | ...] @ [A_0; A_1; ...]`` over
    the flattened lead, TF32 off; its operands, built once."""
    s, d, k = b.shape[0], w.shape[-2], w.shape[-1]
    r = b.shape[-1]
    lead = w[0].numel() // (d * k)
    a = a[0] if a.dim() == b.dim() + 1 else a          # per receiver: N = 1
    bc = (coeffs[0].reshape((s,) + (1,) * (b.dim() - 1)) * b.float()) \
        .reshape(s, lead, d, r).permute(1, 2, 0, 3) \
        .reshape(lead, d, s * r).contiguous()
    acat = a.float().reshape(s, lead, r, k).permute(1, 0, 2, 3) \
        .reshape(lead, s * r, k).contiguous()
    return w.float().reshape(lead, d, k), bc, acat


def _adapter_rank_cases(torch, cases, rank_inputs, ring_senders, *,
                        grams_opts, specs, arch: str, path: str) -> None:
    """The adapter wire as the spawned ranks run it (``rank_inputs(**job)``
    gives every node's ``launch.wire._rank_inputs``), rank 8 at int4,
    without or with grams (``grams_opts``): ``rowabs`` and
    ``quantize_rows`` on node 0's group payload at each of ``specs``, and
    ``lowrank_apply`` on every matrix leaf of node 0's merge with its
    ring senders' factors (``ppermute``) and all nodes' (``gather`` /
    ``packed``), ``A`` shared or RegMean-adjusted per receiver; the
    merge's leaves summed into one entry a (senders, design), beside one
    ``baddbmm`` a leaf (:func:`_lowrank_library`)."""
    from repro_torch.core.aggregation import regmean_adjust
    from repro_torch.core.round_ops import adapter_share_nodes
    from repro_torch.kernels.lowrank_apply.lowrank_apply import \
        lowrank_apply_cuda
    from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref
    from repro_torch.kernels.quantize.ops import pack_tree_nodes
    from repro_torch.optim.plane import _leaf_view
    from repro_torch.wirespec import WireSpec

    gen = cases.gen
    for grams in grams_opts:
        tag = "adapters8+grams" if grams else "adapters8"
        ins = rank_inputs(bits="4", adapter_rank=8, adapter_grams=grams)
        nodes = len(ins)
        groups = []
        for students, prot, _, _, carry in ins:
            ast = dict(carry[0], ref={
                k: v + 1e-3 * torch.randn(v.shape, generator=gen,
                                          device="cuda")
                for k, v in carry[0]["ref"].items()})
            g, _, layout = adapter_share_nodes(students, ast, rank=8,
                                               grams=grams)
            groups.append((g, prot))
        for spec in specs:
            buf, ids, meta = pack_tree_nodes(
                dict(groups[0][0], protos=groups[0][1]),
                WireSpec.parse(spec))
            cases.codec(f"{arch}/{tag}/{spec}", path, buf, ids, meta)
        # a receiver's merge: every matrix leaf of node 0 through one
        # launch with its senders' factors
        w_plane = ins[0][0].buf
        for s, senders in ((2, ring_senders), (nodes, list(range(nodes)))):
            coeffs = torch.rand((1, s), generator=gen, device="cuda") / s
            leaf_cases = []
            for name, is_mat, (_, _, shape, row, r_leaf) in zip(
                    layout.names, layout.is_mat, ins[0][0].meta.recipe):
                if not is_mat:
                    continue
                w = _leaf_view(w_plane, shape, row, r_leaf).contiguous()
                b = torch.cat([groups[j][0]["adapters"][name]["B"]
                               for j in senders]).float().contiguous()
                a = torch.cat([groups[j][0]["adapters"][name]["A"]
                               for j in senders]).float()
                if grams:
                    gr = torch.cat([groups[j][0]["grams"][name]
                                    for j in senders])
                    a = regmean_adjust(a[None], gr[None], coeffs,
                                       per_recv=True)
                leaf_cases.append((w, b, a.contiguous()))
            design = "per_recv" if grams else "shared"
            launches = [lambda w=w, b=b, a=a: lowrank_apply_cuda(
                w, coeffs, b, a) for w, b, a in leaf_cases]
            plains = [lambda w=w, b=b, a=a: lowrank_apply_ref(
                w, coeffs, b, a) for w, b, a in leaf_cases]
            libs = [_lowrank_library(torch, w, coeffs, b, a)
                    for w, b, a in leaf_cases]
            d_k = [(w.shape[-2], w.shape[-1], w[0].numel() // (
                w.shape[-2] * w.shape[-1])) for w, _, _ in leaf_cases]
            cases.held(
                "lowrank_apply", f"{arch}/{design}/S{s}",
                lambda: [f() for f in launches],
                lambda: [f() for f in plains],
                nbytes=sum(4 * (2 * w.numel() + coeffs.numel() + b.numel()
                                + a.numel()) for w, b, a in leaf_cases),
                nops=sum(lead * d * k * (2 * 8 * s + 2 * s + 1)
                         if not grams else lead * s * d * k * (2 * 8 + 2)
                         for d, k, lead in d_k),
                library=lambda: [torch.baddbmm(*x) for x in libs],
                path=path, receiver_leaves=len(leaf_cases),
                senders=s, design=design,
                shape=[list(w.shape) for w, _, _ in leaf_cases])
        del groups, buf


def check_example_shapes(torch, timer, rows) -> None:
    """Phase 3 at the shapes the examples phase (14d) gives six kernels
    and no other check holds, each case bit for bit its plain version and
    timed into its row under ``example_shapes``:

    * rows 1-4 on the 4-node mnist-cnn federation of the quickstart and
      the ablations: ``adamw_update`` on the ``[4, 416, 512]`` plane,
      ``proto_accum`` on ``f1 [4, 64, 128]``, ``rowabs`` and
      ``quantize_rows`` on the ``[1664, 512]`` payload at 16, 8 and 32
      bits (the ablations' wires), and on one node's ``[416, 512]`` at
      16 and 4 bits (the suite's mnist-cnn ranks);
    * rows 1-4 on the ResNet8 students of the CIFAR driver (3 nodes) and
      the topology sweep (4 nodes), and rows 3, 4 and 11 on one sweep
      node's payload as the audit's ranks quantize and mix it (``S``
      senders for each of the sweep's single-phase topologies and
      exchanges);
    * on yi-6b's smoke student as the topology suite's (and the mesh
      demo's) ranks build it (``launch.wire._rank_inputs``): ``rowabs``
      and ``quantize_rows`` on a node's int4 / 16-bit adapter payload
      (with and without grams) and its dense int4 / 16-bit plane
      payload, ``mix_packed`` on that plane with 1 (the demo's star), 2
      (ring) and 8 (packed) senders' codes and on the demo's FedAvg
      round (2 fp32 teacher planes), and ``lowrank_apply`` on every
      matrix leaf of a receiver's
      merge: 2 senders (ppermute) or 8 (gather / packed), ``A`` shared
      or RegMean-adjusted per receiver (``--adapter-grams``).  The
      merge's leaves are summed into one entry a (senders, design),
      beside one ``baddbmm`` a leaf (:func:`_lowrank_library`)."""
    from repro_torch.config import get_config
    from repro_torch.core import topology as T
    from repro_torch.kernels.quantize.ops import pack_plane_payload
    from repro_torch.launch.wire import _config as _wire_config
    from repro_torch.launch.wire import _rank_inputs
    from repro_torch.models import derive_student
    from repro_torch.optim.plane import Plane
    from repro_torch.wirespec import WireSpec

    cases = ShapeCases(torch, timer, rows, "example_shapes", 31)
    gen = cases.gen

    # -- the quickstart's and the ablations' 4 mnist-cnn nodes ------------
    mnist = get_config("mnist-cnn")
    plane = cases.stacked(derive_student(mnist), 4)
    cases.adamw("mnist/4", "quickstart, ablations", plane.buf)
    cases.accum("mnist/4", "quickstart, ablations", 4, QUICKSTART_BATCH,
                mnist.proto_dim, mnist.num_classes)
    protos = torch.rand((4, mnist.num_classes, mnist.proto_dim),
                        generator=gen, device="cuda")
    for bits in (16, 8, 32):
        buf, ids, meta, _, _ = pack_plane_payload(
            protos, plane, WireSpec.from_bits(bits))
        cases.codec(f"mnist/4/{bits}", "quickstart, ablations", buf, ids,
                    meta)
    # one node's payload as the suite's mnist-cnn ranks quantize it
    for spec in ("16", "4"):
        buf, ids, meta, _, _ = pack_plane_payload(
            protos[:1], Plane(plane.buf[:1], plane.meta),
            WireSpec.parse(spec))
        cases.codec(f"mnist/rank/{spec}", "dryrun-topo", buf, ids, meta)
    del plane, buf

    # -- ResNet8: the CIFAR driver's 3 nodes and the sweep's 4 -------------
    cifar = get_config("cifar10-resnet18")
    res8 = derive_student(cifar)
    for n_res, path in ((3, "dfl"), (4, "sweep")):
        plane = cases.stacked(res8, n_res)
        cases.adamw(f"resnet8/{n_res}", path, plane.buf)
        cases.accum(f"resnet8/{n_res}", path, n_res, CIFAR_BATCH,
                    res8.proto_dim, cifar.num_classes)
        protos = torch.rand((n_res, cifar.num_classes, res8.proto_dim),
                            generator=gen, device="cuda")
        buf, ids, meta, _, _ = pack_plane_payload(protos, plane,
                                                  WireSpec(16))
        cases.codec(f"resnet8/{n_res}", path, buf, ids, meta)
    # one sweep node's payload as the audit's ranks quantize and mix it:
    # 2 senders (ring, random-k2), 3 (full, ppermute), 4 (packed)
    cases.codec("resnet8/rank", "sweep", buf[:1], ids, meta)
    codes, rd = cases.wire_codes(buf, ids, meta)
    for senders in ([1, 3], [1, 2, 3], [0, 1, 2, 3]):
        cases.mix(f"resnet8/S{len(senders)}", "sweep", buf[:1].contiguous(),
                  codes[senders].contiguous(), rd[senders].contiguous())
    del plane, buf, codes

    # -- yi-6b's smoke student as the suite's ranks build it ---------------
    nodes = 8

    def rank_inputs(**job):
        job = dict(dict(arch="yi-6b", n_nodes=nodes, topology="ring",
                        bits="4", seed=0, inner=1, adapter_rank=0,
                        adapter_grams=False, device="cuda"), **job)
        return [_rank_inputs(job, i, torch.device("cuda"))
                for i in range(nodes)]

    ring = T.make_schedule(nodes, "ring", rounds=1, seed=0).adjacency_at(0)
    ring_senders = sorted(T.neighbors(ring, 0))          # receiver node 0
    # the dense plane payload at int4 (the suite's dense reference) and
    # 16 bits (the mesh demo's ring of 8)
    ins = rank_inputs()
    plane = Plane(torch.cat([s.buf for s, *_ in ins]), ins[0][0].meta)
    protos = torch.cat([p for _, p, *_ in ins])
    for bits in (4, 16):
        buf, ids, meta, _, _ = pack_plane_payload(protos, plane,
                                                  WireSpec.from_bits(bits))
        cases.codec(f"yi-6b/plane/{bits}", "dryrun-topo, mesh-demo",
                    buf[:1], ids, meta)
        codes, rd = cases.wire_codes(buf, ids, meta)
        # the demo's star (1 sender), the ring (2) and packed (8)
        for senders in ([1], ring_senders, list(range(nodes))):
            cases.mix(f"yi-6b/plane/{bits}/S{len(senders)}",
                      "dryrun-topo, mesh-demo", buf[:1].contiguous(),
                      codes[senders].contiguous(), rd[senders].contiguous())
    del plane, buf, codes
    # the demo's FedAvg round: 2 nodes' fp32 teacher planes at unit Δ
    teacher = cases.stacked(_wire_config("yi-6b"), 2).buf
    cases.mix("yi-6b/fedavg", "mesh-demo", teacher[:1].contiguous(),
              teacher, torch.ones(teacher.shape[:2], device="cuda"))
    del teacher
    # the int4 adapter wire, without and with grams
    _adapter_rank_cases(torch, cases, rank_inputs, ring_senders,
                        grams_opts=(False, True), specs=("4", "16"),
                        arch="yi-6b", path="dryrun-topo")
    torch.cuda.empty_cache()


# the paper phase's new kernel shapes: (key, model, nodes, path) of each
# stacked plane rows 1, 3 and 4 see (table2's 4 nodes, table3's 3)
PAPER_PLANES = (("cifar100/4", "cifar100-resnet32", 4, "table2"),
                ("cifar100/3", "cifar100-resnet32", 3, "table3"),
                ("mnist/3", "mnist-cnn", 3, "table3"))
PAPER_BATCH = 64                # the paper scripts' TrainConfig batch


def check_paper_shapes(torch, timer, rows) -> None:
    """Phase 3 at the shapes the paper phase gives rows 1-4 and no
    earlier check holds, each case bit for bit its plain version and
    timed into its row under ``paper_shapes`` (``PAPER_PLANES``):
    ``adamw_update`` on cifar100-resnet32's student plane (ResNet18 at
    width 64, ``[N, 22144, 512]``) for 3 and 4 nodes and on mnist-cnn's
    for 3; ``proto_accum`` on ``f1 [N, 64, 256]`` at C = 100 (the
    ProFe, FedProto and FedGPD Eq. 3 pass) and ``[3, 64, 128]`` at C =
    10; ``rowabs`` and ``quantize_rows`` on each plane's 16-bit
    payload.  And rows 8 and 11 as table2's ``--physical`` ranks run
    them (mnist-cnn, ``PAPER_PHYSICAL_NODES`` nodes on the full graph,
    each rank's inputs as ``launch.wire._rank_inputs`` draws them):
    ``quantize_rows_mixed`` on one node's ``4/16`` payload, and
    ``mix_packed`` of a receiver's rows with its 3 senders' codes
    (``ppermute``) and all 4 nodes' (``packed``; ``w_self`` 0 in the
    full-gather reference), at ``16`` and ``4/16``."""
    from repro_torch.config import get_config
    from repro_torch.kernels.quantize.ops import pack_plane_payload
    from repro_torch.launch.wire import _rank_inputs
    from repro_torch.models import derive_student
    from repro_torch.optim.plane import Plane
    from repro_torch.wirespec import WireSpec

    cases = ShapeCases(torch, timer, rows, "paper_shapes", 32)
    for key, model, nodes, path in PAPER_PLANES:
        cfg = get_config(model)
        scfg = derive_student(cfg)
        plane = cases.stacked(scfg, nodes)
        cases.adamw(key, path, plane.buf)
        cases.accum(key, path, nodes, PAPER_BATCH, scfg.proto_dim,
                    cfg.num_classes)
        protos = torch.rand((nodes, cfg.num_classes, scfg.proto_dim),
                            generator=cases.gen, device="cuda")
        buf, ids, meta, _, _ = pack_plane_payload(protos, plane,
                                                  WireSpec(16))
        cases.codec(key, path, buf, ids, meta)
        del plane, buf
        torch.cuda.empty_cache()

    # -- table2 --physical: the mnist-cnn ranks' codec and mixes ----------
    nodes = PAPER_PHYSICAL_NODES
    for bits in PAPER_PPERMUTE:
        job = dict(arch="mnist-cnn", n_nodes=nodes, bits=bits, seed=0,
                   adapter_rank=0, adapter_grams=False)
        ins = [_rank_inputs(job, i, torch.device("cuda"))
               for i in range(nodes)]
        plane = Plane(torch.cat([s.buf for s, *_ in ins]), ins[0][0].meta)
        protos = torch.cat([p for _, p, *_ in ins])
        buf, ids, meta, _, _ = pack_plane_payload(protos, plane,
                                                  WireSpec.parse(bits))
        key = f"mnist/rank/{bits}"
        if len({int(b) for b in meta[3]}) > 1:
            cases.mixed(key, "table2 --physical", buf[:1].contiguous(), ids,
                        meta)
        codes, rd = cases.wire_codes(buf, ids, meta)
        own = buf[:1].contiguous()
        cases.mix(f"{key}/S3", "table2 --physical (ppermute)", own,
                  codes[1:].contiguous(), rd[1:].contiguous())
        for self_weight, tag in ((True, "S4"), (False, "S4/w_self0")):
            cases.mix(f"{key}/{tag}", "table2 --physical (packed)", own,
                      codes, rd, self_weight=self_weight)
        del plane, buf, codes


# the round-step phase's reduced mnist-cnn (benchmarks/torch_round_step.py
# _setup): teacher channels, node counts, batch and samples a node
ROUND_STEP_CHANNELS = (8, 16)
ROUND_STEP_NODES = (2, 4, 8)
ROUND_STEP_BATCH = 8
ROUND_STEP_SAMPLES = 32
ADAPTER_RANK = 8                  # the apply pair's and the wire rows' rank


def _lowrank_library_nodes(torch, w, coeffs, b, a):
    """One ``baddbmm`` of every receiver's merge of one leaf (``w [N, d,
    k]``, ``A`` shared over receivers): ``w_i + [c_i0·B_0 | c_i1·B_1 |
    ...] @ [A_0; A_1; ...]``, batched over receivers, TF32 off; its
    operands, built once."""
    n, s = coeffs.shape
    d, r = b.shape[-2], b.shape[-1]
    bc = (coeffs[:, :, None, None] * b[None]).permute(0, 2, 1, 3) \
        .reshape(n, d, s * r).contiguous()
    acat = a.reshape(s * r, -1)[None].expand(n, -1, -1)
    return w, bc, acat


def check_round_step_shapes(torch, timer, rows) -> None:
    """Phase 3 at the shapes the round-step phase (14f) gives rows 1-4 and
    16, each case bit for bit its plain version and timed into its row
    under ``round_step_shapes``, at N = 2, 4 and 8 of the script's reduced
    mnist-cnn (``ROUND_STEP_CHANNELS``: a ``[N, 112, 512]`` student
    plane): ``adamw_update`` on the plane, ``proto_accum`` on ``f1 [N, 8,
    128]`` at C = 10, ``rowabs`` and ``quantize_rows`` on the plane's
    16-bit payload, and ``lowrank_apply`` on the apply pair's fused side
    (``adapter_apply_plane``): every matrix leaf of the plane (fc1 ``[N,
    392, 128]``, fc2 ``[N, 128, 10]``) with rank-8 factors of its delta
    against 0.9× the weights and the full graph's ``w_neigh`` as
    coefficients, ``A`` shared; the leaves summed into one entry a node
    count beside one ``baddbmm`` a leaf (:func:`_lowrank_library_nodes`).
    Then ``proto_accum`` on the seed loop's one-node ``f1 [1, 8, 128]`` at
    C = 10, and ``--wire`` on 8 full-width mnist-cnn nodes: the codec
    pair on ``benchmarks/torch_round_step.codec_payload`` at each
    ``ROUND_STEP_WIRE`` row (the per-leaf side's ``rowabs`` and
    ``quantize_dequantize_rows`` on its ``[R, 512]`` tree buffer at a
    uniform width, the packed side's ``rowabs`` and ``quantize_rows`` or
    ``quantize_rows_mixed`` on its ``[8, R, 512]`` buffer), and the
    spawned ranks' shapes (``launch.wire._rank_inputs``): ``rowabs`` and
    ``quantize_rows`` / ``quantize_rows_mixed`` on one node's plane
    payload, ``mix_packed`` of a receiver's rows with its 2 ring
    senders' codes (``ppermute``) and all 8 nodes' (``packed``; ``w_self``
    0 in the full-gather reference), and the adapter row's group codec
    and merges (:func:`_adapter_rank_cases`)."""
    from repro_torch.config import get_config
    from repro_torch.core import topology as T
    from repro_torch.core.adapters import (adapter_layout, factorize_deltas,
                                           split_student)
    from repro_torch.core.round_ops import gossip_matrix
    from repro_torch.kernels.lowrank_apply.lowrank_apply import \
        lowrank_apply_cuda
    from repro_torch.kernels.lowrank_apply.ref import lowrank_apply_ref
    from repro_torch.kernels.quantize.ops import (pack_plane_payload,
                                                  pack_tree_nodes)
    from repro_torch.launch.wire import _rank_inputs
    from repro_torch.models import derive_student
    from repro_torch.optim.plane import Plane, as_tree
    from repro_torch.wirespec import WireSpec

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks.torch_round_step import codec_payload

    cfg = get_config("mnist-cnn").replace(cnn_channels=ROUND_STEP_CHANNELS)
    scfg = derive_student(cfg)
    cases = ShapeCases(torch, timer, rows, "round_step_shapes", 33)
    for n in ROUND_STEP_NODES:
        key = f"reduced/{n}"
        plane = cases.stacked(scfg, n)
        cases.adamw(key, "round-step", plane.buf)
        cases.accum(key, "round-step", n, ROUND_STEP_BATCH, scfg.proto_dim,
                    cfg.num_classes)
        protos = torch.rand((n, cfg.num_classes, scfg.proto_dim),
                            generator=cases.gen, device="cuda")
        buf, ids, meta, _, _ = pack_plane_payload(protos, plane,
                                                  WireSpec(16))
        cases.codec(key, "round-step", buf, ids, meta)

        views = as_tree(plane)
        layout = adapter_layout(views, ADAPTER_RANK, node_axis=True)
        mats, _ = split_student(layout, views)
        factors = factorize_deltas(layout, mats,
                                   {k: 0.9 * v for k, v in mats.items()})
        w_neigh = torch.as_tensor(gossip_matrix(
            T.adjacency(n, "full"), [ROUND_STEP_SAMPLES] * n)[1],
            device="cuda")
        leaf_cases = [(mats[name].contiguous(),
                       factors[name]["B"].contiguous(),
                       factors[name]["A"].contiguous())
                      for name in layout.mat_names]
        launches = [lambda w=w, b=b, a=a: lowrank_apply_cuda(
            w, w_neigh, b, a) for w, b, a in leaf_cases]
        plains = [lambda w=w, b=b, a=a: lowrank_apply_ref(w, w_neigh, b, a)
                  for w, b, a in leaf_cases]
        libs = [_lowrank_library_nodes(torch, w, w_neigh, b, a)
                for w, b, a in leaf_cases]
        cases.held(
            "lowrank_apply", key,
            lambda: [f() for f in launches], lambda: [f() for f in plains],
            nbytes=sum(4 * (2 * w.numel() + w_neigh.numel() + b.numel()
                            + a.numel()) for w, b, a in leaf_cases),
            # each B_j @ A_j once, then every receiver's weighted sum
            nops=sum(w.shape[-2] * w.shape[-1] * (2 * ADAPTER_RANK * n
                                                  + 2 * n * n + n)
                     for w, _, _ in leaf_cases),
            library=lambda: [torch.baddbmm(*x) for x in libs],
            path="round-step (apply_fused)", receivers=n, senders=n,
            design="shared", receiver_leaves=len(leaf_cases),
            shape=[list(w.shape) for w, _, _ in leaf_cases])
        del plane, buf

    # -- the seed loop's Eq. 3 pass: one node's batch ---------------------
    cases.accum("reduced/seed", "round-step (seed loop)", 1,
                ROUND_STEP_BATCH, scfg.proto_dim, cfg.num_classes)

    # -- --wire: the codec pair on 8 full-width mnist-cnn nodes ------------
    nodes = ROUND_STEP_WIRE_NODES
    for label in ROUND_STEP_WIRE:
        bits, _, rank = label.partition("+adapters")
        spec = WireSpec.parse(bits)
        payload = codec_payload(nodes, adapter_rank=int(rank or 0),
                                device="cuda")
        key = f"wire/{label}"
        if spec.uniform_bits is not None:
            cases.roundtrip(key, "round-step --wire codec (per-leaf)",
                            payload, spec.uniform_bits)
        buf, ids, meta = pack_tree_nodes(payload, spec)
        cases.codec(key, "round-step --wire codec (packed)", buf, ids, meta)
        del payload, buf

    # -- --wire's spawned ranks: a node's payload and a receiver's mixes ---
    def rank_inputs(**job):
        job = dict(dict(arch="mnist-cnn", n_nodes=nodes, topology="ring",
                        bits="16", seed=0, inner=1, adapter_rank=0,
                        adapter_grams=False, device="cuda"), **job)
        return [_rank_inputs(job, i, torch.device("cuda"))
                for i in range(nodes)]

    ring = T.make_schedule(nodes, "ring", rounds=1, seed=0).adjacency_at(0)
    ring_senders = sorted(T.neighbors(ring, 0))          # receiver node 0
    path = "round-step --wire ranks"
    for bits in (b for b in ROUND_STEP_WIRE if "+" not in b):
        ins = rank_inputs(bits=bits)
        plane = Plane(torch.cat([s.buf for s, *_ in ins]), ins[0][0].meta)
        protos = torch.cat([p for _, p, *_ in ins])
        buf, ids, meta, _, _ = pack_plane_payload(protos, plane,
                                                  WireSpec.parse(bits))
        key = f"wire/rank/{bits}"
        own = buf[:1].contiguous()
        cases.codec(key, path, own, ids, meta)
        codes, rd = cases.wire_codes(buf, ids, meta)
        cases.mix(f"{key}/S2", f"{path} (ppermute)", own,
                  codes[ring_senders].contiguous(),
                  rd[ring_senders].contiguous())
        for self_weight, tag in ((True, "S8"), (False, "S8/w_self0")):
            cases.mix(f"{key}/{tag}", f"{path} (packed, full-gather)", own,
                      codes, rd, self_weight=self_weight)
        del ins, plane, buf, codes
    _adapter_rank_cases(torch, cases, rank_inputs, ring_senders,
                        grams_opts=(False,), specs=("4",), arch="mnist-cnn",
                        path=path)
    torch.cuda.empty_cache()


def check_plane_sweeps(torch, timer, student_cfg):
    """Phase 3, the sgd and adafactor sweeps: each kernel against its
    plain version on 20 nodes' ResNet8 student planes ``[20, 208, 512]``
    (the CIFAR paths' shape), bit for bit, and timed; adafactor also bit
    for bit on a flat buffer that starts one element in (2,129,919
    elements: a scalar head), and timed beside a streaming yardstick
    (``torch.add(p, upd, out=p)``: the same bytes in one launch)."""
    from dataclasses import asdict
    from repro_torch.kernels.opt_update.opt_update import (
        adafactor_apply_cuda, adafactor_plan, sgd_update_cuda)
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
    masked_ms, masked = masked_sweep_cases(
        torch, timer, "sgd_update",
        lambda pp, mm, active: sgd_update_cuda(g, pp, mm, lr, scale,
                                               active=active, **hp),
        lambda active: sgd_update_ref(g, p, mu, lr=lr, scale=scale,
                                      active=active, **hp),
        [p, mu])
    print(f"sgd_update: {ms:.4f} ms unmasked, {masked_ms:.4f} ms masked")
    b_ms, b_by = bound(5 * 4 * n, 7 * n)
    rows.append(dict(name="sgd_update", route="cuda",
                     source="src/repro_torch/csrc/opt_update.cu",
                     replaces="src/repro/kernels/opt_update/opt_update.py:40",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     masked_ms=masked_ms, masked_cases=masked))

    # the packed clipped update of adafactor: about ±1 on the real lanes
    upd = torch.randn(shape, generator=gen).cuda() * real
    plan = adafactor_plan(n, upd.data_ptr() // 4 % 4, p.data_ptr() // 4 % 4)
    want = adafactor_apply_ref(upd, p, lr=lr, weight_decay=0.01)
    got = p.clone()
    adafactor_apply_cuda(upd, got, lr, weight_decay=0.01)
    torch.cuda.synchronize()
    ulps = ulp_diff(torch, got, want)
    err = float((got - want).abs().max())
    print(f"adafactor_apply {shape}: max |kernel - plain| = {err:.3e}, max "
          f"ulp difference {ulps} (plan {plan})")
    expect(ulps == 0,
           "adafactor_apply kernel is not bit-exact with its plain version")
    # a flat buffer that starts one element in, n - 1 long: a scalar head
    # of 3 and a body of whole vectors behind it
    flat_p = torch.cat([torch.zeros(1, device="cuda"), p.flatten()])[1:-1]
    flat_u = torch.cat([torch.zeros(1, device="cuda"), upd.flatten()])[1:-1]
    off_plan = adafactor_plan(flat_p.numel(), flat_u.data_ptr() // 4 % 4,
                              flat_p.data_ptr() // 4 % 4)
    off_want = adafactor_apply_ref(flat_u, flat_p, lr=lr, weight_decay=0.01)
    off_got = torch.cat([torch.zeros(1, device="cuda"), flat_p])[1:]
    adafactor_apply_cuda(flat_u, off_got, lr, weight_decay=0.01)
    torch.cuda.synchronize()
    off_ulps = ulp_diff(torch, off_got, off_want)
    print(f"adafactor_apply offset 1, n = {flat_p.numel()}: max ulp "
          f"difference {off_ulps} (plan {off_plan})")
    expect(off_ulps == 0, "adafactor_apply is not bit-exact at an offset")
    expect((off_plan.vec, off_plan.head) == (4, 3),
           f"the offset case took no scalar head: {off_plan}")
    ms = timer(lambda: adafactor_apply_cuda(upd, got, lr, weight_decay=0.01))
    plain_ms = timer(lambda: adafactor_apply_ref(upd, p, lr=lr,
                                                 weight_decay=0.01))
    # library yardstick: PyTorch's fused SGD without momentum computes the
    # same function, p - lr·(upd + wd·p), in one call
    lib = [p.clone()]
    lib_ms = timer(lambda: torch._fused_sgd_(
        lib, [upd], [], weight_decay=0.01, momentum=0.0, lr=1e-3,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False))
    # streaming yardstick: one launch that moves the same 3 x 4 B an
    # element (reads p and upd, writes p)
    stream_ms = timer(lambda: torch.add(got, upd, out=got))
    masked_ms, masked = masked_sweep_cases(
        torch, timer, "adafactor_apply",
        lambda pp, active: adafactor_apply_cuda(upd, pp, lr,
                                                weight_decay=0.01,
                                                active=active),
        lambda active: [adafactor_apply_ref(upd, p, lr=lr, weight_decay=0.01,
                                            active=active)],
        [p])
    print(f"adafactor_apply: {ms:.4f} ms unmasked, {masked_ms:.4f} ms "
          f"masked")
    b_ms, b_by = bound(3 * 4 * n, 4 * n)
    rows.append(dict(name="adafactor_apply", route="cuda",
                     source="src/repro_torch/csrc/opt_update.cu",
                     replaces="src/repro/kernels/opt_update/opt_update.py:120",
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     stream_ms=stream_ms, plan=asdict(plan),
                     cases=[list(shape), [off_got.numel()]],
                     masked_ms=masked_ms, masked_cases=masked))
    print(f"  adafactor_apply streaming yardstick (torch.add, out=p) "
          f"{stream_ms:.4f} ms")
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


def fused_cases(torch, teacher):
    """The whole-tensor codec's cases in phase 3: ``(what, x, bits)``.
    The teacher's leaf first (its row's times); mnist-cnn's fc1, conv2
    and fc2-bias leaves; a view at element offset 1 (2,359,297 elements,
    not on 16 bytes); 12,582,912 elements (48 MB, more than the grid
    stages) at widths 16 and 4; all zeros; an absmax that is a negative
    element's magnitude."""
    from repro_torch.config import get_config
    from repro_torch.models import derive_student, init_params
    from repro_torch.tree import tree_leaves
    gen = torch.Generator().manual_seed(5)
    leaves = {tuple(t.shape): t for t in tree_leaves(init_params(
        derive_student(get_config("mnist-cnn")), gen))}
    view = torch.randn(2359298, generator=gen).cuda()[1:]
    big = torch.randn(12582912, generator=gen).cuda()
    neg = torch.rand((1568, 128), generator=gen).cuda()
    neg[700, 3] = -2.0
    expect(view.storage_offset() == 1 and view.data_ptr() % 16 == 4,
           "the offset-1 view is on 16 bytes")
    expect(float(neg.min()) == -float(neg.abs().max()),
           "the negative case's absmax is not a negative's")
    return ([("teacher", teacher, 16)]
            + [(f"mnist-cnn {list(s)}", leaves[s].cuda(), 16)
               for s in ((1568, 128), (3, 3, 16, 32), (10,))]
            + [("offset-1 view", view, 16), ("48 MB", big, 16),
               ("48 MB", big, 4),
               ("all zero", torch.zeros((1568, 128), device="cuda"), 16),
               ("negative absmax", neg, 16)])


def on_card_at(torch, t, off: int):
    """A contiguous copy of ``t`` on the card whose first element lies
    ``off`` elements into its storage (4·off bytes past a 16-byte
    address)."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device="cuda")
    view = buf[off:].view(t.shape)
    view.copy_(t)
    expect(view.storage_offset() == off, f"offset {off} not kept")
    return view


def mixed_bits(torch, rows: int):
    """Per-row widths ``[rows, 1]`` of a mixed-width edge case: 4, 8 and
    16 bits in runs of three rows, so each width meets each of
    :func:`edge_rows`' row patterns."""
    return torch.tensor((4, 8, 16))[(torch.arange(rows) // 3) % 3][:, None]


def edge_rows(torch, gen, rows: int, cols: int, bits,
              zero: bool = False):
    """``([rows, cols] fp32, [rows, 1] Δ)`` on the card for the row
    codec's edge cases: Δ from each row's absmax; on rows 1, 4, 7, ... Δ
    rounded down to a power of two and every third column on an exact
    half-step ``(k + 1/2)·Δ``, k over the whole code range (so the codes
    round half up, and ``qmax + 1/2`` clips); on rows 2, 5, 8, ... Δ a
    quarter of that (codes beyond ±qmax clip).  ``bits`` is one width, or
    a ``[rows, 1]`` tensor of each row's (:func:`mixed_bits`).  ``zero``:
    all zeros at the least normal Δ."""
    tiny = torch.finfo(torch.float32).tiny
    if zero:
        return (torch.zeros((rows, cols), device="cuda"),
                torch.full((rows, 1), tiny, device="cuda"))
    qm = (1 << (bits - 1)) - 1
    x = torch.randn((rows, cols), generator=gen) * 3
    delta = (x.abs().amax(1, keepdim=True) / qm).clamp_min(tiny)
    delta[1::3] = torch.exp2(torch.floor(torch.log2(delta[1::3])))
    if isinstance(bits, int):
        k = torch.randint(-qm - 1, qm + 1, (rows, cols), generator=gen)
    else:       # per-row code ranges
        k = torch.floor(torch.rand((rows, cols), generator=gen)
                        * (2 * qm + 2)) - qm - 1
    half = (k.float() + 0.5) * delta
    x[1::3, ::3] = half[1::3, ::3]
    delta[2::3] /= 4
    return x.cuda(), delta.cuda()


def row_codec_cases(torch, name: str):
    """Phase 3's edge cases of one entry point of the row codec
    (``quantize_rows``, ``quantize_rows_mixed``,
    ``quantize_dequantize_rows`` or ``dequantize_rows``), each held bit
    for bit to its plain version:
    the input at storage offsets 1-3 (so input and output at different
    offsets), 510 and 10 columns, one row, 70,000 rows and 600,000 rows
    of 8 (beyond 65,535 row tiles: two rows a thread), widths 16, 8 and
    4 with exact half-steps and codes beyond ±qmax (:func:`edge_rows`),
    all zeros, and through the C entry point the output at offsets 1-3
    (input at the same offset and at another) and both at offset 4 (on
    16 bytes); ``dequantize_rows`` also at codes over the whole int32
    range; ``quantize_rows_mixed`` at each row's own width, 4, 8 and 16
    bits in runs of three rows (:func:`mixed_bits`; its ``int{bits}``
    cases are the uniform widths as a qmax column).  Returns the cases
    with the plan each took."""
    from repro_torch.kernels.quantize import quantize as Q
    from repro_torch.kernels.quantize import ref as R
    wrapper, plain = getattr(Q, f"{name}_cuda"), getattr(R, f"{name}_ref")
    dequant = name == "dequantize_rows"
    mixed = name == "quantize_rows_mixed"
    gen = torch.Generator().manual_seed(6)
    cases = []

    def held(what, rows, cols, bits=16, x_off=0, out_off=None, zero=False,
             full_range=False):
        if mixed and what[:3] != "int":
            bits = mixed_bits(torch, rows)
        x, rd = edge_rows(torch, gen, rows, cols, bits, zero)
        if mixed:
            col = torch.full((rows, 1), bits) if isinstance(bits, int) \
                else bits
            qm = ((1 << (col - 1)) - 1).float().cuda()
            args, launch = (qm,), (qm.data_ptr(),)
        elif dequant:
            args, launch = (), ()
        else:
            args, launch = (), (Q._qmaxf(bits),)
        kw = {} if dequant or mixed else dict(bits=bits)
        if full_range:
            x = torch.randint(-2 ** 31, 2 ** 31, (rows, cols), generator=gen,
                              dtype=torch.int32).cuda()
        elif dequant:
            x = R.quantize_rows_ref(x, rd, bits=bits)
        x = on_card_at(torch, x, x_off)
        want = plain(x, rd, *args, **kw)
        if out_off is None:
            got = wrapper(x, rd, *args, **kw)
        else:
            got = on_card_at(torch, torch.full_like(want, -1), out_off)
            Q._row_codec(name, x, rd, got, *launch)
        torch.cuda.synchronize()
        expect(bits_equal(torch, got, want),
               f"{name} is not bit-exact with its plain version at {what}")
        plan = Q.rows_plan(rows, cols, x.data_ptr() % 16 == 0
                           and got.data_ptr() % 16 == 0)
        if not isinstance(bits, int):
            bits = "4/8/16 by row"
        cases.append(dict(case=what, shape=[rows, cols], bits=bits,
                          x_offset=x.storage_offset(),
                          out_offset=got.storage_offset(), vec=plan.vec,
                          block=list(plan.block), grid=list(plan.grid),
                          rows_a_thread=plan.rows_a_thread))
        return plan

    for off in (1, 2, 3):
        expect(held(f"x at offset {off}", 257, 512, x_off=off).vec == 1,
               f"{name}: x off 16 bytes took 16-byte vectors")
    for cols in (510, 10):
        expect(held(f"{cols} columns", 257, cols).vec == 1,
               f"{name}: {cols} columns took 16-byte vectors")
    held("one row", 1, 512)
    held("one row of 10", 1, 10)
    held("70,000 rows of 8", 70000, 8)
    expect(held("600,000 rows of 8", 600000, 8).rows_a_thread == 2,
           f"{name}: 600,000 rows took no row stride")
    for bits in (16, 8, 4):
        expect(held(f"int{bits}", 257, 512, bits=bits).vec == 4,
               f"{name}: an aligned buffer took one column a thread")
    held("all zeros", 257, 512, zero=True)
    for off in (1, 2, 3):
        held(f"x and out at offset {off}", 257, 512, x_off=off, out_off=off)
        held(f"out at offset {off}", 257, 512, out_off=off)
    expect(held("x and out at offset 4", 257, 512, x_off=4,
                out_off=4).vec == 4,
           f"{name}: 16-byte aligned views took one column a thread")
    if dequant:
        held("int32 range", 257, 512, full_range=True)
    print(f"{name}: bit-exact at {len(cases)} edge cases")
    return cases


def dequantize_cases(torch):
    """Phase 3's edge cases of ``dequantize``, each held bit for bit to
    its plain version: n of 1 to 7, codes at offsets 1-3 (so codes and
    out at different offsets: one element a vector), through the C
    entry point codes and out at the same offset 1-3 (a scalar head)
    at 100,003 elements and at n of 1 to 7, codes and out at offsets 1
    and 2, all zeros, and codes over the whole int32 range.  Returns the
    cases with the split each took."""
    from repro_torch.kernels.quantize import quantize as Q
    from repro_torch.kernels.quantize.ref import dequantize_ref
    gen = torch.Generator().manual_seed(7)
    delta = torch.tensor(3.0517578125e-05 * 1.37, device="cuda")
    cases = []

    def held(what, n, c_off=0, out_off=None, zero=False, full_range=False):
        hi = 2 ** 31 if full_range else 32768
        codes = (torch.zeros(n, dtype=torch.int32) if zero else
                 torch.randint(-hi, hi, (n,), generator=gen,
                               dtype=torch.int32))
        codes = on_card_at(torch, codes, c_off)
        want = dequantize_ref(codes, delta)
        if out_off is None:
            got = Q.dequantize_cuda(codes, delta)
        else:
            got = on_card_at(torch, torch.full_like(want, -1), out_off)
            Q._dequantize(codes, delta, got)
        torch.cuda.synchronize()
        expect(bits_equal(torch, got, want),
               f"dequantize is not bit-exact with its plain version at "
               f"{what}")
        plan = Q.dequantize_plan(n, codes.data_ptr() // 4 % 4,
                                 got.data_ptr() // 4 % 4)
        cases.append(dict(case=what, n=n, codes_offset=codes.storage_offset(),
                          out_offset=got.storage_offset(), vec=plan.vec,
                          head=plan.head, body=plan.body, tail=plan.tail,
                          grid=plan.grid))
        return plan

    for n in range(1, 8):
        held(f"n={n}", n)
    for off in (1, 2, 3):
        expect(held(f"codes at offset {off}", 100003, c_off=off).vec == 1,
               "dequantize: codes off out's offset took 16-byte vectors")
        expect(held(f"codes and out at offset {off}", 100003, off,
                    off).head == 4 - off,
               f"dequantize at offset {off} took no scalar head")
    for n in range(1, 8):
        held(f"n={n} at offset 3", n, 3, 3)
    held("codes at offset 1, out at offset 2", 100003, 1, 2)
    held("all zeros", 100003, zero=True)
    held("int32 range", 100003, full_range=True)
    print(f"dequantize: bit-exact at {len(cases)} edge cases")
    return cases


def check_codec_kernels(torch, timer):
    """Phase 3, the per-leaf and per-tensor codec's five kernels against
    their plain versions, bit for bit, and timed: ``quantize_dequantize_
    rows`` and ``dequantize_rows`` at the mnist-cnn per-leaf payload
    (``pack_tree(node_axis=True)``: ``[8240, 512]``, 180 segments), and
    at the edge cases of :func:`row_codec_cases`; ``fused_quantize``,
    ``fused_quantize_dequantize`` and ``dequantize`` timed at the
    ResNet18 teacher's ``[3, 3, 512, 512]`` leaf; the first two held,
    codes and Δ, at every case of :func:`fused_cases` too, ``dequantize``
    at those of :func:`dequantize_cases`.  Each row carries its cases
    and the launch plan of its timed shape (``design``)."""
    from dataclasses import asdict

    from repro_torch.kernels.quantize.ops import (_qmax_t, _segment_deltas,
                                                  pack_tree)
    from repro_torch.kernels.quantize.quantize import (
        dequantize_cuda, dequantize_plan, dequantize_rows_cuda, fused_plan,
        fused_quantize_cuda, fused_quantize_dequantize_cuda,
        quantize_dequantize_rows_cuda, rows_plan)
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
    plan = rows_plan(*buf.shape, buf.data_ptr() % 16 == 0)
    expect(plan.vec == 4, f"the per-leaf payload took {plan}")
    path_case = [dict(case="per-leaf payload", shape=list(buf.shape),
                      bits=16)]
    rows[-1].update(design=asdict(plan), cases=path_case + row_codec_cases(
        torch, "quantize_dequantize_rows"))

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
    rows[-1].update(design=asdict(plan), cases=path_case + row_codec_cases(
        torch, "dequantize_rows"))

    # -- rows 13 and 14 at every case, row 15 at the teacher's leaf ------
    x = teacher_leaf(torch)
    n = x.numel()
    qm = _qmax_t(16, x.device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for what, t, bits in fused_cases(torch, x):
        qmb = _qmax_t(bits, t.device)
        got = fused_quantize_cuda(t, bits=bits)
        want = fused_quantize_ref(t, qmb)
        rt_got = fused_quantize_dequantize_cuda(t, bits=bits)
        rt_want = fused_quantize_dequantize_ref(t, qmb)
        torch.cuda.synchronize()
        expect(all(map(bits_equal, [torch] * 2, got, want)),
               f"fused_quantize codes or delta disagree with the plain "
               f"version at {what}")
        expect(all(map(bits_equal, [torch] * 2, rt_got, rt_want)),
               f"fused_quantize_dequantize is not bit-exact with its plain "
               f"version at {what}")
        plan = fused_plan(t.numel(), t.data_ptr() // 4 % 4, sms)
        cases.append(dict(case=what, shape=list(t.shape),
                          offset=t.storage_offset(), bits=bits,
                          grid=plan.grid, staged=plan.staged,
                          streamed=plan.n - plan.staged))
        print(f"fused_quantize / fused_quantize_dequantize {what} "
              f"{tuple(t.shape)} offset {t.storage_offset()} int{bits}: "
              f"codes, round trip and delta {float(got[1]):.6e} bit-exact "
              f"(grid {plan.grid}, {plan.staged} of {plan.n} staged)")
        if what == "teacher":
            (c_got, d_got), (c_want, _) = got, want
            (o_got, _), (o_want, _) = rt_got, rt_want
    plan = fused_plan(n, x.data_ptr() // 4 % 4, sms)
    design = dict(asdict(plan), smem=plan.smem, staged=plan.staged)
    # no single PyTorch call takes the absmax and writes the codes, so
    # rows 13 and 14 have no library yardstick
    row("fused_quantize", 120, float((c_got - c_want).abs().max()),
        timer(lambda: fused_quantize_cuda(x, bits=16)),
        timer(lambda: fused_quantize_ref(x, qm)), 8 * n + 4, 6 * n, None)
    row("fused_quantize_dequantize", 133, float((o_got - o_want).abs().max()),
        timer(lambda: fused_quantize_dequantize_cuda(x, bits=16)),
        timer(lambda: fused_quantize_dequantize_ref(x, qm)), 8 * n + 4,
        7 * n, None)
    for rw in rows[-2:]:
        rw.update(design=design, cases=cases)
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
    plan = dequantize_plan(n, c_got.data_ptr() // 4 % 4, 0)
    expect(plan.vec == 4, f"the teacher leaf's codes took {plan}")
    rows[-1].update(design=asdict(plan), cases=[dict(
        case="teacher", n=n)] + dequantize_cases(torch))
    for rw in rows:
        print(f"  {rw['name']:25s} kernel {rw['ms']:.4f} ms  plain "
              f"{rw['plain_ms']:.4f} ms  library {rw['library_ms']}  "
              f"bound {rw['bound_ms']:.4f} ms ({rw['bound_by']})")
    return rows


def run_codec(torch) -> dict:
    """Phase 13, the per-leaf and per-tensor codec at full width, every
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
            ("ragged", 1001, 200, 37),
            ("P = 2048", 640, 2048, 100))
# proto_dist's edge cases in phase 3, held (P = 2048 is also timed above):
# (what, N, P, C, storage offset of x and protos); each in fp32 and bf16.
# Offsets 1-3 and P = 3 or 130 take one element a load (VEC = 1), P =
# 2048 eight chunks.
PD_EDGE = (("one row", 1, 128, 10, 0), ("one prototype", 640, 128, 1, 0),
           ("P = 3", 640, 3, 10, 0), ("P = 130", 640, 130, 10, 0),
           ("P = 2048", 640, 2048, 100, 0),
           ("offset 1", 640, 128, 10, 1), ("offset 2", 640, 256, 100, 2),
           ("offset 3", 1001, 200, 37, 3))
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
            ("ragged", 250, 50280, "bfloat16", 3.0),
            ("split regime", 16, LM_VOCAB, "bfloat16", 1.0))
# kd_loss's edge cases in phase 3, held to kd_tol but not timed: (what,
# rows, V, dtype, T, storage offset of both logit tensors, mean of the
# logits).  V = 1, 7, 13 take the segments design, V = 1001 (not a whole
# number of vectors) and offsets 1-3 one logit a load, one and 16 rows of
# the LM vocabulary a cluster a row.
KD_EDGE = tuple(
    [(f"V = {v}", 320, v, dt, 3.0, 0, 0.0) for v in (1, 7, 13, 1001)
     for dt in ("float32", "bfloat16")]
    + [(f"offset {off}", r, 50280, dt, 1.0, off, 0.0) for off in (1, 2, 3)
       for dt in ("float32", "bfloat16") for r in (250, 64)]
    + [("one row", 1, LM_VOCAB, "bfloat16", 1.0, 0, 0.0),
       ("16 rows", 16, LM_VOCAB, "bfloat16", 3.0, 0, 0.0),
       ("|y| ~ 1e3", 320, 10, "float32", 3.0, 0, 1000.0),
       ("|y| ~ 1e3", 250, 50280, "bfloat16", 1.0, 0, 1000.0)])
# Claim 4 in phase 14: model -> local epochs of make_fedavg_step
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
    if d2.shape[1] < 2:         # one prototype: the argmin cannot flip
        return torch.ones(d2.shape[0], dtype=torch.bool, device=d2.device)
    top2 = torch.topk(d2, 2, dim=-1, largest=False).values
    return (top2[:, 1] - top2[:, 0]) > 2 * tol


def pd_held(torch, what: str, x, protos):
    """``proto_dist`` at x and protos against both plain versions (the
    expansion and the direct oracle) within :func:`pd_close`, and its
    argmin against the oracle's on the rows clear of ties.  Returns
    ``(d2, the expansion's d2, a record of the errors and the plan)``."""
    from repro_torch.kernels.proto_dist.proto_dist import (proto_dist_cuda,
                                                           proto_dist_plan)
    from repro_torch.kernels.proto_dist.ref import (proto_dist_expand,
                                                    proto_dist_ref)
    got = proto_dist_cuda(x, protos)
    want = proto_dist_expand(x, protos)
    direct = proto_dist_ref(x, protos)
    torch.cuda.synchronize()
    dtype = str(x.dtype).replace("torch.", "")
    for plain, name in ((want, "expansion"), (direct, "oracle")):
        ok, tol = pd_close(torch, got, plain, x, protos)
        expect(ok, f"proto_dist {what} {dtype}: beyond tolerance "
                   f"{tol:.3e} of the {name}")
    clear = clear_of_ties(torch, direct, tol)
    expect(torch.equal(got.argmin(-1)[clear], direct.argmin(-1)[clear]),
           f"proto_dist {what} {dtype}: argmin differs away from ties")
    (n, p_dim), c = x.shape, protos.shape[0]
    plan = proto_dist_plan(n, c, p_dim, x.dtype, x.data_ptr() % 16 == 0
                           and protos.data_ptr() % 16 == 0)
    rec = dict(case=what, shape=f"[{n}, {p_dim}] x [{c}, {p_dim}]",
               dtype=dtype, offset=x.storage_offset(),
               max_abs_err=float((got - want).abs().max()),
               max_abs_err_oracle=float((got - direct).abs().max()),
               rows_near_ties=int((~clear).sum()), vec=plan.vec,
               warps=plan.warps, warp_rows=plan.warp_rows,
               col_tile=plan.col_tile, chunks=plan.chunks,
               grid=list(plan.grid))
    print(f"proto_dist {what} {rec['shape']} {dtype} offset "
          f"{rec['offset']}: max |kernel - expansion| "
          f"{rec['max_abs_err']:.3e}, - oracle "
          f"{rec['max_abs_err_oracle']:.3e} (tol {tol:.3e}); argmin equal "
          f"on {int(clear.sum())} rows, {rec['rows_near_ties']} near ties; "
          f"{plan}")
    return got, want, rec


def kd_logits(torch, gen, r: int, v: int, dtype: str, off: int = 0,
              mean: float = 0.0):
    """Student and teacher logits ``[r, v]`` of ``dtype`` on the card,
    each first element ``off`` elements into its storage: the student
    ``mean + 3·N(0, 1)``, the teacher the student plus ``N(0, 1)``."""
    dt = getattr(torch, dtype)
    ys = torch.randn((r, v), generator=gen, device="cuda") * 3 + mean
    yt = (ys + torch.randn((r, v), generator=gen, device="cuda")).to(dt)
    ys = ys.to(dt)
    if off:
        ys, yt = on_card_at(torch, ys, off), on_card_at(torch, yt, off)
    return ys, yt


def kd_held(torch, what: str, ys, yt, temp: float) -> dict:
    """``kd_loss_rows`` at ys, yt against its plain version within
    :func:`kd_tol`, finite, and a second call bit-identical to the first.
    Returns a record of the case, its error and the plan it took."""
    from dataclasses import asdict

    from repro_torch.kernels.kd_loss.kd_loss import (_sm_count, kd_plan,
                                                     kd_loss_rows_cuda)
    from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref
    got = kd_loss_rows_cuda(ys, yt, temp)
    again = kd_loss_rows_cuda(ys, yt, temp)
    want = kd_loss_rows_ref(ys, yt, temp)
    torch.cuda.synchronize()
    r, v = ys.shape
    dtype = str(ys.dtype).replace("torch.", "")
    ymax = max(float(ys.float().abs().max()), float(yt.float().abs().max()))
    tol = kd_tol(ymax, temp)
    err = float((got - want).abs().max())
    expect(err <= tol and bool(torch.isfinite(got).all()),
           f"kd_loss {what} [{r}, {v}] {dtype} T={temp}: max error "
           f"{err:.3e} > {tol:.3e}")
    expect(bits_equal(torch, got, again),
           f"kd_loss {what} [{r}, {v}] {dtype}: a second call differs")
    plan = kd_plan(r, v, ys.element_size(), ys.data_ptr() % 16 == 0
                   and yt.data_ptr() % 16 == 0, _sm_count(ys.device.index))
    print(f"kd_loss {what} [{r}, {v}] {dtype} T={temp} offset "
          f"{ys.storage_offset()}: max |kernel - plain| {err:.3e} (tol "
          f"{tol:.3e}, {err / tol:.3f} of it, max|y| {ymax:.3g}), mean "
          f"{float(want.mean()):.4f}; {plan}")
    return dict(case=what, shape=f"[{r}, {v}]", dtype=dtype,
                temperature=temp, offset=ys.storage_offset(),
                max_abs_err=err, tol=tol, **asdict(plan))


def check_proto_kd_kernels(torch, timer):
    """Phase 3, rows 18 and 17: ``proto_dist`` against its plain versions
    (:func:`pd_held`) at Eq. 5's shapes in fp32 and bf16, timed, and at
    the edge cases of ``PD_EDGE``; ``kd_loss`` per row against
    ``kd_loss_rows_ref`` (:func:`kd_held`) at ``KD_CASES``, timed (one
    node's epoch of mnist-cnn logits, llama4-scout's vocabulary, a ragged
    shape, 16 rows in the split regime; T = 1 and 3), at the edge cases
    of ``KD_EDGE``, and at identical logits."""
    from repro_torch.kernels.kd_loss.kd_loss import (KdPlan, _sm_count,
                                                     kd_loss_rows_cuda)
    from repro_torch.kernels.kd_loss.ref import kd_loss_rows_ref
    from repro_torch.kernels.proto_dist.proto_dist import proto_dist_cuda
    from repro_torch.kernels.proto_dist.ref import proto_dist_expand

    gen = torch.Generator(device="cuda").manual_seed(17)
    cases = []
    for what, n, p_dim, c in PD_CASES:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn((n, p_dim), generator=gen, device="cuda").to(dt)
            protos = torch.randn((c, p_dim), generator=gen,
                                 device="cuda").to(dt)
            _, _, rec = pd_held(torch, what, x, protos)
            isz = x.element_size()
            nbytes = isz * (n + c) * p_dim + 4 * n * c
            b_ms, b_by = bound(nbytes, 2 * n * c * p_dim + 2 * (n + c) * p_dim
                               + 4 * n * c)
            # library yardstick: torch.cdist returns the root ||x - p||,
            # not its square; it takes no bf16, so bf16 inputs are timed
            # on fp32 copies made outside the timed region
            x32, p32 = x.float(), protos.float()
            rec.update(ms=timer(lambda: proto_dist_cuda(x, protos)),
                       plain_ms=timer(lambda: proto_dist_expand(x, protos)),
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=timer(lambda: torch.cdist(x32, p32)),
                       copy_ms=copy_ms(torch, timer, nbytes))
            cases.append(rec)
    edge = []
    for what, n, p_dim, c, off in PD_EDGE:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = on_card_at(torch, torch.randn(
                (n, p_dim), generator=gen, device="cuda").to(dt), off)
            protos = on_card_at(torch, torch.randn(
                (c, p_dim), generator=gen, device="cuda").to(dt), off)
            rec = pd_held(torch, what, x, protos)[2]
            expect(rec["vec"] == 1 if off or p_dim in (3, 130)
                   else rec["vec"] > 1,
                   f"proto_dist {what} {dtype}: took vec {rec['vec']}")
            expect(rec["chunks"] == -(-p_dim // 256),
                   f"proto_dist {what}: {rec['chunks']} chunks")
            edge.append(rec)
    print(f"proto_dist: within tolerance at {len(edge)} edge cases")
    rows = [dict(name="proto_dist", route="cuda",
                 source="src/repro_torch/csrc/proto_dist.cu",
                 replaces="src/repro/kernels/proto_dist/proto_dist.py:31",
                 **cases[0], cases=cases + edge)]

    KD_PLAN_KEYS = tuple(KdPlan.__dataclass_fields__)
    cases = []
    for what, r, v, dtype, temp in KD_CASES:
        ys, yt = kd_logits(torch, gen, r, v, dtype)
        rec = kd_held(torch, what, ys, yt, temp)
        isz = ys.element_size()
        b_ms, b_by = bound(2 * isz * r * v + 4 * r, 11 * r * v)
        # no library yardstick: no single PyTorch call takes raw logits to
        # the KL (F.kl_div needs both log-softmaxes made first)
        rec.update(ms=timer(lambda: kd_loss_rows_cuda(ys, yt, temp)),
                   plain_ms=timer(lambda: kd_loss_rows_ref(ys, yt, temp)),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        cases.append(rec)
        del ys, yt
    edge = []
    for what, r, v, dtype, temp, off, mean in KD_EDGE:
        ys, yt = kd_logits(torch, gen, r, v, dtype, off, mean)
        rec = kd_held(torch, what, ys, yt, temp)
        wide = 16 // ys.element_size()
        expect((rec["vec"] == 1) == (off > 0 or v % wide > 0 or v <= 256),
               f"kd_loss {what}: took vec {rec['vec']}")
        expect((rec["design"] == "clusters")
               == (r < _sm_count(0) and v > 5e4),
               f"kd_loss {what}: took the {rec['design']} design")
        edge.append(rec)
        del ys, yt
    print(f"kd_loss: within tolerance at {len(edge)} edge cases, each "
          f"call's bits repeated")
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
                        if k in ("shape", "dtype", "max_abs_err", "ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
                     design={k: cases[0][k] for k in KD_PLAN_KEYS},
                     cases=cases + edge))
    for row in rows:
        for cs in row["cases"]:
            if "ms" not in cs:
                continue
            print(f"  {row['name']:10s} {cs['shape']:24s} {cs['dtype']:8s} "
                  f"{'T=%g ' % cs['temperature'] if 'temperature' in cs else ''}"
                  f"kernel {cs['ms']:.4f} ms  plain {cs['plain_ms']:.4f} ms"
                  f"  library {cs['library_ms']}  bound "
                  f"{cs['bound_ms']:.4f} ms ({cs['bound_by']})")
    return rows


def run_proto_infer(torch, inputs) -> dict:
    """Phase 14, ``proto-infer``: the paper's Claim 4 (nearest-prototype
    inference, ``tests/test_system.py``) at full width on the card, and
    the ProFe pair's KD term through the ``kd_loss`` kernel.

    1. For each model of ``CLAIM4_EPOCHS`` (mnist-cnn: teacher widths
       (32, 64), proto_dim 128; cifar10-resnet18: the ResNet18, proto_dim
       256): node 0's 320 images of the paths' data, ``make_fedavg_step``
       on a one-node stack under per-leaf adamw with ``TrainConfig``
       defaults for its local
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
                                        init_node_state, node_params,
                                        stack_states)
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
        # the stacked step on a one-node stack
        state = stack_states([NodeState(
            student=params, teacher={}, opt_s=opt.init(params), opt_t={},
            global_protos=torch.zeros((ncls, cfg.proto_dim), device="cuda"),
            proto_mask=torch.zeros((ncls,), device="cuda"),
            round_idx=torch.zeros((), dtype=torch.int32, device="cuda"))])
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
                state, m = step(state, {k: v[None] for k, v in b.items()})
                losses.append(m["loss_s"][0])
            params = node_params(state.student, 0)
            protos, counts = compute_local_prototypes(
                cfg, params, proto_batches, ncls)
            with torch.no_grad():
                f1 = forward(cfg, params, {"image": test["image"]}).f1
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


def path_inputs(model: str, split: str = "iid"):
    """A model's paths' configuration and data: the config at full width,
    20 nodes on a full graph, 2 rounds of 1 local epoch, ``TrainConfig``
    defaults, iid 320 images a node (10 steps a round), or the
    ``split`` of ``PATH_SPLIT``."""
    from repro_torch.config import FederationConfig, TrainConfig, get_config
    from repro_torch.data import (make_image_dataset, partition,
                                  train_test_split)

    data = make_image_dataset(0, 7040, IMAGE_SHAPE[model], 10)
    train_d, test_d = train_test_split(data, 1 / 11, 0)
    parts = partition(train_d["label"], N_NODES,
                      "iid" if split == "ragged" else split, 0)
    if split == "ragged":
        parts[0] = parts[0][:RAGGED_IMAGES]
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    fed = FederationConfig(num_nodes=N_NODES, topology="full", rounds=ROUNDS,
                           local_epochs=1)
    return get_config(model), fed, TrainConfig(), node_data, test_d


def run_path(torch, inputs, name: str):
    """Phases 4-10: ProFe or a paper baseline
    (``PATH_FED``'s ``algorithm``) at full width through
    ``run_federation`` on the path ``name`` of ``PATHS`` (its model's
    ``inputs``, its optimizer, wire and rounds, and ``PATH_FED``'s
    fields), with the launch counts set to 0 just before and read just
    after.  Checks finite F1 every round, the resolved ``param_plane``,
    the launches (every count exactly as the algorithm, the plane mode,
    the optimizer and the wire spec imply, each kernel of the path at
    least once) and the wire bytes against the JAX package's.  With
    ``+ef`` the final ``CodecState`` must have advanced ``seq`` once a
    round and carry a residual that is finite, non-zero, and zero on the
    plane's padding lanes.  On the adapter wire the last round's shared
    factors must be finite and non-zero.  ``PATH_RUN`` gives the run's
    keywords (the round variants); a path of ``DETERMINISTIC_PATHS``
    runs under deterministic cuDNN, and :func:`check_variant` holds what
    its variant promises.  Returns the launch counts."""
    import contextlib
    import dataclasses

    from repro_torch.core.federation import run_federation
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    _, optimizer, wire, rounds, expected_bytes = PATHS[name]
    cfg, fed, train, node_data, test_d = inputs
    spec = parse_wire(wire)
    extra = PATH_FED.get(name, {})
    fed = dataclasses.replace(fed, rounds=rounds, **wire_fields(spec),
                              **extra)
    train = dataclasses.replace(train, optimizer=optimizer)
    run_kw = PATH_RUN.get(name, {})
    sizes = [len(d["label"]) for d in node_data]
    algo = fed.algorithm
    # the student rides the plane only for ProFe with param_plane "auto"
    plane = algo == "profe" and fed.param_plane != "off"
    # a node smaller than one batch: run_federation falls back to the
    # per-node loop engine
    loop = min(sizes) < train.batch_size
    print(f"{cfg.name}: {algo}, {N_NODES} nodes x {min(sizes)}-{max(sizes)} "
          f"images, batch {train.batch_size}, {optimizer}, wire "
          f"{spec.describe() if spec else 'fp32'}, plane {plane}, engine "
          f"{'loop' if loop else 'stacked'} {extra or ''} {run_kw or ''}")
    # each node's local batches a round (1 epoch; a node under one batch
    # takes one short batch), from the split on the host
    node_batches = [max(n // train.batch_size, 1) for n in sizes]
    # the stacked engine steps every node together, as many steps as the
    # largest node has batches (the others masked out of the padded
    # ones); the loop engine steps each node on its own
    steps = rounds * (sum(node_batches) if loop else max(node_batches))
    quantized = spec is not None
    ef = quantized and spec.error_feedback
    uniform = quantized and spec.uniform_bits is not None
    # the stale-by-one pipeline skips round 0's mix
    mixes = rounds - 1 if run_kw.get("overlap") == "rounds" else rounds
    # one plane sweep per training step, of the path's optimizer only (a
    # per-leaf student updates through the plain per-leaf optimizer)
    launches = {k: steps if opt == optimizer and plane else 0
                for opt, k in OPT_KERNEL.items()}
    # one share codec a round: the stacked engine's one packed sweep for
    # every node (amax rows, then the codes), the loop engine's a node
    # (the plane rows' amax and round trip; +ef the residual's; the
    # adapter groups and the prototypes through the plain per-tensor
    # codec); none on the fp32 wire
    shares = rounds * (N_NODES if loop else 1)
    plane_rows = loop and plane and quantized and not fed.adapter_rank
    launches.update({
        # one per Eq. 3 proto batch, where prototypes travel
        "proto_accum": steps if algo == "profe" or algo in PROTO_BASELINES
        else 0,
        "rowabs": shares if quantized and not ef
        and (plane_rows or not loop) else 0,
        "quantize_rows": rounds if uniform and not ef and not loop else 0,
        "quantize_rows_mixed": rounds if quantized and not uniform
        and not ef and not loop else 0,
        "rowabs_sum": shares if ef else 0,
        "quantize_rows_ef": shares if ef else 0,
        # one merge launch per matrix leaf a round (the loop engine's one
        # a receiver: on the full graph every node receives)
        "lowrank_apply": ADAPTER_LEAVES * mixes * (N_NODES if loop else 1)
        if fed.adapter_rank else 0,
        # the stacked engine mixes with tensordot; only the mesh exchange
        # launches the fused mix
        "mix_packed": 0})
    launches.update({k: 0 for k in CODEC_KERNELS + PROTO_INFER_KERNELS})
    # the loop engine's plane wire: the row round trip a node
    launches["quantize_dequantize_rows"] = shares if plane_rows and not ef \
        else 0

    exact = deterministic_cudnn(torch) if name in DETERMINISTIC_PATHS \
        else contextlib.nullcontext()
    with exact:
        reset_launch_counts()
        res = run_federation(cfg, fed, train, node_data, test_d,
                             verbose=True, **run_kw)
        counts = launch_counts()
        check_variant(torch, name, inputs, fed, train, res)
    expect(res.extras["param_plane"] is plane,
           f"{name}: param_plane resolved to {res.extras['param_plane']}")
    from repro_torch.core.comm import ScheduleCommAccountant
    expect(isinstance(res.comm, ScheduleCommAccountant) is not loop,
           f"{name}: ran on the {'stacked' if loop else 'loop'} engine")
    # each node's step counters: its own batch count over the rounds (the
    # mask's effect where counts differ)
    want_steps = [rounds * b for b in node_batches]
    got_steps = res.state.opt_s["step"].tolist()
    print(f"per-node student step counters: {got_steps}")
    expect(got_steps == want_steps,
           f"{name}: student step counters {got_steps} != {want_steps}")

    print(f"per-round F1: {res.f1_per_round}")
    print(f"per-round seconds: {res.extras['round_times_s']}")
    print(f"avg_sent_gb: {res.extras['avg_sent_gb']!r}  "
          f"wire_bytes_packed_per_copy: "
          f"{res.extras['wire_bytes_packed_per_copy']}  "
          f"wire_bytes_per_copy: {res.extras['wire_bytes_per_copy']}")
    print(f"launches on the {name} path: {counts}")
    print(f"predicted: { {k: v for k, v in launches.items() if v} }")
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
    if ef and not hasattr(ws.residual["student"], "meta"):
        # a tree residual (the adapter payload's, a per-leaf student's)
        seq = ws.seq.tolist()
        expect(seq == [rounds] * N_NODES, f"{name}: seq {seq} != {rounds}")
        from repro_torch.tree import tree_paths
        for group in sorted(ws.residual):
            leaves = [x for _, x in tree_paths(ws.residual[group])]
            expect(all(bool(torch.isfinite(x).all()) for x in leaves),
                   f"{name}: residual {group} not finite")
            top = max(float(x.abs().max()) for x in leaves)
            print(f"residual {group}: {len(leaves)} leaves, max |res| "
                  f"{top:.4g}")
        expect(max(float(x.abs().max()) for _, x in tree_paths(
            ws.residual)) > 0, f"{name}: residual all zero")
        print(f"residual after {rounds} rounds: seq {seq[0]} on all "
              f"{N_NODES} nodes, groups {sorted(ws.residual)}")
    elif ef:
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
    expect((shared is not None) == bool(fed.adapter_rank),
           f"{name}: adapter_factors is {shared!r}")
    if fed.adapter_rank:
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


class deterministic_cudnn:
    """Deterministic cuDNN algorithms inside the block (a convolution's
    backward may otherwise pick one whose float sums run in another order
    each call), the flag printed as set and as restored."""

    def __init__(self, torch):
        self.backends = torch.backends.cudnn

    def __enter__(self):
        self.was = self.backends.deterministic
        self.backends.deterministic = True
        print(f"cudnn.deterministic: {self.was} -> True")

    def __exit__(self, *exc):
        self.backends.deterministic = self.was
        print(f"cudnn.deterministic restored to {self.was}")
        return False


def states_equal(torch, a, b) -> bool:
    """Two states (trees of tensors and NamedTuples) with the same keys
    and every leaf bit-identical (:func:`repro_torch.tree.keyed_leaves`)."""
    from repro_torch.tree import keyed_leaves
    ia, ib = keyed_leaves(a), keyed_leaves(b)
    return [k for k, _ in ia] == [k for k, _ in ib] and all(
        bits_equal(torch, x.detach(), y.detach()) for (_, x), (_, y)
        in zip(ia, ib))


def timed_phases(torch, federation, seconds):
    """Patch ``federation``'s round parts and Eq. 3 pass so that each
    phase call is timed on the host clock with the card synchronized
    before and after it, appending to ``seconds[phase]``; returns the
    function that restores them."""
    parts, proto_pass = federation._make_round_parts, \
        federation._make_proto_pass

    def clock(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return run

    def make_parts(*args, **kwargs):
        train, share, mix = parts(*args, **kwargs)
        return clock("train+eq3", train), clock("share", share), \
            clock("mix", mix)

    federation._make_round_parts = make_parts
    federation._make_proto_pass = lambda *a, **k: clock("eq3", proto_pass(
        *a, **k))

    def restore():
        federation._make_round_parts = parts
        federation._make_proto_pass = proto_pass
    return restore


def check_variant(torch, name: str, inputs, fed, train, res) -> None:
    """What a round variant's path promises beyond bytes and launches:

    * ``16/fused`` (``eval_all_nodes``): 20 finite per-node F1s a round,
      their mean the reported F1;
    * ``16/fused+ema``: the carried counts after 2 rounds exactly 1.5x one
      round's (480 a node: 10 steps of 32 images, plus half of round 1's),
      read from the state the round function returned;
    * ``16/none``: a sequential leg from the same seeds (the same
      configuration, ``overlap=None``) ends with the final stacked student
      bit-identical; that leg's phases (train, Eq. 3, share, mix) are timed
      synchronized and printed.
    """
    import numpy as np

    from repro_torch.core import federation
    per_round = (len(inputs[3][0]["label"]) // train.batch_size) * \
        train.batch_size
    if name == "16/fused":
        nodes = res.extras["f1_per_round_nodes"]
        expect(len(nodes) == fed.rounds, f"{name}: {len(nodes)} rounds")
        for rnd, f1s in enumerate(nodes):
            print(f"round {rnd + 1} per-node F1: {f1s}")
            expect(len(f1s) == N_NODES and all(math.isfinite(f)
                                               for f in f1s),
                   f"{name}: per-node F1 {f1s}")
            expect(res.f1_per_round[rnd] == float(np.mean(f1s)),
                   f"{name}: F1 {res.f1_per_round[rnd]} is not the mean "
                   f"of the nodes'")
        print(f"F1 spread per round: {res.extras['f1_std_per_round']}")
    elif name == "16/fused+ema":
        counts = res.state.proto_acc[1].sum(-1)
        want = per_round + fed.proto_ema * per_round
        print(f"carried Eq. 3 counts after {fed.rounds} rounds: "
              f"{counts.tolist()} (one round: {per_round})")
        expect(bool((counts == want).all()),
               f"{name}: carried counts {counts.tolist()} != {want}")
    elif name == "16/none":
        cfg, _, _, node_data, test_d = inputs
        seconds = {}
        restore = timed_phases(torch, federation, seconds)
        try:
            seq = federation.run_federation(cfg, fed, train, node_data,
                                            test_d)
        finally:
            restore()
        for rnd in range(fed.rounds):
            eq3 = seconds["eq3"][rnd]
            split = {"train": seconds["train+eq3"][rnd] - eq3, "eq3": eq3,
                     "share": seconds["share"][rnd],
                     "mix": seconds["mix"][rnd]}
            print(f"sequential leg, round {rnd + 1} phase seconds "
                  f"(synchronized): {json.dumps(split)}  round "
                  f"{seq.extras['round_times_s'][rnd]!r}")
        print(f"per-round seconds: overlap='none' "
              f"{res.extras['round_times_s']}, sequential "
              f"{seq.extras['round_times_s']}")
        expect(states_equal(torch, res.state, seq.state),
               f"{name}: the final state differs from the sequential leg's")
        expect(res.f1_per_round == seq.f1_per_round,
               f"{name}: F1 {res.f1_per_round} != {seq.f1_per_round}")
        print("overlap='none': the final stacked state bit-identical to "
              "the sequential leg's")


# the loop engine against the stacked engine on the card: the CPU tests'
# tolerances (tests/test_torch_loop_engine.py): parameters, Adam's mu and
# nu, the Eq. 4 prototypes
LOOP_ATOL = {"params": 2e-5, "mu": 1e-6, "nu": 1e-8, "protos": 1e-4}
LR = 1e-3                        # TrainConfig's learning rate
# with the path's clip and the stacked engine's own [N, ...] norm
# reductions: the most parameters beyond LOOP_ATOL["params"] (measured on
# the H100: 40 of the student, 255 of the teacher; PERF.md, PR 26),
# about 2.5 times that
CLIP_BEYOND_MAX = {"student": 100, "teacher": 640}


class node_sliced_norms:
    """Inside the block the stacked engine reduces each node's clip norm
    as the loop engine does: ``clip_by_global_norm(lead=1)`` (the
    per-leaf models, through ``core/profe``) and ``plane_global_norm``
    (the student plane) run on each node's gradient copied out of the
    ``[N, ...]`` stack as a one-node stack of its own, and the nodes'
    results are joined.  The clip scales multiply elementwise, so nothing
    else of the step changes."""

    def __init__(self, torch):
        from repro_torch.core import profe
        from repro_torch.optim import plane
        self.torch, self.profe, self.plane = torch, profe, plane

    def __enter__(self):
        from repro_torch.tree import tree_leaves, tree_map
        torch, profe, plane = self.torch, self.profe, self.plane
        self.saved = clip, gnorm = (profe.clip_by_global_norm,
                                    plane.plane_global_norm)

        def node(tree, i):
            return tree_map(lambda g: g[i:i + 1].clone(), tree)

        def sliced_clip(grads, max_norm, *, lead=0):
            n = tree_leaves(grads)[0].shape[0]
            if lead != 1 or n == 1:
                return clip(grads, max_norm, lead=lead)
            parts = [clip(node(grads, i), max_norm, lead=1)
                     for i in range(n)]
            return (tree_map(lambda *gs: torch.cat(gs),
                             *[c for c, _ in parts]),
                    torch.cat([gn for _, gn in parts]))

        def sliced_gnorm(grads):
            buf = grads.buf
            if buf.dim() != 3 or buf.shape[0] == 1:
                return gnorm(grads)
            return torch.cat([gnorm(plane.Plane(buf[i:i + 1].clone(),
                                                grads.meta))
                              for i in range(buf.shape[0])])
        profe.clip_by_global_norm = sliced_clip
        plane.plane_global_norm = sliced_gnorm

    def __exit__(self, *exc):
        self.profe.clip_by_global_norm, self.plane.plane_global_norm = \
            self.saved
        return False


def loop_gaps(torch, a, b):
    """The loop engine's final state ``a`` against the stacked engine's
    ``b``: counters, masks and round counters held equal; returns the
    largest gaps ``{student, teacher, protos, mu, nu}`` and the count of
    student and teacher parameters beyond ``LOOP_ATOL["params"]``."""
    from repro_torch.tree import tree_leaves
    for opt in ("opt_s", "opt_t"):
        expect(getattr(a, opt)["step"].tolist()
               == getattr(b, opt)["step"].tolist(), f"loop: {opt} steps")
    expect(bits_equal(torch, a.proto_mask, b.proto_mask)
           and a.round_idx.tolist() == b.round_idx.tolist(),
           "loop: masks or round counters differ")

    def diffs(xs, ys):
        return torch.cat([(x.detach() - y.detach()).abs().flatten()
                          for x, y in zip(xs, ys)])
    parts = {"student": diffs([a.student.buf], [b.student.buf]),
             "teacher": diffs(tree_leaves(a.teacher), tree_leaves(b.teacher)),
             "protos": diffs([a.global_protos], [b.global_protos])}
    for key in ("mu", "nu"):
        parts[key] = diffs(tree_leaves((a.opt_s[key], a.opt_t[key])),
                           tree_leaves((b.opt_s[key], b.opt_t[key])))
    gaps = {k: float(d.max()) for k, d in parts.items()}
    beyond = {k: int((parts[k] > LOOP_ATOL["params"]).sum())
              for k in ("student", "teacher")}
    return gaps, beyond


def hold_loop_gaps(gaps, what: str) -> None:
    for key, g in gaps.items():
        tol = LOOP_ATOL.get(key, LOOP_ATOL["params"])
        expect(g <= tol, f"loop ({what}): {key} {g!r} apart from the "
               f"stacked engine's (tolerance {tol})")


def check_loop_against_stacked(torch, inputs) -> None:
    """Phase ``loop``: one round of the main path's configuration (iid,
    mnist-cnn, 16-bit wire) through ``run_federation_loop`` against
    ``run_federation``, both under deterministic cuDNN from the same
    seeded states, once without the gradient clip and once with the
    path's (1.0).  Bytes, step and round counters and masks exactly; the
    largest gaps of the student planes, teachers, moments and prototypes
    printed, the student's said zero or not.  Without the clip every gap
    is held to ``LOOP_ATOL``.  With it the stacked engine's per-node clip
    norm sums an ``[N, ...]`` gradient in another order than the loop's
    ``[1, ...]`` one; where a clipped gradient element is near Adam's eps
    that last bit moves the element by up to 2·lr, and later steps carry
    it on.  So the clipped stacked run is made twice: as the path runs it
    (every parameter within ``atol + 2·lr``, those beyond ``atol`` at most
    ``CLIP_BEYOND_MAX``), and under :class:`node_sliced_norms`, which
    reduces each node's norm as the loop does and is held, parameters,
    moments and prototypes, to ``LOOP_ATOL``."""
    import dataclasses

    from repro_torch.core.federation import (run_federation,
                                             run_federation_loop)

    cfg, fed, train, node_data, test_d = inputs
    fed = dataclasses.replace(fed, rounds=1, **wire_fields(parse_wire("16")))
    for clip in (0.0, train.grad_clip):
        tr = dataclasses.replace(train, grad_clip=clip)
        with deterministic_cudnn(torch):
            t0 = time.time()
            stacked = run_federation(cfg, fed, tr, node_data, test_d)
            t1 = time.time()
            loop = run_federation_loop(cfg, fed, tr, node_data, test_d)
            t2 = time.time()
            if clip:
                with node_sliced_norms(torch):
                    sliced = run_federation(cfg, fed, tr, node_data, test_d)
        print(f"grad_clip {clip}: round seconds stacked {t1 - t0:.3f}, "
              f"loop {t2 - t1:.3f}")
        for key in ("avg_sent_gb", "wire_bytes_per_copy",
                    "wire_bytes_packed_per_copy"):
            expect(loop.extras[key] == stacked.extras[key],
                   f"loop: {key} {loop.extras[key]!r} != the stacked "
                   f"{stacked.extras[key]!r}")
        gaps, beyond = loop_gaps(torch, loop.state, stacked.state)
        print(f"grad_clip {clip}: loop against stacked, largest gaps "
              f"{json.dumps(gaps)}, parameters beyond "
              f"{LOOP_ATOL['params']}: {json.dumps(beyond)}; the student "
              f"gap {'zero' if gaps['student'] == 0 else 'not zero'}; F1 "
              f"stacked {stacked.f1_per_round}, loop {loop.f1_per_round}")
        if clip == 0.0:
            hold_loop_gaps(gaps, "no clip")
            continue
        for key in ("student", "teacher"):
            expect(gaps[key] <= LOOP_ATOL["params"] + 2 * LR,
                   f"loop: {key} {gaps[key]!r} apart beyond Adam's "
                   f"eps regime")
            expect(beyond[key] <= CLIP_BEYOND_MAX[key],
                   f"loop: {beyond[key]} {key} parameters beyond "
                   f"{LOOP_ATOL['params']} (at most {CLIP_BEYOND_MAX[key]})")
        gaps, beyond = loop_gaps(torch, loop.state, sliced.state)
        print(f"grad_clip {clip}, the stacked engine's norms reduced node "
              f"by node: loop against stacked, largest gaps "
              f"{json.dumps(gaps)}, parameters beyond "
              f"{LOOP_ATOL['params']}: {json.dumps(beyond)}; F1 "
              f"{sliced.f1_per_round}")
        hold_loop_gaps(gaps, "clip, norms node by node")


def run_checkpoint(torch, inputs) -> None:
    """Phase ``checkpoint``: the ``4/16+ef`` run's stacked state after
    round 1 saved (``repro_torch.checkpoint``, under ``build/``), loaded
    and held bit-identical to what was saved; then round 2 resumed from
    the restored state (``run_federation(start_round=1)``) against the
    2-round run that never stopped, the whole final state bit-identical,
    all under deterministic cuDNN.  The checkpoint's files are removed
    after."""
    import dataclasses

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.federation import run_federation

    cfg, fed, train, node_data, test_d = inputs
    fed = dataclasses.replace(fed, rounds=2,
                              **wire_fields(parse_wire("4/16+ef")))
    path = str(ROOT / "build" / "checkpoint" / "round1")
    with deterministic_cudnn(torch):
        one = run_federation(cfg, dataclasses.replace(fed, rounds=1), train,
                             node_data, test_d)
        t0 = time.time()
        save_checkpoint(path, one.state, metadata={"round": 1})
        back = load_checkpoint(path, one.state)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        size = os.path.getsize(path + ".npz")
        expect(states_equal(torch, back, one.state),
               "checkpoint: the restored state differs from the saved one")
        expect(back.student.buf.is_cuda and back.student.buf.requires_grad
               and back.student.meta == one.state.student.meta,
               "checkpoint: the restored plane is not a card-side leaf "
               "with its recipe")
        print(f"saved and restored the round-1 state ({size} B) in "
              f"{seconds:.3f} s: bit-identical, seq "
              f"{back.wire_state.seq.tolist()[:1]} x {N_NODES}")
        resumed = run_federation(cfg, fed, train, node_data, test_d,
                                 initial_states=back, start_round=1)
        full = run_federation(cfg, fed, train, node_data, test_d)
    for suffix in (".npz", ".meta.json"):
        os.remove(path + suffix)
    expect(states_equal(torch, resumed.state, full.state),
           "checkpoint: the resumed run's state differs from the "
           "uninterrupted run's")
    expect(resumed.f1_per_round == full.f1_per_round[1:],
           f"checkpoint: F1 {resumed.f1_per_round} != "
           f"{full.f1_per_round[1:]}")
    expect(full.state.wire_state.seq.tolist() == [2] * N_NODES,
           "checkpoint: seq after 2 rounds")
    print("round 2 resumed from the checkpoint: the final state "
          "bit-identical to the uninterrupted run's, F1 "
          f"{resumed.f1_per_round}")


def run_stochastic(torch) -> None:
    """Phase ``stochastic``: the main path's 20-node payload
    (``{"protos", "student": Plane}``, :func:`codec_payload` on the plane)
    through ``quantize_dequantize_per_node`` with a stochastic 16-bit spec
    and a fixed key, and its codes through ``quantize_packed_buffer``: on
    the card bit for bit the CPU's; the call launches ``rowabs`` once and
    the codes sweep nowhere (the plain path, ``repro``'s routing with a
    key); the mean error over the payload within 5 sigma of 0, sigma =
    sqrt(sum of Δ_row^2 / 4) / n (each element's error lies in (-Δ, Δ)
    with mean 0 and variance at most Δ^2/4); and its codes differ from
    nearest rounding's."""
    from repro_torch.core.round_ops import quantize_dequantize_per_node
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.kernels.quantize import ops as Q
    from repro_torch.optim.plane import Plane, plane_from_tree
    from repro_torch.tree import tree_map
    from repro_torch.wirespec import WireSpec

    tree = codec_payload(torch, "mnist-cnn", 8)
    planes = [plane_from_tree(tree_map(lambda x: x[i], tree["student"]))
              for i in range(N_NODES)]
    card = {"protos": tree["protos"],
            "student": Plane(torch.stack([p.buf for p in planes]),
                             planes[0].meta)}
    host = {"protos": card["protos"].cpu(),
            "student": Plane(card["student"].buf.cpu(), planes[0].meta)}
    spec = WireSpec(16, stochastic_rounding=True)
    key = (0, 2024)                  # jax.random.PRNGKey(2024)'s words
    reset_launch_counts()
    t0 = time.time()
    recv = quantize_dequantize_per_node(card, spec=spec, rng=key)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = {k: v for k, v in launch_counts().items() if v}
    expect(got == {"rowabs": 1},
           f"stochastic: the call launched {got} != {{'rowabs': 1}}")
    want = quantize_dequantize_per_node(host, spec=spec, rng=key)
    for part in ("protos", "student"):
        a = recv[part].buf if part == "student" else recv[part]
        b = want[part].buf if part == "student" else want[part]
        expect(bits_equal(torch, a.cpu(), b),
               f"stochastic: the card's {part} differs from the CPU's")
    buf, ids, meta, _, _ = Q.pack_plane_payload(card["protos"],
                                                card["student"], spec)
    hbuf = buf.cpu()
    codes, deltas = Q.quantize_packed_buffer(buf, ids, meta[1], 16, rng=key)
    hcodes, hdeltas = Q.quantize_packed_buffer(hbuf, ids, meta[1], 16,
                                               rng=key)
    expect(bits_equal(torch, codes.cpu(), hcodes)
           and bits_equal(torch, deltas.cpu(), hdeltas),
           "stochastic: the card's codes differ from the CPU's")
    nearest, _ = Q.quantize_packed_buffer(buf, ids, meta[1], 16)
    flips = int((codes != nearest).sum())
    expect(flips > 0, "stochastic: the codes are nearest rounding's")
    row_delta = deltas[:, torch.as_tensor(ids, device=buf.device)]
    err = (codes.double() * row_delta.double()[:, :, None]
           - buf.double())
    n = buf.numel()
    mean = float(err.sum()) / n
    sigma = math.sqrt(float((row_delta.double() ** 2).sum())
                      * buf.shape[2] / 4) / n
    print(f"stochastic 16-bit on the {N_NODES}-node payload "
          f"{tuple(buf.shape)}: codes and reconstruction bit-identical to "
          f"the CPU's; {flips} codes off nearest rounding; mean error "
          f"{mean:.3e} (5 sigma {5 * sigma:.3e}); max |error|/Δ "
          f"{float((err.abs() / row_delta.double()[:, :, None]).max()):.4f};"
          f" the call took {seconds:.4f} s (host clock, the noise drawn "
          f"on the host)")
    expect(abs(mean) <= 5 * sigma,
           f"stochastic: mean error {mean} beyond 5 sigma {5 * sigma}")


def check_mix_packed(torch, timer, student_cfg):
    """Phase 3, the mesh exchange's fused mix: ``mix_packed`` against its
    plain version, bit for bit, on real mnist-cnn wire codes (R = 416
    rows of 512).  Timed: the ring path's shape ``own [1, R, 512]`` with 2
    senders, ``mesh/full-packed``'s (1 receiver, 8 senders, ``w_self``
    0), one rank holding eight nodes (``own [8, R, 512]``, 8 senders) and
    the accumulate form (the accumulator in ``own`` at weight one, one
    sender: a pipelined ring step).  Held bit for bit only: fp32 "codes"
    (raw buffers at unit delta) at 8×8, 12 receivers × 12 senders (two
    receiver groups, the second partial), a column tail (C = 510: one
    column a thread) and codes that start one element past a 16-byte
    address.  Each case prints the launch plan it took."""
    from dataclasses import asdict
    from repro_torch.kernels.quantize.ops import (mix_packed_init,
                                                  quantize_packed_buffer)
    from repro_torch.kernels.quantize.quantize import (mix_packed_cuda,
                                                       mix_plan)
    from repro_torch.kernels.quantize.ref import mix_packed_ref

    gen = torch.Generator().manual_seed(3)
    buf, seg_ids, meta, _, _ = payload_buffer(torch, gen, student_cfg)
    codes, scales = quantize_packed_buffer(buf, seg_ids, meta[1],
                                           seg_bits=meta[3])
    ids = torch.as_tensor(seg_ids, dtype=torch.int64, device="cuda")
    codes = codes.to(torch.int32)
    row_delta = scales[:, ids].contiguous()
    rows = {}
    cases = []

    def weights(m, s):
        w = torch.rand((m, s + 1), generator=gen).cuda()
        w = w / w.sum(dim=1, keepdim=True)
        return w[:, 0].contiguous(), w[:, 1:].contiguous()

    def case(name, own, cds, rd, w_self, w_rows, timed):
        m, r, c = own.shape
        s = cds.shape[0]
        got = mix_packed_cuda(own, cds, rd, w_self, w_rows)
        want = mix_packed_ref(own, cds, rd, w_self, w_rows)
        torch.cuda.synchronize()
        ulps = ulp_diff(torch, got, want)
        expect(ulps == 0, f"mix_packed ({name}) is not bit-exact with its "
                          f"plain version: {ulps} ulp")
        plan = mix_plan(m, s, r, c, all(t.data_ptr() % 16 == 0
                                        for t in (own, cds, got)))
        print(f"mix_packed {name}: own {tuple(own.shape)} codes "
              f"{tuple(cds.shape)} {cds.dtype}: bit-exact (plan {plan})")
        cases.append(name)
        if not timed:
            return plan
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
                          bound_by=b_by, library_ms=None, plan=asdict(plan))
        return plan

    w_self, w_rows = weights(1, 2)
    case("ring", buf[:1].contiguous(), codes[1:3].contiguous(),
         row_delta[1:3].contiguous(), w_self, w_rows, True)
    # the all-gather round: a rank's own copy rides among the 8 senders
    _, w_rows = weights(1, 8)
    case("full-packed", buf[:1].contiguous(), codes[:8].contiguous(),
         row_delta[:8].contiguous(), torch.zeros(1, device="cuda"), w_rows,
         True)
    w_self, w_rows = weights(8, 8)
    own8, codes8 = buf[:8].contiguous(), codes[8:16].contiguous()
    rd8 = row_delta[8:16].contiguous()
    case("8x8", own8, codes8, rd8, w_self, w_rows, True)
    case("8x8-fp32", own8, buf[8:16].contiguous(),
         torch.ones((8, buf.shape[1]), device="cuda"), w_self, w_rows, False)
    acc = mix_packed_init(buf[:1], w_self[:1]).contiguous()
    case("accumulate", acc, codes[1:2].contiguous(),
         row_delta[1:2].contiguous(), torch.ones(1, device="cuda"),
         w_rows[:1, :1].contiguous(), True)
    w12_self, w12_rows = weights(12, 12)
    plan = case("12x12", buf[:12].contiguous(), codes[8:20].contiguous(),
                row_delta[8:20].contiguous(), w12_self, w12_rows, False)
    expect(plan.grid[2] == 2, f"12 receivers took {plan.grid[2]} groups")
    plan = case("C=510", own8[..., :510].contiguous(),
                codes8[..., :510].contiguous(), rd8, w_self, w_rows, False)
    expect(plan.vec == 1, "a column tail took 16-byte vectors")
    flat = torch.empty(codes8.numel() + 1, dtype=torch.int32, device="cuda")
    flat[1:].copy_(codes8.flatten())
    plan = case("offset codes", own8, flat[1:].view(codes8.shape), rd8,
                w_self, w_rows, False)
    expect(plan.vec == 1, "codes off a 16-byte address took 16-byte loads")
    row = dict(name="mix_packed", route="cuda",
               source="src/repro_torch/csrc/quantize.cu",
               replaces="src/repro/kernels/quantize/quantize.py:374",
               **rows["ring"])
    row["m8s8"] = rows["8x8"]
    row["full_packed"] = rows["full-packed"]
    row["accumulate"] = rows["accumulate"]
    row["cases"] = cases
    print(f"  {'mix_packed':19s} kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  library None  bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    for name in ("full-packed", "8x8", "accumulate"):
        r = rows[name]
        print(f"  mix_packed {name:11s} kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return [row]


def mesh_inputs(n_images: int, nodes: int = MESH_NODES):
    """The mesh paths' configuration and data: mnist-cnn at full width,
    ``TrainConfig`` defaults, ``make_image_dataset(0, n_images, (28, 28,
    1), 10)`` with a 1/11 test split, iid over ``nodes`` nodes."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data import (make_image_dataset, partition,
                                  train_test_split)

    data = make_image_dataset(0, n_images, IMAGE_SHAPE["mnist-cnn"], 10)
    train_d, _ = train_test_split(data, 1 / 11, 0)
    parts = partition(train_d["label"], nodes, "iid", 0)
    node_data = [{k: v[i] for k, v in train_d.items()} for i in parts]
    return get_config("mnist-cnn"), TrainConfig(), node_data


def mesh_path(name: str):
    """A mesh path's entry, of ``MESH_PATHS`` or ``MESH_ROW_PATHS``, and
    its node count."""
    if name in MESH_ROW_PATHS:
        return MESH_ROW_PATHS[name], MESH_ROW_NODES
    return MESH_PATHS[name], MESH_NODES


def mesh_federation_parts(torch, cfg, train, name: str, device):
    """``(fed, wire, train_phase, node states maker)`` of the mesh path
    ``name``: the stacked engine's own wiring for the path's nodes
    (ProFe on the plane or per-leaf, the adapter wire, or FedAvg, by
    ``MESH_FED``)."""
    import dataclasses

    from repro_torch.config import FederationConfig
    from repro_torch.core import federation as F
    from repro_torch.core.profe import stack_states
    from repro_torch.models import derive_student
    from repro_torch.optim import make_optimizer, make_plane_optimizer

    (topo, _, wire, _, rounds, _, _), nodes = mesh_path(name)
    spec = parse_wire(wire)
    fed = dataclasses.replace(
        FederationConfig(num_nodes=nodes, topology=topo, rounds=rounds,
                         local_epochs=1), **wire_fields(spec),
        **MESH_FED.get(name, {}))
    algo = fed.algorithm
    student_cfg = derive_student(cfg)
    plane = F._plane_mode(fed, train, algo, student_cfg)
    opt_t = make_optimizer(train.optimizer, train.learning_rate,
                           weight_decay=train.weight_decay,
                           momentum=train.momentum)
    opt_s = make_plane_optimizer(train.optimizer, train.learning_rate,
                                 weight_decay=train.weight_decay,
                                 momentum=train.momentum,
                                 grad_clip=train.grad_clip) \
        if plane else opt_t
    step, wire_model, share, wire_spec, cfgs = F._algo_wiring(
        algo, cfg, student_cfg, fed, train, opt_s, opt_t)
    ncls = cfg.num_classes
    proto_cfg = cfgs[1] if algo in ("profe", "fml") else cfgs[0]
    adapters = bool(fed.adapter_rank)
    parts = F._make_round_parts(step, proto_cfg, ncls, bits=wire_spec,
                                share_protos=share, wire_model=wire_model,
                                adapter_rank=fed.adapter_rank,
                                adapter_grams=fed.adapter_grams)

    def states(nodes):
        """The stacked initial state of ``nodes`` (node i seeded
        ``seed * 1000 + i``, as ``run_federation`` seeds it), with the
        carries its wire needs (the adapter reference, the residual)."""
        init = F._init_states(algo, cfgs, fed, opt_s, opt_t, ncls, device,
                              plane=plane)
        return F._with_carries(
            stack_states([init[i] for i in nodes]), fed, wire_spec,
            torch.device(device), ncls, proto_cfg.proto_dim,
            use_plane=plane, adapters_on=adapters,
            ef_on=wire_spec is not None and wire_spec.error_feedback,
            ema=False)

    return fed, wire_spec, parts, states


def mesh_launches(name: str, fed, spec, steps: int, rounds: int,
                  plane: bool) -> dict:
    """A mesh path's launches on one rank: its optimizer's plane sweep a
    step (none for a per-leaf model), ``proto_accum`` a batch of the
    Eq. 3 pass where prototypes travel, one codec pair a round (the row
    absmax and the codes; ``+ef`` their residual forms; mixed widths the
    per-row qmax codes; nothing on FedAvg's fp32 wire), ``MESH_PATHS``'
    mixes a round and, on the adapter wire, a ``lowrank_apply`` a matrix
    leaf a round."""
    mix = mesh_path(name)[0][6]
    want = {"mix_packed": mix * rounds}
    if fed.algorithm == "fedavg":
        return want
    want.update(proto_accum=steps, adamw_update=steps if plane else 0)
    if spec.error_feedback:
        want.update(rowabs_sum=rounds, quantize_rows_ef=rounds)
    elif spec.uniform_bits is not None:
        want.update(rowabs=rounds, quantize_rows=rounds)
    else:
        want.update(rowabs=rounds, quantize_rows_mixed=rounds)
    if fed.adapter_rank:
        want["lowrank_apply"] = ADAPTER_LEAVES * rounds
    return want


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


def digest(torch, tensors) -> str:
    """A sha256 of the tensors' bytes, in order: two replicas of a node
    compare by it across ranks."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mesh_path_rank(torch, name: str, inputs, node: int, sizes, dev,
                   ranks_per_node: int = 1) -> dict:
    """One mesh path on this rank, holding node ``node`` (a replica of
    it with ``ranks_per_node`` > 1) of ``inputs`` (:func:`mesh_inputs`):
    each round its node's local training,
    then the mesh round; the rank's bytes a round (pod groups, and the
    node groups apart), launches, seq and finite values checked.  Returns
    the path's report, with a digest of the final student, prototypes,
    mask (and residual)."""
    from repro_torch.core import federation as F
    from repro_torch.core import mesh_federation as M
    from repro_torch.core.topology import make_schedule
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.optim.plane import Plane
    from repro_torch.tree import keyed_leaves

    cfg, train, node_data = inputs
    (topo, exchange, _, overlap, rounds, want_bytes, _), nodes = \
        mesh_path(name)
    fed, spec, parts, states = mesh_federation_parts(torch, cfg, train, name,
                                                     dev)
    train_phase = parts[0]
    adj = (None if topo == "full"
           else make_schedule(nodes, topo).adjacency_at(0))
    fedavg = fed.algorithm == "fedavg"
    if fedavg:
        round_fn = M.make_fedavg_round(adjacency=adj, exchange=exchange,
                                       ranks_per_node=ranks_per_node)
    else:
        round_fn = M.make_profe_round(
            adjacency=adj, exchange=exchange, spec=spec, overlap=overlap,
            adapter_rank=fed.adapter_rank, adapter_grams=fed.adapter_grams,
            ranks_per_node=ranks_per_node)
    state = states([node])
    plane = isinstance(state.student, Plane)
    ef = spec is not None and spec.error_feedback
    steps = rounds * (len(node_data[node]["label"]) // train.batch_size)
    t0 = time.time()
    sent, inner, round_s = [], [], []
    reset_launch_counts()
    for rnd in range(rounds):
        state, protos, counts = train_nodes(
            fed, train, train_phase, state, node_data, [node], rnd, dev)
        before = (M.COLLECTIVE_BYTES.count, M.COLLECTIVE_BYTES.inner)
        t_round = time.time()
        carry = [state.adapter_state] if fed.adapter_rank else []
        carry += [state.wire_state] if ef else []
        out = round_fn(state.student, sizes) if fedavg else \
            round_fn(state.student, protos, counts, sizes, *carry)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        round_s.append(time.time() - t_round)
        sent.append(M.COLLECTIVE_BYTES.count - before[0])
        inner.append(M.COLLECTIVE_BYTES.inner - before[1])
        with torch.no_grad():
            F._copy_into(state.student, out if fedavg else out[0])
        checked = [("student", v) for _, v in keyed_leaves(state.student)]
        if not fedavg:
            gp, mask = ((out[1], out[2]) if adj is not None
                        else (out[1][None], out[2][None]))
            state = state._replace(
                global_protos=gp, proto_mask=mask,
                adapter_state=out[3] if fed.adapter_rank else None,
                wire_state=out[-1] if ef else None)
            checked.append(("prototypes", gp))
            expect(float(mask.sum()) > 0,
                   f"{name} node {node} round {rnd}: empty mask")
        for what, t in checked:
            expect(bool(torch.isfinite(t).all()),
                   f"{name} node {node} round {rnd}: {what} not finite")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update(mesh_launches(name, fed, spec, steps, rounds, plane))
    for kernel, n in want.items():
        expect(dev.type != "cuda" or counts[kernel] == n,
               f"{name} node {node}: {kernel} launched {counts[kernel]} != "
               f"{n}")
    expect(sent == [want_bytes] * rounds,
           f"{name} node {node}: bytes handed to collectives {sent} != "
           f"{want_bytes} a round")
    if ef:
        expect(state.wire_state.seq.tolist() == [rounds],
               f"{name} node {node}: seq {state.wire_state.seq.tolist()}")
    student_max = max(float(v.detach().abs().max())
                      for _, v in keyed_leaves(state.student))
    final = [v for _, v in keyed_leaves(state.student)]
    if not fedavg:
        final += [state.global_protos, state.proto_mask]
    if ef:
        final += [v for _, v in keyed_leaves(state.wire_state.residual)]
    return dict(launches=counts, bytes_per_round=sent,
                inner_bytes_per_round=inner, seconds=time.time() - t0,
                mesh_round_s=round_s, student_abs_max=student_max,
                mask=None if fedavg else state.proto_mask.tolist(),
                digest=digest(torch, final))


def mesh_rank(rank: int, world: int, init: str, out_dir: str, device: str,
              n_images: int) -> None:
    """Phase 11 on one spawned rank: its node through every path of
    ``MESH_PATHS`` (train, then the mesh round, each round), then, as
    inner index ``rank % 2`` of node ``rank // 2``, through every path of
    ``MESH_ROW_PATHS`` (deterministic algorithms: the node's replicas
    train alike); the report goes to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.profe import resolve_device

    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        report = {}
        for names, nodes, images, node in (
                (MESH_PATHS, MESH_NODES, n_images, rank),
                (MESH_ROW_PATHS, MESH_ROW_NODES,
                 n_images * MESH_ROW_IMAGES // 7040,
                 rank // MESH_RANKS_PER_NODE)):
            inputs = mesh_inputs(images, nodes)
            sizes = torch.tensor([len(d["label"]) for d in inputs[2]],
                                 dtype=torch.float32, device=dev)
            row = names is MESH_ROW_PATHS
            if row:
                torch.backends.cudnn.deterministic = True
                torch.use_deterministic_algorithms(True, warn_only=True)
            for name in names:
                report[name] = mesh_path_rank(
                    torch, name, inputs, node, sizes, dev,
                    MESH_RANKS_PER_NODE if row else 1)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run_mesh(torch, device: str = "cuda", n_images: int = 7040,
             rank_fn=mesh_rank) -> dict:
    """Phase 11: spawn ``MESH_NODES`` ranks (``spawn`` start method, a
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
    for name in list(MESH_PATHS) + list(MESH_ROW_PATHS):
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
        if name in MESH_ROW_PATHS:
            m = MESH_RANKS_PER_NODE
            digests = [p["digest"] for p in per]
            print(f"{name}: node-group bytes per rank and round "
                  f"{sorted({b for p in per for b in p['inner_bytes_per_round']})}"
                  f" beside the pod groups' above; replicas bit-identical: "
                  f"{[len(set(digests[i * m:(i + 1) * m])) == 1 for i in range(MESH_ROW_NODES)]}")
            expect(all(len(set(digests[i * m:(i + 1) * m])) == 1
                       for i in range(MESH_ROW_NODES)),
                   f"{name}: the ranks of a node end with different states")
            expect(MESH_ROW_PATHS[name][0] == "full"
                   or len(set(digests)) == MESH_ROW_NODES,
                   f"{name}: sparse gossip left nodes identical")
    # Table II on the mesh: what a rank hands to its collectives a round
    # for FedAvg's fp32 model against ProFe's 16-bit student + prototypes,
    # on the same full-packed exchange
    fedavg, profe = (reports[0][n]["bytes_per_round"][0]
                     for n in ("mesh/fedavg/full-packed", "mesh/full-packed"))
    print(f"Table II on the mesh (full-packed, B a rank a round): fedavg "
          f"{fedavg}  profe {profe}  ratio {profe / fedavg:.4f}")
    return totals


def check_mesh_parity(torch, device: str = "cuda",
                      n_images: int = 7040) -> None:
    """Phase 12: one rank of a one-rank gloo group holds all
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


def check_mesh_adapter_parity(torch, device: str = "cuda",
                              n_images: int = 7040) -> None:
    """Phase 12, the adapter wire: one rank of a one-rank gloo group
    holds all ``MESH_NODES`` nodes of ``mesh/adapters8`` (ring, rank 8,
    ``4,adapters=8``).  After one round of local training, the packed
    adapter round and the stacked engine's ``share_phase`` +
    ``mix_phase`` run on copies of the same state: students within 4
    ulp of their largest magnitude, prototypes, mask and the new adapter
    references bit for bit."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import mesh_federation as M
    from repro_torch.core.profe import resolve_device
    from repro_torch.core.topology import make_schedule
    from repro_torch.optim.plane import Plane
    from repro_torch.tree import tree_leaves

    dev = resolve_device(device)
    cfg, train, node_data = mesh_inputs(n_images)
    nodes = list(range(MESH_NODES))
    fed, spec, parts, states = mesh_federation_parts(
        torch, cfg, train, "mesh/adapters8", dev)
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
            round_fn = M.make_profe_round(
                adjacency=sched.adjacency_at(0), exchange="packed",
                spec=spec, adapter_rank=fed.adapter_rank)
            got = round_fn(Plane(state.student.buf.detach().clone(),
                                 state.student.meta), protos, counts,
                           torch.tensor(sizes, dtype=torch.float32,
                                        device=dev), state.adapter_state)
        finally:
            dist.destroy_process_group()
    st = state._replace(student=Plane(state.student.buf.detach().clone(),
                                      state.student.meta))
    st, recv, protos_rx = share_phase(st, protos)
    w_self, w_neigh, include = (torch.as_tensor(x[0], device=dev)
                                for x in sched.lower(sizes))
    st = mix_phase(st, recv, protos_rx, counts, w_self, w_neigh, include)
    want = st.student.buf.detach()
    tol = 4 * float(torch.finfo(torch.float32).eps) * 2.0 ** math.floor(
        math.log2(float(want.abs().max())))
    err = float((got[0].buf - want).abs().max())
    same = (torch.equal(got[1], st.global_protos)
            and torch.equal(got[2], st.proto_mask)
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got[3]), tree_leaves(st.adapter_state))))
    print(f"one rank, {MESH_NODES} nodes, packed adapter round against "
          f"share_phase + mix_phase: max |student difference| {err:.3e} "
          f"(bound {tol:.3e}); prototypes, mask and adapter state "
          f"bit-exact: {same}")
    expect(err <= tol, "the one-rank adapter round's students differ from "
                       "the stacked engine's beyond 4 ulp")
    expect(same, "the one-rank adapter round's prototypes, mask or adapter "
                 "state differ from the stacked engine's")


def mesh_lm_rank(rank: int, world: int, init: str, out_dir: str,
                 device: str, ranks_per_node: int = 1) -> None:
    """The ``mesh/lm/mamba2-130m`` phase on one spawned rank: its
    mamba2-130m node (full width and depth, the student on the plane)
    takes one round of local training (``LM_BATCHES`` batches of
    ``LM_BATCH`` × 256 tokens and the Eq. 3 pass), then one ring
    ``ppermute`` round of the 16-bit wire.  With ``ranks_per_node`` = 2
    (``mesh/lm/mamba2-130m/4x2``) the rank is inner index ``rank % 2`` of
    node ``rank // 2``, its replica trains one batch under deterministic
    algorithms, and the round is the row-sharded permute.  Checks the
    plane's shape, the bytes handed to the pod groups (``MESH_LM_BYTES``
    or ``MESH_LM_4X2_BYTES``), finite students and prototypes and, on
    the card, every launch; reports the round's seconds, the node-group
    bytes, a digest of the result and the rank's peak memory to
    ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.config import FederationConfig, TrainConfig
    from repro_torch.core import federation as F
    from repro_torch.core import mesh_federation as M
    from repro_torch.core.profe import (init_node_state, resolve_device,
                                        stack_states)
    from repro_torch.core.topology import make_schedule
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    from repro_torch.models import derive_student
    from repro_torch.optim import make_optimizer, make_plane_optimizer

    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        m = ranks_per_node
        nodes, node = world // m, rank // m
        name = MESH_LM if m == 1 else MESH_LM_4X2
        batches = LM_BATCHES if m == 1 else 1
        arch, smoke, optimizer, _, _, seq, _, _ = LM_PATHS["lm/mamba2-130m"]
        cfg, node_data, _ = lm_inputs(arch, smoke, nodes, seq)
        node_data = [{k: v[:batches * LM_BATCH] for k, v in d.items()}
                     for d in node_data]
        fed = FederationConfig(num_nodes=nodes, topology="ring", rounds=1,
                               local_epochs=1, quantize_bits=16)
        train = TrainConfig(batch_size=LM_BATCH, optimizer=optimizer)
        student_cfg = derive_student(cfg)
        opt_t = make_optimizer(optimizer, train.learning_rate,
                               weight_decay=train.weight_decay)
        opt_s = make_plane_optimizer(optimizer, train.learning_rate,
                                     weight_decay=train.weight_decay,
                                     grad_clip=train.grad_clip)
        step, _, _, spec, _ = F._algo_wiring("profe", cfg, student_cfg, fed,
                                             train, opt_s, opt_t)
        ncls = F._n_proto_classes(cfg)
        train_phase = F._make_round_parts(step, student_cfg, ncls,
                                          bits=spec)[0]
        state = stack_states([init_node_state(
            cfg, student_cfg,
            torch.Generator().manual_seed(fed.seed * 1000 + node), opt_s,
            opt_t, ncls, device=dev)])
        expect(tuple(state.student.buf.shape) == MESH_LM_PLANE,
               f"{name}: plane {tuple(state.student.buf.shape)}")
        sizes = torch.tensor([len(next(iter(d.values()))) for d in node_data],
                             dtype=torch.float32, device=dev)
        round_fn = M.make_profe_round(
            adjacency=make_schedule(nodes, "ring").adjacency_at(0),
            exchange="ppermute", spec=spec, ranks_per_node=m)
        if m > 1:
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        t0 = time.time()
        state, protos, counts = train_nodes(fed, train, train_phase, state,
                                            node_data, [node], 0, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.time()
        before = (M.COLLECTIVE_BYTES.count, M.COLLECTIVE_BYTES.inner)
        out = round_fn(state.student, protos, counts, sizes)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        round_s = time.time() - t1
        sent = M.COLLECTIVE_BYTES.count - before[0]
        inner = M.COLLECTIVE_BYTES.inner - before[1]
        got = launch_counts()
        want = {k: 0 for k in got}
        want.update(adamw_update=batches, proto_accum=batches, rowabs=1,
                    quantize_rows=1, mix_packed=1 if m == 1 else 2)
        for kernel, n in want.items():
            expect(dev.type != "cuda" or got[kernel] == n,
                   f"{name} rank {rank}: {kernel} launched {got[kernel]} "
                   f"!= {n}")
        want_bytes = MESH_LM_BYTES if m == 1 else MESH_LM_4X2_BYTES
        expect(sent == want_bytes,
               f"{name} rank {rank}: bytes handed to collectives {sent} "
               f"!= {want_bytes}")
        for what, t in (("student", out[0].buf), ("prototypes", out[1])):
            expect(bool(torch.isfinite(t).all()),
                   f"{name} rank {rank}: {what} not finite")
        expect(float(out[2].sum()) > 0, f"{name} rank {rank}: empty mask")
        report = dict(
            launches=got, bytes=sent, inner_bytes=inner, train_s=t1 - t0,
            round_s=round_s,
            peak_bytes=torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None,
            plane=list(state.student.buf.shape),
            student_abs_max=float(out[0].buf.abs().max()),
            digest=digest(torch, [out[0].buf, out[1], out[2]]))
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run_mesh_lm(torch, smi: str, device: str = "cuda",
                ranks_per_node: int = 1) -> dict:
    """Phase 11a, ``mesh/lm/mamba2-130m``: ``MESH_LM_RANKS`` nodes of
    ``ranks_per_node`` spawned ranks each in one gloo group on one card
    (:func:`mesh_lm_rank`).  Prints one ``mesh lm {...}`` line (``mesh lm
    4x2 {...}`` with 2 ranks a node) with each rank's round seconds,
    node-group bytes and peak memory beside the card, and checks that a
    node's ranks end bit-identical; returns the launches summed over the
    ranks."""
    import tempfile

    import torch.multiprocessing as mp

    m = ranks_per_node
    world = MESH_LM_RANKS * m
    name = MESH_LM if m == 1 else MESH_LM_4X2
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            mesh_lm_rank, args=(world, f"file://{tmp}/store", tmp, device,
                                m),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_DEADLINE_S
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                expect(time.monotonic() < deadline,
                       f"{name} ranks still running after "
                       f"{MESH_DEADLINE_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        reports = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                   for r in range(world)]
    digests = [r["digest"] for r in reports]
    same = [len(set(digests[i * m:(i + 1) * m])) == 1
            for i in range(MESH_LM_RANKS)]
    line = {"path": name, "ranks": world, "ranks_per_node": m, "card": smi,
            "plane": reports[0]["plane"],
            "bytes_per_rank": [r["bytes"] for r in reports],
            "inner_bytes_per_rank": [r["inner_bytes"] for r in reports],
            "train_s": [r["train_s"] for r in reports],
            "round_s": [r["round_s"] for r in reports],
            "peak_bytes": [r["peak_bytes"] for r in reports],
            "replicas_identical": same,
            "student_abs_max": max(r["student_abs_max"] for r in reports)}
    print(("mesh lm " if m == 1 else "mesh lm 4x2 ") + json.dumps(line),
          flush=True)
    expect(all(same), f"{name}: the ranks of a node end with different "
                      f"states")
    return {k: sum(r["launches"][k] for r in reports)
            for k in reports[0]["launches"]}


def run_audit(smi: str) -> None:
    """The wire audit on the card: ``python -m repro_torch.launch.dryrun
    --arch mnist-cnn --topology ring --pods 4x2 --bits 4/16 --ef`` as a
    subprocess (its ranks on this card), which must exit 0; its report's
    pod permute bytes a node must equal its prediction.  Prints an
    ``audit {...}`` line."""
    out = ROOT / "build" / "audit.json"
    out.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    run = subprocess.run([sys.executable, *AUDIT_CMD, "--json", str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=AUDIT_TIMEOUT_S, cwd=ROOT)
    took = time.time() - t0
    if run.returncode != 0:
        print(run.stdout[-4000:], run.stderr[-4000:], sep="\n")
    expect(run.returncode == 0, f"the audit exited {run.returncode}")
    report = json.loads(out.read_text())
    checks = {c.get("check", "topology") + "/" + c["exchange"]: c
              for c in report["checks"]}
    perm = checks["topology/ppermute"]["permute_bytes_per_node"]
    pred = report["packed_pred_bytes_per_node"]
    expect(perm == pred, f"the audit's pod permute bytes {perm} != its "
                         f"prediction {pred}")
    ex = report["exchanges"]
    print("audit " + json.dumps({
        "cmd": " ".join(AUDIT_CMD), "card": smi, "seconds": took,
        "device": report["device"], "bits": report["bits"],
        "packed_pred_bytes_per_node": pred, "permute_bytes_per_node": perm,
        "collective_bytes_per_node": {
            k: v.get("collective_bytes_per_node") for k, v in ex.items()},
        "full_gather_bytes_per_node": report["full_gather_bytes_per_node"],
        "inner_by_axis": ex["ppermute"].get("by_axis"),
        "checks": sorted(checks)}), flush=True)
    out.unlink()


def profile_rounds(torch, inputs, name: str) -> None:
    """Phase 15 (``--profile``): where a round's time goes on the path
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

    _, optimizer, wire, rounds, _ = PATHS[name]
    cfg, fed, train, node_data, test_d = inputs
    fed = dataclasses.replace(fed, rounds=rounds,
                              **wire_fields(parse_wire(wire)),
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


# the serve phase's full-width runs: arch -> (layers kept, None for the
# config's own depth; the JAX package's param_count at that depth, from
# shapes — tests/test_torch_lm_serve.py holds these constants to it)
SERVE_FULL = {"yi-6b": (None, 5_815_672_832),
              "mamba2-130m": (None, 129_574_080),
              "whisper-small": (None, 238_791_168),
              "llama4-scout-17b-a16e": (2, 5_213_255_680)}
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 16, 32
# decode-after-prefill against forward at the smoke size in fp32: the
# JAX package's own bound (tests/test_models.py), absolute
SERVE_SMOKE_TOL = 2e-2
# at full width, relative to max|forward logits|: bf16 keeps 8 bits, and
# decode and forward round the attention (bf16 probabilities against the
# fp32 online softmax), the SSD state (stepped against chunked) and the
# matmuls (other shapes) at other places, which 12-32 random-weight
# layers amplify (0.1-5.4 % at reduced width on the CPU); fp32 keeps 24
# bits (2e-7-2e-6 there)
SERVE_BF16_TOL = 0.1
SERVE_FP32_TOL = 1e-3


def serve_inputs(torch, cfg, batch: int, seq: int, seed: int,
                 device: str = "cuda"):
    """Prompt tokens and (audio, VLM) random frontend embeddings of
    scale 0.02, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, seq))).to(device)}
    for key, n in (("image_embed", cfg.num_image_tokens if cfg.family ==
                    "vlm" else 0), ("audio_embed", cfg.encoder_seq if
                                    cfg.family == "audio" else 0)):
        if n:
            out[key] = torch.from_numpy((rng.standard_normal(
                (batch, n, cfg.d_model)) * 0.02).astype(np.float32)).to(device)
    return out


# the lines of the runs the roofline phase (14g) counts, filled by the
# serve (14a), train (14b) and programs (14c) phases: name -> line
TIMED: dict = {}


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def decode_gap(torch, cfg, params, batch) -> tuple:
    """Prefill all but the last token into a cache one longer, decode
    the last: ``(max |decode - forward's last logits|, max |forward's
    last logits|, prefill ms)``, the prefill timed on the host clock
    (synchronized), the median of 3 after one warm-up."""
    from repro_torch.models import build_memory, decode_step, forward, \
        prefill
    device = batch["tokens"].device.type
    seq = batch["tokens"].shape[1]
    pre = dict(batch, tokens=batch["tokens"][:, :seq - 1])
    with torch.inference_mode():
        want = forward(cfg, params, batch).logits[:, -1].float()
        memory = build_memory(cfg, params, batch)
        times = []
        for _ in range(4):
            sync(torch, device)
            t0 = time.perf_counter()
            _, cache = prefill(cfg, params, pre, cache_len=seq)
            sync(torch, device)
            times.append((time.perf_counter() - t0) * 1e3)
        got, _ = decode_step(cfg, params, batch["tokens"][:, seq - 1:],
                             seq - 1, cache, memory)
    expect(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite logits")
    return (float((got.float() - want).abs().max()),
            float(want.abs().max()), statistics.median(times[1:]))


def run_serve(torch, smi: str, device: str = "cuda",
              full: dict = SERVE_FULL) -> list:
    """Phase 14a (see the module's docstring); nothing is caught.
    Returns the full-width runs' lines."""
    from repro_torch.config import get_config
    from repro_torch.configs import ASSIGNED
    from repro_torch.core.profe import resolve_device
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import decode_step, init_cache, init_params, \
        param_count
    resolve_device(device)             # TF32 off: fp32 stays fp32
    for arch in ASSIGNED:
        cfg = get_config(arch).smoke().replace(dtype="float32",
                                               param_dtype="float32")
        params = init_params(cfg, torch.Generator(device).manual_seed(0))
        err, _, _ = decode_gap(torch, cfg, params,
                               serve_inputs(torch, cfg, 2, 8, 0, device))
        print(f"smoke {arch}: decode-after-prefill against forward "
              f"{err:.3e} (limit {SERVE_SMOKE_TOL})")
        expect(err < SERVE_SMOKE_TOL, f"{arch}: decode/forward gap {err}")
    cfg = get_config("yi-6b").smoke().replace(
        dtype="float32", param_dtype="float32", sliding_window_serve=8)
    params = init_params(cfg, torch.Generator(device).manual_seed(0))
    cache = init_cache(cfg, 1, 8, torch.float32, device)
    tok = torch.ones((1, 1), dtype=torch.long, device=device)
    with torch.inference_mode():
        for i in range(20):
            logits, cache = decode_step(cfg, params, tok, i, cache,
                                        rolling=True)
    expect(bool(torch.isfinite(logits).all()), "rolling decode: non-finite")
    print("smoke yi-6b: 20 rolling decode steps through an 8-slot window, "
          "finite logits")
    del params, cache

    lines = []
    for arch, (layers, count) in full.items():
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        argv = ["--arch", arch, "--full-config", "--batch", str(SERVE_BATCH),
                "--prompt-len", str(SERVE_PROMPT), "--tokens",
                str(SERVE_TOKENS), "--device", device]
        if layers is not None:
            argv += ["--layers", str(layers)]
        res = launch_serve.main(argv)
        cfg, params = res["cfg"], res["params"]
        n = param_count(params)
        expect(n == count, f"{arch}: {n} parameters, the JAX package's "
               f"{count}")
        expect(bool(torch.isfinite(res["last_logits"]).all()),
               f"{arch}: non-finite serve logits")
        peak = (torch.cuda.max_memory_allocated if device == "cuda"
                else lambda: None)
        peak_serve = peak()
        batch = serve_inputs(torch, cfg, SERVE_BATCH, SERVE_PROMPT, 1, device)
        gap, ymax, prefill_ms = decode_gap(torch, cfg, params, batch)
        gap32, ymax32, _ = decode_gap(torch, cfg.replace(dtype="float32"),
                                      params, batch)
        depth = get_config(arch).num_layers
        line = {"arch": arch, "layers": cfg.num_layers,
                "reduced": (None if layers is None else
                            f"{layers} of {depth} layers: the full depth "
                            f"does not fit one card"),
                "params": n, "param_dtype": cfg.param_dtype,
                "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
                "tokens": SERVE_TOKENS, "init_s": res["init_s"],
                "memory_ms": res["memory_ms"],
                "first_step_ms": res["first_step_ms"],
                "step_ms": res["step_ms"],
                "tokens_per_s": res["tokens_per_s"],
                "prefill_ms": prefill_ms,
                "peak_bytes_serve": peak_serve, "peak_bytes": peak(),
                "bf16_gap": gap / ymax, "fp32_gap": gap32 / ymax32,
                "device": device, "card": smi}
        print("serve " + json.dumps(line), flush=True)
        TIMED[f"serve/{arch}"] = line
        expect(gap <= SERVE_BF16_TOL * ymax,
               f"{arch}: bf16 decode/forward gap {gap / ymax:.3e}")
        expect(gap32 <= SERVE_FP32_TOL * ymax32,
               f"{arch}: fp32 decode/forward gap {gap32 / ymax32:.3e}")
        lines.append(line)
        del res, params, batch
    return lines


# the train phase's full-width runs: arch -> (layers kept, None for the
# config's own depth; the JAX package's teacher and student parameter
# counts at that depth, from shapes — tests/test_torch_lm_federation.py
# holds these constants to it)
TRAIN_FULL = {"mamba2-130m": (None, 129_574_080, 84_390_240),
              "whisper-small": (None, 238_791_168, 111_278_592),
              "yi-6b": (2, 624_975_872, 489_709_568)}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 4, 256
# the full-width runs' audio and image frontend stubs: normal draws of
# this scale (the serve phase's); zero stubs keep an encoder's residual
# stream at exactly 0, where every LayerNorm's backward multiplies the
# gradient by 1/sqrt(eps): whisper-small's 24 encoder norms overflow it
# (NaN in the first step; 2 encoder layers give gradients of 6e10)
TRAIN_FRONTEND_SCALE = 0.02
# the LM federations: name -> (arch, smoke size?, optimizer, nodes,
# rounds, sequence length, student on the plane?, the JAX package's
# (avg_sent_gb, packed B/copy, logical B/copy) on the 16-bit wire, full
# graph, computed once on the CPU from shapes as PATHS' are)
LM_PATHS = {
    "lm/mamba2-130m": ("mamba2-130m", False, "adamw", 4, 2, 256, True,
                       (1.013273832, 168886584, 168878972)),
    "lm/grok-1/per-leaf": ("grok-1-314b", True, "adafactor", 4, 1, 64,
                           False, (0.001682148, 565336, 560716)),
}
# each LM node holds LM_BATCHES batches of LM_BATCH sequences; the test
# split is LM_TEST sequences
LM_BATCHES, LM_BATCH, LM_TEST = 2, 4, 16
# the kernels an LM federation launches, with the path that phase 3's
# check_lm_shapes holds at its shapes
LM_KERNELS = ("adamw_update", "proto_accum", "rowabs", "quantize_rows")


class deterministic_algorithms:
    """Deterministic cuDNN and ``torch.use_deterministic_algorithms``
    (warn-only: an op without a deterministic version warns, it does not
    raise; the embedding's accumulating backward has one) inside the
    block, both restored after."""

    def __init__(self, torch):
        self.torch = torch
        self.cudnn = deterministic_cudnn(torch)

    def __enter__(self):
        torch = self.torch
        self.was = (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
        self.cudnn.__enter__()
        torch.use_deterministic_algorithms(True, warn_only=True)
        print(f"deterministic algorithms: {self.was[0]} -> True")

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.was[0],
                                                warn_only=self.was[1])
        print(f"deterministic algorithms restored to {self.was[0]}")
        return self.cudnn.__exit__(*exc)


def lm_inputs(arch: str, smoke: bool, nodes: int, seq: int):
    """An LM federation's config and iid data: ``make_token_dataset``,
    ``LM_BATCHES · LM_BATCH`` sequences a node in order, then ``LM_TEST``
    for the test split."""
    from repro_torch.config import get_config
    from repro_torch.data import make_token_dataset
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    per = LM_BATCHES * LM_BATCH
    data = make_token_dataset(0, nodes * per + LM_TEST, seq, cfg.vocab_size,
                              cfg.n_proto_classes)
    node_data = [{k: v[i * per:(i + 1) * per] for k, v in data.items()}
                 for i in range(nodes)]
    test = {k: v[nodes * per:] for k, v in data.items()}
    return cfg, node_data, test


def run_lm_path(torch, name: str, device: str = "cuda") -> dict:
    """An LM federation of ``LM_PATHS`` through ``run_federation`` (ProFe,
    full graph, 1 local epoch, the 16-bit wire), the launch counts set to
    0 just before and read just after: finite F1 every round, the
    resolved student (plane or per-leaf), every node's step counters,
    every launch exactly (one plane sweep a step where the student is on
    the plane, one ``proto_accum`` a batch of the Eq. 3 pass, one
    ``rowabs`` and one ``quantize_rows`` a round; nothing else) and the
    wire bytes against the JAX package's.  Returns the launch counts."""
    from repro_torch.config import FederationConfig, TrainConfig
    from repro_torch.core.federation import run_federation
    from repro_torch.kernels.build import launch_counts, reset_launch_counts
    arch, smoke, optimizer, nodes, rounds, seq, plane, want_bytes = \
        LM_PATHS[name]
    cfg, node_data, test = lm_inputs(arch, smoke, nodes, seq)
    fed = FederationConfig(num_nodes=nodes, topology="full", rounds=rounds,
                           local_epochs=1, quantize_bits=16)
    train = TrainConfig(batch_size=LM_BATCH, optimizer=optimizer)
    print(f"{cfg.name}: profe, {nodes} nodes x {LM_BATCHES * LM_BATCH} "
          f"sequences of {seq}, batch {LM_BATCH}, {optimizer}, 16-bit "
          f"wire, {rounds} round(s), student dtype {cfg.param_dtype}")
    steps = rounds * LM_BATCHES
    launches = {k: 0 for k in launch_counts()}
    if device == "cuda":        # on the CPU the plain versions run
        launches.update({OPT_KERNEL[optimizer]: steps if plane else 0,
                         "proto_accum": steps, "rowabs": rounds,
                         "quantize_rows": rounds})
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    res = run_federation(cfg, fed, train, node_data, test, verbose=True,
                         device=device)
    took = time.time() - t0
    counts = launch_counts()
    expect(res.extras["param_plane"] is plane,
           f"{name}: param_plane resolved to {res.extras['param_plane']}")
    got_steps = res.state.opt_s["step"].tolist()
    expect(got_steps == [steps] * nodes,
           f"{name}: student step counters {got_steps}")
    print(f"per-round F1: {res.f1_per_round}")
    print(f"per-round seconds: {res.extras['round_times_s']}")
    print(f"launches on the {name} path: "
          f"{ {k: v for k, v in counts.items() if v} }")
    expect(len(res.f1_per_round) == rounds
           and all(math.isfinite(f) for f in res.f1_per_round),
           f"{name}: expected {rounds} finite F1 values, got "
           f"{res.f1_per_round}")
    for kernel in set(launches) | set(counts):
        got, want = counts.get(kernel, 0), launches.get(kernel, 0)
        expect(got == want, f"{name} path: {kernel} launched {got} != {want}")
    for key, want in zip(("avg_sent_gb", "wire_bytes_packed_per_copy",
                          "wire_bytes_per_copy"), want_bytes):
        expect(res.extras[key] == want,
               f"{name} path: {key} {res.extras[key]!r} != the JAX "
               f"package's {want!r}")
    line = {"path": name, "arch": arch, "smoke": smoke, "nodes": nodes,
            "rounds": rounds, "seq": seq, "batch": LM_BATCH,
            "steps": steps, "plane": plane,
            "f1": res.f1_per_round, "round_s": res.extras["round_times_s"],
            "seconds": took,
            "avg_sent_gb": res.extras["avg_sent_gb"],
            "peak_bytes": torch.cuda.max_memory_allocated()
            if device == "cuda" else None}
    print("lm path " + json.dumps(line), flush=True)
    del res
    return counts


PROGRAM_ATOL = 2e-5                # fp32 parameters after one step
PROGRAM_EPS_ELEMENTS = 4           # Adam's eps regime, each within + 2·lr


def program_state(torch, cfg, seed: int, device):
    """One node's unstacked per-leaf state of ``cfg`` and its student,
    drawn on ``device`` from ``seed``, with the program's optimizer."""
    from repro_torch.core.profe import init_node_state
    from repro_torch.models import derive_student
    from repro_torch.optim import make_optimizer
    opt = make_optimizer(cfg.optimizer, LR)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_node_state(cfg, derive_student(cfg), gen, opt, opt,
                           cfg.n_proto_classes, plane=False, device=device)


def run_programs(torch, smi: str, device: str = "cuda", *,
                 full_smoke: bool = False) -> None:
    """Phase 14c, the microbatched train program
    (``launch/programs.make_profe_train_fn``; per-leaf, no kernel of the
    table).  At yi-6b's smoke size in fp32 with every prototype class
    set, ``microbatches=4`` against 1 on one batch of 4 × 16 from the same
    state: losses and gradient norm within rtol 1e-5, parameters within
    ``PROGRAM_ATOL`` but for ``PROGRAM_EPS_ELEMENTS`` (reassociation
    only: the four microbatch means average to the batch's).  Then yi-6b
    at full width cut to ``PROGRAM_LAYERS`` layers, remat on, for each of
    ``PROGRAM_RUNS`` (batch, microbatches) ``PROGRAM_STEPS`` steps of 256
    tokens: finite losses; one ``programs {...}`` line with ms a step
    and peak memory of each, beside the card.  ``full_smoke`` runs the
    second part at yi-6b's smoke size (a CPU check of the phase)."""
    import numpy as np

    from repro_torch.config import FederationConfig, TrainConfig, get_config
    from repro_torch.core.profe import resolve_device
    from repro_torch.launch.programs import make_profe_train_fn
    from repro_torch.launch.train import token_batches
    from repro_torch.models import derive_student
    from repro_torch.tree import tree_leaves

    dev = resolve_device(device)
    fed = FederationConfig()

    def program(cfg, m):
        return make_profe_train_fn(cfg, derive_student(cfg), fed,
                                   TrainConfig(learning_rate=LR,
                                               optimizer=cfg.optimizer,
                                               microbatches=m))[0]

    cfg = get_config("yi-6b").smoke().replace(dtype="float32")
    (batch,) = token_batches(cfg, 1, 4, 16, dev)
    batch = {k: v[0] for k, v in batch.items()}
    gen = np.random.default_rng(7)
    protos = torch.as_tensor(gen.standard_normal(
        (cfg.n_proto_classes, cfg.proto_dim)), dtype=torch.float32,
        device=dev)
    ends = []
    for m in (1, 4):
        state = program_state(torch, cfg, 0, dev)
        state = state._replace(global_protos=protos.clone(),
                               proto_mask=torch.ones_like(
                                   state.proto_mask))
        state, metrics = program(cfg, m)(state, batch)
        ends.append((state, {k: float(v) for k, v in metrics.items()}))
    (one, m1), (four, m4) = ends
    for key in ("loss_s", "loss_t", "grad_norm_s"):
        expect(abs(m4[key] - m1[key]) <= 1e-5 * abs(m1[key]),
               f"programs smoke: {key} {m4[key]} at 4 microbatches, "
               f"{m1[key]} at 1")
    beyond, gap = 0, 0.0
    for a, b in zip(tree_leaves(one.teacher) + tree_leaves(one.student),
                    tree_leaves(four.teacher) + tree_leaves(four.student)):
        err = (a.detach().float() - b.detach().float()).abs()
        beyond += int((err > PROGRAM_ATOL).sum())
        gap = max(gap, float(err.max()))
    print(f"programs smoke yi-6b: 4 microbatches against 1, losses "
          f"{m4['loss_s']:.6f} / {m1['loss_s']:.6f}, parameters max "
          f"|difference| {gap:.3e}, {beyond} beyond {PROGRAM_ATOL}")
    expect(beyond <= PROGRAM_EPS_ELEMENTS and gap <= PROGRAM_ATOL + 2 * LR,
           f"programs smoke: 4 microbatches and 1 differ in {beyond} "
           f"parameters (max {gap:.3e})")
    del ends, one, four

    cfg = get_config("yi-6b")
    cfg = (cfg.smoke() if full_smoke else cfg).replace(
        num_layers=PROGRAM_LAYERS)
    seq = 16 if full_smoke else TRAIN_SEQ
    cuda = dev.type == "cuda"
    runs = []
    for b, m in PROGRAM_RUNS:
        if cuda:
            torch.cuda.empty_cache()
        state = program_state(torch, cfg, 0, dev)
        batches = [{k: v[0] for k, v in x.items()} for x in
                   token_batches(cfg, PROGRAM_STEPS, b, seq, dev)]
        step = program(cfg, m)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
        stamps, losses = [time.perf_counter()], []
        for x in batches:
            state, metrics = step(state, x)
            losses.append((float(metrics["loss_s"]),
                           float(metrics["loss_t"])))
            if cuda:
                torch.cuda.synchronize(dev)
            stamps.append(time.perf_counter())
        expect(all(math.isfinite(v) for pair in losses for v in pair),
               f"programs yi-6b batch {b} x {m}: non-finite losses "
               f"{losses}")
        runs.append({"batch": b, "microbatches": m, "seq": seq,
                     "steps": PROGRAM_STEPS, "losses": losses,
                     "first_step_ms": (stamps[1] - stamps[0]) * 1e3,
                     "step_ms": (stamps[-1] - stamps[1]) * 1e3
                     / (PROGRAM_STEPS - 1),
                     "peak_bytes": torch.cuda.max_memory_allocated(dev)
                     if cuda else None})
        TIMED[f"programs/yi-6b/{b}x{m}"] = dict(
            runs[-1], layers=cfg.num_layers, smoke=full_smoke)
        del state, batches, step
    print("programs " + json.dumps({
        "arch": "yi-6b", "smoke": full_smoke, "layers": PROGRAM_LAYERS,
        "reduced": f"{PROGRAM_LAYERS} of {get_config('yi-6b').num_layers} "
                   f"layers: fp32 parameters with adamw moments of the "
                   f"full depth do not fit one card",
        "remat": True, "optimizer": cfg.optimizer, "runs": runs,
        "card": smi}), flush=True)


def run_train(torch, smi: str, device: str = "cuda",
              full: dict = TRAIN_FULL, lm_paths=tuple(LM_PATHS), *,
              full_smoke: bool = False) -> dict:
    """Phase 14b (see the module's docstring); nothing is caught.
    ``full_smoke`` runs ``full``'s configs at their smoke size (a CPU
    check of the phase).  Returns the LM paths' launch counts."""
    from repro_torch.config import get_config
    from repro_torch.configs import ASSIGNED
    from repro_torch.core.profe import resolve_device
    from repro_torch.launch import train as launch_train
    from repro_torch.models import param_count
    from repro_torch.tree import keyed_leaves, tree_leaves
    resolve_device(device)             # TF32 off: fp32 stays fp32
    with deterministic_algorithms(torch):
        for arch in ASSIGNED:
            cfg = get_config(arch).smoke().replace(dtype="float32")
            ends = []
            for remat in (True, False):
                state = launch_train.train_state(cfg, seed=0, device=device)
                before = [x.detach().clone()
                          for x in tree_leaves(state.student)]
                out = launch_train.train(cfg, state, steps=1, batch=2,
                                         seq=16, remat=remat, verbose=False)
                expect(all(math.isfinite(x) for x in
                           out["loss_s"] + out["loss_t"]),
                       f"{arch}: non-finite losses {out['loss_s']} "
                       f"{out['loss_t']}")
                moved = sum(not torch.equal(a, b.detach()) for a, b in
                            zip(before, tree_leaves(out["state"].student)))
                expect(moved > 0, f"{arch}: the student did not change")
                ends.append((out, moved))
            (on, moved), (off, _) = ends
            same = [torch.equal(a.detach(), b.detach()) for (_, a), (_, b)
                    in zip(keyed_leaves(on["state"]),
                           keyed_leaves(off["state"]))]
            expect(all(same) and on["loss_s"] == off["loss_s"]
                   and on["loss_t"] == off["loss_t"],
                   f"{arch}: remat on and off differ in "
                   f"{same.count(False)} of {len(same)} leaves")
            print(f"smoke {arch}: one ProFe step, loss_s "
                  f"{on['loss_s'][0]:.4f} loss_t {on['loss_t'][0]:.4f}, "
                  f"{moved} student leaves moved, remat on and off "
                  f"bit-identical ({len(same)} leaves)")
            del ends, on, off, state

    for arch, (layers, n_teacher, n_student) in full.items():
        if device == "cuda":
            torch.cuda.empty_cache()
        cfg = get_config(arch)
        if full_smoke:
            cfg = cfg.smoke()
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        state = launch_train.train_state(cfg, seed=0, device=device)
        nt, ns = param_count(state.teacher), param_count(state.student)
        expect((nt, ns) == (n_teacher, n_student),
               f"{arch}: teacher {nt} and student {ns} parameters, the JAX "
               f"package's {n_teacher} and {n_student}")
        out = launch_train.train(cfg, state, steps=TRAIN_STEPS,
                                 batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                 remat=True,
                                 frontend_scale=TRAIN_FRONTEND_SCALE)
        expect(all(math.isfinite(x) for x in out["loss_s"] + out["loss_t"]),
               f"{arch}: non-finite losses")
        depth = get_config(arch).num_layers
        line = {"arch": arch, "layers": cfg.num_layers,
                "reduced": (None if layers is None else
                            f"{layers} of {depth} layers: fp32 parameters "
                            f"with adamw moments of the full depth do not "
                            f"fit one card"),
                "teacher_params": nt, "student_params": ns,
                "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
                "optimizer": cfg.optimizer, "remat": True,
                "frontend_scale": TRAIN_FRONTEND_SCALE,
                "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
                "seq": TRAIN_SEQ, "loss_s": out["loss_s"],
                "loss_t": out["loss_t"],
                "first_step_ms": out["first_step_ms"],
                "step_ms": out["step_ms"],
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3
                / out["step_ms"],
                "peak_bytes": out["peak_bytes"], "device": device,
                "card": smi}
        print("train " + json.dumps(line), flush=True)
        TIMED[f"train/{arch}"] = dict(line, smoke=full_smoke)
        del out, state

    counts = {}
    for name in lm_paths:
        phase(f"lm path {name}")
        counts[name] = run_lm_path(torch, name, device)
    return counts


# the examples phase (run_examples): each ported user script's run() at
# its own defaults, on the card.  avg_sent_gb of every ProFe, FedAvg and
# FedProto run in it, computed once with the JAX package's run_federation
# on the CPU at the scripts' configurations (the JAX scripts' defaults):
# script/run -> bytes.  They depend only on shapes and the schedule
EXAMPLE_BYTES = {
    "quickstart/profe": 0.003748176,
    "quickstart/fedavg": 0.015179112,
    "dfl/profe": 0.000792304,
    "dfl/fedproto": 4.112e-05,
    "dfl/fedavg": 0.180815008,
    "sweep/full": 0.001188456,
    "sweep/ring": 0.000792304,
    "sweep/dynamic:ring,star": 0.000693266,
    "sweep/random-k2": 0.000792304,
    "ablations/paper (16-bit, decay, protos)": 0.003748176,
    "ablations/32-bit wire": 0.007495992,
    "ablations/8-bit wire": 0.001874268,
    "ablations/no decay (alpha fixed)": 0.003748176,
    "ablations/no distillation (alpha=0)": 0.003748176,
    "ablations/no prototypes (beta=0)": 0.003748176,
}
# the scripts whose run() the phase calls, in order: name -> (folder
# under the repo root, module); their kernels' launches are read around
# each run() (the spawned ranks' from their records).  The topology
# suite runs last, as a subprocess (TOPO_CMD)
EXAMPLES = {"quickstart": ("examples", "torch_quickstart"),
            "dfl": ("examples", "torch_dfl_noniid_cifar"),
            "sweep": ("examples", "torch_topology_sweep"),
            "mesh-demo": ("examples", "torch_mesh_federation_demo"),
            "ablations": ("benchmarks", "torch_ablations")}
# quickstart's batch; its ProFe run launches rows 1-4 as run_path's
# formula gives them, its FedAvg run (fp32 wire, per-leaf) none
QUICKSTART_BATCH = 64
# the CIFAR driver's and the topology sweep's batch
CIFAR_BATCH = 32
# rows 1-4: a ProFe run on the plane and the 16-bit wire launches each
PROFE_KERNELS = ("adamw_update", "proto_accum", "rowabs", "quantize_rows")
# the topology byte-gate suite (benchmarks/torch_dryrun_topo.py) as a
# subprocess: its four rows' audits, each one more subprocess of 8 ranks
TOPO_CMD = ("-m", "benchmarks.torch_dryrun_topo", "--out-dir",
            "build/dryrun", "--force")
TOPO_TIMEOUT_S = 600

# the paper phase (run_paper): each paper script's main(argv), on the card.
# (avg_sent_gb, avg_received_gb) of every run it makes, computed once
# with the JAX package's accountant on the CPU at the scripts' defaults
# (table2: 4 nodes, 2 rounds; fig2: 4 nodes, 3 rounds, any split; a full
# graph): script/dataset/algorithm -> bytes.  table2's mnist-cnn rows are
# reports/table2_comm.json's
PAPER_BYTES = {
    "table2/mnist-cnn/fedavg": (0.010119408, 0.010119408),
    "table2/mnist-cnn/fedgpd": (0.010150368, 0.010150368),
    "table2/mnist-cnn/fml": (0.004966128, 0.004966128),
    "table2/mnist-cnn/fedproto": (3.096e-05, 3.096e-05),
    "table2/mnist-cnn/profe": (0.002498784, 0.002498784),
    "table2/cifar100-resnet32/fedavg": (0.012201696, 0.012201696),
    "table2/cifar100-resnet32/fedgpd": (0.012818496, 0.012818496),
    "table2/cifar100-resnet32/fml": (0.271777632, 0.271777632),
    "table2/cifar100-resnet32/fedproto": (0.0006168, 0.0006168),
    "table2/cifar100-resnet32/profe": (0.136198656, 0.136198656),
    "fig2/mnist-cnn/fedavg": (0.015179112, 0.015179112),
    "fig2/mnist-cnn/fedgpd": (0.015225552, 0.015225552),
    "fig2/mnist-cnn/fml": (0.007449192, 0.007449192),
    "fig2/mnist-cnn/fedproto": (4.644e-05, 4.644e-05),
    "fig2/mnist-cnn/profe": (0.003748176, 0.003748176),
}
# the ppermute bytes a node of table2's --physical wire rows (mnist-cnn,
# 4 nodes, a full graph): reports/table2_comm.json's wire_bits rows
PAPER_PPERMUTE = {"16": 1278180.0, "4/16": 326628.0}


def _example(name: str):
    """The module of the script ``name`` of ``EXAMPLES``, imported from
    its directory (kept on ``sys.path``, so spawned ranks can import it
    too)."""
    import importlib
    folder, module = EXAMPLES[name]
    if folder == "benchmarks":
        path, module = ROOT, f"benchmarks.{module}"
    else:
        path = ROOT / folder
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))
    return importlib.import_module(module)


def _sum_launches(into: dict, launches: dict) -> None:
    for k, v in launches.items():
        into[k] = into.get(k, 0) + v


def _finite_f1(what: str, f1) -> None:
    expect(len(f1) > 0 and all(math.isfinite(f) for f in f1),
           f"{what}: F1 {f1} not finite")


def _held_bytes(what: str, got) -> None:
    want = EXAMPLE_BYTES[what]
    expect(got == want, f"{what}: avg_sent_gb {got!r} != the JAX "
                        f"package's {want!r}")


def run_examples(torch, smi: str) -> dict:
    """Phase 14d, the ported user scripts on the card at their own
    defaults (see :data:`EXAMPLES`), each ``run()`` with the launch
    counts set to 0 just before and read just after: every F1 finite,
    every ProFe / FedAvg / FedProto run's ``avg_sent_gb`` the JAX
    package's (``EXAMPLE_BYTES``); quickstart's launches exactly (rows
    1-4 from its nodes × steps, every other kernel 0); every ProFe
    script's rows 1-4 launched; the topology sweep's physical ``ppermute``
    bytes (its single-phase topologies) and the mesh demo's ring the
    audit's prediction, one ``mix_packed`` a rank; demo part (a)'s
    aggregate within the 16-bit step and C̄[0,0] 1.5, its bytes a rank
    the packed copy's; then ``benchmarks/torch_dryrun_topo.py`` as a
    subprocess, which must exit 0 with its ``summary.json`` on the card
    and every row passed (equal to the JAX reports).  Prints an
    ``examples {...}`` line.
    Returns each script's launches (its spawned ranks' included) under
    ``examples/<name>``."""
    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    counts, seconds, summary = {}, {}, {}

    def timed(name, **kw):
        mod = _example(name)
        reset_launch_counts()
        t0 = time.time()
        out = mod.run(**kw)
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        counts[name] = launch_counts()
        print(f"{name} took {seconds[name]:.1f} s; launches "
              f"{ {k: v for k, v in counts[name].items() if v} }",
              flush=True)
        return out

    # quickstart: ProFe then FedAvg, 3 rounds on 4 iid mnist-cnn nodes
    q = timed("quickstart")
    rounds = len(q["profe"]["f1"])
    steps = rounds * max(max(n // QUICKSTART_BATCH, 1)
                         for n in q["node_sizes"])
    want = {k: 0 for k in counts["quickstart"]}
    want.update(adamw_update=steps, proto_accum=steps, rowabs=rounds,
                quantize_rows=rounds)
    expect(counts["quickstart"] == want,
           f"quickstart launches {counts['quickstart']} != {want}")
    for algo in ("profe", "fedavg"):
        _finite_f1(f"quickstart/{algo}", q[algo]["f1"])
        _held_bytes(f"quickstart/{algo}", q[algo]["avg_sent_gb"])
    summary["quickstart"] = {a: {"f1": q[a]["f1"][-1],
                                 "avg_sent_gb": q[a]["avg_sent_gb"]}
                             for a in ("profe", "fedavg")}
    summary["quickstart"]["predicted_launches"] = {
        k: v for k, v in want.items() if v}

    # the non-iid CIFAR driver: profe, fedproto, fedavg on 3 nodes
    d = timed("dfl")
    for algo in ("profe", "fedproto", "fedavg"):
        _finite_f1(f"dfl/{algo}", d[algo]["f1"])
        _held_bytes(f"dfl/{algo}", d[algo]["avg_sent_gb"])
    summary["dfl"] = {a: {"f1": d[a]["f1"][-1],
                          "avg_sent_gb": d[a]["avg_sent_gb"]}
                      for a in ("profe", "fedproto", "fedavg")}
    summary["dfl"]["node_samples"] = [n["samples"] for n in d["nodes"]]

    # the topology sweep, with the physical bytes of each single-phase
    # topology from the audit's spawned ranks
    s = timed("sweep")
    summary["sweep"] = {}
    for entry in s["runs"]:
        topo = entry["topology"]
        _finite_f1(f"sweep/{topo}", entry["f1"])
        _held_bytes(f"sweep/{topo}", entry["avg_sent_gb"])
        row = {"f1": entry["f1"][-1], "avg_sent_gb": entry["avg_sent_gb"]}
        if entry["phases"] == 1:
            expect("physical" in entry,
                   f"sweep/{topo}: physical bytes skipped: "
                   f"{entry.get('physical_skipped')}")
            rep = entry["physical"]
            perm = rep["exchanges"]["ppermute"]
            expect("error" not in perm, f"sweep/{topo}: ppermute {perm}")
            expect(perm["collective_bytes_per_node"]
                   == rep["packed_pred_bytes_per_node"],
                   f"sweep/{topo}: ppermute moves "
                   f"{perm['collective_bytes_per_node']} B a node, the "
                   f"audit predicts {rep['packed_pred_bytes_per_node']}")
            expect(perm["launches"].get("mix_packed") == s["nodes"],
                   f"sweep/{topo}: ppermute launches {perm['launches']}")
            for ex in rep["exchanges"].values():
                _sum_launches(counts["sweep"], ex.get("launches", {}))
            row["physical"] = {
                ex: v.get("collective_bytes_per_node", v.get("error"))
                for ex, v in rep["exchanges"].items()}
            row["packed_pred_bytes_per_node"] = \
                rep["packed_pred_bytes_per_node"]
        summary["sweep"][topo] = row

    # the mesh demo: 2 ranks a node each for (a)-(c), 8 for (d)
    m = timed("mesh-demo")
    step = 2.0 / 32767                 # node 1's prototype step
    expect(m["aggregate_err_over_step"] <= 1.0,
           f"mesh demo: aggregate {m['aggregate_err_over_step']:.3f} steps "
           f"of the 16-bit wire off")
    expect(abs(m["c_bar_00"] - 1.5) <= step,
           f"mesh demo: C̄[0,0] {m['c_bar_00']!r} != 1.5")
    expect(m["profe_bytes_per_rank"] == m["profe_pred_bytes"],
           f"mesh demo: ProFe {m['profe_bytes_per_rank']} B a rank != the "
           f"packed copy {m['profe_pred_bytes']}")
    expect(m["fedavg_bytes_per_rank"] == m["fedavg_pred_bytes"],
           f"mesh demo: FedAvg {m['fedavg_bytes_per_rank']} B a rank != "
           f"{m['fedavg_pred_bytes']}")
    expect(m["launches"].get("mix_packed") == 3 * m["ranks"],
           f"mesh demo (a)-(c) launches {m['launches']}: one mix_packed a "
           f"rank a round")
    ring = m["ring8"]
    expect(ring["ppermute_bytes_per_node"]
           == ring["packed_pred_bytes_per_node"]
           and ring["full_gather_bytes_per_node"]
           == _example("mesh-demo").RING_NODES * ring["packed_copy_bytes"],
           f"mesh demo (d): {ring}")
    expect(ring["launches"].get("mix_packed")
           == _example("mesh-demo").RING_NODES,
           f"mesh demo (d) launches {ring['launches']}")
    _sum_launches(counts["mesh-demo"], m["launches"])
    _sum_launches(counts["mesh-demo"], ring["launches"])
    summary["mesh-demo"] = {k: m[k] for k in (
        "aggregate_max_err", "aggregate_err_over_step", "c_bar_00",
        "profe_bytes_per_rank", "fedavg_bytes_per_rank", "saved",
        "star_divergence", "layout")}
    summary["mesh-demo"]["ring8"] = {k: v for k, v in ring.items()
                                     if k != "launches"}

    # the ablations
    a = timed("ablations")
    for name, row in a.items():
        _finite_f1(f"ablations/{name}", row["f1_curve"])
        _held_bytes(f"ablations/{name}", row["avg_sent_gb"])
    summary["ablations"] = {n: {"f1": r["f1"],
                                "avg_sent_gb": r["avg_sent_gb"]}
                            for n, r in a.items()}
    for name in ("dfl", "sweep", "ablations"):
        for k in PROFE_KERNELS:
            expect(counts[name][k] > 0, f"{name}: {k} never launched")

    # the topology byte-gate suite as a subprocess: its summary names
    # each row's verdict, compared keys and launches
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    run = subprocess.run([sys.executable, *TOPO_CMD], env=env, cwd=ROOT,
                         capture_output=True, text=True,
                         timeout=TOPO_TIMEOUT_S)
    seconds["dryrun-topo"] = time.time() - t0
    print(run.stdout[-6000:])
    if run.returncode != 0:
        print(run.stderr[-4000:])
    expect(run.returncode == 0,
           f"torch_dryrun_topo exited {run.returncode}")
    suite = json.loads((ROOT / TOPO_CMD[3] / "summary.json").read_text())
    expect(suite["ok"] and suite["device"] == "cuda",
           f"dryrun-topo: ok {suite['ok']} on {suite['device']}")
    counts["dryrun-topo"] = {}
    summary["dryrun-topo"] = {}
    for row in suite["rows"]:
        _sum_launches(counts["dryrun-topo"], row["launches"])
        summary["dryrun-topo"][row["tag"]] = {k: g for k, g, _ in
                                              row["compared"]}
    print("examples " + json.dumps({"card": smi, "seconds": seconds,
                                    **summary}), flush=True)
    return {f"examples/{k}": v for k, v in counts.items()}


# the paper phase (run_paper): the paper scripts' main(argv), run in
# PAPER_DIR (their reports land under its reports/): call -> (module
# under benchmarks/, argv).  "run" drives fig2, table2 and table3 at
# their defaults on mnist-cnn
PAPER_DIR = "build/paper"
PAPER_CALLS = {
    "run": ("torch_run", []),
    "table3-overlap": ("torch_table3_time", ["--overlap", "--topologies",
                                             "ring"]),
    "table2-physical": ("torch_table2_comm", ["--bits", "16,4/16",
                                              "--physical"]),
    "table2-cifar100": ("torch_table2_comm", ["--datasets",
                                              "cifar100-resnet32"]),
    "table3-cifar100": ("torch_table3_time", ["--datasets",
                                              "cifar100-resnet32"]),
}
# the scripts whose run_federation the phase records, by module -> the
# short name its launches are keyed by (paper/<name>/<dataset>)
PAPER_SCRIPTS = {"torch_fig2_f1": "fig2", "torch_table2_comm": "table2",
                 "torch_table3_time": "table3"}
PAPER_PHYSICAL_NODES = 4           # table2's default nodes


def _paper_launches_want(algo: str, rounds: int, sizes, zero: dict) -> dict:
    """A paper script's run's launches on the 16-bit wire at batch
    ``PAPER_BATCH``: ProFe's rows 1-4 (a plane sweep and an Eq. 3 batch a
    step, the codec once a round), FedProto's and FedGPD's ``proto_accum``
    a step, FedAvg and FML none (per-leaf, the fp32 wire)."""
    steps = rounds * max(max(n // PAPER_BATCH, 1) for n in sizes)
    want = dict(zero)
    if algo == "profe":
        want.update(adamw_update=steps, proto_accum=steps, rowabs=rounds,
                    quantize_rows=rounds)
    elif algo in PROTO_BASELINES:
        want.update(proto_accum=steps)
    return want


def run_paper(torch, smi: str) -> dict:
    """Phase 14e, the paper's experiment scripts on the card
    (``PAPER_CALLS``): ``torch_run.py`` at its defaults (fig2's three
    splits × five algorithms, table2 and table3 on mnist-cnn), table3's
    ``--overlap`` on a ring (under deterministic cuDNN), table2's
    ``--physical`` wire at ``16`` and ``4/16``, and both tables on
    cifar100-resnet32.  Every ``run_federation`` of the scripts is
    recorded, the launch counts set to 0 just before it and read just
    after: every F1 finite; every table2 and fig2 run's bytes
    ``PAPER_BYTES``'; every run's launches as
    :func:`_paper_launches_want` says; the ``ppermute`` bytes a node
    ``PAPER_PPERMUTE``'s and the prediction, one ``mix_packed`` a rank;
    ``overlap="none"``'s F1 and final state the sequential driver's bit
    for bit.  Prints a ``paper {...}`` line.  Returns the launches under
    ``paper/<script>/<dataset>`` (the spawned ranks' summed in)."""
    import importlib
    import shutil

    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    mods = {m: importlib.import_module(f"benchmarks.{m}")
            for m in ("torch_run", *PAPER_SCRIPTS)}
    algos = mods["torch_table2_comm"].ALGOS
    zero = {k: 0 for k in launch_counts()}
    records, reports, seconds = [], {}, {}
    current = {}

    def recording(module, real):
        def run_federation(cfg, fed, train, node_data, test_d, **kw):
            reset_launch_counts()
            res = real(cfg, fed, train, node_data, test_d, **kw)
            torch.cuda.synchronize()
            records.append(dict(
                call=current["call"], script=PAPER_SCRIPTS[module],
                dataset=cfg.name, algo=fed.algorithm, rounds=fed.rounds,
                sizes=[len(n["label"]) for n in node_data],
                overlap=kw.get("overlap", "off"), f1=list(res.f1_per_round),
                sent=res.extras["avg_sent_gb"],
                received=res.extras["avg_received_gb"],
                launches=launch_counts(),
                state=res.state if current["call"] == "table3-overlap"
                else None))
            res.state = None
            return res
        return run_federation

    work = ROOT / PAPER_DIR
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    reals = {m: mods[m].run_federation for m in PAPER_SCRIPTS}
    cwd = os.getcwd()
    try:
        os.chdir(work)
        for m, real in reals.items():
            mods[m].run_federation = recording(m, real)
        for call, (module, argv) in PAPER_CALLS.items():
            current["call"] = call
            t0 = time.time()
            if call == "table3-overlap":
                with deterministic_cudnn(torch):
                    got = mods[module].main(argv)
            else:
                got = mods[module].main(argv)
            seconds[call] = time.time() - t0
            print(f"paper {call} took {seconds[call]:.1f} s", flush=True)
            # each call's report as its main returns it (torch_run's by
            # script; table3 merges into its earlier --out)
            if call == "run":
                reports.update(got)
            else:
                reports[call] = got
    finally:
        os.chdir(cwd)
        for m, real in reals.items():
            mods[m].run_federation = real

    counts = {}
    for r in records:
        what = f"{r['call']}/{r['script']}/{r['dataset']}/{r['algo']}"
        if r["overlap"] != "off":
            what += f"/overlap={r['overlap']}"
        _finite_f1(what, r["f1"])
        _sum_launches(counts.setdefault(
            f"paper/{r['script']}/{r['dataset']}", dict(zero)),
            r["launches"])
        want = _paper_launches_want(r["algo"], r["rounds"], r["sizes"], zero)
        expect(r["launches"] == want,
               f"{what}: launches {r['launches']} != {want}")
        if r["script"] in ("table2", "fig2"):
            pinned = PAPER_BYTES[f"{r['script']}/{r['dataset']}/{r['algo']}"]
            expect((r["sent"], r["received"]) == pinned,
                   f"{what}: bytes {(r['sent'], r['received'])} != the JAX "
                   f"package's {pinned}")
    for ds in ("mnist-cnn", "cifar100-resnet32"):
        for script in ("table2", "table3"):
            ran = {r["algo"] for r in records if r["dataset"] == ds
                   and r["script"] == script and r["overlap"] == "off"}
            expect(ran == set(algos), f"{script} on {ds} ran {ran}")
    n_fig2 = sum(r["script"] == "fig2" for r in records)
    expect(n_fig2 == 15, f"fig2 ran {n_fig2} runs, not 3 splits × 5 "
                         f"algorithms")
    summary = {"card": smi, "seconds": seconds, "runs": len(records)}

    summary["table2_pct_vs_fedavg"] = {
        ds: {a: rows[a]["pct_vs_fedavg"] for a in algos}
        for ds, rows in (("mnist-cnn", reports["table2"]["mnist-cnn"]),
                         ("cifar100-resnet32", reports["table2-cifar100"][
                             "cifar100-resnet32"]))}

    # the physical wire: the ppermute bytes a node and one mix a rank
    phys = reports["table2-physical"]["mnist-cnn"]["wire_bits"]
    spawned = counts.setdefault("paper/table2/mnist-cnn", dict(zero))
    summary["physical"] = {}
    for bits, want in PAPER_PPERMUTE.items():
        rep = phys[bits]
        perm = rep["exchanges"]["ppermute"]
        expect("error" not in perm, f"physical {bits}: ppermute {perm}")
        expect(perm["collective_bytes_per_node"] == want
               == rep["packed_pred_bytes_per_node"],
               f"physical {bits}: ppermute moves "
               f"{perm['collective_bytes_per_node']} B a node, the JAX "
               f"package {want}, the prediction "
               f"{rep['packed_pred_bytes_per_node']}")
        expect(perm["launches"].get("mix_packed") == PAPER_PHYSICAL_NODES,
               f"physical {bits}: ppermute launches {perm['launches']}")
        for ex in rep["exchanges"].values():
            _sum_launches(spawned, ex.get("launches", {}))
        summary["physical"][bits] = {
            ex: v.get("collective_bytes_per_node", v.get("error"))
            for ex, v in rep["exchanges"].items()}

    # overlap="none" against the sequential driver, bit for bit
    ov = {r["overlap"]: r for r in records if r["call"] == "table3-overlap"}
    expect(set(ov) == {None, "none", "rounds"},
           f"table3 --overlap ran {list(ov)}")
    expect(ov["none"]["f1"] == ov[None]["f1"]
           and states_equal(torch, ov["none"]["state"], ov[None]["state"]),
           "overlap='none' is not the sequential driver bit for bit")
    ring = reports["table3-overlap"]["mnist-cnn"]["ring"]["overlap"]
    for r in records:
        r["state"] = None
    summary["overlap_ring"] = {m: {k: ring[m].get(k) for k in (
        "median_round_s", "round_times_s", "f1_per_round",
        "round_speedup_vs_sequential", "f1_final_abs_diff")} for m in ring}

    # Table III: percentages and seconds a round
    summary["table3"] = {
        ds: {a: {k: rows[a][k] for k in ("pct_vs_fedavg", "elapsed_s",
                                         "round_times_s")} for a in algos}
        for ds, rows in (("mnist-cnn", reports["table3"]["mnist-cnn"][
            "full"]), ("cifar100-resnet32", reports["table3-cifar100"][
                "cifar100-resnet32"]["full"]))}
    summary["fig2_final_f1"] = {key: {n: row["f1_per_round"][-1]
                                      for n, row in rows.items()}
                                for key, rows in reports["fig2"].items()}
    for key, launches in counts.items():
        for k in PROFE_KERNELS:
            expect(launches[k] > 0, f"{key}: {k} never launched")
    print("paper " + json.dumps(summary), flush=True)
    return counts


# the round-step phase (run_round_step): the round-step microbenchmark's
# two commands at their defaults, each main(argv) run in ROUND_STEP_DIR
ROUND_STEP_DIR = "build/round_step"
ROUND_STEP_CALLS = {"nodes": ["--nodes", "2", "4", "8", "--phases"],
                    "wire": ["--wire"]}
ROUND_STEP_ROUNDS = 5             # the script's --rounds
ROUND_STEP_STEPS = ROUND_STEP_SAMPLES // ROUND_STEP_BATCH
ROUND_STEP_APPLY_LEAVES = 2       # the reduced student's rank-8 matrix leaves
ROUND_STEP_WIRE_NODES = 8         # --wire-nodes
ROUND_STEP_WIRE_ROUNDS = 10       # --wire's timed rounds: max(--rounds, 10)
# the JAX package's wire bytes a node (BENCH_wire_exchange.json, pods 8):
# row -> (ppermute, packed, full-gather); the adapter row's full-gather
# records its error (merge-based aggregation needs an adjacency)
ROUND_STEP_WIRE = {"16": (852120.0, 3408480.0, 3408480.0),
                   "8": (426136.0, 1704544.0, 1704544.0),
                   "4": (213144.0, 852576.0, 852576.0),
                   "4/16": (217752.0, 871008.0, 871008.0),
                   "4+adapters8": (24752.0, 99008.0, None)}


def _round_step_nodes_want(n: int, zero: dict) -> dict:
    """Launches of ``measure(n)`` and ``measure_phases(n)`` at the
    script's defaults (``ROUND_STEP_ROUNDS`` timed rounds after a warm-up,
    ``ROUND_STEP_STEPS`` batches a node a round).  ``measure``: the seed
    loop's per-leaf steps and ``core/quantization`` codec launch nothing,
    its Eq. 3 pass ``proto_accum`` a node a batch; the stacked round a
    plane sweep and an Eq. 3 batch a step, ``rowabs`` and
    ``quantize_rows`` once.  ``measure_phases``: the train pair (``max(
    rounds, 5)`` pairs and a warm-up) sweeps a step on each side, the
    fused side accumulates a step; the exact Eq. 3 pass (a warm-up, the
    timed calls and one more for the codec's input) a batch a call; the
    codec (the same count) once a call; the round pair as the stacked
    round on each side; the update pair (``max(rounds, 10)`` and a
    warm-up) one sweep on its fused side; the grad and mix pairs
    nothing; the apply pair (``max(rounds, 100)`` and a warm-up) one
    ``lowrank_apply`` a matrix leaf on each side (``adapter_apply_tree``
    launches it too)."""
    r, steps = ROUND_STEP_ROUNDS, ROUND_STEP_STEPS
    rounds = r + 1
    pairs = max(r, 5) + 1
    calls = r + 2
    want = dict(zero)
    want.update(
        adamw_update=rounds * steps + 2 * pairs * steps + 2 * pairs * steps
        + max(r, 10) + 1,
        proto_accum=rounds * steps + rounds * n * steps + pairs * steps
        + calls * steps + 2 * pairs * steps,
        rowabs=rounds + calls + 2 * pairs,
        quantize_rows=rounds + calls + 2 * pairs,
        lowrank_apply=2 * (max(r, 100) + 1) * ROUND_STEP_APPLY_LEAVES)
    return want


def _round_step_wire_want(label: str, zero: dict):
    """Launches of a ``--wire`` row: ``(codec, rank)``.  ``codec``, the
    codec pair (a warm-up and ``ROUND_STEP_WIRE_ROUNDS`` calls a side; on
    the card the per-leaf reference at a uniform width is ``rowabs`` and
    ``quantize_dequantize_rows`` on its packed tree, at ``4/16`` plain
    math; the packed codec ``rowabs`` and ``quantize_rows`` or, mixed,
    ``quantize_rows_mixed``).  ``rank``, one spawned rank's round of each
    exchange: every exchange quantizes the rank's node once; ``packed``,
    ``ppermute`` and the full-gather reference mix with one
    ``mix_packed`` (``gather`` mixes leaf by leaf in plain math); the
    adapter wire merges with one ``lowrank_apply`` a matrix leaf instead
    of mixing, and its full-gather reference is refused before any
    launch."""
    calls = ROUND_STEP_WIRE_ROUNDS + 1
    bits, _, rank = label.partition("+adapters")
    codes = "quantize_rows_mixed" if "/" in bits else "quantize_rows"
    codec = dict(zero, rowabs=calls, **{codes: calls})
    if "/" not in bits:
        codec.update(rowabs=2 * calls, quantize_dequantize_rows=calls)
    once = dict(zero, rowabs=1, **{codes: 1})
    mixed = dict(once, mix_packed=1)
    if rank:
        merged = dict(once, lowrank_apply=ADAPTER_LEAVES)
        per_rank = {"gather": merged, "packed": merged, "ppermute": merged,
                    "full-gather": dict(zero)}
    else:
        per_rank = {"gather": once, "packed": mixed, "ppermute": mixed,
                    "full-gather": mixed}
    return codec, per_rank


def _positive_ms(what: str, ms) -> None:
    expect(isinstance(ms, (int, float)) and math.isfinite(ms) and ms > 0,
           f"{what}: {ms} ms is not a finite time above 0")


def run_round_step(torch, smi: str) -> dict:
    """Phase 14f, the round-step microbenchmark on the card
    (``ROUND_STEP_CALLS``, ``benchmarks/torch_round_step.py`` ``main(argv)``
    in ``ROUND_STEP_DIR``): ``--nodes 2 4 8 --phases`` (the seed loop
    against the stacked round on the reduced mnist-cnn, the phase split
    and the four A/B pairs) and ``--wire`` (the codec pair and the three
    exchanges on 8 spawned ranks, a ring, at 16, 8, 4, ``4/16`` and
    ``4+adapters8``).  ``measure``, ``measure_phases`` and
    ``measure_codec`` are recorded, the launch counts set to 0 just before
    each call and read just after, and held to
    :func:`_round_step_nodes_want` / :func:`_round_step_wire_want` with
    every exchange's warm-up and timed rounds on every rank summed in
    (the timed rounds ``ROUND_STEP_WIRE_ROUNDS`` times the warm-up's
    launches); every row's ``ppermute``,
    ``packed`` and full-gather bytes a node ``ROUND_STEP_WIRE``'s (the JAX
    package's; ``gather`` is the port's own count, printed); every time
    finite and above 0 (``proto_fused_ms``, a clamped difference, at
    least 0).  Prints a ``round_step {...}`` line.  Returns the launches
    under ``round-step/nodes/<N>`` and ``round-step/wire``."""
    import importlib
    import shutil

    from repro_torch.kernels.build import launch_counts, reset_launch_counts

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    mod = importlib.import_module("benchmarks.torch_round_step")
    zero = {k: 0 for k in launch_counts()}
    launches = {}

    def recording(name, real):
        def call(*args, **kw):
            reset_launch_counts()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            key = (name, kw.get("bits", args[0]), kw.get("adapter_rank", 0))
            into = launches.setdefault(key, dict(zero))
            _sum_launches(into, launch_counts())
            return out
        return call

    work = ROOT / ROUND_STEP_DIR
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    reals = {f: getattr(mod, f) for f in ("measure", "measure_phases",
                                          "measure_codec")}
    reports, seconds = {}, {}
    cwd = os.getcwd()
    try:
        os.chdir(work)
        for f, real in reals.items():
            setattr(mod, f, recording(f, real))
        for call, argv in ROUND_STEP_CALLS.items():
            t0 = time.time()
            reports[call] = mod.main(argv)
            seconds[call] = time.time() - t0
            print(f"round-step {call} took {seconds[call]:.1f} s", flush=True)
    finally:
        os.chdir(cwd)
        for f, real in reals.items():
            setattr(mod, f, real)

    counts = {}
    summary = {"card": smi, "seconds": seconds, "nodes": {}, "wire": {}}
    nodes = reports["nodes"]
    expect(nodes["card"] == smi and nodes["backend"] == "cuda",
           f"round-step: the report's card {nodes['card']} / backend "
           f"{nodes['backend']}")
    for n in ROUND_STEP_NODES:
        got = dict(zero)
        for f in ("measure", "measure_phases"):
            _sum_launches(got, launches[(f, n, 0)])
        want = _round_step_nodes_want(n, zero)
        expect(got == want, f"round-step N={n}: launches {got} != {want}")
        counts[f"round-step/nodes/{n}"] = got
        row = nodes["nodes"][str(n)]
        phases = row["phases"]
        for k, v in list(row.items()) + list(phases.items()):
            if k in ("local_steps_per_round", "phases"):
                continue
            if k == "proto_fused_ms":
                expect(math.isfinite(v) and v >= 0,
                       f"round-step N={n}: {k} {v}")
            else:
                _positive_ms(f"round-step N={n} {k}", v)
        expect(row["local_steps_per_round"] == n * ROUND_STEP_STEPS,
               f"round-step N={n}: {row['local_steps_per_round']} steps")
        summary["nodes"][n] = row

    wire = reports["wire"]
    expect(wire["card"] == smi and wire["backend"] == "cuda"
           and list(wire["per_bits"]) == list(ROUND_STEP_WIRE),
           f"round-step --wire: rows {list(wire['per_bits'])}, card "
           f"{wire['card']}")
    spawned = dict(zero)
    for label, (perm, packed, full) in ROUND_STEP_WIRE.items():
        res = wire["per_bits"][label]
        rep, codec = res["exchange"], res["codec"]
        ex = rep["exchanges"]
        for what in ("ppermute", "packed", "gather"):
            expect("error" not in ex[what], f"--wire {label}: {what} "
                                            f"{ex[what]}")
            _positive_ms(f"--wire {label} {what} round", ex[what]["round_ms"])
        got = (ex["ppermute"]["collective_bytes_per_node"],
               ex["packed"]["collective_bytes_per_node"],
               rep["full_gather_bytes_per_node"])
        expect(got == (perm, packed, full),
               f"--wire {label}: ppermute / packed / full-gather bytes a "
               f"node {got} != the JAX package's {(perm, packed, full)}")
        expect(ex["ppermute"]["collective_bytes_per_node"]
               == rep["packed_pred_bytes_per_node"],
               f"--wire {label}: ppermute is not the prediction "
               f"{rep['packed_pred_bytes_per_node']}")
        for what in ("per_leaf_ms", "packed_ms"):
            _positive_ms(f"--wire {label} codec {what}", codec[what])
        bits, _, rank = label.partition("+adapters")
        codec_want, per_rank = _round_step_wire_want(label, zero)
        got = launches[("measure_codec", bits, int(rank or 0))]
        expect(got == codec_want, f"--wire {label}: the codec pair "
                                  f"launched {got} != {codec_want}")
        ranks = ROUND_STEP_WIRE_NODES
        for name, one in per_rank.items():
            warm = dict(zero, **(rep["full_gather_launches"]
                                 if name == "full-gather"
                                 else ex[name]["launches"]))
            want = {k: ranks * v for k, v in one.items()}
            expect(warm == want, f"--wire {label} {name}: the warm-up "
                                 f"round launched {warm} != {want}")
            _sum_launches(spawned, warm)
            if name == "full-gather":
                continue
            timed = dict(zero, **ex[name]["timed_launches"])
            want = {k: ROUND_STEP_WIRE_ROUNDS * v for k, v in warm.items()}
            expect(timed == want, f"--wire {label} {name}: the timed "
                                  f"rounds launched {timed} != {want}")
            _sum_launches(spawned, timed)
        summary["wire"][label] = {
            "codec": codec,
            "exchanges": {k: {"bytes": v["collective_bytes_per_node"],
                              "round_ms": v["round_ms"]}
                          for k, v in ex.items()},
            "full_gather_bytes": rep["full_gather_bytes_per_node"],
            "ppermute_vs_full_gather": res.get("ppermute_vs_full_gather"),
            "ppermute_vs_int16": res.get("ppermute_vs_int16")}
    got = dict(zero)
    for key, launched in launches.items():
        if key[0] == "measure_codec":
            _sum_launches(got, launched)
    _sum_launches(got, spawned)
    counts["round-step/wire"] = got
    for key, launched in counts.items():
        need = PROFE_KERNELS + ("lowrank_apply",) if "nodes" in key else (
            "rowabs", "quantize_rows", "quantize_rows_mixed",
            "quantize_dequantize_rows", "mix_packed", "lowrank_apply")
        for k in need:
            expect(launched[k] > 0, f"{key}: {k} never launched")
    print("round_step " + json.dumps(summary), flush=True)
    return counts


# the regression gate held on phase 14f's reports (hold_regression_gate):
# the port's committed baselines at the repo's root, and each committed
# invariant their numbers break, as (row, verdict word): at N = 2 the
# committed grad plane pass took 2.082 ms against the repack's 2.079
GATE_BASELINES = {"nodes": "BENCH_torch_round_step.json",
                  "wire": "BENCH_torch_wire_exchange.json"}
GATE_KNOWN_FAILING = (("N=2", "PLANE-GRAD-NOT-CHEAPER"),)


def hold_regression_gate(committed: dict, fresh: dict, smi: str) -> dict:
    """``benchmarks/torch_check_regression.py``'s gates over the committed
    baselines (``committed``, by ``GATE_BASELINES`` key) and phase 14f's
    two reports as the fresh side (``fresh``): nothing is re-measured.
    Held: both baselines are the port's, from a card; every committed row
    gets its verdicts (a round ratio a node count, the invariants a
    phases row, a codec ratio a wire row); the committed invariants fail
    exactly as ``GATE_KNOWN_FAILING`` says; every wire byte verdict is
    ``OK`` (the fresh bytes the committed ones, no row missing) and the
    committed rows' ``ppermute``, ``packed`` and full-gather bytes
    ``ROUND_STEP_WIRE``'s.  Not held: the ratios of the fresh times to
    the committed ones and the fresh rows' invariants, since the two
    sides' times come from different hosts (a host 15–30 % slower in
    every phase has been seen); they are printed on a line
    ``regression_gate {...}``, which this returns."""
    import importlib

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    G = importlib.import_module("benchmarks.torch_check_regression")
    base, wire_base = committed["nodes"], committed["wire"]
    for key, rep in committed.items():
        expect(G.is_port_report(rep) and rep["backend"].startswith("cuda")
               and str(rep["card"]).startswith("NVIDIA"),
               f"gate: {GATE_BASELINES[key]} is not the port's report from "
               f"a card (backend {rep.get('backend')}, card "
               f"{rep.get('card')})")
    nodes = sorted(base["nodes"], key=int)
    expect(nodes == [str(n) for n in ROUND_STEP_NODES],
           f"gate: committed node counts {nodes}")

    fresh_nodes = fresh["nodes"]["nodes"]
    rounds = G.check_round(base, {n: fresh_nodes[n]["jitted_ms"]
                                  for n in nodes}, G.THRESHOLD)
    expect([v.row for v in rounds] == [f"N={n}" for n in nodes]
           and all(math.isfinite(v.ratio) for v in rounds),
           f"gate: round verdicts {[v.line for v in rounds]}")

    invariants = G.check_invariants(base)
    n_big = G.phase_node(base)
    # a row: the round pair and the A/B pairs; the largest N the marginal
    want = [f"N={n}" for n in nodes] * (1 + len(G.PAIRS)) + [f"N={n_big}"]
    expect(n_big == nodes[-1] and sorted(v.row for v in invariants)
           == sorted(want), f"gate: invariant verdicts "
                            f"{[v.line for v in invariants]}")
    failing = tuple((v.row, v.word) for v in invariants if v.failed)
    expect(failing == GATE_KNOWN_FAILING,
           f"gate: the committed invariants failing {failing} != "
           f"GATE_KNOWN_FAILING {GATE_KNOWN_FAILING}")
    proto = G.check_proto(base, fresh_nodes[n_big]["phases"], G.THRESHOLD)

    expect(list(wire_base["per_bits"]) == list(ROUND_STEP_WIRE)
           and list(wire_base["per_pods"]) == [str(ROUND_STEP_WIRE_NODES)],
           f"gate: committed wire rows {list(wire_base['per_bits'])}, pods "
           f"{list(wire_base.get('per_pods', {}))}")
    for label, want_bytes in ROUND_STEP_WIRE.items():
        rep = wire_base["per_bits"][label]["exchange"]
        got = (rep["exchanges"]["ppermute"]["collective_bytes_per_node"],
               rep["exchanges"]["packed"]["collective_bytes_per_node"],
               rep["full_gather_bytes_per_node"])
        expect(got == want_bytes, f"gate: committed {label} bytes {got} != "
                                  f"the JAX package's {want_bytes}")
    wire = G.check_wire(wire_base, fresh["wire"], G.THRESHOLD)
    codec = [v for v in wire if v.ratio is not None]
    expect([v.row for v in codec]
           == [f"[pods={ROUND_STEP_WIRE_NODES} bits={b}]"
               for b in ROUND_STEP_WIRE]
           and all(math.isfinite(v.ratio) for v in codec),
           f"gate: codec verdicts {[v.line for v in codec]}")
    drift = [v.line for v in wire if v.ratio is None and v.word != "OK"]
    expect(not drift, f"gate: wire bytes {drift}")

    summary = {
        "card": smi, "baseline_card": {k: committed[k]["card"]
                                       for k in GATE_BASELINES},
        "threshold": G.THRESHOLD,
        "round": {v.row: v.ratio for v in rounds},
        "proto": {proto.row: proto.ratio},
        "codec": {v.row: v.ratio for v in codec},
        "byte_verdicts": sum(v.ratio is None for v in wire),
        "over_threshold": [v.line for v in rounds + [proto] + codec
                           if v.failed],
        "committed_invariants_failing": failing,
        "fresh_invariants_failing": [(v.row, v.word) for v in
                                     G.check_invariants(fresh["nodes"])
                                     if v.failed]}
    print("regression_gate " + json.dumps(summary), flush=True)
    return summary


def run_regression_gate(smi: str) -> dict:
    """Phase 14f's gate (:func:`hold_regression_gate`): the committed
    baselines against the reports ``run_round_step`` wrote in
    ``ROUND_STEP_DIR``."""
    def load(path):
        with open(path) as f:
            return json.load(f)

    return hold_regression_gate(
        {k: load(ROOT / name) for k, name in GATE_BASELINES.items()},
        {k: load(ROOT / ROUND_STEP_DIR / name)
         for k, name in GATE_BASELINES.items()}, smi)


# the roofline phase (run_roofline): the compile-report sweep, then the
# op count of each timed run
ROOFLINE_SLACK = 1.05     # a term may exceed the measured time by 5 %
ROOFLINE_DIR = "build/roofline"   # each combo's whole report
ROOFLINE_COUNTED = ("serve/yi-6b", "train/mamba2-130m", "train/whisper-small",
                    "train/yi-6b", "programs/yi-6b/4x1", "programs/yi-6b/16x4")


def timed_program(torch, name: str, line: dict):
    """The program of one timed run (``TIMED[name]``) at its own shapes on
    ``meta``: ``(fn, args)``.  ``serve/<arch>``: one decode step of
    ``launch/serve`` (a cache of prompt + tokens slots); ``train/<arch>``:
    ``core/profe.make_profe_step`` on a one-node stack, the teacher on;
    ``programs/yi-6b/<b>x<m>``: ``make_profe_train_fn`` with m
    microbatches."""
    from repro_torch.config import FederationConfig, TrainConfig, get_config
    from repro_torch.config.base import ShapeConfig
    from repro_torch.core.profe import (NodeState, make_profe_step,
                                        stack_states)
    from repro_torch.launch import programs as PR
    from repro_torch.models import derive_student, init_cache, init_params
    from repro_torch.optim import make_optimizer
    kind, arch = name.split("/")[:2]
    cfg = get_config(arch)
    if line.get("smoke"):
        cfg = cfg.smoke()
    if line.get("layers") and line["layers"] != cfg.num_layers:
        cfg = cfg.replace(num_layers=line["layers"])
    gen = torch.Generator().manual_seed(0)
    if kind == "serve":
        b, total = line["batch"], line["prompt"] + line["tokens"]
        params = init_params(cfg, gen, device="meta")
        cache = init_cache(cfg, b, total, torch.bfloat16, "meta")
        token = torch.empty((b, 1), dtype=torch.int64, device="meta")
        fn = PR.make_serve_fn(cfg, ShapeConfig("serve", total, b, "decode"))
        return torch.no_grad()(fn), (params, token, total - 2, cache)
    student_cfg = derive_student(cfg)
    if kind == "train":
        b, seq = line["batch"], line["seq"]
        opt = make_optimizer(cfg.optimizer, LR)
        teacher = init_params(cfg, gen, device="meta")
        student = init_params(student_cfg, gen, device="meta")
        zeros = lambda *shape, dt=torch.float32: torch.zeros(
            shape, dtype=dt, device="meta")
        state = stack_states([NodeState(
            student=student, teacher=teacher, opt_s=opt.init(student),
            opt_t=opt.init(teacher),
            global_protos=zeros(cfg.n_proto_classes, student_cfg.proto_dim),
            proto_mask=zeros(cfg.n_proto_classes),
            round_idx=zeros(dt=torch.int32))])
        batch = {k: v[None] for k, v in PR.batch_struct(
            cfg, ShapeConfig("train", seq, b, "train")).items()}
        step = make_profe_step(cfg, student_cfg, FederationConfig(), opt,
                               opt, remat=True)
        return (lambda st, bt: step(st, bt, True)), (state, batch)
    b, m = line["batch"], line["microbatches"]
    train = TrainConfig(learning_rate=LR, optimizer=cfg.optimizer,
                        microbatches=m)
    step, _ = PR.make_profe_train_fn(cfg, student_cfg, FederationConfig(),
                                     train)
    state = PR.node_state_struct(cfg, student_cfg, train,
                                 cfg.n_proto_classes)
    return step, (state, PR.batch_struct(
        cfg, ShapeConfig("train", line["seq"], b, "train")))


def count_against_card(torch, name: str, line: dict) -> dict:
    """One timed run's op count (``launch/op_analysis.count_ops`` of
    :func:`timed_program`) beside its measured ms: the compute and memory
    terms at the card's published peaks, the share (the larger term over
    the measured time) and ``peak_bytes_estimate`` beside the run's
    ``torch.cuda.max_memory_allocated()``."""
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.launch.roofline import (HBM_BW, compute_seconds,
                                             memory_analysis)
    fn, args = timed_program(torch, name, line)
    t0 = time.time()
    c = count_ops(fn, *args)
    ms = line["step_ms"]
    terms = {"compute_ms": compute_seconds(c.flops) * 1e3,
             "memory_ms": c.bytes / HBM_BW * 1e3}
    mem = memory_analysis(c)
    return {"run": name, "flops_by_dtype": dict(c.flops),
            "bytes": c.bytes, **terms, "measured_ms": ms,
            "share": max(terms.values()) / ms,
            "peak_bytes_estimate": mem["peak_bytes_estimate"],
            "max_memory_allocated": line.get("peak_bytes",
                                             line.get("peak_bytes_serve")),
            "count_s": time.time() - t0}


def run_roofline(torch, smi: str, counted=ROOFLINE_COUNTED, timed=None,
                 out_dir: str = ROOFLINE_DIR, **sweep) -> dict:
    """Phase 14g (see the module's docstring): the sweep is
    ``benchmarks/torch_dryrun_all.run`` over its archs, shapes and
    meshes (``sweep`` may narrow them), a line a combo, each report in
    ``out_dir``; it fails after every combo has run if any is not
    ``ok``.  Returns the ``roofline {...}`` line."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import torch_dryrun_all
    timed = TIMED if timed is None else timed
    t0 = time.time()
    res = torch_dryrun_all.run(out_dir=out_dir, force=True, **sweep)
    failed = [f"{r['arch']} {r['shape']} {r['mesh']}: {r.get('error')}"
              for r in res["reports"] if r.get("status") != "ok"]
    combos = [r for r in res["reports"] if r.get("status") == "ok"]
    sweep_s = time.time() - t0
    expect(not failed, f"roofline: {len(failed)} combos failed: {failed}")
    checks = []
    for name in counted:
        expect(name in timed, f"roofline: no timed run {name}")
        row = count_against_card(torch, name, timed[name])
        checks.append(row)
        print(f"roofline count {name}: FLOPs {row['flops_by_dtype']}, "
              f"bytes {row['bytes']:.6g}, compute {row['compute_ms']:.4f} "
              f"ms, memory {row['memory_ms']:.4f} ms, measured "
              f"{row['measured_ms']:.4f} ms, share {row['share']:.4f}; peak "
              f"estimate {row['peak_bytes_estimate']} B, max allocated "
              f"{row['max_memory_allocated']} B", flush=True)
        for term in ("compute_ms", "memory_ms"):
            expect(row[term] <= ROOFLINE_SLACK * row["measured_ms"],
                   f"roofline {name}: {term} {row[term]} above the measured "
                   f"{row['measured_ms']} ms: the count is wrong")
    line = {"combos": len(combos), "sweep_s": sweep_s, "counted": checks,
            "reports": out_dir, "seconds": time.time() - t0,
            "card": smi}
    print("roofline " + json.dumps(line, default=str), flush=True)
    return dict(line, combos=[{k: r[k] for k in ("arch", "shape", "mesh")}
                              for r in combos])


# the layouts phase (run_layouts): the compile report of a node of
# LAYOUT_CARDS cards at layout "auto", then one rank of yi-6b on the card
LAYOUT_CARDS = 8
LAYOUT_SHAPES = ("train_4k", "decode_32k")
# training combos left out of the phase's sweep to keep it near 120 s on
# the card's host (each is in `torch_dryrun_all.py --cards-per-node 8`,
# 43–386 s a combo there on 6 processes; yi-6b's, kept, 41–73 s)
LAYOUT_CUT = tuple((a, "train_4k") for a in (
    "mamba2-130m", "whisper-small", "recurrentgemma-9b", "qwen3-14b",
    "starcoder2-15b", "llama4-scout-17b-a16e", "llama-3.2-vision-90b",
    "qwen1.5-110b", "grok-1-314b"))
LAYOUT_JOBS = 6     # the card's host has 8 cores; phase 14g's sweep too
LAYOUT_DIR = "build/layouts"
LAYOUT_RUNS = (("fsdp", (8, 1)), ("tp", (2, 4)))
LAYOUT_BATCH, LAYOUT_STEPS = 4, 3


def _materialize(torch, tree, device, vocab: int, gen):
    """Each DTensor of ``tree`` (shards on ``meta``) with its rank's shard
    drawn on ``device``: floats from N(0, 0.02²), the token and label ids
    below ``vocab``, every other integer 0."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map

    def one(path, t):
        local = t._local_tensor
        if local.is_floating_point():
            x = torch.empty(local.shape, dtype=local.dtype, device=device)
            x.normal_(0.0, 0.02, generator=gen)
        elif path in ("tokens", "labels"):
            x = torch.randint(0, vocab, local.shape, dtype=local.dtype,
                              device=device, generator=gen)
        else:
            x = torch.zeros(local.shape, dtype=local.dtype, device=device)
        return DTensor.from_local(x, t.device_mesh, t.placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    if isinstance(tree, dict):
        return {k: (one(k, v) if isinstance(v, torch.Tensor) else
                    _materialize(torch, v, device, vocab, gen))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_materialize(torch, v, device, vocab, gen)
                            for v in tree))
    return tree_map(lambda t: one("", t) if isinstance(t, torch.Tensor)
                    else t, tree)


def layout_rank_on_card(torch, name: str, node, device: str = "cuda",
                        cfg=None, seq: int = TRAIN_SEQ) -> dict:
    """One rank of yi-6b (full width, ``PROGRAM_LAYERS`` layers; ``cfg``
    in its place on the CPU) under layout ``name`` on a ``node`` (data,
    model) mesh of ``LAYOUT_CARDS`` cards over the fake process group:
    ``make_profe_train_fn`` at ``LAYOUT_BATCH`` × ``seq``, one
    microbatch.  The same step is counted on ``meta``
    (``launch/op_analysis``), then run on ``device`` from drawn shards:
    the rank's compute runs and its collectives hallucinate (no bytes
    move).  Returns the count's terms at the card's peaks beside the
    measured ms a step (``LAYOUT_STEPS`` after one warm-up) and the
    count's ``peak_bytes_estimate`` beside ``max_memory_allocated``."""
    from repro_torch.config import FederationConfig, TrainConfig, get_config
    from repro_torch.config.base import ShapeConfig
    from repro_torch.launch import programs as PR
    from repro_torch.launch.dryrun import NodeLayout
    from repro_torch.launch.mesh import fake_group, make_node_mesh
    from repro_torch.launch.op_analysis import count_ops
    from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW,
                                             compute_seconds,
                                             memory_analysis)
    from repro_torch.models import derive_student
    if cfg is None:
        cfg = get_config("yi-6b").replace(num_layers=PROGRAM_LAYERS)
    st = derive_student(cfg)
    lay = NodeLayout(name, LAYOUT_CARDS, *node)
    train = TrainConfig(learning_rate=LR, optimizer=cfg.optimizer,
                        remat=True, microbatches=1)
    step, _ = PR.make_profe_train_fn(cfg, st, FederationConfig(), train)
    cuda = torch.device(device).type == "cuda"
    with fake_group(LAYOUT_CARDS):
        mesh = make_node_mesh(LAYOUT_CARDS, *node, device=device)
        state = lay.place_state(PR.node_state_struct(
            cfg, st, train, cfg.n_proto_classes), cfg, st, train.optimizer,
            mesh)
        batch = lay.place_batch(PR.batch_struct(cfg, ShapeConfig(
            "train", seq, LAYOUT_BATCH, "train")), "train", mesh)
        t0 = time.time()
        with lay.active(mesh):
            c = count_ops(step, state, batch, arg_parts={
                "teacher": (state.teacher, state.opt_t),
                "student": (state.student, state.opt_s)})
        count_s = time.time() - t0
        gen = torch.Generator(device=device).manual_seed(0)
        state = _materialize(torch, state, device, cfg.vocab_size, gen)
        batch = _materialize(torch, batch, device, cfg.vocab_size, gen)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        stamps = [time.perf_counter()]
        with lay.active(mesh):
            for _ in range(LAYOUT_STEPS + 1):
                state, _metrics = step(state, batch)
                if cuda:
                    torch.cuda.synchronize()
                stamps.append(time.perf_counter())
        peak = torch.cuda.max_memory_allocated() if cuda else None
        del state, batch
    ms = (stamps[-1] - stamps[1]) * 1e3 / LAYOUT_STEPS
    terms = {"compute_ms": compute_seconds(c.flops) * 1e3,
             "memory_ms": c.bytes / HBM_BW * 1e3,
             "collective_ms": c.coll_total / NVLINK_BW * 1e3}
    return {"layout": name, "node_mesh": list(node), "layers":
            cfg.num_layers, "batch": LAYOUT_BATCH, "seq": seq,
            "flops_by_dtype": dict(c.flops), "bytes": c.bytes,
            "collective_by_kind": dict(c.coll), **terms,
            "first_step_ms": (stamps[1] - stamps[0]) * 1e3,
            "measured_ms": ms,
            "share": max(terms["compute_ms"], terms["memory_ms"]) / ms,
            "peak_bytes_estimate":
                memory_analysis(c)["peak_bytes_estimate"],
            "max_memory_allocated": peak, "count_s": count_s}


def run_layouts(torch, smi: str, device: str = "cuda", archs=None,
                shapes=LAYOUT_SHAPES, cut=LAYOUT_CUT, jobs: int = LAYOUT_JOBS,
                out_dir: str = LAYOUT_DIR, runs=LAYOUT_RUNS,
                run_cfg=None, run_seq: int = TRAIN_SEQ) -> dict:
    """Phase 14h (see the module's docstring): the sweep is
    ``benchmarks/torch_dryrun_all.run`` over ``archs`` × ``shapes`` on a
    node of ``LAYOUT_CARDS`` cards at layout ``auto`` but the ``cut``
    pairs, on ``jobs`` processes, a line a combo, each report in
    ``out_dir``; it fails after every combo has run if any is not ``ok``.
    Then :func:`layout_rank_on_card` for each of ``runs``.  Returns the
    ``layouts {...}`` line."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import torch_dryrun_all
    t0 = time.time()
    res = torch_dryrun_all.run(
        archs if archs is not None else torch_dryrun_all.ARCHS, shapes,
        ["pod1"], out_dir, force=True, cards=LAYOUT_CARDS, jobs=jobs,
        skip=cut)
    failed = [f"{r['arch']} {r['shape']}: {r.get('error')}"
              for r in res["reports"] if r.get("status") != "ok"]
    expect(not failed, f"layouts: {len(failed)} combos failed: {failed}")
    sweep_s = time.time() - t0
    combos = [{"arch": r["arch"], "shape": r["shape"],
               "layout": r["layout"], "dominant": r["dominant"],
               "terms_s": r["terms_s"],
               "collective_by_kind": r["collective_by_kind"],
               "peak_bytes_estimate":
                   r["memory_analysis"]["peak_bytes_estimate"],
               "fits_80gb_hbm": r["memory_analysis"]["fits_80gb_hbm"],
               "held_out_check": r["trip_count_fit"]["held_out_check"],
               "wall_s": r["wall_s"]} for r in res["reports"]]
    for c in combos:
        expect(c["held_out_check"] == "exact",
               f"layouts {c['arch']} {c['shape']}: the fit is not exact")
    ran = []
    for name, node in runs:
        row = layout_rank_on_card(torch, name, node, device, cfg=run_cfg,
                                  seq=run_seq)
        ran.append(row)
        print(f"layouts rank {name} {node[0]}x{node[1]}: measured "
              f"{row['measured_ms']:.4f} ms a step (first "
              f"{row['first_step_ms']:.1f} ms), count compute "
              f"{row['compute_ms']:.4f} ms, memory {row['memory_ms']:.4f} "
              f"ms, collective {row['collective_ms']:.4f} ms "
              f"(hallucinated), share {row['share']:.4f}; peak estimate "
              f"{row['peak_bytes_estimate']} B, max allocated "
              f"{row['max_memory_allocated']} B", flush=True)
        expect(row["share"] <= ROOFLINE_SLACK,
               f"layouts rank {name}: the count's larger term is above "
               f"the measured {row['measured_ms']} ms: the count is wrong")
    line = {"cards": LAYOUT_CARDS, "combos": combos,
            "cut": [list(c) for c in cut], "sweep_s": sweep_s,
            "jobs": jobs, "runs": ran, "reports": out_dir,
            "seconds": time.time() - t0, "card": smi}
    print("layouts " + json.dumps(line, default=str), flush=True)
    return line


def main() -> int:
    t_start = time.time()
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
    one = torch.zeros(1, device="cuda")
    launch_ms = timer(lambda: torch.add(one, 1.0, out=one))
    print(f"one launch (a 1-element add): {launch_ms:.4f} ms")
    rows = check_kernels(torch, timer, derive_student(get_config("mnist-cnn")))
    rows += check_plane_sweeps(torch, timer,
                               derive_student(get_config("cifar10-resnet18")))
    rows += check_lowrank(torch, timer,
                          derive_student(get_config("mnist-cnn")))
    rows += check_mix_packed(torch, timer,
                             derive_student(get_config("mnist-cnn")))
    rows += check_codec_kernels(torch, timer)
    rows += check_proto_kd_kernels(torch, timer)
    check_loop_shapes(torch, timer, derive_student(get_config("mnist-cnn")),
                      rows)
    check_lm_shapes(torch, timer, rows)
    check_new_shapes(torch, timer, rows)
    check_row_block_shapes(torch, timer, rows)
    check_example_shapes(torch, timer, rows)
    check_paper_shapes(torch, timer, rows)
    check_round_step_shapes(torch, timer, rows)
    for row in rows:
        if row["name"] in ("mix_packed", "adafactor_apply", "rowabs",
                           "rowabs_sum", "proto_dist", "quantize_rows_mixed",
                           "kd_loss"):
            row["launch_ms"] = launch_ms

    inputs = {model: path_inputs(model) for model in IMAGE_SHAPE}
    split_inputs = {}
    counts = {}
    t_noniid = 0.0
    for name, (model, optimizer, wire, rounds, _) in PATHS.items():
        algo = PATH_FED.get(name, {}).get("algorithm", "profe")
        split = PATH_SPLIT.get(name, "iid")
        phase(f"{'main' if name == '16' else 'path'} {name}: {algo} "
              f"{model}, {N_NODES} nodes ({split}), {rounds} round(s), "
              f"{optimizer}, {wire} wire")
        t0 = time.time()
        if split == "iid":
            path_in = inputs[model]
        else:
            if (model, split) not in split_inputs:
                split_inputs[model, split] = path_inputs(model, split)
            path_in = split_inputs[model, split]
        counts[name] = run_path(torch, path_in, name)
        took = time.time() - t0
        if split != "iid":
            t_noniid += took
        print(f"{name} path took {took:.1f} s")

    phase("loop: run_federation_loop against run_federation, one round of "
          "the main path's configuration")
    t0 = time.time()
    check_loop_against_stacked(torch, inputs["mnist-cnn"])
    t_noniid += time.time() - t0
    print(f"loop phase took {time.time() - t0:.1f} s; the non-iid paths and "
          f"the loop phase {t_noniid:.1f} s all told")

    phase("checkpoint: the 4/16+ef state after round 1 saved, restored and "
          "resumed")
    t0 = time.time()
    run_checkpoint(torch, inputs["mnist-cnn"])
    print(f"checkpoint phase took {time.time() - t0:.1f} s")

    phase("stochastic: the main path's payload through the stochastic "
          "codec, card against CPU")
    run_stochastic(torch)

    # gloo binds to the loopback: the ranks share this machine, which has
    # no network
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    phase(f"mesh: {MESH_NODES} ranks on one card over gloo, "
          f"{', '.join(MESH_PATHS)}; then as {MESH_ROW_NODES} nodes of "
          f"{MESH_RANKS_PER_NODE} ranks, {', '.join(MESH_ROW_PATHS)}")
    t0 = time.time()
    counts.update(run_mesh(torch))
    print(f"mesh paths took {time.time() - t0:.1f} s")

    phase(f"mesh parity: one rank holding {MESH_NODES} nodes against the "
          f"stacked engine")
    check_mesh_parity(torch)
    check_mesh_adapter_parity(torch)

    phase(f"{MESH_LM}: {MESH_LM_RANKS} ranks on one card over gloo, one "
          f"full-width node each, ring ppermute, 16-bit")
    t0 = time.time()
    counts[MESH_LM] = run_mesh_lm(torch, smi)
    print(f"{MESH_LM} phase took {time.time() - t0:.1f} s")

    phase(f"{MESH_LM_4X2}: {MESH_LM_RANKS} full-width nodes of "
          f"{MESH_RANKS_PER_NODE} ranks on one card over gloo, the "
          f"row-sharded permute, 16-bit")
    t0 = time.time()
    counts[MESH_LM_4X2] = run_mesh_lm(torch, smi,
                                      ranks_per_node=MESH_RANKS_PER_NODE)
    print(f"{MESH_LM_4X2} phase took {time.time() - t0:.1f} s")

    phase("audit: python -m repro_torch.launch.dryrun " + " ".join(
        AUDIT_CMD[2:]))
    t0 = time.time()
    run_audit(smi)
    print(f"audit phase took {time.time() - t0:.1f} s")

    phase("codec: the per-leaf and per-tensor wire codec at full width")
    t0 = time.time()
    counts["codec"] = run_codec(torch)
    print(f"codec phase took {time.time() - t0:.1f} s")

    phase("proto-infer: Claim 4 (Eq. 3 + Eq. 5) at full width, the ProFe "
          "KD term")
    t0 = time.time()
    counts["proto-infer"] = run_proto_infer(torch, inputs)
    print(f"proto-infer phase took {time.time() - t0:.1f} s")

    phase("serve: the ten assigned LM configs at smoke size, then yi-6b, "
          "mamba2-130m, whisper-small and llama4-scout (2 layers) at full "
          "width through repro_torch.launch.serve")
    t0 = time.time()
    run_serve(torch, smi)
    print(f"serve phase took {time.time() - t0:.1f} s")

    phase("train: one ProFe step of each assigned LM config at smoke size "
          "(remat on and off), then mamba2-130m, whisper-small and yi-6b "
          "(2 layers) at full width through repro_torch.launch.train, then "
          "the LM federations")
    t0 = time.time()
    counts.update(run_train(torch, smi))
    print(f"train phase took {time.time() - t0:.1f} s")

    phase("programs: the microbatched train program, yi-6b smoke (4 "
          "microbatches against 1), then yi-6b (2 layers) at full width")
    t0 = time.time()
    run_programs(torch, smi)
    print(f"programs phase took {time.time() - t0:.1f} s")

    phase("examples: the ported user scripts at their own defaults "
          "(quickstart, the non-iid CIFAR driver, the topology sweep, the "
          "mesh demo, the ablations), then the topology byte-gate suite")
    t0 = time.time()
    counts.update(run_examples(torch, smi))
    print(f"examples phase took {time.time() - t0:.1f} s")

    phase("paper: the paper's experiment scripts (torch_run.py at its "
          "defaults, table3 --overlap on a ring, table2 --physical, both "
          "tables on cifar100-resnet32)")
    t0 = time.time()
    counts.update(run_paper(torch, smi))
    print(f"paper phase took {time.time() - t0:.1f} s")

    phase("round-step: the round-step microbenchmark at its defaults "
          "(--nodes 2 4 8 --phases, then --wire)")
    t0 = time.time()
    counts.update(run_round_step(torch, smi))
    t1 = time.time()
    run_regression_gate(smi)
    print(f"regression gate took {time.time() - t1:.2f} s")
    print(f"round-step phase took {time.time() - t0:.1f} s")

    phase("roofline: the compile report of 10 archs x 4 shapes x pod1 / "
          "pod2 (launch/dryrun.py --shape), then the op count of the runs "
          "phases 14a-14c timed against their measured ms")
    t0 = time.time()
    run_roofline(torch, smi, jobs=LAYOUT_JOBS)
    print(f"roofline phase took {time.time() - t0:.1f} s")

    phase(f"layouts: the compile report of a node of {LAYOUT_CARDS} cards "
          f"(10 archs x {', '.join(LAYOUT_SHAPES)}, layout auto, "
          f"launch/dryrun.py --cards-per-node {LAYOUT_CARDS}), then one "
          f"rank of yi-6b ({PROGRAM_LAYERS} layers) under fsdp and tp run "
          f"on the card over the fake process group")
    t0 = time.time()
    run_layouts(torch, smi)
    print(f"layouts phase took {time.time() - t0:.1f} s")

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
        # the non-iid paths' launches of the kernel, where it ran there
        row["noniid_launches"] = {p: counts[p][row["name"]]
                                  for p in PATH_SPLIT
                                  if counts[p].get(row["name"])}
        # the LM federations' launches of the kernel, where it ran there
        row["lm_launches"] = {p: counts[p][row["name"]] for p in LM_PATHS
                              if counts[p].get(row["name"])}
        # the launches of the kernel on the tree-payload error-feedback,
        # adapter, FedAvg and LM mesh paths (the mesh paths' summed over
        # their ranks), where it ran there
        row["new_path_launches"] = {p: counts[p][row["name"]]
                                    for p in NEW_PATHS
                                    if counts[p].get(row["name"])}
        # the examples phase's launches of the kernel (spawned ranks'
        # summed in), where it ran there
        row["examples_launches"] = {p: counts[p][row["name"]]
                                    for p in counts
                                    if p.startswith("examples/")
                                    and counts[p].get(row["name"])}
        # the paper phase's launches of the kernel by script and dataset
        # (spawned ranks summed in), where it ran there
        row["paper_launches"] = {p: counts[p][row["name"]] for p in counts
                                 if p.startswith("paper/")
                                 and counts[p].get(row["name"])}
        # the round-step phase's launches of the kernel by node count and
        # in --wire (the spawned ranks' warm-up and timed rounds summed in)
        row["round_step_launches"] = {p: counts[p][row["name"]]
                                      for p in counts
                                      if p.startswith("round-step/")
                                      and counts[p].get(row["name"])}
    print(f"chip_smoke took {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
