"""The Hopper redesigns of ``lowrank_apply`` and ``proto_accum``, held on
the CPU where they can be: their launch plans, the batch-order plain
version of ``proto_accum`` and the wrappers' limits.  That the CUDA
kernels are bit-identical to their plain versions is held on the card
(``chip_smoke.py`` phase 3 runs every design and ring depth the plan
takes).

* ``lowrank_plan`` over receivers and senders N, S in {1, 3, 20, 64,
  300}, lead axes ``()`` and ``(3, 3)``, d in {16, 70, 1568}, k in
  {10, 32, 128} and ranks 1, 8, 128 and the variant's largest: shared
  memory within a block's 232,448 bytes, a ``cp.async`` ring of two to
  four senders, every output covered by exactly one block, the grid
  within its limits, and the design it takes when.
* ``proto_accum_batch_order`` (what the CUDA kernel is held to bit for
  bit on the card) against a numpy fp32 scalar replay, bit for bit; its
  counts equal to JAX's interpret-mode Pallas kernel's and its sums
  within ``rtol=1e-6`` of them at the main path's batch of 32 post-ReLU
  features (the Pallas kernel sums in its own order; non-negative terms
  keep that gap relative); labels outside ``[0, C)`` included.
* The wrappers' limits (the ranks, ``MAX_CLASSES``, the grid) raise on
  CPU tensors, before any device is needed.
"""
import math

import numpy as np
import pytest
import torch

from repro.kernels.proto_accum.ops import \
    proto_accumulate_nodes as jax_proto_nodes
from repro_torch.kernels.lowrank_apply import lowrank_apply as LA
from repro_torch.kernels.lowrank_apply.lowrank_apply import (
    MAX_RANK, lowrank_apply_cuda, lowrank_plan, max_rank)
from repro_torch.kernels.proto_accum import proto_accum as PA
from repro_torch.kernels.proto_accum.proto_accum import (MAX_CLASSES,
                                                         proto_accum_cuda,
                                                         proto_accum_smem)
from repro_torch.kernels.proto_accum.ref import (proto_accum_batch_order,
                                                 proto_accum_ref)

torch.set_num_threads(2)

SIZES = (1, 3, 20, 64, 300)
GRID_YZ = 65535


def _once(spans, size):
    """Each index of ``range(size)`` lies in exactly one span."""
    hits = np.zeros(size, np.int64)
    for lo, hi in spans:
        hits[lo:hi] += 1
    return bool((hits == 1).all())


# -- (a) the launch plan ------------------------------------------------------

@pytest.mark.parametrize("r", [1, 8, 128, "top"])
@pytest.mark.parametrize("lead", [(), (3, 3)], ids=["matrix", "conv"])
@pytest.mark.parametrize("per_recv", [False, True], ids=["shared",
                                                         "per_recv"])
def test_lowrank_plan_fits_covers_and_picks(per_recv, lead, r):
    r = max_rank(per_recv) if r == "top" else r
    lead_n = math.prod(lead)
    for n in SIZES:
        for s in SIZES:
            for d in (16, 70, 1568):
                for k in (10, 32, 128):
                    p = lowrank_plan(n, s, lead_n, d, k, r, per_recv)
                    what = (n, s, lead, d, k, r, per_recv, p)
                    assert 0 < p.smem <= LA.SMEM_MAX, what
                    assert 2 <= p.stages <= LA.MAX_STAGES, what
                    assert 0 < p.threads <= 1024, what
                    tiles_d, tiles_k = -(-d // p.tile_d), -(-k // p.tile_k)
                    assert p.grid[0] == tiles_d * tiles_k, what
                    assert p.grid[0] < 2 ** 31 and p.grid[1] == lead_n
                    assert p.grid[2] <= GRID_YZ, what
                    # block x -> (x // tiles_k, x % tiles_k), as the kernels
                    assert _once([(x // tiles_k * p.tile_d,
                                   min(d, (x // tiles_k + 1) * p.tile_d))
                                  for x in range(p.grid[0])
                                  if x % tiles_k == 0], d), what
                    assert _once([((x % tiles_k) * p.tile_k,
                                   min(k, (x % tiles_k + 1) * p.tile_k))
                                  for x in range(tiles_k)], k), what
                    bank, ring = 4 * s * 32 * 16, 4 * r * (32 + LA.PAD + 16)
                    if p.design == "bank":
                        # one block sweeps every receiver; four columns
                        # a thread
                        assert not per_recv and p.grid[2] == 1
                        assert (p.group, p.tile_d, p.tile_k) == (n, 32, 16)
                        assert p.threads * 4 == p.tile_d * p.tile_k
                    else:
                        assert p.design == "groups", what
                        assert _once([(z * p.group,
                                       min(n, (z + 1) * p.group))
                                      for z in range(p.grid[2])], n), what
                        # eight rows of one column a thread
                        assert p.threads * 8 == p.tile_d * p.tile_k
                        ring = 4 * r * (p.tile_d + LA.PAD + (
                            p.group if per_recv else 1) * p.tile_k)
                    # the deepest ring that fits
                    assert p.smem == (bank if p.design == "bank" else 0) \
                        + p.stages * ring, what
                    assert (p.stages == LA.MAX_STAGES
                            or p.smem + ring > LA.SMEM_MAX), what
                    # the bank whenever A is shared, the rows are 16-byte
                    # aligned, the bank and a ring of two fit and its
                    # blocks fill the card
                    bank_ok = (k % 4 == 0 and bank + 2 * 4 * r * 52
                               <= LA.SMEM_MAX
                               and lead_n * -(-d // 32) * -(-k // 16)
                               >= LA.SMS)
                    assert (p.design == "bank") == (not per_recv
                                                    and bank_ok), what
                    if p.design == "bank":
                        assert lowrank_plan(n, s, lead_n, d, k, r, per_recv,
                                            aligned=False).design == "groups"


def test_lowrank_plan_at_the_path_shapes():
    """fc1 takes the bank at 32x16 (392 blocks) and the groups design per
    receiver, both with a ring of four senders at the wire's rank 8;
    conv2 and fc2 give the bank too few blocks; 300 senders overflow it;
    at rank 128 the bank keeps its ring of four and the groups design per
    receiver shortens it to two."""
    fc1 = lowrank_plan(20, 20, 1, 1568, 128, 8, False)
    assert (fc1.design, fc1.tile_d, fc1.tile_k, fc1.grid, fc1.stages) == \
        ("bank", 32, 16, (392, 1, 1), 4)
    per = lowrank_plan(20, 20, 1, 1568, 128, 8, True)
    assert (per.design, per.grid, per.stages) == ("groups", (100, 1, 5), 4)
    for args in ((20, 20, 9, 16, 32), (20, 20, 1, 128, 10)):
        assert lowrank_plan(*args, 8, False).design == "groups"
    far = lowrank_plan(20, 300, 1, 64, 32, 8, False)
    assert far.design == "groups" and far.grid == (1, 1, 5)
    assert 4 * 300 * 32 * 16 > LA.SMEM_MAX
    # the ranks chip_smoke.py holds on the card at fc1
    for r, per_recv, design, stages in ((128, False, "bank", 4),
                                        (128, True, "groups", 2),
                                        (96, True, "groups", 3),
                                        (256, False, "bank", 3)):
        p = lowrank_plan(20, 20, 1, 1568, 128, r, per_recv)
        assert (p.design, p.stages) == (design, stages), (r, per_recv, p)


# -- (b) the batch-order proto_accum plain version ---------------------------

def _proto_case(seed, n=3, batch=150, p=20, c=6, relu=False):
    rng = np.random.default_rng(seed)
    f1 = (rng.standard_normal((n, batch, p)) *
          rng.uniform(0.1, 10.0, (n, batch, 1))).astype(np.float32)
    if relu:                          # Eq. 3's features are post-ReLU
        f1 = np.maximum(f1, 0.0)
    labels = rng.integers(-2, c + 2, (n, batch)).astype(np.int32)
    labels[0, :4] = [c, c + 7, -1, -5]             # match no class
    return f1, labels, c


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_order_plain_version_is_a_scalar_replay(seed):
    f1, labels, c = _proto_case(seed)
    sums, counts = proto_accum_batch_order(torch.from_numpy(f1),
                                           torch.from_numpy(labels), c)
    f32 = np.float32
    want = np.zeros((f1.shape[0], c, f1.shape[2]), np.float32)
    want_n = np.zeros((f1.shape[0], c), np.float32)
    for i in range(f1.shape[0]):
        for bi in range(f1.shape[1]):
            cls = labels[i, bi]
            if 0 <= cls < c:
                for col in range(f1.shape[2]):
                    want[i, cls, col] = f32(want[i, cls, col]
                                            + f1[i, bi, col])
                want_n[i, cls] = f32(want_n[i, cls] + f32(1.0))
    assert np.array_equal(sums.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(counts.numpy(), want_n)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_order_plain_version_against_jax_and_the_einsum(seed):
    """At the main path's batch of 32 post-ReLU features: sums of
    non-negative terms, so ``rtol`` bounds the summation-order gap."""
    f1, labels, c = _proto_case(seed, batch=32, relu=True)
    sums, counts = proto_accum_batch_order(torch.from_numpy(f1),
                                           torch.from_numpy(labels), c)
    js, jc = jax_proto_nodes(f1, labels, c, use_kernels=True)  # interpret
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-6,
                               atol=0)
    es, ec = proto_accum_ref(torch.from_numpy(f1), torch.from_numpy(labels),
                             c)
    assert torch.equal(ec, counts)
    torch.testing.assert_close(sums, es, rtol=1e-6, atol=0)


# -- (c) the wrappers' limits -------------------------------------------------

def test_lowrank_limits_raise_without_a_card():
    """The ranks reach past 128 in both variants (the wire's factors up
    to fc1's 128 columns); past the groups design's ring of two they
    raise."""
    x = torch.zeros((2, 8, 8))
    assert 128 < MAX_RANK == max_rank(True) < max_rank(False)
    for r in (0, max_rank(False) + 1):
        with pytest.raises(ValueError, match="rank must be in"):
            lowrank_apply_cuda(x, torch.ones((2, 1)), torch.zeros((1, 8, r)),
                               torch.zeros((1, r, 8)))
    for per_recv in (False, True):
        for r in (0, max_rank(per_recv) + 1):
            with pytest.raises(ValueError, match="rank must be in"):
                lowrank_plan(2, 1, 1, 8, 8, r, per_recv)
        # the largest rank's ring of two fits a block; one more does not
        top = max_rank(per_recv)
        p = lowrank_plan(20, 20, 1, 64, 32, top, per_recv)
        assert p.design == "groups" and p.stages == 2
        assert p.smem <= LA.SMEM_MAX < p.smem // top * (top + 1)
    with pytest.raises(ValueError, match="exceed the grid"):
        lowrank_apply_cuda(torch.zeros((65536, 2, 2)),
                           torch.ones((65536, 1)), torch.zeros((1, 2, 1)),
                           torch.zeros((1, 1, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        lowrank_apply_cuda(x, torch.ones((2, 1)),
                           torch.zeros((1, 8, MAX_RANK)),
                           torch.zeros((1, MAX_RANK, 8)))


def test_proto_accum_limits_raise_without_a_card():
    f1 = torch.zeros((1, 4, 8))
    labels = torch.zeros((1, 4), dtype=torch.int32)
    for c in (0, MAX_CLASSES + 1):
        with pytest.raises(ValueError, match="n_classes must be in"):
            proto_accum_cuda(f1, labels, c)
    with pytest.raises(ValueError, match="CUDA"):
        proto_accum_cuda(f1, labels, MAX_CLASSES)
    # MAX_CLASSES is the most whose tile fits beside two staged chunks
    assert proto_accum_smem(10 ** 6, MAX_CLASSES) <= PA.SMEM_MAX
    assert proto_accum_smem(10 ** 6, MAX_CLASSES + 1) > PA.SMEM_MAX
    assert proto_accum_smem(32, 10) == 4 * (32 * 33 + 10 * 33)
