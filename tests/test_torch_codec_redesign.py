"""The Hopper redesign of the whole-tensor codec (``fused_quantize`` and
``fused_quantize_dequantize``: one cooperative launch, x staged in shared
memory), held on the CPU where it can be: its launch plan and the
wrappers' limits.  That the CUDA kernel is bit-identical to its plain
version is held on the card only (``chip_smoke.py`` phase 3: the teacher
leaf, mnist-cnn's leaves, a misaligned view, a tensor beyond what the
grid stages, an all-zero one, a negative absmax); the plain versions
are held against the JAX package's Pallas kernel in interpret mode at
widths 4, 8 and 16 by ``tests/test_torch_codec.py``.

* ``fused_plan`` for n in {1, 3, 4, 5, 16, 144, 4608, 200704, 2359296,
  2359297, 12582912}, element offsets 0-3 and 114 and 132 SMs (the PCIe
  and SXM H100): every element staged or streamed by exactly one block,
  the staged part on 16-byte addresses, shared memory within a block's
  232,448 bytes and an SM's share, the grid co-resident, one block for
  the tiny leaves.
* The wrappers raise on CPU, empty and non-fp32 tensors.
"""
import pytest
import torch

from repro_torch.kernels.quantize import quantize as FQ
from repro_torch.kernels.quantize.quantize import (
    fused_plan, fused_quantize_cuda, fused_quantize_dequantize_cuda,
    fused_spans)

torch.set_num_threads(2)

SIZES = (1, 3, 4, 5, 16, 144, 4608, 200704, 2359296, 2359297, 12582912)
TINY = 4608          # mnist-cnn's student leaves up to conv2's 3·3·16·32


# -- (a) the launch plan ------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sms", [114, 132])
def test_fused_plan_covers_fits_and_is_resident(sms, n):
    bps = FQ.BLOCKS_PER_SM
    for align in range(4):
        p = fused_plan(n, align, sms)
        what = (n, align, sms, p)
        assert p.span % 4 == 0 and p.stage % 4 == 0, what
        assert 0 < p.smem == 4 * p.stage <= FQ.SMEM_MAX, what
        assert bps * (p.smem + FQ.SMEM_STATIC + FQ.SMEM_RESERVED) \
            <= FQ.SMEM_SM, what
        assert 1 <= p.grid <= sms * bps, what
        assert p.stage <= FQ.FUSED_CHUNK * FQ.FUSED_MAX_CHUNKS, what
        # the spans tile [0, n) in order, none empty; each splits into a
        # streamed head, a staged middle, a streamed rest
        edge = 0
        staged = 0
        for lo, s_lo, s_hi, hi in fused_spans(p):
            assert lo == edge and lo < hi, what
            assert lo <= s_lo <= s_hi <= hi, what
            assert s_hi - s_lo <= p.stage, what
            assert s_lo - lo <= 3, what        # only the unaligned head
            if s_hi > s_lo or s_hi < hi:       # staged bounds aligned
                assert (s_lo + align) % 4 == 0, what
                assert (s_hi + align) % 4 == 0, what
            staged += s_hi - s_lo
            edge = hi
        assert edge == n, what
        assert p.staged == staged, what
        if n <= TINY:
            assert p.grid == 1, what
        # everything 16-byte aligned is staged while the grid holds it
        if p.stage == p.span:
            assert n - p.staged <= 6, what


def test_fused_plan_at_the_teacher_leaf_and_beyond():
    """The ResNet18 teacher's ``[3, 3, 512, 512]`` leaf (9.44 MB) is
    staged whole; 48 MB is not, and the rest streams."""
    n = 3 * 3 * 512 * 512
    p = fused_plan(n, 0, 132)
    assert p.grid == 132 * FQ.BLOCKS_PER_SM and p.staged == n
    p = fused_plan(12582912, 0, 132)
    assert p.grid == 264 and p.stage < p.span < 2 * p.stage
    assert p.staged == 264 * p.stage
    with pytest.raises(ValueError, match="empty"):
        fused_plan(0, 0, 132)
    for bad in (dict(align=4), dict(align=-1), dict(sms=0)):
        with pytest.raises(ValueError, match="fused_plan"):
            fused_plan(**dict(dict(n=16, align=0, sms=132), **bad))


# -- (c) the wrappers' limits -------------------------------------------------

@pytest.mark.parametrize("fn", [fused_quantize_cuda,
                                fused_quantize_dequantize_cuda],
                         ids=["fused_quantize", "fused_quantize_dequantize"])
def test_wrappers_raise_on_cpu_empty_and_non_fp32(fn):
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros((3, 3, 16, 32)))
    with pytest.raises(ValueError, match="empty tensor"):
        fn(torch.zeros((0, 5)))
    for dtype in (torch.float64, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="float32"):
            fn(torch.zeros((8,), dtype=dtype))
