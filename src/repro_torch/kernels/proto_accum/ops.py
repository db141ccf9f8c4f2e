"""The Eq. 3 prototype accumulation op both the round engine's exact
pass and the tests route through: the CUDA kernel for tensors on the
card (no ``[N, B, C]`` one-hot), the one-hot einsum on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.proto_accum.proto_accum import proto_accum_cuda
from repro_torch.kernels.proto_accum.ref import proto_accum_ref


def proto_accumulate_nodes(f1, labels, n_classes: int):
    """Stacked-node batch: f1 ``[N, B, P]`` + labels ``[N, B]`` ->
    (sums ``[N, C, P]``, counts ``[N, C]``)."""
    if f1.is_cuda:
        return proto_accum_cuda(f1.to(torch.float32).contiguous(),
                                labels.to(torch.int32).contiguous(),
                                n_classes)
    return proto_accum_ref(f1, labels, n_classes)

