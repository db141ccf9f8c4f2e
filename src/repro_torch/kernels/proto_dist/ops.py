"""Eq. 5 prototype distances and the nearest-prototype prediction: the
CUDA kernel for tensors on the card, its plain version for tensors on
the CPU.  No padding: the kernel masks ragged N and C itself."""
from __future__ import annotations

import torch

from repro_torch.kernels.proto_dist.proto_dist import DTYPES, proto_dist_cuda
from repro_torch.kernels.proto_dist.ref import proto_dist_expand


def proto_dists(x, protos):
    """x ``[N, P]``, protos ``[C, P]`` -> d2 ``[N, C]`` fp32.  Inputs of
    another type than fp32 or bf16, or of two types, go to the kernel as
    fp32."""
    if x.is_cuda:
        if x.dtype != protos.dtype or x.dtype not in DTYPES:
            x, protos = x.float(), protos.float()
        return proto_dist_cuda(x.contiguous(), protos.contiguous())
    return proto_dist_expand(x, protos)


def nearest_prototype(x, protos, proto_mask):
    """Eq. 5: the index of the nearest prototype among the classes with
    ``proto_mask > 0``.  Ties go to the first index; a row with every
    class masked gives 0, as ``jnp.argmin`` does."""
    d2 = proto_dists(x, protos)
    d2 = torch.where(proto_mask[None, :] > 0, d2, torch.inf)
    return torch.argmin(d2, dim=-1)
