"""Plain PyTorch versions of the Eq. 5 prototype distances.  Inputs are
cast to fp32 first, as the TPU kernel does, so bf16 inputs are taken."""
from __future__ import annotations

import torch


def proto_dist_ref(x, protos) -> torch.Tensor:
    """Direct pairwise ``||x - p||^2``, ``[N, P] x [C, P] -> [N, C]``:
    the oracle ``repro``'s tests hold the kernel to."""
    diff = x.float()[:, None, :] - protos.float()[None, :, :]
    return torch.sum(torch.square(diff), dim=-1)


def proto_dist_expand(x, protos) -> torch.Tensor:
    """``max(||x||^2 - 2 x·p + ||p||^2, 0)``: the expansion the Pallas
    body and ``core/prototypes.pairwise_sq_dists`` compute, the kernel's
    plain version."""
    x = x.float()
    protos = protos.float()
    x2 = torch.sum(torch.square(x), dim=-1, keepdim=True)           # [N, 1]
    p2 = torch.sum(torch.square(protos), dim=-1)[None, :]           # [1, C]
    xc = x @ protos.T                                               # [N, C]
    return torch.clamp_min(x2 - 2.0 * xc + p2, 0.0)
