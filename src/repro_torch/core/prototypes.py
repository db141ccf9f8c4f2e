"""Prototype learning (paper Sec. III-B): Eq. 4 over all nodes and the
Eq. 6 prototype loss.  Eq. 3 runs in ``kernels/proto_accum``; Eq. 4 per
neighbourhood in ``core/round_ops.py``."""
from __future__ import annotations

from typing import Tuple

import torch


def aggregate_prototypes(protos, counts) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Eq. 4 over every node (the fully-connected protocol):
    ``protos [M, C, P]``, ``counts [M, C]`` -> ``(global [C, P],
    mask [C])``, the instance-count-weighted mean of each class's
    prototypes over the nodes that saw it.  As in ``repro``, the
    paper's extra ``1/|N_j|`` prefactor (FedProto's) is dropped: the
    weights already sum to one."""
    n_j = torch.sum(counts, dim=0)                                  # [C]
    w = counts / torch.clamp_min(n_j, 1.0)[None, :]                 # [M, C]
    glob = torch.einsum("mc,mcp->cp", w, protos.float())
    mask = (n_j > 0).float()
    return glob, mask


def proto_mse_loss(f1, global_protos, labels, proto_mask) -> torch.Tensor:
    """Eq. 6: MSE(f_1(x), C̄(true class)), masked to classes with a
    global prototype."""
    target = global_protos[labels]                                  # [B, P]
    valid = proto_mask[labels]                                      # [B]
    d = f1.float() - target
    per_ex = torch.mean(torch.square(d), dim=-1) * valid
    return torch.sum(per_ex) / torch.clamp_min(torch.sum(valid), 1.0)
