"""Prototype learning (paper Sec. III-B): the Eq. 6 prototype loss.
Eq. 3 runs in ``kernels/proto_accum``; Eq. 4 per neighbourhood in
``core/round_ops.py``."""
from __future__ import annotations

import torch


def proto_mse_loss(f1, global_protos, labels, proto_mask) -> torch.Tensor:
    """Eq. 6: MSE(f_1(x), C̄(true class)), masked to classes with a
    global prototype."""
    target = global_protos[labels]                                  # [B, P]
    valid = proto_mask[labels]                                      # [B]
    d = f1.float() - target
    per_ex = torch.mean(torch.square(d), dim=-1) * valid
    return torch.sum(per_ex) / torch.clamp_min(torch.sum(valid), 1.0)
