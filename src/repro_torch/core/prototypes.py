"""Prototype learning (paper Sec. III-B, following FedProto with CE loss).

* Eq. 3 — local prototype: class mean of the representations f_1(x)
  (one batch here; streamed through ``kernels/proto_accum`` by
  ``core/profe.compute_local_prototypes``).
* Eq. 4 — global prototype: instance-count-weighted mean over the nodes
  that know the class (per neighbourhood in ``core/round_ops.py``).
* Eq. 5 — nearest-prototype inference through ``kernels/proto_dist``.
* Eq. 6 — prototype MSE loss against the true class's global prototype.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.proto_dist.ops import nearest_prototype
from repro_torch.kernels.proto_dist.ref import proto_dist_expand

# Eq. 5: the label of the nearest global prototype (L2) among the classes
# with a prototype, through the proto_dist kernel on the card
nearest_prototype_predict = nearest_prototype
# ||x - c||^2 through the expansion x² - 2xc + c², in plain differentiable
# ops (FedGPD's loss differentiates it; the kernel has no backward)
pairwise_sq_dists = proto_dist_expand


def local_prototypes(f1, labels, n_classes: int) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Eq. 3. f1 ``[N, P]``, labels ``[N]`` int -> (protos ``[C, P]``,
    counts ``[C]``), through the one-hot.  Classes absent locally get a
    zero prototype and count 0."""
    classes = torch.arange(n_classes, device=labels.device)
    onehot = (labels[:, None] == classes).float()                   # [N, C]
    counts = torch.sum(onehot, dim=0)                               # [C]
    sums = torch.einsum("nc,np->cp", onehot, f1.float())
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


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


def aggregate_prototypes_strict(protos, counts) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """The literal Eq. 4, with the ``1/|N_j|`` prefactor: the weighted
    mean divided again by the number of nodes that know each class."""
    n_j = torch.sum(counts, dim=0)
    nodes_knowing = torch.sum((counts > 0).float(), dim=0)
    w = counts / torch.clamp_min(n_j, 1.0)[None, :]
    glob = torch.einsum("mc,mcp->cp", w, protos.float())
    glob = glob / torch.clamp_min(nodes_knowing, 1.0)[:, None]
    return glob, (n_j > 0).float()


def proto_mse_loss(f1, global_protos, labels, proto_mask) -> torch.Tensor:
    """Eq. 6: MSE(f_1(x), C̄(true class)), masked to classes with a
    global prototype."""
    target = global_protos[labels]                                  # [B, P]
    valid = proto_mask[labels]                                      # [B]
    d = f1.float() - target
    per_ex = torch.mean(torch.square(d), dim=-1) * valid
    return torch.sum(per_ex) / torch.clamp_min(torch.sum(valid), 1.0)
