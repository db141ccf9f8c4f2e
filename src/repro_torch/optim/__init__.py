"""Optimizers over parameter trees (the teacher) and over the flat
parameter plane (the student's fused clip+adamw sweep)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    make_optimizer,
)
from repro_torch.optim.plane import (
    Plane,
    PlaneMeta,
    as_tree,
    make_plane_optimizer,
    plane_from_tree,
    plane_global_norm,
)

__all__ = [
    "Optimizer", "adamw", "clip_by_global_norm", "make_optimizer",
    "Plane", "PlaneMeta", "as_tree", "make_plane_optimizer",
    "plane_from_tree", "plane_global_norm",
]
