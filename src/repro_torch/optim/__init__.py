"""Optimizers of the port (AdamW, schedules, clipping): plain functions on
lists of tensors, ported from ``repro.optim``."""
from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    make_optimizer,
)

__all__ = [
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_schedule",
    "make_optimizer",
]
