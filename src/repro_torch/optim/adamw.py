"""AdamW + schedules + gradient clipping, as plain functions on tensors.

Counterpart of ``src/repro/optim/adamw.py``, ported literally: the same
eps placement (``m̂ / (√v̂ + eps)``), f32 moments, and a global-norm clip
at 1.0 by default in ``make_optimizer``.  ``torch.optim.Adam`` clips
nothing and places eps differently, so it is not used.

Parameters, gradients and moments are lists of tensors in one order (a
module's ``parameters()``).  Where the JAX package returns new arrays, the
port updates the parameters and the moments in place, under
``torch.no_grad()``, and returns them.  The step count is a host int.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.0) -> Callable:
    def lr(step):
        step = np.float32(step)
        warm = base_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + math.cos(math.pi * t)))
        return float(np.float32(warm if step < warmup else cos))
    return lr


def constant_schedule(base_lr: float) -> Callable:
    return lambda step: float(np.float32(base_lr))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """(grads scaled so their global norm is at most max_norm, the norm)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], gnorm


def adamw_init(params: List[torch.Tensor], state_dtype=torch.float32):
    return {
        "step": 0,
        "mu": [torch.zeros(p.shape, dtype=state_dtype, device=p.device)
               for p in params],
        "nu": [torch.zeros(p.shape, dtype=state_dtype, device=p.device)
               for p in params],
    }


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 state, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, max_grad_norm: float = 0.0):
    """One step, in place.  Returns (params, new_state, metrics)."""
    gnorm = torch.zeros((), dtype=torch.float32)
    if max_grad_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state["step"] + 1
    sf = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** sf)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** sf)
    for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
        g32 = g.float()
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, {"step": step, "mu": state["mu"], "nu": state["nu"]}, \
        {"grad_norm": gnorm}


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def make_optimizer(name: str = "adamw", *, lr=1e-3,
                   schedule: Optional[Callable] = None, b1=0.9, b2=0.999,
                   eps=1e-8, weight_decay=0.0,
                   max_grad_norm: float = 1.0) -> Optimizer:
    sched = schedule or constant_schedule(lr)
    if name not in ("adam", "adamw"):
        raise ValueError(name)
    wd = weight_decay if name == "adamw" else 0.0

    def update(params, grads, state):
        return adamw_update(params, grads, state,
                            lr=sched(state["step"]), b1=b1, b2=b2, eps=eps,
                            weight_decay=wd, max_grad_norm=max_grad_norm)

    return Optimizer(init=adamw_init, update=update)
