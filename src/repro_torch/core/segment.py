"""Segment sampling and Stale Embedding Dropout (paper §3.1, §3.4).

Counterpart of ``src/repro/core/segment.py`` (``sample_segments``,
``sampled_mask``, ``sed_weights``, ``_sed_from_uniform``, ``aggregate``).
All functions are mask-aware: graphs have up to ``J_max`` segments with a
validity mask.  ``J^(i)`` in the paper is ``num_valid`` here.

SED weights (Eq. 1), with keep probability p and S backprop segments:
    η = p + (1-p)·J/S   for sampled (fresh) segments
    η = 0               for stale segments dropped  (prob 1-p)
    η = 1               for stale segments kept     (prob p)

Randomness comes from an explicit ``torch.Generator``.  It gives other
numbers than ``jax.random`` from the same seed, so the parity tests hand
both packages the same draws: the sampled indices, and the uniforms ``u``
that ``_sed_from_uniform`` takes.  The per-row keys of the distributed
step (``per_row_keys`` and the ``*_rowwise`` draws) land with the
distributed slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


def sample_segments(generator: torch.Generator, seg_valid: torch.Tensor,
                    num_sampled: int) -> torch.Tensor:
    """Sample S distinct segment indices per graph (Gumbel top-k over valid).

    seg_valid: (B, J) 0/1.  Returns idx: (B, S) int64 on seg_valid's device,
    drawn on the generator's device.  Invalid slots are never chosen as
    long as the graph has >= S valid segments.
    """
    e = torch.empty(seg_valid.shape, device=generator.device)
    gumbel = -torch.log(e.exponential_(generator=generator))   # -log Exp(1)
    scores = torch.where(seg_valid > 0, gumbel.to(seg_valid.device),
                         torch.tensor(float("-inf"), device=seg_valid.device))
    return torch.topk(scores, num_sampled, dim=-1).indices


def sampled_mask(idx: torch.Tensor, J: int) -> torch.Tensor:
    """(B, S) indices -> (B, J) float32 0/1 mask of sampled segments."""
    one_hot = torch.nn.functional.one_hot(idx.long(), J)
    return torch.sum(one_hot, dim=1).float()


def sed_weights(generator: torch.Generator, seg_valid, fresh_mask,
                keep_prob: float, num_sampled: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1 weights.  Returns (eta (B, J), drop_mask (B, J)).

    seg_valid:  (B, J) 1 where the segment exists.
    fresh_mask: (B, J) 1 where the segment was sampled for backprop.
    drop_mask:  1 where a *stale* segment is dropped by SED.
    """
    u = torch.rand(seg_valid.shape, generator=generator,
                   device=generator.device).to(seg_valid.device)
    return _sed_from_uniform(u, seg_valid, fresh_mask, keep_prob, num_sampled)


def _sed_from_uniform(u, seg_valid, fresh_mask, keep_prob: float,
                      num_sampled: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1 weights from precomputed uniform draws u (B, J)."""
    seg_valid = seg_valid.float()
    fresh_mask = fresh_mask.float()
    J_i = torch.sum(seg_valid, dim=-1, keepdim=True)            # (B, 1)
    S = float(num_sampled)
    drop = (u > keep_prob).float()
    stale = seg_valid * (1.0 - fresh_mask)
    eta_fresh = keep_prob + (1.0 - keep_prob) * J_i / S
    eta = fresh_mask * eta_fresh + stale * (1.0 - drop)
    return eta * seg_valid, drop * stale


def aggregate(h_segments, weights, seg_valid, mode: str = "mean"):
    """⊕ with weights.  h_segments: (B, J, d); weights/seg_valid: (B, J).

    mean: Σ η_j h_j / J^(i)  (the paper's mean-pooling ⊕, η-weighted)
    sum:  Σ η_j h_j          (TpuGraphs: per-segment predictions summed)
    """
    w = (weights * seg_valid.to(weights.dtype))[..., None]
    s = torch.sum(h_segments * w.to(h_segments.dtype), dim=1)
    if mode == "sum":
        return s
    J_i = torch.sum(seg_valid.float(), dim=-1, keepdim=True)
    return s / torch.clamp(J_i, min=1.0).to(s.dtype)
