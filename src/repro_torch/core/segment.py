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
that ``_sed_from_uniform`` takes.

Per-row draws (the distributed step): the JAX package derives one key per
batch row from its GLOBAL batch position (``per_row_keys``), so a shard of
the batch samples what the single-device step samples for the same rows.
A ``torch.Generator`` has no keys to fold, so the port gets the same
property another way: every shard draws the WHOLE global batch's noise
from the step's generator (all shards hold generators in the same state)
and keeps its own rows by ``batch_pos``.  Each row then gets exactly the
draw the single-device step gives it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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


class RowKeys(NamedTuple):
    """The per-row draw source of a shard: the step's generator, the rows'
    positions in the global batch, and the global batch's row count."""
    generator: torch.Generator
    batch_pos: torch.Tensor      # (B_local,) int64, on the CPU
    n_global: int


def per_row_keys(generator: torch.Generator, batch_pos: torch.Tensor,
                 n_global: int) -> RowKeys:
    """The counterpart of ``src/repro/core/segment.py::per_row_keys``:
    rows keyed by their global position ``batch_pos`` (just ``arange(B)``
    on one device) in a global batch of ``n_global`` rows."""
    return RowKeys(generator, torch.as_tensor(batch_pos).long().cpu(),
                   int(n_global))


def _rows_of_global(keys: RowKeys, draw) -> torch.Tensor:
    """Draw the global (n_global, J) noise with ``draw`` on the generator's
    device and keep the shard's rows."""
    return draw(keys.n_global)[keys.batch_pos.to(keys.generator.device)]


def sample_segments_rowwise(row_keys: RowKeys, seg_valid: torch.Tensor,
                            num_sampled: int) -> torch.Tensor:
    """``sample_segments`` for the shard's rows of the global batch: the
    Gumbel noise of the global batch, the shard's rows of it."""
    J = seg_valid.shape[-1]
    gen = row_keys.generator

    def draw(n):
        e = torch.empty((n, J), device=gen.device)
        return -torch.log(e.exponential_(generator=gen))

    gumbel = _rows_of_global(row_keys, draw)
    scores = torch.where(seg_valid > 0, gumbel.to(seg_valid.device),
                         torch.tensor(float("-inf"), device=seg_valid.device))
    return torch.topk(scores, num_sampled, dim=-1).indices


def sed_weights_rowwise(row_keys: RowKeys, seg_valid, fresh_mask,
                        keep_prob: float, num_sampled: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sed_weights`` for the shard's rows of the global batch."""
    J = seg_valid.shape[-1]
    gen = row_keys.generator
    u = _rows_of_global(row_keys, lambda n: torch.rand(
        (n, J), generator=gen, device=gen.device))
    return _sed_from_uniform(u.to(seg_valid.device), seg_valid, fresh_mask,
                             keep_prob, num_sampled)


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
