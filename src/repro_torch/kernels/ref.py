"""Plain-torch versions of the port's kernels: the CPU path of each wrapper
and the yardstick the kernels are held against on the card.

Counterpart of ``src/repro/kernels/ref.py``.  ``swa_attention_ref`` lands
with the sequence slice.
"""
from __future__ import annotations

import torch


def segment_spmm_ref(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     w: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Weighted neighbor scatter-add:  out[v] = Σ_{e: dst_e = v} w_e · h[src_e].

    h: (m, d); src/dst: (e,) int32 or int64; w: (e,) float — padding edges
    carry w=0.  Summed in f32, returned in h's dtype.
    """
    return segment_spmm_batched_ref(h[None], src[None], dst[None], w[None],
                                    num_nodes)[0]


def segment_spmm_batched_ref(h: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, w: torch.Tensor,
                             num_nodes: int = None) -> torch.Tensor:
    """Batched: out[n, v] = Σ_{e: dst[n,e]=v} w[n,e] · h[n, src[n,e]].

    h: (N, m, d); src/dst: (N, e) int32 or int64; w: (N, e) float.
    Gather, multiply, ``index_add_`` over the flattened (N·m) node axis, in
    f32; the result is cast to h's dtype.
    """
    N, m, d = h.shape
    num_nodes = m if num_nodes is None else num_nodes
    offs = torch.arange(N, device=h.device, dtype=torch.int64)[:, None]
    src_g = (src.long() + offs * m).reshape(-1)
    dst_g = (dst.long() + offs * num_nodes).reshape(-1)
    msg = h.float().reshape(N * m, d)[src_g] * w.float().reshape(-1, 1)
    out = torch.zeros(N * num_nodes, d, dtype=torch.float32, device=h.device)
    out.index_add_(0, dst_g, msg)
    return out.reshape(N, num_nodes, d).to(h.dtype)


def sed_eta(seg_valid: torch.Tensor, fresh_mask: torch.Tensor,
            drop_mask: torch.Tensor, keep_prob: float, num_sampled: int,
            ages: torch.Tensor = None, decay: float = 0.0):
    """The Eq.-1 η weights from the three masks: (eta (B, J), J_i (B, 1)).

    Shared by ``sed_pool_ref`` and the backward of ``sed_pool``, and
    mirrored operation for operation by ``csrc/sed_pool.cu``.  With
    ``ages`` (B, J) and λ = ``decay`` > 0 the STALE branch is further
    weighted by exp(-λ·age); λ = 0 (or no ages) is the unaged formula.
    """
    valid = seg_valid.float()
    fresh = fresh_mask.float()
    drop = drop_mask.float()
    J_i = torch.sum(valid, dim=-1, keepdim=True)
    eta_fresh = keep_prob + (1.0 - keep_prob) * J_i / float(num_sampled)
    stale = valid * (1.0 - fresh)
    stale_term = stale * (1.0 - drop)
    if ages is not None and decay > 0.0:
        stale_term = stale_term * torch.exp(-decay * ages.float())
    eta = (fresh * eta_fresh + stale_term) * valid
    return eta, J_i


def sed_pool_ref(h: torch.Tensor, seg_valid: torch.Tensor,
                 fresh_mask: torch.Tensor, drop_mask: torch.Tensor,
                 keep_prob: float, num_sampled: int, agg: str = "mean",
                 ages: torch.Tensor = None, decay: float = 0.0) -> torch.Tensor:
    """Fused SED η-weighting (Eq. 1) + segment aggregation ⊕.

    h: (B, J, d); masks (and ``ages``): (B, J) -> (B, d).  Matches
    core.segment.sed_weights + core.segment.aggregate composed (given the
    same drop draw).
    """
    eta, J_i = sed_eta(seg_valid, fresh_mask, drop_mask, keep_prob,
                       num_sampled, ages, decay)
    s = torch.sum(h * eta[..., None].to(h.dtype), dim=1)
    if agg == "sum":
        return s
    return s / torch.clamp(J_i, min=1.0).to(s.dtype)
