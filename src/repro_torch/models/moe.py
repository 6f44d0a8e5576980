"""Mixture-of-Experts FFN with GShard-style one-hot dispatch.

Counterpart of ``src/repro/models/moe.py``.  Tokens are routed to experts
by one-hot dispatch and combine tensors and einsums, the reference's
default ``DISPATCH_MODE = "einsum"`` (its scatter/gather mode is a speed
switch and is not ported).  The router and the expert products are plain
torch: the reference computes them in jnp, outside any Pallas kernel.

Capacity accounting is per batch row (each sequence is one GShard
dispatch group): token t of row b is dropped at expert e iff the tokens of
the same row routed to e before it already fill the row's capacity
``capacity(S, cfg)``.  Dropping is therefore causal in the token order,
and ``moe_decode`` reproduces it from a per-(row, expert) routed-token
counter kept in the layer's cache.

Supports top-k routing with a capacity factor, always-on shared experts
(DeepSeek-V3 [arXiv:2412.19437]), a dense residual FFN in parallel
(Arctic [hf:Snowflake/snowflake-arctic-base]) and the Switch load-balance
auxiliary loss.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import dense_init, gelu, mlp_forward, mlp_params


def moe_params(generator: torch.Generator, d_model: int, cfg: MoEConfig,
               act: str, dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """The router (always f32), the experts' stacked (E, d, F) / (E, F, d)
    weights (a normal cut at ±2σ times 1/√d, 1/√F), and the shared and
    dense MLPs where the config has them.  ``lead`` stacks layers."""
    E, Fd = cfg.num_experts, cfg.expert_d_ff
    scale_in = 1.0 / math.sqrt(d_model)
    p = {
        "router": dense_init(d_model, E, generator, torch.float32,
                             scale=scale_in, lead=lead),
        "experts": {
            "w_in": dense_init(d_model, Fd, generator, dtype, scale=scale_in,
                               lead=lead + (E,)),
            "w_gate": dense_init(d_model, Fd, generator, dtype,
                                 scale=scale_in, lead=lead + (E,)),
            "w_out": dense_init(Fd, d_model, generator, dtype,
                                scale=1.0 / math.sqrt(Fd), lead=lead + (E,)),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_params(generator, d_model,
                                 Fd * cfg.num_shared_experts, act, dtype, lead)
    if cfg.dense_d_ff:
        p["dense"] = mlp_params(generator, d_model, cfg.dense_d_ff, act, dtype,
                                lead)
    return p


def capacity(tokens_per_row: int, cfg: MoEConfig) -> int:
    """Per-row expert capacity C = ceil(S/E * capacity_factor * k), >= k,
    <= S.  Decode must call this with the sequence length the forward used
    to reproduce the forward's dropping."""
    cap = max(int(math.ceil(tokens_per_row / cfg.num_experts
                            * cfg.capacity_factor * cfg.top_k)), cfg.top_k)
    return min(cap, tokens_per_row)


def _top_k_gating(logits, k: int):
    """logits: (..., E) f32 -> (gates (..., E) renormalised over the k
    selected experts, mask (..., E) in {0, 1}, probs (..., E))."""
    probs = torch.softmax(logits, dim=-1)
    top_idx = torch.topk(probs, k, dim=-1).indices
    mask = torch.zeros_like(probs).scatter_(-1, top_idx, 1.0)
    gates = probs * mask
    denom = torch.sum(gates, dim=-1, keepdim=True)
    return gates / torch.clamp(denom, min=1e-9), mask, probs


def _aux_loss(mask, probs, E: int, K: int, dims):
    """Switch-style load-balance loss over the tokens of ``dims``."""
    return torch.sum(torch.mean(mask, dim=dims) * torch.mean(probs, dim=dims)) \
        * (E / K)


def _expert_ffn(we, expert_in, act: str):
    """expert_in: (B, E, C, D) -> (B, E, C, D), each expert's FFN."""
    if act in ("silu", "swiglu"):
        h = F.silu(torch.einsum("becd,edf->becf", expert_in, we["w_gate"])) \
            * torch.einsum("becd,edf->becf", expert_in, we["w_in"])
    else:
        h = gelu(torch.einsum("becd,edf->becf", expert_in, we["w_in"]))
    return torch.einsum("becf,efd->becd", h, we["w_out"])


def _add_shared_and_dense(p, routed, xt, act: str):
    """routed (T, d) plus the always-on paths beside the experts."""
    out = routed
    for name in ("shared", "dense"):
        if name in p:
            out = out + mlp_forward(p[name], xt, act)
    return out


def moe_forward(p, x, cfg: MoEConfig, act: str, *, with_counts: bool = False):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar[, counts (B, E)]).

    Each expert takes at most C = capacity(S, cfg) tokens of each row;
    overflow tokens are dropped (their routed contribution is zero; the
    shared and dense paths still apply).  ``counts`` is the number of
    tokens each row routed to each expert, dropped ones included: the
    decode counters after a prefill.
    """
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    logits = (x.reshape(B * S, D).float()
              @ p["router"].float()).reshape(B, S, E)
    gates, mask, probs = _top_k_gating(logits, K)
    aux = _aux_loss(mask, probs, E, K, (0, 1))

    cap = capacity(S, cfg)
    # position of each token in its row's expert queue (causal cumsum)
    pos_in_expert = torch.cumsum(mask, dim=1) * mask - 1.0  # (B, S, E)
    keep = (pos_in_expert < cap) & (mask > 0)
    pos_c = torch.clamp(pos_in_expert, 0, cap - 1).long()
    # dispatch: (B, S, E, C), one-hot over the capacity slot of kept tokens
    oh_cap = x.new_zeros((B, S, E, cap)).scatter_(
        -1, pos_c[..., None], keep[..., None].to(x.dtype))
    combine = oh_cap * gates[..., None].to(x.dtype)
    expert_in = torch.einsum("bsec,bsd->becd", oh_cap, x)  # (B, E, C, D)
    expert_out = _expert_ffn(p["experts"], expert_in, act)
    routed = torch.einsum("bsec,becd->bsd", combine, expert_out)
    out = _add_shared_and_dense(p, routed.reshape(B * S, D),
                                x.reshape(B * S, D), act).reshape(B, S, D)
    if with_counts:
        counts = torch.sum(mask, dim=1).to(torch.int32)  # (B, E)
        return out, aux.float(), counts
    return out, aux.float()


def moe_decode(p, x, cfg: MoEConfig, act: str, counts, cap: int):
    """One-token step: x (B, 1, d), counts (B, E) routed-token counters.

    Reproduces ``moe_forward``'s per-row dropping: the token is dropped at
    expert e iff counts[b, e] >= cap, where cap is the forward's
    ``capacity(seq_len, cfg)``.  The experts run by a gather of the k
    selected experts' weights, (B, k, d, F) each: O(k) FFNs a token, no
    dispatch tensor.

    Returns (out (B, 1, d), aux scalar, new_counts (B, E)).
    """
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    xt = x.reshape(B, D)
    logits = xt.float() @ p["router"].float()  # (B, E)
    gates, mask, probs = _top_k_gating(logits, K)
    aux = _aux_loss(mask, probs, E, K, 0)

    keep = (counts < cap) & (mask > 0)  # (B, E)
    top_gates, top_idx = torch.topk(gates, K, dim=-1)  # (B, K)
    kept = torch.gather(keep, 1, top_idx)  # (B, K)
    we = p["experts"]
    xk = xt.to(we["w_in"].dtype)
    w_in = we["w_in"][top_idx]  # (B, K, D, F)
    if act in ("silu", "swiglu"):
        h = F.silu(torch.einsum("bd,bkdf->bkf", xk, we["w_gate"][top_idx])) \
            * torch.einsum("bd,bkdf->bkf", xk, w_in)
    else:
        h = gelu(torch.einsum("bd,bkdf->bkf", xk, w_in))
    del w_in
    y = torch.einsum("bkf,bkfd->bkd", h, we["w_out"][top_idx])  # (B, K, D)
    w_eff = torch.where(kept, top_gates, 0.0).to(y.dtype)
    routed = torch.sum(y * w_eff[..., None], dim=1)  # (B, D)
    out = _add_shared_and_dense(p, routed, xt, act)
    new_counts = counts + mask.to(counts.dtype)
    return out.reshape(B, S, D), aux.float(), new_counts
