"""Mixture-of-Experts FFN with GShard-style one-hot dispatch.

Counterpart of ``src/repro/models/moe.py``.  ``DISPATCH_MODE``, read at
call time as the reference reads it, picks how the forward routes tokens
to experts: "einsum" (the default), one-hot dispatch and combine tensors
(B, S, E, C) and einsums; or "gather", the same function with no one-hot
planes and no dispatch FLOPs: the kept tokens are scattered into their
(expert, slot) cells, the experts' outputs gathered back and summed with
their gates.  The router and the expert products are plain torch: the
reference computes them in jnp, outside any Pallas kernel.

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
from torch.overrides import handle_torch_function, has_torch_function

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


# Dispatch of moe_forward:
#   "einsum" - GShard one-hot dispatch / combine einsums, O(T·E·C·d)
#              FLOPs;
#   "gather" - a scatter of each kept (token, expert) into its (expert,
#              slot) cell and a gather back, O(T·k·d) data movement.
DISPATCH_MODE = "einsum"


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


def _einsum_dispatch(we, x, gates, pos_c, keep, cap: int, act: str,
                     first: int = 0):
    """The routed output (B, S, D) of ``moe_forward`` by GShard's one-hot
    dispatch: a (B, S, E, C) plane, one-hot over the slot of each kept
    (token, expert) pair, takes the tokens into the (B, E, C, D) expert
    input by an einsum, and the same plane weighted by the gates combines
    the experts' outputs back.

    ``we`` may hold a run of the experts, ``first`` … ``first`` + its
    count − 1: ``gates``, ``pos_c`` and ``keep`` (B, S, E) are cut to
    the run's columns, so the runs' outputs sum to the whole.  A torch
    function, as ``_gather_dispatch`` is: the dry run runs each device's
    experts on their run (``launch/dryrun.py``)."""
    operands = (x, gates, pos_c, keep, *we.values())
    if has_torch_function(operands):
        return handle_torch_function(_einsum_dispatch, operands, we, x,
                                     gates, pos_c, keep, cap, act,
                                     first=first)
    return einsum_dispatch_ops(we, x, gates, pos_c, keep, cap, act, first)


def einsum_dispatch_ops(we, x, gates, pos_c, keep, cap: int, act: str,
                        first: int = 0):
    """The ops of ``_einsum_dispatch`` (see there), as plain ops."""
    B, S, D = x.shape
    E = we["w_in"].shape[0]
    if first or E != gates.shape[-1]:
        gates, pos_c, keep = (t[..., first:first + E]
                              for t in (gates, pos_c, keep))
    # dispatch: (B, S, E, C), one-hot over the slot of kept tokens
    oh_cap = x.new_zeros((B, S, E, cap)).scatter_(
        -1, pos_c[..., None], keep[..., None].to(x.dtype))
    combine = oh_cap * gates[..., None].to(x.dtype)
    expert_in = torch.einsum("bsec,bsd->becd", oh_cap, x)  # (B, E, C, D)
    expert_out = _expert_ffn(we, expert_in, act)
    return torch.einsum("bsec,becd->bsd", combine, expert_out)


def _gather_dispatch(we, x, gates, pos_c, keep, cap: int, K: int, act: str,
                     first: int = 0):
    """The routed output (B, S, D) of ``moe_forward`` by scatter and
    gather: each of a token's k (expert, gate) pairs goes to its slot of
    the (B, E, C + 1, D) expert input, a dropped one to the overflow slot
    C, cut off before the FFN; the outputs come back by a gather and a
    sum weighted by the gates (0 for a dropped pair).  Kept pairs own
    distinct (row, expert, slot) cells and dropped ones add zeros, so the
    accumulating scatter gives the same values in any order.

    ``we`` may hold a run of the experts, ``first`` … ``first`` + its
    count − 1: a pair routed to another adds nothing (dropped here), so
    the runs' outputs sum to the whole.  It is a torch function, so a
    torch function mode may run it its own way: the dry run runs each
    device's experts on their run (``launch/dryrun.py``)."""
    operands = (x, gates, pos_c, keep, *we.values())
    if has_torch_function(operands):
        return handle_torch_function(_gather_dispatch, operands, we, x,
                                     gates, pos_c, keep, cap, K, act,
                                     first=first)
    return gather_dispatch_ops(we, x, gates, pos_c, keep, cap, K, act, first)


def gather_dispatch_ops(we, x, gates, pos_c, keep, cap: int, K: int,
                        act: str, first: int = 0):
    """The ops of ``_gather_dispatch`` (see there), as plain ops."""
    B, S, D = x.shape
    E = we["w_in"].shape[0]
    top_gates, top_idx = torch.topk(gates, K, dim=-1)  # (B, S, K)
    slot = torch.gather(pos_c, 2, top_idx)
    kept = torch.gather(keep, 2, top_idx)
    if first or E != gates.shape[-1]:
        top_idx = top_idx - first
        kept = kept & (top_idx >= 0) & (top_idx < E)
        top_idx = top_idx.clamp(0, E - 1)
    # each (row, expert, slot) cell flattened to one axis, the pairs to
    # another: the scatter and the gather take one index a pair, not one
    # an element
    rows = torch.arange(B, device=x.device)[:, None]
    e_flat = top_idx.reshape(B, S * K)
    s_flat = slot.reshape(B, S * K)
    k_flat = kept.reshape(B, S * K)
    w_flat = torch.where(kept, top_gates, 0.0).reshape(B, S * K).to(x.dtype)
    s_safe = torch.where(k_flat, s_flat, cap)
    x_rep = x.repeat_interleave(K, dim=1)  # (B, S*K, D)
    cell = ((rows * E + e_flat) * (cap + 1) + s_safe).reshape(-1)
    expert_in = x.new_zeros((B * E * (cap + 1), D)).index_add(
        0, cell, torch.where(k_flat[..., None], x_rep, 0.0).reshape(-1, D))
    expert_out = _expert_ffn(
        we, expert_in.reshape(B, E, cap + 1, D)[:, :, :cap], act)
    cell = ((rows * E + e_flat) * cap
            + torch.clamp(s_flat, max=cap - 1)).reshape(-1)
    gathered = expert_out.reshape(B * E * cap, D).index_select(0, cell)
    return torch.sum((gathered * w_flat.reshape(-1, 1)).reshape(B, S, K, D),
                     dim=2)


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
    if DISPATCH_MODE == "einsum":
        routed = _einsum_dispatch(p["experts"], x, gates, pos_c, keep, cap,
                                  act)
    else:
        routed = _gather_dispatch(p["experts"], x, gates, pos_c, keep, cap,
                                  K, act)
    out = _add_shared_and_dense(p, routed.reshape(B * S, D),
                                x.reshape(B * S, D), act).reshape(B, S, D)
    if with_counts:
        counts = torch.sum(mask, dim=1).to(torch.int32)  # (B, E)
        return out, aux.float(), counts
    return out, aux.float()


def _decode_experts(we, xk, top_idx, w_eff, act: str, first: int = 0):
    """The routed output (B, D) of ``moe_decode``: each token's k
    selected experts run on it by a gather of their weights, (B, k, d, F)
    each, and their outputs are summed with the weights ``w_eff`` (B, k)
    (the gates, 0 for a dropped pair).

    ``we`` may hold a run of the experts, ``first`` … ``first`` + its
    count − 1: a pair routed to another adds nothing, so the runs'
    outputs sum to the whole.  A torch function, as ``_gather_dispatch``
    is: the dry run runs it on its own layout (``launch/dryrun.py``)."""
    operands = (xk, top_idx, w_eff, *we.values())
    if has_torch_function(operands):
        return handle_torch_function(_decode_experts, operands, we, xk,
                                     top_idx, w_eff, act, first=first)
    return decode_experts_ops(we, xk, top_idx, w_eff, act, first)


def decode_experts_ops(we, xk, top_idx, w_eff, act: str, first: int = 0):
    """The ops of ``_decode_experts`` (see there), as plain ops."""
    E = we["w_in"].shape[0]
    # the pairs of another run: weight 0 on a clamped expert of this one
    top_idx = top_idx - first
    w_eff = torch.where((top_idx >= 0) & (top_idx < E), w_eff, 0.0)
    top_idx = top_idx.clamp(0, E - 1)
    w_in = we["w_in"][top_idx]  # (B, K, D, F)
    if act in ("silu", "swiglu"):
        h = F.silu(torch.einsum("bd,bkdf->bkf", xk, we["w_gate"][top_idx])) \
            * torch.einsum("bd,bkdf->bkf", xk, w_in)
    else:
        h = gelu(torch.einsum("bd,bkdf->bkf", xk, w_in))
    del w_in
    y = torch.einsum("bkf,bkfd->bkd", h, we["w_out"][top_idx])  # (B, K, D)
    return torch.sum(y * w_eff[..., None], dim=1)  # (B, D)


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
    w_eff = torch.where(kept, top_gates, 0.0).to(we["w_in"].dtype)
    routed = _decode_experts(we, xt.to(we["w_in"].dtype), top_idx, w_eff,
                             act)
    out = _add_shared_and_dense(p, routed, xt, act)
    new_counts = counts + mask.to(counts.dtype)
    return out.reshape(B, S, D), aux.float(), new_counts
