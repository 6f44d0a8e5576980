"""Uniform block interface over all layer kinds.

Counterpart of ``src/repro/models/blocks.py``.  Every block kind exposes:
    block_init(kind, generator, cfg, dtype, lead)               -> params tree
    block_forward(kind, p, x, cfg, mode, ...)                   -> (x, new_cache, aux)
    init_block_cache(kind, cfg, batch, cache_len, dtype, lead)  -> cache tree
with a kind-stable tree structure, so a run of equal-kind layers is stored
stacked along a leading layer axis (see transformer.py).

Kinds:
    attn        — pre-norm GQA attention + dense MLP (window-maskable)
    mla_dense   — MLA attention + dense MLP      (DeepSeek-V3 dense layers)
    mla_moe     — MLA attention + MoE            (DeepSeek-V3 MoE layers)
    gqa_moe     — GQA attention + MoE (+ dense residual)          (Arctic)
    mamba       — Mamba2/SSD block                        (Zamba2 backbone)
    rwkv        — RWKV6 time-mix + channel-mix
    shared_attn — the structure of ``attn``; one parameter set shared by
                  every occurrence (Zamba2), a cache each occurrence.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (
    attn_decode,
    attn_forward,
    attn_params,
    make_norm,
    mlp_forward,
    mlp_params,
)

KINDS = ("attn", "mla_dense", "mla_moe", "gqa_moe", "mamba", "rwkv",
         "shared_attn")


def block_init(kind: str, generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """The parameters of a layer of ``kind``, drawn on ``generator``'s
    device; ``lead`` = (n,) stacks n layers on a leading axis."""
    if kind not in KINDS:
        raise ValueError(kind)
    d = cfg.d_model
    dev = generator.device
    n1, _ = make_norm(cfg.norm, d, dtype, lead, dev)
    if kind == "mamba":
        return {"norm1": n1,
                "mamba": mamba_mod.mamba2_params(generator, cfg, dtype, lead)}
    n2, _ = make_norm(cfg.norm, d, dtype, lead, dev)
    if kind == "rwkv":
        return {"norm1": n1,
                "tm": rwkv_mod.rwkv_timemix_params(generator, cfg, dtype, lead),
                "norm2": n2,
                "cm": rwkv_mod.rwkv_channelmix_params(generator, cfg, dtype,
                                                      lead)}
    if kind in ("mla_dense", "mla_moe"):
        mixer = {"mla": mla_mod.mla_params(generator, cfg, dtype, lead)}
    else:
        mixer = {"attn": attn_params(generator, d, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.resolved_head_dim,
                                     dtype, lead=lead)}
    if kind in ("mla_moe", "gqa_moe"):
        ffn = {"moe": moe_mod.moe_params(generator, d, cfg.moe, cfg.act,
                                         dtype, lead)}
    else:
        ffn = {"mlp": mlp_params(generator, d, cfg.d_ff, cfg.act, dtype,
                                 lead=lead)}
    return {"norm1": n1, **mixer, "norm2": n2, **ffn}


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int,
                     dtype, lead: Tuple[int, ...] = (), device=None):
    """The zero cache of a layer of ``kind``; ``lead`` = (n,) stacks n
    layers.  The MoE kinds also carry per-(row, expert) routed-token
    counters, so decode reproduces the forward's capacity dropping
    (``moe.moe_decode``); the recurrent kinds carry their states (f32)
    and their last inputs, and no sequence axis."""
    if kind not in KINDS:
        raise ValueError(kind)

    def zeros(*shape, dt=dtype):
        return torch.zeros(tuple(lead) + shape, dtype=dt, device=device)

    if kind == "mamba":
        d_inner, H, P, N = mamba_mod.mamba2_dims(cfg)
        return {"conv": zeros(batch, cfg.ssm.conv_width - 1, d_inner),
                "ssm": zeros(batch, H, P, N, dt=torch.float32)}
    if kind == "rwkv":
        H, N = rwkv_mod.rwkv_dims(cfg)
        return {"state": zeros(batch, H, N, N, dt=torch.float32),
                "shift_tm": zeros(batch, cfg.d_model),
                "shift_cm": zeros(batch, cfg.d_model)}
    if kind in ("mla_dense", "mla_moe"):
        c = {"ckv": zeros(batch, cache_len, cfg.mla_kv_lora_rank),
             "kr": zeros(batch, cache_len, cfg.mla_rope_head_dim)}
    else:
        shp = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        c = {"k": zeros(*shp), "v": zeros(*shp)}
    if kind in ("mla_moe", "gqa_moe"):
        c["moe_counts"] = zeros(batch, cfg.moe.num_experts, dt=torch.int32)
    return c


def _apply_norm(cfg: ArchConfig, p, x):
    _, fn = make_norm(cfg.norm, cfg.d_model, x.dtype)
    return fn(p, x)


def _moe_ffn(p, h, cfg: ArchConfig, *, mode, cache, new_cache, cache_len,
             moe_cap_len):
    """The MoE of the gqa_moe / mla_moe blocks.

    Decode reproduces the forward's per-row capacity dropping from the
    counters in the cache (updated in place); the capacity is
    ``capacity(cache_len)`` — the teacher-forced forward over
    ``cache_len`` tokens — unless ``moe_cap_len`` pins the sequence length
    (a cache allocated longer than the sequence reproduced).  Adds
    'moe_counts' to new_cache when there is one.
    """
    if mode == "full":
        o, aux, counts = moe_mod.moe_forward(
            p["moe"], h, cfg.moe, cfg.act, with_counts=True)
        if new_cache is not None:
            new_cache["moe_counts"] = counts
    else:
        cap = moe_mod.capacity(moe_cap_len or cache_len, cfg.moe)
        o, aux, counts = moe_mod.moe_decode(
            p["moe"], h, cfg.moe, cfg.act, cache["moe_counts"], cap)
        new_cache["moe_counts"] = cache["moe_counts"].copy_(counts)
    return o, aux


def block_forward(
    kind: str,
    p,
    x,
    cfg: ArchConfig,
    *,
    mode: str,                      # "full" | "decode"
    positions=None,                 # (B, S) absolute positions (full mode)
    positions_thw=None,             # (B, S, 3) M-RoPE ids (vlm)
    cache=None,
    cache_pos=None,                 # (B,) decode position
    window: int = 0,                # sliding-window size; 0 = full attention
    ring: bool = False,             # decode cache is a ring buffer
    emit_cache: bool = False,       # full mode: return the cache (prefill)
    moe_cap_len: int = 0,           # MoE decode capacity sequence length;
                                    # 0 = the cache length
    use_kernels: bool = True,       # full mode: attention through the kernel
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """One layer.  ``p`` and ``cache`` are the layer's own (unstacked);
    decode writes into ``cache`` in place (the recurrent kinds copy their
    new states and last inputs into it), but for the attention caches
    under ``common.CACHE_UPDATE`` "onehot", which come back new."""
    if kind not in KINDS:
        raise ValueError(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    hd = cfg.resolved_head_dim
    mrope = cfg.mrope_sections if cfg.family == "vlm" else ()
    h = _apply_norm(cfg, p["norm1"], x)
    if kind == "mamba":
        if mode == "full":
            o, (conv, ssm) = mamba_mod.mamba2_forward(p["mamba"], h, cfg)
            new_cache = {"conv": conv, "ssm": ssm} if emit_cache else None
        else:
            o, (conv, ssm) = mamba_mod.mamba2_decode(
                p["mamba"], h, cache["conv"], cache["ssm"], cfg)
            new_cache = {"conv": cache["conv"].copy_(conv),
                         "ssm": cache["ssm"].copy_(ssm)}
        return x + o, new_cache, aux
    if kind == "rwkv":
        decode = mode != "full"
        o, (state, last) = rwkv_mod.rwkv_timemix(
            p["tm"], h, cfg, state=cache["state"] if decode else None,
            shift_prev=cache["shift_tm"] if decode else None)
        x = x + o
        o, last2 = rwkv_mod.rwkv_channelmix(
            p["cm"], _apply_norm(cfg, p["norm2"], x),
            shift_prev=cache["shift_cm"] if decode else None)
        if decode:
            new_cache = {"state": cache["state"].copy_(state),
                         "shift_tm": cache["shift_tm"].copy_(last),
                         "shift_cm": cache["shift_cm"].copy_(last2)}
        else:
            new_cache = ({"state": state, "shift_tm": last, "shift_cm": last2}
                         if emit_cache else None)
        return x + o, new_cache, aux
    if kind in ("mla_dense", "mla_moe"):
        if mode == "full":
            o, (ckv, kr) = mla_mod.mla_forward(p["mla"], h, cfg, positions)
            new_cache = {"ckv": ckv, "kr": kr} if emit_cache else None
        else:
            o, ckv, kr = mla_mod.mla_decode(
                p["mla"], h, cache["ckv"], cache["kr"], cache_pos, cfg,
                absorbed=mla_mod.ABSORBED_DECODE)
            new_cache = {"ckv": ckv, "kr": kr}
    elif mode == "full":
        o, (k, v) = attn_forward(
            p["attn"], h, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=hd, positions=positions, rope_theta=cfg.rope_theta,
            causal=True, window=window, mrope_sections=mrope,
            positions_thw=positions_thw, use_kernels=use_kernels)
        new_cache = {"k": k, "v": v} if emit_cache else None
    else:
        o, ck, cv = attn_decode(
            p["attn"], h, cache["k"], cache["v"], cache_pos,
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads, head_dim=hd,
            rope_theta=cfg.rope_theta, ring=ring, mrope_sections=mrope,
            positions_thw=positions_thw)
        new_cache = {"k": ck, "v": cv}
    x = x + o
    h = _apply_norm(cfg, p["norm2"], x)
    if kind in ("mla_moe", "gqa_moe"):
        cache_len = 0
        if cache is not None:
            cache_len = cache["ckv" if kind == "mla_moe" else "k"].shape[1]
        o, aux = _moe_ffn(p, h, cfg, mode=mode, cache=cache,
                          new_cache=new_cache, cache_len=cache_len,
                          moe_cap_len=moe_cap_len)
    else:
        o = mlp_forward(p["mlp"], h, cfg.act)
    return x + o, new_cache, aux


def resolve_kind(cfg: ArchConfig, raw_kind: str) -> str:
    """Map a config-level layer kind to a block kind."""
    if raw_kind == "attn":
        return "attn"
    if raw_kind == "dense":
        return "mla_dense" if cfg.use_mla else "attn"
    if raw_kind == "moe":
        return "mla_moe" if cfg.use_mla else "gqa_moe"
    if raw_kind in ("mamba", "rwkv", "shared_attn"):
        return raw_kind
    raise ValueError(raw_kind)
