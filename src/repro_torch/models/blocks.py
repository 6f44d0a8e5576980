"""Uniform block interface over the layer kinds the port has so far.

Counterpart of ``src/repro/models/blocks.py``.  Every block kind exposes:
    block_init(kind, generator, cfg, dtype, n)            -> params tree
    block_forward(kind, p, x, cfg, mode, ...)             -> (x, new_cache, aux)
    init_block_cache(kind, cfg, batch, cache_len, dtype)  -> cache tree
with a kind-stable tree structure, so a run of equal-kind layers is stored
stacked along a leading layer axis (see transformer.py).

Kinds:
    attn       — pre-norm GQA attention + dense MLP (window-maskable)
    mla_dense  — MLA attention + dense MLP      (DeepSeek-V3 dense layers)
    mla_moe    — MLA attention + MoE            (DeepSeek-V3 MoE layers)
    gqa_moe    — GQA attention + MoE (+ dense residual)          (Arctic)
The Mamba2, RWKV6 and shared attention kinds raise
``NotImplementedError``: they wait for ROADMAP A4.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (
    _A4,
    attn_decode,
    attn_forward,
    attn_params,
    make_norm,
    mlp_forward,
    mlp_params,
)

KINDS = ("attn", "mla_dense", "mla_moe", "gqa_moe")


def _unported(kind: str):
    return NotImplementedError(f"block kind {kind!r} {_A4}")


def block_init(kind: str, generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, n: int = 1):
    """The parameters of ``n`` layers of ``kind``, stacked on a leading
    axis of length n, drawn on ``generator``'s device."""
    if kind not in KINDS:
        raise _unported(kind)
    d = cfg.d_model
    dev = generator.device
    lead = (n,)
    n1, _ = make_norm(cfg.norm, d, dtype, lead, dev)
    n2, _ = make_norm(cfg.norm, d, dtype, lead, dev)
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
                     dtype, n: int = 1, device=None):
    """Zero caches of ``n`` layers of ``kind``, stacked on a leading axis.
    The MoE kinds also carry per-(row, expert) routed-token counters, so
    decode reproduces the forward's capacity dropping (``moe.moe_decode``)."""
    if kind not in KINDS:
        raise _unported(kind)

    def zeros(*shape, dt=dtype):
        return torch.zeros((n,) + shape, dtype=dt, device=device)

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
    decode writes into ``cache`` in place."""
    if kind not in KINDS:
        raise _unported(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    hd = cfg.resolved_head_dim
    mrope = cfg.mrope_sections if cfg.family == "vlm" else ()
    h = _apply_norm(cfg, p["norm1"], x)
    if kind in ("mla_dense", "mla_moe"):
        if mode == "full":
            o, (ckv, kr) = mla_mod.mla_forward(p["mla"], h, cfg, positions)
            new_cache = {"ckv": ckv, "kr": kr} if emit_cache else None
        else:
            o, ckv, kr = mla_mod.mla_decode(p["mla"], h, cache["ckv"],
                                            cache["kr"], cache_pos, cfg)
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
        raise _unported(raw_kind)
    raise ValueError(raw_kind)
