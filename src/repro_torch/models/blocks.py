"""Uniform block interface over the layer kinds the port has so far.

Counterpart of ``src/repro/models/blocks.py``.  Every block kind exposes:
    block_init(kind, generator, cfg, dtype, n)            -> params tree
    block_forward(kind, p, x, cfg, mode, ...)             -> (x, new_cache, aux)
    init_block_cache(kind, cfg, batch, cache_len, dtype)  -> cache tree
with a kind-stable tree structure, so a run of equal-kind layers is stored
stacked along a leading layer axis (see transformer.py).

Kinds: ``attn`` — pre-norm GQA attention + dense MLP (window-maskable), the
only kind of the dense family.  The MLA, MoE, Mamba2, RWKV6 and shared
attention kinds raise ``NotImplementedError``: they wait for ROADMAP A4.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    _A4,
    attn_decode,
    attn_forward,
    attn_params,
    make_norm,
    mlp_forward,
    mlp_params,
)


def _unported(kind: str):
    return NotImplementedError(f"block kind {kind!r} {_A4}")


def block_init(kind: str, generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, n: int = 1):
    """The parameters of ``n`` layers of ``kind``, stacked on a leading
    axis of length n, drawn on ``generator``'s device."""
    if kind != "attn":
        raise _unported(kind)
    d = cfg.d_model
    dev = generator.device
    n1, _ = make_norm(cfg.norm, d, dtype, (n,), dev)
    n2, _ = make_norm(cfg.norm, d, dtype, (n,), dev)
    return {
        "norm1": n1,
        "attn": attn_params(generator, d, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, dtype, lead=(n,)),
        "norm2": n2,
        "mlp": mlp_params(generator, d, cfg.d_ff, cfg.act, dtype, lead=(n,)),
    }


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, cache_len: int,
                     dtype, n: int = 1, device=None):
    """Zero caches of ``n`` layers of ``kind``, stacked on a leading axis."""
    if kind != "attn":
        raise _unported(kind)
    shp = (n, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def _apply_norm(cfg: ArchConfig, p, x):
    _, fn = make_norm(cfg.norm, cfg.d_model, x.dtype)
    return fn(p, x)


def block_forward(
    kind: str,
    p,
    x,
    cfg: ArchConfig,
    *,
    mode: str,                      # "full" | "decode"
    positions=None,                 # (B, S) absolute positions (full mode)
    cache=None,
    cache_pos=None,                 # (B,) decode position
    window: int = 0,                # sliding-window size; 0 = full attention
    ring: bool = False,             # decode cache is a ring buffer
    emit_cache: bool = False,       # full mode: return (k, v) as cache (prefill)
    use_kernels: bool = True,       # full mode: attention through the kernel
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """One layer.  ``p`` and ``cache`` are the layer's own (unstacked)."""
    if kind != "attn":
        raise _unported(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    hd = cfg.resolved_head_dim
    h = _apply_norm(cfg, p["norm1"], x)
    if mode == "full":
        o, (k, v) = attn_forward(
            p["attn"], h, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=hd, positions=positions, rope_theta=cfg.rope_theta,
            causal=True, window=window, use_kernels=use_kernels)
        new_cache = {"k": k, "v": v} if emit_cache else None
    else:
        o, ck, cv = attn_decode(
            p["attn"], h, cache["k"], cache["v"], cache_pos,
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads, head_dim=hd,
            rope_theta=cfg.rope_theta, ring=ring)
        new_cache = {"k": ck, "v": cv}
    x = x + o
    h = _apply_norm(cfg, p["norm2"], x)
    return x + mlp_forward(p["mlp"], h, cfg.act), new_cache, aux


def resolve_kind(cfg: ArchConfig, raw_kind: str) -> str:
    """Map a config-level layer kind to a block kind."""
    if raw_kind == "attn" or (raw_kind == "dense" and not cfg.use_mla):
        return "attn"
    if raw_kind in ("dense", "moe", "mamba", "rwkv", "shared_attn"):
        raise _unported(raw_kind if raw_kind != "dense" else "mla_dense")
    raise ValueError(raw_kind)
