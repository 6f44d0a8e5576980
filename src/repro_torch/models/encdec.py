"""Whisper-style encoder-decoder backbone. [arXiv:2212.04356]

Counterpart of ``src/repro/models/encdec.py``.  The mel-spectrogram and
conv feature extractor are a stub, as in the reference: the model consumes
precomputed frame embeddings (B, T, d_model).  The transformer backbone:
  * encoder — non-causal self-attention blocks over the frames (+
    sinusoidal positions), through ``common.sdpa``;
  * decoder — causal self-attention (``common.attn_forward``: the
    sliding-window attention kernel with ``use_kernels``) and
    cross-attention to the encoder output (``sdpa``);
  * decode — the self-attention cache, stacked (L, B, C, KV, hd) and
    written in place, and the precomputed cross-attention K/V.
The layers' parameters are stacked on a leading axis, as the reference
stacks them for ``lax.scan``; a Python loop takes the place of the scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    attn_decode,
    attn_forward,
    attn_params,
    dense_init,
    embed_init,
    layernorm,
    layernorm_params,
    mlp_forward,
    mlp_params,
    sinusoidal_positions,
)
from repro_torch.models.transformer import _layer


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32):
    """The parameter tree, drawn on ``generator``'s device from it."""
    d, hd, dev = cfg.d_model, cfg.resolved_head_dim, generator.device

    def attn(n):
        return attn_params(generator, d, cfg.num_heads, cfg.num_kv_heads, hd,
                           dtype, lead=(n,))

    def norm(n=None):
        return layernorm_params(d, dtype, () if n is None else (n,), dev)

    ne, nd = cfg.num_encoder_layers, cfg.num_layers
    params = {"embed": embed_init(cfg.vocab_size, d, generator, dtype)}
    params["enc_blocks"] = {
        "norm1": norm(ne), "attn": attn(ne), "norm2": norm(ne),
        "mlp": mlp_params(generator, d, cfg.d_ff, cfg.act, dtype, lead=(ne,))}
    params["enc_final"] = norm()
    params["dec_blocks"] = {
        "norm1": norm(nd), "self_attn": attn(nd), "norm_x": norm(nd),
        "cross_attn": attn(nd), "norm2": norm(nd),
        "mlp": mlp_params(generator, d, cfg.d_ff, cfg.act, dtype, lead=(nd,))}
    params["final_norm"] = norm()
    params["lm_head"] = dense_init(d, cfg.vocab_size, generator, dtype)
    return params


def _heads(cfg: ArchConfig):
    return dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim)


def encode(params, cfg: ArchConfig, frames):
    """frames: (B, T, d_model) stub frame embeddings -> (B, T, d_model)."""
    B, T, d = frames.shape
    x = frames + sinusoidal_positions(T, d, frames.dtype, frames.device)[None]
    pos = torch.arange(T, device=frames.device)[None].expand(B, T)
    for i in range(cfg.num_encoder_layers):
        p = _layer(params["enc_blocks"], i)
        o, _ = attn_forward(p["attn"], layernorm(p["norm1"], x), **_heads(cfg),
                            positions=pos, rope_theta=0.0, causal=False)
        x = x + o
        x = x + mlp_forward(p["mlp"], layernorm(p["norm2"], x), cfg.act)
    return layernorm(params["enc_final"], x)


def cross_kv(params, cfg: ArchConfig, enc_out):
    """Every decoder layer's cross-attention K/V of the encoder output:
    (k, v), each (L, B, T, KV, hd)."""
    B, T, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    shp = (cfg.num_layers, B, T, cfg.num_kv_heads, hd)
    k, v = enc_out.new_empty(shp), enc_out.new_empty(shp)
    for i in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], i)["cross_attn"]
        k[i] = (enc_out @ p["wk"]).reshape(shp[1:])
        v[i] = (enc_out @ p["wv"]).reshape(shp[1:])
    return k, v


def decoder_forward(params, cfg: ArchConfig, tokens, enc_out, *,
                    emit_cache: bool = False, use_kernels: bool = True):
    """Teacher-forced decoder pass.  Returns (hidden, (k, v) self-attention
    caches, each (L, B, S, KV, hd), or None)."""
    B, S = tokens.shape
    x = F.embedding(tokens.long(), params["embed"])
    x = x + sinusoidal_positions(S, cfg.d_model, x.dtype, x.device)[None]
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    xk, xv = cross_kv(params, cfg, enc_out)
    kv = None
    for i in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], i)
        o, (k, v) = attn_forward(p["self_attn"], layernorm(p["norm1"], x),
                                 **_heads(cfg), positions=pos, rope_theta=0.0,
                                 causal=True, use_kernels=use_kernels)
        x = x + o
        o, _ = attn_forward(p["cross_attn"], layernorm(p["norm_x"], x),
                            **_heads(cfg), positions=pos, rope_theta=0.0,
                            causal=False, kv_override=(xk[i], xv[i]))
        x = x + o
        x = x + mlp_forward(p["mlp"], layernorm(p["norm2"], x), cfg.act)
        if emit_cache:
            if kv is None:
                kv = tuple(k.new_empty((cfg.num_layers,) + tuple(k.shape))
                           for _ in range(2))
            kv[0][i], kv[1][i] = k, v
    return layernorm(params["final_norm"], x), kv


def init_self_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                    device=None):
    shp = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
           cfg.resolved_head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def decode_step(params, cfg: ArchConfig, token, self_cache, xkv, cache_pos):
    """token: (B, 1); self_cache: stacked (L, B, C, KV, hd), written in
    place and returned (a new one under ``common.CACHE_UPDATE`` "onehot");
    xkv: the cross K/V of ``cross_kv``; cache_pos: (B,).  Returns (logits
    (B, 1, vocab), self_cache)."""
    x = F.embedding(token.long(), params["embed"])
    # the sinusoidal position embedding at the current step
    C = self_cache["k"].shape[2]
    x = x + sinusoidal_positions(C, cfg.d_model, x.dtype,
                                 x.device)[cache_pos][:, None, :]
    pos = cache_pos[:, None]
    xk, xv = xkv
    fresh = None
    for i in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], i)
        ck, cv = self_cache["k"][i], self_cache["v"][i]
        o, nk, nv = attn_decode(p["self_attn"], layernorm(p["norm1"], x),
                                ck, cv, cache_pos, **_heads(cfg),
                                rope_theta=0.0)
        if nk is not ck:            # a new cache, not written in place
            if fresh is None:
                fresh = {n: torch.empty_like(c) for n, c in self_cache.items()}
            fresh["k"][i], fresh["v"][i] = nk, nv
        x = x + o
        o, _ = attn_forward(p["cross_attn"], layernorm(p["norm_x"], x),
                            **_heads(cfg), positions=pos, rope_theta=0.0,
                            causal=False, kv_override=(xk[i], xv[i]))
        x = x + o
        x = x + mlp_forward(p["mlp"], layernorm(p["norm2"], x), cfg.act)
    x = layernorm(params["final_norm"], x)
    return x @ params["lm_head"], fresh or self_cache
