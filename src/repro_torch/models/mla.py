"""Multi-head Latent Attention (DeepSeek-V3). [arXiv:2412.19437]

Counterpart of ``src/repro/models/mla.py``.  MLA compresses K/V into a
low-rank latent c_kv (rank r_kv) plus one shared RoPE key (rope_head_dim);
Q goes through a low-rank projection too.  The decode cache holds only
(c_kv, k_rope): r_kv + rope_head_dim values a token.

Full sequences (forward, prefill) run the naive expanded form: the latent
is expanded to per-head K/V and attended with the (B, H, S, S) logits.
Decode runs the absorbed form, the reference's default
(``ABSORBED_DECODE = True``): W_uk is folded into the query and W_uv into
the output, so a step attends in latent space.  The reference's naive
decode is a speed switch and is not ported.

Everything here is plain torch, as the reference runs it in jnp.  The
sliding-window attention kernel does not apply: MLA's q·k width (nope +
rope, 192 at full size) differs from v's (128), and the kernel takes one
head dim for q, k and v (``kernels/swa_attention.py``), so deepseek-v3
launches no kernel.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import apply_rope, dense_init, write_cache


def mla_params(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    H = cfg.num_heads
    r_kv, r_q = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank
    dn, dr, dv = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim, cfg.mla_v_head_dim

    def init(d_in, d_out, **kw):
        return dense_init(d_in, d_out, generator, dtype, lead=lead, **kw)

    return {
        "wq_a": init(d, r_q),                # d -> q latent
        "wq_b": init(r_q, H * (dn + dr)),    # q latent -> per-head q
        "wkv_a": init(d, r_kv + dr),         # d -> kv latent + shared rope k
        "wk_b": init(r_kv, H * dn),          # latent -> per-head k_nope
        "wv_b": init(r_kv, H * dv),          # latent -> per-head v
        "wo": init(H * dv, d, scale=1.0 / math.sqrt(H * dv)),
    }


def _project_qkv(p, x, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim
    q = ((x @ p["wq_a"]) @ p["wq_b"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]  # (B, S, r_kv + dr)
    r = cfg.mla_kv_lora_rank
    c_kv, k_rope = kv[..., :r], kv[..., r:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p, x, cfg: ArchConfig, positions, causal: bool = True):
    """Naive (expanded) MLA over a full sequence.  Returns (out, (c_kv,
    k_rope)) so prefill can emit the compressed cache."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim, cfg.mla_v_head_dim
    q_nope, q_rope, c_kv, k_rope = _project_qkv(p, x, cfg, positions)
    k_nope = (c_kv @ p["wk_b"]).reshape(B, S, H, dn)
    v = (c_kv @ p["wv_b"]).reshape(B, S, H, dv)
    scale = 1.0 / math.sqrt(dn + dr)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)).float() * scale
    if causal:
        qp = torch.arange(S, device=x.device)
        mask = qp[None, :] <= qp[:, None]
        logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    del logits
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(B, S, H * dv) @ p["wo"]
    return out, (c_kv, k_rope)


def mla_decode(p, x, cache_ckv, cache_krope, cache_pos, cfg: ArchConfig):
    """One-token MLA decode against the compressed cache, absorbed form:

        logits = (q_nope @ W_uk^T) @ c_kv^T + q_rope @ k_rope^T
        out    = (probs @ c_kv) @ W_uv, then the head merge through wo.

    x: (B, 1, d); cache_ckv: (B, C, r_kv); cache_krope: (B, C, dr), both
    written in place at slot cache_pos (B,) and returned.
    """
    B = x.shape[0]
    C = cache_ckv.shape[1]
    H = cfg.num_heads
    dn, dr, dv = cfg.mla_nope_head_dim, cfg.mla_rope_head_dim, cfg.mla_v_head_dim
    r_kv = cfg.mla_kv_lora_rank
    q_nope, q_rope, c_kv_new, k_rope_new = _project_qkv(
        p, x, cfg, cache_pos[:, None])
    write_idx = torch.clamp(cache_pos, max=C - 1)
    cache_ckv = write_cache(cache_ckv, c_kv_new, write_idx)
    cache_krope = write_cache(cache_krope, k_rope_new, write_idx)
    valid = torch.clamp(cache_pos + 1, max=C)
    scale = 1.0 / math.sqrt(dn + dr)
    # absorb W_uk into q: (B, 1, H, dn) x (r, H, dn) -> (B, 1, H, r)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope,
                         p["wk_b"].reshape(r_kv, H, dn))
    logits = (torch.einsum("bqhr,bkr->bhqk", q_lat, cache_ckv)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, cache_krope)
              ).float() * scale
    k_idx = torch.arange(C, device=x.device)[None, :]
    logits = torch.where((k_idx < valid[:, None])[:, None, None, :], logits,
                         -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkr->bqhr", probs, cache_ckv)  # (B, 1, H, r)
    out = torch.einsum("bqhr,rhd->bqhd", ctx, p["wv_b"].reshape(r_kv, H, dv))
    out = out.reshape(B, 1, H * dv) @ p["wo"]
    return out, cache_ckv, cache_krope
