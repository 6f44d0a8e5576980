"""The dense decoder as GST's segment encoder F, from the equations.

Pre-norm layers: x += Wo · attn(RoPE(Wq h), RoPE(Wk h), Wv h), h =
norm(x); x += W_out (silu(W_gate h) * (W_in h)), h = norm(x); a final
norm, then the mean over the segment's tokens.  RMSNorm (InternLM2) or
LayerNorm without affine parameters (OLMo).  RoPE rotates the two halves
of each head, frequency theta^(-2i/D).  Causal softmax attention, query
head h reading KV head h // (H / KV).  Weights are taken by the port's
names (``gstbench.weights``), a layer at a time from the stacks.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from gstbench.reference.precision import mm


def norm(x, scale, kind: str, eps: float):
    if kind == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def rope(x, theta: float):
    """x (N, S, heads, D) rotated by position."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(half, device=x.device, dtype=torch.float32)
                     * 2.0 / D)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * freq
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mode: str):
    """q (N, S, H, D), k/v (N, S, KV, D) -> (N, S, H·D), causal."""
    N, S, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(N, S, KV, H // KV, D).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]               # (N, KV, 1, D, S)
    scores = mm(qg, kt, mode) / math.sqrt(D)            # (N, KV, G, S, S)
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    out = mm(probs, v.permute(0, 2, 1, 3)[:, :, None], mode)
    return out.permute(0, 3, 1, 2, 4).reshape(N, S, H * D)


def layer(x, p: Dict[str, torch.Tensor], arch: dict, mode: str):
    N, S, _ = x.shape
    H, KV, D = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    kind, eps = arch["norm"], arch["norm_eps"]
    h = norm(x, p.get("norm1"), kind, eps)
    q = rope(mm(h, p["wq"], mode).view(N, S, H, D), arch["rope_theta"])
    k = rope(mm(h, p["wk"], mode).view(N, S, KV, D), arch["rope_theta"])
    v = mm(h, p["wv"], mode).view(N, S, KV, D)
    x = x + mm(attention(q, k, v, mode), p["wo"], mode)
    h = norm(x, p.get("norm2"), kind, eps)
    ff = F.silu(mm(h, p["w_gate"], mode)) * mm(h, p["w_in"], mode)
    return x + mm(ff, p["w_out"], mode)


STACKED = {"norm1": "runs.0.norm1.scale", "norm2": "runs.0.norm2.scale",
           "wq": "runs.0.attn.wq", "wk": "runs.0.attn.wk",
           "wv": "runs.0.attn.wv", "wo": "runs.0.attn.wo",
           "w_in": "runs.0.mlp.w_in", "w_gate": "runs.0.mlp.w_gate",
           "w_out": "runs.0.mlp.w_out"}


def encode(w: Dict[str, torch.Tensor], arch: dict, tokens, mode: str = "f32"):
    """Segment embeddings (N, d) of tokens (N, S): GST's F."""
    x = w["embed"][tokens.long()]
    for i in range(arch["num_layers"]):
        p = {k: w[name][i] for k, name in STACKED.items() if name in w}
        x = layer(x, p, arch, mode)
    x = norm(x, w.get("final_norm.scale"), arch["norm"], arch["norm_eps"])
    return x.mean(dim=1)
