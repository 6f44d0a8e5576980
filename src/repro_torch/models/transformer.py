"""Generic decoder-only model assembled from blocks.

Counterpart of ``src/repro/models/transformer.py``.  Layers are grouped
into runs of consecutive equal block kinds; each run's parameters (and
caches) are stacked along a leading layer axis, as the reference stacks
them for ``lax.scan``, so the trees are the reference's:
``runs.<i>.<name>`` with the layer first.  A Python loop over the layers
of a run takes the place of the scan.  The dense and VLM families are one
run of ``attn`` blocks, arctic one of ``gqa_moe``, deepseek-v3 a run of
``mla_dense`` then one of ``mla_moe``; the recurrent kinds wait for
ROADMAP A4 (``blocks.py``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models.common import dense_init, embed_init, make_norm


def layer_runs(cfg: ArchConfig) -> List[Tuple[str, int]]:
    kinds = [B.resolve_kind(cfg, k) for k in cfg.layer_kinds()]
    runs: List[Tuple[str, int]] = []
    for k in kinds:
        if runs and runs[-1][0] == k and k != "shared_attn":
            runs[-1] = (k, runs[-1][1] + 1)
        else:
            runs.append((k, 1))
    return runs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.float32):
    """The parameter tree, drawn on ``generator``'s device from it."""
    runs = layer_runs(cfg)
    params: dict = {"embed": embed_init(cfg.vocab_size, cfg.d_model, generator,
                                        dtype)}
    params["runs"] = [B.block_init(kind, generator, cfg, dtype, n)
                      for kind, n in runs]
    params["final_norm"], _ = make_norm(cfg.norm, cfg.d_model, dtype,
                                        device=generator.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(cfg.d_model, cfg.vocab_size, generator,
                                       dtype)
    return params


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
               device=None):
    return [B.init_block_cache(kind, cfg, batch, cache_len, dtype, n, device)
            for kind, n in layer_runs(cfg)]


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _mrope_ids(cfg: ArchConfig, idx):
    """Purely positional M-RoPE ids [arXiv:2409.12191], idx (...) ->
    (..., 3): the first ``vision_prefix_len`` positions are a (t=0, h, w)
    grid; text positions continue on all three axes after the largest
    spatial id.  Shared by the full forward and decode, so the caches
    agree."""
    P = cfg.vision_prefix_len
    side = max(int(P ** 0.5), 1)
    is_vis = idx < P
    zero = torch.zeros_like(idx)
    h_id = torch.where(is_vis, (idx % max(P, 1)) // side, zero)
    w_id = torch.where(is_vis, (idx % max(P, 1)) % side, zero)
    t_txt = idx - P + side  # text starts after the largest spatial id
    return torch.stack([torch.where(is_vis, zero, t_txt),
                        torch.where(is_vis, h_id, t_txt),
                        torch.where(is_vis, w_id, t_txt)], dim=-1)


def _build_positions(cfg: ArchConfig, batch: int, seq: int, device=None):
    """(positions (B, S), M-RoPE ids (B, S, 3) for the VLM family, else
    None)."""
    idx = torch.arange(seq, device=device)
    pos = idx[None, :].expand(batch, seq)
    if cfg.family != "vlm":
        return pos, None
    return pos, _mrope_ids(cfg, idx)[None].expand(batch, seq, 3)


def _embed(params, cfg: ArchConfig, tokens, patches=None):
    """The token embeddings; where ``patches`` (B, P, d) are given (the
    VLM's stub modality front end), they take the first P positions of the
    gathered copy (``params["embed"]`` is not written)."""
    x = params["embed"][tokens.long()]
    if patches is not None and cfg.vision_prefix_len:
        x[:, :patches.shape[1]] = patches.to(x.dtype)
    return x


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _run_layers(kind, stacked_p, x, cfg, *, n, mode, positions,
                positions_thw, caches, cache_pos, window, ring, emit_cache,
                moe_cap_len, use_kernels):
    """Apply one run of ``n`` layers in order.  Decode writes each layer's
    new key and value into the stacked ``caches`` in place (through the
    layer's views) and returns them.  Prefill writes its caches into one
    stacked buffer a leaf (allocated at the first layer), not stacked
    afterwards, so a long prefill holds its caches once."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out_caches = caches if mode == "decode" else None
    for i in range(n):
        x, new_c, a = B.block_forward(
            kind, _layer(stacked_p, i), x, cfg, mode=mode, positions=positions,
            positions_thw=positions_thw,
            cache=None if caches is None else _layer(caches, i),
            cache_pos=cache_pos, window=window, ring=ring,
            emit_cache=emit_cache, moe_cap_len=moe_cap_len,
            use_kernels=use_kernels)
        aux = aux + a
        if new_c is not None and mode != "decode":
            if out_caches is None:
                out_caches = {k: c.new_empty((n,) + tuple(c.shape))
                              for k, c in new_c.items()}
            for k, c in new_c.items():
                out_caches[k][i] = c
    return x, out_caches, aux


def forward_hidden(params, cfg: ArchConfig, tokens, *, patches=None,
                   caches=None, cache_pos=None, mode="full", window: int = 0,
                   ring: bool = False, emit_cache: bool = False,
                   moe_cap_len: int = 0, use_kernels: bool = True):
    """Core stack application.  Returns (hidden, new_caches, aux_loss, the
    sum over the layers).  ``use_kernels``: the full-sequence attention
    through the kernel.  Decode updates ``caches`` in place and returns
    them.  ``moe_cap_len``: the sequence length decode's MoE capacity is
    computed from (0 = the cache length); pin it to the teacher-forced
    length when the cache is allocated longer."""
    batch, seq = tokens.shape
    if mode == "decode":
        positions = cache_pos[:, None]
        thw = (_mrope_ids(cfg, cache_pos)[:, None, :]
               if cfg.family == "vlm" else None)
    else:
        positions, thw = _build_positions(cfg, batch, seq,
                                          device=tokens.device)
    x = _embed(params, cfg, tokens, patches)
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, n) in enumerate(layer_runs(cfg)):
        x, nc, aux = _run_layers(
            kind, params["runs"][i], x, cfg, n=n, mode=mode,
            positions=positions, positions_thw=thw,
            caches=caches[i] if caches is not None else None,
            cache_pos=cache_pos, window=window, ring=ring,
            emit_cache=emit_cache, moe_cap_len=moe_cap_len,
            use_kernels=use_kernels)
        new_caches.append(nc)
        aux_total = aux_total + aux
    _, norm_fn = make_norm(cfg.norm, cfg.d_model, x.dtype)
    x = norm_fn(params["final_norm"], x)
    return x, new_caches, aux_total


def lm_logits(params, cfg: ArchConfig, hidden):
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return hidden @ params["lm_head"]
