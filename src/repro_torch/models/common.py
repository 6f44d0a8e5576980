"""Shared model components of the port: init helpers, norms, rotary
embeddings, attention (full / sliding-window / cached decode) and MLP
blocks, plus the carry-over of parameters initialised by the JAX package.

Counterpart of ``src/repro/models/common.py``.  As there, the components
are functions over nested-dict parameter trees of tensors, with the
reference's parameter names.  The causal self-attention of a
full-sequence forward goes through ``kernels/ops.py::
sliding_window_attention``: the hand-written kernel when ``use_kernels``
is set, its plain version otherwise.

The reference's exact rewrites are module attributes with its names, read
at call time (``tests/test_torch_perf_toggles.py`` holds each mode to the
JAX package's same mode): ``GQA_IMPL`` ("repeat" | "grouped"),
``ATTN_IMPL`` ("naive" | "chunked") with ``ATTN_CHUNK``, and
``CACHE_UPDATE`` ("dus" | "onehot").  The port's cache default is "dus",
the in-place write, where the reference's is "onehot": both give the same
values, and a decode on the card should not rewrite its whole cache a
token.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def dense_init(d_in: int, d_out: int, generator: torch.Generator,
               dtype=torch.float32, scale: Optional[float] = None,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Truncated-normal fan-in init, matmul weight (d_in, d_out): a standard
    normal cut at ±2σ, times 1/√d_in.  Drawn on ``generator``'s device
    from it, so one seed gives the same weights whatever device a CPU
    generator's weights go to.  ``lead``: leading axes of a stack of such
    weights (one a layer), drawn at once."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.empty(*lead, d_in, d_out, dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale).to(dtype)


def embed_init(vocab: int, d: int, generator: torch.Generator,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.empty(vocab, d, dtype=torch.float32, device=generator.device)
    w.normal_(0.0, 1.0, generator=generator)
    return (w * 0.02).to(dtype)


def flatten_tree(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict/list tree — the JAX
    package's parameter pytrees as nn.Module parameter names
    (``{"mp": [{"prelu": {"a": ...}}]}`` -> ``"mp.0.prelu.a"``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_tree(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_tree(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


class ParamTree(torch.nn.Module):
    """A model's parameter tree (nested dicts and lists of tensors) as an
    ``nn.Module``, the form the GST train step trains (``parameters()``):
    each leaf becomes an ``nn.Parameter`` on the leaf's storage, named by
    its dotted path as ``flatten_tree`` names it, so ``load_jax_params``
    and the JAX package's tree paths agree.  ``tree`` is the same nesting
    over those parameters, what the model functions take."""

    def __init__(self, tree):
        super().__init__()
        self._seq = isinstance(tree, (list, tuple))
        self._keys = []
        for k, v in (enumerate(tree) if self._seq else tree.items()):
            name = str(k)
            if hasattr(torch.nn.Module, name):
                raise KeyError(f"parameter tree key {name!r} shadows an "
                               "nn.Module attribute")
            self._keys.append(name)
            if isinstance(v, (dict, list, tuple)):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, torch.nn.Parameter(
                    v, requires_grad=v.is_floating_point()))

    @property
    def tree(self):
        kids = [getattr(self, k) for k in self._keys]
        kids = [c.tree if isinstance(c, ParamTree) else c for c in kids]
        return kids if self._seq else dict(zip(self._keys, kids))


def load_jax_params(target, np_tree):
    """Fill ``target``'s parameters from the JAX package's parameter tree
    (nested dicts and lists of numpy arrays), matched by path name, in
    place.  ``target`` is an ``nn.Module`` (its named parameters) or a
    nested dict/list tree of tensors (the sequence models' parameters).
    The weight carry-over the parity tests use.  Raises when the names or
    the shapes of the two disagree; returns ``target``."""
    flat = dict(flatten_tree(np_tree))
    if isinstance(target, torch.nn.Module):
        params = dict(target.named_parameters())
    else:
        params = dict(flatten_tree(target))
    if set(flat) != set(params):
        raise KeyError(f"parameter names differ: only in the tree "
                       f"{sorted(set(flat) - set(params))}, only in the "
                       f"target {sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape {arr.shape} != target "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
    return target


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def layernorm_params(d: int, dtype=torch.float32, lead: Tuple[int, ...] = (),
                     device=None):
    return {"scale": torch.ones(*lead, d, dtype=dtype, device=device),
            "bias": torch.zeros(*lead, d, dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if p is not None and "scale" in p:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(dt)


def nonparam_ln(x, eps: float = 1e-5):
    """OLMo-style LayerNorm without learnable affine. [arXiv:2402.00838]"""
    return layernorm(None, x, eps)


def make_norm(kind: str, d: int, dtype=torch.float32, lead: Tuple[int, ...] = (),
              device=None):
    """Returns (params, apply_fn).  ``nonparam_ln`` carries an empty dict so
    the tree structure stays uniform across layer kinds; ``lead`` stacks
    the parameters of several layers."""
    if kind == "rmsnorm":
        return ({"scale": torch.ones(*lead, d, dtype=dtype, device=device)},
                rmsnorm)
    if kind == "layernorm":
        return layernorm_params(d, dtype, lead, device), layernorm
    if kind == "nonparam_ln":
        return {}, lambda p, x: nonparam_ln(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x, ang):
    """x (..., seq, heads, D) rotated by ang (..., seq, D/2), in f32."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :]  # (..., seq, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x, positions_thw, theta: float, sections: Tuple[int, ...]):
    """Qwen2-VL M-RoPE. [arXiv:2409.12191]

    x: (B, S, H, D); positions_thw: (B, S, 3) temporal/height/width position
    ids.  ``sections`` splits the D/2 rotary frequencies into (t, h, w)
    groups; each group rotates by its own position id.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to D/2 = {half}")
    inv = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    # per-frequency position: section 0 -> t, 1 -> h, 2 -> w (made on the
    # host: a fake tensor of the dry run cannot size a repeat by its data)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (half,)
    pos = positions_thw.float()[..., sec_id]  # (B, S, half)
    return _rotate(x, pos * inv)


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, device=None):
    """Whisper-style sinusoidal embeddings, (seq, d): sin then cos of
    pos / 10000^(i / max(d/2 - 1, 1)), i < d/2."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / max(d // 2 - 1, 1)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


# Decode-cache write:
#   "dus"    - the new entry scattered into its slot, in place (the
#              reference's vmapped dynamic_update_slice under donation);
#   "onehot" - cache·(1 − oh) + oh·new, a new cache: two reads and a write
#              of the whole cache (the reference's default).
CACHE_UPDATE = "dus"


def write_cache(cache, new, idx):
    """cache: (B, C, ...); new: (B, 1, ...); idx: (B,) target slot.
    Returns the cache with ``new`` in slot ``idx`` of each row: ``cache``
    itself, written in place, under "dus"; a new tensor under "onehot".
    For finite values both give the same bits."""
    if CACHE_UPDATE == "onehot":
        # the reference's jax.nn.one_hot: a comparison with the slot index
        slots = torch.arange(cache.shape[1], device=cache.device)
        oh = (slots[None, :] == idx[:, None]).to(cache.dtype)  # (B, C)
        oh = oh.reshape(oh.shape + (1,) * (cache.dim() - 2))
        return cache * (1.0 - oh) + oh * new
    at = idx.long().reshape((-1, 1) + (1,) * (cache.dim() - 2))
    # a scatter along the slot axis keeps the batch and head axes free to
    # be sharded (a DTensor cache of the dry run, launch/specs.py)
    return cache.scatter_(1, at.expand(new.shape), new)


def attn_params(generator: torch.Generator, d_model: int, num_heads: int,
                num_kv: int, head_dim: int, dtype=torch.float32,
                lead: Tuple[int, ...] = ()):
    return {
        "wq": dense_init(d_model, num_heads * head_dim, generator, dtype,
                         lead=lead),
        "wk": dense_init(d_model, num_kv * head_dim, generator, dtype,
                         lead=lead),
        "wv": dense_init(d_model, num_kv * head_dim, generator, dtype,
                         lead=lead),
        "wo": dense_init(num_heads * head_dim, d_model, generator, dtype,
                         scale=1.0 / math.sqrt(num_heads * head_dim),
                         lead=lead),
    }


def _repeat_kv(k, num_heads: int):
    """(B, S, KV, D) -> (B, S, H, D) by repeating kv groups (head h reads
    kv head h // (H // KV), as ``jnp.repeat``)."""
    num_kv = k.shape[-2]
    if num_kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // num_kv, dim=-2)


# GQA attention:
#   "repeat"  - K/V repeated to H heads (at decode a re-read of the cache
#               H/KV times);
#   "grouped" - einsums against the KV heads with a query-group axis: the
#               same function, K/V never repeated.  Taken where KV != H.
GQA_IMPL = "repeat"


def _grouped_attn(q, k, v, mask):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) -> (B, Sq, H, D); query head
    h reads KV head h // (H // KV).  ``mask``: bool, broadcastable to the
    f32 logits (B, KV, G, Sq, Sk), False where a key is masked.

    It is a torch function, so a torch function mode may run it its own
    way: the dry run runs it on each device's batch rows and query heads
    against the KV heads they read (``launch/dryrun.py``), where the
    unflatten of H sharded heads into (KV, G) cannot keep the shard."""
    if has_torch_function((q, k, v, mask)):
        return handle_torch_function(_grouped_attn, (q, k, v, mask), q, k,
                                     v, mask)
    return grouped_einsums(q, k, v, mask)


def grouped_einsums(q, k, v, mask):
    """The einsums of ``_grouped_attn`` (see there), as plain ops."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqkgd,bckd->bkgqc", qg, k).float() * scale
    probs = torch.softmax(torch.where(mask, logits, -1e30),
                          dim=-1).to(q.dtype)
    out = torch.einsum("bkgqc,bckd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def sdpa(q, k, v, *, causal: bool, window: int = 0):
    """Reference scaled-dot-product attention with optional causal +
    sliding-window masking.  q: (B, Sq, H, D), k/v: (B, Sk, KV, D).
    ``window``: if > 0, keys older than ``window`` positions are masked.
    Materialises the (B, H, Sq, Sk) logits; under ``GQA_IMPL`` "grouped"
    with KV != H, the grouped form (``_grouped_attn``).  (The reference's
    decode-only ``q_offset`` and ``kv_valid_len`` have no caller here: the
    port's decode masks its cache itself, as the reference's does.)
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if GQA_IMPL == "grouped" and k.shape[2] != H:
        return _grouped_attn(q, k, v, mask[None, None, None])
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# Prefill attention without the kernel:
#   "naive"   - the (B, H, S, S) logits at once;
#   "chunked" - online softmax over ATTN_CHUNK keys at a time (peak
#               O(S·chunk)), where S > ATTN_CHUNK and S % ATTN_CHUNK == 0.
ATTN_IMPL = "naive"
ATTN_CHUNK = 1024


def chunked_causal_attention(q, k, v, *, window: int = 0, chunk: int = 1024):
    """Online-softmax causal (optionally windowed) attention over KV chunks,
    peak activation O(S·chunk) instead of O(S²).  q/k/v: (B, S, H|KV, D)
    -> (B, S, H, D); like the reference, it covers S // chunk chunks."""
    B, S, H, D = q.shape
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scale = 1.0 / math.sqrt(D)
    q_pos = torch.arange(S, device=q.device)
    qf = q.float()
    m = torch.full((B, H, S, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    for i in range(S // chunk):
        ks = k[:, i * chunk:(i + 1) * chunk].float()
        vs = v[:, i * chunk:(i + 1) * chunk].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, ks) * scale
        k_pos = i * chunk + torch.arange(chunk, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.where(mask[None, None], logits, -1e30)
        m_cur = torch.amax(logits, dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha.transpose(1, 2) + torch.einsum(
            "bhqk,bkhd->bqhd", p, vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)
    return out.to(q.dtype)


def _rotate_qk(q, k, positions, rope_theta, mrope_sections, positions_thw):
    """q and k rotated by RoPE at ``positions``, or by M-RoPE at
    ``positions_thw`` where ``mrope_sections`` is set."""
    if mrope_sections:
        return (apply_mrope(q, positions_thw, rope_theta, mrope_sections),
                apply_mrope(k, positions_thw, rope_theta, mrope_sections))
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta))


def attn_qkv(p, x, *, num_heads: int, num_kv: int, head_dim: int, positions,
             rope_theta: float, mrope_sections: Tuple[int, ...] = (),
             positions_thw=None, kv_override=None):
    """The projections of ``attn_forward``, rotated: (q (B, S, H, D),
    k, v (B, S, KV, D)).  Cross-attention (``kv_override``) rotates q
    alone, by plain RoPE, and only where ``rope_theta`` is set."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, num_heads, head_dim)
    if kv_override is None:
        k = (x @ p["wk"]).reshape(B, S, num_kv, head_dim)
        v = (x @ p["wv"]).reshape(B, S, num_kv, head_dim)
        if rope_theta:
            q, k = _rotate_qk(q, k, positions, rope_theta, mrope_sections,
                              positions_thw)
    else:
        k, v = kv_override
        if rope_theta:
            q = apply_rope(q, positions, rope_theta)
    return q, k, v


def attn_forward(p, x, *, num_heads: int, num_kv: int, head_dim: int,
                 positions, rope_theta: float, causal: bool = True,
                 window: int = 0, mrope_sections: Tuple[int, ...] = (),
                 positions_thw=None, kv_override=None,
                 use_kernels: bool = True):
    """Full attention over a sequence (train / prefill).  Returns (out,
    (k, v)) so the prefill path can emit the cache.  ``kv_override``: (k, v)
    from an encoder for cross-attention.

    Causal self-attention with ``use_kernels`` runs the kernel
    (``ops.sliding_window_attention``, the window S where ``window`` is
    0: the op takes its window literally) under every switch: it is the
    chunked schedule, K/V read once a query group.  Without it: under
    ``ATTN_IMPL`` "chunked", where S > ATTN_CHUNK and S % ATTN_CHUNK == 0,
    ``chunked_causal_attention``; else under ``GQA_IMPL`` "grouped" with
    KV != H, ``sdpa``'s grouped form; else the kernel's plain version
    (``ref.swa_attention_ref``).  Cross- and non-causal attention run
    ``sdpa``."""
    B, S, _ = x.shape
    q, k, v = attn_qkv(p, x, num_heads=num_heads, num_kv=num_kv,
                       head_dim=head_dim, positions=positions,
                       rope_theta=rope_theta, mrope_sections=mrope_sections,
                       positions_thw=positions_thw, kv_override=kv_override)
    if not causal or kv_override is not None:
        out = sdpa(q, k, v, causal=False, window=window)
    elif (not use_kernels and ATTN_IMPL == "chunked" and S > ATTN_CHUNK
          and S % ATTN_CHUNK == 0):
        out = chunked_causal_attention(q, k, v, window=window,
                                       chunk=ATTN_CHUNK)
    elif not use_kernels and GQA_IMPL == "grouped" and num_kv != num_heads:
        out = sdpa(q, k, v, causal=True, window=window)
    else:
        out = ops.sliding_window_attention(
            q, k, v, window=window if window > 0 else S,
            use_kernels=use_kernels)
    out = out.reshape(B, S, num_heads * head_dim) @ p["wo"]
    return out, (k, v)


def attn_decode(p, x, cache_k, cache_v, cache_pos, *, num_heads: int,
                num_kv: int, head_dim: int, rope_theta: float,
                ring: bool = False, mrope_sections: Tuple[int, ...] = (),
                positions_thw=None):
    """One-token cached decode.  x: (B, 1, d); cache_k/v: (B, C, KV, D),
    written by ``write_cache`` (in place under "dus") and returned, the
    attention over them grouped under ``GQA_IMPL`` "grouped" where
    KV != H; cache_pos: (B,)
    absolute position of the new token; positions_thw: (B, 1, 3) its
    M-RoPE ids where ``mrope_sections`` is set.

    ``ring``: cache is a ring buffer of size C: the write index is
    ``cache_pos % C`` and all C slots attend once full (the window is the
    ring's size; the reference's ``window`` argument here is unused).
    Keys are stored post-RoPE so ring eviction needs no re-rotation.
    Plain torch: the reference has no kernel here.
    """
    B = x.shape[0]
    C = cache_k.shape[1]
    q = (x @ p["wq"]).reshape(B, 1, num_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, 1, num_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, 1, num_kv, head_dim)
    if rope_theta:
        q, k = _rotate_qk(q, k, cache_pos[:, None], rope_theta,
                          mrope_sections, positions_thw)
    write_idx = (cache_pos % C) if ring else torch.clamp(cache_pos, max=C - 1)
    cache_k = write_cache(cache_k, k, write_idx)
    cache_v = write_cache(cache_v, v, write_idx)
    valid = torch.clamp(cache_pos + 1, max=C)  # (B,)
    k_pos = torch.arange(C, device=x.device)[None, :]  # slot index
    vmask = k_pos < valid[:, None]  # (B, C)
    if GQA_IMPL == "grouped" and num_kv != num_heads:
        out = _grouped_attn(q, cache_k, cache_v,
                            vmask[:, None, None, None, :])
    else:
        kh = _repeat_kv(cache_k, num_heads)
        vh = _repeat_kv(cache_v, num_heads)
        scale = 1.0 / math.sqrt(head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kh).float() * scale
        logits = torch.where(vmask[:, None, None, :], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    out = out.reshape(B, 1, num_heads * head_dim) @ p["wo"]
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP / FFN
# ---------------------------------------------------------------------------


def mlp_params(generator: torch.Generator, d_model: int, d_ff: int, act: str,
               dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """The gated (SwiGLU) MLP for ``silu``/``swiglu``, else the plain
    two-matrix MLP (``gelu``, ``relu_sq``)."""
    p = {"w_in": dense_init(d_model, d_ff, generator, dtype, lead=lead)}
    if act in ("silu", "swiglu"):
        p["w_gate"] = dense_init(d_model, d_ff, generator, dtype, lead=lead)
    p["w_out"] = dense_init(d_ff, d_model, generator, dtype,
                            scale=1.0 / math.sqrt(d_ff), lead=lead)
    return p


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_forward(p, x, act: str):
    if act in ("silu", "swiglu"):
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    if act == "gelu":
        return gelu(x @ p["w_in"]) @ p["w_out"]
    if act == "relu_sq":
        return torch.square(torch.relu(x @ p["w_in"])) @ p["w_out"]
    raise ValueError(act)
