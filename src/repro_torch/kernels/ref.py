"""Plain-torch versions of the port's kernels: the CPU path of each wrapper
and the yardstick the kernels are held against on the card.

Counterpart of ``src/repro/kernels/ref.py``, plus the wire-format pack and
unpack of ``src/repro/kernels/quant.py:64-130`` (``quantize_rows_ref``,
``dequantize_rows_ref``) and ``swa_attention_ref`` with GQA heads.
"""
from __future__ import annotations

import math

import torch


def segment_spmm_ref(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                     w: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Weighted neighbor scatter-add:  out[v] = Σ_{e: dst_e = v} w_e · h[src_e].

    h: (m, d); src/dst: (e,) int32 or int64; w: (e,) float — padding edges
    carry w=0.  Summed in f32, returned in h's dtype.
    """
    return segment_spmm_batched_ref(h[None], src[None], dst[None], w[None],
                                    num_nodes)[0]


def segment_spmm_batched_ref(h: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor, w: torch.Tensor,
                             num_nodes: int = None) -> torch.Tensor:
    """Batched: out[n, v] = Σ_{e: dst[n,e]=v} w[n,e] · h[n, src[n,e]].

    h: (N, m, d); src/dst: (N, e) int32 or int64; w: (N, e) float.
    Gather, multiply, ``index_add_`` over the flattened (N·m) node axis, in
    f32; the result is cast to h's dtype.  An edge whose src or dst lies
    outside the segment adds nothing, as the reference's Pallas kernel
    (its one-hot rows are zero there) and the CUDA kernel skip it: it is
    sent to a spare row that is dropped, so nothing waits on the device.
    """
    N, m, d = h.shape
    num_nodes = m if num_nodes is None else num_nodes
    src, dst = src.long(), dst.long()
    ok = (src >= 0) & (src < m) & (dst >= 0) & (dst < num_nodes)
    offs = torch.arange(N, device=h.device, dtype=torch.int64)[:, None]
    src_g = (torch.where(ok, src, 0) + offs * m).reshape(-1)
    dst_g = torch.where(ok, dst + offs * num_nodes, N * num_nodes).reshape(-1)
    msg = h.float().reshape(N * m, d)[src_g] * w.float().reshape(-1, 1)
    out = torch.zeros(N * num_nodes + 1, d, dtype=torch.float32,
                      device=h.device)
    out.index_add_(0, dst_g, msg)
    return out[:-1].reshape(N, num_nodes, d).to(h.dtype)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[n, idx[n, e]] for x (N, m, d), idx (N, e), as the reference's
    ``jnp.take_along_axis`` gives it: a negative index counts once from
    the end, and an index still outside [0, m) reads NaN."""
    m = x.shape[1]
    i = idx.long()
    i = torch.where(i < 0, i + m, i)
    ok = (i >= 0) & (i < m)
    rows = torch.gather(x, 1, torch.where(ok, i, 0)[..., None].expand(
        -1, -1, x.shape[-1]))
    return torch.where(ok[..., None], rows, float("nan"))


def sed_eta(seg_valid: torch.Tensor, fresh_mask: torch.Tensor,
            drop_mask: torch.Tensor, keep_prob: float, num_sampled: int,
            ages: torch.Tensor = None, decay: float = 0.0):
    """The Eq.-1 η weights from the three masks: (eta (B, J), J_i (B, 1)).

    Shared by ``sed_pool_ref`` and the CPU backward of ``sed_pool``, and
    mirrored operation for operation by ``csrc/sed_pool.cu``, which
    writes it out for the backward on the card.  With
    ``ages`` (B, J) and λ = ``decay`` > 0 the STALE branch is further
    weighted by exp(-λ·age); λ = 0 (or no ages) is the unaged formula.
    """
    valid = seg_valid.float()
    fresh = fresh_mask.float()
    drop = drop_mask.float()
    J_i = torch.sum(valid, dim=-1, keepdim=True)
    eta_fresh = keep_prob + (1.0 - keep_prob) * J_i / float(num_sampled)
    stale = valid * (1.0 - fresh)
    stale_term = stale * (1.0 - drop)
    if ages is not None and decay > 0.0:
        stale_term = stale_term * torch.exp(-decay * ages.float())
    eta = (fresh * eta_fresh + stale_term) * valid
    return eta, J_i


def sed_pool_ref(h: torch.Tensor, seg_valid: torch.Tensor,
                 fresh_mask: torch.Tensor, drop_mask: torch.Tensor,
                 keep_prob: float, num_sampled: int, agg: str = "mean",
                 ages: torch.Tensor = None, decay: float = 0.0) -> torch.Tensor:
    """Fused SED η-weighting (Eq. 1) + segment aggregation ⊕.

    h: (B, J, d); masks (and ``ages``): (B, J) -> (B, d).  Matches
    core.segment.sed_weights + core.segment.aggregate composed (given the
    same drop draw).
    """
    eta, J_i = sed_eta(seg_valid, fresh_mask, drop_mask, keep_prob,
                       num_sampled, ages, decay)
    s = torch.sum(h * eta[..., None].to(h.dtype), dim=1)
    if agg == "sum":
        return s
    return s / torch.clamp(J_i, min=1.0).to(s.dtype)


# ---------------------------------------------------------------------------
# compressed wire format (src/repro/kernels/quant.py:64-130)
#
# torch has no usable uint32 arithmetic: the random bits travel as an int32
# tensor holding the uint32 bit pattern, and the bit math below runs in
# int64 masked to 32 bits (``>>`` on int32 would be arithmetic, not
# logical).  Every operation is the reference's, in its order, so given the
# same bits the result is the JAX package's to the bit.
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
# Python scalars: an f32 tensor times a Python float multiplies by the
# float rounded to f32 (torch's opmath for f32 is f32), as JAX's weak-typed
# scalars do; 2^-24 is exact in f32.  A 0-dim tensor on the CPU would be
# a copy to the card, which waits for it, at every call.
_INV127 = 1.0 / 127.0
_TWO_M24 = 2.0 ** -24
# the quiet NaNs of the wire format: bf16 (sign | 0x7FC0) and the int8
# scale's f32 0x7FC00000 (a Python NaN is that pattern as an f32)
_BF16_QNAN = 0x7FC0
_F32_QNAN = float("nan")


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its uint32 value, as int64."""
    return bits.to(torch.int64) & _U32


def _as_bf16(hi: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns held as int64 in [0, 65535] -> a bf16 tensor."""
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi).to(torch.int16)
    return hi.view(torch.bfloat16)


def _bf16_quiet_nan(hi: torch.Tensor, is_nan: torch.Tensor) -> torch.Tensor:
    """Where ``is_nan``, the bf16 pattern becomes the quiet NaN 0x7FC0 with
    the sign of ``hi`` kept: what XLA's f32 -> bf16 conversion gives for
    any NaN, so the JAX package's wire format carries no other NaN."""
    return torch.where(is_nan, (hi & 0x8000) | _BF16_QNAN, hi)


def _bf16_nearest(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 rounded to nearest even.  A NaN is made explicit on the
    bit pattern: ``Tensor.to`` gives 0xFFFF for one on the CPU and another
    pattern on CUDA, JAX gives 0x7FC0 with x's sign."""
    u = _u32(x.contiguous().view(torch.int32))
    rne = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    nan = torch.isnan(x)
    return _as_bf16(_bf16_quiet_nan(torch.where(nan, u >> 16, rne), nan))


def _bf16_stochastic(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 by adding the low 16 random bits below the bf16 mantissa
    boundary and truncating: ``(u + (bits & 0xFFFF)) & 0xFFFF0000`` on the
    f32 bit pattern u, mod 2^32.  The kept high half is the bf16 value,
    but for a NaN: the reference converts the truncated f32 to bf16, which
    makes any NaN 0x7FC0 with its sign."""
    u = _u32(x.contiguous().view(torch.int32))
    hi = (((u + (_u32(bits) & 0xFFFF)) & _U32) >> 16)          # [0, 65535]
    is_nan = ((hi & 0x7F80) == 0x7F80) & ((hi & 0x7F) != 0)
    return _as_bf16(_bf16_quiet_nan(hi, is_nan))


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> uniform [0, 1) f32 from their high 24 bits."""
    return (_u32(bits) >> 8).to(torch.float32) * _TWO_M24


def _int8_quantize(x: torch.Tensor, bits=None):
    """x (r, n) f32 -> (values (r, n) int8, scale (r, 1) f32).  ``bits``
    None rounds to nearest even (read path), else stochastically.

    NaN and inf as the reference gives them: a row holding a NaN has a NaN
    scale (the quiet NaN 0x7FC00000, as JAX's is for rows of quiet NaNs;
    the device's arithmetic would give another pattern on CUDA), is
    divided by 1 and packs 0 where x is NaN; a row holding ±inf has scale
    inf and packs 0 everywhere (x / inf is ±0, inf / inf NaN).  The NaN to
    0 of the cast is explicit, not left to ``Tensor.to``."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = amax * _INV127
    scale = torch.where(torch.isnan(scale), _F32_QNAN, scale)
    v = x / torch.where(scale > 0, scale, torch.ones_like(scale))
    if bits is None:
        q = torch.round(v)                       # half to even, as jnp.round
    else:
        lo = torch.floor(v)
        q = lo + (_uniform01(bits) < (v - lo)).to(torch.float32)
    q = torch.clamp(q, -127.0, 127.0)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int8), scale


def quantize_rows_ref(x: torch.Tensor, dtype: str, rand_bits=None):
    """x (R, ...) f32 -> wire parts: (values,) for bf16, (values int8,
    scale (R,) f32) for int8.  ``rand_bits``: int32 of x's shape holding
    uint32 random bits, for stochastic rounding (the write path); None
    rounds to nearest even (the read path)."""
    shape = x.shape
    x2 = x.reshape(shape[0], math.prod(shape[1:]))
    bits = None if rand_bits is None else rand_bits.reshape(x2.shape)
    if dtype == "bf16":
        if bits is None:
            return (_bf16_nearest(x2).reshape(shape),)
        return (_bf16_stochastic(x2, bits).reshape(shape),)
    if dtype == "int8":
        q, scale = _int8_quantize(x2, bits)
        return q.reshape(shape), scale[:, 0]
    raise ValueError(f"quantize dtype {dtype!r} not in ('bf16', 'int8')")


def dequantize_rows_ref(parts, dtype: str) -> torch.Tensor:
    """Inverse of ``quantize_rows_ref``: wire parts -> f32 (R, ...)."""
    if dtype == "bf16":
        (v,) = parts
        return v.to(torch.float32)
    if dtype == "int8":
        v, scale = parts
        return v.to(torch.float32) * scale.reshape((-1,) + (1,) * (v.dim() - 1))
    raise ValueError(f"dequantize dtype {dtype!r} not in ('bf16', 'int8')")


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int) -> torch.Tensor:
    """Causal sliding-window attention oracle (``src/repro/kernels/ref.py:
    73-87``): key j is visible to query i iff  i - window < j <= i.

    q: (B, S, H, D); k/v: (B, S, KV, D) with KV dividing H, expanded as the
    models' ``_repeat_kv`` does (head h reads KV head h // (H // KV)); with
    KV == H it is the reference's oracle.  ``window`` is taken literally,
    as the reference takes it (0 masks every key, and the softmax over the
    all -1e30 row is then uniform).  Materialises the (B, H, S, S) logits.
    """
    B, S, H, D = q.shape
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
