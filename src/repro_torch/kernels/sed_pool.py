"""Fused Stale-Embedding-Dropout weighting + segment pooling (Eq. 1 and ⊕).

    out[b] = Σ_j η[b, j] · h[b, j]   (÷ max(J_b, 1) for agg="mean")

with η built from the valid, fresh and drop masks (and, aged, the
per-segment age) as ``ref.sed_eta`` builds it.  The wrapper of the
hand-written CUDA kernels in ``csrc/sed_pool.cu``, which replace the TPU
kernels ``src/repro/kernels/sed_pool.py::_sed_pool_kernel`` (:27) and
``::_sed_pool_aged_kernel`` (:40); see the source's note for the design and
its bound.  ``plan`` picks the launch geometry, and with it the order in
which the kernel sums.

Device rule: a CPU tensor goes to the plain version (``ref.sed_pool_ref``);
a CUDA tensor launches the kernel or raises.  Nothing falls back.
``LAUNCHES`` counts each kernel's launches, one per launch.

Each pooling is a ``torch.autograd.Function``, the counterpart of the
``custom_vjp``s at ``sed_pool.py:91-118,161-191``: dh = g·η (÷ max(J_b, 1)
for mean), in plain torch as the reference computes it in jnp; the masks
and the ages get no gradient.  On the card the forward launch also writes
η and J_b when h needs a gradient, and the backward reads them
(``dh_from_eta``); on the CPU the backward rebuilds them with
``ref.sed_eta``, as the reference's VJP does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.counts import LaunchCounts

KERNEL = "sed_pool"
KERNEL_AGED = "sed_pool_aged"
LAUNCHES = LaunchCounts((KERNEL, KERNEL_AGED))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/sed_pool.cu's kMaxThreads and kChunk
MAX_THREADS = 256
CHUNK = 8


class Plan(NamedTuple):
    """A launch's geometry: a thread loads ``vec_bytes`` of a row of h at
    once (``vec_bytes // itemsize`` columns), ``tx`` vectors (a power of
    two, at most 32) lie across a block, ``ty`` j-lanes (a power of two)
    split each row's J, and ``col_tiles`` blocks cover d.  j-lane i sums
    j = i, i + ty, i + 2 ty, ... in order; the ty partials then join by
    adjacent pairs, ((p0 + p1) + (p2 + p3)) + ..."""
    vec_bytes: int
    tx: int
    ty: int
    col_tiles: int


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(J: int, d: int, itemsize: int, address: int) -> Plan:
    """The geometry for h (B, J, d) of ``itemsize`` bytes at ``address``:
    the widest load (16, 8, 4 bytes, or 2 for bf16) that every row start
    keeps aligned, a row's vectors rounded up to a power of two (at most 32)
    across a block, and the fewest j-lanes that hold a row's J in one chunk
    of ``CHUNK`` a thread, at most ``MAX_THREADS`` threads a block."""
    vec_bytes = next(v for v in (16, 8, 4, 2) if v >= itemsize
                     and (d * itemsize) % v == 0 and address % v == 0)
    vectors = -(-d // (vec_bytes // itemsize))
    tx = min(32, _pow2_ceil(vectors))
    ty_cap = 1 << ((MAX_THREADS // tx).bit_length() - 1)
    ty = min(ty_cap, _pow2_ceil(-(-J // CHUNK)))
    return Plan(vec_bytes, tx, ty, max(1, -(-vectors // tx)))


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels._build import load

    lib = load("sed_pool")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sed_pool_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     f, f, f, i, i, p]
        lib.sed_pool_fwd.restype = i
        lib.sed_pool_aged_fwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                          i, i, i, f, f, f, f, i, i, p]
        lib.sed_pool_aged_fwd.restype = i
        lib.sed_pool_error_string.argtypes = [i]
        lib.sed_pool_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(h, masks):
    if h.dim() != 3:
        raise ValueError(f"want h (B, J, d), got {tuple(h.shape)}")
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be float32 or bfloat16, not {h.dtype}")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    for name, t in masks.items():
        if t.shape != h.shape[:2]:
            raise ValueError(f"{name} must be (B, J) = {tuple(h.shape[:2])}, "
                             f"not {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg, decay,
            residuals=False):
    """One launch on CUDA tensors: the aged kernel where ``ages`` is given.
    Returns out, or (out, η (B, J) f32, J_b (B, 1) f32) with ``residuals``."""
    masks = {"seg_valid": valid, "fresh_mask": fresh, "drop_mask": drop}
    if ages is not None:
        masks["ages"] = ages
    _check(h, masks)
    if agg not in ("mean", "sum"):
        raise ValueError(f"agg must be 'mean' or 'sum', not {agg!r}")
    B, J, d = h.shape
    out = torch.empty((B, d), dtype=h.dtype, device=h.device)
    eta = jb = None
    if residuals:
        eta = torch.empty((B, J), dtype=torch.float32, device=h.device)
        jb = torch.empty((B, 1), dtype=torch.float32, device=h.device)
    if B == 0:
        return (out, eta, jb) if residuals else out
    lib = _lib()
    geometry = plan(J, d, h.element_size(), h.data_ptr())
    # 1/S in f32, as PyTorch divides a CUDA tensor by a Python scalar
    inv_sampled = float(np.float32(1.0) / np.float32(num_sampled))
    scalars = (float(keep_prob), float(1.0 - keep_prob), inv_sampled)
    outs = (out.data_ptr(), None if eta is None else eta.data_ptr(),
            None if jb is None else jb.data_ptr())
    common = (B, J, d, *geometry, *scalars)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if ages is None:
            err = lib.sed_pool_fwd(
                h.data_ptr(), valid.data_ptr(), fresh.data_ptr(),
                drop.data_ptr(), *outs, *common, int(agg == "mean"),
                _DTYPES[h.dtype], stream)
        else:
            err = lib.sed_pool_aged_fwd(
                h.data_ptr(), valid.data_ptr(), fresh.data_ptr(),
                drop.data_ptr(), ages.data_ptr(), *outs, *common,
                float(-decay), int(agg == "mean"), _DTYPES[h.dtype], stream)
    if err != 0:
        raise RuntimeError("sed_pool launch failed: "
                           + lib.sed_pool_error_string(err).decode())
    LAUNCHES.add(KERNEL if ages is None else KERNEL_AGED)
    return (out, eta, jb) if residuals else out


def _pool(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg, decay):
    if h.device.type == "cpu":
        return ref.sed_pool_ref(h, valid, fresh, drop, keep_prob, num_sampled,
                                agg, ages, decay)
    if h.device.type != "cuda":
        raise ValueError(f"sed_pool runs on cpu or cuda, not {h.device}")
    return _launch(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg,
                   decay)


def dh_from_eta(g, eta, J_b, agg, dtype):
    """The pooling's VJP from its weights: dh = g·η, g ÷ max(J_b, 1) first
    for mean, as the reference's ``_sed_bwd`` orders it.  g (B, d), η
    (B, J) f32, J_b (B, 1) f32 -> dh (B, J, d) in ``dtype``."""
    g = g.float()
    if agg == "mean":
        g = g / torch.clamp(J_b, min=1.0)
    return (g[:, None, :] * eta[..., None]).to(dtype)


class _SedPool(torch.autograd.Function):
    """``ages`` None: the unaged kernel; else the aged one at λ = decay."""

    @staticmethod
    def forward(ctx, h, valid, fresh, drop, ages, keep_prob, num_sampled,
                agg, decay):
        ctx.args = (keep_prob, num_sampled, agg, decay, h.dtype)
        if h.device.type == "cuda" and ctx.needs_input_grad[0]:
            out, eta, J_b = _launch(h, valid, fresh, drop, ages, keep_prob,
                                    num_sampled, agg, decay, residuals=True)
            ctx.save_for_backward(eta, J_b)
            ctx.from_kernel = True
            return out
        ctx.save_for_backward(valid, fresh, drop, ages)
        ctx.from_kernel = False
        return _pool(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg,
                     decay)

    @staticmethod
    def backward(ctx, g):
        keep_prob, num_sampled, agg, decay, dtype = ctx.args
        if ctx.from_kernel:
            eta, J_b = ctx.saved_tensors
        else:
            valid, fresh, drop, ages = ctx.saved_tensors
            eta, J_b = ref.sed_eta(valid, fresh, drop, keep_prob, num_sampled,
                                   ages, decay)
        return (dh_from_eta(g, eta, J_b, agg, dtype),) + (None,) * 8


def sed_pool(h: torch.Tensor, seg_valid: torch.Tensor,
             fresh_mask: torch.Tensor, drop_mask: torch.Tensor, *,
             keep_prob: float, num_sampled: int, agg: str = "mean",
             ages: torch.Tensor = None, decay: float = 0.0) -> torch.Tensor:
    """h: (B, J, d); masks: (B, J) float32 -> (B, d) pooled graph embedding.

    One kernel launch on CUDA; differentiable in h.  ``ages``/``decay``:
    optional (B, J) float32 age-in-steps and λ of the staleness-decayed η.
    λ = 0 (or no ages) runs the unaged kernel, where ``sed_pool.py:208``
    dispatches the unaged Pallas kernel.
    """
    if ages is not None and decay > 0.0:
        return _SedPool.apply(h, seg_valid, fresh_mask, drop_mask, ages,
                              keep_prob, num_sampled, agg, decay)
    return _SedPool.apply(h, seg_valid, fresh_mask, drop_mask, None,
                          keep_prob, num_sampled, agg, 0.0)
