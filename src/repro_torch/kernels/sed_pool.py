"""Fused Stale-Embedding-Dropout weighting + segment pooling (Eq. 1 and ⊕).

    out[b] = Σ_j η[b, j] · h[b, j]   (÷ max(J_b, 1) for agg="mean")

with η built from the valid, fresh and drop masks (and, aged, the
per-segment age) as ``ref.sed_eta`` builds it.  The wrapper of the
hand-written CUDA kernels in ``csrc/sed_pool.cu``, which replace the TPU
kernels ``src/repro/kernels/sed_pool.py::_sed_pool_kernel`` (:27) and
``::_sed_pool_aged_kernel`` (:40); see the source's note for the design and
its bound.

Device rule: a CPU tensor goes to the plain version (``ref.sed_pool_ref``);
a CUDA tensor launches the kernel or raises.  Nothing falls back.
``LAUNCHES`` counts each kernel's launches, one per launch.

Each pooling is a ``torch.autograd.Function``, the counterpart of the
``custom_vjp``s at ``sed_pool.py:91-118,161-191``: dh = g·η (÷ max(J_b, 1)
for mean), in plain torch on both devices as the reference computes it in
jnp; the masks and the ages get no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

KERNEL = "sed_pool"
KERNEL_AGED = "sed_pool_aged"
LAUNCHES = {KERNEL: 0, KERNEL_AGED: 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels._build import load

    lib = load("sed_pool")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sed_pool_fwd.argtypes = [p, p, p, p, p, i, i, i, f, f, f, i, i, p]
        lib.sed_pool_fwd.restype = i
        lib.sed_pool_aged_fwd.argtypes = [p, p, p, p, p, p, i, i, i, f, f, f,
                                          f, i, i, p]
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


def _launch(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg, decay):
    """One launch on CUDA tensors: the aged kernel where ``ages`` is given."""
    masks = {"seg_valid": valid, "fresh_mask": fresh, "drop_mask": drop}
    if ages is not None:
        masks["ages"] = ages
    _check(h, masks)
    if agg not in ("mean", "sum"):
        raise ValueError(f"agg must be 'mean' or 'sum', not {agg!r}")
    B, J, d = h.shape
    out = torch.empty((B, d), dtype=h.dtype, device=h.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    scalars = (float(keep_prob), float(1.0 - keep_prob), float(num_sampled))
    common = (B, J, d, *scalars)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if ages is None:
            err = lib.sed_pool_fwd(
                h.data_ptr(), valid.data_ptr(), fresh.data_ptr(),
                drop.data_ptr(), out.data_ptr(), *common, int(agg == "mean"),
                _DTYPES[h.dtype], stream)
        else:
            err = lib.sed_pool_aged_fwd(
                h.data_ptr(), valid.data_ptr(), fresh.data_ptr(),
                drop.data_ptr(), ages.data_ptr(), out.data_ptr(), *common,
                float(-decay), int(agg == "mean"), _DTYPES[h.dtype], stream)
    if err != 0:
        raise RuntimeError("sed_pool launch failed: "
                           + lib.sed_pool_error_string(err).decode())
    LAUNCHES[KERNEL if ages is None else KERNEL_AGED] += 1
    return out


def _pool(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg, decay):
    if h.device.type == "cpu":
        return ref.sed_pool_ref(h, valid, fresh, drop, keep_prob, num_sampled,
                                agg, ages, decay)
    if h.device.type != "cuda":
        raise ValueError(f"sed_pool runs on cpu or cuda, not {h.device}")
    return _launch(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg,
                   decay)


class _SedPool(torch.autograd.Function):
    """``ages`` None: the unaged kernel; else the aged one at λ = decay."""

    @staticmethod
    def forward(ctx, h, valid, fresh, drop, ages, keep_prob, num_sampled,
                agg, decay):
        ctx.save_for_backward(valid, fresh, drop, ages)
        ctx.args = (keep_prob, num_sampled, agg, decay, h.dtype)
        return _pool(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg,
                     decay)

    @staticmethod
    def backward(ctx, g):
        valid, fresh, drop, ages = ctx.saved_tensors
        keep_prob, num_sampled, agg, decay, dtype = ctx.args
        eta, J_i = ref.sed_eta(valid, fresh, drop, keep_prob, num_sampled,
                               ages, decay)
        g = g.float()
        if agg == "mean":
            g = g / torch.clamp(J_i, min=1.0)
        dh = (g[:, None, :] * eta[..., None]).to(dtype)
        return (dh,) + (None,) * 8


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
