"""Causal sliding-window attention: the attention of every full-sequence
forward of the sequence track's dense transformer (prefill, forward,
segment encode).

    out[b, i, h] = Σ_j softmax_j(q[b, i, h] · k[b, j, g] / √D) · v[b, j, g]

over the keys with i − W < j ≤ i (W ≥ S: full causal), g = h // (H / KV).
The wrapper of the hand-written CUDA kernel in ``csrc/swa_attention.cu``,
which replaces the TPU kernel
``src/repro/kernels/swa_attention.py::_swa_kernel`` (:27, launched at
:86); see the source's note for the design and its bound.  Both of its
products run on the tensor cores at f32 accuracy (3xTF32: each operand
split into two TF32 parts, three products a product).

Device rule: a CPU tensor goes to the plain version
(``ref.swa_attention_ref``); a CUDA tensor launches the kernel or raises.
Nothing falls back.  ``LAUNCHES`` counts the kernel's launches, one per
launch.  There is no backward (the reference has none either, its models
train through jnp autodiff): the kernel refuses inputs that need a
gradient.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.counts import LaunchCounts

KERNEL = "swa_attention"
LAUNCHES = LaunchCounts((KERNEL,))
HEAD_DIMS = (64, 128)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels._build import load

    lib = load("swa_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.swa_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, p, i,
                                          ctypes.c_float, p]
        lib.swa_attention_fwd.restype = i
        lib.swa_attention_smem_bytes.argtypes = [i]
        lib.swa_attention_smem_bytes.restype = i
        lib.swa_attention_error_string.argtypes = [i]
        lib.swa_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("want q (B, S, H, D) and k, v (B, S, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, S, KV, D) = ({B}, {S}, KV, {D}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"H = {H} query heads must be a multiple of KV = {KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} must have a contiguous last dimension, "
                             "strides in multiples of 4 elements and a "
                             "16-byte aligned start")
    _refuse_grad(q, k, v)


def _refuse_grad(q, k, v):
    """The kernel has no backward: a call that autograd records raises, on
    the CPU too, so a training path that reaches the kernel's route fails
    there as it would on the card."""
    if torch.is_grad_enabled():
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.requires_grad:
                raise RuntimeError(f"{name} requires grad: swa_attention "
                                   "has no backward")


def _launch(q, k, v, window: int) -> torch.Tensor:
    """One launch on CUDA tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"the swa_attention kernel runs on cuda, not "
                         f"{q.device}")
    _check(q, k, v)
    if window < 1:
        raise ValueError(f"window must be >= 1, not {window}")
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    with torch.cuda.device(q.device):
        err = lib.swa_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
            k.shape[2], D, strides, min(window, S), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("swa_attention launch failed: "
                           + lib.swa_attention_error_string(err).decode())
    LAUNCHES.add(KERNEL)
    return out


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, KV, D) -> (B, S, H, D): one kernel launch
    on CUDA.  ``window`` >= S is full causal attention."""
    _refuse_grad(q, k, v)
    if q.device.type == "cpu":
        return ref.swa_attention_ref(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"swa_attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, window)
