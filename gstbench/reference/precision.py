"""The precision the reference computes its matmuls in.

``f32``: float32 with TF32 off, the configurations' stated precision.
The controls are the nearest precisions below it: ``tf32`` (on the card
TF32 switched on; on the CPU, which has none, each operand rounded to
TF32's 10-bit mantissa, as the tensor cores read it) and ``bf16``.
"""
from __future__ import annotations

import contextlib

import torch

MODES = ("f32", "tf32", "bf16")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def matmul_precision(mode: str):
    """TF32 on the card as ``mode`` says, restored on exit."""
    if mode not in MODES:
        raise ValueError(mode)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest even at 10 mantissa bits (TF32), kept f32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every operand rounded to TF32, the backward's too, as
    the tensor cores multiply both passes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        return (ga.sum_to_size(a.shape) if ga.shape != a.shape else ga,
                gb.sum_to_size(b.shape) if gb.shape != b.shape else gb)


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in ``mode``; f32 out."""
    if mode == "bf16":
        return torch.matmul(a.bfloat16(), b.bfloat16()).float()
    if mode == "tf32" and a.device.type == "cpu":
        return _TF32MatMul.apply(a, b)
    return torch.matmul(a, b)
