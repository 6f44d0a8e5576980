"""GST heads of the port.

Counterpart of ``src/repro/core/gst.py:64-82`` (``head_init`` and
``head_apply``).  The variants, losses and train/eval/finetune steps land
with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import dense_init


class Head(nn.Module):
    """mode 'mlp': 2-layer MLP graph head F' (w1, b1, w2, b2).  mode
    'segment_sum': linear per-segment scalar head (w, b) — part of F, with
    F' = Σ (paper §5.3)."""

    def __init__(self, d_h: int, num_out: int, mode: str,
                 gen: torch.Generator):
        super().__init__()
        self.mode = mode
        if mode == "mlp":
            self.w1 = nn.Parameter(dense_init(d_h, d_h, gen))
            self.b1 = nn.Parameter(torch.zeros(d_h))
            self.w2 = nn.Parameter(dense_init(d_h, num_out, gen))
            self.b2 = nn.Parameter(torch.zeros(num_out))
        else:
            self.w = nn.Parameter(dense_init(d_h, 1, gen))
            self.b = nn.Parameter(torch.zeros(1))

    def forward(self, h):
        return head_apply(self, h, self.mode)


def head_init(d_h: int, num_out: int, mode: str, generator: torch.Generator,
              device) -> Head:
    return Head(d_h, num_out, mode, generator).to(device)


def head_apply(p: Head, h: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "mlp":
        z = torch.relu(h @ p.w1 + p.b1)
        return z @ p.w2 + p.b2
    return (h @ p.w + p.b)[..., 0]
