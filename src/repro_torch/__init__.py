"""PyTorch/CUDA port of the GST system (the JAX package ``repro`` is the
reference and stays as it is).

Slice 1 is the graph-property serving path: ``launch/serve_graphs.py`` ->
``serve/engine.py::ServeEngine`` -> ``graphs/gnn.py::encode_segments``, whose
neighbor aggregation runs the hand-written CUDA kernel
``kernels/csrc/segment_spmm.cu`` on the card.  Slice 2 is graph-track GST
training: ``launch/train.py`` -> ``graphs/experiment.py::run_experiment`` ->
the steps of ``core/gst.py``, which add the SpMM's backward (the same
kernel, src and dst swapped) and the fused SED pooling
``kernels/csrc/sed_pool.cu``.  Slice 3 is distributed training
(``launch/train_dist.py``, the codec kernels ``kernels/csrc/quant.cu``).
Slice 4 is sequence-track serving of the dense transformers:
``launch/serve.py`` and ``models/registry.py::Model``, whose full-sequence
passes run the attention kernel ``kernels/csrc/swa_attention.cu``.

Device rule: entry points run on ``cuda`` unless the caller asks for the
CPU; asking for ``cuda`` where no card is visible raises.  TF32 is switched
off for matmuls and convolutions, because the f32 parity with the JAX
package (1e-5) does not survive it.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and
    ``torch.cuda.is_available()`` is False (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was asked for but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return dev
