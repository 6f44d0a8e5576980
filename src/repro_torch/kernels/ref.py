"""Plain-torch versions of the port's kernels: the CPU path of each wrapper
and the yardstick the kernels are held against on the card.

Counterpart of ``src/repro/kernels/ref.py``.  ``sed_eta``, ``sed_pool_ref``
and ``swa_attention_ref`` land with the slices that port their kernels.
"""
from __future__ import annotations

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
    f32; the result is cast to h's dtype.
    """
    N, m, d = h.shape
    num_nodes = m if num_nodes is None else num_nodes
    offs = torch.arange(N, device=h.device, dtype=torch.int64)[:, None]
    src_g = (src.long() + offs * m).reshape(-1)
    dst_g = (dst.long() + offs * num_nodes).reshape(-1)
    msg = h.float().reshape(N * m, d)[src_g] * w.float().reshape(-1, 1)
    out = torch.zeros(N * num_nodes, d, dtype=torch.float32, device=h.device)
    out.index_add_(0, dst_g, msg)
    return out.reshape(N, num_nodes, d).to(h.dtype)
