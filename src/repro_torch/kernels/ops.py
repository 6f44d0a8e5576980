"""Public wrappers over the port's kernels, plus the shape-padding helpers.

Counterpart of ``src/repro/kernels/ops.py``.  Where the JAX package counts
``pallas_call`` eqns in a jaxpr (``count_pallas_calls``), the port counts
launches: every kernel wrapper adds one to its entry of
``kernel_launches()`` when it launches, and nowhere else.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import quant as _quant
from repro_torch.kernels import ref
from repro_torch.kernels import sed_pool as _sed
from repro_torch.kernels import segment_spmm as _spmm
from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels.quant import PAYLOAD_DTYPES  # noqa: F401


# ---------------------------------------------------------------------------
# shape-padding helpers (shared by serve/cache.py and store/)
#
# Scatter/gather row sets vary per batch; padding their length to the next
# power of two keeps the set of shapes O(log capacity).  Padding repeats the
# LAST entry, so a padded scatter writes the same (row, value) pair twice —
# a deterministic no-op — and a padded gather reads rows the caller then
# ignores.
# ---------------------------------------------------------------------------


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def prev_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (n.bit_length() - 1)


def pad_rows_pow2(rows: Sequence[int], *alongside: Sequence,
                  ) -> Tuple[np.ndarray, ...]:
    """Pad ``rows`` (and any parallel index lists) to the next power of two
    by repeating the last entry.  Returns int32 numpy arrays ready for a
    padded scatter/gather; ``rows`` must be non-empty."""
    n = next_pow2(len(rows))
    out = []
    for seq in (rows,) + alongside:
        seq = list(seq)
        out.append(np.asarray(seq + [seq[-1]] * (n - len(seq)), np.int32))
    return tuple(out)


def pad_leading(x, target: int):
    """Zero-pad the leading axis of ``x`` (numpy array or tensor) to
    ``target`` rows (no-op when already there)."""
    n = x.shape[0]
    if n == target:
        return x
    if isinstance(x, np.ndarray):
        pad = np.zeros((target - n,) + x.shape[1:], x.dtype)
        return np.concatenate([x, pad], axis=0)
    return torch.cat([x, x.new_zeros((target - n,) + tuple(x.shape[1:]))])


# ---------------------------------------------------------------------------
# kernel entry points
# ---------------------------------------------------------------------------


_COUNTERS = (_spmm.LAUNCHES, _sed.LAUNCHES, _quant.LAUNCHES, _swa.LAUNCHES)


def kernel_launches() -> Dict[str, int]:
    """Launches of each kernel since the last ``reset_kernel_launches``:
    the SpMM forward (``segment_spmm_batched``) and backward
    (``segment_spmm_batched_bwd``), ``sed_pool``, ``sed_pool_aged``, the
    six ``quant_*`` pack and unpack kernels and ``swa_attention``."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_kernel_launches() -> None:
    for counts in _COUNTERS:
        counts.reset()


def max_intermediate_bytes(fn, *args, **kwargs) -> int:
    """Bytes of the largest single buffer an op makes in one call of
    ``fn(*args, **kwargs)`` (an output that is a view or an in-place
    result makes none), counted by the memory probe's dispatch mode
    (``obs/memory.py::LiveBytes``) in the calling thread.  Counterpart of
    ``src/repro/kernels/ops.py::max_intermediate_bytes``: the streaming
    encoder's stays flat as the chunk count grows, the one-shot
    encoder's grows with the segment count."""
    from repro_torch.obs.memory import LiveBytes

    mode = LiveBytes()
    with mode:
        fn(*args, **kwargs)
    return mode.largest


def batched_neighbor_sum(h, src, dst, w, *, use_kernels: bool = True):
    """Batched weighted scatter-add over N segments in ONE kernel launch.

    h: (N, m, d); src/dst: (N, e) int32; w: (N, e) float32.  The GNN hot
    path: every message-passing layer of graphs/gnn.py::_encode_batched
    makes exactly one call here.  ``use_kernels`` False takes the plain
    version on any device.
    """
    if use_kernels:
        return _spmm.segment_spmm_batched(h, src, dst, w)
    return ref.segment_spmm_batched_ref(h, src, dst, w)


def neighbor_aggregate(h, src, dst, edge_valid, *, num_nodes: int,
                       use_kernels: bool = True):
    """Masked neighbor mean of one segment: (mean (m, d), deg (m,)).

    The sum runs through the SpMM kernel (N = 1); the degree is a cheap
    O(e) reduction in plain torch."""
    if use_kernels:
        s = _spmm.segment_spmm(h, src, dst, edge_valid)
    else:
        s = ref.segment_spmm_ref(h, src, dst, edge_valid, num_nodes)
    deg = torch.zeros(num_nodes, dtype=edge_valid.dtype, device=h.device)
    deg.index_add_(0, dst.long(), edge_valid)
    return s / deg.clamp_min(1.0)[:, None], deg


def sed_aggregate(h, seg_valid, fresh_mask, drop_mask, ages=None, *,
                  keep_prob: float, num_sampled: int, agg: str = "mean",
                  decay: float = 0.0, use_kernels: bool = True):
    """Fused Eq.-1 η-weighting + ⊕ pooling over segments: (B, J, d) -> (B, d).

    ``ages``/``decay``: optional (B, J) age-in-steps and λ of the
    staleness-decayed stale branch (ref.sed_eta); λ = 0 keeps the unaged
    kernel.  ``use_kernels`` False takes the plain version on any device."""
    if use_kernels:
        return _sed.sed_pool(h, seg_valid, fresh_mask, drop_mask,
                             keep_prob=keep_prob, num_sampled=num_sampled,
                             agg=agg, ages=ages, decay=decay)
    return ref.sed_pool_ref(h, seg_valid, fresh_mask, drop_mask, keep_prob,
                            num_sampled, agg, ages, decay)


def quantize_payload(x, rand_bits=None, *, dtype: str,
                     use_kernels: bool = True):
    """Pack f32 rows into the compressed exchange wire format: (values
    bf16,) or (values int8, scale (R,) f32), one scale per leading row.
    ``rand_bits`` (int32 holding uint32 bits, x's shape) rounds
    stochastically (the write path); None to nearest even (the read path).
    ``use_kernels`` False takes the plain version on any device."""
    if use_kernels:
        return _quant.quantize_rows(x, dtype, rand_bits)
    return ref.quantize_rows_ref(x, dtype, rand_bits)


def dequantize_payload(parts, *, dtype: str, use_kernels: bool = True):
    """Unpack compressed wire parts back to f32 rows."""
    if use_kernels:
        return _quant.dequantize_rows(parts, dtype)
    return ref.dequantize_rows_ref(tuple(parts), dtype)


def sliding_window_attention(q, k, v, *, window: int,
                             use_kernels: bool = True):
    """Causal sliding-window attention: q (B, S, H, D), k/v (B, S, KV, D)
    -> (B, S, H, D); key j visible to query i iff i - window < j <= i, so
    ``window`` >= S is full causal attention.  ``window`` is taken
    literally, as the reference's op takes it.  ``use_kernels`` False takes
    the plain version on any device.

    The kernel has no backward: with ``use_kernels`` a call that autograd
    records raises.  The caller that trains picks the plain version
    (``use_kernels`` False), as the reference's models train through jnp
    and never call its Pallas attention."""
    if use_kernels:
        return _swa.swa_attention(q, k, v, window=window)
    return ref.swa_attention_ref(q, k, v, window)
