"""Padded-CSR segment buckets for the serving engine.

Incoming segments (arbitrary node/edge counts, from arbitrary graphs) are
routed into a small ladder of static (m_max, e_max, batch) shapes so the
jitted encode step compiles ONCE per bucket and segments from different
requests share a device batch.  This is the serving analogue of the training
pipeline's single (m_max, e_max) padding in graphs/batching.py — the same
``pad_segment`` does the padding; the ladder just picks which static shape a
segment lands in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.graphs.batching import pad_segment
from repro_torch.graphs.data import SyntheticGraph


@dataclass(frozen=True)
class BucketSpec:
    """One static encode shape: segments padded to (m_max, e_max), batched
    ``batch`` at a time (short batches are padded with invalid segments)."""
    m_max: int
    e_max: int
    batch: int = 8

    @property
    def key(self) -> str:
        return f"m{self.m_max}_e{self.e_max}_b{self.batch}"


def default_ladder(max_seg_nodes: int = 64, batch: int = 8,
                   edge_factor: int = 8, n_buckets: int = 3) -> Tuple[BucketSpec, ...]:
    """Doubling node-size ladder ending at max_seg_nodes, edges ~8x nodes
    (comfortably above the synthetic datasets' density so the catch-all
    bucket almost never truncates; oversized edge lists are truncated by
    pad_segment exactly as in training)."""
    sizes = [max(max_seg_nodes >> (n_buckets - 1 - i), 4) for i in range(n_buckets)]
    sizes = sorted(set(sizes))
    return tuple(BucketSpec(m, m * edge_factor, batch) for m in sizes)


def choose_bucket(ladder: Sequence[BucketSpec], n_nodes: int, n_edges: int) -> int:
    """Smallest bucket that fits the segment; the LAST bucket is the
    catch-all (node lists/edge lists beyond its shape are truncated, matching
    the training-side pad_segment semantics)."""
    for i, spec in enumerate(ladder):
        if n_nodes <= spec.m_max and n_edges <= spec.e_max:
            return i
    return len(ladder) - 1


def truncation_counts(n_nodes: int, n_edges: int,
                      spec: BucketSpec) -> Tuple[int, int]:
    """How many nodes/edges ``pad_to_bucket`` will DROP for a segment of
    this size routed to ``spec`` — nonzero only for catch-all overflow
    (choose_bucket routes every fitting segment to a bucket that holds
    it).  The engine counts these per request so silent truncation
    becomes a published counter the obs gate can fail on."""
    return (max(n_nodes - spec.m_max, 0), max(n_edges - spec.e_max, 0))


def count_local_edges(graph: SyntheticGraph, node_ids: np.ndarray) -> int:
    sel = np.isin(graph.edges[:, 0], node_ids) & np.isin(graph.edges[:, 1], node_ids)
    return int(sel.sum())


def pad_to_bucket(graph: SyntheticGraph, node_ids: np.ndarray,
                  spec: BucketSpec) -> Dict[str, np.ndarray]:
    """One segment -> the bucket's static shapes (x, edges, edge_valid,
    node_valid), via the training pipeline's pad_segment."""
    x, e, ev, nv = pad_segment(graph, node_ids, spec.m_max, spec.e_max)
    return {"x": x, "edges": e, "edge_valid": ev, "node_valid": nv}


def batch_bucket(padded: List[Dict[str, np.ndarray]],
                 spec: BucketSpec) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Stack <= spec.batch padded segments into one device batch, padding the
    batch dim to spec.batch.  Returns (seg_inputs, seg_valid (batch,))."""
    n = len(padded)
    assert 0 < n <= spec.batch
    out = {}
    for k in ("x", "edges", "edge_valid", "node_valid"):
        first = padded[0][k]
        arr = np.zeros((spec.batch,) + first.shape, first.dtype)
        for i, seg in enumerate(padded):
            arr[i] = seg[k]
        out[k] = arr
    valid = np.zeros((spec.batch,), np.float32)
    valid[:n] = 1.0
    return out, valid


def segment_fingerprint(padded: Dict[str, np.ndarray], bucket_idx: int) -> bytes:
    """Content address of a padded segment: identical subgraphs (same local
    node features, same local edge list, same bucket) map to the same key —
    the cross-request cache key."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(bucket_idx.to_bytes(4, "little"))
    for k in ("x", "edges", "edge_valid", "node_valid"):
        a = np.ascontiguousarray(padded[k])
        h.update(a.tobytes())
    return h.digest()
