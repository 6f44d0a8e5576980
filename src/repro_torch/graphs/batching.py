"""Static-shape segment batching (the XLA adaptation of the paper's pipeline).

Each segment is padded to (m_max nodes, e_max edges) with validity masks;
each graph is padded to J_max segments with a segment mask.  Edges are local
to a segment (indices into the segment's node list); cross-segment edges are
dropped — the paper's Table 6 ablation shows locality-preserving partitions
make this information loss negligible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.graphs.data import SyntheticGraph
from repro_torch.graphs.partition import partition_graph


@dataclass
class SegmentedDataset:
    """All arrays are host numpy; leading dims (n_graphs, J_max, ...)."""
    x: np.ndarray          # (n, J, m_max, F)
    edges: np.ndarray      # (n, J, e_max, 2) int32 — local node indices
    edge_valid: np.ndarray  # (n, J, e_max) float32
    node_valid: np.ndarray  # (n, J, m_max) float32
    seg_valid: np.ndarray  # (n, J) float32
    labels: np.ndarray     # (n,) int32 or float32
    j_max: int
    m_max: int
    e_max: int

    @property
    def n(self):
        return self.x.shape[0]

    def seg_inputs(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "x": self.x[ids],
            "edges": self.edges[ids],
            "edge_valid": self.edge_valid[ids],
            "node_valid": self.node_valid[ids],
        }


def pad_segment(graph: SyntheticGraph, node_ids: np.ndarray, m_max: int,
                e_max: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Extract one segment as padded arrays (x, edges_local, edge_valid, node_valid)."""
    node_ids = node_ids[:m_max]
    g2l = {int(g): l for l, g in enumerate(node_ids)}
    sel = np.isin(graph.edges[:, 0], node_ids) & np.isin(graph.edges[:, 1], node_ids)
    e = graph.edges[sel]
    if len(e) > e_max:
        e = e[np.random.default_rng(0).permutation(len(e))[:e_max]]
    e_local = np.asarray([[g2l[int(a)], g2l[int(b)]] for a, b in e], np.int32)
    x = np.zeros((m_max, graph.x.shape[1]), np.float32)
    x[: len(node_ids)] = graph.x[node_ids]
    edges = np.zeros((e_max, 2), np.int32)
    edge_valid = np.zeros((e_max,), np.float32)
    if len(e_local):
        edges[: len(e_local)] = e_local
        edge_valid[: len(e_local)] = 1.0
    node_valid = np.zeros((m_max,), np.float32)
    node_valid[: len(node_ids)] = 1.0
    return x, edges, edge_valid, node_valid


def segment_dataset(
    graphs: List[SyntheticGraph],
    max_seg_nodes: int = 64,
    method: str = "bfs",
    j_max: Optional[int] = None,
    e_max: Optional[int] = None,
    seed: int = 0,
) -> SegmentedDataset:
    """Preprocessing phase: partition every graph and pad (paper §3.1)."""
    all_segs = []
    for gi, g in enumerate(graphs):
        segs = partition_graph(len(g.x), g.edges, max_seg_nodes, method, seed + gi)
        all_segs.append(segs)
    J = j_max or max(len(s) for s in all_segs)
    m_max = max_seg_nodes
    if e_max is None:
        e_max = 0
        for g, segs in zip(graphs, all_segs):
            for s in segs:
                sel = np.isin(g.edges[:, 0], s) & np.isin(g.edges[:, 1], s)
                e_max = max(e_max, int(sel.sum()))
        e_max = max(e_max, 1)
    n, F = len(graphs), graphs[0].x.shape[1]
    X = np.zeros((n, J, m_max, F), np.float32)
    E = np.zeros((n, J, e_max, 2), np.int32)
    EV = np.zeros((n, J, e_max), np.float32)
    NV = np.zeros((n, J, m_max), np.float32)
    SV = np.zeros((n, J), np.float32)
    labels = np.asarray([g.label for g in graphs])
    labels = labels.astype(np.int32 if np.issubdtype(labels.dtype, np.integer) else np.float32)
    for gi, (g, segs) in enumerate(zip(graphs, all_segs)):
        for j, s in enumerate(segs[:J]):
            x, e, ev, nv = pad_segment(g, s, m_max, e_max)
            X[gi, j], E[gi, j], EV[gi, j], NV[gi, j] = x, e, ev, nv
            SV[gi, j] = 1.0
    return SegmentedDataset(X, E, EV, NV, SV, labels, J, m_max, e_max)


def batch_id_schedule(n: int, batch_size: int, *, rng: np.random.Generator,
                      shuffle: bool = True) -> List[np.ndarray]:
    """One epoch's id batches (drop-last) — THE batching policy, shared by
    ``batch_iterator`` and the dist feeders (dist/pipeline.py::epoch_ids)
    so the two paths cannot diverge."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    return [order[i : i + batch_size]
            for i in range(0, n - batch_size + 1, batch_size)]


def batch_iterator(ds: SegmentedDataset, batch_size: int, *, rng: np.random.Generator,
                   shuffle: bool = True) -> Iterator[Tuple[Dict, np.ndarray, np.ndarray, np.ndarray]]:
    """Yields (seg_inputs, seg_valid, graph_ids, labels) batches (drop-last)."""
    for ids in batch_id_schedule(ds.n, batch_size, rng=rng, shuffle=shuffle):
        yield ds.seg_inputs(ids), ds.seg_valid[ids], ids.astype(np.int32), ds.labels[ids]


def whole_graph_dataset(graphs: List[SyntheticGraph]) -> SegmentedDataset:
    """Full Graph Training baseline: each graph is ONE segment padded to the
    dataset max — memory scales with the largest graph (the paper's OOM case)."""
    m_max = max(len(g.x) for g in graphs)
    e_max = max(len(g.edges) for g in graphs)
    n, F = len(graphs), graphs[0].x.shape[1]
    X = np.zeros((n, 1, m_max, F), np.float32)
    E = np.zeros((n, 1, e_max, 2), np.int32)
    EV = np.zeros((n, 1, e_max), np.float32)
    NV = np.zeros((n, 1, m_max), np.float32)
    SV = np.ones((n, 1), np.float32)
    labels = np.asarray([g.label for g in graphs])
    labels = labels.astype(np.int32 if np.issubdtype(labels.dtype, np.integer) else np.float32)
    for gi, g in enumerate(graphs):
        X[gi, 0, : len(g.x)] = g.x
        E[gi, 0, : len(g.edges)] = g.edges
        EV[gi, 0, : len(g.edges)] = 1.0
        NV[gi, 0, : len(g.x)] = 1.0
    return SegmentedDataset(X, E, EV, NV, SV, labels, 1, m_max, e_max)
