"""Synthetic graph-property datasets mirroring the paper's benchmarks.

The container is offline, so MalNet / TpuGraphs are *modeled*, preserving the
properties GST exercises (this is what the paper's claims hinge on):

* MalNet-like (classification): each graph is a union of communities, each
  community has a latent type visible in its nodes' (noisy) features, and the
  **label depends on the multiset of community types across the whole graph**
  (majority type, ties to the smaller id).  A single segment sees ~one
  community, so it carries insufficient information — exactly the "graph
  diameter" argument of the paper's introduction — and GST-One must
  underperform while aggregated GST matches full-graph training.

* TpuGraphs-like (ranking/regression): the target "runtime" is a sum of
  per-community costs (cost = nonlinear function of the community's type and
  size, modulated by a per-graph "configuration" feature that is broadcast to
  node features, as TpuGraphs featurizes layout configs into node features).
  Sum-decomposability matches the paper's §5.3 observation that predicting
  per-segment runtimes and sum-pooling works best; OPA is the metric.

Graphs are plain numpy (host-side preprocessing, like the paper's METIS
pass); the padded-CSR batching in batching.py produces the static-shape
device arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SyntheticGraph:
    x: np.ndarray          # (n_nodes, n_feat) float32
    edges: np.ndarray      # (n_edges, 2) int32, undirected (both dirs present)
    label: float           # class id (int) or runtime (float)
    community: np.ndarray  # (n_nodes,) int32 — ground-truth community id
    meta: dict = field(default_factory=dict)


def _community_graph(rng: np.random.Generator, n_comm: int, comm_size_rng,
                     n_types: int, n_feat: int, p_in: float, p_out_edges: int):
    """Build a noisy-feature community graph; returns (x, edges, types, comm)."""
    sizes = [int(rng.integers(*comm_size_rng)) for _ in range(n_comm)]
    types = rng.integers(0, n_types, size=n_comm)
    n = sum(sizes)
    x = np.zeros((n, n_feat), np.float32)
    comm = np.zeros((n,), np.int32)
    edges = []
    offset = 0
    for c, (sz, t) in enumerate(zip(sizes, types)):
        idx = np.arange(offset, offset + sz)
        comm[idx] = c
        # noisy one-hot of the community type in the first n_types dims
        feats = rng.normal(0, 0.4, size=(sz, n_feat)).astype(np.float32)
        feats[:, t % n_feat] += 1.0
        x[idx] = feats
        # intra-community edges: random tree + extra random edges (connected,
        # locality-preserving — what METIS-style partitioners can exploit)
        for i in range(1, sz):
            j = int(rng.integers(0, i))
            edges.append((idx[i], idx[j]))
        extra = int(p_in * sz)
        for _ in range(extra):
            a, b = rng.integers(0, sz, 2)
            if a != b:
                edges.append((idx[a], idx[b]))
        offset += sz
    # sparse inter-community edges
    for _ in range(p_out_edges):
        a = int(rng.integers(0, n))
        b = int(rng.integers(0, n))
        if comm[a] != comm[b]:
            edges.append((a, b))
    e = np.asarray(edges, np.int32)
    e = np.concatenate([e, e[:, ::-1]], axis=0)  # symmetrize
    return x, e, types, comm


def make_malnet_like(
    n_graphs: int = 120,
    n_classes: int = 5,
    n_feat: int = 8,
    comm_range: Tuple[int, int] = (4, 9),
    comm_size_range: Tuple[int, int] = (24, 56),
    seed: int = 0,
) -> List[SyntheticGraph]:
    """Label = majority community type (ties -> smaller id) — global info."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n_comm = int(rng.integers(*comm_range))
        x, e, types, comm = _community_graph(
            rng, n_comm, comm_size_range, n_classes, n_feat, p_in=2.0,
            p_out_edges=max(2, n_comm // 2))
        label = int(np.argmax(np.bincount(types, minlength=n_classes)))
        graphs.append(SyntheticGraph(x, e, label, comm,
                                     meta={"types": types}))
    return graphs


def make_tpugraphs_like(
    n_graphs: int = 96,
    n_feat: int = 8,
    n_types: int = 5,
    comm_range: Tuple[int, int] = (4, 9),
    comm_size_range: Tuple[int, int] = (24, 56),
    n_configs: int = 4,
    seed: int = 1,
) -> List[SyntheticGraph]:
    """Runtime = Σ_c cost(type_c, size_c) · (1 + 0.3·config·type_c/n_types).

    Each (graph, config) pair is one example (the paper: "a graph together
    with a configuration defines one G^(i)"); the config scalar is broadcast
    into the last node-feature column.
    """
    rng = np.random.default_rng(seed)
    base_cost = rng.uniform(0.5, 2.0, size=n_types)
    graphs = []
    for _ in range(n_graphs // n_configs):
        n_comm = int(rng.integers(*comm_range))
        x, e, types, comm = _community_graph(
            rng, n_comm, comm_size_range, n_types, n_feat, p_in=2.0,
            p_out_edges=max(2, n_comm // 2))
        sizes = np.bincount(comm, minlength=len(types)).astype(np.float32)
        for k in range(n_configs):
            cfgval = k / max(n_configs - 1, 1)
            runtime = float(np.sum(
                base_cost[types] * np.sqrt(sizes) * (1 + 0.3 * cfgval * types / n_types)))
            xc = x.copy()
            xc[:, -1] = cfgval
            graphs.append(SyntheticGraph(
                xc, e, runtime + float(rng.normal(0, 0.01)), comm,
                meta={"config": cfgval, "types": types}))
    return graphs
