"""Graph partitioners (paper §3.1 + Table 6 ablation).

The paper uses METIS as the canonical partitioner and ablates Louvain,
random edge-cut, and vertex-cut schemes (DBH, NE).  The container has no
METIS binding, so we implement:

  * ``bfs``        — METIS-like locality-preserving region growing: BFS from
                     random seeds, capped at max_size (greedy graph growing,
                     the seed heuristic inside METIS's coarsening).
  * ``louvain``    — networkx Louvain communities, split/merged to max_size.
  * ``random``     — random node assignment (random EDGE-CUT — the paper's
                     failure case: destroys locality).
  * ``vertex_cut`` — DBH-style edge partitioning by hashing the higher-degree
                     endpoint; nodes are replicated across segments [33].

All return List[np.ndarray] of node ids per segment (vertex-cut may repeat
nodes across segments).  Every node appears in >= 1 segment.
"""
from __future__ import annotations

from collections import defaultdict, deque
from typing import Callable, Dict, List

import numpy as np


def _adjacency(n: int, edges: np.ndarray) -> List[List[int]]:
    """Symmetrized adjacency: both directions of every edge are inserted so
    BFS region growing reaches a node regardless of the orientation callers
    hand us (a directed edge list no longer silently strands sink-only
    nodes in singleton segments)."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for a, b in edges:
        a, b = int(a), int(b)
        adj[a].append(b)
        if a != b:
            adj[b].append(a)
    return adj


def bfs_partition(n: int, edges: np.ndarray, max_size: int,
                  seed: int = 0) -> List[np.ndarray]:
    """Locality-preserving region growing (METIS-like)."""
    rng = np.random.default_rng(seed)
    adj = _adjacency(n, edges)
    unassigned = np.ones(n, bool)
    order = rng.permutation(n)
    segments: List[np.ndarray] = []
    ptr = 0
    while unassigned.any():
        while ptr < n and not unassigned[order[ptr]]:
            ptr += 1
        seed_node = int(order[ptr])
        seg = []
        q = deque([seed_node])
        unassigned[seed_node] = False
        while q and len(seg) < max_size:
            u = q.popleft()
            seg.append(u)
            for v in adj[u]:
                if unassigned[v] and len(seg) + len(q) < max_size:
                    unassigned[v] = False
                    q.append(v)
        # drain queue into the segment (already marked assigned)
        while q and len(seg) < max_size:
            seg.append(q.popleft())
        for u in q:  # overflow back to the pool
            unassigned[u] = True
        segments.append(np.asarray(seg, np.int32))
    return segments


def louvain_partition(n: int, edges: np.ndarray, max_size: int,
                      seed: int = 0) -> List[np.ndarray]:
    try:
        import networkx as nx
    except ImportError:
        # minimal containers have no networkx; the BFS region grower is the
        # closest locality-preserving stand-in (same invariants, Table 6
        # shows both sit in the locality-preserving cluster)
        return bfs_partition(n, edges, max_size, seed)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(map(tuple, edges))
    comms = nx.algorithms.community.louvain_communities(g, seed=seed)
    segments: List[np.ndarray] = []
    bucket: List[int] = []
    for c in comms:
        nodes = sorted(c)
        # split oversized communities, merge small ones into buckets
        for i in range(0, len(nodes), max_size):
            chunk = nodes[i : i + max_size]
            if len(chunk) == max_size:
                segments.append(np.asarray(chunk, np.int32))
            else:
                bucket.extend(chunk)
                while len(bucket) >= max_size:
                    segments.append(np.asarray(bucket[:max_size], np.int32))
                    bucket = bucket[max_size:]
    if bucket:
        segments.append(np.asarray(bucket, np.int32))
    return segments


def random_partition(n: int, edges: np.ndarray, max_size: int,
                     seed: int = 0) -> List[np.ndarray]:
    """Random edge-cut: random node assignment, no locality."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [perm[i : i + max_size].astype(np.int32)
            for i in range(0, n, max_size)]


def vertex_cut_partition(n: int, edges: np.ndarray, max_size: int,
                         seed: int = 0) -> List[np.ndarray]:
    """DBH-style vertex-cut [33]: assign each edge to the hash bucket of its
    higher-degree endpoint; a segment's node set is the union of endpoints of
    its edges (nodes replicated across segments)."""
    deg = np.bincount(edges.reshape(-1), minlength=n)
    n_parts = max(1, int(np.ceil(n / max_size)))
    rng = np.random.default_rng(seed)
    salt = int(rng.integers(0, 2**31))
    part_nodes: Dict[int, set] = defaultdict(set)
    for a, b in edges:
        a, b = int(a), int(b)
        pivot = a if deg[a] >= deg[b] else b
        p = (pivot * 2654435761 + salt) % n_parts
        part_nodes[p].add(a)
        part_nodes[p].add(b)
    covered = set().union(*part_nodes.values()) if part_nodes else set()
    isolated = [u for u in range(n) if u not in covered]
    for u in isolated:
        part_nodes[(u * 2654435761 + salt) % n_parts].add(u)
    segments = []
    for p in sorted(part_nodes):
        nodes = sorted(part_nodes[p])
        for i in range(0, len(nodes), max_size):  # enforce the cap
            segments.append(np.asarray(nodes[i : i + max_size], np.int32))
    return segments


PARTITIONERS: Dict[str, Callable] = {
    "bfs": bfs_partition,          # METIS-like (default)
    "louvain": louvain_partition,
    "random": random_partition,    # random edge-cut (failure case)
    "vertex_cut": vertex_cut_partition,
}


def partition_graph(n: int, edges: np.ndarray, max_size: int,
                    method: str = "bfs", seed: int = 0) -> List[np.ndarray]:
    return PARTITIONERS[method](n, edges, max_size, seed)


def partitioner_run(method: str) -> str:
    """The partitioner that ``partition_graph(..., method)`` runs in this
    process: ``method`` itself, but ``"bfs(networkx absent)"`` for
    ``louvain`` where networkx cannot be imported (``louvain_partition``
    then falls back to BFS, as the reference's does)."""
    if method == "louvain":
        try:
            import networkx  # noqa: F401
        except ImportError:
            return "bfs(networkx absent)"
    return method
