"""Synthetic request traffic for the serving engine.

Models the serving-side distribution the ROADMAP's "millions of users" north
star implies: a pool of unique graphs with a heavy-tailed size mix, replayed
as a request stream in which a configurable fraction of requests repeat an
earlier graph (duplicate_rate) — the knob that exercises the cross-request
segment cache.  Repeated requests reference the SAME graph object, so the
deterministic partitioner reproduces identical segments and the cache keys
match by content.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.graphs.data import SyntheticGraph, make_malnet_like


@dataclass(frozen=True)
class TrafficConfig:
    n_unique: int = 24            # unique graphs in the pool
    n_requests: int = 64          # total request stream length
    duplicate_rate: float = 0.5   # P(request repeats an already-seen graph)
    popularity: float = 0.0       # repeat-pick skew over distinct seen
                                  # graphs: P(g) ∝ times_served(g)**popularity.
                                  # 0 = uniform over distinct seen ids (the
                                  # documented default), 1 = proportional
                                  # rich-get-richer (the old accidental
                                  # behavior), >1 = steeper head
    comm_range: Tuple[int, int] = (2, 12)    # wide -> mixed graph sizes
    comm_size_range: Tuple[int, int] = (12, 48)
    n_types: int = 5
    n_feat: int = 8
    seed: int = 0


def make_graph_pool(cfg: TrafficConfig) -> List[SyntheticGraph]:
    """Unique graphs with mixed sizes (small requests land in small buckets,
    large ones span several segments) — the training dataset's generator, so
    serving traffic follows the training distribution by construction."""
    pool = make_malnet_like(
        n_graphs=cfg.n_unique, n_classes=cfg.n_types, n_feat=cfg.n_feat,
        comm_range=cfg.comm_range, comm_size_range=cfg.comm_size_range,
        seed=cfg.seed)
    for gi, g in enumerate(pool):
        g.meta["pool_id"] = gi
    return pool


def make_request_stream(cfg: TrafficConfig) -> List[SyntheticGraph]:
    """Request stream over the pool.  The first occurrence of each graph is
    always a cold miss; with probability duplicate_rate a request re-serves
    an already-seen graph — uniformly over DISTINCT seen ids by default,
    or skewed ∝ times_served**popularity when cfg.popularity > 0.

    (The stream used to sample from the seen list WITH duplicates, which
    silently compounded popularity — every repeat made the next repeat of
    the same graph more likely — inflating cache hit-rates beyond what the
    docstring promised.  That behavior is now the explicit popularity=1
    setting.)"""
    pool = make_graph_pool(cfg)
    rng = np.random.default_rng(cfg.seed + 1)
    stream: List[SyntheticGraph] = []
    seen: List[int] = []              # distinct seen ids, arrival order
    count: dict = {}                  # id -> times served
    fresh = list(range(len(pool)))
    for _ in range(cfg.n_requests):
        if seen and (not fresh or rng.random() < cfg.duplicate_rate):
            if cfg.popularity > 0.0:
                w = np.array([count[g] for g in seen], np.float64)
                w = w ** cfg.popularity
                gi = int(rng.choice(seen, p=w / w.sum()))
            else:
                gi = int(seen[int(rng.integers(len(seen)))])
        else:
            gi = fresh.pop(0)
        if gi not in count:
            seen.append(gi)
        count[gi] = count.get(gi, 0) + 1
        stream.append(pool[gi])
    return stream
