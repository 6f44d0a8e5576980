"""The traffic generator: property documents and request schedules.

``property_docs`` is a vectorised copy of the port's
``data/tokens.py::make_property_docs`` law: each segment's tokens come
from one latent topic, a band of the vocabulary holding
``topic_band_share`` of the mass over the uniform rest, and a document's
label is its majority topic (ties to the lowest).  Vectorised, because the
copy's per-segment ``rng.choice`` over a 92,544-word vocabulary would cost
seconds of set-up; the same seed gives the same corpus.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np


def property_docs(n_docs: int, n_segments: int, seg_len: int, vocab: int,
                  n_topics: int, band_share: float, seed: int, tag: int
                  ) -> Dict[str, np.ndarray]:
    """tokens (n, J, L) int32, labels (n,) int32, seg_valid (n, J) f32."""
    rng = np.random.default_rng([seed, tag])
    topics = rng.integers(0, n_topics, (n_docs, n_segments))
    lo = (topics * vocab) // n_topics
    hi = ((topics + 1) * vocab) // n_topics
    shape = (n_docs, n_segments, seg_len)
    band = lo[..., None] + (rng.random(shape) * (hi - lo)[..., None]
                            ).astype(np.int64)
    anywhere = rng.integers(0, vocab, shape)
    tokens = np.where(rng.random(shape) < band_share, band, anywhere)
    counts = (topics[..., None] == np.arange(n_topics)).sum(axis=1)
    return {"tokens": tokens.astype(np.int32),
            "labels": np.argmax(counts, axis=1).astype(np.int32),
            "seg_valid": np.ones((n_docs, n_segments), np.float32)}


def segment_cycle(max_segments: int, cycle: int) -> np.ndarray:
    """The segment counts of one cycle of requests: J = floor((max + 1)^u)
    at u = (i + 1/2) / cycle, a log-uniform law over 1..max whose every
    cycle holds the same counts."""
    u = (np.arange(cycle) + 0.5) / cycle
    return np.floor((max_segments + 1) ** u).astype(np.int64).clip(
        1, max_segments)


def request_segments(max_segments: int, cycle: int, n: int, seed: int,
                     tag: int) -> np.ndarray:
    """The segment counts of the first ``n`` requests: whole cycles, each
    shuffled by the seed, so every seed sends the same counts in another
    order."""
    rng = np.random.default_rng([seed, tag])
    base = segment_cycle(max_segments, cycle)
    reps = math.ceil(n / cycle)
    return np.concatenate([rng.permutation(base) for _ in range(reps)])[:n]
