"""Synthetic token pipelines for the sequence (transformer) GST track.

A copy of ``src/repro/data/tokens.py`` (numpy only): the same seed gives
the same documents, batches and LM stream, bit for bit.

``make_property_docs`` mirrors the MalNet-like construction at token level:
a document is J segments, each drawn from a latent *topic*'s unigram
distribution; the label is the majority topic — a whole-input property no
single segment determines reliably, which is GST's use case (DESIGN.md §3).

``make_lm_stream`` is a deterministic-pattern LM stream used by smoke tests
(loss must drop) and the plain-LM objective of train.py.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def make_property_docs(
    n_docs: int = 64,
    n_segments: int = 4,
    seg_len: int = 64,
    vocab: int = 256,
    n_topics: int = 5,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Returns dict of arrays: tokens (n, J, L), labels (n,), seg_valid (n, J)."""
    rng = np.random.default_rng(seed)
    # topic unigram distributions over disjoint-ish vocab bands
    topics = []
    for t in range(n_topics):
        w = np.full(vocab, 0.2 / vocab)
        band = slice((t * vocab) // n_topics, ((t + 1) * vocab) // n_topics)
        w[band] += 0.8 / max(band.stop - band.start, 1)
        topics.append(w / w.sum())
    tokens = np.zeros((n_docs, n_segments, seg_len), np.int32)
    labels = np.zeros((n_docs,), np.int32)
    for i in range(n_docs):
        seg_topics = rng.integers(0, n_topics, n_segments)
        for j, t in enumerate(seg_topics):
            tokens[i, j] = rng.choice(vocab, size=seg_len, p=topics[t])
        labels[i] = int(np.argmax(np.bincount(seg_topics, minlength=n_topics)))
    return {
        "tokens": tokens,
        "labels": labels,
        "seg_valid": np.ones((n_docs, n_segments), np.float32),
    }


def doc_batch_iterator(docs: Dict[str, np.ndarray], batch_size: int, *,
                       rng: np.random.Generator, shuffle: bool = True
                       ) -> Iterator[Tuple[Dict, np.ndarray, np.ndarray, np.ndarray]]:
    n = docs["tokens"].shape[0]
    order = rng.permutation(n) if shuffle else np.arange(n)
    for i in range(0, n - batch_size + 1, batch_size):
        ids = order[i : i + batch_size]
        yield ({"tokens": docs["tokens"][ids]}, docs["seg_valid"][ids],
               ids.astype(np.int32), docs["labels"][ids])


def make_lm_stream(n_seqs: int, seq_len: int, vocab: int, seed: int = 0
                   ) -> np.ndarray:
    """Learnable pattern: x_{t+1} = (x_t * 3 + noise) % vocab, noise sparse."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_seqs, seq_len), np.int32)
    x = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len):
        out[:, t] = x
        jump = rng.random(n_seqs) < 0.05
        x = np.where(jump, rng.integers(0, vocab, n_seqs), (x * 3 + 1) % vocab)
    return out
