"""Cross-request segment-embedding cache (content-addressed, LRU-bounded).

Counterpart of ``src/repro/serve/cache.py``.  A segment whose padded content
hash was seen before skips the GNN encode; only the cheap head runs on a
full-hit request.  A thin keying layer: content hashes map onto logical
rows of an ``EmbeddingStore`` through a ``SlotMap`` (LRU), and the store
decides where those rows live — with ``DeviceStore``, all in device memory.

Host side keeps hash -> row in LRU order plus hit/miss/eviction counters.
Eviction frees the least-recently-used row; its embedding stays where it
is and is overwritten on reuse.  Over a ``TieredStore`` the keying
layer's capacity is the rows of both tiers: an entry spilled to the host
tier faults back bit-exact on a hit.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import embedding_table as tbl
from repro_torch.kernels.ops import pad_rows_pow2, prev_pow2
from repro_torch.obs.metrics import get_registry
from repro_torch.store import DeviceStore, EmbeddingStore, SlotMap, StoreCounters


class SegmentCache:
    def __init__(self, capacity: int, d_h: int, dtype=torch.float32,
                 store: Optional[EmbeddingStore] = None, device="cpu"):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self.d_h = d_h
        self.store = store if store is not None \
            else DeviceStore(capacity, 1, d_h, dtype=dtype, device=device)
        # the cache keys SEGMENT-SLOT 0 of each store row
        if (self.store.n_rows, self.store.d_h) != (capacity, d_h):
            raise ValueError(
                f"backing store geometry {(self.store.n_rows, self.store.d_h)}"
                f" != cache ({capacity}, {d_h})")
        self.table = self.store.init_device_table()
        self._slots = SlotMap(capacity)   # content key -> logical row, LRU
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.skipped_inserts = 0
        self.step = 0  # monotonically increasing insertion step (age base)
        self._published: Dict[str, int] = {}  # registry mirror baselines

    def __len__(self) -> int:
        return len(self._slots)

    def close(self):
        """Release the backing store (stops a TieredStore's write-back
        thread)."""
        self.store.close()

    def flush(self):
        """Empty the cache (contents + counters; a tiered store's host tier
        and residency too)."""
        (self.table,) = self.store.restore(tbl.init_table(
            self.capacity, self.store.j_max, self.d_h, self.store.dtype))
        self._slots.clear()
        self.hits = self.misses = self.evictions = self.skipped_inserts = 0
        self.store.counters = StoreCounters()
        self.step = 0

    def publish_counters(self) -> None:
        """Mirror keying-layer counter movement into the metrics registry
        (``serve.cache.*``; no-op when metrics are disabled)."""
        reg = get_registry()
        if not reg.enabled:
            return
        for name, cur in (("serve.cache.hits", self.hits),
                          ("serve.cache.misses", self.misses),
                          ("serve.cache.evictions", self.evictions),
                          ("serve.cache.skipped_inserts",
                           self.skipped_inserts)):
            moved = cur - self._published.get(name, 0)
            if moved > 0:
                reg.inc(name, moved)
            self._published[name] = cur

    def get(self, key: bytes) -> Optional[int]:
        """Logical row of a cached segment (refreshes LRU position), or
        None.  Counts a hit/miss."""
        row = self._slots.get(key)
        if row is None:
            self.misses += 1
            return None
        self.hits += 1
        return row

    def peek(self, key: bytes) -> Optional[int]:
        """Like get() but with no counter / LRU side effects."""
        return self._slots.get(key, touch=False)

    def _rows(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows), dtype=torch.long,
                               device=self.store.device)

    def put(self, keys: List[bytes], embs: torch.Tensor,
            pinned=()) -> List[Optional[int]]:
        """Best-effort insert of freshly-encoded embeddings (len(keys), d_h);
        returns the row per key, None where the insert was skipped (batch of
        new keys larger than the capacity — the caller keeps its fresh
        embedding).  Duplicate keys in the batch write once.  ``pinned``:
        extra keys that must NOT be evicted — the engine passes the
        window's hit keys, whose rows it gathers after this insert.  The
        scatter is padded to the next power of two (pad_rows_pow2)."""
        self.step += 1
        # never evict a key being inserted in this batch, nor a caller-pinned
        # one (a hit row evicted here would be silently reused before the
        # caller's gather)
        pinned = set(keys) | set(pinned)
        slots, rows, idx, displaced_rows = [], [], [], []
        for i, key in enumerate(keys):
            row = self._slots.get(key)
            if row is None:
                row, displaced = self._slots.reserve(key, pinned=pinned)
                if row is None:
                    self.skipped_inserts += 1
                    slots.append(None)
                    continue
                if displaced is not None:
                    self.evictions += 1
                    displaced_rows.append(displaced[1])
                rows.append(row)
                idx.append(i)
            slots.append(row)
        if displaced_rows:
            # one batched invalidation per put(), not one per eviction
            self.table = self.store.invalidate_rows(self.table,
                                                    displaced_rows)
        if rows:
            chunk = min(len(rows), self.store.device_rows)
            for i0 in range(0, len(rows), chunk):
                rows_p, idx_p = pad_rows_pow2(rows[i0:i0 + chunk],
                                              idx[i0:i0 + chunk])
                # rows about to be fully overwritten: residency only
                self.table, dev_rows = self.store.prepare(
                    self.table, rows_p, fetch=False)
                self.table = tbl.update_rows(self.table, self._rows(dev_rows),
                                             embs[self._rows(idx_p)],
                                             self.step)
        return slots

    def gather(self, slots, valid=None) -> torch.Tensor:
        """(len(slots), d_h) embeddings — the stored values, so a hit
        returns bit-identical bytes to what was inserted.  ``valid`` (0/1,
        same length) limits the liveness check to real entries when the
        caller padded ``slots``."""
        rows = np.asarray(slots, np.int32)
        if len(rows) == 0:
            return torch.zeros(0, self.d_h, dtype=self.store.dtype,
                               device=self.store.device)
        chunk = min(prev_pow2(self.store.device_rows), len(rows))
        embs, inits = [], []
        for i0 in range(0, len(rows), chunk):
            self.table, dev_rows = self.store.prepare(self.table,
                                                      rows[i0:i0 + chunk])
            e, i = tbl.lookup_rows(self.table, self._rows(dev_rows))
            embs.append(e)
            inits.append(i)
        emb = torch.cat(embs)
        live = torch.cat(inits).cpu().numpy()
        if valid is not None:
            live = live | (np.asarray(valid) <= 0)
        if not live.all():
            raise RuntimeError("gather() of an evicted/uninitialized slot")
        return emb

    def stats(self) -> Dict:
        total = self.hits + self.misses
        ages, init = self.store.ages_init(self.table)
        ages, init = ages[:, 0], init[:, 0]
        live_ages = (self.step - ages[init]) if init.any() else np.zeros(0)
        return {
            "capacity": self.capacity,
            "size": len(self._slots),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "evictions": self.evictions,
            "skipped_inserts": self.skipped_inserts,
            "age_mean_steps": float(live_ages.mean()) if live_ages.size else 0.0,
            "age_max_steps": int(live_ages.max()) if live_ages.size else 0,
            "store": self.store.stats(),
        }
