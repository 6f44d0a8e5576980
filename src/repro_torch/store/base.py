"""The embedding-store API of the port, and its device-resident backend.

Counterpart of ``src/repro/store/base.py:67-338``.  An ``EmbeddingStore``
owns WHICH rows of the historical table live in device memory; callers
address a plain ``EmbeddingTable`` of device rows through the row ids the
store hands back from ``prepare``.  ``DeviceStore`` keeps the whole table on
the device, so row ids ARE device rows and ``begin``/``commit`` are
bookkeeping only.  ``TieredStore`` (the host-RAM tier) lands with the store
slice.

Row geometry (``src/repro/store/base.py:48-55,141-150``): ``n_rows`` rows
split block-wise over ``num_shards`` shards, shard s owning rows
[s·R, (s+1)·R) with R = ``rows_per_shard``; the last shard pads.  Each
shard owns its own (R, J, d) tables (``init_shard_tables``), as it would
with one process per card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import embedding_table as tbl
from repro_torch.kernels.ops import pad_rows_pow2
from repro_torch.obs.metrics import get_registry


def rows_per_shard(n_rows: int, num_shards: int) -> int:
    """R such that D·R >= n (block row partition, last shard may pad)."""
    return -(-n_rows // max(num_shards, 1))


def padded_rows(n_rows: int, num_shards: int) -> int:
    return rows_per_shard(n_rows, num_shards) * max(num_shards, 1)


@dataclass
class StoreCounters:
    """Residency-traffic counters."""
    lookups: int = 0         # batch rows requested
    hits: int = 0            # already device-resident
    misses: int = 0          # faulted host -> device
    evictions: int = 0       # spilled device -> host
    bytes_h2d: int = 0
    bytes_d2h: int = 0

    def as_dict(self) -> dict:
        total = max(self.lookups, 1)
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total,
            "evictions": self.evictions,
            "bytes_h2d": self.bytes_h2d,
            "bytes_d2h": self.bytes_d2h,
            "migration_bytes": self.bytes_h2d + self.bytes_d2h,
        }


# registry mirror of StoreCounters: (field, published metric name, unit).
# ``misses`` surfaces as ``store.faults`` — the residency fault count.
_COUNTER_METRICS = (
    ("lookups", "store.lookups", "rows"),
    ("hits", "store.hits", "rows"),
    ("misses", "store.faults", "rows"),
    ("evictions", "store.evictions", "rows"),
    ("bytes_h2d", "store.bytes_h2d", "bytes"),
    ("bytes_d2h", "store.bytes_d2h", "bytes"),
)


class PreparedMigration(NamedTuple):
    """Output of ``begin``: the batch's device rows (and, in a tiered
    backend, the staged data movement ``commit`` applies)."""
    slots: np.ndarray                      # (B,) device rows for the batch


class EmbeddingStore:
    """Geometry, counters and the residency contract (module docstring).

    ``n_rows`` logical rows of ``j_max`` segment slots of ``d_h`` values,
    split over ``num_shards`` shards, ``device_rows`` of them
    device-resident at a time, on ``device``.
    """

    def __init__(self, n_rows: int, j_max: int, d_h: int, *,
                 num_shards: int = 1, dtype=torch.float32, device="cpu"):
        self.n_rows = n_rows
        self.j_max = j_max
        self.d_h = d_h
        self.num_shards = max(num_shards, 1)
        self.dtype = dtype
        self.device = torch.device(device)
        self.rows_per_shard = rows_per_shard(n_rows, self.num_shards)
        self.padded_rows = padded_rows(n_rows, self.num_shards)
        self.counters = StoreCounters()

    # ``store.counters`` stays the mutation surface (callers reset it by
    # assigning a fresh StoreCounters); the registry carries a cumulative
    # mirror published by diffing, so a reset never rewinds it.
    @property
    def counters(self) -> StoreCounters:
        return self._counters

    @counters.setter
    def counters(self, c: StoreCounters) -> None:
        self._counters = c
        self._published = {f: getattr(c, f) for f, _, _ in _COUNTER_METRICS}

    def publish_counters(self) -> None:
        """Mirror counter movement since the last publish into the metrics
        registry (no-op when metrics are disabled)."""
        reg = get_registry()
        if not reg.enabled:
            return
        for field, name, unit in _COUNTER_METRICS:
            cur = getattr(self._counters, field)
            moved = cur - self._published[field]
            if moved:
                reg.inc(name, moved, unit=unit)
                self._published[field] = cur

    @property
    def device_rows(self) -> int:
        return self.padded_rows

    # -- residency ---------------------------------------------------------

    def begin(self, row_ids, *, fetch: bool = True) -> PreparedMigration:
        """Make ``row_ids`` device-resident (``fetch`` False: their content
        is about to be overwritten, so only residency is needed)."""
        raise NotImplementedError

    def commit(self, table: tbl.EmbeddingTable,
               prep: PreparedMigration) -> tbl.EmbeddingTable:
        raise NotImplementedError

    def prepare(self, table: tbl.EmbeddingTable, row_ids, *,
                fetch: bool = True) -> Tuple[tbl.EmbeddingTable, np.ndarray]:
        """begin + commit in one call: (table, device rows of row_ids)."""
        prep = self.begin(row_ids, fetch=fetch)
        return self.commit(table, prep), prep.slots

    # -- lifecycle ---------------------------------------------------------

    def init_device_table(self) -> tbl.EmbeddingTable:
        """A fresh (all-uninitialized) device tier."""
        return tbl.init_table(self.device_rows, self.j_max, self.d_h,
                              self.dtype, self.device)

    def init_shard_tables(self, shards=None):
        """Fresh device tiers of the given shards (default: all), one
        (rows_per_shard, J, d) table each."""
        shards = range(self.num_shards) if shards is None else shards
        return [tbl.init_table(self.device_rows // self.num_shards,
                               self.j_max, self.d_h, self.dtype, self.device)
                for _ in shards]

    def restore(self, table: tbl.EmbeddingTable, shards=None):
        """The given shards' device tiers seeded from a full (n_rows, J, d)
        table: shard s gets rows [s·R, (s+1)·R), zero-padded."""
        raise NotImplementedError

    def invalidate_rows(self, table: tbl.EmbeddingTable,
                        rows) -> tbl.EmbeddingTable:
        """Clear ``initialized`` for the given rows (the serving keying
        layer's eviction)."""
        raise NotImplementedError

    def ages_init(self, table: tbl.EmbeddingTable):
        """(ages (n_rows, J), initialized (n_rows, J)) as numpy."""
        raise NotImplementedError

    def refresh_ages(self, table: tbl.EmbeddingTable) -> None:
        """Re-report device-plane ages to the eviction bookkeeping; a no-op
        for backends whose eviction never consults ages."""

    def flush_writebacks(self) -> None:
        """Wait until every pending device->host write-back has landed
        (none without a host tier)."""

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        self.publish_counters()
        d = self.counters.as_dict()
        d.update({
            "backend": type(self).__name__,
            "n_rows": self.n_rows,
            "device_rows": self.device_rows,
            "occupancy": self.occupancy(),
        })
        return d

    def occupancy(self) -> int:
        return 0


class DeviceStore(EmbeddingStore):
    """The device-resident backend: the whole table lives in device memory
    and row ids ARE the device rows."""

    def begin(self, row_ids, *, fetch: bool = True) -> PreparedMigration:
        slots = np.asarray(row_ids, np.int32)
        # count UNIQUE rows: callers pass pow2-padded row arrays whose
        # padding repeats the last row
        uniq = len(set(slots.tolist()))
        self.counters.lookups += uniq
        self.counters.hits += uniq
        self.publish_counters()
        return PreparedMigration(slots=slots)

    def commit(self, table, prep):
        return table

    def restore(self, table, shards=None):
        shards = range(self.num_shards) if shards is None else shards
        R = self.rows_per_shard
        out = self.init_shard_tables(shards)
        with torch.no_grad():
            for s, dst in zip(shards, out):
                for d, src in zip(dst, table):
                    part = src[s * R:min((s + 1) * R, self.n_rows)]
                    d[:part.shape[0]].copy_(part)
        return out

    def invalidate_rows(self, table, rows) -> tbl.EmbeddingTable:
        if len(rows) == 0:
            return table
        (rows_p,) = pad_rows_pow2(list(rows))
        return tbl.evict_rows(table, torch.as_tensor(rows_p, dtype=torch.long,
                                                     device=self.device))

    def ages_init(self, table):
        return (table.age[:self.n_rows].cpu().numpy(),
                table.initialized[:self.n_rows].cpu().numpy())

    def occupancy(self) -> int:
        return self.n_rows
