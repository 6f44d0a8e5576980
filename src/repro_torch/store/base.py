"""The embedding-store API of the port, and its device-resident backend.

Counterpart of ``src/repro/store/base.py:45-338``.  An ``EmbeddingStore``
owns WHICH rows of the historical table live in device memory; callers
address a plain ``EmbeddingTable`` of device rows through the row ids the
store hands back from ``prepare`` (or ``begin``, then ``commit``).
``DeviceStore`` keeps the whole table on the device, so row ids ARE device
rows and ``begin``/``commit`` are bookkeeping only; ``TieredStore``
(``store/tiered.py``) keeps a bounded set of rows on the device over a
host-RAM tier.

Row geometry (``src/repro/store/base.py:48-63,141-150``): ``n_rows`` rows
split block-wise over ``num_shards`` shards, shard s owning rows
[s·R, (s+1)·R) with R = ``rows_per_shard``; the last shard pads.  Each
shard owns its own (``device_rows_per_shard``, J, d) table
(``init_shard_tables``), as it would with one process per card.  Where the
reference passes one table sharded over its mesh, the port passes the list
of the shards' tables this process holds (one table where there is one
shard): ``commit``, ``snapshot``, ``refresh_ages``, ``ages_init`` and
``invalidate_rows`` take either, and ``restore`` returns the list.

The two-phase ``begin``/``commit`` split exists for the async pipeline:
``begin`` does the host work (residency bookkeeping, host-tier gather,
staging copies) and is safe on the feeder thread while a step runs;
``commit`` applies the staged migration to the live tables and must run in
``begin`` order on the consumer thread.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import ClassVar, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import embedding_table as tbl
from repro_torch.obs.metrics import get_registry


def rows_per_shard(n_rows: int, num_shards: int) -> int:
    """R such that D·R >= n (block row partition, last shard may pad)."""
    return -(-n_rows // max(num_shards, 1))


def padded_rows(n_rows: int, num_shards: int) -> int:
    return rows_per_shard(n_rows, num_shards) * max(num_shards, 1)


def device_rows_per_shard(n_rows: int, num_shards: int,
                          device_rows: int) -> int:
    """Device-tier rows per shard for a TOTAL cap of ``device_rows``:
    the cap split evenly over shards, clamped to [1, rows_per_shard]."""
    num_shards = max(num_shards, 1)
    per = -(-min(device_rows, padded_rows(n_rows, num_shards)) // num_shards)
    return max(1, min(rows_per_shard(n_rows, num_shards), per))


def shard_tables(tables):
    """(list of per-shard tables, whether one bare table was given)."""
    if isinstance(tables, tbl.EmbeddingTable):
        return [tables], True
    return list(tables), False


@dataclass
class StoreCounters:
    """Residency-traffic counters."""
    lookups: int = 0         # batch rows requested
    hits: int = 0            # already device-resident
    misses: int = 0          # faulted host -> device
    evictions: int = 0       # spilled device -> host
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    writeback_wait_ms: float = 0.0   # begin() blocked on pending write-backs
    # delta-gated write-back admission (TieredStore ``wb_threshold``):
    # evicted rows whose embedding moved less than the threshold skip the
    # host-tier emb write; bytes_d2h is settled down by the skipped emb
    # bytes when the writer thread lands the eviction
    wb_skipped_rows: int = 0
    wb_skipped_bytes: int = 0

    # the fields a process counts for its own shards only under torchrun
    # (the write-back lane settles the local host tiers); the others every
    # process counts for the whole table
    SHARD_LOCAL: ClassVar[tuple] = ("writeback_wait_ms", "wb_skipped_rows",
                                    "wb_skipped_bytes")

    def shard_local(self) -> dict:
        return {f: getattr(self, f) for f in self.SHARD_LOCAL}

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
            "wb_skipped_rows": self.wb_skipped_rows,
            "wb_skipped_bytes": self.wb_skipped_bytes,
            "writeback_wait_ms": round(self.writeback_wait_ms, 3),
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
    ("writeback_wait_ms", "store.writeback_wait_ms", "ms"),
    ("wb_skipped_rows", "store.wb_skipped_rows", "rows"),
    ("wb_skipped_bytes", "store.wb_skipped_bytes", "bytes"),
)


class PreparedMigration(NamedTuple):
    """Output of ``begin``: the batch's device rows plus the staged data
    movement ``commit`` applies.  The ``up_*`` and ``ev_*`` fields hold one
    entry for each shard this process holds (None where that shard moves
    nothing): its table's rows to write and the staged (emb, age,
    initialized) to write there, its rows to gather and the global rows
    they go home to.  ``up_ready`` is the CUDA event after which the
    staged uploads are on the device (None on the CPU)."""
    slots: np.ndarray                      # (B,) device rows for the batch
    ticket: int = 0
    n_up: int = 0                          # rows faulted in, all shards
    n_ev: int = 0                          # rows evicted, all shards
    up_slots: Optional[tuple] = None       # per local shard: (n,) long
    up_emb: Optional[tuple] = None         # per local shard: (n, J, d)
    up_age: Optional[tuple] = None         # per local shard: (n, J)
    up_init: Optional[tuple] = None        # per local shard: (n, J)
    up_ready: Optional[object] = None      # torch.cuda.Event or None
    ev_slots: Optional[tuple] = None       # per local shard: (m,) long
    ev_rows: Optional[tuple] = None        # per local shard: (m,) numpy


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
        if not hasattr(self, "_publish_mu"):   # first call is from __init__
            self._publish_mu = threading.Lock()
        with self._publish_mu:
            self._counters = c
            self._published = {f: getattr(c, f)
                               for f, _, _ in _COUNTER_METRICS}

    def publish_counters(self) -> None:
        """Mirror counter movement since the last publish into the metrics
        registry (no-op when metrics are disabled).  Callable from any
        thread: begin runs on the feeder, commit on the consumer, the
        delta gate's settlement on the writer."""
        reg = get_registry()
        if not reg.enabled:
            return
        with self._publish_mu:
            for field, name, unit in _COUNTER_METRICS:
                cur = getattr(self._counters, field)
                moved = cur - self._published[field]
                if moved:
                    reg.inc(name, moved, unit=unit)
                    self._published[field] = cur

    @property
    def row_bytes(self) -> int:
        """Bytes of one (emb, age, initialized) row triple, the unit a
        migration moves."""
        item = torch.empty((), dtype=self.dtype).element_size()
        return self.j_max * (self.d_h * item + 4 + 1)

    @property
    def device_rows_per_shard(self) -> int:
        return self.rows_per_shard

    @property
    def device_rows(self) -> int:
        return self.device_rows_per_shard * self.num_shards

    # -- residency ---------------------------------------------------------

    def begin(self, row_ids, *, fetch: bool = True,
              step: Optional[int] = None,
              pin: bool = False) -> PreparedMigration:
        """Make ``row_ids`` device-resident (``fetch`` False: their content
        is about to be overwritten, so only residency is needed).
        ``step``: the training step about to WRITE these rows, the
        stale-first eviction's refresh hint; ``pin``: keep these rows
        resident against later begins until ``release`` (lookahead)."""
        raise NotImplementedError

    def commit(self, tables, prep: PreparedMigration):
        """Apply ``prep`` to this process's shard tables (a list, or one
        table), in begin order; returns them in the same form."""
        raise NotImplementedError

    def prepare(self, tables, row_ids, *, fetch: bool = True,
                step: Optional[int] = None):
        """begin + commit in one call: (tables, device rows of row_ids)."""
        prep = self.begin(row_ids, fetch=fetch, step=step)
        return self.commit(tables, prep), prep.slots

    def release(self, prep: PreparedMigration) -> None:
        """Drop the residency pins ``begin(pin=True)`` took for this batch
        (a no-op where nothing pins)."""

    def resident_slot(self, row: int) -> Optional[int]:
        """Device row currently holding ``row`` (no LRU side effects), or
        None when the row lives in the host tier."""
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------

    def init_device_table(self) -> tbl.EmbeddingTable:
        """A fresh (all-uninitialized) device tier of one table."""
        return tbl.init_table(self.device_rows, self.j_max, self.d_h,
                              self.dtype, self.device)

    def init_shard_tables(self, shards=None):
        """Fresh device tiers of the given shards (default: all), one
        (device_rows_per_shard, J, d) table each."""
        shards = range(self.num_shards) if shards is None else shards
        return [tbl.init_table(self.device_rows_per_shard, self.j_max,
                               self.d_h, self.dtype, self.device)
                for _ in shards]

    def snapshot(self, tables) -> tbl.EmbeddingTable:
        """The whole logical table (n_rows, J, d) on the host, both tiers
        merged: the checkpointable view of the store.  ``tables``: every
        shard's table (what ``restore`` returns), or one table."""
        raise NotImplementedError

    def restore(self, snap: tbl.EmbeddingTable, shards=None):
        """Reset from a dense (n_rows, J, d) table; returns the device
        tiers of the given shards (default: this process's)."""
        raise NotImplementedError

    def invalidate_rows(self, tables, rows):
        """Clear ``initialized`` for the given rows in whichever tier holds
        them (the serving keying layer's eviction)."""
        raise NotImplementedError

    def ages_init(self, tables):
        """(ages (n_rows, J), initialized (n_rows, J)) as numpy."""
        raise NotImplementedError

    def local_ages_init(self, tables):
        """(ages, initialized) of this process's shards, each shard's
        rows_per_shard rows in shard order, as numpy: a torchrun run
        gathers them from every rank into ``ages_init``'s view."""
        raise NotImplementedError

    def _counter_lock(self):
        return self._publish_mu

    def fold_counters(self, moved: dict) -> None:
        """Add another process's shard-local counter movement (the
        ``StoreCounters.SHARD_LOCAL`` fields) to this store's counters, so
        rank 0 of a torchrun run counts what one store over every shard
        does; the skipped write-back bytes were counted as moved."""
        with self._counter_lock():
            for f, v in moved.items():
                setattr(self._counters, f, getattr(self._counters, f) + v)
            self._counters.bytes_d2h -= moved["wb_skipped_bytes"]

    def refresh_ages(self, tables) -> None:
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
            "device_rows": min(self.device_rows, self.padded_rows),
            "occupancy": self.occupancy(),
        })
        return d

    def occupancy(self) -> int:
        return 0


class DeviceStore(EmbeddingStore):
    """The device-resident backend: the whole table lives in device memory
    and row ids ARE the device rows."""

    def begin(self, row_ids, *, fetch: bool = True,
              step: Optional[int] = None,
              pin: bool = False) -> PreparedMigration:
        slots = np.asarray(row_ids, np.int32)
        # count UNIQUE rows, like TieredStore.begin, so the counters are
        # comparable across backends
        uniq = len(set(slots.tolist()))
        self.counters.lookups += uniq
        self.counters.hits += uniq
        self.publish_counters()
        return PreparedMigration(slots=slots)

    def commit(self, tables, prep):
        return tables

    def resident_slot(self, row: int) -> Optional[int]:
        return int(row)

    def snapshot(self, tables) -> tbl.EmbeddingTable:
        tables, _ = shard_tables(tables)
        if len(tables) == 1:
            return tbl.EmbeddingTable(*(t[:self.n_rows].cpu().clone()
                                        for t in tables[0]))
        if len(tables) != self.num_shards:
            raise ValueError("snapshot needs every shard's table")
        return tbl.EmbeddingTable(*(
            torch.cat([t[k].cpu() for t in tables])[:self.n_rows]
            for k in range(3)))

    def restore(self, snap, shards=None):
        shards = range(self.num_shards) if shards is None else shards
        R = self.rows_per_shard
        out = self.init_shard_tables(shards)
        with torch.no_grad():
            for s, dst in zip(shards, out):
                for d, src in zip(dst, snap):
                    part = torch.as_tensor(
                        src[s * R:min((s + 1) * R, self.n_rows)])
                    d[:part.shape[0]].copy_(part)
        return out

    def invalidate_rows(self, tables, rows):
        if len(rows) == 0:
            return tables
        (table,), single = shard_tables(tables)
        rows_t = torch.as_tensor(np.asarray(rows), dtype=torch.long,
                                 device=self.device)
        table = tbl.evict_rows(table, rows_t)
        return table if single else [table]

    def ages_init(self, tables):
        tables, _ = shard_tables(tables)
        if len(tables) != self.num_shards:
            raise ValueError("ages_init needs every shard's table")
        return tuple(x[:self.n_rows] for x in self.local_ages_init(tables))

    def local_ages_init(self, tables):
        tables, _ = shard_tables(tables)
        return tuple(torch.cat([getattr(t, k).cpu() for t in tables]).numpy()
                     for k in ("age", "initialized"))

    def occupancy(self) -> int:
        return min(self.n_rows, self.device_rows)
