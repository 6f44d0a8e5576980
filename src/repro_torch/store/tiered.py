"""TieredStore: a bounded device tier of hot rows over a host-RAM tier.

Counterpart of ``src/repro/store/tiered.py:57-553``.  FreshGNN's regime
(PAPERS.md): the historical table outgrows device memory, but historical
embeddings are STABLE, so a small device-resident set of hot rows backed
by host memory captures most traffic.  Per shard:

        host tier  (R rows; pinned tensors on cuda, ordinary memory on the
            ▲       CPU; authoritative for non-resident rows)
            │  eviction write-back: gathered on the compute stream, copied
            │  device -> host on a side stream, landed in the host tier by
            │  the AsyncHostWriter thread
            ▼  miss fetch: staged in begin() (a pinned buffer a ticket,
            │  host -> device on a side stream), applied in commit()
      device tier  (C <= R rows = "slots", store/slots.SlotMap, eviction
                    ``evict_policy`` "lru" or age-aware "stale-first")

A global row r lives on shard ``r // R``; when resident it occupies row
``slot`` of that shard's (C, J, d) table, and the step addresses it as
``shard·C + slot``, so the exchange's owner arithmetic (``id // rows``)
works unchanged on slot ids with rows = C (``DistContext.table_rows``).

Invariants (tests/test_torch_store_props.py):
  * device-tier occupancy never exceeds C per shard;
  * every row is authoritative in EXACTLY one tier (pending write-backs
    count as device rows until the writer lands them);
  * a slot holds its row's (emb, age, initialized) triple bit for bit, so
    any eviction or fetch sequence is invisible to the training math.

Where the reference jits a gather that makes a new buffer, the port's
steps write the table in place, so the eviction content is a COPY
(``index_select``) taken on the compute stream before the upload's
``index_copy_``; later in-place writes to the table cannot reach it.
That device half of a commit is the memory probe's ``store.migrate``
(uploads and evictions), ``store.upload`` or ``store.gather`` site, and
``publish_counters`` gauges the host tier as ``store.host_tier``.

Concurrency: ``begin`` may run on the feeder thread while a step runs (it
touches host bookkeeping and fresh staging buffers only, and copies on its
own stream); ``commit`` runs on the consumer thread in begin order (the
compute stream waits for the staged copy's event there).  A fetch of a row
whose write-back is still pending waits for it to land.

``local_shards``: the shards whose tables this process holds (default
all; one under torchrun).  The residency bookkeeping runs for every shard,
so every process hands out the same slot ids; host tiers, staging and
write-backs exist for the local shards only.  Stale-first eviction reads
ages from the host and device tiers, so it needs every shard local.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import embedding_table as tbl
from repro_torch.obs.memory import get_probe, probe_call
from repro_torch.obs.trace import span
from repro_torch.store.base import (EmbeddingStore, PreparedMigration,
                                    device_rows_per_shard, shard_tables)
from repro_torch.store.forecast import RowForecaster
from repro_torch.store.slots import SlotMap
from repro_torch.store.writeback import AsyncHostWriter, delta_gate


class TieredStore(EmbeddingStore):
    def __init__(self, n_rows: int, j_max: int, d_h: int, *,
                 device_rows: int, num_shards: int = 1, dtype=torch.float32,
                 device="cpu", local_shards=None,
                 writer: Optional[AsyncHostWriter] = None,
                 evict_policy: str = "lru", wb_threshold: float = 0.0,
                 stale_forecast: bool = False):
        super().__init__(n_rows, j_max, d_h, num_shards=num_shards,
                         dtype=dtype, device=device)
        self._C = device_rows_per_shard(n_rows, self.num_shards, device_rows)
        self.local_shards = (tuple(range(self.num_shards))
                             if local_shards is None else tuple(local_shards))
        self.evict_policy = evict_policy
        if evict_policy != "lru" and len(self.local_shards) != self.num_shards:
            raise ValueError(
                "stale-first eviction scores rows by ages held in every "
                "shard's tiers: it needs all shards in one process")
        # delta-gated write-back admission (--wb-threshold, FreshGNN): an
        # evicted row whose embedding moved less than this (max-abs vs the
        # stale host copy it faulted in from) skips the host-tier emb
        # write.  0.0 disables the gate: every eviction writes back and
        # the store stays bit-exact vs the device-resident store.
        self.wb_threshold = float(wb_threshold)
        # stale-row forecasting (--stale-forecast): an online per-row
        # velocity EMA fed by the eviction delta stream; fault-ins with a
        # step hint are extrapolated forward by their age.  None (the
        # default) leaves every staged upload bit-identical.
        self._forecaster = RowForecaster(self.padded_rows, j_max, d_h) \
            if stale_forecast else None
        self._maps = [SlotMap(self._C, policy=evict_policy)
                      for _ in range(self.num_shards)]
        self._cuda = self.device.type == "cuda"
        self._host = {s: self._host_tier() for s in self.local_shards}
        if self._cuda:
            # the staging copies' own streams: host -> device (begin, maybe
            # on the feeder thread) and device -> host (commit's evictions)
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._writer = writer if writer is not None else AsyncHostWriter()
        self._own_writer = writer is None
        self._mu = threading.Condition()
        self._begin_mu = threading.RLock()
        self._pending: Dict[int, int] = {}   # row -> evicting begin ticket
        # lookahead pinning: tickets begun with ``pin=True`` keep their rows
        # displacement-proof until the caller calls ``release(prep)``
        self._live_pins: Dict[int, set] = {}  # ticket -> pinned rows
        self._begin_ticket = 0
        self._commit_next = 1
        self._done_ticket = 0
        self._wb_exc: Optional[BaseException] = None  # failed write-back
        # memory-probe sites, one a commit by what it moves (the
        # reference's three migration jits)
        self._migrate = probe_call("store.migrate", self._move)
        self._upload = probe_call("store.upload", self._move)
        self._gather_ev = probe_call("store.gather", self._move)

    def _host_tier(self) -> tbl.EmbeddingTable:
        """One shard's host tier, zeros: pinned on cuda (an error where
        pinning fails; there is no pageable tier), ordinary on the CPU."""
        R, J, d = self.rows_per_shard, self.j_max, self.d_h
        pin = self.device.type == "cuda"
        return tbl.EmbeddingTable(
            torch.zeros(R, J, d, dtype=self.dtype, pin_memory=pin),
            torch.zeros(R, J, dtype=torch.int32, pin_memory=pin),
            torch.zeros(R, J, dtype=torch.bool, pin_memory=pin))

    # -- geometry ----------------------------------------------------------

    @property
    def device_rows_per_shard(self) -> int:
        return self._C

    def occupancy(self) -> int:
        return sum(len(m) for m in self._maps)

    def resident_slot(self, row: int) -> Optional[int]:
        shard = int(row) // self.rows_per_shard
        slot = self._maps[shard].get(int(row), touch=False)
        return None if slot is None else shard * self._C + slot

    def _split(self, row: int):
        """(shard, row within the shard's host tier)."""
        R = self.rows_per_shard
        return row // R, row - (row // R) * R

    # -- residency ---------------------------------------------------------

    def begin(self, row_ids, *, fetch: bool = True,
              step: Optional[int] = None,
              pin: bool = False) -> PreparedMigration:
        """Host half of a migration: residency bookkeeping and staging.

        Safe on the feeder thread while a step runs.  With ``fetch=False``
        missing rows are made resident WITHOUT copying host content up
        (their slots hold stale data until the caller overwrites them:
        the serving cache's insert path).

        ``step``: refresh hint for stale-first eviction, the training step
        about to WRITE these rows (train and refresh paths; nothing for
        read-only paths like finetune lookups).  ``pin``: lookahead
        pinning, this batch's rows stay displacement-proof against LATER
        begins until ``release(prep)``; every later begin honours live
        pins whether or not it pins itself."""
        with span("store.begin"):
            prep = self._begin_impl(row_ids, fetch=fetch, step=step, pin=pin)
        self.publish_counters()
        return prep

    def _begin_impl(self, row_ids, *, fetch: bool,
                    step: Optional[int], pin: bool) -> PreparedMigration:
        ids = np.asarray(row_ids).ravel()
        R, C = self.rows_per_shard, self._C
        with self._begin_mu:
            # validate the WHOLE batch before touching any residency state,
            # so a bad batch raises cleanly instead of leaving half-reserved
            # slots and an uncommittable ticket behind
            uniq = list(dict.fromkeys(int(r) for r in ids))
            live: set = set().union(*self._live_pins.values()) \
                if self._live_pins else set()
            per_shard: Dict[int, int] = {}
            for rid in uniq:
                if not 0 <= rid < self.n_rows:
                    raise IndexError(
                        f"row {rid} outside table [0, {self.n_rows})")
                per_shard[rid // R] = per_shard.get(rid // R, 0) + 1
            worst = max(per_shard.values(), default=0)
            if worst > C:
                raise RuntimeError(
                    f"device tier exhausted: shard "
                    f"{max(per_shard, key=per_shard.get)} needs {worst} "
                    f"resident rows for one batch but has only {C} device "
                    "rows; raise the device-row cap (--table-device-rows) "
                    "to at least the per-shard batch row count")
            if live:
                # a live-pinned previous batch shrinks the displaceable
                # pool: this batch's rows AND the pinned ones must coexist
                both: Dict[int, int] = {}
                for rid in set(uniq) | live:
                    both[rid // R] = both.get(rid // R, 0) + 1
                worst_b = max(both.values(), default=0)
                if worst_b > C:
                    raise RuntimeError(
                        f"device tier exhausted under lookahead pinning: "
                        f"shard {max(both, key=both.get)} needs {worst_b} "
                        "resident rows (this batch + the pinned in-flight "
                        f"batch) but has only {C} device rows")
            self._begin_ticket += 1
            ticket = self._begin_ticket
            pinned = set(uniq) | live
            if pin:
                self._live_pins[ticket] = set(uniq)
            slot_of: Dict[int, int] = {}
            uploads: List[tuple] = []   # (row, shard, slot)
            evicts: List[tuple] = []    # (row, shard, slot)
            deferred_age: List[int] = []
            n_hit = 0
            for rid in uniq:
                shard = rid // R
                m = self._maps[shard]
                slot = m.get(rid)
                if slot is None:
                    slot, displaced = m.reserve(rid, pinned=pinned)
                    if slot is None:   # excluded by the demand check above
                        raise RuntimeError("no displaceable slot")
                    if displaced is not None:
                        evicts.append((displaced[0], shard, displaced[1]))
                    uploads.append((rid, shard, slot))
                    if self.evict_policy != "lru":
                        # stale-first scores by the age the row carried in
                        # from the host tier; a step hint means the step is
                        # about to rewrite the row: no host read needed
                        if step is not None:
                            m.set_age(rid, int(step))
                        else:
                            deferred_age.append(rid)
                else:
                    n_hit += 1
                    if self.evict_policy != "lru" and step is not None:
                        m.set_age(rid, int(step))  # about to be rewritten
                slot_of[rid] = shard * C + slot
            slots = np.asarray([slot_of[int(r)] for r in ids], np.int32)
            local = set(self.local_shards)
            with self._mu:
                # lookups count UNIQUE rows, so hits + misses == lookups
                self.counters.lookups += len(uniq)
                self.counters.hits += n_hit
                self.counters.misses += len(uploads)
                for row, shard, _ in evicts:
                    if shard in local:
                        self._pending[row] = ticket
            if deferred_age:
                # host ages are authoritative only once any in-flight
                # write-back of these rows has landed
                self._wait_rows(deferred_age)
                for rid in deferred_age:
                    s, r = self._split(rid)
                    self._maps[s].set_age(
                        rid, int(self._host[s].age[r].max()))
            prep = dict(slots=slots, ticket=ticket, n_ev=len(evicts),
                        n_up=len(uploads) if fetch else 0)
            if evicts:
                prep.update(self._stage_evictions(evicts))
            if uploads and fetch:
                self._wait_rows([r for r, s, _ in uploads if s in local])
                prep.update(self._stage_uploads(uploads, step))
                with self._mu:
                    self.counters.bytes_h2d += len(uploads) * self.row_bytes
            return PreparedMigration(**prep)

    def _by_shard(self, moves):
        """Local shard position -> [(row, slot)] of ``moves``."""
        out = [[] for _ in self.local_shards]
        pos = {s: i for i, s in enumerate(self.local_shards)}
        for row, shard, slot in moves:
            if shard in pos:
                out[pos[shard]].append((row, slot))
        return out

    def _gather_host(self, x: torch.Tensor, rows: torch.Tensor):
        """x[rows], a fresh buffer: pinned on cuda, for the async copy."""
        out = torch.empty((rows.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, pin_memory=self._cuda)
        return torch.index_select(x, 0, rows, out=out)

    def _to_device(self, tensors):
        """CPU tensors -> the store's device.  On cuda from pinned copies,
        on the host -> device stream, with the event the compute stream
        waits for in commit; on the CPU, the tensors themselves."""
        if not self._cuda:
            return tensors, None
        with torch.cuda.stream(self._h2d):
            out = [None if t is None else
                   (t if t.is_pinned() else t.pin_memory()).to(
                       self.device, non_blocking=True)
                   for t in tensors]
            ready = torch.cuda.Event()
            ready.record(self._h2d)
        return out, ready

    def _stage_evictions(self, evicts) -> dict:
        parts = self._by_shard(evicts)
        slots, ready = self._to_device(
            [torch.tensor([g for _, g in p], dtype=torch.long) if p else None
             for p in parts])
        return dict(ev_slots=tuple(slots),
                    ev_rows=tuple(np.asarray([r for r, _ in p], np.int64)
                                  if p else None for p in parts),
                    up_ready=ready)

    def _stage_uploads(self, uploads, step) -> dict:
        """Gather the faulted rows from the host tier into a fresh staging
        buffer a shard and send them to the device."""
        parts = self._by_shard(uploads)
        staged = []
        for shard, p in zip(self.local_shards, parts):
            if not p:
                staged += [None] * 4
                continue
            rows = np.asarray([r for r, _ in p], np.int64)
            local = torch.from_numpy(rows - shard * self.rows_per_shard)
            emb, age, init = (self._gather_host(x, local)
                              for x in self._host[shard])
            if self._forecaster is not None and step is not None:
                # serve the extrapolated row on fault-in; the
                # authoritative host copy is untouched
                emb = torch.from_numpy(self._forecaster.apply(
                    rows, emb.numpy(), age.numpy(), init.numpy(), int(step)))
            staged += [torch.tensor([g for _, g in p], dtype=torch.long),
                       emb, age, init]
        dev, ready = self._to_device(staged)
        out = {k: tuple(dev[i::4]) for i, k in enumerate(
            ("up_slots", "up_emb", "up_age", "up_init"))}
        out["up_ready"] = ready
        return out

    def release(self, prep: PreparedMigration) -> None:
        """Drop the lookahead pins ``begin(pin=True)`` took for this batch
        (after its step is enqueued: a later commit's migration runs after
        it on the compute stream)."""
        with self._begin_mu:
            self._live_pins.pop(prep.ticket, None)

    def commit(self, tables, prep: PreparedMigration):
        """Device half: apply the staged migration to this process's shard
        tables (a list in ``local_shards`` order, or one table), in begin
        order, and hand the evicted content to the write-back thread."""
        with span("store.commit", n_up=prep.n_up, n_ev=prep.n_ev):
            tables = self._commit_impl(tables, prep)
        self.publish_counters()
        return tables

    @torch.no_grad()
    def _commit_impl(self, tables, prep: PreparedMigration):
        if prep.ticket != self._commit_next:
            raise RuntimeError(
                f"commit order violated: expected ticket {self._commit_next}, "
                f"got {prep.ticket}")
        tlist, single = shard_tables(tables)
        if len(tlist) != len(self.local_shards):
            raise ValueError(f"commit got {len(tlist)} tables for "
                             f"{len(self.local_shards)} local shards")
        self._commit_next += 1
        cur = torch.cuda.current_stream(self.device) if self._cuda else None
        if prep.up_ready is not None:
            cur.wait_event(prep.up_ready)
        fields = [prep.ev_slots, prep.up_slots, prep.up_emb, prep.up_age,
                  prep.up_init]
        staged = [[None if f is None else f[i] for f in fields]
                  for i in range(len(tlist))]
        if self._cuda:
            # the staged tensors came from the host -> device stream
            for t in (t for shard in staged for t in shard):
                if t is not None:
                    t.record_stream(cur)
        evs = [None] * len(tlist)
        if prep.n_up and prep.n_ev:
            evs = self._migrate(tlist, staged)
        elif prep.n_up:
            evs = self._upload(tlist, staged)
        elif prep.n_ev:
            evs = self._gather_ev(tlist, staged)
        going_home = [(self.local_shards[i], prep.ev_rows[i],
                       self._to_host(ev, cur))
                      for i, ev in enumerate(evs) if ev is not None]
        if prep.n_ev:
            with self._mu:
                self.counters.evictions += prep.n_ev
                self.counters.bytes_d2h += prep.n_ev * self.row_bytes
        if going_home:
            # one thunk a ticket: the ticket counts as landed only once
            # every shard's rows have
            landed = None
            if self._cuda:
                landed = torch.cuda.Event()
                landed.record(self._d2h)
            self._writer.submit(self._writeback_thunk(going_home,
                                                      prep.ticket, landed))
        return tlist[0] if single else tlist

    @staticmethod
    def _move(tables, staged):
        """The device half of a migration on every local shard's table:
        the evicted rows gathered (a copy) BEFORE the uploads land in
        place.  ``staged`` a shard: (ev_slots, up_slots, emb, age, init),
        each None where the shard has none.  Returns each shard's evicted
        (emb, age, init), or None."""
        evs = []
        for table, (ev_slots, up_slots, *up) in zip(tables, staged):
            evs.append(None if ev_slots is None
                       else [x.index_select(0, ev_slots) for x in table])
            if up_slots is not None:
                for x, u in zip(table, up):
                    x.index_copy_(0, up_slots, u)
        return evs

    def _to_host(self, ev, cur):
        """The evicted (emb, age, init) on the host: on cuda copied into
        pinned buffers on the device -> host stream, after the gather on
        the compute stream ``cur``; on the CPU, the gathered copies."""
        if not self._cuda:
            return ev
        gathered = torch.cuda.Event()
        gathered.record(cur)
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(gathered)
            host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in ev]
            for h, x in zip(host, ev):
                h.copy_(x, non_blocking=True)
                x.record_stream(self._d2h)
        return host

    def _writeback_thunk(self, going_home, ticket, landed):
        def write():
            n = sum(len(rows) for _, rows, _ in going_home)
            with span("store.writeback", rows=n):
                try:
                    if landed is not None:
                        landed.synchronize()  # the device -> host copies
                    for shard, rows, ev in going_home:
                        self._writeback_body(ev, rows, shard)
                except BaseException as e:
                    with self._mu:
                        if self._wb_exc is None:
                            self._wb_exc = e
                    raise   # AsyncHostWriter also records it for flush()
                finally:
                    # ALWAYS advance the ticket (failure included) so a
                    # waiter raises the stored exception instead of
                    # waiting forever
                    with self._mu:
                        self._done_ticket = ticket
                        for _, rows, _ in going_home:
                            for r in rows:
                                if self._pending.get(int(r)) == ticket:
                                    del self._pending[int(r)]
                        self._mu.notify_all()
            self.publish_counters()
        return write

    def _writeback_body(self, ev, rows, shard):
        """Land one shard's evicted rows in its host tier."""
        emb, age, init = (x.numpy() for x in ev)
        host = tbl.EmbeddingTable(*(x.numpy() for x in self._host[shard]))
        local = rows - shard * self.rows_per_shard
        if self._forecaster is not None:
            # the host copy is still the fault-in-time content here
            # (read BEFORE the writes below): one (Δemb, Δstep)
            # residency observation per evicted row
            self._forecaster.observe(
                rows, emb, host.emb[local], age, host.age[local],
                init, host.initialized[local])
        if self.wb_threshold > 0.0:
            # the host copy is the row's content when it faulted in,
            # so this measures how far the row moved while resident
            admit = delta_gate(emb, host.emb[local], init,
                               host.initialized[local], self.wb_threshold)
            nskip = int(len(rows) - admit.sum())
            if nskip:
                # emb bytes of skipped rows never reach the host tier:
                # settle the eager bytes_d2h from commit (ages and init
                # still land, so staleness bookkeeping stays exact)
                emb_bytes = self.j_max * self.d_h * emb.dtype.itemsize
                with self._mu:
                    self.counters.wb_skipped_rows += nskip
                    self.counters.wb_skipped_bytes += nskip * emb_bytes
                    self.counters.bytes_d2h -= nskip * emb_bytes
            host.emb[local[admit]] = emb[admit]
        else:
            host.emb[local] = emb
        host.age[local] = age
        host.initialized[local] = init

    def _raise_wb_exc_locked(self):
        if self._wb_exc is not None:
            exc, self._wb_exc = self._wb_exc, None
            raise RuntimeError("eviction write-back failed: the host tier "
                               "is no longer trustworthy") from exc

    def _wait_rows(self, rows) -> None:
        """Block until pending write-backs covering ``rows`` have landed."""
        with self._mu:
            need = max((self._pending.get(int(r), 0) for r in rows),
                       default=0)
            self._raise_wb_exc_locked()
        if not need:
            return
        t0 = time.perf_counter()
        with self._mu:
            while self._done_ticket < need and self._wb_exc is None:
                self._mu.wait(timeout=0.05)
            self._raise_wb_exc_locked()
            self.counters.writeback_wait_ms += (time.perf_counter() - t0) * 1e3

    # -- lifecycle ---------------------------------------------------------

    def _assert_quiescent(self):
        if self._begin_ticket != self._commit_next - 1:
            raise RuntimeError(
                "store has begun-but-uncommitted migrations: drain the "
                "feeder before snapshot/restore")

    def flush_writebacks(self) -> None:
        self._writer.flush()

    def host_tier_bytes(self) -> int:
        """Bytes of the local host tiers (pinned on cuda)."""
        return sum(x.numel() * x.element_size()
                   for h in self._host.values() for x in h)

    def publish_counters(self) -> None:
        super().publish_counters()
        p = get_probe()
        if p.enabled:
            p.observe_host("store.host_tier", self.host_tier_bytes())

    def _resident(self, shard: int):
        """(rows within the shard, slots) of the shard's resident rows."""
        items = list(self._maps[shard].items())
        R = self.rows_per_shard
        return (np.asarray([r - shard * R for r, _ in items], np.int64),
                np.asarray([s for _, s in items], np.int64))

    def _merged(self, tables, planes, local: bool = False):
        """The given planes (indices into the triple) of every shard's
        host tier with the resident rows overlaid from the device tables,
        joined and cut to n_rows, on the host (``local``: this process's
        shards, uncut)."""
        tlist, _ = shard_tables(tables)
        if not local and len(self.local_shards) != self.num_shards:
            raise ValueError("a merged view needs every shard's tables in "
                             "this process")
        out = []
        for k in planes:
            parts = []
            for shard, table in zip(self.local_shards, tlist):
                host = self._host[shard][k].clone()
                rows, slots = self._resident(shard)
                if rows.size:
                    host[torch.from_numpy(rows)] = table[k][
                        torch.from_numpy(slots).to(self.device)].cpu()
                parts.append(host)
            out.append(torch.cat(parts) if local
                       else torch.cat(parts)[:self.n_rows])
        return out

    def snapshot(self, tables) -> tbl.EmbeddingTable:
        """Dense (n_rows, J, d) host view: the host tier overlaid with
        every device-resident row, the checkpointable whole table.  Flushes
        the write-back lane first; refuses while migrations are begun but
        not committed."""
        self._assert_quiescent()
        self._writer.flush()
        return tbl.EmbeddingTable(*self._merged(tables, (0, 1, 2)))

    def restore(self, snap, shards=None):
        """Reset from a dense snapshot: every row starts in the host tier
        and the device tier comes back empty (residency is not semantic
        state: the first batches re-fault their rows).  Returns the local
        shards' fresh device tables."""
        shards = self.local_shards if shards is None else tuple(shards)
        if shards != self.local_shards:
            raise ValueError(f"restore makes the local shards' tables "
                             f"{self.local_shards}, not {shards}")
        self._assert_quiescent()
        self._writer.flush()
        for m in self._maps:
            m.clear()
        with self._begin_mu:
            self._live_pins.clear()
        with self._mu:
            self._pending.clear()
        R = self.rows_per_shard
        for shard, host in self._host.items():
            for h, src in zip(host, snap):
                part = torch.as_tensor(src[shard * R:min((shard + 1) * R,
                                                         self.n_rows)])
                h.zero_()
                h[:part.shape[0]].copy_(part)
        return self.init_shard_tables(shards)

    def invalidate_rows(self, tables, rows):
        if len(rows) == 0:
            return tables
        tlist, single = shard_tables(tables)
        pos = {s: i for i, s in enumerate(self.local_shards)}
        dev: Dict[int, List[int]] = {}
        host_rows = []
        for r in rows:
            shard, local = self._split(int(r))
            if shard not in pos:
                continue
            slot = self._maps[shard].get(int(r), touch=False)
            if slot is not None:
                dev.setdefault(shard, []).append(slot)
            else:
                host_rows.append(int(r))
        if host_rows:
            self._wait_rows(host_rows)
            for r in host_rows:
                shard, local = self._split(r)
                self._host[shard].initialized[local] = False
        for shard, slots in dev.items():
            i = pos[shard]
            tlist[i] = tbl.evict_rows(tlist[i], torch.as_tensor(
                slots, dtype=torch.long, device=self.device))
        return tlist[0] if single else tlist

    def refresh_ages(self, tables) -> None:
        """Re-report TRUE ages for every device-resident row to the
        eviction SlotMaps: SlotMap ages are otherwise only fed at fault-in
        and step-hinted begins, so a row refreshed while resident would
        keep scoring as stale as its fault-in copy.  Reads the device age
        planes back (one copy a shard), so call it at epoch granularity.
        No-op under plain LRU."""
        if self.evict_policy == "lru":
            return
        tlist, _ = shard_tables(tables)
        R = self.rows_per_shard
        for shard, table in zip(self.local_shards, tlist):
            dev_age = table.age.cpu().numpy()
            rows, slots = self._resident(shard)
            for row, slot in zip(rows, slots):
                self._maps[shard].set_age(int(row) + shard * R,
                                          int(dev_age[slot].max()))

    def ages_init(self, tables):
        """(ages, initialized) over both tiers as numpy.  A stats-grade
        view: no writer flush, so a row with an in-flight write-back may
        read one migration stale; ``snapshot`` is the consistent view."""
        age, init = self._merged(tables, (1, 2))
        return age.numpy(), init.numpy()

    def local_ages_init(self, tables):
        age, init = self._merged(tables, (1, 2), local=True)
        return age.numpy(), init.numpy()

    def _counter_lock(self):
        return self._mu

    def close(self) -> None:
        if self._own_writer:
            self._writer.close()

    def stats(self) -> dict:
        d = super().stats()
        d.update({
            "device_rows_per_shard": self._C,
            "host_rows": self.padded_rows,
            "occupancy_frac": self.occupancy() / max(self.device_rows, 1),
            "pending_writebacks": self._writer.pending,
            "evict_policy": self.evict_policy,
            "wb_threshold": self.wb_threshold,
            "stale_forecast": self._forecaster is not None,
        })
        if self._forecaster is not None:
            d["forecast"] = self._forecaster.stats()
        return d
