"""Data-parallel GST training with the row-sharded table.

Counterpart of ``src/repro/dist/train.py``.  Where the JAX package wraps the unchanged step functions of
``core/gst.py`` in ``shard_map``, the port runs one step per shard, each
in its own thread (``LocalGroup``) or process (``ProcessGroup``), with:

  * backbone, head and AdamW state REPLICATED: every shard keeps its own
    replica and applies the same averaged gradients, so after each step
    all replicas are bitwise equal;
  * the historical table ROW-SHARDED: shard k holds rows [k·R, (k+1)·R)
    as its own (R, J, d) tensors, reached through the context's exchange
    strategy (``dist/exchange.py``); with a device-row cap each shard's
    table holds C rows of a ``TieredStore`` split over the shards, and the
    step addresses slot ids (``DistContext.table_rows`` = C);
  * the batch split on its leading dim, each row carrying its global
    position ``batch_pos``, so every row draws what the single-device
    step draws for it (``core/segment.py::per_row_keys``);
  * gradients, loss and metric averaged over the shards inside the step
    (``core/gst.py``'s ``comm``).

A distributed state is the list of the shards' ``TrainState``s held by
this process, in local order; a distributed batch the list of their
batches.

The prefetch lane (``ctx.prefetch``): the next batch's lookup runs as its
own collective (``make_prefetch_lookup``) before the current step, which
reads its own (already patched) prefetched pair instead of looking up,
and writes back through ``update_sampled_patch``, handing out the next
batch's pair patched.  Where the JAX step donates the table and relies on
dispatch order, the port keeps one stream a card: the lookup is enqueued
after the next batch's migration commit and before the step's in-place
write.  The kernels run per shard unchanged: each shard hands them its
(B/D)·S segments and they never see the other shards.

Each top-level step is a memory-probe site (``dist.train_step``,
``dist.prefetch_lookup``, ``dist.eval_step``, ``dist.refresh_step``,
``dist.finetune_step``), its record the whole card's for the local
shards; each shard runs through ``obs/memory.py::in_shard``.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core import embedding_table as tbl
from repro_torch.core import gst as G
from repro_torch.dist import table as dtbl
from repro_torch.dist.exchange import (EXCHANGES, PAYLOAD_DTYPES, Exchange,
                                       make_exchange)
from repro_torch.obs.memory import in_shard, probe_call
from repro_torch.store import (DeviceStore, EmbeddingStore, TieredStore,
                               device_rows_per_shard)


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DistContext:
    """Static facts every distributed step needs."""
    group: Any                 # comm.LocalGroup or comm.ProcessGroup
    num_shards: int
    n_rows: int                # unpadded historical-table rows
    rows_per_shard: int
    # device-resident rows PER SHARD when the table is tiered (store/),
    # None = the whole table on the device.  The exchange routes by
    # ``id // table_rows``: under a tiered store the ids the step sees are
    # device-row ("slot") ids, whose owner arithmetic uses C
    device_rows_per_shard: Optional[int] = None
    # table-exchange strategy: "ring", "alltoall" or "bucketed" ("auto" is
    # resolved by the launcher with select_exchange before make_context)
    exchange: str = "ring"
    # bucketed only: host-planned per-(shard, owner) bucket capacity
    exchange_cap: Optional[int] = None
    # wire format of the exchanged embeddings: "f32", "bf16" or "int8"
    payload_dtype: str = "f32"
    # pack/unpack through the kernels (False: their plain versions)
    use_kernels: bool = True
    # the prefetch lane (--prefetch-lookups): the train step consumes a
    # prefetched lookup of its batch and patches the next batch's
    # (make_prefetch_lookup, exchange.update_sampled_patch)
    prefetch: bool = False
    # bucketed only: host-planned per-(shard, consumer) patch bucket
    # capacity (exchange.plan_patch_capacity); None = the local batch
    patch_cap: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def table_rows(self) -> int:
        """Rows per shard OF THE TABLE THE STEP SEES (exchange owner
        arithmetic)."""
        return self.device_rows_per_shard or self.rows_per_shard

    @property
    def local_ranks(self) -> List[int]:
        return self.group.local_ranks


def make_context(group, n_rows: int, device_rows: Optional[int] = None, *,
                 exchange: str = "ring",
                 exchange_cap: Optional[int] = None,
                 payload_dtype: str = "f32",
                 use_kernels: bool = True,
                 prefetch: bool = False,
                 patch_cap: Optional[int] = None) -> DistContext:
    """``device_rows``: the total device-resident row cap (the
    --table-device-rows knob); None keeps the whole table on the device.
    ``prefetch``/``patch_cap``: the prefetch lane (see DistContext)."""
    if exchange not in EXCHANGES:
        raise ValueError(
            f"unknown exchange strategy {exchange!r}: expected one of "
            f"{EXCHANGES}; resolve 'auto' with exchange.select_exchange "
            "before make_context")
    if payload_dtype not in PAYLOAD_DTYPES:
        raise ValueError(f"unknown payload dtype {payload_dtype!r}: expected "
                         f"one of {PAYLOAD_DTYPES}")
    d = group.size
    per_shard = None if device_rows is None else \
        device_rows_per_shard(n_rows, d, device_rows)
    return DistContext(group=group, num_shards=d, n_rows=n_rows,
                       rows_per_shard=dtbl.rows_per_shard(n_rows, d),
                       device_rows_per_shard=per_shard,
                       exchange=exchange, exchange_cap=exchange_cap,
                       payload_dtype=payload_dtype, use_kernels=use_kernels,
                       prefetch=prefetch, patch_cap=patch_cap)


def make_dist_store(ctx: DistContext, j_max: int, d_h: int,
                    dtype=torch.float32, evict_policy: str = "lru",
                    wb_threshold: float = 0.0,
                    stale_forecast: bool = False) -> EmbeddingStore:
    """The context's embedding store, split over the shards: a
    ``TieredStore`` of C device rows a shard when the context carries a
    device-row cap (its eviction policy, delta-gated write-back threshold
    and stale-row forecaster as given), the device-resident backend
    otherwise.  Its local shards are this process's."""
    if ctx.device_rows_per_shard is None:
        return DeviceStore(ctx.n_rows, j_max, d_h, num_shards=ctx.num_shards,
                           dtype=dtype, device=ctx.device)
    return TieredStore(ctx.n_rows, j_max, d_h,
                       device_rows=ctx.device_rows_per_shard * ctx.num_shards,
                       num_shards=ctx.num_shards, dtype=dtype,
                       device=ctx.device, local_shards=ctx.local_ranks,
                       evict_policy=evict_policy, wb_threshold=wb_threshold,
                       stale_forecast=stale_forecast)


def make_shard_exchange(ctx: DistContext, comm) -> Exchange:
    return make_exchange(ctx.exchange, comm=comm, num_shards=ctx.num_shards,
                         rows=ctx.table_rows, cap=ctx.exchange_cap,
                         payload_dtype=ctx.payload_dtype,
                         use_kernels=ctx.use_kernels,
                         patch_cap=ctx.patch_cap)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def replicate(state: G.TrainState, table, device) -> G.TrainState:
    """A replica of ``state``'s modules and optimizer state on ``device``,
    holding ``table``."""
    opt = state.opt_state
    opt = dict(opt, mu=[m.detach().clone().to(device) for m in opt["mu"]],
               nu=[v.detach().clone().to(device) for v in opt["nu"]])
    return G.TrainState(copy.deepcopy(state.backbone).to(device),
                        copy.deepcopy(state.head).to(device), opt, table,
                        state.step)


def device_state(ctx: DistContext, state: G.TrainState,
                 store: Optional[EmbeddingStore] = None) -> List[G.TrainState]:
    """One replica of everything but the table for each shard this process
    holds, with the shard's rows of ``state.table`` (the full dense table);
    with a ``store`` the store seeds the shards' tables from it (a tiered
    store takes the rows into its host tier and starts each shard's C-row
    device tier empty)."""
    if store is not None:
        tables = store.restore(state.table, ctx.local_ranks)
    else:
        shards = dtbl.split_table(state.table, ctx.num_shards)
        tables = [tbl.EmbeddingTable(*(t.to(ctx.device) for t in shards[k]))
                  for k in ctx.local_ranks]
    return [replicate(state, t, ctx.device) for t in tables]


def host_table(ctx: DistContext, states: List[G.TrainState],
               store: Optional[EmbeddingStore] = None):
    """The full table from every shard's rows, on the host, padding
    stripped (every shard must be in this process); with a ``store``, its
    snapshot of the shards' tables (both tiers of a tiered store)."""
    if len(states) != ctx.num_shards:
        raise ValueError("host_table needs every shard in this process")
    if store is not None:
        return store.snapshot([s.table for s in states])
    return dtbl.join_tables([tuple(t.cpu() for t in s.table) for s in states],
                            ctx.n_rows)


def shard_batch(ctx: DistContext, batch: G.GSTBatch) -> List[G.GSTBatch]:
    """A host batch (numpy arrays) -> this process's shards' slices on the
    device, each row carrying its global position ``batch_pos`` (a CPU
    tensor), so the shards draw what the single-device step draws."""
    B = batch.seg_valid.shape[0]
    if B % ctx.num_shards:
        raise ValueError(f"batch size {B} must divide over {ctx.num_shards} "
                         "shards (drop-last batching guarantees this)")
    pos = np.arange(B) if batch.batch_pos is None else np.asarray(
        batch.batch_pos)
    b = B // ctx.num_shards
    dev = ctx.device

    def put(x, sl, dtype=None):
        a = np.ascontiguousarray(np.asarray(x)[sl])
        t = torch.from_numpy(a if dtype is None else a.astype(dtype))
        return t.to(dev)

    out = []
    for k in ctx.local_ranks:
        sl = slice(k * b, (k + 1) * b)
        out.append(G.GSTBatch(
            {n: put(v, sl) for n, v in batch.seg_inputs.items()},
            put(batch.seg_valid, sl), put(batch.graph_ids, sl, np.int64),
            put(batch.labels, sl),
            torch.from_numpy(pos[sl].astype(np.int64))))
    return out


def shard_rows(ctx: DistContext, x, dtype=np.int64) -> List[torch.Tensor]:
    """A host array over the GLOBAL batch's rows -> this process's shards'
    slices on the device (e.g. the bucketed patch's ``next_dest``)."""
    x = np.asarray(x)
    b = x.shape[0] // ctx.num_shards
    return [torch.from_numpy(np.ascontiguousarray(
        x[k * b:(k + 1) * b]).astype(dtype)).to(ctx.device)
        for k in ctx.local_ranks]


def _shard_draws(draws, batch: G.GSTBatch):
    """The shard's rows of the GLOBAL batch's injected (idx, u) draws."""
    if draws is None:
        return None
    pos = batch.batch_pos.numpy()
    return np.asarray(draws[0])[pos], np.asarray(draws[1])[pos]


# ---------------------------------------------------------------------------
# steps (the per-shard steps of core/gst.py, one per shard)
# ---------------------------------------------------------------------------


class _DistStep:
    """Runs one per-shard step on every shard this process holds;
    ``exchanges`` are the shards' exchanges (their codecs carry the
    write-path bits hook)."""

    def __init__(self, ctx: DistContext, build):
        self.ctx = ctx
        self.exchanges = [make_shard_exchange(ctx, c) for c in ctx.group.comms]
        self.steps = [build(ex, c) for ex, c in zip(self.exchanges,
                                                   ctx.group.comms)]

    def _run(self, fn):
        return self.ctx.group.run(
            lambda i, comm: in_shard(lambda: fn(i, self.steps[i])))


def make_dist_train_step(encode_fn, optimizer, variant: G.GSTVariant, *,
                         ctx: DistContext, **kwargs):
    """Data-parallel ``G.make_train_step``: ``step(states, batches,
    generators=None, draws=None) -> (states, metrics)``, states from
    ``device_state``, batches from ``shard_batch``, one generator per
    local shard (all in the same state), ``draws`` the GLOBAL batch's
    (idx (B, S), u (B, J)).  The metrics are the shards' means.

    With ``ctx.prefetch`` the step is the prefetched one
    (``src/repro/dist/train.py:262-341``):

      step(states, batches, generators, draws, pref, nxt, next_ids,
           next_dest) -> (states, metrics, patched)

    each of the last four a list over the local shards: ``pref`` this
    batch's prefetched ``(emb, init)`` pair (already patched by the
    previous step), read in place of the lookup; ``nxt`` the next batch's
    pair (``make_prefetch_lookup``, issued before this call);
    ``next_ids``/``next_dest`` route the fused write-back patch
    (``next_dest`` None except for bucketed, ``shard_rows`` of
    ``exchange.consumer_shards``); ``patched`` is ``nxt`` with this
    step's write-back in it, the ``pref`` of the next call.  A variant
    without a table hands ``nxt`` back unpatched."""
    decay = kwargs.get("sed_decay", 0.0)

    def build(ex, comm):
        # the age plane travels its own exchange collective (lookup_ages),
        # only with the decay on
        age = ex.lookup_ages if decay > 0.0 else None
        return G.make_train_step(encode_fn, optimizer, variant,
                                 table_lookup=ex.lookup,
                                 table_update=ex.update_sampled,
                                 table_lookup_age=age, comm=comm, **kwargs)

    def build_prefetched(ex, comm):
        # the injected table ops read this call's buffers from ``io``: the
        # lookup answers from ``pref`` without a collective, the update
        # runs the fused write-back and patch and leaves the patched pair
        io = {}

        def t_lookup(table, graph_ids):
            return io["pref"]

        def t_update(table, graph_ids, seg_idx, h_new, step):
            table, io["patched"] = ex.update_sampled_patch(
                table, graph_ids, seg_idx, h_new, step, io["nxt"],
                io["next_ids"], io["next_dest"])
            return table

        age = ex.lookup_ages if decay > 0.0 else None
        inner = G.make_train_step(encode_fn, optimizer, variant,
                                  table_lookup=t_lookup,
                                  table_update=t_update,
                                  table_lookup_age=age, comm=comm, **kwargs)

        def step(state, batch, generator, draws, pref, nxt, next_ids,
                 next_dest):
            io.clear()
            io.update(pref=pref, nxt=nxt, next_ids=next_ids,
                      next_dest=next_dest)
            state, metrics = inner(state, batch, generator, draws)
            return state, metrics, io.pop("patched", nxt)

        return step

    class TrainStep(_DistStep):
        def __call__(self, states, batches, generators=None, draws=None):
            out = self._run(lambda i, step: step(
                states[i], batches[i],
                None if generators is None else generators[i],
                _shard_draws(draws, batches[i])))
            return [s for s, _ in out], out[0][1]

    class PrefetchedTrainStep(_DistStep):
        def __call__(self, states, batches, generators, draws, pref, nxt,
                     next_ids, next_dest=None):
            out = self._run(lambda i, step: step(
                states[i], batches[i],
                None if generators is None else generators[i],
                _shard_draws(draws, batches[i]), pref[i], nxt[i],
                next_ids[i], None if next_dest is None else next_dest[i]))
            return [s for s, _, _ in out], out[0][1], [p for _, _, p in out]

    if ctx.prefetch:
        return probe_call("dist.train_step",
                          PrefetchedTrainStep(ctx, build_prefetched))
    return probe_call("dist.train_step", TrainStep(ctx, build))


def make_prefetch_lookup(ctx: DistContext):
    """The prefetch lane's own collective (``src/repro/dist/train.py:
    343-360``): ``fn(tables, ids) -> [(emb, init)]``, one lookup per local
    shard through ``ctx.group``, every shard issuing the same collectives
    in the same order; ``ids`` the shards' slices of the next batch.  The
    tables are read, not written: the loop issues it after the next
    batch's migration commit and before the current step."""
    exchanges = [make_shard_exchange(ctx, c) for c in ctx.group.comms]

    def fn(tables, ids):
        return ctx.group.run(lambda i, comm: in_shard(
            lambda: exchanges[i].prefetch_lookup(tables[i], ids[i])))

    return probe_call("dist.prefetch_lookup", fn)


def make_dist_eval_step(encode_fn, *, ctx: DistContext, **kwargs):
    """``step(states, batches) -> metrics`` (the shards' means)."""

    class EvalStep(_DistStep):
        def __call__(self, states, batches):
            return self._run(lambda i, step: step(states[i], batches[i]))[0]

    return probe_call("dist.eval_step", EvalStep(
        ctx, lambda ex, comm: G.make_eval_step(encode_fn, comm=comm,
                                               **kwargs)))


def make_dist_refresh_step(encode_fn, *, ctx: DistContext):
    """``step(states, batches) -> states``: Algorithm 2 line 12 through the
    exchange's ``update_all``."""

    class RefreshStep(_DistStep):
        def __call__(self, states, batches):
            return self._run(lambda i, step: step(states[i], batches[i]))

    return probe_call("dist.refresh_step", RefreshStep(
        ctx, lambda ex, comm: G.make_refresh_step(
            encode_fn, table_update_all=ex.update_all)))


def make_dist_finetune_step(optimizer, *, ctx: DistContext, **kwargs):
    """``step(states, batches) -> (states, metrics)``: the head trained
    from the table, read through the exchange's ``lookup``."""

    class FinetuneStep(_DistStep):
        def __call__(self, states, batches):
            out = self._run(lambda i, step: step(states[i], batches[i]))
            return [s for s, _ in out], out[0][1]

    return probe_call("dist.finetune_step", FinetuneStep(
        ctx, lambda ex, comm: G.make_finetune_step(
            optimizer, table_lookup=ex.lookup, comm=comm, **kwargs)))
