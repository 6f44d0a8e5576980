"""Distributed GST training launcher of the port (data parallel, row-sharded
table, pluggable table exchange, compressed wire format).

Counterpart of ``src/repro/launch/train_dist.py``:

    # 4 shards as threads on one card, ring exchange, int8 payloads
    PYTHONPATH=src python -m repro_torch.launch.train_dist \
        --devices 4 --exchange ring --payload-dtype int8 --epochs 5

    # the same on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.train_dist --device cpu \
        --devices 4 --exchange bucketed --epochs 2 --finetune-epochs 1

    # one shard per card, one process each
    torchrun --nproc-per-node 4 -m repro_torch.launch.train_dist \
        --exchange alltoall --payload-dtype bf16

    # the prefetch lane: batch k+1's lookup issued before step k, the
    # write-back patched into it (bitwise the inline run at f32)
    PYTHONPATH=src python -m repro_torch.launch.train_dist \
        --devices 4 --prefetch-lookups --exchange bucketed --epochs 5

Started by ``torchrun`` (``WORLD_SIZE`` set), each process is one shard
(``ProcessGroup``: NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``); otherwise ``--devices D`` runs D shards as threads of this process
on ``--device`` (``LocalGroup``), the counterpart of the reference's forced
N-device host.  The payload codec only runs with two or more shards: at one
shard nothing crosses a wire and ``--payload-dtype`` is pinned to f32, as
in the reference.  ``--use-kernels`` routes the SpMM, the SED pooling and
the payload pack/unpack through the port's kernels (their plain versions
on a CPU tensor).

``--table-device-rows`` caps the table's device-resident rows (at least a
batch a shard) over a host-RAM tier: a ``TieredStore`` split over the
shards, each shard's table C rows, the exchange routing slot ids
(``--evict-policy``, ``--wb-threshold`` and ``--stale-forecast`` act on
that tier).  The feeder begins each batch's migration (host bookkeeping,
staging copies) ahead of its step; the consumer commits it into the
shards' tables right before the step.

``--prefetch-lookups`` runs the train loop through the prefetch lane
(``dist/pipeline.py::PrefetchLane``): the lane pulls batch k+1 before
step k, commits its migration and issues its lookup; step k reads its own
prefetched pair and patches batch k+1's with its write-back.  Under a
capped table the lane keeps its batches pinned on the device tier until
their step ran (``store.begin(pin=True)``, ``store.release``), so the cap
is raised to hold the in-flight window: 2 batches with the sync feeder,
``--depth`` + 2 with the async one.  ``--patch-cap`` sizes bucketed's
patch buckets (default: planned over the train schedules).  Refresh,
finetune and eval stay inline.

Each epoch prints its last loss, the feeder's host-blocked time and the
exchange traffic one shard sent, from the comm's counters.

Telemetry (``repro_torch.obs``, the flags of ``add_obs_args``) as in
``src/repro/launch/train_dist.py``: ``train.commit`` and ``train.step``
spans; once a train step, from the main loop (not the shard threads),
``exchange.bytes.<strategy>.<dtype>`` += the modelled bytes of a step and
shard, and on the prefetch lane ``exchange.prefetch.*`` with the step's
patched rows; each epoch the store's counters, a staleness probe of the
whole table and a tick; at the end ``store.wb_skip_rate`` and the summary
(``wall_s``, ``train_metric``).  Telemetry of a ``torchrun`` run (one
shard a process) is not ported and raises.

    PYTHONPATH=src python -m repro_torch.launch.train_dist --device cpu \
        --devices 2 --exchange ring --payload-dtype int8 --epochs 2 \
        --finetune-epochs 1 --metrics-out d.jsonl --trace-out d_trace.json
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gst as G
from repro_torch.core.embedding_table import init_table
from repro_torch.dist import exchange as EXC
from repro_torch.dist import pipeline as DP
from repro_torch.dist import train as DT
from repro_torch.dist.comm import LocalGroup, ProcessGroup
from repro_torch.dist.table import rows_per_shard
from repro_torch.graphs import data as D
from repro_torch.graphs.experiment import epoch_generator
from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
from repro_torch.obs import (Obs, StalenessProbe, add_obs_args,
                             record_exchange_bytes, record_prefetch_exchange,
                             span)
from repro_torch.obs.export import summary_lines
from repro_torch.optim import make_optimizer


@dataclass
class DistResult:
    """What a run of ``run`` gives back (the CLI prints it)."""
    cap: Optional[int]
    epoch_losses: List[float]
    train_metric: float
    finetuned: bool
    finetune_loss: float
    train_steps: int
    finetune_steps: int
    refresh_steps: int
    ms_per_iter: float
    step_bytes_model: int             # analytic exchange bytes a train step
    epoch_exchange_bytes: List[int]   # one shard's counted bytes an epoch
    store_stats: Optional[dict] = None  # residency counters (store/)
    patch_cap: Optional[int] = None   # bucketed prefetch: patch buckets
    patched_rows: int = 0             # prefetch: write rows with a consumer
    states: Optional[List] = None     # the local shards' final TrainStates
    store: object = None              # their store (closed)

    def host_table(self) -> tuple:
        """The final table (emb, age, init), copied to the host on demand
        from every shard's tiers (every shard must be in this process)."""
        return tuple(self.store.snapshot([st.table for st in self.states]))

    def host_params(self) -> list:
        """Shard 0's final parameters, copied to the host on demand."""
        return [p.detach().cpu() for p in G.train_params(self.states[0])]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None,
                    help="data-parallel width: shards as threads of this "
                         "process on --device (under torchrun: must equal "
                         "the world size)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dataset", default="malnet", choices=["malnet"])
    ap.add_argument("--backbone", default="sage", choices=["gcn", "sage"])
    ap.add_argument("--variant", default="gst_efd")
    ap.add_argument("--n-graphs", type=int, default=64)
    ap.add_argument("--max-seg-nodes", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--finetune-epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--keep-prob", type=float, default=0.5)
    ap.add_argument("--num-sampled", type=int, default=1,
                    help="segments sampled for backprop per graph (S)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="route the SpMM, the SED pooling and the payload "
                         "pack/unpack through the port's kernels (their "
                         "plain versions on the CPU)")
    ap.add_argument("--feeder", default="async", choices=["async", "sync"],
                    help="host->device pipeline: async double buffering "
                         "(default) or the synchronous baseline")
    ap.add_argument("--depth", type=int, default=2,
                    help="async pipeline depth (batches in flight)")
    ap.add_argument("--exchange", default="ring",
                    choices=["ring", "alltoall", "bucketed", "auto"],
                    help="table-exchange strategy (dist/exchange.py); auto "
                         "= fewest analytic bytes a step at this shard "
                         "count and payload dtype")
    ap.add_argument("--exchange-cap", type=int, default=None,
                    help="bucketed only: per-(shard, owner) bucket capacity; "
                         "default planned over the run's id schedules")
    ap.add_argument("--payload-dtype", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="wire format of the exchanged embeddings: f32 "
                         "(identity, bit-exact), bf16, or int8 with a "
                         "per-row scale; write-backs round stochastically")
    ap.add_argument("--sed-age-weighting", type=float, default=0.0,
                    help="λ of the exp(-λ·age) staleness decay on the stale "
                         "branch of Eq.-1 η (ages read exactly through the "
                         "exchange). 0 = off")
    ap.add_argument("--prefetch-lookups", action="store_true",
                    help="hide the exchange: issue batch k+1's table lookup "
                         "as its own collective before step k "
                         "(dist.make_prefetch_lookup), and restore "
                         "read-after-write correctness with the fused "
                         "write-back patch (exchange.update_sampled_patch). "
                         "Bitwise the inline exchange at --payload-dtype "
                         "f32; bounded error under bf16/int8 like the "
                         "inline path.  Train loop only: refresh, finetune "
                         "and eval stay inline")
    ap.add_argument("--patch-cap", type=int, default=None,
                    help="bucketed + --prefetch-lookups only: per-(shard, "
                         "consumer) bucket capacity of the patch hop; "
                         "default planned over the train schedules "
                         "(exchange.plan_patch_capacity)")
    ap.add_argument("--table-device-rows", type=int, default=None,
                    help="cap the table's device-resident rows (total over "
                         "the shards, at least shards x batch) over a "
                         "host-RAM tier (store/tiered.py). Default: the "
                         "whole table on the devices")
    ap.add_argument("--evict-policy", default="lru",
                    choices=["lru", "stale-first"],
                    help="device-tier eviction under --table-device-rows: "
                         "LRU or age-aware stale-first")
    ap.add_argument("--wb-threshold", type=float, default=0.0,
                    help="delta-gated write-back under --table-device-rows: "
                         "skip the host-tier emb write of evicted rows that "
                         "moved less than this. 0 = off, bit-exact")
    ap.add_argument("--stale-forecast", action="store_true",
                    help="extrapolate stale host-tier rows on fault-in "
                         "under --table-device-rows (store/forecast.py)")
    add_obs_args(ap)
    return ap


def _make_group(args):
    """torchrun -> one shard per process; else --devices threads."""
    if "WORLD_SIZE" not in os.environ:
        return LocalGroup(args.devices or 1, resolve_device(args.device))
    import torch.distributed as dist

    if args.device == "cuda":
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if args.devices not in (None, dist.get_world_size()):
        raise ValueError(f"--devices {args.devices} disagrees with the "
                         f"world size {dist.get_world_size()}")
    return ProcessGroup(dev)


@dataclass
class DistSetup:
    """A run's model, data, schedules and steps, before its first step."""
    args: argparse.Namespace
    ctx: DT.DistContext
    ds: object              # graphs/batching.SegmentedDataset
    spec: object            # serve/buckets.BucketSpec
    variant: G.GSTVariant
    enc: object             # the backbone's encode_fn
    store: object           # store/: DeviceStore or TieredStore, split
                            # over the shards
    states: list            # the local shards' TrainStates
    step: object            # dist/train.py train step
    eval_step: object
    train_scheds: list
    refresh_sched: list
    ft_scheds: list
    eval_sched: list
    cap: Optional[int]
    xbytes: int             # modelled exchange bytes a train step a shard
    pxbytes: int = 0        # the same of a prefetched step
    hint: int = 0           # the next train/refresh step's number

    def put(self, b, step: Optional[int] = None, pin: bool = False):
        """A host batch -> (its store migration, its shards' device
        batches), the ids routed through the store (the identity for the
        device-resident store).  ``step``: the step about to WRITE these
        rows, the stale-first eviction's hint.  ``pin``: the rows stay on
        the device tier until ``store.release`` (the prefetch lane's
        lookahead).  Safe on the feeder thread; ``commit`` applies the
        migration."""
        prep = self.store.begin(np.asarray(b.graph_ids), step=step, pin=pin)
        return prep, DT.shard_batch(self.ctx,
                                    b._replace(graph_ids=prep.slots))

    def put_writing(self, b, pin: bool = False):
        """``put`` for a train or refresh batch: the hint counts up."""
        self.hint += 1
        return self.put(b, step=self.hint - 1, pin=pin)

    def put_pinned(self, b):
        """``put_writing`` for the prefetch lane: the batch stays pinned
        until its step ran (``src/repro/launch/train_dist.py:305-323``)."""
        return self.put_writing(b, pin=True)

    def commit(self, states, item):
        """Apply an item of ``put`` to the shards' tables, in put order:
        (states, the item's device batches)."""
        prep, batches = item
        tables = self.store.commit([st.table for st in states], prep)
        return ([st._replace(table=t) for st, t in zip(states, tables)],
                batches)


def setup(args) -> DistSetup:
    """The run's model, data, schedules and steps (``run`` drives them;
    ``chip_smoke.py`` and the card's tests drive their steps directly)."""
    group = _make_group(args)
    n_dev = group.size
    if args.batch_size % n_dev:
        raise ValueError(f"--batch-size {args.batch_size} must be divisible "
                         f"by the shard count {n_dev}")
    if args.epochs < 1:
        raise ValueError("--epochs must be >= 1")
    if args.n_graphs < args.batch_size:
        raise ValueError(f"--n-graphs {args.n_graphs} yields an empty "
                         f"drop-last epoch at --batch-size {args.batch_size}")

    graphs = D.make_malnet_like(n_graphs=args.n_graphs, seed=args.seed)
    ds, spec = DP.segment_dataset_shared(graphs, args.max_seg_nodes,
                                         seed=args.seed)
    var = G.VARIANTS[args.variant]
    cfg = GNNConfig(backbone=args.backbone, n_feat=graphs[0].x.shape[1],
                    hidden=args.hidden, use_kernels=args.use_kernels)
    enc = make_encode_fn(cfg)
    gen = torch.Generator().manual_seed(args.seed)
    bb = gnn_init(cfg, gen, "cpu")
    head = G.head_init(args.hidden, 5, "mlp", gen, "cpu")
    opt = make_optimizer("adam", lr=args.lr)
    state = G.TrainState(bb, head, None,
                         init_table(ds.n, ds.j_max, args.hidden), 0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))

    # every id schedule up front (the reference's rng draw order): the
    # bucketed exchange plans its bucket capacity over the whole run
    rng = np.random.default_rng(args.seed + 3)
    train_scheds = [DP.epoch_ids(ds, args.batch_size, rng=rng)
                    for _ in range(args.epochs)]
    refresh_sched = DP.epoch_ids(ds, args.batch_size, rng=rng, shuffle=False)
    ft_scheds = [DP.epoch_ids(ds, args.batch_size, rng=rng)
                 for _ in range(args.finetune_epochs)] \
        if var.finetune_head else []
    eval_sched = DP.epoch_ids(ds, args.batch_size, rng=rng, shuffle=False)

    rows = rows_per_shard(ds.n, n_dev)
    need_cap = EXC.plan_capacity(
        [ids for sched in (*train_scheds, refresh_sched, *ft_scheds)
         for ids in sched], num_shards=n_dev, rows=rows)
    cap = args.exchange_cap
    if cap is None:
        cap = need_cap
    elif cap < need_cap:
        raise ValueError(f"--exchange-cap {cap} is below the {need_cap} rows "
                         "one owner bucket needs for this run's schedules: "
                         "the bucketed exchange would lose writes")
    b_local = args.batch_size // n_dev
    exchange = args.exchange
    if exchange == "auto":
        exchange = EXC.select_exchange(n_dev, b_local, ds.j_max,
                                       args.num_sampled, args.hidden,
                                       cap=cap,
                                       payload_dtype=args.payload_dtype)
    cap = cap if exchange == "bucketed" else None
    patch_cap = None
    if args.prefetch_lookups and exchange == "bucketed":
        # the patch hop routes a batch's write-backs to the shards holding
        # the NEXT batch: plan its buckets over consecutive pairs of each
        # train epoch (slot space as graph space, as for the cap above)
        need_patch = max(EXC.plan_patch_capacity(sched, num_shards=n_dev,
                                                 rows=rows)
                         for sched in train_scheds)
        patch_cap = args.patch_cap
        if patch_cap is None:
            patch_cap = need_patch
        elif patch_cap < need_patch:
            raise ValueError(f"--patch-cap {patch_cap} is below the "
                             f"{need_patch} rows one consumer bucket needs "
                             "for this run's schedules: the patch hop would "
                             "drop write-back repairs")
    # every shard must be able to hold one batch's rows at once (owner
    # histograms are the same in graph-row and slot space: a row's slot
    # stays on its owner shard, so the capacity planned above holds too);
    # the prefetch lane keeps its in-flight window pinned: the running
    # step, the prefetched next batch and up to --depth feeder batches
    window = 1 if not args.prefetch_lookups else (
        2 if args.feeder == "sync" else args.depth + 2)
    device_rows = (None if args.table_device_rows is None
                   else max(args.table_device_rows,
                            window * n_dev * args.batch_size))
    ctx = DT.make_context(group, ds.n, device_rows, exchange=exchange,
                          exchange_cap=cap, payload_dtype=args.payload_dtype,
                          use_kernels=args.use_kernels,
                          prefetch=args.prefetch_lookups, patch_cap=patch_cap)
    store = DT.make_dist_store(ctx, ds.j_max, args.hidden,
                               evict_policy=args.evict_policy,
                               wb_threshold=args.wb_threshold,
                               stale_forecast=args.stale_forecast)
    step = DT.make_dist_train_step(enc, opt, var, ctx=ctx,
                                   keep_prob=args.keep_prob,
                                   num_sampled=args.num_sampled,
                                   sed_decay=args.sed_age_weighting,
                                   use_kernels=args.use_kernels)
    geom = (b_local, ds.j_max, args.num_sampled, args.hidden)
    xbytes = step.exchanges[0].train_step_bytes(*geom,
                                                use_table=var.use_table)
    pxbytes = step.exchanges[0].prefetch_train_step_bytes(
        *geom, use_table=var.use_table)
    return DistSetup(
        args=args, ctx=ctx, ds=ds, spec=spec, variant=var, enc=enc,
        store=store, states=DT.device_state(ctx, state, store=store),
        step=step, eval_step=DT.make_dist_eval_step(
            enc, ctx=ctx, use_kernels=args.use_kernels),
        train_scheds=train_scheds, refresh_sched=refresh_sched,
        ft_scheds=ft_scheds, eval_sched=eval_sched, cap=cap, xbytes=xbytes,
        pxbytes=pxbytes)


def run(args, log=print) -> DistResult:
    if "WORLD_SIZE" in os.environ and any(getattr(args, k, None) for k in (
            "metrics", "metrics_out", "trace_out")):
        raise NotImplementedError(
            "telemetry of a torchrun run (one shard a process) is not "
            "ported: run the shards as threads (--devices) for a stream")
    s = setup(args)
    try:
        obs = Obs.from_args(args, run="train_dist", variant=args.variant,
                            devices=s.ctx.num_shards,
                            exchange=s.ctx.exchange,
                            payload_dtype=s.step.exchanges[0].payload_dtype,
                            epochs=args.epochs, batch_size=args.batch_size)
        try:
            return _run(s, log, obs)
        finally:
            obs.close()
    finally:
        s.store.close()   # stops a tiered store's write-back thread


def _store_line(store) -> str:
    st = store.stats()
    gate = (f", delta-gate skipped {st['wb_skipped_rows']} rows "
            f"({st['wb_skipped_bytes'] / 1024:.1f} KiB)"
            if st.get("wb_threshold", 0.0) > 0.0 else "")
    return (f"store [{st['backend']}] device rows {st['device_rows']}/"
            f"{st['n_rows']}  hit-rate {st['hit_rate']:.2f} "
            f"({st['misses']} faults), {st['evictions']} evictions, "
            f"{st['migration_bytes'] / 1024:.1f} KiB migrated, "
            f"occupancy {st['occupancy']}{gate}")


def _run(s: DistSetup, log, obs) -> DistResult:
    args, ctx, ds, step, states = s.args, s.ctx, s.ds, s.step, s.states
    if ctx.local_ranks[0] != 0:
        log = lambda *a, **k: None            # noqa: E731  (rank 0 prints)
    ex = step.exchanges[0]
    prefetch = ctx.prefetch
    step_bytes = s.pxbytes if prefetch else s.xbytes
    log(f"[dist] devices={ctx.num_shards} rows/shard={ctx.rows_per_shard} "
        f"device-rows/shard={ctx.table_rows} "
        f"bucket={s.spec.key} feeder={args.feeder} device={ctx.device} "
        f"exchange={ctx.exchange} (payload={ex.payload_dtype}, "
        f"{s.xbytes / 1024:.1f} KiB/step/shard"
        + (f", cap={s.cap}" if s.cap is not None else "")
        + (f", prefetch {s.pxbytes / 1024:.1f} KiB"
           + (f", patch-cap={ctx.patch_cap}" if ctx.exchange == "bucketed"
              else "") if prefetch else "") + ")", flush=True)
    tiered = ctx.device_rows_per_shard is not None

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    def tables():
        return [st.table for st in states]

    probe = StalenessProbe(keep_prob=args.keep_prob,
                           num_sampled=args.num_sampled,
                           seg_valid=ds.seg_valid,
                           sed_decay=args.sed_age_weighting,
                           forecast=args.stale_forecast)
    comm0 = ctx.group.comms[0]
    t_start = time.perf_counter()
    iter_times, epoch_losses, epoch_bytes = [], [], []
    stats = None
    patched_rows = 0
    for epoch, sched in enumerate(s.train_scheds):
        gens = [epoch_generator(args.seed, epoch) for _ in ctx.local_ranks]
        feeder = DP.make_feeder(args.feeder, ds, sched,
                                s.put_pinned if prefetch else s.put_writing,
                                depth=args.depth)
        sent0 = comm0.exchange_bytes
        if prefetch:
            states, loss, stats, rows = run_epoch_prefetch(
                s, states, feeder, gens, sync, iter_times, epoch)
            patched_rows += rows
        else:
            loss = None
            for item in feeder:
                # the timed region includes the tier migration's commit:
                # it is part of a capped table's step cost
                t0 = time.perf_counter()
                with span("train.commit"):
                    states, batches = s.commit(states, item)
                with span("train.step", epoch=epoch):
                    states, m = step(states, batches, gens)
                sync()
                iter_times.append(time.perf_counter() - t0)
                record_exchange_bytes(ctx.exchange, ex.payload_dtype,
                                      step_bytes)
                loss = m["loss"]
            stats = feeder.stats
        epoch_losses.append(float(loss))
        epoch_bytes.append(comm0.exchange_bytes - sent0)
        log(f"epoch {epoch}: loss={epoch_losses[-1]:.4f} "
            f"host_blocked={stats.host_blocked_ms_per_batch:.2f} ms/batch "
            f"exch KiB {epoch_bytes[-1] / 1024:.1f} "
            f"({stats.batches} steps, {step_bytes / 1024:.1f} KiB/step/shard "
            "modelled)", flush=True)
        # resident rows rewritten this epoch re-report their device ages to
        # the eviction bookkeeping (no-op under plain LRU)
        s.store.refresh_ages(tables())
        if obs.enabled:
            # per-epoch rates (the registry's delta()) and a staleness
            # probe of the whole table
            s.store.publish_counters()
            stale = probe.observe(s.store, tables(), s.hint)
            d = None
            if obs.exporter is None:
                d = obs.registry.delta()
            elif obs.should_tick(epoch):
                d = obs.tick(step=s.hint, epoch=epoch,
                             loss=epoch_losses[-1], staleness=stale)["delta"]
            if d is not None:
                exch = sum(v for k, v in d.items()
                           if k.startswith("exchange.bytes."))
                log(f"  obs epoch {epoch}: faults "
                    f"{d.get('store.faults', 0):.0f} evictions "
                    f"{d.get('store.evictions', 0):.0f} exch KiB "
                    f"{exch / 1024:.1f} row-age p99 "
                    f"{stale['row_age_steps']['p99']:.0f} steps sed-drop "
                    f"{stale['sed_drop_rate']:.3f}", flush=True)
    train_steps = states[0].step
    if tiered:
        log(f"  {_store_line(s.store)}", flush=True)

    finetuned, ft_loss, ft_steps = False, float("nan"), 0
    if s.variant.finetune_head:
        refresh = DT.make_dist_refresh_step(s.enc, ctx=ctx)
        for item in DP.make_feeder("sync", ds, s.refresh_sched,
                                   s.put_writing):
            states, batches = s.commit(states, item)
            states = refresh(states, batches)
        ft_opt = make_optimizer("adam", lr=args.lr * 0.5)
        states = [st._replace(opt_state=ft_opt.init(list(
            st.head.parameters()))) for st in states]
        ft = DT.make_dist_finetune_step(ft_opt, ctx=ctx,
                                        use_kernels=args.use_kernels)
        m = None
        for sched in s.ft_scheds:
            # finetune only READS the table: no step hint
            for item in DP.make_feeder(args.feeder, ds, sched, s.put,
                                       depth=args.depth):
                states, batches = s.commit(states, item)
                states, m = ft(states, batches)
                ft_steps += 1
        if m is not None:
            finetuned, ft_loss = True, float(m["loss"])
            log(f"finetune: loss={ft_loss:.4f}", flush=True)

    # eval reads no table: no store routing
    metrics = [float(s.eval_step(states, b)["metric"]) for b in
               DP.make_feeder("sync", ds, s.eval_sched,
                              lambda b: DT.shard_batch(ctx, b))]
    train_metric = float(np.mean(metrics))
    # surface any failed write-back before reporting success
    s.store.flush_writebacks()
    wall = time.perf_counter() - t_start
    blocked = stats.host_blocked_ms_per_batch
    log(f"[dist] done in {wall:.1f}s: train metric {train_metric:.3f}, "
        f"host blocked {blocked:.2f} ms/batch ({args.feeder})", flush=True)
    if tiered:
        log(f"  {_store_line(s.store)}", flush=True)
    if obs.enabled:
        s.store.publish_counters()
        probe.observe_store_counters(s.store.counters.as_dict())
    rec = obs.close(wall_s=wall, train_metric=train_metric)
    for line in summary_lines(rec) if rec is not None else ():
        log(line, flush=True)
    ms = (float(np.median(iter_times[3:]) * 1e3) if len(iter_times) > 4
          else float("nan"))
    return DistResult(cap=s.cap,
                      epoch_losses=epoch_losses, train_metric=train_metric,
                      finetuned=finetuned, finetune_loss=ft_loss,
                      train_steps=train_steps, finetune_steps=ft_steps,
                      refresh_steps=len(s.refresh_sched) if finetuned else 0,
                      ms_per_iter=ms, step_bytes_model=step_bytes,
                      epoch_exchange_bytes=epoch_bytes,
                      store_stats=s.store.stats(), patch_cap=ctx.patch_cap,
                      patched_rows=patched_rows, states=states,
                      store=s.store)


def run_epoch_prefetch(s: DistSetup, states, feeder, gens, sync,
                       iter_times, epoch: int = 0):
    """One train epoch through the prefetch lane
    (``src/repro/launch/train_dist.py:340-410``): the lane pulls item k+1
    before step k and dispatches it (commit its migration, then issue its
    lookup); step k reads its own prefetched pair and patches item k+1's,
    the bucketed patch routed by consumer shards planned from the two
    batches' slots (the other strategies need no plan); the last step
    patches a throwaway zero pair addressed by sentinels.  ``feeder``
    yields items of ``s.put_pinned``.  Each step's pins are released after
    it.  A variant without the table issues no lookup (the reference's lane
    issues one that its step never reads; its bytes model counts none).
    Each step records its exchange telemetry (``epoch`` tags its span).
    Returns (states, the last loss, the feeder's stats, the write rows with
    a consumer)."""
    ctx, args = s.ctx, s.args
    D, dev = ctx.num_shards, ctx.device
    bucketed = ctx.exchange == "bucketed"
    payload_dtype = s.step.exchanges[0].payload_dtype
    box = {"states": states}
    lookup = DT.make_prefetch_lookup(ctx)

    def dispatch(item):
        with span("train.commit"):
            box["states"], batches = s.commit(box["states"], item)
        if not s.variant.use_table:
            return [None] * len(batches)
        return lookup([st.table for st in box["states"]],
                      [b.graph_ids for b in batches])

    lane = DP.PrefetchLane(feeder, dispatch)
    b_local = args.batch_size // D
    shape = (b_local, s.ds.j_max, args.hidden)
    pref, loss, rows = None, None, 0
    t0 = time.perf_counter()
    for (prep, batches), cur_h, nxt, nxt_h in lane:
        if pref is None:
            pref = cur_h         # the first batch: nothing patched it yet
        dest, step_rows = None, 0
        if nxt is not None:
            nprep, nbatches = nxt
            next_ids, next_pair = [b.graph_ids for b in nbatches], nxt_h
            step_rows = int(np.isin(prep.slots, nprep.slots).sum())
            if bucketed:
                dest = EXC.consumer_shards(prep.slots, nprep.slots,
                                           num_shards=D, rows=ctx.table_rows)
        else:
            # the epoch's tail: sentinel consumers patch nothing into a
            # throwaway zero pair
            sent = D * ctx.table_rows
            next_ids = [torch.full((b_local,), sent, dtype=torch.int64,
                                   device=dev) for _ in ctx.local_ranks]
            next_pair = [(torch.zeros(shape, device=dev),
                          torch.zeros(shape[:2], dtype=torch.bool,
                                      device=dev)) for _ in ctx.local_ranks]
            if bucketed:
                dest = np.full((args.batch_size,), D, np.int32)
        with span("train.step", epoch=epoch):
            states, m, pref = s.step(box["states"], batches, gens, None,
                                     pref, next_pair, next_ids,
                                     None if dest is None
                                     else DT.shard_rows(ctx, dest))
        box["states"] = states
        s.store.release(prep)
        sync()
        t1 = time.perf_counter()
        iter_times.append(t1 - t0)      # the step and the next dispatch
        t0 = t1
        rows += step_rows
        # exchange.bytes.* stays the run's total-traffic family (the lane
        # moves the same bytes earlier; bucketed adds its patch hop),
        # exchange.prefetch.* is the lane's own
        record_exchange_bytes(ctx.exchange, payload_dtype, s.pxbytes)
        record_prefetch_exchange(ctx.exchange, payload_dtype, s.pxbytes,
                                 step_rows)
        loss = m["loss"]
    return box["states"], loss, lane.stats, rows


def main(argv=None) -> DistResult:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
