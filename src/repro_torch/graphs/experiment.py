"""End-to-end experiment runner for the paper-faithful graph track.

Counterpart of ``src/repro/graphs/experiment.py``.  Runs one (dataset,
backbone, variant) cell of the paper's tables on the synthetic MalNet-like /
TpuGraphs-like datasets: GST training (Algorithm 1/2) with the optional
head-finetuning phase, returning train/test metrics and the wall-clock time
per iteration (Table 3 analogue).  ``run_in_lockstep`` runs several such
experiments with their timed train steps interleaved, so that their times
per iteration are taken under the same host conditions.

The data split, the batch order and the epoch structure are the
reference's, from the same numpy generators.  The step's random draws come
from a ``torch.Generator`` made from ``seed`` and the epoch, on the CPU (so
the draws do not depend on the device); ``draws`` replaces them, which is
how the parity tests replay JAX's ``key(epoch)`` stream.  The historical
table lives behind an embedding store: the whole table on the device
(``DeviceStore``), or with ``table_device_rows`` a bounded set of hot rows
over a host-RAM tier (``TieredStore``), bitwise the same run either way
while the write-back gate and the forecaster are off.  With ``obs`` (a
``repro_torch.obs.Obs``) each epoch ticks its stream, and while a live
registry is installed each epoch publishes the store's counters and a
staleness probe of the table (``src/repro/graphs/experiment.py:160-201``).
The train, eval, refresh and finetune steps are the memory probe's
``train.*`` sites (``obs/memory.py``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Callable, Dict, Generator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import embedding_table as tbl
from repro_torch.core import gst as G
from repro_torch.graphs import batching as Bt
from repro_torch.graphs import data as D
from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
from repro_torch.models.common import load_jax_params
from repro_torch.obs import StalenessProbe, get_registry, probe_call, span
from repro_torch.optim import make_optimizer
from repro_torch.store import DeviceStore, TieredStore


@dataclass
class ExperimentResult:
    variant: str
    backbone: str
    train_metric: float
    test_metric: float
    ms_per_iter: float
    use_kernels: bool = True
    finetuned: bool = False      # whether the Algorithm-2 head-finetuning
                                 # phase (lines 11-18) actually ran
    store_stats: Optional[Dict] = None   # residency counters (store/)
    train_steps: int = 0         # train steps taken (finetune steps apart)
    finetune_steps: int = 0
    epoch_losses: Optional[list] = None   # mean train loss of each epoch
    table: Optional[tbl.EmbeddingTable] = None  # the final historical
                                 # table on the host (store.snapshot)


def to_batch(seg_inputs, seg_valid, ids, labels, device) -> G.GSTBatch:
    return G.GSTBatch(
        {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in seg_inputs.items()},
        torch.from_numpy(seg_valid).to(device),
        torch.from_numpy(ids.astype(np.int64)).to(device),
        torch.from_numpy(np.asarray(labels)).to(device))


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The CPU generator of one epoch's train-step draws."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_datasets(dataset: str, n_graphs: int, max_seg_nodes: int, *,
                  partition: str = "bfs", seed: int = 0,
                  test_frac: float = 0.25):
    """The experiment's data: ((loss_kind, head_mode, agg, n_out), the
    padded training set, the padded test set), split and padded as
    ``src/repro/graphs/experiment.py:77-97`` does it."""
    if dataset == "malnet":
        graphs = D.make_malnet_like(n_graphs=n_graphs, seed=seed)
        track = ("ce", "mlp", "mean", 5)
    else:
        graphs = D.make_tpugraphs_like(n_graphs=n_graphs, seed=seed)
        # paper §5.3: per-segment runtime, F' = sum; normalize targets
        track = ("pairwise_hinge", "segment_sum", "sum", 1)
        lab = np.asarray([g.label for g in graphs], np.float32)
        mu, sd = lab.mean(), lab.std() + 1e-6
        for g in graphs:
            g.label = float((g.label - mu) / sd)

    n_test = int(len(graphs) * test_frac)
    rng = np.random.default_rng(seed + 17)
    perm = rng.permutation(len(graphs))
    test_graphs = [graphs[i] for i in perm[:n_test]]
    train_graphs = [graphs[i] for i in perm[n_test:]]

    ds = Bt.segment_dataset(train_graphs, max_seg_nodes, method=partition, seed=seed)
    ds_test = Bt.segment_dataset(test_graphs, max_seg_nodes, method=partition,
                                 seed=seed, j_max=ds.j_max, e_max=ds.e_max)
    return track, ds, ds_test


def experiment_steps(
    *,
    dataset: str = "malnet",          # malnet | tpugraphs
    backbone: str = "sage",           # gcn | sage | gps
    variant: str = "gst_efd",
    n_graphs: int = 80,
    max_seg_nodes: int = 64,
    partition: str = "bfs",
    epochs: int = 30,
    finetune_epochs: int = 10,
    batch_size: int = 8,
    hidden: int = 64,
    lr: float = 5e-3,
    keep_prob: float = 0.5,
    num_sampled: int = 1,
    seed: int = 0,
    test_frac: float = 0.25,
    use_kernels: bool = True,
    device="cuda",
    table_device_rows: Optional[int] = None,
    evict_policy: str = "lru",
    wb_threshold: float = 0.0,
    sed_age_weighting: float = 0.0,   # λ of the stale-branch exp(-λ·age)
                                      # decay in Eq. 1 (0 = off)
    stale_forecast: bool = False,
    draws: Optional[Callable] = None,
    weights: Optional[Tuple] = None,
    obs=None,                         # optional repro_torch.obs.Obs bundle:
                                      # a tick an epoch (its interval)
) -> Generator[None, None, ExperimentResult]:
    """One experiment as a generator: it yields after each timed train
    step and returns the ``ExperimentResult`` when it ends
    (``run_experiment`` runs it alone, ``run_in_lockstep`` beside others).

    ``device``: "cuda" (the default; raises where no card is visible) or
    "cpu".  ``use_kernels``: route the SpMM and the SED pooling through the
    port's kernels (the plain versions on a CPU tensor).

    ``draws(epoch, step, seg_valid) -> (idx (B, S), u (B, J))``: optional
    replacement of the train step's own draws (``step`` is the global
    train-step count, ``seg_valid`` the batch's (B, J) numpy mask).
    ``weights``: optional (backbone tree, head tree) of numpy arrays in the
    JAX package's layout, loaded with ``load_jax_params`` in place of the
    weights drawn from ``seed``.

    ``table_device_rows``: cap the table's device-resident rows (at least
    one batch) over a host tier, with ``evict_policy`` ("lru" or
    "stale-first"), the delta-gated write-back ``wb_threshold`` (0 = off)
    and ``stale_forecast`` (extrapolate stale rows on fault-in); the last
    two only act on a capped table, where rows go stale in the host tier.
    """
    dev = resolve_device(device)
    var = G.VARIANTS[variant]
    track, ds, ds_test = load_datasets(dataset, n_graphs, max_seg_nodes,
                                       partition=partition, seed=seed,
                                       test_frac=test_frac)
    loss_kind, head_mode, agg, n_out = track

    cfg = GNNConfig(backbone=backbone, n_feat=ds.x.shape[-1],
                    hidden=hidden, use_kernels=use_kernels)
    enc = make_encode_fn(cfg)
    gen = torch.Generator().manual_seed(seed)
    bb = gnn_init(cfg, gen, "cpu")
    head = G.head_init(hidden, n_out, head_mode, gen, "cpu")
    if weights is not None:
        load_jax_params(bb, weights[0])
        load_jax_params(head, weights[1])
    bb, head = bb.to(dev), head.to(dev)
    opt = make_optimizer("adam", lr=lr)
    store = (TieredStore(ds.n, ds.j_max, hidden,
                         device_rows=max(table_device_rows, batch_size),
                         device=dev, evict_policy=evict_policy,
                         wb_threshold=wb_threshold,
                         stale_forecast=stale_forecast)
             if table_device_rows else
             DeviceStore(ds.n, ds.j_max, hidden, device=dev))
    state = G.TrainState(bb, head, None, store.init_device_table(), 0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))

    # each step is a memory-probe site (--mem-probe: the first call of
    # each shape measured; one global read and a branch a call when off)
    step = probe_call("train.step", G.make_train_step(
        enc, opt, var, num_sampled=num_sampled, keep_prob=keep_prob,
        head_mode=head_mode, loss_kind=loss_kind, agg=agg,
        use_kernels=use_kernels, sed_decay=sed_age_weighting))
    eval_step = probe_call("train.eval", G.make_eval_step(
        enc, head_mode=head_mode, loss_kind=loss_kind, agg=agg,
        use_kernels=use_kernels))
    refresh = probe_call("train.refresh", G.make_refresh_step(enc))

    def evaluate(ds_, st):
        ms, ws = [], []
        for tup in Bt.batch_iterator(ds_, batch_size, rng=np.random.default_rng(0),
                                     shuffle=False):
            m = eval_step(st, to_batch(*tup, dev))
            ms.append(float(m["metric"]))
            ws.append(tup[1].shape[0])
        return float(np.average(ms, weights=ws)) if ms else float("nan")

    def route(tup, step=None):
        """Map the batch's graph ids onto device rows through the store
        (migrating rows between the tiers; the identity under the
        DeviceStore).  ``step``: the train step about to WRITE these rows,
        the stale-first eviction's hint (None on read-only paths)."""
        nonlocal state
        table, slots = store.prepare(state.table, tup[2], step=step)
        state = state._replace(table=table)
        return torch.from_numpy(slots.astype(np.int64)).to(dev)

    def routed(tup, step=None):
        return to_batch(*tup, dev)._replace(graph_ids=route(tup, step))

    try:
        iter_times = []
        brng = np.random.default_rng(seed + 3)
        last_train = 0.0
        epoch_losses = []
        probe = StalenessProbe(keep_prob=keep_prob, num_sampled=num_sampled,
                               seg_valid=ds.seg_valid,
                               sed_decay=sed_age_weighting,
                               forecast=stale_forecast)
        for epoch in range(epochs):
            ep_metrics, ep_losses = [], []
            egen = epoch_generator(seed, epoch)
            for tup in Bt.batch_iterator(ds, batch_size, rng=brng):
                drawn = (None if draws is None
                         else draws(epoch, state.step, tup[1]))
                batch = to_batch(*tup, dev)
                # the timed region ends with a device sync: eagerly, the
                # loss is ready before the backward and the update have run
                t0 = time.perf_counter()
                # the timed region includes the tier migration: it is part
                # of a capped table's step cost
                batch = batch._replace(graph_ids=route(tup, state.step))
                with span("train.step", epoch=epoch):
                    state, m = step(state, batch, egen, drawn)
                    _sync(dev)
                iter_times.append(time.perf_counter() - t0)
                ep_metrics.append(float(m["metric"]))
                ep_losses.append(float(m["loss"]))
                yield
            last_train = float(np.mean(ep_metrics))
            epoch_losses.append(float(np.mean(ep_losses)))
            # resident rows rewritten this epoch re-report their device
            # ages to the eviction bookkeeping (no-op under plain LRU)
            store.refresh_ages(state.table)
            stale = None
            if get_registry().enabled:
                store.publish_counters()
                stale = probe.observe(store, state.table, state.step)
            if obs is not None and obs.should_tick(epoch):
                obs.tick(step=state.step, epoch=epoch, train=last_train,
                         staleness=stale)
        train_steps = state.step

        # ---- head finetuning phase (Algorithm 2 lines 11-18) -----------------
        # Runs for BOTH head modes: the MLP graph head and the TpuGraphs
        # per-segment scalar head finetune from the refreshed table.
        finetuned = False
        finetune_steps = 0
        if var.finetune_head:
            for tup in Bt.batch_iterator(ds, batch_size, rng=brng, shuffle=False):
                # refresh WRITES every requested row at the current step
                state = refresh(state, routed(tup, state.step))
            ft_opt = make_optimizer("adam", lr=lr * 0.5)
            state = state._replace(opt_state=ft_opt.init(
                list(state.head.parameters())))
            ft_step = probe_call("train.finetune", G.make_finetune_step(
                ft_opt, head_mode=head_mode, loss_kind=loss_kind, agg=agg,
                use_kernels=use_kernels))
            for _ in range(finetune_epochs):
                for tup in Bt.batch_iterator(ds, batch_size, rng=brng):
                    state, _ = ft_step(state, routed(tup))
                    finetuned = True
                    finetune_steps += 1
            state = state._replace(opt_state=opt.init(G.train_params(state)))

        store.flush_writebacks()
        store_stats = store.stats()
        table = store.snapshot(state.table)
    finally:
        store.close()
    # skip the first few warm-up iterations in the timing
    ms_per_iter = float(np.median(iter_times[3:]) * 1e3) if len(iter_times) > 4 else float("nan")
    return ExperimentResult(
        variant=variant, backbone=backbone,
        train_metric=last_train,
        test_metric=evaluate(ds_test, state),
        ms_per_iter=ms_per_iter, use_kernels=use_kernels,
        finetuned=finetuned, store_stats=store_stats,
        train_steps=train_steps, finetune_steps=finetune_steps,
        epoch_losses=epoch_losses, table=table)


def run_experiment(**kwargs) -> ExperimentResult:
    """One experiment run to its end; the arguments of
    ``experiment_steps``."""
    return run_in_lockstep([kwargs])[0]


def run_in_lockstep(configs: Sequence[Dict]) -> List[ExperimentResult]:
    """Several experiments (``experiment_steps``' arguments each) with
    their timed train steps interleaved: one step of each in turn, the
    run that goes first rotating from turn to turn.  On the card a graph
    step is host bound and the host's speed drifts from second to second,
    so runs made one after the other also compare the drift; in lockstep
    it falls on every run alike.  Each run's results are those it gives
    alone (its own generators, store and state); only its timings are
    taken beside the others'."""
    runs = [experiment_steps(**c) for c in configs]
    results: List[Optional[ExperimentResult]] = [None] * len(runs)
    try:
        live, turn = list(range(len(runs))), 0
        while live:
            k = turn % len(live)
            for i in live[k:] + live[:k]:
                try:
                    next(runs[i])
                except StopIteration as done:
                    results[i] = done.value
            live = [i for i in live if results[i] is None]
            turn += 1
    finally:  # a run that raised: close the others' stores
        for r in runs:
            r.close()
    return results
