"""Training launcher of the port: the graph, sequence and LM tracks.

Counterpart of ``src/repro/launch/train.py``:

    # GST+EFD on synthetic MalNet with a SAGE backbone, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --track graph \
        --backbone sage --variant gst_efd --epochs 30

    # the same on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.train --track graph \
        --device cpu --epochs 3 --finetune-epochs 1 --n-graphs 48

    # sequence track: GST+EFD property training of an assigned arch
    PYTHONPATH=src python -m repro_torch.launch.train --track seq \
        --arch internlm2-1.8b --reduced --steps 200 --device cpu

    # the plain-LM objective (the non-GST baseline)
    PYTHONPATH=src python -m repro_torch.launch.train --track lm \
        --arch olmo-1b --reduced --steps 100 --device cpu

Runs on the card (``--device cuda``, the default; it raises where no card
is visible) unless ``--device cpu`` is given.  ``--lr`` does not reach the
graph track, which trains at ``run_experiment``'s 5e-3: the reference's
``train_graph`` passes no learning rate either.  ``--table-device-rows``
caps the historical table's device-resident rows over a host-RAM tier
(``--evict-policy``, ``--wb-threshold`` and ``--stale-forecast`` act on
that tier), on the graph track and on the sequence track's
(n_docs, J, d_model) table.

The sequence track trains the model's ``encode_segment`` as GST's
backbone F (``train_seq``); ``--use-kernels`` routes the Eq.-1 pooling of
the SED variants through the sed_pool kernels and the ``gst`` variant's
no-grad re-encode through the attention kernel.  The attention kernel has
no backward, so the encode that trains runs the plain attention, as the
reference's models train through jnp (``seq_setup`` builds the two
encodes).  The LM track (``train_lm``) minimises next-token NLL +
1e-2·aux under a cosine schedule; it has no no-grad pass, so its
attention is always the plain version.  The reference has no frames for
the encoder-decoder on these tracks (its encoder reads
``inputs["frames"]``, which the token pipelines do not make); the port
draws stub frames from the seed there.

Telemetry (``repro_torch.obs``; ``--metrics``, ``--metrics-out``,
``--metrics-interval``, ``--trace-out``, ``--torch-trace-annotations``):
every track records a ``train.step`` span a step.  The graph track ticks
the stream an epoch with the staleness probe
(``src/repro/graphs/experiment.py``); ``--track seq`` ticks every
``--log-every`` steps with the store's counters and the probe, ``--track
lm`` (no table) with its loss.  Off, the registry and the tracer are the
shared no-op ones.  ``--mem-probe`` raises (ROADMAP A3b).

    PYTHONPATH=src python -m repro_torch.launch.train --track graph \
        --device cpu --epochs 3 --finetune-epochs 1 --n-graphs 48 \
        --metrics-out t.jsonl --trace-out t_trace.json
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core import gst as G
from repro_torch.data.tokens import (doc_batch_iterator, make_lm_stream,
                                     make_property_docs)
from repro_torch.graphs.experiment import epoch_generator
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree
from repro_torch.obs import Obs, StalenessProbe, add_obs_args, span
from repro_torch.obs.export import summary_lines
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.store import DeviceStore, TieredStore


def train_graph(args, obs=None):
    from repro_torch.graphs.experiment import run_experiment
    r = run_experiment(
        dataset=args.dataset, backbone=args.backbone, variant=args.variant,
        n_graphs=args.n_graphs, epochs=args.epochs,
        finetune_epochs=args.finetune_epochs, keep_prob=args.keep_prob,
        seed=args.seed, use_kernels=args.use_kernels, device=args.device,
        table_device_rows=args.table_device_rows,
        evict_policy=args.evict_policy,
        wb_threshold=args.wb_threshold,
        sed_age_weighting=args.sed_age_weighting,
        stale_forecast=args.stale_forecast, obs=obs)
    print(f"[graph/{args.dataset}] {args.backbone} {args.variant}"
          f"{' [kernels]' if args.use_kernels else ''} on {args.device}: "
          f"train={r.train_metric:.3f} test={r.test_metric:.3f} "
          f"{r.ms_per_iter:.1f} ms/iter")
    return r


@dataclass
class SeqResult:
    """What ``train_seq`` / ``train_lm`` give back (the CLI prints it)."""
    losses: List[float]           # every step's loss
    metrics: List[float]          # every step's metric (seq: accuracy)
    ms_per_step: float            # median wall ms a step after the first 3
    step_ms: List[float]          # every step's wall ms, synced
    state: object                 # seq: the TrainState; lm: the ParamTree
    store_stats: Optional[dict] = None
    ckpt: Optional[str] = None    # the checkpoint written (--ckpt-dir)


def _arch_config(args):
    cfg = get_config(args.arch)
    return reduce_cfg(cfg) if args.reduced else cfg


def stub_frames(cfg, batch_shape, seed: int, step: int, device):
    """The encoder-decoder's stub frame embeddings (batch_shape + (T,
    d_model)), drawn from (seed, step); None for the other families."""
    if not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng([seed, step])
    x = rng.standard_normal(tuple(batch_shape) + (cfg.encoder_seq_len,
                                                  cfg.d_model))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _median_ms(times):
    return (float(np.median(times[3:])) if len(times) > 4
            else float("nan"))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seq_setup(args):
    """(model, docs, state, step, store) of ``--track seq``: the backbone
    is the model's parameter tree as a module, the (n_docs, J, d_model)
    table the device tier of a ``DeviceStore`` or, under
    ``--table-device-rows``, a ``TieredStore``.  The encode that trains
    runs the plain attention (the kernel has no backward); under
    ``--use-kernels`` the ``gst`` variant's no-grad re-encode launches the
    attention kernel."""
    cfg = _arch_config(args)
    dev = resolve_device(args.device)
    model = build_model(cfg, use_kernels=args.use_kernels, device=dev)
    graded = build_model(cfg, use_kernels=False, device=dev)
    J, L = cfg.gst_num_segments, args.seg_len
    docs = make_property_docs(n_docs=args.n_docs, n_segments=J, seg_len=L,
                              vocab=cfg.vocab_size,
                              n_topics=cfg.gst_num_classes, seed=args.seed)
    gen = torch.Generator(dev).manual_seed(args.seed)
    backbone = ParamTree(model.init(gen))
    head = G.head_init(cfg.d_model, cfg.gst_num_classes, "mlp", gen, dev)
    opt = make_optimizer("adamw", lr=args.lr, weight_decay=0.01)
    if args.table_device_rows:
        store = TieredStore(args.n_docs, J, cfg.d_model,
                            device_rows=max(args.table_device_rows,
                                            args.batch_size),
                            device=dev, evict_policy=args.evict_policy,
                            wb_threshold=args.wb_threshold,
                            stale_forecast=args.stale_forecast)
    else:
        store = DeviceStore(args.n_docs, J, cfg.d_model, device=dev)
    state = G.TrainState(backbone, head, None, store.init_device_table(), 0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))

    def encode(backbone, seg_inputs):
        return graded.encode_segment(backbone.tree, seg_inputs)

    def recompute(backbone, seg_inputs):
        return model.encode_segment(backbone.tree, seg_inputs)

    step = G.make_train_step(encode, opt, G.VARIANTS[args.variant],
                             keep_prob=args.keep_prob,
                             use_kernels=args.use_kernels,
                             sed_decay=args.sed_age_weighting,
                             recompute_fn=recompute)
    return model, docs, state, step, store


def seq_batch(model, tup, slots, seed: int, step: int) -> G.GSTBatch:
    """A ``doc_batch_iterator`` tuple as a batch on the model's device, its
    ids the store's device rows ``slots``."""
    dev = model.device
    inputs = {"tokens": torch.from_numpy(tup[0]["tokens"]).to(dev)}
    frames = stub_frames(model.cfg, tup[0]["tokens"].shape[:2], seed, step,
                         dev)
    if frames is not None:
        inputs["frames"] = frames
    return G.GSTBatch(inputs, torch.from_numpy(tup[1]).to(dev),
                      torch.from_numpy(np.asarray(slots, np.int64)).to(dev),
                      torch.from_numpy(tup[3]).to(dev))


def train_seq(args, log=print, obs=None) -> SeqResult:
    """``--track seq`` (``src/repro/launch/train.py:62-140``): GST training
    of ``encode_segment`` over the property documents, the batch's rows
    routed through the store with the step about to write them as the
    stale-first hint; then the pending write-backs flushed, the store
    closed and, under ``--ckpt-dir``, the backbone and head saved.  With
    ``obs`` enabled, every ``--log-every`` steps publish the store's
    counters and a staleness probe of the table and tick the stream."""
    model, docs, state, step, store = seq_setup(args)
    dev = model.device
    losses, metrics, times = [], [], []
    ckpt = None
    probe = StalenessProbe(keep_prob=args.keep_prob, num_sampled=1,
                           sed_decay=args.sed_age_weighting,
                           forecast=args.stale_forecast)
    try:
        rng = np.random.default_rng(args.seed)
        it = 0
        t_start = time.perf_counter()
        while it < args.steps:
            for tup in doc_batch_iterator(docs, args.batch_size, rng=rng):
                t0 = time.perf_counter()
                table, slots = store.prepare(state.table,
                                             np.asarray(tup[2]), step=it)
                state = state._replace(table=table)
                batch = seq_batch(model, tup, slots, args.seed, it)
                with span("train.step", step=it):
                    state, m = step(state, batch,
                                    epoch_generator(args.seed, it))
                losses.append(float(m["loss"]))     # waits for the step
                metrics.append(float(m["metric"]))
                _sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
                it += 1
                if it % args.log_every == 0:
                    log(f"step {it}: loss={losses[-1]:.4f} "
                        f"acc={metrics[-1]:.3f} ({(time.perf_counter() - t_start) / it * 1e3:.0f} ms/step)",
                        flush=True)
                    if obs is not None and obs.enabled:
                        store.publish_counters()
                        stale = probe.observe(store, state.table, it)
                        if obs.should_tick(it // args.log_every - 1):
                            obs.tick(step=it, loss=losses[-1],
                                     staleness=stale)
                if it >= args.steps:
                    break
        # surface any failed write-back before reporting success
        store.flush_writebacks()
        if args.table_device_rows:
            st = store.stats()
            log(f"store [{st['backend']}] device rows {st['device_rows']}/"
                f"{st['n_rows']}  hit-rate {st['hit_rate']:.2f}, "
                f"{st['evictions']} evictions, "
                f"{st['migration_bytes'] / 1024:.1f} KiB migrated",
                flush=True)
        if args.ckpt_dir:
            ckpt = save_checkpoint(args.ckpt_dir, it, {
                "backbone": state.backbone.tree,
                "head": dict(state.head.named_parameters())})
    finally:
        store.close()   # stop the write-back thread even on error
    return SeqResult(losses, metrics, _median_ms(times), times, state,
                     store.stats(), ckpt)


def lm_loss(model, params, tokens, frames=None):
    """Next-token NLL + 1e-2·aux of ``tokens`` (B, S + 1) under the model
    (``src/repro/launch/train.py:148-154``)."""
    inputs = {"tokens": tokens[:, :-1]}
    if frames is not None:
        inputs["frames"] = frames
    h, aux = model.forward_with_aux(params, inputs)
    logp = torch.log_softmax(model.logits(params, h).float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return torch.mean(nll) + 1e-2 * aux


def lm_setup(args):
    """(model, data, params as a ParamTree, optimizer, opt state) of
    ``--track lm``.  Every pass trains, so the attention is the plain
    version (the kernel has no backward) whatever ``--use-kernels``
    says, as the reference's ``--use-pallas`` does not reach this
    track."""
    cfg = _arch_config(args)
    dev = resolve_device(args.device)
    model = build_model(cfg, use_kernels=False, device=dev)
    data = make_lm_stream(args.n_docs, args.seg_len + 1, cfg.vocab_size,
                          seed=args.seed)
    params = ParamTree(model.init(torch.Generator(dev).manual_seed(
        args.seed)))
    opt = make_optimizer("adamw", lr=args.lr,
                         schedule=cosine_schedule(args.lr, args.steps, 10))
    return model, data, params, opt, opt.init(list(params.parameters()))


def lm_step(model, params, opt, opt_state, tokens, frames=None):
    """One LM step, in place: (opt_state, the loss)."""
    leaves = list(params.parameters())
    with torch.enable_grad():
        loss = lm_loss(model, params.tree, tokens, frames)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    _, opt_state, _ = opt.update(leaves, grads, opt_state)
    return opt_state, loss.detach()


def train_lm(args, log=print, obs=None) -> SeqResult:
    """``--track lm`` (``src/repro/launch/train.py:143-178``).  With
    ``obs``, every ``--log-every`` steps tick the stream with the loss
    (the track has no table to probe)."""
    model, data, params, opt, opt_state = lm_setup(args)
    dev = model.device
    rng = np.random.default_rng(args.seed)
    losses, times = [], []
    t_start = time.perf_counter()
    for it in range(args.steps):
        t0 = time.perf_counter()
        ids = rng.integers(0, len(data), args.batch_size)
        tokens = torch.from_numpy(data[ids]).to(dev)
        frames = stub_frames(model.cfg, (args.batch_size,), args.seed, it,
                             dev)
        with span("train.step", step=it):
            opt_state, loss = lm_step(model, params, opt, opt_state, tokens,
                                      frames)
        losses.append(float(loss))
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if (it + 1) % args.log_every == 0:
            log(f"step {it + 1}: lm_loss={losses[-1]:.4f} "
                f"({(time.perf_counter() - t_start) / (it + 1) * 1e3:.0f} "
                "ms/step)", flush=True)
            if obs is not None and obs.should_tick(
                    (it + 1) // args.log_every - 1):
                obs.tick(step=it + 1, loss=losses[-1])
    return SeqResult(losses, [], _median_ms(times), times, params)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--track", default="graph", choices=["graph", "seq", "lm"])
    ap.add_argument("--dataset", default="malnet", choices=["malnet", "tpugraphs"])
    ap.add_argument("--backbone", default="sage", choices=["gcn", "sage", "gps"])
    ap.add_argument("--n-graphs", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--finetune-epochs", type=int, default=10)
    ap.add_argument("--variant", default="gst_efd", choices=list(G.VARIANTS))
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="route the SpMM, the SED pooling and the gst "
                         "variant's no-grad re-encode's attention through "
                         "the port's kernels (their plain versions on the "
                         "CPU); the encode that trains and the lm track "
                         "run the plain attention (no backward)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--keep-prob", type=float, default=0.5)
    ap.add_argument("--table-device-rows", type=int, default=None,
                    help="cap device-resident historical-table rows; the "
                         "rest live in a host-RAM tier (store/tiered.py). "
                         "Default: the whole table on the device")
    ap.add_argument("--evict-policy", default="lru",
                    choices=["lru", "stale-first"],
                    help="device-tier eviction under --table-device-rows: "
                         "LRU or age-aware stale-first")
    ap.add_argument("--wb-threshold", type=float, default=0.0,
                    help="delta-gated write-back under --table-device-rows: "
                         "skip the host-tier emb write of evicted rows that "
                         "moved less than this. 0 = off, bit-exact")
    ap.add_argument("--sed-age-weighting", type=float, default=0.0,
                    help="λ of the exp(-λ·age) staleness decay folded into "
                         "the stale branch of Eq.-1 η (use_sed+use_table "
                         "variants). 0 = off")
    ap.add_argument("--stale-forecast", action="store_true",
                    help="extrapolate stale host-tier rows on fault-in "
                         "under --table-device-rows (store/forecast.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="does not reach the graph track (as in the "
                         "reference), which trains at 5e-3")
    # seq / lm tracks
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's CPU-sized variant (configs.reduced)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seg-len", type=int, default=64)
    ap.add_argument("--n-docs", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="seq track: save the backbone and head here at the "
                         "end (checkpoint/io.py)")
    add_obs_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    obs = Obs.from_args(args, run="train", track=args.track,
                        variant=args.variant)
    try:
        if args.track == "graph":
            r = train_graph(args, obs)
        else:
            r = (train_seq if args.track == "seq" else train_lm)(
                args, obs=obs)
            print(f"[{args.track}/{args.arch}"
                  f"{' reduced' if args.reduced else ''}] "
                  f"{args.variant if args.track == 'seq' else 'lm'} on "
                  f"{args.device}: loss {r.losses[0]:.4f} -> "
                  f"{r.losses[-1]:.4f}, {r.ms_per_step:.1f} ms/step")
        rec = obs.close()
        for line in summary_lines(rec) if rec is not None else ():
            print(line)
        return r
    finally:
        obs.close()


if __name__ == "__main__":
    main()
