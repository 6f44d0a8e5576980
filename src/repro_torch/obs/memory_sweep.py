"""The constant-memory sweep of the port: GST's headline claim, measured.

    python -m repro_torch.obs.memory_sweep --quick --device cpu
    python -m repro_torch.obs.memory_sweep                 # on the card
    python -m repro_torch.obs.memory_sweep --full-width    # the repo's width
    python -m repro_torch.obs.gate --memory-json build/gst_memory.json

Counterpart of ``benchmarks/bench_memory.py``, kept in the package (the
reference's benchmark folder is its own).  The segment budget stays fixed
while the graphs grow (``comm`` communities a graph, so more segments J a
graph), and each leg is measured through the memory probe's two modes
(``obs/memory.py::measure_call``: the card's allocator, or on the CPU the
live bytes of the storages the call's ops create), one warm-up call first
so first-use workspaces stay out of the measured one:

* ``gst_step``   the GST train step (``gst_efd``): its temp bytes should
                 stay nearly flat;
* ``full_step``  the full-graph step (``full``: every segment gets
                 activations and a backward), the control that must grow;
* ``streaming``  ``make_stream_encoder`` on each point's largest graph:
                 temp independent of the chunk count and at least
                 ``accounting_bound_bytes`` (``max_intermediate_bytes``);
* ``ladder``     each serve-ladder bucket's encode peak and their total.

Two geometries: the reference's (hidden 32, ``max_seg_nodes`` 32, batch
4, 4 graphs, comm 2/4/8/16, or 2/4/8 with ``--quick``) and, with
``--full-width``, the repo's (hidden 64, ``max_seg_nodes`` 64, batch 8, 8
graphs, comm 4/16/64/256/512, J up to ~700).  Both: sage, stream chunk 4,
the port's kernels (their plain versions on CPU tensors).

Writes the ``gst_memory`` schema that either package's gate reads
(``--memory-json``), merge-keyed by the configuration, the torch version
and the device's kind; ``--out`` defaults to ``build/gst_memory.json``
under the repo.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gst as G
from repro_torch.core.embedding_table import init_table
from repro_torch.graphs import batching as Bt
from repro_torch.graphs import data as D
from repro_torch.graphs.experiment import epoch_generator, to_batch
from repro_torch.graphs.gnn import (GNNConfig, encode_segments, gnn_init,
                                    make_encode_fn)
from repro_torch.graphs.partition import partition_graph
from repro_torch.kernels.ops import max_intermediate_bytes
from repro_torch.obs.memory import measure_call
from repro_torch.optim import make_optimizer
from repro_torch.serve.buckets import batch_bucket, default_ladder, pad_to_bucket
from repro_torch.serve.engine import (graph_to_chunks, make_stream_encoder,
                                      to_device)

# (n_graphs, batch_size, hidden, max_seg_nodes, comms, quick comms)
REFERENCE = dict(n_graphs=4, batch_size=4, hidden=32, max_seg_nodes=32,
                 comms=(2, 4, 8, 16), quick_comms=(2, 4, 8))
FULL_WIDTH = dict(n_graphs=8, batch_size=8, hidden=64, max_seg_nodes=64,
                  comms=(4, 16, 64, 256, 512), quick_comms=(4, 16, 64))
BACKBONE = "sage"
STREAM_CHUNK = 4
DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / \
    "gst_memory.json"


def _weights(cfg: GNNConfig, dev):
    gen = torch.Generator().manual_seed(0)
    bb = gnn_init(cfg, gen, "cpu").to(dev)
    head = G.head_init(cfg.hidden, 5, "mlp", gen, "cpu").to(dev)
    return bb, head


def make_point(comm: int, *, n_graphs: int, max_seg_nodes: int,
               batch_size: int):
    """One size point: (graphs, segmented dataset, first batch, meta)."""
    graphs = D.make_malnet_like(n_graphs=n_graphs, seed=0,
                                comm_range=(comm, comm + 1))
    ds = Bt.segment_dataset(graphs, max_seg_nodes, method="bfs", seed=0)
    tup = next(Bt.batch_iterator(ds, batch_size,
                                 rng=np.random.default_rng(0), shuffle=False))
    meta = {"comm": comm, "j_max": int(ds.j_max),
            "nodes_mean": round(float(np.mean([len(g.x) for g in graphs])),
                                1)}
    return graphs, ds, tup, meta


def train_leg(tup, variant: str, *, n_rows: int, hidden: int, dev):
    """A fresh state (a table of ``n_rows`` graphs) and ``variant``'s train
    step for the batch ``tup`` (its J and feature width set the table's
    and the backbone's), warmed up by one step: (the step, the arguments
    of the next one).  Also the paper tables' Figure 1 step
    (``repro_torch.paper.paper_tables.fig1_memory``)."""
    _, j_max, _, n_feat = tup[0]["x"].shape
    cfg = GNNConfig(backbone=BACKBONE, n_feat=n_feat, hidden=hidden,
                    use_kernels=True)
    bb, head = _weights(cfg, dev)
    opt = make_optimizer("adam", lr=1e-3)
    state = G.TrainState(bb, head, None,
                         init_table(n_rows, j_max, hidden, device=dev), 0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))
    step = G.make_train_step(make_encode_fn(cfg), opt, G.VARIANTS[variant],
                             keep_prob=0.5, use_kernels=True)
    batch = to_batch(*tup, dev)
    state, _ = step(state, batch, epoch_generator(0, 0))
    return step, (state, batch, epoch_generator(0, 1))


def bench_steps(ds, tup, meta, *, hidden: int, dev) -> Dict:
    """gst_efd vs full train-step bytes at one graph size, each leg its
    own fresh state."""
    out = dict(meta)
    for leg, variant in (("gst", "gst_efd"), ("full", "full")):
        step, args = train_leg(tup, variant, n_rows=ds.n, hidden=hidden,
                               dev=dev)
        out[leg], _ = measure_call(step, args)
        del step, args
    return out


def bench_streaming(graphs, meta, *, hidden: int, max_seg_nodes: int,
                    dev) -> Dict:
    """The streaming encoder on the point's largest graph: the chunk count
    grows with the graph, the temp bytes must not."""
    cfg = GNNConfig(backbone=BACKBONE, n_feat=graphs[0].x.shape[1],
                    hidden=hidden, use_kernels=True)
    g = max(graphs, key=lambda gr: len(gr.x))
    spec = default_ladder(max_seg_nodes)[-1]
    chunks = graph_to_chunks(g, spec, STREAM_CHUNK,
                             partition_max_nodes=max_seg_nodes)
    stream = make_stream_encoder(cfg)
    bb, head = _weights(cfg, dev)
    args = (bb, head, chunks, dev)
    stream(*args)
    rec, _ = measure_call(stream, args)
    rec.update(meta, n_chunks=int(chunks["seg_valid"].shape[0]),
               accounting_bound_bytes=int(max_intermediate_bytes(stream,
                                                                 *args)))
    return rec


def bench_ladder(*, max_seg_nodes: int, hidden: int, dev,
                 n_feat: int = 8) -> Dict:
    """Each serve-ladder bucket's encode peak and their total."""
    cfg = GNNConfig(backbone=BACKBONE, n_feat=n_feat, hidden=hidden,
                    use_kernels=True)
    bb, _ = _weights(cfg, dev)
    g = D.make_malnet_like(n_graphs=1, seed=0)[0]

    @torch.no_grad()
    def encode(p, si):
        return encode_segments(p, cfg, si)

    buckets = []
    for spec in default_ladder(max_seg_nodes):
        segs = partition_graph(len(g.x), g.edges, spec.m_max, "bfs", 0)
        padded = [pad_to_bucket(g, s, spec) for s in segs[:spec.batch]]
        seg_inputs, _ = batch_bucket(padded, spec)
        inputs = to_device(seg_inputs, dev)
        encode(bb, inputs)
        rec, _ = measure_call(encode, (bb, inputs))
        rec["key"] = spec.key
        buckets.append(rec)
    return {"buckets": buckets,
            "total_peak_bytes": int(sum(b["peak_bytes"] for b in buckets))}


def _ratio(points, leg, field="peak_bytes") -> Optional[float]:
    vals = [p[leg][field] for p in points]
    if not vals or min(vals) <= 0:
        return None
    return round(max(vals) / min(vals), 4)


def summarize(points, streaming, ladder) -> Dict:
    """The gated claims, under the reference's keys
    (``benchmarks/bench_memory.py:212-230``)."""
    stream_temps = [s["temp_bytes"] for s in streaming]
    return {
        "gst_temp_ratio_max_over_min": _ratio(points, "gst", "temp_bytes"),
        "full_temp_ratio_max_over_min": _ratio(points, "full", "temp_bytes"),
        "gst_peak_ratio_max_over_min": _ratio(points, "gst"),
        "full_peak_ratio_max_over_min": _ratio(points, "full"),
        "streaming_temp_ratio_max_over_min": round(
            max(stream_temps) / max(min(stream_temps), 1), 4),
        "streaming_bound_ok": all(
            s["temp_bytes"] >= s["accounting_bound_bytes"]
            for s in streaming),
        "ladder_total_peak_bytes": ladder["total_peak_bytes"],
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the first three sizes of the geometry's sweep")
    ap.add_argument("--full-width", action="store_true",
                    help="the repo's width (hidden 64, max_seg_nodes 64, "
                         "batch 8, 8 graphs, comm 4..512) in place of the "
                         "reference's")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    return ap


def main(argv=None, log=print) -> Dict:
    """Run the sweep, merge it into ``--out``, and return its entry."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    geo = FULL_WIDTH if args.full_width else REFERENCE
    comms = geo["quick_comms"] if args.quick else geo["comms"]
    log(f"{'comm':>5s} {'J':>4s} {'nodes':>8s} {'gst temp':>10s} "
        f"{'full temp':>11s} {'stream temp':>11s} {'chunks':>6s}")
    points, streaming = [], []
    for comm in comms:
        graphs, ds, tup, meta = make_point(
            comm, n_graphs=geo["n_graphs"],
            max_seg_nodes=geo["max_seg_nodes"],
            batch_size=geo["batch_size"])
        pt = bench_steps(ds, tup, meta, hidden=geo["hidden"], dev=dev)
        st = bench_streaming(graphs, meta, hidden=geo["hidden"],
                             max_seg_nodes=geo["max_seg_nodes"], dev=dev)
        points.append(pt)
        streaming.append(st)
        log(f"{comm:5d} {pt['j_max']:4d} {pt['nodes_mean']:8.1f} "
            f"{pt['gst']['temp_bytes']:10d} {pt['full']['temp_bytes']:11d} "
            f"{st['temp_bytes']:11d} {st['n_chunks']:6d}")
    ladder = bench_ladder(max_seg_nodes=geo["max_seg_nodes"],
                          hidden=geo["hidden"], dev=dev)
    summary = summarize(points, streaming, ladder)
    log("summary: " + json.dumps(summary))

    config = {"sweep_comms": list(comms), "n_graphs": geo["n_graphs"],
              "batch_size": geo["batch_size"], "hidden": geo["hidden"],
              "max_seg_nodes": geo["max_seg_nodes"], "backbone": BACKBONE,
              "stream_chunk": STREAM_CHUNK, "quick": args.quick,
              "full_width": args.full_width}
    env = {"backend": dev.type, "torch": torch.__version__,
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "device_count": (torch.cuda.device_count()
                            if dev.type == "cuda" else 1)}
    keep = ("comm", "j_max", "nodes_mean")
    entry = {"summary": summary, "config": config, "env": env,
             "gst_step": [{**{k: p[k] for k in keep}, **p["gst"]}
                          for p in points],
             "full_step": [{**{k: p[k] for k in keep}, **p["full"]}
                           for p in points],
             "streaming": streaming, "ladder": ladder}
    run_key = ",".join(f"{k}={v}" for k, v in sorted(config.items())) + \
        f",backend={env['backend']},device_kind={env['device_kind']}" + \
        f",torch={env['torch']},device_count={env['device_count']}"
    payload = {"benchmark": "gst_memory", "unit": "bytes", "runs": {}}
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                prev = json.load(f)
            if prev.get("benchmark") == "gst_memory" and \
                    isinstance(prev.get("runs"), dict):
                payload = prev
        except (json.JSONDecodeError, OSError):
            pass
    payload["runs"][run_key] = entry
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    log(f"wrote {args.out} ({len(payload['runs'])} tracked run configs)")
    return entry


if __name__ == "__main__":
    main()
