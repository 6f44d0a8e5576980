"""Graph-property serving launcher of the port: replay synthetic request
traffic through the segment-streaming inference engine (serve/engine.py).

    PYTHONPATH=src python -m repro_torch.launch.serve_graphs \
        --requests 64 --unique 24 --duplicate-rate 0.5 --window 8

Runs on the card (``--device cuda``, the default; it raises where no card
is visible) unless ``--device cpu`` is given.  Reports p50/p99 request
latency, throughput, cross-request cache hit-rate, encode batches and
kernel launches.  ``--check-parity`` verifies a sample of engine
predictions against the one-shot batch encoder and exits nonzero on
mismatch; ``--min-hit-rate`` turns the hit-rate into an assertion.
``--table-device-rows`` caps the cache's device-resident rows over a
host-RAM tier (``--evict-policy``, ``--wb-threshold`` and
``--stale-forecast`` act on that tier).  ``--metrics``, ``--trace-out``
and ``--mem-probe`` land with the telemetry slice.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def build_engine(args):
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = ServeConfig(
        backbone=args.backbone,
        use_kernels=args.use_kernels,
        max_seg_nodes=args.max_seg_nodes,
        cache_capacity=args.cache_capacity,
        cache_enabled=not args.no_cache,
        table_device_rows=args.table_device_rows,
        evict_policy=args.evict_policy,
        wb_threshold=args.wb_threshold,
        stale_forecast=args.stale_forecast,
        stream_chunk=args.stream_chunk,
        device=args.device,
    )
    return ServeEngine(cfg, seed=args.seed)


@torch.no_grad()
def check_parity(engine, graphs, atol: float) -> float:
    """Engine predictions vs the one-shot batch encoder (training-style
    padding, every segment of a graph encoded in one flat batch)."""
    from repro_torch.core import gst as G
    from repro_torch.graphs.batching import segment_dataset
    from repro_torch.graphs.gnn import encode_segments
    from repro_torch.graphs.partition import partition_graph
    from repro_torch.serve.engine import to_device

    worst = 0.0
    for g in graphs:
        res = engine.process([g], window=1)[0]
        segs = partition_graph(len(g.x), g.edges, engine.cfg.max_seg_nodes,
                               engine.cfg.partition, engine.cfg.partition_seed)
        ds = segment_dataset([g], engine.cfg.max_seg_nodes,
                             method=engine.cfg.partition,
                             seed=engine.cfg.partition_seed)
        si = to_device({k: v[0] for k, v in
                        ds.seg_inputs(np.array([0])).items()}, engine.device)
        h = encode_segments(engine.params, engine.gnn_cfg, si)[:len(segs)]
        ref = G.head_apply(engine.head, h.mean(dim=0), "mlp")
        worst = max(worst, float(np.abs(res.pred - ref.cpu().numpy()).max()))
    if worst > atol:
        raise SystemExit(f"PARITY FAIL: engine vs one-shot max diff {worst:.3e} "
                         f"> atol {atol:.1e}")
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--unique", type=int, default=24)
    ap.add_argument("--duplicate-rate", type=float, default=0.5)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--backbone", default="sage", choices=["gcn", "sage", "gps"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) raises where no card is visible")
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="gcn/sage message passing through the CUDA SpMM "
                         "kernel on the card (gps always runs plain torch)")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--cache-capacity", type=int, default=512)
    ap.add_argument("--table-device-rows", type=int, default=None,
                    help="cap device-resident cache rows; cold entries "
                         "spill to a host-RAM tier and fault back on hit "
                         "instead of being re-encoded (store/tiered.py). "
                         "Default: all cache rows on the device")
    ap.add_argument("--evict-policy", default="lru",
                    choices=["lru", "stale-first"],
                    help="device-tier eviction under --table-device-rows: "
                         "LRU or age-aware stale-first")
    ap.add_argument("--wb-threshold", type=float, default=0.0,
                    help="delta-gated write-back under --table-device-rows: "
                         "skip the host-tier emb write of spilled rows that "
                         "moved less than this (max-abs) while resident. "
                         "0 = gate off, bit-exact")
    ap.add_argument("--stale-forecast", action="store_true",
                    help="extrapolate stale host rows forward on fault-in "
                         "under --table-device-rows (store/forecast.py)")
    ap.add_argument("--popularity", type=float, default=0.0,
                    help="repeat-request skew: P(graph) ∝ "
                         "times_served**popularity over distinct seen "
                         "graphs (0 = uniform, 1 = rich-get-richer)")
    ap.add_argument("--max-seg-nodes", type=int, default=64)
    ap.add_argument("--stream-chunk", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=4,
                    help="requests replayed first (stats are reset "
                         "afterwards; cache is NOT reset, pass --cold-cache "
                         "to flush it)")
    ap.add_argument("--cold-cache", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-parity", action="store_true")
    ap.add_argument("--parity-atol", type=float, default=1e-5)
    ap.add_argument("--min-hit-rate", type=float, default=None)
    args = ap.parse_args(argv)

    from repro_torch.serve.traffic import TrafficConfig, make_request_stream

    engine = build_engine(args)
    tc = TrafficConfig(n_unique=args.unique, n_requests=args.requests,
                       duplicate_rate=args.duplicate_rate,
                       popularity=args.popularity, seed=args.seed)
    stream = make_request_stream(tc)
    try:
        return _run(args, engine, stream)
    finally:
        engine.close()


def _run(args, engine, stream):
    if args.warmup:
        engine.process(stream[:args.warmup], window=args.window)
        engine.reset_stats()
        if args.cold_cache and engine.cache is not None:
            engine.cache.flush()  # cold contents

    engine.process(stream, window=args.window)
    s = engine.stats.summary()

    dev = engine.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve_graphs] device={dev} ({name}) backbone={args.backbone} "
          f"kernels={args.use_kernels} "
          f"cache={'off' if args.no_cache else 'on'}")
    print(f"  requests          {s['n_requests']}  ({s['n_segments']} segments)")
    print(f"  throughput        {s['throughput_req_s']:.1f} req/s")
    print(f"  latency p50/p99   {s['latency_p50_ms']:.3f} / "
          f"{s['latency_p99_ms']:.3f} ms")
    print(f"  encode launches   {s['encode_launches']} "
          f"({s['encoded_segments']} segments encoded, "
          f"{s['kernel_launches']} kernel launches)")
    if s.get("truncated_nodes") or s.get("truncated_edges"):
        print(f"  TRUNCATED         {s['truncated_nodes']} nodes, "
              f"{s['truncated_edges']} edges dropped by catch-all "
              f"bucket overflow")
    if s["cache"]:
        c = s["cache"]
        print(f"  cache             hit-rate {c['hit_rate']:.2f} "
              f"({c['hits']} hits / {c['misses']} misses), "
              f"{c['size']}/{c['capacity']} slots, "
              f"{c['evictions']} evictions, "
              f"age mean/max {c['age_mean_steps']:.1f}/{c['age_max_steps']} steps")
        st = c["store"]
        print(f"  store             [{st['backend']}] device rows "
              f"{st['occupancy']}/{st['device_rows']} "
              f"(of {st['n_rows']} total), tier hit-rate "
              f"{st['hit_rate']:.2f}, {st['evictions']} spills, "
              f"{st['migration_bytes'] / 1024:.1f} KiB migrated")

    if args.check_parity:
        worst = check_parity(engine, stream[:3], args.parity_atol)
        print(f"  parity            OK (max |engine - one-shot| = {worst:.2e})")
    if args.min_hit_rate is not None:
        hr = s["cache"].get("hit_rate", 0.0) if s["cache"] else 0.0
        if hr <= args.min_hit_rate:
            raise SystemExit(f"HIT-RATE FAIL: {hr:.3f} <= {args.min_hit_rate}")
        print(f"  hit-rate check    OK ({hr:.2f} > {args.min_hit_rate})")
    return s


if __name__ == "__main__":
    main()
