#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path on the card at the repo's full model width
(GNNConfig / ServeConfig defaults: hidden 64, 2 message-passing layers,
buckets m in {16, 32, 64}, an mlp head) with random weights from a seed, and
holds its hand-written kernel against the plain PyTorch version.  Phases,
in order; an error in any of them fails the run (none catches its own):

  1. card       the device name and nvidia-smi's name and power limit
  2. build      nvcc builds the kernel from the checkout's sources
  3. kernel     segment_spmm_batched vs its plain version at the three
                serving buckets and a stress shape: within rtol = atol = 1e-5,
                two launches bitwise equal; kernel, plain and torch.sparse.mm
                times (CUDA events) beside the bound from bytes and flops
  4. serving    the default TrafficConfig replay through ServeEngine on cuda
                for sage and gcn: kernel launches = encode batches x n_mp,
                every encoded bucket batch = the plain encoder on the card,
                engine = one-shot encoder (serve_graphs --check-parity);
                latency, throughput, hit rate, host time by trace span
  5. streaming  predict_streaming on a >= 10,000-node graph = process(), and
                peak device memory flat from 2 to 16 chunks
  6. kernels    one JSON line: per kernel, launches on the main path, error,
                times and bound

It exits nonzero without a result where torch.cuda.is_available() is False
or where the port's sources are not beside it.  The last line of standard
output is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate, and f32 outside the tensor cores
# (the kernel's FMAs are plain f32).  The rates assume the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TOL = 1e-5   # f32, from the reference's own kernel tests (test_fused_path.py:48)

# (N, m, e, d): the three serving buckets (8 segments a batch, e = 8 m,
# hidden 64), then the stress shape at the kernel's stated limits
SERVING_SHAPES = [(8, 16, 128, 64), (8, 32, 256, 64), (8, 64, 512, 64)]
STRESS_SHAPE = (64, 1024, 8192, 128)
HEADLINE_SHAPE = (8, 64, 512, 64)   # the catch-all serving bucket


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int) -> float:
    """Median device time of one call, from CUDA events around each call.

    Each round of 20 calls is queued behind a sleep kernel, so
    the host enqueues the round while the card is busy and the card then
    runs it back to back: the events time the device, not the host's launch
    overhead.  Rounds stay short because CUDA's queue of pending launches
    is bounded: once it is full, the host blocks.
    Where the sleep ended before the host finished a round, the events
    would include host gaps: the round is dropped and the sleep doubled."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_round = 20
    cycles = 50_000_000                     # ~25 ms at the H100's clock
    times = []
    while len(times) < iters:
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(per_round)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(per_round)]
        slept = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        slept.record()
        for s, e in zip(starts, ends):
            s.record()
            fn()
            e.record()
        host_kept_ahead = not slept.query()
        torch.cuda.synchronize()
        if host_kept_ahead:
            times += [s.elapsed_time(e) for s, e in zip(starts, ends)]
        elif cycles < 1_600_000_000:
            cycles *= 2
        else:
            raise RuntimeError("the host could not enqueue the timed calls "
                               "ahead of the card")
    return statistics.median(times)


def spmm_inputs(torch, N, m, e, d, seed, device):
    """Random edges with duplicates, the last quarter of each segment's
    edge list padding ((0, 0), w = 0, as graphs/batching.py pads)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_real = e - e // 4
    h = rng.normal(size=(N, m, d)).astype(np.float32)
    src = np.zeros((N, e), np.int32)
    dst = np.zeros((N, e), np.int32)
    w = np.zeros((N, e), np.float32)
    src[:, :n_real] = rng.integers(0, m, (N, n_real))
    dst[:, :n_real] = rng.integers(0, m, (N, n_real))
    dst[:, 1] = dst[:, 0]                  # duplicate destinations
    src[:, 1] = src[:, 0]                  # and a duplicate edge
    w[:, :n_real] = rng.uniform(0.1, 1.0, (N, n_real))
    return [torch.from_numpy(a).to(device) for a in (h, src, dst, w)]


def phase_card(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {name}; {torch.cuda.device_count()} visible")
    log(smi.splitlines()[0])
    return name, smi.splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_spmm as spmm

    t0 = time.perf_counter()
    path = _build.build("segment_spmm")
    spmm._lib()
    log(f"[build] {path.relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    report = path.with_suffix(".log")
    for line in report.read_text().splitlines() if report.exists() else []:
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build]   {line.strip()}")


def phase_kernel(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_spmm as spmm

    rows = []
    for shape in SERVING_SHAPES + [STRESS_SHAPE]:
        N, m, e, d = shape
        h, src, dst, w = spmm_inputs(torch, N, m, e, d, seed=N * m + e,
                                     device=dev)
        a = spmm.segment_spmm_batched(h, src, dst, w)
        b = spmm.segment_spmm_batched(h, src, dst, w)
        plain = ref.segment_spmm_batched_ref(h, src, dst, w)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{shape}: two launches differ bitwise")
        torch.testing.assert_close(a, plain, rtol=TOL, atol=TOL)
        err = float((a - plain).abs().max())

        # yardstick only (the port never calls it): one torch.sparse.mm on
        # the block-diagonal (N·m x N·m) COO matrix of (dst, src, w)
        offs = torch.arange(N, device=dev)[:, None] * m
        idx = torch.stack([(dst.long() + offs).reshape(-1),
                           (src.long() + offs).reshape(-1)])
        adj = torch.sparse_coo_tensor(idx, w.reshape(-1), (N * m, N * m),
                                      check_invariants=True).coalesce()
        flat = h.reshape(N * m, d)
        lib_out = torch.sparse.mm(adj, flat).reshape(N, m, d)
        torch.testing.assert_close(lib_out, plain, rtol=TOL, atol=TOL)

        iters = 50 if shape == STRESS_SHAPE else 200
        ms = time_ms(torch, lambda: spmm.segment_spmm_batched(h, src, dst, w),
                     iters)
        plain_ms = time_ms(torch, lambda: ref.segment_spmm_batched_ref(
            h, src, dst, w), iters)
        library_ms = time_ms(torch, lambda: torch.sparse.mm(adj, flat), iters)
        n_bytes = 2 * N * m * d * h.element_size() + 3 * N * e * 4
        flops = 2 * N * e * d
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        row = {"shape": {"N": N, "m": m, "e": e, "d": d, "dtype": "float32"},
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms, "bytes": n_bytes, "flops": flops}
        rows.append(row)
        log(f"[kernel] N={N} m={m} e={e} d={d}: max|kernel-plain| {err:.3e}, "
            f"bitwise equal twice; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"sparse.mm {library_ms:.6f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}, {n_bytes} B, {flops} flop)")
    return rows


def phase_serving(torch, dev, backbone):
    from repro_torch.graphs.gnn import encode_segments
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_graphs import check_parity
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.serve.engine import ServeConfig, ServeEngine, to_device
    from repro_torch.serve.traffic import TrafficConfig, make_request_stream

    engine = ServeEngine(ServeConfig(backbone=backbone, device="cuda"), seed=0)
    stream = make_request_stream(TrafficConfig())
    engine.process(stream[:4], window=8)          # warm-up, not counted
    engine.reset_stats()

    captured = []
    encode = engine._encode_bucket

    def capture(bi, seg_inputs):
        emb = encode(bi, seg_inputs)
        captured.append((seg_inputs, emb.clone()))
        return emb

    engine._encode_bucket = capture
    tracer = Tracer()
    previous = set_tracer(tracer)
    ops.reset_kernel_launches()
    results = engine.process(stream, window=8)
    torch.cuda.synchronize()
    launches = ops.kernel_launches()["segment_spmm_batched"]
    set_tracer(previous)
    engine._encode_bucket = encode
    spans_ms = {}
    for ev in tracer.events():    # host time per span name (ms)
        spans_ms[ev["name"]] = spans_ms.get(ev["name"], 0.0) + ev["dur"] / 1e3
    s = engine.stats.summary()

    n_mp = engine.gnn_cfg.n_mp
    if not (launches == s["kernel_launches"] == s["encode_launches"] * n_mp > 0):
        raise AssertionError(f"{backbone}: {launches} kernel launches, engine "
                             f"counted {s['kernel_launches']}, for "
                             f"{s['encode_launches']} encodes x {n_mp} layers")
    for r in results:
        if r.pred.shape != (engine.cfg.n_out,) or not bool(
                torch.isfinite(torch.from_numpy(r.pred)).all()):
            raise AssertionError(f"{backbone}: bad prediction {r.pred!r}")
    plain_cfg = dataclasses.replace(engine.gnn_cfg, use_kernels=False)
    worst = 0.0
    with torch.no_grad():
        for seg_inputs, emb in captured:
            want = encode_segments(engine.params, plain_cfg,
                                   to_device(seg_inputs, dev))
            torch.testing.assert_close(emb, want, rtol=TOL, atol=TOL)
            worst = max(worst, float((emb - want).abs().max()))
    parity = check_parity(engine, stream[:3], TOL)
    c = s["cache"]
    log(f"[serving] {backbone}: {s['n_requests']} requests "
        f"({s['n_segments']} segments), p50 {s['latency_p50_ms']:.6f} ms, "
        f"p99 {s['latency_p99_ms']:.6f} ms, {s['throughput_req_s']:.3f} req/s, "
        f"hit-rate {c['hit_rate']:.4f}, {s['encode_launches']} encode batches, "
        f"{launches} kernel launches; {len(captured)} batches = plain encoder "
        f"(max {worst:.3e}); engine vs one-shot {parity:.3e}")
    log(f"[serving] {backbone} host ms by span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(spans_ms.items())))
    engine.close()
    return launches, {"backbone": backbone, **{k: v for k, v in s.items()
                                               if k != "cache"},
                      "hit_rate": c["hit_rate"], "batch_max_abs_err": worst,
                      "parity_max_abs_err": parity, "spans_ms": spans_ms}


def phase_streaming(torch, dev):
    from repro_torch.graphs.data import make_malnet_like
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (ServeConfig, ServeEngine,
                                          graph_to_chunks, make_stream_encoder)

    engine = ServeEngine(ServeConfig(backbone="sage", device="cuda"), seed=0)
    graph = make_malnet_like(n_graphs=1, comm_range=(300, 301), seed=0)[0]
    n_nodes = len(graph.x)
    if n_nodes < 10_000:
        raise AssertionError(f"streaming graph has only {n_nodes} nodes")
    ops.reset_kernel_launches()
    pred = engine.predict_streaming(graph)
    stream_launches = ops.kernel_launches()["segment_spmm_batched"]
    want = engine.process([graph], window=1)[0].pred
    torch.testing.assert_close(torch.from_numpy(pred), torch.from_numpy(want),
                               rtol=TOL, atol=TOL)

    cfg = engine.cfg
    chunks = graph_to_chunks(graph, engine.ladder[-1], cfg.stream_chunk,
                             partition=cfg.partition, seed=cfg.partition_seed,
                             partition_max_nodes=cfg.max_seg_nodes)
    n_chunks = chunks["seg_valid"].shape[0]
    if n_chunks < 16 or stream_launches != n_chunks * engine.gnn_cfg.n_mp:
        raise AssertionError(f"{n_chunks} chunks, {stream_launches} launches")
    stream = make_stream_encoder(engine.gnn_cfg)
    peak = {}
    for n in (1, 2, 16):
        sub = {k: v[:n] for k, v in chunks.items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stream(engine.params, engine.head, sub, dev)
        torch.cuda.synchronize()
        peak[n] = torch.cuda.max_memory_allocated() - base
    if not abs(peak[16] - peak[2]) < peak[1]:
        raise AssertionError(f"streaming peak grew with chunks: {peak}")
    log(f"[streaming] {n_nodes} nodes, {n_chunks} chunks of "
        f"{cfg.stream_chunk}, {stream_launches} kernel launches; "
        f"|stream - process| {float(abs(pred - want).max()):.3e}; peak bytes "
        f"above base: 1 chunk {peak[1]}, 2 chunks {peak[2]}, "
        f"16 chunks {peak[16]}")
    engine.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no result",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}: no result",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (switches TF32 off)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    name, smi = phase_card(torch)
    phase_build()
    rows = phase_kernel(torch, dev)
    main_launches = 0
    serving = []
    for backbone in ("sage", "gcn"):
        launches, summary = phase_serving(torch, dev, backbone)
        main_launches += launches
        serving.append(summary)
    phase_streaming(torch, dev)

    head = rows[SERVING_SHAPES.index(HEADLINE_SHAPE)]
    kernel = {"name": "segment_spmm_batched", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/segment_spmm.cu",
              "replaces": "src/repro/kernels/segment_spmm.py:52",
              "launches": main_launches,
              "max_abs_err": max(r["max_abs_err"] for r in rows),
              "ms": head["ms"], "plain_ms": head["plain_ms"],
              "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
              "library_ms": head["library_ms"], "shape": head["shape"],
              "shapes": rows}
    log(json.dumps({"serving": serving, "card": smi,
                    "seconds": time.perf_counter() - t0}))
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
