#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path and its graph-track training path on the card
at the repo's full model width (GNNConfig / ServeConfig / run_experiment
defaults: hidden 64, 2 message-passing layers, max_seg_nodes 64, batch 8)
with random weights from a seed, and holds each hand-written kernel against
its plain PyTorch version.  Phases, in order; an error in any of them fails
the run (none catches its own):

  1. card       the device name and nvidia-smi's name and power limit
  2. build      nvcc builds every kernel source from the checkout, all at
                once; registers, spills and shared memory from -Xptxas -v
  3. kernel     each kernel vs its plain version, two launches bitwise
                equal, times (CUDA events) beside the bound from bytes and
                flops and one PyTorch library call as the yardstick:
                segment_spmm_batched at the three serving buckets, the two
                training shapes and a stress shape (1e-5); its backward
                (dh by the same kernel with src and dst swapped, dw in
                torch) against plain autograd (1e-4); sed_pool and
                sed_pool_aged at the two training shapes and a 64 MiB
                stress shape (1e-5)
  4. serving    the default TrafficConfig replay through ServeEngine on cuda
                for sage and gcn: kernel launches = encode batches x n_mp,
                every encoded bucket batch = the plain encoder on the card,
                engine = one-shot encoder (serve_graphs --check-parity);
                latency, throughput, hit rate, host time by trace span
  5. streaming  predict_streaming on a >= 10,000-node graph = process(), and
                peak device memory flat from 2 to 16 chunks
  6. training   run_experiment on cuda with kernels on (gst_efd: sage on
                MalNet-like, gcn on TpuGraphs-like, sage with SED age
                weighting 0.05), epochs cut from 30 to 5 and finetune epochs
                from 10 to 2: first 3 train steps of the kernel path = the
                plain path on the card given the same draws, with n_mp SpMM
                forward, n_mp backward and one sed_pool (or sed_pool_aged)
                launch per step; then the run itself: finite metrics, the
                finetune phase ran, launches as the step counts predict;
                ms per iteration and peak device memory
  7. kernels    one JSON line: per kernel, launches on the main path
                (serving and training), error, times and bound

It exits nonzero without a result where torch.cuda.is_available() is False
or where the port's sources are not beside it.  The last line of standard
output is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate, and f32 outside the tensor cores
# (the kernel's FMAs are plain f32).  The rates assume the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TOL = 1e-5   # f32, from the reference's own kernel tests (test_fused_path.py:48)

GRAD_TOL = 1e-4   # gradients and step parity (test_fused_path.py:73,185)

# (N, m, e, d): the three serving buckets (8 segments a batch, e = 8 m,
# hidden 64), then the stress shape at the kernel's stated limits
SERVING_SHAPES = [(8, 16, 128, 64), (8, 32, 256, 64), (8, 64, 512, 64)]
STRESS_SHAPE = (64, 1024, 8192, 128)
HEADLINE_SHAPE = (8, 64, 512, 64)   # the catch-all serving bucket
# the training path at run_experiment's defaults (80 graphs, 60 to train,
# e_max 382): N = B*S = 8 sampled segments a train step, N = B*J_max = 160
# in eval, refresh and the full-graph variants
TRAIN_SHAPES = [(8, 64, 382, 64), (160, 64, 382, 64)]
# (B, J, d): the mlp head's pooling (J_max 20, hidden 64), the segment_sum
# head's (J_max 16, one scalar a segment), and a 64 MiB stress shape
SED_SHAPES = [(8, 20, 64), (8, 16, 1), (1024, 64, 256)]
# (dataset, backbone, SED age weighting λ); epochs cut for time
TRAIN_RUNS = [("malnet", "sage", 0.0), ("tpugraphs", "gcn", 0.0),
              ("malnet", "sage", 0.05)]
TRAIN_EPOCHS, FINETUNE_EPOCHS = 5, 2     # run_experiment's are 30 and 10


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
    """Build every csrc/*.cu at once (one nvcc each) and load the wrappers'
    libraries."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import sed_pool as sp
    from repro_torch.kernels import segment_spmm as spmm

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    spmm._lib()
    sp._lib()
    log(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for path in paths:
        report = path.with_suffix(".log")
        log(f"[build] {path.relative_to(ROOT)}")
        for line in report.read_text().splitlines() if report.exists() else []:
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def sparse_adjacency(torch, src, dst, w, m):
    """Yardstick only (the port never calls it): the block-diagonal
    (N·m x N·m) COO matrix with w at (dst, src)."""
    N = src.shape[0]
    offs = torch.arange(N, device=src.device)[:, None] * m
    idx = torch.stack([(dst.long() + offs).reshape(-1),
                       (src.long() + offs).reshape(-1)])
    return torch.sparse_coo_tensor(idx, w.reshape(-1), (N * m, N * m),
                                   check_invariants=True).coalesce()


def bound(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def phase_kernel(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_spmm as spmm

    rows = []
    for shape in SERVING_SHAPES + TRAIN_SHAPES + [STRESS_SHAPE]:
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

        adj = sparse_adjacency(torch, src, dst, w, m)
        flat = h.reshape(N * m, d)
        lib_out = torch.sparse.mm(adj, flat).reshape(N, m, d)
        torch.testing.assert_close(lib_out, plain, rtol=TOL, atol=TOL)

        iters = 50 if shape == STRESS_SHAPE else 200
        ms = time_ms(torch, lambda: spmm.segment_spmm_batched(h, src, dst, w),
                     iters)
        plain_ms = time_ms(torch, lambda: ref.segment_spmm_batched_ref(
            h, src, dst, w), iters)
        library_ms = time_ms(torch, lambda: torch.sparse.mm(adj, flat), iters)
        row = {"shape": {"N": N, "m": m, "e": e, "d": d, "dtype": "float32"},
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               **bound(2 * N * m * d * h.element_size() + 3 * N * e * 4,
                       2 * N * e * d)}
        rows.append(row)
        log(f"[kernel] spmm N={N} m={m} e={e} d={d}: max|kernel-plain| "
            f"{err:.3e}, bitwise equal twice; kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, sparse.mm {library_ms:.6f} ms, bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}, {row['bytes']} B, "
            f"{row['flops']} flop)")
    return rows


def phase_kernel_bwd(torch, dev):
    """The SpMM backward: dh (the kernel with src and dst swapped) and dw
    (torch) against the plain version's autograd; the dh launch timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_spmm as spmm

    rows = []
    for shape in TRAIN_SHAPES + [STRESS_SHAPE]:
        N, m, e, d = shape
        h, src, dst, w = spmm_inputs(torch, N, m, e, d, seed=N + m + e,
                                     device=dev)
        g = torch.randn(N, m, d, device=dev,
                        generator=torch.Generator(dev).manual_seed(e))
        grads = []
        for fn in (spmm.segment_spmm_batched, ref.segment_spmm_batched_ref):
            hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
            torch.sum(fn(hh, src, dst, ww) * g).backward()
            grads.append((hh.grad, ww.grad))
        (dh, dw), (dh_ref, dw_ref) = grads
        again = spmm.segment_spmm_batched_transpose(g, src, dst, w)
        torch.cuda.synchronize()
        if not torch.equal(again, dh):
            raise AssertionError(f"{shape}: two backward launches differ")
        torch.testing.assert_close(dh, dh_ref, rtol=GRAD_TOL, atol=GRAD_TOL)
        torch.testing.assert_close(dw, dw_ref, rtol=GRAD_TOL, atol=GRAD_TOL)
        err = float((dh - dh_ref).abs().max())
        err_w = float((dw - dw_ref).abs().max())

        # the transposed block-diagonal matrix: w at (src, dst)
        adj_t = sparse_adjacency(torch, dst, src, w, m)
        flat = g.reshape(N * m, d)
        torch.testing.assert_close(torch.sparse.mm(adj_t, flat).reshape(
            N, m, d), dh_ref, rtol=TOL, atol=TOL)
        iters = 50 if shape == STRESS_SHAPE else 200
        ms = time_ms(torch, lambda: spmm.segment_spmm_batched_transpose(
            g, src, dst, w), iters)
        plain_ms = time_ms(torch, lambda: ref.segment_spmm_batched_ref(
            g, dst, src, w), iters)
        library_ms = time_ms(torch, lambda: torch.sparse.mm(adj_t, flat),
                             iters)
        row = {"shape": {"N": N, "m": m, "e": e, "d": d, "dtype": "float32"},
               "max_abs_err": err, "dw_max_abs_err": err_w, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **bound(2 * N * m * d * 4 + 3 * N * e * 4, 2 * N * e * d)}
        rows.append(row)
        log(f"[kernel] spmm backward N={N} m={m} e={e} d={d}: max|dh-plain| "
            f"{err:.3e}, max|dw-plain| {err_w:.3e}, bitwise equal twice; dh "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, sparse.mm (A^T) "
            f"{library_ms:.6f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']})")
    return rows


def sed_inputs(torch, B, J, d, seed, device):
    """Rows of 1..J valid segments, one fresh segment a row, random drops
    (row 0 drops every stale segment), ages 0..29."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, J + 1, B)
    valid = (np.arange(J)[None, :] < n_valid[:, None]).astype(np.float32)
    fresh = np.zeros((B, J), np.float32)
    fresh[np.arange(B), rng.integers(0, n_valid)] = 1.0
    drop = (rng.uniform(size=(B, J)) > 0.5).astype(np.float32)
    drop[0] = 1.0
    ages = rng.integers(0, 30, (B, J)).astype(np.float32)
    h = torch.randn(B, J, d, device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    return [h] + [torch.from_numpy(a).to(device)
                  for a in (valid, fresh, drop, ages)]


def phase_kernel_sed(torch, dev, aged):
    """sed_pool (or sed_pool_aged at λ = 0.05) against the plain version,
    timed beside torch.bmm(eta, h) with η precomputed (the yardstick leaves
    out η's construction and the mean's division)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sed_pool as sp

    decay = 0.05 if aged else 0.0
    rows = []
    for shape in SED_SHAPES:
        B, J, d = shape
        h, valid, fresh, drop, ages = sed_inputs(torch, B, J, d, seed=B + d,
                                                 device=dev)
        ages = ages if aged else None
        kw = dict(keep_prob=0.5, num_sampled=1, agg="mean", ages=ages,
                  decay=decay)
        a = sp.sed_pool(h, valid, fresh, drop, **kw)
        b = sp.sed_pool(h, valid, fresh, drop, **kw)
        plain = ref.sed_pool_ref(h, valid, fresh, drop, 0.5, 1, "mean", ages,
                                 decay)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{shape}: two launches differ bitwise")
        torch.testing.assert_close(a, plain, rtol=TOL, atol=TOL)
        err = float((a - plain).abs().max())
        eta, _ = ref.sed_eta(valid, fresh, drop, 0.5, 1, ages, decay)
        eta3 = eta[:, None, :].contiguous()
        torch.testing.assert_close(torch.bmm(eta3, h)[:, 0], torch.sum(
            h * eta[..., None], dim=1), rtol=TOL, atol=TOL)

        iters = 50 if shape == SED_SHAPES[-1] else 200
        ms = time_ms(torch, lambda: sp.sed_pool(h, valid, fresh, drop, **kw),
                     iters)
        plain_ms = time_ms(torch, lambda: ref.sed_pool_ref(
            h, valid, fresh, drop, 0.5, 1, "mean", ages, decay), iters)
        library_ms = time_ms(torch, lambda: torch.bmm(eta3, h), iters)
        planes = 4 if aged else 3
        # per (b, j): J_b's add, 6 operations of η (3 more for the age);
        # per output: J multiply-adds and the mean's division
        flops = (7 + 3 * aged) * B * J + 2 * B * J * d + B * d
        row = {"shape": {"B": B, "J": J, "d": d, "dtype": "float32"},
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               **bound((B * J * d + planes * B * J + B * d) * 4, flops)}
        rows.append(row)
        log(f"[kernel] {'sed_pool_aged' if aged else 'sed_pool'} B={B} J={J} "
            f"d={d}: max|kernel-plain| {err:.3e}, bitwise equal twice; "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bmm "
            f"{library_ms:.6f} ms, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}, {row['bytes']} B, {row['flops']} flop)")
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


def train_step_parity(torch, dev, dataset, backbone, decay):
    """The first train steps of the kernel path against the plain path on
    the card, given the same draws, each from the same state
    (``repro_torch.core.step_parity``: losses rtol 1e-4, gradients and
    parameters 1e-4, the table 1e-5).  The third step shows the first
    step's batch again, so the table's stale segments (and, with a decay,
    their ages) weigh in Eq. 1 on both paths.  Each kernel step must launch
    n_mp SpMM forwards, n_mp backwards and one pooling."""
    import numpy as np

    from repro_torch.core.step_parity import kernel_step_parity
    from repro_torch.graphs.batching import batch_iterator
    from repro_torch.graphs.experiment import to_batch

    runs = []
    for use_kernels in (True, False):
        ds, st, step = train_setup(torch, dev, dataset, backbone, decay,
                                   use_kernels)
        runs.append((st, step))
    n_mp = st.backbone.cfg.n_mp
    want_counts = {"segment_spmm_batched": n_mp,
                   "segment_spmm_batched_bwd": n_mp,
                   "sed_pool": int(decay == 0), "sed_pool_aged": int(decay > 0)}
    tups = batch_iterator(ds, 8, rng=np.random.default_rng(3))
    b0, b1 = (to_batch(*t, dev) for _, t in zip(range(2), tups))
    worst, n_stale = kernel_step_parity(
        runs[0], runs[1], [b0, b1, b0], torch.Generator().manual_seed(1),
        want_counts)
    return want_counts, worst, n_stale


def train_setup(torch, dev, dataset, backbone, decay, use_kernels):
    """run_experiment's training set, model and gst_efd train step at its
    defaults, weights from seed 0: (dataset, state, step)."""
    from repro_torch.core import gst as G
    from repro_torch.graphs.experiment import load_datasets
    from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
    from repro_torch.optim import make_optimizer
    from repro_torch.store import DeviceStore

    (loss_kind, head_mode, agg, n_out), ds, _ = load_datasets(dataset, 80, 64)
    cfg = GNNConfig(backbone=backbone, n_feat=ds.x.shape[-1],
                    use_kernels=use_kernels)
    gen = torch.Generator().manual_seed(0)
    bb = gnn_init(cfg, gen, dev)
    head = G.head_init(cfg.hidden, n_out, head_mode, gen, dev)
    opt = make_optimizer("adam", lr=5e-3)
    table = DeviceStore(ds.n, ds.j_max, cfg.hidden,
                        device=dev).init_device_table()
    st = G.TrainState(bb, head, None, table, 0)
    st = st._replace(opt_state=opt.init(G.train_params(st)))
    return ds, st, G.make_train_step(
        make_encode_fn(cfg), opt, G.VARIANTS["gst_efd"], head_mode=head_mode,
        loss_kind=loss_kind, agg=agg, use_kernels=use_kernels,
        sed_decay=decay)


def phase_profile(torch, dev, n_steps=5):
    """Where a kernel-path train step's time goes (sage, MalNet-like):
    torch.profiler over ``n_steps`` steps after 3 warm-up steps; device
    events (kernels and copies) a step, their summed device time, the
    hand-written kernels' share, and the wall time under the profiler
    (which adds host overhead, so the busy share it gives is a lower
    bound).  Runs after the training runs: their ms per iteration is
    taken with no profiler attached."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.graphs.batching import batch_iterator
    from repro_torch.graphs.experiment import to_batch

    ds, st, step = train_setup(torch, dev, "malnet", "sage", 0.0, True)
    gen = torch.Generator().manual_seed(2)
    batches = [to_batch(*t, dev) for t in batch_iterator(
        ds, 8, rng=np.random.default_rng(4))][:n_steps]
    for batch in batches[:3]:
        st, _ = step(st, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            st, _ = step(st, batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    ours = [e for e in dev_events if "segment_spmm_fwd_kernel" in e.name
            or "sed_pool_fwd_kernel" in e.name]
    ours_us = sum(e.time_range.elapsed_us() for e in ours)
    n = len(batches)
    prof = {"steps": n, "device_events_per_step": len(dev_events) / n,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "wall_ms_per_step": wall_us / n / 1e3,
            "busy_share": busy_us / wall_us,
            "handwritten_launches_per_step": len(ours) / n,
            "handwritten_ms_per_step": ours_us / n / 1e3}
    log(f"[profile] {n} kernel-path train steps (sage, MalNet-like): "
        f"{prof['device_events_per_step']:.1f} device events a step, device "
        f"busy {prof['device_busy_ms_per_step']:.6f} ms of "
        f"{prof['wall_ms_per_step']:.6f} ms wall (busy share "
        f"{prof['busy_share']:.4f}; the profiler's overhead is in the wall), "
        f"hand-written kernels {prof['handwritten_launches_per_step']:.1f} "
        f"launches {prof['handwritten_ms_per_step']:.6f} ms a step")
    return prof


def phase_training(torch, dev, dataset, backbone, decay):
    """Step parity, then run_experiment on cuda with kernels on (the main
    path, its launches counted from 0)."""
    from repro_torch.graphs.experiment import run_experiment
    from repro_torch.kernels import ops

    per_step, worst, n_stale = train_step_parity(torch, dev, dataset,
                                                 backbone, decay)
    log(f"[training] {dataset}/{backbone} λ={decay}: 3 steps kernel path = "
        f"plain path (max param diff {worst:.3e}, {n_stale} stale segments "
        f"kept); launches a step {per_step}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    r = run_experiment(dataset=dataset, backbone=backbone, variant="gst_efd",
                       epochs=TRAIN_EPOCHS, finetune_epochs=FINETUNE_EPOCHS,
                       sed_age_weighting=decay, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated() - base
    if not (r.finetuned and r.use_kernels and all(map(
            math.isfinite, (r.train_metric, r.test_metric, r.ms_per_iter)))):
        raise AssertionError(f"{dataset}/{backbone}: bad result {r}")
    # run_experiment's defaults: 60 graphs to train (7 batches of 8), 20 to
    # test (2 batches); refresh encodes each training batch once
    n_mp, steps, ft = 2, r.train_steps, r.finetune_steps
    refresh, evals = steps // TRAIN_EPOCHS, 2
    pools = {"sed_pool": steps * (decay == 0) + ft + evals,
             "sed_pool_aged": steps * (decay > 0)}
    want = {"segment_spmm_batched": n_mp * (steps + refresh + evals),
            "segment_spmm_batched_bwd": n_mp * steps, **pools}
    if steps != 7 * TRAIN_EPOCHS or ft != 7 * FINETUNE_EPOCHS \
            or launches != want:
        raise AssertionError(f"{dataset}/{backbone}: {steps} steps, {ft} "
                             f"finetune steps, launches {launches}, want "
                             f"{want}")
    log(f"[training] {dataset}/{backbone} gst_efd λ={decay}: {steps} train "
        f"+ {ft} finetune steps in {seconds:.3f} s, train {r.train_metric:.4f}"
        f" test {r.test_metric:.4f}, {r.ms_per_iter:.6f} ms/iter, peak device"
        f" memory {peak} B above the {base} B allocated before; launches "
        f"{launches}")
    return launches, {"dataset": dataset, "backbone": backbone,
                      "sed_age_weighting": decay, "train_steps": steps,
                      "finetune_steps": ft, "train_metric": r.train_metric,
                      "test_metric": r.test_metric,
                      "ms_per_iter": r.ms_per_iter, "peak_bytes": peak,
                      "base_bytes": base, "seconds": seconds,
                      "launches": launches, "parity_max_param_diff": worst,
                      "parity_stale_kept": n_stale}


def kernel_entry(name, source, replaces, launches, rows, headline):
    head = rows[headline]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rows}


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
    bwd_rows = phase_kernel_bwd(torch, dev)
    sed_rows = phase_kernel_sed(torch, dev, aged=False)
    aged_rows = phase_kernel_sed(torch, dev, aged=True)
    main_launches = {}
    serving = []
    for backbone in ("sage", "gcn"):
        launches, summary = phase_serving(torch, dev, backbone)
        main_launches["segment_spmm_batched"] = \
            main_launches.get("segment_spmm_batched", 0) + launches
        serving.append(summary)
    phase_streaming(torch, dev)
    log(f"[training] epochs cut from 30 to {TRAIN_EPOCHS}, finetune epochs "
        f"from 10 to {FINETUNE_EPOCHS}, for time")
    training = []
    for dataset, backbone, decay in TRAIN_RUNS:
        launches, summary = phase_training(torch, dev, dataset, backbone,
                                           decay)
        for k, v in launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
        training.append(summary)

    profile = phase_profile(torch, dev)

    csrc = "src/repro_torch/kernels/csrc/"
    kernels = [
        kernel_entry("segment_spmm_batched", csrc + "segment_spmm.cu",
                     "src/repro/kernels/segment_spmm.py:52",
                     main_launches["segment_spmm_batched"], rows,
                     SERVING_SHAPES.index(HEADLINE_SHAPE)),
        kernel_entry("segment_spmm_batched_bwd", csrc + "segment_spmm.cu",
                     "src/repro/kernels/segment_spmm.py:52 (via _spmm_bwd "
                     ":138-142)",
                     main_launches["segment_spmm_batched_bwd"], bwd_rows, 0),
        kernel_entry("sed_pool", csrc + "sed_pool.cu",
                     "src/repro/kernels/sed_pool.py:27",
                     main_launches["sed_pool"], sed_rows, 0),
        kernel_entry("sed_pool_aged", csrc + "sed_pool.cu",
                     "src/repro/kernels/sed_pool.py:40",
                     main_launches["sed_pool_aged"], aged_rows, 0),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    log(json.dumps({"serving": serving, "training": training,
                    "profile": profile, "card": smi,
                    "seconds": time.perf_counter() - t0}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
