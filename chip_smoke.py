#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path, its graph-track training path and its
distributed training path (inline and through the prefetch lane) on the
card, each also over the tiered store, at the repo's full model width
(GNNConfig / ServeConfig / run_experiment defaults: hidden 64, 2
message-passing layers, max_seg_nodes 64, batch 8), and the sequence
track's training (GST and LM) and serving paths on internlm2-1.8b at
full width and depth, and its serving path on
qwen2-vl-7b, arctic-480b, deepseek-v3-671b, whisper-large-v3,
zamba2-1.2b and rwkv6-7b at full width (the two MoE models cut in depth
to fit the card), with random weights from a seed, and holds each
hand-written kernel against its plain PyTorch version.  Phases, in order; an error in any of them
fails the run (none catches its own):

  1. card       the device name and nvidia-smi's name and power limit
  2. build      nvcc builds every kernel source from the checkout, all at
                once (one nvcc each, in parallel); registers, spills and
                shared memory from -Xptxas -v; swa_attention's registers,
                spills and dynamic shared memory a template instance
  3. kernel     each kernel vs its plain version, two launches bitwise
                equal, times (CUDA events) beside the bound from bytes and
                flops and one PyTorch library call as the yardstick:
                segment_spmm_batched at the three serving buckets, the two
                training shapes and a stress shape (1e-5), and untimed at
                the cases of tests/_spmm_cases.py (a hub, weight-0
                repeats, a padding-only segment, out-of-range edges, d 1
                to 128, bf16, inf under a weight-0 edge); its backward
                (dh by the same kernel with src and dst swapped, dw in
                torch) against plain autograd (1e-4); sed_pool and
                sed_pool_aged at the two training shapes, the sequence track's
                (8, 8, 2048) and a 64 MiB
                stress shape (1e-5), beside torch.bmm and a launch floor
                (one torch.cuda._sleep(0) in the same timer); the six
                pack / unpack kernels of the
                compressed exchange BITWISE at the distributed run's own
                (R, N) (ring and alltoall lookups, bucketed buckets,
                write-backs), a 40 MiB stress shape and edge cases (R = 1,
                N not a multiple of 32, zero rows, ±0, nearest-even ties,
                NaN of both signs, ±inf, a row of NaN, rows wider than the
                int8 pack keeps in registers, x and v views off a 16-byte
                boundary), subnormal rows at N 8 and 1280 (scales under,
                at and just above FLT_MIN, subnormal x and quotients, the
                stochastic packs with bit words whose high 24 bits are
                zero: tests/_quant_cases.py), the stochastic int8 pack
                with its bits off x's 16-byte phase (the stress shape and
                a ragged N) and the int8 unpack at scales ±1e-40, beside x.to(bfloat16), .float() and
                torch.mul(v, scale[:, None]) (each bitwise the plain
                version) and, for the unpacks, a fill of their output;
                swa_attention (1e-5) at (B, S, H, KV, D, W) (2, 256, 4, 2,
                64, 128), (1, 2048, 16, 8, 128, full), (1, 4096, ..., 1024),
                (2, 1000, ..., 300), (1, 1, ..., full), (1, 777, 6, 1, 128,
                1), (2, 513, 8, 8, 64, 33) and seq_families' head shapes
                (1, 2048, 28, 4, 128, full), (1, 2048, 56, 8, 128, full),
                (2, 448, 20, 20, 64, full), (1, 2048, 32, 32, 64, full)
                against the (B, H, S, S) oracle,
                and (1, 32768, 16, 8, 128, full) against the plain chunked
                attention, beside scaled_dot_product_attention, with its
                3xTF32 tensor-core bound and its f32 FMA bound
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
  7. dist       train_dist with 4 shards as threads on the card (sage,
                gst_efd, 64 graphs, batch 8, hidden 64, max_seg_nodes 64):
                ring / int8, alltoall / bf16, bucketed / int8 with SED age
                weighting 0.05 (epochs cut from 5 to 3, finetune epochs
                from 3 to 2).  Each: the first 3 distributed steps of
                the kernel path = the plain path on the card given the
                same draws and bits, a stale segment kept, the launches of
                every shard as the exchange predicts; then the run: finite
                metrics, the finetune phase ran, every kernel's launches
                as the step counts predict, the exchange bytes a step as
                the model; ms per iteration, peak memory, exch KiB.  Then
                the same f32 run through the three strategies, 2 epochs:
                identical per-epoch losses.  Then 5 ring / int8 steps
                under torch.profiler (device busy share), and the wall
                time of a step at 1, 2 and 4 shards
 7b. dist_prefetch  train_dist --prefetch-lookups, the same 4 shards and
                width, epochs cut to 2 and finetune epochs to 1 (as the
                f32 strategy runs): (d') ring / f32: per-epoch losses,
                parameters and final table bitwise the inline ring / f32
                run; (e') alltoall / bf16 and (f') bucketed / int8 λ 0.05:
                finite, launches as Exchange.codec_launches predicts with
                "prefetch_lookup" and "update_sampled_patch", exchange
                bytes a step a shard = prefetch_train_step_bytes (+ the
                age plane at λ > 0), bucketed's patch bytes and planned
                patch_cap printed; (g') ring / f32 on 2 shards, sync
                feeder, --table-device-rows 32 (the lane's window, 2
                batches a shard, of 64 rows): bitwise the uncapped
                prefetched run, rows evicted under the pins, no pin
                exhaustion; (h') ring, alltoall, bucketed / f32: 4
                batches of one row set through the launcher's lane,
                every row of the first 3 patched, bitwise the inline
                loop; then 5 ring / f32 steps inline and through the
                lane under torch.profiler (busy share)
  8. store      the tiered embedding store: (a) training run (a) again with
                max(10% of its 60 training graphs, a batch) = 8 rows on the
                card: per-epoch losses, metrics and final table bitwise the
                uncapped run; ms per iteration, peak memory, hit rate,
                faults, evictions, bytes each way, write-back waits; (b) the
                same with stale-first eviction and the delta gate at 0.05,
                then with the forecaster: finite, write-backs skipped, rows
                forecast; (c) the sage replay with 64 of the cache's 512
                rows on the card: predictions bitwise the uncapped engine,
                p50 / p99 beside it; (d) train_dist ring / int8 with
                --table-device-rows 16 (32 of 64 rows: a batch a shard):
                per-epoch losses bitwise the uncapped ring / int8 run,
                exchange bytes the model; (e) a table of 262,144 rows x J
                20 x d 64 (1.34 GB pinned host tier, 10% on the card):
                begin + commit and the write-back's landing for 8, 64 and
                1,024 misses with as many evictions, as GB/s each way;
                then 200 random batches: snapshot bitwise a DeviceStore's
  8a. telemetry  the obs spine (repro_torch.obs) on the graph paths,
                kernels on, each path four times in turns: telemetry off,
                on (a JSONL stream and a Chrome trace), on, off; every run
                bitwise the first, launches equal, and
                repro_torch.obs.gate passes the stream and the trace:
                (1) run_experiment (a) (losses, metrics, final table; the
                row-age p99 under the SED bound); (2) serve_graphs' replay
                (sage; p99 budget 3x the slowest run without, encode
                launches under windows x buckets + segments / the smallest
                bucket batch); (3) train_dist ring / int8, 4 shards, 2
                epochs, inline and --prefetch-lookups (--expect-dist,
                --expect-prefetch; exchange.bytes.ring.int8 = shard 0's
                counted bytes); (4) an epoch of (a) under torch.profiler
                with --torch-trace-annotations: a train.step range a
                step.  ms_per_iter and p50 / p99 of every turn.  Streams
                and traces under chiprun_out/telemetry/
 8b. seq_train  internlm2-1.8b at full width and depth (f32, random),
                launch.train: (a) --track seq gst_efd, kernels, batch 8
                x J 8 x 64 tokens, 64 documents, 3 steps: sed_pool once
                a step at (8, 8, 2048), the attention kernel never (the
                encode that trains runs the plain attention); (b)
                --no-use-kernels: losses and parameters within 1e-4; (c)
                --table-device-rows 16: bitwise (a); (d) --variant gst,
                2 steps: the attention kernel 24 times a step (the
                no-grad re-encode, one call a layer); (e) --track lm, 8
                steps: finite, loss falling; ms a step, peak memory
                above the weights, one profiled gst_efd step; every
                state freed (1 GiB at most stays)
 9. seq_serve  internlm2-1.8b (1.9 B parameters, f32) on the card: (a)
                launch.serve.serve, B 2, prompt 16, 16 generated tokens,
                ms a token; (b) Model.prefill of that prompt = the decode
                loop (5e-4); (c) prefill B 2, S 2048, kernel path = plain
                path (last logits, every layer's caches, 5e-4); (d)
                prefill B 1, S 32768 through the kernel: time, peak
                memory; (e) forward with window 8192 at S 16384, finite,
                its first layer's attention = the plain chunked version;
                (f) encode_segment over 8 documents x 8 segments x 512
                tokens, kernel = plain (5e-4).  24 swa_attention launches
                in each of (b)-(f); then one profiled prefill of (c)
 10. seq_families  the other families at full width, f32, random
                weights from seed 0, one at a time (card memory printed
                before each build): qwen2-vl-7b (M-RoPE, patches),
                arctic-480b cut to 1 of 35 layers, deepseek-v3-671b cut
                to 1 dense + 1 MoE layer of 61, whisper-large-v3
                (encoder-decoder), zamba2-1.2b (32 Mamba2 layers, 6
                shared attention occurrences) and rwkv6-7b, nothing cut.
                Each: (a) launch.serve.serve B 2, prompt 16, 16
                generated, ms a token; (b) prefill of that prompt = the
                decode loop (logits, every cache, 5e-4); (c) prefill B 1,
                S 2048 (qwen2-vl's first 256 positions patches; whisper:
                1500 frames, decoder S 448), kernel path = plain path,
                seconds and peak memory above the weights (rwkv6's plain
                path, its kernel path's code, without a warm-up call of
                its own); (d) encode_segment 8 x 512 tokens (whisper 8 x
                1500 frames), kernel = plain; a profiled decode step.
                swa_attention launches a pass: 28, 1, 0 (MLA), 32, 6, 0
 11. recurrent  the plain-torch pieces without a kernel in the reference,
                one layer at full width: zamba2's ssd_chunked and rwkv6's
                rwkv_timemix at B 1, S 2048, one decode step of each
                layer at B 2: ms a call, launches, device busy time
 12. kernels    one JSON line: per kernel, launches on the main path
                (serving, training, distributed training, dist_prefetch,
                the store's (a), (c) and (d), telemetry, seq_train,
                seq_serve and seq_families),
                error, times and bound

    python3 chip_smoke.py --turns PARENT_DIR

times phase 3's SpMM and pack / unpack kernels, the sage serving
replay's latency, the first training run's ms per iteration and the
profiled train step's device time of the checkout at PARENT_DIR and of
this one in turns (parent, this, this, parent), each in a process of its
own, and runs nothing else.

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

# NVIDIA H100 SXM data sheet: HBM3 rate, f32 outside the tensor cores (the
# graph-track and codec kernels' plain f32 arithmetic) and dense TF32 on the
# tensor cores (swa_attention's products, three TF32 products for each f32
# one: 3xTF32).  The rates assume the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
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
SED_SHAPES = [(8, 20, 64), (8, 16, 1), (8, 8, 2048), (1024, 64, 256)]
# (dataset, backbone, SED age weighting λ); epochs cut for time
TRAIN_RUNS = [("malnet", "sage", 0.0), ("tpugraphs", "gcn", 0.0),
              ("malnet", "sage", 0.05)]
TRAIN_EPOCHS, FINETUNE_EPOCHS = 5, 2     # run_experiment's are 30 and 10
# the distributed runs: 4 shards as threads on the one card, train_dist's
# defaults (64 graphs, batch 8) at the graph track's full width, epochs
# cut from 5 to 3 and finetune epochs from 3 to 2 for time; (exchange,
# payload dtype, SED age weighting λ)
DIST_SHARDS = 4
DIST_EPOCHS, DIST_FINETUNE_EPOCHS = 3, 2
DIST_ARGS = ["--device", "cuda", "--devices", str(DIST_SHARDS),
             "--backbone", "sage", "--variant", "gst_efd", "--n-graphs", "64",
             "--batch-size", "8", "--hidden", "64", "--max-seg-nodes", "64",
             "--epochs", str(DIST_EPOCHS),
             "--finetune-epochs", str(DIST_FINETUNE_EPOCHS)]
DIST_RUNS = [("ring", "int8", 0.0), ("alltoall", "bf16", 0.0),
             ("bucketed", "int8", 0.05)]
# the prefetch lane (dist_prefetch): the distributed run's shape with
# epochs cut to 2 and finetune epochs to 1 (as the f32 strategy runs);
# (d') ring / f32 against the inline ring / f32 run, (e') alltoall / bf16,
# (f') bucketed / int8 λ 0.05, then (g') ring / f32 under a capped table
PREFETCH_EPOCHS = ["--epochs", "2", "--finetune-epochs", "1"]
PREFETCH_RUNS = [("ring", "f32", 0.0), ("alltoall", "bf16", 0.0),
                 ("bucketed", "int8", 0.05)]
PREFETCH_DEVICE_ROWS = 32
PREFETCH_CAPPED_SHARDS = 2            # (g'): 32 of 64 rows are the window
PREFETCH_OVERLAP_STEPS = 4            # (h'): batches of one row set
# the telemetry phase's streams and traces (inside the checkout, ignored
# by git)
TELEMETRY_DIR = ROOT / "chiprun_out" / "telemetry"
QUANT_STRESS = (8192, 1280)             # 40 MiB of f32 rows
# (R, N, element offset of x and v in their buffers) edge cases: one row,
# N not a multiple of 32, a wide ragged row, rows with NaN of both signs,
# ±inf and all NaN (quant_inputs, R > 4), one row at the lookup's N, rows
# wider than the int8 pack keeps in registers (quant.REGISTER_N), and
# views that start off a 16-byte boundary
QUANT_EDGES = [(1, 4, 0), (3, 33, 0), (2, 1000, 0), (6, 37, 0), (1, 1280, 0),
               (6, 20001, 0), (6, 1281, 1), (2, 1280, 3)]
# (R, N, element offsets of x and of the random bits in their buffers): the
# stochastic int8 pack with its bits off x's 16-byte phase, at the stress
# shape (bits at each other phase) and at a ragged N (bit loads of 4, 4
# and 8 bytes)
QUANT_BITS_EDGES = [(8192, 1280, 0, 1), (8192, 1280, 0, 2), (8192, 1280, 0, 3),
                    (6, 1281, 1, 0), (6, 1281, 1, 2), (6, 1281, 1, 3)]
# widths of the subnormal rows of tests/_quant_cases.py (scales under, at
# and just above FLT_MIN, subnormal x and quotients; the stochastic packs
# with bit words whose high 24 bits are zero)
QUANT_SUBNORMAL_N = (8, 1280)
# the store phase: (a) training run (a) with about 10% of its training
# graphs device-resident (no fewer than a batch); (c) the serving cache
# with an eighth of its rows on the device; (d) the ring / int8
# distributed run with --table-device-rows 16 (raised to a batch a shard);
# (e) a table its users hold: 262,144 rows x J 20 x d 64 f32 (1.34 GB in
# the pinned host tier), 10% device-resident, batches of 8, 64 and 1,024
# misses timed, then 200 random batches against the DeviceStore
STORE_DEVICE_FRAC = 0.1
STORE_CACHE_DIVISOR = 8
STORE_DIST_ROWS = 16
MIGRATION_TABLE = (262_144, 20, 64)
MIGRATION_BATCHES = (8, 64, 1024)
MIGRATION_REPEATS = 5
MIGRATION_STEPS = 200
# the sequence track: internlm2-1.8b at full width and depth (24 layers,
# d_model 2048, 16 query and 8 KV heads of 128, d_ff 8192, vocab 92,544)
SEQ_ARCH = "internlm2-1.8b"
# seq_train: the sequence track's GST training (--track seq, gst_efd) of
# SEQ_ARCH at full width and depth: batch 8 of J 8 segments of 64 tokens,
# 64 documents, 3 steps a run; the capped run keeps 16 of the 64 rows on
# the card; --track lm takes SEQ_LM_STEPS steps
SEQ_TRAIN = ["--track", "seq", "--arch", SEQ_ARCH, "--batch-size", "8",
             "--seg-len", "64", "--n-docs", "64", "--steps", "3",
             "--log-every", "1"]
SEQ_TRAIN_ROWS = 16
SEQ_LM_STEPS = 8
# (B, S, H, KV, D, W; None = full causal): the reduced model's width, the
# full model at 2048 tokens, a windowed 4096, S and W not multiples of a
# tile, one token, a GQA ratio of 6 on one KV head with only the diagonal
# visible (S ragged), no GQA at D 64 with a window across a tile edge;
# the head shapes of seq_families' prefills: qwen2-vl-7b and arctic-480b
# at 2048 tokens (G 7), whisper-large-v3's decoder at B 2, S 448 (G 1, D
# 64), zamba2-1.2b's shared attention at 2048 tokens (G 1, D 64); then
# prefill_32k's length at batch 1
SWA_SHAPES = [(2, 256, 4, 2, 64, 128), (1, 2048, 16, 8, 128, None),
              (1, 4096, 16, 8, 128, 1024), (2, 1000, 16, 8, 128, 300),
              (1, 1, 16, 8, 128, None), (1, 777, 6, 1, 128, 1),
              (2, 513, 8, 8, 64, 33), (1, 2048, 28, 4, 128, None),
              (1, 2048, 56, 8, 128, None), (2, 448, 20, 20, 64, None),
              (1, 2048, 32, 32, 64, None)]
SWA_LONG = (1, 32768, 16, 8, 128, None)
SWA_HEADLINE = 1
SEQ_TOL = 5e-4   # forward vs decode, kernel vs plain model (test_models.py:40)
# seq_serve's sizes: serve (batch, prompt, generated); prefill (B, S) with
# both paths; prefill_32k's length at batch 1; the windowed forward's S;
# GST's segments (documents, segments a document, tokens a segment:
# train_4k's 4096 tokens in gst_num_segments 8)
SEQ_SERVE = (2, 16, 16)
SEQ_PREFILL = (2, 2048)
SEQ_LONG = (1, 32768)
SEQ_WINDOW_S = 16384
SEQ_DOCS = (8, 8, 512)
# seq_families: (arch, layers kept (None: all), swa_attention launches a
# full-sequence pass).  arctic-480b and deepseek-v3-671b keep their full
# width and lose depth to fit the card in f32 (1 layer: 52.4 GiB; 1 dense
# + 1 MoE layer: 51.9 GiB); deepseek-v3's MLA runs no swa_attention;
# zamba2-1.2b's 6 shared attention occurrences each launch it once
# between its 32 Mamba2 layers; rwkv6-7b is attention-free
FAMILY_RUNS = [("qwen2-vl-7b", None, 28), ("arctic-480b", 1, 1),
               ("deepseek-v3-671b", 2, 0), ("whisper-large-v3", None, 32),
               ("zamba2-1.2b", None, 6), ("rwkv6-7b", None, 0)]
# (c)'s prefill (B, S): whisper's decoder S is the public model's
# max_target_positions, over its 1500 frames; (d)'s segments (B, S)
FAMILY_PREFILL = (1, 2048)
# the families whose random stacks amplify f32 noise past SEQ_TOL end to end
# at full depth: (b) and (c) hold them layer by layer (recurrent_check)
RECURRENT = ("ssm", "hybrid")
WHISPER_DECODER_S = 448
FAMILY_DOCS = (8, 512)


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


def spmm_edges(e):
    """The real and padding edges of each segment of spmm_inputs."""
    return {"real": e - e // 4, "padding": e // 4}


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
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import sed_pool as sp
    from repro_torch.kernels import segment_spmm as spmm
    from repro_torch.kernels import swa_attention as swa

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    spmm._lib()
    sp._lib()
    qt._lib()
    swa._lib()
    log(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for path in paths:
        report = path.with_suffix(".log")
        log(f"[build] {path.relative_to(ROOT)}")
        for line in report.read_text().splitlines() if report.exists() else []:
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")
    swa_build = swa_build_report(swa, paths[names.index("swa_attention")])
    for inst, r in swa_build.items():
        log(f"[build] swa_attention {inst}: {r['registers']} registers, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
            f"loads, {r['smem_bytes']} B dynamic shared memory a block")
    return swa_build


def swa_build_report(swa, path):
    """swa_attention's registers and spills a template instance (D, HB:
    query heads a block), from -Xptxas -v, and its dynamic shared memory,
    from the library."""
    import re

    out, inst = {}, None
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            m = re.search(r"swa_attention_kernelILi(\d+)ELi(\d+)E", line)
            inst = f"D={m[1]} HB={m[2]}" if m else None
            if inst:
                out[inst] = {"smem_bytes":
                             swa._lib().swa_attention_smem_bytes(int(m[1]))}
        elif inst and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            out[inst]["spill_stores"] = int(m[1])
            out[inst]["spill_loads"] = int(m[2])
        elif inst and "Used" in line and "registers" in line:
            out[inst]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line)[1])
    if not out:
        raise AssertionError(f"no swa_attention_kernel in {path}.log")
    return out


def sparse_adjacency(torch, src, dst, w, m):
    """Yardstick only (the port never calls it): the block-diagonal
    (N·m x N·m) COO matrix with w at (dst, src)."""
    N = src.shape[0]
    offs = torch.arange(N, device=src.device)[:, None] * m
    idx = torch.stack([(dst.long() + offs).reshape(-1),
                       (src.long() + offs).reshape(-1)])
    return torch.sparse_coo_tensor(idx, w.reshape(-1), (N * m, N * m),
                                   check_invariants=True).coalesce()


def launched(counts):
    """The kernels launched at least once (no entry and 0 are the same)."""
    return {k: v for k, v in counts.items() if v}


def bound(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def spmm_stress_cases(torch, dev):
    """The SpMM cases of tests/_spmm_cases.py (a hub, weight-0 repeats, a
    padding-only segment, out-of-range edges, m 45, d 1 to 128, inf under
    a weight-0 edge; bf16 on five), untimed: forward and transpose within
    1e-5 of the plain version (6e-2 in bf16), NaN where it is, two launches
    bitwise equal; then dh and dw against the plain path (1e-4)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _spmm_cases import BF16_CASES, CASES, case
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_spmm as spmm

    for name in CASES:
        base = [torch.from_numpy(a).to(dev) for a in case(name)]
        for dtype in [torch.float32] + [torch.bfloat16] * (name in BF16_CASES):
            h, src, dst, w = [base[0].to(dtype)] + base[1:]
            tol = TOL if dtype == torch.float32 else 6e-2
            for fn, s_, d_ in ((spmm.segment_spmm_batched, src, dst),
                               (spmm.segment_spmm_batched_transpose, dst, src)):
                a, b = fn(h, src, dst, w), fn(h, src, dst, w)
                want = ref.segment_spmm_batched_ref(h, s_, d_, w)
                torch.cuda.synchronize()
                if not (bitwise_equal(torch, a, b)
                        and torch.equal(a.isnan(), want.isnan())):
                    raise AssertionError(f"spmm case {name}: two launches "
                                         "differ or NaN misplaced")
                torch.testing.assert_close(a.float(), want.float(), rtol=tol,
                                           atol=tol, equal_nan=True)
        # the gradients against the same autograd Function on the CPU,
        # where it runs the plain version (dw of an out-of-range edge reads
        # NaN or a wrapped row there, as the reference's dw does)
        grads = []
        for where in (dev, torch.device("cpu")):
            h, src, dst, w = (torch.from_numpy(a).to(where)
                              for a in case(name, 1))
            g = torch.randn(h.shape, generator=torch.Generator().manual_seed(
                3)).to(where)
            hh, ww = h.requires_grad_(), w.requires_grad_()
            torch.sum(spmm.segment_spmm_batched(hh, src, dst, ww) * g
                      ).backward()
            grads += [hh.grad.cpu(), ww.grad.cpu()]
        for got, want in ((grads[0], grads[2]), (grads[1], grads[3])):
            if not torch.equal(got.isnan(), want.isnan()):
                raise AssertionError(f"spmm case {name}: gradient NaN "
                                     "misplaced")
            torch.testing.assert_close(got, want, rtol=GRAD_TOL,
                                       atol=GRAD_TOL, equal_nan=True)
    log(f"[kernel] spmm stress cases ({', '.join(CASES)}; bf16 on "
        f"{', '.join(BF16_CASES)}): forward and transpose = plain, NaN in "
        "place, bitwise twice; dh and dw = the plain path")


def phase_kernel(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_spmm as spmm

    spmm_stress_cases(torch, dev)
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
               "edges": spmm_edges(e), "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               **bound(2 * N * m * d * h.element_size() + 3 * N * e * 4,
                       2 * N * e * d)}
        rows.append(row)
        log(f"[kernel] spmm N={N} m={m} e={e} d={d} ({row['edges']['real']} "
            f"real, {row['edges']['padding']} padding edges a segment): "
            f"max|kernel-plain| "
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
               "edges": spmm_edges(e), "max_abs_err": err,
               "dw_max_abs_err": err_w, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               **bound(2 * N * m * d * 4 + 3 * N * e * 4, 2 * N * e * d)}
        rows.append(row)
        log(f"[kernel] spmm backward N={N} m={m} e={e} d={d} "
            f"({row['edges']['real']} real, {row['edges']['padding']} padding "
            f"edges a segment): max|dh-plain| "
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
        # one near-empty kernel in the same timer: what a launch costs
        floor_ms = time_ms(torch, lambda: torch.cuda._sleep(0), iters)
        planes = 4 if aged else 3
        # per (b, j): J_b's add, 6 operations of η (3 more for the age);
        # per output: J multiply-adds and the mean's division
        flops = (7 + 3 * aged) * B * J + 2 * B * J * d + B * d
        row = {"shape": {"B": B, "J": J, "d": d, "dtype": "float32"},
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "launch_floor_ms": floor_ms,
               **bound((B * J * d + planes * B * J + B * d) * 4, flops)}
        rows.append(row)
        log(f"[kernel] {'sed_pool_aged' if aged else 'sed_pool'} B={B} J={J} "
            f"d={d}: max|kernel-plain| {err:.3e}, bitwise equal twice; "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bmm "
            f"{library_ms:.6f} ms, launch floor (_sleep(0)) {floor_ms:.6f} "
            f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}, "
            f"{row['bytes']} B, {row['flops']} flop)")
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
    sed = [e for e in dev_events if "sed_pool_kernel" in e.name]
    ours = sed + [e for e in dev_events if "segment_spmm_fwd_kernel" in e.name]
    ours_us = sum(e.time_range.elapsed_us() for e in ours)
    sed_us = sum(e.time_range.elapsed_us() for e in sed)
    n = len(batches)
    prof = {"steps": n, "device_events_per_step": len(dev_events) / n,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "wall_ms_per_step": wall_us / n / 1e3,
            "busy_share": busy_us / wall_us,
            "handwritten_launches_per_step": len(ours) / n,
            "handwritten_ms_per_step": ours_us / n / 1e3,
            "sed_pool_launches_per_step": len(sed) / n,
            "sed_pool_ms_per_step": sed_us / n / 1e3}
    log(f"[profile] {n} kernel-path train steps (sage, MalNet-like): "
        f"{prof['device_events_per_step']:.1f} device events a step, device "
        f"busy {prof['device_busy_ms_per_step']:.6f} ms of "
        f"{prof['wall_ms_per_step']:.6f} ms wall (busy share "
        f"{prof['busy_share']:.4f}; the profiler's overhead is in the wall), "
        f"hand-written kernels {prof['handwritten_launches_per_step']:.1f} "
        f"launches {prof['handwritten_ms_per_step']:.6f} ms a step, of them "
        f"sed_pool {prof['sed_pool_launches_per_step']:.1f} launches "
        f"{prof['sed_pool_ms_per_step']:.6f} ms")
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
            or launched(launches) != launched(want):
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


# ---------------------------------------------------------------------------
# the compressed exchange's pack and unpack kernels
# ---------------------------------------------------------------------------

# per element: operations (f32 rate) and bytes beyond the f32 row it reads
# or writes; int8 adds a 4-byte scale a row
QUANT_OPS = {"quant_pack_bf16_det": 1, "quant_pack_bf16": 3,
             "quant_pack_int8_det": 6, "quant_pack_int8": 11,
             "quant_unpack_bf16": 1, "quant_unpack_int8": 2}


def quant_bytes(name, R, N):
    n = R * N
    if name == "quant_pack_bf16_det":
        return n * 4 + n * 2
    if name == "quant_pack_bf16":
        return n * 8 + n * 2
    if name == "quant_pack_int8_det":
        return n * 4 + n + R * 4
    if name == "quant_pack_int8":
        return n * 8 + n + R * 4
    if name == "quant_unpack_bf16":
        return n * 2 + n * 4
    return n + R * 4 + n * 4                     # quant_unpack_int8


def quant_inputs(torch, R, N, seed, dev, offset=0):
    """Random rows; row 0 zero, row 1 with ±0, nearest-even ties of both
    grids and amax 127 (an int8 scale of exactly 1); where R > 4 and N > 3,
    row 2 with NaN of both signs, row 3 with ±inf, row 4 all NaN.  x is a
    view ``offset`` elements into its buffer."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, N)) * 3.0).astype(np.float32)
    x[0] = 0.0
    if R > 1:
        ties = np.asarray([-0.0, 1.0 + 2.0 ** -8, 63.5, -0.5, 2.5, 1e-30],
                          np.float32)
        x[1, :min(N, 6)] = ties[:min(N, 6)]
        x[1, -1] = 127.0
    if R > 4 and N > 3:
        x[2, 1], x[2, -2] = np.nan, -np.nan
        x[3, 0], x[3, -1] = np.inf, -np.inf
        x[4] = np.nan
    bits = rng.integers(0, 2 ** 32, (R, N), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    return (offset_view(torch, torch.from_numpy(x).to(dev), offset),
            torch.from_numpy(bits).to(dev))


def offset_view(torch, t, offset):
    """A contiguous copy of t that starts ``offset`` elements into a
    larger buffer (so off the buffer's alignment where offset > 0)."""
    if not offset:
        return t
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


def bitwise_equal(torch, a, b):
    if a.dtype in (torch.bfloat16, torch.float32):
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def dist_geometry():
    """The distributed runs' (J_max, hidden, bucketed cap), from the run's
    own set-up."""
    from repro_torch.launch.train_dist import build_parser, setup

    s = setup(build_parser().parse_args(
        DIST_ARGS + ["--exchange", "bucketed", "--payload-dtype", "int8"]))
    return s.ds.j_max, s.args.hidden, s.cap


def phase_kernel_quant(torch, dev):
    """The six pack / unpack kernels against their plain versions, BITWISE,
    two launches bitwise equal, at the distributed run's own (R, N), the
    stress shape and the edge cases; timed at the ring's lookup and
    write-back shapes and the stress shape, beside the one call that
    computes the same function where there is one (x.to(bfloat16),
    .float(), torch.mul(v, scale[:, None]), each first checked bitwise
    against the plain version; none for the int8 pack and for stochastic
    rounding), and the unpacks beside a fill of their f32 output alone."""
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import ref

    j_max, d, cap = dist_geometry()
    b_local, D = 8 // DIST_SHARDS, DIST_SHARDS
    shapes = {"lookup (ring)": (b_local, j_max * d, 0),
              "lookup (alltoall)": (D * b_local, j_max * d, 0),
              "lookup (bucketed)": (D * cap, j_max * d, 0),
              "write-back": (b_local, d, 0),
              "write-back (gathered)": (D * b_local, d, 0),
              "stress": (*QUANT_STRESS, 0)}
    shapes.update({f"edge {r}x{n}" + (f" at +{o}" if o else ""): (r, n, o)
                   for r, n, o in QUANT_EDGES})
    timed = ("lookup (ring)", "write-back", "stress")
    log(f"[quant] J_max {j_max}, hidden {d}, bucketed cap {cap}; shapes "
        + ", ".join(f"{k} {v}" for k, v in shapes.items())
        + "; subnormal rows at N " + ", ".join(map(str, QUANT_SUBNORMAL_N)))
    cases = [(label, R, N, offset, *quant_inputs(torch, R, N, seed=R * 7 + N,
                                                 dev=dev, offset=offset))
             for label, (R, N, offset) in shapes.items()]
    for n in QUANT_SUBNORMAL_N:
        x, bits = subnormal_inputs(torch, n, dev)
        cases.append((f"subnormal {x.shape[0]}x{n}", *x.shape, 0, x, bits))
    rows = {name: [] for name in QUANT_OPS}
    for label, R, N, offset, x, bits in cases:
        for dtype in ("bf16", "int8"):
            packs = {False: f"quant_pack_{dtype}_det",
                     True: f"quant_pack_{dtype}"}
            for stochastic, name in packs.items():
                b = bits if stochastic else None
                a1 = qt.quantize_rows(x, dtype, b)
                a2 = qt.quantize_rows(x, dtype, b)
                want = ref.quantize_rows_ref(x, dtype, b)
                torch.cuda.synchronize()
                for p1, p2, pw in zip(a1, a2, want):
                    if not bitwise_equal(torch, p1, p2):
                        raise AssertionError(f"{name} {R}x{N}: two launches "
                                             "differ")
                    if not bitwise_equal(torch, p1, pw):
                        raise AssertionError(f"{name} {R}x{N}: kernel != "
                                             "plain version")
                lib = (lambda: x.to(torch.bfloat16)) if name == \
                    "quant_pack_bf16_det" else None
                rows[name].append(quant_row(
                    torch, name, label, R, N, label in timed,
                    lambda: qt.quantize_rows(x, dtype, b),
                    lambda: ref.quantize_rows_ref(x, dtype, b), lib))
            parts = ref.quantize_rows_ref(x, dtype, bits)
            parts = (offset_view(torch, parts[0], offset),) + parts[1:]
            name = f"quant_unpack_{dtype}"
            u1 = qt.dequantize_rows(parts, dtype)
            u2 = qt.dequantize_rows(parts, dtype)
            uw = ref.dequantize_rows_ref(parts, dtype)
            lib = ((lambda: parts[0].float()) if dtype == "bf16" else
                   (lambda: torch.mul(parts[0], parts[1][:, None])))
            torch.cuda.synchronize()
            if not (bitwise_equal(torch, u1, u2)
                    and bitwise_equal(torch, u1, uw)):
                raise AssertionError(f"{name} {R}x{N}: kernel != plain or "
                                     "two launches differ")
            if not bitwise_equal(torch, lib(), uw):
                raise AssertionError(f"{name} {R}x{N}: the library call != "
                                     "plain version")
            rows[name].append(quant_row(
                torch, name, label, R, N, label in timed,
                lambda: qt.dequantize_rows(parts, dtype),
                lambda: ref.dequantize_rows_ref(parts, dtype), lib,
                fill=torch.empty((R, N), dtype=torch.float32, device=dev)
                if label in timed else None))
    rows["quant_pack_int8"] += quant_bits_phases(torch, dev)
    quant_subnormal_scales(torch, dev)
    return rows


def quant_bits_phases(torch, dev):
    """The stochastic int8 pack with its random bits off x's 16-byte phase
    (QUANT_BITS_EDGES), untimed: bitwise the plain version, two launches
    bitwise equal."""
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import ref

    rows = []
    for R, N, x_off, b_off in QUANT_BITS_EDGES:
        x, bits = quant_inputs(torch, R, N, seed=R * 7 + N, dev=dev,
                               offset=x_off)
        bits = offset_view(torch, bits, b_off)
        a1 = qt.quantize_rows(x, "int8", bits)
        a2 = qt.quantize_rows(x, "int8", bits)
        want = ref.quantize_rows_ref(x, "int8", bits)
        torch.cuda.synchronize()
        if not all(bitwise_equal(torch, p1, p2) and bitwise_equal(torch, p1, pw)
                   for p1, p2, pw in zip(a1, a2, want)):
            raise AssertionError(f"quant_pack_int8 {R}x{N}, x at +{x_off}, "
                                 f"bits at +{b_off}: kernel != plain or two "
                                 "launches differ")
        label = f"bits off x's phase {R}x{N}, x +{x_off}, bits +{b_off}"
        rows.append(quant_row(torch, "quant_pack_int8", label, R, N, False,
                              None, None, None))
    log("[quant] quant_pack_int8 with its bits off x's 16-byte phase: "
        + ", ".join(f"{R}x{N} x +{xo} bits +{bo}"
                    for R, N, xo, bo in QUANT_BITS_EDGES)
        + ": bitwise the plain version, two launches equal")
    return rows


def subnormal_inputs(torch, n, dev):
    """tests/_quant_cases.py's subnormal rows at width n on the card, with
    its bit words whose high 24 bits are zero."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from _quant_cases import subnormal_rows

    x, bits = subnormal_rows(n, seed=n)
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(bits.view(np.int32)).to(dev))


def quant_subnormal_scales(torch, dev):
    """The int8 unpack at subnormal scales: (5, -3) at ±1e-40 gives (0, -0)
    and (-0, 0), bitwise the plain version (the JAX package's bits);
    torch.mul keeps the subnormal products, so it is no yardstick there."""
    from repro_torch.kernels import quant as qt
    from repro_torch.kernels import ref

    sys.path.insert(0, str(ROOT / "tests"))
    from _quant_cases import subnormal_unpack

    v, s = (torch.from_numpy(a).to(dev) for a in subnormal_unpack())
    got = qt.dequantize_rows((v, s), "int8")
    want = ref.dequantize_rows_ref((v, s), "int8")
    torch.cuda.synchronize()
    bits = got.view(torch.int32).cpu().tolist()
    if not bitwise_equal(torch, got, want) or bits != [[0, -2 ** 31],
                                                       [-2 ** 31, 0]]:
        raise AssertionError(f"unpack_int8 at subnormal scales: {bits}")
    log("[quant] quant_unpack_int8 (5, -3) at scales ±1e-40: (0, -0) and "
        "(-0, 0), bitwise the plain version")


def quant_row(torch, name, label, R, N, timed, fn, plain, library, fill=None):
    row = {"shape": {"what": label, "R": R, "N": N}, "max_abs_err": 0.0,
           "ms": None, "plain_ms": None, "library_ms": None,
           **bound(quant_bytes(name, R, N), QUANT_OPS[name] * R * N + R)}
    if timed:
        iters = 50 if label == "stress" else 100
        row["ms"] = time_ms(torch, fn, iters)
        row["plain_ms"] = time_ms(torch, plain, iters)
        row["library_ms"] = (time_ms(torch, library, iters)
                             if library is not None else None)
        if fill is not None:      # the output's bytes written, nothing read
            row["fill_ms"] = time_ms(torch, lambda: fill.fill_(1.0), iters)
        log(f"[quant] {name} {label} ({R}, {N}): bitwise equal to the plain "
            f"version, twice; kernel {row['ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms, library "
            + (f"{row['library_ms']:.6f} ms" if library else "-")
            + (f", fill {row['fill_ms']:.6f} ms" if fill is not None else "")
            + f", bound {row['bound_ms']:.7f} ms ({row['bound_by']}, "
            f"{row['bytes']} B)")
    return row


# ---------------------------------------------------------------------------
# distributed training
# ---------------------------------------------------------------------------


def dist_args(exchange, dtype, decay, *extra, shards=DIST_SHARDS):
    from repro_torch.launch.train_dist import build_parser

    return build_parser().parse_args(
        DIST_ARGS + ["--exchange", exchange, "--payload-dtype", dtype,
                     "--sed-age-weighting", str(decay), *extra,
                     "--devices", str(shards)])


def dist_step_launches(ex, n_mp, decay, D):
    """A distributed train step's launches, all D shards together."""
    want = {"segment_spmm_batched": D * n_mp,
            "segment_spmm_batched_bwd": D * n_mp,
            "sed_pool": D * (decay == 0), "sed_pool_aged": D * (decay > 0)}
    for op in ("lookup", "update_sampled"):
        for k, v in ex.codec_launches(op).items():
            want[k] = want.get(k, 0) + D * v
    return want


def dist_step_parity(torch, exchange, dtype, decay):
    """The first 3 distributed steps, kernel path against plain path on
    the card (repro_torch.core.step_parity.dist_step_parity), batches 0, 1
    and 0 again of the first epoch."""
    from repro_torch.core.step_parity import dist_step_parity as parity
    from repro_torch.dist.pipeline import _assemble
    from repro_torch.launch.train_dist import setup

    runs = []
    for flag in ("--use-kernels", "--no-use-kernels"):
        s = setup(dist_args(exchange, dtype, decay, flag))
        runs.append((s.ctx, s.states, s.step))
    want = dist_step_launches(runs[0][2].exchanges[0], 2, decay,
                              DIST_SHARDS)
    sched = s.train_scheds[0]
    worst, n_stale = parity(
        runs[0], runs[1], [_assemble(s.ds, i) for i in (sched[0], sched[1],
                                                         sched[0])],
        torch.Generator().manual_seed(1), want)
    return want, worst, n_stale


def phase_dist(torch, exchange, dtype, decay):
    """Step parity, then train_dist on the card with kernels on (the main
    path, its launches counted from 0)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dist import run
    from repro_torch.dist.exchange import make_exchange

    per_step, worst, n_stale = dist_step_parity(torch, exchange, dtype,
                                                decay)
    log(f"[dist] {exchange}/{dtype} λ={decay}: 3 steps kernel path = plain "
        f"path on {DIST_SHARDS} shards (max param diff {worst:.3e}, "
        f"{n_stale} stale segments kept); launches a step {per_step}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    r = run(dist_args(exchange, dtype, decay),
            log=lambda msg, **k: log(f"[dist] run: {msg}"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated() - base
    if not (r.finetuned and all(map(math.isfinite, (
            r.train_metric, r.finetune_loss, r.ms_per_iter,
            *r.epoch_losses)))):
        raise AssertionError(f"dist {exchange}/{dtype}: bad result {r}")
    D, n_mp = DIST_SHARDS, 2
    ex = make_exchange(exchange, num_shards=D, rows=1, cap=r.cap,
                       payload_dtype=dtype)
    steps, ft, refresh = r.train_steps, r.finetune_steps, r.refresh_steps
    evals = 64 // 8
    want = {"segment_spmm_batched": D * n_mp * (steps + refresh + evals),
            "segment_spmm_batched_bwd": D * n_mp * steps,
            "sed_pool": D * (steps * (decay == 0) + ft + evals),
            "sed_pool_aged": D * steps * (decay > 0)}
    for op, calls in (("lookup", steps + ft), ("update_sampled", steps),
                      ("update_all", refresh)):
        for k, v in ex.codec_launches(op).items():
            want[k] = want.get(k, 0) + D * calls * v
    got = launched(launches)
    if got != launched(want):
        raise AssertionError(f"dist {exchange}/{dtype}: launches {launches}, "
                             f"want {want}")
    per_epoch = steps // len(r.epoch_losses)
    step_bytes = [b / per_epoch for b in r.epoch_exchange_bytes]
    if decay == 0 and any(b != r.step_bytes_model for b in step_bytes):
        raise AssertionError(f"dist {exchange}/{dtype}: {step_bytes} bytes a "
                             f"step, model {r.step_bytes_model}")
    log(f"[dist] {exchange}/{dtype} λ={decay}: {steps} train + {ft} finetune "
        f"steps in {seconds:.3f} s, train metric {r.train_metric:.4f}, "
        f"{r.ms_per_iter:.6f} ms/iter, exch {step_bytes[-1] / 1024:.3f} KiB "
        f"a step a shard (model {r.step_bytes_model / 1024:.3f}), peak device "
        f"memory {peak} B above the {base} B allocated before; launches "
        f"{got}")
    return launches, {"exchange": exchange, "payload_dtype": dtype,
                      "sed_age_weighting": decay, "shards": D,
                      "cap": r.cap, "train_steps": steps,
                      "finetune_steps": ft, "epoch_losses": r.epoch_losses,
                      "train_metric": r.train_metric,
                      "ms_per_iter": r.ms_per_iter,
                      "exch_bytes_per_step_per_shard": step_bytes[-1],
                      "exch_bytes_model": r.step_bytes_model,
                      "peak_bytes": peak, "base_bytes": base,
                      "seconds": seconds, "launches": got,
                      "parity_max_param_diff": worst,
                      "parity_stale_kept": n_stale}


def phase_dist_f32_strategies(torch):
    """The same f32 run through the three strategies, 2 epochs: the
    per-epoch losses (and the train metric) must be identical (the
    reference's bit-exact exchange contract)."""
    from repro_torch.launch.train_dist import run

    out, runs = {}, {}
    for exchange in ("ring", "alltoall", "bucketed"):
        r = run(dist_args(exchange, "f32", 0.0, *PREFETCH_EPOCHS),
                log=lambda *a, **k: None)
        out[exchange] = (r.epoch_losses, r.train_metric)
        runs[exchange] = r
    if not out["ring"] == out["alltoall"] == out["bucketed"]:
        raise AssertionError(f"f32 strategies differ: {out}")
    log(f"[dist] f32, 2 epochs: per-epoch losses {out['ring'][0]} and train "
        f"metric {out['ring'][1]} identical through ring, alltoall and "
        "bucketed")
    return out["ring"][0], runs["ring"]


def bitwise_run(torch, a, b):
    """Two DistResults: per-epoch losses, train metric, shard 0's
    parameters and the final table (emb, age, init) bit for bit."""
    return (a.epoch_losses == b.epoch_losses
            and a.train_metric == b.train_metric
            and all(torch.equal(x, y)
                    for x, y in zip(a.host_params(), b.host_params()))
            and all(torch.equal(x, y)
                    for x, y in zip(a.host_table(), b.host_table())))


def prefetch_launches(ex, r, decay, D):
    """The kernels a prefetched train_dist run launches, all D shards: per
    train step n_mp SpMM forward and backward, one pooling, the lookup of
    the next item and the fused write-back and patch (every item is
    looked up once); refresh, finetune and eval inline."""
    n_mp, evals = 2, 64 // 8
    steps, ft, refresh = r.train_steps, r.finetune_steps, r.refresh_steps
    want = {"segment_spmm_batched": D * n_mp * (steps + refresh + evals),
            "segment_spmm_batched_bwd": D * n_mp * steps,
            "sed_pool": D * (steps * (decay == 0) + ft + evals),
            "sed_pool_aged": D * steps * (decay > 0)}
    for op, calls in (("prefetch_lookup", steps),
                      ("update_sampled_patch", steps), ("lookup", ft),
                      ("update_all", refresh)):
        for k, v in ex.codec_launches(op).items():
            want[k] = want.get(k, 0) + D * calls * v
    return want


def age_plane_bytes(exchange, cap, b_local, j_max, D):
    """Bytes a shard sends a step reading the age plane (lookup_ages, λ >
    0), which the reference's bytes models leave out: bucketed sends its
    (D, cap) int32 id buckets and receives the (D, cap, J) int32 ages back,
    (D-1)/D of each; ring D hops of (ids, ages); alltoall the ids'
    all_gather and the ages' all_to_all."""
    if exchange == "bucketed":
        return (D - 1) * cap * 4 * (1 + j_max)
    if exchange == "ring":
        return D * b_local * 4 * (1 + j_max)
    return (D - 1) * b_local * 4 * (1 + j_max)


def lane_profile(torch, prefetch, n_steps=5):
    """Device busy share of ring / f32 train steps, inline or through the
    prefetch lane: 3 warm-up steps, then ``n_steps`` under torch.profiler
    (sync feeder; the lane's dispatch of each next item is in the window)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import pipeline as DP
    from repro_torch.graphs.experiment import epoch_generator
    from repro_torch.launch.train_dist import run_epoch_prefetch, setup

    s = setup(dist_args("ring", "f32", 0.0, *(["--prefetch-lookups"]
                                              if prefetch else [])))
    gens = [epoch_generator(0, 0) for _ in range(DIST_SHARDS)]
    sched = s.train_scheds[0]

    def steps(states, ids):
        if prefetch:
            feeder = DP.make_feeder("sync", s.ds, ids, s.put_pinned)
            return run_epoch_prefetch(s, states, feeder, gens,
                                      torch.cuda.synchronize, [])[0]
        for item in DP.make_feeder("sync", s.ds, ids, s.put_writing):
            states, batches = s.commit(states, item)
            states, _ = s.step(states, batches, gens)
        return states

    states = steps(s.states, sched[:3])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(states, sched[3:3 + n_steps])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    s.store.close()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    return {"device_events_per_step": len(events) / n_steps,
            "device_busy_ms_per_step": busy_us / n_steps / 1e3,
            "wall_ms_per_step": wall_us / n_steps / 1e3,
            "busy_share": busy_us / wall_us}


def overlap_lane(torch, exchange, prefetch):
    """(h'): one epoch of PREFETCH_OVERLAP_STEPS batches, each a
    permutation of one set of 8 rows, through train_dist's own epoch loop
    (``run_epoch_prefetch`` under --prefetch-lookups, else commit + step)
    at f32 on DIST_SHARDS shards: every row of every batch but the last is
    patched.  Launcher epochs hold disjoint batches and patch nothing.
    Returns (the last loss, shard 0's parameters, the table, the rows
    patched) on the host."""
    import numpy as np

    from repro_torch.core import gst as G
    from repro_torch.dist import pipeline as DP
    from repro_torch.dist.train import host_table
    from repro_torch.graphs.experiment import epoch_generator
    from repro_torch.launch.train_dist import run_epoch_prefetch, setup

    s = setup(dist_args(exchange, "f32", 0.0, "--exchange-cap", "2",
                        "--patch-cap", "2",
                        *(["--prefetch-lookups"] if prefetch else [])))
    try:
        rng = np.random.default_rng(1)
        base = rng.permutation(s.ds.n)[:8]
        sched = [rng.permutation(base).astype(np.int64)
                 for _ in range(PREFETCH_OVERLAP_STEPS)]
        gens = [epoch_generator(0, 0) for _ in range(DIST_SHARDS)]
        rows = 0
        if prefetch:
            feeder = DP.make_feeder("sync", s.ds, sched, s.put_pinned)
            states, loss, _, rows = run_epoch_prefetch(
                s, s.states, feeder, gens, torch.cuda.synchronize, [])
        else:
            states = s.states
            for item in DP.make_feeder("sync", s.ds, sched, s.put_writing):
                states, batches = s.commit(states, item)
                states, m = s.step(states, batches, gens)
                loss = m["loss"]
        return (float(loss),
                [p.detach().cpu() for p in G.train_params(states[0])],
                tuple(host_table(s.ctx, states, s.store)), rows)
    finally:
        s.store.close()


def phase_dist_prefetch(torch, inline_f32):
    """train_dist --prefetch-lookups on 4 shards of the card at the
    distributed run's width (the main path, launches counted from 0):
    (d') ring / f32 bitwise ``inline_f32`` (the inline ring / f32 run of
    phase_dist_f32_strategies: losses, parameters, final table); (e')
    alltoall / bf16 and (f') bucketed / int8 λ 0.05: finite, launches as
    ``codec_launches`` predicts with "update_sampled_patch", bytes a step
    a shard the prefetched model (with the age plane at λ > 0); (g') ring
    / f32 on 2 shards under --table-device-rows 32 with the sync feeder:
    bitwise the uncapped prefetched run, rows evicted.  Then (h'), the
    patch on the card: all-overlap batches through the launcher's lane
    (``overlap_lane``), and the lane's busy share beside the inline
    steps'."""
    from repro_torch.dist.exchange import make_exchange
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dist import run

    D = DIST_SHARDS
    launches, out = {}, {}
    for exchange, dtype, decay in PREFETCH_RUNS:
        torch.cuda.synchronize()
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        r = run(dist_args(exchange, dtype, decay, "--prefetch-lookups",
                          *PREFETCH_EPOCHS), log=lambda *a, **k: None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = ops.kernel_launches()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if not (r.finetuned and all(map(math.isfinite, (
                r.train_metric, r.finetune_loss, r.ms_per_iter,
                *r.epoch_losses)))):
            raise AssertionError(f"prefetch {exchange}/{dtype}: bad result "
                                 f"{r}")
        ex = make_exchange(exchange, num_shards=D, rows=1, cap=r.cap,
                           payload_dtype=dtype, patch_cap=r.patch_cap)
        want = prefetch_launches(ex, r, decay, D)
        if launched(got) != launched(want):
            raise AssertionError(f"prefetch {exchange}/{dtype}: launches "
                                 f"{launched(got)}, want {launched(want)}")
        b_local = 8 // D
        j_max = r.states[0].table.emb.shape[1]
        ages = age_plane_bytes(exchange, r.cap, b_local, j_max, D) \
            if decay > 0 else 0
        per_epoch = r.train_steps // len(r.epoch_losses)
        step_bytes = [b / per_epoch for b in r.epoch_exchange_bytes]
        if any(b != r.step_bytes_model + ages for b in step_bytes):
            raise AssertionError(f"prefetch {exchange}/{dtype}: {step_bytes} "
                                 f"bytes a step, model {r.step_bytes_model}"
                                 f" + age plane {ages}")
        patch = ex.patch_bytes(b_local, 1, 64)
        if (patch > 0) != (exchange == "bucketed"):
            raise AssertionError(f"{exchange}: patch bytes {patch}")
        if exchange == "ring":
            if not bitwise_run(torch, r, inline_f32):
                raise AssertionError(
                    f"(d') prefetched ring / f32 {r.epoch_losses} is not "
                    f"bitwise the inline run {inline_f32.epoch_losses}")
        label = {"ring": "(d')", "alltoall": "(e')",
                 "bucketed": "(f')"}[exchange]
        log(f"[dist_prefetch] {label} {exchange}/{dtype} λ={decay}: "
            + ("per-epoch losses, parameters and final table bitwise the "
               "inline ring / f32 run; " if exchange == "ring" else "")
            + f"{r.train_steps} train steps in {seconds:.3f} s, "
            f"{r.ms_per_iter:.6f} ms/iter, exch {step_bytes[-1]:.1f} B a "
            f"step a shard = prefetched model {r.step_bytes_model}"
            + (f" + age plane {ages}" if ages else "")
            + f" (patch bytes {patch}"
            + (f", planned patch_cap {r.patch_cap}, cap {r.cap}"
               if exchange == "bucketed" else "")
            + f"), patched rows {r.patched_rows}; launches {launched(got)}")
        out[label] = {"exchange": exchange, "payload_dtype": dtype,
                      "sed_age_weighting": decay,
                      "ms_per_iter": r.ms_per_iter, "seconds": seconds,
                      "epoch_losses": r.epoch_losses,
                      "exch_bytes_per_step_per_shard": step_bytes[-1],
                      "exch_bytes_model": r.step_bytes_model,
                      "age_plane_bytes": ages, "patch_bytes": patch,
                      "patch_cap": r.patch_cap, "cap": r.cap,
                      "patched_rows": r.patched_rows,
                      "launches": launched(got)}
    # (g') at 2 shards: the lane's window (2 batches a shard) is 32 of the
    # 64 rows, so rows are evicted while others stay pinned
    g_args = ("ring", "f32", 0.0, "--prefetch-lookups", *PREFETCH_EPOCHS,
              "--feeder", "sync")
    uncapped = run(dist_args(*g_args, shards=PREFETCH_CAPPED_SHARDS),
                   log=lambda *a, **k: None)
    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    r = run(dist_args(*g_args, "--table-device-rows",
                      str(PREFETCH_DEVICE_ROWS),
                      shards=PREFETCH_CAPPED_SHARDS),
            log=lambda *a, **k: None)
    torch.cuda.synchronize()
    for k, v in ops.kernel_launches().items():
        launches[k] = launches.get(k, 0) + v
    st = r.store_stats
    if st["backend"] != "TieredStore" or st["evictions"] <= 0 \
            or st["device_rows"] >= st["n_rows"] \
            or not bitwise_run(torch, r, uncapped):
        raise AssertionError(f"(g') capped prefetched ring / f32 "
                             f"{r.epoch_losses} {st} is not bitwise the "
                             f"uncapped {uncapped.epoch_losses}, or evicted "
                             "nothing")
    log(f"[dist_prefetch] (g') ring / f32, {PREFETCH_CAPPED_SHARDS} shards, "
        f"sync feeder, --table-device-rows {PREFETCH_DEVICE_ROWS} (the "
        f"lane's window of 2 batches a shard: {st['device_rows']} of "
        f"{st['n_rows']} rows on the card): losses, parameters, final table "
        f"bitwise the uncapped prefetched run, {st['evictions']} evictions "
        f"under the pins, no pin exhaustion; {r.ms_per_iter:.6f} ms/iter "
        f"(uncapped {uncapped.ms_per_iter:.6f}); {store_line(st)}")
    out["(g')"] = {"shards": PREFETCH_CAPPED_SHARDS,
                   "ms_per_iter": r.ms_per_iter,
                   "uncapped_ms_per_iter": uncapped.ms_per_iter, "store": st}
    del uncapped, r
    out["(h')"] = {}
    for exchange in ("ring", "alltoall", "bucketed"):
        (la, pa, ta, rows_a), (lb, pb, tb, rows_b) = (
            overlap_lane(torch, exchange, p) for p in (False, True))
        want_rows = (PREFETCH_OVERLAP_STEPS - 1) * 8
        if not (rows_a == 0 and rows_b == want_rows and la == lb
                and tables_equal(torch, pa, pb)
                and tables_equal(torch, ta, tb)):
            raise AssertionError(
                f"(h') {exchange} / f32 all-overlap: prefetched loss {lb}, "
                f"{rows_b} rows patched (want {want_rows}) against inline "
                f"{la}, or the parameters or table differ")
        log(f"[dist_prefetch] (h') {exchange} / f32, {DIST_SHARDS} shards, "
            f"{PREFETCH_OVERLAP_STEPS} all-overlap batches through the "
            f"launcher's lane: {rows_b} rows patched, loss {lb}, parameters "
            "and table bitwise the inline loop's")
        out["(h')"][exchange] = {"patched_rows": rows_b, "loss": lb}
    prof = {"inline": lane_profile(torch, False),
            "prefetch": lane_profile(torch, True)}
    log("[dist_prefetch] ring / f32 steps, 4 shards, 5 after 3 warm-up, "
        "under torch.profiler: " + "; ".join(
            f"{k}: {v['wall_ms_per_step']:.3f} ms wall, device busy "
            f"{v['device_busy_ms_per_step']:.4f} ms "
            f"({v['device_events_per_step']:.0f} events), busy share "
            f"{v['busy_share']:.4f}" for k, v in prof.items())
        + f"; inline ring / f32 run {inline_f32.ms_per_iter:.6f} ms/iter")
    out["profile"] = prof
    out["inline_f32_ms_per_iter"] = inline_f32.ms_per_iter
    return launches, out


# ---------------------------------------------------------------------------
# the tiered embedding store
# ---------------------------------------------------------------------------


def store_line(st):
    return (f"hit rate {st['hit_rate']:.4f} ({st['hits']} hits, "
            f"{st['misses']} faults of {st['lookups']} lookups), "
            f"{st['evictions']} evictions, bytes_h2d {st['bytes_h2d']}, "
            f"bytes_d2h {st['bytes_d2h']}, writeback_wait_ms "
            f"{st['writeback_wait_ms']}")


def tables_equal(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_store_training(torch):
    """(a) training run (a) with about 10% of its training graphs on the
    device: per-epoch losses, final metrics and snapshot bitwise the
    uncapped run's; (b) the same with stale-first eviction and the delta
    gate, then with the forecaster: finite, the gate skipped write-backs,
    the forecaster observed and forecast rows.  Returns (a)'s kernel
    launches, counted from 0 just before it, and the summaries."""
    from repro_torch.graphs.experiment import run_experiment
    from repro_torch.kernels import ops

    dataset, backbone, decay = TRAIN_RUNS[0]
    kw = dict(dataset=dataset, backbone=backbone, variant="gst_efd",
              epochs=TRAIN_EPOCHS, finetune_epochs=FINETUNE_EPOCHS,
              sed_age_weighting=decay, device="cuda")
    full = run_experiment(**kw)
    n_train, batch = full.table.emb.shape[0], 8
    rows = max(math.ceil(STORE_DEVICE_FRAC * n_train), batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    r = run_experiment(table_device_rows=rows, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated() - base
    st = r.store_stats
    if not (r.epoch_losses == full.epoch_losses
            and (r.train_metric, r.test_metric) == (full.train_metric,
                                                    full.test_metric)
            and tables_equal(torch, r.table, full.table)):
        raise AssertionError(f"store (a): capped run {r.epoch_losses} "
                             f"{r.train_metric} {r.test_metric} != uncapped "
                             f"{full.epoch_losses} {full.train_metric} "
                             f"{full.test_metric} (or the tables differ)")
    if st["backend"] != "TieredStore" or st["evictions"] <= 0:
        raise AssertionError(f"store (a): the cap did not spill: {st}")
    log(f"[store] (a) {dataset}/{backbone} gst_efd, {rows} of {n_train} "
        f"rows on the device: per-epoch losses, metrics and snapshot "
        f"bitwise the uncapped run; {r.ms_per_iter:.6f} ms/iter (uncapped "
        f"{full.ms_per_iter:.6f}), peak device memory {peak} B above the "
        f"{base} B allocated before, {seconds:.3f} s; {store_line(st)}; "
        f"launches {launched(launches)}")
    out = {"a": {"device_rows": rows, "n_rows": n_train,
                 "ms_per_iter": r.ms_per_iter,
                 "uncapped_ms_per_iter": full.ms_per_iter,
                 "peak_bytes": peak, "base_bytes": base, "seconds": seconds,
                 "epoch_losses": r.epoch_losses,
                 "train_metric": r.train_metric,
                 "test_metric": r.test_metric, "store": st,
                 "launches": launched(launches)}}
    for label, extra in (("wb_threshold 0.05", dict(wb_threshold=0.05)),
                         ("stale_forecast", dict(stale_forecast=True))):
        b = run_experiment(table_device_rows=rows, evict_policy="stale-first",
                           **extra, **kw)
        bs = b.store_stats
        moved = (bs["wb_skipped_rows"] > 0 if "wb_threshold" in extra
                 else bs["forecast"]["observed_rows"] > 0
                 and bs["forecast"]["forecast_rows"] > 0)
        if not (moved and all(map(math.isfinite, (
                b.train_metric, b.test_metric, *b.epoch_losses)))):
            raise AssertionError(f"store (b) {label}: {b} {bs}")
        log(f"[store] (b) stale-first, {label}: train {b.train_metric:.4f} "
            f"test {b.test_metric:.4f} (uncapped {full.train_metric:.4f} / "
            f"{full.test_metric:.4f}), {b.ms_per_iter:.6f} ms/iter; "
            f"{store_line(bs)}; wb_skipped_rows {bs['wb_skipped_rows']}, "
            f"forecast {bs.get('forecast')}")
        out[f"b {label}"] = {"train_metric": b.train_metric,
                             "test_metric": b.test_metric,
                             "ms_per_iter": b.ms_per_iter, "store": bs}
    return launches, out


def phase_store_serving(torch):
    """(c) the sage serving replay with cache_capacity // 8 rows of the
    cache on the device: every prediction bitwise the uncapped engine's.
    Returns its kernel launches (counted from 0 before the replay) and a
    summary."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.traffic import TrafficConfig, make_request_stream

    stream = make_request_stream(TrafficConfig())
    rows = ServeConfig().cache_capacity // STORE_CACHE_DIVISOR
    out, launches = {}, None
    for label, cap in (("uncapped", None), ("capped", rows)):
        engine = ServeEngine(ServeConfig(backbone="sage", device="cuda",
                                         table_device_rows=cap), seed=0)
        engine.process(stream[:4], window=8)          # warm-up, not counted
        engine.reset_stats()
        ops.reset_kernel_launches()
        results = engine.process(stream, window=8)
        torch.cuda.synchronize()
        if cap is not None:
            launches = ops.kernel_launches()
        out[label] = (results, engine.stats.summary())
        engine.close()
    for a, b in zip(out["uncapped"][0], out["capped"][0]):
        if not (a.pred.tobytes() == b.pred.tobytes()):
            raise AssertionError(f"store (c): request {a.request_id}: "
                                 f"{a.pred} != {b.pred}")
    (_, full), (_, s) = out["uncapped"], out["capped"]
    st = s["cache"]["store"]
    if st["backend"] != "TieredStore":
        raise AssertionError(f"store (c): {st}")
    log(f"[store] (c) sage replay, {rows} of {s['cache']['capacity']} cache "
        f"rows on the device: {len(out['capped'][0])} predictions bitwise "
        f"the uncapped engine; p50 {s['latency_p50_ms']:.6f} ms, p99 "
        f"{s['latency_p99_ms']:.6f} ms (uncapped {full['latency_p50_ms']:.6f}"
        f" / {full['latency_p99_ms']:.6f}); cache hit rate "
        f"{s['cache']['hit_rate']:.4f}; store {store_line(st)}")
    return launches, {"device_rows": rows,
                      "latency_p50_ms": s["latency_p50_ms"],
                      "latency_p99_ms": s["latency_p99_ms"],
                      "uncapped_latency_p50_ms": full["latency_p50_ms"],
                      "uncapped_latency_p99_ms": full["latency_p99_ms"],
                      "cache_hit_rate": s["cache"]["hit_rate"], "store": st}


def phase_store_dist(torch, uncapped):
    """(d) train_dist ring / int8 with --table-device-rows 16 on 4 shard
    threads: per-epoch losses bitwise the uncapped ring / int8 run's
    (``uncapped``, phase_dist's summary), the exchange bytes a step the
    model's.  Returns its kernel launches (from 0) and a summary."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train_dist import run

    torch.cuda.synchronize()
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    r = run(dist_args("ring", "int8", 0.0, "--table-device-rows",
                      str(STORE_DIST_ROWS)), log=lambda *a, **k: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.kernel_launches()
    st = r.store_stats
    per_epoch = r.train_steps // len(r.epoch_losses)
    step_bytes = [b / per_epoch for b in r.epoch_exchange_bytes]
    if r.epoch_losses != uncapped["epoch_losses"] \
            or r.train_metric != uncapped["train_metric"]:
        raise AssertionError(f"store (d): capped {r.epoch_losses} "
                             f"{r.train_metric} != uncapped "
                             f"{uncapped['epoch_losses']} "
                             f"{uncapped['train_metric']}")
    if any(b != r.step_bytes_model for b in step_bytes):
        raise AssertionError(f"store (d): {step_bytes} bytes a step, model "
                             f"{r.step_bytes_model}")
    if st["backend"] != "TieredStore" or st["evictions"] <= 0:
        raise AssertionError(f"store (d): the cap did not spill: {st}")
    log(f"[store] (d) ring / int8, {DIST_SHARDS} shards, "
        f"--table-device-rows {STORE_DIST_ROWS} ({st['device_rows']} of "
        f"{st['n_rows']} rows on the device): per-epoch losses and train "
        f"metric bitwise the uncapped run, exch {step_bytes[-1]:.1f} B a "
        f"step a shard = the model; {r.ms_per_iter:.6f} ms/iter (uncapped "
        f"{uncapped['ms_per_iter']:.6f}), {seconds:.3f} s; {store_line(st)};"
        f" launches {launched(launches)}")
    return launches, {"ms_per_iter": r.ms_per_iter,
                      "uncapped_ms_per_iter": uncapped["ms_per_iter"],
                      "epoch_losses": r.epoch_losses,
                      "exch_bytes_per_step_per_shard": step_bytes[-1],
                      "seconds": seconds, "store": st,
                      "launches": launched(launches)}


def telemetry_obs(tag, annotations=False):
    """A live telemetry bundle (repro_torch.obs.Obs, installed) writing
    ``tag``.jsonl and ``tag``_trace.json under TELEMETRY_DIR."""
    from repro_torch.obs import Obs

    TELEMETRY_DIR.mkdir(parents=True, exist_ok=True)
    return Obs(metrics_out=str(TELEMETRY_DIR / f"{tag}.jsonl"),
               trace_out=str(TELEMETRY_DIR / f"{tag}_trace.json"),
               annotations=annotations)


def telemetry_argv(tag):
    return ["--metrics-out", str(TELEMETRY_DIR / f"{tag}.jsonl"),
            "--trace-out", str(TELEMETRY_DIR / f"{tag}_trace.json")]


def telemetry_gate(tag, *argv, stream="--train-jsonl"):
    """repro_torch.obs.gate over ``tag``'s stream and trace; fails the run
    unless it exits 0.  Returns the stream's summary record."""
    from repro_torch.obs import gate

    path = TELEMETRY_DIR / f"{tag}.jsonl"
    rc = gate.main([stream, str(path), *argv, "--trace",
                    str(TELEMETRY_DIR / f"{tag}_trace.json")])
    if rc != 0:
        raise AssertionError(f"[telemetry] {tag}: the gate exited {rc}")
    return json.loads(path.read_text().splitlines()[-1])


TELEMETRY_TURNS = (False, True, True, False)   # telemetry off, on, on, off


def phase_telemetry(torch, dev):
    """The telemetry spine (repro_torch.obs) on the graph paths, kernels on.
    Each path runs four times in turns, telemetry off, on, on, off (the
    first run of a path in a call is slower than the rest, so the order
    would bias one side): every run's results bitwise the first's and its
    launches equal; the telemetry runs write a JSONL stream and a Chrome
    trace, and repro_torch.obs.gate must exit 0 on the last.

    (1) run_experiment (a): per-epoch losses, metrics and final table;
    the gate also bounds the row-age p99 by the SED bound of its geometry.
    (2) serve_graphs' replay (sage): predictions' summary and launches;
    the gate with a p99 budget of 3x the slowest run without telemetry
    and an encode-launch budget from the replay's geometry.  (3)
    train_dist ring / int8 on 4 shards, inline and --prefetch-lookups:
    losses, parameters and table; the gate with --expect-dist (and
    --expect-prefetch); exchange.bytes.ring.int8 = the bytes shard 0's
    comm counted over the train epochs.  (4) one epoch of (a) under
    torch.profiler with --torch-trace-annotations: a train.step range a
    step.  ms_per_iter (p50 / p99 of the replay) of each turn.  Returns
    the telemetry runs' launches (each counted from 0) and a summary."""
    from repro_torch.graphs.experiment import load_datasets, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_graphs, train_dist
    from repro_torch.serve.engine import ServeConfig

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    main_launches, out = {}, {}

    def in_turns(label, run, same):
        """``run(on)`` in TELEMETRY_TURNS, launches counted from 0 each;
        every run ``same`` as the first and with its launches.  Returns
        [(on, result)]."""
        turns = []
        for on in TELEMETRY_TURNS:
            sync()
            ops.reset_kernel_launches()
            r = run(on)
            sync()
            turns.append((on, r, launched(ops.kernel_launches())))
        first, first_l = turns[0][1], turns[0][2]
        for on, r, launches in turns[1:]:
            if not (same(r, first) and launches == first_l):
                raise AssertionError(f"[telemetry] {label}: a run with "
                                     f"telemetry {'on' if on else 'off'} "
                                     f"differs from the first ({launches} "
                                     f"vs {first_l} launches)")
            if on:
                for k, v in launches.items():
                    main_launches[k] = main_launches.get(k, 0) + v
        return [(on, r) for on, r, _ in turns]

    def turns_line(values):
        return ", ".join(f"{'on' if on else 'off'} {v:.6f}"
                         for on, v in values)

    # (1) graph training (a)
    train_kw = dict(dataset="malnet", backbone="sage", variant="gst_efd",
                    epochs=TRAIN_EPOCHS, finetune_epochs=FINETUNE_EPOCHS,
                    device=dev.type)

    def train_run(on):
        obs = telemetry_obs("train") if on else None
        try:
            return run_experiment(obs=obs, **train_kw)
        finally:
            if obs is not None:
                obs.close()

    runs = in_turns("training (a)", train_run, lambda a, b: (
        a.epoch_losses == b.epoch_losses
        and (a.train_metric, a.test_metric) == (b.train_metric,
                                                b.test_metric)
        and all(torch.equal(x, y) for x, y in zip(a.table, b.table))))
    _, ds, _ = load_datasets("malnet", 80, 64)
    summary = telemetry_gate(
        "train", "--j-max", str(ds.j_max), "--num-sampled", "1",
        "--steps-per-epoch", str(runs[0][1].train_steps // TRAIN_EPOCHS))
    row_age = summary["metrics"]["staleness.row_age"]
    ms = [(on, r.ms_per_iter) for on, r in runs]
    log(f"[telemetry] training (a): losses, metrics, final table bitwise "
        f"and launches equal in every turn; gate passed (row-age p99 "
        f"{row_age['p99']:.3f} steps, j_max {ds.j_max}); ms_per_iter "
        f"{turns_line(ms)}")
    out["training"] = {"ms_per_iter_turns": ms,
                       "row_age_p99": row_age["p99"], "j_max": ds.j_max}

    # (2) serving replay (sage)
    def serve_run(on):
        return serve_graphs.main(["--device", dev.type] + (
            telemetry_argv("serve") if on else []))

    keys = ("n_requests", "n_segments", "encode_launches",
            "encoded_segments", "kernel_launches", "cache")
    runs = in_turns("serving (sage)", serve_run, lambda a, b: all(
        a[k] == b[k] for k in keys))
    s_on = runs[-2][1]
    ladder = ServeConfig().resolved_ladder()
    windows = math.ceil(s_on["n_requests"] / 8)
    max_launches = windows * len(ladder) + math.ceil(
        s_on["n_segments"] / min(spec.batch for spec in ladder))
    budget = 3 * max(r["latency_p99_ms"] for on, r in runs if not on)
    telemetry_gate("serve", "--serve-p99-ms", str(budget),
                   "--max-encode-launches", str(max_launches),
                   stream="--serve-jsonl")
    lat = [(on, r["latency_p50_ms"], r["latency_p99_ms"]) for on, r in runs]
    log(f"[telemetry] serving (sage): summaries and launches equal in every "
        f"turn; gate passed (p99 budget {budget:.3f} ms = 3x the slowest "
        f"run without telemetry, encode launches "
        f"{s_on['encode_launches']} <= {max_launches} = {windows} windows x "
        f"{len(ladder)} buckets + {s_on['n_segments']} segments / the "
        f"smallest bucket batch); p50 / p99 ms " + ", ".join(
            f"{'on' if on else 'off'} {p50:.6f} / {p99:.6f}"
            for on, p50, p99 in lat))
    out["serving"] = {"p50_p99_turns": lat, "p99_budget_ms": budget}

    # (3) distributed training, 4 shards, ring / int8
    base = [dev.type if a == "cuda" else a for a in DIST_ARGS]
    dist_base = base[:base.index("--epochs")] + PREFETCH_EPOCHS + [
        "--exchange", "ring", "--payload-dtype", "int8"]
    out["dist"] = {}
    for lane in ("inline", "prefetch"):
        flags = dist_base + (["--prefetch-lookups"] if lane == "prefetch"
                             else [])

        def dist_run(on):
            args = train_dist.build_parser().parse_args(
                flags + (telemetry_argv("dist_" + lane) if on else []))
            return train_dist.run(args, log=lambda *a, **k: None)

        runs = in_turns(f"dist {lane}", dist_run,
                        lambda a, b: bitwise_run(torch, a, b))
        summary = telemetry_gate("dist_" + lane, "--expect-dist", *(
            ["--expect-prefetch"] if lane == "prefetch" else []))
        total = summary["metrics"]["exchange.bytes.ring.int8"]
        counted = sum(runs[-2][1].epoch_exchange_bytes)
        if total != counted:
            raise AssertionError(f"[telemetry] dist {lane}: registry "
                                 f"{total} exchange bytes, comm {counted}")
        ms = [(on, r.ms_per_iter) for on, r in runs]
        log(f"[telemetry] dist ring / int8 {lane}, {DIST_SHARDS} shards: "
            f"losses, parameters, table bitwise and launches equal in every "
            f"turn; gate passed; exchange.bytes.ring.int8 {total:.0f} = "
            f"shard 0's counted bytes; ms_per_iter {turns_line(ms)}")
        out["dist"][lane] = {"ms_per_iter_turns": ms,
                             "exchange_bytes": total}

    # (4) span names as ranges in a torch.profiler trace
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    obs = telemetry_obs("profiled", annotations=True)
    try:
        with profile(activities=activities) as prof:
            r = run_experiment(obs=obs, **dict(train_kw, epochs=1,
                                               finetune_epochs=1))
            sync()
    finally:
        obs.close()
    host = torch.autograd.DeviceType.CPU
    ranges = sum(1 for e in prof.events()
                 if e.name == "train.step" and e.device_type == host)
    on_card = sum(1 for e in prof.events()
                  if e.name == "train.step" and e.device_type != host)
    if ranges != r.train_steps:
        raise AssertionError(f"[telemetry] {ranges} train.step ranges in "
                             f"the profile for {r.train_steps} steps")
    log(f"[telemetry] profiled epoch with --torch-trace-annotations: "
        f"{ranges} train.step ranges for {r.train_steps} steps ({on_card} "
        "more on the device's timeline)")
    out["annotated_train_step_ranges"] = ranges
    return main_launches, out


def phase_store_migration(torch, dev):
    """(e) migrations at a table size users hold: MIGRATION_TABLE in a
    TieredStore with 10% of the rows on the card (host tier pinned).
    For batches of 8, 64 and 1,024 rows, none resident, each evicting as
    many: begin + commit to a synchronised card, and the write-back's
    landing in the host tier after it, as GB/s of the rows' (emb, age,
    init) bytes; then MIGRATION_STEPS random batches with in-place writes
    through it and through a DeviceStore: the snapshots bitwise equal."""
    import numpy as np

    from repro_torch.core import embedding_table as tbl
    from repro_torch.store import DeviceStore, TieredStore

    n, J, d = MIGRATION_TABLE
    C = n // 10
    t0 = time.perf_counter()
    store = TieredStore(n, J, d, device_rows=C, device=dev)
    made_s = time.perf_counter() - t0
    table = store.init_device_table()
    host_gb = store.host_tier_bytes() / 1e9
    table, _ = store.prepare(table, np.arange(C))       # fill the device tier
    store.flush_writebacks()
    torch.cuda.synchronize()
    nxt, timings = C, {}
    for b in MIGRATION_BATCHES:
        begin, begin_commit, landing = [], [], []
        for _ in range(MIGRATION_REPEATS):
            ids = np.arange(nxt, nxt + b) % n
            nxt += b
            t0 = time.perf_counter()
            prep = store.begin(ids)
            torch.cuda.synchronize()
            tb = time.perf_counter()
            table = store.commit(table, prep)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            store.flush_writebacks()
            t2 = time.perf_counter()
            if prep.n_up != b or prep.n_ev != b:
                raise AssertionError(f"store (e): {prep.n_up} faults, "
                                     f"{prep.n_ev} evictions for {b} rows")
            begin.append((tb - t0) * 1e3)
            begin_commit.append((t1 - t0) * 1e3)
            landing.append((t2 - t0) * 1e3)
        mb, ml = statistics.median(begin_commit), statistics.median(landing)
        moved = b * store.row_bytes
        timings[b] = {"begin_ms": statistics.median(begin),
                      "begin_commit_ms": mb, "landed_ms": ml,
                      "h2d_gb_s": moved / mb / 1e6,
                      "d2h_gb_s": moved / ml / 1e6,
                      "bytes_each_way": moved}
        log(f"[store] (e) {b} misses + {b} evictions ({moved} B each way): "
            f"begin {timings[b]['begin_ms']:.6f} ms (its copies synced), "
            f"begin + commit {mb:.6f} ms ({timings[b]['h2d_gb_s']:.4f} GB/s "
            f"host -> device), write-back landed {ml:.6f} ms after begin "
            f"({timings[b]['d2h_gb_s']:.4f} GB/s device -> host); median of "
            f"{MIGRATION_REPEATS}")
    store.close()

    # the bitwise check: the same random batches and in-place writes
    # through a fresh TieredStore and a DeviceStore
    rng = np.random.default_rng(0)
    tiered = TieredStore(n, J, d, device_rows=C, device=dev)
    dense = DeviceStore(n, J, d, device=dev)
    t_tier, t_dense = tiered.init_device_table(), dense.init_device_table()
    hot = rng.choice(n, 4096, replace=False)
    t0 = time.perf_counter()
    for t in range(MIGRATION_STEPS):
        ids = np.unique(np.concatenate([rng.choice(hot, 256),
                                        rng.integers(0, n, 768)]))
        seg = torch.from_numpy(rng.integers(0, J, (len(ids), 1))).to(dev)
        vals = torch.randn(len(ids), 1, d, device=dev)
        for st, tb in ((tiered, t_tier), (dense, t_dense)):
            tb, slots = st.prepare(tb, ids, step=t)
            tbl.update_sampled(tb, torch.from_numpy(
                slots.astype(np.int64)).to(dev), seg, vals, t)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    if not tables_equal(torch, tiered.snapshot(t_tier),
                        dense.snapshot(t_dense)):
        raise AssertionError("store (e): the tiered snapshot differs from "
                             "the DeviceStore's")
    st = tiered.stats()
    tiered.close()
    log(f"[store] (e) {n} x {J} x {d} f32, host tier {host_gb:.4f} GB "
        f"pinned (made in {made_s:.3f} s), {C} rows ({C * store.row_bytes} "
        f"B) on the card: after {MIGRATION_STEPS} random batches "
        f"({drive_s:.3f} s) the snapshot is bitwise the DeviceStore's; "
        f"{store_line(st)}")
    return {"table": MIGRATION_TABLE, "device_rows": C,
            "host_tier_gb": host_gb, "host_tier_made_s": made_s,
            "batches": timings, "random_steps": MIGRATION_STEPS,
            "random_steps_s": drive_s, "store": st}


def phase_dist_profile(torch, n_steps=5):
    """Where a distributed step's time goes (ring / int8, 4 shards):
    torch.profiler over ``n_steps`` kernel-path steps after 3 warm-up
    steps; device events a step, their summed device time, the
    hand-written kernels' share, and the wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist.pipeline import _assemble
    from repro_torch.graphs.experiment import epoch_generator
    from repro_torch.launch.train_dist import setup

    s = setup(dist_args("ring", "int8", 0.0))
    gens = [epoch_generator(0, 0) for _ in range(DIST_SHARDS)]
    # the device-resident store: routing is the identity, commit a no-op
    batches = [s.put(_assemble(s.ds, ids))[1]
               for ids in s.train_scheds[0][:3 + n_steps]]
    states = s.states
    for b in batches[:3]:
        states, _ = s.step(states, b, gens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            states, _ = s.step(states, b, gens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    ours = [e for e in dev_events if "segment_spmm_fwd_kernel" in e.name
            or "sed_pool_kernel" in e.name or "pack_" in e.name
            or "unpack_" in e.name]
    ours_us = sum(e.time_range.elapsed_us() for e in ours)
    out = {"steps": n_steps, "shards": DIST_SHARDS,
           "device_events_per_step": len(dev_events) / n_steps,
           "device_busy_ms_per_step": busy_us / n_steps / 1e3,
           "wall_ms_per_step": wall_us / n_steps / 1e3,
           "busy_share": busy_us / wall_us,
           "handwritten_launches_per_step": len(ours) / n_steps,
           "handwritten_ms_per_step": ours_us / n_steps / 1e3}
    log(f"[profile] {n_steps} distributed steps (ring / int8, "
        f"{DIST_SHARDS} shards): {out['device_events_per_step']:.1f} device "
        f"events a step, device busy {out['device_busy_ms_per_step']:.6f} ms "
        f"of {out['wall_ms_per_step']:.6f} ms wall (busy share "
        f"{out['busy_share']:.4f}), hand-written kernels "
        f"{out['handwritten_launches_per_step']:.1f} launches "
        f"{out['handwritten_ms_per_step']:.6f} ms a step")
    return out


def phase_dist_scaling(torch, n_steps=5):
    """Wall ms of one distributed step (ring / int8; f32 at one shard, where
    the codec is pinned) at 1, 2 and 4 shards as threads, no profiler, and
    at 4 shards again with the interpreter's thread switch interval cut
    from its default to 0.1 ms: how the shards' host dispatch shares the
    interpreter lock."""
    from repro_torch.dist.pipeline import _assemble
    from repro_torch.graphs.experiment import epoch_generator
    from repro_torch.launch.train_dist import setup

    out = {}
    default = sys.getswitchinterval()
    for shards, interval in ((1, default), (2, default), (4, default),
                             (4, 1e-4)):
        s = setup(dist_args("ring", "int8", 0.0, shards=shards))
        gens = [epoch_generator(0, 0) for _ in range(shards)]
        batches = [s.put(_assemble(s.ds, ids))[1]    # identity routing
                   for ids in s.train_scheds[0][:3 + n_steps]]
        states = s.states
        sys.setswitchinterval(interval)
        try:
            times = []
            for b in batches:
                t0 = time.perf_counter()
                states, _ = s.step(states, b, gens)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            sys.setswitchinterval(default)
        key = f"{shards} shards, switch interval {interval * 1e3:g} ms"
        out[key] = statistics.median(times[3:])
    log("[profile] ms a distributed step (median of "
        f"{n_steps} after 3 warm-up): " + ", ".join(
            f"{k}: {v:.6f}" for k, v in out.items()))
    return out


def time_long_ms(torch, fn, iters: int = 3) -> float:
    """Median device time of one call for calls of tens of ms and more,
    from CUDA events around each call after one warm-up call (the host is
    far ahead of such calls without a sleep kernel)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def swa_pairs(S, W):
    """Visible (query, key) pairs of causal attention in a window W."""
    W = min(W, S)
    return W * (W + 1) // 2 + (S - W) * W


def swa_sdpa(torch, q, k, v, W, repeat_kv=False):
    """The yardstick (the port never calls it): one
    ``scaled_dot_product_attention`` call over the (B, H, S, D) views, with
    ``is_causal`` or the band mask, GQA by ``enable_gqa``; or, where
    ``repeat_kv``, over K/V repeated to H heads beforehand (untimed), which
    lets PyTorch take its memory-efficient kernel in f32."""
    import torch.nn.functional as F

    S, H = q.shape[1], q.shape[2]
    if repeat_kv:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = {"enable_gqa": not repeat_kv}
    if W >= S:
        kw["is_causal"] = True
    else:
        i = torch.arange(S, device=q.device)
        kw["attn_mask"] = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def swa_bound(n_bytes, flops):
    """swa_attention's least time: its bytes, or its flops at f32 accuracy
    on the tensor cores (3xTF32: three TF32 products a product), whichever
    is longer; beside it the f32 FMA bound of ``bound``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * flops / TF32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_tc),
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "tc_bound_ms": t_tc,
            "fma_bound_ms": bound(n_bytes, flops)["bound_ms"],
            "bytes": n_bytes, "flops": flops}


def phase_kernel_swa(torch, dev):
    """swa_attention against the plain version (ref.swa_attention_ref, the
    (B, H, S, S) oracle; at 32k the plain chunked_causal_attention), two
    launches bitwise equal, timed beside scaled_dot_product_attention."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.models.common import chunked_causal_attention

    rows = []
    for shape in SWA_SHAPES + [SWA_LONG]:
        B, S, H, KV, D, W = shape
        W = S if W is None else W
        g = torch.Generator(dev).manual_seed(S + W)
        q = torch.randn(B, S, H, D, device=dev, generator=g)
        k = torch.randn(B, S, KV, D, device=dev, generator=g)
        v = torch.randn(B, S, KV, D, device=dev, generator=g)
        long = shape == SWA_LONG
        if long:
            plain_fn = lambda: chunked_causal_attention(  # noqa: E731
                q, k, v, window=0 if W >= S else W, chunk=1024)
        else:
            plain_fn = lambda: ref.swa_attention_ref(q, k, v, W)  # noqa: E731
        a = swa.swa_attention(q, k, v, window=W)
        b = swa.swa_attention(q, k, v, window=W)
        plain = plain_fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{shape}: two launches differ bitwise")
        torch.testing.assert_close(a, plain, rtol=TOL, atol=TOL)
        err = float((a - plain).abs().max())
        del plain
        # the math path of enable_gqa needs the (B, H, S, S) logits: 64 GiB
        # at 32k, so there the yardstick runs on repeated K/V alone
        repeated = swa_sdpa(torch, q, k, v, W, repeat_kv=True)
        fns = [lambda: swa.swa_attention(q, k, v, window=W), plain_fn,
               repeated]
        if not long:
            fns.append(swa_sdpa(torch, q, k, v, W))
        for fn in fns[2:]:
            torch.testing.assert_close(fn().transpose(1, 2), a, rtol=TOL,
                                       atol=TOL)
        times = [time_long_ms(torch, fn) if long else time_ms(torch, fn, 50)
                 for fn in fns]
        ms, plain_ms, repeated_ms = times[:3]
        library_ms = times[-1]
        P = swa_pairs(S, W)
        row = {"shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "W": W,
                         "dtype": "float32"},
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "plain": "chunked_causal_attention" if long
               else "swa_attention_ref",
               "library_ms": library_ms,
               "library": "sdpa, K/V repeated" if long
               else "sdpa(enable_gqa=True)",
               "sdpa_repeated_kv_ms": repeated_ms, "pairs": P,
               **swa_bound(4 * (2 * B * S * H * D + 2 * B * S * KV * D),
                           4 * B * H * D * P)}
        rows.append(row)
        log(f"[kernel] swa_attention B={B} S={S} H={H} KV={KV} D={D} W={W}: "
            f"max|kernel-plain| {err:.3e}, bitwise equal twice; kernel "
            f"{ms:.6f} ms ({row['flops'] / ms / 1e9:.3f} TFLOP/s), plain "
            f"{plain_ms:.6f} ms ({row['plain']}), {row['library']} "
            f"{library_ms:.6f} ms, sdpa on repeated K/V {repeated_ms:.6f} ms "
            f"(kernel / that {ms / repeated_ms:.3f}); bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']}, {row['bytes']} B, "
            f"{row['flops']} flop): 3xTF32 tensor-core bound "
            f"{row['tc_bound_ms']:.6f} ms ({row['tc_bound_ms'] / ms:.1%} of "
            f"it reached), f32 FMA bound {row['fma_bound_ms']:.6f} ms "
            f"({row['fma_bound_ms'] / ms:.1%})")
        del q, k, v, a, b
        torch.cuda.empty_cache()
    return rows


def seq_tokens(torch, vocab, B, S, seed, dev):
    import numpy as np

    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return torch.from_numpy(toks).to(dev)


def max_diff(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def synced_s(torch, fn):
    """(result, wall seconds) of ``fn`` ended by a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_seq_serve(torch, dev):
    """The sequence track's serving path on internlm2-1.8b at full width
    and depth, f32, random weights from seed 0 drawn on the card: (a)
    launch.serve.serve as the reference runs it; (b) prefill of the same
    prompt = the decode loop; (c) prefill at B 2, S 2048, kernel path =
    plain path; (d) prefill at B 1, S 32768 (kernel path only); (e)
    forward with the dense long-context window 8192 at S 16384, its first
    layer's attention against the plain chunked version; (f)
    encode_segment over 8 documents x 8 segments x 512 tokens, kernel =
    plain.  Every swa_attention launch here is on the main path but for
    the first-layer comparison in (e), which launches after the count is
    read; a profiled prefill of (c)'s shape and a profiled decode step
    follow the count."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.common import (attn_qkv,
                                           chunked_causal_attention,
                                           flatten_tree, make_norm)

    cfg = get_config(SEQ_ARCH)
    L = cfg.num_layers
    kern = build_model(cfg, use_kernels=True, device=dev)
    plain = build_model(cfg, use_kernels=False, device=dev)
    params, init_s = synced_s(torch, lambda: kern.init(
        torch.Generator(dev).manual_seed(0)))
    n_params = sum(t.numel() for _, t in flatten_tree(params))
    out = {"arch": SEQ_ARCH, "params": n_params, "init_s": init_s}
    log(f"[seq_serve] {SEQ_ARCH}: {n_params} parameters ({L} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads} x {cfg.num_kv_heads} heads "
        f"of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), f32, drawn on the card in {init_s:.3f} s")
    main = 0

    def counted(fn, want):
        """Run ``fn`` with the counts set to 0 just before, read just
        after; every launch of it is on the main path."""
        nonlocal main
        ops.reset_kernel_launches()
        res, secs = synced_s(torch, fn)
        got = launched(ops.kernel_launches())
        if got != ({"swa_attention": want} if want else {}):
            raise AssertionError(f"launches {got}, want {want} swa_attention")
        main += want
        return res, secs

    # (a) the serving launcher, as the reference runs it
    B, prompt, n_gen = SEQ_SERVE
    args = types.SimpleNamespace(arch=SEQ_ARCH, reduced=False, batch=B,
                                 prompt_len=prompt, gen=n_gen, seed=0,
                                 device=dev.type)
    steps = prompt + n_gen - 1
    gen, cold_s = counted(lambda: serve.serve(args, params=params), 0)
    gen2, warm_s = counted(lambda: serve.serve(args, params=params), 0)
    if gen.shape != (B, n_gen) or not (gen == gen2).all() \
            or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"serve generated {gen.shape} {gen2.shape}")
    out["serve"] = {"batch": B, "prompt": prompt, "gen": n_gen,
                    "steps": steps,
                    "ms_per_token_cold": cold_s / steps * 1e3,
                    "ms_per_token": warm_s / steps * 1e3}
    log(f"[seq_serve] (a) serve B {B} prompt {prompt} gen {n_gen}: "
        f"{steps} decode steps, "
        f"{out['serve']['ms_per_token']:.3f} ms a token "
        f"(first call {out['serve']['ms_per_token_cold']:.3f}); sample "
        f"{gen[0][:8].tolist()}")

    # (b) prefill of the same prompt = the teacher-forced decode loop
    toks = seq_tokens(torch, cfg.vocab_size, B, prompt, args.seed, dev)
    (lp, cp), _ = counted(lambda: kern.prefill(params, {"tokens": toks}), L)
    caches = kern.init_cache(B, prompt)
    for t in range(prompt):
        ld, caches = kern.decode_step(params, toks[:, t:t + 1], caches,
                                      torch.full((B,), t, device=dev))
    torch.testing.assert_close(lp, ld, rtol=SEQ_TOL, atol=SEQ_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(cp[0][name], caches[0][name], rtol=SEQ_TOL,
                                   atol=SEQ_TOL)
    out["prefill_vs_decode"] = {
        "logits": max_diff(torch, lp, ld),
        "caches": max(max_diff(torch, cp[0][n], caches[0][n])
                      for n in ("k", "v"))}
    log(f"[seq_serve] (b) prefill = decode loop (B {B}, {prompt} tokens): "
        f"max diff "
        f"logits {out['prefill_vs_decode']['logits']:.3e}, caches "
        f"{out['prefill_vs_decode']['caches']:.3e} (tol {SEQ_TOL})")
    del cp, caches

    # (c) prefill B 2, S 2048: kernel path = plain path
    toks = seq_tokens(torch, cfg.vocab_size, *SEQ_PREFILL, 1, dev)
    (lk, ck), k_s = counted(lambda: kern.prefill(params, {"tokens": toks}), L)
    (lp, cp), p_s = synced_s(torch, lambda: plain.prefill(params,
                                                          {"tokens": toks}))
    torch.testing.assert_close(lk, lp, rtol=SEQ_TOL, atol=SEQ_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(ck[0][name], cp[0][name], rtol=SEQ_TOL,
                                   atol=SEQ_TOL)
    out["prefill"] = {"B": SEQ_PREFILL[0], "S": SEQ_PREFILL[1],
        "kernel_s": k_s, "plain_s": p_s,
        "max_diff_logits": max_diff(torch, lk, lp),
        "max_diff_caches": max(max_diff(torch, ck[0][n], cp[0][n])
                               for n in ("k", "v"))}
    log(f"[seq_serve] (c) prefill B, S {SEQ_PREFILL}: kernel path "
        f"{k_s:.3f} s "
        f"({L} swa_attention launches), plain path {p_s:.3f} s; max diff "
        f"logits {out['prefill']['max_diff_logits']:.3e}, caches of "
        f"every layer {out['prefill']['max_diff_caches']:.3e} "
        f"(tol {SEQ_TOL})")
    del ck, cp

    # (d) prefill B 1, S 32768, the kernel path only
    toks = seq_tokens(torch, cfg.vocab_size, *SEQ_LONG, 2, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    (lk, ck), d_s = counted(lambda: kern.prefill(params, {"tokens": toks}), L)
    peak = torch.cuda.max_memory_allocated(dev) - base
    if tuple(lk.shape) != (1, 1, cfg.vocab_size) or not bool(
            torch.isfinite(lk).all()) or not all(
            bool(torch.isfinite(ck[0][n]).all()) for n in ("k", "v")):
        raise AssertionError("long prefill: non-finite or misshapen output")
    n_tok = SEQ_LONG[0] * SEQ_LONG[1]
    out["prefill_long"] = {"B": SEQ_LONG[0], "S": SEQ_LONG[1], "s": d_s,
                          "tokens_per_s": n_tok / d_s,
                          "peak_bytes_above_base": peak,
                          "cache_bytes": sum(ck[0][n].numel() * 4
                                             for n in ("k", "v"))}
    log(f"[seq_serve] (d) prefill B, S {SEQ_LONG}: {d_s:.3f} s "
        f"({n_tok / d_s:.1f} tokens/s), {L} swa_attention launches, peak "
        f"device memory {peak / 2**30:.3f} GiB above the base (caches "
        f"{out['prefill_long']['cache_bytes'] / 2**30:.3f} GiB)")
    del lk, ck
    torch.cuda.empty_cache()

    # (e) the dense long-context window at S 16384
    W, S = cfg.sliding_window, SEQ_WINDOW_S
    toks = seq_tokens(torch, cfg.vocab_size, 1, S, 3, dev)
    hid, e_s = counted(lambda: kern.forward(params, {"tokens": toks},
                                            window=W), L)
    if tuple(hid.shape) != (1, S, cfg.d_model) or not bool(
            torch.isfinite(hid).all()):
        raise AssertionError("windowed forward: non-finite or misshapen")
    layer0 = {k: {n: t[0] for n, t in v.items()}
              for k, v in params["runs"][0].items()}
    x = make_norm(cfg.norm, cfg.d_model)[1](layer0["norm1"],
                                            params["embed"][toks])
    q, k, v = attn_qkv(layer0["attn"], x, num_heads=cfg.num_heads,
                       num_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                       positions=torch.arange(S, device=dev)[None],
                       rope_theta=cfg.rope_theta)
    got = ops.sliding_window_attention(q, k, v, window=W)
    want = chunked_causal_attention(q, k, v, window=W, chunk=1024)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    out["forward_window"] = {"S": S, "window": W, "s": e_s,
                             "layer0_attention_max_diff":
                             max_diff(torch, got, want)}
    log(f"[seq_serve] (e) forward B 1 S {S} window {W}: {e_s:.3f} s, finite, "
        f"{L} swa_attention launches; layer 0's attention kernel vs plain "
        f"chunked max diff "
        f"{out['forward_window']['layer0_attention_max_diff']:.3e} (tol {TOL})")
    del hid, x, q, k, v, got, want
    torch.cuda.empty_cache()

    # (f) GST's segment encoder: 8 documents x 8 segments x 512 tokens
    docs, segs, seg_len = SEQ_DOCS
    toks = seq_tokens(torch, cfg.vocab_size, docs * segs, seg_len, 4, dev)
    (ek, _), f_s = counted(lambda: kern.encode_segment(
        params, {"tokens": toks}), L)
    (ep, _), fp_s = synced_s(torch, lambda: plain.encode_segment(
        params, {"tokens": toks}))
    torch.testing.assert_close(ek, ep, rtol=SEQ_TOL, atol=SEQ_TOL)
    out["encode_segment"] = {"docs": docs, "segments": segs,
                             "tokens": seg_len,
                             "kernel_s": f_s, "plain_s": fp_s,
                             "max_diff": max_diff(torch, ek, ep)}
    log(f"[seq_serve] (f) encode_segment {docs} docs x {segs} segments x "
        f"{seg_len} tokens: "
        f"kernel path {f_s:.3f} s, plain path {fp_s:.3f} s, max diff "
        f"{out['encode_segment']['max_diff']:.3e} (tol {SEQ_TOL})")
    del ek, ep

    # where the device time of a kernel-path prefill at (c)'s shape and of
    # one decode step of (a) goes
    toks = seq_tokens(torch, cfg.vocab_size, *SEQ_PREFILL, 1, dev)
    out["prefill_profile"] = profiled(
        torch, lambda: kern.prefill(params, {"tokens": toks}),
        f"prefill B, S {SEQ_PREFILL}",
        gemm_flops=prefill_gemm_flops(params, cfg, *SEQ_PREFILL))
    toks = seq_tokens(torch, cfg.vocab_size, B, 1, 5, dev)
    caches = kern.init_cache(B, prompt + n_gen)
    pos = torch.full((B,), prompt, device=dev)
    out["decode_profile"] = profiled(
        torch, lambda: kern.decode_step(params, toks, caches, pos),
        f"decode step B {B}, cache {prompt + n_gen}")
    del params
    torch.cuda.empty_cache()
    return main, out


def seq_train_args(*extra):
    from repro_torch.launch.train import build_parser

    return build_parser().parse_args(SEQ_TRAIN + ["--device", "cuda",
                                                  *extra])


def free_card(torch, base, label):
    """Collect, empty the cache, and fail when more than 1 GiB above
    ``base`` stays allocated (a model's state kept alive)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    if left > 2 ** 30:
        raise AssertionError(f"{label}: {left} B still allocated")


def phase_seq_train(torch, dev):
    """The sequence track's training on SEQ_ARCH at full width and depth
    (f32, random weights from seed 0), through launch.train's entry points
    (the main path, launches counted from 0): (a) --track seq gst_efd with
    the kernels, 3 steps: sed_pool once a step at (8, 8, 2048), the
    attention kernel never (the encode that trains runs the plain
    attention: the kernel has no backward); (b) the same
    with --no-use-kernels: losses and parameters within GRAD_TOL of (a);
    (c) (a) with --table-device-rows 16: losses and parameters bitwise
    (a); (d) --track seq gst, 2 steps: the attention kernel once a layer
    a step (the no-grad re-encode of all B·J segments is one call a
    layer), sed_pool never; (e) --track lm, SEQ_LM_STEPS steps: finite,
    loss falling; then one gst_efd step profiled.  ms a step, peak memory
    above the weights; every state freed before the phase returns."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    launches = {}

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = ops.kernel_launches()
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return r, launched(got), seconds, torch.cuda.max_memory_allocated()

    quiet = lambda *a, **k: None     # noqa: E731
    out = {}
    r, got, seconds, peak = counted(lambda: T.train_seq(seq_train_args(),
                                                        log=quiet))
    n_params = sum(p.numel() for p in r.state.backbone.parameters())
    weights = sum(p.numel() * p.element_size()
                  for p in r.state.backbone.parameters())
    want = {"sed_pool": 3}
    if got != launched(want):
        raise AssertionError(f"seq_train (a): launches {got}, want {want}")
    if not all(map(math.isfinite, r.losses)):
        raise AssertionError(f"seq_train (a): losses {r.losses}")
    # parameters and moments: 4x the weights; the rest is activations,
    # gradients' transients and the table
    state_bytes = 4 * weights
    out["a"] = {"losses": r.losses, "ms_per_step": r.step_ms,
                "seconds": seconds, "launches": got, "params": n_params,
                "weights_bytes": weights,
                "peak_above_weights_bytes": peak - base - weights,
                "peak_above_state_bytes": peak - base - state_bytes}
    log(f"[seq_train] (a) {SEQ_ARCH} ({n_params} parameters, {weights} B "
        f"f32), --track seq gst_efd, kernels, B 8 x J 8 x 64 tokens, 3 "
        f"steps: losses {r.losses}, ms a step {r.step_ms}, {seconds:.3f} s "
        f"with the build; peak {peak - base} B above the phase's start: "
        f"{peak - base - weights} B above the weights, "
        f"{peak - base - state_bytes} B above weights, gradients and the two "
        f"AdamW moments; launches {got}")
    kern_losses = r.losses
    kern_params = [p.detach() for p in r.state.backbone.parameters()] + \
        [p.detach() for p in r.state.head.parameters()]
    del r
    free_card(torch, base + weights, "seq_train (a)")

    r, got, seconds, _ = counted(lambda: T.train_seq(seq_train_args(
        "--no-use-kernels"), log=quiet))
    params = [p.detach() for p in list(r.state.backbone.parameters())
              + list(r.state.head.parameters())]
    worst = max(float((a - b).abs().max()) for a, b in zip(kern_params,
                                                          params))
    loss_diff = max(abs(a - b) for a, b in zip(kern_losses, r.losses))
    if got or worst > GRAD_TOL or loss_diff > GRAD_TOL * max(
            1.0, max(map(abs, r.losses))):
        raise AssertionError(f"seq_train (b): plain path launches {got}, "
                             f"max param diff {worst}, loss diff {loss_diff}")
    log(f"[seq_train] (b) --no-use-kernels: losses {r.losses}, max |loss "
        f"diff| {loss_diff:.3e}, max |param diff| {worst:.3e} after 3 steps "
        f"(tolerance {GRAD_TOL}); ms a step {r.step_ms}")
    out["b"] = {"losses": r.losses, "ms_per_step": r.step_ms,
                "max_param_diff": worst, "max_loss_diff": loss_diff}
    del r, params
    free_card(torch, base + weights, "seq_train (b)")

    r, got, seconds, _ = counted(lambda: T.train_seq(seq_train_args(
        "--table-device-rows", str(SEQ_TRAIN_ROWS)), log=quiet))
    params = [p.detach() for p in list(r.state.backbone.parameters())
              + list(r.state.head.parameters())]
    st = r.store_stats
    if r.losses != kern_losses or not all(
            torch.equal(a, b) for a, b in zip(kern_params, params)) \
            or st["evictions"] <= 0:
        raise AssertionError(f"seq_train (c): capped {r.losses} {st} is not "
                             f"bitwise the uncapped {kern_losses}")
    log(f"[seq_train] (c) --table-device-rows {SEQ_TRAIN_ROWS}: losses and "
        f"parameters bitwise (a); ms a step {r.step_ms}; {store_line(st)}")
    out["c"] = {"ms_per_step": r.step_ms, "store": st}
    del r, params, kern_params
    free_card(torch, base, "seq_train (c)")

    r, got, seconds, _ = counted(lambda: T.train_seq(seq_train_args(
        "--variant", "gst", "--steps", "2"), log=quiet))
    layers = get_config(SEQ_ARCH).num_layers
    want = {"swa_attention": 2 * layers}
    if got != launched(want) or not all(map(math.isfinite, r.losses)):
        raise AssertionError(f"seq_train (d) gst: launches {got}, want "
                             f"{want}; losses {r.losses}")
    log(f"[seq_train] (d) --variant gst, 2 steps: losses {r.losses}, ms a "
        f"step {r.step_ms}; launches {got}: the no-grad re-encode of all "
        f"8 x 8 segments is one attention call a layer ({layers} a step), "
        "the sampled encode that trains runs the plain attention")
    out["d"] = {"losses": r.losses, "ms_per_step": r.step_ms,
                "launches": got}
    del r
    free_card(torch, base, "seq_train (d)")

    r, got, seconds, peak = counted(lambda: T.train_lm(seq_train_args(
        "--track", "lm", "--steps", str(SEQ_LM_STEPS)), log=quiet))
    if got or not all(map(math.isfinite, r.losses)) \
            or not r.losses[-1] < r.losses[0]:
        raise AssertionError(f"seq_train (e) lm: launches {got}, losses "
                             f"{r.losses}")
    log(f"[seq_train] (e) --track lm, {SEQ_LM_STEPS} steps: losses "
        f"{r.losses} (falling), ms a step {r.step_ms}, peak "
        f"{peak - base - weights} B above the weights")
    out["e"] = {"losses": r.losses, "ms_per_step": r.step_ms,
                "peak_above_weights_bytes": peak - base - weights}
    del r
    free_card(torch, base, "seq_train (e)")

    # one gst_efd step under the profiler (not on the main path)
    from repro_torch.data.tokens import doc_batch_iterator
    from repro_torch.graphs.experiment import epoch_generator
    import numpy as np

    model, docs, state, step, store = T.seq_setup(seq_train_args())
    tups = list(doc_batch_iterator(docs, 8, rng=np.random.default_rng(0)))
    box = {"state": state, "i": 0}

    def one_step():
        tup = tups[box["i"] % len(tups)]
        box["state"], m = step(box["state"], T.seq_batch(model, tup, tup[2],
                                                         0, box["i"]),
                               epoch_generator(0, box["i"]))
        box["i"] += 1
        return float(m["loss"])

    one_step()
    out["profile"] = profiled(torch, one_step, "gst_efd train step",
                              tag="seq_train")
    store.close()
    del model, state, step, store, box
    free_card(torch, base, "seq_train profile")
    return launches, out


def prefill_gemm_flops(params, cfg, batch, seq):
    """The matmul operations of ``Model.prefill``: every layer's
    projections and MLP (the stacked (L, in, out) weights) over all
    batch·seq tokens, and the lm_head over one token a sequence."""
    from repro_torch.models.common import flatten_tree

    layers = sum(t.numel() for _, t in flatten_tree(params["runs"])
                 if t.dim() == 3)
    head = params["embed" if cfg.tie_embeddings else "lm_head"].numel()
    return 2 * batch * seq * layers + 2 * batch * head


def profiled(torch, fn, label, gemm_flops=None, tag="seq_serve"):
    """One warm call of ``fn``, then one under torch.profiler: device
    events, their summed time by kind (the attention kernel, matmuls, the
    rest), and the busy share of the wall time (a lower bound: the
    profiler's host overhead is in the wall).  ``gemm_flops``: the
    matmuls' operations, for their rate."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {"swa_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in events:
        kind = ("swa_attention" if "swa_attention_kernel" in e.name else
                "gemm" if "gemm" in e.name.lower() else "other")
        by[kind] += e.time_range.elapsed_us() / 1e3
    busy = sum(by.values())
    log(f"[{tag}] profiled {label}: {len(events)} device events, busy "
        f"{busy:.3f} ms of {wall_ms:.3f} ms wall (busy share "
        f"{busy / wall_ms:.4f}): swa_attention {by['swa_attention']:.3f} ms, "
        f"matmuls {by['gemm']:.3f} ms, other {by['other']:.3f} ms")
    res = {"device_events": len(events), "device_ms": by, "busy_ms": busy,
           "wall_ms": wall_ms, "busy_share": busy / wall_ms}
    if gemm_flops:
        res["gemm_tflops"] = gemm_flops / 1e12
        res["gemm_tflop_per_s"] = gemm_flops / (by["gemm"] * 1e-3) / 1e12
        log(f"[{tag}] profiled {label}: matmuls "
            f"{res['gemm_tflops']:.3f} TFLOP at "
            f"{res['gemm_tflop_per_s']:.2f} TFLOP/s")
    return res


def family_config(arch, layers):
    """The full-width config of ``arch``, cut to ``layers`` layers (None:
    all); deepseek-v3's two are one dense and one MoE layer."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is None:
        return cfg
    if cfg.use_mla:
        return dataclasses.replace(cfg, num_layers=layers,
                                   block_pattern=("dense", "moe"))
    return dataclasses.replace(cfg, num_layers=layers)


def family_shape(cfg):
    """The mixing layers' widths, for the model line."""
    if cfg.attn_free:
        H = cfg.d_model // cfg.ssm.state_size
        return f"attention-free, RWKV-6 {H} heads of {cfg.ssm.state_size}"
    shape = (f"{cfg.num_heads} x {cfg.num_kv_heads} heads of "
             f"{cfg.resolved_head_dim}")
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        shape += (f"; Mamba2 d_inner {d_inner}, {cfg.ssm.num_ssm_heads} "
                  f"heads of {d_inner // cfg.ssm.num_ssm_heads}, state "
                  f"{cfg.ssm.state_size}, chunk {cfg.ssm.chunk_size}")
    return shape


def family_inputs(torch, cfg, B, S, seed, dev, patches=True):
    """Tokens, then the VLM's patches or the encoder-decoder's frames, drawn
    from one numpy generator in the order launch/serve.py draws them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev)}
    if cfg.family == "vlm" and patches:
        out["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.vision_prefix_len, cfg.d_model))).float().to(dev)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model))).float().to(dev)
    return out


def tree_max_diff(torch, a, b, check=True):
    """Max abs diff over the leaves of two cache trees; integer leaves (the
    MoE counters) must be equal, and with ``check`` the float leaves within
    SEQ_TOL."""
    from repro_torch.models.common import flatten_tree

    fa, fb = dict(flatten_tree(a)), dict(flatten_tree(b))
    if set(fa) != set(fb):
        raise AssertionError(f"cache trees differ: {sorted(fa)} {sorted(fb)}")
    worst = 0.0
    for name, x in fa.items():
        if x.shape != fb[name].shape:
            raise AssertionError(f"{name}: {tuple(x.shape)} != "
                                 f"{tuple(fb[name].shape)}")
        if not x.is_floating_point():
            if not torch.equal(x, fb[name]):
                raise AssertionError(f"{name} differs")
            continue
        if check:
            torch.testing.assert_close(x, fb[name], rtol=SEQ_TOL,
                                       atol=SEQ_TOL)
        worst = max(worst, max_diff(torch, x, fb[name]))
    return worst


def one_ulp_embedding(torch, params, seed=5):
    """``params`` with every embedding entry moved by one ulp, up or down
    at random: a model's own float noise is how far its outputs move."""
    emb = params["embed"]
    g = torch.Generator(emb.device).manual_seed(seed)
    sign = torch.randint(0, 2, emb.shape, generator=g,
                         device=emb.device).float() * 2 - 1
    return {**params, "embed": emb * (1 + sign * 2.0 ** -23)}


def stack_layers(torch, cfg, params, tokens):
    """Every layer of a decoder-only stack along its full-sequence pass
    through the kernel, caches emitted: (kind, layer params, positions,
    the layer's input, its output, its cache)."""
    from repro_torch.models import blocks, transformer

    B, S = tokens.shape
    positions, _ = transformer._build_positions(cfg, B, S,
                                                device=tokens.device)
    x = transformer._embed(params, cfg, tokens)
    for i, (kind, n) in enumerate(transformer.layer_runs(cfg)):
        for j in range(n):
            p = (params["shared_attn"] if kind == "shared_attn"
                 else transformer._layer(params["runs"][i], j))
            y, cache, _ = blocks.block_forward(
                kind, p, x, cfg, mode="full", positions=positions,
                emit_cache=True)
            yield kind, p, positions, x, y, cache
            x = y


def layerwise(torch, cfg, params, tokens, against):
    """Every layer held to itself on its own input from the kernel path's
    full-sequence pass: against its decode loop from a zero cache (each
    step's output, the final cache) or against its plain path (output,
    cache), within SEQ_TOL.  Returns (layers, largest output diff,
    largest cache diff)."""
    from repro_torch.models import blocks

    B, S = tokens.shape
    layers, out_diff, cache_diff = 0, 0.0, 0.0
    for kind, p, positions, x, y, full in stack_layers(torch, cfg, params,
                                                       tokens):
        if against == "decode":
            other = blocks.init_block_cache(kind, cfg, B, S, x.dtype,
                                            device=x.device)
            outs = [blocks.block_forward(
                kind, p, x[:, t:t + 1], cfg, mode="decode", cache=other,
                cache_pos=torch.full((B,), t, device=x.device))[0]
                for t in range(S)]
            got = torch.cat(outs, dim=1)
        else:
            got, other, _ = blocks.block_forward(
                kind, p, x, cfg, mode="full", positions=positions,
                emit_cache=True, use_kernels=False)
        torch.testing.assert_close(got, y, rtol=SEQ_TOL, atol=SEQ_TOL)
        out_diff = max(out_diff, max_diff(torch, got, y))
        cache_diff = max(cache_diff, tree_max_diff(torch, full, other))
        layers += 1
    return layers, out_diff, cache_diff


def recurrent_check(torch, cfg, model, params, inp, logits, caches,
                    other_logits, other_caches, against):
    """(b) and (c) for the recurrent families.  Their random stacks
    amplify f32 noise with depth, so at full depth two paths that round
    differently part end to end by about as much as, or more than, one
    path moves when its embedding moves by one ulp: the end-to-end logits
    and caches are reported beside that noise, and every layer is held
    to its decode loop or its plain path within SEQ_TOL on its own input
    (``layerwise``)."""
    noisy, noisy_c = model.prefill(one_ulp_embedding(torch, params), inp)
    layers, out_diff, cache_diff = layerwise(torch, cfg, params,
                                             inp["tokens"], against)
    res = {"max_diff_logits": max_diff(torch, logits, other_logits),
           "max_diff_caches": tree_max_diff(torch, caches, other_caches,
                                            check=False),
           "logits_one_ulp_noise": max_diff(torch, logits, noisy),
           "caches_one_ulp_noise": tree_max_diff(torch, caches, noisy_c,
                                                 check=False),
           "layers": layers, "layer_max_diff_outputs": out_diff,
           "layer_max_diff_caches": cache_diff}
    del noisy, noisy_c
    return res, (f"layer by layer ({layers} layers, each on its own input "
                 f"from the kernel path's prefill) max diff outputs "
                 f"{out_diff:.3e}, caches {cache_diff:.3e} (tol {SEQ_TOL}); "
                 f"end to end logits {res['max_diff_logits']:.3e}, caches "
                 f"{res['max_diff_caches']:.3e}, beside the prefill's own "
                 f"one-ulp noise {res['logits_one_ulp_noise']:.3e} / "
                 f"{res['caches_one_ulp_noise']:.3e}")


def phase_seq_families(torch, dev):
    """Sequence serving of the other families at full width, f32,
    random weights from seed 0 drawn on the card, one model at a time
    (each freed before the next): qwen2-vl-7b (M-RoPE, patches),
    arctic-480b (1 layer), deepseek-v3-671b (1 dense + 1 MoE layer),
    whisper-large-v3 (encoder-decoder), zamba2-1.2b (Mamba2, shared
    attention) and rwkv6-7b (attention-free).  For each: (a)
    launch.serve.serve at B 2, prompt 16, 16 generated; (b) prefill of
    that prompt = the decode loop (last logits, every cache; 5e-4); (c)
    prefill at B 1, S 2048 (qwen2-vl: its first 256 positions patches;
    whisper: 1500 frames and a decoder S of 448), kernel path = plain
    path, seconds of a call after a warm-up call (rwkv6's plain path: the
    kernel path's code, warmed by its call) and peak memory above the
    weights; (d) encode_segment at 8 x 512 tokens (whisper: 8 x 1500
    frames), kernel = plain; then one profiled decode
    step.  swa_attention launches: the table's count a pass in (b)-(d)
    (whisper's encode_segment runs the encoder alone: none); all on the
    main path.  Returns (launches, summary)."""
    import types

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model, encdec
    from repro_torch.models.common import flatten_tree

    main, out = 0, []

    def counted(fn, want):
        nonlocal main
        ops.reset_kernel_launches()
        res, secs = synced_s(torch, fn)
        got = launched(ops.kernel_launches())
        if got != ({"swa_attention": want} if want else {}):
            raise AssertionError(f"launches {got}, want {want} swa_attention")
        main += want
        return res, secs

    for arch, layers, per_pass in FAMILY_RUNS:
        before = torch.cuda.memory_allocated(dev)
        free, total = torch.cuda.mem_get_info(dev)
        log(f"[seq_families] {arch}: card memory free {free / 2**30:.3f} of "
            f"{total / 2**30:.3f} GiB before the build")
        cfg = family_config(arch, layers)
        kern = build_model(cfg, use_kernels=True, device=dev)
        plain = build_model(cfg, use_kernels=False, device=dev)
        params, init_s = synced_s(torch, lambda: kern.init(
            torch.Generator(dev).manual_seed(0)))
        # no list of the leaves: it would keep the weights alive past the
        # model's own loop iteration
        n_params = sum(t.numel() for _, t in flatten_tree(params))
        weights = sum(t.numel() * t.element_size()
                      for _, t in flatten_tree(params))
        res = {"arch": arch, "layers": cfg.num_layers,
               "full_depth_layers": family_config(arch, None).num_layers,
               "params": n_params, "weight_bytes": weights,
               "init_s": init_s, "swa_launches_per_pass": per_pass}
        log(f"[seq_families] {arch}: {n_params} parameters, "
            f"{weights / 2**30:.3f} GiB ({cfg.num_layers} of "
            f"{res['full_depth_layers']} layers, d_model {cfg.d_model}, "
            f"{family_shape(cfg)}), f32, drawn on the card in "
            f"{init_s:.3f} s")

        # (a) the serving launcher
        B, prompt, n_gen = SEQ_SERVE
        args = types.SimpleNamespace(arch=arch, reduced=False, batch=B,
                                     prompt_len=prompt, gen=n_gen, seed=0,
                                     device=dev.type)
        steps = prompt + n_gen - 1
        gen, cold_s = counted(lambda: serve.serve(args, params, cfg), 0)
        gen2, warm_s = counted(lambda: serve.serve(args, params, cfg), 0)
        if gen.shape != (B, n_gen) or not (gen == gen2).all() \
                or gen.min() < 0 or gen.max() >= cfg.vocab_size:
            raise AssertionError(f"serve generated {gen.shape} {gen2.shape}")
        res["serve"] = {"batch": B, "prompt": prompt, "gen": n_gen,
                        "ms_per_token_cold": cold_s / steps * 1e3,
                        "ms_per_token": warm_s / steps * 1e3,
                        "sample": gen[0][:8].tolist()}
        log(f"[seq_families] {arch} (a) serve B {B} prompt {prompt} gen "
            f"{n_gen}: {res['serve']['ms_per_token']:.3f} ms a token (first "
            f"call {res['serve']['ms_per_token_cold']:.3f}); sample "
            f"{res['serve']['sample']}")

        # (b) prefill of that prompt (text only: decode has no patches) =
        # the decode loop, with the MoE capacity of the prompt's length
        inp = family_inputs(torch, cfg, B, prompt, args.seed, dev,
                            patches=False)
        (lp, cp), _ = counted(lambda: kern.prefill(params, inp), per_pass)
        caches = kern.init_cache(B, prompt)
        if cfg.is_encoder_decoder:
            caches = {"self": caches, "cross": encdec.cross_kv(
                params, cfg, encdec.encode(params, cfg, inp["frames"]))}
        for t in range(prompt):
            ld, caches = kern.decode_step(
                params, inp["tokens"][:, t:t + 1], caches,
                torch.full((B,), t, device=dev), moe_cap_len=prompt)
        if cfg.family in RECURRENT:
            res["prefill_vs_decode"], held = recurrent_check(
                torch, cfg, kern, params, inp, lp, cp, ld, caches, "decode")
            log(f"[seq_families] {arch} (b) prefill = decode loop (B {B}, "
                f"{prompt} tokens): {held}; {per_pass} swa_attention "
                "launches")
        else:
            torch.testing.assert_close(lp, ld, rtol=SEQ_TOL, atol=SEQ_TOL)
            res["prefill_vs_decode"] = {
                "logits": max_diff(torch, lp, ld),
                "caches": tree_max_diff(torch, cp, caches)}
            log(f"[seq_families] {arch} (b) prefill = decode loop (B {B}, "
                f"{prompt} tokens): max diff logits "
                f"{res['prefill_vs_decode']['logits']:.3e}, caches "
                f"{res['prefill_vs_decode']['caches']:.3e} (tol {SEQ_TOL}); "
                f"{per_pass} swa_attention launches")
        del lp, cp, ld, caches

        # (c) prefill at full length, kernel path = plain path
        Bc, S = FAMILY_PREFILL
        if cfg.is_encoder_decoder:
            S = WHISPER_DECODER_S
        inp = family_inputs(torch, cfg, Bc, S, 1, dev)
        runs = {}
        for label, model, want in (("kernel", kern, per_pass),
                                   ("plain", plain, 0)):
            # attention-free, the plain path runs the kernel path's code,
            # which the kernel path's call has warmed
            if label == "kernel" or not cfg.attn_free:
                model.prefill(params, inp)  # warm-up, outside the counts
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            (lg, c), secs = counted(lambda: model.prefill(params, inp), want)
            runs[label] = (lg, c, secs,
                           torch.cuda.max_memory_allocated(dev) - base)
        (lk, ck, k_s, k_peak), (lp, cp, p_s, p_peak) = \
            runs["kernel"], runs["plain"]
        if tuple(lk.shape) != (Bc, 1, cfg.vocab_size) or not bool(
                torch.isfinite(lk).all()):
            raise AssertionError("prefill: non-finite or misshapen logits")
        res["prefill"] = {
            "B": Bc, "S": S, "kernel_s": k_s, "plain_s": p_s,
            "kernel_peak_bytes": k_peak, "plain_peak_bytes": p_peak}
        if cfg.family in RECURRENT:
            diffs, held = recurrent_check(torch, cfg, kern, params, inp, lk,
                                          ck, lp, cp, "plain")
            res["prefill"].update(diffs)
        else:
            torch.testing.assert_close(lk, lp, rtol=SEQ_TOL, atol=SEQ_TOL)
            res["prefill"].update(
                max_diff_logits=max_diff(torch, lk, lp),
                max_diff_caches=tree_max_diff(torch, ck, cp))
            held = (f"max diff logits {res['prefill']['max_diff_logits']:.3e}"
                    f", caches {res['prefill']['max_diff_caches']:.3e} (tol "
                    f"{SEQ_TOL})")
        if cfg.family == "vlm":
            res["prefill"]["patches"] = cfg.vision_prefix_len
        if cfg.is_encoder_decoder:
            res["prefill"]["frames"] = cfg.encoder_seq_len
        log(f"[seq_families] {arch} (c) prefill B {Bc} S {S}"
            + (f" ({cfg.vision_prefix_len} patches)" if cfg.family == "vlm"
               else f" over {cfg.encoder_seq_len} frames"
               if cfg.is_encoder_decoder else "")
            + f": kernel path {k_s:.3f} s ({per_pass} swa_attention "
            f"launches), peak {k_peak / 2**30:.3f} GiB above the weights; "
            f"plain path {p_s:.3f} s"
            + (" (no warm-up call of its own: attention-free, it is the "
               "kernel path's code)" if cfg.attn_free else "")
            + f", peak {p_peak / 2**30:.3f} GiB; {held}")
        del runs, lk, ck, lp, cp

        # (d) GST's segment encoder
        docs, seg_len = FAMILY_DOCS
        inp = family_inputs(torch, cfg, docs,
                            1 if cfg.is_encoder_decoder else seg_len, 2, dev)
        want = 0 if cfg.is_encoder_decoder else per_pass
        (ek, _), d_s = counted(lambda: kern.encode_segment(params, inp), want)
        (ep, _), dp_s = synced_s(torch, lambda: plain.encode_segment(params,
                                                                     inp))
        if tuple(ek.shape) != (docs, cfg.d_model):
            raise AssertionError(f"encode_segment: {tuple(ek.shape)}")
        torch.testing.assert_close(ek, ep, rtol=SEQ_TOL, atol=SEQ_TOL)
        n = cfg.encoder_seq_len if cfg.is_encoder_decoder else seg_len
        res["encode_segment"] = {"docs": docs, "tokens": n,
                                 "kernel_s": d_s, "plain_s": dp_s,
                                 "max_diff": max_diff(torch, ek, ep)}
        log(f"[seq_families] {arch} (d) encode_segment {docs} x {n} "
            f"{'frames' if cfg.is_encoder_decoder else 'tokens'}: kernel "
            f"path {d_s:.3f} s ({want} swa_attention launches), plain path "
            f"{dp_s:.3f} s, max diff {res['encode_segment']['max_diff']:.3e} "
            f"(tol {SEQ_TOL})")
        del ek, ep

        # where one decode step's device time goes (B 2, cache 32)
        inp = family_inputs(torch, cfg, B, 1, 5, dev, patches=False)
        caches = kern.init_cache(B, prompt + n_gen)
        if cfg.is_encoder_decoder:
            caches = {"self": caches, "cross": encdec.cross_kv(
                params, cfg, encdec.encode(params, cfg, inp["frames"]))}
        pos = torch.full((B,), prompt, device=dev)
        res["decode_profile"] = profiled(
            torch, lambda: kern.decode_step(params, inp["tokens"], caches,
                                            pos),
            f"{arch} decode step B {B}, cache {prompt + n_gen}",
            tag="seq_families")
        out.append(res)
        del params, caches, inp, kern, plain
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(dev) - before
        if left > 2**30:
            raise AssertionError(f"{arch}: {left / 2**30:.3f} GiB still "
                                 "allocated after its model was freed")
    return main, out


def phase_recurrent_pieces(torch, dev):
    """The plain-torch pieces of the recurrent families that no kernel of
    the reference covers, one layer each at full width, f32, weights from
    seed 0: zamba2-1.2b's ``ssd_chunked`` (on one layer's own projections
    of random input) and rwkv6-7b's ``rwkv_timemix`` at B 1, S 2048, and
    one layer's decode step of each (``block_forward``, B 2).  Per piece:
    ms of a call (CUDA events around it after a warm-up: the host's gaps
    between launches included), the device events of one call and their
    summed time under torch.profiler (``profiled``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, mamba2, rwkv6

    Bp, S = FAMILY_PREFILL
    B = SEQ_SERVE[0]
    out = {}
    for arch, kind in (("zamba2-1.2b", "mamba"), ("rwkv6-7b", "rwkv")):
        cfg = get_config(arch)
        gen = torch.Generator(dev).manual_seed(0)
        p = blocks.block_init(kind, gen, cfg)
        x = torch.randn(Bp, S, cfg.d_model, device=dev, generator=gen)
        if kind == "mamba":
            d_inner, H, P, N = mamba2.mamba2_dims(cfg)
            mp = p["mamba"]
            xs, _, Bm, Cm, dt = mamba2._split_in(mp, x, cfg)
            xs = mamba2._causal_conv(mp, xs)[0].reshape(Bp, S, H, P)
            A = -torch.exp(mp["A_log"].float())
            piece = ("ssd_chunked", lambda: mamba2.ssd_chunked(
                xs, Bm, Cm, dt, A, chunk=cfg.ssm.chunk_size))
        else:
            piece = ("rwkv_timemix", lambda: rwkv6.rwkv_timemix(
                p["tm"], x, cfg))
        cache = blocks.init_block_cache(kind, cfg, B, 1, torch.float32,
                                        device=dev)
        x1 = torch.randn(B, 1, cfg.d_model, device=dev, generator=gen)
        pos = torch.zeros(B, dtype=torch.int64, device=dev)
        step = (f"{kind} decode step", lambda: blocks.block_forward(
            kind, p, x1, cfg, mode="decode", cache=cache, cache_pos=pos))
        for (name, fn), shape in ((piece, (Bp, S)), (step, (B, 1))):
            ms = time_long_ms(torch, fn, iters=5)
            prof = profiled(torch, fn, f"{arch} {name}", tag="recurrent")
            n, busy = prof["device_events"], prof["busy_ms"]
            out[f"{arch} {name}"] = {"B": shape[0], "S": shape[1], "ms": ms,
                                     "launches": n, "device_ms": busy}
            log(f"[recurrent] {arch} {name} B {shape[0]} S {shape[1]}: "
                f"{ms:.3f} ms a call (CUDA events), {n} launches, device "
                f"busy {busy:.3f} ms ({busy / ms:.3f} of the call)")
    return out


def kernel_entry(name, source, replaces, launches, rows, headline):
    head = rows[headline]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": rows}


TURN_CODE = (
    "import json, sys; root = sys.argv[1]; "
    "sys.path[:0] = [root + '/src', root]; "
    "import torch, chip_smoke as c, repro_torch; "
    "dev = torch.device('cuda', 0); torch.cuda.set_device(dev); "
    "print('TURN ' + json.dumps({'spmm': c.phase_kernel(torch, dev), "
    "'spmm_bwd': c.phase_kernel_bwd(torch, dev), "
    "'quant': c.phase_kernel_quant(torch, dev), "
    "'serve': c.phase_serving(torch, dev, 'sage')[1], "
    "'train': c.phase_training(torch, dev, *c.TRAIN_RUNS[0])[1], "
    "'profile': c.phase_profile(torch, dev), "
    "'dist_profile': c.phase_dist_profile(torch)}))")


def turns(parent: Path) -> None:
    """The kernel phases (SpMM forward and backward, the pack and unpack
    kernels), the sage serving replay, the first training run, the
    profiled train step and the profiled distributed step (ring / int8) of
    the tree at ``parent`` and of this one in
    turns: parent, this, this, parent, each in its own process on card 0
    with the kernels its tree builds.  One line of times a turn."""
    for label, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                        ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", TURN_CODE, str(root)],
                             cwd=root, capture_output=True, text=True,
                             timeout=900, check=True).stdout
        rows = json.loads(next(line[5:] for line in out.splitlines()
                               if line.startswith("TURN ")))
        times = [f"spmm{'' if k == 'spmm' else ' bwd'} "
                 + ",".join(str(v) for v in r["shape"].values() if v != "float32")
                 + f" {r['ms']:.6f}" for k in ("spmm", "spmm_bwd") for r in rows[k]]
        times += [f"{name} {r['shape']['R']}x{r['shape']['N']} {r['ms']:.6f}"
                  for name, rs in rows["quant"].items() for r in rs
                  if r["ms"] is not None]
        times += [f"serving p50 {rows['serve']['latency_p50_ms']:.3f} p99 "
                  f"{rows['serve']['latency_p99_ms']:.3f} ms",
                  f"ms_per_iter {rows['train']['ms_per_iter']:.3f}",
                  "device ms a step "
                  f"{rows['profile']['device_busy_ms_per_step']:.4f} "
                  f"({rows['profile']['device_events_per_step']:.0f} events)",
                  "distributed step (ring / int8): device ms "
                  f"{rows['dist_profile']['device_busy_ms_per_step']:.4f}, "
                  "hand-written ms "
                  f"{rows['dist_profile']['handwritten_ms_per_step']:.6f}, "
                  "wall ms "
                  f"{rows['dist_profile']['wall_ms_per_step']:.3f}"]
        log(f"[turns] {label} ({root}): " + "; ".join(times))


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
    if sys.argv[1:2] == ["--turns"]:
        phase_card(torch)
        turns(Path(sys.argv[2]).resolve())
        return 0
    t0 = time.perf_counter()
    name, smi = phase_card(torch)
    swa_build = phase_build()
    rows = phase_kernel(torch, dev)
    bwd_rows = phase_kernel_bwd(torch, dev)
    sed_rows = phase_kernel_sed(torch, dev, aged=False)
    aged_rows = phase_kernel_sed(torch, dev, aged=True)
    quant_rows = phase_kernel_quant(torch, dev)
    swa_rows = phase_kernel_swa(torch, dev)
    main_launches = {}
    serving = []
    for backbone in ("sage", "gcn"):
        launches, summary = phase_serving(torch, dev, backbone)
        main_launches["segment_spmm_batched"] = \
            main_launches.get("segment_spmm_batched", 0) + launches
        serving.append(summary)
    phase_streaming(torch, dev)
    log(f"[training] epochs cut from 30 to {TRAIN_EPOCHS}, finetune epochs "
        f"from 10 to {FINETUNE_EPOCHS}, for time; distributed epochs from 5 "
        f"to {DIST_EPOCHS}, finetune epochs from 3 to {DIST_FINETUNE_EPOCHS}")
    training = []
    for dataset, backbone, decay in TRAIN_RUNS:
        launches, summary = phase_training(torch, dev, dataset, backbone,
                                           decay)
        for k, v in launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
        training.append(summary)

    dist = []
    for exchange, dtype, decay in DIST_RUNS:
        launches, summary = phase_dist(torch, exchange, dtype, decay)
        for k, v in launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
        dist.append(summary)
    f32_losses, inline_f32 = phase_dist_f32_strategies(torch)
    launches, dist_prefetch = phase_dist_prefetch(torch, inline_f32)
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v

    store = {}
    for part, phase in (("training", lambda: phase_store_training(torch)),
                        ("serving", lambda: phase_store_serving(torch)),
                        ("dist", lambda: phase_store_dist(torch, dist[0]))):
        launches, store[part] = phase()
        for k, v in launches.items():
            main_launches[k] = main_launches.get(k, 0) + v
    store["migration"] = phase_store_migration(torch, dev)
    launches, telemetry = phase_telemetry(torch, dev)
    for k, v in launches.items():
        main_launches[k] = main_launches.get(k, 0) + v

    profile = phase_profile(torch, dev)
    dist_profile = phase_dist_profile(torch)
    dist_scaling = phase_dist_scaling(torch)
    train_launches, seq_train = phase_seq_train(torch, dev)
    for k, v in train_launches.items():
        main_launches[k] = main_launches.get(k, 0) + v
    serve_launches, seq_serve = phase_seq_serve(torch, dev)
    main_launches["swa_attention"] = main_launches.get(
        "swa_attention", 0) + serve_launches
    family_launches, seq_families = phase_seq_families(torch, dev)
    main_launches["swa_attention"] += family_launches
    recurrent = phase_recurrent_pieces(torch, dev)

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
    quant_src = "src/repro/kernels/quant.py:"
    for kernel, line, headline in (
            ("quant_pack_bf16", 139, 3), ("quant_pack_bf16_det", 143, 0),
            ("quant_pack_int8", 147, 3), ("quant_pack_int8_det", 153, 0),
            ("quant_unpack_bf16", 159, 0), ("quant_unpack_int8", 163, 0)):
        kernels.append(kernel_entry(kernel, csrc + "quant.cu",
                                    quant_src + str(line),
                                    main_launches.get(kernel, 0),
                                    quant_rows[kernel], headline))
    kernels.append(kernel_entry(
        "swa_attention", csrc + "swa_attention.cu",
        "src/repro/kernels/swa_attention.py:27",
        main_launches["swa_attention"], swa_rows, SWA_HEADLINE))
    kernels[-1].update(
        launches_by_path={
            "seq_train": train_launches.get("swa_attention", 0),
            "seq_serve": serve_launches, "seq_families": family_launches},
        tc_bound_ms=swa_rows[SWA_HEADLINE]["tc_bound_ms"],
        fma_bound_ms=swa_rows[SWA_HEADLINE]["fma_bound_ms"],
        build=swa_build)
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    log(json.dumps({"serving": serving, "training": training,
                    "profile": profile, "dist": dist,
                    "dist_f32_epoch_losses": f32_losses,
                    "dist_prefetch": dist_prefetch, "seq_train": seq_train,
                    "store": store, "telemetry": telemetry,
                    "dist_profile": dist_profile,
                    "dist_scaling_ms": dist_scaling, "seq_serve": seq_serve,
                    "seq_families": seq_families,
                    "recurrent_pieces": recurrent, "card": smi,
                    "seconds": time.perf_counter() - t0}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
