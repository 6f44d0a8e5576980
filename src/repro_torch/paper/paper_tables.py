"""The paper's experiments through the port: one function per table or
figure, each returning and printing ``name,value,derived`` rows.

Counterpart of ``benchmarks/paper_tables.py``: the same nine entries under
the same keys of ``ALL_BENCHES``, the same row names in the same order at
the same sizes (``quick`` and full), and every training run through
``repro_torch.graphs.experiment.run_experiment`` with exactly the
reference's arguments, plus ``device`` (the kernels stay on, its
default).  Scales are CPU-sized in the reference; the orderings and
mechanisms are what reproduce.  Where the reference measures with XLA,
the port measures with its own tools:

* ``fig1_memory``: the reference reads a compiled step's
  ``memory_analysis().temp_size_in_bytes``.  The port compiles nothing, so
  it builds the same step (``obs/memory_sweep.py::train_leg``: one
  warm-up step) and measures the next real call with
  ``obs/memory.py::measure_call``: the allocator on the card, the dispatch
  mode's accounting on the CPU; ``derived`` names the mode.
* ``kernels``: the reference times its jnp oracles.  The port times its
  plain versions at the same shapes and, on a card, adds a row for each
  hand-written kernel, timed with CUDA events behind a sleep kernel after
  a warm-up; ``derived`` carries the card's name and power limit.
* ``roofline``: the reference reads a dry run's JSON, whose terms are a
  TPU's.  The port reads its own dry run's (``python -m
  repro_torch.launch.dryrun --out ...``; ``path``, by default
  ``build/dryrun_single.json``), whose terms are over the H100's constants
  (``roofline/analysis.py::HW``), and emits the reference's rows; each
  ``derived`` names those constants.  Without the file it prints the
  missing row.
* ``table6``: ``louvain`` falls back to BFS where networkx cannot be
  imported (``graphs/partition.py``); that row's ``derived`` then says so.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graphs import experiment as E
from repro_torch.graphs.partition import partitioner_run
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.obs.memory import measure_call
from repro_torch.obs.memory_sweep import train_leg

Row = Tuple[str, float, str]


def _emit(rows: List[Row]) -> List[Row]:
    for name, val, derived in rows:
        print(f"{name},{val},{derived}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Table 1 — MalNet accuracy across variants × backbones
# ---------------------------------------------------------------------------


def table1_malnet(quick: bool = False, seeds=(0, 1),
                  device="cuda") -> List[Row]:
    backbones = ["sage"] if quick else ["gcn", "sage"]
    variants = ["gst", "gst_one", "gst_e", "gst_efd"] if quick else \
        ["full", "gst", "gst_one", "gst_e", "gst_ef", "gst_ed", "gst_efd"]
    seeds = seeds[:1] if quick else seeds
    rows: List[Row] = []
    for bb in backbones:
        for v in variants:
            accs = []
            for s in seeds:
                r = E.run_experiment(dataset="malnet", backbone=bb, variant=v,
                                     n_graphs=60 if quick else 120,
                                     epochs=12 if quick else 35,
                                     finetune_epochs=6 if quick else 15,
                                     seed=s, device=device)
                accs.append(r.test_metric)
            rows.append((f"table1/malnet/{bb}/{v}",
                         round(float(np.mean(accs)), 4),
                         f"test_acc±{np.std(accs):.3f}"))
    return _emit(rows)


# ---------------------------------------------------------------------------
# Table 2 — TpuGraphs OPA across variants
# ---------------------------------------------------------------------------


def table2_tpugraphs(quick: bool = False, device="cuda") -> List[Row]:
    rows: List[Row] = []
    for v in ["gst", "gst_one", "gst_e", "gst_efd"]:
        r = E.run_experiment(dataset="tpugraphs", backbone="sage", variant=v,
                             n_graphs=48 if quick else 80,
                             epochs=15 if quick else 30,
                             finetune_epochs=0, seed=0, device=device)
        rows.append((f"table2/tpugraphs/{v}/train",
                     round(r.train_metric, 4), "train_OPA"))
        rows.append((f"table2/tpugraphs/{v}/test",
                     round(r.test_metric, 4), "test_OPA"))
    return _emit(rows)


# ---------------------------------------------------------------------------
# Table 3 — runtime per training iteration across variants
# ---------------------------------------------------------------------------


def table3_runtime(quick: bool = False, device="cuda") -> List[Row]:
    rows: List[Row] = []
    for v in ["full", "gst", "gst_one", "gst_e", "gst_efd"]:
        r = E.run_experiment(dataset="malnet", backbone="sage", variant=v,
                             n_graphs=40, epochs=4, finetune_epochs=0, seed=0,
                             device=device)
        rows.append((f"table3/ms_per_iter/{v}", round(r.ms_per_iter, 2),
                     "median_train_iter_ms"))
    return _emit(rows)


# ---------------------------------------------------------------------------
# Figure 3 — SED keep-ratio sweep
# ---------------------------------------------------------------------------


def fig3_keep_ratio(quick: bool = False, device="cuda") -> List[Row]:
    rows: List[Row] = []
    ps = [0.0, 0.5, 1.0] if quick else [0.0, 0.25, 0.5, 0.75, 1.0]
    for p in ps:
        r = E.run_experiment(dataset="malnet", backbone="sage",
                             variant="gst_efd",
                             n_graphs=60 if quick else 100,
                             epochs=12 if quick else 30,
                             finetune_epochs=6 if quick else 12,
                             keep_prob=p, seed=0, device=device)
        rows.append((f"fig3/keep_ratio/{p}", round(r.test_metric, 4),
                     "test_acc"))
    return _emit(rows)


# ---------------------------------------------------------------------------
# Figure 4 — max segment size sweep
# ---------------------------------------------------------------------------


def fig4_segment_size(quick: bool = False, device="cuda") -> List[Row]:
    rows: List[Row] = []
    sizes = [32, 64] if quick else [24, 32, 48, 64, 96]
    for m in sizes:
        r = E.run_experiment(dataset="malnet", backbone="sage",
                             variant="gst_efd",
                             n_graphs=60 if quick else 100, max_seg_nodes=m,
                             epochs=12 if quick else 30,
                             finetune_epochs=6 if quick else 12, seed=0,
                             device=device)
        rows.append((f"fig4/seg_size/{m}", round(r.test_metric, 4),
                     "test_acc"))
    return _emit(rows)


# ---------------------------------------------------------------------------
# Table 6 — partition-algorithm ablation
# ---------------------------------------------------------------------------


def table6_partitioners(quick: bool = False, device="cuda") -> List[Row]:
    rows: List[Row] = []
    methods = ["bfs", "random"] if quick else ["bfs", "louvain", "random",
                                               "vertex_cut"]
    for m in methods:
        r = E.run_experiment(dataset="malnet", backbone="sage",
                             variant="gst_efd",
                             n_graphs=60 if quick else 100, partition=m,
                             epochs=12 if quick else 30,
                             finetune_epochs=6 if quick else 12, seed=0,
                             device=device)
        ran = partitioner_run(m)
        rows.append((f"table6/partition/{m}", round(r.test_metric, 4),
                     "test_acc" if ran == m else f"test_acc;partition={ran}"))
    return _emit(rows)


# ---------------------------------------------------------------------------
# Figure 1 / §5.1 — constant-memory claim (a train step's temp bytes vs J)
# ---------------------------------------------------------------------------


def _fig1_setup(variant, J, dev, m=48, B=4, hidden=32, n=16, seed=0):
    """The reference's Figure 1 step (sage, 8 features, hidden 32, a table
    of n graphs, one batch of B graphs x J full segments of m nodes and e
    edges): (the step, the arguments of its measured call)."""
    rng = np.random.default_rng(seed)
    e = 64
    tup = ({"x": rng.normal(size=(B, J, m, 8)).astype(np.float32),
            "edges": rng.integers(0, m, (B, J, e, 2)).astype(np.int32),
            "edge_valid": np.ones((B, J, e), np.float32),
            "node_valid": np.ones((B, J, m), np.float32)},
           np.ones((B, J), np.float32), np.arange(B, dtype=np.int32),
           rng.integers(0, 5, B).astype(np.int32))
    return train_leg(tup, variant, n_rows=n, hidden=hidden, dev=dev)


def fig1_memory(quick: bool = False, device="cuda") -> List[Row]:
    dev = resolve_device(device)
    rows: List[Row] = []
    Js = [4, 8, 16] if quick else [2, 4, 8, 16, 32]
    for variant in ["full", "gst_efd"]:
        for J in Js:
            step, args = _fig1_setup(variant, J, dev)
            rec, _ = measure_call(step, args)
            del step, args
            rows.append((f"fig1/temp_bytes/{variant}/J={J}",
                         rec["temp_bytes"], f"{rec['mode']}_temp_bytes"))
    return _emit(rows)


# ---------------------------------------------------------------------------
# Kernels — µs/call: the plain versions and, on a card, the kernels
# ---------------------------------------------------------------------------


def card_label(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card ``dev``."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def time_us(fn: Callable, dev: torch.device, n: int = 3) -> float:
    """µs a call of ``fn`` after a warm-up call.  On the CPU the host clock
    over ``n`` calls, as the reference times; on a card CUDA events around
    ``n`` calls queued behind a sleep kernel, so they time the device and
    not the host's launches (the sleep is doubled where the host fell
    behind it)."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize(dev)
    cycles = 50_000_000                     # ~25 ms at the H100's clock
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        slept.record()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        host_kept_ahead = not slept.query()
        torch.cuda.synchronize(dev)
        if host_kept_ahead:
            return start.elapsed_time(end) / n * 1e3
        if cycles >= 1_600_000_000:
            raise RuntimeError("the host could not enqueue the timed calls "
                               "ahead of the card")
        cycles *= 2


def kernels_bench(quick: bool = False, device="cuda") -> List[Row]:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    m, d, e = 128, 128, 1024
    h = t(rng.normal(size=(m, d)).astype(np.float32))
    src = t(rng.integers(0, m, e).astype(np.int32))
    dst = t(rng.integers(0, m, e).astype(np.int32))
    w = torch.ones(e, device=dev)
    B, J, dd = 64, 16, 256
    hh = t(rng.normal(size=(B, J, dd)).astype(np.float32))
    ones = torch.ones(B, J, device=dev)
    zeros = torch.zeros(B, J, device=dev)
    q = t(rng.normal(size=(1, 512, 4, 64)).astype(np.float32))
    # (name, plain version, kernel, shape)
    cases = [
        ("segment_spmm",
         lambda: ref.segment_spmm_ref(h, src, dst, w, m),
         lambda: kops.batched_neighbor_sum(h[None], src[None], dst[None],
                                           w[None]),
         f"m={m},d={d},e={e}"),
        ("sed_pool",
         lambda: ref.sed_pool_ref(hh, ones, ones, zeros, 0.5, 1),
         lambda: kops.sed_aggregate(hh, ones, ones, zeros, keep_prob=0.5,
                                    num_sampled=1),
         f"B={B},J={J},d={dd}"),
        ("swa",
         lambda: ref.swa_attention_ref(q, q, q, 256),
         lambda: kops.sliding_window_attention(q, q, q, window=256),
         "S=512,W=256"),
    ]
    n = 20 if dev.type == "cuda" else 3
    where = card_label(dev) if dev.type == "cuda" else "cpu"
    rows: List[Row] = [(f"kernels/{name}_ref_us",
                        round(time_us(plain, dev, n), 1),
                        f"{shape};plain;{where}")
                       for name, plain, _, shape in cases]
    if dev.type == "cuda":
        rows += [(f"kernels/{name}_us", round(time_us(kernel, dev, n), 1),
                  f"{shape};kernel;{where}")
                 for name, _, kernel, shape in cases]
    return _emit(rows)


# ---------------------------------------------------------------------------
# Roofline — dump the dry run's table (single-pod baselines)
# ---------------------------------------------------------------------------

DRYRUN_JSON = "build/dryrun_single.json"


def roofline_table(quick: bool = False, device="cuda",
                   path: str = DRYRUN_JSON) -> List[Row]:
    import json
    import os

    if not os.path.exists(path):
        return _emit([("roofline/missing", 0.0,
                       "run python -m repro_torch.launch.dryrun --mesh "
                       f"single --out {path} first")])
    from repro_torch.roofline.analysis import HW   # imports DTensor's stack

    hw = HW()
    card = (f"H100 {hw.peak_flops:.4g} FLOP/s bf16, {hw.hbm_bw:.4g} B/s "
            f"HBM, {hw.link_bw:.4g} B/s NVLink")
    with open(path) as f:
        results = json.load(f)
    rows: List[Row] = []
    for r in results:
        if r.get("status") != "ok":
            continue
        t = r["terms_seconds"]
        name = f"roofline/{r['arch']}/{r['shape']}"
        for term in ("compute", "memory", "collective"):
            rows.append((f"{name}/{term}_s", f"{t[term]:.3e}",
                         f"{r['dominant']};{card}"))
        if "useful_flops_ratio" in r:
            rows.append((name + "/useful_flops_ratio",
                         round(r["useful_flops_ratio"], 4),
                         f"6ND/matmul FLOPs;{card}"))
    return _emit(rows)


ALL_BENCHES = {
    "table1": table1_malnet,
    "table2": table2_tpugraphs,
    "table3": table3_runtime,
    "fig3": fig3_keep_ratio,
    "fig4": fig4_segment_size,
    "table6": table6_partitioners,
    "fig1_memory": fig1_memory,
    "kernels": kernels_bench,
    "roofline": roofline_table,
}
