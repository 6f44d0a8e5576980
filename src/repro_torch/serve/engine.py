"""Graph-property serving engine of the port: constant-memory
segment-streaming inference.

Counterpart of ``src/repro/serve/engine.py``.  GST's Eq.-1 structure —
encode segments independently, aggregate, then run a small head — means
inference never needs the whole graph in device memory:

* ``make_stream_encoder``: a loop over fixed-size chunks of one graph's
  padded segments (the JAX package's ``lax.scan``).  Only the pooled
  readout (d_h floats + a count) is carried; each chunk goes to the device,
  is encoded, and its buffers are freed before the next one, so peak device
  memory is one chunk's, however large the graph.

* ``ServeEngine.process``: bucketed dynamic batching across requests.
  Segments from all requests in a window are routed into a small ladder of
  padded-CSR buckets (serve/buckets.py), deduplicated against the
  cross-request segment cache (serve/cache.py), and only the misses are
  encoded — one batch per bucket, so the SpMM kernel runs once per
  message-passing layer for a whole bucket batch.  On a full cache hit only
  the cheap head runs.

Both paths go through graphs/gnn.py::encode_segments.  Everything runs
under ``torch.no_grad()``: serving needs no autograd graph.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gst as G
from repro_torch.graphs.data import SyntheticGraph
from repro_torch.graphs.gnn import GNN, GNNConfig, encode_segments, gnn_init
from repro_torch.graphs.partition import partition_graph
from repro_torch.kernels.ops import kernel_launches, next_pow2
from repro_torch.obs.memory import probe_call
from repro_torch.obs.metrics import (AGE_BUCKETS_STEPS, LATENCY_BUCKETS_MS,
                                     Histogram, get_registry, summarize)
from repro_torch.obs.trace import span
from repro_torch.serve.buckets import (
    BucketSpec,
    batch_bucket,
    choose_bucket,
    count_local_edges,
    default_ladder,
    pad_to_bucket,
    segment_fingerprint,
    truncation_counts,
)
from repro_torch.serve.cache import SegmentCache
from repro_torch.store import StoreCounters, TieredStore

SEG_KEYS = ("x", "edges", "edge_valid", "node_valid")


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host numpy segment arrays -> tensors on ``device`` (dtypes kept:
    float32 features and masks, int32 edges)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _total_launches() -> int:
    return sum(kernel_launches().values())


# ---------------------------------------------------------------------------
# streaming encoder (constant-memory single-graph path)
# ---------------------------------------------------------------------------


def graph_to_chunks(graph: SyntheticGraph, spec: BucketSpec, chunk: int, *,
                    partition: str = "bfs", seed: int = 0,
                    partition_max_nodes: int = 0,
                    pad_chunks_pow2: bool = True) -> Dict[str, np.ndarray]:
    """Partition + pad one graph into chunks: host arrays
    (n_chunks, chunk, ...) plus ``seg_valid`` (n_chunks, chunk).

    partition_max_nodes: segment size cap for the partitioner (default: the
    bucket's m_max).  The engine passes its cfg.max_seg_nodes so the
    streaming path sees the SAME segmentation as the bucketed path.
    n_chunks is padded to the next power of two (invalid chunks are
    all-zero), as in the JAX package.
    """
    segs = partition_graph(len(graph.x), graph.edges,
                           partition_max_nodes or spec.m_max, partition, seed)
    padded = [pad_to_bucket(graph, s, spec) for s in segs]
    n = len(padded)
    n_chunks = max((n + chunk - 1) // chunk, 1)
    if pad_chunks_pow2:
        n_chunks = next_pow2(n_chunks)
    out: Dict[str, np.ndarray] = {}
    for k in SEG_KEYS:
        first = padded[0][k]
        arr = np.zeros((n_chunks, chunk) + first.shape, first.dtype)
        for i, seg in enumerate(padded):
            arr[i // chunk, i % chunk] = seg[k]
        out[k] = arr
    valid = np.zeros((n_chunks, chunk), np.float32)
    valid.reshape(-1)[:n] = 1.0
    out["seg_valid"] = valid
    return out


def make_stream_encoder(cfg: GNNConfig, *, head_mode: str = "mlp",
                        agg: str = "mean"):
    """Returns ``stream(params, head, chunks, device) -> (pred, pooled)``.

    chunks: host arrays with SEG_KEYS leaves (C, chunk, ...) and seg_valid
    (C, chunk).  The loop carries only the pooled accumulator — (d_h,) for
    the MLP head, a scalar for the per-segment head — and moves one chunk
    at a time to ``device``, so live device memory is one chunk's
    activations regardless of C.
    """

    @torch.no_grad()
    def stream(params: GNN, head: G.Head, chunks: Dict[str, np.ndarray],
               device) -> Tuple[torch.Tensor, torch.Tensor]:
        if head_mode == "segment_sum":
            s = torch.zeros((), device=device)
        else:
            # carry width = hidden dim, recovered from the head params
            s = torch.zeros(head.w1.shape[0], device=device)
        cnt = torch.zeros((), device=device)
        for c in range(chunks["seg_valid"].shape[0]):
            ch = to_device({k: chunks[k][c] for k in SEG_KEYS + ("seg_valid",)},
                           device)
            h = encode_segments(params, cfg,
                                {k: ch[k] for k in SEG_KEYS})     # (chunk, d)
            w = ch["seg_valid"]
            if head_mode == "segment_sum":
                s = s + torch.sum(G.head_apply(head, h, "segment_sum") * w)
            else:
                s = s + torch.sum(h * w[:, None], dim=0)
            cnt = cnt + torch.sum(w)
            del ch, h, w          # this chunk's buffers go before the next
        pooled = s / cnt.clamp_min(1.0) if agg == "mean" else s
        if head_mode == "segment_sum":
            return pooled, pooled          # pred IS the pooled scalar (F' = Σ)
        return G.head_apply(head, pooled, "mlp"), pooled

    return stream


# ---------------------------------------------------------------------------
# serving engine (bucketed batching + cross-request cache)
# ---------------------------------------------------------------------------


@dataclass
class ServeConfig:
    backbone: str = "sage"             # gcn | sage | gps
    n_feat: int = 8
    hidden: int = 64
    use_kernels: bool = True           # gcn/sage SpMM through the CUDA kernel
    head_mode: str = "mlp"             # mlp | segment_sum
    agg: str = "mean"                  # mean | sum
    n_out: int = 5
    max_seg_nodes: int = 64
    partition: str = "bfs"
    partition_seed: int = 0            # fixed -> identical graphs re-partition
                                       # identically -> cache hits
    ladder: Optional[Tuple[BucketSpec, ...]] = None
    cache_capacity: int = 512
    cache_enabled: bool = True
    # cap the cache's device-resident rows over a host-RAM tier
    # (store/tiered.py): cold entries spill to the host and fault back on a
    # hit instead of being re-encoded.  None keeps every row on the device.
    # The other three act only on a capped cache: its eviction policy
    # ("lru" or "stale-first"), the delta-gated write-back threshold (0 =
    # off, bit-exact) and the stale-row forecaster
    table_device_rows: Optional[int] = None
    evict_policy: str = "lru"
    wb_threshold: float = 0.0
    stale_forecast: bool = False
    stream_chunk: int = 8
    device: str = "cuda"               # cuda unless the caller asks for cpu

    def resolved_ladder(self) -> Tuple[BucketSpec, ...]:
        return self.ladder or default_ladder(self.max_seg_nodes)


@dataclass
class RequestResult:
    request_id: int
    pred: np.ndarray                   # () scalar or (n_out,) logits
    latency_ms: float
    n_segments: int
    n_cache_hits: int


def _latency_hist() -> Histogram:
    return Histogram("latency_ms", buckets=LATENCY_BUCKETS_MS, unit="ms")


@dataclass
class ServeStats:
    n_requests: int = 0
    n_segments: int = 0
    encode_launches: int = 0           # bucket-batch encodes
    encoded_segments: int = 0          # segments that actually ran the GNN
    kernel_launches: int = 0           # kernel launches of those encodes
    truncated_nodes: int = 0           # nodes dropped by catch-all overflow
    truncated_edges: int = 0           # edges dropped by catch-all overflow
    wall_s: float = 0.0
    # fixed-bucket histogram: a replay of any length summarizes in
    # O(buckets) memory (obs.metrics)
    latency: Histogram = field(default_factory=_latency_hist)
    cache: Dict = field(default_factory=dict)

    def summary(self) -> Dict:
        lat = summarize(self.latency)
        return {
            "n_requests": self.n_requests,
            "n_segments": self.n_segments,
            "throughput_req_s": self.n_requests / self.wall_s if self.wall_s else 0.0,
            "latency_p50_ms": lat["p50"],
            "latency_p99_ms": lat["p99"],
            "latency_mean_ms": lat["mean"],
            "encode_launches": self.encode_launches,
            "encoded_segments": self.encoded_segments,
            "kernel_launches": self.kernel_launches,
            "truncated_nodes": self.truncated_nodes,
            "truncated_edges": self.truncated_edges,
            "cache": dict(self.cache),
        }


class ServeEngine:
    """Answers streams of graph-property requests with constant device memory.

    Request flow:  partition -> bucket -> cache probe -> batched encode of
    the misses (one encode per bucket batch) -> cache insert -> η=1
    aggregate -> head.  ``params``/``head`` default to weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (GNN first, then the head).
    """

    def __init__(self, cfg: ServeConfig, params: Optional[GNN] = None,
                 head: Optional[G.Head] = None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.gnn_cfg = GNNConfig(backbone=cfg.backbone, n_feat=cfg.n_feat,
                                 hidden=cfg.hidden, use_kernels=cfg.use_kernels)
        gen = torch.Generator().manual_seed(seed)
        self.params = (params if params is not None
                       else gnn_init(self.gnn_cfg, gen, "cpu")).to(self.device)
        self.head = (head if head is not None else G.head_init(
            cfg.hidden, cfg.n_out, cfg.head_mode, gen, "cpu")).to(self.device)
        self.ladder = cfg.resolved_ladder()
        store = None
        if cfg.cache_enabled and cfg.table_device_rows is not None:
            store = TieredStore(cfg.cache_capacity, 1, cfg.hidden,
                                device_rows=cfg.table_device_rows,
                                device=self.device,
                                evict_policy=cfg.evict_policy,
                                wb_threshold=cfg.wb_threshold,
                                stale_forecast=cfg.stale_forecast)
        self.cache = (SegmentCache(cfg.cache_capacity, cfg.hidden,
                                   store=store, device=self.device)
                      if cfg.cache_enabled else None)
        self.stats = ServeStats()
        # memory-probe sites: the head, one encode a bucket, the stream
        self._encode_fns: Dict[int, object] = {}
        self._head_fn = probe_call("serve.head", self._head_impl)
        self._stream = None
        self._request_counter = 0

    def close(self):
        """Release the cache's backing store (a TieredStore's write-back
        thread)."""
        if self.cache is not None:
            self.cache.close()

    def reset_stats(self):
        """Zero the counters (post-warmup), keeping the cache contents;
        cache hit/miss counters restart too."""
        self.stats = ServeStats()
        if self.cache is not None:
            self.cache.hits = self.cache.misses = 0
            self.cache.evictions = self.cache.skipped_inserts = 0
            self.cache.store.counters = StoreCounters()

    # -- encode ------------------------------------------------------------

    def _encode_bucket(self, bi: int, seg_inputs: Dict[str, np.ndarray]
                       ) -> torch.Tensor:
        fn = self._encode_fns.get(bi)
        if fn is None:
            gc = self.gnn_cfg
            fn = self._encode_fns[bi] = probe_call(
                f"serve.encode.{self.ladder[bi].key}",
                lambda p, si: encode_segments(p, gc, si))
        launches0 = _total_launches()
        with span("serve.encode", bucket=bi):
            emb = fn(self.params, to_device(seg_inputs, self.device))
        self.stats.encode_launches += 1
        self.stats.kernel_launches += _total_launches() - launches0
        return emb

    # -- request processing ------------------------------------------------

    def _segment_request(self, graph: SyntheticGraph):
        """Partition + route one graph; returns [(key, bucket_idx, padded)].

        Catch-all overflow is counted, not silent: segments larger than the
        last bucket's shape lose their overflow nodes/edges to pad_segment's
        truncation."""
        segs = partition_graph(len(graph.x), graph.edges, self.cfg.max_seg_nodes,
                               self.cfg.partition, self.cfg.partition_seed)
        items = []
        tn = te = 0
        for s in segs:
            ne = count_local_edges(graph, s)
            bi = choose_bucket(self.ladder, len(s), ne)
            dn, de = truncation_counts(len(s), ne, self.ladder[bi])
            tn += dn
            te += de
            padded = pad_to_bucket(graph, s, self.ladder[bi])
            items.append((segment_fingerprint(padded, bi), bi, padded))
        if tn or te:
            self.stats.truncated_nodes += tn
            self.stats.truncated_edges += te
            reg = get_registry()
            if reg.enabled:
                if tn:
                    reg.inc("serve.bucket.truncated_nodes", tn, unit="nodes")
                if te:
                    reg.inc("serve.bucket.truncated_edges", te, unit="edges")
        return items

    def process(self, graphs: Sequence[SyntheticGraph],
                window: int = 8) -> List[RequestResult]:
        """Serve a stream of requests in arrival order, ``window`` at a time
        (the dynamic-batching window: segments of all requests in a window
        share device batches)."""
        results: List[RequestResult] = []
        for w0 in range(0, len(graphs), window):
            chunk = graphs[w0:w0 + window]
            with span("serve.window", requests=len(chunk)):
                results.extend(self._process_window(chunk))
        return results

    @torch.no_grad()
    def _process_window(self, graphs: Sequence[SyntheticGraph]) -> List[RequestResult]:
        t0 = time.perf_counter()
        launches0 = self.stats.encode_launches
        with span("serve.partition", requests=len(graphs)):
            requests = [self._segment_request(g) for g in graphs]

        # cache probe (per segment occurrence) + miss dedup (per content key)
        key_slot: Dict[bytes, int] = {}
        miss_by_bucket: Dict[int, List[Tuple[bytes, Dict]]] = {}
        seen_miss = set()
        hits_per_req = []
        for items in requests:
            n_hits = 0
            for key, bi, padded in items:
                if self.cache is not None:
                    slot = key_slot.get(key)
                    if slot is None:
                        slot = self.cache.get(key)
                    else:
                        self.cache.hits += 1  # in-window duplicate of a hit
                    if slot is not None:
                        key_slot[key] = slot
                        n_hits += 1
                        continue
                if key not in seen_miss:
                    seen_miss.add(key)
                    miss_by_bucket.setdefault(bi, []).append((key, padded))
            hits_per_req.append(n_hits)

        # batched encode of the misses, one encode per bucket batch
        fresh: Dict[bytes, torch.Tensor] = {}
        for bi, misses in sorted(miss_by_bucket.items()):
            spec = self.ladder[bi]
            for i in range(0, len(misses), spec.batch):
                chunk = misses[i:i + spec.batch]
                seg_inputs, _valid = batch_bucket([p for _, p in chunk], spec)
                emb = self._encode_bucket(bi, seg_inputs)       # (batch, d)
                for j, (key, _) in enumerate(chunk):
                    fresh[key] = emb[j]
                self.stats.encoded_segments += len(chunk)

        # cross-request insert (best-effort: over-capacity batches keep what
        # fits).  This window's hit keys are pinned — their slots are
        # gathered below.
        if self.cache is not None and fresh:
            with span("serve.insert", segments=len(fresh)):
                keys = list(fresh)
                slots = self.cache.put(keys,
                                       torch.stack([fresh[k] for k in keys]),
                                       pinned=key_slot.keys())
                for k, s in zip(keys, slots):
                    if s is not None:
                        key_slot[k] = s

        # per-request aggregate + head: J is padded to the next power of two
        # with a validity mask, as in the JAX package.  This window's misses
        # aggregate from ``fresh`` (bit-identical to what was just
        # inserted); hits gather from the cache table.
        out: List[RequestResult] = []
        reg = get_registry()
        hit_rows: List[int] = []       # cache rows this window's hits read
        n_fresh_reads = 0              # fresh-embedding reads (staleness 0)
        for ri, (graph, items) in enumerate(zip(graphs, requests)):
            J = len(items)
            Jp = next_pow2(J)
            mask = np.zeros((Jp,), np.float32)
            mask[:J] = 1.0
            cached_pos = [j for j, (key, _, _) in enumerate(items)
                          if key not in fresh]
            cemb = None
            if cached_pos:
                cp = next_pow2(len(cached_pos))
                cmask = np.zeros((cp,), np.float32)
                cmask[:len(cached_pos)] = 1.0
                cslots = [key_slot[items[j][0]] for j in cached_pos]
                hit_rows.extend(cslots)
                cslots += [cslots[0]] * (cp - len(cslots))
                with span("serve.gather", rows=len(cached_pos)):
                    cemb = self.cache.gather(cslots, valid=cmask)  # (cp, d)
            rows, ci = [], 0
            for key, _, _ in items:
                if key in fresh:
                    rows.append(fresh[key])
                    n_fresh_reads += 1
                else:
                    rows.append(cemb[ci])
                    ci += 1
            h = torch.stack(rows + [rows[0]] * (Jp - J))           # (Jp, d)
            with span("serve.head", segments=J):
                pred = self._head_fn(
                    self.head, h, torch.from_numpy(mask).to(self.device))
                pred_np = pred.cpu().numpy()          # waits for the card
            latency_ms = (time.perf_counter() - t0) * 1e3
            out.append(RequestResult(
                request_id=self._request_counter, pred=pred_np,
                latency_ms=latency_ms, n_segments=len(items),
                n_cache_hits=hits_per_req[ri]))
            self._request_counter += 1
            self.stats.latency.observe(latency_ms)
            reg.observe("serve.latency_ms", latency_ms,
                        buckets=LATENCY_BUCKETS_MS, unit="ms")
            self.stats.n_segments += len(items)
        self.stats.n_requests += len(graphs)
        self.stats.wall_s += time.perf_counter() - t0
        if reg.enabled:
            self._publish_window(reg, n_requests=len(graphs),
                                 n_launches=self.stats.encode_launches
                                 - launches0, hit_rows=hit_rows,
                                 n_fresh_reads=n_fresh_reads)
        if self.cache is not None:
            self.stats.cache = self.cache.stats()
        return out

    def _publish_window(self, reg, *, n_requests: int, n_launches: int,
                        hit_rows: List[int], n_fresh_reads: int) -> None:
        """Registry mirror of one window (only when metrics are enabled).

        ``serve.prediction_staleness``: the age, in cache insertion steps,
        of every table row the window's served predictions read — hits
        gather rows stamped ``cache.step`` at insert time, fresh encodes
        read age-0 embeddings."""
        reg.inc("serve.windows")
        reg.inc("serve.requests", n_requests)
        reg.inc("serve.encode_launches", n_launches)
        if self.cache is not None:
            self.cache.publish_counters()
            hist = reg.histogram("serve.prediction_staleness",
                                 buckets=AGE_BUCKETS_STEPS, unit="steps")
            if hit_rows:
                age, _ = self.cache.store.ages_init(self.cache.table)
                hist.observe_many(self.cache.step
                                  - age[np.asarray(hit_rows, np.int64), 0])
            if n_fresh_reads:
                hist.observe_many(np.zeros(n_fresh_reads))

    def _head_impl(self, head: G.Head, h: torch.Tensor, mask: torch.Tensor):
        """η=1 aggregate + head over one request's segment embeddings
        (Jp, d) with validity mask (Jp,) — the paper's test-time
        distribution P(F'(⊕ h_j), y)."""
        J = torch.sum(mask).clamp_min(1.0)
        if self.cfg.head_mode == "segment_sum":
            s = torch.sum(G.head_apply(head, h, "segment_sum") * mask)
            return s / J if self.cfg.agg == "mean" else s
        pooled = torch.sum(h * mask[:, None], dim=0)
        pooled = pooled / J if self.cfg.agg == "mean" else pooled
        return G.head_apply(head, pooled, "mlp")

    # -- streaming single-graph path --------------------------------------

    def predict_streaming(self, graph: SyntheticGraph) -> np.ndarray:
        """Constant-memory prediction for one (arbitrarily large) graph via
        the chunked streaming encoder; bypasses the cache."""
        chunks = graph_to_chunks(graph, self.ladder[-1], self.cfg.stream_chunk,
                                 partition=self.cfg.partition,
                                 seed=self.cfg.partition_seed,
                                 partition_max_nodes=self.cfg.max_seg_nodes)
        if self._stream is None:
            self._stream = probe_call("serve.stream", make_stream_encoder(
                self.gnn_cfg, head_mode=self.cfg.head_mode, agg=self.cfg.agg))
        pred, _ = self._stream(self.params, self.head, chunks, self.device)
        return pred.cpu().numpy()
