"""Host-to-device segment pipeline of the distributed trainer.

Counterpart of ``src/repro/dist/pipeline.py``.  The synchronous loop does
``gather batch -> copy to the device -> step`` in series;
``AsyncSegmentFeeder`` moves the gather and the copy to a background
thread, keeping up to ``depth`` batches ready while the current step runs.
Both feeders replay one precomputed id schedule (``epoch_ids``), so they
deliver the same batches, and count the milliseconds ``next()`` waits
(``FeederStats``).  ``PrefetchLane`` wraps either with a one-item
lookahead that issues the next batch's table lookup before the current
step (the ``--prefetch-lookups`` lane).

``put_fn`` owns what a delivered item is: the trainer's routes the
batch's ids through the store and splits it over the shards
(``dist/train.py::shard_batch``).

Padding is shared with serving: ``shared_bucket`` picks the (m_max,
e_max) shape from the serve bucket ladder and ``segment_dataset_shared``
pads the training set to it with the same ``pad_segment``.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import gst as G
from repro_torch.graphs import batching as Bt
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import span
from repro_torch.serve.buckets import BucketSpec, choose_bucket, default_ladder


# ---------------------------------------------------------------------------
# shared train/serve padding policy
# ---------------------------------------------------------------------------


def shared_bucket(max_seg_nodes: int, batch: int = 8,
                  ladder: Optional[Tuple[BucketSpec, ...]] = None) -> BucketSpec:
    """The serve-ladder bucket a training run pads to: the smallest rung
    fitting ``max_seg_nodes``."""
    ladder = ladder or default_ladder(max_seg_nodes, batch=batch)
    return ladder[choose_bucket(ladder, max_seg_nodes, 0)]


def segment_dataset_shared(graphs, max_seg_nodes: int = 64, *,
                           method: str = "bfs", seed: int = 0,
                           j_max: Optional[int] = None,
                           ) -> Tuple[Bt.SegmentedDataset, BucketSpec]:
    """``Bt.segment_dataset`` padded to the serve bucket ladder's shapes."""
    spec = shared_bucket(max_seg_nodes)
    ds = Bt.segment_dataset(graphs, spec.m_max, method=method, seed=seed,
                            j_max=j_max, e_max=spec.e_max)
    return ds, spec


# ---------------------------------------------------------------------------
# feeders
# ---------------------------------------------------------------------------


@dataclass
class FeederStats:
    batches: int = 0
    host_blocked_ms: float = 0.0     # time next() waited on host work
    put_ms: float = 0.0              # put_fn time (async: off-thread)
    blocked_per_batch: List[float] = field(default_factory=list)

    @property
    def host_blocked_ms_per_batch(self) -> float:
        return self.host_blocked_ms / max(self.batches, 1)

    def record_batch(self, blocked_ms: float) -> None:
        """One delivered batch: local stats + the registry mirror
        (``feeder.batches``, ``feeder.host_blocked_ms``)."""
        self.batches += 1
        self.host_blocked_ms += blocked_ms
        self.blocked_per_batch.append(blocked_ms)
        reg = get_registry()
        if reg.enabled:
            reg.inc("feeder.batches")
            reg.inc("feeder.host_blocked_ms", blocked_ms, unit="ms")


def _assemble(ds: Bt.SegmentedDataset, ids: np.ndarray) -> G.GSTBatch:
    """Host-side batch assembly (the numpy gather) as a GSTBatch of numpy
    arrays; ``batch_pos`` = the rows' positions in this global batch."""
    return G.GSTBatch(ds.seg_inputs(ids), ds.seg_valid[ids],
                      ids.astype(np.int32), ds.labels[ids],
                      np.arange(len(ids), dtype=np.int64))


def epoch_ids(ds: Bt.SegmentedDataset, batch_size: int, *,
              rng: np.random.Generator, shuffle: bool = True) -> List[np.ndarray]:
    """The id schedule of one epoch, precomputed so the sync and async
    feeders replay the same trace (``Bt.batch_id_schedule``'s policy)."""
    return Bt.batch_id_schedule(ds.n, batch_size, rng=rng, shuffle=shuffle)


class SyncSegmentFeeder:
    """Baseline feeder: assemble and put inline on the consumer thread
    (all host work is blocked time)."""

    def __init__(self, ds: Bt.SegmentedDataset, id_schedule: List[np.ndarray],
                 put_fn: Callable[[G.GSTBatch], Any]):
        self._ds = ds
        self._sched = id_schedule
        self._put = put_fn
        self.stats = FeederStats()

    def __iter__(self) -> Iterator:
        for ids in self._sched:
            t0 = time.perf_counter()
            with span("feeder.assemble", batch=len(ids)):
                host = _assemble(self._ds, ids)
            t1 = time.perf_counter()
            with span("feeder.put"):
                dev = self._put(host)
            t2 = time.perf_counter()
            self.stats.put_ms += (t2 - t1) * 1e3
            self.stats.record_batch((t2 - t0) * 1e3)
            yield dev


class AsyncSegmentFeeder:
    """Double-buffered feeder: a daemon thread assembles and puts batches
    k+1..k+depth while the consumer runs step k; ``next()`` blocks only
    when the producer has not caught up.

    Single-shot (build one per epoch).  Abandoning the iterator (a step
    raising, a break) closes the feeder: the producer stops and the queued
    batches are dropped.  A producer error is raised on the consumer."""

    _DONE = object()

    def __init__(self, ds: Bt.SegmentedDataset, id_schedule: List[np.ndarray],
                 put_fn: Callable[[G.GSTBatch], Any], *, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._ds = ds
        self._sched = id_schedule
        self._put = put_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._exc: Optional[BaseException] = None
        self._stop = threading.Event()
        self._consumed = False
        self.stats = FeederStats()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="segment-feeder")
        self._thread.start()

    def _put_q(self, item) -> bool:
        """Stop-aware blocking put; False when the feeder was closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for ids in self._sched:
                if self._stop.is_set():
                    return
                t1 = time.perf_counter()
                with span("feeder.assemble", batch=len(ids)):
                    host = _assemble(self._ds, ids)
                with span("feeder.put"):
                    dev = self._put(host)
                self.stats.put_ms += (time.perf_counter() - t1) * 1e3
                if not self._put_q(dev):
                    return
        except BaseException as e:  # raised on the consumer side
            self._exc = e
        finally:
            self._put_q(self._DONE)

    def close(self) -> None:
        """Stop the producer and drop the batches in flight."""
        self._stop.set()

        def drain():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass

        drain()  # wake a put-blocked producer now
        self._thread.join(timeout=5.0)
        drain()  # a put racing past the first drain may have landed

    def __iter__(self) -> Iterator:
        if self._consumed:
            raise RuntimeError(
                "AsyncSegmentFeeder is single-shot: construct a new feeder "
                "per epoch (the id schedule is the reusable part)")
        self._consumed = True
        try:
            while True:
                t0 = time.perf_counter()
                with span("feeder.wait"):
                    item = self._q.get()
                blocked = (time.perf_counter() - t0) * 1e3
                if item is self._DONE:
                    self._thread.join()
                    if self._exc is not None:
                        raise self._exc
                    return
                self.stats.record_batch(blocked)
                yield item
        finally:  # abandoned mid-epoch (break / step raised): shut down
            self.close()


def make_feeder(kind: str, ds: Bt.SegmentedDataset,
                id_schedule: List[np.ndarray],
                put_fn: Callable[[G.GSTBatch], Any], *, depth: int = 2):
    if kind == "async":
        return AsyncSegmentFeeder(ds, id_schedule, put_fn, depth=depth)
    if kind == "sync":
        return SyncSegmentFeeder(ds, id_schedule, put_fn)
    raise ValueError(f"unknown feeder kind {kind!r}")


# ---------------------------------------------------------------------------
# the prefetch lane (lookahead lookup dispatch)
# ---------------------------------------------------------------------------


class PrefetchLane:
    """A one-item lookahead over a feeder that calls ``dispatch_fn(item)``
    exactly once per item, at pull time: for item k+1 right BEFORE the
    training loop runs step k, so the lookup it issues
    (``dist/train.py::make_prefetch_lookup``) is enqueued ahead of the step
    that writes the table in place.  The JAX lane relies on the same
    dispatch order, with the table donated (``src/repro/dist/pipeline.py:
    273-346``); here stream order alone keeps the lookup before the write.
    The dispatch is also where the next item's store migration is
    committed (the lookup must read the committed table).

    Yields ``(item, handle, next_item, next_handle)``: the current item,
    what ``dispatch_fn`` returned for it (the loop reads it for the
    first item only; later the step's patched buffer takes its place) and
    the next pair, ``None``/``None`` on the last item.

    A ``dispatch_fn`` error (or an abandoned iteration) closes the wrapped
    feeder before the exception surfaces, so its producer thread never
    blocks on a dead consumer.  ``feeder.prefetch_batches`` and
    ``feeder.prefetch_dispatch_ms`` go to the metrics registry, the span
    ``feeder.prefetch_dispatch`` to the tracer."""

    def __init__(self, feeder, dispatch_fn: Callable[[Any], Any]):
        self._feeder = feeder
        self._dispatch = dispatch_fn
        self.prefetch_batches = 0
        self.dispatch_ms = 0.0

    @property
    def stats(self) -> FeederStats:
        return self._feeder.stats

    def _dispatch_timed(self, item):
        t0 = time.perf_counter()
        with span("feeder.prefetch_dispatch"):
            handle = self._dispatch(item)
        dt = (time.perf_counter() - t0) * 1e3
        self.prefetch_batches += 1
        self.dispatch_ms += dt
        reg = get_registry()
        reg.inc("feeder.prefetch_batches")
        reg.inc("feeder.prefetch_dispatch_ms", dt, unit="ms")
        return handle

    def close(self) -> None:
        close = getattr(self._feeder, "close", None)
        if close is not None:
            close()

    def __iter__(self):
        it = iter(self._feeder)
        try:
            try:
                cur = next(it)
            except StopIteration:
                return
            cur_h = self._dispatch_timed(cur)
            while True:
                try:
                    nxt = next(it)
                except StopIteration:
                    nxt, nxt_h = None, None
                else:
                    nxt_h = self._dispatch_timed(nxt)
                yield cur, cur_h, nxt, nxt_h
                if nxt is None:
                    return
                cur, cur_h = nxt, nxt_h
        finally:
            self.close()
