"""Process-wide metrics registry of the port: counters, gauges and
fixed-bucket histograms.

Counterpart of ``src/repro/obs/metrics.py``, with the same names, units,
buckets and summaries, so a stream the port writes reads like the JAX
package's.  One telemetry spine for every subsystem: the store, the
exchange, the feeders and the serve engine all publish through ONE
registry under hierarchical dotted names (``store.faults``,
``exchange.bytes.ring.f32``, ``serve.latency_ms``), so a run's residency
traffic, wire bytes and latency distributions come out of a single
``snapshot()``.

Design rules:

* **Host-side only.**  Instrumented code records host values it already
  holds (counts, host clocks) around the steps; what has to read the
  device (the staleness probe's ages) runs only while a live registry is
  installed, once an epoch or a window, so telemetry changes no step.
* **The disabled path is a no-op.**  The module-global registry defaults
  to :class:`NullRegistry`, whose record methods are empty and whose
  metric handles are shared no-op singletons — code can call
  ``get_registry().inc("store.faults")`` unconditionally.
* **Thread-safe.**  The store's begin() runs on the feeder thread,
  write-backs land on the AsyncHostWriter thread, and the consumer reads
  snapshots — every mutation takes the registry's lock (one lock: these
  are per-batch events, not per-element ones).
* **Cumulative counters + ``delta()``.**  Counters never self-reset;
  per-interval rates (a per-epoch fault count, a per-window hit-rate)
  come from ``delta()``, which diffs against the previous ``delta()``
  call.

``summarize()`` is the one percentile/latency-summary implementation: it
accepts a :class:`Histogram` (p50/p99 interpolated from the buckets —
O(buckets) memory no matter how long the replay) or a plain value
sequence.
"""
from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# bucket ladders
# ---------------------------------------------------------------------------


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` upper bounds start, start*factor, ... (an implicit +inf
    overflow bucket always follows)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# 0.1 ms .. ~52 s in x2 steps
LATENCY_BUCKETS_MS = exponential_buckets(0.1, 2.0, 20)
# 1 .. ~5e5 steps in x2 steps — row ages / prediction staleness in steps
AGE_BUCKETS_STEPS = exponential_buckets(1.0, 2.0, 20)
BYTES_BUCKETS = exponential_buckets(64.0, 4.0, 16)


# ---------------------------------------------------------------------------
# metric kinds
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic cumulative count (events, rows, bytes, milliseconds)."""

    __slots__ = ("name", "unit", "_lock", "_value")
    kind = "counter"

    def __init__(self, name: str, unit: str = "", lock: Optional[threading.Lock] = None):
        self.name = name
        self.unit = unit
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict:
        return {"type": self.kind, "unit": self.unit, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (occupancy, queue depth)."""

    __slots__ = ("name", "unit", "_lock", "_value")
    kind = "gauge"

    def __init__(self, name: str, unit: str = "", lock: Optional[threading.Lock] = None):
        self.name = name
        self.unit = unit
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict:
        return {"type": self.kind, "unit": self.unit, "value": self.value}


class Histogram:
    """Fixed-bucket distribution: O(len(buckets)) memory however many
    observations land — the replacement for unbounded per-event lists.

    ``buckets`` are ascending upper bounds; an overflow bucket is
    implicit.  Percentiles interpolate linearly inside a bucket (the
    first bucket's lower edge is the observed min, the overflow bucket's
    upper edge the observed max), so ``percentile`` is exact at the
    bucket resolution.
    """

    __slots__ = ("name", "unit", "buckets", "_lock", "counts", "_count",
                 "_sum", "_min", "_max")
    kind = "histogram"

    def __init__(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                 unit: str = "", lock: Optional[threading.Lock] = None):
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(set(bs)):
            raise ValueError(f"buckets must be strictly ascending: {bs}")
        self.name = name
        self.unit = unit
        self.buckets = bs
        self._lock = lock or threading.Lock()
        self.counts = [0] * (len(bs) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values) -> None:
        """Vectorized observe for array-sized recordings (row-age sweeps)."""
        arr = np.asarray(values, np.float64).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(self.buckets, arr, side="left")
        binned = np.bincount(idx, minlength=len(self.counts))
        with self._lock:
            for i, c in enumerate(binned):
                self.counts[i] += int(c)
            self._count += arr.size
            self._sum += float(arr.sum())
            self._min = min(self._min, float(arr.min()))
            self._max = max(self._max, float(arr.max()))

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100]; linear interpolation within the target bucket."""
        with self._lock:
            counts = list(self.counts)
            total, lo, hi = self._count, self._min, self._max
        if total == 0:
            return 0.0
        target = (q / 100.0) * total
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= target:
                lower = self.buckets[i - 1] if i > 0 else lo
                upper = self.buckets[i] if i < len(self.buckets) else hi
                lower = max(lower, lo)
                upper = min(upper, hi) if hi >= lower else lower
                frac = (target - seen) / c
                return float(lower + (upper - lower) * min(max(frac, 0.0), 1.0))
            seen += c
        return float(hi)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "type": self.kind, "unit": self.unit,
                "buckets": list(self.buckets), "counts": list(self.counts),
                "count": self._count, "sum": self._sum,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
            }


Metric = Union[Counter, Gauge, Histogram]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Get-or-create metric handles by dotted name + snapshot/delta/reset."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self._delta_mark: Dict[str, float] = {}

    # -- handles -----------------------------------------------------------

    def _get_or_create(self, name: str, cls, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get_or_create(name, Counter, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, unit=unit)

    def histogram(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                  unit: str = "") -> Histogram:
        return self._get_or_create(name, Histogram, buckets=buckets, unit=unit)

    # -- convenience recorders (the null registry overrides these) ---------

    def inc(self, name: str, v: float = 1.0, unit: str = "") -> None:
        self.counter(name, unit=unit).inc(v)

    def set(self, name: str, v: float, unit: str = "") -> None:
        self.gauge(name, unit=unit).set(v)

    def observe(self, name: str, v: float,
                buckets: Sequence[float] = LATENCY_BUCKETS_MS,
                unit: str = "") -> None:
        self.histogram(name, buckets=buckets, unit=unit).observe(v)

    # -- views -------------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            metrics = dict(self._metrics)
        return {name: m.snapshot() for name, m in sorted(metrics.items())}

    def delta(self) -> Dict[str, float]:
        """Per-interval change since the PREVIOUS delta() call: counters
        diff their cumulative value, histograms diff their observation
        count (``<name>.count``) and sum (``<name>.sum``), gauges report
        their current value.  This is the primitive every per-epoch /
        per-window rate print goes through — cumulative counters stop
        masquerading as rates."""
        out: Dict[str, float] = {}
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in sorted(metrics.items()):
            if isinstance(m, Counter):
                cur = m.value
                out[name] = cur - self._delta_mark.get(name, 0.0)
                self._delta_mark[name] = cur
            elif isinstance(m, Gauge):
                out[name] = m.value
            else:
                snap = m.snapshot()
                for part in ("count", "sum"):
                    key = f"{name}.{part}"
                    cur = float(snap[part])
                    out[key] = cur - self._delta_mark.get(key, 0.0)
                    self._delta_mark[key] = cur
        return out

    def reset(self) -> None:
        """Drop every metric AND the delta marks (a fresh run phase)."""
        with self._lock:
            self._metrics.clear()
            self._delta_mark.clear()

    def summary(self) -> Dict[str, object]:
        """Flat report-grade dict: counters/gauges -> value, histograms ->
        summarize() dict.  This is what the BENCH_*.json writers merge."""
        out: Dict[str, object] = {}
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in sorted(metrics.items()):
            out[name] = summarize(m) if isinstance(m, Histogram) else m.value
        return out


class _NullMetric:
    """Shared do-nothing handle: inc/set/observe all no-ops, reads zero."""

    __slots__ = ()
    name = ""
    unit = ""
    value = 0.0
    count = 0
    mean = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def snapshot(self) -> Dict:
        return {}


_NULL_METRIC = _NullMetric()


class NullRegistry(MetricsRegistry):
    """The disabled path: every handle is the shared no-op singleton and
    every recorder is an empty method — instrumented code pays one Python
    call, no allocation, no locking."""

    enabled = False

    def __init__(self):
        pass  # no lock, no dicts — nothing to mutate

    def counter(self, name: str, unit: str = ""):
        return _NULL_METRIC

    def gauge(self, name: str, unit: str = ""):
        return _NULL_METRIC

    def histogram(self, name: str, buckets=LATENCY_BUCKETS_MS, unit: str = ""):
        return _NULL_METRIC

    def inc(self, name: str, v: float = 1.0, unit: str = "") -> None:
        pass

    def set(self, name: str, v: float, unit: str = "") -> None:
        pass

    def observe(self, name: str, v: float, buckets=LATENCY_BUCKETS_MS,
                unit: str = "") -> None:
        pass

    def names(self) -> List[str]:
        return []

    def get(self, name: str):
        return None

    def snapshot(self) -> Dict[str, Dict]:
        return {}

    def delta(self) -> Dict[str, float]:
        return {}

    def reset(self) -> None:
        pass

    def summary(self) -> Dict[str, object]:
        return {}


_NULL_REGISTRY = NullRegistry()
_registry: MetricsRegistry = _NULL_REGISTRY


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem publishes to (a
    NullRegistry until someone enables metrics)."""
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the process-wide registry; returns the
    previous one so callers (tests, benches) can restore it."""
    global _registry
    prev = _registry
    _registry = registry
    return prev


def null_registry() -> NullRegistry:
    return _NULL_REGISTRY


def enable_metrics() -> MetricsRegistry:
    """Install and return a fresh live registry (the --metrics path)."""
    reg = MetricsRegistry()
    set_registry(reg)
    return reg


# ---------------------------------------------------------------------------
# the one latency/percentile summary implementation
# ---------------------------------------------------------------------------


def summarize(data: Union[Histogram, Iterable[float]],
              percentiles: Sequence[float] = (50, 99)) -> Dict[str, float]:
    """count/mean/min/max + requested percentiles, from a Histogram
    (bucket-interpolated — constant memory) or a raw value sequence
    (exact).  Keys: ``count, mean, min, max, p50, p99, ...``."""
    if isinstance(data, (Histogram, _NullMetric)):
        if isinstance(data, _NullMetric) or data.count == 0:
            base = {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0}
            base.update({f"p{_fmt_q(q)}": 0.0 for q in percentiles})
            return base
        snap = data.snapshot()
        out = {"count": snap["count"], "mean": snap["sum"] / snap["count"],
               "min": snap["min"], "max": snap["max"]}
        for q in percentiles:
            out[f"p{_fmt_q(q)}"] = data.percentile(q)
        return out
    arr = np.asarray(list(data), np.float64)
    if arr.size == 0:
        base = {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0}
        base.update({f"p{_fmt_q(q)}": 0.0 for q in percentiles})
        return base
    out = {"count": int(arr.size), "mean": float(arr.mean()),
           "min": float(arr.min()), "max": float(arr.max())}
    for q in percentiles:
        out[f"p{_fmt_q(q)}"] = float(np.percentile(arr, q))
    return out


def _fmt_q(q: float) -> str:
    return str(int(q)) if float(q).is_integer() else str(q).replace(".", "_")


def dict_delta(cur: Dict, prev: Optional[Dict]) -> Dict:
    """Numeric diff of two flat stat dicts (non-numeric keys pass through
    from ``cur``) — the per-interval view of a cumulative counter dict,
    for code still reading the legacy dict accessors."""
    if prev is None:
        return dict(cur)
    out = {}
    for k, v in cur.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            out[k] = v
        else:
            p = prev.get(k, 0)
            out[k] = v - p if isinstance(p, (int, float)) else v
    return out
