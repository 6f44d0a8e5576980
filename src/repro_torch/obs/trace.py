"""Span tracing of the port -> Chrome-trace JSON (chrome://tracing, Perfetto).

Counterpart of ``src/repro/obs/trace.py``, cut to the spans the serving
engine records (``serve.window`` -> ``serve.partition`` -> ``serve.encode`` ->
``serve.insert`` -> ``serve.gather`` -> ``serve.head``).  Spans are complete
("X") events with ``ts``/``dur`` in microseconds on one monotonic clock.
Host-side only: a span around a launch measures its dispatch, not the
card.  The disabled path is free: the process-wide tracer defaults to
:class:`NullTracer`, whose ``span()`` returns one shared no-op context.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _NullSpan:
    """Reusable no-op context manager (the disabled-tracing path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tracer._record(self.name, self._t0, time.perf_counter_ns(),
                             self.args)
        return False


class Tracer:
    """Collects spans from any thread; ``export()`` writes Chrome JSON."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def _record(self, name: str, t0_ns: int, t1_ns: int,
                args: Optional[Dict]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0_ns - self._epoch_ns) // 1000,
              "dur": max((t1_ns - t0_ns) // 1000, 1),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def export(self, path: str) -> str:
        """Write ``{"traceEvents": [...]}``, sorted by (ts, -dur) so that
        parents precede their children."""
        with self._lock:
            events = sorted(self._events, key=lambda e: (e["ts"], -e["dur"]))
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
            f.write("\n")
        return path


class NullTracer:
    """The disabled path: span() hands back one shared no-op context."""

    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def events(self) -> List[Dict]:
        return []


_tracer = NullTracer()


def set_tracer(tracer) -> object:
    """Install ``tracer`` process-wide; returns the previous tracer."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def span(name: str, **args):
    """``with span("serve.encode", bucket=2): ...`` against the current
    process-wide tracer."""
    return _tracer.span(name, **args)
