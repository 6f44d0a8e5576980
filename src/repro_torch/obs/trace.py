"""Span tracing of the port -> Chrome-trace JSON (chrome://tracing, Perfetto).

Counterpart of ``src/repro/obs/trace.py``, with the same span names and
event format.  One tracer covers every thread of a run: the consumer's
train step and store commits, the feeder thread's batch assembly and
copies, the AsyncHostWriter's eviction write-backs, and the serve request
path (window -> partition -> bucket encode -> cache insert -> gather ->
head).  Spans are recorded as *complete* ("X") events — one event per
finished span with ``ts``/``dur`` in microseconds on a single monotonic
clock — which both viewers load directly and which keeps the in-memory
form one dict per span.

Like the metrics registry, tracing is host-side only: a span around a
launch measures its dispatch, not the card, and the disabled path is
free: the module-global tracer defaults to :class:`NullTracer`, whose
``span()`` returns one shared reusable no-op context manager.

``annotations=True`` additionally enters
``torch.profiler.record_function(name)`` for every span, so the same span
names show up as ranges inside a ``torch.profiler`` trace of the card.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch


class _NullSpan:
    """Reusable no-op context manager (the disabled-tracing path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0
        self._range = None

    def __enter__(self):
        if self._tracer._annotations:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tracer._record(self.name, self._t0, t1, self.args)
        return False


class Tracer:
    """Collects spans from any thread; ``export()`` writes Chrome JSON."""

    enabled = True

    def __init__(self, *, annotations: bool = False):
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self._thread_names: Dict[int, str] = {}
        self._annotations = annotations
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """``with tracer.span("train.step", epoch=3): ...`` — records one
        complete event when the block exits (exception included, so a
        failing step still shows its span)."""
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (epoch boundaries, flushes)."""
        ts = (time.perf_counter_ns() - self._epoch_ns) // 1000
        self._append({"name": name, "ph": "i", "s": "t", "ts": ts,
                      **self._ids(), **({"args": args} if args else {})})

    def counter(self, name: str, **values) -> None:
        """Chrome "C" counter event: each kwarg is one numeric series under
        ``name``, rendered by the viewers as a timeline counter track —
        queue depths, occupancy, live bytes.  Only
        numeric values are recorded; at least one is required."""
        series = {k: float(v) for k, v in values.items()
                  if isinstance(v, (int, float)) and not isinstance(v, bool)}
        if not series:
            raise ValueError(f"counter {name!r} needs at least one numeric "
                             f"series (got {sorted(values)})")
        ts = (time.perf_counter_ns() - self._epoch_ns) // 1000
        self._append({"name": name, "ph": "C", "ts": ts, **self._ids(),
                      "args": series})

    def _record(self, name: str, t0_ns: int, t1_ns: int,
                args: Optional[Dict]) -> None:
        ev = {"name": name, "ph": "X",
              "ts": (t0_ns - self._epoch_ns) // 1000,
              "dur": max((t1_ns - t0_ns) // 1000, 1),
              **self._ids()}
        if args:
            ev["args"] = args
        self._append(ev)

    def _ids(self) -> Dict:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._thread_names:
            with self._lock:
                self._thread_names.setdefault(tid, t.name)
        return {"pid": self._pid, "tid": tid}

    def _append(self, ev: Dict) -> None:
        with self._lock:
            self._events.append(ev)

    # -- views / export ----------------------------------------------------

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # export order at equal ts: spans before counters before instants, and
    # longer spans (parents) before shorter ones — spans are appended at
    # EXIT while counters are appended live, so raw append order from
    # multiple threads interleaves them nondeterministically
    _PH_ORDER = {"X": 0, "C": 1, "i": 2, "I": 2}

    def export(self, path: str) -> str:
        """Write ``{"traceEvents": [...]}`` Chrome/Perfetto JSON: the
        recorded spans plus one thread-name metadata event per thread
        seen, sorted on a total deterministic key (ts, phase, -dur, tid)
        so the stream is ts-monotonic — and stable across reruns — even
        when counter and span events interleave from multiple threads."""
        with self._lock:
            events = sorted(
                self._events,
                key=lambda e: (e["ts"], self._PH_ORDER.get(e["ph"], 3),
                               -e.get("dur", 0), e.get("tid", 0)))
            names = dict(self._thread_names)
        meta = [{"name": "thread_name", "ph": "M", "pid": self._pid,
                 "tid": tid, "args": {"name": tname}}
                for tid, tname in sorted(names.items())]
        payload = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)
            f.write("\n")
        return path


class NullTracer:
    """The disabled path: span() hands back one shared no-op context."""

    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def events(self) -> List[Dict]:
        return []

    def __len__(self) -> int:
        return 0

    def export(self, path: str) -> str:
        raise RuntimeError("NullTracer has nothing to export — enable "
                           "tracing (--trace-out) first")


_NULL_TRACER = NullTracer()
_tracer = _NULL_TRACER


def get_tracer():
    return _tracer


def set_tracer(tracer) -> object:
    """Install ``tracer`` process-wide; returns the previous tracer."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def null_tracer() -> NullTracer:
    return _NULL_TRACER


def span(name: str, **args):
    """``with span("serve.encode", bucket=2): ...`` against the current
    process-wide tracer — the one-liner instrumented code uses."""
    return _tracer.span(name, **args)


def instant(name: str, **args) -> None:
    _tracer.instant(name, **args)


def counter(name: str, **values) -> None:
    """``counter("mem.device_bytes", train_step=4.2e5)`` against the
    current process-wide tracer (no-op on the NullTracer)."""
    _tracer.counter(name, **values)


def validate_chrome_trace(payload: Dict) -> List[str]:
    """Structural checks a Chrome-trace consumer relies on; returns a list
    of problems (empty = valid).  Used by tests and the CI obs gate."""
    problems: List[str] = []
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    begins: Dict = {}
    last_ts = None
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), int) or ev["ts"] < 0:
            problems.append(f"event {i}: bad ts {ev.get('ts')!r}")
            continue
        if last_ts is not None and ev["ts"] < last_ts:
            problems.append(f"event {i}: ts not monotonic ({ev['ts']} < {last_ts})")
        last_ts = ev["ts"]
        if ph == "X":
            if not isinstance(ev.get("dur"), int) or ev["dur"] < 0:
                problems.append(f"event {i}: X event with bad dur")
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                problems.append(f"event {i}: C event without args series")
            elif not all(isinstance(v, (int, float))
                         and not isinstance(v, bool)
                         for v in args.values()):
                problems.append(f"event {i}: C event with non-numeric "
                                "series values")
        elif ph == "B":
            begins.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
        elif ph == "E":
            stack = begins.get((ev.get("pid"), ev.get("tid")), [])
            if not stack:
                problems.append(f"event {i}: E without matching B")
            else:
                stack.pop()
        elif ph not in ("i", "I"):
            problems.append(f"event {i}: unsupported phase {ph!r}")
        if ph != "M" and ("pid" not in ev or "tid" not in ev):
            problems.append(f"event {i}: missing pid/tid")
    for key, stack in begins.items():
        if stack:
            problems.append(f"{len(stack)} unmatched B events on {key}")
    return problems
