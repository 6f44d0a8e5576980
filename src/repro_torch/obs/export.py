"""Telemetry export of the port: periodic JSONL event log, final summaries,
CLI glue.

Counterpart of ``src/repro/obs/export.py`` without the memory probe
(ROADMAP A3b): the same flags, stream schema and lifecycle, so the JAX
package's gate reads a stream the port writes unchanged.  The three graph
CLIs (launch/train.py, launch/train_dist.py, launch/serve_graphs.py)
share one flag set (``add_obs_args``) and one lifecycle object
(:class:`Obs`):

    add_obs_args(ap)
    args = ap.parse_args()
    obs = Obs.from_args(args)          # installs registry + tracer globals
    ...
    obs.tick(step=..., epoch=...)      # JSONL line: per-interval deltas
    ...
    summary = obs.close(run_meta)      # summary JSONL line + trace export

JSONL stream format (one JSON object per line):

    {"type": "meta", "wall_time": ..., "argv": ..., **run_meta}
    {"type": "tick", "step": N, "wall_s": ..., "delta": {name: change},
     **extra}                          # delta() since the previous tick
    {"type": "event", "event": "...", **payload}
    {"type": "summary", "wall_s": ..., "metrics": {name: value|summary},
     **extra}                          # cumulative, report-grade

The gate (``python -m repro_torch.obs.gate``, or the JAX package's)
asserts SLOs against the same stream.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import (MetricsRegistry, null_registry,
                                     set_registry)
from repro_torch.obs.trace import Tracer, null_tracer, set_tracer


def add_obs_args(ap) -> None:
    """The shared observability flag set (no-cost defaults: everything
    off)."""
    g = ap.add_argument_group("observability (repro_torch.obs)")
    g.add_argument("--metrics", action="store_true",
                   help="enable the process-wide metrics registry "
                        "(store/exchange/feeder/serve counters, staleness "
                        "histograms) and print its summary at the end; "
                        "off = null registry, zero overhead")
    g.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the JSONL telemetry stream (per-interval "
                        "ticks + final summary) here; implies --metrics")
    g.add_argument("--metrics-interval", type=int, default=1,
                   help="emit a JSONL tick every N intervals (epochs of "
                        "the graph and distributed trainers, --log-every "
                        "steps of the seq and lm tracks, windows of the "
                        "serve replay); needs --metrics-out")
    g.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record spans (train step, feeder, write-back "
                        "lane, serve request path) and write a Chrome-"
                        "trace JSON here (chrome://tracing / Perfetto)")
    g.add_argument("--torch-trace-annotations", action="store_true",
                   help="also enter torch.profiler.record_function for "
                        "each span, so span names show up as ranges in a "
                        "torch.profiler trace; needs --trace-out")
    g.add_argument("--mem-probe", action="store_true",
                   help="per-site device memory records: not ported yet "
                        "(ROADMAP A3b); raises NotImplementedError")


class JsonlExporter:
    """Append-only JSONL event stream over one registry."""

    def __init__(self, path: str, registry: MetricsRegistry):
        self.path = path
        self.registry = registry
        self._f = open(path, "w")
        self._t0 = time.perf_counter()
        self._n_ticks = 0

    def _emit(self, obj: Dict) -> None:
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def meta(self, **run_meta) -> None:
        self._emit({"type": "meta", "wall_time": time.time(),
                    "argv": sys.argv, **run_meta})

    def tick(self, step: Optional[int] = None, **extra) -> Dict:
        """One per-interval line: the registry's delta() since the last
        tick (per-interval rates) plus any extras (epoch number, loss,
        staleness summary...)."""
        self._n_ticks += 1
        rec = {"type": "tick",
               "wall_s": round(time.perf_counter() - self._t0, 6)}
        if step is not None:
            rec["step"] = int(step)
        rec["delta"] = _jsonable(self.registry.delta())
        rec.update(_jsonable(extra))
        self._emit(rec)
        return rec

    def event(self, event: str, **payload) -> None:
        self._emit({"type": "event", "event": event,
                    "wall_s": round(time.perf_counter() - self._t0, 6),
                    **_jsonable(payload)})

    def summary(self, **extra) -> Dict:
        rec = {"type": "summary",
               "wall_s": round(time.perf_counter() - self._t0, 6),
               "n_ticks": self._n_ticks,
               "metrics": _jsonable(self.registry.summary())}
        rec.update(_jsonable(extra))
        self._emit(rec)
        return rec

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _jsonable(obj):
    """Round-trip-safe coercion (numpy and torch scalars and arrays ->
    python; a tensor is copied to the host, a 0-d one is a scalar)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()   # a 0-d tensor -> its scalar
    if isinstance(obj, float) and (obj != obj or obj in (float("inf"),
                                                         float("-inf"))):
        return None
    return obj


def summary_lines(rec: Dict):
    """A summary record as printable lines, one a metric (a histogram by
    its count, p50 and p99)."""
    out = []
    for name, v in sorted(rec["metrics"].items()):
        if isinstance(v, dict):
            v = (f"count {v['count']} p50 {v['p50']:.6g} "
                 f"p99 {v['p99']:.6g}")
        out.append(f"[obs] {name} {v}")
    return out


class Obs:
    """One run's telemetry bundle: registry + tracer + JSONL exporter,
    installed process-wide on construction so every subsystem (store,
    exchange, feeders, serve engine) publishes without plumbing."""

    def __init__(self, *, metrics: bool = False,
                 metrics_out: Optional[str] = None,
                 trace_out: Optional[str] = None,
                 metrics_interval: int = 1,
                 annotations: bool = False,
                 mem_probe: bool = False,
                 install: bool = True):
        if mem_probe:
            raise NotImplementedError(
                "--mem-probe is not ported yet: the port's per-site device "
                "memory records are ROADMAP A3b")
        if int(metrics_interval) != 1 and not metrics_out:
            raise ValueError("--metrics-interval spaces the ticks "
                             "--metrics-out writes: pass --metrics-out too")
        if annotations and not trace_out:
            raise ValueError("--torch-trace-annotations enters "
                             "record_function in the spans --trace-out "
                             "records: pass --trace-out too")
        self.enabled = bool(metrics or metrics_out)
        self.trace_out = trace_out
        self.interval = int(metrics_interval)
        if self.interval < 1:
            raise ValueError(f"--metrics-interval {self.interval} < 1")
        self.registry = MetricsRegistry() if self.enabled else null_registry()
        self.tracer = (Tracer(annotations=annotations)
                       if trace_out else null_tracer())
        self.exporter = (JsonlExporter(metrics_out, self.registry)
                         if metrics_out else None)
        self._prev_registry = None
        self._prev_tracer = None
        self._installed = False
        self._closed = False
        if install:
            self.install()

    @classmethod
    def from_args(cls, args, **run_meta) -> "Obs":
        obs = cls(metrics=getattr(args, "metrics", False),
                  metrics_out=getattr(args, "metrics_out", None),
                  trace_out=getattr(args, "trace_out", None),
                  metrics_interval=getattr(args, "metrics_interval", 1),
                  annotations=getattr(args, "torch_trace_annotations", False),
                  mem_probe=getattr(args, "mem_probe", False))
        if obs.exporter is not None:
            obs.exporter.meta(**run_meta)
        return obs

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "Obs":
        if not self._installed:
            self._prev_registry = set_registry(self.registry)
            self._prev_tracer = set_tracer(self.tracer)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            set_registry(self._prev_registry or null_registry())
            set_tracer(self._prev_tracer or null_tracer())
            self._installed = False

    def __enter__(self) -> "Obs":
        return self.install()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- recording ---------------------------------------------------------

    def should_tick(self, interval_index: int) -> bool:
        return self.exporter is not None and \
            interval_index % self.interval == 0

    def tick(self, step: Optional[int] = None, **extra) -> Optional[Dict]:
        if self.exporter is None:
            return None
        return self.exporter.tick(step=step, **extra)

    def event(self, event: str, **payload) -> None:
        if self.exporter is not None:
            self.exporter.event(event, **payload)

    def summary(self, **extra) -> Dict:
        """Cumulative report-grade dict (registry summary + extras); does
        NOT close anything."""
        return {"metrics": _jsonable(self.registry.summary()),
                **_jsonable(extra)}

    def close(self, **summary_extra) -> Optional[Dict]:
        """Final summary JSONL line, trace export, uninstall.  Returns the
        summary record (None when telemetry was fully disabled)."""
        if self._closed:
            return None
        self._closed = True
        rec = None
        if self.exporter is not None:
            rec = self.exporter.summary(**summary_extra)
            self.exporter.close()
        elif self.enabled:
            rec = {"type": "summary",
                   "metrics": _jsonable(self.registry.summary()),
                   **_jsonable(summary_extra)}
        if self.trace_out and len(self.tracer):
            self.tracer.export(self.trace_out)
        self.uninstall()
        return rec
