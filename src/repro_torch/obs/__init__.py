"""repro_torch.obs — the port's telemetry spine: metrics registry, span
tracing, staleness observability, JSONL/trace export and the gate.

Counterpart of ``src/repro/obs/`` with the same names, stream schema and
gate verdicts; the memory probe (``--mem-probe``) is ROADMAP A3b.  Import
surface kept flat so instrumented code needs only::

    from repro_torch.obs import get_registry, span

and CLIs only::

    from repro_torch.obs import Obs, add_obs_args
"""
from repro_torch.obs.metrics import (AGE_BUCKETS_STEPS, BYTES_BUCKETS,
                                     Counter, Gauge, Histogram,
                                     LATENCY_BUCKETS_MS, MetricsRegistry,
                                     NullRegistry, dict_delta, enable_metrics,
                                     exponential_buckets, get_registry,
                                     null_registry, set_registry, summarize)
from repro_torch.obs.trace import (NullTracer, Tracer, counter, get_tracer,
                                   instant, null_tracer, set_tracer, span,
                                   validate_chrome_trace)
from repro_torch.obs.staleness import (StalenessProbe, record_exchange_bytes,
                                       record_prefetch_exchange,
                                       sed_age_bound, sed_drop_stats,
                                       wb_skip_rate)
from repro_torch.obs.export import JsonlExporter, Obs, add_obs_args

__all__ = [
    "AGE_BUCKETS_STEPS", "BYTES_BUCKETS", "LATENCY_BUCKETS_MS",
    "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NullRegistry",
    "dict_delta", "enable_metrics", "exponential_buckets",
    "get_registry", "null_registry", "set_registry", "summarize",
    "NullTracer", "Tracer", "counter", "get_tracer", "instant",
    "null_tracer", "set_tracer", "span", "validate_chrome_trace",
    "StalenessProbe", "record_exchange_bytes", "record_prefetch_exchange",
    "sed_age_bound", "sed_drop_stats", "wb_skip_rate",
    "JsonlExporter", "Obs", "add_obs_args",
]
