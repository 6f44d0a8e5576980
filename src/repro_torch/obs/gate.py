"""Observability gate of the port: assert SLOs against a run's telemetry
stream.

A whole copy of ``src/repro/obs/gate.py`` (the same checks, messages and
exit codes), so a stream is judged alike by either package's gate and
the card, which has no JAX, can gate the port's own runs.  Reads the
JSONL stream(s) written via ``--metrics-out`` and the Chrome trace(s)
written via ``--trace-out`` and fails (exit 1) when a budget is blown,
so perf/staleness regressions fail a check instead of silently shifting
BENCH_*.json.  Usage:

    python -m repro_torch.obs.gate \\
        --train-jsonl obs_train.jsonl --j-max 8 --num-sampled 2 \\
        --steps-per-epoch 16 \\
        --serve-jsonl obs_serve.jsonl --serve-p99-ms 2000 \\
        --max-encode-launches 64 \\
        --trace obs_train_trace.json --trace obs_serve_trace.json

Checks:
  * every JSONL stream parses, ends with a ``summary`` record, and that
    summary carries the required metric families;
  * serve: ``serve.latency_ms`` p99 <= --serve-p99-ms and
    ``serve.encode_launches`` <= --max-encode-launches; nonzero
    ``serve.bucket.truncated_*`` counters fail unless --allow-truncation;
  * train: ``staleness.row_age`` p99 <= the SED-implied bound
    (:func:`repro_torch.obs.staleness.sed_age_bound` over the run geometry);
    --effective-age-below-row-age additionally requires the weighted/
    forecast run's ``staleness.effective_age`` p99 strictly below the
    row-age p99 (of --baseline-jsonl when given, else the same stream);
  * every trace passes :func:`repro_torch.obs.trace.validate_chrome_trace`;
  * memory (``--memory-json``, a ``gst_memory`` file of the sweep,
    ``python -m repro_torch.obs.memory_sweep``, or of the reference's
    ``benchmarks/bench_memory.py``): the GST train-step temp bytes stay
    flat while graph size grows (max/min ratio <= 1 + --mem-epsilon), the
    full-graph control actually grows (>= --mem-growth-floor, proving the
    sweep has teeth), the streaming-encoder temp is chunk-count-independent
    (ratio <= 1 + --stream-epsilon) and >= its accounting bound (the
    largest single buffer), and the serve bucket-ladder total peak fits
    --ladder-budget-bytes when given.  ``--expect-mem`` additionally
    requires the ``mem.device.*`` gauge families in the train stream
    (the --mem-probe wiring canary; ``obs/memory.py`` writes them).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from repro_torch.obs.staleness import sed_age_bound
from repro_torch.obs.trace import validate_chrome_trace

# single-device train runs (launch/train.py) publish the staleness
# families but have no exchange and no write-back gate; the dist extras
# are required when the stream actually came from a dist run (any
# exchange.* metric present) or when --expect-dist pins them explicitly.
TRAIN_FAMILIES = ("staleness.row_age", "staleness.sed_drop_rate")
DIST_FAMILIES = ("store.wb_skip_rate", "exchange.bytes.")
# required when the stream advertises the prefetch lane (any
# exchange.prefetch.* metric present) or --expect-prefetch pins them
PREFETCH_FAMILIES = ("exchange.prefetch.bytes.",
                     "exchange.prefetch.patched_rows")
MEM_FAMILIES = ("mem.device.peak_bytes.", "mem.device.temp_bytes.")
SERVE_FAMILIES = ("serve.latency_ms", "serve.prediction_staleness",
                  "serve.windows")


class GateFailure(Exception):
    pass


def load_jsonl(path: str) -> List[Dict]:
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise GateFailure(f"{path}:{i + 1}: bad JSONL line: {e}")
    if not records:
        raise GateFailure(f"{path}: empty telemetry stream")
    return records


def final_summary(records: List[Dict], path: str) -> Dict:
    summaries = [r for r in records if r.get("type") == "summary"]
    if not summaries:
        raise GateFailure(f"{path}: no summary record (run did not close "
                          "its Obs bundle)")
    return summaries[-1]


def require_families(summary: Dict, families, path: str) -> List[str]:
    metrics = summary.get("metrics", {})
    missing = [fam for fam in families
               if not any(name == fam or
                          (fam.endswith(".") and name.startswith(fam))
                          for name in metrics)]
    if missing:
        raise GateFailure(f"{path}: summary missing metric families: "
                          f"{', '.join(missing)}")
    return sorted(metrics)


def metric_value(summary: Dict, name: str, field: Optional[str],
                 path: str) -> float:
    metrics = summary.get("metrics", {})
    if name not in metrics:
        raise GateFailure(f"{path}: metric {name!r} absent from summary")
    val = metrics[name]
    if isinstance(val, dict):
        if field is None or field not in val:
            raise GateFailure(f"{path}: metric {name!r} has no "
                              f"field {field!r} (has {sorted(val)})")
        val = val[field]
    if val is None:
        raise GateFailure(f"{path}: metric {name!r}.{field} is null "
                          "(no observations)")
    return float(val)


def check_memory_json(path: str, *, mem_epsilon: float,
                      stream_epsilon: float, growth_floor: float,
                      ladder_budget: Optional[float]) -> List[str]:
    """Assert the constant-memory claims against one bench_memory.py file
    (every tracked run config in it must pass)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("benchmark") != "gst_memory":
        raise GateFailure(f"{path}: not a gst_memory benchmark file "
                          f"(benchmark={payload.get('benchmark')!r})")
    runs = payload.get("runs") or {}
    if not runs:
        raise GateFailure(f"{path}: no tracked runs")
    lines = []
    for run_key, entry in sorted(runs.items()):
        s = entry.get("summary", {})
        where = f"{path} [{run_key}]"

        def summary_ratio(name: str) -> float:
            v = s.get(name)
            if v is None:
                raise GateFailure(f"{where}: summary missing {name!r}")
            return float(v)

        gst = summary_ratio("gst_temp_ratio_max_over_min")
        if gst > 1.0 + mem_epsilon:
            raise GateFailure(
                f"{where}: GST train-step temp bytes grew {gst:.3f}x across "
                f"the graph-size sweep (budget {1 + mem_epsilon:.3f}x) — "
                "the constant-memory claim regressed (activations now "
                "scale with graph size)")
        full = summary_ratio("full_temp_ratio_max_over_min")
        if full < growth_floor:
            raise GateFailure(
                f"{where}: full-graph control temp grew only {full:.3f}x "
                f"(floor {growth_floor:.3f}x) — the sweep no longer "
                "exercises graph-size scaling, so the flat-GST gate above "
                "is vacuous")
        stream = summary_ratio("streaming_temp_ratio_max_over_min")
        if stream > 1.0 + stream_epsilon:
            raise GateFailure(
                f"{where}: streaming-encoder temp varies {stream:.4f}x "
                f"with the chunk count (budget {1 + stream_epsilon:.4f}x) "
                "— the lax.scan no longer holds one chunk's activations")
        if not s.get("streaming_bound_ok", False):
            raise GateFailure(
                f"{where}: streaming temp fell below the jaxpr-walk "
                "max_intermediate_bytes bound — the compiled stats and "
                "the accounting model disagree")
        if ladder_budget is not None:
            total = float(s.get("ladder_total_peak_bytes") or 0)
            if total > ladder_budget:
                raise GateFailure(
                    f"{where}: serve bucket-ladder total peak "
                    f"{total:.0f}B exceeds the device budget "
                    f"{ladder_budget:.0f}B")
        lines.append(f"memory {run_key[:60]}...: gst x{gst:.3f} flat, "
                     f"full x{full:.2f} grows, stream x{stream:.3f}")
    return lines


def check_trace(path: str) -> int:
    with open(path) as f:
        payload = json.load(f)
    problems = validate_chrome_trace(payload)
    if problems:
        head = "; ".join(problems[:5])
        raise GateFailure(f"{path}: invalid Chrome trace "
                          f"({len(problems)} problems: {head})")
    n = sum(1 for ev in payload.get("traceEvents", [])
            if ev.get("ph") != "M")
    if n == 0:
        raise GateFailure(f"{path}: trace contains no span events")
    return n


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="assert SLO gates against repro_torch.obs telemetry")
    ap.add_argument("--train-jsonl", default=None)
    ap.add_argument("--serve-jsonl", default=None)
    ap.add_argument("--trace", action="append", default=[],
                    help="Chrome trace JSON to validate (repeatable)")
    ap.add_argument("--serve-p99-ms", type=float, default=None,
                    help="serve.latency_ms p99 budget")
    ap.add_argument("--max-encode-launches", type=float, default=None,
                    help="serve.encode_launches budget (compile/launch "
                         "count, the bucketing regression canary)")
    ap.add_argument("--j-max", type=int, default=None)
    ap.add_argument("--num-sampled", type=int, default=None)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--age-safety", type=float, default=2.0)
    ap.add_argument("--memory-json", action="append", default=[],
                    help="bench_memory.py BENCH_gst_memory.json to gate "
                         "the constant-memory claims against (repeatable)")
    ap.add_argument("--mem-epsilon", type=float, default=0.25,
                    help="allowed fractional growth of GST train-step temp "
                         "bytes across the graph-size sweep")
    ap.add_argument("--stream-epsilon", type=float, default=0.01,
                    help="allowed fractional variation of streaming-"
                         "encoder temp bytes across chunk counts")
    ap.add_argument("--mem-growth-floor", type=float, default=2.0,
                    help="minimum growth of the full-graph control — "
                         "proves the sweep actually scales graph size")
    ap.add_argument("--ladder-budget-bytes", type=float, default=None,
                    help="serve bucket-ladder total compiled peak budget")
    ap.add_argument("--expect-mem", action="store_true",
                    help="require the mem. gauge family in the train "
                         "stream (--mem-probe wiring canary)")
    ap.add_argument("--expect-dist", action="store_true",
                    help="require the dist-run metric families "
                         "(store.wb_skip_rate, exchange.bytes.*) in the "
                         "train stream even if no exchange metric is "
                         "present — CI pins this so a silently-missing "
                         "exchange instrumentation fails the gate")
    ap.add_argument("--expect-prefetch", action="store_true",
                    help="require the prefetch-lane metric families "
                         "(exchange.prefetch.bytes.*, exchange.prefetch."
                         "patched_rows) in the train stream — CI pins "
                         "this on the --prefetch-lookups leg")
    ap.add_argument("--effective-age-below-row-age", action="store_true",
                    help="require staleness.effective_age p99 STRICTLY "
                         "below staleness.row_age p99 — the staleness-"
                         "intelligence acceptance gate: age weighting / "
                         "forecasting must reduce the age the training "
                         "step experiences, not just relabel it")
    ap.add_argument("--baseline-jsonl", default=None,
                    help="unweighted baseline train stream: its "
                         "staleness.row_age p99 becomes the reference the "
                         "--effective-age-below-row-age check compares "
                         "against (default: the --train-jsonl stream's "
                         "own row_age)")
    ap.add_argument("--allow-truncation", action="store_true",
                    help="tolerate nonzero serve.bucket.truncated_* "
                         "counters in the serve stream (catch-all bucket "
                         "overflow drops nodes/edges from predictions; "
                         "fails the gate by default)")
    args = ap.parse_args(argv)

    checks = []
    try:
        if args.train_jsonl:
            records = load_jsonl(args.train_jsonl)
            summary = final_summary(records, args.train_jsonl)
            families = TRAIN_FAMILIES
            is_dist = args.expect_dist or any(
                name.startswith("exchange.")
                for name in summary.get("metrics", {}))
            if is_dist:
                families = families + DIST_FAMILIES
            # a stream that advertises the prefetch lane must carry ALL
            # its families — a half-wired lane (bytes without the
            # patched-rows histogram, or vice versa) fails the gate
            has_prefetch = args.expect_prefetch or any(
                name.startswith("exchange.prefetch.")
                for name in summary.get("metrics", {}))
            if has_prefetch:
                families = families + PREFETCH_FAMILIES
            if args.expect_mem:
                families = families + MEM_FAMILIES
            names = require_families(summary, families, args.train_jsonl)
            checks.append(f"train stream ok: {len(records)} records, "
                          f"{len(names)} metrics")
            if args.j_max and args.num_sampled and args.steps_per_epoch:
                bound = sed_age_bound(j_max=args.j_max,
                                      num_sampled=args.num_sampled,
                                      steps_per_epoch=args.steps_per_epoch,
                                      safety=args.age_safety)
                p99 = metric_value(summary, "staleness.row_age", "p99",
                                   args.train_jsonl)
                if p99 > bound:
                    raise GateFailure(
                        f"staleness.row_age p99 {p99:.1f} steps exceeds the "
                        f"SED-implied bound {bound:.1f} (j_max={args.j_max}, "
                        f"num_sampled={args.num_sampled}) — staleness "
                        "bookkeeping or the refresh pass regressed")
                checks.append(f"row-age p99 {p99:.1f} <= bound {bound:.1f}")
            if args.effective_age_below_row_age:
                eff_p99 = metric_value(summary, "staleness.effective_age",
                                       "p99", args.train_jsonl)
                if args.baseline_jsonl:
                    base = final_summary(load_jsonl(args.baseline_jsonl),
                                         args.baseline_jsonl)
                    row_p99 = metric_value(base, "staleness.row_age", "p99",
                                           args.baseline_jsonl)
                    ref = args.baseline_jsonl
                else:
                    row_p99 = metric_value(summary, "staleness.row_age",
                                           "p99", args.train_jsonl)
                    ref = args.train_jsonl
                if not eff_p99 < row_p99:
                    raise GateFailure(
                        f"staleness.effective_age p99 {eff_p99:.2f} is not "
                        f"strictly below staleness.row_age p99 {row_p99:.2f} "
                        f"(reference {ref}) — age weighting/forecasting is "
                        "not reducing the staleness the step experiences")
                checks.append(f"effective-age p99 {eff_p99:.2f} < "
                              f"row-age p99 {row_p99:.2f}")

        if args.serve_jsonl:
            records = load_jsonl(args.serve_jsonl)
            summary = final_summary(records, args.serve_jsonl)
            names = require_families(summary, SERVE_FAMILIES,
                                     args.serve_jsonl)
            checks.append(f"serve stream ok: {len(records)} records, "
                          f"{len(names)} metrics")
            if args.serve_p99_ms is not None:
                p99 = metric_value(summary, "serve.latency_ms", "p99",
                                   args.serve_jsonl)
                if p99 > args.serve_p99_ms:
                    raise GateFailure(
                        f"serve.latency_ms p99 {p99:.2f}ms exceeds budget "
                        f"{args.serve_p99_ms:.2f}ms")
                checks.append(f"serve p99 {p99:.2f}ms <= "
                              f"{args.serve_p99_ms:.2f}ms")
            if args.max_encode_launches is not None:
                launches = metric_value(summary, "serve.encode_launches",
                                        None, args.serve_jsonl)
                if launches > args.max_encode_launches:
                    raise GateFailure(
                        f"serve.encode_launches {launches:.0f} exceeds "
                        f"budget {args.max_encode_launches:.0f} — bucket "
                        "padding/batching regressed")
                checks.append(f"encode launches {launches:.0f} <= "
                              f"{args.max_encode_launches:.0f}")
            # catch-all bucket overflow: absent counters = nothing was
            # truncated (the engine only publishes them on overflow)
            metrics = summary.get("metrics", {})
            trunc = {name: float(metrics[name] or 0)
                     for name in ("serve.bucket.truncated_nodes",
                                  "serve.bucket.truncated_edges")
                     if name in metrics}
            dropped = sum(trunc.values())
            if dropped and not args.allow_truncation:
                detail = ", ".join(f"{k.rsplit('.', 1)[-1]}={v:.0f}"
                                   for k, v in sorted(trunc.items()))
                raise GateFailure(
                    f"serve catch-all bucket truncated input ({detail}) — "
                    "predictions silently dropped graph structure; size "
                    "the ladder up or pass --allow-truncation")
            checks.append(
                "serve truncation: none" if not dropped else
                f"serve truncation: {dropped:.0f} dropped (allowed)")

        for mem_path in args.memory_json:
            checks.extend(check_memory_json(
                mem_path, mem_epsilon=args.mem_epsilon,
                stream_epsilon=args.stream_epsilon,
                growth_floor=args.mem_growth_floor,
                ladder_budget=args.ladder_budget_bytes))

        for trace_path in args.trace:
            n = check_trace(trace_path)
            checks.append(f"trace {trace_path}: valid, {n} events")
    except GateFailure as e:
        for line in checks:
            print(f"[obs-gate] PASS {line}")
        print(f"[obs-gate] FAIL {e}", file=sys.stderr)
        return 1

    if not checks:
        print("[obs-gate] FAIL nothing to check (pass --train-jsonl / "
              "--serve-jsonl / --trace)", file=sys.stderr)
        return 1
    for line in checks:
        print(f"[obs-gate] PASS {line}")
    print(f"[obs-gate] all {len(checks)} gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
