"""Benchmark drift report of the port: fresh BENCH_*.json vs the committed
baseline.

A copy of ``src/repro/obs/bench_diff.py`` (the same joins, leaves and
exit codes).  The tracked benchmark writers (benchmarks/bench_*.py)
merge runs into ``{"benchmark", "unit", "runs": {run_key: entry}}``
keyed by (config, backend, framework version, device count).  This tool
joins a freshly-written file against the committed baseline ON THOSE
SAME KEYS and reports every numeric leaf whose relative delta exceeds
the tolerance:

    python -m repro_torch.obs.bench_diff \\
        --fresh BENCH_gst_memory_ci.json --baseline BENCH_gst_memory.json \\
        --tolerance 0.25

Exit code is 0 even when drift is found (a WARNING step in CI — wall-
clock noise on shared runners must not fail the build); ``--strict``
turns drift into exit 1 for local use and for byte-exact metrics like
the memory benchmark.  Run keys present on only one side are reported
but never fatal: configs legitimately come and go.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterator, List, Optional, Tuple

# leaves that identify the run rather than measure it — never diffed
_SKIP_KEYS = {"config", "env"}


def _numeric_leaves(obj, prefix: str = "") -> Iterator[Tuple[str, float]]:
    """Depth-first (path, value) over every numeric leaf; bools excluded
    (they are claims, not measurements — compared separately)."""
    if isinstance(obj, dict):
        for k in sorted(obj):
            if not prefix and k in _SKIP_KEYS:
                continue
            yield from _numeric_leaves(obj[k], f"{prefix}{k}." if prefix
                                       else f"{k}.")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _numeric_leaves(v, f"{prefix}{i}.")
    elif isinstance(obj, bool):
        yield prefix.rstrip("."), float(obj)
    elif isinstance(obj, (int, float)) and obj == obj:  # NaN-safe
        yield prefix.rstrip("."), float(obj)


def load_bench(path: str) -> Dict:
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload.get("runs"), dict):
        raise ValueError(f"{path}: not a merge-keyed BENCH file "
                         "(no 'runs' dict)")
    return payload


def diff_entries(fresh: Dict, baseline: Dict,
                 tolerance: float) -> List[Dict]:
    """Per-metric deltas between two run entries; returns only the leaves
    whose relative change exceeds ``tolerance`` (appeared/vanished leaves
    always count)."""
    f_leaves = dict(_numeric_leaves(fresh))
    b_leaves = dict(_numeric_leaves(baseline))
    out = []
    for path in sorted(f_leaves.keys() | b_leaves.keys()):
        fv, bv = f_leaves.get(path), b_leaves.get(path)
        if fv is None or bv is None:
            out.append({"metric": path, "fresh": fv, "baseline": bv,
                        "rel_delta": None,
                        "note": "missing in " +
                                ("baseline" if bv is None else "fresh")})
            continue
        denom = max(abs(bv), 1e-12)
        rel = (fv - bv) / denom
        if abs(rel) > tolerance:
            out.append({"metric": path, "fresh": fv, "baseline": bv,
                        "rel_delta": round(rel, 4)})
    return out


def diff_files(fresh_path: str, baseline_path: str, *,
               tolerance: float) -> Dict:
    fresh = load_bench(fresh_path)
    baseline = load_bench(baseline_path)
    report = {"benchmark": fresh.get("benchmark"),
              "tolerance": tolerance, "common": [],
              "only_fresh": [], "only_baseline": []}
    if fresh.get("benchmark") != baseline.get("benchmark"):
        raise ValueError(
            f"benchmark mismatch: fresh={fresh.get('benchmark')!r} "
            f"baseline={baseline.get('benchmark')!r}")
    f_runs, b_runs = fresh["runs"], baseline["runs"]
    report["only_fresh"] = sorted(f_runs.keys() - b_runs.keys())
    report["only_baseline"] = sorted(b_runs.keys() - f_runs.keys())
    for run_key in sorted(f_runs.keys() & b_runs.keys()):
        drifted = diff_entries(f_runs[run_key], b_runs[run_key], tolerance)
        report["common"].append({"run_key": run_key, "drift": drifted})
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="report drift between a fresh BENCH_*.json and the "
                    "committed baseline")
    ap.add_argument("--fresh", required=True)
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="relative delta beyond which a leaf is reported")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any drift (default: report-only)")
    args = ap.parse_args(argv)

    try:
        report = diff_files(args.fresh, args.baseline,
                            tolerance=args.tolerance)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"[bench-diff] ERROR {e}", file=sys.stderr)
        return 1

    n_drift = 0
    for rk in report["only_fresh"]:
        print(f"[bench-diff] NOTE run only in fresh: {rk}")
    for rk in report["only_baseline"]:
        print(f"[bench-diff] NOTE run only in baseline: {rk}")
    for item in report["common"]:
        drift = item["drift"]
        if not drift:
            print(f"[bench-diff] OK {item['run_key'][:80]}: within "
                  f"{args.tolerance:.0%}")
            continue
        n_drift += len(drift)
        print(f"[bench-diff] DRIFT {item['run_key'][:80]}:")
        for d in drift:
            if d.get("rel_delta") is None:
                print(f"[bench-diff]   {d['metric']}: {d['note']} "
                      f"(fresh={d['fresh']}, baseline={d['baseline']})")
            else:
                print(f"[bench-diff]   {d['metric']}: "
                      f"{d['baseline']} -> {d['fresh']} "
                      f"({d['rel_delta']:+.1%})")
    if not report["common"]:
        print("[bench-diff] WARNING no common run keys — nothing compared "
              "(config/backend/jax-version changed?)")
    if n_drift:
        print(f"[bench-diff] {n_drift} drifted metrics "
              f"(tolerance {args.tolerance:.0%})")
        return 1 if args.strict else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
