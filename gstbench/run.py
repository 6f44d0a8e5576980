"""One run of one cell of the port's benchmark.

    python3 -m gstbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``src/repro_torch``).  The cell names its configuration
(``configs/<config>.json``) and traffic (``traffic/<mix>.json``, whose
``kind`` names the driver in ``paths/<kind>.py``); its limits are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  The run makes its weights, documents and draws
from ``--seed``, warms up, measures for ``--seconds``, checks what the
timed path produced against the reference, and prints one JSON line last
on standard output (with ``--trace 1`` the per-layer metrics, read over a
traced part of the window).  It exits with another code than 0, and
prints no result, without the card the cell asks for, or when a module of
JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from gstbench import harness as H  # noqa: E402

# build and kernel caches at fixed places inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/gstbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/gstbench/torch_extensions",
          "CUDA_CACHE_PATH": "build/gstbench/nv"}


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m gstbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def applies(metric: dict, cell: str, reported=None) -> bool:
    """A metric with ``workloads`` is read in those cells; one without,
    in every cell (end to end) or every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, *, device: str, t0: float, cfg_over=None,
            traffic_over=None) -> dict:
    """Run one cell; the result's fields before printing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {**H.load_json(H.HERE / "configs" / f"{w['config']}.json"),
           "name": w["config"], **(cfg_over or {})}
    traffic = {**H.load_json(H.HERE / "traffic" / f"{w['traffic']}.json"),
               **(traffic_over or {})}
    limits = H.load_json(H.HERE / "limits" / f"{workload}.json")["limits"]
    peaks, kind = None, "cpu"
    if device == "cuda":
        import torch
        kind = torch.cuda.get_device_name(0)
        peaks = H.load_json(H.HERE / "peaks.json").get(kind)
    cell = H.Cell(workload, cfg, H.arch_of(cfg), traffic, seed,
                  seconds, trace, device, t0, peaks)
    path = H.load_module(H.HERE / "paths" / f"{traffic['kind']}.py",
                         f"gstbench_path_{traffic['kind']}")
    out = path.run(cell)
    checks = H.compare(out["numbers"], limits)
    e2e = out["end_to_end"]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    if trace:
        reported = [m["name"] for m in bench["end_to_end"]
                    if applies(m, workload)]
        values = {}
        for m in bench["per_layer"]:
            if applies(m, workload, reported):
                reader = H.load_module(H.HERE / "metrics" / f"{m['name']}.py",
                                       f"gstbench_metric_{m['name']}")
                v = reader.read(out["record"])
                if v is not None:
                    values[m["name"]] = v
    else:
        values = {m["name"]: e2e[m["name"]] for m in bench["end_to_end"]
                  if applies(m, workload)}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
           "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    if device == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": all(c["ok"] for c in checks.values())
              and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in values.items()},
              "device": dev}
    summary = out["record"].get("trace")
    if trace and summary:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check_s"] = out["check_s"]
    result["detail"] = out.get("detail", []) + [
        "set-up by phase (s since start): " + ", ".join(
            f"{k} {v:.3f}" for k, v in cell.marks)]
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    for k, v in CACHES.items():
        os.environ.setdefault(k, str(H.ROOT / v))
    try:
        bench = H.load_json(H.ROOT / "BENCHMARK.json")
        chips = {w["name"]: w["chips"] for w in bench["workloads"]}[
            args.workload]
        H.port()
    except (OSError, KeyError) as e:
        print(f"gstbench: cannot run {args.workload!r}: {e!r}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gstbench: {args.workload} needs {chips} CUDA device(s); "
              f"available {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    result = execute(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), device="cuda", t0=T0)
    bad = H.forbidden_modules()
    if bad:
        print(f"gstbench: the run loaded {bad}: the port's runs may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 4
    for line in result.pop("detail"):
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
