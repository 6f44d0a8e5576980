"""Reduction of a ``torch.profiler`` trace to what the metric readers
and the result's ``device`` and ``breakdown`` read.

The traced window is the host range ``gstbench.window`` that the harness
opens after a synchronisation and closes after another.  Device time is
every device event (kernels, copies, fills) clipped to it; busy seconds
are the union of their intervals, so overlapping streams count once.  An
idle gap is named after what the host was doing at its midpoint: the
harness's outermost range (``gst.*``) and the innermost host operation.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Tuple

# cuBLAS and CUTLASS matmul kernels on Hopper and before
GEMM = re.compile(r"gemm|gemv|xmma|cutlass|cublas", re.IGNORECASE)
# the harness's host ranges, which the profiler mirrors on the device's
# timeline as annotations: no device work
HARNESS = ("gst.", "gstbench.")
# the longest gaps named one by one; the rest are summed as one entry
NAMED_GAPS = 400


def is_gemm(name: str) -> bool:
    return bool(GEMM.search(name)) and "swa_attention" not in name


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _covering(spans, starts, t: float, back: int):
    """Of ``spans`` (name, start, end) sorted by start, those covering
    ``t``, looking back at most ``back`` spans; latest start first."""
    i = bisect.bisect_right(starts, t)
    return [s for s in spans[max(0, i - back):i][::-1] if s[2] >= t]


def _host_label(ranges, range_starts, ops, op_starts, t: float) -> str:
    """The outermost harness range and the innermost host op covering
    time ``t``."""
    outer = _covering(ranges, range_starts, t, len(ranges))
    inner = _covering(ops, op_starts, t, 2000)
    parts = [outer[-1][0] if outer else "host"] + (
        [inner[0][0]] if inner else [])
    return "/".join(parts)


def summarize(prof, window_name: str) -> Dict:
    """{window_s, busy_s, device_s: {name: s}, device_ops, idle_gaps}; the
    lists hold at most 10 [name, seconds] pairs, longest first."""
    from torch.autograd import DeviceType
    events = prof.events()
    host, dev = [], []
    w0 = w1 = None
    for e in events:
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CPU:
            if e.name == window_name:
                w0, w1 = a, b
            else:
                host.append((e.name, a, b))
        elif not e.name.startswith(HARNESS):
            dev.append((e.name, a, b))
    if w0 is None:
        raise RuntimeError(f"no host range {window_name!r} in the trace")
    device_s: Dict[str, float] = defaultdict(float)
    clipped = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            device_s[name] += (b - a) * 1e-6
    busy = _merge(clipped)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host.sort(key=lambda x: x[1])
    ranges = [h for h in host if h[0].startswith("gst.")]
    ops = [h for h in host if not h[0].startswith("gst.")]
    range_starts = [a for _, a, _ in ranges]
    op_starts = [a for _, a, _ in ops]
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = defaultdict(float)
    for a, b in gaps[:NAMED_GAPS]:
        named[_host_label(ranges, range_starts, ops, op_starts,
                          (a + b) / 2)] += (b - a) * 1e-6
    rest = gaps[NAMED_GAPS:]
    if rest:
        named[f"{len(rest)} shorter gaps"] += sum(b - a for a, b in rest) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_s": dict(device_s), "device_ops": top(device_s),
            "idle_gaps": top(named)}
