"""Compare sweeps of the dry run (``launch/dryrun.py``) row by row.

Each sweep is the ``--out`` JSON of ``python -m repro_torch.launch.dryrun``
(a list of rows), named on the command line; the first is the basis.
Prints, per file, its statuses; per row, whether its FLOPs, bytes and
collectives (bytes and counts) equal the basis's to the last digit; the
rows whose temp or peak bytes a device differ between any two files, with
each file's figures and their ratio to the basis's; and every row whose
``memory_analysis.collector_bytes`` is not 0 (bytes only Python's
collector freed: ``roofline/analysis.py``).  Exits 1 where a row's
counts differ, where any ``collector_bytes`` is not 0, or, with
``--same-memory a,b``, where files a and b differ in any row's temp or
peak bytes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun_compare \
        parent=parent_single.json change=change_single.json \
        [change2=change2_single.json] [--same-memory change,change2]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple

COUNTS = ("flops_per_device", "bytes_per_device",
          "collective_bytes_per_device", "collective_op_counts")
MEMORY = ("temp_bytes", "peak_bytes")


def load(path: str) -> Dict[Tuple[str, str, str], dict]:
    """A sweep's rows by (arch, shape, mesh)."""
    with open(path) as f:
        return {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}


def statuses(rows) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in rows.values():
        s = "ok" if r["status"] == "ok" else "skipped" \
            if "skip" in r["status"] else "failed"
        out[s] = out.get(s, 0) + 1
    return out


def compare(sweeps: Dict[str, dict], same_memory=()) -> Tuple[List[str],
                                                                bool]:
    """(the report's lines, whether every check held)."""
    names = list(sweeps)
    base = sweeps[names[0]]
    lines, ok = [], True
    for name, rows in sweeps.items():
        lines.append(f"{name}: {len(rows)} rows, {statuses(rows)}")
    keys = sorted(k for k in base if base[k]["status"] == "ok")
    for name in names[1:]:
        differ = [k for k in keys if sweeps[name].get(k, {}).get(
            "status") != "ok" or any(sweeps[name][k][c] != base[k][c]
                                     for c in COUNTS)]
        ok &= not differ
        lines.append(f"{name} vs {names[0]}: FLOPs, bytes and collectives "
                     f"equal in {len(keys) - len(differ)} of {len(keys)} "
                     f"ok rows" + (f"; differ: {differ}" if differ else ""))
    lines.append("| arch | shape | mesh | what | " + " | ".join(names)
                 + " | " + " | ".join(f"{n} / {names[0]}"
                                      for n in names[1:]) + " |")
    lines.append("|---" * (4 + 2 * len(names) - 1) + "|")
    moved = 0
    for k in keys:
        mems = {n: sweeps[n].get(k, {}).get("memory_analysis") for n in names}
        if any(m is None for m in mems.values()):
            continue
        for what in MEMORY:
            vals = [mems[n][what] for n in names]
            if len(set(vals)) == 1:
                continue
            moved += what == "temp_bytes"
            lines.append(f"| {k[0]} | {k[1]} | {k[2]} | {what} | "
                         + " | ".join(f"{v:.4e}" for v in vals) + " | "
                         + " | ".join(f"×{v / vals[0]:.3f}"
                                      for v in vals[1:]) + " |")
        for n in names:
            got = mems[n].get("collector_bytes")
            if got:
                ok = False
                lines.append(f"{n} {k}: collector_bytes {got}")
    lines.append(f"temp bytes differ between files in {moved} of "
                 f"{len(keys)} ok rows")
    for a, b in [tuple(p.split(",")) for p in same_memory]:
        differ = [k for k in keys if any(
            sweeps[a][k]["memory_analysis"][w]
            != sweeps[b][k]["memory_analysis"][w] for w in MEMORY)]
        ok &= not differ
        lines.append(f"{a} vs {b}: temp and peak bytes equal in "
                     f"{len(keys) - len(differ)} of {len(keys)} ok rows"
                     + (f"; differ: {differ}" if differ else ""))
    return lines, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sweeps", nargs="+", help="name=path of a sweep's JSON")
    ap.add_argument("--same-memory", action="append", default=[],
                    help="a,b: files a and b must give the same temp and "
                         "peak bytes in every row")
    args = ap.parse_args(argv)
    sweeps = {}
    for item in args.sweeps:
        name, _, path = item.rpartition("=")
        sweeps[name or path] = load(path)
    lines, ok = compare(sweeps, args.same_memory)
    print("\n".join(lines))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
