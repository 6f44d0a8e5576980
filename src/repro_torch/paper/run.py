"""Runner of the paper tables: one function per paper table or figure.

Usage:
    PYTHONPATH=src python -m repro_torch.paper.run              # full suite
    PYTHONPATH=src python -m repro_torch.paper.run --quick      # CI-sized
    PYTHONPATH=src python -m repro_torch.paper.run --only table1,table3
    PYTHONPATH=src python -m repro_torch.paper.run --quick --device cpu

Prints ``name,value,derived`` CSV rows per entry, as ``benchmarks/run.py``
does.  Runs on the card unless ``--device cpu``; asking for the card where
none is visible raises.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List

from repro_torch import resolve_device


def main(argv=None) -> Dict[str, List]:
    """Run the entries and return their rows by entry name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark names")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    resolve_device(args.device)

    from repro_torch.paper.paper_tables import ALL_BENCHES
    names = list(ALL_BENCHES) if not args.only else args.only.split(",")
    print("name,value,derived")
    t0 = time.time()
    results = {}
    for name in names:
        if name not in ALL_BENCHES:
            print(f"unknown benchmark {name!r}; have {list(ALL_BENCHES)}",
                  file=sys.stderr)
            continue
        t1 = time.time()
        results[name] = ALL_BENCHES[name](quick=args.quick,
                                          device=args.device)
        print(f"# {name} done in {time.time()-t1:.0f}s", flush=True)
    print(f"# total {time.time()-t0:.0f}s")
    return results


if __name__ == '__main__':
    main()
