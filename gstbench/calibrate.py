"""The readings the limits are set from, many seeds in one process.

    python3 -m gstbench.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --out <file.jsonl>

For each seed, the program's readings against the reference (the lower
readings); for each control seed, the reference in TF32 against the
reference in f32 (the control), and for a training cell the planted fault
"half of the batch left out, the mean taken over the rest", in the
reference put in the program's place.  One JSON line a reading.  Not run
by the benchmark's runs.
"""
from __future__ import annotations

import argparse
import json
import time

from gstbench import harness as H


def cell_of(bench, workload, seed, seconds, device):
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    cfg = {**H.load_json(H.HERE / "configs" / f"{w['config']}.json"),
           "name": w["config"]}
    traffic = H.load_json(H.HERE / "traffic" / f"{w['traffic']}.json")
    peaks = None
    if device == "cuda":
        import torch
        peaks = H.load_json(H.HERE / "peaks.json").get(
            torch.cuda.get_device_name(0))
    return H.Cell(workload, cfg, H.arch_of(cfg), traffic, seed, seconds,
                  False, device, time.perf_counter(), peaks)


def train(cell, control: bool, program: bool):
    from gstbench.paths import train_efd as TE
    out = []
    if program:
        prog = TE.build(cell)
        seen = TE.checked_steps(cell, prog)
        del prog
        H.free_device(cell.device)
    ref = TE.reference(cell)
    if program:
        out.append(("program", TE.readings(seen, ref),
                    {"program": seen["losses"], "reference": ref["losses"]}))
    if control:
        low = TE.reference(cell, "tf32")
        out.append(("control_tf32", TE.readings(low, ref),
                    {"control": low["losses"]}))
        half = TE.reference(cell, "f32", slice(0, cell.traffic["batch"] // 2))
        out.append(("fault_half_batch", TE.readings(half, ref),
                    {"fault": half["losses"]}))
    return out


def predict(cell, control: bool, program: bool):
    from gstbench.paths import predict as PR
    out = []
    if program:
        r = PR.run(cell)
        out.append(("program", {**r["numbers"], "picked": r["picked"]},
                    r["end_to_end"]))
        picked = r["picked"]
    else:
        picked = [(i, int(j)) for i, j in enumerate(
            PR.schedule(cell, cell.traffic["sample"]))]
    if control:
        exact = PR.reference(cell, picked, "f32")
        low = PR.reference(cell, picked, "tf32")
        out.append(("control_tf32", {"logits": PR.logit_gap(low, exact),
                                     "picked": picked}, {}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    H.port()
    bench = H.load_json(H.ROOT / "BENCHMARK.json")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    with open(a.out, "a") as f:
        for seed in sorted(set(seeds) | set(controls)):
            cell = cell_of(bench, a.workload, seed, a.seconds, a.device)
            kind = cell.traffic["kind"]
            fn = train if kind == "train_efd" else predict
            t = time.perf_counter()
            for what, values, extra in fn(cell, seed in controls,
                                          seed in seeds):
                line = {"workload": a.workload, "seed": seed, "what": what,
                        "readings": values, "extra": extra,
                        "seconds": time.perf_counter() - t}
                print(json.dumps(line), flush=True)
                f.write(json.dumps(line) + "\n")
                f.flush()


if __name__ == "__main__":
    main()
