"""Tiny sizes for the CPU tests: the cells' files with the widths cut to
what a test run holds, driven through ``run.execute`` on the CPU.

Nothing here names a configuration or a traffic mix: a configuration's
tiny heads keep its file's query heads to a KV head, and a traffic
file's tiny parameters are its kind's ``TINY`` (``paths/<kind>.py``), so
a new file of either kind is tested without an edit here."""
from __future__ import annotations

import time

from gstbench import harness as H
from gstbench import run

TINY_HEAD_DIM = 16
TINY = {"num_hidden_layers": 2, "intermediate_size": 128, "vocab_size": 512,
        "head_dim": TINY_HEAD_DIM}


def bench() -> dict:
    return H.load_json(H.ROOT / "BENCHMARK.json")


CELLS = tuple(w["name"] for w in bench()["workloads"])
CONFIGS = tuple(sorted(p.stem for p in (H.HERE / "configs").glob("*.json")))


def traffic_file(traffic: str) -> dict:
    return H.load_json(H.HERE / "traffic" / f"{traffic}.json")


def cells_of(kind: str):
    """The benchmark's cells whose traffic is of ``kind``."""
    return [w["name"] for w in bench()["workloads"]
            if traffic_file(w["traffic"])["kind"] == kind]


def cell_files(workload: str):
    w = {c["name"]: c for c in bench()["workloads"]}[workload]
    return w["config"], w["traffic"]


def tiny_config(config: str) -> dict:
    return tiny_of(H.load_json(H.HERE / "configs" / f"{config}.json"))


def tiny_of(cfg: dict) -> dict:
    """A configuration's keys at tiny widths: query heads a KV head as the
    file has them, at most 4 KV heads of 16."""
    group = cfg["num_attention_heads"] // cfg["num_key_value_heads"]
    kv = max(1, 4 // group)
    return {**TINY, "num_attention_heads": kv * group,
            "num_key_value_heads": kv, "hidden_size": kv * group
            * TINY_HEAD_DIM, "gst": {**cfg["gst"], "segments": 4}}


def tiny_traffic(traffic: str) -> dict:
    """The tiny parameters of the traffic file's kind."""
    kind = traffic_file(traffic)["kind"]
    return H.load_module(H.HERE / "paths" / f"{kind}.py",
                         f"gstbench_path_{kind}").TINY


def execute(workload: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
            trace: bool = False) -> dict:
    config, traffic = cell_files(workload)
    return run.execute(bench(), workload, seed, seconds, trace,
                       device="cpu", t0=time.perf_counter(),
                       cfg_over=tiny_config(config),
                       traffic_over=tiny_traffic(traffic))
