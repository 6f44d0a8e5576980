"""Telemetry of a ``torchrun`` run of ``launch/train_dist.py`` on the CPU:
two gloo processes (``torch.distributed.run --nproc_per_node 2``) against
``--devices 2`` threads, both with ``--metrics-out``, ``--trace-out`` and
``--mem-probe``.

  * the streams are equal on every key but timings: the same record types
    in the same order, the same ``meta`` (``devices`` the world size),
    tick keys, metric names and values, losses bitwise; the counters the
    thread run reads over all its shards (the staleness probe over the
    whole table, the store's, ``feeder.batches``, the exchange bytes) are
    gathered to rank 0;
  * a ``dist.*`` memory record covers one process's shard (``"shards":
    1``, ``"world_size": 2``) where the thread run's covers both, at the
    same sites with as many calls;
  * rank 1 writes no file: one stream, one trace;
  * both packages' gates pass the torchrun stream;
  * over a capped table with the delta-gated write-back, the store's
    counters, shard-local ones included, sum to the thread run's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.obs as P  # noqa: E402
from repro.obs import gate as jgate  # noqa: E402
from repro_torch.launch import train_dist  # noqa: E402
from repro_torch.obs import gate as pgate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--device", "cpu", "--exchange", "ring", "--payload-dtype", "int8",
        "--epochs", "2", "--finetune-epochs", "1", "--n-graphs", "32",
        "--metrics-out", "s.jsonl", "--trace-out", "t.json", "--mem-probe"]
# keys whose values are times or host memory: equal only in name
TIMING = ("_ms", "wall", "rss", "mem.")


def _both(tmp_path_factory, args):
    """(torchrun dir, thread dir): the files of the two runs of ``args``."""
    ranked = tmp_path_factory.mktemp("torchrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train_dist",
         *args], cwd=ranked, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    threads = tmp_path_factory.mktemp("threads")
    cwd = os.getcwd()
    os.chdir(threads)
    try:
        train_dist.main(args + ["--devices", "2"])
    finally:
        os.chdir(cwd)
        P.set_registry(P.null_registry())
        P.set_tracer(P.null_tracer())
        P.set_probe(P.null_probe())
    return ranked, threads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _both(tmp_path_factory, ARGS)


@pytest.fixture(scope="module")
def tiered_runs(tmp_path_factory):
    """A capped table over a host tier with the delta-gated write-back:
    each process settles its own shards' write-backs."""
    return _both(tmp_path_factory, ARGS + ["--table-device-rows", "16",
                                           "--wb-threshold", "0.05"])


def _stream(d):
    return [json.loads(ln) for ln in (d / "s.jsonl").read_text().splitlines()]


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if k != "argv" and not any(t in k for t in TIMING)}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def test_streams_equal_on_every_key_but_timings(runs):
    got, want = (_stream(d) for d in runs)
    assert [r["type"] for r in got] == [r["type"] for r in want] == [
        "meta", "tick", "tick", "event", "summary"]
    assert got[0]["devices"] == 2
    for g, w in zip(got, want):
        if g["type"] == "event":
            continue
        assert g.keys() == w.keys(), g["type"]
        assert _untimed(g) == _untimed(w), g["type"]
    # the names of timed metrics too, and the ticks' losses bitwise
    assert sorted(got[-1]["metrics"]) == sorted(want[-1]["metrics"])
    for g, w in zip(got[1:3], want[1:3]):
        assert sorted(g["delta"]) == sorted(w["delta"])
        assert g["loss"] == w["loss"] and isinstance(g["loss"], float)


def test_counters_read_over_every_shard_are_gathered(runs):
    got, want = (_stream(d) for d in runs)
    metrics = got[-1]["metrics"]
    for k in ("feeder.batches", "exchange.bytes.ring.int8",
              "store.lookups", "store.hits", "store.wb_skip_rate",
              "staleness.init_fraction", "staleness.row_age",
              "staleness.sed.eligible", "staleness.sed_drop_rate"):
        assert metrics[k] == want[-1]["metrics"][k], k
    for g, w in zip(got[1:3], want[1:3]):
        assert g["staleness"] == w["staleness"]
        # the staleness probe saw the whole table: both shards' rows
        assert g["staleness"]["row_age_steps"]["count"] > 0


def test_memory_records_cover_one_process_shard(runs):
    got, want = (_stream(d)[3]["records"] for d in runs)
    # a site's signature is its arguments': one shard's state here, both
    # shards' in the thread run
    assert [(r["site"], r["calls"]) for r in got] == [
        (r["site"], r["calls"]) for r in want]
    assert {r["site"] for r in got} >= {"dist.train_step",
                                        "dist.eval_step"}
    for g, w in zip(got, want):
        if g["site"].startswith("dist."):
            assert (g["shards"], g["world_size"]) == (1, 2)
            assert w["shards"] == 2 and "world_size" not in w


def test_rank_one_writes_no_file(runs):
    ranked, threads = runs
    assert sorted(p.name for p in ranked.iterdir()) == ["s.jsonl", "t.json"]
    lines = _stream(ranked)
    assert sum(r["type"] == "meta" for r in lines) == 1
    assert sum(r["type"] == "summary" for r in lines) == 1
    assert P.validate_chrome_trace(json.loads((ranked / "t.json")
                                              .read_text())) == []


@pytest.mark.parametrize("gate", [jgate, pgate], ids=["jax", "port"])
def test_both_gates_pass_the_torchrun_stream(runs, gate):
    ranked, _ = runs
    assert gate.main(["--train-jsonl", str(ranked / "s.jsonl"),
                      "--expect-dist", "--expect-mem",
                      "--trace", str(ranked / "t.json")]) == 0


def test_tiered_store_counters_fold_into_rank_zero(tiered_runs):
    """The write-back lane counts what it skips for its own process's
    shards; rank 0 folds the others' in, so the summary's store counters
    equal the thread run's one store's once the lane has drained (the
    ticks read the lane mid-flight, in either run)."""
    got, want = (_stream(d) for d in tiered_runs)
    assert [r["type"] for r in got] == [r["type"] for r in want]
    g, w = got[-1]["metrics"], want[-1]["metrics"]
    assert sorted(g) == sorted(w)
    store = [k for k in w if k.startswith("store.") and "_ms" not in k]
    assert {"store.faults", "store.evictions", "store.bytes_d2h",
            "store.wb_skipped_rows", "store.wb_skip_rate"} <= set(store)
    assert w["store.wb_skipped_rows"] > 0
    for k in store:
        assert g[k] == w[k], k
    assert [r["loss"] for r in got[1:3]] == [r["loss"] for r in want[1:3]]
