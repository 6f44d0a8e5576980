"""The port's telemetry spine (src/repro_torch/obs/) against the JAX
package's (src/repro/obs/), piece by piece, on the same numpy inputs:

  * the registry's summary, delta, snapshot and percentiles, and
    ``dict_delta``, equal; the null registry and tracer are the shared
    no-op singletons;
  * ``StalenessProbe.observe_ages`` (λ 0, λ 0.1, the forecaster) returns
    and publishes the same summaries and histograms; ``sed_drop_stats``,
    ``sed_age_bound``, ``wb_skip_rate``, ``record_exchange_bytes`` and
    ``record_prefetch_exchange`` agree; the store's ``ages_init`` is the
    snapshot's ages, split over shards or not;
  * ``validate_chrome_trace`` flags the same breakages, and both accept
    the port tracer's export; ``annotations=True`` puts the span names
    into a ``torch.profiler`` trace (here on the CPU);
  * the JSONL stream has the same record types and keys; a tensor never
    reaches ``json.dumps``;
  * ``bench_diff`` gives the same report on the repo's own BENCH files;
  * ``Obs(mem_probe=True)`` installs a memory probe and a live registry
    and restores both on close, and a flag that would act only beside
    another one refuses to stand alone.
"""
import json
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.obs as J  # noqa: E402
import repro_torch.obs as P  # noqa: E402
from repro.obs import bench_diff as jbench_diff  # noqa: E402
from repro.obs.trace import null_tracer as jnull_tracer  # noqa: E402
from repro_torch.core import embedding_table as tbl  # noqa: E402
from repro_torch.obs import bench_diff  # noqa: E402
from repro_torch.obs.export import _jsonable  # noqa: E402
from repro_torch.store import DeviceStore, TieredStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_globals():
    """Every test starts and ends with both packages' null registry,
    tracer and memory probe installed."""
    for mod, nt in ((J, jnull_tracer), (P, P.null_tracer)):
        mod.set_registry(mod.null_registry())
        mod.set_tracer(nt())
        mod.set_probe(mod.null_probe())
    yield
    for mod, nt in ((J, jnull_tracer), (P, P.null_tracer)):
        mod.set_registry(mod.null_registry())
        mod.set_tracer(nt())
        mod.set_probe(mod.null_probe())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _drive_registry(mod, seed):
    """The same recordings into a fresh registry of ``mod``: its summary,
    two deltas, its snapshot and a list summary at three percentiles."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    lat = rng.lognormal(1.0, 1.5, 300)
    ages = rng.integers(0, 5000, 400)
    for v in lat[:150]:
        reg.observe("serve.latency_ms", float(v), unit="ms")
    reg.histogram("staleness.row_age", buckets=mod.AGE_BUCKETS_STEPS,
                  unit="steps").observe_many(ages)
    reg.inc("store.faults", int(rng.integers(1, 50)), unit="rows")
    reg.set("staleness.init_fraction", float(rng.random()))
    d1 = reg.delta()
    for v in lat[150:]:
        reg.observe("serve.latency_ms", float(v), unit="ms")
    reg.inc("store.faults", 3)
    reg.inc("exchange.bytes.ring.int8", 10240.0, unit="bytes")
    reg.histogram("bytes", buckets=mod.BYTES_BUCKETS).observe(4096.0)
    d2 = reg.delta()
    listed = mod.summarize(lat.tolist(), percentiles=(50, 99, 99.9))
    return reg.summary(), d1, d2, reg.snapshot(), listed, reg.names()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_summary_delta_snapshot_equal(seed):
    assert _drive_registry(P, seed) == _drive_registry(J, seed)


@pytest.mark.parametrize("cur,prev", [
    ({"a": 5, "b": 1.5, "name": "x", "ok": True}, {"a": 2, "b": 0.5}),
    ({"a": 5}, None),
    ({"a": 5, "b": 2}, {"a": "text", "c": 9}),
])
def test_dict_delta_equal(cur, prev):
    assert P.dict_delta(cur, prev) == J.dict_delta(cur, prev)


def test_registry_kinds_collide_and_threads_count():
    reg = P.MetricsRegistry()
    reg.set("store.occupancy", 7)
    with pytest.raises(TypeError):
        reg.inc("store.occupancy")
    h = reg.histogram("h", buckets=tuple(float(2 ** i) for i in range(8)))

    def work():
        for i in range(500):
            reg.inc("c")
            h.observe(float(i % 100))
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert reg.get("c").value == 4000 and reg.get("h").count == 4000


def test_null_registry_and_tracer_are_shared_noops():
    reg = P.null_registry()
    assert reg is P.get_registry() and not reg.enabled
    reg.inc("x", 5)
    reg.set("y", 2)
    reg.histogram("z").observe(1.0)
    assert reg.snapshot() == reg.summary() == reg.delta() == {}
    assert reg.names() == [] and reg.get("x") is None
    assert reg.counter("a") is reg.gauge("b") is reg.histogram("c")
    nt = P.get_tracer()
    assert nt is P.null_tracer() and not nt.enabled and len(nt) == 0
    assert nt.span("a") is nt.span("b")
    nt.instant("i")
    nt.counter("c", v=1.0)
    with pytest.raises(RuntimeError, match="--trace-out"):
        nt.export("never.json")


# ---------------------------------------------------------------------------
# staleness
# ---------------------------------------------------------------------------


def _ages(seed, n=40, J=6):
    rng = np.random.default_rng(seed)
    age = rng.integers(0, 90, (n, J)).astype(np.int32)
    init = rng.random((n, J)) < 0.7
    seg_valid = (rng.random((n, J)) < 0.8).astype(np.int32)
    return age, init, seg_valid


@pytest.mark.parametrize("knobs", [dict(), dict(sed_decay=0.1),
                                   dict(forecast=True),
                                   dict(sed_decay=0.1, forecast=True,
                                        forecast_min_age=4)])
def test_staleness_probe_observe_ages_equal(knobs):
    age, init, seg_valid = _ages(3)
    out = []
    for mod in (P, J):
        reg = mod.MetricsRegistry()
        probe = mod.StalenessProbe(keep_prob=0.5, num_sampled=2,
                                   seg_valid=seg_valid, registry=reg, **knobs)
        first = probe.observe_ages(age, init, 100)
        second = probe.observe_ages(age, init, 130)
        probe.observe_store_counters({"evictions": 8, "wb_skipped_rows": 3})
        out.append((first, second, reg.snapshot(), reg.summary()))
    assert out[0] == out[1]
    assert ("staleness.effective_age" in out[0][2]) == bool(knobs)


@pytest.mark.parametrize("seed,num_sampled,keep_prob", [
    (0, 1, 0.5), (1, 2, 0.25), (2, 8, 0.9)])
def test_sed_drop_stats_equal(seed, num_sampled, keep_prob):
    _, init, seg_valid = _ages(seed)
    kw = dict(num_sampled=num_sampled, keep_prob=keep_prob)
    assert P.sed_drop_stats(seg_valid, init, **kw) == \
        J.sed_drop_stats(seg_valid, init, **kw)


@pytest.mark.parametrize("kw", [
    dict(j_max=4, num_sampled=1, steps_per_epoch=10),
    dict(j_max=3, num_sampled=1, steps_per_epoch=4, safety=1.0),
    dict(j_max=20, num_sampled=3, steps_per_epoch=7),
    dict(j_max=1, num_sampled=5, steps_per_epoch=2)])
def test_sed_age_bound_equal(kw):
    assert P.sed_age_bound(**kw) == J.sed_age_bound(**kw)


@pytest.mark.parametrize("stats", [{}, {"evictions": 0, "wb_skipped_rows": 2},
                                   {"evictions": 9, "wb_skipped_rows": 4}])
def test_wb_skip_rate_equal(stats):
    assert P.wb_skip_rate(stats) == J.wb_skip_rate(stats)


def test_exchange_recorders_equal():
    out = []
    for mod in (P, J):
        reg = mod.MetricsRegistry()
        for rows in (0, 0, 3, 24, 5000):
            mod.record_exchange_bytes("ring", "int8", 10272, registry=reg)
            mod.record_prefetch_exchange("bucketed", "f32", 2048, rows,
                                         registry=reg)
        mod.record_exchange_bytes("alltoall", "bf16", 77, registry=reg)
        out.append((reg.snapshot(), reg.summary()))
    assert out[0] == out[1]
    assert out[0][0]["exchange.prefetch.patched_rows"]["count"] == 5


@pytest.mark.parametrize("backend,shards", [("device", 1), ("device", 2),
                                            ("tiered", 2)])
def test_ages_init_is_the_snapshot(backend, shards):
    """The probe's view (``ages_init``) of every shard's table is the
    snapshot's ages and flags, so a probe histogram counts the table."""
    n, J_, d = 13, 4, 3
    rng = np.random.default_rng(5)
    snap = tbl.EmbeddingTable(
        torch.from_numpy(rng.normal(size=(n, J_, d)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 50, (n, J_)).astype(np.int32)),
        torch.from_numpy(rng.random((n, J_)) < 0.6))
    store = (DeviceStore(n, J_, d, num_shards=shards, device="cpu")
             if backend == "device" else
             TieredStore(n, J_, d, device_rows=4 * shards, num_shards=shards,
                         device="cpu"))
    try:
        tables = store.restore(snap)
        if backend == "tiered":   # a resident row overlays the host tier
            tables, slots = store.prepare(tables, np.array([2, 9]))
        age, init = store.ages_init(tables if shards > 1 else tables[0])
        want = store.snapshot(tables)
        np.testing.assert_array_equal(age, want.age.numpy())
        np.testing.assert_array_equal(init, want.initialized.numpy())
        np.testing.assert_array_equal(age, snap.age.numpy())
    finally:
        store.close()


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

_TRACE_BREAKAGES = [
    {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 10, "dur": 1, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5, "dur": -1, "pid": 1, "tid": 1},
        {"name": "c", "ph": "E", "ts": 20, "pid": 1, "tid": 1}]},
    {"traceEvents": "not a list"},
    {},
    {"traceEvents": [
        {"name": "m", "ph": "M", "pid": 1, "tid": 1},
        {"name": "c", "ph": "C", "ts": 1, "pid": 1, "tid": 1, "args": {}},
        {"name": "c", "ph": "C", "ts": 2, "pid": 1, "tid": 1,
         "args": {"v": True}},
        {"name": "q", "ph": "Q", "ts": 3, "pid": 1, "tid": 1},
        {"name": "x", "ph": "X", "ts": 4, "dur": 2}]},
    {"traceEvents": [
        {"name": "b", "ph": "B", "ts": 1, "pid": 1, "tid": 1},
        {"name": "b", "ph": "B", "ts": 2, "pid": 1, "tid": 2},
        {"name": "b", "ph": "E", "ts": 3, "pid": 1, "tid": 1},
        {"name": "i", "ph": "i", "ts": 1.5, "pid": 1, "tid": 1}]},
]


@pytest.mark.parametrize("payload", _TRACE_BREAKAGES)
def test_validate_chrome_trace_flags_the_same_breakages(payload):
    got = P.validate_chrome_trace(payload)
    assert got == J.validate_chrome_trace(payload) and got


def test_port_tracer_export_passes_both_validators(tmp_path):
    tracer = P.Tracer()
    together = threading.Barrier(4, timeout=60)   # 4 live threads: 4 tids

    def work(i):
        together.wait()
        for k in range(5):
            with tracer.span("feeder.put", batch=k):
                with tracer.span("store.begin"):
                    pass
        tracer.counter("queue", depth=i)
        together.wait()
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    tracer.instant("epoch", n=1)
    path = tracer.export(str(tmp_path / "t.json"))
    payload = json.loads(Path(path).read_text())
    assert P.validate_chrome_trace(payload) == []
    assert J.validate_chrome_trace(payload) == []
    xs = [e for e in payload["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 40 and len(tracer) == 4 * 11 + 1
    assert len({e["tid"] for e in xs}) == 4


def test_annotations_enter_record_function_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    tracer = P.Tracer(annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracer.span("train.step", epoch=0):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("train.step") == 3 and len(tracer) == 3
    plain = P.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with plain.span("train.step"):
            torch.ones(4).sum()
    assert "train.step" not in [e.name for e in prof.events()]


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _drive_obs(mod, tmp_path, tag):
    out = tmp_path / f"{tag}.jsonl"
    obs = mod.Obs(metrics_out=str(out), trace_out=str(tmp_path / f"{tag}.json"),
                  metrics_interval=2)
    assert mod.get_registry() is obs.registry and obs.enabled
    obs.exporter.meta(run="unit", devices=2)
    obs.registry.inc("store.faults", 4)
    obs.registry.observe("serve.latency_ms", 3.0)
    with mod.get_tracer().span("train.step"):
        pass
    ticks = [obs.tick(step=i, epoch=i, loss=0.5) if obs.should_tick(i)
             else None for i in range(3)]
    obs.event("note", n=np.int64(3))
    obs.registry.set("store.wb_skip_rate", 0.25)
    rec = obs.close(wall_s=1.0, train_metric=np.float32(0.5))
    assert obs.close() is None and not mod.get_registry().enabled
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    return ticks, rec, lines


def test_jsonl_stream_types_and_keys_match(tmp_path):
    pt, prec, plines = _drive_obs(P, tmp_path, "port")
    jt, jrec, jlines = _drive_obs(J, tmp_path, "jax")
    assert [l["type"] for l in plines] == [l["type"] for l in jlines] == [
        "meta", "tick", "tick", "event", "summary"]
    for p, j in zip(plines, jlines):
        assert sorted(p) == sorted(j)
        if p["type"] != "meta":
            drop = ("wall_s", "wall_time")
            assert {k: v for k, v in p.items() if k not in drop} == \
                {k: v for k, v in j.items() if k not in drop}
    assert [t is None for t in pt] == [t is None for t in jt] == \
        [False, True, False]
    assert prec["metrics"] == jrec["metrics"]
    trace = json.loads((tmp_path / "port.json").read_text())
    assert J.validate_chrome_trace(trace) == []


def test_obs_off_is_the_null_bundle():
    obs = P.Obs()
    assert not obs.enabled and obs.registry is P.null_registry()
    assert obs.tracer is P.null_tracer() and obs.exporter is None
    assert obs.tick(step=0) is None and not obs.should_tick(0)
    assert obs.close() is None


def test_jsonable_takes_tensors_and_numpy():
    payload = {"loss": torch.tensor(0.25), "n": torch.tensor(3),
               "v": torch.arange(3), "a": np.arange(2), "s": np.float32(1.5),
               "bad": float("nan"), "t": (1, torch.tensor([1.5]))}
    got = _jsonable(payload)
    assert got == {"loss": 0.25, "n": 3, "v": [0, 1, 2], "a": [0, 1],
                   "s": 1.5, "bad": None, "t": [1, [1.5]]}
    json.dumps(got)


@pytest.mark.parametrize("kw,err,match", [
    (dict(annotations=True), ValueError, "--trace-out"),
    (dict(metrics=True, metrics_interval=3), ValueError, "--metrics-out"),
    (dict(metrics_out="x.jsonl", metrics_interval=0), ValueError, "< 1"),
])
def test_obs_refuses_flags_that_cannot_act(kw, err, match, tmp_path,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(err, match=match):
        P.Obs(**kw)
    assert not P.get_registry().enabled


def test_obs_mem_probe_installs_probe_and_live_registry():
    obs = P.Obs(mem_probe=True)
    assert obs.enabled and obs.exporter is None
    assert P.get_probe() is obs.probe and obs.probe.enabled
    assert P.get_registry() is obs.registry and obs.registry.enabled
    rec = obs.close()
    assert rec["type"] == "summary" and rec["metrics"] == {}
    assert P.get_probe() is P.null_probe() and not P.get_probe().enabled
    assert P.get_registry() is P.null_registry()


# ---------------------------------------------------------------------------
# bench_diff
# ---------------------------------------------------------------------------

BENCH_FILES = sorted(p.name for p in ROOT.glob("BENCH_gst_*.json"))


def _perturbed(src: Path, dst: Path) -> None:
    """``src`` with every third numeric leaf scaled by 1.5 and one run key
    renamed (a config that came and went)."""
    count = [0]

    def walk(o):
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items()}
        if isinstance(o, list):
            return [walk(v) for v in o]
        if isinstance(o, (int, float)) and not isinstance(o, bool):
            count[0] += 1
            return o * 1.5 if count[0] % 3 == 0 else o
        return o
    payload = walk(json.loads(src.read_text()))
    runs = payload["runs"]
    if runs:
        first = sorted(runs)[0]
        runs[first + "|renamed"] = runs.pop(first)
    dst.write_text(json.dumps(payload))


@pytest.mark.parametrize("name", BENCH_FILES)
def test_bench_diff_same_report(name, tmp_path):
    src = ROOT / name
    fresh = tmp_path / ("fresh_" + name)
    _perturbed(src, fresh)
    for tol in (0.0, 0.25):
        for a, b in ((src, src), (fresh, src), (src, fresh)):
            got = bench_diff.diff_files(str(a), str(b), tolerance=tol)
            assert got == jbench_diff.diff_files(str(a), str(b),
                                                 tolerance=tol)
    argv = ["--fresh", str(fresh), "--baseline", str(src), "--strict"]
    assert bench_diff.main(argv) == jbench_diff.main(argv)


def test_bench_diff_refuses_mismatched_benchmarks():
    a, b = (str(ROOT / n) for n in BENCH_FILES[:2])
    for mod in (bench_diff, jbench_diff):
        with pytest.raises(ValueError, match="benchmark mismatch"):
            mod.diff_files(a, b, tolerance=0.25)
        assert mod.main(["--fresh", a, "--baseline", b]) == 1
