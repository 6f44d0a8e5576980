"""The port's memory probe (src/repro_torch/obs/memory.py) and its
constant-memory sweep (obs/memory_sweep.py), held against the JAX
package's (src/repro/obs/memory.py, benchmarks/bench_memory.py) on the
CPU, the counterpart of tests/test_obs_memory.py:

  * records keyed by (site, shape signature), measured once and counted
    after, their gauges in the registry; ``shape_signature`` and
    ``tree_nbytes`` equal the reference's on the same numpy trees;
  * a probed call is the call: a train step with the probe installed is
    bitwise the step without, a call that raises leaves no record, and
    the disabled probe records nothing;
  * accounting mode counts the live bytes of the storages a call makes;
    a ``dist.*``-style call sums its shard threads' peaks (each thread
    under its own dispatch mode) and carries ``"shards"``;
  * the host gauges: ``store.host_tier`` = the snapshot's bytes (and the
    reference store's gauge), ``feeder.staging`` = the batch's bytes;
  * ``Obs(mem_probe=True)`` writes the memory event just before the
    summary;
  * the streaming encoder's ``max_intermediate_bytes`` stays flat as the
    chunk count grows while the one-shot encoder's grows
    (tests/test_serve.py::test_streaming_constant_memory), and its
    accounting temp is flat and at least that bound;
  * the sweep at ``--quick`` writes a ``gst_memory`` file that both
    packages' gates pass, the full-graph control growing >= 2x.
"""
import collections
import json
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.obs as J  # noqa: E402
import repro_torch.obs as P  # noqa: E402
from repro.obs.trace import null_tracer as jnull_tracer  # noqa: E402
from repro.store import TieredStore as JTieredStore  # noqa: E402
from repro_torch.core import embedding_table as tbl  # noqa: E402
from repro_torch.core import gst as G  # noqa: E402
from repro_torch.dist import pipeline as DP  # noqa: E402
from repro_torch.dist.comm import LocalGroup  # noqa: E402
from repro_torch.graphs import data as D  # noqa: E402
from repro_torch.graphs.experiment import (epoch_generator,  # noqa: E402
                                           load_datasets, to_batch)
from repro_torch.graphs.gnn import (GNNConfig, encode_segments,  # noqa: E402
                                    gnn_init, make_encode_fn)
from repro_torch.kernels.ops import max_intermediate_bytes  # noqa: E402
from repro_torch.obs.memory import (LiveBytes, in_shard,  # noqa: E402
                                    measure_call, probe_call)
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve.buckets import BucketSpec  # noqa: E402
from repro_torch.serve.engine import (SEG_KEYS, graph_to_chunks,  # noqa: E402
                                      make_stream_encoder)
from repro_torch.store import TieredStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HID = 8
NT = collections.namedtuple("NT", "a b")


@pytest.fixture(autouse=True)
def _clean_globals():
    for mod, nt in ((J, jnull_tracer), (P, P.null_tracer)):
        mod.set_registry(mod.null_registry())
        mod.set_tracer(nt())
        mod.set_probe(mod.null_probe())
    yield
    for mod, nt in ((J, jnull_tracer), (P, P.null_tracer)):
        mod.set_registry(mod.null_registry())
        mod.set_tracer(nt())
        mod.set_probe(mod.null_probe())


def _train_setup(seed=0):
    """A small sage gst_efd train step, its state and a batch (CPU)."""
    _, ds, _ = load_datasets("malnet", 16, 24)
    cfg = GNNConfig(backbone="sage", n_feat=ds.x.shape[-1], hidden=HID)
    gen = torch.Generator().manual_seed(seed)
    bb = gnn_init(cfg, gen, "cpu")
    head = G.head_init(HID, 5, "mlp", gen, "cpu")
    opt = make_optimizer("adam", lr=5e-3)
    state = G.TrainState(bb, head, None, tbl.init_table(ds.n, ds.j_max, HID),
                         0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))
    step = G.make_train_step(make_encode_fn(cfg), opt, G.VARIANTS["gst_efd"],
                             keep_prob=0.5)
    ids = np.arange(4)
    batch = to_batch(ds.seg_inputs(ids), ds.seg_valid[ids], ids,
                     ds.labels[ids], "cpu")
    return ds, step, state, batch


# ---------------------------------------------------------------------------
# capture, dedup, signatures
# ---------------------------------------------------------------------------


def test_probe_records_keyed_by_shape_signature():
    probe = P.MemoryProbe()
    P.set_probe(probe)
    reg = P.MetricsRegistry()
    P.set_registry(reg)
    f = probe_call("t.add", lambda a, b: a + b)
    x4, x8 = torch.ones(4), torch.ones(8)
    assert torch.equal(f(x4, x4), x4 + x4)
    f(x4, x4)          # same signature: counted, not measured again
    f(x8, x8)          # a new signature: a second record
    recs = {(r["site"], r["signature"]): r for r in probe.records()}
    assert len(recs) == 2
    sig4 = P.shape_signature(((x4, x4), {}))
    assert sig4 == "float32[4];float32[4]"
    r = recs[("t.add", sig4)]
    assert r["calls"] == 2 and r["mode"] == "accounting"
    assert r["cost"] is None
    assert r["temp_bytes"] == 16 and r["arg_bytes"] == 16
    assert r["peak_bytes"] == 32 and r["accounting_bound_bytes"] == 16
    assert recs[("t.add", "float32[8];float32[8]")]["temp_bytes"] == 32
    snap = reg.snapshot()
    assert snap["mem.device.peak_bytes.t.add"]["value"] > 0
    assert "mem.device.temp_bytes.t.add" in snap
    assert probe.sites() == ["t.add"]


TREES = [
    {"z": np.zeros((4, 8), np.float32),
     "a": [np.arange(3), None, 5, np.float32(1.0)],
     "m": NT(np.zeros((2,), np.int32), (np.ones((1, 1), bool),))},
    (np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int32)),
    [np.zeros((0, 5), np.int64), {"b": np.ones(7, np.uint8), "a": 1.5}],
]


@pytest.mark.parametrize("tree", TREES)
def test_signature_and_nbytes_match_jax(tree):
    assert P.shape_signature(tree) == J.shape_signature(tree)
    assert P.tree_nbytes(tree) == J.tree_nbytes(tree)
    as_torch = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                for x in (tree if isinstance(tree, tuple) else [])]
    if as_torch:      # tensors sign as JAX's arrays do: float32[2,3]
        assert P.shape_signature(tuple(as_torch)) == J.shape_signature(tree)
        assert P.tree_nbytes(tuple(as_torch)) == J.tree_nbytes(tree)


def test_null_probe_records_nothing_and_passes_attributes():
    assert not P.NullProbe().enabled and P.get_probe() is P.null_probe()

    class Step:
        tag = "step"

        def __call__(self, x):
            return x * 2

    f = probe_call("t.mul", Step())
    assert f.tag == "step" and f.site == "t.mul"
    assert torch.equal(f(torch.ones(2)), torch.full((2,), 2.0))
    assert P.get_probe().records() == []


def test_a_call_that_raises_propagates_and_leaves_no_record():
    probe = P.MemoryProbe()
    P.set_probe(probe)

    def boom(x):
        raise RuntimeError("the run's own step failed")

    with pytest.raises(RuntimeError, match="own step"):
        probe_call("t.boom", boom)(torch.ones(2))
    assert probe.records() == []


# ---------------------------------------------------------------------------
# measure the one real call
# ---------------------------------------------------------------------------


def test_train_step_with_probe_is_bitwise_the_step_without():
    _, step, state_a, batch = _train_setup()
    _, _, state_b, _ = _train_setup()
    out_a = [step(state_a, batch, epoch_generator(0, e)) for e in range(2)]
    probe = P.MemoryProbe()
    P.set_probe(probe)
    probed = probe_call("train.step", step)
    out_b = [probed(state_b, batch, epoch_generator(0, e)) for e in range(2)]
    for (sa, ma), (sb, mb) in zip(out_a, out_b):
        assert torch.equal(ma["loss"], mb["loss"])
    for a, b in zip(G.train_params(sa), G.train_params(sb)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(sa.table, sb.table))
    (rec,) = probe.records()
    assert rec["site"] == "train.step" and rec["calls"] == 2
    assert rec["mode"] == "accounting" and rec["temp_bytes"] > 0
    assert rec["accounting_bound_bytes"] <= rec["temp_bytes"]


def test_sharded_call_sums_its_shard_threads():
    """Each shard thread allocates (rank + 1) KiB it keeps until it
    returns: the record sums the two threads' peaks (the calling
    thread's own dispatch mode sees none of them)."""
    group = LocalGroup(2)

    def sharded(n):
        def shard(rank):
            x = torch.zeros(256 * (rank + 1) * n)      # (rank + 1) KiB x n
            return float(x.sum())

        return group.run(lambda i, comm: in_shard(lambda: shard(i)))

    probe = P.MemoryProbe()
    P.set_probe(probe)
    assert probe_call("dist.train_step", sharded)(1) == [0.0, 0.0]
    (rec,) = probe.records()
    assert rec["shards"] == 2 and rec["mode"] == "accounting"
    assert rec["temp_bytes"] == (1024 + 4) + (2048 + 4)   # x and its sum
    # one shard runs in the calling thread: counted once, by its mode
    rec1, _ = measure_call(lambda: LocalGroup(1).run(
        lambda i, comm: in_shard(lambda: torch.zeros(256).sum())))
    assert rec1["shards"] == 1 and rec1["temp_bytes"] == 1024 + 4
    # outside a measurement in_shard is the call itself
    assert in_shard(lambda: 7) == 7


def test_a_dispatch_mode_does_not_see_other_threads():
    mode = LiveBytes()
    kept = []
    with mode:
        t = threading.Thread(target=lambda: kept.append(torch.zeros(1024)))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and len(kept) == 1
    assert mode.peak == 0


# ---------------------------------------------------------------------------
# host gauges
# ---------------------------------------------------------------------------


def test_host_tier_gauge_is_the_snapshot_bytes():
    _, ds, _ = load_datasets("malnet", 16, 24)
    probe = P.MemoryProbe()
    P.set_probe(probe)
    P.set_registry(P.MetricsRegistry())
    store = TieredStore(ds.n, ds.j_max, HID, device_rows=4)
    try:
        table = store.init_device_table()
        table, _ = store.prepare(table, np.arange(4, dtype=np.int64))
        store.publish_counters()
        want = P.tree_nbytes(store.snapshot(table))
        assert probe.host_bytes()["store.host_tier"] == want
        assert store.host_tier_bytes() == want
        snap = P.get_registry().snapshot()
        assert snap["mem.host.store.host_tier_bytes"]["value"] == want
    finally:
        store.close()
    jstore = JTieredStore(ds.n, ds.j_max, HID, device_rows=4)
    try:
        assert jstore.host_tier_bytes() == want
    finally:
        jstore.close()


def test_feeder_staging_bytes_published():
    _, ds, _ = load_datasets("malnet", 16, 24)
    probe = P.MemoryProbe()
    P.set_probe(probe)
    P.set_registry(P.MetricsRegistry())
    sched = [np.arange(4, dtype=np.int64)]
    for feeder in (DP.SyncSegmentFeeder(ds, sched, lambda h: h),
                   DP.AsyncSegmentFeeder(ds, sched, lambda h: h)):
        (batch,) = list(feeder)
        assert probe.host_bytes()["feeder.staging"] == P.tree_nbytes(batch)


# ---------------------------------------------------------------------------
# the Obs lifecycle
# ---------------------------------------------------------------------------


def test_memory_event_written_before_the_summary(tmp_path):
    out = str(tmp_path / "obs.jsonl")
    obs = P.Obs(mem_probe=True, metrics_out=out)
    assert P.get_probe() is obs.probe
    probe_call("t.sq", lambda x: x * x)(torch.ones(4))
    obs.close()
    assert P.get_probe() is P.null_probe()
    records = [json.loads(line) for line in Path(out).read_text().splitlines()]
    assert [r["type"] for r in records] == ["event", "summary"]
    mem = records[0]
    assert mem["event"] == "memory"
    assert [r["site"] for r in mem["records"]] == ["t.sq"]
    assert mem["records"][0]["mode"] == "accounting"
    assert sorted(mem) == sorted(
        ["type", "event", "wall_s"] + list(J.NullProbe().snapshot()))
    assert "mem.device.peak_bytes.t.sq" in records[-1]["metrics"]


# ---------------------------------------------------------------------------
# the streaming encoder's constant memory
# ---------------------------------------------------------------------------


def test_streaming_flat_across_chunk_counts_and_bounded():
    cfg = GNNConfig(backbone="sage", n_feat=8, hidden=HID)
    gen = torch.Generator().manual_seed(0)
    params = gnn_init(cfg, gen, "cpu")
    head = G.head_init(HID, 5, "mlp", gen, "cpu")
    spec = BucketSpec(m_max=16, e_max=64, batch=4)
    small = D.make_malnet_like(n_graphs=1, comm_range=(3, 4),
                               comm_size_range=(14, 16), seed=4)[0]
    big = D.make_malnet_like(n_graphs=1, comm_range=(10, 11),
                             comm_size_range=(14, 16), seed=3)[0]
    stream = make_stream_encoder(cfg)
    bounds, temps, counts = [], [], []
    for g in (small, big):
        chunks = graph_to_chunks(g, spec, 4)
        counts.append(chunks["seg_valid"].shape[0])
        args = (params, head, chunks, "cpu")
        bounds.append(max_intermediate_bytes(stream, *args))
        rec, _ = measure_call(stream, args)
        temps.append(rec["temp_bytes"])
    assert counts[1] > counts[0] >= 1
    assert bounds[0] == bounds[1] and temps[0] == temps[1]
    assert temps[0] >= bounds[0]
    flat = {k: torch.from_numpy(np.ascontiguousarray(
        chunks[k].reshape((-1,) + chunks[k].shape[2:]))) for k in SEG_KEYS}
    with torch.no_grad():
        one_shot = max_intermediate_bytes(encode_segments, params, cfg, flat)
    assert bounds[1] < one_shot


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def test_quick_sweep_passes_both_gates(tmp_path):
    from repro.obs import gate as jgate
    from repro_torch.obs import gate as pgate
    from repro_torch.obs import memory_sweep

    out = str(tmp_path / "gst_memory.json")
    # one intra-op thread: the sweep's ops are small, and on a loaded host
    # contention between threads, not the work, sets its time
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        entry = memory_sweep.main(["--quick", "--device", "cpu", "--out",
                                   out], log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)
    s = entry["summary"]
    assert s["full_temp_ratio_max_over_min"] >= 2.0
    assert s["gst_temp_ratio_max_over_min"] <= 1.25
    assert s["streaming_temp_ratio_max_over_min"] == 1.0
    assert s["streaming_bound_ok"] and s["ladder_total_peak_bytes"] > 0
    assert [p["comm"] for p in entry["gst_step"]] == [2, 4, 8]
    assert all(p["mode"] == "accounting" for p in entry["full_step"])
    assert entry["env"]["backend"] == "cpu"
    payload = json.loads(Path(out).read_text())
    assert payload["benchmark"] == "gst_memory"
    (key,) = payload["runs"]
    assert "torch=" in key and "device_kind=cpu" in key
    argv = ["--memory-json", out]
    assert jgate.main(argv) == 0 and pgate.main(argv) == 0
