"""The port's serving path (serve/, launch/serve_graphs.py) against the JAX
package's: byte-identical datasets and cache keys, engine predictions at
atol 1e-5 (tests/test_serve.py:86,223) given the same converted weights,
cache hits, streaming, the CLI and the device rule.  On the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.graphs import batching as JB  # noqa: E402
from repro.graphs import data as JD  # noqa: E402
from repro.graphs import partition as JP  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import buckets as JBk  # noqa: E402
from repro.serve import traffic as JT  # noqa: E402
from repro_torch.core import gst as G  # noqa: E402
from repro_torch.graphs import batching as B  # noqa: E402
from repro_torch.graphs import data as D  # noqa: E402
from repro_torch.graphs import partition as P  # noqa: E402
from repro_torch.graphs.gnn import GNNConfig, gnn_init, load_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve_graphs  # noqa: E402
from repro_torch.serve import buckets as Bk  # noqa: E402
from repro_torch.serve import traffic as T  # noqa: E402
from repro_torch.serve.cache import SegmentCache  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine  # noqa: E402

HID = 16
TRAFFIC = dict(n_unique=6, n_requests=14, duplicate_rate=0.5, seed=3)


def _graph_arrays(g):
    return (g.x, g.edges, np.asarray(g.label), g.community)


# ---------------------------------------------------------------------------
# byte-identical data and keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("maker", ["make_malnet_like", "make_tpugraphs_like"])
def test_datasets_byte_identical(maker):
    kw = dict(n_graphs=8, seed=5)
    for a, b in zip(getattr(D, maker)(**kw), getattr(JD, maker)(**kw)):
        for x, y in zip(_graph_arrays(a), _graph_arrays(b)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("method", ["bfs", "louvain", "random", "vertex_cut"])
def test_partitions_and_padding_byte_identical(method):
    g = D.make_malnet_like(n_graphs=1, comm_range=(5, 6), seed=2)[0]
    segs = P.partition_graph(len(g.x), g.edges, 32, method, 1)
    jsegs = JP.partition_graph(len(g.x), g.edges, 32, method, 1)
    assert [s.tobytes() for s in segs] == [s.tobytes() for s in jsegs]
    # e_max 40 forces the edge truncation (np.random.default_rng(0) draw)
    for s in segs[:4]:
        for x, y in zip(B.pad_segment(g, s, 32, 40), JB.pad_segment(g, s, 32, 40)):
            assert x.tobytes() == y.tobytes()


def test_segment_fingerprints_and_traffic_identical():
    tc, jtc = T.TrafficConfig(**TRAFFIC), JT.TrafficConfig(**TRAFFIC)
    stream, jstream = T.make_request_stream(tc), JT.make_request_stream(jtc)
    assert [g.meta["pool_id"] for g in stream] == \
        [g.meta["pool_id"] for g in jstream]
    ladder, jladder = Bk.default_ladder(64), JBk.default_ladder(64)
    assert [(s.m_max, s.e_max, s.batch) for s in ladder] == \
        [(s.m_max, s.e_max, s.batch) for s in jladder]
    g = stream[0]
    for s in P.partition_graph(len(g.x), g.edges, 64):
        bi = Bk.choose_bucket(ladder, len(s), Bk.count_local_edges(g, s))
        assert bi == JBk.choose_bucket(jladder, len(s),
                                       JBk.count_local_edges(g, s))
        key = Bk.segment_fingerprint(Bk.pad_to_bucket(g, s, ladder[bi]), bi)
        assert key == JBk.segment_fingerprint(
            JBk.pad_to_bucket(g, s, jladder[bi]), bi)


# ---------------------------------------------------------------------------
# engine parity with JAX
# ---------------------------------------------------------------------------


def _engines(backbone):
    jeng = JServeEngine(JServeConfig(backbone=backbone, hidden=HID), seed=0)
    cfg = ServeConfig(backbone=backbone, hidden=HID, device="cpu")
    gcfg = GNNConfig(backbone=backbone, hidden=HID)
    params = load_jax_params(gnn_init(gcfg, torch.Generator(), "cpu"),
                             jax.tree_util.tree_map(np.asarray, jeng.params))
    head = load_jax_params(G.head_init(HID, cfg.n_out, "mlp", torch.Generator(),
                                       "cpu"),
                           jax.tree_util.tree_map(np.asarray, jeng.head))
    return jeng, ServeEngine(cfg, params=params, head=head)


@pytest.mark.parametrize("backbone", ["sage", "gcn"])
def test_engine_matches_jax(backbone):
    jeng, eng = _engines(backbone)
    stream = T.make_request_stream(T.TrafficConfig(**TRAFFIC))
    ops.reset_kernel_launches()
    got = eng.process(stream, window=4)
    want = jeng.process(stream, window=4)
    for a, b in zip(got, want):
        assert a.n_segments == b.n_segments and a.n_cache_hits == b.n_cache_hits
        np.testing.assert_allclose(a.pred, np.asarray(b.pred), atol=1e-5)
    s, js = eng.stats.summary(), jeng.stats.summary()
    for k in ("n_requests", "n_segments", "encode_launches", "encoded_segments"):
        assert s[k] == js[k], k
    assert s["cache"]["hits"] == js["cache"]["hits"] > 0
    assert s["kernel_launches"] == 0          # CPU tensors: the plain path


def test_metrics_and_spans_match_jax(tmp_path):
    """With metrics on, the port publishes the JAX engine's serve/store
    counters and histograms with the same values (latency values aside),
    and records the request path's spans."""
    import json

    from repro.obs import metrics as jm
    from repro_torch.obs import metrics as tm
    from repro_torch.obs import trace as tt

    jeng, eng = _engines("sage")
    stream = T.make_request_stream(T.TrafficConfig(**TRAFFIC))
    jprev, tprev = jm.set_registry(jm.MetricsRegistry()), tm.enable_metrics()
    tracer = tt.Tracer()
    prev_tracer = tt.set_tracer(tracer)
    try:
        eng.process(stream, window=4)
        jeng.process(stream, window=4)
        got, want = tm.get_registry().snapshot(), jm.get_registry().snapshot()
    finally:
        jm.set_registry(jprev)
        tm.set_registry(tprev)
        tt.set_tracer(prev_tracer)
    assert {"serve.requests", "serve.cache.hits", "store.lookups",
            "serve.prediction_staleness", "serve.latency_ms"} <= set(got)
    assert set(got) <= set(want)
    for name, snap in got.items():
        if snap["type"] == "counter":
            assert snap["value"] == want[name]["value"], name
        else:
            assert snap["count"] == want[name]["count"], name
            if name != "serve.latency_ms":
                assert snap["counts"] == want[name]["counts"], name
    names = {ev["name"] for ev in tracer.events()}
    assert names == {"serve.window", "serve.partition", "serve.encode",
                     "serve.insert", "serve.gather", "serve.head"}
    out = json.loads(open(tracer.export(str(tmp_path / "t.json"))).read())
    # the export adds one thread-name metadata ("M") event a thread seen,
    # as the reference's does
    spans = [ev for ev in out["traceEvents"] if ev["ph"] != "M"]
    meta = [ev for ev in out["traceEvents"] if ev["ph"] == "M"]
    assert len(spans) == len(tracer.events())
    assert [ev["name"] for ev in meta] == ["thread_name"] * len(
        {ev["tid"] for ev in spans})


def test_full_hit_request_adds_no_encode_and_is_bit_identical():
    eng = ServeEngine(ServeConfig(hidden=HID, device="cpu"), seed=1)
    g = T.make_graph_pool(T.TrafficConfig(n_unique=1, seed=7))[0]
    first = eng.process([g])[0]
    launches = eng.stats.encode_launches
    second = eng.process([g])[0]
    assert eng.stats.encode_launches == launches > 0
    assert second.n_cache_hits == second.n_segments
    assert np.array_equal(first.pred, second.pred)


def test_cache_hit_returns_bit_identical_rows():
    cache = SegmentCache(4, HID, device="cpu")
    embs = torch.randn(3, HID, generator=torch.Generator().manual_seed(0))
    slots = cache.put([b"a", b"b", b"c"], embs)
    assert torch.equal(cache.gather(slots), embs)
    # LRU eviction past capacity; a pinned key survives
    cache.put([b"d", b"e"], embs[:2], pinned=[b"a"])
    assert cache.peek(b"a") is not None and cache.peek(b"b") is None
    assert torch.equal(cache.gather([cache.peek(b"e")]), embs[1:2])
    with pytest.raises(RuntimeError, match="evicted"):
        SegmentCache(4, HID, device="cpu").gather([0])


@pytest.mark.parametrize("backbone", ["sage", "gps"])
def test_streaming_matches_process(backbone):
    eng = ServeEngine(ServeConfig(backbone=backbone, hidden=HID, device="cpu",
                                  stream_chunk=4), seed=2)
    g = D.make_malnet_like(n_graphs=1, comm_range=(8, 9),
                           comm_size_range=(20, 40), seed=6)[0]
    want = eng.process([g])[0].pred
    np.testing.assert_allclose(eng.predict_streaming(g), want, atol=1e-5)


# ---------------------------------------------------------------------------
# CLI and device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", ["gcn", "gps"])
def test_cli_check_parity_runs(backbone, capsys):
    s = serve_graphs.main(["--device", "cpu", "--backbone", backbone,
                           "--requests", "10", "--unique", "5",
                           "--check-parity", "--min-hit-rate", "0.0"])
    assert s["n_requests"] == 10 and s["kernel_launches"] == 0
    assert "parity            OK" in capsys.readouterr().out


def test_default_device_is_cuda_and_raises_without_a_card():
    assert ServeConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    with pytest.raises(RuntimeError, match="is_available"):
        ServeEngine(ServeConfig())
    with pytest.raises(RuntimeError, match="is_available"):
        serve_graphs.main(["--requests", "2"])


@pytest.mark.parametrize("kw", [dict(table_device_rows=16),
                                dict(wb_threshold=0.1),
                                dict(stale_forecast=True)])
def test_tiered_store_options_not_ported(kw):
    """The tiered-store options, once refused, now run (the name is kept
    from when they raised): the engine over a capped cache (16 device rows
    of 32, with the gate or the forecaster added to the cap) answers a
    replay with finite predictions, bitwise the uncapped engine's where
    the gate and the forecaster are off (a cache row is written once and
    never moves, so neither changes a fault-in here either), and its
    store counters show the tier at work."""
    from repro_torch.serve.traffic import TrafficConfig, make_request_stream

    stream = make_request_stream(TrafficConfig(
        n_unique=8, n_requests=16, duplicate_rate=0.5, comm_range=(2, 5),
        comm_size_range=(8, 20), seed=3))
    cfg = dict(backbone="sage", hidden=16, max_seg_nodes=32,
               cache_capacity=32, device="cpu")
    full = ServeEngine(ServeConfig(**cfg), seed=0)
    capped = ServeEngine(ServeConfig(**cfg, **{"table_device_rows": 16,
                                               **kw}), seed=0)
    try:
        want = full.process(stream, window=4)
        got = capped.process(stream, window=4)
        for a, b in zip(want, got):
            assert np.isfinite(b.pred).all()
            assert np.array_equal(a.pred, b.pred)
        st = capped.stats.summary()["cache"]["store"]
        assert st["backend"] == "TieredStore" and st["device_rows"] == 16
        assert st["evictions"] > 0 and st["misses"] > 0
        assert st["wb_threshold"] == kw.get("wb_threshold", 0.0)
        assert st["stale_forecast"] == kw.get("stale_forecast", False)
    finally:
        full.close()
        capped.close()
