"""The port's tiered embedding store (src/repro_torch/store/tiered.py) on the
CPU, against its device-resident store and against the JAX package's
TieredStore (src/repro/store/).

The contract of the reference's own tests (tests/test_store.py): a store
that holds about 10% of the rows on the device is invisible to the math,
a slot holding its row's (emb, age, initialized) triple bit for bit, so:

  * all 7 GST variants train BITWISE like the DeviceStore, through
    ``run_experiment`` and step by step (snapshots, parameters, losses),
    refresh and finetune included, and through the 4-shard thread group;
  * against JAX's TieredStore: the same begins hand out the same slots and
    evict the same rows under lru and stale-first, with equal counters and
    snapshots; train steps through both stores agree at the train-step
    parity tolerances (tests/test_torch_train.py), ages and flags bitwise;
  * checkpoints round-trip and resume bitwise, also with a write-back in
    flight; the serving cache and engine over a capped store give the
    uncapped predictions bitwise;
  * commit order, capacity exhaustion before any mutation, a failed
    write-back raising, the delta gate and the forecaster as JAX's.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (Pair, assert_tables_match, batches,  # noqa: E402
                           copy_jax_state, jax_batch, jax_draws, port_batch)
from repro.core import embedding_table as jtbl  # noqa: E402
from repro.graphs.experiment import run_experiment as jax_run  # noqa: E402
from repro.store import RowForecaster as JRowForecaster  # noqa: E402
from repro.store import TieredStore as JTieredStore  # noqa: E402
from repro.store import delta_gate as jdelta_gate  # noqa: E402
from repro_torch.checkpoint import (load_store_checkpoint,  # noqa: E402
                                   save_store_checkpoint)
from repro_torch.core import embedding_table as tbl  # noqa: E402
from repro_torch.core import gst as G  # noqa: E402
from repro_torch.dist import pipeline as DP  # noqa: E402
from repro_torch.dist import train as DT  # noqa: E402
from repro_torch.dist.comm import LocalGroup  # noqa: E402
from repro_torch.graphs import data as D  # noqa: E402
from repro_torch.graphs.experiment import run_experiment  # noqa: E402
from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve.cache import SegmentCache  # noqa: E402
from repro_torch.store import (AsyncHostWriter, DeviceStore,  # noqa: E402
                               RowForecaster, TieredStore, delta_gate,
                               rows_per_shard)

HID = 8


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _as_tensor(x):
    return x.detach() if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.asarray(x))


def _bitwise(a, b):
    return all(torch.equal(_as_tensor(x), _as_tensor(y))
               for x, y in zip(a, b))


@pytest.fixture(scope="module")
def dataset():
    graphs = D.make_malnet_like(n_graphs=48, seed=0)
    return DP.segment_dataset_shared(graphs, 16, seed=0)[0]


def _model(ds, seed=0):
    cfg = GNNConfig(backbone="sage", n_feat=ds.x.shape[-1], hidden=HID)
    gen = torch.Generator().manual_seed(seed)
    bb = gnn_init(cfg, gen, "cpu")
    head = G.head_init(HID, 5, "mlp", gen, "cpu")
    opt = make_optimizer("adam", lr=5e-3)
    st = G.TrainState(bb, head, None, tbl.init_table(ds.n, ds.j_max, HID), 0)
    return make_encode_fn(cfg), opt, st._replace(
        opt_state=opt.init(G.train_params(st)))


def _fresh(ds, table):
    """The model of ``_model`` (the same weights each call), on ``table``."""
    enc, opt, st = _model(ds)
    return enc, opt, st._replace(table=table)


def _batch(ds, ids, slots=None):
    b = DP._assemble(ds, np.asarray(ids))
    ids = b.graph_ids if slots is None else slots
    return G.GSTBatch({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in b.seg_inputs.items()},
                      torch.from_numpy(b.seg_valid), _t(ids),
                      torch.from_numpy(b.labels))


def _spread_batches(n, num_shards, batch, steps):
    """Id schedules whose rows spread evenly over the shards, each batch
    faulting fresh rows (tests/test_store.py's)."""
    R = rows_per_shard(n, num_shards)
    per = batch // num_shards
    out = []
    for t in range(steps):
        ids = [min(s * R + (t * per + j) % R, n - 1)
               for s in range(num_shards) for j in range(per)]
        assert len(set(ids)) == len(ids)
        out.append(np.asarray(ids, np.int64))
    return out


def _params(st):
    return [p.detach() for p in G.train_params(st)]


# ---------------------------------------------------------------------------
# one device: ~10% of the rows resident == the device-resident store
# ---------------------------------------------------------------------------


RUN = dict(n_graphs=48, max_seg_nodes=24, hidden=HID, batch_size=4,
           epochs=2, finetune_epochs=1, device="cpu")


@pytest.mark.parametrize("variant", list(G.VARIANTS))
def test_run_experiment_capped_is_bitwise_uncapped(variant):
    """run_experiment with 4 of 36 training rows on the device (11%):
    per-epoch losses, train and test metrics and the final table bit for
    bit, finetune included."""
    a = run_experiment(variant=variant, **RUN)
    b = run_experiment(variant=variant, table_device_rows=4, **RUN)
    assert (a.epoch_losses, a.train_metric, a.test_metric, a.finetuned) == \
        (b.epoch_losses, b.train_metric, b.test_metric, b.finetuned)
    assert _bitwise(a.table, b.table) and a.table.emb.shape[0] == 36
    st = b.store_stats
    assert st["backend"] == "TieredStore" and st["device_rows"] == 4
    assert st["n_rows"] == 36 and st["evictions"] > 0
    assert st["hits"] + st["misses"] == st["lookups"]


@pytest.mark.parametrize("policy", ["lru", "stale-first"])
def test_run_experiment_capped_aged_is_bitwise_uncapped(policy):
    """Aged SED (λ 0.05, the ages read from the capped table) with 4 of 36
    training rows on the device, under either eviction policy: per-epoch
    losses, metrics and the final table bitwise the uncapped aged run."""
    kw = dict(variant="gst_efd", sed_age_weighting=0.05, **RUN)
    a = run_experiment(**kw)
    b = run_experiment(table_device_rows=4, evict_policy=policy, **kw)
    assert (a.epoch_losses, a.train_metric, a.test_metric, a.finetuned) == \
        (b.epoch_losses, b.train_metric, b.test_metric, b.finetuned)
    assert _bitwise(a.table, b.table)
    st = b.store_stats
    assert st["evict_policy"] == policy and st["evictions"] > 0
    assert int(a.table.age.max()) > 0


@pytest.mark.parametrize("variant", list(G.VARIANTS))
def test_tiered_train_steps_bitwise_all_variants(dataset, variant):
    ds = dataset
    B, steps = 4, 6
    cap = max(-(-ds.n // 10), B)          # ~10% of rows, >= one batch
    assert cap < ds.n // 2
    var = G.VARIANTS[variant]
    scheds = _spread_batches(ds.n, 1, B, steps)

    dense = DeviceStore(ds.n, ds.j_max, HID)
    enc, opt, s1 = _fresh(ds, dense.init_device_table())
    step = G.make_train_step(enc, opt, var, keep_prob=0.5)
    g1 = torch.Generator().manual_seed(3)
    for ids in scheds:
        s1, m1 = step(s1, _batch(ds, ids), g1)

    store = TieredStore(ds.n, ds.j_max, HID, device_rows=cap)
    _, _, s2 = _fresh(ds, store.init_device_table())
    step = G.make_train_step(enc, opt, var, keep_prob=0.5)
    g2 = torch.Generator().manual_seed(3)
    for t, ids in enumerate(scheds):
        table, slots = store.prepare(s2.table, ids, step=t)
        s2 = s2._replace(table=table)
        s2, m2 = step(s2, _batch(ds, ids, slots), g2)

    assert _bitwise(dense.snapshot(s1.table), store.snapshot(s2.table))
    assert _bitwise(_params(s1), _params(s2))
    assert float(m1["loss"]) == float(m2["loss"])
    if var.use_table:
        assert store.counters.evictions > 0
    store.close()


def test_tiered_refresh_and_finetune_bitwise(dataset):
    """Algorithm 2's refresh and head-finetune steps through the store."""
    ds = dataset
    B = 4
    cap = max(-(-ds.n // 10), B)
    scheds = _spread_batches(ds.n, 1, B, 12)   # covers every row
    enc = _model(ds)[0]
    refresh = G.make_refresh_step(enc)
    ft_opt = make_optimizer("adam", lr=1e-3)
    ft = G.make_finetune_step(ft_opt)

    def run(store):
        _, _, s = _fresh(ds, store.init_device_table())
        for t, ids in enumerate(scheds):
            table, slots = store.prepare(s.table, ids, step=t)
            s = refresh(s._replace(table=table), _batch(ds, ids, slots))
        s = s._replace(opt_state=ft_opt.init(list(s.head.parameters())))
        for ids in scheds[:4]:
            table, slots = store.prepare(s.table, ids)
            s, m = ft(s._replace(table=table), _batch(ds, ids, slots))
        return s, m

    dense = DeviceStore(ds.n, ds.j_max, HID)
    store = TieredStore(ds.n, ds.j_max, HID, device_rows=cap)
    s1, m1 = run(dense)
    s2, m2 = run(store)
    assert _bitwise(dense.snapshot(s1.table), store.snapshot(s2.table))
    assert _bitwise(list(s1.head.parameters()), list(s2.head.parameters()))
    assert float(m1["loss"]) == float(m2["loss"])
    assert store.counters.evictions > 0
    store.close()


# ---------------------------------------------------------------------------
# against the JAX package's TieredStore
# ---------------------------------------------------------------------------


def test_run_experiment_capped_matches_jax_capped():
    """Both packages' run_experiment with 4 device rows, JAX's weights and
    draws replayed into the port (tests/test_torch_experiment.py): train
    and test metrics within 1e-4, the same residency counters."""
    from test_torch_experiment import SMALL, _jax_weights

    kw = dict(dataset="malnet", backbone="sage", variant="gst_efd",
              table_device_rows=4, **SMALL)
    want = jax_run(**kw)
    got = run_experiment(
        device="cpu", weights=_jax_weights("malnet", "sage", SMALL["hidden"]),
        draws=lambda epoch, step, sv: jax_draws(jax.random.key(epoch), step,
                                                sv, 1), **kw)
    np.testing.assert_allclose(got.train_metric, want.train_metric,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.test_metric, want.test_metric,
                               rtol=1e-4, atol=1e-4)
    for k in ("lookups", "hits", "misses", "evictions", "bytes_h2d",
              "bytes_d2h"):
        assert got.store_stats[k] == want.store_stats[k], k
    assert got.store_stats["evictions"] > 0


def test_tiered_train_steps_match_jax_tiered_steps():
    """Train steps through each package's TieredStore (4 of 16 rows on the
    device) from the same state, JAX's draws replayed: the same slots each
    step; loss 1e-4; the device tier's emb 1e-5, ages and flags bitwise;
    at the end the snapshots' ages and flags bitwise, emb 1e-5."""
    ds, tups = batches("malnet", n_graphs=16)
    pair = Pair("malnet", "sage", n_table=ds.n, j_max=ds.j_max)
    jstep, step = pair.steps("gst_efd")
    jstore = JTieredStore(ds.n, ds.j_max, 16, device_rows=4)
    store = TieredStore(ds.n, ds.j_max, 16, device_rows=4)
    js = pair.jstate._replace(table=jstore.init_device_table())
    st = pair.state._replace(table=store.init_device_table())
    rng = jax.random.key(7)
    for i, b in enumerate([0, 1, 2, 3, 0, 2, 1, 3]):
        tup = tups[b]
        jtable, jslots = jstore.prepare(js.table, tup[2], step=i)
        table, slots = store.prepare(st.table, tup[2], step=i)
        assert np.array_equal(np.asarray(jslots), slots)
        js, jm = jstep(js._replace(table=jtable),
                       jax_batch(tup)._replace(graph_ids=jnp.asarray(jslots)),
                       rng)
        st, m = step(st._replace(table=table),
                     port_batch(tup)._replace(graph_ids=_t(slots)),
                     draws=jax_draws(rng, i, tup[1], 1))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, atol=1e-5)
        assert_tables_match(js.table, st.table)
        st = copy_jax_state(js, st)
    want, got = jstore.snapshot(js.table), store.snapshot(st.table)
    np.testing.assert_array_equal(got.age.numpy(), np.asarray(want.age))
    np.testing.assert_array_equal(got.initialized.numpy(),
                                  np.asarray(want.initialized))
    np.testing.assert_allclose(got.emb.numpy(), np.asarray(want.emb),
                               rtol=1e-5, atol=1e-5)
    assert store.counters.evictions == jstore.counters.evictions > 0
    jstore.close()
    store.close()


@pytest.mark.parametrize("num_shards", [1, 2])
@pytest.mark.parametrize("policy", ["lru", "stale-first"])
def test_same_begins_evict_the_same_rows_as_jax(policy, num_shards):
    """The same begin row ids and step hints (read-only begins among them,
    refresh_ages every 20 steps) and the same writes through both
    packages' stores: the same slots every step, the same counters, and
    bitwise equal snapshots."""
    rng = np.random.default_rng(5)
    n, J, d, cap = 24, 2, 4, 6
    jstore = JTieredStore(n, J, d, device_rows=cap, num_shards=num_shards,
                          evict_policy=policy)
    store = TieredStore(n, J, d, device_rows=cap, num_shards=num_shards,
                        evict_policy=policy)
    jtable = jstore.init_device_table()
    tables = store.init_shard_tables()
    C, R = store.device_rows_per_shard, store.rows_per_shard
    for t in range(60):
        ids = np.concatenate([
            rng.choice(np.arange(s * R, min((s + 1) * R, n)),
                       int(rng.integers(1, C + 1)), replace=False)
            for s in range(num_shards)])
        hint = None if t % 7 == 3 else t
        jtable, jslots = jstore.prepare(jtable, ids, step=hint)
        tables, slots = store.prepare(tables, ids, step=hint)
        assert np.array_equal(np.asarray(jslots), slots), t
        h = rng.normal(size=(len(ids), 1, d)).astype(np.float32)
        sidx = rng.integers(0, J, (len(ids), 1))
        if hint is not None:
            jtable = jtbl.update_sampled(jtable, jnp.asarray(slots),
                                         jnp.asarray(sidx, jnp.int32),
                                         jnp.asarray(h), t)
            for k, s in enumerate(slots):
                tbl.update_sampled(tables[s // C], _t([s % C]),
                                   _t(sidx[k:k + 1]),
                                   torch.from_numpy(h[k:k + 1]), t)
        if t % 20 == 19:
            jstore.refresh_ages(jtable)
            store.refresh_ages(tables)
    jstore.flush_writebacks()
    store.flush_writebacks()
    want, got = jstore.counters.as_dict(), store.counters.as_dict()
    for k in ("lookups", "hits", "misses", "evictions", "bytes_h2d",
              "bytes_d2h"):
        assert got[k] == want[k], k
    assert got["evictions"] > 20
    assert _bitwise(jstore.snapshot(jtable), store.snapshot(tables))
    jstore.close()
    store.close()


def test_delta_gate_and_forecaster_match_jax():
    """delta_gate and RowForecaster give the JAX package's numbers on the
    same numpy inputs (the port keeps its own copy of both)."""
    rng = np.random.default_rng(0)
    n, J, d = 10, 3, 4
    old = rng.normal(size=(n, J, d)).astype(np.float32)
    new = old + rng.normal(size=old.shape).astype(np.float32) * \
        rng.choice([0.0, 0.01, 1.0], size=(n, 1, 1)).astype(np.float32)
    init_old = rng.random((n, J)) < 0.8
    init_new = init_old | (rng.random((n, J)) < 0.2)
    for thr in (0.0, 0.05, 0.5):
        np.testing.assert_array_equal(
            delta_gate(new, old, init_new, init_old, thr),
            jdelta_gate(new, old, init_new, init_old, thr))
    fc, jfc = RowForecaster(n, J, d), JRowForecaster(n, J, d)
    for t in range(4):
        rows = rng.choice(n, 5, replace=False)
        age_old = rng.integers(0, 5, (5, J)).astype(np.int32)
        age_new = age_old + rng.integers(0, 4, (5, J)).astype(np.int32)
        args = (rows, new[rows] * (t + 1), old[rows], age_new, age_old,
                init_new[rows], init_old[rows])
        fc.observe(*args)
        jfc.observe(*args)
        apply = (rows, old[rows], age_old, init_old[rows], 9)
        np.testing.assert_array_equal(fc.apply(*apply), jfc.apply(*apply))
    assert fc.stats() == jfc.stats() and fc.stats()["forecast_rows"] > 0


# ---------------------------------------------------------------------------
# four shards as threads: each shard's table a tiered slice
# ---------------------------------------------------------------------------


def _dist_run(ds, var, scheds, *, device_rows, exchange="ring",
              payload="f32"):
    enc, opt, st = _model(ds)
    ctx = DT.make_context(LocalGroup(4), ds.n, device_rows,
                          exchange=exchange, exchange_cap=8,
                          payload_dtype=payload)
    store = DT.make_dist_store(ctx, ds.j_max, HID)
    step = DT.make_dist_train_step(enc, opt, var, ctx=ctx, keep_prob=0.5)
    states = DT.device_state(ctx, st, store=store)
    gens = [torch.Generator().manual_seed(3) for _ in range(4)]
    losses = []
    for t, ids in enumerate(scheds):
        prep = store.begin(ids, step=t)
        batches = DT.shard_batch(ctx, DP._assemble(ds, ids)._replace(
            graph_ids=prep.slots))
        tables = store.commit([s.table for s in states], prep)
        states = [s._replace(table=tb) for s, tb in zip(states, tables)]
        states, m = step(states, batches, gens)
        losses.append(float(m["loss"]))
    snap = DT.host_table(ctx, states, store=store)
    store.close()
    return ctx, store, states, losses, snap


@pytest.mark.parametrize("variant", list(G.VARIANTS))
def test_four_shard_tiered_steps_bitwise_uncapped(dataset, variant):
    """Four shard threads, ring at f32, each shard's device tier two rows
    (one batch's share): losses, replicas' parameters and the merged
    table bitwise the uncapped run's; the exchange routes slot ids."""
    ds = dataset
    var = G.VARIANTS[variant]
    scheds = _spread_batches(ds.n, 4, 8, 5)
    _, _, s1, l1, t1 = _dist_run(ds, var, scheds, device_rows=None)
    ctx, store, s2, l2, t2 = _dist_run(ds, var, scheds, device_rows=8)
    assert ctx.table_rows == 2 and ctx.rows_per_shard == 12
    assert isinstance(store, TieredStore)
    assert l1 == l2
    assert _bitwise(t1, t2)
    for a, b in zip(s1, s2):
        assert _bitwise(_params(a), _params(b))
    if var.use_table:
        assert store.counters.evictions > 0


@pytest.mark.parametrize("exchange,payload", [("ring", "int8"),
                                              ("bucketed", "bf16"),
                                              ("alltoall", "int8")])
def test_four_shard_tiered_compressed_bitwise_uncapped(dataset, exchange,
                                                       payload):
    ds = dataset
    var = G.VARIANTS["gst_efd"]
    scheds = _spread_batches(ds.n, 4, 8, 5)
    _, _, _, l1, t1 = _dist_run(ds, var, scheds, device_rows=None,
                                exchange=exchange, payload=payload)
    _, _, _, l2, t2 = _dist_run(ds, var, scheds, device_rows=8,
                                exchange=exchange, payload=payload)
    assert l1 == l2 and _bitwise(t1, t2)


def test_dist_context_table_rows():
    dense = DT.make_context(LocalGroup(1), 40)
    assert dense.table_rows == dense.rows_per_shard == 40
    assert isinstance(DT.make_dist_store(dense, 2, 4), DeviceStore)
    tiered = DT.make_context(LocalGroup(1), 40, 8)
    assert tiered.table_rows == 8 and tiered.rows_per_shard == 40
    store = DT.make_dist_store(tiered, 2, 4)
    assert isinstance(store, TieredStore)
    store.close()


def test_per_process_stores_hand_out_the_same_slots():
    """A store holding one shard (one process of a torchrun group) makes
    the same residency decisions as one holding every shard, and its
    commits write its own table as the all-shards store writes that
    shard's."""
    rng = np.random.default_rng(2)
    n, J, d = 16, 1, 2
    whole = TieredStore(n, J, d, device_rows=4, num_shards=2)
    parts = [TieredStore(n, J, d, device_rows=4, num_shards=2,
                         local_shards=[s]) for s in (0, 1)]
    t_whole = whole.init_shard_tables()
    t_parts = [p.init_shard_tables([s])[0] for s, p in enumerate(parts)]
    for t in range(30):
        ids = np.concatenate([rng.choice(8, 2, replace=False),
                              8 + rng.choice(8, 2, replace=False)])
        t_whole, slots = whole.prepare(t_whole, ids, step=t)
        for s, p in enumerate(parts):
            t_parts[s], ps = p.prepare(t_parts[s], ids, step=t)
            assert np.array_equal(ps, slots)
        h = torch.from_numpy(rng.normal(size=(4, 1, d)).astype(np.float32))
        for k, sl in enumerate(slots):
            for tb in (t_whole[sl // 2], t_parts[sl // 2]):
                tbl.update_sampled(tb, _t([sl % 2]), _t([[0]]), h[k:k + 1],
                                   t)
    for s in (0, 1):
        parts[s].flush_writebacks()
        whole.flush_writebacks()
        assert _bitwise(t_parts[s], t_whole[s])
        assert _bitwise(parts[s]._host[s], whole._host[s])
    with pytest.raises(ValueError, match="every shard"):
        parts[0].snapshot(t_parts[0])
    for st in (whole, *parts):
        st.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["device", "tiered"])
def test_checkpoint_roundtrip_resumes_bitwise(dataset, backend, tmp_path):
    ds = dataset
    B = 4
    scheds = _spread_batches(ds.n, 1, B, 6)

    def make_store():
        if backend == "tiered":
            return TieredStore(ds.n, ds.j_max, HID, device_rows=B + 1)
        return DeviceStore(ds.n, ds.j_max, HID)

    def run(store, state, step, sched, t0):
        for t, ids in enumerate(sched):
            table, slots = store.prepare(state.table, ids, step=t0 + t)
            state, _ = step(state._replace(table=table),
                            _batch(ds, ids, slots),
                            torch.Generator().manual_seed(t0 + t))
        return state

    ref_store = make_store()
    enc, opt, s = _fresh(ds, ref_store.init_device_table())
    step = G.make_train_step(enc, opt, G.VARIANTS["gst_efd"], keep_prob=0.5)
    ref = run(ref_store, s, step, scheds, 0)

    st1 = make_store()
    _, _, s = _fresh(ds, st1.init_device_table())
    s = run(st1, s, step, scheds[:3], 0)
    extra = {"backbone": s.backbone.state_dict(),
             "head": s.head.state_dict(), "mu": s.opt_state["mu"],
             "nu": s.opt_state["nu"], "count": s.opt_state["step"],
             "step": s.step}
    path = save_store_checkpoint(str(tmp_path), 3, st1, s.table, extra=extra)
    st1.close()

    st2 = make_store()
    (table,), got = load_store_checkpoint(path, st2, extra_like=extra)
    _, _, r = _fresh(ds, table)
    r.backbone.load_state_dict(got["backbone"])
    r.head.load_state_dict(got["head"])
    r = r._replace(opt_state=dict(r.opt_state, mu=got["mu"], nu=got["nu"],
                                  step=got["count"]), step=got["step"])
    r = run(st2, r, step, scheds[3:], 3)
    assert _bitwise(ref_store.snapshot(ref.table), st2.snapshot(r.table))
    assert _bitwise(_params(ref), _params(r))
    ref_store.close()
    st2.close()


def test_checkpoint_with_pending_writebacks_flushes_and_resumes(tmp_path):
    """Saving while the write-back lane still holds an eviction: snapshot
    flushes it first, the file carries the evicted row, and the resumed
    run ends bitwise where the uninterrupted one does."""
    n, J, d = 6, 1, 4
    vals = np.random.default_rng(11).normal(size=(32, 1, 1, d)).astype(
        np.float32)
    sched = [0, 1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5]   # C = 2: constant churn
    z = torch.zeros((1, 1), dtype=torch.long)

    def run(store, table, oracle, steps):
        for t in steps:
            table, slots = store.prepare(table, np.asarray([sched[t]]))
            tbl.update_sampled(table, _t(slots), z,
                               torch.from_numpy(vals[t]), t)
            tbl.update_sampled(oracle, _t([sched[t]]), z,
                               torch.from_numpy(vals[t]), t)
        return table, oracle

    ref = TieredStore(n, J, d, device_rows=2)
    ref_table, oracle = run(ref, ref.init_device_table(),
                            tbl.init_table(n, J, d), range(len(sched)))

    st1 = TieredStore(n, J, d, device_rows=2)
    table1, _ = run(st1, st1.init_device_table(), tbl.init_table(n, J, d),
                    range(6))
    gate = threading.Event()
    st1._writer.submit(lambda: gate.wait(timeout=10.0))
    table1, _ = st1.prepare(table1, np.asarray([sched[6]]))   # evicts
    assert st1._writer.pending >= 1
    threading.Timer(0.2, gate.set).start()
    path = save_store_checkpoint(str(tmp_path), 6, st1, table1)
    assert st1._writer.pending == 0
    st1.close()

    st2 = TieredStore(n, J, d, device_rows=2)
    (table2,), _ = load_store_checkpoint(path, st2)
    table2, _ = run(st2, table2, tbl.init_table(n, J, d),
                    range(6, len(sched)))
    snap = st2.snapshot(table2)
    assert _bitwise(ref.snapshot(ref_table), snap)
    assert _bitwise(snap, oracle)
    ref.close()
    st2.close()


def test_checkpoint_files_rotate_and_reserve_table(tmp_path):
    from repro_torch.checkpoint import (latest_checkpoint, load_checkpoint,
                                       save_checkpoint)

    tree = {"a": torch.arange(3), "b": [np.ones(2, np.float32), 4]}
    for step in range(5):
        save_checkpoint(str(tmp_path), step, tree, keep=3)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"step_{i:08d}.ckpt" for i in (2, 3, 4)]
    back = load_checkpoint(latest_checkpoint(str(tmp_path)), tree)
    assert torch.equal(back["a"], tree["a"]) and back["b"][1] == 4
    assert np.array_equal(back["b"][0], tree["b"][0])
    store = DeviceStore(4, 1, 2)
    with pytest.raises(ValueError, match="reserved"):
        save_store_checkpoint(str(tmp_path), 9, store,
                              store.init_device_table(), extra={"table": 1})


# ---------------------------------------------------------------------------
# serving over a capped store
# ---------------------------------------------------------------------------


def test_serve_cache_over_tiered_store_bitwise():
    """Entries spilled to the host tier fault back bit for bit; the keying
    layer's capacity is the rows of both tiers."""
    rng = np.random.default_rng(0)
    store = TieredStore(32, 1, HID, device_rows=8)
    cache = SegmentCache(32, HID, store=store)
    keys = [bytes([i]) * 4 for i in range(24)]
    embs = torch.from_numpy(rng.normal(size=(24, HID)).astype(np.float32))
    for i in range(0, 24, 6):
        cache.put(keys[i:i + 6], embs[i:i + 6])
    assert len(cache) == 24 and store.occupancy() == 8
    slots = [cache.get(k) for k in keys]
    assert torch.equal(cache.gather(slots[:8]), embs[:8])
    assert torch.equal(cache.gather(slots), embs)     # wider than the tier
    assert store.counters.evictions > 0
    assert cache.stats()["store"]["backend"] == "TieredStore"
    assert cache.gather([]).shape == (0, HID)
    cache.close()


def test_cache_over_trainer_shaped_store_and_flush():
    rng = np.random.default_rng(0)
    store = TieredStore(16, 3, HID, device_rows=4)
    cache = SegmentCache(16, HID, store=store)
    keys = [bytes([i]) * 4 for i in range(12)]
    embs = torch.from_numpy(rng.normal(size=(12, HID)).astype(np.float32))
    for i in range(0, 12, 4):
        cache.put(keys[i:i + 4], embs[i:i + 4])
    slots = [cache.get(k) for k in keys]
    assert torch.equal(cache.gather(slots[:4]), embs[:4])
    assert store.counters.evictions > 0
    cache.flush()
    assert len(cache) == 0 and store.occupancy() == 0
    cache.put([keys[0]], embs[:1])
    assert torch.equal(cache.gather([cache.get(keys[0])]), embs[:1])
    cache.close()


@pytest.mark.parametrize("policy", ["lru", "stale-first"])
def test_serve_engine_with_device_row_cap_matches_uncapped(policy):
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.traffic import TrafficConfig, make_request_stream

    tc = TrafficConfig(n_unique=6, n_requests=12, duplicate_rate=0.5,
                       comm_range=(2, 5), comm_size_range=(8, 20), seed=3)
    stream = make_request_stream(tc)

    def engine(rows):
        return ServeEngine(ServeConfig(
            backbone="sage", hidden=32, max_seg_nodes=32, cache_capacity=128,
            stream_chunk=4, table_device_rows=rows, evict_policy=policy,
            device="cpu"), seed=0)

    full, capped = engine(None), engine(8)
    p1 = full.process(stream, window=4)
    p2 = capped.process(stream, window=4)
    for a, b in zip(p1, p2):
        assert np.array_equal(a.pred, b.pred)
    st = capped.stats.summary()["cache"]["store"]
    assert st["backend"] == "TieredStore" and st["evictions"] > 0
    assert st["evict_policy"] == policy
    full.close()
    capped.close()


# ---------------------------------------------------------------------------
# the migration machinery
# ---------------------------------------------------------------------------


def test_pending_writeback_blocks_refetch():
    """Evict a row and fault it straight back: the fetch waits for the
    write-back, so the host tier is never read stale."""
    rng = np.random.default_rng(0)
    store = TieredStore(4, 1, 4, device_rows=1)
    table = store.init_device_table()
    vals = {}
    z = torch.zeros((1, 1), dtype=torch.long)
    for t, row in enumerate([0, 1, 0, 1, 0, 1]):
        table, slots = store.prepare(table, np.asarray([row]))
        v = torch.from_numpy(rng.normal(size=(1, 1, 4)).astype(np.float32))
        vals[row] = v
        tbl.update_sampled(table, _t(slots), z, v, t)
        other = 1 - row
        if other in vals:
            table, oslots = store.prepare(table, np.asarray([other]))
            assert torch.equal(tbl.lookup(table, _t(oslots))[0], vals[other])
            table, slots = store.prepare(table, np.asarray([row]))
    assert store.counters.evictions >= 4
    store.close()


def test_async_writer_propagates_thunk_errors():
    w = AsyncHostWriter()

    def boom():
        raise RuntimeError("writeback exploded")

    w.submit(boom)
    with pytest.raises(RuntimeError, match="writeback exploded"):
        w.flush()
    w.close()


def test_commit_order_enforced():
    store = TieredStore(8, 1, 2, device_rows=2)
    table = store.init_device_table()
    p1 = store.begin(np.asarray([0]))
    p2 = store.begin(np.asarray([1]))
    with pytest.raises(RuntimeError, match="commit order"):
        store.commit(table, p2)
    with pytest.raises(RuntimeError, match="uncommitted"):
        store.snapshot(table)
    table = store.commit(table, p1)
    store.commit(table, p2)
    store.close()


def test_capacity_exhaustion_raises_before_mutating():
    store = TieredStore(8, 1, 2, device_rows=2)
    with pytest.raises(RuntimeError, match="device tier exhausted"):
        store.begin(np.arange(5))
    with pytest.raises(IndexError, match="outside table"):
        store.begin(np.asarray([0, 99]))
    assert store.occupancy() == 0 and store._begin_ticket == 0
    table = store.init_device_table()
    table, slots = store.prepare(table, np.asarray([0, 1]))
    assert store.occupancy() == 2
    store.close()


def test_failed_writeback_raises_instead_of_hanging(monkeypatch):
    """A write-back that dies surfaces as an error on the next fetch of the
    evicted row instead of a wait that never ends."""
    store = TieredStore(4, 1, 2, device_rows=1)
    table = store.init_device_table()
    table, _ = store.prepare(table, np.asarray([0]))

    def broken(*a, **k):
        raise OSError("host tier unwritable")

    monkeypatch.setattr(store, "_writeback_body", broken)
    table, _ = store.prepare(table, np.asarray([1]))   # evicts row 0
    with pytest.raises(RuntimeError, match="write-back failed"):
        store.prepare(table, np.asarray([0]))          # refetch row 0
    with pytest.raises(OSError, match="unwritable"):
        store.flush_writebacks()
    store.close()


def test_delta_gate_admission_rules():
    old = np.zeros((4, 1, 3), np.float32)
    new = old.copy()
    new[0] += 0.5            # moved past the threshold
    new[1] += 0.09           # moved, but under it
    init_old = np.ones((4, 1), bool)
    init_new = init_old.copy()
    init_new[2, 0] = False   # a flag flip on an otherwise static row
    assert delta_gate(new, old, init_new, init_old, 0.1).tolist() == \
        [True, False, True, False]
    new[1] += 0.01           # at the threshold now: admitted
    assert delta_gate(new, old, init_new, init_old, 0.1).tolist() == \
        [True, True, True, False]


def test_tiered_delta_gate_skips_static_rows():
    store = TieredStore(4, 1, 4, device_rows=1, wb_threshold=0.5)
    table = store.init_device_table()
    v = torch.full((1, 1, 4), 2.0)
    z = torch.zeros((1, 1), dtype=torch.long)

    def write(table, slots, val, t):
        tbl.update_sampled(table, _t(slots), z, val, t)

    # first residency: the flag flip forces admission
    table, slots = store.prepare(table, np.asarray([0]))
    write(table, slots, v, 0)
    table, _ = store.prepare(table, np.asarray([1]))     # evicts row 0
    store.flush_writebacks()
    assert store.counters.wb_skipped_rows == 0
    assert torch.equal(store._host[0].emb[0], v[0])
    # a sub-threshold nudge skips the emb write but lands the age (and the
    # never-written row 1's eviction is skipped too: 2)
    table, slots = store.prepare(table, np.asarray([0]))
    write(table, slots, v + 0.1, 7)
    table, _ = store.prepare(table, np.asarray([1]))
    store.flush_writebacks()
    assert store.counters.wb_skipped_rows == 2
    assert store.counters.wb_skipped_bytes == 2 * 1 * 4 * 4
    assert torch.equal(store._host[0].emb[0], v[0])
    assert int(store._host[0].age[0, 0]) == 7
    # movement past the threshold is admitted
    table, slots = store.prepare(table, np.asarray([0]))
    write(table, slots, v + 3.0, 9)
    table, _ = store.prepare(table, np.asarray([1]))
    store.flush_writebacks()
    assert store.counters.wb_skipped_rows == 3
    assert torch.equal(store._host[0].emb[0], v[0] + 3.0)
    assert store.stats()["wb_threshold"] == 0.5
    store.close()


def test_tiered_gate_off_by_default_and_counts_zero():
    store = TieredStore(4, 1, 4, device_rows=1)
    assert store.wb_threshold == 0.0
    table = store.init_device_table()
    for row in [0, 1, 0, 1]:
        table, _ = store.prepare(table, np.asarray([row]))
    store.flush_writebacks()
    assert store.counters.evictions >= 2
    st = store.stats()
    assert st["wb_skipped_rows"] == st["wb_skipped_bytes"] == 0
    store.close()


def test_stale_forecast_changes_only_the_staged_upload():
    """With the forecaster on, a faulted-in stale row arrives extrapolated
    while the host tier keeps its authoritative copy; with it off the same
    run is bitwise the device-resident store."""
    n, J, d = 3, 1, 2
    z = torch.zeros((1, 1), dtype=torch.long)
    store = TieredStore(n, J, d, device_rows=1, stale_forecast=True)
    table = store.init_device_table()
    for t, (row, val) in enumerate([(0, 1.0), (1, 0.0), (0, 3.0), (1, 0.0)]):
        table, slots = store.prepare(table, np.asarray([row]), step=t)
        tbl.update_sampled(table, _t(slots), z, torch.full((1, 1, d), val), t)
    store.flush_writebacks()
    assert store.stats()["forecast"]["observed_rows"] > 0
    host = store._host[0].emb[0].clone()
    table, slots = store.prepare(table, np.asarray([0]), step=10)
    got = tbl.lookup(table, _t(slots))[0]
    assert not torch.equal(got[0], host) and torch.equal(
        store._host[0].emb[0], host)
    store.close()
