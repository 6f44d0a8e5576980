"""The port's distributed trainer (src/repro_torch/dist/, launch/
train_dist.py) on the CPU.

  * D = 1: the distributed train, eval, refresh and finetune steps are
    BITWISE the port's single-device steps (core/gst.py), the draws made
    per row;
  * D = 4 against JAX: the reference's own shard_map train step
    (src/repro/dist/train.py) runs in a subprocess on a forced 4-device
    CPU host (the tier-1 process sees one device, tests/conftest.py);
    the port's step, from the same state and given JAX's per-row draws
    and its write-path bits, matches it per step: loss rtol 1e-4,
    gradients 1e-4 (from the Adam first moment), parameters 1e-5 where
    the gradient is above the 1e-6 noise floor (Adam's eps, see
    tests/test_torch_train.py), the table within one int8 grid step (1e-5
    at f32) with ages and flags equal; ring with int8 payloads and
    bucketed with f32;
  * the replicas stay bitwise equal across shards;
  * the feeders: async delivers the sync trace, shuts down when
    abandoned, raises the producer's error;
  * the shard group: a shard that raises fails the run instead of
    hanging the others; the kernel launch counts survive many threads;
  * ``train_dist --device cpu --devices 4`` prints identical per-epoch
    losses through the three strategies at f32;
  * two gloo processes (``ProcessGroup``) equal ``LocalGroup`` bitwise at
    D = 2.
"""
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import segment as jseg  # noqa: E402
from repro_torch.core import gst as G  # noqa: E402
from repro_torch.core.embedding_table import EmbeddingTable, init_table  # noqa: E402
from repro_torch.dist import pipeline as DP  # noqa: E402
from repro_torch.dist import train as DT  # noqa: E402
from repro_torch.dist.comm import LocalGroup  # noqa: E402
from repro_torch.dist.table import split_table  # noqa: E402
from repro_torch.graphs import data as D  # noqa: E402
from repro_torch.graphs.experiment import epoch_generator  # noqa: E402
from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn  # noqa: E402
from repro_torch.kernels.counts import LaunchCounts  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HID = 8
B1 = 0.9            # Adam's b1
NOISE_FLOOR = 1e-6  # a gradient below this is float noise around 0


@pytest.fixture(scope="module")
def dataset():
    graphs = D.make_malnet_like(n_graphs=16, seed=0)
    return DP.segment_dataset_shared(graphs, 16, seed=0)[0]


def _model(ds, seed=0):
    cfg = GNNConfig(backbone="sage", n_feat=ds.x.shape[-1], hidden=HID)
    gen = torch.Generator().manual_seed(seed)
    bb = gnn_init(cfg, gen, "cpu")
    head = G.head_init(HID, 5, "mlp", gen, "cpu")
    opt = make_optimizer("adam", lr=5e-3)
    st = G.TrainState(bb, head, None, init_table(ds.n, ds.j_max, HID), 0)
    return make_encode_fn(cfg), opt, st._replace(
        opt_state=opt.init(G.train_params(st)))


def _host_batch(ds, ids):
    return DP._assemble(ds, np.asarray(ids))


def _torch_batch(ds, ids):
    b = _host_batch(ds, ids)
    return G.GSTBatch({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in b.seg_inputs.items()},
                      torch.from_numpy(b.seg_valid),
                      torch.from_numpy(b.graph_ids.astype(np.int64)),
                      torch.from_numpy(b.labels))


def _params(st):
    return [p.detach() for p in G.train_params(st)] + \
        list(st.opt_state["mu"]) + list(st.opt_state["nu"])


def _assert_replicas_equal(states):
    for s in states[1:]:
        for a, b in zip(_params(states[0]), _params(s)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# one shard: bitwise the single-device steps
# ---------------------------------------------------------------------------


def test_one_shard_is_bitwise_the_single_device_steps(dataset):
    ds = dataset
    enc, opt, st = _model(ds)
    var = G.VARIANTS["gst_efd"]
    kw = dict(keep_prob=0.5, num_sampled=1, use_kernels=True)
    single = G.make_train_step(enc, opt, var, **kw)
    ctx = DT.make_context(LocalGroup(1), ds.n, payload_dtype="int8")
    dist = DT.make_dist_train_step(enc, opt, var, ctx=ctx, **kw)
    states = DT.device_state(ctx, st)
    gen, gens = epoch_generator(0, 0), [epoch_generator(0, 0)]
    order = [np.arange(0, 8), np.arange(8, 16), np.arange(0, 8)]
    for ids in order:
        st, m = single(st, _torch_batch(ds, ids), gen)
        states, dm = dist(states, DT.shard_batch(ctx, _host_batch(ds, ids)),
                          gens)
        assert torch.equal(m["loss"], dm["loss"])
        for a, b in zip(_params(st), _params(states[0])):
            assert torch.equal(a, b)
        for a, b in zip(st.table, DT.host_table(ctx, states)):
            assert torch.equal(a, b)
    assert states[0].step == st.step == 3

    ev = G.make_eval_step(enc, use_kernels=True)(st, _torch_batch(ds, order[1]))
    dev = DT.make_dist_eval_step(enc, ctx=ctx, use_kernels=True)(
        states, DT.shard_batch(ctx, _host_batch(ds, order[1])))
    assert torch.equal(ev["metric"], dev["metric"])

    st = G.make_refresh_step(enc)(st, _torch_batch(ds, order[1]))
    states = DT.make_dist_refresh_step(enc, ctx=ctx)(
        states, DT.shard_batch(ctx, _host_batch(ds, order[1])))
    for a, b in zip(st.table, DT.host_table(ctx, states)):
        assert torch.equal(a, b)

    ft_opt = make_optimizer("adam", lr=2.5e-3)
    st = st._replace(opt_state=ft_opt.init(list(st.head.parameters())))
    states = [s._replace(opt_state=ft_opt.init(list(s.head.parameters())))
              for s in states]
    ft = G.make_finetune_step(ft_opt, use_kernels=True)
    dft = DT.make_dist_finetune_step(ft_opt, ctx=ctx, use_kernels=True)
    for ids in order[:2]:
        st, m = ft(st, _torch_batch(ds, ids))
        states, dm = dft(states, DT.shard_batch(ctx, _host_batch(ds, ids)))
        assert torch.equal(m["loss"], dm["loss"])
    for a, b in zip(st.head.parameters(), states[0].head.parameters()):
        assert torch.equal(a, b)


def test_four_shards_keep_replicas_equal_and_kept_stale(dataset):
    """Four threads, the three strategies at int8 with the age decay on:
    after every step the four replicas are bitwise equal, the table
    shards are written by their owners only, and the launches of the
    plain path stay zero (no card)."""
    from repro_torch.kernels import ops

    ds = dataset
    ops.reset_kernel_launches()
    for exchange in ("ring", "alltoall", "bucketed"):
        enc, opt, st = _model(ds)
        ctx = DT.make_context(LocalGroup(4), ds.n, exchange=exchange,
                              exchange_cap=2, payload_dtype="int8")
        step = DT.make_dist_train_step(
            enc, opt, G.VARIANTS["gst_efd"], ctx=ctx, keep_prob=0.5,
            num_sampled=1, use_kernels=True, sed_decay=0.05)
        states = DT.device_state(ctx, st)
        gens = [epoch_generator(0, 0) for _ in range(4)]
        for ids in (np.arange(0, 8), np.arange(8, 16), np.arange(0, 8)):
            states, m = step(states, DT.shard_batch(
                ctx, _host_batch(ds, ids)), gens)
            assert np.isfinite(float(m["loss"]))
            _assert_replicas_equal(states)
        full = DT.host_table(ctx, states)
        assert bool(full.initialized.any()) and int(full.age.max()) == 2
    assert sum(ops.kernel_launches().values()) == 0


# ---------------------------------------------------------------------------
# four shards against the JAX package's shard_map step
# ---------------------------------------------------------------------------

_JAX_DIST = textwrap.dedent('''
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import dist as DT
    from repro.core import gst as G
    from repro.core.embedding_table import init_table
    from repro.dist import pipeline as DP
    from repro.graphs import data as D
    from repro.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
    from repro.optim import make_optimizer
    from repro_torch.models.common import flatten_tree

    out = {}
    graphs = D.make_malnet_like(n_graphs=16, seed=0)
    ds, _ = DP.segment_dataset_shared(graphs, 16, seed=0)
    for k in ("x", "edges", "edge_valid", "node_valid", "seg_valid",
              "labels"):
        out["ds/" + k] = getattr(ds, k)
    cfg = GNNConfig(backbone="sage", n_feat=ds.x.shape[-1], hidden=%(hid)d)
    enc = make_encode_fn(cfg)
    key = jax.random.key(0)
    bb = gnn_init(key, cfg)
    head = G.head_init(jax.random.fold_in(key, 1), %(hid)d, 5, "mlp")
    opt = make_optimizer("adam", lr=5e-3)
    rng = jax.random.PRNGKey(0)
    for exchange, dtype in (("ring", "int8"), ("bucketed", "f32")):
        state = G.TrainState(bb, head, opt.init((bb, head)),
                             init_table(ds.n, ds.j_max, %(hid)d),
                             jnp.zeros((), jnp.int32))
        ctx = DT.make_context(DT.make_dist_mesh(4), ds.n, exchange=exchange,
                              exchange_cap=2 if exchange == "bucketed"
                              else None, payload_dtype=dtype)
        step = DT.make_dist_train_step(enc, opt, G.VARIANTS["gst_efd"],
                                       ctx=ctx, keep_prob=0.5, num_sampled=1)
        st = DT.device_state(ctx, state)

        def save(i, st, m=None):
            p = f"{exchange}/{i}/"
            for name, leaf in flatten_tree(jax.device_get(
                    (st.backbone, st.head))):
                out[p + "p/" + name] = np.asarray(leaf)
            for which in ("mu", "nu"):
                for name, leaf in flatten_tree(jax.device_get(
                        st.opt_state[which])):
                    out[p + which + "/" + name] = np.asarray(leaf)
            out[p + "opt_step"] = np.asarray(st.opt_state["step"])
            t = DT.host_table(ctx, st.table)
            for k, v in zip(("emb", "age", "init"), t):
                out[p + "table/" + k] = np.asarray(v)
            out[p + "step"] = np.asarray(st.step)
            if m is not None:
                out[p + "loss"] = np.asarray(m["loss"])

        save(0, st)
        for i, lo in enumerate((0, 8, 0)):
            b = DP._assemble(ds, np.arange(lo, lo + 8))
            st, m = step(st, DT.shard_batch(ctx, b), rng)
            save(i + 1, st, m)
    np.savez(sys.argv[1], **out)
''') % {"hid": HID}


@pytest.fixture(scope="module")
def jax_dist_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dist") / "run.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _JAX_DIST, str(path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def _jax_draws(step, seg_valid):
    """The JAX dist step's per-row draws at ``step`` (src/repro/core/
    gst.py:248-254,281-284, rng PRNGKey(0), batch_pos 0..B-1)."""
    r_sample, r_sed = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(0), step))
    pos = jnp.arange(seg_valid.shape[0])
    sv = jnp.asarray(seg_valid)
    idx = jseg.sample_segments_rowwise(jseg.per_row_keys(r_sample, pos), sv, 1)
    u = jax.vmap(lambda k: jax.random.uniform(k, (sv.shape[1],)))(
        jseg.per_row_keys(r_sed, pos))
    return np.asarray(idx), np.asarray(u)


def _jax_bits(step, shard, shape):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0x6E57),
                                                step), shard)
    return np.asarray(jax.random.bits(key, shape, jnp.uint32))


def _named(st):
    names = [f"0.{n}" for n, _ in st.backbone.named_parameters()] + \
        [f"1.{n}" for n, _ in st.head.named_parameters()]
    return dict(zip(names, G.train_params(st))), \
        dict(zip(names, st.opt_state["mu"])), dict(zip(names, st.opt_state["nu"]))


@torch.no_grad()
def _load(states, run, prefix, ctx):
    """Set every replica (and the table shards) to JAX's saved state."""
    table = EmbeddingTable(*(torch.from_numpy(run[prefix + "table/" + k])
                             for k in ("emb", "age", "init")))
    shards = split_table(table, ctx.num_shards)
    out = []
    for s, shard in zip(states, shards):
        params, mu, nu = _named(s)
        for name, t in params.items():
            t.copy_(torch.from_numpy(run[prefix + "p/" + name]))
            mu[name].copy_(torch.from_numpy(run[prefix + "mu/" + name]))
            nu[name].copy_(torch.from_numpy(run[prefix + "nu/" + name]))
        for t, v in zip(s.table, shard):
            t.copy_(v)
        out.append(s._replace(opt_state=dict(
            s.opt_state, step=int(run[prefix + "opt_step"])),
            step=int(run[prefix + "step"])))
    return out


@pytest.mark.parametrize("exchange,dtype", [("ring", "int8"),
                                            ("bucketed", "f32")])
def test_four_shards_match_jax_dist_step(jax_dist_run, exchange, dtype):
    run = jax_dist_run
    ds = DP.segment_dataset_shared(D.make_malnet_like(n_graphs=16, seed=0),
                                   16, seed=0)[0]
    for k in ("x", "edges", "seg_valid", "labels"):
        np.testing.assert_array_equal(getattr(ds, k), run["ds/" + k])
    enc, opt, st = _model(ds)
    ctx = DT.make_context(LocalGroup(4), ds.n, exchange=exchange,
                          exchange_cap=2 if exchange == "bucketed" else None,
                          payload_dtype=dtype)
    step = DT.make_dist_train_step(enc, opt, G.VARIANTS["gst_efd"], ctx=ctx,
                                   keep_prob=0.5, num_sampled=1,
                                   use_kernels=True)
    for ex in step.exchanges:
        ex.codec.bits_fn = _jax_bits
    states = DT.device_state(ctx, st)
    n_stale = 0
    for i, lo in enumerate((0, 8, 0)):
        states = _load(states, run, f"{exchange}/{i}/", ctx)
        host = _host_batch(ds, np.arange(lo, lo + 8))
        draws = _jax_draws(states[0].step, host.seg_valid)
        init = DT.host_table(ctx, states).initialized.numpy()[host.graph_ids]
        fresh = np.zeros_like(init)
        fresh[np.arange(8), draws[0][:, 0]] = True
        n_stale += int((init & ~fresh & (draws[1] <= 0.5)
                        & (host.seg_valid > 0)).sum())
        mu_prev = {k: v.clone() for k, v in _named(states[0])[1].items()}
        states, m = step(states, DT.shard_batch(ctx, host), draws=draws)
        _assert_replicas_equal(states)
        p = f"{exchange}/{i + 1}/"
        np.testing.assert_allclose(float(m["loss"]), float(run[p + "loss"]),
                                   rtol=1e-4, atol=1e-5)
        params, mu, _ = _named(states[0])
        for name, t in params.items():
            g = (mu[name].numpy() - B1 * mu_prev[name].numpy()) / (1 - B1)
            g_want = (run[p + "mu/" + name]
                      - B1 * mu_prev[name].numpy()) / (1 - B1)
            np.testing.assert_allclose(g, g_want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i} gradient {name}")
            held = (np.abs(g) >= NOISE_FLOOR) | (np.abs(g_want) >= NOISE_FLOOR)
            np.testing.assert_allclose(
                t.detach().numpy()[held], run[p + "p/" + name][held],
                rtol=0, atol=1e-5, err_msg=f"step {i} {name}")
        table = DT.host_table(ctx, states)
        np.testing.assert_array_equal(table.age.numpy(), run[p + "table/age"])
        np.testing.assert_array_equal(table.initialized.numpy(),
                                      run[p + "table/init"])
        want = run[p + "table/emb"]
        grid = (np.abs(want).max(axis=(1, 2), keepdims=True) / 127.0
                if dtype == "int8" else 0.0)
        assert np.all(np.abs(table.emb.numpy() - want) <= grid + 1e-5)
    assert n_stale > 0      # Eq. 1's stale branch was reached


# ---------------------------------------------------------------------------
# the feeders
# ---------------------------------------------------------------------------


def _identity(b):
    return b


def _batches_equal(a, b):
    return all(np.array_equal(a.seg_inputs[k], b.seg_inputs[k])
               for k in a.seg_inputs) and all(
        np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))


def test_async_feeder_delivers_sync_trace(dataset):
    sched = DP.epoch_ids(dataset, 4, rng=np.random.default_rng(5))
    sync = list(DP.make_feeder("sync", dataset, sched, _identity))
    feeder = DP.make_feeder("async", dataset, sched, _identity, depth=2)
    asyn = list(feeder)
    assert len(sync) == len(asyn) == len(sched) == feeder.stats.batches
    for a, b in zip(sync, asyn):
        assert _batches_equal(a, b)
        assert b.batch_pos is not None   # per-row positions travel along


def test_async_feeder_shuts_down_when_abandoned(dataset):
    sched = DP.epoch_ids(dataset, 4, rng=np.random.default_rng(5))
    feeder = DP.make_feeder("async", dataset, sched, _identity, depth=1)
    it = iter(feeder)
    next(it)
    it.close()      # what an exception in the consumer's loop triggers
    feeder._thread.join(timeout=5.0)
    assert not feeder._thread.is_alive()
    with pytest.raises(RuntimeError, match="single-shot"):
        next(iter(feeder))


def test_async_feeder_propagates_producer_errors(dataset):
    sched = DP.epoch_ids(dataset, 4, rng=np.random.default_rng(5))

    def bad_put(b):
        raise RuntimeError("copy to the device exploded")

    with pytest.raises(RuntimeError, match="exploded"):
        list(DP.make_feeder("async", dataset, sched, bad_put))


# ---------------------------------------------------------------------------
# the shard group
# ---------------------------------------------------------------------------


def test_a_failing_shard_fails_the_run_instead_of_hanging():
    group = LocalGroup(4, timeout=30.0)

    def shard(i, comm):
        if i == 2:
            raise ValueError("shard 2 failed")
        return comm.all_gather(torch.ones(3))      # would wait for shard 2

    errors = []

    def run_group():
        try:
            group.run(shard)
        except BaseException as e:          # checked below
            errors.append(e)

    t = threading.Thread(target=run_group)
    t.start()
    t.join(timeout=20.0)
    assert not t.is_alive()
    assert len(errors) == 1 and isinstance(errors[0], ValueError)
    with pytest.raises(RuntimeError, match="failed before"):
        group.run(shard)


def test_collectives_and_their_byte_counts():
    D = 4

    def shard(i, comm):
        x = torch.arange(8, dtype=torch.float32) + 10 * i
        ring = comm.ppermute(x)
        a2a = comm.all_to_all(x)
        gathered = comm.all_gather((x, torch.tensor([i], dtype=torch.int8)))
        mean = comm.all_reduce_mean(x)
        return ring, a2a, gathered, mean, dict(comm.sent)

    out = LocalGroup(D).run(shard)
    for i, (ring, a2a, (g, g8), mean, sent) in enumerate(out):
        assert torch.equal(ring, torch.arange(8.) + 10 * ((i - 1) % D))
        assert torch.equal(a2a, torch.cat([torch.arange(2.) + 2 * i + 10 * s
                                           for s in range(D)]))
        assert torch.equal(g[:, 0], torch.arange(D) * 10.0)
        assert g8.tolist() == [[s] for s in range(D)]
        assert torch.equal(mean, torch.arange(8.) + 15.0)
        assert sent == {"ppermute": 32, "all_to_all": 24,
                        "all_gather": 3 * 33, "all_reduce": 3 * 32}


def test_launch_counts_survive_many_threads():
    counts = LaunchCounts(("k",))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counts.add("k")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 16 * 2000


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_strategies_print_identical_losses_at_f32(capsys):
    from repro_torch.launch.train_dist import main

    results = {}
    for exchange in ("ring", "alltoall", "bucketed"):
        r = main(["--device", "cpu", "--devices", "4", "--exchange",
                  exchange, "--epochs", "2", "--finetune-epochs", "1",
                  "--n-graphs", "32", "--feeder", "sync"])
        assert r.finetuned and np.isfinite(r.train_metric)
        assert r.epoch_exchange_bytes == [r.step_bytes_model * 4] * 2
        results[exchange] = r.epoch_losses
    out = capsys.readouterr().out
    assert out.count("exch KiB") == 6
    assert results["ring"] == results["alltoall"] == results["bucketed"]


@pytest.mark.parametrize("flag", [["--prefetch-lookups"],
                                  ["--table-device-rows", "16"],
                                  ["--evict-policy", "stale-first"],
                                  ["--wb-threshold", "0.1"],
                                  ["--stale-forecast"]])
def test_cli_flags_of_later_slices_raise(flag):
    """Every flag of the later slices now runs (the name is kept): the
    prefetch lane prints the inline run's per-epoch losses bitwise, with
    its parameters and final table, and counts its modelled bytes.  The
    tiered-store flags: 2 shards, 32 graphs, 16 device rows (the two
    shards' batch) under the flag; ``--table-device-rows`` alone and with
    stale-first eviction print the uncapped run's losses bitwise, the
    gate skips write-backs, the forecaster observes evictions."""
    from repro_torch.launch.train_dist import main

    base = ["--device", "cpu", "--devices", "2", "--n-graphs", "32",
            "--epochs", "2", "--finetune-epochs", "1", "--feeder", "sync"]
    if flag == ["--prefetch-lookups"]:
        inline, r = main(base), main(base + flag)
        assert r.finetuned and r.epoch_losses == inline.epoch_losses
        assert r.train_metric == inline.train_metric
        assert all(torch.equal(a, b) for a, b in zip(r.host_params(),
                                                     inline.host_params()))
        assert all(torch.equal(a, b) for a, b in zip(r.host_table(),
                                                     inline.host_table()))
        assert r.epoch_exchange_bytes == [r.step_bytes_model * 4] * 2
        return
    capped = flag if flag[0] == "--table-device-rows" else \
        ["--table-device-rows", "16"] + flag
    r = main(base + capped)
    st = r.store_stats
    assert r.finetuned and np.isfinite(r.train_metric)
    assert all(np.isfinite(r.epoch_losses))
    assert st["backend"] == "TieredStore" and st["device_rows"] == 16
    assert st["evictions"] > 0
    if "--wb-threshold" in flag:
        assert st["wb_skipped_rows"] > 0
    elif "--stale-forecast" in flag:
        assert st["forecast"]["observed_rows"] > 0
    else:
        assert r.epoch_losses == main(base).epoch_losses
        assert st["evict_policy"] == ("stale-first" if "stale-first" in flag
                                      else "lru")


# ---------------------------------------------------------------------------
# one shard per process (gloo) against threads
# ---------------------------------------------------------------------------

_GLOO = textwrap.dedent('''
    import os, sys
    import numpy as np, torch

    def run_shards(group):
        from repro_torch.core import gst as G
        from repro_torch.core.embedding_table import init_table
        from repro_torch.dist import pipeline as DP, train as DT
        from repro_torch.graphs import data as D
        from repro_torch.graphs.experiment import epoch_generator
        from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
        from repro_torch.optim import make_optimizer

        ds = DP.segment_dataset_shared(D.make_malnet_like(n_graphs=8, seed=0),
                                       16, seed=0)[0]
        out = {}
        for exchange, dtype in (("ring", "int8"), ("alltoall", "bf16")):
            cfg = GNNConfig(backbone="sage", n_feat=ds.x.shape[-1], hidden=8)
            gen = torch.Generator().manual_seed(0)
            bb, head = gnn_init(cfg, gen, "cpu"), G.head_init(8, 5, "mlp", gen,
                                                              "cpu")
            opt = make_optimizer("adam", lr=5e-3)
            st = G.TrainState(bb, head, None, init_table(ds.n, ds.j_max, 8), 0)
            st = st._replace(opt_state=opt.init(G.train_params(st)))
            ctx = DT.make_context(group, ds.n, exchange=exchange,
                                  payload_dtype=dtype)
            step = DT.make_dist_train_step(make_encode_fn(cfg), opt,
                                           G.VARIANTS["gst_efd"], ctx=ctx)
            states = DT.device_state(ctx, st)
            gens = [epoch_generator(0, 0) for _ in ctx.local_ranks]
            for ids in (np.arange(0, 4), np.arange(4, 8), np.arange(0, 4)):
                states, m = step(states, DT.shard_batch(
                    ctx, DP._assemble(ds, ids)), gens)
            for r, s in zip(ctx.local_ranks, states):
                key = f"{exchange}/{r}/"
                out[key + "loss"] = m["loss"].numpy()
                for j, p in enumerate(G.train_params(s)):
                    out[key + f"p{j}"] = p.detach().numpy()
                for k, t in zip(("emb", "age", "init"), s.table):
                    out[key + k] = t.numpy()
        return out

    if __name__ == "__main__":
        import torch.distributed as dist
        from repro_torch.dist.comm import ProcessGroup

        rank = int(sys.argv[1])
        dist.init_process_group("gloo", init_method="tcp://localhost:" +
                                sys.argv[2], world_size=2, rank=rank)
        try:
            np.savez(sys.argv[3], **run_shards(ProcessGroup("cpu")))
        finally:
            dist.destroy_process_group()
''')


def test_gloo_processes_equal_threads_bitwise(tmp_path):
    import runpy
    import socket

    script = tmp_path / "gloo_shard.py"
    script.write_text(_GLOO)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port,
                               str(tmp_path / f"rank{r}.npz")], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    want = runpy.run_path(str(script))["run_shards"](LocalGroup(2))
    got = {}
    for r in range(2):
        got.update({k: v for k, v in np.load(tmp_path / f"rank{r}.npz").items()
                    if k.split("/")[1] == str(r)})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
