"""The port's prefetch lane (``--prefetch-lookups``) on the CPU, the contract
of tests/test_prefetch.py:

  * ``update_sampled_patch`` applies the sampled write-back exactly like
    ``update_sampled`` AND patches the next batch's prefetched buffer so
    it is BITWISE a lookup of the written table at f32, for the three
    strategies x D in {1, 2, 4} x all / zero / partial overlap;
  * at D = 4 it matches JAX's own fused patch (run in a subprocess on a
    forced 4-device CPU host): ring with int8 payloads given JAX's write
    bits, bucketed at f32;
  * ragged and all-sentinel next batches are never patched; bucketed
    without ``next_dest`` raises;
  * the comm counts ``prefetch_train_step_bytes`` a step, and
    ``patch_bytes`` is 0 for ring and alltoall;
  * ``consumer_shards`` and ``plan_patch_capacity`` equal the reference's;
  * ``PrefetchLane``: dispatch order, pairing, a single and an empty
    feeder, an error closes the feeder; its counters reach the registry;
  * a prefetched train loop driven by hand over an all-overlap schedule
    (every row patched every step) is BITWISE the inline one at f32 for
    the 7 variants x 3 strategies at D = 4;
  * ``train_dist --device cpu --devices 4 --prefetch-lookups`` is
    bitwise the inline run for gst_efd and gst x 3 strategies; with a
    capped table it keeps its lookahead pinned and prints the uncapped
    prefetched run's losses; a failing dispatch fails the run instead of
    hanging it.
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

from repro.dist import exchange as JEX  # noqa: E402
from repro_torch.core import embedding_table as tbl  # noqa: E402
from repro_torch.core import gst as G  # noqa: E402
from repro_torch.core.embedding_table import init_table  # noqa: E402
from repro_torch.dist import exchange as EX  # noqa: E402
from repro_torch.dist import pipeline as DP  # noqa: E402
from repro_torch.dist import train as DT  # noqa: E402
from repro_torch.dist.comm import LocalGroup  # noqa: E402
from repro_torch.dist.table import join_tables, rows_per_shard, split_table  # noqa: E402
from repro_torch.graphs import data as D  # noqa: E402
from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn  # noqa: E402
from repro_torch.obs import metrics as M  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from _torch_lane import all_overlap_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = list(EX.EXCHANGES)
OVERLAPS = ("all", "none", "partial")
N_ROWS, J, DH = 64, 2, 4
B_GLOBAL = 8
HID = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on
    the same cores, and small ops then spend their time in thread
    hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_table(n=N_ROWS, seed=0):
    rng = np.random.default_rng(seed)
    return tbl.EmbeddingTable(
        emb=torch.from_numpy(rng.normal(size=(n, J, DH)).astype(np.float32)),
        age=torch.from_numpy(rng.integers(0, 9, (n, J)).astype(np.int32)),
        initialized=torch.from_numpy(rng.integers(0, 2, (n, J)).astype(bool)))


def _overlap_ids(mode, rng):
    """(cur_ids, next_ids): unique global batches with a given overlap."""
    pool = rng.permutation(N_ROWS).astype(np.int64)
    cur = pool[:B_GLOBAL]
    if mode == "all":
        nxt = rng.permutation(cur)
    elif mode == "none":
        nxt = pool[B_GLOBAL:2 * B_GLOBAL]
    else:
        nxt = rng.permutation(np.concatenate(
            [cur[:B_GLOBAL // 2], pool[B_GLOBAL:B_GLOBAL + B_GLOBAL // 2]]))
    return cur, nxt.astype(np.int64)


def _payloads(ids, S=1):
    rng = np.random.default_rng(7)
    key = rng.normal(size=(N_ROWS + 1, S, DH)).astype(np.float32)
    sidx = (ids[:, None] + np.arange(S)[None, :]) % J
    return sidx.astype(np.int64), key[np.minimum(ids, N_ROWS)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _run_patch(strategy, D_, table, ids, sidx, h, step, pref, next_ids,
               dest=None, *, dtype="f32", cap=None, pcap=None, bits_fn=None,
               counts=None):
    """update_sampled_patch on D shards (LocalGroup): (full table, patched
    emb, patched init); ``counts`` collects each shard's comm counters."""
    group = LocalGroup(D_)
    rows = rows_per_shard(N_ROWS, D_)
    shards = split_table(table, D_)
    b, bn = len(ids) // D_, len(next_ids) // D_

    def shard(i, comm):
        comm.reset_counts()
        ex = EX.make_exchange(strategy, comm=comm, num_shards=D_, rows=rows,
                              cap=cap, patch_cap=pcap, payload_dtype=dtype,
                              bits_fn=bits_fn)
        sl, nl = slice(i * b, (i + 1) * b), slice(i * bn, (i + 1) * bn)
        t, (e, init) = ex.update_sampled_patch(
            shards[i], _t(ids[sl]), _t(sidx[sl]), _t(h[sl]), step,
            (pref[0][nl], pref[1][nl]), _t(next_ids[nl]),
            None if dest is None else _t(dest[sl]))
        if counts is not None:
            counts.append(comm.exchange_bytes)
        return t, e, init

    out = group.run(shard)
    return (join_tables([o[0] for o in out], N_ROWS),
            torch.cat([o[1] for o in out]), torch.cat([o[2] for o in out]))


def _bitwise_tables(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _dense_write(table, ids, sidx, h, step):
    t = tbl.EmbeddingTable(*(x.clone() for x in table))
    return tbl.update_sampled(t, _t(ids), _t(sidx), _t(h), step)


# ---------------------------------------------------------------------------
# the fused op: the write is update_sampled's, the patched buffer a lookup
# of the written table, bitwise, at every overlap and shard count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", OVERLAPS)
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_update_sampled_patch_is_a_lookup_of_the_written_table(
        strategy, n_shards, overlap):
    rng = np.random.default_rng(11)
    ids, next_ids = _overlap_ids(overlap, rng)
    sidx, h = _payloads(ids)
    table = _random_table()
    rows = rows_per_shard(N_ROWS, n_shards)
    cap = EX.required_capacity(ids, num_shards=n_shards, rows=rows)
    pcap = EX.required_patch_capacity(ids, next_ids, num_shards=n_shards,
                                      rows=rows)
    pref = tbl.lookup(table, _t(next_ids))
    dest = EX.consumer_shards(ids, next_ids, num_shards=n_shards, rows=rows)
    got_t, got_e, got_i = _run_patch(strategy, n_shards, table, ids, sidx, h,
                                     5, pref, next_ids, dest, cap=cap,
                                     pcap=pcap)
    want_t = _dense_write(table, ids, sidx, h, 5)
    assert _bitwise_tables(got_t, want_t)
    want_e, want_i = tbl.lookup(want_t, _t(next_ids))
    assert torch.equal(got_e, want_e) and torch.equal(got_i, want_i)
    if overlap != "none":
        assert not torch.equal(got_e, pref[0])     # the patch did something


def test_bucketed_patch_requires_next_dest():
    with pytest.raises(ValueError, match="next_dest"):
        _run_patch("bucketed", 2, _random_table(), np.arange(8),
                   np.zeros((8, 1), np.int64), np.zeros((8, 1, DH),
                                                        np.float32), 0,
                   (torch.zeros(8, J, DH), torch.zeros(8, J, dtype=bool)),
                   np.arange(8), cap=4, pcap=1)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ragged_next_batch_sentinels_never_patched(strategy):
    """A next global batch of 2·D+3 rows, sentinel-padded: its real slots
    are patched as a lookup of the written table, its pad slots keep the
    prefetched zeros, and the write ignores the padding."""
    D_ = 4
    rows = rows_per_shard(N_ROWS, D_)
    rng = np.random.default_rng(3)
    ids = rng.permutation(N_ROWS)[:B_GLOBAL].astype(np.int64)
    sidx, h = _payloads(ids)
    n_next = 2 * D_ + 3
    next_real = np.concatenate(
        [ids[:n_next // 2], np.setdiff1d(rng.permutation(N_ROWS), ids)
         [:n_next - n_next // 2]]).astype(np.int64)
    next_p, n_real = EX.pad_ragged(D_, rows, next_real)
    cap = EX.plan_capacity([ids, next_p], num_shards=D_, rows=rows)
    pcap = EX.required_patch_capacity(ids, next_p, num_shards=D_, rows=rows)
    table = _random_table()

    def lookup(i, comm):
        ex = EX.make_exchange(strategy, comm=comm, num_shards=D_, rows=rows,
                              cap=cap)
        b = len(next_p) // D_
        return ex.prefetch_lookup(split_table(table, D_)[i],
                                  _t(next_p[i * b:(i + 1) * b]))

    out = LocalGroup(D_).run(lookup)
    pref = (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]))
    assert (pref[0][n_real:] == 0).all() and not pref[1][n_real:].any()
    dest = EX.consumer_shards(ids, next_p, num_shards=D_, rows=rows)
    got_t, got_e, got_i = _run_patch(strategy, D_, table, ids, sidx, h, 4,
                                     pref, next_p, dest, cap=cap, pcap=pcap)
    want_t = _dense_write(table, ids, sidx, h, 4)
    assert _bitwise_tables(got_t, want_t)
    want_e, want_i = tbl.lookup(want_t, _t(next_real))
    assert torch.equal(got_e[:n_real], want_e)
    assert torch.equal(got_i[:n_real], want_i)
    assert (got_e[n_real:] == 0).all() and not got_i[n_real:].any()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_all_sentinel_next_batch_patch_is_a_noop(strategy):
    """The epoch's tail: every next id is the sentinel."""
    D_ = 4
    rows = rows_per_shard(N_ROWS, D_)
    ids = np.random.default_rng(5).permutation(N_ROWS)[:B_GLOBAL]
    sidx, h = _payloads(ids)
    next_ids = np.full(B_GLOBAL, D_ * rows, np.int64)
    zeros = (torch.zeros(B_GLOBAL, J, DH), torch.zeros(B_GLOBAL, J,
                                                       dtype=torch.bool))
    dest = np.full(B_GLOBAL, D_, np.int64)
    table = _random_table()
    got_t, got_e, got_i = _run_patch(
        strategy, D_, table, ids, sidx, h, 2, zeros, next_ids, dest,
        cap=EX.required_capacity(ids, num_shards=D_, rows=rows), pcap=1)
    assert _bitwise_tables(got_t, _dense_write(table, ids, sidx, h, 2))
    assert (got_e == 0).all() and not got_i.any()


# ---------------------------------------------------------------------------
# against JAX's own fused patch at D = 4
# ---------------------------------------------------------------------------


_JAX_PATCH = textwrap.dedent('''
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import dist as DT
    from repro.core import embedding_table as tbl
    from repro.dist import exchange as EX

    d = dict(np.load(sys.argv[1]))
    ctx = DT.make_context(DT.make_dist_mesh(4), int(d["n_rows"]))
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(ctx.mesh, P(DT.AXIS)))
    tspec = tbl.EmbeddingTable(P(DT.AXIS), P(DT.AXIS), P(DT.AXIS))
    out = {}
    for strategy, dtype in (("ring", "int8"), ("bucketed", "f32")):
        ex = EX.make_exchange(strategy, axis_name=DT.AXIS, num_shards=4,
                              rows=ctx.rows_per_shard, cap=int(d["cap"]),
                              payload_dtype=dtype,
                              patch_cap=int(d["pcap"]))

        def f(table, ids, sidx, h, step, pe, pi, nids, dest):
            t, (e, i) = ex.update_sampled_patch(table, ids, sidx, h, step,
                                                (pe, pi), nids, dest)
            return t, e, i

        fn = shard_map(f, mesh=ctx.mesh,
                       in_specs=(tspec,) + (P(DT.AXIS),) * 3 + (P(),)
                       + (P(DT.AXIS),) * 4,
                       out_specs=(tspec, P(DT.AXIS), P(DT.AXIS)),
                       check_rep=False)
        table = tbl.EmbeddingTable(jnp.asarray(d["emb"]), jnp.asarray(d["age"]),
                                   jnp.asarray(d["init"]))
        t, e, i = jax.jit(fn)(
            DT.device_table(ctx, table), put(d["ids"]), put(d["sidx"]),
            put(d["h"]), jnp.asarray(int(d["step"]), jnp.int32),
            put(d["pe"]), put(d["pi"]), put(d["next_ids"]), put(d["dest"]))
        t = DT.host_table(ctx, t)
        for k, v in zip(("emb", "age", "init"), t):
            out[strategy + "/" + k] = np.asarray(v)
        out[strategy + "/pe"] = np.asarray(e)
        out[strategy + "/pi"] = np.asarray(i)
    np.savez(sys.argv[2], **out)
''')


def _jax_bits(step, shard, shape):
    """JAX's write-path bits (PayloadCodec.encode_write)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0x6E57),
                                                step), shard)
    return np.asarray(jax.random.bits(key, shape, jnp.uint32))


@pytest.fixture(scope="module")
def jax_patch(tmp_path_factory):
    rng = np.random.default_rng(13)
    ids, next_ids = _overlap_ids("partial", rng)
    sidx, h = _payloads(ids)
    h = h * 3.7    # values off the int8 grid
    table = _random_table(seed=2)
    rows = rows_per_shard(N_ROWS, 4)
    pref = tbl.lookup(table, _t(next_ids))
    inputs = dict(
        n_rows=N_ROWS, emb=table.emb.numpy(), age=table.age.numpy(),
        init=table.initialized.numpy(), ids=ids.astype(np.int32),
        sidx=sidx.astype(np.int32), h=h, next_ids=next_ids.astype(np.int32),
        pe=pref[0].numpy(), pi=pref[1].numpy(), step=3,
        cap=EX.required_capacity(ids, num_shards=4, rows=rows),
        pcap=EX.required_patch_capacity(ids, next_ids, num_shards=4,
                                        rows=rows),
        dest=EX.consumer_shards(ids, next_ids, num_shards=4, rows=rows))
    d = tmp_path_factory.mktemp("jax_patch")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _JAX_PATCH,
                           str(d / "in.npz"), str(d / "out.npz")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inputs, table, pref, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("strategy,dtype", [("ring", "int8"),
                                            ("bucketed", "f32")])
def test_four_shard_patch_matches_jax(jax_patch, strategy, dtype):
    """The table write and the patched pair bitwise JAX's, given JAX's
    write bits (at int8 the patch carries the write-rounded value, JAX's
    contract: src/repro/dist/exchange.py:296-300)."""
    d, table, pref, want = jax_patch
    got_t, got_e, got_i = _run_patch(
        strategy, 4, table, d["ids"].astype(np.int64),
        d["sidx"].astype(np.int64), d["h"], d["step"], pref,
        d["next_ids"].astype(np.int64), d["dest"].astype(np.int64),
        dtype=dtype, cap=int(d["cap"]), pcap=int(d["pcap"]),
        bits_fn=_jax_bits)
    for k, t in zip(("emb", "age", "init"), got_t):
        np.testing.assert_array_equal(t.numpy(), want[f"{strategy}/{k}"])
    np.testing.assert_array_equal(got_e.numpy(), want[f"{strategy}/pe"])
    np.testing.assert_array_equal(got_i.numpy(), want[f"{strategy}/pi"])
    if dtype == "int8":
        # the patched rows hold the write-rounded value, not h itself
        written = d["next_ids"][:, None] == d["ids"][None, :]
        assert written.any() and not torch.equal(got_t.emb,
                                                 _dense_write(table, d["ids"],
                                                              d["sidx"],
                                                              d["h"], 3).emb)


# ---------------------------------------------------------------------------
# bytes: the comm's counters = the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_counted_bytes_equal_prefetch_train_step_bytes(strategy, dtype):
    D_, b_local, S = 4, 2, 1
    rows = rows_per_shard(N_ROWS, D_)
    rng = np.random.default_rng(1)
    ids, next_ids = _overlap_ids("partial", rng)
    sidx, h = _payloads(ids, S)
    table = _random_table()
    cap, pcap = 2, 1
    look_counts, patch_counts = [], []

    def lookup(i, comm):
        comm.reset_counts()
        ex = EX.make_exchange(strategy, comm=comm, num_shards=D_, rows=rows,
                              cap=cap, payload_dtype=dtype)
        out = ex.prefetch_lookup(split_table(table, D_)[i],
                                 _t(next_ids[i * b_local:(i + 1) * b_local]))
        look_counts.append(comm.exchange_bytes)
        return out

    out = LocalGroup(D_).run(lookup)
    pref = (torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out]))
    dest = np.minimum(EX.consumer_shards(ids, next_ids, num_shards=D_,
                                         rows=rows), D_)
    # keep every patch bucket within pcap (the plan would size it)
    for dev in range(D_):
        seen = set()
        for r in range(dev * b_local, (dev + 1) * b_local):
            if dest[r] < D_ and dest[r] in seen:
                dest[r] = D_
            seen.add(dest[r])
    _run_patch(strategy, D_, table, ids, sidx, h, 1, pref, next_ids,
               dest.astype(np.int64), dtype=dtype, cap=cap, pcap=pcap,
               counts=patch_counts)
    ex = EX.make_exchange(strategy, num_shards=D_, rows=rows, cap=cap,
                          patch_cap=pcap, payload_dtype=dtype)
    assert look_counts == [ex.prefetch_lookup_bytes(b_local, J, DH)] * D_
    assert ex.prefetch_lookup_bytes(b_local, J, DH) == \
        ex.lookup_bytes(b_local, J, DH)
    assert patch_counts == [ex.update_sampled_patch_bytes(b_local, S, DH)] * D_
    assert [a + b for a, b in zip(look_counts, patch_counts)] == \
        [ex.prefetch_train_step_bytes(b_local, J, S, DH,
                                      use_table=True)] * D_
    surcharge = patch_counts[0] - ex.update_sampled_bytes(b_local, S, DH)
    assert surcharge == ex.patch_bytes(b_local, S, DH)
    assert (surcharge == 0) == (strategy != "bucketed")
    assert ex.prefetch_train_step_bytes(b_local, J, S, DH,
                                        use_table=False) == 0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_bytes_models_equal_the_reference(strategy):
    for dtype in ("f32", "bf16", "int8"):
        kw = dict(num_shards=8, rows=8, cap=4, patch_cap=2,
                  payload_dtype=dtype)
        ex = EX.make_exchange(strategy, **kw)
        jex = JEX.make_exchange(strategy, axis_name="x", **kw)
        for args in ((16, 4, 16), (3, 2, 5)):
            assert ex.prefetch_lookup_bytes(*args) == \
                jex.prefetch_lookup_bytes(*args)
            assert ex.patch_bytes(*args) == jex.patch_bytes(*args)
            assert ex.update_sampled_patch_bytes(*args) == \
                jex.update_sampled_patch_bytes(*args)
        for ut in (True, False):
            assert ex.prefetch_train_step_bytes(16, 4, 1, 16, use_table=ut) \
                == jex.prefetch_train_step_bytes(16, 4, 1, 16, use_table=ut)
    # the reference's module-level ring helpers are the ring's model at
    # f32 (itemsize 4) and bf16 (itemsize 2)
    for dtype, item in (("f32", 4), ("bf16", 2)):
        for D, b, x, d in ((1, 4, 3, 8), (4, 4, 3, 8), (8, 2, 1, 16)):
            ring = EX.make_exchange("ring", num_shards=D, rows=4,
                                    payload_dtype=dtype)
            assert ring.lookup_bytes(b, x, d) == \
                JEX.lookup_exchange_bytes(D, b, x, d, item)
            assert ring.update_sampled_bytes(b, x, d) == \
                JEX.update_sampled_exchange_bytes(D, b, x, d, item)
            assert ring.update_all_bytes(b, x, d) == \
                JEX.update_all_exchange_bytes(D, b, x, d, item)
    ring = EX.make_exchange("ring", num_shards=4, rows=4)
    for ut in (True, False):
        assert ring.train_step_bytes(2, 3, 1, 8, use_table=ut) == \
            JEX.train_step_exchange_bytes(4, 2, 3, 1, 8, use_table=ut)


def test_codec_launches_of_the_patch():
    """The payload kernels a fused patch launches: ring decodes once a hop
    (as its write-back), alltoall once, bucketed once more for the patch
    buckets; the prefetch lookup is the lookup's."""
    for dtype, pack, unpack in (("int8", "quant_pack_int8",
                                 "quant_unpack_int8"),
                                ("bf16", "quant_pack_bf16",
                                 "quant_unpack_bf16")):
        want = {"ring": 4, "alltoall": 1, "bucketed": 2}
        for strategy, unpacks in want.items():
            ex = EX.make_exchange(strategy, num_shards=4, rows=8,
                                  payload_dtype=dtype)
            assert ex.codec_launches("update_sampled_patch") == \
                {pack: 1, unpack: unpacks}
            assert ex.codec_launches("prefetch_lookup") == \
                ex.codec_launches("lookup")
        assert EX.make_exchange("ring", num_shards=4, rows=8).codec_launches(
            "update_sampled_patch") == {}


# ---------------------------------------------------------------------------
# host planners
# ---------------------------------------------------------------------------


def test_consumer_shards_routing():
    cur, nxt = np.asarray([1, 2, 7, 9]), np.asarray([1, 9, 2, 3])
    assert EX.consumer_shards(cur, nxt, num_shards=2,
                              rows=8).tolist() == [0, 1, 2, 0]
    assert (EX.consumer_shards(np.arange(4), np.arange(8, 12), num_shards=2,
                               rows=8) == 2).all()
    d = EX.consumer_shards(np.asarray([0, 1, 2]), np.asarray([0, 1, 2, 3]),
                           num_shards=2, rows=8)
    assert d.shape[0] == 4 and d[3] == 2
    d = EX.consumer_shards(np.asarray([0, 16, 1, 3]),
                           np.asarray([0, 16, 3, 16]), num_shards=2, rows=8)
    assert d.tolist() == [0, 2, 2, 1]


@pytest.mark.parametrize("num_shards", [2, 4])
def test_planners_equal_the_reference(num_shards):
    rng = np.random.default_rng(num_shards)
    rows = 16
    n = num_shards * rows
    for mode in ("shuffled", "overlap", "ragged"):
        sched = []
        for _ in range(6):
            if mode == "overlap" and sched:
                b = rng.permutation(sched[-1])
            else:
                b = rng.permutation(n)[:12 if mode == "ragged" else 16]
            sched.append(b.astype(np.int64))
        for a, b in zip(sched, sched[1:]):
            kw = dict(num_shards=num_shards, rows=rows)
            np.testing.assert_array_equal(EX.consumer_shards(a, b, **kw),
                                          JEX.consumer_shards(a, b, **kw))
            assert EX.required_patch_capacity(a, b, **kw) == \
                JEX.required_patch_capacity(a, b, **kw)
        assert EX.plan_patch_capacity(sched, num_shards=num_shards,
                                      rows=rows) == \
            JEX.plan_patch_capacity(sched, num_shards=num_shards, rows=rows)
    a, b = np.asarray([0, 1, 8, 9]), np.asarray([4, 5, 12, 13])
    assert EX.plan_patch_capacity([a, b, a], num_shards=2, rows=8) == 1
    assert EX.plan_patch_capacity([a, a, b], num_shards=2, rows=8) == 2


# ---------------------------------------------------------------------------
# PrefetchLane mechanics
# ---------------------------------------------------------------------------


class _FakeFeeder:
    def __init__(self, items):
        self.items = list(items)
        self.closed = False
        self.stats = "the-stats"

    def __iter__(self):
        for it in self.items:
            if isinstance(it, Exception):
                raise it
            yield it

    def close(self):
        self.closed = True


def test_prefetch_lane_dispatch_order_and_pairing():
    events = []
    feeder = _FakeFeeder(["a", "b", "c"])
    reg = M.MetricsRegistry()
    prev = M.set_registry(reg)
    try:
        lane = DP.PrefetchLane(
            feeder, lambda it: events.append(("d", it)) or f"h:{it}")
        out = []
        for cur, cur_h, nxt, nxt_h in lane:
            events.append(("y", cur))
            out.append((cur, cur_h, nxt, nxt_h))
    finally:
        M.set_registry(prev)
    # every item dispatched once, BEFORE the step of the item before it
    assert events == [("d", "a"), ("d", "b"), ("y", "a"),
                      ("d", "c"), ("y", "b"), ("y", "c")]
    assert out == [("a", "h:a", "b", "h:b"), ("b", "h:b", "c", "h:c"),
                   ("c", "h:c", None, None)]
    assert lane.prefetch_batches == 3 and feeder.closed
    assert lane.stats == "the-stats"
    snap = reg.snapshot()
    assert snap["feeder.prefetch_batches"]["value"] == 3
    assert snap["feeder.prefetch_dispatch_ms"]["value"] >= 0


def test_prefetch_lane_single_and_empty():
    lane = DP.PrefetchLane(_FakeFeeder(["only"]), lambda it: "h")
    assert list(lane) == [("only", "h", None, None)]
    feeder = _FakeFeeder([])
    lane = DP.PrefetchLane(feeder, lambda it: pytest.fail("no dispatch"))
    assert list(lane) == [] and feeder.closed


def test_prefetch_lane_error_propagates_and_closes():
    feeder = _FakeFeeder(["a", RuntimeError("boom")])
    with pytest.raises(RuntimeError, match="boom"):
        list(DP.PrefetchLane(feeder, lambda it: "h"))
    assert feeder.closed
    feeder = _FakeFeeder(["a", "b"])

    def dispatch(it):
        if it == "b":
            raise ValueError("dispatch failed")
        return it

    with pytest.raises(ValueError, match="dispatch failed"):
        list(DP.PrefetchLane(feeder, dispatch))
    assert feeder.closed


# ---------------------------------------------------------------------------
# end to end: a prefetched train loop == the inline one, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset():
    graphs = D.make_malnet_like(n_graphs=16, seed=0)
    return DP.segment_dataset_shared(graphs, 16, seed=0)[0]


def _state(ds):
    cfg = GNNConfig(backbone="sage", n_feat=ds.x.shape[-1], hidden=HID)
    gen = torch.Generator().manual_seed(0)
    bb = gnn_init(cfg, gen, "cpu")
    head = G.head_init(HID, 5, "mlp", gen, "cpu")
    opt = make_optimizer("adam", lr=5e-3)
    st = G.TrainState(bb, head, None, init_table(ds.n, ds.j_max, HID), 0)
    return make_encode_fn(cfg), opt, st._replace(
        opt_state=opt.init(G.train_params(st)))


def _all_overlap(ds, steps=4, seed=1):
    rng = np.random.default_rng(seed)
    base = rng.permutation(ds.n)[:B_GLOBAL]
    return [rng.permutation(base).astype(np.int64) for _ in range(steps)]


def _run(ds, variant, strategy, sched, prefetch, n_shards=4):
    rows = rows_per_shard(ds.n, n_shards)
    cap = EX.plan_capacity(sched, num_shards=n_shards, rows=rows) \
        if strategy == "bucketed" else None
    pcap = EX.plan_patch_capacity(sched, num_shards=n_shards, rows=rows) \
        if strategy == "bucketed" and prefetch else None
    ctx = DT.make_context(LocalGroup(n_shards), ds.n, exchange=strategy,
                          exchange_cap=cap, prefetch=prefetch,
                          patch_cap=pcap)
    enc, opt, st = _state(ds)
    step = DT.make_dist_train_step(enc, opt, G.VARIANTS[variant], ctx=ctx,
                                   keep_prob=0.5)
    states = DT.device_state(ctx, st)
    batches = [DT.shard_batch(ctx, DP._assemble(ds, ids)) for ids in sched]
    gens = [torch.Generator().manual_seed(3) for _ in ctx.local_ranks]
    if not prefetch:
        for b in batches:
            states, m = step(states, b, gens)
        return ctx, states, m
    lookup = DT.make_prefetch_lookup(ctx)
    b_local = B_GLOBAL // n_shards
    pref = None
    for k, b in enumerate(batches):
        if pref is None:
            pref = lookup([s.table for s in states], [x.graph_ids for x in b])
        if k + 1 < len(batches):
            nb = batches[k + 1]
            nxt = lookup([s.table for s in states],
                         [x.graph_ids for x in nb])
            next_ids = [x.graph_ids for x in nb]
            dest = EX.consumer_shards(sched[k], sched[k + 1],
                                      num_shards=n_shards, rows=rows)
        else:
            next_ids = [torch.full((b_local,), n_shards * rows)
                        for _ in ctx.local_ranks]
            nxt = [(torch.zeros(b_local, ds.j_max, HID),
                    torch.zeros(b_local, ds.j_max, dtype=torch.bool))
                   for _ in ctx.local_ranks]
            dest = np.full(B_GLOBAL, n_shards)
        states, m, pref = step(states, b, gens, None, pref, nxt, next_ids,
                               DT.shard_rows(ctx, dest))
    return ctx, states, m


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("variant", list(G.VARIANTS))
def test_prefetched_training_bitwise_inline_all_variants(dataset, variant,
                                                         strategy):
    """An all-overlap schedule (every row of each batch reappears in the
    next, so every step patches), 4 steps on 4 shards at f32: parameters,
    loss and the table (emb, ages, flags) bitwise the inline run."""
    sched = _all_overlap(dataset)
    ctx_a, sa, ma = _run(dataset, variant, strategy, sched, prefetch=False)
    ctx_b, sb, mb = _run(dataset, variant, strategy, sched, prefetch=True)
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(G.train_params(sa[0]), G.train_params(sb[0])):
        assert torch.equal(x, y)
    assert _bitwise_tables(DT.host_table(ctx_a, sa), DT.host_table(ctx_b, sb))


# ---------------------------------------------------------------------------
# the launcher: a capped table under lookahead pinning, a failing dispatch
# ---------------------------------------------------------------------------


CLI = ["--device", "cpu", "--n-graphs", "64", "--epochs", "2",
       "--finetune-epochs", "1", "--feeder", "sync", "--prefetch-lookups"]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("variant", ["gst_efd", "gst"])
def test_cli_prefetched_run_is_bitwise_inline(variant, strategy):
    """``train_dist --device cpu --devices 4 --prefetch-lookups`` at f32:
    per-epoch losses, finetune, metric, parameters and the final table
    bitwise the inline run (a variant with the table and one without; the
    7 variants x 3 strategies with patching on run above, by hand)."""
    from repro_torch.launch.train_dist import main

    base = ["--device", "cpu", "--devices", "4", "--n-graphs", "32",
            "--epochs", "2", "--finetune-epochs", "1", "--variant", variant,
            "--exchange", strategy]
    a, b = main(base), main(base + ["--prefetch-lookups"])
    assert (a.epoch_losses, a.train_metric, a.finetuned) == \
        (b.epoch_losses, b.train_metric, b.finetuned)
    np.testing.assert_array_equal(a.finetune_loss, b.finetune_loss)
    assert all(torch.equal(x, y)
               for x, y in zip(a.host_params(), b.host_params()))
    assert all(torch.equal(x, y)
               for x, y in zip(a.host_table(), b.host_table()))
    assert b.epoch_exchange_bytes == [b.step_bytes_model * 4] * 2


def test_prefetched_capped_table_is_bitwise_uncapped():
    """2 shards, 64 graphs, --table-device-rows 16 raised to the sync
    lane's window (2 batches a shard: 32 of 64 rows): per-epoch losses,
    parameters and the final table bitwise the uncapped prefetched run,
    rows evicted, no pin exhaustion."""
    from repro_torch.launch.train_dist import main

    base = CLI + ["--devices", "2", "--exchange", "bucketed"]
    a = main(base)
    b = main(base + ["--table-device-rows", "16"])
    assert b.store_stats["device_rows"] == 32
    assert b.store_stats["evictions"] > 0
    assert a.epoch_losses == b.epoch_losses
    assert all(torch.equal(x, y)
               for x, y in zip(a.host_params(), b.host_params()))
    assert all(torch.equal(x, y)
               for x, y in zip(a.host_table(), b.host_table()))
    assert a.epoch_exchange_bytes == [a.step_bytes_model * 8] * 2
    assert a.patch_cap is not None


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_launcher_lane_patches_an_all_overlap_schedule_bitwise_inline(
        strategy):
    """The launcher's own epoch loop (``run_epoch_prefetch``: pinned
    items, dispatch, consumer shards, release) over 4 all-overlap batches
    on 4 shards at f32: every row of the first 3 batches patched, and the
    loss, parameters and table bitwise the inline loop's."""
    argv = CLI[:-1] + ["--devices", "4", "--exchange", strategy,
                       "--exchange-cap", "2", "--patch-cap", "2"]
    loss_a, params_a, table_a, rows_a = all_overlap_run(argv)
    loss_b, params_b, table_b, rows_b = all_overlap_run(
        argv + ["--prefetch-lookups"])
    assert (rows_a, rows_b) == (0, 3 * 8)
    assert loss_a == loss_b
    assert all(torch.equal(x, y) for x, y in zip(params_a, params_b))
    assert all(torch.equal(x, y) for x, y in zip(table_a, table_b))


def test_a_failing_dispatch_fails_the_run_instead_of_hanging(monkeypatch):
    from repro_torch.launch.train_dist import main

    calls = {"n": 0}
    real = EX.RingExchange.prefetch_lookup

    def failing(self, table, graph_ids):
        if self.me == 2:
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("shard 2's lookup failed")
        return real(self, table, graph_ids)

    monkeypatch.setattr(EX.RingExchange, "prefetch_lookup", failing)
    errors = []

    def run():
        try:
            main(CLI + ["--devices", "4", "--exchange", "ring"])
        except BaseException as e:           # checked below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert len(errors) == 1 and "shard 2's lookup failed" in str(errors[0])
