"""The port's table exchange (src/repro_torch/dist/exchange.py) on
``LocalGroup`` shards on the CPU, against the JAX package.

  * every strategy at D in {1, 2, 4, 8}: ``lookup``, ``lookup_ages``,
    ``update_sampled`` and ``update_all`` BIT-exact at f32 against JAX's
    dense single-device table ops (src/repro/core/embedding_table.py), on
    the reference's adversarial row distributions (tests/
    test_exchange_props.py: uniform, one owner, duplicate rows, a shard
    owning nothing);
  * at bf16 / int8: lookups equal JAX's nearest-even round trip of the
    dense rows, and the written table equals JAX's ``quantize_rows_ref``
    round trip of each shard's rows, given the reference's own per-shard
    bits ``bits(fold_in(fold_in(key(0x6E57), step), shard))``
    (src/repro/dist/exchange.py:177-183);
  * ``pad_ragged`` and the sentinel: pad rows read zeros, writes drop them;
  * the comm's byte counters equal each strategy's analytic model for
    every dtype;
  * ``required_capacity``, ``plan_capacity`` and ``select_exchange`` equal
    JAX's on the same schedules.
All comparisons are exact (no tolerance)."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import embedding_table as jtbl  # noqa: E402
from repro.dist import exchange as JEX  # noqa: E402
from repro.kernels.quant import dequantize_rows_ref as jdq  # noqa: E402
from repro.kernels.quant import quantize_rows_ref as jq  # noqa: E402
from repro_torch.core import embedding_table as tbl  # noqa: E402
from repro_torch.dist import exchange as EX  # noqa: E402
from repro_torch.dist.comm import LocalGroup  # noqa: E402
from repro_torch.dist.table import (join_tables, rows_per_shard,  # noqa: E402
                                    split_table)

STRATEGIES = list(EX.EXCHANGES)
N_ROWS, J, DH, B = 64, 2, 4, 8
CASES = ("uniform", "one_owner", "duplicates", "empty_shard")


def _np_table(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_ROWS, J, DH)).astype(np.float32),
            rng.integers(0, 9, (N_ROWS, J)).astype(np.int32),
            rng.integers(0, 2, (N_ROWS, J)).astype(bool))


def _ids(case, D, seed=0):
    """The reference's adversarial id batches (test_exchange_props.py)."""
    rows = rows_per_shard(N_ROWS, D)
    rng = np.random.default_rng(seed)
    if case == "uniform":
        ids = rng.permutation(N_ROWS)[:B]
    elif case == "one_owner":
        ids = rng.permutation(min(rows, N_ROWS))[:B]
    elif case == "duplicates":
        ids = np.concatenate([rng.permutation(N_ROWS)[:B // 2]] * 2)[:B]
    else:
        if D == 1:
            pytest.skip("empty_shard needs >= 2 shards")
        ids = rng.permutation((D - 1) * rows)[:B]
    return np.sort(ids)[rng.permutation(B)].astype(np.int32)


def _payloads(ids):
    """Write payloads derived from the id, so duplicate rows write equal
    values (an order-free scatter, as the reference's oracle needs)."""
    rng = np.random.default_rng(7)
    h = rng.normal(size=(N_ROWS + 1, 1, DH)).astype(np.float32)[ids]
    h_all = rng.normal(size=(N_ROWS + 1, J, DH)).astype(np.float32)[ids]
    sidx = (ids[:, None] % J).astype(np.int32)
    sv = ((ids[:, None] + np.arange(J)[None, :]) % 2).astype(np.float32)
    return sidx, h, h_all, sv


def _jax_bits(step, shard, shape):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0x6E57),
                                                step), shard)
    return np.asarray(jax.random.bits(key, shape, jnp.uint32))


def _run(strategy, D, fn, *, cap=None, dtype="f32", table=None):
    """Run ``fn(exchange, shard_table, rank)`` on D LocalGroup shards of
    ``table``; returns (per-shard results, the joined table)."""
    table = tbl.EmbeddingTable(*(torch.from_numpy(a.copy())
                                 for a in (table or _np_table())))
    shards = split_table(table, D)
    rows = rows_per_shard(N_ROWS, D)

    def shard(i, comm):
        ex = EX.make_exchange(strategy, comm=comm, num_shards=D, rows=rows,
                              cap=cap, payload_dtype=dtype,
                              bits_fn=_jax_bits)
        return fn(ex, shards[i], i)

    return LocalGroup(D).run(shard), join_tables(shards, N_ROWS)


def _slice(x, i, D):
    b = x.shape[0] // D
    return torch.from_numpy(np.ascontiguousarray(x[i * b:(i + 1) * b]))


def _jtable(np_table):
    return jtbl.EmbeddingTable(*(jnp.asarray(a) for a in np_table))


def _assert_tables_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# f32: bit-exact against the dense single-device ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_table_ops_bit_exact_vs_jax_dense(strategy, D, case):
    ids = _ids(case, D)
    sidx, h, h_all, sv = _payloads(ids)
    cap = JEX.required_capacity(ids, num_shards=D,
                                rows=rows_per_shard(N_ROWS, D))
    np_table = _np_table()

    def lookups(ex, table, i):
        my = _slice(ids, i, D).long()
        return ex.lookup(table, my), ex.lookup_ages(table, my)

    out, _ = _run(strategy, D, lookups, cap=cap)
    want_e, want_i = jtbl.lookup(_jtable(np_table), jnp.asarray(ids))
    np.testing.assert_array_equal(
        torch.cat([o[0][0] for o in out]).numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(
        torch.cat([o[0][1] for o in out]).numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(torch.cat([o[1] for o in out]).numpy(),
                                  np_table[1][ids])

    def sampled(ex, table, i):
        ex.update_sampled(table, _slice(ids, i, D).long(),
                          _slice(sidx, i, D).long(), _slice(h, i, D), 5)

    _, got = _run(strategy, D, sampled, cap=cap)
    _assert_tables_equal(got, jtbl.update_sampled(
        _jtable(np_table), jnp.asarray(ids), jnp.asarray(sidx),
        jnp.asarray(h), jnp.int32(5)))

    if case == "duplicates":   # update_all writes whole rows: ids unique
        return

    def whole(ex, table, i):
        ex.update_all(table, _slice(ids, i, D).long(), _slice(h_all, i, D),
                      _slice(sv, i, D), 9)

    _, got = _run(strategy, D, whole, cap=cap)
    _assert_tables_equal(got, jtbl.update_all(
        _jtable(np_table), jnp.asarray(ids), jnp.asarray(h_all),
        jnp.asarray(sv), jnp.int32(9)))


# ---------------------------------------------------------------------------
# bf16 / int8: the reference's codec round trip, given its bits
# ---------------------------------------------------------------------------


def _round_trip(x, dtype, bits=None):
    parts = jq(jnp.asarray(x), dtype, None if bits is None
               else jnp.asarray(bits))
    return np.asarray(jdq(parts, dtype))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_compressed_exchange_equals_reference_codec(strategy, D, dtype):
    ids = _ids("uniform", D)
    sidx, h, h_all, sv = _payloads(ids)
    cap = JEX.required_capacity(ids, num_shards=D,
                                rows=rows_per_shard(N_ROWS, D))
    np_table = _np_table()
    b = B // D

    def lookups(ex, table, i):
        return ex.lookup(table, _slice(ids, i, D).long())

    out, _ = _run(strategy, D, lookups, cap=cap, dtype=dtype)
    want = np.concatenate([_round_trip(np_table[0][ids[i * b:(i + 1) * b]],
                                       dtype) for i in range(D)])
    np.testing.assert_array_equal(torch.cat([o[0] for o in out]).numpy(),
                                  want)

    step = 3
    h_dec = np.concatenate([
        _round_trip(h[i * b:(i + 1) * b], dtype,
                    _jax_bits(step, i, h[i * b:(i + 1) * b].shape))
        for i in range(D)])
    hb = max(b // 2, 1)      # update_all writes each shard's first hb rows

    def writes(ex, table, i):
        my = _slice(ids, i, D).long()
        ex.update_sampled(table, my, _slice(sidx, i, D).long(),
                          _slice(h, i, D), step)
        ex.update_all(table, my[:hb], _slice(h_all, i, D)[:hb],
                      _slice(sv, i, D)[:hb], step)

    _, got = _run(strategy, D, writes, cap=cap, dtype=dtype)
    want_t = jtbl.update_sampled(_jtable(np_table), jnp.asarray(ids),
                                 jnp.asarray(sidx), jnp.asarray(h_dec),
                                 jnp.int32(step))
    half = np.concatenate([np.arange(i * b, i * b + hb) for i in range(D)])
    # update_all packs each shard's rows with bits of their own shape
    h_all_half = np.concatenate([
        _round_trip(h_all[i * b:i * b + hb], dtype,
                    _jax_bits(step, i, h_all[i * b:i * b + hb].shape))
        for i in range(D)])
    want_t = jtbl.update_all(want_t, jnp.asarray(ids[half]),
                             jnp.asarray(h_all_half), jnp.asarray(sv[half]),
                             jnp.int32(step))
    _assert_tables_equal(got, want_t)


# ---------------------------------------------------------------------------
# ragged batches: the sentinel
# ---------------------------------------------------------------------------


def test_pad_ragged_matches_reference():
    ids = np.arange(10, dtype=np.int32)
    h = np.ones((10, 3), np.float32)
    for got, want in zip(EX.pad_ragged(4, 8, ids, h),
                         JEX.pad_ragged(4, 8, ids, h)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    ids_q, n = EX.pad_ragged(2, 8, ids)
    assert n == 10 and ids_q.shape == (10,)


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ragged_batch_end_to_end(strategy, D):
    """2·D + 3 rows padded by pad_ragged: lookups of the real rows equal
    the dense lookup and the pad rows read zeros; the sentinel writes land
    nowhere."""
    rows = rows_per_shard(N_ROWS, D)
    ids = np.random.default_rng(3).permutation(N_ROWS)[:2 * D + 3].astype(
        np.int32)
    sidx, h, _, _ = _payloads(ids)
    ids_p, sidx_p, h_p, n_real = EX.pad_ragged(D, rows, ids, sidx, h)
    assert ids_p.shape[0] % D == 0 and (ids_p[n_real:] == D * rows).all()
    cap = EX.required_capacity(ids_p, num_shards=D, rows=rows)
    np_table = _np_table()

    def fn(ex, table, i):
        my = _slice(ids_p, i, D).long()
        e, init = ex.lookup(table, my)
        ages = ex.lookup_ages(table, my)
        ex.update_sampled(table, my, _slice(sidx_p, i, D).long(),
                          _slice(h_p, i, D), 3)
        return e, init, ages

    out, got = _run(strategy, D, fn, cap=cap)
    e = torch.cat([o[0] for o in out]).numpy()
    init = torch.cat([o[1] for o in out]).numpy()
    ages = torch.cat([o[2] for o in out]).numpy()
    np.testing.assert_array_equal(e[:n_real], np_table[0][ids])
    np.testing.assert_array_equal(init[:n_real], np_table[2][ids])
    assert not e[n_real:].any() and not init[n_real:].any()
    assert not ages[n_real:].any()
    _assert_tables_equal(got, jtbl.update_sampled(
        _jtable(np_table), jnp.asarray(ids), jnp.asarray(sidx),
        jnp.asarray(h), jnp.int32(3)))


# ---------------------------------------------------------------------------
# bytes: the comm's counters against the analytic models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_counted_bytes_equal_the_model(strategy, D, dtype):
    S, b_local = 2, 2
    Bg = b_local * D
    ids = np.arange(Bg, dtype=np.int32) * (N_ROWS // Bg)
    cap = 2 if D > 1 else None

    def fn(ex, table, i):
        c = ex.comm
        my = _slice(ids, i, D).long()
        c.reset_counts()
        ex.lookup(table, my)
        look = c.exchange_bytes
        c.reset_counts()
        ex.update_sampled(table, my, torch.zeros(b_local, S, dtype=torch.long),
                          torch.ones(b_local, S, DH), 1)
        upd = c.exchange_bytes
        c.reset_counts()
        ex.update_all(table, my, torch.ones(b_local, J, DH),
                      torch.ones(b_local, J), 2)
        return (look, upd, c.exchange_bytes,
                ex.lookup_bytes(b_local, J, DH),
                ex.update_sampled_bytes(b_local, S, DH),
                ex.update_all_bytes(b_local, J, DH))

    out, _ = _run(strategy, D, fn, cap=cap, dtype=dtype)
    for o in out:
        assert o[:3] == o[3:], (strategy, D, dtype, o)
    # the models are the reference's, byte for byte
    jex = JEX.make_exchange(strategy, axis_name="x", num_shards=D, rows=8,
                            cap=cap, payload_dtype=dtype)
    assert out[0][3:] == (jex.lookup_bytes(b_local, J, DH),
                          jex.update_sampled_bytes(b_local, S, DH),
                          jex.update_all_bytes(b_local, J, DH))


# ---------------------------------------------------------------------------
# host planning and the auto policy
# ---------------------------------------------------------------------------


def test_capacity_planning_matches_reference():
    rng = np.random.default_rng(11)
    for D, n in itertools.product((1, 2, 4, 8), (64, 61)):
        rows = rows_per_shard(n, D)
        sched = [rng.permutation(n)[:8 * D].astype(np.int32)
                 for _ in range(5)]
        sched.append(np.arange(8 * D, dtype=np.int32) % rows)  # one owner
        for ids in sched:
            assert EX.required_capacity(ids, num_shards=D, rows=rows) == \
                JEX.required_capacity(ids, num_shards=D, rows=rows)
        assert EX.plan_capacity(sched, num_shards=D, rows=rows) == \
            JEX.plan_capacity(sched, num_shards=D, rows=rows)
        ragged = rng.permutation(n)[:8 * D + 1]
        assert EX.required_capacity(ragged, num_shards=D, rows=rows) == \
            JEX.required_capacity(ragged, num_shards=D, rows=rows)


def test_select_exchange_matches_reference():
    for D, b_local, j_max, s, d_h, dtype in itertools.product(
            (1, 2, 4, 8, 16), (1, 2, 8, 32), (4, 20), (1, 2), (32, 64),
            ("f32", "bf16", "int8")):
        for cap in (None, 1, b_local):
            assert EX.select_exchange(D, b_local, j_max, s, d_h, cap=cap,
                                      payload_dtype=dtype) == \
                JEX.select_exchange(D, b_local, j_max, s, d_h, cap=cap,
                                    payload_dtype=dtype)


def test_make_exchange_rejects_unknown_and_auto():
    with pytest.raises(ValueError, match="auto"):
        EX.make_exchange("auto", num_shards=2, rows=4)
    with pytest.raises(ValueError, match="unknown exchange"):
        EX.make_exchange("mesh", num_shards=2, rows=4)
    with pytest.raises(ValueError, match="unknown payload dtype"):
        EX.PayloadCodec("fp8")
    # one shard: nothing crosses a wire, the codec is pinned to f32
    assert EX.make_exchange("ring", num_shards=1, rows=4,
                            payload_dtype="int8").payload_dtype == "f32"


def test_table_drop_mode_skips_rows_outside():
    t = tbl.init_table(4, 2, 3)
    tbl.update_sampled(t, torch.tensor([1, 4, -1]), torch.zeros(3, 1).long(),
                       torch.ones(3, 1, 3), 7, mode="drop")
    assert t.initialized[:, 0].tolist() == [False, True, False, False]
    tbl.update_all(t, torch.tensor([9, 2]), torch.full((2, 2, 3), 2.0),
                   torch.ones(2, 2), 8, mode="drop")
    assert t.age[2].tolist() == [8, 8] and float(t.emb[2].sum()) == 12.0
    with pytest.raises(IndexError):
        tbl.update_sampled(t, torch.tensor([4]), torch.zeros(1, 1).long(),
                           torch.ones(1, 1, 3), 7)


def test_ring_entry_points_are_the_ring_strategy():
    """dist/table.py's ring_* functions (the reference's original API)
    answer and write as RingExchange does, at 4 shards."""
    from repro_torch.dist import table as dtbl

    D, rows = 4, rows_per_shard(N_ROWS, 4)
    ids = _ids("uniform", D)
    sidx, h, h_all, sv = _payloads(ids)
    np_table = _np_table()

    def fn(ex, table, i):
        my, c = _slice(ids, i, D).long(), ex.comm
        e, init = dtbl.ring_lookup(table, my, comm=c, rows=rows)
        dtbl.ring_update_sampled(table, my, _slice(sidx, i, D).long(),
                                 _slice(h, i, D), 4, comm=c, rows=rows)
        dtbl.ring_update_all(table, my[:1], _slice(h_all, i, D)[:1],
                             _slice(sv, i, D)[:1], 6, comm=c, rows=rows)
        return e, init

    out, got = _run("ring", D, fn)
    np.testing.assert_array_equal(torch.cat([o[0] for o in out]).numpy(),
                                  np_table[0][ids])
    first = ids.reshape(D, -1)[:, 0]
    want = jtbl.update_sampled(_jtable(np_table), jnp.asarray(ids),
                               jnp.asarray(sidx), jnp.asarray(h), jnp.int32(4))
    want = jtbl.update_all(want, jnp.asarray(first),
                           jnp.asarray(h_all.reshape(D, -1, J, DH)[:, 0]),
                           jnp.asarray(sv.reshape(D, -1, J)[:, 0]),
                           jnp.int32(6))
    _assert_tables_equal(got, want)
