"""Property tests of the port's tiered store (src/repro_torch/store/):
the tier invariants of tests/test_store_props.py, on the CPU.

Random (geometry, batch sequence) draws, through hypothesis where it is
installed (tests/_hypothesis_compat.py otherwise), checked after EVERY
prepare and in-place update against a dense table written the same way:

  * device-tier occupancy never exceeds the per-shard capacity C, and no
    two rows share a slot;
  * every row is authoritative in exactly one tier: the resident rows
    answer from the device tables, the rest from the host tier, and the
    merged snapshot equals the dense table bit for bit;
  * lookups after ANY eviction or fetch sequence are bitwise the dense
    table's, under both eviction policies; stale-first only changes WHICH
    row migrates.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.core import embedding_table as tbl  # noqa: E402
from repro_torch.store import SlotMap, TieredStore  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _slot_lookup(store, tables, slots):
    """Rows of the step's slot ids across the shards' (C, J, d) tables."""
    C = store.device_rows_per_shard
    slots = np.asarray(slots, np.int64)
    emb = torch.stack([tables[s // C].emb[s % C] for s in slots])
    init = torch.stack([tables[s // C].initialized[s % C] for s in slots])
    return emb, init


def _slot_update(store, tables, slots, sidx, h, step):
    C = store.device_rows_per_shard
    for s, si, hv in zip(np.asarray(slots, np.int64), sidx, h):
        tbl.update_sampled(tables[s // C], _t([s % C]), _t(si[None]),
                           torch.from_numpy(hv[None]), step)


def _random_ops(store, tables, oracle, rng, n_steps, batch):
    """Identical random lookups and updates through the tiered store and the
    dense table; yields after each for the invariant checks."""
    n, J, d = oracle.emb.shape
    R, C = store.rows_per_shard, store.device_rows_per_shard
    for t in range(n_steps):
        # per-shard draws, so a batch never needs more than C rows of a
        # shard resident (the capacity contract)
        ids = []
        for s in range(store.num_shards):
            lo, hi = s * R, min((s + 1) * R, n)
            if lo >= n:
                continue
            k = min(batch, C, hi - lo)
            ids.extend(rng.choice(np.arange(lo, hi), size=k, replace=False))
        ids = np.asarray(ids, np.int64)
        h = rng.normal(size=(len(ids), 1, d)).astype(np.float32)
        sidx = rng.integers(0, J, (len(ids), 1))

        tables, slots = store.prepare(tables, ids, step=t)
        got = _slot_lookup(store, tables, slots)
        want = tbl.lookup(oracle, _t(ids))
        _slot_update(store, tables, slots, sidx, h, t)
        tbl.update_sampled(oracle, _t(ids), _t(sidx), torch.from_numpy(h), t)
        yield tables, ids, slots, got, want


@settings(max_examples=8, deadline=None)
@given(n=st.integers(5, 30), device_frac=st.floats(0.1, 0.9),
       num_shards=st.sampled_from([1, 2, 4]), seed=st.integers(0, 10**6),
       policy=st.sampled_from(["lru", "stale-first"]))
def test_tier_invariants_hold_under_random_churn(n, device_frac, num_shards,
                                                 seed, policy):
    rng = np.random.default_rng(seed)
    J, d = 2, 4
    store = TieredStore(n, J, d, num_shards=num_shards,
                        device_rows=max(1, int(n * device_frac)),
                        evict_policy=policy)
    tables = store.init_shard_tables()
    oracle = tbl.init_table(n, J, d)
    C, R = store.device_rows_per_shard, store.rows_per_shard
    for tables, ids, slots, got, want in _random_ops(
            store, tables, oracle, rng, n_steps=12, batch=3):
        # lookups bitwise the dense table's after any eviction sequence
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # occupancy within C a shard, no slot shared, rows on their shard
        resident = {}
        for s, m in enumerate(store._maps):
            assert len(m) <= C
            entries = dict(m.items())
            assert len(set(entries.values())) == len(entries)
            for row, slot in entries.items():
                assert s * R <= row < min((s + 1) * R, n)
                resident[row] = s * C + slot
        # the batch's slot ids agree with the residency map
        for rid, slot in zip(ids, slots):
            assert resident[int(rid)] == int(slot)
            assert store.resident_slot(int(rid)) == int(slot)
        assert store.occupancy() == len(resident)
        if policy == "lru" and len(ids):
            # exactly one tier: a row not resident is the host tier's
            for row in range(n):
                assert (store.resident_slot(row) is None) == \
                    (row not in resident)

    store.flush_writebacks()
    snap = store.snapshot(tables)
    for a, b in zip(snap, oracle):
        assert torch.equal(a, b)
    store.close()


@settings(max_examples=10, deadline=None)
@given(capacity=st.integers(1, 8), n_keys=st.integers(1, 24),
       seed=st.integers(0, 10**6))
def test_slotmap_never_leaks_or_doubles_slots(capacity, n_keys, seed):
    rng = np.random.default_rng(seed)
    m = SlotMap(capacity)
    live = {}
    for _ in range(3 * n_keys):
        key = int(rng.integers(n_keys))
        if key in m:
            if rng.random() < 0.3:
                slot = m.release(key)
                assert live.pop(key) == slot
            else:
                assert m.get(key) == live[key]
            continue
        slot, evicted = m.reserve(key)
        assert slot is not None
        if evicted is not None:
            assert live.pop(evicted[0]) == evicted[1] == slot
        live[key] = slot
        assert len(m) == len(live) <= capacity
        assert len(set(live.values())) == len(live)


@settings(max_examples=6, deadline=None)
@given(n=st.integers(4, 20), seed=st.integers(0, 10**6))
def test_min_capacity_single_slot_store_stays_exact(n, seed):
    """A one-row device tier: every step evicts, every lookup faults, and
    the store stays bitwise the dense table."""
    rng = np.random.default_rng(seed)
    store = TieredStore(n, 1, 3, device_rows=1)
    table = store.init_device_table()
    oracle = tbl.init_table(n, 1, 3)
    z = torch.zeros((1, 1), dtype=torch.long)
    for t in range(10):
        row = int(rng.integers(n))
        h = torch.from_numpy(rng.normal(size=(1, 1, 3)).astype(np.float32))
        table, slots = store.prepare(table, np.asarray([row]))
        tbl.update_sampled(table, _t(slots), z, h, t)
        tbl.update_sampled(oracle, _t([row]), z, h, t)
    snap = store.snapshot(table)
    assert all(torch.equal(a, b) for a, b in zip(snap, oracle))
    store.close()


def _aged_store(policy, C=4):
    """8 rows with known ages (5, 1, 9, 1, 20, 20, 20, 3) restored into a
    store whose device tier holds C of them."""
    rng = np.random.default_rng(0)
    n, J, d = 8, 2, 3
    ages = np.array([5, 1, 9, 1, 20, 20, 20, 3])
    snap = tbl.EmbeddingTable(
        torch.from_numpy(rng.normal(size=(n, J, d)).astype(np.float32)),
        torch.from_numpy(np.tile(ages[:, None], (1, J)).astype(np.int32)),
        torch.ones(n, J, dtype=torch.bool))
    store = TieredStore(n, J, d, device_rows=C, evict_policy=policy)
    (table,) = store.restore(snap)
    return store, table, snap


def test_stale_first_evicts_stale_and_cold_rows_first():
    store, table, snap = _aged_store("stale-first")
    table, _ = store.prepare(table, np.asarray([0, 1, 2, 3]))  # tier full
    # rows 1 and 3 are equally stale (age 1); row 1 is colder, so it
    # leaves first, NOT row 0, the LRU victim
    table, _ = store.prepare(table, np.asarray([4]))
    assert store.resident_slot(1) is None
    assert all(store.resident_slot(r) is not None for r in (0, 2, 3, 4))
    table, _ = store.prepare(table, np.asarray([5]))
    assert store.resident_slot(3) is None                      # age 1
    table, _ = store.prepare(table, np.asarray([6]))
    assert store.resident_slot(0) is None                      # age 5
    assert store.resident_slot(2) is not None                  # fresh: 9
    # the policy never touched the math: the merged view is the restored
    # snapshot, and an evicted row faults back exact
    store.flush_writebacks()
    assert all(torch.equal(a, b) for a, b in zip(store.snapshot(table), snap))
    table, slots = store.prepare(table, np.asarray([1]))
    e, i = tbl.lookup(table, _t(slots))
    assert torch.equal(e[0], snap.emb[1]) and torch.equal(
        i[0], snap.initialized[1])
    store.close()


def test_stale_first_step_hint_keeps_rewritten_resident_rows():
    """A resident row a train step is about to rewrite (the ``step`` hint)
    stops scoring as stale as its fault-in age."""
    store, table, _ = _aged_store("stale-first")
    table, _ = store.prepare(table, np.asarray([0, 1, 2, 3]))
    table, _ = store.prepare(table, np.asarray([1]), step=100)
    table, _ = store.prepare(table, np.asarray([4]))
    assert store.resident_slot(3) is None
    assert store.resident_slot(1) is not None
    store.close()


def test_lru_contrast_evicts_coldest_not_stalest():
    store, table, _ = _aged_store("lru")
    table, _ = store.prepare(table, np.asarray([0, 1, 2, 3]))
    table, _ = store.prepare(table, np.asarray([4]))
    assert store.resident_slot(0) is None     # coldest, despite mid age
    assert store.resident_slot(1) is not None  # stalest but newer in LRU
    store.close()


def test_refresh_ages_reports_device_ages_to_stale_first():
    """A row rewritten while resident (its device age plane advanced) stops
    being the stale-first victim once refresh_ages reads the device ages
    back; before it, it still scores by its fault-in age."""
    store, table, _ = _aged_store("stale-first")
    table, slots = store.prepare(table, np.asarray([0, 1, 2, 3]))
    # row 1 (fault-in age 1) is rewritten on the device at step 50
    tbl.update_sampled(table, _t(slots[1:2]), _t([[0]]),
                       torch.zeros(1, 1, 3), 50)
    store.refresh_ages(table)
    table, _ = store.prepare(table, np.asarray([4]))
    assert store.resident_slot(1) is not None
    assert store.resident_slot(3) is None      # the stalest now
    store.close()
