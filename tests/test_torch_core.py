"""The port's GST core (segment sampling, SED, aggregation, AdamW, the
historical table's writes) against the JAX package's.

Given the same uniforms ``u`` and indices, the port's SED weights, sampled
mask and table writes are held to JAX bitwise where the reference is exact
(masks, ages, ``initialized``) and at f32 1e-5 elsewhere; AdamW over 5 steps
at 1e-6 (the update's own rounding).  The port's own Gumbel top-k draws
come from a ``torch.Generator`` and are checked for what they must be:
valid, distinct, uniform over the valid segments (the twins of
tests/test_gst_core.py:23,39).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import embedding_table as jtbl  # noqa: E402
from repro.core import segment as jseg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.core import embedding_table as tbl  # noqa: E402
from repro_torch.core import segment as seg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def _masks(B, J, S, seed):
    rng = np.random.default_rng(seed)
    valid = (rng.uniform(size=(B, J)) < 0.7).astype(np.float32)
    valid[:, :S] = 1.0
    idx = np.stack([rng.choice(np.flatnonzero(v), S, replace=False)
                    for v in valid]).astype(np.int32)
    u = rng.uniform(size=(B, J)).astype(np.float32)
    return valid, idx, u


# ---------------------------------------------------------------------------
# sampling, SED and aggregation, given the same draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,keep_prob", [(1, 0.5), (2, 0.3), (3, 0.9)])
def test_sed_from_uniform_and_sampled_mask_match_jax(S, keep_prob):
    valid, idx, u = _masks(6, 11, S, seed=S)
    fresh = seg.sampled_mask(torch.from_numpy(idx), 11) * torch.from_numpy(valid)
    jfresh = jseg.sampled_mask(jnp.asarray(idx), 11) * jnp.asarray(valid)
    np.testing.assert_array_equal(fresh.numpy(), np.asarray(jfresh))
    eta, drop = seg._sed_from_uniform(torch.from_numpy(u),
                                      torch.from_numpy(valid), fresh,
                                      keep_prob, S)
    jeta, jdrop = jseg._sed_from_uniform(jnp.asarray(u), jnp.asarray(valid),
                                         jfresh, keep_prob, S)
    np.testing.assert_array_equal(drop.numpy(), np.asarray(jdrop))
    np.testing.assert_array_equal(eta.numpy(), np.asarray(jeta))


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_aggregate_matches_jax(mode):
    valid, _, u = _masks(5, 9, 1, seed=4)
    h = np.random.default_rng(5).normal(size=(5, 9, 16)).astype(np.float32)
    got = seg.aggregate(torch.from_numpy(h), torch.from_numpy(u),
                        torch.from_numpy(valid), mode)
    want = jseg.aggregate(jnp.asarray(h), jnp.asarray(u), jnp.asarray(valid),
                          mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sed_weights_draws_from_the_generator():
    valid, idx, _ = _masks(4, 8, 1, seed=0)
    sv = torch.from_numpy(valid)
    fresh = seg.sampled_mask(torch.from_numpy(idx), 8) * sv
    a = seg.sed_weights(torch.Generator().manual_seed(3), sv, fresh, 0.5, 1)
    b = seg.sed_weights(torch.Generator().manual_seed(3), sv, fresh, 0.5, 1)
    u = torch.rand(sv.shape, generator=torch.Generator().manual_seed(3))
    c = seg._sed_from_uniform(u, sv, fresh, 0.5, 1)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("B,J,S,seed", [(1, 2, 1, 0), (8, 16, 3, 1),
                                        (5, 7, 2, 2), (3, 12, 1, 3)])
def test_sample_segments_valid_and_distinct(B, J, S, seed):
    rng = np.random.default_rng(seed)
    valid = (rng.uniform(size=(B, J)) < 0.7).astype(np.float32)
    valid[:, 0] = 1.0
    idx = seg.sample_segments(torch.Generator().manual_seed(seed),
                              torch.from_numpy(valid), S).numpy()
    assert idx.shape == (B, S)
    for b in range(B):
        assert len(set(idx[b].tolist())) == S                 # distinct
        if valid[b].sum() >= S:                               # only valid
            assert all(valid[b, c] == 1.0 for c in idx[b])


def test_sampling_is_uniform_over_valid():
    n, J = 4000, 5
    valid = torch.ones(n, J)
    valid[:, 3] = 0.0
    idx = seg.sample_segments(torch.Generator().manual_seed(0), valid, 1)
    counts = np.bincount(idx[:, 0].numpy(), minlength=J)
    assert counts[3] == 0
    np.testing.assert_allclose(counts[counts > 0] / n, 0.25, atol=0.03)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_grad_norm", [0.0, 1.0, 100.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_jax_over_five_steps(max_grad_norm, weight_decay):
    """max_grad_norm 1.0 clips (the gradients' norm is ~10), 100 does not,
    0 turns clipping off."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), (1,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[3.0 * rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    kw = dict(lr=1e-2, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    params = [torch.from_numpy(p.copy()) for p in p0]
    state = adamw.adamw_init(params)
    jparams = [jnp.asarray(p) for p in p0]
    jstate = jadamw.adamw_init(jparams)
    for g in grads:
        params, state, m = adamw.adamw_update(
            params, [torch.from_numpy(x) for x in g], state, **kw)
        jparams, jstate, jm = jadamw.adamw_update(
            jparams, [jnp.asarray(x) for x in g], jstate, **kw)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert state["step"] == int(jstate["step"]) == 5
    for a, b in zip(params + state["mu"] + state["nu"],
                    jparams + jstate["mu"] + jstate["nu"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_adamw_updates_in_place_and_make_optimizer_clips():
    p = torch.ones(3)
    ptr = p.data_ptr()
    opt = adamw.make_optimizer("adam", lr=0.1)
    state = opt.init([p])
    (p2,), state, m = opt.update([p], [torch.full((3,), 10.0)], state)
    assert p2 is p and p.data_ptr() == ptr
    assert float(m["grad_norm"]) == pytest.approx(10 * np.sqrt(3))
    # clipped to norm 1.0: mu = 0.1 * g * (1 / |g|)
    np.testing.assert_allclose(state["mu"][0].numpy(),
                               0.1 * 10 / (10 * np.sqrt(3)), rtol=1e-6)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((5, 2), (7,))]
    for max_norm in (0.5, 50.0):
        got, n = adamw.clip_by_global_norm(
            [torch.from_numpy(g) for g in grads], max_norm)
        want, jn = jadamw.clip_by_global_norm(
            [jnp.asarray(g) for g in grads], max_norm)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_schedules_match_jax():
    for kw in (dict(base_lr=1e-3, total_steps=100),
               dict(base_lr=3e-4, total_steps=50, warmup=10, final_frac=0.1)):
        lr, jlr = adamw.cosine_schedule(**kw), jadamw.cosine_schedule(**kw)
        for step in (0, 1, 5, 10, 11, 25, 49, 50, 120):
            np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{kw} {step}")
    assert adamw.constant_schedule(5e-3)(7) == float(
        jadamw.constant_schedule(5e-3)(7))


# ---------------------------------------------------------------------------
# the historical table's writes
# ---------------------------------------------------------------------------


def test_table_writes_match_jax():
    n, J, d, B = 10, 6, 4, 3
    rng = np.random.default_rng(2)
    table = tbl.init_table(n, J, d)
    jtable = jtbl.init_table(n, J, d)
    ptrs = [t.data_ptr() for t in table]
    ids = np.array([7, 2, 5], np.int32)
    idx = np.array([[0, 3], [5, 1], [2, 4]], np.int32)
    h_s = rng.normal(size=(B, 2, d)).astype(np.float32)
    table = tbl.update_sampled(table, torch.from_numpy(ids).long(),
                               torch.from_numpy(idx).long(),
                               torch.from_numpy(h_s), 3)
    jtable = jtbl.update_sampled(jtable, jnp.asarray(ids), jnp.asarray(idx),
                                 jnp.asarray(h_s), jnp.int32(3))
    h_all = rng.normal(size=(2, J, d)).astype(np.float32)
    sv = (rng.uniform(size=(2, J)) < 0.6).astype(np.float32)
    ids2 = np.array([5, 9], np.int32)
    table = tbl.update_all(table, torch.from_numpy(ids2).long(),
                           torch.from_numpy(h_all), torch.from_numpy(sv), 4)
    jtable = jtbl.update_all(jtable, jnp.asarray(ids2), jnp.asarray(h_all),
                             jnp.asarray(sv), jnp.int32(4))
    for got, want in zip(table, jtable):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [t.data_ptr() for t in table] == ptrs        # written in place
    emb, init = tbl.lookup(table, torch.tensor([5, 7]))
    jemb, jinit = jtbl.lookup(jtable, jnp.asarray([5, 7]))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
    np.testing.assert_array_equal(init.numpy(), np.asarray(jinit))
