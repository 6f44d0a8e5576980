"""The redesigned sed_pool / sed_pool_aged kernels' arithmetic, on the CPU.

The CUDA kernels (``src/repro_torch/kernels/csrc/sed_pool.cu``) cannot run
here, so their documented summation order is replayed in f32 torch from the
wrapper's own launch geometry (``sed_pool.plan``): j-lane i sums
j = i, i + TY, ... in order with one FMA a step (emulated in f64 and
rounded once to f32), the TY partials join by adjacent pairs,
((p0 + p1) + (p2 + p3)) + ..., and the mean multiplies by the rounded
reciprocal of max(J_b, 1) last.  That replay is held against
JAX's Pallas ``sed_pool`` (interpret mode, as the JAX tests run it) and
the jnp oracle ``repro.kernels.ref.sed_pool_ref`` at the reference's own
tolerance (tests/test_fused_path.py:48: f32 1e-5, bf16 6e-2).  The
backward that reads the forward's η and J_b (``sed_pool.dh_from_eta``) is
held against ``jax.grad`` through the Pallas kernels' custom VJPs at 1e-4.
The kernels themselves are held to the plain version on the card in
tests/test_torch_kernels_gpu.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sed_pool import sed_pool as jax_sed_pool  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import sed_pool as sp  # noqa: E402

KEEP, NUM_SAMPLED = 0.6, 2


def _inputs(B, J, d, seed):
    """Rows of 1..J valid segments (row 0 full), up to NUM_SAMPLED fresh
    ones a row, random drops (row 1 drops every stale segment), ages
    0..29."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, J, d)).astype(np.float32)
    n_valid = rng.integers(1, J + 1, B)
    n_valid[0] = J
    valid = (np.arange(J)[None, :] < n_valid[:, None]).astype(np.float32)
    fresh = np.zeros((B, J), np.float32)
    for b in range(B):
        k = min(NUM_SAMPLED, n_valid[b])
        fresh[b, rng.choice(n_valid[b], k, replace=False)] = 1.0
    drop = (rng.uniform(size=(B, J)) > 0.5).astype(np.float32)
    drop[min(1, B - 1)] = 1.0
    ages = rng.integers(0, 30, (B, J)).astype(np.float32)
    return h, valid, fresh, drop, ages


def emulate_kernel(h, valid, fresh, drop, ages, keep_prob, num_sampled, agg,
                   decay, geometry):
    """csrc/sed_pool.cu's sum in its order, for the geometry ``plan`` gave:
    η as ref.sed_eta builds it, each j-lane's FMA chain, the fixed tree
    over the TY lanes, the mean's reciprocal; out in h's dtype."""
    eta, J_b = ref.sed_eta(valid, fresh, drop, keep_prob, num_sampled,
                           ages if decay > 0 else None, decay)
    B, J, d = h.shape
    TY = geometry.ty
    K = -(-J // TY)
    hp = torch.zeros(B, K * TY, d, dtype=torch.float64)
    hp[:, :J] = h.float().double()
    ep = torch.zeros(B, K * TY, dtype=torch.float64)
    ep[:, :J] = eta.double()
    hp, ep = hp.reshape(B, K, TY, d), ep.reshape(B, K, TY, 1)
    acc = torch.zeros(B, TY, d, dtype=torch.float32)
    for k in range(K):            # fmaf: the product exact in f64, one add
        acc = (ep[:, k] * hp[:, k] + acc.double()).float()
    while acc.shape[1] > 1:       # adjacent pairs: (p0 + p1) + (p2 + p3)
        acc = acc[:, 0::2] + acc[:, 1::2]
    out = acc[:, 0]
    if agg == "mean":
        out = out * (1.0 / torch.clamp(J_b, min=1.0))
    return out.to(h.dtype)


def _jax_pool(h, valid, fresh, drop, ages, agg, decay):
    jm = [jnp.asarray(a) for a in (valid, fresh, drop)]
    kw = dict(keep_prob=KEEP, num_sampled=NUM_SAMPLED, agg=agg,
              ages=jnp.asarray(ages), decay=decay)
    pallas = jax_sed_pool(jnp.asarray(h), *jm, interpret=True, **kw)
    oracle = jref.sed_pool_ref(jnp.asarray(h), *jm, KEEP, NUM_SAMPLED, agg,
                               jnp.asarray(ages), decay)
    return np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("decay", [0.0, 0.05])
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("d", [1, 3, 64, 130])
@pytest.mark.parametrize("J", [1, 7, 20, 64, 300])
def test_emulated_kernel_order_matches_jax(J, d, agg, decay):
    """The kernel's summation order (one launch, f32) within 1e-5 of JAX's
    Pallas kernel and of its oracle, λ > 0 through the aged kernels."""
    h, valid, fresh, drop, ages = _inputs(3, J, d, seed=J * 131 + d)
    geometry = sp.plan(J, d, 4, 0)
    got = emulate_kernel(*map(torch.from_numpy, (h, valid, fresh, drop,
                                                 ages)),
                         KEEP, NUM_SAMPLED, agg, decay, geometry).numpy()
    pallas, oracle = _jax_pool(h, valid, fresh, drop, ages, agg, decay)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("decay", [0.0, 0.05])
@pytest.mark.parametrize("J,d", [(20, 64), (300, 130), (7, 3)])
def test_emulated_kernel_order_bf16_matches_jax(J, d, decay):
    """bf16 h: the kernel widens h to f32, sums in f32 and rounds once at
    the store; within 6e-2 of JAX's Pallas kernel on the same bf16 h."""
    h, valid, fresh, drop, ages = _inputs(4, J, d, seed=J + d)
    hb = torch.from_numpy(h).bfloat16()
    geometry = sp.plan(J, d, 2, 0)
    got = emulate_kernel(hb, *map(torch.from_numpy, (valid, fresh, drop,
                                                     ages)),
                         KEEP, NUM_SAMPLED, "mean", decay, geometry)
    assert got.dtype == torch.bfloat16
    pallas, _ = _jax_pool(jnp.asarray(hb.float().numpy()).astype(
        jnp.bfloat16), valid, fresh, drop, ages, "mean", decay)
    np.testing.assert_allclose(got.float().numpy(),
                               pallas.astype(np.float32), rtol=6e-2,
                               atol=6e-2)


@pytest.mark.parametrize("decay", [0.0, 0.05])
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("J,d", [(20, 64), (16, 1), (300, 3)])
def test_eta_residual_backward_matches_jax_vjp(J, d, agg, decay):
    """dh from the forward's η and J_b (here ref.sed_eta's, which the kernel
    writes) equals jax.grad through the Pallas kernel's custom VJP."""
    h, valid, fresh, drop, ages = _inputs(5, J, d, seed=7 * J + d)
    g = np.random.default_rng(J).normal(size=(5, d)).astype(np.float32)
    eta, J_b = ref.sed_eta(*map(torch.from_numpy, (valid, fresh, drop)), KEEP,
                           NUM_SAMPLED, torch.from_numpy(ages), decay)
    assert J_b.shape == (5, 1)
    dh = sp.dh_from_eta(torch.from_numpy(g), eta, J_b, agg, torch.float32)

    jm = [jnp.asarray(a) for a in (valid, fresh, drop)]
    want = jax.grad(lambda hh: jnp.sum(jax_sed_pool(
        hh, *jm, keep_prob=KEEP, num_sampled=NUM_SAMPLED, agg=agg,
        ages=jnp.asarray(ages), decay=decay, interpret=True) * g))(
            jnp.asarray(h))
    np.testing.assert_allclose(dh.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("J,d,itemsize,address,want", [
    (20, 64, 4, 0, (16, 16, 4, 1)),          # the train step's pooling
    (16, 1, 4, 0, (4, 1, 2, 1)),             # the segment_sum head's
    (64, 256, 4, 0, (16, 32, 8, 2)),         # the stress shape
    (1, 1, 4, 0, (4, 1, 1, 1)),
    (300, 64, 4, 0, (16, 16, 16, 1)),        # J longer than one chunk
    (20, 2, 4, 0, (8, 1, 4, 1)),             # below one 16-byte vector
    (20, 130, 2, 0, (4, 32, 4, 3)),          # bf16, d not a multiple of 8
    (20, 130, 4, 0, (8, 32, 4, 3)),
    (20, 64, 4, 4, (4, 32, 4, 2)),           # h one element past 16 B
    (20, 64, 2, 2, (2, 32, 4, 2)),
    (5000, 8, 2, 0, (16, 1, 256, 1)),        # J above one eta tile (2048)
    (0, 64, 4, 0, (16, 16, 1, 1)),
    (20, 20, 4, 0, (16, 8, 4, 1)),           # 5 vectors: tx rounds up to 8
    (20, 3, 4, 0, (4, 4, 4, 1)),
])
def test_plan_geometry(J, d, itemsize, address, want):
    """The launch geometry: the widest load every row start keeps aligned,
    a power of two of at most 32 vectors and 256 threads a block, TY the
    power of two that holds J in one chunk a thread, the column tiles
    covering d."""
    p = sp.plan(J, d, itemsize, address)
    assert tuple(p) == want
    assert p.vec_bytes >= itemsize and address % p.vec_bytes == 0
    assert (d * itemsize) % p.vec_bytes == 0
    assert p.ty & (p.ty - 1) == 0 and p.tx & (p.tx - 1) == 0 and p.tx <= 32
    assert p.tx * p.ty <= sp.MAX_THREADS
    assert p.col_tiles * p.tx * (p.vec_bytes // itemsize) >= d
