"""The port's Theorem 4.1 estimators (``repro_torch.core.theory``) against
the JAX package's, and the theorem's checks of tests/test_theory.py
reproduced through the port's own sampler (``repro_torch.core.segment``):
SED with keep ratio p cuts the stale-embedding bias by exactly p, at the
cost of a regularization (second-moment) term that grows as p drops."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import theory as jtheory  # noqa: E402
from repro_torch.core import segment as seg  # noqa: E402
from repro_torch.core import theory  # noqa: E402

CASES = [(6, 1, 0.25), (6, 1, 0.5), (6, 1, 0.75), (5, 1, 0.0), (5, 1, 1.0),
         (16, 4, 0.5)]


def _inputs(J, d=4, seed=0, spread=0.5):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(J, d)).astype(np.float32)
    h_tilde = (h + rng.normal(size=(J, d)) * spread).astype(np.float32)
    return h, h_tilde


@pytest.mark.parametrize("J,S,p", CASES)
def test_estimators_match_jax(J, S, p):
    h, ht = _inputs(J, seed=J)
    th, tht = torch.from_numpy(h), torch.from_numpy(ht)
    jh, jht = jnp.asarray(h), jnp.asarray(ht)
    pairs = [(theory.delta_moments_et(th, tht, J, S),
              jtheory.delta_moments_et(jh, jht, J, S)),
             (theory.delta_moments_sed(th, tht, J, S, p),
              jtheory.delta_moments_sed(jh, jht, J, S, p))]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    got = theory.bias_reduction_factor(th, tht, J, S, p)
    want = jtheory.bias_reduction_factor(jh, jht, J, S, p)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _simulate_delta(h, h_tilde, J, S, p, n, use_sed, gen):
    """Monte-Carlo E[δ_j], δ = (η-weighted observed) - (true), per segment:
    the n draws are the rows of one (n, J) batch through the port's
    sampler, from one generator."""
    valid = torch.ones(n, J)
    idx = seg.sample_segments(gen, valid, S)
    fresh = seg.sampled_mask(idx, J)
    observed = torch.where(fresh[..., None] > 0, h, h_tilde)
    if use_sed:
        eta, _ = seg.sed_weights(gen, valid, fresh, p, S)
        observed = eta[..., None] * observed
    return (observed - h).mean(dim=0).numpy()


@pytest.mark.parametrize("p", [0.25, 0.5, 0.75])
def test_bias_reduced_by_factor_p(p):
    rng = np.random.default_rng(0)
    J, S, d = 6, 1, 4
    h = torch.from_numpy(rng.normal(size=(J, d)).astype(np.float32))
    h_tilde = h + torch.from_numpy(
        (rng.normal(size=(J, d)) * 0.5).astype(np.float32))

    et_mean, _ = theory.delta_moments_et(h, h_tilde, J, S)
    sed_mean, _ = theory.delta_moments_sed(h, h_tilde, J, S, p)
    stale_et = (J - S) / J * (h_tilde - h).numpy()
    np.testing.assert_allclose(et_mean.numpy(), stale_et, rtol=1e-5)
    fresh_part = (S / J) * (1 - p) * (J - S) / S * h.numpy() \
        - (1 - p) * (J - S) / J * h.numpy()
    np.testing.assert_allclose(sed_mean.numpy(), p * stale_et + fresh_part,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(fresh_part, 0.0, atol=1e-6)
    np.testing.assert_allclose(
        float(theory.bias_reduction_factor(h, h_tilde, J, S, p)), p,
        rtol=1e-5)

    n = 40_000
    gen = torch.Generator().manual_seed(0)
    mc_et = _simulate_delta(h, h_tilde, J, S, p, n, False, gen)
    mc_sed = _simulate_delta(h, h_tilde, J, S, p, n, True, gen)
    np.testing.assert_allclose(mc_et, stale_et, atol=0.05)
    sigma = (1 - p) * (J - S) / S * float(h.abs().max())
    np.testing.assert_allclose(mc_sed, p * stale_et,
                               atol=max(0.05, 5 * sigma / np.sqrt(n)))


def test_limit_cases_match_theorem():
    """p=1 degrades to ET; p=0 removes the stale bias entirely, and the
    sampler agrees: at p=0 no stale segment survives the dropout."""
    rng = np.random.default_rng(1)
    J, S, d = 5, 1, 3
    h = torch.from_numpy(rng.normal(size=(J, d)).astype(np.float32))
    h_tilde = h + 1.0
    et_mean, et_second = theory.delta_moments_et(h, h_tilde, J, S)
    sed1_mean, sed1_second = theory.delta_moments_sed(h, h_tilde, J, S, 1.0)
    np.testing.assert_allclose(sed1_mean.numpy(), et_mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(sed1_second.numpy(), et_second.numpy(),
                               rtol=1e-6)
    _, sed0_second = theory.delta_moments_sed(h, h_tilde, J, S, 0.0)
    assert float(sed0_second.sum()) > float(et_second.sum())

    n = 40_000
    gen = torch.Generator().manual_seed(1)
    mc_sed1 = _simulate_delta(h, h_tilde, J, S, 1.0, n, True, gen)
    mc_et = _simulate_delta(h, h_tilde, J, S, 1.0, n, False, gen)
    np.testing.assert_allclose(mc_sed1, et_mean.numpy(), atol=0.05)
    np.testing.assert_allclose(mc_et, et_mean.numpy(), atol=0.05)
    mc_sed0 = _simulate_delta(h, h_tilde, J, S, 0.0, n, True, gen)
    sigma = (J - S) / S * float(h.abs().max())
    np.testing.assert_allclose(mc_sed0, 0.0,
                               atol=max(0.05, 5 * sigma / np.sqrt(n)))


def test_regularizer_grows_as_p_drops():
    rng = np.random.default_rng(2)
    J, S = 8, 1
    h = torch.from_numpy(rng.normal(size=(J, 4)).astype(np.float32))
    h_tilde = h + torch.from_numpy(
        (rng.normal(size=(J, 4)) * 0.3).astype(np.float32))
    seconds = [float(theory.delta_moments_sed(h, h_tilde, J, S, p)[1].sum())
               for p in [1.0, 0.75, 0.5, 0.25, 0.0]]
    assert all(seconds[i] <= seconds[i + 1] + 1e-6
               for i in range(len(seconds) - 1))
