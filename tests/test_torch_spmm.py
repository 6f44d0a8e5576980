"""The port's segment SpMM (kernels/segment_spmm.py; on the CPU its plain
version, which the CUDA kernel is held to on the card) against the JAX
package's ``segment_spmm_batched`` at the cases that stress the kernel's
design (tests/_spmm_cases.py: a hub, weight-0 repeats away from node 0, a
padding-only segment, out-of-range edges, m not a multiple of 32, d 1 to
128, bf16, inf under a weight-0 edge).

The forward and the transpose are held against JAX's Pallas kernel in
interpret mode, values and NaN positions, within 1e-5 (bf16 6e-2, the
reference's tolerances, tests/test_fused_path.py:48); the inf case against
JAX's jnp oracle, because the Pallas kernel's one-hot gather multiplies
every h row by 0 or 1 and so spreads an inf's NaN over every edge.  The
gradients go through the port's autograd Function against ``jax.grad``
through the Pallas kernel's custom VJP, 1e-4, NaN positions included (dw
of an out-of-range edge reads NaN or a wrapped row, as JAX's
``take_along_axis`` does)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _spmm_cases import BF16_CASES, CASES, case  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm_batched as jax_spmm  # noqa: E402
from repro_torch.kernels import segment_spmm as spmm  # noqa: E402


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _want(h, src, dst, w, name):
    j = tuple(map(jnp.asarray, (h, src, dst, w)))
    if name == "inf_under_zero_weight":
        return jref.segment_spmm_batched_ref(*j)
    return jax_spmm(*j, interpret=True)


@pytest.mark.parametrize("name", list(CASES))
def test_spmm_matches_jax(name):
    h, src, dst, w = case(name)
    t = [torch.from_numpy(a) for a in (h, src, dst, w)]
    got = spmm.segment_spmm_batched(*t)
    assert got.dtype == torch.float32 and got.shape == h.shape
    _close(got.numpy(), _want(h, src, dst, w, name), 1e-5)
    # the transpose: the same SpMM with src and dst swapped
    _close(spmm.segment_spmm_batched_transpose(*t).numpy(),
           _want(h, dst, src, w, name), 1e-5)
    if name == "inf_under_zero_weight":
        assert np.isnan(got.numpy()[1, 9, 3])
        assert np.isnan(got.numpy()).sum() == 1
    if name == "padding_only_segment":
        assert not got[0].any()


@pytest.mark.parametrize("name", BF16_CASES)
def test_spmm_bf16_matches_jax(name):
    h, src, dst, w = case(name)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    got = spmm.segment_spmm_batched(hb, *map(torch.from_numpy, (src, dst, w)))
    assert got.dtype == torch.bfloat16
    want = jax_spmm(jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16),
                    *map(jnp.asarray, (src, dst, w)), interpret=True)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 6e-2)


@pytest.mark.parametrize("name", list(CASES))
def test_spmm_gradients_match_jax(name):
    h, src, dst, w = case(name, seed=1)
    g = np.random.default_rng(len(name)).normal(size=h.shape).astype(
        np.float32)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = spmm.segment_spmm_batched(th, torch.from_numpy(src),
                                    torch.from_numpy(dst), tw)
    torch.sum(out * torch.from_numpy(g)).backward()
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    dh, dw = jax.grad(
        lambda hh, ww: jnp.sum(jax_spmm(hh, js, jd, ww, interpret=True) * g),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    _close(th.grad.numpy(), dh, 1e-4)
    _close(tw.grad.numpy(), dw, 1e-4)
