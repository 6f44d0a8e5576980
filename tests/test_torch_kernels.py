"""The port's segment-SpMM (kernels/) against the JAX package's.

On the CPU the wrapper takes its plain version (kernels/ref.py), which is
held against JAX's Pallas kernel (interpret mode, as the JAX tests run it)
and JAX's jnp oracle at the reference's own tolerances
(tests/test_fused_path.py:48: f32 1e-5, bf16 6e-2).  The CUDA kernel itself
is tested in tests/test_torch_kernels_gpu.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm_batched as jax_spmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_spmm as spmm  # noqa: E402


def _inputs(N, m, d, e, seed, n_pad=0, empty_seg=False):
    """Random edges with duplicates; the last ``n_pad`` edges of every
    segment are padding, (0, 0) with w = 0 as graphs/batching.py pads;
    ``empty_seg`` makes segment 0 all padding (a zero-edge segment)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, m, d)).astype(np.float32)
    src = rng.integers(0, m, (N, e)).astype(np.int32)
    dst = rng.integers(0, m, (N, e)).astype(np.int32)
    if e:
        dst[:, 1] = dst[:, 0]                     # duplicate destinations
        src[:, 1] = src[:, 0]                     # and a duplicate edge
    w = (rng.uniform(0, 1, (N, e)) * (rng.uniform(size=(N, e)) > 0.3)
         ).astype(np.float32)
    if n_pad:
        src[:, e - n_pad:] = dst[:, e - n_pad:] = 0
        w[:, e - n_pad:] = 0.0
    if empty_seg:
        src[0] = dst[0] = 0
        w[0] = 0.0
    return h, src, dst, w


CASES = [  # N, m, d, e, n_pad, empty_seg
    (1, 16, 8, 5, 0, False),          # N = 1
    (5, 48, 40, 130, 20, False),      # padding edges
    (3, 37, 130, 300, 0, False),      # m not a power of two, d > 128
    (4, 24, 12, 64, 8, True),         # a zero-edge segment
]


@pytest.mark.parametrize("N,m,d,e,n_pad,empty_seg", CASES)
def test_spmm_plain_matches_jax(N, m, d, e, n_pad, empty_seg):
    h, src, dst, w = _inputs(N, m, d, e, seed=N * 100 + e, n_pad=n_pad,
                             empty_seg=empty_seg)
    got = spmm.segment_spmm_batched(*map(torch.from_numpy, (h, src, dst, w)))
    assert got.dtype == torch.float32 and got.shape == (N, m, d)
    j = tuple(map(jnp.asarray, (h, src, dst, w)))
    pallas = np.asarray(jax_spmm(*j, interpret=True))
    oracle = np.asarray(jref.segment_spmm_batched_ref(*j))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)
    if empty_seg:
        assert not got[0].any()


def test_spmm_plain_no_edges():
    h, src, dst, w = _inputs(2, 8, 4, 0, seed=3)
    got = spmm.segment_spmm_batched(*map(torch.from_numpy, (h, src, dst, w)))
    want = jref.segment_spmm_batched_ref(*map(jnp.asarray, (h, src, dst, w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spmm_plain_bf16_matches_jax():
    h, src, dst, w = _inputs(4, 32, 64, 257, seed=11, n_pad=7)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    got = spmm.segment_spmm_batched(hb, *map(torch.from_numpy, (src, dst, w)))
    assert got.dtype == torch.bfloat16
    want = jref.segment_spmm_batched_ref(
        jnp.asarray(hb.float().numpy()), *map(jnp.asarray, (src, dst, w)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=6e-2, atol=6e-2)


def test_spmm_single_segment_matches_jax():
    h, src, dst, w = _inputs(1, 20, 6, 40, seed=5, n_pad=4)
    got = spmm.segment_spmm(*map(torch.from_numpy, (h[0], src[0], dst[0], w[0])))
    want = jref.segment_spmm_ref(*map(jnp.asarray, (h[0], src[0], dst[0], w[0])),
                                 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_spmm_inf_stays_nan_through_padding():
    """0 · inf in a padding edge must give NaN, as in the reference."""
    h, src, dst, w = _inputs(1, 8, 4, 6, seed=2, n_pad=2)
    h[0, 0, 1] = np.inf
    got = spmm.segment_spmm_batched(*map(torch.from_numpy, (h, src, dst, w)))
    want = np.asarray(jref.segment_spmm_batched_ref(
        *map(jnp.asarray, (h, src, dst, w))))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want[0, 0, 1])


def test_neighbor_aggregate_matches_jax():
    h, src, dst, w = _inputs(1, 24, 10, 60, seed=9, n_pad=10)
    ev = (w[0] > 0).astype(np.float32)
    for use_kernels in (False, True):
        mean, deg = ops.neighbor_aggregate(
            *map(torch.from_numpy, (h[0], src[0], dst[0], ev)), num_nodes=24,
            use_kernels=use_kernels)
        jm, jd = jops.neighbor_aggregate(
            *map(jnp.asarray, (h[0], src[0], dst[0], ev)), num_nodes=24,
            use_pallas=False)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(deg.numpy(), np.asarray(jd))


def test_batched_neighbor_sum_cpu_takes_plain_path():
    ops.reset_kernel_launches()
    h, src, dst, w = map(torch.from_numpy, _inputs(3, 16, 8, 40, seed=1))
    for use_kernels in (True, False):
        got = ops.batched_neighbor_sum(h, src, dst, w, use_kernels=use_kernels)
        torch.testing.assert_close(got, ref.segment_spmm_batched_ref(h, src, dst, w),
                                   rtol=0, atol=0)
    assert ops.kernel_launches() == {"segment_spmm_batched": 0}


def test_spmm_other_device_raises():
    h, src, dst, w = (t.to("meta") for t in
                      map(torch.from_numpy, _inputs(1, 4, 2, 3, seed=0)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm.segment_spmm_batched(h, src, dst, w)


@pytest.mark.parametrize("bad", ["int64_src", "f64_w", "f16_h", "shape",
                                 "strided"])
def test_spmm_wrapper_checks(bad):
    h, src, dst, w = map(torch.from_numpy, _inputs(2, 8, 4, 6, seed=0))
    if bad == "int64_src":
        src = src.long()
    elif bad == "f64_w":
        w = w.double()
    elif bad == "f16_h":
        h = h.half()
    elif bad == "shape":
        w = w[:, :5].contiguous()
    else:
        h = h.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        spmm._check(h, src, dst, w)


def test_smem_bytes_covers_stated_kernel_range():
    # m <= 1024 and e <= 8192 (the JAX kernel's VMEM claim) fit one block
    # of an H100 after the opt-in (232,448 bytes)
    assert spmm.smem_bytes(1024, 8192) <= 232448


# ---------------------------------------------------------------------------
# pad helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 100, 1024, 1025])
def test_pow2_helpers_match_jax(n):
    assert ops.next_pow2(n) == jops.next_pow2(n)
    assert ops.prev_pow2(n) == jops.prev_pow2(n)
    rows = list(range(3, 3 + n))
    other = [7 * r for r in rows]
    for a, b in zip(ops.pad_rows_pow2(rows, other),
                    jops.pad_rows_pow2(rows, other)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pad_leading_matches_jax():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for target in (3, 5):
        want = np.asarray(jops.pad_leading(x, target))
        np.testing.assert_array_equal(ops.pad_leading(x, target), want)
        np.testing.assert_array_equal(
            ops.pad_leading(torch.from_numpy(x), target).numpy(), want)
