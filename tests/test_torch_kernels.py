"""The port's kernels (segment SpMM, sed_pool) against the JAX package's.

On the CPU each wrapper takes its plain version (kernels/ref.py), which is
held against JAX's Pallas kernel (interpret mode, as the JAX tests run it)
and JAX's jnp oracle at the reference's own tolerances
(tests/test_fused_path.py:48,73: f32 1e-5, gradients 1e-4, bf16 6e-2).
The gradients go through the port's autograd Functions, the same on both
devices, against ``jax.grad`` through the Pallas kernels' custom VJPs.  The
CUDA kernels themselves are tested in tests/test_torch_kernels_gpu.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sed_pool import sed_pool as jax_sed_pool  # noqa: E402
from repro.kernels.segment_spmm import segment_spmm_batched as jax_spmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sed_pool as sp  # noqa: E402
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


@pytest.mark.parametrize("N,m,d,e,n_pad,empty_seg", CASES)
def test_spmm_gradients_match_jax(N, m, d, e, n_pad, empty_seg):
    """dh (the transposed SpMM) and dw (the per-edge inner product) of the
    port's autograd Function against jax.grad through the Pallas kernel's
    custom VJP (src/repro/kernels/segment_spmm.py:128-151)."""
    h, src, dst, w = _inputs(N, m, d, e, seed=N * 7 + e, n_pad=n_pad,
                             empty_seg=empty_seg)
    g = np.random.default_rng(e).normal(size=(N, m, d)).astype(np.float32)
    th, tw = torch.from_numpy(h).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    out = spmm.segment_spmm_batched(th, torch.from_numpy(src),
                                    torch.from_numpy(dst), tw)
    torch.sum(out * torch.from_numpy(g)).backward()
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    dh, dw = jax.grad(
        lambda hh, ww: jnp.sum(jax_spmm(hh, js, jd, ww, interpret=True) * g),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), rtol=1e-4,
                               atol=1e-4)


def test_spmm_transpose_is_the_swapped_spmm():
    h, src, dst, w = map(torch.from_numpy, _inputs(3, 16, 8, 40, seed=4,
                                                   n_pad=5))
    torch.testing.assert_close(
        spmm.segment_spmm_batched_transpose(h, src, dst, w),
        ref.segment_spmm_batched_ref(h, dst, src, w), rtol=0, atol=0)


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
    assert ops.kernel_launches() == {
        "segment_spmm_batched": 0, "segment_spmm_batched_bwd": 0,
        "sed_pool": 0, "sed_pool_aged": 0, "quant_pack_bf16": 0,
        "quant_pack_bf16_det": 0, "quant_pack_int8": 0,
        "quant_pack_int8_det": 0, "quant_unpack_bf16": 0,
        "quant_unpack_int8": 0, "swa_attention": 0}


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


@pytest.mark.parametrize("N,m,e,d,itemsize,addr", [
    (8, 64, 512, 64, 4, 256), (160, 64, 382, 64, 4, 256),
    (64, 1024, 8192, 128, 4, 256), (64, 1024, 8192, 128, 2, 256),
    (3, 37, 300, 130, 4, 256), (2, 8, 6, 1, 4, 256), (5, 48, 130, 40, 2, 256),
    (4, 32, 257, 64, 4, 260), (1, 1, 0, 3, 2, 2), (10_000, 1024, 8192, 64, 4, 0)])
def test_spmm_plan_geometry(N, m, e, d, itemsize, addr):
    """The launch geometry the CUDA kernel is given: the load divides a
    row of h and its address, a row's threads are a power of two <= 32
    that cover the columns with their tiles, the row tiles cover m with at
    most 256 rows each, and the block's shared memory fits an H100's."""
    g = spmm.plan(N, m, e, d, itemsize, addr)
    nbytes = g.vec * itemsize
    assert (d * itemsize) % nbytes == 0 and addr % nbytes == 0
    assert g.vec == 1 or nbytes in (16, 8, 4)
    assert g.tpr in (1, 2, 4, 8, 16, 32)
    assert g.col_tiles * g.tpr * g.vec >= d > (g.col_tiles - 1) * g.tpr * g.vec
    assert 1 <= g.tile_rows <= spmm.MAX_TILE_ROWS
    assert g.row_tiles * g.tile_rows >= m > (g.row_tiles - 1) * g.tile_rows
    assert spmm.smem_bytes(m, e, g.tile_rows) <= 232448
    if N * g.col_tiles >= 132 * 8:            # the card is full with one tile
        assert g.row_tiles == -(-m // spmm.MAX_TILE_ROWS)


def test_smem_bytes_covers_stated_kernel_range():
    # m <= 1024 and e <= 8192 (the JAX kernel's VMEM claim) fit one block
    # of an H100 after the opt-in (232,448 bytes)
    assert spmm.smem_bytes(1024, 8192) <= 232448


# ---------------------------------------------------------------------------
# sed_pool and sed_pool_aged
# ---------------------------------------------------------------------------


def _sed_inputs(B, J, d, seed, num_sampled=2):
    """Invalid slots (rows shorter than J), num_sampled fresh segments per
    row, random drops with row 1 dropping every stale segment, and ages."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, J, d)).astype(np.float32)
    n_valid = rng.integers(num_sampled, J + 1, B)
    n_valid[0] = J
    valid = (np.arange(J)[None, :] < n_valid[:, None]).astype(np.float32)
    fresh = np.zeros((B, J), np.float32)
    for b in range(B):
        fresh[b, rng.choice(n_valid[b], num_sampled, replace=False)] = 1.0
    drop = (rng.uniform(size=(B, J)) > 0.5).astype(np.float32)
    drop[1] = 1.0
    ages = rng.integers(0, 20, (B, J)).astype(np.float32)
    return h, valid, fresh, drop, ages


@pytest.mark.parametrize("decay", [0.0, 0.1])
@pytest.mark.parametrize("d", [1, 64])
@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_sed_pool_matches_jax(agg, d, decay):
    """Forward against JAX's Pallas kernel (interpret mode) and its jnp
    oracle, and dh against jax.grad through the kernel's custom VJP; λ > 0
    takes the aged kernel on both sides."""
    h, valid, fresh, drop, ages = _sed_inputs(5, 7, d, seed=d + int(10 * decay))
    kw = dict(keep_prob=0.6, num_sampled=2, agg=agg, decay=decay)
    g = np.random.default_rng(1).normal(size=(5, d)).astype(np.float32)
    th = torch.from_numpy(h).requires_grad_()
    masks = [torch.from_numpy(a) for a in (valid, fresh, drop)]
    out = sp.sed_pool(th, *masks, ages=torch.from_numpy(ages), **kw)
    torch.sum(out * torch.from_numpy(g)).backward()

    jmasks = [jnp.asarray(a) for a in (valid, fresh, drop)]
    jages = jnp.asarray(ages)
    pallas = jax_sed_pool(jnp.asarray(h), *jmasks, ages=jages,
                          interpret=True, **kw)
    oracle = jref.sed_pool_ref(jnp.asarray(h), *jmasks, 0.6, 2, agg, jages,
                               decay)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(oracle),
                               rtol=1e-5, atol=1e-5)
    dh = jax.grad(lambda hh: jnp.sum(jax_sed_pool(
        hh, *jmasks, ages=jages, interpret=True, **kw) * g))(jnp.asarray(h))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh), rtol=1e-4,
                               atol=1e-4)
    # every stale segment of row 1 dropped: only its fresh ones count
    eta, _ = ref.sed_eta(*masks, 0.6, 2)
    assert torch.equal(eta[1] > 0, masks[1][1] > 0)


def test_sed_eta_matches_jax_bitwise():
    h, valid, fresh, drop, ages = _sed_inputs(6, 9, 4, seed=3)
    for a, decay in ((None, 0.0), (ages, 0.1)):
        eta, J_i = ref.sed_eta(*map(torch.from_numpy, (valid, fresh, drop)),
                               0.5, 1, None if a is None else
                               torch.from_numpy(a), decay)
        jeta, jJ = jref.sed_eta(*map(jnp.asarray, (valid, fresh, drop)), 0.5,
                                1, None if a is None else jnp.asarray(a),
                                decay)
        np.testing.assert_array_equal(J_i.numpy(), np.asarray(jJ))
        if a is None:      # exp may round differently; the rest is exact
            np.testing.assert_array_equal(eta.numpy(), np.asarray(jeta))
        else:
            np.testing.assert_allclose(eta.numpy(), np.asarray(jeta),
                                       rtol=1e-6, atol=0)


def test_sed_aggregate_cpu_takes_plain_path():
    h, valid, fresh, drop, ages = map(torch.from_numpy,
                                      _sed_inputs(4, 6, 8, seed=2))
    ops.reset_kernel_launches()
    for decay in (0.0, 0.1):
        outs = [ops.sed_aggregate(h, valid, fresh, drop, ages, keep_prob=0.5,
                                  num_sampled=2, agg="mean", decay=decay,
                                  use_kernels=k) for k in (True, False)]
        torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not any(ops.kernel_launches().values())


@pytest.mark.parametrize("bad", ["f16_h", "f64_mask", "shape", "strided",
                                 "agg"])
def test_sed_pool_wrapper_checks(bad):
    h, valid, fresh, drop, _ = map(torch.from_numpy,
                                   _sed_inputs(3, 5, 4, seed=0))
    masks = {"seg_valid": valid, "fresh_mask": fresh, "drop_mask": drop}
    if bad == "f16_h":
        h = h.half()
    elif bad == "f64_mask":
        masks["drop_mask"] = drop.double()
    elif bad == "shape":
        masks["fresh_mask"] = fresh[:, :4].contiguous()
    elif bad == "strided":
        masks["seg_valid"] = valid.t().contiguous().t()
    if bad == "agg":
        with pytest.raises(ValueError, match="agg"):
            sp._launch(h, valid, fresh, drop, None, 0.5, 1, "max", 0.0)
    else:
        with pytest.raises((TypeError, ValueError)):
            sp._check(h, masks)


def test_sed_pool_other_device_raises():
    h, valid, fresh, drop, _ = (t.to("meta") for t in map(
        torch.from_numpy, _sed_inputs(2, 3, 2, seed=0)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        sp.sed_pool(h, valid, fresh, drop, keep_prob=0.5, num_sampled=1)


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
