"""The int8 wire-format kernels' geometry (kernels/quant.py::plan_pack_int8
and ::plan_unpack_int8) on the CPU, and the library call that chip_smoke.py
times beside the int8 unpack.

The kernels run only on a card; here the index arithmetic that
``csrc/quant.cu`` states for them is replayed over each plan, at every
(R, N) of chip_smoke.py's quant phase and every alignment of x or v mod 16
bytes: every element and every scale is taken exactly once.  And
``torch.mul(v, scale[:, None])`` (int8 times f32 promotes to f32, one
elementwise product) is bitwise the plain version and the JAX package's
``dequantize_rows_ref``, NaN, ±inf, zero and subnormal scales included.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import quant as jq  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SMS = 132


def _smoke_shapes():
    """chip_smoke.py's quant (R, N): its distributed run's lookups and
    write-backs (from the run's own set-up, on the CPU), the stress shape
    and the edge cases."""
    from repro_torch.launch.train_dist import build_parser, setup

    args = [a if a != "cuda" else "cpu" for a in chip_smoke.DIST_ARGS]
    s = setup(build_parser().parse_args(
        args + ["--exchange", "bucketed", "--payload-dtype", "int8"]))
    j, d, cap = s.ds.j_max, s.args.hidden, s.cap
    b, D = 8 // chip_smoke.DIST_SHARDS, chip_smoke.DIST_SHARDS
    return sorted({(b, j * d), (D * b, j * d), (D * cap, j * d), (b, d),
                   (D * b, d), chip_smoke.QUANT_STRESS}
                  | {(r, n) for r, n, _ in chip_smoke.QUANT_EDGES})


SHAPES = _smoke_shapes()


def _pack_coverage(R, N, x_mod, plan):
    """How often the pack kernel's threads take each element of x and each
    scale, replaying csrc/quant.cu::pack_int8_det_kernel's indexing: block
    b's warp w owns row b * (8 / W) + w / W; within a row, thread t < 32 W
    takes the scalar head element t (t < head), float4 j = t + k * 32 W (k
    < K from registers, then on, read twice) and tail element t; thread 0
    writes the scale."""
    W, K = plan.warps_per_row, plan.vecs_per_lane
    T, per_block = 32 * W, tq.ROW_WARPS // W
    blocks = -(-R // per_block)
    rows = np.add.outer(np.arange(blocks) * per_block, np.arange(per_block))
    scale_hits = np.bincount(rows[rows < R], minlength=R)
    # the elements of one row depend on its head only: 4 classes
    hits = {}
    for head in range(4):
        h = min(N, head)
        nvec, count = (N - h) // 4, np.zeros(N, np.int64)
        t = np.arange(T)
        count[t[t < h]] += 1
        j = np.concatenate([t + k * T for k in range(K)]
                           + [np.arange(K * T, max(nvec, K * T))])
        j = j[j < nvec]
        np.add.at(count, h + (4 * j[:, None] + np.arange(4)).ravel(), 1)
        tail = N - h - 4 * nvec
        count[h + 4 * nvec + t[t < tail]] += 1
        hits[head] = count
    heads = {(4 - (x_mod + r * N) % 4) % 4 for r in range(min(R, 4))}
    return scale_hits, {h: hits[h] for h in heads}


@pytest.mark.parametrize("x_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("R,N", SHAPES)
def test_pack_plan_covers_every_element_and_scale_once(R, N, x_mod):
    plan = tq.plan_pack_int8(R, N, SMS)
    assert plan.warps_per_row in (1, 2, 4, 8)
    assert plan.vecs_per_lane in tq.VECS_PER_LANE
    scale_hits, hits = _pack_coverage(R, N, x_mod, plan)
    assert (scale_hits == 1).all()
    for head, count in hits.items():
        assert (count == 1).all(), (head, np.flatnonzero(count != 1)[:5])
    if N <= tq.REGISTER_N:     # a row's float4 all stay in registers
        assert N // 4 <= 32 * plan.warps_per_row * plan.vecs_per_lane


def test_pack_plan_switches_to_the_wide_path_past_register_n():
    """Rows up to REGISTER_N (8 warps of 16 float4 a thread) stay in
    registers; a row 4 elements wider has a float4 more than its threads
    keep, which is read twice; the lookup's rows take 8 warps a row when
    few arrive, 2 at the stress shape."""
    n = tq.REGISTER_N
    assert n == 16384
    for R in (1, 6, 8192):
        for N in (n, n + 4):
            plan = tq.plan_pack_int8(R, N, SMS)
            assert plan == tq.Int8Plan(8, 16)
            kept = 32 * plan.warps_per_row * plan.vecs_per_lane
            assert (N // 4 <= kept) == (N == n)
    assert tq.plan_pack_int8(2, 1280, SMS) == tq.Int8Plan(8, 2)
    assert tq.plan_pack_int8(8192, 1280, SMS) == tq.Int8Plan(2, 8)


def _unpack_coverage(R, N, v_mod, groups):
    """How often the unpack kernel's threads take each element and with
    which row's scale, replaying csrc/quant.cu::unpack_int8_kernel: from
    head = v's bytes to its next 4-byte boundary on, warp w's lane l takes
    the words at head + w * 128 G + 4 l + 128 k (k < G), its row by one
    division, then steps of 128 elements; the head and what follows the
    last whole span one element a thread."""
    n = R * N
    head = min(n, (4 - v_mod) % 4)
    span = 128 * groups
    spans = (n - head) // span
    count = np.zeros(n, np.int64)
    row_of = np.full(n, -1, np.int64)
    e0 = head + (np.arange(spans)[:, None] * span + 4 * np.arange(32)).ravel()
    row, col = e0 // N, e0 % N
    for k in range(groups):
        e = e0 + 128 * k
        for i in range(4):
            crossed = (col + i) // N          # a word across a row's end
            np.add.at(count, e + i, 1)
            row_of[e + i] = row + crossed
        col = col + 128
        row, col = row + col // N, col % N
    rest = np.r_[0:head, head + spans * span:n]
    count[rest] += 1
    row_of[rest] = rest // N
    return count, row_of


@pytest.mark.parametrize("v_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("R,N", SHAPES)
def test_unpack_plan_covers_every_element_once_with_its_row(R, N, v_mod):
    groups = tq.plan_unpack_int8(R, N, SMS)
    assert groups in tq.UNPACK_GROUPS
    count, row_of = _unpack_coverage(R, N, v_mod, groups)
    assert (count == 1).all()
    assert (row_of == np.arange(R * N) // N).all()


def test_unpack_plan_fills_the_card_before_widening():
    """One word a thread until the buffer gives every SM 4 warps of two
    words, then the most words that still do; 16 at the stress shape."""
    assert tq.plan_unpack_int8(2, 1280, SMS) == 1
    assert tq.plan_unpack_int8(8192, 1280, SMS) == 16
    for R, N in SHAPES:
        g = tq.plan_unpack_int8(R, N, SMS)
        assert g == 1 or R * N // (128 * g) >= 4 * SMS
        if g < tq.UNPACK_GROUPS[-1]:
            assert R * N // (256 * g) < 4 * SMS


@pytest.mark.parametrize("value", [0.0, float("nan"), float("inf"),
                                   float("-inf"), 1e-40, 2.0 ** -149, 1.0,
                                   3.0 / 127, 1e30])
def test_torch_mul_is_the_int8_unpack(value):
    """The library column's contract: torch.mul(v, scale[:, None]) gives
    the plain version's bits for every int8 value at a scale of ``value``
    (in one row, beside a random scale and -value), and the JAX package's
    where XLA's CPU arithmetic keeps subnormals: it flushes a subnormal
    product to ±0, the port does not (ROADMAP C3)."""
    rng = np.random.default_rng(7)
    v = np.concatenate([np.arange(-127, 128, dtype=np.int8),
                        rng.integers(-127, 128, 1, dtype=np.int8)])
    v = np.stack([v, v[::-1].copy(), rng.permutation(v)])
    s = np.asarray([value, rng.normal() * 0.03, -value], np.float32)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    got = torch.mul(tv, ts[:, None])
    assert got.dtype == torch.float32
    want = ref.dequantize_rows_ref((tv, ts), "int8")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    if not 0 < abs(value) < np.finfo(np.float32).tiny:
        jax_want = np.asarray(jq.dequantize_rows_ref(
            (jnp.asarray(v), jnp.asarray(s)), "int8"))
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      jax_want.view(np.int32))
