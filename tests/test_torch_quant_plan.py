"""The int8 wire-format kernels' geometry (kernels/quant.py::plan_pack_int8
and ::plan_unpack_int8) on the CPU, the stochastic int8 pack's plain
version against the JAX package where the kernel's design is most exposed,
and the library call that chip_smoke.py times beside the int8 unpack.

The kernels run only on a card; here the index arithmetic that
``csrc/quant.cu`` states for them is replayed over each plan, at every
(R, N) of chip_smoke.py's quant phase and every alignment of x or v mod 16
bytes (for the stochastic pack, also of its random bits): every element,
every bit word and every scale is taken exactly once, and every load of
bits is aligned to its width.  The plain stochastic pack is bitwise the
JAX package's reference and Pallas kernel (interpret mode) at a row wider
than REGISTER_N, with x and the bits at different offsets into their
buffers, and with bits on the stochastic comparison's boundary, where the
result turns on the quotient's last bit.  And
``torch.mul(v, scale[:, None])`` (int8 times f32 promotes to f32, one
elementwise product) is bitwise the plain version at every normal scale,
NaN, ±inf and zero included; at a subnormal scale the plain version gives
the JAX package's ``dequantize_rows_ref`` bits (±0, as XLA flushes it on
the CPU) and ``torch.mul`` keeps the subnormal product.
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
from _quant_cases import boundary_bits  # noqa: E402

SMS = 132


def _smoke_shapes():
    """chip_smoke.py's quant (R, N): its distributed run's lookups and
    write-backs (from the run's own set-up, on the CPU), the stress shape,
    the edge cases (those with bits off x's phase too) and the subnormal
    rows (8 of them)."""
    from repro_torch.launch.train_dist import build_parser, setup

    args = [a if a != "cuda" else "cpu" for a in chip_smoke.DIST_ARGS]
    s = setup(build_parser().parse_args(
        args + ["--exchange", "bucketed", "--payload-dtype", "int8"]))
    j, d, cap = s.ds.j_max, s.args.hidden, s.cap
    b, D = 8 // chip_smoke.DIST_SHARDS, chip_smoke.DIST_SHARDS
    return sorted({(b, j * d), (D * b, j * d), (D * cap, j * d), (b, d),
                   (D * b, d), chip_smoke.QUANT_STRESS}
                  | {(r, n) for r, n, _ in chip_smoke.QUANT_EDGES}
                  | {(r, n) for r, n, _, _ in chip_smoke.QUANT_BITS_EDGES}
                  | {(8, n) for n in chip_smoke.QUANT_SUBNORMAL_N})


SHAPES = _smoke_shapes()


def _pack_coverage(R, N, x_mod, plan):
    """How often the pack kernel's threads take each element of x and each
    scale, replaying csrc/quant.cu::PackRow, both int8 packs' indexing: block
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


def _bits_loads(bits_mod, x_mod, word):
    """The loads (first word, words) of csrc/quant.cu::ld_bits4 for the
    four bit words from ``word`` on: one of 4 where the bits' phase
    against x (bits_mod - x_mod mod 4) is 0, two of 2 where it is 2, else
    four of 1."""
    width = {0: 4, 2: 2}.get((bits_mod - x_mod) % 4, 1)
    return [(word + i, width) for i in range(0, 4, width)]


def _stochastic_coverage(R, N, x_mod, bits_mod, plan):
    """The stochastic pack's reads of its random bits, replaying
    csrc/quant.cu::pack_int8_stochastic_kernel over rows 0-3 (a row's head
    depends on its start mod 4 only): thread t < 32 W reads the head word
    t (t < head), the four words of float4 j = t + k * 32 W with ld_bits4
    (k < K into registers before the amax, then on after it, once), and
    the tail word t.  Returns, per row, how often each word is read, and
    the loads whose address (bits at 4 * bits_mod mod 16 bytes) is not a
    multiple of their width."""
    W, K = plan.warps_per_row, plan.vecs_per_lane
    T = 32 * W
    reads, misaligned = {}, []
    for r in range(min(R, 4)):
        base = r * N
        h = min(N, (4 - (x_mod + base) % 4) % 4)
        nvec, tail = (N - h) // 4, (N - h) % 4
        count = np.zeros(N, np.int64)
        count[:h] += 1
        for t in range(T):
            j = t
            while j < nvec:
                for word, width in _bits_loads(bits_mod, x_mod, h + 4 * j):
                    count[word:word + width] += 1
                    if (4 * bits_mod + 4 * (base + word)) % (4 * width):
                        misaligned.append((r, word, width))
                j += T
        count[h + 4 * nvec:h + 4 * nvec + tail] += 1
        reads[r] = count
    return reads, misaligned


@pytest.mark.parametrize("bits_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("x_mod", [0, 1, 2, 3])
@pytest.mark.parametrize("R,N", SHAPES)
def test_stochastic_pack_plan_reads_every_bit_word_once_aligned(R, N, x_mod,
                                                                bits_mod):
    """The stochastic pack takes the nearest-even pack's plan and indexing
    (every element and scale once, as above) and reads each random-bit
    word once, with loads as wide as the bits' phase against x allows and
    aligned to their width; its register arrays hold the row up to
    REGISTER_N."""
    plan = tq.plan_pack_int8(R, N, SMS)
    assert plan.vecs_per_lane in tq.VECS_PER_LANE
    scale_hits, hits = _pack_coverage(R, N, x_mod, plan)
    assert (scale_hits == 1).all()
    assert all((count == 1).all() for count in hits.values())
    reads, misaligned = _stochastic_coverage(R, N, x_mod, bits_mod, plan)
    assert not misaligned, misaligned[:5]
    for r, count in reads.items():
        assert (count == 1).all(), (r, np.flatnonzero(count != 1)[:5])
    if N <= tq.REGISTER_N:
        assert N // 4 <= 32 * plan.warps_per_row * plan.vecs_per_lane


def _jax_int8_packs(x, bits):
    """The JAX package's stochastic int8 pack of x with bits: its jnp
    reference and its Pallas kernel in interpret mode."""
    jx, jb = jnp.asarray(x), jnp.asarray(bits.astype(np.uint32))
    return (jq.quantize_rows_ref(jx, "int8", jb),
            jq.quantize_rows(jx, "int8", jb, use_pallas=True, interpret=True))


def _assert_packs_equal(got, wants):
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                          np.asarray(w).view(np.uint8))


@pytest.mark.parametrize("case", ["wider_than_register_n", "bits_off_x"])
def test_plain_stochastic_pack_bitwise_jax_where_the_kernel_is_exposed(case):
    """A row 5 elements wider than REGISTER_N (the kernel reads x's rest
    twice and its bits' rest once), and x and the bits as views 1 and 3
    elements into their buffers (off each other's 16-byte phase, as the
    kernel's narrower bit loads take them): the plain stochastic pack is
    bitwise JAX's reference and Pallas kernel."""
    R, N = (3, tq.REGISTER_N + 5) if case == "wider_than_register_n" else (6, 1281)
    rng = np.random.default_rng(N)
    x = (rng.normal(size=(R, N)) * 3.0).astype(np.float32)
    x[1, -1] = 127.0
    bits = rng.integers(0, 2 ** 32, (R, N), dtype=np.uint64).astype(np.uint32)
    tx, tb = torch.from_numpy(x), torch.from_numpy(bits.view(np.int32))
    if case == "bits_off_x":
        tx = torch.cat([torch.zeros(1), tx.ravel()])[1:].view(R, N)
        tb = torch.cat([torch.zeros(3, dtype=torch.int32), tb.ravel()])[3:].view(R, N)
        assert tx.storage_offset() == 1 and tb.storage_offset() == 3
    got = tq.quantize_rows(tx, "int8", tb)
    _assert_packs_equal(got, _jax_int8_packs(x, bits))


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_plain_stochastic_pack_bitwise_jax_at_boundary_bits(delta):
    """Bits with bits >> 8 = floor((v - floor(v)) * 2^24) + delta
    (tests/_quant_cases.py::boundary_bits): the plain stochastic pack is
    bitwise JAX's reference and Pallas kernel at each delta, which pins
    the quotient v = x / scale to its last bit (one ulp off flips the
    result at delta 0); at -1 every element off the integer grid rounds
    up and at +1 down."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(8, 1280)) * 3.0).astype(np.float32)
    x[1, :4] = (127.0, -1.0, 0.5, 0.0)
    bits = boundary_bits(x, delta, seed=11)
    got = tq.quantize_rows(torch.from_numpy(x), "int8",
                           torch.from_numpy(bits.view(np.int32)))
    _assert_packs_equal(got, _jax_int8_packs(x, bits))
    scale = np.abs(x).max(axis=1, keepdims=True) * np.float32(1.0 / 127.0)
    v = x / scale
    lo, off_grid = np.floor(v), v != np.floor(v)
    k = bits >> np.uint32(8)
    clear = off_grid & (k > 0) & (k < 2 ** 24 - 1)
    if delta:
        want = np.clip(lo + (delta < 0), -127, 127)
        np.testing.assert_array_equal(got[0].numpy()[clear], want[clear])


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
    """The library column's contract: the plain version gives the JAX
    package's bits for every int8 value at a scale of ``value`` (in one
    row, beside a random scale and -value), subnormal scales included
    (read as ±0, as XLA's CPU arithmetic reads them); torch.mul(v,
    scale[:, None]) gives the same bits wherever the scale is not
    subnormal, and keeps the subnormal product where it is."""
    rng = np.random.default_rng(7)
    v = np.concatenate([np.arange(-127, 128, dtype=np.int8),
                        rng.integers(-127, 128, 1, dtype=np.int8)])
    v = np.stack([v, v[::-1].copy(), rng.permutation(v)])
    s = np.asarray([value, rng.normal() * 0.03, -value], np.float32)
    tv, ts = torch.from_numpy(v), torch.from_numpy(s)
    got = torch.mul(tv, ts[:, None])
    assert got.dtype == torch.float32
    want = ref.dequantize_rows_ref((tv, ts), "int8")
    jax_want = np.asarray(jq.dequantize_rows_ref(
        (jnp.asarray(v), jnp.asarray(s)), "int8"))
    np.testing.assert_array_equal(want.numpy().view(np.int32),
                                  jax_want.view(np.int32))
    if 0 < abs(value) < np.finfo(np.float32).tiny:
        # the subnormal rows differ (v != 0 gives a subnormal product),
        # the middle row at a normal scale does not
        assert not np.array_equal(got[0::2].numpy().view(np.int32),
                                  want[0::2].numpy().view(np.int32))
        np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                      want[1].numpy().view(np.int32))
    else:
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.numpy().view(np.int32))
