"""The port's wire-format pack and unpack (kernels/ref.py, kernels/quant.py,
kernels/ops.py) against the JAX package's (src/repro/kernels/quant.py):
BITWISE, given the same uint32 random bits, against both its jnp reference
``quantize_rows_ref`` and its Pallas kernels in interpret mode; plus the
properties of tests/test_quant.py (representable values and grid points
preserved, zero rows decode to exact zeros, one grid step of error,
stochastic rounding unbiased).  On the CPU the wrappers take the plain
versions; the CUDA kernels are held to them on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _quant_cases import subnormal_rows, subnormal_unpack  # noqa: E402
from repro.kernels import quant as jq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402

COMPRESSED = ("bf16", "int8")


def _bits(shape, seed):
    return np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32))


def _t_bits(bits):
    return None if bits is None else torch.from_numpy(bits.view(np.int32).copy())


def _raw(a):
    """An array's bits, for bitwise comparison (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _inputs(r, n, seed):
    """Random rows with the edge cases in: a zero row, ±0, values on the
    RNE ties of both grids, huge and tiny magnitudes."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(r, n)) * 3.0).astype(np.float32)
    x[0] = 0.0
    if r > 1:
        ties = np.asarray([0.0, -0.0, 1.0 + 2.0 ** -8, -(1.0 + 3 * 2.0 ** -8),
                           63.5, -0.5, 2.5, 1e-30], np.float32)
        k = min(n, len(ties))
        x[1, :k] = ties[:k]
        x[1, -1] = 127.0                 # amax 127: scale exactly 1
    if r > 2:
        x[2] *= 1e6
    return x


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", COMPRESSED)
@pytest.mark.parametrize("r,n,pallas", [(1, 4, True), (3, 33, False),
                                        (17, 130, True), (40, 1280, False)])
def test_pack_unpack_bitwise_vs_jax(r, n, pallas, dtype, stochastic):
    """Against the jnp reference at every shape (R = 1, N not a multiple
    of 32, the training widths), and against the Pallas kernels in
    interpret mode (about a second a call) at two of them."""
    x = _inputs(r, n, seed=r * n)
    bits = _bits((r, n), seed=r + n) if stochastic else None
    jbits = None if bits is None else jnp.asarray(bits)
    wants = [jq.quantize_rows_ref(jnp.asarray(x), dtype, jbits)]
    if pallas:
        wants.append(jq.quantize_rows(jnp.asarray(x), dtype, jbits,
                                      use_pallas=True, interpret=True))
    got = tq.quantize_rows(torch.from_numpy(x), dtype, _t_bits(bits))
    back = tq.dequantize_rows(got, dtype).numpy().view(np.int32)
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_raw(g), _raw(w))
        np.testing.assert_array_equal(
            back, np.asarray(jq.dequantize_rows_ref(want, dtype)).view(
                np.int32))
    if pallas:
        np.testing.assert_array_equal(back, np.asarray(jq.dequantize_rows(
            wants[1], dtype, use_pallas=True, interpret=True)).view(np.int32))


def _nan_rows(n, seed, payloads):
    """Random rows, then NaN of both signs, ±inf, a row of NaN, and with
    ``payloads`` a row of NaNs with payloads (signalling, all ones,
    0x7FA12345)."""
    x = _inputs(6, n, seed)
    x[2, 1], x[2, -2] = np.nan, -np.nan
    x[3, 0], x[3, -1] = np.inf, -np.inf
    x[4] = np.nan
    if payloads:
        p = np.asarray([0x7F800001, 0xFF800001, 0x7FFFFFFF, 0xFFFFFFFF,
                        0x7FA12345], np.uint32).view(np.float32)
        x[5, :len(p)] = p
    return x


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", COMPRESSED)
def test_nan_and_inf_rows_bitwise_vs_jax(dtype, stochastic):
    """NaN of both signs, ±inf, a row of NaN: values and scales bitwise
    against JAX's jnp reference and its Pallas kernels in interpret mode,
    and the unpacks of both round trip to JAX's bits.  bf16 also packs
    NaNs with payloads as JAX does; an int8 scale's NaN is always
    0x7FC00000 (JAX on the CPU keeps the payload of whichever NaN its
    max returns, which the card's arithmetic does not keep)."""
    x = _nan_rows(40, seed=3, payloads=dtype == "bf16")
    bits = _bits(x.shape, seed=9) if stochastic else None
    jbits = None if bits is None else jnp.asarray(bits)
    got = tq.quantize_rows(torch.from_numpy(x), dtype, _t_bits(bits))
    back = tq.dequantize_rows(got, dtype).numpy().view(np.int32)
    for want in (jq.quantize_rows_ref(jnp.asarray(x), dtype, jbits),
                 jq.quantize_rows(jnp.asarray(x), dtype, jbits,
                                  use_pallas=True, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_raw(g), _raw(w))
        np.testing.assert_array_equal(
            back, np.asarray(jq.dequantize_rows_ref(want, dtype)).view(
                np.int32))
    if dtype == "bf16" and not stochastic:
        nan = np.isnan(x)
        sign = (x.view(np.int32) < 0) * np.int16(-0x8000)
        assert (_raw(got[0])[nan] == (sign | 0x7FC0)[nan]).all()
    if dtype == "int8":
        assert not _raw(got[0])[np.isnan(x)].any() and not _raw(got[0])[3].any()
        assert (_raw(got[1])[[2, 4]].view(np.uint32) == 0x7FC00000).all()
        assert np.isinf(got[1][3].item())


@pytest.mark.parametrize("bits_kind", [None, "high24_zero", "random"])
@pytest.mark.parametrize("dtype", COMPRESSED)
@pytest.mark.parametrize("n", [8, 130])
def test_subnormal_rows_bitwise_vs_jax(n, dtype, bits_kind):
    """Subnormals (tests/_quant_cases.py) bitwise against JAX's jnp
    reference and its Pallas kernels in interpret mode, packs and unpacks:
    the bf16 paths keep subnormals (bit operations), the int8 paths flush
    them as XLA's CPU arithmetic does (a subnormal x or scale reads as ±0,
    a subnormal scale or quotient becomes ±0)."""
    x, low_bits = subnormal_rows(n, seed=n)
    bits = {None: None, "high24_zero": low_bits,
            "random": _bits(x.shape, seed=n)}[bits_kind]
    jbits = None if bits is None else jnp.asarray(bits)
    got = tq.quantize_rows(torch.from_numpy(x), dtype, _t_bits(bits))
    back = tq.dequantize_rows(got, dtype).numpy().view(np.int32)
    for want in (jq.quantize_rows_ref(jnp.asarray(x), dtype, jbits),
                 jq.quantize_rows(jnp.asarray(x), dtype, jbits,
                                  use_pallas=True, interpret=True)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_raw(g), _raw(w))
        np.testing.assert_array_equal(
            back, np.asarray(jq.dequantize_rows_ref(want, dtype)).view(
                np.int32))
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
    if dtype == "bf16":
        if bits is None:
            # 1e-39 and -5e-40 keep their subnormal bf16 patterns
            assert _raw(got[0])[0, :2].view(np.uint16).tolist() == [0x000B,
                                                                   0x8005]
        assert (tq.dequantize_rows(got, dtype).numpy()[sub] != 0).any()
    else:
        q, scale = (_raw(p) for p in got)
        assert scale[[0, 1]].tolist() == [0.0, 0.0] and not q[0].any()
        if bits is None:
            assert not q[1].any() and q[2, :4].tolist() == [127, 1, 0, 0]
        assert not q[sub].any()


@pytest.mark.parametrize("pallas", [False, True])
def test_subnormal_scale_unpacks_to_signed_zero_as_jax(pallas):
    """(5, -3) at scale 1e-40 unpacks to (0, -0) and at -1e-40 to (-0, 0):
    JAX's bits, from its jnp reference or its Pallas kernel."""
    v, s = subnormal_unpack()
    got = tq.dequantize_rows((torch.from_numpy(v), torch.from_numpy(s)),
                             "int8").numpy()
    want = np.asarray(jq.dequantize_rows(
        (jnp.asarray(v), jnp.asarray(s)), "int8", use_pallas=pallas,
        interpret=True))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.view(np.uint32).tolist() == [[0, 0x80000000],
                                            [0x80000000, 0]]


@pytest.mark.parametrize("dtype", COMPRESSED)
def test_payload_wrappers_keep_leading_rows(dtype):
    """(B, J, d) payloads pack one scale per leading row, as the JAX
    package's ops.quantize_payload does; no launch on the CPU."""
    x = np.random.default_rng(1).normal(size=(6, 3, 16)).astype(np.float32)
    bits = _bits(x.shape, 5)
    ops.reset_kernel_launches()
    for use_kernels in (True, False):
        parts = ops.quantize_payload(torch.from_numpy(x), _t_bits(bits),
                                     dtype=dtype, use_kernels=use_kernels)
        want = jq.quantize_rows_ref(jnp.asarray(x), dtype, jnp.asarray(bits))
        for g, w in zip(parts, want):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_array_equal(_raw(g), _raw(w))
        back = ops.dequantize_payload(parts, dtype=dtype,
                                      use_kernels=use_kernels)
        assert back.shape == x.shape and back.dtype == torch.float32
    assert sum(ops.kernel_launches().values()) == 0


@pytest.mark.parametrize("stochastic", [False, True])
def test_bf16_preserves_representable(stochastic):
    vals = np.asarray([[0.0, -0.0, 1.0, -1.0, 0.5, -2.0, 384.0, 2.0 ** -20]],
                      np.float32)
    x = torch.from_numpy(vals).to(torch.bfloat16).float()
    bits = _t_bits(_bits(tuple(x.shape), 3)) if stochastic else None
    back = ref.dequantize_rows_ref(ref.quantize_rows_ref(x, "bf16", bits),
                                   "bf16")
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))
    assert bool(torch.signbit(back[0, 1])) and not bool(torch.signbit(back[0, 0]))


@pytest.mark.parametrize("stochastic", [False, True])
def test_int8_preserves_grid_points(stochastic):
    ks = np.asarray([[-127, -64, -1, 0, 1, 3, 64, 127]], np.float32)
    x = torch.from_numpy(ks * 0.25)
    bits = _t_bits(_bits(tuple(x.shape), 7)) if stochastic else None
    q, s = ref.quantize_rows_ref(x, "int8", bits)
    assert torch.equal(q, torch.from_numpy(ks.astype(np.int8)))
    np.testing.assert_allclose(s.numpy(), [0.25], rtol=1e-6)
    np.testing.assert_allclose(ref.dequantize_rows_ref((q, s), "int8").numpy(),
                               x.numpy(), rtol=1e-6)


def test_int8_zero_rows_decode_to_exact_zeros():
    x = torch.zeros(3, 8)
    x[1] = -0.0
    for bits in (None, _t_bits(_bits((3, 8), 11))):
        q, s = ref.quantize_rows_ref(x, "int8", bits)
        assert not q.any() and not s.any()
        back = ref.dequantize_rows_ref((q, s), "int8")
        assert torch.equal(back, torch.zeros(3, 8))


@pytest.mark.parametrize("dtype,value", [("bf16", 0.3), ("int8", 0.35)])
def test_stochastic_rounding_unbiased(dtype, value):
    n, rel_tol = 20_000, 2e-4
    x = torch.full((n, 4), value)
    x[:, 0] = 1.0                    # pin amax: the int8 grid stays put
    parts = ref.quantize_rows_ref(x, dtype, _t_bits(_bits((n, 4), 123)))
    back = ref.dequantize_rows_ref(parts, dtype).double()
    assert abs(float(back[:, 1:].mean()) - value) < rel_tol * value
    det = ref.dequantize_rows_ref(ref.quantize_rows_ref(x, dtype), dtype)
    assert abs(float(det[:, 1:].double().mean()) - value) > rel_tol * value


@pytest.mark.parametrize("dtype", COMPRESSED)
def test_error_within_one_grid_step(dtype):
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(16, 32)).astype(np.float32))
    back = ref.dequantize_rows_ref(ref.quantize_rows_ref(
        x, dtype, _t_bits(_bits((16, 32), 4))), dtype)
    amax = x.abs().amax(dim=1, keepdim=True)
    grid = amax * (2.0 ** -7 if dtype == "bf16" else 1.0 / 127.0)
    assert bool(((back - x).abs() <= grid + 1e-7).all())


def test_wrappers_refuse_what_they_cannot_do():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="quantize dtype"):
        tq.quantize_rows(x, "fp8")
    with pytest.raises(ValueError, match="dequantize dtype"):
        tq.dequantize_rows((x,), "f32")
