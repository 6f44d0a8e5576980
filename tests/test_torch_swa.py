"""The port's sliding-window attention (kernels/ref.py::swa_attention_ref,
kernels/ops.py::sliding_window_attention, the attention functions of
models/common.py) against the JAX package's: its oracle
(src/repro/kernels/ref.py:73-87) and its Pallas kernel in interpret mode,
at 2e-5 as the reference's own kernel test (tests/test_kernels.py:116),
plus GQA heads, any S and W, and the wrapper's refusals.  On the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.swa_attention import swa_attention as jswa  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import swa_attention as swa  # noqa: E402
from repro_torch.models import common  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, KV, D)).astype(np.float32),
            rng.normal(size=(B, S, KV, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (B, S, H, D, window in 128-row blocks; 100 = full causal), from the
# reference's hypothesis space (tests/test_kernels.py:104-107)
REF_CASES = [(1, 128, 1, 64, 1), (2, 256, 2, 128, 1), (1, 512, 4, 64, 2),
             (3, 256, 1, 64, 100), (1, 512, 2, 128, 4), (2, 128, 4, 128, 100)]


def _window(S, Wb):
    return min(Wb * 128, S) if Wb != 100 else S


@pytest.mark.parametrize("B,S,H,D,Wb", REF_CASES)
def test_ref_and_op_match_jax_oracle_and_pallas_kernel(B, S, H, D, Wb):
    W = _window(S, Wb)
    q, k, v = _qkv(B, S, H, H, D, seed=S + H + D + Wb)
    want = np.asarray(jref.swa_attention_ref(*_j(q, k, v), W))
    pallas = np.asarray(jswa(*_j(q, k, v), window=W, blk=128, interpret=True))
    got = ref.swa_attention_ref(*_t(q, k, v), W).numpy()
    op = ops.sliding_window_attention(*_t(q, k, v), window=W).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(op, pallas, **TOL)
    np.testing.assert_array_equal(op, got)   # the CPU path IS the plain one


@pytest.mark.parametrize("H,KV", [(4, 2), (16, 8), (4, 1)])
def test_gqa_matches_jax_oracle_on_repeated_kv(H, KV):
    """Head h reads KV head h // (H / KV), as jnp.repeat (common.py:176)."""
    B, S, D, W = 2, 96, 64, 40
    q, k, v = _qkv(B, S, H, KV, D, seed=H * KV)
    rep = H // KV
    want = jref.swa_attention_ref(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
        jnp.repeat(jnp.asarray(v), rep, axis=2), W)
    got = ops.sliding_window_attention(*_t(q, k, v), window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,W", [(100, 30), (1000, 300), (1, 1), (77, 500),
                                 (130, 1)])
def test_any_s_and_window_match_jax_oracle(S, W):
    """S and W need not be multiples of a tile (the Pallas kernel's rule)."""
    q, k, v = _qkv(1, S, 2, 1, 64, seed=S + W)
    want = jref.swa_attention_ref(jnp.asarray(q),
                                  jnp.repeat(jnp.asarray(k), 2, axis=2),
                                  jnp.repeat(jnp.asarray(v), 2, axis=2), W)
    got = ref.swa_attention_ref(*_t(q, k, v), W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_window_zero_is_taken_literally_like_the_reference_op():
    """The op takes its window as given: 0 masks every key (a uniform
    softmax), in the port's plain version as in JAX's."""
    q, k, v = _qkv(1, 32, 2, 2, 64, seed=0)
    want = jref.swa_attention_ref(*_j(q, k, v), 0)
    got = ops.sliding_window_attention(*_t(q, k, v), window=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attn_inputs(seed, B=2, S=48, d=64, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    p = {n: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, H * hd)), ("wk", (d, KV * hd)),
                      ("wv", (d, KV * hd)), ("wo", (H * hd, d)))}
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    return p, x, pos, dict(num_heads=H, num_kv=KV, head_dim=hd,
                           rope_theta=1e6)


@pytest.mark.parametrize("window", [0, 16, 200])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_attn_forward_matches_jax(window, use_kernels):
    """W = 0 is full causal attention: attn_forward hands the op the window
    S, where JAX's attn_forward runs sdpa(causal=True).  The head dim 16
    is the plain version's (the kernel takes 64 and 128 on the card)."""
    p, x, pos, kw = _attn_inputs(window)
    jout, (jk, jv) = jcommon.attn_forward(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
        positions=jnp.asarray(pos), window=window, **kw)
    out, (k, v) = common.attn_forward(
        {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
        positions=torch.from_numpy(pos), window=window,
        use_kernels=use_kernels, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 300, 1024])
def test_chunked_causal_attention_matches_jax_and_the_op(window):
    q, k, v = _qkv(1, 2048, 4, 2, 64, seed=window)
    want = jcommon.chunked_causal_attention(*_j(q, k, v), window=window,
                                            chunk=512)
    got = common.chunked_causal_attention(*_t(q, k, v), window=window,
                                          chunk=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    op = ops.sliding_window_attention(*_t(q, k, v),
                                      window=window if window else 2048)
    np.testing.assert_allclose(got.numpy(), op.numpy(), **TOL)


# ---------------------------------------------------------------------------
# what the kernel's wrapper refuses, checked before any launch
# ---------------------------------------------------------------------------


def test_kernel_launch_refuses_cpu_tensors_and_the_op_other_devices():
    q, k, v = _t(*_qkv(1, 8, 2, 1, 64, seed=0))
    with pytest.raises(ValueError, match="runs on cuda"):
        swa._launch(q, k, v, 8)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        swa.swa_attention(*meta, window=8)


@pytest.mark.parametrize("what", ["head_dim_96", "float16", "kv_not_dividing",
                                  "shape", "stride", "grad"])
def test_kernel_checks_refuse_what_it_cannot_do(what):
    D = 96 if what == "head_dim_96" else 64
    H, KV = (4, 3) if what == "kv_not_dividing" else (4, 2)
    q, k, v = _t(*_qkv(1, 8, H, KV, D, seed=0))
    if what == "float16":
        q = q.half()
    if what == "shape":
        v = v[:, :4]
    if what == "stride":
        k = torch.from_numpy(np.ascontiguousarray(
            k.numpy().transpose(0, 1, 3, 2))).transpose(2, 3)
    if what == "grad":
        q.requires_grad_()
    err = {"float16": TypeError, "grad": RuntimeError}.get(what, ValueError)
    with pytest.raises(err):
        swa._check(q, k, v)


# ---------------------------------------------------------------------------
# the kernel's arithmetic on the card (csrc/swa_attention.cu), emulated in
# plain torch: 3xTF32 products, online softmax over 64-key tiles in the
# log2 domain
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, W; None = full causal): the card's cases
# (tests/test_torch_kernels_gpu.py::SWA_CASES, chip_smoke.py's SWA_SHAPES)
# but the 32k one
CARD_CASES = [(2, 256, 4, 2, 64, 128), (1, 2048, 16, 8, 128, None),
              (1, 4096, 16, 8, 128, 1024), (2, 1000, 16, 8, 128, 300),
              (1, 1, 16, 8, 128, None), (1, 777, 6, 1, 128, 1),
              (2, 513, 8, 8, 64, 33)]
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)   # chip_smoke.py's TOL


def _tf32(x):
    """f32 -> TF32 (10 mantissa bits), round to nearest, ties away from
    zero, as cvt.rna.tf32.f32 with the low 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, passes):
    """a @ b in f32 from TF32 parts: 3 passes = the kernel's 3xTF32
    (small products first, big x big last), 1 pass = plain TF32."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _emulated_kernel(q, k, v, W, passes):
    """The kernel's arithmetic: per 64-key tile, S = Q K^T, masked scores
    times scale * log2(e) (f32), the running max (a row with none yet
    exponentiates against 0), P = exp2(S - m), O = O * alpha + P V.  Each
    tile updates only the rows that can see it."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(rep, 2).transpose(1, 2)
    v = v.repeat_interleave(rep, 2).transpose(1, 2)
    c = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    m = torch.full((B, H, S, 1), -np.inf)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, D)
    for k0 in range(0, S, 64):
        k1 = min(k0 + 64, S)
        r0, r1 = k0, min(S, k1 - 1 + W)          # the rows that see the tile
        i = torch.arange(r0, r1)[:, None]
        j = torch.arange(k0, k1)[None, :]
        s = _product(q[:, :, r0:r1], k[:, :, k0:k1].transpose(-1, -2),
                     passes) * c
        s = s.masked_fill((j > i) | (j <= i - W), -np.inf)
        m_new = torch.maximum(m[:, :, r0:r1], s.amax(-1, keepdim=True))
        use = torch.where(m_new == -np.inf, 0.0, m_new)
        alpha = torch.exp2(m[:, :, r0:r1] - use)
        p = torch.exp2(s - use)
        l[:, :, r0:r1] = l[:, :, r0:r1] * alpha + p.sum(-1, keepdim=True)
        o[:, :, r0:r1] = o[:, :, r0:r1] * alpha + _product(
            p, v[:, :, k0:k1], passes)
        m[:, :, r0:r1] = m_new
    return (o / l).transpose(1, 2)


def _oracle_f64(q, k, v, W, rows=256):
    """Attention in f64, a block of query rows at a time over the keys the
    block can see."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    q, k, v = (t.double().transpose(1, 2) for t in (q, k, v))
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    out = torch.empty_like(q)
    for a in range(0, S, rows):
        b = min(a + rows, S)
        lo = max(0, a - W + 1)
        i = torch.arange(a, b)[:, None]
        j = torch.arange(lo, b)[None, :]
        s = q[:, :, a:b] @ k[:, :, lo:b].transpose(-1, -2) / np.sqrt(D)
        s = s.masked_fill((j > i) | (j <= i - W), -np.inf)
        out[:, :, a:b] = torch.softmax(s, -1) @ v[:, :, lo:b]
    return out.transpose(1, 2)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -11        # halfway between 1 and 1 + 2^-10
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0,
                      1.0 + 3 * 2.0 ** -11, 0.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
            1.0 + 2.0 ** -9, 0.0]
    assert _tf32(x).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    big = _tf32(r)
    assert not bool((big.view(torch.int32) & 0x1fff).any())
    assert bool(((r - big).abs() <= r.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("B,S,H,KV,D,W", CARD_CASES)
def test_emulated_3xtf32_kernel_holds_1e5_and_1xtf32_does_not(B, S, H, KV,
                                                              D, W):
    """The kernel's 3xTF32 arithmetic stays within the card's 1e-5 of the
    f64 oracle at the card's shapes; one TF32 product a product does not."""
    W = S if W is None else W
    q, k, v = _t(*_qkv(B, S, H, KV, D, seed=S + W))
    want = _oracle_f64(q, k, v, W)
    got = _emulated_kernel(q, k, v, W, passes=3)
    torch.testing.assert_close(got.double(), want, **KERNEL_TOL)
    one = _emulated_kernel(q, k, v, W, passes=1).double()
    excess = (one - want).abs() - (KERNEL_TOL["atol"]
                                   + KERNEL_TOL["rtol"] * want.abs())
    assert float(excess.max()) > 0
