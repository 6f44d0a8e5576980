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
