"""The port's exact rewrites of the sequence models against the JAX
package's, mode by mode (the counterpart of tests/test_perf_toggles.py):
each switch set to the same mode in both packages, the same numpy inputs,
JAX's parameters carried over, on the CPU, at the reference's tolerances:

  * ``moe.DISPATCH_MODE`` einsum / gather, ample and dropping capacity
    (cf 4.0, 0.4): 3e-5; the gather form's gradients equal the einsum
    form's at 1e-4;
  * ``common.ATTN_IMPL`` naive / chunked (also windowed): 2e-5;
  * ``common.GQA_IMPL`` repeat / grouped, ``sdpa`` causal and windowed and
    ``attn_decode``: 2e-5;
  * ``mla.ABSORBED_DECODE`` absorbed / naive: 2e-5;
  * ``common.CACHE_UPDATE`` dus / onehot: bitwise;
  * a reduced arctic-480b forward under gather + chunked + grouped: 5e-5;
  * through a reduced model's ``decode_step`` (the port alone): the naive
    MLA decode within 2e-5 of the absorbed one, the onehot cache write
    bitwise the in-place one.

A fixture restores both packages' attributes after each test.  The JAX
functions run under a fresh ``jax.jit`` (``jitted``), which reads the
switches while it traces.  The kernel path is not switched (the kernel
runs under every mode), so the models here are the plain path's."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.common as JC  # noqa: E402
import repro.models.mla as JMLA  # noqa: E402
import repro.models.moe as JM  # noqa: E402
from _torch_seq import close, np_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import load_jax_params  # noqa: E402
from repro_torch.models import common as C  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

SWITCHES = [(C, JC, "CACHE_UPDATE"), (C, JC, "ATTN_IMPL"),
            (C, JC, "ATTN_CHUNK"), (C, JC, "GQA_IMPL"),
            (M, JM, "DISPATCH_MODE"), (MLA, JMLA, "ABSORBED_DECODE")]


def tol(t):
    return dict(rtol=t, atol=t)


@pytest.fixture(autouse=True)
def _restore_switches():
    saved = [(mod, name, getattr(mod, name)) for pair in SWITCHES
             for mod, name in ((pair[0], pair[2]), (pair[1], pair[2]))]
    yield
    for mod, name, value in saved:
        setattr(mod, name, value)


def set_both(name, value):
    """The switch ``name`` set to ``value`` in both packages."""
    for port, ref, attr in SWITCHES:
        if attr == name:
            setattr(port, attr, value)
            setattr(ref, attr, value)
            return
    raise KeyError(name)


def t(a):
    return torch.from_numpy(np.array(a))


def ported(tree):
    return jax.tree_util.tree_map(t, tree)


def jitted(fn, *args, **static):
    """``fn(*args, **static)`` under a fresh ``jax.jit`` (one compile, not
    one an op; it traces under the switches as they are now)."""
    return jax.jit(functools.partial(fn, **static))(*args)


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------

D = 16


@functools.lru_cache(maxsize=None)
def moe_weights():
    """An 8-expert top-2 MoE's JAX parameters (the capacity factor does not
    change them) and inputs whose router logits leave a gap of 1e-3 at the
    top-k boundary of every token, so both packages route them alike."""
    cfg = JMoEConfig(num_experts=8, top_k=2, expert_d_ff=32)
    jp = jitted(JM.moe_params, jax.random.key(0), d_model=D, cfg=cfg,
                act="silu")
    router = np.asarray(jp["router"], np.float64)
    rng = np.random.default_rng(0)
    while True:
        x = rng.normal(size=(2, 16, D)).astype(np.float32)
        lg = np.sort(x.reshape(-1, D) @ router, axis=-1)[:, ::-1]
        if np.all(lg[:, 1] - lg[:, 2] > 1e-3):
            return jp, x


def moe_cfgs(cf):
    fields = dict(num_experts=8, top_k=2, expert_d_ff=32, capacity_factor=cf)
    return MoEConfig(**fields), JMoEConfig(**fields)


@pytest.mark.parametrize("cf", [4.0, 0.4])
@pytest.mark.parametrize("mode", ["einsum", "gather"])
def test_moe_dispatch_matches_jax(mode, cf):
    cfg, jcfg = moe_cfgs(cf)
    jp, x = moe_weights()
    set_both("DISPATCH_MODE", mode)
    jo, ja, jc = jitted(JM.moe_forward, jp, jnp.asarray(x), cfg=jcfg,
                        act="silu", with_counts=True)
    o, a, c = M.moe_forward(ported(jp), t(x), cfg, "silu", with_counts=True)
    close(o, jo, tol(3e-5))
    close(a, ja, tol(1e-6))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    dropped = int(np.asarray(jc).max()) > M.capacity(16, cfg)
    assert dropped == (cf < 1.0)


def test_moe_gather_gradients_equal_einsum():
    """The MoE layer trains through the gather form (dropping capacity):
    its gradients of the input and of every parameter equal the einsum
    form's."""
    cfg, _ = moe_cfgs(0.4)
    jp, x = moe_weights()
    grads = {}
    for mode in ("einsum", "gather"):
        M.DISPATCH_MODE = mode
        p = jax.tree_util.tree_map(lambda a: t(a).requires_grad_(), jp)
        xt = t(x).requires_grad_()
        out, aux = M.moe_forward(p, xt, cfg, "silu")
        leaves = [xt] + jax.tree_util.tree_leaves(p)
        grads[mode] = torch.autograd.grad((out ** 2).sum() + aux, leaves)
    for g, e in zip(grads["gather"], grads["einsum"]):
        torch.testing.assert_close(g, e, **tol(1e-4))
    assert float(grads["gather"][0].abs().sum()) > 0


# ---------------------------------------------------------------------------
# attention: chunked, grouped
# ---------------------------------------------------------------------------


def qkv(B, S, H, KV, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, Dh)).astype(np.float32),
            rng.normal(size=(B, S, KV, Dh)).astype(np.float32),
            rng.normal(size=(B, S, KV, Dh)).astype(np.float32))


def attn_weights(d, H, KV, Dh, seed):
    return jitted(JC.attn_params, jax.random.key(seed), d_model=d,
                  num_heads=H, num_kv=KV, head_dim=Dh)


@pytest.mark.parametrize("window", [0, 96])
def test_chunked_attention_matches_jax(window):
    q, k, v = qkv(2, 256, 4, 2, 32, 2)
    got = C.chunked_causal_attention(t(q), t(k), t(v), window=window,
                                     chunk=64)
    want = jitted(JC.chunked_causal_attention, q, k, v, window=window,
                  chunk=64)
    close(got, want, tol(2e-5))
    naive = C.sdpa(t(q), t(k), t(v), causal=True, window=window)
    close(got, naive.numpy(), tol(2e-5))


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_attn_forward_under_attn_impl_matches_jax(impl):
    """The plain path's causal attention layer (64 tokens, chunks of 16,
    GQA 4 / 2) under each ATTN_IMPL against JAX's."""
    set_both("ATTN_IMPL", impl)
    set_both("ATTN_CHUNK", 16)
    jp = attn_weights(32, 4, 2, 16, 1)
    x = np.random.default_rng(3).normal(size=(2, 64, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64), (2, 64))
    kw = dict(num_heads=4, num_kv=2, head_dim=16, rope_theta=1e4)
    jo, _ = jitted(JC.attn_forward, jp, x, positions=jnp.asarray(pos), **kw)
    o, _ = C.attn_forward(ported(jp), t(x), positions=t(pos),
                          use_kernels=False, **kw)
    close(o, jo, tol(2e-5))


@pytest.mark.parametrize("kwargs", [dict(causal=True),
                                    dict(causal=True, window=5)])
@pytest.mark.parametrize("impl", ["repeat", "grouped"])
def test_sdpa_under_gqa_impl_matches_jax(impl, kwargs):
    set_both("GQA_IMPL", impl)
    q, k, v = qkv(2, 16, 8, 2, 32, 4)
    want = jitted(JC.sdpa, q, k, v, **kwargs)
    close(C.sdpa(t(q), t(k), t(v), **kwargs), want, tol(2e-5))


@pytest.mark.parametrize("impl", ["repeat", "grouped"])
def test_attn_decode_under_gqa_impl_matches_jax(impl):
    set_both("GQA_IMPL", impl)
    H, KV, Dh = 8, 2, 32
    rng = np.random.default_rng(4)
    jp = attn_weights(64, H, KV, Dh, 0)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(2, 8, KV, Dh)).astype(np.float32)
    cv = rng.normal(size=(2, 8, KV, Dh)).astype(np.float32)
    pos = np.array([3, 5])
    kw = dict(num_heads=H, num_kv=KV, head_dim=Dh, rope_theta=1e4)
    want = jitted(JC.attn_decode, jp, x, ck, cv, pos, **kw)
    got = C.attn_decode(ported(jp), t(x), t(ck), t(cv), t(pos), **kw)
    for g, w in zip(got, want):
        close(g, w, tol(2e-5))


# ---------------------------------------------------------------------------
# MLA decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_decode_matches_jax(absorbed):
    """One step of each form against random latent caches, at positions
    that leave part of the cache unwritten and one past its end."""
    arch = "deepseek-v3-671b"
    cfg = configs.reduced(configs.get_config(arch))
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    jp = jitted(JMLA.mla_params, jax.random.key(1), cfg=jcfg)
    rng = np.random.default_rng(4)
    B, Cn = 3, 8
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, Cn, cfg.mla_kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, Cn, cfg.mla_rope_head_dim)).astype(np.float32)
    pos = np.array([0, 5, 11])
    want = jitted(JMLA.mla_decode, jp, x, ckv, kr, pos, cfg=jcfg,
                  absorbed=absorbed)
    got = MLA.mla_decode(ported(jp), t(x), t(ckv), t(kr), t(pos), cfg,
                         absorbed=absorbed)
    for g, w in zip(got, want):
        close(g, w, tol(2e-5))


# ---------------------------------------------------------------------------
# cache write
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 8, 2, 4), (3, 8, 4)])
@pytest.mark.parametrize("mode", ["dus", "onehot"])
def test_cache_write_matches_jax_bitwise(mode, shape):
    """Each mode bitwise JAX's same mode and the port's other mode; "dus"
    writes the cache it is given, "onehot" leaves it and returns a new
    one."""
    rng = np.random.default_rng(1)
    idx = np.array([0, 5, 7])
    cache = rng.normal(size=shape).astype(np.float32)
    new = rng.normal(size=(3, 1) + shape[2:]).astype(np.float32)
    set_both("CACHE_UPDATE", mode)
    want = np.asarray(jitted(JC.write_cache, cache, new, idx))
    tc = t(cache)
    got = C.write_cache(tc, t(new), t(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got is tc) == (mode == "dus")
    if mode == "onehot":
        np.testing.assert_array_equal(tc.numpy(), cache)
    C.CACHE_UPDATE = "onehot" if mode == "dus" else "dus"
    other = C.write_cache(t(cache), t(new), t(idx))
    np.testing.assert_array_equal(other.numpy(), want)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,switch,values", [
    ("internlm2-1.8b", "CACHE_UPDATE", ("dus", "onehot")),
    ("deepseek-v3-671b", "ABSORBED_DECODE", (True, False))])
def test_decode_steps_equal_across_modes(arch, switch, values):
    """Six decode steps of a reduced model (seed-0 weights) from an empty
    cache under each mode of the switch, through ``decode_step`` (the
    caches it returns): the cache writes' logits and caches bitwise equal,
    the MLA forms' within 2e-5."""
    cfg = configs.reduced(configs.get_config(arch))
    model = build_model(cfg, use_kernels=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 6))
    runs = []
    for value in values:
        set_both(switch, value)
        caches, logits = model.init_cache(2, 6), []
        for step in range(6):
            lg, caches = model.decode_step(params, toks[:, step:step + 1],
                                           caches, np.full((2,), step))
            logits.append(lg)
        runs.append((torch.stack(logits), caches))
    (la, ca), (lb, cb) = runs
    if switch == "CACHE_UPDATE":
        assert torch.equal(la, lb)
        for a, b in zip(ca, cb):
            assert set(a) == set(b)
            assert all(torch.equal(a[k], b[k]) for k in a)
    else:
        torch.testing.assert_close(la, lb, **tol(2e-5))
    assert float(ca[0]["k" if "k" in ca[0] else "ckv"].abs().sum()) > 0


def test_arctic_forward_under_all_switches_matches_jax():
    """A reduced arctic-480b (2 KV heads of its 4, so GQA groups; 32
    tokens in chunks of 16) through the plain path under gather dispatch,
    chunked attention and grouped GQA, against JAX's forward under the
    same (JAX's weights carried over), and against its own forward under
    the defaults."""
    arch, kv = "arctic-480b", {"num_kv_heads": 2}
    jcfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config(arch)), **kv)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)), **kv)
    jm = jbuild_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    model = build_model(cfg, use_kernels=False, device="cpu")
    p = load_jax_params(model.init(torch.Generator().manual_seed(1)),
                        np_tree(jp))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    default = model.forward(p, {"tokens": toks})
    set_both("ATTN_CHUNK", 16)
    for name, value in (("DISPATCH_MODE", "gather"), ("ATTN_IMPL", "chunked"),
                        ("GQA_IMPL", "grouped")):
        set_both(name, value)
    got = model.forward(p, {"tokens": toks})
    want = jitted(jm.forward, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    close(got, want, tol(5e-5))
    close(got, default.numpy(), tol(5e-5))
