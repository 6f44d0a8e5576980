"""The port's RWKV-6 block (repro_torch/models/rwkv6.py) against the JAX
package's (src/repro/models/rwkv6.py), given the same weights and numpy
inputs, on the CPU, at the reduced rwkv6-7b width (d 256: 16 heads of
16, lora 32) and a narrow one (d 64: 8 heads of 8): the group norm (the
population variance), the time-mix with and without a carried state and
token shift, and the channel-mix with and without a token shift, at
1e-5; the time-mix's restructured recurrence against the reference's
literal one, and the one-token chain against the full sequence at
5e-4."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import CHAIN_TOL, close, np_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import rwkv6 as jr  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import rwkv6 as r  # noqa: E402
from repro_torch.models.common import flatten_tree  # noqa: E402

WIDTHS = {"reduced": {}, "narrow": dict(d_model=64, d_ff=96)}
NARROW_HEAD = 8


def _cfgs(width):
    def cut(c):
        c = c.reduced(c.get_config("rwkv6-7b"))
        c = dataclasses.replace(c, **WIDTHS[width])
        if width == "narrow":
            c = dataclasses.replace(c, ssm=dataclasses.replace(
                c.ssm, state_size=NARROW_HEAD))
        return c
    return cut(configs), cut(jconfigs)


def _torch_tree(jp):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)


def _setup(width, seed=0):
    cfg, jcfg = _cfgs(width)
    k1, k2 = jax.random.split(jax.random.key(seed))
    jtm = jr.rwkv_timemix_params(k1, jcfg)
    jcm = jr.rwkv_channelmix_params(k2, jcfg)
    return cfg, jcfg, (jtm, _torch_tree(jtm)), (jcm, _torch_tree(jcm))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_params_trees_match_jax(width):
    cfg, jcfg, (jtm, _), (jcm, _) = _setup(width)
    g = torch.Generator().manual_seed(0)
    for got, want in ((r.rwkv_timemix_params(g, cfg), jtm),
                      (r.rwkv_channelmix_params(g, cfg), jcm)):
        got, want = dict(flatten_tree(got)), dict(flatten_tree(np_tree(want)))
        assert {k: tuple(v.shape) for k, v in got.items()} \
            == {k: tuple(v.shape) for k, v in want.items()}
        for name, v in want.items():
            if not name.startswith("w"):  # the constants, not the draws
                np.testing.assert_array_equal(got[name].numpy(), v)
    d = cfg.d_model
    assert tuple(jtm["w_decay_a"].shape) == (d, max(32, d // 64))
    stacked = r.rwkv_timemix_params(g, cfg, lead=(2,))
    assert stacked["wo"].shape == (2, d, d)
    assert torch.equal(stacked["decay_base"][1], torch.full((d,), -0.6))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_group_norm_is_the_population_variance_as_jax(width):
    """Per-head groups of 16 (reduced) and 8 (narrow) values: the unbiased
    variance would be 16/15 and 8/7 times larger and fail by far."""
    cfg, jcfg, (jtm, tm), _ = _setup(width)
    H, N = r.rwkv_dims(cfg)
    y = _normal(1, 2, 5, cfg.d_model) * 3.0 + 1.0
    got = r._group_norm(tm, torch.from_numpy(y), H, N)
    want = np.asarray(jr._group_norm(jtm, jnp.asarray(y), H, N))
    close(got, want)
    yh = torch.from_numpy(y).reshape(2, 5, H, N)
    unbiased = ((yh - yh.mean(-1, keepdim=True))
                * torch.rsqrt(yh.var(-1, keepdim=True) + 1e-5))
    assert np.abs(unbiased.reshape(2, 5, -1).numpy() - want).max() > 1e-2


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_timemix_matches_jax(width, carried):
    """A sequence from zeros, and one continuing a carried state and
    token shift."""
    cfg, jcfg, (jtm, tm), _ = _setup(width)
    H, N = r.rwkv_dims(cfg)
    B, S = 2, 13
    x = _normal(2, B, S, cfg.d_model)
    state = _normal(3, B, H, N, N) if carried else None
    prev = _normal(4, B, cfg.d_model) if carried else None
    jo, (js, jlast) = jr.rwkv_timemix(
        jtm, jnp.asarray(x), jcfg,
        state=None if state is None else jnp.asarray(state),
        shift_prev=None if prev is None else jnp.asarray(prev))
    o, (s, last) = r.rwkv_timemix(
        tm, torch.from_numpy(x), cfg,
        state=None if state is None else torch.from_numpy(state),
        shift_prev=None if prev is None else torch.from_numpy(prev))
    close(o, jo)
    close(s, js)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    assert s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, N)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_channelmix_matches_jax(width, shifted):
    cfg, jcfg, _, (jcm, cm) = _setup(width)
    x = _normal(5, 2, 7, cfg.d_model)
    prev = _normal(6, 2, cfg.d_model) if shifted else None
    jo, jlast = jr.rwkv_channelmix(jcm, jnp.asarray(x), None if prev is None
                                   else jnp.asarray(prev))
    o, last = r.rwkv_channelmix(cm, torch.from_numpy(x), None if prev is None
                                else torch.from_numpy(prev))
    close(o, jo)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


def test_recurrence_equals_the_reference_literal_step(monkeypatch):
    """The restructured loop (the bonus term before the loop; a bmm, a
    product and an addcmul a step) against the reference's step written out in torch:
    y_t = r_t · (S + u ∘ k_t ⊗ v_t), S = w_t ∘ S + k_t ⊗ v_t."""
    cfg, _, _, _ = _setup("narrow")
    H, N = r.rwkv_dims(cfg)
    B, S = 2, 9
    p = r.rwkv_timemix_params(torch.Generator().manual_seed(3), cfg)
    p["bonus_u"] = torch.from_numpy(_normal(7, cfg.d_model))
    x = torch.from_numpy(_normal(8, B, S, cfg.d_model))
    state = torch.from_numpy(_normal(9, B, H, N, N))
    captured = {}
    real = r._group_norm

    def capture(p_, y, H_, N_):
        captured["y"] = y
        return real(p_, y, H_, N_)

    monkeypatch.setattr(r, "_group_norm", capture)
    _, (s_new, _) = r.rwkv_timemix(p, x, cfg, state=state)
    xp = r._token_shift(x, torch.zeros(B, cfg.d_model))

    def proj(name, w):
        m = p[f"mix_{name}"]
        return (x * m + xp * (1 - m)) @ p[w]

    rr, kk, vv = (proj(n, w).reshape(B, S, H, N)
                  for n, w in (("r", "wr"), ("k", "wk"), ("v", "wv")))
    dd = torch.tanh(proj("w", "w_decay_a")) @ p["w_decay_b"]
    w = torch.exp(-torch.exp(p["decay_base"] + dd)).reshape(B, S, H, N)
    u = p["bonus_u"].reshape(H, N)
    s = state
    for t in range(S):
        kv = kk[:, t, :, :, None] * vv[:, t, :, None, :]
        y = torch.einsum("bhn,bhnm->bhm", rr[:, t], s + u[:, :, None] * kv)
        torch.testing.assert_close(captured["y"][:, t].reshape(B, H, N), y,
                                   rtol=1e-5, atol=1e-5)
        s = w[:, t, :, :, None] * s + kv
    torch.testing.assert_close(s_new, s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_one_token_chain_equals_the_sequence(width):
    """Decode: the time-mix and channel-mix over one token at a time,
    carrying the state and both token shifts, against the full sequence
    (5e-4, the reference's forward-vs-decode tolerance)."""
    cfg, _, (_, tm), (_, cm) = _setup(width)
    B, S = 2, 11
    x = torch.from_numpy(_normal(10, B, S, cfg.d_model))
    full, (s_full, last_full) = r.rwkv_timemix(tm, x, cfg)
    cfull, _ = r.rwkv_channelmix(cm, x)
    state, prev, cprev = None, None, None
    outs, couts = [], []
    for t in range(S):
        o, (state, prev) = r.rwkv_timemix(tm, x[:, t:t + 1], cfg,
                                          state=state, shift_prev=prev)
        co, cprev = r.rwkv_channelmix(cm, x[:, t:t + 1], cprev)
        outs.append(o)
        couts.append(co)
    close(torch.cat(outs, 1), full.numpy(), CHAIN_TOL)
    close(torch.cat(couts, 1), cfull.numpy(), CHAIN_TOL)
    close(state, s_full.numpy(), CHAIN_TOL)
    assert torch.equal(prev, last_full)
