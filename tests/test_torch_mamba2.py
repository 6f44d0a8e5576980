"""The port's Mamba2 block (repro_torch/models/mamba2.py) against the JAX
package's (src/repro/models/mamba2.py), given the same weights and numpy
inputs, on the CPU, at the reduced zamba2 width (d_inner 512: 4 heads of
128, state 16, conv 4, chunk 64) and a narrow one (8 heads of 16, state
8, conv 3, chunk 16): the chunked SSD scan at chunks 16 and 64 over
several chunks, with and without a carried state (1e-5 of its output's
largest magnitude), against the recurrence it implements, and its assert
on a ragged length; the causal conv with and without a state; the
forward (1e-5; at the reduced width, where JAX's own float noise is
larger, 1e-4) and the decode step (1e-5), and the decode chain against
the forward at 5e-4."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import (CHAIN_TOL, NOISE_TOL, TOL, close,  # noqa: E402
                        np_tree, ulp_noise)
from repro import configs as jconfigs  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import mamba2 as m  # noqa: E402
from repro_torch.models.common import flatten_tree  # noqa: E402

SSM = {"reduced": {},
       "narrow": dict(state_size=8, num_ssm_heads=8, conv_width=3,
                      chunk_size=16)}
# the forward's tolerance: JAX's own forward over 3 chunks moves by 2.1e-5
# at the reduced width when its input moves by one ulp
# (test_mamba2_forward_noise_floor)
FORWARD_TOL = {"reduced": NOISE_TOL, "narrow": TOL}


def _cfgs(width):
    def cut(c):
        c = c.reduced(c.get_config("zamba2-1.2b"))
        ssm = dataclasses.replace(c.ssm, **SSM[width])
        return dataclasses.replace(
            c, ssm=ssm, d_model=64 if width == "narrow" else c.d_model)
    return cut(configs), cut(jconfigs)


def _setup(width, seed=0):
    cfg, jcfg = _cfgs(width)
    jp = jm.mamba2_params(jax.random.key(seed), jcfg)
    # a dt_bias of 25 on head 0 puts softplus past F.softplus's threshold
    pass  # TEMP
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return cfg, jcfg, jp, p


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


@pytest.mark.parametrize("width", list(SSM))
def test_params_tree_and_init_constants_match_jax(width):
    cfg, jcfg = _cfgs(width)
    p = m.mamba2_params(torch.Generator().manual_seed(0), cfg)
    want = dict(flatten_tree(np_tree(jm.mamba2_params(jax.random.key(0),
                                                      jcfg))))
    got = dict(flatten_tree(p))
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: tuple(v.shape) for k, v in want.items()}
    for name in ("conv_b", "dt_bias", "A_log", "D", "out_norm.scale"):
        close(got[name], want[name], dict(rtol=1e-6, atol=0))
    assert 0.08 < float(got["conv_w"].std()) < 0.12
    stacked = m.mamba2_params(torch.Generator().manual_seed(0), cfg, lead=(3,))
    for name, v in flatten_tree(stacked):
        assert tuple(v.shape) == (3,) + tuple(got[name].shape)
    torch.testing.assert_close(stacked["A_log"][2], got["A_log"])


def _ssd_inputs(B, S, H, P, N, seed):
    """Drawn as the reference's own scan test draws them
    (tests/test_models.py:46-51)."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, S, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    return xs, Bm, Cm, dt, A


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk,S", [(16, 16), (16, 80), (64, 192),
                                     (64, 40)])
def test_ssd_chunked_matches_jax(chunk, S, carried):
    """S spans 1, 5 and 3 chunks, and at (64, 40) is shorter than a chunk
    (the chunk shrinks to S, as in the reference).  The outputs reach 16,
    and a sum's rounding grows with its terms, so the tolerance is 1e-5 of
    the largest output."""
    B, H, P, N = 2, 4, 8, 16
    args = _ssd_inputs(B, S, H, P, N, seed=S + chunk)
    state = _normal(7, B, H, P, N) if carried else None
    jargs, targs = _both(*args)
    jy, js = jm.ssd_chunked(*jargs, init_state=None if state is None
                            else jnp.asarray(state), chunk=chunk)
    y, s = m.ssd_chunked(*targs, init_state=None if state is None
                         else torch.from_numpy(state), chunk=chunk)
    for got, want in ((y, jy), (s, js)):
        close(got, want, dict(rtol=1e-5,
                              atol=1e-5 * float(np.abs(want).max())))
    assert s.dtype == torch.float32


def test_ssd_chunked_equals_the_recurrence():
    """The chunked form against the per-token recurrence it implements
    (mamba2.py's docstring), over 3 chunks."""
    B, S, H, P, N = 1, 48, 3, 4, 5
    xs, Bm, Cm, dt, A = (torch.from_numpy(a)
                         for a in _ssd_inputs(B, S, H, P, N, seed=3))
    y, final = m.ssd_chunked(xs, Bm, Cm, dt, A, chunk=16)
    h = torch.zeros(B, H, P, N)
    for t in range(S):
        a = torch.exp(A * dt[:, t])                          # (B, H)
        h = h * a[..., None, None] + (dt[:, t, :, None, None]
                                      * xs[:, t, :, :, None]
                                      * Bm[:, t, None, None, :])
        torch.testing.assert_close(
            y[:, t], torch.einsum("bhpn,bn->bhp", h, Cm[:, t]),
            rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final, h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk,S", [(16, 40), (64, 100)])
def test_ssd_chunked_refuses_a_ragged_length_as_jax(chunk, S):
    args = _ssd_inputs(1, S, 2, 4, 4, seed=1)
    jargs, targs = _both(*args)
    with pytest.raises(AssertionError):
        jm.ssd_chunked(*jargs, chunk=chunk)
    with pytest.raises(AssertionError, match=f"{S}, {chunk}"):
        m.ssd_chunked(*targs, chunk=chunk)


@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("width", list(SSM))
def test_causal_conv_matches_jax(width, stateful):
    cfg, jcfg, jp, p = _setup(width)
    d_inner, W = m.mamba2_dims(cfg)[0], cfg.ssm.conv_width
    xs = _normal(2, 2, 7, d_inner)
    state = _normal(3, 2, W - 1, d_inner) if stateful else None
    jout, jnew = jm._causal_conv(jp, jnp.asarray(xs), None if state is None
                                 else jnp.asarray(state))
    out, new = m._causal_conv(p, torch.from_numpy(xs), None if state is None
                              else torch.from_numpy(state))
    close(out, jout)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(new.numpy(), xs[:, -(W - 1):])


@pytest.mark.parametrize("width", list(SSM))
def test_split_in_matches_jax(width):
    """Including dt past F.softplus's threshold of 20 (head 0)."""
    cfg, jcfg, jp, p = _setup(width)
    jp["dt_bias"] = jp["dt_bias"].at[0].set(25.0)
    p["dt_bias"][0] = 25.0
    x = _normal(4, 2, 5, cfg.d_model)
    got = m._split_in(p, torch.from_numpy(x), cfg)
    want = jm._split_in(jp, jnp.asarray(x), jcfg)
    for g, w in zip(got, want):
        close(g, w)
    assert float(got[-1][..., 0].min()) > 20.0


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("width", list(SSM))
def test_mamba2_forward_matches_jax(width, carried):
    """Over 3 chunks of the config; with a carried conv and SSM state as
    a continued sequence would have them."""
    cfg, jcfg, jp, p = _setup(width)
    d_inner, H, P, N = m.mamba2_dims(cfg)
    B, S = 2, 3 * cfg.ssm.chunk_size
    x = _normal(5, B, S, cfg.d_model)
    conv = _normal(6, B, cfg.ssm.conv_width - 1, d_inner) if carried else None
    ssm = _normal(7, B, H, P, N) if carried else None
    jo, (jconv, jssm) = jm.mamba2_forward(
        jp, jnp.asarray(x), jcfg,
        init_state=None if ssm is None else jnp.asarray(ssm),
        conv_state=None if conv is None else jnp.asarray(conv))
    o, (tconv, tssm) = m.mamba2_forward(
        p, torch.from_numpy(x), cfg,
        init_state=None if ssm is None else torch.from_numpy(ssm),
        conv_state=None if conv is None else torch.from_numpy(conv))
    close(o, jo, FORWARD_TOL[width])
    close(tconv, jconv)
    close(tssm, jssm, FORWARD_TOL[width])


def test_mamba2_forward_noise_floor():
    """Why the reduced width's forward is held at NOISE_TOL: JAX's own
    forward over 3 chunks moves by more than half of 1e-5 when its input
    moves by one ulp, and the port's distance from JAX is within twice
    that."""
    cfg, jcfg, jp, p = _setup("reduced")
    x = _normal(5, 2, 3 * cfg.ssm.chunk_size, cfg.d_model)
    noise = ulp_noise(lambda a: jm.mamba2_forward(jp, jnp.asarray(a),
                                                  jcfg)[0], x)
    got = np.abs(m.mamba2_forward(p, torch.from_numpy(x), cfg)[0].numpy()
                 - np.asarray(jm.mamba2_forward(jp, jnp.asarray(x),
                                                jcfg)[0])).max()
    assert noise > 5e-6
    assert got < 2 * noise < NOISE_TOL["atol"]


@pytest.mark.parametrize("width", list(SSM))
def test_mamba2_decode_matches_jax_and_continues_the_forward(width):
    """Each decode step from the same states at 1e-5; the chain of steps
    against the full forward at 5e-4, the states against its final
    states."""
    cfg, jcfg, jp, p = _setup(width)
    d_inner, H, P, N = m.mamba2_dims(cfg)
    B, S = 2, cfg.ssm.chunk_size
    x = _normal(8, B, S, cfg.d_model)
    full, (fconv, fssm) = m.mamba2_forward(p, torch.from_numpy(x), cfg)
    conv = torch.zeros(B, cfg.ssm.conv_width - 1, d_inner)
    ssm = torch.zeros(B, H, P, N)
    outs = []
    for t in range(S):
        xt = x[:, t:t + 1]
        jo, (jconv, jssm) = jm.mamba2_decode(
            jp, jnp.asarray(xt), jnp.asarray(conv.numpy()),
            jnp.asarray(ssm.numpy()), jcfg)
        o, (conv, ssm) = m.mamba2_decode(p, torch.from_numpy(xt), conv, ssm,
                                         cfg)
        close(o, jo)
        close(conv, jconv)
        close(ssm, jssm)
        outs.append(o)
    close(torch.cat(outs, 1), full.numpy(), CHAIN_TOL)
    close(conv, fconv.numpy(), CHAIN_TOL)
    close(ssm, fssm.numpy(), CHAIN_TOL)
