"""The port's Multi-head Latent Attention (repro_torch/models/mla.py)
against the JAX package's (src/repro/models/mla.py) on the reduced
deepseek-v3 config and at other widths, given the same weights and numpy
inputs, on the CPU: the projections and the naive forward at 1e-5, the
absorbed decode (the reference's default) step by step at 1e-5 and its
chain against the forward at 5e-4."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import CHAIN_TOL, close, np_tree  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.common import flatten_tree  # noqa: E402

# the reduced config (nope 32 + rope 32, v 32), and one whose q·k width
# differs from v's as at full size (nope 48 + rope 16 = 64 vs v 40)
WIDTHS = {"reduced": {},
          "uneven": dict(mla_nope_head_dim=48, mla_rope_head_dim=16,
                         mla_v_head_dim=40, mla_kv_lora_rank=24,
                         num_heads=3)}


def _cfgs(width):
    arch = "deepseek-v3-671b"
    return (dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                **WIDTHS[width]),
            dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                                **WIDTHS[width]))


def _setup(width, seed=0):
    cfg, jcfg = _cfgs(width)
    jp = jmla.mla_params(jax.random.key(seed), jcfg)
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return cfg, jcfg, jp, p


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mla_params_tree_matches_jax(width):
    cfg, jcfg, jp, _ = _setup(width)
    p = mla.mla_params(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in flatten_tree(p)} \
        == {k: tuple(v.shape) for k, v in flatten_tree(np_tree(jp))}
    stacked = mla.mla_params(torch.Generator().manual_seed(0), cfg, lead=(2,))
    assert stacked["wo"].shape == (2,) + tuple(p["wo"].shape)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_project_qkv_matches_jax(width):
    cfg, jcfg, jp, p = _setup(width)
    x = _x(cfg, 2, 9, 1)
    pos = np.random.default_rng(2).integers(0, 5000, (2, 9))
    got = mla._project_qkv(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    want = jmla._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_mla_forward_matches_jax(width, causal):
    cfg, jcfg, jp, p = _setup(width)
    B, S = 2, 12
    x = _x(cfg, B, S, 3)
    pos = np.broadcast_to(np.arange(S), (B, S))
    out, (ckv, kr) = mla.mla_forward(p, torch.from_numpy(x), cfg,
                                     torch.from_numpy(pos.copy()), causal)
    jout, (jckv, jkr) = jmla.mla_forward(jp, jnp.asarray(x), jcfg,
                                         jnp.asarray(pos), causal)
    close(out, jout)
    close(ckv, jckv)
    close(kr, jkr)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_absorbed_decode_matches_jax_at_random_caches(width):
    """One absorbed step against random latent caches, at positions that
    leave part of the cache unwritten and one past its end (clamped to the
    last slot): output and both caches against JAX's absorbed decode."""
    cfg, jcfg, jp, p = _setup(width, seed=1)
    rng = np.random.default_rng(4)
    B, C = 3, 8
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, C, cfg.mla_kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, C, cfg.mla_rope_head_dim)).astype(np.float32)
    pos = np.array([0, 5, 11])
    jo, jc, jk = jmla.mla_decode(jp, jnp.asarray(x), jnp.asarray(ckv),
                                 jnp.asarray(kr), jnp.asarray(pos), jcfg,
                                 absorbed=True)
    tc, tk = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    o, c, k = mla.mla_decode(p, torch.from_numpy(x), tc, tk,
                             torch.from_numpy(pos), cfg)
    assert c is tc and k is tk  # written in place
    close(o, jo)
    close(c, jc)
    close(k, jk)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_absorbed_decode_chain_equals_the_forward(width):
    """Decode from an empty latent cache, token by token, against the
    naive forward (the absorbed form is exact), and the caches it leaves
    against the forward's (c_kv, k_rope)."""
    cfg, _, _, p = _setup(width, seed=2)
    B, S = 2, 10
    x = torch.from_numpy(_x(cfg, B, S, 5))
    pos = torch.arange(S)[None].expand(B, S)
    want, (ckv, kr) = mla.mla_forward(p, x, cfg, pos)
    c = torch.zeros(B, S, cfg.mla_kv_lora_rank)
    k = torch.zeros(B, S, cfg.mla_rope_head_dim)
    outs = []
    for t in range(S):
        o, c, k = mla.mla_decode(p, x[:, t:t + 1], c, k,
                                 torch.full((B,), t), cfg)
        outs.append(o[:, 0])
    close(torch.stack(outs, 1), want.numpy(), CHAIN_TOL)
    close(c, ckv.numpy())
    close(k, kr.numpy())
