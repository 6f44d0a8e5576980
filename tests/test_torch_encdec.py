"""The port's Whisper-style encoder-decoder (repro_torch/models/encdec.py,
and its branches of registry.py and launch/serve.py) against the JAX
package's, on the reduced whisper-large-v3 (2 + 2 layers, d 256, 4 heads
of 64, 64 frames) with JAX's weights, and its pieces: the sinusoidal
positions and the gelu and relu_sq MLPs.  1e-5 on the entry points, 5e-4
on the decode chains (tests/test_models.py:130 holds the reference's
decode against teacher forcing so)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import (CHAIN_TOL, Pair, close, close_trees,  # noqa: E402
                        np_tree, serve_logits_match_the_reference)
from repro.models import common as jcommon  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.models import common, encdec  # noqa: E402
from repro_torch.models.common import flatten_tree, load_jax_params  # noqa: E402

ARCH = "whisper-large-v3"
_PAIR = []


@pytest.fixture
def pair():
    if not _PAIR:
        _PAIR.append(Pair(ARCH))
    return _PAIR[0]


def _enc(pair, jin, tin):
    frames = torch.from_numpy(tin["frames"])
    return (jencdec.encode(pair.jp, pair.jcfg, jin["frames"]),
            encdec.encode(pair.p, pair.cfg, frames))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,d", [(64, 256), (8, 2), (33, 10), (1, 64),
                                   (448, 64)])
def test_sinusoidal_positions_match_jax(seq, d):
    close(common.sinusoidal_positions(seq, d),
          jcommon.sinusoidal_positions(seq, d))


@pytest.mark.parametrize("act", ["gelu", "relu_sq", "silu"])
def test_mlp_params_and_forward_match_jax(act):
    """The gelu MLP is jax.nn.gelu's tanh approximation (the exact erf
    gelu differs by ~1e-3); relu_sq squares the relu."""
    jp = jcommon.mlp_params(jax.random.key(3), 32, 64, act)
    p = common.mlp_params(torch.Generator().manual_seed(0), 32, 64, act)
    assert {k: tuple(v.shape) for k, v in p.items()} \
        == {k: tuple(v.shape) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).normal(size=(2, 5, 32)).astype(np.float32) * 2
    close(common.mlp_forward(p, torch.from_numpy(x), act),
          jcommon.mlp_forward(jp, jnp.asarray(x), act))


def test_layernorm_params_match_jax():
    p = common.layernorm_params(12, lead=(3,))
    assert p["scale"].shape == p["bias"].shape == (3, 12)
    jp = jcommon.layernorm_params(12)
    close(common.layernorm_params(12)["scale"], jp["scale"])
    close(common.layernorm_params(12)["bias"], jp["bias"])


# ---------------------------------------------------------------------------
# the encoder-decoder's functions
# ---------------------------------------------------------------------------


def test_param_trees_match_and_mismatches_raise(pair):
    assert {k: tuple(v.shape) for k, v in flatten_tree(pair.p)} \
        == {k: tuple(v.shape) for k, v in flatten_tree(np_tree(pair.jp))}
    fresh = encdec.init_params(torch.Generator().manual_seed(0), pair.cfg)
    assert {k: tuple(v.shape) for k, v in flatten_tree(fresh)} \
        == {k: tuple(v.shape) for k, v in flatten_tree(pair.p)}
    bad = np_tree(pair.jp)
    bad["dec_blocks"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(fresh, bad)
    bad = np_tree(pair.jp)
    bad["enc_blocks"]["attn"]["wq"] = bad["enc_blocks"]["attn"]["wq"][:, :8]
    with pytest.raises(ValueError, match="enc_blocks.attn.wq"):
        load_jax_params(fresh, bad)


def test_encode_and_cross_kv_match_jax(pair):
    jin, tin = pair.inputs(2, 4, seed=1)
    jenc, enc = _enc(pair, jin, tin)
    close(enc, jenc)
    close_trees(encdec.cross_kv(pair.p, pair.cfg, enc),
                jencdec.cross_kv(pair.jp, pair.jcfg, jenc))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decoder_forward_matches_jax(pair, use_kernels):
    jin, tin = pair.inputs(2, 12, seed=2)
    jenc, enc = _enc(pair, jin, tin)
    jh, jkv = jencdec.decoder_forward(pair.jp, pair.jcfg, jin["tokens"], jenc,
                                      emit_cache=True)
    h, kv = encdec.decoder_forward(pair.p, pair.cfg,
                                   torch.from_numpy(tin["tokens"]), enc,
                                   emit_cache=True, use_kernels=use_kernels)
    close(h, jh)
    close_trees(kv, jkv)
    h2, none = encdec.decoder_forward(pair.p, pair.cfg,
                                      torch.from_numpy(tin["tokens"]), enc)
    assert none is None and torch.equal(h2, h)


def test_decode_steps_match_jax_and_teacher_forcing(pair):
    """decode_step from an empty self cache, each step against JAX's
    (logits and caches), the chain against the teacher-forced decoder
    (tests/test_models.py:130)."""
    B, S = 2, 6
    jin, tin = pair.inputs(B, S, seed=3)
    jenc, enc = _enc(pair, jin, tin)
    jxkv = jencdec.cross_kv(pair.jp, pair.jcfg, jenc)
    xkv = encdec.cross_kv(pair.p, pair.cfg, enc)
    jc = jencdec.init_self_cache(pair.jcfg, B, S, jnp.float32)
    c = encdec.init_self_cache(pair.cfg, B, S, torch.float32)
    jstep = jax.jit(jencdec.decode_step, static_argnums=1)
    outs = []
    for t in range(S):
        tok = tin["tokens"][:, t:t + 1]
        jl, jc = jstep(pair.jp, pair.jcfg, jnp.asarray(tok), jc, jxkv,
                       jnp.full((B,), t, jnp.int32))
        lg, c2 = encdec.decode_step(pair.p, pair.cfg, torch.from_numpy(tok), c,
                                    xkv, torch.full((B,), t))
        assert c2 is c  # written in place
        close(lg, jl, CHAIN_TOL)
        outs.append(lg[:, 0])
    close_trees(c, jc, CHAIN_TOL)
    h, _ = encdec.decoder_forward(pair.p, pair.cfg,
                                  torch.from_numpy(tin["tokens"]), enc)
    close(torch.stack(outs, 1), (h @ pair.p["lm_head"]).numpy(), CHAIN_TOL)


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------


def test_forward_logits_and_aux_match_jax(pair):
    jin, tin = pair.inputs(2, 10, seed=4)
    jh = pair.jm.forward(pair.jp, jin)
    h, aux = pair.m.forward_with_aux(pair.p, tin)
    close(h, jh)
    close(pair.m.logits(pair.p, h), pair.jm.logits(pair.jp, jh))
    assert float(aux) == 0.0
    close(pair.plain.forward(pair.p, tin), jh)


def test_prefill_matches_jax(pair):
    jin, tin = pair.inputs(2, 9, seed=5)
    jl, jc = pair.jm.prefill(pair.jp, jin)
    lg, c = pair.m.prefill(pair.p, tin)
    close(lg, jl)
    assert set(c) == {"self", "cross"}
    close_trees(c, jc)


def test_decode_after_prefill_matches_jax(pair):
    """Prefill over 6 tokens, the self cache padded to 10, then 4 decode
    steps on both sides with the prefill's cross K/V."""
    B, S, n = 2, 6, 4
    jin, tin = pair.inputs(B, S + n, seed=6)
    _, jc = pair.jm.prefill(pair.jp, {**jin, "tokens": jin["tokens"][:, :S]})
    _, c = pair.m.prefill(pair.p, {**tin, "tokens": tin["tokens"][:, :S]})
    pad = [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)]
    jc = {"self": {k: jnp.pad(v, pad) for k, v in jc["self"].items()},
          "cross": jc["cross"]}
    c = {"self": {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
                  for k, v in c["self"].items()}, "cross": c["cross"]}
    for t in range(S, S + n):
        jl, jc = pair.jdecode(pair.jp, jin["tokens"][:, t:t + 1], jc,
                              jnp.full((B,), t, jnp.int32))
        lg, c = pair.m.decode_step(pair.p, tin["tokens"][:, t:t + 1], c,
                                   np.full((B,), t), extras={"unused": 1})
        close(lg, jl, CHAIN_TOL)
    close_trees(c, jc, CHAIN_TOL)


def test_encode_segment_is_the_mean_of_the_encoder(pair):
    jin, tin = pair.inputs(4, 3, seed=7)
    je, jaux = pair.jm.encode_segment(pair.jp, jin)
    e, aux = pair.m.encode_segment(pair.p, tin)
    assert tuple(e.shape) == (4, pair.cfg.d_model)
    close(e, je)
    assert float(aux) == float(jaux) == 0.0


def test_serve_gives_the_reference_logits_at_each_step(monkeypatch, capsys):
    serve_logits_match_the_reference(ARCH, monkeypatch)
    assert "[whisper-large-v3] generated (2, 5)" in capsys.readouterr().out
