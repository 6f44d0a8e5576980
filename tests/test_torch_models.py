"""The port's sequence-track dense transformer (repro_torch.configs,
models/, launch/serve.py) against the JAX package's, given the same
weights (JAX's ``model.init`` carried over by ``load_jax_params``) and the
same numpy tokens, on the CPU: every ported entry point at 1e-5, the
decode chains at 5e-4 (the reference's forward-vs-decode tolerance,
tests/test_models.py:40-41), the configs field by field, and the serving
launcher's logits at each step."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import (CHAIN_TOL, Pair, close, np_tree,  # noqa: E402
                        serve_logits_match_the_reference)
from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import load_jax_params  # noqa: E402

# reduced olmo-1b (tied embeddings, non-parametric LayerNorm), reduced
# internlm2-1.8b (MHA once reduced, configs/base.py:141-142) and the same
# with 2 KV heads, so that GQA stays under test
CASES = {"olmo-1b": ("olmo-1b", {}),
         "internlm2-1.8b": ("internlm2-1.8b", {}),
         "internlm2-1.8b-gqa": ("internlm2-1.8b", {"num_kv_heads": 2})}
_PAIRS = {}


@pytest.fixture(params=list(CASES))
def pair(request):
    if request.param not in _PAIRS:
        arch, replace = CASES[request.param]
        _PAIRS[request.param] = Pair(arch, **replace)
    return _PAIRS[request.param]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_configs_equal_the_reference_field_by_field(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for ours, theirs in ((configs.get_config(arch), jconfigs.get_config(arch)),
                         (configs.reduced(configs.get_config(arch)),
                          jconfigs.reduced(jconfigs.get_config(arch)))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert {k: dataclasses.asdict(v) for k, v in configs.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------


def test_param_trees_match_and_mismatches_raise(pair):
    flat = dict(common.flatten_tree(pair.p))
    jflat = dict(common.flatten_tree(np_tree(pair.jp)))
    assert {k: tuple(v.shape) for k, v in flat.items()} \
        == {k: tuple(v.shape) for k, v in jflat.items()}
    bad = np_tree(pair.jp)
    bad["runs"][0]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(pair.m.init(torch.Generator().manual_seed(0)), bad)
    bad = np_tree(pair.jp)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        load_jax_params(pair.m.init(torch.Generator().manual_seed(0)), bad)


@pytest.mark.parametrize("window", [0, 16])
def test_forward_and_logits_match_jax(pair, window):
    jin, tin = pair.inputs(2, 40, seed=window)
    jh = pair.jm.forward(pair.jp, jin, window=window)
    h = pair.m.forward(pair.p, tin, window=window)
    close(h, jh)
    close(pair.m.logits(pair.p, h), pair.jm.logits(pair.jp, jh))
    jh2, jaux = pair.jm.forward_with_aux(pair.jp, jin, window=window)
    h2, aux = pair.m.forward_with_aux(pair.p, tin, window=window)
    close(h2, jh2)
    assert float(aux) == float(jaux) == 0.0


def test_kernel_path_equals_plain_path_on_the_cpu(pair):
    _, tin = pair.inputs(2, 40, seed=3)
    plain = registry.Model(pair.cfg, use_kernels=False,
                           device=torch.device("cpu"))
    for window in (0, 16):
        close(pair.m.forward(pair.p, tin, window=window),
              plain.forward(pair.p, tin, window=window).numpy())


def test_prefill_logits_and_caches_match_jax(pair):
    jin, tin = pair.inputs(2, 24, seed=4)
    jl, jc = pair.jm.prefill(pair.jp, jin)
    lg, c = pair.m.prefill(pair.p, tin)
    close(lg, jl)
    assert len(c) == len(jc) == 1
    for name in ("k", "v"):
        close(c[0][name], jc[0][name])


def test_decode_steps_after_prefill_match_jax(pair):
    """Prefill over 16 tokens, its caches padded to 24, then 8 decode
    steps on both sides."""
    B, S, n = 2, 16, 8
    jin, tin = pair.inputs(B, S + n, seed=5)
    _, jc = pair.jm.prefill(pair.jp, {"tokens": jin["tokens"][:, :S]})
    _, c = pair.m.prefill(pair.p, {"tokens": tin["tokens"][:, :S]})
    pad = [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)]
    jc = [{k: jnp.pad(v, pad) for k, v in run.items()} for run in jc]
    c = [{k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
          for k, v in run.items()} for run in c]
    for t in range(S, S + n):
        jl, jc = pair.jdecode(pair.jp, jin["tokens"][:, t:t + 1], jc,
                                     jnp.full((B,), t, jnp.int32))
        lg, c = pair.m.decode_step(pair.p, tin["tokens"][:, t:t + 1], c,
                                   np.full((B,), t))
        close(lg, jl, CHAIN_TOL)
    for name in ("k", "v"):
        close(c[0][name], jc[0][name], CHAIN_TOL)


def test_decode_from_empty_cache_equals_forward(pair):
    """The reference's strongest cache property (tests/test_models.py:15),
    on the port."""
    _, tin = pair.inputs(1, 8, seed=6)
    full = pair.m.logits(pair.p, pair.m.forward(pair.p, tin))
    caches = pair.m.init_cache(1, 8)
    outs = []
    for t in range(8):
        lg, caches = pair.m.decode_step(pair.p, tin["tokens"][:, t:t + 1],
                                        caches, np.full((1,), t))
        outs.append(lg[:, 0])
    close(torch.stack(outs, 1), full.numpy(), CHAIN_TOL)


def test_decode_step_writes_the_caches_in_place(pair):
    """decode_step writes each layer's new key and value into the stacked
    caches it is given, at the slot of cache_pos, and returns them."""
    B, C, t = 2, 6, 3
    _, tin = pair.inputs(B, 1, seed=9)
    caches = pair.m.init_cache(B, C)
    _, out = pair.m.decode_step(pair.p, tin["tokens"], caches,
                                np.full((B,), t))
    for name in ("k", "v"):
        assert out[0][name] is caches[0][name]
        written = caches[0][name].abs().sum(dim=(0, 1, 3, 4)) > 0
        assert written.tolist() == [s == t for s in range(C)]


def test_ring_buffer_decode_matches_jax(pair):
    """A ring cache of W = 8 slots over 20 tokens (it wraps twice) against
    JAX's, and against the windowed forward."""
    B, total, W = 1, 20, 8
    jin, tin = pair.inputs(B, total, seed=7)
    jc = pair.jm.init_cache(B, W, jnp.float32)
    c = pair.m.init_cache(B, W)
    outs = []
    for t in range(total):
        jl, jc = pair.jdecode(pair.jp, jin["tokens"][:, t:t + 1], jc,
                                     jnp.full((B,), t, jnp.int32), window=W,
                                     ring=True)
        lg, c = pair.m.decode_step(pair.p, tin["tokens"][:, t:t + 1], c,
                                   np.full((B,), t), window=W, ring=True)
        close(lg, jl, CHAIN_TOL)
        outs.append(lg[:, 0])
    want = pair.m.logits(pair.p, pair.m.forward(pair.p, tin, window=W))
    close(torch.stack(outs, 1), want.numpy(), CHAIN_TOL)


def test_encode_segment_matches_jax(pair):
    """GST's segment encoder F: 4 documents x 4 segments of 32 tokens."""
    jin, tin = pair.inputs(16, 32, seed=8)
    je, jaux = pair.jm.encode_segment(pair.jp, jin)
    e, aux = pair.m.encode_segment(pair.p, tin)
    assert tuple(e.shape) == (16, pair.cfg.d_model)
    close(e, je)
    assert float(aux) == float(jaux)


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    jp, jfn = jcommon.make_norm(kind, 64)
    p, fn = common.make_norm(kind, 64)
    if kind != "nonparam_ln":
        p["scale"] = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        jp = {**jp, "scale": jnp.asarray(p["scale"].numpy())}
    close(fn(p, torch.from_numpy(x)), jfn(jp, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9))
    close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_mlp_matches_jax_and_other_activations_wait():
    """The SwiGLU MLP and, ported since, the gelu (tanh approximation)
    and relu_sq MLPs against JAX's, with the reference's parameter names."""
    x = np.random.default_rng(2).normal(size=(2, 5, 32)).astype(np.float32)
    for act in ("silu", "gelu", "relu_sq"):
        jp = jcommon.mlp_params(jax.random.key(2), 32, 64, act)
        assert set(common.mlp_params(torch.Generator(), 32, 64, act)) \
            == set(jp)
        p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
        close(common.mlp_forward(p, torch.from_numpy(x), act),
              jcommon.mlp_forward(jp, jnp.asarray(x), act))


def test_write_cache_matches_jax():
    rng = np.random.default_rng(3)
    cache = rng.normal(size=(3, 6, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 1, 2, 4)).astype(np.float32)
    idx = np.array([0, 5, 2])
    target = torch.from_numpy(cache.copy())
    got = common.write_cache(target, torch.from_numpy(new),
                             torch.from_numpy(idx))
    want = jcommon.write_cache(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got is target  # written in place


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_families_not_ported_yet_raise(arch):
    with pytest.raises(NotImplementedError, match="A4"):
        build_model(configs.reduced(configs.get_config(arch)), device="cpu")


def test_default_device_is_cuda_and_raises_without_a_card():
    assert registry.Model(configs.get_config("olmo-1b")).device.type == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="is_available"):
        build_model(configs.reduced(configs.get_config("olmo-1b")))
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--arch", "olmo-1b", "--reduced"])


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmo-1b"])
def test_serve_gives_the_reference_logits_at_each_step(arch, monkeypatch,
                                                       capsys):
    serve_logits_match_the_reference(arch, monkeypatch, gen=6, prompt=6)
    assert "generated (2, 6)" in capsys.readouterr().out


def test_serve_cli_runs_on_the_cpu(capsys):
    gen = serve.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                      "--reduced", "--gen", "3"])
    assert gen.shape == (2, 3)
    assert "[internlm2-1.8b] generated (2, 3)" in capsys.readouterr().out
