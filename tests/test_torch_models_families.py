"""The port's decoder-only families beyond the dense one — arctic-480b
(gqa_moe: GQA attention + MoE with a dense residual), deepseek-v3-671b
(mla_dense + mla_moe: MLA attention, a shared expert), qwen2-vl-7b
(M-RoPE, the patch prefix), zamba2-1.2b (mamba + shared_attn; also at 4
layers, where one shared parameter set serves two occurrences) and
rwkv6-7b (rwkv) — against the JAX package's, reduced, with JAX's weights
carried over by ``load_jax_params`` and inputs made from a numpy seed, on
the CPU: the full-sequence entry points at 1e-5, and M-RoPE's pieces.
The decode chains and the serving launcher are in
test_torch_models_families_decode.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import (NOISE_TOL, close, close_trees, np_tree,  # noqa: E402
                        pair_of, pair_param, ulp_noise)
from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.models.common import flatten_tree, load_jax_params  # noqa: E402

ARCHS = ["arctic-480b", "deepseek-v3-671b", "qwen2-vl-7b", "zamba2-1.2b",
         "zamba2-1.2b/4L", "rwkv6-7b"]


@pytest.fixture(params=ARCHS)
def pair(request):
    return pair_param(request.param)


# ---------------------------------------------------------------------------
# M-RoPE and the patch prefix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,D", [((16, 8, 8), 64), ((16, 24, 24), 128),
                                        ((2, 1, 1), 8)])
def test_apply_mrope_matches_jax(sections, D):
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 9, 3, D)).astype(np.float32)
    thw = rng.integers(0, 3000, (2, 9, 3))
    for theta in (1e4, 1e6):
        close(common.apply_mrope(torch.from_numpy(x), torch.from_numpy(thw),
                                 theta, sections),
              jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(thw), theta,
                                  sections))


def test_mrope_with_equal_ids_is_rope():
    """Where t, h and w are one position, M-RoPE is RoPE at it."""
    x = torch.randn(1, 5, 2, 64, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)[None] * 7
    got = common.apply_mrope(x, pos[..., None].expand(1, 5, 3), 1e4,
                             (16, 8, 8))
    torch.testing.assert_close(got, common.apply_rope(x, pos, 1e4),
                               rtol=0, atol=0)


def test_mrope_refuses_sections_that_miss_half_the_head_dim():
    with pytest.raises(ValueError, match="sum to D/2 = 32"):
        common.apply_mrope(torch.zeros(1, 2, 1, 64),
                           torch.zeros(1, 2, 3, dtype=torch.long), 1e4,
                           (16, 8, 4))


@pytest.mark.parametrize("P", [0, 1, 16, 256, 10])
def test_mrope_ids_match_jax(P):
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config("qwen2-vl-7b")),
        vision_prefix_len=P)
    jcfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("qwen2-vl-7b")),
        vision_prefix_len=P)
    idx = np.arange(3 * P + 40)
    np.testing.assert_array_equal(
        transformer._mrope_ids(cfg, torch.from_numpy(idx)).numpy(),
        np.asarray(jtransformer._mrope_ids(jcfg, jnp.asarray(idx))))
    pos, thw = transformer._build_positions(cfg, 2, 20)
    jpos, jthw = jtransformer._build_positions(jcfg, 2, 20)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(thw.numpy(), np.asarray(jthw))


def test_patch_prefix_matches_jax_and_leaves_the_embedding_alone():
    pair = pair_of("qwen2-vl-7b")
    jin, tin = pair.inputs(2, 24, seed=11)
    before = pair.p["embed"].clone()
    x = transformer._embed(pair.p, pair.cfg, torch.from_numpy(tin["tokens"]),
                           torch.from_numpy(tin["patches"]))
    close(x, jtransformer._embed(pair.jp, pair.jcfg, jin["tokens"],
                                 jin["patches"]))
    P = pair.cfg.vision_prefix_len
    np.testing.assert_array_equal(x[:, :P].numpy(), tin["patches"])
    assert torch.equal(pair.p["embed"], before)
    h_patch = pair.m.forward(pair.p, tin)
    h_text = pair.m.forward(pair.p, {"tokens": tin["tokens"]})
    assert not torch.allclose(h_patch, h_text)


def test_dense_configs_have_no_mrope_positions():
    cfg = configs.reduced(configs.get_config("internlm2-1.8b"))
    assert transformer._build_positions(cfg, 1, 4)[1] is None


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------


def test_param_trees_match_and_mismatches_raise(pair):
    flat = {k: tuple(v.shape) for k, v in flatten_tree(pair.p)}
    assert flat == {k: tuple(v.shape)
                    for k, v in flatten_tree(np_tree(pair.jp))}
    fresh = pair.m.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in flatten_tree(fresh)} == flat
    bad = np_tree(pair.jp)
    bad["runs"][-1]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(fresh, bad)
    bad = np_tree(pair.jp)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        load_jax_params(fresh, bad)


def test_runs_are_the_reference_block_kinds(pair):
    assert transformer.layer_runs(pair.cfg) \
        == jtransformer.layer_runs(pair.jcfg)


def test_forward_logits_and_aux_match_jax(pair):
    jin, tin = pair.inputs(2, 24, seed=1)
    jh, jaux = pair.jm.forward_with_aux(pair.jp, jin)
    h, aux = pair.m.forward_with_aux(pair.p, tin)
    close(h, jh, pair.tol)
    close(aux, jaux)
    if pair.cfg.family == "moe":
        assert float(aux) > 0.0  # one Switch loss a MoE layer, summed
    close(pair.m.forward(pair.p, tin), pair.jm.forward(pair.jp, jin),
          pair.tol)
    close(pair.m.logits(pair.p, h), pair.jm.logits(pair.jp, jh), pair.tol)


@pytest.mark.parametrize("window", [0, 8])
def test_kernel_path_equals_plain_path_on_the_cpu(pair, window):
    _, tin = pair.inputs(2, 20, seed=2)
    close(pair.m.forward(pair.p, tin, window=window),
          pair.plain.forward(pair.p, tin, window=window).numpy())


def test_prefill_logits_and_caches_match_jax(pair):
    jin, tin = pair.inputs(2, 20, seed=3)
    jl, jc = pair.jm.prefill(pair.jp, jin)
    lg, c = pair.m.prefill(pair.p, tin)
    close(lg, jl, pair.tol)
    close_trees(c, jc, pair.tol)
    if pair.cfg.family == "moe":
        assert c[-1]["moe_counts"].dtype == torch.int32


def test_encode_segment_matches_jax(pair):
    """GST's segment encoder F: 8 segments of 16 tokens (the VLM's with
    its patch prefix)."""
    jin, tin = pair.inputs(8, 16, seed=8)
    je, jaux = pair.jm.encode_segment(pair.jp, jin)
    e, aux = pair.m.encode_segment(pair.p, tin)
    assert tuple(e.shape) == (8, pair.cfg.d_model)
    close(e, je, pair.tol)
    close(aux, jaux)


def test_shared_attention_is_one_parameter_set_with_a_cache_each():
    """zamba2 at 4 layers (mamba, shared_attn, mamba, shared_attn): the
    shared runs hold no parameters of their own, both occurrences apply
    params["shared_attn"], and a prefill over two SSD chunks (128 tokens,
    chunk 64) emits an unstacked K/V cache for each, as JAX's."""
    pair = pair_param("zamba2-1.2b/4L")
    assert [k for k, _ in transformer.layer_runs(pair.cfg)] \
        == ["mamba", "shared_attn", "mamba", "shared_attn"]
    assert pair.p["runs"][1] == pair.p["runs"][3] == {}
    B, S = 2, 2 * pair.cfg.ssm.chunk_size
    jin, tin = pair.inputs(B, S, seed=12)
    jl, jc = pair.jm.prefill(pair.jp, jin)
    lg, c = pair.m.prefill(pair.p, tin)
    close(lg, jl, pair.tol)
    close_trees(c, jc, pair.tol)
    shape = (B, S, pair.cfg.num_kv_heads, pair.cfg.resolved_head_dim)
    assert tuple(c[1]["k"].shape) == tuple(c[3]["v"].shape) == shape
    assert not torch.equal(c[1]["k"], c[3]["k"])
    close(pair.m.forward(pair.p, tin), pair.jm.forward(pair.jp, jin),
          pair.tol)


@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-1.2b/4L"])
def test_reference_noise_floor(name):
    """Why these Pairs are held at NOISE_TOL: JAX's own forward moves by
    more than half of 1e-5 when its embedding moves by one ulp (1.0e-5 and
    2.6e-5), and the port's distance from JAX is within twice that."""
    pair = pair_param(name)
    assert pair.tol is NOISE_TOL
    jin, tin = pair.inputs(2, 24, seed=1)

    def forward(embed):
        return pair.jm.forward({**pair.jp, "embed": jnp.asarray(embed)}, jin)

    noise = ulp_noise(forward, np.asarray(pair.jp["embed"]))
    got = np.abs(pair.m.forward(pair.p, tin).numpy()
                 - np.asarray(pair.jm.forward(pair.jp, jin))).max()
    assert noise > 5e-6
    assert got < 2 * noise < NOISE_TOL["atol"]
