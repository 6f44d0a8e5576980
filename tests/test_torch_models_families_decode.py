"""The decode paths of the port's decoder-only families beyond the dense
one — arctic-480b (gqa_moe), deepseek-v3-671b (mla_dense + mla_moe: the
absorbed MLA decode, the MoE's routed-token counters) and qwen2-vl-7b
(M-RoPE ids at the decode position) — against the JAX package's, reduced,
with JAX's weights and inputs made from a numpy seed, on the CPU: the
decode chains at 5e-4 (tests/test_models.py), with the cache exactly the
sequence's length and over-allocated with ``moe_cap_len`` pinned, and the
serving launcher's logits at each step."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import (CHAIN_TOL, close, close_trees, pair_of,  # noqa: E402
                        serve_logits_match_the_reference)
from repro_torch.models import transformer  # noqa: E402

ARCHS = ["arctic-480b", "deepseek-v3-671b", "qwen2-vl-7b"]


@pytest.fixture(params=ARCHS)
def pair(request):
    return pair_of(request.param)


def _slice(inputs, S):
    return {**inputs, "tokens": inputs["tokens"][:, :S]}


def test_decode_steps_after_prefill_match_jax(pair):
    """Prefill over 12 tokens (text only: decode has no patch prefix), the
    caches padded to 18 (counters as they are), then 6 decode steps on
    both sides with the MoE capacity of the cache length."""
    B, S, n = 2, 12, 6
    jin, tin = pair.inputs(B, S + n, seed=4, patches=False)
    _, jc = pair.jm.prefill(pair.jp, _slice(jin, S))
    _, c = pair.m.prefill(pair.p, _slice(tin, S))

    def jpad(v):
        return v if v.ndim < 4 else jnp.pad(
            v, [(0, 0), (0, 0), (0, n)] + [(0, 0)] * (v.ndim - 3))

    def pad(v):
        return v if v.dim() < 4 else torch.nn.functional.pad(
            v, (0, 0) * (v.dim() - 3) + (0, n))

    jc = [{k: jpad(v) for k, v in run.items()} for run in jc]
    c = [{k: pad(v) for k, v in run.items()} for run in c]
    for t in range(S, S + n):
        jl, jc = pair.jdecode(pair.jp, jin["tokens"][:, t:t + 1], jc,
                              jnp.full((B,), t, jnp.int32))
        lg, c = pair.m.decode_step(pair.p, tin["tokens"][:, t:t + 1], c,
                                   np.full((B,), t))
        close(lg, jl, CHAIN_TOL)
    close_trees(c, jc, CHAIN_TOL)


@pytest.mark.parametrize("over", [1, 2])
def test_decode_from_empty_cache_equals_forward(pair, over):
    """The reference's strongest cache property (tests/test_models.py:15),
    with the cache exactly the sequence's length and over-allocated to
    twice it with ``moe_cap_len`` pinned to the sequence
    (tests/test_models.py:191)."""
    B, S = 1, 8
    _, tin = pair.inputs(B, S, seed=5, patches=False)
    full = pair.m.logits(pair.p, pair.m.forward(pair.p, tin))
    caches = pair.m.init_cache(B, over * S)
    outs = []
    for t in range(S):
        lg, caches = pair.m.decode_step(pair.p, tin["tokens"][:, t:t + 1],
                                        caches, np.full((B,), t),
                                        moe_cap_len=S if over > 1 else 0)
        outs.append(lg[:, 0])
    close(torch.stack(outs, 1), full.numpy(), CHAIN_TOL)


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b"])
def test_moe_decode_counters_continue_the_prefill(arch):
    """After a prefill, the MoE counters in the cache are the forward's
    routed-token counts (k a token), and decode adds its token's k experts
    to them in place."""
    pair = pair_of(arch)
    B, S = 2, 8
    _, tin = pair.inputs(B, S + 1, seed=6)
    _, c = pair.m.prefill(pair.p, _slice(tin, S))
    counts = c[-1]["moe_counts"]
    n_moe = transformer.layer_runs(pair.cfg)[-1][1]
    assert counts.shape == (n_moe, B, pair.cfg.moe.num_experts)
    assert counts.sum(-1).eq(S * pair.cfg.moe.top_k).all()
    c = [{k: v if v.dim() < 4 else torch.nn.functional.pad(
        v, (0, 0) * (v.dim() - 3) + (0, 1)) for k, v in run.items()}
        for run in c]
    held = c[-1]["moe_counts"]
    pair.m.decode_step(pair.p, tin["tokens"][:, S:], c, np.full((B,), S))
    assert c[-1]["moe_counts"] is held
    assert held.sum(-1).eq((S + 1) * pair.cfg.moe.top_k).all()


def test_serve_gives_the_reference_logits_at_each_step(pair, monkeypatch,
                                                       capsys):
    serve_logits_match_the_reference(pair.cfg.name, monkeypatch)
    assert f"[{pair.cfg.name}] generated (2, 5)" in capsys.readouterr().out
