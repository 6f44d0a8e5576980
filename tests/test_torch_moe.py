"""The port's Mixture-of-Experts FFN (repro_torch/models/moe.py) against
the JAX package's (src/repro/models/moe.py), given the same weights and
the same numpy inputs, on the CPU: the forward's outputs, aux loss and
routed-token counts at 1e-5, with and without capacity dropping, and the
decode chain (the counters reproducing the forward's per-row dropping)
at 2e-5, as tests/test_models.py:155-211 hold the reference.  Inputs are
drawn so that no two router probabilities of a token tie at the top-k
boundary: torch.topk and jax.lax.top_k then select the same set."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_seq import close, np_tree  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import flatten_tree  # noqa: E402

D = 16
# (config fields, activation): arctic-like (dense residual), deepseek-like
# (a shared expert), a gelu expert FFN; capacity factors that keep every
# token (2.0) and that drop (0.5)
CASES = {
    "dense_residual": (dict(num_experts=4, top_k=2, expert_d_ff=32,
                            dense_d_ff=24), "silu"),
    "shared": (dict(num_experts=4, top_k=2, expert_d_ff=32,
                    num_shared_experts=1), "silu"),
    "gelu": (dict(num_experts=8, top_k=3, expert_d_ff=32), "gelu"),
}


def _cfgs(name, capacity_factor):
    fields, act = CASES[name]
    fields = dict(fields, capacity_factor=capacity_factor)
    return MoEConfig(**fields), JMoEConfig(**fields), act


def _params(jcfg, act, seed=0):
    jp = jmoe.moe_params(jax.random.key(seed), D, jcfg, act)
    return jp, jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                      jp)


def _untied_x(jp, shape, seed, K):
    """Normal inputs whose router probabilities leave a gap of at least
    1e-3 between the k-th and (k+1)-th expert of every token."""
    rng = np.random.default_rng(seed)
    router = np.asarray(jp["router"], np.float64)
    while True:
        x = rng.normal(size=shape).astype(np.float32)
        logits = np.sort(x.reshape(-1, D) @ router, axis=-1)[:, ::-1]
        if logits.shape[1] == K or np.all(logits[:, K - 1] - logits[:, K]
                                          > 1e-3):
            return x


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_matches_jax(name, capacity_factor):
    cfg, jcfg, act = _cfgs(name, capacity_factor)
    jp, p = _params(jcfg, act)
    B, S = 3, 8
    x = _untied_x(jp, (B, S, D), 0, cfg.top_k)
    jout, jaux, jcounts = jmoe.moe_forward(jp, jnp.asarray(x), jcfg, act,
                                           with_counts=True)
    out, aux, counts = moe.moe_forward(p, torch.from_numpy(x), cfg, act,
                                       with_counts=True)
    close(out, jout)
    close(aux, jaux)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.dtype == torch.int32
    dropped = int(np.asarray(jcounts).max()) > moe.capacity(S, cfg)
    assert dropped == (capacity_factor < 1.0), "the drop case must drop"
    out2, aux2 = moe.moe_forward(p, torch.from_numpy(x), cfg, act)
    assert torch.equal(out2, out) and torch.equal(aux2, aux)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_decode_chain_reproduces_the_forward_and_jax(name,
                                                         capacity_factor):
    """Token by token with the routed-token counters: each step equal to
    JAX's moe_decode, the chain equal to the teacher-forced forward
    (dropping included), the counters equal to the forward's counts."""
    cfg, jcfg, act = _cfgs(name, capacity_factor)
    jp, p = _params(jcfg, act, seed=1)
    B, S = 3, 8
    x = _untied_x(jp, (B, S, D), 1, cfg.top_k)
    out_fwd, _, counts_fwd = moe.moe_forward(p, torch.from_numpy(x), cfg, act,
                                             with_counts=True)
    cap = moe.capacity(S, cfg)
    assert cap == jmoe.capacity(S, jcfg)
    counts = torch.zeros(B, cfg.num_experts, dtype=torch.int32)
    jcounts = jnp.zeros((B, cfg.num_experts), jnp.int32)
    outs = []
    for t in range(S):
        o, aux, counts = moe.moe_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                        cfg, act, counts, cap)
        jo, jaux, jcounts = jmoe.moe_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                            jcfg, act, jcounts, cap)
        close(o, jo)
        close(aux, jaux)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        outs.append(o[:, 0])
    close(torch.stack(outs, 1), out_fwd.numpy(), dict(rtol=2e-5, atol=2e-5))
    assert torch.equal(counts, counts_fwd)


@pytest.mark.parametrize("S", [1, 7, 8, 64, 513, 2048])
@pytest.mark.parametrize("name", list(CASES))
def test_capacity_matches_jax(name, S):
    for cf in (0.5, 1.0, 1.25, 2.0):
        cfg, jcfg, _ = _cfgs(name, cf)
        assert moe.capacity(S, cfg) == jmoe.capacity(S, jcfg)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_gating_matches_jax(k):
    logits = np.random.default_rng(k).normal(size=(5, 7, 6)).astype(np.float32)
    want = jmoe._top_k_gating(jnp.asarray(logits), k)
    got = moe._top_k_gating(torch.from_numpy(logits), k)
    for g, w in zip(got, want):
        close(g, w)
    assert got[1].sum(-1).eq(k).all()


@pytest.mark.parametrize("name", list(CASES))
def test_moe_params_tree_matches_jax(name):
    cfg, jcfg, act = _cfgs(name, 1.25)
    jp = jmoe.moe_params(jax.random.key(0), D, jcfg, act)
    p = moe.moe_params(torch.Generator().manual_seed(0), D, cfg, act)
    assert {k: tuple(v.shape) for k, v in flatten_tree(p)} \
        == {k: tuple(v.shape) for k, v in flatten_tree(np_tree(jp))}
    assert p["router"].dtype == torch.float32
    # the experts: a normal cut at ±2σ times 1/√d (1/√F for w_out)
    w = p["experts"]["w_in"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(D) + 1e-7
    stacked = moe.moe_params(torch.Generator().manual_seed(0), D, cfg, act,
                             lead=(3,))
    assert stacked["experts"]["w_out"].shape == (3, cfg.num_experts,
                                                 cfg.expert_d_ff, D)


def test_aux_loss_balanced_routing_is_minimal():
    """As tests/test_models.py:214: uniform routing gives aux ≈ 1, a peaked
    router more; the port's loss equals the reference's on both."""
    T, E, K = 256, 8, 2
    uniform = np.zeros((T, E), np.float32)
    peaked = uniform.copy()
    peaked[:, 0], peaked[:, 1] = 10.0, 9.0
    auxes = []
    for logits in (uniform, peaked):
        _, mask, probs = moe._top_k_gating(torch.from_numpy(logits), K)
        auxes.append(float(moe._aux_loss(mask, probs, E, K, 0)))
    assert auxes[1] > auxes[0]
    np.testing.assert_allclose(auxes[0], 1.0, atol=0.2)
    _, jmask, jprobs = jmoe._top_k_gating(jnp.asarray(peaked), K)
    np.testing.assert_allclose(
        auxes[1], float(jnp.sum(jnp.mean(jmask, 0) * jnp.mean(jprobs, 0))
                        * E / K), rtol=1e-6)


def test_decode_drops_at_a_full_counter():
    """A counter at the capacity drops the token at that expert (its
    routed contribution 0), one below keeps it."""
    cfg, jcfg, act = _cfgs("gelu", 1.0)
    cfg = dataclasses.replace(cfg, top_k=1)
    jp, p = _params(dataclasses.replace(jcfg, top_k=1), act)
    x = _untied_x(jp, (1, 1, D), 2, 1)
    logits = x.reshape(1, D) @ np.asarray(jp["router"])
    e = int(np.argmax(logits))
    cap = 4
    full = torch.zeros(1, cfg.num_experts, dtype=torch.int32)
    full[0, e] = cap
    o_drop, _, c_drop = moe.moe_decode(p, torch.from_numpy(x), cfg, act,
                                       full, cap)
    assert float(o_drop.abs().max()) == 0.0  # no shared or dense path here
    assert int(c_drop[0, e]) == cap + 1
    o_keep, _, _ = moe.moe_decode(p, torch.from_numpy(x), cfg, act,
                                  full - (torch.arange(cfg.num_experts) == e)
                                  .int()[None], cap)
    assert float(o_keep.abs().max()) > 0.0
