"""Shared set-up of the port's sequence-model parity tests: a reduced model
in both packages with JAX's weights carried into the port, inputs made
from a numpy seed for both, and the reference serving launcher's logits
at each step."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import build_model as jbuild_model
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import build_model, registry
from repro_torch.models.common import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = dict(rtol=5e-4, atol=5e-4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def close_trees(got, want, tol=TOL):
    """Every leaf of two trees of the same structure (dicts, lists and
    tuples) within ``tol``."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close_trees(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close_trees(g, w, tol)
    else:
        close(got, want, tol)


class Pair:
    """The reduced model of ``arch`` in both packages, with JAX's weights
    (``init`` at key 0) in both."""

    def __init__(self, arch, **replace):
        jcfg = jconfigs.reduced(jconfigs.get_config(arch))
        cfg = configs.reduced(configs.get_config(arch))
        if replace:
            jcfg = dataclasses.replace(jcfg, **replace)
            cfg = dataclasses.replace(cfg, **replace)
        self.cfg, self.jcfg = cfg, jcfg
        self.jm = jbuild_model(jcfg)
        self.jp = self.jm.init(jax.random.key(0))
        self.jdecode = jax.jit(self.jm.decode_step,
                               static_argnames=("window", "ring",
                                                "moe_cap_len"))
        self.m = build_model(cfg, device="cpu")
        self.plain = registry.Model(cfg, use_kernels=False,
                                    device=torch.device("cpu"))
        self.p = load_jax_params(self.m.init(torch.Generator().manual_seed(1)),
                                 np_tree(self.jp))

    def inputs(self, B, S, seed, patches=True):
        """(JAX inputs, port inputs): tokens, and the VLM's patches (where
        ``patches``) or the encoder-decoder's frames, drawn from ``seed``."""
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        tin = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
        if cfg.family == "vlm" and patches:
            tin["patches"] = rng.normal(
                size=(B, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)
        if cfg.is_encoder_decoder:
            tin["frames"] = rng.normal(
                size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        jin = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
               for k, v in tin.items()}
        return jin, tin


_PAIRS = {}


def pair_of(arch):
    """The Pair of ``arch``, built once a process."""
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


def serve_logits_match_the_reference(arch, monkeypatch, gen=5, prompt=5):
    """The port's serving launcher against the reference's
    (``src/repro/launch/serve.py``), both on the reduced ``arch`` with
    JAX's weights: the logits of every decode step at 5e-4, and the
    generated tokens equal."""
    args = types.SimpleNamespace(arch=arch, reduced=True, batch=2,
                                 prompt_len=prompt, gen=gen, seed=0,
                                 device="cpu")
    jm = jbuild_model(jconfigs.reduced(jconfigs.get_config(arch)))
    jp = jm.init(jax.random.key(args.seed))

    want = []

    def recording_jit(fn):
        jitted = jax.jit(fn)

        def call(*a):
            logits, caches = jitted(*a)
            want.append(np.asarray(logits))
            return logits, caches
        return call

    with monkeypatch.context() as mp:
        mp.setattr(jserve, "jax", types.SimpleNamespace(random=jax.random,
                                                        jit=recording_jit))
        jgen = jserve.serve(args)

    seen = []
    step = registry.Model.decode_step

    def recording(self, *a, **kw):
        logits, caches = step(self, *a, **kw)
        seen.append(logits.numpy().copy())
        return logits, caches

    monkeypatch.setattr(registry.Model, "decode_step", recording)
    params = load_jax_params(
        build_model(configs.reduced(configs.get_config(arch)),
                    device="cpu").init(torch.Generator().manual_seed(0)),
        np_tree(jp))
    got = serve.serve(args, params=params)
    assert len(seen) == len(want) == args.prompt_len + args.gen - 1
    for g, w in zip(seen, want):
        np.testing.assert_allclose(g, w, **CHAIN_TOL)
    np.testing.assert_array_equal(got, np.asarray(jgen))
    assert got.shape == (2, gen)
