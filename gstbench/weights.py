"""The benchmark's seeded weights, table and draws, made on the device.

Every leaf of the port's parameter tree (``models/transformer.py``
``init_params`` for the dense family: stacked layers, ``runs.0.*``) is
drawn by its own ``torch.Generator`` on the device, seeded from the run's
seed and the leaf's place, so one large call makes a leaf and any leaf can
be made again alone (the check regenerates the starting weights after the
program has trained them in place).  The laws are the port's: a
truncated normal at +-2 sigma over the fan-in for a matmul weight (the
output projections over their own fan-in), N(0, 0.02^2) embeddings, unit
norm scales, zero biases.  The program and the reference get the same
tensors; neither makes its own.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

MASK64 = (1 << 64) - 1


def mix(seed: int, tag: int) -> int:
    """A 63-bit generator seed from (seed, tag): splitmix64 of both."""
    z = (seed * 0x9E3779B97F4A7C15 + tag * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) >> 1


def generator(device, seed: int, tag: int) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(mix(seed, tag))


class Leaf(NamedTuple):
    name: str                 # dotted path in the port's tree
    shape: Tuple[int, ...]
    law: str                  # "dense" | "embed" | "ones" | "zeros"
    scale: float


def backbone_leaves(arch: dict) -> List[Leaf]:
    """The dense model's leaves in the port's order (``flatten_tree`` of
    ``transformer.init_params``)."""
    d, L, V = arch["d_model"], arch["num_layers"], arch["vocab_size"]
    h, kv, hd, f = (arch["num_heads"], arch["num_kv_heads"],
                    arch["head_dim"], arch["d_ff"])
    rms = arch["norm"] == "rmsnorm"
    out = [Leaf("embed", (V, d), "embed", 0.02)]
    norm = lambda n: [Leaf(f"runs.0.{n}.scale", (L, d), "ones", 1.0)] if rms \
        else []
    out += norm("norm1")
    out += [Leaf("runs.0.attn.wq", (L, d, h * hd), "dense", d ** -0.5),
            Leaf("runs.0.attn.wk", (L, d, kv * hd), "dense", d ** -0.5),
            Leaf("runs.0.attn.wv", (L, d, kv * hd), "dense", d ** -0.5),
            Leaf("runs.0.attn.wo", (L, h * hd, d), "dense", (h * hd) ** -0.5)]
    out += norm("norm2")
    out += [Leaf("runs.0.mlp.w_in", (L, d, f), "dense", d ** -0.5),
            Leaf("runs.0.mlp.w_gate", (L, d, f), "dense", d ** -0.5),
            Leaf("runs.0.mlp.w_out", (L, f, d), "dense", f ** -0.5)]
    if rms:
        out.append(Leaf("final_norm.scale", (d,), "ones", 1.0))
    if not arch["tie_embeddings"]:
        out.append(Leaf("lm_head", (d, V), "dense", d ** -0.5))
    return out


def head_leaves(arch: dict, n_classes: int) -> List[Leaf]:
    d = arch["d_model"]
    return [Leaf("head.w1", (d, d), "dense", d ** -0.5),
            Leaf("head.b1", (d,), "zeros", 0.0),
            Leaf("head.w2", (d, n_classes), "dense", d ** -0.5),
            Leaf("head.b2", (n_classes,), "zeros", 0.0)]


def make_leaf(leaf: Leaf, seed: int, tag: int, device) -> torch.Tensor:
    """One leaf, f32, drawn on ``device`` in one call."""
    if leaf.law == "ones":
        return torch.ones(leaf.shape, device=device)
    if leaf.law == "zeros":
        return torch.zeros(leaf.shape, device=device)
    w = torch.empty(leaf.shape, device=device)
    gen = generator(device, seed, tag)
    if leaf.law == "embed":
        return w.normal_(0.0, 1.0, generator=gen).mul_(leaf.scale)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(leaf.scale)


# tags: a leaf's index in its list, offset by the list's base
BACKBONE_TAG, HEAD_TAG, TABLE_TAG, DRAWS_TAG = 1_000, 2_000, 3_000, 4_000


def backbone_leaf(arch: dict, seed: int, name: str, device) -> torch.Tensor:
    """The backbone leaf ``name`` as the run made it."""
    for i, leaf in enumerate(backbone_leaves(arch)):
        if leaf.name == name:
            return make_leaf(leaf, seed, BACKBONE_TAG + i, device)
    raise KeyError(name)


def backbone(arch: dict, seed: int, device) -> dict:
    """The whole backbone tree, in the port's nesting and order (empty
    dicts for the non-parametric norms)."""
    flat = {leaf.name: make_leaf(leaf, seed, BACKBONE_TAG + i, device)
            for i, leaf in enumerate(backbone_leaves(arch))}

    def group(prefix, keys):
        return {k: flat[f"{prefix}.{k}"] for k in keys
                if f"{prefix}.{k}" in flat}

    run = {"norm1": group("runs.0.norm1", ["scale"]),
           "attn": group("runs.0.attn", ["wq", "wk", "wv", "wo"]),
           "norm2": group("runs.0.norm2", ["scale"]),
           "mlp": group("runs.0.mlp", ["w_in", "w_gate", "w_out"])}
    tree = {"embed": flat["embed"], "runs": [run],
            "final_norm": group("final_norm", ["scale"])}
    if "lm_head" in flat:
        tree["lm_head"] = flat["lm_head"]
    return tree


def head(arch: dict, n_classes: int, seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """w1, b1, w2, b2 of the MLP head."""
    return {leaf.name.split(".")[1]: make_leaf(leaf, seed, HEAD_TAG + i,
                                               device)
            for i, leaf in enumerate(head_leaves(arch, n_classes))}


def table(n_rows: int, j: int, d: int, std: float, seed: int, device
          ) -> torch.Tensor:
    """Stale segment embeddings (n_rows, J, d), N(0, std^2), as a table
    that a first epoch has filled."""
    w = torch.empty((n_rows, j, d), device=device)
    return w.normal_(0.0, std, generator=generator(device, seed, TABLE_TAG))


def train_draws(seed: int, step: int, batch: int, j: int, sampled: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``step``'s GST draws: the sampled segments (B, S), distinct in
    a row, and the SED uniforms (B, J)."""
    gen = generator(device, seed, DRAWS_TAG + step)
    idx = torch.argsort(torch.rand((batch, j), generator=gen, device=device),
                        dim=1)[:, :sampled]
    u = torch.rand((batch, j), generator=gen, device=device)
    return idx, u
