"""Shared model components of the port: init helpers.

Counterpart of ``src/repro/models/common.py`` (``dense_init`` only, so far),
plus the carry-over of parameters initialised by the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def dense_init(d_in: int, d_out: int, generator: torch.Generator,
               dtype=torch.float32, scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init, matmul weight (d_in, d_out): a standard
    normal cut at ±2σ, times 1/√d_in.  Drawn on the CPU from ``generator``,
    so one seed gives the same weights whatever device they go to."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.empty(d_in, d_out, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def flatten_tree(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict/list tree — the JAX
    package's parameter pytrees as nn.Module parameter names
    (``{"mp": [{"prelu": {"a": ...}}]}`` -> ``"mp.0.prelu.a"``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_tree(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_tree(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def load_jax_params(module: torch.nn.Module, np_tree) -> torch.nn.Module:
    """Fill ``module``'s parameters from the JAX package's parameter tree
    (nested dicts and lists of numpy arrays), matched by path name.  The
    weight carry-over the parity tests use.  Raises when the names or the
    shapes of the two disagree; returns ``module``."""
    flat = dict(flatten_tree(np_tree))
    params = dict(module.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"parameter names differ: only in the tree "
                       f"{sorted(set(flat) - set(params))}, only in the "
                       f"module {sorted(set(params) - set(flat))}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree shape {arr.shape} != module "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
    return module
