"""Checkpoints of nested tensor structures, and of an embedding store.

Counterpart of ``src/repro/checkpoint/io.py:31-117``.  Layout:
``<dir>/step_<N>.ckpt`` (N zero-padded to 8 digits), a ``torch.save`` of
``{"step": N, "arrays": {path: CPU tensor}}``: the structure flattened to
"/"-joined paths of dict keys, sequence indices and NamedTuple field
names.  Plain tensors only, so ``torch.load(..., weights_only=True)``
reads it back (the reference's msgpack is not a dependency of the port).
``save_checkpoint`` keeps the newest ``keep`` files of the directory.
``load_checkpoint`` rebuilds the structure of ``like``, each leaf as the
type ``like`` holds there (tensor, numpy array or Python number); placing
tensors on a device is the caller's job.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.embedding_table import EmbeddingTable

_CKPT = re.compile(r"step_\d+\.ckpt$")


def _items(tree):
    """(key, child) pairs of a dict, NamedTuple, list or tuple; None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix="", out=None) -> dict:
    out = {} if out is None else out
    items = _items(tree)
    if items is None:
        if isinstance(tree, torch.Tensor):
            leaf = tree.detach().cpu().clone()
        else:
            leaf = torch.as_tensor(np.asarray(tree)).clone()
        out[prefix] = leaf
        return out
    for key, child in items:
        _flatten(child, f"{prefix}/{key}" if prefix else key, out)
    return out


def _rebuild(like, arrays, prefix=""):
    items = _items(like)
    if items is None:
        if prefix not in arrays:
            raise KeyError(f"checkpoint missing {prefix}")
        t = arrays[prefix]
        if isinstance(like, torch.Tensor):
            return t.to(like.dtype)
        if isinstance(like, np.ndarray):
            return t.numpy().astype(like.dtype, copy=False)
        return type(like)(t.item())
    kids = [_rebuild(c, arrays, f"{prefix}/{k}" if prefix else k)
            for k, c in items]
    if isinstance(like, dict):
        return type(like)(zip(like.keys(), kids))
    if hasattr(like, "_fields"):
        return type(like)(*kids)
    return type(like)(kids)


def _checkpoints(path_dir: str):
    return sorted(f for f in os.listdir(path_dir) if _CKPT.match(f))


def save_checkpoint(path_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"step_{step:08d}.ckpt")
    tmp = path + ".tmp"
    torch.save({"step": int(step), "arrays": _flatten(tree)}, tmp)
    os.replace(tmp, path)
    for old in _checkpoints(path_dir)[:-keep]:
        os.remove(os.path.join(path_dir, old))
    return path


def latest_checkpoint(path_dir: str) -> Optional[str]:
    if not os.path.isdir(path_dir):
        return None
    ckpts = _checkpoints(path_dir)
    return os.path.join(path_dir, ckpts[-1]) if ckpts else None


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (paths must match)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return _rebuild(like, blob["arrays"])


# ---------------------------------------------------------------------------
# embedding-store checkpoints: the historical table's rows, ages and init
# flags over BOTH tiers, so a capped run resumes
# ---------------------------------------------------------------------------


def save_store_checkpoint(path_dir: str, step: int, store, tables,
                          extra: Any = None, keep: int = 3) -> str:
    """Checkpoint an EmbeddingStore's whole logical table.

    ``store.snapshot(tables)`` merges the device tier into the host tier
    (flushing pending write-backs first), so the file holds the dense
    (n_rows, J, d) embeddings, ages and initialized flags whatever the
    backend and wherever the rows were.  ``extra``: an optional dict saved
    beside it (parameters, optimizer state ...); "table" is reserved."""
    extra = dict(extra or {})
    if "table" in extra:
        raise ValueError('"table" is reserved for the store snapshot')
    snap = store.snapshot(tables)
    return save_checkpoint(path_dir, step, {"table": snap._asdict(), **extra},
                           keep=keep)


def load_store_checkpoint(path: str, store, extra_like: Any = None):
    """Restore a ``save_store_checkpoint`` file into ``store``.

    Returns ``(tables, extra)``: ``store.restore``'s device tables (a list,
    one a local shard) and the extra dict rebuilt after ``extra_like``.
    Residency is reset: a TieredStore restarts with every row in the host
    tier and re-faults on demand, which is not semantic state, so training
    resumes bitwise either way."""
    extra_like = dict(extra_like or {})
    like_table = {
        "emb": torch.zeros(store.n_rows, store.j_max, store.d_h,
                           dtype=store.dtype),
        "age": torch.zeros(store.n_rows, store.j_max, dtype=torch.int32),
        "initialized": torch.zeros(store.n_rows, store.j_max,
                                   dtype=torch.bool),
    }
    tree = load_checkpoint(path, {"table": like_table, **extra_like})
    snap = EmbeddingTable(**tree["table"])
    return store.restore(snap), {k: tree[k] for k in extra_like}
