"""Sharding rules: parameter-path patterns -> specs -> DTensor placements.

Counterpart of ``src/repro/launch/sharding.py``, with its rules copied
unchanged.  Scheme: FSDP over the ('pod','data') axes × tensor parallel
over 'model'.  Rules give a spec for the TRAILING dims of a leaf; leading
dims (the stacked layer axis, the expert axis handled explicitly) are
replicated by padding with None.  Every sharded dim is divisibility-checked
against the mesh axis size and falls back to replication when it does not
divide — head counts like 56 or 20 on a 16-way model axis replicate.

A spec is what the reference's ``PartitionSpec`` holds, as a tuple: one
entry a tensor dim, each None (replicated), a mesh axis name, or a tuple
of names (FSDP over ('pod', 'data')).  :func:`placements` turns it into
``DTensor`` placements, one a mesh dim: a tensor dim over two mesh dims is
``Shard`` on both, split pod-major as JAX splits it;
:func:`dtensor_placements` merges the two into the one flattened dim of
``launch/mesh.py::dtensor_mesh``, where the step's ``DTensor``s live (the
same shard on every device).  The reference's
override hook (the module global ``OVERRIDES``) is an argument here:
``overrides``, e.g. :func:`head_aligned_overrides`.  A tree is a nested
dict/list tree of tensors or shapes; its paths join keys with '/', as the
reference's ``_path_str`` does.
"""
from __future__ import annotations

import re
from typing import Any, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import fsdp_axes, mesh_sizes

# (regex over param path, trailing-dim logical spec)
# logical axes: "fsdp" -> ('pod','data'), "model" -> 'model', None -> replicate
_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"experts/w_(in|gate)$", ("model", "fsdp", None)),
    (r"experts/w_out$", ("model", None, "fsdp")),
    (r"router$", ("fsdp", "model")),
    (r"(^|/)embed$", ("model", "fsdp")),           # (vocab, d)
    (r"lm_head$", ("fsdp", "model")),              # (d, vocab)
    (r"conv_w$", (None, "model")),                 # (W, d_inner)
    # column-parallel projections (d_in, d_out): out dim over model
    (r"(wq|wk|wv|wg|wr|wq_a|wq_b|wkv_a|wk_b|wv_b|w_in|w_gate|w_msg|"
     r"w_gate_src|w_gate_dst|w_decay_a|mlp_in|w1)$", ("fsdp", "model")),
    # row-parallel projections (d_in, d_out): in dim over model
    (r"(wo|w_out|w_rec|w_decay_b|mlp_out|w2)$", ("model", "fsdp")),
)


def _axis_size(mesh, logical) -> int:
    if logical is None:
        return 1
    sizes = mesh_sizes(mesh)
    if logical == "fsdp":
        n = 1
        for a in fsdp_axes(mesh):
            n *= sizes[a]
        return n
    return sizes.get(logical, 1)


def _resolve(mesh, logical):
    if logical is None:
        return None
    if logical == "fsdp":
        ax = fsdp_axes(mesh)
        return ax if len(ax) > 1 else (ax[0] if ax else None)
    return logical if logical in mesh.mesh_dim_names else None


def head_aligned_overrides(cfg, mesh) -> list:
    """Rules checked before ``_RULES`` when a head count does not divide
    the model axis: the attention projections replicate over 'model' (the
    reference's head-aligned-sharding experiment)."""
    n_model = mesh_sizes(mesh).get("model", 1)
    o = []
    misaligned = (cfg.num_heads and cfg.num_heads % n_model) or \
                 (cfg.num_kv_heads and cfg.num_kv_heads % n_model)
    if misaligned:
        o.append((r"(wq|wq_b)$", ("fsdp", None)))
        o.append((r"(wk|wv)$", ("fsdp", None)))
        o.append((r"wo$", (None, "fsdp")))
    return o


def spec_for_path(mesh, path: str, shape: Tuple[int, ...],
                  overrides: Sequence = ()) -> tuple:
    for pat, trailing in list(overrides) + list(_RULES):
        if re.search(pat, path):
            trailing = trailing[-len(shape):] if len(shape) < len(trailing) \
                else trailing
            full = (None,) * (len(shape) - len(trailing)) + tuple(trailing)
            axes = []
            for dim, logical in zip(shape, full):
                if logical is not None and dim % _axis_size(mesh,
                                                            logical) == 0:
                    axes.append(_resolve(mesh, logical))
                else:
                    axes.append(None)
            return tuple(axes)
    return ()  # replicate (norm scales, biases, 1-D params)


def placements(mesh, spec: tuple) -> tuple:
    """A spec -> one ``Shard``/``Replicate`` a mesh dim.  A tensor dim over
    several mesh dims shards on each, the mesh's order first (pod-major).
    Over a mesh dim of one device a shard is the whole tensor: that dim
    says ``Replicate`` (the same layout; older DTensors refuse some views
    of a dim marked sharded, even over one device)."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if mesh.size(names.index(name)) > 1:
                out[names.index(name)] = Shard(dim)
    return tuple(out)


def dtensor_placements(mesh, spec: tuple) -> tuple:
    """A spec -> placements over ``dtensor_mesh(mesh)``: those of
    :func:`placements`, the 'pod' and 'data' dims merged into one (a
    tensor dim the two shard together, pod-major, is that dim's
    ``Shard``)."""
    out = placements(mesh, spec)
    names = list(mesh.mesh_dim_names)
    if "pod" not in names:
        return out
    i, j = names.index("pod"), names.index("data")
    a, b = out[i], out[j]
    if a != b and not (isinstance(a, Replicate) and mesh.size(i) == 1) \
            and not (isinstance(b, Replicate) and mesh.size(j) == 1):
        raise ValueError(f"{spec}: 'pod' and 'data' shard apart "
                         f"({a}, {b}); the flattened mesh cannot hold it")
    merged = b if isinstance(a, Replicate) else a
    return (merged,) + tuple(p for d, p in enumerate(out) if d not in (i, j))


def _tree_map_with_path(f, tree, prefix: str = ""):
    if hasattr(tree, "shape"):       # a tensor or a (shape, dtype) record
        return f(prefix, tree)
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(f, v, f"{prefix}/{k}" if prefix
                                       else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [_tree_map_with_path(f, v, f"{prefix}/{i}" if prefix
                                    else str(i)) for i, v in enumerate(tree)]
        # a NamedTuple (the table, a batch) takes its fields positionally
        return type(tree)(*kids) if hasattr(tree, "_fields") else \
            type(tree)(kids)
    return f(prefix, tree)


def tree_map(f, tree):
    """``f(leaf)`` over a nested dict/list tree."""
    return _tree_map_with_path(lambda _, leaf: f(leaf), tree)


def tree_shardings(mesh, tree_shapes: Any, overrides: Sequence = ()) -> Any:
    """A tree of tensors or shapes -> the same tree of specs, by rule."""
    return _tree_map_with_path(
        lambda path, leaf: spec_for_path(mesh, path, tuple(leaf.shape),
                                         overrides), tree_shapes)


# ---------------------------------------------------------------------------
# data / state shardings
# ---------------------------------------------------------------------------


def batch_spec(mesh, batch: int, ndim: int) -> tuple:
    """Shard leading batch dim over the fsdp axes when divisible."""
    n = _axis_size(mesh, "fsdp")
    lead = _resolve(mesh, "fsdp") if (n > 1 and batch % n == 0) else None
    return (lead,) + (None,) * (ndim - 1)


def batch_sharding(mesh, tree_shapes: Any) -> Any:
    return tree_map(lambda l: batch_spec(mesh, l.shape[0], len(l.shape)),
                    tree_shapes)


def table_sharding(mesh, table_shapes) -> Any:
    """Historical embedding table: graph-id rows over the fsdp axes."""
    return tree_map(lambda l: batch_spec(mesh, l.shape[0], len(l.shape)),
                    table_shapes)


def cache_spec(mesh, path: str, shape: Tuple[int, ...],
               seq_shard: bool = False) -> tuple:
    """KV/state caches, by leaf name; a leading stacked-layer axis is
    detected by ndim and always replicated:

        k/v    (L?, B, C, KV, hd) — batch over fsdp, KV heads over model
        ckv/kr (L?, B, C, r)      — batch over fsdp (latent replicated)
        conv   (L?, B, W-1, d_in) — batch over fsdp, channels over model
        ssm    (L?, B, H, P, N)   — batch over fsdp, heads over model
        state  (L?, B, H, N, N)   — batch over fsdp, heads over model
        shift* (L?, B, d)         — batch over fsdp

    ``seq_shard=True`` (long_500k, batch=1): shard the *sequence* dim of
    attention caches over the fsdp axes instead (sequence-parallel
    decode)."""
    n_fsdp = _axis_size(mesh, "fsdp")
    n_model = _axis_size(mesh, "model")
    fsdp = _resolve(mesh, "fsdp")
    model = _resolve(mesh, "model")
    name = path.rsplit("/", 1)[-1]
    ndim = len(shape)
    # (kind, base ndim without the stacked-layer axis)
    if name in ("k", "v") or (name not in ("ckv", "kr", "conv", "ssm", "state",
                                           "shift_tm", "shift_cm") and ndim >= 5):
        kind, base = "kv", 4
    elif name in ("ckv", "kr"):
        kind, base = "latent", 3
    elif name == "conv":
        kind, base = "conv", 3
    elif name in ("ssm", "state"):
        kind, base = "heads", 4
    elif name in ("shift_tm", "shift_cm"):
        kind, base = "shift", 2
    else:
        kind, base = "other", ndim
    off = ndim - base  # 1 if a stacked-layer axis leads, else 0
    axes: list = [None] * ndim
    if off < 0 or off > 1:
        return tuple(axes)
    b_i = off  # batch dim index
    if kind == "kv":
        seq_i, kv_i = off + 1, off + 2
        if seq_shard:
            if shape[seq_i] % n_fsdp == 0:
                axes[seq_i] = fsdp
        elif n_fsdp > 1 and shape[b_i] % n_fsdp == 0:
            axes[b_i] = fsdp
        if shape[kv_i] % n_model == 0:
            axes[kv_i] = model
    elif kind == "latent":
        seq_i = off + 1
        if seq_shard:
            if shape[seq_i] % n_fsdp == 0:
                axes[seq_i] = fsdp
        elif n_fsdp > 1 and shape[b_i] % n_fsdp == 0:
            axes[b_i] = fsdp
    elif kind == "conv":
        if n_fsdp > 1 and shape[b_i] % n_fsdp == 0:
            axes[b_i] = fsdp
        if shape[off + 2] % n_model == 0:
            axes[off + 2] = model
    elif kind == "heads":
        if n_fsdp > 1 and shape[b_i] % n_fsdp == 0:
            axes[b_i] = fsdp
        if shape[off + 1] % n_model == 0:
            axes[off + 1] = model
    elif kind == "shift":
        if n_fsdp > 1 and shape[b_i] % n_fsdp == 0:
            axes[b_i] = fsdp
    return tuple(axes)


def cache_sharding(mesh, cache_shapes, *, seq_shard: bool = False):
    return _tree_map_with_path(
        lambda path, leaf: cache_spec(mesh, path, tuple(leaf.shape),
                                      seq_shard), cache_shapes)


def replicated(mesh, tree_shapes: Any) -> Any:
    return tree_map(lambda l: (), tree_shapes)

