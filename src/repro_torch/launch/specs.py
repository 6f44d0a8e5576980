"""Per-(architecture × input-shape) step functions, argument specs and
shardings of the dry run.

Counterpart of ``src/repro/launch/specs.py``:

train_4k    the **GST+EFD train step** (the paper's technique, §3) of the
            sequence track (``core/gst.py``, ``optim/adamw.py``):
            sampled-segment backprop + historical-table lookup + SED +
            table write-back + AdamW update, with the reference's head,
            loss, pooling and AdamW settings;
prefill_32k ``Model.prefill`` (full forward, emits the caches);
decode_32k  ``Model.decode_step`` (1 token, cache of seq_len);
long_500k   ``decode_step`` with the long-context plan per family: SSM
            state / ring-buffer sliding window / full (seq-sharded) latent
            cache for MLA.

Where the reference builds ``ShapeDtypeStruct``s with ``jax.eval_shape``,
the port's argument specs are :class:`TensorSpec` records and its
parameter shapes a tree of meta tensors (:func:`param_shapes`): nothing is
allocated for a full-size config.  :func:`materialize` turns a step's
specs into ``DTensor`` arguments on a mesh, with the placements of
``launch/sharding.py``: fake tensors inside a ``FakeTensorMode`` (the dry
run), or given values (a real step on a small mesh).

The steps differ from the reference's in two ways, both forced: the
models run their kernels' plain versions (a hand-written kernel launches
through ctypes and cannot run on a fake tensor), and the train step takes
its draws as inputs (``draws``: the sampled segments (B, S) and the SED
uniforms (B, J)), where the reference draws them inside from ``seed``: a
fake tensor has no random bits.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape
from repro_torch.core import embedding_table as tbl
from repro_torch.core import gst as G
from repro_torch.core.embedding_table import EmbeddingTable
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import dtensor_mesh, fsdp_axes
from repro_torch.models import encdec, transformer
from repro_torch.models.common import ParamTree
from repro_torch.models.registry import Model
from repro_torch.optim import make_optimizer


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _f(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(s) for s in shape), dtype)


# ---------------------------------------------------------------------------
# long-context decode plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecodePlan:
    cache_len: int
    window: int = 0
    ring: bool = False
    seq_shard: bool = False   # shard cache sequence dim over fsdp axes (B=1)


def decode_plan(cfg: ArchConfig, shape: InputShape) -> DecodePlan:
    if shape.name != "long_500k":
        return DecodePlan(cache_len=shape.seq_len)
    if cfg.family == "ssm":
        return DecodePlan(cache_len=1)  # recurrent state only
    if cfg.use_mla:
        # DeepSeek MLA: the compressed latent cache IS the long-context
        # feature — keep the full 524k latent, sequence-sharded over data.
        return DecodePlan(cache_len=shape.seq_len, seq_shard=True)
    if cfg.name == "arctic-480b":
        # GQA kv=8 @ 524k fits when sequence-sharded
        return DecodePlan(cache_len=shape.seq_len, seq_shard=True)
    # dense / vlm / hybrid: ring-buffer sliding window (sub-quadratic variant)
    return DecodePlan(cache_len=cfg.sliding_window, window=cfg.sliding_window,
                      ring=True)


# ---------------------------------------------------------------------------
# GST segmentation of the train shape, input specs
# ---------------------------------------------------------------------------


def gst_geometry(cfg: ArchConfig, shape: InputShape) -> Tuple[int, int]:
    """(J segments, segment length) for the train shape."""
    J = cfg.gst_num_segments
    if shape.seq_len % J:
        raise ValueError(f"{shape.name}: seq_len {shape.seq_len} does not "
                         f"split into {J} segments")
    return J, shape.seq_len // J


def seg_input_specs(cfg: ArchConfig, B: int, J: int, L: int, dtype):
    """One GST batch's segment inputs."""
    spec: Dict[str, Any] = {"tokens": _f((B, J, L), torch.int32)}
    if cfg.family == "vlm":
        spec["patches"] = _f((B, J, cfg.vision_prefix_len, cfg.d_model),
                             dtype)
    if cfg.is_encoder_decoder:
        spec = {"frames": _f((B, J, L, cfg.d_model), dtype)}  # audio: frames
    return spec


def serve_input_specs(cfg: ArchConfig, B: int, S: int, dtype):
    spec: Dict[str, Any] = {"tokens": _f((B, S), torch.int32)}
    if cfg.family == "vlm":
        spec["patches"] = _f((B, cfg.vision_prefix_len, cfg.d_model), dtype)
    if cfg.is_encoder_decoder:
        spec["frames"] = _f((B, cfg.encoder_seq_len, cfg.d_model), dtype)
    return spec


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(cfg: ArchConfig, shape_name, *, dtype=torch.bfloat16):
    """:class:`TensorSpec` stand-ins for every model input of this shape
    (a name of ``INPUT_SHAPES`` or an ``InputShape``)."""
    shape = _shape(shape_name)
    if shape.kind == "train":
        J, L = gst_geometry(cfg, shape)
        return {
            "seg_inputs": seg_input_specs(cfg, shape.global_batch, J, L,
                                          dtype),
            "seg_valid": _f((shape.global_batch, J), torch.float32),
            "graph_ids": _f((shape.global_batch,), torch.int32),
            "labels": _f((shape.global_batch,), torch.int32),
        }
    if shape.kind == "prefill":
        return serve_input_specs(cfg, shape.global_batch, shape.seq_len,
                                 dtype)
    plan = decode_plan(cfg, shape)
    return {
        "token": _f((shape.global_batch, 1), torch.int32),
        "cache_pos": _f((shape.global_batch,), torch.int32),
        "cache_len": plan.cache_len,
    }


# ---------------------------------------------------------------------------
# parameter shapes: the models' init on the meta device
# ---------------------------------------------------------------------------


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is meta: the models' init draws
    onto its generator's device, and a draw on a meta tensor is a no-op,
    so ``init`` gives the parameter tree's shapes and allocates nothing."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16):
    """The model's parameter tree as meta tensors (``jax.eval_shape`` of
    the reference's ``model.init``)."""
    init = encdec.init_params if cfg.is_encoder_decoder else \
        transformer.init_params
    return init(_MetaGenerator("cpu"), cfg, dtype)


def head_shapes(d_h: int, num_out: int, dtype=torch.bfloat16):
    """The 'mlp' graph head F' (``core/gst.py::Head``) as a tree of specs."""
    return {"w1": _f((d_h, d_h), dtype), "b1": _f((d_h,), dtype),
            "w2": _f((d_h, num_out), dtype), "b2": _f((num_out,), dtype)}


def module_order(tree):
    """The leaves of a parameter tree in ``ParamTree(tree).parameters()``'s
    order (each node's own leaves, then its subtrees), as (path, leaf)."""
    items = list(tree.items()) if isinstance(tree, dict) else \
        [(str(i), v) for i, v in enumerate(tree)]
    own = [(k, v) for k, v in items if _is_leaf(v)]
    kids = [(k, v) for k, v in items if not _is_leaf(v)]
    out = list(own)
    for k, v in kids:
        out += [(f"{k}/{p}", leaf) for p, leaf in module_order(v)]
    return out


# ---------------------------------------------------------------------------
# step specs
# ---------------------------------------------------------------------------


@dataclass
class StepSpec:
    """A step, its argument specs and their shardings.

    ``args``: trees of :class:`TensorSpec` (or meta tensors) and Python
    scalars; ``shardings``: the same trees with a spec (a tuple, see
    ``launch/sharding.py``) at each tensor leaf; ``params``: the model's
    parameter shapes (the roofline's parameter count)."""
    name: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]
    shardings: Tuple[Any, ...]
    params: Any


# ---------------------------------------------------------------------------
# the row-sharded table: owner-computes reads and writes
# ---------------------------------------------------------------------------


def _full(x):
    """A DTensor's whole value on every device (an all-gather); a plain
    tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _local_rows(plane: DTensor):
    """(this device's shard of a row-sharded table plane, its first row):
    rows split evenly over the mesh dims that shard them, in mesh order."""
    local = plane.to_local()
    mesh, coord = plane.device_mesh, plane.device_mesh.get_coordinate()
    block = 0
    for d, p in enumerate(plane.placements):
        if isinstance(p, Shard) and p.dim == 0:
            block = block * mesh.size(d) + coord[d]
    return local, block * local.shape[0]


def sharded_lookup(table: EmbeddingTable, graph_ids):
    """``tbl.lookup`` of a table whose rows are sharded over the mesh: each
    device reads the rows it owns (zero elsewhere) and the partial reads
    are summed onto the batch's placement (GSPMD's gather from a sharded
    operand).  A plain table is ``tbl.lookup``'s."""
    if not isinstance(table.emb, DTensor):
        return tbl.lookup(table, graph_ids)
    mesh = table.emb.device_mesh
    ids = _full(graph_ids).long()
    emb_l, off = _local_rows(table.emb)
    init_l, _ = _local_rows(table.initialized)
    local = ids - off
    mask = (local >= 0) & (local < emb_l.shape[0])
    rows = local.clamp(0, emb_l.shape[0] - 1)
    emb = emb_l[rows] * mask[:, None, None].to(emb_l.dtype)
    init = (init_l[rows] & mask[:, None]).to(torch.int32)
    partial = [Partial() if isinstance(p, Shard) else Replicate()
               for p in table.emb.placements]
    want = (graph_ids.placements if isinstance(graph_ids, DTensor)
            else [Replicate()] * mesh.ndim)
    emb = DTensor.from_local(emb, mesh, partial).redistribute(mesh, want)
    init = DTensor.from_local(init, mesh, partial).redistribute(mesh, want)
    return emb, init > 0


def _owner_write(plane: torch.Tensor, rows, seg, vals) -> None:
    """plane[rows, seg] = vals for the rows this shard holds (``rows``
    local, out-of-range ones skipped), in place.  Shapes do not depend on
    the data: an out-of-range write repeats the first in-range one (or, if
    none is, writes a slot's own value back), so no two writes to one slot
    disagree."""
    n = plane.shape[0]
    mask = (rows >= 0) & (rows < n)
    k = torch.argmax(mask.to(torch.int32)).reshape(1)   # no host sync
    r = torch.where(mask, rows, rows.index_select(0, k)).clamp(0, n - 1)
    s = torch.where(mask, seg, seg.index_select(0, k))
    cur = plane[r, s]
    trail = (1,) * (vals.dim() - 1)
    fill = torch.where(mask.index_select(0, k).reshape((1,) + trail),
                       vals.index_select(0, k), cur.index_select(0, k))
    keep = mask.reshape(mask.shape + trail)
    plane.index_put_((r, s), torch.where(keep, vals, fill))


@torch.no_grad()
def sharded_update_sampled(table: EmbeddingTable, graph_ids, seg_idx, h_new,
                           step: int) -> EmbeddingTable:
    """``tbl.update_sampled`` of a table whose rows are sharded over the
    mesh: every device takes the batch's writes (an all-gather) and makes
    those to the rows it owns (owner computes, as the distributed
    exchange's shards do).  A plain table is ``tbl.update_sampled``'s."""
    if not isinstance(table.emb, DTensor):
        return tbl.update_sampled(table, graph_ids, seg_idx, h_new, step)
    ids, seg = _full(graph_ids).long(), _full(seg_idx).long()
    h = _full(h_new)
    rows = ids[:, None].expand(seg.shape).reshape(-1)
    seg = seg.reshape(-1)
    h = h.reshape((-1,) + tuple(h.shape[2:]))
    for plane, vals in ((table.emb, h.to(table.emb.dtype)),
                        (table.age, torch.full(rows.shape, step,
                                               dtype=table.age.dtype,
                                               device=rows.device)),
                        (table.initialized, torch.ones(
                            rows.shape, dtype=torch.bool,
                            device=rows.device))):
        local, off = _local_rows(plane)
        _owner_write(local, rows - off, seg, vals)
    return table


def unshard_fsdp(tree, whole_embed: bool = True):
    """The parameters as the step computes with them: each ``DTensor``
    gathered over the FSDP axes ('pod', 'data'), its 'model' sharding
    kept, as FSDP does (an all-gather before use; autograd's reverse is a
    reduce-scatter of the gradient back to the stored placement).  Left
    sharded, DTensor's propagation would rather shard the activations'
    feature axis over 'data' than the batch.  With ``whole_embed`` (a
    step that trains) the token embedding, which a lookup reads by row,
    is gathered whole: a lookup into a vocab-sharded table gives a masked
    partial sum whose gradient the card's DTensor (torch 2.11) cannot
    carry back.  A serving step keeps its vocab shard, so a tied LM head
    (``hidden @ embed.T``) is column-parallel as an untied one.  Plain
    tensors as they are."""
    def one(path, t):
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        whole = whole_embed and re.search(r"(^|/)embed$", path) is not None
        fsdp = fsdp_axes(mesh)
        want = [Replicate() if whole or name in fsdp else p
                for name, p in zip(mesh.mesh_dim_names, t.placements)]
        return t.redistribute(mesh, want)
    return SH._tree_map_with_path(one, tree)


def _model(cfg: ArchConfig, device) -> Model:
    # the dry run's tensors are fake, so a cuda model needs no card here
    return Model(cfg, use_kernels=False, device=torch.device(device))


def build_train_spec(cfg: ArchConfig, shape: InputShape, mesh, *,
                     dtype=torch.bfloat16, variant: str = "gst_efd",
                     device="cuda", overrides=()) -> StepSpec:
    model = _model(cfg, device)
    B = shape.global_batch
    J, L = gst_geometry(cfg, shape)
    S = cfg.gst_backprop_segments
    d_h = cfg.d_model
    n_table = max(cfg.gst_table_size, B)

    opt = make_optimizer("adamw", lr=1e-4, weight_decay=0.01,
                         max_grad_norm=1.0)

    def encode(backbone, seg_inputs):
        return model.encode_segment(unshard_fsdp(backbone.tree), seg_inputs)

    gst_step = G.make_train_step(
        encode, opt, G.VARIANTS[variant], num_sampled=S,
        keep_prob=cfg.gst_keep_prob, head_mode="mlp", loss_kind="ce",
        agg="mean", table_lookup=sharded_lookup,
        table_update=sharded_update_sampled)

    def train_step(state, batch, draws):
        st = G.TrainState(ParamTree(state["backbone"]),
                          ParamTree(state["head"]),
                          {"step": state["step"], "mu": state["mu"],
                           "nu": state["nu"]},
                          state["table"], state["step"])
        st, metrics = gst_step(st, G.GSTBatch(**batch), draws=draws)
        return st, metrics

    backbone = param_shapes(cfg, dtype)
    head = head_shapes(d_h, cfg.gst_num_classes, dtype)
    bb_sh = SH.tree_shardings(mesh, backbone, overrides)
    head_sh = SH.tree_shardings(mesh, head, overrides)
    # AdamW's f32 moments, in the step's parameter order, sharded as their
    # parameters (the reference's tree_shardings of mu and nu)
    order = module_order(backbone) + module_order(head)
    moments = [_f(leaf.shape, torch.float32) for _, leaf in order]
    moment_sh = [SH.spec_for_path(mesh, p, tuple(leaf.shape), overrides)
                 for p, leaf in order]
    table = EmbeddingTable(emb=_f((n_table, J, d_h), dtype),
                           age=_f((n_table, J), torch.int32),
                           initialized=_f((n_table, J), torch.bool))
    state = {"backbone": backbone, "head": head, "mu": moments,
             "nu": list(moments), "table": table, "step": 0}
    state_sh = {"backbone": bb_sh, "head": head_sh, "mu": moment_sh,
                "nu": list(moment_sh),
                "table": SH.table_sharding(mesh, table), "step": None}
    batch = {"seg_inputs": seg_input_specs(cfg, B, J, L, dtype),
             "seg_valid": _f((B, J), torch.float32),
             "graph_ids": _f((B,), torch.int32),
             "labels": _f((B,), torch.int32)}
    batch_sh = {"seg_inputs": SH.batch_sharding(mesh, batch["seg_inputs"]),
                "seg_valid": SH.batch_spec(mesh, B, 2),
                "graph_ids": SH.batch_spec(mesh, B, 1),
                "labels": SH.batch_spec(mesh, B, 1)}
    draws = (_f((B, S), torch.int64), _f((B, J), torch.float32))
    draws_sh = (SH.batch_spec(mesh, B, 2), SH.batch_spec(mesh, B, 2))
    return StepSpec(name=f"{cfg.name}:{shape.name}:{variant}", kind="train",
                    fn=train_step, args=(state, batch, draws),
                    shardings=(state_sh, batch_sh, draws_sh),
                    params=backbone)


def build_prefill_spec(cfg: ArchConfig, shape: InputShape, mesh, *,
                       dtype=torch.bfloat16, device="cuda",
                       overrides=()) -> StepSpec:
    model = _model(cfg, device)
    B, S = shape.global_batch, shape.seq_len

    def prefill_step(params, inputs):
        return model.prefill(unshard_fsdp(params, whole_embed=False), inputs)

    params = param_shapes(cfg, dtype)
    inputs = serve_input_specs(cfg, B, S, dtype)
    return StepSpec(name=f"{cfg.name}:{shape.name}", kind="prefill",
                    fn=prefill_step, args=(params, inputs),
                    shardings=(SH.tree_shardings(mesh, params, overrides),
                               SH.batch_sharding(mesh, inputs)),
                    params=params)


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int, dtype):
    """A decode step's caches as meta tensors; the encoder-decoder's are
    {"self": its self-attention cache, "cross": (k, v)}, as the
    reference's dry run lays them out."""
    caches = _model(cfg, "meta").init_cache(batch, cache_len, dtype)
    if cfg.is_encoder_decoder:
        hd = cfg.resolved_head_dim
        xkv = _f((cfg.num_layers, batch, cfg.encoder_seq_len,
                  cfg.num_kv_heads, hd), dtype)
        caches = {"self": caches, "cross": (xkv, xkv)}
    return caches


def build_decode_spec(cfg: ArchConfig, shape: InputShape, mesh, *,
                      dtype=torch.bfloat16, device="cuda",
                      overrides=()) -> StepSpec:
    model = _model(cfg, device)
    B = shape.global_batch
    plan = decode_plan(cfg, shape)

    def decode_step(params, token, caches, cache_pos):
        return model.decode_step(unshard_fsdp(params, whole_embed=False),
                                 token, caches, cache_pos,
                                 window=plan.window, ring=plan.ring)

    params = param_shapes(cfg, dtype)
    caches = cache_shapes(cfg, B, plan.cache_len, dtype)
    return StepSpec(
        name=f"{cfg.name}:{shape.name}", kind="decode", fn=decode_step,
        args=(params, _f((B, 1), torch.int32), caches,
              _f((B,), torch.int32)),
        shardings=(SH.tree_shardings(mesh, params, overrides),
                   SH.batch_spec(mesh, B, 2),
                   SH.cache_sharding(mesh, caches, seq_shard=plan.seq_shard),
                   SH.batch_spec(mesh, B, 1)),
        params=params)


def build_step_spec(cfg: ArchConfig, shape, mesh, *, dtype=torch.bfloat16,
                    variant: str = "gst_efd", device="cuda",
                    overrides=()) -> StepSpec:
    """The step of ``shape`` (a name of ``INPUT_SHAPES`` or an
    ``InputShape``); raises where the config skips the shape."""
    shape = _shape(shape)
    if not cfg.supports_shape(shape):
        raise ValueError(f"{cfg.name} skips {shape.name}")
    kw = dict(dtype=dtype, device=device, overrides=overrides)
    if shape.kind == "train":
        return build_train_spec(cfg, shape, mesh, variant=variant, **kw)
    if shape.kind == "prefill":
        return build_prefill_spec(cfg, shape, mesh, **kw)
    return build_decode_spec(cfg, shape, mesh, **kw)


# ---------------------------------------------------------------------------
# specs -> DTensor arguments
# ---------------------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, (TensorSpec, torch.Tensor))


def _map2(f, spec_tree, sh_tree, val_tree):
    if _is_leaf(spec_tree):
        return f(spec_tree, sh_tree, val_tree)
    if isinstance(spec_tree, dict):
        return {k: _map2(f, v, sh_tree[k], None if val_tree is None
                         else val_tree[k]) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        kids = [_map2(f, v, sh_tree[i], None if val_tree is None
                      else val_tree[i]) for i, v in enumerate(spec_tree)]
        return type(spec_tree)(*kids) if hasattr(spec_tree, "_fields") \
            else type(spec_tree)(kids)
    return spec_tree if val_tree is None else val_tree   # a Python scalar


def materialize(spec: StepSpec, mesh, device, values=None) -> tuple:
    """The step's arguments as ``DTensor``s on ``dtensor_mesh(mesh)`` (on
    a multi-pod mesh, 'pod' and 'data' flattened into one dim), each
    placed by its spec: new tensors of the specs' shapes on ``device``
    (fake ones inside a ``FakeTensorMode``; their contents are
    undefined), or ``values`` (the
    same trees of tensors) moved to ``device`` and distributed.  Floating
    parameters of the train step require grad through the step's own
    ``ParamTree``.  ``mesh`` None: the plain tensors, on one device."""
    dmesh = None if mesh is None else dtensor_mesh(mesh)

    def leaf(s, sh, v):
        if v is None:
            v = torch.empty(tuple(s.shape), dtype=s.dtype, device=device)
        else:
            v = v.to(device)
        if dmesh is None:
            return v
        return distribute_tensor(v, dmesh,
                                 SH.dtensor_placements(mesh, sh or ()))

    vals = values if values is not None else (None,) * len(spec.args)
    return tuple(_map2(leaf, a, sh, v)
                 for a, sh, v in zip(spec.args, spec.shardings, vals))
