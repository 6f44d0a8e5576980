"""Production-mesh dry run: every (architecture × input shape × mesh)
step traced sharded on the production mesh, with its roofline terms.

Counterpart of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each step with XLA on 512 forced host devices and reads the
compiled module.  The port asks the same question ("does every step run
sharded on the production mesh, and what does it cost a device?") its own
way: a ``DeviceMesh`` over a fake process group of 256 or 512 ranks
(``launch/mesh.py``), the parameters, optimizer state, table, batch and
caches as ``DTensor``s placed by the reference's rules
(``launch/sharding.py``, ``launch/specs.py``), and one step traced on
fake tensors, nothing allocated, under ``roofline/analysis.py``'s counter.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch internlm2-1.8b --shape all --mesh single --out dry.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh both --out build/dryrun_single.json
    # the tests' small meshes and reduced configs trace fake CPU tensors
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu ...

A row carries the reference's keys, with ``trace_s`` in place of
``lower_s``/``compile_s``; a decode row its ``decode_plan``; a failure is
a row with ``status: "FAIL: ..."``.  ``--head-aligned-sharding`` acts.

Where the reference's partitioner (GSPMD) partitions what DTensor cannot,
the trace does what GSPMD does, and the row counts it:

* each step does on each device the share of the work the reference's
  shardings give it (:class:`DTensorCalls`): a product's partial sums
  are reduced at once (Megatron's layout: a row-parallel projection's
  output all-reduced, not carried into the next projection, whose
  weight DTensor would gather); an einsum or a matmul whose operands
  split one index alike on each mesh dim runs on the local shards
  (:func:`_local_einsum`, :func:`_local_matmul`); heads that do not
  divide the mesh dim are split in blocks (:func:`_split_again`); a
  stack of a sharded tensor is split as it (:func:`_stacked`); products
  of mixed dtypes run in the promoted type, as ``jnp``'s do.  A product
  that still drops an operand's shard is counted (``gathered_calls``),
  and so is a column-parallel product whose input came split along the
  contracted index and was gathered (``input_gathered_calls``),
  and each row carries the plain step's FLOPs over the devices its work
  splits over (``plain_flops_per_device``, ``work_split``) and its ratio
  to them (``flops_over_plain``);
* an op with no DTensor strategy at its operands' placements, in the
  forward (:class:`DTensorCalls`) or in a backward (:class:`AtenCalls`,
  one aten op at a time, inside the graph), runs on operands gathered
  over the mesh's last axes (``replicated_calls``);
* a decode step's write into a cache sharded along its slots
  (``seq_shard``) goes to the shard that owns the slot
  (``_local_scatter``, ``local_scatter_calls``);
* on the multi-pod mesh the FSDP axes ('pod', 'data') are one flattened
  mesh dim (``launch/mesh.py::dtensor_mesh``): the same shards;
* rwkv6's token loop runs on each device's batch and heads, with no
  collective inside, grouped GQA on each device's query heads, both MoE
  dispatches and the decode's experts on each device's experts or
  their shard of F, zamba2's in-projection with each output split, and
  the GST step's segment gather on each device's batch rows, its outputs
  in its inputs' layout (:data:`LOCAL_CALLS`); a long loop is counted
  from its runs at 2 and 3 steps (:func:`counted_loop`).
The reference's exact rewrites act as its flags set them, for the row
being traced (:func:`trace_one` sets the module attributes and restores
them after): ``--dispatch`` (``models/moe.py::DISPATCH_MODE``),
``--cache-update`` (``models/common.py::CACHE_UPDATE``; the port's
default is "dus", the in-place write, where the reference's is
"onehot"), ``--attn-impl`` (``ATTN_IMPL``), ``--gqa`` (``GQA_IMPL``) and
``--mla-naive`` (``models/mla.py::ABSORBED_DECODE``); ``opts`` records
what ran.  ``--no-unroll`` raises: the port runs its layers as a Python
loop, every layer traced, and has no scan to keep rolled.  The kernels
cannot run on a fake tensor (they launch through ctypes), so the traced
steps run their plain versions; ``opts`` says so.
"""
from __future__ import annotations

import argparse
import json
import logging
import re
import time
import traceback
from contextlib import contextmanager
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensorMode, \
    unset_fake_temporarily
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, ArchConfig, \
    InputShape, get_config
from repro_torch.core import gst as gst_mod
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import fsdp_axes, make_production_mesh
from repro_torch.launch.sharding import head_aligned_overrides
from repro_torch.launch.specs import (StepSpec, build_step_spec,
                                      decode_plan, gst_geometry, materialize,
                                      param_shapes)
from repro_torch.models import common as common_mod, mamba2 as mamba_mod, \
    mla as mla_mod, moe as moe_mod
from repro_torch.models.rwkv6 import wkv_scan
from repro_torch.roofline.analysis import HW, TraceCounter, \
    active_counter, analyze_trace, param_counts

# the dry run's options for the reference's exact rewrites (switched)
SWITCHES = ("dispatch", "cache_update", "attn_impl", "gqa", "mla_naive")
NO_UNROLL = ("--no-unroll cannot act in the port: its layers are a Python "
             "loop, every layer traced; there is no scan to keep rolled")


@contextmanager
def switched(dispatch: str = "einsum", cache_update: str = "dus",
             attn_impl: str = "naive", gqa: str = "repeat",
             mla_naive: bool = False):
    """The models' switches set as the dry run's options say and restored
    on exit, also when the body raises; yields ``opts``, what runs."""
    values = {(moe_mod, "DISPATCH_MODE"): dispatch,
              (common_mod, "CACHE_UPDATE"): cache_update,
              (common_mod, "ATTN_IMPL"): attn_impl,
              (common_mod, "GQA_IMPL"): gqa,
              (mla_mod, "ABSORBED_DECODE"): not mla_naive}
    saved = {key: getattr(*key) for key in values}
    try:
        for (mod, attr), value in values.items():
            setattr(mod, attr, value)
        yield {"dispatch": dispatch, "cache_update": cache_update,
               "attn_impl": attn_impl, "mla_absorbed": not mla_naive,
               "unroll": True, "gqa": gqa, "use_kernels": False}
    finally:
        for (mod, attr), value in saved.items():
            setattr(mod, attr, value)


# what DTensor says where it cannot partition an op at its operands'
# placements (torch 2.11 and 2.13)
_NO_STRATEGY = (
    "Sharding propagation failed",
    "does not have a sharding strategy",
    # a local view its strategy assumed but the shard's strides refuse
    # (2.11 in a forward; 2.13 in the MoE dispatch's backward)
    "Cannot view a tensor with shape",
    # 2.13: a view splitting a dim whose shard is not a whole number of
    # the new dims (56 heads over a 16-way axis)
    "Cannot unflatten unevenly sharded tensor",
    # 2.13: an in-place op whose strategy would move its target
    "require placement changes",
    # 2.11: index_add's strategy splits the source along the indexed dim
    # and keeps the index whole (the gather dispatch run op by op)
    "should be equal to tensor.size(dim)",
    # 2.13: an in-place op into a partial sum from a sharded source (the
    # backward of qwen2-vl-7b's patch write into its embeddings)
    "to P(sum) not supported",
)
_ERRORS = (RuntimeError, NotImplementedError, ValueError)


def _no_strategy(e: Exception) -> bool:
    """DTensor cannot partition the op at its operands' placements."""
    msg = str(e)
    return any(m in msg for m in _NO_STRATEGY)


def _let_go(e: BaseException) -> BaseException:
    """``e``, a refused call's exception, with the frames of its traceback
    and of its cause and context chain cleared (``traceback.clear_frames``;
    an executing frame is kept).  DTensor re-raises inside its own
    ``except ... as e``, so its frame holds the exception it caught, whose
    traceback holds the frame: a cycle that would keep every frame the
    traceback reaches (``f_back`` up to the model's layers), and their
    tensors, until Python's collector ran."""
    seen, todo = set(), [e]
    while todo:
        x = todo.pop()
        if x is None or id(x) in seen:
            continue
        seen.add(id(x))
        traceback.clear_frames(x.__traceback__)
        todo += [x.__cause__, x.__context__]
    return e


class DTensorCalls(TorchFunctionMode):
    """The dry run's handling of each call on ``DTensor``s (and of a real
    step on a small mesh, ``chip_smoke.py``'s debug-mesh check).

    A call runs with the fake mode unset: DTensor's sharding propagation
    computes shard sizes and offsets with small host tensors of its own
    (``_StridedShard.local_shard_size_and_offset`` reads one with
    ``.tolist()``), which a fake tensor cannot answer; the local shards
    stay fake and dispatch to their own fake mode.

    Where DTensor has no strategy for a call at its operands' placements
    (an ``unbind`` along a sharded axis; on torch 2.11 a view that
    flattens a sharded head axis, or a strategy whose local view does not
    fit the shard's strides), the call's DTensor operands are gathered
    over the mesh's last axis, then over the last two, and so on, until
    the call goes through, as XLA's partitioner inserts a gather where it
    cannot partition an op.  An in-place call keeps its target and has
    only its other operands gathered (torch 2.13 cannot split a source
    into the partial sums of a gradient it is copied into).
    An autograd call (``torch.autograd.grad``) is not retried either (a
    gathered copy of a parameter is not in the graph): the ops it runs,
    which reach no torch function mode, get the same treatment one aten
    op at a time from :class:`AtenCalls`, a dispatch mode above
    DTensor's, inside the graph.  An in-place ``scatter_`` that DTensor
    cannot place runs on the local shards (:func:`_local_scatter`: a
    decode step's cache write, ``models/common.py::write_cache``, batch-
    or sequence-sharded; the MoE's one-hot masks; the card's torch 2.11
    has no scatter strategy).  A call listed in :data:`LOCAL_CALLS`
    (rwkv6's token loop, grouped GQA, the MoE dispatches and decode
    experts, zamba2's in-projection, the segment gather) runs on the
    local shards as its entry says, or, where its runner declines, its
    ops one by one (:data:`OP_BY_OP`).  A product (:data:`_PRODUCTS`)
    runs in its operands' promoted dtype, on the local shards where they
    are laid out for it, and its partial sums, and a lookup's, are
    reduced at once.  ``replicated`` ("<call> over <axes>", an aten op
    under its aten name), ``local`` and ``gathered`` (a product that
    dropped an operand's shard) count these calls, and the dry run's row
    reports them."""

    def __init__(self):
        super().__init__()
        self.replicated: Dict[str, int] = {}
        self.local: Dict[str, int] = {}
        self.gathered: Dict[str, int] = {}
        self.input_gathered: Dict[str, int] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(isinstance(t, DTensor)
                   for t in tree_leaves((args, kwargs))):
            return func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        with unset_fake_temporarily():
            if func in _AUTOGRAD_CALLS:
                with AtenCalls(self):
                    return func(*args, **kwargs)
            if func in LOCAL_CALLS:
                out = LOCAL_CALLS[func](func, *args, **kwargs)
                if out is not NotImplemented:
                    self.count_local(name)
                    return out
                with self:      # its ops one by one, as the model's
                    return OP_BY_OP[func](*args, **kwargs)
            if name in _FACTORIES:
                out = _stacked(func, args, kwargs)
                if out is not NotImplemented:
                    return out
            out = NotImplemented
            if name in _PRODUCTS:
                args = _promoted(name, args)
            if name == "einsum":
                args = _cosharded(args)
                out = _local_einsum(func, args, kwargs)
            elif name in ("matmul", "__matmul__", "mm", "bmm") and \
                    not kwargs:
                out = _local_matmul(func, *args, gathered=lambda axis: (
                    self.count(self.input_gathered, f"{name} over {axis}")))
            if out is NotImplemented:
                out = self.partitioned(func, name, args, kwargs,
                                       name.endswith("_"))
            if name in _CONTRACTIONS:
                self.count_gathers(name, (args, kwargs), out)
                out = tree_map_only(DTensor, _reduced, out)
            return out

    def count_gathers(self, name: str, operands, out) -> None:
        """Count a contraction that dropped an operand's shard over a mesh
        dim: its output replicated there, or a partial sum there computed
        against a sharded operand DTensor gathered (``gathered``)."""
        if not isinstance(out, DTensor):
            return
        ins = [t.placements for t in tree_leaves(operands)
               if isinstance(t, DTensor)]
        for d, p in enumerate(out.placements):
            shard = any(isinstance(q[d], Shard) for q in ins)
            partial = any(q[d].is_partial() for q in ins)
            if shard and (isinstance(p, Replicate)
                          or (p.is_partial() and partial)):
                key = f"{name} over {out.device_mesh.mesh_dim_names[d]}"
                self.count(self.gathered, key)

    def count_local(self, name: str) -> None:
        self.count(self.local, name)

    @staticmethod
    def count(tally: Dict[str, int], key: str) -> None:
        tally[key] = tally.get(key, 0) + 1

    def partitioned(self, func, name: str, args, kwargs, inplace: bool):
        """``func(*args, **kwargs)``, its DTensor operands gathered over
        the mesh's last axes where DTensor has no strategy for it (an
        in-place op's target as it is).  Each exception it declines lets
        go of its frames (:func:`_let_go`), and the one it may re-raise
        is dropped on every return: else the frames of a refused call, and
        their tensors, live until Python's collector finds the cycle."""
        try:
            return func(*args, **kwargs)
        except _ERRORS as e:
            if not _no_strategy(e):
                raise
            err = _let_go(e)
        try:
            return self._gathered(func, name, args, kwargs, inplace, err)
        finally:
            del err

    def _gathered(self, func, name: str, args, kwargs, inplace: bool, err):
        """:meth:`partitioned`'s retries of a call DTensor refused with
        ``err``."""
        if name == "scatter_" and _local_scatter(*args, **kwargs):
            self.count_local(name)
            return args[0]
        mesh = _mesh_of((args, kwargs))
        names = mesh.mesh_dim_names
        # an in-place op writes into its own target: only the other
        # operands are gathered
        keep = args[:1] if inplace else ()
        for k in range(len(names) - 1, -1, -1):
            a, kw = tree_map_only(DTensor, lambda t: _gathered_from(t, k),
                                  (args[len(keep):], kwargs))
            try:
                out = self._replicated(name, names[k:],
                                       func(*keep, *a, **kw))
            except _ERRORS as e:
                if not _no_strategy(e):
                    raise
                _let_go(e)
            else:
                return _split_again(args[0], out) if name in _VIEWS else out
        if inplace:
            raise err
        # no strategy even replicated: the whole tensors on every device,
        # laid out densely (DTensor's gather can leave a layout a view
        # cannot take), the op run on them
        a, kw = tree_map_only(DTensor, lambda t: t.to_local().contiguous(),
                              (a, kw))
        try:
            out = func(*a, **kw)
        except _ERRORS as e:
            raise err from e
        return self._replicated(name, names, tree_map_only(
            torch.Tensor, lambda t: DTensor.from_local(
                t, mesh, [Replicate()] * mesh.ndim, run_check=False), out))

    def _replicated(self, name: str, axes, out):
        key = f"{name} over {','.join(axes)}"
        self.count(self.replicated, key)
        return out


class AtenCalls(TorchDispatchMode):
    """:class:`DTensorCalls`' partitioner for the aten ops of an autograd
    call (a backward's ops): an op on ``DTensor``s that DTensor cannot
    partition at its operands' placements runs on operands gathered over
    the mesh's last axes, counted in ``calls.replicated`` under its aten
    name.  The mode sits above ``roofline/analysis.py::TraceCounter``,
    which passes a ``DTensor`` op on to DTensor and counts its local ops
    and collectives (the gathers' too)."""

    def __init__(self, calls: DTensorCalls):
        super().__init__()
        self.calls = calls

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        return self.calls.partitioned(func, str(func), args, kwargs,
                                      func._schema.is_mutable)


_AUTOGRAD_CALLS = (torch.autograd.grad, torch.autograd.backward,
                   torch.Tensor.backward)


# the products (projections, attention einsums), and with them the
# lookups (a vocab-sharded embedding's masked rows), whose partial sums
# the dry run reduces at once
_PRODUCTS = ("matmul", "__matmul__", "__rmatmul__", "mm", "bmm", "einsum",
             "linear")
_CONTRACTIONS = _PRODUCTS + ("embedding",)


def _reduced(t: DTensor) -> DTensor:
    """``t`` with its partial sums reduced (an all-reduce over each mesh
    dim where it is ``Partial``)."""
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


# a DTensor's methods that make a new tensor of a given size
_FACTORIES = ("new_empty", "new_zeros", "new_ones", "new_full")


def _stacked(func, args, kwargs):
    """``t.new_empty((n,) + t.shape)`` (or new_zeros, new_ones,
    new_full) of a ``DTensor`` t: a stack of n tensors laid out as t,
    split as t is (each of its shards one dim on), where DTensor would make
    it whole on every device (a prefill's stacked caches: each layer's
    batch-sharded cache then gathered into it).  NotImplemented for any
    other size."""
    t, size = args[0], args[1] if len(args) > 1 else kwargs.get("size")
    if not isinstance(t, DTensor) or not isinstance(size, (tuple, list,
                                                            torch.Size)):
        return NotImplemented
    size = tuple(size)
    if len(size) != t.ndim + 1 or size[1:] != tuple(t.shape):
        return NotImplemented
    place = [Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
             for p in t.placements]
    if any(p.is_partial() for p in t.placements):
        return NotImplemented
    local = t.to_local()
    out = func(local, (size[0],) + tuple(local.shape), *args[2:], **kwargs)
    return _global(out, t.device_mesh, place, size)


# views whose unflatten of a sharded dim DTensor may refuse
_VIEWS = ("reshape", "view")


def _split_again(src, out):
    """A view's result ``out``, gathered over the mesh dims that split the
    dim of ``src`` it unflattens (H·D heads into (H, D) where H does not
    divide the mesh dim), split again there along its leading part H:
    ceil(H / n) heads a device (torch.chunk's blocks, the last devices
    fewer or none), as GSPMD pads a head axis that does not divide.  A
    local chunk; only where H has a block for every device (a KV axis of
    8 heads over 16 stays whole)."""
    if not (isinstance(src, DTensor) and isinstance(out, DTensor)) or \
            out.ndim != src.ndim + 1:
        return out
    mesh, place = out.device_mesh, list(out.placements)
    for d, p in enumerate(src.placements):
        if not isinstance(p, Shard) or not isinstance(place[d], Replicate):
            continue
        j = p.dim
        if tuple(out.shape[:j]) == tuple(src.shape[:j]) and \
                out.shape[j] * out.shape[j + 1] == src.shape[j] and \
                out.shape[j] >= mesh.size(d) and \
                all(not isinstance(q, Shard) or q.dim != j for q in place):
            place[d] = Shard(j)
    if place == list(out.placements):
        return out
    return out.redistribute(mesh, place)


def _global(local, mesh, placements, shape):
    """``local`` as its shard of a ``shape`` DTensor laid out in the
    local tensor's dim order (a shard that may be uneven: the global shape
    given, not inferred)."""
    order = sorted(range(local.ndim), key=lambda i: (-local.stride(i), -i))
    stride, n = [0] * local.ndim, 1
    for i in reversed(order):
        stride[i] = n
        n *= shape[i]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _promoted(name: str, args):
    """A contraction's arguments (an einsum's after its equation) in one
    dtype, the operands' promoted type: the reference's ``jnp`` products
    promote (whisper's f32 encoder output against its bf16 decoder);
    torch's raise."""
    lead = 1 if name == "einsum" else 0
    ops = args[lead:]
    if not all(isinstance(t, torch.Tensor) and t.is_floating_point()
               for t in ops) or len({t.dtype for t in ops}) < 2:
        return args
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return (*args[:lead], *(t.to(dt) for t in ops))


class PlainCalls(TorchFunctionMode):
    """The plain step of :func:`plain_flops` as the dry run runs its
    calls: products of mixed dtypes in their promoted type
    (:func:`_promoted`), rwkv6's token loop counted from its short runs
    (:func:`counted_loop`; run whole, a prefill's 32,768 steps × 32
    layers would take most of an hour)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is wkv_scan:
            return counted_loop(func, *args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in _PRODUCTS:
            args = _promoted(name, args)
        return func(*args, **kwargs)


def _cosharded(args):
    """An einsum's ``(equation, *operands)`` with each operand that is
    replicated over a mesh dim where another shards an index the two share
    split there too (a local chunk, no collective), as GSPMD partitions a
    dot along a batch or head index both sides carry.  DTensor would
    rather gather the sharded side: a query's heads, where the keys are
    replicated over 'model' (8 KV heads on a 16-way axis)."""
    eq, ops = args[0], list(args[1:])
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = list(ops[0])
    if not isinstance(eq, str) or "." in eq or not all(
            isinstance(t, DTensor) for t in ops):
        return args
    subs = eq.replace(" ", "").split("->")[0].split(",")
    mesh = ops[0].device_mesh
    for d in range(mesh.ndim):
        if any(t.placements[d].is_partial() for t in ops):
            continue
        letters = {subs[i][t.placements[d].dim] for i, t in enumerate(ops)
                   if isinstance(t.placements[d], Shard)}
        if len(letters) != 1:
            continue
        idx = letters.pop()
        size = {t.shape[subs[i].find(idx)] for i, t in enumerate(ops)
                if isinstance(t.placements[d], Shard)}
        for i, t in enumerate(ops):
            j = subs[i].find(idx)
            if j < 0 or not isinstance(t.placements[d], Replicate) or \
                    {t.shape[j]} != size:
                continue
            place = list(t.placements)
            place[d] = Shard(j)
            ops[i] = t.redistribute(mesh, place)
    return (eq, *ops)


def _local_einsum(func, args, kwargs):
    """An einsum on the local shards where each mesh dim shards one index
    (or none) and every operand that carries it is split along it alike,
    the others replicated there: its local einsum is its shard of the
    result, split along that index where the result keeps it, a partial
    sum where the index is contracted.  GSPMD partitions a dot so; DTensor
    (torch 2.11) flattens a batch and a head axis sharded over two mesh
    dims into one and gathers the heads.  NotImplemented where the
    operands are laid out any other way."""
    eq, ops = args[0], list(args[1:])
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = list(ops[0])
    if kwargs or not isinstance(eq, str) or "." in eq or "->" not in eq \
            or not all(isinstance(t, DTensor) for t in ops):
        return NotImplemented
    ins, res = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = ops[0].device_mesh
    grads = [list(t.placements) for t in ops]
    out = []
    for d in range(mesh.ndim):
        place = [t.placements[d] for t in ops]
        if any(not isinstance(p, (Shard, Replicate)) for p in place):
            return NotImplemented
        letters = {subs[i][p.dim] for i, p in enumerate(place)
                   if isinstance(p, Shard)}
        if not letters:
            out.append(Replicate())
            continue
        if len(letters) > 1:
            return NotImplemented
        idx = letters.pop()
        sizes = set()
        for i, (p, t) in enumerate(zip(place, ops)):
            j = subs[i].find(idx)
            if j < 0:
                # its gradient is this shard's share
                grads[i][d] = Partial()
            elif not (isinstance(p, Shard) and p.dim == j):
                return NotImplemented
            else:
                sizes.add(t.shape[j])
        if len(sizes) != 1:     # a block of one is not a block of another
            return NotImplemented
        out.append(Shard(res.index(idx)) if idx in res else Partial())
    size = {}
    for sub, t in zip(subs, ops):
        for c, n in zip(sub, t.shape):      # a size-1 index broadcasts
            size[c] = max(size.get(c, 1), n)
    local = func(eq, *[t.to_local(grad_placements=g)
                       for t, g in zip(ops, grads)])
    return _global(local, mesh, out, [size[c] for c in res])


def _local_matmul(func, a, b, gathered=None):
    """``a @ b`` on the local shards where each mesh dim splits one of
    its indices alike on both (or on one, the other replicated there): a
    batch index (a size-1 or missing one of the other side broadcasts; a
    replicated one is split there too, a local chunk), the rows of ``a``,
    the columns of ``b``, or the contracted index on both (a partial
    sum); where ``a`` splits the contracted index and ``b`` its columns,
    ``a`` is gathered there first (a column-parallel projection's
    input; ``gathered(axis)`` is told of each such gather).  GSPMD
    partitions a dot so; DTensor gathers the sharded side of a batched
    product whose other side broadcasts (zamba2's SSD state against its
    C).  NotImplemented where the operands are laid out any other way."""
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or \
            a.ndim < 2 or b.ndim < 2:
        return NotImplemented
    mesh = a.device_mesh
    nb = max(a.ndim, b.ndim) - 2             # the result's batch dims

    def role(t, p):
        """What the shard of operand t (a or b) splits."""
        if isinstance(p, Replicate):
            return None
        if not isinstance(p, Shard):
            return "other"
        last = p.dim - t.ndim
        if last == -1:
            return "k" if t is a else "n"
        if last == -2:
            return "m" if t is a else "k"
        return nb - (t.ndim - 2) + p.dim       # a batch dim of the result

    def batch_dim(t, i):
        """Operand t's dim at the result's batch dim i, or None."""
        j = i - (nb - (t.ndim - 2))
        return j if j >= 0 else None

    out, grads = [], [list(a.placements), list(b.placements)]
    ops, gathers = [a, b], []
    for d in range(mesh.ndim):
        ra, rb = role(a, a.placements[d]), role(b, b.placements[d])
        if "other" in (ra, rb):
            return NotImplemented
        if ra is None and rb is None:
            out.append(Replicate())
        elif "k" in (ra, rb) and None in (ra, rb) or ra == rb == "k":
            for k, (t, r) in enumerate(((a, ra), (b, rb))):
                if r is None:           # split along k there too
                    place = list(ops[k].placements)
                    place[d] = Shard(t.ndim - (1 if k == 0 else 2))
                    ops[k] = ops[k].redistribute(mesh, place)
                    grads[k][d] = place[d]
            out.append(Partial())
        elif ra == "k" and rb == "n":
            # Megatron's column-parallel product: the input gathered
            place = list(ops[0].placements)
            place[d] = Replicate()
            ops[0] = ops[0].redistribute(mesh, place)
            grads[0][d] = Replicate()
            out.append(Shard(nb + 1))
            gathers.append(mesh.mesh_dim_names[d])
        elif ra == "m" and rb is None:
            out.append(Shard(nb))
            grads[1][d] = Partial()
        elif rb == "n" and ra is None:
            out.append(Shard(nb + 1))
            grads[0][d] = Partial()
        elif isinstance(ra, int) and rb in (ra, None) or \
                isinstance(rb, int) and ra is None:
            i = ra if isinstance(ra, int) else rb
            for k, (t, r) in enumerate(((a, ra), (b, rb))):
                if r is not None:
                    continue
                j = batch_dim(t, i)
                if j is None or t.shape[j] == 1:
                    grads[k][d] = Partial()    # it broadcasts
                    continue
                place = list(ops[k].placements)
                place[d] = Shard(j)
                ops[k] = ops[k].redistribute(mesh, place)
                grads[k][d] = Shard(j)
            out.append(Shard(i))
        else:
            return NotImplemented
    for t in ops:
        for d, p in enumerate(t.placements):
            if isinstance(p, Shard) and t.shape[p.dim] % mesh.size(d):
                return NotImplemented
    local = func(*[t.to_local(grad_placements=g)
                   for t, g in zip(ops, grads)])
    for axis in gathers if gathered else ():
        gathered(axis)
    return DTensor.from_local(local, mesh, out, run_check=False)


def _mesh_of(tree):
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            return t.device_mesh
    raise ValueError("no DTensor")


def _gathered_from(t: DTensor, k: int) -> DTensor:
    """``t`` replicated over the mesh axes from the k-th on."""
    place = [Replicate() if d >= k else p for d, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, place)


def _block(mesh, dims) -> int:
    """This device's block of a dim split over mesh ``dims``, mesh-major."""
    block, coord = 0, mesh.get_coordinate()
    for d in dims:
        block = block * mesh.size(d) + coord[d]
    return block


def _local_scatter(target, dim, index, src=None, **kwargs) -> bool:
    """``target.scatter_(dim, index, src)`` (a tensor or a number) on the
    local shards where the target is a DTensor and index and source have
    its shape on every axis but ``dim``; False (nothing done) otherwise.

    Index and source take the target's placements, replicated over the
    mesh dims that shard ``dim``.  Where none does, each shard scatters
    its own rows.  Where some do (a cache sharded along its slots,
    ``seq_shard``), each index must name one slot (``index.shape[dim]``
    is 1): owner computes (:func:`_owner_scatter`), what GSPMD makes of
    the reference's one-hot update."""
    value = kwargs.pop("value", None)
    if src is None:
        src = value
    if kwargs or not isinstance(target, DTensor) or src is None:
        return False
    dim %= target.ndim
    mesh, place = target.device_mesh, target.placements
    along = [d for d, p in enumerate(place)
             if isinstance(p, Shard) and p.dim == dim]
    n = 1
    for d in along:
        n *= mesh.size(d)
    if along and (index.shape[dim] != 1 or target.shape[dim] % n):
        return False
    others = [t for t in (index, src) if isinstance(t, torch.Tensor)]
    for t in others:
        if [s for d, s in enumerate(t.shape) if d != dim] != [
                s for d, s in enumerate(target.shape) if d != dim]:
            return False
    want = [Replicate() if d in along else p for d, p in enumerate(place)]

    def local(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, want).to_local()

    shard = target.to_local()
    if not along:
        shard.scatter_(dim, local(index), local(src))
        return True
    _owner_scatter(shard, dim, local(index), local(src),
                   _block(mesh, along) * shard.shape[dim])
    return True


def _owner_scatter(shard, dim: int, index, src, offset: int) -> None:
    """``scatter_`` into the shard that holds slots ``offset`` … ``offset
    + shard.shape[dim] - 1`` of a tensor split along ``dim``: an index in
    that range writes its source at its local slot, any other writes
    nothing (it writes back the slot it was clamped to, whose value it
    read first: one index a row along ``dim``, so no two writes meet)."""
    at = index - offset
    mine = (at >= 0) & (at < shard.shape[dim])
    at = at.clamp(0, shard.shape[dim] - 1)
    shard.scatter_(dim, at, torch.where(mine, src, shard.gather(dim, at)))


def _replicated_dt(t, mesh):
    """``t`` as a ``DTensor`` on ``mesh``: replicated where a plain tensor."""
    return t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _local_wkv_scan(func, wrkv, state=None):
    """rwkv6's token loop (``models/rwkv6.py::wkv_scan``) on each device's
    own batch rows and heads: w, r, k, v (4, S, B, H, N) keep their shards
    of B and H (a dim that does not divide its mesh dim, and any other
    sharding, is gathered), the state (B, H, N, N) takes the same ones,
    and the loop runs on the plain local tensors, in the graph
    (``to_local`` / ``from_local``).  GSPMD partitions the reference's
    ``lax.scan`` the same way, along batch and heads, with no collective
    inside the loop; a DTensor dispatch a step costs a full-size trace
    minutes, where a plain fake op costs microseconds."""
    mesh = wrkv.device_mesh
    place = [p if isinstance(p, Shard) and p.dim in (2, 3)
             and wrkv.shape[p.dim] % mesh.size(d) == 0 else Replicate()
             for d, p in enumerate(wrkv.placements)]
    # the same mesh dims on the state (B, H, N, N) and on y (B, S, H, N)
    on_state = [Shard(p.dim - 2) if isinstance(p, Shard) else p
                for p in place]
    on_y = [Shard(0 if p.dim == 2 else 2) if isinstance(p, Shard) else p
            for p in place]
    if state is not None:
        state = _replicated_dt(state, mesh).redistribute(
            mesh, on_state).to_local()
    y, s = counted_loop(func, wrkv.redistribute(mesh, place).to_local(),
                        state)
    return (DTensor.from_local(y, mesh, on_y, run_check=False),
            DTensor.from_local(s, mesh, on_state, run_check=False))


# a loop of more steps than this is run at 2 and 3 steps and counted at
# its length (counted_loop)
LOOP_STEPS = 64


def counted_loop(func, x, state):
    """``func(x, state)``, a token loop over ``x.shape[1]`` steps of equal
    shapes (rwkv6's ``wkv_scan`` on local tensors).  Up to
    :data:`LOOP_STEPS` steps, or where no ``TraceCounter`` counts, it
    runs as it is.  Longer, it runs at 2 and 3 steps, each under a
    counter of its own, and the active counter takes what the loop does
    at its length: every count (FLOPs, bytes, collectives) is affine in
    the step count (a step's ops do not change, the prologue and
    epilogue scale or stay), so c(S) = c(3) + (S − 3)·(c(3) − c(2));
    the storages' peak and what stays live (the outputs, the tensors
    saved for the backward) are taken the same way.  The backward is
    counted alike from the two short loops' backwards
    (:class:`_CountedLoop`).  A full-size trace dispatches a step's ops
    on fake tensors at about a millisecond each: 32,768 steps × 32
    layers would take an hour."""
    counter = active_counter()
    if counter is None or x.shape[1] <= LOOP_STEPS:
        return func(x, state)
    return _CountedLoop.apply(func, counter, x, state)


def _tally(sub, since=None) -> dict:
    """What ``sub`` (a ``TraceCounter``) counted, less ``since`` (a tally
    of it taken earlier, its peak then reset to what was live)."""
    base = since or {"flops": 0, "bytes": 0, "collective_bytes": {},
                     "collective_ops": {}, "live": 0}
    return {
        "flops": sub.flops - base["flops"],
        "bytes": sub.bytes_accessed - base["bytes"],
        "collective_bytes": {k: v - base["collective_bytes"].get(k, 0.0)
                             for k, v in sub.collective_bytes.items()},
        "collective_ops": {k: v - base["collective_ops"].get(k, 0)
                           for k, v in sub.collective_ops.items()},
        "peak": sub.peak - base["live"], "live": sub.live_bytes}


def _extrapolated(a: dict, b: dict, S: int) -> dict:
    """The tally at S steps from the tallies at 2 and 3 (affine)."""
    def at(u, v):
        if isinstance(u, dict):
            return {k: at(u.get(k, 0), v.get(k, 0)) for k in set(u) | set(v)}
        return v + (S - 3) * (v - u)

    return {k: at(a[k], b[k]) for k in a}


def _at_length(a, b, S: int):
    """A new tensor like ``a`` and ``b``, a loop's output at 2 and 3 steps,
    at S steps: the sizes and strides (affine in the step count) taken
    the same way, so the ops after it see the loop's own layout."""
    def at(u, v):
        return tuple(j + (S - 3) * (j - i) for i, j in zip(u, v))

    # a method of the (fake) tensor: a new fake tensor of its mode
    return a.new_empty_strided(at(a.shape, b.shape), at(a.stride(),
                                                        b.stride()))


def _count(counter, work) -> None:
    counter.add(work["flops"], work["bytes"], work["collective_bytes"],
                work["collective_ops"])
    counter.reach(work["peak"])


class _CountedLoop(torch.autograd.Function):
    """:func:`counted_loop`'s long loop: the outputs are new tensors of
    the loop's shapes, the counts those of the loop (see there).  The
    backward runs the short loops' backwards under their forwards'
    counters, so the storages their forwards saved are freed as the
    backward goes, as the loop's are, and lets go of the short runs, so
    the loop's input is freed with its backward too."""

    @staticmethod
    def forward(ctx, func, counter, x, state):
        S, grad = x.shape[1], x.requires_grad
        runs, tallies = [], []
        for n in (2, 3):
            # the first n steps, as views: the same strides as the loop's
            xn = x[:, :n].detach().requires_grad_(grad)
            sn = None if state is None else state.detach()
            with counter.aside() as sub, torch.enable_grad() if grad \
                    else torch.no_grad():
                out = func(xn, sn)
            tallies.append(_tally(sub))
            runs.append((sub, xn, out))
        work = _extrapolated(*tallies, S)
        _count(counter, work)
        with counter.paused():
            y, s = (_at_length(a, b, S)
                    for a, b in zip(runs[0][2], runs[1][2]))
        counter.account((), {}, (y, s))
        # what the loop keeps beside its outputs: the backward's tensors
        ctx.held = counter.hold(work["live"] - sum(
            t.untyped_storage().nbytes() for t in (y, s)), ctx)
        ctx.set_materialize_grads(False)   # the last state's, unused
        ctx.counter, ctx.S = counter, S
        ctx.runs = list(zip(runs, tallies)) if grad else None
        return y, s

    @staticmethod
    def backward(ctx, gy, gs):
        counter, tallies, gxs = ctx.counter, [], []
        # the short runs go with this backward, as the loop's saved tensors
        # do: their inputs are views of x, whose storage the graph would
        # otherwise keep until it is dropped
        runs, ctx.runs = ctx.runs, None
        for (sub, xn, (yn, sn)), since in runs:
            n = xn.shape[1]
            outs, grads = [yn], [gy[:, :n].detach()]
            if gs is not None:
                outs.append(sn)
                grads.append(gs.detach())
            since = dict(since, live=sub.live_bytes)
            sub.peak = sub.live_bytes
            with counter.paused(), sub:
                gx, = torch.autograd.grad(outs, [xn], grads)
            tallies.append(_tally(sub, since))
            gxs.append(gx)
        _count(counter, _extrapolated(*tallies, ctx.S))
        counter.release(ctx.held)       # the saved tensors, freed
        with counter.paused():
            gx = _at_length(*gxs, ctx.S)
        counter.account((), {}, gx)
        return None, None, gx, None


def _local_grouped_attn(func, q, k, v, mask):
    """``models/common.py::_grouped_attn`` on each device's batch rows
    and query heads, against the KV heads those read: q (B, Sq, H, D)
    keeps its shards of B and H (an uneven split of H too, ``_split_again``;
    a replicated k, v or mask takes q's batch split, a local chunk), k and
    v (B, Sk, KV, D) their shard of KV where both H and KV divide the mesh
    dim that splits H, else the KV heads the local query heads read (a
    slice of the gathered heads: one KV head where the local heads share
    it, else one a query head).  GSPMD partitions the reference's grouped
    einsums so; DTensor cannot unflatten H sharded heads into (KV, G)
    where KV does not divide the mesh dim, and would gather q (every
    device all heads).  NotImplemented (the ops one by one) where q or
    the keys are split any other way."""
    mesh = q.device_mesh
    B, _, H, _ = q.shape
    KV = k.shape[2]
    G = H // KV

    q, k, v, mask = (_replicated_dt(t, mesh) for t in (q, k, v, mask))
    q_at, kv_at, m_at, heads = [], [], [], []
    for d in range(mesh.ndim):
        n = mesh.size(d)
        dims = {p.dim for t in (q, k, v) for p in [t.placements[d]]
                if isinstance(p, Shard)}
        if any(t.placements[d].is_partial() for t in (q, k, v, mask)) or \
                isinstance(mask.placements[d], Shard) and \
                mask.placements[d].dim != 0 or not dims <= {0, 2} or \
                dims == {0, 2}:
            return NotImplemented
        if dims == {0} and B % n == 0:
            q_at.append(Shard(0))
            kv_at.append(Shard(0))
            m_at.append(Shard(0) if mask.shape[0] == B else Replicate())
        elif dims == {2} and not heads and H >= n:
            heads.append(d)
            q_at.append(Shard(2))
            kv_at.append(Shard(2) if H % n == 0 and KV % n == 0
                         else Replicate())
            m_at.append(Replicate())
        elif dims:
            return NotImplemented
        else:
            q_at.append(Replicate())
            kv_at.append(Replicate())
            m_at.append(Replicate())
    ql, kl, vl = (t.redistribute(mesh, at).to_local() for t, at in
                  ((q, q_at), (k, kv_at), (v, kv_at)))
    if heads and isinstance(kv_at[heads[0]], Replicate):
        # the KV heads of the local query heads h0 … h0 + hl − 1
        n = mesh.size(heads[0])
        h0 = mesh.get_coordinate()[heads[0]] * -(-H // n)
        hl = ql.shape[2]
        if hl and h0 // G == (h0 + hl - 1) // G:
            kl, vl = (t.narrow(2, h0 // G, 1) for t in (kl, vl))
        elif hl:
            at = torch.div(torch.arange(h0, h0 + hl, device=kl.device), G,
                           rounding_mode="floor")
            kl, vl = (t.index_select(2, at) for t in (kl, vl))
    out = func(ql, kl, vl, mask.redistribute(mesh, m_at).to_local())
    return _global(out, mesh, q_at, q.shape)


def _expert_dims(w: DTensor):
    """The mesh dims that split an expert weight's E (dim 0), or None
    where it is split along another dim too."""
    along = [d for d, p in enumerate(w.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if any(isinstance(p, Shard) and d not in along or p.is_partial()
           for d, p in enumerate(w.placements)):
        return None
    return along


def _rows_of(t: DTensor, skip):
    """Placements that keep ``t``'s split of its leading (batch) dim over
    the mesh dims not in ``skip``, replicated elsewhere."""
    return [Shard(0) if d not in skip and isinstance(p, Shard)
            and p.dim == 0 else Replicate()
            for d, p in enumerate(t.placements)]


def _rows_share(place, rows):
    """The gradient placements of a weight laid out as ``place`` that
    each device multiplies by its own batch rows (``rows``, as
    :func:`_rows_of` gives them): its share, a partial sum, over the
    mesh dims that split the rows (the FSDP reduce-scatter then sums
    it), as ``place`` elsewhere."""
    return [Partial() if isinstance(r, Shard) else p
            for p, r in zip(place, rows)]


def _local_dispatch(func, we, x, gates, pos_c, keep, *rest, first=0):
    """``models/moe.py::_einsum_dispatch`` or ``_gather_dispatch`` on each
    device's experts: the expert weights keep their shard of E (over
    'model'), the tokens, gates and slots (B, S, ·) their shard of B and
    come whole over the mesh dims that shard E; each device routes the
    pairs of its experts into their inputs (the one-hot planes of its
    E/16 experts, or its experts' cells of the scatter), runs their FFNs
    and combines their outputs (``first``: its first expert), and the
    devices' (B, S, D) sums over their experts are reduced over those
    dims (an all-reduce; where no mesh dim shards E, each device runs
    every expert on its rows).  What GSPMD makes of the reference's
    einsums or scatter and gather with expert-sharded weights; DTensor
    would build the one-hot planes, or the (B, E·(C + 1), D) expert
    input, whole on every device.  ``rest``: the call's other arguments.
    NotImplemented (the ops one by one) where a weight is split along
    another dim."""
    w = we["w_in"]
    mesh = w.device_mesh
    along = _expert_dims(w)
    if along is None:
        return NotImplemented
    tokens = _rows_of(x, along)
    # a gradient of the whole tokens is each device's experts' share
    grads = [Partial() if d in along else p for d, p in enumerate(tokens)]
    xl, gl, pl, kl = (t.redistribute(mesh, tokens).to_local(
        grad_placements=grads) for t in (x, gates, pos_c, keep))
    wl = {k: v.to_local(grad_placements=_rows_share(v.placements, tokens))
          for k, v in we.items()}
    out = func(wl, xl, gl, pl, kl, *rest,
               first=first + _block(mesh, along) * w.to_local().shape[0])
    return _reduced(DTensor.from_local(out, mesh, grads, run_check=False))


# the dim of F in each expert weight, (E, D, F) and (E, F, D)
_EXPERT_F = {"w_in": 2, "w_gate": 2, "w_out": 1}


def _local_decode_experts(func, we, xk, top_idx, w_eff, act, first=0):
    """``models/moe.py::_decode_experts`` with every expert's weights
    split along F over the mesh dims that shard E (an all-to-all of the
    expert weights, as torch 2.13's DTensor moves them for the gather,
    there along D): each device gathers the (B, k, D, F/16) slices of
    its batch rows' selected experts, runs Megatron's expert FFN on them
    (the up and gate products on its F columns, the down product a
    partial sum), and the (B, D) sums are reduced over those dims.  A
    device's expert work is its share; DTensor on the card's torch 2.11
    gathers the (B, k, D, F) weights whole on every device.
    NotImplemented (the ops one by one) where no mesh dim shards E or a
    weight is split along another dim."""
    w = we["w_in"]
    mesh = w.device_mesh
    along = _expert_dims(w)
    if not along or any(v.shape[_EXPERT_F[k]] % mesh.size(d)
                        for k, v in we.items() for d in along):
        return NotImplemented
    xk = _replicated_dt(xk, mesh)
    rows = _rows_of(xk, along)
    wl = {}
    for k, v in we.items():
        place = [Shard(_EXPERT_F[k]) if d in along else p
                 for d, p in enumerate(v.placements)]
        wl[k] = v.redistribute(mesh, place).to_local(
            grad_placements=_rows_share(place, rows))
    xl, il, el = (_replicated_dt(t, mesh).redistribute(mesh, rows).to_local()
                  for t in (xk, top_idx, w_eff))
    out = func(wl, xl, il, el, act, first=first)
    return _reduced(DTensor.from_local(
        out, mesh, [Partial() if d in along else p
                    for d, p in enumerate(rows)], run_check=False))


def _local_split_in(func, p, x, cfg):
    """``models/mamba2.py::_split_in`` with each of its five outputs split
    over the mesh dim that splits the in-projection's columns ('model'),
    as the reference's five slices of its output are: each device
    multiplies its batch rows (gathered along any other dim, a
    sequence-parallel input) by its own columns of xs, gate, B, C and dt
    (the weight gathered there, its gradient reduce-scattered), so xs,
    gate and dt keep 1/16 of their columns (dt two of 32 heads, xs and
    gate those heads' channels) and B and C, which every head reads, are
    gathered ((B, S, N) each).  A device's FLOPs are its share of the
    projection; DTensor (torch 2.11) gathers the output z, whose
    boundaries fall inside its 16 blocks of 522 columns, and torch 2.13
    its gradient.  NotImplemented (the ops one by one) where a width does
    not divide that mesh dim or the weight is split another way."""
    w = p["w_in"]
    if not isinstance(w, DTensor):
        return NotImplemented
    mesh = w.device_mesh
    cols = [d for d, q in enumerate(w.placements)
            if isinstance(q, Shard) and q.dim == w.ndim - 1]
    widths = mamba_mod.in_widths(cfg)
    if len(cols) != 1 or any(
            isinstance(q, Shard) and d not in cols or q.is_partial()
            for d, q in enumerate(w.placements)) or any(
            k % mesh.size(cols[0]) for k in widths):
        return NotImplemented
    m, n = cols[0], mesh.size(cols[0])
    x = _replicated_dt(x, mesh)
    rows = _rows_of(x, cols)
    partial = [Partial() if d == m else q for d, q in enumerate(rows)]
    xl = x.redistribute(mesh, rows).to_local(grad_placements=partial)
    whole = [Replicate() if d == m else q for d, q in enumerate(w.placements)]
    # each device's columns and batch rows: the weight's and the bias's
    # gradients are its share there
    share = [Partial() if d == m else q
             for d, q in enumerate(_rows_share(whole, rows))]
    wl = w.redistribute(mesh, whole).to_local(grad_placements=share)
    j = mesh.get_coordinate()[m]
    at, starts = 0, []
    for k in widths:
        starts.append(at + j * (k // n))
        at += k
    idx = torch.cat([torch.arange(a, a + k // n, device=wl.device)
                     for a, k in zip(starts, widths)])
    bias = _replicated_dt(p["dt_bias"], mesh).full_tensor(
        grad_placements=[Partial() if q.is_partial() else Replicate()
                         for q in share])
    H = widths[-1]
    outs = mamba_mod.split_z(xl @ wl.index_select(1, idx),
                             bias.narrow(0, j * (H // n), H // n),
                             [k // n for k in widths])
    split = [Shard(x.ndim - 1) if d == m else q for d, q in enumerate(rows)]
    res = []
    for t, k, name in zip(outs, widths, ("xs", "gate", "B", "C", "dt")):
        shape = tuple(x.shape[:-1]) + (k,)
        t = _global(t, mesh, split, shape)
        res.append(t.redistribute(mesh, rows) if name in ("B", "C") else t)
    return tuple(res)


def _local_gather_segments(func, seg_inputs, idx):
    """``core/gst.py::gather_segments`` on each device's own batch rows:
    each input (B, J, ...) gathered on its local shard at the local rows
    of idx (B, S), its output laid out as the input is on every mesh dim
    (the batch split where the input's is, replicated where it is
    replicated), as GSPMD partitions the reference's ``take_along_axis``.
    DTensor (torch 2.13) splits the output's token axis over 'model' (the
    frames' over 'data', and their features over 'model'), and the norms
    and projections after it carry that split: a row-parallel weight's
    gradient is then formed whole on every device (rwkv6-7b's ``w_rec``,
    MLA's ``wkv_a``).  NotImplemented (the ops one by one) where a mesh
    dim splits J, a placement is partial, or the index is not split as
    an input's batch."""
    mesh = _mesh_of((seg_inputs, idx))
    idx = _replicated_dt(idx, mesh)
    out = {}
    for k, x in seg_inputs.items():
        x = _replicated_dt(x, mesh)
        rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0
                else Replicate() for p in x.placements]
        if any(isinstance(p, Shard) and p.dim == 1 or p.is_partial()
               for p in x.placements) or list(idx.placements) != rows:
            return NotImplemented
        local = func({k: x.to_local()}, idx.to_local())[k]
        out[k] = _global(local, mesh, x.placements,
                         tuple(idx.shape) + tuple(x.shape[2:]))
    return out


# calls the dry run runs on the local shards: function -> its runner,
# which may return NotImplemented for the call's ops one by one, run as
# OP_BY_OP has them
LOCAL_CALLS = {wkv_scan: _local_wkv_scan,
               common_mod._grouped_attn: _local_grouped_attn,
               moe_mod._einsum_dispatch: _local_dispatch,
               moe_mod._gather_dispatch: _local_dispatch,
               moe_mod._decode_experts: _local_decode_experts,
               mamba_mod._split_in: _local_split_in,
               gst_mod.gather_segments: _local_gather_segments}
OP_BY_OP = {common_mod._grouped_attn: common_mod.grouped_einsums,
            moe_mod._einsum_dispatch: moe_mod.einsum_dispatch_ops,
            moe_mod._gather_dispatch: moe_mod.gather_dispatch_ops,
            moe_mod._decode_experts: moe_mod.decode_experts_ops,
            mamba_mod._split_in: mamba_mod.split_in_ops,
            gst_mod.gather_segments: gst_mod.gather_segments_ops}


@contextmanager
def fake_trace():
    """The dry run's context: a ``FakeTensorMode`` (host tensors that
    DTensor makes are taken in), DTensor's calls outside it
    (:class:`DTensorCalls`, yielded), and plain tensors the models make
    (positions, masks) treated as replicated."""
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)    # one warning per multi-axis gather
    calls = DTensorCalls()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), calls, \
                implicit_replication():
            yield calls
    finally:
        log.setLevel(level)


def step_tokens(cfg: ArchConfig, shape: InputShape):
    """(tokens a step, "train" or "infer"): the reference's accounting."""
    if shape.kind == "train":
        _, L = gst_geometry(cfg, shape)
        return shape.global_batch * L * cfg.gst_backprop_segments, "train"
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len, "infer"
    return shape.global_batch, "infer"


def plain_flops(spec: StepSpec, device) -> float:
    """The FLOPs of ``spec``'s step on one device, unsharded: the plain
    step traced on fake tensors under the roofline's counter (no
    ``DTensor``, no collective), the work its formulation does.  Only
    the FLOPs are read, so the trace skips ``analyze_trace``'s memory
    report (its collection after the trace scans the whole heap)."""
    with FakeTensorMode() as fake, PlainCalls():
        args = materialize(spec, None, device)
        with TraceCounter(fake) as counter:
            spec.fn(*args)
    return float(counter.flops)


def work_split(mesh, batch: int) -> int:
    """The devices a step's work splits over: the mesh, less the FSDP
    axes where the batch does not divide them (``sharding.batch_spec``
    replicates it there: a long_500k batch of 1 runs on every data
    replica)."""
    if SH.batch_spec(mesh, batch, 1)[0] is not None:
        return mesh.size()
    n = 1
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        if name not in fsdp_axes(mesh):
            n *= size
    return n


def analytic_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """The closed form of a dense or VLM decoder's serving step (prefill
    or decode), all devices together: 2·N_proj·T for the layers'
    projections (the sharding rules' projections; T = B·S tokens at
    prefill, B at decode), 2·d·V·B for the LM head (the last position's
    logits), and 4·B·H·Sq·Sk·D·L for the attention's two einsums (Sq = Sk
    = S at prefill, whose plain forms compute every masked pair; Sq = 1,
    Sk the cache's slots at decode)."""
    if cfg.family not in ("dense", "vlm") or shape.kind == "train":
        raise ValueError(f"no closed form for {cfg.name} {shape.name}")
    proj = [pat for pat, _ in SH._RULES if "embed" not in pat
            and "conv_w" not in pat]
    leaves = {}
    SH._tree_map_with_path(lambda p, leaf: leaves.__setitem__(p, leaf),
                           param_shapes(cfg)["runs"])
    n_proj = sum(leaf.numel() for p, leaf in leaves.items()
                 if any(re.search(pat, p) for pat in proj))
    B = shape.global_batch
    if shape.kind == "prefill":
        T, Sq, Sk = B * shape.seq_len, shape.seq_len, shape.seq_len
    else:
        T, Sq, Sk = B, 1, decode_plan(cfg, shape).cache_len
    return (2.0 * n_proj * T + 2.0 * cfg.d_model * cfg.vocab_size * B
            + 4.0 * B * cfg.num_heads * Sq * Sk * cfg.resolved_head_dim
            * cfg.num_layers)


def trace_spec(cfg: ArchConfig, shape: InputShape, spec: StepSpec, mesh, *,
               device, hw: HW = HW()) -> Dict:
    """Trace ``spec``'s step once on fake ``DTensor``s on ``mesh``: the
    roofline report with the parameter counts and tokens, and beside it
    the plain step's FLOPs over the devices its work splits over
    (``plain_flops_per_device``: :func:`plain_flops` over
    ``work_split``, :func:`work_split`) and the row's ratio to them
    (``flops_over_plain``): above 1 where a device repeats work another
    does."""
    n_total, n_active = param_counts(spec.params, cfg.moe.top_k,
                                     cfg.moe.num_experts)
    tokens, kind = step_tokens(cfg, shape)
    with fake_trace() as calls:
        args = materialize(spec, mesh, device)
        rep, _ = analyze_trace(spec.fn, args, chips=mesh.size(), hw=hw,
                               n_active=n_active, tokens=tokens, kind=kind)
    rep.update(params_total=n_total, params_active=n_active,
               tokens_per_step=tokens, replicated_calls=calls.replicated,
               local_scatter_calls=calls.local,
               gathered_calls=calls.gathered,
               input_gathered_calls=calls.input_gathered)
    split = work_split(mesh, shape.global_batch)
    plain = plain_flops(spec, device) / split
    rep.update(work_split=split, plain_flops_per_device=plain,
               flops_over_plain=rep["flops_per_device"] / plain)
    return rep


def trace_one(cfg: ArchConfig, shape: InputShape, mesh, *, mesh_name: str,
              variant: str = "gst_efd", dtype=torch.bfloat16,
              head_aligned: bool = False, device="cuda",
              verbose: bool = True, **switches) -> Dict:
    """One (config, shape) traced on ``mesh``: the dry run's row.
    ``switches``: :func:`switched`'s options, set for this trace alone."""
    t0 = time.time()
    overrides = head_aligned_overrides(cfg, mesh) if head_aligned else ()
    spec = build_step_spec(cfg, shape, mesh, dtype=dtype, variant=variant,
                           device=device, overrides=overrides)
    with switched(**switches) as opts:
        rep = trace_spec(cfg, shape, spec, mesh, device=device)
    t_trace = time.time() - t0
    rep.update({
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "variant": variant if shape.kind == "train" else None,
        "opts": {**opts, "head_aligned": head_aligned},
        "device": torch.device(device).type,
        "trace_s": round(t_trace, 2),
    })
    if shape.kind == "decode":
        plan = decode_plan(cfg, shape)
        rep["decode_plan"] = {"cache_len": plan.cache_len,
                              "window": plan.window, "ring": plan.ring,
                              "seq_shard": plan.seq_shard}
    if verbose:
        ma = rep["memory_analysis"]
        print(f"[{mesh_name}] {cfg.name} x {shape.name}: OK "
              f"(trace {t_trace:.1f}s) dominant={rep['dominant']} "
              f"terms={ {k: f'{v:.3e}' for k, v in rep['terms_seconds'].items()} } "
              f"args/dev={ma['arg_bytes'] / 1e9:.2f}GB "
              f"temp/dev={ma['temp_bytes'] / 1e9:.2f}GB", flush=True)
    return rep


def run_one(arch_id: str, shape_name: str, multi_pod: bool, *,
            variant: str = "gst_efd", dtype=torch.bfloat16,
            head_aligned: bool = False, device="cuda",
            verbose: bool = True, **switches) -> Dict:
    cfg = get_config(arch_id)
    shape = INPUT_SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        return {"arch": arch_id, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped (DESIGN.md §Skips)"}
    resolve_device(device)
    with make_production_mesh(multi_pod=multi_pod, device=device) as mesh:
        return trace_one(cfg, shape, mesh, mesh_name="multi(2,16,16)"
                         if multi_pod else "single(16,16)",
                         variant=variant, dtype=dtype,
                         head_aligned=head_aligned, device=device,
                         verbose=verbose, **switches)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="gst_efd")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type; the traced tensors are "
                         "fake either way (cuda asks for a visible card)")
    ap.add_argument("--head-aligned-sharding", action="store_true")
    ap.add_argument("--no-unroll", action="store_true",
                    help="raises: the port has no layer scan")
    ap.add_argument("--dispatch", default="einsum",
                    choices=["einsum", "gather"],
                    help="the MoE forward's dispatch (models/moe.py)")
    ap.add_argument("--cache-update", default="dus",
                    choices=["dus", "onehot"],
                    help="the decode cache write (models/common.py): the "
                         "port's default dus writes the slot in place, "
                         "onehot rewrites the cache (the reference's "
                         "default); both give the same values")
    ap.add_argument("--attn-impl", default="naive",
                    choices=["naive", "chunked"],
                    help="the plain prefill attention (models/common.py)")
    ap.add_argument("--mla-naive", action="store_true",
                    help="MLA decode in the naive form (models/mla.py)")
    ap.add_argument("--gqa", default="repeat", choices=["repeat", "grouped"],
                    help="GQA attention with K/V repeated or grouped "
                         "(models/common.py)")
    return ap


def main(argv=None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    if args.no_unroll:
        raise ValueError(NO_UNROLL)
    switches = {name: getattr(args, name) for name in SWITCHES}
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results: List[Dict] = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_one(
                        arch, shape, mp, variant=args.variant,
                        head_aligned=args.head_aligned_sharding,
                        device=args.device, **switches))
                except Exception as e:   # a FAIL row; the sweep goes on
                    traceback.print_exc()
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": "multi" if mp else "single",
                                    "status": f"FAIL: {e}"[:2000]})
                    print(f"FAIL {arch} x {shape} multi={mp}: {e}",
                          flush=True)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1, default=str)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if "skip" in r["status"])
    print(f"\n{n_ok} ok, {n_skip} skipped, {len(results) - n_ok - n_skip} "
          f"failed of {len(results)}")
    return results


if __name__ == "__main__":
    main()
