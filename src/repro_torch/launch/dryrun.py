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
  collective inside (:data:`LOCAL_CALLS`); a long loop is counted from
  its runs at 2 and 3 steps (:func:`counted_loop`).
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
import time
import traceback
from contextlib import contextmanager
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensorMode, \
    unset_fake_temporarily
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, ArchConfig, \
    InputShape, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import head_aligned_overrides
from repro_torch.launch.specs import (StepSpec, build_step_spec,
                                      decode_plan, gst_geometry, materialize)
from repro_torch.models import common as common_mod, mla as mla_mod, \
    moe as moe_mod
from repro_torch.models.rwkv6 import wkv_scan
from repro_torch.roofline.analysis import HW, active_counter, \
    analyze_trace, param_counts

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
)
_ERRORS = (RuntimeError, NotImplementedError, ValueError)


def _no_strategy(e: Exception) -> bool:
    """DTensor cannot partition the op at its operands' placements."""
    msg = str(e)
    return any(m in msg for m in _NO_STRATEGY)


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
    cannot partition an op.  An in-place call is never retried that way.
    An autograd call (``torch.autograd.grad``) is not retried either (a
    gathered copy of a parameter is not in the graph): the ops it runs,
    which reach no torch function mode, get the same treatment one aten
    op at a time from :class:`AtenCalls`, a dispatch mode above
    DTensor's, inside the graph.  An in-place ``scatter_`` that DTensor
    cannot place runs on the local shards (:func:`_local_scatter`: a
    decode step's cache write, ``models/common.py::write_cache``, batch-
    or sequence-sharded; the MoE's one-hot masks; the card's torch 2.11
    has no scatter strategy).  A call listed in :data:`LOCAL_CALLS`
    (rwkv6's token loop) runs on the local shards as its entry says.
    ``replicated`` ("<call> over <axes>", an aten op under its aten
    name) and ``local`` count these calls, and the dry run's row reports
    them."""

    def __init__(self):
        super().__init__()
        self.replicated: Dict[str, int] = {}
        self.local: Dict[str, int] = {}

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
                self.count_local(name)
                return LOCAL_CALLS[func](func, *args, **kwargs)
            return self.partitioned(func, name, args, kwargs,
                                    name.endswith("_"))

    def count_local(self, name: str) -> None:
        self.local[name] = self.local.get(name, 0) + 1

    def partitioned(self, func, name: str, args, kwargs, inplace: bool):
        """``func(*args, **kwargs)``, its DTensor operands gathered over
        the mesh's last axes where DTensor has no strategy for it."""
        try:
            return func(*args, **kwargs)
        except _ERRORS as e:
            if not _no_strategy(e):
                raise
            if name == "scatter_" and _local_scatter(*args, **kwargs):
                self.count_local(name)
                return args[0]
            if inplace:
                raise
            err = e
        mesh = _mesh_of((args, kwargs))
        names = mesh.mesh_dim_names
        for k in range(len(names) - 1, -1, -1):
            a, kw = tree_map_only(DTensor, lambda t: _gathered_from(t, k),
                                  (args, kwargs))
            try:
                return self._replicated(name, names[k:], func(*a, **kw))
            except _ERRORS as e:
                if not _no_strategy(e):
                    raise
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
        self.replicated[key] = self.replicated.get(key, 0) + 1
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


def _mesh_of(tree):
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            return t.device_mesh
    raise ValueError("no DTensor")


def _gathered_from(t: DTensor, k: int) -> DTensor:
    """``t`` replicated over the mesh axes from the k-th on."""
    place = [Replicate() if d >= k else p for d, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, place)


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
    coord, block = mesh.get_coordinate(), 0
    for d in along:                        # the dim's split, mesh-major
        block = block * mesh.size(d) + coord[d]
    _owner_scatter(shard, dim, local(index), local(src),
                   block * shard.shape[dim])
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
        if not isinstance(state, DTensor):
            state = DTensor.from_local(state, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
        state = state.redistribute(mesh, on_state).to_local()
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
    backward goes, as the loop's are."""

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
        for (sub, xn, (yn, sn)), since in ctx.runs:
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


# calls the dry run runs on the local shards: function -> its runner
LOCAL_CALLS = {wkv_scan: _local_wkv_scan}


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


def trace_spec(cfg: ArchConfig, shape: InputShape, spec: StepSpec, mesh, *,
               device, hw: HW = HW()) -> Dict:
    """Trace ``spec``'s step once on fake ``DTensor``s on ``mesh``: the
    roofline report with the parameter counts and tokens."""
    n_total, n_active = param_counts(spec.params, cfg.moe.top_k,
                                     cfg.moe.num_experts)
    tokens, kind = step_tokens(cfg, shape)
    with fake_trace() as calls:
        args = materialize(spec, mesh, device)
        rep, _ = analyze_trace(spec.fn, args, chips=mesh.size(), hw=hw,
                               n_active=n_active, tokens=tokens, kind=kind)
    rep.update(params_total=n_total, params_active=n_active,
               tokens_per_step=tokens, replicated_calls=calls.replicated,
               local_scatter_calls=calls.local)
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
