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
The reference's six speed switches (``--no-unroll``, ``--dispatch
gather``, ``--cache-update dus``, ``--attn-impl chunked``,
``--mla-naive``, ``--gqa grouped``) raise: the port keeps only their
defaults (``models/common.py``, ``moe.py``, ``mla.py``) and runs its
layers as a Python loop, so there is nothing to switch and no scan to
unroll.  The kernels cannot run on a fake tensor (they launch through
ctypes), so the traced steps run their plain versions; ``opts`` says so.
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
from torch.utils._pytree import tree_leaves, tree_map_only

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, ArchConfig, \
    InputShape, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import head_aligned_overrides
from repro_torch.launch.specs import (StepSpec, build_step_spec,
                                      decode_plan, gst_geometry, materialize)
from repro_torch.roofline.analysis import HW, analyze_trace, param_counts

# the reference's speed switches: flag -> (its default, what the port does)
SPEED_SWITCHES = {
    "no_unroll": (False, "the port's layers are a Python loop: every layer "
                         "is traced, there is no scan to keep rolled"),
    "dispatch": ("einsum", "the port's MoE dispatch is the einsum form "
                           "(models/moe.py)"),
    "cache_update": ("onehot", "the port writes the cache in place "
                               "(models/common.py)"),
    "attn_impl": ("naive", "the port's attention is the naive form "
                           "(models/common.py)"),
    "mla_naive": (False, "the port's MLA decode is the absorbed form "
                         "(models/mla.py)"),
    "gqa": ("repeat", "the port's GQA repeats K/V (models/common.py)"),
}
OPTS = {"dispatch": "einsum", "cache_update": "onehot", "attn_impl": "naive",
        "mla_absorbed": True, "unroll": True, "gqa": "repeat",
        "use_kernels": False}


def check_speed_switches(args) -> None:
    """Raise for a reference speed switch set away from its default."""
    for name, (default, why) in SPEED_SWITCHES.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise ValueError(f"{flag} cannot act in the port: {why}")


def _no_strategy(e: Exception) -> bool:
    """DTensor cannot partition the call at its operands' placements: no
    strategy, or (torch 2.11) a local view its strategy assumed."""
    msg = str(e)
    return ("Sharding propagation failed" in msg
            or "does not have a sharding strategy" in msg
            or "Cannot view a tensor with shape" in msg)


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
    fit the shard's strides), the call's DTensor operands are
    gathered over the mesh's last axis, then over the last two, and so
    on, until the call goes through, as XLA's partitioner inserts a
    gather where it cannot partition an op.  An in-place call, or an
    autograd call (``torch.autograd.grad``: a gathered copy of a
    parameter is not in the graph), is never retried that way, but an
    in-place ``scatter_`` whose target is not
    sharded along the scatter dim runs on the local shards, its index and
    source placed as the target: DTensor's own scatter strategy does so
    from torch 2.13 on, and the card's torch 2.11 has none (a decode
    step's cache write, ``models/common.py::write_cache``; the MoE's
    one-hot masks).  ``replicated`` ("<call> over <axes>") and ``local``
    count these calls, and the dry run's row reports them."""

    def __init__(self):
        super().__init__()
        self.replicated: Dict[str, int] = {}
        self.local: Dict[str, int] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(isinstance(t, DTensor)
                   for t in tree_leaves((args, kwargs))):
            return func(*args, **kwargs)
        if func in _AUTOGRAD_CALLS:
            # their results hang on their operands' identity: a gathered
            # copy is not in the graph, so a failure surfaces as it is
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        with unset_fake_temporarily():
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                name = getattr(func, "__name__", str(func))
                if not _no_strategy(e):
                    raise
                if name == "scatter_" and _local_scatter(*args, **kwargs):
                    self.local[name] = self.local.get(name, 0) + 1
                    return args[0]
                if name.endswith("_"):
                    raise
                err = e
            names = _mesh_names((args, kwargs))
            for k in range(len(names) - 1, -1, -1):
                a, kw = tree_map_only(DTensor,
                                      lambda t: _gathered_from(t, k),
                                      (args, kwargs))
                try:
                    out = func(*a, **kw)
                except (RuntimeError, NotImplementedError) as e:
                    if not _no_strategy(e):
                        raise
                    continue
                key = f"{name} over {','.join(names[k:])}"
                self.replicated[key] = self.replicated.get(key, 0) + 1
                return out
            raise err


_AUTOGRAD_CALLS = (torch.autograd.grad, torch.autograd.backward,
                   torch.Tensor.backward)


def _mesh_names(tree) -> tuple:
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            return tuple(t.device_mesh.mesh_dim_names)
    return ()


def _gathered_from(t: DTensor, k: int) -> DTensor:
    """``t`` replicated over the mesh axes from the k-th on."""
    place = [Replicate() if d >= k else p for d, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, place)


def _local_scatter(target, dim, index, src=None, **kwargs) -> bool:
    """``target.scatter_(dim, index, src)`` (a tensor or a number) on the
    local shards where the target is a DTensor not sharded along ``dim``
    and index and source have its shape on every other axis; False
    (nothing done) otherwise."""
    value = kwargs.pop("value", None)
    if src is None:
        src = value
    if kwargs or not isinstance(target, DTensor) or src is None:
        return False
    dim %= target.ndim
    if any(isinstance(p, Shard) and p.dim == dim for p in target.placements):
        return False
    others = [t for t in (index, src) if isinstance(t, torch.Tensor)]
    for t in others:
        if [s for d, s in enumerate(t.shape) if d != dim] != [
                s for d, s in enumerate(target.shape) if d != dim]:
            return False
    mesh, place = target.device_mesh, target.placements

    def local(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, place).to_local()

    target.to_local().scatter_(dim, local(index), local(src))
    return True


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
              verbose: bool = True) -> Dict:
    """One (config, shape) traced on ``mesh``: the dry run's row."""
    t0 = time.time()
    overrides = head_aligned_overrides(cfg, mesh) if head_aligned else ()
    spec = build_step_spec(cfg, shape, mesh, dtype=dtype, variant=variant,
                           device=device, overrides=overrides)
    rep = trace_spec(cfg, shape, spec, mesh, device=device)
    t_trace = time.time() - t0
    rep.update({
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "variant": variant if shape.kind == "train" else None,
        "opts": {**OPTS, "head_aligned": head_aligned},
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
            verbose: bool = True) -> Dict:
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
                         verbose=verbose)


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
    # the reference's speed switches: accepted at their defaults only
    ap.add_argument("--no-unroll", action="store_true",
                    help="raises: " + SPEED_SWITCHES["no_unroll"][1])
    ap.add_argument("--dispatch", default="einsum",
                    choices=["einsum", "gather"],
                    help="gather raises: " + SPEED_SWITCHES["dispatch"][1])
    ap.add_argument("--cache-update", default="onehot",
                    choices=["onehot", "dus"],
                    help="dus raises: " + SPEED_SWITCHES["cache_update"][1])
    ap.add_argument("--attn-impl", default="naive",
                    choices=["naive", "chunked"],
                    help="chunked raises: " + SPEED_SWITCHES["attn_impl"][1])
    ap.add_argument("--mla-naive", action="store_true",
                    help="raises: " + SPEED_SWITCHES["mla_naive"][1])
    ap.add_argument("--gqa", default="repeat", choices=["repeat", "grouped"],
                    help="grouped raises: " + SPEED_SWITCHES["gqa"][1])
    return ap


def main(argv=None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    check_speed_switches(args)
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
                        device=args.device))
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
