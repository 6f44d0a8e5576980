"""Three-term roofline of one traced step on a mesh of H100s.

Counterpart of ``src/repro/roofline/analysis.py``, with the same report
and the same formulas:

    compute term    = FLOPs            / (chips × peak FLOP/s)
    memory term     = bytes            / (chips × HBM bandwidth)
    collective term = collective bytes a device / link bandwidth

The reference reads XLA's compiled module (``cost_analysis``,
``memory_analysis``, the optimized HLO's collectives).  Torch compiles
nothing to ask, so :func:`analyze_trace` runs the step once on the mesh's
``DTensor`` arguments (fake tensors on the production mesh, where nothing
is allocated) under :class:`TraceCounter`.  That dispatch mode returns
``NotImplemented`` for an op on ``DTensor``s, as ``CommDebugMode`` does:
DTensor splits the op over the mesh first, and the mode then sees the
local ops and the collectives of the device that traces (rank 0).  Per
local op it counts

* FLOPs, through ``FlopCounterMode``'s formulas: matmuls, convolutions
  and attention (XLA's ``flops`` counts every HLO op);
* bytes: the op's operand and result bytes, views excluded (the nearest
  analogue of XLA's ``bytes accessed``);
* live bytes: the storages the ops create, each until it is freed, whose
  peak is the temp term of the memory report (``obs/memory.py::LiveBytes``,
  the memory probe's CPU accounting);
* collectives: each functional collective's max(result bytes, operand
  bytes), by kind, and their count (the reference's convention).

In a fake trace only ops on the trace's own fake tensors count: DTensor's
host bookkeeping and its sharding propagation's global-shape stand-ins
(another fake mode) are no work of the device, nor is a ``.device``
query.  Work no op of the counter runs (a loop counted from shorter runs,
``launch/dryrun.py::counted_loop``) is added with :meth:`TraceCounter.add`.

Temp bytes are frees by reference count alone.  The step runs with
Python's cyclic collector off, so a storage is freed in the count when the
step drops its last reference to it, as the card's caching allocator
frees it, and the figure is the same in every process.  A storage that a
reference cycle holds stays counted to the end of the trace: a
``gc.collect()`` then frees it, and the bytes it frees are reported as
``memory_analysis.collector_bytes``, neither subtracted nor hidden (0 in
every row of the dry run; ``launch/dryrun.py::DTensorCalls.partitioned``
breaks the cycles of the calls it retries).  With the collector on, that
storage would have been freed whenever the collector happened to run,
which depends on what else the process had allocated.

Per-device figures are rank 0's; global ones multiply by the chip count,
as the reference does with XLA's per-device module.
"""
from __future__ import annotations

import gc
import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.obs.memory import LiveBytes


@dataclass(frozen=True)
class HW:
    # NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi's name and power limit);
    # NVIDIA's data sheet, SXM part, dense rates
    peak_flops: float = 989e12      # bf16 tensor-core FLOP/s per card
    hbm_bw: float = 3.35e12         # B/s of HBM3 per card
    link_bw: float = 450e9          # B/s one way over NVLink 4 (18 links,
                                    # 900 GB/s both ways) per card


# the reference's collective kinds (XLA's names); a collective of another
# kind is counted under its own op name
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("permute", "collective-permute"))
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd", "c10d")
_NOT_COLLECTIVES = ("wait_tensor", "barrier", "monitored_barrier",
                    "_wrap_tensor_autograd")


def _collective_kind(func) -> Optional[str]:
    """The collective kind of a dispatched op, or None for a compute op."""
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func._overloadpacket.__name__
    if name in _NOT_COLLECTIVES:
        return None
    for key, kind in _KIND_OF:
        if key in name:
            return kind
    return name


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class TraceCounter(LiveBytes):
    """The dispatch mode of :func:`analyze_trace` (see the module
    docstring): FLOPs (``flops``), operand + result bytes
    (``bytes_accessed``), live bytes (``peak``, ``largest``, from
    ``LiveBytes``) and collectives (``collective_bytes``,
    ``collective_ops``) of the local ops that run under it.  In a fake
    trace an op on host tensors only is DTensor's bookkeeping and is not
    counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        # the fake mode of the traced tensors (None: real ones); an op on
        # another fake mode's tensors, or on meta tensors, is DTensor's own
        # shape propagation (global shapes, not work of this device; torch
        # versions differ in which they use) and is not counted
        self.fake_mode = fake_mode
        self.flop_counter = FlopCounterMode(display=False)
        self.bytes_accessed = 0
        self.collective_bytes: Dict[str, float] = dict.fromkeys(COLLECTIVES,
                                                                0.0)
        self.collective_ops: Dict[str, int] = dict.fromkeys(COLLECTIVES, 0)
        self.extra_flops = 0        # counted by add(), not by an op
        self._paused = 0

    @property
    def flops(self) -> int:
        return self.flop_counter.get_total_flops() + self.extra_flops

    @contextmanager
    def paused(self) -> Iterator[None]:
        """Ops run inside pass through uncounted."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    @contextmanager
    def aside(self) -> Iterator["TraceCounter"]:
        """A fresh counter, yielded, for the ops run inside; this one
        counts none of them."""
        sub = TraceCounter(self.fake_mode)
        with self.paused(), sub:
            yield sub

    def add(self, flops: float, bytes_accessed: float,
            collective_bytes: Dict[str, float],
            collective_ops: Dict[str, float]) -> None:
        """Count work no op of this counter ran (``launch/dryrun.py``'s
        counted loops)."""
        self.extra_flops += int(flops)
        self.bytes_accessed += int(bytes_accessed)
        for k, v in collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v
        for k, v in collective_ops.items():
            self.collective_ops[k] = self.collective_ops.get(k, 0) + int(v)

    def reach(self, nbytes: int) -> None:
        """``nbytes`` above what is live now were live at once."""
        self.peak = max(self.peak, self.live_bytes + int(nbytes))

    def hold(self, nbytes: int, owner):
        """``nbytes`` more are live until ``owner`` is freed or the
        returned key released."""
        key = ("held", id(owner))
        nbytes = int(nbytes)
        if nbytes > 0:
            with self._mu:
                self._live[key] = self._live.get(key, 0) + nbytes
                self.live_bytes += nbytes
                self.peak = max(self.peak, self.live_bytes)
            weakref.finalize(owner, self._release, key)
        return key

    def release(self, key) -> None:
        """What :meth:`hold` took under ``key`` is no longer live."""
        self._release(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # DTensor splits the op over the mesh; its local ops come back
            return NotImplemented
        ins = _tensors((args, kwargs))
        if any(t.is_meta or (isinstance(t, FakeTensor)
                             and t.fake_mode is not self.fake_mode)
               for t in ins):
            return func(*args, **kwargs)
        if ins and not any(self._ours(t) for t in ins):
            # host tensors in a fake trace: DTensor's own bookkeeping
            # (shard sizes and offsets), no work of the device
            return func(*args, **kwargs)
        registry = self.flop_counter.flop_registry
        if func not in registry and func is not torch.ops.prim.device.default:
            # what FlopCounterMode does: count a composite op's parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not ins and not any(self._ours(t) for t in outs):
            # made from nothing outside the trace's tensors: DTensor's
            # bookkeeping, or its sharding propagation's global-shape
            # stand-ins (a fake mode of its own)
            return out
        self.account(args, kwargs, out)
        kind = _collective_kind(func)
        if kind is not None:
            self.collective_ops[kind] = self.collective_ops.get(kind, 0) + 1
            self.collective_bytes[kind] = self.collective_bytes.get(
                kind, 0.0) + float(max(_nbytes(ins), _nbytes(outs)))
            return out
        self.flop_counter._count_flops(func._overloadpacket, out, args,
                                       kwargs)
        if outs and not _is_view(func):     # a metadata query moves none
            self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        return out

    def _ours(self, t: torch.Tensor) -> bool:
        """A tensor of the trace: of its fake mode, or any in a real
        trace."""
        return self.fake_mode is None or (
            isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode)


def active_counter() -> Optional[TraceCounter]:
    """The :class:`TraceCounter` on the dispatch mode stack, if any."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, TraceCounter):
            return mode
    return None


def _is_view(func) -> bool:
    """A view op (its result aliases an operand without writing it) moves
    no bytes of its own; an in-place op does."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _local_tensors(tree):
    """The tensors of ``tree`` on the device that traces: a DTensor's
    local shard."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def local_argument_bytes(tree) -> int:
    """Bytes of the unique storages of the tensors in ``tree`` on the
    device that traces: a DTensor counts its local shard."""
    seen = {}
    for t in _local_tensors(tree):
        if t.layout == torch.strided:
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def param_counts(param_shapes, moe_top_k: int = 0, moe_num_experts: int = 0
                 ) -> Tuple[float, float]:
    """(total params, active params) of a nested dict/list tree of tensors
    or shapes.  Leaves under a path containing 'experts' are scaled by
    top_k/num_experts for the active count."""
    total = 0.0
    active = 0.0
    for path, leaf in _flatten_with_path(param_shapes):
        n = float(np.prod(leaf.shape)) if len(leaf.shape) else 1.0
        total += n
        if "experts" in path and moe_num_experts:
            active += n * moe_top_k / moe_num_experts
        else:
            active += n
    return total, active


def _flatten_with_path(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], f"{prefix}/{k}"
                                          if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, f"{prefix}/{i}"
                                          if prefix else str(i))
    else:
        yield prefix, tree


def model_flops(n_active: float, tokens: float, kind: str) -> float:
    """Useful model FLOPs: 6·N·D for training, 2·N·D for inference."""
    return (6.0 if kind == "train" else 2.0) * n_active * tokens


def roofline_report(*, chips: int, flops_dev: float, bytes_dev: float,
                    coll: Dict[str, float], counts: Dict[str, int],
                    mem_stats: Dict[str, Any], hw: HW = HW(),
                    n_active: Optional[float] = None,
                    tokens: Optional[float] = None,
                    kind: str = "train") -> Dict[str, Any]:
    """The reference's report (``analyze_compiled``'s keys and formulas)
    from per-device counts."""
    coll = dict(coll)
    coll["total"] = sum(v for k, v in coll.items() if k != "total")
    flops_global = flops_dev * chips
    bytes_global = bytes_dev * chips
    t_compute = flops_global / (chips * hw.peak_flops)
    t_memory = bytes_global / (chips * hw.hbm_bw)
    t_collective = coll["total"] / hw.link_bw  # per-device bytes, one link
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    result = {
        "chips": chips,
        "flops_per_device": flops_dev,
        "flops_global": flops_global,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll,
        "collective_op_counts": dict(counts),
        "terms_seconds": terms,
        "dominant": dominant,
        "memory_analysis": mem_stats,
    }
    if n_active is not None and tokens is not None:
        mf = model_flops(n_active, tokens, kind)
        result["model_flops"] = mf
        result["useful_flops_ratio"] = mf / flops_global if flops_global \
            else 0.0
        result["mfu_upper_bound"] = mf / (chips * hw.peak_flops) / max(
            max(terms.values()), 1e-30)
    return result


@contextmanager
def collector_off() -> Iterator[None]:
    """Python's cyclic collector off inside, and back as it was on exit
    (also when the body raises): a storage is then freed only when its
    last reference goes, the same in every process."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def analyze_trace(fn: Callable, args: tuple, *, chips: int, hw: HW = HW(),
                  n_active: Optional[float] = None,
                  tokens: Optional[float] = None,
                  kind: str = "train") -> Tuple[Dict[str, Any], Any]:
    """Run ``fn(*args)`` once under :class:`TraceCounter` and derive the
    three roofline terms and the diagnostics: (the report, fn's result).
    ``memory_analysis`` holds the accounting of the device that traces:
    ``arg_bytes`` (its shards of the arguments), ``temp_bytes`` (the peak
    of the storages the step created), ``peak_bytes`` (their sum),
    ``accounting_bound_bytes`` (the largest single buffer) and
    ``collector_bytes`` (what only the collector freed: see the module
    docstring).  The step runs with the collector off
    (:func:`collector_off`)."""
    arg = local_argument_bytes(args)
    fakes = [t for t in _local_tensors(args) if isinstance(t, FakeTensor)]
    counter = TraceCounter(fakes[0].fake_mode if fakes else None)
    with collector_off():
        with counter:
            out = fn(*args)
        live = counter.live_bytes
        gc.collect()
        freed = live - counter.live_bytes
    mem = {"mode": "accounting", "arg_bytes": int(arg),
           "temp_bytes": int(counter.peak),
           "peak_bytes": int(arg + counter.peak),
           "accounting_bound_bytes": int(counter.largest),
           "collector_bytes": int(freed)}
    rep = roofline_report(chips=chips, flops_dev=float(counter.flops),
                          bytes_dev=float(counter.bytes_accessed),
                          coll=counter.collective_bytes,
                          counts=counter.collective_ops, mem_stats=mem,
                          hw=hw, n_active=n_active, tokens=tokens, kind=kind)
    return rep, out
