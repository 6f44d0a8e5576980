"""Memory observability of the port: measure the constant-memory claim.

Counterpart of ``src/repro/obs/memory.py`` with the same names, record
keys and published metrics.  The reference reads XLA's compiled
``memory_analysis()`` from an AOT compile beside each jit and runs the
original callable after it.  Torch compiles nothing to ask, and the port's
train, refresh and finetune steps write the table and the optimizer state
in place, so a second call would change the run.  So the port measures the
ONE real call, on the first call of each (site, shape signature), and
later calls of that signature only count (``"calls"``):

* a call with a CUDA tensor among its arguments (``mode: "allocator"``):
  the device is synchronized, ``torch.cuda.memory_allocated`` read,
  ``torch.cuda.reset_peak_memory_stats`` called, the call made and the
  device synchronized again.  ``temp_bytes`` is ``max_memory_allocated``
  less the bytes allocated before; ``peak_bytes`` the bytes of the call's
  unique argument storages plus ``temp_bytes`` (the reference's
  "argument + output + temp - alias").  The probe RESETS the card's peak
  counter: code that reads a run's own peak must run with the probe off;
* a call on the CPU (``mode: "accounting"``): a ``TorchDispatchMode`` of
  the calling thread counts the bytes of every storage the call's ops
  create, each until it is freed (a weakref finalizer), and keeps the
  peak as ``temp_bytes``; ``accounting_bound_bytes`` is the largest
  single buffer an op made (``kernels/ops.py::max_intermediate_bytes``).

The shards of a ``LocalGroup`` are threads of one process on one card.
The allocator counts per device, so a ``dist.*`` record is the whole
card's for its D shards; a dispatch mode sees one thread, so in
accounting mode each shard thread runs under a mode of its own
(:func:`in_shard`) and the record sums the shards' peaks.  Either way a
sharded record carries ``"shards": D``.  Under ``torchrun`` a process is
one shard: its record says ``"shards": 1`` and the run's ``world_size``.
The reference's records are per device.  There is no ``"error"`` mode: a call that raises propagates (it
is the run's own step), and ``cost`` is None.

Per measurement the probe publishes, as the reference does:

    mem.device.peak_bytes.<site>   argument storages + temp
    mem.device.temp_bytes.<site>   the call's own bytes above what was live
    mem.host.rss_bytes             process RSS at capture time

and a Chrome-trace "C" counter ``mem.device.temp_bytes``.  Host gauges
(the tiered store's host tier, the feeders' staging) go through
:meth:`MemoryProbe.observe_host` -> ``mem.host.<site>_bytes``.

The probe is a process-wide global defaulting to :class:`NullProbe`; a
call site wraps its callable with :func:`probe_call`, whose disabled path
is one global read and a branch a call: no sync, no peak reset and no
dispatch mode.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import get_tracer


# ---------------------------------------------------------------------------
# shape signatures + byte helpers
# ---------------------------------------------------------------------------


def _leaves(tree):
    """The leaves of ``tree`` in ``jax.tree_util``'s order: tuples
    (NamedTuples too) and lists by position, dicts by sorted key, None has
    none; a module gives its parameters, then its buffers."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def shape_signature(tree) -> str:
    """Canonical ``dtype[shape]`` signature of a tree of tensors and arrays
    (JAX's form: ``float32[4,8]``), the probe's dedup key."""
    parts = []
    for leaf in _leaves(tree):
        dtype = getattr(leaf, "dtype", None)
        shape = getattr(leaf, "shape", None)
        if dtype is None or shape is None:
            parts.append(type(leaf).__name__)
        else:
            name = str(dtype).removeprefix("torch.")
            parts.append(f"{name}[{','.join(str(s) for s in shape)}]")
    return ";".join(parts)


def tree_nbytes(tree) -> int:
    """Total bytes of every tensor and array leaf (host staging buffers,
    host tiers)."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            nb = getattr(leaf, "nbytes", None)
            if nb is not None:
                total += int(nb)
    return total


def process_rss_bytes() -> int:
    """Resident-set size of this process, in bytes (0 when unreadable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource
            # ru_maxrss is KiB on Linux (bytes on macOS: close enough for a
            # monitoring gauge; the gates never read RSS)
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except (ImportError, OSError):
            return 0


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _strided(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)
            and t.layout == torch.strided]


def argument_bytes(tree) -> int:
    """Bytes of the unique storages of the tensors in ``tree``."""
    seen = {}
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor) and t.layout == torch.strided:
            seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


# ---------------------------------------------------------------------------
# accounting: the live bytes of the storages a call's ops create
# ---------------------------------------------------------------------------


class LiveBytes(TorchDispatchMode):
    """Counts, in the thread that enters it, the bytes of every storage the
    ops run under it create (an output that is a view or an in-place
    result creates none), each until the storage is freed.  ``peak`` is
    the most live at once, ``largest`` the largest single storage.

    A storage is released through a finalizer on it: a storage that a
    reference cycle holds stays counted until Python's collector frees
    the cycle, and when that is depends on what else the process has
    allocated, so the peak would too.  The dry run's trace runs with the
    collector off and reports what a collection after it frees
    (``roofline/analysis.py::analyze_trace``, ``collector_bytes``)."""

    def __init__(self):
        super().__init__()
        self._mu = threading.Lock()
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.largest = 0

    def _release(self, key: int) -> None:
        with self._mu:
            self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.account(args, kwargs, out)
        return out

    def account(self, args, kwargs, out) -> None:
        """Take in the storages ``out`` creates (see the class)."""
        known = {_storage_key(t) for t in _strided((args, kwargs))}
        for t in _strided(out):
            st = t.untyped_storage()
            key, nb = st._cdata, st.nbytes()
            if not nb or key in known:
                continue
            with self._mu:
                if key in self._live:
                    continue
                self._live[key] = nb
                self.live_bytes += nb
                self.peak = max(self.peak, self.live_bytes)
                self.largest = max(self.largest, nb)
            weakref.finalize(st, self._release, key)


class _ShardMeter:
    """The shard threads' share of the one call being measured."""

    def __init__(self, accounting: bool):
        self.thread = threading.get_ident()
        self.accounting = accounting
        self._mu = threading.Lock()
        self.shards = 0
        self.peak = 0
        self.largest = 0

    def add(self, mode: Optional[LiveBytes]) -> None:
        with self._mu:
            self.shards += 1
            if mode is not None:
                self.peak += mode.peak
                self.largest = max(self.largest, mode.largest)


_meter: Optional[_ShardMeter] = None   # set only while a call is measured
_measure_mu = threading.Lock()          # one measurement at a time
_measuring = threading.local()          # this thread is measuring a call


def in_shard(thunk: Callable[[], Any]):
    """One shard's share of a sharded call (a ``LocalGroup`` thread runs
    it).  While the probe measures that call, the shard is counted, and in
    accounting mode runs under a dispatch mode of its own thread whose
    peak adds to the record; otherwise it is ``thunk()``."""
    meter = _meter
    if meter is None:
        return thunk()
    if not meter.accounting or threading.get_ident() == meter.thread:
        # the allocator sees every thread; the calling thread's mode
        # already sees this one
        out = thunk()
        meter.add(None)
        return out
    mode = LiveBytes()
    with mode:
        out = thunk()
    meter.add(mode)
    return out


def _cuda_device(tree) -> Optional[torch.device]:
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def measure_call(fn: Callable, args=(), kwargs=None
                 ) -> Tuple[Dict[str, Any], Any]:
    """Make the one call ``fn(*args, **kwargs)`` and measure it: (the
    record's memory fields, the call's result).  Allocator mode where a
    CUDA tensor is among the arguments, accounting mode otherwise (see
    the module docstring)."""
    global _meter
    if getattr(_measuring, "on", False):
        # a site inside a measured call would wait on the lock it holds
        raise RuntimeError("memory-probe sites nest: a measured call made "
                           "the first call of another site")
    kwargs = kwargs or {}
    arg = argument_bytes((args, kwargs))
    dev = _cuda_device((args, kwargs))
    with _measure_mu:
        meter = _meter = _ShardMeter(accounting=dev is None)
        _measuring.on = True
        try:
            if dev is not None:
                torch.cuda.synchronize(dev)
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                out = fn(*args, **kwargs)
                torch.cuda.synchronize(dev)
                temp = torch.cuda.max_memory_allocated(dev) - before
                rec = {"mode": "allocator", "device": str(dev)}
            else:
                mode = LiveBytes()
                with mode:
                    out = fn(*args, **kwargs)
                temp = mode.peak + meter.peak
                rec = {"mode": "accounting", "accounting_bound_bytes":
                       max(mode.largest, meter.largest)}
        finally:
            _meter = None
            _measuring.on = False
    rec.update(temp_bytes=int(temp), peak_bytes=int(arg + temp),
               arg_bytes=int(arg))
    if meter.shards:
        rec["shards"] = meter.shards
    return rec, out


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


class MemoryProbe:
    """Measures one call per (site, shape signature); counts the rest."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._records: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._host_bytes: Dict[str, int] = {}
        # a torchrun run's world size: its sharded records cover this
        # process's shard ("shards": 1) of that many
        self.world_size: Optional[int] = None

    # -- device-side capture ----------------------------------------------

    def observe_call(self, site: str, fn: Callable, args, kwargs):
        """Make one call of a probed site and return its result: measured
        on the first call per (site, signature), counted afterwards."""
        sig = shape_signature((args, kwargs))
        key = (site, sig)
        with self._lock:
            rec = self._records.get(key)
            if rec is not None:
                rec["calls"] += 1
                measure = False
            else:
                # reserved before the measurement, so a racing call of the
                # same signature only counts
                rec = {"site": site, "signature": sig, "calls": 1,
                       "memory": None, "cost": None, "mode": "pending"}
                self._records[key] = rec
                measure = True
        if not measure:
            return fn(*args, **kwargs)
        try:
            measured, out = measure_call(fn, args, kwargs)
        except BaseException:
            with self._lock:       # the run's own call failed: no record
                self._records.pop(key, None)
            raise
        if self.world_size and "shards" in measured:
            measured["world_size"] = self.world_size
        with self._lock:
            rec.update(measured)
        self._publish(site, rec)
        return out

    def _publish(self, site: str, rec: Dict[str, Any]) -> None:
        temp = rec["temp_bytes"]
        reg = get_registry()
        reg.set(f"mem.device.peak_bytes.{site}", float(rec["peak_bytes"]),
                unit="bytes")
        reg.set(f"mem.device.temp_bytes.{site}", float(temp), unit="bytes")
        rss = process_rss_bytes()
        if rss:
            reg.set("mem.host.rss_bytes", float(rss), unit="bytes")
        get_tracer().counter("mem.device.temp_bytes", **{site: temp})

    # -- host-side gauges --------------------------------------------------

    def observe_host(self, site: str, nbytes: int) -> None:
        """Host-memory gauge for ``site`` (the tiered store's host tier,
        the feeders' staging): ``mem.host.<site>_bytes`` + a trace
        counter."""
        nbytes = int(nbytes)
        with self._lock:
            self._host_bytes[site] = nbytes
        reg = get_registry()
        reg.set(f"mem.host.{site}_bytes", float(nbytes), unit="bytes")
        rss = process_rss_bytes()
        if rss:
            reg.set("mem.host.rss_bytes", float(rss), unit="bytes")
        get_tracer().counter("mem.host_bytes", **{site: nbytes})

    # -- views -------------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._records.values()]

    def host_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._host_bytes)

    def sites(self) -> List[str]:
        with self._lock:
            return sorted({site for site, _ in self._records})

    def site_records(self, prefix: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for (site, _), r in self._records.items()
                    if site.startswith(prefix)]

    def ladder_total_bytes(self, prefix: str = "serve.encode.") -> int:
        """Sum of the peak bytes of every measured serve-ladder bucket (the
        serving device budget); 0 until a bucket is measured."""
        with self._lock:
            return sum(int(r.get("peak_bytes", 0))
                       for (site, _), r in self._records.items()
                       if site.startswith(prefix))

    def snapshot(self) -> Dict[str, Any]:
        """Per-(site, signature) records, host gauges, the serve-ladder
        total and the current RSS: what ``Obs.close()`` writes as the
        ``memory`` event."""
        return {
            "records": self.records(),
            "host_bytes": self.host_bytes(),
            "serve_ladder_peak_bytes": self.ladder_total_bytes(),
            "rss_bytes": process_rss_bytes(),
        }


class NullProbe:
    """The disabled path: calls go straight through, views are empty."""

    enabled = False

    def observe_call(self, site, fn, args, kwargs):
        return fn(*args, **kwargs)

    def observe_host(self, site: str, nbytes: int) -> None:
        pass

    def records(self) -> List[Dict[str, Any]]:
        return []

    def host_bytes(self) -> Dict[str, int]:
        return {}

    def sites(self) -> List[str]:
        return []

    def site_records(self, prefix: str) -> List[Dict[str, Any]]:
        return []

    def ladder_total_bytes(self, prefix: str = "serve.encode.") -> int:
        return 0

    def snapshot(self) -> Dict[str, Any]:
        return {"records": [], "host_bytes": {},
                "serve_ladder_peak_bytes": 0, "rss_bytes": 0}


_NULL_PROBE = NullProbe()
_probe = _NULL_PROBE


def get_probe():
    """The process-wide memory probe (a NullProbe until --mem-probe)."""
    return _probe


def set_probe(probe) -> object:
    """Install ``probe`` process-wide; returns the previous probe."""
    global _probe
    prev = _probe
    _probe = probe
    return prev


def null_probe() -> NullProbe:
    return _NULL_PROBE


class _ProbedCall:
    """Call-through wrapper of one site: binds the process-wide probe at
    call time (so a site built before the probe is installed still
    reports); attributes pass through to the callable."""

    __slots__ = ("site", "_fn")

    def __init__(self, site: str, fn: Callable):
        self.site = site
        self._fn = fn

    def __call__(self, *args, **kwargs):
        p = _probe
        if p.enabled:
            return p.observe_call(self.site, self._fn, args, kwargs)
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def probe_call(site: str, fn: Callable) -> Callable:
    """Hook one callable into the memory probe under ``site`` (the
    counterpart of the reference's ``probe_jit``): train.step,
    dist.train_step, serve.encode.<bucket>, store.migrate, ..."""
    return _ProbedCall(site, fn)
