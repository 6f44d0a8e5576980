"""The shards of a data-parallel run, and how they talk.

The counterpart of ``shard_map`` and ``jax.lax``'s collectives.  A shard's
code sees one small interface, ``Comm``:

    rank, size
    ppermute(x, shift)   shard r's x arrives at shard (r + shift) % size
    all_to_all(x)        x (size·k, ...): chunk j goes to shard j, and the
                         result's chunk j is what shard j sent here
                         (``jax.lax.all_to_all(x, ax, 0, 0, tiled=True)``)
    all_gather(x)        (size, ...) stacked on a new leading axis
    all_reduce_mean(x)   the mean over the shards, summed in rank order

Each collective takes one tensor or a tuple of tensors (sent together,
returned in the same structure).  Every comm counts the bytes its shard
sends, by the reference's conventions (``src/repro/dist/exchange.py:98-104``):
a ``ppermute`` sends its whole operand, an ``all_to_all`` (size-1)/size
of it, an ``all_gather`` size-1 copies of it.  ``exchange_bytes`` sums the
three; the gradient mean is counted apart (``sent["all_reduce"]``).

Two implementations:

``LocalGroup``  size shards in ONE process, a Python thread each, on one
    device: the port's counterpart of JAX's forced host device count, and
    what the CPU tests and a single card use.  A collective is a
    rendezvous on a ``threading.Barrier``: each shard deposits a private
    copy of what it sends (its send buffer, enqueued before the barrier),
    then takes what it receives.  Every shard enqueues on the same stream
    of the same device, so the barrier's host order is the stream's order.
    A shard that raises aborts the barrier, so the others fail instead of
    waiting; the barrier also times out.
``ProcessGroup``  one shard per process over ``torch.distributed`` (NCCL
    with one card per rank, or gloo on the CPU): ``batch_isend_irecv`` for
    the ring, ``all_to_all_single`` and the list form of ``all_gather``.
    Tensors travel as their bytes, so every dtype goes over either backend.

Both run a shard function with ``run(fn)``: ``fn(i, comm)`` for each shard
this process holds (``i`` its local index), results in local order.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch

EXCHANGE_OPS = ("ppermute", "all_to_all", "all_gather")


def _as_tuple(x):
    return (tuple(x), True) if isinstance(x, (tuple, list)) else ((x,), False)


def _nbytes(xs) -> int:
    return sum(t.numel() * t.element_size() for t in xs)


class Comm:
    """One shard's view of the group (see the module docstring)."""

    rank: int
    size: int

    def __init__(self, rank: int, size: int):
        self.rank = rank
        self.size = size
        self.sent = dict.fromkeys(EXCHANGE_OPS + ("all_reduce",), 0)

    @property
    def exchange_bytes(self) -> int:
        """Bytes this shard sent through ppermute, all_to_all, all_gather."""
        return sum(self.sent[k] for k in EXCHANGE_OPS)

    def reset_counts(self) -> None:
        for k in self.sent:
            self.sent[k] = 0

    # -- counted collectives ------------------------------------------------

    def ppermute(self, x, shift: int = 1):
        xs, many = _as_tuple(x)
        self.sent["ppermute"] += _nbytes(xs)
        out = self._ppermute(xs, shift % self.size)
        return out if many else out[0]

    def all_to_all(self, x):
        xs, many = _as_tuple(x)
        for t in xs:
            if t.shape[0] % self.size:
                raise ValueError(f"all_to_all: leading dim {t.shape[0]} "
                                 f"does not split over {self.size} shards")
        self.sent["all_to_all"] += _nbytes(xs) * (self.size - 1) // self.size
        out = self._all_to_all(xs)
        return out if many else out[0]

    def all_gather(self, x):
        xs, many = _as_tuple(x)
        self.sent["all_gather"] += _nbytes(xs) * (self.size - 1)
        out = self._all_gather(xs)
        return out if many else out[0]

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the shards: the shards' tensors summed in rank order,
        then divided by the shard count, so every shard gets the same
        bits."""
        self.sent["all_reduce"] += _nbytes((x,)) * (self.size - 1)
        parts = self._all_gather((x,))[0]
        acc = parts[0].clone()
        for r in range(1, self.size):
            acc += parts[r]
        return acc / self.size

    # -- transport ------------------------------------------------------------

    def _ppermute(self, xs, shift):
        raise NotImplementedError

    def _all_to_all(self, xs):
        raise NotImplementedError

    def _all_gather(self, xs):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# shards as threads of one process
# ---------------------------------------------------------------------------


class LocalComm(Comm):
    def __init__(self, group: "LocalGroup", rank: int):
        super().__init__(rank, group.size)
        self._group = group
        self._calls = 0

    def _rendezvous(self, op: str, xs):
        """Deposit private copies of ``xs``, wait for every shard, return
        every shard's deposit, in rank order.  Deposits alternate between
        two slot lists: a shard can only deposit call k+1 after every
        shard reached call k, i.e. after each took its call k-1 reads."""
        g = self._group
        slots = g._slots[self._calls % 2]
        self._calls += 1
        slots[self.rank] = (op, tuple(t.clone() for t in xs))
        g._wait()
        got = list(slots)
        ops = {o for o, _ in got}
        if ops != {op}:
            raise RuntimeError(f"shards called different collectives: {ops}")
        return [payload for _, payload in got]

    def _ppermute(self, xs, shift):
        if self.size == 1:
            return xs
        return self._rendezvous("ppermute", xs)[(self.rank - shift)
                                                % self.size]

    def _all_to_all(self, xs):
        if self.size == 1:
            return xs
        got = self._rendezvous("all_to_all", xs)
        out = []
        for i, t in enumerate(xs):
            k = t.shape[0] // self.size
            out.append(torch.cat([got[s][i][self.rank * k:(self.rank + 1) * k]
                                  for s in range(self.size)]))
        return tuple(out)

    def _all_gather(self, xs):
        if self.size == 1:
            return tuple(t[None] for t in xs)
        got = self._rendezvous("all_gather", xs)
        return tuple(torch.stack([got[s][i] for s in range(self.size)])
                     for i in range(len(xs)))


class LocalGroup:
    """``size`` shards as threads of this process, on ``device``.

    ``run(fn)`` starts one thread per shard (the calling thread itself when
    ``size`` is 1), sets the thread's current device and stream (the
    device's default stream, shared by every shard), calls ``fn(rank,
    comm)``, and returns the results in rank order.  A shard that raises
    aborts the barrier, so the others raise ``BrokenBarrierError`` at their
    next collective instead of waiting; ``run`` then raises the first
    shard's own error, and the group refuses further use.  ``timeout``
    bounds every wait on the barrier.
    """

    def __init__(self, size: int, device="cpu", *, timeout: float = 300.0):
        if size < 1:
            raise ValueError(f"a group needs at least one shard, not {size}")
        self.size = size
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.local_ranks = list(range(size))
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots = [[None] * size, [None] * size]
        self.comms = [LocalComm(self, r) for r in range(size)]
        self._broken: Optional[BaseException] = None

    def _wait(self) -> None:
        self._barrier.wait()

    def _enter(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(torch.cuda.default_stream(self.device))

    def run(self, fn: Callable) -> List:
        if self._broken is not None:
            raise RuntimeError("the shard group failed before and cannot "
                               "run again") from self._broken
        if self.size == 1:
            return [fn(0, self.comms[0])]
        results: List = [None] * self.size
        errors: List[Optional[BaseException]] = [None] * self.size

        def shard(rank: int) -> None:
            try:
                self._enter()
                results[rank] = fn(rank, self.comms[rank])
            except BaseException as e:      # re-raised by run() below
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(target=shard, args=(r,),
                                    name=f"shard-{r}", daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            own = [e for e in failed
                   if not isinstance(e, threading.BrokenBarrierError)]
            self._broken = (own or failed)[0]
            raise self._broken
        return results


# ---------------------------------------------------------------------------
# one shard per process (torch.distributed)
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` as a flat uint8 tensor (any dtype, any backend)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _unwire(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    return b.view(like.dtype).reshape(shape)


class ProcessComm(Comm):
    def __init__(self):
        import torch.distributed as dist

        super().__init__(dist.get_rank(), dist.get_world_size())
        self._dist = dist

    def _ppermute(self, xs, shift):
        if self.size == 1:
            return xs
        dist = self._dist
        dst, src = (self.rank + shift) % self.size, (self.rank - shift) % self.size
        out = []
        for t in xs:
            send = _wire(t)
            recv = torch.empty_like(send)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                           dist.P2POp(dist.irecv, recv, src)])
            for r in reqs:
                r.wait()
            out.append(_unwire(recv, t, t.shape))
        return tuple(out)

    def _all_to_all(self, xs):
        if self.size == 1:
            return xs
        out = []
        for t in xs:
            send = _wire(t).reshape(self.size, -1)
            recv = torch.empty_like(send)
            self._dist.all_to_all_single(recv, send)
            out.append(_unwire(recv, t, t.shape))
        return tuple(out)

    def _all_gather(self, xs):
        if self.size == 1:
            return tuple(t[None] for t in xs)
        out = []
        for t in xs:
            send = _wire(t)
            recv = [torch.empty_like(send) for _ in range(self.size)]
            self._dist.all_gather(recv, send)
            out.append(torch.stack([_unwire(r, t, t.shape) for r in recv]))
        return tuple(out)


class ProcessGroup:
    """This process's one shard of a ``torch.distributed`` group (already
    initialised by the caller, e.g. under ``torchrun``), on ``device``."""

    def __init__(self, device="cpu"):
        self.comms = [ProcessComm()]
        self.size = self.comms[0].size
        self.device = torch.device(device)
        self.local_ranks = [self.comms[0].rank]

    def run(self, fn: Callable) -> List:
        return [fn(0, self.comms[0])]
