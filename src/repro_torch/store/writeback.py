"""Async device->host write-back lane of the tiered store.

Counterpart of ``src/repro/store/writeback.py`` (numpy and a thread, so a
copy, not an import: the port imports nothing of the JAX package).  A FIFO
thunk executor on a daemon thread that ``store/tiered.py`` submits eviction
write-backs to, so waiting for the device->host copy and writing the host
tier overlap with the running step instead of sitting on the critical
path.  ``delta_gate`` is the FreshGNN write-back admission rule.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np


def delta_gate(emb_new, emb_old, init_new, init_old,
               threshold: float) -> np.ndarray:
    """FreshGNN write-back admission: which evicted rows are WORTH writing
    back to the host tier.

    Returns a (n,) bool mask over the leading row axis: True where the
    row's embedding moved by at least ``threshold`` (max-abs over the
    row's elements) since it last left the host tier, or where any
    initialized flag flipped (a first write or an invalidation must never
    be dropped, whatever its magnitude).  Rows gated out keep their stale
    host copy — the same staleness the GST paper already models with SED,
    now bounded by the threshold instead of one refresh period.
    """
    emb_new = np.asarray(emb_new)
    delta = np.max(np.abs(emb_new - np.asarray(emb_old)),
                   axis=tuple(range(1, emb_new.ndim)))
    init_new = np.asarray(init_new)
    flipped = np.any(init_new != np.asarray(init_old),
                     axis=tuple(range(1, init_new.ndim)))
    return (delta >= threshold) | flipped


class AsyncHostWriter:
    """FIFO thunk executor on a daemon thread.

    ``submit`` returns a monotonically increasing ticket; ``wait(ticket)``
    blocks until that submission (and everything before it — FIFO) has run.
    Exceptions raised by a thunk are re-raised on the next wait()/flush()
    so a failed write-back cannot be silently dropped.
    """

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._submitted = 0
        self._done = 0
        self._exc: Optional[BaseException] = None
        self._closed = False
        self.wait_ms = 0.0          # consumer time blocked in wait()/flush()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except BaseException as e:  # surfaced on the next wait()
                with self._cv:
                    if self._exc is None:
                        self._exc = e
            with self._cv:
                self._done += 1
                self._cv.notify_all()

    def submit(self, fn: Callable[[], None]) -> int:
        if self._closed:
            raise RuntimeError("AsyncHostWriter is closed")
        with self._cv:
            self._submitted += 1
            ticket = self._submitted
        self._q.put(fn)
        return ticket

    def wait(self, ticket: int) -> None:
        t0 = time.perf_counter()
        with self._cv:
            while self._done < ticket and self._exc is None:
                self._cv.wait(timeout=0.05)
            exc, self._exc = self._exc, None
        self.wait_ms += (time.perf_counter() - t0) * 1e3
        if exc is not None:
            raise exc

    def flush(self) -> None:
        """Wait for every submitted thunk to finish."""
        with self._cv:
            ticket = self._submitted
        self.wait(ticket)

    @property
    def pending(self) -> int:
        with self._cv:
            return self._submitted - self._done

    def close(self) -> None:
        """Drain and stop the thread.  Never raises — close() runs in
        callers' finally blocks and must not mask their exception; thunk
        errors surface through wait()/flush() during operation."""
        if self._closed:
            return
        self._closed = True
        try:
            self.flush()
        except BaseException:
            pass
        finally:
            self._q.put(None)
            self._thread.join(timeout=5.0)
