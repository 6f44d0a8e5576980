"""Launch counts of the port's kernels, safe to bump from several threads.

The distributed trainer runs its shards as threads of one process
(``dist/comm.py::LocalGroup``), each launching the same kernels; a plain
``dict[key] += 1`` from several threads can lose counts, so every wrapper
counts through ``LaunchCounts.add``, which holds one lock.
"""
from __future__ import annotations

import threading
from typing import Iterable

_LOCK = threading.Lock()


class LaunchCounts(dict):
    """``{kernel name: launches}``; ``add`` and ``reset`` hold a lock."""

    def __init__(self, names: Iterable[str]):
        super().__init__((name, 0) for name in names)

    def add(self, name: str) -> None:
        with _LOCK:
            self[name] += 1

    def reset(self) -> None:
        with _LOCK:
            for name in self:
                self[name] = 0
