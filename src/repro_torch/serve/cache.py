"""Thread-safe bounded LRU cache — tier 1 of the advisor service (the
port's copy of ``repro.serve.cache``; no tensors involved).

A deliberately tiny primitive: one ``OrderedDict`` guarded by one lock.
The service's hit path is ``get`` → return the cached
:class:`~repro_torch.serve.service.Advice` object itself — no copy, no new answer object, no
per-hit heap traffic beyond the interpreter's call frames (the value was
allocated once, on the miss that computed it).  ``move_to_end`` keeps the
recency order without reinserting, so a hit never triggers an eviction
sweep either.

Also reused to bound the service's per-``(machine, budget)`` placement
tables, which would otherwise grow per distinct query shape for the life
of the process.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable


class LRUCache:
    """Bounded thread-safe LRU mapping.

    ``get`` refreshes recency; ``put`` inserts (or refreshes) and evicts
    the least-recently-used entry past ``capacity``.  All operations are
    O(1) under a single non-reentrant lock — the critical sections never
    call out, so the lock cannot be held across user code.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._data: OrderedDict[Hashable, Any] = OrderedDict()

    def get(self, key: Hashable, default: Any = None) -> Any:
        """Return the cached value (refreshing its recency) or ``default``."""
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                return default
            self._data.move_to_end(key)
            return value

    def put(self, key: Hashable, value: Any) -> None:
        """Insert/refresh a key, evicting least-recent entries over capacity."""
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._data

    def keys(self) -> list:
        """Snapshot of the keys, oldest first (for tests/introspection)."""
        with self._lock:
            return list(self._data.keys())
