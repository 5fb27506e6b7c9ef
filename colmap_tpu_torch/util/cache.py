"""LRU caches (plain / memory-constrained / thread-safe).

Copy of colmap_tpu/util/cache.py (reference: src/colmap/util/cache.h:48,
93, 139), used by the MVS workspace. Host-side only.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Generic, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    def __init__(self, max_num_elems: int, getter: Callable[[K], V]):
        assert max_num_elems > 0
        self.max_num_elems = max_num_elems
        self._getter = getter
        self._elems: OrderedDict = OrderedDict()

    def __len__(self) -> int:
        return len(self._elems)

    def exists(self, key: K) -> bool:
        return key in self._elems

    def get(self, key: K) -> V:
        if key in self._elems:
            self._elems.move_to_end(key)
            return self._elems[key]
        value = self._getter(key)
        self.set(key, value)
        return value

    def set(self, key: K, value: V):
        self._elems[key] = value
        self._elems.move_to_end(key)
        while len(self._elems) > self.max_num_elems:
            self._evict_one()

    def _evict_one(self):
        self._elems.popitem(last=False)

    def pop(self, key: K):
        self._elems.pop(key, None)

    def clear(self):
        self._elems.clear()


class MemoryConstrainedLRUCache(LRUCache):
    """Evicts by total memory instead of element count
    (reference: util/cache.h:139). `sizer(value)` returns bytes."""

    def __init__(self, max_num_bytes: int, getter: Callable,
                 sizer: Callable = None):
        super().__init__(max_num_elems=2**62, getter=getter)
        self.max_num_bytes = max_num_bytes
        self._sizer = sizer or (lambda v: getattr(v, "nbytes", 1))
        self._num_bytes = 0
        self._sizes = {}

    @property
    def num_bytes(self) -> int:
        return self._num_bytes

    def set(self, key, value):
        if key in self._elems:
            self._num_bytes -= self._sizes.pop(key, 0)
        size = int(self._sizer(value))
        self._elems[key] = value
        self._elems.move_to_end(key)
        self._sizes[key] = size
        self._num_bytes += size
        while self._num_bytes > self.max_num_bytes and len(self._elems) > 1:
            self._evict_one()

    def _evict_one(self):
        key, _ = self._elems.popitem(last=False)
        self._num_bytes -= self._sizes.pop(key, 0)

    def pop(self, key):
        if key in self._elems:
            self._num_bytes -= self._sizes.pop(key, 0)
            del self._elems[key]

    def clear(self):
        super().clear()
        self._sizes.clear()
        self._num_bytes = 0


class ThreadSafeLRUCache(Generic[K, V]):
    """Reference: util/cache.h:93 — mutex-guarded LRU."""

    def __init__(self, max_num_elems: int, getter: Callable[[K], V]):
        self._cache = LRUCache(max_num_elems, getter)
        self._mutex = threading.Lock()

    def __len__(self):
        with self._mutex:
            return len(self._cache)

    def get(self, key: K) -> V:
        with self._mutex:
            return self._cache.get(key)

    def set(self, key: K, value: V):
        with self._mutex:
            self._cache.set(key, value)

    def exists(self, key: K) -> bool:
        with self._mutex:
            return self._cache.exists(key)
