"""One lock for forward-mode autodiff across threads.

torch keeps the dual level of forward-mode AD (`torch.func.jvp`,
`torch.func.jacfwd`) process-wide: two threads inside it at once fail with
"no level exists" or mix their tangents. Every forward-mode call of the
port runs under `lock`, so the hierarchical mapper's cluster threads can
map concurrently in one process. The lock keeps, per thread, the seconds
spent waiting for it and holding it, so that a caller can tell how much
of a thread's time the serialization costs.
"""

import threading
import time


class _TimedLock:
    """A re-entrant lock that sums, per thread, the seconds spent waiting
    to acquire it and the seconds it was held (outermost hold only)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._local = threading.local()

    def __enter__(self):
        t0 = time.perf_counter()
        self._lock.acquire()
        t1 = time.perf_counter()
        loc = self._local
        depth = getattr(loc, "depth", 0)
        if depth == 0:
            loc.wait_s = getattr(loc, "wait_s", 0.0) + (t1 - t0)
            loc.since = t1
        loc.depth = depth + 1
        return self

    def __exit__(self, *exc):
        loc = self._local
        loc.depth -= 1
        if loc.depth == 0:
            loc.held_s = (getattr(loc, "held_s", 0.0)
                          + time.perf_counter() - loc.since)
        self._lock.release()
        return False

    def thread_seconds(self):
        """(waited, held) seconds of the calling thread so far."""
        loc = self._local
        return getattr(loc, "wait_s", 0.0), getattr(loc, "held_s", 0.0)


lock = _TimedLock()
