"""LWW timestamp source.

The reference stamps adds with ``System.monotonic_time(:nanosecond)``
(``aw_lww_map.ex:104``) — monotonic per BEAM node, arbitrary offset, so
cross-replica LWW order is essentially meaningless there (SURVEY §7
"Hard parts"). We keep the per-replica monotonicity contract but base the
clock on wall time so cross-replica LWW is at least wall-clock sensible,
and guarantee strict per-replica increase (ties are impossible within a
replica). Deterministic logical clocks are injectable for tests.

The PyTorch port's own copy of ``delta_crdt_ex_tpu/runtime/clock.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import time

import numpy as np


class Clock:
    """Strictly increasing nanosecond timestamps, wall-clock based."""

    def __init__(self, start: int | None = None):
        self._last = int(start or 0)

    def next(self) -> int:
        now = time.time_ns()
        self._last = now if now > self._last else self._last + 1
        return self._last

    def next_n(self, n: int) -> np.ndarray:
        """``n`` strictly increasing stamps in one call (the bulk flush
        path) — consecutive from max(now, last+1), so interleaving with
        ``next()`` keeps the strict global order."""
        now = time.time_ns()
        start = now if now > self._last else self._last + 1
        out = start + np.arange(n, dtype=np.int64)
        if n:
            self._last = int(out[-1])
        return out


class LogicalClock(Clock):
    """Deterministic test clock: 1, 2, 3, …"""

    def next(self) -> int:
        self._last += 1
        return self._last

    def next_n(self, n: int) -> np.ndarray:
        out = self._last + 1 + np.arange(n, dtype=np.int64)
        self._last += n
        return out
