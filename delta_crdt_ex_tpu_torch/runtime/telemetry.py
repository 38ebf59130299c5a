"""Telemetry — the observability surface (reference: one ``:telemetry`` event).

The reference fires ``[:delta_crdt, :sync, :done]`` with
``%{keys_updated_count: n}`` and ``%{name: name}`` on **every** merge —
local ops and remote deltas alike (``causal_crdt.ex:396-398``). Same
contract here, plus the capacity-growth, sync-round, ingress-coalescing
and fleet dispatch/egress events, under the same attach/execute API.
The events of later slices (WAL, serving, …) come with them.

The PyTorch port's own copy of ``delta_crdt_ex_tpu/runtime/telemetry.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable

SYNC_DONE = ("delta_crdt", "sync", "done")  # measurements: keys_updated_count
CAPACITY_GROWN = ("delta_crdt", "capacity", "grown")  # measurements: capacity, replica_capacity
SYNC_ROUND = ("delta_crdt", "sync", "round")  # measurements: duration_s, buckets, entries; metadata: name, plane
INGEST_COALESCE = ("delta_crdt", "ingest", "coalesce")  # measurements: depth, rows, entries, duration_s; metadata: name
FLEET_DISPATCH = ("delta_crdt", "fleet", "dispatch")  # measurements: replicas, lanes, messages, rows, padded_rows, duration_s; metadata: fleet
FLEET_EGRESS = ("delta_crdt", "fleet", "egress")  # measurements: members, jobs_batched, jobs_solo, dispatches, duration_s; metadata: fleet

_lock = threading.Lock()
#: event -> handler tuple. Handler tables are REPLACED, never mutated
#: in place (copy-on-write under ``_lock``), so ``execute`` can iterate
#: the tuple it read without copying it first — one hot-path
#: allocation per event gone, and a concurrent attach/detach never
#: mutates a tuple an ``execute`` is mid-iteration over.
_handlers: dict[tuple, tuple[Callable, ...]] = defaultdict(tuple)


def attach(event: tuple, handler: Callable[[tuple, dict, dict], None]) -> None:
    with _lock:
        _handlers[event] = _handlers[event] + (handler,)


def detach(event: tuple, handler: Callable) -> None:
    with _lock:
        table = _handlers.get(event, ())
        if handler in table:
            i = table.index(handler)  # first occurrence, like list.remove
            _handlers[event] = table[:i] + table[i + 1:]


def has_handlers(event: tuple) -> bool:
    with _lock:
        return bool(_handlers.get(event))


def execute(event: tuple, measurements: dict, metadata: dict) -> None:
    with _lock:
        handlers = _handlers.get(event, ())
    for h in handlers:
        h(event, measurements, metadata)


def execute_many(event: tuple, measurements_list: list, metadata: dict) -> None:
    """One event per element of ``measurements_list`` (shared
    ``metadata``), in order, handler by handler: each handler sees the
    stream ``execute`` in a loop would deliver."""
    with _lock:
        handlers = _handlers.get(event, ())
    for h in handlers:
        for meas in measurements_list:
            h(event, meas, metadata)
