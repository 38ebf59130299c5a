"""Public API facade of the PyTorch port — parity with ``DeltaCrdt``
(``lib/delta_crdt.ex``) and with ``delta_crdt_ex_tpu/api.py``:
``start_link``, ``set_neighbours``, ``mutate``, ``mutate_async``,
``mutate_batch``, ``read``, ``read_keys``.

Example (the reference doctest flow on the hash store)::

    crdt1 = start_link(AWLWWMap, store="hash", sync_interval=0.003)
    crdt2 = start_link(AWLWWMap, store="hash", sync_interval=0.003)
    set_neighbours(crdt1, [crdt2])
    set_neighbours(crdt2, [crdt1])
    mutate(crdt1, "add", ["CRDT", "is magic!"])
    ...
    read(crdt2)  # {'CRDT': 'is magic!'}

Replicas keep their state on ``device`` — ``"cuda"`` unless the caller
asks for the CPU — and raise when CUDA is absent.
"""

from __future__ import annotations

from typing import Any

from delta_crdt_ex_tpu_torch.models.hash_store import HashAWLWWMap
from delta_crdt_ex_tpu_torch.runtime.replica import Replica

DEFAULT_SYNC_INTERVAL = 0.2  # seconds (reference: 200 ms, delta_crdt.ex:31)
DEFAULT_MAX_SYNC_SIZE = 200  # items (reference: delta_crdt.ex:32)
#: default call timeout (see ``delta_crdt_ex_tpu/api.py``)
DEFAULT_TIMEOUT = 30.0

DeltaCrdt = Replica  # the handle type users hold


def _resolve_store(crdt_module, store: "str | None"):
    """The model class for the requested dot-store backend. Only the
    hash store is ported: ``store="hash"`` is required, and the default
    (binned) store raises until its slice lands."""
    if store not in (None, "hash", "binned"):
        raise ValueError(f"unknown store backend {store!r}; use 'hash' or 'binned'")
    if store != "hash":
        raise NotImplementedError(
            "binned store not yet ported to PyTorch; pass store='hash' "
            "(the binned store comes with the next slice)"
        )
    if crdt_module is not HashAWLWWMap:
        raise ValueError(f"{crdt_module!r} has no ported hash-store model; use AWLWWMap")
    return crdt_module


#: the AWLWWMap model — in this port only its hash-store form exists
AWLWWMap = HashAWLWWMap


def start_link(
    crdt_module=AWLWWMap,
    *,
    threaded: bool = True,
    store: "str | None" = None,
    **opts,
) -> Replica:
    """Start a replica (reference ``DeltaCrdt.start_link/2``) on the
    hash store (``store="hash"``). ``threaded=False`` leaves driving to the caller (``sync_to_all()`` +
    ``transport.pump()``). ``device`` defaults to ``"cuda"``."""
    opts.setdefault("sync_interval", DEFAULT_SYNC_INTERVAL)
    opts.setdefault("max_sync_size", DEFAULT_MAX_SYNC_SIZE)
    replica = Replica(_resolve_store(crdt_module, store), **opts)
    if threaded:
        replica.start()
    return replica


def set_neighbours(crdt: Replica, neighbours: list) -> None:
    """One-way sync edges; call symmetrically for bidirectional sync."""
    crdt.set_neighbours(neighbours)


def mutate(crdt: Replica, f: str, args: list, timeout: float = DEFAULT_TIMEOUT) -> None:
    crdt.mutate(f, args, timeout)


def mutate_async(crdt: Replica, f: str, args: list) -> None:
    crdt.mutate_async(f, args)


def mutate_batch(crdt: Replica, f: str, items: list, timeout: float = DEFAULT_TIMEOUT) -> None:
    """Bulk mutation: one ``f`` op per ``items`` entry, applied in order."""
    crdt.mutate_batch(f, items, timeout)


def read(crdt: Replica, timeout: float = DEFAULT_TIMEOUT) -> "dict[Any, Any]":
    return crdt.read(timeout)


def read_keys(crdt: Replica, keys: list) -> "dict[Any, Any]":
    """Partial read (reference ``AWLWWMap.read/2``)."""
    return crdt.read_keys(keys)
