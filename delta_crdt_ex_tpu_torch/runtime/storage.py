"""Persistence behaviour (reference ``DeltaCrdt.Storage``, ``storage.ex:15-16``).

The PyTorch port's own copy of ``delta_crdt_ex_tpu/runtime/storage.py``
(the port imports nothing of the JAX package).

Contract: ``write(name, snapshot)`` / ``read(name) -> snapshot | None``.
The snapshot carries everything needed for dot-counter continuity across
a crash-restart (reference stores ``{node_id, sequence_number, crdt_state,
merkle_map}``, ``causal_crdt.ex:242-250``).

The replica runtime supports ``storage_mode="every_op"`` (the reference's
write-through on every state change, ``causal_crdt.ex:402-403``) and
``storage_mode="interval"`` (an async snapshot cadence).

Snapshots are pickles, so a pickle names its ``Snapshot`` class by
module path. The port writes its own path
(``delta_crdt_ex_tpu_torch.runtime.storage.Snapshot``), which the JAX
package reads with a plain ``pickle.load``. Reading a snapshot the JAX
package wrote must not import the JAX package, so the port's readers
(:func:`loads`, :func:`load`) map that one class path,
``delta_crdt_ex_tpu.runtime.storage.Snapshot``, to the port's own
:class:`Snapshot` and refuse every other name under the JAX package.
The ``arrays`` hold the JAX package's column dtypes and field order
either way, so both packages read both.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import threading
from typing import Any, Protocol

import numpy as np


#: engine layout written by the current replica runtime; bumped whenever
#: the column set / array shapes change incompatibly
CURRENT_LAYOUT = "binned-v2"  # v2: payload dots keyed (gid, bucket, ctr); per-bucket counters


@dataclasses.dataclass
class Snapshot:
    """Host-side image of a replica: state columns + host dictionaries."""

    node_id: int  # dot-namespace continuity across restarts
    sequence_number: int  # number of applied mutation batches
    arrays: dict[str, np.ndarray]  # DotStore columns + ctx tables (JAX dtypes)
    payloads: dict[tuple[int, int, int], tuple[Any, Any]]  # (gid, bucket, ctr) -> (key_term, value)
    key_terms: dict[int, Any]  # key hash -> key term
    last_ts: int  # clock continuity (LWW monotonicity)
    layout: str = CURRENT_LAYOUT  # engine layout tag (rehydrate checks it)
    #: per-peer applied watermarks (addr -> that peer's seq this replica
    #: fully covered when the snapshot was cut); legacy pickles lack the
    #: field (read via ``__dict__.get``)
    peer_seqs: dict | None = None
    #: dot-store backend that wrote ``arrays`` ("binned", the default
    #: for untagged pickles, or "hash"); rehydrate rejects a mismatch
    store: str = "binned"


#: the JAX package's class path for :class:`Snapshot`
_JAX_SNAPSHOT = ("delta_crdt_ex_tpu.runtime.storage", "Snapshot")


class _Unpickler(pickle.Unpickler):
    """Unpickler that reads the JAX package's ``Snapshot`` as the port's
    and imports nothing else of the JAX package."""

    def find_class(self, module: str, name: str):
        if (module, name) == _JAX_SNAPSHOT:
            return Snapshot
        if module.split(".")[0] == "delta_crdt_ex_tpu":
            raise pickle.UnpicklingError(
                f"refusing to load {module}.{name}: only the JAX package's "
                "Snapshot class maps onto the PyTorch port"
            )
        return super().find_class(module, name)


def load(f) -> Any:
    """``pickle.load`` for snapshots of either package."""
    return _Unpickler(f).load()


def loads(blob: bytes) -> Any:
    """``pickle.loads`` for snapshots of either package."""
    return load(io.BytesIO(blob))


def require_layout(tag, what: str) -> None:
    """Reject snapshots written by a different engine layout with one
    shared, descriptive error. ``tag`` must come from the snapshot's
    instance data (read ``__dict__``, not ``getattr``: a dataclass
    default would mask a legacy untagged pickle)."""
    if tag != CURRENT_LAYOUT:
        raise ValueError(
            f"{what} was written by engine layout {tag!r}; this build "
            f"reads {CURRENT_LAYOUT!r} — migrate or delete the stored "
            "snapshot to start fresh"
        )


def fsync_dir(directory: str) -> None:
    """fsync a directory so entry creations/renames/unlinks inside it
    survive power loss (fsyncing a file does NOT persist its dirent)."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def name_key(name: Any) -> str:
    """Stable filesystem-safe key for a replica name (shared by
    :class:`FileStorage` snapshot paths and the WAL's per-replica
    segment directories, so the two stay colocatable)."""
    import hashlib

    return hashlib.blake2b(repr(name).encode(), digest_size=8).hexdigest()


class Storage(Protocol):
    def write(self, name: Any, snapshot: Snapshot) -> None: ...

    def read(self, name: Any) -> Snapshot | None: ...


class MemoryStorage:
    """In-memory store (reference test fixture ``memory_storage.ex``) —
    process-global so a restarted replica with the same name rehydrates."""

    _store: dict[Any, bytes] = {}
    _lock = threading.Lock()

    def write(self, name, snapshot: Snapshot) -> None:
        with self._lock:
            MemoryStorage._store[name] = pickle.dumps(snapshot)

    def read(self, name) -> Snapshot | None:
        with self._lock:
            blob = MemoryStorage._store.get(name)
        return loads(blob) if blob is not None else None

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._store.clear()


class FileStorage:
    """Directory-backed store: one pickle per replica name.

    ``fsync=True`` makes each write power-loss durable (file contents
    fsynced before the rename, directory entry fsynced after) — required
    when the snapshot is a WAL compaction checkpoint, because compaction
    DELETES the fsynced log records the snapshot supersedes. The default
    stays False: the plain ``every_op`` snapshot path never promised
    machine-crash durability."""

    def __init__(self, directory: str, *, fsync: bool = False):
        self.directory = directory
        self.fsync = fsync
        self._dir_synced = False  # own dirent persisted in the parent
        os.makedirs(directory, exist_ok=True)

    def _path(self, name) -> str:
        return os.path.join(self.directory, f"crdt_{name_key(name)}.pkl")

    def write(self, name, snapshot: Snapshot) -> None:
        tmp = self._path(name) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(snapshot, f)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self._path(name))
        if self.fsync:
            fsync_dir(self.directory)
            if not self._dir_synced:
                # a freshly created snapshot dir's own dirent must reach
                # disk too, or power loss vanishes the directory whole
                fsync_dir(os.path.dirname(self.directory) or ".")
                self._dir_synced = True

    def read(self, name) -> Snapshot | None:
        try:
            with open(self._path(name), "rb") as f:
                return load(f)
        except FileNotFoundError:
            return None
