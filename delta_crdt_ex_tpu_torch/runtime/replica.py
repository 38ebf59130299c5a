"""Replica driver — the host actor owning one device-resident CRDT state;
the PyTorch port of ``delta_crdt_ex_tpu/runtime/replica.py``, on either
dot store: the bucket-binned store (``BinnedAWLWWMap``, the default
model, and ``AWSet``) or the open-addressing hash store
(``HashAWLWWMap``, ``HashAWSet``).

Counterpart of the reference's ``DeltaCrdt.CausalCrdt`` GenServer: the
driver serialises every state transition through a lock and issues
batched torch calls against the state on ``device``. What this slice
carries, line for line the JAX replica's semantics:

- ``mutate`` / ``mutate_async`` / ``mutate_batch`` → a queued mutation
  batch flushed before any read or sync;
- the ``on_diffs`` change feed with the reference's emission rules (on
  the hash store the before/after winner passes go through the
  probe-window kernel);
- ``read`` (incrementally maintained read cache) / ``read_keys`` /
  ``read_items`` / ``canonical_state_bytes``;
- anti-entropy: eager own-delta pushes, full-row pushes of kill-touched
  rows, and the digest-tree walk with ≤ 1 in-flight round per
  neighbour, over the same wire messages as the JAX package;
- ingress coalescing: ``process_pending`` drains the mailbox in
  bounded batches and joins each run of compatible ``EntriesMsg``s
  with one grouped merge, ``SYNC_DONE`` readbacks deferred to the end
  of the drain;
- neighbour monitoring, host payload gc, ``SYNC_DONE`` /
  ``SYNC_ROUND`` / ``CAPACITY_GROWN`` / ``INGEST_COALESCE`` telemetry,
  the threaded loop;
- the fleet hooks (``fleet_prepare`` / ``fleet_commit`` /
  ``fleet_handle_group``, the lazily materialised ``state`` of a
  fleet-held lane, the egress plan/extract/emit split) that
  :mod:`delta_crdt_ex_tpu_torch.runtime.fleet` drives.

WAL and storage, log shipping, tree gossip, serving, the observability
plane, fault injection and the device mesh wait for later slices: their
options raise ``NotImplementedError`` naming the slice
(:data:`LATER_OPTIONS`). Sync slices always travel on the host
plane (numpy ``EntriesMsg`` bodies in the JAX package's dtypes), so the
wire stays the JAX package's and every one of them may coalesce.
"""

from __future__ import annotations

import logging
import secrets
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import pow2_tier, pow4_tier
from delta_crdt_ex_tpu_torch.models.binned_map import BinnedAWLWWMap, CtxGapError
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_CLEAR, OP_PAD, OP_REMOVE
from delta_crdt_ex_tpu_torch.ops.binned import _i64, slice_from_wire, wire_from_host
from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, telemetry, transition
from delta_crdt_ex_tpu_torch.runtime.clock import Clock
from delta_crdt_ex_tpu_torch.runtime.transport import Down, LocalTransport, default_transport
from delta_crdt_ex_tpu_torch.utils import transfers
from delta_crdt_ex_tpu_torch.utils.hashing import (
    key_hash64,
    key_hash64_batch,
    value_hash32,
    value_hash32_batch,
)
from delta_crdt_ex_tpu_torch.utils.transfers import as_u32, as_u64

logger = logging.getLogger("delta_crdt_ex_tpu_torch")

_SLICE_COLUMNS = ("key", "valh", "ts", "node", "ctr", "alive")

# audited device↔host transfer sites (the JAX replica's labels)
_TR_DIGEST_LEVELS = transfers.register("replica.digest_levels")
_TR_READ_KEYS = transfers.register("replica.read_keys")
_TR_APPLY_COUNTS = transfers.register("replica.apply_counts")
_TR_INGEST_COUNTS = transfers.register("replica.ingest_counts")
_TR_DIFF_WINNERS = transfers.register("replica.diff_winners")
_TR_WINNER_ALL = transfers.register("replica.winner_all")
_TR_WINNER_ROWS = transfers.register("replica.winner_rows")
_TR_CANONICAL_STATE = transfers.register("replica.canonical_state")
_TR_OWN_CTR_CACHE = transfers.register("replica.own_ctr_cache")
_TR_SLICE_PAYLOAD_DOTS = transfers.register("replica.slice_payload_dots")
_TR_SLICE_WIRE = transfers.register("replica.slice_wire")
_TR_GC_SCAN = transfers.register("replica.gc_scan")
_TR_DRAIN_ACCOUNTING = transfers.register("replica.drain_accounting")

#: JAX-replica options this port does not implement yet → the later
#: slice that brings them (``ROADMAP.md`` queue 1) and the value that
#: leaves the feature off (passing that value is accepted; ``...`` =
#: the option only tunes an unported feature, so any value raises)
LATER_OPTIONS = {
    "storage_module": ("WAL and storage", None),
    "storage_mode": ("WAL and storage", ...),
    "wal_dir": ("WAL and storage", None),
    "fsync_mode": ("WAL and storage", ...),
    "segment_bytes": ("WAL and storage", ...),
    "compact_every": ("WAL and storage", ...),
    "checkpoint_interval": ("WAL and storage", ...),
    "membership_compaction": ("WAL and storage", False),
    "membership_retain": ("WAL and storage", ...),
    "log_shipping": ("WAL, storage and log shipping", False),
    "catchup_chunk_rows": ("WAL, storage and log shipping", ...),
    "catchup_suffix_ratio": ("WAL, storage and log shipping", ...),
    "tree_gossip": ("tree gossip", False),
    "tree_fanout": ("tree gossip", ...),
    "tree_seed": ("tree gossip", ...),
    "tree_degrade_ratio": ("tree gossip", ...),
    "tree_group": ("tree gossip", None),
    "obs": ("serving and observability", None),
    "flight_dump_path": ("serving and observability", None),
}


def _check_later(opts: dict) -> None:
    for name, value in opts.items():
        if name not in LATER_OPTIONS:
            raise TypeError(f"Replica() got an unexpected keyword argument {name!r}")
        slice_name, off = LATER_OPTIONS[name]
        if off is ... or value is not off and value != off:
            raise NotImplementedError(
                f"option {name}={value!r} is not ported to PyTorch yet; it "
                f"comes with the {slice_name} slice (ROADMAP.md queue 1)"
            )


def _pow2(n: int, floor: int = 8) -> int:
    return pow2_tier(n, floor)


def _wire(n: int, floor: int = 8) -> int:
    return pow4_tier(n, floor)


def resolve_device(device) -> torch.device:
    """The torch device a replica keeps its state on. CUDA is the
    default and must be present: a replica never falls back to the CPU
    on its own (pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the PyTorch port runs on the GPU by "
            "default; pass device='cpu' to run it on the CPU"
        )
    return dev


class _LazyLevels:
    """Digest-tree levels, device-resident, host-materialised per level
    on first access (as uint32 numpy — the wire dtype of ``DiffMsg``
    blocks)."""

    __slots__ = ("_dev", "_host")

    def __init__(self, levels: list) -> None:
        self._dev = levels
        self._host: list[np.ndarray | None] = [None] * len(levels)

    def __len__(self) -> int:
        return len(self._dev)

    def __getitem__(self, level: int) -> np.ndarray:
        h = self._host[level]
        if h is None:
            h = self._host[level] = as_u32(_TR_DIGEST_LEVELS.get(self._dev[level]))
        return h


class _StackedLevels:
    """Digest-tree levels for a whole fleet egress bucket, built by ONE
    batched call (``transition.fleet_tree_from_leaves``): level j is
    ``[N, 2^j]``. Host copies are per LEVEL and shared by every member
    lane: the openers' top ``levels_per_round`` levels come over in one
    transfer, and a deep walk by any member fetches that level for all."""

    __slots__ = ("_dev", "_host")

    def __init__(self, levels: list) -> None:
        self._dev = levels
        self._host: list[np.ndarray | None] = [None] * len(levels)

    def __len__(self) -> int:
        return len(self._dev)

    def prefetch(self, upto: int) -> None:
        """Fetch levels ``0..upto`` (inclusive, clamped) with one
        transfer — the openers' whole working set."""
        upto = min(upto, len(self._dev) - 1)
        want = [j for j in range(upto + 1) if self._host[j] is None]
        if not want:
            return
        got = _TR_DIGEST_LEVELS.get([self._dev[j] for j in want])
        for j, arr in zip(want, got):
            self._host[j] = as_u32(arr)

    def lane_level(self, level: int, lane: int) -> np.ndarray:
        h = self._host[level]
        if h is None:
            h = self._host[level] = as_u32(_TR_DIGEST_LEVELS.get(self._dev[level]))
        return h[lane]


class _LaneLevels:
    """One member's view of a :class:`_StackedLevels`: indexes and
    ``len()`` as :class:`_LazyLevels` does, bit-identical to the
    member's solo tree."""

    __slots__ = ("_stack", "_lane")

    def __init__(self, stack: _StackedLevels, lane: int) -> None:
        self._stack = stack
        self._lane = lane

    def __len__(self) -> int:
        return len(self._stack)

    def __getitem__(self, level: int) -> np.ndarray:
        return self._stack.lane_level(level, self._lane)


class _PushJob:
    """One planned eager-push extraction: the rows / interval bounds to
    gather and the peers the resulting slice fans out to. Planning,
    extraction and emission are separate steps so a fleet can run many
    members' extractions as one batched call between a member's plan
    and its emit."""

    __slots__ = ("kind", "rows", "lo", "pending", "peers", "advance", "new_cursor")

    def __init__(self, kind, rows, lo, pending, peers, advance=None, new_cursor=0):
        self.kind = kind  # "delta" (own-interval) | "rows" (kill-touched)
        self.rows = rows  # int32[U] bucket rows, -1 pads (wire tier)
        self.lo = lo  # uint32[U] interval lower bounds ("delta" only)
        self.pending = pending  # real bucket indices
        self.peers = peers  # "delta": [(addr, cursor array)]; "rows": [addr]
        self.advance = advance  # "delta": own counters to advance cursors to
        self.new_cursor = new_cursor  # "rows": touch-seq cursor after this push


class Replica:
    def __init__(
        self,
        crdt_module=BinnedAWLWWMap,
        *,
        name: Any = None,
        node_id: int | None = None,
        sync_interval: float = 0.2,
        max_sync_size: int | str = 200,
        on_diffs: Callable | tuple | None = None,
        transport: LocalTransport | None = None,
        clock: Clock | None = None,
        capacity: int = 1024,
        replica_capacity: int = 8,
        tree_depth: int = 12,
        levels_per_round: int = 8,
        sync_timeout: float | None = None,
        eager_deltas: bool = True,
        ingress_coalesce: bool = True,
        max_coalesce: int = 16,
        ingress_batch: int = 256,
        gc_interval_ops: int = 4096,
        device="cuda",
        **later,
    ):
        _check_later(later)
        if max_sync_size == "infinite":
            self.max_sync_size: float = float("inf")
        elif isinstance(max_sync_size, int) and not isinstance(max_sync_size, bool) and max_sync_size > 0:
            self.max_sync_size = max_sync_size
        else:
            raise ValueError(f"{max_sync_size!r} is not a valid max_sync_size")

        self.device = resolve_device(device)
        self.model = crdt_module
        self.name = name if name is not None else f"crdt-{secrets.token_hex(6)}"
        self.sync_interval = sync_interval
        self.on_diffs = on_diffs
        self.tree_depth = tree_depth
        self.num_buckets = 1 << tree_depth
        self.levels_per_round = levels_per_round
        self.transport = transport or default_transport()
        self.clock = clock or Clock()
        # in-flight sync slots expire (a lost message must not stall the
        # edge forever on a lossy transport)
        self.sync_timeout = (
            sync_timeout if sync_timeout is not None else max(10 * sync_interval, 2.0)
        )
        self.eager_deltas = eager_deltas
        #: ingress coalescing: ``process_pending`` drains at most
        #: ``ingress_batch`` messages a batch and joins each run of
        #: compatible ``EntriesMsg``s, at most ``max_coalesce`` deep,
        #: with one grouped merge; the counters feed ``stats()["ingress"]``
        self.ingress_coalesce = bool(ingress_coalesce)
        self.max_coalesce = int(max_coalesce)
        self.ingress_batch = int(ingress_batch)
        self._coalesce_depths: dict[int, int] = {}
        self._ingress_messages = 0
        self._ingress_dispatches = 0
        self._ingress_gap_fallbacks = 0
        self._ingress_gap_partitions = 0
        #: open only inside a ``process_pending`` drain: ``SYNC_DONE``
        #: emissions park ``(fetch, emit)`` pairs here, and the drain's
        #: end reads every parked count with one device→host transfer
        #: and emits them in order
        self._telemetry_defer: list | None = None
        self._lock = threading.RLock()
        #: the cell behind the ``state`` property: ``_state`` is the
        #: replica's own store, or None while its authoritative copy is
        #: a lane of a fleet's stacked result (``_fleet_src = (stacked,
        #: lane)``, copied out on first access). ``_state_version`` moves
        #: on every assignment: a fleet dispatch is optimistic, and a
        #: version that moved between staging and commit means the batch
        #: read a stale state and must be replayed solo
        self._state: Any = None
        self._fleet_src: "tuple | None" = None
        self._state_version = 0
        #: fleet participation (``stats()["fleet"]``): batched dispatches
        #: this replica rode, messages merged in them, solo fallbacks
        self._fleet_dispatches = 0
        self._fleet_messages = 0
        self._fleet_fallbacks = 0
        #: set by a Fleet on membership: the fleet owns this replica's
        #: event loop, so ``start()`` refuses (two drains would race)
        self._in_fleet = False
        self._pending: list[tuple[str, Any, Any]] = []  # (op, key_term, value)
        #: per-neighbour per-bucket own counter already pushed
        self._push_cursor: dict[Any, np.ndarray] = {}
        #: host cache of ctx_max[:, self_slot]; invalidated when local
        #: mutations mint dots
        self._own_ctr_cache: np.ndarray | None = None
        #: rows touched by kills get a unique monotone stamp and are
        #: pushed as full-row state slices
        self._row_touch_seq = np.zeros(self.num_buckets, np.int64)
        self._touch_seq = 0
        self._rm_cursor: dict[Any, int] = {}
        # dot (gid, bucket, ctr) -> (key_term, value)
        self._payloads: dict[tuple[int, int, int], tuple[Any, Any]] = {}
        self._key_terms: dict[int, Any] = {}
        self.gc_interval_ops = int(gc_interval_ops)
        self._gc_pressure = 0
        self._gc_floor = 0
        self._neighbours: list[Any] = []
        self._monitors: set[Any] = set()
        self._outstanding: dict[Any, float] = {}
        self._tree: _LazyLevels | None = None
        #: full-read result cache, maintained incrementally by local
        #: flushes while complete; ``_read_cache_kh`` maps each cached
        #: term to its canonical hash (the ==-collapse guard)
        self._read_cache: dict | None = {}
        self._read_cache_kh: dict | None = {}
        self._seq = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self.addr = self.transport.canonical_addr(self.name)

        self._init_fresh(
            node_id if node_id is not None else (secrets.randbits(63) | 1),
            capacity,
            replica_capacity,
        )
        self.transport.register(self.name, self)

    def _init_fresh(self, node_id: int, capacity: int, replica_capacity: int) -> None:
        self.node_id = node_id
        bin_cap = _pow2(max(capacity // self.num_buckets, 1), floor=4)
        state = self.model.new(self.num_buckets, bin_cap, replica_capacity, device=self.device)
        # claim slot 0 of the context table for our own gid
        state.ctx_gid[0] = _i64(self.node_id)
        self.state = state
        self.self_slot = 0

    @property
    def state(self):
        """The device-resident lattice state. For a fleet member the
        authoritative copy may be a lane of the fleet's stacked result
        (:meth:`fleet_commit`); the lane is copied out on first access
        and kept, so members that only ever merge through batched
        dispatches never pay a per-replica unstack."""
        with self._lock:
            if self._state is None:
                stacked, lane = self._fleet_src
                self._state = transition.index_state(stacked, lane)
                self._fleet_src = None
            return self._state

    @state.setter
    def state(self, value) -> None:
        with self._lock:
            self._state = value
            self._fleet_src = None
            self._state_version += 1

    def _geometry(self) -> tuple:
        """The model's batch-compatibility key, read without copying a
        fleet-held lane out (the fleet's bucketing stays free of device
        work)."""
        if self._state is not None:
            return self.model.geometry(self._state)
        stacked, _lane = self._fleet_src
        return self.model.geometry_stacked(stacked)

    # ------------------------------------------------------------------
    # public API (facade parity: delta_crdt.ex:97-137)

    def _acquire(self, timeout: float | None, what: str) -> None:
        if not self._lock.acquire(timeout=-1 if timeout is None else timeout):
            raise TimeoutError(
                f"{what} timed out after {timeout}s waiting for replica {self.name!r}"
            )

    def mutate(self, f: str, args: list, timeout: float | None = None) -> None:
        self._acquire(timeout, f"mutate {f!r}")
        try:
            self._enqueue(f, args)
            self._flush()
        finally:
            self._lock.release()

    def mutate_async(self, f: str, args: list) -> None:
        with self._lock:
            self._enqueue(f, args)
        self.notify()

    def mutate_batch(self, f: str, items: list, timeout: float | None = None) -> None:
        """Bulk synchronous mutation: one ``f`` op per entry of ``items``,
        enqueued under one lock acquisition and flushed once."""
        self.apply_ops([(f, args) for args in items], timeout)

    def apply_ops(self, ops: list, timeout: float | None = None) -> None:
        """Apply ``ops`` — ``(f, args)`` pairs — in order as ONE batch."""
        self._acquire(timeout, "apply_ops")
        try:
            pre = len(self._pending)
            try:
                for f, args in ops:
                    self._enqueue(f, args)
            except Exception:
                del self._pending[pre:]
                raise
            self._flush()
        finally:
            self._lock.release()

    def _enqueue(self, f: str, args: list) -> None:
        ops = self.model.OPS
        if f not in ops:
            raise ValueError(f"unknown operation {f!r}; available: {sorted(ops)}")
        _, arity = ops[f]
        if len(args) != arity:
            raise ValueError(f"{f} expects {arity} argument(s), got {len(args)}")
        if f == "add":
            value = args[1] if arity == 2 else True
            self._pending.append(("add", args[0], value))
        elif f == "remove":
            self._pending.append(("remove", args[0], None))
        else:
            self._pending.append(("clear", None, None))

    def read(self, timeout: float | None = None) -> "dict | set":
        self._acquire(timeout, "read")
        try:
            self._flush()
            if self._read_cache is None:
                self._read_cache = self._rebuild_read_cache()
            return self.model.read_view(dict(self._read_cache))
        finally:
            self._lock.release()

    def read_keys(self, key_terms: list) -> "dict | set":
        """Partial read (reference ``AWLWWMap.read/2``) through the
        probe-window kernel."""
        with self._lock:
            self._flush()
            hashes = [key_hash64(k) for k in key_terms]
            k = _wire(max(len(hashes), 1))
            arr = np.zeros(k, np.uint64)
            arr[: len(hashes)] = hashes
            w = self.model.winners_for_keys(self.state, self._u64_tensor(arr))
            found, gid, ctr = _TR_READ_KEYS.get((w.found, w.gid, w.ctr))
            gid = as_u64(gid)
            out = {}
            mask = self.num_buckets - 1
            for i, term in enumerate(key_terms):
                if found[i]:
                    dot = (int(gid[i]), int(hashes[i]) & mask, int(ctr[i]))
                    out[term] = self._payloads[dot][1]
            return self.model.read_view(out)

    def _u64_tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64).copy()).to(self.device)

    def _i64_tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64).copy()).to(self.device)

    def set_neighbours(self, neighbours: list) -> None:
        """One-way sync edges (reference ``{:set_neighbours, …}``):
        prunes monitors/in-flight slots for removed peers, then syncs."""
        addrs = [n.addr if isinstance(n, Replica) else n for n in neighbours]
        with self._lock:
            removed = set(self._monitors) - set(addrs)
            for addr in removed:
                self.transport.demonitor(self.addr, addr)
            self._neighbours = list(addrs)
            self._monitors &= set(addrs)
            self._outstanding = {a: v for a, v in self._outstanding.items() if a in addrs}
            self._push_cursor = {a: c for a, c in self._push_cursor.items() if a in addrs}
            self._rm_cursor = {a: c for a, c in self._rm_cursor.items() if a in addrs}
            self.sync_to_all()

    # ------------------------------------------------------------------
    # local mutation batch

    #: largest mutation batch applied in one kernel call
    MAX_BATCH = 1024

    def _flush(self) -> None:
        while self._pending:
            batch = self._pending[: self.MAX_BATCH]
            self._pending = self._pending[self.MAX_BATCH :]
            self._flush_batch(batch)

    def _flush_batch(self, batch: list) -> None:
        n = len(batch)
        if n >= 64 and self.on_diffs is None and all(f == "add" for f, _t, _v in batch):
            return self._flush_batch_adds(batch)
        key = np.zeros(n, np.uint64)
        valh = np.zeros(n, np.uint32)
        op = np.full(n, OP_PAD, np.int32)
        ts = np.zeros(n, np.int64)
        any_clear = False
        batch_hashes = None
        if n >= 32:
            batch_hashes = (
                key_hash64_batch([t for _f, t, _v in batch]),
                value_hash32_batch([v for _f, _t, v in batch]),
            )
        for i, (f, key_term, value) in enumerate(batch):
            if f == "add":
                op[i] = OP_ADD
                key[i] = batch_hashes[0][i] if batch_hashes else key_hash64(key_term)
                valh[i] = batch_hashes[1][i] if batch_hashes else value_hash32(value)
            elif f == "remove":
                op[i] = OP_REMOVE
                key[i] = batch_hashes[0][i] if batch_hashes else key_hash64(key_term)
            else:
                op[i] = OP_CLEAR
                any_clear = True
            ts[i] = self.clock.next()
            if f != "clear":
                self._key_terms[key[i].item()] = key_term

        touched: dict[int, Any] = {}
        for i, (f, key_term, _v) in enumerate(batch):
            if f != "clear":
                touched[int(key[i])] = key_term

        # the before/after winner passes feed only the diff callback (and
        # clear's full-map diff)
        need_winners = self.on_diffs is not None or any_clear
        w_before = self._batch_winner_records(touched, any_clear) if need_winners else {}

        # apply segments split at clears (clear is a full-state kernel)
        n_changed = 0
        ctr_of_op = np.zeros(n, np.uint32)
        seg_start = 0
        for i in range(n + 1):
            if i == n or op[i] == OP_CLEAR:
                if i > seg_start:
                    sl = slice(seg_start, i)
                    n_changed += self._apply_segment(
                        op[sl], key[sl], valh[sl], ts[sl], ctr_of_op[sl]
                    )
                if i < n:  # the clear itself
                    n_cleared = int(self.state.num_alive())
                    self.state = self.model.clear_all(self.state)
                    n_changed += n_cleared
                seg_start = i + 1
        self._seq += 1
        if any_clear:
            self._stamp_rows(np.arange(self.num_buckets, dtype=np.int64))

        # payloads for surviving adds (last op per key wins, a clear
        # shadows everything before it)
        survivor: dict[int, int] = {}
        blocked = False
        for i in range(n - 1, -1, -1):
            f, key_term, value = batch[i]
            if f == "clear":
                blocked = True
            elif not blocked and int(key[i]) not in survivor:
                survivor[int(key[i])] = i if f == "add" else -1
        for kh, i in survivor.items():
            if i >= 0:
                _f, key_term, value = batch[i]
                dot = (self.node_id, kh & (self.num_buckets - 1), int(ctr_of_op[i]))
                self._payloads[dot] = (key_term, value)

        # maintain the full-read cache in place when it is complete
        maintained = self._read_cache is not None and self._read_cache_kh is not None
        if maintained:
            cache, ckh = self._read_cache, self._read_cache_kh
            try:
                for i, (f, key_term, value) in enumerate(batch):
                    if f == "clear":
                        cache.clear()
                        ckh.clear()
                        continue
                    kh = int(key[i])
                    prev = ckh.get(key_term)
                    if prev is not None and prev != kh:
                        self._read_cache = None
                        self._read_cache_kh = None
                        maintained = False
                        break
                    if f == "add":
                        cache[key_term] = value
                        ckh[key_term] = kh
                    else:
                        cache.pop(key_term, None)
                        ckh.pop(key_term, None)
            except TypeError:
                self._read_cache = None
                self._read_cache_kh = None
                maintained = False

        if need_winners:
            w_after = self._batch_winner_records(touched, any_clear)
            touched_all = dict(touched)
            for kh in set(w_before) | set(w_after):
                touched_all.setdefault(kh, self._key_terms.get(kh))
            self._emit_diffs(touched_all, w_before, w_after, maintained)
        else:
            self._note_state_changed(lambda: n_changed, maintained)
        self._gc_pressure += n
        self._maybe_gc()

    def _flush_batch_adds(self, batch: list) -> None:
        """All-adds fast path of ``_flush_batch`` (no clears, no diff
        subscriber); identical semantics."""
        n = len(batch)
        terms = [t for _f, t, _v in batch]
        values = [v for _f, _t, v in batch]
        key = np.asarray(key_hash64_batch(terms), np.uint64)
        valh = np.asarray(value_hash32_batch(values), np.uint32)
        ts = self.clock.next_n(n)
        op = np.full(n, OP_ADD, np.int32)
        kh_list = key.tolist()
        self._key_terms.update(zip(kh_list, terms))

        ctr_of_op = np.zeros(n, np.uint32)
        n_changed = self._apply_segment(op, key, valh, ts, ctr_of_op)
        self._seq += 1

        last_idx = dict(zip(kh_list, range(n)))
        mask = self.num_buckets - 1
        b_l = (key & np.uint64(mask)).astype(np.int64).tolist()
        c_l = ctr_of_op.tolist()
        node_id = self.node_id
        self._payloads.update(
            ((node_id, b_l[i], c_l[i]), (terms[i], values[i]))
            for i in last_idx.values()
        )

        maintained = self._read_cache is not None and self._read_cache_kh is not None
        if maintained:
            try:
                d_kh = dict(zip(terms, kh_list))
                if len(d_kh) < len(set(kh_list)):
                    maintained = False
                else:
                    ckh = self._read_cache_kh
                    for t in ckh.keys() & d_kh.keys():
                        if ckh[t] != d_kh[t]:
                            maintained = False
                            break
            except TypeError:
                maintained = False
            if maintained:
                self._read_cache.update(zip(terms, values))
                self._read_cache_kh.update(d_kh)
            else:
                self._read_cache = None
                self._read_cache_kh = None

        self._note_state_changed(lambda: n_changed, maintained)
        self._gc_pressure += n
        self._maybe_gc()

    def _apply_segment(self, op, key, valh, ts, ctr_out) -> int:
        """Apply one clear-free batch segment; fills ``ctr_out`` with the
        dot counter assigned to each op. Returns the changed-key count."""
        g = self.model.group_batch(self.num_buckets, op, key, valh, ts)
        args = (
            self._i64_tensor(g.rows),
            torch.from_numpy(g.op.copy()).to(self.device),
            self._u64_tensor(g.key),
            self._i64_tensor(g.valh),
            self._i64_tensor(g.ts),
        )
        while True:
            res = self.model.row_apply(self.state, self.self_slot, *args)
            if bool(res.ok):
                self.state = self.model.post_apply(
                    res.state, res, on_grow=self._grown_telemetry
                )
                break
            self._grow_bin()
        self._own_ctr_cache = None  # fresh own dots: push cursors lag
        killed_mask, ctr_assigned, n_keys_changed = _TR_APPLY_COUNTS.get(
            (res.row_killed, res.ctr_assigned, res.n_keys_changed)
        )
        self._stamp_rows(g.rows[killed_mask & (g.rows >= 0)])
        urow, cols = g.index
        ctr_out[:] = ctr_assigned[urow, cols]
        return int(n_keys_changed)

    def _stamp_rows(self, rows: np.ndarray) -> None:
        """Mark rows as needing a full-row push, each with a UNIQUE
        monotone stamp."""
        if len(rows) == 0:
            return
        rows = np.unique(rows)
        k = len(rows)
        self._row_touch_seq[rows] = np.arange(
            self._touch_seq + 1, self._touch_seq + 1 + k, dtype=np.int64
        )
        self._touch_seq += k

    def _grow_bin(self) -> None:
        # the model's overflow escape: bin tier ×2 (binned) or a
        # whole-table rehash (hash)
        self.state = self.model.grow_for_apply(self.state)
        self._grown_telemetry(self.state)

    def grow_store_advised(self) -> None:
        """Fleet post-commit growth advisory (``replica.py:1510``): the
        batched merge reported this member's fullest probe window near
        overflow, so grow the store off the batch path. Re-checks under
        the lock (a concurrent mutate may have grown it already) and
        commits through the state cell in one critical section."""
        with self._lock:
            st = self.state
            if self.model.store_load_high(st):
                self._state = self.model.grow_for_apply(st)
                self._fleet_src = None
                self._state_version += 1
                self._grown_telemetry(self._state)

    def _grown_telemetry(self, state) -> None:
        if telemetry.has_handlers(telemetry.CAPACITY_GROWN):
            telemetry.execute(
                telemetry.CAPACITY_GROWN,
                {"capacity": state.capacity, "replica_capacity": state.replica_capacity},
                {"name": self.name},
            )

    # ------------------------------------------------------------------
    # diffs, callback, telemetry (reference causal_crdt.ex:344-404)

    def _batch_winner_records(self, touched: dict[int, Any], full: bool) -> dict[int, tuple]:
        """Winner records for a mutation batch's diff: the probe-window
        kernel over the touched keys, or the full-map pass for a batch
        that holds a ``clear``."""
        if full:
            return self._winner_records_rows(None)
        if not touched:
            return {}
        tkeys = np.zeros(_wire(max(len(touched), 1)), np.uint64)
        tkeys[: len(touched)] = list(touched.keys())
        w = self.model.winners_for_keys(self.state, self._u64_tensor(tkeys))
        found, gid, ctr, valh, ts = _TR_DIFF_WINNERS.get(
            (w.found, w.gid, w.ctr, w.valh, w.ts)
        )
        gid = as_u64(gid)
        out = {}
        for i, kh in enumerate(touched):
            if found[i]:
                out[kh] = (int(gid[i]), int(ctr[i]), int(valh[i]), int(ts[i]))
        return out

    def _winner_arrays_rows(self, rows: np.ndarray | None) -> tuple:
        """LWW winner entries within the given bucket rows (``None`` = the
        whole map) as flat numpy columns ``(key, gid, ctr, valh, ts)`` in
        the JAX package's dtypes."""
        def host(w, site):
            win, key, gid, ctr, valh, ts = site.get(
                (w.win, w.key, w.gid, w.ctr, w.valh, w.ts)
            )
            u_idx, b_idx = np.nonzero(win)
            return (
                as_u64(key)[u_idx, b_idx],
                as_u64(gid)[u_idx, b_idx],
                as_u32(ctr[u_idx, b_idx]),
                as_u32(valh[u_idx, b_idx]),
                ts[u_idx, b_idx],
            )

        if rows is None:
            return host(self.model.winner_all(self.state), _TR_WINNER_ALL)
        cols: list[tuple] = []
        CHUNK = 4096
        for s in range(0, len(rows), CHUNK):
            chunk = rows[s : s + CHUNK]
            padded = np.full(_pow2(len(chunk)), -1, np.int64)
            padded[: len(chunk)] = chunk
            w = self.model.winner_rows(self.state, self._i64_tensor(padded))
            cols.append(host(w, _TR_WINNER_ROWS))
        if not cols:
            return (
                np.zeros(0, np.uint64),
                np.zeros(0, np.uint64),
                np.zeros(0, np.uint32),
                np.zeros(0, np.uint32),
                np.zeros(0, np.int64),
            )
        return tuple(np.concatenate(c) for c in zip(*cols))

    def _winner_records_rows(self, rows: np.ndarray | None) -> dict[int, tuple]:
        key, gid, ctr, valh, ts = self._winner_arrays_rows(rows)
        return dict(
            zip(
                key.tolist(),
                zip(gid.tolist(), ctr.tolist(), valh.tolist(), ts.tolist()),
            )
        )

    def canonical_state_bytes(self) -> bytes:
        """Topology-independent canonical projection of the CRDT state:
        the sorted per-key LWW winner records plus the causal context
        re-keyed by writer gid — byte-identical to the JAX replica's
        ``canonical_state_bytes`` for the same CRDT state."""
        with self._lock:
            self._flush()
            key, gid, ctr, valh, ts = self._winner_arrays_rows(None)
            order = np.lexsort((ts, valh, ctr, gid, key))
            winners = np.stack(
                [
                    key[order].astype(np.uint64),
                    gid[order].astype(np.uint64),
                    ctr[order].astype(np.uint64),
                    valh[order].astype(np.uint64),
                    ts[order].astype(np.uint64),
                ],
                1,
            )
            st = self.state
            gids, ctx = _TR_CANONICAL_STATE.get((st.ctx_gid, st.ctx_max))
            gids, ctx = as_u64(gids), as_u32(ctx)
            # writers with an all-zero context column are arrival
            # artifacts: keep only writers that contributed coverage
            live = np.nonzero((gids != 0) & ctx.any(axis=0))[0]
            g_order = live[np.argsort(gids[live], kind="stable")]
            return winners.tobytes() + gids[g_order].tobytes() + ctx[:, g_order].tobytes()

    def _note_state_changed(
        self, count_fn: Callable[[], Any], keep_read_cache: bool = False
    ) -> None:
        """Invalidate read/tree caches and emit ``SYNC_DONE`` telemetry
        (``count_fn`` runs only when a handler is attached; it may return
        an int or a tuple of scalars to sum)."""
        self._tree = None
        if not keep_read_cache:
            self._read_cache = None
            self._read_cache_kh = None
        if telemetry.has_handlers(telemetry.SYNC_DONE):
            name = self.name

            def emit(n):
                if isinstance(n, tuple):
                    n = sum(int(c) for c in n)
                telemetry.execute(telemetry.SYNC_DONE, {"keys_updated_count": int(n)}, {"name": name})

            if self._telemetry_defer is not None:
                self._telemetry_defer.append((count_fn, emit))
            else:
                emit(count_fn())

    def _emit_diffs(
        self,
        touched: dict[int, Any],
        before: dict,
        after: dict,
        keep_read_cache: bool = False,
    ) -> None:
        """Reference emission rules (``causal_crdt.ex:344-381``):
        telemetry counts dot-level changes; the callback compares read
        values, so no-op re-adds are silent and a ``None`` value emits a
        remove diff."""
        internal_changed = 0
        diffs = []
        mask = self.num_buckets - 1
        for kh, term in touched.items():
            b, a = before.get(kh), after.get(kh)
            if b != a:
                internal_changed += 1
            old_rec = self._payloads.get((b[0], kh & mask, b[1])) if b else None
            new_rec = self._payloads.get((a[0], kh & mask, a[1])) if a else None
            old_val = old_rec[1] if old_rec else None
            new_val = new_rec[1] if new_rec else None
            if old_val == new_val:
                continue
            if new_val is None:
                diffs.append(("remove", term))
            else:
                diffs.append(("add", term, new_val))

        self._note_state_changed(lambda: internal_changed, keep_read_cache)
        if diffs and self.on_diffs is not None:
            if isinstance(self.on_diffs, tuple):
                fn, extra = self.on_diffs
                fn(*extra, diffs)
            else:
                self.on_diffs(diffs)

    def _rebuild_read_cache(self) -> dict:
        out, kh_map = self._read_pairs()
        self._read_cache_kh = kh_map
        return out

    def _read_pairs(self) -> "tuple[dict, dict | None]":
        key, gid, ctr, _valh, ts = self._winner_arrays_rows(None)

        def build(k, g, c):
            bucket = (k & np.uint64(self.num_buckets - 1)).astype(np.int64)
            dots = zip(g.tolist(), bucket.tolist(), c.tolist())
            try:
                return dict(map(self._payloads.__getitem__, dots))
            except TypeError:
                for term, _value in self._payloads.values():
                    try:
                        hash(term)
                    except TypeError:
                        raise TypeError(
                            f"key term {term!r} is unhashable in Python; use "
                            "read_items() for maps with unhashable keys"
                        ) from None
                raise

        out = build(key, gid, ctr)
        if len(out) == len(key):
            return out, dict(zip(out.keys(), key.tolist()))
        # ==-equal terms with distinct canonical keys (1 vs True): insert
        # in ascending LWW order so every replica keeps the same value
        order = np.lexsort((ctr, gid, ts))
        return build(key[order], gid[order], ctr[order]), None

    def read_items(self) -> list[tuple[Any, Any]]:
        """Read as (key, value) pairs — supports unhashable key terms."""
        with self._lock:
            self._flush()
            key, gid, ctr, _valh, _ts = self._winner_arrays_rows(None)
            bucket = (key & np.uint64(self.num_buckets - 1)).astype(np.int64)
            dots = zip(gid.tolist(), bucket.tolist(), ctr.tolist())
            return list(map(self._payloads.__getitem__, dots))

    # ------------------------------------------------------------------
    # anti-entropy (reference causal_crdt.ex:252-335)

    def _ensure_tree(self) -> _LazyLevels:
        if self._tree is None:
            self._tree = _LazyLevels(self.model.tree_from_leaves(self.state.leaf))
        return self._tree

    def sync_to_all(self) -> None:
        """One sync round to all monitored neighbours: push own fresh
        deltas, then open the digest-walk round."""
        with self._lock:
            self._flush()
            self._monitor_neighbours()
            self._push_deltas()
            self._open_walks()

    def _open_walks(self) -> None:
        """Open digest-walk rounds toward every monitored neighbour — the
        tail of :meth:`sync_to_all`, shared with the fleet's batched
        sync tick. Caller holds the lock."""
        for n in list(self._monitors):
            if n != self.addr:
                self._open_walk(n)

    def _open_walk(self, n) -> bool:
        """Open one digest-walk round toward ``n`` (≤ 1 in flight)."""
        now = time.monotonic()
        expiry = self._outstanding.get(n)
        if expiry is not None and now < expiry:
            return False
        tree = self._ensure_tree()
        root = np.zeros(1, np.int64)
        blocks = sync_proto.make_blocks(tree, 0, root, self.levels_per_round)
        msg = sync_proto.DiffMsg(
            originator=self.addr, frm=self.addr, to=n, level=0, idx=root,
            blocks=blocks, seq=self._seq,
        )
        if self.transport.send(n, msg):
            self._outstanding[n] = now + self.sync_timeout
            return True
        logger.debug("tried to sync with a dead neighbour: %r", n)
        return False

    def _push_deltas(self) -> None:
        """Eagerly push own fresh dots to each neighbour as
        delta-interval slices (Almeida et al.'s delta mode), plus
        full-row slices of kill-touched rows: plan, extract, emit."""
        for job in self._eager_jobs():
            self._emit_push_job(job, self._extract_push_job(job))

    def _eager_jobs(self) -> list:
        jobs: list = []
        if not self.eager_deltas:
            return jobs
        if self._own_ctr_cache is None:
            self._own_ctr_cache = as_u32(
                _TR_OWN_CTR_CACHE.get(self.state.ctx_max[:, self.self_slot])
            )
        own = self._own_ctr_cache
        limit = int(min(self.max_sync_size, self.num_buckets))

        groups: dict[bytes, list] = {}
        for n in list(self._monitors):
            if n == self.addr:
                continue
            cur = self._push_cursor.get(n)
            if cur is None:
                cur = np.zeros(self.num_buckets, np.uint32)
                self._push_cursor[n] = cur
            groups.setdefault(cur.tobytes(), []).append((n, cur))
        for members in groups.values():
            cur0 = members[0][1]
            pending = np.nonzero(own > cur0)[0]
            if len(pending) == 0:
                continue
            pending = pending[:limit]
            rows = np.full(_wire(max(len(pending), 1)), -1, np.int32)
            rows[: len(pending)] = pending
            lo = np.zeros(len(rows), np.uint32)
            lo[: len(pending)] = cur0[pending]
            jobs.append(
                _PushJob("delta", rows, lo, pending, members, advance=own[pending].copy())
            )

        rm_groups: dict[int, list] = {}
        for n in list(self._monitors):
            if n == self.addr:
                continue
            rm_groups.setdefault(self._rm_cursor.get(n, 0), []).append(n)
        for rc, members in rm_groups.items():
            pend = np.nonzero(self._row_touch_seq > rc)[0]
            if len(pend) == 0:
                continue
            order = np.argsort(self._row_touch_seq[pend], kind="stable")
            pend = pend[order][:limit]
            new_cursor = int(self._row_touch_seq[pend[-1]])
            rows = np.full(_wire(max(len(pend), 1)), -1, np.int32)
            rows[: len(pend)] = pend
            jobs.append(_PushJob("rows", rows, None, pend, members, new_cursor=new_cursor))
        return jobs

    def _extract_push_job(self, job: _PushJob):
        if job.kind == "delta":
            return self.model.extract_own_delta(
                self.state,
                self._i64_tensor(job.rows),
                self.self_slot,
                torch.tensor(_i64(self.node_id), dtype=torch.int64, device=self.device),
                self._i64_tensor(job.lo),
            )
        return self.model.extract_rows(self.state, self._i64_tensor(job.rows))

    def _emit_push_job(self, job: _PushJob, sl) -> None:
        """Fan one extracted push slice out to the job's peers and
        advance their cursors on successful sends — the emission tail of
        the solo and the fleet egress paths (caller holds the lock).
        ``sl`` is on the device (solo) or already on the host (fleet)."""
        arrays, payloads = self._slice_wire(sl, job.rows)
        buckets = job.pending.astype(np.int64)
        for p in job.peers:
            n = p[0] if job.kind == "delta" else p
            msg = sync_proto.EntriesMsg(
                originator=self.addr, frm=self.addr, to=n,
                buckets=buckets, arrays=arrays, payloads=payloads,
            )
            if self.transport.send(n, msg):
                if job.kind == "delta":
                    p[1][job.pending] = job.advance
                else:
                    self._rm_cursor[n] = job.new_cursor

    def _monitor_neighbours(self) -> None:
        for n in list(self._neighbours):
            if n in self._monitors:
                continue
            if self.transport.monitor(self.addr, n):
                self._monitors.add(n)
            else:
                logger.debug("tried to monitor a dead neighbour: %r", n)

    def handle(self, msg) -> None:
        with self._lock:
            if isinstance(msg, sync_proto.DiffMsg):
                self._handle_diff(msg)
            elif isinstance(msg, sync_proto.GetDiffMsg):
                self._flush()
                self._send_entries(to=msg.frm, buckets=msg.buckets, originator=msg.originator)
                self._outstanding.pop(msg.frm, None)
            elif isinstance(msg, sync_proto.EntriesMsg):
                self._handle_entries_inner(msg)
            elif isinstance(msg, sync_proto.AckMsg):
                self._outstanding.pop(msg.clear_addr, None)
            elif isinstance(msg, Down):
                self._monitors.discard(msg.addr)
                self._outstanding.pop(msg.addr, None)
            elif isinstance(msg, (sync_proto.GetLogMsg, sync_proto.LogChunkMsg)):
                raise NotImplementedError(
                    "log-shipping catch-up is not ported to PyTorch yet; it comes "
                    "with the WAL, storage and log shipping slice"
                )
            elif isinstance(msg, sync_proto.FleetFrameMsg):
                raise NotImplementedError(
                    "fleet frames over TCP are not ported to PyTorch yet; they come "
                    "with the WAL, storage and log shipping slice (its TcpTransport)"
                )
            else:
                raise TypeError(f"unknown message: {msg!r}")

    def _handle_diff(self, msg: sync_proto.DiffMsg) -> None:
        self._flush()
        tree = self._ensure_tree()
        end_level, end_idx = sync_proto.walk(
            tree, msg.level, msg.idx, msg.blocks, self.max_sync_size
        )
        if len(end_idx) == 0:
            # trees agree under every compared node ({:ok, []} path)
            cleared = self.addr if msg.originator != self.addr else msg.frm
            self.transport.send(msg.originator, sync_proto.AckMsg(clear_addr=cleared))
            return
        if end_level == self.tree_depth:
            buckets = end_idx[: int(min(self.max_sync_size, len(end_idx)))]
            if msg.originator == self.addr:
                # walk ended at the originator: ship entries directly
                self._send_entries(to=msg.frm, buckets=buckets, originator=self.addr)
                self._outstanding.pop(msg.frm, None)
            else:
                self.transport.send(
                    msg.originator,
                    sync_proto.GetDiffMsg(
                        originator=msg.originator, frm=self.addr, to=msg.originator, buckets=buckets
                    ),
                )
            return
        # continue the ping-pong with our own digests beneath the frontier
        blocks = sync_proto.make_blocks(tree, end_level, end_idx, self.levels_per_round)
        self.transport.send(
            msg.frm,
            sync_proto.DiffMsg(
                originator=msg.originator,
                frm=self.addr,
                to=msg.frm,
                level=end_level,
                idx=end_idx,
                blocks=blocks,
                seq=self._seq,
            ),
        )

    def _slice_wire(self, sl, rows: np.ndarray) -> tuple[dict, dict]:
        """Host-plane wire form of a RowSlice: the EntriesMsg column dict
        (JAX dtypes, context rows for exactly the shipped buckets) plus
        the payload dict of every alive dot in the slice."""
        node_h, ctr_h, alive_h, gid_h = _TR_SLICE_PAYLOAD_DOTS.get(
            (sl.node, sl.ctr, sl.alive, sl.ctx_gid)
        )
        host = wire_from_host({"node": node_h, "ctr": ctr_h, "alive": alive_h, "ctx_gid": gid_h})
        u_idx, b_idx = np.nonzero(host["alive"])
        gid_l = host["ctx_gid"][host["node"][u_idx, b_idx]].tolist()
        row_l = rows[u_idx].tolist()
        ctr_l = host["ctr"][u_idx, b_idx].tolist()
        pay = self._payloads
        payloads = {dot: pay[dot] for dot in zip(gid_l, row_l, ctr_l)}

        names = (*_SLICE_COLUMNS, "ctx_rows", "ctx_lo", "ctx_gid")
        got = wire_from_host(
            _TR_SLICE_WIRE.get({c: getattr(sl, c) for c in names if c not in host})
        )
        arrays = {c: host[c] if c in host else got[c] for c in names}
        arrays["rows"] = rows  # row indices are control metadata: numpy
        return arrays, payloads

    def _send_entries(self, to, buckets: np.ndarray, originator) -> bool:
        rows = np.full(_wire(max(len(buckets), 1)), -1, np.int32)
        rows[: len(buckets)] = np.asarray(buckets, np.int32)
        sl = self.model.extract_rows(self.state, self._i64_tensor(rows))
        arrays, payloads = self._slice_wire(sl, rows)
        return self.transport.send(
            to,
            sync_proto.EntriesMsg(
                originator=originator,
                frm=self.addr,
                to=to,
                buckets=np.asarray(buckets, np.int64),
                arrays=arrays,
                payloads=payloads,
            ),
        )

    def _handle_entries_inner(self, msg: sync_proto.EntriesMsg) -> None:
        self._flush()
        t0 = time.perf_counter()
        a = msg.arrays
        sl = slice_from_wire(a, self.device)
        rows_np = np.asarray(a["rows"])

        # the before/after winner passes feed only the on_diffs callback
        want_diffs = self.on_diffs is not None
        keys_b = self._winner_records_rows(rows_np[rows_np >= 0]) if want_diffs else {}
        # payloads first: diff values for incoming winners must resolve
        self._register_slice_payloads(msg.payloads)

        try:
            self.state, res = self.model.merge_rows_into(
                self.state, sl, on_grow=self._grown_telemetry
            )
        except CtxGapError:
            # a delta-interval push is not contiguous with our context:
            # ask the sender for the full rows (the get_diff repair path)
            logger.debug("delta push from %r gapped; requesting full rows", msg.frm)
            self.transport.send(
                msg.frm,
                sync_proto.GetDiffMsg(
                    originator=self.addr, frm=self.addr, to=msg.frm,
                    buckets=np.asarray(msg.buckets),
                ),
            )
            self._gc_pressure += len(msg.payloads)
            return

        self._seq += 1
        if want_diffs:
            keys_a = self._winner_records_rows(rows_np[rows_np >= 0])
            touched: dict[int, Any] = {}
            for kh in set(keys_b) | set(keys_a):
                term = self._key_terms.get(kh)
                if term is not None:
                    touched[kh] = term
            self._emit_diffs(touched, keys_b, keys_a)
        else:
            self._note_state_changed(
                lambda ins=res.n_inserted, kill=res.n_killed: (ins, kill)
            )
        if telemetry.has_handlers(telemetry.SYNC_ROUND):
            telemetry.execute(
                telemetry.SYNC_ROUND,
                {
                    "duration_s": time.perf_counter() - t0,
                    "buckets": int(len(msg.buckets)),
                    "entries": len(msg.payloads),
                },
                {"name": self.name, "plane": "host"},
            )
        self._gc_pressure += len(msg.payloads) + int(_TR_INGEST_COUNTS.get(res.n_killed))
        self._maybe_gc()

    def _register_slice_payloads(self, payloads: dict) -> None:
        self._payloads.update(payloads)
        for _dot, (key_term, _val) in payloads.items():
            self._key_terms[key_hash64(key_term)] = key_term

    # ------------------------------------------------------------------
    # payload GC (host dictionaries must track device alive masks)

    def gc(self) -> None:
        """Prune host payload/key dictionaries to currently-alive dots."""
        with self._lock:
            st = self.state
            alive, node_h, gid_h, ctr_h, key_h = _TR_GC_SCAN.get(
                (st.alive, st.node, st.ctx_gid, st.ctr, st.key)
            )
            gid_h, key_h = as_u64(gid_h), as_u64(key_h)
            idx = np.nonzero(alive)
            gid_l = gid_h[node_h[idx]].tolist()
            ctr_l = ctr_h[idx].tolist()
            keys = key_h[idx]
            bucket = (keys & np.uint64(self.num_buckets - 1)).astype(np.int64)
            live = set(zip(gid_l, bucket.tolist(), ctr_l))
            self._payloads = {d: p for d, p in self._payloads.items() if d in live}
            keep_keys = set(keys.tolist())
            self._key_terms = {h: t for h, t in self._key_terms.items() if h in keep_keys}
            self._gc_pressure = 0
            self._gc_floor = len(self._payloads)

    def _maybe_gc(self) -> None:
        if self._gc_pressure >= max(self.gc_interval_ops, self._gc_floor >> 1):
            self.gc()

    # ------------------------------------------------------------------
    # threaded event loop (the reference's GenServer process analog)

    def notify(self) -> None:
        if self._thread is not None:
            self._wake.set()

    def process_pending(self) -> int:
        """Deterministic drive: handle queued messages now, in batches
        of at most ``ingress_batch`` and at most eight batches a call
        (so the threaded loop's sync ticks are never starved). With
        ``ingress_coalesce`` on, each run of consecutive
        ``EntriesMsg``s merges group by group (``_handle_batch``). The
        ``SYNC_DONE`` events of the whole drain read their counts with
        one transfer at its end and are emitted then, in order."""
        n = 0
        with self._lock:
            top = self._telemetry_defer is None
            if top:
                self._telemetry_defer = []
        try:
            for _ in range(8):
                batch = self.transport.drain_nowait(self.addr, self.ingress_batch)
                if not batch:
                    break
                n += len(batch)
                self._handle_batch(batch)
                if len(batch) < self.ingress_batch:
                    break
        finally:
            if top:
                with self._lock:
                    deferred, self._telemetry_defer = self._telemetry_defer, None
                if deferred:
                    fetched = _TR_DRAIN_ACCOUNTING.get([f() for f, _e in deferred])
                    for (_f, emit), data in zip(deferred, fetched):
                        emit(data)
        return n

    def _handle_batch(self, msgs: list) -> None:
        """Handle one drained batch in arrival order, coalescing each
        consecutive run of ``EntriesMsg``s; any other message closes the
        run and is handled in place, so nothing is reordered across
        types. A diff subscriber takes the per-slice path (its
        before/after winner compare is defined per slice)."""
        if not self.ingress_coalesce or self.on_diffs is not None:
            for m in msgs:
                self.handle(m)
            return
        run: list = []
        for m in msgs:
            if isinstance(m, sync_proto.EntriesMsg):
                run.append(m)
                continue
            self._drain_entries_run(run)
            self.handle(m)
        self._drain_entries_run(run)

    def _drain_entries_run(self, run: list) -> None:
        """Merge one run of queued entries, group by group, taking the
        lock per group (callers interleave between groups as they could
        between messages)."""
        if not run:
            return
        for group in self._coalesce_groups(run):
            with self._lock:
                self._handle_entries_group(group)
        run.clear()

    @staticmethod
    def _coalescible(msg) -> "tuple | None":
        """``(bucket-row set, entry-lane tier)`` of a message that may
        join a grouped merge; ``None`` forces the per-slice path (a
        body that is not host numpy)."""
        a = msg.arrays
        if not isinstance(a["key"], np.ndarray):
            return None
        rows = np.asarray(a["rows"])
        return frozenset(rows[rows >= 0].tolist()), a["key"].shape[1]

    def _coalesce_groups(self, run: list) -> list:
        """Partition a run of ``EntriesMsg``s (arrival order) into groups
        one grouped merge may join: equal entry-lane tiers (the grouped
        row-compact sort is then as wide as each message's own, so even
        dead slots match) and pairwise disjoint rows (``merge_rows`` is
        row-local, so the group equals its members merged in turn), at
        most ``max_coalesce`` deep. Greedy in arrival order: a message
        that conflicts closes the current group, so each sender's slices
        still merge in order."""
        groups: list = []
        cur: list = []
        cur_rows: set = set()
        cur_s = -1
        for m in run:
            info = self._coalescible(m)
            if info is None:
                if cur:
                    groups.append(cur)
                cur, cur_rows, cur_s = [], set(), -1
                groups.append([m])
                continue
            rows, width = info
            if cur and width == cur_s and len(cur) < self.max_coalesce and not (rows & cur_rows):
                cur.append(m)
                cur_rows |= rows
            else:
                if cur:
                    groups.append(cur)
                cur, cur_rows, cur_s = [m], set(rows), width
        if cur:
            groups.append(cur)
        return groups

    def _count_dispatch(self, depth: int, messages: int) -> None:
        self._ingress_dispatches += 1
        self._ingress_messages += messages
        self._coalesce_depths[depth] = self._coalesce_depths.get(depth, 0) + 1

    def _handle_entries_group(self, msgs: list, partition: bool = True) -> None:
        """Join a group of compatible ``EntriesMsg``s with ONE grouped
        merge (``merge_group_into``), then do the per-message
        bookkeeping, so what peers and subscribers observe is what
        handling them in turn gives, bit for bit. Singleton groups and a
        diff subscriber take the per-slice path. A delta-interval gap
        inside the group partitions it: the kernel's per-row gap mask
        names the gapped members, which replay solo (each answered with
        its ``GetDiffMsg`` repair), while the clean members retry as one
        grouped merge; with no usable mask the whole group replays per
        slice."""
        if len(msgs) == 1 or self.on_diffs is not None:
            for m in msgs:
                self._count_dispatch(1, 1)
                self._handle_entries_inner(m)
            return
        self._flush()
        t0 = time.perf_counter()
        # payloads first, whole group: merged winners must resolve
        # (idempotent, so a fallback below re-registers harmlessly)
        for m in msgs:
            self._register_slice_payloads(m.payloads)
        try:
            self.state, res, offsets = self.model.merge_group_into(
                self.state, [m.arrays for m in msgs], on_grow=self._grown_telemetry
            )
        except CtxGapError as err:
            gapped = err.gapped_members
            if partition and gapped and 0 < len(gapped) < len(msgs):
                # the clean subgroup re-evaluates against the same state:
                # a second gap there means the mask was wrong, so its
                # retry falls back to per-slice handling
                self._ingress_gap_partitions += 1
                self._handle_entries_group([m for i, m in enumerate(msgs) if i not in gapped], partition=False)
                for i in sorted(gapped):
                    self._count_dispatch(1, 1)
                    self._handle_entries_inner(msgs[i])
                return
            self._ingress_gap_fallbacks += 1
            for m in msgs:
                self._count_dispatch(1, 1)
                self._handle_entries_inner(m)
            return
        depth = len(msgs)
        self._count_dispatch(depth, depth)
        dt = time.perf_counter() - t0
        # caches invalidate once (per message in turn: the same end state)
        self._tree = None
        self._read_cache = None
        self._read_cache_kh = None
        # the count tensors only: a closure over ``res`` would keep its
        # whole state alive across the drain's deferral window
        self._commit_entries_group(msgs, offsets, lambda ins=res.n_ins_row, kill=res.n_kill_row: (ins, kill), dt)
        if telemetry.has_handlers(telemetry.INGEST_COALESCE):
            telemetry.execute(
                telemetry.INGEST_COALESCE,
                {
                    "depth": depth,
                    "rows": int(offsets[-1][1]),
                    "entries": sum(len(m.payloads) for m in msgs),
                    "duration_s": dt,
                },
                {"name": self.name},
            )
        self._gc_pressure += sum(len(m.payloads) for m in msgs) + int(_TR_INGEST_COUNTS.get(res.n_killed))
        self._maybe_gc()

    def _commit_entries_group(self, msgs: list, offsets, counts_fn, dt: float) -> None:
        """Per-message bookkeeping of one grouped merge: one sequence
        number and one ``SYNC_DONE`` per message (its count summed from
        the kernel's per-row insert and kill counts over its own rows),
        one ``SYNC_ROUND`` per message with the group's duration split
        evenly. The caller holds the lock and has stored the state."""
        self._seq += len(msgs)
        depth = len(msgs)
        if telemetry.has_handlers(telemetry.SYNC_DONE):
            name = self.name

            def emit_done(counts, offsets=offsets):
                ins_row, kill_row = counts
                tot = np.cumsum(np.asarray(ins_row, np.int64) + np.asarray(kill_row, np.int64))
                meas = [
                    {"keys_updated_count": int(tot[hi - 1]) - (int(tot[lo - 1]) if lo else 0) if hi > lo else 0}
                    for lo, hi in offsets
                ]
                telemetry.execute_many(telemetry.SYNC_DONE, meas, {"name": name})

            if self._telemetry_defer is not None:
                self._telemetry_defer.append((counts_fn, emit_done))
            else:
                emit_done(_TR_INGEST_COUNTS.get(counts_fn()))
        if telemetry.has_handlers(telemetry.SYNC_ROUND):
            telemetry.execute_many(
                telemetry.SYNC_ROUND,
                [
                    {"duration_s": dt / depth, "buckets": int(len(m.buckets)), "entries": len(m.payloads)}
                    for m in msgs
                ],
                {"name": self.name, "plane": "host"},
            )

    # ------------------------------------------------------------------
    # batched replica fleets (``replica.py:3461-3560``): the replica's
    # side of the contract :mod:`delta_crdt_ex_tpu_torch.runtime.fleet`
    # drives. Staging is optimistic (no lock held across the batched
    # dispatch) and the commit replays through the same bookkeeping tail
    # as the solo grouped path, so what peers observe (state bits, seq,
    # telemetry) is what handling the messages without a fleet gives.

    def fleet_prepare(self, msgs: list) -> "tuple | None":
        """Stage one coalesce group for a fleet batched dispatch: flush
        pending local ops, register the group's payloads (idempotent —
        the solo fallback re-registers harmlessly) and combine the group
        into one host-form slice. Returns ``(slice, offsets,
        state_version, geometry)``, or ``None`` for the per-replica
        fallback: a diff subscriber (its before/after compare is per
        slice) or a body that is not host numpy."""
        if self.on_diffs is not None:
            return None
        for m in msgs:
            if not isinstance(m.arrays["key"], np.ndarray):
                return None
        with self._lock:
            self._flush()
            for m in msgs:
                self._register_slice_payloads(m.payloads)
            sl, offsets = self.model.combine_entry_arrays([m.arrays for m in msgs], None)
            return sl, offsets, self._state_version, self._geometry()

    def fleet_handle_group(self, msgs: list) -> None:
        """Per-replica fallback for one fleet group: the solo grouped
        merge under this replica's own lock — growth, the gap partition
        and repair, and singleton handling behave as without a fleet."""
        with self._lock:
            self._fleet_fallbacks += 1
            self._handle_entries_group(msgs)

    def fleet_commit(self, msgs: list, offsets, stacked, lane: int, counts_fn, n_killed: int,
                     dt: float, version: int) -> "int | None":
        """Adopt lane ``lane`` of a fleet batched dispatch's stacked
        result and fan out the per-message bookkeeping (seq, telemetry,
        gc pressure). Returns the NEW state version (the one at which
        ``stacked[lane]`` is this replica's state — the fleet's resident
        stack must record exactly this one), or ``None``, leaving the
        replica untouched, when its state moved since
        :meth:`fleet_prepare` staged it: the batch read a stale state
        and the fleet replays the group solo."""
        with self._lock:
            if self._state_version != version:
                return None
            self._state = None
            self._fleet_src = (stacked, lane)
            self._state_version += 1
            committed_version = self._state_version
            self._tree = None
            self._read_cache = None
            self._read_cache_kh = None
            # the batched dispatch swaps the WHOLE state cell: the next
            # egress tick plans from the adopted lane, never a stale own
            # column
            self._own_ctr_cache = None
            self._fleet_dispatches += 1
            self._fleet_messages += len(msgs)
            self._commit_entries_group(msgs, offsets, counts_fn, dt)
            self._gc_pressure += sum(len(m.payloads) for m in msgs) + n_killed
            self._maybe_gc()
            return committed_version

    def stats(self) -> dict:
        """Observability snapshot. ``ingress`` shows the coalescing of
        ``process_pending``: messages and grouped dispatches, the depth
        histogram (group size → dispatches) and the gap fallbacks;
        ``fleet`` the batched dispatches this replica rode as a fleet
        member."""
        from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel

        with self._lock:
            dispatches = self._ingress_dispatches
            messages = self._ingress_messages
            return {
                "name": self.name,
                "node_id": self.node_id,
                "sequence_number": self._seq,
                "neighbours": list(self._neighbours),
                "outstanding_syncs": len(self._outstanding),
                "payloads": len(self._payloads),
                "ingress": {
                    "messages": messages,
                    "dispatches": dispatches,
                    "merges_per_dispatch": round(messages / dispatches, 3) if dispatches else 0.0,
                    "coalesce_depth_hist": dict(sorted(self._coalesce_depths.items())),
                    "gap_fallbacks": self._ingress_gap_fallbacks,
                    "gap_partitions": self._ingress_gap_partitions,
                },
                "fleet": {
                    "dispatches": self._fleet_dispatches,
                    "batched_messages": self._fleet_messages,
                    "fallbacks": self._fleet_fallbacks,
                },
                "device": str(self.device),
                # process-wide launch count of the probe-window kernel
                "kernel_launches": {probe_lookup_kernel.name: probe_lookup_kernel.launches},
                # process-wide per-site device↔host crossings
                "transfers": transfers.snapshot(),
            }

    def start(self) -> "Replica":
        """Run the periodic anti-entropy loop in a background thread
        (first sync fires immediately)."""
        if self._in_fleet:
            raise ValueError(
                f"replica {self.name!r} is a fleet member; the fleet owns "
                "its event loop (two drains of one mailbox would race)"
            )
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            next_sync = time.monotonic()
            while not self._stop.is_set():
                self.process_pending()
                with self._lock:
                    if self._pending:
                        self._flush()
                now = time.monotonic()
                if now >= next_sync:
                    self.sync_to_all()
                    next_sync = now + self.sync_interval
                self._wake.wait(timeout=max(0.0, min(next_sync - time.monotonic(), 0.05)))
                self._wake.clear()

        self._thread = threading.Thread(target=loop, name=f"crdt-{self.name}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Terminate: best-effort final sync, then deregister (fires
        ``Down`` at monitoring peers)."""
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=30)
            self._thread = None
        try:
            self.sync_to_all()
        except Exception:  # best-effort, like the reference's terminate path
            logger.debug("final sync on terminate failed", exc_info=True)
        self.transport.unregister(self.name)
