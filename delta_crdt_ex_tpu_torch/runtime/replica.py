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
  :mod:`delta_crdt_ex_tpu_torch.runtime.fleet` drives;
- durability: pluggable snapshot storage (``storage_module``,
  ``storage_mode``) and the write-ahead delta log (``wal_dir``): every
  local batch and every merged slice is one record, written before
  anything observes it, and a restart with the same ``name`` recovers
  snapshot + replay, bit for bit, with the node id and counters kept;
  compaction checkpoints gated by the peers' acks; ``crash()`` and
  ``checkpoint()``; the labelled fault points of
  :mod:`delta_crdt_ex_tpu_torch.utils.faults` on every commit boundary.
  Snapshots and WAL records hold the JAX package's dtypes and orders,
  so either package recovers what the other wrote.

- the serving plane's publication (``_serve_pub``, swapped at every
  commit boundary and read by :mod:`delta_crdt_ex_tpu_torch.runtime.serve`
  without the lock) and the cached front door (:meth:`Replica.frontdoor`);
- the observability hooks (``obs=``): the flight recorder, the lag
  tracer, the plane's varz/health sources (:meth:`Replica.obs_varz`,
  :meth:`Replica.health`), the drain accounting, and the
  ``crdt.flush`` / ``crdt.merge`` / ``crdt.merge_group`` profiler spans
  (:mod:`delta_crdt_ex_tpu_torch.runtime.tracing`);

- log-shipping catch-up (``log_shipping``, on by default as in the JAX
  package): per-peer applied watermarks learned from walk equality, a
  round opener's ``log_horizon`` deciding between the digest walk and a
  ``GetLogMsg`` / ``LogChunkMsg`` stream of the WAL suffix, chunks
  merged through the entries path (a chunk slice that changes nothing
  is not logged: with a WAL on both sides the JAX replica's two streams
  echo each other, ``ROADMAP.md`` §3.6; a dense suffix fills a chunk to
  its hard cap); fleet envelopes
  (``FleetFrameMsg``) handed to a mailbox whole fan out here.

- tree gossip (``tree_gossip``, off by default as in the JAX package):
  the replica derives the membership's spanning tree
  (:mod:`delta_crdt_ex_tpu_torch.runtime.treesync`), monitors, pushes
  to and walks toward its tree links only, and relays: what it merged
  from one link re-emits, coalesced, as ONE merged slice per other link
  per epoch (``_relay_flush``, at the end of each drain pass and each
  sync tick); a ``Down`` re-parents, and past ``tree_degrade_ratio``
  locally down members it gossips flat.

- the device data plane: a replica PINNED to a device — ``device=``
  given with an explicit index (``"cuda:0"``, ``torch.device("cuda",
  1)``, ``"cpu:0"``) — receives its sync slices as tensor bodies placed
  straight on that device (``replica.slice_place``; a peer copy between
  cards, nothing on one card); the sender builds one body per distinct
  pinned device among a fan-out's peers. A bare ``"cuda"`` / ``"cpu"``
  is not pinned, and an unpinned receiver (the default) gets the host
  plane: numpy bodies in the JAX package's dtypes, so the wire stays the
  JAX package's and every one of them may coalesce. A tensor body
  merges per slice (it never joins a coalesced group, as in the JAX
  package) and is logged in the JAX dtypes.

The replica accepts every option the JAX replica accepts.
"""

from __future__ import annotations

import dataclasses
import logging
import os
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
from delta_crdt_ex_tpu_torch.runtime import metrics as metrics_mod
from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, telemetry, tracing, transition, treesync
from delta_crdt_ex_tpu_torch.runtime.clock import Clock
from delta_crdt_ex_tpu_torch.runtime.storage import (
    FileStorage,
    Snapshot,
    Storage,
    name_key,
    require_layout,
)
from delta_crdt_ex_tpu_torch.runtime.transport import (
    Down,
    LocalTransport,
    default_transport,
    forward_fleet_entries,
)
from delta_crdt_ex_tpu_torch.runtime.wal import ReplayClock, WalLog
from delta_crdt_ex_tpu_torch.utils import transfers
from delta_crdt_ex_tpu_torch.utils.devices import Sharded, tree_map
from delta_crdt_ex_tpu_torch.utils.faults import faultpoint
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
_TR_SNAPSHOT = transfers.register("replica.snapshot")
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
_TR_SLICE_PLACE = transfers.register("replica.slice_place")
_TR_WAL_ENTRIES = transfers.register("replica.wal_entries")
_TR_GC_SCAN = transfers.register("replica.gc_scan")
_TR_DRAIN_ACCOUNTING = transfers.register("replica.drain_accounting")
_TR_SAME_STATE = transfers.register("replica.same_state")
_TR_RELAY_ACCOUNTING = transfers.register("replica.relay_accounting")


def _pow2(n: int, floor: int = 8) -> int:
    return pow2_tier(n, floor)


def _wire(n: int, floor: int = 8) -> int:
    return pow4_tier(n, floor)


def _same_state(a, b) -> bool:
    """Whether two states of one store hold equal columns (one device
    read for all of them)."""
    if a is b:
        return True
    pairs = [(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)]
    if any(x.shape != y.shape if torch.is_tensor(x) else x != y for x, y in pairs):
        return False
    diff = [torch.ne(x, y).any() for x, y in pairs if torch.is_tensor(x) and x is not y]
    return not diff or not bool(_TR_SAME_STATE.get(torch.stack(diff).any()))


def _slices_nbytes(slices: list) -> int:
    """Array bytes of a chunk's entry slices (the catch-up byte count)."""
    return sum(int(v.nbytes) for s in slices for v in s["arrays"].values() if hasattr(v, "nbytes"))


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
        storage_module: Storage | None = None,
        storage_mode: str = "every_op",
        wal_dir: str | None = None,
        fsync_mode: str = "batch",
        segment_bytes: int = 4 << 20,
        compact_every: int = 1024,
        transport: LocalTransport | None = None,
        clock: Clock | None = None,
        capacity: int = 1024,
        replica_capacity: int = 8,
        tree_depth: int = 12,
        levels_per_round: int = 8,
        sync_timeout: float | None = None,
        checkpoint_interval: float = 5.0,
        eager_deltas: bool = True,
        ingress_coalesce: bool = True,
        max_coalesce: int = 16,
        ingress_batch: int = 256,
        membership_compaction: bool = True,
        membership_retain: int | None = None,
        log_shipping: bool = True,
        catchup_chunk_rows: int = 1024,
        catchup_suffix_ratio: float = 4.0,
        gc_interval_ops: int = 4096,
        tree_gossip: bool = False,
        tree_fanout: int = 8,
        tree_seed: int = 0,
        tree_degrade_ratio: float = 0.25,
        tree_group=None,
        obs=None,
        flight_dump_path: str | None = None,
        device="cuda",
    ):
        if max_sync_size == "infinite":
            self.max_sync_size: float = float("inf")
        elif isinstance(max_sync_size, int) and not isinstance(max_sync_size, bool) and max_sync_size > 0:
            self.max_sync_size = max_sync_size
        else:
            raise ValueError(f"{max_sync_size!r} is not a valid max_sync_size")

        self.device = resolve_device(device)
        #: the device this replica is PINNED to: the one given with an
        #: explicit index (``"cuda:0"``), else None. Peers place sync
        #: slices for a pinned replica straight on its device (the device
        #: data plane); an unpinned one gets the host plane. A bare
        #: ``"cuda"`` keeps the host plane, as the JAX replica's
        #: ``device=None`` does
        self.pinned_device = self.device if torch.device(device).index is not None else None
        self.model = crdt_module
        self.name = name if name is not None else f"crdt-{secrets.token_hex(6)}"
        self.sync_interval = sync_interval
        self.on_diffs = on_diffs
        self.storage_module = storage_module
        self.storage_mode = storage_mode
        self.checkpoint_interval = checkpoint_interval
        #: durable delta log: with a ``wal_dir``, ``every_op`` durability
        #: is an O(delta) record append instead of an O(state) image
        #: write, and snapshots become compaction checkpoints
        self.compact_every = int(compact_every)
        self._wal: WalLog | None = None
        self._wal_unc = 0  # records appended since the last compaction
        self._replaying = False
        if wal_dir is not None:
            if self.storage_module is None:
                # compaction checkpoints live beside the log, fsynced:
                # compaction DELETES the fsynced records they supersede
                self.storage_module = FileStorage(
                    os.path.join(wal_dir, "snapshots"),
                    fsync=fsync_mode != "none",
                )
            elif getattr(self.storage_module, "fsync", None) is False:
                logger.warning(
                    "WAL compaction checkpoints for %r go through a "
                    "non-fsynced storage module; pass "
                    "FileStorage(..., fsync=True) for machine-crash "
                    "durability",
                    self.name,
                )
            self._wal = WalLog(
                os.path.join(wal_dir, f"replica_{name_key(self.name)}"),
                fsync_mode=fsync_mode,
                segment_bytes=segment_bytes,
            )
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
        #: observability plane: ``obs=True`` resolves to the process-wide
        #: plane, an :class:`~delta_crdt_ex_tpu_torch.runtime.metrics.
        #: Observability` is used as-is, ``None``/``False`` disables it
        #: (the ``has_handlers`` guards then keep disabled telemetry at a
        #: lock check). The flight recorder is the per-replica black box
        #: (a bounded ring dumped on :meth:`crash`, also to
        #: ``flight_dump_path`` as JSON lines when set); the lag tracer
        #: samples local commits so peers' watermark advances yield
        #: per-peer convergence-lag histograms with zero wire changes.
        #: Set before recovery: the WAL replay records a flight event
        self._obs = metrics_mod.resolve_obs(obs)
        self.flight = self._obs.recorder(self.name) if self._obs is not None else None
        self.flight_dump_path = flight_dump_path
        self._lag = self._obs.lag if self._obs is not None else None
        #: the threaded loop's heartbeat (``health()``)
        self._loop_ts = time.monotonic()
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
        #: serving-plane read publication: the ``(version, state,
        #: fleet_src, payloads)`` tuple the front door's lock-free
        #: snapshot reads pin, swapped in one attribute store by
        #: ``_publish_serve`` at commit boundaries (where the device
        #: state and the payload dict agree) and read WITHOUT the lock.
        #: Two invariants keep a pinned tuple valid for ever: no op
        #: writes into a tensor a published state holds (every op copies
        #: then writes), and the published payload dict is append-only
        #: for its generation (``gc`` replaces the dict, never prunes it)
        self._serve_pub: "tuple | None" = None
        #: the cached front door (``frontdoor()``), closed on stop/crash
        #: so its admission worker never outlives the replica
        self._frontdoor = None
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
        #: membership-driven WAL compaction: per monitored neighbour, the
        #: highest local ``_seq`` that peer is known to have observed (an
        #: acked walk round that opened at that seq). Segment reclaim
        #: never passes the minimum over the monitored set, bounded by
        #: ``membership_retain`` records of history
        self.membership_compaction = bool(membership_compaction)
        self.membership_retain = (
            int(membership_retain)
            if membership_retain is not None
            else 4 * self.compact_every
        )
        self._ack_seq: dict[Any, int] = {}
        self._sync_open_seq: dict[Any, int] = {}
        #: log-shipping catch-up: a rejoining or lagging peer's
        #: divergence is the suffix of the originator's delta log past
        #: the peer's last fully observed seq, so catch-up requests WAL
        #: record ranges (``GetLogMsg``) and merges the shipped row
        #: slices instead of walking the digest tree. ``_applied_seq``
        #: is this replica's watermark of each PEER's history (learned
        #: from walk equality on round openers, advanced by applied
        #: chunks, kept in snapshots); ``_catchup`` tracks the one
        #: in-flight request per peer (requester-paced: the server
        #: stays stateless)
        self.log_shipping = bool(log_shipping)
        self.catchup_chunk_rows = int(catchup_chunk_rows)
        #: past the horizon, stream the clamped suffix only when it is at
        #: least this many times the walk-bound prefix
        self.catchup_suffix_ratio = float(catchup_suffix_ratio)
        self._applied_seq: dict[Any, int] = {}
        self._catchup: dict[Any, dict] = {}
        #: per-peer "walk first" floor: a horizon-marked chunk said the
        #: span through that seq is unservable by the peer's log, so
        #: openers take the classic walk until our watermark passes it
        self._catchup_walk_floor: dict[Any, int] = {}
        self._catchup_chunks_served = 0
        self._catchup_chunks_applied = 0
        self._catchup_bytes_shipped = 0
        self._catchup_lanes_shipped = 0
        self._catchup_entries_shipped = 0
        self._catchup_rows_applied = 0
        self._catchup_horizon_fallbacks = 0
        self._catchup_last_duration = 0.0
        #: tree gossip: with ``tree_gossip`` the replica syncs along the
        #: membership's spanning tree (``runtime/treesync.py``): leaves
        #: sync only their parent, relays coalesce inbound children's
        #: merged rows and re-emit ONE merged slice per link per epoch
        #: (``_relay_flush``). Every replica derives the same tree from
        #: the sorted member set and ``tree_seed`` (no coordinator); a
        #: ``Down`` re-derives, and past ``tree_degrade_ratio`` locally
        #: down members it gossips flat
        self.tree_gossip = bool(tree_gossip)
        self.tree_fanout = int(tree_fanout)
        if self.tree_gossip and self.tree_fanout < 2:
            raise ValueError(f"tree_fanout must be >= 2, got {tree_fanout!r}")
        self.tree_seed = int(tree_seed)
        self.tree_degrade_ratio = float(tree_degrade_ratio)
        #: tier-0 cluster key (``treesync.group_of``): a fleet stamps its
        #: members with one shared key, so the fleet forms ONE
        #: bottom-tier subtree whose captain alone gossips outward
        self.tree_group = tree_group
        self._tree_topo: "treesync.TreeTopology | None" = None
        self._tree_down: set[Any] = set()
        self._tree_degraded = False
        self._tree_probe_ts = 0.0
        #: REVERSE links: peers outside our tree view that keep opening
        #: walks toward us (their view has us as a link — divergent
        #: views mid-churn) → deadline; we sync back toward them until
        #: they stop, so every view edge is bidirectional
        self._tree_reverse: dict[Any, float] = {}
        #: relay state, all under ``_lock``: per link, the ordered set
        #: of bucket rows still to re-emit (a dict of insertion-ordered
        #: dicts: the order decides the groups and the message order, as
        #: in the JAX replica) and the inbound messages folded into it.
        #: ``_relay_defer`` parks each merge's (sources, rows, bytes) with
        #: its insert/kill count accessor; the next flush reads every
        #: parked count with ONE transfer and stamps only the messages
        #: whose merge changed state — a no-op merge relays nothing,
        #: which is what ends relay cycles between divergent views
        self._relay_defer: list = []
        self._relay_pending: dict[Any, dict[int, None]] = {}
        self._relay_fold: dict[Any, int] = {}
        self._relay_rx_pending = 0
        self._relay_reemits = 0
        self._relay_msgs_folded = 0
        self._relay_entries_emitted = 0
        self._relay_rows_emitted = 0
        self._relay_tx_bytes = 0
        self._relay_rx_bytes = 0
        self._relay_depth_hist: dict[int, int] = {}
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

        t_recover = time.perf_counter()
        wal_header, wal_records = (
            self._wal.recover() if self._wal is not None else (None, [])
        )
        snap = self.storage_module.read(self.name) if self.storage_module else None
        if snap is not None:
            self._rehydrate(snap)
            if wal_header is not None and int(wal_header["node_id"]) != self.node_id:
                raise ValueError(
                    f"WAL for {self.name!r} belongs to node "
                    f"{wal_header['node_id']} but the snapshot is node "
                    f"{self.node_id} — mixed histories in one wal_dir"
                )
        elif wal_header is not None:
            # the crash landed before the first compaction snapshot: fresh
            # columns, but the WAL header keeps the dot namespace (and an
            # explicit conflicting node_id is a mixed history too)
            if node_id is not None and node_id != int(wal_header["node_id"]):
                raise ValueError(
                    f"WAL for {self.name!r} belongs to node "
                    f"{wal_header['node_id']} but node_id={node_id} was "
                    "requested — mixed histories in one wal_dir"
                )
            self._init_fresh(int(wal_header["node_id"]), capacity, replica_capacity)
        else:
            self._init_fresh(
                node_id if node_id is not None else (secrets.randbits(63) | 1),
                capacity,
                replica_capacity,
            )
        if wal_records:
            # snapshot + replay: records past the snapshot's sequence
            # number re-apply through the live flush/merge paths
            self._wal_replay(wal_records, t_recover)
        if self._wal is not None:
            self._wal.bind(self.node_id)
        self.transport.register(self.name, self)
        if self._obs is not None:
            # last: the plane's scrape-time collector polls stats(), so
            # every field it reads must exist already
            self._obs.register_replica(self)

    def _init_fresh(self, node_id: int, capacity: int, replica_capacity: int) -> None:
        self.node_id = node_id
        bin_cap = _pow2(max(capacity // self.num_buckets, 1), floor=4)
        state = self.model.new(self.num_buckets, bin_cap, replica_capacity, device=self.device)
        # claim slot 0 of the context table for our own gid
        state.ctx_gid[0] = _i64(self.node_id)
        self.state = state
        self.self_slot = 0

    # ------------------------------------------------------------------
    # rehydrate / persist (reference causal_crdt.ex:216-250)

    def _rehydrate(self, snap: Snapshot) -> None:
        # __dict__.get, not getattr: a legacy pickle missing the field
        # would otherwise read the dataclass default and pass the guard
        require_layout(
            snap.__dict__.get("layout", "<untagged>"), f"snapshot for {self.name!r}"
        )
        snap_store = snap.__dict__.get("store", "binned")
        if snap_store != self.model.backend:
            raise ValueError(
                f"snapshot for {self.name!r} was written by the "
                f"{snap_store!r} dot store but this replica runs "
                f"{self.model.backend!r} — cross-backend restore goes "
                "through extraction (see MIGRATING.md), or delete the "
                "stored snapshot to start fresh"
            )
        self.node_id = snap.node_id
        self._seq = snap.sequence_number
        # straight onto the replica's device: the JAX dtypes in, the
        # port's layout out
        self.state = self.model.from_numpy(snap.arrays, self.device)
        gids = np.asarray(snap.arrays["ctx_gid"])
        slots = np.nonzero(gids == np.uint64(self.node_id))[0]
        if len(slots) != 1:
            raise ValueError(
                f"snapshot for {self.name!r} holds node {self.node_id} in "
                f"{len(slots)} context slots; a snapshot holds it in exactly one"
            )
        self.self_slot = int(slots[0])
        self._payloads = dict(snap.payloads)
        self._key_terms = dict(snap.key_terms)
        self.clock.observe(snap.last_ts)
        self._applied_seq = dict(snap.__dict__.get("peer_seqs") or {})
        # the snapshot's read map is unknown until a full pass rebuilds it
        self._read_cache = None
        self._read_cache_kh = None

    def _snapshot(self) -> Snapshot:
        # one audited fetch of the full column set, in the JAX package's
        # dtypes and field order (pickle keeps dict order: snapshot
        # bytes are a durability format)
        arrays = self.model.to_numpy(self.state, _TR_SNAPSHOT.get)
        return Snapshot(
            node_id=self.node_id,
            sequence_number=self._seq,
            arrays=arrays,
            payloads=dict(self._payloads),
            key_terms=dict(self._key_terms),
            last_ts=self.clock._last,
            peer_seqs=dict(self._applied_seq),
            store=self.model.backend,
        )

    def _persist(self) -> None:
        if self.storage_module is not None and self.storage_mode == "every_op":
            # every_op durability is the contract: the image is taken
            # under the lock, and callers opted into blocking on it
            self.storage_module.write(self.name, self._snapshot())

    def _wal_arrays_host(self, a: dict) -> dict:
        """Host numpy image of an EntriesMsg column dict for a WAL
        record, in the message's column order (a record pickles dict
        order into its bytes). Host-plane bodies pass through with no
        crossing counted; a tensor body crosses once, under
        ``replica.wal_entries``."""
        if isinstance(a["key"], np.ndarray):
            return {c: np.asarray(v) for c, v in a.items()}
        got = _TR_WAL_ENTRIES.get({c: v for c, v in a.items() if c != "rows"})
        out = {}
        for c, v in a.items():
            if c == "rows":
                out[c] = np.asarray(v)  # host control metadata, as it came
                continue
            out[c] = wire_from_host({c: got[c]})[c]
            # read-only, as the JAX package's device_get copies are (the
            # record's pickled bytes follow the flag)
            out[c].flags.writeable = False
        return out

    def _durable(self, record_fn: Callable[[], dict]) -> None:
        """One durability point per applied batch/slice: with a WAL an
        O(delta) record append + group commit (``fsync_mode`` cadence);
        without, the reference's ``every_op`` full-image write.
        ``record_fn`` is lazy so the non-WAL path never builds a record.
        Replay does not re-log what it is replaying."""
        if self._replaying:
            return
        faultpoint("replica.durable")
        if self._wal is None:
            return self._persist()
        t0 = time.perf_counter()
        try:
            n_bytes = self._wal.append(record_fn())
            self._wal.commit()
        except BaseException:
            # drop the staged record: the caller rolls the seq back, and
            # a stale staged record would flush beside the retry's
            # re-minted seq (a duplicate-seq log is corruption)
            self._wal.abort()
            raise
        self._wal_unc += 1
        if telemetry.has_handlers(telemetry.WAL_APPEND):
            telemetry.execute(
                telemetry.WAL_APPEND,
                {
                    "bytes": n_bytes,
                    "records": 1,
                    "duration_s": time.perf_counter() - t0,
                },
                {"name": self.name},
            )
        if self._wal_unc >= self.compact_every:
            self._compact_wal()

    def _commit_abort(self, exc: BaseException) -> None:
        """Shared tail of every failed durability point: roll the seq
        back, so it keeps naming the last durable record (recovery
        replays a contiguous prefix)."""
        self._seq -= 1
        logger.debug("commit of seq %d aborted: %r", self._seq + 1, exc)
        # the black box shows which commit died and why
        self._flight("commit_abort", seq=self._seq, error=repr(exc))

    def _durable_batch(self, batch: list, ts) -> None:
        """Durability point for one local mutation batch — the single
        definition of the ``batch`` record schema (both flush paths)."""
        if not self._replaying:
            faultpoint("replica.commit.batch")
        if self._lag is not None and not self._replaying:
            # sample this local commit for replication-lag tracing
            # (replay re-applies history, it commits nothing fresh)
            self._lag.note_commit(self.addr, self._seq)
        self._durable(
            lambda: {
                "kind": "batch",
                "seq": self._seq,
                "ops": [tuple(b) for b in batch],
                "ts": ts.tolist(),
            }
        )

    def _ack_floor(self) -> int:
        """Membership compaction gate: the highest seq every MONITORED
        peer is known to have observed. No monitored peers, or the gate
        off, means the snapshot alone caps reclaim."""
        if not self.membership_compaction:
            return self._seq
        peers = [n for n in self._monitors if n != self.addr]
        if not peers:
            return self._seq
        return min(self._ack_seq.get(n, 0) for n in peers)

    def _reclaim_floor(self) -> int:
        """The seq WAL segment reclaim may proceed to: the ack floor,
        bounded below by the ``membership_retain`` horizon and above by
        the snapshot seq — the one definition compaction and ``stats()``
        share."""
        return min(
            self._seq,
            max(self._ack_floor(), self._seq - self.membership_retain),
        )

    def _compact_wal(self) -> None:
        """Checkpoint a snapshot and reclaim fully-covered segments.
        Segments are only DELETED when the checkpoint store is known to
        be disk-backed (it has an ``fsync`` attribute, as
        ``FileStorage`` does): a volatile snapshot (``MemoryStorage``)
        must not cost committed records."""
        t0 = time.perf_counter()
        self.storage_module.write(self.name, self._snapshot())
        floor = self._reclaim_floor()
        if getattr(self.storage_module, "fsync", None) is not None:
            deleted, freed = self._wal.compact(floor)
        else:
            deleted, freed = 0, 0
            self._wal.rotate()  # still bound the active segment's size
        self._wal_unc = 0
        self._flight("wal_compact", segments_deleted=deleted, bytes_reclaimed=freed, ack_floor=floor)
        if telemetry.has_handlers(telemetry.WAL_COMPACT):
            telemetry.execute(
                telemetry.WAL_COMPACT,
                {
                    "segments_deleted": deleted,
                    "bytes_reclaimed": freed,
                    "ack_floor": floor,
                    "duration_s": time.perf_counter() - t0,
                },
                {"name": self.name},
            )

    def _wal_replay(self, records: list, t0: float) -> None:
        """Replay recovered records past the snapshot's sequence number
        through the live flush/merge paths. Local batches re-mint their
        logged LWW timestamps via :class:`ReplayClock` (dot counters
        then reassign identically from the restored per-bucket context),
        so the replayed state is bit for bit the pre-crash one. Diff
        subscribers stay silent: recovery re-applies history, it does
        not re-announce it."""
        base = self._seq
        real_clock, real_diffs = self.clock, self.on_diffs
        self._replaying = True
        self.on_diffs = None
        applied = 0
        max_ts = 0
        try:
            for rec in records:
                seq = int(rec["seq"])
                if seq <= base:
                    continue  # the snapshot already covers this record
                if rec["kind"] == "batch":
                    ts = rec["ts"]
                    self.clock = ReplayClock(ts)
                    self._flush_batch([tuple(op) for op in rec["ops"]])
                    if ts:
                        max_ts = max(max_ts, int(max(ts)))
                elif rec["kind"] == "entries":
                    self._replay_entries(rec)
                else:  # forward-compat: unknown kinds are skipped loudly
                    logger.warning("WAL replay: unknown record kind %r", rec["kind"])
                self._seq = seq  # lockstep even across skipped records
                applied += 1
        finally:
            self.clock, self.on_diffs = real_clock, real_diffs
            self._replaying = False
        # clock continuity: replayed local stamps must not out-rank new
        # writes (the snapshot's last_ts was observed in _rehydrate)
        self.clock.observe(max_ts)
        self._flight("wal_recover", records=applied, bytes=self._wal.recovered_bytes)
        if telemetry.has_handlers(telemetry.WAL_RECOVER):
            telemetry.execute(
                telemetry.WAL_RECOVER,
                {
                    "records": applied,
                    "bytes": self._wal.recovered_bytes,
                    "duration_s": time.perf_counter() - t0,
                },
                {"name": self.name},
            )

    def _replay_entries(self, rec: dict) -> None:
        sl = slice_from_wire(rec["arrays"], self.device)
        self._register_slice_payloads(rec["payloads"])
        try:
            self.state, res = self.model.merge_rows_into(
                self.state, sl, on_grow=self._grown_telemetry
            )
        except CtxGapError:
            # pre-crash this slice merged cleanly, so a gap means the
            # log lost an earlier record: skip it and let anti-entropy
            # repair (never crash a recovery)
            logger.warning(
                "WAL replay: gapped entries record seq %s skipped", rec["seq"]
            )
            return
        self._note_state_changed(
            lambda ins=res.n_inserted, kill=res.n_killed: (ins, kill)
        )
        self._gc_pressure += int(_TR_INGEST_COUNTS.get(res.n_killed))
        self._maybe_gc()

    def checkpoint(self) -> None:
        """Explicit snapshot (for ``storage_mode="interval"``); with a
        WAL a compaction point — the snapshot covers the log, so covered
        segments are reclaimed."""
        with self._lock:
            if self.storage_module is None:
                return
            if self._wal is not None:
                self._compact_wal()
            else:
                self.storage_module.write(self.name, self._snapshot())

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
                state = transition.index_state(stacked, lane)
                if isinstance(stacked, Sharded):
                    # a mesh fleet's lane lives on its shard's device
                    state = tree_map(lambda t: t.to(self.device), state)
                self._state = state
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

    def flush(self) -> None:
        """Apply queued async mutations now (without reading)."""
        with self._lock:
            self._flush()

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
            # removed peers stop gating WAL segment reclaim immediately
            self._ack_seq = {a: s for a, s in self._ack_seq.items() if a in addrs}
            self._sync_open_seq = {a: s for a, s in self._sync_open_seq.items() if a in addrs}
            self._catchup = {a: s for a, s in self._catchup.items() if a in addrs}
            if self.tree_gossip:
                # membership moved: re-derive the spanning tree (every
                # replica fed the same member list lands on the same
                # topology), and forget the failure and relay state of
                # members that left
                self._tree_topo = None
                self._tree_down &= set(addrs)
                self._relay_pending = {a: p for a, p in self._relay_pending.items() if a in addrs}
                self._relay_fold = {a: c for a, c in self._relay_fold.items() if a in addrs}
                self._tree_reverse = {a: t for a, t in self._tree_reverse.items() if a in addrs}
            self.sync_to_all()

    # ------------------------------------------------------------------
    # local mutation batch

    #: largest mutation batch applied in one kernel call
    MAX_BATCH = 1024

    def _flush(self) -> None:
        while self._pending:
            batch = self._pending[: self.MAX_BATCH]
            self._pending = self._pending[self.MAX_BATCH :]
            with tracing.annotate("crdt.flush"):
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

        # durability happens-before publication: a crash between the two
        # may lose only unpublished work. A failed append rolls the seq
        # back so it still names the last durable record.
        try:
            self._durable_batch(batch, ts)
        except BaseException as e:
            self._commit_abort(e)
            raise
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

        # durability happens-before publication (see _flush_batch)
        try:
            self._durable_batch(batch, ts)
        except BaseException as e:
            self._commit_abort(e)
            raise
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
                # growth keeps the content but swaps the store: readers
                # pin the live generation
                self._publish_serve()
                self._grown_telemetry(self._state)

    def _grown_telemetry(self, state) -> None:
        self._flight("growth", capacity=int(state.capacity))
        if telemetry.has_handlers(telemetry.CAPACITY_GROWN):
            telemetry.execute(
                telemetry.CAPACITY_GROWN,
                {"capacity": state.capacity, "replica_capacity": state.replica_capacity},
                {"name": self.name},
            )

    def _flight(self, kind: str, **fields) -> None:
        """Record one structured event in the flight recorder (a no-op
        without an observability plane)."""
        if self.flight is not None:
            self.flight.record(kind, **fields)

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
        # commit boundary: every path reaching here registered its
        # payloads first, so the serving plane's readers may pin it
        self._publish_serve()
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
        deltas, then open the digest-walk round; in tree mode the tick's
        relay epoch follows."""
        with self._lock:
            self._flush()
            if self.tree_gossip:
                self._tree_probe_down()
            self._monitor_neighbours()
            self._push_deltas()
            self._open_walks()
        # the tick's relay epoch: everything merged since the last flush
        # re-emits as ONE merged slice per tree link (no-op when flat)
        self._relay_flush()

    def _open_walks(self, send=None) -> None:
        """Open digest-walk rounds toward every monitored neighbour — the
        tail of :meth:`sync_to_all`, shared with the fleet's batched
        sync tick (whose ``send`` aggregates fleet frames). Caller holds
        the lock."""
        opened = 0
        for n in list(self._monitors):
            if n != self.addr:
                opened += bool(self._open_walk(n, send))
        if opened:
            self._flight("sync_open", peers=opened, seq=self._seq)
            if self._lag is not None:
                # the origin's propagation-round clock: one round per
                # tick that opened walks
                self._lag.note_round(self.addr)

    def _open_walk(self, n, send=None) -> bool:
        """Open one digest-walk round toward ``n`` (≤ 1 in flight); also
        the log-shipping horizon fallback's fresh walk."""
        now = time.monotonic()
        expiry = self._outstanding.get(n)
        if expiry is not None and now < expiry:
            return False
        tree = self._ensure_tree()
        root = np.zeros(1, np.int64)
        blocks = sync_proto.make_blocks(tree, 0, root, self.levels_per_round)
        # openers advertise the log horizon (memoised by the WAL: no disk
        # read on the tick path) so the peer can choose log shipping
        horizon = self._wal.horizon() if self.log_shipping and self._wal is not None else None
        msg = sync_proto.DiffMsg(
            originator=self.addr, frm=self.addr, to=n, level=0, idx=root,
            blocks=blocks, seq=self._seq, log_horizon=horizon,
        )
        if (self.transport.send if send is None else send)(n, msg):
            self._outstanding[n] = now + self.sync_timeout
            # an eventual AckMsg for this round proves the peer held all
            # we had when the round OPENED; expired rounds may overlap in
            # flight, so keep the MINIMUM open seq
            self._sync_open_seq[n] = min(self._sync_open_seq.get(n, self._seq), self._seq)
            return True
        logger.debug("tried to sync with a dead neighbour: %r", n)
        return False

    def _push_deltas(self, send=None) -> None:
        """Eagerly push own fresh dots to each neighbour as
        delta-interval slices (Almeida et al.'s delta mode), plus
        full-row slices of kill-touched rows: plan, extract, emit."""
        for job in self._eager_jobs():
            self._emit_push_job(job, self._extract_push_job(job), send)

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

    def _emit_push_job(self, job: _PushJob, sl, send=None) -> None:
        """Fan one extracted push slice out to the job's peers and
        advance their cursors on successful sends — the emission tail of
        the solo and the fleet egress paths (caller holds the lock).
        ``sl`` is on the device (solo) or already on the host (fleet)."""
        peers = [p[0] for p in job.peers] if job.kind == "delta" else list(job.peers)
        bodies, payloads = self._slice_bodies(sl, job.rows, peers)
        buckets = job.pending.astype(np.int64)
        send = self.transport.send if send is None else send
        for p in job.peers:
            n = p[0] if job.kind == "delta" else p
            msg = sync_proto.EntriesMsg(
                originator=self.addr, frm=self.addr, to=n,
                buckets=buckets, arrays=bodies[n], payloads=payloads,
            )
            if send(n, msg):
                if job.kind == "delta":
                    p[1][job.pending] = job.advance
                else:
                    self._rm_cursor[n] = job.new_cursor

    def _monitor_neighbours(self) -> None:
        """Monitor the sync targets: every neighbour when flat; in tree
        mode the tree links plus the live reverse edges."""
        topo = self._tree_refresh()
        if topo is None:
            targets = list(self._neighbours)
        else:
            links = topo.links(self.addr)
            now = time.monotonic()
            for a in [a for a, t in self._tree_reverse.items() if t <= now]:
                # the peer stopped syncing us: its view caught up (or it
                # left), so the reverse edge retires
                del self._tree_reverse[a]
                if a not in links and a in self._monitors:
                    self.transport.demonitor(self.addr, a)
                    self._monitors.discard(a)
            targets = links + [a for a in self._tree_reverse if a not in links]
        for n in targets:
            if n in self._monitors:
                continue
            if self.transport.monitor(self.addr, n):
                # covers Down-then-up rejoins too: sync_to_all opens a
                # round toward every monitor right after this
                self._monitors.add(n)
                if n in self._tree_down:
                    # a tree link came back: re-derive so the rejoined
                    # member regains its deterministic slot
                    self._tree_down.discard(n)
                    self._tree_topo = None
            else:
                logger.debug("tried to monitor a dead neighbour: %r", n)
                if topo is not None and n != self.addr:
                    # an unmonitorable TREE LINK is a down observation:
                    # re-derive now instead of stalling this edge until a
                    # Down that may never come (we were not monitoring)
                    self._tree_down.add(n)
                    self._tree_topo = None

    # -- tree gossip ------------------------------------------------------
    #
    # Tree mode points the existing sync machinery at the replica's
    # spanning-tree links instead of the whole neighbour set: the
    # monitors (and through them _eager_jobs, _open_walks and the
    # full-row push) cover links only, so own deltas ride the unchanged
    # delta-interval path one edge at a time. What is new is the RELAY:
    # merged inbound slices re-emit onward, coalesced — one merged
    # extraction per link per epoch, not N forwarded frames.

    def _tree_refresh(self) -> "treesync.TreeTopology | None":
        """The current spanning tree, derived lazily and memoised until
        membership or failure state moves — or ``None`` when this replica
        gossips flat (tree mode off, or degraded past
        ``tree_degrade_ratio`` locally observed down members). Caller
        holds the lock."""
        if not self.tree_gossip:
            return None
        members = set(self._neighbours) | {self.addr}
        down = self._tree_down & members
        if treesync.too_damaged(len(members), len(down), self.tree_degrade_ratio):
            if not self._tree_degraded:
                self._tree_degraded = True
                self._tree_topo = None
                self._flight("tree_degrade", down=len(down), members=len(members))
                self._tree_telemetry(None, len(members), len(down))
            return None
        if self._tree_degraded:
            # membership recovered: re-derive out of the flat fallback
            self._tree_degraded = False
            self._tree_topo = None
        topo = self._tree_topo
        if topo is not None:
            return topo
        transport = self.transport
        topo = treesync.derive_tree(
            members,
            fanout=self.tree_fanout,
            seed=self.tree_seed,
            down=down,
            group_key=lambda a: treesync.group_of(transport, a),
        )
        self._tree_topo = topo
        # monitors narrow to the new links (and live reverse edges): a
        # dropped link must not keep feeding _eager_jobs / _open_walks
        # (its cursors stay: soft state, re-covered if the edge returns)
        links = set(topo.links(self.addr)) | set(self._tree_reverse)
        for a in [m for m in self._monitors if m not in links]:
            self.transport.demonitor(self.addr, a)
            self._monitors.discard(a)
            self._outstanding.pop(a, None)
        self._flight(
            "tree_epoch", epoch=topo.epoch, role=topo.role(self.addr),
            tier=int(topo.tier.get(self.addr, 0)), depth=topo.depth,
        )
        self._tree_telemetry(topo, len(members), len(down))
        return topo

    _TREE_ROLE_CODE = {"leaf": 0, "relay": 1, "root": 2}

    def _tree_telemetry(self, topo, members: int, down: int) -> None:
        if telemetry.has_handlers(telemetry.TREE_TOPOLOGY):
            telemetry.execute(
                telemetry.TREE_TOPOLOGY,
                {
                    "depth": 0 if topo is None else topo.depth,
                    "fanout": self.tree_fanout,
                    "tier": 0 if topo is None else int(topo.tier.get(self.addr, 0)),
                    "role": 0 if topo is None else self._TREE_ROLE_CODE[topo.role(self.addr)],
                    "members": members,
                    "down": down,
                    "degraded": int(topo is None),
                },
                {"name": self.name},
            )

    def _tree_probe_down(self) -> None:
        """Throttled liveness probe of locally down NON-link members (a
        link's rejoin is seen by ``_monitor_neighbours``): without it, a
        down member that never re-enters our links would stay out of
        the tree for ever. Caller holds the lock."""
        if not self._tree_down:
            return
        now = time.monotonic()
        if now < self._tree_probe_ts + max(2 * self.sync_interval, 1.0):
            return
        self._tree_probe_ts = now
        rejoined = [a for a in self._tree_down if self.transport.alive(a)]
        if rejoined:
            self._tree_down.difference_update(rejoined)
            self._tree_topo = None

    def _relay_note_merge(self, msgs: list, counts_fn, offsets=None) -> None:
        """Park one committed merge for the next relay flush: each
        message's (source, bucket rows, bytes) with the merge's raw
        insert/kill count accessor. The flush reads every parked count
        with ONE transfer and stamps rows toward every tree link but the
        source edge — only for messages whose merge changed state. That
        changed-only gate is load-bearing: a no-op merge relays nothing,
        so a cycle formed by transiently divergent tree views ends as
        soon as the content stops being news. ``counts_fn`` hands back
        the count tensors as they are (never read them here: one device
        read per message is what the deferral exists to avoid). Caller
        holds the lock."""
        if not self.tree_gossip or self._replaying:
            return
        topo = self._tree_refresh()
        if topo is None or not topo.links(self.addr):
            return
        metas = []
        for m in msgs:
            rows = [int(b) for b in np.asarray(m.buckets).tolist()]
            nbytes = sum(int(v.nbytes) for v in m.arrays.values() if hasattr(v, "nbytes"))
            metas.append((m.frm, rows, nbytes))
        self._relay_defer.append((metas, counts_fn, offsets))

    @staticmethod
    def _relay_changed_per_msg(data, offsets, depth: int) -> list:
        """Per-message changed-entry counts from one fetched count pair:
        whole-slice scalars for a solo merge, per-row arrays and member
        offsets for a grouped one."""
        ins, kill = data
        if offsets is None:
            return [int(np.asarray(ins)) + int(np.asarray(kill))]
        tot = np.cumsum(np.asarray(ins, np.int64) + np.asarray(kill, np.int64))
        out = []
        for lo, hi in offsets[:depth]:
            if hi > lo:
                out.append(int(tot[hi - 1]) - (int(tot[lo - 1]) if lo else 0))
            else:
                out.append(0)
        return out

    def _relay_stamp_deferred(self, topo) -> None:
        """Drain the parked merges into per-link pending rows: one
        transfer for every parked count, then host-only stamping. Caller
        holds the lock."""
        defer, self._relay_defer = self._relay_defer, []
        if not defer:
            return
        links = topo.links(self.addr)
        fetched = _TR_RELAY_ACCOUNTING.get([fn() for _m, fn, _o in defer])
        for (metas, _fn, offsets), data in zip(defer, fetched):
            changed = self._relay_changed_per_msg(data, offsets, len(metas))
            for (frm, rows, nbytes), n_changed in zip(metas, changed):
                if not rows or not n_changed:
                    continue
                self._relay_rx_pending += nbytes
                for a in links:
                    if a == frm:
                        continue
                    pend = self._relay_pending.setdefault(a, {})
                    for b in rows:
                        pend[b] = None
                    self._relay_fold[a] = self._relay_fold.get(a, 0) + 1

    def _relay_flush(self, send=None) -> int:
        """Re-emit pending relayed rows: for each group of links whose
        pending window is identical (in a steady fan-in, every link but
        the source), extract the rows from the MERGED state once
        (``extract_rows``, the walk's own idempotent full-row shape, so
        a lost re-emission heals as a lost walk transfer does) and fan
        the slice out — N inbound frames become one merged re-emission
        per link per epoch. At most ``min(max_sync_size, num_buckets)``
        rows a link a flush; the rest stays pending. Returns the
        messages emitted. The slice is read from the state under the
        lock, and nothing is written into a published tensor."""
        if not self.tree_gossip:
            return 0
        faultpoint("replica.relay.flush")
        with self._lock:
            if not self._relay_pending and not self._relay_defer:
                return 0
            topo = self._tree_refresh()
            if topo is None:
                # degraded to flat: every member hears writers directly
                # again, and the periodic walks heal anything in flight
                self._relay_defer.clear()
                self._relay_pending.clear()
                self._relay_fold.clear()
                self._relay_rx_pending = 0
                return 0
            self._relay_stamp_deferred(topo)
            if not self._relay_pending:
                return 0
            t0 = time.perf_counter()
            links = set(topo.links(self.addr))
            for a in [a for a in self._relay_pending if a not in links]:
                self._relay_pending.pop(a, None)
                self._relay_fold.pop(a, None)
            limit = int(min(self.max_sync_size, self.num_buckets))
            groups: dict[tuple, list] = {}
            for a, pend in self._relay_pending.items():
                batch = tuple(list(pend)[:limit])
                if batch:
                    groups.setdefault(batch, []).append(a)
            if not groups:
                return 0
            send = self.transport.send if send is None else send
            emitted: list[dict] = []
            for batch, peers in groups.items():
                rows = self._wire_rows(np.asarray(batch, np.int64))
                sl = self.model.extract_rows(self.state, self._i64_tensor(rows))
                bodies, payloads = self._slice_bodies(sl, rows, peers)
                buckets = np.asarray(batch, np.int64)
                for a in peers:
                    arrays = bodies[a]
                    tx = sum(int(v.nbytes) for v in arrays.values() if hasattr(v, "nbytes"))
                    msg = sync_proto.EntriesMsg(
                        originator=self.addr, frm=self.addr, to=a,
                        buckets=buckets, arrays=arrays, payloads=payloads,
                    )
                    if not send(a, msg):
                        continue
                    pend = self._relay_pending.get(a)
                    drained = False
                    if pend is not None:
                        for b in batch:
                            pend.pop(b, None)
                        if not pend:
                            self._relay_pending.pop(a, None)
                            drained = True
                    # fold accounting is per COMPLETED window: a flush cut
                    # at the row cap leaves the link's fold count in place
                    # and this continuation adds no depth sample
                    folded = self._relay_fold.pop(a, 0) if drained else None
                    self._relay_reemits += 1
                    self._relay_entries_emitted += len(payloads)
                    self._relay_rows_emitted += len(batch)
                    self._relay_tx_bytes += tx
                    meas = {
                        "entries": len(payloads),
                        "buckets": len(batch),
                        "tx_bytes": tx,
                        "rx_bytes": 0,
                        "duration_s": 0.0,
                    }
                    if folded is not None:
                        self._relay_msgs_folded += folded
                        self._relay_depth_hist[folded] = self._relay_depth_hist.get(folded, 0) + 1
                        meas["depth"] = folded
                    emitted.append(meas)
            if not emitted:
                return 0
            rx, self._relay_rx_pending = self._relay_rx_pending, 0
            self._relay_rx_bytes += rx
            if telemetry.has_handlers(telemetry.TREE_RELAY):
                # flush-level quantities ride the first message's row
                emitted[0]["rx_bytes"] = rx
                emitted[0]["duration_s"] = time.perf_counter() - t0
                telemetry.execute_many(
                    telemetry.TREE_RELAY,
                    emitted,
                    {"name": self.name, "tier": str(int(topo.tier.get(self.addr, 0)))},
                )
            return len(emitted)

    def handle(self, msg) -> None:
        with self._lock:
            if isinstance(msg, sync_proto.DiffMsg):
                self._handle_diff(msg)
            elif isinstance(msg, sync_proto.GetDiffMsg):
                self._flush()
                self._send_entries(to=msg.frm, buckets=msg.buckets, originator=msg.originator)
                self._outstanding.pop(msg.frm, None)
            elif isinstance(msg, sync_proto.EntriesMsg):
                self._handle_entries(msg)
            elif isinstance(msg, sync_proto.AckMsg):
                self._outstanding.pop(msg.clear_addr, None)
                # trees were equal when the acked round's walk ran: the
                # peer covers our state at round open, the watermark WAL
                # compaction reclaims up to
                open_seq = self._sync_open_seq.pop(msg.clear_addr, None)
                if open_seq is not None:
                    self._ack_seq[msg.clear_addr] = max(
                        self._ack_seq.get(msg.clear_addr, 0), open_seq
                    )
            elif isinstance(msg, Down):
                self._monitors.discard(msg.addr)
                self._outstanding.pop(msg.addr, None)
                if self.tree_gossip:
                    # deterministic mid-epoch re-parent: every replica
                    # that observed this Down derives the same tree over
                    # the survivors on its next refresh (or degrades to
                    # flat gossip past the damage threshold)
                    self._tree_down.add(msg.addr)
                    self._tree_topo = None
                    self._relay_pending.pop(msg.addr, None)
                    self._relay_fold.pop(msg.addr, None)
                    self._tree_reverse.pop(msg.addr, None)
                # a dead peer must not gate segment reclaim forever
                self._ack_seq.pop(msg.addr, None)
                self._sync_open_seq.pop(msg.addr, None)
                # a catch-up stream dies with its server: applied chunks
                # were ordinary idempotent merges, so the watermark stands
                # at the last one and the peer's next opener resumes there
                self._catchup.pop(msg.addr, None)
            elif isinstance(msg, sync_proto.GetLogMsg):
                self._handle_get_log(msg)
            elif isinstance(msg, sync_proto.LogChunkMsg):
                self._handle_log_chunk(msg)
            elif isinstance(msg, sync_proto.FleetFrameMsg):
                self._handle_fleet_frame(msg)
            else:
                raise TypeError(f"unknown message: {msg!r}")

    def _handle_fleet_frame(self, msg: sync_proto.FleetFrameMsg) -> None:
        """Fan a fleet egress envelope out. The TCP transport decodes
        ``_FLEETF`` frames before delivery, so this arm serves
        transports that hand the envelope to a mailbox whole: entries
        addressed to this replica dispatch through :meth:`handle` (the
        RLock makes the re-entry a no-op acquire), everything else
        forwards unopened, regrouped per next-hop endpoint."""

        def local(to, m) -> bool:
            if to == self.addr or to == self.name:
                self.handle(m)
                return True
            return False

        forward_fleet_entries(self.transport, msg.entries, local)

    def _handle_diff(self, msg: sync_proto.DiffMsg) -> None:
        if self.tree_gossip and msg.frm != self.addr and msg.originator == msg.frm:
            # ORIGINATOR frames only (openers and the originator's deeper
            # blocks) prove that the peer's own view has us as a sync
            # target; mid-walk replies in rounds WE opened must not
            # count, or our polling of a reverse peer would refresh its
            # deadline for ever
            topo = self._tree_refresh()
            if topo is not None and msg.frm not in topo.links(self.addr):
                # a non-link peer syncing us: its view has us as a link
                # (divergent views mid-churn) — sync back toward it until
                # it stops, so every view edge is bidirectional
                self._tree_reverse[msg.frm] = time.monotonic() + max(6 * self.sync_interval, 3.0)
        self._flush()
        tree = self._ensure_tree()
        end_level, end_idx = sync_proto.walk(
            tree, msg.level, msg.idx, msg.blocks, self.max_sync_size
        )
        if len(end_idx) == 0:
            # trees agree under every compared node ({:ok, []} path). For
            # a ROUND OPENER that is a whole-tree proof: digest equality ⇒
            # content equality ⇒ we cover the sender's state at its
            # stamped seq, the applied watermark log shipping resumes
            # from. Mid-walk frames re-verify only the frontier subtrees
            # (the rest was proven at round open), so their stamps teach
            # nothing watermark-safe
            if (
                msg.level == 0
                and msg.originator == msg.frm
                and msg.seq > self._applied_seq.get(msg.frm, 0)
            ):
                self._note_applied_seq(msg.frm, int(msg.seq))
            cleared = self.addr if msg.originator != self.addr else msg.frm
            self.transport.send(msg.originator, sync_proto.AckMsg(clear_addr=cleared))
            return
        # log-shipping mode decision: on a DIVERGING round opener from a
        # log-capable originator, a peer whose watermark sits within the
        # advertised horizon answers with a GetLogMsg — the divergence is
        # the originator's log suffix past the watermark, so one streamed
        # replay replaces the level walk. Past the horizon the walk heals
        # the compacted prefix regardless (and everything else it
        # finds), so suffix chunks pay only when the servable suffix
        # dwarfs the walk-bound prefix (``catchup_suffix_ratio``). The
        # strict ``seq > watermark`` leg: a diverging opener at or below
        # the watermark means the sender regressed, and its log has
        # nothing for us
        if (
            self.log_shipping
            and msg.level == 0
            and msg.originator == msg.frm
            and msg.originator != self.addr
            and msg.log_horizon is not None
            and msg.seq > self._applied_seq.get(msg.frm, 0)
            and self._applied_seq.get(msg.frm, 0) >= self._catchup_walk_floor.get(msg.frm, 0)
        ):
            watermark = self._applied_seq.get(msg.frm, 0)
            if watermark >= msg.log_horizon or (
                msg.seq - msg.log_horizon >= self.catchup_suffix_ratio * (msg.log_horizon - watermark)
            ):
                self._request_catchup(msg.frm)
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

    def _slice_payload_host(self, sl, rows: np.ndarray) -> tuple[dict, dict]:
        """Host copies (wire dtypes) of the slice columns the payload pass
        reads, and the payload dict of every alive dot in the slice —
        needed on every plane: the key and value terms live on the host."""
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
        return host, payloads

    def _slice_arrays(self, sl, host: dict, target_device, rows: np.ndarray) -> dict:
        """The EntriesMsg column dict for one data plane:

        - ``target_device=None`` — the host plane: numpy columns in the
          JAX dtypes (pickleable for any transport), reusing the copies
          the payload pass made;
        - a pinned device — the device plane: the columns placed on the
          receiver's device in one audited put (``replica.slice_place``),
          tensors in the port's layout; nothing crosses the host.
        """
        names = (*_SLICE_COLUMNS, "ctx_rows", "ctx_lo", "ctx_gid")
        if target_device is None:
            got = wire_from_host(
                _TR_SLICE_WIRE.get({c: getattr(sl, c) for c in names if c not in host})
            )
            arrays = {c: host[c] if c in host else got[c] for c in names}
            for a in arrays.values():
                # read-only, as the JAX package's device_get copies are: a
                # WAL record pickles a read-only array as bytes and a
                # writable one as a bytearray, so this keeps a receiver's
                # records byte-identical whichever package sent the slice
                a.flags.writeable = False
        else:
            placed = _TR_SLICE_PLACE.put({c: getattr(sl, c) for c in names}, target_device)
            # sorted column order, as the JAX package's device_put of a
            # dict hands it back: a WAL record pickles dict order
            arrays = {c: placed[c] for c in sorted(placed)}
        arrays["rows"] = rows  # row indices are control metadata: numpy
        return arrays

    def _slice_wire(self, sl, rows: np.ndarray, target_device=None) -> tuple[dict, dict]:
        """Single-plane wire form of a RowSlice: the column arrays
        (context rows for exactly the shipped buckets) plus the payload
        dict."""
        host, payloads = self._slice_payload_host(sl, rows)
        return self._slice_arrays(sl, host, target_device, rows), payloads

    def _slice_bodies(self, sl, rows: np.ndarray, peers) -> tuple[dict, dict]:
        """Fan-out wire bodies: ONE column dict per distinct pinned device
        among ``peers`` (None = the host plane), shared payloads — a
        fan-out over devices and unpinned peers builds one body a device
        plus one host body, not one a peer. Returns ``({peer: arrays},
        payloads)``."""
        host, payloads = self._slice_payload_host(sl, rows)
        groups: dict[Any, list] = {}
        for n in peers:
            groups.setdefault(self._device_of(n), []).append(n)
        by_peer: dict[Any, dict] = {}
        for dev, members in groups.items():
            arrays = self._slice_arrays(sl, host, dev, rows)
            for n in members:
                by_peer[n] = arrays
        return by_peer, payloads

    @staticmethod
    def _wire_rows(buckets: np.ndarray) -> np.ndarray:
        """Bucket rows padded with -1 to the wire tier (THE row-transfer
        shape of walk transfers, relay re-emissions and catch-up)."""
        rows = np.full(_wire(max(len(buckets), 1)), -1, np.int32)
        rows[: len(buckets)] = np.asarray(buckets, np.int32)
        return rows

    def _extract_rows_wire(self, buckets: np.ndarray, device=None) -> tuple[dict, dict]:
        """Extract the given bucket rows as one wire-tier-padded entries
        body for ``device``'s data plane — shared by walk transfers and
        log-shipping chunks so the padding cannot drift between them."""
        rows = self._wire_rows(buckets)
        sl = self.model.extract_rows(self.state, self._i64_tensor(rows))
        return self._slice_wire(sl, rows, device)

    def _device_of(self, peer):
        """The pinned device of ``peer`` (None: the host plane)."""
        device_of = getattr(self.transport, "device_of", None)
        return device_of(peer) if device_of is not None else None

    def _send_entries(self, to, buckets: np.ndarray, originator) -> bool:
        arrays, payloads = self._extract_rows_wire(buckets, self._device_of(to))
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

    def _handle_entries(self, msg: sync_proto.EntriesMsg, log_noop: bool = True) -> "int | None":
        with tracing.annotate("crdt.merge"):
            return self._handle_entries_inner(msg, log_noop)

    def _handle_entries_inner(self, msg: sync_proto.EntriesMsg, log_noop: bool = True) -> "int | None":
        """Merge one entries slice; returns the entries it inserted or
        killed (None when it gapped and was answered with a repair
        request instead). With ``log_noop`` off, a merge that left the
        state as it was mints no seq and writes no record (a catch-up
        chunk's rows the receiver holds already)."""
        self._flush()
        t0 = time.perf_counter()
        before = self.state
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
            self._flight("gap_repair", peer=str(msg.frm), buckets=int(len(msg.buckets)))
            self.transport.send(
                msg.frm,
                sync_proto.GetDiffMsg(
                    originator=self.addr, frm=self.addr, to=msg.frm,
                    buckets=np.asarray(msg.buckets),
                ),
            )
            return None

        if not log_noop and _same_state(before, self.state):
            self._maybe_gc()
            return 0
        self._seq += 1
        # durability happens-before publication: log the merged slice
        # before diffs or telemetry see it, rolling the seq back if the
        # append fails
        try:
            self._durable(
                lambda: {
                    "kind": "entries",
                    "seq": self._seq,
                    "arrays": self._wal_arrays_host(a),
                    "payloads": dict(msg.payloads),
                }
            )
        except BaseException as e:
            self._commit_abort(e)
            raise
        # relay bookkeeping: the merged rows park for the next flush's
        # changed-only stamping toward every tree link but the source
        # (the two count tensors only, never the whole result)
        self._relay_note_merge([msg], lambda ins=res.n_inserted, kill=res.n_killed: (ins, kill))
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
                {"name": self.name, "plane": "host" if isinstance(a["key"], np.ndarray) else "device"},
            )
        n_ins, n_kill = _TR_INGEST_COUNTS.get((res.n_inserted, res.n_killed))
        self._gc_pressure += int(n_kill)
        self._maybe_gc()
        return int(n_ins) + int(n_kill)

    def _register_slice_payloads(self, payloads: dict) -> int:
        """Register a slice's payloads; returns how many dots were new.
        A dot held already has its payload and its key term (gc prunes
        both together), so only new dots are stored and hashed: a
        full-row slice mostly re-ships entries the receiver holds.

        The new dots are the slice's whole share of gc pressure (the
        merge paths add their kills): a re-shipped dot the replica holds
        is no garbage. The JAX replica counts every shipped payload, so
        a replica answering its peer's digest walks under a write load
        re-merges full rows it holds and runs ``gc()`` over its whole
        payload dict every few rounds, under its lock (``ROADMAP.md``
        §3.8)."""
        pay, terms = self._payloads, self._key_terms
        n = len(pay)
        for dot, p in payloads.items():
            if dot not in pay:
                pay[dot] = p
                terms[key_hash64(p[0])] = p[0]
        n_new = len(pay) - n
        self._gc_pressure += n_new
        return n_new

    # ------------------------------------------------------------------
    # log-shipping catch-up (``replica.py:2792-3165``). The WAL range is
    # a CHANGED-BUCKET INDEX, not replayed literally: re-applying another
    # writer's ``batch`` ops here would re-mint dots under the wrong
    # writer and counters and break add-wins. Full-row slices extracted
    # from the current state are the walk's own transfer shape, so a
    # chunk merges idempotently and bit-comparably with a walk.

    #: watermarks survive Down and set_neighbours churn on purpose (the
    #: rejoin is when they pay off), so the dicts are bounded instead of
    #: pruned: past this many peers the least recently advanced one is
    #: evicted (that peer's next catch-up walks — safe, just slower)
    MAX_PEER_WATERMARKS = 4096

    def _note_applied_seq(self, peer, seq: int) -> None:
        """Advance (never regress) the applied watermark for ``peer``,
        keeping the dict LRU-ordered and bounded; a watermark passing
        the peer's walk floor retires the floor (the walk has healed the
        unservable span it guarded)."""
        d = self._applied_seq
        cur = d.pop(peer, 0)  # pop + reinsert: insertion order ≈ recency
        d[peer] = max(cur, int(seq))
        if self._lag is not None and d[peer] > cur:
            # the lag trace: every sampled commit of ``peer`` at or
            # below the new watermark is visible here now
            self._lag.note_visible(self.addr, peer, d[peer])
        while len(d) > self.MAX_PEER_WATERMARKS:
            d.pop(next(iter(d)))
        floor = self._catchup_walk_floor
        if floor and d[peer] >= floor.get(peer, 0):
            floor.pop(peer, None)
        while len(floor) > self.MAX_PEER_WATERMARKS:
            floor.pop(next(iter(floor)))

    def _request_catchup(self, peer) -> None:
        """Open (or refresh) the one in-flight catch-up stream toward
        ``peer``, resuming from our applied watermark of its history —
        the peer-side answer to a diverging round opener, so data keeps
        flowing originator → peer. Caller holds the lock."""
        if not self.log_shipping or peer == self.addr:
            return
        now = time.monotonic()
        st = self._catchup.get(peer)
        if st is not None and now < st["expiry"]:
            return  # requester-paced: ≤ 1 outstanding request per peer
        last = int(self._applied_seq.get(peer, 0))
        msg = sync_proto.GetLogMsg(frm=self.addr, to=peer, last_seq=last, applied_seq=last)
        if self.transport.send(peer, msg):
            self._flight("catchup_request", peer=str(peer), last_seq=last)
            self._catchup[peer] = {
                "t0": now,
                "expiry": now + self.sync_timeout,
                "chunks": 0,
                "horizon": False,
                # correlates chunks to THIS stream: a chunk answering an
                # older (timed-out) request must not pace follow-ups
                "last_req": last,
            }

    def _iter_log_records(self, lo: int, hi: int):
        """WAL records with ``lo < seq ≤ hi`` in seq order, through the
        bounded range cursor (a huge lag never loads the whole log)."""
        cursor = lo
        while cursor < hi:
            records, next_seq, exhausted = self._wal.read_range(cursor, hi)
            yield from records
            if exhausted or next_seq == cursor:
                return
            cursor = next_seq

    def _scan_log_rows(self, lo: int, hi: int) -> tuple[int, set, int, bool, int | None]:
        """Consume records in ``(lo, hi]`` accumulating the touched-
        bucket set until the chunk row budget fills. Whole records only:
        the chunk's ``seq_hi`` becomes the peer's watermark, so a chunk
        covers EVERY bucket its seq range touched. Records whose row
        effects cannot be served bounded are BARRIERS — an unknown kind,
        or a ``clear`` touching more buckets than the hard row cap. The
        scan stops BEFORE a barrier; a barrier that is the first record
        is returned so the server answers "walk through here, log-ship
        after". A DENSE suffix (the chunk's rows cover a quarter of the
        table when its budget fills) goes on taking whole records up to
        the hard cap: later records then mostly re-touch rows the chunk
        ships anyway, and chunking them apart re-ships those full rows
        once a chunk (with the JAX replica's budget alone, 64 records of
        1024 random keys on a 4096-row table take about 32 chunks of
        about 1600 rows each).
        Returns ``(n_records, touched_rows, seq_hi, more,
        barrier_seq)``."""
        mask = self.num_buckets - 1
        hard_cap = 4 * self.catchup_chunk_rows
        touched: set[int] = set()
        n_rec = 0
        seq_hi = lo
        more = False
        barrier_seq: int | None = None
        for rec in self._iter_log_records(lo, hi):
            if len(touched) >= self.catchup_chunk_rows and 4 * len(touched) < self.num_buckets:
                more = True  # budget full: this record opens the next chunk
                break
            kind = rec.get("kind")
            rec_rows: set[int] | None = None
            if kind == "batch":
                rec_rows = set()
                for f, key_term, _v in rec["ops"]:
                    if f == "clear":
                        # a clear touches every bucket; past the hard cap
                        # it is a barrier (classified without building
                        # the full keyspace set)
                        rec_rows = set(range(self.num_buckets)) if self.num_buckets <= hard_cap else None
                        break
                    rec_rows.add(int(key_hash64(key_term)) & mask)
            elif kind == "entries":
                rows = np.asarray(rec["arrays"]["rows"])
                rec_rows = set(rows[rows >= 0].tolist())
            if rec_rows is None or (
                len(touched) + len(rec_rows) > hard_cap and len(touched | rec_rows) > hard_cap
            ):
                if n_rec == 0:
                    barrier_seq = int(rec["seq"])
                else:
                    more = True
                break
            touched |= rec_rows
            n_rec += 1
            seq_hi = int(rec["seq"])
        return n_rec, touched, seq_hi, more, barrier_seq

    def _extract_catchup_slices(self, rows_sorted: np.ndarray, device) -> list:
        """Full-row entry slices for the touched buckets, on the peer's
        data plane like every other entries transfer: one slice a chunk,
        split only when a record (a ``clear``) pushed the chunk past the
        row budget."""
        limit = self.catchup_chunk_rows
        slices = []
        for s in range(0, len(rows_sorted), limit):
            part = np.asarray(rows_sorted[s : s + limit], np.int64)
            arrays, payloads = self._extract_rows_wire(part, device)
            slices.append({"buckets": part, "arrays": arrays, "payloads": payloads})
        return slices

    def _handle_get_log(self, msg: sync_proto.GetLogMsg) -> None:
        """Serve one bounded catch-up chunk from the WAL window that
        compaction retains. A request below the compaction horizon is
        clamped: the chunk covers ``(horizon, seq_hi]`` with the horizon
        made explicit, and the pre-horizon prefix heals through a digest
        walk opened alongside."""
        self._flush()
        peer = msg.frm
        # applied_seq is the peer's sound claim of how much of OUR
        # history it holds (NOT last_seq, a resume cursor that may sit
        # past barrier spans); a claim beyond our seq is a mixed-history
        # signal and must not reclaim records the peer cannot hold
        if self._ack_seq.get(peer, 0) < int(msg.applied_seq) <= self._seq:
            self._ack_seq[peer] = int(msg.applied_seq)
        if self._wal is None or not self.log_shipping:
            # nothing servable: everything is pre-horizon, heal by walk,
            # superseding the round whose opener prompted this request
            self.transport.send(
                peer,
                sync_proto.LogChunkMsg(
                    frm=self.addr, to=peer, seq_lo=int(msg.last_seq),
                    seq_hi=int(msg.last_seq), more=False, horizon=self._seq, slices=[],
                ),
            )
            self._outstanding.pop(peer, None)
            self._open_walk(peer)
            return
        t0 = time.perf_counter()
        horizon = self._wal.horizon()
        clamped = int(msg.last_seq) < horizon
        lo = max(int(msg.last_seq), horizon)
        hi = self._wal.last_seq
        n_rec, touched, seq_hi, more, barrier_seq = self._scan_log_rows(lo, hi)
        if barrier_seq is not None:
            # the next record is unservable by log: an explicit horizon
            # AT the barrier — the walk covers through it, log shipping
            # resumes after it
            clamped, horizon, more = True, barrier_seq, barrier_seq < hi
        slices = self._extract_catchup_slices(np.sort(np.fromiter(touched, np.int64)), self._device_of(peer))
        sent = self.transport.send(
            peer,
            sync_proto.LogChunkMsg(
                frm=self.addr, to=peer, seq_lo=lo, seq_hi=seq_hi, more=more,
                horizon=horizon if clamped else None, slices=slices,
            ),
        )
        if sent:
            n_bytes = _slices_nbytes(slices)
            n_entries = sum(len(s["payloads"]) for s in slices)
            self._catchup_chunks_served += 1
            self._catchup_bytes_shipped += n_bytes
            # padding accounting: shipped entry lanes against alive entries
            self._catchup_lanes_shipped += sum(int(s["arrays"]["key"].size) for s in slices)
            self._catchup_entries_shipped += n_entries
            if telemetry.has_handlers(telemetry.CATCHUP_CHUNK):
                telemetry.execute(
                    telemetry.CATCHUP_CHUNK,
                    {
                        "records": n_rec,
                        "rows": len(touched),
                        "entries": n_entries,
                        "bytes": n_bytes,
                        "duration_s": time.perf_counter() - t0,
                    },
                    {"name": self.name, "role": "server", "peer": peer},
                )
        if clamped:
            # the round whose opener prompted this request still holds
            # its in-flight slot: supersede it with a FRESH walk, now
            self._outstanding.pop(peer, None)
            self._open_walk(peer)

    def _handle_log_chunk(self, msg: sync_proto.LogChunkMsg) -> None:
        """Apply one catch-up chunk: each slice enters as an
        ``EntriesMsg`` through the normal idempotent merge path (one
        merge a slice: slices are already chunk-sized), then the stream
        either continues (a requester-paced ``GetLogMsg`` from
        ``seq_hi``) or completes."""
        peer = msg.frm
        st = self._catchup.get(peer)
        # a chunk belongs to the CURRENT stream only when it answers our
        # latest request; a superseded request's chunk still applies but
        # neither paces nor completes the stream
        current = st is not None and int(msg.seq_lo) >= int(st["last_req"])
        if not current and int(msg.seq_hi) <= self._applied_seq.get(peer, 0):
            # a chunk of a superseded request (re-sent after its stream
            # timed out while the chunk was still on its way) that our
            # watermark covers already: the JAX replica merges it again
            return
        t0 = time.perf_counter()
        for s in msg.slices:
            # a slice that changes nothing is not logged: the rows it
            # carries are held already (often the receiver's own, back
            # from the peer's log), and a record of them would be served
            # back to that peer in turn — the JAX replica logs it, so
            # two WAL replicas' streams echo each other (``ROADMAP.md``
            # §3.6)
            self._handle_entries(
                sync_proto.EntriesMsg(
                    originator=peer, frm=peer, to=self.addr,
                    buckets=np.asarray(s["buckets"], np.int64),
                    arrays=s["arrays"], payloads=s["payloads"],
                ),
                log_noop=False,
            )
        # full-row slices never gap, so (seq_lo, seq_hi] is now covered —
        # but the watermark advances only when that range CONNECTS to it
        # (a clamped chunk must not claim the unshipped prefix), and
        # never regresses
        if self._applied_seq.get(peer, 0) >= int(msg.seq_lo) and int(msg.seq_hi) > self._applied_seq.get(peer, 0):
            self._note_applied_seq(peer, int(msg.seq_hi))
        self._catchup_chunks_applied += 1
        self._catchup_rows_applied += sum(len(s["buckets"]) for s in msg.slices)
        if msg.horizon is not None:
            self._catchup_horizon_fallbacks += 1
            if st is not None:
                st["horizon"] = True
            # the span through msg.horizon is unservable by this peer's
            # log: walk on future openers until our watermark passes it
            self._catchup_walk_floor[peer] = max(self._catchup_walk_floor.get(peer, 0), int(msg.horizon))
        if telemetry.has_handlers(telemetry.CATCHUP_CHUNK):
            telemetry.execute(
                telemetry.CATCHUP_CHUNK,
                {
                    "records": 0,
                    "rows": sum(len(s["buckets"]) for s in msg.slices),
                    "entries": sum(len(s["payloads"]) for s in msg.slices),
                    "bytes": _slices_nbytes(msg.slices),
                    "duration_s": time.perf_counter() - t0,
                },
                {"name": self.name, "role": "client", "peer": peer},
            )
        if msg.more:
            if not current:
                return  # a superseded stream's chunk: applied, not paced
            st["chunks"] += 1
            st["expiry"] = time.monotonic() + self.sync_timeout
            # resume past any barrier horizon; the watermark gate above
            # keeps the skipped span out of our coverage claim
            nxt = max(int(msg.seq_hi), int(msg.horizon or 0))
            st["last_req"] = nxt
            if not self.transport.send(
                peer,
                sync_proto.GetLogMsg(
                    frm=self.addr, to=peer, last_seq=nxt,
                    # resume cursor ≠ coverage claim
                    applied_seq=int(self._applied_seq.get(peer, 0)),
                ),
            ):
                self._catchup.pop(peer, None)  # server died mid-stream
        elif current:
            dur = time.monotonic() - st["t0"]
            self._catchup_last_duration = dur
            self._flight(
                "catchup_done", peer=str(peer), chunks=st["chunks"] + 1, horizon_fallback=bool(st["horizon"])
            )
            if telemetry.has_handlers(telemetry.CATCHUP_DONE):
                telemetry.execute(
                    telemetry.CATCHUP_DONE,
                    {"chunks": st["chunks"] + 1, "duration_s": dur, "horizon_fallback": int(st["horizon"])},
                    {"name": self.name, "peer": peer},
                )
            if not st["horizon"]:
                # an unclamped stream covered everything up to the
                # server's round-open seq — what a walk-equality ack
                # claims, so the same ack clears the server's slot and
                # advances its compaction watermark for us
                self.transport.send(peer, sync_proto.AckMsg(clear_addr=self.addr))
            self._catchup.pop(peer, None)

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
            # republish with the pruned dict (same version, same state:
            # every published winner is a live dot and survives the
            # prune), so a pinned tuple stops holding the pre-gc dict
            self._publish_serve()

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
        obs = self._obs
        t0 = time.perf_counter() if obs is not None else 0.0
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
            # end-of-drain relay epoch: everything this pass merged
            # re-emits as ONE coalesced slice per tree link, so
            # propagation cascades hop by hop through the relays instead
            # of waiting a sync interval per tree level
            self._relay_flush()
        finally:
            if top:
                with self._lock:
                    deferred, self._telemetry_defer = self._telemetry_defer, None
                if deferred:
                    fetched = _TR_DRAIN_ACCOUNTING.get([f() for f, _e in deferred])
                    for (_f, emit), data in zip(deferred, fetched):
                        emit(data)
        if obs is not None and n:
            # one registry update per drain pass, never per message
            obs.record_drain(self.name, n, time.perf_counter() - t0)
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
                self._handle_entries(m)
            return
        self._flush()
        t0 = time.perf_counter()
        # payloads first, whole group: merged winners must resolve
        # (idempotent, so a fallback below re-registers harmlessly)
        for m in msgs:
            self._register_slice_payloads(m.payloads)
        try:
            with tracing.annotate("crdt.merge_group"):
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
                self._flight("gap_partition", depth=len(msgs), gapped=len(gapped))
                self._handle_entries_group([m for i, m in enumerate(msgs) if i not in gapped], partition=False)
                for i in sorted(gapped):
                    self._count_dispatch(1, 1)
                    self._handle_entries(msgs[i])
                return
            self._ingress_gap_fallbacks += 1
            self._flight("gap_fallback", depth=len(msgs))
            for m in msgs:
                self._count_dispatch(1, 1)
                self._handle_entries(m)
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
        self._gc_pressure += int(_TR_INGEST_COUNTS.get(res.n_killed))
        self._maybe_gc()

    def _commit_entries_group(self, msgs: list, offsets, counts_fn, dt: float) -> None:
        """Per-message bookkeeping of one grouped merge: one sequence
        number and one ``SYNC_DONE`` per message (its count summed from
        the kernel's per-row insert and kill counts over its own rows),
        one ``SYNC_ROUND`` per message with the group's duration split
        evenly. The caller holds the lock and has stored the state.

        Durability happens-before publication: the group's WAL records
        land one message at a time, each with its own seq, and a failed
        append rolls the seq back to the last record that did land, so
        a recovering replica replays a contiguous prefix of the group."""
        for m in msgs:
            self._seq += 1
            a, payloads = m.arrays, m.payloads
            try:
                faultpoint("replica.commit.entries")
                self._durable(
                    lambda a=a, payloads=payloads: {
                        "kind": "entries",
                        "seq": self._seq,
                        "arrays": self._wal_arrays_host(a),
                        "payloads": dict(payloads),
                    }
                )
            except BaseException as e:
                self._commit_abort(e)
                raise
        # commit boundary of the grouped paths (solo grouped and fleet
        # batched): state stored, payloads registered
        self._publish_serve()
        # relay bookkeeping shares this tail, so the grouped solo path and
        # the fleet's batched path park their relay stamps alike (the
        # singleton path parks in _handle_entries_inner); counts_fn is the
        # accessor the SYNC_DONE deferral reads too
        self._relay_note_merge(msgs, counts_fn, offsets)
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
            self._flight("fleet_fallback", depth=len(msgs))
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
            self._gc_pressure += n_killed
            self._maybe_gc()
            return committed_version

    # ------------------------------------------------------------------
    # serving plane (``replica.py:3555-3600``)

    def _publish_serve(self) -> None:
        """Publish the current commit for the serving plane's lock-free
        snapshot readers (caller holds the lock, at a commit boundary:
        every alive dot of the current state has its payload in
        ``_payloads``). One tuple and one attribute store."""
        self._serve_pub = (self._state_version, self._state, self._fleet_src, self._payloads)

    def publish_read_snapshot(self) -> tuple:
        """Publish the current state now and return the published tuple
        (the front door's priming and stale-read refresh hook)."""
        with self._lock:
            self._publish_serve()
            return self._serve_pub

    def frontdoor(self, **opts):
        """This replica's serving front door, created on first use and
        cached: lock-free snapshot reads, coalesced write admission,
        backpressure and shedding (:class:`~delta_crdt_ex_tpu_torch.
        runtime.serve.Frontdoor`). Closed by :meth:`stop` and
        :meth:`crash`; options are fixed at first creation."""
        from delta_crdt_ex_tpu_torch.runtime.serve import Frontdoor

        with self._lock:
            if self._frontdoor is None:
                self._frontdoor = Frontdoor(self, **opts)
            elif opts:
                raise ValueError(
                    f"front door for {self.name!r} already exists; options "
                    "are fixed at first creation"
                )
            return self._frontdoor

    def _close_frontdoor(self) -> None:
        """Detach and close the cached front door. The close joins the
        admission worker, which may be waiting for this replica's lock,
        so it runs outside the lock."""
        with self._lock:
            fd, self._frontdoor = self._frontdoor, None
        if fd is not None:
            fd.close()

    # ------------------------------------------------------------------
    # bench parity helpers (reference ``benchmark_helper.ex:2-14``:
    # ``:hibernate`` compacts before timing, ``:ping`` round-trips the
    # mailbox)

    def hibernate(self) -> str:
        """Quiesce before timing: flush, prune the host dicts, and wait
        for the device."""
        with self._lock:
            self._flush()
            self.gc()
        # the device wait runs outside the lock: a whole in-flight merge
        # pipeline must not hold concurrent mutators and readers
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return "ok"

    def ping(self) -> str:
        """Mailbox round trip: pending async mutations are applied
        before the pong, as a GenServer ``:ping`` is served after every
        queued cast."""
        with self._lock:
            self._flush()
            return "ok"

    def stats(self) -> dict:
        """Observability snapshot. ``ingress`` shows the coalescing of
        ``process_pending``: messages and grouped dispatches, the depth
        histogram (group size → dispatches) and the gap fallbacks;
        ``fleet`` the batched dispatches this replica rode as a fleet
        member; ``catchup`` the log-shipping chunks served and applied,
        rows, bytes, padding and horizon fallbacks; ``wal`` (None
        without a WAL) the records since the last compaction, the
        reclaim floor, the segment count and the log horizon; ``tree``
        (only in tree mode) the derived tree's epoch, this replica's
        role, tier and links, and the relay's re-emissions, folds and
        bytes."""
        from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel

        with self._lock:
            dispatches = self._ingress_dispatches
            messages = self._ingress_messages
            out = {
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
                "catchup": {
                    "store": self.model.backend,
                    "chunks_served": self._catchup_chunks_served,
                    "chunks_applied": self._catchup_chunks_applied,
                    "rows_applied": self._catchup_rows_applied,
                    "bytes_shipped": self._catchup_bytes_shipped,
                    "lanes_shipped": self._catchup_lanes_shipped,
                    "entries_shipped": self._catchup_entries_shipped,
                    # alive entries per shipped lane (1.0 = dense)
                    "chunk_fill_ratio": (
                        round(self._catchup_entries_shipped / self._catchup_lanes_shipped, 4)
                        if self._catchup_lanes_shipped
                        else 0.0
                    ),
                    "horizon_fallbacks": self._catchup_horizon_fallbacks,
                    "in_flight": len(self._catchup),
                    "last_duration_s": round(self._catchup_last_duration, 6),
                },
                "device": str(self.device),
                # process-wide launch count of the probe-window kernel
                "kernel_launches": {probe_lookup_kernel.name: probe_lookup_kernel.launches},
                # process-wide per-site device↔host crossings
                "transfers": transfers.snapshot(),
                "wal": None,
            }
            if self.tree_gossip:
                topo = self._tree_refresh()
                reemits = self._relay_reemits
                out["tree"] = {
                    "degraded": topo is None,
                    "epoch": None if topo is None else topo.epoch,
                    "role": "flat" if topo is None else topo.role(self.addr),
                    "tier": 0 if topo is None else int(topo.tier.get(self.addr, 0)),
                    "depth": 0 if topo is None else topo.depth,
                    "fanout": self.tree_fanout,
                    "members": 0 if topo is None else len(topo.members),
                    "down": len(self._tree_down),
                    "links": [] if topo is None else [str(a) for a in topo.links(self.addr)],
                    "reemits": reemits,
                    "msgs_folded": self._relay_msgs_folded,
                    "folds_per_reemit": round(self._relay_msgs_folded / reemits, 3) if reemits else 0.0,
                    "entries_reemitted": self._relay_entries_emitted,
                    "rows_reemitted": self._relay_rows_emitted,
                    "tx_bytes": self._relay_tx_bytes,
                    "rx_bytes": self._relay_rx_bytes,
                    "depth_hist": dict(sorted(self._relay_depth_hist.items())),
                    "pending_links": len(self._relay_pending),
                    "pending_rows": sum(len(p) for p in self._relay_pending.values()),
                }
            if self._wal is not None:
                out["wal"] = {
                    "uncompacted_records": self._wal_unc,
                    "ack_floor": self._reclaim_floor(),
                    "segments": len(self._wal.segment_paths()),
                    "horizon": self._wal.horizon(),
                }
            return out

    def wal_size_bytes(self) -> int:
        """On-disk WAL footprint (segments + staged append buffer); 0
        without a WAL."""
        with self._lock:
            if self._wal is None:
                return 0
            return self._wal.size_bytes()

    def obs_varz(self) -> dict:
        """This replica's ``/varz`` stanza: the unchanged :meth:`stats`
        dict under a typed envelope, plus the flight recorder's event
        count with a plane attached."""
        out = {"kind": "replica", "stats": self.stats()}
        if self.flight is not None:
            out["flight_events"] = self.flight.events_recorded()
        return out

    def health(self) -> dict:
        """Liveness and readiness for ``/healthz``: the event loop is
        responsive (a fresh heartbeat when threaded; a fleet's members
        are covered by the fleet's tick check), the WAL directory is
        writable, and every configured neighbour is monitored (an
        unmonitorable neighbour is what the transport reported dead)."""
        with self._lock:
            loop_ok = True
            if self._thread is not None:
                loop_ok = self._thread.is_alive() and (
                    time.monotonic() - self._loop_ts < max(5 * self.sync_interval, 2.0)
                )
            wal_ok = self._wal is None or os.access(self._wal.directory, os.W_OK)
            # tree mode: readiness is about OUR sync edges (the tree
            # links), not the whole membership — a leaf monitoring only
            # its parent is healthy by design
            topo = self._tree_refresh()
            targets = self._neighbours if topo is None else topo.links(self.addr)
            neighbours = [n for n in targets if n != self.addr]
            unreachable = [n for n in neighbours if n not in self._monitors]
        return {
            "ok": loop_ok and wal_ok and not unreachable,
            "loop_responsive": loop_ok,
            "wal_writable": wal_ok,
            "neighbours": len(neighbours),
            "neighbours_unreachable": [str(n) for n in unreachable],
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
            next_ckpt = time.monotonic() + self.checkpoint_interval
            while not self._stop.is_set():
                faultpoint("replica.loop")
                self.process_pending()
                with self._lock:
                    # health heartbeat: a wedged loop goes stale and
                    # /healthz turns unready
                    self._loop_ts = time.monotonic()
                    if self._pending:
                        self._flush()
                now = time.monotonic()
                if now >= next_sync:
                    self.sync_to_all()
                    next_sync = now + self.sync_interval
                if (
                    self.storage_mode == "interval"
                    and self.storage_module is not None
                    and now >= next_ckpt
                ):
                    self.checkpoint()
                    next_ckpt = now + self.checkpoint_interval
                with self._lock:
                    # interval-mode fsyncs reach disk even when the
                    # replica goes idle right after a commit (the WAL is
                    # lock-serialised state; crash/stop close it)
                    if self._wal is not None:
                        self._wal.maybe_sync()
                self._wake.wait(timeout=max(0.0, min(next_sync - time.monotonic(), 0.05)))
                self._wake.clear()

        self._thread = threading.Thread(target=loop, name=f"crdt-{self.name}", daemon=True)
        self._thread.start()
        return self

    def crash(self) -> None:
        """Fault injection: die WITHOUT the terminate-path goodbye sync
        (the reference's tests kill the owning process,
        ``causal_crdt_test.exs:87-102``): the loop stops mid-flight,
        nothing is flushed or synced beyond what ``storage_mode`` and
        the WAL's fsync cadence already persisted, and deregistration
        fires ``Down`` at monitoring peers. A later ``start_link`` with
        the same name and storage recovers with the node id kept. With a
        plane attached the flight recorder is dumped through the logger
        (and to ``flight_dump_path`` when set)."""
        self._close_frontdoor()
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=30)
            self._thread = None
        if self.flight is not None:
            self.flight.dump(path=self.flight_dump_path)
        if self._obs is not None:
            self._obs.unregister_replica(self)
        with self._lock:
            # under the lock: a concurrent mutate mid-append must not
            # race the close
            if self._wal is not None:
                # a crash drops whatever the fsync cadence had not yet
                # committed — the durability contract under test
                self._wal.close(flush=False)
        self.transport.unregister(self.name)

    def stop(self) -> None:
        """Terminate: best-effort final sync, an interval-mode
        checkpoint, the WAL's final flush, then deregister (fires
        ``Down`` at monitoring peers)."""
        self._close_frontdoor()
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=30)
            self._thread = None
        if self._obs is not None:
            # a stopped replica must not scrape as a stale last value
            self._obs.unregister_replica(self)
        try:
            self.sync_to_all()
        except Exception:  # best-effort, like the reference's terminate path
            logger.debug("final sync on terminate failed", exc_info=True)
        if self.storage_mode == "interval" and self.storage_module is not None:
            self.checkpoint()
        with self._lock:
            if self._wal is not None:
                self._wal.close(flush=True)
        self.transport.unregister(self.name)
