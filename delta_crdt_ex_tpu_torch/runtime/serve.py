"""The serving front door — the PyTorch port of
``delta_crdt_ex_tpu/runtime/serve.py``: lock-free snapshot reads,
coalesced write admission, backpressure and shedding.

- **Lock-free versioned read snapshots** (:class:`ReadSnapshot`): the
  replica's commit paths publish a ``(version, state, fleet_src,
  payloads)`` tuple (``Replica._serve_pub``, one attribute store under
  the replica lock), read here WITHOUT that lock. The JAX package relies
  on its store pytrees being immutable; the port's tensors are mutable,
  so the same guarantee rests on two invariants the replica keeps: no
  op writes into a tensor a published state holds (every op copies,
  then writes the copy), and the published payload dict is append-only
  for its generation (``Replica.gc`` replaces the dict, it never prunes
  it). Point reads (:meth:`ReadSnapshot.read_keys`, which launches the
  probe-window kernel on the hash store), full reads and prefix scans
  then run off a pinned generation while the event loop keeps merging.
  A read that races a commit window it cannot resolve raises
  :class:`StaleSnapshot` internally and the front door retries on the
  newer generation (bounded, then the classic locked read).
  ``Replica.read(timeout)`` keeps its flush-then-read semantics: it is
  the strong-read mode.
- **Write admission with request coalescing** (:meth:`Frontdoor.mutate`,
  :meth:`Frontdoor.mutate_async`): client ops enqueue on an admission
  queue and one admission worker folds everything queued into ONE
  grouped commit per window through :meth:`Replica.apply_ops`, the
  entrance ``mutate_batch`` uses, so the two cannot drift (WAL and state
  bytes are held equal to the JAX package's in
  ``tests/test_torch_serve.py``). Write tickets resolve when their
  group's commit returned.
- **Backpressure and shedding**: admission is gated on the admission
  queue depth, the transport mailbox depth, the TCP senders'
  ``queue_bytes`` and the WAL compaction backlog; past a limit the op
  is rejected with :class:`Overloaded`. Shedding flips the front door's
  ``/healthz`` check to 503 until the pressure drains, and the
  ``crdt_serve_*`` metrics record admitted, shed, coalesce depth and the
  commit and read latencies.

Every device call here runs on the default stream of the replica's
device, from whichever thread calls it, so the device runs reads and
merges in the order the host submitted them.

Lock order: the front door's one lock is a leaf below the replica lock
(nothing here calls into the replica while holding it; the admission
worker pops its batch, releases, then takes the replica lock inside
``apply_ops``). Snapshot reads take no runtime lock at all.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import pow4_tier
from delta_crdt_ex_tpu_torch.runtime import telemetry, tracing, transition
from delta_crdt_ex_tpu_torch.utils import transfers
from delta_crdt_ex_tpu_torch.utils.hashing import key_hash64
from delta_crdt_ex_tpu_torch.utils.transfers import as_u32, as_u64

# audited device↔host transfer sites (the JAX package's labels)
_TR_WINNER_COLUMNS = transfers.register("serve.winner_columns")
_TR_READ_KEYS = transfers.register("serve.read_keys")


class Overloaded(RuntimeError):
    """The serving plane shed this op (explicit admission rejection).

    ``reason`` names the tripped signal: ``"admission_queue"`` (the
    front door's own pending window), ``"mailbox"`` (the replica's
    transport mailbox depth), ``"queue_bytes"`` (TCP sender queues), or
    ``"wal"`` (WAL compaction backlog). Clients should back off and
    retry; the op was NOT enqueued."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(
            f"serving plane overloaded ({reason})" + (f": {detail}" if detail else "")
        )
        self.reason = reason


class StaleSnapshot(RuntimeError):
    """A snapshot read raced a commit window it cannot resolve (a
    winner dot's payload is not in the pinned payload view). Internal:
    the front door retries against the newer published generation."""


def _winner_columns(model, store) -> tuple:
    """Flat LWW-winner columns ``(key, gid, ctr, ts)`` of a pinned store
    generation in the JAX package's dtypes — the snapshot twin of the
    full-map pass in ``Replica._winner_arrays_rows(None)``: one
    full-table device pass, one batched transfer, one nonzero and flat
    gathers."""
    w = model.winner_all(store)
    win, key, gid, ctr, ts = _TR_WINNER_COLUMNS.get((w.win, w.key, w.gid, w.ctr, w.ts))
    u_idx, b_idx = np.nonzero(win)
    return (
        as_u64(key)[u_idx, b_idx],
        as_u64(gid)[u_idx, b_idx],
        as_u32(ctr[u_idx, b_idx]),
        ts[u_idx, b_idx],
    )


class ReadSnapshot:
    """One pinned read generation: the published store, its payload
    view, and the version it committed at.

    Every read method is a pure function of the pinned triple: no
    replica lock, no event-loop interaction. A missing payload (ruled
    out by the publication invariant: payloads are registered before
    the commit that publishes them) raises :class:`StaleSnapshot`, so
    the front door retries on a fresher generation instead of serving a
    torn view."""

    __slots__ = ("version", "store", "model", "num_buckets", "_payloads")

    def __init__(self, version: int, store, model, num_buckets: int, payloads: dict):
        self.version = version
        self.store = store
        self.model = model
        self.num_buckets = num_buckets
        self._payloads = payloads

    # -- point / bulk reads ---------------------------------------------

    def read_keys(self, key_terms: list) -> "dict | set":
        """Consistent point reads off the pinned generation (the
        lock-free counterpart of ``Replica.read_keys``; on the hash
        store one probe-kernel launch at Q = ``pow4_tier(n, 8)``)."""
        hashes = [key_hash64(k) for k in key_terms]
        k = pow4_tier(max(len(hashes), 1), 8)
        arr = np.zeros(k, np.uint64)
        arr[: len(hashes)] = hashes
        q = torch.from_numpy(arr.view(np.int64)).to(self.store.key.device)
        w = self.model.winners_for_keys(self.store, q)
        found, gid, ctr = _TR_READ_KEYS.get((w.found, w.gid, w.ctr))
        gid = as_u64(gid)
        out = {}
        mask = self.num_buckets - 1
        pay = self._payloads
        for i, term in enumerate(key_terms):
            if found[i]:
                dot = (int(gid[i]), int(hashes[i]) & mask, int(ctr[i]))
                rec = pay.get(dot)
                if rec is None:
                    raise StaleSnapshot(f"winner dot {dot} has no payload")
                out[term] = rec[1]
        return self.model.read_view(out)

    # -- full / scan reads ----------------------------------------------

    def _pairs(self) -> dict:
        """Full resolved map of the pinned generation (the snapshot twin
        of ``Replica._read_pairs``, including the deterministic
        LWW-ascending reinsert when ``==``-equal terms collapse)."""
        key, gid, ctr, ts = _winner_columns(self.model, self.store)
        pay = self._payloads

        def build(k, g, c):
            bucket = (k & np.uint64(self.num_buckets - 1)).astype(np.int64)
            dots = zip(g.tolist(), bucket.tolist(), c.tolist())
            try:
                return dict(map(pay.__getitem__, dots))
            except KeyError as e:
                raise StaleSnapshot(f"winner dot {e} has no payload") from None

        out = build(key, gid, ctr)
        if len(out) == len(key):
            return out
        # ==-equal terms with distinct canonical keys (1 vs True):
        # reinsert in ascending LWW order so the collapse keeps the
        # LWW-greatest write deterministically (Replica._read_pairs)
        order = np.lexsort((ctr, gid, ts))
        return build(key[order], gid[order], ctr[order])

    def read(self) -> "dict | set":
        """Full resolved read off the pinned generation."""
        return self.model.read_view(self._pairs())

    def items(self) -> list:
        """Full read as (key, value) pairs (maps with unhashable keys,
        as ``Replica.read_items``)."""
        key, gid, ctr, _ts = _winner_columns(self.model, self.store)
        bucket = (key & np.uint64(self.num_buckets - 1)).astype(np.int64)
        dots = zip(gid.tolist(), bucket.tolist(), ctr.tolist())
        try:
            return list(map(self._payloads.__getitem__, dots))
        except KeyError as e:
            raise StaleSnapshot(f"winner dot {e} has no payload") from None

    def scan(self, prefix: str) -> "dict | set":
        """Prefix scan over string key terms of the pinned generation
        (non-string keys never match a string prefix)."""
        pairs = self._pairs()
        return self.model.read_view({
            k: v
            for k, v in pairs.items()
            if isinstance(k, str) and k.startswith(prefix)
        })


class WriteTicket:
    """One admitted async write: resolves when its admission group's
    commit returned — the client-facing analog of an ingress ack.
    ``Event``-backed, so waiting is a plain happens-before edge."""

    __slots__ = ("_done", "error", "t_done")

    def __init__(self) -> None:
        self._done = threading.Event()
        self.error: "BaseException | None" = None
        self.t_done = 0.0

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: "float | None" = None) -> None:
        """Block until the group committed; re-raises a commit failure."""
        if not self._done.wait(timeout):
            raise TimeoutError("write not committed within timeout")
        if self.error is not None:
            raise self.error


class _Op:
    __slots__ = ("f", "args", "ticket")

    def __init__(self, f: str, args: list) -> None:
        self.f = f
        self.args = args
        self.ticket = WriteTicket()


class Frontdoor:
    """The serving front door of ONE replica: lock-free snapshot reads,
    coalesced write admission, backpressure and shedding.

    Construction wires the plane into the replica's observability plane
    when one is attached (a ``serve:{name}`` health check and varz
    source, and polled ``crdt_serve_pending_ops`` /
    ``crdt_serve_overloaded`` gauges, removed again on :meth:`close` or
    ``unregister_replica``). The admission worker is one daemon thread
    per front door; reads run on the calling thread and never wait for
    the replica lock.
    """

    def __init__(
        self,
        replica,
        *,
        max_commit_ops: int = 256,
        max_pending_ops: int = 4096,
        max_mailbox_depth: int = 8192,
        max_queue_bytes: int = 32 << 20,
        max_wal_backlog: "int | None" = None,
        shed_health_hold: float = 1.0,
        read_retries: int = 4,
        journal: bool = False,
    ):
        if not (1 <= max_commit_ops <= replica.MAX_BATCH):
            # one admission group == one _flush_batch == one WAL group
            # commit; past MAX_BATCH the flush would split the group and
            # the journal's group boundaries would no longer be the WAL's
            raise ValueError(f"max_commit_ops must be in [1, {replica.MAX_BATCH}]")
        self._rep = replica
        self.name = replica.name
        self.max_commit_ops = int(max_commit_ops)
        self.max_pending_ops = int(max_pending_ops)
        self.max_mailbox_depth = int(max_mailbox_depth)
        self.max_queue_bytes = int(max_queue_bytes)
        self.max_wal_backlog = int(max_wal_backlog) if max_wal_backlog is not None else None
        self.shed_health_hold = float(shed_health_hold)
        self.read_retries = int(read_retries)
        #: one lock for the admission queue, the counters and the
        #: snapshot cache; a LEAF lock — nothing here calls into the
        #: replica (or any other runtime object) while holding it
        self._lock = threading.Lock()
        self._queue: list[_Op] = []
        self._pending_ops = 0  # queued + in flight (the admission window)
        self._admitted_ops = 0
        self._commits = 0
        self._commit_time = 0.0
        self._commit_depth_hist: dict[int, int] = {}
        self._shed_ops = 0
        self._shed_by_reason: dict[str, int] = {}
        self._last_shed_ts = 0.0
        self._reads = 0
        self._read_retries = 0
        self._strong_fallbacks = 0
        self._snap: "ReadSnapshot | None" = None
        self._journal: "list | None" = [] if journal else None
        self._closing = False
        self._stop = threading.Event()
        self._have_ops = threading.Event()
        # prime the publication so the first read never takes the
        # replica lock on the hot path (reentrant if called under it)
        replica.publish_read_snapshot()
        self._obs = replica._obs
        if self._obs is not None:
            self._obs.register_serve(self)
        # started last: every attribute the worker reads exists first
        self._worker = threading.Thread(
            target=self._admission_loop,
            name=f"crdt-serve-{replica.name}",
            daemon=True,
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # reads: lock-free snapshots

    def snapshot(self) -> ReadSnapshot:
        """The newest published read generation, monotone per front door
        (a reader never sees the version go backwards): one attribute
        read of the published tuple, one materialisation per
        publication. A fleet member's lane is copied out of the stacked
        state here once per publication (``transition.index_state``
        clones every column), never once per read."""
        pub = self._rep._serve_pub
        if pub is None:
            pub = self._rep.publish_read_snapshot()
        version = pub[0]
        with self._lock:
            snap = self._snap
            # a hit needs the same PUBLICATION, not just the same
            # version: gc() republishes an identical version with a
            # freshly pruned payload dict, and serving the cached pre-gc
            # view would pin the garbage gc just reclaimed
            if snap is not None and snap.version >= version and (
                snap.version > version or snap._payloads is pub[3]
            ):
                return snap
        # materialise outside the lock: index_state reads a published
        # stacked state nothing writes into (a racing duplicate is benign)
        with tracing.annotate("crdt.serve.publish"):
            _version, state, fleet_src, payloads = pub
            if state is None:
                stacked, lane = fleet_src
                state = transition.index_state(stacked, lane)
            fresh = ReadSnapshot(version, state, self._rep.model, self._rep.num_buckets, payloads)
        with self._lock:
            cur = self._snap
            if (
                cur is None
                or cur.version < fresh.version
                # same version, newer publication (gc's pruned dict):
                # adopt it so the pre-gc dict is released
                or (cur.version == fresh.version and cur._payloads is not fresh._payloads)
            ):
                self._snap = fresh
            return self._snap

    def _read(self, mode: str, fn, strong_fn) -> Any:
        """Shared retry shell of every snapshot read: bounded
        :class:`StaleSnapshot` retries against fresher generations, then
        ``strong_fn`` — the classic locked read — as the last resort.
        Under a profiler the whole read is a ``crdt.serve.read`` span."""
        with tracing.annotate("crdt.serve.read"):
            t0 = time.perf_counter()
            retries = 0
            strong = False
            try:
                for _attempt in range(self.read_retries):
                    snap = self.snapshot()
                    try:
                        return fn(snap)
                    except StaleSnapshot:
                        retries += 1
                        # drop the raced snapshot from the cache (the next
                        # attempt must rebuild, not re-serve it) and force a
                        # fresh publication past the raced window
                        with self._lock:
                            if self._snap is snap:
                                self._snap = None
                        self._rep.publish_read_snapshot()
                strong = True
                return strong_fn()
            finally:
                with self._lock:
                    self._reads += 1
                    self._read_retries += retries
                    if strong:
                        self._strong_fallbacks += 1
                if telemetry.has_handlers(telemetry.SERVE_READ):
                    telemetry.execute(
                        telemetry.SERVE_READ,
                        {"reads": 1, "retries": retries, "duration_s": time.perf_counter() - t0},
                        {"name": self.name, "mode": mode},
                    )

    def read_keys(self, key_terms: list) -> "dict | set":
        """Lock-free consistent point reads (pinned generation)."""
        return self._read(
            "keys",
            lambda snap: snap.read_keys(key_terms),
            lambda: self._rep.read_keys(key_terms),
        )

    def read(self) -> "dict | set":
        """Lock-free full read off the pinned generation. For the strong
        flush-then-read mode call ``Replica.read(timeout)``."""
        return self._read("full", lambda snap: snap.read(), self._rep.read)

    def scan(self, prefix: str) -> "dict | set":
        """Lock-free prefix scan over string keys (pinned generation)."""

        def strong():
            view = self._rep.read()
            d = view if isinstance(view, dict) else {k: True for k in view}
            return self._rep.model.read_view({
                k: v for k, v in d.items() if isinstance(k, str) and k.startswith(prefix)
            })

        return self._read("scan", lambda snap: snap.scan(prefix), strong)

    # ------------------------------------------------------------------
    # writes: admission with request coalescing

    def _validate(self, f: str, args: list) -> None:
        # per-client validation BEFORE grouping: a malformed op must
        # reject its own client, never poison co-admitted ops' commit
        ops = self._rep.model.OPS
        if f not in ops:
            raise ValueError(f"unknown operation {f!r}; available: {sorted(ops)}")
        _, arity = ops[f]
        if len(args) != arity:
            raise ValueError(f"{f} expects {arity} argument(s), got {len(args)}")

    def _overload_reason_locked(self) -> "str | None":
        """The first tripped backpressure signal (caller holds the front
        door's lock). The transport probes are a length or counter read;
        the WAL backlog reads the replica's uncompacted-record count
        without its lock (advisory: a torn read sheds one op early or
        late, and corrupts nothing)."""
        if self._pending_ops >= self.max_pending_ops:
            return "admission_queue"
        rep = self._rep
        depth_fn = getattr(rep.transport, "queue_depth", None)
        if depth_fn is not None and depth_fn(rep.addr) > self.max_mailbox_depth:
            return "mailbox"
        tstats_fn = getattr(rep.transport, "transport_stats", None)
        if tstats_fn is not None and tstats_fn()["queue_bytes"] > self.max_queue_bytes:
            return "queue_bytes"
        if self.max_wal_backlog is not None and rep._wal is not None and rep._wal_unc > self.max_wal_backlog:
            return "wal"
        return None

    def _submit(self, f: str, args: list) -> _Op:
        self._validate(f, args)
        with self._lock:
            if self._closing:
                raise RuntimeError(f"front door for {self.name!r} is closed")
            reason = self._overload_reason_locked()
            if reason is None:
                op = _Op(f, list(args))
                self._queue.append(op)
                self._pending_ops += 1
            else:
                self._shed_ops += 1
                self._shed_by_reason[reason] = self._shed_by_reason.get(reason, 0) + 1
                self._last_shed_ts = time.monotonic()
        if reason is not None:
            if telemetry.has_handlers(telemetry.SERVE_SHED):
                telemetry.execute(telemetry.SERVE_SHED, {"ops": 1}, {"name": self.name, "reason": reason})
            raise Overloaded(reason)
        self._have_ops.set()
        return op

    def mutate(self, f: str, args: list, timeout: "float | None" = None) -> None:
        """Admitted synchronous mutation: returns once the op's admission
        group committed. Raises :class:`Overloaded` when shed — the op
        was NOT applied."""
        self._submit(f, args).ticket.result(timeout)

    def mutate_async(self, f: str, args: list) -> WriteTicket:
        """Admitted asynchronous mutation: returns the
        :class:`WriteTicket` that resolves at group commit."""
        return self._submit(f, args).ticket

    # ------------------------------------------------------------------
    # the admission worker

    def _admission_loop(self) -> None:
        while not self._stop.is_set():
            self._have_ops.wait(timeout=0.05)
            self._have_ops.clear()
            self._drain_admission()
        self._drain_admission()  # commit everything admitted before close

    def _drain_admission(self) -> int:
        """Fold everything queued into grouped commits (one ``apply_ops``
        per window of up to ``max_commit_ops``). The admission window is
        emergent: ops arriving while a commit is in flight form the next
        group."""
        total = 0
        while True:
            with self._lock:
                batch = self._queue[: self.max_commit_ops]
                del self._queue[: len(batch)]
            if not batch:
                return total
            t0 = time.perf_counter()
            err: "BaseException | None" = None
            try:
                # THE shared grouped-commit entrance (mutate_batch's):
                # one lock acquisition, one flush, one WAL group commit
                # for the whole window
                with tracing.annotate("crdt.serve.commit"):
                    self._rep.apply_ops([(op.f, op.args) for op in batch])
            except BaseException as e:  # noqa: BLE001 — fanned out to the tickets
                err = e
            dt = time.perf_counter() - t0
            t_done = time.perf_counter()
            for op in batch:
                op.ticket.error = err
                op.ticket.t_done = t_done
                op.ticket._done.set()
            depth = len(batch)
            with self._lock:
                self._pending_ops -= depth
                self._commits += 1
                self._commit_time += dt
                self._commit_depth_hist[depth] = self._commit_depth_hist.get(depth, 0) + 1
                if err is None:
                    self._admitted_ops += depth
                if self._journal is not None and err is None:
                    self._journal.append([(op.f, list(op.args)) for op in batch])
            if err is None and telemetry.has_handlers(telemetry.SERVE_ADMIT):
                # failed groups are fanned out to their tickets, not
                # counted as admitted (the stats exclude them too)
                telemetry.execute(
                    telemetry.SERVE_ADMIT, {"ops": depth, "duration_s": dt}, {"name": self.name}
                )
            total += depth

    # ------------------------------------------------------------------
    # observability

    def journal(self) -> list:
        """Committed op groups in commit order (``journal=True`` only):
        the record an unloaded twin replays through the same
        ``apply_ops`` entrance to prove the loaded commits bit for bit."""
        with self._lock:
            if self._journal is None:
                raise ValueError("front door was created with journal=False")
            return [list(g) for g in self._journal]

    def stats(self) -> dict:
        with self._lock:
            commits = self._commits
            hist = dict(sorted(self._commit_depth_hist.items()))
            overload = self._overload_reason_locked()
            shedding = overload is not None or time.monotonic() - self._last_shed_ts < self.shed_health_hold
            return {
                "name": self.name,
                "pending_ops": self._pending_ops,
                "admitted_ops": self._admitted_ops,
                "commits": commits,
                "ops_per_commit": round(self._admitted_ops / commits, 3) if commits else 0.0,
                "commit_depth_hist": hist,
                "shed_ops": self._shed_ops,
                "shed_by_reason": dict(self._shed_by_reason),
                "overloaded": shedding,
                "overload_reason": overload,
                "reads": self._reads,
                "read_retries": self._read_retries,
                "strong_read_fallbacks": self._strong_fallbacks,
                "snapshot_version": self._snap.version if self._snap is not None else 0,
            }

    def obs_varz(self) -> dict:
        """``/varz`` stanza: the unchanged :meth:`stats` dict under the
        typed envelope."""
        return {"kind": "serve", "stats": self.stats()}

    def health(self) -> dict:
        """Readiness for ``/healthz``: unready while the plane is
        overloaded (a signal tripped now, or sheds within the last
        ``shed_health_hold`` seconds — the sticky window that makes a
        shed spike observable) or the admission worker died."""
        st = self.stats()
        worker_ok = self._worker.is_alive()
        return {
            "ok": worker_ok and not st["overloaded"],
            "admission_worker_alive": worker_ok,
            "overloaded": st["overloaded"],
            "overload_reason": st["overload_reason"],
            "pending_ops": st["pending_ops"],
            "shed_ops": st["shed_ops"],
        }

    # ------------------------------------------------------------------

    def close(self) -> None:
        """Stop admitting, commit everything already admitted, stop the
        worker, and unwire the observability sources (idempotent)."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
        self._stop.set()
        self._have_ops.set()
        self._worker.join(timeout=10)
        if self._obs is not None:
            self._obs.unregister_serve(self)


class FleetFrontdoor:
    """One front door per fleet member plus key-hash routing. Writes
    route to the key's owner member (``clear`` broadcasts: the union of
    the members' observed-remove clears is the fleet-wide clear);
    ``read_keys`` routes each key to its owner, so clients read their
    own writes per key without waiting for gossip."""

    def __init__(self, fleet, **opts):
        self.fleet = fleet
        # through the replica's accessor: each member's door registers
        # on rep._frontdoor, so a member stopped or crashed on its own
        # closes its door and unwires its gauges as a solo replica does
        self.members = [rep.frontdoor(**opts) for rep in fleet.replicas]

    def member_for(self, key_term) -> Frontdoor:
        return self.members[key_hash64(key_term) % len(self.members)]

    def mutate(self, f: str, args: list, timeout: "float | None" = None) -> None:
        for t in self._route(f, args):
            t.result(timeout)

    def mutate_async(self, f: str, args: list) -> "list[WriteTicket]":
        return self._route(f, args)

    def _route(self, f: str, args: list) -> "list[WriteTicket]":
        # validate before routing: a malformed op gets the solo door's
        # ValueError, not an IndexError from reading args[0]
        self.members[0]._validate(f, args)
        if f == "clear":
            return [fd.mutate_async(f, args) for fd in self.members]
        return [self.member_for(args[0]).mutate_async(f, args)]

    def read_keys(self, key_terms: list) -> "dict | set":
        by_member: dict[int, list] = {}
        for term in key_terms:
            by_member.setdefault(key_hash64(term) % len(self.members), []).append(term)
        out: dict = {}
        for idx, terms in by_member.items():
            view = self.members[idx].read_keys(terms)
            if isinstance(view, dict):
                out.update(view)
            else:  # a set model's member subset
                out.update({t: True for t in view})
        return self.members[0]._rep.model.read_view(out)

    def read(self, member: int = 0) -> "dict | set":
        """One member's lock-free full view (eventually consistent:
        routed writes reach the other members by gossip)."""
        return self.members[member].read()

    def stats(self) -> dict:
        per = [fd.stats() for fd in self.members]
        return {
            "members": len(per),
            "pending_ops": sum(s["pending_ops"] for s in per),
            "admitted_ops": sum(s["admitted_ops"] for s in per),
            "shed_ops": sum(s["shed_ops"] for s in per),
            "commits": sum(s["commits"] for s in per),
            "overloaded": any(s["overloaded"] for s in per),
            "per_member": per,
        }

    def health(self) -> dict:
        per = [fd.health() for fd in self.members]
        return {
            "ok": all(h["ok"] for h in per),
            "members": len(per),
            "overloaded": [str(fd.name) for fd, h in zip(self.members, per) if h["overloaded"]],
        }

    def close(self) -> None:
        for fd in self.members:
            fd.close()


__all__ = [
    "FleetFrontdoor",
    "Frontdoor",
    "Overloaded",
    "ReadSnapshot",
    "StaleSnapshot",
    "WriteTicket",
]
