"""Batched replica fleets — one process, many replicas, one device call
a wave: the PyTorch port of ``delta_crdt_ex_tpu/runtime/fleet.py``.

A :class:`Fleet` owns N member replicas' event loops. It drains all N
mailboxes a :meth:`~Fleet.tick` and joins every member's coalesce groups
with ONE batched merge over a leading replica axis
(:func:`delta_crdt_ex_tpu_torch.runtime.transition.fleet_merge_rows`)
instead of one merge (and one host loop) per replica.

Semantics are the solo replica's, bit for bit:

- grouping reuses each member's own ``_coalesce_groups`` pass, so the
  combined slices are what the solo grouped path would merge;
- lane k of a batched call is the solo op on lane k's inputs;
- seq numbering and telemetry fan back out per replica through the same
  bookkeeping tail as the solo grouped path
  (``Replica._commit_entries_group``).

Scheduling is wave-ordered: each member's drained mailbox splits into
units (a coalesce group, or one other message), and wave w of every
member runs before wave w+1, so per-member arrival order holds while
the units of one wave share a dispatch. Groups bucket by state geometry
and entry-lane tier; ragged row counts and writer tables pad per lane,
and the replica axis pads to a pow2 lane tier with all-padding lanes
(:func:`~delta_crdt_ex_tpu_torch.models.binned_map.stack_entry_slices`).
What a batch cannot carry takes the per-replica path: buckets of one,
diff subscribers, growth and gap escapes (per-lane ``ok``), and
members whose state moved between staging and commit.

A stable batch's member states stay RESIDENT as the stacked result of
the previous dispatch (``Replica.state`` copies a lane out only when
something per-replica reads it), so a steady state neither stacks nor
unstacks. The egress half is batched too (:meth:`Fleet.sync_tick`): the
due members' digest trees, eager-delta extractions and own-counter
columns each run as one call per shape bucket, fanned back out through
the replicas' own plan/emit bookkeeping.

The serving and observability planes: ``obs=`` registers the fleet's
varz and health sources and a scrape-time collector (occupancy, fill,
ticks, egress), :meth:`Fleet.frontdoor` is one front door per member
with key-hash routing, :meth:`Fleet.health` checks the shared loop's
tick freshness. A sync tick's sends to a peer process
whose TCP connection negotiated fleet frames aggregate into ONE
``FleetFrameMsg`` per endpoint (:class:`_FrameCollector`), as in the
JAX fleet. Tree-mode members (``tree_gossip=True``) share ONE tier-0
group key (:func:`~delta_crdt_ex_tpu_torch.runtime.treesync.
fleet_group_key`), so the fleet is a single bottom-tier subtree whose
captain alone gossips outward; each tick's relay epoch runs after the
ingress waves (:meth:`Fleet.tick`) and on the egress tick's send, so
re-emissions ride the frame collector. Members with a ``wal_dir`` log what
the batched merge commits through the solo commit tail, so a crashed
member recovers as a solo replica.

MESH MODE (``mesh=``): the same fleet over a 1-D replica mesh
(:mod:`delta_crdt_ex_tpu_torch.utils.devices`). Every batched dispatch
swaps its fleet form for the ``mesh_fleet_*`` twin
(:mod:`delta_crdt_ex_tpu_torch.runtime.transition`), with the lane tier
padded to a shard multiple; resident stacked states stay block-split
over the shards between ticks (a batched result is already laid out for
the next dispatch); and a sync tick's messages bound for a co-mesh
member ride the intra-mesh delivery plane
(:mod:`delta_crdt_ex_tpu_torch.runtime.meshplane`) as rotations — only
off-mesh destinations take the frame collector or a direct send. Lane k
of a sharded dispatch is the fleet form on lane k's inputs, so mesh and
vmap fleets are equal on state bits, WAL bytes, acks and wire bytes. A
member's lane, when something per-replica reads it, is copied out onto
the member's own device.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import pow2_tier
from delta_crdt_ex_tpu_torch.models.binned_map import stack_entry_slices
from delta_crdt_ex_tpu_torch.ops.binned import _i64
from delta_crdt_ex_tpu_torch.runtime import metrics as metrics_mod
from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, telemetry, transition, treesync
from delta_crdt_ex_tpu_torch.runtime.meshplane import MeshPlane
from delta_crdt_ex_tpu_torch.runtime.replica import Replica, _LaneLevels, _StackedLevels
from delta_crdt_ex_tpu_torch.utils import devices as devices_mod, transfers
from delta_crdt_ex_tpu_torch.utils.devices import Sharded
from delta_crdt_ex_tpu_torch.utils.faults import faultpoint
from delta_crdt_ex_tpu_torch.utils.transfers import as_u32

# audited device↔host transfer sites (the JAX fleet's labels)
_TR_MESH_PLACE = transfers.register("fleet.mesh_place")
_TR_DISPATCH_RESULT = transfers.register("fleet.dispatch_result")
_TR_DISPATCH_COUNTS = transfers.register("fleet.dispatch_counts")
_TR_OWN_CTR_COLUMNS = transfers.register("fleet.own_ctr_columns")
_TR_EGRESS_EXTRACT = transfers.register("fleet.egress_extract")

class _FrameCollector:
    """Per-transport aggregation of one egress tick's outbound sync
    messages into fleet-wide wire frames (JAX ``fleet.py:115-171``):
    sends whose destination endpoint negotiated the ``_FEAT_FLEET``
    capability buffer as ``(to, msg)`` entries and ship at :meth:`flush`
    as ONE :class:`~delta_crdt_ex_tpu_torch.runtime.sync.FleetFrameMsg`
    per endpoint. Everything else (local peers, legacy peers, transports
    without ``fleet_sink``) passes straight through to the normal send.

    ``send`` returning True means the message is committed to a frame
    that a live negotiated connection will carry; a drop after that is
    the lossy-transport case of a per-member send — cursors may run
    ahead of delivery by one tick and the periodic sync re-covers."""

    __slots__ = ("transport", "_sink_of", "_sinks", "frames", "senders")

    def __init__(self, transport) -> None:
        self.transport = transport
        self._sink_of = getattr(transport, "fleet_sink", None)
        self._sinks: dict = {}  # per-tick memo: destination -> sink|None
        self.frames: dict = {}  # endpoint -> [(to, msg), ...] send order
        self.senders: dict = {}  # endpoint -> distinct member addrs

    def send(self, to, msg) -> bool:
        if self._sink_of is not None:
            try:
                sink = self._sinks[to]
            except KeyError:
                # memoised per tick: a dead endpoint pays one connect
                # timeout a tick, not one a message
                sink = self._sinks[to] = self._sink_of(to)
            except TypeError:
                sink = self._sink_of(to)  # unhashable addr: no memo
            if sink is not None:
                self.frames.setdefault(sink, []).append((to, msg))
                self.senders.setdefault(sink, set()).add(getattr(msg, "frm", None))
                return True
        return self.transport.send(to, msg)

    def flush(self) -> "tuple[int, int]":
        """Ship the buffered envelopes; returns ``(frames, member
        slots)`` — distinct contributing members summed over the frames
        shipped."""
        frames = members = 0
        for sink, entries in self.frames.items():
            if self.transport.send_fleet_frame(sink, entries):
                frames += 1
                members += len(self.senders[sink])
        self.frames.clear()
        self.senders.clear()
        return frames, members


#: RowSlice entry columns carried at the dense lane tier (trimmed back
#: per member on the hash store; the ctx tables are never lane-tiered)
_ENTRY_LANE_COLS = ("key", "valh", "ts", "node", "ctr", "alive")


def _lane_slice(host, lane: int, rows: np.ndarray, tier: "int | None"):
    """Lane ``lane`` of a host-fetched stacked RowSlice as the member's
    solo slice: the hash store packs each row's entries as an
    arrival-ordered prefix with zeroed dead lanes, so trimming the
    entry-lane axis to the member's own pow2 tier gives its solo
    extraction bit for bit."""
    out = {}
    for c in host._fields:
        a = getattr(host, c)[lane]
        if tier is not None and c in _ENTRY_LANE_COLS:
            a = a[:, :tier]
        out[c] = a
    out["rows"] = rows  # the job's own planning array (same values)
    return type(host)(**out)


class _EgressMember:
    """One member's snapshot through a batched sync tick: the (state,
    version) pair every batched call reads, the planned push jobs, and
    the solo flag for members whose version moved."""

    __slots__ = ("rep", "state", "version", "need_ctr", "need_tree", "own_ctr", "jobs", "solo")

    def __init__(self, rep, state, version, need_ctr, need_tree):
        self.rep = rep
        self.state = state
        self.version = version
        self.need_ctr = need_ctr
        self.need_tree = need_tree
        self.own_ctr = None
        self.jobs = None
        self.solo = False


class _Staged:
    """One member's staged coalesce group, awaiting a batched dispatch."""

    __slots__ = ("rep", "msgs", "sl", "offsets", "version", "key")

    def __init__(self, rep, msgs, sl, offsets, version, geometry):
        self.rep = rep
        self.msgs = msgs
        self.sl = sl
        self.offsets = offsets
        self.version = version
        # batch-compat bucket: identical state geometry and entry-lane
        # tier; row counts and writer-table widths may be ragged
        self.key = geometry + (sl.key.shape[1],)


class Fleet:
    """Scheduler owning N member replicas' event loops.

    Members must be UNTHREADED (``threaded=False``): the fleet is their
    event loop. Deterministic drives call :meth:`tick` / :meth:`drain` /
    :meth:`sync_tick`; :meth:`start` runs one background thread serving
    every member's periodic sync and the batched ingress drain. All
    members keep their state on one device; a mesh fleet (``mesh=``)
    runs its batched dispatches on the mesh's devices.
    """

    def __init__(self, replicas: list, *, min_batch: int = 2, obs=None, mesh=None, mesh_narrow: bool = True):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        for r in replicas:
            if not isinstance(r, Replica):
                raise TypeError(f"not a Replica: {r!r}")
            if r._thread is not None:
                raise ValueError(
                    f"replica {r.name!r} runs its own event loop; fleet "
                    "members must be started with threaded=False"
                )
            if r._in_fleet:
                raise ValueError(
                    f"replica {r.name!r} already belongs to a fleet; two "
                    "fleets draining one mailbox would race"
                )
        devices = {r.device for r in replicas}
        if len(devices) > 1:
            raise ValueError(
                f"fleet members keep their states on different devices "
                f"({sorted(map(str, devices))}); a fleet stacks them on one"
            )
        self.replicas = list(replicas)
        self.device = replicas[0].device
        #: smallest batch worth stacking: below it the per-replica
        #: grouped path is strictly cheaper
        self.min_batch = max(2, int(min_batch))
        #: mesh mode: a 1-D replica mesh (a Mesh, an int shard count, or
        #: True for the detected devices' default), default off. Batched
        #: dispatches then run the mesh twins, resident stacked states
        #: stay block-split over the shards, and intra-mesh sync-tick
        #: entries deliver as rotations (runtime/meshplane.py)
        self._mesh = None
        self._mesh_shards = 1
        self._mesh_sharding = None
        self._mesh_plane = None
        self._mesh_members_per_shard = 0.0
        if mesh is not None and mesh is not False:
            if mesh is True or isinstance(mesh, int):
                mesh = devices_mod.fleet_mesh(None if mesh is True else mesh)
            if tuple(mesh.axis_names) != (transition.MESH_AXIS,):
                raise ValueError(
                    f"fleet mesh must be 1-D over the {transition.MESH_AXIS!r} axis, got {mesh.axis_names}"
                )
            shards = int(mesh.shards)
            if shards & (shards - 1):
                raise ValueError(f"fleet mesh size must be a power of two, got {shards}")
            if mesh.spans_processes:
                raise ValueError("a fleet is one process: its mesh cannot span torch.distributed ranks")
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(
                    f"fleet mesh devices {[str(d) for d in mesh.devices]} are not the members' "
                    f"device type ({self.device})"
                )
            self._mesh = mesh
            self._mesh_shards = shards
            self._mesh_sharding = transition.replica_sharding(mesh)
            # mesh_narrow=False keeps the padded host round-trip exchange
            self._mesh_plane = MeshPlane(mesh, narrow=mesh_narrow)
            self._mesh_plane.assign([(r.addr, r.transport) for r in self.replicas])
            # membership is fixed at construction: snapshot the ratio so
            # stats() never calls into the plane under the fleet lock
            self._mesh_members_per_shard = self._mesh_plane.members_per_shard()
        # the device topology, read once: stats() must not enumerate
        # devices under the fleet lock on every scrape
        self._mesh_topology = devices_mod.detected_topology()
        #: intra-mesh delivery accounting (read by stats() under the
        #: fleet lock; the sync tick writes it there too)
        self._mesh_intra_entries = 0
        self._mesh_fallback_entries = 0
        self._mesh_permuted_bytes = 0
        self._mesh_exchanges = 0
        self._lock = threading.Lock()
        #: resident stacked states per batch bucket: (members, lanes) →
        #: (member state versions at commit, stacked store). Reused while
        #: no member's state moved outside the batched dispatch; dropped
        #: whenever any lane fell back (its lane in the result is stale)
        self._stack_cache: dict = {}
        self._stack_cache_cap = 32
        self._stack_hits = 0
        self._stack_misses = 0
        self._ticks = 0
        self._tick_time = 0.0
        self._dispatches = 0
        self._batched_messages = 0
        self._occupancy_hist: dict[int, int] = {}
        self._real_rows = 0
        self._padded_rows = 0
        self._fallbacks = {"singleton": 0, "shape": 0, "escape": 0, "stale": 0}
        self._egress_ticks = 0
        self._egress_members = 0
        self._egress_time = 0.0
        self._egress_dispatches = 0
        self._egress_batched_jobs = 0
        self._egress_solo_jobs = 0
        self._egress_solo_members = 0
        self._egress_occupancy: dict[int, int] = {}
        self._egress_tree_batched = 0
        self._egress_frames = 0
        self._egress_frame_members = 0
        #: tick-freshness heartbeat for /healthz (a wedged fleet loop
        #: goes stale)
        self._tick_ts = time.monotonic()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        for r in self.replicas:
            # member notify() wakes the FLEET loop, not a per-replica one
            r.notify = self._member_notify  # type: ignore[method-assign]
            r._in_fleet = True
        #: tree gossip's tier 0: tree-mode members share ONE cluster key,
        #: so the whole fleet is a single bottom-tier subtree — hops
        #: inside it are local mailbox (or, on a mesh, rotation)
        #: deliveries, and only the captain gossips outward. A mesh fleet
        #: keys the cluster on its mesh plane
        if any(r.tree_gossip for r in self.replicas):
            if self._mesh_plane is not None:
                group = self._mesh_plane.tree_group()
            else:
                group = treesync.fleet_group_key([r.addr for r in self.replicas])
            for r in self.replicas:
                if r.tree_group is None:
                    r.tree_group = group
        #: the observability plane: the fleet registers its own varz and
        #: health sources and a scrape-time collector of its counters
        #: (members register themselves through their own ``obs=``)
        self._obs = metrics_mod.resolve_obs(obs)
        #: the cached FleetFrontdoor (``frontdoor()``)
        self._frontdoor = None
        if self._obs is not None:
            self._obs.register_fleet(self)

    def _member_notify(self) -> None:
        if self._thread is not None:
            self._wake.set()

    # ------------------------------------------------------------------
    # ingress: drain all mailboxes, dispatch in waves

    def tick(self) -> int:
        """Drain one bounded batch from every member's mailbox and handle
        it — batched where compatible, per replica everywhere else.
        Returns the messages handled."""
        t0 = time.perf_counter()
        with self._lock:
            # refreshed every tick, busy or idle: readiness means "the
            # loop is turning", not "traffic is flowing"
            self._tick_ts = time.monotonic()
        per_member: list = []
        n_msgs = 0
        for rep in self.replicas:
            batch = rep.transport.drain_nowait(rep.addr, rep.ingress_batch)
            if batch:
                n_msgs += len(batch)
                per_member.append((rep, self._units(rep, batch)))
        wave = 0
        while True:
            pairs = []
            busy = False
            for rep, units in per_member:
                if wave >= len(units):
                    continue
                busy = True
                kind, payload = units[wave]
                if kind == "group":
                    pairs.append((rep, payload))
                else:
                    rep.handle(payload)
            if not busy:
                break
            if pairs:
                self._dispatch_wave(pairs)
            wave += 1
        # the ingress side's relay epoch: what this tick's waves merged
        # into relay members re-emits now, so propagation cascades tick
        # by tick through the fleet instead of waiting for each member's
        # next periodic sync
        for rep, _units in per_member:
            rep._relay_flush()
        if n_msgs:
            with self._lock:
                self._ticks += 1
                self._tick_time += time.perf_counter() - t0
        return n_msgs

    def drain(self, max_rounds: int = 10_000) -> int:
        """Deterministic drive: tick until every mailbox is empty."""
        total = 0
        for _ in range(max_rounds):
            n = self.tick()
            if n == 0:
                return total
            total += n
        raise RuntimeError("fleet did not quiesce")

    def _units(self, rep, batch: list) -> list:
        """Split one member's drained batch into ordered units, as
        ``Replica._handle_batch`` does: consecutive ``EntriesMsg`` runs
        become the member's own coalesce groups; every other message is a
        unit of its own."""
        if not rep.ingress_coalesce or rep.on_diffs is not None:
            return [("msg", m) for m in batch]
        units: list = []
        run: list = []
        for m in batch:
            if isinstance(m, sync_proto.EntriesMsg):
                run.append(m)
                continue
            if run:
                units += [("group", g) for g in rep._coalesce_groups(run)]
                run = []
            units.append(("msg", m))
        if run:
            units += [("group", g) for g in rep._coalesce_groups(run)]
        return units

    def _solo(self, rep, msgs: list, reason: str) -> None:
        with self._lock:
            self._fallbacks[reason] += 1
        rep.fleet_handle_group(msgs)

    def _dispatch_wave(self, pairs: list) -> None:
        """Stage every (member, group) of one wave, bucket by shape
        compatibility, and run one batched dispatch per bucket."""
        buckets: dict[tuple, list] = {}
        for rep, msgs in pairs:
            prep = rep.fleet_prepare(msgs)
            if prep is None:
                self._solo(rep, msgs, "shape")
                continue
            sl, offsets, version, geometry = prep
            staged = _Staged(rep, msgs, sl, offsets, version, geometry)
            buckets.setdefault(staged.key, []).append(staged)
        for members in buckets.values():
            if len(members) < self.min_batch:
                for st in members:
                    self._solo(st.rep, st.msgs, "singleton")
                continue
            self._dispatch_bucket(members)

    def _lane_tier(self, n: int) -> int:
        """The replica axis of one batched call: the pow2 lane tier,
        padded up to the shard count on a mesh so the lanes split evenly
        over the shards (padding lanes merge and extract nothing). Torch
        compiles nothing per shape; the tier keeps the padding, and with
        it ``stats()``'s occupancy and fill ratio, the JAX fleet's."""
        return pow2_tier(max(n, self._mesh_shards), floor=2)

    def _stacked_states(self, reps: list, lanes: int):
        """The stacked input states of one bucket: the previous
        dispatch's RESULT when no member's state moved since
        (``_state_version`` match), else restacked from the members'
        states, padding lanes copying member 0 (their slices are
        all-padding, so the merge leaves them as they are)."""
        key = tuple(id(r) for r in reps) + (lanes,)
        versions = [r._state_version for r in reps]
        with self._lock:
            hit = self._stack_cache.get(key)
            if hit is not None and hit[0] == versions:
                self._stack_hits += 1
                return hit[1], key
            self._stack_misses += 1
        states = [r.state for r in reps]
        states += [states[0]] * (lanes - len(states))
        stacked = transition.stack_states(states)
        if self._mesh_sharding is not None:
            # a fresh stack is placed block-split over the mesh; a cached
            # result is sharded already, which keeps the resident state
            # on the shards between ticks
            stacked = _TR_MESH_PLACE.put(stacked, self._mesh_sharding)
        return stacked, key

    def _dispatch_bucket(self, members: list) -> None:
        t0 = time.perf_counter()
        n = len(members)
        lanes = self._lane_tier(n)
        sl, real_rows = stack_entry_slices([st.sl for st in members], lanes=lanes, device=self.device)
        reps = [st.rep for st in members]
        stacked_in, cache_key = self._stacked_states(reps, lanes)
        # the bucket key holds the backend tag, so every member of a
        # bucket shares one store backend and its batched merge; a mesh
        # fleet runs the twin over the same stacked operands
        if self._mesh is None:
            res = reps[0].model.fleet_merge_rows(stacked_in, sl)
        else:
            res = reps[0].model.mesh_fleet_merge_rows(self._mesh, stacked_in, sl)
        # hash backend: per-lane window pressure rides the same host
        # read, so the growth advisory below costs no extra sync
        wfill = getattr(res, "max_window_fill", None)
        flags = [res.ok, res.n_killed] + ([wfill] if wfill is not None else [])
        if self._mesh is not None:
            flags = [f.gather() for f in flags]
        got = _TR_DISPATCH_RESULT.get(torch.stack([f.to(torch.int64) for f in flags]))  # one read for the bucket
        ok, n_killed = got[0], got[1]
        probe_window = getattr(stacked_in, "probe_window", 0)
        dt = time.perf_counter() - t0
        # per-row counts are read lazily, once for the whole stack, and
        # only if a SYNC_DONE handler asks. The closure holds JUST the
        # two count tensors: holding ``res`` would pin the stacked result
        # for as long as a member keeps the function
        counts_cell: list = []

        def counts_for(lane, ins_rows=res.n_ins_row, kill_rows=res.n_kill_row):
            def fn():
                if not counts_cell:
                    both = [t.gather() if isinstance(t, Sharded) else t for t in (ins_rows, kill_rows)]
                    counts_cell.append(_TR_DISPATCH_COUNTS.get(torch.stack(both)))
                both = counts_cell[0]
                return both[0][lane], both[1][lane]

            return fn

        all_committed = True
        committed = 0
        committed_versions: list[int] = []
        for lane, st in enumerate(members):
            if not ok[lane]:
                # growth/gap escape: the solo path owns the retry tiers
                # and the gap partition and repair
                all_committed = False
                self._solo(st.rep, st.msgs, "escape")
                continue
            new_version = st.rep.fleet_commit(
                st.msgs, st.offsets, res.state, lane, counts_for(lane), int(n_killed[lane]), dt / n, st.version,
            )
            if new_version is not None:
                committed += 1
                committed_versions.append(new_version)
                if wfill is not None and st.rep.model.load_high(int(got[2][lane]), probe_window):
                    # grow OFF the batch path: the version bump drops the
                    # member from the resident stack, and it re-buckets
                    # at its new capacity next tick
                    st.rep.grow_store_advised()
                    all_committed = False
            else:
                # the member's state moved between staging and commit:
                # the batched merge read a stale state — replay solo
                all_committed = False
                self._solo(st.rep, st.msgs, "stale")
        with self._lock:
            if all_committed:
                # the result becomes the members' resident state; the
                # recorded versions are the COMMIT-returned ones (a
                # re-read here could mask a concurrent mutation)
                self._stack_cache[cache_key] = (committed_versions, res.state)
                while len(self._stack_cache) > self._stack_cache_cap:
                    self._stack_cache.pop(next(iter(self._stack_cache)))
            else:
                self._stack_cache.pop(cache_key, None)
            self._dispatches += 1
            self._batched_messages += sum(len(st.msgs) for st in members)
            self._occupancy_hist[committed] = self._occupancy_hist.get(committed, 0) + 1
            self._real_rows += real_rows
            self._padded_rows += lanes * int(sl.rows.shape[1])
        if telemetry.has_handlers(telemetry.FLEET_DISPATCH):
            telemetry.execute(
                telemetry.FLEET_DISPATCH,
                {
                    "replicas": n,
                    "lanes": lanes,
                    "messages": sum(len(st.msgs) for st in members),
                    "rows": real_rows,
                    "padded_rows": lanes * int(sl.rows.shape[1]),
                    "duration_s": dt,
                },
                {"fleet": id(self)},
            )

    # ------------------------------------------------------------------
    # batched sync-tick egress: one batched tree build and one batched
    # extraction per shape bucket, fanned back out through the
    # replicas' own plan/emit bookkeeping

    def sync_tick(self, members: "list | None" = None) -> int:
        """One sync tick for ``members`` (default: every member) with the
        egress half batched across the fleet: each member's planning
        (``Replica._eager_jobs``) and emission (``_emit_push_job`` /
        ``_open_walks``) run under its own lock as ``sync_to_all`` would,
        and the device work between them — the own-counter columns, the
        eager-delta and full-row extractions, the digest-tree builds —
        runs as one call per shape bucket. Lane k of each is the solo
        call on lane k's inputs, so wire bytes, openers and cursors are
        the per-member loop's. Returns the members synced."""
        reps = list(self.replicas if members is None else members)
        if not reps:
            return 0
        t0 = time.perf_counter()
        if len(reps) < self.min_batch:
            for rep in reps:
                rep.sync_to_all()
            with self._lock:
                self._egress_ticks += 1
                self._egress_members += len(reps)
                self._egress_solo_members += len(reps)
                self._egress_time += time.perf_counter() - t0
            return len(reps)

        # phase 0 — per member, under its lock: flush pending mutations,
        # refresh monitors, snapshot (state, version) as THE source of
        # every batched call below
        staged: list = []
        for rep in reps:
            with rep._lock:
                rep._flush()
                rep._monitor_neighbours()
                staged.append(_EgressMember(
                    rep, rep.state, rep._state_version, rep._own_ctr_cache is None, rep._tree is None,
                ))

        # phase 0.5 — the cursor sources: one gather and one transfer per
        # writer-table geometry instead of N column reads
        ctr_groups: dict[tuple, list] = {}
        for ent in staged:
            if ent.need_ctr:
                ctr_groups.setdefault(tuple(ent.state.ctx_max.shape), []).append(ent)
        for items in ctr_groups.values():
            if len(items) < self.min_batch:
                continue  # _eager_jobs reads those solo
            lanes = self._lane_tier(len(items))
            tables = [e.state.ctx_max for e in items]
            tables += [tables[0]] * (lanes - len(items))
            slots = torch.zeros(lanes, dtype=torch.int64)
            slots[: len(items)] = torch.tensor([e.rep.self_slot for e in items])
            stacked_tables = transition.stack_pytrees(*tables)
            if self._mesh is None:
                own = transition.fleet_own_ctr_columns(stacked_tables, slots.to(self.device))
            else:
                own = transition.mesh_fleet_own_ctr_columns(self._mesh, stacked_tables, slots)
            cols = as_u32(_TR_OWN_CTR_COLUMNS.get(own))
            for lane, e in enumerate(items):
                e.own_ctr = cols[lane]

        # phase 1 — per member, under its lock: plan the tick's push jobs
        # against the snapshot (a member whose version moved replays the
        # whole tick solo: its cursors could overrun the shipped claims)
        for ent in staged:
            rep = ent.rep
            with rep._lock:
                if rep._state_version != ent.version:
                    ent.solo = True
                    continue
                if ent.own_ctr is not None and rep._own_ctr_cache is None:
                    rep._own_ctr_cache = ent.own_ctr
                ent.jobs = rep._eager_jobs()

        # phase 2a — bucket push jobs by (backend geometry, job kind, row
        # tier): one batched extraction and one transfer per bucket
        buckets: dict[tuple, list] = {}
        for ent in staged:
            if ent.solo or not ent.jobs:
                continue
            geo = ent.rep.model.geometry(ent.state)
            for job in ent.jobs:
                buckets.setdefault(geo + (job.kind, job.rows.shape[0]), []).append((ent.rep, ent.state, job))
        extracted: dict[int, Any] = {}
        n_dispatch = n_batched_jobs = n_solo_jobs = 0
        occupancy: dict[int, int] = {}
        for items in buckets.values():
            if len(items) < self.min_batch:
                n_solo_jobs += len(items)
                continue
            self._extract_bucket(items, extracted)
            n_dispatch += 1
            n_batched_jobs += len(items)
            occupancy[len(items)] = occupancy.get(len(items), 0) + 1

        # phase 2b — batched digest-tree builds (leaf digests share one
        # geometry across backends); the openers' top levels come over
        # in one transfer a bucket, deep levels stay on the device for
        # the walks to fetch
        tree_groups: dict[int, list] = {}
        for ent in staged:
            if ent.need_tree and not ent.solo:
                tree_groups.setdefault(int(ent.state.leaf.shape[-1]), []).append(ent)
        lane_trees: dict[int, tuple] = {}
        n_tree_batched = 0
        for items in tree_groups.values():
            if len(items) < self.min_batch:
                continue  # _ensure_tree builds those solo
            lanes = self._lane_tier(len(items))
            leaves = [e.state.leaf for e in items]
            leaves += [leaves[0]] * (lanes - len(items))
            stacked_leaves = transition.stack_pytrees(*leaves)
            if self._mesh is None:
                levels = transition.fleet_tree_from_leaves(stacked_leaves)
            else:
                levels = transition.mesh_fleet_tree_from_leaves(self._mesh, stacked_leaves)
            stack = _StackedLevels(levels)
            stack.prefetch(max(e.rep.levels_per_round for e in items))
            n_tree_batched += len(items)
            for lane, e in enumerate(items):
                lane_trees[id(e.rep)] = (stack, lane, e.version)

        # phase 3 — per member, under its lock: adopt the batched tree
        # (version-guarded), emit every job through the shared
        # _emit_push_job tail, open the walk rounds, with sends
        # aggregating into fleet frames. A mesh fleet interposes the
        # intra-mesh delivery plane: co-mesh destinations buffer for the
        # tick's exchange (delivered in order at flush), everything else
        # takes the collector
        exchange = self._mesh_plane.begin_tick() if self._mesh_plane is not None else None
        collectors: dict[int, _FrameCollector] = {}
        for ent in staged:
            rep = ent.rep
            coll = collectors.get(id(rep.transport))
            if coll is None:
                coll = collectors[id(rep.transport)] = _FrameCollector(rep.transport)
            if exchange is None:
                send = coll.send
            else:
                # default-arg capture of JUST the collector's send
                send = lambda to, m, _f=coll.send: exchange.send_via(_f, to, m)  # noqa: E731
            with rep._lock:
                if ent.solo:
                    rep._push_deltas(send)
                    rep._open_walks(send)
                    rep._relay_flush(send)
                    continue
                tv = lane_trees.get(id(rep))
                if tv is not None and rep._tree is None and rep._state_version == tv[2]:
                    rep._tree = _LaneLevels(tv[0], tv[1])
                for job in ent.jobs:
                    sl = extracted.get(id(job))
                    if sl is None:
                        sl = rep._extract_push_job(job)
                    rep._emit_push_job(job, sl, send)
                rep._open_walks(send)
                # the tick's relay epoch: coalesced re-emissions ride the
                # same send, so fleet frames aggregate them per endpoint
                # (and co-mesh links take the exchange)
                rep._relay_flush(send)

        # phase 3.5 — the intra-mesh exchange: rotate the buffered co-mesh
        # entries along the replica axis and deliver every buffered
        # message in global send order (the host path's arrival order)
        mesh_stats = exchange.flush() if exchange is not None else None

        # phase 4 — ship the aggregated fleet frames, one per endpoint
        frames = frame_members = 0
        for coll in collectors.values():
            f, m = coll.flush()
            frames += f
            frame_members += m

        dt = time.perf_counter() - t0
        solo_members = sum(1 for ent in staged if ent.solo)
        with self._lock:
            self._egress_ticks += 1
            self._egress_members += len(reps)
            self._egress_time += dt
            self._egress_dispatches += n_dispatch
            self._egress_batched_jobs += n_batched_jobs
            self._egress_solo_jobs += n_solo_jobs
            self._egress_solo_members += solo_members
            for k, v in occupancy.items():
                self._egress_occupancy[k] = self._egress_occupancy.get(k, 0) + v
            self._egress_tree_batched += n_tree_batched
            self._egress_frames += frames
            self._egress_frame_members += frame_members
            if mesh_stats is not None:
                self._mesh_intra_entries += mesh_stats["intra_entries"]
                self._mesh_fallback_entries += mesh_stats["fallback_entries"]
                self._mesh_permuted_bytes += mesh_stats["permuted_bytes"]
                self._mesh_exchanges += mesh_stats["exchanges"]
        if mesh_stats is not None and telemetry.has_handlers(telemetry.MESH_EXCHANGE):
            telemetry.execute(
                telemetry.MESH_EXCHANGE,
                {
                    "intra_entries": mesh_stats["intra_entries"],
                    "fallback_entries": mesh_stats["fallback_entries"],
                    "permuted_bytes": mesh_stats["permuted_bytes"],
                    "exchanges": mesh_stats["exchanges"],
                    "shards": self._mesh_shards,
                },
                {"fleet": id(self)},
            )
        if telemetry.has_handlers(telemetry.FLEET_EGRESS):
            telemetry.execute(
                telemetry.FLEET_EGRESS,
                {
                    "members": len(reps),
                    "jobs_batched": n_batched_jobs,
                    "jobs_solo": n_solo_jobs + solo_members,
                    "dispatches": n_dispatch,
                    "frames": frames,
                    "frame_members": frame_members,
                    "duration_s": dt,
                },
                {"fleet": id(self)},
            )
        return len(reps)

    def _extract_bucket(self, items: list, extracted: dict) -> None:
        """One batched extraction for a bucket of same-shape push jobs:
        stack the members' snapshot states and job inputs on a leading
        replica axis (pow2 lane tier; padding lanes copy member 0 with
        all ``-1`` rows and gather nothing), run the backend's batched
        form, fetch the WHOLE stacked slice with one transfer, and hand
        each job its lane — trimmed back to the member's own solo tier on
        the hash store — as the host-form slice ``_emit_push_job`` fans
        out."""
        model = items[0][0].model
        n = len(items)
        lanes = self._lane_tier(n)
        states = [st for _rep, st, _job in items]
        states += [states[0]] * (lanes - n)
        stacked = transition.stack_pytrees(*states)
        u = items[0][2].rows.shape[0]
        rows = np.full((lanes, u), -1, np.int64)
        for k, (_rep, _st, job) in enumerate(items):
            rows[k] = job.rows
        put = lambda a: torch.from_numpy(a).to(self.device)
        if items[0][2].kind == "delta":
            slots = np.zeros(lanes, np.int64)
            gids = np.zeros(lanes, np.int64)
            lo = np.zeros((lanes, u), np.int64)
            for k, (rep, _st, job) in enumerate(items):
                slots[k] = rep.self_slot
                gids[k] = _i64(rep.node_id)
                lo[k] = job.lo
            if self._mesh is None:
                sl, tiers = model.fleet_extract_own_delta(stacked, put(rows), put(slots), put(gids), put(lo))
            else:
                sl, tiers = model.mesh_fleet_extract_own_delta(
                    self._mesh, stacked, put(rows), put(slots), put(gids), put(lo)
                )
        elif self._mesh is None:
            sl, tiers = model.fleet_extract_rows(stacked, put(rows))
        else:
            sl, tiers = model.mesh_fleet_extract_rows(self._mesh, stacked, put(rows))
        host = _TR_EGRESS_EXTRACT.get(sl)  # one transfer for the whole bucket
        for k, (_rep, _st, job) in enumerate(items):
            extracted[id(job)] = _lane_slice(host, k, job.rows, None if tiers is None else tiers[k])

    # ------------------------------------------------------------------
    # periodic duties + the one-thread event loop

    def run_duties(self, now: float | None = None) -> None:
        """One pass of every member's periodic duties — the per-replica
        loop body of ``Replica.start``, hoisted so N members share one
        thread: flush pending mutations, the interval checkpoints and
        the WAL's deferred interval-mode fsync, then one batched sync
        tick for the members whose interval is due."""
        now = time.monotonic() if now is None else now
        due: list = []
        for rep in self.replicas:
            with rep._lock:
                if rep._pending:
                    rep._flush()
            if now >= getattr(rep, "_fleet_next_sync", 0.0):
                due.append(rep)
                rep._fleet_next_sync = now + rep.sync_interval
            if rep.storage_mode == "interval" and rep.storage_module is not None:
                nxt = getattr(rep, "_fleet_next_ckpt", None)
                if nxt is None:
                    # first sight: one interval out, as the solo loop
                    # (an immediate checkpoint for every member would
                    # stall the shared thread at start)
                    rep._fleet_next_ckpt = now + rep.checkpoint_interval
                elif now >= nxt:
                    rep.checkpoint()
                    rep._fleet_next_ckpt = now + rep.checkpoint_interval
            with rep._lock:
                if rep._wal is not None:
                    rep._wal.maybe_sync()
        if due:
            self.sync_tick(due)

    def start(self) -> "Fleet":
        """Run the fleet's event loop in ONE background thread serving
        every member: thread count no longer grows with replica count."""
        if self._thread is not None:
            return self
        self._stop.clear()
        min_interval = min(r.sync_interval for r in self.replicas)

        def loop():
            while not self._stop.is_set():
                faultpoint("fleet.loop")
                self.tick()
                self.run_duties()
                self._wake.wait(timeout=min(min_interval, 0.05))
                self._wake.clear()

        self._thread = threading.Thread(target=loop, name=f"crdt-fleet-{id(self):x}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop and every member (best-effort final sync and
        WAL close, the solo ``Replica.stop`` contract per member). Each
        member's goodbye sync is drained before the next member stops:
        the fleet is the loop that serves it, so the recipients merge
        (and log) it before their own WALs close."""
        with self._lock:
            fd, self._frontdoor = self._frontdoor, None
        if fd is not None:
            # close the serving plane first: its admission workers must
            # not race member shutdown (outside the fleet lock: close
            # joins threads)
            fd.close()
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=5)
            self._thread = None
        if self._obs is not None:
            self._obs.unregister_fleet(self)
        for rep in self.replicas:
            rep.stop()
            self.drain()

    # ------------------------------------------------------------------
    # serving plane

    def frontdoor(self, **opts):
        """The fleet's serving front door, created on first use and
        cached: one :class:`~delta_crdt_ex_tpu_torch.runtime.serve.
        Frontdoor` per member plus key-hash routing
        (:class:`~delta_crdt_ex_tpu_torch.runtime.serve.FleetFrontdoor`).
        Closed by :meth:`stop`."""
        from delta_crdt_ex_tpu_torch.runtime.serve import FleetFrontdoor

        with self._lock:
            if self._frontdoor is None:
                self._frontdoor = FleetFrontdoor(self, **opts)
            elif opts:
                raise ValueError("fleet front door already exists; options are fixed at first creation")
            return self._frontdoor

    def obs_varz(self) -> dict:
        """The fleet's ``/varz`` stanza: the unchanged :meth:`stats` dict
        under a typed envelope."""
        return {"kind": "fleet", "stats": self.stats()}

    def health(self) -> dict:
        """Readiness for ``/healthz``: the shared event loop's tick is
        fresh (when threaded; deterministic drives pass). Member WAL and
        neighbour checks ride each member's own ``Replica.health``."""
        with self._lock:
            tick_ts = self._tick_ts
        ok = True
        if self._thread is not None:
            fresh = time.monotonic() - tick_ts < max(5 * min(r.sync_interval for r in self.replicas), 2.0)
            ok = self._thread.is_alive() and fresh
        return {"ok": ok, "loop_responsive": ok, "replicas": len(self.replicas)}

    # ------------------------------------------------------------------
    # observability

    def stats(self) -> dict:
        """Fleet dispatch observability: occupancy (replicas per batched
        dispatch), ragged-mask fill ratio, tick throughput, fallbacks by
        reason, the resident stack's hits and misses, and the egress
        half's counters. Served under the fleet lock: the loop thread
        updates every counter it reports."""
        with self._lock:
            occ = dict(sorted(self._occupancy_hist.items()))
            total = sum(occ.values())
            return {
                "replicas": len(self.replicas),
                "ticks": self._ticks,
                "ticks_per_sec": round(self._ticks / self._tick_time, 3) if self._tick_time else 0.0,
                "dispatches": self._dispatches,
                "batched_messages": self._batched_messages,
                # process-wide per-site device↔host crossings
                "transfers": transfers.snapshot(),
                "occupancy_hist": occ,
                "avg_occupancy": round(sum(k * v for k, v in occ.items()) / total, 3) if total else 0.0,
                "ragged_fill_ratio": (
                    round(self._real_rows / self._padded_rows, 4) if self._padded_rows else 0.0
                ),
                "fallbacks": dict(self._fallbacks),
                "stack_cache": {"hits": self._stack_hits, "misses": self._stack_misses},
                "egress": self._egress_stats_held(),
                "mesh": self._mesh_stats_held(),
            }

    def _mesh_stats_held(self) -> dict:
        """Mesh-mode observability (caller holds the fleet lock): the
        shard layout, intra-mesh against fallback deliveries, permuted
        bytes, exchanges, and the device topology read at construction
        (so every stats consumer says what hardware it ran on)."""
        return {
            "enabled": self._mesh is not None,
            "shards": self._mesh_shards if self._mesh is not None else 0,
            "members_per_shard": self._mesh_members_per_shard,
            "intra_entries": self._mesh_intra_entries,
            "fallback_entries": self._mesh_fallback_entries,
            "permuted_bytes": self._mesh_permuted_bytes,
            "exchanges": self._mesh_exchanges,
            "topology": self._mesh_topology,
        }

    def _egress_stats_held(self) -> dict:
        """Batched-egress observability (caller holds the fleet lock)."""
        occ = dict(sorted(self._egress_occupancy.items()))
        occ_total = sum(occ.values())
        return {
            "ticks": self._egress_ticks,
            "members_synced": self._egress_members,
            "ticks_per_sec": (
                round(self._egress_ticks / self._egress_time, 3) if self._egress_time else 0.0
            ),
            "dispatches": self._egress_dispatches,
            "batched_jobs": self._egress_batched_jobs,
            "solo_jobs": self._egress_solo_jobs,
            "solo_members": self._egress_solo_members,
            "bucket_occupancy_hist": occ,
            "avg_bucket_occupancy": (
                round(sum(k * v for k, v in occ.items()) / occ_total, 3) if occ_total else 0.0
            ),
            "trees_batched": self._egress_tree_batched,
            "frames": self._egress_frames,
            "frame_members": self._egress_frame_members,
            "members_per_frame": (
                round(self._egress_frame_members / self._egress_frames, 3) if self._egress_frames else 0.0
            ),
            "frames_per_tick": (
                round(self._egress_frames / self._egress_ticks, 3) if self._egress_ticks else 0.0
            ),
        }


def start_fleet(replicas: list, *, threaded: bool = True, **opts) -> Fleet:
    """Wrap existing unthreaded replicas in a :class:`Fleet` (``opts`` are
    the Fleet's: ``min_batch``, ``obs``, ``mesh``, ``mesh_narrow``);
    ``threaded=True`` starts its one shared event loop.
    :func:`delta_crdt_ex_tpu_torch.api.start_fleet` builds the replicas
    too."""
    fleet = Fleet(replicas, **opts)
    if threaded:
        fleet.start()
    return fleet
