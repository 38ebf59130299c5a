"""Fleet-wide metrics plane — the PyTorch port's own copy of
``delta_crdt_ex_tpu/runtime/metrics.py`` (the port imports nothing of the
JAX package).

The reference's entire observability surface is one ``:telemetry``
event (``[:delta_crdt, :sync, :done]``, ``causal_crdt.ex:396-398``).
This module is the aggregation layer on top of the port's events:

- :class:`Registry` — a process-wide table of counters / gauges /
  histograms with label sets (replica name, peer, plane, fleet), rendered
  as Prometheus text exposition by :meth:`Registry.render` (served by
  :mod:`delta_crdt_ex_tpu_torch.runtime.obs_server`). Every update
  happens under one registry lock and every read is a snapshot.
- :class:`MetricsBridge` — THE one always-attached telemetry consumer:
  it subscribes to every event tuple declared in
  :mod:`~delta_crdt_ex_tpu_torch.runtime.telemetry` (the subscription
  table in :meth:`MetricsBridge._table` covers exactly
  ``telemetry.declared_events()``) and folds measurements into the
  registry. With no bridge attached the ``has_handlers`` guards on the
  hot paths keep disabled telemetry at a lock check.
- :class:`FlightRecorder` — a bounded per-replica ring buffer of recent
  structured events (sync rounds, catch-up, growth, compaction, gap
  repairs, fallbacks): the black box dumped through the logger on
  :meth:`Replica.crash` and queryable in tests via
  :meth:`FlightRecorder.events`.
- :class:`LagTracer` — dot-provenance replication-lag tracing with zero
  wire changes: the origin samples local-commit times keyed on its
  address and seq, a peer reports visibility when its applied watermark
  of that origin advances, giving per-peer convergence-lag and
  propagation-round histograms.
- :class:`Observability` — the facade the ``obs=`` option of
  :func:`~delta_crdt_ex_tpu_torch.api.start_link` /
  :func:`~delta_crdt_ex_tpu_torch.api.start_fleet` resolves to: one
  registry + bridge + lag tracer + flight-recorder factory, plus the
  varz / health source tables the HTTP endpoint serves.

The metric families are the JAX package's, names, help texts and label
sets alike, less the compile-cache family (``crdt_jit_compiles_total``),
whose event the port does not emit: it compiles nothing per shape.

Metric naming scheme: every name is ``crdt_<noun>[_<unit>]`` with the
Prometheus conventions — ``_total`` counters, ``_seconds`` / ``_bytes``
units, histograms exported as ``_bucket``/``_sum``/``_count``. Label
keys are drawn from the closed set ``name`` (replica), ``peer``,
``origin``, ``plane``, ``role``, ``fleet``, ``transport``, ``reason``
(shed signal), ``mode`` (read class), ``site`` (transfer or fault site).

Lock order (deadlock-free by construction): replica lock →
tracer/recorder lock → registry lock. Nothing here ever acquires a
replica or fleet lock.
"""

from __future__ import annotations

import bisect
import logging
import re
import threading
import time
from typing import Any, Callable

from delta_crdt_ex_tpu_torch.runtime import telemetry

logger = logging.getLogger("delta_crdt_ex_tpu_torch")

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: wall-time histogram buckets (seconds): spans a 100 µs kernel
#: dispatch to a 30 s catch-up stream
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
#: small-count histogram buckets (coalesce depth, batch occupancy,
#: propagation rounds)
COUNT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 64.0, 128.0)


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as ints."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    """Base: one named metric family with a fixed label-name tuple.
    All value state is guarded by the OWNING registry's lock (one lock
    per registry keeps update cost at a single uncontended acquire on
    the hot path and makes reads whole-registry-consistent)."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, label_names: tuple, lock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} for {name!r}")
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = lock

    def _labels(self, labels) -> tuple:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"value(s) {self.label_names}, got {labels!r}"
            )
        # fast path: a tuple of str (what the bridge always passes) is
        # already canonical — the genexpr re-tuple below costs more than
        # the whole locked update on the ingest hot path
        if type(labels) is tuple:
            for v in labels:
                if type(v) is not str:
                    break
            else:
                return labels
        return tuple(str(v) for v in labels)

    def _series(self, labels: tuple) -> str:
        if not labels:
            return self.name
        pairs = ",".join(
            f'{k}="{_escape(v)}"' for k, v in zip(self.label_names, labels)
        )
        return f"{self.name}{{{pairs}}}"


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text, label_names, lock):
        super().__init__(name, help_text, label_names, lock)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, labels: tuple = ()) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up ({amount})")
        labels = self._labels(labels)
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def _inc_held(self, labels: tuple, amount: float = 1.0) -> None:
        """Caller HOLDS the registry lock and has canonicalised
        ``labels`` — the bridge's hot path folds a whole event's
        updates under ONE lock acquire instead of one per metric."""
        self._values[labels] = self._values.get(labels, 0.0) + amount

    def value(self, labels: tuple = ()) -> float:
        labels = self._labels(labels)
        with self._lock:
            return self._values.get(labels, 0.0)

    def _render(self) -> list[str]:
        # caller holds the registry lock
        return [
            f"{self._series(lb)} {_fmt(v)}"
            for lb, v in sorted(self._values.items())
        ]

    def _snapshot(self):
        return dict(self._values)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text, label_names, lock):
        super().__init__(name, help_text, label_names, lock)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, labels: tuple = ()) -> None:
        labels = self._labels(labels)
        with self._lock:
            self._values[labels] = float(value)

    def _set_held(self, labels: tuple, value: float) -> None:
        """Caller HOLDS the registry lock, ``labels`` canonical (see
        :meth:`Counter._inc_held`)."""
        self._values[labels] = float(value)

    def inc(self, amount: float = 1.0, labels: tuple = ()) -> None:
        labels = self._labels(labels)
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def remove(self, labels: tuple = ()) -> None:
        """Drop one label set (a stopped replica's gauges must not scrape
        as a stale last value forever)."""
        labels = self._labels(labels)
        with self._lock:
            self._values.pop(labels, None)

    def value(self, labels: tuple = ()) -> float:
        labels = self._labels(labels)
        with self._lock:
            return self._values.get(labels, 0.0)

    _render = Counter._render
    _snapshot = Counter._snapshot


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, label_names, lock, buckets=LATENCY_BUCKETS):
        super().__init__(name, help_text, label_names, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{self.name}: at least one bucket required")
        self.buckets = b
        # per label set: [per-bucket counts..., +Inf count], sum
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, labels: tuple = ()) -> None:
        labels = self._labels(labels)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(labels)
            if counts is None:
                counts = self._counts[labels] = [0] * (len(self.buckets) + 1)
                self._sums[labels] = 0.0
            counts[i] += 1
            self._sums[labels] += value

    def _observe_held(self, labels: tuple, value: float) -> None:
        """Caller HOLDS the registry lock, ``labels`` canonical (see
        :meth:`Counter._inc_held`)."""
        i = bisect.bisect_left(self.buckets, value)
        counts = self._counts.get(labels)
        if counts is None:
            counts = self._counts[labels] = [0] * (len(self.buckets) + 1)
            self._sums[labels] = 0.0
        counts[i] += 1
        self._sums[labels] += value

    def count(self, labels: tuple = ()) -> int:
        labels = self._labels(labels)
        with self._lock:
            return sum(self._counts.get(labels, ()))

    def sum(self, labels: tuple = ()) -> float:
        labels = self._labels(labels)
        with self._lock:
            return self._sums.get(labels, 0.0)

    def label_sets(self) -> list[tuple]:
        with self._lock:
            return list(self._counts)

    def _render(self) -> list[str]:
        out: list[str] = []
        for lb in sorted(self._counts):
            counts = self._counts[lb]
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                le = (_fmt(ub), lb)
                pairs = ",".join(
                    [f'le="{le[0]}"']
                    + [
                        f'{k}="{_escape(v)}"'
                        for k, v in zip(self.label_names, lb)
                    ]
                )
                out.append(f"{self.name}_bucket{{{pairs}}} {cum}")
            cum += counts[-1]
            pairs = ",".join(
                ['le="+Inf"']
                + [f'{k}="{_escape(v)}"' for k, v in zip(self.label_names, lb)]
            )
            out.append(f"{self.name}_bucket{{{pairs}}} {cum}")
            suffix = self._series(lb)
            base, brace, rest = suffix.partition("{")
            out.append(f"{base}_sum{brace}{rest} {_fmt(self._sums[lb])}")
            out.append(f"{base}_count{brace}{rest} {cum}")
        return out

    def _snapshot(self):
        return {
            lb: {"count": sum(c), "sum": self._sums[lb]}
            for lb, c in self._counts.items()
        }


class Registry:
    """Process-wide metric registry.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent
    for an identical signature, raising on a conflicting re-register),
    so independent subsystems can share families. Collectors registered
    via :meth:`register_collector` are invoked at snapshot/render time
    OUTSIDE the registry lock (they may take replica/fleet locks to
    poll ``stats()`` — the scrape path never holds the registry lock
    while acquiring a runtime lock, keeping the lock order acyclic).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    # -- family registration --------------------------------------------

    def _get_or_create(self, cls, name, help_text, label_names, **kw) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.label_names}"
                    )
                return existing
            metric = cls(name, help_text, tuple(label_names), self._lock, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str, label_names: tuple = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, label_names)

    def gauge(self, name: str, help_text: str, label_names: tuple = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, label_names)

    def histogram(
        self, name: str, help_text: str, label_names: tuple = (),
        buckets=LATENCY_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, label_names, buckets=buckets
        )

    def get(self, name: str) -> "_Metric | None":
        with self._lock:
            return self._metrics.get(name)

    # -- collectors ------------------------------------------------------

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs before every render/snapshot to poll gauges
        from live objects (mailbox depth, WAL segment counts, fleet
        occupancy) — scrape-time cost instead of hot-path cost."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # a dead source must not kill the scrape
                logger.debug("metrics collector failed", exc_info=True)

    # -- export ----------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._run_collectors()
        lines: list[str] = []
        with self._lock:
            for name, m in self._metrics.items():
                samples = m._render()
                if not samples:
                    continue
                lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                lines.extend(samples)
        return "\n".join(lines) + "\n"

    def families(self) -> int:
        """Registered metric-family count — the cheap header number for
        ``/varz`` (``snapshot()`` would re-run every collector, i.e.
        re-poll every replica/fleet/WAL source, just to be counted)."""
        with self._lock:
            return len(self._metrics)

    def snapshot(self) -> dict:
        """Structured value snapshot (tests / the JSON varz surface)."""
        self._run_collectors()
        out: dict = {}
        with self._lock:
            for name, m in self._metrics.items():
                values = {
                    "|".join(lb) if lb else "": v
                    for lb, v in m._snapshot().items()
                }
                out[name] = {"type": m.kind, "values": values}
        return out


# ----------------------------------------------------------------------
# the telemetry -> metrics bridge

def _with_batch(per_message: Callable, batch: Callable) -> Callable:
    """Wrap a per-message handler with a ``batch`` attribute —
    ``telemetry.execute_many`` dispatches the whole list to ``batch``
    in one call; plain ``execute`` (and non-batch handlers) still see
    per-message calls. A function object because bound methods reject
    attribute assignment."""
    def handler(event, meas, meta):
        per_message(event, meas, meta)
    handler.batch = batch
    return handler


class MetricsBridge:
    """THE always-attached telemetry consumer: every event tuple
    declared in :mod:`~delta_crdt_ex_tpu_torch.runtime.telemetry` has a
    row in :meth:`_table` folding its measurements into registry
    metrics; :meth:`attach` warns about a declared event without one."""

    def __init__(self, registry: Registry):
        self.registry = registry
        #: the registry's one lock: each handler folds its whole
        #: event's updates under a single acquire (the ``*_held``
        #: metric primitives) — per-metric ``inc``/``observe`` calls
        #: would pay one acquire each on the ingest hot path
        self._lock = registry._lock
        self._attached = False
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.sync_done = c(
            "crdt_sync_done_total", "Merges applied (local + remote)", ("name",)
        )
        self.keys_updated = c(
            "crdt_sync_keys_updated_total", "Keys changed by merges", ("name",)
        )
        self.capacity_grown = c(
            "crdt_capacity_grown_total", "Store growth events", ("name",)
        )
        self.capacity = g(
            "crdt_capacity", "Current store entry capacity", ("name",)
        )
        self.sync_rounds = c(
            "crdt_sync_rounds_total", "Entry slices merged", ("name", "plane")
        )
        self.sync_seconds = h(
            "crdt_merge_dispatch_seconds",
            "Per-slice merge wall time (kernel accounting)",
            ("name", "plane"),
        )
        self.sync_entries = c(
            "crdt_sync_entries_total", "Entries received in slices",
            ("name", "plane"),
        )
        self.sync_buckets = c(
            "crdt_sync_buckets_total", "Bucket rows received in slices",
            ("name", "plane"),
        )
        self.ingest_dispatches = c(
            "crdt_ingest_dispatches_total", "Grouped fan-in dispatches", ("name",)
        )
        self.ingest_messages = c(
            "crdt_ingest_coalesced_messages_total",
            "Messages folded into grouped dispatches", ("name",),
        )
        self.ingest_depth = h(
            "crdt_ingest_coalesce_depth", "Messages per grouped dispatch",
            ("name",), buckets=COUNT_BUCKETS,
        )
        self.ingest_seconds = h(
            "crdt_ingest_dispatch_seconds", "Grouped dispatch wall time",
            ("name",),
        )
        self.wal_records = c(
            "crdt_wal_append_records_total", "WAL records appended", ("name",)
        )
        self.wal_bytes = c(
            "crdt_wal_append_bytes_total", "WAL bytes appended", ("name",)
        )
        self.wal_seconds = h(
            "crdt_wal_append_seconds", "WAL append+commit wall time", ("name",)
        )
        self.wal_compactions = c(
            "crdt_wal_compactions_total", "WAL compaction checkpoints", ("name",)
        )
        self.wal_reclaimed = c(
            "crdt_wal_reclaimed_bytes_total", "WAL bytes reclaimed", ("name",)
        )
        self.wal_recover_records = c(
            "crdt_wal_recovered_records_total", "WAL records replayed", ("name",)
        )
        self.wal_recover_seconds = h(
            "crdt_wal_recover_seconds", "WAL recovery wall time", ("name",)
        )
        self.catchup_chunks = c(
            "crdt_catchup_chunks_total", "Log-shipping chunks",
            ("name", "role"),
        )
        self.catchup_bytes = c(
            "crdt_catchup_chunk_bytes_total", "Log-shipping chunk bytes",
            ("name", "role"),
        )
        self.catchup_entries = c(
            "crdt_catchup_chunk_entries_total", "Log-shipping chunk entries",
            ("name", "role"),
        )
        self.catchup_streams = c(
            "crdt_catchup_streams_total", "Completed catch-up streams", ("name",)
        )
        self.catchup_horizon = c(
            "crdt_catchup_horizon_fallbacks_total",
            "Catch-up streams clamped at a compaction horizon", ("name",),
        )
        self.catchup_seconds = h(
            "crdt_catchup_stream_seconds", "Catch-up stream wall time", ("name",)
        )
        self.fleet_dispatches = c(
            "crdt_fleet_dispatches_total", "Fleet batched dispatches", ("fleet",)
        )
        self.fleet_messages = c(
            "crdt_fleet_batched_messages_total",
            "Messages merged by fleet batched dispatches", ("fleet",),
        )
        self.fleet_seconds = h(
            "crdt_fleet_dispatch_seconds", "Fleet batched dispatch wall time",
            ("fleet",),
        )
        self.fleet_occupancy = h(
            "crdt_fleet_dispatch_replicas", "Replicas per fleet dispatch",
            ("fleet",), buckets=COUNT_BUCKETS,
        )
        self.fleet_rows = c(
            "crdt_fleet_rows_total", "Real rows in fleet dispatches", ("fleet",)
        )
        self.fleet_padded_rows = c(
            "crdt_fleet_padded_rows_total",
            "Padded rows launched by fleet dispatches", ("fleet",),
        )
        self.fleet_egress_ticks = c(
            "crdt_fleet_egress_ticks_total",
            "Batched fleet sync-tick egress passes", ("fleet",),
        )
        self.fleet_egress_dispatches = c(
            "crdt_fleet_egress_dispatches_total",
            "Vmapped egress extraction/tree dispatches", ("fleet",),
        )
        self.fleet_egress_members = h(
            "crdt_fleet_egress_members",
            "Members served per batched egress tick", ("fleet",),
            buckets=COUNT_BUCKETS,
        )
        self.fleet_egress_frames = c(
            "crdt_fleet_egress_frames_total",
            "FleetFrameMsg envelopes shipped", ("fleet",),
        )
        self.fleet_egress_frame_members = c(
            "crdt_fleet_egress_frame_members_total",
            "Member replicas carried by shipped FleetFrameMsg envelopes",
            ("fleet",),
        )
        self.fleet_egress_seconds = h(
            "crdt_fleet_egress_seconds",
            "Batched egress tick wall time", ("fleet",),
        )
        self.mesh_exchanges = c(
            "crdt_mesh_exchanges_total",
            "Intra-mesh ppermute exchange dispatches", ("fleet",),
        )
        self.mesh_intra_entries = c(
            "crdt_mesh_intra_entries_total",
            "Sync-tick entries delivered through the intra-mesh plane",
            ("fleet",),
        )
        self.mesh_fallback_entries = c(
            "crdt_mesh_fallback_entries_total",
            "Sync-tick entries that fell back to the host/TCP path",
            ("fleet",),
        )
        self.mesh_permuted_bytes = c(
            "crdt_mesh_permuted_bytes_total",
            "Bytes moved by intra-mesh ppermute rotations (padded buffers)",
            ("fleet",),
        )
        # serving plane: admission/shed/read accounting — the front
        # door's client-facing counterpart of the ingest
        # coalescing family (one SERVE_ADMIT per grouped commit, one
        # SERVE_SHED per rejected op, one SERVE_READ per snapshot read)
        self.serve_commits = c(
            "crdt_serve_commits_total", "Admission grouped commits", ("name",)
        )
        self.serve_admitted = c(
            "crdt_serve_admitted_ops_total",
            "Client write ops admitted and committed", ("name",),
        )
        self.serve_depth = h(
            "crdt_serve_coalesce_depth",
            "Client ops folded per admission commit", ("name",),
            buckets=COUNT_BUCKETS,
        )
        self.serve_commit_seconds = h(
            "crdt_serve_commit_seconds",
            "Admission group-commit wall time", ("name",),
        )
        self.serve_shed = c(
            "crdt_serve_shed_ops_total",
            "Client write ops shed by backpressure", ("name", "reason"),
        )
        self.serve_reads = c(
            "crdt_serve_reads_total", "Snapshot reads served", ("name", "mode")
        )
        self.serve_read_seconds = h(
            "crdt_serve_read_seconds", "Snapshot read wall time", ("name",)
        )
        self.serve_read_retries = c(
            "crdt_serve_read_retries_total",
            "Stale-snapshot read retries", ("name",),
        )
        # tree gossip: the crdt_tree_* family — relay coalescing
        # histograms (inbound frames folded into one re-emission, entries
        # per merged re-emission), per-tier tx/rx byte counters, and the
        # topology gauges TREE_TOPOLOGY keeps fresh (removed on
        # unregister_replica: a stopped replica must not scrape stale)
        self.tree_reemits = c(
            "crdt_tree_reemits_total",
            "Relay coalesced re-emissions shipped", ("name",),
        )
        self.tree_coalesce_depth = h(
            "crdt_tree_relay_coalesce_depth",
            "Inbound frames folded per relay re-emission", ("name",),
            buckets=COUNT_BUCKETS,
        )
        self.tree_entries_per_reemit = h(
            "crdt_tree_entries_per_reemit",
            "Entries carried per merged relay re-emission", ("name",),
            buckets=COUNT_BUCKETS,
        )
        self.tree_tx_bytes = c(
            "crdt_tree_tx_bytes_total",
            "Relay re-emission slice bytes shipped, by tree tier",
            ("name", "tier"),
        )
        self.tree_rx_bytes = c(
            "crdt_tree_rx_bytes_total",
            "Inbound slice bytes folded into relay re-emissions, by tree tier",
            ("name", "tier"),
        )
        self.tree_depth = g(
            "crdt_tree_depth", "Spanning-tree depth of the derived topology",
            ("name",),
        )
        self.tree_fanout = g(
            "crdt_tree_fanout", "Configured relay fanout", ("name",)
        )
        self.tree_role = g(
            "crdt_tree_role",
            "Tree role (0 leaf / 1 relay / 2 root; degraded reads 0)",
            ("name",),
        )
        self.tree_tier = g(
            "crdt_tree_tier", "This replica's tier (distance from root)",
            ("name",),
        )
        self.tree_members = g(
            "crdt_tree_members", "Members in the derived tree", ("name",)
        )
        self.tree_degraded = g(
            "crdt_tree_degraded",
            "1 while degraded to flat gossip (0 tree-routed)", ("name",),
        )
        self._on_tree_relay = _with_batch(
            self._on_tree_relay, self._on_tree_relay_batch
        )
        # monotone by construction, hence the _total names despite the
        # set-to-absolute gauge primitive: the transfer ledger's audit
        # reports absolute per-site crossing/byte totals
        self.transfers = g(
            "crdt_transfers_total",
            "Device-host crossings per audited transfer site",
            ("site",),
        )
        self.transfer_bytes = g(
            "crdt_transfer_bytes_total",
            "Bytes moved across the device-host boundary per audited site",
            ("site",),
        )
        # fault-injection trips: a real counter — the faults registry
        # emits one FAULT_TRIP per trip, not absolute totals, so chaos
        # runs attach mid-process and see only their own schedule's trips
        self.fault_trips = c(
            "crdt_fault_trips_total",
            "Injected-fault trips per labelled fault-point site",
            ("site",),
        )
        # batchable handlers for the two per-message hot families: the
        # grouped ingest path emits them via telemetry.execute_many, and
        # the batch form folds the whole group under ONE registry-lock
        # acquire and one label resolve — per-message handler dispatch
        # is the dominant enabled-telemetry cost at coalesce depth 16
        self._on_sync_done = _with_batch(
            self._on_sync_done, self._on_sync_done_batch
        )
        self._on_sync_round = _with_batch(
            self._on_sync_round, self._on_sync_round_batch
        )

    # -- subscription table ---------------------------------------------

    def _table(self) -> list:
        """Event tuple -> handler: one row for every event declared in
        ``runtime/telemetry.py`` (``tests/test_torch_metrics.py`` holds
        the two sets equal)."""
        return [
            (telemetry.SYNC_DONE, self._on_sync_done),
            (telemetry.CAPACITY_GROWN, self._on_capacity_grown),
            (telemetry.SYNC_ROUND, self._on_sync_round),
            (telemetry.INGEST_COALESCE, self._on_ingest_coalesce),
            (telemetry.WAL_APPEND, self._on_wal_append),
            (telemetry.WAL_COMPACT, self._on_wal_compact),
            (telemetry.WAL_RECOVER, self._on_wal_recover),
            (telemetry.CATCHUP_CHUNK, self._on_catchup_chunk),
            (telemetry.CATCHUP_DONE, self._on_catchup_done),
            (telemetry.FLEET_DISPATCH, self._on_fleet_dispatch),
            (telemetry.FLEET_EGRESS, self._on_fleet_egress),
            (telemetry.MESH_EXCHANGE, self._on_mesh_exchange),
            (telemetry.TRANSFER, self._on_transfer),
            (telemetry.FAULT_TRIP, self._on_fault_trip),
            (telemetry.SERVE_ADMIT, self._on_serve_admit),
            (telemetry.SERVE_SHED, self._on_serve_shed),
            (telemetry.SERVE_READ, self._on_serve_read),
            (telemetry.TREE_RELAY, self._on_tree_relay),
            (telemetry.TREE_TOPOLOGY, self._on_tree_topology),
        ]

    def attach(self) -> "MetricsBridge":
        if not self._attached:
            rows = self._table()
            # a declared event without a subscription row would
            # silently read zero forever
            missing = set(telemetry.declared_events()) - {ev for ev, _h in rows}
            if missing:
                logger.warning(
                    "metrics bridge table misses declared telemetry "
                    "event(s) %s — their metrics will read zero", missing,
                )
            for event, handler in rows:
                telemetry.attach(event, handler)
            self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            for event, handler in self._table():
                telemetry.detach(event, handler)
            self._attached = False

    # -- handlers --------------------------------------------------------

    # Handlers run on whatever thread emitted the event (replica loop,
    # fleet tick, TCP serve) — every update happens under the one
    # registry lock, folded per EVENT (one acquire, N ``*_held``
    # updates). Label tuples are built inline as canonical str tuples
    # (``str(meta[...])`` only when a caller passed a non-str).

    @staticmethod
    def _s(v) -> str:
        return v if type(v) is str else str(v)

    def _on_sync_done(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        with self._lock:
            self.sync_done._inc_held(lb)
            self.keys_updated._inc_held(lb, meas.get("keys_updated_count", 0))

    def _on_sync_done_batch(self, _event, meas_list, meta) -> None:
        lb = (self._s(meta.get("name")),)
        keys = 0
        for meas in meas_list:
            keys += meas.get("keys_updated_count", 0)
        with self._lock:
            self.sync_done._inc_held(lb, len(meas_list))
            self.keys_updated._inc_held(lb, keys)

    def _on_capacity_grown(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        with self._lock:
            self.capacity_grown._inc_held(lb)
            self.capacity._set_held(lb, meas.get("capacity", 0))

    def _on_sync_round(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")), self._s(meta.get("plane", "host")))
        g = meas.get
        with self._lock:
            self.sync_rounds._inc_held(lb)
            self.sync_seconds._observe_held(lb, g("duration_s", 0.0))
            self.sync_entries._inc_held(lb, g("entries", 0))
            self.sync_buckets._inc_held(lb, g("buckets", 0))

    def _on_sync_round_batch(self, _event, meas_list, meta) -> None:
        lb = (self._s(meta.get("name")), self._s(meta.get("plane", "host")))
        entries = buckets = 0
        with self._lock:
            observe = self.sync_seconds._observe_held
            for meas in meas_list:
                g = meas.get
                observe(lb, g("duration_s", 0.0))
                entries += g("entries", 0)
                buckets += g("buckets", 0)
            self.sync_rounds._inc_held(lb, len(meas_list))
            self.sync_entries._inc_held(lb, entries)
            self.sync_buckets._inc_held(lb, buckets)

    def _on_ingest_coalesce(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        g = meas.get
        with self._lock:
            self.ingest_dispatches._inc_held(lb)
            self.ingest_messages._inc_held(lb, g("depth", 0))
            self.ingest_depth._observe_held(lb, g("depth", 0))
            self.ingest_seconds._observe_held(lb, g("duration_s", 0.0))

    def _on_wal_append(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        g = meas.get
        with self._lock:
            self.wal_records._inc_held(lb, g("records", 1))
            self.wal_bytes._inc_held(lb, g("bytes", 0))
            self.wal_seconds._observe_held(lb, g("duration_s", 0.0))

    def _on_wal_compact(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        with self._lock:
            self.wal_compactions._inc_held(lb)
            self.wal_reclaimed._inc_held(lb, meas.get("bytes_reclaimed", 0))

    def _on_wal_recover(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        with self._lock:
            self.wal_recover_records._inc_held(lb, meas.get("records", 0))
            self.wal_recover_seconds._observe_held(
                lb, meas.get("duration_s", 0.0)
            )

    def _on_catchup_chunk(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")), self._s(meta.get("role", "")))
        g = meas.get
        with self._lock:
            self.catchup_chunks._inc_held(lb)
            self.catchup_bytes._inc_held(lb, g("bytes", 0))
            self.catchup_entries._inc_held(lb, g("entries", 0))

    def _on_catchup_done(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        g = meas.get
        with self._lock:
            self.catchup_streams._inc_held(lb)
            self.catchup_seconds._observe_held(lb, g("duration_s", 0.0))
            self.catchup_horizon._inc_held(lb, g("horizon_fallback", 0))

    def _on_fleet_dispatch(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("fleet")),)
        g = meas.get
        with self._lock:
            self.fleet_dispatches._inc_held(lb)
            self.fleet_messages._inc_held(lb, g("messages", 0))
            self.fleet_seconds._observe_held(lb, g("duration_s", 0.0))
            self.fleet_occupancy._observe_held(lb, g("replicas", 0))
            self.fleet_rows._inc_held(lb, g("rows", 0))
            self.fleet_padded_rows._inc_held(lb, g("padded_rows", 0))

    def _on_fleet_egress(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("fleet")),)
        g = meas.get
        with self._lock:
            self.fleet_egress_ticks._inc_held(lb)
            self.fleet_egress_dispatches._inc_held(lb, g("dispatches", 0))
            self.fleet_egress_members._observe_held(lb, g("members", 0))
            self.fleet_egress_frames._inc_held(lb, g("frames", 0))
            self.fleet_egress_frame_members._inc_held(lb, g("frame_members", 0))
            self.fleet_egress_seconds._observe_held(lb, g("duration_s", 0.0))

    def _on_mesh_exchange(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("fleet")),)
        g = meas.get
        with self._lock:
            self.mesh_exchanges._inc_held(lb, g("exchanges", 0))
            self.mesh_intra_entries._inc_held(lb, g("intra_entries", 0))
            self.mesh_fallback_entries._inc_held(lb, g("fallback_entries", 0))
            self.mesh_permuted_bytes._inc_held(lb, g("permuted_bytes", 0))

    def _on_transfer(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("site")),)
        with self._lock:
            self.transfers._set_held(lb, meas.get("crossings", 0))
            self.transfer_bytes._set_held(lb, meas.get("bytes", 0))

    def _on_fault_trip(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("site")),)
        with self._lock:
            self.fault_trips._inc_held(lb, meas.get("trips", 1))

    def _on_serve_admit(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        g = meas.get
        with self._lock:
            self.serve_commits._inc_held(lb)
            self.serve_admitted._inc_held(lb, g("ops", 0))
            self.serve_depth._observe_held(lb, g("ops", 0))
            self.serve_commit_seconds._observe_held(lb, g("duration_s", 0.0))

    def _on_serve_shed(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")), self._s(meta.get("reason", "")))
        with self._lock:
            self.serve_shed._inc_held(lb, meas.get("ops", 1))

    def _on_serve_read(self, _event, meas, meta) -> None:
        name = self._s(meta.get("name"))
        lb = (name, self._s(meta.get("mode", "keys")))
        g = meas.get
        with self._lock:
            self.serve_reads._inc_held(lb, g("reads", 1))
            self.serve_read_seconds._observe_held((name,), g("duration_s", 0.0))
            retries = g("retries", 0)
            if retries:
                self.serve_read_retries._inc_held((name,), retries)

    def _on_tree_relay(self, _event, meas, meta) -> None:
        name = self._s(meta.get("name"))
        lb = (name,)
        tier_lb = (name, self._s(meta.get("tier", "0")))
        g = meas.get
        with self._lock:
            self.tree_reemits._inc_held(lb)
            # continuation emissions of a truncated window carry no depth
            # sample: only completed windows shape the histogram
            depth = g("depth")
            if depth is not None:
                self.tree_coalesce_depth._observe_held(lb, depth)
            self.tree_entries_per_reemit._observe_held(lb, g("entries", 0))
            self.tree_tx_bytes._inc_held(tier_lb, g("tx_bytes", 0))
            rx = g("rx_bytes", 0)
            if rx:
                self.tree_rx_bytes._inc_held(tier_lb, rx)

    def _on_tree_relay_batch(self, _event, meas_list, meta) -> None:
        name = self._s(meta.get("name"))
        lb = (name,)
        tier_lb = (name, self._s(meta.get("tier", "0")))
        tx = rx = 0
        with self._lock:
            depth_obs = self.tree_coalesce_depth._observe_held
            entries_obs = self.tree_entries_per_reemit._observe_held
            for meas in meas_list:
                g = meas.get
                depth = g("depth")
                if depth is not None:
                    depth_obs(lb, depth)
                entries_obs(lb, g("entries", 0))
                tx += g("tx_bytes", 0)
                rx += g("rx_bytes", 0)
            self.tree_reemits._inc_held(lb, len(meas_list))
            self.tree_tx_bytes._inc_held(tier_lb, tx)
            if rx:
                self.tree_rx_bytes._inc_held(tier_lb, rx)

    def _on_tree_topology(self, _event, meas, meta) -> None:
        lb = (self._s(meta.get("name")),)
        g = meas.get
        with self._lock:
            self.tree_depth._set_held(lb, g("depth", 0))
            self.tree_fanout._set_held(lb, g("fanout", 0))
            self.tree_role._set_held(lb, g("role", 0))
            self.tree_tier._set_held(lb, g("tier", 0))
            self.tree_members._set_held(lb, g("members", 0))
            self.tree_degraded._set_held(lb, g("degraded", 0))


# ----------------------------------------------------------------------
# flight recorder

class FlightRecorder:
    """Bounded ring buffer of recent structured events — the per-replica
    black box. ``record`` is a lock + list append (µs-scale next to a
    merge dispatch); the ring drops the OLDEST event past ``capacity``
    and counts drops so a post-mortem knows how much history it holds.
    """

    def __init__(self, name: str, capacity: int = 256):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.name = name
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: list[tuple] = []
        self._next = 0  # monotone event id (== total events ever recorded)

    def record(self, kind: str, **fields) -> None:
        t = time.time()
        with self._lock:
            self._buf.append((t, self._next, kind, fields))
            self._next += 1
            if len(self._buf) > self.capacity:
                del self._buf[0 : len(self._buf) - self.capacity]

    def events(self, kind: str | None = None) -> list[dict]:
        """Snapshot, oldest first (queryable in tests and chaos runs)."""
        with self._lock:
            buf = list(self._buf)
        return [
            {"t": t, "id": i, "kind": k, **f}
            for t, i, k, f in buf
            if kind is None or k == kind
        ]

    def dropped(self) -> int:
        with self._lock:
            return self._next - len(self._buf)

    def events_recorded(self) -> int:
        """Total events ever recorded (monotone; the ring holds the
        newest ``capacity`` of them)."""
        with self._lock:
            return self._next

    def dump(self, log=None, path: str | None = None) -> int:
        """Write the ring through the logger (the crash black box);
        returns the number of events dumped.

        Exception-safe per event: a logging handler (or an unprintable
        field value) raising mid-dump must not lose the REMAINING ring
        events — the black box's whole value is the events nearest the
        crash, which are the last ones dumped. With ``path`` the ring
        is also appended to that file as JSON lines (best-effort,
        ``repr`` fallback for non-JSON fields), so chaos runs keep the
        black box after the process dies and the log stream with it."""
        log = log or logger
        events = self.events()
        try:
            log.error(
                "flight recorder %r: %d event(s), %d older dropped",
                self.name, len(events), self.dropped(),
            )
        except Exception:
            pass  # a dying log sink must not stop the event dump below
        for e in events:
            try:
                fields = {k: v for k, v in e.items() if k not in ("t", "id", "kind")}
                log.error("flight %r #%d %.6f %s %s", self.name, e["id"], e["t"], e["kind"], fields)
            except Exception:
                continue  # skip the poison event, keep the rest
        if path is not None:
            try:
                import json as _json

                with open(path, "a", encoding="utf-8") as f:
                    for e in events:
                        f.write(_json.dumps(
                            {"replica": self.name, **e}, default=repr,
                        ) + "\n")
            except OSError:
                logger.debug("flight dump to %r failed", path, exc_info=True)
        return len(events)


# ----------------------------------------------------------------------
# replication-lag tracing

class LagTracer:
    """Per-peer convergence lag from dots already on the wire.

    The origin samples local commits (every ``sample_every``-th seq) as
    ``(origin addr, seq) -> commit time``; a peer reports visibility the
    moment its applied watermark of that origin advances (walk-equality
    ack on a round opener, or an applied log-shipping chunk — both
    existing protocol events carrying the originator address and seq,
    so the trace needs ZERO wire changes). The lag histogram is labeled
    ``(origin, peer)``; a parallel histogram counts the origin's sync
    ROUNDS the sample waited through — the propagation-rounds
    measurement hierarchical anti-entropy topologies are judged by.

    Pending samples are bounded per origin (oldest evicted — a sample
    no peer ever covers must not leak), origins bounded LRU. A sample
    stays pending until evicted so EVERY peer's first coverage of it
    yields one observation; samples are kept as parallel
    ascending-seq lists, so each watermark advance bisects to its
    ``(origin, peer)`` covered floor and touches only the newly
    covered span — O(log pending + newly covered), never a rescan of
    the whole window. All state sits under one tracer lock; histogram
    updates happen after it is released (the registry lock never nests
    inside it).
    """

    MAX_PENDING = 512
    MAX_ORIGINS = 4096

    def __init__(self, registry: Registry, *, sample_every: int = 16):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.sample_every = int(sample_every)
        self._lock = threading.Lock()
        #: origin addr -> parallel ([seq...], [(t_commit, rounds)...])
        #: lists in ascending seq order (commits are monotone per
        #: origin; a backward seq means the origin restarted and the
        #: old incarnation's samples/floors are dropped)
        self._pending: dict[Any, tuple[list, list]] = {}
        #: (origin, peer) -> highest seq this peer already covered; the
        #: skip floor that makes repeat watermark advances cheap (LRU
        #: bounded — an evicted floor can at worst double-count still-
        #: pending old samples for that one pair)
        self._floor: dict[tuple, int] = {}
        #: origin addr -> sync rounds opened by that origin
        self._rounds: dict[Any, int] = {}
        self.lag = registry.histogram(
            "crdt_replication_lag_seconds",
            "Local-commit to remote-visibility lag per (origin, peer)",
            ("origin", "peer"),
        )
        self.rounds = registry.histogram(
            "crdt_propagation_rounds",
            "Origin sync rounds between commit and remote visibility",
            ("origin", "peer"), buckets=COUNT_BUCKETS,
        )

    def note_commit(self, origin, seq: int, now: float | None = None) -> None:
        """Called by the origin after a seq advance (sampled here, so
        the hot path pays one modulo when no sample is due)."""
        if seq % self.sample_every:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            pend = self._pending.get(origin)
            if pend is None:
                if len(self._pending) >= self.MAX_ORIGINS:
                    self._pending.pop(next(iter(self._pending)))
                pend = self._pending[origin] = ([], [])
            seqs, samples = pend
            s = int(seq)
            if seqs and s <= seqs[-1]:
                # backward seq: the origin restarted (recovery resumes
                # from a snapshot) — the old incarnation's samples and
                # floors describe commits that no longer exist
                seqs.clear()
                samples.clear()
                for k in [k for k in self._floor if k[0] == origin]:
                    del self._floor[k]
            # the sample stays pending until evicted by the bound, so
            # EVERY peer's first coverage of it yields one observation
            # (popping on first match would hand all the lag evidence
            # to whichever peer converges first)
            seqs.append(s)
            samples.append((now, self._rounds.get(origin, 0)))
            if len(seqs) > self.MAX_PENDING:
                excess = len(seqs) - self.MAX_PENDING
                del seqs[:excess]
                del samples[:excess]

    def note_round(self, origin) -> None:
        """Called by the origin when it opens a sync round (the
        propagation-round clock)."""
        with self._lock:
            self._rounds[origin] = self._rounds.get(origin, 0) + 1
            while len(self._rounds) > self.MAX_ORIGINS:
                self._rounds.pop(next(iter(self._rounds)))

    def note_visible(self, peer, origin, seq: int, now: float | None = None) -> None:
        """Called by ``peer`` when its applied watermark of ``origin``
        advances to ``seq``: every pending sample in ``(floor, seq]`` —
        the span this peer has not yet covered — is now remotely
        visible there (the samples stay pending for the OTHER peers;
        each peer's first coverage counts exactly once, and bisecting
        the ascending seq list to the floor makes the usual
        nothing-new advance O(log pending))."""
        if peer == origin:
            return  # self-visibility is not replication lag
        now = time.monotonic() if now is None else now
        with self._lock:
            pend = self._pending.get(origin)
            if pend is None or not pend[0]:
                return
            key = (origin, peer)
            floor = self._floor.get(key, 0)
            if seq <= floor:
                return  # already covered through here
            rounds_now = self._rounds.get(origin, 0)
            seqs, samples = pend
            lo = bisect.bisect_right(seqs, floor)
            hi = bisect.bisect_right(seqs, int(seq))
            matched = samples[lo:hi]
            self._floor.pop(key, None)  # pop+reinsert: LRU recency
            self._floor[key] = seq
            while len(self._floor) > self.MAX_ORIGINS:
                self._floor.pop(next(iter(self._floor)))
        labels = (str(origin), str(peer))
        for t_commit, rounds_at in matched:
            self.lag.observe(max(0.0, now - t_commit), labels)
            self.rounds.observe(rounds_now - rounds_at, labels)

    def peers_seen(self) -> set:
        """Peer label values with at least one lag sample (bench gate:
        the per-peer histogram must be populated for every peer)."""
        return {lb[1] for lb in self.lag.label_sets()}


# ----------------------------------------------------------------------
# the facade behind the ``obs=`` knob

class Observability:
    """One observability plane: registry + always-attached bridge + lag
    tracer + flight-recorder factory + the varz / health source tables
    the HTTP endpoint (``obs_server.ObsServer``) serves. Pass an
    instance (or ``True`` for the process-wide default) as ``obs=`` to
    ``start_link`` / ``start_fleet``.

    ONE plane per process is the expected shape (``obs=True``): the
    telemetry handler table is process-global, so a second plane's
    bridge folds EVERY replica's events — including replicas started
    with ``obs=None``, whose hot paths then also pay enabled-telemetry
    costs while any plane exists in the process. Use distinct planes
    only for isolated registries in tests, and ``close()`` them."""

    def __init__(
        self,
        *,
        registry: Registry | None = None,
        lag_sample_every: int = 16,
        flight_capacity: int = 256,
    ):
        self.registry = registry or Registry()
        self.bridge = MetricsBridge(self.registry).attach()
        self.lag = LagTracer(self.registry, sample_every=lag_sample_every)
        self.flight_capacity = int(flight_capacity)
        self._lock = threading.Lock()
        self._varz_sources: dict[str, Callable[[], dict]] = {}
        self._health_checks: dict[str, Callable[[], dict]] = {}
        self._server = None
        # replica/fleet-polled gauges (collector-fed: scrape-time cost)
        g = self.registry.gauge
        self._g_mailbox = g(
            "crdt_mailbox_depth", "Queued messages in the replica mailbox",
            ("name",),
        )
        self._g_seq = g(
            "crdt_sequence_number", "Replica applied-batch sequence number",
            ("name",),
        )
        self._g_payloads = g(
            "crdt_payloads", "Host payload dict size", ("name",)
        )
        self._g_outstanding = g(
            "crdt_outstanding_syncs", "In-flight sync rounds", ("name",)
        )
        self._g_wal_segments = g(
            "crdt_wal_segments", "WAL segment files on disk", ("name",)
        )
        self._g_wal_bytes = g(
            "crdt_wal_bytes", "WAL bytes on disk", ("name",)
        )
        self._g_wal_horizon = g(
            "crdt_wal_horizon", "WAL log-shipping horizon seq", ("name",)
        )
        self._g_fleet_occupancy = g(
            "crdt_fleet_avg_occupancy", "Mean replicas per fleet dispatch",
            ("fleet",),
        )
        self._g_fleet_fill = g(
            "crdt_fleet_ragged_fill_ratio",
            "Real/padded row ratio of fleet dispatches", ("fleet",),
        )
        self._g_fleet_ticks = g(
            "crdt_fleet_ticks", "Fleet scheduler ticks (polled)", ("fleet",)
        )
        self._g_fleet_egress_mpf = g(
            "crdt_fleet_egress_members_per_frame",
            "Mean member replicas per shipped FleetFrameMsg", ("fleet",),
        )
        self._g_fleet_egress_fpt = g(
            "crdt_fleet_egress_frames_per_tick",
            "Mean FleetFrameMsg envelopes per egress tick", ("fleet",),
        )
        self._g_fleet_egress_occ = g(
            "crdt_fleet_egress_bucket_occupancy",
            "Mean members per batched egress extraction bucket", ("fleet",),
        )
        self._g_serve_pending = g(
            "crdt_serve_pending_ops",
            "Write ops queued or in flight in the serving front door",
            ("name",),
        )
        self._g_serve_overloaded = g(
            "crdt_serve_overloaded",
            "1 while the serving front door is shedding (0 healthy)",
            ("name",),
        )
        self._g_mesh_shards = g(
            "crdt_mesh_shards",
            "Mesh shard count of a mesh-mode fleet (0 = vmap mode)",
            ("fleet",),
        )
        self._g_mesh_mps = g(
            "crdt_mesh_members_per_shard",
            "Mean fleet members per mesh shard", ("fleet",),
        )
        # transfer-ledger audit, collector-fed (an idle process pays
        # nothing between scrapes): each scrape re-publishes every
        # audited site's absolute crossing/byte totals through TRANSFER
        # telemetry; the bridge folds them into
        # crdt_transfers_total{site=...} / crdt_transfer_bytes_total
        from delta_crdt_ex_tpu_torch.utils import transfers as _transfers

        def _collect_transfers() -> None:
            _transfers.audit()

        self._transfer_collector = _collect_transfers
        self.registry.register_collector(_collect_transfers)
        self.add_varz_source("transfers", _transfers.varz)
        self._c_drained = self.registry.counter(
            "crdt_drained_messages_total",
            "Messages drained by the replica event loop", ("name",),
        )
        self._h_drain = self.registry.histogram(
            "crdt_drain_seconds", "Wall time of one mailbox drain pass",
            ("name",),
        )
        self._g_tx_bytes = g(
            "crdt_transport_tx_bytes", "Transport bytes sent", ("transport",)
        )
        self._g_rx_bytes = g(
            "crdt_transport_rx_bytes", "Transport bytes received", ("transport",)
        )
        self._g_txq_bytes = g(
            "crdt_transport_queue_bytes", "Bytes queued on sender connections",
            ("transport",),
        )

    # -- factory hooks ---------------------------------------------------

    def recorder(self, name: str) -> FlightRecorder:
        return FlightRecorder(name, capacity=self.flight_capacity)

    def record_drain(self, name: str, messages: int, duration_s: float) -> None:
        """Mailbox drain accounting (one call per ``process_pending``
        batch — never per message; both updates under one registry
        lock acquire)."""
        lb = (name if type(name) is str else str(name),)
        with self.registry._lock:
            self._c_drained._inc_held(lb, messages)
            self._h_drain._observe_held(lb, duration_s)

    # -- source registration ---------------------------------------------

    def add_varz_source(self, key: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._varz_sources[key] = fn

    def add_health_check(self, key: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._health_checks[key] = fn

    def remove_source(self, key: str) -> None:
        with self._lock:
            self._varz_sources.pop(key, None)
            self._health_checks.pop(key, None)

    def register_replica(self, rep) -> None:
        """Wire one replica into the plane: varz + health sources plus a
        scrape-time collector polling its stats/mailbox/WAL gauges."""
        key = f"replica:{rep.name}"
        self.add_varz_source(key, rep.obs_varz)
        self.add_health_check(key, rep.health)
        name_lb = (rep.name,)

        def collect() -> None:
            st = rep.stats()
            self._g_seq.set(st["sequence_number"], name_lb)
            self._g_payloads.set(st["payloads"], name_lb)
            self._g_outstanding.set(st["outstanding_syncs"], name_lb)
            depth_fn = getattr(rep.transport, "queue_depth", None)
            if depth_fn is not None:
                self._g_mailbox.set(depth_fn(rep.addr), name_lb)
            wal = st.get("wal")
            if wal is not None:
                self._g_wal_segments.set(wal["segments"], name_lb)
                self._g_wal_horizon.set(wal["horizon"], name_lb)
                self._g_wal_bytes.set(rep.wal_size_bytes(), name_lb)
            tstats_fn = getattr(rep.transport, "transport_stats", None)
            if tstats_fn is not None:
                ts = tstats_fn()
                tl = (ts["endpoint"],)
                self._g_tx_bytes.set(ts["tx_bytes"], tl)
                self._g_rx_bytes.set(ts["rx_bytes"], tl)
                self._g_txq_bytes.set(ts["queue_bytes"], tl)

        rep._obs_collector = collect
        self.registry.register_collector(collect)

    def unregister_replica(self, rep) -> None:
        self.remove_source(f"replica:{rep.name}")
        collect = getattr(rep, "_obs_collector", None)
        if collect is not None:
            self.registry.unregister_collector(collect)
            rep._obs_collector = None
        # a still-attached front door unwires with its replica: its
        # collector would otherwise keep re-setting the serve gauges
        # removed below (the crdt_serve_* cleanup contract)
        fd = getattr(rep, "_frontdoor", None)
        if fd is not None:
            self.unregister_serve(fd)
        for gauge in (
            self._g_mailbox, self._g_seq, self._g_payloads,
            self._g_outstanding, self._g_wal_segments, self._g_wal_bytes,
            self._g_wal_horizon,
            # the tree-topology gauges are event-fed by the bridge but
            # owned here: a stopped tree-mode replica must not scrape its
            # last role and depth for ever
            self.bridge.tree_depth, self.bridge.tree_fanout,
            self.bridge.tree_role, self.bridge.tree_tier,
            self.bridge.tree_members, self.bridge.tree_degraded,
        ):
            # serve gauges are NOT in this loop: unregister_serve (the
            # register_serve pair, invoked above and by Frontdoor.close)
            # owns their cleanup unambiguously
            gauge.remove((rep.name,))

    # -- serving plane ----------------------------------------------------

    def register_serve(self, fd) -> None:
        """Wire one serving front door into the plane: ``serve:{name}``
        varz + health sources (the health check is what flips
        ``/healthz`` to 503 while the plane sheds) plus a scrape-time
        collector polling the pending/overloaded gauges."""
        key = f"serve:{fd.name}"
        self.add_varz_source(key, fd.obs_varz)
        self.add_health_check(key, fd.health)
        name_lb = (fd.name if type(fd.name) is str else str(fd.name),)

        def collect() -> None:
            st = fd.stats()
            self._g_serve_pending.set(st["pending_ops"], name_lb)
            self._g_serve_overloaded.set(
                1.0 if st["overloaded"] else 0.0, name_lb
            )

        fd._obs_collector = collect
        self.registry.register_collector(collect)

    def unregister_serve(self, fd) -> None:
        """Unwire a front door (close / replica teardown): sources,
        collector and gauges all go — a closed plane must not scrape
        as a stale last value (the unregister-cleanup contract)."""
        self.remove_source(f"serve:{fd.name}")
        collect = getattr(fd, "_obs_collector", None)
        if collect is not None:
            self.registry.unregister_collector(collect)
            fd._obs_collector = None
        name_lb = (fd.name if type(fd.name) is str else str(fd.name),)
        self._g_serve_pending.remove(name_lb)
        self._g_serve_overloaded.remove(name_lb)

    def register_fleet(self, fleet) -> None:
        key = f"fleet:{id(fleet):x}"
        self.add_varz_source(key, fleet.obs_varz)
        self.add_health_check(key, fleet.health)
        fleet_lb = (str(id(fleet)),)

        def collect() -> None:
            st = fleet.stats()
            self._g_fleet_occupancy.set(st["avg_occupancy"], fleet_lb)
            self._g_fleet_fill.set(st["ragged_fill_ratio"], fleet_lb)
            self._g_fleet_ticks.set(st["ticks"], fleet_lb)
            eg = st["egress"]
            self._g_fleet_egress_mpf.set(eg["members_per_frame"], fleet_lb)
            self._g_fleet_egress_fpt.set(eg["frames_per_tick"], fleet_lb)
            self._g_fleet_egress_occ.set(eg["avg_bucket_occupancy"], fleet_lb)
            mesh = st["mesh"]
            self._g_mesh_shards.set(mesh["shards"], fleet_lb)
            self._g_mesh_mps.set(mesh["members_per_shard"], fleet_lb)

        fleet._obs_collector = collect
        self.registry.register_collector(collect)

    def unregister_fleet(self, fleet) -> None:
        self.remove_source(f"fleet:{id(fleet):x}")
        collect = getattr(fleet, "_obs_collector", None)
        if collect is not None:
            self.registry.unregister_collector(collect)
            fleet._obs_collector = None
        # fleet front door: per-member serve gauges unwire with the
        # fleet (each member Frontdoor registered under its own name)
        fd = getattr(fleet, "_frontdoor", None)
        if fd is not None:
            for member_fd in fd.members:
                self.unregister_serve(member_fd)
        for gauge in (
            self._g_fleet_occupancy, self._g_fleet_fill, self._g_fleet_ticks,
            self._g_fleet_egress_mpf, self._g_fleet_egress_fpt,
            self._g_fleet_egress_occ, self._g_mesh_shards, self._g_mesh_mps,
        ):
            # same contract as unregister_replica: a stopped fleet must
            # not scrape as a stale last value forever
            gauge.remove((str(id(fleet)),))

    # -- snapshots the HTTP endpoint serves -------------------------------

    def varz(self) -> dict:
        """The unified JSON snapshot: every registered source's stats
        under one schema (``Replica.stats()`` / ``Fleet.stats()`` / WAL
        stats are UNCHANGED — this surface is additive)."""
        with self._lock:
            sources = dict(self._varz_sources)
        out: dict = {"sources": {}}
        for key, fn in sources.items():
            try:
                out["sources"][key] = fn()
            except Exception as e:  # a dying source must not 500 the page
                out["sources"][key] = {"error": repr(e)}
        return out

    def health(self) -> tuple[bool, dict]:
        """Aggregate health: ``(all_ok, {source: check})``."""
        with self._lock:
            checks = dict(self._health_checks)
        detail: dict = {}
        ok = True
        for key, fn in checks.items():
            try:
                res = fn()
            except Exception as e:
                res = {"ok": False, "error": repr(e)}
            detail[key] = res
            ok = ok and bool(res.get("ok"))
        return ok, detail

    # -- HTTP export -------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Start (idempotently) the per-process HTTP endpoint serving
        ``/metrics`` + ``/healthz`` + ``/varz`` for this plane; returns
        the :class:`~delta_crdt_ex_tpu_torch.runtime.obs_server.ObsServer`."""
        from delta_crdt_ex_tpu_torch.runtime.obs_server import ObsServer

        with self._lock:
            if self._server is None:
                self._server = ObsServer(self, host=host, port=port).start()
            return self._server

    def close(self) -> None:
        """Detach the bridge and stop the HTTP endpoint (tests; the
        telemetry handler table is process-global, so a discarded plane
        must not keep consuming events)."""
        self.bridge.detach()
        # same contract as unregister_replica/_fleet: a closed plane
        # must not keep running the transfer audit at scrape time
        self.registry.unregister_collector(self._transfer_collector)
        self.remove_source("transfers")
        with self._lock:
            server, self._server = self._server, None
        if server is not None:
            server.stop()


_default_obs: Observability | None = None
_default_lock = threading.Lock()


def default_observability() -> Observability:
    """The process-wide plane ``obs=True`` resolves to."""
    global _default_obs
    with _default_lock:
        if _default_obs is None:
            _default_obs = Observability()
        return _default_obs


def resolve_obs(obs) -> Observability | None:
    """``obs=`` knob semantics: ``None``/``False`` disabled, ``True``
    the process default, an :class:`Observability` used as-is."""
    if obs is None or obs is False:
        return None
    if obs is True:
        return default_observability()
    if isinstance(obs, Observability):
        return obs
    raise TypeError(
        f"obs= expects True/False/None or an Observability, got {obs!r}"
    )


__all__ = [
    "COUNT_BUCKETS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "LagTracer",
    "MetricsBridge",
    "Observability",
    "Registry",
    "default_observability",
    "resolve_obs",
]
