"""Public API facade of the PyTorch port — parity with ``DeltaCrdt``
(``lib/delta_crdt.ex``) and with ``delta_crdt_ex_tpu/api.py``:
``start_link``, ``start_fleet``, ``child_spec``, ``set_neighbours``,
``mutate``, ``mutate_async``, ``mutate_batch``, ``read``, ``read_keys``,
``frontdoor``.

Example (the reference doctest flow, ``delta_crdt.ex:17-28``)::

    crdt1 = start_link(AWLWWMap, sync_interval=0.003)
    crdt2 = start_link(AWLWWMap, sync_interval=0.003)
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

from delta_crdt_ex_tpu_torch.models.binned_map import AWSet, BinnedAWLWWMap
from delta_crdt_ex_tpu_torch.models.hash_store import HashAWLWWMap, HashAWSet
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet, start_fleet as start_fleet_over
from delta_crdt_ex_tpu_torch.runtime.metrics import resolve_obs
from delta_crdt_ex_tpu_torch.runtime.replica import Replica

DEFAULT_SYNC_INTERVAL = 0.2  # seconds (reference: 200 ms, delta_crdt.ex:31)
DEFAULT_MAX_SYNC_SIZE = 200  # items (reference: delta_crdt.ex:32)
#: default call timeout (see ``delta_crdt_ex_tpu/api.py``)
DEFAULT_TIMEOUT = 30.0

DeltaCrdt = Replica  # the handle type users hold

#: the AWLWWMap model — the bucket-binned store, as in the JAX package
AWLWWMap = BinnedAWLWWMap

#: (store, model) → the same model on the other backend
_STORE_COUNTERPARTS = {
    ("hash", BinnedAWLWWMap): HashAWLWWMap,
    ("hash", AWSet): HashAWSet,
    ("binned", HashAWLWWMap): BinnedAWLWWMap,
    ("binned", HashAWSet): AWSet,
}


def _resolve_store(crdt_module, store: "str | None"):
    """Map a model class onto the requested dot-store backend
    (``delta_crdt_ex_tpu/api.py:44``): ``store="hash"`` selects the
    open-addressing hash-table store, ``store="binned"`` the
    bucket-binned rows; ``None`` keeps the model's own backend."""
    if store is None:
        return crdt_module
    if store not in ("hash", "binned"):
        raise ValueError(f"unknown store backend {store!r}; use 'hash' or 'binned'")
    if getattr(crdt_module, "backend", None) == store:
        return crdt_module
    try:
        return _STORE_COUNTERPARTS[(store, crdt_module)]
    except KeyError:
        raise ValueError(
            f"{crdt_module!r} has no {store!r}-store counterpart; pass a "
            "model class whose backend matches, or omit store="
        ) from None


def start_link(
    crdt_module=AWLWWMap,
    *,
    threaded: bool = True,
    store: "str | None" = None,
    **opts,
) -> Replica:
    """Start a replica (reference ``DeltaCrdt.start_link/2``).
    ``store`` selects the dot-store backend (``"binned"``, the default
    model's, or ``"hash"``). ``threaded=False`` leaves driving to the
    caller (``sync_to_all()`` + ``transport.pump()``, or
    ``process_pending()`` for coalesced ingress). ``device`` defaults
    to ``"cuda"``. ``transport`` defaults to the process's
    ``LocalTransport``; pass a
    :class:`~delta_crdt_ex_tpu_torch.runtime.tcp_transport.TcpTransport`
    for a cluster across processes or hosts, where neighbours are
    ``(name, (host, port))`` addresses and JAX-package replicas may
    join. With a ``wal_dir``, a lagging peer catches up by log shipping
    (``log_shipping=True``, ``catchup_chunk_rows=1024``,
    ``catchup_suffix_ratio=4.0``: the JAX package's defaults).
    ``obs=True`` joins the process-wide observability plane (metrics,
    the flight recorder, the lag tracer, ``/metrics`` ``/healthz``
    ``/varz`` through ``obs.serve()``); pass an
    :class:`~delta_crdt_ex_tpu_torch.runtime.metrics.Observability` for
    a plane of your own, and ``flight_dump_path`` to keep the flight
    ring as JSON lines when the replica crashes.

    Tree gossip (off by default, as in the JAX package):
    ``tree_gossip=True`` replaces flat all-neighbour sync with a
    spanning tree every replica derives alike from the sorted member
    set and ``tree_seed``
    (:mod:`delta_crdt_ex_tpu_torch.runtime.treesync`; no coordinator).
    Leaves sync only their parent, and relays coalesce their inbound
    merged rows into ONE re-emission per link per epoch: O(fanout) links
    a member instead of O(neighbours), and a write cascades through the
    relays within its round. Members of one fleet or one TCP endpoint
    form a bottom-tier subtree whose captain alone gossips outward. A
    relay's ``Down`` re-parents on every observer; past
    ``tree_degrade_ratio`` locally down members the replica gossips flat
    until membership settles. Knobs: ``tree_gossip``, ``tree_fanout``
    (default 8, at least 2), ``tree_seed``, ``tree_degrade_ratio``
    (default 0.25), ``tree_group`` (an explicit tier-0 cluster key); the
    tree shows in ``Replica.stats()["tree"]`` and the ``crdt_tree_*``
    metric family. Give every member the FULL membership as neighbours."""
    opts.setdefault("sync_interval", DEFAULT_SYNC_INTERVAL)
    opts.setdefault("max_sync_size", DEFAULT_MAX_SYNC_SIZE)
    replica = Replica(_resolve_store(crdt_module, store), **opts)
    if threaded:
        replica.start()
    return replica


def start_fleet(
    n: int,
    crdt_module=AWLWWMap,
    *,
    threaded: bool = True,
    names: "list | None" = None,
    min_batch: int = 2,
    store: "str | None" = None,
    mesh=None,
    mesh_narrow: bool = True,
    **opts,
) -> Fleet:
    """Start ``n`` replicas served by ONE batched event loop
    (``delta_crdt_ex_tpu/api.py:195``): the fleet drains all ``n``
    mailboxes a tick and joins compatible sync slices across replicas
    with one batched merge over a leading replica axis, and batches the
    sync ticks' extractions and tree builds the same way. What each
    member observes is what a solo replica would.

    ``opts`` are per-replica ``start_link`` options shared by every
    member (``names`` gives each its name); ``device`` defaults to
    ``"cuda"`` and raises without CUDA. Returns the
    :class:`~delta_crdt_ex_tpu_torch.runtime.fleet.Fleet`, whose
    ``.replicas`` are ordinary replica handles. ``threaded=False``
    leaves driving to the caller (``fleet.tick()`` / ``fleet.drain()``
    and ``fleet.sync_tick()`` or ``fleet.run_duties()``). ``obs=``
    registers the fleet and every member on the plane.

    ``mesh=`` (default off) runs the fleet's batched dispatches over a
    1-D replica mesh: pass a
    :class:`~delta_crdt_ex_tpu_torch.utils.devices.Mesh` (``fleet_mesh``
    builds one; a device may be listed several times), an int shard
    count, or ``True`` for the detected devices' default. Each shard
    then runs its lane block of every batched call on its own device,
    resident stacked states stay block-split between ticks, and
    sync-tick messages between co-mesh members deliver as device-side
    rotations (only off-mesh destinations take the transport).
    ``mesh_narrow=False`` keeps the padded exchange, whose buffers cross
    to the host and back. Semantics are the vmap fleet's, bit for bit.

    ``tree_gossip=True`` members are stamped with ONE shared tier-0
    cluster key, so the whole fleet forms a single bottom-tier subtree of
    the gossip spanning tree: hops inside the fleet are local mailbox
    deliveries and only the captain gossips outward; relay re-emissions
    ride the tick's frame collector like every other sync send."""
    if names is not None and len(names) != n:
        raise ValueError(f"{len(names)} names for {n} replicas")
    # one plane for every member and the fleet (resolved once)
    obs = resolve_obs(opts.pop("obs", None))
    opts.setdefault("sync_interval", DEFAULT_SYNC_INTERVAL)
    opts.setdefault("max_sync_size", DEFAULT_MAX_SYNC_SIZE)
    crdt_module = _resolve_store(crdt_module, store)
    replicas = []
    for i in range(n):
        member = dict(opts)
        if names is not None:
            member["name"] = names[i]
        replicas.append(Replica(crdt_module, obs=obs, **member))
    return start_fleet_over(
        replicas, threaded=threaded, min_batch=min_batch, obs=obs, mesh=mesh, mesh_narrow=mesh_narrow
    )


def child_spec(opts: dict | None = None) -> dict:
    """Supervision metadata (reference ``child_spec/1``, ``delta_crdt.ex:68-82``)."""
    opts = dict(opts or {})
    crdt = opts.pop("crdt", None)
    if crdt is None:
        raise ValueError(f"must specify 'crdt' in options, got: {opts!r}")
    name = opts.get("name", "DeltaCrdt")
    shutdown = opts.pop("shutdown", 5.0)
    return {
        "id": name,
        "start": (start_link, (crdt,), opts),
        "shutdown": shutdown,
    }


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


def frontdoor(crdt, **opts):
    """The serving front door of a replica or a fleet
    (``delta_crdt_ex_tpu/api.py:341``), created on first use and cached
    on the target:

    - lock-free snapshot reads: ``fd.read_keys(keys)`` / ``fd.read()`` /
      ``fd.scan(prefix)`` run off a published store generation without
      taking the replica lock (on the hash store ``read_keys`` launches
      the probe-window kernel); ``Replica.read(timeout)`` stays the
      strong flush-then-read mode;
    - coalesced write admission: ``fd.mutate(f, args)`` /
      ``fd.mutate_async(f, args)`` fold concurrent clients' ops into one
      grouped commit per admission window through ``Replica.apply_ops``,
      the entrance ``mutate_batch`` uses;
    - backpressure: past the admission-queue, mailbox, TCP
      ``queue_bytes`` or WAL-backlog limits an op is shed with
      :class:`~delta_crdt_ex_tpu_torch.runtime.serve.Overloaded`, and
      the plane's ``/healthz`` check reads 503 until it drains.

    ``crdt`` may be a :class:`Replica` (a
    :class:`~delta_crdt_ex_tpu_torch.runtime.serve.Frontdoor`) or a
    :class:`Fleet` (one front door per member with key-hash routing).
    Options (``max_commit_ops``, ``max_pending_ops``,
    ``max_mailbox_depth``, ``max_queue_bytes``, ``max_wal_backlog``,
    ``shed_health_hold``, ``read_retries``, ``journal``) are fixed at
    first creation."""
    return crdt.frontdoor(**opts)
