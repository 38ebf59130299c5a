"""delta_crdt_ex_tpu_torch — the PyTorch/CUDA port of ``delta_crdt_ex_tpu``.

A second package beside the JAX one, which stays the reference it is
held against bit for bit. It imports ``torch`` and nothing of JAX or of
the JAX package (it keeps its own copies of the host-only modules it
needs), mirrors the JAX package's module layout and names, and runs on
the GPU unless the caller passes ``device="cpu"``.

Ported so far: the replica path on both dot stores —
``start_link(AWLWWMap)`` (the bucket-binned store, ingress coalescing
on) or ``store="hash"`` → ``mutate``/``mutate_batch`` → anti-entropy
between neighbours → ``read``/``read_keys``, for ``AWLWWMap``,
``AWSet`` and ``HashAWSet`` — with the probe-window LWW lookup as a
hand-written CUDA kernel for Hopper (``csrc/probe.cu``); and the
binned-store fan-in with the digest-tree roots fold as the second
(``csrc/roots.cu``); and batched replica fleets —
``start_fleet(n)``, one device call a wave for many replicas' ingress
merges and sync-tick extractions, on both stores; and durability and
adversarial delivery — snapshot storage (``MemoryStorage``,
``FileStorage``), the write-ahead delta log (``wal_dir=``, ``WalLog``),
crash recovery with the node id and counters kept, fault points on
every commit boundary, and the seeded ``SimNetwork``; and the cross-host
``TcpTransport`` on the JAX package's wire, log-shipping catch-up
(``GetLogMsg``/``LogChunkMsg``, on by default) and fleet frames, so a
JAX replica and a torch replica run in one cluster; and the serving
front door (``frontdoor(crdt)``: lock-free snapshot reads that launch
the probe kernel on the hash store, coalesced write admission with
shedding) and the observability plane (``obs=``: metrics, the flight
recorder, the lag tracer, ``/metrics`` ``/healthz`` ``/varz``, profiler
spans); and tree gossip; and the packed entry layout on the fan-in
(``parallel.pack_states`` → ``fanout_merge_into``, ``ops/packed.py``) and
the native batch hasher (``native/``). See ``ROADMAP.md`` for what
comes next.
"""

from delta_crdt_ex_tpu_torch.api import (
    AWLWWMap,
    DeltaCrdt,
    child_spec,
    frontdoor,
    mutate,
    mutate_async,
    mutate_batch,
    read,
    read_keys,
    set_neighbours,
    start_fleet,
    start_link,
)
from delta_crdt_ex_tpu_torch.models.binned_map import AWSet, BinnedAWLWWMap
from delta_crdt_ex_tpu_torch.models.hash_store import HashAWLWWMap, HashAWSet
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet
from delta_crdt_ex_tpu_torch.runtime.metrics import Observability
from delta_crdt_ex_tpu_torch.runtime.obs_server import ObsServer
from delta_crdt_ex_tpu_torch.runtime.replica import Replica
from delta_crdt_ex_tpu_torch.runtime.serve import FleetFrontdoor, Frontdoor, Overloaded
from delta_crdt_ex_tpu_torch.runtime.simnet import SimNetwork
from delta_crdt_ex_tpu_torch.runtime.storage import FileStorage, MemoryStorage, Storage
from delta_crdt_ex_tpu_torch.runtime.tcp_transport import TcpTransport
from delta_crdt_ex_tpu_torch.runtime.wal import WalLog

__version__ = "0.1.0"

__all__ = [
    "AWLWWMap",
    "AWSet",
    "BinnedAWLWWMap",
    "DeltaCrdt",
    "FileStorage",
    "Fleet",
    "FleetFrontdoor",
    "Frontdoor",
    "HashAWLWWMap",
    "HashAWSet",
    "MemoryStorage",
    "Observability",
    "ObsServer",
    "Overloaded",
    "Replica",
    "SimNetwork",
    "Storage",
    "TcpTransport",
    "WalLog",
    "child_spec",
    "frontdoor",
    "mutate",
    "mutate_async",
    "mutate_batch",
    "read",
    "read_keys",
    "set_neighbours",
    "start_fleet",
    "start_link",
]
