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
merges and sync-tick extractions, on both stores. See ``ROADMAP.md``
for what comes next.
"""

from delta_crdt_ex_tpu_torch.api import (
    AWLWWMap,
    DeltaCrdt,
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
from delta_crdt_ex_tpu_torch.runtime.replica import Replica

__version__ = "0.1.0"

__all__ = [
    "AWLWWMap",
    "AWSet",
    "BinnedAWLWWMap",
    "DeltaCrdt",
    "Fleet",
    "HashAWLWWMap",
    "HashAWSet",
    "Replica",
    "mutate",
    "mutate_async",
    "mutate_batch",
    "read",
    "read_keys",
    "set_neighbours",
    "start_fleet",
    "start_link",
]
