"""Device↔host transfer ledger — the PyTorch port's minimal copy of
``delta_crdt_ex_tpu/utils/transfers.py``.

Every crossing on the replica paths goes through an audited site
(:func:`register` returns a :class:`TransferSite` whose :meth:`get`
copies a tree of tensors to host numpy), and the ledger counts
crossings and bytes per site label, so the port's crossings stay
counted exactly where the JAX package counts them. :func:`audit`
exports the absolute per-site totals as ``TRANSFER`` telemetry at
scrape time (the metrics plane runs it as a collector), and
:func:`varz` is the ledger's ``/varz`` envelope.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.utils.devices import ReplicaSharding, Sharded, tree_map

_lock = threading.Lock()
#: site label -> TransferSite (insertion = module import order)
_sites: dict[str, "TransferSite"] = {}


#: the array leaves of a transferred tree
_LEAVES = (torch.Tensor, np.ndarray, Sharded)


def _map(fn, value):
    """Apply ``fn`` to every array leaf (a tensor, a numpy array, a
    mesh-sharded value) of a tree of tuples, lists, dicts and store
    dataclasses (NamedTuples and stores keep their type); other leaves
    pass through."""
    return tree_map(fn, value, _LEAVES)


def gathered(value):
    """``value`` with every mesh-sharded leaf concatenated on the host in
    shard order (one read of every block)."""
    return _map(lambda v: v.gather("cpu") if isinstance(v, Sharded) else v, value)


def device_layout(a: np.ndarray) -> torch.Tensor:
    """A host column as a tensor of the port's device layout: uint64 as
    its int64 bits, uint32 widened to int64, everything else as it is
    (a column already in that layout passes unchanged)."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = np.ascontiguousarray(a).view(np.int64)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True))


def _tensors(value) -> list:
    found: list = []
    _map(lambda t: found.append(t) if isinstance(t, torch.Tensor) else None, value)
    return found


class TransferSite:
    """One audited crossing site: a label, the registering call site,
    and the running (crossings, bytes) tally."""

    __slots__ = ("label", "origin", "count", "bytes")

    def __init__(self, label: str, origin: tuple) -> None:
        self.label = label
        self.origin = origin
        self.count = 0
        self.bytes = 0

    def note(self, n_bytes: int, crossings: int = 1) -> None:
        with _lock:
            self.count += crossings
            self.bytes += int(n_bytes)

    def get(self, value):
        """Audited device→host copy: one counted crossing for the whole
        tree; every tensor leaf becomes a numpy array of its own dtype.
        Host leaves pass through, and a tree of host leaves only (a
        slice the fleet already fetched) crosses nothing and counts
        nothing."""
        value = gathered(value)
        tensors = _tensors(value)
        if tensors:
            self.note(sum(t.numel() * t.element_size() for t in tensors))
        return _map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, value)

    def put(self, value, device):
        """Audited host→device (or device→device) placement: one counted
        crossing for the whole tree, as the JAX ``put`` counts it, bytes
        of every array leaf. Numpy leaves become tensors of the device
        layout (:func:`device_layout`); ``device`` is a torch device or
        a :class:`~delta_crdt_ex_tpu_torch.utils.devices.ReplicaSharding`
        (the tree is then block-split over its mesh)."""
        n_bytes = 0

        def leaf(v):
            nonlocal n_bytes
            if isinstance(v, np.ndarray):
                n_bytes += v.nbytes
                return device_layout(v)
            n_bytes += v.numel() * v.element_size()
            return v

        value = _map(leaf, value)
        self.note(n_bytes)
        if isinstance(device, ReplicaSharding):
            return device.put(value)
        return _map(lambda t: t.to(device, non_blocking=True), value)


def register(label: str) -> TransferSite:
    """Register ``label`` and return its :class:`TransferSite` handle.
    The same label from the same file:line returns the existing handle
    (module reload); from a different call site it raises."""
    if not isinstance(label, str) or not label:
        raise ValueError(f"transfer site label must be a non-empty str, got {label!r}")
    frame = sys._getframe(1)
    origin = (frame.f_code.co_filename, frame.f_lineno)
    with _lock:
        prior = _sites.get(label)
        if prior is not None:
            if prior.origin != origin:
                raise ValueError(
                    f"transfers: site label {label!r} already registered at "
                    f"{prior.origin[0]}:{prior.origin[1]}"
                )
            return prior
        site = _sites[label] = TransferSite(label, origin)
        return site


def snapshot() -> dict:
    """``{label: {"count": crossings, "bytes": bytes_moved}}`` for every
    registered site, in sorted label order."""
    with _lock:
        return {
            label: {"count": s.count, "bytes": s.bytes}
            for label, s in sorted(_sites.items())
        }


def audit() -> dict:
    """Read every site's tally and emit ``TRANSFER`` telemetry carrying
    the ABSOLUTE per-site totals (the metrics bridge sets its
    ``crdt_transfers_total{site=...}`` and ``crdt_transfer_bytes_total``
    gauges from them, so a plane attaching mid-process still exports
    true totals). With no handler attached it is a snapshot read and
    nothing more. Returns the snapshot."""
    # deferred: runtime modules register their sites at import time, so
    # a top-level runtime import here would cycle
    from delta_crdt_ex_tpu_torch.runtime import telemetry

    snap = snapshot()
    if not telemetry.has_handlers(telemetry.TRANSFER):
        return snap
    for label, tally in snap.items():
        telemetry.execute(
            telemetry.TRANSFER,
            {"crossings": tally["count"], "bytes": tally["bytes"]},
            {"site": label},
        )
    return snap


def varz() -> dict:
    """``/varz`` source: the ledger's snapshot under its envelope."""
    return {"kind": "transfers", "stats": snapshot()}


def as_u64(a: np.ndarray) -> np.ndarray:
    """Host view of an int64 bit-pattern column as the uint64 it holds."""
    return np.asarray(a).view(np.uint64)


def as_u32(a: np.ndarray) -> np.ndarray:
    """Host copy of an int64 column holding uint32 values."""
    return np.asarray(a).astype(np.uint32)
