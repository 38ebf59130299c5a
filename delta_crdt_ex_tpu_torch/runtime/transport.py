"""In-process transport + failure detection.

The reference's transport is raw BEAM message passing — location-
transparent ``send/2`` to pid / name / ``{name, node}`` with
``Process.monitor`` for neighbour liveness (``causal_crdt.ex:270,291-314``).
The TPU-native control plane mirrors that contract behind a small
interface so the same replica/protocol code runs over:

- :class:`LocalTransport` — same-process registry + mailboxes (covers the
  reference's single-VM test topology, SURVEY §4, and the batched
  many-replicas-per-chip bench path);
- :class:`delta_crdt_ex_tpu_torch.runtime.tcp_transport.TcpTransport`
  — a socket transport for cross-host control, on the JAX package's
  wire.

This module is the PyTorch port's own copy of
``delta_crdt_ex_tpu/runtime/transport.py`` (the port imports nothing of
the JAX package), the fleet-envelope relay policy included.

Send to a dead address returns ``False`` (the reference rescues
``ArgumentError`` and moves on — sync is idempotent, ``causal_crdt.ex:
269-282``); monitors deliver a :class:`Down` message on unregister, the
``:DOWN`` analog.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Hashable


@dataclasses.dataclass
class Down:
    """Neighbour-death notification (reference ``:DOWN``, ``causal_crdt.ex:127``)."""

    addr: Hashable


class LocalTransport:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._mailboxes: dict[Hashable, queue.Queue] = {}
        self._owners: dict[Hashable, Any] = {}
        # target addr -> set of watcher addrs
        self._monitors: dict[Hashable, set[Hashable]] = {}

    def register(self, addr: Hashable, owner: Any) -> None:
        with self._lock:
            if addr in self._owners:
                raise ValueError(f"address already registered: {addr!r}")
            self._mailboxes[addr] = queue.Queue()
            self._owners[addr] = owner

    def canonical_addr(self, name: Hashable) -> Hashable:
        """The address peers should use to reach ``name`` (in-process:
        the name itself; TCP: ``(name, endpoint)``)."""
        return name

    def unregister(self, addr: Hashable) -> None:
        with self._lock:
            self._mailboxes.pop(addr, None)
            self._owners.pop(addr, None)
            watchers = self._monitors.pop(addr, set())
        for w in watchers:
            self.send(w, Down(addr))

    def alive(self, addr: Hashable) -> bool:
        with self._lock:
            return addr in self._owners

    def device_of(self, addr: Hashable):
        """The device the replica behind ``addr`` is PINNED to (None when
        unpinned or unknown). Senders place sync slices straight on a
        pinned receiver's device — the device data plane; in-process
        messages pass by reference, so a tensor body never takes a host
        round trip."""
        with self._lock:
            return getattr(self._owners.get(addr), "pinned_device", None)

    def send(self, addr: Hashable, msg: Any) -> bool:
        with self._lock:
            mb = self._mailboxes.get(addr)
            owner = self._owners.get(addr)
        if mb is None:
            return False
        mb.put(msg)
        notify = getattr(owner, "notify", None)
        if notify is not None:
            notify()  # wake a threaded replica's event loop
        return True

    def monitor(self, watcher: Hashable, target: Hashable) -> bool:
        """Watch ``target``; ``False`` if it is already dead (the reference
        rescues monitoring a dead process, ``causal_crdt.ex:295-308``)."""
        with self._lock:
            if target not in self._owners:
                return False
            self._monitors.setdefault(target, set()).add(watcher)
            return True

    def demonitor(self, watcher: Hashable, target: Hashable) -> None:
        with self._lock:
            self._monitors.get(target, set()).discard(watcher)

    def queue_depth(self, addr: Hashable) -> int:
        """Queued messages in one mailbox — a gauge (``qsize`` is
        approximate under concurrency)."""
        with self._lock:
            mb = self._mailboxes.get(addr)
        return mb.qsize() if mb is not None else 0

    # -- driving (deterministic mode) ------------------------------------

    def drain_nowait(self, addr: Hashable, max_n: int | None = None) -> list:
        """Pop up to ``max_n`` queued messages for one address (all of
        them when ``None``), never blocking. Arrival (FIFO) order is
        preserved across message types — a ``Down`` is never reordered
        past entries queued before it from the same peer, which is what
        lets the replica's ingress coalescing batch-receive without
        changing protocol semantics, and likewise keeps log-shipping
        catch-up frames (``GetLogMsg``/``LogChunkMsg``) ordered against
        the walk and entries traffic they interleave with (a chunk
        never passes the ``Down`` of the server that sent it)."""
        with self._lock:
            mb = self._mailboxes.get(addr)
        out: list = []
        if mb is None:
            return out
        while max_n is None or len(out) < max_n:
            try:
                out.append(mb.get_nowait())
            except queue.Empty:
                break
        return out

    def drain(self, addr: Hashable) -> list:
        """Pop all queued messages for one address."""
        return self.drain_nowait(addr, None)

    def pump(self, max_rounds: int = 10_000) -> int:
        """Deterministically deliver messages until quiescent.

        The reference's tests await convergence with ``Process.sleep``
        (flaky-prone, SURVEY §4); this is the deterministic "deliver
        everything now" alternative. Returns messages delivered.
        """
        delivered = 0
        for _ in range(max_rounds):
            progressed = False
            with self._lock:
                addrs = list(self._owners)
            for addr in addrs:
                with self._lock:
                    owner = self._owners.get(addr)
                if owner is None:
                    continue
                for msg in self.drain(addr):
                    owner.handle(msg)
                    delivered += 1
                    progressed = True
            if not progressed:
                return delivered
        raise RuntimeError("transport did not quiesce")


def forward_fleet_entries(transport, entries, local=None) -> None:
    """THE fleet-envelope relay policy, shared by the TCP receive path
    and the replica's whole-envelope fallback so the two cannot drift:
    entries ``local`` claims (returns True) are done; the rest regroup
    per next-hop endpoint (``transport.fleet_sink``) and re-emit as ONE
    rewritten frame each — per-destination order preserved, inner
    messages untouched — with per-member ``transport.send`` for
    sink-less destinations and the renegotiated-down unbundle inside
    ``send_fleet_frame`` itself."""
    sink_of = getattr(transport, "fleet_sink", None)
    forwards: dict = {}
    for to, m in entries:
        if local is not None and local(to, m):
            continue
        sink = sink_of(to) if sink_of is not None else None
        if sink is None:
            transport.send(to, m)
        else:
            forwards.setdefault(sink, []).append((to, m))
    for endpoint, group in forwards.items():
        transport.send_fleet_frame(endpoint, group)


_default: LocalTransport | None = None
_default_lock = threading.Lock()


def default_transport() -> LocalTransport:
    global _default
    with _default_lock:
        if _default is None:
            _default = LocalTransport()
        return _default
