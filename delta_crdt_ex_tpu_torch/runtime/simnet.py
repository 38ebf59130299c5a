"""Deterministic simulated network — the race-detector of this framework.

The PyTorch port's own copy of ``delta_crdt_ex_tpu/runtime/simnet.py``
over the port's :class:`~delta_crdt_ex_tpu_torch.runtime.transport.
LocalTransport`: one seed gives the same delivery schedule in both
packages.

The reference has no sanitizer; its safety argument is the actor model
plus property tests (SURVEY §5.2). This runtime's equivalent is this
seeded, deterministic scheduler: it intercepts every protocol message and
delivers them in adversarial orders — permuted, delayed, duplicated, or
dropped — while the convergence property suite asserts that replicas
still converge (sync is idempotent and commutative, so any delivery
schedule must reach the same fixed point; reference behaviour under
``send/2``'s only guarantee, per-pair FIFO, is a special case).

Duplication exercises idempotence; dropping exercises retry-via-next-tick
(the reference's "syncing is idempotent" rescue, ``causal_crdt.ex:
269-282``); permutation exercises commutativity of merges.
"""

from __future__ import annotations

import random
from typing import Hashable

from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport


class SimNetwork(LocalTransport):
    """LocalTransport with a seeded adversarial delivery schedule.

    Messages are buffered in a pending pool; :meth:`step` delivers a
    random subset in random order, optionally duplicating or dropping.
    Fully deterministic given the seed.
    """

    def __init__(
        self,
        seed: int = 0,
        drop_rate: float = 0.0,
        dup_rate: float = 0.0,
        reorder: bool = True,
    ):
        super().__init__()
        self.rng = random.Random(seed)
        self.drop_rate = drop_rate
        self.dup_rate = dup_rate
        self.reorder = reorder
        self._pool: list[tuple[Hashable, object]] = []

    def send(self, addr: Hashable, msg) -> bool:
        with self._lock:
            known = addr in self._owners
        if not known:
            return False
        self._pool.append((addr, msg))
        return True

    def step(self, max_deliveries: int | None = None) -> int:
        """Deliver (a prefix of) the pending pool adversarially."""
        pool, self._pool = self._pool, []
        if self.reorder:
            self.rng.shuffle(pool)
        if max_deliveries is not None:
            pool, rest = pool[:max_deliveries], pool[max_deliveries:]
            self._pool.extend(rest)
        delivered = 0
        for addr, msg in pool:
            r = self.rng.random()
            if r < self.drop_rate:
                continue
            if r < self.drop_rate + self.dup_rate:
                self._deliver(addr, msg)
                delivered += 1
            self._deliver(addr, msg)
            delivered += 1
        return delivered

    def _deliver(self, addr, msg) -> None:
        with self._lock:
            owner = self._owners.get(addr)
        if owner is not None:
            owner.handle(msg)

    def run(self, replicas, rounds: int = 50) -> None:
        """Alternate sync ticks and adversarial delivery steps."""
        for _ in range(rounds):
            for rep in replicas:
                rep.sync_to_all()
            self.step()

    @property
    def pending(self) -> int:
        return len(self._pool)
