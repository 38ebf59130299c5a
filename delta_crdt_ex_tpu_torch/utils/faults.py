"""Deterministic fault-point injection.

The PyTorch port's own copy of ``delta_crdt_ex_tpu/utils/faults.py``
(the port imports nothing of the JAX package): the same 12 site labels,
plans, actions and trip ledger, so one seeded schedule trips the same
program points in both packages.

The anti-entropy algorithm is only correct if replicas survive
crash-recovery, message loss, and mid-commit failure without tearing
the seq/WAL/state/ack invariants — and "survives" is only evidence
when the failure can be *reproduced*. Every interesting failure
boundary in the runtime (commit tails, WAL append/fsync/roll,
transport send/recv, thread-loop tops) is a **labelled fault point** —
a :func:`faultpoint` call whose label comes from the closed
:data:`SITES` vocabulary — and a seeded :class:`FaultPlan`
deterministically trips raise / delay / partial-write / crash-before /
crash-after at the Nth hit of a labelled site.

Zero overhead when disarmed: :func:`faultpoint` is one module-global
load and an ``is None`` compare — no lock, no dict lookup, no
allocation.

Trips are counted per site and exported two ways: :func:`trips` for
chaos harnesses diffing schedules, and ``FAULT_TRIP`` telemetry (emitted
per trip, only when a handler is attached).
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager

#: the closed fault-point vocabulary. One label == one call site, so a
#: chaos schedule naming a site pins exactly one program point. The
#: port wires the ``fleet.*``, ``replica.*`` (but ``replica.relay.flush``,
#: which comes with tree gossip) and ``wal.*`` points; ``transport.*``
#: come with the TCP transport.
SITES = (
    "fleet.loop",
    "replica.commit.batch",
    "replica.commit.entries",
    "replica.durable",
    "replica.loop",
    "replica.relay.flush",
    "transport.recv",
    "transport.send",
    "wal.append",
    "wal.fsync",
    "wal.rotate",
    "wal.write",
)

#: actions a :class:`FaultRule` may take at its Nth hit
ACTIONS = ("raise", "delay", "crash_before", "crash_after", "partial_write")


class FaultError(Exception):
    """Common base of injected failures (so harnesses can catch both)."""


class FaultInjected(FaultError):
    """A transient injected failure: the component is expected to
    surface it to its caller and stay recoverable in-process."""


class CrashInjected(FaultError):
    """A process-death injection: the chaos harness catches this and
    kills the replica (``Replica.crash()``) — nothing in the runtime
    may swallow it."""


class FaultRule:
    """Trip ``action`` at the ``nth`` hit of ``site`` (1-based)."""

    __slots__ = ("site", "nth", "action", "arg", "fired")

    def __init__(self, site: str, nth: int, action: str, arg=None):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; pick one of {SITES}")
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; pick one of {ACTIONS}")
        if nth < 1:
            raise ValueError(f"nth must be >= 1, got {nth}")
        self.site = site
        self.nth = int(nth)
        self.action = action
        self.arg = arg
        self.fired = False

    def __repr__(self) -> str:
        return f"FaultRule({self.site!r}, nth={self.nth}, action={self.action!r})"


class FaultPlan:
    """A deterministic fault schedule: an ordered rule list plus the
    per-site hit counters it consumes. Each rule fires at most once —
    re-arming the same plan object resets its counters, so a seed
    replays the identical schedule."""

    def __init__(self, rules, seed: int = 0):
        self.seed = int(seed)
        self.rules = [
            r if isinstance(r, FaultRule) else FaultRule(*r) for r in rules
        ]
        self.hits: dict[str, int] = {}
        #: site label that armed a pending crash-after (the NEXT hit of
        #: ANY site raises — the points sit at every boundary, so "next
        #: hit" is "immediately after the guarded operation")
        self.pending_crash: str | None = None

    @classmethod
    def seeded(
        cls,
        seed: int,
        sites=None,
        n_rules: int = 3,
        window: tuple = (1, 24),
        actions=("raise", "crash_before", "crash_after", "delay"),
    ) -> "FaultPlan":
        """Mint a deterministic plan from a seed: ``n_rules`` rules over
        ``sites``, each at a hit count drawn from ``window``. The same
        seed always yields the same schedule."""
        rng = random.Random(seed)
        sites = list(sites if sites is not None else SITES)
        rules = []
        for _ in range(n_rules):
            site = rng.choice(sites)
            action = rng.choice(tuple(actions))
            rules.append(FaultRule(site, rng.randint(*window), action))
        return cls(rules, seed=seed)

    def reset(self) -> None:
        self.hits.clear()
        self.pending_crash = None
        for r in self.rules:
            r.fired = False

    def exhausted(self) -> bool:
        """True when every rule has fired (a chaos leg may pump until
        the whole schedule has been delivered)."""
        return self.pending_crash is None and all(r.fired for r in self.rules)


_lock = threading.Lock()
#: the armed plan. ``faultpoint`` reads this WITHOUT the lock — a plain
#: global load — so the disarmed hot path pays one compare; arming /
#: disarming happens on the chaos harness's thread and publication of
#: the object is an atomic reference store.
_plan: "FaultPlan | None" = None
#: per-site trip totals (monotone across plans — the telemetry export)
_trips: dict[str, int] = {}


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` (resetting its counters) and return it."""
    global _plan
    with _lock:
        plan.reset()
        _plan = plan
    return plan


def disarm() -> None:
    global _plan
    with _lock:
        _plan = None


@contextmanager
def armed(plan: FaultPlan):
    """``with faults.armed(plan):`` — scoped arming for tests/benches."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


@contextmanager
def suspended():
    """Temporarily disarm WITHOUT resetting counters — chaos harnesses
    wrap crash-recovery in this so replaying the WAL (which walks the
    same commit/append code paths) does not consume schedule hits, and
    the plan resumes exactly where it left off."""
    global _plan
    with _lock:
        plan, _plan = _plan, None
    try:
        yield plan
    finally:
        with _lock:
            _plan = plan


def active() -> "FaultPlan | None":
    return _plan


def trips() -> dict:
    """``{site: trip_count}`` across every plan ever armed, sorted —
    the ledger image chaos harnesses diff and ``varz`` surfaces."""
    with _lock:
        return dict(sorted(_trips.items()))


def _record_trip(site: str) -> None:
    with _lock:
        _trips[site] = _trips.get(site, 0) + 1
    # deferred import: utils sits below the runtime layer (runtime
    # modules call faultpoint at import-adjacent paths), so a top-level
    # runtime import would cycle through runtime/__init__
    from delta_crdt_ex_tpu_torch.runtime import telemetry

    if telemetry.has_handlers(telemetry.FAULT_TRIP):
        telemetry.execute(
            telemetry.FAULT_TRIP, {"trips": 1}, {"site": site}
        )


def faultpoint(label: str):
    """One labelled fault point. Disarmed: a global load + compare.
    Armed: count the hit and trip any rule scheduled for it.

    Returns ``None`` normally. A ``partial_write`` trip returns the
    rule's fraction (0 < f < 1) instead of raising — the WAL's write
    path is the cooperating consumer: it writes that fraction of its
    staged bytes and raises :class:`CrashInjected` itself, minting a
    deterministic torn tail for the recovery legs."""
    # lock-free by design: a stale None read
    # only delays arming by one call — the disarmed fast path must stay
    # a single global load so production pays nothing for fault hooks
    plan = _plan
    if plan is None:
        return None
    return _trip(plan, label)


def _trip(plan: FaultPlan, label: str):
    crashed_site = None
    with _lock:
        if plan.pending_crash is not None:
            crashed_site = plan.pending_crash
            plan.pending_crash = None
    if crashed_site is not None:
        _record_trip(crashed_site)
        raise CrashInjected(
            f"crash_after armed at {crashed_site!r}, tripped at {label!r}"
        )
    with _lock:
        n = plan.hits.get(label, 0) + 1
        plan.hits[label] = n
        rule = None
        for r in plan.rules:
            if not r.fired and r.site == label and r.nth == n:
                rule = r
                r.fired = True
                break
    if rule is None:
        return None
    if rule.action == "crash_after":
        # arm only — the trip is recorded when the pending crash fires
        with _lock:
            plan.pending_crash = label
        return None
    _record_trip(label)
    if rule.action == "raise":
        raise FaultInjected(f"injected failure at {label!r} (hit {rule.nth})")
    if rule.action == "crash_before":
        raise CrashInjected(f"injected crash before {label!r} (hit {rule.nth})")
    if rule.action == "delay":
        time.sleep(float(rule.arg) if rule.arg is not None else 0.002)
        return None
    # partial_write: hand the fraction to the cooperating caller
    frac = float(rule.arg) if rule.arg is not None else 0.5
    return min(max(frac, 0.01), 0.99)


def varz() -> dict:
    """``/varz`` source: the fault-injection trip ledger."""
    return {"kind": "faults", "armed": _plan is not None, "trips": trips()}
