"""Two suspects from the port's chip runs, held against the JAX package
on the CPU under ``LogicalClock``:

1. The first single-op propagation after a bulk load is slow on the
   card. Hypothesis: a payload ``gc()`` (a full-state scan) falls due
   during it. :func:`first_propagation` loads ``n_keys`` into replica 1
   in 1024-op batches, converges replica 2, then counts each replica's
   ``gc()`` calls and the sync rounds of the first single-op
   propagation, and of a second one for contrast.
2. A stopped ``Fleet`` or ``Replica`` may leave reference cycles the
   collector frees later (a pause in whatever runs next).
   :func:`cycles_after_stop` drives a fleet (or a replica pair), stops
   it, drops every reference and returns what ``gc.collect()`` finds.

Run as a script for the numbers ``ROADMAP.md`` §3 quotes (the first
leg at 65536 keys and 4096 buckets, the count of buckets on the card)::

    JAX_PLATFORMS=cpu python -m tests.test_torch_gc_suspects

The tests hold the port to the JAX package's counts at a smaller size.
"""

from __future__ import annotations

import collections
import gc
import json

import pytest

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.fleet import Fleet as JFleet
from delta_crdt_ex_tpu.runtime.replica import Replica as JReplica
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet
from delta_crdt_ex_tpu_torch.runtime.replica import Replica
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport


def _pkg(pkg):
    if pkg == "jax":
        return jdc, JTransport, JClock, JFleet, JReplica, {"log_shipping": False}
    return t_api, TTransport, TClock, Fleet, Replica, {"device": "cpu", "log_shipping": False}


def first_propagation(pkg: str, n_keys: int = 16384, tree_depth: int = 8) -> dict:
    """``gc()`` calls per replica during the bulk load, the convergence,
    and the first and second single-op propagations, with the sync
    rounds each propagation took."""
    dc, T, C, _F, R, extra = _pkg(pkg)
    t, clock = T(), C()
    calls: dict = {}
    real_gc = R.gc

    def counting_gc(self):
        calls[self.name] = calls.get(self.name, 0) + 1
        return real_gc(self)

    mk = lambda name: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=clock, capacity=n_keys, tree_depth=tree_depth,
        name=name, max_sync_size=500, sync_timeout=1e9, **extra,
    )
    R.gc = counting_gc
    r1, r2 = mk("r1"), mk("r2")
    try:
        r1.set_neighbours([r2])
        r2.set_neighbours([r1])

        def round_():
            r1.sync_to_all()
            r2.sync_to_all()
            t.pump()

        out = {}
        for s in range(0, n_keys, 1024):
            r1.mutate_batch("add", [[f"k{i}", i] for i in range(s, min(s + 1024, n_keys))])
        out["load"] = dict(calls)
        calls.clear()
        rounds = 0
        while len(r2.read()) < n_keys:
            round_()
            rounds += 1
        out["converge"] = {**calls, "rounds": rounds}
        for leg in ("first", "second"):
            calls.clear()
            r1.mutate("add", [f"k{leg}", leg])
            rounds = 0
            while r2.read_keys([f"k{leg}"]) != {f"k{leg}": leg}:
                round_()
                rounds += 1
            out[leg] = {**calls, "rounds": rounds}
        return out
    finally:
        R.gc = real_gc
        r1.crash()
        r2.crash()


#: runtime classes whose instances a stopped fleet's cycle may hold
_RUNTIME_CLASSES = ("Fleet", "Replica", "BinnedStore", "_StackedLevels", "_LaneLevels", "LocalTransport")


def cycles_after_stop(pkg: str, kind: str) -> tuple[int, dict]:
    """What ``gc.collect()`` frees right after a stopped fleet (or a
    replica pair) and every reference to it are dropped: the object
    count, and the runtime-class instances among them."""
    gc.collect()
    # no automatic collection may free part of the cycle before the
    # count below
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        return _drive_stop_and_collect(pkg, kind)
    finally:
        if was_enabled:
            gc.enable()


def _drive_stop_and_collect(pkg: str, kind: str) -> tuple[int, dict]:
    dc, T, C, F, _R, extra = _pkg(pkg)
    t, clock = T(), C()
    mk = lambda name: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=clock, capacity=256, tree_depth=6, name=name,
        sync_timeout=1e9, **extra,
    )
    senders = [mk(f"s{i}") for i in range(4)]
    if kind == "fleet":
        owner = F([mk(f"f{i}") for i in range(4)])
        receivers = list(owner.replicas)
    else:
        receivers = [mk(f"f{i}") for i in range(4)]
        owner = None
    for s, r in zip(senders, receivers):
        s.set_neighbours([r])
        r.set_neighbours([s])
        s.mutate_batch("add", [[f"{s.name}{k}", k] for k in range(20)])
    for _ in range(3):
        for s in senders:
            s.sync_to_all()
        if owner is not None:
            owner.drain()
            owner.sync_tick()
        else:
            for r in receivers:
                r.process_pending()
                r.sync_to_all()
        t.pump()
    if owner is not None:
        owner.stop()
    else:
        for r in receivers:
            r.stop()
    for s in senders:
        s.stop()
    del senders, receivers, owner, s, r, t, mk
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        n = gc.collect()
        kinds = collections.Counter(type(o).__name__ for o in gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    return n, {c: kinds[c] for c in _RUNTIME_CLASSES if kinds[c]}


def test_first_propagation_gc_calls_match_jax():
    j = first_propagation("jax", 4096, 6)
    t = first_propagation("torch", 4096, 6)
    assert t == j
    assert t["first"]["rounds"] >= 1


@pytest.mark.parametrize("kind", ["fleet", "replicas"])
def test_stopped_cycles_hold_what_the_jax_ones_hold(kind):
    """Stopped replicas leave no cycle in either package; a stopped
    fleet leaves one in both (members hold the fleet's bound notify),
    over the same runtime objects."""
    (nj, j), (nt, t) = cycles_after_stop("jax", kind), cycles_after_stop("torch", kind)
    assert t == j
    if kind == "replicas":
        assert nt == nj == 0
    else:
        assert nt > 0 and nj > 0 and t["Fleet"] == 1 and t["Replica"] == 4


if __name__ == "__main__":
    for pkg in ("jax", "torch"):
        print(json.dumps({"pkg": pkg, "first_propagation": first_propagation(pkg, 65536, 12)}))
        for kind in ("fleet", "replicas"):
            n, held = cycles_after_stop(pkg, kind)
            print(json.dumps({"pkg": pkg, "kind": kind, "gc_collect_after_stop": n, "runtime_objects": held}))
