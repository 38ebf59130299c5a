"""Convergence of port replicas and fleets under adversarial delivery
(``delta_crdt_ex_tpu_torch/runtime/simnet.py``), on both dot stores.

- The schedules of ``tests/test_simnet.py`` (reordered and duplicated
  delivery; drops healed by periodic re-sync) and of
  ``tests/test_runtime_property.py`` (fully synced scripts against a
  dict oracle), on torch replicas.
- A fleet in the same adversarial network: batched sync ticks out,
  mailbox delivery in a seeded order, batched drains.
- One seed, one result: under one seed and ``LogicalClock``, a torch
  cluster in the port's ``SimNetwork`` ends bit-equal to a JAX cluster
  in the JAX ``SimNetwork`` — same canonical bytes, reads and delivery
  counts step by step.
"""

from __future__ import annotations

import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.simnet import SimNetwork as JSimNetwork
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.simnet import SimNetwork
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

STORES = ["binned", "hash"]


def build(n_replicas, seed, drop, dup, store, pkg="torch"):
    jax_side = pkg == "jax"
    net = (JSimNetwork if jax_side else SimNetwork)(seed=seed, drop_rate=drop, dup_rate=dup)
    clock = JClock() if jax_side else LogicalClock()
    extra = {"log_shipping": False} if jax_side else {"device": "cpu", "log_shipping": False}
    dc = jdc if jax_side else tdc
    reps = [
        dc.start_link(
            dc.AWLWWMap, store=store, threaded=False, transport=net, clock=clock, capacity=128,
            tree_depth=5, max_sync_size=6, name=f"sim{i}", node_id=(0xF0 << 56) + 11 + i,
            sync_timeout=0.0,  # lossy schedule: re-arm in-flight slots every tick
            **extra,
        )
        for i in range(n_replicas)
    ]
    for r in reps:
        r.set_neighbours(reps)
    net.step()
    return net, reps


def stop_all(reps):
    for r in reps:
        r.crash()


SCRIPTS = st.lists(
    st.tuples(
        st.integers(min_value=0, max_value=2),  # writer
        st.sampled_from(["add", "add", "remove", "clear"]),
        st.integers(min_value=1, max_value=6),  # key
        st.integers(min_value=0, max_value=50),  # value
    ),
    max_size=25,
)


@pytest.mark.parametrize("store", STORES)
@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000), script=SCRIPTS)
def test_convergence_under_reordered_and_duplicated_delivery(store, seed, script):
    """All replicas converge to one map, and every surviving value is
    one actually written to its key (with partial sync interleaved, a
    sequential dict is not the oracle: a remove kills observed dots
    only)."""
    net, reps = build(3, seed, 0.0, 0.3, store)
    try:
        writes: dict = {}
        for who, op, key, val in script:
            if op == "add":
                reps[who].mutate("add", [key, val])
                writes.setdefault(key, set()).add(val)
            elif op == "remove":
                reps[who].mutate("remove", [key])
            else:
                reps[who].mutate("clear", [])
            if net.rng.random() < 0.5:
                net.run(reps, rounds=1)
        net.run(reps, rounds=50)
        while net.pending:  # drain in-flight protocol tails without new ticks
            net.step()
        reads = [r.read() for r in reps]
        assert reads[0] == reads[1] == reads[2]
        assert len({r.canonical_state_bytes() for r in reps}) == 1
        for key, val in reads[0].items():
            assert val in writes[key]
    finally:
        stop_all(reps)


@pytest.mark.parametrize("store", STORES)
@settings(max_examples=5, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_convergence_despite_message_drops(store, seed):
    net, reps = build(3, seed, 0.25, 0.1, store)
    try:
        for i in range(12):
            reps[i % 3].mutate("add", [f"k{i}", i])
            net.run(reps, rounds=1)
        reps[0].mutate("remove", ["k0"])
        # drops only delay convergence; periodic re-sync heals every loss
        net.run(reps, rounds=120)
        net.drop_rate = 0.0  # final quiesce without loss
        net.run(reps, rounds=15)
        want = {f"k{i}": i for i in range(1, 12)}
        assert [r.read() for r in reps] == [want] * 3
    finally:
        stop_all(reps)


@pytest.mark.parametrize("store", STORES)
@settings(max_examples=6, deadline=None)
@given(
    st.lists(
        st.tuples(
            st.integers(min_value=0, max_value=2),
            st.sampled_from(["add", "add", "add", "remove", "clear"]),
            st.integers(min_value=1, max_value=8),
            st.integers(min_value=0, max_value=99),
        ),
        max_size=12,
    ),
)
def test_fully_synced_scripts_match_dict_oracle(store, script):
    """``tests/test_runtime_property.py``: with full convergence after
    every op, a plain dict is an exact oracle."""
    transport = LocalTransport()
    clock = LogicalClock()
    reps = [
        tdc.start_link(tdc.AWLWWMap, store=store, threaded=False, transport=transport, clock=clock,
                       capacity=64, tree_depth=5, device="cpu")
        for _ in range(3)
    ]
    try:
        for r in reps:
            r.set_neighbours([x for x in reps if x is not r])

        def converge():
            for _ in range(6):
                for r in reps:
                    r.sync_to_all()
                transport.pump()

        converge()
        model: dict = {}
        for who, op, key, val in script:
            if op == "add":
                reps[who].mutate("add", [key, val])
                model[key] = val
            elif op == "remove":
                reps[who].mutate("remove", [key])
                model.pop(key, None)
            else:
                reps[who].mutate("clear", [])
                model.clear()
            converge()
            for r in reps:
                assert r.read() == model, (op, key, val)
    finally:
        stop_all(reps)


class MailboxNet(SimNetwork):
    """The seeded schedule delivering into mailboxes, so a fleet's
    batched drain merges what the network lets through."""

    def _deliver(self, addr, msg) -> None:
        LocalTransport.send(self, addr, msg)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("seed", [3, 17])
def test_fleet_converges_under_drops_dups_and_reorder(store, seed):
    """Four fleet members and two solo replicas in one lossy network:
    the fleet's batched sync ticks and drains converge with the solos
    to one canonical state, equal to the written map."""
    net = MailboxNet(seed=seed, drop_rate=0.2, dup_rate=0.2)
    clock = LogicalClock()
    opts = dict(store=store, threaded=False, transport=net, clock=clock, capacity=128, tree_depth=5,
                max_sync_size=6, sync_timeout=0.0, device="cpu")
    fleet = tdc.start_fleet(4, names=[f"fm{i}" for i in range(4)], **opts)
    solos = [tdc.start_link(tdc.AWLWWMap, name=f"fs{i}", **opts) for i in range(2)]
    everyone = list(fleet.replicas) + solos
    try:
        for r in everyone:
            r.set_neighbours([x for x in everyone if x is not r])

        def round_():
            fleet.sync_tick()
            for s in solos:
                s.sync_to_all()
            net.step()
            fleet.drain()
            for s in solos:
                s.process_pending()

        want = {}
        for i in range(18):
            r = everyone[i % len(everyone)]
            r.mutate("add", [f"k{i % 11}", i])
            want[f"k{i % 11}"] = i
            round_()
        for _ in range(60):
            round_()
        net.drop_rate = net.dup_rate = 0.0
        for _ in range(15):
            round_()
        assert [r.read() for r in everyone] == [want] * len(everyone)
        assert len({r.canonical_state_bytes() for r in everyone}) == 1
        st_ = fleet.stats()
        assert st_["dispatches"] >= 1 and st_["egress"]["trees_batched"] >= 1
    finally:
        fleet.stop()
        stop_all(solos)


def _seeded_cluster(pkg: str, store, seed: int) -> list:
    """One seeded lossy script; returns every observation the two
    packages must agree on, step by step."""
    net, reps = build(3, seed, 0.2, 0.2, store, pkg)
    try:
        out = []
        for i in range(10):
            w = reps[i % 3]
            w.mutate("add", [f"k{i % 7}", i])
            if i == 4:
                reps[1].mutate("remove", ["k1"])
            if i == 7:
                reps[2].mutate("clear", [])
            for r in reps:
                r.sync_to_all()
            out.append((net.pending, net.step()))
        net.run(reps, rounds=40)
        net.drop_rate = 0.0
        net.run(reps, rounds=10)
        while net.pending:
            out.append(net.step())
        out += [r.read() for r in reps]
        out += [r.canonical_state_bytes() for r in reps]
        out.append([r._seq for r in reps])
        return out
    finally:
        stop_all(reps)


@pytest.mark.parametrize("store", STORES)
def test_one_seed_one_result_against_the_jax_simnet(store):
    j = _seeded_cluster("jax", store, 1234)
    t = _seeded_cluster("torch", store, 1234)
    assert len(t) == len(j)
    for i, (a, b) in enumerate(zip(j, t)):
        assert a == b, i
    assert len(set(t[-4:-1])) == 1, "the cluster must converge"
