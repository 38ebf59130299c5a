"""PyTorch port vs JAX package: the public API cases
(``tests/test_api.py``), plus ``Replica.flush()`` and
``runtime.fleet.start_fleet``.

Each case runs its script on the JAX package and on the port
(``Side``) and checks on each what the JAX test checks; reads,
canonical bytes and telemetry streams must agree between the two.
"""

from __future__ import annotations

import pytest

import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.api import child_spec as j_child_spec, start_link as j_start_link
from delta_crdt_ex_tpu.runtime.fleet import start_fleet as j_start_fleet
from delta_crdt_ex_tpu_torch.api import child_spec, mutate_batch, start_link
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet, start_fleet
from tests.test_torch_lattice import jax_compiles_released  # noqa: F401 (autouse)
from tests.test_torch_runtime_property import assert_twins, both


@pytest.fixture
def sides():
    pair = both()
    yield pair
    for side in pair:
        side.close()


def test_child_spec_requires_crdt():
    """The reference raises without a ``:crdt`` option (``delta_crdt.ex:73-79``)."""
    for spec_fn, start in ((child_spec, start_link), (j_child_spec, j_start_link)):
        with pytest.raises(ValueError, match="must specify 'crdt'"):
            spec_fn({})
    spec = child_spec({"crdt": tdc.AWLWWMap, "name": "sup_child", "shutdown": 1.0})
    jspec = j_child_spec({"crdt": tdc.AWLWWMap, "name": "sup_child", "shutdown": 1.0})
    assert spec["id"] == jspec["id"] == "sup_child"
    assert spec["shutdown"] == jspec["shutdown"] == 1.0
    fn, args, opts = spec["start"]
    assert fn is start_link and args == (tdc.AWLWWMap,)
    assert "shutdown" not in opts and opts == jspec["start"][2]


def test_unknown_op_and_wrong_arity_raise(sides):
    for side in sides:
        c = side.mk()
        with pytest.raises(ValueError, match="unknown operation"):
            c.mutate("bogus", [1])
        with pytest.raises(ValueError, match="expects 2 argument"):
            c.mutate("add", ["only-key"])
    assert_twins(*sides)


def test_read_keys_partial_read(sides):
    """``AWLWWMap.read/2`` (``aw_lww_map.ex:218-224``)."""
    for side in sides:
        c = side.mk()
        for i in range(10):
            c.mutate_async("add", [f"k{i}", i])
        assert c.read_keys(["k3", "k7", "missing"]) == {"k3": 3, "k7": 7}
    assert_twins(*sides)


def test_read_items_supports_unhashable_keys(sides):
    for side in sides:
        c1, c2 = side.mk(), side.mk()
        c1.set_neighbours([c2])
        c1.mutate("add", [["list", "key"], "v1"])
        c1.mutate("add", [{"dict": "key"}, "v2"])
        side.converge()
        items = sorted(c2.read_items(), key=repr)
        assert items == sorted([(["list", "key"], "v1"), ({"dict": "key"}, "v2")], key=repr)
        with pytest.raises(TypeError, match="unhashable"):
            c2.read()
    j, t = sides
    for a, b in zip(j.replicas, t.replicas):
        assert b.canonical_state_bytes() == a.canonical_state_bytes()


def test_capacity_grown_telemetry_fires(sides):
    streams = []
    for side in sides:
        events: list = []
        handler = lambda _e, meas, _meta, events=events: events.append((meas["capacity"], meas["replica_capacity"]))
        side.telemetry.attach(side.telemetry.CAPACITY_GROWN, handler)
        try:
            c = side.mk(capacity=64, tree_depth=3)  # 8 buckets x 8 bins
            for i in range(200):
                c.mutate_async("add", [i, i])
            c.flush()
            assert len(c.read()) == 200
        finally:
            side.telemetry.detach(side.telemetry.CAPACITY_GROWN, handler)
        assert events and events[-1][0] >= 256, "growth must fire telemetry"
        streams.append(events)
    assert streams[1] == streams[0]
    assert_twins(*sides)


def test_sync_round_telemetry_reports_merge(sides):
    entries = []
    for side in sides:
        rounds: list = []
        handler = lambda _e, meas, _meta, rounds=rounds: rounds.append(meas["entries"])
        side.telemetry.attach(side.telemetry.SYNC_ROUND, handler)
        try:
            c1, c2 = side.mk(), side.mk()
            c1.set_neighbours([c2])
            c1.mutate("add", ["x", 1])
            side.converge()
        finally:
            side.telemetry.detach(side.telemetry.SYNC_ROUND, handler)
        assert any(n >= 1 for n in rounds)
        entries.append(rounds)
    assert entries[1] == entries[0]


def test_mutate_batch_matches_per_op(sides):
    for side in sides:
        a = side.mk(capacity=256)
        b = side.mk(capacity=256)
        items = [[f"k{i}", i] for i in range(100)]
        side.dc.api.mutate_batch(a, "add", items)
        for args in items:
            b.mutate("add", args)
        assert a.read() == b.read() == {f"k{i}": i for i in range(100)}
        side.dc.api.mutate_batch(a, "remove", [[f"k{i}"] for i in range(0, 100, 2)])
        assert a.read() == {f"k{i}": i for i in range(1, 100, 2)}
        before = a.read()
        with pytest.raises(ValueError, match="expects"):  # a rejected batch commits nothing
            side.dc.api.mutate_batch(a, "add", [["ok", 1], ["bad-arity"]])
        assert a.read() == before
    assert_twins(*sides)
    assert side.dc.api.mutate_batch is mutate_batch


def test_flush_applies_queued_mutations(sides):
    """``Replica.flush()`` applies the queued async mutations without a
    read; the state then equals the JAX replica's."""
    for side in sides:
        c = side.mk()
        for i in range(20):
            c.mutate_async("add", [f"k{i}", i])
        c.mutate_async("remove", ["k3"])
        assert c._pending
        c.flush()
        assert not c._pending
    assert_twins(*sides)
    assert sides[1].replicas[0].read() == {f"k{i}": i for i in range(20) if i != 3}


@pytest.mark.parametrize("store", ["binned", "hash"])
def test_runtime_start_fleet_wraps_existing_replicas(store):
    """``runtime.fleet.start_fleet(replicas)`` serves replicas already
    started, as the JAX function does: the members converge in the
    fleet's drains to the same bytes as a JAX fleet built the same way."""
    sides = both(store)
    try:
        fleets = []
        for side, fn in zip(sides, (j_start_fleet, start_fleet)):
            reps = [side.mk() for _ in range(3)]
            for r in reps:
                r.set_neighbours([x for x in reps if x is not r])
            fleet = fn(reps, threaded=False, min_batch=2)
            assert fleet.replicas == reps
            for i, r in enumerate(reps):
                r.mutate("add", [f"k{i}", i])
            for _ in range(6):
                fleet.sync_tick()
                fleet.drain()
            assert all(r.read() == {"k0": 0, "k1": 1, "k2": 2} for r in reps)
            fleets.append(fleet)
        assert isinstance(fleets[1], Fleet) and fleets[1].stats()["dispatches"] > 0
        assert_twins(*sides)
        for fleet in fleets:
            fleet.stop()
    finally:
        for side in sides:
            side.close()
