"""PyTorch port vs JAX package: telemetry attach/detach racing
``execute`` (``tests/test_telemetry.py``).

The handler table is process-global and shared by every replica loop
and fleet tick thread. The module-level race and the ``execute_many``
forms run on both packages' telemetry modules, which must deliver the
same streams. The live races, a threaded replica pair's event loops and
a threaded fleet's tick thread, run on the port (the JAX package's own
test holds its runtime): no exceptions, no torn handler tables, and a
detached handler receives nothing more.
"""

from __future__ import annotations

import threading
import time

import pytest

from delta_crdt_ex_tpu.runtime import telemetry as j_telemetry
from delta_crdt_ex_tpu_torch.api import set_neighbours, start_fleet, start_link
from delta_crdt_ex_tpu_torch.runtime import telemetry as t_telemetry
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

MODULES = {"jax": j_telemetry, "port": t_telemetry}


@pytest.fixture(autouse=True)
def _isolated_handlers():
    """Start and end each case with empty handler tables on both
    packages, then put back what other suites had attached."""
    saved = {}
    for name, tel in MODULES.items():
        with tel._lock:
            saved[name] = dict(tel._handlers)
            tel._handlers.clear()
    yield
    for name, tel in MODULES.items():
        with tel._lock:
            tel._handlers.clear()
            tel._handlers.update(saved[name])


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_attach_detach_race_execute_threaded(pkg):
    """Executors hammer every declared event while the main thread
    attaches and detaches: a handler sees a whole call or none."""
    tel = MODULES[pkg]
    stop = threading.Event()
    errors: list = []

    def executor():
        try:
            while not stop.is_set():
                for ev in tel.declared_events():
                    tel.execute(ev, {"n": 1}, {"name": "race"})
        except BaseException as e:  # noqa: BLE001 - the assertion surface
            errors.append(e)

    threads = [threading.Thread(target=executor, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    calls = [0]

    def handler(_ev, _meas, _meta):
        calls[0] += 1

    try:
        for _ in range(200):
            for ev in tel.declared_events():
                tel.attach(ev, handler)
            for ev in tel.declared_events():
                tel.detach(ev, handler)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors, errors
    for ev in tel.declared_events():
        assert not tel.has_handlers(ev)
    before = calls[0]
    tel.execute(tel.SYNC_DONE, {"n": 1}, {"name": "race"})
    assert calls[0] == before


def test_declared_events_are_the_jax_events_less_the_compile_event():
    """The port declares every JAX event but ``JIT_COMPILE`` (torch
    compiles nothing per shape)."""
    assert set(t_telemetry.declared_events()) == set(j_telemetry.declared_events()) - {j_telemetry.JIT_COMPILE}


def test_attach_detach_race_replica_loop():
    """Handlers churn while two threaded replicas' loops emit from merges
    and mutations."""
    transport = LocalTransport()
    a = start_link(threaded=True, transport=transport, name="tel-a", sync_interval=0.005, device="cpu")
    b = start_link(threaded=True, transport=transport, name="tel-b", sync_interval=0.005, device="cpu")
    set_neighbours(a, [b])
    set_neighbours(b, [a])
    seen = []

    def handler(_ev, meas, meta):
        seen.append((dict(meas), dict(meta)))

    try:
        deadline = time.monotonic() + 2.0
        i = 0
        while time.monotonic() < deadline:
            t_telemetry.attach(t_telemetry.SYNC_DONE, handler)
            a.mutate("add", [f"k{i}", i])
            t_telemetry.detach(t_telemetry.SYNC_DONE, handler)
            b.mutate("add", [f"p{i}", i])
            i += 1
        assert seen, "attached windows never observed an event"
        for meas, meta in seen:
            assert "keys_updated_count" in meas and "name" in meta
    finally:
        t_telemetry.detach(t_telemetry.SYNC_DONE, handler)
        a.stop()
        b.stop()
    assert not t_telemetry.has_handlers(t_telemetry.SYNC_DONE)


def test_attach_detach_race_fleet_tick_thread():
    """The same churn against a threaded fleet's tick thread."""
    fleet = start_fleet(
        4, threaded=True, transport=LocalTransport(), sync_interval=0.005,
        names=[f"telf{i}" for i in range(4)], device="cpu",
    )
    reps = fleet.replicas
    for r in reps:
        set_neighbours(r, [p for p in reps if p is not r])
    counts = [0]

    def handler(_ev, _meas, _meta):
        counts[0] += 1

    events = (t_telemetry.SYNC_DONE, t_telemetry.SYNC_ROUND, t_telemetry.FLEET_DISPATCH)
    try:
        deadline = time.monotonic() + 2.0
        i = 0
        while time.monotonic() < deadline:
            for ev in events:
                t_telemetry.attach(ev, handler)
            reps[i % len(reps)].mutate_async("add", [f"k{i}", i])
            time.sleep(0.002)
            for ev in events:
                t_telemetry.detach(ev, handler)
            i += 1
        assert counts[0] > 0, "attached windows never observed an event"
    finally:
        for ev in events:
            t_telemetry.detach(ev, handler)
        fleet.stop()
    for ev in events:
        assert not t_telemetry.has_handlers(ev)


# ---------------------------------------------------------------------------
# execute_many: the batch form of the grouped ingest path


def _deliver(tel, handlers, meas_list, meta):
    for h in handlers:
        tel.attach(tel.SYNC_DONE, h)
    try:
        tel.execute_many(tel.SYNC_DONE, meas_list, meta)
        tel.execute(tel.SYNC_DONE, {"keys_updated_count": 9}, {})
    finally:
        for h in handlers:
            tel.detach(tel.SYNC_DONE, h)


def test_execute_many_plain_handler_sees_per_message_stream():
    streams = {}
    for pkg, tel in MODULES.items():
        seen: list = []
        meas_list = [{"keys_updated_count": n} for n in (3, 0, 7)]
        _deliver(tel, [lambda ev, meas, meta: seen.append((meas, meta))], meas_list, {"name": "x"})
        assert seen[:3] == [(m, {"name": "x"}) for m in meas_list]
        streams[pkg] = seen
    assert streams["port"] == streams["jax"]


def test_execute_many_batch_handler_gets_one_call():
    streams = {}
    for pkg, tel in MODULES.items():
        per_message: list = []
        batches: list = []

        def handler(ev, meas, meta, per_message=per_message):
            per_message.append(meas)

        handler.batch = lambda ev, ml, meta, batches=batches: batches.append((list(ml), meta))
        meas_list = [{"keys_updated_count": n} for n in range(5)]
        _deliver(tel, [handler], meas_list, {"name": "x"})
        assert batches == [(meas_list, {"name": "x"})]
        assert per_message == [{"keys_updated_count": 9}]  # plain execute stays per message
        streams[pkg] = (batches, per_message)
    assert streams["port"] == streams["jax"]


def test_execute_many_mixed_handlers():
    streams = {}
    for pkg, tel in MODULES.items():
        plain: list = []
        batched: list = []

        def batch_capable(ev, meas, meta):
            batched.append(("per-message", meas["keys_updated_count"]))

        batch_capable.batch = lambda ev, ml, meta, batched=batched: batched.extend(
            m["keys_updated_count"] for m in ml
        )
        meas_list = [{"keys_updated_count": n} for n in (1, 2, 3)]
        _deliver(tel, [lambda ev, meas, meta: plain.append(meas["keys_updated_count"]), batch_capable], meas_list, {})
        assert plain == [1, 2, 3, 9]
        assert batched == [1, 2, 3, ("per-message", 9)]
        streams[pkg] = (plain, batched)
    assert streams["port"] == streams["jax"]
