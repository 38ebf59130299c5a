"""The port's metrics plane (``runtime/metrics.py``) against the JAX
package's:

- the registry cases of ``tests/test_metrics.py`` (counters, gauges,
  histograms, get-or-create, label arity, render escaping, collectors,
  snapshots) as one parametrised test;
- the bridge's table covers exactly the port's ``declared_events()``;
  the JAX package declares one more, listed here as the known
  difference (compile-cache);
- the flight recorder's ring and drop accounting, the lag tracer's
  sampling and matching;
- plane parity: one deterministic three-replica script under ``obs=``
  in each package gives equal metric family names and label sets (apart
  from the listed compile-cache family), equal
  event-counting counters and histogram counts, the same flight-recorder
  event kinds in the same order, and equal lag-tracer peers and counts;
- ``obs=None`` pays nothing: no recorder, no tracer, no handlers.
"""

from __future__ import annotations

import logging
import sys
import threading

import numpy as np
import pytest
import torch

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import metrics as j_metrics, telemetry as j_telemetry
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup, probe_lookup_kernel
from delta_crdt_ex_tpu_torch.ops.roots import batched_roots, batched_roots_kernel
from delta_crdt_ex_tpu_torch.runtime import telemetry
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.metrics import (
    FlightRecorder,
    LagTracer,
    MetricsBridge,
    Observability,
    Registry,
    default_observability,
    resolve_obs,
)
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport
from delta_crdt_ex_tpu_torch.utils import probe_tables

#: the JAX event (and its metric family) the port does not emit: no
#: per-shape compiles
JAX_ONLY_EVENTS = {
    ("delta_crdt", "jit", "compile"),
}
JAX_ONLY_FAMILY_PREFIXES = ("crdt_jit_",)


@pytest.fixture(autouse=True)
def _isolated_telemetry_handlers():
    """Other suites may leave handlers attached; every test here runs
    against clean handler tables in both packages, and leaves them
    clean."""
    for mod in (telemetry, j_telemetry):
        with mod._lock:
            mod._handlers.clear()
    yield
    for mod in (telemetry, j_telemetry):
        with mod._lock:
            mod._handlers.clear()


# ----------------------------------------------------------------------
# registry + metric families


def _counter():
    reg = Registry()
    c = reg.counter("crdt_test_total", "help", ("name",))
    c.inc(1, ("a",))
    c.inc(2.5, ("a",))
    c.inc(7, ("b",))
    assert (c.value(("a",)), c.value(("b",)), c.value(("missing",))) == (3.5, 7, 0.0)
    with pytest.raises(ValueError):
        c.inc(-1, ("a",))


def _gauge():
    reg = Registry()
    g = reg.gauge("crdt_g", "help", ("name",))
    g.set(5, ("x",))
    g.inc(2, ("x",))
    assert g.value(("x",)) == 7
    g.remove(("x",))
    assert g.value(("x",)) == 0.0
    assert "crdt_g" not in reg.render()  # no samples: family omitted


def _histogram():
    reg = Registry()
    h = reg.histogram("crdt_h", "help", (), buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 100.0):
        h.observe(v)
    assert (h.count(), h.sum()) == (4, 104.5)
    out = reg.render()
    for line in ('crdt_h_bucket{le="1"} 2', 'crdt_h_bucket{le="2"} 2', 'crdt_h_bucket{le="4"} 3',
                 'crdt_h_bucket{le="+Inf"} 4', "crdt_h_count 4"):
        assert line in out


def _get_or_create():
    reg = Registry()
    a = reg.counter("crdt_x_total", "help", ("name",))
    assert reg.counter("crdt_x_total", "help", ("name",)) is a
    for bad in (lambda: reg.gauge("crdt_x_total", "help", ("name",)),
                lambda: reg.counter("crdt_x_total", "help", ("other",)),
                lambda: reg.counter("bad name", "help")):
        with pytest.raises(ValueError):
            bad()


def _label_arity():
    c = Registry().counter("crdt_y_total", "help", ("a", "b"))
    with pytest.raises(ValueError):
        c.inc(1, ("only-one",))


def _render_escape():
    reg = Registry()
    reg.counter("crdt_esc_total", "help", ("name",)).inc(1, ('we"ird\\v\nal',))
    line = [l for l in reg.render().splitlines() if l.startswith("crdt_esc")][0]
    assert '\\"' in line and "\\\\" in line and "\\n" in line


def _collector():
    reg = Registry()
    g = reg.gauge("crdt_polled", "help")
    calls = []

    def ok_collector():
        calls.append(1)
        g.set(42)

    def bad_collector():
        raise RuntimeError("dead source")

    reg.register_collector(ok_collector)
    reg.register_collector(bad_collector)
    assert "crdt_polled 42" in reg.render() and calls
    reg.unregister_collector(ok_collector)
    reg.render()
    assert len(calls) == 1


def _snapshot():
    reg = Registry()
    reg.counter("crdt_s_total", "h", ("name",)).inc(2, ("a",))
    assert reg.snapshot()["crdt_s_total"] == {"type": "counter", "values": {"a": 2.0}}


@pytest.mark.parametrize(
    "case",
    [_counter, _gauge, _histogram, _get_or_create, _label_arity, _render_escape, _collector, _snapshot],
    ids=lambda f: f.__name__.strip("_"),
)
def test_registry_cases(case):
    case()


def test_render_matches_jax_registry():
    """The same updates render the same exposition text in both
    packages."""
    out = []
    for mod in (j_metrics, sys.modules[Registry.__module__]):
        reg = mod.Registry()
        reg.counter("crdt_a_total", "a", ("name",)).inc(3, ("x\ny",))
        reg.gauge("crdt_b", "b", ("name", "peer")).set(2.5, ("p", "q"))
        h = reg.histogram("crdt_c_seconds", "c", ("name",))
        for v in (0.0001, 0.02, 7.0, 99.0):
            h.observe(v, ("r",))
        out.append(reg.render())
    assert out[0] == out[1]


# ----------------------------------------------------------------------
# the telemetry -> metrics bridge


def test_bridge_table_covers_every_declared_event():
    subscribed = {ev for ev, _h in MetricsBridge(Registry())._table()}
    assert subscribed == set(telemetry.declared_events())
    # the known difference from the JAX package: exactly these events
    assert set(j_telemetry.declared_events()) - subscribed == JAX_ONLY_EVENTS
    assert subscribed <= set(j_telemetry.declared_events())


def test_bridge_folds_events_and_detaches():
    reg = Registry()
    bridge = MetricsBridge(reg).attach()
    bridge.attach()  # a second attach must not double-subscribe
    try:
        telemetry.execute(telemetry.SYNC_DONE, {"keys_updated_count": 3}, {"name": "r1"})
        telemetry.execute(telemetry.SYNC_ROUND, {"duration_s": 0.01, "buckets": 4, "entries": 9},
                          {"name": "r1", "plane": "host"})
        telemetry.execute(telemetry.FLEET_DISPATCH, {"replicas": 3, "messages": 7, "rows": 10,
                                                     "padded_rows": 12, "duration_s": 0.002}, {"fleet": 123})
        telemetry.execute(telemetry.SERVE_SHED, {"ops": 1}, {"name": "r1", "reason": "wal"})
        telemetry.execute(telemetry.TRANSFER, {"crossings": 5, "bytes": 80}, {"site": "x.y"})
        assert bridge.sync_done.value(("r1",)) == 1
        assert bridge.keys_updated.value(("r1",)) == 3
        assert bridge.sync_entries.value(("r1", "host")) == 9
        assert bridge.sync_seconds.count(("r1", "host")) == 1
        assert bridge.fleet_messages.value(("123",)) == 7
        assert bridge.serve_shed.value(("r1", "wal")) == 1
        assert (bridge.transfers.value(("x.y",)), bridge.transfer_bytes.value(("x.y",))) == (5, 80)
    finally:
        bridge.detach()
    telemetry.execute(telemetry.SYNC_DONE, {"keys_updated_count": 1}, {"name": "r1"})
    assert bridge.sync_done.value(("r1",)) == 1
    assert not telemetry.has_handlers(telemetry.SYNC_DONE)


def test_bridge_batch_handlers_match_per_message_folds():
    """``execute_many`` through the bridge's batch handlers gives the
    registry values a loop of per-message ``execute`` calls gives."""
    meas_done = [{"keys_updated_count": n} for n in (3, 0, 7, 2)]
    meas_round = [{"duration_s": 0.001 * (i + 1), "buckets": i, "entries": 2 * i} for i in range(4)]
    regs = []
    for batched in (True, False):
        reg = Registry()
        bridge = MetricsBridge(reg).attach()
        try:
            if batched:
                telemetry.execute_many(telemetry.SYNC_DONE, meas_done, {"name": "r1"})
                telemetry.execute_many(telemetry.SYNC_ROUND, meas_round, {"name": "r1", "plane": "host"})
            else:
                for m in meas_done:
                    telemetry.execute(telemetry.SYNC_DONE, m, {"name": "r1"})
                for m in meas_round:
                    telemetry.execute(telemetry.SYNC_ROUND, m, {"name": "r1", "plane": "host"})
        finally:
            bridge.detach()
        regs.append(reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].get("crdt_sync_done_total").value(("r1",)) == 4
    assert regs[0].get("crdt_sync_keys_updated_total").value(("r1",)) == 12


# ----------------------------------------------------------------------
# flight recorder


def test_flight_recorder_ring_and_drop_accounting():
    fr = FlightRecorder("r1", capacity=4)
    for i in range(10):
        fr.record("sync_open", seq=i)
    events = fr.events()
    assert [e["seq"] for e in events] == [6, 7, 8, 9]  # oldest dropped
    assert (fr.dropped(), fr.events_recorded()) == (6, 10)
    assert events[0]["kind"] == "sync_open" and fr.events(kind="nope") == []
    with pytest.raises(ValueError):
        FlightRecorder("x", capacity=0)


def test_flight_recorder_dump_goes_through_logger(tmp_path):
    fr = FlightRecorder("r2", capacity=8)
    fr.record("growth", capacity=128)
    fr.record("poison", value=object())
    records = []

    class Sink(logging.Handler):
        def emit(self, rec):
            records.append(rec.getMessage())

    log = logging.getLogger("test-torch-flight-sink")
    sink = Sink()
    log.addHandler(sink)
    try:
        path = tmp_path / "flight.jsonl"
        assert fr.dump(log, path=str(path)) == 2
        assert any("growth" in m for m in records)
        assert len(path.read_text().splitlines()) == 2
    finally:
        log.removeHandler(sink)


# ----------------------------------------------------------------------
# lag tracer


def _lag_every_peer_once(tr):
    tr.note_commit("origin", 1, now=10.0)
    tr.note_visible("p1", "origin", 1, now=10.5)
    tr.note_visible("p2", "origin", 1, now=11.0)
    tr.note_visible("p1", "origin", 5, now=12.0)  # no double count
    assert tr.lag.count(("origin", "p1")) == tr.lag.count(("origin", "p2")) == 1
    assert tr.lag.sum(("origin", "p1")) == pytest.approx(0.5)
    assert tr.lag.sum(("origin", "p2")) == pytest.approx(1.0)
    assert tr.peers_seen() == {"p1", "p2"}


def _lag_self_ignored(tr):
    tr.note_commit("o", 1, now=0.0)
    tr.note_visible("o", "o", 1, now=1.0)
    assert tr.peers_seen() == set()


def _lag_rounds(tr):
    tr.note_commit("o", 1, now=0.0)
    tr.note_round("o")
    tr.note_round("o")
    tr.note_visible("p", "o", 1, now=1.0)
    assert (tr.rounds.count(("o", "p")), tr.rounds.sum(("o", "p"))) == (1, 2)


def _lag_below_sample(tr):
    tr.note_commit("o", 10, now=0.0)
    tr.note_visible("p", "o", 9, now=1.0)
    assert tr.lag.count(("o", "p")) == 0


def _lag_pending_bound(tr):
    for seq in range(1, tr.MAX_PENDING + 10):
        tr.note_commit("o", seq, now=0.0)
    tr.note_visible("p", "o", tr.MAX_PENDING + 9, now=1.0)
    assert tr.lag.count(("o", "p")) == tr.MAX_PENDING


def _lag_backward_seq(tr):
    tr.note_commit("o", 10, now=0.0)
    tr.note_commit("o", 20, now=0.0)
    tr.note_visible("p", "o", 20, now=1.0)
    tr.note_commit("o", 5, now=2.0)  # the origin restarted
    tr.note_visible("p", "o", 5, now=3.0)
    assert (tr.lag.count(("o", "p")), tr.lag.sum(("o", "p"))) == (3, 3.0)


@pytest.mark.parametrize(
    "case",
    [_lag_every_peer_once, _lag_self_ignored, _lag_rounds, _lag_below_sample, _lag_pending_bound, _lag_backward_seq],
    ids=lambda f: f.__name__.strip("_"),
)
def test_lag_tracer_cases(case):
    case(LagTracer(Registry(), sample_every=1))


def test_lag_tracer_sampling_rate_and_validation():
    tr = LagTracer(Registry(), sample_every=4)
    for seq in range(1, 9):
        tr.note_commit("o", seq, now=0.0)
    tr.note_visible("p", "o", 8, now=1.0)
    assert tr.lag.count(("o", "p")) == 2  # seqs 4 and 8
    with pytest.raises(ValueError):
        LagTracer(Registry(), sample_every=0)


# ----------------------------------------------------------------------
# the Observability facade and the obs= option


def test_resolve_obs_semantics():
    import delta_crdt_ex_tpu_torch.runtime.metrics as metrics_mod

    assert resolve_obs(None) is None and resolve_obs(False) is None
    plane = Observability()
    try:
        assert resolve_obs(plane) is plane
    finally:
        plane.close()
    default = resolve_obs(True)
    try:
        assert default is default_observability()
    finally:
        default.close()
        metrics_mod._default_obs = None
    with pytest.raises(TypeError):
        resolve_obs("yes")


def test_observability_varz_and_health_aggregation():
    plane = Observability()
    try:
        plane.add_varz_source("a", lambda: {"kind": "x", "stats": {"n": 1}})
        plane.add_varz_source("dying", lambda: 1 / 0)
        plane.add_health_check("ok", lambda: {"ok": True})
        varz = plane.varz()
        assert varz["sources"]["a"]["stats"]["n"] == 1 and "error" in varz["sources"]["dying"]
        assert plane.health() == (True, {"ok": {"ok": True}})
        plane.add_health_check("bad", lambda: {"ok": False, "why": "down"})
        ok, detail = plane.health()
        assert not ok and not detail["bad"]["ok"]
        plane.add_health_check("crash", lambda: 1 / 0)
        ok, detail = plane.health()
        assert not ok and "error" in detail["crash"]
        assert varz["sources"]["transfers"]["kind"] == "transfers"
    finally:
        plane.close()
    assert "transfers" not in plane.varz()["sources"]


def test_observability_registers_replica_and_fleet_sources():
    plane = Observability()
    t = LocalTransport()
    try:
        rep = tdc.start_link(threaded=False, transport=t, obs=plane, name="obs-reg", device="cpu",
                             capacity=64, tree_depth=4)
        rep.mutate("add", ["k", "v"])
        out = plane.registry.render()
        for line in ('crdt_sync_done_total{name="obs-reg"} 1', 'crdt_sequence_number{name="obs-reg"} 1',
                     'crdt_payloads{name="obs-reg"} 1', 'crdt_mailbox_depth{name="obs-reg"} 0'):
            assert line in out
        varz = plane.varz()["sources"]["replica:obs-reg"]
        assert varz["kind"] == "replica" and varz["stats"]["payloads"] == 1 and varz["flight_events"] >= 0
        assert plane.health()[1]["replica:obs-reg"]["ok"]
        rep.stop()
        out = plane.registry.render()
        assert 'crdt_sequence_number{name="obs-reg"}' not in out
        assert "replica:obs-reg" not in plane.varz()["sources"]

        fleet = tdc.start_fleet(3, threaded=False, transport=t, obs=plane, names=[f"fm{i}" for i in range(3)],
                                device="cpu", capacity=64, tree_depth=4)
        fleet.replicas[0].mutate("add", ["k", 1])
        fleet.drain()
        assert "crdt_fleet_ticks" in plane.registry.render()
        sources = plane.varz()["sources"]
        assert [v["kind"] for v in sources.values()].count("fleet") == 1
        assert all(f"replica:fm{i}" in sources for i in range(3)) and plane.health()[0]
        fleet.stop()
        assert "crdt_fleet_ticks{" not in plane.registry.render()
    finally:
        plane.close()


# ----------------------------------------------------------------------
# plane parity with the JAX package


def _drive(reps, rounds: int) -> None:
    for _ in range(rounds):
        for r in reps:
            r.sync_to_all()
        for _ in range(50):
            if not sum(r.process_pending() for r in reps):
                break


def _plane_script(pkg: str, tmp_path) -> tuple:
    """Three unthreaded replicas under one plane (``pb`` and ``pc`` both
    push into ``pa``, whose ingress coalesces them): local batches,
    growth past the initial capacity, removes, a clear, WAL commits and
    compactions on ``a``, anti-entropy with ingress coalescing. Returns
    the plane's snapshot and the flight kinds and lag stats."""
    dc, mod = (jdc, j_metrics) if pkg == "jax" else (tdc, sys.modules[Registry.__module__])
    plane = mod.Observability(lag_sample_every=1)
    t, clock = (JTransport(), JClock()) if pkg == "jax" else (LocalTransport(), LogicalClock())
    kw = dict(transport=t, clock=clock, obs=plane, capacity=64, tree_depth=4, sync_timeout=1e9,
              log_shipping=False, threaded=False)
    if pkg == "torch":
        kw["device"] = "cpu"
    a = dc.start_link(dc.AWLWWMap, name="pa", node_id=0xF000000000000021,
                      wal_dir=str(tmp_path / pkg), fsync_mode="none", compact_every=4, **kw)
    b = dc.start_link(dc.AWLWWMap, name="pb", node_id=5, **kw)
    c = dc.start_link(dc.AWLWWMap, name="pc", node_id=6, **kw)
    try:
        a.set_neighbours([b, c])
        b.set_neighbours([a])
        c.set_neighbours([a])
        g = np.random.default_rng(5)
        for step in range(6):
            a.mutate_batch("add", [[f"a{int(x)}", step] for x in g.integers(0, 300, 40)])
            b.mutate_batch("add", [[f"b{step}_{j}", j] for j in range(3)])
            c.mutate("add", [f"c{step}", step])
            a.mutate("remove", [f"a{int(g.integers(0, 300))}"])
            if step == 3:
                b.mutate("clear", [])
            # b and c push first, so a drains both slices together
            _drive([b, c, a], 2)
        _drive([b, c, a], 3)
        assert a.read() == b.read() == c.read()
        snap = plane.registry.snapshot()
        flights = {r.name: [e["kind"] for e in r.flight.events()] for r in (a, b, c)}
        lag = (plane.lag.peers_seen(), {lb: plane.lag.lag.count(lb) for lb in plane.lag.lag.label_sets()},
               {lb: plane.lag.rounds.count(lb) for lb in plane.lag.rounds.label_sets()})
        return snap, flights, lag, a.canonical_state_bytes()
    finally:
        for r in (a, b, c):
            r.stop()
        plane.close()


def test_plane_parity_with_jax(tmp_path):
    (sj, fj, lj, cj), (st, ft, lt, ct) = _plane_script("jax", tmp_path), _plane_script("torch", tmp_path)
    assert ct == cj
    jax_families = {k for k in sj if not k.startswith(JAX_ONLY_FAMILY_PREFIXES)}
    assert set(st) == jax_families, "metric families differ beyond the listed jit family"
    for name in sorted(jax_families):
        kind = sj[name]["type"]
        assert st[name]["type"] == kind, name
        if name.startswith("crdt_transfer"):
            continue  # per-site ledgers: the two packages register different sites
        assert set(st[name]["values"]) == set(sj[name]["values"]), f"label sets of {name}"
        if kind == "counter":
            assert st[name]["values"] == sj[name]["values"], name
        elif kind == "histogram":
            assert {k: v["count"] for k, v in st[name]["values"].items()} == {
                k: v["count"] for k, v in sj[name]["values"].items()
            }, name
    # the script exercised every plane the port has
    for fam in ("crdt_sync_done_total", "crdt_capacity_grown_total", "crdt_ingest_dispatches_total",
                "crdt_wal_append_records_total", "crdt_wal_compactions_total", "crdt_drained_messages_total"):
        assert sum(st[fam]["values"].values()) > 0, fam
    assert ft == fj
    assert {"sync_open", "growth", "wal_compact"} <= set(ft["pa"])
    assert lt == lj and lt[0] == {"pa", "pb", "pc"}


def test_disabled_obs_pays_nothing():
    rep = tdc.start_link(threaded=False, transport=LocalTransport(), name="noobs", device="cpu",
                         capacity=64, tree_depth=4)
    try:
        assert rep.flight is None and rep._lag is None and rep._obs is None
        rep.mutate("add", ["k", 1])
        rep.frontdoor().read_keys(["k"])
        for ev in telemetry.declared_events():
            assert not telemetry.has_handlers(ev)
        assert "flight_events" not in rep.obs_varz()
    finally:
        rep.stop()


# ----------------------------------------------------------------------
# the kernel wrappers' launch counters under concurrent launches


def test_launch_counters_are_thread_safe():
    """Client threads, admission workers and event loops launch the
    kernels side by side: 8 threads counting launches while running the
    plain path lose no count. On the CPU the wrappers take the plain
    versions and count nothing; the count path itself needs no card."""
    st, keys = probe_tables.seeded_table(256, 8, 32, seed=3, device=torch.device("cpu"))
    qk = probe_tables.queries(keys, 8, seed=4)
    leaf = torch.randint(0, 1 << 32, (2, 16), dtype=torch.int64)
    n_threads, per = 8, 400
    wrappers = ((probe_lookup_kernel, (256, 8, 8)), (batched_roots_kernel, (2, 16)))
    for w, _shape in wrappers:
        w.reset()
    want_grid, want_roots = probe_lookup(qk, st), batched_roots(leaf)
    errors: list = []

    def worker():
        try:
            for i in range(per):
                for w, shape in wrappers:
                    w._count(shape)
                if i % 100 == 0:
                    assert torch.equal(probe_lookup(qk, st), want_grid)
                    assert torch.equal(batched_roots(leaf), want_roots)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for w, shape in wrappers:
        assert w.launches == n_threads * per
        assert w.launches_by_shape == {shape: n_threads * per}
        w.reset()
        assert w.launches == 0 and w.launches_by_shape == {}
