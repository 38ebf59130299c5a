"""The port's serving front door against the JAX package, on both dot
stores (``"binned"``, the default, and ``"hash"``), with ``AWLWWMap``
and ``AWSet``:

- snapshot reads (``read_keys``, ``read``, ``items``, ``scan``) on the
  pinned generation equal the JAX package's front door on one seeded
  script, and equal ``Replica.read`` / ``read_keys`` — top-bit keys and
  terms that compare equal (``1`` / ``True``) included;
- snapshot reads finish while another thread holds the replica lock;
- a pinned snapshot does not change across merges, growth and ``gc()``,
  on a solo replica and on a fleet member: its reads stay the same and
  every tensor of its state stays bit for bit what it was (no op writes
  into a published state), and concurrent readers never see a torn
  generation;
- the front door's journal of a concurrent load, replayed through the
  JAX replica's ``apply_ops``, gives equal canonical state bytes and WAL
  segment bytes (``LogicalClock``, fixed node id, a WAL);
- ``mutate_batch`` routes through ``apply_ops``;
- overload sheds with each ``Overloaded.reason`` and recovers, and
  ``/healthz`` reads 503 and then 200 again over live HTTP;
- the fleet front door routes and reads; the front door is cached and
  closed on ``stop`` and ``crash``.

Everything runs on the CPU at small shapes, the port with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.runtime import metrics, sync as t_sync, transition
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.replica import Replica
from delta_crdt_ex_tpu_torch.runtime.serve import Overloaded, StaleSnapshot
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

STORES = ["binned", "hash"]
MODELS = ["AWLWWMap", "AWSet"]
#: one node id with the top bit set: unsigned gid orders matter
NODE = 0xF000000000000011


def _mk(pkg="torch", store="binned", model="AWLWWMap", **kw):
    kw.setdefault("capacity", 256)
    kw.setdefault("tree_depth", 6)
    kw.setdefault("sync_timeout", 1e9)
    if pkg == "jax":
        kw.setdefault("transport", JTransport())
        return jdc.start_link(getattr(jdc, model), threaded=False, store=store, **kw)
    kw.setdefault("transport", LocalTransport())
    kw.setdefault("threaded", False)
    return tdc.start_link(getattr(tdc, model), store=store, device="cpu", **kw)


def _wal_bytes(rep) -> bytes:
    segs = sorted(glob.glob(os.path.join(rep._wal.directory, "*")))
    return b"".join(open(s, "rb").read() for s in segs)


def _state_cols(state) -> dict:
    return {
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
    }


def _assert_cols_unchanged(state, cols: dict) -> None:
    for name, want in cols.items():
        assert torch.equal(getattr(state, name), want), f"published state column {name} was written in place"


# ----------------------------------------------------------------------
# snapshot reads against the JAX package


def _script_ops(model: str) -> list:
    """Groups of ops: adds (top-bit integer keys, ``1`` then ``True``),
    overwrites, removes, a clear, then more adds."""
    g = np.random.default_rng(11)
    set_model = model == "AWSet"
    add = (lambda k, v: ("add", [k])) if set_model else (lambda k, v: ("add", [k, v]))
    keys = [f"k{i}" for i in range(30)] + [(1 << 63) | int(x) for x in g.integers(0, 1 << 40, 6)]
    groups = [[add(k, i) for i, k in enumerate(keys)]]
    groups.append([add(1, "one"), add("p/x", 5), add("p/y", 6)])
    groups.append([add(True, "true"), add(keys[3], "over"), ("remove", [keys[4]])])
    groups.append([("remove", [k]) for k in keys[10:14]])
    groups.append([("clear", [])] + [add(k, j) for j, k in enumerate(keys[20:])])
    groups.append([add(f"late{i}", i) for i in range(70)])  # the all-adds fast path (n >= 64)
    groups.append([add("p/z", 7), add(0, "zero"), add(False, "false"), ("remove", [keys[21]])])
    return groups


def _reads(rep, fd, model: str) -> dict:
    probe = [f"k{i}" for i in range(0, 34, 3)] + [1, True, 0, "missing", "p/x", "p/z", "late3"]
    snap = fd.snapshot()
    out = {
        "read_keys": snap.read_keys(probe),
        "read": snap.read(),
        "items": snap.items(),
        "scan": snap.scan("p/"),
        "scan_late": snap.scan("late1"),
        "fd_read_keys": fd.read_keys(probe),
        "fd_read": fd.read(),
        "fd_scan": fd.scan("k2"),
    }
    # the strong (locked) reads agree with the lock-free ones
    assert rep.read() == out["read"]
    assert rep.read_keys(probe) == out["read_keys"]
    return out


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("store", STORES)
def test_snapshot_reads_match_jax(store, model):
    got = {}
    for pkg in ("jax", "torch"):
        clock = JClock() if pkg == "jax" else LogicalClock()
        rep = _mk(pkg, store, model, name=f"sv-{pkg}", node_id=NODE, clock=clock)
        fd = (jdc if pkg == "jax" else tdc).frontdoor(rep)
        try:
            for group in _script_ops(model):
                rep.apply_ops(group)
            got[pkg] = (_reads(rep, fd, model), rep.canonical_state_bytes())
        finally:
            rep.stop()
    (rj, cj), (rt, ct) = got["jax"], got["torch"]
    assert ct == cj
    for name in rj:
        assert rt[name] == rj[name], name
        if isinstance(rj[name], dict):
            # the same terms, not just ==-equal ones (1 vs True collapse
            # to the LWW-greatest term in both packages)
            assert [repr(k) for k in rt[name]] == [repr(k) for k in rj[name]], name
    assert [repr(p) for p in rt["items"]] == [repr(p) for p in rj["items"]]
    assert rt["read_keys"] and rt["scan"] and rt["items"]


def test_snapshot_read_does_not_flush_pending():
    """The lock-free read serves the last committed generation;
    ``Replica.read`` keeps its flush-then-read semantics."""
    rep = _mk(name="sv-strong")
    fd = tdc.frontdoor(rep)
    try:
        fd.mutate("add", ["k", 1])
        rep.mutate_async("add", ["pending", 9])  # queued, not flushed
        assert "pending" not in fd.read()
        assert rep.read() == {"k": 1, "pending": 9}
        assert fd.read()["pending"] == 9  # the flush published
        v1 = fd.snapshot().version
        fd.mutate("add", ["c", 4])
        assert fd.snapshot().version > v1
    finally:
        rep.stop()


@pytest.mark.parametrize("store", STORES)
def test_snapshot_reads_lock_free(store):
    """Snapshot reads complete while the replica lock is held by another
    thread; the strong read blocks."""
    rep = _mk(store=store, name=f"sv-lockfree-{store}")
    fd = tdc.frontdoor(rep)
    try:
        fd.mutate("add", ["k", "v"])
        rep._lock.acquire()
        try:
            got: list = []

            def reader():
                got.append(fd.read_keys(["k"]))
                got.append(fd.read())
                got.append(fd.scan("k"))
                try:
                    rep.read(timeout=0.05)
                    got.append("strong-read-did-not-block")
                except TimeoutError:
                    got.append("strong-read-blocked")

            t = threading.Thread(target=reader)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive(), "snapshot read blocked on the replica lock"
            assert got == [{"k": "v"}, {"k": "v"}, {"k": "v"}, "strong-read-blocked"]
        finally:
            rep._lock.release()
    finally:
        rep.stop()


# ----------------------------------------------------------------------
# pinned generations: merges, growth and gc never touch them


def _pinned(fd, keys):
    snap = fd.snapshot()
    return snap, (snap.read_keys(keys), snap.read(), snap.items()), _state_cols(snap.store)


def _check_pinned(snap, before, cols, keys):
    assert (snap.read_keys(keys), snap.read(), snap.items()) == before
    _assert_cols_unchanged(snap.store, cols)


@pytest.mark.parametrize("store", STORES)
def test_pinned_snapshot_across_merges_growth_gc_solo(store):
    t, clock = LocalTransport(), LogicalClock()
    a = _mk(store=store, name="pin-a", transport=t, clock=clock, capacity=64, tree_depth=4, gc_interval_ops=1 << 30)
    b = _mk(store=store, name="pin-b", transport=t, clock=clock, capacity=64, tree_depth=4)
    a.set_neighbours([b])
    b.set_neighbours([a])
    fd = tdc.frontdoor(a)
    try:
        fd.mutate("add", ["old", 1])
        a.mutate_batch("add", [[f"a{i}", i] for i in range(12)])
        keys = ["old", "a3", "b1", "a20"]
        snap, before, cols = _pinned(fd, keys)
        cap = a.state.capacity
        # merges: the peer's writes arrive through grouped and solo paths
        b.mutate_batch("add", [[f"b{i}", i] for i in range(40)])
        for _ in range(4):
            b.sync_to_all()
            a.sync_to_all()
            t.pump()
        # growth: far past the initial capacity
        a.mutate_batch("add", [[f"a{i}", -i] for i in range(12, 400)])
        assert a.state.capacity > cap, "the script must grow the store"
        # removes, a clear and gc (which replaces the payload dict)
        fd.mutate("remove", ["old"])
        a.mutate("remove", ["a3"])
        a.gc()
        _check_pinned(snap, before, cols, keys)
        assert snap.read_keys(["old"]) == {"old": 1}
        live = fd.read()
        assert "old" not in live and "a3" not in live and live["a20"] == -20 and live["b1"] == 1
        a.mutate("clear", [])
        a.gc()
        _check_pinned(snap, before, cols, keys)
        assert fd.read() == {}
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("store", STORES)
def test_pinned_snapshot_across_merges_growth_gc_fleet_member(store):
    """A fleet member whose publication is a lane of the fleet's stacked
    result: the snapshot copies the lane once per publication, and the
    stacked result stays untouched by the next batched merges (which
    start from it as the resident stack), by growth and by gc."""
    t, clock = LocalTransport(), LogicalClock()
    fleet = tdc.start_fleet(2, store=store, threaded=False, transport=t, clock=clock, device="cpu",
                            names=["pf0", "pf1"], capacity=64, tree_depth=4, sync_timeout=1e9,
                            gc_interval_ops=1 << 30)
    senders = [_mk(store=store, name=f"ps{i}", transport=t, clock=clock, capacity=64, tree_depth=4)
               for i in range(2)]
    for s, m in zip(senders, fleet.replicas):
        s.set_neighbours([m])
    a = fleet.replicas[0]
    fd = tdc.frontdoor(a)
    calls = []
    real_index_state = transition.index_state

    def counting(stacked, lane):
        calls.append(lane)
        return real_index_state(stacked, lane)

    try:
        for rnd in range(3):
            for i, s in enumerate(senders):
                s.mutate_batch("add", [[f"s{i}r{rnd}k{j}", j] for j in range(6)])
                s.sync_to_all()
            fleet.drain()
        assert a._state is None and a._serve_pub[1] is None, "the member's publication must be a fleet lane"
        transition.index_state = counting
        try:
            keys = ["s0r1k2", "s0r0k5", "zz"]
            snap, before, cols = _pinned(fd, keys)
            assert fd.snapshot() is snap and len(calls) == 1, "one lane copy per publication"
        finally:
            transition.index_state = real_index_state
        stacked = a._serve_pub[2][0]
        stacked_cols = _state_cols(stacked)
        assert before[0] == {"s0r1k2": 2, "s0r0k5": 5}
        # more batched merges: the resident stack is their input
        for rnd in range(3, 6):
            for i, s in enumerate(senders):
                s.mutate_batch("add", [[f"s{i}r{rnd}k{j}", j] for j in range(6)] + [[f"s{i}r0k0", -rnd]])
                s.sync_to_all()
            fleet.drain()
        assert fleet.stats()["stack_cache"]["hits"] > 0
        _assert_cols_unchanged(stacked, stacked_cols)
        # growth and gc on the member
        a.mutate_batch("add", [[f"own{i}", i] for i in range(300)])
        a.gc()
        _check_pinned(snap, before, cols, keys)
        _assert_cols_unchanged(stacked, stacked_cols)
        assert fd.read_keys(["s0r0k0", "own7"]) == {"s0r0k0": -5, "own7": 7}
    finally:
        fleet.stop()
        for s in senders:
            s.stop()


def _torn_read_property(rep, fd, *, generations=20, keys=5, readers=2):
    """The writer commits generation i as ONE batch setting all of
    ``g0..g{keys}`` to i; concurrent snapshot readers check that every
    read is a whole committed generation and that versions and values
    never go backwards."""
    gkeys = [f"g{j}" for j in range(keys)]
    stop = threading.Event()
    errors: list = []
    reads = [0]

    def reader():
        last_version = last_gen = -1
        try:
            while not stop.is_set():
                snap = fd.snapshot()
                if snap.version < last_version:
                    raise AssertionError(f"version regressed {last_version} -> {snap.version}")
                last_version = snap.version
                view = snap.read_keys(gkeys)
                reads[0] += 1
                if not view:
                    continue
                vals = set(view.values())
                if len(view) == keys and len(vals) != 1:
                    raise AssertionError(f"torn read: {view}")
                gen = max(vals)
                if gen < last_gen:
                    raise AssertionError(f"generation regressed {last_gen} -> {gen}")
                last_gen = gen
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(readers)]
    for t in threads:
        t.start()
    try:
        for i in range(generations):
            rep.mutate_batch("add", [[k, i] for k in gkeys])
            time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors
    assert reads[0] > 0
    assert fd.read_keys(gkeys) == {k: generations - 1 for k in gkeys}


@pytest.mark.parametrize("store", STORES)
def test_no_torn_reads_solo(store):
    rep = _mk(store=store, name=f"torn-{store}", node_id=101)
    fd = tdc.frontdoor(rep)
    try:
        _torn_read_property(rep, fd)
    finally:
        rep.stop()


@pytest.mark.parametrize("store", STORES)
def test_no_torn_reads_fleet_member(store):
    """The same property on a fleet member while the threaded fleet loop
    gossips a peer's writes into it."""
    fleet = tdc.start_fleet(2, threaded=True, store=store, device="cpu", transport=LocalTransport(),
                            names=[f"tf-{store}-0", f"tf-{store}-1"], capacity=256, tree_depth=6,
                            sync_interval=0.01, sync_timeout=600.0)
    a, b = fleet.replicas
    a.set_neighbours([b])
    b.set_neighbours([a])
    fd = tdc.frontdoor(a)
    stop = threading.Event()

    def remote_writer():
        i = 0
        while not stop.is_set():
            b.mutate_batch("add", [[f"r{i}_{j}", j] for j in range(4)])
            i += 1
            time.sleep(0.005)

    t = threading.Thread(target=remote_writer)
    t.start()
    try:
        _torn_read_property(a, fd, generations=15)
    finally:
        stop.set()
        t.join(timeout=30)
        fleet.stop()


def test_snapshot_cache_tracks_gc_republication():
    """``gc()`` republishes the pruned payload dict at the same version;
    the cache adopts the new publication instead of pinning the pre-gc
    dict."""
    rep = _mk(name="sv-gcpub")
    fd = tdc.frontdoor(rep)
    try:
        fd.mutate("add", ["k", "v"])
        before = fd.snapshot()
        rep.gc()
        after = fd.snapshot()
        assert after.version == before.version
        assert after._payloads is rep._serve_pub[3]
        assert after._payloads is not before._payloads
        assert after.read_keys(["k"]) == {"k": "v"}
    finally:
        rep.stop()


def test_stale_snapshot_defensive_retry():
    """A snapshot whose payload view cannot resolve raises StaleSnapshot;
    the front door retries on a fresher generation and serves."""
    rep = _mk(name="sv-stale")
    fd = tdc.frontdoor(rep)
    try:
        fd.mutate("add", ["k", "v"])
        snap = fd.snapshot()
        broken = type(snap)(snap.version, snap.store, snap.model, snap.num_buckets, {})
        with pytest.raises(StaleSnapshot):
            broken.read_keys(["k"])
        with pytest.raises(StaleSnapshot):
            broken.read()
        with fd._lock:
            fd._snap = broken
        rep.mutate("add", ["k2", "v2"])  # publishes a fresh generation
        assert fd.read_keys(["k"]) == {"k": "v"}
        poisoned = type(snap)(snap.version + 1_000_000, snap.store, snap.model, snap.num_buckets, {})
        with fd._lock:
            fd._snap = poisoned
        assert fd.read_keys(["k"]) == {"k": "v"}
        st = fd.stats()
        assert st["read_retries"] >= 1 and st["strong_read_fallbacks"] == 0
    finally:
        rep.stop()


# ----------------------------------------------------------------------
# write admission


def _concurrent_load(fd, n_clients=6, per=25):
    def client(i):
        for j in range(per):
            fd.mutate("add", [f"c{i}/{j}", (i, j)])
            if j % 7 == 3:
                fd.mutate("remove", [f"c{i}/{j - 1}"])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()


@pytest.mark.parametrize("store", STORES)
def test_admission_journal_replays_on_jax(tmp_path, store):
    """The port's front door admits a concurrent load; its journal,
    replayed through the JAX replica's ``apply_ops`` (and through a port
    twin's), gives equal canonical state bytes and WAL segment bytes."""
    wal = lambda tag: dict(name="adm", node_id=NODE, wal_dir=str(tmp_path / tag), fsync_mode="none")
    a = _mk(store=store, clock=LogicalClock(), **wal("loaded"))
    fd = tdc.frontdoor(a, journal=True)
    _concurrent_load(fd)
    fd.close()
    journal = fd.journal()
    st = fd.stats()
    assert st["admitted_ops"] == sum(len(g) for g in journal) > 0
    assert st["commits"] == len(journal) and st["commits"] < st["admitted_ops"], "admission must coalesce"
    j = _mk("jax", store, clock=JClock(), **wal("jax"))
    b = _mk(store=store, clock=LogicalClock(), **wal("twin"))
    try:
        for group in journal:
            j.apply_ops(group)
            b.apply_ops(group)
        assert a._seq == j._seq == b._seq == len(journal)
        assert a.canonical_state_bytes() == j.canonical_state_bytes() == b.canonical_state_bytes()
        assert a.read() == j.read()
        wa = _wal_bytes(a)
        assert wa and wa == _wal_bytes(j) == _wal_bytes(b)
    finally:
        for r in (a, j, b):
            r.stop()


def test_mutate_batch_routes_through_apply_ops(tmp_path, monkeypatch):
    """``mutate_batch`` is ``apply_ops`` of its items: the same call, and
    bit-for-bit the same state and WAL bytes as a hand-built
    ``apply_ops``."""
    seen = []
    real = Replica.apply_ops

    def spy(self, ops, timeout=None):
        seen.append(list(ops))
        return real(self, ops, timeout)

    monkeypatch.setattr(Replica, "apply_ops", spy)
    mk = lambda tag: _mk(name=f"mb-{tag}", node_id=9, clock=LogicalClock(), wal_dir=str(tmp_path / tag),
                         fsync_mode="none")
    a, b = mk("a"), mk("b")
    try:
        items = [[f"k{i}", i] for i in range(50)]
        a.mutate_batch("add", items)
        assert seen == [[("add", it) for it in items]]
        b.apply_ops([("add", it) for it in items])
        assert a.canonical_state_bytes() == b.canonical_state_bytes()
        assert _wal_bytes(a) == _wal_bytes(b)
    finally:
        a.stop()
        b.stop()


def test_admission_coalesces_and_resolves_tickets():
    rep = _mk(name="sv-adm", capacity=4096)
    fd = tdc.frontdoor(rep)
    try:
        n_clients, per = 8, 30

        def client(i):
            for j in range(per):
                fd.mutate("add", [f"c{i}/{j}", j])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        st = fd.stats()
        assert st["admitted_ops"] == n_clients * per and st["pending_ops"] == 0
        assert st["commits"] < n_clients * per and st["ops_per_commit"] > 1.0
        assert rep.read_keys([f"c{i}/0" for i in range(n_clients)]) == {f"c{i}/0": 0 for i in range(n_clients)}
        tk = fd.mutate_async("add", ["async", 1])
        tk.result(30)
        assert tk.done() and tk.error is None
        assert fd.read_keys(["async"]) == {"async": 1}
        with pytest.raises(ValueError, match="unknown operation"):
            fd.mutate("bogus", ["k"])
        with pytest.raises(ValueError, match="argument"):
            fd.mutate("add", ["k"])
        assert fd.stats()["admitted_ops"] == n_clients * per + 1
    finally:
        rep.stop()


# ----------------------------------------------------------------------
# backpressure and shedding


def _get_status(url: str) -> int:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _wait_healthy(fd, timeout=10.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not fd.health()["ok"]:
        time.sleep(0.02)
    assert fd.health()["ok"], fd.stats()


@pytest.mark.parametrize("reason", ["admission_queue", "mailbox", "queue_bytes", "wal"])
def test_overload_sheds_each_reason_and_recovers(tmp_path, reason):
    """Each backpressure signal sheds with its own reason, the shed op
    is not applied, the front door reads unhealthy, and it recovers when
    the pressure drains."""
    kw = {"wal_dir": str(tmp_path), "fsync_mode": "none", "compact_every": 1 << 20} if reason == "wal" else {}
    rep = _mk(name=f"shed-{reason}", capacity=4096, **kw)
    fd = tdc.frontdoor(rep, max_pending_ops=4, max_commit_ops=4, max_mailbox_depth=3, max_queue_bytes=1000,
                       max_wal_backlog=2, shed_health_hold=0.1)
    held = False
    try:
        if reason == "admission_queue":
            rep._lock.acquire()  # the admission worker cannot commit
            held = True
            tickets = [fd.mutate_async("add", [f"q{i}", i]) for i in range(4)]
        elif reason == "mailbox":
            for i in range(4):
                rep.transport.send(rep.addr, t_sync.AckMsg(clear_addr="nobody"))
        elif reason == "queue_bytes":
            real_stats = {"queue_bytes": 5000}
            rep.transport.transport_stats = lambda: real_stats
        else:
            for i in range(3):
                fd.mutate("add", [f"w{i}", i])  # one WAL record each
        with pytest.raises(Overloaded) as exc:
            fd.mutate("add", ["shed", 1])
        assert exc.value.reason == reason
        st = fd.stats()
        assert st["overloaded"] and st["overload_reason"] == reason and st["shed_by_reason"] == {reason: 1}
        assert fd.health()["ok"] is False
        assert isinstance(fd.read(), dict)  # reads still serve while writes shed
        # the pressure drains
        if reason == "admission_queue":
            rep._lock.release()
            held = False
            for tk in tickets:
                tk.result(30)
        elif reason == "mailbox":
            rep.process_pending()
        elif reason == "queue_bytes":
            real_stats["queue_bytes"] = 0
        else:
            rep.checkpoint()  # a compaction point empties the backlog
        _wait_healthy(fd)
        fd.mutate("add", ["after", 2])
        got = fd.read()
        assert "shed" not in got and got["after"] == 2
    finally:
        if held:
            rep._lock.release()
        rep.stop()


def test_healthz_flips_on_overload_over_http():
    """``/healthz`` answers 503 while the front door sheds and 200 again
    once the pressure drains, over live HTTP on 127.0.0.1:0. The
    pressure is a full mailbox (an unthreaded replica drains nothing), so
    no runtime lock is held while the endpoint asks every health check."""
    plane = metrics.Observability()
    rep = _mk(name="sv-hz", obs=plane)
    fd = tdc.frontdoor(rep, max_mailbox_depth=2, shed_health_hold=0.2)
    server = plane.serve(port=0)
    try:
        assert _get_status(server.url + "/healthz") == 200
        for _ in range(3):
            rep.transport.send(rep.addr, t_sync.AckMsg(clear_addr="nobody"))
        shed = 0
        for i in range(5):
            try:
                fd.mutate_async("add", [f"x{i}", i])
            except Overloaded as e:
                assert e.reason == "mailbox"
                shed += 1
        assert shed == 5
        assert _get_status(server.url + "/healthz") == 503
        with urllib.request.urlopen(server.url + "/varz", timeout=10) as r:
            varz = json.loads(r.read().decode())
        assert varz["sources"]["serve:sv-hz"]["stats"]["shed_ops"] == shed
        rep.process_pending()
        deadline = time.monotonic() + 10
        code = 503
        while time.monotonic() < deadline and code != 200:
            time.sleep(0.05)
            code = _get_status(server.url + "/healthz")
        assert code == 200
        fd.mutate("add", ["ok", 1])
        assert fd.read() == {"ok": 1}
    finally:
        rep.stop()
        plane.close()


# ----------------------------------------------------------------------
# lifecycle and the fleet front door


@pytest.mark.parametrize("end", ["stop", "crash"])
def test_frontdoor_cached_and_closed(end):
    rep = _mk(name=f"sv-life-{end}")
    fd = tdc.frontdoor(rep)
    assert tdc.frontdoor(rep) is fd
    with pytest.raises(ValueError, match="already exists"):
        tdc.frontdoor(rep, max_pending_ops=1)
    with pytest.raises(ValueError, match="max_commit_ops"):
        _mk(name="sv-life-bad").frontdoor(max_commit_ops=Replica.MAX_BATCH + 1)
    fd.mutate("add", ["k", 1])
    getattr(rep, end)()
    assert not fd._worker.is_alive() and rep._frontdoor is None
    with pytest.raises(RuntimeError, match="closed"):
        fd.mutate("add", ["k", 1])


def test_fleet_frontdoor_routing_and_reads():
    fleet = tdc.start_fleet(3, threaded=False, device="cpu", transport=LocalTransport(),
                            names=["ffd0", "ffd1", "ffd2"], capacity=256, tree_depth=6, sync_timeout=1e9)
    for i, rep in enumerate(fleet.replicas):
        rep.set_neighbours([r for j, r in enumerate(fleet.replicas) if j != i])
    fd = fleet.frontdoor()
    try:
        assert fleet.frontdoor() is fd and tdc.frontdoor(fleet) is fd
        assert all(rep._frontdoor is m for rep, m in zip(fleet.replicas, fd.members))
        with pytest.raises(ValueError, match="unknown operation"):
            fd.mutate("bogus", [])
        with pytest.raises(ValueError, match="argument"):
            fd.mutate("add", [])
        keys = [f"k{i}" for i in range(30)] + [(1 << 63) | 9]
        for i, k in enumerate(keys):
            fd.mutate("add", [k, i])
        want = {k: i for i, k in enumerate(keys)}
        assert fd.read_keys(keys) == want  # owner-routed: no gossip wait
        assert len({id(fd.member_for(k)) for k in keys}) > 1
        assert fd.stats()["admitted_ops"] == len(keys) and fd.health()["ok"]
        # gossip spreads the routed writes; every member then reads the map
        for _ in range(4):
            fleet.sync_tick()
            fleet.drain()
        assert all(fd.read(m) == want for m in range(3))
        fd.mutate("clear", [])
        assert fd.read_keys(keys) == {}
    finally:
        fleet.stop()
    assert all(not m._worker.is_alive() for m in fd.members)


@pytest.mark.cuda
def test_cuda_snapshot_read_launches_the_probe_kernel():
    """On the card a hash-store snapshot read launches ``csrc/probe.cu``
    once, at Q = ``pow4_tier(n, 8)``, and agrees with the locked read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernel is CUDA C++ and has no CPU mode")
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel

    rep = tdc.start_link(tdc.AWLWWMap, store="hash", threaded=False, transport=LocalTransport(),
                         capacity=256, tree_depth=6)
    try:
        fd = tdc.frontdoor(rep)
        fd.mutate_async("add", ["k", 1]).result(30)
        snap = fd.snapshot()
        before = probe_lookup_kernel.launches
        assert snap.read_keys(["k", "missing"]) == {"k": 1} == rep.read_keys(["k", "missing"])
        assert probe_lookup_kernel.launches >= before + 2
    finally:
        rep.stop()
