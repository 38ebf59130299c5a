"""The port's durability against the JAX package: snapshot storage, the
write-ahead delta log and crash recovery, on both dot stores.

- The scenarios of ``tests/test_wal.py`` (all but the soak test) on
  port replicas: crash at random points, a torn tail, an empty final
  segment, mixed histories, no counter reuse after recovery, remote
  slices logged by a receiver, compaction, a volatile checkpoint store,
  every fsync mode, the WAL telemetry — plus the ``MemoryStorage``
  ``every_op`` crash/rehydrate of ``tests/test_replica.py``.
- Byte-identical WAL segments: one script under ``LogicalClock`` with
  fixed node ids and names gives the same segment files in both
  packages, across a segment roll and a compaction.
- Cross-recovery: a ``wal_dir`` written by either package recovers in
  the other to equal ``canonical_state_bytes()``, ``read()`` and
  ``node_id``, with and without a compaction snapshot.
- Snapshot pickles: the port reads the JAX package's ``Snapshot`` class
  path as its own and refuses any other name under the JAX package.

Everything runs on the CPU at small shapes; every replica a test starts
is crashed in teardown, which closes its WAL.
"""

from __future__ import annotations

import glob
import os
import pickle
import random

import numpy as np
import pytest

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.storage import FileStorage as JFileStorage, Snapshot as JSnapshot
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.runtime import storage as t_storage, telemetry
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport
from delta_crdt_ex_tpu_torch.runtime.wal import WalLog

STORES = ["binned", "hash"]
#: one node id with the top bit set: unsigned gid orders matter
NODE_A, NODE_B = 0xF000000000000003, 7


@pytest.fixture
def spawn():
    """``spawn(pkg="torch", **opts)`` starts an unthreaded replica at
    small shapes; every replica started is crashed in teardown."""
    made = []

    def mk(pkg="torch", **opts):
        opts.setdefault("capacity", 64)
        opts.setdefault("tree_depth", 6)
        opts.setdefault("log_shipping", False)
        if pkg == "jax":
            r = jdc.start_link(jdc.AWLWWMap, threaded=False, **opts)
        else:
            r = tdc.start_link(tdc.AWLWWMap, threaded=False, device="cpu", **opts)
        made.append(r)
        return r

    yield mk
    for r in made:
        r.crash()
    t_storage.MemoryStorage.clear()


@pytest.fixture
def net():
    return LocalTransport(), LogicalClock()


def converge(transport, replicas, rounds: int = 6):
    for _ in range(rounds):
        for r in replicas:
            r.sync_to_all()
        transport.pump()


def seg_files(wal_dir) -> list:
    return sorted(glob.glob(os.path.join(str(wal_dir), "replica_*", "*.wal")))


# ---------------------------------------------------------------------------
# the scenarios of tests/test_wal.py on the port, both stores


@pytest.mark.parametrize("store", STORES)
def test_wal_rehydrates_after_crash(tmp_path, spawn, net, store):
    t, clock = net
    c = spawn(store=store, transport=t, clock=clock, name="walbasic", wal_dir=str(tmp_path))
    c.mutate("add", ["Derek", "Kraan"])
    c.mutate("add", ["Tonci", "Galic"])
    c.mutate("remove", ["Derek"])
    pre = c.read()
    node_id = c.node_id
    c.crash()

    c2 = spawn(store=store, transport=t, clock=clock, name="walbasic", wal_dir=str(tmp_path))
    assert c2.read() == pre == {"Tonci": "Galic"}
    assert c2.node_id == node_id  # dot-namespace continuity, no snapshot needed
    c2.mutate("add", ["After", "crash"])
    assert c2.read() == {"Tonci": "Galic", "After": "crash"}
    assert c2.state.key.device.type == "cpu"


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_crash_recovery_at_random_point(tmp_path, spawn, net, store, seed):
    """Random add/remove/clear history, a crash at a random point between
    WAL appends and compaction snapshots (small ``compact_every``, tiny
    segments), a restart from disk: the same read and canonical bytes,
    and fresh mutations mint fresh dots."""
    t, clock = net
    rng = random.Random(seed)
    wal = str(tmp_path / f"w{seed}")
    opts = dict(store=store, transport=t, clock=clock, name=f"walrand{seed}", wal_dir=wal)
    c = spawn(**opts, compact_every=rng.choice([3, 7]), segment_bytes=rng.choice([256, 1024]))
    keys = [f"k{i}" for i in range(12)]
    for op_i in range(rng.randrange(10, 40)):
        r = rng.random()
        if r < 0.65:
            c.mutate("add", [rng.choice(keys), op_i])
        elif r < 0.95:
            c.mutate("remove", [rng.choice(keys)])
        else:
            c.mutate("clear", [])
    pre, canon, node_id = c.read(), c.canonical_state_bytes(), c.node_id
    c.crash()

    c2 = spawn(**opts)
    assert c2.read() == pre
    assert c2.canonical_state_bytes() == canon
    assert c2.node_id == node_id
    c2.mutate("add", ["post", seed])
    assert c2.read() == {**pre, "post": seed}


@pytest.mark.parametrize("store", STORES)
def test_torn_tail_record_is_truncated(tmp_path, spawn, net, store):
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock, name="waltorn", wal_dir=str(tmp_path))
    c = spawn(**opts)
    c.mutate("add", ["kept", 1])
    c.mutate("add", ["torn", 2])
    c.crash()

    seg = seg_files(tmp_path)[-1]
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 5)  # tear the final record mid-bytes

    c2 = spawn(**opts)
    assert c2.read() == {"kept": 1}
    c2.mutate("add", ["after", 3])
    pre = c2.read()
    c2.crash()
    c3 = spawn(**opts)
    assert c3.read() == pre == {"kept": 1, "after": 3}


@pytest.mark.parametrize("store", STORES)
def test_empty_final_segment_discarded(tmp_path, spawn, net, store):
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock, name="walempty", wal_dir=str(tmp_path))
    c = spawn(**opts)
    c.mutate("add", ["a", 1])
    pre = c.read()
    c.crash()
    seg_dir = os.path.dirname(seg_files(tmp_path)[-1])
    with open(os.path.join(seg_dir, "seg-" + "9" * 20 + ".wal"), "wb"):
        pass  # durable-but-empty newest segment
    c2 = spawn(**opts)
    assert c2.read() == pre
    c2.mutate("add", ["b", 2])
    assert c2.read() == {"a": 1, "b": 2}


@pytest.mark.parametrize("store", STORES)
def test_conflicting_explicit_node_id_rejected(tmp_path, spawn, net, store):
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock, name="walnid", wal_dir=str(tmp_path))
    c = spawn(**opts)
    c.mutate("add", ["a", 1])
    nid = c.node_id
    c.crash()
    with pytest.raises(ValueError, match="mixed histories"):
        spawn(**opts, node_id=nid ^ 0xBEEF)
    assert spawn(**opts, node_id=nid).read() == {"a": 1}


@pytest.mark.parametrize("store", STORES)
def test_no_counter_reuse_after_recovery(tmp_path, spawn, net, store):
    """A peer that observed the pre-crash dots keeps them in its causal
    context: re-minted counters would be dropped there as covered."""
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock)
    hub = spawn(**opts, name="walhub", wal_dir=str(tmp_path))
    peer = spawn(**opts, name="walpeer")
    hub.set_neighbours([peer])
    peer.set_neighbours([hub])
    for i in range(8):
        hub.mutate("add", [f"pre{i}", i])
    converge(t, [hub, peer])
    assert len(peer.read()) == 8

    hub.crash()
    hub2 = spawn(**opts, name="walhub", wal_dir=str(tmp_path))
    assert hub2.read() == peer.read()
    hub2.set_neighbours([peer])
    peer.set_neighbours([hub2])
    hub2.mutate("add", ["pre0", "overwritten"])  # same key: new dot, same bucket
    for i in range(4):
        hub2.mutate("add", [f"post{i}", i])
    converge(t, [hub2, peer])
    want = {f"pre{i}": i for i in range(1, 8)}
    want.update({"pre0": "overwritten", **{f"post{i}": i for i in range(4)}})
    assert hub2.read() == want
    assert peer.read() == want, "peer dropped post-recovery dots (counter reuse)"


@pytest.mark.parametrize("store", STORES)
def test_receiver_logs_remote_slices(tmp_path, spawn, net, store):
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock)
    writer = spawn(**opts, name="walwriter")
    rx = spawn(**opts, name="walrx", wal_dir=str(tmp_path))
    writer.set_neighbours([rx])
    rx.set_neighbours([writer])
    for i in range(10):
        writer.mutate("add", [f"k{i}", i])
    writer.mutate("remove", ["k0"])
    converge(t, [writer, rx])
    pre = rx.read()
    assert len(pre) == 9
    rx.crash()

    rx2 = spawn(**opts, name="walrx", wal_dir=str(tmp_path))
    assert rx2.read() == pre
    writer.set_neighbours([rx2])
    rx2.set_neighbours([writer])
    writer.mutate("add", ["k10", 10])
    converge(t, [writer, rx2])
    assert rx2.read() == {**pre, "k10": 10}


@pytest.mark.parametrize("store", STORES)
def test_compaction_reclaims_segments(tmp_path, spawn, net, store):
    t, clock = net
    c = spawn(store=store, transport=t, clock=clock, name="walcomp", wal_dir=str(tmp_path),
              compact_every=5, segment_bytes=256)
    for i in range(23):
        c.mutate("add", [f"x{i}", i])
    assert len(seg_files(tmp_path)) <= 2, seg_files(tmp_path)
    assert glob.glob(os.path.join(str(tmp_path), "snapshots", "*.pkl"))
    st = c.stats()["wal"]
    assert st["uncompacted_records"] == 3 and st["segments"] <= 2 and c.wal_size_bytes() > 0
    pre = c.read()
    c.crash()
    c2 = spawn(store=store, transport=t, clock=clock, name="walcomp", wal_dir=str(tmp_path))
    assert c2.read() == pre


@pytest.mark.parametrize("store", STORES)
def test_volatile_snapshot_store_keeps_segments(tmp_path, spawn, net, store):
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock, name="walvol", wal_dir=str(tmp_path),
                storage_module=tdc.MemoryStorage(), compact_every=5)
    c = spawn(**opts)
    for i in range(12):
        c.mutate("add", [f"k{i}", i])
    pre = c.read()
    c.crash()
    tdc.MemoryStorage.clear()  # the process died: RAM snapshots are gone
    assert spawn(**opts).read() == pre, "compaction deleted the only durable copy"


@pytest.mark.parametrize("fsync_mode", ["record", "batch", "interval", "none"])
def test_fsync_modes_all_recover(tmp_path, spawn, net, fsync_mode):
    t, clock = net
    opts = dict(transport=t, clock=clock, name=f"walf_{fsync_mode}", wal_dir=str(tmp_path / fsync_mode),
                fsync_mode=fsync_mode)
    c = spawn(**opts)
    c.mutate("add", ["a", 1])
    c.mutate("add", ["b", 2])
    pre = c.read()
    c.crash()
    assert spawn(**opts).read() == pre


def test_bad_fsync_mode_rejected(tmp_path):
    with pytest.raises(ValueError, match="fsync_mode"):
        WalLog(str(tmp_path), fsync_mode="bogus")


@pytest.mark.parametrize("store", STORES)
def test_wal_telemetry_events(tmp_path, spawn, net, store):
    t, clock = net
    events = {}
    handlers = []
    for ev in (telemetry.WAL_APPEND, telemetry.WAL_COMPACT, telemetry.WAL_RECOVER):
        h = lambda e, m, md, _ev=ev: events.setdefault(_ev, []).append(m)
        telemetry.attach(ev, h)
        handlers.append((ev, h))
    try:
        opts = dict(store=store, transport=t, clock=clock, name="waltel", wal_dir=str(tmp_path))
        c = spawn(**opts, compact_every=3)
        for i in range(7):
            c.mutate("add", [f"k{i}", i])
        pre = c.read()
        c.crash()
        assert spawn(**opts).read() == pre
    finally:
        for ev, h in handlers:
            telemetry.detach(ev, h)
    appends = events[telemetry.WAL_APPEND]
    assert len(appends) == 7 and all(m["bytes"] > 0 for m in appends)
    assert events[telemetry.WAL_COMPACT], "compact_every=3 must have compacted"
    (rec,) = events[telemetry.WAL_RECOVER]
    assert rec["records"] == 1 and rec["bytes"] > 0


@pytest.mark.parametrize("store", STORES)
def test_mixed_history_rejected(tmp_path, spawn, net, store):
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock, name="walmix", wal_dir=str(tmp_path))
    c = spawn(**opts)
    c.mutate("add", ["a", 1])
    c.crash()
    snap = c._snapshot()
    snap.node_id ^= 0xDEAD
    snap.arrays["ctx_gid"] = snap.arrays["ctx_gid"].copy()
    snap.arrays["ctx_gid"][c.self_slot] = np.uint64(snap.node_id)
    c.storage_module.write("walmix", snap)
    with pytest.raises(ValueError, match="mixed histories"):
        spawn(**opts)


@pytest.mark.parametrize("store", STORES)
def test_memory_storage_every_op_crash_rehydrates(spawn, net, store):
    """``tests/test_replica.py``'s storage crash test: every_op snapshots
    through ``MemoryStorage``, a crash without the goodbye sync, and a
    restart under the same name keeps the map and the node id."""
    t, clock = net
    opts = dict(store=store, transport=t, clock=clock, name="storage_test",
                storage_module=tdc.MemoryStorage())
    c = spawn(**opts)
    c.mutate("add", ["Derek", "Kraan"])
    c.mutate("add", [("complex", "key"), [1, 2]])
    c.mutate("remove", ["Derek"])
    pre, node_id, seq = c.read(), c.node_id, c._seq
    c.crash()
    c2 = spawn(**opts)
    assert c2.read() == pre and c2.node_id == node_id and c2._seq == seq
    c2.mutate("add", ["Derek", "again"])
    assert c2.read() == {**pre, "Derek": "again"}


def test_interval_storage_checkpoints_on_stop(spawn, net):
    """``storage_mode="interval"``: no write per op, one checkpoint at
    ``stop()`` (and on the threaded loop's cadence)."""
    t, clock = net
    store = tdc.MemoryStorage()
    c = spawn(transport=t, clock=clock, name="ival", storage_module=store, storage_mode="interval")
    c.mutate("add", ["a", 1])
    assert store.read("ival") is None
    c.stop()
    snap = store.read("ival")
    assert snap is not None and snap.sequence_number == 1 and snap.store == "binned"


def test_child_spec():
    spec = tdc.child_spec({"crdt": tdc.AWLWWMap, "name": "x", "sync_interval": 5})
    assert spec["id"] == "x" and spec["shutdown"] == 5.0
    assert spec["start"] == (tdc.start_link, (tdc.AWLWWMap,), {"name": "x", "sync_interval": 5})
    with pytest.raises(ValueError, match="crdt"):
        tdc.child_spec({})


# ---------------------------------------------------------------------------
# byte-identical segments and cross-recovery against the JAX package


def _script(pkg, wal_dir, store, spawn, *, compact_every=5, segment_bytes=2048):
    """Adds, removes, a clear and a peer's slices merged into replica
    ``a`` (the one with the WAL), across segment rolls and compactions.
    Returns ``a``'s read, canonical bytes, node id and segment files."""
    t, clock = (JTransport(), JClock()) if pkg == "jax" else (LocalTransport(), LogicalClock())
    mk = lambda name, nid, **o: spawn(pkg, store=store, transport=t, clock=clock, name=name,
                                      node_id=nid, sync_timeout=1e9, **o)
    a = mk("a", NODE_A, wal_dir=wal_dir, segment_bytes=segment_bytes, compact_every=compact_every)
    b = mk("b", NODE_B)
    a.set_neighbours([b])
    b.set_neighbours([a])
    g = np.random.default_rng(3)
    for step in range(12):
        a.mutate_batch("add", [[f"k{int(x)}", int(v)] for x, v in zip(g.integers(0, 40, 6), g.integers(0, 99, 6))])
        a.mutate("remove", [f"k{int(g.integers(0, 40))}"])
        b.mutate("add", [f"b{step}", step])
        if step == 6:
            a.mutate("clear", [])
        converge(t, [a, b], rounds=2)
    a.mutate_batch("add", [[f"big{i}", i] for i in range(80)])  # the all-adds fast path
    converge(t, [a, b], rounds=3)
    out = (a.read(), a.canonical_state_bytes(), a.node_id)
    files = {os.path.basename(f): open(f, "rb").read() for f in seg_files(wal_dir)}
    a.crash()
    b.crash()
    return out, files


@pytest.mark.parametrize("store", STORES)
def test_wal_segments_byte_identical_to_jax(tmp_path, spawn, store):
    (rj, cj, nj), fj = _script("jax", str(tmp_path / "j"), store, spawn)
    (rt, ct, nt), ft = _script("torch", str(tmp_path / "t"), store, spawn)
    assert (rt, ct, nt) == (rj, cj, nj)
    assert len(fj) >= 2, "the script must roll segments"
    assert sorted(ft) == sorted(fj)
    for name in fj:
        assert ft[name] == fj[name], name
    # a compaction snapshot exists on both sides
    assert glob.glob(str(tmp_path / "j" / "snapshots" / "*.pkl"))
    assert glob.glob(str(tmp_path / "t" / "snapshots" / "*.pkl"))


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("compact_every", [5, 10_000])
def test_cross_package_recovery(tmp_path, spawn, store, writer, compact_every):
    """A ``wal_dir`` one package wrote recovers in the other: with a
    compaction snapshot (``compact_every=5``) and from the log alone."""
    wal = str(tmp_path / "w")
    (read0, canon0, nid0), files = _script(writer, wal, store, spawn, compact_every=compact_every)
    snaps = glob.glob(os.path.join(wal, "snapshots", "*.pkl"))
    assert bool(snaps) == (compact_every == 5)
    reader = "torch" if writer == "jax" else "jax"
    kw = {"transport": JTransport(), "clock": JClock()} if reader == "jax" else {
        "transport": LocalTransport(), "clock": LogicalClock()}
    r = spawn(reader, store=store, name="a", wal_dir=wal, **kw)
    assert r.node_id == nid0
    assert r.read() == read0
    assert r.canonical_state_bytes() == canon0
    r.mutate("add", ["after", 1])
    assert r.read() == {**read0, "after": 1}


def test_snapshot_pickles_cross_packages(tmp_path):
    """The port reads a JAX ``Snapshot`` pickle as its own class and
    refuses any other class under the JAX package; a port pickle loads
    in the JAX package's ``FileStorage`` as a duck-equal snapshot."""
    arrays = {"ctx_gid": np.array([5], np.uint64)}
    js = JSnapshot(node_id=5, sequence_number=3, arrays=arrays, payloads={(5, 0, 1): ("k", 1)},
                   key_terms={9: "k"}, last_ts=11, store="hash")
    got = t_storage.loads(pickle.dumps(js))
    assert type(got) is t_storage.Snapshot
    assert got.__dict__.keys() == js.__dict__.keys()
    assert (got.node_id, got.store, got.payloads) == (5, "hash", {(5, 0, 1): ("k", 1)})
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        t_storage.loads(pickle.dumps(JFileStorage(str(tmp_path / "x"))))

    port_dir = str(tmp_path / "snaps")
    t_storage.FileStorage(port_dir).write("n", got)
    back = JFileStorage(port_dir).read("n")
    assert (back.node_id, back.sequence_number, back.store, back.layout) == (5, 3, "hash", "binned-v2")
    assert back.payloads == got.payloads and back.arrays["ctx_gid"].dtype == np.uint64
