"""The replicas' device data plane, PyTorch port against the JAX package
(the cases of ``tests/test_device_plane.py`` that one device can show):

- a replica given ``device=`` with an explicit index is PINNED: its
  peers place sync slices straight on its device (tensor bodies,
  ``replica.slice_place``), with the row indices kept as host control
  metadata; an unpinned receiver gets the host plane; a fan-out over
  pinned and unpinned peers builds one body a plane;
- the walk repair, the gap repair and a partition/heal soak ride the
  device plane; a seeded drop/dup/reorder schedule converges; a
  rehydrated replica is pinned again; ``SYNC_ROUND`` names the plane;
- a pinned pair's state, diff feed, WAL segment bytes and transfer
  counts equal two JAX replicas pinned to one JAX device;
- every unpinned path keeps ``device_of`` → ``None`` (the local and the
  TCP transport, fleet members);
- members pinned to one device form one tier-0 tree group and derive
  the JAX package's tree (roles, tiers, captains and epoch).
"""

from __future__ import annotations

import glob
import os

import jax
import numpy as np
import torch

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.runtime import treesync as j_ts
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu.utils import transfers as j_transfers
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, telemetry as t_telemetry, treesync as t_ts
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.simnet import SimNetwork
from delta_crdt_ex_tpu_torch.runtime.storage import MemoryStorage
from delta_crdt_ex_tpu_torch.runtime.tcp_transport import TcpTransport
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from delta_crdt_ex_tpu_torch.utils import transfers as t_transfers

PIN = "cpu:0"  # the one CPU device, given with an index: pinned
TOP = 1 << 63


def _mk(transport, clock, **opts):
    opts.setdefault("capacity", 64)
    opts.setdefault("tree_depth", 6)
    opts.setdefault("device", "cpu")
    return t_api.start_link(t_api.AWLWWMap, threaded=False, transport=transport, clock=clock, **opts)


def _capture_entries(transport):
    captured = []
    orig = transport.send

    def send(addr, msg):
        if isinstance(msg, t_sync.EntriesMsg):
            captured.append(msg)
        return orig(addr, msg)

    transport.send = send
    return captured


def converge(transport, replicas, rounds: int = 6):
    for _ in range(rounds):
        for r in replicas:
            r.sync_to_all()
        transport.pump()


def _placed() -> int:
    return t_transfers.snapshot()["replica.slice_place"]["count"]


def test_pinned_rule():
    t, c = TTransport(), TClock()
    pinned = [_mk(t, c, device=d) for d in (PIN, torch.device("cpu", 0))]
    unpinned = [_mk(t, c, device=d) for d in ("cpu", torch.device("cpu"))]
    assert all(r.pinned_device == torch.device("cpu", 0) for r in pinned)
    assert all(r.pinned_device is None for r in unpinned)
    assert [t.device_of(r.addr) for r in pinned + unpinned] == [torch.device("cpu", 0)] * 2 + [None] * 2


def test_pinned_peers_sync_on_the_device_plane():
    t, c = TTransport(), TClock()
    a, b = _mk(t, c, device=PIN), _mk(t, c, device=PIN)
    a.set_neighbours([b])
    captured = _capture_entries(t)
    before = _placed()
    a.mutate("add", ["k", "v"])
    converge(t, [a, b])
    assert b.read() == {"k": "v"}
    assert captured, "no entries message crossed the transport"
    for msg in captured:
        assert isinstance(msg.arrays["key"], torch.Tensor), type(msg.arrays["key"])
        assert msg.arrays["key"].device == torch.device("cpu")
        assert isinstance(msg.arrays["rows"], np.ndarray)  # control metadata stays host
    assert _placed() - before == len(captured)
    assert b.state.leaf.device == torch.device("cpu")


def test_unpinned_receiver_uses_the_host_plane():
    t, c = TTransport(), TClock()
    a, b = _mk(t, c, device=PIN), _mk(t, c)
    a.set_neighbours([b])
    captured = _capture_entries(t)
    a.mutate("add", ["k", "v"])
    converge(t, [a, b])
    assert b.read() == {"k": "v"}
    assert captured and all(isinstance(m.arrays["key"], np.ndarray) for m in captured)


def test_mixed_fanout_builds_one_body_a_plane():
    """A fan-out over pinned and unpinned peers: the pinned ones share
    ONE device body, the unpinned one gets the host body, in one push."""
    t, c = TTransport(), TClock()
    a = _mk(t, c, device=PIN)
    b, cc, d = _mk(t, c, device=PIN), _mk(t, c, device=PIN), _mk(t, c)
    a.set_neighbours([b, cc, d])
    captured = _capture_entries(t)
    a.mutate("add", ["k", "v"])
    a.sync_to_all()
    first = [m for m in captured if m.frm == a.addr]
    assert {m.to for m in first} == {b.addr, cc.addr, d.addr}
    by_to = {m.to: m for m in first}
    assert by_to[b.addr].arrays is by_to[cc.addr].arrays  # one device body
    assert isinstance(by_to[b.addr].arrays["key"], torch.Tensor)
    assert isinstance(by_to[d.addr].arrays["key"], np.ndarray)
    converge(t, [a, b, cc, d])
    assert b.read() == cc.read() == d.read() == {"k": "v"}


def test_walk_repair_rides_the_device_plane():
    t, c = TTransport(), TClock()
    a, b = _mk(t, c, device=PIN, eager_deltas=False), _mk(t, c, device=PIN, eager_deltas=False)
    a.set_neighbours([b])
    captured = _capture_entries(t)
    for i in range(8):
        a.mutate("add", [f"k{i}", i])
    converge(t, [a, b])
    assert b.read() == {f"k{i}": i for i in range(8)}
    assert captured and all(isinstance(m.arrays["key"], torch.Tensor) for m in captured)


def test_gap_repair_rides_the_device_plane():
    t, c = TTransport(), TClock()
    c1, c2 = _mk(t, c, device=PIN), _mk(t, c, device=PIN)
    c1.set_neighbours([c2])
    converge(t, [c1, c2])
    c1.mutate("add", ["k", 1])
    c1.sync_to_all()
    t.drain(c2.addr)  # push lost
    c1.mutate("add", ["k", 2])
    c1.sync_to_all()
    pushes = [m for m in t.drain(c2.addr) if isinstance(m, t_sync.EntriesMsg)]
    assert pushes
    c2.handle(pushes[0])  # gap -> repair request
    gets = [m for m in t.drain(c1.addr) if isinstance(m, t_sync.GetDiffMsg)]
    assert gets
    c1.handle(gets[0])
    ents = [m for m in t.drain(c2.addr) if isinstance(m, t_sync.EntriesMsg)]
    assert ents and isinstance(ents[0].arrays["key"], torch.Tensor)
    c2.handle(ents[0])
    assert c2.read()["k"] == 2


def test_pinned_pair_partition_heal_soak():
    t, c = TTransport(), TClock()
    a, b = _mk(t, c, device=PIN), _mk(t, c, device=PIN)
    a.set_neighbours([b])
    b.set_neighbours([a])
    for i in range(20):
        a.mutate("add", [f"k{i}", i])
    converge(t, [a, b])
    assert b.read() == {f"k{i}": i for i in range(20)}
    a.set_neighbours([])
    b.mutate("remove", ["k0"])
    b.mutate("add", ["k1", "overwritten"])
    a.set_neighbours([b])
    converge(t, [a, b])
    want = {f"k{i}": i for i in range(2, 20)} | {"k1": "overwritten"}
    assert a.read() == want and b.read() == want


def test_adversarial_schedule_pinned():
    net = SimNetwork(seed=7, drop_rate=0.2, dup_rate=0.2)
    c = TClock()
    rs = [_mk(net, c, device=PIN) for _ in range(3)]
    for r in rs:
        r.set_neighbours([p for p in rs if p is not r])
    for i, r in enumerate(rs):
        for k in range(8):
            r.mutate("add", [f"k{i}-{k}", (i, k)])
    rs[0].mutate("remove", ["k0-0"])
    want = {f"k{i}-{k}": (i, k) for i in range(3) for k in range(8)}
    del want["k0-0"]
    for _ in range(60):
        for r in rs:
            r.sync_to_all()
        net.step()
        for r in rs:
            r.process_pending()
        if all(r.read() == want for r in rs):
            break
    assert all(r.read() == want for r in rs)


def test_rehydrate_repins_state():
    t, c = TTransport(), TClock()
    st = MemoryStorage()
    try:
        a = _mk(t, c, name="pinned", storage_module=st, device=PIN)
        a.mutate("add", ["k", "v"])
        nid = a.node_id
        t.unregister(a.name)  # crash without stop()
        b = _mk(t, c, name="pinned", storage_module=st, device=PIN)
        assert b.node_id == nid and b.read() == {"k": "v"}
        assert b.pinned_device == torch.device("cpu", 0) and t.device_of(b.addr) == torch.device("cpu", 0)
        assert b.state.leaf.device == torch.device("cpu")
    finally:
        MemoryStorage.clear()


def test_sync_round_telemetry_names_the_plane():
    planes = []
    rec = lambda event, meas, meta: planes.append(meta["plane"])
    t_telemetry.attach(t_telemetry.SYNC_ROUND, rec)
    try:
        t, c = TTransport(), TClock()
        a, b, u = _mk(t, c, device=PIN), _mk(t, c, device=PIN), _mk(t, c)
        a.set_neighbours([b])
        a.mutate("add", ["k", 1])
        converge(t, [a, b])
        assert "device" in planes and "host" not in planes, planes
        a.set_neighbours([u])
        a.mutate("add", ["k2", 2])
        converge(t, [a, u])
        assert "host" in planes, planes
    finally:
        t_telemetry.detach(t_telemetry.SYNC_ROUND, rec)


# ---------------------------------------------------------------------------
# against the JAX package

SITES = ("replica.slice_place", "replica.slice_payload_dots", "replica.slice_wire", "replica.wal_entries")


def pinned_pair_script(pkg, tmp, pinned=True):
    """Two pinned replicas (one JAX device; the port's ``cpu:0``) with a
    WAL and a diff feed each, seeded adds and removes both ways, a
    partition and a heal. Returns canonical bytes, reads, feeds, WAL
    segment bytes and the transfer-count deltas."""
    if pkg == "jax":
        dc, t, c, ledger = jdc, JTransport(), JClock(), j_transfers
        dev = {"device": jax.devices()[0]} if pinned else {}
    else:
        dc, t, c, ledger = t_api, TTransport(), TClock(), t_transfers
        dev = {"device": PIN if pinned else "cpu"}
    feeds = {0: [], 1: []}
    reps = [
        dc.start_link(
            dc.AWLWWMap, threaded=False, transport=t, clock=c, capacity=64, tree_depth=6, name=f"pp{pinned}{i}",
            node_id=(TOP if i else 0) + 40 + i, wal_dir=str(tmp / f"{pkg}{pinned}{i}"), fsync_mode="none",
            on_diffs=feeds[i].append, log_shipping=False, **dev,
        )
        for i in range(2)
    ]
    a, b = reps
    a.set_neighbours([b])
    b.set_neighbours([a])
    before = ledger.snapshot()
    rng = np.random.default_rng(9)
    for rnd in range(3):
        for r in reps:
            for _ in range(int(rng.integers(2, 6))):
                k = f"k{int(rng.integers(0, 12))}"
                if rng.random() < 0.75:
                    r.mutate("add", [k, int(rng.integers(0, 99))])
                else:
                    r.mutate("remove", [k])
        if rnd == 1:
            a.set_neighbours([])
            b.mutate("add", ["solo", 1])
            a.set_neighbours([b])
        converge(t, reps)
    now = ledger.snapshot()
    delta = {s: now[s]["count"] - before.get(s, {"count": 0})["count"] for s in SITES}
    out = [(r.canonical_state_bytes(), r.read(), r._seq) for r in reps]
    for r in reps:
        r._wal.close(flush=True)
    wal = {
        os.path.relpath(p, tmp / f"{pkg}{pinned}{i}"): open(p, "rb").read()
        for i in range(2)
        for p in sorted(glob.glob(str(tmp / f"{pkg}{pinned}{i}" / "**" / "*.wal"), recursive=True))
    }
    for r in reps:
        r.crash()
    return out, feeds, wal, delta


def test_pinned_pair_equals_jax_pinned_replicas(tmp_path):
    """THE device-plane property: a pinned pair's state, reads, seqs,
    diff feeds and WAL segment bytes equal two JAX replicas pinned to
    one JAX device, and the audited crossings count as JAX's do (every
    slice placed once; a device body logged with one WAL crossing)."""
    t_out, t_feed, t_wal, t_delta = pinned_pair_script("torch", tmp_path)
    j_out, j_feed, j_wal, j_delta = pinned_pair_script("jax", tmp_path)
    assert t_out == j_out
    assert t_feed == j_feed
    assert t_wal and list(t_wal) == list(j_wal)
    for name in t_wal:
        assert t_wal[name] == j_wal[name], name
    assert t_delta["replica.slice_place"] == j_delta["replica.slice_place"] > 0
    assert t_delta["replica.wal_entries"] == j_delta["replica.wal_entries"] > 0
    # the payload pass reads the slice's dot columns on every plane, in
    # both packages; the host-plane column fetch runs in neither
    assert t_delta["replica.slice_payload_dots"] == j_delta["replica.slice_payload_dots"]
    assert t_delta["replica.slice_wire"] == j_delta["replica.slice_wire"] == 0
    # the host plane (unpinned) ends in the same state as the device plane
    h_out, h_feed, _h_wal, h_delta = pinned_pair_script("torch", tmp_path, pinned=False)
    assert h_out == t_out and h_feed == t_feed
    assert h_delta["replica.slice_place"] == 0 and h_delta["replica.wal_entries"] == 0


def test_unpinned_paths_keep_device_of_none():
    """Every default path stays on the host plane: a bare-device replica,
    a fleet member, and a TCP transport's local and remote addresses."""
    t, c = TTransport(), TClock()
    r = _mk(t, c)
    fleet = t_api.start_fleet(2, threaded=False, device="cpu", transport=t, capacity=64, tree_depth=4)
    assert t.device_of(r.addr) is None
    assert all(t.device_of(m.addr) is None for m in fleet.replicas)
    tcp = TcpTransport()
    try:
        x = t_api.start_link(t_api.AWLWWMap, threaded=False, transport=tcp, device="cpu", capacity=64, tree_depth=4)
        y = t_api.start_link(t_api.AWLWWMap, threaded=False, transport=tcp, device=PIN, capacity=64, tree_depth=4)
        assert tcp.device_of(x.addr) is None
        assert tcp.device_of(y.addr) == torch.device("cpu", 0)
        assert tcp.device_of(("far", ("10.0.0.9", 1))) is None
    finally:
        tcp.close()


def _tree_view(pkg):
    """Twelve tree-mode members, eight pinned to one device (JAX device
    0; the port's ``cpu:0``), four unpinned; every member's derived
    tree."""
    if pkg == "jax":
        dc, t, c = jdc, JTransport(), JClock()
        pin = {"device": jax.devices()[0]}
        unpin = {}
    else:
        dc, t, c = t_api, TTransport(), TClock()
        pin, unpin = {"device": PIN}, {"device": "cpu"}
    reps = [
        dc.start_link(dc.AWLWWMap, threaded=False, transport=t, clock=c, capacity=64, tree_depth=4,
                      name=f"tg{i}", node_id=i + 1, tree_gossip=True, tree_fanout=3, sync_timeout=120.0,
                      **(pin if i % 3 else unpin))
        for i in range(12)
    ]
    for r in reps:
        r.set_neighbours([x.addr for x in reps])
    ts = t_ts if pkg == "torch" else j_ts
    groups = [ts.group_of(t, r.addr) for r in reps]
    topos = [r._tree_refresh() for r in reps]
    view = [(tp.epoch, tp.root, tp.depth, dict(tp.parent), dict(tp.children), dict(tp.tier)) for tp in topos]
    for r in reps:
        r.stop()
    return [g is not None and g[0] for g in groups], view


def test_pinned_device_tree_group_derives_the_jax_tree():
    """Members pinned to one device are ONE tier-0 group whose captain
    alone links upward; the port derives the JAX package's tree from
    the same pinned membership — roles, tiers, captains and epoch."""
    t_groups, t_view = _tree_view("torch")
    j_groups, j_view = _tree_view("jax")
    assert t_groups == j_groups == [False if i % 3 == 0 else "device" for i in range(12)]
    assert t_view == j_view
    assert len({v[0] for v in t_view}) == 1  # one epoch on every member
