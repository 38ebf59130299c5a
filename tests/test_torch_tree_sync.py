"""Tree gossip in the port (``runtime/treesync.py`` and the replica's
relay) against the JAX package, modelled on ``tests/test_tree_sync.py``:

- the derivation: ``derive_tree`` and ``group_of`` give the JAX
  package's epochs, parents, children and tiers (determinism, down
  members, groups under one captain, ``too_damaged``), and port replicas
  on one device are NOT one tier-0 group (the JAX package's pinned-device
  rule sees no device on an unpinned replica);
- tree-mode replicas: links-only monitors, the relay's coalesced
  re-emissions, ``stats()["tree"]`` equal to the JAX replica's for one
  script, seeded tree-vs-flat canonical parity on both stores equal to
  the JAX package's bytes;
- relay coalescing: the full message stream to every destination, the
  ack stream and the WAL bytes equal to the JAX package's, coalesced and
  per message;
- failures: gap repair at a relay mid-group, re-parenting after a relay
  crash, degrade to flat past the ratio and recovery, the chaos
  partition with a relay crash and WAL recovery on both stores;
- the fleet's tier-0 group with an external replica, a mixed JAX/port
  tree over ``TcpTransport``, the ``crdt_tree_*`` metric family and the
  ``replica.relay.flush`` fault point.

Everything on the CPU (``device="cpu"``), exact equality.
"""

from __future__ import annotations

import pickle
import re
import time
from pathlib import Path

import numpy as np
import pytest

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import metrics as j_metrics, treesync as j_ts
from delta_crdt_ex_tpu.runtime import tcp_transport as JT
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.fleet import Fleet as JFleet
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.runtime import metrics as t_metrics, tcp_transport as TT, treesync
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from delta_crdt_ex_tpu_torch.utils import faults
from tests.test_ingest_coalesce import keys_for_buckets

REPO = Path(__file__).resolve().parents[1]
PKG = {"jax": (jdc, JTransport, JClock), "torch": (tdc, TTransport, TClock)}


def start(pkg, **kw):
    dc = PKG[pkg][0]
    if pkg == "torch":
        kw["device"] = "cpu"
    return dc.start_link(dc.AWLWWMap, threaded=False, **kw)


def mk_universe(pkg, n, *, tree, transport=None, clock=None, names=None, **opts):
    _dc, T, C = PKG[pkg]
    transport = transport or T()
    clock = clock or C()
    opts.setdefault("capacity", 256)
    opts.setdefault("tree_depth", 6)
    opts.setdefault("sync_timeout", 120.0)
    fanout = opts.pop("tree_fanout", 2)
    reps = [
        start(pkg, transport=transport, clock=clock, name=(names[i] if names else f"tr{i}"), node_id=i + 1,
              tree_gossip=tree, tree_fanout=fanout, **opts)
        for i in range(n)
    ]
    for r in reps:
        r.set_neighbours([x.addr for x in reps])
    return transport, reps


def drive_round(reps):
    """One deterministic global round: every replica ticks its sync, then
    messages deliver to quiescence (relay cascades included)."""
    for r in reps:
        r.sync_to_all()
    for _ in range(500):
        if not sum(r.process_pending() for r in reps):
            return
    raise AssertionError("universe did not quiesce")


def drive_to_convergence(reps, rounds=12):
    for _ in range(rounds):
        drive_round(reps)


def topo_view(t):
    return (t.epoch, t.root, t.depth, dict(t.parent), dict(t.children), dict(t.tier), t.members)


def tree_stats(r) -> dict:
    return r.stats()["tree"]


# ----------------------------------------------------------------------
# derivation


@pytest.mark.parametrize(
    "n, fanout, seed, n_down, grouped",
    [(37, 4, 7, 0, False), (16, 4, 0, 1, False), (12, 2, 3, 0, True), (256, 8, 0, 0, False),
     (64, 3, -5, 6, True), (2, 2, 1, 0, False)],
)
def test_derive_tree_matches_jax(n, fanout, seed, n_down, grouped):
    members = [f"m{i}" for i in range(n)]
    group = (lambda m: ("g", int(m[1:]) // 4)) if grouped else None
    base = treesync.derive_tree(members, fanout=fanout, seed=seed, group_key=group)
    # down members: the base tree's first ones in shuffle order (the root first)
    down = set(sorted(members, key=lambda m: treesync._shuffle_rank(m, seed))[:n_down])
    t1 = treesync.derive_tree(members, fanout=fanout, seed=seed, down=down, group_key=group)
    t2 = treesync.derive_tree(list(reversed(members)), fanout=fanout, seed=seed, down=set(down), group_key=group)
    want = j_ts.derive_tree(members, fanout=fanout, seed=seed, down=down, group_key=group)
    assert t1 == t2  # member order is irrelevant
    assert topo_view(t1) == topo_view(want)
    assert topo_view(base) == topo_view(j_ts.derive_tree(members, fanout=fanout, seed=seed, group_key=group))
    assert [treesync._shuffle_rank(m, seed) for m in members] == [j_ts._shuffle_rank(m, seed) for m in members]
    # every alive member exactly once; parents and children agree
    assert set(t1.members) == set(members) - down
    for m in t1.members:
        p = t1.parent.get(m)
        assert (m == t1.root) if p is None else (m in t1.children[p])
    if n_down:
        assert base.root in down and t1.root != base.root
    if grouped:
        # each group's members hang off one captain, one tier below it
        for gk in {group(m) for m in t1.members}:
            g = [m for m in t1.members if group(m) == gk]
            caps = [m for m in g if t1.parent.get(m) not in g]
            assert len(caps) == 1
            assert all(t1.parent[m] == caps[0] and t1.tier[m] == t1.tier[caps[0]] + 1 for m in g if m != caps[0])
    else:
        assert all(len(k) <= fanout for k in t1.children.values())
    assert treesync.derive_tree(members, fanout=fanout, seed=seed + 1).epoch != base.epoch or n < 3
    assert treesync.derive_tree(members, fanout=fanout, seed=seed, down=set(members)) is None
    with pytest.raises(ValueError):
        treesync.derive_tree(members, fanout=1)


@pytest.mark.parametrize("n, down, ratio", [(1, 0, 0.25), (16, 4, 0.25), (16, 5, 0.25), (4, 1, 0.2), (4, 1, 0.25)])
def test_too_damaged_matches_jax(n, down, ratio):
    assert treesync.too_damaged(n, down, ratio) == j_ts.too_damaged(n, down, ratio)


def test_group_of_endpoint_owner_and_fleet_key():
    for ts, T in ((treesync, TTransport), (j_ts, JTransport)):
        t = T()

        class _Owner:
            tree_group = None
            device = None

        o = _Owner()
        t.register("a", o)
        assert ts.group_of(t, "a") is None  # singleton
        o.tree_group = ("fleet", "xyz")
        assert ts.group_of(t, "a") == ("group", ("fleet", "xyz"))
        assert ts.group_of(t, ("peer", ("10.0.0.1", 4321))) == ("endpoint", ("10.0.0.1", 4321))
    addrs = [f"f{i}" for i in range(5)] + [("x", ("h", 1))]
    assert treesync.fleet_group_key(addrs) == j_ts.fleet_group_key(list(reversed(addrs)))


def test_port_replicas_on_one_device_are_not_one_group():
    """The third ``group_of`` rule clusters members pinned to one
    device. Port replicas always carry a device, but only one given
    with an explicit index is pinned: replicas on a bare ``"cpu"`` (or
    ``"cuda"``) are not one tier-0 group under one captain, and the same
    member names give the JAX package's epoch, parents and tiers."""
    views = {}
    for pkg in ("jax", "torch"):
        t, reps = mk_universe(pkg, 12, tree=True, tree_fanout=3, tree_seed=11)
        mod = treesync if pkg == "torch" else j_ts
        assert all(mod.group_of(t, r.addr) is None for r in reps), pkg
        assert t.device_of(reps[0].addr) is None
        topo = reps[0]._tree_refresh()
        assert topo.depth >= 2 and len(topo.children[topo.root]) == 3  # no 11-child captain
        assert {r._tree_refresh().epoch for r in reps} == {topo.epoch}
        views[pkg] = topo_view(topo)
        for r in reps:
            r.stop()
    assert views["torch"] == views["jax"]


# ----------------------------------------------------------------------
# tree-mode replicas


def _monitors_script(pkg):
    _t, reps = mk_universe(pkg, 10, tree=True)
    drive_round(reps)
    topo = reps[0]._tree_refresh()
    for r in reps:
        mine = r._tree_refresh()
        assert mine.epoch == topo.epoch
        assert r._monitors <= set(mine.links(r.addr))
    leaf = next(r for r in reps if topo.role(r.addr) == "leaf")
    leaf.mutate("add", ["k", "v"])
    drive_round(reps)
    assert all(r.read().get("k") == "v" for r in reps)
    h = leaf.health()
    assert h["ok"] and h["neighbours"] == len(topo.links(leaf.addr))
    out = [(r.name, tree_stats(r), r.canonical_state_bytes()) for r in reps]
    for r in reps:
        r.stop()
    return out, topo_view(topo)


def test_tree_mode_monitors_only_links_and_matches_jax():
    (got, topo), (want, jtopo) = _monitors_script("torch"), _monitors_script("jax")
    assert topo == jtopo
    assert got == want  # stats()["tree"] key for key, and the bytes
    assert any(st["reemits"] > 0 for _n, st, _c in got if st["role"] in ("relay", "root"))


def _fan_in_script(pkg):
    _t, reps = mk_universe(pkg, 10, tree=True, tree_fanout=8)
    drive_round(reps)
    topo = reps[0]._tree_refresh()
    root = next(r for r in reps if r.addr == topo.root)
    by_addr = {r.addr: r for r in reps}
    kids = topo.children[root.addr]
    assert len(kids) >= 3
    for i, k in enumerate(kids[:3]):
        by_addr[k].mutate("add", [f"k{i}", i])
        by_addr[k].sync_to_all()
    root.process_pending()
    return tree_stats(root), root.stats()["ingress"]


def test_relay_coalesces_children_fan_in_as_jax_does():
    (st, ing), (jst, jing) = _fan_in_script("torch"), _fan_in_script("jax")
    assert st == jst and ing == jing
    assert st["reemits"] >= 1 and st["msgs_folded"] >= 3
    assert max(st["depth_hist"]) >= 2 or st["folds_per_reemit"] > 1.0


def test_stats_tree_absent_when_disabled_and_options_validate():
    _t, reps = mk_universe("torch", 2, tree=False)
    assert "tree" not in reps[0].stats()
    with pytest.raises(ValueError):
        start("torch", transport=TTransport(), tree_gossip=True, tree_fanout=1)
    with pytest.raises(TypeError):
        start("torch", transport=TTransport(), no_such_option=1)


def _parity_script(pkg, store, tree):
    rng = np.random.default_rng(1234)
    script = [[(int(rng.integers(0, 8)), "add" if rng.random() < 0.7 else "remove", int(rng.integers(0, 24)),
                int(rng.integers(0, 100))) for _ in range(10)] for _ in range(3)]
    _t, reps = mk_universe(pkg, 8, tree=tree, names=[f"p{i}" for i in range(8)], store=store)
    for ops in script:
        for w, f, k, v in ops:
            reps[w].mutate(f, [k, v] if f == "add" else [k])
        drive_round(reps)
    drive_to_convergence(reps)
    return [(r.read(), r.canonical_state_bytes()) for r in reps]


@pytest.mark.parametrize("store", ["binned", "hash"])
def test_seeded_tree_vs_flat_canonical_parity_matches_jax(store):
    tree = _parity_script("torch", store, True)
    assert tree == _parity_script("torch", store, False)
    assert tree == _parity_script("jax", store, True)
    assert len({c for _r, c in tree}) == 1


# ----------------------------------------------------------------------
# the relay's message stream


def _norm(m):
    """One sent message in a package-free form, dtypes included."""
    t = type(m).__name__
    if t == "EntriesMsg":
        return (t, m.originator, m.frm, m.to, np.asarray(m.buckets).tolist(),
                {c: (np.asarray(v).dtype.str, np.asarray(v).tolist()) for c, v in sorted(m.arrays.items())},
                sorted(map(repr, m.payloads.items())))
    if t == "DiffMsg":
        return (t, m.originator, m.frm, m.to, m.level, np.asarray(m.idx).tolist(),
                [(np.asarray(b).dtype.str, np.asarray(b).tolist()) for b in m.blocks], m.seq, m.log_horizon)
    if t == "GetDiffMsg":
        return (t, m.originator, m.frm, m.to, np.asarray(m.buckets).tolist())
    if t == "AckMsg":
        return (t, m.clear_addr)
    return (t, repr(m))


def recording(T):
    class Recording(T):
        """Records every successful send, per destination."""

        def __init__(self):
            super().__init__()
            self.wire: dict = {}

        def send(self, addr, msg):
            ok = super().send(addr, msg)
            if ok:
                self.wire.setdefault(addr, []).append(_norm(msg))
            return ok

    return Recording()


def _stream_script(pkg, tmp_path, coalesce, store):
    rng = np.random.default_rng(7)
    script = [[(int(rng.integers(0, 6)), "add" if rng.random() < 0.75 else "remove", int(rng.integers(0, 16)),
                int(rng.integers(0, 50))) for _ in range(8)] for _ in range(3)]
    transport = recording(PKG[pkg][1])
    wal = tmp_path / f"{pkg}-{coalesce}-{store}"
    # log shipping off: the port logs no catch-up chunk that changes
    # nothing (ROADMAP.md §3.6), so with it on the seqs part where the
    # JAX replica logs such a chunk — a difference of log shipping, not
    # of the relay under test
    _t, reps = mk_universe(pkg, 6, tree=True, transport=transport, names=[f"w{i}" for i in range(6)],
                           ingress_coalesce=coalesce, wal_dir=str(wal), fsync_mode="none", store=store,
                           log_shipping=False)
    for ops in script:
        for w, f, k, v in ops:
            reps[w].mutate(f, [k, v] if f == "add" else [k])
        drive_round(reps)
    drive_to_convergence(reps, rounds=4)
    wals = [b"".join(Path(p).read_bytes() for p in sorted(r._wal.segment_paths())) for r in reps]
    out = (transport.wire, wals, [r._seq for r in reps], [r.canonical_state_bytes() for r in reps],
           [tree_stats(r) for r in reps])
    for r in reps:
        r.crash()
    return out


@pytest.mark.parametrize("coalesce, store", [(True, "binned"), (False, "binned"), (True, "hash")])
def test_relay_message_stream_and_wal_bytes_match_jax(tmp_path, coalesce, store):
    wire, wals, seqs, canon, stats = _stream_script("torch", tmp_path, coalesce, store)
    jwire, jwals, jseqs, jcanon, jstats = _stream_script("jax", tmp_path, coalesce, store)
    assert set(wire) == set(jwire)
    for dst in jwire:
        assert wire[dst] == jwire[dst], f"message stream to {dst} differs"
    assert wals == jwals and seqs == jseqs and canon == jcanon and stats == jstats
    assert sum(s["reemits"] for s in stats) > 0


# ----------------------------------------------------------------------
# failures


def _gap_script(pkg):
    t, reps = mk_universe(pkg, 8, tree=True, tree_fanout=8)
    drive_round(reps)
    topo = reps[0]._tree_refresh()
    root = next(r for r in reps if r.addr == topo.root)
    by_addr = {r.addr: r for r in reps}
    kids = [by_addr[k] for k in topo.children[root.addr]]
    victim, clean = kids[0], kids[1]
    k_a, k_b = keys_for_buckets(0, 1, 2, mask=63)
    (k_c,) = keys_for_buckets(1, 2, 1, mask=63)
    victim.mutate("add", [k_a, 1])
    victim.sync_to_all()
    # the victim's first push is LOST at the root
    kept = [m for m in t.drain(root.addr)
            if not (type(m).__name__ == "EntriesMsg" and m.frm == victim.addr)]
    for m in kept:
        t.send(root.addr, m)
    victim.mutate("add", [k_b, 2])
    clean.mutate("add", [k_c, 3])
    victim.sync_to_all()
    clean.sync_to_all()
    root.process_pending()
    ing = root.stats()["ingress"]
    assert ing["gap_fallbacks"] + ing["gap_partitions"] >= 1
    drive_to_convergence(reps)
    for r in reps:
        got = r.read()
        assert got.get(k_a) == 1 and got.get(k_b) == 2 and got.get(k_c) == 3, r.name
    return ing, [r.canonical_state_bytes() for r in reps], [tree_stats(r) for r in reps]


def test_gap_repair_at_relay_mid_group_matches_jax():
    assert _gap_script("torch") == _gap_script("jax")


def _crash_script(pkg):
    _t, reps = mk_universe(pkg, 10, tree=True)
    drive_round(reps)
    topo = reps[0]._tree_refresh()
    by_addr = {r.addr: r for r in reps}
    relay_addr = next(a for a, kids in topo.children.items() if a != topo.root and kids)
    relay = by_addr[relay_addr]
    survivors = [r for r in reps if r is not relay]
    relay.crash()
    survivors[0].mutate("add", ["after-crash", 9])
    drive_to_convergence(survivors)
    assert all(r.read().get("after-crash") == 9 for r in survivors)
    observers = [r for r in survivors if r._tree_down]
    epochs = {r._tree_refresh().epoch for r in observers}
    assert len(epochs) == 1
    assert all(relay_addr not in r._tree_refresh().members for r in observers)
    assert any(r._tree_reverse for r in survivors) or len(observers) == len(survivors)
    return epochs, [r.name for r in observers], [r.canonical_state_bytes() for r in survivors]


def test_relay_crash_reparents_deterministically_as_jax_does():
    assert _crash_script("torch") == _crash_script("jax")


def _degrade_script(pkg):
    obs = (t_metrics if pkg == "torch" else j_metrics).Observability()
    _t, reps = mk_universe(pkg, 4, tree=True, tree_degrade_ratio=0.2, obs=obs)
    try:
        drive_round(reps)
        reps[-1].crash()
        survivors = reps[:-1]
        survivors[0].mutate("add", ["deg", 1])
        drive_to_convergence(survivors)
        assert all(r.read().get("deg") == 1 for r in survivors)
        degraded = [tree_stats(r)["degraded"] for r in survivors]
        assert any(degraded)
        assert all(tree_stats(r)["role"] == "flat" for r in survivors if tree_stats(r)["degraded"])
        for r in survivors:
            r.set_neighbours([x.addr for x in survivors])
        drive_round(survivors)
        assert all(not tree_stats(r)["degraded"] for r in survivors)
        kinds = {r.name: [e["kind"] for e in r.flight.events() if e["kind"].startswith("tree_")] for r in survivors}
        assert any("tree_degrade" in k for k in kinds.values())
        return degraded, kinds, [tree_stats(r) for r in survivors]
    finally:
        for r in reps[:-1]:
            r.stop()
        obs.close()


def test_degrade_to_flat_past_the_ratio_and_recover_as_jax_does():
    assert _degrade_script("torch") == _degrade_script("jax")


def partitioned(T):
    class Partitioned(T):
        """Drops sends whose (frm → to) edge crosses the active partition
        (acks and Down, without ``frm``, pass)."""

        def __init__(self):
            super().__init__()
            self.groups = None

        def send(self, addr, msg):
            frm = getattr(msg, "frm", None)
            if self.groups is not None and frm is not None:
                gf = next((i for i, g in enumerate(self.groups) if frm in g), None)
                gt = next((i for i, g in enumerate(self.groups) if addr in g), None)
                if gf is not None and gt is not None and gf != gt:
                    return False
            return super().send(addr, msg)

    return Partitioned()


def _chaos_script(pkg, tmp_path, store, log_shipping):
    rng = np.random.default_rng(99)
    script = [[(int(rng.integers(0, 6)), "add" if rng.random() < 0.7 else "remove", int(rng.integers(0, 20)),
                int(rng.integers(0, 90))) for _ in range(8)] for _ in range(4)]
    transport, clock = partitioned(PKG[pkg][1]), PKG[pkg][2]()
    kw = dict(transport=transport, clock=clock, store=store, tree_gossip=True, tree_fanout=2, capacity=256,
              tree_depth=6, sync_timeout=120.0, fsync_mode="none", log_shipping=log_shipping)
    root = tmp_path / f"{pkg}-{log_shipping}"
    reps = [start(pkg, name=f"c{i}", node_id=i + 1, wal_dir=str(root / f"c{i}"), **kw) for i in range(6)]
    for r in reps:
        r.set_neighbours([x.addr for x in reps])
    drive_round(reps)
    addrs = [r.addr for r in reps]
    for rnd, ops in enumerate(script):
        for w, f, k, v in ops:
            reps[w].mutate(f, [k, v] if f == "add" else [k])
        if rnd == 1:
            transport.groups = [set(addrs[:3]), set(addrs[3:])]
        elif rnd == 2:
            transport.groups = None
        drive_round(reps)
    topo = next(t for t in (r._tree_refresh() for r in reps) if t is not None)
    idx = addrs.index(next(a for a in topo.children if topo.children[a]))
    name = reps[idx].name
    reps[idx].crash()
    reps[idx] = start(pkg, name=name, wal_dir=str(root / name), **kw)
    for r in reps:
        r.set_neighbours([x.addr for x in reps])
    drive_to_convergence(reps)
    _t, flat = mk_universe(pkg, 6, tree=False, names=[f"f{i}" for i in range(6)], store=store)
    for ops in script:
        for w, f, k, v in ops:
            flat[w].mutate(f, [k, v] if f == "add" else [k])
        drive_round(flat)
    drive_to_convergence(flat)
    want = flat[0].read()
    assert all(r.read() == want for r in reps)
    canon = {r.canonical_state_bytes() for r in reps}
    assert canon == {flat[0].canonical_state_bytes()}
    out = (name, canon, [r._seq for r in reps], [r.node_id for r in reps])
    for r in reps:
        r.crash()
    return out


@pytest.mark.parametrize("log_shipping", [False, True])
@pytest.mark.parametrize("store", ["binned", "hash"])
def test_chaos_partition_relay_crash_wal_recovery_matches_jax(tmp_path, store, log_shipping):
    got = _chaos_script("torch", tmp_path, store, log_shipping)
    want = _chaos_script("jax", tmp_path, store, log_shipping)
    if log_shipping:
        # the end state, node ids and the recovered member are the JAX
        # package's; the seqs are not, because the port logs no catch-up
        # chunk that changes nothing (ROADMAP.md §3.6) and so mints fewer
        got, want = (got[:2] + got[3:]), (want[:2] + want[3:])
    assert got == want


# ----------------------------------------------------------------------
# the fleet's tier 0, a mixed tree over TCP


def _fleet_script(pkg):
    dc, T, C = PKG[pkg]
    transport, clock = T(), C()
    kw = dict(transport=transport, clock=clock, tree_gossip=True, tree_fanout=2, capacity=256, tree_depth=6,
              sync_timeout=120.0)
    if pkg == "torch":
        kw["device"] = "cpu"
    fleet = dc.start_fleet(5, threaded=False, names=[f"fm{i}" for i in range(5)], **kw)
    try:
        groups = {r.tree_group for r in fleet.replicas}
        assert len(groups) == 1 and next(iter(groups)) is not None
        ext = dc.start_link(dc.AWLWWMap, threaded=False, name="external", node_id=99, **kw)
        members = [r.addr for r in fleet.replicas] + [ext.addr]
        for r in fleet.replicas:
            r.set_neighbours(members)
        ext.set_neighbours(members)
        topo = ext._tree_refresh()
        fleet_addrs = {r.addr for r in fleet.replicas}
        outward = [a for a in fleet_addrs if any(x not in fleet_addrs for x in topo.links(a))]
        assert len(outward) == 1  # the captain
        # a duty pass with every member due (an explicit clock: the pass
        # must not depend on how fast the loop turns)
        ticks = iter(range(1, 1000))
        ext.mutate("add", ["from-outside", 42])
        for _ in range(12):
            ext.sync_to_all()
            ext.process_pending()
            fleet.run_duties(now=float(next(ticks)))
            fleet.drain()
            if all(r.read().get("from-outside") == 42 for r in fleet.replicas):
                break
        assert all(r.read().get("from-outside") == 42 for r in fleet.replicas)
        fleet.replicas[3].mutate("add", ["from-inside", 7])
        for _ in range(12):
            fleet.run_duties(now=float(next(ticks)))
            fleet.drain()
            ext.sync_to_all()
            ext.process_pending()
            if ext.read().get("from-inside") == 7:
                break
        assert ext.read().get("from-inside") == 7
        # fleet members mint random node ids, so the reads compare, not the bytes
        out = (next(iter(groups)), topo_view(topo), outward, ext.read())
        ext.stop()
        return out
    finally:
        fleet.stop()


def test_fleet_tier0_group_converges_with_an_external_as_jax_does():
    assert _fleet_script("torch") == _fleet_script("jax")


def test_mixed_jax_and_port_tree_over_tcp_converges():
    """Two port replicas on the port's TcpTransport and two JAX replicas
    on the JAX package's, one tree over the full membership: each
    endpoint is a tier-0 group, every member derives the same epoch, and
    writes on both sides converge to equal canonical bytes."""
    jt, tt = JT.TcpTransport(), TT.TcpTransport()
    reps: list = []
    try:
        kw = dict(threaded=False, capacity=256, tree_depth=6, sync_timeout=0.05, tree_gossip=True, tree_fanout=2)
        reps += [jdc.start_link(jdc.AWLWWMap, transport=jt, name=f"j{i}", **kw) for i in range(2)]
        reps += [tdc.start_link(tdc.AWLWWMap, transport=tt, name=f"t{i}", device="cpu", **kw) for i in range(2)]
        members = [r.addr for r in reps]
        assert members[0] == jt.remote_addr("j0") and members[2] == tt.remote_addr("t0")
        for r in reps:
            r.set_neighbours(members)
        topos = [r._tree_refresh() for r in reps]
        assert len({t.epoch for t in topos}) == 1
        assert topo_view(topos[2]) == topo_view(topos[0])
        assert treesync.group_of(tt, members[0]) == ("endpoint", tuple(jt.endpoint))
        reps[1].mutate_batch("add", [[f"j{i}", i] for i in range(12)])
        reps[3].mutate_batch("add", [[f"t{i}", [i, "x"]] for i in range(12)])
        reps[3].mutate("remove", ["t4"])
        want = {f"j{i}": i for i in range(12)} | {f"t{i}": [i, "x"] for i in range(12) if i != 4}
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            for r in reps:
                r.sync_to_all()
            for _ in range(3):
                jt.pump()
                tt.pump()
                time.sleep(0.01)
            if len({r.canonical_state_bytes() for r in reps}) == 1 and all(r.read() == want for r in reps):
                break
        assert len({r.canonical_state_bytes() for r in reps}) == 1
        assert all(r.read() == want for r in reps)
    finally:
        for r in reps:
            r.crash()
        jt.close()
        tt.close()


# ----------------------------------------------------------------------
# the metric family and the fault point


def _metrics_script(pkg):
    obs = (t_metrics if pkg == "torch" else j_metrics).Observability()
    _t, reps = mk_universe(pkg, 8, tree=True, tree_fanout=2, obs=obs)
    try:
        drive_round(reps)
        reps[5].mutate_batch("add", [[f"k{i}", i] for i in range(20)])
        drive_to_convergence(reps, rounds=3)
        snap = obs.registry.snapshot()
        fams = {k: v for k, v in snap.items() if k.startswith("crdt_tree_")}
        return {k: (v["type"], {lb: (x["count"] if isinstance(x, dict) else x) for lb, x in v["values"].items()})
                for k, v in fams.items()}
    finally:
        for r in reps:
            r.stop()
        snap = obs.registry.snapshot()
        # the topology gauges went with their replicas
        assert not any(snap[k]["values"] for k in snap if k in ("crdt_tree_role", "crdt_tree_depth"))
        obs.close()


def test_tree_metric_family_matches_jax():
    got = _metrics_script("torch")
    assert got == _metrics_script("jax")
    assert sum(got["crdt_tree_reemits_total"][1].values()) > 0
    assert len(got) == 11


def test_relay_flush_fault_point_is_wired():
    """All twelve fault sites have their call in the port's source, and
    an armed ``replica.relay.flush`` trips in a tree-mode sync tick."""
    src = "\n".join(p.read_text() for p in (REPO / "delta_crdt_ex_tpu_torch").rglob("*.py"))
    wired = {s for s in faults.SITES if re.search(rf'faultpoint\(\s*"{re.escape(s)}"', src)}
    assert wired == set(faults.SITES) and len(wired) == 12
    _t, reps = mk_universe("torch", 3, tree=True)
    with faults.armed(faults.FaultPlan([("replica.relay.flush", 1, "raise")])) as plan:
        with pytest.raises(faults.FaultInjected):
            reps[0].sync_to_all()
        assert plan.exhausted()
    # flat replicas never reach the point
    _t, flat = mk_universe("torch", 2, tree=False, names=["x0", "x1"])
    with faults.armed(faults.FaultPlan([("replica.relay.flush", 1, "raise")])) as plan:
        flat[0].sync_to_all()
        assert not plan.exhausted()


def test_pickled_relay_message_decodes_in_the_jax_package():
    """A relay's re-emission crosses the wire as the JAX package's
    ``EntriesMsg``: the port's codec writes it under the JAX class
    path, and the JAX decoder reads back equal fields."""
    _t, reps = mk_universe("torch", 4, tree=True, tree_fanout=2)
    drive_round(reps)
    topo = reps[0]._tree_refresh()
    relay = next(r for r in reps if topo.role(r.addr) != "leaf" and topo.children.get(r.addr))
    sent: list = []
    orig = relay.transport.send
    relay.transport.send = lambda a, m: sent.append(m) or orig(a, m)
    child = next(r for r in reps if topo.parent.get(r.addr) == relay.addr)
    child.mutate("add", ["relayed", 1])
    child.sync_to_all()
    relay.process_pending()
    relay.transport.send = orig
    reemits = [m for m in sent if type(m).__name__ == "EntriesMsg" and m.frm == relay.addr]
    assert reemits
    back = pickle.loads(TT.wire_dumps(reemits[0]))
    assert type(back).__module__.startswith("delta_crdt_ex_tpu.") and _norm(back) == _norm(reemits[0])


def _tcp_fleets_script(pkg, n=4):
    """Two TCP endpoints with an ``n``-member tree fleet each and all
    ``2n`` members as every member's neighbours. Returns the epochs an
    endpoint derived, whether the two endpoints' epochs differ, the
    captains a fleet, whether both endpoints derived one tree (every
    address rewritten as ``(name, side)``), and the converged read."""
    dc, C = PKG[pkg][0], PKG[pkg][2]
    mod = TT if pkg == "torch" else JT
    ts = [mod.TcpTransport("127.0.0.1") for _ in range(2)]
    clock = C()
    kw = dict(threaded=False, clock=clock, capacity=256, tree_depth=6, sync_timeout=0.05, tree_gossip=True,
              tree_fanout=2)
    if pkg == "torch":
        kw["device"] = "cpu"
    fleets = []
    try:
        for g in range(2):
            reps = [dc.start_link(dc.AWLWWMap, transport=ts[g], name=f"{'ab'[g]}{i}", node_id=1 + 10 * g + i, **kw)
                    for i in range(n)]
            fleets.append((tdc.Fleet if pkg == "torch" else JFleet)(reps))
        addrs = [ts[g].remote_addr(r.name) for g in range(2) for r in fleets[g].replicas]
        side = {tuple(t.endpoint): "ab"[g] for g, t in enumerate(ts)}
        norm = lambda a: (a[0], side[tuple(a[1])]) if isinstance(a, tuple) else (a, "local")
        for f in fleets:
            for r in f.replicas:
                r.set_neighbours(addrs)
        epochs = [sorted({r._tree_refresh().epoch for r in f.replicas}) for f in fleets]
        topos = [f.replicas[0]._tree_refresh() for f in fleets]
        trees = [({norm(k): norm(v) for k, v in t.parent.items()}, {norm(k): t.tier[k] for k in t.tier})
                 for t in topos]
        captains = []
        for g, f in enumerate(fleets):
            other = tuple(ts[1 - g].endpoint)
            captains.append([r.name for r in f.replicas
                             if any(isinstance(a, tuple) and tuple(a[1]) == other
                                    for a in r._tree_refresh().links(r.addr))])
        for g, f in enumerate(fleets):
            f.replicas[-1].mutate("add", [f"k{g}", g])
        deadline = time.monotonic() + 20.0
        members = [r for f in fleets for r in f.replicas]
        while time.monotonic() < deadline:
            for f in fleets:
                f.sync_tick()
            time.sleep(0.02)
            for f in fleets:
                f.drain()
            if len({r.canonical_state_bytes() for r in members}) == 1:
                break
        assert len({r.canonical_state_bytes() for r in members}) == 1
        # the addresses hold each run's ports, so the trees of the two
        # packages' runs differ: what compares is their shape
        return ([len(e) for e in epochs], epochs[0] != epochs[1], [len(c) for c in captains], trees[0] == trees[1],
                members[0].read())
    finally:
        for f in fleets:
            for r in f.replicas:
                r.crash()
        for t in ts:
            t.close()


def test_tree_fleets_over_tcp_match_jax():
    """Each fleet is one tier-0 group with one captain linked to the
    other endpoint; both endpoints derive the same tree, and converge.
    The epochs of the two endpoints differ although the trees are one:
    each side keys its own fleet by the fleet's group key and the other
    by its endpoint, and the epoch digest folds the keys' order in
    (``ROADMAP.md`` §3.9) — the JAX package does the same."""
    got = _tcp_fleets_script("torch")
    assert got == _tcp_fleets_script("jax")
    assert got == ([1, 1], True, [1, 1], True, {"k0": 0, "k1": 1})


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_fleet_duty_passes_inside_one_interval_sync_once(pkg):
    """A fleet's duty pass syncs only the members whose interval is due,
    so two passes inside one ``sync_interval`` sync them once: a loop of
    ``run_duties()`` calls converges only as fast as the wall clock
    lets intervals pass (``ROADMAP.md`` §3.9; the tier-0 test above
    passes explicit times)."""
    dc, T, C = PKG[pkg]
    t = recording(T)
    kw = dict(threaded=False, transport=t, clock=C(), capacity=256, tree_depth=6, sync_timeout=120.0,
              tree_gossip=True, tree_fanout=2, names=["d0", "d1", "d2"])
    if pkg == "torch":
        kw["device"] = "cpu"
    fleet = dc.start_fleet(3, **kw)
    try:
        for r in fleet.replicas:
            r.set_neighbours([x.addr for x in fleet.replicas])
        fleet.drain()
        sent = lambda: sum(len(v) for v in t.wire.values())
        fleet.run_duties(now=100.0)
        fleet.drain()  # the walks' acks clear the in-flight slots
        first = sent()
        fleet.run_duties(now=100.0 + fleet.replicas[0].sync_interval / 2)
        assert sent() == first  # nobody was due
        fleet.run_duties(now=100.0 + 2 * fleet.replicas[0].sync_interval)
        assert sent() > first
    finally:
        fleet.stop()
