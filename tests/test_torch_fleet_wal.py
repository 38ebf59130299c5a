"""Fleet members with a write-ahead log, against the JAX fleet.

- The same seeded gossip into a WAL-backed fleet in both packages gives
  byte-identical member segments; every member then crashes and
  recovers as a solo replica, bit-equal to its pre-crash state and to
  the JAX member recovered the same way.
- ``Fleet.run_duties`` checkpoints interval-mode members on the JAX
  fleet's cadence (first sight schedules one interval out).
- A crashed member recovers as a solo replica and rejoins a new fleet,
  which keeps converging with the senders.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.fleet import Fleet as JFleet
from delta_crdt_ex_tpu.runtime.storage import MemoryStorage as JMemoryStorage
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet
from delta_crdt_ex_tpu_torch.runtime.storage import MemoryStorage
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport

TOP = 1 << 63


def _pkg(pkg):
    if pkg == "jax":
        return jdc, JTransport, JClock, JFleet, {"log_shipping": False}
    return t_api, TTransport, TClock, Fleet, {"device": "cpu", "log_shipping": False}


def wal_fleet_script(pkg: str, tmp, store, seed: int = 0, n: int = 4):
    """Seeded adds and removes on ``n`` senders, each pushing to its
    WAL-backed fleet member, the fleet draining (``test_fleet.py``'s
    parity script with per-member WALs and a compaction every 6
    records). Then every member crashes and recovers as a solo replica.
    Returns the pre-crash and recovered canonical bytes, reads, seqs and
    node ids, and the members' segment files."""
    dc, T, C, F, extra = _pkg(pkg)
    transport, clock = T(), C()
    mk = lambda name, node, **kw: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=transport, clock=clock, capacity=64, tree_depth=6,
        name=name, node_id=node, sync_timeout=1e9, store=store, **extra, **kw,
    )
    wal = lambda i: {"wal_dir": str(tmp / f"m{i}"), "fsync_mode": "none", "compact_every": 6}
    senders = [mk(f"s{i}", (TOP if i % 2 else 0) + 500 + i) for i in range(n)]
    members = [mk(f"f{i}", 1000 + i, **wal(i)) for i in range(n)]
    fleet = F(members)
    for s, r in zip(senders, members):
        s.set_neighbours([r])
    rng = np.random.default_rng(seed)
    for _round in range(4):
        for _ in range(int(rng.integers(4, 12))):
            i = int(rng.integers(0, n))
            ki = int(rng.integers(0, 24))
            if rng.random() < 0.7:
                senders[i].mutate("add", [ki, int(rng.integers(0, 100))])
            else:
                senders[i].mutate("remove", [ki])
        for s in senders:
            s.sync_to_all()
        fleet.drain()
        for s in senders:
            transport.drain(s.addr)
    dispatches = fleet.stats()["dispatches"]
    pre = [(r.canonical_state_bytes(), r.read(), r._seq, r.node_id) for r in members]
    segs = {
        os.path.relpath(p, tmp): open(p, "rb").read()
        for p in sorted(glob.glob(str(tmp / "m*" / "replica_*" / "*.wal")))
    }
    for r in members + senders:
        r.crash()
    post = []
    for i in range(n):
        reborn = dc.start_link(dc.AWLWWMap, threaded=False, transport=T(), clock=C(), capacity=64,
                               tree_depth=6, name=f"f{i}", store=store, **extra, **wal(i))
        post.append((reborn.canonical_state_bytes(), reborn.read(), reborn._seq, reborn.node_id))
        reborn.crash()
    return pre, post, segs, dispatches


@pytest.mark.parametrize("store", [None, "hash"])
def test_wal_fleet_members_recover_bit_equal_to_jax(tmp_path, store):
    j_pre, j_post, j_segs, j_disp = wal_fleet_script("jax", tmp_path / "j", store)
    t_pre, t_post, t_segs, t_disp = wal_fleet_script("torch", tmp_path / "t", store)
    assert t_disp == j_disp and t_disp >= 1, "the fleet must have batched"
    assert t_pre == j_pre
    assert t_post == t_pre, "a recovered member differs from its pre-crash state"
    assert j_post == j_pre
    assert sorted(t_segs) == sorted(j_segs) and t_segs
    for name in j_segs:
        assert t_segs[name] == j_segs[name], name


def _duties_cadence(pkg: str) -> list:
    """Interval-mode members under ``run_duties(now=...)`` at fixed
    times: which calls wrote a checkpoint, per member."""
    dc, T, C, F, extra = _pkg(pkg)
    store_cls = JMemoryStorage if pkg == "jax" else MemoryStorage
    store_cls.clear()
    t = T()
    reps = [
        dc.start_link(dc.AWLWWMap, threaded=False, transport=t, clock=C(), capacity=64, tree_depth=6,
                      name=f"d{i}", storage_module=store_cls(), storage_mode="interval",
                      checkpoint_interval=1.0 + i, **extra)
        for i in range(2)
    ]
    fleet = F(reps)
    seen = []
    try:
        for step, now in enumerate([100.0, 100.5, 101.0, 101.2, 102.0, 102.5, 103.1, 104.0]):
            for r in reps:
                r.mutate("add", [f"k{step}", step])
            fleet.run_duties(now=now)
            seen.append([None if (s := store_cls().read(r.name)) is None else s.sequence_number for r in reps])
    finally:
        for r in reps:
            r.crash()
        store_cls.clear()
    return seen


def test_run_duties_checkpoints_on_the_jax_cadence():
    j = _duties_cadence("jax")
    t = _duties_cadence("torch")
    assert t == j
    assert t[0] == [None, None], "first sight schedules one interval out"
    assert t[-1][0] is not None and t[-1][1] is not None


def test_crashed_member_recovers_solo_and_rejoins_a_fleet(tmp_path):
    transport, clock = TTransport(), TClock()
    mk = lambda name, **kw: t_api.start_link(
        t_api.AWLWWMap, threaded=False, transport=transport, clock=clock, capacity=64, tree_depth=6,
        name=name, sync_timeout=1e9, device="cpu", **kw,
    )
    wal = lambda i: {"wal_dir": str(tmp_path / f"m{i}"), "fsync_mode": "none"}
    senders = [mk(f"rs{i}") for i in range(2)]
    fleet = Fleet([mk(f"rf{i}", **wal(i)) for i in range(2)])
    made = list(senders) + list(fleet.replicas)
    try:
        for s, r in zip(senders, fleet.replicas):
            s.set_neighbours([r])
            s.mutate_batch("add", [[f"{s.name}-{k}", k] for k in range(6)])
            s.sync_to_all()
        fleet.drain()
        victim = fleet.replicas[0]
        want, node_id = victim.read(), victim.node_id
        assert len(want) == 6
        victim.crash()
        reborn = mk("rf0", **wal(0))
        made.append(reborn)
        assert reborn.read() == want and reborn.node_id == node_id
        fleet2 = Fleet([reborn, mk("rf9")])
        made.append(fleet2.replicas[1])
        senders[0].set_neighbours([reborn])
        senders[0].mutate("add", ["late", 1])
        for _ in range(3):
            senders[0].sync_to_all()
            fleet2.drain()
            fleet2.sync_tick()
            transport.pump()
        assert reborn.read() == {**want, "late": 1}
        assert reborn.stats()["fleet"]["dispatches"] + reborn.stats()["fleet"]["fallbacks"] >= 1
    finally:
        for r in made:
            r.crash()
