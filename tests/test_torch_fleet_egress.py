"""The batched sync tick of the port's fleet (``Fleet.sync_tick``) against
the per-member loop and against the JAX fleet, modelled on
``tests/test_fleet_egress.py``: the batched tree build and its lane
view against the solo ``_LazyLevels``, the batched extractions (with
the hash store's per-member tier trim) lane for lane, the receivers'
streams — eager-delta pushes, full-row pushes, walk openers — equal to
the solo loop's and to the JAX fleet's, the solo fallbacks of a ragged
bucket and of a one-member tick, and the own-counter cache dropped on a
fleet commit. Everything on the CPU, exact equality.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.runtime import transition as j_tr
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.fleet import Fleet as JFleet
from delta_crdt_ex_tpu.runtime.replica import _LazyLevels as JLazyLevels
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.ops.binned import _i64, tree_from_leaves
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, transition as t_tr
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet, _lane_slice
from delta_crdt_ex_tpu_torch.runtime.replica import _LaneLevels, _LazyLevels, _StackedLevels
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from tests.test_torch_fleet import assert_same, columns


def _mk(transport, store=None, pkg="torch", **kw):
    kw.setdefault("capacity", 256)
    kw.setdefault("tree_depth", 4)
    kw.setdefault("sync_timeout", 1e9)  # walk slots clear by hand, never by the clock
    if pkg == "jax":
        return jdc.start_link(jdc.AWLWWMap, threaded=False, transport=transport, clock=JClock(), store=store, **kw)
    return t_api.start_link(t_api.AWLWWMap, threaded=False, transport=transport, clock=TClock(), store=store,
                            device="cpu", **kw)


def _norm(msg):
    """Address-free form of one outbound sync message, dtypes included,
    for either package's message classes."""
    t = type(msg).__name__
    if t == "EntriesMsg":
        return (
            "entries",
            np.asarray(msg.buckets).tolist(),
            {c: (np.asarray(v).dtype.str, np.asarray(v).tolist()) for c, v in sorted(msg.arrays.items())},
            sorted(map(repr, msg.payloads.items())),
        )
    if t == "DiffMsg":
        return ("diff", msg.level, np.asarray(msg.idx).tolist(),
                [(np.asarray(b).dtype.str, np.asarray(b).tolist()) for b in msg.blocks], msg.seq)
    return (t,)


# ---------------------------------------------------------------------------
# the batched forms, lane for lane


def test_stacked_levels_lane_view_matches_lazy_levels():
    rng = np.random.default_rng(8)
    leaves = rng.integers(0, 2**32, size=(3, 16), dtype=np.uint32)
    stacked = _StackedLevels(t_tr.fleet_tree_from_leaves(torch.from_numpy(leaves.astype(np.int64))))
    stacked.prefetch(2)
    for lane in range(3):
        solo = _LazyLevels(tree_from_leaves(torch.from_numpy(leaves[lane].astype(np.int64))))
        want = JLazyLevels(j_tr.binned_ops.tree_from_leaves(jnp.asarray(leaves[lane])))
        view = _LaneLevels(stacked, lane)
        assert len(view) == len(solo) == len(want)
        for j in range(len(solo)):
            assert view[j].dtype == solo[j].dtype == np.uint32
            assert np.array_equal(view[j], solo[j]) and np.array_equal(view[j], np.asarray(want[j]))


@pytest.mark.parametrize("store", [None, "hash"])
def test_fleet_extraction_lane_parity(store):
    """Each lane of the batched interval and full-row extractions, cut
    to the member's own tier by ``_lane_slice``, is the member's solo
    extraction and the JAX member's, column for column."""
    n, u = 4, 16
    tt, jt = TTransport(), JTransport()
    reps = [_mk(tt, store, name=f"x{i}", node_id=(1 << 63) + 50 + i) for i in range(n)]
    jreps = [_mk(jt, store, "jax", name=f"x{i}", node_id=(1 << 63) + 50 + i) for i in range(n)]
    for i in range(n):
        for j in range(1 + 3 * i):  # ragged content: distinct dense tiers
            reps[i].mutate("add", [i * 100 + j, j])
            jreps[i].mutate("add", [i * 100 + j, j])
    stacked = t_tr.stack_states([r.state for r in reps])
    rows = np.full((n, u), -1, np.int32)
    lo = np.zeros((n, u), np.uint32)
    for i, r in enumerate(reps):
        pend = np.nonzero(r.state.ctx_max[:, r.self_slot].numpy())[0][:u]
        rows[i, : len(pend)] = pend
        lo[i, : len(pend) // 2] = 1
    put = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    slots = put([r.self_slot for r in reps])
    gids = put([_i64(r.node_id) for r in reps])
    model = reps[0].model
    for kind in ("delta", "rows"):
        if kind == "delta":
            sl, tiers = model.fleet_extract_own_delta(stacked, put(rows), slots, gids, put(lo))
        else:
            sl, tiers = model.fleet_extract_rows(stacked, put(rows))
        assert (tiers is None) == (store is None)
        host = type(sl)(*(c.numpy() for c in sl))
        for i, (r, jr) in enumerate(zip(reps, jreps)):
            lane = _lane_slice(host, i, rows[i], None if tiers is None else tiers[i])
            if kind == "delta":
                solo = r.model.extract_own_delta(r.state, put(rows[i]), r.self_slot, gids[i], put(lo[i]))
                want = jr.model.extract_own_delta(jr.state, jnp.asarray(rows[i]), jnp.int32(jr.self_slot),
                                                  jnp.uint64(jr.node_id), jnp.asarray(lo[i]))
            else:
                solo = r.model.extract_rows(r.state, put(rows[i]))
                want = jr.model.extract_rows(jr.state, jnp.asarray(rows[i]))
            for c in type(want)._fields:
                assert_same(getattr(lane, c), getattr(want, c), (store, kind, i, c))
                assert np.array_equal(np.asarray(getattr(lane, c)), getattr(solo, c).numpy()), (store, kind, i, c)


# ---------------------------------------------------------------------------
# the sync tick: fleet == solo loop == JAX fleet


def egress_script(pkg: str, store, n: int = 4):
    """``test_fleet_egress.py``'s one-directional egress: each member
    pushes to its own receiver; three rounds of adds, and removes in the
    second. Returns the receivers' normalised streams (fleet and solo
    twins), the cursors, and the egress stats."""
    transport = JTransport() if pkg == "jax" else TTransport()
    mk = lambda name, node: _mk(transport, store, pkg, name=name, node_id=node)
    fm = [mk(f"ef{i}", 100 + i) for i in range(n)]
    sm = [mk(f"eo{i}", 100 + i) for i in range(n)]
    fr = [mk(f"efr{i}", 900 + i) for i in range(n)]
    orr = [mk(f"eor{i}", 900 + i) for i in range(n)]
    for i in range(n):
        fm[i].set_neighbours([fr[i]])
        sm[i].set_neighbours([orr[i]])
    fleet = (JFleet if pkg == "jax" else Fleet)(fm)
    f_streams, o_streams = [], []
    for rnd in range(3):
        for i in range(n):
            for j in range(2 + i):
                k = rnd * 1000 + i * 10 + j
                fm[i].mutate("add", [k, k])
                sm[i].mutate("add", [k, k])
            if rnd == 1 and i % 2 == 0:
                fm[i].mutate("remove", [rnd * 1000 + i * 10])
                sm[i].mutate("remove", [rnd * 1000 + i * 10])
        fleet.sync_tick()
        for r in sm:
            r.sync_to_all()
        for i in range(n):
            f_streams.append([_norm(m) for m in transport.drain(fr[i].addr)])
            o_streams.append([_norm(m) for m in transport.drain(orr[i].addr)])
            for r in (fm[i], sm[i]):  # every round opens a walk
                r._outstanding.clear()
                getattr(r, "_sync_open_seq", {}).clear()
    cursors = [([c.tolist() for c in r._push_cursor.values()], list(r._rm_cursor.values())) for r in fm]
    solo_cursors = [([c.tolist() for c in r._push_cursor.values()], list(r._rm_cursor.values())) for r in sm]
    return f_streams, o_streams, cursors, solo_cursors, fleet.stats()["egress"]


@pytest.mark.parametrize("store", [None, "hash"])
def test_egress_streams_match_solo_loop_and_jax_fleet(store):
    f, o, cur, solo_cur, eg = egress_script("torch", store)
    jf, _jo, jcur, _jsolo, jeg = egress_script("jax", store)
    assert all(f) and f == o and cur == solo_cur
    assert f == jf and cur == jcur
    assert eg["ticks"] == 3 and eg["dispatches"] >= 1 and eg["batched_jobs"] >= 1 and eg["trees_batched"] >= 4
    for k in ("dispatches", "batched_jobs", "solo_jobs", "solo_members", "bucket_occupancy_hist", "trees_batched"):
        assert eg[k] == jeg[k], k


@pytest.mark.parametrize("store", [None, "hash"])
def test_egress_randomized_gossip_parity(store):
    """Bidirectional: receivers handle everything (walk replies, repairs,
    acks), members take the back-traffic through ``fleet.tick()``; the
    fleet members end equal to their solo twins, streams equal."""
    rng = np.random.default_rng(1234 if store is None else 4321)
    transport = TTransport()
    mk = lambda name, node: _mk(transport, store, name=name, node_id=node)
    fm = [mk(f"rf{i}", 100 + i) for i in range(3)]
    sm = [mk(f"ro{i}", 100 + i) for i in range(3)]
    fr = [mk(f"rfr{i}", 900 + i) for i in range(3)]
    orr = [mk(f"ror{i}", 900 + i) for i in range(3)]
    for i in range(3):
        fm[i].set_neighbours([fr[i]])
        sm[i].set_neighbours([orr[i]])
    fleet = Fleet(fm)
    f_streams, o_streams = [[] for _ in range(3)], [[] for _ in range(3)]
    for _rnd in range(5):
        for i in range(3):
            for _ in range(int(rng.integers(0, 4))):
                k, v = int(rng.integers(0, 40)), int(rng.integers(0, 1000))
                fm[i].mutate("add", [k, v])
                sm[i].mutate("add", [k, v])
            if rng.random() < 0.3:
                k = int(rng.integers(0, 40))
                fm[i].mutate("remove", [k])
                sm[i].mutate("remove", [k])
        fleet.sync_tick()
        for r in sm:
            r.sync_to_all()
        for _ in range(4):
            moved = 0
            for i in range(3):
                for recv, streams in ((fr[i], f_streams), (orr[i], o_streams)):
                    for m in transport.drain(recv.addr):
                        streams[i].append(_norm(m))
                        recv.handle(m)
                        moved += 1
            moved += fleet.tick()
            for r in sm:
                moved += r.process_pending()
            if not moved:
                break
    assert f_streams == o_streams
    for i in range(3):
        assert fm[i]._seq == sm[i]._seq and fm[i].read() == sm[i].read()
        assert fm[i].canonical_state_bytes() == sm[i].canonical_state_bytes()
        assert len(fm[i]._outstanding) == len(sm[i]._outstanding)
        for a, b in ((fm[i], sm[i]), (fr[i], orr[i])):
            ca, cb = columns(a.state), columns(b.state)
            assert all(np.array_equal(ca[c], cb[c]) for c in ca)


def test_ragged_bucket_falls_back_to_solo():
    """Members of different tree depths share no bucket: each extracts
    solo, and the streams are still the per-member loop's."""
    t = TTransport()
    fa, fb = _mk(t, name="rg_f0", node_id=100), _mk(t, name="rg_f1", node_id=101, tree_depth=5)
    oa, ob = _mk(t, name="rg_o0", node_id=100), _mk(t, name="rg_o1", node_id=101, tree_depth=5)
    ra, rb = _mk(t, name="rg_ra", node_id=900), _mk(t, name="rg_rb", node_id=901, tree_depth=5)
    sa, sb = _mk(t, name="rg_sa", node_id=900), _mk(t, name="rg_sb", node_id=901, tree_depth=5)
    for src, dst in ((fa, ra), (fb, rb), (oa, sa), (ob, sb)):
        src.set_neighbours([dst])
    fleet = Fleet([fa, fb])
    for rep in (fa, fb, oa, ob):
        rep.mutate("add", [1, 1])
        rep.mutate("add", [2, 2])
    fleet.sync_tick()
    oa.sync_to_all()
    ob.sync_to_all()
    for recv, srecv in ((ra, sa), (rb, sb)):
        am, bm = t.drain(recv.addr), t.drain(srecv.addr)
        assert len(am) == len(bm) > 0
        assert [_norm(m) for m in am] == [_norm(m) for m in bm]
    eg = fleet.stats()["egress"]
    assert eg["solo_jobs"] >= 2 and eg["dispatches"] == 0 and eg["trees_batched"] == 0


def test_single_member_tick_uses_solo_path():
    t = TTransport()
    f, r = _mk(t, name="solo_f", node_id=100), _mk(t, name="solo_r", node_id=900)
    f.set_neighbours([r])
    fleet = Fleet([f])
    f.mutate("add", [1, 1])
    fleet.sync_tick()
    eg = fleet.stats()["egress"]
    assert eg["solo_members"] == 1 and eg["dispatches"] == 0
    kinds = [type(m).__name__ for m in t.drain(r.addr)]
    assert "EntriesMsg" in kinds and "DiffMsg" in kinds


def test_own_ctr_cache_invalidated_on_fleet_commit():
    """A batched fleet commit drops the member's ``_own_ctr_cache``: the
    adopted lane may carry own counters the cache predates."""
    t = TTransport()
    senders = [_mk(t, name=f"occ_s{i}", node_id=10 + i) for i in range(2)]
    members = [_mk(t, name=f"occ_f{i}", node_id=100 + i) for i in range(2)]
    for s, m in zip(senders, members):
        s.set_neighbours([m])
    fleet = Fleet(members)
    fleet.sync_tick()  # builds every member's cursor source, batched
    assert fleet.stats()["transfers"]["fleet.own_ctr_columns"]["count"] >= 1
    for m in members:
        assert m._own_ctr_cache is not None
    for i, s in enumerate(senders):
        s.mutate("add", [i, i])
        s.sync_to_all()
    for m in members:
        kept = [x for x in t.drain(m.addr) if isinstance(x, t_sync.EntriesMsg)]
        assert kept
        for x in kept:
            t.send(m.addr, x)
    fleet.tick()
    st = fleet.stats()
    assert st["dispatches"] >= 1 and st["fallbacks"]["singleton"] == 0
    for m in members:
        assert m._fleet_dispatches >= 1 and m._own_ctr_cache is None
