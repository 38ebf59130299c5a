"""Batched replica fleets, PyTorch port against the JAX package: the
lane-axis ops and ``runtime/transition.py``'s fleet forms lane for lane
against ``jax.vmap`` of the JAX op (ragged rows, padding lanes, top-bit
keys and gids), ``stack_entry_slices``, and an 8-member port fleet
against an 8-member JAX fleet on one seeded script (canonical state
bytes, seqs, the walk-reply streams and the ``stats()`` counters),
plus the fallback paths — growth escape, gap partition and repair,
stale version — against solo twins, as ``tests/test_fleet.py`` holds
the JAX fleet, and ``start_fleet`` end to end. Exact equality
throughout; everything runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.models.binned_map import (
    combine_entry_arrays as j_combine,
    stack_entry_slices as j_stack_entry_slices,
)
from delta_crdt_ex_tpu.ops import binned as j_binned
from delta_crdt_ex_tpu.runtime import transition as j_tr
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.fleet import Fleet as JFleet
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.models import binned as t_binned_store, hash_store as t_hash_store
from delta_crdt_ex_tpu_torch.models.binned_map import stack_entry_slices
from delta_crdt_ex_tpu_torch.ops.binned import wire_from_host
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, telemetry as t_telemetry, transition as t_tr
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from tests.kernel_harness import BinnedKernelMap, HashKernelMap
from tests.test_ingest_coalesce import keys_for_buckets

L = 16
TOP = 1 << 63


# ---------------------------------------------------------------------------
# JAX ↔ port conversion and exact comparison


def to_port_state(js):
    """The port store holding a JAX store's (single or stacked) bits."""
    cols = {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js) if f.name != "probe_window"}
    if hasattr(js, "probe_window"):
        return t_hash_store.from_numpy(cols, "cpu", probe_window=js.probe_window)
    return t_binned_store.from_numpy(cols, "cpu")


def assert_same(t, j, what=""):
    """A port tensor (or host array) equals a JAX array exactly: the
    same shape, and the same bits (uint64) or values (everything else)."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if b.dtype == np.uint64:
        a = np.ascontiguousarray(a).view(np.uint64)
    else:
        a, b = a.astype(np.int64), b.astype(np.int64)
    assert np.array_equal(a, b), what


def assert_tree_same(t, j, what=""):
    """Every field of a port result (NamedTuple or store) equals the JAX
    result's field of the same name."""
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            if f.name == "probe_window":
                assert t.probe_window == j.probe_window
            else:
                assert_same(getattr(t, f.name), getattr(j, f.name), (what, f.name))
        return
    for name in j._fields:
        jv, tv = getattr(j, name), getattr(t, name)
        if dataclasses.is_dataclass(jv) or isinstance(jv, tuple):
            assert_tree_same(tv, jv, (what, name))
        else:
            assert_same(tv, jv, (what, name))


# ---------------------------------------------------------------------------
# lane parity of every fleet form


def make_lanes(n, store="binned", seed=0, rows_per=None):
    """n (target state, incoming slice) pairs, JAX side: top-bit writer
    gids on every other lane, top-bit keys, overlapping keys so the
    merges insert and kill. Sources are binned stores, so every slice
    has the same entry-lane tier whatever the target store."""
    rng = np.random.default_rng(seed)
    kmap = HashKernelMap if store == "hash" else BinnedKernelMap
    states, slices = [], []
    for i in range(n):
        tgt = kmap(gid=(TOP if i % 2 else 0) + 100 + i, capacity=128, rcap=8, num_buckets=L)
        src = BinnedKernelMap(gid=TOP + 500 + i, capacity=128, rcap=8, num_buckets=L)
        ks = [int(k) | (TOP if j % 2 else 0) for j, k in enumerate(rng.integers(1, 1 << 40, 9))]
        for ts, k in enumerate(ks, start=1):
            src.add(k, int(rng.integers(0, 100)), ts=ts)
        for ts, k in enumerate(ks[:3], start=20):  # kill-pass prey
            tgt.add(k, 7, ts=ts)
        tgt.add(int(rng.integers(1, 1 << 40)) | TOP, 5, ts=40)  # a dot the slice does not cover
        nrows = rows_per[i] if rows_per else L
        states.append(tgt.state)
        slices.append(j_binned.extract_rows(src.state, jnp.asarray(np.arange(nrows, dtype=np.int32))))
    return states, slices


def _np_slice(jsl):
    return j_binned.RowSlice(**{c: np.asarray(getattr(jsl, c)) for c in j_binned.RowSlice._fields})


@pytest.mark.parametrize("store", ["binned", "hash"])
@pytest.mark.parametrize("rows_per, lanes", [(None, 4), ([16, 4, 8], 4), ([2, 16], 2)])
def test_fleet_merge_rows_lanes_equal_jax_vmap(store, rows_per, lanes):
    """Lane k of the port's batched merge is JAX's vmapped lane k, every
    column and count — ragged rows padded with -1, padding lanes merging
    nothing, top-bit keys and gids — and the inputs stay intact."""
    n = len(rows_per) if rows_per else 3
    states, slices = make_lanes(n, store, seed=len(rows_per or ()) + lanes, rows_per=rows_per)
    j_sl, j_real = j_stack_entry_slices([_np_slice(s) for s in slices], lanes=lanes)
    j_states = j_tr.stack_states(states + [states[0]] * (lanes - n))
    fleet_j = j_tr.jit_fleet_hash_merge_rows if store == "hash" else j_tr.jit_fleet_merge_rows
    want = fleet_j(j_states, j_sl)

    t_sl, t_real = stack_entry_slices([_np_slice(s) for s in slices], lanes=lanes, device="cpu")
    assert t_real == j_real
    assert_tree_same(t_sl, j_sl, "stacked slice")
    t_states = to_port_state(j_states)
    before = {f.name: getattr(t_states, f.name).clone() for f in dataclasses.fields(t_states) if f.name != "probe_window"}
    fleet_t = t_tr.fleet_hash_merge_rows if store == "hash" else t_tr.fleet_merge_rows
    got = fleet_t(t_states, t_sl)
    assert_tree_same(got, want, store)
    assert bool(np.asarray(want.ok).all())
    for name, col in before.items():
        assert torch.equal(getattr(t_states, name), col), name
    # padding lanes: the input state, nothing inserted or killed
    for k in range(n, lanes):
        assert_tree_same(t_tr.index_state(got.state, k), j_tr.index_state(j_states, 0), ("pad lane", k))
        assert int(got.n_inserted[k]) == 0 and int(got.n_killed[k]) == 0


def test_stack_entry_slices_rejects_unequal_lane_tiers():
    _, slices = make_lanes(2, seed=3)
    a = _np_slice(slices[0])
    widened = j_binned.RowSlice(**{
        **a._asdict(),
        **{c: np.concatenate([getattr(a, c)] * 2, axis=1) for c in ("key", "valh", "ts", "node", "ctr", "alive")},
    })
    with pytest.raises(ValueError, match="lane tiers"):
        stack_entry_slices([a, widened], device="cpu")
    with pytest.raises(ValueError, match="lane tiers"):
        j_stack_entry_slices([a, widened])


def test_stack_entry_slices_pads_ragged_writer_tables_as_jax():
    """Combined groups with unequal writer-table widths (and row counts)
    pad to JAX's arrays: zero gids claiming nothing, -1 rows; the port's
    host combine is JAX's ``to_device=False`` combine."""
    from delta_crdt_ex_tpu_torch.models.binned_map import combine_entry_arrays

    _, slices = make_lanes(4, seed=4, rows_per=[16, 4, 8, 2])
    wire = [{c: np.asarray(getattr(s, c)) for c in j_binned.RowSlice._fields} for s in slices]
    groups = [wire[:1], wire[1:4]]  # one sender, then three senders: 2 vs 4 writers
    j_parts = [j_combine(g, to_device=False)[0] for g in groups]
    t_parts = [combine_entry_arrays(g, None)[0] for g in groups]
    for tp, jp in zip(t_parts, j_parts):
        for c in j_binned.RowSlice._fields:
            assert np.asarray(getattr(tp, c)).dtype == np.asarray(getattr(jp, c)).dtype, c
            assert np.array_equal(getattr(tp, c), np.asarray(getattr(jp, c))), c
    assert t_parts[0].ctx_gid.shape != t_parts[1].ctx_gid.shape
    j_sl, j_real = j_stack_entry_slices(j_parts, lanes=4)
    t_sl, t_real = stack_entry_slices(t_parts, lanes=4, device="cpu")
    assert t_real == j_real
    assert_tree_same(t_sl, j_sl)
    gids = wire_from_host({"ctx_gid": t_sl.ctx_gid.numpy()})["ctx_gid"]
    assert (gids[0, t_parts[0].ctx_gid.shape[0]:] == 0).all()


@pytest.mark.parametrize("store", ["binned", "hash"])
def test_fleet_read_and_extract_forms_equal_jax_vmap(store):
    """winner_all, the own-counter columns, the digest trees, and both
    extractions (with the hash store's counting passes) lane for lane."""
    n, lanes, u = 3, 4, 16
    states, _ = make_lanes(n, store, seed=11)
    j_states = j_tr.stack_states(states + [states[0]] * (lanes - n))
    t_states = to_port_state(j_states)
    rng = np.random.default_rng(12)
    rows = np.full((lanes, u), -1, np.int32)
    lo = np.zeros((lanes, u), np.uint32)
    for k in range(n):
        r = rng.permutation(L)[: 4 + 5 * k]
        rows[k, : len(r)] = r
        lo[k, : len(r)] = rng.integers(0, 2, len(r))
    slots = np.zeros(lanes, np.int32)
    gids = np.asarray([np.asarray(s.ctx_gid)[0] for s in states] + [0] * (lanes - n), np.uint64)
    t_rows, t_slots = torch.from_numpy(rows.astype(np.int64)), torch.from_numpy(slots.astype(np.int64))
    t_gids = torch.from_numpy(gids.view(np.int64).copy())
    t_lo = torch.from_numpy(lo.astype(np.int64))

    assert_same(t_tr.fleet_own_ctr_columns(t_states.ctx_max, t_slots),
                j_tr.jit_fleet_own_ctr_columns(j_states.ctx_max, jnp.asarray(slots)))
    for tl, jl in zip(t_tr.fleet_tree_from_leaves(t_states.leaf), j_tr.jit_fleet_tree_from_leaves(j_states.leaf)):
        assert_same(tl, jl)
    if store == "binned":
        assert_tree_same(t_tr.fleet_winner_all(t_states), j_tr.jit_fleet_winner_all(j_states))
        assert_tree_same(t_tr.fleet_compact_rows(t_states), j_tr.jit_fleet_compact_rows(j_states))
        assert_tree_same(t_tr.fleet_extract_rows(t_states, t_rows),
                         j_tr.jit_fleet_extract_rows(j_states, jnp.asarray(rows)))
        assert_tree_same(
            t_tr.fleet_interval_slices(t_states, t_rows, t_slots, t_gids, t_lo),
            j_tr.jit_fleet_interval_slices(j_states, jnp.asarray(rows), jnp.asarray(slots),
                                           jnp.asarray(gids), jnp.asarray(lo)),
        )
        return
    assert_tree_same(t_tr.fleet_hash_winner_all(t_states), j_tr.jit_fleet_hash_winner_all(j_states))
    counts = t_tr.fleet_hash_row_counts(t_states, t_rows)
    assert_same(counts, j_tr.jit_fleet_hash_row_counts(j_states, jnp.asarray(rows)))
    own = t_tr.fleet_hash_own_delta_counts(t_states, t_rows, t_slots, t_lo)
    assert_same(own, j_tr.jit_fleet_hash_own_delta_counts(j_states, jnp.asarray(rows), jnp.asarray(slots),
                                                          jnp.asarray(lo)))
    for width in (4, 8):
        assert_tree_same(t_tr.fleet_hash_extract_rows(t_states, t_rows, width),
                         j_tr.jit_fleet_hash_extract_rows(j_states, jnp.asarray(rows), lanes=width))
        assert_tree_same(
            t_tr.fleet_hash_interval_slices(t_states, t_rows, t_slots, t_gids, t_lo, width),
            j_tr.jit_fleet_hash_interval_slices(j_states, jnp.asarray(rows), jnp.asarray(slots),
                                                jnp.asarray(gids), jnp.asarray(lo), lanes=width),
        )


def test_fleet_row_apply_lanes_equal_jax_vmap():
    n = 3
    states, _ = make_lanes(n, seed=13)
    j_states = j_tr.stack_states(states)
    rng = np.random.default_rng(14)
    u, m = 4, 4
    rows = np.stack([rng.permutation(L)[:u] for _ in range(n)]).astype(np.int32)
    op = rng.integers(0, 3, (n, u, m)).astype(np.int32)  # pad, add, remove
    key = (rng.integers(1, 1 << 40, (n, u, m)).astype(np.uint64) & ~np.uint64(L - 1)) | rows[..., None].astype(np.uint64)
    key[..., 0] |= np.uint64(TOP)
    valh = rng.integers(0, 2**32, (n, u, m)).astype(np.uint32)
    ts = rng.integers(1, 1000, (n, u, m)).astype(np.int64)
    slots = np.zeros(n, np.int32)
    want = j_tr.jit_fleet_row_apply(j_states, *map(jnp.asarray, (slots, rows, op, key, valh, ts)))
    got = t_tr.fleet_row_apply(
        to_port_state(j_states), torch.from_numpy(slots.astype(np.int64)), torch.from_numpy(rows.astype(np.int64)),
        torch.from_numpy(op), torch.from_numpy(key.view(np.int64).copy()), torch.from_numpy(valh.astype(np.int64)),
        torch.from_numpy(ts),
    )
    assert_tree_same(got, want)


def test_stack_and_index_state_copy_lanes():
    states, _ = make_lanes(2, "hash", seed=15)
    ts = [to_port_state(s) for s in states]
    stacked = t_tr.stack_states(ts)
    lane = t_tr.index_state(stacked, 1)
    assert_tree_same(lane, states[1])
    assert lane.key.data_ptr() != stacked.key[1].data_ptr()  # a copy, not a view of the stack
    with pytest.raises(ValueError, match="probe_window"):
        t_tr.stack_states([ts[0], dataclasses.replace(ts[1], probe_window=64)])
    with pytest.raises(NotImplementedError, match="hash-store fleet mutation"):
        t_tr.fleet_hash_row_apply(stacked, None, None, None, None, None, None)


# ---------------------------------------------------------------------------
# the runtime: a port fleet against a JAX fleet, and against solo twins


def _norm_msg(m, addr_map):
    """Address-free form of a walk reply or ack, the two packages'
    message classes alike."""
    sub = lambda v: addr_map.get(v, v)
    t = type(m).__name__
    if t == "AckMsg":
        return (t, sub(m.clear_addr))
    if t == "DiffMsg":
        return (t, sub(m.originator), sub(m.frm), m.level, np.asarray(m.idx).tolist(),
                [np.asarray(b).tolist() for b in m.blocks], m.seq)
    if t == "GetDiffMsg":
        return (t, sub(m.originator), sub(m.frm), np.asarray(m.buckets).tolist())
    return (t,)


def fleet_script(pkg: str, seed: int, store=None, n: int = 8):
    """Seeded gossip into an ``n``-member fleet (``test_fleet.py:249``'s
    script): random adds and removes on ``n`` senders, each pushing to
    its member, the fleet draining, the back-traffic recorded. Returns
    the members' canonical bytes and seqs, the back streams and the
    fleet's counters."""
    jax_side = pkg == "jax"
    dc = jdc if jax_side else t_api
    transport, clock = (JTransport(), JClock()) if jax_side else (TTransport(), TClock())
    extra = {} if jax_side else {"device": "cpu"}
    mk = lambda name, node: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=transport, clock=clock, capacity=64, tree_depth=6,
        name=name, node_id=node, sync_timeout=1e9, store=store, **extra,
    )
    senders = [mk(f"s{i}", (TOP if i % 2 else 0) + 500 + i) for i in range(n)]
    members = [mk(f"f{i}", 1000 + i) for i in range(n)]
    fleet = (JFleet if jax_side else Fleet)(members)
    for s, r in zip(senders, members):
        s.set_neighbours([r])
    addr_map = {r.addr: f"recv{i}" for i, r in enumerate(members)}
    rng = np.random.default_rng(seed)
    back = []
    for _round in range(3):
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
        back.append([[_norm_msg(m, addr_map) for m in transport.drain(s.addr)] for s in senders])
    st = fleet.stats()
    counters = {k: st[k] for k in ("dispatches", "batched_messages", "occupancy_hist", "avg_occupancy",
                                   "ragged_fill_ratio", "fallbacks")}
    return [r.canonical_state_bytes() for r in members], [r._seq for r in members], back, counters


@pytest.mark.parametrize("store", [None, "hash"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fleet_matches_jax_fleet(seed, store):
    j_bytes, j_seqs, j_back, j_counts = fleet_script("jax", seed, store)
    t_bytes, t_seqs, t_back, t_counts = fleet_script("torch", seed, store)
    assert t_seqs == j_seqs
    assert t_bytes == j_bytes
    assert t_back == j_back
    assert t_counts == j_counts
    assert t_counts["dispatches"] >= 1 and max(t_counts["occupancy_hist"]) >= 2


def _port_pairs(transport, clock, n, store=None):
    """n fleet receivers + n solo twins (equal node ids) and n senders."""
    mk = lambda name, node: t_api.start_link(
        t_api.AWLWWMap, threaded=False, transport=transport, clock=clock, capacity=64, tree_depth=6,
        name=name, node_id=node, sync_timeout=1e9, store=store, device="cpu",
    )
    senders = [mk(f"ps{i}", 500 + i) for i in range(n)]
    fleet = Fleet([mk(f"pf{i}", 1000 + i) for i in range(n)])
    solos = [mk(f"po{i}", 1000 + i) for i in range(n)]
    for i, s in enumerate(senders):
        s.set_neighbours([fleet.replicas[i], solos[i]])
    return senders, fleet, solos


def entries_only(transport, addr):
    msgs = [m for m in transport.drain(addr) if isinstance(m, t_sync.EntriesMsg)]
    for m in msgs:
        transport.send(addr, m)


def deliver(transport, fleet, solos):
    for r in list(fleet.replicas) + solos:
        entries_only(transport, r.addr)
    fleet.drain()
    for r in solos:
        r.process_pending()


def columns(state) -> dict:
    """A port store's columns in the JAX dtypes."""
    return (t_hash_store.to_numpy if hasattr(state, "probe_window") else t_binned_store.to_numpy)(state)


def assert_twins(fleet, solos):
    """Each fleet member equals its solo twin: seq, canonical bytes and
    every state column."""
    for rf, rs in zip(fleet.replicas, solos):
        assert rf._seq == rs._seq
        assert rf.canonical_state_bytes() == rs.canonical_state_bytes()
        a, b = columns(rf.state), columns(rs.state)
        for c in a:
            assert np.array_equal(a[c], b[c]), (rf.name, c)


@pytest.mark.parametrize("store, keys0, keys0_buckets, expect", [
    (None, 6, (3, 4), "escape"),  # 4-slot bins overflow: need_fill_grow
    ("hash", 200, (0, 64), "escape"),  # a 256-lane table's windows overflow
    ("hash", 160, (0, 64), "advised"),  # window pressure: grown off the batch path
])
def test_growth_escape_falls_back_solo(store, keys0, keys0_buckets, expect):
    """A member whose store overflows mid-batch escapes to the solo
    growth path while the clean member keeps the batched result
    (``test_fleet.py:366``); a hash member whose fullest window nears
    overflow commits and then grows off the batch path."""
    t, c = TTransport(), TClock()
    senders, fleet, solos = _port_pairs(t, c, 2, store)
    for k in keys_for_buckets(*keys0_buckets, keys0, start=0):
        senders[0].mutate("add", [k, "x"])
    for k in keys_for_buckets(40, 41, 5, start=50_000):
        senders[1].mutate("add", [k, "y"])
    for s in senders:
        s.sync_to_all()
    size0 = fleet.replicas[0].state.capacity
    deliver(t, fleet, solos)
    st = fleet.stats()
    assert st["dispatches"] == 1
    assert st["fallbacks"]["escape"] == (0 if expect == "advised" else 1 if store else 2)
    assert fleet.replicas[0].state.capacity > size0
    assert_twins(fleet, solos)


def test_gap_partitions_and_repairs_like_solo():
    """A lost push gaps one member's group mid-batch; the escape routes
    through the solo gap machinery: the sender gets each receiver's
    GetDiffMsg, and after the repair the twins agree (``test_fleet.py:400``)."""
    t, c = TTransport(), TClock()
    senders, fleet, solos = _port_pairs(t, c, 2)
    k1a, k1b = keys_for_buckets(3, 4, 2)
    senders[0].mutate("add", [k1a, "one"])
    senders[0].sync_to_all()
    for r in list(fleet.replicas) + solos:
        t.drain(r.addr)  # the push is lost everywhere
    senders[0].mutate("add", [k1b, "two"])  # same bucket: the interval gaps
    (k2,) = keys_for_buckets(40, 48, 1)
    senders[1].mutate("add", [k2, "other"])
    for s in senders:
        s.sync_to_all()
    deliver(t, fleet, solos)
    assert fleet.stats()["fallbacks"]["escape"] >= 1
    gets = [m for m in t.drain(senders[0].addr) if isinstance(m, t_sync.GetDiffMsg)]
    assert sorted(m.frm for m in gets) == sorted([fleet.replicas[0].addr, solos[0].addr])
    for m in gets:
        senders[0].handle(m)
    deliver(t, fleet, solos)
    assert fleet.replicas[0].read() == solos[0].read() == {k1a: "one", k1b: "two"}
    assert_twins(fleet, solos)


def test_stale_version_refuses_commit():
    """A member whose state moved between staging and commit refuses the
    batched result and stays untouched (``test_fleet.py:481``)."""
    t, c = TTransport(), TClock()
    senders, fleet, _ = _port_pairs(t, c, 2)
    rep = fleet.replicas[0]
    senders[0].mutate("add", [keys_for_buckets(0, 64, 1)[0], "v"])
    senders[0].sync_to_all()
    msgs = [m for m in t.drain(rep.addr) if isinstance(m, t_sync.EntriesMsg)]
    assert msgs
    prep = rep.fleet_prepare(msgs)
    assert prep is not None
    _sl, offsets, version, geometry = prep
    assert geometry == rep.model.geometry(rep.state)
    rep.mutate("add", [keys_for_buckets(0, 64, 1, start=12345)[0], "w"])
    seq_before = rep._seq
    assert rep.fleet_commit(msgs, offsets, None, 0, lambda: (None, None), 0, 0.0, version) is None
    assert rep._seq == seq_before


def test_fleet_rejects_threaded_members_and_mixed_devices():
    t = TTransport()
    mk = lambda name: t_api.start_link(t_api.AWLWWMap, threaded=False, transport=t, name=name,
                                       capacity=64, tree_depth=4, device="cpu")
    r = mk("thr")
    r.start()
    try:
        with pytest.raises(ValueError, match="threaded=False"):
            Fleet([r])
    finally:
        r.stop()
    with pytest.raises(ValueError, match="at least one"):
        Fleet([])
    r2 = mk("m2")
    Fleet([r2, mk("m3")])
    with pytest.raises(ValueError, match="fleet member"):
        r2.start()
    with pytest.raises(ValueError, match="already belongs"):
        Fleet([r2, mk("m4")])
    a, b = mk("d1"), mk("d2")
    b.device = torch.device("meta")  # a member on another device
    with pytest.raises(ValueError, match="different devices"):
        Fleet([a, b])


def test_start_fleet_threaded_end_to_end():
    """``start_fleet(..., device="cpu", threaded=True)``: mutually
    syncing members converge through the one shared loop
    (``test_fleet.py:532``)."""
    fleet = t_api.start_fleet(3, transport=TTransport(), clock=TClock(), capacity=64, tree_depth=6,
                              sync_interval=0.02, names=["fa", "fb", "fc"], device="cpu")
    try:
        a, b, c = fleet.replicas
        for r in fleet.replicas:
            r.set_neighbours([x for x in fleet.replicas if x is not r])

        def converged(want):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if all(r.read() == want for r in fleet.replicas):
                    return True
                time.sleep(0.02)
            return False

        a.mutate("add", ["k1", 1])
        b.mutate("add", ["k2", 2])
        assert converged({"k1": 1, "k2": 2})
        c.mutate("remove", ["k1"])
        assert converged({"k2": 2})
        assert fleet.stats()["ticks"] >= 1
    finally:
        fleet.stop()
    assert fleet._thread is None


def test_fleet_dispatch_telemetry_and_member_stats():
    t, c = TTransport(), TClock()
    senders, fleet, solos = _port_pairs(t, c, 4)
    events = []
    handler = lambda _e, meas, _m: events.append(meas)
    t_telemetry.attach(t_telemetry.FLEET_DISPATCH, handler)
    try:
        for i, s in enumerate(senders):
            for k in keys_for_buckets(0, 64, 3, start=777 * i):
                s.mutate("add", [k, k])
            s.sync_to_all()
        deliver(t, fleet, solos)
    finally:
        t_telemetry.detach(t_telemetry.FLEET_DISPATCH, handler)
    st = fleet.stats()
    assert st["dispatches"] == 1 and st["occupancy_hist"] == {4: 1} and st["batched_messages"] == 4
    assert st["stack_cache"] == {"hits": 0, "misses": 1}
    for r in fleet.replicas:
        assert r.stats()["fleet"] == {"dispatches": 1, "batched_messages": 1, "fallbacks": 0}
        assert len(r.read()) == 3
    assert len(events) == 1 and events[0]["replicas"] == 4 and events[0]["lanes"] == 4
    assert_twins(fleet, solos)
