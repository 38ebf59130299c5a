"""The mesh-sharded fleet, PyTorch port against itself and against the
JAX package (``tests/test_mesh_fleet.py``'s cases):

- every ``mesh_fleet_*`` twin is bit-equal to its ``fleet_*`` form, lane
  for lane, at shards {1, 2, 4, 8} on both stores, and to JAX's
  ``jit_mesh_fleet_*`` at 8 shards on seeded inputs (top-bit keys and
  gids);
- a port mesh fleet gossiping among its members is bit-equal to the JAX
  mesh fleet (shards 2 and 8, both stores) and to its own vmap fleet on
  canonical state bytes, WAL segment bytes, seq and in-flight sync
  slots; off-mesh sinks see the JAX mesh fleet's streams and pickled
  wire bytes; the audited transfer counts are pinned next to JAX's;
- mixed on- and off-mesh destinations in one tick, padding lanes at
  (members, shards) ∈ {(3, 8), (5, 4), (2, 2)}, the resident sharded
  stack and its invalidation on a fallback, the padded exchange
  (``mesh_narrow=False``), mesh construction and validation, and a
  rotation that never lets a receiver's write reach the sender.

The port's meshes list the one CPU device once per shard; the JAX side
runs on the 8 virtual CPU devices the conftest forces.
"""

from __future__ import annotations

import pickle

import jax
import numpy as np
import pytest
import torch

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.runtime import transition as j_tr
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.fleet import Fleet as JFleet
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu.utils import transfers as j_transfers
from delta_crdt_ex_tpu.utils.devices import fleet_mesh as j_fleet_mesh
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.models.binned_map import stack_entry_slices
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, transition as t_tr
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from delta_crdt_ex_tpu_torch.utils import devices, transfers as t_transfers
from delta_crdt_ex_tpu_torch.utils.devices import Mesh, Sharded, fleet_mesh, mesh_shard_count
from tests.test_ingest_coalesce import _wal_segment_bytes, keys_for_buckets
from tests.test_torch_fleet import _np_slice, make_lanes, to_port_state

TOP = 1 << 63
L = 16


def cpu_mesh(shards: int) -> Mesh:
    return fleet_mesh(shards, devices=["cpu"] * shards)


def gathered(x):
    """A port result with every sharded leaf gathered (a tree of
    tensors on the CPU)."""
    return t_transfers.gathered(x)


def assert_port_equal(a, b, what=""):
    """Two port trees (tensors, NamedTuples, stores, lists) hold equal
    bits."""
    a, b = gathered(a), gathered(b)
    la, lb = devices._tensor_leaves(a), devices._tensor_leaves(b)
    assert len(la) == len(lb) > 0, what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), what


def jax_like(x):
    """A port mesh result as the tree ``assert_tree_same`` reads."""
    return gathered(x)


# ---------------------------------------------------------------------------
# twin parity


def _extract_inputs(states, n, lanes, seed):
    rng = np.random.default_rng(seed)
    u = 16
    rows = np.full((lanes, u), -1, np.int32)
    lo = np.zeros((lanes, u), np.uint32)
    for k in range(n):
        r = rng.permutation(L)[: 4 + (3 * k) % 12]
        rows[k, : len(r)] = r
        lo[k, : len(r)] = rng.integers(0, 2, len(r))
    slots = np.zeros(lanes, np.int32)
    gids = np.asarray([np.asarray(s.ctx_gid)[0] for s in states] + [0] * (lanes - n), np.uint64)
    return rows, lo, slots, gids


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint64:
        return torch.from_numpy(a.view(np.int64).copy())
    return torch.from_numpy(a.astype(np.int64))


def row_apply_batch(lanes, seed, u=4, m=4, as_numpy=False):
    """A bucket-grouped mutation batch a lane (pad, add and remove ops,
    top-bit keys), as port tensors or as the JAX dtypes' numpy."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.permutation(L)[:u] for _ in range(lanes)]).astype(np.int32)
    op = rng.integers(0, 3, (lanes, u, m)).astype(np.int32)
    key = (rng.integers(1, 1 << 40, (lanes, u, m)).astype(np.uint64) & ~np.uint64(L - 1)) | rows[..., None].astype(np.uint64)
    key[..., 0] |= np.uint64(TOP)
    valh = rng.integers(0, 2**32, (lanes, u, m)).astype(np.uint32)
    ts = rng.integers(1, 1000, (lanes, u, m)).astype(np.int64)
    slots = np.zeros(lanes, np.int32)
    host = (slots, rows, op, key, valh, ts)
    if as_numpy:
        return host
    return (_t(slots), _t(rows), torch.from_numpy(op), _t(key), _t(valh), torch.from_numpy(ts))


@pytest.mark.parametrize("store", ["binned", "hash"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_mesh_twins_bit_equal_to_fleet_forms(store, shards):
    """Every twin, lane for lane, against its fleet form on the same
    stacked inputs: the merge, both extractions (with the hash store's
    counting passes and bucket-wide tier), the digest trees, the
    own-counter columns and the binned row apply. The inputs stay
    intact."""
    n, lanes = 6, 8
    states, slices = make_lanes(n, store, seed=shards, rows_per=[16, 4, 8, 2, 16, 12])
    j_states = j_tr.stack_states(states + [states[0]] * (lanes - n))
    t_states = to_port_state(j_states)
    sl, _ = stack_entry_slices([_np_slice(s) for s in slices], lanes=lanes, device="cpu")
    mesh = cpu_mesh(shards)
    model = t_api._resolve_store(t_api.AWLWWMap, store)
    before = [t.clone() for t in devices._tensor_leaves(t_states)]

    assert_port_equal(model.mesh_fleet_merge_rows(mesh, t_states, sl), model.fleet_merge_rows(t_states, sl), "merge")
    rows, lo, slots, gids = _extract_inputs(states, n, lanes, seed=shards)
    got, got_tiers = model.mesh_fleet_extract_rows(mesh, t_states, _t(rows))
    want, want_tiers = model.fleet_extract_rows(t_states, _t(rows))
    assert got_tiers == want_tiers
    assert_port_equal(got, want, "extract_rows")
    got, got_tiers = model.mesh_fleet_extract_own_delta(mesh, t_states, _t(rows), _t(slots), _t(gids), _t(lo))
    want, want_tiers = model.fleet_extract_own_delta(t_states, _t(rows), _t(slots), _t(gids), _t(lo))
    assert got_tiers == want_tiers
    assert_port_equal(got, want, "own delta")
    assert_port_equal(
        t_tr.mesh_fleet_tree_from_leaves(mesh, t_states.leaf), t_tr.fleet_tree_from_leaves(t_states.leaf), "tree"
    )
    assert_port_equal(
        t_tr.mesh_fleet_own_ctr_columns(mesh, t_states.ctx_max, _t(slots)),
        t_tr.fleet_own_ctr_columns(t_states.ctx_max, _t(slots)),
        "own ctr",
    )
    if store == "hash":
        assert_port_equal(t_tr.mesh_fleet_hash_row_counts(mesh, t_states, _t(rows)),
                          t_tr.fleet_hash_row_counts(t_states, _t(rows)), "row counts")
        assert_port_equal(t_tr.mesh_fleet_hash_own_delta_counts(mesh, t_states, _t(rows), _t(slots), _t(lo)),
                          t_tr.fleet_hash_own_delta_counts(t_states, _t(rows), _t(slots), _t(lo)), "own delta counts")
    else:
        batch = row_apply_batch(lanes, seed=shards)
        assert_port_equal(t_tr.mesh_fleet_row_apply(mesh, t_states, *batch),
                          t_tr.fleet_row_apply(t_states, *batch), "row_apply")
    for x, y in zip(devices._tensor_leaves(t_states), before):
        assert torch.equal(x, y)
    # a sharded input is used as it is, and a sharded result feeds the
    # next twin: the resident form
    placed = t_tr.replica_sharding(mesh).put(t_states)
    assert isinstance(placed, Sharded) and len(placed.blocks) == shards
    res = model.mesh_fleet_merge_rows(mesh, placed, sl)
    assert isinstance(res.state, Sharded)
    assert_port_equal(res, model.fleet_merge_rows(t_states, sl), "merge from placed")


def test_mesh_plane_rotate_moves_lanes_intact_and_never_aliases():
    """A rotation by any shift (0 included, on a mesh that repeats one
    device) moves every lane block intact — JAX's rotation of the same
    buffers — and hands the receiver a buffer of its own: writing into
    what arrived leaves the sender's lanes bit-unchanged."""
    mesh = cpu_mesh(4)
    rng = np.random.default_rng(11)
    bufs = {
        "a": rng.integers(0, 2**31, size=(4, 2, 3)).astype(np.int64),
        "b": rng.integers(0, 2**32, size=(4, 2), dtype=np.uint64),
    }
    jm = j_fleet_mesh(4)
    for shift in (0, 1, 2, 3):
        sent = {c: t_tr.replica_sharding(mesh).put(_t(v) if c == "b" else torch.from_numpy(v)) for c, v in bufs.items()}
        keep = {c: [b.clone() for b in s.blocks] for c, s in sent.items()}
        out = t_tr.mesh_plane_rotate(mesh, shift, sent)
        want = jax.device_get(j_tr.jit_mesh_plane_rotate(jm, shift, jax.device_put(bufs, j_tr.replica_sharding(jm))))
        for c in bufs:
            got = out[c].gather().numpy()
            if c == "b":
                got = got.view(np.uint64)
            assert np.array_equal(got, np.roll(bufs[c], shift, axis=0)), (c, shift)
            assert np.array_equal(got, want[c]), (c, shift)
            for blk in out[c].blocks:
                blk.fill_(-7)  # the receiver writes into what it got
            for blk, k in zip(sent[c].blocks, keep[c]):
                assert torch.equal(blk, k), (c, shift)


# ---------------------------------------------------------------------------
# runtime parity


def _pkg(pkg):
    if pkg == "jax":
        return jdc, JTransport, JClock, JFleet, j_fleet_mesh, j_transfers, {"log_shipping": False}
    return t_api, TTransport, TClock, Fleet, cpu_mesh, t_transfers, {"device": "cpu", "log_shipping": False}


def _drive(fleets, members, rounds=1):
    for _ in range(rounds):
        for f in fleets:
            f.sync_tick()
        for f in fleets:
            f.drain()
        for r in members:
            r._outstanding.clear()
            r._sync_open_seq.clear()


def _norm(msg):
    """Address-free canonical form of one outbound sync message, for
    either package's classes."""
    kind = type(msg).__name__
    if kind == "EntriesMsg":
        return (
            "entries",
            np.asarray(msg.buckets).tolist(),
            {c: (np.asarray(v).dtype.str, np.asarray(v).tolist()) for c, v in msg.arrays.items()},
            sorted(map(repr, msg.payloads.items())),
        )
    if kind == "DiffMsg":
        return ("diff", msg.level, np.asarray(msg.idx).tolist(), [np.asarray(b).tolist() for b in msg.blocks],
                msg.seq, msg.log_horizon)
    return (kind,)


def _wire_bytes(msg):
    """Pickled size of the address-free body (``tests/test_mesh_fleet.py``)."""
    kind = type(msg).__name__
    if kind == "EntriesMsg":
        return len(pickle.dumps(
            (np.asarray(msg.buckets), {c: np.asarray(v) for c, v in msg.arrays.items()}, msg.payloads),
            protocol=4,
        ))
    if kind == "DiffMsg":
        return len(pickle.dumps((msg.level, msg.idx, msg.blocks, msg.seq, msg.log_horizon), protocol=4))
    return 0


SITES = ("fleet.mesh_place", "meshplane.ship_dense", "meshplane.ship_padded", "meshplane.deliver_padded",
         "replica.wal_entries", "fleet.dispatch_result", "fleet.egress_extract")


def intra_script(pkg, store, shards, tmp, n=4, narrow=True):
    """Members gossiping among themselves — every such sync-tick entry
    crosses the mesh plane — and pushing to a sink each outside the
    fleet, under seeded adds and removes, with a WAL each.
    ``shards=None`` is the vmap fleet. Returns each member's (canonical
    bytes, read, seq, WAL bytes, in-flight slots), the sinks' streams
    (normalised) and pickled wire bytes, the mesh stats and the
    transfer-count deltas."""
    dc, T, C, F, mesh_of, ledger, extra = _pkg(pkg)
    t = T()
    tag = f"{pkg}{store}{shards}{narrow}"
    reps = [
        dc.start_link(
            dc.AWLWWMap, threaded=False, transport=t, clock=C(), capacity=256, tree_depth=4, sync_timeout=600.0,
            store=store, name=f"mg{tag}{i}", node_id=(TOP if i % 2 else 0) + 100 + i,
            wal_dir=str(tmp / f"{tag}{i}"), fsync_mode="none", **extra,
        )
        for i in range(n)
    ]
    sinks = [
        dc.start_link(dc.AWLWWMap, threaded=False, transport=t, clock=C(), capacity=256, tree_depth=4,
                      store=store, name=f"mgs{tag}{i}", node_id=900 + i, **extra)
        for i in range(n)
    ]
    for i in range(n):
        reps[i].set_neighbours([reps[(i + 1) % n], reps[(i + 2) % n], sinks[i]])
    opts = {} if shards is None else {"mesh": mesh_of(shards), "mesh_narrow": narrow}
    fleet = F(reps, **opts)
    streams, wire = [], 0

    def drain_sinks():
        nonlocal wire
        for sk in sinks:
            msgs = t.drain(sk.addr)
            streams.append([_norm(m) for m in msgs])
            wire += sum(_wire_bytes(m) for m in msgs)

    before = ledger.snapshot()
    rng = np.random.default_rng(5)
    for rnd in range(3):
        for i in range(n):
            for j in range(2 + i):
                k = f"k{rnd}-{i}-{j}-{int(rng.integers(0, 1 << 62)) | TOP}"
                reps[i].mutate("add", [k, int(rng.integers(0, 1000))])
            if rnd == 1 and i % 2 == 0:
                reps[i].mutate("remove", [f"k0-{i}-0-{0}"])
        _drive([fleet], reps)
        drain_sinks()
    _drive([fleet], reps, rounds=3)
    drain_sinks()
    now = ledger.snapshot()
    delta = {s: now.get(s, {"count": 0})["count"] - before.get(s, {"count": 0})["count"] for s in SITES}
    out = [
        (r.canonical_state_bytes(), r.read(), r._seq, _wal_segment_bytes(r), len(r._outstanding))
        for r in reps
    ]
    mesh = fleet.stats()["mesh"]
    for r in reps + sinks:
        r.crash()
    return out, (streams, wire), mesh, delta


@pytest.mark.parametrize("shards", [2, 8])
def test_mesh_fleet_bit_equal_to_jax_mesh_fleet(shards, tmp_path):
    """THE acceptance property, on the binned store (the hash store's is
    in ``tests/test_torch_mesh_hash.py``)."""
    check_intra_parity("binned", shards, tmp_path)


def check_intra_parity(store, shards, tmp_path):
    """The port's mesh fleet against the JAX mesh fleet on one seeded
    script — canonical state bytes, reads, seqs, WAL segment bytes,
    in-flight slots, the sinks' streams and pickled wire bytes — and
    against its own vmap fleet; only the sinks' entries fall back."""
    tm, tsink, tms, td = intra_script("torch", store, shards, tmp_path)
    jm, jsink, jms, jd = intra_script("jax", store, shards, tmp_path)
    tv, vsink, _tvs, _ = intra_script("torch", store, None, tmp_path)
    assert tsink == jsink == vsink and tsink[1] > 0, "sink streams or wire bytes differ"
    assert len(tm) == len(jm) == len(tv)
    for i, (a, b, c) in enumerate(zip(tm, jm, tv)):
        assert a[0] == b[0] == c[0], ("canonical bytes", i)
        assert a[1] == b[1] == c[1], ("read", i)
        assert a[2] == b[2] == c[2], ("seq", i)
        assert a[3] == b[3], ("WAL bytes against JAX", i)
        assert a[4] == b[4] == c[4], ("in-flight slots", i)
    for key in ("enabled", "shards", "members_per_shard", "intra_entries", "fallback_entries", "exchanges"):
        assert tms[key] == jms[key], key
    sink_entries = sum(m[0] == "entries" for stream in tsink[0] for m in stream)
    assert tms["intra_entries"] > 0 and tms["fallback_entries"] == sink_entries > 0
    assert tms["exchanges"] > 0 and tms["permuted_bytes"] > 0
    assert tms["topology"]["platform"] == "cpu" and tms["topology"]["global_devices"] >= 1
    # the audited crossings: the mesh sites and the receivers' WAL reads
    # of device-plane bodies count as JAX's do
    assert td == jd, (td, jd)
    assert td["meshplane.ship_dense"] > 0 and td["replica.wal_entries"] > 0


def test_mesh_exchange_feeds_the_metrics_plane():
    """Every sync tick's ``MESH_EXCHANGE`` reaches the ``crdt_mesh_*``
    counters, which then read what ``stats()["mesh"]`` counts, and the
    scrape-time gauges read the shard layout."""
    from delta_crdt_ex_tpu_torch.runtime.metrics import Observability

    plane = Observability()
    try:
        t = TTransport()
        fleet = t_api.start_fleet(4, threaded=False, device="cpu", transport=t, capacity=256, tree_depth=4,
                                  mesh=cpu_mesh(2), obs=plane)
        reps = fleet.replicas
        for i, r in enumerate(reps):
            r.set_neighbours([reps[(i + 1) % 4]])
            r.mutate("add", [f"m{i}", i])
        _drive([fleet], reps, rounds=2)
        ms = fleet.stats()["mesh"]
        lb = (str(id(fleet)),)
        b = plane.bridge
        assert ms["intra_entries"] > 0 and ms["exchanges"] > 0
        assert (b.mesh_intra_entries.value(lb), b.mesh_fallback_entries.value(lb), b.mesh_exchanges.value(lb),
                b.mesh_permuted_bytes.value(lb)) == (ms["intra_entries"], ms["fallback_entries"], ms["exchanges"],
                                                     ms["permuted_bytes"])
        snap = plane.registry.snapshot()  # runs the scrape-time collectors
        assert snap["crdt_mesh_shards"]["values"][lb[0]] == 2
        assert snap["crdt_mesh_members_per_shard"]["values"][lb[0]] == 2.0
        fleet.stop()
    finally:
        plane.close()


def entries_only(transport, addr) -> int:
    """Drain an address and re-queue only its port EntriesMsgs, in order
    (a consecutive entries run for the coalescer)."""
    msgs = [m for m in transport.drain(addr) if isinstance(m, t_sync.EntriesMsg)]
    for m in msgs:
        transport.send(addr, m)
    return len(msgs)


def _pair(store=None, **kw):
    t = TTransport()

    def mk(name, node):
        return t_api.start_link(t_api.AWLWWMap, threaded=False, transport=t, clock=TClock(), device="cpu",
                                sync_timeout=600.0, name=name, node_id=node, store=store, **kw)

    return t, mk


@pytest.mark.parametrize("n,shards", [(3, 8), (5, 4), (2, 2)])
def test_mesh_shard_padding_lanes(n, shards):
    """Members below, above and at the shard count: the lane tier pads
    to a shard multiple (padding lanes merge nothing) and the end
    states equal the vmap fleet's."""
    t, mk = _pair(capacity=256, tree_depth=4)
    fm = [mk(f"pad{n}{shards}m{i}", 100 + i) for i in range(n)]
    vm = [mk(f"pad{n}{shards}v{i}", 100 + i) for i in range(n)]
    for i in range(n):
        fm[i].set_neighbours([fm[(i + 1) % n]])
        vm[i].set_neighbours([vm[(i + 1) % n]])
    f_mesh, f_vmap = Fleet(fm, mesh=cpu_mesh(shards)), Fleet(vm)
    assert f_mesh._lane_tier(n) % shards == 0 and f_mesh._lane_tier(n) >= max(n, shards)
    for rnd in range(2):
        for i in range(n):
            fm[i].mutate("add", [rnd * 10 + i, i])
            vm[i].mutate("add", [rnd * 10 + i, i])
        _drive([f_mesh, f_vmap], fm + vm)
    _drive([f_mesh, f_vmap], fm + vm, rounds=6)
    for i in range(n):
        assert fm[i].read() == vm[i].read(), (n, shards, i)
        assert fm[i].canonical_state_bytes() == vm[i].canonical_state_bytes(), (n, shards, i)


def test_mesh_ingress_batches_and_resident_state_sharded():
    """The ingress half rides the twins too: a batched wave lands in ONE
    sharded dispatch, and the resident stacked result stays block-split
    over the mesh between ticks."""
    t, mk = _pair(capacity=256, tree_depth=4)
    n = 4
    mesh = cpu_mesh(4)
    senders = [mk(f"ribs{i}", 7000 + i) for i in range(n)]
    members = [mk(f"ribm{i}", 100 + i) for i in range(n)]
    for i, s in enumerate(senders):
        s.set_neighbours([members[i]])
    fleet = Fleet(members, mesh=mesh)
    for rnd in range(2):
        for i, s in enumerate(senders):
            for k in keys_for_buckets(0, 16, 2, start=rnd * 37 + 7 * i):
                s.mutate("add", [k, k])
            s.sync_to_all()
        for r in members:
            entries_only(t, r.addr)
        fleet.drain()
    st = fleet.stats()
    assert st["dispatches"] >= 1 and st["occupancy_hist"].get(n, 0) >= 1
    assert fleet._stack_cache, "no resident stacked state cached"
    for _versions, stacked in fleet._stack_cache.values():
        assert isinstance(stacked, Sharded) and stacked.mesh is mesh
        assert len(stacked.blocks) == 4 and stacked.lanes_per_shard == 1
    assert st["stack_cache"]["hits"] >= 1


def test_mesh_resident_state_invalidated_on_fallback():
    """A member escaping a sharded dispatch (bin-tier overflow → the solo
    growth path) drops the bucket's resident sharded stack — its lane in
    the result is stale — and the end states match the vmap twin's."""
    t = TTransport()
    mk = lambda tag, i, node: t_api.start_link(
        t_api.AWLWWMap, threaded=False, transport=t, clock=TClock(), capacity=64, tree_depth=6, node_id=node,
        name=f"{tag}{i}", sync_timeout=600.0, device="cpu",
    )
    n = 2
    fsend = [mk("mfs", i, 7000 + i) for i in range(n)]
    vsend = [mk("mvs", i, 7000 + i) for i in range(n)]
    fm = [mk("mff", i, 1000 + i) for i in range(n)]
    vm = [mk("mvf", i, 1000 + i) for i in range(n)]
    for i in range(n):
        fsend[i].set_neighbours([fm[i]])
        vsend[i].set_neighbours([vm[i]])
    f_mesh, f_vmap = Fleet(fm, mesh=cpu_mesh(2)), Fleet(vm)
    for k in keys_for_buckets(3, 4, 6, start=0):
        fsend[0].mutate("add", [k, "x"])
        vsend[0].mutate("add", [k, "x"])
    for k in keys_for_buckets(40, 41, 5, start=50_000):
        fsend[1].mutate("add", [k, "y"])
        vsend[1].mutate("add", [k, "y"])
    for s in fsend + vsend:
        s.sync_to_all()
    for r in fm + vm:
        entries_only(t, r.addr)
    f_mesh.drain()
    f_vmap.drain()
    assert f_mesh.stats()["fallbacks"]["escape"] >= 1
    assert not f_mesh._stack_cache
    for i in range(n):
        assert fm[i].read() == vm[i].read(), i
        assert fm[i].canonical_state_bytes() == vm[i].canonical_state_bytes(), i


# ---------------------------------------------------------------------------
# construction and validation


def test_fleet_mesh_helpers():
    assert mesh_shard_count(8) == 8 and mesh_shard_count(6) == 4 and mesh_shard_count(1) == 1
    with pytest.raises(ValueError, match="power of two"):
        fleet_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="device"):
        fleet_mesh(1024)  # more shards than the detected devices
    mesh = fleet_mesh()
    assert mesh.axis_names == ("replicas",) and mesh.shards == mesh_shard_count()
    assert devices.detected_topology() == {
        "platform": "cpu", "global_devices": 1, "local_devices": 1, "processes": 1,
    }
    # a listed device may repeat: 8 shards on the one CPU
    assert cpu_mesh(8).devices == (torch.device("cpu"),) * 8


def test_fleet_rejects_bad_mesh():
    _t, mk = _pair()
    with pytest.raises(ValueError, match="replicas"):
        Fleet([mk("badmesh0", 1)], mesh=Mesh(["cpu"] * 2, axis_names=("clients",)))
    with pytest.raises(ValueError, match="power of two"):
        Fleet([mk("badmesh1", 2)], mesh=Mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="ranks"):
        Fleet([mk("badmesh2", 3)], mesh=Mesh(["cpu"] * 2, ranks=[0, 1]))


def test_fleet_mesh_int_and_true_knobs():
    _t, mk = _pair()
    f = Fleet([mk("knob0", 1)], mesh=True)
    assert f._mesh_shards == mesh_shard_count()
    f1 = Fleet([mk("knob1", 2)], mesh=1)
    assert f1._mesh_shards == 1 and f1.stats()["mesh"]["enabled"]
    # one CPU device: two shards need the device listed twice
    with pytest.raises(ValueError, match="device"):
        Fleet([mk("knob2", 3)], mesh=2)
    fleet = t_api.start_fleet(3, threaded=False, device="cpu", mesh=cpu_mesh(2), mesh_narrow=False,
                              capacity=64, tree_depth=4, transport=TTransport())
    assert fleet._mesh_shards == 2 and not fleet._mesh_plane.narrow
    assert Fleet([mk("knob3", 4)]).stats()["mesh"] == {
        "enabled": False, "shards": 0, "members_per_shard": 0.0, "intra_entries": 0, "fallback_entries": 0,
        "permuted_bytes": 0, "exchanges": 0, "topology": devices.detected_topology(),
    }
