"""The default replica path as a whole: JAX replicas and PyTorch
replicas (``threaded=False``, ``LogicalClock``, the same node ids,
``sync_timeout=1e9``) run one seeded script each, driven by
``sync_to_all()`` + ``transport.pump()`` or, where ingress must
coalesce, by ``process_pending()``:

(a) an ``AWLWWMap`` pair on the default (binned) store with diff
    subscribers — adds, overwrites, removes, concurrent writes to one
    key, a clear, growth past bin tiers: reads, partial reads, the diff
    streams, ``SYNC_DONE``, canonical bytes and every state column are
    bit-identical;
(b) three senders on disjoint bucket ranges into one receiver with no
    subscriber, so grouped merges deeper than 1 form, plus one
    delta-interval gap inside a group and its repair: state columns,
    canonical bytes, ``SYNC_DONE`` and ``stats()["ingress"]`` are the
    JAX receiver's;
(c) ``AWSet`` and ``HashAWSet`` pairs: read sets and diffs are JAX's;
(d) the port's binned and hash pairs on script (a) converge to the
    same canonical bytes, reads and diffs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import sync as j_sync, telemetry as j_telemetry
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.models.binned import to_numpy
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, telemetry as t_telemetry
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from tests.test_ingest_coalesce import keys_for_buckets

NODE_IDS = (0xF00000000000000B, 7)
JAX = (jdc, j_telemetry, j_sync, JTransport, JClock, {})
TORCH = (tdc, t_telemetry, t_sync, TTransport, TClock, {"device": "cpu"})


def record_sync_done(telemetry, fn):
    """``(fn(), [(name, keys_updated_count), …])``."""
    events = []
    handler = lambda _e, meas, meta: events.append((meta["name"], meas["keys_updated_count"]))
    telemetry.attach(telemetry.SYNC_DONE, handler)
    try:
        return fn(), events
    finally:
        telemetry.detach(telemetry.SYNC_DONE, handler)


def assert_columns_equal(j_state, t_state):
    cols = to_numpy(t_state)
    for f in dataclasses.fields(j_state):
        want = np.asarray(getattr(j_state, f.name))
        assert cols[f.name].dtype == want.dtype and np.array_equal(cols[f.name], want), f.name


# ---------------------------------------------------------------------------
# (a) the default store with subscribers


def map_script(pkg, model=None, **kw):
    """A pair on ``model`` (default: the package's ``AWLWWMap``) through
    the seeded script; returns every observation, the replicas and the
    diff logs."""
    dc, _tel, _sync, transport_cls, clock_cls, extra = pkg
    t, c, logs = transport_cls(), clock_cls(), ([], [])
    rs = [
        dc.start_link(
            model or dc.AWLWWMap, threaded=False, transport=t, clock=c, name=f"b{i}",
            node_id=NODE_IDS[i], capacity=64, tree_depth=4, sync_interval=0.01,
            max_sync_size=8, on_diffs=logs[i].append, sync_timeout=1e9, **extra, **kw,
        )
        for i in range(2)
    ]
    rs[0].set_neighbours([rs[1]])
    rs[1].set_neighbours([rs[0]])
    g = np.random.default_rng(9)
    out = []

    def converge(rounds: int) -> None:
        for _ in range(rounds):
            for r in rs:
                r.sync_to_all()
            t.pump()

    for step in range(10):
        r = rs[step % 2]
        r.mutate_batch("add", [[f"k{int(x)}", int(g.integers(0, 1000))] for x in g.integers(0, 120, 30)])
        for x in g.integers(0, 120, 4):
            r.mutate("remove", [f"k{int(x)}"])
        rs[0].mutate("add", ["hot", step])
        rs[1].mutate("add", ["hot", -step])
        if step == 6:
            rs[1].mutate("clear", [])
        converge(2)
        out.append(rs[0].read_keys([f"k{i}" for i in range(0, 120, 7)] + ["hot", "nope"]))
        out.append(rs[step % 2].state.capacity)
    converge(6)
    for r in rs:
        out += [r.read(), r.read_items(), r.canonical_state_bytes()]
    return out, rs, logs


@pytest.fixture(scope="module")
def default_runs():
    return {
        name: record_sync_done(pkg[1], lambda pkg=pkg: map_script(pkg))
        for name, pkg in (("jax", JAX), ("torch", TORCH))
    }


def test_default_store_reads_and_canonical_bytes_match_jax(default_runs):
    (oj, rj, _), _ = default_runs["jax"]
    (ot, rt, _), _ = default_runs["torch"]
    assert rt[0].model is tdc.BinnedAWLWWMap
    assert len(oj) == len(ot)
    for i, (a, b) in enumerate(zip(oj, ot)):
        assert a == b, i
    # converged, and the bins grew past their first tier on the way
    assert oj[-1] == oj[-4] and len(oj[-3]) > 0
    assert rt[0].state.bin_capacity > 4 and rt[0].state.bin_capacity == rj[0].state.bin_capacity


def test_default_store_diffs_and_sync_done_match_jax(default_runs):
    (_, _, lj), ej = default_runs["jax"]
    (_, _, lt), et = default_runs["torch"]
    assert lj == lt
    assert ej == et and len(ej) > 0
    assert {d[0] for batch in lj[0] + lj[1] for d in batch} == {"add", "remove"}


def test_default_store_state_columns_match_jax(default_runs):
    (_, rj, _), _ = default_runs["jax"]
    (_, rt, _), _ = default_runs["torch"]
    for a, b in zip(rj, rt):
        assert_columns_equal(a.state, b.state)


def test_binned_and_hash_pairs_converge_to_the_same_bytes(default_runs):
    (ob, _, lb), _ = default_runs["torch"]
    oh, rh, lh = map_script(TORCH, store="hash")
    assert rh[0].model is tdc.HashAWLWWMap
    for i in (-6, -3):  # each replica's read, items (order is the store's) and canonical bytes
        assert oh[i] == ob[i] and dict(oh[i + 1]) == dict(ob[i + 1]) and oh[i + 2] == ob[i + 2]
    # the same diffs in the same callbacks; within one callback they come
    # in the store's winner order
    by_call = lambda logs: [[sorted(map(repr, batch)) for batch in log] for log in logs]
    assert by_call(lh) == by_call(lb)


# ---------------------------------------------------------------------------
# (b) coalesced ingress: three senders into one receiver


def entries_only(transport, addr) -> int:
    """Keep only the EntriesMsgs queued at ``addr``, in order."""
    msgs = [m for m in transport.drain(addr) if type(m).__name__ == "EntriesMsg"]
    for m in msgs:
        transport.send(addr, m)
    return len(msgs)


def coalesce_script(pkg):
    dc, _tel, sync, transport_cls, clock_cls, extra = pkg
    t, c = transport_cls(), clock_cls()
    # 8 slots a bucket: no sender grows its bins, so every slice has one
    # lane tier and the three senders' slices may share a group
    mk = lambda name, node: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=c, name=name, node_id=node,
        capacity=512, tree_depth=6, sync_timeout=1e9, **extra,
    )
    senders = [mk(f"s{i}", NODE_IDS[0] - i) for i in range(3)]
    recv = mk("recv", NODE_IDS[1])
    for s in senders:
        s.set_neighbours([recv])
    keys = [keys_for_buckets(16 * i, 16 * (i + 1), 30, start=10_000 * i) for i in range(3)]

    gets = []

    def deliver() -> int:
        for s in senders:
            s.sync_to_all()
        n = entries_only(t, recv.addr)
        recv.process_pending()
        for s in senders:  # walk back-traffic dropped: the pushes carry all data
            gets.extend((s, m) for m in t.drain(s.addr) if isinstance(m, sync.GetDiffMsg))
        return n

    seen = []
    for i, s in enumerate(senders):  # adds: interval pushes
        s.mutate_batch("add", [[k, f"v{k}"] for k in keys[i][:20]])
    seen.append(deliver())
    for i, s in enumerate(senders):  # removes + fresh adds: full-row pushes too
        s.mutate("remove", [keys[i][0]])
        s.mutate_batch("add", [[k, f"w{k}"] for k in keys[i][20:25]])
    seen.append(deliver())

    # a lost push: sender 0's next interval in that bucket gaps
    (k1, k2) = keys_for_buckets(3, 4, 2, start=90_000)
    senders[0].mutate("add", [k1, "one"])
    senders[0].sync_to_all()
    t.drain(recv.addr)
    senders[0].mutate("add", [k2, "two"])
    for i in (1, 2):
        senders[i].mutate("add", [keys[i][26], "late"])
    seen.append(deliver())
    for s, m in gets:
        s.handle(m)  # the repair: full rows back to the receiver
    seen.append(entries_only(t, recv.addr))
    recv.process_pending()
    return {
        "seen": seen,
        "gets": [s.name for s, _m in gets],
        "bins": [s.state.bin_capacity for s in senders],
        "read": recv.read(),
        "canonical": recv.canonical_state_bytes(),
        "ingress": recv.stats()["ingress"],
        "seq": recv.stats()["sequence_number"],
        "recv": recv,
        "want": {k: v for s in senders for k, v in s.read().items()},
    }


@pytest.fixture(scope="module")
def coalesce_runs():
    return {
        name: record_sync_done(pkg[1], lambda pkg=pkg: coalesce_script(pkg))
        for name, pkg in (("jax", JAX), ("torch", TORCH))
    }


def test_coalesced_ingress_matches_jax(coalesce_runs):
    j, ej = coalesce_runs["jax"]
    t, et = coalesce_runs["torch"]
    for f in ("seen", "gets", "bins", "read", "canonical", "ingress", "seq"):
        assert j[f] == t[f], f
    assert_columns_equal(j["recv"].state, t["recv"].state)
    assert [x for x in ej if x[0] == "recv"] == [x for x in et if x[0] == "recv"]
    assert t["read"] == t["want"] and len(t["read"]) == 3 * 24 + 2 + 2


def test_coalesced_ingress_formed_deep_groups_and_partitioned_the_gap(coalesce_runs):
    t, _ = coalesce_runs["torch"]
    ing = t["ingress"]
    assert max(ing["coalesce_depth_hist"]) >= 3 and ing["messages"] > ing["dispatches"] >= 1
    assert ing["gap_partitions"] == 1 and ing["gap_fallbacks"] == 0
    assert t["gets"] == ["s0"] and t["bins"] == [8, 8, 8]


# ---------------------------------------------------------------------------
# (c) AWSet and HashAWSet


def set_script(pkg, model_name: str):
    dc, _tel, _sync, transport_cls, clock_cls, extra = pkg
    model = getattr(dc, model_name)
    t, c, logs = transport_cls(), clock_cls(), ([], [])
    rs = [
        dc.start_link(
            model, threaded=False, transport=t, clock=c, name=f"set{i}", node_id=NODE_IDS[i],
            capacity=64, tree_depth=4, max_sync_size=8, on_diffs=logs[i].append,
            sync_timeout=1e9, **extra,
        )
        for i in range(2)
    ]
    rs[0].set_neighbours([rs[1]])
    rs[1].set_neighbours([rs[0]])
    g = np.random.default_rng(4)
    out = []
    for step in range(6):
        r = rs[step % 2]
        r.mutate_batch("add", [[int(x)] for x in g.integers(0, 80, 20)])
        r.mutate("remove", [int(g.integers(0, 80))])
        if step == 3:
            rs[0].mutate("clear", [])
        for _ in range(2):
            for x in rs:
                x.sync_to_all()
            t.pump()
        out.append(rs[1 - step % 2].read())
        out.append(rs[0].read_keys([0, 1, 2, 3, 999]))
    out += [r.canonical_state_bytes() for r in rs]
    return out, logs


@pytest.mark.parametrize("model_name", ["AWSet", "HashAWSet"])
def test_sets_match_jax(model_name):
    oj, lj = set_script(JAX, model_name)
    ot, lt = set_script(TORCH, model_name)
    assert oj == ot and lj == lt
    assert all(isinstance(x, set) for x in ot[:-2]) and ot[-1] == ot[-2]
    assert {d[0] for batch in lt[0] + lt[1] for d in batch} == {"add", "remove"}
    assert all(d[2] is True for batch in lt[0] for d in batch if d[0] == "add")
