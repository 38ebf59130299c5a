"""Log-shipping catch-up on the port, against the JAX package: a
rejoining or lagging peer replays the originator's delta-log suffix
(``GetLogMsg`` / ``LogChunkMsg``) instead of walking the digest tree.

- The watermark repair: port replicas learn the applied watermark from
  walk equality on round openers exactly as JAX replicas do, and keep it
  in their snapshots (``peer_seqs``); mid-walk equality teaches nothing.
- The cases of ``tests/test_log_shipping.py`` on port replicas, over
  both dot stores where the JAX case is store-agnostic: the WAL range
  cursor, the horizon and barrier contracts, requester pacing, a
  superseded stream, a ``Down`` mid-stream, telemetry and stats, the
  past-horizon mode decision, and a chunk over the port's TCP transport.
- Parity: catch-up by log shipping leaves the receiver bit-equal to a
  catch-up by the digest walk, and the port's catch-up equals the JAX
  package's on one ``LogicalClock`` script (messages, state columns,
  canonical bytes, watermarks, stats).

Everything runs on the CPU at small shapes.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import pytest

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import sync as j_sync
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, telemetry
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.tcp_transport import TcpTransport
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport
from delta_crdt_ex_tpu_torch.runtime.wal import WalLog

STORES = ["binned", "hash"]


# ---------------------------------------------------------------------------
# WAL range-read cursor


def _mk_wal(tmp_path, **kw):
    w = WalLog(str(tmp_path / "log"), fsync_mode="none", **kw)
    w.bind(7)
    return w


def _append(w, seq, tag="x"):
    w.append({"kind": "batch", "seq": seq, "ops": [("add", f"{tag}{seq}", seq)], "ts": [seq]})
    w.commit()


def test_read_range_spans_segment_boundaries(tmp_path):
    w = _mk_wal(tmp_path, segment_bytes=128)  # rolls every couple records
    for seq in range(1, 13):
        _append(w, seq)
    assert len(w.segment_paths()) > 2
    records, next_seq, exhausted = w.read_range(0, 12)
    assert [r["seq"] for r in records] == list(range(1, 13))
    assert next_seq == 12 and exhausted
    records, next_seq, exhausted = w.read_range(5, 9)
    assert [r["seq"] for r in records] == [6, 7, 8, 9]
    assert next_seq == 9 and exhausted
    records, next_seq, exhausted = w.read_range(0, 12, max_records=4)
    assert [r["seq"] for r in records] == [1, 2, 3, 4] and not exhausted
    records, next_seq, _ = w.read_range(next_seq, 12, max_records=4)
    assert [r["seq"] for r in records] == [5, 6, 7, 8]
    records, next_seq, exhausted = w.read_range(0, 12, max_bytes=1)
    assert [r["seq"] for r in records] == [1] and not exhausted
    w.close()


def test_read_range_empty_and_out_of_range(tmp_path):
    w = _mk_wal(tmp_path)
    assert w.read_range(0, 0) == ([], 0, True)
    _append(w, 1)
    _append(w, 2)
    assert w.read_range(5, 9) == ([], 5, True)
    w.close()


def test_read_range_stops_at_truncated_tail(tmp_path):
    w = _mk_wal(tmp_path)
    for seq in (1, 2, 3):
        _append(w, seq)
    w.close()
    path = w.segment_paths()[-1]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)  # tear the last record
    records, next_seq, exhausted = w.read_range(0, 3)
    assert [r["seq"] for r in records] == [1, 2]
    assert next_seq == 2  # the cursor never claims the torn record
    w2 = WalLog(str(tmp_path / "log"), fsync_mode="none")
    _header, recs = w2.recover()
    assert [r["seq"] for r in recs] == [1, 2]
    assert w2.read_range(0, 9) == (recs, 2, True)
    w2.close()


def test_read_range_handles_records_larger_than_the_read_chunk(tmp_path):
    w = _mk_wal(tmp_path)
    big = {"kind": "blob", "seq": 1, "data": os.urandom(700 << 10)}
    w.append(big)
    w.commit()
    _append(w, 2)
    w.close()
    records, next_seq, exhausted = w.read_range(0, 2)
    assert [r["seq"] for r in records] == [1, 2] and exhausted
    assert records[0]["data"] == big["data"]


def test_read_range_stops_at_mid_segment_corruption(tmp_path):
    w = _mk_wal(tmp_path)
    for seq in (1, 2, 3):
        _append(w, seq)
    w.close()
    path = w.segment_paths()[-1]
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    records, _next, _exhausted = w.read_range(0, 3)
    assert [r["seq"] for r in records] == [1]  # clean prefix only


def test_read_range_after_reused_start_seq(tmp_path):
    w = _mk_wal(tmp_path)
    _append(w, 1)
    w.rotate()
    _append(w, 2)
    w.close()
    second = w.segment_paths()[-1]
    with open(second, "r+b") as f:
        f.truncate(os.path.getsize(second) - 3)
    w2 = WalLog(str(tmp_path / "log"), fsync_mode="none")
    _header, recs = w2.recover()
    assert [r["seq"] for r in recs] == [1]
    _append(w2, 2)
    records, next_seq, exhausted = w2.read_range(0, 2)
    assert [r["seq"] for r in records] == [1, 2]
    assert exhausted
    w2.close()


def test_horizon_tracks_compaction(tmp_path):
    w = _mk_wal(tmp_path, segment_bytes=128)
    assert w.horizon() == 0
    for seq in range(1, 13):
        _append(w, seq)
    assert w.horizon() == 0
    w.compact(8)
    h = w.horizon()
    assert 0 < h <= 8
    records, _next, exhausted = w.read_range(h, 12)
    assert exhausted and [r["seq"] for r in records] == list(range(h + 1, 13))
    below, _n, _e = w.read_range(0, 12)
    assert [r["seq"] for r in below] == list(range(h + 1, 13))
    w.close()


# ---------------------------------------------------------------------------
# replicas


@pytest.fixture
def spawn():
    """``spawn(transport, clock, name, store, tmp=None, pkg="torch",
    **opts)``: an unthreaded replica at small shapes (a WAL under
    ``tmp`` when given); every replica started is crashed in teardown,
    which closes its WAL."""
    made = []

    def mk(transport, clock, name, store="binned", tmp=None, pkg="torch", **opts):
        kw = dict(
            threaded=False, transport=transport, clock=clock, capacity=256,
            tree_depth=6, sync_timeout=0.01, store=store, name=name,
        )
        if tmp is not None:
            kw.update(wal_dir=str(tmp), fsync_mode="none")
        kw.update(opts)
        if pkg == "jax":
            r = jdc.start_link(jdc.AWLWWMap, **kw)
        else:
            r = tdc.start_link(tdc.AWLWWMap, device="cpu", **kw)
        made.append(r)
        return r

    yield mk
    for r in made:
        r.crash()


def _drive(transport, replicas, rounds=8):
    """Deliver queued messages without opening new sync rounds."""
    n = 0
    for _ in range(rounds):
        moved = 0
        for r in replicas:
            for m in transport.drain(r.addr):
                r.handle(m)
                moved += 1
        n += moved
        if not moved:
            break
    return n


def _lose_inflight(transport, rep):
    """In-flight loss toward ``rep``: its mailbox drains to the floor."""
    return transport.drain(rep.addr)


def _cols(rep) -> dict:
    """The state's columns as numpy, in the JAX package's dtypes and
    field order, from a replica of either package."""
    if isinstance(rep, tdc.Replica):
        return rep.model.to_numpy(rep.state)
    st = rep.state
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def assert_state_bit_equal(r1, r2, ctx=""):
    c1, c2 = _cols(r1), _cols(r2)
    assert c1.keys() == c2.keys()
    for c in c1:
        assert np.array_equal(np.asarray(c1[c]), np.asarray(c2[c])), (ctx, c)


def _alive_dots(rep):
    """Canonical content fingerprint: every alive dot's identity,
    position-independent."""
    c = _cols(rep)
    idx = np.nonzero(c["alive"])
    gid = c["ctx_gid"][c["node"][idx]]
    return sorted(
        zip(c["key"][idx].tolist(), gid.tolist(), c["ctr"][idx].tolist(), c["ts"][idx].tolist(),
            c["valh"][idx].tolist())
    )


def _watermark_script(spawn, pkg, store, tmp_path):
    """Two replicas each way through five adds and six sync rounds,
    then a mid-walk equality frame stamped with a far-future seq."""
    transport = (JTransport if pkg == "jax" else LocalTransport)()
    clock = (JClock if pkg == "jax" else LogicalClock)()
    a = spawn(transport, clock, "wm_a", store, tmp_path / pkg / "a", pkg=pkg, node_id=11)
    b = spawn(transport, clock, "wm_b", store, tmp_path / pkg / "b", pkg=pkg, node_id=22)
    a.set_neighbours([b])
    b.set_neighbours([a])
    transport.pump()
    for i in range(5):
        a.mutate("add", [i, i])
    for _ in range(6):
        a.sync_to_all()
        b.sync_to_all()
        transport.pump()
    learned = (dict(a._applied_seq), dict(b._applied_seq))
    peer_seqs = (a._snapshot().peer_seqs, b._snapshot().peer_seqs)
    tree = b._ensure_tree()
    b.handle(
        (j_sync if pkg == "jax" else sync_proto).DiffMsg(
            originator=a.addr, frm=a.addr, to=b.addr, level=2, idx=np.zeros(1, np.int64),
            blocks=sync_proto.make_blocks(tree, 2, np.zeros(1, np.int64), 2), seq=999, log_horizon=0,
        )
    )
    return learned, peer_seqs, dict(b._applied_seq), a.read() == b.read(), a._seq


@pytest.mark.parametrize("store", STORES)
def test_watermark_learned_from_walk_equality_matches_jax(spawn, tmp_path, store):
    """The applied watermark is learned from walk equality on round
    openers only (``originator == frm``), as in the JAX replica, and
    rides the snapshot's ``peer_seqs``; an equality on a mid-walk frame
    (level > 0) does not advance it."""
    jax_run = _watermark_script(spawn, "jax", store, tmp_path)
    port_run = _watermark_script(spawn, "torch", store, tmp_path)
    assert port_run == jax_run
    (a_seqs, b_seqs), (a_snap, b_snap), b_after, converged, a_seq = port_run
    assert converged and b_seqs == {"wm_a": a_seq} and a_seq >= 5 and a_seqs.get("wm_b", 0) >= 1
    assert (a_snap, b_snap) == (a_seqs, b_seqs)
    assert b_after == b_seqs  # the mid-walk frame claimed nothing


@pytest.mark.parametrize("store", STORES)
def test_watermark_learned_from_walk_equality(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "wm_a", store, tmp_path / "a")
    b = spawn(transport, clock, "wm_b", store)
    a.set_neighbours([b])
    transport.pump()
    for i in range(5):
        a.mutate("add", [i, i])
    a.sync_to_all()
    transport.pump()
    assert b.read() == a.read()
    assert b._applied_seq.get(a.addr) == a._seq == 5
    assert a._ack_seq.get(b.addr) == 5


@pytest.mark.parametrize("store", STORES)
def test_midwalk_equality_does_not_advance_watermark(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "mw_a", store, tmp_path / "a")
    b = spawn(transport, clock, "mw_b", store)
    a.set_neighbours([b])
    transport.pump()
    for i in range(4):
        a.mutate("add", [i, i])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == 4
    tree = b._ensure_tree()
    b.handle(
        sync_proto.DiffMsg(
            originator=a.addr, frm=a.addr, to=b.addr, level=2, idx=np.zeros(1, np.int64),
            blocks=sync_proto.make_blocks(tree, 2, np.zeros(1, np.int64), 2), seq=999, log_horizon=0,
        )
    )
    assert b._applied_seq.get(a.addr) == 4


def test_superseded_chunk_does_not_fork_streams(spawn, tmp_path):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "fk_a", tmp=tmp_path / "a", catchup_chunk_rows=8)
    b = spawn(transport, clock, "fk_b")
    a.set_neighbours([b])
    transport.pump()
    a.mutate("add", ["prime", 0])
    a.sync_to_all()
    transport.pump()
    for i in range(40):
        a.mutate("add", [i, i])
    a.sync_to_all()
    _lose_inflight(transport, b)
    time.sleep(0.02)
    a.sync_to_all()
    for m in _lose_inflight(transport, b):
        b.handle(m)  # opener → request #1 queued at a
    for m in transport.drain(a.addr):
        a.handle(m)  # chunk #1 (more=True) queued at b
    chunk1 = next(m for m in transport.drain(b.addr) if isinstance(m, sync_proto.LogChunkMsg))
    assert chunk1.more
    time.sleep(0.02)
    with b._lock:
        b._request_catchup(a.addr)  # request #2 (from the old watermark)
    b.handle(chunk1)
    b.handle(chunk1)
    followups = [m for m in transport.drain(a.addr) if isinstance(m, sync_proto.GetLogMsg)]
    assert len(followups) == 2
    assert followups[0].last_seq == chunk1.seq_lo
    assert followups[1].last_seq > chunk1.seq_lo
    assert b.stats()["catchup"]["in_flight"] == 1
    for m in followups:
        a.handle(m)
    for _ in range(12):
        for m in transport.drain(b.addr):
            b.handle(m)
        for m in transport.drain(a.addr):
            a.handle(m)
    assert b.read() == a.read()
    assert b.stats()["catchup"]["in_flight"] == 0


@pytest.mark.parametrize("store", STORES)
def test_catchup_after_inflight_loss_single_roundtrip(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "lr_a", store, tmp_path / "a")
    b = spawn(transport, clock, "lr_b", store)
    a.set_neighbours([b])
    transport.pump()
    for i in range(8):
        a.mutate("add", [i, i])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == 8
    for i in range(8, 24):
        a.mutate("add", [i, i])
    a.mutate("remove", [0])
    a.sync_to_all()
    lost = _lose_inflight(transport, b)
    assert any(isinstance(m, sync_proto.EntriesMsg) for m in lost)
    time.sleep(0.02)
    a.sync_to_all()
    kinds = []
    for _ in range(8):
        for m in transport.drain(b.addr):
            kinds.append(type(m).__name__)
            b.handle(m)
        for m in transport.drain(a.addr):
            kinds.append(type(m).__name__)
            a.handle(m)
    assert b.read() == a.read() == {i: i for i in range(1, 24)}
    assert "GetLogMsg" in kinds and "LogChunkMsg" in kinds
    assert "GetDiffMsg" not in kinds
    assert kinds.count("LogChunkMsg") == 1
    assert b.stats()["catchup"]["chunks_applied"] == 1
    assert a.stats()["catchup"]["chunks_served"] == 1
    assert a.stats()["catchup"]["bytes_shipped"] > 0
    assert not a._outstanding
    assert a._ack_seq.get(b.addr) == a._seq


@pytest.mark.parametrize("store", STORES)
def test_catchup_parity_bit_for_bit_vs_digest_walk(spawn, tmp_path, store):
    """Two identically seeded receivers, one catching up by log shipping
    and one by the walk, end bit-identical (fresh adds plus removes of
    pre-lag keys: touched rows are the differing rows)."""
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "pb_a", store, tmp_path / "a")
    bl = spawn(transport, clock, "pb_log", store, node_id=777)
    bw = spawn(transport, clock, "pb_walk", store, node_id=777, log_shipping=False)
    a.set_neighbours([bl, bw])
    transport.pump()
    for i in range(12):
        a.mutate("add", [i, i * 10])
    a.sync_to_all()
    transport.pump()
    assert bl.read() == bw.read() == a.read()
    assert_state_bit_equal(bl, bw, "pre-lag")
    for i in range(12, 40):
        a.mutate("add", [i, i * 10])
    for i in range(0, 6):
        a.mutate("remove", [i])
    a.sync_to_all()
    _lose_inflight(transport, bl)
    _lose_inflight(transport, bw)
    time.sleep(0.02)
    a.sync_to_all()
    _drive(transport, [a, bl, bw])
    assert bl.read() == bw.read() == a.read()
    assert len(a.read()) == 12 - 6 + 28
    assert_state_bit_equal(bl, bw, "post-catchup")
    assert bl.canonical_state_bytes() == bw.canonical_state_bytes() == a.canonical_state_bytes()
    assert bl.stats()["catchup"]["chunks_applied"] >= 1
    assert bw.stats()["catchup"]["chunks_applied"] == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_catchup_parity_randomized_churn(spawn, tmp_path, seed):
    rng = np.random.default_rng(seed)
    store = STORES[seed % 2]
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, f"rc_a{seed}", store, tmp_path / "a")
    bl = spawn(transport, clock, f"rc_log{seed}", store, node_id=777)
    bw = spawn(transport, clock, f"rc_walk{seed}", store, node_id=777, log_shipping=False)
    a.set_neighbours([bl, bw])
    transport.pump()
    for _cycle in range(int(rng.integers(2, 5))):
        for _ in range(int(rng.integers(1, 16))):
            ki = int(rng.integers(0, 24))
            if rng.random() < 0.7:
                a.mutate("add", [ki, int(rng.integers(0, 100))])
            else:
                a.mutate("remove", [ki])
        a.sync_to_all()
        if rng.random() < 0.7:
            _lose_inflight(transport, bl)
            _lose_inflight(transport, bw)
            time.sleep(0.02)
        else:
            _drive(transport, [a, bl, bw])
    for _ in range(6):
        time.sleep(0.02)
        a.sync_to_all()
        _drive(transport, [a, bl, bw])
    assert bl.read() == bw.read() == a.read()
    assert _alive_dots(bl) == _alive_dots(bw) == _alive_dots(a)


def test_horizon_fallback_covers_prefix_by_walk(spawn, tmp_path):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "hz_a", tmp=tmp_path / "a", segment_bytes=256, compact_every=10**9,
              membership_compaction=False)
    b = spawn(transport, clock, "hz_b")
    a.set_neighbours([b])
    transport.pump()
    for i in range(4):
        a.mutate("add", [i, i])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == 4
    for i in range(4, 40):
        a.mutate("add", [i, i])
    a.sync_to_all()
    _lose_inflight(transport, b)
    a.checkpoint()
    horizon = a.stats()["wal"]["horizon"]
    assert horizon > 4
    time.sleep(0.02)
    a.sync_to_all()
    _drive(transport, [a, b])
    assert b.read() == a.read()

    b2 = spawn(transport, clock, "hz_b2")
    transport.send(a.addr, sync_proto.GetLogMsg(frm=b2.addr, to=a.addr, last_seq=0))
    for m in transport.drain(a.addr):
        a.handle(m)
    chunks = [m for m in transport.drain(b2.addr) if isinstance(m, sync_proto.LogChunkMsg)]
    assert len(chunks) == 1 and chunks[0].horizon == horizon
    assert chunks[0].seq_lo == horizon
    b2.handle(chunks[0])
    assert b2.stats()["catchup"]["horizon_fallbacks"] == 1
    assert b2._applied_seq.get(a.addr, 0) == 0


@pytest.mark.parametrize("store", STORES)
def test_clear_record_is_a_serving_barrier(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    # 64 buckets; hard cap = 4 × catchup_chunk_rows = 16 < 64 → barrier
    a = spawn(transport, clock, "cl_a", store, tmp_path / "a", catchup_chunk_rows=4)
    b = spawn(transport, clock, "cl_b", store)
    a.set_neighbours([b])
    transport.pump()
    for i in range(6):
        a.mutate("add", [i, i])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == a._seq
    a.mutate("clear", [])
    for i in range(10, 16):
        a.mutate("add", [i, i])
    a.sync_to_all()
    _lose_inflight(transport, b)
    time.sleep(0.02)
    a.sync_to_all()
    kinds = []
    for _ in range(16):
        time.sleep(0.02)
        a.sync_to_all()
        for m in transport.drain(b.addr):
            kinds.append(type(m).__name__)
            b.handle(m)
        for m in transport.drain(a.addr):
            kinds.append(type(m).__name__)
            a.handle(m)
    assert b.read() == a.read() == {i: i for i in range(10, 16)}
    assert "LogChunkMsg" in kinds
    assert b._applied_seq.get(a.addr) == a._seq


def test_unknown_record_kind_is_a_serving_barrier(spawn, tmp_path):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "uk_a", tmp=tmp_path / "a")
    b = spawn(transport, clock, "uk_b")
    a.set_neighbours([b])
    transport.pump()
    a.mutate("add", ["prime", 0])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == 1
    a._wal.append({"kind": "from_the_future", "seq": a._seq + 1})
    a._wal.commit()
    a._seq += 1
    for i in range(6):
        a.mutate("add", [i, i])
    with b._lock:
        b._request_catchup(a.addr)
    for m in transport.drain(a.addr):
        a.handle(m)
    chunk = next(m for m in transport.drain(b.addr) if isinstance(m, sync_proto.LogChunkMsg))
    assert chunk.horizon == 2 and chunk.seq_hi == 1 and chunk.slices == []
    assert chunk.more
    b.handle(chunk)
    assert b._applied_seq.get(a.addr) == 1
    for m in transport.drain(a.addr):
        a.handle(m)
    chunk2 = next(m for m in transport.drain(b.addr) if isinstance(m, sync_proto.LogChunkMsg))
    assert chunk2.seq_lo == 2 and chunk2.seq_hi == a._seq and chunk2.slices
    b.handle(chunk2)
    assert b._applied_seq.get(a.addr) == 1
    assert a._ack_seq.get(b.addr, 0) <= 1


@pytest.mark.parametrize("store", STORES)
def test_get_log_without_wal_answers_walkable_horizon(spawn, store):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "nw_a", store)
    b = spawn(transport, clock, "nw_b", store)
    for i in range(5):
        a.mutate("add", [i, i])
    transport.send(a.addr, sync_proto.GetLogMsg(frm=b.addr, to=a.addr, last_seq=0))
    for m in transport.drain(a.addr):
        a.handle(m)
    msgs = transport.drain(b.addr)
    chunk = next(m for m in msgs if isinstance(m, sync_proto.LogChunkMsg))
    assert chunk.slices == [] and not chunk.more and chunk.horizon == a._seq
    assert any(isinstance(m, sync_proto.DiffMsg) for m in msgs)
    for m in msgs:
        b.handle(m)
    _drive(transport, [a, b])
    assert b.read() == a.read()


@pytest.mark.parametrize("store", STORES)
def test_chunked_stream_is_requester_paced(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "ch_a", store, tmp_path / "a", catchup_chunk_rows=8)
    b = spawn(transport, clock, "ch_b", store)
    a.set_neighbours([b])
    transport.pump()
    a.mutate("add", ["prime", 0])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == 1
    for i in range(40):
        a.mutate("add", [i, i])
    a.sync_to_all()
    _lose_inflight(transport, b)
    time.sleep(0.02)
    a.sync_to_all()
    kinds = []
    for _ in range(24):
        for m in transport.drain(b.addr):
            kinds.append(type(m).__name__)
            b.handle(m)
        for m in transport.drain(a.addr):
            kinds.append(type(m).__name__)
            a.handle(m)
    assert b.read() == a.read()
    n_chunks = kinds.count("LogChunkMsg")
    assert n_chunks > 1
    assert b.stats()["catchup"]["chunks_applied"] == n_chunks
    assert not a._outstanding


def test_down_mid_stream_leaves_receiver_consistent(spawn, tmp_path):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "dn_a", tmp=tmp_path / "a", catchup_chunk_rows=8, eager_deltas=False)
    b = spawn(transport, clock, "dn_b")
    a.set_neighbours([b])
    b.set_neighbours([a])
    transport.pump()
    a.mutate("add", ["prime", 0])
    a.sync_to_all()
    transport.pump()
    for i in range(40):
        a.mutate("add", [i, i])
    a.sync_to_all()
    _lose_inflight(transport, b)
    time.sleep(0.02)
    a.sync_to_all()
    for m in _lose_inflight(transport, b):
        b.handle(m)
    for m in transport.drain(a.addr):
        a.handle(m)
    chunk1 = [m for m in transport.drain(b.addr) if isinstance(m, sync_proto.LogChunkMsg)]
    assert len(chunk1) == 1 and chunk1[0].more
    b.handle(chunk1[0])
    applied_before = b.stats()["catchup"]["chunks_applied"]
    watermark = b._applied_seq.get(a.addr)
    assert watermark == chunk1[0].seq_hi

    a.crash()
    b.process_pending()
    assert b.stats()["catchup"]["in_flight"] == 0
    written = {i: i for i in range(40)} | {"prime": 0}
    assert set(b.read().items()) <= set(written.items())
    assert b._applied_seq.get(a.addr) == watermark

    a2 = spawn(transport, clock, "dn_a", tmp=tmp_path / "a", catchup_chunk_rows=8, eager_deltas=False)
    a2.set_neighbours([b])
    time.sleep(0.02)
    a2.sync_to_all()
    _drive(transport, [a2, b])
    assert b.read() == a2.read()
    assert b.stats()["catchup"]["chunks_applied"] > applied_before


@pytest.mark.parametrize("store", STORES)
def test_watermarks_survive_restart_via_snapshot(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "sn_a", store, tmp_path / "a")
    b = spawn(transport, clock, "sn_b", store, tmp_path / "b")
    a.set_neighbours([b])
    transport.pump()
    for i in range(6):
        a.mutate("add", [i, i])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == 6
    b.checkpoint()
    b.crash()
    b2 = spawn(transport, clock, "sn_b", store, tmp_path / "b")
    assert b2._applied_seq.get(a.addr) == 6
    assert b2.read() == a.read()


@pytest.mark.parametrize("store", STORES)
def test_catchup_telemetry_and_stats(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "tl_a", store, tmp_path / "a")
    b = spawn(transport, clock, "tl_b", store)
    a.set_neighbours([b])
    transport.pump()
    a.mutate("add", ["prime", 0])
    a.sync_to_all()
    transport.pump()
    events = []

    def handler(e, meas, meta):
        events.append((e, dict(meas), dict(meta)))

    telemetry.attach(telemetry.CATCHUP_CHUNK, handler)
    telemetry.attach(telemetry.CATCHUP_DONE, handler)
    try:
        for i in range(12):
            a.mutate("add", [i, i])
        a.sync_to_all()
        _lose_inflight(transport, b)
        time.sleep(0.02)
        a.sync_to_all()
        _drive(transport, [a, b])
    finally:
        telemetry.detach(telemetry.CATCHUP_CHUNK, handler)
        telemetry.detach(telemetry.CATCHUP_DONE, handler)
    assert b.read() == a.read()
    roles = {m.get("role") for e, _meas, m in events if e == telemetry.CATCHUP_CHUNK}
    assert roles == {"server", "client"}
    done = [meas for e, meas, _m in events if e == telemetry.CATCHUP_DONE]
    assert len(done) == 1 and done[0]["chunks"] == 1
    assert done[0]["duration_s"] >= 0 and done[0]["horizon_fallback"] == 0
    st = b.stats()["catchup"]
    assert st["chunks_applied"] == 1 and st["rows_applied"] > 0
    assert st["last_duration_s"] >= 0 and st["in_flight"] == 0
    assert st["store"] == store
    served = a.stats()["catchup"]
    assert served["entries_shipped"] > 0 and 0 < served["chunk_fill_ratio"] <= 1


def test_log_chunk_roundtrips_over_tcp():
    t1, t2 = TcpTransport(), TcpTransport()
    try:
        t2.register("sink", None)
        arrays = {"rows": np.arange(8, dtype=np.int32), "key": np.arange(64, dtype=np.uint64).reshape(8, 8)}
        chunk = sync_proto.LogChunkMsg(
            frm="src", to="sink", seq_lo=3, seq_hi=9, more=True, horizon=None,
            slices=[{"buckets": np.arange(8, dtype=np.int64), "arrays": arrays, "payloads": {(1, 2, 3): ("k", "v")}}],
        )
        get = sync_proto.GetLogMsg(frm="src", to="sink", last_seq=3)
        assert t1.send(("sink", t2.endpoint), get)
        assert t1.send(("sink", t2.endpoint), chunk)
        got = []
        deadline = time.monotonic() + 5
        while len(got) < 2 and time.monotonic() < deadline:
            got += t2.drain("sink")
            time.sleep(0.01)
        assert [type(m) for m in got] == [sync_proto.GetLogMsg, sync_proto.LogChunkMsg]
        assert got[0].last_seq == 3
        rt = got[1]
        assert (rt.seq_lo, rt.seq_hi, rt.more, rt.horizon) == (3, 9, True, None)
        assert np.array_equal(rt.slices[0]["arrays"]["key"], arrays["key"])
        assert rt.slices[0]["payloads"] == {(1, 2, 3): ("k", "v")}
    finally:
        t1.close()
        t2.close()


# ---------------------------------------------------------------------------
# past-horizon mode decision


def _lagged_pair(spawn, tmp_path, transport, clock, store="binned", **writer_opts):
    """Prime a (writer, receiver) pair to watermark 4, then lag the
    writer by ops 4..40 with the receiver partitioned."""
    a = spawn(transport, clock, "sx_a", store, tmp_path / "a", segment_bytes=256, compact_every=10**9,
              **writer_opts)
    b = spawn(transport, clock, "sx_b", store)
    a.set_neighbours([b])
    transport.pump()
    for i in range(4):
        a.mutate("add", [i, i])
    a.sync_to_all()
    transport.pump()
    assert b._applied_seq.get(a.addr) == 4
    for i in range(4, 40):
        a.mutate("add", [i, i])
    a.sync_to_all()
    _lose_inflight(transport, b)
    return a, b


@pytest.mark.parametrize("store", STORES)
def test_past_horizon_dominant_suffix_streams_clamped_chunks(spawn, tmp_path, store):
    transport, clock = LocalTransport(), LogicalClock()
    a, b = _lagged_pair(spawn, tmp_path, transport, clock, store,
                        membership_compaction=True, membership_retain=32)
    a.checkpoint()
    horizon = a.stats()["wal"]["horizon"]
    w = b._applied_seq.get(a.addr)
    assert w < horizon < a._seq
    assert a._seq - horizon >= b.catchup_suffix_ratio * (horizon - w)
    time.sleep(0.02)
    before = b.stats()["catchup"]["chunks_applied"]
    a.sync_to_all()
    _drive(transport, [a, b], rounds=30)
    st = b.stats()["catchup"]
    assert st["chunks_applied"] > before
    assert st["horizon_fallbacks"] >= 1
    assert st["in_flight"] == 0
    time.sleep(0.02)
    a.sync_to_all()
    _drive(transport, [a, b], rounds=30)
    assert b.read() == a.read()
    assert b._applied_seq.get(a.addr) == a._seq
    assert b._catchup_walk_floor.get(a.addr) is None


def test_past_horizon_small_suffix_skips_chunks_entirely(spawn, tmp_path):
    transport, clock = LocalTransport(), LogicalClock()
    a, b = _lagged_pair(spawn, tmp_path, transport, clock, membership_compaction=False)
    a.checkpoint()
    horizon = a.stats()["wal"]["horizon"]
    w = b._applied_seq.get(a.addr)
    assert w < horizon and a._seq - horizon == 0
    time.sleep(0.02)
    before = b.stats()["catchup"]["chunks_applied"]
    deadline = time.monotonic() + 10
    while b._applied_seq.get(a.addr) != a._seq:
        assert time.monotonic() < deadline, "no convergence"
        a.sync_to_all()
        moved = _drive(transport, [a, b], rounds=30)
        assert moved, "no progress toward convergence"
        time.sleep(0.02)
    assert b.read() == a.read()
    assert b.stats()["catchup"]["chunks_applied"] == before


def test_catchup_suffix_ratio_knob_gates_the_stream(spawn, tmp_path):
    transport, clock = LocalTransport(), LogicalClock()
    a, b = _lagged_pair(spawn, tmp_path, transport, clock, membership_compaction=True, membership_retain=32)
    b.catchup_suffix_ratio = 10_000.0
    a.checkpoint()
    assert b._applied_seq.get(a.addr) < a.stats()["wal"]["horizon"]
    time.sleep(0.02)
    before = b.stats()["catchup"]["chunks_applied"]
    deadline = time.monotonic() + 10
    while b._applied_seq.get(a.addr) != a._seq:
        assert time.monotonic() < deadline, "no convergence"
        a.sync_to_all()
        moved = _drive(transport, [a, b], rounds=30)
        assert moved, "no progress toward convergence"
        time.sleep(0.02)
    assert b.read() == a.read()
    assert b.stats()["catchup"]["chunks_applied"] == before


@pytest.mark.parametrize("store", STORES)
def test_dense_suffix_fills_a_chunk_to_the_hard_cap(spawn, tmp_path, store):
    """A suffix whose records each touch a quarter of the table goes in
    one chunk up to the hard cap (4 × ``catchup_chunk_rows``), not one
    chunk a record, and the receiver ends with the canonical bytes of a
    walk twin. (A sparse suffix stops at the budget, as in the JAX
    replica: ``test_port_catchup_matches_jax``.)"""
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "ds_a", store, tmp_path / "a", catchup_chunk_rows=16)
    bl = spawn(transport, clock, "ds_log", store, node_id=778)
    bw = spawn(transport, clock, "ds_walk", store, node_id=778, log_shipping=False)
    a.set_neighbours([bl, bw])
    transport.pump()
    a.mutate("add", ["prime", 0])
    a.sync_to_all()
    transport.pump()
    seq0 = a._seq
    assert bl._applied_seq.get(a.addr) == seq0
    for i in range(6):  # 32 keys a record: about 25 of the 64 rows each
        a.mutate_batch("add", [[f"d{i}.{j}", j] for j in range(32)])
    n_rec, touched, seq_hi, more, barrier = a._scan_log_rows(seq0, a._seq)
    assert (n_rec, seq_hi, more, barrier) == (6, a._seq, False, None)
    assert 16 < len(touched) <= 64
    a.sync_to_all()
    _lose_inflight(transport, bl)
    _lose_inflight(transport, bw)
    time.sleep(0.02)
    a.sync_to_all()
    _drive(transport, [a, bl, bw], rounds=16)
    assert bl.read() == bw.read() == a.read()
    assert bl.canonical_state_bytes() == bw.canonical_state_bytes() == a.canonical_state_bytes()
    assert bl.stats()["catchup"]["chunks_applied"] == 1


@pytest.mark.parametrize("store", STORES)
def test_chunk_slice_that_changes_nothing_is_not_logged(spawn, tmp_path, store):
    """A catch-up chunk of rows the receiver holds already (its own,
    back from the peer's log) advances the watermark and mints no seq
    and no record; a chunk that brings news is logged as the JAX replica
    logs it; a late copy of a chunk the watermark covers is skipped."""
    transport, clock = LocalTransport(), LogicalClock()
    a = spawn(transport, clock, "nl_a", store, tmp_path / "a")
    b = spawn(transport, clock, "nl_b", store, tmp_path / "b")
    a.set_neighbours([b])
    b.set_neighbours([a])
    transport.pump()
    a.mutate_batch("add", [[f"k{i}", i] for i in range(40)])
    b.mutate("add", ["b0", 0])  # a learns b's writer id before the chunk
    for _ in range(3):
        a.sync_to_all()
        b.sync_to_all()
        _drive(transport, [a, b])
    assert b.read() == a.read() and b._seq >= 2  # b logged a's rows
    seq, last = a._seq, a._wal.last_seq
    applied = a.stats()["catchup"]["chunks_applied"]

    def chunk_from(server, client):
        # no watermark (as after a restart before any snapshot): the
        # client asks for the server's whole log
        client._applied_seq.pop(server.addr, None)
        client._request_catchup(server.addr)
        for m in transport.drain(server.addr):
            server.handle(m)
        (msg,) = [m for m in transport.drain(client.addr) if isinstance(m, sync_proto.LogChunkMsg)]
        assert msg.slices and msg.seq_lo == 0
        client.handle(msg)
        return msg

    msg = chunk_from(b, a)
    assert (a._seq, a._wal.last_seq) == (seq, last)
    assert a._applied_seq.get(b.addr) == msg.seq_hi == b._seq
    assert a.stats()["catchup"]["chunks_applied"] == applied + 1
    b.mutate("add", ["fresh", 1])
    msg = chunk_from(b, a)
    assert a._seq == a._wal.last_seq > seq
    assert a.read()["fresh"] == 1
    # the same chunk again, as a superseded request's answer arriving
    # late: the watermark covers it, so it is not merged again
    seq, applied = a._seq, a.stats()["catchup"]["chunks_applied"]
    a.handle(msg)
    assert (a._seq, a.stats()["catchup"]["chunks_applied"]) == (seq, applied)


# ---------------------------------------------------------------------------
# the port's catch-up against the JAX package's


def _catchup_script(spawn, pkg, store, tmp_path):
    """One ``LogicalClock`` script in one package: a primed pair, a lag
    (adds, removes, a chunk budget of 8 rows) lost in flight, then the
    catch-up exchange driven message by message."""
    transport = (JTransport if pkg == "jax" else LocalTransport)()
    clock = (JClock if pkg == "jax" else LogicalClock)()
    a = spawn(transport, clock, "cp_a", store, tmp_path / pkg / "a", pkg=pkg, node_id=0xF000000000000005,
              catchup_chunk_rows=8)
    b = spawn(transport, clock, "cp_b", store, tmp_path / pkg / "b", pkg=pkg, node_id=9)
    a.set_neighbours([b])
    transport.pump()
    for i in range(10):
        a.mutate("add", [f"k{i}", i])
    a.sync_to_all()
    transport.pump()
    for i in range(10, 48):
        a.mutate("add", [f"k{i}", [i, "v"]])
    for i in range(0, 5):
        a.mutate("remove", [f"k{i}"])
    a.sync_to_all()
    _lose_inflight(transport, b)
    time.sleep(0.02)
    a.sync_to_all()
    trace = []
    for _ in range(24):
        for r in (b, a):
            for m in transport.drain(r.addr):
                f = {k: getattr(m, k) for k in ("seq_lo", "seq_hi", "more", "horizon", "last_seq", "applied_seq")
                     if hasattr(m, k)}
                if hasattr(m, "slices"):
                    f["rows"] = [np.asarray(s["buckets"]).tolist() for s in m.slices]
                    f["payloads"] = [s["payloads"] for s in m.slices]
                trace.append((r.name, type(m).__name__, f))
                r.handle(m)
    st = {k: v for k, v in b.stats()["catchup"].items() if k != "last_duration_s"}
    served = {k: v for k, v in a.stats()["catchup"].items() if k != "last_duration_s"}
    cols = {c: np.asarray(v).tolist() for c, v in _cols(b).items()}
    return trace, st, served, cols, b.canonical_state_bytes(), dict(b._applied_seq), b.read(), a.read()


@pytest.mark.parametrize("store", STORES)
def test_port_catchup_matches_jax(spawn, tmp_path, store):
    jax_run = _catchup_script(spawn, "jax", store, tmp_path)
    port_run = _catchup_script(spawn, "torch", store, tmp_path)
    trace_j, st_j, served_j, cols_j, canon_j, wm_j, read_j, _ = jax_run
    trace_t, st_t, served_t, cols_t, canon_t, wm_t, read_t, writer_read = port_run
    assert [(n, k) for n, k, _ in trace_t] == [(n, k) for n, k, _ in trace_j]
    assert trace_t == trace_j
    assert sum(k == "LogChunkMsg" for _n, k, _ in trace_t) > 1  # a paced stream
    assert (st_t, served_t) == (st_j, served_j)
    assert cols_t == cols_j
    assert canon_t == canon_j
    assert wm_t == wm_j == {"cp_a": 53}
    assert read_t == read_j == writer_read


def _echo_script(spawn, pkg, store, tmp_path):
    """Two replicas, each with a WAL and a chunk budget of 8 rows: a
    writes, both converge, b checkpoints and crashes, a writes more
    (lost in flight), b restarts, and both open rounds for 12 rounds.
    Returns whether they converged and, after rounds 6 and 12, the
    chunks applied on a and on b and both seqs (each a record in that
    replica's log)."""
    transport = (JTransport if pkg == "jax" else LocalTransport)()
    clock = (JClock if pkg == "jax" else LogicalClock)()
    opts = dict(pkg=pkg, sync_timeout=0.0, max_sync_size=16, catchup_chunk_rows=8)
    a = spawn(transport, clock, "ea", store, tmp_path / pkg / "a", node_id=5, **opts)
    b = spawn(transport, clock, "eb", store, tmp_path / pkg / "b", node_id=6, **opts)
    a.set_neighbours([b])
    b.set_neighbours([a])
    for i in range(8):
        a.mutate_batch("add", [[f"k{i}.{j}", j] for j in range(32)])
    for _ in range(8):
        a.sync_to_all()
        b.sync_to_all()
        transport.pump()
    b.checkpoint()
    b.crash()
    for i in range(8, 16):
        a.mutate_batch("add", [[f"k{i}.{j}", j] for j in range(32)])
    a.sync_to_all()
    _lose_inflight(transport, b)
    b = spawn(transport, clock, "eb", store, tmp_path / pkg / "b", **opts)
    b.set_neighbours([a])
    marks = []
    for rnd in range(12):
        a.sync_to_all()
        b.sync_to_all()
        _drive(transport, [a, b], rounds=6)
        if rnd in (5, 11):
            marks.append((a.stats()["catchup"]["chunks_applied"], b.stats()["catchup"]["chunks_applied"],
                          a._seq, b._seq))
    converged = a.canonical_state_bytes() == b.canonical_state_bytes() and a.read() == b.read()
    return converged, marks


def test_two_wal_replicas_do_not_echo_each_others_logs(spawn, tmp_path):
    """``ROADMAP.md`` §3.6: with a WAL on both sides, the JAX package
    logs every chunk a replica merges as a new record in its own log,
    so its two catch-up streams (the lagging replica streaming the
    writer's log, the writer streaming the lagging replica's log of the
    writer's own rows) feed each other for as long as both run. The
    port logs no chunk slice that changes nothing, so once each side
    has drained the other's log its streams stop: rounds 7-12 apply no
    chunk and log nothing. Both converge either way. (The stream logic
    is store-agnostic; the binned store keeps the JAX side's compiles
    few.)"""
    j_conv, (j_6, j_12) = _echo_script(spawn, "jax", "binned", tmp_path)
    t_conv, (t_6, t_12) = _echo_script(spawn, "torch", "binned", tmp_path)
    assert j_conv and t_conv
    # the reference echoes: chunks and records keep coming on both sides
    assert all(late > early for early, late in zip(j_6, j_12))
    # the port quiesces, having applied chunks on both sides
    assert t_12 == t_6 and t_6[0] >= 1 and t_6[1] >= 1
