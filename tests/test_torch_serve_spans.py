"""The served path's spans and the replica's sync counters, on the CPU:
under ``runtime/tracing.trace`` (every thread recorded) the front
door's ``crdt.serve.read`` / ``.publish`` / ``.commit``, the sync
tick's ``crdt.sync.round`` with ``crdt.sync.walk`` and
``crdt.sync.extract`` inside it, ``crdt.feed``, and
``merge_rows_into``'s ``crdt.merge.flags`` / ``crdt.merge.grow.gid`` /
``crdt.merge.grow.bins`` are each recorded on their path; none is
entered without a profiler; ``stats()["sync"]`` counts a deterministic
script's rounds, capped rounds and shipped entries; and a traced run
leaves the same canonical bytes and feeds as an untraced one."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, tracing
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport
from delta_crdt_ex_tpu_torch.utils.hashing import key_hash64

SERVE = ("crdt.serve.read", "crdt.serve.publish", "crdt.serve.commit")
SYNC = ("crdt.sync.round", "crdt.sync.walk", "crdt.sync.extract")
MERGE = ("crdt.merge.flags", "crdt.merge.grow.gid", "crdt.merge.grow.bins")


def _keys_in_buckets(num_buckets: int, per_bucket: dict) -> list:
    """Key terms ``k<i>``, ``per_bucket[b]`` of them in each bucket ``b``."""
    want = dict(per_bucket)
    out = []
    i = 0
    while any(want.values()):
        term = f"k{i}"
        b = key_hash64(term) & (num_buckets - 1)
        if want.get(b):
            want[b] -= 1
            out.append(term)
        i += 1
    return out


def _script(feeds: list) -> list:
    """A deterministic two-replica script through the front doors and the
    pumped anti-entropy: writes on both sides, reads, a receiver whose
    writer table (1 slot) and bins (4 slots) must grow in
    ``merge_rows_into``. Returns the replicas (stopped by the caller)."""
    t = LocalTransport()
    opts = dict(transport=t, threaded=False, device="cpu", sync_timeout=1e9, tree_depth=2)
    a = tdc.start_link(tdc.AWLWWMap, name="sp-a", node_id=11, clock=LogicalClock(), capacity=64,
                       on_diffs=feeds[0].extend, **opts)
    b = tdc.start_link(tdc.AWLWWMap, name="sp-b", node_id=22, clock=LogicalClock(), capacity=16,
                       replica_capacity=1, on_diffs=feeds[1].extend, **opts)
    a.set_neighbours([b])
    b.set_neighbours([a])
    da, db = a.frontdoor(journal=True), b.frontdoor(journal=True)
    for i in range(24):
        da.mutate("add", [f"x{i}", i])
    db.mutate("add", ["y", "b-side"])
    for _ in range(3):
        a.sync_to_all()
        b.sync_to_all()
        t.pump()
    da.mutate("add", ["x0", "again"])
    assert da.read_keys(["x0", "y"]) == {"x0": "again", "y": "b-side"}
    assert db.read_keys(["x1"]) == {"x1": 1}
    for _ in range(3):
        a.sync_to_all()
        b.sync_to_all()
        t.pump()
    return [a, b]


def _stop(reps):
    for r in reps:
        r.stop()


def test_each_new_span_is_recorded_on_its_path(tmp_path):
    logdir = tmp_path / "trace"
    with tracing.trace(str(logdir), cuda=False):
        reps = _script([[], []])
    try:
        doc = json.loads((logdir / tracing.TRACE_FILE).read_text())
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        names = {e["name"] for e in spans}
        for name in (*SERVE, *SYNC, *MERGE, "crdt.feed", "crdt.merge"):
            assert name in names, name
        # the walk and the extraction nest inside a round
        rounds = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans if e["name"] == "crdt.sync.round"]
        for e in spans:
            if e["name"] in ("crdt.sync.walk", "crdt.sync.extract"):
                a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                assert any(r0 - 0.5 <= a and b <= r1 + 0.5 for r0, r1 in rounds), e["name"]
        # the commit runs on the admission worker, not the test's thread
        main = {e["tid"] for e in spans if e["name"] == "crdt.serve.read"}
        assert {e["tid"] for e in spans if e["name"] == "crdt.serve.commit"} - main
    finally:
        _stop(reps)


def test_no_new_span_is_entered_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert not tracing.enabled()
    _stop(_script([[], []]))
    assert not [n for n in entered if n.startswith("crdt.")]


def test_sync_counters_follow_a_logical_clock_script():
    """Five keys in five of eight buckets on A, ``max_sync_size`` 2: A's
    pushes are cut on the two ticks that start with more than two
    pending buckets (5, then 3: walk transfers move no push cursor),
    not on the third (1) nor the fourth (none). Every tick is one round
    a neighbour; the shipped entries equal what the wire carried."""
    t = LocalTransport()
    opts = dict(transport=t, threaded=False, device="cpu", sync_timeout=1e9, tree_depth=3, max_sync_size=2,
                capacity=64, clock=LogicalClock())
    a = tdc.start_link(tdc.AWLWWMap, name="sc-a", node_id=5, **opts)
    b = tdc.start_link(tdc.AWLWWMap, name="sc-b", node_id=6, **{**opts, "clock": LogicalClock()})
    wire = {a.addr: 0, b.addr: 0}
    send = t.send

    def counting(addr, msg):
        if isinstance(msg, sync_proto.EntriesMsg):
            wire[msg.frm] += len(msg.payloads)
        return send(addr, msg)

    t.send = counting
    try:
        a.set_neighbours([b])
        b.set_neighbours([a])
        t.pump()
        assert a.stats()["sync"] == {"rounds": 1, "capped_rounds": 0, "keys_sent": 0}
        a.mutate_batch("add", [[k, 1] for k in _keys_in_buckets(8, {0: 1, 1: 1, 2: 1, 3: 1, 4: 1})])
        for _ in range(4):
            a.sync_to_all()
            b.sync_to_all()
            t.pump()
        sa, sb = a.stats()["sync"], b.stats()["sync"]
        assert (sa["rounds"], sa["capped_rounds"]) == (5, 2)
        assert (sb["rounds"], sb["capped_rounds"]) == (5, 0)
        assert sa["keys_sent"] == wire[a.addr] >= 5
        assert sb["keys_sent"] == wire[b.addr]
        assert b.canonical_state_bytes() == a.canonical_state_bytes()
    finally:
        t.send = send
        _stop([a, b])


def test_tracing_changes_no_result(tmp_path):
    plain, traced = [[], []], [[], []]
    reps = _script(plain)
    want = [r.canonical_state_bytes() for r in reps]
    _stop(reps)
    with tracing.trace(str(tmp_path / "trace"), cuda=False):
        reps = _script(traced)
    try:
        assert [r.canonical_state_bytes() for r in reps] == want
        assert traced == plain and all(plain)
        assert np.array_equal(np.frombuffer(want[0], np.uint8), np.frombuffer(want[1], np.uint8))
    finally:
        _stop(reps)


@pytest.mark.parametrize("field", ["rounds", "capped_rounds", "keys_sent"])
def test_sync_counters_start_at_zero(field):
    r = tdc.start_link(tdc.AWLWWMap, name=f"zero-{field}", threaded=False, device="cpu", capacity=64,
                       tree_depth=2, transport=LocalTransport())
    try:
        assert r.stats()["sync"][field] == 0
    finally:
        r.stop()
