"""The port's ``runtime/tracing.py``: ``annotate`` spans are reusable and
survive exceptions; ``trace`` writes a Chrome trace on the CPU that
holds the replica's ``crdt.flush`` and ``crdt.merge_group`` spans from a
live replica (and ``crdt.merge`` from a lone slice), the admission
worker thread's spans included; ``trace`` stops on
an exception so the next one can start; ``profile_mutations`` works with
and without a trace directory."""

from __future__ import annotations

import json

import pytest
import torch

import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu_torch.runtime import tracing
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

SMALL = dict(capacity=64, tree_depth=4, sync_timeout=1e9, threaded=False, device="cpu")


def _span_names(logdir) -> set:
    doc = json.loads((logdir / tracing.TRACE_FILE).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return {e.get("name") for e in events}


def test_annotate_is_a_reusable_span():
    span = tracing.annotate
    with span("test.span"):
        x = torch.arange(8).sum()
    assert int(x) == 28
    with span("outer"), span("inner"):
        pass
    with span("test.span"):  # the same name again
        pass


def test_annotate_survives_exceptions():
    with pytest.raises(RuntimeError):
        with tracing.annotate("test.boom"):
            raise RuntimeError("boom")
    with tracing.annotate("after.boom"):
        pass


def test_trace_writes_replica_spans(tmp_path):
    """Three senders push disjoint slices into one receiver whose drain
    merges them as one group (``crdt.merge_group``); a lone slice takes
    ``crdt.merge``; local batches flush under ``crdt.flush``."""
    t = LocalTransport()
    recv = tdc.start_link(tdc.AWLWWMap, transport=t, name="tr-recv", **SMALL)
    senders = [tdc.start_link(tdc.AWLWWMap, transport=t, name=f"tr-s{i}", **SMALL) for i in range(3)]
    try:
        for s in senders:
            s.set_neighbours([recv])
        logdir = tmp_path / "trace"
        with tracing.trace(str(logdir)) as prof:
            for i, s in enumerate(senders):
                # one key each, in distinct buckets, so the slices coalesce
                s.mutate("add", [f"k{i}", i])
                s.sync_to_all()
            recv.process_pending()
            senders[0].mutate("add", ["lone", 1])
            senders[0].sync_to_all()
            recv.process_pending()
        assert recv.stats()["ingress"]["coalesce_depth_hist"].get(3) == 1
        assert recv.read() == {"k0": 0, "k1": 1, "k2": 2, "lone": 1}
        names = _span_names(logdir)
        assert {"crdt.flush", "crdt.merge_group", "crdt.merge"} <= names
        assert any(e.key == "crdt.flush" for e in prof.key_averages())
    finally:
        recv.stop()
        for s in senders:
            s.stop()


def test_trace_records_the_admission_workers_spans(tmp_path):
    """A front door commits on its admission worker thread: the trace
    holds that thread's ``crdt.flush`` span too."""
    rep = tdc.start_link(tdc.AWLWWMap, transport=LocalTransport(), name="tr-fd", **SMALL)
    try:
        fd = tdc.frontdoor(rep)
        fd.mutate("add", ["warm", 0])
        logdir = tmp_path / "fd"
        with tracing.trace(str(logdir)):
            fd.mutate("add", ["k", 1])
        assert "crdt.flush" in _span_names(logdir)
        assert fd.read_keys(["k"]) == {"k": 1}
    finally:
        rep.stop()


def test_trace_stops_on_exception(tmp_path):
    with pytest.raises(RuntimeError):
        with tracing.trace(str(tmp_path / "t2")):
            raise RuntimeError("mid-trace")
    assert (tmp_path / "t2" / tracing.TRACE_FILE).exists()
    with tracing.trace(str(tmp_path / "t3")):  # a fresh trace starts
        torch.ones(4).sum()
    assert (tmp_path / "t3" / tracing.TRACE_FILE).exists()


@pytest.mark.parametrize("with_dir", [False, True])
def test_profile_mutations(tmp_path, with_dir):
    crdt = tdc.start_link(tdc.AWLWWMap, transport=LocalTransport(), name="prof", **SMALL)
    try:
        logdir = str(tmp_path / "prof") if with_dir else None
        out = tracing.profile_mutations(crdt, n=16, logdir=logdir)
        assert out["mutations"] == 16 and out["total_s"] > 0
        assert out["per_op_us"] == pytest.approx(out["total_s"] / 16 * 1e6)
        assert out["trace_dir"] == logdir
        assert len(crdt.read()) == 16  # hibernate flushed them
        assert crdt.hibernate() == "ok" and crdt.ping() == "ok"
        if with_dir:
            assert "crdt.flush" in _span_names(tmp_path / "prof")
    finally:
        crdt.stop()


# --- spans only while a profiler runs, and the merge entry's spans

STEPS = (
    "crdt.merge.view", "crdt.merge.insert_grid", "crdt.merge.insert_select", "crdt.merge.insert_scatter",
    "crdt.merge.insert_aux", "crdt.merge.kill_rows", "crdt.merge.kill_apply", "crdt.merge.assemble",
)


def _no_ranges(monkeypatch):
    """Make entering a profiler or an NVTX range raise."""

    def refuse(*args, **kwargs):
        raise AssertionError("a range was entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range", refuse)


def _removal_stack(packed: bool):
    """A one-lane stack of one writer's map (64 buckets, 4 entries each,
    bins of 8) and that writer's slice over every bucket: its 4 entries
    removed and 6 new ones added. The merge steps the kill tier (64
    flagged rows over a budget of 16) and compacts (the bins overflow)
    in its first retry, then doubles the bins (compaction frees
    nothing): three attempts."""
    import numpy as np

    from delta_crdt_ex_tpu_torch.ops.binned import slice_from_wire
    from delta_crdt_ex_tpu_torch.parallel import batched_sync
    from delta_crdt_ex_tpu_torch.utils.synth import build_state

    L, B, gid, old, new = 64, 8, 0xF00D, 4, 6
    keys = np.array([b + L * j for j in range(1, old + 1) for b in range(L)], np.uint64)
    one, _ = build_state(gid, keys, L, B, 4, device="cpu")
    stack = batched_sync.stack_states([one])
    if packed:
        stack = batched_sync.pack_states(stack)
    rows = np.arange(L)
    fresh = (rows[:, None] + L * np.arange(old + 1, old + new + 1)[None, :]).astype(np.uint64)
    sl = dict(
        rows=rows.astype(np.int32),
        key=np.zeros((L, B), np.uint64),
        valh=np.zeros((L, B), np.uint32),
        ts=np.zeros((L, B), np.int64),
        node=np.zeros((L, B), np.int32),
        ctr=np.zeros((L, B), np.uint32),
        alive=np.zeros((L, B), bool),
        ctx_rows=np.full((L, 1), old + new, np.uint32),
        ctx_lo=np.zeros((L, 1), np.uint32),
        ctx_gid=np.array([gid], np.uint64),
    )
    sl["key"][:, :new] = fresh
    sl["valh"][:, :new] = (fresh & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sl["ts"][:, :new] = 10_000 + np.arange(L * new).reshape(L, new)
    sl["ctr"][:, :new] = np.arange(old + 1, old + new + 1)
    sl["alive"][:, :new] = True
    return stack, slice_from_wire(sl, "cpu"), L * new


def _merge(stack, sl):
    from delta_crdt_ex_tpu_torch.parallel import batched_sync

    out, res, retries = batched_sync.fanout_merge_into(stack, sl)
    return out, res, retries


def _spans(logdir) -> list:
    """The ``crdt.*`` ranges of the trace, as ``(start, end, name)``."""
    doc = json.loads((logdir / tracing.TRACE_FILE).read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith("crdt.")
    )


def _inside(child, parents) -> bool:
    eps = 0.5  # microseconds of rounding in the trace's timestamps
    return any(p[0] - eps <= child[0] and child[1] <= p[1] + eps for p in parents)


def test_annotate_enters_no_range_without_a_profiler(monkeypatch):
    _no_ranges(monkeypatch)
    assert not tracing.enabled()
    with tracing.annotate("crdt.merge"):
        x = torch.arange(4).sum()
    assert int(x) == 6


@pytest.mark.parametrize("packed", [False, True])
def test_merge_path_enters_no_range_without_a_profiler(monkeypatch, packed):
    stack, sl, added = _removal_stack(packed)
    _no_ranges(monkeypatch)
    out, res, retries = _merge(stack, sl)
    assert retries == 2 and int(res.n_inserted.sum()) == added


def test_replica_paths_enter_no_range_without_a_profiler(monkeypatch):
    t = LocalTransport()
    recv = tdc.start_link(tdc.AWLWWMap, transport=t, name="nr-recv", **SMALL)
    senders = [tdc.start_link(tdc.AWLWWMap, transport=t, name=f"nr-s{i}", **SMALL) for i in range(2)]
    try:
        for s in senders:
            s.set_neighbours([recv])
        _no_ranges(monkeypatch)
        for i, s in enumerate(senders):
            s.mutate("add", [f"k{i}", i])  # crdt.flush
            s.sync_to_all()
        recv.process_pending()  # crdt.merge_group
        senders[0].mutate("add", ["lone", 1])
        senders[0].sync_to_all()
        recv.process_pending()  # crdt.merge
        assert recv.read() == {"k0": 0, "k1": 1, "lone": 1}
    finally:
        recv.stop()
        for s in senders:
            s.stop()


def test_enabled_follows_the_profiler(tmp_path):
    assert tracing.enabled() is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.enabled() is True
    assert tracing.enabled() is False
    with tracing.trace(str(tmp_path / "t"), cuda=False):
        assert tracing.enabled() is True
    assert tracing.enabled() is False


def test_merge_entry_spans_nest_under_a_profiler(tmp_path, monkeypatch):
    """Under a trace the fan-in's call is one ``crdt.merge_into``; each
    attempt holds the eight step spans; the flag reads and the
    escalations sit beside the attempts, inside the call. No NVTX range
    is entered."""
    stack, sl, _ = _removal_stack(packed=False)
    monkeypatch.setattr(torch.cuda.nvtx, "range", lambda *a, **k: (_ for _ in ()).throw(AssertionError("nvtx")))
    with tracing.trace(str(tmp_path / "m"), cuda=False):
        _, _, retries = _merge(stack, sl)
    spans = _spans(tmp_path / "m")
    by = {}
    for sp in spans:
        by.setdefault(sp[2], []).append(sp)
    calls, attempts = by["crdt.merge_into"], by["crdt.merge.attempt"]
    assert len(calls) == 1
    assert len(attempts) == 1 + retries == 3
    assert len(by["crdt.merge.flags"]) == len(attempts)
    assert len(by["crdt.merge.grow.kill"]) >= 1 and len(by["crdt.merge.compact"]) == 1
    assert len(by["crdt.merge.grow.bins"]) == 1
    for name in STEPS:
        assert len(by[name]) == len(attempts), name
        assert all(_inside(sp, attempts) for sp in by[name]), name
    for name in ("crdt.merge.attempt", "crdt.merge.flags", "crdt.merge.grow.kill", "crdt.merge.compact"):
        assert all(_inside(sp, calls) for sp in by[name]), name
    for name in ("crdt.merge.flags", "crdt.merge.grow.kill", "crdt.merge.compact", "crdt.merge.grow.bins"):
        assert not any(_inside(sp, attempts) for sp in by[name]), name


def test_packed_merge_carries_the_same_step_names(tmp_path):
    stack, sl, _ = _removal_stack(packed=True)
    with tracing.trace(str(tmp_path / "p"), cuda=False):
        _, _, retries = _merge(stack, sl)
    names = [sp[2] for sp in _spans(tmp_path / "p")]
    assert names.count("crdt.merge.attempt") == 1 + retries
    for name in STEPS:
        assert names.count(name) == 1 + retries, name
