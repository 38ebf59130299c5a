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
