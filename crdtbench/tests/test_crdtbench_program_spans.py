"""The program's spans in a traced run (``crdtbench/program_spans.py``):
the benchmark's own reduction of a fixed trace is unchanged by them; a
fixed trace with nested program spans gives the stated counts, self
times and idle attribution; the profile's events reduce as its Chrome
export does; a traced run of each tiny cell reads the new metrics, and
a program without the spans gives none and still a result."""

from __future__ import annotations

import contextlib
import json

import pytest

from crdtbench import program_spans
from crdtbench.tests.tiny import REPO, make_root, run_cell
from crdtbench.trace import Tracer, reduce_trace

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = {
    "propagation.30k": ("merge_host_ms", "merge_sync_wait_ms", "attempt_enqueue_ms", "idle_in_attempt_share"),
    "fullbench.30k": (
        "merge_host_ms.fullbench", "merge_sync_wait_ms.fullbench", "attempt_enqueue_ms.fullbench",
        "idle_in_attempt_share.fullbench", "kill_retries_per_kcall.fullbench",
    ),
}


def _x(name, cat, a, b, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one traced call (µs): the harness's spans, three torch ops, four
# launches and their device operations on another thread
BASE = [
    _x("crdtbench.window", "user_annotation", 0, 100),
    _x("crdtbench.deliver", "user_annotation", 0, 5),
    _x("crdtbench.merge", "user_annotation", 5, 80),
    _x("crdtbench.roots", "user_annotation", 80, 90),
    _x("crdtbench.sync", "user_annotation", 90, 100),
    _x("aten::add", "cpu_op", 2, 3),
    _x("aten::copy_", "cpu_op", 20, 30),
    _x("aten::where", "cpu_op", 62, 70),
    _x("cudaMemcpyAsync", "cuda_runtime", 2.5, 2.7, corr=3),
    _x("cudaLaunchKernel", "cuda_runtime", 21, 22, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 63, 63.5, corr=2),
    _x("cudaLaunchKernel", "cuda_runtime", 85, 85.5, corr=4),
    _x("Memcpy HtoD", "gpu_memcpy", 3, 4, tid=7, corr=3),
    _x("copy_kernel", "kernel", 25, 35, tid=7, corr=1),
    _x("where_kernel", "kernel", 64, 68, tid=7, corr=2),
    _x("batched_roots_kernel", "kernel", 86, 88, tid=7, corr=4),
]
# the program's spans inside the harness's merge span: two attempts, a
# flag read after each, one kill-tier step between them; and a span on
# another thread, which is not the window's
PROGRAM = [
    _x("crdt.merge_into", "user_annotation", 6, 79),
    _x("crdt.merge.attempt", "user_annotation", 7, 40),
    _x("crdt.merge.view", "user_annotation", 8, 15),
    _x("crdt.merge.insert_scatter", "user_annotation", 16, 38),
    _x("crdt.merge.flags", "user_annotation", 41, 50),
    _x("crdt.merge.grow.kill", "user_annotation", 51, 52),
    _x("crdt.merge.attempt", "user_annotation", 53, 75),
    _x("crdt.merge.view", "user_annotation", 54, 60),
    _x("crdt.merge.insert_scatter", "user_annotation", 61, 74),
    _x("crdt.merge.flags", "user_annotation", 76, 78),
    _x("crdt.merge_into", "user_annotation", 10, 20, tid=2),
]


@pytest.mark.parametrize("events", [BASE, BASE + PROGRAM], ids=["bench-only", "with-program-spans"])
def test_reduce_trace_is_unchanged_by_program_spans(events):
    s = reduce_trace(events, 1)
    assert s.window_s == 0.0001
    assert s.busy_s == 1.7e-05
    assert s.span_device_s == {"deliver": 1e-06, "merge": 1.4000000000000001e-05, "roots": 2e-06}
    assert s.kernel_s == {
        "Memcpy HtoD": [1e-06], "copy_kernel": [1e-05], "where_kernel": [4e-06], "batched_roots_kernel": [2e-06],
    }
    assert s.op_s == {"aten::add": 1e-06, "aten::copy_": 1e-05, "aten::where": 4e-06, "batched_roots_kernel": 2e-06}
    assert s.idle_s == {"deliver:python": 3e-06, "merge:python": 6.8e-05, "sync:python": 1.2e-05}
    assert s.steps == 1
    assert s.breakdown() == {
        "device_ops": [["aten::copy_", 1e-05], ["aten::where", 4e-06], ["batched_roots_kernel", 2e-06],
                       ["aten::add", 1e-06]],
        "idle_gaps": [["merge:python", 6.8e-05], ["sync:python", 1.2e-05], ["deliver:python", 3e-06]],
    }


def test_no_program_spans_reduce_to_none():
    assert program_spans.reduce_program_spans(BASE) is None


def test_nested_program_spans():
    p = program_spans.reduce_program_spans(BASE + PROGRAM)
    us = lambda d: {k: round(v * 1e6, 6) for k, v in d.items()}
    assert p.count == {
        "crdt.merge_into": 1, "crdt.merge.attempt": 2, "crdt.merge.view": 2, "crdt.merge.insert_scatter": 2,
        "crdt.merge.flags": 2, "crdt.merge.grow.kill": 1,
    }
    assert us(p.host_s) == {
        "crdt.merge_into": 73, "crdt.merge.attempt": 55, "crdt.merge.view": 13, "crdt.merge.insert_scatter": 35,
        "crdt.merge.flags": 11, "crdt.merge.grow.kill": 1,
    }
    assert us(p.self_s) == {
        "crdt.merge_into": 6, "crdt.merge.attempt": 7, "crdt.merge.view": 13, "crdt.merge.insert_scatter": 35,
        "crdt.merge.flags": 11, "crdt.merge.grow.kill": 1,
    }
    # the copy and the where launched inside the insert scatters; the
    # memcpy and the roots kernel outside every program span
    assert us(p.device_s) == {"crdt.merge.insert_scatter": 14}
    # gaps (µs): 0-3 deliver, 4-25 view, 35-64 flags, 68-86 flags, 88-100 sync
    assert round(p.idle_total_s * 1e6, 6) == 83
    assert us(p.idle_s) == {
        "crdt.merge_into": 68, "crdt.merge.attempt": 21, "crdt.merge.view": 21, "crdt.merge.flags": 47,
    }
    assert us(p.gaps) == {
        "deliver:python": 3, "crdt.merge.view:python": 21, "crdt.merge.flags:python": 47, "sync:python": 12,
    }
    b = p.breakdown()
    assert [k for k, _ in b["program_gaps"]] == [
        "crdt.merge.flags:python", "crdt.merge.view:python", "sync:python", "deliver:python",
    ]
    assert [k for k, _ in b["program_device"]] == ["crdt.merge.insert_scatter"]
    assert p.per("host_s", "crdt.merge.flags", "crdt.merge_into") == pytest.approx(0.011)
    assert p.per("host_s", "crdt.merge.flags", "crdt.nothing") is None


class _Untyped:
    """A Kineto event as a torch without ``activity_type`` gives it."""

    def __init__(self, e):
        self._e = e

    def __getattr__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return getattr(self._e, name)


@pytest.mark.parametrize("typed", [True, False], ids=["activity_type", "no-activity_type"])
def test_profile_events_reduce_as_the_chrome_export(tmp_path, typed):
    """On the CPU: the profile's Kineto events, in the trace's form, give
    the Chrome export's reductions, with or without the events' own
    categories (the card's check is the same)."""
    import torch

    from crdtbench.trace import Spans
    from delta_crdt_ex_tpu_torch.parallel import batched_sync
    from delta_crdt_ex_tpu_torch.utils.synth import build_state, interval_delta_stream

    import numpy as np

    keys = np.random.default_rng(5).integers(1, 1 << 63, size=512, dtype=np.uint64)
    one, nxt = build_state(7, keys, 64, 32, 4, device="cpu")
    stack = batched_sync.stack_states([one])
    slices, _ = interval_delta_stream(7, np.random.default_rng(6), 3, 40, 64, next_ctr=nxt, device="cpu")
    spans = Spans(True)
    tracer = Tracer(False)
    tracer.start()
    for sl in slices:
        with spans("merge"):
            stack, _, _ = batched_sync.fanout_merge_into(stack, sl)
        with spans("sync"):
            torch.ones(2).sum()
    tracer.stop()
    if typed:
        converted = program_spans.profile_events(tracer.prof)
    else:
        converted = program_spans.kineto_events(_Untyped(e) for e in tracer.prof.profiler.kineto_results.events())
    path = tmp_path / "trace.json"
    tracer.prof.export_chrome_trace(str(path))
    exported = json.loads(path.read_text())["traceEvents"]
    # the export rounds its timestamps: a gap's middle may fall on the
    # other side of an op's edge, so the spans holding it are compared,
    # not the op that labels it
    spans_of = lambda labels: {k.split(":")[0] for k in labels}
    a, b = reduce_trace(exported, 3), reduce_trace(converted, 3)
    assert b.window_s == pytest.approx(a.window_s, abs=1e-6) and spans_of(b.idle_s) == spans_of(a.idle_s)
    pa, pb = program_spans.reduce_program_spans(exported), program_spans.reduce_program_spans(converted)
    assert pa.count == pb.count and pa.count["crdt.merge_into"] == 3
    assert pb.host_s == pytest.approx(pa.host_s, rel=1e-3, abs=1e-6)
    assert pb.idle_total_s == pytest.approx(pa.idle_total_s, abs=1e-6) and spans_of(pb.gaps) == spans_of(pa.gaps)
    assert {e["cat"] for e in converted} == {"cpu_op", "user_annotation"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(tmp_path, capsys, cell):
    out = run_cell(make_root(tmp_path), capsys, cell, seconds=2.0, trace=1)
    assert out["correct"] is True
    metrics = out["metrics"]
    for name in NEW[cell]:
        assert metrics[name]["value"] is not None, name
    suffix = ".fullbench" if cell == "fullbench.30k" else ""
    spans = program_spans._LAST[1]
    calls = spans.count["crdt.merge_into"]
    attempts = spans.count["crdt.merge.attempt"] / calls
    assert attempts >= 1
    assert metrics["attempt_enqueue_ms" + suffix]["value"] * attempts <= metrics["merge_host_ms" + suffix]["value"]
    assert 0 <= metrics["idle_in_attempt_share" + suffix]["value"] <= 100
    if suffix:
        assert metrics["kill_retries_per_kcall.fullbench"]["value"] > 0  # 32-row removals over a budget of 16


@pytest.mark.parametrize("cell", CELLS)
def test_a_program_without_the_spans_reports_none_of_them(tmp_path, capsys, monkeypatch, cell):
    """As the parent commit's program: no ``crdt.*`` span, so the new
    metrics are left out of the line, and the run still gives one."""
    from delta_crdt_ex_tpu_torch.runtime import tracing

    monkeypatch.setattr(tracing, "annotate", lambda name: contextlib.nullcontext())
    out = run_cell(make_root(tmp_path), capsys, cell, seconds=1.0, trace=1)
    assert out["correct"] is True
    assert not set(NEW[cell]) & set(out["metrics"])
    assert out["metrics"]  # the accepted per-layer metrics are still read
