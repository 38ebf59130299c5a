"""Spans and the profiler's trace, reduced to what the per-layer metrics
read.

The drivers wrap each call into a layer of the program in a span
(:class:`Spans`): a ``torch.profiler.record_function`` named
``crdtbench.<layer>`` when the run is traced, nothing otherwise. A
traced run profiles a steady stretch of the window (:class:`Tracer`),
exports the trace as JSON into a temporary directory and reduces it
(:func:`reduce_trace`): every device operation (kernel, copy, set) is
tied through its launch's correlation id to the host span and the
innermost torch op that launched it; the device's busy time is the union
of their intervals inside the traced window, and each idle gap is
labelled with the span and the op the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time

import torch

WINDOW = "crdtbench.window"
PREFIX = "crdtbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """``spans("merge")`` is a context: a named profiler range when
    ``on``, a no-op otherwise (so an untraced run pays nothing)."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if self.on:
            return torch.profiler.record_function(PREFIX + name)
        return contextlib.nullcontext()


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    span_device_s: dict  # span name (without the prefix) -> device seconds launched in it
    kernel_s: dict  # device op name -> [seconds of each run]
    op_s: dict  # launching torch op (or kernel name) -> device seconds
    idle_s: dict  # "span:op" -> idle seconds
    steps: int  # calls or rounds inside the traced window

    def kernel_mean_s(self, substring: str) -> float | None:
        runs = [d for name, ds in self.kernel_s.items() if substring in name for d in ds]
        return sum(runs) / len(runs) if runs else None

    def breakdown(self, top: int = 10) -> dict:
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(self.op_s), "idle_gaps": pick(self.idle_s)}


class Tracer:
    """The profiler over a stretch of the window: :meth:`start`, the
    steps, :meth:`stop` (each synchronises the device), then
    :meth:`reduce`."""

    def __init__(self, cuda: bool):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.cuda = cuda
        self.prof = torch.profiler.profile(activities=acts)
        self.range = None
        self.steps = 0
        self.running = False

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.prof.__enter__()
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        self.running = True

    def stop(self):
        if not self.running:
            return
        self._sync()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.running = False

    def reduce(self) -> TraceSummary:
        with tempfile.TemporaryDirectory(prefix="crdtbench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return reduce_trace(events, self.steps)


def _innermost(intervals: list, queries: list) -> list:
    """For each query time, the name of the innermost of the properly
    nested ``(start, end, name)`` intervals that holds it, or None."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out = [None] * len(queries)
    stack: list = []
    k = 0
    for qi in sorted(range(len(queries)), key=queries.__getitem__):
        t = queries[qi]
        while k < len(ivs) and ivs[k][0] <= t:
            while stack and stack[-1][1] < ivs[k][0]:
                stack.pop()
            stack.append(ivs[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[qi] = stack[-1][2] if stack else None
    return out


def reduce_trace(events: list, steps: int) -> TraceSummary:
    wins = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not wins:
        raise RuntimeError("the trace holds no crdtbench.window range")
    win = wins[0]
    tid = win.get("tid")
    host = lambda e: e.get("ph") == "X" and e.get("tid") == tid
    spans = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
        for e in events
        if host(e) and e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX) and e["name"] != WINDOW
    ]
    # the window runs from the window range's start (or the first span's)
    # to the end of its range or of its last span, whichever is later
    w0 = min([float(win["ts"])] + [a for a, _, _ in spans])
    w1 = max([float(win["ts"]) + float(win["dur"])] + [b for _, b, _ in spans])
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events if host(e) and e.get("cat") == "cpu_op"]
    launch = {
        e["args"]["correlation"]: float(e["ts"])
        for e in events
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
    }
    dev = [
        (float(e["ts"]), float(e["dur"]), e["name"], launch.get(e.get("args", {}).get("correlation")))
        for e in events
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
    ]
    dev = [d for d in dev if d[3] is None or w0 <= d[3] <= w1 or w0 <= d[0] <= w1]
    at = [d[3] if d[3] is not None else d[0] for d in dev]
    span_of = _innermost(spans, at)
    op_of = _innermost(ops, at)

    span_device_s: dict = {}
    kernel_s: dict = {}
    op_s: dict = {}
    for (ts, dur, name, _), sp, op in zip(dev, span_of, op_of):
        s = dur / 1e6
        span_device_s[sp or "unattributed"] = span_device_s.get(sp or "unattributed", 0.0) + s
        kernel_s.setdefault(name, []).append(s)
        key = op or name
        op_s[key] = op_s.get(key, 0.0) + s

    # device busy time: the union of device intervals inside the window
    ivs = sorted((max(ts, w0), min(ts + dur, w1)) for ts, dur, _, _ in dev if ts < w1 and ts + dur > w0)
    busy = 0.0
    gaps = []
    cur = w0
    for a, b in ivs:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    mids = [(a + b) / 2 for a, b in gaps]
    g_span = _innermost(spans, mids)
    g_op = _innermost(ops, mids)
    idle_s: dict = {}
    for (a, b), sp, op in zip(gaps, g_span, g_op):
        label = f"{sp or 'between spans'}:{op or 'python'}"
        idle_s[label] = idle_s.get(label, 0.0) + (b - a) / 1e6
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy / 1e6,
        span_device_s=span_device_s,
        kernel_s=kernel_s,
        op_s=op_s,
        idle_s=idle_s,
        steps=steps,
    )


class SetupClock:
    """``mark(name)`` ends a set-up phase: it synchronises the device and
    records the seconds since the previous mark under ``name``."""

    def __init__(self, sync):
        self.sync = sync
        self.phases: dict = {}
        self.t = time.perf_counter()

    def __call__(self, name: str):
        self.sync()
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now

