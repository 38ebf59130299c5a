"""The program's own spans in a traced run, for the per-layer metrics
that read them.

While a profiler runs, the program records ``crdt.*`` ranges
(``delta_crdt_ex_tpu_torch/runtime/tracing.py``): around its merge entry
(``crdt.merge_into``), each merge attempt, each flag read, each tier
escalation, and the steps of the merge body. :func:`reduce_program_spans`
reduces the profiler's trace to them, on the window's thread and with
the window, the device operations and the idle gaps taken exactly as
:func:`crdtbench.trace.reduce_trace` takes them: for each span name its
count, host seconds, self seconds (less its program child spans),
device seconds launched with it as the innermost program span, and the
idle seconds of the gaps whose middle it holds; and the idle gaps
labelled ``"<innermost program span>:<op>"`` (the benchmark span where
no program span holds the gap).

A metric's reader gets the run's reduced trace, which holds no program
span, so :func:`of_run` finds the run's :class:`crdtbench.trace.Tracer`
among the frames that called the reader and reduces its profile's
events (:func:`profile_events`), once a run. It writes the spans'
counts (``program_spans``: the retries by reason among them) and the
two breakdowns (``program_gaps``, ``program_device``) to standard
error. A program with no ``crdt.merge_into`` span gives None, so its
readers report nothing.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys

from torch.autograd import DeviceType

from crdtbench.trace import DEVICE_CATS, LAUNCH_CATS, PREFIX, WINDOW, Tracer, _innermost

#: the prefix of the program's span names
PROGRAM = "crdt."
#: the program's span around one call of its merge entry
ENTRY = "crdt.merge_into"
_CPU = DeviceType.CPU


@dataclasses.dataclass
class ProgramSpans:
    count: dict  # span name -> spans on the window's thread
    host_s: dict  # span name -> host seconds
    self_s: dict  # span name -> host seconds less its program child spans
    device_s: dict  # span name -> device seconds launched with it the innermost program span
    idle_s: dict  # span name -> idle seconds of the gaps whose middle it holds
    gaps: dict  # "<innermost program span or benchmark span>:<op>" -> idle seconds
    idle_total_s: float  # every idle gap of the window

    def per(self, field: str, name: str, per: str) -> float | None:
        """``field`` of ``name`` in ms for each ``per`` span, or None
        where the trace holds no ``per`` span."""
        n = self.count.get(per, 0)
        return getattr(self, field).get(name, 0.0) / n * 1e3 if n else None

    def breakdown(self, top: int = 10) -> dict:
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"program_gaps": pick(self.gaps), "program_device": pick(self.device_s)}


def _enclosing(intervals: list, queries: list) -> list:
    """For each query time, the names of every one of the properly
    nested ``(start, end, name)`` intervals that holds it, outermost
    first."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out: list = [()] * len(queries)
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
        out[qi] = tuple(iv[2] for iv in stack if iv[0] <= t <= iv[1])
    return out


def _self_seconds(spans: list) -> dict:
    """Each span's duration less what its direct children cover (spans
    on one thread nest properly), summed by name, in seconds."""
    out: dict = {}
    stack: list = []  # [end, name, duration, children's µs]
    for a, b, name in sorted(spans, key=lambda iv: (iv[0], -iv[1])):
        while stack and stack[-1][0] <= a:
            end, nm, dur, kids = stack.pop()
            out[nm] = out.get(nm, 0.0) + (dur - kids) / 1e6
        if stack:
            stack[-1][3] += b - a
        stack.append([b, name, b - a, 0.0])
    while stack:
        end, nm, dur, kids = stack.pop()
        out[nm] = out.get(nm, 0.0) + (dur - kids) / 1e6
    return out


def reduce_program_spans(events: list) -> ProgramSpans | None:
    """The program's spans in a Chrome trace (``traceEvents``), or None
    where the window's thread holds no ``crdt.merge_into`` span."""
    wins = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not wins:
        return None
    win = wins[0]
    tid = win.get("tid")
    host = lambda e: e.get("ph") == "X" and e.get("tid") == tid
    notes = [e for e in events if host(e) and e.get("cat") == "user_annotation"]
    ivl = lambda e, name: (float(e["ts"]), float(e["ts"]) + float(e["dur"]), name)
    bench = [ivl(e, e["name"][len(PREFIX):]) for e in notes if e["name"].startswith(PREFIX) and e["name"] != WINDOW]
    prog = [ivl(e, e["name"]) for e in notes if e["name"].startswith(PROGRAM)]
    if not any(name == ENTRY for _, _, name in prog):
        return None
    # the window, the device operations and the gaps as reduce_trace takes them
    w0 = min([float(win["ts"])] + [a for a, _, _ in bench])
    w1 = max([float(win["ts"]) + float(win["dur"])] + [b for _, b, _ in bench])
    ops = [ivl(e, e["name"]) for e in events if host(e) and e.get("cat") == "cpu_op"]
    launch = {
        e["args"]["correlation"]: float(e["ts"])
        for e in events
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
    }
    dev = [
        (float(e["ts"]), float(e["dur"]), launch.get(e.get("args", {}).get("correlation")))
        for e in events
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
    ]
    dev = [d for d in dev if d[2] is None or w0 <= d[2] <= w1 or w0 <= d[0] <= w1]

    count: dict = {}
    host_s: dict = {}
    for a, b, name in prog:
        count[name] = count.get(name, 0) + 1
        host_s[name] = host_s.get(name, 0.0) + (b - a) / 1e6
    device_s: dict = {}
    at = [d[2] if d[2] is not None else d[0] for d in dev]
    for (_, dur, _), sp in zip(dev, _innermost(prog, at)):
        if sp is not None:
            device_s[sp] = device_s.get(sp, 0.0) + dur / 1e6

    ivs = sorted((max(ts, w0), min(ts + dur, w1)) for ts, dur, _ in dev if ts < w1 and ts + dur > w0)
    gaps = []
    cur = w0
    for a, b in ivs:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < w1:
        gaps.append((cur, w1))
    mids = [(a + b) / 2 for a, b in gaps]
    idle_s: dict = {}
    labels: dict = {}
    for (a, b), held, sp, op in zip(gaps, _enclosing(prog, mids), _innermost(bench, mids), _innermost(ops, mids)):
        s = (b - a) / 1e6
        for name in set(held):
            idle_s[name] = idle_s.get(name, 0.0) + s
        label = f"{held[-1] if held else sp or 'between spans'}:{op or 'python'}"
        labels[label] = labels.get(label, 0.0) + s
    return ProgramSpans(
        count=count,
        host_s=host_s,
        self_s=_self_seconds(prog),
        device_s=device_s,
        idle_s=idle_s,
        gaps=labels,
        idle_total_s=sum(b - a for a, b in gaps) / 1e6,
    )


#: the names of the device's synchronisation records, which the trace
#: files under ``cuda_sync`` and no device operation
SYNC_NAMES = ("Context Sync", "Stream Sync", "Event Sync", "Stream Wait Event")
#: calls into the CUDA API: ``cudaLaunchKernel``, ``cuLaunchKernelEx``
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def _category(e, annotations: set) -> str:
    """An event's category in the trace's terms. A torch without
    ``activity_type`` on its events: a host event linked to a torch op,
    or named for a call into the CUDA API (``cuda…``, ``cu…``), is a
    launch (``cuda_runtime``), a torch op (``ns::name``) a ``cpu_op``,
    an annotation a ``user_annotation``, anything else the profiler's
    own ``overhead``; a device event a ``kernel``, unless it is an
    annotation's range on the device or a synchronisation record."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if e.device_type() == _CPU:
        if e.is_user_annotation():
            return "user_annotation"
        if e.linked_correlation_id() > 0 or _RUNTIME.match(name):
            return "cuda_runtime"
        return "cpu_op" if "::" in name else "overhead"
    if e.is_user_annotation() or name in annotations:
        return "gpu_user_annotation"
    return "cuda_sync" if name in SYNC_NAMES else "kernel"


def kineto_events(events) -> list:
    """Kineto events (``profiler.kineto_results.events()``) in the Chrome
    trace's form: ``ph``, ``cat``, ``name``, ``ts`` and ``dur`` in µs,
    ``tid``, ``args.correlation``."""
    events = list(events)
    annotations = {e.name() for e in events if e.device_type() == _CPU and e.is_user_annotation()}
    return [
        {
            "ph": "X",
            "cat": _category(e, annotations),
            "name": e.name(),
            "ts": e.start_ns() / 1e3,
            "dur": e.duration_ns() / 1e3,
            "tid": e.start_thread_id(),
            "args": {"correlation": e.correlation_id()},
        }
        for e in events
    ]


def profile_events(prof) -> list:
    """A stopped ``torch.profiler.profile``'s events in the Chrome trace's
    form, read from its Kineto results: the profile can be exported as a
    trace only once, and the harness has done so."""
    return kineto_events(prof.profiler.kineto_results.events())


#: ``(profiler, its ProgramSpans)`` of the last run reduced
_LAST: tuple | None = None


def _calling_tracer() -> Tracer | None:
    """The harness's tracer, a local of a frame that called the reader
    (the run's ``main``), or None."""
    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if isinstance(v, Tracer):
                return v
        f = f.f_back
    return None


def of_run(run) -> ProgramSpans | None:
    """The program's spans in the traced stretch of the run whose metric
    is being read (``run`` is the reader's argument), or None; a fault
    in reading them is written to standard error, and gives None."""
    global _LAST
    if run.trace is None:
        return None
    try:
        tracer = _calling_tracer()
        if tracer is None:
            return None
        if _LAST is not None and _LAST[0] is tracer.prof:
            return _LAST[1]
        spans = reduce_program_spans(profile_events(tracer.prof))
    except Exception as err:  # a reader reports nothing rather than fail the run
        print(f"crdtbench: the program's spans could not be read: {err!r}", file=sys.stderr)
        return None
    _LAST = (tracer.prof, spans)
    if spans is not None:
        print(f"crdtbench: program_spans {json.dumps(spans.count)}", file=sys.stderr)
        for key, top in spans.breakdown().items():
            print(f"crdtbench: {key} {json.dumps(top)}", file=sys.stderr)
    return spans
