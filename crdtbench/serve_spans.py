"""The program's spans on the served path in a traced run, for the
per-layer metrics of the YCSB cells.

:mod:`crdtbench.program_spans` reduces a trace only where it holds the
fan-in's merge entry (``crdt.merge_into``), which the replica's merges
(``models/binned_map.py:merge_rows_into``) do not run through. Here
every ``crdt.*`` span on the window's thread inside the window (the
traced steps' anti-entropy and reads: the front doors' commits run on
their admission workers, which the harness's profiler does not record)
is reduced to its count and host seconds, read from the run's profiler
as :func:`crdtbench.program_spans.of_run` reads it. A trace with no such
span gives None.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from crdtbench import program_spans
from crdtbench.trace import WINDOW


@dataclasses.dataclass
class Spans:
    count: dict  # span name -> spans on the window's thread
    host_s: dict  # span name -> host seconds


def reduce_spans(events: list) -> Spans | None:
    """The ``crdt.*`` spans on the window's thread of a Chrome trace's
    events, or None where there is no window or no such span."""
    wins = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not wins:
        return None
    win = wins[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    count: dict = {}
    host_s: dict = {}
    for e in events:
        if (e.get("ph") != "X" or e.get("tid") != win.get("tid") or e.get("cat") != "user_annotation"
                or not e["name"].startswith(program_spans.PROGRAM)):
            continue
        a = float(e["ts"])
        if w0 <= a <= w1:
            count[e["name"]] = count.get(e["name"], 0) + 1
            host_s[e["name"]] = host_s.get(e["name"], 0.0) + float(e["dur"]) / 1e6
    return Spans(count, host_s) if count else None


#: ``(profiler, its Spans)`` of the last run reduced
_LAST: tuple | None = None


def of_run(run) -> Spans | None:
    """The served path's spans in the traced stretch of the run whose
    metric is being read, or None; a fault in reading them is written to
    standard error, and gives None."""
    global _LAST
    if run.trace is None:
        return None
    try:
        tracer = program_spans._calling_tracer()
        if tracer is None:
            return None
        if _LAST is not None and _LAST[0] is tracer.prof:
            return _LAST[1]
        spans = reduce_spans(program_spans.profile_events(tracer.prof))
    except Exception as err:  # a reader reports nothing rather than fail the run
        print(f"crdtbench: the served path's spans could not be read: {err!r}", file=sys.stderr)
        return None
    _LAST = (tracer.prof, spans)
    if spans is not None:
        print(f"crdtbench: served_spans {json.dumps(spans.count)}", file=sys.stderr)
        print(f"crdtbench: served_host_s {json.dumps(spans.host_s)}", file=sys.stderr)
    return spans
