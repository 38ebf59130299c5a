"""The share of the traced window's idle device time whose gaps fall
inside a merge attempt (the program's ``crdt.merge.attempt`` spans,
which hold the gap's middle), from the profiler's trace: how much of
the idle device waits on the merge body's host enqueue."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    if not spans or spans.idle_total_s <= 0:
        return None
    return 100.0 * spans.idle_s.get("crdt.merge.attempt", 0.0) / spans.idle_total_s
