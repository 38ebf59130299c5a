"""Host milliseconds a merge attempt spends enqueueing the merge body:
the program's ``crdt.merge.attempt`` spans over their count, from the
profiler's trace (an attempt holds no device sync; the flag read that
follows it is ``merge_sync_wait_ms``)."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    return spans.per("host_s", "crdt.merge.attempt", "crdt.merge.attempt") if spans else None
