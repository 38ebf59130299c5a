"""Host milliseconds a traced call blocks in the merge entry's flag
reads (the program's ``crdt.merge.flags`` spans, one a merge attempt),
the time its host waits for the device, over the calls
(``crdt.merge_into`` spans), from the profiler's trace."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    return spans.per("host_s", "crdt.merge.flags", "crdt.merge_into") if spans else None
