"""Kill-tier escalations of the merge entry a thousand traced calls: the
program's ``crdt.merge.grow.kill`` spans (each the kill budget ×4 before
a whole merge again) over its ``crdt.merge_into`` spans, counted in the
profiler's trace."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    calls = spans.count.get("crdt.merge_into", 0) if spans else 0
    return spans.count.get("crdt.merge.grow.kill", 0) / calls * 1000.0 if calls else None
