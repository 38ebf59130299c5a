"""Host milliseconds a traced call spends in the program's merge entry,
retries included: the program's ``crdt.merge_into`` spans (around
``models/binned_map.py:tier_retry_merge``) over their count, from the
profiler's trace."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    return spans.per("host_s", "crdt.merge_into", "crdt.merge_into") if spans else None
