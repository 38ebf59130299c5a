"""``attempt_enqueue_ms`` (host ms a merge attempt, the program's
``crdt.merge.attempt`` spans) in the cells that report no
``merges_per_s`` end to end."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    return spans.per("host_s", "crdt.merge.attempt", "crdt.merge.attempt") if spans else None
