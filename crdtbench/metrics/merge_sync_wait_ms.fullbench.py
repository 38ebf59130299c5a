"""``merge_sync_wait_ms`` (host ms a traced call blocks in the program's
``crdt.merge.flags`` spans) in the cells that report no
``merges_per_s`` end to end."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    return spans.per("host_s", "crdt.merge.flags", "crdt.merge_into") if spans else None
