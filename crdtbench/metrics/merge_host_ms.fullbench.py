"""``merge_host_ms`` (host ms a traced call spends in the program's
``crdt.merge_into`` span) in the cells that report no ``merges_per_s``
end to end."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    return spans.per("host_s", "crdt.merge_into", "crdt.merge_into") if spans else None
