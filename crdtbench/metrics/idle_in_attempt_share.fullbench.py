"""``idle_in_attempt_share`` (the idle time inside the program's
``crdt.merge.attempt`` spans, a share of the window's) in the cells
that report no ``merges_per_s`` end to end."""

from crdtbench import program_spans


def read(run):
    spans = program_spans.of_run(run)
    if not spans or spans.idle_total_s <= 0:
        return None
    return 100.0 * spans.idle_s.get("crdt.merge.attempt", 0.0) / spans.idle_total_s
