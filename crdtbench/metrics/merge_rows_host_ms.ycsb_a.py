"""Host milliseconds a merge on the receiving replica takes in the traced
steps: the program's ``crdt.merge`` (one received slice) and
``crdt.merge_group`` (a coalesced group) spans on the driver's thread,
which pumps both replicas' ingress, over their count."""

from crdtbench import serve_spans


def read(run):
    spans = serve_spans.of_run(run)
    if not spans:
        return None
    n = spans.count.get("crdt.merge", 0) + spans.count.get("crdt.merge_group", 0)
    s = spans.host_s.get("crdt.merge", 0.0) + spans.host_s.get("crdt.merge_group", 0.0)
    return s / n * 1e3 if n else None
