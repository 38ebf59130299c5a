"""The share of the merge entry's attempts that ran as a CUDA graph
replay in the traced calls: the program's ``crdt.merge.replay`` spans
over its ``crdt.merge.attempt`` spans, in %. A program without the
graphed entry (no ``parallel/merge_graph.py``) gives none."""

import importlib.util

from crdtbench import program_spans

GRAPHS = "delta_crdt_ex_tpu_torch.parallel.merge_graph"


def read(run):
    spans = program_spans.of_run(run)
    attempts = spans.count.get("crdt.merge.attempt", 0) if spans else 0
    if not attempts or importlib.util.find_spec(GRAPHS) is None:
        return None
    return 100.0 * spans.count.get("crdt.merge.replay", 0) / attempts
