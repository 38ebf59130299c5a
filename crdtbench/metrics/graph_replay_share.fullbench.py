"""``graph_replay_share`` (the merge entry's attempts that ran as a CUDA
graph replay, in % of the traced attempts) in the cells that report no
``merges_per_s`` end to end."""

import importlib.util

from crdtbench import program_spans

GRAPHS = "delta_crdt_ex_tpu_torch.parallel.merge_graph"


def read(run):
    spans = program_spans.of_run(run)
    attempts = spans.count.get("crdt.merge.attempt", 0) if spans else 0
    if not attempts or importlib.util.find_spec(GRAPHS) is None:
        return None
    return 100.0 * spans.count.get("crdt.merge.replay", 0) / attempts
