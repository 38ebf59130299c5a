"""``graph_replay_share`` and its ``.fullbench`` twin: on a fixed trace
the replayed attempts over all attempts; 0 where the program has the
graphed entry and replayed nothing; none without attempts or without the
graphed entry (as the parent commit's program); and a traced tiny run of
each cell on the CPU, where no graph is captured, reads 0."""

from __future__ import annotations

import json

import pytest

from crdtbench import program_spans
from crdtbench.run import load_module
from crdtbench.tests.test_crdtbench_program_spans import BASE, PROGRAM, _x
from crdtbench.tests.tiny import HARNESS, REPO, make_root, run_cell

CELLS = {"propagation.30k": "graph_replay_share", "fullbench.30k": "graph_replay_share.fullbench"}
# the first attempt replayed (inside its attempt span), the second eager
REPLAY = [_x("crdt.merge.replay", "user_annotation", 8, 9)]


class _Run:
    trace = object()


@pytest.fixture(params=sorted(CELLS.values()))
def reader(request):
    return load_module(HARNESS / "metrics" / f"{request.param}.py")


@pytest.mark.parametrize(
    "events, want", [(BASE + PROGRAM + REPLAY, 50.0), (BASE + PROGRAM, 0.0), (BASE, None)],
    ids=["one-of-two-replayed", "none-replayed", "no-attempts"],
)
def test_replay_share_on_a_fixed_trace(monkeypatch, reader, events, want):
    monkeypatch.setattr(program_spans, "of_run", lambda run: program_spans.reduce_program_spans(events))
    assert reader.read(_Run()) == want


def test_a_program_without_the_graphed_entry_gives_none(monkeypatch, reader):
    monkeypatch.setattr(program_spans, "of_run", lambda run: program_spans.reduce_program_spans(BASE + PROGRAM + REPLAY))
    monkeypatch.setattr(reader.importlib.util, "find_spec", lambda name: None)
    assert reader.read(_Run()) is None


def test_the_metrics_are_declared_for_their_cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for cell, name in CELLS.items():
        assert declared[name]["workloads"] == [cell] and declared[name]["layer"] == "merge entry"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_cpu_run_replays_nothing(tmp_path, capsys, cell):
    out = run_cell(make_root(tmp_path), capsys, cell, seconds=1.0, trace=1)
    assert out["correct"] is True
    assert out["metrics"][CELLS[cell]]["value"] == 0.0
