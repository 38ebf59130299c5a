"""Every cell of ``BENCHMARK.json`` runs end to end at a tiny geometry on
the port's CPU path, proves correct against the plain reference, and
reports the metrics its entries name; a mix and a metric added as files
alone run without an edit."""

from __future__ import annotations

import json

import pytest

from crdtbench.tests.tiny import REPO, make_root, run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _e2e_for(cell: str) -> set:
    return {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_reports_its_metrics(tmp_path, capsys, cell):
    out = run_cell(make_root(tmp_path), capsys, cell)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == _e2e_for(cell)
    assert all(v["value"] > 0 for k, v in out["metrics"].items() if k != "device_mem_gib")
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_per_layer_metrics(tmp_path, capsys, cell):
    out = run_cell(make_root(tmp_path), capsys, cell, seconds=2.0, trace=1)
    assert out["correct"] is True
    names = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    assert set(out["metrics"]) <= names
    # what needs no device trace is read on the CPU too
    host = {m["name"] for m in BENCH["per_layer"]
            if cell in m["workloads"] and m["source"] in ("host_clock", "program_counter")}
    assert host and host <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(tmp_path):
    import numpy as np

    from crdtbench import gen

    root = make_root(tmp_path)
    cfg = json.loads((root / "crdtbench/configs/fullbench-2r-30k.json").read_text())
    mix = json.loads((root / "crdtbench/traffic/add_remove_30k.json").read_text())
    a, b = (gen.cycle_traffic(cfg, mix, np.random.default_rng(2**40 + 3)) for _ in range(2))
    assert np.array_equal(a.key, b.key) and np.array_equal(a.ctr0, b.ctr0) and np.array_equal(a.valh, b.valh)
    assert len(a.wires) == 2 * a.groups == 16
    for wa, wb in zip(a.wires, b.wires):
        assert all(np.array_equal(wa[k], wb[k]) for k in wa)
    c = gen.cycle_traffic(cfg, mix, np.random.default_rng(2**40 + 4))
    assert [w["rows"].shape for w in c.wires] == [w["rows"].shape for w in a.wires]
    assert not np.array_equal(a.key, c.key)


def test_a_mix_and_a_metric_added_as_files_alone(tmp_path, capsys):
    root = make_root(tmp_path)
    (root / "crdtbench/traffic/add_remove_64.json").write_text(
        json.dumps({"kind": "add_remove_cycles", "cycle_keys": 64, "warmup_cycles": 1, "trace_steps": 2})
    )
    (root / "crdtbench/metrics/cycles_traced.py").write_text(
        "def read(run):\n    return float(run.trace.steps) if run.trace is not None else None\n"
    )
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fullbench.64", "config": "fullbench-2r-30k", "traffic": "add_remove_64",
                               "chips": 1, "why": "throwaway"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("fullbench.64")
    bench["per_layer"].append({"name": "cycles_traced", "unit": "cycles", "better": "higher",
                               "source": "device_trace", "layer": "merge entry", "moves": "merges_per_s",
                               "workloads": ["fullbench.64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell(root, capsys, "fullbench.64")
    assert out["correct"] is True and "merges_per_s" in out["metrics"]
    traced = run_cell(root, capsys, "fullbench.64", seconds=1.0, trace=1)
    assert traced["metrics"]["cycles_traced"]["value"] == 2


def test_no_cuda_device_means_no_result(tmp_path, capsys):
    import torch

    from crdtbench import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], root=make_root(tmp_path))
    assert rc != 0
    assert capsys.readouterr().out == ""
