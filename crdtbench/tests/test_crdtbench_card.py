"""On the card: every cell at the tiny geometry through the CUDA path
(the roots kernel included) proves correct, and the control fails.
Skips where there is no CUDA device; run on the card with
``python3 -m pytest crdtbench/tests/test_crdtbench_card.py``."""

from __future__ import annotations

import json

import pytest

from crdtbench.tests.tiny import REPO, make_root, run_cell

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, tmp_path, capsys, cell):
    out = run_cell(make_root(tmp_path), capsys, cell, device="cuda")
    assert out["correct"] is True, out["checks"]
    ctl = run_cell(make_root(tmp_path / "ctl"), capsys, cell, device="cuda", control="ts32")
    assert ctl["correct"] is False
