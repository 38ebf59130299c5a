"""The comparison that decides ``correct`` fails the control and every
fault a cell can have, planted under the timed path of a tiny run on
the CPU: a merge that returns its state unchanged, half of a delta's
rows left out, an answer altered where it is produced, a delivery
dropped. (A cell runs on one chip and holds its replicas in one stack:
it has no exchange between chips to leave out.)"""

from __future__ import annotations

import dataclasses
import json

import pytest

from crdtbench.tests.tiny import REPO, make_root, run_cell
from delta_crdt_ex_tpu_torch.parallel import batched_sync

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _alter_first_entry(stack):
    """``stack`` with the value hash of lane 0's first alive entry set to
    a value no generated entry has (value hashes are drawn below 2^32),
    or ``stack`` itself where no entry is alive."""
    if hasattr(stack, "words"):
        w = stack.words.clone()
        alive = ((w[0, ..., 7] >> 16) != 0).nonzero()
        if not len(alive):
            return stack
        b, s = alive[0].tolist()
        w[0, b, s, 4] = 0x5EED
        return dataclasses.replace(stack, words=w)
    alive = stack.alive[0].nonzero()
    if not len(alive):
        return stack
    v = stack.valh.clone()
    b, s = alive[0].tolist()
    v[0, b, s] = 0x5EED
    return dataclasses.replace(stack, valh=v)


def _half_rows(sl):
    """``sl`` with the second half of its rows turned into padding."""
    n = int((sl.rows >= 0).sum())
    rows = sl.rows.clone()
    rows[(n + 1) // 2:] = -1
    return sl._replace(rows=rows)


def _fault(kind):
    real = batched_sync.fanout_merge_into
    calls = [0]

    def broken(stack, sl, **kw):
        calls[0] += 1
        if kind == "unchanged":
            return stack, None, 0
        if kind == "half":
            return real(stack, _half_rows(sl), **kw)
        new, res, n = real(stack, sl, **kw)
        if kind == "altered":
            return _alter_first_entry(new), res, n
        if kind == "dropped":  # one delivery in three is lost
            return (stack if calls[0] % 3 == 0 else new), res, n
        raise ValueError(kind)

    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "dropped"])
def test_fault_fails(tmp_path, capsys, monkeypatch, cell, kind):
    monkeypatch.setattr(batched_sync, "fanout_merge_into", _fault(kind))
    out = run_cell(make_root(tmp_path), capsys, cell, seconds=1.0)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_ts32_fails(tmp_path, capsys, cell):
    out = run_cell(make_root(tmp_path), capsys, cell, control="ts32")
    assert out["correct"] is False
    assert out["checks"]["calls_roots_off"]["value"] > 0
    assert out["checks"]["entries_off"]["value"] > 0 or cell.startswith("fullbench")

