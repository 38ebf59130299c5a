"""The YCSB cell on the CPU at a tiny size (2^10 records, 4 clients, a
second of rounds, the replicas pumped on ``--device cpu``): the
generator against YCSB's own definitions, the driver against the plain
reference with ``correct`` true, four faults planted in the program,
each read false (a dropped acknowledged update, a stale read, a wrong
LWW winner, replicas left unequal), and the ``ts32`` control read
false."""

from __future__ import annotations

import json

import numpy as np
import pytest

from crdtbench import ycsb_gen
from crdtbench.tests.tiny import make_root, run_cell
from delta_crdt_ex_tpu_torch.runtime import replica as replica_mod, serve
from delta_crdt_ex_tpu_torch.runtime.replica import Replica

CELL = "ycsb_a.1m"
CONFIG = "crdtbench/configs/ycsb-a-2r-1m.json"
M64 = (1 << 64) - 1


def _root(tmp_path):
    """A checkout at the tiny size: 2^10 records on the CPU, 2 clients
    on each replica, a short warm-up."""
    root = make_root(tmp_path)
    cfg = json.loads((root / CONFIG).read_text())
    assert cfg["cpu_recordcount"] == 1 << 10
    mix = root / "crdtbench/traffic/ycsb_a_32c.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "clients_per_replica": 2, "warmup_s": 0.3}))
    return root


def _fnv_java(n: int) -> int:
    """``Utils.fnvhash64`` with Python integers and Java's long arithmetic."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= n & 0xFF
        n >>= 8
        h = (h * 1099511628211) & M64
    if h >= 1 << 63:  # a negative long: Math.abs
        h = (-(h - (1 << 64))) & M64
    return h


def test_keys_are_ycsb_hashed_key_names():
    assert ycsb_gen.key_names(1) == ["user6284781860667377211"]  # YCSB's first loaded key
    nums = [0, 1, 2, 255, 256, 999_999, 2**31 + 7, 2**40 + 3]
    assert ycsb_gen.fnvhash64(np.array(nums, np.uint64)).tolist() == [_fnv_java(n) for n in nums]
    names = ycsb_gen.key_names(1 << 10)
    assert len(set(names)) == 1 << 10 and all(k.startswith("user") for k in names)


def test_mix_hot_keys_records_and_seed():
    rng = np.random.default_rng(2**35 + 11)
    reads = ycsb_gen.operations(rng, 200_000, 0.5)
    assert abs(reads.mean() - 0.5) < 0.005
    z = ycsb_gen.ScrambledZipfian(1 << 10)
    keys = z.draw(rng, 200_000)
    assert keys.min() >= 0 and keys.max() < 1 << 10
    counts = np.bincount(keys, minlength=1 << 10)
    # item 0 of the zipfian draw alone is 1/zetan of the draws; it lands on
    # fnvhash64(0) mod (recordcount + 1), scattered, not on record 0
    hot = int(ycsb_gen.fnvhash64(np.array([0], np.uint64))[0] % np.uint64((1 << 10) + 1))
    assert counts.argmax() == hot
    assert 1 / ycsb_gen.ZETAN - 0.003 < counts[hot] / len(keys) < 1 / ycsb_gen.ZETAN + 0.02
    top = np.sort(counts)[::-1]
    # the ten hottest zipfian ranks alone are about 11% of the draws
    assert top[:10].sum() / len(keys) > 0.10
    recs = ycsb_gen.records(rng, 64, 10, 100)
    assert all(len(r) == 10 and all(len(f) == 100 and f.isascii() and f.decode().isprintable() for f in r) for r in recs)
    a, b = (ycsb_gen.records(np.random.default_rng(7), 8, 10, 100) for _ in range(2))
    assert a == b and a != ycsb_gen.records(np.random.default_rng(8), 8, 10, 100)
    za, zb = (ycsb_gen.ScrambledZipfian(1 << 20).draw(np.random.default_rng(9), 1000) for _ in range(2))
    assert np.array_equal(za, zb)


def test_driver_against_the_reference(tmp_path, capsys):
    out = run_cell(_root(tmp_path), capsys, CELL, seconds=1.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"reads_off", "acks_off", "replicas_unequal", "read_off", "feed_off", "entries_off"}
    assert set(out["metrics"]) == {"device_mem_gib", "setup_s"}


def _engage_on_first_commit(monkeypatch) -> dict:
    """A switch that turns on at the first front-door commit (after the
    load and its anti-entropy), for faults of the served traffic."""
    state = {"on": False}
    real = Replica.apply_ops

    def apply_ops(self, ops, timeout=None):
        if len(ops) < self.MAX_BATCH:
            state["on"] = True
        return real(self, ops, timeout)

    monkeypatch.setattr(Replica, "apply_ops", apply_ops)
    return state


def _drop_acked_update(monkeypatch):
    """Every third front-door commit loses its last op; its ticket is
    acknowledged all the same."""
    real = Replica.apply_ops
    calls = [0]

    def apply_ops(self, ops, timeout=None):
        if len(ops) < self.MAX_BATCH:
            calls[0] += 1
            if calls[0] % 3 == 0:
                ops = ops[:-1]
        return real(self, ops, timeout)

    monkeypatch.setattr(Replica, "apply_ops", apply_ops)


def _stale_read(monkeypatch):
    """A front door that keeps serving the first snapshot it materialised
    (the loaded map), whatever its replica committed since."""
    real = serve.Frontdoor.snapshot
    first: dict = {}

    def snapshot(self):
        return first.setdefault(self.name, real(self))

    monkeypatch.setattr(serve.Frontdoor, "snapshot", snapshot)


def _wrong_winner(monkeypatch):
    """Once the traffic runs, a receiver takes remote writes as 2^40 µs
    older than they are, so its own older writes outrank them."""
    on = _engage_on_first_commit(monkeypatch)
    real = replica_mod.slice_from_wire

    def slice_from_wire(a, device):
        sl = real(a, device)
        return sl._replace(ts=sl.ts - sl.alive.long() * (1 << 40)) if on["on"] else sl

    monkeypatch.setattr(replica_mod, "slice_from_wire", slice_from_wire)


def _unequal(monkeypatch):
    """Once the traffic runs, replica 1 drops what replica 0 sends it."""
    on = _engage_on_first_commit(monkeypatch)
    real = Replica._handle_entries

    def handle_entries(self, msg, log_noop=True):
        if on["on"] and self.name == "ycsb-1":
            return 0
        return real(self, msg, log_noop)

    monkeypatch.setattr(Replica, "_handle_entries", handle_entries)


@pytest.mark.parametrize("plant", [_drop_acked_update, _stale_read, _wrong_winner, _unequal])
def test_planted_fault_reads_false(tmp_path, capsys, monkeypatch, plant):
    plant(monkeypatch)
    out = run_cell(_root(tmp_path), capsys, CELL, seconds=1.0)
    assert out["correct"] is False, out["checks"]


def test_control_ts32_reads_false(tmp_path, capsys):
    out = run_cell(_root(tmp_path), capsys, CELL, seconds=0.5, control="ts32")
    assert out["correct"] is False
    assert out["checks"]["entries_off"]["value"] > 0
