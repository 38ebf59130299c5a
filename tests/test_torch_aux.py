"""PyTorch port vs JAX package: the auxiliary subsystems
(``tests/test_aux.py``): ``profile_mutations``, ``SYNC_DONE`` counts,
interval checkpointing, ``gc()`` pruning, ``FileStorage`` across
processes and the rejected foreign layout.

Each case runs on the JAX package and on the port (``Side``) and checks
on each what the JAX test checks; reads and canonical bytes agree. The
``FileStorage`` case rehydrates the port's files in a child interpreter
whose import system refuses JAX and the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from delta_crdt_ex_tpu.runtime.storage import FileStorage as JFileStorage
from delta_crdt_ex_tpu.runtime.tracing import profile_mutations as j_profile
from delta_crdt_ex_tpu_torch.runtime.storage import FileStorage as TFileStorage
from delta_crdt_ex_tpu_torch.runtime.tracing import profile_mutations as t_profile
from tests.test_torch_lattice import jax_compiles_released  # noqa: F401 (autouse)
from tests.test_torch_runtime_property import NODE_IDS, assert_twins, both

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def sides():
    pair = both()
    yield pair
    for side in pair:
        side.close()


def test_profile_mutations(sides):
    for side, profile in zip(sides, (j_profile, t_profile)):
        c = side.mk()
        out = profile(c, n=20)
        assert out["mutations"] == 20 and out["total_s"] > 0
        assert len(c.read()) == 20
    assert_twins(*sides)


def test_telemetry_sync_done_counts(sides):
    streams = []
    for side in sides:
        events: list = []
        handler = lambda _e, m, md, events=events: events.append((m["keys_updated_count"], md["name"]))
        side.telemetry.attach(side.telemetry.SYNC_DONE, handler)
        try:
            c = side.mk(name="telem")
            c.mutate("add", ["a", 1])
            c.mutate("add", ["a", 1])  # the same value, a new dot: an internal change
            c.mutate("remove", ["missing"])  # no internal change
        finally:
            side.telemetry.detach(side.telemetry.SYNC_DONE, handler)
        assert [n for n, name in events if name == "telem"] == [1, 1, 0]
        streams.append(events)
    assert streams[1] == streams[0]


def test_interval_checkpointing_rehydrates(sides):
    for side in sides:
        store = side.MemoryStorage()
        c = side.mk(
            threaded=True, name="ickpt", storage_module=store, storage_mode="interval",
            checkpoint_interval=0.05, sync_interval=0.02,
        )
        c.mutate("add", ["k", "v"])
        deadline = time.monotonic() + 5
        while store.read("ickpt") is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert store.read("ickpt") is not None, (side.pkg, "interval checkpoint never fired")
        c.stop()
        side.replicas.remove(c)
        c2 = side.mk(name="ickpt", storage_module=store, node_id=c.node_id)
        assert c2.read() == {"k": "v"}
    j, t = sides
    assert t.replicas[0].canonical_state_bytes() == j.replicas[0].canonical_state_bytes()


def test_gc_prunes_dead_payloads(sides):
    for side in sides:
        c = side.mk()
        for i in range(10):
            c.mutate("add", [f"k{i}", i])
        for i in range(5):
            c.mutate("remove", [f"k{i}"])
        assert len(c._payloads) >= 10  # dead dots still held
        c.gc()
        assert len(c._payloads) == 5
        assert len(c._key_terms) == 5
        assert c.read() == {f"k{i}": i for i in range(5, 10)}
    j, t = sides
    assert set(t.replicas[0]._payloads) == set(j.replicas[0]._payloads)
    assert_twins(*sides)


CHILD = r"""
import json, sys


class _Refuse:
    # the JAX package and JAX itself must never load in this process
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "delta_crdt_ex_tpu"):
            raise ImportError(f"{name} is refused in this process")
        return None


sys.meta_path.insert(0, _Refuse())
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.storage import FileStorage
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

c = tdc.start_link(tdc.AWLWWMap, threaded=False, transport=LocalTransport(), clock=LogicalClock(),
                   storage_module=FileStorage(sys.argv[1]), name="file_store", capacity=64,
                   tree_depth=6, device="cpu", node_id=int(sys.argv[2]), sync_timeout=1e9)
read = c.read()
c.mutate("add", ["k3", 3])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "delta_crdt_ex_tpu"))
print(json.dumps({"node_id": c.node_id, "read": repr(sorted(read.items(), key=repr)),
                  "bytes": c.canonical_state_bytes().hex(), "bad": bad}))
"""


def test_file_storage_rehydrates_across_processes(tmp_path, sides):
    """A replica whose process is gone rehydrates node id and state from
    its ``FileStorage`` directory in a fresh interpreter that loads only
    the port; its next write gives the bytes the JAX replica gives after
    the same rehydrate."""
    want = {("tuple", "key"): {"v": 1}, "k2": b"bytes"}
    dirs = {}
    for side, FS in zip(sides, (JFileStorage, TFileStorage)):
        dirs[side.pkg] = str(tmp_path / side.pkg)
        c = side.mk(storage_module=FS(dirs[side.pkg]), name="file_store")
        c.mutate("add", [("tuple", "key"), {"v": 1}])
        c.mutate("add", ["k2", b"bytes"])
        side.transport.unregister(c.addr)  # the crash: no goodbye sync
        side.replicas.remove(c)
    j = sides[0]
    jc = j.mk(storage_module=JFileStorage(dirs["jax"]), name="file_store", clock=j.Clock())
    assert jc.node_id == NODE_IDS[0] and jc.read() == want
    jc.mutate("add", ["k3", 3])

    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, str(script), dirs["port"], str(NODE_IDS[0])],
        capture_output=True, text=True, timeout=120, env=env, check=True,
    )
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["node_id"] == NODE_IDS[0]  # the dot namespace continues
    assert got["read"] == repr(sorted(want.items(), key=repr))
    assert bytes.fromhex(got["bytes"]) == jc.canonical_state_bytes()


def test_rehydrate_rejects_foreign_layout(sides):
    """A snapshot of another engine layout fails with a descriptive error,
    the untagged legacy pickle too."""
    for side in sides:
        store = side.MemoryStorage()
        c = side.mk(name="laytag", storage_module=store)
        c.mutate("add", ["k", "v"])
        snap = store.read("laytag")
        assert snap.layout == "binned-v2"
        c.stop()
        side.replicas.remove(c)
        side.transport.unregister("laytag")
        store.write("laytag", dataclasses.replace(snap, layout="flat-v0"))
        with pytest.raises(ValueError, match="engine layout"):
            side.mk(name="laytag", storage_module=store)
        untagged = dataclasses.replace(snap)
        del untagged.__dict__["layout"]
        store.write("laytag", untagged)
        with pytest.raises(ValueError, match="engine layout"):
            side.mk(name="laytag", storage_module=store)
