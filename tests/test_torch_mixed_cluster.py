"""One wire: a JAX replica and a port replica in one cluster over TCP.

A JAX replica on the JAX package's ``TcpTransport`` and a port replica
(``device="cpu"``) on the port's, each with a WAL and the JAX default
``log_shipping=True``:

- converge to equal ``canonical_state_bytes()`` with writes on both
  sides (both edge directions);
- a crashed port replica, restarted from its WAL, catches up from the
  JAX replica by ``LogChunkMsg``; and the roles reversed, the port
  serving the chunks to a restarted JAX replica;
- a port fleet and a JAX fleet exchange ``FleetFrameMsg`` envelopes
  both ways and converge;
- a port replica in a child process whose import system refuses
  ``jax`` and ``delta_crdt_ex_tpu`` converges with a JAX parent: the
  port decodes JAX frames without JAX.

Every wait loop has its own deadline, and every transport is closed in
teardown.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import tcp_transport as JT
from delta_crdt_ex_tpu_torch.runtime import tcp_transport as T

REPO = Path(__file__).resolve().parents[1]
OPTS = dict(threaded=False, capacity=256, tree_depth=6, sync_timeout=0.05)


@pytest.fixture
def cluster(tmp_path):
    """One JAX and one port TcpTransport, and ``start(pkg, name, **opts)``
    for replicas on them (a WAL under ``tmp_path/name``); every replica
    is crashed and both transports closed in teardown."""
    jt, tt = JT.TcpTransport(), T.TcpTransport()
    made = []

    def start(pkg, name, **opts):
        kw = dict(OPTS, name=name, wal_dir=str(tmp_path / name), fsync_mode="none")
        kw.update(opts)
        if pkg == "jax":
            r = jdc.start_link(jdc.AWLWWMap, transport=jt, **kw)
        else:
            r = tdc.start_link(tdc.AWLWWMap, transport=tt, device="cpu", **kw)
        made.append(r)
        return r

    yield jt, tt, start
    for r in made:
        try:
            r.crash()
        except Exception:  # already crashed in the test
            pass
    jt.close()
    tt.close()


def _drive(transports, replicas, done, timeout=10.0):
    """Sync rounds and pumps until ``done()`` or the deadline."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for r in replicas:
            r.sync_to_all()
        for _ in range(3):
            for t in transports:
                t.pump()
            time.sleep(0.01)
        if done():
            return True
    return done()


def _equal(*reps):
    return lambda: len({r.canonical_state_bytes() for r in reps}) == 1 and all(r.read() == reps[0].read() for r in reps)


@pytest.mark.parametrize("store", ["binned", "hash"])
def test_jax_and_port_replicas_converge_over_tcp(cluster, store):
    jt, tt, start = cluster
    j = start("jax", "j", store=store)
    t = start("torch", "t", store=store)
    assert j.log_shipping and t.log_shipping
    j.set_neighbours([tt.remote_addr("t")])
    t.set_neighbours([jt.remote_addr("j")])
    j.mutate_batch("add", [[f"j{i}", i] for i in range(20)])
    t.mutate_batch("add", [[f"t{i}", [i, "x"]] for i in range(20)])
    j.mutate("remove", ["j3"])
    assert _drive([jt, tt], [j, t], _equal(j, t))
    want = {f"j{i}": i for i in range(20) if i != 3} | {f"t{i}": [i, "x"] for i in range(20)}
    assert t.read() == j.read() == want
    # frames crossed both ways, on the negotiated wire paths
    assert tt.transport_stats()["rx_bytes"] > 0 and tt.transport_stats()["tx_bytes"] > 0


def test_port_replica_catches_up_from_jax_by_log_chunks(cluster):
    jt, tt, start = cluster
    j = start("jax", "j")
    t = start("torch", "t")
    j.set_neighbours([tt.remote_addr("t")])
    t.set_neighbours([jt.remote_addr("j")])
    j.mutate_batch("add", [[i, i] for i in range(16)])
    assert _drive([jt, tt], [j, t], _equal(j, t))
    t.crash()
    j.mutate_batch("add", [[i, -i] for i in range(16, 48)])
    j.mutate("remove", [0])
    _drive([jt], [j], lambda: False, timeout=0.2)  # pushes toward the dead replica are lost
    t2 = start("torch", "t")
    t2.set_neighbours([jt.remote_addr("j")])
    assert _drive([jt, tt], [j, t2], _equal(j, t2))
    assert t2.read() == {i: i for i in range(1, 16)} | {i: -i for i in range(16, 48)}
    assert t2.stats()["catchup"]["chunks_applied"] >= 1
    assert j.stats()["catchup"]["chunks_served"] >= 1


def test_port_replica_serves_log_chunks_to_jax(cluster):
    jt, tt, start = cluster
    t = start("torch", "t")
    j = start("jax", "j")
    t.set_neighbours([jt.remote_addr("j")])
    j.set_neighbours([tt.remote_addr("t")])
    t.mutate_batch("add", [[i, i] for i in range(16)])
    assert _drive([jt, tt], [j, t], _equal(j, t))
    j.crash()
    t.mutate_batch("add", [[i, -i] for i in range(16, 48)])
    t.mutate("remove", [0])
    _drive([tt], [t], lambda: False, timeout=0.2)
    j2 = start("jax", "j")
    j2.set_neighbours([tt.remote_addr("t")])
    assert _drive([jt, tt], [j2, t], _equal(j2, t))
    assert j2.read() == {i: i for i in range(1, 16)} | {i: -i for i in range(16, 48)}
    assert j2.stats()["catchup"]["chunks_applied"] >= 1
    assert t.stats()["catchup"]["chunks_served"] >= 1


def test_fleet_frames_cross_both_ways(cluster):
    jt, tt, _start = cluster
    n = 3
    fopts = dict(threaded=False, capacity=256, tree_depth=6, sync_timeout=0.05)
    tf = tdc.start_fleet(n, transport=tt, device="cpu", names=[f"tf{i}" for i in range(n)], **fopts)
    jf = jdc.start_fleet(n, transport=jt, names=[f"jf{i}" for i in range(n)], **fopts)
    try:
        for i in range(n):
            tf.replicas[i].set_neighbours([jt.remote_addr(f"jf{i}")])
            jf.replicas[i].set_neighbours([tt.remote_addr(f"tf{i}")])
            tf.replicas[i].mutate_batch("add", [[f"t{i}.{k}", k] for k in range(8)])
            jf.replicas[i].mutate_batch("add", [[f"j{i}.{k}", k] for k in range(8)])
        # the fleet-frame capability is negotiated by HELLO: wait for it
        for t, ep in ((tt, jt.endpoint), (jt, tt.endpoint)):
            assert _drive([], [], lambda: t.fleet_sink(("x", ep)) is not None)
        pairs = list(zip(tf.replicas, jf.replicas))

        def converged():
            return all(a.canonical_state_bytes() == b.canonical_state_bytes() for a, b in pairs)

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not converged():
            tf.sync_tick()
            jf.sync_tick()
            for _ in range(3):
                time.sleep(0.01)
                tf.drain()
                jf.drain()
        assert converged()
        for a, b in pairs:
            assert a.read() == b.read() and len(a.read()) == 16
        assert tf.stats()["egress"]["frames"] >= 1 and jf.stats()["egress"]["frames"] >= 1
        assert tt.transport_stats()["rx_frames"].get("fleetf", 0) >= 1
        assert tt.transport_stats()["tx_frames"].get("fleetf", 0) >= 1
    finally:
        for f in (tf, jf):
            for r in f.replicas:
                r.crash()


CHILD = r"""
import sys, time


class _Refuse:
    # the JAX package and JAX itself must never load in this process
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "delta_crdt_ex_tpu"):
            raise ImportError(f"{name} is refused in this process")
        return None


sys.meta_path.insert(0, _Refuse())
import delta_crdt_ex_tpu_torch as tdc

parent_host, parent_port, wal_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
t = tdc.TcpTransport()
c = tdc.start_link(tdc.AWLWWMap, threaded=False, transport=t, name="child", capacity=256,
                   tree_depth=6, device="cpu", wal_dir=wal_dir, fsync_mode="none", sync_timeout=0.05)
c.set_neighbours([("parent", (parent_host, parent_port))])
c.mutate("add", ["from_child", "hello"])
c.mutate("add", ["child_endpoint", list(t.endpoint)])  # membership through the CRDT
deadline = time.monotonic() + 60
while time.monotonic() < deadline:
    c.sync_to_all()
    t.pump()
    time.sleep(0.02)
    if c.read().get("from_parent") == ["hi", 1] and "parent_saw_child" in c.read():
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "delta_crdt_ex_tpu"))
        print("CHILD_CONVERGED", bad, c.stats()["catchup"]["chunks_applied"], flush=True)
        t.close()
        sys.exit(0)
sys.exit(3)
"""


def test_port_child_without_jax_decodes_jax_frames(tmp_path):
    t = JT.TcpTransport()
    try:
        parent = jdc.start_link(
            jdc.AWLWWMap, threaded=False, transport=t, name="parent", capacity=256, tree_depth=6,
            wal_dir=str(tmp_path / "parent"), fsync_mode="none", sync_timeout=0.05,
        )
        parent.mutate("add", ["from_parent", ["hi", 1]])
        host, port = t.endpoint
        script = tmp_path / "child.py"
        script.write_text(CHILD)
        env = dict(os.environ)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        child = subprocess.Popen(
            [sys.executable, str(script), str(host), str(port), str(tmp_path / "child")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        try:
            linked = False
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline and child.poll() is None:
                parent.sync_to_all()
                t.pump()
                time.sleep(0.02)
                if not linked and "child_endpoint" in parent.read():
                    ch_host, ch_port = parent.read()["child_endpoint"]
                    parent.set_neighbours([("child", (ch_host, ch_port))])
                    parent.mutate("add", ["parent_saw_child", True])
                    linked = True
            out, err = child.communicate(timeout=60)
            assert "CHILD_CONVERGED [] " in out, f"child failed: {out[-500:]} {err[-2000:]}"
            got = parent.read()
            assert got["from_child"] == "hello" and got["from_parent"] == ["hi", 1]
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate(timeout=10)
        parent.crash()
    finally:
        t.close()
