"""The hash-store replica path as a whole: a JAX pair and a PyTorch pair
(``store="hash"``, ``threaded=False``, ``LogicalClock``, the same node
ids, ``on_diffs`` recorders) run one seeded script — adds, overwrites,
removes, concurrent writes to one key, a clear, growth past a rehash —
driven by ``sync_to_all()`` + ``transport.pump()``. Reads, partial
reads, the diff streams, the canonical state bytes and every state
column must be bit-identical.

Also: the port imports nothing of JAX or of the JAX package, its wire
messages keep the JAX package's fields, CUDA is its default device,
``AWLWWMap`` with no ``store=`` is the binned store with ingress
coalescing on, ``stats()`` works on both stores, the options of the
serving and observability slice (``obs=``, ``flight_dump_path=``, the
fleet's front door and health) work, and options of later slices raise
instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import telemetry as j_telemetry
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.models.hash_store import to_numpy
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, telemetry as t_telemetry, transition
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport

REPO = Path(__file__).resolve().parents[1]
#: one gid with the top bit set, so unsigned gid orders matter
NODE_IDS = (0xF00000000000000B, 7)


def _pair(dc, transport_cls, clock_cls, **kw):
    t, c, logs = transport_cls(), clock_cls(), ([], [])
    rs = [
        dc.start_link(
            dc.AWLWWMap, threaded=False, store="hash", transport=t, clock=c,
            name=f"r{i}", node_id=NODE_IDS[i], capacity=64, tree_depth=4,
            sync_interval=0.01, max_sync_size=8, on_diffs=logs[i].append,
            # in-flight walk slots then clear only by message, never by
            # the wall clock, so both packages send the same messages
            sync_timeout=1e9, **kw,
        )
        for i in range(2)
    ]
    rs[0].set_neighbours([rs[1]])
    rs[1].set_neighbours([rs[0]])
    return t, rs, logs


def _script(t, rs, steps: int) -> list:
    """Returns every observation the two packages must agree on."""
    g = np.random.default_rng(5)
    out = []

    def converge(rounds: int) -> None:
        for _ in range(rounds):
            for r in rs:
                r.sync_to_all()
            t.pump()

    for step in range(steps):
        r = rs[step % 2]
        r.mutate_batch(
            "add", [[f"k{int(x)}", int(g.integers(0, 1000))] for x in g.integers(0, 150, 40)]
        )
        for x in g.integers(0, 150, 5):
            r.mutate("remove", [f"k{int(x)}"])
        # concurrent writes to one key
        rs[0].mutate("add", ["hot", step])
        rs[1].mutate("add", ["hot", -step])
        if step == 7:
            rs[1].mutate("clear", [])
        converge(2)
        out.append(rs[0].read_keys([f"k{i}" for i in range(0, 150, 7)] + ["hot", "nope"]))
        out.append(rs[step % 2].state.table_size)
    converge(6)
    for r in rs:
        out += [r.read(), r.read_items(), r.canonical_state_bytes()]
    return out


def _run(dc, telemetry, transport_cls, clock_cls, **kw):
    """The script on one package, with its ``SYNC_DONE`` stream."""
    events = []
    handler = lambda _e, meas, meta: events.append((meta["name"], meas["keys_updated_count"]))
    telemetry.attach(telemetry.SYNC_DONE, handler)
    try:
        t, rs, logs = _pair(dc, transport_cls, clock_cls, **kw)
        return _script(t, rs, 12), rs, logs, events
    finally:
        telemetry.detach(telemetry.SYNC_DONE, handler)


@pytest.fixture(scope="module")
def runs():
    return (_run(jdc, j_telemetry, JTransport, JClock),
            _run(tdc, t_telemetry, TTransport, TClock, device="cpu"))


def test_reads_and_canonical_bytes_match_jax(runs):
    (oj, rj, _, _), (ot, rt, _, _) = runs
    assert len(oj) == len(ot)
    for i, (a, b) in enumerate(zip(oj, ot)):
        assert a == b, i
    # the pair converged, and the table grew past a rehash on the way
    assert oj[-1] == oj[-4] and len(oj[-1]) > 0
    assert rt[0].state.table_size > 64 and rt[0].state.table_size == rj[0].state.table_size


def test_diff_streams_match_jax(runs):
    (_, _, lj, ej), (_, _, lt, et) = runs
    assert lj == lt
    assert ej == et and len(ej) > 0  # telemetry: the SYNC_DONE stream
    kinds = {d[0] for batch in lj[0] + lj[1] for d in batch}
    assert kinds == {"add", "remove"}


def test_state_columns_match_jax(runs):
    (_, rj, _, _), (_, rt, _, _) = runs
    for a, b in zip(rj, rt):
        cols = to_numpy(b.state)
        assert a.state.probe_window == b.state.probe_window
        for f in dataclasses.fields(a.state):
            if f.name != "probe_window":
                assert np.array_equal(np.asarray(getattr(a.state, f.name)), cols[f.name]), f.name


def test_port_imports_no_jax():
    code = (
        "import sys, delta_crdt_ex_tpu_torch\n"
        "import delta_crdt_ex_tpu_torch.ops.hash_map, delta_crdt_ex_tpu_torch.utils.kernels\n"
        "import delta_crdt_ex_tpu_torch.ops.roots, delta_crdt_ex_tpu_torch.utils.synth\n"
        "import delta_crdt_ex_tpu_torch.parallel.batched_sync, delta_crdt_ex_tpu_torch.models.binned_map\n"
        "import delta_crdt_ex_tpu_torch.models.hash_store, delta_crdt_ex_tpu_torch.ops.binned\n"
        "import delta_crdt_ex_tpu_torch.runtime.replica, delta_crdt_ex_tpu_torch.runtime.telemetry\n"
        "import delta_crdt_ex_tpu_torch.runtime.transition, delta_crdt_ex_tpu_torch.runtime.fleet\n"
        "import delta_crdt_ex_tpu_torch.runtime.storage, delta_crdt_ex_tpu_torch.runtime.wal\n"
        "import delta_crdt_ex_tpu_torch.runtime.simnet, delta_crdt_ex_tpu_torch.utils.faults\n"
        "import delta_crdt_ex_tpu_torch.runtime.tcp_transport, delta_crdt_ex_tpu_torch.runtime.transport\n"
        "from delta_crdt_ex_tpu_torch import AWSet, BinnedAWLWWMap, HashAWSet, HashAWLWWMap\n"
        "from delta_crdt_ex_tpu_torch import FileStorage, MemoryStorage, SimNetwork, WalLog, child_spec\n"
        "from delta_crdt_ex_tpu_torch import TcpTransport\n"
        "import delta_crdt_ex_tpu_torch.runtime.serve, delta_crdt_ex_tpu_torch.runtime.metrics\n"
        "import delta_crdt_ex_tpu_torch.runtime.obs_server, delta_crdt_ex_tpu_torch.runtime.tracing\n"
        "import delta_crdt_ex_tpu_torch.runtime.treesync\n"
        "import delta_crdt_ex_tpu_torch.ops.packed, delta_crdt_ex_tpu_torch.native, delta_crdt_ex_tpu_torch.parallel\n"
        "from delta_crdt_ex_tpu_torch.parallel import fanout_merge_packed, pack_states\n"
        "import delta_crdt_ex_tpu_torch.utils.devices, delta_crdt_ex_tpu_torch.runtime.meshplane\n"
        "import delta_crdt_ex_tpu_torch.parallel.mesh_gossip\n"
        "from delta_crdt_ex_tpu_torch.parallel import gossip_delta_step, gossip_delta_drive, gossip_train_step\n"
        "from delta_crdt_ex_tpu_torch.parallel import make_mesh, place_states, snapshot_mesh, restore_mesh\n"
        "from delta_crdt_ex_tpu_torch import Frontdoor, FleetFrontdoor, Observability, ObsServer, Overloaded, frontdoor\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'delta_crdt_ex_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=True
    )
    assert out.stdout.strip() == "[]"


def test_wire_messages_keep_the_manifest_fields():
    """The port's copy of ``runtime/sync.py`` keeps every message's
    fields as the protocol manifest records them for the JAX package."""
    manifest = json.loads((REPO / "tools/crdtlint/protocol_manifest.json").read_text())
    messages = manifest["packages"]["delta_crdt_ex_tpu"]["messages"]
    assert messages
    for name, spec in messages.items():
        cls = getattr(t_sync, name)
        assert [f.name for f in dataclasses.fields(cls)] == [f for f, _ in spec["fields"]], name


def test_start_link_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for store in ("hash", None):  # None: the binned store, the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdc.start_link(tdc.AWLWWMap, store=store, threaded=False, transport=TTransport())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdc.start_fleet(2, store=store, threaded=False, transport=TTransport())


def test_default_start_link_is_the_binned_store_with_coalescing():
    r = tdc.start_link(tdc.AWLWWMap, threaded=False, transport=TTransport(), device="cpu")
    assert tdc.AWLWWMap is tdc.BinnedAWLWWMap
    assert r.model is tdc.BinnedAWLWWMap and type(r.state).__name__ == "BinnedStore"
    assert (r.ingress_coalesce, r.max_coalesce, r.ingress_batch) == (True, 16, 256)
    for model, store, want in [
        (tdc.AWLWWMap, "hash", tdc.HashAWLWWMap),
        (tdc.AWSet, "hash", tdc.HashAWSet),
        (tdc.HashAWSet, "binned", tdc.AWSet),
        (tdc.AWSet, None, tdc.AWSet),
    ]:
        r = tdc.start_link(model, store=store, threaded=False, transport=TTransport(), device="cpu")
        assert r.model is want, (model, store)


@pytest.mark.parametrize("store", ["binned", "hash"])
def test_stats_on_both_stores(store):
    t = TTransport()
    r1, r2 = (
        tdc.start_link(tdc.AWLWWMap, store=store, threaded=False, transport=t, device="cpu", capacity=64, tree_depth=4)
        for _ in range(2)
    )
    r1.set_neighbours([r2])
    r1.mutate_batch("add", [[i, i] for i in range(40)])
    r1.sync_to_all()
    r2.process_pending()
    st = r2.stats()
    assert st["ingress"]["dispatches"] >= 1 and st["ingress"]["messages"] >= st["ingress"]["dispatches"]
    assert set(st["ingress"]) == {
        "messages", "dispatches", "merges_per_dispatch", "coalesce_depth_hist", "gap_fallbacks", "gap_partitions",
    }
    assert st["payloads"] == 40 and "table_size" not in st
    assert r2.read() == {i: i for i in range(40)}


@pytest.mark.parametrize(
    "opts, err",
    [
        # the options of the serving and observability slice and of the
        # tree-gossip slice now work (None: the call succeeds; the cases
        # keep the ids they had while these options raised); an unknown
        # option still raises
        pytest.param({"obs": True}, None, id="opts0-NotImplementedError"),
        pytest.param({"store": "hash", "tree_gossip": True, "tree_fanout": 2}, None, id="opts1-NotImplementedError"),
        pytest.param({"store": "hash", "flight_dump_path": "x"}, None, id="opts2-NotImplementedError"),
        pytest.param({"store": "hash", "tree_gossip": True}, None, id="opts3-NotImplementedError"),
        ({"store": "hash", "no_such_option": 1}, TypeError),
    ],
)
def test_unported_options_raise(opts, err):
    from delta_crdt_ex_tpu_torch.runtime import metrics

    start = lambda: tdc.start_link(tdc.AWLWWMap, threaded=False, transport=TTransport(), device="cpu", **opts)
    if err is not None:
        with pytest.raises(err):
            start()
        return
    r = start()
    try:
        if opts.get("obs"):
            assert r._obs is metrics.default_observability() and r.flight is not None
        assert r.flight_dump_path == opts.get("flight_dump_path")
        if opts.get("tree_gossip"):
            # alone, the replica is its own tree: it gossips flat
            tree = r.stats()["tree"]
            assert tree["fanout"] == opts.get("tree_fanout", 8) and tree["role"] == "flat"
        else:
            assert "tree" not in r.stats()
        r.mutate("add", ["k", 1])
        assert r.frontdoor().read_keys(["k"]) == {"k": 1}
    finally:
        r.stop()
        if opts.get("obs"):
            # the process default plane must not outlive this test
            metrics.default_observability().close()
            metrics._default_obs = None


def _fleet_obs(t):
    from delta_crdt_ex_tpu_torch.runtime import metrics

    plane = metrics.Observability()
    fleet = tdc.start_fleet(2, threaded=False, transport=t, device="cpu", obs=plane, capacity=64, tree_depth=4)
    try:
        assert all(r._obs is plane for r in fleet.replicas) and fleet._obs is plane
        assert any(v["kind"] == "fleet" for v in plane.varz()["sources"].values())
        return plane.health()[0]
    finally:
        fleet.stop()
        plane.close()


def _fleet_call(t, method):
    fleet = tdc.start_fleet(2, threaded=False, transport=t, device="cpu", capacity=64, tree_depth=4)
    try:
        return getattr(fleet, method)()
    finally:
        fleet.stop()


def _mesh_fleet(t, store):
    fleet = tdc.start_fleet(2, threaded=False, transport=t, device="cpu", store=store, capacity=64, tree_depth=4,
                            mesh=True)
    try:
        return fleet.stats()["mesh"]["enabled"]
    finally:
        fleet.stop()


@pytest.mark.parametrize(
    "call, match",
    [
        # the mesh and the serving and observability slices' fleet calls
        # now succeed (match None: the call's result must be truthy; the
        # cases keep the ids they had while these calls raised)
        pytest.param(lambda t: _mesh_fleet(t, None), None, id="<lambda>-multi-device mesh0"),
        pytest.param(_fleet_obs, None, id="<lambda>-serving and observability0"),
        pytest.param(lambda t: type(_fleet_call(t, "frontdoor")).__name__ == "FleetFrontdoor", None,
                     id="<lambda>-serving and observability1"),
        pytest.param(lambda t: _fleet_call(t, "health")["ok"], None, id="<lambda>-serving and observability2"),
        (lambda t: transition.fleet_hash_row_apply(None, None, None, None, None, None, None), "hash-store fleet mutation"),
        pytest.param(lambda t: _mesh_fleet(t, "hash"), None, id="<lambda>-multi-device mesh1"),
    ],
)
def test_unported_fleet_options_raise(call, match):
    if match is None:
        assert call(TTransport())
        return
    with pytest.raises(NotImplementedError, match=match):
        call(TTransport())
