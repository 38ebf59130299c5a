"""PyTorch port vs JAX package: the runtime dict-oracle property
(``tests/test_runtime_property.py``), on both stores.

With full convergence after every op a plain dict is an exact oracle: a
remove observes every dot, so add-wins coincides with sequential map
semantics. ``hypothesis`` draws writer scripts (add, remove, clear);
each runs on three ``threaded=False`` replicas of each package, the
same node ids and a ``LogicalClock`` each, the first with a write-ahead
log. After every op every replica's read equals the dict; at the end the
port's canonical bytes, state columns, diff feeds and WAL segment bytes
equal the JAX replicas'.

``Side`` (one package's runtime, driven by the same script as the
other's) serves the other runtime conformance files too.
"""

from __future__ import annotations

import glob
import os
import tempfile
from pathlib import Path

import pytest
from hypothesis import given, settings, strategies as st

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import telemetry as j_telemetry
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.runtime import telemetry as t_telemetry
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from tests.test_torch_lattice import PROPERTY, STORES, assert_state_same, jax_compiles_released  # noqa: F401 (autouse)

#: node ids of a side's replicas in start order; every other one has the
#: top bit set, so unsigned gid orders matter
NODE_IDS = tuple((1 << 63 | 0xB0 + i) if i % 2 == 0 else 7 + i for i in range(16))


class Side:
    """One package's runtime for a script run on both: a transport, a
    ``LogicalClock`` and replicas started with fixed node ids and names,
    so both packages send the same messages and mint the same dots."""

    def __init__(self, pkg: str, store: str = "binned", **defaults):
        self.pkg, self.store = pkg, store
        jax = pkg == "jax"
        self.dc = jdc if jax else tdc
        self.telemetry = j_telemetry if jax else t_telemetry
        self.MemoryStorage = self.dc.MemoryStorage
        self.transport = JTransport() if jax else TTransport()
        self.Clock = JClock if jax else TClock
        self.clock = self.Clock()
        self.opts = dict(
            store=store, threaded=False, transport=self.transport, clock=self.clock,
            capacity=64, tree_depth=6,
            # in-flight walk slots clear only by message, never by the
            # wall clock, so both packages send the same messages
            sync_timeout=1e9,
        )
        if not jax:
            self.opts["device"] = "cpu"
        self.opts.update(defaults)
        self.replicas: list = []

    def mk(self, **opts):
        i = len(self.replicas)
        o = {**self.opts, "node_id": NODE_IDS[i], "name": f"{self.store}-r{i}"}
        o.update(opts)
        r = self.dc.start_link(self.dc.AWLWWMap, **o)
        self.replicas.append(r)
        return r

    def converge(self, reps=None, rounds: int = 6):
        reps = self.replicas if reps is None else reps
        for _ in range(rounds):
            for r in reps:
                r.sync_to_all()
            self.transport.pump()

    def full_pass_read(self, r) -> dict:
        """A read through the full winner pass, whatever the cache holds."""
        r.flush()
        return r._read_all() if self.pkg == "jax" else r._read_pairs()[0]

    def close(self):
        for r in self.replicas:
            try:
                r.stop()
            except Exception:
                pass
        self.MemoryStorage.clear()


def both(store: str = "binned", **defaults):
    return Side("jax", store, **defaults), Side("port", store, **defaults)


def wal_segments(wal_dir: str) -> dict:
    """``{file name: bytes}`` of every WAL segment under ``wal_dir``."""
    return {os.path.basename(f): Path(f).read_bytes() for f in sorted(glob.glob(os.path.join(wal_dir, "replica_*", "*.wal")))}


def assert_twins(j: Side, t: Side):
    """The port's replicas equal the JAX replicas started in the same
    order: reads, canonical bytes and state columns."""
    assert len(j.replicas) == len(t.replicas)
    for a, b in zip(j.replicas, t.replicas):
        assert b.read_items() == a.read_items()
        assert b.canonical_state_bytes() == a.canonical_state_bytes()
        assert_state_same(a.state, b.state)


@pytest.fixture(params=STORES, scope="module")
def store(request):
    return request.param


@settings(max_examples=8, **PROPERTY)
@given(
    st.lists(
        st.tuples(
            st.integers(min_value=0, max_value=2),  # writer
            st.sampled_from(["add", "add", "add", "remove", "clear"]),
            st.integers(min_value=1, max_value=8),  # key
            st.integers(min_value=0, max_value=99),  # value
        ),
        max_size=12,
    ),
)
def test_fully_synced_scripts_match_dict_oracle(store, script):
    """Replica 0 of each package also keeps a write-ahead log: its
    segment files must be byte-identical across the packages."""
    sides = both(store, capacity=64, tree_depth=5, log_shipping=False)
    feeds = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for side in sides:
                log: list = []
                feeds.append(log)
                reps = [
                    side.mk(
                        on_diffs=(lambda i, log: lambda d: log.append((i, d)))(i, log),
                        wal_dir=os.path.join(tmp, side.pkg) if i == 0 else None,
                    )
                    for i in range(3)
                ]
                for r in reps:
                    r.set_neighbours([x for x in reps if x is not r])
                side.converge()
            model: dict = {}
            for who, op, key, val in script:
                for side in sides:
                    r = side.replicas[who]
                    if op == "add":
                        r.mutate("add", [key, val])
                    elif op == "remove":
                        r.mutate("remove", [key])
                    else:
                        r.mutate("clear", [])
                    side.converge()
                if op == "add":
                    model[key] = val
                elif op == "remove":
                    model.pop(key, None)
                else:
                    model.clear()
                for side in sides:
                    for r in side.replicas:
                        assert r.read() == model, (side.pkg, op, key, val)
            assert_twins(*sides)
            assert feeds[1] == feeds[0]
            segs = [wal_segments(os.path.join(tmp, side.pkg)) for side in sides]
            assert segs[1] == segs[0]
            assert segs[0] or not any(op == "add" for _w, op, _k, _v in script)  # merged adds are logged
        finally:
            for side in sides:
                side.close()
