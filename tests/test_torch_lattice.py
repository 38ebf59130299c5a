"""PyTorch port vs JAX package: the lattice suite of ``tests/test_lattice.py``.

``PortKernelMap`` is the port's copy of ``tests/kernel_harness.py``'s
``BinnedKernelMap``/``HashKernelMap``: add, remove, clear, batches and
``join_from`` straight over the port's ``BinnedAWLWWMap`` and
``HashAWLWWMap`` ops on the CPU, with no runtime. ``Lockstep`` drives the
JAX harness and the port harness with the same ops, and after every op
holds the port's state columns bit-equal to the JAX state's and its read
equal to the JAX read. The suite runs on both stores; the two
``hypothesis`` properties drive ``utils/pyref.py``, JAX and the port in
lockstep, with top-bit keys and a top-bit writer id in the draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from delta_crdt_ex_tpu.ops.apply import OP_ADD, OP_CLEAR, OP_REMOVE
from delta_crdt_ex_tpu.utils.pyref import PyAWLWWMap
from delta_crdt_ex_tpu_torch.models import binned_map as t_binned_map, hash_store as t_hash_store
from delta_crdt_ex_tpu_torch.ops import binned as t_ops
from tests.kernel_harness import BinnedKernelMap, HashKernelMap

STORES = ["binned", "hash"]
A_GID, B_GID = 11, 22
TOP = 1 << 63

#: every property of the port's conformance files: the same examples on
#: every run, so the passing count never wanders
PROPERTY = dict(derandomize=True, database=None, deadline=None)


@pytest.fixture(autouse=True, scope="module")
def jax_compiles_released():
    """The JAX side of a conformance file compiles many small programs.
    Each compiled XLA CPU executable that JAX keeps holds memory
    mappings, and a long-lived test worker that passes the kernel's
    ``vm.max_map_count`` (65530) dies inside its next compile (a tier-1
    worker was seen at 58463). So when the file ends, JAX drops every
    compiled program (``jax.clear_caches()``; later files recompile what
    they need), and while it runs, JAX writes nothing to the persistent
    compilation cache that every worker shares (``tests/conftest.py``;
    JAX writes an entry with a plain ``write_bytes``). Other conformance
    files import this fixture, which makes it autouse there too."""
    import gc

    import jax

    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", float("inf"))
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)
    jax.clear_caches()
    gc.collect()


def i64(u: int) -> int:
    """A uint64 as the int64 bit pattern the port's columns hold."""
    return u - (1 << 64) if u >= TOP else u


def as_u64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint64)


def assert_state_same(j_state, t_state, what=""):
    """Every column of a JAX store (single or stacked, either backend)
    equals the port store's, bit for bit: uint64 columns through their
    int64 bit patterns, uint32 through their widened values."""
    for f in dataclasses.fields(j_state):
        want = getattr(j_state, f.name)
        got = getattr(t_state, f.name)
        if f.name == "probe_window":
            assert got == want, what
            continue
        want = np.asarray(want)
        got = got.detach().cpu().numpy()
        assert got.shape == want.shape, (what, f.name, got.shape, want.shape)
        if want.dtype == np.uint64:
            got = np.ascontiguousarray(got).view(np.uint64)
        else:
            got, want = got.astype(np.int64), want.astype(np.int64)
        assert np.array_equal(got, want), (what, f.name)


def port_slice(sj):
    """A JAX RowSlice on the port's side, through its wire columns."""
    return t_ops.slice_from_wire({c: np.asarray(getattr(sj, c)) for c in sj._fields}, "cpu")


class PortKernelMap:
    """The port's lattice harness: the JAX harness's drive over the
    port's model ops (``group_batch`` → ``row_apply`` → ``post_apply``,
    growing on ``ok=False``; clears split out as ``clear_all``; joins as
    ``extract_rows`` of every row → ``merge_rows_into``)."""

    def __init__(self, store: str, gid: int, capacity: int = 64, rcap: int = 8, num_buckets: int = 64):
        self.M = t_hash_store.HashAWLWWMap if store == "hash" else t_binned_map.BinnedAWLWWMap
        self.gid = gid
        bin_cap = 4
        while bin_cap * num_buckets < capacity:
            bin_cap *= 2
        state = self.M.new(num_buckets, bin_cap, rcap, device="cpu")
        state.ctx_gid[0] = i64(gid)  # a fresh state: nothing else holds it
        self.state = state

    def batch(self, rows):
        seg: list = []
        for row in rows:
            if row[0] == OP_CLEAR:
                self._segment(seg)
                seg = []
                self.state = self.M.clear_all(self.state)
            else:
                seg.append(row)
        self._segment(seg)

    def _segment(self, rows):
        if not rows:
            return
        g = self.M.group_batch(
            self.state.num_buckets,
            np.array([r[0] for r in rows], np.int32),
            np.array([r[1] for r in rows], np.uint64),
            np.array([r[2] for r in rows], np.uint32),
            np.array([r[3] for r in rows], np.int64),
        )
        args = (
            torch.from_numpy(g.rows.astype(np.int64)),
            torch.from_numpy(g.op),
            torch.from_numpy(g.key.view(np.int64).copy()),
            torch.from_numpy(g.valh.astype(np.int64)),
            torch.from_numpy(g.ts),
        )
        while True:
            res = self.M.row_apply(self.state, 0, *args)
            if bool(res.ok):
                self.state = self.M.post_apply(res.state, res)
                return
            self.state = self.M.grow_for_apply(self.state)

    def add(self, key: int, val: int, ts: int):
        self.batch([(OP_ADD, key, val, ts)])

    def remove(self, key: int, ts: int = 0):
        self.batch([(OP_REMOVE, key, 0, ts)])

    def clear(self, ts: int = 0):
        self.batch([(OP_CLEAR, 0, 0, ts)])

    def extract_all(self):
        return self.M.extract_rows(self.state, torch.arange(self.state.num_buckets, dtype=torch.int64))

    def join_from(self, other: "PortKernelMap"):
        self.merge_slice(other.extract_all())

    def merge_slice(self, sl):
        self.state, res = self.M.merge_rows_into(self.state, sl)
        return res

    def read(self) -> dict:
        w = self.M.winner_all(self.state)
        win = w.win
        keys = as_u64(w.key[win])
        vals = w.valh[win].numpy()
        return {int(k): int(v) for k, v in zip(keys, vals)}

    def ctx(self) -> dict:
        gids = as_u64(self.state.ctx_gid)
        maxs = self.state.global_ctx().numpy()
        return {int(g): int(m) for g, m in zip(gids, maxs) if g != 0 and m != 0}

    def alive_count(self) -> int:
        return int(self.state.num_alive())


class Lockstep:
    """One replica's lattice on both packages, op for op: after each op
    the port's columns equal the JAX columns and both read the same."""

    def __init__(self, store: str, gid: int, **kw):
        self.j = (HashKernelMap if store == "hash" else BinnedKernelMap)(gid, **kw)
        self.t = PortKernelMap(store, gid, **kw)
        self.check("new")

    def check(self, what=""):
        assert_state_same(self.j.state, self.t.state, what)

    def _both(self, name, *args, **kw):
        getattr(self.j, name)(*args, **kw)
        getattr(self.t, name)(*args, **kw)
        self.check(name)

    def add(self, key, val, ts):
        self._both("add", key, val, ts=ts)

    def remove(self, key, ts=0):
        self._both("remove", key, ts=ts)

    def clear(self, ts=0):
        self._both("clear", ts=ts)

    def batch(self, rows):
        self._both("batch", rows)

    def join_from(self, other: "Lockstep"):
        self.j.join_from(other.j)
        self.t.join_from(other.t)
        self.check("join_from")

    def merge_slice(self, sj):
        """Merge a JAX-built RowSlice on both sides (the port's copy
        through the wire form); a non-contiguous interval must raise on
        both and leave both states as they were."""
        st = port_slice(sj)
        try:
            self.j.merge_slice(sj)
        except ValueError as e:
            with pytest.raises(ValueError, match="not contiguous"):
                self.t.merge_slice(st)
            self.check("merge_slice gap")
            raise e
        self.t.merge_slice(st)
        self.check("merge_slice")

    def read(self) -> dict:
        got = self.t.read()
        assert got == self.j.read()
        return got

    def ctx(self) -> dict:
        got = self.t.ctx()
        assert got == self.j.ctx()
        return got

    def alive_count(self) -> int:
        got = self.t.alive_count()
        assert got == self.j.alive_count()
        return got


@pytest.fixture(params=STORES, scope="module")
def store(request):
    return request.param


def mk(store):
    return lambda gid, **kw: Lockstep(store, gid, **kw)


def test_can_add_and_read_a_value(store):
    m = mk(store)(A_GID)
    m.add(1, 2, ts=1)
    assert m.read() == {1: 2}


def test_can_join_two_adds(store):
    M = mk(store)
    a = M(A_GID)
    a.add(1, 2, ts=1)
    b = M(B_GID)
    b.add(2, 2, ts=2)
    a.join_from(b)
    assert a.read() == {1: 2, 2: 2}


def test_can_remove_elements(store):
    m = mk(store)(A_GID)
    m.add(1, 2, ts=1)
    m.remove(1)
    assert m.read() == {}


def test_remove_only_kills_observed_dots_add_wins(store):
    M = mk(store)
    a = M(A_GID)
    a.add(1, 2, ts=1)
    b = M(B_GID)
    b.join_from(a)
    b.add(1, 99, ts=2)  # b's new dot, unseen by a
    a.remove(1)  # kills only the dots a observed
    b.join_from(a)
    assert b.read() == {1: 99}


def test_can_resolve_conflicts_lww(store):
    m = mk(store)(A_GID)
    m.add(1, 2, ts=1)
    m.add(1, 3, ts=2)
    assert m.read() == {1: 3}
    assert m.alive_count() == 1  # the losing value's entry is gone


def test_context_stays_compressed(store):
    m = mk(store)(A_GID)
    m.add(1, 2, ts=1)
    m.add(1, 3, ts=2)
    assert m.ctx() == {A_GID: 2}
    assert m.alive_count() == 1


def test_clear_removes_everything(store):
    M = mk(store)
    m = M(A_GID)
    m.add(1, 2, ts=1)
    m.add(2, 3, ts=2)
    m.clear()
    assert m.read() == {}
    old = M(B_GID)  # cleared dots stay observed: an old copy cannot resurrect
    old.add(3, 4, ts=3)
    m.join_from(old)
    assert m.read() == {3: 4}


def test_batch_sequential_semantics(store):
    m = mk(store)(A_GID)
    m.batch(
        [
            (OP_ADD, 1, 10, 1),
            (OP_ADD, 2, 20, 2),
            (OP_ADD, 1, 11, 3),  # shadows the first add
            (OP_REMOVE, 2, 0, 4),
            (OP_ADD, 3, 30, 5),
        ]
    )
    assert m.read() == {1: 11, 3: 30}
    m.batch([(OP_ADD, 4, 40, 6), (OP_CLEAR, 0, 0, 7), (OP_ADD, 5, 50, 8)])
    assert m.read() == {5: 50}


def test_join_is_idempotent_and_commutative(store):
    M = mk(store)
    a = M(A_GID)
    a.add(1, 1, ts=1)
    a.add(2, 2, ts=2)
    b = M(B_GID)
    b.add(2, 22, ts=3)
    b.add(3, 3, ts=4)
    ab = M(A_GID)
    ab.add(1, 1, ts=1)
    ab.add(2, 2, ts=2)
    ab.join_from(b)
    ab.join_from(b)  # idempotent
    ba = M(B_GID)
    ba.add(2, 22, ts=3)
    ba.add(3, 3, ts=4)
    ba.join_from(a)
    assert ab.read() == ba.read() == {1: 1, 2: 22, 3: 3}
    assert_state_same(ab.j.state, ab.t.state)


def test_top_bit_keys_and_writer(store):
    """uint64 keys and writer ids past 2^63 are int64 bit patterns in the
    port: reads, contexts and joins keep their unsigned meaning."""
    M = mk(store)
    a = M(A_GID)
    b = M(TOP | B_GID)
    a.add(TOP | 1, 7, ts=1)
    b.add(1, 8, ts=2)
    b.add(TOP | 1, 9, ts=3)
    a.join_from(b)
    assert a.read() == {TOP | 1: 9, 1: 8}
    assert a.ctx() == {A_GID: 1, TOP | B_GID: 2}


keys = st.builds(lambda k, top: k | (TOP if top else 0), st.integers(1, 8), st.booleans())

ops_strategy = st.lists(
    st.tuples(st.sampled_from(["add", "remove"]), keys, st.integers(min_value=0, max_value=100)),
    max_size=40,
)


@settings(max_examples=30, **PROPERTY)
@given(ops_strategy)
def test_property_single_replica_matches_dict_model(store, ops):
    """An arbitrary add/remove sequence reads back like a plain dict, on
    pyref, JAX and the port alike (``aw_lww_map_test.exs:51-86``)."""
    m = Lockstep(store, A_GID, capacity=128)
    model: dict = {}
    spec = PyAWLWWMap()
    for i, (op, key, val) in enumerate(ops):
        ts = i + 1
        if op == "add":
            m.add(key, val, ts=ts)
            delta = spec.add(key, val, A_GID, ts)
            model[key] = val
        else:
            m.remove(key, ts=ts)
            delta = spec.remove(key)
            model.pop(key, None)
        spec = spec.join(delta, [key])
    assert m.read() == model
    assert spec.read() == model


@settings(max_examples=20, **PROPERTY)
@given(
    st.lists(
        st.tuples(
            st.integers(min_value=0, max_value=2),  # replica
            st.sampled_from(["add", "remove", "sync"]),
            keys,  # key, or sync target (low bits)
            st.integers(min_value=0, max_value=50),
        ),
        max_size=30,
    ),
)
def test_property_multi_replica_convergence_vs_spec(store, script):
    """Concurrent ops and pairwise joins on three replicas: pyref, JAX and
    the port stay in lockstep, and full pairwise sync converges all three
    to one read."""
    gids = [101, TOP | 202, 303]
    ks = [Lockstep(store, g, capacity=128) for g in gids]
    specs = [PyAWLWWMap() for _ in gids]

    def join(i, j):
        ks[i].join_from(ks[j])
        all_keys = set(specs[i].value) | set(specs[j].value)
        specs[i] = specs[i].join(PyAWLWWMap(dots=specs[j].dots, value=specs[j].value), list(all_keys))

    for ts, (who, op, key, val) in enumerate(script, 1):
        if op == "add":
            ks[who].add(key, val, ts=ts)
            specs[who] = specs[who].join(specs[who].add(key, val, gids[who], ts), [key])
        elif op == "remove":
            ks[who].remove(key, ts=ts)
            specs[who] = specs[who].join(specs[who].remove(key), [key])
        elif (key & 0xFF) % 3 != who:
            join(who, (key & 0xFF) % 3)
        assert ks[who].read() == specs[who].read()
    for _ in range(3):
        for i in range(3):
            for j in range(3):
                if i != j:
                    join(i, j)
    reads = [k.read() for k in ks]
    assert reads[0] == reads[1] == reads[2] == specs[0].read()
