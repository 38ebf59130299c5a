"""PyTorch port vs JAX package: every op of the hash store
(``ops/hash_map.py`` and the ``models/hash_store.py`` host wrappers) on
seeded scripts shaped like ``tests/kernel_harness.py:HashKernelMap``.

Each step runs the JAX op and its port counterpart on the same state
(carried across with ``from_numpy``) and compares every state column
(via ``to_numpy``), every result count and every escape flag (``ok``,
``need_gid_grow``, ``need_fill_grow``, ``need_ctx_gap`` with its
``gap_row``) bit for bit. Tables are small: L ≤ 64 buckets, H ≤ 1024
lanes, R ≤ 8 writers.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.models import hash_store as j_hs
from delta_crdt_ex_tpu.models.binned_map import CtxGapError as JCtxGapError, group_batch
from delta_crdt_ex_tpu.ops import binned as j_binned, hash_map as j_hm
from delta_crdt_ex_tpu.ops.apply import OP_ADD, OP_CLEAR, OP_REMOVE
from delta_crdt_ex_tpu_torch.models import hash_store as t_hs
from delta_crdt_ex_tpu_torch.models.binned_map import CtxGapError as TCtxGapError
from delta_crdt_ex_tpu_torch.ops import binned as t_binned, hash_map as t_hm

JM = j_hs.HashAWLWWMap
TM = t_hs.HashAWLWWMap
#: the JAX package's jitted kernel table (compiled once per shape)
JIT = j_hs.jit


def jax_cols(state) -> dict:
    return {
        f.name: np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
        if f.name != "probe_window"
    }


def carry(state) -> t_hs.HashStore:
    """A JAX HashStore carried across to the port, bit for bit."""
    return t_hs.from_numpy(jax_cols(state), "cpu", probe_window=state.probe_window)


def assert_same_state(js, ts, what=""):
    got = t_hs.to_numpy(ts)
    assert js.probe_window == got["probe_window"], what
    for name, col in jax_cols(js).items():
        assert col.dtype == got[name].dtype, (what, name)
        assert np.array_equal(col, got[name]), (what, name)


def to_np(x):
    """A port result value as the JAX dtype-free numpy it should equal."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_values(a, b, what):
    a = np.asarray(a)
    b = to_np(b)
    if a.dtype == np.uint64:
        b = b.view(np.uint64)
    assert np.array_equal(a.astype(np.int64) if a.dtype != np.uint64 else a,
                          b.astype(np.int64) if a.dtype != np.uint64 else b), what


def assert_same_slice(sj, st, what=""):
    for c in j_binned.RowSlice._fields:
        assert_same_values(getattr(sj, c), getattr(st, c), (what, c))


def t_slice(sj) -> t_binned.RowSlice:
    """The JAX slice on the port's side (the wire carries it as numpy)."""
    return t_binned.slice_from_wire({c: np.asarray(getattr(sj, c)) for c in sj._fields}, "cpu")


def rand_key(g, n, pool=40) -> np.ndarray:
    """Keys from a small pool (overwrites and several dots per key),
    half with the top bit set."""
    k = g.integers(1, pool, n).astype(np.uint64)
    return k | ((k % 2) << np.uint64(63))


class Pair:
    """One replica's hash store on both sides, driven in lockstep."""

    def __init__(self, gid: int, capacity: int = 128, rcap: int = 8, num_buckets: int = 16):
        bin_cap = 4
        while bin_cap * num_buckets < capacity:
            bin_cap *= 2
        st = j_hs.HashStore.new(num_buckets, bin_cap, rcap)
        self.j = dataclasses.replace(st, ctx_gid=st.ctx_gid.at[0].set(jnp.uint64(gid)))
        self.t = carry(self.j)
        self.gid = gid

    def check(self, what=""):
        assert_same_state(self.j, self.t, what)

    def apply(self, op_rows):
        """Apply ops (clear split out), comparing every kernel result."""
        seg = []
        for row in op_rows + [(None,)]:
            if row[0] not in (OP_CLEAR, None):
                seg.append(row)
                continue
            if seg:
                self._segment(seg)
                seg = []
            if row[0] == OP_CLEAR:
                self.j, self.t = JM.clear_all(self.j), TM.clear_all(self.t)
                self.check("clear_all")

    def _segment(self, rows):
        op = np.array([r[0] for r in rows], np.int32)
        key = np.array([r[1] for r in rows], np.uint64)
        valh = np.array([r[2] for r in rows], np.uint32)
        ts = np.array([r[3] for r in rows], np.int64)
        g = group_batch(self.j.num_buckets, op, key, valh, ts)
        targs = (
            torch.from_numpy(g.rows.astype(np.int64)), torch.from_numpy(g.op),
            torch.from_numpy(g.key.view(np.int64).copy()),
            torch.from_numpy(g.valh.astype(np.int64)), torch.from_numpy(g.ts),
        )
        while True:
            rj = JM.row_apply(self.j, jnp.int32(0), *map(jnp.asarray, (g.rows, g.op, g.key, g.valh, g.ts)))
            rt = TM.row_apply(self.t, 0, *targs)
            for f in ("ok", "ctr_assigned", "n_keys_changed", "row_killed", "n_alive", "max_window_fill"):
                assert_same_values(getattr(rj, f), getattr(rt, f), f)
            assert_same_state(rj.state, rt.state, "row_apply")
            if bool(rj.ok):
                self.j, self.t = JM.post_apply(rj.state, rj), TM.post_apply(rt.state, rt)
                self.check("post_apply")
                return
            self.j, self.t = JM.grow_for_apply(self.j), TM.grow_for_apply(self.t)
            self.check("grow_for_apply")

    def merge(self, sj, expect_gap: bool = False):
        """Merge a JAX-extracted slice on both sides: the raw kernel's
        flags, then the growth-handling host wrapper."""
        st = t_slice(sj)
        rj, rt = JM.merge_rows(self.j, sj), TM.merge_rows(self.t, st)
        for f in ("ok", "need_gid_grow", "need_fill_grow", "need_ctx_gap", "n_inserted",
                  "n_killed", "n_ins_row", "n_kill_row", "gap_row", "n_alive", "max_window_fill"):
            assert_same_values(getattr(rj, f), getattr(rt, f), f)
        assert_same_state(rj.state, rt.state, "merge_rows")
        if expect_gap:
            with pytest.raises(JCtxGapError) as ej:
                JM.merge_rows_into(self.j, sj)
            with pytest.raises(TCtxGapError) as et:
                TM.merge_rows_into(self.t, st)
            assert np.array_equal(ej.value.gap_rows, et.value.gap_rows)
            return rj
        self.j, _ = JM.merge_rows_into(self.j, sj)
        self.t, _ = TM.merge_rows_into(self.t, st)
        self.check("merge_rows_into")
        return rj

    def extract_rows(self, rows):
        rows = np.asarray(rows, np.int32)
        sj = JM.extract_rows(self.j, jnp.asarray(rows))
        st = TM.extract_rows(self.t, torch.from_numpy(rows.astype(np.int64)))
        assert_same_slice(sj, st, "extract_rows")
        counts_j = JIT.row_counts(self.j, jnp.asarray(rows))
        assert_same_values(counts_j, t_hm.row_counts(self.t, torch.from_numpy(rows.astype(np.int64))), "row_counts")
        return sj

    def extract_own_delta(self, rows, lo):
        rows = np.asarray(rows, np.int32)
        lo = np.asarray(lo, np.uint32)
        sj = JM.extract_own_delta(
            self.j, jnp.asarray(rows), jnp.int32(0), jnp.uint64(self.gid), jnp.asarray(lo)
        )
        st = TM.extract_own_delta(
            self.t, torch.from_numpy(rows.astype(np.int64)), 0,
            torch.tensor(t_binned._i64(self.gid)), torch.from_numpy(lo.astype(np.int64)),
        )
        assert_same_slice(sj, st, "extract_own_delta")
        cj = JIT.own_delta_counts(self.j, jnp.asarray(rows), jnp.int32(0), jnp.asarray(lo))
        ct = t_hm.own_delta_counts(self.t, torch.from_numpy(rows.astype(np.int64)), 0, torch.from_numpy(lo.astype(np.int64)))
        assert_same_values(cj, ct, "own_delta_counts")
        return sj

    def check_reads(self, keys):
        # whole-table and per-row winners
        wa_j, wa_t = JM.winner_all(self.j), TM.winner_all(self.t)
        live = np.asarray(wa_j.win)
        assert np.array_equal(live, wa_t.win.numpy())
        for f in ("key", "gid", "ctr", "ts"):
            assert_same_values(getattr(wa_j, f), getattr(wa_t, f), f)
        assert_same_values(np.asarray(wa_j.valh)[live], wa_t.valh.numpy()[live], "valh")
        rows = np.arange(self.j.num_buckets, dtype=np.int32)
        rows[::3] = -1
        wr_j = JM.winner_rows(self.j, jnp.asarray(rows))
        wr_t = TM.winner_rows(self.t, torch.from_numpy(rows.astype(np.int64)))
        live = np.asarray(wr_j.win)
        assert np.array_equal(live, wr_t.win.numpy())
        for f in ("key", "gid", "ctr", "ts"):
            assert_same_values(getattr(wr_j, f), getattr(wr_t, f), f)
        # point reads: the jnp path vs the port's (probe grid) path on
        # found rows, and the jnp path vs its plain port everywhere
        kj = JIT.winners_for_keys(self.j, jnp.asarray(keys))
        kt = TM.winners_for_keys(self.t, torch.from_numpy(keys.view(np.int64).copy()))
        kr = t_hm.winners_for_keys_ref(self.t, torch.from_numpy(keys.view(np.int64).copy()))
        found = np.asarray(kj.found)
        assert np.array_equal(found, kt.found.numpy())
        for f in ("found", "gid", "ctr", "valh", "ts"):
            assert_same_values(np.asarray(getattr(kj, f))[found], to_np(getattr(kt, f))[found], f)
            assert_same_values(getattr(kj, f), getattr(kr, f), f)
        assert int(JIT.max_window_fill(self.j)) == int(t_hm.max_window_fill(self.t))
        assert_same_state(JIT.compact_rows(self.j), t_hm.compact_rows(self.t), "compact_rows")


def random_ops(g, n, ts0, pool=40, p_remove=0.2, p_clear=0.0):
    rows = []
    for i in range(n):
        r = g.random()
        k = int(rand_key(g, 1, pool)[0])
        if r < p_clear:
            rows.append((OP_CLEAR, 0, 0, ts0 + i))
        elif r < p_clear + p_remove:
            rows.append((OP_REMOVE, k, 0, ts0 + i))
        else:
            rows.append((OP_ADD, k, int(g.integers(0, 2**32)), ts0 + i))
    return rows


GIDS = (0xF00000000000000B, 7, 0x8000000000000003)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_merge_extract_script(seed):
    g = np.random.default_rng(seed)
    reps = [Pair(gid, capacity=128, num_buckets=16) for gid in GIDS]
    ts = 1
    for step in range(6):
        for r in reps:
            r.apply(random_ops(g, 16, ts, p_clear=0.05 if step == 5 else 0.0))
            ts += 100
        # full-row exchange (the walk's transfer shape) in a ring
        for i, r in enumerate(reps):
            src = reps[(i + 1) % len(reps)]
            rows = list(g.choice(16, 6, replace=False)) + [-1, -1]
            r.merge(src.extract_rows(rows))
        keys = np.concatenate([rand_key(g, 24), g.integers(0, 2**63, 4, dtype=np.int64).astype(np.uint64)])
        for r in reps:
            r.check_reads(keys)


@pytest.mark.parametrize("seed", [0, 1])
def test_own_delta_and_ctx_gap(seed):
    g = np.random.default_rng(10 + seed)
    a, b = Pair(GIDS[0]), Pair(GIDS[1])
    a.apply(random_ops(g, 30, 1, p_remove=0.0))
    rows = np.arange(16, dtype=np.int32)
    # the whole own interval (0, ctx_max] merges cleanly
    b.merge(a.extract_own_delta(rows, np.zeros(16, np.uint32)))
    a.apply(random_ops(g, 30, 100, p_remove=0.1))
    own = np.asarray(a.j.ctx_max[:, 0])
    # an interval that starts past what b has seen gaps on those rows
    lo = np.minimum(own, np.asarray(b.j.ctx_max[:, 1]) + 2).astype(np.uint32)
    sl = a.extract_own_delta(rows, lo)
    rj = b.merge(sl, expect_gap=bool((np.asarray(sl.ctx_rows)[:, 0] > lo).any()))
    assert rj is not None


def test_gid_overflow_grows_writer_table():
    g = np.random.default_rng(7)
    sink = Pair(0xABC, rcap=2)
    writers = [Pair(gid) for gid in GIDS]
    for i, w in enumerate(writers):
        w.apply(random_ops(g, 12, 1 + 50 * i, p_remove=0.0))
        rows = np.arange(16, dtype=np.int32)
        rj = sink.merge(w.extract_rows(rows))
        if i == 1:
            assert bool(rj.need_gid_grow)
    assert sink.j.replica_capacity >= 4
    sink.check_reads(rand_key(g, 16))


def test_fill_growth_and_rehash():
    g = np.random.default_rng(8)
    p = Pair(GIDS[0], capacity=64, num_buckets=8)
    h0 = p.j.table_size
    for step in range(4):
        p.apply(random_ops(g, 48, 1 + 100 * step, pool=400, p_remove=0.1))
    assert p.j.table_size > h0  # at least one rehash happened
    # a merge whose inserts overflow a window: need_fill_grow
    q = Pair(GIDS[1], capacity=64, num_buckets=8)
    rj = q.merge(p.extract_rows(np.arange(8, dtype=np.int32)))
    assert bool(rj.need_fill_grow)
    q.check_reads(rand_key(g, 32, pool=400))


@pytest.mark.parametrize("window", [64, 256])
def test_rehash_widens_window(window):
    g = np.random.default_rng(9)
    p = Pair(GIDS[0], capacity=256, num_buckets=16)
    p.apply(random_ops(g, 96, 1, pool=300))
    H = p.j.table_size * 2
    sj, okj = JIT.rehash(p.j, table_size=H, probe_window=window)
    st, okt = t_hm.rehash(p.t, table_size=H, probe_window=window)
    assert bool(okj) == bool(okt)
    assert_same_state(sj, st, "rehash")
    p.j, p.t = sj, st
    p.apply(random_ops(g, 24, 1000, pool=300))
    p.check_reads(rand_key(g, 40, pool=300))


def test_rehash_reports_overflow():
    g = np.random.default_rng(11)
    p = Pair(GIDS[0], capacity=256, num_buckets=16)
    p.apply(random_ops(g, 150, 1, pool=500, p_remove=0.0))
    # too small a table for the live entries: ok=False on both sides
    sj, okj = JIT.rehash(p.j, table_size=64, probe_window=8)
    st, okt = t_hm.rehash(p.t, table_size=64, probe_window=8)
    assert not bool(okj) and not bool(okt)
    assert_same_state(sj, st, "rehash overflow")


@pytest.mark.parametrize("table_size", [64, 1024])
def test_probe_base_and_window(table_size):
    g = np.random.default_rng(table_size)
    keys = np.concatenate([rand_key(g, 64, pool=2**40), np.array([0, 2**64 - 1], np.uint64)])
    tk = torch.from_numpy(keys.view(np.int64).copy())
    assert np.array_equal(np.asarray(j_hm.probe_base(jnp.asarray(keys), table_size)),
                          t_hm.probe_base(tk, table_size).numpy())
    sj, okj = j_hm._window(jnp.asarray(keys), table_size, 32)
    st, okt = t_hm._window(tk, table_size, 32)
    assert np.array_equal(np.asarray(sj), st.numpy())
    assert np.array_equal(np.asarray(okj), okt.numpy())


def test_grouped_merge_matches_jax():
    """``merge_group_into``: two senders' slices over disjoint rows,
    combined into one merge, against the JAX fan-in."""
    g = np.random.default_rng(13)
    a, b, sink = Pair(GIDS[0]), Pair(GIDS[1]), Pair(GIDS[2])
    a.apply(random_ops(g, 40, 1))
    b.apply(random_ops(g, 40, 500))
    sink.apply(random_ops(g, 12, 900))
    arrays = []
    for p, rows in ((a, np.arange(0, 8, dtype=np.int32)), (b, np.arange(8, 16, dtype=np.int32))):
        sj = JIT.extract_rows_packed(p.j, jnp.asarray(rows), lanes=16)
        arrays.append({c: np.asarray(getattr(sj, c)) for c in sj._fields})
    js, rj, offj = j_hs.merge_group_into(sink.j, arrays)
    ts, rt, offt = t_hs.merge_group_into(sink.t, arrays)
    assert offj == offt
    for f in ("ok", "n_inserted", "n_killed", "n_ins_row", "n_kill_row"):
        assert_same_values(getattr(rj, f), getattr(rt, f), f)
    assert int(rj.n_inserted) > 0
    assert_same_state(js, ts, "merge_group_into")


def test_port_state_round_trip():
    p = Pair(GIDS[2])
    p.apply(random_ops(np.random.default_rng(12), 40, 1))
    again = t_hs.from_numpy(t_hs.to_numpy(p.t), "cpu")
    assert_same_state(p.j, again, "round trip")
    assert TM.geometry(p.t) == JM.geometry(p.j)
