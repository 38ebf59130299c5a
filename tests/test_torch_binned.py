"""PyTorch port vs JAX package: the bucket-binned store and its row ops
(``BinnedStore``, ``init_from_columns``, ``compact_rows``,
``flagged_first_order``, ``merge_slice``, ``extract_rows``,
``merge_rows``).

States are built by the JAX package's own harness from seeded scripts
and carried to the port with ``from_numpy``; every column, flag and
count must agree bit for bit, ``ok=False`` results included (each
escape flag is reached: gid grow, kill tier, fill compact, ctx gap,
insert tier). A merge must never write into its inputs: the host re-runs
a failed merge on the pre-merge state.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.models.binned import BinnedStore as JStore
from delta_crdt_ex_tpu.ops import binned as j_ops
from delta_crdt_ex_tpu.utils.synth import build_state, interval_delta_stream
from delta_crdt_ex_tpu_torch.models import binned as t_bin
from delta_crdt_ex_tpu_torch.ops import binned as t_ops
from tests.kernel_harness import BinnedKernelMap
from tests.test_interval_merge import interval_slice


def carry(state) -> t_bin.BinnedStore:
    """A JAX BinnedStore (single or stacked) as the port's, on the CPU."""
    return t_bin.from_numpy({f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}, "cpu")


def carry_slice(sl) -> t_ops.RowSlice:
    return t_ops.slice_from_wire({c: np.asarray(getattr(sl, c)) for c in sl._fields}, "cpu")


def assert_store_equal(j_state, t_state, ctx=None):
    got = t_bin.to_numpy(t_state)
    for f in dataclasses.fields(j_state):
        want = np.asarray(getattr(j_state, f.name))
        assert got[f.name].dtype == want.dtype, (ctx, f.name)
        assert np.array_equal(got[f.name], want), (ctx, f.name)


def assert_result_equal(rj, rt, ctx=None):
    assert_store_equal(rj.state, rt.state, ctx)
    for f in rj._fields[1:]:
        want = np.asarray(getattr(rj, f))
        got = getattr(rt, f).numpy()
        assert np.array_equal(got.astype(want.dtype), want), (ctx, f)


def snapshot(*objs):
    """Clones of every tensor in the given stores and slices."""
    out = []
    for o in objs:
        ts = [getattr(o, f.name) for f in dataclasses.fields(o)] if dataclasses.is_dataclass(o) else list(o)
        out.append([t.clone() for t in ts])
    return out


def assert_unchanged(snap, *objs):
    for before, o in zip(snap, objs):
        now = [getattr(o, f.name) for f in dataclasses.fields(o)] if dataclasses.is_dataclass(o) else list(o)
        assert all(torch.equal(a, b) for a, b in zip(before, now))


def scripted_pair(seed: int, rcap: int = 4, capacity: int = 128, join: bool | None = None, n_keys: int = 24):
    """``(a, b)`` JAX harness maps after a random add/remove/clear script
    (``tests/test_merge_parity.py``); ``join`` gives a b's dots first,
    so b's slice has kill targets."""
    rng = np.random.default_rng(seed)
    a = BinnedKernelMap(gid=100, capacity=capacity, rcap=rcap, num_buckets=16)
    b = BinnedKernelMap(gid=0xF000000000000200, capacity=capacity, rcap=rcap, num_buckets=16)
    for ts in range(1, int(rng.integers(8, 30))):
        who = a if rng.random() < 0.5 else b
        k = int(rng.integers(0, n_keys)) | (int(rng.integers(0, 2)) << 63)
        op = rng.random()
        if op < 0.7:
            who.add(k, int(rng.integers(0, 2**32)), ts=ts)
        elif op < 0.95:
            who.remove(k, ts=ts)
        else:
            who.clear(ts=ts)
    if join if join is not None else rng.random() < 0.6:
        a.join_from(b)
    return a, b


def all_rows(L: int):
    return jnp.arange(L, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# the store


@pytest.mark.parametrize("grow", [(None, None), (32, None), (None, 16), (64, 32)])
def test_new_and_grow_single_and_stacked(grow):
    j = JStore.new(16, 8, 4)
    t = t_bin.BinnedStore.new(16, 8, 4, device="cpu")
    assert_store_equal(j, t)
    assert_store_equal(j.grow(*grow), t.grow(*grow))
    a, b = scripted_pair(1)
    js = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), a.state, b.state)
    ts = carry(js)
    assert ts.key.shape == (2, 16, a.state.bin_capacity)
    assert_store_equal(js.grow(*grow), ts.grow(*grow))


def test_store_views():
    a, _ = scripted_pair(2, join=True)
    j, t = a.state, carry(a.state)
    assert np.array_equal(np.asarray(j.entry_gid()), t.entry_gid().numpy().view(np.uint64))
    assert np.array_equal(np.asarray(j.global_ctx()), t.global_ctx().numpy().astype(np.uint32))
    assert int(j.own_counter(0)) == int(t.own_counter(0))
    assert int(j.num_alive()) == int(t.num_alive()) > 0
    keys = np.array([5, 2**63 + 17, 2**64 - 1], np.uint64)
    assert np.array_equal(
        np.asarray(j.bucket_of(jnp.asarray(keys))),
        t.bucket_of(torch.from_numpy(keys.view(np.int64).copy())).numpy(),
    )
    assert (t.num_buckets, t.bin_capacity, t.replica_capacity) == (16, j.bin_capacity, 4)


def test_numpy_round_trip_keeps_dtypes_and_bits():
    a, _ = scripted_pair(3, join=True)
    cols = t_bin.to_numpy(carry(a.state))
    assert_store_equal(a.state, t_bin.from_numpy(cols, "cpu"))
    with pytest.raises(TypeError, match="ctr"):
        t_bin.from_numpy({**cols, "ctr": cols["ctr"].astype(np.int64)}, "cpu")


def random_columns(seed: int, L: int = 16, B: int = 8, R: int = 4):
    """Host-built raw columns (holes, top-bit keys and gids, several
    writers) with zeroed invariants, as a bulk load hands them over."""
    g = np.random.default_rng(seed)
    cols = {
        "key": (g.integers(0, 2**63, (L, B), dtype=np.int64).view(np.uint64)
                | (g.integers(0, 2, (L, B)).astype(np.uint64) << np.uint64(63))),
        "valh": g.integers(0, 2**32, (L, B), dtype=np.int64).astype(np.uint32),
        "ts": g.integers(-5, 2**40, (L, B)).astype(np.int64),
        "node": g.integers(0, R, (L, B)).astype(np.int32),
        "ctr": g.integers(0, 2**32, (L, B), dtype=np.int64).astype(np.uint32),
        "alive": g.random((L, B)) < 0.6,
        "ehash": np.zeros((L, B), np.uint32),
        "fill": np.zeros(L, np.int32),
        "amin": np.zeros((L, R), np.uint32),
        "amax": np.zeros((L, R), np.uint32),
        "leaf": np.zeros(L, np.uint32),
        "ctx_gid": np.array([7, 2**63 + 9, 2**64 - 1, 0], np.uint64)[:R],
        "ctx_max": g.integers(0, 2**32, (L, R), dtype=np.int64).astype(np.uint32),
    }
    return cols


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_init_from_columns_and_compact_rows(seed):
    cols = random_columns(seed)
    j = j_ops.init_from_columns(JStore(**{c: jnp.asarray(v) for c, v in cols.items()}))
    t = t_ops.init_from_columns(t_bin.from_numpy(cols, "cpu"))
    assert_store_equal(j, t, seed)
    # holes: kill a third of the alive entries, then repack
    kill = np.random.default_rng(seed + 10).random(cols["alive"].shape) < 0.33
    jh = dataclasses.replace(j, alive=j.alive & ~jnp.asarray(kill))
    th = dataclasses.replace(t, alive=t.alive & ~torch.from_numpy(kill))
    assert_store_equal(j_ops.compact_rows(jh), t_ops.compact_rows(th), seed)


def test_compact_rows_stacked_equals_each_lane():
    lanes = [random_columns(s) for s in (4, 5, 6)]
    stacked = {c: np.stack([x[c] for x in lanes]) for c in lanes[0]}
    j = jax.vmap(j_ops.compact_rows)(JStore(**{c: jnp.asarray(v) for c, v in stacked.items()}))
    t = t_ops.compact_rows(t_bin.from_numpy(stacked, "cpu"))
    assert_store_equal(j, t)
    for i, x in enumerate(lanes):
        solo = t_ops.compact_rows(t_bin.from_numpy(x, "cpu"))
        assert all(torch.equal(getattr(solo, c), getattr(t, c)[i]) for c in t_bin.COLUMNS)


@pytest.mark.parametrize("budget", [1, 4, 16, 32])
def test_flagged_first_order_matches_jax_and_never_fills_with_a_flagged_row(budget):
    rng = np.random.default_rng(7)
    cases = [
        np.array([True] + [False] * 15),  # the alias hazard: row 0 flagged
        np.array([False] * 16),
        np.array([True] * 16),
        np.array([False, True] * 8),
        np.array([False] * 15 + [True]),
    ] + [rng.random(16) < p for p in (0.1, 0.5, 0.9)]
    got_all = t_ops.flagged_first_order(torch.from_numpy(np.stack(cases)), budget).numpy()
    for ci, flags in enumerate(cases):
        want = np.asarray(j_ops.flagged_first_order(jnp.asarray(flags), budget))
        got = t_ops.flagged_first_order(torch.from_numpy(flags), budget).numpy()
        assert np.array_equal(got, want), (ci, got, want)
        assert np.array_equal(got_all[ci], want), ci  # the lane-batched form
        n_flagged = min(int(flags.sum()), got.shape[0])
        assert not flags[got[n_flagged:]].any(), ci


# ---------------------------------------------------------------------------
# merge_slice


@pytest.mark.parametrize("max_inserts", [None, 64, 1024])
@pytest.mark.parametrize("seed", range(6))
def test_merge_slice_state_form_scripts(seed, max_inserts):
    a, b = scripted_pair(seed)
    sl = j_ops.extract_rows(b.state, all_rows(16))
    rj = j_ops.merge_slice(a.state, sl, kill_budget=16, max_inserts=max_inserts)
    rt = t_ops.merge_slice(carry(a.state), carry_slice(sl), 16, max_inserts)
    assert bool(rj.ok)
    assert_result_equal(rj, rt, (seed, max_inserts))


def test_merge_slice_interval_stream():
    """A stream of delta-interval slices merged in order, then a skipped
    interval that must gap (``tests/test_merge_parity.py``)."""
    rng = np.random.default_rng(1)
    L = 64
    keys = rng.integers(1, 1 << 63, size=2000, dtype=np.uint64)
    st, _ = build_state(11, keys, num_buckets=L, bin_capacity=64)
    tst = carry(st)
    slices, _ = interval_delta_stream(22, rng, 4, 64, L, bin_width=8)
    for i, sl in enumerate(slices):
        rj = j_ops.merge_slice(st, sl, kill_budget=L, max_inserts=None if i % 2 else 256)
        rt = t_ops.merge_slice(tst, carry_slice(sl), L, None if i % 2 else 256)
        assert bool(rj.ok) and int(rj.n_inserted) == 64
        assert_result_equal(rj, rt, i)
        st, tst = rj.state, rt.state
    fresh, _ = build_state(11, keys, num_buckets=L, bin_capacity=64)
    rj = j_ops.merge_slice(fresh, slices[1], kill_budget=L)
    rt = t_ops.merge_slice(carry(fresh), carry_slice(slices[1]), L)
    assert bool(rj.need_ctx_gap) and not bool(rj.ok)
    assert_result_equal(rj, rt, "gap")


@pytest.mark.parametrize(
    "rows, entries, lo, hi",
    [
        ([1], [(0, 1, 10, 1, 1)], [0], [1]),  # first interval
        ([1], [], [0], [1]),  # an interval that ships a remove
        ([1], [], [1], [1]),  # an empty interval claims nothing
        ([1, -1], [(0, 1 + 2 * 64, 30, 3, 3)], [2, 0], [3, 0]),  # a gap beneath lo
        ([1], [(0, 1 + 64, 20, 2, 2)], [1], [2]),  # the next interval
    ],
)
def test_merge_slice_hand_built_intervals(rows, entries, lo, hi):
    """``tests/test_interval_merge.py``'s slices on a replica that holds
    the first interval's dot."""
    b = BinnedKernelMap(11)
    b.merge_slice(interval_slice([1], [(0, 1, 10, 1, 1)], [0], [1]))
    sl = interval_slice(rows, entries, lo, hi)
    rj = j_ops.merge_slice(b.state, sl, kill_budget=4)
    rt = t_ops.merge_slice(carry(b.state), carry_slice(sl), 4)
    assert_result_equal(rj, rt)


def _flag_case(name):
    """``(state, slice, kill_budget, max_inserts)`` of a JAX merge that
    raises exactly the named escape flag."""
    if name == "gid":  # an unseen writer, no free slot
        a = BinnedKernelMap(gid=100, capacity=64, rcap=1, num_buckets=16)
        a.add(3, 30, ts=1)
        b = BinnedKernelMap(gid=200, capacity=64, rcap=4, num_buckets=16)
        b.add(5, 50, ts=2)
        return a.state, j_ops.extract_rows(b.state, all_rows(16)), 16, None
    if name == "kill":  # removes in every bucket, kill budget 2
        a, b = BinnedKernelMap(gid=100, capacity=64, num_buckets=16), BinnedKernelMap(gid=200, capacity=64, num_buckets=16)
        for k in range(32):
            b.add(k, k, ts=k + 1)
        a.join_from(b)
        for k in range(32):
            b.remove(k, ts=100 + k)
        return a.state, j_ops.extract_rows(b.state, all_rows(16)), 2, None
    if name == "fill":  # bin capacity 4: 2 alive + 3 inserts in one bucket
        a = BinnedKernelMap(gid=100, capacity=64, num_buckets=16)
        a.add(1, 1, ts=1)
        a.add(17, 2, ts=2)
        b = BinnedKernelMap(gid=200, capacity=256, num_buckets=16)
        for j in range(3):
            b.add(33 + 16 * j, j, ts=10 + j)
        return a.state, j_ops.extract_rows(b.state, all_rows(16)), 16, None
    if name == "gap":
        b = BinnedKernelMap(11)
        b.merge_slice(interval_slice([1], [(0, 1, 10, 1, 1)], [0], [1]))
        return b.state, interval_slice([1], [(0, 129, 30, 3, 3)], [2], [3]), 4, None
    assert name == "ins"  # max_inserts 1 against several inserts
    a, b = scripted_pair(4, join=False)
    return a.state, j_ops.extract_rows(b.state, all_rows(16)), 16, 1


FLAGS = {
    "gid": "need_gid_grow",
    "kill": "need_kill_tier",
    "fill": "need_fill_compact",
    "gap": "need_ctx_gap",
    "ins": "need_ins_tier",
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_merge_slice_escape_flags_and_inputs_survive(name):
    st, sl, kb, mi = _flag_case(name)
    rj = j_ops.merge_slice(st, sl, kill_budget=kb, max_inserts=mi)
    raised = {f for f in FLAGS.values() if bool(getattr(rj, f))}
    assert raised == {FLAGS[name]} and not bool(rj.ok)
    t_state, t_sl = carry(st), carry_slice(sl)
    before = snapshot(t_state, t_sl)
    rt = t_ops.merge_slice(t_state, t_sl, kb, mi)
    assert_result_equal(rj, rt, name)
    assert_unchanged(before, t_state, t_sl)  # a failed merge re-runs on its input
    # and the re-run gives the same result
    assert_result_equal(rj, t_ops.merge_slice(t_state, t_sl, kb, mi), name)


# ---------------------------------------------------------------------------
# extract_rows / merge_rows


@pytest.mark.parametrize("rows", [list(range(16)), [3, -1, 9, 0], [15, 2, -1, -1]])
def test_extract_rows(rows):
    a, _ = scripted_pair(5, join=True)
    r = np.asarray(rows, np.int32)
    sj = j_ops.extract_rows(a.state, jnp.asarray(r))
    st = t_ops.extract_rows(carry(a.state), torch.from_numpy(r.astype(np.int64)))
    wire = t_ops.wire_from_host({c: getattr(st, c).numpy() for c in st._fields})
    for c in sj._fields:
        assert np.array_equal(np.asarray(getattr(sj, c)), wire[c]), c


@pytest.mark.parametrize("seed", range(6))
def test_merge_rows_scripts(seed):
    a, b = scripted_pair(seed + 20)
    sl = j_ops.extract_rows(b.state, all_rows(16))
    rj = j_ops.merge_rows(a.state, sl)
    t_state, t_sl = carry(a.state), carry_slice(sl)
    before = snapshot(t_state, t_sl)
    rt = t_ops.merge_rows(t_state, t_sl)
    assert_result_equal(rj, rt, seed)
    assert_unchanged(before, t_state, t_sl)


@pytest.mark.parametrize("name", ["gid", "fill", "gap"])
def test_merge_rows_escape_flags(name):
    st, sl, _, _ = _flag_case(name)
    rj = j_ops.merge_rows(st, sl)
    assert not bool(rj.ok)
    t_state, t_sl = carry(st), carry_slice(sl)
    before = snapshot(t_state, t_sl)
    assert_result_equal(rj, t_ops.merge_rows(t_state, t_sl), name)
    assert_unchanged(before, t_state, t_sl)


def test_merge_rows_and_merge_slice_agree():
    """The two merges implement one join (``tests/test_merge_parity.py``):
    on state-form slices their states are equal in the port too."""
    for seed in range(4):
        a, b = scripted_pair(seed + 40)
        sl = carry_slice(j_ops.extract_rows(b.state, all_rows(16)))
        r1 = t_ops.merge_slice(carry(a.state), sl, 16)
        r2 = t_ops.merge_rows(carry(a.state), sl)
        assert bool(r1.ok) and bool(r2.ok)
        for c in ("ctx_max", "leaf", "amin", "amax", "ctx_gid"):
            assert torch.equal(getattr(r1.state, c), getattr(r2.state, c)), (seed, c)
        assert int(r1.n_inserted) == int(r2.n_inserted) and int(r1.n_killed) == int(r2.n_killed)
