"""PyTorch port vs JAX package: the binned store's local-mutation and
read ops (``row_apply``, ``clear_all``, ``extract_own_delta``,
``winners_for_keys``, ``winner_all``, ``winner_rows``) and the grouped
ingress merge (``merge_group_into``).

Seeded numpy inputs go through the JAX op and the port's op on the CPU
at a small geometry (L = 16 buckets, B ≤ 16 slots, R = 4 writers); every
state column and every result field must be bit-equal. Winner reads are
compared by ``win`` and the ``win``-selected entries, never by the
arrays at other positions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.models.binned import BinnedStore as JStore
from delta_crdt_ex_tpu.models.binned_map import BinnedAWLWWMap as JMap, CtxGapError as JGapError
from delta_crdt_ex_tpu.ops import binned as j_ops
from delta_crdt_ex_tpu.ops.apply import OP_ADD, OP_REMOVE
from delta_crdt_ex_tpu_torch.models import binned as t_bin, binned_map as t_map
from delta_crdt_ex_tpu_torch.ops import binned as t_ops
from tests.kernel_harness import BinnedKernelMap
from tests.test_torch_binned import assert_result_equal, assert_store_equal, carry, scripted_pair

L = 16
#: the second writer's gid has its top bit set, so unsigned gid orders matter
GID_A, GID_B = 100, 0xF000000000000200


def tt(a) -> torch.Tensor:
    """A numpy/JAX array in the port's layout on the CPU (int32 rows
    widen to int64 indices)."""
    a = np.asarray(a)
    return t_ops._to_torch(a.astype(np.int64) if a.dtype == np.int32 else a, "cpu")


def assert_fields_equal(j, t, ctx=None):
    """Every tensor field of a NamedTuple, values compared in the JAX dtype."""
    for f in j._fields:
        want = np.asarray(getattr(j, f))
        got = getattr(t, f).numpy()
        assert got.shape == want.shape, (ctx, f)
        assert np.array_equal(got.astype(want.dtype), want), (ctx, f)


def random_batch(seed: int, known: list, n: int = 24, rows: int = 5):
    """``(op, key, valh, ts)`` of one mutation batch over ``rows`` buckets:
    fresh and known (overwritten) keys, removes, one key repeated, top-bit
    keys."""
    g = np.random.default_rng(seed)
    # buckets that hold known keys first, so the batch overwrites some
    held = list(dict.fromkeys(k & (L - 1) for k in known))
    buckets = np.array((held + [b for b in g.permutation(L).tolist() if b not in held])[:rows])
    fresh = [int(b) + L * int(j) | (int(t) << 63) for b, j, t in
             zip(g.choice(buckets, n), g.integers(1, 2**20, n), g.integers(0, 2, n))]
    pool = fresh + 3 * [k for k in known if (k & (L - 1)) in set(buckets.tolist())]
    key = np.array([pool[int(i)] for i in g.integers(0, len(pool), n)], np.uint64)
    key[n // 2] = key[n // 3]  # one key twice in the batch
    op = np.where(g.random(n) < 0.75, OP_ADD, OP_REMOVE).astype(np.int32)
    valh = g.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    ts = np.arange(100, 100 + n, dtype=np.int64)
    return op, key, valh, ts


def stacked(*states):
    """JAX states stacked on a lane axis, each first grown to the
    largest bin tier."""
    b = max(s.bin_capacity for s in states)
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *(s.grow(bin_capacity=b) for s in states))


def known_keys(state) -> list:
    a = np.asarray(state.alive)
    return [int(k) for k in np.asarray(state.key)[a]]


def run_row_apply(j_state, t_state, op, key, valh, ts, slot: int = 0):
    g = JMap.group_batch(L, op, key, valh, ts)
    tg = t_map.group_batch(L, op, key, valh, ts)
    for f in ("rows", "op", "key", "valh", "ts"):
        assert np.array_equal(getattr(g, f), getattr(tg, f)), f
    rj = JMap.row_apply(j_state, jnp.int32(slot), *map(jnp.asarray, (g.rows, g.op, g.key, g.valh, g.ts)))
    rt = t_ops.row_apply(t_state, slot, tt(g.rows), torch.from_numpy(g.op.copy()), tt(g.key), tt(g.valh), tt(g.ts))
    return g, rj, rt


# ---------------------------------------------------------------------------
# row_apply


@pytest.mark.parametrize("seed", range(4))
def test_row_apply_batches(seed):
    """Adds, overwrites, removes and one key twice in a batch, on a
    scripted two-writer state; padded rows (5 buckets in a tier of 8)."""
    a, _ = scripted_pair(seed, capacity=256, join=True)
    op, key, valh, ts = random_batch(seed, known_keys(a.state))
    g, rj, rt = run_row_apply(a.state, carry(a.state), op, key, valh, ts)
    assert (g.rows < 0).any() and bool(rj.ok)
    assert_result_equal(rj, rt, seed)
    assert int(rj.n_keys_changed) > 0 and np.asarray(rj.row_killed).any()


def test_row_apply_own_counter_wraps_past_2_32():
    a, _ = scripted_pair(5, capacity=256, join=True)
    near = np.asarray(a.state.ctx_max).copy()
    near[:, 0] = 2**32 - 3
    j = dataclasses.replace(a.state, ctx_max=jnp.asarray(near))
    op, key, valh, ts = random_batch(5, known_keys(j), n=32, rows=3)
    op[:] = OP_ADD
    _, rj, rt = run_row_apply(j, carry(j), op, key, valh, ts)
    assert bool(rj.ok) and int(np.asarray(rj.ctr_assigned).min()) < 8  # wrapped
    assert_result_equal(rj, rt)


def test_row_apply_full_row_is_not_ok_then_grows():
    """A row with no free slot: ``ok`` is False on both (the state is
    the host's to discard), then ``grow_for_apply`` (bin tier ×2) and
    the re-run agree bit for bit."""
    m = BinnedKernelMap(gid=GID_A, capacity=64, rcap=4, num_buckets=L)  # B = 4
    m.batch([(OP_ADD, 3 + L * i, i, i) for i in range(1, 5)])
    assert m.state.bin_capacity == 4 and int(m.state.fill[3]) == 4
    op = np.array([OP_ADD, OP_ADD, OP_REMOVE], np.int32)
    key = np.array([3 + L * 9, 3 + L * 10 | 1 << 63, 3 + L], np.uint64)
    valh = np.array([1, 2, 0], np.uint32)
    ts = np.array([20, 21, 22], np.int64)
    _, rj, rt = run_row_apply(m.state, carry(m.state), op, key, valh, ts)
    assert not bool(rj.ok) and not bool(rt.ok)
    assert np.array_equal(rt.ctr_assigned.numpy(), np.asarray(rj.ctr_assigned).astype(np.int64))
    j2, t2 = JMap.grow_for_apply(m.state), t_map.BinnedAWLWWMap.grow_for_apply(carry(m.state))
    assert_store_equal(j2, t2)
    _, rj, rt = run_row_apply(j2, t2, op, key, valh, ts)
    assert bool(rj.ok) and rj.state.bin_capacity == 8
    assert_result_equal(rj, rt)


def test_row_apply_stacked_lanes_equal_jax_vmap():
    """Lane k of a stacked call is JAX's vmapped lane k (the fleet form)."""
    js = stacked(*(scripted_pair(s, capacity=256, join=True)[0].state for s in (6, 7)))
    batches = [JMap.group_batch(L, *random_batch(10 + i, known_keys(js), n=16, rows=4)) for i in range(2)]
    u = max(b.op.shape[0] for b in batches)
    m = max(b.op.shape[1] for b in batches)

    def stack(f):
        pad = -1 if f == "rows" else 0
        out = []
        for b in batches:
            a = getattr(b, f)
            width = ((0, u - a.shape[0]),) + (((0, m - a.shape[1]),) if a.ndim == 2 else ())
            out.append(np.pad(a, width, constant_values=pad))
        return np.stack(out)
    rj = jax.vmap(j_ops.row_apply)(
        js, jnp.zeros(2, jnp.int32), *(jnp.asarray(stack(f)) for f in ("rows", "op", "key", "valh", "ts"))
    )
    rt = t_ops.row_apply(
        carry(js), torch.zeros(2, dtype=torch.int64), tt(stack("rows")),
        torch.from_numpy(stack("op")), tt(stack("key")), tt(stack("valh")), tt(stack("ts")),
    )
    assert bool(np.asarray(rj.ok).all())
    assert_result_equal(rj, rt)


def test_row_apply_leaves_inputs_intact():
    a, _ = scripted_pair(8, capacity=256, join=True)
    t = carry(a.state)
    before = {c: getattr(t, c).clone() for c in t_bin.COLUMNS}
    op, key, valh, ts = random_batch(8, known_keys(a.state))
    run_row_apply(a.state, t, op, key, valh, ts)
    assert all(torch.equal(before[c], getattr(t, c)) for c in t_bin.COLUMNS)


# ---------------------------------------------------------------------------
# clear_all, extract_own_delta


@pytest.mark.parametrize("seed", [0, 3])
def test_clear_all_single_and_stacked(seed):
    a, b = scripted_pair(seed, join=True)
    assert_store_equal(j_ops.clear_all(a.state), t_ops.clear_all(carry(a.state)))
    js = stacked(a.state, b.state)
    assert_store_equal(jax.vmap(j_ops.clear_all)(js), t_ops.clear_all(carry(js)))


def own_delta_source():
    """A map whose own writer has superseded counters inside each row's
    interval (overwrites) next to a second writer's joined entries."""
    a = BinnedKernelMap(gid=GID_A, capacity=128, rcap=4, num_buckets=L)
    b = BinnedKernelMap(gid=GID_B, capacity=128, rcap=4, num_buckets=L)
    g = np.random.default_rng(3)
    for ts in range(1, 40):
        k = int(g.integers(0, 6)) * L + int(g.integers(0, 8)) | (int(g.integers(0, 2)) << 63)
        (a if ts % 3 else b).add(k, int(g.integers(0, 2**32)), ts=ts)
    a.join_from(b)
    return a


def test_extract_own_delta_padded_rows_and_per_row_lo():
    a = own_delta_source()
    own = np.asarray(a.state.ctx_max)[:, 0]
    rows = np.array([0, 3, -1, 5, 7, 2, -1, 6], np.int32)
    lo = np.where(rows >= 0, own[np.clip(rows, 0, L - 1)] // 2, 7).astype(np.uint32)
    assert (own[rows[rows >= 0]] > 1).all()
    sj = JMap.extract_own_delta(a.state, jnp.asarray(rows), jnp.int32(0), jnp.uint64(GID_A), jnp.asarray(lo))
    st = t_ops.extract_own_delta(
        carry(a.state), tt(rows), 0, torch.tensor(np.uint64(GID_A).view(np.int64)), tt(lo)
    )
    assert_fields_equal(sj, st)
    assert np.asarray(sj.alive).any() and not np.asarray(sj.alive)[rows < 0].any()


def test_extract_own_delta_stacked_equals_jax_vmap():
    a = own_delta_source()
    b, _ = scripted_pair(9, capacity=128, join=True)
    gb = int(np.asarray(b.state.ctx_gid)[0])
    js = stacked(a.state, b.state)
    rows = np.array([[1, 4, -1, 6], [0, 2, 3, -1]], np.int32)
    lo = np.array([[0, 1, 0, 2], [1, 0, 0, 0]], np.uint32)
    gids = np.array([GID_A, gb], np.uint64)
    sj = jax.vmap(j_ops.extract_own_delta)(
        js, jnp.asarray(rows), jnp.zeros(2, jnp.int32), jnp.asarray(gids), jnp.asarray(lo)
    )
    st = t_ops.extract_own_delta(carry(js), tt(rows), torch.zeros(2, dtype=torch.int64), tt(gids), tt(lo))
    assert_fields_equal(sj, st)


# ---------------------------------------------------------------------------
# reads


def tie_columns(seed: int, B: int = 16, R: int = 4):
    """Raw columns whose keys sit in their own bucket rows, few distinct
    keys per row (several entries a key), few timestamps (ts ties broken
    by gid, then by ctr), dead entries, top-bit keys and gids."""
    g = np.random.default_rng(seed)
    rows = np.arange(L)[:, None]
    key = (rows + L * g.integers(0, 4, (L, B))).astype(np.uint64) | (
        g.integers(0, 2, (L, B)).astype(np.uint64) << np.uint64(63)
    )
    return {
        "key": key,
        "valh": g.integers(0, 2**32, (L, B), dtype=np.int64).astype(np.uint32),
        "ts": g.integers(0, 3, (L, B)).astype(np.int64),
        "node": g.integers(0, R, (L, B)).astype(np.int32),
        "ctr": g.integers(0, 3, (L, B)).astype(np.uint32),
        "alive": g.random((L, B)) < 0.7,
        "ehash": np.zeros((L, B), np.uint32),
        "fill": np.zeros(L, np.int32),
        "amin": np.zeros((L, R), np.uint32),
        "amax": np.zeros((L, R), np.uint32),
        "leaf": np.zeros(L, np.uint32),
        "ctx_gid": np.array([7, 2**63 + 9, 2**64 - 1, 2**63], np.uint64)[:R],
        "ctx_max": np.full((L, R), 8, np.uint32),
    }


def tie_state(seed: int):
    cols = tie_columns(seed)
    j = j_ops.init_from_columns(JStore(**{c: jnp.asarray(v) for c, v in cols.items()}))
    return j, carry(j)


def assert_winners_equal(wj, wt, ctx=None):
    win = np.asarray(wj.win)
    assert np.array_equal(wt.win.numpy(), win), ctx
    assert win.any(), ctx
    for f in ("key", "gid", "ctr", "valh", "ts"):
        want = np.asarray(getattr(wj, f))
        got = getattr(wt, f).numpy().astype(want.dtype)
        assert np.array_equal(got[win], want[win]), (ctx, f)


@pytest.mark.parametrize("seed", range(3))
def test_winners_for_keys_ties_dead_and_missing(seed):
    j, t = tie_state(seed)
    cols = tie_columns(seed)
    present = np.unique(cols["key"].reshape(-1))
    missing = (np.arange(L, dtype=np.uint64) + np.uint64(L * 1000)) | np.uint64(1 << 63)
    q = np.concatenate([present, missing])
    wj = JMap.winners_for_keys(j, jnp.asarray(q))
    wt = t_ops.winners_for_keys(t, tt(q))
    assert_fields_equal(wj, wt, seed)
    found = np.asarray(wj.found)
    assert found[: len(present)].any() and not found[len(present):].any()
    assert (~found[: len(present)]).any()  # keys whose every entry is dead


@pytest.mark.parametrize("seed", range(3))
def test_winner_all_and_winner_rows(seed):
    j, t = tie_state(seed)
    assert_winners_equal(JMap.winner_all(j), t_ops.winner_all(t), seed)
    rows = np.array([3, -1, 0, 15, 7, -1, 9, 2], np.int32)
    assert_winners_equal(JMap.winner_rows(j, jnp.asarray(rows)), t_ops.winner_rows(t, tt(rows)), seed)


def test_winner_all_stacked_equals_jax_vmap():
    (j0, _), (j1, _) = tie_state(4), tie_state(5)
    js = stacked(j0, j1)
    assert_winners_equal(jax.vmap(j_ops.winner_all)(js), t_ops.winner_all(carry(js)))


# ---------------------------------------------------------------------------
# the grouped ingress merge


def group_members():
    """Wire bodies of four disjoint-row slices into one target: full-row
    slices of two writers, and two own-delta intervals of a third, the
    second of which starts past what the target holds (a gap)."""
    tgt = BinnedKernelMap(gid=GID_A, capacity=128, rcap=4, num_buckets=L)
    srcs = [BinnedKernelMap(gid=g, capacity=128, rcap=4, num_buckets=L) for g in (GID_B, 300, 2**64 - 5)]
    g = np.random.default_rng(11)

    def writes(ts_range):
        for ts in ts_range:
            k = (0, 4, 8)[ts % 3] + int(g.integers(0, 4)) + L * int(g.integers(0, 5))
            srcs[ts % 3].add(k, int(g.integers(0, 2**32)), ts=ts)

    writes(range(1, 40))
    tgt.add(1 + L, 5, ts=50)
    tgt.join_from(srcs[0])
    writes(range(60, 90))  # overwrites after the join: the target's copies die
    wire = lambda sl: {c: np.asarray(getattr(sl, c)) for c in sl._fields}
    m0 = wire(JMap.extract_rows(srcs[0].state, jnp.arange(0, 4, dtype=jnp.int32)))
    m1 = wire(JMap.extract_rows(srcs[1].state, jnp.arange(4, 8, dtype=jnp.int32)))
    own = np.asarray(srcs[2].state.ctx_max)[:, 0]
    delta = lambda rows, lo: wire(JMap.extract_own_delta(
        srcs[2].state, jnp.asarray(np.array(rows, np.int32)), jnp.int32(0),
        jnp.uint64(2**64 - 5), jnp.asarray(np.array(lo, np.uint32))))
    m2 = delta([8, 9, -1, -1], [0, 0, 0, 0])
    m3 = delta([10, 11, -1, -1], [own[10] - 1, 0, 0, 0])  # row 10 claims (own - 1, own]: a gap
    assert own[10] > 1
    return tgt, [m0, m1, m2, m3]


def test_merge_group_into_clean_group():
    tgt, members = group_members()
    members = members[:3]
    sj, rj, oj = JMap.merge_group_into(tgt.state, members)
    st, rt, ot = t_map.merge_group_into(carry(tgt.state), members)
    assert oj == ot == [(0, 4), (4, 8), (8, 12)]
    assert bool(rj.ok) and int(rj.n_killed) > 0 and int(rj.n_inserted) > 0
    assert_store_equal(sj, st)
    assert_result_equal(rj, rt)


def test_merge_group_into_mid_group_gap_names_the_member():
    tgt, members = group_members()
    members = [members[0], members[3], members[1]]  # the gapped member in the middle
    with pytest.raises(JGapError) as ej:
        JMap.merge_group_into(tgt.state, members)
    with pytest.raises(t_map.CtxGapError) as et:
        t_map.merge_group_into(carry(tgt.state), members)
    assert ej.value.gapped_members == et.value.gapped_members == {1}
    assert np.array_equal(ej.value.gap_rows, et.value.gap_rows)
