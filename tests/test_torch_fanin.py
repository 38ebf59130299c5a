"""The binned-store fan-in path, port vs JAX package: the synthetic
workload builders, the neighbour-stack merges (``fanout_merge``,
``fanout_merge_into``, ``ring_gossip_round``), and the whole north-star
fan-in script (``bench.py``'s column layout) at its smoke geometry —
every stack column, flag and root bit-equal, the JAX roots taken from
``batched_roots_pallas`` in interpret mode.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.ops import binned as j_ops
from delta_crdt_ex_tpu.ops.pallas_tree import batched_roots_pallas
from delta_crdt_ex_tpu.parallel import (
    fanout_merge as j_fanout_merge,
    fanout_merge_into as j_fanout_merge_into,
    ring_gossip_round as j_ring_gossip_round,
    stack_states as j_stack,
)
from delta_crdt_ex_tpu.utils import synth as j_synth
from delta_crdt_ex_tpu_torch.models import binned as t_bin
from delta_crdt_ex_tpu_torch.ops import binned as t_ops
from delta_crdt_ex_tpu_torch.ops import roots as t_roots
from delta_crdt_ex_tpu_torch.parallel import batched_sync as t_sync
from delta_crdt_ex_tpu_torch.utils import synth as t_synth
from tests.kernel_harness import BinnedKernelMap
from tests.test_torch_binned import assert_result_equal, assert_store_equal, carry, carry_slice


def assert_slice_equal(sj, st):
    wire = t_ops.wire_from_host({c: getattr(st, c).numpy() for c in st._fields})
    for c in sj._fields:
        assert np.array_equal(np.asarray(getattr(sj, c)), wire[c]), c


def test_synth_matches_jax():
    keys = np.random.default_rng(3).integers(1, 1 << 63, size=3000, dtype=np.uint64)
    sj, nj = j_synth.build_state(11, keys, 64, 128, 8)
    st, nt = t_synth.build_state(11, keys, 64, 128, 8, device="cpu")
    assert_store_equal(sj, st)
    assert np.array_equal(nj, nt) and nt.dtype == np.uint32
    gj, gt = np.random.default_rng(4), np.random.default_rng(4)
    slj, nj = j_synth.interval_delta_stream(22, gj, 3, 200, 64, next_ctr=nj, bin_width=16)
    slt, nt = t_synth.interval_delta_stream(22, gt, 3, 200, 64, next_ctr=nt, bin_width=16, device="cpu")
    assert np.array_equal(nj, nt)
    assert len(slt) == 3 and slt[0].key.shape == (256, 16)
    for a, b in zip(slj, slt):
        assert_slice_equal(a, b)


def neighbours(n: int, capacity: int = 64, rcap: int = 4, L: int = 16):
    """n JAX harness maps of distinct content; odd lanes hold the delta
    writer's older dots, so its slice kills there."""
    src = BinnedKernelMap(gid=0xF000000000000999, capacity=capacity, rcap=rcap, num_buckets=L)
    for k in range(10):
        src.add(k, 1000 + k, ts=k + 1)
    maps = []
    for i in range(n):
        m = BinnedKernelMap(gid=100 + i, capacity=capacity, rcap=rcap, num_buckets=L)
        for k in range(i + 1):
            m.add(50 + 7 * k + i, i, ts=20 + k)
        if i % 2:
            m.join_from(src)
        maps.append(m)
    for k in range(0, 10, 3):
        src.remove(k, ts=40 + k)
    for k in range(6):
        src.add(200 + k, k, ts=60 + k)
    return maps, j_ops.extract_rows(src.state, jnp.arange(L, dtype=jnp.int32))


@pytest.mark.parametrize("max_inserts", [None, 64])
def test_fanout_lanes_equal_solo_merges(max_inserts):
    maps, sl = neighbours(4)
    stacked = j_stack([m.state for m in maps])
    rj = j_fanout_merge(stacked, sl, kill_budget=16, max_inserts=max_inserts)
    t_stack, t_sl = carry(stacked), carry_slice(sl)
    rt = t_sync.fanout_merge(t_stack, t_sl, 16, max_inserts)
    assert bool(rj.ok.all()) and int(np.asarray(rj.n_killed).sum()) > 0
    assert_result_equal(rj, rt)
    for i, lane in enumerate(t_sync.unstack_states(t_stack)):
        solo = t_ops.merge_slice(lane, t_sl, 16, max_inserts)
        for c in t_bin.COLUMNS:
            assert torch.equal(getattr(solo.state, c), getattr(rt.state, c)[i]), (i, c)
        for f in solo._fields[1:]:
            assert torch.equal(getattr(solo, f), getattr(rt, f)[i]), (i, f)


def test_fanout_merge_into_tier_overflow_matches_jax():
    """``tests/test_parallel.py:194``: 64 neighbours; the slice overflows
    the kill budget, the bins and the gid table; the retry loop must end
    in the same state after the same number of retries."""
    n, L = 64, 16
    origin = BinnedKernelMap(gid=500, capacity=64, rcap=2, num_buckets=L)
    for k in range(32):
        origin.add(k, k, ts=k + 1)
    maps = [BinnedKernelMap(gid=100 + i, capacity=64, rcap=2, num_buckets=L) for i in range(n)]
    for m in maps:
        m.join_from(origin)
    stacked = j_stack([m.state for m in maps])
    updater = BinnedKernelMap(gid=999, capacity=64, rcap=4, num_buckets=L)
    updater.join_from(origin)
    for k in range(32):
        updater.remove(k, ts=100 + k)
    for j in range(48):
        updater.add(32 + j, 7000 + j, ts=200 + j)
    sl = j_ops.extract_rows(updater.state, jnp.arange(L, dtype=jnp.int32))

    sj, rj, nj = j_fanout_merge_into(stacked, sl, kill_budget=2)
    grows = []
    st, rt, nt = t_sync.fanout_merge_into(carry(stacked), carry_slice(sl), kill_budget=2, on_grow=grows.append)
    assert 1 <= nj == nt
    assert st.bin_capacity >= 8 and st.replica_capacity >= 4 and grows
    assert_store_equal(sj, st)
    assert_result_equal(rj, rt)


def test_scatter_compact_on_a_column_stack_raises():
    maps, sl = neighbours(2)
    with pytest.raises(TypeError, match="PackedStore"):
        t_sync.fanout_merge_into(carry(j_stack([m.state for m in maps])), carry_slice(sl), scatter_compact=True)


def test_ring_gossip_round_matches_jax():
    """``tests/test_parallel.py:58``: N - 1 rounds converge a ring."""
    n = 4
    maps = [BinnedKernelMap(gid=100 + i, capacity=64, rcap=8, num_buckets=64) for i in range(n)]
    for i, m in enumerate(maps):
        m.add(10 + i, i, ts=i + 1)
        m.add(2**63 + 64 * i + 3, 7 * i, ts=i + 9)
    sj = j_stack([m.state for m in maps])
    st = carry(sj)
    for _ in range(n - 1):
        rj, rt = j_ring_gossip_round(sj), t_sync.ring_gossip_round(st)
        assert bool(rj.ok.all())
        assert_result_equal(rj, rt)
        sj, st = rj.state, rt.state
    roots = t_roots.batched_roots(st.leaf)
    assert (roots == roots[0]).all()
    # writer slots and in-row order are each replica's own; the leaf
    # digests and the content over global writer ids are not
    assert (st.leaf == st.leaf[:1]).all()
    views = [canonical(lane) for lane in t_sync.unstack_states(st)]
    assert all(v == views[0] for v in views) and len(views[0][0]) == 2 * n


def canonical(lane: t_bin.BinnedStore):
    """A replica's content over global writer ids: its alive entries as
    sorted (key, writer gid, ctr, ts, valh) and its context as sorted
    (bucket, writer gid, max counter)."""
    c = t_bin.to_numpy(lane)
    gid = c["ctx_gid"][c["node"]]
    a = c["alive"]
    entries = sorted(zip(*(x[a].tolist() for x in (c["key"], gid, c["ctr"], c["ts"], c["valh"]))))
    b, r = np.nonzero(c["ctx_max"])
    ctx = sorted(zip(b.tolist(), c["ctx_gid"][r].tolist(), c["ctx_max"][b, r].tolist()))
    return entries, ctx


def test_fanin_slice_at_smoke_geometry_matches_jax():
    """``bench.py``'s north-star fan-in with ``BENCH_SMOKE`` sizes and the
    column layout: 4096 keys, L = 2^8, B = 64, 4 neighbours, groups of
    4 × 128-entry deltas, 1 warm-up and 2 timed calls of
    ``fanout_merge(kill_budget=8, max_inserts=512)`` then the roots."""
    L, B, N, delta, group = 1 << 8, 64, 4, 128, 4
    gj, gt = np.random.default_rng(0), np.random.default_rng(0)
    keys = gj.integers(1, 1 << 63, size=4096, dtype=np.uint64)
    assert np.array_equal(keys, gt.integers(1, 1 << 63, size=4096, dtype=np.uint64))
    one_j, _ = j_synth.build_state(11, keys, L, B, 8)
    one_t, _ = t_synth.build_state(11, keys, L, B, 8, device="cpu")
    sj = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), one_j)
    st = t_sync.stack_states([one_t] * N)
    nj = nt = None
    before = t_roots.batched_roots_kernel.launches
    for call in range(3):
        (slj,), nj = j_synth.interval_delta_stream(22, gj, 1, group * delta, L, next_ctr=nj, bin_width=16)
        (slt,), nt = t_synth.interval_delta_stream(22, gt, 1, group * delta, L, next_ctr=nt, bin_width=16, device="cpu")
        rj = j_fanout_merge(sj, slj, kill_budget=8, max_inserts=group * delta)
        rt = t_sync.fanout_merge(st, slt, 8, group * delta)
        assert bool(rj.ok.all()) and (rt.n_inserted == group * delta).all() and (rt.n_killed == 0).all()
        assert_result_equal(rj, rt, call)
        sj, st = rj.state, rt.state
        want = np.asarray(batched_roots_pallas(sj.leaf, interpret=True)).astype(np.int64)
        assert np.array_equal(t_roots.batched_roots(st.leaf).numpy(), want), call
    assert t_roots.batched_roots_kernel.launches == before  # CPU tensors: the plain version
    assert int(st.alive[0].sum()) == 4096 + 3 * group * delta
    lane0 = t_sync.unstack_states(st)[0]
    assert torch.equal(t_ops.compact_rows(lane0).leaf, lane0.leaf)
    assert dataclasses.is_dataclass(st) and st.key.shape == (N, L, B)
