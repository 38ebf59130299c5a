"""The packed entry layout, port vs JAX package: ``pack``/``unpack``,
every ``merge_slice_packed`` mode (top_k, ``scatter_compact``,
``fused_aux``), ``compact_rows_packed``, ``grow``, the packed fan-out
(``fanout_merge_packed``, ``fanout_merge_into`` with growth) and the
north-star fan-in script on the packed layout at ``bench.py``'s smoke
geometry. Words, aux tables, flags, counts, retries and tiers must agree
bit for bit, ``ok=False`` results included; the roots of the JAX side
come from ``batched_roots_pallas`` in interpret mode.
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
from delta_crdt_ex_tpu.ops import packed as j_packed
from delta_crdt_ex_tpu.ops.pallas_tree import batched_roots_pallas
from delta_crdt_ex_tpu.parallel import (
    fanout_merge_into as j_fanout_merge_into,
    fanout_merge_packed as j_fanout_merge_packed,
    pack_states as j_pack_states,
    stack_states as j_stack,
)
from delta_crdt_ex_tpu.utils import synth as j_synth
from delta_crdt_ex_tpu_torch.models import binned as t_bin
from delta_crdt_ex_tpu_torch.ops import binned as t_ops
from delta_crdt_ex_tpu_torch.ops import packed as t_packed
from delta_crdt_ex_tpu_torch.ops import roots as t_roots
from delta_crdt_ex_tpu_torch.parallel import batched_sync as t_sync
from delta_crdt_ex_tpu_torch.utils import synth as t_synth
from tests.kernel_harness import BinnedKernelMap
from tests.test_packed_parity import random_divergent_pair
from tests.test_torch_binned import (
    assert_store_equal,
    assert_unchanged,
    carry,
    carry_slice,
    random_columns,
    snapshot,
)

#: the JAX merge, compiled once a mode and tier (op by op, each first
#: call of a primitive compiles on its own, which costs more here)
j_merge = jax.jit(
    j_packed.merge_slice_packed,
    static_argnames=("kill_budget", "max_inserts", "fused_aux", "scatter_compact", "rows_sorted"),
)

MODES = {
    "top_k": {},
    "scomp": {"scatter_compact": True},
    "fused": {"fused_aux": True},
}


def carry_packed(p) -> t_packed.PackedStore:
    """A JAX PackedStore (single or stacked) as the port's, on the CPU."""
    return t_packed.packed_from_numpy({f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}, "cpu")


def assert_packed_equal(j_state, t_state, ctx=None):
    assert t_state.words.dtype == torch.int32, ctx
    got = t_packed.packed_to_numpy(t_state)
    for f in dataclasses.fields(j_state):
        want = np.asarray(getattr(j_state, f.name))
        assert got[f.name].dtype == want.dtype, (ctx, f.name)
        assert np.array_equal(got[f.name], want), (ctx, f.name)


def assert_result_equal(rj, rt, ctx=None):
    assert_packed_equal(rj.state, rt.state, ctx)
    for f in rj._fields[1:]:
        want = np.asarray(getattr(rj, f))
        got = getattr(rt, f).numpy()
        assert np.array_equal(got.astype(want.dtype), want), (ctx, f)


def wild_state(seed: int):
    """A JAX BinnedStore with top-bit keys, negative ts, and valh, ctr
    and ehash words with bit 31 set (``random_columns``)."""
    cols = random_columns(seed)
    cols["ts"] = cols["ts"] - 2**39  # about half of them negative
    return jax.jit(j_ops.init_from_columns)(JStore(**{c: jnp.asarray(v) for c, v in cols.items()}))


# ---------------------------------------------------------------------------
# the layout


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_bit_equal_to_jax(seed):
    js = wild_state(seed)
    ts = carry(js)
    for c in ("key", "valh", "ctr", "ehash"):
        assert bool((getattr(ts, c) >= 2**31).any() if c != "key" else (ts.key < 0).any()), c
    assert bool((ts.ts < 0).any())
    pj, pt = j_packed.pack(js), t_packed.pack(ts)
    assert_packed_equal(pj, pt)
    assert_store_equal(j_packed.unpack(pj), t_packed.unpack(pt))
    assert_store_equal(js, t_packed.unpack(pt))
    # a neighbour stack packs in one call, lane for lane
    js2 = j_stack([js, wild_state(seed + 5)])
    pt2 = t_packed.pack(carry(js2))
    assert_packed_equal(j_packed.pack(js2), pt2)
    assert pt2.words.shape == (2, 16, 8, 8)
    assert_packed_equal(j_packed.pack(js2), carry_packed(j_packed.pack(js2)))


def test_words_are_32_bit_and_the_stack_is_32_bytes_an_entry():
    one = t_bin.BinnedStore.new(64, 16, 8, device="cpu")
    stack = t_sync.pack_states(t_sync.stack_states([one] * 4))
    assert stack.words.dtype == torch.int32 and stack.words.shape == (4, 64, 16, 8)
    assert stack.words.numel() * stack.words.element_size() == 4 * 64 * 16 * 32
    col = t_sync.stack_states([one] * 4)
    col_bytes = sum(getattr(col, c).numel() * getattr(col, c).element_size()
                    for c in ("key", "valh", "ts", "node", "ctr", "alive", "ehash"))
    assert col_bytes == 4 * 64 * 16 * 45
    with pytest.raises(ValueError, match="16 bits"):
        t_packed.pack(t_bin.BinnedStore.new(4, 2, 1 << 16, device="cpu"))
    with pytest.raises(TypeError, match="words"):
        t_packed.packed_from_numpy({**t_packed.packed_to_numpy(stack), "words": np.zeros(3, np.int32)}, "cpu")


def test_grow_and_compact_rows_packed_match_jax():
    js = wild_state(3)
    pj, pt = j_packed.pack(js), t_packed.pack(carry(js))
    gj, gt = pj.grow(bin_capacity=16, replica_capacity=8), pt.grow(bin_capacity=16, replica_capacity=8)
    assert (gt.bin_capacity, gt.replica_capacity, gt.num_buckets) == (16, 8, 16)
    assert_packed_equal(gj, gt)
    kill = np.random.default_rng(3).random(js.alive.shape) < 0.4
    hj = j_packed.pack(dataclasses.replace(js, alive=js.alive & ~jnp.asarray(kill)))
    ht = carry_packed(hj)
    assert_packed_equal(j_packed.compact_rows_packed(hj), t_packed.compact_rows_packed(ht))
    assert_store_equal(j_ops.compact_rows(j_packed.unpack(hj)), t_packed.unpack(t_packed.compact_rows_packed(ht)))


# ---------------------------------------------------------------------------
# the merge, every mode


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
@pytest.mark.parametrize("mode", list(MODES))
def test_merge_slice_packed_matches_jax(mode, seed):
    """``test_packed_parity.py``'s seeded divergent pairs, through every
    mode, with the grid uncompacted (None), an insert tier that
    overflows (8) and one that fits (256); the inputs stay untouched."""
    rng = np.random.default_rng(seed)
    kw = MODES[mode]
    for trial in range(3):
        a, b = random_divergent_pair(rng, L=16)
        sl = j_ops.extract_rows(b.state, jnp.arange(16, dtype=jnp.int32))
        pj = j_packed.pack(a.state)
        pt, slt = t_packed.pack(carry(a.state)), carry_slice(sl)
        snap = snapshot(pt, slt)
        for mi in (None, 8, 256):
            rj = j_merge(pj, sl, kill_budget=16, max_inserts=mi, **kw)
            rt = t_packed.merge_slice_packed(pt, slt, 16, mi, **kw)
            assert_result_equal(rj, rt, (mode, seed, trial, mi))
        assert_unchanged(snap, pt, slt)


@pytest.mark.parametrize("mode", list(MODES))
def test_interval_stream_with_ctr_past_the_sign_bit(mode):
    """An interval stream whose per-bucket counters start at 2^31 − 64
    (the first slice state-form, so the unknown writer's context does
    not gap), merged slice after slice: every ordered compare and
    reduction over the ``ctr`` plane must read it unsigned."""
    L, B = 4, 256
    rng = np.random.default_rng(15)
    keys = rng.integers(1, 1 << 63, size=100, dtype=np.uint64)
    js, _ = j_synth.build_state(11, keys, L, B, 8)
    slices, _ = j_synth.interval_delta_stream(
        22, rng, 6, 64, L, next_ctr=np.full(L, 2**31 - 64, np.uint32), bin_width=32
    )
    slices[0] = slices[0]._replace(ctx_lo=jnp.zeros_like(slices[0].ctx_lo))
    pj = j_packed.pack(js)
    pt = carry_packed(pj)
    for i, sl in enumerate(slices):
        rj = j_merge(pj, sl, kill_budget=L, max_inserts=64, **MODES[mode])
        rt = t_packed.merge_slice_packed(pt, carry_slice(sl), L, 64, **MODES[mode])
        assert bool(rj.ok), i
        assert_result_equal(rj, rt, (mode, i))
        pj, pt = rj.state, rt.state
    ctr = t_packed.unpack(pt).ctr[t_packed.unpack(pt).alive]
    assert int((ctr >= 2**31).sum()) > 0 and int((ctr < 2**31).sum()) > 0
    assert int(pt.amax.max()) >= 2**31 and int(pt.ctx_max[:, 1].min()) >= 2**31


def test_rows_sorted_changes_nothing():
    """Shuffled slice rows: the port's scomp merge with ``rows_sorted``
    True and False equals JAX's with False (torch takes no scatter
    hint); ascending rows equal JAX's vouched call."""
    rng = np.random.default_rng(12)
    for trial in range(3):
        a, b = random_divergent_pair(rng, L=16)
        pj, pt = j_packed.pack(a.state), t_packed.pack(carry(a.state))
        for rows in (rng.permutation(16), np.arange(16)):
            sl = j_ops.extract_rows(b.state, jnp.asarray(rows.astype(np.int32)))
            vouch = bool((np.diff(rows) > 0).all())
            rj = j_merge(pj, sl, kill_budget=16, max_inserts=256, scatter_compact=True, rows_sorted=vouch)
            for flag in (False, True):
                rt = t_packed.merge_slice_packed_scomp(pt, carry_slice(sl), 16, 256, rows_sorted=flag)
                assert_result_equal(rj, rt, (trial, vouch, flag))


def test_packed_equals_the_column_merge():
    """On valid merges the packed result unpacks to the port's column
    merge, state for state."""
    rng = np.random.default_rng(16)
    for trial in range(4):
        a, b = random_divergent_pair(rng, L=16)
        ts, slt = carry(a.state), carry_slice(j_ops.extract_rows(b.state, jnp.arange(16, dtype=jnp.int32)))
        rc = t_ops.merge_slice(ts, slt, 16, 256)
        for mode, kw in MODES.items():
            rp = t_packed.merge_slice_packed(t_packed.pack(ts), slt, 16, 256, **kw)
            assert bool(rc.ok) == bool(rp.ok)
            if bool(rc.ok):
                for c in t_bin.COLUMNS:
                    assert torch.equal(getattr(t_packed.unpack(rp.state), c), getattr(rc.state, c)), (mode, c)


# ---------------------------------------------------------------------------
# the packed fan-out


def neighbour_stack(n: int = 4, L: int = 16):
    from tests.test_torch_fanin import neighbours

    maps, sl = neighbours(n, L=L)
    return j_stack([m.state for m in maps]), sl


@pytest.mark.parametrize("scomp", [True, False])
def test_fanout_merge_packed_lanes_match_jax_and_solo(scomp):
    stacked, sl = neighbour_stack()
    pj = j_pack_states(stacked)
    rj = j_fanout_merge_packed(pj, sl, kill_budget=16, max_inserts=64, scatter_compact=scomp)
    pt = t_sync.pack_states(carry(stacked))
    rt = t_sync.fanout_merge_packed(pt, carry_slice(sl), 16, 64, scatter_compact=scomp)
    assert bool(rj.ok.all()) and int(np.asarray(rj.n_killed).sum()) > 0
    assert_result_equal(rj, rt)
    for i, lane in enumerate(t_sync.unstack_states(pt)):
        solo = t_packed.merge_slice_packed(lane, carry_slice(sl), 16, 64, scatter_compact=scomp)
        assert torch.equal(solo.state.words, rt.state.words[i]) and torch.equal(solo.state.leaf, rt.state.leaf[i])
        for f in solo._fields[1:]:
            assert torch.equal(getattr(solo, f), getattr(rt, f)[i]), (i, f)
    with pytest.raises(TypeError, match="PackedStore"):
        t_sync.fanout_merge_packed(carry(stacked), carry_slice(sl))


@pytest.mark.parametrize("scatter_compact", [None, False, True])
def test_fanout_merge_into_growth_matches_jax(scatter_compact):
    """``test_packed_parity.py:130``'s growth script (kill budget, bin
    tier and gid table all overflow) through ``fanout_merge_into`` on a
    packed stack: the same retries, tiers and words as the JAX package,
    and the unpacked stack equal to the port's column result."""
    n, L = 8, 16
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

    pj, rj, nj = j_fanout_merge_into(j_pack_states(stacked), sl, kill_budget=2, scatter_compact=scatter_compact)
    grows = []
    pt, rt, nt = t_sync.fanout_merge_into(
        t_sync.pack_states(carry(stacked)), carry_slice(sl), kill_budget=2,
        on_grow=grows.append, scatter_compact=scatter_compact, rows_sorted=True,
    )
    assert 1 <= nj == nt and grows and all(isinstance(g, t_packed.PackedStore) for g in grows)
    assert (pt.bin_capacity, pt.replica_capacity) == (pj.bin_capacity, pj.replica_capacity)
    assert pt.bin_capacity >= 8 and pt.replica_capacity >= 4
    assert_packed_equal(pj, pt)
    assert_result_equal(rj, rt)
    ct, _, nc = t_sync.fanout_merge_into(carry(stacked), carry_slice(sl), kill_budget=2)
    assert nc == nt
    for c in t_bin.COLUMNS:
        assert torch.equal(getattr(t_packed.unpack(pt), c), getattr(ct, c)), c


@pytest.mark.parametrize("scomp", [True, False])
def test_packed_fanin_at_smoke_geometry_matches_jax(scomp):
    """``bench.py``'s north-star fan-in on the packed layout
    (``merge_slice_packed_scomp`` with ``rows_sorted=True``, or the
    ``packed_topk`` alternate) at its ``BENCH_SMOKE`` sizes: 4096 keys,
    L = 2^8, B = 64, 4 neighbours, groups of 4 × 128-entry deltas, 1
    warm-up and 2 timed calls, then the roots."""
    L, B, N, delta, group = 1 << 8, 64, 4, 128, 4
    gj, gt = np.random.default_rng(0), np.random.default_rng(0)
    keys = gj.integers(1, 1 << 63, size=4096, dtype=np.uint64)
    assert np.array_equal(keys, gt.integers(1, 1 << 63, size=4096, dtype=np.uint64))
    one_j, _ = j_synth.build_state(11, keys, L, B, 8)
    one_t, _ = t_synth.build_state(11, keys, L, B, 8, device="cpu")
    sj = j_pack_states(jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), one_j))
    st = t_sync.pack_states(t_sync.stack_states([one_t] * N))
    assert_packed_equal(sj, st)
    nj = nt = None
    before = t_roots.batched_roots_kernel.launches
    for call in range(3):
        (slj,), nj = j_synth.interval_delta_stream(22, gj, 1, group * delta, L, next_ctr=nj, bin_width=16)
        (slt,), nt = t_synth.interval_delta_stream(22, gt, 1, group * delta, L, next_ctr=nt, bin_width=16, device="cpu")
        rj = j_fanout_merge_packed(sj, slj, kill_budget=8, max_inserts=group * delta,
                                   scatter_compact=scomp, rows_sorted=True)
        rt = t_sync.fanout_merge_packed(st, slt, 8, group * delta, scatter_compact=scomp, rows_sorted=True)
        assert bool(rj.ok.all()) and (rt.n_inserted == group * delta).all() and (rt.n_killed == 0).all()
        assert_result_equal(rj, rt, call)
        sj, st = rj.state, rt.state
        want = np.asarray(batched_roots_pallas(sj.leaf, interpret=True)).astype(np.int64)
        assert np.array_equal(t_roots.batched_roots(st.leaf).numpy(), want), call
    assert t_roots.batched_roots_kernel.launches == before  # CPU tensors: the plain version
    lane0 = t_packed.unpack(t_sync.unstack_states(st)[0])
    assert int(lane0.alive.sum()) == 4096 + 3 * group * delta
    assert torch.equal(t_ops.compact_rows(lane0).leaf, lane0.leaf)


def test_torch_bulk_fanout_example_runs_on_the_cpu_and_never_falls_back():
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "examples" / "torch_bulk_fanout.py"
    out = subprocess.run([sys.executable, str(script), "--device", "cpu"], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert "16 neighbours in one call on cpu" in out and "torch.int32" in out and "[68] live dots" in out
    if not torch.cuda.is_available():
        bare = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=120)
        assert bare.returncode != 0 and "CUDA is not available" in bare.stderr
