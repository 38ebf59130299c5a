"""PyTorch port vs JAX package: cross-kernel merge parity
(``tests/test_merge_parity.py``).

The row-granular merge (``merge_rows``, the runtime path), the
element-scatter merge (``merge_slice``, the fan-in path) and the packed
merges (``merge_slice_packed`` with a top-k or a cumsum-rank insert
compaction) implement one join. Within the port all four give the same
lattice state (reads, dots, context, digests, summaries) on the same
slice, including the large writer table and every insert-compaction
tier; and each one equals the JAX package's merge of the same mode bit
for bit, every column and every counter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from delta_crdt_ex_tpu.ops import binned as j_ops, packed as j_packed
from delta_crdt_ex_tpu.utils.synth import build_state, interval_delta_stream
from delta_crdt_ex_tpu_torch.ops import binned as t_ops, packed as t_packed
from tests.kernel_harness import BinnedKernelMap
from tests.test_torch_binned import carry
from tests.test_torch_lattice import as_u64, assert_state_same, port_slice, jax_compiles_released  # noqa: F401 (autouse)

# the JAX side jitted once a shape (op-by-op dispatch would compile
# every primitive of every call)
_j_slice = jax.jit(j_ops.merge_slice, static_argnames=("kill_budget", "max_inserts"))
_j_rows = jax.jit(j_ops.merge_rows)
_j_topk = jax.jit(lambda s, sl, kb, mi: j_packed.merge_slice_packed(j_packed.pack(s), sl, kb, mi), static_argnums=(2, 3))
_j_scomp = jax.jit(
    lambda s, sl, kb, mi: j_packed.merge_slice_packed_scomp(j_packed.pack(s), sl, kb, mi), static_argnums=(2, 3)
)
j_unpack = jax.jit(j_packed.unpack)

#: merge modes: (JAX call, port call); the packed modes merge a packed
#: copy of the state and hand back the column layout
MODES = {
    "slice": (
        lambda s, sl, kb, mi: _j_slice(s, sl, kill_budget=kb, max_inserts=mi),
        lambda s, sl, kb, mi: t_ops.merge_slice(s, sl, kb, mi),
    ),
    "rows": (lambda s, sl, kb, mi: _j_rows(s, sl), lambda s, sl, kb, mi: t_ops.merge_rows(s, sl)),
    "packed_topk": (_j_topk, lambda s, sl, kb, mi: t_packed.merge_slice_packed(t_packed.pack(s), sl, kb, mi)),
    "packed_scomp": (
        _j_scomp,
        lambda s, sl, kb, mi: t_packed.merge_slice_packed_scomp(t_packed.pack(s), sl, kb, mi),
    ),
}
COUNTERS = ("ok", "n_inserted", "n_killed")


def column_state(res, unpack):
    state = res.state
    return unpack(state) if hasattr(state, "words") else state


def lattice_view(state) -> tuple:
    """The slot-independent view of a port store: LWW reads, the alive
    dot set by (writer gid, bucket, ctr), and the context, digest and
    summary columns."""
    w = t_ops.winner_all(state)
    read = dict(zip(as_u64(w.key[w.win]).tolist(), w.valh[w.win].tolist()))
    gid = as_u64(state.entry_gid())
    u, b = np.nonzero(state.alive.numpy())
    dots = {(int(gid[x, y]), int(x), int(state.ctr[x, y])) for x, y in zip(u, b)}
    return read, dots, *(getattr(state, c).numpy().tobytes() for c in ("ctx_max", "leaf", "amin", "amax"))


def merge_all(j_state, j_sl, kill_budget, max_inserts=None, modes=MODES) -> dict:
    """Every mode's merge on both packages: each port result equals the
    JAX result of its mode (state and counters); returns the port's
    ``{mode: result}``."""
    t_state, t_sl = carry(j_state), port_slice(j_sl)
    out = {}
    for mode in modes:
        jf, tf = MODES[mode]
        rj, rt = jf(j_state, j_sl, kill_budget, max_inserts), tf(t_state, t_sl, kill_budget, max_inserts)
        for f in COUNTERS + ("need_ctx_gap",):
            assert int(getattr(rt, f)) == int(getattr(rj, f)), (mode, f)
        if bool(rj.ok):
            assert_state_same(column_state(rj, j_unpack), column_state(rt, t_packed.unpack), mode)
        out[mode] = rt
    return out


def assert_modes_agree(results: dict, ctx):
    views = {m: lattice_view(column_state(r, t_packed.unpack)) for m, r in results.items() if bool(r.ok)}
    first = next(iter(views.values()))
    for m, v in views.items():
        assert v == first, (ctx, m)


def scripted(rng, L, capacity, rcap, n_keys, n_ts, p_add, p_remove):
    a = BinnedKernelMap(gid=100, capacity=capacity, rcap=rcap, num_buckets=L)
    b = BinnedKernelMap(gid=200, capacity=capacity, rcap=rcap, num_buckets=L)
    for ts in range(1, n_ts):
        who = a if rng.random() < 0.5 else b
        k = int(rng.integers(0, n_keys))
        op = rng.random()
        if op < p_add:
            who.add(k, int(rng.integers(0, 100)), ts=ts)
        elif op < p_remove:
            who.remove(k, ts=ts)
        else:
            who.clear(ts=ts)
    return a, b


def all_rows(L):
    return jnp.arange(L, dtype=jnp.int32)


def test_state_form_slices_identical_across_kernels():
    rng = np.random.default_rng(0)
    L = 16
    for trial in range(12):
        a, b = scripted(rng, L, 128, 4, 24, int(rng.integers(2, 25)), 0.7, 0.95)
        if rng.random() < 0.6:
            a.join_from(b)  # gives kills remote targets
        res = merge_all(a.state, j_ops.extract_rows(b.state, all_rows(L)), L)
        assert all(bool(r.ok) for r in res.values()), trial
        assert_modes_agree(res, trial)
        assert len({(int(r.n_inserted), int(r.n_killed)) for r in res.values()}) == 1, trial


def test_interval_stream_and_gap_parity():
    rng = np.random.default_rng(1)
    L = 64
    keys = rng.integers(1, 1 << 63, size=2000, dtype=np.uint64)
    keys[::7] |= np.uint64(1 << 63)  # top-bit keys ride the stream too
    base, _ = build_state(11, keys, num_buckets=L, bin_capacity=64)
    slices, _ = interval_delta_stream(22, rng, 6, 64, L, bin_width=8)
    states = {m: carry(base) for m in MODES}
    j_states = {"slice": base, "rows": base}
    for i, sl in enumerate(slices):
        t_sl = port_slice(sl)
        for mode, (jf, tf) in MODES.items():
            rt = tf(states[mode], t_sl, L, None)
            assert bool(rt.ok), (i, mode)
            states[mode] = column_state(rt, t_packed.unpack)
            if mode in j_states:
                rj = jf(j_states[mode], sl, L, None)
                j_states[mode] = rj.state
                assert_state_same(rj.state, states[mode], (i, mode))
        assert_modes_agree({m: _Ok(s) for m, s in states.items()}, i)
    # a skipped interval gaps on every kernel of both packages
    res = merge_all(base, slices[1], L)
    for mode, r in res.items():
        assert bool(r.need_ctx_gap) and not bool(r.ok), mode


class _Ok:
    """A merged column state in the shape ``assert_modes_agree`` reads."""

    def __init__(self, state):
        self.state, self.ok = state, torch.tensor(True)


def test_large_writer_table_fallback_parity():
    """Writer tables past the JAX select-unroll threshold (rcap 64) merge
    to the same slot-independent views as rcap 8, on every kernel."""
    L = 16
    for trial in range(4):
        views = {}
        for rcap in (8, 64):
            script = np.random.default_rng(1000 + trial)
            a = BinnedKernelMap(gid=100, capacity=128, rcap=rcap, num_buckets=L)
            b = BinnedKernelMap(gid=200, capacity=128, rcap=rcap, num_buckets=L)
            for ts in range(1, 20):
                who = a if script.random() < 0.5 else b
                k = int(script.integers(0, 24))
                if script.random() < 0.75:
                    who.add(k, int(script.integers(0, 100)), ts=ts)
                else:
                    who.remove(k, ts=ts)
            a.join_from(b)
            res = merge_all(a.state, j_ops.extract_rows(b.state, all_rows(L)), L)
            assert all(bool(r.ok) for r in res.values()), (trial, rcap)
            assert_modes_agree(res, (trial, rcap))
            read, dots, _ctx, leaf, *_ = lattice_view(column_state(res["slice"], t_packed.unpack))
            views[rcap] = (read, dots, leaf)
        assert views[8] == views[64], trial


def test_insert_compaction_tier_is_transparent():
    """``max_inserts`` is a cost knob only: any tier that holds the
    inserts gives the uncompacted merge's state on every element-scatter
    kernel, and an undersized tier flags ``need_ins_tier``. The
    uncompacted merges are held against JAX's; the tiers against them
    (JAX's own test holds its tiers the same way)."""
    rng = np.random.default_rng(3)
    L = 16
    scatter = ("slice", "packed_topk", "packed_scomp")
    for trial in range(6):
        a, b = scripted(rng, L, 256, 4, 40, int(rng.integers(5, 30)), 0.8, 1.1)
        if trial % 2:
            a.join_from(b)
        sl = j_ops.extract_rows(b.state, all_rows(L))
        none = merge_all(a.state, sl, L, None, scatter)
        t_state, t_sl = carry(a.state), port_slice(sl)
        for tier in (int(sl.key.size), 64, 256):
            res = {f"{m}@{tier}": MODES[m][1](t_state, t_sl, L, tier) for m in scatter}
            for m in scatter:
                r = res[f"{m}@{tier}"]
                assert bool(r.ok) == bool(none[m].ok), (trial, m, tier)
                assert int(r.n_inserted) == int(none[m].n_inserted), (trial, m, tier)
            assert_modes_agree({**none, **res}, (trial, tier))
        if int(none["slice"].n_inserted) > 1:
            for m in scatter:
                r = MODES[m][1](t_state, t_sl, L, 1)
                assert not bool(r.ok) and bool(r.need_ins_tier), (trial, m)


def test_flagged_first_order_filler_never_flagged():
    """The kill pass's row order: the first ``budget`` flagged rows
    ascending, then fillers that never alias a flagged row; the port's
    order equals the JAX order."""
    rng = np.random.default_rng(7)
    cases = [
        np.array([True] + [False] * 15),
        np.array([False] * 16),
        np.array([True] * 16),
        np.array([False, True] * 8),
        np.array([False] * 15 + [True]),
    ] + [rng.random(16) < p for p in (0.1, 0.5, 0.9)]
    for budget in (1, 4, 16, 32):
        for ci, flags in enumerate(cases):
            order = t_ops.flagged_first_order(torch.from_numpy(flags), budget).numpy()
            want = np.asarray(j_ops.flagged_first_order(jnp.asarray(flags), budget))
            assert np.array_equal(order, want), (ci, budget)
            kb = min(budget, flags.size)
            n_flagged = int(flags.sum())
            assert order.shape == (kb,)
            assert np.array_equal(order[: min(kb, n_flagged)], np.flatnonzero(flags)[: min(kb, n_flagged)])
            assert not flags[order[min(kb, n_flagged):]].any(), (ci, budget)
