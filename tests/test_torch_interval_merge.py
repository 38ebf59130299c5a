"""PyTorch port vs JAX package: delta-interval merges
(``tests/test_interval_merge.py`` and its property,
``tests/test_interval_merge_property.py``).

A slice whose context is the interval ``(lo, hi]`` claims only the dots
it ships; a gap beneath ``lo`` is rejected. Every slice is built by the
JAX tests' own builders and carried to the port through its wire
columns (``ops/binned.py:slice_from_wire``); the JAX harness and the
port harness merge it in lockstep (``tests/test_torch_lattice.py``),
state columns bit-equal after each merge, on both stores. The property
also holds both against ``utils/pyref.py``.
"""

from __future__ import annotations

import pytest
from hypothesis import given, settings, strategies as st

from delta_crdt_ex_tpu.models.binned_map import BinnedAWLWWMap as JBinned
from delta_crdt_ex_tpu.models.hash_store import HashAWLWWMap as JHash
from delta_crdt_ex_tpu.utils.pyref import PyAWLWWMap
from delta_crdt_ex_tpu_torch.models.binned_map import BinnedAWLWWMap as TBinned
from delta_crdt_ex_tpu_torch.models.hash_store import HashAWLWWMap as THash
from tests.test_interval_merge import L, interval_slice
from tests.test_interval_merge_property import WRITER_GIDS, _writer_history, interval_scenario, multi_slice
from tests.test_torch_lattice import PROPERTY, STORES, Lockstep, port_slice, jax_compiles_released  # noqa: F401 (autouse)

BUCKET = 1
K1, K2, K3 = 1, 1 + L, 1 + 2 * L  # one bucket


@pytest.fixture(params=STORES, scope="module")
def store(request):
    return request.param


def gap_flags(store, m: Lockstep, sj):
    """The raw kernel's (need_ctx_gap, ok) on both packages: the
    element-scatter merge on the binned store, the row merge on the
    hash store (its only merge kernel)."""
    st = port_slice(sj)
    if store == "binned":
        rj = JBinned.merge_slice(m.j.state, sj, kill_budget=4)
        rt = TBinned.merge_slice(m.t.state, st, kill_budget=4)
    else:
        rj = JHash.merge_rows(m.j.state, sj)
        rt = THash.merge_rows(m.t.state, st)
    got = (bool(rt.need_ctx_gap), bool(rt.ok))
    assert got == (bool(rj.need_ctx_gap), bool(rj.ok))
    return got


def test_interval_delta_does_not_kill_older_unshipped_dots(store):
    b = Lockstep(store, 11)
    b.merge_slice(interval_slice([BUCKET], [(0, K1, 10, 1, 1)], [0], [1]))
    assert b.read() == {K1: 10}
    b.merge_slice(interval_slice([BUCKET], [(0, K2, 20, 2, 2)], [1], [2]))
    assert b.read() == {K1: 10, K2: 20}  # k1 survives: not claimed


def test_state_form_slice_with_same_content_would_kill(store):
    b = Lockstep(store, 11)
    b.merge_slice(interval_slice([BUCKET], [(0, K1, 10, 1, 1)], [0], [1]))
    b.merge_slice(interval_slice([BUCKET], [(0, K2, 20, 2, 2)], [0], [2]))
    assert b.read() == {K2: 20}  # the state-form claim (0, 2] killed ctr 1


def test_interval_gap_is_rejected(store):
    b = Lockstep(store, 11)
    b.merge_slice(interval_slice([BUCKET], [(0, K1, 10, 1, 1)], [0], [1]))
    gapped = interval_slice([BUCKET], [(0, K3, 30, 3, 3)], [2], [3])
    with pytest.raises(ValueError, match="not contiguous"):
        b.merge_slice(gapped)
    assert gap_flags(store, b, gapped) == (True, False)
    assert b.read() == {K1: 10}


def test_interval_removal_propagates(store):
    b = Lockstep(store, 11)
    b.merge_slice(interval_slice([BUCKET], [(0, K1, 10, 1, 1)], [0], [1]))
    assert b.read() == {K1: 10}
    b.merge_slice(interval_slice([BUCKET], [], [0], [1]))  # re-claims dot 1, ships nothing
    assert b.read() == {}


def test_empty_interval_claims_nothing(store):
    b = Lockstep(store, 11)
    b.merge_slice(interval_slice([BUCKET], [(0, K1, 10, 1, 1)], [0], [1]))
    ctx_before = b.t.state.ctx_max.clone()
    b.merge_slice(interval_slice([BUCKET], [], [1], [1]))  # (1, 1]: nothing claimed
    assert b.read() == {K1: 10}
    assert b.t.state.ctx_max.equal(ctx_before)


def test_interval_merge_is_idempotent(store):
    b = Lockstep(store, 11)
    sl = interval_slice([BUCKET], [(0, 1, 10, 1, 1)], [0], [1])
    b.merge_slice(sl)
    r1, leaf1 = b.read(), b.t.state.leaf.clone()
    b.merge_slice(sl)
    assert b.read() == r1
    assert b.t.state.leaf.equal(leaf1)


def test_clear_between_interval_slices(store):
    """A local clear between two slices of one writer: the clear kills the
    first slice's dot but keeps it observed, so a re-ship of it stays dead
    and the next interval merges contiguously."""
    b = Lockstep(store, 11)
    first = interval_slice([BUCKET], [(0, K1, 10, 1, 1)], [0], [1])
    b.merge_slice(first)
    b.clear(ts=5)
    assert b.read() == {}
    b.merge_slice(first)
    assert b.read() == {}
    b.merge_slice(interval_slice([BUCKET], [(0, K2, 20, 2, 2)], [1], [2]))
    assert b.read() == {K2: 20}


@settings(max_examples=50, **PROPERTY)
@given(interval_scenario())
def test_interval_streams_match_oracle(store, scenario):
    """Random multi-writer interval streams (in order, stale, duplicated,
    overlapping, empty, gapped and state-form) against the pyref oracle,
    JAX and the port in lockstep."""
    timelines, msgs = scenario
    histories = [_writer_history(w, evs) for w, evs in enumerate(timelines)]
    b = Lockstep(store, 11)
    oracle = PyAWLWWMap()

    def deliver(w, t, lo, hi):
        gid = WRITER_GIDS[w]
        entries = [(key, valh, ts, c) for c, (key, valh, ts) in sorted(histories[w][t].items()) if lo < c <= hi]
        sl = multi_slice(entries, lo, hi, gid)
        if hi > lo and oracle.dots.get(gid, 0) < lo:
            with pytest.raises(ValueError, match="not contiguous"):
                b.merge_slice(sl)
            assert gap_flags(store, b, sl) == (True, False)
            return oracle
        b.merge_slice(sl)
        delta = PyAWLWWMap(dots={(gid, c) for c in range(lo + 1, hi + 1)}, value={}, compressed=False)
        for key, valh, ts, c in entries:
            delta.value.setdefault(key, {})[(valh, ts)] = {(gid, c)}
        return oracle.join(delta, set(oracle.value) | set(delta.value))

    for w, t, lo, hi in msgs:
        oracle = deliver(w, t, lo, hi)
        assert b.read() == oracle.read()
        assert b.ctx() == {g: c for g, c in oracle.dots.items() if c}
    for w, evs in enumerate(timelines):  # a final state-form slice from each writer
        oracle = deliver(w, len(evs), 0, sum(1 for e in evs if e[0] == "add"))
    final: dict = {}
    for w, evs in enumerate(timelines):
        for key, valh, ts in histories[w][len(evs)].values():
            if key not in final or final[key][1] < ts:
                final[key] = (valh, ts)
    assert b.read() == {k: v for k, (v, _ts) in final.items()} == oracle.read()


@settings(max_examples=30, **PROPERTY)
@given(interval_scenario(), st.lists(st.booleans(), max_size=16))
def test_interval_streams_with_receiver_clears_match_oracle(store, scenario, clears):
    """The same streams with a local clear on the receiver before some
    messages: a cleared dot stays observed, so a later slice that ships it
    again leaves it dead, and intervals above it still merge; pyref, JAX
    and the port stay in lockstep."""
    timelines, msgs = scenario
    histories = [_writer_history(w, evs) for w, evs in enumerate(timelines)]
    b = Lockstep(store, 11)
    oracle = PyAWLWWMap()
    for i, (w, t, lo, hi) in enumerate(msgs):
        if i < len(clears) and clears[i]:
            b.clear(ts=1_000 + i)
            oracle = oracle.join(oracle.clear(), list(oracle.value))
        gid = WRITER_GIDS[w]
        entries = [(key, valh, ts, c) for c, (key, valh, ts) in sorted(histories[w][t].items()) if lo < c <= hi]
        sl = multi_slice(entries, lo, hi, gid)
        if hi > lo and oracle.dots.get(gid, 0) < lo:
            with pytest.raises(ValueError, match="not contiguous"):
                b.merge_slice(sl)
        else:
            b.merge_slice(sl)
            delta = PyAWLWWMap(dots={(gid, c) for c in range(lo + 1, hi + 1)}, value={}, compressed=False)
            for key, valh, ts, c in entries:
                delta.value.setdefault(key, {})[(valh, ts)] = {(gid, c)}
            oracle = oracle.join(delta, set(oracle.value) | set(delta.value))
        assert b.read() == oracle.read()
        assert b.ctx() == {g: c for g, c in oracle.dots.items() if c}
