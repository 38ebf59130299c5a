"""The column fan-in's merge entry on captured graphs
(``parallel/merge_graph.py``): the graph bodies are the eager merge and
compaction bit for bit, and write nothing but the store they own and
their flag buffers; the entry's script of add/remove cycles (a kill-tier
ladder, an insert-tier step, a compaction, gid-table growth, a foreign
stack) returns every stack, last result and retry count of the eager
path, with the counters the script predicts, and refuses a consumed
stack. On the CPU the entry runs with graphs that replay eagerly; the
card test (``cuda`` marker, skips without a card) runs the same script
through ``fanout_merge_into`` with real graphs:
``python3 -m pytest tests/test_torch_merge_graph.py`` on the card."""

from __future__ import annotations

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, map_columns, pow2_tier
from delta_crdt_ex_tpu_torch.models.binned_map import tier_retry_merge
from delta_crdt_ex_tpu_torch.ops.binned import compact_rows, merge_slice, slice_from_wire
from delta_crdt_ex_tpu_torch.parallel import batched_sync, merge_graph
from delta_crdt_ex_tpu_torch.utils.synth import build_state

L, B, R, S = 1024, 8, 2, 8
WRITER = 0xF00000000000AAAA
NEWCOMERS = (0xF00000000000BBBB, 0x70000000000000CC)


class Writer:
    """The sender: per-bucket counters of writer ``WRITER`` from a base
    of two keys a bucket (which the receiver holds), and the deltas it
    ships: adds of fresh keys and the removal of an earlier add (the
    same context interval, no entries)."""

    def __init__(self, device):
        self.device = device
        keys = np.array([(1 << 63) | (j << 10) | b for j in (1, 2) for b in range(L)], np.uint64)
        self.base, nxt = build_state(WRITER, keys, L, B, R, device=device)
        self.next_ctr = nxt.astype(np.int64)
        self.fresh = 3
        self.ts = 1 << 30

    def _wire(self, u, gids):
        return dict(
            rows=np.full(u, -1, np.int32), key=np.zeros((u, S), np.uint64), valh=np.zeros((u, S), np.uint32),
            ts=np.zeros((u, S), np.int64), node=np.zeros((u, S), np.int32), ctr=np.zeros((u, S), np.uint32),
            alive=np.zeros((u, S), bool), ctx_rows=np.zeros((u, len(gids)), np.uint32),
            ctx_lo=np.zeros((u, len(gids)), np.uint32), ctx_gid=np.array(gids, np.uint64),
        )

    def add(self, rows):
        """One fresh key in each of ``rows``; returns ``(slice, its removal)``."""
        rows = np.asarray(rows)
        add, rm = self._wire(pow2_tier(len(rows)), [WRITER]), self._wire(pow2_tier(len(rows)), [WRITER])
        lo = self.next_ctr[rows] - 1  # the writer's top counter in each row
        for w in (add, rm):
            w["rows"][: len(rows)] = rows
            w["ctx_lo"][: len(rows), 0] = lo
            w["ctx_rows"][: len(rows), 0] = lo + 1
        add["key"][: len(rows), 0] = np.uint64((1 << 63) | (self.fresh << 10)) | rows.astype(np.uint64)
        add["valh"][: len(rows), 0] = rows * 7 + self.fresh
        add["ts"][: len(rows), 0] = self.ts + np.arange(len(rows))
        add["ctr"][: len(rows), 0] = lo + 1
        add["alive"][: len(rows), 0] = True
        self.next_ctr[rows] += 1
        self.fresh += 1
        self.ts += len(rows)
        return slice_from_wire(add, self.device), slice_from_wire(rm, self.device)

    def newcomers(self, rows):
        """Two writers the receiver has never seen, one key each in each
        of ``rows``: more gids than its free writer slots."""
        w = self._wire(pow2_tier(len(rows)), list(NEWCOMERS))
        w["rows"][: len(rows)] = rows
        for slot in range(2):
            w["key"][: len(rows), slot] = (slot + 5 << 40) | np.asarray(rows)
            w["valh"][: len(rows), slot] = slot + 1
            w["ts"][: len(rows), slot] = self.ts + slot
            w["node"][: len(rows), slot] = slot
            w["ctr"][: len(rows), slot] = 1
            w["alive"][: len(rows), slot] = True
            w["ctx_rows"][: len(rows), slot] = 1
        self.ts += 2
        return slice_from_wire(w, self.device)


def eager(stack, sl, n_alive):
    """``fanout_merge_into``'s eager path: the tier loop over
    ``fanout_merge`` and ``compact_rows``."""
    return tier_retry_merge(
        stack, sl, batched_sync.fanout_merge, compact_rows, 16, pow2_tier(max(n_alive, 1))
    )


def snapshot(*objs):
    out = []
    for o in objs:
        fields = [getattr(o, c) for c in COLUMNS] if dataclasses.is_dataclass(o) else list(o)
        out.append([t.clone() for t in fields])
    return out


def same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def assert_stack_equal(got, want, ctx):
    for c in COLUMNS:
        assert torch.equal(getattr(got, c), getattr(want, c)), (ctx, c)


def assert_result_equal(got, want, ctx):
    assert_stack_equal(got.state, want.state, ctx)
    for f in got._fields[1:]:
        assert torch.equal(getattr(got, f), getattr(want, f)), (ctx, f)


# ---------------------------------------------------------------------------
# the graph bodies


def _case(name, w):
    """``(store, slice, kill budget, insert tier)`` of one case, the store
    a two-lane stack brought to the state the case needs."""
    st = batched_sync.stack_states([w.base, w.base])
    if name == "add":
        return st, w.add(range(10))[0], 16, 16
    if name == "kill_tier":
        add, rm = w.add(range(100, 400))
        return eager(st, add, 300)[0], rm, 16, 1
    if name == "insert_tier":
        return st, w.add(range(10))[0], 16, 2
    if name == "fill_compact":
        for _ in range(B - 2):  # each add and removal leaves its slot a hole
            add, rm = w.add(range(10))
            st = eager(eager(st, add, 10)[0], rm, 0)[0]
        return st, w.add(range(10))[0], 16, 16
    assert name == "gid_grow"
    return st, w.newcomers(range(500, 504)), 16, 8


@pytest.mark.parametrize("name", ["add", "kill_tier", "insert_tier", "fill_compact", "gid_grow"])
def test_graph_bodies_are_the_eager_merge(name):
    """``merge_body`` gives ``merge_slice``'s flags and counts, writes its
    state over the store where every lane merged and leaves it bit-equal
    otherwise; ``compact_body`` writes ``compact_rows``' result; neither
    writes the slice, and both write the store's own tensors in place."""
    w = Writer("cpu")
    st, sl, kb, mi = _case(name, w)
    x = map_columns(torch.clone, st)
    before, sl_before = snapshot(x, sl)
    want = merge_slice(st, sl, kb, mi)
    flags = torch.zeros((len(merge_graph.FLAGS), 2), dtype=torch.bool)
    counts = torch.zeros((2, 2), dtype=torch.int64)
    ids = [id(getattr(x, c)) for c in COLUMNS]

    merge_graph.merge_body(x, sl, kb, mi, flags, counts)
    assert same(snapshot(sl)[0], sl_before)
    assert [id(getattr(x, c)) for c in COLUMNS] == ids
    for i, f in enumerate(merge_graph.FLAGS):
        assert torch.equal(flags[i], getattr(want, f)), f
    assert torch.equal(counts[0], want.n_inserted) and torch.equal(counts[1], want.n_killed)
    ok = bool(want.ok.all())
    assert ok == (name in ("add",)), name
    if ok:
        assert_stack_equal(x, want.state, name)
    else:
        assert same(snapshot(x)[0], before), name
    expect = {"kill_tier": "need_kill_tier", "insert_tier": "need_ins_tier", "fill_compact": "need_fill_compact",
              "gid_grow": "need_gid_grow"}
    if name in expect:
        assert bool(getattr(want, expect[name]).any())
    if name == "fill_compact":
        merge_graph.compact_body(x)
        assert_stack_equal(x, compact_rows(st), name)
        assert [id(getattr(x, c)) for c in COLUMNS] == ids


# ---------------------------------------------------------------------------
# the entry's script


class _EagerGraph:
    """A stand-in for a captured graph: the first run on capture, and the
    body again on each replay."""

    def __init__(self, body):
        self.body = body
        body()

    def replay(self):
        self.body()


def _counts():
    return merge_graph.replays, merge_graph.eager_attempts, merge_graph.captures


def run_script(call, w):
    """Add/remove cycles through ``call(stack, slice, n_alive)`` (the
    entry), each held against the eager path on the same inputs, with
    each call's (replays, eager attempts, captures) against the script's
    prediction. Returns the stacks the entry returned."""
    base = batched_sync.stack_states([w.base, w.base])
    ref = map_columns(torch.clone, base)
    stack = base
    returned = []

    def step(sl, n_alive, expect, ctx, stack_in=None):
        nonlocal stack, ref
        c0 = _counts()
        got = call(stack if stack_in is None else stack_in, sl, n_alive)
        ref_out = eager(ref, sl, n_alive)
        assert_stack_equal(got[0], ref_out[0], ctx)
        assert_result_equal(got[1], ref_out[1], ctx)
        assert got[1].state is got[0]
        assert got[2] == ref_out[2], ctx
        assert tuple(b - a for a, b in zip(c0, _counts())) == expect, ctx
        stack, ref = got[0], ref_out[0]
        returned.append(stack)
        return got[2]

    a, a_rm = w.add(range(10))
    step(a, 10, (0, 1, 0), "first call: a stack the entry did not return, merged eagerly")
    step(a_rm, 0, (0, 1, 1), "removal: captured")
    for k in range(2):
        b, b_rm = w.add(range(10))
        step(b, 10, (0, 1, 1) if k == 0 else (1, 0, 0), f"add {k}")
        step(b_rm, 0, (1, 0, 0), f"removal {k}")
    d, d_rm = w.add(range(100, 400))
    step(d, 300, (0, 1, 1), "300-row add")
    assert step(d_rm, 0, (0, 4, 4), "kill tier 16 -> 64 -> 256 -> 512") == 3
    d, d_rm = w.add(range(100, 400))
    step(d, 300, (1, 0, 0), "300-row add, replayed")
    assert step(d_rm, 0, (4, 0, 0), "kill-tier ladder, replayed") == 3
    e, e_rm = w.add(range(10))
    assert step(e, 2, (0, 3, 3), "insert tier 2 -> 8 -> 32") == 2
    step(e_rm, 0, (1, 0, 0), "removal")
    for k in range(2):
        f, f_rm = w.add(range(10))
        step(f, 10, (1, 0, 0), f"add {k}, filling the rows")
        step(f_rm, 0, (1, 0, 0), f"removal {k}")
    h, h_rm = w.add(range(10))
    assert step(h, 10, (2, 0, 1), "fill overflow: compaction, captured, then the merge again") == 1
    step(h_rm, 0, (1, 0, 0), "removal")
    assert step(w.newcomers(range(500, 504)), 8, (0, 2, 1), "gid growth: grown, merged eagerly, adopted") == 1
    assert stack.replica_capacity == 2 * R
    i, i_rm = w.add(range(10))
    step(i, 10, (0, 1, 1), "new geometry: captured again")
    step(i_rm, 0, (0, 1, 1), "new geometry: removal captured")
    j, j_rm = w.add(range(10))
    foreign = map_columns(torch.clone, stack)
    held = snapshot(foreign)
    step(j, 10, (0, 1, 0), "a foreign stack: merged eagerly, adopted", stack_in=foreign)
    assert same(snapshot(foreign)[0], held[0])  # never written
    step(j_rm, 0, (0, 1, 1), "removal on the adopted stack: captured")
    k, k_rm = w.add(range(10))
    step(k, 10, (0, 1, 1), "add: captured")
    consumed = stack
    step(k_rm, 0, (1, 0, 0), "removal: replayed")
    c0 = _counts()
    with pytest.raises(ValueError, match="consumed"):
        call(consumed, w.add(range(10))[0], 10)
    assert _counts() == c0
    return returned


def test_entry_script_on_the_cpu():
    """The entry's logic with graphs that replay eagerly: every result as
    the eager path's, the counters as predicted."""
    entry = merge_graph.MergeGraphs(capture=lambda body, device, pool: _EagerGraph(body))
    run_script(lambda st, sl, n: entry.merge_into(st, sl, 16, pow2_tier(max(n, 1))), Writer("cpu"))


def test_entry_shared_by_threads():
    """More threads than cores, each with its own stack and writer, share
    one entry under a short switch interval: every thread's stack ends
    bit-equal to the eager path's on its inputs (a call that lost the
    entry to another thread's stack merges eagerly, and none is lost)."""
    entry = merge_graph.MergeGraphs(capture=lambda body, device, pool: _EagerGraph(body))
    n = (os.cpu_count() or 1) + 1
    writers = [Writer("cpu") for _ in range(n)]
    out, errors = [None] * n, []

    def worker(i):
        try:
            w = writers[i]
            stack = ref = batched_sync.stack_states([w.base])
            for _ in range(3):
                for sl, alive in zip(w.add(range(i, 10 * n, n)), (10, 0)):
                    stack = entry.merge_into(stack, sl, 16, pow2_tier(max(alive, 1)))[0]
                    ref = eager(ref, sl, alive)[0]
            out[i] = (stack, ref)
        except Exception as err:  # reported below, with the thread's index
            errors.append((i, err))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i, (stack, ref) in enumerate(out):
        assert_stack_equal(stack, ref, i)


def test_cpu_and_packed_stacks_merge_eagerly():
    """``fanout_merge_into`` on a CPU column stack and on a packed stack
    takes the eager path: no counter moves, and a stack passed twice is
    merged twice from the same state."""
    w = Writer("cpu")
    st = batched_sync.stack_states([w.base, w.base])
    add, _ = w.add(range(10))
    c0 = _counts()
    for stack in (st, batched_sync.pack_states(st)):
        first = batched_sync.fanout_merge_into(stack, add)
        again = batched_sync.fanout_merge_into(stack, add)
        assert first[0] is not stack and torch.equal(first[0].leaf, again[0].leaf)
    assert _counts() == c0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_entry_script_on_the_card(card):
    """The same script through ``fanout_merge_into`` on a CUDA column
    stack: captured graphs, results bit-equal to the eager path."""
    returned = run_script(
        lambda st, sl, n: batched_sync.fanout_merge_into(st, sl, n_alive=n), Writer("cuda")
    )
    assert all(s.device.type == "cuda" for s in returned)
