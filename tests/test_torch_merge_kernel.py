"""The column fan-in's merge attempt on the card (``ops/merge_kernel.py``,
``csrc/merge.cu``) against the plain op.

On the CPU: the plain twin of the conditional commit
(``ops/binned.py:merge_commit_ref``) is ``merge_slice`` where ok holds
(every lane's, or each lane's own) and leaves the store as it was where
not, over ``test_torch_merge_graph``'s five cases; the wrapper refuses
what the kernel does not take.

On the card (``cuda`` marker, skips without one; run there with
``python3 -m pytest --noconftest tests/test_torch_merge_kernel.py``): the
kernel against ``_merge_slice_b`` on seeded cases (adds, removals that
kill, full rows whose dots the slice carries, the kill tier, the insert
tier, fill overflow, gid growth and overflow, a context gap, padding
rows) at N in {1, 4}, B in {32, 64}, R in {8, 16}: every flag and
``n_inserted`` bit-equal on every attempt, the state and ``n_killed``
where ok holds (every lane's, and each lane's own), the store untouched
where not; ``merge_slice`` on a CUDA stack where one lane fails and the
others merge; the limits the library refuses; then add/remove scripts
through the tier loop and through ``fanout_merge_into``'s graphed entry,
ending bit-equal to the CPU path, with the kernel's launches plus the
replays counting every attempt."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, map_columns, pow2_tier
from delta_crdt_ex_tpu_torch.models.binned_map import tier_retry_merge
from delta_crdt_ex_tpu_torch.ops import merge_kernel
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_PAD, OP_REMOVE
from delta_crdt_ex_tpu_torch.ops.binned import (
    FLAGS,
    RowSlice,
    compact_rows,
    extract_rows,
    merge_commit,
    merge_slice,
    result_buffers,
    row_apply,
    slice_from_wire,
)
from delta_crdt_ex_tpu_torch.parallel import batched_sync, merge_graph
from delta_crdt_ex_tpu_torch.utils.synth import build_state

# ---------------------------------------------------------------------------
# the CPU: the plain twin and the wrapper's checks


def _graph_case(name):
    from test_torch_merge_graph import Writer, _case

    return _case(name, Writer("cpu"))


def _same_store(a, b) -> bool:
    return all(torch.equal(getattr(a, c), getattr(b, c)) for c in COLUMNS)


def _lanes_where(ok, new, old):
    """``new``'s lanes where ``ok``, ``old``'s elsewhere."""
    return map_columns(lambda a, b: torch.where(ok.reshape(-1, *(1,) * (a.dim() - 1)), a, b), new, old)


@pytest.mark.parametrize("per_lane", [False, True], ids=["all_lanes", "per_lane"])
@pytest.mark.parametrize("name", ["add", "kill_tier", "insert_tier", "fill_compact", "gid_grow"])
def test_plain_twin_commits_only_where_ok(name, per_lane):
    """``merge_commit`` on a CPU store (the plain twin): ``merge_slice``'s
    flags and counts; its state where ok holds (every lane's, or with
    ``per_lane`` each lane's own), else the store bit-equal to what it
    was; the slice never written."""
    st, sl, kb, mi = _graph_case(name)
    x = map_columns(torch.clone, st)
    sl_before = [t.clone() for t in sl]
    want = merge_slice(st, sl, kb, mi)
    flags, counts = result_buffers(st.key.shape[0], "cpu")
    merge_commit(x, sl, kb, mi, flags, counts, per_lane=per_lane)
    for i, f in enumerate(FLAGS):
        assert torch.equal(flags[i], getattr(want, f)), f
    assert torch.equal(counts[0], want.n_inserted) and torch.equal(counts[1], want.n_killed)
    assert all(torch.equal(a, b) for a, b in zip(sl, sl_before))
    if bool(want.ok.all()):
        assert name == "add"
        assert _same_store(x, want.state)
    elif per_lane:
        assert _same_store(x, _lanes_where(want.ok, want.state, st))
    else:
        assert _same_store(x, st)


def _small():
    st, sl, _, _ = _graph_case("add")
    return (st, sl, *result_buffers(st.key.shape[0], "cpu"))


def test_wrapper_takes_the_graph_cases():
    """The wrapper's checks pass the graph cases' store and slice, and
    the result buffers come zeroed."""
    st, sl, flags, counts = _small()
    n, L, B = st.key.shape
    assert merge_kernel.check_args(st, sl, flags, counts) == (n, L, B, st.ctx_gid.shape[1], *sl.key.shape, 1, False)
    assert not flags.any() and not counts.any()


@pytest.mark.parametrize(
    "bad",
    ["store_on_cpu", "key_dtype", "node_dtype", "slice_dtype", "no_lane_axis", "ctx_lo_shape", "flags_shape",
     "counts_dtype", "flags_dtype", "counts_shape", "rows_dtype", "fill_dtype", "amin_shape", "not_contiguous",
     "slice_device", "lane_slice_shape"],
)
def test_wrapper_refuses(bad):
    """The kernel's wrapper raises ``ValueError`` on a store or slice it
    does not take, before any launch: a CPU store, a wrong dtype or
    shape, a strided column, a slice elsewhere than the store. (Sizes
    past the kernel's limits are the library's to refuse: on the card,
    ``test_kernel_refuses_past_its_limits``.)"""
    st, sl, flags, counts = _small()
    n = st.key.shape[0]
    call = merge_kernel.check_args
    if bad == "store_on_cpu":
        call = lambda *a: merge_kernel.merge_slice_kernel(*a[:2], 16, 16, *a[2:])  # noqa: E731
    elif bad == "flags_dtype":
        flags = flags.to(torch.uint8)
    elif bad == "counts_shape":
        counts = torch.zeros((3, n), dtype=torch.int64)
    elif bad == "rows_dtype":
        sl = sl._replace(rows=sl.rows.to(torch.int32))
    elif bad == "fill_dtype":
        st = dataclasses.replace(st, fill=st.fill.to(torch.int64))
    elif bad == "amin_shape":
        st = dataclasses.replace(st, amin=st.amin[..., :1].contiguous())
    elif bad == "key_dtype":
        st = dataclasses.replace(st, key=st.key.to(torch.int32))
    elif bad == "node_dtype":
        st = dataclasses.replace(st, node=st.node.to(torch.int64))
    elif bad == "slice_dtype":
        sl = sl._replace(alive=sl.alive.to(torch.uint8))
    elif bad == "no_lane_axis":
        st = map_columns(lambda t: t[0], st)
    elif bad == "ctx_lo_shape":
        sl = sl._replace(ctx_lo=sl.ctx_lo[:, :0])
    elif bad == "flags_shape":
        flags = flags[:, :1] if n > 1 else torch.zeros((6, 2), dtype=torch.bool)
    elif bad == "counts_dtype":
        counts = counts.to(torch.int32)
    elif bad == "not_contiguous":
        st = dataclasses.replace(st, ts=st.ts.transpose(1, 2).contiguous().transpose(1, 2))
    elif bad == "slice_device":
        sl = sl._replace(ctr=sl.ctr.to("meta"))
    elif bad == "lane_slice_shape":
        sl = RowSlice(*(t.expand(n + 1, *t.shape).contiguous() for t in sl))
    with pytest.raises(ValueError, match="merge kernel"):
        call(st, sl, flags, counts)


def test_merge_slice_on_the_cpu_is_the_plain_op():
    """``merge_slice`` on a CPU store never reaches the kernel wrapper."""
    st, sl, kb, mi = _graph_case("kill_tier")
    before = merge_kernel.merge_slice_kernel.launches
    res = merge_slice(st, sl, kb, mi)
    assert not bool(res.ok.all())
    assert merge_kernel.merge_slice_kernel.launches == before


# ---------------------------------------------------------------------------
# the card: seeded cases

L = 256
BASE = 0x1111000000000001
W = 0x2222000000000002
V = 0x4444000000000004
NEWCOMER = 0x3333000000000000


def _key(bucket: int, j: int) -> int:
    return (1 << 63) | (j << 20) | bucket


class Gen:
    """A receiving stack of ``n`` lanes over one base map (writer BASE),
    the lanes made to differ by a writer V known only to lanes 1.., and
    the deltas writer W ships: interval adds and their removals, as the
    cycle cells' traffic."""

    def __init__(self, n: int, B: int, R: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n, self.B, self.R = n, B, R
        occ = self.rng.integers(0, 5, size=L)
        occ[:4] = B - 2  # nearly full rows for fill overflow
        keys = np.array([_key(b, j) for b in range(L) for j in range(occ[b])], np.uint64)
        one, _ = build_state(BASE, keys, L, B, R, ts_start=1 << 20, device="cpu")
        self.one = one
        self.fresh = 10
        self.ts = 1 << 30
        self.w_top = np.zeros(L, np.int64)
        lanes = [one]
        for k in range(1, n):  # lane k knows writer V in rows of its own
            rows = np.arange(100 + 8 * k, 104 + 8 * k)
            sl, _ = self._interval(rows, gid=V + k, counts=np.ones(len(rows), np.int64), lo=np.zeros(len(rows), np.int64))
            lanes.append(merge_ref(one, sl))
        self.stack = batched_sync.stack_states(lanes)

    def _wire(self, u: int, S: int, gids) -> dict:
        return dict(
            rows=np.full(u, -1, np.int32), key=np.zeros((u, S), np.uint64), valh=np.zeros((u, S), np.uint32),
            ts=np.zeros((u, S), np.int64), node=np.zeros((u, S), np.int32), ctr=np.zeros((u, S), np.uint32),
            alive=np.zeros((u, S), bool), ctx_rows=np.zeros((u, len(gids)), np.uint32),
            ctx_lo=np.zeros((u, len(gids)), np.uint32), ctx_gid=np.array(gids, np.uint64),
        )

    def _interval(self, rows, gid, counts, lo, S=8, u=None, at=None):
        """``(add, removal)`` wires of writer ``gid``: ``counts[i]`` fresh
        keys in ``rows[i]`` with counters ``lo[i] + 1 ..``, claiming the
        interval ``(lo, lo + count]``; ``at`` places row i at slice
        position ``at[i]`` (padding elsewhere)."""
        rows = np.asarray(rows)
        u = u or pow2_tier(len(rows))
        at = np.arange(len(rows)) if at is None else np.asarray(at)
        add, rm = self._wire(u, S, [gid]), self._wire(u, S, [gid])
        for w in (add, rm):
            w["rows"][at] = rows
            w["ctx_lo"][at, 0] = lo
            w["ctx_rows"][at, 0] = lo + counts
        for i, (r, c) in enumerate(zip(rows, counts)):
            for s in range(c):
                add["key"][at[i], s] = _key(int(r), self.fresh)
                add["valh"][at[i], s] = self.rng.integers(0, 1 << 32)
                add["ts"][at[i], s] = self.ts
                add["ctr"][at[i], s] = lo[i] + 1 + s
                add["alive"][at[i], s] = True
                self.fresh += 1
                self.ts += 1
        return slice_from_wire(add, "cpu"), slice_from_wire(rm, "cpu")

    def w_delta(self, rows, counts=None, skip=0, **kw):
        """Writer W's next add delta into ``rows`` (and its removal);
        ``skip`` leaves a hole of that many counters before it (a gap)."""
        rows = np.asarray(rows)
        counts = self.rng.integers(1, 4, size=len(rows)) if counts is None else np.asarray(counts)
        lo = self.w_top[rows] + skip
        self.w_top[rows] = lo + counts
        return self._interval(rows, W, counts, lo, **kw)

    def rows(self, k: int):
        return np.sort(self.rng.choice(np.arange(4, 100), size=k, replace=False))

    def merge_all(self, sl):
        """The stack with ``sl`` merged into every lane (the plain path)."""
        self.stack = tier_retry_merge(self.stack, sl, merge_slice, compact_rows, 1 << 20, 1 << 20)[0]

    def newcomers(self, rows, k: int, rr: int):
        """``k`` writers no lane knows, one key each in each of ``rows``,
        in a slice table of ``rr`` slots."""
        w = self._wire(pow2_tier(len(rows)), 8, [NEWCOMER + i + 1 if i < k else 0 for i in range(rr)])
        w["rows"][: len(rows)] = rows
        for i in range(min(k, 8)):
            for j, r in enumerate(rows):
                w["key"][j, i] = _key(int(r), self.fresh)
                self.fresh += 1
            w["valh"][: len(rows), i] = i + 1
            w["ts"][: len(rows), i] = self.ts + i
            w["node"][: len(rows), i] = i
            w["ctr"][: len(rows), i] = 1
            w["alive"][: len(rows), i] = True
        for i in range(k):
            w["ctx_rows"][: len(rows), i] = 1
        self.ts += 8
        return slice_from_wire(w, "cpu")

    def full_rows(self, rows):
        """A slice of whole rows from a sender holding lane 0's map on
        which writer W removed one key and added one in each row: the
        removed dots die, the rest are carried (present) and survive."""
        snd = self.one
        slot = int((snd.ctx_gid == 0).nonzero()[0, 0])
        snd = dataclasses.replace(snd, ctx_gid=snd.ctx_gid.clone().index_fill_(0, torch.tensor([slot]), W))
        rows = np.asarray(rows)
        m = 2
        op = np.full((len(rows), m), OP_PAD, np.int32)
        key = np.zeros((len(rows), m), np.int64)
        for i, r in enumerate(rows):
            alive = snd.key[r][snd.alive[r]]
            if len(alive):
                op[i, 0], key[i, 0] = OP_REMOVE, int(alive[0])
            k = _key(int(r), self.fresh)
            op[i, 1], key[i, 1] = OP_ADD, k - (1 << 64) if k >= 1 << 63 else k
            self.fresh += 1
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        res = row_apply(snd, slot, t(rows.astype(np.int64)), t(op), t(key), t(np.full((len(rows), m), 7, np.int64)),
                        t(np.full((len(rows), m), self.ts, np.int64)))
        assert bool(res.ok)
        self.ts += 1
        padded = np.full(pow2_tier(len(rows) + 3), -1, np.int64)
        padded[1 : 1 + len(rows)] = rows
        return extract_rows(res.state, torch.from_numpy(padded))


def merge_ref(state, sl):
    """``sl`` merged into one state by the plain tier loop."""
    st = batched_sync.stack_states([state])
    return batched_sync.unstack_states(tier_retry_merge(st, sl, merge_slice, compact_rows, 1 << 20, 1 << 20)[0])[0]


def _n_alive(sl) -> int:
    return int(sl.alive.sum())


def make_case(name: str, g: Gen):
    """``(stack, slice, kill budget, insert tier, the flag the case must
    raise or None)``, all on the CPU."""
    if name == "add":
        sl, _ = g.w_delta(g.rows(40))
        return g.stack, sl, 16, pow2_tier(_n_alive(sl)), None
    if name in ("kill", "kill_tier"):
        add, rm = g.w_delta(g.rows(30))
        g.merge_all(add)
        if name == "kill":
            return g.stack, rm, 32, 1, None
        return g.stack, rm, 4, 1, "need_kill_tier"
    if name == "full_rows":
        return g.stack, g.full_rows(g.rows(20)), 64, 64, None
    if name == "insert_tier":
        sl, _ = g.w_delta(g.rows(20))
        return g.stack, sl, 16, 2, "need_ins_tier"
    if name == "fill":
        sl, _ = g.w_delta(np.array([1, 2, 30, 40]), counts=[3, 3, 1, 1])
        return g.stack, sl, 16, 16, "need_fill_compact"
    if name == "gid_grow":
        return g.stack, g.newcomers(g.rows(6), 3, 4), 16, 64, None
    if name == "gid_overflow":
        return g.stack, g.newcomers(g.rows(6), g.R, g.R), 16, 1 << 10, "need_gid_grow"
    if name == "gid_one_lane":  # lane 0 has a slot to spare for each newcomer, the others do not
        return g.stack, g.newcomers(g.rows(6), g.R - 1, g.R - 1), 16, 1 << 10, "need_gid_grow" if g.n > 1 else None
    if name == "gid_wide":
        return g.stack, g.newcomers(g.rows(6), 2 * g.R, 2 * g.R), 16, 1 << 10, "need_gid_grow"
    if name == "ctx_gap":
        add, _ = g.w_delta(g.rows(10))
        g.merge_all(add)
        sl, _ = g.w_delta(g.rows(10), skip=1)
        return g.stack, sl, 16, 64, "need_ctx_gap"
    assert name == "padding"
    rows = g.rows(12)
    sl, _ = g.w_delta(rows, u=32, at=np.arange(12) * 2 + 1)
    return g.stack, sl, 16, 64, None


CASES = ["add", "kill", "full_rows", "kill_tier", "insert_tier", "fill", "gid_grow", "gid_overflow", "gid_one_lane",
         "gid_wide", "ctx_gap", "padding"]
GEOMETRIES = [(n, b, r) for n in (1, 4) for b in (32, 64) for r in (8, 16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def to_card(obj):
    if isinstance(obj, RowSlice):
        return RowSlice(*(t.to("cuda") for t in obj))
    return map_columns(lambda t: t.to("cuda"), obj)


def kernel_attempt(stack, sl, kb, mi, per_lane=False):
    """The kernel's attempt on a card copy of ``stack``: ``(store after,
    flags, counts)`` on the CPU."""
    x = to_card(stack)
    flags, counts = result_buffers(stack.key.shape[0], "cuda")
    merge_commit(x, to_card(sl), kb, mi, flags, counts, per_lane=per_lane)
    torch.cuda.synchronize()
    return map_columns(lambda t: t.cpu(), x), flags.cpu(), counts.cpu()


def assert_attempt(stack, sl, kb, mi, ctx):
    """The kernel's attempt against the plain op's on the same inputs,
    committing where every lane is ok and, again, each ok lane."""
    want = merge_slice(stack, sl, kb, mi)
    for per_lane in (False, True):
        got, flags, counts = kernel_attempt(stack, sl, kb, mi, per_lane)
        cx = (ctx, "per_lane" if per_lane else "all_lanes")
        for i, f in enumerate(FLAGS):
            assert torch.equal(flags[i], getattr(want, f)), (cx, f, flags[i], getattr(want, f))
        assert torch.equal(counts[0], want.n_inserted), (cx, counts[0], want.n_inserted)
        ok = want.ok if per_lane else want.ok.all().expand(want.ok.shape)
        assert torch.equal(counts[1][ok], want.n_killed[ok]), (cx, counts[1], want.n_killed)
        for c in COLUMNS:
            g, w, s = getattr(got, c), getattr(want.state, c), getattr(stack, c)
            assert torch.equal(g[ok], w[ok]), (cx, "merged", c)
            assert torch.equal(g[~ok], s[~ok]), (cx, "written where not ok", c)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "N%d-B%d-R%d" % g)
@pytest.mark.parametrize("name", CASES)
def test_kernel_is_the_plain_op(card, name, geo):
    n, B, R = geo
    g = Gen(n, B, R, seed=100 * CASES.index(name) + GEOMETRIES.index(geo))
    stack, sl, kb, mi, flag = make_case(name, g)
    want = assert_attempt(stack, sl, kb, mi, (name, geo))
    if flag is None:
        assert bool(want.ok.all()), (name, geo)
    else:
        assert bool(getattr(want, flag).any()), (name, geo, flag)
    if name in ("kill", "full_rows"):
        assert int(want.n_killed.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [(4, 32, 8), (4, 64, 16)], ids=lambda g: "N%d-B%d-R%d" % g)
def test_merge_slice_on_the_card_merges_each_ok_lane(card, geo):
    """``merge_slice`` (``fanout_merge``) on a CUDA stack where lane 0
    merges and the other lanes overflow their writer tables: every
    lane's flags and ``n_inserted`` are the CPU's, lane 0's state and
    ``n_killed`` too, and the failing lanes come back as they were."""
    stack, sl, kb, mi, _ = make_case("gid_one_lane", Gen(*geo, seed=11))
    want = merge_slice(stack, sl, kb, mi)
    got = merge_slice(to_card(stack), to_card(sl), kb, mi)
    assert want.ok.tolist() == [True] + [False] * (geo[0] - 1)
    for f in FLAGS + ("n_inserted",):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert int(got.n_killed[0]) == int(want.n_killed[0])
    assert _same_store(map_columns(lambda t: t.cpu(), got.state), _lanes_where(want.ok, want.state, stack))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["too_many_writers", "too_wide_slice", "too_many_slice_writers"])
def test_kernel_refuses_past_its_limits(card, bad):
    """Sizes past the kernel's limits, which only the library states,
    raise ``ValueError`` before any launch, naming the limits."""
    st, sl, flags, counts = _small()
    if bad == "too_many_writers":
        st = st.grow(replica_capacity=512)
    st, sl, flags, counts = to_card(st), to_card(sl), flags.cuda(), counts.cuda()
    if bad == "too_wide_slice":
        pad = lambda t: torch.zeros((t.shape[0], 1025), dtype=t.dtype, device="cuda")  # noqa: E731
        sl = sl._replace(key=pad(sl.key), valh=pad(sl.valh), ts=pad(sl.ts), node=pad(sl.node),
                         ctr=pad(sl.ctr), alive=pad(sl.alive))
    elif bad == "too_many_slice_writers":
        rr = 257
        sl = sl._replace(ctx_rows=torch.zeros((sl.rows.shape[0], rr), dtype=torch.int64, device="cuda"),
                         ctx_lo=torch.zeros((sl.rows.shape[0], rr), dtype=torch.int64, device="cuda"),
                         ctx_gid=torch.zeros(rr, dtype=torch.int64, device="cuda"))
    before = merge_kernel.merge_slice_kernel.launches
    with pytest.raises(ValueError, match="past its limits"):
        merge_kernel.merge_slice_kernel(st, sl, 16, 16, flags, counts)
    assert merge_kernel.merge_slice_kernel.launches == before


def _script(g: Gen):
    """A cycle of W's deltas: adds, their removals, a fill overflow, a
    gid growth and a gap-free full-row slice, as ``(slice, n_alive)``."""
    out = []
    adds = [g.w_delta(g.rows(k)) for k in (10, 40, 60)]
    out += [(a, _n_alive(a)) for a, _ in adds]
    out += [(r, 0) for _, r in adds]
    add, rm = g.w_delta(np.array([1, 2, 3, 50]), counts=[3, 3, 3, 1])
    out += [(add, _n_alive(add)), (rm, 0)]
    sl = g.newcomers(g.rows(6), g.R, g.R)
    out.append((sl, _n_alive(sl)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("geo", [(1, 32, 8), (4, 64, 8)], ids=lambda g: "N%d-B%d-R%d" % g)
def test_tier_loop_attempts_match(card, geo):
    """The tier loop on the card (every attempt through the kernel, eager)
    and on the CPU: each attempt's flags and insert counts, the retries
    and the final stacks, bit-equal."""
    g = Gen(*geo, seed=7)
    seen = {"cuda": [], "cpu": []}

    def recording(dev):
        def merge(st, sl, kb, mi):
            res = merge_slice(st, sl, kb, mi)
            seen[dev].append((torch.stack([getattr(res, f) for f in FLAGS]).cpu(), res.n_inserted.cpu()))
            return res
        return merge

    cpu, card_st = g.stack, to_card(g.stack)
    for i, (sl, n_alive) in enumerate(_script(g)):
        a = tier_retry_merge(cpu, sl, recording("cpu"), compact_rows, 16, pow2_tier(max(n_alive, 1)))
        b = tier_retry_merge(card_st, to_card(sl), recording("cuda"), compact_rows, 16, pow2_tier(max(n_alive, 1)))
        assert a[2] == b[2], i
        cpu, card_st = a[0], b[0]
        assert _same_store(map_columns(lambda t: t.cpu(), card_st), cpu), i
    assert len(seen["cpu"]) == len(seen["cuda"])
    for (fa, na), (fb, nb) in zip(seen["cpu"], seen["cuda"]):
        assert torch.equal(fa, fb) and torch.equal(na, nb)


@pytest.mark.cuda
def test_graphed_entry_script_ends_as_the_cpu_path(card):
    """The cycles' script through ``fanout_merge_into`` on a CUDA stack
    (captured graphs) and on a CPU one: every call's retries and final
    stack equal; the kernel's launches plus the replays are every
    attempt the entry made on the card."""
    g = Gen(1, 32, 8, seed=3)
    cpu, card_st = g.stack, to_card(g.stack)
    k = merge_kernel.merge_slice_kernel
    l0, r0 = k.launches, merge_graph.replays
    attempts = 0
    for rnd in range(3):
        for i, (sl, n_alive) in enumerate(_script(g)):
            a = batched_sync.fanout_merge_into(cpu, sl, n_alive=n_alive)
            b = batched_sync.fanout_merge_into(card_st, to_card(sl), n_alive=n_alive)
            assert a[2] == b[2], (rnd, i)
            attempts += 1 + b[2]
            cpu, card_st = a[0], b[0]
        assert _same_store(map_columns(lambda t: t.cpu(), card_st), cpu), rnd
    assert merge_graph.replays > r0
    assert (k.launches - l0) + (merge_graph.replays - r0) == attempts
