"""Open-addressing hash-table kernels over the flat dot store — the
PyTorch port of ``delta_crdt_ex_tpu/ops/hash_map.py``.

Every entry lives in ONE flat table of ``H`` lanes (see
:mod:`delta_crdt_ex_tpu_torch.models.hash_store`); an entry's slot is
found by probing a bounded window of ``probe_window`` lanes from its
key's group-aligned base. Placement takes the first DEAD lane of the
window, every lookup scans its whole window masked by ``alive`` (no
tombstones), and a window with no dead lane signals ``need_fill_grow``
— the host rehashes the table ×2.

Each function here is the JAX function of the same name as torch ops on
the state's device, bit for bit: the same lanes, the same arrival
stamps, the same escape flags. Integer layout and the unsigned-order
helpers are in :mod:`delta_crdt_ex_tpu_torch.ops.binned`. Scatters whose
JAX form drops out-of-range indices (``mode="drop"``) write into one
extra sentinel element that is then cut off; every scatter with
possibly repeated indices either writes one value or reduces with an
order-free reduction (``amin``, integer ``index_add_``), so the result
does not depend on the order CUDA applies them in.

The point lookup (:func:`probe_lookup`) is the port of the Pallas TPU
kernel ``probe_lookup_pallas``: on a CUDA table it launches the
hand-written CUDA kernel in ``csrc/probe.cu``, on a CPU table it runs
the plain torch :func:`probe_lookup_ref`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from delta_crdt_ex_tpu_torch.models.hash_store import GROUP, HashStore
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_REMOVE
from delta_crdt_ex_tpu_torch.ops.binned import (
    I64_MAX,
    M32,
    KeyWinners,
    RowSlice,
    _argmax_lww,
    _flip,
    _i64,
    _mix64,
    _slice_view,
    _sorted_winners,
    _table_lookup,
    entry_hash,
)

#: probe-hash salt: the window base must be independent of the sync
#: bucket (= low key bits)
_SALT = _i64(0x9E3779B97F4A7C15)
_LONG = torch.int64


def probe_base(key: torch.Tensor, table_size: int) -> torch.Tensor:
    """int32[...]: group-aligned first lane of ``key``'s probe window."""
    ng = table_size // GROUP
    h = _mix64(key ^ _SALT)
    return ((h & (ng - 1)) * GROUP).to(torch.int32)


def _window(key: torch.Tensor, table_size: int, window: int):
    """Candidate lanes ``int32[..., W]`` for ``key`` plus their in-table
    mask. Windows do not wrap: lanes past the table end are masked out."""
    slots = probe_base(key, table_size)[..., None] + torch.arange(
        window, dtype=torch.int32, device=key.device
    )
    return slots, slots < table_size


def _set_drop(col: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``col.at[idx].set(vals, mode="drop")`` where the only out-of-range
    index is ``len(col)``: write into a sentinel element, cut it off."""
    ext = torch.cat([col, col[:1]])
    ext[idx.to(_LONG)] = vals if not isinstance(vals, torch.Tensor) else vals.to(col.dtype)
    return ext[:-1]


def _count_drop(n: int, idx: torch.Tensor) -> torch.Tensor:
    """int32[n]: ``zeros(n).at[idx].add(1, mode="drop")`` (index ``n``
    drops)."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx.to(_LONG), torch.ones_like(idx, dtype=torch.int32))
    return out[:n]


def _place(occupied: torch.Tensor, want: torch.Tensor, slots: torch.Tensor, slot_ok: torch.Tensor):
    """Place each flagged entry at the first unoccupied lane of its
    candidate window, resolving same-lane collisions within the batch:
    ``W`` rounds of propose → scatter-min claim → winners commit
    (``hash_map.py:101``). Returns ``(placed int64[N] (-1 = window
    full), occupied')``."""
    n, w = slots.shape
    h = occupied.shape[0]
    dev = occupied.device
    slots_c = torch.where(slot_ok, slots, h).to(_LONG)  # h = out-of-window sentinel
    used_p = torch.cat([occupied, torch.ones(1, dtype=torch.bool, device=dev)])
    ids = torch.arange(n, dtype=_LONG, device=dev)
    placed = torch.full((n,), -1, dtype=_LONG, device=dev)
    for _ in range(w):
        unplaced = want & (placed < 0)
        free = ~used_p[slots_c]  # [N, W]
        has = free.any(dim=1)
        pos = free.to(torch.int32).argmax(dim=1, keepdim=True)
        go = unplaced & has
        cand = torch.where(go, torch.gather(slots_c, 1, pos)[:, 0], h)
        claim = torch.full((h + 1,), n, dtype=_LONG, device=dev)
        claim.scatter_reduce_(0, cand, ids, "amin")
        win = go & (claim[cand] == ids)
        placed = torch.where(win, cand, placed)
        used_p[torch.where(win, cand, h)] = True
    return placed, used_p[:-1]


def _row_lookup(rows: torch.Tensor, num_buckets: int):
    """``(valid[U], rows_safe[U] (L = padding sentinel), rows_clip[U],
    row_to_u[L])`` where ``row_to_u`` maps a sync bucket to its position
    in ``rows`` (``U`` = not requested)."""
    u = rows.shape[0]
    valid = rows >= 0
    rows_safe = torch.where(valid, rows, num_buckets).to(_LONG)
    rows_clip = rows_safe.clamp(0, num_buckets - 1)
    row_to_u = _set_drop(
        torch.full((num_buckets,), u, dtype=_LONG, device=rows.device),
        rows_safe,
        torch.arange(u, dtype=_LONG, device=rows.device),
    )
    return valid, rows_safe, rows_clip, row_to_u


def _max_window_fill(alive: torch.Tensor, table_size: int, window: int) -> torch.Tensor:
    """int64: alive entries in the fullest probe window (the growth
    pressure signal)."""
    a = alive.to(_LONG)
    cum = torch.cumsum(a, 0)
    bases = torch.arange(0, table_size, GROUP, dtype=_LONG, device=alive.device)
    hi = (bases + window - 1).clamp(0, table_size - 1)
    below = cum[bases] - a[bases]
    return (cum[hi] - below).max()


def max_window_fill(state: HashStore) -> torch.Tensor:
    return _max_window_fill(state.alive, state.table_size, state.probe_window)


def _entry_rows(state: HashStore) -> torch.Tensor:
    """int64[H]: the sync bucket of each slot's key (stale for dead
    slots — always mask by ``alive``)."""
    return state.key & (state.num_buckets - 1)


def _splice_leaf(state: HashStore, alive2, ehash2, rows_safe, rows_clip):
    """Recompute the maintained leaf digests of the touched rows from
    the updated table (wrapping sum of alive ehash)."""
    L = state.num_buckets
    ent_row = _entry_rows(state)
    touched = _set_drop(torch.zeros(L, dtype=torch.bool, device=alive2.device), rows_safe, True)
    sel = alive2 & touched[ent_row]
    leaf_all = torch.zeros(L + 1, dtype=_LONG, device=alive2.device)
    leaf_all.index_add_(0, torch.where(sel, ent_row, L), torch.where(sel, ehash2, 0))
    leaf_all = leaf_all[:L] & M32
    return _set_drop(state.leaf, rows_safe, leaf_all[rows_clip])


# ---------------------------------------------------------------------------
# local mutation batch


class HashApplyResult(NamedTuple):
    state: HashStore
    ok: torch.Tensor  # bool: every insert found a free window lane
    ctr_assigned: torch.Tensor  # int64[U, M] (uint32)
    n_keys_changed: torch.Tensor  # int64
    row_killed: torch.Tensor  # bool[U]
    n_alive: torch.Tensor  # int64
    max_window_fill: torch.Tensor  # int64


def row_apply(
    state: HashStore,
    self_slot: int,
    rows: torch.Tensor,  # int64[U] unique bucket rows (-1 = padding)
    op: torch.Tensor,  # int32[U, M] ops per row, batch order (OP_PAD pads)
    key: torch.Tensor,  # int64[U, M] (uint64 bits)
    valh: torch.Tensor,  # int64[U, M] (uint32)
    ts: torch.Tensor,  # int64[U, M]
) -> HashApplyResult:
    """Apply a bucket-grouped local mutation batch (``hash_map.py:198``):
    sequential shadowing, per-bucket dot counters, kill accounting.
    ``ok=False`` means some insert's window was full — the host rehashes
    ×2 and retries."""
    L = state.num_buckets
    H = state.table_size
    W = state.probe_window
    u, m = op.shape
    n = u * m
    dev = key.device

    valid = rows >= 0
    rows_safe = torch.where(valid, rows, L).to(_LONG)
    rows_clip = rows_safe.clamp(0, L - 1)

    is_add = (op == OP_ADD) & valid[:, None]
    is_touch = is_add | ((op == OP_REMOVE) & valid[:, None])

    # dot counters: one contiguous sequence per (replica, bucket)
    base = state.ctx_max[rows_clip, self_slot]
    add_rank = torch.cumsum(is_add.to(_LONG), 1)
    ctr_assigned = (base[:, None] + add_rank) & M32

    # batch-internal shadowing
    later = torch.triu(torch.ones((m, m), dtype=torch.bool, device=dev), 1)
    key_eq = key[:, :, None] == key[:, None, :]
    shadowed = (key_eq & later[None] & is_touch[:, None, :]).any(dim=2)
    ins = is_add & ~shadowed

    # pre-batch kills: probe every touched key's window for alive
    # same-key entries
    key_f = key.reshape(n)
    touch_f = is_touch.reshape(n)
    slots, slot_in = _window(key_f, H, W)
    slots_c = torch.where(slot_in, slots, H).to(_LONG)
    slots_g = slots.clamp(0, H - 1).to(_LONG)
    t_alive = state.alive[slots_g] & slot_in
    match = touch_f[:, None] & t_alive & (state.key[slots_g] == key_f[:, None])
    alive1 = _set_drop(state.alive, torch.where(match, slots_c, H), False)
    killed_any = match.any(dim=1).reshape(u, m)
    row_killed = (killed_any & is_touch).any(dim=1)

    # inserts: first dead window lane, batch collisions resolved
    placed, alive2 = _place(alive1, ins.reshape(n), slots, slot_in)
    ok = ~(ins.reshape(n) & (placed < 0)).any()
    tgt = torch.where(placed >= 0, placed, H)

    gid_self = state.ctx_gid[self_slot]
    eh = entry_hash(key, gid_self, ctr_assigned, ts, valh)
    ins_rank = (torch.cumsum(ins.to(_LONG), 1) - 1) & M32
    arr_new = (state.rowseq[rows_clip][:, None] + ins_rank) & M32

    put = lambda col, vals: _set_drop(col, tgt, vals.reshape(n))
    n_ins_row = ins.to(_LONG).sum(dim=1)
    rowseq_ext = torch.cat([state.rowseq, state.rowseq.new_zeros(1)])
    rowseq_ext.index_add_(0, rows_safe, n_ins_row)
    own_max = torch.where(ins, ctr_assigned, 0).amax(dim=1)
    ctx_ext = torch.cat([state.ctx_max, state.ctx_max.new_zeros(1, state.replica_capacity)])
    ctx_ext[rows_safe, self_slot] = torch.maximum(ctx_ext[rows_safe, self_slot], own_max)

    st2 = HashStore(
        key=put(state.key, key),
        valh=put(state.valh, valh),
        ts=put(state.ts, ts),
        node=put(state.node, torch.full((u, m), self_slot, dtype=torch.int32, device=dev)),
        ctr=put(state.ctr, ctr_assigned),
        alive=alive2,
        ehash=put(state.ehash, eh),
        arr=put(state.arr, arr_new),
        leaf=state.leaf,
        rowseq=rowseq_ext[:L] & M32,
        ctx_gid=state.ctx_gid,
        ctx_max=ctx_ext[:L],
        probe_window=W,
    )
    st2 = dataclasses.replace(
        st2, leaf=_splice_leaf(st2, alive2, st2.ehash, rows_safe, rows_clip)
    )

    # telemetry count: distinct keys whose dot store changed
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=dev), -1)
    first_occ = ~(key_eq & earlier[None] & is_touch[:, None, :]).any(dim=2)
    changed = is_touch & first_occ & (ins | killed_any)

    return HashApplyResult(
        st2, ok, ctr_assigned, changed.sum(), row_killed,
        alive2.sum(), _max_window_fill(alive2, H, W),
    )


class HashMergeResult(NamedTuple):
    state: HashStore
    ok: torch.Tensor
    need_gid_grow: torch.Tensor
    need_fill_grow: torch.Tensor
    need_ctx_gap: torch.Tensor
    n_inserted: torch.Tensor
    n_killed: torch.Tensor
    n_ins_row: torch.Tensor  # int32[U]
    n_kill_row: torch.Tensor  # int32[U]
    gap_row: torch.Tensor  # bool[U]
    n_alive: torch.Tensor  # int64
    max_window_fill: torch.Tensor  # int64


def clear_all(state: HashStore) -> HashStore:
    """Kill every observed dot: entries die, the context stays."""
    return dataclasses.replace(
        state,
        alive=torch.zeros_like(state.alive),
        leaf=torch.zeros_like(state.leaf),
    )


# ---------------------------------------------------------------------------
# anti-entropy merge


def merge_rows(state: HashStore, sl: RowSlice) -> HashMergeResult:
    """Join a received bucket slice (``hash_map.py:348``): the shared
    interval preamble, a kill pass over the synced rows' alive entries,
    presence by probing the slice entries' windows, and probe-placed
    inserts."""
    L = state.num_buckets
    H = state.table_size
    W = state.probe_window
    u, s = sl.key.shape
    dev = sl.key.device

    v = _slice_view(state, sl)
    valid, rows_safe, rows_clip = v.valid, v.rows_safe, v.rows_clip
    gids, rdense, ldense = v.gids, v.rdense, v.ldense
    ln, ln_clip, ins, need_ctx_gap = v.ln, v.ln_clip, v.ins, v.need_ctx_gap

    _, _, _, row_to_u = _row_lookup(sl.rows, L)

    # --- kill pass ((s1∩s2) ∪ (s1∖c2)) over the synced rows
    ent_row = _entry_rows(state)
    u_of = row_to_u[ent_row]  # [H]: position in sl.rows, u = not synced
    in_slice = state.alive & (u_of < u)
    u_clip = u_of.clamp(0, u - 1)
    node_clip = state.node.clamp(0, state.replica_capacity - 1).to(_LONG)
    cov_hi = rdense[u_clip, node_clip]
    cov_lo = ldense[u_clip, node_clip]
    covered = (cov_hi >= state.ctr) & (cov_lo < state.ctr)

    # presence: probe each slice entry's window for its exact local dot
    r_ok = sl.alive & (ln >= 0) & valid[:, None]
    skey_f = sl.key.reshape(u * s)
    slots, slot_in = _window(skey_f, H, W)
    slots_c = torch.where(slot_in, slots, H).to(_LONG)
    slots_g = slots.clamp(0, H - 1).to(_LONG)
    pmatch = (
        r_ok.reshape(u * s)[:, None]
        & slot_in
        & state.alive[slots_g]
        & (state.key[slots_g] == skey_f[:, None])
        & (state.node[slots_g].to(_LONG) == ln_clip.reshape(u * s)[:, None])
        & (state.ctr[slots_g] == sl.ctr.reshape(u * s)[:, None])
    )
    present = _set_drop(
        torch.zeros(H, dtype=torch.bool, device=dev), torch.where(pmatch, slots_c, H), True
    )

    die = in_slice & covered & ~present
    alive1 = state.alive & ~die
    n_kill_row = _count_drop(u, torch.where(die, u_of, u))

    # --- insert pass (s2 ∖ c1): probe-place into dead window lanes
    ins_f = ins.reshape(u * s)
    placed, alive2 = _place(alive1, ins_f, slots, slot_in)
    need_fill_grow = (ins_f & (placed < 0)).any()
    tgt = torch.where(placed >= 0, placed, H)

    eh_ins = entry_hash(
        sl.key,
        _table_lookup(sl.ctx_gid, sl.node.clamp(0, sl.ctx_gid.shape[0] - 1)),
        sl.ctr,
        sl.ts,
        sl.valh,
    )
    ins_rank = (torch.cumsum(ins.to(_LONG), 1) - 1) & M32
    arr_new = (state.rowseq[rows_clip][:, None] + ins_rank) & M32

    put = lambda col, vals: _set_drop(col, tgt, vals.reshape(u * s))
    n_ins_row = ins.to(torch.int32).sum(dim=1, dtype=torch.int32)
    rowseq_ext = torch.cat([state.rowseq, state.rowseq.new_zeros(1)])
    rowseq_ext.index_add_(0, rows_safe, n_ins_row.to(_LONG))
    ctx2 = torch.maximum(v.local_ctx, rdense)
    ctx_ext = torch.cat([state.ctx_max, state.ctx_max.new_zeros(1, state.replica_capacity)])
    ctx_ext[rows_safe] = ctx2

    st2 = HashStore(
        key=put(state.key, sl.key),
        valh=put(state.valh, sl.valh),
        ts=put(state.ts, sl.ts),
        node=put(state.node, ln_clip),
        ctr=put(state.ctr, sl.ctr),
        alive=alive2,
        ehash=put(state.ehash, eh_ins),
        arr=put(state.arr, arr_new),
        leaf=state.leaf,
        rowseq=rowseq_ext[:L] & M32,
        ctx_gid=gids.ctx_gid,
        ctx_max=ctx_ext[:L],
        probe_window=W,
    )
    st2 = dataclasses.replace(
        st2, leaf=_splice_leaf(st2, alive2, st2.ehash, rows_safe, rows_clip)
    )

    ok = ~(gids.overflow | need_fill_grow | need_ctx_gap)
    return HashMergeResult(
        st2,
        ok,
        gids.overflow,
        need_fill_grow,
        need_ctx_gap,
        n_ins_row.sum(),
        n_kill_row.sum(),
        n_ins_row,
        n_kill_row,
        v.gap_row,
        alive2.sum(),
        _max_window_fill(alive2, H, W),
    )


# ---------------------------------------------------------------------------
# extraction (the dense, non-padded wire path)


def row_counts(state: HashStore, rows: torch.Tensor) -> torch.Tensor:
    """int32[U]: alive entries per requested sync row."""
    u = rows.shape[0]
    _, _, _, row_to_u = _row_lookup(rows, state.num_buckets)
    u_of = row_to_u[_entry_rows(state)]
    sel = state.alive & (u_of < u)
    return _count_drop(u, torch.where(sel, u_of, u))


def own_delta_counts(state: HashStore, rows, self_slot: int, lo) -> torch.Tensor:
    """int32[U]: own-writer entries with counter in ``(lo, ∞)`` per
    requested row."""
    u = rows.shape[0]
    _, _, _, row_to_u = _row_lookup(rows, state.num_buckets)
    u_of = row_to_u[_entry_rows(state)]
    u_clip = u_of.clamp(0, u - 1)
    sel = (
        state.alive
        & (u_of < u)
        & (state.node == self_slot)
        & (state.ctr > lo[u_clip])
    )
    return _count_drop(u, torch.where(sel, u_of, u))


def _pack_rows(state: HashStore, rows: torch.Tensor, sel: torch.Tensor, lanes: int):
    """Pack the selected entries into a dense ``[U, lanes]`` grid, each
    row in arrival (``arr``) order, dead lanes zeroed. One stable sort by
    (row position, arr) in unsigned order; per-row lane = global rank −
    row start."""
    u = rows.shape[0]
    H = state.table_size
    dev = rows.device
    _, _, _, row_to_u = _row_lookup(rows, state.num_buckets)
    u_of = row_to_u[_entry_rows(state)]
    u_clip = u_of.clamp(0, u - 1)

    sortkey = torch.where(sel, _flip((u_of << 32) | state.arr), I64_MAX)
    _, order = torch.sort(sortkey, stable=True)
    sel_s = sel[order]
    u_s = u_clip[order]
    counts = _count_drop(u, torch.where(sel, u_of, u)).to(_LONG)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    pos = torch.arange(H, dtype=_LONG, device=dev) - starts[u_s]
    tgt_u = torch.where(sel_s & (pos < lanes), u_s, u)
    tgt_p = pos.clamp(0, lanes - 1)

    def pack(col):
        out = torch.zeros((u + 1, lanes), dtype=col.dtype, device=dev)
        out[tgt_u, tgt_p] = col[order]
        return out[:u]

    cols = {c: pack(getattr(state, c)) for c in ("key", "valh", "ts", "node", "ctr")}
    alive = torch.zeros((u + 1, lanes), dtype=torch.bool, device=dev)
    alive[tgt_u, tgt_p] = sel_s
    return cols, alive[:u]


def extract_rows_packed(state: HashStore, rows: torch.Tensor, lanes: int) -> RowSlice:
    """Dense full-row state slice (``ctx_lo = 0``) for the requested
    sync rows."""
    L = state.num_buckets
    u = rows.shape[0]
    _, _, _, row_to_u = _row_lookup(rows, L)
    u_of = row_to_u[_entry_rows(state)]
    sel = state.alive & (u_of < u)
    cols, alive = _pack_rows(state, rows, sel, lanes)
    valid = rows >= 0
    rows_clip = rows.clamp(0, L - 1).to(_LONG)
    return RowSlice(
        rows=rows,
        key=cols["key"],
        valh=cols["valh"],
        ts=cols["ts"],
        node=cols["node"],
        ctr=cols["ctr"],
        alive=alive,
        ctx_rows=state.ctx_max[rows_clip] * valid[:, None],
        ctx_lo=torch.zeros_like(state.ctx_max[rows_clip]),
        ctx_gid=state.ctx_gid,
    )


def extract_own_delta_packed(
    state: HashStore,
    rows: torch.Tensor,
    self_slot: int,
    gid_self: torch.Tensor,
    lo: torch.Tensor,
    lanes: int,
) -> RowSlice:
    """Dense own-writer delta-interval slice claiming exactly
    ``(lo, ctx_max]`` per row."""
    L = state.num_buckets
    u = rows.shape[0]
    valid, _, rows_clip, row_to_u = _row_lookup(rows, L)
    u_of = row_to_u[_entry_rows(state)]
    u_clip = u_of.clamp(0, u - 1)
    sel = (
        state.alive
        & (u_of < u)
        & (state.node == self_slot)
        & (state.ctr > lo[u_clip])
    )
    cols, alive = _pack_rows(state, rows, sel, lanes)
    hi = state.ctx_max[rows_clip, self_slot] * valid
    return RowSlice(
        rows=rows,
        key=cols["key"],
        valh=cols["valh"],
        ts=cols["ts"],
        node=torch.zeros_like(cols["node"]),
        ctr=cols["ctr"],
        alive=alive,
        ctx_rows=hi[:, None],
        ctx_lo=(lo * valid)[:, None],
        ctx_gid=gid_self.reshape(1),
    )


# ---------------------------------------------------------------------------
# reads


def winners_for_keys_ref(state: HashStore, khash: torch.Tensor) -> KeyWinners:
    """The JAX package's jnp ``winners_for_keys`` (``hash_map.py:624``):
    gather each key's probe window and take the lexicographic (ts, gid,
    ctr) maximum among alive matches. Its not-found rows carry lane-0
    garbage; the replica reads found rows only."""
    H = state.table_size
    W = state.probe_window
    slots, slot_in = _window(khash, H, W)
    slots_g = slots.clamp(0, H - 1).to(_LONG)
    g_alive = state.alive[slots_g] & slot_in & (state.key[slots_g] == khash[:, None])
    g_gid = _table_lookup(
        state.ctx_gid, state.node[slots_g].clamp(0, state.replica_capacity - 1)
    )
    g_ctr = state.ctr[slots_g]
    g_ts = state.ts[slots_g]
    best = _argmax_lww(g_ts, g_gid, g_ctr, g_alive)
    take = lambda a: torch.gather(a, 1, best)[:, 0]
    return KeyWinners(
        found=take(g_alive),
        gid=take(g_gid),
        ctr=take(g_ctr),
        valh=take(state.valh[slots_g]),
        ts=take(g_ts),
    )


def winner_all(state: HashStore):
    """Whole-table LWW winners: one lexicographic sort of the flat table."""
    gid = _table_lookup(state.ctx_gid, state.node.clamp(0, state.replica_capacity - 1))
    one = lambda a: a[None, :]
    return _sorted_winners(
        one(state.key), one(state.ts), one(gid), one(state.ctr),
        one(state.alive), one(state.valh),
    )


def winner_rows_packed(state: HashStore, rows: torch.Tensor, lanes: int):
    """Per-key LWW winners within the given sync rows."""
    u = rows.shape[0]
    _, _, _, row_to_u = _row_lookup(rows, state.num_buckets)
    u_of = row_to_u[_entry_rows(state)]
    sel = state.alive & (u_of < u)
    cols, alive = _pack_rows(state, rows, sel, lanes)
    gid = _table_lookup(state.ctx_gid, cols["node"].clamp(0, state.replica_capacity - 1))
    return _sorted_winners(cols["key"], cols["ts"], gid, cols["ctr"], alive, cols["valh"])


# ---------------------------------------------------------------------------
# maintenance: rehash (THE growth event) + invariant rebuild


def rehash(state: HashStore, table_size: int, probe_window: int):
    """Rebuild the table at ``table_size`` lanes: entries sorted by
    (new base, arrival) take ``slot_j = j + cummax(base_j − j)`` — linear
    probing's first-free-lane rule for the whole table at once. Returns
    ``(state', ok)``."""
    H_old = state.table_size
    dev = state.key.device
    sel = state.alive
    base = probe_base(state.key, table_size)
    sortkey = torch.where(sel, _flip((base.to(_LONG) << 32) | state.arr), I64_MAX)
    _, order = torch.sort(sortkey, stable=True)
    sel_s = sel[order]
    base_s = base[order].to(_LONG)
    j = torch.arange(H_old, dtype=_LONG, device=dev)
    slot = j + torch.cummax(torch.where(sel_s, base_s - j, -(2**40)), 0).values
    disp = slot - base_s
    ok = ~(sel_s & ((slot >= table_size) | (disp >= probe_window))).any()
    tgt = torch.where(sel_s & (slot < table_size), slot, table_size)

    def move(col):
        out = torch.zeros(table_size + 1, dtype=col.dtype, device=dev)
        out[tgt] = col[order]
        return out[:table_size]

    st2 = HashStore(
        key=move(state.key),
        valh=move(state.valh),
        ts=move(state.ts),
        node=move(state.node),
        ctr=move(state.ctr),
        alive=move(sel),
        ehash=move(state.ehash),
        arr=move(state.arr),
        leaf=state.leaf,
        rowseq=state.rowseq,
        ctx_gid=state.ctx_gid,
        ctx_max=state.ctx_max,
        probe_window=probe_window,
    )
    return st2, ok


def compact_rows(state: HashStore) -> HashStore:
    """Rebuild the maintained leaf digests from the entry lanes."""
    L = state.num_buckets
    ent_row = _entry_rows(state)
    sel = state.alive
    leaf = torch.zeros(L + 1, dtype=_LONG, device=sel.device)
    leaf.index_add_(0, torch.where(sel, ent_row, L), torch.where(sel, state.ehash, 0))
    return dataclasses.replace(state, leaf=leaf[:L] & M32)


# ---------------------------------------------------------------------------
# the probe-window point lookup: plain torch version + CUDA kernel
#
# Both compute the ``int32[Q, 8]`` grid of the Pallas TPU kernel
# ``probe_lookup_pallas`` (``delta_crdt_ex_tpu/ops/hash_map.py:839``):
# per query (found, slot, node, ctr, valh, ts_lo, ts_hi, free_slot).
# Not found gives slot −1 and zeros; no dead lane in the window gives
# free_slot = 2^30. The winner is the lexicographic maximum of (ts
# signed, writer gid unsigned, ctr) among alive key-matching window
# lanes, the lowest lane on a full tie (``_argmax_lww``).

#: free_slot when the window holds no dead lane
NO_FREE = 1 << 30


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern of the low 32 bits of an int64."""
    return (((x & M32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def probe_lookup_ref(khash: torch.Tensor, state: HashStore) -> torch.Tensor:
    """Plain torch version of the probe kernel: window gathers plus
    ``_argmax_lww``. ``khash`` is int64[Q] (uint64 bits)."""
    H = state.table_size
    W = state.probe_window
    slots, slot_in = _window(khash, H, W)
    sg = slots.clamp(0, H - 1).to(_LONG)
    alive = state.alive[sg] & slot_in
    m = alive & (state.key[sg] == khash[:, None])
    node = state.node[sg]
    gid = _table_lookup(state.ctx_gid, node.clamp(0, state.replica_capacity - 1))
    ctr = state.ctr[sg]
    ts = state.ts[sg]
    best = _argmax_lww(ts, gid, ctr, m)
    found = m.any(dim=1)
    take = lambda a: torch.where(found, torch.gather(a, 1, best)[:, 0], 0)
    free = slot_in & ~state.alive[sg]
    free_slot = torch.where(free, slots, NO_FREE).amin(dim=1)
    ts_w = take(ts)
    return torch.stack(
        [
            found.to(torch.int32),
            torch.where(found, torch.gather(slots, 1, best)[:, 0], -1),
            take(node).to(torch.int32),
            _as_i32(take(ctr)),
            _as_i32(take(state.valh[sg])),
            _as_i32(ts_w),
            _as_i32(ts_w >> 32),
            free_slot.to(torch.int32),
        ],
        dim=1,
    ).to(torch.int32)


class ProbeLookupKernel:
    """The hand-written CUDA kernel ``probe_lookup`` (``csrc/probe.cu``).

    Replaces the Pallas TPU kernel ``_probe_kernel_body`` /
    ``probe_lookup_pallas`` (``delta_crdt_ex_tpu/ops/hash_map.py:756``,
    ``pallas_call`` at 873).

    Bound on the H100: memory. Per query it reads the window's ``key``
    (8 B) and ``alive`` (1 B) lanes, and ``node``, ``ctr``, ``ts``,
    ``valh`` (4 + 8 + 8 + 8 B) of the key-matching lanes, plus 8 B of
    query and 32 B of grid out; there is no arithmetic to speak of, so
    the least time is those bytes (each distinct lane counted once) over
    3.35 TB/s. Design: a group of G threads per query (G = 8 at the
    default W = 32, at most 32; :meth:`group`), each thread reading a
    4-lane chunk of the window as two 16-byte key loads and one 32-bit
    alive load; a
    grid-stride run of queries per group that fills the card, with the
    next query's hash and window loads issued before the current one
    resolves; node/ctr/ts/valh loaded at the match; the writer table
    staged in shared memory (read from global memory when R > 2048);
    native 64-bit compares; a width-G shuffle butterfly for the LWW
    maximum over (ts, gid, ctr, lane) and the lowest dead lane; and the
    winning lane's thread writing the row as two 16-byte stores from its
    registers. The probe base is computed in the kernel. Any W ≥ 1 and
    any power-of-two H ≥ 8 work (the TPU kernel needs W ≤ 128 and
    H ≥ 256).

    ``launches`` counts launches and ``launches_by_shape`` counts them by
    Q (the wire tier of the caller's batch); the wrapper builds the
    library at first use and raises on any launch error."""

    name = "probe_lookup"
    source = "delta_crdt_ex_tpu_torch/csrc/probe.cu"
    replaces = "delta_crdt_ex_tpu/ops/hash_map.py:873"

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_shape: dict[int, int] = {}
        self._lib = None

    def reset(self) -> None:
        """Zero the launch counts."""
        self.launches = 0
        self.launches_by_shape = {}

    def group(self, window: int) -> int:
        """Threads per query the kernel runs for a window of ``window``
        lanes (``probe_group`` in ``csrc/probe.cu``); chunk c of 4 lanes
        falls to thread c mod G. Builds the library."""
        return int(self._load().probe_group(window))

    def _load(self):
        if self._lib is None:
            from delta_crdt_ex_tpu_torch.utils import kernels

            lib = ctypes.CDLL(str(kernels.build("probe")[0]))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.probe_lookup.argtypes = [p, i, p, p, p, p, p, p, i, i, p, i, p, p]
            lib.probe_lookup.restype = ctypes.c_int
            lib.probe_group.argtypes = [i]
            lib.probe_group.restype = i
            lib.probe_error_string.argtypes = [i]
            lib.probe_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, khash: torch.Tensor, state: HashStore) -> torch.Tensor:
        dev = khash.device
        if dev.type != "cuda":
            raise ValueError(f"probe_lookup kernel needs CUDA tensors, got {dev}")
        cols = {
            "khash": (khash, torch.int64),
            "key": (state.key, torch.int64),
            "alive": (state.alive, torch.bool),
            "node": (state.node, torch.int32),
            "ctr": (state.ctr, torch.int64),
            "ts": (state.ts, torch.int64),
            "valh": (state.valh, torch.int64),
            "ctx_gid": (state.ctx_gid, torch.int64),
        }
        for name, (t, dt) in cols.items():
            if t.device != dev or t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
                raise ValueError(
                    f"probe_lookup: {name} must be a contiguous 1-D {dt} tensor on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        H, W, R, Q = state.table_size, state.probe_window, state.replica_capacity, khash.shape[0]
        for name in ("alive", "node", "ctr", "ts", "valh"):
            if cols[name][0].shape[0] != H:
                raise ValueError(f"probe_lookup: {name} has {cols[name][0].shape[0]} lanes, key {H}")
        if H < GROUP or H & (H - 1) or not 1 <= W <= H or R < 1 or H >= NO_FREE:
            raise ValueError(f"probe_lookup: unsupported table (H={H}, W={W}, R={R})")
        if state.key.data_ptr() % 16 or state.alive.data_ptr() % 4:
            raise ValueError("probe_lookup: key must start on a 16-byte and alive on a 4-byte boundary")
        out = torch.empty((Q, 8), dtype=torch.int32, device=dev)
        if Q == 0:
            return out
        lib = self._load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.probe_lookup(
            khash.data_ptr(), Q,
            state.key.data_ptr(), state.alive.data_ptr(), state.node.data_ptr(),
            state.ctr.data_ptr(), state.ts.data_ptr(), state.valh.data_ptr(),
            H, W, state.ctx_gid.data_ptr(), R,
            out.data_ptr(), stream,
        )
        if err != 0:
            raise RuntimeError(
                f"probe_lookup kernel launch failed: {lib.probe_error_string(err).decode()}"
            )
        self.launches += 1
        self.launches_by_shape[Q] = self.launches_by_shape.get(Q, 0) + 1
        return out


#: the process's one probe kernel wrapper (its ``launches`` count is
#: what ``chip_smoke.py`` reads to prove the main path went through it)
probe_lookup_kernel = ProbeLookupKernel()


def probe_lookup(khash: torch.Tensor, state: HashStore) -> torch.Tensor:
    """The probe grid: the CUDA kernel for CUDA tensors (it launches or
    raises — no fallback), the plain torch version for CPU tensors."""
    if khash.device.type == "cpu":
        return probe_lookup_ref(khash, state)
    return probe_lookup_kernel(khash, state)


def probe_winners(state: HashStore, khash: torch.Tensor) -> KeyWinners:
    """:class:`KeyWinners` view of the probe grid (``hash_map.py:909``):
    the port's ``winners_for_keys``."""
    out = probe_lookup(khash, state)
    u32 = lambda col: col.to(_LONG) & M32
    node = out[:, 2].clamp(0, state.replica_capacity - 1)
    return KeyWinners(
        found=out[:, 0] != 0,
        gid=_table_lookup(state.ctx_gid, node),
        ctr=u32(out[:, 3]),
        valh=u32(out[:, 4]),
        ts=(out[:, 6].to(_LONG) << 32) | u32(out[:, 5]),
    )


#: the hash model's point read
winners_for_keys = probe_winners
