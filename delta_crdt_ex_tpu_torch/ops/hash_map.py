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
stamps, the same escape flags. The ops the hash fleet runs
(:func:`merge_rows`, :func:`row_counts`, :func:`own_delta_counts`,
:func:`extract_rows_packed`, :func:`extract_own_delta_packed`,
:func:`winner_all`) also take a stack of tables (``[N, H]`` columns)
with per-lane arguments, where the JAX package ``vmap``s them; a
single table runs as one lane. Integer layout and the unsigned-order
helpers are in :mod:`delta_crdt_ex_tpu_torch.ops.binned`. Scatters whose
JAX form drops out-of-range indices (``mode="drop"``) write into one
extra sentinel element per lane that is then cut off; every scatter
with possibly repeated indices either writes one value or reduces with
an order-free reduction (``amin``, integer ``scatter_add_``), so the
result does not depend on the order CUDA applies them in.

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
    _lane0,
    _lane_args,
    _lane_slice,
    _lanes,
    _mix64,
    _slice_view_b,
    _sorted_winners,
    _table_lookup,
    _with_lanes,
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


# ---------------------------------------------------------------------------
# lane-batched scatter helpers. Every column here is ``[N, H]`` (or
# ``[N, L]``): one flat table per lane. A drop-mode scatter sends its
# out-of-range writes to index ``H`` of the lane's own row of an
# ``[N, H + 1]`` copy (the sentinel column, cut off after), so one
# lane's dropped write never lands in another lane; a window's lanes
# never pass ``H`` either (``_window`` masks them), so a window near a
# table's end cannot read into the next lane's table.


def _set_drop_b(col: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``col[n].at[idx[n]].set(vals[n], mode="drop")`` per lane, out of
    place, where the only out-of-range index is ``H``. Indices below
    ``H`` are distinct within a lane, or written with one value."""
    n = col.shape[0]
    ext = torch.cat([col, col[:, :1]], 1)
    idx = idx.reshape(n, -1).to(_LONG)
    if isinstance(vals, torch.Tensor):
        src = vals.to(col.dtype).reshape(n, -1)
    else:
        src = torch.full(idx.shape, vals, dtype=col.dtype, device=col.device)
    ext.scatter_(1, idx, src)
    return ext[:, :-1]


def _count_drop_b(u: int, idx: torch.Tensor) -> torch.Tensor:
    """int32[N, u]: ``zeros(u).at[idx[n]].add(1, mode="drop")`` per lane
    (index ``u`` drops)."""
    n = idx.shape[0]
    idx = idx.reshape(n, -1).to(_LONG)
    out = torch.zeros((n, u + 1), dtype=torch.int32, device=idx.device)
    out.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:, :u]


def _place_b(occupied: torch.Tensor, want: torch.Tensor, slots: torch.Tensor, slot_ok: torch.Tensor):
    """Place each flagged entry at the first unoccupied lane of its
    candidate window, resolving same-lane collisions within the batch:
    ``W`` rounds of propose → scatter-min claim → winners commit
    (``hash_map.py:101``), every table of the stack at once. ``occupied``
    is ``[N, H]``, ``want`` ``[N, K]``, ``slots``/``slot_ok``
    ``[N, K, W]``. Returns ``(placed int64[N, K] (-1 = window full),
    occupied')``."""
    n, k, w = slots.shape
    h = occupied.shape[1]
    dev = occupied.device
    slots_c = torch.where(slot_ok, slots, h).to(_LONG)  # h = out-of-window sentinel
    used_p = torch.cat([occupied, torch.ones((n, 1), dtype=torch.bool, device=dev)], 1)
    ids = torch.arange(k, dtype=_LONG, device=dev).expand(n, k)
    placed = torch.full((n, k), -1, dtype=_LONG, device=dev)
    for _ in range(w):
        unplaced = want & (placed < 0)
        free = ~torch.gather(used_p, 1, slots_c.reshape(n, k * w)).reshape(n, k, w)
        has = free.any(dim=2)
        pos = free.to(torch.int32).argmax(dim=2, keepdim=True)
        go = unplaced & has
        cand = torch.where(go, torch.gather(slots_c, 2, pos)[..., 0], h)
        claim = torch.full((n, h + 1), k, dtype=_LONG, device=dev)
        claim.scatter_reduce_(1, cand, ids, "amin")
        win = go & (torch.gather(claim, 1, cand) == ids)
        placed = torch.where(win, cand, placed)
        used_p.scatter_(1, torch.where(win, cand, h), True)
    return placed, used_p[:, :-1]


def _row_lookup_b(rows: torch.Tensor, num_buckets: int):
    """``(valid[N, U], rows_safe[N, U] (L = padding sentinel),
    rows_clip[N, U], row_to_u[N, L])`` where ``row_to_u`` maps a sync
    bucket to its position in the lane's ``rows`` (``U`` = not
    requested)."""
    n, u = rows.shape
    valid = rows >= 0
    rows_safe = torch.where(valid, rows, num_buckets).to(_LONG)
    rows_clip = rows_safe.clamp(0, num_buckets - 1)
    row_to_u = _set_drop_b(
        torch.full((n, num_buckets), u, dtype=_LONG, device=rows.device),
        rows_safe,
        torch.arange(u, dtype=_LONG, device=rows.device).expand(n, u),
    )
    return valid, rows_safe, rows_clip, row_to_u


def _max_window_fill_b(alive: torch.Tensor, table_size: int, window: int) -> torch.Tensor:
    """int64[N]: alive entries in each table's fullest probe window (the
    growth pressure signal)."""
    a = alive.to(_LONG)
    cum = torch.cumsum(a, 1)
    bases = torch.arange(0, table_size, GROUP, dtype=_LONG, device=alive.device)
    hi = (bases + window - 1).clamp(0, table_size - 1)
    below = cum[:, bases] - a[:, bases]
    return (cum[:, hi] - below).amax(dim=1)


def max_window_fill(state: HashStore) -> torch.Tensor:
    """int64 (one per lane for a stacked store): alive entries in the
    fullest probe window."""
    a = state.alive
    fill = _max_window_fill_b(a.reshape(-1, a.shape[-1]), state.table_size, state.probe_window)
    return fill.reshape(a.shape[:-1])


def _entry_rows(state: HashStore) -> torch.Tensor:
    """int64[..., H]: the sync bucket of each slot's key (stale for dead
    slots — always mask by ``alive``)."""
    return state.key & (state.num_buckets - 1)


def _u_of(state: HashStore, rows: torch.Tensor) -> torch.Tensor:
    """int64[N, H]: each slot's position in its lane's requested ``rows``
    (``U`` = its bucket was not requested)."""
    _, _, _, row_to_u = _row_lookup_b(rows, state.num_buckets)
    return torch.gather(row_to_u, 1, _entry_rows(state))


def _splice_leaf_b(state: HashStore, alive2, ehash2, rows_safe, rows_clip):
    """Recompute the maintained leaf digests of the touched rows from
    the updated tables (wrapping sum of alive ehash), every lane."""
    n, L = state.leaf.shape
    ent_row = _entry_rows(state)
    touched = _set_drop_b(torch.zeros((n, L), dtype=torch.bool, device=alive2.device), rows_safe, True)
    sel = alive2 & torch.gather(touched, 1, ent_row)
    leaf_all = torch.zeros((n, L + 1), dtype=_LONG, device=alive2.device)
    leaf_all.scatter_add_(1, torch.where(sel, ent_row, L), torch.where(sel, ehash2, 0))
    leaf_all = leaf_all[:, :L] & M32
    return _set_drop_b(state.leaf, rows_safe, torch.gather(leaf_all, 1, rows_clip))


# one-table forms for ``row_apply``, which has no lane axis

def _set_drop(col: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    return _set_drop_b(col[None], idx[None], vals[None] if isinstance(vals, torch.Tensor) else vals)[0]


def _place(occupied, want, slots, slot_ok):
    placed, used = _place_b(occupied[None], want[None], slots[None], slot_ok[None])
    return placed[0], used[0]


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
    ×2 and retries. One table only: the fleet mutates through each
    member's own replica."""
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
    st1, _ = _with_lanes(st2)
    leaf = _splice_leaf_b(st1, alive2[None], st2.ehash[None], rows_safe[None], rows_clip[None])[0]
    st2 = dataclasses.replace(st2, leaf=leaf)

    # telemetry count: distinct keys whose dot store changed
    earlier = torch.tril(torch.ones((m, m), dtype=torch.bool, device=dev), -1)
    first_occ = ~(key_eq & earlier[None] & is_touch[:, None, :]).any(dim=2)
    changed = is_touch & first_occ & (ins | killed_any)

    return HashApplyResult(
        st2, ok, ctr_assigned, changed.sum(), row_killed,
        alive2.sum(), _max_window_fill_b(alive2[None], H, W)[0],
    )


class HashMergeResult(NamedTuple):
    """Each field has a leading lane axis for a stacked store."""

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


def _merge_rows_b(state: HashStore, sl: RowSlice) -> HashMergeResult:
    n, H = state.key.shape
    L = state.num_buckets
    W = state.probe_window
    R = state.replica_capacity
    u, s = sl.key.shape[-2:]
    k = u * s
    dev = state.device
    lanes = _lanes(n, dev)  # [N, 1]
    lanes3 = lanes[..., None]  # [N, 1, 1]

    v = _slice_view_b(state.ctx_gid, state.ctx_max, sl)

    # --- kill pass ((s1∩s2) ∪ (s1∖c2)) over the synced rows
    u_of = _u_of(state, sl.rows)  # [N, H]: position in sl.rows, u = not synced
    in_slice = state.alive & (u_of < u)
    u_clip = u_of.clamp(0, u - 1)
    node_clip = state.node.clamp(0, R - 1).to(_LONG)
    cov_hi = v.rdense[lanes, u_clip, node_clip]
    cov_lo = v.ldense[lanes, u_clip, node_clip]
    covered = (cov_hi >= state.ctr) & (cov_lo < state.ctr)

    # presence: probe each slice entry's window for its exact local dot
    r_ok = (sl.alive & (v.ln >= 0) & v.valid[..., None]).reshape(n, k)
    skey_f = sl.key.reshape(n, k)
    slots, slot_in = _window(skey_f, H, W)  # [N, K, W]
    slots_c = torch.where(slot_in, slots, H).to(_LONG)
    slots_g = slots.clamp(0, H - 1).to(_LONG)
    at = lambda col: col[lanes3, slots_g]
    pmatch = (
        r_ok[..., None]
        & slot_in
        & at(state.alive)
        & (at(state.key) == skey_f[..., None])
        & (at(state.node).to(_LONG) == v.ln_clip.reshape(n, k)[..., None])
        & (at(state.ctr) == sl.ctr.reshape(n, k)[..., None])
    )
    present = _set_drop_b(
        torch.zeros((n, H), dtype=torch.bool, device=dev), torch.where(pmatch, slots_c, H), True
    )

    die = in_slice & covered & ~present
    alive1 = state.alive & ~die
    n_kill_row = _count_drop_b(u, torch.where(die, u_of, u))

    # --- insert pass (s2 ∖ c1): probe-place into dead window lanes
    ins_f = v.ins.reshape(n, k)
    placed, alive2 = _place_b(alive1, ins_f, slots, slot_in)
    need_fill_grow = (ins_f & (placed < 0)).any(dim=1)
    tgt = torch.where(placed >= 0, placed, H)

    rr = sl.ctx_gid.shape[-1]
    gid_ins = torch.gather(sl.ctx_gid[:, None, :].expand(n, u, rr), -1, sl.node.clamp(0, rr - 1).to(_LONG))
    eh_ins = entry_hash(sl.key, gid_ins, sl.ctr, sl.ts, sl.valh)
    ins_rank = (torch.cumsum(v.ins.to(_LONG), -1) - 1) & M32
    arr_new = (state.rowseq[lanes, v.rows_clip][..., None] + ins_rank) & M32

    put = lambda col, vals: _set_drop_b(col, tgt, vals)
    n_ins_row = v.ins.sum(dim=-1, dtype=torch.int32)
    rowseq_ext = torch.cat([state.rowseq, state.rowseq.new_zeros(n, 1)], 1)
    rowseq_ext.scatter_add_(1, v.rows_safe, n_ins_row.to(_LONG))
    ctx_ext = torch.cat([state.ctx_max, state.ctx_max.new_zeros(n, 1, R)], 1)
    ctx_ext[lanes, v.rows_safe] = torch.maximum(v.local_ctx, v.rdense)

    st2 = HashStore(
        key=put(state.key, sl.key),
        valh=put(state.valh, sl.valh),
        ts=put(state.ts, sl.ts),
        node=put(state.node, v.ln_clip),
        ctr=put(state.ctr, sl.ctr),
        alive=alive2,
        ehash=put(state.ehash, eh_ins),
        arr=put(state.arr, arr_new),
        leaf=state.leaf,
        rowseq=rowseq_ext[:, :L] & M32,
        ctx_gid=v.gids.ctx_gid,
        ctx_max=ctx_ext[:, :L],
        probe_window=W,
    )
    st2 = dataclasses.replace(
        st2, leaf=_splice_leaf_b(st2, alive2, st2.ehash, v.rows_safe, v.rows_clip)
    )

    ok = ~(v.gids.overflow | need_fill_grow | v.need_ctx_gap)
    return HashMergeResult(
        st2,
        ok,
        v.gids.overflow,
        need_fill_grow,
        v.need_ctx_gap,
        n_ins_row.sum(dim=-1),
        n_kill_row.sum(dim=-1),
        n_ins_row,
        n_kill_row,
        v.gap_row,
        alive2.sum(dim=-1),
        _max_window_fill_b(alive2, H, W),
    )


def merge_rows(state: HashStore, sl: RowSlice) -> HashMergeResult:
    """Join a received bucket slice (``hash_map.py:348``): the shared
    interval preamble, a kill pass over the synced rows' alive entries,
    presence by probing the slice entries' windows, and probe-placed
    inserts. ``state`` is one table or a stack (``[N, H]`` columns) with
    one slice per lane (the fleet's batched merge; lane k is the solo
    merge on lane k). Never writes into its inputs."""
    st, single = _with_lanes(state)
    res = _merge_rows_b(st, _lane_slice(sl, st.key.shape[0]))
    return _lane0(res) if single else res


# ---------------------------------------------------------------------------
# extraction (the dense, non-padded wire path). Each op takes one table
# or a stack with per-lane arguments (rows ``[N, U]``, one self slot,
# writer gid and ``lo`` row per lane).


def _row_counts_b(state: HashStore, rows) -> torch.Tensor:
    u = rows.shape[-1]
    u_of = _u_of(state, rows)
    return _count_drop_b(u, torch.where(state.alive & (u_of < u), u_of, u))


def row_counts(state: HashStore, rows: torch.Tensor) -> torch.Tensor:
    """int32[U]: alive entries per requested sync row."""
    st, single, (rows,) = _lane_args(state, rows)
    res = _row_counts_b(st, rows)
    return res[0] if single else res


def _own_delta_sel(state: HashStore, u_of, self_slot, lo) -> torch.Tensor:
    """bool[N, H]: own-writer entries of the requested rows with counter
    in ``(lo, ∞)``."""
    u = lo.shape[-1]
    return (
        state.alive
        & (u_of < u)
        & (state.node == self_slot[:, None])
        & (state.ctr > torch.gather(lo, 1, u_of.clamp(0, u - 1)))
    )


def own_delta_counts(state: HashStore, rows, self_slot, lo) -> torch.Tensor:
    """int32[U]: own-writer entries with counter in ``(lo, ∞)`` per
    requested row."""
    st, single, (rows, self_slot, lo) = _lane_args(state, rows, self_slot, lo)
    u = rows.shape[-1]
    u_of = _u_of(st, rows)
    res = _count_drop_b(u, torch.where(_own_delta_sel(st, u_of, self_slot, lo), u_of, u))
    return res[0] if single else res


def _pack_rows_b(state: HashStore, u_of: torch.Tensor, sel: torch.Tensor, u: int, lanes: int):
    """Pack the selected entries into a dense ``[N, U, lanes]`` grid,
    each row in arrival (``arr``) order, dead lanes zeroed. One stable
    sort per table by (row position, arr) in unsigned order; per-row
    lane = rank in the table − row start."""
    n, H = state.key.shape
    dev = state.device
    li = _lanes(n, dev)
    u_clip = u_of.clamp(0, u - 1)

    sortkey = torch.where(sel, _flip((u_of << 32) | state.arr), I64_MAX)
    _, order = torch.sort(sortkey, dim=1, stable=True)
    sel_s = torch.gather(sel, 1, order)
    u_s = torch.gather(u_clip, 1, order)
    counts = _count_drop_b(u, torch.where(sel, u_of, u)).to(_LONG)
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(H, dtype=_LONG, device=dev) - torch.gather(starts, 1, u_s)
    tgt_u = torch.where(sel_s & (pos < lanes), u_s, u)
    tgt_p = pos.clamp(0, lanes - 1)

    def pack(col):
        out = torch.zeros((n, u + 1, lanes), dtype=col.dtype, device=dev)
        out[li, tgt_u, tgt_p] = torch.gather(col, 1, order)
        return out[:, :u]

    cols = {c: pack(getattr(state, c)) for c in ("key", "valh", "ts", "node", "ctr")}
    return cols, pack(sel)


def _extract_rows_packed_b(state: HashStore, rows, lanes: int) -> RowSlice:
    L = state.num_buckets
    u = rows.shape[-1]
    u_of = _u_of(state, rows)
    cols, alive = _pack_rows_b(state, u_of, state.alive & (u_of < u), u, lanes)
    valid = rows >= 0
    ctx = state.ctx_max[_lanes(rows.shape[0], rows.device), rows.clamp(0, L - 1).to(_LONG)]
    return RowSlice(
        rows=rows,
        key=cols["key"],
        valh=cols["valh"],
        ts=cols["ts"],
        node=cols["node"],
        ctr=cols["ctr"],
        alive=alive,
        ctx_rows=ctx * valid[..., None],
        ctx_lo=torch.zeros_like(ctx),
        ctx_gid=state.ctx_gid,
    )


def extract_rows_packed(state: HashStore, rows: torch.Tensor, lanes: int) -> RowSlice:
    """Dense full-row state slice (``ctx_lo = 0``) for the requested
    sync rows, ``lanes`` entries wide."""
    st, single, (rows,) = _lane_args(state, rows)
    res = _extract_rows_packed_b(st, rows, lanes)
    return _lane0(res) if single else res


def _extract_own_delta_packed_b(state: HashStore, rows, self_slot, gid_self, lo, lanes: int) -> RowSlice:
    L = state.num_buckets
    u = rows.shape[-1]
    li = _lanes(rows.shape[0], rows.device)
    u_of = _u_of(state, rows)
    cols, alive = _pack_rows_b(state, u_of, _own_delta_sel(state, u_of, self_slot, lo), u, lanes)
    valid = rows >= 0
    hi = state.ctx_max[li, rows.clamp(0, L - 1).to(_LONG), self_slot[:, None]] * valid
    return RowSlice(
        rows=rows,
        key=cols["key"],
        valh=cols["valh"],
        ts=cols["ts"],
        node=torch.zeros_like(cols["node"]),
        ctr=cols["ctr"],
        alive=alive,
        ctx_rows=hi[..., None],
        ctx_lo=(lo * valid)[..., None],
        ctx_gid=gid_self[:, None],
    )


def extract_own_delta_packed(state: HashStore, rows, self_slot, gid_self, lo, lanes: int) -> RowSlice:
    """Dense own-writer delta-interval slice claiming exactly
    ``(lo, ctx_max]`` per row."""
    st, single, (rows, self_slot, gid_self, lo) = _lane_args(state, rows, self_slot, gid_self, lo)
    res = _extract_own_delta_packed_b(st, rows, self_slot, gid_self, lo, lanes)
    return _lane0(res) if single else res


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
    """Whole-table LWW winners: one lexicographic sort of each flat
    table (``[1, H]`` fields, ``[N, 1, H]`` for a stack)."""
    st, single = _with_lanes(state)
    gid = torch.gather(st.ctx_gid, 1, st.node.clamp(0, st.replica_capacity - 1).to(_LONG))
    one = lambda a: a[:, None, :]
    res = _sorted_winners(
        one(st.key), one(st.ts), one(gid), one(st.ctr), one(st.alive), one(st.valh),
    )
    return _lane0(res) if single else res


def winner_rows_packed(state: HashStore, rows: torch.Tensor, lanes: int):
    """Per-key LWW winners within the given sync rows."""
    st, _, (rows,) = _lane_args(state, rows)
    u = rows.shape[-1]
    u_of = _u_of(st, rows)
    cols, alive = _pack_rows_b(st, u_of, st.alive & (u_of < u), u, lanes)
    cols, alive = {c: x[0] for c, x in cols.items()}, alive[0]
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
    (H, W, Q): the table's lanes, its probe window and the wire tier of
    the caller's batch; the wrapper builds the library at first use and
    raises on any launch error."""

    name = "probe_lookup"
    source = "delta_crdt_ex_tpu_torch/csrc/probe.cu"
    replaces = "delta_crdt_ex_tpu/ops/hash_map.py:873"

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_shape: dict[tuple[int, int, int], int] = {}
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
        self.launches_by_shape[(H, W, Q)] = self.launches_by_shape.get((H, W, Q), 0) + 1
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
