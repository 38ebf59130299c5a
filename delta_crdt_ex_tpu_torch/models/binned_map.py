"""The model seam of the binned store — the PyTorch port of
``delta_crdt_ex_tpu/models/binned_map.py``: batch grouping, the
delta-interval gap error, the wire fan-in that combines several
EntriesMsg bodies into one slice, the host's merge loops
(:func:`tier_retry_merge`, :func:`merge_into`, :func:`merge_rows_into`,
:func:`merge_group_into`) that own the growth policy, and the model
classes the replica runtime is generic over: :class:`BinnedAWLWWMap`
(the default ``AWLWWMap``) and :class:`AWSet`.

Batch grouping and the fan-in stay host numpy (they shape the wire and
the kernel inputs exactly as the JAX package does); the combined slice
lands on the caller's torch device. Each merge loop reads the flags it
branches on with one device-to-host copy per attempt.
"""

from __future__ import annotations

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import (
    BinnedStore,
    from_numpy as binned_store_from_numpy,
    pow2_tier as _pow2,
    pow4_tier as _pow4,
    to_numpy as binned_store_to_numpy,
)
from delta_crdt_ex_tpu_torch.ops import binned as binned_ops
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_CLEAR, OP_PAD, OP_REMOVE
from delta_crdt_ex_tpu_torch.ops.binned import (
    RowSlice,
    compact_rows,
    merge_rows,
    merge_slice,
    slice_from_wire,
)
from delta_crdt_ex_tpu_torch.runtime import tracing


class GroupedBatch:
    """A local mutation batch grouped by bucket row for :func:`row_apply`.

    ``index`` maps each original batch position to its (row, col) in the
    grouped arrays so callers can recover per-op results (assigned dot
    counters). Shapes are padded to power-of-two tiers to bound kernel
    recompiles.
    """

    def __init__(self, rows, op, key, valh, ts, index):
        self.rows = rows
        self.op = op
        self.key = key
        self.valh = valh
        self.ts = ts
        self.index = index


def group_batch(num_buckets: int, op, key, valh, ts) -> GroupedBatch:
    """Group flat batch arrays (numpy, batch order) by bucket row.

    Ops for the same key keep their relative order inside a row, which is
    all the sequential batch semantics need (ops on different keys
    commute; see :func:`delta_crdt_ex_tpu.ops.binned.row_apply`).
    ``clear`` must be split out by the caller (``clear_all``).
    """
    n = len(op)
    bucket = (key & np.uint64(num_buckets - 1)).astype(np.int64)
    order: dict[int, int] = {}
    cols = np.zeros(n, np.int64)
    counts: dict[int, int] = {}
    urow_of = np.zeros(n, np.int64)
    for i in range(n):
        b = int(bucket[i])
        if b not in order:
            order[b] = len(order)
            counts[b] = 0
        urow_of[i] = order[b]
        cols[i] = counts[b]
        counts[b] += 1
    u = _pow2(max(len(order), 1))
    m = _pow2(max(counts.values(), default=1))
    rows = np.full(u, -1, np.int32)
    for b, r in order.items():
        rows[r] = b
    g_op = np.full((u, m), OP_PAD, np.int32)
    g_key = np.zeros((u, m), np.uint64)
    g_valh = np.zeros((u, m), np.uint32)
    g_ts = np.zeros((u, m), np.int64)
    g_op[urow_of, cols] = op
    g_key[urow_of, cols] = key
    g_valh[urow_of, cols] = valh
    g_ts[urow_of, cols] = ts
    return GroupedBatch(rows, g_op, g_key, g_valh, g_ts, (urow_of, cols))


_CTX_GAP_MSG = (
    "delta-interval slice is not contiguous with the local context; "
    "re-sync with a full-row slice (ctx_lo=0)"
)


class CtxGapError(ValueError):
    # the port's own type: ``except CtxGapError`` in the port matches
    # this class, never the JAX package's
    """A delta-interval slice is not contiguous with the local context
    (``need_ctx_gap``): growth cannot heal this — the *sender* must fall
    back to a full-row (state-form, ``ctx_lo=0``) slice. A distinct type
    so sync layers that ship delta-intervals can catch it and request the
    fallback — the replica runtime's eager delta pushes do exactly that
    (``runtime/replica.py``: ``_push_deltas`` sends intervals, the
    ``_handle_entries_inner`` catcher answers a gap with a ``GetDiffMsg``
    full-row repair).

    ``gap_rows`` (numpy bool[U], when the row-granular kernel raised) is
    the per-row gap mask; ``gapped_members`` (set[int], when a grouped
    fan-in merge raised) maps those rows back to the offending member
    slices so the caller replays only the gapped senders solo and keeps
    the clean members in one grouped dispatch."""

    gap_rows = None  # numpy bool[U] from the row-granular kernel
    gapped_members: "set[int] | None" = None  # member indices of a grouped merge


def tier_retry_merge(
    state: BinnedStore,
    sl: RowSlice,
    merge,
    compact,
    kill_budget: int,
    max_inserts: int,
    on_grow=None,
):
    """The tier-escalation policy shared by the single-state and the
    neighbour-stack merge paths (``binned_map.py:127``): run
    ``merge(state, sl, kill_budget, max_inserts)``, and on overflow grow
    the offending tier and retry on the PRE-merge state — gid table ×2,
    kill budget ×4 (capped at the slice's row count), insert tier ×4
    (capped at the slice grid), and for fill overflow one compact first,
    then bin capacity ×2. Flags of a stack reduce with any/all, so one
    overflowing neighbour retiers the whole stack.

    Returns ``(new_state, last_result, n_retries)``; raises
    :class:`CtxGapError` on a non-contiguous delta-interval.

    Under a profiler the call is the ``crdt.merge_into`` span, each
    merge a ``crdt.merge.attempt``, each flag read a ``crdt.merge.flags``
    and each escalation a ``crdt.merge.grow.*`` or
    ``crdt.merge.compact`` span (:mod:`~delta_crdt_ex_tpu_torch.runtime.tracing`)."""
    with tracing.annotate("crdt.merge_into"):
        compacted = False
        retries = 0
        mi = max_inserts
        while True:
            with tracing.annotate("crdt.merge.attempt"):
                res = merge(state, sl, kill_budget, mi)
            flags = torch.stack([
                res.ok.all(), res.need_ctx_gap.any(), res.need_gid_grow.any(),
                res.need_kill_tier.any(), res.need_ins_tier.any(), res.need_fill_compact.any(),
            ])
            with tracing.annotate("crdt.merge.flags"):
                ok, gap, gid, kill, ins, fill = flags.tolist()  # one device sync for every branch below
            del flags  # not held on the device through a retry's merge
            if ok:
                return res.state, res, retries
            retries += 1
            if gap:
                raise CtxGapError(_CTX_GAP_MSG)
            if gid:
                with tracing.annotate("crdt.merge.grow.gid"):
                    state = state.grow(replica_capacity=state.replica_capacity * 2)
                    if on_grow:
                        on_grow(state)
            if kill:
                with tracing.annotate("crdt.merge.grow.kill"):
                    kill_budget = min(kill_budget * 4, int(sl.rows.shape[0]))
            if ins:
                with tracing.annotate("crdt.merge.grow.ins"):
                    mi = min(mi * 4, int(sl.alive.numel()))
            if fill:
                if not compacted:
                    with tracing.annotate("crdt.merge.compact"):
                        state = compact(state)
                    compacted = True
                else:
                    with tracing.annotate("crdt.merge.grow.bins"):
                        state = state.grow(bin_capacity=state.bin_capacity * 2)
                        if on_grow:
                            on_grow(state)


def merge_rows_into(state: BinnedStore, sl: RowSlice, on_grow=None):
    """Merge a RowSlice through the row-granular kernel
    (:func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_rows`), growing the
    gid table or the bins on overflow (``binned_map.py:184``). Returns
    ``(new_state, last_result)``; raises :class:`CtxGapError` (with
    ``gap_rows``) on a non-contiguous delta-interval.

    Under a profiler each flag read is a ``crdt.merge.flags`` span and
    each growth a ``crdt.merge.grow.gid`` or ``crdt.merge.grow.bins``
    span, as in :func:`tier_retry_merge`."""
    while True:
        res = merge_rows(state, sl)
        flags = torch.stack([res.ok, res.need_ctx_gap, res.need_gid_grow, res.need_fill_grow])
        with tracing.annotate("crdt.merge.flags"):
            ok, gap, gid, fill = flags.tolist()
        if ok:
            return res.state, res
        if gap:
            err = CtxGapError(_CTX_GAP_MSG)
            err.gap_rows = res.gap_row.cpu().numpy()
            raise err
        if gid:
            with tracing.annotate("crdt.merge.grow.gid"):
                state = state.grow(replica_capacity=state.replica_capacity * 2)
                if on_grow:
                    on_grow(state)
        if fill:
            with tracing.annotate("crdt.merge.grow.bins"):
                state = state.grow(bin_capacity=state.bin_capacity * 2)
                if on_grow:
                    on_grow(state)


def merge_into(
    state: BinnedStore, sl: RowSlice, kill_budget: int = 16, on_grow=None, n_alive: int | None = None
):
    """Merge a RowSlice into one state through :func:`tier_retry_merge`
    over the element-scatter kernel (``binned_map.py:443``), the insert
    tier starting at the ×4 wire tier of the slice's alive count (pass
    ``n_alive`` when the host knows it, to skip a device read). Returns
    ``(new_state, last_result)``."""
    if n_alive is None:
        n_alive = int(sl.alive.sum())
    new_state, res, _ = tier_retry_merge(
        state, sl, merge_slice, compact_rows, kill_budget, _pow4(max(n_alive, 1)), on_grow=on_grow
    )
    return new_state, res


#: entry columns of the EntriesMsg wire dict, in RowSlice order
_WIRE_ENTRY_COLS = ("key", "valh", "ts", "ctr", "alive")


def combine_entry_arrays(arrays_list: list, device) -> "tuple[RowSlice, list]":
    """Combine k host-plane ``EntriesMsg`` column dicts into ONE
    :class:`~delta_crdt_ex_tpu_torch.ops.binned.RowSlice` on ``device``
    (``None``: a RowSlice of host numpy columns in the wire dtypes, the
    fleet's staging form for :func:`stack_entry_slices`) — the ingress
    coalescing fan-in: instead of k sequential ``merge_rows`` dispatches,
    the runtime merges the whole group with one.

    Safety preconditions (the caller's grouping rules):

    - bucket rows are pairwise DISJOINT across messages — ``merge_rows``
      is row-local, so the combined merge then equals the sequential
      merges bit-for-bit (insert/kill/pack decisions per row see exactly
      the state the sequential merge would);
    - entry lane tiers are EQUAL (``key.shape[1]``) — the row-compact
      sort width is then identical to the per-message merges, so even
      dead-slot bytes match.

    Writer tables are unioned in first-appearance order (message order,
    slot order within a message) — the same order sequential
    ``merge_gid_tables`` calls would append unknown gids in, keeping
    ``ctx_gid`` bit-identical. Each message's ``node`` column and context
    columns are remapped into the union table; zero-gid (empty) slots
    map to a guaranteed-empty padding column so they stay "no local
    slot" (-1) through the kernel's remap, exactly as before combining.

    Returns ``(slice, offsets)`` where ``offsets[i] = (lo, hi)`` is
    message i's row range in the combined slice (for per-message
    accounting over the kernel's per-row counts).
    """
    # union writer table, first-appearance order
    union_idx: dict[int, int] = {}
    for a in arrays_list:
        for g in np.asarray(a["ctx_gid"]).tolist():
            if g != 0 and g not in union_idx:
                union_idx[g] = len(union_idx)
    rr_u = len(union_idx)
    rp = _pow2(rr_u + 1, floor=2)  # ≥1 trailing zero column, tiered
    null_col = rr_u  # first padding column: gid 0, remaps to -1
    ctx_gid = np.zeros(rp, np.uint64)
    if rr_u:
        ctx_gid[:rr_u] = np.array(list(union_idx), dtype=np.uint64)

    parts: dict[str, list] = {c: [] for c in _WIRE_ENTRY_COLS}
    rows_parts: list = []
    node_parts: list = []
    ctx_rows_parts: list = []
    ctx_lo_parts: list = []
    offsets: list[tuple[int, int]] = []
    off = 0
    for a in arrays_list:
        table = np.asarray(a["ctx_gid"])
        rr_i = table.shape[0]
        remap = np.full(rr_i, null_col, np.int64)
        nz = np.nonzero(table)[0]
        remap[nz] = [union_idx[int(g)] for g in table[nz].tolist()]
        node = np.asarray(a["node"])
        node_parts.append(remap[np.clip(node, 0, rr_i - 1)].astype(np.int32))
        u_i = node.shape[0]
        crows = np.zeros((u_i, rp), np.uint32)
        clo = np.zeros((u_i, rp), np.uint32)
        crows[:, remap[nz]] = np.asarray(a["ctx_rows"])[:, nz]
        clo[:, remap[nz]] = np.asarray(a["ctx_lo"])[:, nz]
        ctx_rows_parts.append(crows)
        ctx_lo_parts.append(clo)
        rows_parts.append(np.asarray(a["rows"], np.int32))
        for c in _WIRE_ENTRY_COLS:
            parts[c].append(np.asarray(a[c]))
        offsets.append((off, off + u_i))
        off += u_i

    cols = {c: np.concatenate(parts[c], axis=0) for c in _WIRE_ENTRY_COLS}
    rows = np.concatenate(rows_parts)
    node = np.concatenate(node_parts, axis=0)
    ctx_rows = np.concatenate(ctx_rows_parts, axis=0)
    ctx_lo = np.concatenate(ctx_lo_parts, axis=0)

    # pad the row axis to the wire tier (bounds distinct compiles); -1
    # rows are dropped by the kernel's valid mask
    u_pad = _pow4(max(off, 1))
    if u_pad != off:
        pad = u_pad - off
        rows = np.concatenate([rows, np.full(pad, -1, np.int32)])
        node = np.concatenate([node, np.zeros((pad,) + node.shape[1:], node.dtype)])
        ctx_rows = np.concatenate([ctx_rows, np.zeros((pad, rp), np.uint32)])
        ctx_lo = np.concatenate([ctx_lo, np.zeros((pad, rp), np.uint32)])
        cols = {
            c: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
            for c, v in cols.items()
        }

    wire = {
        "rows": rows,
        **cols,
        "node": node,
        "ctx_rows": ctx_rows,
        "ctx_lo": ctx_lo,
        "ctx_gid": ctx_gid,
    }
    if device is None:
        return RowSlice(**{c: wire[c] for c in RowSlice._fields}), offsets
    return slice_from_wire(wire, device), offsets


#: RowSlice fields padded along the writer-table (Rr) axis by
#: :func:`stack_entry_slices`'s ragged masking
_SLICE_CTX_FIELDS = ("ctx_rows", "ctx_lo")


def stack_entry_slices(slices: list, lanes: int | None = None, *, device) -> "tuple[RowSlice, int]":
    """``combine_entry_arrays`` generalised to a replica axis
    (``binned_map.py:338``): stack k per-replica combined slices (host
    numpy form, ``combine_entry_arrays(..., None)``) into one
    :class:`~delta_crdt_ex_tpu_torch.ops.binned.RowSlice` on ``device``
    with a leading replica axis, for ONE ``fleet_merge_rows`` call.

    Ragged fan-in is handled by per-replica masking, not truncation:

    - row counts pad to the stack's max row tier with ``-1`` rows (the
      merge's valid mask drops them);
    - writer-table widths pad to the max with zero gids (empty slots
      that claim nothing);
    - entry-lane tiers (``key.shape[1]``) must be EQUAL — padding them
      would change the row-compact sort width and with it dead-slot
      bytes; the fleet buckets unequal tiers apart instead.

    ``lanes`` pads the REPLICA axis with all-padding lanes (rows all
    ``-1``) that merge nothing; they copy lane 0's geometry. Returns
    ``(stacked slice, real_rows)``, ``real_rows`` counting the
    non-padding bucket rows of the real lanes (the ragged-mask fill
    ratio's numerator)."""
    n = len(slices)
    lanes = n if lanes is None else lanes
    s_widths = {s.key.shape[1] for s in slices}
    if len(s_widths) > 1:
        raise ValueError(f"unequal entry-lane tiers in one stack: {s_widths}")
    u_to = max(s.rows.shape[0] for s in slices)
    rp_to = max(s.ctx_gid.shape[0] for s in slices)
    real_rows = 0

    def pad(sl: RowSlice) -> dict:
        du = u_to - sl.rows.shape[0]
        drp = rp_to - sl.ctx_gid.shape[0]
        out = {}
        for c in RowSlice._fields:
            a = np.asarray(getattr(sl, c))
            if c == "rows":
                if du:
                    a = np.concatenate([a, np.full(du, -1, a.dtype)])
            elif c == "ctx_gid":
                if drp:
                    a = np.concatenate([a, np.zeros(drp, a.dtype)])
            else:
                if c in _SLICE_CTX_FIELDS and drp:
                    a = np.concatenate([a, np.zeros((a.shape[0], drp), a.dtype)], axis=1)
                if du:
                    a = np.concatenate([a, np.zeros((du,) + a.shape[1:], a.dtype)])
            out[c] = a
        return out

    padded = []
    for sl in slices:
        real_rows += int((np.asarray(sl.rows) >= 0).sum())
        padded.append(pad(sl))
    if lanes > n:
        blank = {c: np.zeros_like(a) for c, a in padded[0].items()}
        blank["rows"] = np.full(u_to, -1, np.int32)
        padded.extend([blank] * (lanes - n))
    stacked = slice_from_wire({c: np.stack([p[c] for p in padded]) for c in RowSlice._fields}, device)
    return stacked, real_rows


def grouped_merge(merge_rows_into_fn, state, arrays_list: list, on_grow=None):
    """Combine k compatible EntriesMsg bodies (:func:`combine_entry_arrays`)
    and join them with ONE ``merge_rows_into_fn`` call. Returns
    ``(new_state, result, offsets)``; a :class:`CtxGapError` carries
    ``gapped_members``, the members whose rows the kernel's per-row gap
    mask names, so the caller replays only those solo."""
    sl, offsets = combine_entry_arrays(arrays_list, state.device)
    try:
        new_state, res = merge_rows_into_fn(state, sl, on_grow=on_grow)
    except CtxGapError as err:
        if err.gap_rows is not None:
            err.gapped_members = {
                i for i, (lo, hi) in enumerate(offsets) if bool(err.gap_rows[lo:hi].any())
            }
        raise
    return new_state, res, offsets


def merge_group_into(state: BinnedStore, arrays_list: list, on_grow=None):
    """The grouped fan-in merge of the replica's ingress coalescing
    (``binned_map.py:417``): one row-granular :func:`merge_rows_into`
    dispatch for a whole group of disjoint-row slices."""
    return grouped_merge(merge_rows_into, state, arrays_list, on_grow=on_grow)


class BinnedAWLWWMap:
    """Model class: the AWLWWMap op vocabulary over :class:`BinnedStore`
    (``binned_map.py:470``) — the default ``crdt_module`` of the port's
    replica runtime."""

    #: mutation name → (op code, arity of user args)
    OPS = {
        "add": (OP_ADD, 2),  # add(key, value)    aw_lww_map.ex:99
        "remove": (OP_REMOVE, 1),  # remove(key)  aw_lww_map.ex:133
        "clear": (OP_CLEAR, 0),  # clear()        aw_lww_map.ex:148
    }

    Store = BinnedStore
    new = staticmethod(BinnedStore.new)
    group_batch = staticmethod(group_batch)
    row_apply = staticmethod(binned_ops.row_apply)
    clear_all = staticmethod(binned_ops.clear_all)
    merge_slice = staticmethod(binned_ops.merge_slice)
    merge_rows = staticmethod(binned_ops.merge_rows)
    extract_rows = staticmethod(binned_ops.extract_rows)
    extract_own_delta = staticmethod(binned_ops.extract_own_delta)
    winners_for_keys = staticmethod(binned_ops.winners_for_keys)
    winner_rows = staticmethod(binned_ops.winner_rows)
    winner_all = staticmethod(binned_ops.winner_all)
    compact_rows = staticmethod(binned_ops.compact_rows)
    tree_from_leaves = staticmethod(binned_ops.tree_from_leaves)
    merge_into = staticmethod(merge_into)
    merge_rows_into = staticmethod(merge_rows_into)
    merge_group_into = staticmethod(merge_group_into)
    combine_entry_arrays = staticmethod(combine_entry_arrays)
    RowSlice = RowSlice

    @staticmethod
    def read_view(d: dict):
        """The resolved winner dict in this model's read form (the map:
        identity; :class:`AWSet` overrides it)."""
        return d

    #: store backend tag (``api._resolve_store`` maps models across it)
    backend = "binned"
    #: static (non-tensor) Store fields — none for this backend
    STORE_META = ()
    #: snapshot columns to and from numpy in the JAX dtypes
    to_numpy = staticmethod(binned_store_to_numpy)
    from_numpy = staticmethod(binned_store_from_numpy)

    @staticmethod
    def grow_for_apply(state: BinnedStore) -> BinnedStore:
        """Local-mutation overflow escape: bin tier ×2."""
        return state.grow(bin_capacity=state.bin_capacity * 2)

    @staticmethod
    def post_apply(state: BinnedStore, res, on_grow=None) -> BinnedStore:
        """Post-commit hook (no load advisory for the binned store)."""
        return state

    @staticmethod
    def load_high(max_window_fill: int, probe_window: int) -> bool:
        """No growth advisory: bins grow through the per-merge
        ``need_fill_grow`` escape only."""
        return False

    @staticmethod
    def store_load_high(state: BinnedStore) -> bool:
        return False

    @staticmethod
    def geometry(state: BinnedStore) -> tuple:
        """Batch-compatibility key: the bin tier B splits fleet batches."""
        return ("binned", state.num_buckets, state.bin_capacity, state.replica_capacity)

    @staticmethod
    def geometry_stacked(stacked) -> tuple:
        """The same key read from a stacked store's shapes."""
        return ("binned", stacked.key.shape[1], stacked.key.shape[2], stacked.ctx_gid.shape[1])

    # the fleet seams (``binned_map.py:561-593``): one batched call
    # serves a whole bucket of members. The extractions return
    # ``(stacked_slice, s_tiers)``; ``s_tiers`` is None here — the
    # binned lane axis is state geometry, so lane k IS the solo slice

    @classmethod
    def fleet_merge_rows(cls, states, slices):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.fleet_merge_rows(states, slices)

    @classmethod
    def fleet_extract_rows(cls, states, rows):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.fleet_extract_rows(states, rows), None

    @classmethod
    def fleet_extract_own_delta(cls, states, rows, self_slots, gid_selfs, lo):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.fleet_interval_slices(states, rows, self_slots, gid_selfs, lo), None

    # the mesh seams (``binned_map.py:595-625``): the same batched forms
    # over a replica mesh, each shard running its own lane block on its
    # own device; lane k is the vmapped (and so the solo) call on lane
    # k's inputs, so the fleet's mesh mode swaps these in and keeps every
    # piece of bookkeeping

    @classmethod
    def mesh_fleet_merge_rows(cls, mesh, states, slices):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.mesh_fleet_merge_rows(mesh, states, slices)

    @classmethod
    def mesh_fleet_extract_rows(cls, mesh, states, rows):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.mesh_fleet_extract_rows(mesh, states, rows), None

    @classmethod
    def mesh_fleet_extract_own_delta(cls, mesh, states, rows, self_slots, gid_selfs, lo):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.mesh_fleet_interval_slices(mesh, states, rows, self_slots, gid_selfs, lo), None


class AWSet(BinnedAWLWWMap):
    """Add-wins observed-remove set over the same kernel table
    (``binned_map.py:627``): an element is a key whose stored value is
    ``True``; ``read`` returns the member set, diffs feed as
    ``("add", elem, True)`` / ``("remove", elem)``."""

    OPS = {
        "add": (OP_ADD, 1),  # add(elem)
        "remove": (OP_REMOVE, 1),  # remove(elem)
        "clear": (OP_CLEAR, 0),  # clear()
    }

    @staticmethod
    def read_view(d: dict):
        return set(d)
