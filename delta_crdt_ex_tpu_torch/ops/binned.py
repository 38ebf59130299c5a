"""Row-local ops over the bucket-binned dot store — the PyTorch port of
``delta_crdt_ex_tpu/ops/binned.py``, as torch ops:

- the primitives the hash store shares: the mixers and the entry hash,
  the digest-tree fold, the wire slice (:class:`RowSlice`), the
  interval/insert preamble every merge shares (:func:`_slice_view_b`),
  and the LWW winner cores;
- the bulk fan-in path's store ops: :func:`merge_slice` (the
  element-scatter merge, both its uncompacted and its ``top_k``
  compacted branch, built from the insert and kill steps it shares with
  the packed layout's merge in :mod:`delta_crdt_ex_tpu_torch.ops.packed`:
  :func:`_insert_grid`, :func:`_insert_aux`, :func:`_kill_rows`,
  :func:`_kill_apply`), :func:`merge_rows` and :func:`extract_rows` (the
  row-granular pair ring gossip and the replica's ingress use),
  :func:`compact_rows`, :func:`init_from_columns` and
  :func:`flagged_first_order`;
- the binned replica's local-mutation and read ops: :func:`row_apply`,
  :func:`clear_all`, :func:`extract_own_delta` (the eager delta push),
  :func:`winners_for_keys`, :func:`winner_all` and :func:`winner_rows`.

The neighbour axis. The JAX package batches neighbours and fleet
members with ``jax.vmap``; here every op it vmaps (the merges,
:func:`extract_rows`, :func:`row_apply`, :func:`extract_own_delta`,
:func:`winner_all`, :func:`compact_rows`, :func:`clear_all`) takes a
:class:`BinnedStore` whose columns have a leading lane axis
(``[N, L, B]``) as well as a single state, with per-lane arguments
(``[N, ...]``) or, for a merge, a slice shared by every lane
(``[U, S]``). A single state runs as one lane, so a lane of a stacked
call and a solo call are the same arithmetic. The point reads
(:func:`winners_for_keys`, :func:`winner_rows`) take one state.

No op writes into its inputs. A merge that reports ``ok=False`` is
re-run by the host on the pre-merge state (``tier_retry_merge``), so
each scatter goes into a fresh copy: one extra element per lane takes
the writes that the JAX package drops (``mode="drop"``) and is cut off.
The one exception is :func:`merge_commit`, the column fan-in's merge
attempt (the hand-written kernel of
:mod:`~delta_crdt_ex_tpu_torch.ops.merge_kernel` on the card, through
the graphed entry of :mod:`~delta_crdt_ex_tpu_torch.parallel.merge_graph`):
it writes the merged rows into the store it is given, and only where
every lane merged, so the retry still finds the pre-merge state; copying
the whole store for a delta of a few rows is the cost it exists to
remove.
Scatters with repeated indices write one value, or reduce with an
order-free reduction (``amin``, ``amax``, integer ``scatter_add_``), so
no result depends on the order CUDA applies them in.

Integer layout. This torch build has no shift, add, compare, max or
scatter on ``uint32``/``uint64``, so the port holds

- every uint64 quantity (key hashes, writer gids) as the int64 with the
  same bits: XOR, AND, OR, left shift and wrapping multiply keep the
  bits, a logical right shift is :func:`_srl`, and an unsigned order is
  the signed order after :func:`_flip` (sign bit flipped);
- every uint32 quantity (counters, value hashes, entry hashes, leaf
  digests, arrival stamps) as an int64 in ``[0, 2^32)``, masked with
  :data:`M32` after each wrapping add or multiply.
"""

from __future__ import annotations

from typing import NamedTuple

import dataclasses

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, U32_MAX, BinnedStore
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_REMOVE
from delta_crdt_ex_tpu_torch.ops.dots import MergedGids, encode_dot, merge_gid_tables
from delta_crdt_ex_tpu_torch.ops.merge_kernel import merge_slice_kernel
from delta_crdt_ex_tpu_torch.runtime import tracing
from delta_crdt_ex_tpu_torch.utils.transfers import device_layout

_LONG = torch.int64
M32 = 0xFFFFFFFF
#: int64 with only the sign bit set: ``x ^ SIGN`` maps the unsigned
#: order of a uint64 bit pattern onto the signed order
SIGN = -(1 << 63)
I64_MAX = (1 << 63) - 1


def _i64(c: int) -> int:
    """The int64 holding the bits of the uint64 constant ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)
_P1 = 0x85EBCA6B
_P2 = 0xC2B2AE35


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a uint64 bit pattern held in int64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _flip(x: torch.Tensor) -> torch.Tensor:
    """Unsigned-order key of a uint64 bit pattern held in int64."""
    return x ^ SIGN


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finaliser over uint32 values held in int64 (< 2^32, so an
    arithmetic right shift is the logical one)."""
    x = ((x ^ (x >> 16)) * _P1) & M32
    x = ((x ^ (x >> 13)) * _P2) & M32
    return x ^ (x >> 16)


def entry_hash(key, gid, ctr, ts, valh) -> torch.Tensor:
    """uint32 content hash of an entry (``ops/binned.py:70``): covers
    the writer's GLOBAL id, so it is replica-independent."""
    h = _mix64(key ^ _mix64(gid ^ ctr) ^ _mix64(ts ^ (valh << 32)))
    return (h ^ _srl(h, 32)) & M32


def tree_from_leaves(leaf: torch.Tensor) -> list[torch.Tensor]:
    """Digest-tree levels from the maintained leaf digests, root first:
    ``[u32[1], u32[2], …, u32[L]]`` (``ops/binned.py:83``); leading axes
    are batch axes (one tree per row of an ``[N, L]`` leaf stack)."""
    levels = [leaf]
    while levels[-1].shape[-1] > 1:
        cur = levels[-1].reshape(*leaf.shape[:-1], -1, 2)
        left = _mix32(cur[..., 0] ^ _P1)
        right = _mix32(cur[..., 1] ^ _P2)
        levels.append((left + (right << 1) + 0x9E3779B9) & M32)
    return levels[::-1]


def _table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a small 1-D table (``idx`` clipped to range).
    The JAX package unrolls this into selects for the TPU; a gather is
    the same function."""
    return table[idx.to(torch.int64)]


def _row_table_lookup(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(tbl, idx, axis=-1)`` for a small trailing axis
    (``ops/binned.py:115``; ``idx`` clipped to range): the same gather
    the JAX package unrolls into selects."""
    return torch.gather(tbl, -1, idx.to(torch.int64))


# ---------------------------------------------------------------------------
# the wire slice


class RowSlice(NamedTuple):
    """Wire format of the sync data plane (``ops/binned.py:358``): rows
    of the sender's store plus the per-(bucket, writer) context interval
    ``(ctx_lo, ctx_rows]`` they claim. Torch layout: see the module
    docstring; ``rows`` and ``node`` are int64 and int32 indices."""

    rows: torch.Tensor  # int64[U] bucket indices (-1 = padding)
    key: torch.Tensor  # int64[U, S] (uint64 bits)
    valh: torch.Tensor  # int64[U, S] (uint32)
    ts: torch.Tensor  # int64[U, S]
    node: torch.Tensor  # int32[U, S] (sender-local slots)
    ctr: torch.Tensor  # int64[U, S] (uint32)
    alive: torch.Tensor  # bool[U, S]
    ctx_rows: torch.Tensor  # int64[U, Rr] (uint32) interval upper bounds
    ctx_lo: torch.Tensor  # int64[U, Rr] (uint32) interval lower bounds
    ctx_gid: torch.Tensor  # int64[Rr] (uint64 bits)


#: wire dtype of each RowSlice column (the JAX package's numpy dtypes —
#: the EntriesMsg body is byte-identical across the two packages)
WIRE_DTYPES = {
    "rows": np.int32,
    "key": np.uint64,
    "valh": np.uint32,
    "ts": np.int64,
    "node": np.int32,
    "ctr": np.uint32,
    "alive": np.bool_,
    "ctx_rows": np.uint32,
    "ctx_lo": np.uint32,
    "ctx_gid": np.uint64,
}


def _to_torch(a, device) -> torch.Tensor:
    """Wire numpy → the port's torch layout (uint64 → int64 bits,
    uint32 → int64 values, int32 rows → int64). A tensor column (a
    device-plane body) is in that layout already and only moves."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return device_layout(a).to(device)


def slice_from_wire(a: dict, device) -> RowSlice:
    """A RowSlice on ``device`` from an EntriesMsg column dict (numpy
    wire columns, or a device-plane body's tensors)."""
    rows = _to_torch(np.asarray(a["rows"], np.int64), device)
    cols = {c: _to_torch(a[c], device) for c in RowSlice._fields if c != "rows"}
    return RowSlice(rows=rows, **cols)


def wire_from_host(host: dict) -> dict:
    """EntriesMsg column dict (wire dtypes) from host copies of torch
    columns (``TransferSite.get`` output)."""
    out = {}
    for c, v in host.items():
        want = WIRE_DTYPES[c]
        v = np.asarray(v)
        if want == np.uint64:
            out[c] = np.ascontiguousarray(v).view(np.uint64)
        else:
            out[c] = v.astype(want)
    return out


class SliceView(NamedTuple):
    """The interval/insert preamble shared by every merge kernel
    (``ops/binned.py:440``). Shapes of one lane; the lane-batched form
    has a leading ``N`` on every field."""

    valid: torch.Tensor  # bool[U]
    rows_safe: torch.Tensor  # int64[U] (L where padding — scatters drop)
    rows_clip: torch.Tensor  # int64[U]
    gids: MergedGids
    rdense: torch.Tensor  # int64[U, R] interval upper bounds, local slots
    ldense: torch.Tensor  # int64[U, R] interval lower bounds, local slots
    ln: torch.Tensor  # int64[U, S] remapped writer slots (-1 unknown)
    ln_clip: torch.Tensor  # int64[U, S]
    local_ctx: torch.Tensor  # int64[U, R]
    ins: torch.Tensor  # bool[U, S]: slice entries to insert (s2 ∖ c1)
    need_ctx_gap: torch.Tensor  # bool
    gap_row: torch.Tensor  # bool[U]
    nonempty: torch.Tensor  # bool[U, Rr]


# ---------------------------------------------------------------------------
# the lane axis


def _lanes(n: int, device) -> torch.Tensor:
    """int64[N, 1] lane index, for ``col[lanes, rows]`` row gathers."""
    return torch.arange(n, device=device)[:, None]


def _lane_slice(sl: RowSlice, n: int) -> RowSlice:
    """``sl`` with a leading lane axis: a shared slice is broadcast (a
    view), a per-lane slice (``key`` is ``[N, U, S]``) passes."""
    if sl.key.dim() == 3:
        return sl
    return RowSlice(*(c.expand(n, *c.shape) for c in sl))


def _map_store(fn, state):
    """The store (binned or hash) with ``fn`` applied to every tensor
    column; static fields (the hash store's probe window) pass."""
    return dataclasses.replace(
        state,
        **{
            f.name: fn(getattr(state, f.name))
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)
        },
    )


def _with_lanes(state):
    """``(state with a lane axis, whether one was added)``, for either
    store: a stacked store's writer table is ``[N, R]``."""
    if state.ctx_gid.dim() == 2:
        return state, False
    return _map_store(lambda t: t.unsqueeze(0), state), True


def _lane0(x):
    """Lane 0 of a lane-batched result (a store, a NamedTuple of
    tensors and stores, or a tensor)."""
    if dataclasses.is_dataclass(x):
        return _map_store(lambda t: t[0], x)
    if isinstance(x, tuple):
        return type(x)(*(_lane0(f) for f in x))
    return x[0]


def _ext(col: torch.Tensor) -> torch.Tensor:
    """``[N, numel + 1]`` copy of a lane-batched column: lane n's
    elements flattened, then one sentinel element that takes the writes
    the JAX package drops (``mode="drop"``)."""
    n = col.shape[0]
    m = col[0].numel()
    out = col.new_empty((n, m + 1))
    out[:, :m] = col.reshape(n, m)
    return out


def _unext(ext: torch.Tensor, shape, contiguous: bool = False) -> torch.Tensor:
    """The column back from :func:`_ext`, sentinel cut off (a view,
    unless ``contiguous``)."""
    cut = ext[:, :-1]
    return cut.contiguous().view(shape) if contiguous else cut.view(shape)


def _set_rows(
    col: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, contiguous: bool = False
) -> torch.Tensor:
    """``col.at[rows].set(vals, mode="drop")`` per lane, out of place:
    ``col`` is ``[N, L, ...]``, ``rows`` ``[N, U]`` (``L`` drops),
    ``vals`` ``[N, U, ...]``."""
    n, L = col.shape[:2]
    w = col[0, 0].numel()
    e = _ext(col)
    idx = torch.where(
        (rows < L)[..., None], rows[..., None] * w + torch.arange(w, device=col.device), L * w
    )
    e.scatter_(1, idx.reshape(n, -1), vals.reshape(n, -1).to(col.dtype))
    return _unext(e, col.shape, contiguous)


def _exact(col: torch.Tensor) -> torch.Tensor:
    """An exact-size copy of a column :func:`_set_rows` returned as a
    view of its one-element-longer buffer. For the 1 MiB ``alive``
    column of a 2^20-slot store the longer buffer lands in the caching
    allocator's large-block pool, where a block a few hundred KiB too
    big is handed out whole; the exact copy lives in the small-block
    pool, so a store generation's device bytes do not depend on the
    allocator's history."""
    return col.clone()


def _slice_view_b(ctx_gid: torch.Tensor, ctx_max: torch.Tensor, sl: RowSlice) -> SliceView:
    """:class:`SliceView` of every lane (``ops/binned.py:462``): remote
    context rows re-expressed in local slots, the insert mask, and
    delta-interval gap detection. ``ctx_gid`` is ``[N, R]``, ``ctx_max``
    ``[N, L, R]`` and ``sl`` lane-batched (:func:`_lane_slice`)."""
    n, L, R = ctx_max.shape
    dev = ctx_max.device
    u = sl.node.shape[-2]
    rr = sl.ctx_gid.shape[-1]

    valid = sl.rows >= 0
    rows_safe = torch.where(valid, sl.rows, L)
    rows_clip = rows_safe.clamp(0, L - 1)

    gids = merge_gid_tables(ctx_gid, sl.ctx_gid)

    # empty intervals (lo == hi) claim nothing: mask them out of BOTH
    # bounds, or an idle writer's row would read as a (0, hi] claim
    nonempty = sl.ctx_rows > sl.ctx_lo
    # dense forms as a one-hot max/min over the Rr axis (remap < 0
    # matches no column)
    oh = gids.remap[..., :, None] == torch.arange(R, device=dev)
    sel3 = nonempty[..., :, :, None] & oh[:, None]  # [N, U, Rr, R]
    rdense = torch.where(sel3, sl.ctx_rows[..., None], 0).amax(dim=-2)
    ldense = torch.where(sel3, sl.ctx_lo[..., None], U32_MAX).amin(dim=-2)
    # interval lower bounds in local slots (0 where nothing shipped)
    ldense = torch.where(ldense == U32_MAX, 0, ldense)

    # insert pass (s2 ∖ c1)
    remap_u = gids.remap[:, None, :].expand(n, u, rr)
    ln = torch.gather(remap_u, -1, sl.node.clamp(0, rr - 1).to(_LONG))
    ln_clip = ln.clamp(0, R - 1)
    local_ctx = ctx_max[_lanes(n, dev), rows_clip]  # [N, U, R]
    covered_local = _row_table_lookup(local_ctx, ln_clip) >= sl.ctr
    ins = sl.alive & valid[..., None] & ~covered_local & (ln >= 0)
    # delta-interval contiguity: advancing ctx to hi is only sound if our
    # context already reaches lo
    gap_row = (valid[..., None] & (rdense > ldense) & (local_ctx < ldense)).any(dim=-1)
    need_ctx_gap = gap_row.any(dim=-1)
    return SliceView(
        valid, rows_safe, rows_clip, gids, rdense, ldense, ln, ln_clip,
        local_ctx, ins, need_ctx_gap, gap_row, nonempty,
    )


# ---------------------------------------------------------------------------
# reads


class KeyWinners(NamedTuple):
    found: torch.Tensor  # bool[K]
    gid: torch.Tensor  # int64[K] (uint64 bits) winner's writer gid
    ctr: torch.Tensor  # int64[K] (uint32)
    valh: torch.Tensor  # int64[K] (uint32)
    ts: torch.Tensor  # int64[K]


def _lww_rank(ts, gid, ctr, alive):
    """Lexicographic (ts, gid, ctr) LWW order as a sortable tuple; dead
    entries rank below everything (``ops/binned.py:913``)."""
    return (
        torch.where(alive, ts, -(2**62)),
        torch.where(alive, gid, 0),
        torch.where(alive, ctr, 0),
    )


def _argmax_lww(ts, gid, ctr, alive) -> torch.Tensor:
    """int64[..., 1] index of the lexicographic (ts, gid unsigned, ctr)
    maximum along the last axis; the first such index on a full tie
    (``ops/binned.py:924``)."""
    t, g, c = _lww_rank(ts, gid, ctr, alive)
    m1 = t == t.amax(dim=-1, keepdim=True)
    g1 = torch.where(m1, _flip(g), SIGN)  # unsigned max; SIGN = flip(0)
    m2 = m1 & (g1 == g1.amax(dim=-1, keepdim=True))
    c1 = torch.where(m2, c, 0)
    m3 = m2 & (c1 == c1.amax(dim=-1, keepdim=True))
    return m3.to(torch.int32).argmax(dim=-1, keepdim=True)


class RowWinners(NamedTuple):
    win: torch.Tensor  # bool[U, B]: entry is its key's LWW winner
    key: torch.Tensor  # int64[U, B] (uint64 bits)
    gid: torch.Tensor  # int64[U, B] (uint64 bits)
    ctr: torch.Tensor  # int64[U, B]
    valh: torch.Tensor  # int64[U, B]
    ts: torch.Tensor  # int64[U, B]


def _sorted_winners(key, ts, gid, ctr, alive, valh) -> RowWinners:
    """Shared winner core (``ops/binned.py:968``): one lexicographic
    sort per row by (key unsigned, ts, gid unsigned, ctr); a winner is
    the last entry of its key-run. Torch has no multi-key sort, so the
    order is built from stable sorts, least significant key first."""
    t, g, c = _lww_rank(ts, gid, ctr, alive)
    perm = torch.arange(key.shape[-1], device=key.device).expand(key.shape).contiguous()
    for k in (c, _flip(g), t, _flip(key)):
        _, o = torch.sort(torch.gather(k, -1, perm), dim=-1, stable=True)
        perm = torch.gather(perm, -1, o)
    key_s, t_s, g_s, c_s, alive_s, valh_s = (
        torch.gather(a, -1, perm) for a in (key, t, g, c, alive, valh)
    )
    run_last = torch.cat(
        [key_s[..., :-1] != key_s[..., 1:], torch.ones_like(key_s[..., :1], dtype=torch.bool)],
        dim=-1,
    )
    return RowWinners(alive_s & run_last, key_s, g_s, c_s, valh_s, t_s)


def winners_for_keys(state: BinnedStore, khash: torch.Tensor) -> KeyWinners:
    """LWW winner per queried key hash (``ops/binned.py:937``;
    ``AWLWWMap.read/2``, ``aw_lww_map.ex:218-224``): each key's bucket
    row, its alive same-key entries, their lexicographic (ts, gid, ctr)
    maximum. ``khash`` is int64[K] (uint64 bits); a missing key reads
    ``found=False`` with the row's slot 0 in the other fields."""
    rows = state.bucket_of(khash)
    g_ts = state.ts[rows]
    g_key = state.key[rows]
    g_alive = state.alive[rows] & (g_key == khash[:, None])
    g_gid = _table_lookup(state.ctx_gid, state.node[rows].clamp(0, state.replica_capacity - 1))
    g_ctr = state.ctr[rows]
    best = _argmax_lww(g_ts, g_gid, g_ctr, g_alive)
    take = lambda a: torch.gather(a, 1, best)[:, 0]
    return KeyWinners(
        found=take(g_alive),
        gid=take(g_gid),
        ctr=take(g_ctr),
        valh=take(state.valh[rows]),
        ts=take(g_ts),
    )


def winner_all(state: BinnedStore) -> RowWinners:
    """Whole-table LWW winners (``ops/binned.py:983``): the full-map
    read path sorts every row of the table at once, no row gather.
    Single or stacked; callers select by ``win``, never by position."""
    gid = dataclasses.replace(state, node=state.node.clamp(0, state.replica_capacity - 1)).entry_gid()
    return _sorted_winners(state.key, state.ts, gid, state.ctr, state.alive, state.valh)


def winner_rows(state: BinnedStore, rows: torch.Tensor) -> RowWinners:
    """Per-key LWW winners within the given bucket rows
    (``ops/binned.py:997``; -1 pads): :func:`_sorted_winners` over the
    gathered rows. An entry wins iff no other alive same-key entry of
    its row ranks higher (keys never span rows). Callers select by
    ``win``, never by position."""
    valid = rows >= 0
    rows_clip = rows.clamp(0, state.num_buckets - 1)
    take = lambda c: getattr(state, c)[rows_clip]
    gid = _table_lookup(state.ctx_gid, take("node").clamp(0, state.replica_capacity - 1))
    return _sorted_winners(
        take("key"), take("ts"), gid, take("ctr"), take("alive") & valid[:, None], take("valh")
    )


# ---------------------------------------------------------------------------
# store maintenance


def flagged_first_order(flags: torch.Tensor, budget: int) -> torch.Tensor:
    """int64[..., min(budget, n)]: the first ``budget`` flagged positions
    along the last axis in ascending order, unfilled slots holding a
    guaranteed-UNFLAGGED index (``ops/binned.py:128``). The filler is
    ``argmin(flags)``, the first unflagged index: a filler that aliased a
    flagged row would enter the kill pass unmasked and subtract that
    row's digest twice. Flagged positions past the budget all land in
    the trash slot ``kb``, which is cut off."""
    n = flags.shape[-1]
    kb = min(budget, n)
    rank = torch.cumsum(flags.to(_LONG), -1) - 1
    dest = torch.where(flags, rank.clamp(max=kb), kb)
    filler = flags.to(torch.int32).argmin(dim=-1, keepdim=True)
    out = filler.expand(*flags.shape[:-1], kb + 1).clone()
    out.scatter_(-1, dest, torch.arange(n, device=flags.device).expand(flags.shape))
    return out[..., :kb]


def _row_reduce(node, vals, r: int, init: int, how: str) -> torch.Tensor:
    """``full([..., U, r], init).at[u, node].<how>(vals)`` (node out of
    ``[0, r)`` drops)."""
    idx = node.to(_LONG)
    idx = torch.where((idx >= 0) & (idx < r), idx, r)
    out = torch.full((*node.shape[:-1], r + 1), init, dtype=_LONG, device=node.device)
    out.scatter_reduce_(-1, idx, vals, how)
    return out[..., :r].contiguous()


def _row_amin(node, ctr, alive, r: int) -> torch.Tensor:
    """int64[..., U, R] min alive counter per (row, writer slot);
    U32_MAX if none (``ops/binned.py:160``)."""
    return _row_reduce(node, torch.where(alive, ctr, U32_MAX), r, U32_MAX, "amin")


def _row_amax(node, ctr, alive, r: int) -> torch.Tensor:
    """int64[..., U, R] max alive counter per (row, writer slot); 0 if
    none (``ops/binned.py:170``)."""
    return _row_reduce(node, torch.where(alive, ctr, 0), r, 0, "amax")


def _row_compact(cols: dict, alive: torch.Tensor):
    """Stable-pack alive entries to the front of each row
    (``ops/binned.py:180``); returns (packed cols, packed alive, fill
    per row). The sort key is uint8: CUDA sorts no bool."""
    order = torch.sort((~alive).to(torch.uint8), dim=-1, stable=True).indices
    packed = {c: torch.gather(v, -1, order) for c, v in cols.items()}
    alive_p = torch.gather(alive, -1, order)
    return packed, alive_p, alive_p.sum(-1, dtype=torch.int32)


_ROW_COLS = ("key", "valh", "ts", "node", "ctr", "ehash")


def _gather_rows(state: BinnedStore, lanes: torch.Tensor, rows_clip: torch.Tensor) -> dict:
    """The entry columns of the given rows of every lane
    (``ops/binned.py:193``): ``[N, U, B]`` from ``rows_clip`` ``[N, U]``."""
    return {c: getattr(state, c)[lanes, rows_clip] for c in _ROW_COLS}


def _lane_args(state, *args):
    """``(state with a lane axis, whether one was added, args)``: each
    argument gains the same leading lane axis as the state (a Python
    int or 0-d tensor is broadcast to one value per lane)."""
    st, single = _with_lanes(state)
    n = st.key.shape[0]
    out = []
    for a in args:
        t = torch.as_tensor(a, device=st.device)
        if t.dim() == 0:
            t = t.to(_LONG).expand(n)
        elif single:
            t = t.unsqueeze(0)
        out.append(t)
    return st, single, out


def _leaf_sum(alive: torch.Tensor, ehash: torch.Tensor) -> torch.Tensor:
    """Wrapping uint32 sum of the alive entry hashes of each row."""
    return torch.where(alive, ehash, 0).sum(-1) & M32


def compact_rows(state: BinnedStore) -> BinnedStore:
    """Full repack (``ops/binned.py:1037``): reclaim holes left by merge
    kills and rebuild every maintained invariant, single or stacked."""
    R = state.replica_capacity
    packed, alive_p, fill = _row_compact({c: getattr(state, c) for c in _ROW_COLS}, state.alive)
    return BinnedStore(
        **packed,
        alive=alive_p,
        fill=fill,
        amin=_row_amin(packed["node"], packed["ctr"], alive_p, R),
        amax=_row_amax(packed["node"], packed["ctr"], alive_p, R),
        leaf=_leaf_sum(alive_p, packed["ehash"]),
        ctx_gid=state.ctx_gid,
        ctx_max=state.ctx_max,
    )


def init_from_columns(state: BinnedStore) -> BinnedStore:
    """Rebuild ``ehash`` from the entry columns, then every maintained
    invariant (``ops/binned.py:1025``): for host-built states whose host
    filled key/valh/ts/node/ctr/alive and the context tables."""
    node_c = state.node.clamp(0, state.replica_capacity - 1)
    gid = dataclasses.replace(state, node=node_c).entry_gid()
    ehash = entry_hash(state.key, gid, state.ctr, state.ts, state.valh)
    return compact_rows(dataclasses.replace(state, ehash=ehash))


# ---------------------------------------------------------------------------
# local mutation batch


class RowApplyResult(NamedTuple):
    """``ops/binned.py:201``; each field has a leading lane axis for a
    stacked state."""

    state: BinnedStore
    ok: torch.Tensor  # bool: every touched row had bin space
    ctr_assigned: torch.Tensor  # int64[U, M] (uint32) dot counter per add op
    n_keys_changed: torch.Tensor  # int64 (telemetry keys_updated_count)
    row_killed: torch.Tensor  # bool[U]: row lost a pre-batch entry


def _row_apply_b(state: BinnedStore, self_slot, rows, op, key, valh, ts) -> RowApplyResult:
    n, L, B = state.key.shape
    R = state.replica_capacity
    m = op.shape[-1]
    dev = state.device
    lanes = _lanes(n, dev)
    ss = self_slot[:, None]  # [N, 1]

    valid = rows >= 0
    rows_safe = torch.where(valid, rows, L)  # L: gathers clip, scatters drop
    rows_clip = rows_safe.clamp(0, L - 1)
    g = _gather_rows(state, lanes, rows_clip)
    galive = state.alive[lanes, rows_clip] & valid[..., None]

    is_add = (op == OP_ADD) & valid[..., None]
    is_touch = is_add | ((op == OP_REMOVE) & valid[..., None])
    touch_j = is_touch[..., None, :]  # [N, U, 1, M]: the touching op m'

    # fresh dot counters: one contiguous sequence per (replica, bucket),
    # wrapping in uint32
    base = state.ctx_max[lanes, rows_clip, ss]  # [N, U] own max per bucket
    ctr_assigned = (base[..., None] + torch.cumsum(is_add.to(_LONG), -1)) & M32

    # batch-internal shadowing: a later same-key touch kills op (u, m)
    later = torch.ones((m, m), dtype=torch.bool, device=dev).triu(1)
    key_eq = key[..., :, None] == key[..., None, :]  # [N, U, M, M]
    ins = is_add & ~(key_eq & later & touch_j).any(-1)

    # pre-batch kills: every alive entry whose key any batch op touches
    hit = ((g["key"][..., :, None] == key[..., None, :]) & touch_j).any(-1)  # [N, U, B]
    killed = galive & hit
    alive1 = galive & ~hit

    # insert into the lowest free slots of each row: slot_of_rank[r] is
    # the r-th free slot (B past the last; column B takes the writes of
    # occupied slots and is cut off)
    free = ~alive1
    free_rank = torch.cumsum(free.to(_LONG), -1) - 1
    slot_of_rank = torch.full((*free.shape[:-1], B + 1), B, dtype=_LONG, device=dev)
    slot_of_rank.scatter_(-1, torch.where(free, free_rank, B), torch.arange(B, device=dev).expand(free.shape))
    ins_rank = torch.cumsum(ins.to(_LONG), -1) - 1
    ok = (ins.sum(-1) <= free.sum(-1)).all(-1)
    tgt_b = torch.where(ins, torch.gather(slot_of_rank, -1, ins_rank.clamp(0, B - 1)), B)

    gid_self = torch.gather(state.ctx_gid, -1, ss)[..., None]  # [N, 1, 1]
    eh = entry_hash(key, gid_self, ctr_assigned, ts, valh)
    node_new = ss[..., None].expand(op.shape)

    def put(col, vals):
        # col.at[u, tgt_b].set(vals, mode="drop") on gathered rows
        e = torch.cat([col, col[..., :1]], -1)
        e.scatter_(-1, tgt_b, vals.to(col.dtype).expand(tgt_b.shape))
        return e[..., :B]

    cols = {
        "key": put(g["key"], key),
        "valh": put(g["valh"], valh),
        "ts": put(g["ts"], ts),
        "node": put(g["node"], node_new),
        "ctr": put(g["ctr"], ctr_assigned),
        "ehash": put(g["ehash"], eh),
    }
    alive2 = put(alive1, torch.ones((), dtype=torch.bool, device=dev))

    # repack rows (free in-row compaction: rows are rewritten anyway)
    packed, alive_p, fill_rows = _row_compact(cols, alive2)
    own_max = torch.where(ins, ctr_assigned, 0).amax(-1)  # [N, U]
    ctx_e = _ext(state.ctx_max)
    ctx_e.scatter_reduce_(1, torch.where(rows_safe < L, rows_safe * R + ss, L * R), own_max, "amax")

    rs = rows_safe
    new_state = BinnedStore(
        **{c: _set_rows(getattr(state, c), rs, packed[c]) for c in _ROW_COLS},
        alive=_exact(_set_rows(state.alive, rs, alive_p)),
        fill=_set_rows(state.fill, rs, fill_rows, True),
        amin=_set_rows(state.amin, rs, _row_amin(packed["node"], packed["ctr"], alive_p, R), True),
        amax=_set_rows(state.amax, rs, _row_amax(packed["node"], packed["ctr"], alive_p, R), True),
        leaf=_set_rows(state.leaf, rs, _leaf_sum(alive_p, packed["ehash"]), True),
        ctx_gid=state.ctx_gid,
        ctx_max=_unext(ctx_e, state.ctx_max.shape, contiguous=True),
    )

    # telemetry: distinct keys whose dot store changed (first-occurrence
    # op marks; key sets of distinct rows are disjoint)
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    first_occ = ~(key_eq & earlier & touch_j).any(-1)
    killed_any = ((key[..., :, None] == g["key"][..., None, :]) & galive[..., None, :]).any(-1)
    changed = is_touch & first_occ & (ins | killed_any)
    return RowApplyResult(new_state, ok, ctr_assigned, changed.sum((-2, -1)), killed.any(-1))


def row_apply(state: BinnedStore, self_slot, rows, op, key, valh, ts) -> RowApplyResult:
    """Apply a bucket-grouped local mutation batch with sequential
    semantics (``ops/binned.py:210``): within a row a later op shadows
    earlier same-key ops, every pre-batch same-key entry dies (a local
    op observes all local dots), adds take the row's lowest free slots
    with fresh per-(writer, bucket) counters, and touched rows are
    repacked. ``ok=False`` means a row ran out of bin space: the host
    grows the bin tier and re-runs on the same state. ``clear`` is
    :func:`clear_all`.

    ``rows`` is int64[U] (-1 pads), ``op`` int32[U, M] (``OP_PAD``
    pads), ``key``/``valh``/``ts`` int64[U, M]; for a stacked state each
    gains a leading lane axis and ``self_slot`` is one slot per lane.
    Never writes into its inputs."""
    st, single, (slots, rows, op, key, valh, ts) = _lane_args(
        state, self_slot, rows, op, key, valh, ts
    )
    res = _row_apply_b(st, slots.to(_LONG), rows.to(_LONG), op, key, valh, ts)
    return _lane0(res) if single else res


def clear_all(state: BinnedStore) -> BinnedStore:
    """Kill every observed dot (``ops/binned.py:333``; ``AWLWWMap.clear``,
    ``aw_lww_map.ex:148-150``): entries die, the context stays, so the
    clear propagates as coverage and unobserved remote dots survive.
    Single or stacked."""
    return dataclasses.replace(
        state,
        alive=torch.zeros_like(state.alive),
        fill=torch.zeros_like(state.fill),
        amin=torch.full_like(state.amin, U32_MAX),
        amax=torch.zeros_like(state.amax),
        leaf=torch.zeros_like(state.leaf),
    )


# ---------------------------------------------------------------------------
# the row-granular pair: extraction and merge


def extract_rows(state: BinnedStore, rows: torch.Tensor) -> RowSlice:
    """The slice of a set of bucket rows (``ops/binned.py:383``; -1
    pads). For a stacked state the slice has one lane per state, over
    rows shared by every lane (``[U]``) or one row set per lane
    (``[N, U]``, the fleet's batched extraction)."""
    L = state.num_buckets
    valid = rows >= 0
    rows_clip = rows.clamp(0, L - 1)
    if rows.dim() == 2:
        lanes = _lanes(rows.shape[0], rows.device)
        take = lambda c: getattr(state, c)[lanes, rows_clip]
    else:
        take = lambda c: getattr(state, c)[..., rows_clip, :]
    ctx_rows = take("ctx_max") * valid[..., None]
    return RowSlice(
        rows=rows.expand(*state.key.shape[:-2], rows.shape[-1]),
        key=take("key"),
        valh=take("valh"),
        ts=take("ts"),
        node=take("node"),
        ctr=take("ctr"),
        alive=take("alive") & valid[..., None],
        ctx_rows=ctx_rows,
        ctx_lo=torch.zeros_like(ctx_rows),
        ctx_gid=state.ctx_gid,
    )


def _extract_own_delta_b(state: BinnedStore, rows, self_slot, gid_self, lo) -> RowSlice:
    n, L, _ = state.key.shape
    lanes = _lanes(n, state.device)
    ss = self_slot[:, None]
    valid = rows >= 0
    rows_clip = rows.clamp(0, L - 1)
    g = _gather_rows(state, lanes, rows_clip)
    alive = (
        state.alive[lanes, rows_clip]
        & valid[..., None]
        & (g["node"] == ss[..., None])
        & (g["ctr"] > lo[..., None])
    )
    hi = state.ctx_max[lanes, rows_clip, ss] * valid
    return RowSlice(
        rows=rows,
        key=g["key"],
        valh=g["valh"],
        ts=g["ts"],
        node=torch.zeros_like(g["node"]),
        ctr=g["ctr"],
        alive=alive,
        ctx_rows=hi[..., None],
        ctx_lo=(lo * valid)[..., None],
        ctx_gid=gid_self[:, None],
    )


def extract_own_delta(state: BinnedStore, rows, self_slot, gid_self, lo) -> RowSlice:
    """An OWN-writer delta-interval slice (``ops/binned.py:404``): this
    replica's alive entries of each row with counter in ``(lo, ctx_max]``,
    claiming exactly that interval (Almeida et al.'s delta mode, the
    eager push). Minted-but-superseded counters inside the interval read
    as observed removes. The writer table is ``[gid_self]`` and the
    shipped node column is 0.

    ``rows`` int64[U] (-1 pads), ``self_slot`` and ``gid_self`` (int64
    bits) scalars, ``lo`` int64[U] (uint32); for a stacked state one of
    each per lane."""
    st, single, (slots, gids, rows, lo) = _lane_args(state, self_slot, gid_self, rows, lo)
    res = _extract_own_delta_b(st, rows.to(_LONG), slots.to(_LONG), gids, lo)
    return _lane0(res) if single else res


class MergeRowsResult(NamedTuple):
    """``ops/binned.py:770``; each field has a leading lane axis for a
    stacked state."""

    state: BinnedStore
    ok: torch.Tensor  # bool: result valid
    need_gid_grow: torch.Tensor  # bool: unknown writer gids overflowed R
    need_fill_grow: torch.Tensor  # bool: survivors + inserts exceed B
    need_ctx_gap: torch.Tensor  # bool: delta-interval not contiguous
    n_inserted: torch.Tensor  # int64
    n_killed: torch.Tensor  # int64
    n_ins_row: torch.Tensor  # int64[U]
    n_kill_row: torch.Tensor  # int64[U]
    gap_row: torch.Tensor  # bool[U]


def _merge_rows_packed(state: BinnedStore, sl: RowSlice, v: SliceView, lanes: torch.Tensor):
    """The row-local part of :func:`_merge_rows_b`: ``(packed cols,
    packed alive, alive per row, kills per row)``, each B wide. Its
    transients (the gathered rows, the ``[U, B, B]`` presence test, the
    2B-wide pack) die with this frame, before the new generation's
    columns are allocated: while three generations of a store are live,
    a merge holds only its B-wide rows, whatever the slice's size."""
    n, _L, B = state.key.shape
    u = sl.key.shape[-2]
    rr = sl.ctx_gid.shape[-1]
    g = _gather_rows(state, lanes, v.rows_clip)  # [N, U, B]
    galive = state.alive[lanes, v.rows_clip] & v.valid[..., None]
    gnode = g["node"].to(_LONG)

    # kill pass ((s1∩s2) ∪ (s1∖c2)) on every row: a local dot dies iff
    # the interval covers it and the slice does not carry it. Presence
    # compares packed dots: node << 32 | ctr is equal exactly when both
    # parts are, and -1 (no slice entry) matches no local dot
    covered = (_row_table_lookup(v.rdense, gnode) >= g["ctr"]) & (
        _row_table_lookup(v.ldense, gnode) < g["ctr"]
    )
    r_ok = sl.alive & (v.ln >= 0)
    r_dot = torch.where(r_ok, encode_dot(v.ln_clip, sl.ctr), -1)
    present = (encode_dot(gnode, g["ctr"])[..., :, None] == r_dot[..., None, :]).any(-1)
    die = galive & covered & ~present
    alive_surv = galive & ~die

    # pack survivors + inserts into the row's B slots (one stable sort,
    # holes reclaimed as a side effect)
    gid_ins = torch.gather(
        sl.ctx_gid[:, None, :].expand(n, u, rr), -1, sl.node.clamp(0, rr - 1).to(_LONG)
    )
    eh_ins = entry_hash(sl.key, gid_ins, sl.ctr, sl.ts, sl.valh)
    ins_cols = {
        "key": sl.key, "valh": sl.valh, "ts": sl.ts,
        "node": v.ln_clip.to(torch.int32), "ctr": sl.ctr, "ehash": eh_ins,
    }
    wide = {c: torch.cat([g[c], ins_cols[c]], dim=-1) for c in _ROW_COLS}
    packed_w, alive_w, n_alive_row = _row_compact(wide, torch.cat([alive_surv, v.ins], dim=-1))
    packed = {c: x[..., :B].contiguous() for c, x in packed_w.items()}
    return packed, alive_w[..., :B].contiguous(), n_alive_row, die.sum(-1)


def _merge_rows_b(state: BinnedStore, sl: RowSlice) -> MergeRowsResult:
    n, L, B = state.key.shape
    R = state.replica_capacity
    lanes = _lanes(n, state.device)

    v = _slice_view_b(state.ctx_gid, state.ctx_max, sl)
    packed, alive_p, n_alive_row, n_kill_row = _merge_rows_packed(state, sl, v, lanes)
    need_fill_grow = (v.valid & (n_alive_row > B)).any(-1)

    rs = v.rows_safe
    new_state = BinnedStore(
        **{c: _set_rows(getattr(state, c), rs, packed[c]) for c in _ROW_COLS},
        alive=_exact(_set_rows(state.alive, rs, alive_p)),
        fill=_set_rows(state.fill, rs, n_alive_row.clamp(max=B), True),
        amin=_set_rows(state.amin, rs, _row_amin(packed["node"], packed["ctr"], alive_p, R), True),
        amax=_set_rows(state.amax, rs, _row_amax(packed["node"], packed["ctr"], alive_p, R), True),
        leaf=_set_rows(state.leaf, rs, _leaf_sum(alive_p, packed["ehash"]), True),
        ctx_gid=v.gids.ctx_gid,
        ctx_max=_set_rows(state.ctx_max, rs, torch.maximum(v.local_ctx, v.rdense), True),
    )
    ok = ~(v.gids.overflow | need_fill_grow | v.need_ctx_gap)
    n_ins_row = v.ins.sum(-1)
    return MergeRowsResult(
        new_state, ok, v.gids.overflow, need_fill_grow, v.need_ctx_gap,
        n_ins_row.sum(-1), n_kill_row.sum(-1), n_ins_row, n_kill_row, v.gap_row,
    )


def merge_rows(state: BinnedStore, sl: RowSlice) -> MergeRowsResult:
    """Row-granular anti-entropy merge (``ops/binned.py:793``): gather
    the slice's rows whole, kill, insert and repack each row with dense
    row-local math, write the rows back. The join of the reference
    (``aw_lww_map.ex:153-209``): insert s2 ∖ c1, kill s1 dots covered by
    the remote interval and absent from s2, context union =
    per-(bucket, writer) max, delta-interval contiguity enforced.

    ``state`` is one store or a stack; a stack takes a shared slice or
    one slice per lane (``ring_gossip_round``). Never writes into its
    inputs."""
    st, single = _with_lanes(state)
    res = _merge_rows_b(st, _lane_slice(sl, st.key.shape[0]))
    return _lane0(res) if single else res


# ---------------------------------------------------------------------------
# the element-scatter merge (bulk fan-in)


class MergeResult(NamedTuple):
    """``ops/binned.py:526``; each field has a leading lane axis for a
    stacked state."""

    state: BinnedStore
    ok: torch.Tensor  # bool: result valid (budgets sufficed)
    need_gid_grow: torch.Tensor  # bool: unknown writer gids overflowed R
    need_kill_tier: torch.Tensor  # bool: flagged rows exceeded the kill budget
    need_fill_compact: torch.Tensor  # bool: some row ran out of bin space
    need_ctx_gap: torch.Tensor  # bool: delta-interval not contiguous
    need_ins_tier: torch.Tensor  # bool: inserts exceeded the max_inserts tier
    n_inserted: torch.Tensor  # int64
    n_killed: torch.Tensor  # int64


class InsertGrid(NamedTuple):
    """Where each slice entry of every lane goes (``ops/binned.py:577``):
    the insert preamble both entry layouts share."""

    n_ins_row: torch.Tensor  # int64[N, U]
    need_fill_compact: torch.Tensor  # bool[N]
    real: torch.Tensor  # bool[N, U, S]: inserted at a slot below B
    flat: torch.Tensor  # int64[N, U·S] flat slot, or L·B + grid position


def _insert_grid(fill: torch.Tensor, v: SliceView, B: int) -> InsertGrid:
    """Each insert's target slot is its row's ``fill`` plus its rank in
    the row. Overflowing rows (pos >= B) must not clip into valid slots;
    padding positions are distinct out-of-range values (L·B + grid
    position), so a compacted order has no ties."""
    n, L = fill.shape
    u, s = v.ins.shape[-2:]
    ins_rank = torch.cumsum(v.ins.to(_LONG), -1) - 1
    n_ins_row = v.ins.sum(-1)
    fill_rows = fill[_lanes(n, fill.device), v.rows_clip].to(_LONG)
    need_fill_compact = (v.valid & (fill_rows + n_ins_row > B)).any(-1)
    pos = fill_rows[..., None] + ins_rank  # [N, U, S] target bin slot
    real = v.ins & (pos < B)
    pad_idx = L * B + torch.arange(u * s, device=fill.device).reshape(u, s)
    flat = torch.where(real, v.rows_clip[..., None] * B + pos.clamp(0, B - 1), pad_idx)
    return InsertGrid(n_ins_row, need_fill_compact, real, flat.reshape(n, u * s))


def _insert_aux(state, sl: RowSlice, v: SliceView, g: InsertGrid, rows_c, ln_c, ctr_c, eh_c, ins_c, max_inserts):
    """The summary tables after the inserts, as ``_ext`` copies
    ``(fill, amin, amax, leaf, ctx_max)``: fill counts, min/max alive
    counter per (row, writer slot), the leaf digests as int64 sums
    masked once at the end (the kill pass adds its negated dead hashes
    first), and the context union, one order-free scatter for all the
    slice's writer columns."""
    n, L, R = state.amin.shape
    rows_safe = v.rows_safe
    fill_e = _ext(state.fill)
    fill_e.scatter_add_(1, rows_safe, g.n_ins_row.to(torch.int32))
    ridx = torch.where(rows_c < L, rows_c * R + ln_c, L * R)
    amin_e = _ext(state.amin)
    amin_e.scatter_reduce_(1, ridx, torch.where(ins_c, ctr_c, U32_MAX), "amin")
    amax_e = _ext(state.amax)
    amax_e.scatter_reduce_(1, ridx, torch.where(ins_c, ctr_c, 0), "amax")
    leaf_e = _ext(state.leaf)
    if max_inserts is None:
        leaf_add = torch.where(g.real, eh_c.reshape(g.real.shape), 0).sum(-1)
        leaf_e.scatter_add_(1, rows_safe, leaf_add)
    else:
        leaf_e.scatter_add_(1, torch.where(rows_c < L, rows_c, L), torch.where(ins_c, eh_c, 0))
    colr = torch.where(v.gids.remap >= 0, v.gids.remap, R)[:, None, :]  # [N, 1, Rr]
    cidx = torch.where((rows_safe[..., None] < L) & (colr < R), rows_safe[..., None] * R + colr, L * R)
    ctx_e = _ext(state.ctx_max)
    ctx_e.scatter_reduce_(
        1, cidx.reshape(n, -1), torch.where(v.nonempty, sl.ctx_rows, 0).reshape(n, -1), "amax"
    )
    return fill_e, amin_e, amax_e, leaf_e, ctx_e


class KillRows(NamedTuple):
    """The rows the kill pass visits (``ops/binned.py:684``)."""

    need_kill_tier: torch.Tensor  # bool[N]
    order: torch.Tensor  # int64[N, KB] slice rows, flagged first
    k_valid: torch.Tensor  # bool[N, KB]
    k_rows: torch.Tensor  # int64[N, KB] bucket rows (L where not flagged)
    k_rows_clip: torch.Tensor  # int64[N, KB]


def _kill_rows(state, v: SliceView, kill_budget: int) -> KillRows:
    """The kill pass is pruned by amin/amax: the interval (lo, hi] can
    only kill a local dot if it overlaps the [amin, amax] alive-counter
    span of some (bucket, writer), on the PRE-merge state."""
    n, L, _ = state.amin.shape
    lanes = _lanes(n, state.amin.device)
    amin_rows = state.amin[lanes, v.rows_clip]
    amax_rows = state.amax[lanes, v.rows_clip]
    flagged = v.valid & ((v.rdense >= amin_rows) & (v.ldense < amax_rows)).any(-1)
    order = flagged_first_order(flagged, kill_budget)  # [N, KB]
    k_valid = torch.gather(flagged, 1, order)
    k_rows = torch.where(k_valid, torch.gather(v.rows_clip, 1, order), L)
    return KillRows(flagged.sum(-1) > kill_budget, order, k_valid, k_rows, k_rows.clamp(0, L - 1))


def _kill_apply(kr: KillRows, sl: RowSlice, v: SliceView, l_node, l_ctr, l_alive, l_ehash, leaf_e, amin_e, amax_e):
    """Kill ((s1∩s2) ∪ (s1∖c2)) the local dots of the flagged rows, read
    through the post-insert table (inserted entries carry fresh remote
    dots present in the slice, so they survive their own coverage
    test): a dot dies iff the interval covers it and the slice does not
    carry it. Subtracts the dead hashes from the leaf digests and resets
    the rows' amin/amax (in place on the ``_ext`` copies); returns
    ``(die, surv)``."""
    n, kb = kr.order.shape
    R = v.rdense.shape[-1]
    L = (amin_e.shape[1] - 1) // R
    lanes = _lanes(n, l_node.device)
    k_rdense = v.rdense[lanes, kr.order]  # [N, KB, R]
    k_ldense = v.ldense[lanes, kr.order]
    covered = (torch.gather(k_rdense, -1, l_node) >= l_ctr) & (torch.gather(k_ldense, -1, l_node) < l_ctr)
    r_alive = sl.alive[lanes, kr.order] & kr.k_valid[..., None]
    r_dot = torch.where(r_alive, encode_dot(v.ln_clip[lanes, kr.order], sl.ctr[lanes, kr.order]), 0)
    present = (encode_dot(l_node, l_ctr)[..., :, None] == r_dot[..., None, :]).any(-1)
    die = l_alive & covered & ~present
    surv = l_alive & ~die
    leaf_e.scatter_add_(1, torch.where(kr.k_valid, kr.k_rows, L), -torch.where(die, l_ehash, 0).sum(-1))
    kidx = torch.where(
        kr.k_valid[..., None], kr.k_rows[..., None] * R + torch.arange(R, device=l_node.device), L * R
    ).reshape(n, -1)
    amin_e.scatter_(1, kidx, _row_amin(l_node, l_ctr, surv, R).reshape(n, -1))
    amax_e.scatter_(1, kidx, _row_amax(l_node, l_ctr, surv, R).reshape(n, -1))
    return die, surv


def _merge_slice_b(
    state: BinnedStore, sl: RowSlice, kill_budget: int, max_inserts: int | None
) -> MergeResult:
    n, L, B = state.key.shape
    u, s = sl.key.shape[-2:]
    rr = sl.ctx_gid.shape[-1]
    dev = state.device
    lanes = _lanes(n, dev)
    LB = L * B

    # each step is a ``crdt.merge.<step>`` span while a profiler runs
    span = tracing.annotate
    with span("crdt.merge.view"):
        v = _slice_view_b(state.ctx_gid, state.ctx_max, sl)
    with span("crdt.merge.insert_grid"):
        g = _insert_grid(state.fill, v, B)

    # --- insert pass (s2 ∖ c1): element scatters at fill positions
    with span("crdt.merge.insert_select"):
        n_inserted = v.ins.sum((-2, -1))
        if max_inserts is None:
            need_ins_tier = torch.zeros(n, dtype=torch.bool, device=dev)
            flat_c = g.flat
            take = lambda a: a.reshape(n, u * s)
        else:
            # the k smallest flat indices in ascending order: the real insert
            # positions first, padding last (jax.lax.top_k of -flat; flat is
            # duplicate-free, so the positions are JAX's)
            k = min(max_inserts, u * s)
            flat_c, sel = torch.topk(g.flat, k, dim=-1, largest=False, sorted=True)
            need_ins_tier = n_inserted > k
            take = lambda a: torch.gather(a.reshape(n, u * s), 1, sel)

        key_c, valh_c, ts_c, ctr_c = take(sl.key), take(sl.valh), take(sl.ts), take(sl.ctr)
        ln_c = take(v.ln_clip)
        node_c = take(sl.node.clamp(0, rr - 1).to(_LONG))
        eh_c = entry_hash(key_c, torch.gather(sl.ctx_gid, -1, node_c), ctr_c, ts_c, valh_c)
        ins_c = flat_c < LB  # real inserts; padding indices drop
        rows_c = flat_c // B  # >= L (dropped) for padding
        idx = torch.where(ins_c, flat_c, LB)

    def put(col, vals):
        e = _ext(col)
        e.scatter_(1, idx, vals.to(col.dtype))
        return e

    with span("crdt.merge.insert_scatter"):
        key_e, valh_e, ts_e = put(state.key, key_c), put(state.valh, valh_c), put(state.ts, ts_c)
        node_e, ctr_e, ehash_e = put(state.node, ln_c), put(state.ctr, ctr_c), put(state.ehash, eh_c)
        alive_e = put(state.alive, ins_c)
    with span("crdt.merge.insert_aux"):
        fill_e, amin_e, amax_e, leaf_e, ctx_e = _insert_aux(
            state, sl, v, g, rows_c, ln_c, ctr_c, eh_c, ins_c, max_inserts
        )

    # --- kill pass ((s1∩s2) ∪ (s1∖c2)) on the flagged rows
    with span("crdt.merge.kill_rows"):
        kr = _kill_rows(state, v, kill_budget)
    shape = state.key.shape
    with span("crdt.merge.kill_apply"):
        node2, ctr2 = _unext(node_e, shape), _unext(ctr_e, shape)
        l_node = node2[lanes, kr.k_rows_clip].to(_LONG)  # [N, KB, B]
        l_ctr = ctr2[lanes, kr.k_rows_clip]
        l_alive = _unext(alive_e, shape)[lanes, kr.k_rows_clip] & kr.k_valid[..., None]
        l_ehash = _unext(ehash_e, shape)[lanes, kr.k_rows_clip]
        die, surv = _kill_apply(kr, sl, v, l_node, l_ctr, l_alive, l_ehash, leaf_e, amin_e, amax_e)
        kidx = torch.where(kr.k_valid[..., None], kr.k_rows[..., None] * B + torch.arange(B, device=dev), LB)
        alive_e.scatter_(1, kidx.reshape(n, -1), surv.reshape(n, -1))

    with span("crdt.merge.assemble"):
        ok = ~(v.gids.overflow | kr.need_kill_tier | g.need_fill_compact | v.need_ctx_gap | need_ins_tier)
        small = lambda e, like: _unext(e, like.shape, contiguous=True)
        new_state = BinnedStore(
            key=_unext(key_e, shape),
            valh=_unext(valh_e, shape),
            ts=_unext(ts_e, shape),
            node=node2,
            ctr=ctr2,
            alive=_unext(alive_e, shape),
            ehash=_unext(ehash_e, shape),
            fill=small(fill_e, state.fill),
            amin=small(amin_e, state.amin),
            amax=small(amax_e, state.amax),
            leaf=small(leaf_e, state.leaf) & M32,
            ctx_gid=v.gids.ctx_gid,
            ctx_max=small(ctx_e, state.ctx_max),
        )
        n_killed = die.sum((-2, -1))
    return MergeResult(
        new_state, ok, v.gids.overflow, kr.need_kill_tier, g.need_fill_compact,
        v.need_ctx_gap, need_ins_tier, n_inserted, n_killed,
    )


def merge_slice(
    state: BinnedStore,
    sl: RowSlice,
    kill_budget: int,
    max_inserts: int | None = None,
) -> MergeResult:
    """Join a received bucket slice into the state (``ops/binned.py:540``)
    — O(slice) plus O(kill_budget · B) for the pruned kill pass:

    - insert remote entries not covered by the local context (s2 ∖ c1)
      at each row's ``fill`` position;
    - kill local entries covered by the remote context interval and
      absent from the remote entries, in at most ``kill_budget`` rows
      that the ``amin``/``amax`` test flags (else ``need_kill_tier``);
    - context union (per-replica max), valid because the interval is
      verified contiguous with the local context (``need_ctx_gap``).

    ``max_inserts`` (a tier) compacts the insert scatter to the
    ``max_inserts`` smallest insert positions (``need_ins_tier`` if more
    are needed); ``None`` scatters the whole slice grid.

    ``state`` is one store or a neighbour stack (one merge per lane, the
    slice shared, ``fanout_merge``). Never writes into its inputs, so a
    failed merge can be re-run on the same state.

    On a CUDA store the merge is the hand-written kernel
    (:func:`merge_commit` with ``per_lane``, ``csrc/merge.cu``)
    committing each lane into a copy of the store: a
    lane that is ok is this plain op's lane bit for bit, ``n_killed``
    included; a lane that is not ok comes back as the unchanged copy
    (the plain op's partial state there is never read). Flags and
    ``n_inserted`` are equal on every lane. Slice rows name distinct
    buckets, except padding."""
    st, single = _with_lanes(state)
    if st.device.type == "cuda":
        x = _map_store(torch.clone, st)
        flags, counts = result_buffers(st.key.shape[0], st.device)
        sl = RowSlice(*(t.contiguous() for t in sl))
        merge_commit(x, sl, kill_budget, max_inserts, flags, counts, per_lane=True)
        res = MergeResult(x, *flags.unbind(0), *counts.unbind(0))
    else:
        res = _merge_slice_b(st, _lane_slice(sl, st.key.shape[0]), kill_budget, max_inserts)
    return _lane0(res) if single else res


#: the boolean fields of a :class:`MergeResult` (the flags buffer's rows
#: in :func:`merge_commit`) and its two counts (the counts buffer's)
FLAGS, COUNTS = MergeResult._fields[1:-2], MergeResult._fields[-2:]


def result_buffers(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(flags, counts)`` for merges into an ``n``-lane store: bool
    ``[6, n]`` and int64 ``[2, n]``, zeroed."""
    flags = torch.zeros((len(FLAGS), n), dtype=torch.bool, device=device)
    counts = torch.zeros((len(COUNTS), n), dtype=torch.int64, device=device)
    return flags, counts


def merge_commit_ref(
    x: BinnedStore, sl: RowSlice, kill_budget: int, max_inserts: int | None, flags, counts, per_lane: bool = False
) -> None:
    """Plain torch version of :func:`merge_commit`: ``sl`` merged into
    ``x`` by :func:`_merge_slice_b`, the merged columns written over
    ``x`` where ``ok`` holds (every lane's, or each lane's own with
    ``per_lane``), ``x`` left as it was elsewhere."""
    res = _merge_slice_b(x, _lane_slice(sl, x.key.shape[0]), kill_budget, max_inserts)
    ok = res.ok if per_lane else res.ok.all().expand(res.ok.shape)
    for c in COLUMNS:
        col = getattr(x, c)
        torch.where(ok.reshape(-1, *(1,) * (col.dim() - 1)), getattr(res.state, c), col, out=col)
    torch.stack([getattr(res, f) for f in FLAGS], out=flags)
    torch.stack([getattr(res, f) for f in COUNTS], out=counts)


def merge_commit(
    x: BinnedStore, sl: RowSlice, kill_budget: int, max_inserts: int | None, flags, counts, per_lane: bool = False
) -> None:
    """One merge attempt of ``sl`` into the lane-batched store ``x``,
    committed in place where every lane is ok (each ok lane on its own
    with ``per_lane``): the per-lane :data:`FLAGS` into ``flags`` (bool
    ``[6, N]``), ``n_inserted`` and ``n_killed`` into ``counts`` (int64
    ``[2, N]``; from :func:`result_buffers`). The hand-written kernel
    for a CUDA store (it launches or raises), :func:`merge_commit_ref`
    for a CPU store. ``sl`` is shared by every lane (``[U, S]``) or has
    a lane axis. No host sync. The store and ``n_killed`` are the plain
    op's where ok holds, flags and ``n_inserted`` everywhere."""
    if x.device.type == "cpu":
        merge_commit_ref(x, sl, kill_budget, max_inserts, flags, counts, per_lane)
    else:
        merge_slice_kernel(x, sl, kill_budget, max_inserts, flags, counts, per_lane)
