"""The packed entry layout — the PyTorch port of
``delta_crdt_ex_tpu/ops/packed.py``.

The column store (:class:`~delta_crdt_ex_tpu_torch.models.binned.BinnedStore`)
keeps seven entry columns, every uint32 one as int64, 45 bytes an
entry. :class:`PackedStore` fuses them into one word table
``int32[..., L, B, 8]`` of 32-bit bit patterns, 32 bytes an entry, in
the JAX package's plane order::

    [key_lo, key_hi, ts_lo, ts_hi, valh, ctr, ehash, meta]

with ``meta = node | alive << 16`` (writer slots are < 2^16: the R tiers
are small). A 64-bit column splits into its two words low word first,
as ``jax.lax.bitcast_convert_type`` does on a little-endian host; a
uint32 column keeps its low word. The aux tables (``fill``, ``amin``,
``amax``, ``leaf``, ``ctx_gid``, ``ctx_max``) keep the column store's
int64 convention, so :func:`~delta_crdt_ex_tpu_torch.ops.binned._slice_view_b`
and the shared merge math run on either layout.

Every ordered compare and every reduction over a plane widens it first
(``& M32`` on the int64 of the word): an int32 plane holds a uint32 with
bit 31 set as a negative number.

:func:`merge_slice_packed` is the column merge
(:func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_slice`) over this
layout: the seven per-column insert scatters become one scatter of
``[k, 8]`` word records, and the kill pass reads entry rows as word
planes and writes back only the ``meta`` plane. Its three modes are the
JAX package's: ``top_k`` insert compaction, ``scatter_compact`` (a
cumsum rank in place of the top-k), and ``fused_aux`` (one min-scatter
for amin/amax/ctx_max and one add-scatter for fill/leaf). Like every
store op of the port it takes a single state or a neighbour stack, and
never writes into its inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import U32_MAX, BinnedStore
from delta_crdt_ex_tpu_torch.ops.binned import (
    M32,
    MergeResult,
    RowSlice,
    _ext,
    _insert_aux,
    _insert_grid,
    _kill_apply,
    _kill_rows,
    _lane0,
    _lane_slice,
    _lanes,
    _slice_view_b,
    _unext,
    _with_lanes,
    compact_rows,
    entry_hash,
)
from delta_crdt_ex_tpu_torch.runtime import tracing

_LONG = torch.int64
_PLANES = 8
_META = 7
#: the JAX ``PackedStore`` fields and the numpy dtype the JAX package
#: holds each in
PACKED_COLUMNS = {
    "words": np.uint32,
    "fill": np.int32,
    "amin": np.uint32,
    "amax": np.uint32,
    "leaf": np.uint32,
    "ctx_gid": np.uint64,
    "ctx_max": np.uint32,
}


@dataclasses.dataclass(frozen=True)
class PackedStore:
    """``BinnedStore`` with the seven entry columns fused into one word
    table (``ops/packed.py:70``). Single or stacked: a neighbour stack
    has a leading lane axis on every field."""

    words: torch.Tensor  # int32[..., L, B, 8] (bit patterns)
    fill: torch.Tensor  # int32[..., L]
    amin: torch.Tensor  # int64[..., L, R] (uint32)
    amax: torch.Tensor  # int64[..., L, R] (uint32)
    leaf: torch.Tensor  # int64[..., L] (uint32)
    ctx_gid: torch.Tensor  # int64[..., R] (uint64 bits)
    ctx_max: torch.Tensor  # int64[..., L, R] (uint32)

    @property
    def num_buckets(self) -> int:
        return self.words.shape[-3]

    @property
    def bin_capacity(self) -> int:
        return self.words.shape[-2]

    @property
    def replica_capacity(self) -> int:
        return self.ctx_gid.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.words.device

    def grow(self, bin_capacity: int | None = None, replica_capacity: int | None = None) -> "PackedStore":
        """Pad to a larger tier (``ops/packed.py:95``) through the column
        layout, so :func:`~delta_crdt_ex_tpu_torch.models.binned_map.tier_retry_merge`
        escalates either layout by one policy."""
        return pack(unpack(self).grow(bin_capacity=bin_capacity, replica_capacity=replica_capacity))


def _words(x: torch.Tensor) -> torch.Tensor:
    """``int32[..., 2]``: the low and the high word of an int64."""
    return x.contiguous().unsqueeze(-1).view(torch.int32)


def _low(x: torch.Tensor) -> torch.Tensor:
    """``int32[..., 1]``: the low word of an int64 (a uint32 column's bits)."""
    return _words(x)[..., :1]


def _widen(plane: torch.Tensor) -> torch.Tensor:
    """A uint32 word plane as the port's int64 in ``[0, 2^32)``."""
    return plane.to(_LONG) & M32


def _i64(pair: torch.Tensor) -> torch.Tensor:
    """The int64 whose low and high words are ``pair[..., 0:2]``."""
    return pair.contiguous().view(_LONG).squeeze(-1)


def _meta(node: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    return node.to(torch.int32) | (alive.to(torch.int32) << 16)


def _records(key, ts, valh, ctr, ehash, meta) -> torch.Tensor:
    """``int32[..., 8]`` word records of entries given as the port's
    int64 columns (``meta`` already a word)."""
    return torch.cat([_words(key), _words(ts), _low(valh), _low(ctr), _low(ehash), meta.unsqueeze(-1)], -1)


def pack(state: BinnedStore) -> PackedStore:
    """Column → packed layout (``ops/packed.py:114``), at any rank: a
    neighbour stack packs in one call."""
    if state.replica_capacity >= 1 << 16:
        raise ValueError(f"the meta plane holds the writer slot in 16 bits; R = {state.replica_capacity}")
    words = _records(
        state.key, state.ts, state.valh, state.ctr, state.ehash, _meta(state.node, state.alive)
    )
    return PackedStore(
        words=words,
        fill=state.fill,
        amin=state.amin,
        amax=state.amax,
        leaf=state.leaf,
        ctx_gid=state.ctx_gid,
        ctx_max=state.ctx_max,
    )


def unpack(p: PackedStore) -> BinnedStore:
    """Packed → column layout (``ops/packed.py:143``), the bitwise
    inverse of :func:`pack`."""
    w = p.words
    meta = w[..., _META]
    return BinnedStore(
        key=_i64(w[..., 0:2]),
        valh=_widen(w[..., 4]),
        ts=_i64(w[..., 2:4]),
        node=meta & 0xFFFF,
        ctr=_widen(w[..., 5]),
        alive=(meta >> 16) != 0,
        ehash=_widen(w[..., 6]),
        fill=p.fill,
        amin=p.amin,
        amax=p.amax,
        leaf=p.leaf,
        ctx_gid=p.ctx_gid,
        ctx_max=p.ctx_max,
    )


def packed_from_numpy(cols: dict, device) -> PackedStore:
    """A port ``PackedStore`` from a JAX ``PackedStore``'s fields as
    numpy (``uint32`` words; single or stacked), bit for bit."""
    out = {}
    for name, want in PACKED_COLUMNS.items():
        a = np.asarray(cols[name])
        if a.dtype != want:
            raise TypeError(f"field {name!r}: expected {np.dtype(want)}, got {a.dtype}")
        if name == "words":
            a = np.ascontiguousarray(a).view(np.int32)
        elif want == np.uint64:
            a = np.ascontiguousarray(a).view(np.int64)
        elif want == np.uint32:
            a = a.astype(np.int64)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return PackedStore(**out)


def packed_to_numpy(p: PackedStore) -> dict:
    """The inverse of :func:`packed_from_numpy`: ``{field: numpy array}``
    in the JAX package's dtypes and field order."""
    out = {}
    for name, want in PACKED_COLUMNS.items():
        a = getattr(p, name).detach().cpu().numpy()
        if name == "words":
            out[name] = np.ascontiguousarray(a).view(np.uint32)
        elif want == np.uint64:
            out[name] = np.ascontiguousarray(a).view(np.uint64)
        else:
            out[name] = a.astype(want)
    return out


def compact_rows_packed(p: PackedStore) -> PackedStore:
    """:func:`~delta_crdt_ex_tpu_torch.ops.binned.compact_rows` over the
    packed layout (``ops/packed.py:211``): unpack, repack densely, pack."""
    return pack(compact_rows(unpack(p)))


def _merge_slice_packed_b(
    state: PackedStore,
    sl: RowSlice,
    shared: RowSlice | None,
    kill_budget: int,
    max_inserts: int | None,
    fused_aux: bool,
    scatter_compact: bool,
) -> MergeResult:
    n, L, B = state.words.shape[:3]
    R = state.replica_capacity
    u, s = sl.key.shape[-2:]
    rr = sl.ctx_gid.shape[-1]
    G = u * s
    dev = state.device
    lanes = _lanes(n, dev)
    LB = L * B

    # each step is a ``crdt.merge.<step>`` span while a profiler runs,
    # under the column merge's names
    span = tracing.annotate
    with span("crdt.merge.view"):
        v = _slice_view_b(state.ctx_gid, state.ctx_max, sl)
    with span("crdt.merge.insert_grid"):
        g = _insert_grid(state.fill, v, B)

    # --- insert pass (s2 ∖ c1): one scatter of word records at fill positions
    with span("crdt.merge.insert_select"):
        n_inserted = v.ins.sum((-2, -1))
        if max_inserts is None:
            need_ins_tier = torch.zeros(n, dtype=torch.bool, device=dev)
            flat_c = g.flat
            take = lambda a: a.reshape(n, G)
        elif scatter_compact and LB + G < 2**31:
            # top_k-free compaction (ops/packed.py:272): the r-th insert of
            # the grid in grid order by a cumsum rank. Per lane only the grid
            # index of each rank is scattered; the payload columns depend on
            # the slice alone, so they stack once a call ([G, 5], not once a
            # lane) and each lane gathers its k rows from them.
            k = min(max_inserts, G)
            ins_flat = g.flat < LB
            rank = torch.cumsum(ins_flat.to(_LONG), -1) - 1
            dest = torch.where(ins_flat & (rank < k), rank, k)  # k: the trash slot, cut off
            gsel = torch.zeros((n, k + 1), dtype=_LONG, device=dev)
            gsel.scatter_(1, dest, torch.arange(G, device=dev).expand(n, G))
            gsel = gsel[:, :k]
            src = shared if shared is not None else sl
            planes = torch.stack([src.key, src.valh, src.ts, src.ctr, src.node.clamp(0, rr - 1).to(_LONG)], -1)
            if shared is not None:
                pay = planes.reshape(G, 5)[gsel]  # [N, k, 5]
            else:
                pay = torch.gather(planes.reshape(n, G, 5), 1, gsel[..., None].expand(n, k, 5))
            kpos = torch.arange(k, device=dev)
            real_c = kpos < ins_flat.sum(-1, keepdim=True)
            flat_c = torch.where(real_c, torch.gather(g.flat, 1, gsel), LB + kpos)
            key_c, valh_c, ts_c, ctr_c, node_c = pay.unbind(-1)
            # ln is a lookup of node in the lane's remap table: recomputed on
            # the k compacted entries (the same values as compacting ln_clip)
            ln_c = torch.gather(v.gids.remap, 1, node_c).clamp(0, R - 1)
            need_ins_tier = n_inserted > k
            take = None
        else:
            # the k smallest flat indices in ascending order (jax.lax.top_k
            # of -flat; flat is duplicate-free)
            k = min(max_inserts, G)
            flat_c, sel = torch.topk(g.flat, k, dim=-1, largest=False, sorted=True)
            need_ins_tier = n_inserted > k
            take = lambda a: torch.gather(a.reshape(n, G), 1, sel)

        if take is not None:  # the scomp branch gathered its columns already
            key_c, valh_c, ts_c, ctr_c = take(sl.key), take(sl.valh), take(sl.ts), take(sl.ctr)
            ln_c, node_c = take(v.ln_clip), take(sl.node.clamp(0, rr - 1).to(_LONG))
        eh_c = entry_hash(key_c, torch.gather(sl.ctx_gid, -1, node_c), ctr_c, ts_c, valh_c)
        ins_c = flat_c < LB  # real inserts; padding indices drop
        rows_c = flat_c // B  # >= L (dropped) for padding
        idx = torch.where(ins_c, flat_c, LB)

    with span("crdt.merge.insert_scatter"):
        words_e = state.words.new_empty((n, LB + 1, _PLANES))
        words_e[:, :LB] = state.words.reshape(n, LB, _PLANES)
        vals8 = _records(key_c, ts_c, valh_c, ctr_c, eh_c, _meta(ln_c, ins_c))  # [N, k, 8]
        words_e.scatter_(1, idx[..., None].expand(*idx.shape, _PLANES), vals8)
        words2 = words_e[:, :LB].view(n, L, B, _PLANES)

    with span("crdt.merge.insert_aux"):
        if fused_aux:
            fill2, amin_e, amax_e, leaf_e, ctx2 = _fused_aux(state, sl, v, rows_c, ln_c, ctr_c, eh_c, ins_c)
        else:
            fill_e, amin_e, amax_e, leaf_e, ctx_e = _insert_aux(
                state, sl, v, g, rows_c, ln_c, ctr_c, eh_c, ins_c, max_inserts
            )
            fill2 = _unext(fill_e, state.fill.shape, contiguous=True)
            ctx2 = _unext(ctx_e, state.ctx_max.shape, contiguous=True)

    # --- kill pass ((s1∩s2) ∪ (s1∖c2)) on the flagged rows, read as word
    # planes; only the meta plane of a flagged row changes
    with span("crdt.merge.kill_rows"):
        kr = _kill_rows(state, v, kill_budget)
    with span("crdt.merge.kill_apply"):
        w_rows = words2[lanes, kr.k_rows_clip]  # [N, KB, B, 8]
        meta_rows = w_rows[..., _META]
        l_alive = ((meta_rows >> 16) != 0) & kr.k_valid[..., None]
        die, surv = _kill_apply(
            kr, sl, v, (meta_rows & 0xFFFF).to(_LONG), _widen(w_rows[..., 5]), l_alive, _widen(w_rows[..., 6]),
            leaf_e, amin_e, amax_e,
        )
        kidx = torch.where(kr.k_valid[..., None], kr.k_rows[..., None] * B + torch.arange(B, device=dev), LB)
        words_e[..., _META].scatter_(1, kidx.reshape(n, -1), _meta(meta_rows & 0xFFFF, surv).reshape(n, -1))

    with span("crdt.merge.assemble"):
        ok = ~(v.gids.overflow | kr.need_kill_tier | g.need_fill_compact | v.need_ctx_gap | need_ins_tier)
        small = lambda e, like: _unext(e, like.shape, contiguous=True)
        new_state = PackedStore(
            words=words2,
            fill=fill2,
            amin=small(amin_e, state.amin),
            amax=small(amax_e, state.amax),
            leaf=small(leaf_e, state.leaf) & M32,
            ctx_gid=v.gids.ctx_gid,
            ctx_max=ctx2,
        )
        n_killed = die.sum((-2, -1))
    return MergeResult(
        new_state, ok, v.gids.overflow, kr.need_kill_tier, g.need_fill_compact,
        v.need_ctx_gap, need_ins_tier, n_inserted, n_killed,
    )


def _fused_aux(state: PackedStore, sl: RowSlice, v, rows_c, ln_c, ctr_c, eh_c, ins_c):
    """The summary tables after the inserts in two scatters
    (``ops/packed.py:385``): amin (min), amax and ctx_max (max, as the
    min of the uint32 complement) in one ``[L, R, 3]`` min-scatter, fill
    and leaf in one ``[L, 2]`` add-scatter at the insert rows. Returns
    ``(fill, amin, amax, leaf, ctx_max)``, amin/amax/leaf as ``_ext``
    copies for the kill pass. Fill counts each insert that landed, not
    each row's insert count: the two differ only on a merge with
    ``ok=False``, whose state the tier ladder drops."""
    n, L, R = state.amin.shape
    rr = sl.ctx_gid.shape[-1]
    u = v.valid.shape[-1]
    dev = state.device
    T = torch.stack([state.amin, state.amax ^ M32, state.ctx_max ^ M32], -1)  # [N, L, R, 3]
    colr = torch.where(v.gids.remap >= 0, v.gids.remap, R)[:, None, :].expand(n, u, rr)
    r_idx = torch.cat([rows_c, v.rows_safe.repeat_interleave(rr, dim=1)], 1)
    c_idx = torch.cat([ln_c, colr.reshape(n, u * rr)], 1)
    ident_u = torch.full((n, u * rr), U32_MAX, dtype=_LONG, device=dev)
    ctx_vals = torch.where(v.nonempty, sl.ctx_rows ^ M32, U32_MAX).reshape(n, u * rr)
    vals3 = torch.cat([
        torch.stack([torch.where(ins_c, ctr_c, U32_MAX), torch.where(ins_c, ctr_c ^ M32, U32_MAX),
                     torch.full_like(ctr_c, U32_MAX)], -1),
        torch.stack([ident_u, ident_u, ctx_vals], -1),
    ], 1)  # [N, k + U·Rr, 3]
    keep = ((r_idx < L) & (c_idx < R))[..., None]
    tidx = torch.where(keep, (r_idx * R + c_idx)[..., None] * 3 + torch.arange(3, device=dev), L * R * 3)
    T_e = _ext(T)
    T_e.scatter_reduce_(1, tidx.reshape(n, -1), vals3.reshape(n, -1), "amin")
    T2 = _unext(T_e, T.shape)
    FL_e = _ext(torch.stack([state.leaf, state.fill.to(_LONG)], -1))
    fl_idx = torch.where((rows_c < L)[..., None], rows_c[..., None] * 2 + torch.arange(2, device=dev), 2 * L)
    FL_e.scatter_add_(1, fl_idx.reshape(n, -1),
                      torch.stack([torch.where(ins_c, eh_c, 0), ins_c.to(_LONG)], -1).reshape(n, -1))
    FL = _unext(FL_e, (n, L, 2))
    return (
        (FL[..., 1] & M32).to(torch.int32),
        _ext(T2[..., 0]),
        _ext(T2[..., 1] ^ M32),
        _ext(FL[..., 0]),
        (T2[..., 2] ^ M32).contiguous(),
    )


def merge_slice_packed(
    state: PackedStore,
    sl: RowSlice,
    kill_budget: int,
    max_inserts: int | None = None,
    fused_aux: bool = False,
    scatter_compact: bool = False,
    rows_sorted: bool = False,
) -> MergeResult:
    """:func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_slice` over the
    packed layout (``ops/packed.py:219``): the same insert, kill and
    context math, one ``[k, 8]`` record scatter for the inserts. Returns
    a ``MergeResult`` whose ``state`` is a :class:`PackedStore`.

    ``fused_aux`` folds the aux-table updates into two scatters;
    ``scatter_compact`` compacts the inserts by a cumsum rank instead of
    a top-k (both bit-identical to the plain mode on valid merges, as in
    the JAX package). ``rows_sorted`` is the JAX package's scatter hint
    (the slice's valid rows strictly ascend); torch takes no such hint,
    so the result is the same whichever way it is set.

    ``state`` is one store or a neighbour stack (one merge per lane,
    the slice shared). Never writes into its inputs."""
    del rows_sorted  # an XLA scatter hint; every torch scatter here is exact either way
    st, single = _with_lanes(state)
    n = st.words.shape[0]
    shared = sl if sl.key.dim() == 2 else None
    res = _merge_slice_packed_b(
        st, _lane_slice(sl, n), shared, kill_budget, max_inserts, fused_aux, scatter_compact
    )
    return _lane0(res) if single else res


def merge_slice_packed_fused(
    state: PackedStore, sl: RowSlice, kill_budget: int, max_inserts: int | None = None
) -> MergeResult:
    """:func:`merge_slice_packed` with ``fused_aux=True``
    (``ops/packed.py:164``)."""
    return merge_slice_packed(state, sl, kill_budget, max_inserts, fused_aux=True)


def merge_slice_packed_scomp(
    state: PackedStore,
    sl: RowSlice,
    kill_budget: int,
    max_inserts: int | None = None,
    rows_sorted: bool = False,
) -> MergeResult:
    """:func:`merge_slice_packed` with ``scatter_compact=True``
    (``ops/packed.py:184``)."""
    return merge_slice_packed(
        state, sl, kill_budget, max_inserts, scatter_compact=True, rows_sorted=rows_sorted
    )

