"""Primitives the hash store shares with the bucket-binned engine — the
part of ``delta_crdt_ex_tpu/ops/binned.py`` this slice runs, as torch
ops: the mixers and the entry hash, the digest-tree fold, the wire
slice (:class:`RowSlice`), the interval/insert preamble every merge
shares (:func:`_slice_view`), and the LWW winner cores. The binned row
kernels (``row_apply``, ``merge_rows``, ``merge_slice``, …) wait for the
binned-store slice.

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

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import U32_MAX
from delta_crdt_ex_tpu_torch.ops.dots import MergedGids, merge_gid_tables

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
    ``[u32[1], u32[2], …, u32[L]]`` (``ops/binned.py:83``)."""
    levels = [leaf]
    while levels[-1].shape[0] > 1:
        cur = levels[-1].reshape(-1, 2)
        left = _mix32(cur[:, 0] ^ _P1)
        right = _mix32(cur[:, 1] ^ _P2)
        levels.append((left + (right << 1) + 0x9E3779B9) & M32)
    return levels[::-1]


def _table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a small 1-D table (``idx`` clipped to range).
    The JAX package unrolls this into selects for the TPU; a gather is
    the same function."""
    return table[idx.to(torch.int64)]


def _row_table_lookup(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tbl[u, idx[u, s]]`` (``idx`` clipped to ``[0, R)``)."""
    return torch.gather(tbl, 1, idx.to(torch.int64))


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


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    """Wire numpy → the port's torch layout (uint64 → int64 bits,
    uint32 → int64 values, int32 rows → int64)."""
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = np.ascontiguousarray(a).view(np.int64)
    elif a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def slice_from_wire(a: dict, device) -> RowSlice:
    """A RowSlice on ``device`` from an EntriesMsg column dict."""
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
    (``ops/binned.py:440``)."""

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


def _slice_view(state, sl: RowSlice) -> SliceView:
    """``ops/binned.py:462``: remote context rows re-expressed in local
    slots, the insert mask, and delta-interval gap detection."""
    L = state.num_buckets
    R = state.replica_capacity
    dev = sl.key.device

    valid = sl.rows >= 0
    rows_safe = torch.where(valid, sl.rows, L)
    rows_clip = rows_safe.clamp(0, L - 1)

    gids = merge_gid_tables(state.ctx_gid, sl.ctx_gid)

    # empty intervals (lo == hi) claim nothing: mask them out of BOTH
    # bounds, or an idle writer's row would read as a (0, hi] claim
    nonempty = sl.ctx_rows > sl.ctx_lo
    # dense forms as a one-hot max/min over the Rr axis (remap < 0
    # matches no column)
    oh = gids.remap[:, None] == torch.arange(R, device=dev)[None, :]
    sel3 = nonempty[:, :, None] & oh[None]  # [U, Rr, R]
    rdense = torch.where(sel3, sl.ctx_rows[:, :, None], 0).amax(dim=1)
    ldense = torch.where(sel3, sl.ctx_lo[:, :, None], U32_MAX).amin(dim=1)
    # interval lower bounds in local slots (0 where nothing shipped)
    ldense = torch.where(ldense == U32_MAX, 0, ldense)

    # insert pass (s2 ∖ c1)
    ln = _table_lookup(gids.remap, sl.node.clamp(0, sl.ctx_gid.shape[0] - 1))
    ln_clip = ln.clamp(0, R - 1)
    local_ctx = state.ctx_max[rows_clip]  # [U, R]
    covered_local = _row_table_lookup(local_ctx, ln_clip) >= sl.ctr
    ins = sl.alive & valid[:, None] & ~covered_local & (ln >= 0)
    # delta-interval contiguity: advancing ctx to hi is only sound if our
    # context already reaches lo
    gap_row = (valid[:, None] & (rdense > ldense) & (local_ctx < ldense)).any(dim=1)
    need_ctx_gap = gap_row.any()
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
    perm = torch.arange(key.shape[1], device=key.device).expand(key.shape).contiguous()
    for k in (c, _flip(g), t, _flip(key)):
        _, o = torch.sort(torch.gather(k, 1, perm), dim=1, stable=True)
        perm = torch.gather(perm, 1, o)
    key_s, t_s, g_s, c_s, alive_s, valh_s = (
        torch.gather(a, 1, perm) for a in (key, t, g, c, alive, valh)
    )
    run_last = torch.cat(
        [key_s[:, :-1] != key_s[:, 1:], torch.ones_like(key_s[:, :1], dtype=torch.bool)],
        dim=1,
    )
    return RowWinners(alive_s & run_last, key_s, g_s, c_s, valh_s, t_s)
