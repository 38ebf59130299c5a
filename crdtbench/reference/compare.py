"""The comparison that decides ``correct``: a lane read from the program
against a :class:`~crdtbench.reference.awlww.MapState`, in plain torch
on the lane's device (a 1M-entry lane sorts there in milliseconds).

A lane is handed over as its alive entries, its writer table with the
per-bucket context, and its leaf digests (the driver reads them out of
the program's stack). Entries are compared as a set, sorted by (key,
writer gid, counter) in unsigned order; the context as a per-bucket
column for every writer gid; the leaves row by row. Each comparison
counts what differs, and each count has the limit 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crdtbench.reference.awlww import MapState

SIGN = -(1 << 63)
M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Lane:
    """One replica as the program left it, in plain tensors."""

    key: torch.Tensor  # int64[n] (uint64 bits) of the alive entries
    gid: torch.Tensor  # int64[n] (uint64 bits)
    ctr: torch.Tensor  # int64[n]
    ts: torch.Tensor  # int64[n]
    valh: torch.Tensor  # int64[n]
    ctx_gid: torch.Tensor  # int64[R] (uint64 bits; 0 = free slot)
    ctx_max: torch.Tensor  # int64[L, R]
    leaf: torch.Tensor  # int64[L]


def _as_i64(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.astype(np.int64, copy=False)).to(device)


def _order(key, gid, ctr) -> torch.Tensor:
    """Permutation sorting by (key, gid) unsigned, then ctr."""
    perm = torch.sort(ctr, stable=True).indices
    for k in (gid ^ SIGN, key ^ SIGN):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


class Judge:
    """The reference's map on ``device``, sorted once, against which
    lanes are counted."""

    def __init__(self, want: MapState, device):
        cols = [_as_i64(getattr(want, c), device) for c in ("key", "gid", "ctr", "ts", "valh")]
        perm = _order(*cols[:3])
        self.want = [c[perm] for c in cols]
        self.ctx = {g: _as_i64(col, device) for g, col in want.ctx.items()}
        self.leaf = _as_i64(want.leaf, device)
        self.root = want.root

    def entries_off(self, lane: Lane) -> int:
        """Alive entries that differ: the count difference plus the
        positions of the sorted overlap where any field differs."""
        got = [lane.key, lane.gid, lane.ctr, lane.ts, lane.valh]
        perm = _order(*got[:3])
        got = [c[perm] for c in got]
        n = min(len(got[0]), len(self.want[0]))
        diff = torch.zeros(n, dtype=torch.bool, device=got[0].device)
        for a, b in zip(got, self.want):
            diff |= a[:n] != b[:n]
        return abs(len(got[0]) - len(self.want[0])) + int(diff.sum())

    def context_off(self, lane: Lane) -> int:
        """(bucket, writer) context cells that differ, over the reference's
        writers and any other writer the lane lists."""
        gids = lane.ctx_gid.tolist()
        off = 0
        for g, want in self.ctx.items():
            g64 = g - (1 << 64) if g >= 1 << 63 else g
            if g64 in gids:
                off += int((lane.ctx_max[:, gids.index(g64)] != want).sum())
            else:
                off += int((want != 0).sum())
        known = {g - (1 << 64) if g >= 1 << 63 else g for g in self.ctx}
        for s, g in enumerate(gids):
            if g not in known:
                off += int((lane.ctx_max[:, s] != 0).sum())
        return off

    def leaf_off(self, lane: Lane) -> int:
        return int(((lane.leaf & M32) != self.leaf).sum())
