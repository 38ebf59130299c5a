"""The plain reference: the add-wins observed-remove LWW map that the
generated inputs must produce, worked out in numpy from the inputs
alone (the base writer's rules, the deltas and the order in which the
benchmark handed them over). It imports nothing of the
program.

A map is its alive entries (key, writer gid, counter, timestamp, value
hash), its causal context (per bucket and writer, the highest counter
seen) and the digests of :mod:`crdtbench.reference.digest`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from crdtbench.reference import digest


@dataclasses.dataclass
class MapState:
    key: np.ndarray  # uint64[n]
    gid: np.ndarray  # uint64[n]
    ctr: np.ndarray  # uint64[n]
    ts: np.ndarray  # int64[n]
    valh: np.ndarray  # uint64[n]
    ctx: dict  # writer gid -> int64[L] highest counter per bucket
    leaf: np.ndarray  # uint64[L]

    @property
    def root(self) -> int:
        return digest.root(self.leaf)


def _ctx_column(L: int, bucket: np.ndarray, ctr: np.ndarray) -> np.ndarray:
    out = np.zeros(L, np.int64)
    np.maximum.at(out, bucket, ctr.astype(np.int64))
    return out


def cycles_expected(cfg: dict, t, calls: int, first: int = 0, ts_mask: int | None = None) -> tuple:
    """``(roots, state)``: the root after each of calls ``first + 1`` to
    ``calls`` of an ``add_remove_cycles`` stream, and the map after
    ``calls`` calls. Call ``c`` is delta ``p`` of cycle ``k`` (``k, p =
    divmod(c, 2G)``): for ``p < G`` the writer's adds of group ``p``, for
    ``p >= G`` the removal of group ``p - G``'s dots. With ``ts_mask``
    every timestamp is cut to those bits before it is hashed or kept
    (the comparison's control)."""
    L, G = cfg["num_buckets"], t.groups
    b = t.base
    cut = (lambda ts: ts & ts_mask) if ts_mask is not None else (lambda ts: ts)
    base_gid = np.full(len(b.key), b.gid, np.uint64)
    leaf = digest.leaves(L, b.bucket, digest.entry_hash(b.key, base_gid, b.ctr, cut(b.ts), b.valh))
    wg = np.full(len(t.key), t.gid, np.uint64)
    step = t.per_cycle[t.bucket].astype(np.uint64)
    members = [np.flatnonzero(t.group == g) for g in range(G)]
    dots = lambda k: (t.ctr0 + np.uint64(k) * step, cut(t.ts0 + k * t.ts_step))
    roots, hashed = [], (-1, None)
    for c in range(calls):
        k, p = divmod(c, 2 * G)
        if hashed[0] != k:
            hashed = (k, digest.entry_hash(t.key, wg, *dots(k), t.valh))
        m = members[p % G]
        part = digest.leaves(L, t.bucket[m], hashed[1][m])
        leaf = (leaf + part) & digest.M32 if p < G else (leaf - part) & digest.M32  # wraps mod 2^64
        if c >= first:
            roots.append(digest.root(leaf))

    k, p = divmod(calls, 2 * G)
    alive = t.group < p if p <= G else t.group >= p - G
    ctr, ts = dots(k)
    minted = np.bincount(t.bucket[t.group < min(p, G)], minlength=L)
    writer_ctx = t.base_ctx + k * t.per_cycle + minted
    ctx = {int(b.gid): _ctx_column(L, b.bucket, b.ctr)} if len(b.key) else {}
    ctx[int(t.gid)] = np.maximum(ctx.get(int(t.gid), 0), writer_ctx)
    state = MapState(
        key=np.concatenate([b.key, t.key[alive]]),
        gid=np.concatenate([base_gid, wg[alive]]),
        ctr=np.concatenate([b.ctr, ctr[alive]]),
        ts=np.concatenate([cut(b.ts), ts[alive]]),
        valh=np.concatenate([b.valh, t.valh[alive]]),
        ctx=ctx,
        leaf=leaf,
    )
    return roots, state
