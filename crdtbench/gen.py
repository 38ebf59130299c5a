"""The benchmark's one traffic generator: host numpy, drawn from the
run's ``--seed``, shaped by a configuration file
(``crdtbench/configs/<config>.json``) and a traffic file
(``crdtbench/traffic/<mix>.json``). Nothing here imports the program.

A traffic file names its kind (``"kind"``). The one kind so far is
``add_remove_cycles``: the anti-entropy stream that one replica (the
writer, gid ``writer_gid``) sends its neighbour while it adds
``cycle_keys`` fresh keys and then removes them again, over and over,
on top of the ``base_keys`` keys both replicas already hold. The adds
ship as deltas of at most ``max_sync_size`` keys in write order; the
removals ship as the same deltas' context intervals with no entries
(a removal delta names exactly the dots it removes). Cycle k re-adds
the same keys with the same values under fresh dots: every counter of
a bucket moves on by the keys that bucket gets a cycle, every
timestamp by ``cycle_keys``.

The base map is one writer's: ``base_keys`` distinct keys in bucket
order (stable by draw order within a bucket), the i-th with timestamp
``ts_origin_us + i``, counter = its rank in its bucket + 1, and value
hash = the key's low 32 bits. That is the program's synthetic
single-writer builder's convention; the plain reference derives the
same map from these rules, not from the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

M32 = 0xFFFFFFFF


def pow2_tier(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def _member(x: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """``x``'s elements that are in the sorted array ``sorted_set``."""
    if not len(sorted_set):
        return np.zeros(len(x), bool)
    i = np.minimum(np.searchsorted(sorted_set, x), len(sorted_set) - 1)
    return sorted_set[i] == x


def draw_keys(rng: np.random.Generator, n: int, exclude: tuple = ()) -> np.ndarray:
    """``n`` distinct uint64 keys in ``[1, 2^63)`` in draw order, none in
    any of the sorted arrays ``exclude``."""
    out = np.empty(0, np.uint64)
    while len(out) < n:
        cand = rng.integers(1, 1 << 63, size=n - len(out) + 16, dtype=np.uint64)
        _, first = np.unique(cand, return_index=True)
        cand = cand[np.sort(first)]
        for ex in (*exclude, np.sort(out)):
            cand = cand[~_member(cand, ex)]
        out = np.concatenate([out, cand])[:n]
    return out


def rank_in_bucket(bucket: np.ndarray) -> np.ndarray:
    """Each element's rank among the elements of its bucket, in array
    order."""
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    rank_sorted = np.arange(len(sb)) - np.searchsorted(sb, sb, side="left")
    rank = np.empty(len(sb), np.int64)
    rank[order] = rank_sorted
    return rank


@dataclasses.dataclass
class BaseMap:
    """The base writer's entries (the reference's view of the base)."""

    keys: np.ndarray  # uint64[n] in draw order (what the program is handed)
    key: np.ndarray  # uint64[n] in bucket order
    bucket: np.ndarray  # int64[n]
    ctr: np.ndarray  # uint64[n]
    ts: np.ndarray  # int64[n]
    valh: np.ndarray  # uint64[n]
    gid: int


def base_map(cfg: dict, rng: np.random.Generator) -> BaseMap:
    L = cfg["num_buckets"]
    keys = draw_keys(rng, cfg["base_keys"])
    bucket = (keys & np.uint64(L - 1)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    sk, sb = keys[order], bucket[order]
    rank = np.arange(len(sk)) - np.searchsorted(sb, sb, side="left")
    if rank.max(initial=0) >= cfg["bin_capacity"]:
        raise ValueError(f"a base bucket holds {rank.max() + 1} keys > bin capacity {cfg['bin_capacity']}")
    return BaseMap(
        keys=keys,
        key=sk,
        bucket=sb,
        ctr=(rank + 1).astype(np.uint64),
        ts=cfg["ts_origin_us"] + np.arange(len(sk), dtype=np.int64),
        valh=sk & np.uint64(M32),
        gid=cfg["base_gid"],
    )


@dataclasses.dataclass
class CycleTraffic:
    """``add_remove_cycles`` traffic (see the module docstring). Cycle 0
    is spelled out; cycle k is cycle 0 moved on by ``k × per_cycle`` in
    every counter and context bound of a bucket and by ``k × ts_step`` in
    every timestamp."""

    base: BaseMap
    gid: int  # the writer's gid
    key: np.ndarray  # uint64[n] the cycle's keys in write order
    bucket: np.ndarray  # int64[n]
    group: np.ndarray  # int64[n] the delta that ships each key's add and removal
    ctr0: np.ndarray  # uint64[n] cycle 0's counters
    ts0: np.ndarray  # int64[n] cycle 0's timestamps
    valh: np.ndarray  # uint64[n] (the same value every cycle)
    base_ctx: np.ndarray  # int64[L] the writer's counters in the base (0 unless it wrote the base)
    per_cycle: np.ndarray  # int64[L] dots the writer mints in each bucket a cycle
    ts_step: int
    groups: int  # G: deltas a phase
    wires: list  # [2G] cycle 0's wire slices: G adds, then G removals
    n_alive: list  # [2G] alive entries of each wire


def _wire(u: int, S: int, gid: int) -> dict:
    return dict(
        rows=np.full(u, -1, np.int32),
        key=np.zeros((u, S), np.uint64),
        valh=np.zeros((u, S), np.uint32),
        ts=np.zeros((u, S), np.int64),
        node=np.zeros((u, S), np.int32),
        ctr=np.zeros((u, S), np.uint32),
        alive=np.zeros((u, S), bool),
        ctx_rows=np.zeros((u, 1), np.uint32),
        ctx_lo=np.zeros((u, 1), np.uint32),
        ctx_gid=np.array([gid], np.uint64),
    )


def cycle_traffic(cfg: dict, mix: dict, rng: np.random.Generator) -> CycleTraffic:
    if mix["kind"] != "add_remove_cycles":
        raise ValueError(f"traffic kind {mix['kind']!r} is not add_remove_cycles")
    base = base_map(cfg, rng)
    L, S, B = cfg["num_buckets"], cfg["bin_width"], cfg["bin_capacity"]
    n = mix["cycle_keys"]
    d = min(cfg["max_sync_size"], n)
    G = -(-n // d)
    gid = cfg["writer_gid"]
    taken = [np.sort(base.keys)]
    groups = []
    for g in range(G):  # each delta's keys, at most bin_width of one bucket
        m = min(d, n - g * d)
        keys = draw_keys(rng, m, tuple(taken))
        while True:
            over = rank_in_bucket((keys & np.uint64(L - 1)).astype(np.int64)) >= S
            if not over.any():
                break
            keep = keys[~over]
            keys = np.concatenate([keep, draw_keys(rng, int(over.sum()), (*taken, np.sort(keep)))])
        taken.append(np.sort(keys))
        groups.append(keys)
    key = np.concatenate(groups)
    bucket = (key & np.uint64(L - 1)).astype(np.int64)
    group = np.repeat(np.arange(G), [len(k) for k in groups])
    base_count = np.bincount(base.bucket, minlength=L)
    per_cycle = np.bincount(bucket, minlength=L)
    if (base_count + per_cycle).max(initial=0) > B:
        raise ValueError(f"a bucket holds {(base_count + per_cycle).max()} keys > bin capacity {B}")
    base_ctx = base_count.astype(np.int64) if base.gid == gid else np.zeros(L, np.int64)
    next_ctr = base_ctx.copy()
    ctr0 = np.zeros(n, np.uint64)
    valh = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    ts0 = cfg["ts_origin_us"] + (1 << 30) + np.arange(n, dtype=np.int64)
    u = pow2_tier(d)
    adds, removals, n_alive = [], [], []
    for g in range(G):
        sel = np.flatnonzero(group == g)
        b = bucket[sel]
        rows_u, inv = np.unique(b, return_inverse=True)
        rank = rank_in_bucket(b)
        counts = np.bincount(inv, minlength=len(rows_u))
        lo = next_ctr[rows_u]
        ctr0[sel] = (lo[inv] + rank + 1).astype(np.uint64)
        next_ctr[rows_u] += counts
        add, rm = _wire(u, S, gid), _wire(u, S, gid)
        for w in (add, rm):
            w["rows"][: len(rows_u)] = rows_u
            w["ctx_lo"][: len(rows_u), 0] = lo
            w["ctx_rows"][: len(rows_u), 0] = lo + counts
        add["key"][inv, rank] = key[sel]
        add["valh"][inv, rank] = valh[sel]
        add["ts"][inv, rank] = ts0[sel]
        add["ctr"][inv, rank] = ctr0[sel]
        add["alive"][inv, rank] = True
        adds.append(add)
        removals.append(rm)
        n_alive.append(len(sel))
    return CycleTraffic(
        base, gid, key, bucket, group, ctr0, ts0, valh, base_ctx, per_cycle.astype(np.int64), n, G,
        adds + removals, n_alive + [0] * G,
    )
