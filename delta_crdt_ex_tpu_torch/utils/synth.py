"""Synthetic workload builders — the PyTorch port of
``delta_crdt_ex_tpu/utils/synth.py``: a single-writer binned state
(:func:`build_state`) and a writer's delta-interval stream
(:func:`interval_delta_stream`).

Generation is the JAX package's host numpy, draw for draw, so one
``rng`` seed gives the same keys, counters, timestamps and slices in
both packages; the results move to torch only at the end
(:func:`~delta_crdt_ex_tpu_torch.models.binned.from_numpy`, the wire
slice conversion). The synthetic writer issues per-bucket contiguous
counters, so each delta claims exactly the dots it carries and in-order
merging never gaps.
"""

from __future__ import annotations

import numpy as np

from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, from_numpy, pow2_tier
from delta_crdt_ex_tpu_torch.ops.binned import init_from_columns, slice_from_wire


def build_state(
    gid: int,
    keys: np.ndarray,
    num_buckets: int,
    bin_capacity: int,
    replica_capacity: int = 8,
    ts_start: int = 1,
    *,
    device="cuda",
):
    """A single-writer BinnedStore on ``device`` holding ``keys`` (uint64,
    distinct) with per-bucket contiguous counters. Returns ``(state,
    next_ctr uint32[L])`` where ``next_ctr[b] - 1`` is the writer's top
    counter in bucket b. The invariants (ehash/fill/amin/amax/leaf) are
    rebuilt on the device by
    :func:`~delta_crdt_ex_tpu_torch.ops.binned.init_from_columns`."""
    L, B, R = num_buckets, bin_capacity, replica_capacity
    n = len(keys)
    bucket = (keys & np.uint64(L - 1)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    sk = keys[order]
    sb = bucket[order]
    # rank within bucket = per-bucket slot and counter-1
    starts = np.searchsorted(sb, np.arange(L))
    rank = np.arange(n) - starts[sb]
    if rank.max(initial=0) >= B:
        raise ValueError(
            f"bucket overflow: max occupancy {rank.max() + 1} > bin capacity {B}"
        )

    cols = {c: np.zeros((L, B), COLUMNS[c]) for c in ("key", "valh", "ts", "node", "ctr", "alive", "ehash")}
    cols["key"][sb, rank] = sk
    cols["valh"][sb, rank] = (sk & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    cols["ts"][sb, rank] = ts_start + np.arange(n)
    cols["ctr"][sb, rank] = rank + 1
    cols["alive"][sb, rank] = True

    counts = np.bincount(bucket, minlength=L).astype(np.uint32)
    cols["fill"] = np.zeros(L, np.int32)
    cols["amin"] = np.zeros((L, R), np.uint32)
    cols["amax"] = np.zeros((L, R), np.uint32)
    cols["leaf"] = np.zeros(L, np.uint32)
    cols["ctx_max"] = np.zeros((L, R), np.uint32)
    cols["ctx_max"][:, 0] = counts
    cols["ctx_gid"] = np.zeros(R, np.uint64)
    cols["ctx_gid"][0] = gid
    return init_from_columns(from_numpy(cols, device)), counts.astype(np.uint32) + 1


def interval_delta_stream(
    gid: int,
    rng: np.random.Generator,
    num_deltas: int,
    delta_size: int,
    num_buckets: int,
    next_ctr: np.ndarray | None = None,
    ts_start: int = 1 << 20,
    bin_width: int = 8,
    *,
    device="cuda",
):
    """``num_deltas`` sequential RowSlices on ``device`` from one writer:
    fresh random keys, per-bucket counters continuing from ``next_ctr``,
    exact delta-interval contexts, all of shape ``[U, bin_width]`` (U =
    delta_size padded to a power of two). Returns ``(slices,
    next_ctr)``."""
    L = num_buckets
    next_ctr = (
        next_ctr.astype(np.uint32) if next_ctr is not None else np.ones(L, np.uint32)
    )
    u = pow2_tier(delta_size)
    s = bin_width
    slices = []
    ts = ts_start
    for _ in range(num_deltas):
        keys = rng.integers(1, 1 << 63, size=delta_size, dtype=np.uint64)
        bucket = (keys & np.uint64(L - 1)).astype(np.int64)
        rows_u, inv = np.unique(bucket, return_inverse=True)
        # the slice's valid rows strictly ascend (np.unique); a producer
        # change that breaks this must fail loudly
        assert (np.diff(rows_u) > 0).all(), "delta slice rows must strictly ascend"
        nrows = len(rows_u)
        cols = np.zeros(delta_size, np.int64)
        seen: dict[int, int] = {}
        for i in range(delta_size):
            r = int(inv[i])
            cols[i] = seen.get(r, 0)
            seen[r] = cols[i] + 1
        if max(seen.values()) > s:
            raise ValueError(
                f"delta has {max(seen.values())} same-bucket keys > bin_width {s}"
            )

        sl = dict(
            rows=np.full(u, -1, np.int32),
            key=np.zeros((u, s), np.uint64),
            valh=np.zeros((u, s), np.uint32),
            ts=np.zeros((u, s), np.int64),
            node=np.zeros((u, s), np.int32),
            ctr=np.zeros((u, s), np.uint32),
            alive=np.zeros((u, s), bool),
            ctx_rows=np.zeros((u, 1), np.uint32),
            ctx_lo=np.zeros((u, 1), np.uint32),
            ctx_gid=np.array([gid], np.uint64),
        )
        sl["rows"][:nrows] = rows_u
        lo = next_ctr[rows_u] - 1  # interval lower bound (exclusive)
        sl["ctx_lo"][:nrows, 0] = lo
        counts = np.bincount(inv, minlength=nrows).astype(np.uint32)
        sl["ctx_rows"][:nrows, 0] = lo + counts
        sl["key"][inv, cols] = keys
        sl["valh"][inv, cols] = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        sl["ts"][inv, cols] = ts + np.arange(delta_size)
        sl["ctr"][inv, cols] = lo[inv] + cols + 1
        sl["alive"][inv, cols] = True
        next_ctr[rows_u] += counts
        ts += delta_size
        slices.append(slice_from_wire(sl, device))
    return slices, next_ctr
