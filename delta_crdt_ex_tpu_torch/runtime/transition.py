"""Pure replica state transitions — the device half of the replica
split; the PyTorch port of ``delta_crdt_ex_tpu/runtime/transition.py``
(its non-mesh part).

Every function here is a deterministic function of its tensor inputs:
no locks, no transport, no host reads. The fleet forms (``fleet_*``)
take N replica states stacked on a leading replica axis and run ONE
batched call for all of them — what the single-process fleet
(:mod:`delta_crdt_ex_tpu_torch.runtime.fleet`) dispatches once a wave
instead of once a member. The JAX package gets the replica axis from
``jax.vmap``; the port's store ops take it as a leading axis
(:mod:`delta_crdt_ex_tpu_torch.ops.binned`,
:mod:`delta_crdt_ex_tpu_torch.ops.hash_map`), so each form here is a
plain call of the lane-axis op, and lane k of it is the solo op on
lane k's inputs, bit for bit.

The mesh forms (``mesh_fleet_*``, ``mesh_plane_*``) come with the
multi-device mesh slice; ``fleet_hash_row_apply`` (which nothing in the
JAX package calls) is not ported (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

from delta_crdt_ex_tpu_torch.ops import binned as binned_ops
from delta_crdt_ex_tpu_torch.ops import hash_map as hash_ops

# ---------------------------------------------------------------------------
# single-replica transitions (the replica loop's device calls)

merge_rows = binned_ops.merge_rows
row_apply = binned_ops.row_apply
extract_rows = binned_ops.extract_rows
compact_rows = binned_ops.compact_rows
winner_all = binned_ops.winner_all


# ---------------------------------------------------------------------------
# fleet transitions: leading replica axis, one call for N replicas


def fleet_merge_rows(states, slices) -> binned_ops.MergeRowsResult:
    """Batched anti-entropy merge: lane k joins ``slices`` lane k into
    ``states`` lane k. Every result field gains the leading axis; the
    per-lane ``ok`` flags let the host retry only the overflowing lanes
    through the solo growth path. Padding lanes (rows all ``-1``) merge
    nothing and report ``ok``."""
    return binned_ops.merge_rows(states, slices)


def fleet_row_apply(states, self_slots, rows, op, key, valh, ts):
    """Batched local mutation: lane k applies its bucket-grouped batch
    to ``states`` lane k."""
    return binned_ops.row_apply(states, self_slots, rows, op, key, valh, ts)


def fleet_extract_rows(states, rows) -> binned_ops.RowSlice:
    """Batched sync-slice extraction: lane k gathers its own ``rows``
    lane (``[N, U]``, ``-1`` pads)."""
    return binned_ops.extract_rows(states, rows)


def fleet_interval_slices(states, rows, self_slots, gid_selfs, lo) -> binned_ops.RowSlice:
    """Batched own-writer delta-interval extraction: lane k gathers its
    own alive entries with counter in ``(lo, ctx_max]`` per bucket row
    (one eager push for every member). Padding lanes (rows all ``-1``)
    extract nothing."""
    return binned_ops.extract_own_delta(states, rows, self_slots, gid_selfs, lo)


def fleet_tree_from_leaves(leaves: torch.Tensor) -> list:
    """Digest-tree levels of stacked leaf digests ``[N, L]`` (level j is
    ``[N, 2^j]``). Leaf digests are the same on both stores, so one form
    serves both."""
    return binned_ops.tree_from_leaves(leaves)


def fleet_own_ctr_columns(ctx_max: torch.Tensor, self_slots: torch.Tensor) -> torch.Tensor:
    """int64[N, L]: each lane's own-writer ``ctx_max`` column (the
    eager-push cursor source) from ``ctx_max`` ``[N, L, R]``."""
    n, L, _ = ctx_max.shape
    idx = self_slots.to(torch.int64)[:, None, None].expand(n, L, 1)
    return torch.gather(ctx_max, 2, idx)[..., 0]


def fleet_compact_rows(states):
    """Batched full repack and invariant rebuild."""
    return binned_ops.compact_rows(states)


def fleet_winner_all(states) -> binned_ops.RowWinners:
    """Batched whole-table LWW winner resolution (the fleet read path)."""
    return binned_ops.winner_all(states)


# ---------------------------------------------------------------------------
# hash-store fleet transitions: the same leading replica axis over the
# open-addressing backend (members bucket by table capacity)


def fleet_hash_merge_rows(states, slices) -> hash_ops.HashMergeResult:
    """Batched anti-entropy merge over stacked hash-store states."""
    return hash_ops.merge_rows(states, slices)


def fleet_hash_row_apply(states, self_slots, rows, op, key, valh, ts):
    raise NotImplementedError(
        "hash-store fleet mutation (ROADMAP queue 1) is not ported to PyTorch: "
        "nothing in the JAX package calls it; fleet members mutate through "
        "their own replicas"
    )


def fleet_hash_winner_all(states):
    """Batched whole-table LWW winner resolution, hash backend."""
    return hash_ops.winner_all(states)


def fleet_hash_row_counts(states, rows) -> torch.Tensor:
    """int32[N, U]: alive entries per requested sync row, every lane —
    the sizing pass of the dense extraction."""
    return hash_ops.row_counts(states, rows)


def fleet_hash_own_delta_counts(states, rows, self_slots, lo) -> torch.Tensor:
    """int32[N, U]: own-writer entries per row in ``(lo, ∞)``."""
    return hash_ops.own_delta_counts(states, rows, self_slots, lo)


def fleet_hash_extract_rows(states, rows, lanes: int) -> binned_ops.RowSlice:
    """Batched dense full-row extraction: ``lanes`` is the bucket-wide
    pow2 tier (the max of the members' own tiers); each member's
    solo-tier slice is the leading ``[:, :member_lanes]`` of its lane."""
    return hash_ops.extract_rows_packed(states, rows, lanes)


def fleet_hash_interval_slices(states, rows, self_slots, gid_selfs, lo, lanes: int) -> binned_ops.RowSlice:
    """Batched dense own-writer delta-interval extraction, hash backend."""
    return hash_ops.extract_own_delta_packed(states, rows, self_slots, gid_selfs, lo, lanes)


# ---------------------------------------------------------------------------
# stacking: torch.stack over a store's fields


def stack_pytrees(*trees):
    """Stack per-replica stores or bare tensors (equal shapes) on a new
    leading replica axis. A store's static fields (the hash store's
    probe window) must agree. Every tensor must live on one device."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        devices = {t.device for t in trees}
        if len(devices) > 1:
            raise ValueError(f"cannot stack replica states on different devices: {sorted(map(str, devices))}")
        return torch.stack(trees)
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(t, f.name) for t in trees]
        if isinstance(vals[0], torch.Tensor):
            out[f.name] = stack_pytrees(*vals)
        elif any(v != vals[0] for v in vals):
            raise ValueError(f"cannot stack stores with different {f.name}: {sorted(set(vals))}")
        else:
            out[f.name] = vals[0]
    return type(first)(**out)


def stack_states(states: list):
    """Stack per-replica states on a new leading replica axis."""
    return stack_pytrees(*states)


def index_state(stacked, lane: int):
    """Lane ``lane`` of a stacked state as a solo state. The columns are
    copies: a view would keep the whole stacked batch alive for as long
    as the member holds its state."""
    return dataclasses.replace(
        stacked,
        **{
            f.name: getattr(stacked, f.name)[lane].clone()
            for f in dataclasses.fields(stacked)
            if isinstance(getattr(stacked, f.name), torch.Tensor)
        },
    )
