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

The mesh forms (``mesh_fleet_*``) are the same fleet forms lifted one
axis further over a 1-D replica mesh
(:class:`~delta_crdt_ex_tpu_torch.utils.devices.Mesh`): the N stacked
lanes split into ``shards`` lane blocks, shard ``s``'s block on
``mesh.devices[s]``, and each block runs the UNCHANGED fleet form on
its shard's device — the JAX package's ``shard_map`` with the vmapped
form inside. Lane k's math is the same whether its block holds 2 lanes
or 256, so mesh and vmap fleets are bit for bit equal. A twin takes
full stacked tensors (split on entry) or
:class:`~delta_crdt_ex_tpu_torch.utils.devices.Sharded` values (used as
they are) and returns :class:`Sharded` results: a resident stacked
state stays block-split between calls. ``mesh_plane_rotate`` and
``mesh_plane_exchange`` are the intra-mesh delivery plane's collective
(:mod:`delta_crdt_ex_tpu_torch.runtime.meshplane`): one rotation of
padded slice buffers along the replica axis, each hop a copy.
``fleet_hash_row_apply`` (which nothing in the JAX package calls) is
not ported (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import dataclasses

import torch

from delta_crdt_ex_tpu_torch.ops import binned as binned_ops
from delta_crdt_ex_tpu_torch.ops import hash_map as hash_ops
from delta_crdt_ex_tpu_torch.utils import devices
from delta_crdt_ex_tpu_torch.utils.devices import Sharded

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
# mesh-lifted fleet transitions: each shard runs the fleet form on its own
# lane block, on its own device. The lane axis must be a multiple of the
# shard count (the fleet pads lane tiers to max(pow2, shards)).

#: the 1-D fleet mesh axis (``parallel/mesh_gossip.AXIS``)
MESH_AXIS = devices.AXIS
replica_sharding = devices.replica_sharding


def _zip_shards(mesh, outs: list):
    """Per-shard results → one :class:`Sharded` result (a list result,
    such as digest-tree levels, becomes a list of sharded levels)."""
    first = next(o for o in outs if o is not None)
    if isinstance(first, list):
        return [_zip_shards(mesh, [None if o is None else o[j] for o in outs]) for j in range(len(first))]
    return Sharded(mesh, outs)


def _lift(mesh, fn):
    """The mesh lift: ``fn`` (a lane-axis ``fleet_*`` form) over each of
    this process's shards' lane blocks, on that shard's device. Every
    argument carries the leading lane axis."""

    def run(*args):
        blocks = [devices.split(mesh, a).blocks for a in args]
        outs = []
        for s in range(mesh.shards):
            if not mesh.local(s):
                outs.append(None)
                continue
            with devices.on_device(mesh.devices[s]):
                outs.append(fn(*[b[s] for b in blocks]))
        return _zip_shards(mesh, outs)

    return run


def mesh_fleet_merge_rows(mesh, states, slices):
    """:func:`fleet_merge_rows` over the replica mesh: each shard merges
    its resident lane block, no cross-shard traffic (the merge is lane
    local; only the delivery plane rotates)."""
    return _lift(mesh, fleet_merge_rows)(states, slices)


def mesh_fleet_row_apply(mesh, states, self_slots, rows, op, key, valh, ts):
    """:func:`fleet_row_apply` over the replica mesh."""
    return _lift(mesh, fleet_row_apply)(states, self_slots, rows, op, key, valh, ts)


def mesh_fleet_extract_rows(mesh, states, rows):
    """:func:`fleet_extract_rows` over the replica mesh."""
    return _lift(mesh, fleet_extract_rows)(states, rows)


def mesh_fleet_interval_slices(mesh, states, rows, self_slots, gid_selfs, lo):
    """:func:`fleet_interval_slices` over the replica mesh."""
    return _lift(mesh, fleet_interval_slices)(states, rows, self_slots, gid_selfs, lo)


def mesh_fleet_tree_from_leaves(mesh, leaves):
    """:func:`fleet_tree_from_leaves` over the replica mesh (a list of
    sharded levels)."""
    return _lift(mesh, fleet_tree_from_leaves)(leaves)


def mesh_fleet_own_ctr_columns(mesh, ctx_max, self_slots):
    """:func:`fleet_own_ctr_columns` over the replica mesh."""
    return _lift(mesh, fleet_own_ctr_columns)(ctx_max, self_slots)


def mesh_fleet_hash_merge_rows(mesh, states, slices):
    """:func:`fleet_hash_merge_rows` over the replica mesh."""
    return _lift(mesh, fleet_hash_merge_rows)(states, slices)


def mesh_fleet_hash_row_counts(mesh, states, rows):
    """:func:`fleet_hash_row_counts` over the replica mesh."""
    return _lift(mesh, fleet_hash_row_counts)(states, rows)


def mesh_fleet_hash_own_delta_counts(mesh, states, rows, self_slots, lo):
    """:func:`fleet_hash_own_delta_counts` over the replica mesh."""
    return _lift(mesh, fleet_hash_own_delta_counts)(states, rows, self_slots, lo)


def mesh_fleet_hash_extract_rows(mesh, states, rows, lanes: int):
    """:func:`fleet_hash_extract_rows` over the replica mesh (``lanes``
    is the bucket-wide dense tier, the same on every shard)."""
    return _lift(mesh, lambda st, r: fleet_hash_extract_rows(st, r, lanes))(states, rows)


def mesh_fleet_hash_interval_slices(mesh, states, rows, self_slots, gid_selfs, lo, lanes: int):
    """:func:`fleet_hash_interval_slices` over the replica mesh."""
    return _lift(
        mesh, lambda st, r, ss, gs, lo_: fleet_hash_interval_slices(st, r, ss, gs, lo_, lanes)
    )(states, rows, self_slots, gid_selfs, lo)


def mesh_plane_exchange(mesh, shift: int, depth: int, cols: dict, src: torch.Tensor, slot: torch.Tensor) -> dict:
    """Dense scatter + rotation of the narrow delivery plane: ``cols``
    holds one exchange group's entry rows as dense column stacks,
    ``src``/``slot`` each row's place in the padded ``[shards, depth,
    ...]`` collective layout. Each shard's ``[1, depth, ...]`` buffer is
    built on its own device from the rows it sends (pad rows carry
    ``src == shards`` and land nowhere), then the buffers rotate by
    ``shift`` (:func:`mesh_plane_rotate`). The result stays on the
    devices for delivery."""
    src = src.to(torch.int64)
    slot = slot.to(torch.int64)
    picks = []
    for s in range(mesh.shards):
        if mesh.local(s):
            m = (src == s).nonzero().flatten()
            picks.append((m, slot[m]))
        else:
            picks.append(None)
    bufs = {}
    for c, a in cols.items():
        blocks = []
        for s, pick in enumerate(picks):
            if pick is None:
                blocks.append(None)
                continue
            dev = mesh.devices[s]
            b = torch.zeros((1, depth) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
            b[0, pick[1].to(dev)] = a[pick[0]].to(dev)
            blocks.append(b)
        bufs[c] = Sharded(mesh, blocks)
    return mesh_plane_rotate(mesh, shift, bufs)


def mesh_plane_rotate(mesh, shift: int, buffers: dict) -> dict:
    """The intra-mesh delivery plane's collective: rotate every column
    of ``buffers`` (padded ``[shards, depth, ...]`` slice stacks, full
    or sharded) ``shift`` shards forward along the replica axis — shard
    ``i``'s block lands on shard ``(i + shift) % S`` as a fresh copy
    (:func:`~delta_crdt_ex_tpu_torch.utils.devices.rotate`)."""
    return {c: devices.rotate(mesh, shift, b) for c, b in buffers.items()}


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
    as the member holds its state. A mesh-stacked state gives the lane
    from its shard's block, on that shard's device."""
    if isinstance(stacked, Sharded):
        s, lane = stacked._where(lane)
        stacked = stacked.blocks[s]
    return dataclasses.replace(
        stacked,
        **{
            f.name: getattr(stacked, f.name)[lane].clone()
            for f in dataclasses.fields(stacked)
            if isinstance(getattr(stacked, f.name), torch.Tensor)
        },
    )
