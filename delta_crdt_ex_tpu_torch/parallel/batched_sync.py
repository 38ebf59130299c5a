"""Batched neighbour anti-entropy — the PyTorch port of
``delta_crdt_ex_tpu/parallel/batched_sync.py`` for the column layout.

Replica states are stacked on a leading neighbour axis (``[N, L, B]``
columns) and one call merges a delta slice into all neighbour states at
once — the north star's 64-neighbour fan-in. The same stack batches a
whole gossip round among N device-resident replicas (each merges its
ring predecessor's full-row slice). The JAX package gets the neighbour
axis from ``jax.vmap``; the port's store ops take it as a leading axis
(:mod:`delta_crdt_ex_tpu_torch.ops.binned`), so lane k of a stacked call
is the solo call on lane k.

The packed entry layout (``fanout_merge_packed``, ``pack_states``) is a
later slice (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from delta_crdt_ex_tpu_torch.models.binned import BinnedStore, map_columns, pow2_tier
from delta_crdt_ex_tpu_torch.models.binned_map import tier_retry_merge
from delta_crdt_ex_tpu_torch.ops.binned import (
    MergeResult,
    MergeRowsResult,
    RowSlice,
    compact_rows,
    extract_rows,
    merge_rows,
    merge_slice,
)


def stack_states(states: list[BinnedStore]) -> BinnedStore:
    """Stack equally shaped replica states on a leading neighbour axis."""
    return map_columns(lambda *xs: torch.stack(xs), *states)


def unstack_states(stacked: BinnedStore) -> list[BinnedStore]:
    return [map_columns(lambda x: x[i], stacked) for i in range(stacked.key.shape[0])]


def _require_stack(stacked) -> None:
    if not isinstance(stacked, BinnedStore):
        raise TypeError(f"expected a BinnedStore neighbour stack, got {type(stacked).__name__}")
    if stacked.key.dim() != 3:
        raise ValueError(f"expected [N, L, B] columns, got key {tuple(stacked.key.shape)}")


def fanout_merge(
    stacked: BinnedStore,
    sl: RowSlice,
    kill_budget: int = 64,
    max_inserts: int | None = None,
) -> MergeResult:
    """Merge one slice into N stacked neighbour states in one call
    (``batched_sync.py:58``). Each neighbour does its own gid remap and
    interval join against the shared slice; every result field has a
    leading neighbour axis."""
    _require_stack(stacked)
    return merge_slice(stacked, sl, kill_budget, max_inserts)


def fanout_merge_into(
    stacked: BinnedStore,
    sl: RowSlice,
    kill_budget: int = 16,
    on_grow=None,
    n_alive: int | None = None,
    scatter_compact: bool | None = None,
):
    """:func:`fanout_merge` with the tier escalation of
    :func:`~delta_crdt_ex_tpu_torch.models.binned_map.tier_retry_merge`
    (``batched_sync.py:115``); tiers are uniform across the stack, so one
    overflowing neighbour retiers all of them. ``scatter_compact`` selects
    the packed layout's top_k-free insert compaction, which the column
    kernel does not have: ``True`` raises ``TypeError``.

    Returns ``(stacked, last_result, n_retries)``."""
    if scatter_compact:
        raise TypeError(
            "scatter_compact=True requires a PackedStore stack (pack_states); "
            "the column kernel has no scomp variant"
        )
    _require_stack(stacked)
    if n_alive is None:
        n_alive = int(sl.alive.sum())
    return tier_retry_merge(
        stacked, sl, fanout_merge, compact_rows, kill_budget, pow2_tier(max(n_alive, 1)), on_grow=on_grow
    )


def ring_gossip_round(stacked: BinnedStore) -> MergeRowsResult:
    """One full-state gossip round among N replicas
    (``batched_sync.py:179``): replica i merges replica (i-1) mod N's
    full-row slice with the row-granular merge. One call, N merges."""
    _require_stack(stacked)
    rolled = map_columns(lambda x: torch.roll(x, 1, dims=0), stacked)
    all_rows = torch.arange(stacked.num_buckets, device=stacked.device)
    return merge_rows(stacked, extract_rows(rolled, all_rows))
