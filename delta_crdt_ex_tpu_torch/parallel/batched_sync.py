"""Batched neighbour anti-entropy — the PyTorch port of
``delta_crdt_ex_tpu/parallel/batched_sync.py``.

Replica states are stacked on a leading neighbour axis (``[N, L, B]``
columns) and one call merges a delta slice into all neighbour states at
once — the north star's 64-neighbour fan-in. The same stack batches a
whole gossip round among N device-resident replicas (each merges its
ring predecessor's full-row slice). The JAX package gets the neighbour
axis from ``jax.vmap``; the port's store ops take it as a leading axis
(:mod:`delta_crdt_ex_tpu_torch.ops.binned`), so lane k of a stacked call
is the solo call on lane k.

Both entry layouts run here: a column stack (:class:`BinnedStore`) and
a packed one (:class:`~delta_crdt_ex_tpu_torch.ops.packed.PackedStore`,
from :func:`pack_states`), whose fan-in with ``scatter_compact`` is the
one ``bench.py`` headlines. Neither switches to the other on its own.
"""

from __future__ import annotations

import dataclasses

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
from delta_crdt_ex_tpu_torch.ops.packed import (
    PackedStore,
    compact_rows_packed,
    merge_slice_packed,
    pack,
)
from delta_crdt_ex_tpu_torch.parallel import merge_graph


def _map_fields(fn, *states):
    """The store (either layout) whose every field is ``fn`` of the
    states' fields (the port's ``jax.tree_util.tree_map``)."""
    names = [f.name for f in dataclasses.fields(states[0])]
    return type(states[0])(**{f: fn(*(getattr(s, f) for s in states)) for f in names})


def stack_states(states: list) -> BinnedStore | PackedStore:
    """Stack equally shaped replica states on a leading neighbour axis
    (either layout)."""
    return _map_fields(lambda *xs: torch.stack(xs), *states)


def unstack_states(stacked: BinnedStore | PackedStore) -> list:
    return [_map_fields(lambda x: x[i], stacked) for i in range(stacked.ctx_gid.shape[0])]


def _require_stack(stacked, cls=BinnedStore) -> None:
    if not isinstance(stacked, cls):
        raise TypeError(f"expected a {cls.__name__} neighbour stack, got {type(stacked).__name__}")
    if stacked.ctx_gid.dim() != 2:
        raise ValueError(f"expected a leading neighbour axis, got a writer table of {tuple(stacked.ctx_gid.shape)}")


def fanout_merge(
    stacked: BinnedStore,
    sl: RowSlice,
    kill_budget: int = 64,
    max_inserts: int | None = None,
) -> MergeResult:
    """Merge one slice into N stacked neighbour states in one call
    (``batched_sync.py:58``). Each neighbour does its own gid remap and
    interval join against the shared slice; every result field has a
    leading neighbour axis. On a CUDA stack a neighbour whose merge is
    not ok comes back as it was (see
    :func:`~delta_crdt_ex_tpu_torch.ops.binned.merge_slice`)."""
    _require_stack(stacked)
    return merge_slice(stacked, sl, kill_budget, max_inserts)


def fanout_merge_packed(
    stacked: PackedStore,
    sl: RowSlice,
    kill_budget: int = 64,
    max_inserts: int | None = None,
    scatter_compact: bool = True,
    rows_sorted: bool = False,
) -> MergeResult:
    """:func:`fanout_merge` over the packed entry layout
    (``batched_sync.py:80``): the same per-neighbour remap and interval
    join, one ``[k, 8]`` record scatter per neighbour.
    ``scatter_compact`` (on by default, as in the JAX package) compacts
    the inserts by a cumsum rank; ``False`` by a top-k. ``rows_sorted``
    is accepted and changes nothing (see
    :func:`~delta_crdt_ex_tpu_torch.ops.packed.merge_slice_packed`)."""
    _require_stack(stacked, PackedStore)
    return merge_slice_packed(
        stacked, sl, kill_budget, max_inserts, scatter_compact=scatter_compact, rows_sorted=rows_sorted
    )


def fanout_merge_into(
    stacked: BinnedStore | PackedStore,
    sl: RowSlice,
    kill_budget: int = 16,
    on_grow=None,
    n_alive: int | None = None,
    scatter_compact: bool | None = None,
    rows_sorted: bool = False,
):
    """:func:`fanout_merge` or :func:`fanout_merge_packed` with the tier
    escalation of
    :func:`~delta_crdt_ex_tpu_torch.models.binned_map.tier_retry_merge`
    (``batched_sync.py:115``); tiers are uniform across the stack, so one
    overflowing neighbour retiers all of them.

    The layout is the stack's: a :class:`PackedStore` stack (see
    :func:`pack_states`) merges packed and compacts with
    :func:`~delta_crdt_ex_tpu_torch.ops.packed.compact_rows_packed`.
    ``scatter_compact`` selects the packed layout's top_k-free insert
    compaction: ``None`` means on for a packed stack and off for a
    column stack, and ``True`` on a column stack raises ``TypeError``
    (the column kernel has no such variant). ``rows_sorted`` passes
    through.

    On a CUDA column stack each merge attempt and each compaction is one
    replay of a captured CUDA graph
    (:mod:`~delta_crdt_ex_tpu_torch.parallel.merge_graph`), bit-equal to
    the eager merge, and the stack is donated:

    - a stack that this function returned is consumed by the next call
      that passes it in, and the result comes back in the same device
      buffers (as a new stack object);
    - passing an older returned stack again raises ``ValueError``: it is
      never read stale (a store made from one, such as its ``grow()``,
      reads what the buffers hold now);
    - any other stack (the first call's, a caller's own, a grown
      geometry) is merged eagerly and never written; the result's
      buffers become the entry's, and the graphs of the stack before
      are dropped.

    The graphs are chosen by what the call observes: a column stack on a
    CUDA device. CPU stacks and packed stacks merge eagerly as before,
    with no donation; there is no switch.

    Returns ``(stacked, last_result, n_retries)``."""
    packed = isinstance(stacked, PackedStore)
    if scatter_compact is None:
        scatter_compact = packed
    if scatter_compact and not packed:
        raise TypeError(
            "scatter_compact=True requires a PackedStore stack (pack_states); "
            "the column kernel has no scomp variant"
        )
    _require_stack(stacked, PackedStore if packed else BinnedStore)
    if n_alive is None:
        n_alive = int(sl.alive.sum())
    max_inserts = pow2_tier(max(n_alive, 1))
    if packed:
        merge = lambda st, s, kb, mi: fanout_merge_packed(st, s, kb, mi, scatter_compact, rows_sorted)
        return tier_retry_merge(stacked, sl, merge, compact_rows_packed, kill_budget, max_inserts, on_grow=on_grow)
    if stacked.device.type == "cuda":
        return merge_graph.ENTRY.merge_into(stacked, sl, kill_budget, max_inserts, on_grow=on_grow)
    return tier_retry_merge(stacked, sl, fanout_merge, compact_rows, kill_budget, max_inserts, on_grow=on_grow)


def pack_states(stacked: BinnedStore) -> PackedStore:
    """Column → packed layout for a neighbour stack
    (``batched_sync.py:172``; :func:`~delta_crdt_ex_tpu_torch.ops.packed.pack`
    takes any rank)."""
    _require_stack(stacked)
    return pack(stacked)


def ring_gossip_round(stacked: BinnedStore) -> MergeRowsResult:
    """One full-state gossip round among N replicas
    (``batched_sync.py:179``): replica i merges replica (i-1) mod N's
    full-row slice with the row-granular merge. One call, N merges."""
    _require_stack(stacked)
    rolled = map_columns(lambda x: torch.roll(x, 1, dims=0), stacked)
    all_rows = torch.arange(stacked.num_buckets, device=stacked.device)
    return merge_rows(stacked, extract_rows(rolled, all_rows))
