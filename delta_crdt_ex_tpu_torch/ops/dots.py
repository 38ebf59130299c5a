"""Causal-context helpers (``delta_crdt_ex_tpu/ops/dots.py:89-130``) as
torch ops.

uint64 gids are held as int64 bit patterns (equality is all these
functions need of them); slot indices are int64. :func:`merge_gid_tables`
takes leading batch axes (one table per stacked neighbour), the form the
JAX package gets from ``jax.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def encode_dot(node: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """Pack a (local-slot, counter) dot into one 64-bit key (int64 bit
    pattern of the JAX package's uint64)."""
    return (node.to(torch.int64) << 32) | (ctr.to(torch.int64) & 0xFFFFFFFF)


class MergedGids(NamedTuple):
    ctx_gid: torch.Tensor  # int64[..., R] (uint64 bits) merged slot table
    remap: torch.Tensor  # int64[..., Rr] remote slot → local slot (-1 for empty)
    overflow: torch.Tensor  # bool[...]: not enough free local slots for new gids


def merge_gid_tables(gid_l: torch.Tensor, gid_r: torch.Tensor) -> MergedGids:
    """Merge the remote gid slot table into the local one: matching gids
    keep their local slot, unknown gids take free local slots in
    remote-slot order. ``gid_l`` is ``[..., R]``; ``gid_r`` is
    ``[..., Rr]`` or one ``[Rr]`` table shared by every batch entry."""
    r_local = gid_l.shape[-1]
    lead = gid_l.shape[:-1]
    dev = gid_l.device
    gid_r = gid_r.expand(*lead, gid_r.shape[-1])

    occupied_r = gid_r != 0
    eq = (gid_l[..., :, None] == gid_r[..., None, :]) & occupied_r[..., None, :]
    has_match = eq.any(dim=-2)
    match_idx = eq.to(torch.int32).argmax(dim=-2)  # first matching slot

    is_new = occupied_r & ~has_match
    free = gid_l == 0
    free_rank = torch.cumsum(free.to(torch.int64), -1) - 1
    # rank → local slot index (unassigned ranks point out of bounds);
    # position r_local is the dropped-write sentinel
    slot_of_rank = torch.full((*lead, r_local + 1), r_local, dtype=torch.int64, device=dev)
    slot_of_rank.scatter_(
        -1,
        torch.where(free, free_rank, r_local),
        torch.arange(r_local, dtype=torch.int64, device=dev).expand(*lead, r_local),
    )
    slot_of_rank = slot_of_rank[..., :r_local]
    new_rank = torch.cumsum(is_new.to(torch.int64), -1) - 1
    overflow = is_new.sum(-1) > free.sum(-1)

    new_slot = torch.gather(slot_of_rank, -1, new_rank.clamp(0, r_local - 1))
    target = torch.where(is_new, new_slot, match_idx.to(torch.int64))
    target = torch.where(occupied_r, target, r_local)

    ext = torch.cat([gid_l, gid_l.new_zeros((*lead, 1))], dim=-1)
    ext.scatter_(-1, target, gid_r)
    ctx_gid = ext[..., :r_local]
    # un-placeable new gids (overflow) map to -1 like empties
    remap = torch.where(occupied_r & (target < r_local), target, -1)
    return MergedGids(ctx_gid, remap, overflow)
