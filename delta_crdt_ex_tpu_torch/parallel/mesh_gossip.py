"""Replication over a device mesh — the PyTorch port of
``delta_crdt_ex_tpu/parallel/mesh_gossip.py``.

One replica state lives on each shard of a 1-D replica mesh
(:class:`~delta_crdt_ex_tpu_torch.utils.devices.Mesh`), and a gossip
step moves state between shards with rotations: shard ``i``'s buffer
goes to shard ``(i ± 1) % S`` as a copy onto the destination's device
(a peer copy between cards, a device-local copy on one card, a
``dist.batch_isend_irecv`` pair between processes of a mesh that spans
``torch.distributed`` ranks). The JAX package runs the same step as one
``shard_map`` program with ``lax.ppermute``; here each shard's part of
the step runs on its own device, in shard order, between the rotations.

Ring gossip converges every replica in ≤ N-1 steps (each state travels
the whole ring); anti-entropy idempotence makes over-delivery harmless.
The bounded-divergence step (:func:`gossip_delta_step`) ships digests,
a frontier request and a slice of only the differing buckets.

Every op here is the port's torch version of the JAX op, so a step is
bit-equal to the JAX step on the same inputs. The mesh steps fold their
roots with ``tree_from_leaves``, as the JAX ones do; they launch no
hand-written kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import to_numpy, from_numpy
from delta_crdt_ex_tpu_torch.ops.binned import (
    extract_rows,
    flagged_first_order,
    merge_rows,
    row_apply,
    tree_from_leaves,
)
from delta_crdt_ex_tpu_torch.utils import devices
from delta_crdt_ex_tpu_torch.utils.devices import (
    AXIS,
    Sharded,
    make_mesh,
    place_states,
    replica_sharding,
    rotate,
)
from delta_crdt_ex_tpu_torch.utils.transfers import device_layout

__all__ = [
    "AXIS",
    "gossip_delta_drive",
    "gossip_delta_step",
    "gossip_train_step",
    "make_mesh",
    "place_states",
    "replica_sharding",
    "restore_mesh",
    "snapshot_mesh",
]


def _tensor(a) -> torch.Tensor:
    """A batch input as a tensor of the device layout (numpy uint64 keys
    as int64 bits, uint32 values widened)."""
    return a if isinstance(a, (torch.Tensor, Sharded)) else device_layout(np.asarray(a))


def _shards(mesh, *args) -> list:
    """Every argument block-split over ``mesh``, one replica a shard."""
    split = [devices.split(mesh, _tensor(a) if not dataclasses.is_dataclass(a) else a) for a in args]
    k = split[0].lanes_per_shard
    if k != 1:
        raise ValueError(f"mesh gossip runs one replica a shard: {k * mesh.shards} replicas on {mesh.shards} shards")
    return split


def _per_shard(mesh, fn, *sharded) -> list:
    """``fn`` of each local shard's blocks, on that shard's device
    (``None`` for another process's shards)."""
    out = []
    for s in range(mesh.shards):
        if not mesh.local(s):
            out.append(None)
            continue
        with devices.on_device(mesh.devices[s]):
            out.append(fn(*[a.blocks[s] for a in sharded]))
    return out


def _field(mesh, outs: list, i: int) -> Sharded:
    return Sharded(mesh, [None if o is None else o[i] for o in outs])


def gossip_delta_step(mesh, stacked, self_slot, rows, op, key, valh, ts, frontier: int = 64):
    """One bounded-divergence gossip step — bytes between shards ∝
    divergence:

    1. apply each replica's local mutation batch (``row_apply``);
    2. rotate the **leaf digests** one shard forward (i → i+1): the
       receiver compares them with its own leaves and picks up to
       ``frontier`` differing buckets (a fixed-size padded frontier, the
       ``max_sync_size`` analog);
    3. rotate the **frontier request** one shard backward (the receiver
       asks its ring predecessor);
    4. the predecessor extracts exactly those rows and the **slice**
       rotates forward; the receiver merges it.

    Divergence beyond ``frontier`` buckets heals over later steps
    (``n_diff`` reports the true differing-bucket count). ``stacked``
    holds one replica a shard, full or already sharded; the batch
    arguments are ``[N, ...]`` tensors (or numpy in the JAX dtypes).

    Returns ``(stacked, roots, ok, n_diff, flags)``, each sharded over
    the mesh: ``ok[i]`` folds the local apply's bin-capacity flag and
    the merge's tier flags — False means replica i's step is invalid
    and the host must grow that tier and replay from the pre-step state
    (:func:`gossip_delta_drive`); ``flags[i] = [apply_fill, gid_grow,
    merge_fill]`` names the tier."""
    st_in, slot, rows, op, key, valh, ts = _shards(mesh, stacked, self_slot, rows, op, key, valh, ts)
    applied = _per_shard(
        mesh, lambda s, sl, r, o, k, v, t: row_apply(s, sl.to(torch.int64), r.to(torch.int64), o, k, v, t),
        st_in, slot, rows, op, key, valh, ts,
    )
    st = _field(mesh, applied, 0)
    apply_ok = _field(mesh, applied, 1)

    # 2. digest exchange: the predecessor's leaves arrive here
    prev_leaf = rotate(mesh, 1, st.leaf)

    def pick(prev, mine):
        diff = prev != mine
        n_diff = diff.sum(-1, dtype=torch.int32)
        # differing buckets first, ascending (truncation past the
        # frontier heals in later steps; n_diff reports it)
        order = flagged_first_order(diff, frontier)
        want = torch.where(torch.gather(diff, -1, order), order, -1)
        return want, n_diff

    picked = _per_shard(mesh, pick, prev_leaf, st.leaf)
    # 3. the frontier request travels backward to the predecessor
    asked = rotate(mesh, -1, _field(mesh, picked, 0))
    # 4. the predecessor gathers its rows; the slice travels forward
    sl = rotate(mesh, 1, Sharded(mesh, _per_shard(mesh, extract_rows, st, asked)))

    def finish(state, sl_b, ok_a):
        res = merge_rows(state, sl_b)
        root = tree_from_leaves(res.state.leaf)[0][..., 0]
        flags = torch.stack([~ok_a, res.need_gid_grow, res.need_fill_grow], dim=-1)
        return res.state, root, ok_a & res.ok, flags

    done = _per_shard(mesh, finish, st, sl, apply_ok)
    return (
        _field(mesh, done, 0),
        _field(mesh, done, 1),
        _field(mesh, done, 2),
        _field(mesh, picked, 1),
        _field(mesh, done, 3),
    )


def _host(x, gather):
    if gather is not None:
        return np.asarray(gather(x))
    return (x.gather("cpu") if isinstance(x, Sharded) else x).numpy()


def _grow(stacked, **kw):
    if isinstance(stacked, Sharded):
        return stacked.map(lambda b: b.grow(**kw))
    return stacked.grow(**kw)


def gossip_delta_drive(
    mesh, stacked, self_slot, rows, op, key, valh, ts, frontier: int = 64, on_grow=None, gather=None,
):
    """Host recovery loop around :func:`gossip_delta_step`: a failed step
    (any ``ok=False``) discards that step's states, grows the offending
    tier on the PRE-step states, and replays — the mutation batches
    re-apply, since the failed result was never kept. Growth: gid table
    ×2, bin capacity ×2 (the row-granular merge reclaims holes in-row,
    so a fill overflow is genuine).

    ``gather`` (a mesh spanning processes): a callable returning the
    FULL ``oks``/``flags`` values on the host in every process —
    :func:`~delta_crdt_ex_tpu_torch.utils.devices.process_allgather` —
    so every process takes the same grow/replay decisions and the steps
    stay in lockstep.

    Returns ``(stacked, roots, n_diff, n_retiers)``."""
    retiers = 0
    while True:
        out, roots, oks, n_diff, flags = gossip_delta_step(
            mesh, stacked, self_slot, rows, op, key, valh, ts, frontier=frontier
        )
        if bool(_host(oks, gather).all()):
            return out, roots, n_diff, retiers
        # flags read only on the (rare) failure path — the same in every
        # process, so the branch above stays in lockstep
        f = _host(flags, gather).reshape(-1, 3).any(axis=0)
        retiers += 1
        apply_fill, gid_grow, merge_fill = map(bool, f)
        if gid_grow:
            stacked = _grow(stacked, replica_capacity=stacked.replica_capacity * 2)
            if on_grow:
                on_grow(stacked)
        if apply_fill or merge_fill:
            stacked = _grow(stacked, bin_capacity=stacked.bin_capacity * 2)
            if on_grow:
                on_grow(stacked)


def gossip_train_step(mesh, stacked, self_slot, rows, op, key, valh, ts):
    """One step of local mutation batch → ring rotation of the full
    state → merge → roots: per-shard compute (the row-local mutation
    ops), one collective (the whole state one shard forward), then
    shard-local lattice math. Returns the new states, each replica's
    digest-tree root and per-replica ``ok`` flags (False: that replica's
    apply or merge overflowed a tier and its state for this step is
    invalid), each sharded over the mesh."""
    st_in, slot, rows, op, key, valh, ts = _shards(mesh, stacked, self_slot, rows, op, key, valh, ts)
    applied = _per_shard(
        mesh, lambda s, sl, r, o, k, v, t: row_apply(s, sl.to(torch.int64), r.to(torch.int64), o, k, v, t),
        st_in, slot, rows, op, key, valh, ts,
    )
    st = _field(mesh, applied, 0)
    received = rotate(mesh, 1, st)

    def finish(state, recv, ok_a):
        all_rows = torch.arange(state.num_buckets, device=state.device)
        res = merge_rows(state, extract_rows(recv, all_rows))
        root = tree_from_leaves(res.state.leaf)[0][..., 0]
        # ok folds the batch's bin-capacity flag too: a dropped insert
        # must be as loud as a merge overflow
        return res.state, root, ok_a & res.ok

    done = _per_shard(mesh, finish, st, received, _field(mesh, applied, 1))
    return _field(mesh, done, 0), _field(mesh, done, 1), _field(mesh, done, 2)


def snapshot_mesh(stacked) -> dict:
    """Device→host image of a mesh-stacked replica set (the SPMD analog
    of the replica's storage snapshot): every column gathered to numpy in
    the JAX package's dtypes, plus the engine layout tag; picklable, and
    readable by either package."""
    from delta_crdt_ex_tpu_torch.runtime.storage import CURRENT_LAYOUT

    whole = stacked.gather("cpu") if isinstance(stacked, Sharded) else stacked
    return {"layout": CURRENT_LAYOUT, "arrays": to_numpy(whole)}


def restore_mesh(snap: dict, mesh) -> Sharded:
    """Re-place a :func:`snapshot_mesh` image onto a mesh (the same
    replica count; the devices may differ)."""
    from delta_crdt_ex_tpu_torch.runtime.storage import require_layout

    require_layout(snap.get("layout", "<untagged>"), "mesh snapshot")
    arrays = snap["arrays"]
    n = arrays["key"].shape[0]
    if mesh.shards != n:
        raise ValueError(f"snapshot holds {n} replicas but the mesh has {mesh.shards} shards")
    return replica_sharding(mesh).put(from_numpy(arrays, "cpu"))
