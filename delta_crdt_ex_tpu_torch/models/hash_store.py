"""Open-addressing hash-table dot store — the PyTorch port of
``delta_crdt_ex_tpu/models/hash_store.py``.

Every entry lives in ONE flat table of ``H`` lanes, its slot found by
probing a bounded window from its key's group-aligned base
(:mod:`delta_crdt_ex_tpu_torch.ops.hash_map`); the only growth event is
a ×2 rehash of the whole table.

Slot lanes (torch tensors on the store's device, [H]; see
:mod:`delta_crdt_ex_tpu_torch.ops.binned` for how unsigned columns are
held):

    key   : int64   64-bit key hash (uint64 bits)
    valh  : int64   value content digest (uint32 value)
    ts    : int64   LWW timestamp
    node  : int32   writer replica as LOCAL slot into ctx tables
    ctr   : int64   dot counter (uint32 value)
    alive : bool    entry liveness — a dead lane is FREE (no tombstones)
    ehash : int64   maintained entry content hash (uint32 value)
    arr   : int64   per-sync-bucket arrival stamp (uint32 value)

Sync-index bookkeeping, unchanged from the binned store:

    leaf    : int64[L]    maintained leaf digests (uint32 wrapping sums)
    rowseq  : int64[L]    next arrival stamp per sync bucket (uint32)
    ctx_gid : int64[R]    slot → global replica id (uint64 bits, 0 = empty)
    ctx_max : int64[L, R] per-bucket per-replica max observed counter

:func:`from_numpy` / :func:`to_numpy` carry a JAX ``HashStore``'s
columns across bit for bit (the JAX dtypes on the numpy side).

The host wrappers below own the data-dependent control flow (growth,
dense-tier sizing); each reads the one or two device flags it branches
on, as the JAX package does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.binned import host_columns, pow2_tier as _pow2
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_CLEAR, OP_REMOVE

#: lanes per probe group (window bases are group-aligned)
GROUP = 8
#: default probe window lanes
DEFAULT_PROBE_WINDOW = 32
#: grow ×2 when the FULLEST probe window passes 3/4 of its lanes
LOAD_NUM, LOAD_DEN = 3, 4

#: array columns in the JAX ``HashStore`` field order, with the numpy
#: dtype the JAX package holds each in
COLUMNS = {
    "key": np.uint64,
    "valh": np.uint32,
    "ts": np.int64,
    "node": np.int32,
    "ctr": np.uint32,
    "alive": np.bool_,
    "ehash": np.uint32,
    "arr": np.uint32,
    "leaf": np.uint32,
    "rowseq": np.uint32,
    "ctx_gid": np.uint64,
    "ctx_max": np.uint32,
}


@dataclasses.dataclass(frozen=True)
class HashStore:
    key: torch.Tensor  # int64[H]
    valh: torch.Tensor  # int64[H]
    ts: torch.Tensor  # int64[H]
    node: torch.Tensor  # int32[H]
    ctr: torch.Tensor  # int64[H]
    alive: torch.Tensor  # bool[H]
    ehash: torch.Tensor  # int64[H]
    arr: torch.Tensor  # int64[H]
    leaf: torch.Tensor  # int64[L]
    rowseq: torch.Tensor  # int64[L]
    ctx_gid: torch.Tensor  # int64[R]
    ctx_max: torch.Tensor  # int64[L, R]
    probe_window: int = DEFAULT_PROBE_WINDOW

    @property
    def table_size(self) -> int:
        return self.key.shape[-1]

    @property
    def capacity(self) -> int:
        return self.key.shape[-1]

    @property
    def num_buckets(self) -> int:
        return self.leaf.shape[-1]

    @property
    def replica_capacity(self) -> int:
        return self.ctx_gid.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.key.device

    @staticmethod
    def new(
        num_buckets: int = 64,
        bin_capacity: int = 16,
        replica_capacity: int = 8,
        probe_window: int = DEFAULT_PROBE_WINDOW,
        *,
        device,
    ) -> "HashStore":
        """Empty state sized like the JAX ``HashStore.new``: the table
        holds ``L × bin_capacity`` lanes (pow2, ≥ 2 probe windows)."""
        L, R = num_buckets, replica_capacity
        H = _pow2(max(num_buckets * bin_capacity, 2 * probe_window, 64))
        z = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=device)
        return HashStore(
            key=z(H),
            valh=z(H),
            ts=z(H),
            node=torch.zeros(H, dtype=torch.int32, device=device),
            ctr=z(H),
            alive=torch.zeros(H, dtype=torch.bool, device=device),
            ehash=z(H),
            arr=z(H),
            leaf=z(L),
            rowseq=z(L),
            ctx_gid=z(R),
            ctx_max=z(L, R),
            probe_window=probe_window,
        )

    def grow(self, replica_capacity: int | None = None) -> "HashStore":
        """Pad the WRITER tables to a larger tier (table growth is a
        rehash, :func:`grow_table`)."""
        r_new = replica_capacity or self.replica_capacity
        dr = r_new - self.replica_capacity
        if dr < 0:
            raise ValueError(f"cannot shrink replica capacity to {r_new}")
        if not dr:
            return self
        pad = lambda a: torch.nn.functional.pad(a, (0, dr))
        return dataclasses.replace(
            self, ctx_gid=pad(self.ctx_gid), ctx_max=pad(self.ctx_max)
        )

    def entry_gid(self) -> torch.Tensor:
        """int64[H] (uint64 bits): global replica id of each entry's writer."""
        return self.ctx_gid[self.node.to(torch.int64)]

    def global_ctx(self) -> torch.Tensor:
        return self.ctx_max.amax(dim=0)

    def own_counter(self, slot) -> torch.Tensor:
        return self.ctx_max[:, slot].amax()

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def bucket_of(self, key: torch.Tensor) -> torch.Tensor:
        return key & (self.num_buckets - 1)


def from_numpy(cols: dict, device, probe_window: int | None = None) -> HashStore:
    """A port store from a JAX ``HashStore``'s columns as numpy (the JAX
    dtypes), bit for bit. ``probe_window`` comes from ``cols`` when it
    holds one (``dataclasses.asdict`` of a JAX store does)."""
    out = {}
    for name, want in COLUMNS.items():
        a = np.asarray(cols[name])
        if a.dtype != want:
            raise TypeError(f"column {name!r}: expected {np.dtype(want)}, got {a.dtype}")
        if want == np.uint64:
            a = np.ascontiguousarray(a).view(np.int64)
        elif want == np.uint32:
            a = a.astype(np.int64)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    pw = probe_window if probe_window is not None else int(cols.get("probe_window", DEFAULT_PROBE_WINDOW))
    return HashStore(**out, probe_window=pw)


def to_numpy(state: HashStore, get=None) -> dict:
    """The inverse of :func:`from_numpy`: ``{column: numpy array}`` in
    the JAX package's dtypes and field order, plus ``probe_window`` as a
    plain int (the JAX ``STORE_META``). ``get`` copies the tensor dict
    to the host (default: one ``.cpu()`` a column)."""
    cols = {name: getattr(state, name) for name in COLUMNS}
    host = get(cols) if get is not None else {c: t.detach().cpu().numpy() for c, t in cols.items()}
    out = host_columns(host, COLUMNS)
    out["probe_window"] = int(state.probe_window)
    return out


# ---------------------------------------------------------------------------
# host-side wrappers: growth policy, dense-tier sizing, model class


def _ops():
    # deferred: ops/hash_map imports this module for HashStore
    from delta_crdt_ex_tpu_torch.ops import hash_map

    return hash_map


def grow_table(state: HashStore, on_grow=None) -> HashStore:
    """THE growth event: rehash ×2 (at least). A rehash that still
    cannot place every entry doubles again and, every second attempt,
    widens the probe window (``hash_store.py:226``)."""
    n_alive = int(state.num_alive())
    w = state.probe_window
    h_new = max(_pow2(max(2 * n_alive, 2 * w, 64)), 2 * state.table_size)
    attempt = 0
    while True:
        st2, ok = _ops().rehash(state, table_size=h_new, probe_window=w)
        if bool(ok):
            if on_grow:
                on_grow(st2)
            return st2
        attempt += 1
        if attempt % 2 == 0 and w < h_new:
            w *= 2
        else:
            h_new *= 2


def maybe_rehash(state: HashStore, max_window_fill: int, on_grow=None) -> HashStore:
    """Growth advisory: grow once the fullest probe window passes
    ``LOAD_NUM/LOAD_DEN`` of its lanes."""
    if max_window_fill * LOAD_DEN > LOAD_NUM * state.probe_window:
        return grow_table(state, on_grow=on_grow)
    return state


def merge_rows_into(state: HashStore, sl, on_grow=None):
    """Merge a RowSlice via the open-addressing kernel; growth handled
    here on the host. Returns ``(new_state, result)``; raises the port's
    :class:`~delta_crdt_ex_tpu_torch.models.binned_map.CtxGapError` on a
    non-contiguous delta-interval."""
    from delta_crdt_ex_tpu_torch.models.binned_map import CtxGapError, _CTX_GAP_MSG

    while True:
        res = _ops().merge_rows(state, sl)
        flags = torch.stack(
            [
                res.ok.to(torch.int64),
                res.max_window_fill.to(torch.int64),
                res.need_ctx_gap.to(torch.int64),
                res.need_gid_grow.to(torch.int64),
                res.need_fill_grow.to(torch.int64),
            ]
        ).tolist()  # one device sync for every branch below
        ok, wfill, gap, gid_grow, fill_grow = flags
        if ok:
            return maybe_rehash(res.state, int(wfill), on_grow=on_grow), res
        if gap:
            err = CtxGapError(_CTX_GAP_MSG)
            err.gap_rows = res.gap_row.cpu().numpy()
            raise err
        if gid_grow:
            state = state.grow(replica_capacity=state.replica_capacity * 2)
            if on_grow:
                on_grow(state)
        if fill_grow:
            state = grow_table(state, on_grow=on_grow)


def merge_group_into(state: HashStore, arrays_list: list, on_grow=None):
    """Grouped fan-in merge over the hash table (one combined slice, one
    merge, ``gapped_members`` mapped through member offsets)."""
    from delta_crdt_ex_tpu_torch.models.binned_map import grouped_merge

    return grouped_merge(merge_rows_into, state, arrays_list, on_grow=on_grow)


def _dense_lanes(counts) -> int:
    """pow2 wire tier of the fullest requested row."""
    return _pow2(max(int(counts.max()) if counts.numel() else 0, 1), floor=4)


def _lane_tiers(counts) -> list:
    """Each lane's :func:`_dense_lanes` tier from a stacked counting
    pass ``[N, U]``, with one host read."""
    return [_pow2(max(c, 1), floor=4) for c in counts.amax(dim=1).tolist()]


def extract_rows(state: HashStore, rows):
    """Dense full-row slice: a counting pass sizes the pow2 lane tier,
    the packed gather fills it."""
    counts = _ops().row_counts(state, rows)
    return _ops().extract_rows_packed(state, rows, lanes=_dense_lanes(counts))


def extract_own_delta(state: HashStore, rows, self_slot, gid_self, lo):
    counts = _ops().own_delta_counts(state, rows, self_slot, lo)
    return _ops().extract_own_delta_packed(
        state, rows, self_slot, gid_self, lo, lanes=_dense_lanes(counts)
    )


def winner_rows(state: HashStore, rows):
    counts = _ops().row_counts(state, rows)
    return _ops().winner_rows_packed(state, rows, lanes=_dense_lanes(counts))


def winners_for_keys(state: HashStore, khash):
    """LWW point lookup through the probe-window kernel: the hand-written
    CUDA kernel for a CUDA table, its plain torch version for a CPU one
    (:func:`delta_crdt_ex_tpu_torch.ops.hash_map.probe_winners`)."""
    return _ops().probe_winners(state, khash)


class HashAWLWWMap:
    """Model class: the AWLWWMap op vocabulary over :class:`HashStore` —
    the ``crdt_module`` of the port's replica runtime."""

    OPS = {
        "add": (OP_ADD, 2),
        "remove": (OP_REMOVE, 1),
        "clear": (OP_CLEAR, 0),
    }

    #: store backend tag (``api._resolve_store`` maps models across it)
    backend = "hash"
    #: static (non-tensor) Store fields: snapshots hold them as plain ints
    STORE_META = ("probe_window",)
    #: snapshot columns to and from numpy in the JAX dtypes
    to_numpy = staticmethod(to_numpy)
    from_numpy = staticmethod(from_numpy)
    new = staticmethod(HashStore.new)
    merge_rows_into = staticmethod(merge_rows_into)
    merge_group_into = staticmethod(merge_group_into)
    extract_rows = staticmethod(extract_rows)
    extract_own_delta = staticmethod(extract_own_delta)
    winner_rows = staticmethod(winner_rows)
    winners_for_keys = staticmethod(winners_for_keys)

    @staticmethod
    def group_batch(num_buckets, op, key, valh, ts):
        from delta_crdt_ex_tpu_torch.models.binned_map import group_batch

        return group_batch(num_buckets, op, key, valh, ts)

    # raw kernels (tests, deterministic drives)
    row_apply = staticmethod(lambda *a: _ops().row_apply(*a))
    merge_rows = staticmethod(lambda *a: _ops().merge_rows(*a))
    clear_all = staticmethod(lambda *a: _ops().clear_all(*a))
    compact_rows = staticmethod(lambda *a: _ops().compact_rows(*a))
    winner_all = staticmethod(lambda *a: _ops().winner_all(*a))

    @staticmethod
    def tree_from_leaves(leaf):
        from delta_crdt_ex_tpu_torch.ops.binned import tree_from_leaves

        return tree_from_leaves(leaf)

    @staticmethod
    def read_view(d: dict):
        return d

    @staticmethod
    def grow_for_apply(state: HashStore) -> HashStore:
        """Local-mutation overflow escape: rehash ×2."""
        return grow_table(state)

    @staticmethod
    def post_apply(state: HashStore, res, on_grow=None) -> HashStore:
        """Post-commit growth advisory from the apply result's max
        window fill."""
        return maybe_rehash(state, int(res.max_window_fill), on_grow=on_grow)

    @staticmethod
    def combine_entry_arrays(arrays_list: list, device):
        from delta_crdt_ex_tpu_torch.models.binned_map import combine_entry_arrays

        return combine_entry_arrays(arrays_list, device)

    @staticmethod
    def load_high(max_window_fill: int, probe_window: int) -> bool:
        """Fleet post-commit advisory (``hash_store.py:441``): a lane
        whose fullest window nears overflow grows off the batch path,
        before it escapes mid-batch."""
        return max_window_fill * LOAD_DEN > LOAD_NUM * probe_window

    @staticmethod
    def store_load_high(state: HashStore) -> bool:
        """The same advisory recomputed from a live state (the replica's
        re-check under its lock before an advised growth)."""
        return HashAWLWWMap.load_high(int(_ops().max_window_fill(state)), state.probe_window)

    @staticmethod
    def geometry(state: HashStore) -> tuple:
        """Batch-compatibility key: hash members bucket by TABLE
        CAPACITY, which moves only on a rehash."""
        return (
            "hash",
            state.num_buckets,
            state.table_size,
            state.replica_capacity,
            state.probe_window,
        )

    @staticmethod
    def geometry_stacked(stacked) -> tuple:
        """The same key read from a stacked store's shapes."""
        return ("hash", stacked.leaf.shape[-1], stacked.key.shape[-1], stacked.ctx_gid.shape[-1], stacked.probe_window)

    # the fleet seams (``hash_store.py:485-520``). The dense extraction
    # sizes its entry-lane tier by content, so a bucket runs at the max
    # of its members' own pow2 tiers (one host read of the counting
    # pass) and each lane trims back to its solo tier (``s_tiers``)

    @classmethod
    def fleet_merge_rows(cls, states, slices):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.fleet_hash_merge_rows(states, slices)

    @classmethod
    def fleet_extract_rows(cls, states, rows):
        from delta_crdt_ex_tpu_torch.runtime import transition

        tiers = _lane_tiers(transition.fleet_hash_row_counts(states, rows))
        return transition.fleet_hash_extract_rows(states, rows, max(tiers)), tiers

    @classmethod
    def fleet_extract_own_delta(cls, states, rows, self_slots, gid_selfs, lo):
        from delta_crdt_ex_tpu_torch.runtime import transition

        tiers = _lane_tiers(transition.fleet_hash_own_delta_counts(states, rows, self_slots, lo))
        return transition.fleet_hash_interval_slices(states, rows, self_slots, gid_selfs, lo, max(tiers)), tiers

    # the mesh seams (``hash_store.py:522-565``): the sizing pass runs
    # on the mesh too, and the bucket-wide dense tier comes from the
    # gathered counts as in the batched forms — padding lanes count no
    # entries, so the tier never moves with the shard padding

    @classmethod
    def mesh_fleet_merge_rows(cls, mesh, states, slices):
        from delta_crdt_ex_tpu_torch.runtime import transition

        return transition.mesh_fleet_hash_merge_rows(mesh, states, slices)

    @classmethod
    def mesh_fleet_extract_rows(cls, mesh, states, rows):
        from delta_crdt_ex_tpu_torch.runtime import transition

        tiers = _lane_tiers(transition.mesh_fleet_hash_row_counts(mesh, states, rows).gather())
        return transition.mesh_fleet_hash_extract_rows(mesh, states, rows, max(tiers)), tiers

    @classmethod
    def mesh_fleet_extract_own_delta(cls, mesh, states, rows, self_slots, gid_selfs, lo):
        from delta_crdt_ex_tpu_torch.runtime import transition

        tiers = _lane_tiers(transition.mesh_fleet_hash_own_delta_counts(mesh, states, rows, self_slots, lo).gather())
        return (
            transition.mesh_fleet_hash_interval_slices(mesh, states, rows, self_slots, gid_selfs, lo, max(tiers)),
            tiers,
        )


class HashAWSet(HashAWLWWMap):
    """Add-wins observed-remove set over the hash store
    (``hash_store.py:565``): the ``AWSet``/``BinnedAWLWWMap``
    relationship on the hash backend."""

    OPS = {
        "add": (OP_ADD, 1),
        "remove": (OP_REMOVE, 1),
        "clear": (OP_CLEAR, 0),
    }

    @staticmethod
    def read_view(d: dict):
        return set(d)
