"""Bucket-binned dot store — the PyTorch port of
``delta_crdt_ex_tpu/models/binned.py``: :class:`BinnedStore`, its
capacity tiers, and :func:`from_numpy`/:func:`to_numpy`, which carry a
JAX ``BinnedStore``'s columns across bit for bit.

Entries live in dense rows ``[L, B]``: row = key-hash bucket (= leaf of
the sync-index digest tree), ``B`` slots per bucket. Columns (torch
tensors on the store's device; see
:mod:`delta_crdt_ex_tpu_torch.ops.binned` for how unsigned columns are
held):

    key   : int64[L, B]   64-bit key hash (uint64 bits)
    valh  : int64[L, B]   value content digest (uint32 value)
    ts    : int64[L, B]   LWW timestamp
    node  : int32[L, B]   writer replica as LOCAL slot into ctx tables
    ctr   : int64[L, B]   dot counter (uint32 value)
    alive : bool[L, B]    slot occupancy
    ehash : int64[L, B]   maintained entry content hash (uint32 value)

Maintained summaries:

    fill    : int32[L]     per-row append pointer (alive ⊆ [0, fill))
    amin    : int64[L, R]  min alive ctr per (bucket, writer slot);
                           U32_MAX when none
    amax    : int64[L, R]  max alive ctr per (bucket, writer slot); 0
                           when none
    leaf    : int64[L]     leaf digests: wrapping uint32 sum of alive ehash
    ctx_gid : int64[R]     slot → global replica id (uint64 bits, 0 = empty)
    ctx_max : int64[L, R]  per-bucket per-replica max observed counter

Every method is rank-agnostic over leading axes, so a neighbour stack
(``[N, L, B]`` columns, :mod:`delta_crdt_ex_tpu_torch.parallel.batched_sync`)
is a ``BinnedStore`` too, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: uint32 all-ones (the ``amin``/``ldense`` sentinel), held as an int
#: because the port keeps uint32 columns as int64 values in [0, 2^32)
U32_MAX = 0xFFFFFFFF

#: array columns in the JAX ``BinnedStore`` field order, with the numpy
#: dtype the JAX package holds each in
COLUMNS = {
    "key": np.uint64,
    "valh": np.uint32,
    "ts": np.int64,
    "node": np.int32,
    "ctr": np.uint32,
    "alive": np.bool_,
    "ehash": np.uint32,
    "fill": np.int32,
    "amin": np.uint32,
    "amax": np.uint32,
    "leaf": np.uint32,
    "ctx_gid": np.uint64,
    "ctx_max": np.uint32,
}


def pow2_tier(n: int, floor: int = 1) -> int:
    """Round up to the power-of-two capacity tier."""
    c = floor
    while c < n:
        c *= 2
    return c


def pow4_tier(n: int, floor: int = 8) -> int:
    """Round up in ×4 steps — the WIRE tier (sync slices vary per
    message; tiering keeps the distinct shapes few and the wire bytes
    identical to the JAX package's)."""
    c = floor
    while c < n:
        c *= 4
    return c


@dataclasses.dataclass(frozen=True)
class BinnedStore:
    key: torch.Tensor  # int64[..., L, B]
    valh: torch.Tensor  # int64[..., L, B]
    ts: torch.Tensor  # int64[..., L, B]
    node: torch.Tensor  # int32[..., L, B]
    ctr: torch.Tensor  # int64[..., L, B]
    alive: torch.Tensor  # bool[..., L, B]
    ehash: torch.Tensor  # int64[..., L, B]
    fill: torch.Tensor  # int32[..., L]
    amin: torch.Tensor  # int64[..., L, R]
    amax: torch.Tensor  # int64[..., L, R]
    leaf: torch.Tensor  # int64[..., L]
    ctx_gid: torch.Tensor  # int64[..., R]
    ctx_max: torch.Tensor  # int64[..., L, R]

    @property
    def num_buckets(self) -> int:
        return self.key.shape[-2]

    @property
    def bin_capacity(self) -> int:
        return self.key.shape[-1]

    @property
    def capacity(self) -> int:
        return self.key.shape[-2] * self.key.shape[-1]

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
        *,
        device,
    ) -> "BinnedStore":
        """Empty lattice state (``models/binned.py:135``)."""
        L, B, R = num_buckets, bin_capacity, replica_capacity
        z = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=device)
        return BinnedStore(
            key=z(L, B),
            valh=z(L, B),
            ts=z(L, B),
            node=torch.zeros((L, B), dtype=torch.int32, device=device),
            ctr=z(L, B),
            alive=torch.zeros((L, B), dtype=torch.bool, device=device),
            ehash=z(L, B),
            fill=torch.zeros(L, dtype=torch.int32, device=device),
            amin=torch.full((L, R), U32_MAX, dtype=torch.int64, device=device),
            amax=z(L, R),
            leaf=z(L),
            ctx_gid=z(R),
            ctx_max=z(L, R),
        )

    def grow(
        self, bin_capacity: int | None = None, replica_capacity: int | None = None
    ) -> "BinnedStore":
        """Pad to a larger tier on the last axis; L never changes. Works
        on a single state and on a neighbour stack alike."""
        db = (bin_capacity or self.bin_capacity) - self.bin_capacity
        dr = (replica_capacity or self.replica_capacity) - self.replica_capacity
        if db < 0 or dr < 0:
            raise ValueError(f"cannot shrink a BinnedStore (bin {db:+d}, replica {dr:+d})")
        pad = lambda a, d, value=0: torch.nn.functional.pad(a, (0, d), value=value) if d else a
        return dataclasses.replace(
            self,
            **{c: pad(getattr(self, c), db) for c in ("key", "valh", "ts", "node", "ctr", "alive", "ehash")},
            amin=pad(self.amin, dr, U32_MAX),
            amax=pad(self.amax, dr),
            ctx_gid=pad(self.ctx_gid, dr),
            ctx_max=pad(self.ctx_max, dr),
        )

    def entry_gid(self) -> torch.Tensor:
        """int64[..., L, B] (uint64 bits): global id of each entry's writer."""
        table = self.ctx_gid.unsqueeze(-2).expand(*self.node.shape[:-1], self.replica_capacity)
        return torch.gather(table, -1, self.node.to(torch.int64))

    def global_ctx(self) -> torch.Tensor:
        """int64[..., R]: the reference's global compressed context view."""
        return self.ctx_max.amax(dim=-2)

    def own_counter(self, slot) -> torch.Tensor:
        """Highest dot counter this replica has issued."""
        return self.ctx_max[..., slot].amax(dim=-1)

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def bucket_of(self, key: torch.Tensor) -> torch.Tensor:
        return key & (self.num_buckets - 1)


def map_columns(fn, *states: BinnedStore) -> BinnedStore:
    """``BinnedStore`` whose every column is ``fn`` of the states'
    columns (the port's ``jax.tree_util.tree_map``)."""
    return BinnedStore(
        **{f: fn(*(getattr(s, f) for s in states)) for f in COLUMNS}
    )


def from_numpy(cols: dict, device) -> BinnedStore:
    """A port store from a JAX ``BinnedStore``'s columns as numpy (the
    JAX dtypes), single or stacked, bit for bit."""
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
    return BinnedStore(**out)


def host_columns(host: dict, columns: dict) -> dict:
    """``{column: numpy array}`` in the JAX package's dtypes, in the
    order of ``columns``, from host copies of the port's columns."""
    out = {}
    for name, want in columns.items():
        a = np.asarray(host[name])
        out[name] = np.ascontiguousarray(a).view(np.uint64) if want == np.uint64 else a.astype(want)
    return out


def to_numpy(state: BinnedStore, get=None) -> dict:
    """The inverse of :func:`from_numpy`: ``{column: numpy array}`` in
    the JAX package's dtypes and field order. ``get`` copies the tensor
    dict to the host (an audited transfer site's ``get``; default: one
    ``.cpu()`` a column)."""
    cols = {name: getattr(state, name) for name in COLUMNS}
    host = get(cols) if get is not None else {c: t.detach().cpu().numpy() for c, t in cols.items()}
    return host_columns(host, COLUMNS)
