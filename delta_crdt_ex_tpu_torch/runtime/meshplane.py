"""Intra-mesh delivery plane — the PyTorch port of
``delta_crdt_ex_tpu/runtime/meshplane.py``: sync-tick messages whose
destination member lives on the same fleet mesh move as device-side
rotations instead of bouncing through the host transport.

A mesh-mode :class:`~delta_crdt_ex_tpu_torch.runtime.fleet.Fleet` keeps
its members' stacked states block-split over a 1-D replica mesh. A
tick's outbound messages bound for a co-mesh member are buffered, their
slice columns ride one rotation per (shard distance, buffer geometry)
group along the ``replicas`` axis
(:func:`delta_crdt_ex_tpu_torch.runtime.transition.mesh_plane_rotate`,
each hop a copy onto the destination shard's device), and the per-entry
host bookkeeping — envelopes, payload dicts, mailbox delivery, and
through them WAL records, acks and telemetry at the receiver — fans out
as the host path's does. Only off-mesh destinations fall back to the
frame collector or a direct send.

Semantics are the host path's, bit for bit:

- a rotation moves each entry's columns intact (integer lattice
  columns; a copy changes placement, never values);
- ALL buffered messages (openers included: their digest blocks are
  host control metadata and ship as they are) deliver at
  :meth:`_TickExchange.flush` in global send order, which is the
  per-destination arrival order the tick without the plane gives;
- ``send`` returning True commits the message to the tick's exchange;
  a drop after that (a receiver died mid-tick) is the lossy-transport
  case of any send, which the periodic sync repairs.

The narrow exchange (the default) ships each group's entry rows as
dense pow2-padded column stacks plus int32 scatter vectors in ONE
audited crossing a tick (``meshplane.ship_dense``), builds the padded
``[shards, depth, ...]`` layout on the devices
(:func:`~delta_crdt_ex_tpu_torch.runtime.transition.mesh_plane_exchange`)
and delivers device-resident slices of the rotated buffers: tensor
bodies in the port's device layout, which the receivers merge on the
device plane (per slice, as the JAX package's device-plane bodies).
``MeshPlane(narrow=False)`` keeps the padded exchange: whole buffers
cross to the devices and back (``meshplane.ship_padded`` /
``meshplane.deliver_padded``) and deliver host-plane bodies.
``permuted_bytes`` counts the rotated buffers in the device layout,
where uint32 columns are int64 (the JAX package counts its own dtypes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from delta_crdt_ex_tpu_torch.models.binned import pow2_tier
from delta_crdt_ex_tpu_torch.ops.binned import wire_from_host
from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, transition, treesync
from delta_crdt_ex_tpu_torch.utils import transfers

# audited device↔host transfer sites (the JAX plane's labels)
#: padded path: whole [shards, depth, ...] buffers cross twice an
#: exchange group (ship + deliver)
_TR_SHIP_PADDED = transfers.register("meshplane.ship_padded")
_TR_DELIVER_PADDED = transfers.register("meshplane.deliver_padded")
#: narrow path: ONE crossing a tick — dense entry-row stacks plus
#: scatter index vectors; nothing comes back (delivery stays resident)
_TR_SHIP_DENSE = transfers.register("meshplane.ship_dense")

#: EntriesMsg columns that ride the exchange; ``rows`` stays host control
#: metadata, as on the replicas' device plane
_EXCHANGE_COLS = (
    "key", "valh", "ts", "node", "ctr", "alive",
    "ctx_rows", "ctx_lo", "ctx_gid",
)


class MeshPlane:
    """Per-fleet routing table and exchange factory. The fleet assigns
    its member addresses once (:meth:`assign`); each sync tick opens one
    :class:`_TickExchange` whose ``send_via`` is handed to the members'
    emission tails in place of the frame collector's send."""

    __slots__ = ("mesh", "shards", "sharding", "narrow", "_members")

    def __init__(self, mesh, *, narrow: bool = True) -> None:
        self.mesh = mesh
        self.shards = int(mesh.shards)
        self.sharding = transition.replica_sharding(mesh)
        #: narrow exchange (default): dense rows ship once a tick, the
        #: padded layout is built on the devices, delivery stays there;
        #: ``narrow=False`` keeps the padded host round trip
        self.narrow = bool(narrow)
        self._members: dict = {}  # addr -> (shard, transport)

    def assign(self, members: list) -> None:
        """Block-assign member ``(addr, transport)`` pairs to shards —
        the leading-axis block layout the resident stacked state splits
        with (lane tier padded to a shard multiple, so every shard owns
        a contiguous lane block)."""
        lanes = max(pow2_tier(len(members), floor=2), self.shards)
        per = lanes // self.shards
        self._members = {addr: (i // per, transport) for i, (addr, transport) in enumerate(members)}

    def shard_of(self, addr) -> "int | None":
        """The shard holding ``addr``'s lane, or None when the address
        is not a member of this mesh (the fallback set)."""
        ent = self._members.get(addr)
        return None if ent is None else ent[0]

    def members_per_shard(self) -> float:
        n = len(self._members)
        return round(n / self.shards, 3) if self.shards else 0.0

    def tree_group(self) -> tuple:
        """The tier-0 cluster key of tree gossip: every member of this
        mesh clusters as ONE bottom-tier subtree (an intra-mesh hop is a
        rotation). Deterministic in the assigned membership."""
        return ("mesh",) + treesync.fleet_group_key(list(self._members))[1:]

    def begin_tick(self) -> "_TickExchange":
        return _TickExchange(self)


class _TickExchange:
    """One sync tick's buffered exchange: routes sends, runs the
    rotations at :meth:`flush`, and returns the tick's delivery stats."""

    __slots__ = ("plane", "entries", "fallback_entries", "passthrough")

    def __init__(self, plane: MeshPlane) -> None:
        self.plane = plane
        self.entries: list = []  # (to, dst_shard, msg) in send order
        self.fallback_entries = 0
        #: co-mesh EntriesMsg the exchange could not carry (tensor
        #: bodies, or a sender that is not a member): delivered in order
        #: as they are and counted as fallback
        self.passthrough = 0

    def send_via(self, fallback, to, msg) -> bool:
        """Route one outbound message: co-mesh destinations buffer for
        the tick's exchange; everything else takes ``fallback`` (the
        member's frame-collector send)."""
        shard = self.plane.shard_of(to)
        if shard is None:
            if isinstance(msg, sync_proto.EntriesMsg):
                self.fallback_entries += 1
            return fallback(to, msg)
        self.entries.append((to, shard, msg))
        return True

    def _exchange_groups(self):
        """Entries the exchange carries, grouped by (shard distance,
        column geometry); same-shard entries (distance 0) are on their
        device already and need no rotation."""
        groups: dict = {}
        same_shard = 0
        for idx, (_to, dst, msg) in enumerate(self.entries):
            if not isinstance(msg, sync_proto.EntriesMsg):
                continue
            src = self.plane.shard_of(getattr(msg, "frm", None))
            if src is None:
                self.passthrough += 1
                continue
            a = msg.arrays
            if not all(isinstance(a.get(c), np.ndarray) for c in _EXCHANGE_COLS):
                self.passthrough += 1
                continue
            shift = (dst - src) % self.plane.shards
            if shift == 0:
                same_shard += 1
                continue
            geom = tuple((c, a[c].shape, a[c].dtype.str) for c in _EXCHANGE_COLS)
            groups.setdefault((shift, geom), []).append((idx, src, dst, a))
        return groups, same_shard

    @staticmethod
    def _slot_layout(items):
        """Each entry's slot in its source shard's buffer rows, and the
        pow2 depth tier covering the busiest source."""
        slot_of: list = []
        per_src: dict = {}
        for _idx, src, _dst, _a in items:
            j = per_src.get(src, 0)
            per_src[src] = j + 1
            slot_of.append(j)
        return slot_of, pow2_tier(max(per_src.values()))

    def _exchange_padded(self, groups):
        """Padded exchange: per group, the full ``[shards, depth, ...]``
        buffers are built on the host, placed on the shards, rotated and
        fetched back whole — two audited crossings a group."""
        delivered_cols: dict = {}
        permuted_bytes = 0
        exchanges = 0
        shards = self.plane.shards
        for (shift, geom), items in groups.items():
            slot_of, depth = self._slot_layout(items)
            bufs = {c: np.zeros((shards, depth) + shape, np.dtype(dt)) for c, shape, dt in geom}
            for (_idx, src, _dst, a), j in zip(items, slot_of):
                for c in _EXCHANGE_COLS:
                    bufs[c][src, j] = a[c]
            shipped = _TR_SHIP_PADDED.put(bufs, self.plane.sharding)
            rotated = transition.mesh_plane_rotate(self.plane.mesh, shift, shipped)
            permuted_bytes += sum(b.nbytes() for b in rotated.values())
            host = wire_from_host(_TR_DELIVER_PADDED.get(rotated))
            exchanges += 1
            for (idx, _src, dst, _a), j in zip(items, slot_of):
                cols = {c: host[c][dst, j] for c in _EXCHANGE_COLS}
                for v in cols.values():
                    v.flags.writeable = False  # as a fetched body's columns are
                delivered_cols[idx] = cols
        return delivered_cols, permuted_bytes, exchanges

    def _exchange_narrow(self, groups):
        """Narrow exchange: every group's entry rows as DENSE column
        stacks (pow2-padded on the entry axis) with int32 ``src``/``slot``
        scatter vectors ship in ONE audited crossing a tick; the padded
        layout is scattered on the devices and rotated, and delivery
        hands out device-resident slices of the rotated buffers."""
        delivered_cols: dict = {}
        if not groups:
            return delivered_cols, 0, 0
        permuted_bytes = 0
        shards = self.plane.shards
        staged: list = []  # (items, slot_of, shift, depth) a group
        bundle: list = []  # matching {"cols", "src", "slot"} stacks
        for (shift, geom), items in groups.items():
            slot_of, depth = self._slot_layout(items)
            n_pad = pow2_tier(len(items))
            cols = {c: np.zeros((n_pad,) + shape, np.dtype(dt)) for c, shape, dt in geom}
            # pad rows carry src == shards and land on no shard
            src = np.full((n_pad,), shards, np.int32)
            slot = np.zeros((n_pad,), np.int32)
            for k, ((_idx, s, _dst, a), j) in enumerate(zip(items, slot_of)):
                for c in _EXCHANGE_COLS:
                    cols[c][k] = a[c]
                src[k] = s
                slot[k] = j
            bundle.append({"cols": cols, "src": src, "slot": slot})
            staged.append((items, slot_of, shift, depth))
        shipped = _TR_SHIP_DENSE.put(bundle, self.plane.mesh.devices[0])
        for g, (items, slot_of, shift, depth) in enumerate(staged):
            rotated = transition.mesh_plane_exchange(
                self.plane.mesh, shift, depth, shipped[g]["cols"], shipped[g]["src"], shipped[g]["slot"]
            )
            permuted_bytes += sum(b.nbytes() for b in rotated.values())
            for (idx, _src, dst, _a), j in zip(items, slot_of):
                delivered_cols[idx] = {c: rotated[c][dst, j] for c in _EXCHANGE_COLS}
        return delivered_cols, permuted_bytes, len(staged)

    def flush(self) -> dict:
        """Run the rotations, then deliver every buffered message in
        global send order. Returns the tick's stats."""
        groups, same_shard = self._exchange_groups()
        exchange = self._exchange_narrow if self.plane.narrow else self._exchange_padded
        delivered_cols, permuted_bytes, exchanges = exchange(groups)

        intra_entries = same_shard + len(delivered_cols)
        members = self.plane._members
        for idx, (to, _dst, msg) in enumerate(self.entries):
            cols = delivered_cols.get(idx)
            if cols is not None:
                cols["rows"] = msg.arrays["rows"]
                msg = dataclasses.replace(msg, arrays=cols)
            members[to][1].send(to, msg)
        self.entries.clear()
        return {
            "intra_entries": intra_entries,
            "fallback_entries": self.fallback_entries + self.passthrough,
            "permuted_bytes": permuted_bytes,
            "exchanges": exchanges,
        }

