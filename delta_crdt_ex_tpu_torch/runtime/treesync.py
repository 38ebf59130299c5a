"""Hierarchical anti-entropy: the spanning tree every replica derives
for itself. The PyTorch port's own copy of
``delta_crdt_ex_tpu/runtime/treesync.py`` (the port imports nothing of
the JAX package); for the same members, seed, fanout and tier-0 groups
it derives the same tree and the same ``epoch`` string.

Flat gossip syncs every configured neighbour directly, so propagation
across many peers pays redundant walk rounds and bytes. Tree gossip
syncs along a reduction tree instead: leaves sync only their parent,
relays coalesce their children's merged rows and re-emit ONE merged
slice per link per epoch (``Replica._relay_flush``).

There is no coordinator: every replica computes the same tree from

- the sorted member set (its configured neighbours plus itself),
- a shared ``tree_seed`` (tie-break shuffling, so the root is not
  always the lexically smallest name),
- its locally observed down set (``Down`` messages for tree links;
  re-derived on ``set_neighbours`` and on Down/rejoin),
- a tier-0 GROUP per member (:func:`group_of`): members of one fleet or
  one process endpoint form one bottom-tier subtree under a single
  "captain", because a hop inside a process is free next to TCP.

Divergent views (mid-churn, before every replica observed the same
Down) are safe, only transiently suboptimal: every tree link is an
ordinary bidirectional sync edge healed by the digest walk, and the
next shared derivation converges the topology. When a replica's local
down set damages the tree past ``tree_degrade_ratio`` it gossips flat
(every neighbour a direct link) until membership stabilises.

Derivation is pure and host-only; the relay state lives on the
:class:`~delta_crdt_ex_tpu_torch.runtime.replica.Replica` under its lock.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Hashable


def member_key(addr: Hashable) -> str:
    """Canonical, process-independent ordering key for a member address
    (names are strings; TCP canonical addrs are ``(name, (host, port))``
    tuples — ``repr`` is deterministic for both)."""
    return repr(addr)


def _shuffle_rank(addr: Hashable, seed: int) -> bytes:
    """Deterministic pseudo-random rank: the same (addr, seed) ranks
    identically in every process, and a seed change reshuffles the whole
    tree (root rotation without a coordinator)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(member_key(addr).encode())
    h.update(int(seed).to_bytes(8, "little", signed=True))
    return h.digest()


def group_of(transport, addr: Hashable) -> "tuple | None":
    """The tier-0 cluster key for ``addr``, derivable by every replica
    from wire-visible information, so trees agree without a gossip
    round about the topology itself:

    1. an in-process owner advertising ``tree_group`` (a fleet stamps
       its members with one shared key);
    2. the remote process endpoint of a TCP canonical address
       (``(name, (host, port))``): co-located members cluster so only
       their captain gossips across processes;
    3. the pinned device (``transport.device_of``): co-device members
       ride the device data plane between each other. Only a replica
       pinned with an explicit device index has one, as only a JAX
       replica given ``device=`` does; the key is
       ``("device", repr(torch_device))``, and the device groups of one
       device type sort among themselves as the JAX package's do;
    4. ``None``: the member is its own singleton group.
    """
    owners = getattr(transport, "_owners", None)
    if owners is not None:
        owner = owners.get(addr)
        if owner is None and isinstance(addr, tuple) and len(addr) == 2:
            owner = owners.get(addr[0])
        if owner is not None:
            tg = getattr(owner, "tree_group", None)
            if tg is not None:
                return ("group", tg)
    if (
        isinstance(addr, tuple)
        and len(addr) == 2
        and isinstance(addr[1], (tuple, list))
        and len(addr[1]) == 2
    ):
        return ("endpoint", tuple(addr[1]))
    device_of = getattr(transport, "device_of", None)
    if device_of is not None:
        dev = device_of(addr)
        if dev is not None:
            return ("device", repr(dev))
    return None


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """One derived spanning tree: identical on every replica that fed
    :func:`derive_tree` the same inputs. ``epoch`` names the derivation
    (hash of members + seed + fanout) so two replicas can cheaply agree
    they computed the same tree."""

    epoch: str
    fanout: int
    seed: int
    members: tuple
    root: Any
    parent: dict  # addr -> parent addr (root absent)
    children: dict  # addr -> tuple of child addrs (leaves absent)
    tier: dict  # addr -> depth from root (root = 0)
    depth: int

    def links(self, addr: Hashable) -> list:
        """This member's sync edges: its parent (if any) then its
        children — the ONLY peers a tree-mode replica monitors, pushes
        to, walks toward, and relays between."""
        out: list = []
        p = self.parent.get(addr)
        if p is not None:
            out.append(p)
        out.extend(self.children.get(addr, ()))
        return out

    def role(self, addr: Hashable) -> str:
        if addr == self.root:
            return "root"
        return "relay" if self.children.get(addr) else "leaf"


def derive_tree(
    members,
    *,
    fanout: int = 8,
    seed: int = 0,
    down=(),
    group_key=None,
) -> "TreeTopology | None":
    """Derive the deterministic spanning tree over ``members`` minus
    ``down``. ``group_key`` maps addr → tier-0 cluster key (or None for
    a singleton); members sharing a key become ONE bottom-tier subtree:
    their captain (lowest shuffle rank) takes the group's slot in the
    relay tree and the rest hang off it directly, whatever the fanout —
    intra-group links are the free tier. The relay tree over captains
    is heap-shaped (captain i's children are ``i*F+1 .. i*F+F`` in
    shuffle-rank order), so depth is ``ceil(log_F(captains))`` and
    every replica lands on the same layout. Returns ``None`` for an
    empty alive set."""
    if fanout < 2:
        raise ValueError(f"tree fanout must be >= 2, got {fanout}")
    down = set(down)
    alive = sorted(
        {m for m in members if m not in down}, key=member_key
    )
    if not alive:
        return None
    rank = {m: _shuffle_rank(m, seed) for m in alive}

    groups: dict[Any, list] = {}
    for m in alive:
        gk = group_key(m) if group_key is not None else None
        if gk is None:
            gk = ("solo", member_key(m))
        groups.setdefault(gk, []).append(m)
    for g in groups.values():
        g.sort(key=lambda m: (rank[m], member_key(m)))
    # captain order = shuffle rank of each group's captain: the relay
    # tree is over captains, one slot per tier-0 cluster
    captains = sorted(
        (g[0] for g in groups.values()),
        key=lambda m: (rank[m], member_key(m)),
    )
    slot = {c: i for i, c in enumerate(captains)}

    parent: dict = {}
    children: dict = {}
    tier: dict = {}
    for i, c in enumerate(captains):
        if i == 0:
            tier[c] = 0
        else:
            p = captains[(i - 1) // fanout]
            parent[c] = p
            children.setdefault(p, []).append(c)
            tier[c] = tier[p] + 1
    for g in groups.values():
        cap = g[0]
        for m in g[1:]:
            parent[m] = cap
            children.setdefault(cap, []).append(m)
            tier[m] = tier[cap] + 1

    h = hashlib.blake2b(digest_size=8)
    for m in alive:
        h.update(member_key(m).encode())
        h.update(b"\x00")
    # the group PARTITION shapes the tree too, and it is observer-
    # dependent (an in-process observer sees tree_group stamps a remote
    # one cannot): fold it into the digest so two replicas reporting
    # the same epoch really did derive the same tree
    for gk in sorted(groups, key=repr):
        h.update(b"\x01")
        for m in groups[gk]:
            h.update(member_key(m).encode())
            h.update(b"\x00")
    h.update(int(seed).to_bytes(8, "little", signed=True))
    h.update(int(fanout).to_bytes(4, "little"))
    return TreeTopology(
        epoch=h.hexdigest(),
        fanout=int(fanout),
        seed=int(seed),
        members=tuple(alive),
        root=captains[0],
        parent=parent,
        children={k: tuple(v) for k, v in children.items()},
        tier=tier,
        depth=max(tier.values()) if tier else 0,
    )


def too_damaged(n_members: int, n_down: int, ratio: float) -> bool:
    """The flat-gossip degrade decision: with more than ``ratio`` of
    the membership down (or nothing but ourselves left) the tree's
    relay chains are untrustworthy — sync every neighbour directly
    until membership stabilises. Local-view-deterministic: replicas
    that observed the same failures degrade together."""
    if n_members <= 1:
        return True
    return n_down > ratio * n_members


def fleet_group_key(member_addrs) -> tuple:
    """The shared ``tree_group`` a fleet stamps its members with: a
    deterministic digest of the sorted member address set, so any
    process that knows the fleet's membership derives the same tier-0
    cluster (and co-located externals fall back to the endpoint group,
    which clusters the same members)."""
    h = hashlib.blake2b(digest_size=8)
    for m in sorted(member_addrs, key=member_key):
        h.update(member_key(m).encode())
        h.update(b"\x00")
    return ("fleet", h.hexdigest())
