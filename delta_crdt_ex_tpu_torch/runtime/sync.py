"""Anti-entropy protocol: messages + the digest-tree level walk.

This is the TPU-native redesign of the reference's two-phase Merkle
anti-entropy (Almeida et al. Algorithm 2 shell, ``causal_crdt.ex:252-289``
+ ``:86-123``):

- the originator A opens a sync with its tree root block; the peers then
  **ping-pong bounded frontier blocks** — each message carries the
  sender's digests for up to ``levels_per_round`` (default 8, exactly the
  reference's ``prepare_partial_diff(mm, 8)`` fan) tree levels beneath the
  currently-differing frontier, truncated to ``max_sync_size`` nodes
  (reference ``truncate``, ``causal_crdt.ex:206-214``);
- the receiver walks the block against its own tree (host numpy over
  device-computed digests — control on host, bulk math on device), either
  continuing the ping-pong, acking on equality (``{:ok, []}`` path,
  ``causal_crdt.ex:101-102``), or arriving at differing leaf buckets;
- differing buckets resolve to an entries transfer from the originator to
  the peer (``get_diff`` / direct-slice paths, ``causal_crdt.ex:324-335``),
  joined on device.

Every message is bounded; truncated divergence heals over subsequent
rounds (sync is idempotent). Data flows originator → peer only, matching
the reference's unidirectional edges (``delta_crdt.ex:89-94``).

Log-shipping catch-up rides the same transport: a rejoining
or lagging peer's divergence has a *known shape* — the suffix of the
server's per-replica delta log (the WAL) past the peer's last fully
observed sequence number — so instead of walking the digest tree it
sends :class:`GetLogMsg` with that watermark and the server answers
:class:`LogChunkMsg` runs. Watermarks are learned from the walk itself:
every :class:`DiffMsg` stamps the sender's applied ``seq``, and a walk
that ends in equality proves the receiver covers the sender's state at
that seq (digest equality ⇒ content equality). The chunk payload is NOT
a literal replay of the server's ``batch`` records — replaying another
writer's local mutation ops at the receiver would re-mint dots under
the wrong writer/counters and break add-wins once deltas also arrive
transitively — instead the WAL range is used as a *changed-bucket
index*: the server ships current full-row slices (``ctx_lo = 0``,
exactly the walk's entries transfer shape) for every bucket the range
touched, deduplicated across the range. Chunks therefore merge through
the normal idempotent entries path, coalesce on the grouped-ingest fast
path, and are bit-comparable against a digest-walk catch-up. A request
below the log's compaction horizon is answered with the explicit
``horizon`` so only the pre-horizon prefix falls back to the tree walk.

The PyTorch port's own copy of ``delta_crdt_ex_tpu/runtime/sync.py``:
the port imports nothing of the JAX package, and the message fields
stay identical so the wire stays single.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Hashable

import numpy as np


@dataclasses.dataclass
class DiffMsg:
    """Frontier block (the reference's ``%Diff{continuation: …}``)."""

    originator: Hashable
    frm: Hashable
    to: Hashable
    level: int  # tree level of the frontier (0 = root)
    idx: np.ndarray  # int64[f] frontier node indices at `level`
    blocks: list[np.ndarray]  # sender digests for levels level..level+j under idx
    #: the SENDER's applied sequence number when this block was built.
    #: A walk ending in equality proves the receiver covers the sender's
    #: state at this seq — the watermark log-shipping catch-up resumes
    #: from (0 on frames from builds predating log shipping: the
    #: watermark then stays conservative and catch-up over-serves, which
    #: is safe — merges are idempotent).
    seq: int = 0
    #: the sender's WAL compaction horizon when this is a round OPENER
    #: from a log-shipping-capable originator (None otherwise). The peer
    #: compares its applied watermark against it to decide the round's
    #: mode: watermark within the horizon → answer ``GetLogMsg`` (the
    #: log suffix IS the divergence, one streamed replay instead of the
    #: level walk); below it the peer weighs the servable suffix
    #: ``seq − log_horizon`` against the walk-bound prefix
    #: ``log_horizon − watermark`` — a dominant suffix (≥ the replica's
    #: ``catchup_suffix_ratio``) still streams as a horizon-clamped
    #: chunk run with only the prefix walking, anything less takes the
    #: classic ping-pong outright (the walk heals everything it finds,
    #: so chunks on top of a comparable walk are pure extra rounds).
    #: The decision rides the opener so data keeps flowing originator →
    #: peer only, exactly like the ``GetDiffMsg`` leaf fetch.
    log_horizon: int | None = None


@dataclasses.dataclass
class GetDiffMsg:
    """Peer asks the originator for its entries in differing buckets
    (reference ``{:get_diff, diff, keys}``, ``causal_crdt.ex:112-123``)."""

    originator: Hashable
    frm: Hashable
    to: Hashable
    buckets: np.ndarray  # int64[b] differing leaf-bucket indices


@dataclasses.dataclass
class EntriesMsg:
    """Entry slice transfer (reference ``{:diff, crdt_slice, keys}``)."""

    originator: Hashable
    frm: Hashable
    to: Hashable
    buckets: np.ndarray
    arrays: dict[str, np.ndarray]  # DotStore slice columns + ctx tables
    payloads: dict[tuple[int, int, int], tuple[Any, Any]]  # (gid, bucket, ctr) -> (key_term, value)


@dataclasses.dataclass
class GetLogMsg:
    """Log-shipping catch-up request: "ship me everything you applied
    past ``last_seq``". The server answers with one
    :class:`LogChunkMsg`; the requester paces the stream by
    re-requesting from each chunk's resume point while ``more`` is set,
    so the server stays stateless and a dead requester leaks nothing.

    ``last_seq`` is the RESUME CURSOR — after a horizon/barrier-clamped
    chunk it sits past spans the requester never received.
    ``applied_seq`` is the requester's honest COVERAGE CLAIM (its
    applied watermark), the only field the server may advance its
    membership-compaction ack floor from; conflating the two would let
    a resume past a barrier reclaim records the peer still needs. 0
    (the pre-field default on old builds) claims nothing."""

    frm: Hashable
    to: Hashable
    last_seq: int
    applied_seq: int = 0


@dataclasses.dataclass
class LogChunkMsg:
    """One bounded run of log-shipped catch-up state covering the
    server's applied range ``(seq_lo, seq_hi]``.

    ``slices`` is a list of full-row entry slices (``{"buckets",
    "arrays", "payloads"}`` — the exact :class:`EntriesMsg` body shape)
    for every bucket the server's WAL records in the range touched,
    deduplicated; the receiver feeds them through the normal idempotent
    entries-merge path. ``horizon`` is set when part of the requested
    range is unservable by log — the request's ``last_seq`` fell below
    the compaction horizon, or the next record is a serving BARRIER (an
    unknown kind, or a ``clear`` touching more buckets than the hard
    row cap): the chunk then covers only ``(horizon, seq_hi]`` (or
    nothing, for a barrier) and the span through ``horizon`` must heal
    by the classic digest walk, which the server opens alongside.
    Receivers must not advance their applied watermark across an
    unshipped span (the chunk connects only when their watermark ≥
    ``seq_lo``). ``more`` means records past the chunk remain —
    re-request from ``max(seq_hi, horizon)``."""

    frm: Hashable
    to: Hashable
    seq_lo: int  # exclusive lower bound actually served
    seq_hi: int  # inclusive upper bound actually served
    more: bool  # records past seq_hi remain: re-request from seq_hi
    horizon: int | None  # set when last_seq was compacted past (see above)
    slices: list  # [{"buckets": int64[b], "arrays": {...}, "payloads": {...}}]


@dataclasses.dataclass
class AckMsg:
    """Clears the originator's in-flight slot for `clear_addr`
    (reference ``{:ack_diff, to}``, ``causal_crdt.ex:82-84,406-412``)."""

    clear_addr: Hashable


@dataclasses.dataclass
class FleetFrameMsg:
    """Fleet-wide egress envelope: one wire frame carrying
    many fleet members' per-peer sync messages — eager-delta
    ``EntriesMsg`` slices and ``DiffMsg`` openers — to a co-located
    peer process, where the transport decodes it back into per-member
    mailbox deliveries. ``entries`` is an ordered list of
    ``(to_addr, message)`` pairs; per-(sender, receiver) message order
    is the list order, exactly what per-member sends would produce.

    This is a negotiated capability (the TCP transport's ``_FLEETF``
    frame kind behind the ``_FEAT_FLEET`` HELLO bit): a peer that never
    advertised it receives plain per-member frames instead, so
    mixed-version clusters keep converging message-for-message. Flat
    gossip rides it today; it is the frame hierarchical anti-entropy
    (ROADMAP) will coalesce on — an intermediate hop can rewrite
    ``entries`` without touching the inner messages.

    A replica handed the whole envelope (a transport without
    frame-level decode) fans it out itself: entries addressed to the
    replica dispatch locally, everything else forwards."""

    frm: Hashable  # sending process identity (diagnostics/tracing)
    entries: list  # [(to_addr, message), ...] in send order


def make_blocks(
    tree: list[np.ndarray], level: int, idx: np.ndarray, levels_per_round: int
) -> list[np.ndarray]:
    """Digest blocks for `levels_per_round` levels beneath frontier `idx`.

    ``blocks[j]`` holds digests at ``level+j`` for all descendants of the
    frontier, ordered (frontier position, subtree offset) — positions are
    derivable, so only digest values travel.
    """
    depth = len(tree) - 1
    end = min(level + levels_per_round, depth)
    blocks = [tree[level][idx]]
    for j in range(1, end - level + 1):
        child_idx = (idx[:, None] * (1 << j) + np.arange(1 << j)[None, :]).reshape(-1)
        blocks.append(tree[level + j][child_idx])
    return blocks


def walk(
    tree: list[np.ndarray],
    level: int,
    idx: np.ndarray,
    blocks: list[np.ndarray],
    max_frontier: float,
) -> tuple[int, np.ndarray]:
    """Compare a received block against the local tree.

    Returns ``(end_level, differing_idx)``: the deepest level the block
    reaches and the still-differing node indices there (truncated per
    level to ``max_frontier``, reference ``causal_crdt.ex:98,105``).
    """
    depth = len(tree) - 1
    cur = np.asarray(idx, dtype=np.int64)
    pos = np.arange(len(cur), dtype=np.int64)
    diff = tree[level][cur] != blocks[0][pos]
    cur, pos = cur[diff], pos[diff]
    j = 0
    while j + 1 < len(blocks) and len(cur):
        j += 1
        cur = np.stack([cur * 2, cur * 2 + 1], 1).reshape(-1)
        pos = np.stack([pos * 2, pos * 2 + 1], 1).reshape(-1)
        diff = tree[level + j][cur] != blocks[j][pos]
        cur, pos = cur[diff], pos[diff]
        if len(cur) > max_frontier:
            cur, pos = cur[: int(max_frontier)], pos[: int(max_frontier)]
    assert level + j <= depth
    return level + j, cur
