#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``delta_crdt_ex_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run: phases 1-13
    python3 chip_smoke.py --keys 131072   # phases 3, 3b, 8a, 8b, 9a, 9b, 10a and 10b at a cut key count
    python3 chip_smoke.py --only 3b       # the build and phase 3b alone (no result lines)
    python3 chip_smoke.py --only 45       # the build, phase 4 and phases 5 and 5p (no result lines)
    python3 chip_smoke.py --only 7        # the build and phase 7 alone (no result lines)
    python3 chip_smoke.py --only 8        # the build and phase 8 alone (no result lines)
    python3 chip_smoke.py --only 9        # the build and phase 9 alone (no result lines)
    python3 chip_smoke.py --only 10       # the build, phases 3 and 3b (the pairs phase 10 serves from) and phase 10
    python3 chip_smoke.py --only 11       # the build and phase 11 alone (no result lines)
    python3 chip_smoke.py --only 12       # the build and phase 12 alone (no result lines)
    python3 chip_smoke.py --only 13       # the build and phase 13 alone (no result lines)

Phases (each raises on failure; any failure exits nonzero):

1. build the port's CUDA kernels from ``delta_crdt_ex_tpu_torch/csrc/``
   (one ``nvcc`` per source, started together) and its native hasher
   from ``delta_crdt_ex_tpu_torch/native/fasthash.cpp`` (one ``g++``,
   beside them) and print each one's ptxas lines, the ``g++`` line, the
   card's name and its power limit;
2. kernels vs plain versions on the card: the probe-window lookup
   kernel against ``probe_lookup_ref`` on seeded tables at every shape
   of ``PROBE_SHAPES`` (H ∈ {8, 16, 256, 2^21}, W ∈ {1, 5, 8, 12, 16,
   32, 33, 128, 256}, writer tables of 8, 2048 and 4096 entries, Q up
   to 2^20 − 3; missing keys, windows that run off or end exactly at
   the table end, dead lanes, several live dots of one key, winners on
   every thread of a query's group, top-bit keys and gids), the whole
   int32 grid bit-equal; the roots kernel against ``batched_roots_ref``
   at N ∈ {1, 11, 64, 133, 4096} × L ∈ {1, 2, 4, 8, 16, 128, 2^14,
   2^20} (but N·L ≤ 2^28) at every cluster size and the picked one,
   top-bit leaves, every root bit-equal, swapped siblings and swapped
   leaves either side of a cluster boundary changing the root; then
   each kernel's duration by the profiler, its plain version's time and
   its memory bound at its headline shapes (``PROBE_TIMED``) or the
   main paths' shapes (``ROOTS_TIMED``), and its time by CUDA events at
   the first of them, the headline of the ``kernels`` line (the probe is
   timed again after phase 8 at every (H, W, Q) that phases 3 and 8b
   launched it at);
3. the slice: two threaded replicas on ``cuda``
   (``store="hash"``, sync_interval 20 ms, max_sync_size 500, an
   ``on_diffs`` subscriber each) — ``mutate_batch`` of an eighth of
   ``--keys`` keys (2^17 by default; cut from 2^20 so that the whole
   run, phase 8 included, stays inside its time limit) into replica 1
   until replica 2 holds them all, 10 single-op
   mutations timed to their arrival, 1% of the keys removed,
   ``read_keys`` of 4096 keys on both — then equal canonical bytes,
   every state tensor on the card, and the kernel launched on this path;
   last, the kernel against ``probe_lookup_ref`` on each replica's own
   final table (every written key, the removed ones and missing keys),
   the whole int32 grid bit-equal;
3b. the default replica at the same size: two threaded replicas on
   ``cuda`` with no ``store=`` (the binned store, L = 4096 buckets ×
   B = 512 slots at 2^20 keys; ingress coalescing on), the same
   configuration and steps as phase 3, replica 2 without a diff
   subscriber (its arrivals counted from its ``SYNC_DONE`` events), plus
   one full ``read()`` of replica 2 — then equal canonical bytes, reads
   equal to the written map, every state tensor on the card, grouped
   ingress dispatches, and neither kernel launched (this path runs
   none, as in the JAX package); every loaded key and value went
   through the native hasher (its counter), which is bit-equal to the
   ``hashlib`` path on 65536 seeded terms, and its load beside the
   ``hashlib`` path's hashing time for the same terms;
4. small deterministic scripts (``threaded=False``, ``LogicalClock``)
   on ``cuda`` and on ``cpu`` give identical ``canonical_state_bytes()``,
   diff feeds and ``stats()["ingress"]``: an ``AWLWWMap`` pair on the
   hash store and on the default store and an ``AWSet`` pair, each with
   subscribers, three senders coalescing into one receiver, and a
   4-member fleet on each store (two senders a member, a gap mid-group,
   fleet counters too); the
   fan-in of phase 5 at ``bench.py``'s smoke geometry (4096 keys,
   L = 2^8, B = 64, 4 neighbours, 4 × 128-entry deltas per call, 1 + 2
   calls) gives identical stack columns and roots on both, and so does
   the same fan-in on the packed layout (``pack_states`` →
   ``fanout_merge_packed`` in scomp and in top_k mode, and
   ``merge_slice_packed_fused``: identical words, aux tables, flags,
   counts and roots), and the growth script of
   ``tests/test_packed_parity.py`` (kill budget, bin tier and gid table
   all overflow) through ``fanout_merge_into`` on a packed stack;
5. the fan-in at full size (``bench.py``'s north star, column layout):
   ``build_state`` over 1,000,000 seeded keys (L = 2^14, B = 128, R = 8)
   broadcast to 64 neighbours, then 1 warm-up and 6 timed calls of
   ``fanout_merge(stack, slice, kill_budget=8, max_inserts=8192)`` and
   ``batched_roots(stack.leaf)`` over 16 × 512-entry interval deltas —
   merges/s as ``bench.py`` computes it (from per-call completion
   intervals, stamped here by CUDA events), per-call device and host
   enqueue times, the roots kernel's launches (exactly 7) and the
   device memory after set-up and at its peak; it checks
   every flag and count, every lane's alive count, the 64 lanes
   bit-equal, the incremental leaf against ``compact_rows``, the alive
   key set against the host's, and the final roots against
   ``batched_roots_ref``;
5p. the same fan-in on the packed layout (``bench.py``'s primary,
   ``packed_scomp``: ``fanout_merge_packed(scatter_compact=True,
   rows_sorted=True)``, then its A/B alternate ``packed_topk``), from
   phase 5's base state broadcast to 64 lanes and packed, over phase
   5's 7 delta groups, one stack freed before the next is built: the
   same metrics and a traced call each, the stack bytes of both
   layouts; checks: every flag and count, the 64 lanes' words and aux
   tables equal, ``unpack`` of lane 0 bit-equal to phase 5's final
   column lane 0, the final roots equal to phase 5's, the roots kernel
   launched 7 times a run and bit-equal to ``batched_roots_ref``;
6. ring gossip: 8 lanes of that geometry, each first given its own
   writer's 4096 fresh keys by ``merge_into``, then 7
   ``ring_gossip_round``s, each followed by the roots; every root and
   every leaf equal at the end, and every lane's content (alive entries
   and context over global writer ids) equal;
7. fleets, ``bench.py --fleet``'s legs on the card (members of 64
   buckets, capacity 1024, ``LogicalClock``, 4 fresh keys a sender a
   round, 1 warm-up + 3 timed rounds, the bench's 5 cut so that the run
   fits its time): the ingress leg (n senders each
   pushing to one fleet member and its solo twin; ``fleet.drain()``
   against the twins' ``process_pending()``) on the binned store at
   N = 256 and 1024 (512 only if the run would otherwise pass
   ``RUN_GUARD_S``) and on the hash store at N = 64, one more drain
   traced; the egress leg (``fleet.sync_tick()`` against the twins'
   ``sync_to_all()``, sink neighbours) at N = 256 binned and N = 64
   hash. ``[fleet]`` lines give merges/s or member syncs/s, round times,
   dispatches, occupancy, fill, fallbacks and stack-cache hits,
   ``[fleet-mem]`` lines the device memory after each round. It raises
   on any fleet/solo difference (state columns, canonical bytes, seqs,
   outbound messages), on state off the card, on memory that grows
   round over round by more than one batch, and on a kernel launch;
8. durability, each leg's WAL directories under ``build/wal/`` with
   the JAX package's WAL defaults (``fsync_mode="batch"``, 4 MiB
   segments): 8a two threaded default-store replicas with phase 3b's
   geometry, 2^20 keys loaded into replica 1 (2^18 when the run would
   otherwise pass ``RUN_GUARD_S``; the cut is logged) (1024 ``batch`` records, a
   compaction snapshot at the last), then 2^19 keys overwritten (512
   more records), replica 2 logging its merged slices as ``entries``
   records; both crash right after the overwrites (replica 2 still
   catching up on them) and restart from disk (snapshot + replay), and must come back with their
   pre-crash canonical bytes, reads, node ids and seqs, on the card,
   then catch up to equal canonical bytes and carry 10 new single-op
   writes to the peer. ``[durability]`` lines give the load time with
   the WAL, the append ms (median, p99), WAL and snapshot bytes, the
   compaction ms, the recovery seconds (the restart's wall time, and
   the ``WAL_RECOVER`` event's span from reading the log to the end of
   the replay), the records replayed, the catch-up seconds with each
   restarted replica's ``stats()["catchup"]`` (the replicas run the
   default ``log_shipping=True``), the post-recovery propagation ms and
   the peak memory. 8b the same on
   the hash store at 2^17 keys with diff subscribers (a snapshot every
   128 records), the probe kernel's launches before the crash, during
   the recovery and after it (``read_keys`` on the recovered tables),
   then the kernel held bit-equal to its plain version on both
   recovered tables at every Q the leg launched it at;
   8c phase 7a's ingress rounds into a 256-member binned fleet without
   and with a WAL per member, then every member crashed and recovered
   solo with equal canonical bytes. 8d runs in phase 4: a seeded
   ``SimNetwork`` (drops, duplicates, reordering) on three replicas per
   store, identical on cuda and cpu;
9. the TCP path: two ``TcpTransport``s on 127.0.0.1 in this process,
   each replica registered on its own and addressing its peer as
   ``(name, (host, port))``. 9a two threaded default-store replicas
   with phase 3b's geometry at 2^20 keys (2^18 only when the run would
   otherwise pass ``RUN_GUARD_S``; the cut is logged on the phase's
   line), a WAL each with the JAX package's defaults: the load on
   replica 1 in 1024-op batches converges over TCP, replica 2 takes a
   compaction checkpoint once its watermark reaches replica 1's seq and
   crashes (its node's transport stays up, so replica 1's pushes are
   lost in flight), 2^16 keys are written on replica 1, replica 2
   restarts from its ``wal_dir`` and catches up by log shipping.
   ``[tcp]`` lines give the load and convergence seconds, the wire
   (``transport_stats()``: bytes and frames by kind, ``_MSGB`` buffers
   raw against zlib), the restart and catch-up seconds, both replicas'
   ``stats()["catchup"]``, and 10 propagation ms with replica 2's
   mailbox before each; a ``[tcp-codec]`` line times the encoding of
   one 1024-row entries frame of the loaded map with the payload dicts
   C-pickled and spliced in and with the pure-Python pickler alone.
   Correct: equal canonical bytes, replica 2's ``read()`` equal to the
   written map, at least one chunk applied, state on the card, no
   kernel launched. 9b the same on the hash
   store at 2^17 keys with an ``on_diffs`` feed on each side (so the
   probe kernel runs on the TCP path; its launches by (H, W, Q) join
   the kernel line), 2^13 keys written while replica 2 is down; the
   feed must equal the written map, and the kernel must be bit-equal
   to its plain version on both final tables at every Q the leg
   launched it at (its error joins the kernel line's). 9c fleet
   frames: a 64-member binned fleet on transport A whose members each
   sync with one member of a 64-member fleet on transport B (phase 7's
   member shape), 1 warm-up + 5 timed rounds of 4 fresh keys a member and one ``sync_tick()`` a
   fleet; solo twins run the same rounds on their own transport pair.
   It prints member syncs/s and (frames, frame_members) a tick, times
   the codec on fleet A's last frame as 9a's line does, and raises
   unless every tick shipped one frame to the one endpoint and
   every member converged with its peer and equals its twin.
10. serving and observability, ``bench.py --serve``'s legs on the
   port's front door (``api.frontdoor``), run on the loaded pairs of
   phases 3 and 3b before they stop. 10a, phase 3b's pair (the default
   store at 2^20 keys, never cut), a front door with
   ``max_commit_ops=256`` on replica 1: leg A, 64 clients x 50 ops (the
   bench's 150 cut so that the run fits its time),
   grouped admission against the per-op ``mutate`` loop, in ops/s;
   leg B, 20 snapshot ``read_keys`` finish while replica 1's lock is
   held; the open-loop mix (70% single-key ``read_keys``, half of them
   on a 64-key hot pool, the rest uniform over the loaded keys; 30%
   writes; Poisson arrivals timed from the scheduled arrival; 16
   workers) at 30% and 70% of the calibrated closed-loop capacity,
   2.5 s each after one unmeasured soak, p50/p99 per class; one
   profiler trace (``tracing.trace``) of a 256-op admission commit and
   a 2048-key ``read_keys``: device busy share, top ops, spans; leg C,
   a fresh replica at the same geometry takes 32 x 50 concurrent ops
   through a journalling front door and an unloaded twin replays the
   journal through ``apply_ops`` (state columns, canonical bytes and
   WAL bytes bit-equal); the ``obs=True`` overhead (1024-op batches in
   turns with and without a plane); leg E, a 4 x 400 write spike
   against a 32-op window sheds and ``/healthz`` answers 503 over HTTP,
   then 200. 10b, phase 3's pair (the hash store at 2^17 keys, a feed
   on each side): the mix at 30%; snapshot reads launch the probe
   kernel from the client threads, and every (H, W, Q) the leg launched
   is held bit-equal to the plain version on the pinned snapshot's own
   table (its launches join the kernel line). 10c, a threaded
   4-member fleet (ring neighbours) behind its front door: 2^14 keys
   routed in, the mix at 30%, then every member reads the written map.
   Each leg checks that reads equal the written map, that every
   acknowledged write reads back from both replicas (every member in
   10c) and that the replicas converge to equal canonical bytes; 10a
   and 10c launch no kernel.
11. tree gossip (``tree_gossip=True``), every replica on the card. 11a,
   ``bench.py --tree``'s shape at full size: two universes of 256
   unthreaded default-store replicas (``LogicalClock``, capacity 512,
   ``replica_capacity`` 512, 64 buckets), each on a transport that costs
   every delivered message at its pickled size; the tree universe with
   fanout 8 and the full membership as neighbours (and a lag tracer at
   ``sample_every=1``), the flat one with 64 neighbours a replica picked
   by ``np.random.default_rng(7)``; 2 settle rounds, then 3 probes (one
   fewer, down to 1, for each ``TREE_PROBE_S`` the run would otherwise
   spend past ``RUN_GUARD_S``; the cut is logged) from a deepest-tier
   writer, each at most 12 global rounds (every
   replica's ``sync_to_all()``, then ``process_pending()`` until
   quiescent). It holds the bench's gates in the run — median
   propagation rounds at least 2x and bytes at least 1.5x better in the
   tree, every tree/flat pair canonical-equal, the lag tracer's
   ``crdt_propagation_rounds`` equal to the hand count — and prints
   rounds, messages and bytes a probe, seconds a global round, the
   relay's re-emits, folds and depth histogram and the tree's shape;
   then a tier-1 relay crashes: its observers derive one epoch, the
   membership update gives every survivor that epoch, one more probe
   reaches every survivor, and they end canonical-equal. 11b, 8
   threaded hash-store replicas (16 until a whole run passed 1200 s)
   in tree mode (fanout 4, depth 2) with
   phase 3's configuration and a feed each: 2^14 keys (an eighth of
   phase 3's, cut so that the run fits its time) into a tier-2 leaf until every
   replica holds them, 5 single-op writes timed to their arrival at the
   last replica, 1% removed, ``read_keys`` of 4096 keys on every
   replica; equal canonical bytes, every acknowledged write read back
   and every feed equal to the written map on all 8, one epoch with
   roles root, relay and leaf and relay re-emits; the probe kernel's
   launches by (H, W, Q) join the kernel line, and it is held bit-equal
   to its plain version on a tier-1 relay's own table at every Q the
   leg launched it at. 11c, phase 9c's two TCP endpoints with a
   64-member fleet each, in tree mode with all 128 members as every
   member's neighbours: one ``tree_group`` a fleet, exactly one member
   of each (its captain) linked to the other endpoint, writes on both
   fleets converged to equal canonical bytes on all 128; the wire from
   endpoint A prints beside 9c's flat figures.
12. the multi-device mesh, run right after phase 6 (it reuses the
   fan-in's base). 12a, ``bench.py --fleet --mesh``'s topology at its
   widths (64 members in one mesh fleet, member i gossiping with i + 32,
   a sink each, 4 fresh keys a member a round, depth 6; 3 timed rounds,
   the bench's 4 cut for time) on meshes of 1, 2, 4 and 8 shards, every
   shard on ``cuda:0``, binned, and at 8 shards on the hash store, each
   against a vmap fleet fed the same script: member-syncs/s and merges/s
   of both; every sink stream, state column, canonical byte, seq and
   in-flight slot equal; the plane's intra entries above 0 and its only
   fallback entries the sinks'. After the hash leg, ``read_keys`` on
   every member launches the probe kernel, held bit-equal to its plain
   version on every member's table. 12b, phase 7a's ingress leg at
   N = 256 on a 4-shard mesh fleet against solo twins (1 timed round, 7a's 3
   cut for time). 12c, ``gossip_delta_drive`` on 8 shards at phase 6's
   geometry (8 replicas from the fan-in's 1,000,000-key base, 2^14
   buckets, 4096 fresh entries each, the frontier the whole tree) until
   ``n_diff`` is 0: every root and every replica's content equal. 12d, a
   pair pinned to ``cuda:0`` converging 2^16 keys on the device plane
   (``replica.slice_place`` counted, every merge labelled ``device``)
   beside a pair on a bare ``"cuda"`` on the host plane. 12e, 12a at 2
   shards on ``cuda:0`` and ``cuda:1`` when the host has two cards;
   otherwise one line says only one card was present.
13. conformance on the card, run right after phase 12. 13a, a
   Horde-style registry (``examples/torch_registry.py`` at deployment
   size) on each store in turn, the hash store first: three threaded
   nodes on ``cuda`` (sync_interval 20 ms) register 2^16 names through
   ``mutate_batch``, a third from each node, each value ``(node, pid)``;
   1024 of them are registered again on two nodes at once and every
   node converges to one LWW winner; every name is looked up on every
   node through ``read_keys`` in batches of 2048; node b crashes and a
   survivor removes its names with ``mutate_batch("remove", ...)``.
   Both survivors read the dict oracle and hold equal canonical bytes;
   on the hash store every probe launch of the leg (the lookups) is
   held bit-equal to its plain version on the node's own table, and the
   launches are the ``kernels`` line's ``"registry"`` path. 13b, the
   history of ``tests/test_soak.py``'s ``_run_soak`` (this script's own
   copy) at 6 replicas × 300 ops: seed 31 on the binned store, seed 32
   on the hash store with every other replica pinned to ``cuda:0``,
   checked against the dict oracle at every heal; past ``RUN_GUARD_S``
   it draws no more ops and logs the cut. 13c,
   ``examples/torch_quickstart.py`` and ``examples/torch_registry.py``
   as subprocesses on the card, started together when 13b starts and
   running beside it; each must exit 0.

Metrics print on their own lines, then the seconds each phase took, then each kernel's launches ×
(kernel time − bound) by timed shape; the line before the last is the
kernel table as JSON, the last line is the device record. The script
imports nothing of JAX or of the JAX package, and exits nonzero without
a result when CUDA is absent or the port is not beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: phase 3 deadline, seconds
SLICE_BUDGET_S = 600.0


def log(*a) -> None:
    print(*a, flush=True)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# phase 1: build


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from delta_crdt_ex_tpu_torch import native
    from delta_crdt_ex_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        hasher = pool.submit(native.build)  # one g++ beside the nvcc builds
        built = kernels.build_all(verbose=True)
        for name, (path, out) in built.items():
            for line in out.splitlines():
                if "registers" in line or "spill" in line or "error" in line.lower():
                    log(f"[build]   {name}: {line.strip()}")
            log(f"[build] {name}: {path.name}")
        so, out = hasher.result()
    log(f"[build] native hasher: {native.gxx()} {' '.join(native.GXX_FLAGS)} "
        f"{native.SRC.relative_to(Path(__file__).resolve().parent)} -> {so.name}"
        + (f"; g++ said: {out.strip()}" if out.strip() else ""))
    log(f"[build] {len(built)} kernels and the native hasher built in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain


def ref_chunked(qk, st):
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_ref

    step = max(1, (1 << 24) // st.probe_window)
    return torch.cat([probe_lookup_ref(qk[i : i + step], st) for i in range(0, len(qk), step)])


#: device spin before each timed call (about 0.5 ms): the host enqueues
#: the call while the device is busy, so the timed interval holds the
#: device's work and not the host's Python
SPIN_CYCLES = 1_000_000


def time_ms(fn, reps: int, flush=None) -> tuple[float, float]:
    """``(device ms, host ms)`` of one ``fn()`` call, means over ``reps``
    calls: device time by CUDA events around each call, recorded while
    the device still spins (so the host's enqueue is not in it), host
    time by the host clock around the enqueue. ``flush()`` runs between
    calls, untimed."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev = host = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        b.record()
        b.synchronize()
        dev += a.elapsed_time(b)
    return dev / reps, host * 1e3 / reps


def probe_bound_bytes(qk, st) -> int:
    """The bytes the probe lookup must move for these inputs, each read
    once: key + alive of every distinct window lane, node + ctr + ts +
    valh of every distinct alive key-matching lane, the writer table,
    the query hashes and the int32[Q, 8] grid."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import _window

    H = st.table_size
    lanes = torch.zeros(H, dtype=torch.bool, device=qk.device)
    hits = torch.zeros(H, dtype=torch.bool, device=qk.device)
    step = max(1, (1 << 24) // st.probe_window)
    for i in range(0, len(qk), step):
        q = qk[i : i + step]
        slots, ok = _window(q, H, st.probe_window)
        s = slots[ok].to(torch.int64)
        lanes[s] = True
        sg = slots.clamp(0, H - 1).to(torch.int64)
        m = ok & st.alive[sg] & (st.key[sg] == q[:, None])
        hits[sg[m]] = True
    n_lanes, n_hits = int(lanes.sum()), int(hits.sum())
    return n_lanes * (8 + 1) + n_hits * (4 + 8 + 8 + 8) + st.replica_capacity * 8 + len(qk) * (8 + 32)


#: probe shapes held bit-equal in phase 2: (H, W, R, Qs); the first
#: block is the original grid, then windows that are not a multiple of 4 or of
#: the thread group, the smallest tables, and writer tables at and past
#: the kernel's shared-memory cap (2048 entries)
PROBE_SHAPES = (
    [(H, W, 8, (8, 2048, 4096, (1 << 20) - 3)) for H in (256, 1 << 21) for W in (8, 32, 128, 256)]
    + [(H, W, 8, (8, 2048, (1 << 20) - 3)) for H in (256, 1 << 21) for W in (1, 12, 33)]
    + [(8, W, 8, (8, 2048)) for W in (1, 5, 8)]
    + [(16, W, 8, (8, 2048)) for W in (1, 12, 16)]
    + [(1 << 21, 32, R, (2048, (1 << 20) - 3)) for R in (2048, 4096)]
)


def phase_kernel_vs_plain() -> int:
    """The probe kernel against ``probe_lookup_ref`` at every shape of
    :data:`PROBE_SHAPES`; returns the max abs error (0)."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_base, probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.utils.probe_tables import queries, seeded_table

    dev = torch.device("cuda")
    max_err = 0
    shapes = 0
    edge_rows = off_first = 0
    for H, W, R, Qs in PROBE_SHAPES:
        st, keys = seeded_table(H, W, max(H // 8, 16), seed=H * 7 + W + R, device=dev, R=R)
        for Q in Qs:
            qk = queries(keys, Q, seed=Q + W)
            got = probe_lookup_kernel(qk, st)
            want = ref_chunked(qk, st)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            found = want[:, 0] == 1
            base = probe_base(qk, H).to(torch.int64)
            edge = int((base + W == H).sum())
            # winners read from a thread other than the group's first
            off = int((found & ((want[:, 1].to(torch.int64) - base) // 4 % probe_lookup_kernel.group(W) != 0)).sum())
            edge_rows += edge
            off_first += off
            log(f"[kernel] H={H} W={W} R={R} Q={Q}: found {int(found.sum())}/{Q}, windows ending at the "
                f"table end {edge}, winners off the group's first thread {off}, max_abs_err {err}")
            if err != 0:
                bad = torch.nonzero((got != want).any(dim=1))[:4, 0]
                raise AssertionError(
                    f"probe kernel disagrees with probe_lookup_ref at H={H} W={W} R={R} "
                    f"Q={Q}: rows {bad.tolist()}: kernel {got[bad].tolist()} "
                    f"plain {want[bad].tolist()}"
                )
            shapes += 1
    if edge_rows == 0 or off_first == 0:
        raise AssertionError(f"probe shapes lack windows ending at the table end ({edge_rows}) or "
                             f"winners off a group's first thread ({off_first})")
    log(f"[kernel] probe: {shapes} shapes bit-equal ({edge_rows} windows ending at the table end, "
        f"{off_first} winners off the group's first thread); max_abs_err {max_err}")
    return max_err


def roots_bound_ms(n: int, L: int) -> float:
    """Least time of the roots fold: N·L int64 leaves read once and N
    int64 roots written, at 3.35 TB/s."""
    return (n * L * 8 + n * 8) / HBM_BYTES_PER_S * 1e3


def random_leaves(n: int, L: int, seed: int):
    """int64[n, L] uint32 values on the card, half with the top bit set."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 2**32, (n, L), dtype=torch.int64, device="cuda", generator=g)


def phase_roots_vs_plain() -> int:
    """The roots kernel against ``batched_roots_ref`` at N ∈ {1, 11, 64,
    133, 4096} × L ∈ {1, 2, 4, 8, 16, 128, 2^14, 2^20} (N·L ≤ 2^28), at
    every cluster size C ≤ min(8, L) and at the one the wrapper picks;
    swapped siblings, and swapped leaves either side of each cluster
    boundary L/C, change the root. Returns the max abs error (0)."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel, batched_roots_ref

    max_err = 0
    shapes = 0
    for n in (1, 11, 64, 133, 4096):
        for L in (1, 2, 4, 8, 16, 128, 1 << 14, 1 << 20):
            if n * L > 1 << 28:  # 2 GiB of leaves: the plain fold's temporaries would not fit
                continue
            leaf = random_leaves(n, L, seed=n * 31 + L)
            want = batched_roots_ref(leaf)
            top = int((leaf >= 2**31).sum())
            for c in (None, 1, 2, 4, 8):
                if c is not None and c > L:
                    continue
                got = batched_roots_kernel(leaf, cluster=c)
                torch.cuda.synchronize()
                err = int((got - want).abs().max())
                max_err = max(max_err, err)
                c_used = batched_roots_kernel.cluster_for(n, L, leaf.device) if c is None else c
                log(f"[kernel] roots N={n} L={L} cluster={c_used}{' (picked)' if c is None else ''}: "
                    f"{top} top-bit leaves, max_abs_err {err}")
                if err != 0:
                    bad = torch.nonzero(got != want)[:4, 0]
                    raise AssertionError(
                        f"roots kernel disagrees with batched_roots_ref at N={n} L={L} cluster={c_used}: "
                        f"rows {bad.tolist()}: kernel {got[bad].tolist()} plain {want[bad].tolist()}"
                    )
                shapes += 1
            del leaf, want
    swaps = 0
    for L in (2, 16, 128, 1 << 14):
        for c in (1, 2, 4, 8):
            if c > L:
                continue
            # siblings 0 and 1, then the leaves either side of the boundary L/C
            for i, j in ((0, 1),) + (((L // c - 1, L // c),) if c > 1 else ()):
                leaf = torch.zeros((2, L), dtype=torch.int64, device="cuda")
                leaf[0, i] = leaf[1, j] = 0xDEADBEEF
                r = batched_roots_kernel(leaf, cluster=c)
                if int(r[0]) == int(r[1]) or not torch.equal(r, batched_roots_ref(leaf)):
                    raise AssertionError(
                        f"roots kernel: leaves {i} and {j} swapped at L={L} cluster={c} give roots {r.tolist()}")
                swaps += 1
    torch.cuda.empty_cache()
    log(f"[kernel] roots: {shapes} shape x cluster cases bit-equal, {swaps} swaps (siblings and "
        f"cluster boundaries) change the root; max_abs_err {max_err}")
    return max_err


#: probe headline shapes (H, W, Q, share of queries that hit): the
#: headline of the ``kernels`` line, its shape since the kernel was
#: ported: 2^20 queries on a 2^21-lane table; then the same with every
#: query missing (so only the windows are read). The shapes the replica
#: paths launch at are timed after them (:func:`path_probe_rows`)
PROBE_TIMED = [(1 << 21, 32, 1 << 20, 0.75), (1 << 21, 32, 1 << 20, 0.0)]
#: the hit share of the path shapes' timing tables (as the headline's)
PATH_HITS = 0.75
#: roots timing shapes (N, L); the first is the headline, its shape since
#: the kernel was ported: the fan-in's 64 lanes; then gossip's 8 and a
#: wide batch
ROOTS_TIMED = [(64, 1 << 14), (8, 1 << 14), (4096, 1 << 14)]


#: profiling windows :func:`kernel_us` tries before it times by events
PROFILE_WINDOWS = 6


def kernel_us(fn, flush, name: str, reps: int = 10) -> tuple[float, str]:
    """``(us, method)``: the mean duration of the device kernels whose
    name holds ``name`` over ``reps`` calls of ``fn()`` (``flush()``
    between them), as ``torch.profiler`` (CUPTI) records them: the
    kernel alone, without the launch and event overhead that
    :func:`time_ms` includes (method ``"profiler"``). When no window
    records the kernel, the mean by CUDA events (method ``"events"``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # late in a run (after the replica paths) the first profiling window
    # of a shape mostly comes back without the kernel's record, the
    # second now and then, and once (H100, torch 2.11) the first three;
    # such a window is profiled again, and if none records it the kernel
    # is timed by events, which time_ms's spin keeps free of the enqueue
    for window in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.device_time_total for e in hits) / count, "profiler"
        log(f"[kernel-time] profiling window {window + 1} recorded no {name} kernel")
    log(f"[kernel-time] no profiling window of {PROFILE_WINDOWS} recorded a {name} kernel: timed by CUDA events")
    return time_ms(fn, reps, flush)[0] * 1e3, "events"


def kernel_timings(device_name: str, probe_shapes=PROBE_TIMED, roots_shapes=ROOTS_TIMED,
                   head: bool = True) -> dict:
    """Each kernel's duration by the profiler at every shape of
    ``probe_shapes`` and ``roots_shapes`` (L2 flushed between calls),
    beside its plain version's time and its byte bound; with ``head``, at
    each kernel's first (headline) shape also its time by CUDA events
    (:func:`time_ms`), the method of the ``ms`` of earlier ``kernels``
    lines. Probe tables hold H / 8 seeded keys."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel, probe_lookup_ref
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel, batched_roots_ref
    from delta_crdt_ex_tpu_torch.utils.probe_tables import queries, seeded_table

    dev = torch.device("cuda")
    scratch = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # 128 MiB > L2
    flush = lambda: scratch.random_(0, 255)

    def timed(fn, plain, name: str, head: bool, plain_reps: int) -> dict:
        us, method = kernel_us(fn, flush, name)
        row = {"kernel_ms": us / 1e3, "kernel_ms_by": method, "plain_ms": time_ms(plain, plain_reps, flush)[0]}
        if head:
            row["ms"], row["host_ms"] = time_ms(fn, 20, flush)
        return row

    def show(row: dict) -> str:
        ev = f" ({row['ms']:.6f} ms by events, host enqueue {row['host_ms']:.6f} ms)" if "ms" in row else ""
        return (f"kernel {row['kernel_ms']:.6f} ms by {row['kernel_ms_by']}{ev}, plain {row['plain_ms']:.6f} ms, bound "
                f"{row['bound_ms']:.6f} ms, kernel/bound {row['kernel_ms'] / row['bound_ms']:.3f} on {device_name}")

    rows: dict = {"probe": [], "roots": []}
    tables: dict = {}
    for i, (H, W, Q, hit) in enumerate(probe_shapes):
        if (H, W) not in tables:
            tables[(H, W)] = seeded_table(H, W, H // 8, seed=H * 7 + W, device=dev)
        st, keys = tables[(H, W)]
        qk = queries(keys, Q, seed=99, hit=hit)
        row = {"shape": {"H": H, "W": W, "Q": Q, "hits": hit}}
        row.update(timed(lambda: probe_lookup_kernel(qk, st), lambda: probe_lookup_ref(qk, st),
                         "probe_lookup", head and i == 0, 5 if Q > 8192 else 20))
        nbytes = probe_bound_bytes(qk, st)
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[kernel-time] probe_lookup H={H} W={W} Q={Q} hits {hit} (L2 flushed between calls, bound "
            f"{nbytes} B at 3.35 TB/s): {show(row)}")
        rows["probe"].append(row)
    del tables
    for i, (n, L) in enumerate(roots_shapes):
        leaf = random_leaves(n, L, seed=7 + n)
        row = {"shape": {"N": n, "L": L}}
        row.update(timed(lambda: batched_roots_kernel(leaf), lambda: batched_roots_ref(leaf),
                         "batched_roots", head and i == 0, 20))
        row["bound_ms"] = roots_bound_ms(n, L)
        log(f"[kernel-time] batched_roots N={n} L={L} (L2 flushed between calls, bound "
            f"{n * L * 8 + n * 8} B at 3.35 TB/s): {show(row)}")
        rows["roots"].append(row)
    return rows


def probe_shape_launches() -> dict:
    """The probe wrapper's launches since its last reset by the shape it
    launched at, keyed ``"HxWxQ"``."""
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel

    return {f"{H}x{W}x{Q}": n for (H, W, Q), n in sorted(probe_lookup_kernel.launches_by_shape.items())}


def path_probe_rows(device_name: str, by_shape: dict, skip: set) -> list:
    """The probe kernel timed as :func:`kernel_timings` times it, at
    every (H, W, Q) in ``by_shape`` (the replica paths' launches by
    shape) but those in ``skip``, each row with its launches."""
    shapes = sorted(tuple(int(x) for x in k.split("x")) for k in by_shape if k not in skip)
    rows = kernel_timings(device_name, [(H, W, Q, PATH_HITS) for H, W, Q in shapes], [], head=False)["probe"]
    for row in rows:
        sh = row["shape"]
        row["launches"] = by_shape[f"{sh['H']}x{sh['W']}x{sh['Q']}"]
    return rows


def kernel_row(kernel, max_err: int, timed: list) -> dict:
    """The kernel's entry of the ``kernels`` JSON line. Its headline
    numbers are those of the first timed shape (``ms`` by CUDA events,
    as in earlier lines); every timed shape is listed under ``shapes``
    with the profiler's ``kernel_ms`` (launches filled in after the main
    paths)."""
    head = timed[0]
    return {
        "name": kernel.name,
        "route": "cuda",
        "source": kernel.source,
        "replaces": kernel.replaces,
        "launches": 0,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        # no single PyTorch call computes the probe grid or the digest-tree fold
        "library_ms": None,
        "shapes": timed,
    }


# ---------------------------------------------------------------------------
# phase 3: the slice at full size


class DiffLog:
    """``on_diffs`` subscriber: the latest read value per key as the
    feed reports it, plus arrival times of watched keys."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.view: dict = {}
        self.events = 0
        self.seen_at: dict = {}

    def __call__(self, diffs) -> None:
        now = time.perf_counter()
        with self.lock:
            for d in diffs:
                self.events += 1
                if d[0] == "add":
                    self.view[d[1]] = d[2]
                else:
                    self.view.pop(d[1], None)
                self.seen_at[d[1]] = now

    def wait(self, pred, deadline: float, what: str) -> None:
        while True:
            with self.lock:
                if pred(self):
                    return
            if time.perf_counter() > deadline:
                raise TimeoutError(f"timed out waiting for {what}")
            time.sleep(0.005)


def check_main_tables(reps, n_keys: int, removed: list, extra: list = (), q_sizes=(), quiet: bool = False) -> int:
    """The probe kernel against ``probe_lookup_ref`` on each replica's
    own final table (``reps`` holds replicas, or ``(name, state)``
    pairs for tables held elsewhere, such as a pinned snapshot's):
    queries are every written key (``key0``… and
    ``extra``, removed ones included) and 4096 missing keys; the whole
    grid must be bit-equal and find exactly the keys still present.
    Then, at each Q in ``q_sizes`` (the Q a path launched the kernel
    at), Q queries, three quarters written keys and a quarter missing
    ones, must be bit-equal too. Returns the max abs error."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.utils.hashing import key_hash64_batch

    terms = [f"key{i}" for i in range(n_keys)] + list(extra)
    written = np.asarray(key_hash64_batch(terms), np.uint64)
    miss = np.random.default_rng(17).integers(0, 2**63, 4096, dtype=np.int64).view(np.uint64) | np.uint64(1 << 63)
    grids = [np.concatenate([written, miss]).view(np.int64)]
    for q in q_sizes:
        n_miss = min(q // 4, len(miss))
        grids.append(np.concatenate([written[: q - n_miss], miss[:n_miss]]).view(np.int64))
    max_err = 0
    for r in reps:
        if isinstance(r, tuple):
            name, st = r
        else:
            name = r.name
            with r._lock:
                st = r.state
        for g, hashes in enumerate(grids):
            qk = torch.from_numpy(hashes.copy()).to(st.key.device)
            # (a rehearsal on the CPU has no kernel: it checks the grids)
            got = probe_lookup_kernel(qk, st) if qk.is_cuda else ref_chunked(qk, st)
            want = ref_chunked(qk, st)
            if qk.is_cuda:
                torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            if err != 0:
                bad = torch.nonzero((got != want).any(dim=1))[:4, 0]
                raise AssertionError(
                    f"{name}: probe kernel disagrees with probe_lookup_ref on the main "
                    f"path's table at Q={len(hashes)}: rows {bad.tolist()}: kernel {got[bad].tolist()} "
                    f"plain {want[bad].tolist()}"
                )
            if g:
                continue
            found = int(want[: len(terms), 0].sum()), int(want[len(terms):, 0].sum())
            if found != (len(terms) - len(removed), 0):
                raise AssertionError(f"{name}: probe grid found {found}, want ({len(terms) - len(removed)}, 0)")
        if quiet:
            continue
        log(f"[slice] {name}: kernel vs plain on the main path's table (H={st.table_size} "
            f"W={st.probe_window}) at Q={[len(h) for h in grids]}: bit-equal, the first grid found "
            f"{found[0]} written + {found[1]} missing, max_abs_err 0")
    return max_err


def phase_slice(n_keys: int, device: str = "cuda", serve=None) -> dict:
    """Phase 3; ``serve(reps, logs, want)``, when given, runs on the
    loaded pair after the phase's checks (phase 10b) and its result is
    the metrics' ``"serve"`` entry."""
    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    budget_s = SLICE_BUDGET_S

    t = LocalTransport()
    logs = (DiffLog(), DiffLog())
    reps = [
        dc.start_link(
            dc.AWLWWMap, store="hash", name=f"smoke{i}", transport=t,
            sync_interval=0.02, max_sync_size=500, on_diffs=logs[i],
            capacity=2 * n_keys, device=device,
        )
        for i in range(2)
    ]
    r1, r2 = reps
    deadline = time.perf_counter() + budget_s
    metrics: dict = {"keys": n_keys}
    try:
        dc.set_neighbours(r1, [r2])
        dc.set_neighbours(r2, [r1])
        probe_lookup_kernel.reset()  # the main path's run starts here

        t0 = time.perf_counter()
        dc.mutate_batch(r1, "add", [[f"key{i}", i] for i in range(n_keys)], timeout=budget_s)
        metrics["load_s"] = time.perf_counter() - t0
        logs[1].wait(lambda d: len(d.view) >= n_keys, deadline, f"{n_keys} keys on replica 2")
        metrics["converge_s"] = time.perf_counter() - t0
        log(f"[slice] {n_keys} keys: mutate_batch {metrics['load_s']:.3f} s, "
            f"on replica 2 after {metrics['converge_s']:.3f} s")

        lat = []
        for i in range(10):
            t1 = time.perf_counter()
            dc.mutate(r1, "add", [f"prop{i}", i])
            logs[1].wait(lambda d: d.view.get(f"prop{i}") == i, deadline, f"prop{i}")
            lat.append(logs[1].seen_at[f"prop{i}"] - t1)
        metrics["propagation_ms"] = [x * 1e3 for x in lat]
        log(f"[slice] 10 single-op propagations (ms): {[round(x * 1e3, 3) for x in lat]} "
            f"median {float(np.median(lat)) * 1e3:.3f}")

        removed = [f"key{i}" for i in range(0, n_keys, 100)]
        t1 = time.perf_counter()
        dc.mutate_batch(r1, "remove", [[k] for k in removed], timeout=budget_s)
        logs[1].wait(lambda d: all(k not in d.view for k in removed[-8:]) and len(d.view) == n_keys + 10 - len(removed),
                     deadline, "removes on replica 2")
        metrics["remove_converge_s"] = time.perf_counter() - t1
        log(f"[slice] removed {len(removed)} keys; on replica 2 after {metrics['remove_converge_s']:.3f} s")

        probe = [f"key{i}" for i in range(0, n_keys, max(1, n_keys // 4096))][:4096]
        t1 = time.perf_counter()
        got1 = dc.read_keys(r1, probe)
        metrics["read_keys_ms"] = (time.perf_counter() - t1) * 1e3
        got2 = dc.read_keys(r2, probe)
        want = {k: int(k[3:]) for k in probe if int(k[3:]) % 100 != 0}
        if got1 != want or got2 != want:
            raise AssertionError("read_keys disagrees with the written map")
        log(f"[slice] read_keys {len(probe)} keys on both replicas agree "
            f"({metrics['read_keys_ms']:.3f} ms on replica 1)")

        # settle: the loops keep syncing until both canonical
        # projections agree (nothing writes any more)
        while True:
            c1, c2 = r1.canonical_state_bytes(), r2.canonical_state_bytes()
            if c1 == c2:
                break
            if time.perf_counter() > deadline:
                raise AssertionError("replicas did not converge to equal canonical bytes")
            time.sleep(0.1)
        for r in reps:
            for name, v in vars(r.state).items():
                if isinstance(v, torch.Tensor) and v.device.type != device:
                    raise AssertionError(f"{r.name}: state column {name} is not on {device}")
        metrics["table_size"] = r1.state.table_size
        metrics["launches"] = probe_lookup_kernel.launches
        metrics["launches_by_shape"] = probe_shape_launches()
        if metrics["launches"] <= 0:
            raise AssertionError("the probe kernel was not launched on the main path")
        metrics["canonical_bytes"] = len(c1)
        log(f"[slice] canonical bytes equal ({len(c1)} B); table {r1.state.table_size} lanes; "
            f"probe kernel launches on the main path: {metrics['launches']}, by HxWxQ "
            f"{metrics['launches_by_shape']}")
        # launches below compare the kernel with its plain version and
        # are not the main path's
        metrics["table_max_abs_err"] = check_main_tables(reps, n_keys, removed)
        if serve is not None:
            want = {f"key{i}": i for i in range(n_keys) if i % 100 != 0}
            want.update({f"prop{i}": i for i in range(10)})
            metrics["serve"] = serve(reps, logs, want)
        return metrics
    finally:
        for r in reps:
            r.stop()


# ---------------------------------------------------------------------------
# phase 3b: the default (binned) replica at full size


class SyncDoneCount:
    """``SYNC_DONE`` handler for one replica: the running sum of its
    ``keys_updated_count`` and when it last moved."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.lock = threading.Lock()
        self.total = 0
        self.moved_at = 0.0

    def __call__(self, _event, meas, meta) -> None:
        if meta["name"] != self.name or not meas["keys_updated_count"]:
            return
        with self.lock:
            self.total += meas["keys_updated_count"]
            self.moved_at = time.perf_counter()

    def wait(self, total: int, deadline: float, what: str) -> float:
        """Wait until the sum reaches ``total``; returns when it moved last."""
        while True:
            with self.lock:
                if self.total >= total:
                    return self.moved_at
            if time.perf_counter() > deadline:
                raise TimeoutError(f"timed out waiting for {what} ({self.total} of {total})")
            time.sleep(0.002)


def timed_propagations(r1, r2, transport, arrivals, deadline: float, key) -> dict:
    """10 single-op writes on ``r1``, each timed to its arrival at ``r2``
    (``SYNC_DONE``), with ``r2``'s mailbox depth before each write and
    the messages its ingress handled until the arrival: a backlog of
    earlier slices queued ahead of the write shows there."""
    import delta_crdt_ex_tpu_torch as dc

    lat, queued, handled = [], [], []
    for i in range(10):
        queued.append(transport.queue_depth(r2.addr))
        # stats() may wait for r2's lock while a merge finishes: read it
        # before the arrival base, so no merge lands between the two
        h0 = r2.stats()["ingress"]["messages"]
        base = arrivals.total
        t1 = time.perf_counter()
        dc.mutate(r1, "add", [key(i), i])
        lat.append(arrivals.wait(base + 1, deadline, f"single-op write {i}") - t1)
        handled.append(r2.stats()["ingress"]["messages"] - h0)
    return {"propagation_ms": [x * 1e3 for x in lat], "queued_before": queued, "handled_during": handled}


def batch_breakdown(r, n_ops: int = 1024) -> dict:
    """Where one mutation batch of the binned load goes: host-clock
    times of its steps on ``n_ops`` fresh keys (hashing the terms,
    grouping by bucket, the uploads, ``row_apply`` enqueued and then
    finished on the card; the state is read, not replaced), then one
    whole ``mutate_batch`` of ``n_ops`` other fresh keys under the
    profiler (it does write them)."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD
    from delta_crdt_ex_tpu_torch.utils.hashing import key_hash64_batch, value_hash32_batch

    terms = [f"breakdown{i}" for i in range(n_ops)]
    out: dict = {"ops": n_ops}
    with r._lock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        key = np.asarray(key_hash64_batch(terms), np.uint64)
        valh = np.asarray(value_hash32_batch(list(range(n_ops))), np.uint32)
        t1 = time.perf_counter()
        g = r.model.group_batch(r.num_buckets, np.full(n_ops, OP_ADD, np.int32), key, valh,
                                np.arange(n_ops, dtype=np.int64))
        t2 = time.perf_counter()
        args = (r._i64_tensor(g.rows), torch.from_numpy(g.op.copy()).to(r.device),
                r._u64_tensor(g.key), r._i64_tensor(g.valh), r._i64_tensor(g.ts))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        res = r.model.row_apply(r.state, r.self_slot, *args)
        t4 = time.perf_counter()
        ok = bool(res.ok)
        t5 = time.perf_counter()
        out.update(hash_ms=(t1 - t0) * 1e3, group_ms=(t2 - t1) * 1e3, upload_ms=(t3 - t2) * 1e3,
                   row_apply_enqueue_ms=(t4 - t3) * 1e3, row_apply_finish_ms=(t5 - t4) * 1e3,
                   shape=list(g.op.shape), ok=ok)
    items = [[f"traced{i}", i] for i in range(n_ops)]
    out["batch_trace"] = trace_call(lambda: r.mutate_batch("add", items))
    return out


#: seeded terms the native hasher is held bit-equal to ``hashlib`` on
HASHER_TERMS = 65536


def seeded_terms(n: int, seed: int = 10) -> list:
    """``n`` terms of every canonical kind the replicas hash: strings,
    wide ints, byte strings of 0-300 bytes (across the 128-byte block
    edge), tuples, floats, None, nested lists."""
    g = np.random.default_rng(seed)
    ints = g.integers(-(2**62), 2**62, n).tolist()
    lens = g.integers(0, 300, n).tolist()
    out = []
    for i in range(n):
        kind = i % 6
        if kind == 0:
            out.append(f"term{ints[i]}")
        elif kind == 1:
            out.append(ints[i] * (1 << (i % 70)))
        elif kind == 2:
            out.append(g.bytes(lens[i]))
        elif kind == 3:
            out.append(("k", ints[i], i))
        elif kind == 4:
            out.append(ints[i] / 7.0 if i % 5 else None)
        else:
            out.append([i, [str(ints[i])], {"n": i}])
    return out


def hasher_check(n_keys: int, device_name: str) -> dict:
    """The native hasher against the ``hashlib`` path on
    :data:`HASHER_TERMS` seeded terms (bit-equal or raise), then both
    hashing the terms of phase 3b's load (``n_keys`` keys and values),
    timed on the card's host."""
    from delta_crdt_ex_tpu_torch.utils import hashing as h

    terms = seeded_terms(HASHER_TERMS)
    for fast, ref in ((h.key_hash64_batch, h.key_hash64_batch_ref), (h.value_hash32_batch, h.value_hash32_batch_ref)):
        got, want = fast(terms), ref(terms)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            bad = np.nonzero(got != want)[0][:4].tolist()
            raise AssertionError(f"native {fast.__name__} differs from hashlib at terms {bad}")
    keys, values = [f"key{i}" for i in range(n_keys)], list(range(n_keys))
    m: dict = {"terms_checked": len(terms)}
    for tag, kf, vf in (("native", h.key_hash64_batch, h.value_hash32_batch),
                        ("hashlib", h.key_hash64_batch_ref, h.value_hash32_batch_ref)):
        t0 = time.perf_counter()
        kf(keys)
        vf(values)
        m[f"load_hash_{tag}_s"] = time.perf_counter() - t0
    log(f"[hasher] native hasher bit-equal to hashlib on {len(terms)} seeded terms (key ids and value "
        f"digests); hashing phase 3b's {n_keys} keys and values: native {m['load_hash_native_s']:.3f} s, "
        f"hashlib {m['load_hash_hashlib_s']:.3f} s on the host of {device_name}")
    return m


def phase_binned(n_keys: int, device_name: str, device: str = "cuda", serve=None) -> dict:
    """Phase 3b; ``serve(reps, transport, want)``, when given, runs on the
    loaded pair after the phase's checks (phase 10a), its result the
    metrics' ``"serve"`` entry."""
    import dataclasses

    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch import native
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel
    from delta_crdt_ex_tpu_torch.runtime import telemetry
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    hasher = hasher_check(n_keys, device_name)
    t = LocalTransport()
    arrivals = SyncDoneCount("binned1")
    telemetry.attach(telemetry.SYNC_DONE, arrivals)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reps = [
        dc.start_link(dc.AWLWWMap, name=f"binned{i}", transport=t, sync_interval=0.02,
                      max_sync_size=500, capacity=2 * n_keys, device=device)
        for i in range(2)
    ]
    r1, r2 = reps
    deadline = time.perf_counter() + SLICE_BUDGET_S
    m: dict = {"keys": n_keys, "buckets": r1.num_buckets, "bin_capacity": r1.state.bin_capacity, "hasher": hasher}
    try:
        dc.set_neighbours(r1, [r2])
        dc.set_neighbours(r2, [r1])
        probe_lookup_kernel.reset()  # this path's run starts here: it launches neither kernel
        batched_roots_kernel.reset()

        native.reset_counts()
        t0 = time.perf_counter()
        dc.mutate_batch(r1, "add", [[f"key{i}", i] for i in range(n_keys)], timeout=SLICE_BUDGET_S)
        m["load_s"] = time.perf_counter() - t0
        m["native_hashed"] = native.counts()
        m["converge_s"] = arrivals.wait(n_keys, deadline, f"{n_keys} keys on replica 2") - t0
        log(f"[binned] {n_keys} keys (L={r1.num_buckets} B={r1.state.bin_capacity}): mutate_batch "
            f"{m['load_s']:.3f} s, on replica 2 after {m['converge_s']:.3f} s on {device_name}")
        if min(m["native_hashed"].values()) < n_keys:
            raise AssertionError(f"the load's terms did not all go through the native hasher: "
                                 f"{m['native_hashed']} for {n_keys} keys and values")
        log(f"[binned] the load's {n_keys} keys and values all went through the native hasher (terms hashed "
            f"natively during the load {m['native_hashed']}); load {m['load_s']:.3f} s, of which hashing "
            f"alone takes {hasher['load_hash_native_s']:.3f} s native against {hasher['load_hash_hashlib_s']:.3f} "
            f"s by the per-term hashlib path the load took before the native hasher, on {device_name}")

        m.update(timed_propagations(r1, r2, t, arrivals, deadline, lambda i: f"prop{i}"))
        log(f"[binned] 10 single-op propagations (ms): {[round(x, 3) for x in m['propagation_ms']]} median "
            f"{float(np.median(m['propagation_ms'])):.3f}; replica 2's mailbox before each {m['queued_before']}, "
            f"messages it handled until each arrived {m['handled_during']} on {device_name}")

        removed = list(range(0, n_keys, 100))
        base = arrivals.total
        t1 = time.perf_counter()
        dc.mutate_batch(r1, "remove", [[f"key{i}"] for i in removed], timeout=SLICE_BUDGET_S)
        m["remove_converge_s"] = arrivals.wait(base + len(removed), deadline, "removes on replica 2") - t1
        log(f"[binned] removed {len(removed)} keys; on replica 2 after {m['remove_converge_s']:.3f} s "
            f"on {device_name}")

        want = {f"key{i}": i for i in range(n_keys) if i % 100 != 0}
        want.update({f"prop{i}": i for i in range(10)})
        probe = [f"key{i}" for i in range(0, n_keys, max(1, n_keys // 4096))][:4096]
        t1 = time.perf_counter()
        got2 = dc.read_keys(r2, probe)
        m["read_keys_ms"] = (time.perf_counter() - t1) * 1e3
        if got2 != {k: want[k] for k in probe if k in want} or dc.read_keys(r1, probe) != got2:
            raise AssertionError("binned read_keys disagrees with the written map")
        t1 = time.perf_counter()
        full = dc.read(r2)
        m["read_ms"] = (time.perf_counter() - t1) * 1e3
        if full != want:
            raise AssertionError(f"binned read() of replica 2 has {len(full)} keys, not the written map's {len(want)}")
        log(f"[binned] read_keys {len(probe)} keys on replica 2 {m['read_keys_ms']:.3f} ms; read() of "
            f"{len(full)} keys {m['read_ms']:.3f} ms; both equal the written map on {device_name}")

        while True:
            c1, c2 = r1.canonical_state_bytes(), r2.canonical_state_bytes()
            if c1 == c2:
                break
            if time.perf_counter() > deadline:
                raise AssertionError("binned replicas did not converge to equal canonical bytes")
            time.sleep(0.1)
        for r in reps:
            with r._lock:
                st = r.state
            for f in dataclasses.fields(st):
                if getattr(st, f.name).device.type != device:
                    raise AssertionError(f"{r.name}: state column {f.name} is not on {device}")
        m["canonical_bytes"] = len(c1)
        m["bin_capacity"] = r1.state.bin_capacity
        m["ingress"] = r2.stats()["ingress"]
        m["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
        ing = m["ingress"]
        if ing["dispatches"] == 0 or ing["messages"] < ing["dispatches"]:
            raise AssertionError(f"replica 2's ingress did not dispatch: {ing}")
        m["launches"] = {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                         batched_roots_kernel.name: batched_roots_kernel.launches}
        if any(m["launches"].values()):
            raise AssertionError(f"a kernel was launched on the binned replica path: {m['launches']}")
        log(f"[binned] canonical bytes equal ({len(c1)} B); every state column on the card; replica 2 "
            f"ingress {ing}; kernel launches on this path {m['launches']}; peak memory "
            f"{m['peak_mem_bytes']} B on {device_name}")
        if cuda:
            b = m["batch_breakdown"] = batch_breakdown(r1)
            tr = b["batch_trace"]
            log(f"[binned-trace] one {b['ops']}-op batch on replica 1's table (grouped {b['shape']}): hash "
                f"{b['hash_ms']:.3f} ms, group {b['group_ms']:.3f} ms, upload {b['upload_ms']:.3f} ms, "
                f"row_apply enqueue {b['row_apply_enqueue_ms']:.3f} ms + finish {b['row_apply_finish_ms']:.3f} "
                f"ms; one mutate_batch traced: wall {tr['wall_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} ms "
                f"(idle share {tr['idle_share']:.4f}), device ms by op "
                f"{[(k, round(v, 3)) for k, v in tr['ops']]} on {device_name}")
        if serve is not None:
            # the arrival counter is 3b's own: phase 10 times its commits
            # with no SYNC_DONE handler attached
            telemetry.detach(telemetry.SYNC_DONE, arrivals)
            if cuda:  # the traced batch of batch_breakdown wrote these
                want.update({f"traced{i}": i for i in range(1024)})
            m["serve"] = serve(reps, t, want)
        return m
    finally:
        telemetry.detach(telemetry.SYNC_DONE, arrivals)
        for r in reps:
            r.stop()


# ---------------------------------------------------------------------------
# phase 4: cuda vs cpu on deterministic scripts


def deterministic_script(device: str, model: str = "AWLWWMap", store: str | None = None) -> bytes:
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    t, c, feed = LocalTransport(), LogicalClock(), []
    rs = [
        dc.start_link(getattr(dc, model), store=store, threaded=False, transport=t, clock=c,
                      name=f"det{i}", node_id=(0xF00000000000000B, 7)[i], capacity=64,
                      tree_depth=4, max_sync_size=8, on_diffs=feed.append, device=device,
                      sync_timeout=1e9)  # walk slots clear by message, not by the clock
        for i in range(2)
    ]
    rs[0].set_neighbours([rs[1]])
    rs[1].set_neighbours([rs[0]])
    g = np.random.default_rng(5)
    add = (lambda k, v: [k, v]) if rs[0].model.OPS["add"][1] == 2 else (lambda k, v: [k])
    for step in range(10):
        rs[step % 2].mutate_batch(
            "add", [add(f"k{int(x)}", int(g.integers(0, 1000))) for x in g.integers(0, 150, 40)]
        )
        for x in g.integers(0, 150, 5):
            rs[step % 2].mutate("remove", [f"k{int(x)}"])
        rs[0].mutate("add", add("hot", step))
        rs[1].mutate("add", add("hot", -step))
        if step == 6:
            rs[1].mutate("clear", [])
        for _ in range(2):
            for r in rs:
                r.sync_to_all()
            t.pump()
    for _ in range(6):
        for r in rs:
            r.sync_to_all()
        t.pump()
    a, b = rs[0].canonical_state_bytes(), rs[1].canonical_state_bytes()
    if a != b:
        raise AssertionError(f"{device}: deterministic pair did not converge")
    return a + repr(feed).encode() + repr([r.stats()["ingress"] for r in rs]).encode()


def keys_for_buckets(lo: int, hi: int, n: int, mask: int, start: int) -> list:
    """``n`` int key terms whose hash buckets lie in ``[lo, hi)``."""
    from delta_crdt_ex_tpu_torch.utils.hashing import key_hash64

    out, k = [], start
    while len(out) < n:
        if lo <= key_hash64(k) & mask < hi:
            out.append(k)
        k += 1
    return out


def coalesced_script(device: str) -> bytes:
    """Three senders on disjoint bucket ranges push into one receiver
    without a subscriber; the receiver drains with ``process_pending``,
    so its merges group. One push is lost on the way, and the next
    interval of that bucket gaps inside a group."""
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, telemetry
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    t, c, done = LocalTransport(), LogicalClock(), []
    mk = lambda name, node: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=c, name=name, node_id=node,
        capacity=512, tree_depth=6, sync_timeout=1e9, device=device,
    )
    senders = [mk(f"co{i}", 0xF00000000000000B - i) for i in range(3)]
    recv = mk("co_recv", 7)
    for s in senders:
        s.set_neighbours([recv])
    keys = [keys_for_buckets(16 * i, 16 * (i + 1), 30, 63, 10_000 * i) for i in range(3)]
    handler = lambda _e, meas, meta: done.append(meas["keys_updated_count"]) if meta["name"] == "co_recv" else None

    def deliver() -> None:
        for s in senders:
            s.sync_to_all()
        entries = [m for m in t.drain(recv.addr) if isinstance(m, sync_proto.EntriesMsg)]
        for m in entries:
            t.send(recv.addr, m)
        recv.process_pending()
        for s in senders:  # repairs are answered; walk back-traffic is dropped
            for m in t.drain(s.addr):
                if isinstance(m, sync_proto.GetDiffMsg):
                    s.handle(m)

    telemetry.attach(telemetry.SYNC_DONE, handler)
    try:
        for i, s in enumerate(senders):
            s.mutate_batch("add", [[k, f"v{k}"] for k in keys[i][:20]])
        deliver()
        for i, s in enumerate(senders):
            s.mutate("remove", [keys[i][0]])
            s.mutate_batch("add", [[k, f"w{k}"] for k in keys[i][20:25]])
        deliver()
        k1, k2 = keys_for_buckets(3, 4, 2, 63, 90_000)
        senders[0].mutate("add", [k1, "one"])
        senders[0].sync_to_all()
        t.drain(recv.addr)  # this push is lost
        senders[0].mutate("add", [k2, "two"])
        for i in (1, 2):
            senders[i].mutate("add", [keys[i][26], "late"])
        deliver()
        deliver()
    finally:
        telemetry.detach(telemetry.SYNC_DONE, handler)
    ing = recv.stats()["ingress"]
    want = {k: v for s in senders for k, v in s.read().items()}
    if recv.read() != want:
        raise AssertionError(f"{device}: coalesced receiver read differs from its senders'")
    if max(ing["coalesce_depth_hist"]) < 3 or ing["gap_partitions"] != 1:
        raise AssertionError(f"{device}: coalesced script formed no deep group or no gap partition: {ing}")
    return recv.canonical_state_bytes() + repr((ing, done)).encode()


def simnet_script(device: str, store=None) -> bytes:
    """Phase 8d (run in phase 4): three replicas in one seeded
    ``SimNetwork`` that drops 20% of the messages, duplicates 20% and
    reorders every step; adds, removes and a clear on all three, then
    loss-free quiesce rounds. Returns every replica's canonical bytes,
    read and seq, which must agree across the three."""
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock

    net = dc.SimNetwork(seed=1234, drop_rate=0.2, dup_rate=0.2)
    clock = LogicalClock()
    reps = [
        dc.start_link(dc.AWLWWMap, store=store, threaded=False, transport=net, clock=clock, name=f"sn{i}",
                      node_id=0xF000000000000021 + i, capacity=512, tree_depth=6, max_sync_size=6,
                      sync_timeout=0.0, device=device)
        for i in range(3)
    ]
    try:
        for r in reps:
            r.set_neighbours(reps)
        net.step()
        for i in range(30):
            reps[i % 3].mutate_batch("add", [[f"k{(7 * i + j) % 50}", 10 * i + j] for j in range(4)])
            if i % 7 == 3:
                reps[(i + 1) % 3].mutate("remove", [f"k{i % 50}"])
            if i == 20:
                reps[2].mutate("clear", [])
            net.run(reps, rounds=1)
        net.run(reps, rounds=40)
        net.drop_rate = net.dup_rate = 0.0
        net.run(reps, rounds=10)
        while net.pending:
            net.step()
        canon = [r.canonical_state_bytes() for r in reps]
        reads = [r.read() for r in reps]
        if len(set(canon)) != 1 or reads[0] != reads[1] or reads[1] != reads[2]:
            raise AssertionError(f"{device}: the SimNetwork cluster (store={store}) did not converge")
        return b"".join(canon) + repr((sorted(reads[0].items()), [r._seq for r in reps])).encode()
    finally:
        for r in reps:
            r.crash()


def phase_cuda_vs_cpu() -> None:
    for model, store in (("AWLWWMap", "hash"), ("AWLWWMap", None), ("AWSet", None)):
        a = deterministic_script("cuda", model, store)
        b = deterministic_script("cpu", model, store)
        if a != b:
            raise AssertionError(f"cuda and cpu runs of the deterministic {model} script (store={store}) differ")
        log(f"[det] {model} store={store or 'default'}: cuda and cpu canonical state + diff feed + "
            f"ingress stats identical ({len(a)} B)")
    a, b = coalesced_script("cuda"), coalesced_script("cpu")
    if a != b:
        raise AssertionError("cuda and cpu runs of the coalesced script differ")
    log(f"[det] three senders coalescing into one receiver, a gap mid-group: cuda and cpu canonical "
        f"state + ingress stats + SYNC_DONE identical ({len(a)} B)")
    for store in (None, "hash"):
        a, b = fleet_det_script("cuda", store), fleet_det_script("cpu", store)
        if a != b:
            raise AssertionError(f"cuda and cpu runs of the fleet script (store={store}) differ")
        log(f"[det] a 4-member fleet, store={store or 'default'}, a gap mid-group: cuda and cpu canonical "
            f"state + fleet counters identical ({len(a)} B)")
    for store in (None, "hash"):
        a, b = simnet_script("cuda", store), simnet_script("cpu", store)
        if a != b:
            raise AssertionError(f"cuda and cpu runs of the SimNetwork script (store={store}) differ")
        log(f"[det] 8d: three replicas in a seeded SimNetwork (20% drops, 20% duplicates, reordered), "
            f"store={store or 'default'}: converged, cuda and cpu canonical state + reads + seqs identical "
            f"({len(a)} B)")

    from delta_crdt_ex_tpu_torch.models.binned import to_numpy

    runs = {dev: run_fanin(FANIN_SMOKE, dev, keep_states=True) for dev in ("cuda", "cpu")}
    calls = 0
    for (sa, ra), (sb, rb) in zip(runs["cuda"]["per_call"], runs["cpu"]["per_call"]):
        ca, cb = to_numpy(sa), to_numpy(sb)
        for c in ca:
            if not np.array_equal(ca[c], cb[c]):
                raise AssertionError(f"fan-in call {calls}: column {c} differs between cuda and cpu")
        if not np.array_equal(ra.cpu().numpy(), rb.numpy()):
            raise AssertionError(f"fan-in call {calls}: roots differ between cuda and cpu")
        calls += 1
    log(f"[det] fan-in at the smoke geometry: {calls} calls, stack columns and roots identical on cuda and cpu")

    from delta_crdt_ex_tpu_torch.ops.packed import packed_to_numpy

    for layout in ("packed_scomp", "packed_topk", "packed_fused"):
        runs = {dev: run_fanin(FANIN_SMOKE, dev, keep_states=True, layout=layout) for dev in ("cuda", "cpu")}
        calls = 0
        for (sa, ra), (sb, rb), xa, xb in zip(runs["cuda"]["per_call"], runs["cpu"]["per_call"],
                                             runs["cuda"]["results"], runs["cpu"]["results"]):
            ca, cb = packed_to_numpy(sa), packed_to_numpy(sb)
            for c in ca:
                if not np.array_equal(ca[c], cb[c]):
                    raise AssertionError(f"{layout} fan-in call {calls}: {c} differs between cuda and cpu")
            for f in xa._fields[1:]:
                if not np.array_equal(getattr(xa, f).cpu().numpy(), getattr(xb, f).numpy()):
                    raise AssertionError(f"{layout} fan-in call {calls}: {f} differs between cuda and cpu")
            if not bool(xa.ok.all()):
                raise AssertionError(f"{layout} fan-in call {calls}: merge overflow")
            if not np.array_equal(ra.cpu().numpy(), rb.numpy()):
                raise AssertionError(f"{layout} fan-in call {calls}: roots differ between cuda and cpu")
            calls += 1
        log(f"[det] {layout} fan-in at the smoke geometry: {calls} calls, words, aux tables, flags, counts "
            f"and roots identical on cuda and cpu")
    a, b = packed_growth_script("cuda"), packed_growth_script("cpu")
    for k in a:
        if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            raise AssertionError(f"packed growth script: {k} differs between cuda and cpu")
    log(f"[det] packed growth script through fanout_merge_into (kill budget, bin tier and gid table "
        f"overflow): {a['retries']} retries to B={a['tiers'][0]} R={a['tiers'][1]}, {a['grows']} grows; "
        f"words, aux tables, flags and counts identical on cuda and cpu, unpacked equal to the column stack's")


def packed_growth_script(device: str) -> dict:
    """``tests/test_packed_parity.py:130``'s growth script on ``device``
    without the JAX harness: 8 neighbours (16 buckets × 4 slots, a
    2-slot writer table holding their own writer and the origin's) that
    hold the origin's 32 entries, and one state-form slice from a third
    writer that removes all 32 and adds 48, through ``fanout_merge_into``
    on the packed stack with kill budget 2: the kill budget, the bins
    and the writer table all overflow. Checks that the stack grew and
    that it unpacks equal to the same merge on the column stack."""
    import dataclasses

    import torch

    from delta_crdt_ex_tpu_torch.models.binned import COLUMNS
    from delta_crdt_ex_tpu_torch.ops.binned import RowSlice
    from delta_crdt_ex_tpu_torch.ops.packed import packed_to_numpy, unpack
    from delta_crdt_ex_tpu_torch.parallel.batched_sync import fanout_merge_into, pack_states, stack_states
    from delta_crdt_ex_tpu_torch.utils.synth import build_state

    L, n = 16, 8
    top = np.uint64(1 << 63)
    keys = np.array([b + 16 * j for j in range(2) for b in range(L)], np.uint64) | top
    one, _ = build_state(500, keys, L, 4, 2, device=device)
    stack = stack_states([one] * n)
    own = torch.tensor([100 + i for i in range(n)], device=device)
    stack = dataclasses.replace(stack, ctx_gid=torch.stack([stack.ctx_gid[:, 0], own], 1))
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.uint64).view(np.int64), device=device)
    new_keys = np.array([[b + 16 * (2 + j) for j in range(3)] for b in range(L)], np.uint64) | top
    sl = RowSlice(
        rows=torch.arange(L, device=device),
        key=i64(new_keys),
        valh=torch.full((L, 3), 7000, dtype=torch.int64, device=device),
        ts=torch.arange(200, 200 + 3 * L, device=device).reshape(L, 3),
        node=torch.zeros((L, 3), dtype=torch.int32, device=device),
        ctr=torch.arange(1, 4, device=device).expand(L, 3).contiguous(),
        alive=torch.ones((L, 3), dtype=torch.bool, device=device),
        ctx_rows=torch.stack([torch.full((L,), 3, device=device), one.ctx_max[:, 0]], 1),
        ctx_lo=torch.zeros((L, 2), dtype=torch.int64, device=device),
        ctx_gid=torch.tensor([999, 500], device=device),
    )
    grows = []
    pk, res, retries = fanout_merge_into(pack_states(stack), sl, kill_budget=2, on_grow=grows.append)
    col, _, col_retries = fanout_merge_into(stack, sl, kill_budget=2)
    if not bool(res.ok.all()) or retries < 1 or col_retries != retries:
        raise AssertionError(f"packed growth on {device}: ok {res.ok.tolist()}, {retries} retries "
                             f"(columns {col_retries})")
    if pk.bin_capacity < 8 or pk.replica_capacity < 4 or not grows:
        raise AssertionError(f"packed growth on {device}: tiers B={pk.bin_capacity} R={pk.replica_capacity}")
    if int(res.n_killed.sum()) != 32 * n or int(res.n_inserted.sum()) != 48 * n:
        raise AssertionError(f"packed growth on {device}: killed {res.n_killed.tolist()}, "
                             f"inserted {res.n_inserted.tolist()}")
    up = unpack(pk)
    for c in COLUMNS:
        if not torch.equal(getattr(up, c), getattr(col, c)):
            raise AssertionError(f"packed growth on {device}: unpacked {c} differs from the column stack's")
    out = packed_to_numpy(pk)
    out.update({f: getattr(res, f).cpu().numpy() for f in res._fields[1:]})
    out.update(retries=retries, tiers=(pk.bin_capacity, pk.replica_capacity), grows=len(grows))
    return out


# ---------------------------------------------------------------------------
# phases 5, 5p and 6: the fan-in (bench.py's north star) on both entry layouts

#: ``bench.py``'s full geometry (N_KEYS, TREE_DEPTH, BIN_CAP, RCAP,
#: NEIGHBOURS, DELTA, GROUP, CALLS, WARMUP_CALLS, the delta bin width)
FANIN_FULL = dict(keys=1_000_000, L=1 << 14, B=128, R=8, N=64, delta=512, group=16,
                  calls=6, warmup=1, bin_width=8)
#: ``bench.py``'s ``BENCH_SMOKE`` geometry
FANIN_SMOKE = dict(keys=4096, L=1 << 8, B=64, R=8, N=4, delta=128, group=4,
                   calls=2, warmup=1, bin_width=16)


def call_stats(dts: list, per_call: int) -> dict:
    """``bench.py``'s summary of per-call completion intervals: sub-5 ms
    intervals coalesce into windows, the headline is the median window
    rate."""
    floor = 0.005
    wins: list = []
    acc_n, acc_dt = 0, 0.0
    for d in dts:
        acc_n += 1
        acc_dt += d
        if acc_dt >= floor:
            wins.append((acc_n, acc_dt))
            acc_n, acc_dt = 0, 0.0
    if acc_n:
        if wins:
            n0, d0 = wins[-1]
            wins[-1] = (n0 + acc_n, d0 + acc_dt)
        else:
            wins.append((acc_n, acc_dt))
    rates = sorted(n * per_call / d for n, d in wins)
    return {
        "merges_per_sec": float(np.median(rates)),
        "stat": f"median_of_{len(wins)}_call_windows",
        "call_rate_min": rates[0],
        "call_rate_max": rates[-1],
    }


#: the fan-in's entry layouts: phase 5's columns (``fanout_merge``);
#: ``bench.py``'s primary on the packed layout and its A/B alternate
#: (phase 5p); the fused-aux packed merge (phase 4 only)
FANIN_LAYOUTS = ("columns", "packed_scomp", "packed_topk", "packed_fused")


def fanin_merge(layout: str):
    """One fan-in call's merge on ``layout``:
    ``(stack, slice, kill_budget, max_inserts) -> MergeResult``."""
    from delta_crdt_ex_tpu_torch.ops.packed import merge_slice_packed_fused
    from delta_crdt_ex_tpu_torch.parallel.batched_sync import fanout_merge, fanout_merge_packed

    if layout == "columns":
        return fanout_merge
    if layout == "packed_fused":
        return merge_slice_packed_fused
    scomp = {"packed_scomp": True, "packed_topk": False}[layout]
    # interval_delta_stream's rows strictly ascend (bench.py vouches so)
    return lambda st, sl, kb, mi: fanout_merge_packed(st, sl, kb, mi, scatter_compact=scomp, rows_sorted=True)


def entry_bytes(stack) -> int:
    """Bytes of a stack's entry table: the seven entry columns, or the
    packed words."""
    if hasattr(stack, "words"):
        return stack.words.numel() * stack.words.element_size()
    return sum(getattr(stack, c).numel() * getattr(stack, c).element_size()
               for c in ("key", "valh", "ts", "node", "ctr", "alive", "ehash"))


def run_fanin(geo: dict, device: str, keep_states: bool = False, layout: str = "columns",
              prior: "dict | None" = None) -> dict:
    """``bench.py``'s fan-in on ``device``: a single-writer state over
    ``geo["keys"]`` seeded keys broadcast to N neighbours (packed, on a
    packed ``layout``), then warm-up + timed calls, each one merge of a
    group of interval deltas from a second writer (:func:`fanin_merge`)
    and the stack's roots. The timed calls are enqueued back to back and
    stamped as each one completes, as ``bench.py`` does; on ``cuda`` the
    stamps are CUDA events recorded after each call (the host stamps of
    ``bench.py`` would collapse here, because enqueueing a call takes
    the host most of a call's device time). ``prior``, an earlier run's
    result, hands over its base state, keys and delta groups, so that a
    second layout merges exactly the same work. Returns the final stack,
    each call's results, the per-call completion intervals and host
    enqueue times, and the host copies of the keys."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots, batched_roots_kernel
    from delta_crdt_ex_tpu_torch.parallel.batched_sync import pack_states, stack_states
    from delta_crdt_ex_tpu_torch.utils.synth import build_state, interval_delta_stream

    L, n_calls = geo["L"], geo["warmup"] + geo["calls"]
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    if prior is None:
        rng = np.random.default_rng(0)  # bench.py make_workload(seed=0)
        keys = rng.integers(1, 1 << 63, size=geo["keys"], dtype=np.uint64)
        if len(np.unique(keys)) != len(keys):
            raise AssertionError("seeded keys are not distinct")
        one, _ = build_state(11, keys, L, geo["B"], geo["R"], device=device)
        next_ctr, slices = None, []
        for _ in range(n_calls + 1):  # the last one is the traced call's
            (sl,), next_ctr = interval_delta_stream(
                22, rng, 1, geo["group"] * geo["delta"], L, next_ctr=next_ctr,
                bin_width=geo["bin_width"], device=device,
            )
            slices.append(sl)
        spare = slices.pop()
        delta_keys = np.concatenate([s.key[s.alive].cpu().numpy() for s in slices]).view(np.uint64)
    else:
        one, keys, slices, spare, delta_keys = (prior[k] for k in ("one", "keys", "slices", "spare", "delta_keys"))
    stack = stack_states([one] * geo["N"])
    if layout != "columns":
        stack = pack_states(stack)  # the column stack is freed here
    merge = fanin_merge(layout)
    sync()
    setup_s = time.perf_counter() - t0
    setup_bytes = torch.cuda.memory_allocated() if cuda else 0

    def stamp():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    batched_roots_kernel.reset()  # the fan-in path's run starts here
    per_call, marks, enqueue_s = [], [], []
    t0 = time.perf_counter()
    for i, sl in enumerate(slices):
        if i == geo["warmup"]:
            sync()
            t0 = time.perf_counter()
            marks.append(stamp())
        t1 = time.perf_counter()
        res = merge(stack, sl, 8, geo["group"] * geo["delta"])
        stack = res.state
        roots = batched_roots(stack.leaf)
        # flags and counts only: a kept state would hold a whole stack
        per_call.append((stack if keep_states else None, roots, res._replace(state=None)))
        if i >= geo["warmup"]:
            enqueue_s.append(time.perf_counter() - t1)
            marks.append(stamp())
    launches = batched_roots_kernel.launches
    by_shape = dict(batched_roots_kernel.launches_by_shape)
    sync()
    wall_s = time.perf_counter() - t0
    if cuda:
        call_dts = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        call_dts = [b - a for a, b in zip(marks, marks[1:])]
    return {
        "stack": stack, "one": one, "keys": keys, "delta_keys": delta_keys, "slices": slices,
        "spare": spare, "per_call": [(s, r) for s, r, _ in per_call], "results": [x for _, _, x in per_call],
        "call_dts": call_dts, "enqueue_s": enqueue_s, "wall_s": wall_s, "launches": launches,
        "launches_by_shape": by_shape, "layout": layout, "merge": merge, "roots": roots,
        "setup_s": setup_s, "setup_bytes": setup_bytes, "stack_bytes": entry_bytes(stack),
    }


def phase_fanin(device_name: str) -> dict:
    import torch

    from delta_crdt_ex_tpu_torch.models.binned import COLUMNS, map_columns
    from delta_crdt_ex_tpu_torch.ops.binned import compact_rows
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots, batched_roots_kernel, batched_roots_ref
    from delta_crdt_ex_tpu_torch.parallel.batched_sync import fanout_merge

    geo = FANIN_FULL
    torch.cuda.reset_peak_memory_stats()
    run = run_fanin(geo, "cuda")
    stack = run["stack"]
    m: dict = {"geometry": geo, "setup_s": run["setup_s"], "launches": run["launches"],
               "launches_by_shape": {f"{n}x{L}": c for (n, L), c in run["launches_by_shape"].items()}}
    m["call_ms"] = [d * 1e3 for d in run["call_dts"]]
    m["enqueue_ms"] = [d * 1e3 for d in run["enqueue_s"]]
    m.update(call_stats(run["call_dts"], geo["group"] * geo["N"]))
    m["aggregate_merges_per_sec"] = geo["calls"] * geo["group"] * geo["N"] / run["wall_s"]
    m["setup_mem_bytes"] = run["setup_bytes"]
    m["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    m["stack_bytes"] = run["stack_bytes"]
    log(f"[fanin] {geo['keys']} keys, {geo['N']} neighbours, L={geo['L']} B={geo['B']}: set-up "
        f"{run['setup_s']:.3f} s; {geo['calls']} timed calls of {geo['group']} x {geo['delta']}-entry "
        f"deltas: per-call ms (device, CUDA events) {[round(x, 3) for x in m['call_ms']]}, host "
        f"enqueue ms {[round(x, 3) for x in m['enqueue_ms']]}; merges/s {m['merges_per_sec']:.3f} "
        f"({m['stat']}, min {m['call_rate_min']:.3f}, max {m['call_rate_max']:.3f}), aggregate "
        f"{m['aggregate_merges_per_sec']:.3f}; memory after set-up {m['setup_mem_bytes']} B, peak "
        f"{m['peak_mem_bytes']} B on {device_name}")

    n_delta = geo["group"] * geo["delta"]
    for i, res in enumerate(run["results"]):
        flags = torch.stack([res.need_gid_grow, res.need_kill_tier, res.need_fill_compact,
                             res.need_ctx_gap, res.need_ins_tier]).any(dim=1).tolist()
        if not bool(res.ok.all()):
            raise AssertionError(f"fan-in call {i}: merge overflow (gid/kill/fill/gap/ins) {flags}")
        want = int(run["slices"][i].alive.sum())
        if want != n_delta or not bool((res.n_inserted == want).all()) or bool(res.n_killed.any()):
            raise AssertionError(f"fan-in call {i}: inserted {res.n_inserted.tolist()[:4]}..., "
                                 f"killed {int(res.n_killed.sum())}, want {want} and 0")
    alive = stack.alive.sum(dim=(1, 2))
    want_alive = geo["keys"] + (geo["warmup"] + geo["calls"]) * n_delta
    if not bool((alive == want_alive).all()):
        raise AssertionError(f"lane alive counts {alive.unique().tolist()}, want {want_alive}")
    for c in COLUMNS:
        col = getattr(stack, c)
        if not bool((col == col[:1]).all()):
            raise AssertionError(f"fan-in lanes differ in column {c}")
    lane0 = map_columns(lambda x: x[0], stack)
    if not torch.equal(compact_rows(lane0).leaf, lane0.leaf):
        raise AssertionError("lane 0's incremental leaf digests differ from compact_rows'")
    got_keys = np.sort(lane0.key[lane0.alive].cpu().numpy().view(np.uint64))
    if not np.array_equal(got_keys, np.sort(np.concatenate([run["keys"], run["delta_keys"]]))):
        raise AssertionError("lane 0's alive key set is not base ∪ deltas")
    if m["launches"] != geo["warmup"] + geo["calls"]:
        raise AssertionError(f"roots kernel launched {m['launches']} times on the fan-in, want "
                             f"{geo['warmup'] + geo['calls']}")
    # launches below compare the kernel with its plain version
    got = batched_roots_kernel(stack.leaf)
    want = batched_roots_ref(stack.leaf)
    m["roots_max_abs_err"] = int((got - want).abs().max())
    if m["roots_max_abs_err"] != 0:
        raise AssertionError("roots kernel disagrees with batched_roots_ref on the final stack")
    log(f"[fanin] checks: every ok, {n_delta} inserted and 0 killed per lane and call, {want_alive} "
        f"alive per lane, {geo['N']} lanes bit-equal, leaf == compact_rows(lane 0).leaf, alive keys == "
        f"base ∪ deltas; roots kernel launches on the fan-in {m['launches']}, final roots "
        f"bit-equal to batched_roots_ref")
    # one more call, on the next delta group, under the profiler: where a
    # call's device time goes (its result is dropped)
    m["trace"] = trace_call(
        lambda: batched_roots(fanout_merge(stack, run["spare"], 8, n_delta).state.leaf)
    )
    log(f"[fanin-trace] one call: wall {m['trace']['wall_ms']:.3f} ms, device busy "
        f"{m['trace']['busy_ms']:.3f} ms (idle share {m['trace']['idle_share']:.4f}); device ms "
        f"by op: {[(k, round(v, 3)) for k, v in m['trace']['ops']]}")
    m["base"] = run["one"]
    # what phase 5p merges again and holds its packed result against
    m["prior"] = {k: run[k] for k in ("one", "keys", "slices", "spare", "delta_keys")}
    m["prior"]["lane0"] = map_columns(lambda x: x[0].clone(), stack)
    m["prior"]["roots"] = run["roots"].clone()
    return m


def phase_fanin_packed(device_name: str, prior: dict) -> dict:
    """Phase 5p: phase 5's fan-in on the packed layout, ``packed_scomp``
    (``bench.py``'s primary) then ``packed_topk`` (its A/B alternate),
    each from phase 5's base state over phase 5's delta groups, one
    stack freed before the next is built."""
    import torch

    from delta_crdt_ex_tpu_torch.models.binned import COLUMNS
    from delta_crdt_ex_tpu_torch.ops.packed import PackedStore, unpack
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots, batched_roots_kernel, batched_roots_ref

    geo = FANIN_FULL
    n_delta = geo["group"] * geo["delta"]
    out: dict = {}
    for layout in ("packed_scomp", "packed_topk"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = run_fanin(geo, "cuda", layout=layout, prior=prior)
        stack = run["stack"]
        m: dict = {"setup_s": run["setup_s"], "launches": run["launches"],
                   "launches_by_shape": {f"{n}x{L}": c for (n, L), c in run["launches_by_shape"].items()},
                   "call_ms": [d * 1e3 for d in run["call_dts"]], "enqueue_ms": [d * 1e3 for d in run["enqueue_s"]]}
        m.update(call_stats(run["call_dts"], geo["group"] * geo["N"]))
        m["aggregate_merges_per_sec"] = geo["calls"] * geo["group"] * geo["N"] / run["wall_s"]
        m["setup_mem_bytes"] = run["setup_bytes"]
        m["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        m["stack_bytes"] = run["stack_bytes"]
        if not isinstance(stack, PackedStore) or stack.words.dtype != torch.int32:
            raise AssertionError(f"{layout}: the stack is not 32-bit packed words")
        log(f"[fanin-packed] {layout}: {geo['keys']} keys, {geo['N']} neighbours, L={geo['L']} B={geo['B']}: "
            f"set-up {run['setup_s']:.3f} s; {geo['calls']} timed calls of {geo['group']} x {geo['delta']}-entry "
            f"deltas: per-call ms (device, CUDA events) {[round(x, 3) for x in m['call_ms']]}, host enqueue ms "
            f"{[round(x, 3) for x in m['enqueue_ms']]}; merges/s {m['merges_per_sec']:.3f} ({m['stat']}, min "
            f"{m['call_rate_min']:.3f}, max {m['call_rate_max']:.3f}), aggregate {m['aggregate_merges_per_sec']:.3f}; "
            f"words {m['stack_bytes']} B; memory after set-up {m['setup_mem_bytes']} B, peak {m['peak_mem_bytes']} B "
            f"on {device_name}")
        for i, res in enumerate(run["results"]):
            flags = torch.stack([res.need_gid_grow, res.need_kill_tier, res.need_fill_compact,
                                 res.need_ctx_gap, res.need_ins_tier]).any(dim=1).tolist()
            if not bool(res.ok.all()):
                raise AssertionError(f"{layout} call {i}: merge overflow (gid/kill/fill/gap/ins) {flags}")
            want = int(prior["slices"][i].alive.sum())
            if want != n_delta or not bool((res.n_inserted == want).all()) or bool(res.n_killed.any()):
                raise AssertionError(f"{layout} call {i}: inserted {res.n_inserted.tolist()[:4]}..., "
                                     f"killed {int(res.n_killed.sum())}, want {want} and 0")
        for f in ("words", "fill", "amin", "amax", "leaf", "ctx_gid", "ctx_max"):
            col = getattr(stack, f)
            if not bool((col == col[:1]).all()):
                raise AssertionError(f"{layout}: lanes differ in {f}")
        lane0 = unpack(PackedStore(**{f: getattr(stack, f)[0] for f in
                                      ("words", "fill", "amin", "amax", "leaf", "ctx_gid", "ctx_max")}))
        for c in COLUMNS:
            if not torch.equal(getattr(lane0, c), getattr(prior["lane0"], c)):
                raise AssertionError(f"{layout}: unpack(lane 0) differs from phase 5's column lane 0 in {c}")
        del lane0
        if not torch.equal(run["roots"], prior["roots"]):
            raise AssertionError(f"{layout}: final roots differ from phase 5's")
        if m["launches"] != geo["warmup"] + geo["calls"]:
            raise AssertionError(f"{layout}: roots kernel launched {m['launches']} times, want "
                                 f"{geo['warmup'] + geo['calls']}")
        # launches below compare the kernel with its plain version
        m["roots_max_abs_err"] = int((batched_roots_kernel(stack.leaf) - batched_roots_ref(stack.leaf)).abs().max())
        if m["roots_max_abs_err"] != 0:
            raise AssertionError(f"{layout}: roots kernel disagrees with batched_roots_ref on the final stack")
        log(f"[fanin-packed] {layout} checks: every ok, {n_delta} inserted and 0 killed per lane and call, "
            f"{geo['N']} lanes' words and aux tables equal, unpack(lane 0) bit-equal to phase 5's column lane 0, "
            f"final roots equal to phase 5's; roots kernel launches {m['launches']}, bit-equal to batched_roots_ref")
        merge = run["merge"]
        m["trace"] = trace_call(lambda: batched_roots(merge(stack, prior["spare"], 8, n_delta).state.leaf))
        log(f"[fanin-packed-trace] {layout}, one call: wall {m['trace']['wall_ms']:.3f} ms, device busy "
            f"{m['trace']['busy_ms']:.3f} ms (idle share {m['trace']['idle_share']:.4f}); device ms by op: "
            f"{[(k, round(v, 3)) for k, v in m['trace']['ops']]} on {device_name}")
        out[layout] = m
        del run, stack
    torch.cuda.empty_cache()
    return out


def trace_call(fn, top: int = 10) -> dict:
    """One ``fn()`` under ``torch.profiler``: its wall time, the device
    time of its kernels (a single stream, so their sum is the busy
    time), the device idle share ``1 - busy / wall``, and the ``top``
    torch ops by the device time of the kernels each launched itself."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time for the traced call")
    ops = sorted(
        ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.key.startswith("aten::") and e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms, "ops": ops[:top]}


def canonical_lanes(stack) -> list:
    """Each lane's content over global writer ids, on the host: alive
    entries as sorted (key, writer gid, ctr, ts, valh) rows and the
    context as sorted (bucket, writer gid, max counter) rows."""
    from delta_crdt_ex_tpu_torch.models.binned import map_columns, to_numpy

    out = []
    for i in range(stack.key.shape[0]):
        c = to_numpy(map_columns(lambda x: x[i], stack))
        a = c["alive"]
        ent = np.stack([c["key"][a], c["ctx_gid"][c["node"][a]], c["ctr"][a].astype(np.uint64),
                        c["ts"][a].view(np.uint64), c["valh"][a].astype(np.uint64)])
        ent = ent[:, np.lexsort(ent[::-1])]
        b, r = np.nonzero(c["ctx_max"])
        ctx = np.stack([b.astype(np.uint64), c["ctx_gid"][r], c["ctx_max"][b, r].astype(np.uint64)])
        out.append((ent, ctx[:, np.lexsort(ctx[::-1])]))
    return out


#: phase 6's gossip geometry: lanes grown from the fan-in's base, fresh
#: entries a lane
GOSSIP_LANES = 8
GOSSIP_FRESH = 4096


def gossip_lanes(base, device: str = "cuda") -> list:
    """Phase 6's (and 12c's) replicas: the fan-in's base state, grown to
    16 writer slots, each lane joined with 4096 fresh entries of its own
    writer (seed 6)."""
    from delta_crdt_ex_tpu_torch.models.binned_map import merge_into
    from delta_crdt_ex_tpu_torch.utils.synth import interval_delta_stream

    L = base.num_buckets
    rng = np.random.default_rng(6)
    base = base.grow(replica_capacity=16)  # the base writer + 8 lane writers
    lanes = []
    for i in range(GOSSIP_LANES):
        (sl,), _ = interval_delta_stream(100 + i, rng, 1, GOSSIP_FRESH, L, bin_width=8, device=device)
        lane, res = merge_into(base, sl, n_alive=GOSSIP_FRESH)
        if int(res.n_inserted) != GOSSIP_FRESH:
            raise AssertionError(f"lane {i}: merge_into inserted {int(res.n_inserted)}, want {GOSSIP_FRESH}")
        lanes.append(lane)
    return lanes


def phase_ring_gossip(base) -> dict:
    import torch

    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots, batched_roots_kernel
    from delta_crdt_ex_tpu_torch.parallel.batched_sync import ring_gossip_round, stack_states

    n, fresh = GOSSIP_LANES, GOSSIP_FRESH
    L = base.num_buckets
    stack = stack_states(gossip_lanes(base))
    torch.cuda.synchronize()
    batched_roots_kernel.reset()  # the gossip path's run starts here
    t0 = time.perf_counter()
    for r in range(n - 1):
        res = ring_gossip_round(stack)
        if not bool(res.ok.all()):
            raise AssertionError(f"ring gossip round {r}: merge overflow")
        stack = res.state
        roots = batched_roots(stack.leaf)
    torch.cuda.synchronize()
    m = {"lanes": n, "rounds": n - 1, "round_ms": (time.perf_counter() - t0) / (n - 1) * 1e3,
         "launches": batched_roots_kernel.launches,
         "launches_by_shape": {f"{n}x{L}": c for (n, L), c in batched_roots_kernel.launches_by_shape.items()}}
    if not bool((roots == roots[0]).all()) or not bool((stack.leaf == stack.leaf[:1]).all()):
        raise AssertionError(f"ring gossip: roots differ after {n - 1} rounds: {roots.tolist()}")
    views = canonical_lanes(stack)
    for i, (ent, ctx) in enumerate(views):
        if not (np.array_equal(ent, views[0][0]) and np.array_equal(ctx, views[0][1])):
            raise AssertionError(f"ring gossip: lane {i}'s content differs from lane 0's")
    want = int(base.alive.sum()) + n * fresh
    if views[0][0].shape[1] != want:
        raise AssertionError(f"ring gossip: {views[0][0].shape[1]} alive entries, want {want}")
    log(f"[gossip] {n} lanes x {n - 1} ring_gossip_rounds ({m['round_ms']:.3f} ms a round with "
        f"its roots): roots and leaves equal, every lane's {want} entries and context equal; "
        f"roots kernel launches on this path {m['launches']}")
    return m


# ---------------------------------------------------------------------------
# phase 7: fleets (bench.py --fleet's legs, on the card)

#: ``bench.py``'s fleet geometry (``bench.py:1791-1794``): 64 buckets a
#: replica (tree_depth 6), capacity (1 << 6) x 16, 4 fresh keys per
#: sender a round, 1 warm-up and 3 timed rounds (the bench's 5, cut so
#: that the whole run ends well inside its limit)
FLEET_DEPTH = 6
FLEET_KEYS_PER_ROUND = 4
FLEET_ROUNDS = 3


class _Sink:
    """Mailbox-only receiver of the egress leg: registered so sends route
    and monitors succeed, it handles nothing."""


def fleet_universe(n: int, store, device: str, tag: str, egress: bool, mesh=None):
    """``bench.py``'s fleet topology on ``device``: n fleet members and n
    solo twins with pairwise-equal node ids (``LogicalClock``); the
    ingress leg adds n senders, each pushing to its member and its twin,
    the egress leg a sink neighbour for every member and twin. ``mesh``
    makes the fleet a mesh fleet (phase 12b)."""
    import gc

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    # the previous leg's replicas sit in reference cycles (a member's
    # notify is its fleet's method): collect them now, not inside a
    # timed round of this leg
    gc.collect()
    t, clock = LocalTransport(), LogicalClock()
    mk = lambda **kw: dc.start_link(
        dc.AWLWWMap, store=store, threaded=False, transport=t, clock=clock if not egress else LogicalClock(),
        capacity=(1 << FLEET_DEPTH) * 16, tree_depth=FLEET_DEPTH, sync_timeout=1e9, device=device, **kw,
    )
    members = [mk(name=f"{tag}_f{i}", node_id=10_000 + i) for i in range(n)]
    solos = [mk(name=f"{tag}_o{i}", node_id=10_000 + i) for i in range(n)]
    senders = []
    if egress:
        for i in range(n):
            t.register(f"{tag}_fr{i}", _Sink())
            t.register(f"{tag}_or{i}", _Sink())
            members[i].set_neighbours([f"{tag}_fr{i}"])
            solos[i].set_neighbours([f"{tag}_or{i}"])
    else:
        senders = [mk(name=f"{tag}_s{i}") for i in range(n)]
        for i, s in enumerate(senders):
            s.set_neighbours([members[i], solos[i]])
    return t, dc.Fleet(members, mesh=mesh), solos, senders


def state_nbytes(state) -> int:
    import dataclasses

    import torch

    if hasattr(state, "blocks"):  # a mesh fleet's block-split stack
        return sum(state_nbytes(b) for b in state.blocks)
    return sum(v.numel() * v.element_size() for f in dataclasses.fields(state)
               if isinstance(v := getattr(state, f.name), torch.Tensor))


def check_on_card(reps, device: str) -> None:
    import dataclasses

    import torch

    for r in reps:
        st = r.state
        for f in dataclasses.fields(st):
            v = getattr(st, f.name)
            if isinstance(v, torch.Tensor) and v.device.type != device:
                raise AssertionError(f"{r.name}: state column {f.name} is not on {device}")


class FleetMemory:
    """``torch.cuda.memory_allocated()`` after every round; raises once a
    round ends more than one batch's bytes above the first timed
    round's figure (views of old stacks piling up)."""

    def __init__(self, leg: str, cuda: bool) -> None:
        self.leg, self.cuda = leg, cuda
        self.first: int | None = None
        self.rounds: list = []

    def note(self, rnd: int, batch_bytes: int) -> None:
        import torch

        if not self.cuda:
            return
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated()
        self.rounds.append(now)
        if rnd == 1:
            self.first = now
        log(f"[fleet-mem] {self.leg} round {rnd}: memory_allocated {now} B (first timed round "
            f"{self.first}, one batch {batch_bytes} B)")
        if self.first is not None and now > self.first + batch_bytes:
            raise AssertionError(f"{self.leg}: device memory grew round over round: {self.rounds}")


def _entries_to(transport, addr) -> int:
    from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto

    msgs = [m for m in transport.drain(addr) if isinstance(m, sync_proto.EntriesMsg)]
    for m in msgs:
        transport.send(addr, m)
    return len(msgs)


def fleet_ingress(n: int, store, device_name: str, device: str = "cuda", mesh=None, rounds: int = 0) -> dict:
    """``bench.py --fleet``'s ingress leg: n senders push delta-interval
    EntriesMsgs to one fleet member and one solo twin each (walk
    back-traffic filtered out); a round times ``fleet.drain()`` against
    the twins' ``process_pending()`` loop. One more round's drain runs
    under the profiler. Then every member's state columns, canonical
    bytes and seq must equal its twin's."""
    import torch

    from delta_crdt_ex_tpu_torch.models.binned import to_numpy as b_np
    from delta_crdt_ex_tpu_torch.models.hash_store import to_numpy as h_np

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rounds = rounds or FLEET_ROUNDS
    leg = f"ingress {store or 'binned'} N={n}" + (f" mesh shards={mesh.shards}" if mesh is not None else "")
    t0 = time.perf_counter()
    tag = f"fi{store or 'b'}{n}" + (f"m{mesh.shards}" if mesh is not None else "")
    t, fleet, solos, senders = fleet_universe(n, store, device, tag, egress=False, mesh=mesh)
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mem = FleetMemory(leg, cuda)
    dts: dict = {"fleet": [], "solo": []}
    disp: list = []
    trace = None
    for rnd in range(rounds + 2):  # round 0 warms up; the last one is traced
        base = 1_000_003 * rnd
        for i, s in enumerate(senders):
            s.mutate_batch("add", [[base + i * 1000 + j, base + i * 1000 + j] for j in range(FLEET_KEYS_PER_ROUND)])
        for s in senders:
            s.sync_to_all()
        for r in fleet.replicas:
            if _entries_to(t, r.addr) < 1:
                raise AssertionError(f"{leg}: member {r.name} got no entries")
        d0 = fleet.stats()["dispatches"]
        if rnd == rounds + 1:
            if cuda:
                trace = trace_call(fleet.drain)
            else:
                fleet.drain()
        else:
            sync()
            t1 = time.perf_counter()
            fleet.drain()
            sync()
            if rnd > 0:
                dts["fleet"].append(time.perf_counter() - t1)
        disp.append(fleet.stats()["dispatches"] - d0)
        for r in solos:
            _entries_to(t, r.addr)
        sync()
        t1 = time.perf_counter()
        for r in solos:
            r.process_pending()
        sync()
        if 0 < rnd <= rounds:
            dts["solo"].append(time.perf_counter() - t1)
        for s in senders:
            t.drain(s.addr)  # walk back-traffic: not measured
        stacks = list(fleet._stack_cache.values())
        mem.note(rnd, state_nbytes(stacks[0][1]) if stacks else 0)

    to_np = h_np if store == "hash" else b_np
    for rf, rs in zip(fleet.replicas, solos):
        if rf._seq != rs._seq or rf._seq <= 0:
            raise AssertionError(f"{leg}: {rf.name} seq {rf._seq} != solo {rs._seq}")
        a, b = to_np(rf.state), to_np(rs.state)
        for c in a:
            if not np.array_equal(a[c], b[c]):
                raise AssertionError(f"{leg}: fleet/solo state diverged at {rf.name}: {c}")
        if rf.canonical_state_bytes() != rs.canonical_state_bytes():
            raise AssertionError(f"{leg}: fleet/solo canonical bytes diverged at {rf.name}")
    check_on_card(list(fleet.replicas) + solos + senders, device)
    st = fleet.stats()
    med = lambda ds: float(np.median(ds))
    m = {
        "replicas": n, "store": store or "binned", "setup_s": setup_s,
        "fleet_merges_per_sec": n / med(dts["fleet"]), "solo_merges_per_sec": n / med(dts["solo"]),
        "fleet_round_ms": [x * 1e3 for x in dts["fleet"]], "solo_round_ms": [x * 1e3 for x in dts["solo"]],
        "dispatches_per_round": disp, "avg_occupancy": st["avg_occupancy"],
        "occupancy_hist": {str(k): v for k, v in st["occupancy_hist"].items()},
        "ragged_fill_ratio": st["ragged_fill_ratio"], "fallbacks": st["fallbacks"],
        "stack_cache": st["stack_cache"], "memory_by_round": mem.rounds,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }
    m["speedup"] = m["fleet_merges_per_sec"] / m["solo_merges_per_sec"]
    if trace is not None:
        m["trace"] = trace
    log(f"[fleet] {leg}: fleet {m['fleet_merges_per_sec']:.3f} vs solo {m['solo_merges_per_sec']:.3f} merges/s "
        f"(median of {rounds} rounds; speedup {m['speedup']:.3f}); fleet round ms "
        f"{[round(x, 3) for x in m['fleet_round_ms']]}, solo round ms {[round(x, 3) for x in m['solo_round_ms']]}; "
        f"dispatches per round {disp}; avg occupancy {st['avg_occupancy']}, ragged fill {st['ragged_fill_ratio']}, "
        f"fallbacks {st['fallbacks']}, stack cache {st['stack_cache']}; peak memory {m['peak_mem_bytes']} B; "
        f"set-up {setup_s:.3f} s on {device_name}")
    if trace is not None:
        log(f"[fleet-trace] {leg}: one traced fleet.drain(): wall {trace['wall_ms']:.3f} ms, device busy "
            f"{trace['busy_ms']:.3f} ms (idle share {trace['idle_share']:.4f}); device ms by op "
            f"{[(k, round(v, 3)) for k, v in trace['ops']]} on {device_name}")
    log(f"[fleet] {leg}: every member's state columns, canonical bytes and seq equal its solo twin's; "
        f"every state tensor on {device}")
    return m


def _norm_out(msg):
    """Address-free body of one outbound sync message (``bench.py``'s
    ``_norm_out``): the parity witness between twins."""
    from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto

    if isinstance(msg, sync_proto.EntriesMsg):
        return ("entries", np.asarray(msg.buckets), {c: np.asarray(v) for c, v in msg.arrays.items()}, msg.payloads)
    if isinstance(msg, sync_proto.DiffMsg):
        return ("diff", msg.level, np.asarray(msg.idx), [np.asarray(b) for b in msg.blocks], msg.seq)
    return (type(msg).__name__,)


def _norm_eq(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))
    if isinstance(a, dict):
        return set(a) == set(b) and all(_norm_eq(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_norm_eq, a, b))
    return a == b


def fleet_egress(n: int, store, device_name: str, device: str = "cuda") -> dict:
    """``bench.py --fleet``'s egress leg: each round every member and its
    twin take the same 4 fresh keys, then one ``fleet.sync_tick()`` is
    timed against the twins' ``sync_to_all()`` loop, and every sink's
    stream must equal its twin sink's, message for message; the cursors
    too at the end."""
    import torch

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    leg = f"egress {store or 'binned'} N={n}"
    tag = f"fe{store or 'b'}{n}"
    t, fleet, solos, _ = fleet_universe(n, store, device, tag, egress=True)
    members = fleet.replicas
    mem = FleetMemory(leg, cuda)
    dts: dict = {"fleet": [], "solo": []}
    msgs = 0
    for rnd in range(FLEET_ROUNDS + 1):  # round 0 warms up
        base = 1_000_003 * rnd
        for i in range(n):
            items = [[base + i * 1000 + j, base + i * 1000 + j] for j in range(FLEET_KEYS_PER_ROUND)]
            members[i].mutate_batch("add", items)
            solos[i].mutate_batch("add", items)
        sync()
        t1 = time.perf_counter()
        fleet.sync_tick()
        sync()
        if rnd:
            dts["fleet"].append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        for r in solos:
            r.sync_to_all()
        sync()
        if rnd:
            dts["solo"].append(time.perf_counter() - t1)
        for i in range(n):
            fm, om = t.drain(f"{tag}_fr{i}"), t.drain(f"{tag}_or{i}")
            if not len(fm) == len(om) > 0:
                raise AssertionError(f"{leg}: round {rnd} member {i}: {len(fm)} vs {len(om)} messages")
            for a, b in zip(fm, om):
                if not _norm_eq(_norm_out(a), _norm_out(b)):
                    raise AssertionError(f"{leg}: round {rnd} member {i}: outbound {type(a).__name__} differs")
            msgs += len(fm)
            members[i]._outstanding.clear()
            solos[i]._outstanding.clear()
        mem.note(rnd, sum(state_nbytes(r.state) for r in members))
    for a, b in zip(members, solos):
        for va, vb in zip(a._push_cursor.values(), b._push_cursor.values()):
            if not np.array_equal(va, vb):
                raise AssertionError(f"{leg}: push cursors diverged at {a.name}")
        if list(a._rm_cursor.values()) != list(b._rm_cursor.values()):
            raise AssertionError(f"{leg}: remove cursors diverged at {a.name}")
    check_on_card(list(members) + solos, device)
    eg = fleet.stats()["egress"]
    med = lambda ds: float(np.median(ds))
    m = {
        "replicas": n, "store": store or "binned",
        "fleet_member_syncs_per_sec": n / med(dts["fleet"]), "solo_member_syncs_per_sec": n / med(dts["solo"]),
        "fleet_tick_ms": [x * 1e3 for x in dts["fleet"]], "solo_loop_ms": [x * 1e3 for x in dts["solo"]],
        "messages": msgs, "egress": eg, "memory_by_round": mem.rounds,
    }
    m["speedup"] = m["fleet_member_syncs_per_sec"] / m["solo_member_syncs_per_sec"]
    log(f"[fleet] {leg}: fleet {m['fleet_member_syncs_per_sec']:.3f} vs solo {m['solo_member_syncs_per_sec']:.3f} "
        f"member syncs/s (median of {FLEET_ROUNDS} rounds; speedup {m['speedup']:.3f}); tick ms "
        f"{[round(x, 3) for x in m['fleet_tick_ms']]}, solo loop ms {[round(x, 3) for x in m['solo_loop_ms']]}; "
        f"egress dispatches {eg['dispatches']}, batched jobs {eg['batched_jobs']}, solo jobs {eg['solo_jobs']}, "
        f"trees batched {eg['trees_batched']}; {msgs} outbound messages equal to the twins' on {device_name}")
    return m


#: phase 7's legs: (leg, N, store); the first ingress size is the
#: bench's gate size, the second its largest
FLEET_LEGS = [("ingress", 256, None), ("ingress", 1024, None), ("egress", 256, None),
              ("ingress", 64, "hash"), ("egress", 64, "hash")]


#: the whole run's guard, seconds: phase 7a's N = 1024 leg runs at 512
#: only if the run would otherwise pass it (a run must end within 1200 s).
#: On an H100 at 700 W whole runs took 899-1121 s with the guard at
#: 1000 s, and one past 1200 s: the guard leaves 500 s of the limit for a slower host
RUN_GUARD_S = 700.0


def phase_fleet(device_name: str, t_start: float, legs=FLEET_LEGS, reserve_s: float = 0.0) -> dict:
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    probe_lookup_kernel.reset()  # this path's run starts here: it launches neither kernel
    batched_roots_kernel.reset()
    out: dict = {}
    per_member_s = 0.0
    for k, (leg, n, store) in enumerate(legs):
        if leg == "ingress" and per_member_s and n > 512:
            # the leg's time grows with N: if the rest of the run (and
            # ``reserve_s`` for the phases after this one) would pass the
            # guard, this leg runs at 512 members
            rest = sum(m for lg, m, _ in legs[k:]) * per_member_s + reserve_s
            if time.perf_counter() - t_start + rest > RUN_GUARD_S:
                log(f"[cut] phase 7a ingress N={n} -> 512: {time.perf_counter() - t_start:.3f} s so far, "
                    f"about {rest:.3f} s to go at N={n} (phase 8 reserved {reserve_s:.0f} s)")
                n = 512
        t0 = time.perf_counter()
        fn = fleet_ingress if leg == "ingress" else fleet_egress
        m = fn(n, store, device_name)
        m["leg_s"] = time.perf_counter() - t0
        per_member_s = max(per_member_s, m["leg_s"] / n)
        out[f"{leg}_{store or 'binned'}_{n}"] = m
    launches = {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                batched_roots_kernel.name: batched_roots_kernel.launches}
    out["launches"] = launches
    log(f"[fleet] kernel launches on the fleet path: {launches}")
    if any(launches.values()):
        raise AssertionError(f"a kernel was launched on the fleet path: {launches}")
    return out


def fleet_det_script(device: str, store=None) -> bytes:
    """Phase 4's fleet script: 4 members, each fed by two senders on
    disjoint bucket ranges (so each member's group is two deep), three
    rounds; one push is lost, so the next interval of that bucket gaps
    inside member 0's group mid-batch and takes the solo partition and
    repair. Returns the members' canonical bytes and the fleet's
    counters."""
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    t, c = LocalTransport(), LogicalClock()
    mk = lambda name, node: dc.start_link(
        dc.AWLWWMap, store=store, threaded=False, transport=t, clock=c, name=name, node_id=node,
        capacity=512, tree_depth=6, sync_timeout=1e9, device=device,
    )
    members = [mk(f"fd{i}", 7 + i) for i in range(4)]
    senders = [mk(f"fs{j}", 0xF00000000000000B - j) for j in range(8)]
    fleet = dc.Fleet(members)
    for j, s in enumerate(senders):
        s.set_neighbours([members[j // 2]])
    keys = [keys_for_buckets(8 * j, 8 * (j + 1), 12, 63, 10_000 * j) for j in range(8)]

    def deliver() -> None:
        for s in senders:
            s.sync_to_all()
        for r in members:
            _entries_to(t, r.addr)
        fleet.drain()
        for s in senders:  # repairs are answered; walk back-traffic is dropped
            for m in t.drain(s.addr):
                if isinstance(m, sync_proto.GetDiffMsg):
                    s.handle(m)

    for j, s in enumerate(senders):
        s.mutate_batch("add", [[k, f"v{k}"] for k in keys[j][:8]])
    deliver()
    k1, k2 = keys_for_buckets(0, 1, 2, 63, 90_000)
    senders[0].mutate("add", [k1, "one"])
    senders[0].sync_to_all()
    t.drain(members[0].addr)  # this push is lost
    senders[0].mutate("add", [k2, "two"])
    for j, s in enumerate(senders):
        s.mutate("remove", [keys[j][0]])
        s.mutate_batch("add", [[k, f"w{k}"] for k in keys[j][8:]])
    deliver()
    deliver()
    st = fleet.stats()
    for i, r in enumerate(members):
        want = {k: v for s in senders[2 * i: 2 * i + 2] for k, v in s.read().items()}
        if r.read() != want:
            raise AssertionError(f"{device}: fleet member {i}'s read differs from its senders'")
    if st["fallbacks"]["escape"] < 1 or members[0].stats()["ingress"]["gap_partitions"] < 1 or st["dispatches"] < 2:
        raise AssertionError(f"{device}: the fleet script batched nothing or took no gap partition: {st}")
    counters = {k: st[k] for k in ("dispatches", "batched_messages", "occupancy_hist", "fallbacks", "stack_cache")}
    return b"".join(r.canonical_state_bytes() for r in members) + repr(counters).encode()


# ---------------------------------------------------------------------------
# phase 8: durability (the write-ahead log, compaction, crash recovery)

#: where phase 8 keeps its WAL directories: inside the checkout, under
#: the ignored ``build/``, removed when the phase ends
WAL_ROOT = Path(__file__).resolve().parent / "build" / "wal"
#: where phase 10 writes its profiler trace (Chrome format)
TRACE_ROOT = Path(__file__).resolve().parent / "build" / "traces"
#: phase 8's WAL settings: the JAX package's defaults
WAL_SEGMENT_BYTES = 4 << 20
WAL_FSYNC_MODE = "batch"
#: 8a/8b: the overwrite pass writes this share of the loaded keys again
OVERWRITE_SHARE = 2


class WalEvents:
    """``WAL_APPEND`` / ``WAL_COMPACT`` / ``WAL_RECOVER`` telemetry by
    replica name: each event's measurements, in order."""

    def __init__(self) -> None:
        from delta_crdt_ex_tpu_torch.runtime import telemetry

        self.telemetry = telemetry
        self.lock = threading.Lock()
        self.events: dict = {}
        self.handlers = []
        for ev in (telemetry.WAL_APPEND, telemetry.WAL_COMPACT, telemetry.WAL_RECOVER):
            h = lambda _e, meas, meta, _k=ev[-1]: self._note(_k, meta["name"], meas)
            telemetry.attach(ev, h)
            self.handlers.append((ev, h))

    def _note(self, kind: str, name, meas: dict) -> None:
        with self.lock:
            self.events.setdefault((kind, name), []).append(dict(meas))

    def get(self, kind: str, name) -> list:
        with self.lock:
            return list(self.events.get((kind, name), []))

    def close(self) -> None:
        for ev, h in self.handlers:
            self.telemetry.detach(ev, h)


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def durability_leg(tag: str, store, n_keys: int, device_name: str, device: str = "cuda",
                   compact_every: int = 1024, subscribers: bool = False) -> dict:
    """Two threaded replicas with phase 3b's geometry (sync_interval 20
    ms, max_sync_size 500), each with its own ``wal_dir`` and the JAX
    package's WAL defaults: ``n_keys`` keys loaded into replica 1 in
    1024-op batches (one ``batch`` record each; a compaction snapshot at
    every ``compact_every``-th record), replica 2 logging what
    anti-entropy brings it as ``entries`` records; then half the keys
    overwritten, so recovery is a snapshot plus a replay. Both replicas
    crash right after the overwrites (replica 2 holding the load, still
    catching up on them) and restart from
    disk: each must come back with its pre-crash canonical bytes, read,
    node id and seq, on the card; then the pair must catch up to equal
    canonical bytes (``catch_up_s``, replica 1 re-pushing every row: push
    cursors are soft state) and new writes must reach the peer (counter
    continuity)."""
    import shutil

    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel
    from delta_crdt_ex_tpu_torch.runtime import telemetry
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root = WAL_ROOT / tag
    shutil.rmtree(root, ignore_errors=True)
    leg = f"{tag} ({store or 'binned'}, {n_keys} keys)"
    ev = WalEvents()
    arrivals = SyncDoneCount(f"{tag}1")
    telemetry.attach(telemetry.SYNC_DONE, arrivals)
    logs = (DiffLog(), DiffLog()) if subscribers else (None, None)
    opts = lambda i: dict(
        name=f"{tag}{i}", store=store, sync_interval=0.02, max_sync_size=500, capacity=2 * n_keys,
        device=device, wal_dir=str(root / f"r{i}"), fsync_mode=WAL_FSYNC_MODE,
        segment_bytes=WAL_SEGMENT_BYTES, compact_every=compact_every, on_diffs=logs[i],
    )
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t = LocalTransport()
    reps = [dc.start_link(dc.AWLWWMap, transport=t, **opts(i)) for i in range(2)]
    reborn: list = []
    deadline = time.perf_counter() + SLICE_BUDGET_S
    m: dict = {"keys": n_keys, "store": store or "binned", "compact_every": compact_every,
               "fsync_mode": WAL_FSYNC_MODE, "segment_bytes": WAL_SEGMENT_BYTES}

    def settle(pair, what: str) -> bytes:
        while True:
            c = [r.canonical_state_bytes() for r in pair]
            if c[0] == c[1]:
                return c[0]
            if time.perf_counter() > deadline:
                raise AssertionError(f"{leg}: {what}: replicas did not converge to equal canonical bytes")
            time.sleep(0.1)

    def launches() -> dict:
        return {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                batched_roots_kernel.name: batched_roots_kernel.launches,
                "probe_by_shape": probe_shape_launches()}

    try:
        r1, r2 = reps
        dc.set_neighbours(r1, [r2])
        dc.set_neighbours(r2, [r1])
        probe_lookup_kernel.reset()  # this path's run starts here
        batched_roots_kernel.reset()
        t0 = time.perf_counter()
        dc.mutate_batch(r1, "add", [[f"key{i}", i] for i in range(n_keys)], timeout=SLICE_BUDGET_S)
        m["load_wal_s"] = time.perf_counter() - t0
        # replica 1's loop syncs only between mutate_batch calls (the call
        # holds its lock): wait until replica 2 has logged the load
        m["converge_s"] = arrivals.wait(n_keys, deadline, f"{n_keys} keys on replica 2") - t0
        n_over = n_keys // OVERWRITE_SHARE
        t0 = time.perf_counter()
        dc.mutate_batch(r1, "add", [[f"key{i}", n_keys + i] for i in range(n_over)], timeout=SLICE_BUDGET_S)
        m["overwrite_s"] = time.perf_counter() - t0
        log(f"[durability] {leg}: load {m['load_wal_s']:.3f} s with the WAL (on replica 2 after "
            f"{m['converge_s']:.3f} s); {n_over} keys overwritten in {m['overwrite_s']:.3f} s on {device_name}")
        # crash first: the loops stop, and each replica's state is what
        # its log holds (every commit fsynced), so the crashed objects
        # are the pre-crash images
        for r in reps:
            r.crash()
        sync()
        pre = [(r.canonical_state_bytes(), r.read(), r.node_id, r._seq) for r in reps]
        want = {f"key{i}": (n_keys + i if i < n_over else i) for i in range(n_keys)}
        if pre[0][1] != want:
            raise AssertionError(f"{leg}: replica 1's pre-crash read differs from the written map")
        if len(pre[1][1]) != n_keys or pre[1][3] <= 0:
            raise AssertionError(f"{leg}: replica 2 had not logged the load before the crash")
        m["launches_before_crash"] = launches()
        per = {}
        for i, r in enumerate(reps):
            app = ev.get("append", r.name)
            snaps = root / f"r{i}" / "snapshots"
            dur = np.array([a["duration_s"] for a in app]) * 1e3
            comp = [c["duration_s"] * 1e3 for c in ev.get("compact", r.name)]
            per[r.name] = {
                "records": len(app), "append_ms_median": float(np.median(dur)) if len(dur) else None,
                "append_ms_p99": float(np.percentile(dur, 99)) if len(dur) else None,
                "append_bytes": int(sum(a["bytes"] for a in app)), "wal_bytes": r.wal_size_bytes(),
                "snapshot_bytes": _dir_bytes(snaps) if snaps.exists() else 0,
                "compactions": len(comp), "compaction_ms": comp, "seq": r._seq,
            }
        m["wal"] = per
        probe_lookup_kernel.reset()
        for i in range(2):
            t0 = time.perf_counter()
            reborn.append(dc.start_link(dc.AWLWWMap, transport=t, **opts(i)))
            sync()
            per[f"{tag}{i}"]["recover_s"] = time.perf_counter() - t0
        m["launches_during_recovery"] = launches()
        for i, r in enumerate(reborn):
            p = per[r.name]
            # WAL_RECOVER spans the restart's recovery: reading the log
            # and the snapshot, the rehydrate and the replay (no device
            # synchronise; ``recover_s`` is the whole restart, synchronised)
            rec = ev.get("recover", r.name)
            p["wal_recover_s"] = rec[-1]["duration_s"] if rec else None
            p["records_replayed"] = rec[-1]["records"] if rec else 0
            p["recovered_bytes"] = rec[-1]["bytes"] if rec else 0
            post = (r.canonical_state_bytes(), r.read(), r.node_id, r._seq)
            for what, a, b in zip(("canonical bytes", "read", "node_id", "seq"), pre[i], post):
                if a != b:
                    raise AssertionError(f"{leg}: {r.name} recovered with a different {what}")
        check_on_card(reborn, device)
        log(f"[durability] {leg}: both replicas crashed and recovered from disk with equal canonical bytes, "
            f"reads, node ids and seqs; state on {device}; per replica "
            + json.dumps({k: {f: v for f, v in p.items() if f != "compaction_ms"} for k, p in per.items()})
            + f" on {device_name}")
        r1, r2 = reborn
        probe_lookup_kernel.reset()
        t0 = time.perf_counter()
        dc.set_neighbours(r1, [r2])
        dc.set_neighbours(r2, [r1])
        # poll a sample (a point read holds the lock briefly; a canonical
        # pass over the whole map would stall the loops it waits for),
        # then check the whole state
        sample = [f"key{i}" for i in range(0, n_keys, max(1, n_keys // 4096))][:4095] + [f"key{n_over - 1}"]
        while dc.read_keys(r2, sample) != {k: want[k] for k in sample}:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{leg}: replica 2 did not catch up after the recovery")
            time.sleep(0.2)
        settle(reborn, "after the recovery")
        m["catch_up_s"] = time.perf_counter() - t0
        m["catchup"] = {r.name: r.stats()["catchup"] for r in reborn}
        log(f"[durability] {leg}: log-shipping catch-up after the restart (log_shipping={r1.log_shipping}): "
            f"{json.dumps(m['catchup'])}")
        # counter continuity: fresh keys are new dots in buckets the
        # peer's context already covers, so a re-minted counter would be
        # dropped there
        m.update(timed_propagations(r1, r2, t, arrivals, deadline, lambda i: f"post{i}"))
        probe = [f"key{i}" for i in range(0, n_keys, max(1, n_keys // 4096))][:4086] + [f"post{i}" for i in range(10)]
        want.update({f"post{i}": i for i in range(10)})
        settle(reborn, "after the post-recovery writes")
        for r in reborn:
            if dc.read_keys(r, probe) != {k: want[k] for k in probe}:
                raise AssertionError(f"{leg}: {r.name}: read_keys after recovery differs from the written map")
        m["launches_after_recovery"] = launches()
        m["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
        if store == "hash":
            # launches below compare the kernel with its plain version on
            # the recovered tables, at every Q this leg launched at; they
            # are not the path's
            qs = {int(k.split("x")[2]) for w in ("launches_before_crash", "launches_during_recovery",
                                                 "launches_after_recovery") for k in m[w]["probe_by_shape"]}
            m["table_max_abs_err"] = check_main_tables(
                reborn, n_keys, [], extra=[f"post{i}" for i in range(10)], q_sizes=sorted(qs))
        log(f"[durability] {leg}: the pair caught up to equal canonical bytes {m['catch_up_s']:.3f} s after "
            f"the recovery; then 10 single-op propagations (ms): "
            f"{[round(x, 3) for x in m['propagation_ms']]} median {float(np.median(m['propagation_ms'])):.3f}; "
            f"replica 2's mailbox before each {m['queued_before']}, messages it handled until each arrived "
            f"{m['handled_during']}; "
            f"read_keys of {len(probe)} keys equal on both; kernel launches before the crash "
            f"{m['launches_before_crash']}, during recovery {m['launches_during_recovery']}, after "
            f"{m['launches_after_recovery']}; peak memory {m['peak_mem_bytes']} B on {device_name}")
        return m
    finally:
        ev.close()
        telemetry.detach(telemetry.SYNC_DONE, arrivals)
        for r in reps:
            r.crash()
        for r in reborn:
            r.stop()
        shutil.rmtree(root, ignore_errors=True)


def fleet_wal(n: int, device_name: str, device: str = "cuda") -> dict:
    """Phase 7a's ingress round shape (n senders, 4 fresh keys a sender a
    round, 1 warm-up and 5 timed ``fleet.drain()`` rounds) into a binned
    fleet without and then with a ``wal_dir`` per member (the JAX
    package's WAL defaults: one fsynced ``entries`` record per merged
    message). Then every WAL member crashes and recovers as a solo
    replica with equal canonical bytes."""
    import gc
    import shutil

    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root = WAL_ROOT / "fleet"
    out: dict = {"replicas": n}
    for wal in (False, True):
        gc.collect()
        shutil.rmtree(root, ignore_errors=True)
        t, clock = LocalTransport(), LogicalClock()
        mk = lambda name, **kw: dc.start_link(
            dc.AWLWWMap, threaded=False, transport=t, clock=clock, capacity=(1 << FLEET_DEPTH) * 16,
            tree_depth=FLEET_DEPTH, sync_timeout=1e9, device=device, name=name, **kw,
        )
        wal_opts = lambda i: {"wal_dir": str(root / f"m{i}"), "fsync_mode": WAL_FSYNC_MODE} if wal else {}
        members = [mk(f"fw{i}", node_id=10_000 + i, **wal_opts(i)) for i in range(n)]
        senders = [mk(f"fws{i}") for i in range(n)]
        fleet = dc.Fleet(members)
        reborn: list = []
        try:
            for s, r in zip(senders, members):
                s.set_neighbours([r])
            dts = []
            for rnd in range(FLEET_ROUNDS + 1):
                base = 1_000_003 * rnd
                for i, s in enumerate(senders):
                    s.mutate_batch("add", [[base + i * 1000 + j, base + i * 1000 + j]
                                           for j in range(FLEET_KEYS_PER_ROUND)])
                for s in senders:
                    s.sync_to_all()
                for r in members:
                    if _entries_to(t, r.addr) < 1:
                        raise AssertionError(f"fleet WAL leg: member {r.name} got no entries")
                sync()
                t1 = time.perf_counter()
                fleet.drain()
                sync()
                if rnd > 0:
                    dts.append(time.perf_counter() - t1)
                for s in senders:
                    t.drain(s.addr)
            key = "fleet_wal" if wal else "fleet"
            out[f"{key}_merges_per_sec"] = n / float(np.median(dts))
            out[f"{key}_round_ms"] = [x * 1e3 for x in dts]
            out[f"{key}_dispatches"] = fleet.stats()["dispatches"]
            check_on_card(members, device)
            if wal:
                pre = [(r.canonical_state_bytes(), r.node_id, r._seq) for r in members]
                out["wal_bytes"] = sum(r.wal_size_bytes() for r in members)
                for r in members:
                    r.crash()
                t1 = time.perf_counter()
                for i in range(n):
                    reborn.append(dc.start_link(
                        dc.AWLWWMap, threaded=False, transport=LocalTransport(), clock=LogicalClock(),
                        capacity=(1 << FLEET_DEPTH) * 16, tree_depth=FLEET_DEPTH, sync_timeout=1e9,
                        device=device, name=f"fw{i}", **wal_opts(i)))
                sync()
                out["recover_s"] = time.perf_counter() - t1
                for i, r in enumerate(reborn):
                    if (r.canonical_state_bytes(), r.node_id, r._seq) != pre[i]:
                        raise AssertionError(f"fleet WAL leg: member {r.name} recovered differently")
                check_on_card(reborn, device)
        finally:
            for r in members + senders:
                r.crash()
            for r in reborn:
                r.crash()
            shutil.rmtree(root, ignore_errors=True)
    out["wal_over_plain"] = out["fleet_wal_merges_per_sec"] / out["fleet_merges_per_sec"]
    log(f"[durability] fleet N={n} binned, 7a's ingress rounds: {out['fleet_wal_merges_per_sec']:.3f} merges/s "
        f"with a WAL per member vs {out['fleet_merges_per_sec']:.3f} without (ratio {out['wal_over_plain']:.4f}); "
        f"WAL round ms {[round(x, 3) for x in out['fleet_wal_round_ms']]}; {out['wal_bytes']} WAL bytes; every "
        f"member crashed and recovered solo with equal canonical bytes, node id and seq in {out['recover_s']:.3f} s "
        f"on {device_name}")
    return out


#: seconds phase 7 keeps free for phase 8 when it decides whether its
#: N = 1024 leg runs (phase 8 took 259.546 s on an H100 at 700 W in the
#: last whole run before this guard)
DURABILITY_RESERVE_S = 300.0
#: phase 8's legs: the default store at phase 3b's size, the hash store
#: at 2^17 keys (a compaction snapshot at its last load batch, as 8a's),
#: and the fleet at 7a's first size
DURABILITY_KEYS = 1 << 20
DURABILITY_HASH_KEYS = 1 << 17
DURABILITY_FLEET_N = 256
#: 8a's key count when the clock demands a cut (phases 9 and 11 keep
#: their reserves): on an H100 at 700 W 8a took about 227 s of phase 8's
#: 296.657 s at 2^20 keys in the first whole run with phase 11
DURABILITY_CUT_KEYS = 1 << 18


def phase_durability(device_name: str, keys: int = DURABILITY_KEYS, hash_keys: int = DURABILITY_HASH_KEYS,
                     fleet_n: int = DURABILITY_FLEET_N, device: str = "cuda", t_start: "float | None" = None) -> dict:
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    t0 = time.perf_counter()
    if t_start is not None and keys > DURABILITY_CUT_KEYS:
        spent = t0 - t_start
        rest = DURABILITY_RESERVE_S + TCP_RESERVE_S + TREE_RESERVE_S
        if spent + rest > RUN_GUARD_S:
            log(f"[cut] phase 8a keys {keys} -> {DURABILITY_CUT_KEYS}: {spent:.3f} s so far, about {rest:.0f} s "
                f"to go with phase 8 at {keys} and phases 9 and 11 after it, past the {RUN_GUARD_S:.0f} s guard")
            keys = DURABILITY_CUT_KEYS
    out = {"8a": durability_leg("dura", None, keys, device_name, device, compact_every=max(1, keys // 1024))}
    for when in ("launches_before_crash", "launches_during_recovery", "launches_after_recovery"):
        ln = out["8a"][when]
        if ln[probe_lookup_kernel.name] or ln[batched_roots_kernel.name]:
            raise AssertionError(f"8a: a kernel was launched on the binned durability path: {ln}")
    out["8b"] = durability_leg("durh", "hash", hash_keys, device_name, device,
                               compact_every=max(1, hash_keys // 1024), subscribers=True)
    probe_total = sum(out["8b"][w][probe_lookup_kernel.name] for w in
                      ("launches_before_crash", "launches_during_recovery", "launches_after_recovery"))
    out["8b"]["probe_launches"] = probe_total
    if device == "cuda" and out["8b"]["launches_after_recovery"][probe_lookup_kernel.name] <= 0:
        raise AssertionError("8b: the probe kernel was not launched on the recovered hash tables")
    out["8c"] = fleet_wal(fleet_n, device_name, device)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[durability] phase 8 {out['phase_s']:.3f} s; probe launches on the hash leg {probe_total} "
        f"by HxWxQ (before the crash {out['8b']['launches_before_crash']['probe_by_shape']}, during recovery "
        f"{out['8b']['launches_during_recovery']['probe_by_shape']}, after "
        f"{out['8b']['launches_after_recovery']['probe_by_shape']})")
    return out


# ---------------------------------------------------------------------------
# phase 9: the TCP path

#: 9a's key count (the north star, ``SURVEY.md:282``) and the cut it
#: takes only when the clock demands it; 9b's (phase 3's); the keys
#: written on replica 1 while replica 2 is down; 9c's fleet size
TCP_KEYS = 1 << 20
TCP_CUT_KEYS = 1 << 18
TCP_HASH_KEYS = 1 << 17
TCP_DOWN_KEYS = 1 << 16
TCP_FLEET_N = 64
#: seconds phase 9 needs after phase 8 with 9a cut to 2^18 keys (what
#: phase 7's guard keeps free for it), and 9a's seconds at 2^20 keys
#: beyond its seconds at 2^18 (the cut's test). On an H100 at 700 W
#: (``PERF.md`` §6) phase 9 took 177.074 s with 9a at 2^20 taking
#: 126.832 s, and 9a took 27.294 s at 2^18: about 77 s and 100 s (the
#: guard's 200 s below the run's limit covers a slower host)
TCP_RESERVE_S = 150.0
TCP_FULL_9A_EXTRA_S = 100.0


def codec_times(obj, reps: int = 3) -> dict:
    """Milliseconds to encode ``obj`` (a ``(name, message)`` frame body)
    as a ``_MSGB`` frame, with the large plain containers (payload
    dicts) C-pickled and spliced into the envelope (median of ``reps``)
    and with the splice off (the pure-Python pickler writes the whole
    envelope; once, as it takes seconds on a large frame); the frame's
    bytes each way, and the port's decode ms."""
    from delta_crdt_ex_tpu_torch.runtime import tcp_transport as tt

    out: dict = {}
    splice_min = tt._SPLICE_MIN
    try:
        for mode, smin, n in (("splice", splice_min, reps), ("no_splice", float("inf"), 1)):
            tt._SPLICE_MIN = smin
            dts = []
            for _ in range(n):
                t0 = time.perf_counter()
                frame = tt._encode_msgb(obj)
                dts.append(time.perf_counter() - t0)
            out[f"{mode}_encode_ms"] = float(np.median(dts)) * 1e3
            out[f"{mode}_bytes"] = len(frame)
    finally:
        tt._SPLICE_MIN = splice_min
    t0 = time.perf_counter()
    tt._decode_msgb(frame)
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def tcp_leg(tag: str, store, n_keys: int, device_name: str, device: str = "cuda",
            subscribers: bool = False, down_keys: int = TCP_DOWN_KEYS, cut_note: str = "") -> dict:
    """Two threaded replicas, each on its own ``TcpTransport`` on
    127.0.0.1 and addressing its peer as ``(name, (host, port))``, each
    with a ``wal_dir`` and the JAX package's WAL defaults, at the port's
    default ``log_shipping=True`` (phase 3b's geometry: sync_interval 20
    ms, max_sync_size 500). ``n_keys`` keys load on replica 1 in 1024-op
    batches and converge over TCP; replica 2 takes a compaction
    checkpoint once its applied watermark reaches replica 1's seq (the
    snapshot a periodic compaction leaves), then crashes: its node's
    transport stays up, so what replica 1 pushes meanwhile is lost in
    flight, as to a crash the sender has not yet noticed. ``down_keys``
    more keys are written on replica 1; replica 2 restarts from its
    ``wal_dir`` and catches up by log shipping (``GetLogMsg`` /
    ``LogChunkMsg``). Correct: equal canonical bytes, replica 2's
    ``read()`` (and its diff feed, with subscribers) equal to the written
    map, at least one chunk applied, state on the card."""
    import shutil

    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel
    from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto, telemetry

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    root = WAL_ROOT / tag
    shutil.rmtree(root, ignore_errors=True)
    leg = f"{tag} ({store or 'binned'}, {n_keys} keys{cut_note})"
    arrivals = SyncDoneCount(f"{tag}2")
    telemetry.attach(telemetry.SYNC_DONE, arrivals)
    logs = (DiffLog(), DiffLog()) if subscribers else (None, None)
    opts = lambda i, t: dict(
        name=f"{tag}{i + 1}", store=store, transport=t, sync_interval=0.02, max_sync_size=500,
        capacity=2 * n_keys, device=device, wal_dir=str(root / f"r{i + 1}"), fsync_mode=WAL_FSYNC_MODE,
        segment_bytes=WAL_SEGMENT_BYTES, on_diffs=logs[i],
    )
    ta, tb = dc.TcpTransport("127.0.0.1"), dc.TcpTransport("127.0.0.1")
    reps: list = []
    m: dict = {"keys": n_keys, "store": store or "binned", "down_keys": down_keys, "cut": bool(cut_note)}
    deadline = time.perf_counter() + SLICE_BUDGET_S
    try:
        probe_lookup_kernel.reset()  # this path's run starts here
        batched_roots_kernel.reset()
        r1, r2 = dc.start_link(dc.AWLWWMap, **opts(0, ta)), dc.start_link(dc.AWLWWMap, **opts(1, tb))
        reps += [r1, r2]
        if not (r1.log_shipping and r2.log_shipping):
            raise AssertionError(f"{leg}: log shipping is not the default")
        dc.set_neighbours(r1, [tb.remote_addr(r2.name)])
        dc.set_neighbours(r2, [ta.remote_addr(r1.name)])

        def settle(what: str) -> bytes:
            while True:
                c = [r.canonical_state_bytes() for r in (r1, r2)]
                if c[0] == c[1]:
                    return c[0]
                if time.perf_counter() > deadline:
                    raise AssertionError(f"{leg}: {what}: replicas did not converge to equal canonical bytes")
                time.sleep(0.1)

        def wait_keys(n: int, what: str) -> float:
            if subscribers:
                logs[1].wait(lambda d: len(d.view) >= n, deadline, what)
                return time.perf_counter()
            return arrivals.wait(n, deadline, what)

        t0 = time.perf_counter()
        dc.mutate_batch(r1, "add", [[f"key{i}", i] for i in range(n_keys)], timeout=SLICE_BUDGET_S)
        m["load_s"] = time.perf_counter() - t0
        m["converge_s"] = wait_keys(n_keys, f"{n_keys} keys on replica 2") - t0
        settle("after the load")
        m["settle_s"] = time.perf_counter() - t0
        m["wire_after_load"] = {"replica1": ta.transport_stats(), "replica2": tb.transport_stats()}
        log(f"[tcp] {leg}: load {m['load_s']:.3f} s; on replica 2 after {m['converge_s']:.3f} s, equal canonical "
            f"bytes after {m['settle_s']:.3f} s; wire from replica 1 {json.dumps(m['wire_after_load']['replica1'])} "
            f"on {device_name}")
        # the wire codec on the leg's own frame shape: one 1024-row
        # entries slice of the loaded map, as a walk or a chunk ships it
        with r1._lock:
            rows = np.arange(min(1024, r1.num_buckets), dtype=np.int64)
            arrays, payloads = r1._extract_rows_wire(rows)
        to = tb.remote_addr(r2.name)
        m["codec"] = codec_times((to[0], sync_proto.EntriesMsg(
            originator=r1.addr, frm=r1.addr, to=to, buckets=rows, arrays=arrays, payloads=payloads)))
        m["codec"]["entries"] = len(payloads)
        log(f"[tcp-codec] {leg}: one {len(rows)}-row entries frame ({len(payloads)} entries): "
            f"{json.dumps(m['codec'])} on {device_name}")

        # the compaction point: replica 2's snapshot carries its watermark
        # of replica 1's history once a walk equality proved it
        while True:
            with r2._lock:
                wm = r2._applied_seq.get(r1.addr, 0)
            if wm >= r1._seq:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"{leg}: replica 2's watermark stayed at {wm} < {r1._seq}")
            time.sleep(0.05)
        r2.checkpoint()
        m["watermark_at_crash"] = wm
        r2.crash()
        sync()
        t0 = time.perf_counter()
        dc.mutate_batch(r1, "add", [[f"down{i}", i] for i in range(down_keys)], timeout=SLICE_BUDGET_S)
        m["down_write_s"] = time.perf_counter() - t0
        time.sleep(0.5)  # replica 1's loop pushes and opens walks toward the dead replica: lost
        t0 = time.perf_counter()
        r2 = dc.start_link(dc.AWLWWMap, **opts(1, tb))
        sync()
        m["recover_s"] = time.perf_counter() - t0
        reps.append(r2)
        t0 = time.perf_counter()
        dc.set_neighbours(r2, [ta.remote_addr(r1.name)])
        want = {f"key{i}": i for i in range(n_keys)} | {f"down{i}": i for i in range(down_keys)}
        sample = [f"down{i}" for i in range(0, down_keys, max(1, down_keys // 4096))]
        while dc.read_keys(r2, sample) != {k: want[k] for k in sample}:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{leg}: replica 2 did not catch up after the restart")
            time.sleep(0.1)
        settle("after the restart")
        m["catch_up_s"] = time.perf_counter() - t0
        m["catchup_replica2"] = r2.stats()["catchup"]
        m["catchup_replica1"] = r1.stats()["catchup"]
        if m["catchup_replica2"]["chunks_applied"] < 1:
            raise AssertionError(f"{leg}: replica 2 caught up without a log-shipped chunk: {m['catchup_replica2']}")
        log(f"[tcp] {leg}: replica 2 crashed with watermark {wm}, {down_keys} keys written meanwhile in "
            f"{m['down_write_s']:.3f} s; restart {m['recover_s']:.3f} s; caught up to equal canonical bytes "
            f"{m['catch_up_s']:.3f} s after the restart; catch-up on replica 2 "
            f"{json.dumps(m['catchup_replica2'])}, served by replica 1 {json.dumps(m['catchup_replica1'])} "
            f"on {device_name}")

        m.update(timed_propagations(r1, r2, tb, arrivals, deadline, lambda i: f"post{i}"))
        want.update({f"post{i}": i for i in range(10)})
        settle("after the post-restart writes")
        t0 = time.perf_counter()
        got = r2.read()
        m["read_ms"] = (time.perf_counter() - t0) * 1e3
        if got != want:
            raise AssertionError(f"{leg}: replica 2's read() differs from the written map")
        if subscribers and logs[1].view != want:
            raise AssertionError(f"{leg}: replica 2's diff feed differs from the written map")
        check_on_card([r1, r2], device)
        m["launches"] = {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                         batched_roots_kernel.name: batched_roots_kernel.launches}
        m["probe_by_shape"] = probe_shape_launches()
        m["wire"] = {"replica1": ta.transport_stats(), "replica2": tb.transport_stats()}
        if store == "hash":
            # launches below compare the kernel with its plain version on
            # both final tables, at every Q this leg launched at; they are
            # not the path's
            m["table_max_abs_err"] = check_main_tables(
                [r1, r2], n_keys, [], extra=[f"down{i}" for i in range(down_keys)] + [f"post{i}" for i in range(10)],
                q_sizes=sorted({int(k.split("x")[2]) for k in m["probe_by_shape"]}))
        log(f"[tcp] {leg}: then 10 single-op propagations (ms) {[round(x, 3) for x in m['propagation_ms']]} "
            f"median {float(np.median(m['propagation_ms'])):.3f}; replica 2's mailbox before each "
            f"{m['queued_before']}, messages it handled until each arrived {m['handled_during']}; read() "
            f"{'and the diff feed ' if subscribers else ''}equal to the written map ({len(want)} keys, read "
            f"{m['read_ms']:.3f} ms); state on {device}; kernel launches {m['launches']}, probe by HxWxQ "
            f"{m['probe_by_shape']}; wire in all {json.dumps(m['wire'])} on {device_name}")
        return m
    finally:
        telemetry.detach(telemetry.SYNC_DONE, arrivals)
        for r in reps:
            r.crash()
        ta.close()
        tb.close()
        shutil.rmtree(root, ignore_errors=True)


def tcp_fleets(n: int, device_name: str, device: str = "cuda") -> dict:
    """Fleet frames over TCP: a binned fleet of ``n`` members on
    transport A and its ring peers, a fleet of ``n`` on transport B
    (member i of A ↔ member i of B), phase 7's member shape (64 buckets,
    capacity 1024, 4 fresh keys a member a round, 1 warm-up + 5 timed
    rounds); each fleet's sync tick ships one ``FleetFrameMsg`` per peer
    endpoint. Solo twins (the same node ids, clock and writes, no fleet)
    run the same rounds on their own transport pair; at the end every
    member pair and every twin pair has converged and every member
    equals its twin (canonical bytes and read)."""
    import gc

    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel
    from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock

    gc.collect()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    leg = f"fleet frames binned N={n}"
    probe_lookup_kernel.reset()
    batched_roots_kernel.reset()
    ts = [dc.TcpTransport("127.0.0.1") for _ in range(4)]  # fleet A, fleet B, twins A, twins B
    clocks = (LogicalClock(), LogicalClock())
    mk = lambda t, clock, name, node: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=clock, capacity=(1 << FLEET_DEPTH) * 16,
        tree_depth=FLEET_DEPTH, sync_timeout=0.2, device=device, name=name, node_id=node,
    )
    groups = [[mk(ts[g], clocks[g // 2], f"tf{'ab'[g % 2]}{'ft'[g // 2]}{i}", 20_000 + 1000 * (g % 2) + i)
               for i in range(n)] for g in range(4)]
    fa, fb = dc.Fleet(groups[0]), dc.Fleet(groups[1])
    sa, sb = groups[2], groups[3]
    out: dict = {"replicas": n}
    shipped: list = []  # fleet A's frames, kept to time the codec on one
    send_frame = ts[0].send_fleet_frame
    ts[0].send_fleet_frame = lambda ep, entries: shipped.append((ep, list(entries))) or send_frame(ep, entries)
    try:
        for a_side, b_side, ta_, tb_ in ((groups[0], groups[1], ts[0], ts[1]), (sa, sb, ts[2], ts[3])):
            for i in range(n):
                a_side[i].set_neighbours([tb_.remote_addr(b_side[i].name)])
                b_side[i].set_neighbours([ta_.remote_addr(a_side[i].name)])
        # the fleet-frame capability is negotiated by HELLO on each
        # pooled connection: wait for it before the timed rounds
        t_end = time.perf_counter() + 10
        while not all(ts[i].fleet_sink(("x", ts[1 - i].endpoint)) for i in (0, 1)):
            if time.perf_counter() > t_end:
                raise AssertionError(f"{leg}: fleet frames were never negotiated")
            time.sleep(0.01)

        def settle() -> None:
            for f in (fa, fb):
                f.drain()
            for t in ts[2:]:
                t.pump()

        dts: dict = {"fleet": [], "solo": []}
        per_tick = []
        for rnd in range(FLEET_ROUNDS + 1):  # round 0 warms up
            base = 1_000_003 * rnd
            for g in range(4):
                for i, r in enumerate(groups[g]):
                    k0 = base + (g % 2) * 500_000 + i * 1000
                    r.mutate_batch("add", [[k0 + j, k0 + j] for j in range(FLEET_KEYS_PER_ROUND)])
            before = fa.stats()["egress"]
            sync()
            t1 = time.perf_counter()
            fa.sync_tick()
            fb.sync_tick()
            sync()
            if rnd:
                dts["fleet"].append(time.perf_counter() - t1)
            after = fa.stats()["egress"]
            per_tick.append((after["frames"] - before["frames"], after["frame_members"] - before["frame_members"]))
            t1 = time.perf_counter()
            for r in sa + sb:
                r.sync_to_all()
            sync()
            if rnd:
                dts["solo"].append(time.perf_counter() - t1)
            time.sleep(0.05)
            settle()
        pairs = list(zip(groups[0], groups[1])) + list(zip(sa, sb))
        t_end = time.perf_counter() + 120
        while not all(a.canonical_state_bytes() == b.canonical_state_bytes() for a, b in pairs):
            if time.perf_counter() > t_end:
                raise AssertionError(f"{leg}: member pairs did not converge")
            fa.sync_tick()
            fb.sync_tick()
            for r in sa + sb:
                r.sync_to_all()
            time.sleep(0.05)
            settle()
        for f, twins in ((fa, sa), (fb, sb)):
            for a, b in zip(f.replicas, twins):
                if a.canonical_state_bytes() != b.canonical_state_bytes() or a.read() != b.read():
                    raise AssertionError(f"{leg}: member {a.name} differs from its solo twin {b.name}")
        check_on_card(groups[0] + groups[1], device)
        launches = {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                    batched_roots_kernel.name: batched_roots_kernel.launches}
        if any(launches.values()):
            raise AssertionError(f"{leg}: a kernel was launched on the fleet path: {launches}")
        if any(f != 1 for f, _ in per_tick):
            raise AssertionError(f"{leg}: frames per tick {per_tick}, want one per endpoint")
        med = lambda ds: float(np.median(ds))
        out.update({
            "fleet_member_syncs_per_sec": 2 * n / med(dts["fleet"]),
            "solo_member_syncs_per_sec": 2 * n / med(dts["solo"]),
            "fleet_tick_ms": [x * 1e3 for x in dts["fleet"]], "solo_loop_ms": [x * 1e3 for x in dts["solo"]],
            "frames_per_tick": per_tick, "egress_a": fa.stats()["egress"], "egress_b": fb.stats()["egress"],
            "wire_a": ts[0].transport_stats(), "launches": launches,
        })
        out["speedup"] = out["fleet_member_syncs_per_sec"] / out["solo_member_syncs_per_sec"]
        ep, entries = shipped[-1]
        out["codec"] = codec_times(sync_proto.FleetFrameMsg(frm=ts[0].endpoint, entries=entries))
        out["codec"]["members"] = len(entries)
        log(f"[tcp-codec] {leg}: fleet A's last frame ({len(entries)} member messages): "
            f"{json.dumps(out['codec'])} on {device_name}")
        log(f"[tcp] {leg}: fleet {out['fleet_member_syncs_per_sec']:.3f} vs solo "
            f"{out['solo_member_syncs_per_sec']:.3f} member syncs/s (both fleets' ticks, median of {FLEET_ROUNDS} "
            f"rounds; speedup {out['speedup']:.3f}); fleet A (frames, frame_members) per tick {per_tick}; every "
            f"member pair converged over TCP and equals its solo twin; wire from A "
            f"{json.dumps(out['wire_a'])} on {device_name}")
        return out
    finally:
        for r in groups[0] + groups[1] + sa + sb:
            r.crash()
        for t in ts:
            t.close()


def phase_tcp(device_name: str, t_start: float, keys: int = TCP_KEYS, hash_keys: int = TCP_HASH_KEYS,
              fleet_n: int = TCP_FLEET_N, device: str = "cuda") -> dict:
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    t0 = time.perf_counter()
    note = ""
    spent = time.perf_counter() - t_start
    if keys > TCP_CUT_KEYS and spent + TCP_RESERVE_S + TCP_FULL_9A_EXTRA_S + TREE_RESERVE_S > RUN_GUARD_S:
        note = f", cut from {keys}: {spent:.3f} s spent when phase 9 began"
        log(f"[cut] phase 9a keys {keys} -> {TCP_CUT_KEYS}: {spent:.3f} s so far, about "
            f"{TCP_RESERVE_S + TCP_FULL_9A_EXTRA_S:.0f} s to go at {keys} and {TREE_RESERVE_S:.0f} s kept for "
            f"phase 11, past the {RUN_GUARD_S:.0f} s guard")
        keys = TCP_CUT_KEYS
    out = {"9a": tcp_leg("tcpb", None, keys, device_name, device, cut_note=note)}
    out["9a"]["leg_s"] = time.perf_counter() - t0
    if any(out["9a"]["launches"].values()):
        raise AssertionError(f"9a: a kernel was launched on the binned TCP path: {out['9a']['launches']}")
    out["9b"] = tcp_leg("tcph", "hash", hash_keys, device_name, device, subscribers=True,
                        down_keys=hash_keys // 16)
    if device == "cuda" and out["9b"]["launches"][probe_lookup_kernel.name] <= 0:
        raise AssertionError("9b: the probe kernel was not launched on the hash-store TCP path")
    if out["9b"]["launches"][batched_roots_kernel.name]:
        raise AssertionError("9b: the roots kernel was launched on the hash-store TCP path")
    out["9c"] = tcp_fleets(fleet_n, device_name, device)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[tcp] phase 9 {out['phase_s']:.3f} s (9a {out['9a']['leg_s']:.3f} s at {keys} keys); probe launches "
        f"on the hash leg "
        f"{out['9b']['launches'][probe_lookup_kernel.name]} by HxWxQ {out['9b']['probe_by_shape']}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the serving front door and the observability plane

#: ``bench.py --serve``'s shape (``bench.py:2931-3345``): leg A's
#: clients and ops a client, the admission window, the open-loop
#: workers, rates (fractions of the calibrated closed-loop capacity),
#: seconds a rate, the read mix's hot pool
SERVE_CLIENTS = 64
#: (the bench's 150 ops a client, cut: leg A's per-op loop alone took
#: about 65 s of 10a's 114 s at 150 on an H100 at 700 W)
SERVE_PER_CLIENT = 50
SERVE_COMMIT_OPS = 256
SERVE_WORKERS = 16
SERVE_RATE_FRACS = (0.3, 0.7)
SERVE_LEG_S = 2.5
SERVE_CAL_S = 1.0
SERVE_HOT = 64
#: leg C's flood (bench's: half the clients), the obs-overhead batches,
#: 10c's fleet and its preload
SERVE_PARITY_CLIENTS = 32
OBS_BATCHES = 8
SERVE_FLEET_N = 4
SERVE_FLEET_KEYS = 1 << 14
#: the sync interval the serving legs run at (``bench.py --serve``'s
#: leg D, 0.25 s; the reference's default is 0.2 s). Phases 3 and 3b
#: sync every 20 ms: with 2^20 keys each digest walk under continuous
#: writes ships whole 256-entry rows and holds replica 1's lock for
#: much of every interval, and the front door then waits on that lock
#: (``PERF.md`` §6)
SERVE_SYNC_INTERVAL = 0.25


def pct_ms(lat: list) -> dict:
    """p50/p99/max in ms of latencies in seconds (nearest rank)."""
    if not lat:
        raise AssertionError("no latency samples")
    a = np.sort(np.asarray(lat, dtype=np.float64)) * 1e3
    rank = lambda q: a[min(len(a) - 1, int(np.ceil(q * len(a))) - 1)]
    return {"n": len(a), "p50_ms": float(rank(0.5)), "p99_ms": float(rank(0.99)), "max_ms": float(a[-1])}


def run_threads(fns: list, timeout: float) -> float:
    """Run each callable on its own thread, join them all, re-raise the
    first error; returns the wall seconds."""
    errors: list = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        if t.is_alive():
            raise AssertionError(f"a client thread did not finish within {timeout} s")
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def tickets_of(t) -> list:
    return t if isinstance(t, list) else [t]


def open_loop(door, read_pool, want: dict, written: dict, tag: str, fracs, rng, device_name: str) -> dict:
    """``bench.py --serve``'s open-loop mix on a front door (a replica's
    or a fleet's): a closed-loop calibration of the same 70/30 mix, then
    one unmeasured soak at the top rate and one measured run at each
    rate, Poisson arrivals, each op's latency timed from its SCHEDULED
    arrival (so queueing delay counts). Reads are single-key
    ``read_keys`` of a key drawn from ``read_pool`` (half the time the
    64-key hot pool, the rest uniform over the loaded keys) and must
    equal ``want``; writes are ``mutate_async`` of fresh keys, recorded
    in ``written`` once acknowledged."""
    hot = [f"hot{j}" for j in range(SERVE_HOT)]
    for tk in [t for j, k in enumerate(hot) for t in tickets_of(door.mutate_async("add", [k, j]))]:
        tk.result(120)
    written.update({k: j for j, k in enumerate(hot)})
    want.update({k: j for j, k in enumerate(hot)})
    lock = threading.Lock()
    checked = [0]

    def pick(r: np.random.Generator):
        return hot[int(r.integers(0, SERVE_HOT))] if r.random() < 0.5 else read_pool[int(r.integers(0, len(read_pool)))]

    def check_read(k, got) -> None:
        exp = {k: want[k]} if k in want else {}
        if got != exp:
            raise AssertionError(f"{tag}: read_keys([{k!r}]) gave {got}, the written map holds {exp}")
        with lock:
            checked[0] += 1

    cal_end = time.perf_counter() + SERVE_CAL_S
    cal_counts = [0] * SERVE_WORKERS
    cal_written: list = []

    def calibrate(w):
        r = np.random.default_rng(1000 + w)
        i = 0
        while time.perf_counter() < cal_end:
            if i % 10 < 7:
                k = pick(r)
                check_read(k, door.read_keys([k]))
            else:
                k = f"{tag}-cal/{w}/{i}"
                for tk in tickets_of(door.mutate_async("add", [k, i])):
                    tk.result(120)
                with lock:
                    cal_written.append((k, i))
            cal_counts[w] += 1
            i += 1

    cal_s = run_threads([lambda w=w: calibrate(w) for w in range(SERVE_WORKERS)], 600)
    written.update(cal_written)
    capacity = sum(cal_counts) / cal_s
    log(f"[serve] {tag}: calibrated closed-loop capacity {capacity:.3f} mixed ops/s ({SERVE_WORKERS} workers, "
        f"70% reads) on {device_name}")
    rates = [max(50, int(capacity * f)) for f in fracs]
    out = {"capacity_ops_per_sec": capacity, "rates": {}}
    for frac, rate, measured in [(fracs[-1], rates[-1], False)] + [(f, r, True) for f, r in zip(fracs, rates)]:
        n = int(rate * SERVE_LEG_S)
        offs = np.cumsum(rng.exponential(1.0 / rate, size=n))
        kinds = rng.random(n) < 0.7
        sched = [(float(offs[i]), pick(rng) if kinds[i] else None) for i in range(n)]
        nxt = iter(range(n))
        lat_read: list = []
        pending: list = []
        t0 = time.perf_counter() + 0.05

        def arrive():
            while True:
                with lock:
                    i = next(nxt, None)
                if i is None:
                    return
                t_arr, key = sched[i]
                now = time.perf_counter()
                if now < t0 + t_arr:
                    time.sleep(t0 + t_arr - now)
                if key is not None:
                    got = door.read_keys([key])
                    dt = time.perf_counter() - (t0 + t_arr)
                    check_read(key, got)
                    with lock:
                        lat_read.append(dt)
                else:
                    k = f"{tag}-ol{rate}/{i}"
                    tks = tickets_of(door.mutate_async("add", [k, i]))
                    with lock:
                        pending.append((k, i, tks, t0 + t_arr))

        run_threads([arrive] * SERVE_WORKERS, SERVE_LEG_S * 40 + 120)
        lat_write = []
        for k, i, tks, t_arr in pending:
            for tk in tks:
                tk.result(120)
            lat_write.append(max(tk.t_done for tk in tks) - t_arr)
            written[k] = i
        achieved = n / (time.perf_counter() - t0)
        if not measured:
            log(f"[serve] {tag}: unmeasured soak at {rate}/s done")
            continue
        entry = {"capacity_fraction": frac, "target_ops_per_sec": rate, "achieved_ops_per_sec": achieved,
                 "read": pct_ms(lat_read), "write": pct_ms(lat_write)}
        out["rates"][str(frac)] = entry
        log(f"[serve] {tag} open loop at {rate}/s ({int(frac * 100)}% of capacity): achieved {achieved:.3f}/s; read "
            f"p50 {entry['read']['p50_ms']:.3f} p99 {entry['read']['p99_ms']:.3f} ms (n {entry['read']['n']}); write "
            f"p50 {entry['write']['p50_ms']:.3f} p99 {entry['write']['p99_ms']:.3f} ms (n {entry['write']['n']}) "
            f"on {device_name}")
    want.update(written)
    out["reads_checked"] = checked[0]
    return out


def wait_equal_canonical(reps, deadline: float, what: str) -> bytes:
    while True:
        cs = [r.canonical_state_bytes() for r in reps]
        if all(c == cs[0] for c in cs):
            return cs[0]
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: replicas did not converge to equal canonical bytes")
        time.sleep(0.1)


def check_written(door_reads, reps_reads, written: dict, tag: str) -> None:
    """Every acknowledged write reads back: ``written`` through the front
    door's snapshot reads and each replica's locked ``read_keys``, in
    4096-key chunks."""
    keys = list(written)
    for s in range(0, len(keys), 4096):
        chunk = keys[s : s + 4096]
        exp = {k: written[k] for k in chunk}
        for name, fn in [("front door", door_reads)] + reps_reads:
            got = fn(chunk)
            if got != exp:
                bad = [k for k in chunk if got.get(k, "<absent>") != exp[k]][:4]
                raise AssertionError(f"{tag}: {name} reads {[(k, got.get(k)) for k in bad]}, written {[(k, exp[k]) for k in bad]}")


def trace_serving(fd, read_keys: list, logdir: Path, device_name: str) -> dict:
    """One admission commit (``SERVE_COMMIT_OPS`` queued writes) and one
    ``read_keys`` of ``read_keys`` under the port's ``tracing.trace``:
    wall time, device busy time and idle share, the top torch ops by
    device time and the replica spans the trace holds."""
    import torch
    from torch.autograd import DeviceType

    from delta_crdt_ex_tpu_torch.runtime import tracing

    torch.cuda.synchronize()
    with tracing.trace(str(logdir), cuda=True) as prof:
        t0 = time.perf_counter()
        tks = [fd.mutate_async("add", [f"serve-traced{i}", i]) for i in range(SERVE_COMMIT_OPS)]
        for tk in tks:
            tk.result(120)
        got = fd.read_keys(read_keys)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the serving trace recorded no device time")
    ops = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    names = {e.key for e in prof.key_averages()}
    spans = sorted(n for n in names if n.startswith("crdt."))
    if "crdt.flush" not in spans:
        raise AssertionError(f"the serving trace holds no crdt.flush span: {spans}")
    trace_file = logdir / "trace.json"
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms, "ops": ops[:8],
           "spans": spans, "trace_bytes": trace_file.stat().st_size, "read_found": len(got)}
    log(f"[serve-trace] one {SERVE_COMMIT_OPS}-op admission commit + one {len(read_keys)}-key read_keys: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share {out['idle_share']:.4f}); spans {spans}; "
        f"device ms by op {[(k, round(v, 3)) for k, v in ops[:8]]}; Chrome trace {out['trace_bytes']} B on {device_name}")
    return out


def admission_parity(capacity: int, device_name: str, device: str) -> dict:
    """Leg C: a fresh replica at 10a's geometry (``LogicalClock``, a fixed
    node id, a WAL) takes a concurrent flood through its front door with
    the journal on; an unloaded twin replays the journal through
    ``apply_ops``. Seqs, canonical bytes, WAL bytes and every state
    column must be bit-equal."""
    import dataclasses
    import shutil

    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    root = WAL_ROOT / "serve"
    shutil.rmtree(root, ignore_errors=True)
    t = LocalTransport()
    mk = lambda tag: dc.start_link(dc.AWLWWMap, threaded=False, transport=t, name=f"serve-par-{tag}", node_id=4242,
                                   clock=LogicalClock(), capacity=capacity, wal_dir=str(root / tag), fsync_mode="none",
                                   device=device)
    a, b = mk("a"), mk("b")
    try:
        fd = a.frontdoor(max_commit_ops=SERVE_COMMIT_OPS, max_pending_ops=1 << 30, journal=True)
        rng = np.random.default_rng(23)
        pools = [rng.integers(1, 1 << 62, size=SERVE_PER_CLIENT, dtype=np.uint64).tolist()
                 for _ in range(SERVE_PARITY_CLIENTS)]
        t0 = time.perf_counter()
        run_threads([lambda p=p: [fd.mutate("add", [int(k), int(k)], timeout=120) for k in p] for p in pools], 600)
        flood_s = time.perf_counter() - t0
        fd.close()
        journal = fd.journal()
        t0 = time.perf_counter()
        for group in journal:
            b.apply_ops(group)
        replay_s = time.perf_counter() - t0
        if a._seq != b._seq or a._seq != len(journal):
            raise AssertionError(f"leg C: seqs {a._seq} / {b._seq} for {len(journal)} groups")
        with a._lock, b._lock:
            for f in dataclasses.fields(a.state):
                va, vb = getattr(a.state, f.name), getattr(b.state, f.name)
                if not (torch.equal(va, vb) if isinstance(va, torch.Tensor) else va == vb):
                    raise AssertionError(f"leg C: loaded and twin state column {f.name} differ")
        ca, cb = a.canonical_state_bytes(), b.canonical_state_bytes()
        segs = lambda r: b"".join(p.read_bytes() for p in sorted(Path(r._wal.directory).iterdir()))
        wa, wb = segs(a), segs(b)
        if ca != cb or wa != wb:
            raise AssertionError(f"leg C: canonical bytes equal {ca == cb}, WAL bytes equal {wa == wb}")
        ops = sum(len(g) for g in journal)
        if ops != SERVE_PARITY_CLIENTS * SERVE_PER_CLIENT:
            raise AssertionError(f"leg C: the journal holds {ops} ops")
        out = {"groups": len(journal), "ops": ops, "wal_bytes": len(wa), "canonical_bytes": len(ca),
               "flood_s": flood_s, "replay_s": replay_s}
        log(f"[serve] 10a leg C: {ops} ops from {SERVE_PARITY_CLIENTS} clients committed in {len(journal)} groups "
            f"({flood_s:.3f} s); the twin's replay ({replay_s:.3f} s) is bit-equal: state columns, canonical bytes "
            f"({len(ca)} B), WAL bytes ({len(wa)} B) on {device_name}")
        return out
    finally:
        a.stop()
        b.stop()
        shutil.rmtree(root, ignore_errors=True)


def obs_overhead_and_shed(capacity: int, device_name: str, device: str) -> dict:
    """The ``obs=True`` overhead (the same 1024-op batches on a replica
    with a plane and one without, in turns; the plane's bridge is
    detached while the plane-less one runs, so it pays exactly what
    ``obs=None`` pays) and leg E: a write spike sheds explicitly and
    ``/healthz`` answers 503 over HTTP, then 200 once it drains."""
    import urllib.error
    import urllib.request

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.serve import Overloaded
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    plane = dc.Observability()
    t = LocalTransport()
    on = dc.start_link(dc.AWLWWMap, threaded=False, transport=t, name="serve-obs-on", obs=plane,
                       capacity=capacity, device=device)
    off = dc.start_link(dc.AWLWWMap, threaded=False, transport=t, name="serve-obs-off", capacity=capacity,
                        device=device)
    out: dict = {}
    try:
        dt = {"on": [], "off": []}
        for i in range(OBS_BATCHES + 1):
            for side, rep in (("on", on), ("off", off)) if i % 2 else (("off", off), ("on", on)):
                (plane.bridge.attach if side == "on" else plane.bridge.detach)()
                items = [[f"obs{i}/{j}", j] for j in range(1024)]
                t0 = time.perf_counter()
                rep.mutate_batch("add", items, timeout=120)
                if i:  # the first round warms both
                    dt[side].append(time.perf_counter() - t0)
        plane.bridge.attach()
        med = {k: float(np.median(v)) for k, v in dt.items()}
        out["obs_overhead"] = {"on_ms": [x * 1e3 for x in dt["on"]], "off_ms": [x * 1e3 for x in dt["off"]],
                               "median_on_ms": med["on"] * 1e3, "median_off_ms": med["off"] * 1e3,
                               "ratio": med["on"] / med["off"]}
        last = [f"obs{OBS_BATCHES}/{j}" for j in range(0, 1024, 97)]
        if on.read_keys(last) != off.read_keys(last) or len(off.read_keys(last)) != len(last):
            raise AssertionError("obs overhead: a batch did not land")
        log(f"[serve] obs=True overhead: {OBS_BATCHES} 1024-op batches in turns, median {med['on'] * 1e3:.3f} ms "
            f"with the plane against {med['off'] * 1e3:.3f} ms without (ratio {med['on'] / med['off']:.4f}) on "
            f"{device_name}")

        fd = on.frontdoor(max_pending_ops=32, max_commit_ops=32, shed_health_hold=2.0)
        for i in range(16):
            fd.mutate("add", [f"warm{i}", i], timeout=120)
        server = plane.serve(port=0)

        def healthz() -> int:
            try:
                with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        if healthz() != 200:
            raise AssertionError("leg E: /healthz is not 200 before the spike")
        shed = [0]
        acked: list = []
        lock = threading.Lock()

        def spike(i):
            for j in range(400):
                try:
                    tk = fd.mutate_async("add", [f"spike{i}/{j}", j])
                except Overloaded:
                    with lock:
                        shed[0] += 1
                    continue
                with lock:
                    acked.append((f"spike{i}/{j}", j, tk))

        run_threads([lambda i=i: spike(i) for i in range(4)], 300)
        code_during = healthz()
        t_spike = time.perf_counter()
        if shed[0] == 0 or code_during != 503:
            raise AssertionError(f"leg E: {shed[0]} ops shed, /healthz {code_during} under the spike")
        code_after = 0
        while time.perf_counter() - t_spike < 60:
            code_after = healthz()
            if code_after == 200:
                break
            time.sleep(0.05)
        if code_after != 200:
            raise AssertionError("leg E: /healthz never recovered after the spike")
        recover_s = time.perf_counter() - t_spike
        for _k, _j, tk in acked:
            tk.result(120)
        want = {k: j for k, j, _tk in acked}
        if fd.read_keys(list(want)) != want or on.read_keys([f"spike0/{j}" for j in range(400)]).keys() - want.keys():
            raise AssertionError("leg E: an acknowledged spike write does not read back, or a shed one does")
        st = fd.stats()
        out["overload"] = {"spike_ops": 1600, "shed_ops": shed[0], "acked_ops": len(acked),
                           "shed_by_reason": st["shed_by_reason"], "healthz_under_overload": code_during,
                           "healthz_recovered": code_after, "recover_s": recover_s}
        log(f"[serve] 10a leg E: a 4 x 400 spike against a 32-op window shed {shed[0]} ops ({st['shed_by_reason']}), "
            f"acked {len(acked)} all read back; /healthz 200 -> {code_during} -> {code_after} after "
            f"{recover_s:.3f} s on {device_name}")
        return out
    finally:
        on.stop()
        off.stop()
        plane.close()


def serve_binned(reps, transport, want: dict, n_keys: int, device_name: str, device: str = "cuda") -> dict:
    """Phase 10a on phase 3b's loaded pair (the default store at 2^20
    keys): leg A (grouped admission against the per-op ``mutate`` loop,
    64 clients x 150 ops), leg B (snapshot reads while the replica lock
    is held), the open-loop mix at 30% and 70% of capacity, the
    ``obs=True`` overhead and leg E on fresh replicas of the same
    geometry, leg C on a fresh pair, one profiler trace; then every
    acknowledged write reads back from both replicas and the pair
    converges to equal canonical bytes."""
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    r1, r2 = reps
    t_leg = time.perf_counter()
    for r in reps:
        r.sync_interval = SERVE_SYNC_INTERVAL
    capacity = 2 * n_keys
    probe_lookup_kernel.reset()  # 10a's run starts here: this path launches neither kernel
    batched_roots_kernel.reset()
    fd = r1.frontdoor(max_commit_ops=SERVE_COMMIT_OPS, max_pending_ops=1 << 30)
    written: dict = {}
    out: dict = {"keys": n_keys}
    rng = np.random.default_rng(7)

    # leg A: grouped admission against the per-op mutate loop
    pools = [rng.integers(1, 1 << 62, size=SERVE_PER_CLIENT, dtype=np.uint64).tolist() for _ in range(2 * SERVE_CLIENTS)]
    warm = [rng.integers(1, 1 << 62, size=8, dtype=np.uint64).tolist() for _ in range(SERVE_CLIENTS)]
    flood = lambda target, ps: run_threads([lambda p=p: [target(int(k)) for k in p] for p in ps], 900)
    flood(lambda k: r1.mutate("add", [k, k], timeout=300), warm)
    flood(lambda k: fd.mutate("add", [k, k], timeout=300), warm)
    dt_po = flood(lambda k: r1.mutate("add", [k, k], timeout=300), pools[:SERVE_CLIENTS])
    dt_gr = flood(lambda k: fd.mutate("add", [k, k], timeout=300), pools[SERVE_CLIENTS:])
    for p in warm + pools:
        written.update({int(k): int(k) for k in p})
    n_ops = SERVE_CLIENTS * SERVE_PER_CLIENT
    st = fd.stats()
    out["admission"] = {"clients": SERVE_CLIENTS, "ops": n_ops, "per_op_ops_per_sec": n_ops / dt_po,
                        "grouped_ops_per_sec": n_ops / dt_gr, "ratio": dt_po / dt_gr,
                        "ops_per_commit": st["ops_per_commit"], "commits": st["commits"]}
    log(f"[serve] 10a leg A: {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} ops on the {n_keys}-key map: grouped admission "
        f"{n_ops / dt_gr:.3f} ops/s ({st['ops_per_commit']} ops a commit) against the per-op mutate loop "
        f"{n_ops / dt_po:.3f} ops/s, ratio {dt_po / dt_gr:.3f} on {device_name}")

    # leg B: snapshot reads while the replica lock is held
    probe = [int(pools[0][0]), int(pools[SERVE_CLIENTS][0])]
    fd.read_keys(probe)
    got: list = []
    with r1._lock:
        th = threading.Thread(target=lambda: [got.append(fd.read_keys(probe)) for _ in range(20)])
        th.start()
        th.join(timeout=60)
        if th.is_alive() or len(got) != 20 or any(g != {k: k for k in probe} for g in got):
            raise AssertionError("leg B: snapshot reads blocked on the held replica lock or read wrong")
    out["lock_free_reads"] = 20
    log(f"[serve] 10a leg B: 20 snapshot read_keys finished while replica 1's lock was held on {device_name}")

    # the open-loop mix; reads over the loaded keys and the hot pool
    read_pool = [f"key{i}" for i in range(n_keys)]
    want.update(written)
    out["open_loop"] = open_loop(fd, read_pool, want, written, "10a", SERVE_RATE_FRACS, rng, device_name)

    if device == "cuda":
        out["trace"] = trace_serving(fd, [f"key{i}" for i in range(0, n_keys, max(1, n_keys // 2048))][:2048],
                                     TRACE_ROOT / "serve_binned", device_name)
        written.update({f"serve-traced{i}": i for i in range(SERVE_COMMIT_OPS)})
    want.update(written)
    out["parity"] = admission_parity(capacity, device_name, device)
    out.update(obs_overhead_and_shed(capacity, device_name, device))

    # every acknowledged write reads back from both replicas, and the
    # pair converges
    deadline = time.perf_counter() + SLICE_BUDGET_S
    c = wait_equal_canonical([r1, r2], deadline, "10a")
    check_written(fd.read_keys, [("replica 1", r1.read_keys), ("replica 2", r2.read_keys)], written, "10a")
    sample = read_pool[::997]
    exp = {k: want[k] for k in sample if k in want}
    if fd.read_keys(sample) != exp or r2.read_keys(sample) != exp:
        raise AssertionError("10a: the loaded keys no longer read as written")
    out["written"] = len(written)
    out["canonical_bytes"] = len(c)
    out["frontdoor"] = {k: v for k, v in fd.stats().items() if k != "commit_depth_hist"}
    out["launches"] = {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                       batched_roots_kernel.name: batched_roots_kernel.launches}
    if any(out["launches"].values()):
        raise AssertionError(f"10a: a kernel was launched on the binned serving path: {out['launches']}")
    out["leg_s"] = time.perf_counter() - t_leg
    log(f"[serve] 10a: {len(written)} acknowledged writes read back from both replicas; canonical bytes equal "
        f"({len(c)} B); {out['frontdoor']['reads']} snapshot reads, {out['frontdoor']['read_retries']} retries, "
        f"{out['frontdoor']['strong_read_fallbacks']} strong fallbacks; kernel launches {out['launches']}; "
        f"{out['leg_s']:.3f} s on {device_name}")
    return out


def serve_hash(reps, logs, want: dict, n_keys: int, device_name: str, device: str = "cuda") -> dict:
    """Phase 10b on phase 3's pair (the hash store at 2^17 keys, an
    ``on_diffs`` feed on each replica): the open-loop mix at 30% of
    capacity through replica 1's front door — its snapshot reads launch
    the probe kernel from the client threads, its admission commits from
    the admission worker — then every shape launched held bit-equal to
    the plain version on the pinned snapshot's own table, and every
    acknowledged write read back from both replicas and on replica 2's
    feed."""
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    r1, r2 = reps
    t_leg = time.perf_counter()
    for r in reps:
        r.sync_interval = SERVE_SYNC_INTERVAL
    probe_lookup_kernel.reset()  # 10b's run starts here
    batched_roots_kernel.reset()
    fd = r1.frontdoor(max_commit_ops=SERVE_COMMIT_OPS, max_pending_ops=1 << 30)
    written: dict = {}
    rng = np.random.default_rng(13)
    out = {"keys": n_keys}
    out["open_loop"] = open_loop(fd, [f"key{i}" for i in range(n_keys)], want, written, "10b",
                                 SERVE_RATE_FRACS[:1], rng, device_name)
    out["launches"] = probe_lookup_kernel.launches
    out["launches_by_shape"] = probe_shape_launches()
    roots = batched_roots_kernel.launches
    if (device == "cuda" and out["launches"] <= 0) or roots:
        raise AssertionError(f"10b: probe launches {out['launches']}, roots launches {roots}")
    # launches below compare the kernel with its plain version on the
    # pinned snapshot's own table, at every Q the leg launched at; they
    # are not the path's
    st = fd.snapshot().store
    shapes = [tuple(int(x) for x in k.split("x")) for k in out["launches_by_shape"]]
    if any((H, W) != (st.table_size, st.probe_window) for H, W, _q in shapes):
        raise AssertionError(f"10b: launches {out['launches_by_shape']} are not all on the pinned table "
                             f"({st.table_size}, {st.probe_window})")
    out["table_max_abs_err"] = check_main_tables(
        [("10b's pinned snapshot", st)], n_keys, [f"key{i}" for i in range(0, n_keys, 100)],
        extra=[f"prop{i}" for i in range(10)] + list(written), q_sizes=sorted({q for _h, _w, q in shapes}))
    deadline = time.perf_counter() + SLICE_BUDGET_S
    logs[1].wait(lambda d: all(d.view.get(k) == v for k, v in written.items()), deadline, "10b writes on replica 2's feed")
    c = wait_equal_canonical([r1, r2], deadline, "10b")
    check_written(fd.read_keys, [("replica 1", r1.read_keys), ("replica 2", r2.read_keys)], written, "10b")
    out["written"] = len(written)
    out["canonical_bytes"] = len(c)
    out["leg_s"] = time.perf_counter() - t_leg
    log(f"[serve] 10b: {len(written)} acknowledged writes read back from both replicas and on replica 2's feed; "
        f"canonical bytes equal ({len(c)} B); probe launches {out['launches']} by HxWxQ {out['launches_by_shape']}; "
        f"{out['leg_s']:.3f} s on {device_name}")
    return out


def serve_fleet(device_name: str, device: str = "cuda") -> dict:
    """Phase 10c: a threaded 4-member fleet (ring neighbours) behind its
    front door: ``SERVE_FLEET_KEYS`` keys routed in, the open-loop mix at
    30% of capacity, then every member's full read equals the written
    map."""
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    t_leg = time.perf_counter()
    probe_lookup_kernel.reset()  # 10c's run starts here: this path launches neither kernel
    batched_roots_kernel.reset()
    fleet = dc.start_fleet(SERVE_FLEET_N, transport=LocalTransport(), names=[f"serve-f{i}" for i in range(SERVE_FLEET_N)],
                           capacity=4 * SERVE_FLEET_KEYS, sync_interval=SERVE_SYNC_INTERVAL, max_sync_size=1024,
                           sync_timeout=600.0,
                           device=device)
    out: dict = {"members": SERVE_FLEET_N, "keys": SERVE_FLEET_KEYS}
    try:
        for i, rep in enumerate(fleet.replicas):
            rep.set_neighbours([fleet.replicas[(i + 1) % SERVE_FLEET_N]])
        ffd = dc.frontdoor(fleet, max_commit_ops=SERVE_COMMIT_OPS, max_pending_ops=1 << 30)
        t0 = time.perf_counter()
        tks = [tk for i in range(SERVE_FLEET_KEYS) for tk in ffd.mutate_async("add", [f"key{i}", i])]
        for tk in tks:
            tk.result(300)
        out["preload_s"] = time.perf_counter() - t0
        want = {f"key{i}": i for i in range(SERVE_FLEET_KEYS)}
        written = dict(want)
        rng = np.random.default_rng(17)
        out["open_loop"] = open_loop(ffd, list(want), want, written, "10c", SERVE_RATE_FRACS[:1], rng, device_name)
        deadline = time.perf_counter() + SLICE_BUDGET_S
        t0 = time.perf_counter()
        while True:
            views = [ffd.read(m) for m in range(SERVE_FLEET_N)]
            if all(v == want for v in views):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"10c: members hold {[len(v) for v in views]} keys, the written map {len(want)}")
            time.sleep(0.2)
        out["converge_s"] = time.perf_counter() - t0
        check_written(ffd.read_keys, [(f"member {m}", fleet.replicas[m].read_keys) for m in range(SERVE_FLEET_N)],
                      written, "10c")
        out["fleet"] = {k: fleet.stats()[k] for k in ("dispatches", "avg_occupancy", "fallbacks")}
        out["written"] = len(written)
        out["launches"] = {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                           batched_roots_kernel.name: batched_roots_kernel.launches}
        if any(out["launches"].values()):
            raise AssertionError(f"10c: a kernel was launched on the binned fleet serving path: {out['launches']}")
    finally:
        fleet.stop()
    out["leg_s"] = time.perf_counter() - t_leg
    log(f"[serve] 10c: {SERVE_FLEET_N}-member fleet, {SERVE_FLEET_KEYS} keys routed in ({out['preload_s']:.3f} s); "
        f"every member reads the written map ({len(want)} keys) {out['converge_s']:.3f} s after the mix; fleet "
        f"{out['fleet']}; {out['leg_s']:.3f} s on {device_name}")
    return out


# ---------------------------------------------------------------------------
# phase 11: tree gossip

#: 11a's shape, ``bench.py --tree``'s (``bench.py:1154-1410``): peers a
#: universe, the flat baseline's neighbours, the tree's fanout, probes,
#: the rounds a probe may take, the digest-tree depth
TREE_PEERS = 256
TREE_FLAT_NEIGHBOURS = 64
TREE_FANOUT = 8
TREE_PROBES = 3
#: seconds one probe adds to 11a, nearly all of them the flat universe's
#: two global rounds (11a took 304.974 s with 3 probes and 216.023 s
#: with 2 in two whole runs on an H100 at 700 W)
TREE_PROBE_S = 90.0
TREE_MAX_ROUNDS = 12
TREE_DEPTH = 6
#: 11b: hash-store replicas, their fanout, the keys loaded: an eighth
#: of phase 3's 2^17, cut so that the phase fits the run's time (at 2^16
#: keys 11b took 145.240 s on an H100 at 700 W, at 2^14 101.800 s:
#: sixteen replica threads share one interpreter, and a single-op write
#: takes about 3 s to reach the last replica at either size; 16
#: replicas until a whole run passed 1200 s, 8 keep the depth-2 tree
#: with root, relays and leaves)
TREE_HASH_N = 8
TREE_HASH_FANOUT = 4
TREE_HASH_KEYS = 1 << 14
#: 11b's single-op writes timed to the last replica (10 until a whole run
#: passed 1200 s: each takes about 3-8 s on an H100 at 700 W)
TREE_HASH_PROPS = 5
#: 11c: members of each TCP fleet (phase 9c's)
TREE_TCP_FLEET_N = 64
#: seconds phase 11 needs after phase 9 with 3 probes (what the guards
#: of phases 7, 8 and 9 keep free for it, and 11a's own probe cut reads):
#: on an H100 at 700 W it took 404.777 s in a whole run (11a 304.974 s,
#: 11b 91.898 s at 2^14 keys on 16 replicas, 11c 7.075 s)
TREE_RESERVE_S = 410.0


def counting_transport():
    """A port ``LocalTransport`` that costs every delivered message at
    its pickled size, what a socket transport would ship (``bench.py
    --tree``'s ``CountingTransport``)."""
    import pickle

    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    class CountingTransport(LocalTransport):
        def __init__(self) -> None:
            super().__init__()
            self.bytes = 0
            self.msgs = 0

        def send(self, addr, msg):
            ok = super().send(addr, msg)
            if ok:
                self.bytes += len(pickle.dumps(msg, protocol=4))
                self.msgs += 1
            return ok

    return CountingTransport()


def tree_universe(tag: str, tree: bool, peers: int, flat_neighbours: int, fanout: int, device: str, obs=None):
    """One universe of ``bench.py --tree``: ``peers`` unthreaded replicas
    on a counting transport under a ``LogicalClock``; tree mode with the
    full membership as neighbours, or the flat baseline's neighbours
    picked with ``np.random.default_rng(7)`` as the bench picks them."""
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock

    transport, clock = counting_transport(), LogicalClock()
    reps = [
        dc.start_link(dc.AWLWWMap, threaded=False, transport=transport, clock=clock, name=f"{tag}{i}",
                      node_id=i + 1, capacity=512, obs=obs, replica_capacity=2 * peers, tree_depth=TREE_DEPTH,
                      sync_timeout=600.0, tree_gossip=tree, tree_fanout=fanout, device=device)
        for i in range(peers)
    ]
    addrs = [r.addr for r in reps]
    if tree:
        for r in reps:
            r.set_neighbours(addrs)
    else:
        rng = np.random.default_rng(7)
        for i, r in enumerate(reps):
            others = [a for j, a in enumerate(addrs) if j != i]
            picks = rng.choice(len(others), flat_neighbours, replace=False)
            r.set_neighbours([others[j] for j in sorted(picks)])
    return transport, reps


def global_round(reps) -> None:
    """Every replica's ``sync_to_all()``, then ``process_pending()``
    until quiescent."""
    for r in reps:
        r.sync_to_all()
    for _ in range(2000):
        if not sum(r.process_pending() for r in reps):
            return
    raise AssertionError("universe did not quiesce")


def run_tree_probes(tag: str, transport, reps, writer_idx: int, probes: int, sync) -> dict:
    """``bench.py``'s probes: 2 settle rounds, then ``probes`` fresh keys
    from the writer, global rounds until every replica reads the key (at
    most ``TREE_MAX_ROUNDS``); rounds, messages and bytes a probe, and
    the wall seconds of every global round."""
    import statistics

    peers = len(reps)
    t0 = time.perf_counter()
    for _ in range(2):
        global_round(reps)
    sync()
    settle_s = time.perf_counter() - t0
    cover_rounds: list = []
    per_peer: dict = {}
    full_rounds, probe_bytes, probe_msgs, round_s = [], [], [], []
    for p in range(probes):
        key = f"probe-{p}"
        reps[writer_idx].mutate("add", [key, p])
        covered = {writer_idx}
        b0, m0 = transport.bytes, transport.msgs
        rnd = 0
        while len(covered) < peers and rnd < TREE_MAX_ROUNDS:
            rnd += 1
            t1 = time.perf_counter()
            global_round(reps)
            sync()
            round_s.append(time.perf_counter() - t1)
            for i, r in enumerate(reps):
                if i not in covered and r.read_keys([key]):
                    covered.add(i)
                    cover_rounds.append(rnd)
                    per_peer.setdefault(str(r.addr), []).append(rnd)
        if len(covered) != peers:
            raise AssertionError(f"11a {tag}: probe {p} reached {len(covered)}/{peers} after {TREE_MAX_ROUNDS} rounds")
        full_rounds.append(rnd)
        probe_bytes.append(transport.bytes - b0)
        probe_msgs.append(transport.msgs - m0)
    return {
        "median_propagation_rounds": statistics.median(cover_rounds),
        "full_coverage_rounds": full_rounds,
        "bytes_per_probe": probe_bytes,
        "msgs_per_probe": probe_msgs,
        "bytes_total": sum(probe_bytes),
        "msgs_total": sum(probe_msgs),
        "round_s": round_s,
        "settle_s": settle_s,
        "cover_rounds_by_peer": per_peer,
    }


def tree_vs_flat(device_name: str, device: str = "cuda", peers: int = TREE_PEERS,
                 flat_neighbours: int = TREE_FLAT_NEIGHBOURS, fanout: int = TREE_FANOUT,
                 probes: int = TREE_PROBES) -> dict:
    """Phase 11a: ``bench.py --tree`` at full size on ``device``, its
    in-run gates, then a tier-1 relay crashed: every survivor derives one
    shared epoch, one more probe reaches every survivor, and the
    survivors end with equal canonical bytes."""
    import gc

    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel
    from delta_crdt_ex_tpu_torch.runtime import treesync
    from delta_crdt_ex_tpu_torch.runtime.metrics import Observability

    gc.collect()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t_leg = time.perf_counter()
    probe_lookup_kernel.reset()  # 11a's run starts here: the binned store launches neither kernel
    batched_roots_kernel.reset()
    plane = Observability(lag_sample_every=1)
    out: dict = {"peers": peers, "flat_neighbours": flat_neighbours, "fanout": fanout, "probes": probes}
    flat_reps, tree_reps = [], []
    try:
        t0 = time.perf_counter()
        flat_t, flat_reps = tree_universe("f", False, peers, flat_neighbours, fanout, device)
        tree_t, tree_reps = tree_universe("t", True, peers, flat_neighbours, fanout, device, obs=plane)
        out["build_s"] = time.perf_counter() - t0
        topo = tree_reps[0]._tree_refresh()
        writer_idx = max(range(peers), key=lambda i: topo.tier.get(tree_reps[i].addr, 0))
        tiers: dict = {}
        for a in topo.members:
            tiers[topo.tier[a]] = tiers.get(topo.tier[a], 0) + 1
        out["tree"] = {"depth": topo.depth, "root": str(topo.root), "tiers": dict(sorted(tiers.items())),
                       "writer": str(tree_reps[writer_idx].addr), "writer_tier": topo.tier[tree_reps[writer_idx].addr],
                       "epochs": len({r._tree_refresh().epoch for r in tree_reps})}
        if out["tree"]["epochs"] != 1:
            raise AssertionError(f"11a: the tree universe derived {out['tree']['epochs']} epochs")
        flat = run_tree_probes("flat", flat_t, flat_reps, writer_idx, probes, sync)
        tree = run_tree_probes("tree", tree_t, tree_reps, writer_idx, probes, sync)
        # the lag tracer at sample_every=1 must reproduce the hand count
        # for every (writer, peer) pair it observed (bench.py:1309-1360)
        rounds_hist = plane.lag.rounds
        writer_addr = str(tree_reps[writer_idx].addr)
        pairs = [lb for lb in rounds_hist.label_sets() if lb[0] == writer_addr]
        if not pairs:
            raise AssertionError("11a: the lag tracer recorded no writer-origin coverage")
        tracer_n, tracer_sum = 0, 0.0
        for lb in pairs:
            hand = tree["cover_rounds_by_peer"].get(lb[1])
            n, s = rounds_hist.count(lb), rounds_hist.sum(lb)
            if hand is None or n != len(hand) or s != float(sum(hand)):
                raise AssertionError(f"11a: lag tracer for peer {lb[1]}: {n} observations summing {s}, "
                                     f"hand count {hand}")
            tracer_n += n
            tracer_sum += s
        out["lag_tracer"] = {"pairs": len(pairs), "observations": tracer_n, "rounds_sum": tracer_sum}
        for _ in range(3):
            global_round(flat_reps)
            global_round(tree_reps)
        want = tree_reps[0].canonical_state_bytes()
        for i in range(peers):
            ct, cf = tree_reps[i].canonical_state_bytes(), flat_reps[i].canonical_state_bytes()
            if ct != cf or ct != want:
                raise AssertionError(f"11a: tree/flat canonical bytes differ at peer {i}")
        check_on_card(tree_reps + flat_reps, device)
        rounds_ratio = flat["median_propagation_rounds"] / tree["median_propagation_rounds"]
        bytes_ratio = flat["bytes_total"] / tree["bytes_total"]
        if rounds_ratio < 2.0 or bytes_ratio < 1.5:
            raise AssertionError(f"11a: rounds ratio {rounds_ratio:.3f} (want >= 2), bytes ratio "
                                 f"{bytes_ratio:.3f} (want >= 1.5)")
        relay = {"reemits": 0, "msgs_folded": 0, "rows_reemitted": 0, "tx_bytes": 0, "depth_hist": {}}
        for r in tree_reps:
            st = r.stats()["tree"]
            for k in ("reemits", "msgs_folded", "rows_reemitted", "tx_bytes"):
                relay[k] += st[k]
            for d, c in st["depth_hist"].items():
                relay["depth_hist"][d] = relay["depth_hist"].get(d, 0) + c
        relay["depth_hist"] = dict(sorted(relay["depth_hist"].items()))
        for tag, m in (("flat", flat), ("tree", tree)):
            m.pop("cover_rounds_by_peer")
            m["s_per_round_median"] = float(np.median(m["round_s"]))
        out.update({"flat": flat, "tree_probes": tree, "rounds_ratio": rounds_ratio, "bytes_ratio": bytes_ratio,
                    "msgs_ratio": flat["msgs_total"] / tree["msgs_total"], "relay": relay,
                    "canonical_bytes": len(want)})
        log(f"[tree] 11a: {peers} peers, tree fanout {fanout} (depth {topo.depth}, root {topo.root}, tiers "
            f"{out['tree']['tiers']}, writer {writer_addr} at tier {out['tree']['writer_tier']}) vs flat "
            f"{flat_neighbours} neighbours: median propagation rounds tree {tree['median_propagation_rounds']} flat "
            f"{flat['median_propagation_rounds']} ({rounds_ratio:.3f}x); messages a probe tree "
            f"{tree['msgs_per_probe']} flat {flat['msgs_per_probe']}; bytes a probe tree {tree['bytes_per_probe']} "
            f"flat {flat['bytes_per_probe']} ({bytes_ratio:.6f}x); s a global round (median) tree "
            f"{tree['s_per_round_median']:.6f} flat {flat['s_per_round_median']:.6f}; relay {json.dumps(relay)}; "
            f"lag tracer {out['lag_tracer']} = the hand count; every tree/flat pair canonical-equal on {device_name}")

        # a tier-1 relay crashes: its links observe the Down and derive
        # the tree over the survivors; the membership update then gives
        # every survivor that same epoch
        for r in flat_reps:
            r.crash()
        flat_reps = []
        relay_addr = next(a for a in topo.children.get(topo.root, ()) if topo.children.get(a))
        victim = next(r for r in tree_reps if r.addr == relay_addr)
        survivors = [r for r in tree_reps if r is not victim]
        victim.crash()
        tree_reps = survivors
        global_round(survivors)
        observers = [r for r in survivors if r._tree_down]
        obs_epochs = {r._tree_refresh().epoch for r in observers}
        alive = [r.addr for r in survivors]
        for r in survivors:
            r.set_neighbours(alive)
        epochs = {r._tree_refresh().epoch for r in survivors}
        want_epoch = treesync.derive_tree(alive, fanout=fanout, seed=0).epoch
        if len(obs_epochs) != 1 or epochs != obs_epochs or epochs != {want_epoch}:
            raise AssertionError(f"11a: after the relay crash observers derived {len(obs_epochs)} epochs, "
                                 f"survivors {len(epochs)}")
        writer = survivors[min(writer_idx, len(survivors) - 1)]
        writer.mutate("add", ["after-crash", 1])
        rounds = 0
        while rounds < TREE_MAX_ROUNDS and not all(r.read_keys(["after-crash"]) for r in survivors):
            rounds += 1
            global_round(survivors)
        if not all(r.read_keys(["after-crash"]) for r in survivors):
            raise AssertionError("11a: the probe after the relay crash did not reach every survivor")
        global_round(survivors)
        if len({r.canonical_state_bytes() for r in survivors}) != 1:
            raise AssertionError("11a: the survivors' canonical bytes differ after the relay crash")
        out["relay_crash"] = {"relay": str(relay_addr), "observers": len(observers), "survivors": len(survivors),
                              "rounds": rounds, "epoch": next(iter(epochs))}
        out["launches"] = {probe_lookup_kernel.name: probe_lookup_kernel.launches,
                           batched_roots_kernel.name: batched_roots_kernel.launches}
        if any(out["launches"].values()):
            raise AssertionError(f"11a: a kernel was launched on the binned tree path: {out['launches']}")
        out["leg_s"] = time.perf_counter() - t_leg
        log(f"[tree] 11a relay crash: {relay_addr} (tier 1) crashed; {len(observers)} observers derived one epoch, "
            f"and after the membership update all {len(survivors)} survivors share it; the next probe reached every "
            f"survivor in {rounds} rounds; survivors canonical-equal; leg {out['leg_s']:.3f} s on {device_name}")
        return out
    finally:
        for r in flat_reps:
            r.crash()
        for r in tree_reps:
            r.stop()  # a crash would dump every flight ring through the logger
        plane.close()


def tree_hash(n: int, n_keys: int, device_name: str, device: str = "cuda", fanout: int = TREE_HASH_FANOUT) -> dict:
    """Phase 11b: ``n`` threaded hash-store replicas in tree mode with
    phase 3's configuration (sync interval 20 ms, ``max_sync_size`` 500,
    an ``on_diffs`` feed each); a tier-2 leaf takes ``n_keys`` keys by
    ``mutate_batch``, then ``TREE_HASH_PROPS`` single-op writes are timed
    to their arrival at the last replica, 1% of the keys are removed, and
    every replica reads 4096 keys. The probe kernel runs the feeds' winner passes and
    the reads; it is held bit-equal on a tier-1 relay's own table."""
    import gc

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    gc.collect()
    t_leg = time.perf_counter()
    t = LocalTransport()
    logs = [DiffLog() for _ in range(n)]
    reps = [dc.start_link(dc.AWLWWMap, store="hash", name=f"treeh{i}", node_id=30_000 + i, transport=t,
                          sync_interval=0.02, max_sync_size=500, on_diffs=logs[i], capacity=2 * n_keys,
                          tree_gossip=True, tree_fanout=fanout, device=device)
            for i in range(n)]
    deadline = time.perf_counter() + SLICE_BUDGET_S
    out: dict = {"replicas": n, "keys": n_keys, "fanout": fanout}
    try:
        for r in reps:
            r.set_neighbours([x.addr for x in reps])
        with reps[0]._lock:
            topo = reps[0]._tree_refresh()
        by_addr = {r.addr: r for r in reps}
        writer = by_addr[max(topo.members, key=lambda a: (topo.tier[a], str(a)))]
        relay = by_addr[topo.parent[writer.addr]]
        out["tree"] = {"depth": topo.depth, "root": str(topo.root), "writer": writer.name,
                       "writer_tier": topo.tier[writer.addr], "relay": relay.name}
        if topo.tier[writer.addr] != 2:
            raise AssertionError(f"11b: the writer sits at tier {topo.tier[writer.addr]}, not 2")
        probe_lookup_kernel.reset()  # 11b's run starts here

        t0 = time.perf_counter()
        dc.mutate_batch(writer, "add", [[f"key{i}", i] for i in range(n_keys)], timeout=SLICE_BUDGET_S)
        out["load_s"] = time.perf_counter() - t0
        for i, lg in enumerate(logs):
            lg.wait(lambda d: len(d.view) >= n_keys, deadline, f"11b: {n_keys} keys on {reps[i].name}")
        out["converge_s"] = time.perf_counter() - t0
        log(f"[tree] 11b: {n_keys} keys into tier-2 leaf {writer.name}: mutate_batch {out['load_s']:.3f} s, on all "
            f"{n} replicas after {out['converge_s']:.3f} s")

        lat = []
        for k in range(TREE_HASH_PROPS):
            t1 = time.perf_counter()
            dc.mutate(writer, "add", [f"prop{k}", k])
            for i, lg in enumerate(logs):
                lg.wait(lambda d: d.view.get(f"prop{k}") == k, deadline, f"11b: prop{k} on {reps[i].name}")
            lat.append(max(lg.seen_at[f"prop{k}"] for lg in logs) - t1)
        out["propagation_ms"] = [x * 1e3 for x in lat]
        log(f"[tree] 11b: {TREE_HASH_PROPS} single-op writes to their arrival at the last replica (ms): "
            f"{[round(x * 1e3, 3) for x in lat]} median {float(np.median(lat)) * 1e3:.3f}")

        removed = [f"key{i}" for i in range(0, n_keys, 100)]
        t1 = time.perf_counter()
        dc.mutate_batch(writer, "remove", [[k] for k in removed], timeout=SLICE_BUDGET_S)
        left = n_keys + TREE_HASH_PROPS - len(removed)
        for i, lg in enumerate(logs):
            lg.wait(lambda d: len(d.view) == left and all(k not in d.view for k in removed[-8:]), deadline,
                    f"11b: removes on {reps[i].name}")
        out["remove_converge_s"] = time.perf_counter() - t1

        probe = [f"key{i}" for i in range(0, n_keys, max(1, n_keys // 4096))][:4096]
        want = {k: int(k[3:]) for k in probe if int(k[3:]) % 100 != 0}
        t1 = time.perf_counter()
        for r in reps:
            if dc.read_keys(r, probe) != want:
                raise AssertionError(f"11b: {r.name}'s read_keys disagrees with the written map")
        out["read_keys_ms_all"] = (time.perf_counter() - t1) * 1e3
        while True:
            canon = {r.canonical_state_bytes() for r in reps}
            if len(canon) == 1:
                break
            if time.perf_counter() > deadline:
                raise AssertionError("11b: the replicas did not converge to equal canonical bytes")
            time.sleep(0.1)
        written = {f"key{i}": i for i in range(n_keys) if i % 100 != 0}
        written |= {f"prop{k}": k for k in range(TREE_HASH_PROPS)}
        for r, lg in zip(reps, logs):
            if lg.view != written:
                raise AssertionError(f"11b: {r.name}'s diff feed differs from the written map")
            if r.read_keys(list(written)) != written:
                raise AssertionError(f"11b: {r.name} does not read back every acknowledged write")
        check_on_card(reps, device)
        stats = [r.stats()["tree"] for r in reps]
        roles = {st["role"] for st in stats}
        if len({st["epoch"] for st in stats}) != 1 or roles != {"root", "relay", "leaf"} \
                or sum(st["reemits"] for st in stats) <= 0:
            raise AssertionError(f"11b: tree stats: epochs {len({st['epoch'] for st in stats})}, roles {roles}, "
                                 f"reemits {sum(st['reemits'] for st in stats)}")
        out["launches"] = probe_lookup_kernel.launches
        out["probe_by_shape"] = probe_shape_launches()
        if device == "cuda" and out["launches"] <= 0:
            raise AssertionError("11b: the probe kernel was not launched on the hash-store tree path")
        out["relay"] = {"reemits": sum(st["reemits"] for st in stats),
                        "msgs_folded": sum(st["msgs_folded"] for st in stats),
                        "rows_reemitted": sum(st["rows_reemitted"] for st in stats),
                        "by_role": {st["role"]: 0 for st in stats}}
        for st in stats:
            out["relay"]["by_role"][st["role"]] += st["reemits"]
        out["canonical_bytes"] = len(next(iter(canon)))
        out["table_size"] = relay.state.table_size
        log(f"[tree] 11b: removed {len(removed)} keys (on all after {out['remove_converge_s']:.3f} s); read_keys of "
            f"{len(probe)} keys on all {n} replicas {out['read_keys_ms_all']:.3f} ms; canonical bytes equal; one epoch, "
            f"roles {sorted(roles)}; relay {json.dumps(out['relay'])}; probe kernel launches on this path "
            f"{out['launches']} by HxWxQ {out['probe_by_shape']} on {device_name}")
        # launches below compare the kernel with its plain version on a
        # tier-1 relay's own table and are not the path's
        qs = sorted({int(k.split("x")[2]) for k in out["probe_by_shape"]})
        props = [f"prop{k}" for k in range(TREE_HASH_PROPS)]
        out["table_max_abs_err"] = check_main_tables([relay], n_keys, removed, props, q_sizes=qs)
        out["leg_s"] = time.perf_counter() - t_leg
        return out
    finally:
        for r in reps:
            r.stop()


def tree_tcp_fleets(n: int, device_name: str, device: str = "cuda", flat_wire: "dict | None" = None) -> dict:
    """Phase 11c: phase 9c's two TCP endpoints, each with an ``n``-member
    fleet, now in tree mode with every member's neighbours all ``2n``
    members: each fleet is one tier-0 group whose captain alone links to
    the other endpoint; writes on members of both fleets converge to
    equal canonical bytes on all ``2n``. The wire from endpoint A prints
    beside 9c's flat figures."""
    import gc

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock

    gc.collect()
    t_leg = time.perf_counter()
    ts = [dc.TcpTransport("127.0.0.1") for _ in range(2)]
    clock = LogicalClock()
    fleets = [dc.Fleet([dc.start_link(dc.AWLWWMap, threaded=False, transport=ts[g], clock=clock,
                                      capacity=(1 << FLEET_DEPTH) * 16, tree_depth=FLEET_DEPTH, sync_timeout=0.2,
                                      device=device, name=f"ttf{'ab'[g]}{i}", node_id=40_000 + 1000 * g + i,
                                      tree_gossip=True, tree_fanout=TREE_FANOUT)
                        for i in range(n)]) for g in range(2)]
    out: dict = {"members": 2 * n}
    try:
        addrs = [ts[g].remote_addr(r.name) for g in range(2) for r in fleets[g].replicas]
        for f in fleets:
            for r in f.replicas:
                r.set_neighbours(addrs)
        t_end = time.perf_counter() + 10
        while not all(ts[i].fleet_sink(("x", ts[1 - i].endpoint)) for i in (0, 1)):
            if time.perf_counter() > t_end:
                raise AssertionError("11c: fleet frames were never negotiated")
            time.sleep(0.01)
        captains = []
        for g, f in enumerate(fleets):
            if len({r.tree_group for r in f.replicas}) != 1:
                raise AssertionError(f"11c: fleet {'ab'[g]}'s members carry more than one tree_group")
            other = ts[1 - g].endpoint
            outward = []
            for r in f.replicas:
                with r._lock:
                    links = r._tree_refresh().links(r.addr)
                if any(isinstance(a, tuple) and tuple(a[1]) == tuple(other) for a in links):
                    outward.append(r.name)
            if len(outward) != 1:
                raise AssertionError(f"11c: fleet {'ab'[g]} has {len(outward)} members linked to the other endpoint")
            captains.append(outward[0])
        epochs = [len({r._tree_refresh().epoch for r in f.replicas}) for f in fleets]
        if epochs != [1, 1]:
            raise AssertionError(f"11c: epochs within each endpoint {epochs}")
        wire0 = ts[0].transport_stats()
        for g, f in enumerate(fleets):
            for i in (0, n // 2, n - 1):
                f.replicas[i].mutate_batch("add", [[f"tcp{g}_{i}_{j}", j] for j in range(FLEET_KEYS_PER_ROUND)])
        rounds = 0
        t0 = time.perf_counter()
        members = fleets[0].replicas + fleets[1].replicas
        while True:
            rounds += 1
            for f in fleets:
                f.sync_tick()
            time.sleep(0.05)
            for f in fleets:
                f.drain()
            if len({r.canonical_state_bytes() for r in members}) == 1:
                break
            if time.perf_counter() - t0 > 120:
                raise AssertionError("11c: the two fleets did not converge to equal canonical bytes")
        out["converge_s"] = time.perf_counter() - t0
        want = {f"tcp{g}_{i}_{j}": j for g in range(2) for i in (0, n // 2, n - 1) for j in range(FLEET_KEYS_PER_ROUND)}
        if any(r.read() != want for r in members):
            raise AssertionError("11c: a member's read differs from the written map")
        check_on_card(members, device)
        wire1 = ts[0].transport_stats()
        out.update({"captains": captains, "rounds": rounds, "wire_a_setup": wire0, "wire_a": wire1,
                    "egress_a": fleets[0].stats()["egress"],
                    "relay_a": sum(r.stats()["tree"]["reemits"] for r in fleets[0].replicas)})
        out["leg_s"] = time.perf_counter() - t_leg
        log(f"[tree] 11c: two {n}-member tree fleets over TCP: one tree_group a fleet, captains {captains} (the only "
            f"members linked to the other endpoint); writes on both converged on all {2 * n} in {rounds} ticks "
            f"({out['converge_s']:.3f} s); relay re-emits on A {out['relay_a']}; wire from A "
            f"{json.dumps(wire1)}; 9c's flat wire from A in this run {json.dumps(flat_wire)} on {device_name}")
        return out
    finally:
        for f in fleets:
            for r in f.replicas:
                r.crash()
        for t in ts:
            t.close()


def phase_tree(device_name: str, device: str = "cuda", flat_wire: "dict | None" = None,
               t_start: "float | None" = None) -> dict:
    t0 = time.perf_counter()
    probes = TREE_PROBES
    if t_start is not None:
        # one probe fewer while the rest of the run would pass the guard
        spent = t0 - t_start
        while probes > 1 and spent + TREE_RESERVE_S - (TREE_PROBES - probes) * TREE_PROBE_S > RUN_GUARD_S:
            probes -= 1
        if probes < TREE_PROBES:
            log(f"[cut] phase 11a probes {TREE_PROBES} -> {probes}: {spent:.3f} s so far, about "
                f"{TREE_RESERVE_S:.0f} s to go with {TREE_PROBES}, past the {RUN_GUARD_S:.0f} s guard")
    out = {"11a": tree_vs_flat(device_name, device, probes=probes)}
    out["11b"] = tree_hash(TREE_HASH_N, TREE_HASH_KEYS, device_name, device)
    out["11c"] = tree_tcp_fleets(TREE_TCP_FLEET_N, device_name, device, flat_wire)
    out["phase_s"] = time.perf_counter() - t0
    log(f"[tree] phase 11 {out['phase_s']:.3f} s (11a {out['11a']['leg_s']:.3f} s, 11b {out['11b']['leg_s']:.3f} s, "
        f"11c {out['11c']['leg_s']:.3f} s) on {device_name}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the multi-device mesh

#: 12a: ``bench.py --fleet --mesh``'s topology (``bench.py:2183``) at its
#: full widths: 64 members paired i <-> i+32, 4 fresh keys a member a
#: round, depth 6, one sink a member; 3 timed rounds after one warm-up
#: (the bench's 4, cut so that the phase fits the run's time)
MESH_N = 64
MESH_ROUNDS = 3
MESH_KEYS = 4
MESH_DEPTH = 6
MESH_SHARDS = (1, 2, 4, 8)
#: 12b: phase 7a's ingress geometry at N = 256, on a 4-shard mesh; 1
#: timed round (7a's 3, cut for time) between the warm-up and the traced one
MESH_7A_N = 256
MESH_7A_SHARDS = 4
MESH_7A_ROUNDS = 1
#: 12d: keys the pinned pair loads
PINNED_KEYS = 1 << 16


def card_mesh(shards: int, device: str = "cuda"):
    """A mesh of ``shards`` shards on one card (``cuda:0`` listed once a
    shard) — the shape a one-card host can run."""
    from delta_crdt_ex_tpu_torch.utils.devices import fleet_mesh

    dev = "cuda:0" if device == "cuda" else device
    return fleet_mesh(shards, devices=[dev] * shards)


def mesh_fleet_leg(shards: int, store, device_name: str, device: str = "cuda", mesh=None) -> dict:
    """12a: n members in ONE mesh fleet gossiping pairwise (member i with
    member i + n/2, so every co-mesh edge crosses half the mesh) plus a
    sink a member, against a vmap fleet fed the same script. A round
    times the egress tick (member-syncs/s) and the drain of the
    plane-delivered entries (merges/s) of both fleets; every sink's
    stream must equal its twin sink's; at the end every member's state
    columns, canonical bytes, seq and in-flight slots equal its twin's,
    the plane carried intra-mesh entries, and the only fallback entries
    are the sinks'. Returns the leg's numbers and both fleets' members."""
    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.models.binned import to_numpy as b_np
    from delta_crdt_ex_tpu_torch.models.hash_store import to_numpy as h_np
    from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n, rounds = MESH_N, MESH_ROUNDS
    mesh = card_mesh(shards, device) if mesh is None else mesh
    leg = f"12a {store or 'binned'} shards={shards} on {[str(d) for d in mesh.devices]}"
    tag = f"mz{store or 'b'}{shards}{mesh.devices[-1].index}"
    t0 = time.perf_counter()
    t = LocalTransport()
    mk = lambda name, node: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=LogicalClock(), capacity=(1 << MESH_DEPTH) * 16,
        tree_depth=MESH_DEPTH, name=name, node_id=node, sync_timeout=3600.0, store=store, device=device,
    )
    fm = [mk(f"{tag}m{i}", 10_000 + i) for i in range(n)]
    vm = [mk(f"{tag}v{i}", 10_000 + i) for i in range(n)]
    for i in range(n):
        t.register(f"{tag}mr{i}", _Sink())
        t.register(f"{tag}vr{i}", _Sink())
        fm[i].set_neighbours([fm[(i + n // 2) % n], f"{tag}mr{i}"])
        vm[i].set_neighbours([vm[(i + n // 2) % n], f"{tag}vr{i}"])
    f_mesh, f_vmap = dc.Fleet(fm, mesh=mesh), dc.Fleet(vm)
    setup_s = time.perf_counter() - t0
    dts: dict = {"mesh_egress": [], "vmap_egress": [], "mesh_ingress": [], "vmap_ingress": []}
    merged: list = []
    sink_entries = 0
    for rnd in range(rounds + 1):  # round 0 warms up
        base = 1_000_003 * rnd
        for i in range(n):
            items = [[base + i * 1000 + j, base + i * 1000 + j] for j in range(MESH_KEYS)]
            fm[i].mutate_batch("add", items)
            vm[i].mutate_batch("add", items)
        for name, f in (("mesh", f_mesh), ("vmap", f_vmap)):
            sync()
            t1 = time.perf_counter()
            f.sync_tick()
            sync()
            if rnd:
                dts[f"{name}_egress"].append(time.perf_counter() - t1)
        for i in range(n):
            a_msgs, b_msgs = t.drain(f"{tag}mr{i}"), t.drain(f"{tag}vr{i}")
            if not len(a_msgs) == len(b_msgs) > 0:
                raise AssertionError(f"{leg}: round {rnd} sink {i}: {len(a_msgs)} vs {len(b_msgs)} messages")
            for a, b in zip(a_msgs, b_msgs):
                if not _norm_eq(_norm_out(a), _norm_out(b)):
                    raise AssertionError(f"{leg}: round {rnd} sink {i}: outbound {type(a).__name__} differs")
            sink_entries += sum(isinstance(m, sync_proto.EntriesMsg) for m in a_msgs)
        for r in fm + vm:
            _entries_to(t, r.addr)  # walk back-traffic out: merges are the quantity
        counts = {}
        for name, f in (("mesh", f_mesh), ("vmap", f_vmap)):
            sync()
            t1 = time.perf_counter()
            counts[name] = f.drain()
            sync()
            if rnd:
                dts[f"{name}_ingress"].append(time.perf_counter() - t1)
        if not counts["mesh"] == counts["vmap"] > 0:
            raise AssertionError(f"{leg}: round {rnd}: mesh drained {counts['mesh']}, vmap {counts['vmap']}")
        if rnd:
            merged.append(counts["mesh"])
        for r in fm + vm:
            r._outstanding.clear()
            r._sync_open_seq.clear()
    to_np = h_np if store == "hash" else b_np
    for a, b in zip(fm, vm):
        if a._seq != b._seq or a._seq <= 0 or len(a._outstanding) != len(b._outstanding):
            raise AssertionError(f"{leg}: {a.name} seq/slots {a._seq}/{len(a._outstanding)} vs {b._seq}/{len(b._outstanding)}")
        ca, cb = to_np(a.state), to_np(b.state)
        for c in ca:
            if not np.array_equal(ca[c], cb[c]):
                raise AssertionError(f"{leg}: mesh/vmap state diverged at {a.name}: {c}")
        if a.canonical_state_bytes() != b.canonical_state_bytes():
            raise AssertionError(f"{leg}: mesh/vmap canonical bytes diverged at {a.name}")
    check_on_card(fm + vm, "cuda" if cuda else device)
    ms = f_mesh.stats()["mesh"]
    if not ms["enabled"] or ms["shards"] != shards or ms["intra_entries"] <= 0:
        raise AssertionError(f"{leg}: the plane carried nothing: {ms}")
    if ms["fallback_entries"] != sink_entries:
        raise AssertionError(f"{leg}: fallback entries {ms['fallback_entries']}, but the sinks got {sink_entries}")
    if shards > 1 and not (ms["exchanges"] > 0 and ms["permuted_bytes"] > 0):
        raise AssertionError(f"{leg}: no rotation ran: {ms}")
    med = lambda ds: float(np.median(ds))
    m = {
        "replicas": n, "shards": shards, "store": store or "binned", "devices": [str(d) for d in mesh.devices],
        "setup_s": setup_s,
        "mesh_member_syncs_per_sec": n / med(dts["mesh_egress"]), "vmap_member_syncs_per_sec": n / med(dts["vmap_egress"]),
        "mesh_merges_per_sec": sum(merged) / sum(dts["mesh_ingress"]),
        "vmap_merges_per_sec": sum(merged) / sum(dts["vmap_ingress"]),
        "mesh_egress_ms": [x * 1e3 for x in dts["mesh_egress"]], "vmap_egress_ms": [x * 1e3 for x in dts["vmap_egress"]],
        "mesh_ingress_ms": [x * 1e3 for x in dts["mesh_ingress"]], "vmap_ingress_ms": [x * 1e3 for x in dts["vmap_ingress"]],
        "merges_per_round": merged, "sink_entries": sink_entries,
        "intra_entries": ms["intra_entries"], "fallback_entries": ms["fallback_entries"],
        "permuted_bytes": ms["permuted_bytes"], "exchanges": ms["exchanges"],
        "members_per_shard": ms["members_per_shard"], "topology": ms["topology"],
    }
    log(f"[mesh] {leg}: mesh {m['mesh_member_syncs_per_sec']:.3f} vs vmap {m['vmap_member_syncs_per_sec']:.3f} "
        f"member-syncs/s, mesh {m['mesh_merges_per_sec']:.3f} vs vmap {m['vmap_merges_per_sec']:.3f} merges/s "
        f"(median egress ticks ms mesh {[round(x, 3) for x in m['mesh_egress_ms']]}, vmap "
        f"{[round(x, 3) for x in m['vmap_egress_ms']]}); {ms['intra_entries']} intra / {ms['fallback_entries']} "
        f"fallback (= the sinks') entries, {ms['exchanges']} exchanges, {ms['permuted_bytes']} B permuted; every "
        f"member's state, canonical bytes, seq and slots equal its vmap twin's, every sink stream equal; "
        f"set-up {setup_s:.3f} s on {device_name}")
    m["members"] = fm
    return m


def mesh_hash_reads(members, device_name: str, device: str = "cuda") -> dict:
    """12a's hash leg, after it: ``read_keys`` on every mesh-fleet member
    (each holds its own keys and its partner's), which launches the probe
    kernel on the member's table; then the kernel held bit-equal to its
    plain version on every member's own table at the Q it launched at."""
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel

    n = len(members)
    keys_of = lambda i: [1_000_003 * rnd + i * 1000 + j for rnd in range(MESH_ROUNDS + 1) for j in range(MESH_KEYS)]
    probe_lookup_kernel.reset()
    for i, r in enumerate(members):
        want = {k: k for k in keys_of(i) + keys_of((i + n // 2) % n)}
        got = r.read_keys(list(want))
        if got != want:
            raise AssertionError(f"12a hash: member {r.name} read_keys differs from its written keys")
    launches = probe_lookup_kernel.launches
    by_shape = {f"{h}x{w}x{q}": c for (h, w, q), c in probe_lookup_kernel.launches_by_shape.items()}
    if device == "cuda" and launches < n:  # (a rehearsal on the CPU has no kernel)
        raise AssertionError(f"12a hash: {launches} probe launches for {n} members' reads")
    qs = sorted({q for (_h, _w, q) in probe_lookup_kernel.launches_by_shape})
    err = 0
    for i, r in enumerate(members):
        with r._lock:
            st = r.state
        extra = keys_of(i) + keys_of((i + n // 2) % n)
        err = max(err, check_main_tables([(r.name, st)], 0, [], extra=extra, q_sizes=qs, quiet=True))
    log(f"[mesh] 12a hash: read_keys on all {n} mesh-fleet members read back every written key; probe launches "
        f"{launches} by (H, W, Q) {by_shape}, bit-equal to probe_lookup_ref on every member's table at Q {qs} "
        f"on {device_name}")
    return {"launches": launches, "probe_by_shape": by_shape, "table_max_abs_err": err}


def mesh_gossip(base, device_name: str, device: str = "cuda") -> dict:
    """12c: ``gossip_delta_drive`` over an 8-shard mesh at phase 6's
    geometry — 8 replicas grown from the fan-in's base, 4096 fresh
    entries each — with the frontier at the whole tree (every differing
    bucket ships a step): steps until no bucket differs, then every
    root equal and every replica's entries and context equal, the base's
    entries plus all 8 × 4096 fresh ones; one step timed by itself."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.apply import OP_PAD
    from delta_crdt_ex_tpu_torch.parallel import gossip_delta_drive, gossip_delta_step, place_states

    n = GOSSIP_LANES
    L = base.num_buckets
    mesh = card_mesh(n, device)
    stacked = place_states(gossip_lanes(base, device), mesh)
    want = int(base.alive.sum()) + n * GOSSIP_FRESH
    slots = np.zeros(n, np.int32)
    empty = (np.full((n, 1), -1, np.int32), np.full((n, 1, 1), OP_PAD, np.int32), np.zeros((n, 1, 1), np.uint64),
             np.zeros((n, 1, 1), np.uint32), np.zeros((n, 1, 1), np.int64))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    steps, retiers, decay = 0, 0, []
    while True:
        stacked, roots, n_diff, r = gossip_delta_drive(mesh, stacked, slots, *empty, frontier=L)
        steps += 1
        retiers += r
        decay.append(int(n_diff.gather().max()))
        if decay[-1] == 0 or steps > 2 * n:
            break
    sync()
    wall = time.perf_counter() - t0
    if decay[-1] != 0:
        raise AssertionError(f"12c: divergence left after {steps} steps: {decay}")
    roots_h = roots.gather().cpu().numpy()
    if not (roots_h == roots_h[0]).all():
        raise AssertionError(f"12c: roots differ: {roots_h.tolist()}")
    views = canonical_lanes(stacked.gather())
    for i, (ent, ctx) in enumerate(views):
        if not (np.array_equal(ent, views[0][0]) and np.array_equal(ctx, views[0][1])):
            raise AssertionError(f"12c: replica {i}'s content differs from replica 0's")
    if views[0][0].shape[1] != want:
        raise AssertionError(f"12c: {views[0][0].shape[1]} alive entries, want {want}")
    sync()
    t1 = time.perf_counter()
    gossip_delta_step(mesh, stacked, slots, *empty, frontier=L)
    sync()
    m = {"replicas": n, "buckets": L, "frontier": L, "steps": steps, "retiers": retiers, "n_diff_by_step": decay,
         "wall_s": wall, "converged_step_ms": (time.perf_counter() - t1) * 1e3, "entries": want}
    log(f"[mesh] 12c gossip_delta_drive on {n} shards of {mesh.devices[0]} (L = {L}, frontier {L}): n_diff by step {decay}, "
        f"{steps} steps, {retiers} retiers, {wall:.3f} s; a converged step {m['converged_step_ms']:.3f} ms; every "
        f"root equal, every replica's {want} entries and context equal on {device_name}")
    return m


def pinned_pair(device_name: str, device: str = "cuda") -> dict:
    """12d: two replicas pinned to one card (``device="cuda:0"``) and,
    for comparison, two on a bare ``"cuda"`` (the host plane): replica 1
    loads ``n_keys`` keys, sync rounds run until replica 2's canonical
    bytes equal replica 1's. The pinned pair's slices ride the device
    plane (``replica.slice_place`` counted, tensor bodies, every merge
    labelled ``device``), the unpinned pair's the host plane; both end
    equal and every state column stays on the card."""
    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime import telemetry
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport
    from delta_crdt_ex_tpu_torch.utils import transfers

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pinned, n_keys = f"{device}:0", PINNED_KEYS
    out = {}
    canon = {}
    for plane, dev in (("device", pinned), ("host", device)):
        t = LocalTransport()
        mk = lambda name: dc.start_link(dc.AWLWWMap, threaded=False, transport=t, clock=LogicalClock(), name=name,
                                        capacity=n_keys * 2, tree_depth=12, max_sync_size=4096, device=dev)
        a, b = mk(f"pp{plane}a"), mk(f"pp{plane}b")
        a.set_neighbours([b])
        b.set_neighbours([a])
        a.mutate_batch("add", [[f"pin{k}", k] for k in range(n_keys)])
        planes: list = []
        rec = lambda _e, _m, meta: planes.append(meta["plane"])
        telemetry.attach(telemetry.SYNC_ROUND, rec)
        before = transfers.snapshot()
        sync()
        t0 = time.perf_counter()
        rounds = 0
        try:
            while rounds < 50:
                rounds += 1
                for r in (a, b):
                    r.sync_to_all()
                t.pump()
                if b.canonical_state_bytes() == a.canonical_state_bytes():
                    break
        finally:
            telemetry.detach(telemetry.SYNC_ROUND, rec)
        sync()
        dt = time.perf_counter() - t0
        now = transfers.snapshot()
        placed = now["replica.slice_place"]["count"] - before["replica.slice_place"]["count"]
        if b.canonical_state_bytes() != a.canonical_state_bytes():
            raise AssertionError(f"12d {plane}: the pair did not converge in {rounds} rounds")
        if plane == "device" and not (placed > 0 and planes and set(planes) == {"device"}):
            raise AssertionError(f"12d device: {placed} slices placed, merge planes {set(planes)}")
        if plane == "host" and (placed or set(planes) != {"host"}):
            raise AssertionError(f"12d host: {placed} slices placed, merge planes {set(planes)}")
        check_on_card([a, b], device)
        if plane == "device" and not (a.pinned_device == b.pinned_device == torch.device(pinned)):
            raise AssertionError("12d: the pair is not pinned")
        canon[plane] = b.read_keys([f"pin{k}" for k in range(0, n_keys, 97)])
        out[plane] = {"rounds": rounds, "converge_s": dt, "slices_placed": placed, "merges": len(planes)}
        for r in (a, b):
            r.stop()
    if canon["device"] != canon["host"]:
        raise AssertionError("12d: the pinned pair reads differently from the host-plane pair")
    log(f"[mesh] 12d pinned pair on {pinned}: {n_keys} keys converged in {out['device']['rounds']} rounds, "
        f"{out['device']['converge_s']:.3f} s, {out['device']['slices_placed']} slices placed on the device plane, "
        f"{out['device']['merges']} merges all labelled device, every column on the card; the host-plane pair "
        f"on {device}: {out['host']['rounds']} rounds, {out['host']['converge_s']:.3f} s, {out['host']['merges']} "
        f"merges; both read alike on {device_name}")
    return out


def phase_mesh(device_name: str, base=None, device: str = "cuda") -> dict:
    """Phase 12: the multi-device mesh (12a-12e); see the module
    docstring. ``base`` is the fan-in's base state (built here when the
    phase runs alone)."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    t0 = time.perf_counter()
    probe_lookup_kernel.reset()  # the mesh path's run starts here
    batched_roots_kernel.reset()
    out: dict = {}
    legs_s: dict = {}
    for shards in MESH_SHARDS:
        t1 = time.perf_counter()
        m = mesh_fleet_leg(shards, None, device_name, device)
        m.pop("members")
        out[f"12a_binned_{shards}"] = m
        legs_s[f"12a_binned_{shards}"] = time.perf_counter() - t1
    probe_before = probe_lookup_kernel.launches
    if probe_before:
        raise AssertionError(f"12a binned: {probe_before} probe launches on the binned mesh path")
    t1 = time.perf_counter()
    m = mesh_fleet_leg(MESH_SHARDS[-1], "hash", device_name, device)
    members = m.pop("members")
    m["reads"] = mesh_hash_reads(members, device_name, device)
    # the launches the checks made against the plain version do not count
    compared = probe_lookup_kernel.launches - m["reads"]["launches"]
    out[f"12a_hash_{MESH_SHARDS[-1]}"] = m
    legs_s[f"12a_hash_{MESH_SHARDS[-1]}"] = time.perf_counter() - t1
    reads = m["reads"]
    t1 = time.perf_counter()
    m = fleet_ingress(MESH_7A_N, None, device_name, device, mesh=card_mesh(MESH_7A_SHARDS, device),
                      rounds=MESH_7A_ROUNDS)
    out[f"12b_ingress_{MESH_7A_N}_shards_{MESH_7A_SHARDS}"] = m
    legs_s["12b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    if base is None:
        from delta_crdt_ex_tpu_torch.utils.synth import build_state

        geo = FANIN_FULL
        keys = np.random.default_rng(0).integers(1, 1 << 63, size=geo["keys"], dtype=np.uint64)
        base, _ = build_state(11, keys, geo["L"], geo["B"], geo["R"], device=device)
        legs_s["12c_base_build"] = time.perf_counter() - t1
        t1 = time.perf_counter()
    out["12c_gossip"] = mesh_gossip(base, device_name, device)
    legs_s["12c"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["12d_pinned_pair"] = pinned_pair(device_name, device)
    legs_s["12d"] = time.perf_counter() - t1
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        from delta_crdt_ex_tpu_torch.utils.devices import fleet_mesh

        m = mesh_fleet_leg(2, None, device_name, mesh=fleet_mesh(2, devices=["cuda:0", "cuda:1"]))
        m.pop("members")
        out["12e_two_cards"] = m
    else:
        out["12e_two_cards"] = None
        log(f"[mesh] 12e: only one card is present ({n_cards}); no cross-card run was possible")
    out["launches"] = {probe_lookup_kernel.name: probe_lookup_kernel.launches - compared,
                       batched_roots_kernel.name: batched_roots_kernel.launches}
    if out["launches"][batched_roots_kernel.name]:
        raise AssertionError(f"the roots kernel was launched on the mesh path: {out['launches']}")
    if out["launches"][probe_lookup_kernel.name] != reads["launches"]:
        raise AssertionError(f"probe launches on the mesh path {out['launches']} are not 12a's reads' {reads['launches']}")
    out["probe_by_shape"] = reads["probe_by_shape"]
    out["table_max_abs_err"] = reads["table_max_abs_err"]
    out["phase_s"] = time.perf_counter() - t0
    out["legs_s"] = legs_s
    log(f"[mesh] phase 12 {out['phase_s']:.3f} s (by leg {json.dumps({k: round(v, 3) for k, v in legs_s.items()})}); "
        f"kernel launches on the mesh path {out['launches']} ({compared} more compared the probe with its plain "
        f"version) on {device_name}")
    return out


# ---------------------------------------------------------------------------
# phase 13: conformance on the card — the registry at deployment size,
# the seeded soak, the examples

#: 13a: a Horde-style registry of 3 nodes (``examples/torch_registry.py``
#: at deployment size): names registered, a third from each node; names
#: registered concurrently on two nodes; lookups a batch
REGISTRY_NODES = ("a", "b", "c")
REGISTRY_NAMES = 1 << 16
REGISTRY_CONTESTED = 1024
REGISTRY_BATCH = 2048
REGISTRY_BUDGET_S = 300.0
#: 13b: ``tests/test_soak.py``'s history, replicas x ops, one entry a
#: seed: (seed, store, every other replica pinned to the card)
SOAK_REPLICAS = 6
SOAK_OPS = 300
SOAK_RUNS = ((31, None, False), (32, "hash", True))
#: 13c: the examples run as subprocesses on the card
EXAMPLES = ("examples/torch_quickstart.py", "examples/torch_registry.py")
EXAMPLE_TIMEOUT_S = 300


def registry_leg(store, device_name: str, device: str = "cuda") -> dict:
    """13a on one store: three threaded nodes (sync_interval 20 ms)
    register ``REGISTRY_NAMES`` names through ``mutate_batch``, a third
    from each node, each value ``(node, pid)``; ``REGISTRY_CONTESTED`` of
    them are registered again on nodes a and c at once, from two threads
    (neither has seen the other's write) — every node must converge to
    one LWW winner. Lookups of every name through ``read_keys`` on each
    node, ``REGISTRY_BATCH`` names a call. Then node b crashes and node a
    removes b's names with ``mutate_batch("remove", ...)``: both
    survivors read the dict oracle and hold equal canonical bytes, every
    state column on the card. On the hash store the lookups launch the
    probe kernel, and every launch is then held bit-equal to its plain
    version on the node's own table at the Q it launched at."""
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    tag = store or "binned"
    t = LocalTransport()
    nodes = {
        n: dc.start_link(dc.AWLWWMap, store=store, name=f"reg-{tag}-{n}", transport=t, sync_interval=0.02,
                         max_sync_size=500, capacity=2 * REGISTRY_NAMES, device=device)
        for n in REGISTRY_NODES
    }
    for me in nodes.values():
        dc.set_neighbours(me, [r for r in nodes.values() if r is not me])
    deadline = time.perf_counter() + REGISTRY_BUDGET_S
    names = [f"svc-{i}" for i in range(REGISTRY_NAMES)]
    oracle = {name: (REGISTRY_NODES[i % 3], i) for i, name in enumerate(names)}
    m: dict = {"store": tag, "names": REGISTRY_NAMES, "contested": REGISTRY_CONTESTED}
    alive = list(REGISTRY_NODES)
    try:
        probe_lookup_kernel.reset()  # the registry path's run starts here
        t0 = time.perf_counter()
        for n in REGISTRY_NODES:
            dc.mutate_batch(nodes[n], "add", [[name, v] for name, v in oracle.items() if v[0] == n],
                            timeout=REGISTRY_BUDGET_S)
        m["register_s"] = time.perf_counter() - t0
        contested = names[:REGISTRY_CONTESTED]
        cand = {name: {("a", 10_000_000 + i), ("c", 20_000_000 + i)} for i, name in enumerate(contested)}
        writes = {n: [[name, (n, base + i)] for i, name in enumerate(contested)]
                  for n, base in (("a", 10_000_000), ("c", 20_000_000))}
        t1 = time.perf_counter()
        run_threads([lambda n=n: dc.mutate_batch(nodes[n], "add", writes[n], timeout=REGISTRY_BUDGET_S)
                     for n in writes], REGISTRY_BUDGET_S)
        wait_equal_canonical(list(nodes.values()), deadline, f"13a {tag}: registration")
        m["converge_s"] = time.perf_counter() - t1
        winners = dc.read_keys(nodes["a"], contested)
        for name in contested:
            if winners.get(name) not in cand[name]:
                raise AssertionError(f"13a {tag}: {name} resolved to {winners.get(name)}, not one of {cand[name]}")
            oracle[name] = winners[name]
        split = {w[0] for w in winners.values()}
        lat = []
        for n in REGISTRY_NODES:
            for lo in range(0, len(names), REGISTRY_BATCH):
                batch = names[lo:lo + REGISTRY_BATCH]
                t2 = time.perf_counter()
                got = dc.read_keys(nodes[n], batch)
                lat.append(time.perf_counter() - t2)
                if got != {k: oracle[k] for k in batch}:
                    raise AssertionError(f"13a {tag}: node {n}'s lookups differ from the oracle at {lo}")
        m["lookup_ms"] = pct_ms(lat)
        m["lookups"] = len(lat)
        m["launches"] = probe_lookup_kernel.launches
        m["launches_by_shape"] = probe_shape_launches()
        with nodes["b"]._lock:
            table_b = nodes["b"].state
        dead = [name for name, v in oracle.items() if v[0] == "b"]
        t3 = time.perf_counter()
        nodes["b"].crash()  # no goodbye sync: the node just dies
        alive.remove("b")
        dc.mutate_batch(nodes["a"], "remove", [[name] for name in dead], timeout=REGISTRY_BUDGET_S)
        survivors = [nodes[n] for n in alive]
        canon = wait_equal_canonical(survivors, deadline, f"13a {tag}: cleanup")
        m["cleanup_s"] = time.perf_counter() - t3
        for name in dead:
            del oracle[name]
        for r in survivors:
            if r.read() != oracle:
                raise AssertionError(f"13a {tag}: {r.name}'s read differs from the dict oracle")
        check_on_card(survivors, device)
        m["canonical_bytes"] = len(canon)
        m["dead_names"] = len(dead)
        if store == "hash":
            if device == "cuda" and m["launches"] < len(lat):
                raise AssertionError(f"13a hash: {m['launches']} probe launches for {len(lat)} lookups")
            qs = sorted({int(k.split("x")[2]) for k in m["launches_by_shape"]})
            # launches below compare the kernel with its plain version
            m["table_max_abs_err"] = max(
                check_main_tables([("reg-hash-b", table_b)], 0, [], extra=names, q_sizes=qs, quiet=True),
                check_main_tables(survivors, 0, dead, extra=names, q_sizes=qs, quiet=True),
            )
        elif m["launches"]:
            raise AssertionError(f"13a binned: {m['launches']} probe launches on the binned store")
        log(f"[registry] 13a {tag}: {REGISTRY_NAMES} names on 3 nodes: register_s {m['register_s']:.3f}, "
            f"{REGISTRY_CONTESTED} contested on a and c, converge_s {m['converge_s']:.3f} (winners from "
            f"{sorted(split)}, one on every node), lookups of every name on each node in {len(lat)} read_keys "
            f"calls of {REGISTRY_BATCH}: p50 {m['lookup_ms']['p50_ms']:.3f} ms p99 {m['lookup_ms']['p99_ms']:.3f} ms a "
            f"batch; node b crashed, {len(dead)} names removed by node a, cleanup_s {m['cleanup_s']:.3f}; both "
            f"survivors read the oracle, canonical bytes equal ({len(canon)} B); probe launches {m['launches']} "
            f"by (H, W, Q) {m['launches_by_shape']}"
            + (", bit-equal to probe_lookup_ref on every node's own table" if store == "hash" else "")
            + f" on {device_name}")
        return m
    finally:
        for n in alive:
            nodes[n].stop()


def soak_on_card(n_replicas: int, n_ops: int, seed: int, store, pin: bool, device_name: str,
                 t_start: float, device: str = "cuda") -> dict:
    """13b: the history of ``tests/test_soak.py``'s ``_run_soak`` (that
    file imports JAX, so this is the script's own copy): writes, removes,
    clears, partitions, heals and crash-rehydrates from ``MemoryStorage``
    on ``n_replicas`` replicas on the card, every other one pinned to
    ``cuda:0`` when ``pin``; at every heal every replica reads the dict
    oracle. Past ``RUN_GUARD_S`` it stops drawing ops (the cut is
    logged) and heals and checks what it has."""
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.storage import MemoryStorage
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel

    rng = np.random.default_rng(seed)
    transport, clock, storage = LocalTransport(), LogicalClock(), MemoryStorage()
    pinned = f"{device}:0"

    def mk(i):
        return dc.start_link(dc.AWLWWMap, store=store, threaded=False, transport=transport, clock=clock,
                             capacity=256, tree_depth=6, name=f"soak{seed}-{i}", storage_module=storage,
                             device=pinned if pin and i % 2 == 0 else device)

    def converge(rounds=8):
        for _ in range(rounds):
            for r in reps:
                r.sync_to_all()
            transport.pump()

    def rewire(partition: set):
        for i, r in enumerate(reps):
            side = i in partition
            r.set_neighbours([x for j, x in enumerate(reps) if x is not r and (j in partition) == side])

    reps = [mk(i) for i in range(n_replicas)]
    rewire(set())
    model: dict = {}
    partitioned: set = set()
    counts = {"adds": 0, "removes": 0, "clears": 0, "partitions": 0, "heals": 0, "crashes": 0, "checks": 0}
    t0 = time.perf_counter()
    ran = n_ops
    probe_lookup_kernel.reset()
    try:
        for step in range(n_ops):
            if time.perf_counter() - t_start > RUN_GUARD_S:
                ran = step
                log(f"[cut] 13b seed {seed}: {ran} of {n_ops} ops, {time.perf_counter() - t_start:.3f} s into the "
                    f"run (guard {RUN_GUARD_S:.0f} s)")
                break
            who = int(rng.integers(0, n_replicas))
            op = rng.random()
            key = int(rng.integers(1, 40))
            if partitioned and op >= 0.62:  # only adds keep the dict exact under a partition
                op = op * 0.62 if op < 0.86 else op
            if op < 0.62:
                val = int(rng.integers(0, 1000))
                reps[who].mutate("add", [key, val])
                model[key] = val
                counts["adds"] += 1
            elif op < 0.82:
                converge()  # a remove is dict-exact once the remover saw every dot
                reps[who].mutate("remove", [key])
                model.pop(key, None)
                counts["removes"] += 1
            elif op < 0.86:
                converge()
                reps[who].mutate("clear", [])
                model.clear()
                counts["clears"] += 1
            elif op < 0.92 and not partitioned:
                k = int(rng.integers(1, n_replicas))
                partitioned = {int(x) for x in rng.choice(n_replicas, k, replace=False)}
                rewire(partitioned)
                counts["partitions"] += 1
            elif op < 0.96 and partitioned:
                partitioned = set()
                rewire(partitioned)
                counts["heals"] += 1
            else:
                victim = int(rng.integers(0, n_replicas))
                transport.unregister(reps[victim].addr)  # the crash: no goodbye sync
                reps[victim] = mk(victim)
                rewire(partitioned)
                counts["crashes"] += 1
            if not partitioned and (step % 7 == 0 or step == n_ops - 1):
                converge()
                counts["checks"] += 1
                for i, r in enumerate(reps):
                    if r.read() != model:
                        raise AssertionError(f"13b seed {seed}: replica {i} differs from the oracle at step {step}")
        if partitioned:
            rewire(set())
        converge(10)
        for i, r in enumerate(reps):
            if r.read() != model:
                raise AssertionError(f"13b seed {seed}: replica {i} differs from the oracle at the end")
        canon = {r.canonical_state_bytes() for r in reps}
        if len(canon) != 1:
            raise AssertionError(f"13b seed {seed}: the replicas' canonical bytes differ")
        check_on_card(reps, device)
        if pin and not all(r.pinned_device is not None for r in reps[::2]):
            raise AssertionError(f"13b seed {seed}: the even replicas are not pinned")
        wall = time.perf_counter() - t0
        launches, by_shape = probe_lookup_kernel.launches, probe_shape_launches()
        err = 0
        if launches:
            # whatever launched the kernel here is held against its plain
            # version on every replica's final table at the Q it ran at
            qs = sorted({int(k.split("x")[2]) for k in by_shape})
            keys = list(range(1, 40))
            err = check_main_tables(reps, 0, [k for k in keys if k not in model], extra=keys, q_sizes=qs, quiet=True)
        out = {"seed": seed, "store": store or "binned", "pinned": pin, "replicas": n_replicas, "ops": ran,
               "ops_drawn": n_ops, "wall_s": wall, "keys": len(model), **counts, "probe_launches": launches,
               "probe_by_shape": by_shape, "table_max_abs_err": err}
        log(f"[soak] 13b seed {seed} {store or 'binned'}{' (every other replica on ' + pinned + ')' if pin else ''}: "
            f"{n_replicas} replicas x {ran} ops in {wall:.3f} s, {json.dumps(counts)}; every replica read the dict "
            f"oracle at each of {counts['checks']} heals and at the end ({len(model)} keys), canonical bytes equal, "
            f"every column on the card; probe launches {launches} by (H, W, Q) {by_shape}"
            + (", bit-equal to probe_lookup_ref on every replica's final table" if launches else "")
            + f" on {device_name}")
        return out
    finally:
        for r in reps:
            r.stop()
        MemoryStorage.clear()


def start_examples() -> tuple:
    """13c: start each example of ``EXAMPLES`` as a subprocess with its
    default device (the card), all at once; returns ``(t0, procs)``."""
    here = Path(__file__).resolve().parent
    procs = {ex: subprocess.Popen([sys.executable, str(here / ex)], cwd=here, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for ex in EXAMPLES}
    return time.perf_counter(), procs


def stop_examples(started: tuple) -> None:
    for p in started[1].values():
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_examples(started: tuple, device_name: str) -> dict:
    """Wait for the examples :func:`start_examples` started; each must
    exit 0 within ``EXAMPLE_TIMEOUT_S`` of the start."""
    t0, procs = started
    out = {}
    try:
        for ex, p in procs.items():
            stdout, stderr = p.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
            dt = time.perf_counter() - t0
            last = (stdout.strip().splitlines() or [""])[-1]
            if p.returncode != 0:
                raise AssertionError(f"13c: {ex} exited {p.returncode}: {stderr[-2000:]}")
            out[ex] = {"rc": p.returncode, "done_after_s": dt, "last_line": last}
            log(f"[examples] 13c {ex}: exit 0, done {dt:.3f} s after the start: {last!r} on {device_name}")
    finally:
        stop_examples(started)
    return out


def phase_conformance(device_name: str, t_start: float, device: str = "cuda") -> dict:
    """Phase 13: 13a the registry on each store (hash first), 13b the
    soak at each of ``SOAK_RUNS``, 13c the examples."""
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    t0 = time.perf_counter()
    out: dict = {}
    legs_s: dict = {}
    batched_roots_kernel.reset()  # the replica paths fold their trees with torch ops
    for store in ("hash", None):
        t1 = time.perf_counter()
        out[f"13a_{store or 'binned'}"] = registry_leg(store, device_name, device)
        legs_s[f"13a_{store or 'binned'}"] = time.perf_counter() - t1
    # 13c's subprocesses start up and run beside 13b (13a's timings are
    # taken without them)
    started = start_examples()
    try:
        for seed, store, pin in SOAK_RUNS:
            t1 = time.perf_counter()
            out[f"13b_{seed}"] = soak_on_card(SOAK_REPLICAS, SOAK_OPS, seed, store, pin, device_name, t_start, device)
            legs_s[f"13b_{seed}"] = time.perf_counter() - t1
    except BaseException:
        stop_examples(started)
        raise
    t1 = time.perf_counter()
    out["13c"] = finish_examples(started, device_name)
    legs_s["13c_wait_after_13b"] = time.perf_counter() - t1
    out["roots_launches"] = batched_roots_kernel.launches
    if out["roots_launches"]:
        raise AssertionError(f"the roots kernel was launched {out['roots_launches']} times in phase 13")
    reg = out["13a_hash"]
    out["launches"] = reg["launches"]
    out["launches_by_shape"] = reg["launches_by_shape"]
    out["table_max_abs_err"] = reg["table_max_abs_err"]
    out["phase_s"] = time.perf_counter() - t0
    out["legs_s"] = legs_s
    log(f"[registry] phase 13 {out['phase_s']:.3f} s (by leg {json.dumps({k: round(v, 3) for k, v in legs_s.items()})}); "
        f"probe launches on the registry path {out['launches']} on {device_name}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=1 << 20,
                    help="keys loaded in phases 3b and 8a; phases 3 and 8b load an eighth")
    ap.add_argument("--only", default="", help="run only phase 1 and these phases (e.g. 7); prints no result")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import delta_crdt_ex_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2
    if Path(delta_crdt_ex_tpu_torch.__file__).resolve().parent.parent != here:
        print("chip_smoke: the imported port is not the one beside this script", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    name_power = gpu_name_power()
    kind = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"[env] card: {name_power}")
    phase_build()
    serve_b = lambda reps, t, want: serve_binned(reps, t, want, args.keys, name_power)
    serve_h = lambda reps, logs, want: serve_hash(reps, logs, want, args.keys // 8, name_power)
    if args.only:
        if "13" in args.only:
            log("[registry-metrics] " + json.dumps(phase_conformance(name_power, t_start)))
        if "12" in args.only:
            log("[mesh-metrics] " + json.dumps(phase_mesh(name_power)))
        if "11" in args.only:
            log("[tree-metrics] " + json.dumps(phase_tree(name_power)))
        if "10" in args.only:
            m = phase_slice(args.keys // 8, serve=serve_h)
            b = phase_binned(args.keys, name_power, serve=serve_b)
            log("[serve-metrics] " + json.dumps({"10a": b.pop("serve"), "10b": m.pop("serve"),
                                                 "10c": serve_fleet(name_power)}))
        if "3b" in args.only:
            log("[binned-metrics] " + json.dumps(phase_binned(args.keys, name_power)))
        if "4" in args.only:
            phase_cuda_vs_cpu()
        if "5" in args.only:
            f = phase_fanin(name_power)
            fp = phase_fanin_packed(name_power, f.pop("prior"))
            f.pop("base")
            log("[fanin-metrics] " + json.dumps(f))
            log("[fanin-packed-metrics] " + json.dumps(fp))
        if "7" in args.only:
            reserve = (DURABILITY_RESERVE_S if "8" in args.only else 0.0) + (
                TCP_RESERVE_S if "9" in args.only else 0.0) + (TREE_RESERVE_S if "11" in args.only else 0.0)
            log("[fleet-metrics] " + json.dumps(phase_fleet(name_power, t_start, reserve_s=reserve)))
        if "8" in args.only:
            log("[durability-metrics] " + json.dumps(phase_durability(name_power)))
        if "9" in args.only:
            log("[tcp-metrics] " + json.dumps(phase_tcp(name_power, t_start, keys=args.keys, hash_keys=args.keys // 8)))
        log(f"[env] total {time.perf_counter() - t_start:.3f} s (phases 1 and {args.only} only)")
        return 0
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    probe_err = phase_kernel_vs_plain()
    roots_err = phase_roots_vs_plain()
    timed = kernel_timings(name_power)
    probe = kernel_row(probe_lookup_kernel, probe_err, timed["probe"])
    roots = kernel_row(batched_roots_kernel, roots_err, timed["roots"])
    phase_t = {"1-2": time.perf_counter() - t_start}
    t_phase = time.perf_counter()
    # phase 3 runs at an eighth of the key count (2^17 by default) so
    # that the whole run, phase 8 included, stays inside its time limit;
    # phases 10b and 10a serve from the loaded pairs of 3 and 3b
    m = phase_slice(args.keys // 8, serve=serve_h)
    sv = {"10b": m.pop("serve")}
    phase_t["3"] = time.perf_counter() - t_phase - sv["10b"]["leg_s"]
    log("[slice-metrics] " + json.dumps(m))
    t_phase = time.perf_counter()
    b = phase_binned(args.keys, name_power, serve=serve_b)
    sv["10a"] = b.pop("serve")
    phase_t["3b"] = time.perf_counter() - t_phase - sv["10a"]["leg_s"]
    log("[binned-metrics] " + json.dumps(b))
    sv["10c"] = serve_fleet(name_power)
    phase_t["10"] = sv["10a"]["leg_s"] + sv["10b"]["leg_s"] + sv["10c"]["leg_s"]
    log("[serve-metrics] " + json.dumps(sv))
    probe["max_abs_err"] = max(probe["max_abs_err"], m["table_max_abs_err"])
    t_phase = time.perf_counter()
    phase_cuda_vs_cpu()
    phase_t["4"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    f = phase_fanin(name_power)
    phase_t["5"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    fp = phase_fanin_packed(name_power, f.pop("prior"))
    phase_t["5p"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    base = f.pop("base")
    g = phase_ring_gossip(base)
    phase_t["6"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    ms = phase_mesh(name_power, base=base)
    del base
    phase_t["12"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    cf = phase_conformance(name_power, t_start)
    phase_t["13"] = time.perf_counter() - t_phase
    log("[fanin-metrics] " + json.dumps(f))
    log("[fanin-packed-metrics] " + json.dumps(fp))
    log(f"[fanin-layouts] merges/s columns {f['merges_per_sec']:.3f}, packed_scomp "
        f"{fp['packed_scomp']['merges_per_sec']:.3f}, packed_topk {fp['packed_topk']['merges_per_sec']:.3f}; "
        f"entry stack bytes {f['stack_bytes']} against {fp['packed_scomp']['stack_bytes']}; peak memory "
        f"{f['peak_mem_bytes']}, {fp['packed_scomp']['peak_mem_bytes']}, {fp['packed_topk']['peak_mem_bytes']} B "
        f"on {name_power}")
    log("[gossip-metrics] " + json.dumps(g))
    log("[mesh-metrics] " + json.dumps(ms))
    log("[registry-metrics] " + json.dumps(cf))
    t_phase = time.perf_counter()
    fl = phase_fleet(name_power, t_start, reserve_s=DURABILITY_RESERVE_S + TCP_RESERVE_S + TREE_RESERVE_S)
    phase_t["7"] = time.perf_counter() - t_phase
    log("[fleet-metrics] " + json.dumps(fl))
    t_phase = time.perf_counter()
    du = phase_durability(name_power, keys=args.keys, hash_keys=args.keys // 8, t_start=t_start)
    phase_t["8"] = time.perf_counter() - t_phase
    log("[durability-metrics] " + json.dumps(du))
    t_phase = time.perf_counter()
    tc = phase_tcp(name_power, t_start, keys=args.keys, hash_keys=args.keys // 8)
    phase_t["9"] = time.perf_counter() - t_phase
    log("[tcp-metrics] " + json.dumps(tc))
    t_phase = time.perf_counter()
    tr = phase_tree(name_power, flat_wire=tc["9c"]["wire_a"], t_start=t_start)
    phase_t["11"] = time.perf_counter() - t_phase
    log("[tree-metrics] " + json.dumps(tr))
    fleet_256 = fl.get("ingress_binned_256", {}).get("fleet_merges_per_sec")
    log(f"[durability] beside the runs without a WAL: 8a load_wal_s {du['8a']['load_wal_s']:.3f} s against 3b's "
        f"load_s {b['load_s']:.3f} s; 8c {du['8c']['fleet_wal_merges_per_sec']:.3f} merges/s against 7a's N=256 "
        f"{fleet_256} on {name_power}")
    log("[env] seconds by phase " + json.dumps({k: round(v, 3) for k, v in phase_t.items()}))
    # each hash-store path's launches were held against the plain
    # version on its own tables at the Q it launched at
    probe["max_abs_err"] = max(probe["max_abs_err"], du["8b"]["table_max_abs_err"], tc["9b"]["table_max_abs_err"],
                               sv["10b"]["table_max_abs_err"], tr["11b"]["table_max_abs_err"], ms["table_max_abs_err"],
                               cf["table_max_abs_err"])
    probe["launches_by_path"] = {"slice": m["launches"], "fleet": fl["launches"][probe_lookup_kernel.name],
                                 "durability_hash": du["8b"]["probe_launches"],
                                 "tcp_hash": tc["9b"]["launches"][probe_lookup_kernel.name],
                                 "tcp_fleet": tc["9c"]["launches"][probe_lookup_kernel.name],
                                 "serve_hash": sv["10b"]["launches"],
                                 "serve_binned": sv["10a"]["launches"][probe_lookup_kernel.name],
                                 "serve_fleet": sv["10c"]["launches"][probe_lookup_kernel.name],
                                 "tree_binned": tr["11a"]["launches"][probe_lookup_kernel.name],
                                 "tree_hash": tr["11b"]["launches"],
                                 "mesh_hash": ms["launches"][probe_lookup_kernel.name],
                                 "registry": cf["launches"]}
    probe["launches"] = sum(probe["launches_by_path"].values())
    # the replica paths' launches by the exact shape they ran at, each
    # row's launches and loss from its own shape: the headline rows take
    # the launches at theirs (the hitting row only), every other shape a
    # path ran at gets a row of its own, timed now
    by_shape: dict = dict(m["launches_by_shape"])
    for when in ("launches_before_crash", "launches_during_recovery", "launches_after_recovery"):
        for k, n in du["8b"][when]["probe_by_shape"].items():
            by_shape[k] = by_shape.get(k, 0) + n
    for k, n in (list(tc["9b"]["probe_by_shape"].items()) + list(sv["10b"]["launches_by_shape"].items())
                 + list(tr["11b"]["probe_by_shape"].items()) + list(ms["probe_by_shape"].items())
                 + list(cf["launches_by_shape"].items())):
        by_shape[k] = by_shape.get(k, 0) + n
    head_keys = set()
    for row in probe["shapes"]:
        sh = row["shape"]
        k = f"{sh['H']}x{sh['W']}x{sh['Q']}"
        row["launches"] = by_shape.get(k, 0) if sh["hits"] > 0 else 0
        head_keys.add(k)
    probe["shapes"] += path_probe_rows(name_power, by_shape, head_keys)
    if sum(row["launches"] for row in probe["shapes"]) != sum(by_shape.values()):
        raise AssertionError(f"probe launches by shape {by_shape} are not all in the timed rows")
    fanin_runs = [f, fp["packed_scomp"], fp["packed_topk"]]
    roots["launches"] = sum(x["launches"] for x in fanin_runs)  # the fan-in's, every layout
    roots["launches_by_path"] = {"fanin": f["launches"], "fanin_packed_scomp": fp["packed_scomp"]["launches"],
                                 "fanin_packed_topk": fp["packed_topk"]["launches"], "gossip": g["launches"],
                                 "fleet": fl["launches"][batched_roots_kernel.name], "durability": 0, "tcp": 0,
                                 "serve": 0, "tree": tr["11a"]["launches"][batched_roots_kernel.name],
                                 "mesh": ms["launches"][batched_roots_kernel.name],
                                 "registry": cf["roots_launches"]}
    roots["max_abs_err"] = max([roots["max_abs_err"]] + [x["roots_max_abs_err"] for x in fanin_runs])
    for row in roots["shapes"]:
        k = f"{row['shape']['N']}x{row['shape']['L']}"
        row["launches"] = sum(x["launches_by_shape"].get(k, 0) for x in fanin_runs + [g])
    for kern in (probe, roots):
        loss = [(row["shape"], row["launches"], row["launches"] * (row["kernel_ms"] - row["bound_ms"]))
                for row in kern["shapes"]]
        log(f"[kernel-loss] {kern['name']}: launches x (kernel_ms - bound_ms) by timed shape "
            f"{[(sh, n, round(x, 6)) for sh, n, x in loss]}, sum {sum(x for _, _, x in loss):.6f} ms")
    log(f"[env] total {time.perf_counter() - t_start:.3f} s")
    print(name_power, flush=True)
    print(json.dumps({"kernels": [probe, roots]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
