#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``delta_crdt_ex_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run: phases 1-9
    python3 chip_smoke.py --keys 131072   # phases 3, 3b, 8a, 8b, 9a and 9b at a cut key count
    python3 chip_smoke.py --only 7        # the build and phase 7 alone (no result lines)
    python3 chip_smoke.py --only 8        # the build and phase 8 alone (no result lines)
    python3 chip_smoke.py --only 9        # the build and phase 9 alone (no result lines)

Phases (each raises on failure; any failure exits nonzero):

1. build the port's CUDA kernels from ``delta_crdt_ex_tpu_torch/csrc/``
   (one ``nvcc`` per source, started together) and print each one's
   ptxas lines, the card's name and its power limit;
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
   none, as in the JAX package);
4. small deterministic scripts (``threaded=False``, ``LogicalClock``)
   on ``cuda`` and on ``cpu`` give identical ``canonical_state_bytes()``,
   diff feeds and ``stats()["ingress"]``: an ``AWLWWMap`` pair on the
   hash store and on the default store and an ``AWSet`` pair, each with
   subscribers, three senders coalescing into one receiver, and a
   4-member fleet on each store (two senders a member, a gap mid-group,
   fleet counters too); the
   fan-in of phase 5 at ``bench.py``'s smoke geometry (4096 keys,
   L = 2^8, B = 64, 4 neighbours, 4 × 128-entry deltas per call, 1 + 2
   calls) gives identical stack columns and roots on both;
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
6. ring gossip: 8 lanes of that geometry, each first given its own
   writer's 4096 fresh keys by ``merge_into``, then 7
   ``ring_gossip_round``s, each followed by the roots; every root and
   every leaf equal at the end, and every lane's content (alive entries
   and context over global writer ids) equal;
7. fleets, ``bench.py --fleet``'s legs on the card (members of 64
   buckets, capacity 1024, ``LogicalClock``, 4 fresh keys a sender a
   round, 1 warm-up + 5 timed rounds): the ingress leg (n senders each
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
   geometry, 2^20 keys loaded into replica 1 (1024 ``batch`` records, a
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
    from delta_crdt_ex_tpu_torch.utils import kernels

    t0 = time.perf_counter()
    built = kernels.build_all(verbose=True)
    for name, (path, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build]   {name}: {line.strip()}")
        log(f"[build] {name}: {path.name}")
    log(f"[build] {len(built)} kernels built in {time.perf_counter() - t0:.3f} s")


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


def kernel_us(fn, flush, name: str, reps: int = 10) -> float:
    """Mean duration of the device kernels whose name holds ``name`` over
    ``reps`` calls of ``fn()`` (``flush()`` between them), as
    ``torch.profiler`` (CUPTI) records them: the kernel alone, without
    the launch and event overhead that :func:`time_ms` includes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiling window now and then comes back without the kernel's
    # record (seen once at (2^22, 32, 8) on the H100 with torch 2.11);
    # such a window is profiled again, at most twice more
    for window in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.device_time_total for e in hits) / count
        log(f"[kernel-time] profiling window {window + 1} recorded no {name} kernel")
    raise AssertionError(f"the profiler recorded no {name} kernel in 3 windows")


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
        row = {"kernel_ms": kernel_us(fn, flush, name) / 1e3, "plain_ms": time_ms(plain, plain_reps, flush)[0]}
        if head:
            row["ms"], row["host_ms"] = time_ms(fn, 20, flush)
        return row

    def show(row: dict) -> str:
        ev = f" ({row['ms']:.6f} ms by events, host enqueue {row['host_ms']:.6f} ms)" if "ms" in row else ""
        return (f"kernel {row['kernel_ms']:.6f} ms{ev}, plain {row['plain_ms']:.6f} ms, bound "
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


def check_main_tables(reps, n_keys: int, removed: list, extra: list = (), q_sizes=()) -> int:
    """The probe kernel against ``probe_lookup_ref`` on each replica's
    own final table: queries are every written key (``key0``… and
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
                    f"{r.name}: probe kernel disagrees with probe_lookup_ref on the main "
                    f"path's table at Q={len(hashes)}: rows {bad.tolist()}: kernel {got[bad].tolist()} "
                    f"plain {want[bad].tolist()}"
                )
            if g:
                continue
            found = int(want[: len(terms), 0].sum()), int(want[len(terms):, 0].sum())
            if found != (len(terms) - len(removed), 0):
                raise AssertionError(f"{r.name}: probe grid found {found}, want ({len(terms) - len(removed)}, 0)")
        log(f"[slice] {r.name}: kernel vs plain on the main path's table (H={st.table_size} "
            f"W={st.probe_window}) at Q={[len(h) for h in grids]}: bit-equal, the first grid found "
            f"{found[0]} written + {found[1]} missing, max_abs_err 0")
    return max_err


def phase_slice(n_keys: int, device: str = "cuda") -> dict:
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


def phase_binned(n_keys: int, device_name: str, device: str = "cuda") -> dict:
    import dataclasses

    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel
    from delta_crdt_ex_tpu_torch.runtime import telemetry
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

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
    m: dict = {"keys": n_keys, "buckets": r1.num_buckets, "bin_capacity": r1.state.bin_capacity}
    try:
        dc.set_neighbours(r1, [r2])
        dc.set_neighbours(r2, [r1])
        probe_lookup_kernel.reset()  # this path's run starts here: it launches neither kernel
        batched_roots_kernel.reset()

        t0 = time.perf_counter()
        dc.mutate_batch(r1, "add", [[f"key{i}", i] for i in range(n_keys)], timeout=SLICE_BUDGET_S)
        m["load_s"] = time.perf_counter() - t0
        m["converge_s"] = arrivals.wait(n_keys, deadline, f"{n_keys} keys on replica 2") - t0
        log(f"[binned] {n_keys} keys (L={r1.num_buckets} B={r1.state.bin_capacity}): mutate_batch "
            f"{m['load_s']:.3f} s, on replica 2 after {m['converge_s']:.3f} s on {device_name}")

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


# ---------------------------------------------------------------------------
# phases 5-6: the fan-in (bench.py's north star, column layout)

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


def run_fanin(geo: dict, device: str, keep_states: bool = False) -> dict:
    """``bench.py``'s fan-in on ``device``: a single-writer state over
    ``geo["keys"]`` seeded keys broadcast to N neighbours, then
    warm-up + timed calls, each one ``fanout_merge`` of a group of
    interval deltas from a second writer and the stack's roots. The
    timed calls are enqueued back to back and stamped as each one
    completes, as ``bench.py`` does; on ``cuda`` the stamps are CUDA
    events recorded after each call (the host stamps of ``bench.py``
    would collapse here, because enqueueing a call takes the host most
    of a call's device time). Returns the final stack, each call's
    results, the per-call completion intervals and host enqueue times,
    and the host copies of the keys."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots, batched_roots_kernel
    from delta_crdt_ex_tpu_torch.parallel.batched_sync import fanout_merge, stack_states
    from delta_crdt_ex_tpu_torch.utils.synth import build_state, interval_delta_stream

    L, n_calls = geo["L"], geo["warmup"] + geo["calls"]
    rng = np.random.default_rng(0)  # bench.py make_workload(seed=0)
    keys = rng.integers(1, 1 << 63, size=geo["keys"], dtype=np.uint64)
    if len(np.unique(keys)) != len(keys):
        raise AssertionError("seeded keys are not distinct")
    t0 = time.perf_counter()
    one, _ = build_state(11, keys, L, geo["B"], geo["R"], device=device)
    stack = stack_states([one] * geo["N"])
    next_ctr, slices = None, []
    for _ in range(n_calls + 1):  # the last one is the traced call's
        (sl,), next_ctr = interval_delta_stream(
            22, rng, 1, geo["group"] * geo["delta"], L, next_ctr=next_ctr,
            bin_width=geo["bin_width"], device=device,
        )
        slices.append(sl)
    spare = slices.pop()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    setup_bytes = torch.cuda.memory_allocated() if cuda else 0
    delta_keys = np.concatenate([s.key[s.alive].cpu().numpy() for s in slices]).view(np.uint64)

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
        res = fanout_merge(stack, sl, 8, geo["group"] * geo["delta"])
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
        "launches_by_shape": by_shape,
        "setup_s": setup_s, "setup_bytes": setup_bytes,
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
    return m


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


def phase_ring_gossip(base) -> dict:
    import torch

    from delta_crdt_ex_tpu_torch.models.binned_map import merge_into
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots, batched_roots_kernel
    from delta_crdt_ex_tpu_torch.parallel.batched_sync import ring_gossip_round, stack_states
    from delta_crdt_ex_tpu_torch.utils.synth import interval_delta_stream

    n, fresh = 8, 4096
    L = base.num_buckets
    rng = np.random.default_rng(6)
    base = base.grow(replica_capacity=16)  # the base writer + 8 lane writers
    lanes = []
    for i in range(n):
        (sl,), _ = interval_delta_stream(100 + i, rng, 1, fresh, L, bin_width=8, device="cuda")
        lane, res = merge_into(base, sl, n_alive=fresh)
        if int(res.n_inserted) != fresh:
            raise AssertionError(f"lane {i}: merge_into inserted {int(res.n_inserted)}, want {fresh}")
        lanes.append(lane)
    stack = stack_states(lanes)
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
#: sender a round, 1 warm-up and 5 timed rounds
FLEET_DEPTH = 6
FLEET_KEYS_PER_ROUND = 4
FLEET_ROUNDS = 5


class _Sink:
    """Mailbox-only receiver of the egress leg: registered so sends route
    and monitors succeed, it handles nothing."""


def fleet_universe(n: int, store, device: str, tag: str, egress: bool):
    """``bench.py``'s fleet topology on ``device``: n fleet members and n
    solo twins with pairwise-equal node ids (``LogicalClock``); the
    ingress leg adds n senders, each pushing to its member and its twin,
    the egress leg a sink neighbour for every member and twin."""
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
    return t, dc.Fleet(members), solos, senders


def state_nbytes(state) -> int:
    import dataclasses

    import torch

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


def fleet_ingress(n: int, store, device_name: str, device: str = "cuda") -> dict:
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
    leg = f"ingress {store or 'binned'} N={n}"
    t0 = time.perf_counter()
    t, fleet, solos, senders = fleet_universe(n, store, device, f"fi{store or 'b'}{n}", egress=False)
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mem = FleetMemory(leg, cuda)
    dts: dict = {"fleet": [], "solo": []}
    disp: list = []
    trace = None
    for rnd in range(FLEET_ROUNDS + 2):  # round 0 warms up; the last one is traced
        base = 1_000_003 * rnd
        for i, s in enumerate(senders):
            s.mutate_batch("add", [[base + i * 1000 + j, base + i * 1000 + j] for j in range(FLEET_KEYS_PER_ROUND)])
        for s in senders:
            s.sync_to_all()
        for r in fleet.replicas:
            if _entries_to(t, r.addr) < 1:
                raise AssertionError(f"{leg}: member {r.name} got no entries")
        d0 = fleet.stats()["dispatches"]
        if rnd == FLEET_ROUNDS + 1:
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
        if 0 < rnd <= FLEET_ROUNDS:
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
        f"(median of {FLEET_ROUNDS} rounds; speedup {m['speedup']:.3f}); fleet round ms "
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
#: only if the run would otherwise pass it (a run must end within 1200 s)
RUN_GUARD_S = 1000.0


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


def phase_durability(device_name: str, keys: int = DURABILITY_KEYS, hash_keys: int = DURABILITY_HASH_KEYS,
                     fleet_n: int = DURABILITY_FLEET_N, device: str = "cuda") -> dict:
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    t0 = time.perf_counter()
    out = {"8a": durability_leg("dura", None, keys, device_name, device)}
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
    if keys > TCP_CUT_KEYS and spent + TCP_RESERVE_S + TCP_FULL_9A_EXTRA_S > RUN_GUARD_S:
        note = f", cut from {keys}: {spent:.3f} s spent when phase 9 began"
        log(f"[cut] phase 9a keys {keys} -> {TCP_CUT_KEYS}: {spent:.3f} s so far, about "
            f"{TCP_RESERVE_S + TCP_FULL_9A_EXTRA_S:.0f} s to go at {keys}, past the {RUN_GUARD_S:.0f} s guard")
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
    if args.only:
        if "4" in args.only:
            phase_cuda_vs_cpu()
        if "7" in args.only:
            reserve = (DURABILITY_RESERVE_S if "8" in args.only else 0.0) + (
                TCP_RESERVE_S if "9" in args.only else 0.0)
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
    # that the whole run, phase 8 included, stays inside its time limit
    m = phase_slice(args.keys // 8)
    phase_t["3"] = time.perf_counter() - t_phase
    log("[slice-metrics] " + json.dumps(m))
    t_phase = time.perf_counter()
    b = phase_binned(args.keys, name_power)
    phase_t["3b"] = time.perf_counter() - t_phase
    log("[binned-metrics] " + json.dumps(b))
    probe["max_abs_err"] = max(probe["max_abs_err"], m["table_max_abs_err"])
    t_phase = time.perf_counter()
    phase_cuda_vs_cpu()
    phase_t["4"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    f = phase_fanin(name_power)
    g = phase_ring_gossip(f.pop("base"))
    phase_t["5-6"] = time.perf_counter() - t_phase
    log("[fanin-metrics] " + json.dumps(f))
    log("[gossip-metrics] " + json.dumps(g))
    t_phase = time.perf_counter()
    fl = phase_fleet(name_power, t_start, reserve_s=DURABILITY_RESERVE_S + TCP_RESERVE_S)
    phase_t["7"] = time.perf_counter() - t_phase
    log("[fleet-metrics] " + json.dumps(fl))
    t_phase = time.perf_counter()
    du = phase_durability(name_power, keys=args.keys, hash_keys=args.keys // 8)
    phase_t["8"] = time.perf_counter() - t_phase
    log("[durability-metrics] " + json.dumps(du))
    t_phase = time.perf_counter()
    tc = phase_tcp(name_power, t_start, keys=args.keys, hash_keys=args.keys // 8)
    phase_t["9"] = time.perf_counter() - t_phase
    log("[tcp-metrics] " + json.dumps(tc))
    fleet_256 = fl.get("ingress_binned_256", {}).get("fleet_merges_per_sec")
    log(f"[durability] beside the runs without a WAL: 8a load_wal_s {du['8a']['load_wal_s']:.3f} s against 3b's "
        f"load_s {b['load_s']:.3f} s; 8c {du['8c']['fleet_wal_merges_per_sec']:.3f} merges/s against 7a's N=256 "
        f"{fleet_256} on {name_power}")
    log("[env] seconds by phase " + json.dumps({k: round(v, 3) for k, v in phase_t.items()}))
    # each hash-store path's launches were held against the plain
    # version on its own tables at the Q it launched at
    probe["max_abs_err"] = max(probe["max_abs_err"], du["8b"]["table_max_abs_err"], tc["9b"]["table_max_abs_err"])
    probe["launches_by_path"] = {"slice": m["launches"], "fleet": fl["launches"][probe_lookup_kernel.name],
                                 "durability_hash": du["8b"]["probe_launches"],
                                 "tcp_hash": tc["9b"]["launches"][probe_lookup_kernel.name],
                                 "tcp_fleet": tc["9c"]["launches"][probe_lookup_kernel.name]}
    probe["launches"] = sum(probe["launches_by_path"].values())
    # the replica paths' launches by the exact shape they ran at, each
    # row's launches and loss from its own shape: the headline rows take
    # the launches at theirs (the hitting row only), every other shape a
    # path ran at gets a row of its own, timed now
    by_shape: dict = dict(m["launches_by_shape"])
    for when in ("launches_before_crash", "launches_during_recovery", "launches_after_recovery"):
        for k, n in du["8b"][when]["probe_by_shape"].items():
            by_shape[k] = by_shape.get(k, 0) + n
    for k, n in tc["9b"]["probe_by_shape"].items():
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
    roots["launches"] = f["launches"]  # the fan-in's, as in earlier lines
    roots["launches_by_path"] = {"fanin": f["launches"], "gossip": g["launches"],
                                 "fleet": fl["launches"][batched_roots_kernel.name], "durability": 0, "tcp": 0}
    roots["max_abs_err"] = max(roots["max_abs_err"], f["roots_max_abs_err"])
    for row in roots["shapes"]:
        k = f"{row['shape']['N']}x{row['shape']['L']}"
        row["launches"] = f["launches_by_shape"].get(k, 0) + g["launches_by_shape"].get(k, 0)
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
