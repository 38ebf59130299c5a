#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``delta_crdt_ex_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run: phases 1-7
    python3 chip_smoke.py --keys 131072   # phases 3 and 3b at a cut key count
    python3 chip_smoke.py --only 7        # the build and phase 7 alone (no result lines)

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
   its memory bound at the main paths' shapes (``PROBE_TIMED``,
   ``ROOTS_TIMED``), and its time by CUDA events at the first of them,
   the headline of the ``kernels`` line;
3. the slice at full size: two threaded replicas on ``cuda``
   (``store="hash"``, sync_interval 20 ms, max_sync_size 500, an
   ``on_diffs`` subscriber each) — ``mutate_batch`` of ``--keys`` keys
   into replica 1 until replica 2 holds them all, 10 single-op
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
   N = 256 and 1024 and on the hash store at N = 64, one more drain
   traced; the egress leg (``fleet.sync_tick()`` against the twins'
   ``sync_to_all()``, sink neighbours) at N = 256 binned and N = 64
   hash. ``[fleet]`` lines give merges/s or member syncs/s, round times,
   dispatches, occupancy, fill, fallbacks and stack-cache hits,
   ``[fleet-mem]`` lines the device memory after each round. It raises
   on any fleet/solo difference (state columns, canonical bytes, seqs,
   outbound messages), on state off the card, on memory that grows
   round over round by more than one batch, and on a kernel launch.

Metrics print on their own lines, then each kernel's launches ×
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


#: probe timing shapes (H, W, Q, share of queries that hit); the first is
#: the headline of the ``kernels`` line, its shape since the kernel was
#: ported: 2^20 queries on a 2^21-lane table; then the same with every
#: query missing (so only the windows are read), then each wire tier the
#: replica path launches on its 2^22-lane tables (8 = one op, 512 and
#: 2048 = a mutation batch, 8192 = a 4096-key read_keys)
PROBE_TIMED = [(1 << 21, 32, 1 << 20, 0.75), (1 << 21, 32, 1 << 20, 0.0)] + [
    (1 << 22, 32, q, 0.75) for q in (8, 512, 2048, 8192)
]
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


def kernel_timings(device_name: str) -> dict:
    """Each kernel's duration by the profiler at every shape of
    :data:`PROBE_TIMED` and :data:`ROOTS_TIMED` (L2 flushed between
    calls), beside its plain version's time and its byte bound; at the
    first (headline) shape also its time by CUDA events (:func:`time_ms`),
    the method of the ``ms`` of earlier ``kernels`` lines."""
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
    for i, (H, W, Q, hit) in enumerate(PROBE_TIMED):
        if (H, W) not in tables:
            tables[(H, W)] = seeded_table(H, W, H // 8, seed=H * 7 + W, device=dev)
        st, keys = tables[(H, W)]
        qk = queries(keys, Q, seed=99, hit=hit)
        row = {"shape": {"H": H, "W": W, "Q": Q, "hits": hit}}
        row.update(timed(lambda: probe_lookup_kernel(qk, st), lambda: probe_lookup_ref(qk, st),
                         "probe_lookup", i == 0, 5 if Q > 8192 else 20))
        nbytes = probe_bound_bytes(qk, st)
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[kernel-time] probe_lookup H={H} W={W} Q={Q} hits {hit} (L2 flushed between calls, bound "
            f"{nbytes} B at 3.35 TB/s): {show(row)}")
        rows["probe"].append(row)
    del tables
    for i, (n, L) in enumerate(ROOTS_TIMED):
        leaf = random_leaves(n, L, seed=7 + n)
        row = {"shape": {"N": n, "L": L}}
        row.update(timed(lambda: batched_roots_kernel(leaf), lambda: batched_roots_ref(leaf),
                         "batched_roots", i == 0, 20))
        row["bound_ms"] = roots_bound_ms(n, L)
        log(f"[kernel-time] batched_roots N={n} L={L} (L2 flushed between calls, bound "
            f"{n * L * 8 + n * 8} B at 3.35 TB/s): {show(row)}")
        rows["roots"].append(row)
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


def check_main_tables(reps, n_keys: int, removed: list) -> int:
    """The probe kernel against ``probe_lookup_ref`` on each replica's
    own final table: queries are every written key (removed ones
    included) and 4096 missing keys; the whole grid must be bit-equal
    and find exactly the keys still present. Returns the max abs error."""
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.utils.hashing import key_hash64_batch

    written = np.asarray(key_hash64_batch([f"key{i}" for i in range(n_keys)]), np.uint64)
    miss = np.random.default_rng(17).integers(0, 2**63, 4096, dtype=np.int64).view(np.uint64) | np.uint64(1 << 63)
    hashes = np.concatenate([written, miss]).view(np.int64)
    max_err = 0
    for r in reps:
        with r._lock:
            st = r.state
        qk = torch.from_numpy(hashes.copy()).to(st.key.device)
        got = probe_lookup_kernel(qk, st)
        want = ref_chunked(qk, st)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        found = int(want[:n_keys, 0].sum()), int(want[n_keys:, 0].sum())
        log(f"[slice] {r.name}: kernel vs plain on the main path's table (H={st.table_size} "
            f"W={st.probe_window} Q={len(hashes)}): found {found[0]} written + {found[1]} "
            f"missing, max_abs_err {err}")
        if err != 0:
            bad = torch.nonzero((got != want).any(dim=1))[:4, 0]
            raise AssertionError(
                f"{r.name}: probe kernel disagrees with probe_lookup_ref on the main "
                f"path's table: rows {bad.tolist()}: kernel {got[bad].tolist()} "
                f"plain {want[bad].tolist()}"
            )
        if found != (n_keys - len(removed), 0):
            raise AssertionError(f"{r.name}: probe grid found {found}, want ({n_keys - len(removed)}, 0)")
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
        metrics["launches_by_q"] = {str(q): n for q, n in sorted(probe_lookup_kernel.launches_by_shape.items())}
        if metrics["launches"] <= 0:
            raise AssertionError("the probe kernel was not launched on the main path")
        metrics["canonical_bytes"] = len(c1)
        log(f"[slice] canonical bytes equal ({len(c1)} B); table {r1.state.table_size} lanes; "
            f"probe kernel launches on the main path: {metrics['launches']}, by Q "
            f"{metrics['launches_by_q']}")
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

        lat = []
        for i in range(10):
            base = arrivals.total
            t1 = time.perf_counter()
            dc.mutate(r1, "add", [f"prop{i}", i])
            lat.append(arrivals.wait(base + 1, deadline, f"prop{i}") - t1)
        m["propagation_ms"] = [x * 1e3 for x in lat]
        log(f"[binned] 10 single-op propagations (ms): {[round(x * 1e3, 3) for x in lat]} median "
            f"{float(np.median(lat)) * 1e3:.3f} on {device_name}")

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


#: the whole run's time target, seconds (a run must end within 1200)
RUN_TARGET_S = 900.0


def phase_fleet(device_name: str, t_start: float, legs=FLEET_LEGS) -> dict:
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    probe_lookup_kernel.reset()  # this path's run starts here: it launches neither kernel
    batched_roots_kernel.reset()
    out: dict = {}
    per_member_s = 0.0
    for k, (leg, n, store) in enumerate(legs):
        if leg == "ingress" and per_member_s and n > 512:
            # the leg's time grows with N: if the rest of the run would
            # pass the target, this leg runs at 512 members
            rest = sum(m for lg, m, _ in legs[k:]) * per_member_s
            if time.perf_counter() - t_start + rest > RUN_TARGET_S:
                log(f"[cut] phase 7a ingress N={n} -> 512: {time.perf_counter() - t_start:.3f} s so far, "
                    f"about {rest:.3f} s to go at N={n}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=1 << 20, help="keys loaded in phases 3 and 3b")
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
            log("[fleet-metrics] " + json.dumps(phase_fleet(name_power, t_start)))
        log(f"[env] total {time.perf_counter() - t_start:.3f} s (phases 1 and {args.only} only)")
        return 0
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel
    from delta_crdt_ex_tpu_torch.ops.roots import batched_roots_kernel

    probe_err = phase_kernel_vs_plain()
    roots_err = phase_roots_vs_plain()
    timed = kernel_timings(name_power)
    probe = kernel_row(probe_lookup_kernel, probe_err, timed["probe"])
    roots = kernel_row(batched_roots_kernel, roots_err, timed["roots"])
    m = phase_slice(args.keys)
    log("[slice-metrics] " + json.dumps(m))
    b = phase_binned(args.keys, name_power)
    log("[binned-metrics] " + json.dumps(b))
    probe["launches"] = m["launches"]
    probe["max_abs_err"] = max(probe["max_abs_err"], m["table_max_abs_err"])
    for row in probe["shapes"]:  # the replica path's tables have m["table_size"] lanes
        sh = row["shape"]
        on_path = sh["H"] == m["table_size"] and sh["W"] == 32 and sh["hits"] > 0
        row["launches"] = m["launches_by_q"].get(str(sh["Q"]), 0) if on_path else 0
    phase_cuda_vs_cpu()
    f = phase_fanin(name_power)
    g = phase_ring_gossip(f.pop("base"))
    log("[fanin-metrics] " + json.dumps(f))
    log("[gossip-metrics] " + json.dumps(g))
    fl = phase_fleet(name_power, t_start)
    log("[fleet-metrics] " + json.dumps(fl))
    probe["launches_by_path"] = {"slice": m["launches"], "fleet": fl["launches"][probe_lookup_kernel.name]}
    roots["launches"] = f["launches"]  # the fan-in's, as in earlier lines
    roots["launches_by_path"] = {"fanin": f["launches"], "gossip": g["launches"],
                                 "fleet": fl["launches"][batched_roots_kernel.name]}
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
