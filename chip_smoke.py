#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``delta_crdt_ex_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py                 # the full run: phases 1-4
    python3 chip_smoke.py --keys 131072   # phase 3 at a cut key count

Phases (each raises on failure; any failure exits nonzero):

1. build the port's CUDA kernel from ``delta_crdt_ex_tpu_torch/csrc/``
   and print the card's name and power limit;
2. kernel vs plain version on the card: the probe-window lookup kernel
   against ``probe_lookup_ref`` on seeded tables (H ∈ {256, 2^21},
   W ∈ {8, 32, 128, 256}, Q ∈ {8, 2048, 4096, 2^20 − 3}; missing keys,
   end-of-table windows, dead lanes, several live dots of one key,
   top-bit keys and gids), the whole int32 grid bit-equal; then the
   kernel's time, the plain version's time and the memory bound;
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
4. a small deterministic script (``threaded=False``, ``LogicalClock``)
   on ``cuda`` and on ``cpu`` gives identical ``canonical_state_bytes()``.

Metrics print on their own lines; the line before the last is the
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
    path, out = kernels.build("probe", verbose=True)
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build]   {line.strip()}")
    log(f"[build] probe: {path.name} built in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain


def seeded_table(H: int, W: int, n_keys: int, seed: int, device):
    """A hash-store table with ``n_keys`` keys placed in their probe
    windows (1-3 live dots each, some dead copies), random garbage in
    the other lanes, and a writer table with top-bit gids. Returns
    ``(state, placed_keys int64)``."""
    import torch

    from delta_crdt_ex_tpu_torch.models.hash_store import HashStore
    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_base

    g = np.random.default_rng(seed)
    R = 8
    rnd_u64 = lambda n: torch.from_numpy(g.integers(0, 2**63, n, dtype=np.int64) ^ np.where(g.random(n) < 0.5, np.int64(-(2**63)), np.int64(0))).to(device)
    key = rnd_u64(H)
    alive = torch.from_numpy(g.random(H) < 0.3).to(device)
    node = torch.from_numpy(g.integers(0, R, H).astype(np.int32)).to(device)
    ctr = torch.from_numpy(g.integers(0, 2**32, H, dtype=np.int64)).to(device)
    ts = torch.from_numpy(g.integers(0, 4, H, dtype=np.int64)).to(device)  # few values: ties
    valh = torch.from_numpy(g.integers(0, 2**32, H, dtype=np.int64)).to(device)
    gid = np.array(
        [0xF000000000000001, 0x7000000000000001, 0xF000000000000002, 5,
         0x8000000000000000, 0xFFFFFFFFFFFFFFFF, 3, 0],
        dtype=np.uint64,
    )
    ctx_gid = torch.from_numpy(gid.view(np.int64).copy()).to(device)

    keys = rnd_u64(n_keys)
    # a share of the keys chosen so their windows run off the table end
    cand = rnd_u64(max(64 * n_keys // 16, 64))
    cb = probe_base(cand, H).to(torch.int64)
    tail = cand[cb + W > H][: n_keys // 16]
    keys = torch.cat([keys[: n_keys - len(tail)], tail])
    base = probe_base(keys, H).to(torch.int64)
    room = torch.clamp(H - base, max=W)
    for copy in range(3):
        take = torch.from_numpy(g.random(len(keys)) < (1.0, 0.5, 0.25)[copy]).to(device)
        off = torch.from_numpy(g.integers(0, 2**31, len(keys))).to(device) % room
        lane = (base + off)[take]
        key[lane] = keys[take]
        alive[lane] = torch.from_numpy(g.random(int(take.sum())) < 0.85).to(device)
    st = HashStore(
        key=key, valh=valh, ts=ts, node=node, ctr=ctr, alive=alive,
        ehash=torch.zeros_like(ctr), arr=torch.zeros_like(ctr),
        leaf=torch.zeros(16, dtype=torch.int64, device=device),
        rowseq=torch.zeros(16, dtype=torch.int64, device=device),
        ctx_gid=ctx_gid, ctx_max=torch.zeros((16, R), dtype=torch.int64, device=device),
        probe_window=W,
    )
    return st, keys


def queries(keys, Q: int, seed: int):
    """``Q`` query hashes: three quarters placed keys, the rest missing."""
    import torch

    g = np.random.default_rng(seed)
    n_hit = (3 * Q) // 4
    hit = keys[torch.from_numpy(g.integers(0, len(keys), n_hit)).to(keys.device)]
    miss = torch.from_numpy(g.integers(-(2**63), 2**63 - 1, Q - n_hit, dtype=np.int64)).to(keys.device)
    return torch.cat([hit, miss])[torch.from_numpy(g.permutation(Q)).to(keys.device)]


def ref_chunked(qk, st):
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_ref

    step = max(1, (1 << 24) // st.probe_window)
    return torch.cat([probe_lookup_ref(qk[i : i + step], st) for i in range(0, len(qk), step)])


def time_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of one ``fn()`` call over ``reps`` calls, by CUDA
    events around each call (``flush()`` runs between calls, untimed)."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


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


def phase_kernel_vs_plain(device_name: str) -> dict:
    import torch

    from delta_crdt_ex_tpu_torch.ops.hash_map import probe_lookup_kernel, probe_lookup_ref

    dev = torch.device("cuda")
    max_err = 0
    shapes = 0
    timing = None
    for H in (256, 1 << 21):
        for W in (8, 32, 128, 256):
            st, keys = seeded_table(H, W, max(H // 8, 16), seed=H * 7 + W, device=dev)
            for Q in (8, 2048, 4096, (1 << 20) - 3):
                qk = queries(keys, Q, seed=Q + W)
                got = probe_lookup_kernel(qk, st)
                want = ref_chunked(qk, st)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                max_err = max(max_err, err)
                found = int(want[:, 0].sum())
                log(f"[kernel] H={H} W={W} Q={Q}: found {found}/{Q}, max_abs_err {err}")
                if err != 0:
                    bad = torch.nonzero((got != want).any(dim=1))[:4, 0]
                    raise AssertionError(
                        f"probe kernel disagrees with probe_lookup_ref at H={H} W={W} "
                        f"Q={Q}: rows {bad.tolist()}: kernel {got[bad].tolist()} "
                        f"plain {want[bad].tolist()}"
                    )
                shapes += 1
            if H == 1 << 21 and W == 32:
                timing = (st, keys)
    # time at the issue's shape (H = 2^21, W = 32, Q = 2^20) and at the
    # main path's read shape (Q = 2048, the wire tier of a 1024-op batch)
    st, keys = timing
    scratch = torch.empty(1 << 27, dtype=torch.uint8, device=dev)  # 128 MiB > L2
    flush = lambda: scratch.random_(0, 255)
    out = {}
    for Q in (1 << 20, 2048):
        qk = queries(keys, Q, seed=99)
        kern = time_ms(lambda: probe_lookup_kernel(qk, st), 20, flush)
        plain = time_ms(lambda: probe_lookup_ref(qk, st), 5 if Q > 4096 else 20, flush)
        nbytes = probe_bound_bytes(qk, st)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(
            f"[kernel-time] probe_lookup H={st.table_size} W={st.probe_window} Q={Q} "
            f"(L2 flushed between calls): kernel {kern:.6f} ms, plain {plain:.6f} ms, "
            f"bound {bound:.6f} ms ({nbytes} B at 3.35 TB/s), kernel/bound "
            f"{kern / bound:.3f} on {device_name}"
        )
        out[Q] = (kern, plain, bound)
    kern, plain, bound = out[1 << 20]
    log(f"[kernel] {shapes} shapes bit-equal; max_abs_err {max_err}")
    probe_lookup_kernel.launches = 0  # comparison launches do not count
    return {
        "name": probe_lookup_kernel.name,
        "route": "cuda",
        "source": probe_lookup_kernel.source,
        "replaces": probe_lookup_kernel.replaces,
        "launches": 0,
        "max_abs_err": max_err,
        "ms": kern,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": "bytes",
        # no single PyTorch call computes the probe grid
        "library_ms": None,
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
        probe_lookup_kernel.launches = 0  # the main path's run starts here

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
        if metrics["launches"] <= 0:
            raise AssertionError("the probe kernel was not launched on the main path")
        metrics["canonical_bytes"] = len(c1)
        log(f"[slice] canonical bytes equal ({len(c1)} B); table {r1.state.table_size} lanes; "
            f"probe kernel launches on the main path: {metrics['launches']}")
        # launches below compare the kernel with its plain version and
        # are not the main path's
        metrics["table_max_abs_err"] = check_main_tables(reps, n_keys, removed)
        return metrics
    finally:
        for r in reps:
            r.stop()


# ---------------------------------------------------------------------------
# phase 4: cuda vs cpu on a deterministic script


def deterministic_script(device: str) -> bytes:
    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    t, c, feed = LocalTransport(), LogicalClock(), []
    rs = [
        dc.start_link(dc.AWLWWMap, store="hash", threaded=False, transport=t, clock=c,
                      name=f"det{i}", node_id=(0xF00000000000000B, 7)[i], capacity=64,
                      tree_depth=4, max_sync_size=8, on_diffs=feed.append, device=device,
                      sync_timeout=1e9)  # walk slots clear by message, not by the clock
        for i in range(2)
    ]
    rs[0].set_neighbours([rs[1]])
    rs[1].set_neighbours([rs[0]])
    g = np.random.default_rng(5)
    for step in range(10):
        rs[step % 2].mutate_batch(
            "add", [[f"k{int(x)}", int(g.integers(0, 1000))] for x in g.integers(0, 150, 40)]
        )
        for x in g.integers(0, 150, 5):
            rs[step % 2].mutate("remove", [f"k{int(x)}"])
        rs[0].mutate("add", ["hot", step])
        rs[1].mutate("add", ["hot", -step])
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
    return a + repr(feed).encode()


def phase_cuda_vs_cpu() -> None:
    a = deterministic_script("cuda")
    b = deterministic_script("cpu")
    if a != b:
        raise AssertionError("cuda and cpu runs of the deterministic script differ")
    log(f"[det] cuda and cpu canonical state + diff feed identical ({len(a)} B)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=1 << 20, help="keys loaded in phase 3")
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
    probe = phase_kernel_vs_plain(name_power)
    m = phase_slice(args.keys)
    log("[slice-metrics] " + json.dumps(m))
    probe["launches"] = m["launches"]
    probe["max_abs_err"] = max(probe["max_abs_err"], m["table_max_abs_err"])
    phase_cuda_vs_cpu()
    log(f"[env] total {time.perf_counter() - t_start:.3f} s")
    print(name_power, flush=True)
    print(json.dumps({"kernels": [probe]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
