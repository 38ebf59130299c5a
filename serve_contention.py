#!/usr/bin/env python3
"""Where a replica's front door waits while the replica gossips: a
measuring tool beside ``chip_smoke.py``, outside the port package.

    python3 serve_contention.py        # on a card (about 3 minutes)

Two threaded default-store replicas (sync_interval 20 ms, as phase 3b
of ``chip_smoke.py``) load 2^20 keys and converge; then both sync every
0.25 s (phase 10's serving interval) and 64 closed-loop clients write 40
fresh keys each through replica 1's front door, twice: with the peer
linked, and with both neighbour lists emptied. A sampler thread reads
every thread's stack every 2 ms during each flood and prints, per
thread (the clients, each replica's event loop, the admission worker),
its most frequent four-frame stacks with their share of the samples.
Last, ten 32-op ``apply_ops`` on replica 1 are timed directly (the
commit's own cost, no contention).
"""

import collections
import sys
import threading
import time

import numpy as np


def main() -> int:
    import torch

    import delta_crdt_ex_tpu_torch as dc
    from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

    if not torch.cuda.is_available():
        print("serve_contention: no CUDA device", file=sys.stderr)
        return 2
    n = 1 << 20
    t = LocalTransport()
    reps = [dc.start_link(dc.AWLWWMap, name=f"b{i}", transport=t, sync_interval=0.02, max_sync_size=500,
                          capacity=2 * n) for i in range(2)]
    r1, r2 = reps
    dc.set_neighbours(r1, [r2])
    dc.set_neighbours(r2, [r1])
    t0 = time.time()
    r1.mutate_batch("add", [[f"key{i}", i] for i in range(n)], timeout=600)
    while r1.canonical_state_bytes() != r2.canonical_state_bytes():
        time.sleep(0.5)
    print("loaded", time.time() - t0, flush=True)
    for r in reps:
        r.sync_interval = 0.25

    samples = collections.defaultdict(collections.Counter)
    stop = threading.Event()

    def sampler():
        names = {}
        while not stop.is_set():
            for th in threading.enumerate():
                names[th.ident] = th.name
            for ident, fr in sys._current_frames().items():
                nm = names.get(ident, "?")
                if not (nm.startswith("crdt") or nm.startswith("Thread")):
                    continue
                stack = []
                f = fr
                while f is not None and len(stack) < 4:
                    stack.append(f"{f.f_code.co_name}:{f.f_lineno}")
                    f = f.f_back
                key = nm if not nm.startswith("Thread") else "client"
                samples[key][" < ".join(stack)] += 1
            time.sleep(0.002)

    def flood(target, pools):
        ths = [threading.Thread(target=lambda p=p: [target(int(k)) for k in p]) for p in pools]
        t0 = time.perf_counter()
        [x.start() for x in ths]
        [x.join() for x in ths]
        return time.perf_counter() - t0

    rng = np.random.default_rng(7)
    fd = r1.frontdoor(max_commit_ops=256, max_pending_ops=1 << 30)
    C, P = 64, 40
    for label, setup in [("with peer", None), ("no peer", "unlink")]:
        if setup == "unlink":
            dc.set_neighbours(r1, [])
            dc.set_neighbours(r2, [])
            time.sleep(1.0)
        pools = [rng.integers(1, 1 << 62, size=P, dtype=np.uint64).tolist() for _ in range(C)]
        samples.clear()
        stop.clear()
        sth = threading.Thread(target=sampler, daemon=True)
        sth.start()
        c0 = fd.stats()["commits"]
        dt = flood(lambda k: fd.mutate("add", [k, k], timeout=600), pools)
        stop.set()
        sth.join()
        print(f"== {label}: grouped {C * P / dt:.1f} ops/s, commits {fd.stats()['commits'] - c0}", flush=True)
        for nm, cnt in sorted(samples.items()):
            tot = sum(cnt.values())
            print(f"  -- {nm} ({tot} samples)")
            for st, c in cnt.most_common(8):
                print(f"     {c / tot:.3f} {st}")
    ts = []
    for i in range(10):
        ops = [("add", [f"direct{i}/{j}", j]) for j in range(32)]
        a = time.perf_counter()
        r1.apply_ops(ops)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - a)
    print("direct 32-op apply_ops ms", [round(x * 1e3, 2) for x in ts], flush=True)
    print(subprocess_name_power(), flush=True)
    for r in reps:
        r.stop()
    return 0


def subprocess_name_power() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
