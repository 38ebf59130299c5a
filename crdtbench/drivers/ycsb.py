"""Driver of the YCSB cells: YCSB core workload A through the program's
public API on two replicas of an ``AWLWWMap``.

The deployment (the configuration file): two replicas on the default
(binned) store, started with ``start_link``, neighbours of each other,
each with an ``on_diffs`` subscriber (its feed) and a serving front door
(``Replica.frontdoor``, journalled) that its clients go through. The
replicas run ``threaded=False``: the driver's thread pumps each one's
anti-entropy (``sync_to_all``) and ingress (``process_pending``) every
``sync_interval_s`` of the window, so that the profiler, which records
the main thread, sees the sync rounds and the merges; each front door
keeps its own admission worker. Both replicas stamp their writes from
one strictly increasing microsecond clock (they share the host), each
through a clock of its own that logs what it hands out.

Set-up: the records (:mod:`crdtbench.ycsb_gen`), the replicas, the load
(one loader, ``mutate_batch`` of ``MAX_BATCH`` records at a time into
replica 0), anti-entropy to quiescence (the digests agree and a round
merges nothing) and equal canonical bytes, then ``warmup_s`` of the
closed loop (every shape the window uses) and anti-entropy to
quiescence again.

A step is one round of the closed loop: each of the clients, in turn,
first waits for the acknowledgement of its previous update if it has
one, then issues its next operation on its replica's front door: a read
(``read_keys([key])``, on the driver's thread) or an update
(``mutate_async("add", [key, record])``, committed by the admission
worker). Anti-entropy runs in both directions once ``sync_interval_s``
has passed since the last round.

``correct`` (:mod:`crdtbench.reference.ycsb`): after the window, the
traffic stops and anti-entropy runs to quiescence; then every read
against the writes, the acknowledged updates against the journals and
the logged clocks, both replicas' canonical bytes against each other,
both replicas' ``read()`` and replayed feeds against the reference's
map, and both replicas' alive entries against the writes.
"""

from __future__ import annotations

import statistics
import sys
import threading
import time

import numpy as np
import torch

from crdtbench import ycsb_gen
from crdtbench.reference import ycsb as reference
from crdtbench.trace import SetupClock

#: seconds a client waits for an acknowledgement before the run fails
ACK_TIMEOUT_S = 120.0
#: anti-entropy rounds that may pass before the replicas must be level
LEVEL_ROUNDS = 512


class _Source:
    """One strictly increasing microsecond clock shared by the replicas
    of a host."""

    def __init__(self):
        self.lock = threading.Lock()
        self.last = 0

    def take(self, n: int) -> int:
        with self.lock:
            start = max(time.time_ns() // 1000, self.last + 1)
            self.last = start + n - 1
            return start


def _logged_clock(source: _Source):
    """A replica's clock: stamps from ``source``, every one logged in the
    order it was handed out (``.log``)."""
    from delta_crdt_ex_tpu_torch.runtime.clock import Clock

    class LoggedClock(Clock):
        def __init__(self):
            super().__init__()
            self.log: list = []

        def next(self) -> int:
            self._last = source.take(1)
            self.log.append(self._last)
            return self._last

        def next_n(self, n: int) -> np.ndarray:
            out = source.take(n) + np.arange(n, dtype=np.int64)
            if n:
                self._last = int(out[-1])
            self.log.extend(out.tolist())
            return out

        def observe(self, ts: int) -> None:
            super().observe(ts)
            with source.lock:
                source.last = max(source.last, int(ts))

    return LoggedClock()


class _Feed:
    """A replica's ``on_diffs`` subscriber: the feed replayed into a map
    as it arrives, and, while ``watch`` is on, the time each record
    value first appears."""

    def __init__(self):
        self.map: dict = {}
        self.seen: dict = {}
        self.watch = False

    def __call__(self, diffs):
        now = time.perf_counter()
        for d in diffs:
            if d[0] == "add":
                self.map[d[1]] = d[2]
                if self.watch:
                    self.seen.setdefault(d[2], now)
            else:
                self.map.pop(d[1], None)


class _Client:
    __slots__ = ("replica", "ticket", "update")

    def __init__(self, replica: int):
        self.replica = replica
        self.ticket = None
        self.update = None  # [replica, record, value, t_submit, t_ack]


def _quantile(values: list, q: int) -> float | None:
    """The q-th percentile (``statistics.quantiles``, n=100)."""
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100)[q - 1]


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str, spans):
        import delta_crdt_ex_tpu_torch as tdc
        from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

        self.cfg, self.mix, self.spans = cfg, mix, spans
        self.cuda = torch.device(device).type == "cuda"
        mark = SetupClock(self._sync)
        self.setup_phases = mark.phases
        # a --device cpu run (the harness's own tests) loads the cut count
        n = cfg["recordcount"] if self.cuda else cfg.get("cpu_recordcount", cfg["recordcount"])
        self.rng = np.random.default_rng(seed)
        self.names = ycsb_gen.key_names(n)
        self.load = ycsb_gen.records(self.rng, n, cfg["fieldcount"], cfg["fieldlength"])
        self.chooser = ycsb_gen.ScrambledZipfian(n, cfg["zipfian_constant"])
        self.gids = []
        while len(self.gids) < cfg["replicas"]:  # distinct writer gids
            g = int(self.rng.integers(1, 1 << 62))
            self.gids += [g] if g not in self.gids else []
        mark("generate")

        source = _Source()
        self.clocks = [_logged_clock(source) for _ in range(cfg["replicas"])]
        self.feeds = [_Feed() for _ in range(cfg["replicas"])]
        self.transport = LocalTransport()
        self.reps = [
            tdc.start_link(
                tdc.AWLWWMap, name=f"ycsb-{i}", node_id=self.gids[i], transport=self.transport, threaded=False,
                sync_interval=cfg["sync_interval_s"], max_sync_size=cfg["max_sync_size"], on_diffs=self.feeds[i],
                clock=self.clocks[i], capacity=cfg["capacity"] * n // cfg["recordcount"], tree_depth=cfg["tree_depth"],
                device=device,
            )
            for i in range(cfg["replicas"])
        ]
        for i, r in enumerate(self.reps):
            r.set_neighbours([p for j, p in enumerate(self.reps) if j != i])
        self.doors = [r.frontdoor(journal=True) for r in self.reps]
        self._pump()
        mark("start")

        batch = self.reps[0].MAX_BATCH
        for s in range(0, n, batch):
            self.reps[0].mutate_batch("add", [[self.names[i], self.load[i]] for i in range(s, min(s + batch, n))])
        mark("load")
        self._level()
        if self.reps[0].canonical_state_bytes() != self.reps[1].canonical_state_bytes():
            raise RuntimeError("the replicas' canonical bytes differ after the load's anti-entropy")
        mark("level")

        per = mix["clients_per_replica"]
        self.clients = [_Client(i % len(self.reps)) for i in range(per * len(self.reps))]
        self.reads: list = []  # (replica, record, value, t_start)
        self.updates: list = []  # [replica, record, value, t_submit, t_ack]
        self.read_s: list = []
        self.w_issued = 0
        self.next_sync = time.perf_counter()
        self.sync_starts: list = []
        t_end = time.perf_counter() + mix["warmup_s"]
        while time.perf_counter() < t_end:
            self.step()
        self._quiesce()
        mark("warm_up")
        self._start_window()

    # -- set-up helpers ---------------------------------------------------

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _pump(self):
        """Deliver every queued message (the replicas' ingress) until no
        mailbox holds one."""
        while sum(r.process_pending() for r in self.reps):
            pass

    def _anti_entropy(self):
        """One anti-entropy round in each direction: each replica pushes
        its fresh deltas and opens its digest walk, and both take in
        what they were sent until quiet."""
        with self.spans("sync"):
            for r in self.reps:
                r.sync_to_all()
            self._pump()

    def _level(self, required: bool = True) -> None:
        """Anti-entropy rounds, with no traffic, to quiescence: until both
        replicas' digest leaves agree and a round merged nothing (their
        sequence numbers stand still: the eager pushes whose cursors the
        digest walk's transfers left behind have caught up), at most
        ``LEVEL_ROUNDS``; past them a ``required`` level raises, and any
        other is left to the comparison."""
        for _ in range(LEVEL_ROUNDS):
            seqs = [r.stats()["sequence_number"] for r in self.reps]
            self._anti_entropy()
            level = all(torch.equal(self.reps[0].state.leaf, r.state.leaf) for r in self.reps[1:])
            if level and seqs == [r.stats()["sequence_number"] for r in self.reps]:
                return
        if required:
            raise RuntimeError(f"the replicas did not converge in {LEVEL_ROUNDS} anti-entropy rounds")

    def _wait(self, c: _Client):
        """Block until ``c``'s outstanding update is acknowledged."""
        if c.ticket is None:
            return
        c.ticket.result(ACK_TIMEOUT_S)
        c.update[4] = c.ticket.t_done
        c.ticket = None

    def _quiesce(self):
        """Stop the traffic (every outstanding update acknowledged) and run
        anti-entropy until the replicas are level (what stays apart is
        the comparison's to count)."""
        for c in self.clients:
            self._wait(c)
        self._level(required=False)

    def _counters_now(self) -> dict:
        doors = [d.stats() for d in self.doors]
        syncs = [r.stats().get("sync") for r in self.reps]
        out = {"commits": sum(d["commits"] for d in doors), "admitted": sum(d["admitted_ops"] for d in doors)}
        if all(s is not None for s in syncs):
            out["sync_rounds"] = sum(s["rounds"] for s in syncs)
            out["sync_capped"] = sum(s["capped_rounds"] for s in syncs)
        return out

    def _start_window(self):
        self.w_reads = len(self.reads)
        self.w_updates = len(self.updates)
        self.read_s = []
        self.at_start = self._counters_now()
        self.peak_setup = torch.cuda.max_memory_allocated() if self.cuda else 0
        self.sync_starts = []
        for f in self.feeds:
            f.watch = True
        self.t0 = time.perf_counter()
        self.next_sync = self.t0 + self.cfg["sync_interval_s"]

    # -- the closed loop -----------------------------------------------------

    def step(self):
        n_ops = len(self.clients)
        is_read = ycsb_gen.operations(self.rng, n_ops, self.cfg["readproportion"])
        record = self.chooser.draw(self.rng, n_ops)
        values = ycsb_gen.records(self.rng, int((~is_read).sum()), self.cfg["fieldcount"], self.cfg["fieldlength"])
        v = 0
        for i, c in enumerate(self.clients):
            self._wait(c)
            k = int(record[i])
            door = self.doors[c.replica]
            if is_read[i]:
                t0 = time.perf_counter()
                got = door.read_keys([self.names[k]])
                t1 = time.perf_counter()
                self.reads.append((c.replica, k, got.get(self.names[k]), t0))
                self.read_s.append(t1 - t0)
            else:
                value = values[v]
                v += 1
                c.update = [c.replica, k, value, time.perf_counter(), None]
                c.ticket = door.mutate_async("add", [self.names[k], value])
                self.updates.append(c.update)
        now = time.perf_counter()
        if now >= self.next_sync:
            self.sync_starts.append(now)
            self._anti_entropy()
            self.next_sync = max(self.next_sync + self.cfg["sync_interval_s"], now)

    def settle(self):
        """After the window: the traffic stops, every outstanding update
        is acknowledged, and anti-entropy runs until both replicas are
        level and no message is left."""
        for f in self.feeds:
            f.watch = False
        self._quiesce()
        self._anti_entropy()

    # -- readings ----------------------------------------------------------------

    def end_to_end(self, window_s: float) -> dict:
        """Read as the window closes: acknowledged operations a second,
        read and update latency at the client (p99), and staleness (p95):
        from an update's acknowledgement on its replica to its first
        appearance in the other replica's feed, over the updates
        acknowledged before the window's last anti-entropy round began.
        An update a later write of its record overwrote before it
        appeared is counted apart; one that has not appeared counts
        with its wait so far."""
        t_end = self.t0 + window_s
        self.at_end = self._counters_now()
        ups = self.updates[self.w_updates:]
        self.w_issued = len(self.reads) - self.w_reads + len(ups)
        acked = [u for u in ups if u[4] is not None and u[4] <= t_end]
        reads = len(self.reads) - self.w_reads
        upd_s = [u[4] - u[3] for u in acked]
        last_round = self.sync_starts[-1] if self.sync_starts else self.t0
        later: dict = {}  # record -> acknowledgement times of its updates
        for u in self.updates:
            if u[4] is not None:
                later.setdefault(u[1], []).append(u[4])
        stale, apart, unseen = [], 0, 0
        for r, k, value, _submitted, ack in acked:
            if ack >= last_round:
                continue
            seen = [f.seen.get(value) for j, f in enumerate(self.feeds) if j != r]
            seen = [s for s in seen if s is not None]
            if seen:
                stale.append(max(max(seen) - ack, 0.0))
            elif any(t > ack for t in later[k]):
                apart += 1
            else:
                unseen += 1
                stale.append(t_end - ack)
        self.staleness_counts = {"sampled": len(stale), "overwritten_apart": apart, "not_yet_seen": unseen}
        print(f"crdtbench: ycsb window: {reads} reads, {len(acked)} updates acknowledged, "
              f"{len(self.sync_starts)} anti-entropy rounds, staleness {self.staleness_counts}, "
              f"counters {self.counters()}, device memory peak {self.peak_setup} B at the end of set-up and "
              f"{torch.cuda.max_memory_allocated() if self.cuda else 0} B now", file=sys.stderr)
        out = {"ops_per_s": {"value": (reads + len(acked)) / window_s, "unit": "ops/s"}}
        for name, vals, q in (("read_p99_ms", self.read_s, 99), ("update_p99_ms", upd_s, 99),
                              ("staleness_p95_ms", stale, 95)):
            p = _quantile(vals, q)
            if p is not None:
                out[name] = {"value": p * 1e3, "unit": "ms"}
        return out

    def counters(self) -> dict:
        """The window's program counters: the front doors' commits and
        admitted operations, and the replicas' sync rounds and capped
        rounds (where the program keeps them)."""
        a, b = self.at_start, self.at_end
        out = {k: b[k] - a[k] for k in b if k in a}
        out.update(self.staleness_counts)
        return out

    def attempted(self) -> int:
        """Operations the clients issued in the window."""
        return self.w_issued

    def work(self, first: int, count: int) -> dict:
        return {"steps": count, "clients": len(self.clients)}

    # -- the comparison ------------------------------------------------------------

    def _entries(self, rep) -> tuple:
        """A replica's alive entries as its store holds them: key id,
        timestamp and writer gid (the store's writer slot through its
        context table), on the host."""
        st = rep.state
        a = st.alive
        slots = st.node.to(torch.int64).clamp(0, st.ctx_gid.shape[-1] - 1)
        key, ts, gid = (t.cpu().numpy() for t in (st.key[a], st.ts[a], st.ctx_gid[slots[a]]))
        return key.view(np.uint64), ts, gid.view(np.uint64)

    def judge(self, control: str | None) -> tuple[dict, int]:
        """``({check: (count, limit)}, operations that failed)`` once the
        traffic has settled."""
        if control not in (None, "ts32"):
            raise ValueError(f"unknown control {control!r}; known: ('ts32',)")
        index = {name: k for k, name in enumerate(self.names)}
        journals = [[(index[args[0]], args[1]) for group in d.journal() for _f, args in group] for d in self.doors]
        n = len(self.load)
        load_ts = self.clocks[0].log[:n]
        w, acks_off = reference.writes_of(load_ts, self.gids[0], self.load, journals,
                                          [c.log for c in self.clocks], self.gids)
        committed = [{v for _k, v in j} for j in journals]
        acked = [(u[0], u[1], u[2], u[4]) for u in self.updates if u[4] is not None]
        acks_off += sum(1 for r, _k, v, _t in acked if v not in committed[r])
        reads_off = reference.reads_off(w, self.reads, acked)
        want = reference.expected_map(w, self.names)
        canon = [r.canonical_state_bytes() for r in self.reps]
        checks = {
            "reads_off": reads_off,
            "acks_off": acks_off,
            "replicas_unequal": int(any(c != canon[0] for c in canon[1:])),
            "read_off": sum(reference.map_off(r.read(), want) for r in self.reps),
            "feed_off": sum(reference.map_off(f.map, want) for f in self.feeds),
            "entries_off": sum(reference.entries_off(w, *self._entries(r), control=control) for r in self.reps),
        }
        for d in self.doors:
            d.close()
        for r in self.reps:
            r.stop()
        return {k: (v, 0) for k, v in checks.items()}, reads_off + acks_off
