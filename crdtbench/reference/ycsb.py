"""The plain reference of the YCSB cells: what two replicas of an
add-wins observed-remove map, values resolved LWW by (timestamp, writer
gid, counter), must hold and answer after a YCSB run, worked out in
plain Python and numpy from the run's inputs and the writes the clients
saw acknowledged. It imports nothing of the program.

The writes are the load's records and every update a front door
acknowledged, each with the timestamp its replica's clock handed out
(the driver's logged clocks, matched to the front doors' journals in
commit order) and its replica's gid. The two replicas stamp from one
strictly increasing host clock, so a write that observed another has
the later timestamp; with adds alone, add-wins keeps the LWW-greatest
write of a key alive on both replicas, and the map is that write's
value for every key.

Each comparison counts what differs; each count has the limit 0.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Writes:
    """Every write of a run, in one flat table: write ``i`` put
    ``value[i]`` under record ``key[i]`` at timestamp ``ts[i]`` on the
    replica with gid ``gid[i]``. The first ``loaded`` writes are the
    load's, one a record in record order."""

    key: np.ndarray  # int64[W] record numbers
    ts: np.ndarray  # int64[W]
    gid: np.ndarray  # uint64[W]
    value: list  # [W] the records written
    loaded: int

    def winners(self) -> np.ndarray:
        """int64[records]: for each record, the write with the greatest
        (ts, gid)."""
        order = np.lexsort((self.gid, self.ts, self.key))
        last = np.ones(len(order), bool)
        last[:-1] = self.key[order][1:] != self.key[order][:-1]
        return order[last]  # sorted by key: record k at position k


def writes_of(load_ts, gid0: int, load_values: list, journals: list, clock_logs: list, gids: list):
    """``(Writes, acks_off)`` from the load (record ``i`` stamped
    ``load_ts[i]`` on replica 0) and each replica's committed updates:
    the ops of its front door's journal (``[(key, value)]`` in commit
    order) matched in order to the stamps its clock handed out after the
    load. ``acks_off`` counts the stamps and ops that do not pair up."""
    n = len(load_values)
    keys, tss, gidl, values = [np.arange(n, dtype=np.int64)], [np.asarray(load_ts, np.int64)], [], list(load_values)
    gidl.append(np.full(n, gid0, np.uint64))
    off = 0
    for r, (ops, log, gid) in enumerate(zip(journals, clock_logs, gids)):
        log = np.asarray(log[n:] if r == 0 else log, np.int64)
        m = min(len(ops), len(log))
        off += abs(len(ops) - len(log))
        keys.append(np.asarray([k for k, _v in ops[:m]], np.int64))
        tss.append(log[:m])
        gidl.append(np.full(m, gid, np.uint64))
        values.extend(v for _k, v in ops[:m])
    w = Writes(np.concatenate(keys), np.concatenate(tss), np.concatenate(gidl), values, n)
    return w, off


def expected_map(w: Writes, names: list) -> dict:
    """The map both replicas must read: each record's key name and its
    LWW-greatest write's value."""
    win = w.winners()
    return {names[k]: w.value[i] for k, i in enumerate(win.tolist())}


def map_off(got: dict, want: dict) -> int:
    """Keys whose value differs, plus keys held by one side only."""
    off = sum(1 for k, v in want.items() if got.get(k, None) != v)
    return off + sum(1 for k in got if k not in want)


def reads_off(w: Writes, reads: list, acked: list) -> int:
    """Reads that break read-your-writes on the replica that served
    them. ``reads`` are ``(replica, record, value, t_start)``; ``acked``
    the acknowledged updates ``(replica, record, value, t_ack)``. A read
    is off where its value is no write of the record, or where an
    update of the record acknowledged on its replica before the read
    began is LWW-greater than the write it returned."""
    ts_of: dict = {}
    for i in range(w.loaded, len(w.value)):
        ts_of[w.value[i]] = (int(w.ts[i]), int(w.gid[i]), int(w.key[i]))
    # per (replica, record): acknowledgement times and the running LWW
    # maximum of the updates acknowledged by then
    hist: dict = {}
    for r, k, v, t in sorted(acked, key=lambda a: a[3]):
        stamp = ts_of.get(v)
        if stamp is None:
            continue  # counted by writes_of's pairing
        times, best = hist.setdefault((r, k), ([], []))
        times.append(t)
        best.append(max(best[-1], stamp[:2]) if best else stamp[:2])
    off = 0
    for r, k, v, t in reads:
        if v is None:
            off += 1
            continue
        if v == w.value[k]:
            got = (int(w.ts[k]), int(w.gid[k]))
        else:
            stamp = ts_of.get(v)
            if stamp is None or stamp[2] != k:
                off += 1
                continue
            got = stamp[:2]
        times, best = hist.get((r, k), ((), ()))
        j = bisect.bisect_left(times, t)
        if j and best[j - 1] > got:
            off += 1
    return off


def entries_off(w: Writes, key_hash: np.ndarray, ts: np.ndarray, gid: np.ndarray, control: str | None = None) -> int:
    """One replica's alive entries (key id, timestamp, writer gid, as
    the driver read them out of the program's store) against the
    writes: entries that are no write (no write has their timestamp and
    gid), key ids whose entries belong to more than one record or whose
    LWW-greatest entry is not that record's winning write, and the
    difference between the key ids and the records. ``control="ts32"``
    cuts the entries' timestamps to their low 32 bits first, what a map
    that kept its microsecond timestamps in 32 bits would hold."""
    ts = np.asarray(ts, np.int64)
    if control == "ts32":
        ts = ts & M32
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    order = np.argsort(w.ts, kind="stable")
    wts = w.ts[order]
    j = np.minimum(np.searchsorted(wts, ts), len(wts) - 1)
    hit = (wts[j] == ts) & (w.gid[order][j] == np.asarray(gid, np.uint64))
    off = int((~hit).sum())
    write = order[j[hit]]
    kh = np.asarray(key_hash, np.uint64)[hit]
    if not len(kh):
        return off + len(w.winners())
    srt = np.lexsort((w.gid[write], w.ts[write], kh))
    kh, write = kh[srt], write[srt]
    start = np.flatnonzero(np.r_[True, kh[1:] != kh[:-1]])
    end = np.r_[start[1:], len(kh)] - 1
    rec = w.key[write]
    mixed = np.minimum.reduceat(rec, start) != np.maximum.reduceat(rec, start)
    winners = w.winners()
    wrong = winners[rec[end]] != write[end]
    return off + int(mixed.sum()) + int((wrong & ~mixed).sum()) + abs(len(start) - len(winners))
