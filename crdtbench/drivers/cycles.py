"""Driver of the add/remove cycle cells: the receiving replica of a
replicated map, held as a neighbour stack of ``receivers`` lanes on one
device, merges the writer's anti-entropy deltas one at a time through
the program's merge entry ``parallel/batched_sync.py:fanout_merge_into``
(its tier retries, compactions and their device sync included), then
takes its digest roots with ``ops/roots.py:batched_roots``.

The deltas are :func:`crdtbench.gen.cycle_traffic`'s: cycle 0's slices
go to the device once in set-up, and the slice of cycle k is made on
the device when it is due by moving cycle 0's counters, context bounds
and timestamps on (the ``deliver`` span: the sender's work, inside the
window and outside the merge). A step is one whole cycle: every add
delta, then every removal delta, then one device sync. So a window
always ends on a cycle's end, and the map is back at its base there;
after it, the add deltas of one more cycle fill the map again for the
comparison (outside the window).

Set-up: the base map (``utils/synth.py:build_state``), stacked and, for
``"layout": "packed"``, packed; ``warmup_cycles`` cycles merged (they
stay in the map, and the reference counts them), and one compaction of
the stack run and dropped, so that the window's first compaction finds
its buffers.

``correct``: the root after every call (the window's, the traced ones
and the fill's) against the reference's, and then every lane's
entries, context and leaves against the reference's map.
"""

from __future__ import annotations

import numpy as np
import torch

from crdtbench import gen, readout, roofline
from crdtbench.reference import awlww, compare
from crdtbench.reference.compare import M32
from crdtbench.trace import SetupClock

#: calls whose roots the device buffer holds before they go to the host
#: (a fixed buffer, so that the harness's memory does not grow with the
#: window's calls); a traffic file may set ``roots_chunk``
ROOT_CHUNK = 4096


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: str, spans):
        from delta_crdt_ex_tpu_torch.ops.binned import compact_rows, slice_from_wire
        from delta_crdt_ex_tpu_torch.ops.packed import compact_rows_packed
        from delta_crdt_ex_tpu_torch.parallel import batched_sync
        from delta_crdt_ex_tpu_torch.utils.synth import build_state

        self.cfg, self.mix, self.device, self.spans = cfg, mix, device, spans
        self.cuda = torch.device(device).type == "cuda"
        self.n = cfg["receivers"]
        self.packed = cfg["layout"] == "packed"
        mark = SetupClock(self._sync)
        self.setup_phases = mark.phases
        self.traffic = t = gen.cycle_traffic(cfg, mix, np.random.default_rng(seed))
        mark("generate")
        one, _ = build_state(
            t.base.gid, t.base.keys, cfg["num_buckets"], cfg["bin_capacity"],
            cfg["replica_capacity"], ts_start=cfg["ts_origin_us"], device=device,
        )
        stack = batched_sync.stack_states([one] * self.n)
        del one
        self.stack = batched_sync.pack_states(stack) if self.packed else stack
        self.slices = [slice_from_wire(w, device) for w in t.wires]
        # what one cycle moves each slice on by: counters and context
        # bounds by the bucket's dots a cycle, timestamps by ts_step
        self.row_step, self.ent_step, self.ts_step = [], [], []
        for w in t.wires:
            rows = w["rows"].astype(np.int64)
            step = np.where(rows >= 0, t.per_cycle[np.maximum(rows, 0)], 0)
            self.row_step.append(torch.from_numpy(step[:, None]).to(device))
            self.ent_step.append(torch.from_numpy(step[:, None] * w["alive"]).to(device))
            self.ts_step.append(torch.from_numpy(w["alive"].astype(np.int64) * t.ts_step).to(device))
        self.root_chunk = max(int(mix.get("roots_chunk", ROOT_CHUNK)), len(t.wires))
        self.root_buf = torch.empty((self.root_chunk, self.n), dtype=torch.int64, device=device)
        mark("build_state")
        self.calls = 0
        self._reset_records()
        for _ in range(mix["warmup_cycles"]):
            self.step()
        (compact_rows_packed if self.packed else compact_rows)(self.stack)
        self.warm = self.calls
        self._reset_records()
        mark("warm_up")

    def _reset_records(self):
        self.roots_host: list = []
        self.root_at = 0
        self.retries = 0

    def _room(self, calls: int):
        """Room in the roots buffer for ``calls`` more calls: what it
        holds goes to the host first where it would not fit."""
        if self.root_at + calls > self.root_chunk:
            self.roots_host.append(self.root_buf[: self.root_at].to("cpu", copy=True))
            self.root_at = 0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _slice(self, k: int, p: int):
        sl = self.slices[p]
        if k == 0:
            return sl
        return sl._replace(
            ctr=sl.ctr + k * self.ent_step[p],
            ts=sl.ts + k * self.ts_step[p],
            ctx_rows=sl.ctx_rows + k * self.row_step[p],
            ctx_lo=sl.ctx_lo + k * self.row_step[p],
        )

    def _call(self, k: int, p: int):
        from delta_crdt_ex_tpu_torch.ops.roots import batched_roots
        from delta_crdt_ex_tpu_torch.parallel import batched_sync

        with self.spans("deliver"):
            sl = self._slice(k, p)
        with self.spans("merge"):
            stack, _, n_retries = batched_sync.fanout_merge_into(
                self.stack, sl, scatter_compact=self.packed, rows_sorted=True, n_alive=self.traffic.n_alive[p],
            )
        with self.spans("roots"):
            self.root_buf[self.root_at] = batched_roots(stack.leaf)
        self.root_at += 1
        self.stack = stack
        self.retries += n_retries
        self.calls += 1

    def step(self):
        k = self.calls // len(self.slices)
        self._room(len(self.slices))
        for p in range(len(self.slices)):
            self._call(k, p)
        with self.spans("sync"):
            self._sync()

    def settle(self):
        """After the window: the add deltas of one more cycle, so that the
        map is compared at its fullest, every key of the cycle alive."""
        k = self.calls // len(self.slices)
        self._room(self.traffic.groups)
        for p in range(self.traffic.groups):
            self._call(k, p)
        self._sync()

    def end_to_end(self, window_s: float) -> dict:
        """Read as the window closes: every delta merged into every
        receiving lane, over the window's seconds."""
        return {"merges_per_s": {"value": (self.calls - self.warm) * self.n / window_s, "unit": "merges/s"}}

    def counters(self) -> dict:
        return {"calls": self.calls - self.warm, "retries": self.retries}

    def attempted(self) -> int:
        return self.calls - self.warm

    def work(self, first: int, count: int) -> dict:
        """Least bytes of ``count`` cycles (every cycle needs the same),
        counted from the inputs: a delta's rows change (entries added
        or removed), read and written once in every lane; the slice
        read once."""
        t = self.traffic
        L, G = self.cfg["num_buckets"], t.groups
        live = np.bincount(t.base.bucket, minlength=L).astype(np.int64)
        total = 0
        for p in range(2 * G):
            sel = t.group == p % G
            rows = np.unique(t.bucket[sel])
            delta = np.bincount(t.bucket[sel], minlength=L)[rows]
            before = live[rows]
            after = before + delta if p < G else before - delta
            live[rows] = after
            total += roofline.merge_bytes(self.n, before, after, t.n_alive[p], len(rows))
        return {"merge_bytes": total * count, "calls": 2 * G * count, "roots_shape": (self.n, L)}

    def judge(self, control: str | None) -> tuple[dict, int]:
        """``({check: (count, limit)}, calls that failed)``, once the
        window has closed. Under the control the reference computed with
        32-bit timestamps stands in for the program's roots, and the
        lanes are read with their timestamps cut."""
        self.slices = self.row_step = self.ent_step = self.ts_step = None
        want_roots, want = awlww.cycles_expected(self.cfg, self.traffic, self.calls, first=self.warm)
        dev = self.stack.leaf.device
        if control == "ts32":
            got_roots, _ = awlww.cycles_expected(self.cfg, self.traffic, self.calls, first=self.warm, ts_mask=M32)
            got = torch.tensor(got_roots, dtype=torch.int64, device=dev)[:, None].expand(-1, self.n)
        elif control is not None:
            raise ValueError(f"unknown control {control!r}; known: {readout.CONTROLS}")
        else:
            got = torch.cat([*self.roots_host, self.root_buf[: self.root_at].cpu()]).to(dev)
        self.roots_host = self.root_buf = None
        expect = torch.tensor(want_roots, dtype=torch.int64, device=dev)
        roots_off = int((got != expect[:, None]).any(-1).sum()) if len(want_roots) else 0
        judge = compare.Judge(want, dev)
        off = readout.count_off(judge, self.stack, control)
        checks = {"calls_roots_off": (roots_off, 0), **{k: (v, 0) for k, v in off.items()}}
        return checks, roots_off
