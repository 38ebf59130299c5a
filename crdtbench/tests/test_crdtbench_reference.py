"""The reference's frozen digest mix is the map's published one (held
here against the program's, which the reference itself never imports),
and the add/remove reference is the join, worked out by a plain
replay of the deltas dot by dot at a tiny size."""

from __future__ import annotations

import numpy as np
import torch

from crdtbench.reference import digest


def test_frozen_digest_matches_the_program():
    from delta_crdt_ex_tpu_torch.ops.binned import entry_hash, tree_from_leaves

    rng = np.random.default_rng(5)
    key = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    gid = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    ctr = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    ts = rng.integers(0, 2**62, size=4096, dtype=np.int64)
    valh = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    t = lambda a: torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)
    want = entry_hash(t(key), t(gid), t(ctr), t(ts), t(valh)).numpy().astype(np.uint64)
    assert np.array_equal(digest.entry_hash(key, gid, ctr, ts, valh), want)
    leaf = rng.integers(0, 2**32, size=1024, dtype=np.uint64)
    assert digest.root(leaf) == int(tree_from_leaves(t(leaf))[0][0])


def test_cycles_reference_matches_a_plain_replay():
    """Replay an add/remove stream dot by dot (the receiver a dict of
    alive dots and a per-(writer, bucket) context; a delta row adds the
    entries whose dots it has not seen and drops the writer's dots its
    interval covers but does not carry) and compare the map after every
    call of two cycles, and after a partial third, with
    :func:`cycles_expected`."""
    from crdtbench import gen
    from crdtbench.reference.awlww import cycles_expected

    cfg = dict(base_keys=48, num_buckets=16, bin_capacity=32, bin_width=8, max_sync_size=12,
               base_gid=22, writer_gid=22, ts_origin_us=1 << 40)
    mix = dict(kind="add_remove_cycles", cycle_keys=40)
    t = gen.cycle_traffic(cfg, mix, np.random.default_rng(9))
    G = t.groups
    alive = {(22, int(b), int(c)): (int(k), int(ts), int(v))
             for k, b, c, ts, v in zip(t.base.key, t.base.bucket, t.base.ctr, t.base.ts, t.base.valh)}
    ctx = {}
    for (g, b, c) in alive:
        ctx[(g, b)] = max(ctx.get((g, b), 0), c)
    for c in range(2 * (2 * G) + G + 1):
        k, p = divmod(c, 2 * G)
        w = t.wires[p]
        for u, row in enumerate(w["rows"].tolist()):
            if row < 0:
                continue
            step = k * int(t.per_cycle[row])
            lo, hi = int(w["ctx_lo"][u, 0]) + step, int(w["ctx_rows"][u, 0]) + step
            carried = {}
            for s in np.flatnonzero(w["alive"][u]):
                dot = (22, row, int(w["ctr"][u, s]) + step)
                carried[dot] = (int(w["key"][u, s]), int(w["ts"][u, s]) + k * t.ts_step, int(w["valh"][u, s]))
            for dot in [d for d in alive if d[0] == 22 and d[1] == row and lo < d[2] <= hi and d not in carried]:
                del alive[dot]
            for dot, e in carried.items():
                if dot[2] > ctx.get((22, row), 0):
                    alive[dot] = e
            ctx[(22, row)] = max(ctx.get((22, row), 0), hi)
        _, want = cycles_expected(cfg, t, c + 1)
        got = sorted((d[2], e[0], e[1], e[2]) for d, e in alive.items())
        assert got == sorted(zip(want.ctr.tolist(), want.key.tolist(), want.ts.tolist(), want.valh.tolist())), c
        col = np.array([ctx.get((22, b), 0) for b in range(16)])
        assert np.array_equal(want.ctx[22], col), c
        leaf = digest.leaves(16, want.key & np.uint64(15),
                             digest.entry_hash(want.key, want.gid, want.ctr, want.ts, want.valh))
        assert np.array_equal(want.leaf, leaf), c
