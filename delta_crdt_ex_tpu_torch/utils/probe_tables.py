"""Seeded hash-store tables and query batches for holding the probe
kernel (``csrc/probe.cu``) against its plain version
(``ops/hash_map.py:probe_lookup_ref``): keys placed anywhere in their
probe windows, windows that run off or end exactly at the table end,
dead lanes, several live dots of one key, top-bit keys and gids, and
writer tables of any size. Used by ``chip_smoke.py`` and the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from delta_crdt_ex_tpu_torch.models.hash_store import HashStore
from delta_crdt_ex_tpu_torch.ops.hash_map import probe_base


def seeded_table(H: int, W: int, n_keys: int, seed: int, device, R: int = 8):
    """A hash-store table with ``n_keys`` keys placed in their probe
    windows (1-3 live dots each, some dead copies), random garbage in
    the other lanes, and an ``R``-entry writer table with top-bit gids.
    A share of the keys have windows that run off the table end, and
    another share (where W is a multiple of 8) windows that end exactly
    at it. Returns ``(state, placed_keys int64)``."""
    g = np.random.default_rng(seed)

    def rnd_u64(n: int) -> torch.Tensor:  # uint64 bits, half with the top bit set
        low = g.integers(0, 2**63, n, dtype=np.int64)
        top = np.where(g.random(n) < 0.5, np.int64(-(2**63)), np.int64(0))
        return torch.from_numpy(low ^ top).to(device)

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
    more = g.integers(0, 2**63, max(R - 8, 0), dtype=np.int64).astype(np.uint64) | np.uint64(1 << 63)
    gid = np.concatenate([gid, more])[:R]
    ctx_gid = torch.from_numpy(gid.view(np.int64).copy()).to(device)

    keys = rnd_u64(n_keys)
    # shares of the keys chosen so their windows run off the table end,
    # or end exactly at it
    cand = rnd_u64(max(64 * n_keys // 16, 64, min(4 * H, 1 << 24)))
    cb = probe_base(cand, H).to(torch.int64)
    tail = cand[cb + W > H][: n_keys // 16]
    edge = cand[cb + W == H][: n_keys // 16]
    keys = torch.cat([keys[: n_keys - len(tail) - len(edge)], tail, edge])
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


def queries(keys, Q: int, seed: int, hit: float = 0.75):
    """``Q`` query hashes: a ``hit`` share of placed keys, the rest missing."""
    g = np.random.default_rng(seed)
    n_hit = int(Q * hit)
    hit = keys[torch.from_numpy(g.integers(0, len(keys), n_hit)).to(keys.device)]
    miss = torch.from_numpy(g.integers(-(2**63), 2**63 - 1, Q - n_hit, dtype=np.int64)).to(keys.device)
    return torch.cat([hit, miss])[torch.from_numpy(g.permutation(Q)).to(keys.device)]
