"""SPMD ring gossip with the PyTorch port: one replica a mesh shard,
bounded-divergence ring anti-entropy — the port's counterpart of
``examples/spmd_gossip.py``.

Each shard applies its own mutation batch inside the step, then
``gossip_delta_step`` exchanges leaf digests with its ring neighbour,
requests only the differing buckets and merges the returned slice
shard-locally. N-1 steps converge an N-shard ring.

The mesh has ``--shards`` shards (default 8) over this process's cards;
with fewer cards than shards a card is listed several times (a
repeated-device mesh: each hop is then a copy on that card).

Run: python examples/torch_spmd_gossip.py [--device cpu] [--shards N]
(the mesh lives on "cuda" unless ``--device cpu`` is given; without a
card the default raises, it does not fall back to the CPU).
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from delta_crdt_ex_tpu_torch.models.binned import BinnedStore  # noqa: E402
from delta_crdt_ex_tpu_torch.models.binned_map import group_batch  # noqa: E402
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_PAD  # noqa: E402
from delta_crdt_ex_tpu_torch.ops.binned import winner_all  # noqa: E402
from delta_crdt_ex_tpu_torch.parallel import gossip_delta_drive, make_mesh, place_states, unstack_states  # noqa: E402

L, B, R = 64, 8, 8


def mesh_devices(device: str, shards: int) -> list:
    """``shards`` devices, the cards of this process in turn (or the CPU)."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * shards
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [cards[i % len(cards)] for i in range(shards)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    n = args.shards
    devices = mesh_devices(args.device, n)
    print(f"mesh of {n} shards: {[str(d) for d in devices]}")
    mesh = make_mesh(devices)

    states = []
    for i in range(n):
        st = BinnedStore.new(L, B, R, device="cpu")
        ctx_gid = st.ctx_gid.clone()
        ctx_gid[0] = 100 + i
        states.append(dataclasses.replace(st, ctx_gid=ctx_gid))
    stacked = place_states(states, mesh)
    self_slot = np.zeros(n, np.int32)

    # each replica writes one distinct key inside the step
    groups = [
        group_batch(
            L, np.array([OP_ADD], np.int32), np.array([1000 + i], np.uint64),
            np.array([7 * i], np.uint32), np.array([i + 1], np.int64),
        )
        for i in range(n)
    ]
    u = max(g.rows.shape[0] for g in groups)
    m = max(g.op.shape[1] for g in groups)
    rows = np.full((n, u), -1, np.int32)
    op = np.full((n, u, m), OP_PAD, np.int32)
    key = np.zeros((n, u, m), np.uint64)
    valh = np.zeros((n, u, m), np.uint32)
    ts = np.zeros((n, u, m), np.int64)
    for i, g in enumerate(groups):
        gu, gm = g.op.shape
        rows[i, :gu], op[i, :gu, :gm], key[i, :gu, :gm] = g.rows, g.op, g.key
        valh[i, :gu, :gm], ts[i, :gu, :gm] = g.valh, g.ts
    empty = (
        np.full((n, 1), -1, np.int32), np.full((n, 1, 1), OP_PAD, np.int32),
        np.zeros((n, 1, 1), np.uint64), np.zeros((n, 1, 1), np.uint32), np.zeros((n, 1, 1), np.int64),
    )

    stacked, roots, n_diff, _ = gossip_delta_drive(mesh, stacked, self_slot, rows, op, key, valh, ts)
    print(f"step 1: differing buckets per hop = {n_diff.gather('cpu').tolist()}")
    for step in range(2, n + 1):
        stacked, roots, n_diff, _ = gossip_delta_drive(mesh, stacked, self_slot, *empty)
        print(f"step {step}: differing buckets per hop = {n_diff.gather('cpu').tolist()}")

    roots = roots.gather("cpu")
    assert bool((roots == roots[0]).all()), "roots must agree after a full ring pass"
    want = {1000 + i: 7 * i for i in range(n)}
    for i, st in enumerate(unstack_states(stacked.gather("cpu"))):
        w = winner_all(st)
        got = {int(k): int(v) for k, v in zip(w.key[w.win].tolist(), w.valh[w.win].tolist())}
        assert got == want, (i, got)
    print(f"converged: all {n} replicas share digest root {int(roots[0])} and hold {len(want)} keys")


if __name__ == "__main__":
    main()
