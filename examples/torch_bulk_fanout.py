"""Bulk fan-in on the packed entry layout with the PyTorch port — the
port's counterpart of ``examples/bulk_fanout.py``: one call merges a
writer's delta slice into a whole stack of neighbour replica states.

Stack the neighbour states, ``pack_states`` them into the packed layout
(one ``int32[N, L, B, 8]`` word table, 32 bytes an entry against the
column layout's 45), and ``fanout_merge_into`` joins the slice into every
neighbour in one call, with ``scatter_compact`` on (the north star's
primary, as in ``bench.py``) and the shared tier-escalation ladder
growing the stack where it must. The reference loops over neighbours
one message at a time (``causal_crdt.ex:264-283``); here the neighbour
axis is a batch axis.

This demo speaks the store's vocabulary (uint64 key hashes, uint32 value
hashes, as ``bench.py`` does); the replica runtime (``start_link``)
wraps the same ops for arbitrary Python keys and values.

Run: python examples/torch_bulk_fanout.py [--device cpu]
(everything lives on "cuda" unless ``--device cpu`` is given; without a
card the default raises, it does not fall back to the CPU).
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from delta_crdt_ex_tpu_torch.models.binned import BinnedStore  # noqa: E402
from delta_crdt_ex_tpu_torch.models.binned_map import group_batch  # noqa: E402
from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD  # noqa: E402
from delta_crdt_ex_tpu_torch.ops.binned import extract_rows, row_apply  # noqa: E402
from delta_crdt_ex_tpu_torch.ops.packed import unpack  # noqa: E402
from delta_crdt_ex_tpu_torch.parallel import (  # noqa: E402
    fanout_merge_into,
    pack_states,
    stack_states,
    unstack_states,
)

N_NEIGHBOURS = 16
L = 256  # digest-tree leaves / hash buckets


def fresh_state(gid: int, device) -> BinnedStore:
    """Empty lattice with this writer's gid in context slot 0."""
    st = BinnedStore.new(num_buckets=L, bin_capacity=16, replica_capacity=4, device=device)
    ctx_gid = st.ctx_gid.clone()
    ctx_gid[0] = gid
    return dataclasses.replace(st, ctx_gid=ctx_gid)


def apply_adds(state: BinnedStore, keys: np.ndarray, vals: np.ndarray, t0: int) -> BinnedStore:
    """A local mutation batch through the bucket-grouped row op."""
    n = len(keys)
    g = group_batch(
        state.num_buckets, np.full(n, OP_ADD, np.int32), keys.astype(np.uint64),
        vals.astype(np.uint32), np.arange(t0, t0 + n, dtype=np.int64),
    )
    dev = state.device
    res = row_apply(
        state, 0,
        torch.from_numpy(g.rows.astype(np.int64)).to(dev),
        torch.from_numpy(g.op).to(dev),
        torch.from_numpy(g.key.view(np.int64)).to(dev),
        torch.from_numpy(g.valh.astype(np.int64)).to(dev),
        torch.from_numpy(g.ts).to(dev),
    )
    if not bool(res.ok):  # no retry path at this level; fail loudly
        raise SystemExit("row_apply overflowed its bin tier")
    return res.state


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    device = torch.device(ap.parse_args().device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")

    rng = np.random.default_rng(0)
    # a writer replica produces a delta; 16 neighbours each hold their
    # own prior state (different gids, so the per-neighbour remap is real)
    writer = apply_adds(
        fresh_state(999, device), rng.integers(1, 1 << 63, size=64, dtype=np.uint64), np.arange(64), t0=100
    )
    neighbours = [
        apply_adds(
            fresh_state(100 + i, device), rng.integers(1, 1 << 63, size=4, dtype=np.uint64), np.arange(4), t0=1
        )
        for i in range(N_NEIGHBOURS)
    ]

    # ship the writer's rows as one slice, fan it into all neighbours
    sl = extract_rows(writer, torch.arange(L, device=device))
    stacked = pack_states(stack_states(neighbours))
    t0 = time.perf_counter()
    stacked, res, retries = fanout_merge_into(stacked, sl, kill_budget=16, scatter_compact=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # fanout_merge_into returns only once every lane merged (its tier
    # ladder retries, or raises on a context gap)

    outs = unstack_states(unpack(stacked))
    dots = sorted({int(st.alive.sum()) for st in outs})
    print(f"fanned 1 slice into {N_NEIGHBOURS} neighbours in one call on {device}: "
          f"{dt * 1e3:.1f} ms, {retries} tier retries, words {tuple(stacked.words.shape)} "
          f"{stacked.words.dtype}, every neighbour now holds {dots} live dots (64 merged + 4 local)")


if __name__ == "__main__":
    main()
