"""SPMD ring gossip over a replica mesh, PyTorch port against the JAX
package (``tests/test_parallel.py``'s mesh cases and
``tests/test_multihost_spmd.py``):

- ``gossip_delta_step`` is bit-equal to JAX's at 8 shards on seeded
  inputs (top-bit keys and gids) step by step — state, roots, ``ok``,
  ``n_diff`` and ``flags`` — with a frontier narrower than the
  divergence, and ``gossip_delta_drive``'s tier-overflow recovery
  (growth and replay) is bit-equal too;
- frontier truncation heals; ``gossip_train_step`` converges; the
  two-pod bridge (two 4-shard meshes joined by a host-mediated slice)
  converges; ``snapshot_mesh`` / ``restore_mesh`` round-trip (and a
  foreign layout or a shard-count mismatch raises);
- two ``torch.distributed`` processes (gloo) with 4 shards each run one
  8-shard mesh to the one-process run's bits.

The port's meshes list the one CPU device once per shard; the JAX side
runs on the 8 virtual CPU devices the conftest forces.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.ops.apply import OP_ADD
from delta_crdt_ex_tpu.parallel import gossip_delta_drive as j_drive, gossip_delta_step as j_step
from delta_crdt_ex_tpu.parallel import make_mesh as j_make_mesh, place_states as j_place
from delta_crdt_ex_tpu.runtime import transition as j_tr
from delta_crdt_ex_tpu_torch.ops.binned import winner_all
from delta_crdt_ex_tpu_torch.parallel import (
    fanout_merge_into,
    gossip_delta_drive,
    gossip_delta_step,
    gossip_train_step,
    make_mesh,
    replica_sharding,
    restore_mesh,
    snapshot_mesh,
    unstack_states,
)
from delta_crdt_ex_tpu_torch.ops.binned import extract_rows
from delta_crdt_ex_tpu_torch.utils.devices import Sharded
from tests.kernel_harness import BinnedKernelMap
from tests.test_parallel import grouped_mutations
from tests.test_torch_fleet import assert_same, assert_tree_same, to_port_state

REPO = Path(__file__).resolve().parents[1]
TOP = 1 << 63


def cpu_mesh(n: int = 8):
    return make_mesh(["cpu"] * n)


def jax_states(n, capacity=128, rcap=8, num_buckets=64):
    """Fresh JAX states with top-bit writer gids on every other replica."""
    return [
        BinnedKernelMap(gid=(TOP if i % 2 else 0) + 100 + i, capacity=capacity, rcap=rcap, num_buckets=num_buckets)
        for i in range(n)
    ]


def both(maps, mesh):
    """The same replica set placed on the JAX mesh and the port's."""
    states = [m.state for m in maps]
    return j_place(states, j_make_mesh()), replica_sharding(mesh).put(to_port_state(j_tr.stack_states(states)))


def np_batch(batch):
    return tuple(np.asarray(a) for a in batch)


def port_read(state) -> dict:
    w = winner_all(state)
    keys = w.key[w.win].numpy().view(np.uint64)
    return {int(k): int(v) for k, v in zip(keys, w.valh[w.win].tolist())}


def lanes_of(stacked) -> list:
    return unstack_states(stacked.gather("cpu") if isinstance(stacked, Sharded) else stacked)


def assert_step_equal(t_out, j_out, what):
    names = ("state", "roots", "ok", "n_diff", "flags")
    for name, t, j in zip(names, t_out, j_out):
        t = t.gather("cpu") if isinstance(t, Sharded) else t
        if name == "state":
            assert_tree_same(t, j, (what, name))
        else:
            assert_same(t, j, (what, name))


def test_gossip_delta_step_bit_equal_to_jax_at_8_shards():
    """Step by step against JAX's ``shard_map`` step: a seeded wave of
    top-bit-key adds, then empty steps with a frontier of 4 buckets (so
    the divergence is truncated and heals over several steps) until
    nothing differs; every output equal."""
    n, L = 8, 64
    mesh = cpu_mesh()
    maps = jax_states(n)
    j_st, t_st = both(maps, mesh)
    slots = np.zeros(n, np.int32)
    rng = np.random.default_rng(3)
    seed = grouped_mutations(n, L, [
        [(OP_ADD, int(rng.integers(1, 1 << 40)) | (TOP if (i + j) % 2 else 0), int(rng.integers(0, 1 << 31)),
          1 + 10 * i + j) for j in range(1 + i % 4)]
        for i in range(n)
    ])
    empty = grouped_mutations(n, L, [[] for _ in range(n)])
    for step in range(24):
        batch = seed if step == 0 else empty
        j_out = j_step(j_make_mesh(), j_st, jnp.asarray(slots), *batch, frontier=4)
        t_out = gossip_delta_step(mesh, t_st, slots, *np_batch(batch), frontier=4)
        assert_step_equal(t_out, j_out, step)
        j_st, t_st = j_out[0], t_out[0]
        if int(np.asarray(j_out[3]).max()) == 0:
            break
    assert int(np.asarray(j_out[3]).max()) == 0 and step > 2  # the frontier truncated, then healed
    roots = t_out[1].gather().numpy()
    assert (roots == roots[0]).all()


def test_gossip_delta_drive_overflow_recovery_bit_equal_to_jax():
    """A replica's batch overflows its bin tier inside the step: the
    drive grows the tier on the pre-step states and replays, in both
    packages alike (states, roots, divergence, retier count)."""
    n, L = 8, 16
    mesh = cpu_mesh()
    maps = jax_states(n, capacity=64, num_buckets=L)
    j_st, t_st = both(maps, mesh)
    slots = np.zeros(n, np.int32)
    same_bucket = [(OP_ADD, (16 * j + 5) | (TOP if j % 2 else 0), 50 + j, j + 1) for j in range(6)]
    batch = grouped_mutations(n, L, [same_bucket] + [[] for _ in range(n - 1)])
    grows: list = []
    j_out = j_drive(j_make_mesh(), j_st, jnp.asarray(slots), *batch)
    t_out = gossip_delta_drive(mesh, t_st, slots, *np_batch(batch), on_grow=lambda s: grows.append(s.bin_capacity))
    assert t_out[3] == j_out[3] >= 1 and grows and t_out[0].bin_capacity >= 8
    assert_tree_same(t_out[0].gather("cpu"), j_out[0], "grown state")
    assert_same(t_out[1].gather("cpu"), j_out[1], "roots")
    empty = grouped_mutations(n, L, [[] for _ in range(n)])
    t_st = t_out[0]
    for _ in range(n):
        t_st, roots, n_diff, _r = gossip_delta_drive(mesh, t_st, slots, *np_batch(empty))
    want = {(16 * j + 5) | (TOP if j % 2 else 0): 50 + j for j in range(6)}
    assert all(port_read(s) == want for s in lanes_of(t_st))


def test_frontier_truncation_heals():
    """Five distinct-bucket keys on one replica and a frontier of 2:
    every replica still reads all five after enough steps."""
    n = 8
    mesh = cpu_mesh()
    maps = jax_states(n)
    seed_keys = [3, 7, 11, 19, 23]
    for j, k in enumerate(seed_keys):
        maps[0].add(k | TOP, 100 + j, ts=j + 1)
    _j, st = both(maps, mesh)
    slots = np.zeros(n, np.int32)
    empty = np_batch(grouped_mutations(n, 64, [[] for _ in range(n)]))
    diffs = []
    for _ in range(3 * (n + len(seed_keys))):
        st, roots, oks, n_diff, _fl = gossip_delta_step(mesh, st, slots, *empty, frontier=2)
        assert bool(oks.gather().all())
        diffs.append(int(n_diff.gather().max()))
    assert diffs[0] >= 3 and diffs[-1] == 0
    want = {k | TOP: 100 + j for j, k in enumerate(seed_keys)}
    assert all(port_read(s) == want for s in lanes_of(st))


def test_gossip_train_step_converges():
    n = 8
    mesh = cpu_mesh()
    maps = jax_states(n)
    _j, st = both(maps, mesh)
    slots = np.zeros(n, np.int32)
    batches = np_batch(grouped_mutations(n, 64, [[(OP_ADD, 1000 + i, i, i + 1)] for i in range(n)]))
    st, roots, oks = gossip_train_step(mesh, st, slots, *batches)
    assert bool(oks.gather().all())
    empty = np_batch(grouped_mutations(n, 64, [[] for _ in range(n)]))
    for _ in range(n - 1):
        st, roots, oks = gossip_train_step(mesh, st, slots, *empty)
        assert bool(oks.gather().all())
    roots = roots.gather().numpy()
    assert (roots == roots[0]).all()
    want = {1000 + i: i for i in range(n)}
    assert all(port_read(s) == want for s in lanes_of(st))


def test_two_pod_bridge_converges():
    """Two 4-shard meshes model two pods; a host-mediated full-row slice
    per direction joins them; ring gossip spreads it inside each pod."""
    L = 16
    pods = []
    for pod in range(2):
        mesh = make_mesh(["cpu"] * 4)
        maps = [BinnedKernelMap(gid=500 * (pod + 1) + i, capacity=64, num_buckets=L) for i in range(4)]
        for i, m in enumerate(maps):
            m.add(100 * pod + i, 1000 + 10 * pod + i, ts=1 + 8 * pod + i)
        pods.append((mesh, replica_sharding(mesh).put(to_port_state(j_tr.stack_states([m.state for m in maps])))))
    slots = np.zeros(4, np.int32)
    empty = np_batch(grouped_mutations(4, L, [[] for _ in range(4)]))

    def heal(pod):
        mesh, st = pod
        for _ in range(4):
            st, roots, n_diff, _r = gossip_delta_drive(mesh, st, slots, *empty)
        return (mesh, st), int(n_diff.gather().max())

    pods[0], d0 = heal(pods[0])
    pods[1], d1 = heal(pods[1])
    assert d0 == d1 == 0
    all_rows = torch.arange(L)
    # the host hop: what a deployment would pickle across hosts
    host = lambda sl: type(sl)(*[x.clone() for x in sl])
    sl_a = host(extract_rows(pods[0][1].lane(0), all_rows))
    sl_b = host(extract_rows(pods[1][1].lane(0), all_rows))
    for pod, sl in ((0, sl_b), (1, sl_a)):
        mesh, st = pods[pod]
        merged, _res, _r = fanout_merge_into(st.gather("cpu"), sl)
        pods[pod] = (mesh, replica_sharding(mesh).put(merged))
    pods[0], d0 = heal(pods[0])
    pods[1], d1 = heal(pods[1])
    assert d0 == d1 == 0
    want = {100 * p + i: 1000 + 10 * p + i for p in (0, 1) for i in range(4)}
    for _mesh, st in pods:
        assert all(port_read(s) == want for s in lanes_of(st))


def test_snapshot_restore_roundtrip():
    """A converged mesh snapshots to host numpy in the JAX dtypes (the
    JAX package reads the arrays back), restores onto a fresh mesh and
    keeps gossiping; a foreign layout and a shard-count mismatch raise."""
    n = 8
    mesh = cpu_mesh()
    maps = jax_states(n)
    for i, m in enumerate(maps):
        m.add(10 + i, i, ts=i + 1)
    _j, st = both(maps, mesh)
    slots = np.zeros(n, np.int32)
    empty = np_batch(grouped_mutations(n, 64, [[] for _ in range(n)]))
    for _ in range(n):
        st, roots, n_diff, _r = gossip_delta_drive(mesh, st, slots, *empty)
    snap = snapshot_mesh(st)
    assert snap["arrays"]["key"].dtype == np.uint64 and snap["arrays"]["leaf"].dtype == np.uint32
    from delta_crdt_ex_tpu.parallel.mesh_gossip import restore_mesh as j_restore

    j_back = j_restore(pickle.loads(pickle.dumps(snap)), j_make_mesh())
    assert_tree_same(st.gather("cpu"), j_back, "JAX reads the port's snapshot")
    restored = restore_mesh(pickle.loads(pickle.dumps(snap)), cpu_mesh())
    want = {10 + i: i for i in range(n)}
    assert all(port_read(s) == want for s in lanes_of(restored))
    batch = np_batch(grouped_mutations(n, 64, [[(OP_ADD, 999, 7, 100)]] + [[] for _ in range(n - 1)]))
    st2, *_ = gossip_delta_drive(mesh, restored, slots, *batch)
    for _ in range(n):
        st2, *_ = gossip_delta_drive(mesh, st2, slots, *empty)
    want[999] = 7
    assert all(port_read(s) == want for s in lanes_of(st2))
    bad = dict(snap, layout="flat-v0")
    with pytest.raises(ValueError, match="engine layout"):
        restore_mesh(bad, cpu_mesh())
    with pytest.raises(ValueError, match="replicas but the mesh has"):
        restore_mesh(snap, cpu_mesh(4))


# ---------------------------------------------------------------------------
# two processes, one mesh

#: one rank of the two-process run (or the whole mesh when the world is
#: one process): identical host construction everywhere, each process
#: keeping its own shards; a seeded wave whose writer table starts
#: smaller than the replica count (so the drive must grow it across the
#: processes), then empty steps until nothing differs. Prints one line
#: per local shard: its index and the sha256 of its state's columns.
WORKER = textwrap.dedent(r'''
    import dataclasses, hashlib, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    if world > 1:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    from delta_crdt_ex_tpu_torch.models.binned import BinnedStore, to_numpy
    from delta_crdt_ex_tpu_torch.models.binned_map import group_batch
    from delta_crdt_ex_tpu_torch.ops.apply import OP_ADD, OP_PAD
    from delta_crdt_ex_tpu_torch.parallel import gossip_delta_drive, make_mesh, replica_sharding, stack_states
    from delta_crdt_ex_tpu_torch.utils.devices import process_allgather

    n, L = 8, 64
    per = n // world
    mesh = make_mesh(["cpu"] * n, ranks=[s // per for s in range(n)])
    states = []
    for i in range(n):
        st = BinnedStore.new(L, 8, 4, device="cpu")  # writer table undersized on purpose
        gid = st.ctx_gid.clone()
        gid[0] = (-(1 << 63) if i % 2 else 0) + 100 + i
        states.append(dataclasses.replace(st, ctx_gid=gid))
    stacked = replica_sharding(mesh).put(stack_states(states))

    def batches(ops_per_replica):
        groups = [group_batch(L, np.array([o[0] for o in ops], np.int32), np.array([o[1] for o in ops], np.uint64),
                              np.array([o[2] for o in ops], np.uint32), np.array([o[3] for o in ops], np.int64))
                  for ops in ops_per_replica]
        u = max(g.rows.shape[0] for g in groups)
        m = max(g.op.shape[1] for g in groups)
        out = [np.full((n, u), -1, np.int32), np.full((n, u, m), OP_PAD, np.int32), np.zeros((n, u, m), np.uint64),
               np.zeros((n, u, m), np.uint32), np.zeros((n, u, m), np.int64)]
        for i, g in enumerate(groups):
            gu, gm = g.op.shape
            out[0][i, :gu] = g.rows
            for a, src in zip(out[1:], (g.op, g.key, g.valh, g.ts)):
                a[i, :gu, :gm] = src
        return out

    slots = np.zeros(n, np.int32)
    grown = []
    seed = batches([[(OP_ADD, 1000 + 97 * i + j, i, 1 + i * 10 + j) for j in range(4)] for i in range(n)])
    stacked, roots, n_diff, retiers = gossip_delta_drive(
        mesh, stacked, slots, *seed, gather=process_allgather, on_grow=lambda st: grown.append(st.replica_capacity))
    empty = batches([[] for _ in range(n)])
    decay = [int(process_allgather(n_diff).max())]
    for _ in range(2 * n):
        stacked, roots, n_diff, r = gossip_delta_drive(
            mesh, stacked, slots, *empty, gather=process_allgather,
            on_grow=lambda st: grown.append(st.replica_capacity))
        retiers += r
        decay.append(int(process_allgather(n_diff).max()))
        if decay[-1] == 0:
            break
    assert decay[0] > 0 and decay[-1] == 0, decay
    assert max(grown, default=0) >= n, grown
    roots_all = process_allgather(roots)
    assert (roots_all == roots_all[0]).all(), roots_all
    for s in range(n):
        if mesh.local(s):
            cols = to_numpy(stacked.blocks[s])
            digest = hashlib.sha256(b"".join(np.ascontiguousarray(v).tobytes() for v in cols.values())).hexdigest()
            print(f"SHARD {s} {digest} retiers={retiers} decay={decay}", flush=True)
    if world > 1:
        dist.destroy_process_group()
''')


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(script: Path, world: int, timeout_s: float) -> list:
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(rank), str(world), port], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            outs.append((p.returncode, out, err))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _gloo_available() -> "tuple[bool, str]":
    dist = torch.distributed
    if not dist.is_available():
        return False, "torch.distributed is not built into this torch"
    if not dist.is_gloo_available():
        return False, "this torch has no gloo backend"
    return True, ""


def test_two_process_gloo_mesh_equals_one_process(tmp_path):
    """Two ranks with 4 shards each run one 8-shard mesh: rotations
    between the ranks are gloo send/recv pairs, the drive's decisions
    gather across them, and every shard ends with the bits the
    one-process 8-shard run gives."""
    ok, why = _gloo_available()
    if not ok:
        pytest.skip(f"gloo cannot start here: {why}")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    one = _run(script, 1, timeout_s=120)
    two = _run(script, 2, timeout_s=120)
    for rc, out, err in one + two:
        assert rc == 0, err[-3000:]
    shards = lambda outs: dict(
        line.split()[1:3] for _rc, out, _err in outs for line in out.splitlines() if line.startswith("SHARD")
    )
    want, got = shards(one), shards(two)
    assert len(want) == 8 and got == want
