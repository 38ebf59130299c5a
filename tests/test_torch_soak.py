"""PyTorch port vs JAX package: the seeded soak (``tests/test_soak.py``).

One seeded history of writes, removes, clears, partitions, heals and
crash-rehydrates drives a JAX cluster and a port cluster op for op
(``Side``), on both stores. At every heal each replica of each package
reads the dict oracle; at the end the port's replicas hold the JAX
replicas' canonical bytes. The pinned miniature pins every other replica
to a device (the port's ``"cpu:0"``; the JAX test's mesh devices): the
device data plane must survive partitions, rehydrates and mixed planes.
The medium and the full soak run with ``RUN_SOAK=1`` (the full soak is
gated so in JAX too; the medium one, with its JAX twin, takes minutes).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from tests.test_soak import _soak_device
from tests.test_torch_lattice import jax_compiles_released  # noqa: F401 (autouse)
from tests.test_torch_runtime_property import NODE_IDS, Side


def _device(side: Side, i: int, pin: bool):
    if not pin or i % 2:
        return None
    return _soak_device(i, True) if side.pkg == "jax" else "cpu:0"


def _mk(side: Side, i: int, seed: int, storage, pin: bool):
    opts = {**side.opts, "name": f"soak{seed}-{i}", "node_id": NODE_IDS[i], "storage_module": storage}
    dev = _device(side, i, pin)
    if dev is not None:
        opts["device"] = dev
    return side.dc.start_link(side.dc.AWLWWMap, **opts)


def run_soak(store: str, n_replicas: int, n_ops: int, seed: int, pin: bool = False):
    """``tests/test_soak.py:_run_soak``'s history on both packages in
    lockstep. Returns the final model."""
    rng = np.random.default_rng(seed)
    sides = [Side(pkg, store, capacity=256, tree_depth=6) for pkg in ("jax", "port")]
    storages = [side.MemoryStorage() for side in sides]
    reps = [[_mk(s, i, seed, st, pin) for i in range(n_replicas)] for s, st in zip(sides, storages)]

    def rewire(partition: set):
        for rs in reps:
            for i, r in enumerate(rs):
                side_of = i in partition
                r.set_neighbours([x for j, x in enumerate(rs) if x is not r and (j in partition) == side_of])

    def converge(rounds=8):
        for s, rs in zip(sides, reps):
            s.converge(rs, rounds)

    def check(what):
        converge()
        for s, rs in zip(sides, reps):
            for i, r in enumerate(rs):
                assert r.read() == model, (s.pkg, seed, what, i)

    rewire(set())
    model: dict = {}
    partitioned: set = set()
    try:
        for step in range(n_ops):
            who = int(rng.integers(0, n_replicas))
            op = rng.random()
            key = int(rng.integers(1, 40))
            if partitioned and op >= 0.62:  # only adds keep the dict exact under a partition
                op = op * 0.62 if op < 0.86 else op
            if op < 0.62:
                val = int(rng.integers(0, 1000))
                for rs in reps:
                    rs[who].mutate("add", [key, val])
                model[key] = val
            elif op < 0.82:
                converge()  # a remove is dict-exact once the remover saw every dot
                for rs in reps:
                    rs[who].mutate("remove", [key])
                model.pop(key, None)
            elif op < 0.86:
                converge()
                for rs in reps:
                    rs[who].mutate("clear", [])
                model.clear()
            elif op < 0.92 and not partitioned:
                k = int(rng.integers(1, n_replicas))
                partitioned = {int(x) for x in rng.choice(n_replicas, k, replace=False)}
                rewire(partitioned)
            elif op < 0.96 and partitioned:
                partitioned = set()
                rewire(partitioned)
            else:
                victim = int(rng.integers(0, n_replicas))
                for s, st, rs in zip(sides, storages, reps):
                    s.transport.unregister(rs[victim].addr)  # the crash: no goodbye sync
                    rs[victim] = _mk(s, victim, seed, st, pin)
                rewire(partitioned)
            if not partitioned and (step % 7 == 0 or step == n_ops - 1):
                check(step)
        if partitioned:
            rewire(set())
        converge(10)
        check("final")
        for a, b in zip(*reps):
            assert b.canonical_state_bytes() == a.canonical_state_bytes(), seed
        return model
    finally:
        for s, rs in zip(sides, reps):
            for r in rs:
                try:
                    r.stop()
                except Exception:
                    pass
            s.MemoryStorage.clear()


@pytest.fixture(params=["binned", "hash"])
def store(request):
    return request.param


def test_soak_miniature(store):
    """3 replicas, 40 ops, seed 11."""
    run_soak(store, 3, 40, seed=11)


def test_soak_miniature_device_pinned(store):
    """Seed 12 with every other replica pinned."""
    run_soak(store, 3, 40, seed=12, pin=True)


@pytest.mark.skipif(os.environ.get("RUN_SOAK") != "1", reason="set RUN_SOAK=1")
@pytest.mark.parametrize("seed", [31, 32])
def test_soak_medium(store, seed):
    """The JAX medium soak (6 replicas, 300 ops a seed, every other
    replica pinned); with the JAX twin it takes minutes, so it runs with
    the full soak."""
    run_soak(store, 6, 300, seed=seed, pin=True)


@pytest.mark.skipif(os.environ.get("RUN_SOAK") != "1", reason="set RUN_SOAK=1")
@pytest.mark.parametrize("seed,pin", [(1, False), (2, False), (3, False), (4, True)])
def test_soak_full(store, seed, pin):
    """6 replicas, 600 ops a seed; seed 4 with every other replica pinned."""
    run_soak(store, 6, 600, seed=seed, pin=pin)
