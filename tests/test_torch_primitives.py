"""PyTorch port vs JAX package: the host hashing and the device
primitives the hash store shares with the binned engine.

Inputs come from a numpy seed and go through the JAX function and its
port counterpart; every integer column must agree bit for bit (keys and
gids with the top bit set included — a signed order would pick other
winners there).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.models import binned_map as j_bmap
from delta_crdt_ex_tpu.ops import binned as j_binned, dots as j_dots
from delta_crdt_ex_tpu.utils import hashing as j_hashing
from delta_crdt_ex_tpu_torch.models import binned_map as t_bmap
from delta_crdt_ex_tpu_torch.ops import binned as t_binned, dots as t_dots
from delta_crdt_ex_tpu_torch.utils import hashing as t_hashing

TERMS = [
    None, True, False, 0, 1, -1, 2**63, -(2**70), 3.5, -0.0, float("inf"),
    "", "key", "ключ", b"", b"\x00\xff", (1, "a"), [1, [2, (3,)]], {1, 2, 3},
    frozenset({"x"}), {"a": 1, "b": [None, 2.0]}, ((), [], {}), 12345678901234567890,
]


def u64(a) -> torch.Tensor:
    """uint64 numpy → the port's int64 bit pattern."""
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64).copy())


def i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def rand_u64(g, shape) -> np.ndarray:
    """uint64 values, half of them with the top bit set."""
    lo = g.integers(0, 2**63, shape, dtype=np.int64).view(np.uint64)
    top = (g.random(shape) < 0.5).astype(np.uint64) << np.uint64(63)
    return lo | top


@pytest.mark.parametrize("i", range(len(TERMS)))
def test_term_hashes_match(i):
    t = TERMS[i]
    assert t_hashing.canonical_bytes(t) == j_hashing.canonical_bytes(t)
    assert t_hashing.key_hash64(t) == j_hashing.key_hash64(t)
    assert t_hashing.value_hash32(t) == j_hashing.value_hash32(t)


def test_batch_hashes_match():
    assert np.array_equal(t_hashing.key_hash64_batch(TERMS), j_hashing.key_hash64_batch(TERMS))
    assert np.array_equal(t_hashing.value_hash32_batch(TERMS), j_hashing.value_hash32_batch(TERMS))
    assert t_hashing.key_hash64_batch(TERMS).dtype == np.uint64
    assert t_hashing.value_hash32_batch(TERMS).dtype == np.uint32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_hash(seed):
    g = np.random.default_rng(seed)
    n = 257
    key, gid = rand_u64(g, n), rand_u64(g, n)
    ctr = g.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    ts = g.integers(0, 2**62, n, dtype=np.int64)
    valh = g.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    want = np.asarray(j_binned.entry_hash(*map(jnp.asarray, (key, gid, ctr, ts, valh))))
    got = t_binned.entry_hash(u64(key), u64(gid), i64(ctr), i64(ts), i64(valh))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2**32


@pytest.mark.parametrize("num_leaves", [1, 2, 16, 64])
def test_tree_from_leaves(num_leaves):
    g = np.random.default_rng(num_leaves)
    leaf = g.integers(0, 2**32, num_leaves, dtype=np.int64).astype(np.uint32)
    want = j_binned.tree_from_leaves(jnp.asarray(leaf))
    got = t_binned.tree_from_leaves(i64(leaf))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy().astype(np.uint32))


def _lww_inputs(seed, k=64, b=12):
    """Rows with ties on ts (and on gid) so the unsigned gid and ctr
    tie-breaks decide; gids from a small pool with top-bit members."""
    g = np.random.default_rng(seed)
    pool = np.array([1, 2, 2**63, 2**63 + 1, 2**64 - 1, 0x7FFFFFFFFFFFFFFF], np.uint64)
    key = rand_u64(g, (k, b))
    key[:, : b // 2] = key[:, :1]  # runs of one key per row
    ts = g.integers(0, 3, (k, b)).astype(np.int64)
    gid = pool[g.integers(0, len(pool), (k, b))]
    ctr = g.integers(0, 4, (k, b)).astype(np.uint32)
    alive = g.random((k, b)) < 0.7
    valh = g.integers(0, 2**32, (k, b), dtype=np.int64).astype(np.uint32)
    return key, ts, gid, ctr, alive, valh


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_argmax_lww(seed):
    _key, ts, gid, ctr, alive, _valh = _lww_inputs(seed)
    want = np.asarray(j_binned._argmax_lww(*map(jnp.asarray, (ts, gid, ctr, alive))))
    got = t_binned._argmax_lww(i64(ts), u64(gid), i64(ctr), torch.from_numpy(alive))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sorted_winners(seed):
    key, ts, gid, ctr, alive, valh = _lww_inputs(seed)
    w_j = j_binned._sorted_winners(*map(jnp.asarray, (key, ts, gid, ctr, alive, valh)))
    w_t = t_binned._sorted_winners(
        u64(key), i64(ts), u64(gid), i64(ctr), torch.from_numpy(alive), i64(valh)
    )
    assert np.array_equal(np.asarray(w_j.win), w_t.win.numpy())
    assert np.array_equal(np.asarray(w_j.key), w_t.key.numpy().view(np.uint64))
    assert np.array_equal(np.asarray(w_j.ts), w_t.ts.numpy())
    assert np.array_equal(np.asarray(w_j.gid), w_t.gid.numpy().view(np.uint64))
    assert np.array_equal(np.asarray(w_j.ctr), w_t.ctr.numpy().astype(np.uint32))
    # dead entries tie on the whole sort key, so only live lanes' values
    # are determined by the order
    live = np.asarray(w_j.win)
    assert np.array_equal(np.asarray(w_j.valh)[live], w_t.valh.numpy()[live].astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_gid_tables(seed):
    g = np.random.default_rng(seed)
    pool = rand_u64(g, 6)
    gid_l = np.zeros(8, np.uint64)
    gid_l[: 3 + seed] = pool[: 3 + seed]
    gid_r = np.zeros(4, np.uint64)
    gid_r[:3] = pool[[1, 5, 4 - seed]]
    want = j_dots.merge_gid_tables(jnp.asarray(gid_l), jnp.asarray(gid_r))
    got = t_dots.merge_gid_tables(u64(gid_l), u64(gid_r))
    assert np.array_equal(np.asarray(want.ctx_gid), got.ctx_gid.numpy().view(np.uint64))
    assert np.array_equal(np.asarray(want.remap), got.remap.numpy())
    assert bool(want.overflow) == bool(got.overflow)


def test_encode_dot():
    node = np.array([0, 1, 7], np.int32)
    ctr = np.array([0, 2**32 - 1, 5], np.uint32)
    want = np.asarray(j_dots.encode_dot(jnp.asarray(node), jnp.asarray(ctr)))
    got = t_dots.encode_dot(torch.from_numpy(node), i64(ctr))
    assert np.array_equal(got.numpy().view(np.uint64), want)


def test_group_batch():
    g = np.random.default_rng(3)
    n = 50
    op = g.choice([1, 1, 2], n).astype(np.int32)
    key = rand_u64(g, n)
    valh = g.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    ts = np.arange(n, dtype=np.int64)
    a = j_bmap.group_batch(16, op, key, valh, ts)
    b = t_bmap.group_batch(16, op, key, valh, ts)
    for c in ("rows", "op", "key", "valh", "ts"):
        assert np.array_equal(getattr(a, c), getattr(b, c))
        assert getattr(a, c).dtype == getattr(b, c).dtype
    assert all(np.array_equal(x, y) for x, y in zip(a.index, b.index))


def _wire_dict(g, rows, lanes, gids):
    u = len(rows)
    return {
        "rows": np.asarray(rows, np.int32),
        "key": rand_u64(g, (u, lanes)),
        "valh": g.integers(0, 2**32, (u, lanes), dtype=np.int64).astype(np.uint32),
        "ts": g.integers(0, 100, (u, lanes)).astype(np.int64),
        "node": g.integers(0, len(gids), (u, lanes)).astype(np.int32),
        "ctr": g.integers(0, 100, (u, lanes)).astype(np.uint32),
        "alive": g.random((u, lanes)) < 0.6,
        "ctx_rows": g.integers(0, 100, (u, len(gids))).astype(np.uint32),
        "ctx_lo": np.zeros((u, len(gids)), np.uint32),
        "ctx_gid": np.asarray(gids, np.uint64),
    }


def test_combine_entry_arrays():
    g = np.random.default_rng(4)
    arrays = [
        _wire_dict(g, [1, 5], 4, [2**63 + 9, 0]),
        _wire_dict(g, [2, 7, 9], 4, [7, 2**63 + 9, 0, 0]),
    ]
    sl_j, off_j = j_bmap.combine_entry_arrays(arrays)
    sl_t, off_t = t_bmap.combine_entry_arrays(arrays, "cpu")
    assert off_j == off_t
    wire = t_binned.WIRE_DTYPES
    for c in t_binned.RowSlice._fields:
        got = getattr(sl_t, c).numpy()
        got = got.view(np.uint64) if wire[c] == np.uint64 else got.astype(wire[c])
        assert np.array_equal(np.asarray(getattr(sl_j, c)), got), c


def test_slice_wire_round_trip():
    g = np.random.default_rng(5)
    a = _wire_dict(g, [3, -1], 8, [2**64 - 1, 4])
    sl = t_binned.slice_from_wire(a, "cpu")
    host = {c: getattr(sl, c).numpy() for c in t_binned.RowSlice._fields}
    back = t_binned.wire_from_host(host)
    for c, v in a.items():
        assert back[c].dtype == v.dtype and np.array_equal(back[c], v), c
