"""The digest-tree roots: the port's ``batched_roots`` on CPU tensors
(its plain version, ``batched_roots_ref``) against the JAX Pallas
kernel ``batched_roots_pallas`` run in interpret mode, as
``tests/test_pallas_tree.py`` runs it, and against the JAX
``tree_from_leaves`` at the sizes the Pallas kernel does not take
(L < 128). Leaves have the top bit set in half the words; swapping two
sibling leaves must change the root.

The CUDA kernel splits each tree into aligned runs (C cluster blocks,
2048-leaf tiles, warps, 8-leaf rows) and folds the runs' roots again;
that this gives the whole root is held here on the CPU, for the plain
fold and for a model of the kernel's nesting. The kernel itself runs
only on the card: its tests here skip, and ``chip_smoke.py`` holds it
against ``batched_roots_ref``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.ops.binned import tree_from_leaves
from delta_crdt_ex_tpu.ops.pallas_tree import batched_roots_pallas
from delta_crdt_ex_tpu_torch.ops import roots as t_roots
from delta_crdt_ex_tpu_torch.ops.binned import _P1, _P2, M32, _mix32


def leaves(seed: int, n: int, L: int) -> np.ndarray:
    """uint32[n, L], half the words with the top bit set."""
    g = np.random.default_rng(seed)
    lo = g.integers(0, 2**31, (n, L), dtype=np.int64)
    return (lo | (g.integers(0, 2, (n, L)) << 31)).astype(np.uint32)


def port(a: np.ndarray) -> np.ndarray:
    return t_roots.batched_roots(torch.from_numpy(a.astype(np.int64))).numpy()


@pytest.mark.parametrize("n, L", [(3, 256), (8, 512), (11, 128)])
def test_roots_match_pallas_interpret(n, L):
    a = leaves(n * L, n, L)
    assert (a >= 2**31).any()
    want = np.asarray(batched_roots_pallas(jnp.asarray(a), interpret=True))
    got = port(a)
    assert got.dtype == np.int64 and got.shape == (n,)
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("L", [1, 2, 64])
def test_roots_match_jax_tree_from_leaves(L):
    a = leaves(L, 5, L)
    want = [int(tree_from_leaves(jnp.asarray(row))[0][0]) for row in a]
    assert port(a).tolist() == want
    if L == 1:
        assert port(a).tolist() == a[:, 0].tolist()  # one leaf is its own root


@pytest.mark.parametrize("L", [2, 64, 128])
def test_sibling_order_changes_the_root(L):
    a = np.zeros((2, L), np.uint32)
    a[0, 0] = a[1, 1] = 7
    got = port(a)
    assert got[0] != got[1]
    assert got.tolist() == [int(tree_from_leaves(jnp.asarray(row))[0][0]) for row in a]


def test_cpu_tensors_take_the_plain_version():
    x = torch.from_numpy(leaves(9, 4, 256).astype(np.int64))
    before = t_roots.batched_roots_kernel.launches
    assert torch.equal(t_roots.batched_roots(x), t_roots.batched_roots_ref(x))
    assert t_roots.batched_roots_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        t_roots.batched_roots_kernel(x)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("n, L", [(3, 8), (5, 64), (2, 1024)])
def test_cluster_runs_fold_to_the_root(n, L, C):
    """The C aligned runs of L/C leaves that a cluster's blocks fold,
    folded again in rank order, give the tree's root."""
    a = torch.from_numpy(leaves(n * L + C, n, L).astype(np.int64))
    runs = t_roots.batched_roots_ref(a.reshape(n * C, L // C)).reshape(n, C)
    got = t_roots.batched_roots_ref(runs)
    assert torch.equal(got, t_roots.batched_roots_ref(a))
    assert got.tolist() == [int(tree_from_leaves(jnp.asarray(row.numpy().astype(np.uint32)))[0][0]) for row in a]


def _combine(left, right):
    return (_mix32(left ^ _P1) + (_mix32(right ^ _P2) << 1) + 0x9E3779B9) & M32


def _lane_fold(v, lanes: int):
    """``warp_fold``: at distance d, lane i (a multiple of 2d) combines
    its value, as the left operand, with lane i + d's; lane 0 ends with
    the root of the last axis."""
    v = v.clone()
    d = 1
    while d < lanes:
        i = torch.arange(0, lanes, 2 * d)
        v[..., i] = _combine(v[..., i], v[..., i + d])
        d *= 2
    return v[..., 0]


def kernel_order_roots(leaf, C: int, tile_max: int = 2048, run_max: int = 8):
    """A plain model of ``csrc/roots.cu``'s order of folds: each of C
    blocks takes L/C leaves as tiles of up to 2048 leaves; a thread
    folds an 8-leaf row, a warp its 32 rows, warp 0 the tile's warp
    roots; tile roots merge through a binary-counter stack; rank 0 folds
    the C run roots."""
    n, L = leaf.shape
    span = L // C
    if span == 1:
        run_roots = leaf.reshape(n, C)
    else:
        tile = min(span, tile_max)
        run = min(tile, run_max)
        rows = tile // run
        lanes = min(rows, 32)
        x = leaf.reshape(n, C, span // tile, rows // lanes, lanes, run)
        tile_roots = _lane_fold(_lane_fold(_lane_fold(x, run), lanes), rows // lanes)
        stack: dict = {}
        for i in range(span // tile):
            r, b = tile_roots[..., i], 0
            while (i >> b) & 1:
                r = _combine(stack[b], r)
                b += 1
            stack[b] = r
        run_roots = r
    return _lane_fold(run_roots, C)


@pytest.mark.parametrize("L, C", [(L, C) for L in (1, 2, 8, 64, 4096, 1 << 14) for C in (1, 2, 8) if C <= L])
def test_kernel_fold_order_model(L, C):
    a = torch.from_numpy(leaves(L + 3 * C, 3, L).astype(np.int64))
    assert torch.equal(kernel_order_roots(a, C), t_roots.batched_roots_ref(a))


def test_cluster_size_fills_the_card():
    sms = 132
    assert [t_roots.cluster_size(n, 1 << 14, sms) for n in (1, 8, 64, 133, 4096)] == [8, 8, 8, 2, 1]
    assert [t_roots.cluster_size(64, L, sms) for L in (1, 2, 4)] == [1, 2, 4]
    for n in (1, 11, 64, 133, 4096):
        c = t_roots.cluster_size(n, 1 << 14, sms)
        assert c == 8 or n * c >= 2 * sms
        assert c == 1 or n * c // 2 < 2 * sms


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the roots kernel is CUDA C++ and has no CPU mode")
    for n, L in [(1, 1), (11, 2), (64, 128), (7, 1 << 14), (3, 1 << 20)]:
        x = torch.from_numpy(leaves(n + L, n, L).astype(np.int64)).cuda()
        before = t_roots.batched_roots_kernel.launches
        got = t_roots.batched_roots(x)
        assert t_roots.batched_roots_kernel.launches == before + 1
        assert torch.equal(got.cpu(), t_roots.batched_roots_ref(x.cpu())), (n, L)
    # every cluster size where the design has edges
    for n in (1, 11, 133, 4096):
        for L in (1, 2, 4, 8, 16, 128, 1 << 14, 1 << 20):
            if n * L > 1 << 26:
                continue
            x = torch.from_numpy(leaves(n * 7 + L, n, L).astype(np.int64)).cuda()
            want = t_roots.batched_roots_ref(x)
            for c in (1, 2, 4, 8):
                if c <= L:
                    assert torch.equal(t_roots.batched_roots_kernel(x, cluster=c), want), (n, L, c)
    # the two leaves either side of each cluster boundary, swapped
    for L in (16, 1 << 14):
        for c in (2, 4, 8):
            x = torch.zeros((2, L), dtype=torch.int64, device="cuda")
            x[0, L // c - 1] = x[1, L // c] = 0xDEADBEEF
            r = t_roots.batched_roots_kernel(x, cluster=c)
            assert int(r[0]) != int(r[1]) and torch.equal(r, t_roots.batched_roots_ref(x))
