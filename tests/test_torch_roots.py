"""The digest-tree roots: the port's ``batched_roots`` on CPU tensors
(its plain version, ``batched_roots_ref``) against the JAX Pallas
kernel ``batched_roots_pallas`` run in interpret mode, as
``tests/test_pallas_tree.py`` runs it, and against the JAX
``tree_from_leaves`` at the sizes the Pallas kernel does not take
(L < 128). Leaves have the top bit set in half the words; swapping two
sibling leaves must change the root.

The CUDA kernel itself runs only on the card: its test here skips, and
``chip_smoke.py`` holds it against ``batched_roots_ref``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.ops.binned import tree_from_leaves
from delta_crdt_ex_tpu.ops.pallas_tree import batched_roots_pallas
from delta_crdt_ex_tpu_torch.ops import roots as t_roots


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
