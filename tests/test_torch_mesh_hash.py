"""The mesh fleet on the hash store, PyTorch port against the JAX
package (``tests/test_mesh_fleet.py``'s case): the port's hash-store
mesh fleet gossiping among its members is bit-equal to the JAX mesh
fleet at shards 2 and 8 and to its own vmap fleet (canonical state
bytes, reads, seqs, WAL segment bytes, in-flight slots, transfer
counts). The binned store's runs are in ``tests/test_torch_mesh_fleet.py``.
"""

from __future__ import annotations

import pytest

from tests.test_torch_mesh_fleet import check_intra_parity


@pytest.mark.parametrize("shards", [2, 8])
def test_mesh_hash_fleet_bit_equal_to_jax_mesh_fleet(shards, tmp_path):
    check_intra_parity("hash", shards, tmp_path)
