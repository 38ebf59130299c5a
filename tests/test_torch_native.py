"""The port's native batch hasher (``delta_crdt_ex_tpu_torch/native``):
bit for bit the port's per-term ``hashlib`` path and the JAX package's
``key_hash64``/``value_hash32``, on ``tests/test_native.py``'s terms;
built from the repo's own ``fasthash.cpp`` into ``build/native/``, never
into the package; a failed build raises; every term it hashes is
counted."""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np
import pytest

from delta_crdt_ex_tpu.utils.hashing import key_hash64 as j_key_hash64
from delta_crdt_ex_tpu.utils.hashing import value_hash32 as j_value_hash32
from delta_crdt_ex_tpu_torch import native
from delta_crdt_ex_tpu_torch.utils import hashing as t_hashing

REPO = Path(__file__).resolve().parents[1]


def edge_terms():
    """``tests/test_native.py``'s terms: the empty string, one block, a
    block plus one, nested terms, 200 seeded random byte strings."""
    rng = random.Random(7)
    return [
        "",
        "x",
        b"\x00" * 128,  # exactly one block
        b"\x01" * 129,  # block boundary + 1
        ("tuple", 1, 2.5, None),
        list(range(50)),
        {"k": {"nested": [1, 2, 3]}},
    ] + [rng.randbytes(rng.randint(0, 1000)) for _ in range(200)]


VALUE_TERMS = ["a", 1, None, b"bytes", (1, 2), {"x": 1}] + [f"v{i}" for i in range(100)]


@pytest.mark.parametrize("terms", [edge_terms(), VALUE_TERMS], ids=["edge", "values"])
def test_key_hash64_batch_matches_hashlib_and_jax(terms):
    got = t_hashing.key_hash64_batch(terms)
    assert got.dtype == np.uint64 and got.shape == (len(terms),)
    assert np.array_equal(got, t_hashing.key_hash64_batch_ref(terms))
    assert np.array_equal(got, np.array([j_key_hash64(t) for t in terms], np.uint64))


@pytest.mark.parametrize("terms", [edge_terms(), VALUE_TERMS], ids=["edge", "values"])
def test_value_hash32_batch_matches_hashlib_and_jax(terms):
    got = t_hashing.value_hash32_batch(terms)
    assert got.dtype == np.uint32 and got.shape == (len(terms),)
    assert np.array_equal(got, t_hashing.value_hash32_batch_ref(terms))
    assert np.array_equal(got, np.array([j_value_hash32(t) for t in terms], np.uint32))


def test_empty_batches_and_the_counter():
    for fn, dtype in ((t_hashing.key_hash64_batch, np.uint64), (t_hashing.value_hash32_batch, np.uint32)):
        out = fn([])
        assert out.dtype == dtype and out.shape == (0,)
    before = native.counts()
    t_hashing.key_hash64_batch(["a", "b", "c"])
    t_hashing.value_hash32_batch([1, 2])
    t_hashing.key_hash64_batch_ref(["a"])  # the plain version counts nothing
    after = native.counts()
    assert {k: after[k] - before[k] for k in after} == {"hash64": 3, "hash32": 2}
    native.reset_counts()
    assert native.counts() == {"hash64": 0, "hash32": 0}


def test_the_build_lands_under_build_native():
    path, _ = native.build()
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libfasthash-") and path.suffix == ".so"
    assert native.SRC == REPO / "delta_crdt_ex_tpu_torch" / "native" / "fasthash.cpp"
    assert not list((REPO / "delta_crdt_ex_tpu_torch").rglob("*.so"))
    assert native.build() == (path, "")  # built once, then reused


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "fasthash.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").glob("*"))
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    monkeypatch.setattr(native, "SRC", Path(__file__))  # a new digest: no library built for it
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
