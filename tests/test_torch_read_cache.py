"""PyTorch port vs JAX package: the incremental full-read cache
(``tests/test_read_cache.py``), on both stores.

Local flushes keep the read dict up to date while it is complete; a
remote merge drops it and the next full read rebuilds it through the
winner pass. Every case runs its script on a JAX replica and on a port
replica (``Side``), and checks on each what the JAX test checks: the
cache equals a full pass, is dropped and rebuilt where JAX drops and
rebuilds it, and both packages read the same and hold the same bytes.
A ``hypothesis`` property drives generated batches, Python-equal key
terms and remote merges through both packages' caches.
"""

from __future__ import annotations

import pytest
from hypothesis import given, settings, strategies as st

from tests.test_torch_lattice import PROPERTY, jax_compiles_released  # noqa: F401 (autouse)
from tests.test_torch_runtime_property import assert_twins, both


@pytest.fixture(params=["binned", "hash"])
def sides(request):
    pair = both(request.param)
    yield pair
    for side in pair:
        side.close()


def test_maintained_cache_matches_full_pass(sides):
    for side in sides:
        c = side.mk()
        for i in range(50):
            c.mutate_async("add", [f"k{i}", i])
        for i in range(0, 50, 3):
            c.mutate_async("remove", [f"k{i}"])
        c.mutate_async("add", ["k1", "overwritten"])
        assert c.read() == side.full_pass_read(c)
        assert c._read_cache is not None  # maintained, not rebuilt
        c.mutate_async("add", ["pre", 1])
        c.mutate_async("clear", [])  # shadows everything before it in the batch
        c.mutate_async("add", ["post", 2])
        assert c.read() == {"post": 2} == side.full_pass_read(c)
    assert_twins(*sides)


def test_local_add_after_merge_observes_remote_dot(sides):
    """b's clock is far ahead, yet a later local add on a wins: an add
    kills every observed dot of its key."""
    for side in sides:
        a = side.mk(clock=side.Clock())
        b = side.mk(clock=side.Clock(start=1_000_000))
        b.mutate("add", ["k", "remote"])
        b.set_neighbours([a])
        side.converge([b])
        assert a.read() == {"k": "remote"}  # the merge dropped the cache; the read rebuilt it
        a.mutate("add", ["k", "local-observed-remove"])
        assert a.read() == {"k": "local-observed-remove"} == side.full_pass_read(a)
    assert_twins(*sides)


def test_cache_resumes_after_merge_rebuild(sides):
    for side in sides:
        a, b = side.mk(), side.mk()
        b.mutate("add", ["remote-key", "rv"])
        b.set_neighbours([a])
        side.converge([b])
        assert a._read_cache is None  # the merge dropped it
        assert a.read() == {"remote-key": "rv"}  # the rebuild primes it
        assert a._read_cache is not None
        a.mutate("add", ["local-key", 1])  # maintained again
        assert a._read_cache is not None
        assert a.read() == {"remote-key": "rv", "local-key": 1} == side.full_pass_read(a)
    assert_twins(*sides)


def test_cache_rebuilt_after_rehydrate(sides):
    for side in sides:
        storage = side.MemoryStorage()
        c = side.mk(storage_module=storage, name="rc-rehydrate")
        c.mutate("add", ["k", 1])
        side.transport.unregister("rc-rehydrate")  # a crash: no stop()
        side.replicas.remove(c)
        c2 = side.mk(storage_module=storage, name="rc-rehydrate", node_id=c.node_id)
        assert c2._read_cache is None
        c2.mutate("add", ["j", 2])
        assert c2.read() == {"k": 1, "j": 2} == side.full_pass_read(c2)
    assert_twins(*sides)


def test_python_equal_distinct_terms(sides):
    """1 and True are ==-equal in Python but distinct keys: the dict view
    collapses them, the latest write's value wins the collapse, and the
    cache stays off until the alias is gone."""
    for side in sides:
        c = side.mk()
        c.mutate("add", [1, "int-first"])
        c.mutate("add", [True, "bool-second"])
        assert c._read_cache is None  # the alias dropped maintenance
        assert c.read() == {1: "bool-second"}
        items = sorted(c.read_items(), key=lambda kv: kv[1])
        assert items == [(True, "bool-second"), (1, "int-first")]
        assert [type(k) for k, _v in items] == [bool, int]
        c.mutate("add", ["other", 3])
        assert c.read() == {1: "bool-second", "other": 3}
        c.mutate("remove", [True])
        final = c.read()
        assert final == {1: "int-first", "other": 3}
        assert type(next(k for k in final if k == 1)) is int  # the int term, not True
        assert c._read_cache_kh is not None  # maintenance resumed
    assert_twins(*sides)


def test_unhashable_key_disables_cache(sides):
    for side in sides:
        c = side.mk()
        c.mutate("add", [["unhashable", "list"], 1])
        with pytest.raises(TypeError, match="unhashable"):
            c.read()
        assert c.read_items() == [(["unhashable", "list"], 1)]
        c.mutate("add", ["plain", 2])  # the cache stays off; reads stay exact
        want = [(["unhashable", "list"], 1), ("plain", 2)]
        assert sorted(c.read_items(), key=repr) == sorted(want, key=repr)
    j, t = sides
    for a, b in zip(j.replicas, t.replicas):
        assert b.canonical_state_bytes() == a.canonical_state_bytes()



#: key terms, Python-equal ones among them (1, True and 1.0 are one dict
#: key but three CRDT keys)
TERMS = [1, True, 1.0, 0, False, "k", ("t", 1), b"b"]


@settings(max_examples=20, **PROPERTY)
@given(
    st.lists(
        st.lists(
            st.tuples(
                st.sampled_from(["add", "add", "add", "remove", "clear", "remote"]),
                st.integers(0, len(TERMS) - 1),
                st.integers(0, 9),
            ),
            min_size=1,
            max_size=6,
        ),
        max_size=6,
    )
)
def test_cache_matches_full_pass_over_generated_batches(batches):
    """Batches of queued mutations (Python-equal key terms among them) and
    remote writes merged between them: after each batch the read equals
    a full winner pass, on both packages, and both read alike."""
    for store in ("binned", "hash"):
        sides = both(store)
        try:
            reads = []
            for side in sides:
                c, peer = side.mk(), side.mk()
                peer.set_neighbours([c])
                got = []
                for batch in batches:
                    for op, t, v in batch:
                        if op == "add":
                            c.mutate_async("add", [TERMS[t], v])
                        elif op == "remove":
                            c.mutate_async("remove", [TERMS[t]])
                        elif op == "clear":
                            c.mutate_async("clear", [])
                        else:
                            c.flush()
                            peer.mutate("add", [TERMS[t], -v])
                            side.converge([peer], rounds=3)
                    r = c.read()
                    assert r == side.full_pass_read(c), (side.pkg, store)
                    got.append((r, sorted(map(repr, c.read_items()))))
                reads.append(got)
            assert reads[1] == reads[0], store
            assert_twins(*sides)
        finally:
            for side in sides:
                side.close()
