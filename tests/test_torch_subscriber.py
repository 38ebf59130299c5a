"""PyTorch port vs JAX package: the ``on_diffs`` change feed
(``tests/test_subscriber.py``), on both stores.

The reference's emission rules: a callable or the ``(fn, extra_args)``
tuple (the MFA form, extra args first); a no-op write is silent; a
``None`` value emits a remove; removing an absent key is silent; one
bundle per sync round; replaying the feed rebuilds the map. Every script
runs on a JAX replica and a port replica (``Side``); each feed must
equal the JAX replica's, bundle for bundle.
"""

from __future__ import annotations

import random

import pytest

from tests.test_torch_lattice import jax_compiles_released  # noqa: F401 (autouse)
from tests.test_torch_runtime_property import assert_twins, both


@pytest.fixture(params=["binned", "hash"])
def sides(request):
    pair = both(request.param)
    yield pair
    for side in pair:
        side.close()


def feeds_of(sides, script) -> list:
    """Run ``script(side, log)`` on both sides; the port's feed must be the
    JAX feed. Returns the feed."""
    logs = []
    for side in sides:
        log: list = []
        script(side, log)
        logs.append(log)
    assert logs[1] == logs[0]
    return logs[0]


def test_on_diffs_as_function(sides):
    def script(side, seen):
        c = side.mk(on_diffs=seen.append)
        c.mutate("add", ["Derek", "Kraan"])
        assert seen == [[("add", "Derek", "Kraan")]]
        c.mutate("remove", ["Derek"])

    assert feeds_of(sides, script) == [[("add", "Derek", "Kraan")], [("remove", "Derek")]]


def test_on_diffs_as_mfa_tuple(sides):
    """The ``{m, f, a}`` form: the extra args come first."""

    def script(side, seen):
        c = side.mk(on_diffs=(lambda tag, diffs: seen.append((tag, diffs)), ["tagged"]))
        c.mutate("add", ["Derek", "Kraan"])
        c.mutate("add", ["Derek", None])

    assert feeds_of(sides, script) == [("tagged", [("add", "Derek", "Kraan")]), ("tagged", [("remove", "Derek")])]


def test_noop_write_emits_no_diff(sides):
    def script(side, seen):
        c = side.mk(on_diffs=seen.append)
        c.mutate("add", ["Derek", "Kraan"])
        c.mutate("add", ["Derek", "Kraan"])  # new dot, same read: silent

    assert feeds_of(sides, script) == [[("add", "Derek", "Kraan")]]
    assert_twins(*sides)


def test_add_nil_value_emits_remove_diff(sides):
    def script(side, seen):
        c = side.mk(on_diffs=seen.append)
        c.mutate("add", ["Derek", "Kraan"])
        c.mutate("add", ["Derek", None])

    assert feeds_of(sides, script) == [[("add", "Derek", "Kraan")], [("remove", "Derek")]]


def test_remove_of_absent_key_is_silent(sides):
    def script(side, seen):
        c = side.mk(on_diffs=seen.append)
        c.mutate("remove", ["never-added"])

    assert feeds_of(sides, script) == []
    assert_twins(*sides)


def test_diffs_bundle_per_sync_round(sides):
    """Remote deltas of one sync round land in one callback."""

    def script(side, seen):
        c1 = side.mk()
        c2 = side.mk(on_diffs=seen.append)
        for i in range(8):
            c1.mutate_async("add", [f"k{i}", i])
        c1.flush()
        c1.set_neighbours([c2])
        side.converge()

    seen = feeds_of(sides, script)
    flat = [d for bundle in seen for d in bundle]
    assert sorted(flat) == sorted(("add", f"k{i}", i) for i in range(8))
    assert 1 <= len(seen) < len(flat)
    assert_twins(*sides)


def test_replaying_diffs_reconstructs_map(sides):
    """A subscriber folding the feed into a dict ends with the replica's
    read (``delta_subscriber_test.exs:79-133``)."""
    replays = []

    def script(side, seen):
        rng = random.Random(7)
        replay: dict = {}

        def apply_diffs(diffs):
            seen.append(diffs)
            for d in diffs:
                if d[0] == "add":
                    replay[d[1]] = d[2]
                else:
                    replay.pop(d[1], None)

        c1 = side.mk(capacity=256)
        c2 = side.mk(capacity=256, on_diffs=apply_diffs)
        c1.set_neighbours([c2])
        c2.set_neighbours([c1])
        keys = [f"key-{i}" for i in range(12)]
        for step in range(60):
            k = rng.choice(keys)
            writer = rng.choice([c1, c2])
            if rng.random() < 0.7:
                writer.mutate("add", [k, rng.randrange(1000)])
            else:
                writer.mutate("remove", [k])
            if step % 10 == 9:
                side.converge()
        side.converge()
        assert c1.read() == c2.read() == replay
        replays.append(replay)

    feeds_of(sides, script)
    assert replays[0] == replays[1]
    assert_twins(*sides)
