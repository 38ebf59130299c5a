"""The probe-window point lookup: the port's plain ``probe_lookup_ref``
grid against the JAX Pallas kernel ``probe_lookup_pallas`` run in
interpret mode (the whole ``int32[Q, 8]`` grid: found, slot, node, ctr,
valh, ts halves and free_slot, not-found rows included; where the Pallas
kernel floors a winner word at -2^30 the test states that relation
exactly), and against
the jnp ``winners_for_keys`` on found rows — with windows at the table
end, dead lanes, several live dots of one key (equal timestamps, so the
gid and counter tie-breaks decide), top-bit keys and gids, and W = 256
(past the Pallas kernel's two-row cover).

The CUDA kernel itself runs only on the card: its test here skips, and
``chip_smoke.py`` holds it against ``probe_lookup_ref`` at full size.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_crdt_ex_tpu.models import hash_store as j_hs
from delta_crdt_ex_tpu.ops import hash_map as j_hm
from delta_crdt_ex_tpu_torch.models import hash_store as t_hs
from delta_crdt_ex_tpu_torch.ops import hash_map as t_hm
from tests.kernel_harness import HashKernelMap

#: gids with the top bit set, so the unsigned tie-break matters
GIDS = (0xF000000000000001, 0x7000000000000001, 0x8000000000000000, 5)

_pallas_interpret = jax.jit(partial(j_hm.probe_lookup_pallas, interpret=True))


def carry(state) -> t_hs.HashStore:
    cols = {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)
            if f.name != "probe_window"}
    return t_hs.from_numpy(cols, "cpu", probe_window=state.probe_window)


def concurrent_state(seed: int, capacity: int, n_keys: int, window: int | None = None):
    """A sink replica's table after merging three writers that wrote the
    same keys concurrently (equal timestamps) and removed a few: keys
    with several live dots, dead lanes, top-bit keys."""
    g = np.random.default_rng(seed)
    keys = g.integers(1, 2**62, n_keys).astype(np.uint64)
    keys[::2] |= np.uint64(1) << np.uint64(63)
    writers = [HashKernelMap(gid=gid, capacity=capacity, num_buckets=16) for gid in GIDS[:3]]
    for w_i, w in enumerate(writers):
        mine = keys[g.random(n_keys) < 0.6]
        w.batch([(1, int(k), int(g.integers(0, 2**32)), 7 + (int(k) % 3)) for k in mine])
        gone = mine[: len(mine) // 6]
        if len(gone):
            w.batch([(2, int(k), 0, 0) for k in gone])
    sink = HashKernelMap(gid=GIDS[3], capacity=capacity, num_buckets=16)
    for w in writers:
        sink.join_from(w)
    st = sink.state
    if window is not None:
        st, ok = j_hs.jit.rehash(st, table_size=st.table_size * 2, probe_window=window)
        assert bool(ok)
    return st, keys


def queries(st, keys, g) -> np.ndarray:
    """Every written key, missing keys, and keys whose window runs off
    the table end."""
    H, W = st.table_size, st.probe_window
    cand = g.integers(0, 2**63, 4096).astype(np.uint64) | np.uint64(1)
    base = np.asarray(j_hm.probe_base(jnp.asarray(cand), H))
    tail = cand[base + W > H][:16]
    miss = g.integers(0, 2**63, 16).astype(np.uint64)
    return np.concatenate([keys, miss, tail])


def grid_ref(st, q) -> np.ndarray:
    return t_hm.probe_lookup_ref(torch.from_numpy(q.view(np.int64).copy()), carry(st)).numpy()


#: the Pallas kernel reads the winner's columns as
#: ``max(where(cand, col, -2^30))``, so a winner word whose int32 bits lie
#: below -2^30 (a uint32 valh or ctr of 2^31 .. 3·2^30 - 1) comes back as
#: -2^30. The port returns the word itself, as the jnp ``winners_for_keys``
#: does; on every other word the two grids are equal.
_PALLAS_PICK_FLOOR = -(2**30)


@pytest.mark.parametrize("seed,capacity", [(0, 256), (1, 512), (2, 256)])
def test_probe_grid_matches_pallas_interpret(seed, capacity):
    st, keys = concurrent_state(seed, capacity, n_keys=40)
    assert st.table_size >= 256 and st.probe_window <= 128
    q = queries(st, keys, np.random.default_rng(seed))
    want = np.asarray(_pallas_interpret(jnp.asarray(q), st))
    got = grid_ref(st, q)
    assert got.dtype == np.int32 and got.shape == (len(q), 8)
    exact = [0, 1, 7]  # found, slot, free_slot
    assert np.array_equal(got[:, exact], want[:, exact])
    found = got[:, 0] == 1
    words = got[:, 2:7]
    assert np.array_equal(np.where(found[:, None], np.maximum(words, _PALLAS_PICK_FLOOR), words),
                          want[:, 2:7])
    assert (words[found] < _PALLAS_PICK_FLOOR).any()  # the case above really occurs
    # the scenario really has what it claims
    assert found.any() and (~found).any()
    assert (got[~found, 1] == -1).all() and (got[~found, 2:7] == 0).all()
    assert (got[:, 7] < st.table_size).any()
    alive = np.asarray(st.alive)
    key = np.asarray(st.key)
    assert max(int(((key == k) & alive).sum()) for k in keys) >= 2


@pytest.mark.parametrize("window", [None, 256])
def test_probe_winners_match_jnp_winners(window):
    st, keys = concurrent_state(3, 256, n_keys=40, window=window)
    q = queries(st, keys, np.random.default_rng(3))
    jw = j_hs.jit.winners_for_keys(st, jnp.asarray(q))
    tk = torch.from_numpy(q.view(np.int64).copy())
    tw = t_hm.probe_winners(carry(st), tk)
    ref = t_hm.winners_for_keys_ref(carry(st), tk)
    found = np.asarray(jw.found)
    assert np.array_equal(found, tw.found.numpy())
    assert found.any() and (~found).any()
    assert np.array_equal(np.asarray(jw.gid)[found], tw.gid.numpy().view(np.uint64)[found])
    for f in ("ctr", "valh", "ts"):
        assert np.array_equal(np.asarray(getattr(jw, f)).astype(np.int64)[found],
                              getattr(tw, f).numpy()[found]), f
    # the jnp path's plain port agrees everywhere, not-found rows included
    assert np.array_equal(np.asarray(jw.gid), ref.gid.numpy().view(np.uint64))
    for f in ("found", "ctr", "valh", "ts"):
        assert np.array_equal(np.asarray(getattr(jw, f)).astype(np.int64),
                              getattr(ref, f).numpy().astype(np.int64)), f


def test_no_free_lane_reports_sentinel():
    st = t_hs.HashStore.new(4, 16, 8, probe_window=8, device="cpu")
    st = dataclasses.replace(st, alive=torch.ones_like(st.alive))
    out = t_hm.probe_lookup_ref(torch.tensor([1, 2, -5]), st)
    assert (out[:, 7] == t_hm.NO_FREE).all()
    assert (out[:, 0] == 0).all() and (out[:, 1] == -1).all()


def test_cpu_tensors_take_the_plain_version():
    st, keys = concurrent_state(4, 256, n_keys=16)
    t_state = carry(st)
    q = torch.from_numpy(keys.view(np.int64).copy())
    before = t_hm.probe_lookup_kernel.launches
    assert torch.equal(t_hm.probe_lookup(q, t_state), t_hm.probe_lookup_ref(q, t_state))
    assert t_hm.probe_lookup_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        t_hm.probe_lookup_kernel(q, t_state)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernel is CUDA C++ and has no CPU mode")
    st, keys = concurrent_state(5, 512, n_keys=40)
    q = queries(st, keys, np.random.default_rng(5))
    dev = torch.device("cuda")
    t_state = t_hs.from_numpy(t_hs.to_numpy(carry(st)), dev)
    tq = torch.from_numpy(q.view(np.int64).copy()).to(dev)
    before = t_hm.probe_lookup_kernel.launches
    got = t_hm.probe_lookup(tq, t_state)
    assert t_hm.probe_lookup_kernel.launches == before + 1
    assert torch.equal(got.cpu(), t_hm.probe_lookup_ref(tq, t_state).cpu())
