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

The CUDA kernel's design (a group of G threads per query, each keeping
the best of its 4-lane chunks, a width-G shuffle butterfly, the owner
of the winning lane writing node and valh from its registers) is held
here as a plain model against ``probe_lookup_ref``. The kernel itself
runs only on the card: its tests here skip, and ``chip_smoke.py`` holds
it against ``probe_lookup_ref`` at full size.
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
from delta_crdt_ex_tpu_torch.utils import probe_tables
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


def _better(a, b) -> bool:
    """``a`` beats ``b`` under the kernel's order: ts signed, gid
    unsigned, ctr unsigned, then the lower slot; slot -1 = none."""
    if a[3] < 0:
        return False
    if b[3] < 0:
        return True
    if a[:3] != b[:3]:
        return a[:3] > b[:3]
    return a[3] < b[3]


#: threads per query the model is run at: every group the kernel can pick
GROUPS = (1, 2, 4, 8, 16, 32)


def group_model(q: np.ndarray, state: t_hs.HashStore, G: int) -> np.ndarray:
    """A plain model of the CUDA kernel's reduction: per query, each of
    G threads keeps the best of its 4-lane chunks (chunk c on thread
    c mod G) and its lowest dead lane; a width-G xor butterfly combines
    them; the thread whose own best is the winner writes the row with
    its own node and valh, thread 0 when nothing matched. The grid does
    not depend on G, so the model holds whichever G the kernel picks."""
    H, W, R = state.table_size, state.probe_window, state.replica_capacity
    key = state.key.numpy().view(np.uint64)
    alive = state.alive.numpy()
    node = state.node.numpy()
    ctr = state.ctr.numpy().view(np.uint64)
    ts = state.ts.numpy()
    valh = state.valh.numpy()
    gid = state.ctx_gid.numpy().view(np.uint64)
    base = t_hm.probe_base(torch.from_numpy(q.view(np.int64).copy()), H).numpy()
    out = np.zeros((len(q), 8), np.int64)
    for i, kh in enumerate(q.astype(np.uint64)):
        best = [(0, 0, 0, -1)] * G  # (ts, gid, ctr, slot)
        mine = [(0, 0)] * G  # (node, valh) of the thread's own best
        free = [t_hm.NO_FREE] * G
        for off in range(W):
            s = int(base[i]) + off
            if s >= H:
                break
            t = (off // 4) % G
            if not alive[s]:
                free[t] = min(free[t], s)
            elif key[s] == kh:
                nd = int(node[s])
                c = (int(ts[s]), int(gid[min(max(nd, 0), R - 1)]), int(ctr[s]), s)
                if _better(c, best[t]):
                    best[t], mine[t] = c, (nd, int(valh[s]) & 0xFFFFFFFF)
        own = [b[3] for b in best]
        d = G // 2
        while d:
            best = [o if _better(o, b) else b for b, o in ((best[t], best[t ^ d]) for t in range(G))]
            free = [min(free[t], free[t ^ d]) for t in range(G)]
            d //= 2
        ts_w, gid_w, ctr_w, slot = best[0]
        assert all(b == best[0] for b in best) and len(set(free)) == 1
        found = slot >= 0
        writer = own.index(slot) if found else 0
        assert own.count(slot) == (1 if found else own.count(-1))
        nd, vh = mine[writer] if found else (0, 0)
        u = ts_w & 0xFFFFFFFFFFFFFFFF
        out[i] = (found, slot if found else -1, nd, (ctr_w & 0xFFFFFFFF) if found else 0, vh,
                  (u & 0xFFFFFFFF) if found else 0, (u >> 32) if found else 0, free[0])
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("seed,capacity,window", [(0, 256, None), (1, 512, None), (2, 256, None),
                                                  (3, 256, 256), (5, 512, 33), (6, 256, 12)])
def test_group_reduction_model_matches_plain_grid(seed, capacity, window):
    st, keys = concurrent_state(seed, capacity, n_keys=40, window=window)
    q = queries(st, keys, np.random.default_rng(seed))
    want = grid_ref(st, q)
    for G in GROUPS:
        assert np.array_equal(group_model(q, carry(st), G), want), G
    assert (np.asarray(st.ctx_gid).view(np.uint64) >= 1 << 63).any()


@pytest.mark.parametrize("H,W,R", [(256, 32, 8), (256, 12, 8), (256, 33, 8), (256, 1, 8), (256, 128, 8),
                                   (8, 8, 8), (16, 12, 8), (1024, 32, 2100)])
def test_group_reduction_model_on_scattered_tables(H, W, R):
    """Tables whose keys sit anywhere in their windows (so winners fall
    on every thread of a group), windows that run off or end exactly at
    the table end, and writer tables past the kernel's shared-memory cap."""
    st, keys = probe_tables.seeded_table(H, W, max(H // 8, 16), seed=H + W + R, device="cpu", R=R)
    qk = probe_tables.queries(keys, 256, seed=W)
    q = qk.numpy().view(np.uint64)
    want = t_hm.probe_lookup_ref(qk, st).numpy()
    for G in GROUPS:
        assert np.array_equal(group_model(q, st, G), want), G
    found = want[:, 0] == 1
    base = t_hm.probe_base(qk, H).numpy()
    assert found.any() and (~found).any()
    if W >= 8:
        # winners in an odd 4-lane chunk: off the first thread at every G >= 2
        assert (((want[found, 1] - base[found]) // 4) % 2 == 1).any()
    if W % 8 == 0 and H <= 256:
        assert (base + W == H).any()
    assert (st.ctx_gid.numpy().view(np.uint64) >= 1 << 63).any()


#: shapes where the kernel's design has edges: windows that are not a
#: multiple of 4 or of the thread group, the smallest tables, a window
#: ending exactly at the table end (H = W = 8), and writer tables at and
#: past the kernel's shared-memory cap (2048 entries)
CUDA_PROBE_SHAPES = [(256, 8, 8), (256, 32, 8), (256, 256, 8), (256, 1, 8), (256, 12, 8),
                     (256, 33, 8), (8, 1, 8), (8, 5, 8), (8, 8, 8), (16, 12, 8), (16, 16, 8),
                     (1 << 16, 32, 2048), (1 << 16, 32, 4096)]


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
    edge = off_first = 0
    for H, W, R in CUDA_PROBE_SHAPES:
        st2, keys2 = probe_tables.seeded_table(H, W, max(H // 8, 16), seed=H + W + R, device=dev, R=R)
        for Q in (8, 2048):
            qk = probe_tables.queries(keys2, Q, seed=Q + W)
            got = t_hm.probe_lookup_kernel(qk, st2)
            want = t_hm.probe_lookup_ref(qk, st2)
            assert torch.equal(got, want), (H, W, R, Q)
            base = t_hm.probe_base(qk, H).to(torch.int64)
            edge += int((base + W == H).sum())
            found = want[:, 0] == 1
            G = t_hm.probe_lookup_kernel.group(W)
            off_first += int((found & ((want[:, 1].to(torch.int64) - base) // 4 % G != 0)).sum())
    assert edge > 0 and off_first > 0
