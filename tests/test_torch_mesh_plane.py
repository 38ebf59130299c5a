"""The mesh fleet's delivery plane and the JAX twins, PyTorch port
against the JAX package (more of ``tests/test_mesh_fleet.py``'s
cases; the twins against the fleet forms and the intra-mesh runtime
parity are in ``tests/test_torch_mesh_fleet.py`` and
``tests/test_torch_mesh_hash.py``):

- the port's ``mesh_fleet_*`` twins against JAX's ``shard_map`` twins
  at 8 shards on seeded inputs (top-bit keys and gids), both stores;
- off-mesh sinks of a port mesh fleet see the JAX mesh fleet's streams
  and pickled wire bytes (and the port vmap fleet's), counted as
  fallback entries; mixed on- and off-mesh destinations in one tick;
- the padded exchange (``mesh_narrow=False``) delivers what the narrow
  one does, through its own audited sites, with JAX's WAL bytes and
  transfer counts.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.runtime import transition as j_tr
from delta_crdt_ex_tpu.utils.devices import fleet_mesh as j_fleet_mesh
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.models.binned_map import stack_entry_slices
from delta_crdt_ex_tpu_torch.runtime import transition as t_tr
from tests.test_torch_fleet import _np_slice, assert_tree_same, make_lanes, to_port_state
from tests.test_torch_mesh_fleet import (
    TOP,
    _extract_inputs,
    _norm,
    _pkg,
    _t,
    _wire_bytes,
    cpu_mesh,
    intra_script,
    jax_like,
    row_apply_batch,
)


@pytest.mark.parametrize("store", ["binned", "hash"])
def test_mesh_twins_bit_equal_to_jax_at_8_shards(store):
    """The port twins against JAX's ``shard_map`` twins over its 8
    devices, on seeded inputs with top-bit keys and gids."""
    n, lanes = 6, 8
    states, slices = make_lanes(n, store, seed=31, rows_per=[16, 4, 8, 2, 16, 12])
    j_states = j_tr.stack_states(states + [states[0]] * (lanes - n))
    t_states = to_port_state(j_states)
    from delta_crdt_ex_tpu.models.binned_map import stack_entry_slices as j_stack

    j_sl, _ = j_stack([_np_slice(s) for s in slices], lanes=lanes)
    t_sl, _ = stack_entry_slices([_np_slice(s) for s in slices], lanes=lanes, device="cpu")
    jm, tm = j_fleet_mesh(8), cpu_mesh(8)
    j_model = jdc.api._resolve_store(jdc.AWLWWMap, store)
    t_model = t_api._resolve_store(t_api.AWLWWMap, store)
    assert_tree_same(jax_like(t_model.mesh_fleet_merge_rows(tm, t_states, t_sl)),
                     j_model.mesh_fleet_merge_rows(jm, j_states, j_sl), "merge")
    rows, lo, slots, gids = _extract_inputs(states, n, lanes, seed=32)
    got, gt = t_model.mesh_fleet_extract_rows(tm, t_states, _t(rows))
    want, wt = j_model.mesh_fleet_extract_rows(jm, j_states, jnp.asarray(rows))
    assert gt == wt
    assert_tree_same(jax_like(got), want, "extract_rows")
    got, gt = t_model.mesh_fleet_extract_own_delta(tm, t_states, _t(rows), _t(slots), _t(gids), _t(lo))
    want, wt = j_model.mesh_fleet_extract_own_delta(
        jm, j_states, jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(gids), jnp.asarray(lo)
    )
    assert gt == wt
    assert_tree_same(jax_like(got), want, "own delta")
    for tl, jl in zip(t_tr.mesh_fleet_tree_from_leaves(tm, t_states.leaf),
                      j_tr.jit_mesh_fleet_tree_from_leaves(jm, j_states.leaf)):
        assert np.array_equal(tl.gather().numpy(), np.asarray(jl).astype(np.int64))
    own_t = t_tr.mesh_fleet_own_ctr_columns(tm, t_states.ctx_max, _t(slots)).gather().numpy()
    own_j = np.asarray(j_tr.jit_mesh_fleet_own_ctr_columns(jm, j_states.ctx_max, jnp.asarray(slots)))
    assert np.array_equal(own_t, own_j.astype(np.int64))
    if store == "hash":
        assert np.array_equal(t_tr.mesh_fleet_hash_row_counts(tm, t_states, _t(rows)).gather().numpy(),
                              np.asarray(j_tr.jit_mesh_fleet_hash_row_counts(jm, j_states, jnp.asarray(rows))))
        return
    host = row_apply_batch(lanes, seed=33, as_numpy=True)
    want = j_tr.jit_mesh_fleet_row_apply(jm, j_states, *map(jnp.asarray, host))
    got = t_tr.mesh_fleet_row_apply(tm, t_states, *row_apply_batch(lanes, seed=33))
    assert_tree_same(jax_like(got), want, "row_apply")


def sink_script(pkg, store, shards, mixed=False, n=4):
    """Members pushing to off-mesh sinks (``mixed``: one co-fleet
    neighbour each too) for three rounds; returns every sink's drained
    stream normalised, the pickled wire bytes and the mesh stats."""
    dc, T, C, F, mesh_of, _ledger, extra = _pkg(pkg)
    t = T()
    tag = f"{pkg}{store}{shards}{mixed}"
    mk = lambda name, node: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=C(), capacity=256, tree_depth=4, sync_timeout=600.0,
        store=store, name=name, node_id=node, **extra,
    )
    reps = [mk(f"of{tag}m{i}", (TOP if i % 2 else 0) + 100 + i) for i in range(n)]
    sinks = [mk(f"of{tag}r{i}", 900 + i) for i in range(n)]
    for i in range(n):
        reps[i].set_neighbours(([reps[(i + 1) % n]] if mixed else []) + [sinks[i]])
    fleet = F(reps, **({} if shards is None else {"mesh": mesh_of(shards)}))
    streams, wire = [], 0
    for rnd in range(3):
        for i in range(n):
            for j in range(2 + i):
                reps[i].mutate("add", [rnd * 1000 + i * 10 + j, j | TOP])
        fleet.sync_tick()
        for s in sinks:
            msgs = t.drain(s.addr)
            assert msgs
            streams.append([_norm(m) for m in msgs])
            wire += sum(_wire_bytes(m) for m in msgs)
        if mixed:
            fleet.drain()
        for r in reps:
            r._outstanding.clear()
            r._sync_open_seq.clear()
    out = (streams, wire, fleet.stats()["mesh"], [r.canonical_state_bytes() for r in reps])
    for r in reps + sinks:
        r.crash()
    return out


@pytest.mark.parametrize("store", ["binned", "hash"])
def test_mesh_off_mesh_sink_streams_equal_jax(store):
    """Off-mesh destinations take the collector path unchanged: the
    sinks' streams and pickled wire bytes equal the JAX mesh fleet's and
    the port's vmap fleet's, and the plane counts them as fallback."""
    ts, tw, tms, _ = sink_script("torch", store, 4)
    js, jw, jms, _ = sink_script("jax", store, 4)
    vs, vw, _, _ = sink_script("torch", store, None)
    assert ts == js == vs
    assert tw == jw == vw > 0
    assert tms["fallback_entries"] == jms["fallback_entries"] > 0
    assert tms["intra_entries"] == 0 and tms["exchanges"] == 0


def test_mesh_mixed_destinations_one_tick():
    """Members whose neighbours span the mesh AND an off-mesh sink in one
    tick: co-mesh entries ride the exchange, off-mesh ones the collector;
    the sinks see the vmap fleet's (and the JAX mesh fleet's) streams, and
    the members drain into the vmap fleet's end states."""
    ts, tw, tms, tc = sink_script("torch", None, 4, mixed=True)
    js, jw, jms, jc = sink_script("jax", None, 4, mixed=True)
    vs, vw, _, vc = sink_script("torch", None, None, mixed=True)
    assert ts == js == vs and tw == jw == vw
    assert tms["intra_entries"] > 0 and tms["fallback_entries"] > 0
    assert (tms["intra_entries"], tms["fallback_entries"]) == (jms["intra_entries"], jms["fallback_entries"])
    assert tc == vc == jc


def test_mesh_narrow_false_delivers_the_same(tmp_path):
    """The padded exchange (``mesh_narrow=False``: whole buffers to the
    devices and back, host-plane bodies delivered) ends where the narrow
    one and the vmap fleet do, through its own audited sites."""
    nm, nsink, nms, nd = intra_script("torch", None, 4, tmp_path)
    pm, psink, pms, pd = intra_script("torch", None, 4, tmp_path, narrow=False)
    jp, jsink, jps, jd = intra_script("jax", None, 4, tmp_path, narrow=False)
    assert nsink == psink == jsink
    for a, b, c in zip(nm, pm, jp):
        assert a[0] == b[0] == c[0] and a[2] == b[2] == c[2]
        assert b[3] == c[3]  # the padded path's host bodies log as JAX's do
    assert pms["intra_entries"] == nms["intra_entries"] > 0
    assert pd["meshplane.ship_padded"] == pd["meshplane.deliver_padded"] == pms["exchanges"] > 0
    assert pd["meshplane.ship_dense"] == 0 and nd["meshplane.deliver_padded"] == 0
    assert pd == jd, (pd, jd)
