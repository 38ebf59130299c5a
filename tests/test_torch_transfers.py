"""Per-site device↔host transfer counts of the port, pinned next to the
JAX package's for the same scripts: one fleet egress tick, one WAL
``entries`` commit and one compaction snapshot.

The ledgers count a crossing per audited ``get``. They differ in one
place, by design: the JAX ``TransferSite.get`` counts a crossing even
for a tree of host arrays only, the port's counts none. On a fleet
egress tick the fleet has already fetched every batched job's slice
(``fleet.egress_extract``), so each batched job's ``_slice_wire`` moves
nothing in the port and counts one ``replica.slice_payload_dots`` and
one ``replica.slice_wire`` crossing in JAX: the expected delta is
exactly the tick's batched job count on each of the two sites.
"""

from __future__ import annotations

import pytest

import delta_crdt_ex_tpu as jdc
from delta_crdt_ex_tpu.runtime.clock import LogicalClock as JClock
from delta_crdt_ex_tpu.runtime.fleet import Fleet as JFleet
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu.utils import transfers as j_transfers
from delta_crdt_ex_tpu_torch import api as t_api
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock as TClock
from delta_crdt_ex_tpu_torch.runtime.fleet import Fleet
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport as TTransport
from delta_crdt_ex_tpu_torch.utils import transfers as t_transfers

SITES = ("replica.slice_payload_dots", "replica.slice_wire", "replica.snapshot", "replica.wal_entries")


def _pkg(pkg):
    if pkg == "jax":
        return jdc, JTransport(), JClock(), JFleet, j_transfers, {"log_shipping": False}
    return t_api, TTransport(), TClock(), Fleet, t_transfers, {"device": "cpu", "log_shipping": False}


def _delta(ledger, before) -> dict:
    now = ledger.snapshot()
    return {s: now[s]["count"] - before.get(s, {"count": 0})["count"] for s in SITES}


def _counts(pkg: str, store, tmp) -> dict:
    """The three scripts on one package; per-site crossing deltas of
    each, plus the egress tick's batched job count."""
    dc, t, clock, F, ledger, extra = _pkg(pkg)
    mk = lambda name, node, **kw: dc.start_link(
        dc.AWLWWMap, threaded=False, transport=t, clock=clock, capacity=64, tree_depth=6, name=name,
        node_id=node, sync_timeout=1e9, store=store, **extra, **kw,
    )
    made = []
    try:
        # one fleet egress tick: 4 members, each with fresh own dots and
        # one sink neighbour
        sinks = [mk(f"sink{i}", 900 + i) for i in range(4)]
        members = [mk(f"m{i}", 100 + i) for i in range(4)]
        made += sinks + members
        fleet = F(members)
        for i, (m, s) in enumerate(zip(members, sinks)):
            m.set_neighbours([s])
            t.drain(s.addr)
            m.mutate_batch("add", [[f"m{i}k{k}", k] for k in range(3)])
        before = ledger.snapshot()
        fleet.sync_tick()
        out = {"egress": _delta(ledger, before), "batched_jobs": fleet.stats()["egress"]["batched_jobs"]}

        # one WAL entries commit: one sender's slice into a WAL receiver
        tx = mk("tx", 7)
        rx = mk("rx", 8, wal_dir=str(tmp / "rx"), compact_every=10_000)
        made += [tx, rx]
        tx.set_neighbours([rx])
        tx.mutate("add", ["x", 1])
        before = ledger.snapshot()
        tx._push_deltas()
        rx.process_pending()
        assert rx._seq == 1
        out["entries"] = _delta(ledger, before)

        # one compaction snapshot
        before = ledger.snapshot()
        rx.checkpoint()
        out["compaction"] = _delta(ledger, before)
        return out
    finally:
        for r in made:
            r.crash()


@pytest.mark.parametrize("store", [None, "hash"])
def test_transfer_counts_pinned_against_jax(tmp_path, store):
    j = _counts("jax", store, tmp_path / "j")
    t = _counts("torch", store, tmp_path / "t")
    jobs = t["batched_jobs"]
    assert jobs == j["batched_jobs"] == 4
    # the egress tick: the known difference, exactly one crossing per
    # batched job on each slice site in JAX, none in the port
    assert t["egress"] == {s: 0 for s in SITES}
    assert j["egress"] == {**t["egress"], "replica.slice_payload_dots": jobs, "replica.slice_wire": jobs}
    # one solo push into a WAL receiver: the sender's two slice
    # crossings; a host-plane body is logged with no crossing
    want_entries = {"replica.slice_payload_dots": 1, "replica.slice_wire": 1, "replica.snapshot": 0,
                    "replica.wal_entries": 0}
    assert t["entries"] == j["entries"] == want_entries
    # one compaction: one snapshot crossing
    want_compaction = {s: 0 for s in SITES} | {"replica.snapshot": 1}
    assert t["compaction"] == j["compaction"] == want_compaction
