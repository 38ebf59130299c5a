"""Deterministic fault-point injection in the port
(``delta_crdt_ex_tpu_torch/utils/faults.py``), the cases of
``tests/test_faults.py`` but the three flight-ring ones (the flight
recorder comes with the observability slice):

1. the plan mechanics: seeded schedules replay identically, rules fire
   exactly once at the Nth hit of their site, ``suspended()`` pauses
   without consuming hits, the disarmed path is inert; the vocabulary
   is the JAX package's;
2. the runtime wiring, on both dot stores: an injected failure at a
   commit boundary rolls the replica's seq back and stages nothing
   durable, the WAL scrubs a failed group commit (no duplicate-seq
   logs), a ``partial_write`` mints a torn tail that recovery truncates
   to the durable prefix, a failure mid-way through a grouped entries
   commit leaves a contiguous prefix, and the loop sites trip.
"""

import time

import pytest

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu.runtime.wal import WalCorruption as JWalCorruption
from delta_crdt_ex_tpu.utils import faults as j_faults
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, telemetry
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport
from delta_crdt_ex_tpu_torch.utils import faults
from delta_crdt_ex_tpu_torch.utils.faults import (
    ACTIONS,
    SITES,
    CrashInjected,
    FaultInjected,
    FaultPlan,
    FaultRule,
)

STORES = ["binned", "hash"]


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends with no armed plan (module-global)."""
    faults.disarm()
    yield
    faults.disarm()


@pytest.fixture
def spawn(tmp_path):
    """``spawn(name, store, **opts)``: an unthreaded port replica with a
    batch-fsynced WAL under ``tmp_path``; all crashed in teardown."""
    made = []

    def mk(name, store="binned", **kw):
        kw.setdefault("wal_dir", str(tmp_path))
        kw.setdefault("fsync_mode", "batch")
        r = tdc.start_link(
            tdc.AWLWWMap, store=store, threaded=False, name=name, capacity=128, tree_depth=5,
            device="cpu", transport=kw.pop("transport", LocalTransport()), **kw,
        )
        made.append(r)
        return r

    yield mk
    for r in made:
        r.crash()


def test_vocabulary_matches_the_jax_package():
    assert SITES == j_faults.SITES and ACTIONS == j_faults.ACTIONS
    assert [(r.site, r.nth, r.action) for r in FaultPlan.seeded(7, n_rules=6).rules] == [
        (r.site, r.nth, r.action) for r in j_faults.FaultPlan.seeded(7, n_rules=6).rules
    ]


# ---------------------------------------------------------------------------
# plan mechanics


def test_rule_validation_rejects_unknown_site_action_and_bad_nth():
    with pytest.raises(ValueError):
        FaultRule("no.such.site", 1, "raise")
    with pytest.raises(ValueError):
        FaultRule("wal.append", 1, "explode")
    with pytest.raises(ValueError):
        FaultRule("wal.append", 0, "raise")


def test_seeded_plans_replay_identically():
    a = FaultPlan.seeded(42, n_rules=5)
    b = FaultPlan.seeded(42, n_rules=5)
    assert [(r.site, r.nth, r.action) for r in a.rules] == [
        (r.site, r.nth, r.action) for r in b.rules
    ]
    c = FaultPlan.seeded(43, n_rules=5)
    assert [(r.site, r.nth, r.action) for r in a.rules] != [
        (r.site, r.nth, r.action) for r in c.rules
    ]
    for r in a.rules:
        assert r.site in SITES and r.action in ACTIONS


def test_disarmed_faultpoint_is_inert():
    assert faults.active() is None
    for _ in range(100):
        assert faults.faultpoint("wal.append") is None
    # nothing counted, nothing tripped
    plan = faults.arm(FaultPlan([("wal.append", 1, "raise")]))
    assert plan.hits == {}


def test_rule_fires_exactly_once_at_nth_hit():
    with faults.armed(FaultPlan([("wal.append", 3, "raise")])) as plan:
        assert faults.faultpoint("wal.append") is None
        assert faults.faultpoint("wal.append") is None
        with pytest.raises(FaultInjected):
            faults.faultpoint("wal.append")
        # fired rules stay down: hit 3 does not re-trip on later hits
        for _ in range(5):
            assert faults.faultpoint("wal.append") is None
        assert plan.exhausted()


def test_unrelated_site_hits_do_not_consume_the_rule():
    with faults.armed(FaultPlan([("wal.fsync", 1, "raise")])):
        for _ in range(10):
            assert faults.faultpoint("wal.append") is None
        with pytest.raises(FaultInjected):
            faults.faultpoint("wal.fsync")


def test_crash_before_raises_crash_injected():
    with faults.armed(FaultPlan([("wal.write", 1, "crash_before")])):
        with pytest.raises(CrashInjected):
            faults.faultpoint("wal.write")


def test_crash_after_trips_at_next_hit_of_any_site():
    with faults.armed(
        FaultPlan([("replica.durable", 1, "crash_after")])
    ) as plan:
        assert faults.faultpoint("replica.durable") is None  # arms only
        assert plan.pending_crash == "replica.durable"
        with pytest.raises(CrashInjected, match="replica.durable"):
            faults.faultpoint("transport.send")  # ANY next hit trips


def test_partial_write_returns_clamped_fraction():
    with faults.armed(FaultPlan([
        FaultRule("wal.write", 1, "partial_write", 0.25),
        FaultRule("wal.write", 2, "partial_write", 7.5),
    ])):
        assert faults.faultpoint("wal.write") == 0.25
        assert faults.faultpoint("wal.write") == 0.99  # clamped


def test_rearming_a_plan_resets_its_counters():
    plan = FaultPlan([("wal.append", 2, "raise")])
    faults.arm(plan)
    assert faults.faultpoint("wal.append") is None
    faults.arm(plan)  # reset: the earlier hit is forgotten
    assert faults.faultpoint("wal.append") is None
    with pytest.raises(FaultInjected):
        faults.faultpoint("wal.append")


def test_suspended_pauses_without_consuming_hits():
    with faults.armed(FaultPlan([("wal.append", 2, "raise")])) as plan:
        assert faults.faultpoint("wal.append") is None
        with faults.suspended():
            # recovery replay: same code paths, no schedule consumption
            for _ in range(10):
                assert faults.faultpoint("wal.append") is None
        assert plan.hits["wal.append"] == 1  # untouched by the replay
        with pytest.raises(FaultInjected):
            faults.faultpoint("wal.append")


def test_trips_ledger_and_telemetry_emission():
    before = faults.trips().get("wal.rotate", 0)
    seen = []
    handler = lambda ev, meas, meta: seen.append((meas, meta))
    telemetry.attach(telemetry.FAULT_TRIP, handler)
    try:
        with faults.armed(FaultPlan([("wal.rotate", 1, "raise")])):
            with pytest.raises(FaultInjected):
                faults.faultpoint("wal.rotate")
    finally:
        telemetry.detach(telemetry.FAULT_TRIP, handler)
    assert faults.trips()["wal.rotate"] == before + 1
    assert seen == [({"trips": 1}, {"site": "wal.rotate"})]
    v = faults.varz()
    assert v["kind"] == "faults" and v["armed"] is False


# ---------------------------------------------------------------------------
# runtime wiring: commit boundaries, WAL scrub, torn tails


@pytest.mark.parametrize("store", STORES)
def test_injected_commit_failure_rolls_seq_back_and_stages_nothing(spawn, store):
    rep = spawn("flt_roll", store)
    rep.mutate("add", ["a", 1])
    seq0 = rep._seq
    with faults.armed(FaultPlan([("replica.durable", 1, "raise")])):
        with pytest.raises(FaultInjected):
            rep.mutate("add", ["b", 2])
    assert rep._seq == seq0, "failed commit must roll the seq back"
    rep.mutate("add", ["b", 2])  # retry commits cleanly
    assert rep.read() == {"a": 1, "b": 2}
    rep.crash()
    # recovery replays a contiguous log: the failed attempt left no
    # record, the retry's record replays at the rolled-back seq
    assert spawn("flt_roll", store).read() == {"a": 1, "b": 2}


@pytest.mark.parametrize("store", STORES)
def test_commit_batch_site_rolls_back_the_all_adds_path(spawn, store):
    """``replica.commit.batch`` on the bulk all-adds flush path."""
    rep = spawn("flt_bulk", store)
    with faults.armed(FaultPlan([("replica.commit.batch", 1, "raise")])):
        with pytest.raises(FaultInjected):
            rep.mutate_batch("add", [[i, i] for i in range(70)])
    assert rep._seq == 0
    rep.mutate_batch("add", [[i, -i] for i in range(70)])
    want = rep.read()
    rep.crash()
    assert spawn("flt_bulk", store).read() == want == {i: -i for i in range(70)}


@pytest.mark.parametrize("store", STORES)
def test_fsync_failure_scrubs_batch_so_retry_cannot_duplicate_seq(spawn, store):
    """A fault between the WAL byte-write and its fsync must scrub the
    written record: the caller rolls its seq back, and a retry re-mints
    the same seq (recovery rejects a duplicate-seq log as corrupt)."""
    rep = spawn("flt_scrub", store)
    rep.mutate("add", ["a", 1])
    with faults.armed(FaultPlan([("wal.fsync", 1, "raise")])):
        with pytest.raises(FaultInjected):
            rep.mutate("add", ["b", 2])
    rep.mutate("add", ["b", 2])  # same seq re-minted — must be unique
    rep.crash()
    assert spawn("flt_scrub", store).read() == {"a": 1, "b": 2}


@pytest.mark.parametrize("store", STORES)
def test_aborted_commit_drops_staged_record_from_the_buffer(spawn, store):
    """crash_after armed at ``wal.append`` trips at ``wal.write`` — after
    the record is staged, before it is written. Stale staged bytes must
    not ride the next successful commit beside the re-minted seq."""
    rep = spawn("flt_abort", store)
    rep.mutate("add", ["a", 1])
    with faults.armed(FaultPlan([("wal.append", 1, "crash_after")])):
        with pytest.raises(CrashInjected):
            rep.mutate("add", ["b", 2])
    rep.mutate("add", ["c", 3])
    rep.crash()
    assert spawn("flt_abort", store).read() == {"a": 1, "c": 3}


@pytest.mark.parametrize("store", STORES)
def test_partial_write_tears_tail_and_recovery_truncates(spawn, store):
    rep = spawn("flt_torn", store)
    with faults.armed(FaultPlan([FaultRule("wal.write", 3, "partial_write", 0.5)])):
        rep.mutate("add", ["a", 1])
        rep.mutate("add", ["b", 2])
        with pytest.raises(CrashInjected, match="partial WAL write"):
            rep.mutate("add", ["c", 3])
    rep.crash()
    # the torn record was never published (durability happens-before
    # publication), so truncating it loses nothing acknowledged
    assert spawn("flt_torn", store).read() == {"a": 1, "b": 2}


@pytest.mark.parametrize("store", STORES)
def test_rotate_failure_keeps_the_commit_and_the_log_recovers(tmp_path, spawn, store):
    """``wal.rotate`` after a commit's records reached disk: the commit
    stands (no seq rollback, so no re-minted seq), the next commit rolls
    the segment, and the log recovers. The JAX package fails this
    script: its commit raises after the durable write, the replica rolls
    the seq back, the retry re-mints seq 1, and recovery rejects the log
    as a regressed sequence (``ROADMAP.md`` §3)."""
    rep = spawn("flt_rot", store, segment_bytes=64, log_shipping=False)
    with faults.armed(FaultPlan([("wal.rotate", 1, "raise")])) as plan:
        rep.mutate("add", ["a", 1])
    assert plan.exhausted() and rep._seq == 1
    rep.mutate("add", ["b", 2])
    want = rep.read()
    rep.crash()
    assert spawn("flt_rot", store, log_shipping=False).read() == want == {"a": 1, "b": 2}

    jdir = str(tmp_path / "jax")
    mk = lambda: jdc.start_link(jdc.AWLWWMap, threaded=False, name="flt_rot", capacity=128, tree_depth=5,
                                wal_dir=jdir, fsync_mode="batch", segment_bytes=64, store=store,
                                transport=JTransport(), log_shipping=False)
    jrep = mk()
    with j_faults.armed(j_faults.FaultPlan([("wal.rotate", 1, "raise")])):
        with pytest.raises(j_faults.FaultInjected):
            jrep.mutate("add", ["a", 1])
    jrep.mutate("add", ["b", 2])
    jrep.crash()
    with pytest.raises(JWalCorruption, match="sequence regressed"):
        mk()


@pytest.mark.parametrize("store", STORES)
def test_failed_tail_fsync_at_the_roll_fails_the_commit(spawn, store):
    """Interval mode fsyncs the tail when a commit fills its segment.
    Only the roll's own failure is soft: a failed fsync of that tail
    scrubs the batch and propagates, so the replica rolls its seq back,
    the retry re-mints the seq, and the log recovers without it."""
    rep = spawn("flt_tailsync", store, segment_bytes=64, fsync_mode="interval")
    with faults.armed(FaultPlan([("wal.fsync", 1, "raise")])) as plan:
        with pytest.raises(FaultInjected):
            rep.mutate("add", ["a", 1])
    assert plan.exhausted() and rep._seq == 0
    rep.mutate("add", ["b", 2])
    assert rep._seq == 1
    rep.crash()
    assert spawn("flt_tailsync", store).read() == {"b": 2}


@pytest.mark.parametrize("store", STORES)
def test_grouped_commit_failure_leaves_a_contiguous_prefix(tmp_path, spawn, store):
    """A failure at the second ``replica.commit.entries`` of a coalesced
    group: the first message's record is durable with its own seq, the
    seq names it, and recovery replays exactly that prefix."""
    t, clock = LocalTransport(), LogicalClock()
    senders = [
        spawn(f"gs{i}", store, transport=t, clock=clock, wal_dir=None, node_id=50 + i) for i in range(3)
    ]
    rx = spawn("grx", store, transport=t, clock=clock, node_id=99)
    for i, s in enumerate(senders):
        s.set_neighbours([rx])
        s.mutate("add", [f"k{i}", i])  # buckets differ: the group coalesces
        s.sync_to_all()
    msgs = [m for m in t.drain(rx.addr) if isinstance(m, t_sync.EntriesMsg)]
    assert len(msgs) == 3
    with faults.armed(FaultPlan([("replica.commit.entries", 2, "raise")])):
        with pytest.raises(FaultInjected):
            rx._handle_entries_group(msgs)
    assert rx._seq == 1
    assert rx.stats()["ingress"]["dispatches"] == 1
    rx.crash()
    rec = spawn("grx", store, transport=LocalTransport(), clock=LogicalClock())
    assert rec._seq == 1 and rec.read() == {"k0": 0}


def test_loop_sites_trip_in_threaded_replica_and_fleet(spawn):
    """``replica.loop`` and ``fleet.loop`` sit at the top of each event
    loop: a ``delay`` there trips and is counted."""
    before = faults.trips()
    plan = FaultPlan([("replica.loop", 1, "delay", 0.001), ("fleet.loop", 1, "delay", 0.001)])
    rep = spawn("flt_loop", "binned", wal_dir=None)
    fleet = tdc.start_fleet(2, threaded=False, device="cpu", transport=LocalTransport(), capacity=64,
                            tree_depth=5)
    with faults.armed(plan):
        rep.start()
        fleet.start()
        deadline = time.monotonic() + 10
        while not plan.exhausted() and time.monotonic() < deadline:
            time.sleep(0.01)
        fleet.stop()
        rep.crash()
    assert plan.exhausted()
    after = faults.trips()
    for site in ("replica.loop", "fleet.loop"):
        assert after[site] == before.get(site, 0) + 1
