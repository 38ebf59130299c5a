"""The port's HTTP observability endpoint (``runtime/obs_server.py``)
against live port replicas: the ``/metrics`` exposition grammar, the
``/healthz`` contract, the ``/varz`` sources, the root and unknown
paths, an idempotent ``serve`` and ``stop``; the WAL and TCP transport
gauges on a scrape; the flight recorder dumped on ``crash()``, to
``flight_dump_path`` too; the serve gauges unregistered with their
replica or fleet; and the port's ``obs_varz()`` stanza against the JAX
replica's ``stats()`` keys for the same configuration (the port adds
``device`` and ``kernel_launches``).
"""

from __future__ import annotations

import json
import logging
import re
import time
import urllib.error
import urllib.request

import pytest

import delta_crdt_ex_tpu as jdc
import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime.transport import LocalTransport as JTransport
from delta_crdt_ex_tpu_torch.runtime.metrics import Observability
from delta_crdt_ex_tpu_torch.runtime.transport import LocalTransport

#: exposition format 0.0.4 line grammar: HELP/TYPE comments or a sample
#: ``name{labels} value`` line (labels optional, value int/float/±Inf)
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")*\})?"
    r" [-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|Inf|NaN)$"
)
_COMMENT_RE = re.compile(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .*)?$")
#: stats() keys the port's replica has and the JAX replica's has not
#: (``sync``: the port's anti-entropy round counters)
PORT_ONLY_STATS = {"device", "kernel_launches", "sync"}

SMALL = dict(capacity=64, tree_depth=4, sync_timeout=1e9, threaded=False, device="cpu")


@pytest.fixture
def plane():
    p = Observability(lag_sample_every=1)
    yield p
    p.close()


@pytest.fixture
def served(plane, tmp_path):
    t = LocalTransport()
    a = tdc.start_link(tdc.AWLWWMap, transport=t, obs=plane, name="srv-a", wal_dir=str(tmp_path),
                       fsync_mode="none", **SMALL)
    b = tdc.start_link(tdc.AWLWWMap, store="hash", transport=t, obs=plane, name="srv-b", **SMALL)
    a.set_neighbours([b])
    b.set_neighbours([a])
    a.mutate("add", ["k1", "v1"])
    b.mutate("add", ["k2", "v2"])
    for _ in range(4):
        a.sync_to_all()
        b.sync_to_all()
        a.process_pending()
        b.process_pending()
    server = plane.serve(port=0)  # ephemeral port: parallel test safety
    yield plane, server, a, b
    a.stop()
    b.stop()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def test_metrics_exposition_grammar(served):
    _plane, server, _a, _b = served
    status, ctype, body = _get(server.url + "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    lines = [l for l in body.splitlines() if l]
    assert lines
    for line in lines:
        assert _COMMENT_RE.match(line) or _SAMPLE_RE.match(line), f"exposition grammar violation: {line!r}"
    assert "# TYPE crdt_sync_done_total counter" in body
    assert 'crdt_sync_done_total{name="srv-a"}' in body
    assert 'crdt_sequence_number{name="srv-b"}' in body
    assert 'crdt_merge_dispatch_seconds_bucket{le="+Inf",name="srv-a",plane="host"}' in body
    assert "crdt_merge_dispatch_seconds_sum" in body and "crdt_merge_dispatch_seconds_count" in body
    assert "crdt_replication_lag_seconds_bucket" in body
    assert 'crdt_drained_messages_total{name="srv-a"}' in body
    # the transfer ledger rides the scrape: the replicas' crossings
    assert re.search(r'crdt_transfers_total\{site="replica\.[a-z_]+"\} [1-9]', body)


def test_healthz_contract(served):
    plane, server, _a, _b = served
    status, ctype, body = _get(server.url + "/healthz")
    assert status == 200 and ctype.startswith("application/json")
    doc = json.loads(body)
    assert doc["status"] == "ok"
    assert doc["checks"]["replica:srv-a"]["ok"] is True
    assert doc["checks"]["replica:srv-a"]["wal_writable"] is True
    assert doc["checks"]["replica:srv-b"]["neighbours"] == 1
    plane.add_health_check("injected", lambda: {"ok": False, "why": "test"})
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(server.url + "/healthz")
        assert exc.value.code == 503
        doc = json.loads(exc.value.read().decode())
        assert doc["status"] == "unhealthy" and doc["checks"]["injected"]["ok"] is False
    finally:
        plane.remove_source("injected")
    assert _get(server.url + "/healthz")[0] == 200


def test_varz_unifies_stats_sources(served):
    _plane, server, a, _b = served
    status, _ctype, body = _get(server.url + "/varz")
    assert status == 200
    doc = json.loads(body)
    stanza = doc["sources"]["replica:srv-a"]
    assert stanza["kind"] == "replica" and stanza["flight_events"] > 0
    live = a.stats()
    assert stanza["stats"]["sequence_number"] == live["sequence_number"]
    assert set(stanza["stats"]) == set(live)
    assert doc["sources"]["transfers"]["kind"] == "transfers"
    assert doc["metrics_families"] > 0


def test_root_and_unknown_paths(served):
    _plane, server, _a, _b = served
    status, _ctype, body = _get(server.url + "/")
    assert status == 200 and "/metrics" in body
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server.url + "/nope")
    assert exc.value.code == 404


def test_serve_is_idempotent_and_stop_releases(plane):
    s1 = plane.serve(port=0)
    assert plane.serve(port=0) is s1
    url = s1.url
    _get(url + "/metrics")
    plane.close()
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _get(url + "/metrics")


def test_wal_and_tcp_transport_gauges_scrape(tmp_path):
    plane = Observability()
    ta, tb = tdc.TcpTransport(), tdc.TcpTransport()
    reps = []
    try:
        a = tdc.start_link(tdc.AWLWWMap, transport=ta, obs=plane, name="walrep", wal_dir=str(tmp_path),
                           fsync_mode="none", **SMALL)
        b = tdc.start_link(tdc.AWLWWMap, transport=tb, obs=plane, name="tcprep", **SMALL)
        reps = [a, b]
        a.set_neighbours([tb.remote_addr("tcprep")])
        a.mutate("add", ["k", "v"])
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and b.read() != {"k": "v"}:
            a.sync_to_all()
            b.process_pending()
            time.sleep(0.02)
        assert b.read() == {"k": "v"}
        out = plane.registry.render()
        assert 'crdt_wal_segments{name="walrep"} 1' in out
        assert 'crdt_wal_append_records_total{name="walrep"} 1' in out
        m = re.search(r'crdt_wal_bytes\{name="walrep"\} (\d+)', out)
        assert m and int(m.group(1)) == a.wal_size_bytes() > 0
        ep = ta.transport_stats()["endpoint"]
        m = re.search(rf'crdt_transport_tx_bytes\{{transport="{re.escape(ep)}"\}} (\d+)', out)
        assert m and int(m.group(1)) > 0
        assert f'crdt_transport_queue_bytes{{transport="{ep}"}}' in out
        m = re.search(r'crdt_transport_rx_bytes\{transport="[^"]+"\} (\d+)', out)
        assert m and int(m.group(1)) > 0
    finally:
        for r in reps:
            r.stop()
        ta.close()
        tb.close()
        plane.close()


@pytest.mark.parametrize("dump_path", [False, True])
def test_flight_recorder_dumped_on_crash(tmp_path, caplog, dump_path):
    plane = Observability()
    path = str(tmp_path / "black_box.jsonl") if dump_path else None
    try:
        rep = tdc.start_link(tdc.AWLWWMap, transport=LocalTransport(), obs=plane, name="crashy",
                             wal_dir=str(tmp_path / "wal"), fsync_mode="none", flight_dump_path=path, **SMALL)
        rep.mutate("add", ["k", "v"])
        rep.checkpoint()  # records a wal_compact flight event
        assert rep.flight.events(kind="wal_compact")
        with caplog.at_level(logging.ERROR, logger="delta_crdt_ex_tpu_torch"):
            rep.crash()
        assert any("flight recorder" in m for m in caplog.messages)
        assert any("wal_compact" in m for m in caplog.messages)
        assert "replica:crashy" not in plane.varz()["sources"]
        if dump_path:
            rows = [json.loads(line) for line in open(path, encoding="utf-8")]
            assert [r["kind"] for r in rows] == [e["kind"] for e in rep.flight.events()]
            assert all(r["replica"] == "crashy" for r in rows)
        # the recovered replica's flight ring starts with the replay
        again = tdc.start_link(tdc.AWLWWMap, transport=LocalTransport(), obs=plane, name="crashy",
                               wal_dir=str(tmp_path / "wal"), fsync_mode="none", **SMALL)
        assert again.read() == {"k": "v"}
        again.stop()
    finally:
        plane.close()


def test_serve_gauges_scrape_and_unregister_replica():
    plane = Observability()
    try:
        rep = tdc.start_link(tdc.AWLWWMap, transport=LocalTransport(), obs=plane, name="srvfd", **SMALL)
        fd = tdc.frontdoor(rep)
        fd.mutate("add", ["k", "v"])
        fd.read_keys(["k"])
        out = plane.registry.render()
        for line in ('crdt_serve_pending_ops{name="srvfd"} 0', 'crdt_serve_overloaded{name="srvfd"} 0',
                     'crdt_serve_admitted_ops_total{name="srvfd"} 1', 'crdt_serve_commits_total{name="srvfd"} 1',
                     'crdt_serve_reads_total{name="srvfd",mode="keys"} 1'):
            assert line in out
        assert "crdt_serve_coalesce_depth_bucket" in out and "crdt_serve_read_seconds_bucket" in out
        assert plane.varz()["sources"]["serve:srvfd"]["kind"] == "serve"
        rep.stop()
        out = plane.registry.render()
        assert 'crdt_serve_pending_ops{name="srvfd"}' not in out
        assert 'crdt_serve_overloaded{name="srvfd"}' not in out
        assert "serve:srvfd" not in plane.varz()["sources"]
    finally:
        plane.close()


def test_serve_gauges_cleanup_on_unregister_fleet():
    plane = Observability()
    try:
        fleet = tdc.start_fleet(2, transport=LocalTransport(), obs=plane, names=["sfobs0", "sfobs1"], **SMALL)
        fd = fleet.frontdoor()
        fd.mutate("add", ["k", "v"])
        fleet.drain()
        out = plane.registry.render()
        assert 'crdt_serve_pending_ops{name="sfobs0"}' in out and 'crdt_serve_pending_ops{name="sfobs1"}' in out
        fleet.stop()
        out = plane.registry.render()
        for name in ("sfobs0", "sfobs1"):
            assert f'crdt_serve_pending_ops{{name="{name}"}}' not in out
            assert f'crdt_serve_overloaded{{name="{name}"}}' not in out
        assert not [k for k in plane.varz()["sources"] if k.startswith(("serve:", "fleet:", "replica:"))]
    finally:
        plane.close()


@pytest.mark.parametrize("store", ["binned", "hash"])
@pytest.mark.parametrize("wal", [False, True])
def test_obs_varz_matches_jax_stats_keys(tmp_path, store, wal):
    """The port's ``obs_varz()`` stanza carries the JAX replica's
    ``stats()`` keys for the same configuration, nested dicts included;
    the port adds only :data:`PORT_ONLY_STATS`."""
    kw = dict(threaded=False, capacity=64, tree_depth=4, name="keys", store=store)
    jkw, tkw = dict(kw), dict(kw)
    if wal:
        jkw["wal_dir"], tkw["wal_dir"] = str(tmp_path / "j"), str(tmp_path / "t")
    plane = Observability()
    j = jdc.start_link(jdc.AWLWWMap, transport=JTransport(), **jkw)
    t = tdc.start_link(tdc.AWLWWMap, transport=LocalTransport(), device="cpu", obs=plane, **tkw)
    try:
        j.mutate("add", ["k", 1])
        t.mutate("add", ["k", 1])
        js, stanza = j.stats(), t.obs_varz()
        assert stanza["kind"] == "replica" and "flight_events" in stanza
        ts = stanza["stats"]
        assert set(ts) - set(js) == PORT_ONLY_STATS and set(js) <= set(ts)
        for key, val in js.items():
            if isinstance(val, dict) and key != "transfers":
                assert set(ts[key]) == set(val), key
            elif val is None:
                assert ts[key] is None, key
    finally:
        j.stop()
        t.stop()
        plane.close()
