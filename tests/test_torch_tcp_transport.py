"""Cross-"node" sync over the port's TCP transport.

Two ``TcpTransport``s in one process model two hosts (the reference's
``{name, node}`` addressing, ``causal_crdt_test.exs:68-78``): port
replicas on different transports sync through real sockets. The cases
of ``tests/test_tcp_transport.py`` on the port — HELLO negotiation, a
legacy peer that never receives ``_MSGZ``, the ``_MSGB`` round trip,
a stalled peer that does not block other edges, ``Down`` for a dead
remote — plus the ``transport.send`` / ``transport.recv`` fault points
and the wire codec against the JAX package's frames.

Every socket wait loop has its own deadline of at most 10 s, and every
transport is closed in teardown.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

import delta_crdt_ex_tpu_torch as tdc
from delta_crdt_ex_tpu.runtime import sync as j_sync, tcp_transport as JT
from delta_crdt_ex_tpu_torch.runtime import sync as t_sync, tcp_transport as T
from delta_crdt_ex_tpu_torch.runtime.clock import LogicalClock
from delta_crdt_ex_tpu_torch.runtime.transport import Down
from delta_crdt_ex_tpu_torch.utils import faults
from delta_crdt_ex_tpu_torch.utils.faults import FaultPlan


@pytest.fixture
def transports():
    """``transports(n)`` makes port TcpTransports; all closed in teardown."""
    made = []

    def mk(n=1, **kw):
        new = [T.TcpTransport(**kw) for _ in range(n)]
        made.extend(new)
        return new if n > 1 else new[0]

    yield mk
    for t in made:
        t.close()


def _mk(transport, clock, name):
    return tdc.start_link(
        tdc.AWLWWMap, threaded=False, transport=transport, clock=clock, name=name,
        capacity=64, tree_depth=6, device="cpu",
    )


def pump_both(ta, tb, rounds=10):
    for _ in range(rounds):
        ta.pump()
        tb.pump()
        time.sleep(0.01)  # socket delivery threads need a beat


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _sync_until(a, b, ta, tb, want, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        a.sync_to_all()
        b.sync_to_all()
        pump_both(ta, tb, rounds=5)
        if a.read() == want and b.read() == want:
            return True
    return False


def test_cross_node_bidirectional_sync(transports):
    ta, tb = transports(2)
    clock = LogicalClock()
    a, b = _mk(ta, clock, "a"), _mk(tb, clock, "b")
    a.set_neighbours([tb.remote_addr("b")])
    b.set_neighbours([ta.remote_addr("a")])
    a.mutate("add", ["from_a", 1])
    b.mutate("add", ["from_b", 2])
    want = {"from_a": 1, "from_b": 2}
    assert _sync_until(a, b, ta, tb, want)
    assert a.canonical_state_bytes() == b.canonical_state_bytes()
    st = ta.transport_stats()
    assert st["tx_bytes"] > 0 and st["rx_bytes"] > 0 and st["tx_frames"].get("msg", 0) > 0


def test_remote_liveness_ping(transports):
    ta, tb = transports(2)
    assert ta.alive(("anything", tb.endpoint))
    tb.close()
    time.sleep(0.05)
    assert not ta.alive(("anything", tb.endpoint))


def test_stalled_peer_does_not_block_other_edges(transports):
    """One peer that accepts but never reads must not stall sends to
    anyone else: sendall runs on a per-connection sender thread."""
    ta, tb = transports(2)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    stalled_ep = srv.getsockname()
    try:
        big = np.zeros(4_000_000, np.uint8)
        t0 = time.monotonic()
        for _ in range(8):
            assert ta.send(("x", stalled_ep), big)
        assert time.monotonic() - t0 < 2.0, "send() blocked on a stalled socket"

        class Sink:
            pass

        tb.register("sink", Sink())
        assert ta.send(("sink", tb.endpoint), {"hello": 1})
        got = []
        assert _wait(lambda: got.extend(tb.drain("sink")) or got, 5)
        assert got == [{"hello": 1}], "healthy edge stalled behind the wedged peer"
    finally:
        srv.close()


def test_frame_over_the_queue_byte_cap_is_sent_and_the_queue_stays_bounded(transports, monkeypatch):
    """A frame larger than the sender queue's byte cap (a catch-up chunk
    of a large table) goes out when less than the cap is queued, and
    reaches the peer whole; behind a stalled peer the queue then holds
    at most the cap plus that one frame (the JAX package's queue drops
    such a frame every time)."""
    monkeypatch.setattr(T._SenderConn, "QUEUE_MAX_BYTES", 1 << 20)
    ta, tb = transports(2)

    class Sink:
        pass

    tb.register("sink", Sink())
    big = np.random.default_rng(5).integers(0, 255, 3 << 20, dtype=np.uint8)
    assert ta.send(("sink", tb.endpoint), {"big": big})
    got = []
    assert _wait(lambda: got.extend(tb.drain("sink")) or got, 10)
    assert np.array_equal(got[0]["big"], big)

    a, b = socket.socketpair()  # b never reads: a stalled peer
    conn = T._SenderConn(a, on_dead=lambda *args: None)
    try:
        frame = bytes(2 << 20)
        assert conn.enqueue(T._MSG, frame)  # the sender thread takes it and blocks
        assert _wait(lambda: conn.queued_bytes() == 0, 10)
        assert conn.enqueue(T._MSG, frame)  # over the cap, behind nothing
        assert not conn.enqueue(T._MSG, frame)  # the cap is spent
        assert not conn.enqueue(T._MSG, bytes(1024))
        assert conn.queued_bytes() == len(frame)
    finally:
        b.close()
        conn.close()


def test_down_delivered_for_dead_remote_node(transports):
    ta, tb = transports(2)
    ta.heartbeat_interval = 0.05
    clock = LogicalClock()
    a, _b = _mk(ta, clock, "a"), _mk(tb, clock, "b")
    a.set_neighbours([tb.remote_addr("b")])
    a.sync_to_all()
    assert tb.remote_addr("b") in a._monitors
    tb.close()  # node death
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and a._monitors:
        time.sleep(0.05)
        ta.pump()
    assert tb.remote_addr("b") not in a._monitors


def test_large_frames_compress_transparently(transports):
    a, b = transports(2)
    b.register("sink", None)
    big = {"arr": np.zeros((512, 64), np.uint64), "tag": "padded-slice"}
    assert a.send(("sink", b.endpoint), big)
    assert a.send(("sink", b.endpoint), {"tag": "tiny"})
    got = []
    assert _wait(lambda: got.extend(b.drain("sink")) or len(got) >= 2)
    payloads = {m["tag"]: m for m in got}
    assert np.array_equal(payloads["padded-slice"]["arr"], big["arr"])
    raw = T.wire_dumps(("sink", big), 4)
    assert len(raw) >= T._COMPRESS_MIN
    assert len(zlib.compress(raw, 1)) < 0.9 * len(raw)


def test_hello_negotiates_array_side_channel(transports, monkeypatch):
    a, b = transports(2)
    sent_kinds = []
    orig = T._send_frame

    def spy(sock, kind, payload):
        sent_kinds.append(kind)
        return orig(sock, kind, payload)

    def pump(tag, n):
        got = []
        assert _wait(lambda: got.extend(b.drain("sink")) or any(m["tag"] == tag for m in got))
        return got

    b.register("sink", None)
    assert a.send(("sink", b.endpoint), {"tag": "opener"})
    conn = a._conns[b.endpoint]
    assert _wait(lambda: conn.accepts_z and conn.accepts_b and conn.accepts_f, 5), "HELLO never negotiated"
    monkeypatch.setattr(T, "_send_frame", spy)
    big = {"arr": np.zeros((1024, 128), np.uint64), "tag": "padded"}
    assert a.send(("sink", b.endpoint), big)
    got = pump("padded", 2)
    m = [g for g in got if g["tag"] == "padded"][0]
    assert np.array_equal(m["arr"], big["arr"])
    assert T._MSGB in sent_kinds, "negotiated peer should get _MSGB"
    assert _wait(lambda: a.transport_stats()["msgb_buffers"]["zlib"] >= 1)

    conn.accepts_b = False  # peer downgraded to MSGZ-only
    sent_kinds.clear()
    assert a.send(("sink", b.endpoint), dict(big, tag="padded2"))
    pump("padded2", 1)
    assert T._MSGZ in sent_kinds and T._MSGB not in sent_kinds


def test_msgb_encode_decode_roundtrip():
    rng = np.random.default_rng(0)
    dense = rng.integers(0, 2**63, (512, 128), dtype=np.uint64)
    sparse = np.zeros((512, 128), np.uint64)
    sparse[:, 0] = 7
    obj = ("sink", {"dense": dense, "sparse": sparse, "meta": [1, "two", None]})
    tally = dict.fromkeys(("raw", "raw_bytes_in", "raw_bytes_out", "zlib", "zlib_bytes_in", "zlib_bytes_out"), 0)
    payload = T._encode_msgb(obj, tally=tally)
    name, msg = T._decode_msgb(payload)
    assert name == "sink"
    assert np.array_equal(msg["dense"], dense)
    assert np.array_equal(msg["sparse"], sparse)
    assert msg["meta"] == [1, "two", None]
    assert msg["dense"].flags.writeable and msg["sparse"].flags.writeable
    msg["dense"][0, 0] = 1
    padded = np.zeros(1 << 16, np.uint64)
    padded[:2048] = rng.integers(0, 2**63, 2048, dtype=np.uint64)
    assert T._maybe_z_buffer(memoryview(padded))[0] == 1
    raw_total = dense.nbytes + sparse.nbytes
    assert len(payload) < raw_total * 0.6, "sparse buffer did not compress"
    assert len(payload) > dense.nbytes, "dense buffer cannot compress below raw"
    assert T._maybe_z_buffer(memoryview(sparse.reshape(-1)))[0] == 1
    assert T._maybe_z_buffer(memoryview(dense.reshape(-1)))[0] == 0
    assert (tally["raw"], tally["zlib"]) == (1, 1)
    assert tally["raw_bytes_in"] == tally["raw_bytes_out"] == dense.nbytes
    assert tally["zlib_bytes_in"] == sparse.nbytes > tally["zlib_bytes_out"]


def test_legacy_peer_never_receives_compressed_frames(transports):
    """A peer that does not speak HELLO gets only plain ``_MSG`` frames."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10)
    seen_kinds = []
    done = threading.Event()

    def legacy_server():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        with conn:
            conn.settimeout(10)
            while len(seen_kinds) < 2:
                hdr = b""
                while len(hdr) < 4:
                    chunk = conn.recv(4 - len(hdr))
                    if not chunk:
                        return
                    hdr += chunk
                n = struct.unpack(">I", hdr)[0]
                body = b""
                while len(body) < n:
                    chunk = conn.recv(n - len(body))
                    if not chunk:
                        return
                    body += chunk
                seen_kinds.append(body[0])
            done.set()

    th = threading.Thread(target=legacy_server, daemon=True)
    th.start()
    a = transports()
    try:
        assert a.send(("sink", srv.getsockname()), {"arr": np.zeros((512, 64), np.uint64)})
        assert done.wait(5), f"legacy server saw only {seen_kinds}"
        assert seen_kinds[0] == T._HELLO
        assert seen_kinds[1] == T._MSG, "legacy peer must get plain _MSG"
    finally:
        srv.close()
        th.join(timeout=10)


def test_msgb_roundtrip_property():
    """Any picklable message structure survives the side channel
    bit-identically, read by the port and by the JAX package."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    dtypes = st.sampled_from(["u8", "u4", "i8", "i4", "b1", "f8"])

    @st.composite
    def arrays(draw):
        dt = np.dtype(draw(dtypes))
        shape = draw(st.lists(st.integers(0, 64), min_size=1, max_size=3))
        rng = np.random.default_rng(draw(st.integers(0, 2**31)))
        a = (rng.integers(0, 100, size=shape) % 2 if dt.kind == "b" else rng.integers(0, 1 << 30, size=shape)).astype(dt)
        if draw(st.booleans()) and a.ndim >= 2 and a.shape[0] > 1:
            a = a[::2]  # non-contiguous view: falls back in band
        return a

    leaves = st.one_of(arrays(), st.integers(-(2**40), 2**40), st.text(max_size=8), st.none())
    messages = st.recursive(
        leaves,
        lambda c: st.one_of(
            st.lists(c, max_size=80),
            st.dictionaries(st.text(max_size=4), c, max_size=4),
            st.tuples(c, c),
        ),
        max_leaves=90,
    )

    def eq(a, b):
        if isinstance(a, np.ndarray):
            return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        if isinstance(a, (list, tuple)):
            return type(a) is type(b) and len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            return set(a) == set(b) and all(eq(a[k], b[k]) for k in a)
        return a == b and type(a) is type(b)

    @settings(max_examples=60, deadline=None)
    @given(messages)
    def check(msg):
        payload = T._encode_msgb(("sink", msg))
        for decode in (T._decode_msgb, JT._decode_msgb):
            name, out = decode(payload)
            assert name == "sink"
            assert eq(out, msg)

    check()


def test_device_of_local_vs_remote(transports):
    ta, tb = transports(2)
    a = _mk(ta, LogicalClock(), "a")
    assert ta.device_of("a") == a.device
    assert ta.device_of(("a", ta.endpoint)) == a.device  # self-remote resolves local
    assert ta.device_of(("a", tb.endpoint)) is None  # genuinely remote
    assert tb.device_of(("a", ta.endpoint)) is None
    a.transport.unregister(a.name)


# ---------------------------------------------------------------------------
# fault points and the wire codec


@pytest.mark.parametrize("site", ["transport.send", "transport.recv"])
def test_transport_fault_point_drops_one_frame_and_sync_heals(transports, site):
    """An injected loss at ``transport.send`` (the sender thread) or
    ``transport.recv`` (the serve thread) drops exactly that frame, as
    a lost packet would; the next sync rounds heal it."""
    ta, tb = transports(2)
    tb.register("sink", None)
    assert ta.send(("sink", tb.endpoint), {"tag": "warm"})  # opens the connection
    got = []
    assert _wait(lambda: got.extend(tb.drain("sink")) or got)
    with faults.armed(FaultPlan([(site, 1, "raise")])) as plan:
        assert ta.send(("sink", tb.endpoint), {"tag": "lost"})
        assert ta.send(("sink", tb.endpoint), {"tag": "kept"})
        got = []
        assert _wait(lambda: got.extend(tb.drain("sink")) or got)
        time.sleep(0.05)
        got.extend(tb.drain("sink"))
    assert plan.exhausted() and faults.trips()[site] >= 1
    assert [m["tag"] for m in got] == ["kept"]

    clock = LogicalClock()
    a, b = _mk(ta, clock, "fa"), _mk(tb, clock, "fb")
    a.set_neighbours([tb.remote_addr("fb")])
    b.set_neighbours([ta.remote_addr("fa")])
    with faults.armed(FaultPlan([(site, 2, "raise")])):
        a.mutate("add", ["k", 1])
        b.mutate("add", ["j", 2])
        assert _sync_until(a, b, ta, tb, {"k": 1, "j": 2})


def test_port_frames_decode_as_jax_classes_and_back():
    """The port writes its messages under the JAX package's class paths
    (a JAX peer's plain ``pickle.loads`` returns its own classes) and
    reads either package's frames into its own classes."""
    pay = {(i, i % 64, i): (f"k{i}", [i, "v"]) for i in range(200)}
    key = np.arange(64, dtype=np.uint64).reshape(8, 8)
    key.flags.writeable = False
    em = t_sync.EntriesMsg(
        originator=("a", ("h", 1)), frm=("a", ("h", 1)), to="b", buckets=np.arange(3),
        arrays={"key": key, "rows": np.arange(8, dtype=np.int32)}, payloads=pay,
    )
    msgs = [
        em,
        t_sync.AckMsg(clear_addr="x"),
        t_sync.GetLogMsg(frm="a", to="b", last_seq=3, applied_seq=2),
        Down(addr=("b", ("h", 2))),
        t_sync.FleetFrameMsg(frm=("h", 1), entries=[(("b", ("h", 2)), em)] * 70),
    ]
    for m in msgs:
        for payload, jax_load, port_load in (
            (T.wire_dumps(("sink", m), 4), pickle.loads, T.wire_loads),
            (T._encode_msgb(("sink", m)), JT._decode_msgb, T._decode_msgb),
        ):
            _n, j = jax_load(payload)
            assert type(j).__module__.startswith("delta_crdt_ex_tpu.runtime.")
            assert type(j).__name__ == type(m).__name__
            _n, p = port_load(payload)
            assert type(p) is type(m)
    j_em = j_sync.EntriesMsg(originator="a", frm="a", to="b", buckets=np.arange(3), arrays={"key": key}, payloads=pay)
    for payload, load in ((pickle.dumps(("s", j_em), protocol=4), T.wire_loads),
                          (JT._encode_msgb(("s", j_em)), T._decode_msgb)):
        _n, p = load(payload)
        assert type(p) is t_sync.EntriesMsg and p.payloads == pay
        assert np.array_equal(p.arrays["key"], key)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        T.wire_loads(pickle.dumps(j_sync.make_blocks, protocol=4))


class _Node:
    """A user value type whose instances may refer to themselves."""

    def __init__(self, tag):
        self.tag = tag
        self.me = self

    def __eq__(self, other):
        return isinstance(other, _Node) and other.tag == self.tag


@pytest.mark.parametrize("value", ["cyclic", "shared"])
def test_spliced_payloads_decode_equal_in_both_packages(value):
    """A payload dict large enough to be C-pickled and spliced: a cyclic
    user value sends the dict through the pure-Python pickler instead
    (fast mode refuses cycles), and a value shared by every entry comes
    back equal in every entry; the JAX package's ``pickle.loads`` and the
    port's reader decode the same payloads."""
    shared = [1, "v", (2.5, None)]
    pay = {
        (7, i % 64, i): (f"k{i}", _Node(i) if value == "cyclic" else shared)
        for i in range(2 * T._SPLICE_MIN)
    }
    em = t_sync.EntriesMsg(originator="a", frm="a", to="b", buckets=np.arange(3),
                           arrays={"rows": np.arange(8, dtype=np.int32)}, payloads=pay)
    frame = T.wire_dumps(("sink", em), 5)
    for load in (pickle.loads, T.wire_loads):
        _n, got = load(frame)
        assert got.payloads == pay
        if value == "cyclic":
            assert all(v.me is v for _k, v in got.payloads.values())
