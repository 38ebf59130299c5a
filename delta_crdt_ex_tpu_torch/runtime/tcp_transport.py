"""Cross-host control-plane transport (reference: distributed Erlang) —
the PyTorch port's own copy of ``delta_crdt_ex_tpu/runtime/tcp_transport.py``,
speaking the JAX package's wire so a JAX replica and a torch replica can
share one cluster.

The reference gets cross-node distribution for free from the BEAM:
location-transparent ``send/2`` to ``{name, node}`` over the full-mesh
TCP of distributed Erlang (``causal_crdt_test.exs:68-78``). One
:class:`TcpTransport` per host process carries length-prefixed pickled
frames over persistent TCP connections, with remote addresses written
``(name, (host, port))`` — the ``{name, node}`` analog. Local names
behave exactly like :class:`~delta_crdt_ex_tpu_torch.runtime.transport.
LocalTransport` addresses, so a replica's protocol code is transport-
agnostic.

Monitors over TCP are heartbeat-based: a background thread pings each
monitored remote every ``heartbeat_interval``; a failed ping delivers
:class:`~delta_crdt_ex_tpu_torch.runtime.transport.Down` to the watcher
— the ``:DOWN`` analog (``causal_crdt.ex:127-145``). Like distributed
Erlang inside a trusted cluster, frames are pickled Python objects: this
transport assumes a trusted network.

**The wire codec for two packages.** Frames are pickles, and a pickle
names each class by module path. The JAX package dispatches on its own
``delta_crdt_ex_tpu.runtime.sync`` classes, so the port WRITES its
message classes (and ``Down``) under the JAX package's module paths: a
JAX peer's plain ``pickle.loads`` returns its own classes. The port
READS frames naming either package's path into its own classes through
a restricted ``find_class`` that refuses every other name under the JAX
package, so decoding a JAX frame never imports JAX. Writing a class
under a foreign path needs the pure-Python pickler (the C pickler
checks the path by importing it); large plain containers inside a
message (the payload dicts) are pickled by the C pickler and spliced
into the stream, and the big arrays ride ``_MSGB``'s out-of-band
buffers, so the pure-Python pickler handles only the envelope. Frames
need not be byte-equal to the JAX package's; they decode equal.
"""

from __future__ import annotations

import io
import logging
import pickle
import queue
import socket
import struct
import threading
import time
import zlib
from typing import Any, Hashable

import numpy as np

from delta_crdt_ex_tpu_torch.runtime import sync as sync_proto
from delta_crdt_ex_tpu_torch.runtime.transport import Down, forward_fleet_entries
from delta_crdt_ex_tpu_torch.utils.faults import FaultInjected, faultpoint

logger = logging.getLogger("delta_crdt_ex_tpu_torch")

_LEN = struct.Struct(">I")

# frame kinds (the JAX package's numbering: one wire)
_MSG = 0
_PING = 1
_PONG = 2
_MSGZ = 3  # zlib-compressed _MSG — only sent to peers that advertised
# _FEAT_MSGZ in the HELLO exchange (legacy peers get plain _MSG frames)
_HELLO = 4  # capability negotiation: payload = [wire_version, features]
_MSGB = 5  # arrays side-channel: pickle-5 head + out-of-band buffers,
# each buffer raw or zlib'd by a sampled compressibility probe
_FLEETF = 6  # fleet egress envelope: one frame carrying a FleetFrameMsg —
# many fleet members' per-peer sync messages to one co-located peer
# process, decoded back to per-member mailbox deliveries here; only sent
# to peers that advertised _FEAT_FLEET

_WIRE_VERSION = 1
_FEAT_MSGZ = 1  # feature bit: peer accepts zlib-compressed _MSG frames
_FEAT_MSGB = 2  # feature bit: peer accepts _MSGB array-buffer frames
_FEAT_FLEET = 4  # feature bit: peer accepts _FLEETF fleet-frame envelopes
_OUR_FEATURES = _FEAT_MSGZ | _FEAT_MSGB | _FEAT_FLEET

#: how long the HELLO waiter keeps reading for a late reply before giving
#: up (a legacy peer never replies and just costs one daemon thread)
_HELLO_WAIT_S = 30.0

#: compress whole _MSG frames at least this large
_COMPRESS_MIN = 4096

# ---------------------------------------------------------------------------
# the wire codec

#: the port's wire classes → the JAX package's path for each: what the
#: port writes
_JAX_PATHS = {
    cls: ("delta_crdt_ex_tpu.runtime.sync", cls.__name__)
    for cls in (
        sync_proto.DiffMsg,
        sync_proto.GetDiffMsg,
        sync_proto.EntriesMsg,
        sync_proto.GetLogMsg,
        sync_proto.LogChunkMsg,
        sync_proto.AckMsg,
        sync_proto.FleetFrameMsg,
    )
}
_JAX_PATHS[Down] = ("delta_crdt_ex_tpu.runtime.transport", "Down")
#: (module, name) → the port's class, under either package's path: what
#: the port reads
_READ_CLASSES = {path: cls for cls, path in _JAX_PATHS.items()}
_READ_CLASSES.update({(cls.__module__, cls.__qualname__): cls for cls in _JAX_PATHS})

#: containers at least this long are pickled by the C pickler and
#: spliced into the envelope's stream (see :class:`_WirePickler`)
_SPLICE_MIN = 64


class _NotPlain(Exception):
    """A container holds a wire class or an array: no C splice."""


class _PlainPickler(pickle.Pickler):
    """The C pickler for containers of plain data (payload dicts: dots
    and user terms), refusing wire classes (they need the JAX paths)
    and arrays (they belong out of band)."""

    def reducer_override(self, obj):
        if type(obj) in _JAX_PATHS or isinstance(obj, np.ndarray) or (isinstance(obj, type) and obj in _JAX_PATHS):
            raise _NotPlain
        return NotImplemented


def _plain_body(obj) -> "bytes | None":
    """``obj``'s pickle opcodes without header and STOP, or None when it
    is not plain. Protocol 3 (no frames) in fast mode (no memo opcodes):
    the body then pushes ``obj`` and touches no memo slot, so it splices
    into any protocol-5 stream without disturbing the outer memo. Fast
    mode writes an object once for each reference to it, so a value
    shared by many entries arrives as equal copies (the frame is as
    large as if each entry held its own); it refuses a cycle, and that
    container then goes to the pure-Python pickler, memo and all."""
    buf = io.BytesIO()
    p = _PlainPickler(buf, protocol=3)
    p.fast = True
    try:
        p.dump(obj)
    except (_NotPlain, ValueError):
        return None
    return buf.getvalue()[2:-1]  # PROTO 3 … STOP


class _WirePickler(pickle._Pickler):
    """Pickles the port's wire classes under the JAX package's module
    paths (a ``GLOBAL`` opcode naming ``delta_crdt_ex_tpu.runtime.sync``)
    and splices large plain containers pickled by the C pickler."""

    def save(self, obj, save_persistent_id=True):
        if type(obj) in (dict, list) and len(obj) >= _SPLICE_MIN and id(obj) not in self.memo:
            body = _plain_body(obj)
            if body is not None:
                self.framer.commit_frame()
                self.write(body)
                return
        super().save(obj, save_persistent_id)

    def save_global(self, obj, name=None):
        path = _JAX_PATHS.get(obj) if isinstance(obj, type) else None
        if path is None:
            return super().save_global(obj, name)
        self.write(pickle.GLOBAL + f"{path[0]}\n{path[1]}\n".encode("utf-8"))
        self.memoize(obj)


class _WireUnpickler(pickle.Unpickler):
    """Reads either package's wire classes as the port's own; refuses
    every other name under the JAX package (the port never imports it)."""

    def find_class(self, module, name):
        cls = _READ_CLASSES.get((module, name))
        if cls is not None:
            return cls
        if module.split(".")[0] == "delta_crdt_ex_tpu":
            raise pickle.UnpicklingError(
                f"refusing {module}.{name}: the only JAX-package names on "
                "the wire are its sync messages and Down"
            )
        return super().find_class(module, name)


def wire_dumps(obj, protocol: int = 4, buffer_callback=None) -> bytes:
    """Pickle ``obj`` for the wire (the JAX package's class paths)."""
    f = io.BytesIO()
    _WirePickler(f, protocol, buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def wire_loads(data, buffers=None):
    """Unpickle a frame written by either package into the port's
    classes."""
    return _WireUnpickler(io.BytesIO(data), buffers=buffers).load()


def _send_frame(sock: socket.socket, kind: int, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload) + 1) + bytes([kind]) + payload)


_BUF_HDR = struct.Struct(">BI")  # per-buffer: flags (1 = zlib), wire length
_Z_SAMPLE = 1 << 12  # probe the first and last 2 KiB for compressibility


def _maybe_z_buffer(mv: memoryview) -> "tuple[int, bytes | memoryview]":
    """Per-buffer compression decision: compress only when a cheap
    sample probe predicts a real win (at least 2×). The head and the
    tail are probed apart: wire tiers pad slices with TRAILING zero
    rows, so a head-only probe would miss exactly the padding it exists
    for."""
    n = mv.nbytes
    if n >= _COMPRESS_MIN:
        mvb = mv.cast("B")
        half = _Z_SAMPLE // 2
        head = bytes(mvb[:half]) if n > half else bytes(mvb)
        tail = bytes(mvb[-half:]) if n > 2 * half else b""
        zh, zt = len(zlib.compress(head, 1)), len(zlib.compress(tail, 1))
        if (zh + zt) * 3 <= len(head) + len(tail) or (tail and zt * 8 <= len(tail)):
            z = zlib.compress(mv, 1)
            if len(z) * 2 <= n:
                return 1, z
    return 0, mv


#: below this much raw buffer data the side-channel's per-buffer probe
#: and framing overheads beat its copy savings — small messages stay on
#: the whole-frame path
_MSGB_MIN = 256 << 10


def _encode_msgb(obj, min_bytes: int = 0, tally: "dict | None" = None) -> bytes | None:
    """(head, buffers) wire form: pickle protocol 5 with out-of-band
    buffers — the big numpy slice columns are framed as raw (or
    probe-compressed) bytes instead of being copied through the pickle
    stream. Returns None when the buffers hold fewer than ``min_bytes``
    (the caller then uses the whole-frame path). ``tally`` counts the
    buffers sent raw and zlib'd, and their bytes before and after."""
    bufs: list[pickle.PickleBuffer] = []

    def keep_oob(pb: pickle.PickleBuffer):
        # a FALSY return serialises out of band; non-contiguous buffers
        # cannot be framed raw and stay in band
        try:
            pb.raw()
        except BufferError:
            return True
        bufs.append(pb)
        return False

    head = wire_dumps(obj, 5, buffer_callback=keep_oob)
    if sum(pb.raw().nbytes for pb in bufs) < min_bytes:
        return None
    parts = [struct.pack(">II", len(bufs), len(head)), head]
    for pb in bufs:
        raw = pb.raw()
        flags, data = _maybe_z_buffer(raw)
        if tally is not None:
            kind = "zlib" if flags & 1 else "raw"
            tally[kind] += 1
            tally[kind + "_bytes_in"] += raw.nbytes
            tally[kind + "_bytes_out"] += len(data)
        parts.append(_BUF_HDR.pack(flags, len(data)))
        parts.append(data)
    return b"".join(parts)


def _decode_msgb(payload: bytes):
    n_bufs, head_len = struct.unpack_from(">II", payload, 0)
    off = 8
    head = payload[off : off + head_len]
    off += head_len
    bufs = []
    for _ in range(n_bufs):
        flags, wire_len = _BUF_HDR.unpack_from(payload, off)
        off += _BUF_HDR.size
        data = payload[off : off + wire_len]
        off += wire_len
        # bytearray: reconstructed arrays are WRITABLE like the whole-
        # frame path's, so a handler never sees which path a message took
        bufs.append(bytearray(zlib.decompress(data)) if flags & 1 else bytearray(data))
    return wire_loads(head, buffers=bufs)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    # pieces joined once: growing one bytes object piece by piece copies
    # the frame over and over, in time quadratic in its size (memory
    # still grows only as the bytes arrive, whatever the header claims)
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 24))
        if not chunk:
            return None
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _recv_frame(sock: socket.socket) -> tuple[int, bytes] | None:
    """Read one length-prefixed frame; ``(kind, payload)`` or None on a
    short read. The HELLO waiter keeps its own cross-timeout byte buffer,
    so a wire-format change must update both."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    body = _recv_exact(sock, _LEN.unpack(hdr)[0])
    if not body:
        return None
    return body[0], body[1:]


def _start_hello_negotiation(conn: "_SenderConn") -> None:
    """Negotiate wire capabilities on a fresh outbound connection without
    ever blocking the send path: send our HELLO, then a short-lived
    daemon thread waits for the peer's reply and flips the connection's
    feature flags when it lands. Until then (and forever, for a peer
    that never replies) the connection advertises no optional feature,
    so compression is never sent to a peer that did not claim it."""
    try:
        _send_frame(conn.sock, _HELLO, bytes([_WIRE_VERSION, _OUR_FEATURES]))
    except OSError:
        return  # the sender thread will discover the dead socket itself

    def wait_reply() -> None:
        # bytes accumulate locally across read timeouts, so a reply that
        # trickles in still parses at the right frame boundary; only
        # timeouts keep the loop going
        deadline = time.monotonic() + _HELLO_WAIT_S
        buf = b""
        while time.monotonic() < deadline:
            try:
                chunk = conn.sock.recv(65536)
            except TimeoutError:
                continue
            except OSError:
                return  # reset/closed: stay feature-less
            if not chunk:
                return
            buf += chunk
            while len(buf) >= 4:
                ln = _LEN.unpack(buf[:4])[0]
                if len(buf) < 4 + ln:
                    break
                body, buf = buf[4 : 4 + ln], buf[4 + ln :]
                if ln >= 1 and body[0] == _HELLO:
                    if ln >= 3:
                        conn.accepts_z = bool(body[2] & _FEAT_MSGZ)
                        conn.accepts_b = bool(body[2] & _FEAT_MSGB)
                        conn.accepts_f = bool(body[2] & _FEAT_FLEET)
                    return  # a short/malformed HELLO concludes feature-less

    threading.Thread(target=wait_reply, daemon=True, name="tcp-hello-wait").start()


class _SenderConn:
    """One pooled outbound connection with its own send queue + thread.

    ``sendall`` to a stalled peer can block for the full socket timeout;
    pushing it onto a per-connection thread means one slow peer delays
    only its own queue — every other edge keeps flowing. A full queue
    drops the frame (anti-entropy is idempotent and retried, so
    backpressure loss only delays convergence)."""

    QUEUE_MAX = 256
    #: byte bound beside the frame-count bound: a stalled peer caps on
    #: bytes queued, not just frames. One frame larger than the bound
    #: (a catch-up chunk of a large table) goes in behind less than the
    #: bound, so the queue holds at most the bound plus that frame; the
    #: JAX package drops such a frame every time it is offered
    QUEUE_MAX_BYTES = 64 << 20

    def __init__(self, sock: socket.socket, on_dead, accepts_z: bool = False, on_sent=None) -> None:
        self.sock = sock
        #: negotiated via HELLO: whether this peer accepts _MSGZ frames
        self.accepts_z = accepts_z
        #: negotiated via HELLO: whether this peer accepts _MSGB frames
        self.accepts_b = False
        #: negotiated via HELLO: whether this peer accepts _FLEETF frames
        self.accepts_f = False
        self._q_bytes = 0  # adjusted under _dead_lock only
        self._q: queue.Queue = queue.Queue(maxsize=self.QUEUE_MAX)
        self._on_dead = on_dead
        #: wire accounting callback, called with each frame's kind and
        #: on-wire size AFTER a successful send
        self._on_sent = on_sent
        self._dead = False
        self._dead_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def enqueue(self, kind: int, payload: bytes, attempt: int = 0) -> bool:
        # the dead flag flips (under this lock) BEFORE the dying sender
        # thread drains the queue, so a late enqueue can never slip in
        # after the drain and be claimed sent but never salvaged
        with self._dead_lock:
            if self._dead:
                return False
            n = len(payload)
            if self._q_bytes + n > self.QUEUE_MAX_BYTES and (
                n <= self.QUEUE_MAX_BYTES or self._q_bytes >= self.QUEUE_MAX_BYTES
            ):
                return False  # byte cap: dropped; periodic sync will retry
            try:
                self._q.put_nowait((kind, payload, attempt))
                self._q_bytes += len(payload)
                return True
            except queue.Full:
                return False  # dropped; periodic sync will retry

    def queued_bytes(self) -> int:
        with self._dead_lock:
            return self._q_bytes

    def close(self) -> None:
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        # close() can run ON the sender thread (the _on_dead path fires
        # from _loop's error handler): joining ourselves would deadlock
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            with self._dead_lock:
                self._q_bytes -= len(item[1])
            try:
                faultpoint("transport.send")
            except FaultInjected:
                # injected send-side loss: this frame is gone, exactly
                # like a dropped packet — periodic anti-entropy heals it
                continue
            try:
                _send_frame(self.sock, item[0], item[1])
                if self._on_sent is not None:
                    self._on_sent(item[0], len(item[1]) + 5)  # + length word + kind
            except OSError:
                # hand the failed frame and the rest of the queue back to
                # the transport: a stale pooled conn (peer restarted) must
                # not silently eat frames the caller was told were sent
                with self._dead_lock:
                    self._dead = True  # late enqueues now refuse
                pending = [item]
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is not None:
                        pending.append(nxt)
                try:
                    self.sock.close()
                except OSError:
                    pass
                self._on_dead(self, pending)
                return


class TcpTransport:
    """Transport with the LocalTransport interface plus TCP remote sends.

    Remote addresses: ``(name, (host, port))``. Everything else (bare
    names) is local to this process.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, heartbeat_interval: float = 0.5):
        self._lock = threading.Lock()
        self._mailboxes: dict[Hashable, queue.Queue] = {}
        self._owners: dict[Hashable, Any] = {}
        self._monitors: dict[Hashable, set[Hashable]] = {}
        self._conns: dict[tuple, _SenderConn] = {}
        self._hb_conns: dict[tuple, socket.socket] = {}  # persistent ping conns
        self.heartbeat_interval = heartbeat_interval
        #: wire accounting, written by the sender and serve threads and
        #: read by :meth:`transport_stats` (its own lock, so the per-frame
        #: bump never contends with register/send/drain)
        self._bytes_lock = threading.Lock()
        self._tx_bytes = 0
        self._rx_bytes = 0
        self._tx_frames: dict[int, int] = {}
        self._rx_frames: dict[int, int] = {}
        self._msgb = dict.fromkeys(
            ("raw", "raw_bytes_in", "raw_bytes_out", "zlib", "zlib_bytes_in", "zlib_bytes_out"), 0
        )
        self._stop = threading.Event()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()

        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"tcp-accept-{self.port}", daemon=True
        )
        self._accept_thread.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"tcp-hb-{self.port}", daemon=True
        )
        self._hb_thread.start()

    @property
    def endpoint(self) -> tuple[str, int]:
        return (self.host, self.port)

    def remote_addr(self, name: Hashable) -> tuple:
        """The ``{name, node}``-style address of a local name, for peers."""
        return (name, self.endpoint)

    canonical_addr = remote_addr  # replicas self-identify cross-node

    # -- local registry (same contract as LocalTransport) -----------------

    def register(self, addr: Hashable, owner: Any) -> None:
        with self._lock:
            if addr in self._owners:
                raise ValueError(f"address already registered: {addr!r}")
            self._mailboxes[addr] = queue.Queue()
            self._owners[addr] = owner

    def unregister(self, addr: Hashable) -> None:
        addr = self._local_name(addr)
        with self._lock:
            self._mailboxes.pop(addr, None)
            self._owners.pop(addr, None)
            watchers = self._monitors.pop(addr, set())
        for w in watchers:
            self.send(w, Down(addr))

    def _is_remote(self, addr) -> bool:
        return (
            isinstance(addr, tuple)
            and len(addr) == 2
            and isinstance(addr[1], tuple)
            and len(addr[1]) == 2
            and addr[1] != self.endpoint
        )

    def alive(self, addr: Hashable) -> bool:
        if self._is_remote(addr):
            return self._ping(addr)
        addr = self._local_name(addr)
        with self._lock:
            return addr in self._owners

    def device_of(self, addr: Hashable):
        """The pinned device of a same-process replica; None for an
        unpinned one and for a remote address (cross-host slices
        serialise on the host plane)."""
        if self._is_remote(addr):
            return None
        with self._lock:
            return getattr(self._owners.get(self._local_name(addr)), "pinned_device", None)

    def _local_name(self, addr):
        # a remote-style address pointing at ourselves resolves locally
        if isinstance(addr, tuple) and len(addr) == 2 and addr[1] == self.endpoint:
            return addr[0]
        return addr

    # -- sending -----------------------------------------------------------

    def send(self, addr: Hashable, msg: Any) -> bool:
        if self._is_remote(addr):
            return self._send_remote(addr, (_MSG, addr[0], msg))
        name = self._local_name(addr)
        with self._lock:
            mb = self._mailboxes.get(name)
            owner = self._owners.get(name)
        if mb is None:
            return False
        mb.put(msg)
        notify = getattr(owner, "notify", None)
        if notify is not None:
            notify()
        return True

    def _connect(self, endpoint: tuple) -> "_SenderConn | None":
        with self._lock:
            conn = self._conns.get(endpoint)
        if conn is not None:
            return conn
        if self._stop.is_set():
            return None
        try:
            sock = socket.create_connection(endpoint, timeout=2.0)
            sock.settimeout(5.0)
        except OSError:
            return None

        def on_dead(dead_conn, pending):
            with self._lock:
                if self._conns.get(endpoint) is dead_conn:
                    del self._conns[endpoint]
            # salvage frames that died on a stale pooled connection: one
            # reconnect attempt per frame (the attempt tag prevents a
            # retry loop against a flapping peer)
            retry = [(k, p) for k, p, attempt in pending if attempt == 0]
            if retry and not self._stop.is_set():
                fresh = self._connect(endpoint)
                if fresh is not None:
                    for k, p in retry:
                        # renegotiated down (or the fresh HELLO has not
                        # landed yet): re-frame for the lowest common
                        # denominator
                        if k == _MSGZ and not fresh.accepts_z:
                            k, p = _MSG, zlib.decompress(p)
                        elif k == _MSGB and not fresh.accepts_b:
                            k, p = _MSG, wire_dumps(_decode_msgb(p), 4)
                        elif k == _FLEETF and not fresh.accepts_f:
                            # unbundle the envelope: one frame per entry
                            fm = _decode_msgb(p)
                            for to, m in fm.entries:
                                self._send_remote(to, (_MSG, to[0], m))
                            continue
                        fresh.enqueue(k, p, attempt=1)

        conn = _SenderConn(sock, on_dead, on_sent=self._count_tx)
        _start_hello_negotiation(conn)
        with self._lock:
            if self._stop.is_set():
                # close() already ran: never insert a conn it would miss
                conn.close()
                return None
            existing = self._conns.get(endpoint)
            if existing is not None:
                conn.close()
                return existing
            self._conns[endpoint] = conn
        return conn

    def _send_remote(self, addr: tuple, frame: tuple) -> bool:
        """Fast-fail if no connection can be established (the dead-
        neighbour signal, ``causal_crdt.ex:269-282``); otherwise enqueue
        on the connection's sender thread and return immediately."""
        _name, endpoint = addr
        conn = self._connect(endpoint)
        if conn is None:
            return False
        kind = frame[0]
        # both wire upgrades are negotiated capabilities (HELLO), never
        # assumed: a legacy peer gets plain pickle-4 frames
        if kind == _MSG and conn.accepts_b:
            payload_b = self._encode_msgb_counted(frame[1:], _MSGB_MIN)
            if payload_b is not None:
                return conn.enqueue(_MSGB, payload_b)
        payload = wire_dumps(frame[1:], 4)
        if kind == _MSG and conn.accepts_z and len(payload) >= _COMPRESS_MIN:
            z = zlib.compress(payload, 1)
            if len(z) < 0.9 * len(payload):  # keep incompressible frames raw
                payload, kind = z, _MSGZ
        return conn.enqueue(kind, payload)

    def _encode_msgb_counted(self, obj, min_bytes: int) -> "bytes | None":
        """``_encode_msgb`` with its buffer counts folded into this
        transport's totals."""
        tally = dict.fromkeys(self._msgb, 0)
        payload = _encode_msgb(obj, min_bytes=min_bytes, tally=tally)
        with self._bytes_lock:
            for k, v in tally.items():
                self._msgb[k] += v
        return payload

    def _count_tx(self, kind: int, n: int) -> None:
        with self._bytes_lock:
            self._tx_bytes += n
            self._tx_frames[kind] = self._tx_frames.get(kind, 0) + 1

    # -- fleet egress frames ------------------------------------------------

    def fleet_sink(self, addr: Hashable) -> "tuple | None":
        """The fleet-frame aggregation key for ``addr``: its remote
        endpoint when the pooled connection there negotiated
        ``_FEAT_FLEET``, else ``None`` (per-member frames — a local
        peer, a dead endpoint, a legacy peer, or a HELLO still in
        flight)."""
        if not self._is_remote(addr):
            return None
        endpoint = addr[1]
        conn = self._connect(endpoint)
        if conn is None or not conn.accepts_f:
            return None
        return endpoint

    def send_fleet_frame(self, endpoint: tuple, entries: list) -> bool:
        """Ship one fleet egress envelope — many members' per-peer sync
        messages in ONE ``_FLEETF`` frame — to a peer process. Falls back
        to per-member sends when the connection renegotiated down
        between :meth:`fleet_sink` and here; the messages still flow,
        but the return is ``False`` so frame accounting never reports an
        envelope that did not ride the wire."""
        conn = self._connect(endpoint)
        if conn is None:
            return False
        if not conn.accepts_f:
            for to, m in entries:
                self.send(to, m)
            return False
        fm = sync_proto.FleetFrameMsg(frm=self.endpoint, entries=list(entries))
        payload = self._encode_msgb_counted(fm, 0)
        return conn.enqueue(_FLEETF, payload)

    def _deliver_fleet_frame(self, fm) -> None:
        """Fan one received fleet envelope out: local entries deliver to
        mailboxes in send order; entries addressed to another process
        regroup by next-hop endpoint and re-emit as one rewritten frame
        each (``transport.forward_fleet_entries``)."""
        forward_fleet_entries(self, fm.entries)

    def queue_depth(self, addr: Hashable) -> int:
        """Queued messages in one LOCAL mailbox (same contract as
        LocalTransport)."""
        with self._lock:
            mb = self._mailboxes.get(self._local_name(addr))
        return mb.qsize() if mb is not None else 0

    def transport_stats(self) -> dict:
        """Wire accounting: bytes and frames (by kind) sent and received
        over TCP, bytes queued on sender connections (the backpressure
        signal), and the ``_MSGB`` buffers sent raw against zlib'd, with
        their bytes before and after."""
        names = {_MSG: "msg", _PING: "ping", _PONG: "pong", _MSGZ: "msgz", _HELLO: "hello",
                 _MSGB: "msgb", _FLEETF: "fleetf"}
        with self._bytes_lock:
            tx, rx = self._tx_bytes, self._rx_bytes
            tx_f = {names.get(k, str(k)): v for k, v in sorted(self._tx_frames.items())}
            rx_f = {names.get(k, str(k)): v for k, v in sorted(self._rx_frames.items())}
            msgb = dict(self._msgb)
        with self._lock:
            conns = list(self._conns.values())
        return {
            "endpoint": f"{self.host}:{self.port}",
            "tx_bytes": tx,
            "rx_bytes": rx,
            "tx_frames": tx_f,
            "rx_frames": rx_f,
            "msgb_buffers": msgb,
            "queue_bytes": sum(c.queued_bytes() for c in conns),
        }

    @staticmethod
    def _ping_roundtrip(sock: socket.socket) -> bool:
        """One PING → PONG exchange on an open socket (shared by
        ``alive()`` probes and heartbeats)."""
        _send_frame(sock, _PING, b"")
        frame = _recv_frame(sock)
        return frame is not None and frame[0] == _PONG

    def _ping(self, addr: tuple) -> bool:
        # connection-level liveness: a fresh short-lived connection probes
        # the remote listener (a dead listener is the BEAM "node down")
        try:
            with socket.create_connection(addr[1], timeout=1.0) as s:
                s.settimeout(2.0)
                return self._ping_roundtrip(s)
        except OSError:
            return False

    # -- monitors ----------------------------------------------------------

    def monitor(self, watcher: Hashable, target: Hashable) -> bool:
        if not self.alive(target):
            return False
        key = target if not isinstance(target, list) else tuple(target)
        with self._lock:
            self._monitors.setdefault(key, set()).add(watcher)
        return True

    def demonitor(self, watcher: Hashable, target: Hashable) -> None:
        with self._lock:
            self._monitors.get(target, set()).discard(watcher)

    def _hb_drop(self, endpoint: tuple) -> None:
        sock = self._hb_conns.pop(endpoint, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _ping_once(self, endpoint: tuple) -> bool:
        """One ping round trip over the cached per-endpoint connection
        (opened on first use)."""
        sock = self._hb_conns.get(endpoint)
        try:
            if sock is None:
                sock = socket.create_connection(endpoint, timeout=1.0)
                sock.settimeout(2.0)
                self._hb_conns[endpoint] = sock
            if not self._ping_roundtrip(sock):
                raise OSError("bad pong")
            return True
        except OSError:
            self._hb_drop(endpoint)
            return False

    def _ping_persistent(self, endpoint: tuple) -> bool:
        """Heartbeat on a PERSISTENT connection that never declares a
        peer dead on a stale cached socket alone: a failed cached ping
        retries once on a fresh connection. Only the heartbeat thread
        touches ``_hb_conns``."""
        had_conn = self._hb_conns.get(endpoint) is not None
        if self._ping_once(endpoint):
            return True
        return had_conn and self._ping_once(endpoint)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            with self._lock:
                remote_targets = [t for t in self._monitors if self._is_remote(t)]
            # close heartbeat conns for endpoints no longer monitored
            live = {t[1] for t in remote_targets}
            for ep in [e for e in self._hb_conns if e not in live]:
                self._hb_drop(ep)
            for t in remote_targets:
                if not self._ping_persistent(t[1]):
                    with self._lock:
                        watchers = self._monitors.pop(t, set())
                    for w in watchers:
                        self.send(w, Down(t))
        # _stop is set: release the remaining heartbeat conns on this
        # thread (their only writer; close() joins us)
        for ep in list(self._hb_conns):
            self._hb_drop(ep)

    # -- receiving ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _peer = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        warned_unknown = False
        with conn:
            while not self._stop.is_set():
                try:
                    frame = _recv_frame(conn)
                except OSError:
                    return
                if frame is None:
                    return
                kind, payload = frame
                with self._bytes_lock:
                    self._rx_bytes += len(payload) + 5
                    self._rx_frames[kind] = self._rx_frames.get(kind, 0) + 1
                if kind == _PING:
                    try:
                        _send_frame(conn, _PONG, b"")
                    except OSError:
                        return
                elif kind == _HELLO:
                    try:
                        _send_frame(conn, _HELLO, bytes([_WIRE_VERSION, _OUR_FEATURES]))
                    except OSError:
                        return
                elif kind == _MSG:
                    # the JAX package's one receive fault site: a seeded
                    # schedule trips the same frames in both packages
                    try:
                        faultpoint("transport.recv")
                    except FaultInjected:
                        continue  # injected receive-side loss (see send)
                    name, msg = wire_loads(payload)
                    self.send(name, msg)
                elif kind == _MSGZ:
                    name, msg = wire_loads(zlib.decompress(payload))
                    self.send(name, msg)
                elif kind == _MSGB:
                    name, msg = _decode_msgb(payload)
                    self.send(name, msg)
                elif kind == _FLEETF:
                    # decode back to per-member mailbox deliveries, in send
                    # order (the per-member path's ordering)
                    self._deliver_fleet_frame(_decode_msgb(payload))
                elif not warned_unknown:
                    # once per connection: a newer peer streaming frames
                    # must not flood the log
                    warned_unknown = True
                    logger.warning(
                        "dropping unknown frame kind %d (peer on a newer wire "
                        "format?) — further unknown frames on this connection "
                        "are dropped silently", kind)

    # -- deterministic driving (parity with LocalTransport) ----------------

    def drain_nowait(self, addr: Hashable, max_n: int | None = None) -> list:
        """Pop up to ``max_n`` queued messages (all when ``None``) without
        blocking — the ``LocalTransport.drain_nowait`` contract: per-
        mailbox FIFO order holds across message types."""
        with self._lock:
            mb = self._mailboxes.get(self._local_name(addr))
        out: list = []
        if mb is None:
            return out
        while max_n is None or len(out) < max_n:
            try:
                out.append(mb.get_nowait())
            except queue.Empty:
                break
        return out

    def drain(self, addr: Hashable) -> list:
        return self.drain_nowait(addr, None)

    def pump(self, max_rounds: int = 10_000) -> int:
        delivered = 0
        for _ in range(max_rounds):
            progressed = False
            with self._lock:
                addrs = list(self._owners)
            for addr in addrs:
                with self._lock:
                    owner = self._owners.get(addr)
                if owner is None:
                    continue
                for msg in self.drain(addr):
                    owner.handle(msg)
                    delivered += 1
                    progressed = True
            if not progressed:
                return delivered
        raise RuntimeError("transport did not quiesce")

    def close(self) -> None:
        self._stop.set()
        try:
            # shutdown, not just close: on Linux closing a listening
            # socket does not wake a thread blocked in accept()
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # heartbeat conns are owned by the hb thread; joining it (it exits
        # promptly on _stop) lets it close them without a cross-thread race
        self._hb_thread.join(timeout=5)
        # the accept loop unblocks when the listener above shuts down
        self._accept_thread.join(timeout=5)
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
