"""Durable delta write-ahead log — O(delta) durability for O(delta) work.

The PyTorch port's own copy of ``delta_crdt_ex_tpu/runtime/wal.py`` (the
port imports nothing of the JAX package). Records and segments are the
JAX package's, byte for byte, so either package recovers a log the
other wrote.

The reference persists by writing the WHOLE replica image through
storage on every state change (``causal_crdt.ex:402-403``) — O(state)
serialisation cost per mutation, the write-through bottleneck SURVEY
§5.4 flags. Deltas are already irredundant join decompositions (Enes et
al. 2018), so the natural durability unit is the delta itself: this
module logs mutation batches and accepted remote delta slices as
CRC-checked, length-prefixed records in rolling segment files, and
recovery becomes *snapshot + replay* through the replica's normal
idempotent merge path (double-apply is harmless by lattice idempotence).

Wire format (all little-endian):

- segment file ``seg-<start_seq:020d>.wal``:
  ``MAGIC(8)`` then a header record, then data records;
- every record is ``[u32 length][u32 crc32(payload)][payload]`` where
  the payload is a pickled dict. The header record's payload carries
  ``{"layout", "node_id", "start_seq"}`` — layout-tagged like snapshots
  (:data:`~delta_crdt_ex_tpu_torch.runtime.storage.CURRENT_LAYOUT`), so a
  build with an incompatible engine layout refuses the log instead of
  replaying garbage; ``node_id`` preserves dot-namespace continuity
  even when the crash landed before the first snapshot.

Data records (``seq`` is the replica's applied-batch sequence number
AFTER the apply, contiguous across records):

- ``{"kind": "batch", "seq", "ops": [(f, key_term, value)...], "ts":
  [int...]}`` — one local mutation batch with the exact LWW timestamps
  it minted (replay re-applies through ``_flush_batch`` under a replay
  clock that replays those stamps, so dot counters and LWW outcomes
  reproduce bit-for-bit);
- ``{"kind": "entries", "seq", "arrays": {col: np.ndarray}, "payloads",
  "buckets"}`` — one accepted remote delta slice (host-plane numpy
  image of the ``EntriesMsg``), replayed through the normal merge
  kernel.

Group commit: ``append`` encodes into an in-process buffer (raw
``os.write``/``os.fsync`` file I/O — no Python buffering, so a crashed
replica loses exactly the uncommitted suffix, nothing less). ``commit``
marks a durability point; the ``fsync_mode`` knob picks the cadence:

- ``"record"`` — write + fsync on every append (safest, slowest);
- ``"batch"``  — write + fsync once per commit (one mutation batch or
  one accepted slice; the group-commit default);
- ``"interval"`` — write per commit, fsync at most every
  ``fsync_interval`` seconds (the replica's event loop also calls
  ``maybe_sync`` so an idle replica still reaches disk);
- ``"none"`` — write per commit, never fsync (tests / ephemera).

A torn tail record (short read or CRC mismatch in the LAST segment) is
truncated away on recovery, not crashed on; corruption in a non-final
segment raises :class:`WalCorruption` — that is real data loss, not an
interrupted append. Compaction deletes segments fully covered by a
snapshot's ``sequence_number``; the active segment is rotated first so
every segment can eventually be reclaimed.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import struct
import time
import zlib
from typing import Any, Iterator

from delta_crdt_ex_tpu_torch.runtime.storage import (
    CURRENT_LAYOUT,
    fsync_dir,
    require_layout,
)
from delta_crdt_ex_tpu_torch.utils.faults import CrashInjected, faultpoint

logger = logging.getLogger("delta_crdt_ex_tpu_torch")

MAGIC = b"DCWAL001"
_HEADER = struct.Struct("<II")  # record length, crc32(payload)

FSYNC_MODES = ("record", "batch", "interval", "none")


class WalCorruption(Exception):
    """Unrecoverable log damage (corruption NOT at the tail)."""


@dataclasses.dataclass
class SegmentInfo:
    """In-memory index entry for one segment file."""

    path: str
    start_seq: int  # first data-record seq this segment may hold


def _encode(payload: dict) -> bytes:
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    return _HEADER.pack(len(blob), zlib.crc32(blob)) + blob


def _iter_records(blob: bytes, offset: int) -> Iterator[tuple[int, dict]]:
    """Yield ``(end_offset, payload)`` per complete CRC-valid record;
    stop (without raising) at the first torn/short/corrupt record — the
    caller decides whether stopping early is truncation or corruption."""
    n = len(blob)
    while offset + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(blob, offset)
        start = offset + _HEADER.size
        end = start + length
        if end > n:
            return  # short record: torn mid-payload
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            return  # torn/corrupt record
        yield end, pickle.loads(payload)
        offset = end


def _stream_records(path: str, chunk: int = 256 << 10) -> Iterator[tuple[int, dict]]:
    """Stream ``(record_bytes, payload)`` from one segment file WITHOUT
    loading the whole segment: the file is read in ``chunk``-sized
    blocks and :func:`_iter_records` parses each block's buffer, with
    the unconsumed tail carried into the next block so records spanning
    block boundaries (or larger than a block) still parse whole. Stops
    at the first torn/corrupt record exactly like ``_iter_records`` —
    range reads over the ACTIVE segment race an in-flight append
    harmlessly (the half-written tail reads as torn and simply ends the
    stream; the caller's cursor picks it up next round). The first
    yielded payload is the segment header."""
    with open(path, "rb") as f:
        buf = f.read(max(chunk, len(MAGIC)))
        if buf[: len(MAGIC)] != MAGIC:
            return  # torn at birth / foreign file: nothing servable
        off = len(MAGIC)
        while True:
            for end, payload in _iter_records(buf, off):
                yield end - off, payload
                off = end
            # truncation vs corruption: when the buffer already holds
            # the stuck record WHOLE (length prefix satisfied) and it
            # still failed to parse, more bytes cannot help — stop, or
            # a mid-segment CRC tear would rebuffer the rest of the
            # file quadratically chunk by chunk. When the prefix says
            # the record is BIGGER than a chunk, read the exact
            # remainder in one call — chunk-sized nibbling would
            # re-copy the accumulated buffer once per chunk (quadratic
            # in the record size).
            want = chunk
            if len(buf) - off >= _HEADER.size:
                length, _crc = _HEADER.unpack_from(buf, off)
                need = _HEADER.size + length - (len(buf) - off)
                if need <= 0:
                    return  # complete but unparseable: corruption
                want = max(need, chunk)
            nxt = f.read(want)
            if not nxt:
                return
            buf = buf[off:] + nxt
            off = 0


class WalLog:
    """One replica's write-ahead delta log in ``directory``.

    Not thread-safe by itself — the replica serialises all calls under
    its own lock, like every other piece of host state.
    """

    def __init__(
        self,
        directory: str,
        *,
        fsync_mode: str = "batch",
        segment_bytes: int = 4 << 20,
        fsync_interval: float = 0.05,
    ):
        if fsync_mode not in FSYNC_MODES:
            raise ValueError(
                f"{fsync_mode!r} is not a valid fsync_mode; pick one of {FSYNC_MODES}"
            )
        self.directory = directory
        self.fsync_mode = fsync_mode
        self.segment_bytes = int(segment_bytes)
        self.fsync_interval = float(fsync_interval)
        os.makedirs(directory, exist_ok=True)
        self.node_id: int | None = None  # bound after recovery/first init
        self.recovered_bytes = 0  # data bytes scanned by the last recover()
        self._dir_synced = False  # parent dirent of the log dir persisted
        self._segments: list[SegmentInfo] = self._scan_segments()
        self._fd: int | None = None
        self._buf = bytearray()
        self._size = 0  # bytes in the active segment (including header)
        self._last_seq = 0  # highest data-record seq ever appended/seen
        self._dirty = False  # bytes written since the last fsync
        self._last_sync = time.monotonic()
        #: memoised compaction horizon (None = recompute): appends never
        #: move it (new records extend the servable suffix), only
        #: compaction and recovery do — so sync openers can stamp it
        #: every tick without re-reading segment heads
        self._horizon: int | None = None

    # ------------------------------------------------------------------
    # segment bookkeeping

    def _scan_segments(self) -> list[SegmentInfo]:
        segs = []
        for fn in os.listdir(self.directory):
            if fn.startswith("seg-") and fn.endswith(".wal"):
                try:
                    start = int(fn[4:-4])
                except ValueError:
                    continue
                segs.append(SegmentInfo(os.path.join(self.directory, fn), start))
        segs.sort(key=lambda s: s.start_seq)
        return segs

    def _open_segment(self, start_seq: int) -> None:
        assert self.node_id is not None, "bind(node_id) before appending"
        path = os.path.join(self.directory, f"seg-{start_seq:020d}.wal")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        header = _encode(
            {"layout": CURRENT_LAYOUT, "node_id": self.node_id, "start_seq": start_seq}
        )
        os.write(fd, MAGIC + header)
        if self.fsync_mode != "none":
            # persist the DIRENT too: fsyncing record bytes into a file
            # whose directory entry is still cache-only would let power
            # loss vanish the whole segment, records and all — and the
            # same applies one level up for a freshly created log dir
            fsync_dir(self.directory)
            if not self._dir_synced:
                fsync_dir(os.path.dirname(self.directory) or ".")
                self._dir_synced = True
        self._fd = fd
        self._size = len(MAGIC) + len(header)
        # a start_seq can be REUSED when recovery truncated a segment's
        # first record and its re-mint reopens the same filename — the
        # stale index entry must not survive as a duplicate
        self._segments = [s for s in self._segments if s.path != path]
        self._segments.append(SegmentInfo(path, start_seq))

    def bind(self, node_id: int) -> None:
        """Set the dot-namespace id stamped into segment headers (called
        once the replica knows its identity — post-recovery)."""
        self.node_id = int(node_id)

    # ------------------------------------------------------------------
    # append / group commit

    def append(self, record: dict) -> int:
        """Stage one data record; returns its encoded size in bytes.
        Durability follows ``fsync_mode`` — ``"record"`` reaches disk
        here, everything else at :meth:`commit`."""
        faultpoint("wal.append")
        seq = int(record["seq"])
        blob = _encode(record)
        if self._fd is None:
            self._open_segment(seq)
        self._buf += blob
        self._last_seq = seq
        if self.fsync_mode == "record":
            self._write_out(fsync=True)
        return len(blob)

    def abort(self) -> None:
        """Drop staged-but-unwritten bytes after a failed append/commit.
        The caller rolls its seq back and re-stages on retry — an
        aborted record left in the buffer would ride the NEXT group
        commit alongside the re-minted seq, and recovery (correctly)
        rejects a duplicate-seq log as corrupt. Written-but-unfsynced
        bytes are :meth:`_scrub`-ed inside :meth:`_write_out` itself;
        this handles the stage-only window before them."""
        self._buf.clear()

    def commit(self) -> None:
        """Group-commit boundary: flush staged records to the OS, fsync
        per ``fsync_mode``, and rotate the segment if it outgrew
        ``segment_bytes``.

        A failed roll does not fail the commit: the records are already
        written and fsynced, so a caller that rolled its seq back would
        re-mint a seq the log holds, and recovery would reject the
        duplicate as a regressed sequence. So a commit that fills its
        segment fsyncs its batch first, in every mode but ``"none"`` (the
        tail fsync that :meth:`rotate` would do): a failure there scrubs
        the batch and propagates, as in batch mode. Then the roll can
        fail only at its own fault point or its close: the segment stays
        open and the next commit rolls it. (The JAX package raises here;
        ``ROADMAP.md`` §3 records that fault.) A crash injection still
        propagates: the process is dying."""
        rolls = self._size + len(self._buf) >= self.segment_bytes
        self._write_out(
            fsync=self.fsync_mode == "batch" or (rolls and self.fsync_mode != "none")
        )
        if self.fsync_mode == "interval":
            self.maybe_sync()
        if rolls:
            try:
                self.rotate()
            except CrashInjected:
                raise
            except Exception:
                logger.warning(
                    "WAL %s: segment roll failed; the next commit retries",
                    self.directory, exc_info=True,
                )

    def maybe_sync(self) -> None:
        """Interval-mode deferred fsync (also called from the replica's
        event loop so an idle replica still reaches disk). A no-op in
        every other mode — ``"none"`` means NEVER fsync, and
        record/batch modes are clean at commit boundaries."""
        if self.fsync_mode != "interval":
            return
        if (
            self._dirty
            and self._fd is not None
            and time.monotonic() - self._last_sync >= self.fsync_interval
        ):
            os.fsync(self._fd)
            self._dirty = False
            self._last_sync = time.monotonic()

    def _write_out(self, fsync: bool) -> None:
        staged = b""
        base = None  # file length before THIS batch's bytes landed
        if self._buf:
            if self._fd is None:
                raise WalCorruption("append buffer with no open segment")
            frac = faultpoint("wal.write")
            if frac is not None:
                # cooperating partial-write injection: persist only a
                # prefix of the staged bytes (fsynced, so the torn tail
                # is deterministically on disk), then die — the
                # recovery legs' reproducible truncate-the-tail input
                buf = bytes(self._buf)
                n = max(1, min(len(buf) - 1, int(len(buf) * frac)))
                os.write(self._fd, buf[:n])
                os.fsync(self._fd)
                self._buf.clear()
                raise CrashInjected(
                    f"partial WAL write injected: {n}/{len(buf)} bytes"
                )
            staged = bytes(self._buf)
            base = os.fstat(self._fd).st_size
            try:
                os.write(self._fd, staged)
            except BaseException:
                # the batch may be partially written; the caller rolls
                # its seq back and will RE-stage these records, so both
                # the file tail and the buffer must forget them
                self._buf.clear()
                self._scrub(base)
                raise
            self._size += len(staged)
            self._buf.clear()
            self._dirty = True
        if fsync and self._dirty and self._fd is not None:
            try:
                faultpoint("wal.fsync")
                os.fsync(self._fd)
            except BaseException:
                if base is not None:
                    # failure atomicity for the group commit: this
                    # batch's bytes are written but not fsynced, while
                    # the caller's seq rollback + retry will re-append
                    # the same seqs — scrub the batch or recovery later
                    # reads a duplicate-seq log and (correctly) calls
                    # it corrupt ("sequence regressed")
                    self._scrub(base)
                    self._size -= len(staged)
                raise
            self._dirty = False
            self._last_sync = time.monotonic()

    def _scrub(self, base: int) -> None:
        """Roll the active segment back to ``base`` bytes after a failed
        group commit. The segment fd is NOT ``O_APPEND`` (writes track
        the seek cursor), so the cursor must follow the truncate or the
        next batch would land past EOF and leave a hole. The truncate is
        itself fsynced: a scrub that only lives in page cache could
        resurrect the aborted batch on power loss."""
        try:
            os.ftruncate(self._fd, base)
            os.lseek(self._fd, base, os.SEEK_SET)
            os.fsync(self._fd)
        except OSError:
            # the device itself is failing; recovery's tail scan (and
            # its seq-regression check) is the remaining line of defence
            pass

    def rotate(self) -> None:
        """Close the active segment; the next append opens a fresh one.
        Rotation is what makes the once-active segment eligible for
        compaction. Interval mode fsyncs the tail here regardless of
        cadence: ``maybe_sync`` can never reach a closed fd, so an
        unflushed tail would otherwise stay cache-only forever."""
        faultpoint("wal.rotate")
        self._write_out(fsync=self.fsync_mode != "none")
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
            self._size = 0

    # ------------------------------------------------------------------
    # recovery

    def recover(self) -> tuple[dict | None, list[dict]]:
        """Scan all segments in order; returns ``(header, records)``
        where ``header`` is the newest segment header (None when the log
        is empty) and ``records`` every CRC-valid data record in seq
        order. A torn tail in the FINAL segment is truncated in place;
        damage anywhere else raises :class:`WalCorruption`."""
        header: dict | None = None
        records: list[dict] = []
        self.recovered_bytes = 0
        self._horizon = None  # truncation/discard may move the horizon
        self._segments = self._scan_segments()
        for i, seg in enumerate(self._segments):
            is_last = i == len(self._segments) - 1
            with open(seg.path, "rb") as f:
                blob = f.read()
            if blob[: len(MAGIC)] != MAGIC:
                # power loss between the dirent fsync and the first
                # content fsync leaves a durable empty/short segment —
                # torn at birth, nothing committed was in it
                if is_last:
                    logger.warning(
                        "WAL %s: missing/torn magic; discarding segment", seg.path
                    )
                    os.unlink(seg.path)
                    self._segments.pop(i)
                    break
                raise WalCorruption(f"{seg.path}: bad magic")
            good_end = len(MAGIC)
            seg_header = None
            for end, payload in _iter_records(blob, len(MAGIC)):
                if seg_header is None:
                    seg_header = payload
                    require_layout(
                        payload.get("layout", "<untagged>"), f"WAL segment {seg.path}"
                    )
                else:
                    if records and int(payload["seq"]) <= int(records[-1]["seq"]):
                        raise WalCorruption(
                            f"{seg.path}: sequence regressed "
                            f"({payload['seq']} after {records[-1]['seq']})"
                        )
                    records.append(payload)
                    self.recovered_bytes += end - good_end
                good_end = end
            if seg_header is None:
                # not even the header survived — an append torn at birth
                if is_last:
                    logger.warning("WAL %s: torn header; discarding segment", seg.path)
                    os.unlink(seg.path)
                    self._segments.pop(i)
                    break
                raise WalCorruption(f"{seg.path}: unreadable header")
            header = seg_header
            if good_end < len(blob):
                if not is_last:
                    raise WalCorruption(
                        f"{seg.path}: corrupt record mid-log at byte {good_end}"
                    )
                logger.warning(
                    "WAL %s: torn tail at byte %d of %d — truncating",
                    seg.path, good_end, len(blob),
                )
                with open(seg.path, "r+b") as f:
                    f.truncate(good_end)
        if records:
            self._last_seq = int(records[-1]["seq"])
        if header is not None and self.node_id is None:
            self.node_id = int(header["node_id"])
        # appends continue in a FRESH segment: reopening the truncated
        # tail for append would need seek bookkeeping for zero benefit
        return header, records

    # ------------------------------------------------------------------
    # range reads (log-shipping catch-up)

    @property
    def last_seq(self) -> int:
        """Highest data-record seq ever appended or recovered — the
        upper bound of what a range read can serve."""
        return self._last_seq

    def horizon(self) -> int:
        """The compaction horizon: the lowest ``lo`` such that
        :meth:`read_range` can serve EVERY record in ``(lo, last_seq]``.
        A catch-up request below it must fall back to the digest walk
        for the pre-horizon prefix. Computed from the head of the oldest
        retained segment (one small read — no index to maintain) and
        memoised: appends only extend the servable suffix, so the value
        is invalidated by compaction and recovery alone. An empty log's
        horizon is ``last_seq`` (nothing servable) — memoising that is
        still sound because the next append's record carries
        ``last_seq + k`` and serving starts right above the memo."""
        if self._horizon is None:
            h: int | None = None
            for seg in self._scan_segments():
                header_seen = False
                for _n, payload in _stream_records(seg.path):
                    if not header_seen:
                        header_seen = True
                        continue
                    h = int(payload["seq"]) - 1
                    break
                if h is not None:
                    break
            self._horizon = self._last_seq if h is None else h
        return self._horizon

    def read_range(
        self,
        lo: int,
        hi: int,
        *,
        max_records: int = 4096,
        max_bytes: int = 4 << 20,
    ) -> tuple[list[dict], int, bool]:
        """Serve data records with ``lo < seq ≤ hi``, oldest first,
        bounded by ``max_records`` / ``max_bytes`` of scanned record
        payload. Returns ``(records, next_seq, exhausted)`` where
        ``next_seq`` is the seq of the last record returned (== ``lo``
        when none) — the cursor a chunked reader resumes from — and
        ``exhausted`` is True when every record ≤ ``hi`` currently on
        disk was returned. The scan streams segments record by record
        (:func:`_stream_records`) and skips segments wholly below the
        cursor, so a chunked catch-up re-reads at most one segment's
        prefix per call, never the whole log. Callers serve from the
        window membership-gated compaction retains (``_ack_floor``);
        records compacted away are simply absent — detect that with
        :meth:`horizon`, not here."""
        records: list[dict] = []
        seen_bytes = 0
        cursor = lo
        segs = self._scan_segments()
        for i, seg in enumerate(segs):
            # a segment's records end where the next segment starts;
            # the final segment runs to the last appended seq
            end_seq = segs[i + 1].start_seq - 1 if i + 1 < len(segs) else self._last_seq
            if end_seq <= lo:
                continue  # wholly below the cursor: skip without reading
            if seg.start_seq > hi + 1:
                break
            header_seen = False
            for n_bytes, payload in _stream_records(seg.path):
                if not header_seen:
                    header_seen = True
                    continue
                seq = int(payload["seq"])
                if seq <= lo:
                    continue
                if seq > hi:
                    return records, cursor, True
                records.append(payload)
                cursor = seq
                seen_bytes += n_bytes
                if len(records) >= max_records or seen_bytes >= max_bytes:
                    return records, cursor, cursor >= min(hi, self._last_seq)
        return records, cursor, True

    # ------------------------------------------------------------------
    # compaction

    def compact(self, covered_seq: int) -> tuple[int, int]:
        """Delete segments whose every record has seq ≤ ``covered_seq``
        (i.e. fully captured by a snapshot). The active segment is
        rotated first so it, too, becomes reclaimable. Returns
        ``(segments_deleted, bytes_reclaimed)``."""
        self.rotate()
        deleted = 0
        freed = 0
        keep: list[SegmentInfo] = []
        segs = self._segments
        for i, seg in enumerate(segs):
            # a segment's records end where the next segment starts; the
            # final segment's end is the last appended seq
            end_seq = segs[i + 1].start_seq - 1 if i + 1 < len(segs) else self._last_seq
            if end_seq <= covered_seq and seg.start_seq <= covered_seq + 1:
                try:
                    freed += os.path.getsize(seg.path)
                    os.unlink(seg.path)
                    deleted += 1
                except FileNotFoundError:
                    pass  # already gone (e.g. a deduped reopen): drop it
                except OSError:
                    keep.append(seg)
            else:
                keep.append(seg)
        self._segments = keep
        self._horizon = None  # reclaimed segments raise the horizon
        if deleted and self.fsync_mode != "none":
            fsync_dir(self.directory)
        return deleted, freed

    # ------------------------------------------------------------------

    def close(self, *, flush: bool = True) -> None:
        """Close the log. ``flush=False`` models a crash: staged bytes
        in the append buffer are DROPPED (exactly what a process death
        loses under the chosen fsync cadence)."""
        if not flush:
            self._buf.clear()
        else:
            self._write_out(fsync=self.fsync_mode != "none")
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
            self._size = 0

    def segment_paths(self) -> list[str]:
        """Current on-disk segment files, oldest first (observability +
        tests)."""
        return [s.path for s in self._scan_segments()]

    def size_bytes(self) -> int:
        """On-disk footprint of every retained segment plus the staged
        (uncommitted) append buffer — the ``crdt_wal_bytes`` gauge the
        observability plane polls at scrape time."""
        total = len(self._buf)
        for seg in self._scan_segments():
            try:
                total += os.path.getsize(seg.path)
            except OSError:
                pass  # compaction may race a scrape; a gone segment is 0
        return total


class ReplayClock:
    """Replays the exact LWW timestamps a logged batch minted, so
    replay through ``_flush_batch`` reproduces dots and LWW outcomes
    bit-for-bit. Quacks like :class:`~delta_crdt_ex_tpu_torch.runtime.clock.
    Clock` for the two minting calls the flush paths make."""

    def __init__(self, ts: list[int]):
        import numpy as np

        self._ts = np.asarray(ts, np.int64)
        self._i = 0
        self._np = np

    def next(self) -> int:
        v = int(self._ts[self._i])
        self._i += 1
        return v

    def next_n(self, n: int):
        out = self._ts[self._i : self._i + n]
        assert len(out) == n, "replay batch shorter than its ts record"
        self._i += n
        return out

    def observe(self, ts: int) -> None:  # pragma: no cover - parity stub
        pass


def wal_record_bytes(record: dict) -> int:
    """Encoded size of a record without staging it (benchmark/telemetry
    helper)."""
    return len(_encode(record))


__all__ = [
    "FSYNC_MODES",
    "ReplayClock",
    "SegmentInfo",
    "WalCorruption",
    "WalLog",
    "wal_record_bytes",
]
