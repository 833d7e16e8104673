"""Columnar binary op-log topics: `SharedFileTopic`'s batch-framed twin.

Copied from fluidframework_tpu/server/columnar_log.py: the truncation
header (`_pack_trunc`, :87-109), `default_log_format` (:111),
`make_topic` (:121), `make_tail_reader` (:129), `ColumnarFileTopic`
(:136) and `ColumnarTailReader` (:525) with `poll_batches`. Left out:
`tail_records_reverse` (:663-760), the summary catch-up's backward scan
(ROADMAP.md Queue 1 item 4, with the summarizer's role).

One `ColumnarFileTopic` append writes ONE fence-gated, CRC-guarded
record-batch frame (`protocol.record_batch`) instead of one JSON line
per record. The robustness contract matches `SharedFileTopic`, lifted
from lines to batches:

- **Torn tail**: a frame whose bytes are not fully on disk is never
  consumed. The next append seals a crash-torn tail by truncating it
  away; complete units are never truncated. A committed-length sidecar
  (``<path>.clen``) bounds the seal scan; it is a hint, not an
  authority.
- **Corruption**: a frame whose CRC no longer matches is skipped but
  its records stay counted, so offsets stay stable across readers; a
  frame whose header is hit is skipped by a bounded magic-resync scan
  and counts one record slot.
- **Fencing**: identical to `SharedFileTopic` (same ``.fence``
  sidecar, same `FencedError` gate under the same lock); the accepted
  (fence, owner) is also stamped into each frame header.
- **Mixed history**: readers parse JSON lines and binary frames in one
  file, so a JSONL topic may continue columnar after a restart.

`ColumnarTailReader` mirrors `queue.TailReader` (incremental byte
position, identical record offsets) and adds `poll_batches()`: raw
`RecordBatch` objects whose columns feed `server.deli_kernel`.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, List, Optional, Tuple

from ..protocol.record_batch import (
    count_records,
    encode_batch,
    iter_units,
)
from .queue import SharedFileTopic, TailReader, check_disk_fault, fsync_file


__all__ = [
    "ColumnarFileTopic",
    "ColumnarTailReader",
    "LOG_FORMATS",
    "TRUNC_HEADER_LEN",
    "default_log_format",
    "make_tail_reader",
    "make_topic",
]

LOG_FORMATS = ("json", "columnar")

# -- prefix truncation (the retention plane's fenced op-log TRUNCATE) --
#
# A truncated topic file begins with this fixed header naming the
# LOGICAL stream position its first physical data byte maps to:
#
#     magic "\x00FTR" | u64 base_records | u64 base_bytes | u32 crc
#
# Record offsets and byte positions are LOGICAL — stable across
# truncation — so checkpointed offsets, `inOff` bookkeeping and
# manifest byte offsets never move when the prefix behind a durable
# summary is reclaimed (`ColumnarFileTopic.truncate_prefix`,
# `server.retention`). The leading NUL byte can never open a JSON line
# and never matches the frame MAGIC, so a header-unaware scan fails
# loudly instead of misparsing. JSONL topics do not truncate: the
# retention role requires the columnar log format.
TRUNC_MAGIC = b"\x00FTR"
_TRUNC = struct.Struct("<4sQQI")  # magic, base_records, base_bytes, crc
TRUNC_HEADER_LEN = _TRUNC.size


def _pack_trunc(base_records: int, base_bytes: int) -> bytes:
    crc = zlib.crc32(struct.pack("<QQ", base_records, base_bytes))
    return _TRUNC.pack(TRUNC_MAGIC, base_records, base_bytes, crc)

def default_log_format(explicit: Optional[str] = None) -> str:
    """Resolve a log format: explicit arg > ``FLUID_LOG_FORMAT`` env >
    "json". Loud on typos — a silently-misrouted format would
    invalidate benches and chaos runs."""
    fmt = explicit or os.environ.get("FLUID_LOG_FORMAT", "json")
    if fmt not in LOG_FORMATS:
        raise ValueError(f"log_format {fmt!r} not in {LOG_FORMATS}")
    return fmt


def make_topic(path: str, log_format: Optional[str] = None):
    """Topic factory for the supervised farm / benches: "json" →
    `SharedFileTopic`, "columnar" → `ColumnarFileTopic`."""
    fmt = default_log_format(log_format)
    return ColumnarFileTopic(path) if fmt == "columnar" else \
        SharedFileTopic(path)


def make_tail_reader(topic, line_offset: int = 0):
    """The matching incremental reader for either topic flavor."""
    if isinstance(topic, ColumnarFileTopic):
        return ColumnarTailReader(topic, line_offset)
    return TailReader(topic, line_offset)


class ColumnarFileTopic(SharedFileTopic):
    """A cross-process topic over one record-batch log file.

    Drop-in `SharedFileTopic` sibling: same constructor, same
    `append_many(...) -> bytes-written` contract, same
    `read_entries`/`read_from` record-offset semantics (JSON lines in
    the same file count one record each — the migration path), same
    fence sidecar and `FencedError` gate."""

    log_format = "columnar"

    # -------------------------------------------------- committed length

    def _clen_path(self) -> str:
        return self.path + ".clen"

    def _read_committed(self) -> Optional[int]:
        try:
            with open(self._clen_path()) as f:
                return int(json.load(f)["len"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _write_committed(self, n: int) -> None:
        # Deliberately NOT fsynced: the data fsync precedes this write,
        # so after an OS crash the sidecar can only UNDERSTATE (stale
        # value → the seal scan covers more bytes, correct) or be
        # junk/missing (full scan, correct) — it can never name bytes
        # that are not durable. Dropping the fsync halves the columnar
        # append's durability cost (one fsync per batch, not two).
        tmp = self._clen_path() + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"len": int(n)}, f)
            f.flush()
        os.replace(tmp, self._clen_path())

    @staticmethod
    def _scan_clean_len(data: bytes) -> int:
        """Byte length of the longest prefix made of complete units
        (frames or newline-terminated lines) — the committed length of
        a topic that predates its sidecar (a migrated JSONL file)."""
        pos = 0
        for _kind, _idx, _cnt, _payload, end in iter_units(data):
            pos = end
        return pos

    # -------------------------------------------------- truncation base

    @staticmethod
    def _parse_base(head: bytes) -> Tuple[int, int, int]:
        """(base_records, base_bytes, header_len) off a file's first
        `TRUNC_HEADER_LEN` bytes — (0, 0, 0) for a never-truncated
        file (or a garbled header, which reads as ordinary data and
        fails loudly downstream rather than silently re-basing)."""
        if len(head) >= TRUNC_HEADER_LEN and \
                head[:4] == TRUNC_MAGIC:
            _m, r, b, crc = _TRUNC.unpack(head[:TRUNC_HEADER_LEN])
            if crc == zlib.crc32(head[4:20]):
                return int(r), int(b), TRUNC_HEADER_LEN
        return 0, 0, 0

    def base_offsets(self) -> Tuple[int, int]:
        """(base_records, base_bytes): the logical stream position of
        this topic's first physically-present unit. (0, 0) until a
        `truncate_prefix` reclaims something. Records/bytes below the
        base are GONE — readers that need them must boot from a
        summary (the retention contract)."""
        try:
            with open(self.path, "rb") as f:
                r, b, _h = self._parse_base(f.read(TRUNC_HEADER_LEN))
        except OSError:
            return 0, 0
        return r, b

    # ----------------------------------------------------------- append

    def __init__(self, path: str):
        super().__init__(path)
        # Process-local seal hint: the LOGICAL clean length after OUR
        # last append (complete units only, so it stays valid whatever
        # other writers append after it — and logical, so a concurrent
        # prefix truncation cannot strand it mid-frame). Bounds the
        # seal scan for unsynced-append topics whose on-disk sidecar
        # is pinned.
        self._seal_hint = 0
        # True while this topic holds appends that were never fsynced
        # (fsync=False legs): the on-disk sidecar must not advance
        # over them — after an OS crash it could otherwise name bytes
        # the page cache lost, and the seal scan trusts it.
        self._unsynced = False

    def _inode_stable(self, f) -> bool:
        """Whether the locked fd still names `self.path`: a concurrent
        `truncate_prefix` REPLACES the file (atomic rename), so an
        appender that opened the old inode and then won its flock
        would otherwise write acknowledged bytes into an orphan."""
        try:
            return os.stat(self.path).st_ino == os.fstat(f.fileno()).st_ino
        except OSError:
            return False

    def append_many(self, messages: List[Any],
                    fence: Optional[int] = None,
                    owner: Optional[str] = None,
                    lock_timeout_s: Optional[float] = None,
                    fsync: bool = True,
                    src: Optional[str] = None) -> int:
        """Append `messages` — plain records and/or pre-columnized
        `ColumnarRecords` segments, spliced in order — as ONE binary
        record-batch frame under the OS lock; returns the frame bytes
        written (0 for an empty batch, which still gates the fence — a
        deposed owner must learn it is deposed even with nothing to
        write).

        ``src`` stamps the frame-level ``inSrc`` tag
        (`record_batch.FLAG_SRC`): every record decoded out of this
        append carries ``"inSrc": src`` — the elastic pred-drain tag
        without per-record dict emission.

        ``fsync=False`` skips the data fsync AND pins the committed-
        length sidecar (a sidecar naming un-fsynced bytes could
        overstate after an OS crash): torn-tail-safe but not crash-
        durable — the derived-feed contract (`SharedFileTopic`
        .append_many has the full story). A later ``fsync=True``
        append re-covers everything (fsync flushes the whole file) and
        resumes the sidecar."""
        from .queue import flock_exclusive

        while True:
            with open(self.path, "r+b") as f:
                with flock_exclusive(f, lock_timeout_s, self.path):
                    if not self._inode_stable(f):
                        continue  # truncation replaced the file: reopen
                    wrote = self._append_locked(
                        f, messages, fence, owner, fsync, src
                    )
                    break
        if wrote:
            # Event-driven consumers wake now (outside the lock, after
            # durability — queue.TopicDoorbell semantics, both formats).
            self._ring_doorbells()
        return wrote

    def _append_locked(self, f, messages, fence, owner, fsync,
                       src) -> int:
        self._gate_fence(fence, owner)
        f.seek(0)
        base_r, base_b, hlen = self._parse_base(
            f.read(TRUNC_HEADER_LEN)
        )
        f.seek(0, os.SEEK_END)
        size = f.tell()
        committed = self._read_committed()  # PHYSICAL length
        # The sidecar is a HINT that bounds the seal scan, not
        # an authority over the data: EXTEND it over any
        # complete units past it (JSON-era lines appended while
        # the farm ran the other format, frames whose sidecar
        # update was lost to a crash) so a format round-trip
        # can never truncate acknowledged records; only the
        # genuinely torn suffix (partial frame, unterminated
        # line) is sealed away — it was never acknowledged.
        # The process-local hint covers our own unsynced
        # appends, whose bytes the sidecar must not name. The
        # hint is LOGICAL: a truncation between our appends
        # re-bases the file, and mapping through the current
        # base keeps the hint on the same unit boundary.
        hint_phys = hlen + max(0, self._seal_hint - base_b)
        start = max(hlen if committed is None
                    else min(max(committed, hlen), size),
                    min(hint_phys, size))
        f.seek(start)
        clean = start + self._scan_clean_len(f.read())
        if size > clean:
            f.truncate(clean)
        if not count_records(messages):
            self._seal_hint = base_b + (clean - hlen)
            if committed != clean and not self._unsynced:
                # The scan may have covered bytes ANOTHER
                # writer appended fsync=False (a dead fused
                # consumer's broadcast frames — our local
                # `_unsynced` flag can't see them): fsync the
                # data BEFORE the sidecar names it, preserving
                # the file-global "sidecar never overstates
                # durable data" invariant. Rare path — fence
                # binds and recovery, never the steady state.
                fsync_file(f, "topic")
                self._write_committed(clean)
            return 0
        cur_fence, cur_owner = self.latest_fence()
        frame = encode_batch(messages, fence=cur_fence,
                             owner=cur_owner, src=src)
        check_disk_fault("topic")
        f.seek(clean)
        f.write(frame)
        f.flush()
        self._seal_hint = base_b + (clean + len(frame) - hlen)
        if fsync:
            fsync_file(f, "topic")
            self._unsynced = False
            # Data is durable BEFORE the length names it.
            self._write_committed(clean + len(frame))
        else:
            self._unsynced = True
        return len(frame)

    # ------------------------------------------------------- truncation

    def truncate_prefix(self, upto_records: int, min_bytes: int = 0,
                        dry_run: bool = False,
                        lock_timeout_s: Optional[float] = None
                        ) -> Tuple[int, int]:
        """Physically reclaim every complete unit whose records ALL sit
        below logical record offset `upto_records` (the cut lands on
        the greatest unit boundary <= it). Returns the
        ``(base_records, base_bytes)`` the call decided on — the
        current base when nothing qualifies (or the reclaimable run is
        under `min_bytes`), the planned new base with ``dry_run=True``
        (nothing touched), the installed new base otherwise.

        Crash-safe by construction: the replacement file (truncation
        header + the untouched suffix bytes, fsynced) is atomically
        renamed over the topic, so a reader sees the old complete file
        or the new complete file, never a mix; the committed-length
        sidecar is DELETED before the rename and rewritten after, so a
        crash anywhere in the window costs at worst a full seal scan.
        Offsets are unchanged — record indices and byte positions are
        logical, and the header preserves the mapping.

        NOT fence-gated: the topic's fence belongs to its WRITER role,
        and binding another would depose it. The caller's zombie
        safety comes from the fenced COMMIT record that precedes every
        reclaim (`server.retention` — a deposed retention role dies at
        its own topic's fence before bytes go away; re-executing an
        already-applied cut is a no-op since the base only grows)."""
        from .queue import flock_exclusive

        while True:
            with open(self.path, "r+b") as f:
                with flock_exclusive(f, lock_timeout_s, self.path):
                    if not self._inode_stable(f):
                        continue
                    return self._truncate_locked(
                        f, int(upto_records), min_bytes, dry_run
                    )

    def _truncate_locked(self, f, upto_records: int, min_bytes: int,
                         dry_run: bool) -> Tuple[int, int]:
        # Orphan sweep: a crash between the tmp write below and its
        # rename leaves `<topic>.trunc.tmp.<pid>` behind — nothing
        # else ever removes it, and it counts against the disk bound
        # this plane exists to hold. The flock serializes truncators,
        # so any such sibling here is a dead writer's.
        tdir = os.path.dirname(self.path) or "."
        tprefix = os.path.basename(self.path) + ".trunc.tmp."
        try:
            for fn in os.listdir(tdir):
                if fn.startswith(tprefix):
                    try:
                        os.unlink(os.path.join(tdir, fn))
                    except OSError:
                        pass
        except OSError:
            pass
        f.seek(0)
        base_r, base_b, hlen = self._parse_base(
            f.read(TRUNC_HEADER_LEN)
        )
        if upto_records <= base_r:
            return base_r, base_b
        f.seek(hlen)
        data = f.read()
        cut_rel = 0
        cut_records = base_r
        for _kind, idx, cnt, _payload, end in iter_units(data, base_r):
            if idx + cnt > upto_records:
                break
            cut_rel, cut_records = end, idx + cnt
        if cut_records <= base_r or cut_rel < max(1, min_bytes):
            return base_r, base_b
        new_r, new_b = cut_records, base_b + cut_rel
        if dry_run:
            return new_r, new_b
        suffix = data[cut_rel:]
        check_disk_fault("topic")
        tmp = self.path + f".trunc.tmp.{os.getpid()}"
        with open(tmp, "wb") as tf:
            tf.write(_pack_trunc(new_r, new_b))
            tf.write(suffix)
            tf.flush()
            fsync_file(tf, "topic")
        # Sidecar OUT before the swap: its physical length is about to
        # change, and a stale value pointing mid-frame in the new file
        # would poison the seal scan. A crash between these steps
        # leaves no sidecar — full scan, correct.
        try:
            os.remove(self._clen_path())
        except OSError:
            pass
        os.replace(tmp, self.path)
        try:
            dfd = os.open(os.path.dirname(self.path) or ".",
                          os.O_RDONLY)
            try:
                os.fsync(dfd)  # the rename itself must survive a crash
            finally:
                os.close(dfd)
        except OSError:
            pass
        # The whole replacement file was fsynced above, so the fresh
        # sidecar may name every complete unit in it.
        self._write_committed(
            TRUNC_HEADER_LEN + self._scan_clean_len(suffix)
        )
        self._seal_hint = max(self._seal_hint, new_b)
        from ..utils.metrics import get_registry

        get_registry().counter(
            "topic_truncations_total",
            topic=os.path.basename(self.path),
        ).inc()
        return new_r, new_b

    # ------------------------------------------------------------- read

    def _read_based(self) -> Tuple[bytes, int, int, int]:
        """``(data_after_header, base_records, base_bytes,
        header_len)`` — the physical file with any truncation header
        stripped, plus the logical base it establishes. Readers rely
        on the torn-unit rules (an incomplete frame or unterminated
        line is never consumed), so an in-flight append is naturally
        invisible and a stale sidecar can never hide acknowledged
        records. Complete units are never truncated by the seal path,
        so what a reader consumed stays consumed (prefix truncation
        only reclaims units behind a committed retention record)."""
        try:
            with open(self.path, "rb") as f:
                head = f.read(TRUNC_HEADER_LEN)
                base_r, base_b, hlen = self._parse_base(head)
                rest = f.read()
        except OSError:
            return b"", 0, 0, 0
        return (rest if hlen else head + rest), base_r, base_b, hlen

    def _read_data(self) -> bytes:
        """The file's unit data (truncation header stripped)."""
        return self._read_based()[0]

    def read_entries(self, offset: int,
                     max_count: Optional[int] = None
                     ) -> Tuple[List[Tuple[int, Any]], int]:
        """Same contract as `SharedFileTopic.read_entries`, over mixed
        frames + JSON lines: record offsets are stable (CRC-skipped
        batches and junk lines stay counted; a truncated prefix keeps
        its logical offsets — its records are simply absent), torn
        units are never consumed, `max_count` caps the parsed entries
        taken."""
        data, base_r, _base_b, _hlen = self._read_based()
        if not data:
            return [], max(offset, base_r)

        def capped():
            return max_count is not None and len(out) >= max_count

        out: List[Tuple[int, Any]] = []
        idx = base_r
        for kind, idx0, cnt, payload, _end in iter_units(data, base_r):
            if capped():
                break
            idx = idx0 + cnt
            if kind == "batch":
                if payload is None or idx <= offset:
                    continue  # CRC-skipped or entirely below the offset
                recs = payload.records()
                for i in range(max(0, offset - idx0), cnt):
                    if capped():
                        break
                    out.append((idx0 + i, recs[i]))
            elif idx0 >= offset:
                line = payload.strip()
                if line:
                    try:
                        out.append((idx0, json.loads(line)))
                    except ValueError:
                        pass  # sealed junk from a crashed writer
        if capped():
            return out, (out[-1][0] + 1 if out else offset)
        return out, max(offset, idx)


class ColumnarTailReader:
    """Incremental reader over a `ColumnarFileTopic` (the `TailReader`
    role): remembers the byte position after the last fully-consumed
    unit, so each poll reads only NEW committed bytes — `read_entries`
    is O(file) per call, which would make a long-lived consumer
    O(file²) over its lifetime. Record offsets (`next_line`) are
    identical to `read_entries` offsets, and — like `TailReader` — a
    `line_offset` AHEAD of the file keeps `next_line == line_offset`
    (records below it are swallowed silently as they appear, never
    delivered).

    `poll()` yields decoded records for legacy consumers;
    `poll_batches()` yields raw `RecordBatch` objects (plus decoded
    stray JSON records from a migrated history) for the kernel deli's
    zero-JSON ingest. `max_count` is a batch-granular bound: a batch is
    always consumed whole, and no new batch starts once the cap is
    reached."""

    def __init__(self, topic: ColumnarFileTopic, line_offset: int = 0):
        self.topic = topic
        self.next_line = line_offset
        # LOGICAL byte position after the last consumed unit, and the
        # record index of the unit there. Logical positions are stable
        # under prefix truncation (physical = logical - base_bytes +
        # header_len), so a long-lived reader survives a concurrent
        # TRUNCATE without re-anchoring. A cold reader (offset at/below
        # the base) needs only the header — the O(file) read happens
        # solely when a record offset must be translated to bytes.
        base_r, base_b = topic.base_offsets()
        self._pos = base_b
        self._abs = base_r
        if line_offset > base_r:
            # One O(file) scan translates the record offset into a byte
            # position; everything after is incremental. Stops before
            # the unit CONTAINING the offset (mid-batch delivery is
            # handled record-wise in _poll_units). Fresh base values
            # from the same read: a truncate between the header probe
            # and this scan only ever advances the base.
            data, base_r, base_b, _hlen = topic._read_based()
            self._pos = base_b
            self._abs = base_r
            for _kind, idx, cnt, _payload, end in iter_units(
                    data, base_r):
                if idx + cnt > line_offset:
                    break
                self._pos = base_b + end
                self._abs = idx + cnt

    def _read_new(self) -> bytes:
        """Only the bytes past `_pos` (incremental tail); the torn-unit
        rules bound what of them is consumable. Re-reads the truncation
        base per poll: a concurrent TRUNCATE moves the physical layout
        while logical positions stand still."""
        try:
            with open(self.topic.path, "rb") as f:
                base_r, base_b, hlen = self.topic._parse_base(
                    f.read(TRUNC_HEADER_LEN)
                )
                if self._pos < base_b:
                    # Our position was reclaimed (a reader behind the
                    # cut — the retention role only cuts behind every
                    # tracked consumer, so this is a COLD reader):
                    # records between are gone; resume at the base.
                    self._pos = base_b
                    self._abs = max(self._abs, base_r)
                f.seek(hlen + (self._pos - base_b))
                return f.read()
        except OSError:
            return b""

    def _poll_units(self, max_count: Optional[int]):
        data = self._read_new()
        if not data:
            return []
        units: List[tuple] = []  # ("batch", start_line, RecordBatch)
        #                        | ("rec", line, value)
        taken = 0
        consumed_bytes = 0
        for kind, rel_idx, cnt, payload, end in iter_units(
                data, self._abs):
            if max_count is not None and taken >= max_count:
                break
            consumed_bytes = end
            self._abs = rel_idx + cnt
            if kind == "batch":
                # Records below next_line (a checkpoint taken against a
                # longer topic) are swallowed without delivery.
                skip = max(0, min(cnt, self.next_line - rel_idx))
                if payload is not None and skip < cnt:
                    if skip == 0:
                        units.append(("batch", rel_idx, payload))
                    else:  # offset lands mid-batch: deliver the tail
                        recs = payload.records()
                        units.extend(
                            ("rec", rel_idx + i, recs[i])
                            for i in range(skip, cnt)
                        )
                    taken += cnt - skip
            elif rel_idx >= self.next_line:
                line = payload.strip()
                if line:
                    try:
                        units.append(("rec", rel_idx, json.loads(line)))
                        taken += 1
                    except ValueError:
                        pass  # sealed junk
            self.next_line = max(self.next_line, self._abs)
        self._pos += consumed_bytes
        return units

    def poll_batches(self, max_count: Optional[int] = None) -> List[tuple]:
        """New committed units as ``("batch", start_line, RecordBatch)``
        / ``("rec", line, value)`` tuples, in stream order."""
        return self._poll_units(max_count)

    def poll(self, max_count: Optional[int] = None
             ) -> List[Tuple[int, Any]]:
        """Decoded-records view (the `TailReader.poll` contract, with
        batch-granular `max_count`)."""
        out: List[Tuple[int, Any]] = []
        for unit in self._poll_units(max_count):
            if unit[0] == "batch":
                _, start, batch = unit
                recs = batch.records()
                out.extend((start + i, recs[i]) for i in range(batch.n))
            else:
                out.append((unit[1], unit[2]))
        return out
