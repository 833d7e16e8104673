"""Versioned columnar record-batch codec (the binary op-log wire form).

Copied whole from fluidframework_tpu/protocol/record_batch.py (frame
versions 1 and 2, `FLAG_SRC`, the ``K_*`` kinds, `JsonBlob`,
`ColumnarRecords`, `mask_runs`, `encode_batch`, `encode_columns`,
`RecordBatch`, `decode_batch`, `iter_units`, `count_records`); its
`_metrics` hook reports to the port's `utils.metrics` registry. Frames
are byte for byte the reference's, so either package reads the other's
topics.

A record BATCH is one length-prefixed, CRC-guarded, fence-stamped
binary frame whose raw-op fields (doc id, client id, client seq, ref
seq, op kind) are stored as columnar arrays with the payload blobs side
by side, so `server.deli_kernel` ingests a batch as numpy arrays with
no per-record JSON decode, while other consumers decode records lazily
one batch at a time and see plain Python values.

Frame layout (versions 1 and 2, little-endian — the version byte is
per FRAME, so one file mixes both freely):

    magic "FRB1" | u8 version | u8 flags | u32 n_records
    | u32 payload_len | u32 crc32(payload) | i64 fence
    payload:
      u16 owner_len + owner utf-8           (fence stamp's owner)
      [u16 src_len + src utf-8]             (iff flags & FLAG_SRC: the
                                             frame-level ``inSrc`` tag
                                             — see below)
      u32 n_docs + (u16 len + utf-8) * n    (batch-local doc dictionary)
      u8  kind[n]        (K_* codes below)
      u8  type_code[n]   (MessageType table index; 255 = n/a)
      i32 doc_idx[n]
      i64 client[n] | client_seq[n] | ref_seq[n] | seq[n] | msn[n]
      i64 in_off[n]      (-1 = absent)
      u32 blob_off[n+1] + blob heap          (JSON bytes per record)

Schema per kind (records that don't fit a kind exactly ride
``K_GENERIC`` with the whole record as one JSON blob, so the codec is
lossless over arbitrary JSON values):

    K_RAW_OP     {"kind":"op","doc","client","clientSeq","refSeq",
                  "contents"}                blob = contents
    K_RAW_JOIN   {"kind":"join","doc","client"}
    K_RAW_LEAVE  {"kind":"leave","doc","client"}
    K_RAW_BOXCAR {"kind":"boxcar","doc","client","ops":[...]}
                  v1 blob = JSON [[clientSeq, refSeq, contents], ...]
                  v2 blob = NESTED binary (the codec-v2 rev):
                    u32 n_ops | i64 clientSeq[n] | i64 refSeq[n]
                    | u32 off[n+1] | per-op contents JSON heap
                  so a boxcar's per-op ints read as arrays and its
                  per-op contents slice out as raw blobs — no
                  once-per-boxcar JSON decode on ingest, no re-encode
                  when the sequenced ops are emitted (`boxcar()`).
    K_SEQ_OP     {"kind":"op","doc","seq","msn","client","clientSeq",
                  "refSeq","type","contents","inOff"} blob = contents
    K_NACK       {"kind":"nack","doc","client","clientSeq","code",
                  "reason","inOff"}  code rides the seq column,
                  blob = reason
    K_GENERIC    anything else        blob = full record

Raw kinds may ADDITIONALLY carry an ``inOff`` key (the supervised
ingress front door stamps its input offset onto every admitted
record — `server.ingress`): it rides the existing ``in_off`` column
(-1 = absent), so an admission-stamped submit keeps the columnar fast
path instead of falling to K_GENERIC.

The ``FLAG_SRC`` frame flag carries a frame-level ``inSrc`` string
(the elastic fabric's predecessor-drain tag, `server.shard_fabric`):
every record decoded out of a src-tagged frame gains ``"inSrc": src``
— one tag per frame instead of one generic-schema dict per record, so
a ranged role's pred drains keep the `encode_columns` emit fast path.

The EMIT half mirrors the ingest half: `ColumnarRecords` is a batch of
already-columnized records (flat int columns + a blob heap — what the
kernel deli's verdict gather produces), and `encode_columns` turns one
or more of them into a frame with zero per-record classification or
dict building. `encode_batch` accepts ColumnarRecords segments mixed
with plain records in one list, so a columnar producer's stray
dict-path records keep their stream position.

The codec is pure (no I/O, no fencing): `server.columnar_log` owns the
topic semantics (torn-tail safety, fence gating, offsets). Codec
throughput metrics (`codec_encode_*` / `codec_decode_*` /
`codec_encode_columns_total`) report through `utils.metrics`.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .messages import MessageType

__all__ = [
    "ColumnarRecords",
    "DEFAULT_VERSION",
    "FLAG_SRC",
    "HEADER",
    "JsonBlob",
    "K_GENERIC",
    "K_NACK",
    "K_RAW_BOXCAR",
    "K_RAW_JOIN",
    "K_RAW_LEAVE",
    "K_RAW_OP",
    "K_SEQ_OP",
    "MAGIC",
    "MAX_BATCH_BYTES",
    "MAX_RESYNC_CANDIDATES",
    "RecordBatch",
    "SCHEMA_VERSION",
    "SCHEMA_VERSIONS",
    "count_records",
    "decode_batch",
    "encode_batch",
    "encode_columns",
    "iter_units",
    "mask_runs",
]

MAGIC = b"FRB1"
SCHEMA_VERSION = 1
SCHEMA_VERSION_2 = 2
SCHEMA_VERSIONS = (1, 2)
# What new frames are written as. v2 only changes the K_RAW_BOXCAR blob
# layout (nested binary offsets instead of a JSON list), and the
# version byte is per frame, so v1 and v2 frames coexist in one file —
# upgrades need no migration, downgrades only a drained topic (like the
# json⇄columnar rule, one rung smaller).
DEFAULT_VERSION = 2
HEADER = struct.Struct("<4sBBIIIq")  # magic, ver, flags, n, plen, crc, fence
# Frame flag bits. FLAG_SRC: the payload carries a frame-level src
# string (after the owner) applied as ``inSrc`` to every decoded
# record. Flags ride the CRC preimage like every other header field.
FLAG_SRC = 0x01
_KNOWN_FLAGS = FLAG_SRC
MAX_BATCH_BYTES = 256 << 20  # sanity cap: junk that fakes the magic must
#                              not trigger a multi-GB allocation

# Record kinds (the `kind` column).
K_RAW_OP = 0
K_RAW_JOIN = 1
K_RAW_LEAVE = 2
K_RAW_BOXCAR = 3
K_SEQ_OP = 4
K_NACK = 5
K_GENERIC = 255

# Wire `type` strings <-> u8 codes (closed MessageType table; custom
# type strings fall back to K_GENERIC).
_TYPES: Tuple[str, ...] = tuple(t.value for t in MessageType)
_TYPE_CODE: Dict[str, int] = {t: i for i, t in enumerate(_TYPES)}
_NO_TYPE = 255

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# Exact key sets the columnar kinds require (anything else -> generic).
# Raw kinds come in two flavors: the bare client-submit shape, and the
# same + "inOff" (the ingress front door's admission stamp, riding the
# existing in_off column).
_RAW_OP_KEYS = frozenset(("kind", "doc", "client", "clientSeq", "refSeq",
                          "contents"))
_RAW_OP_KEYS_OFF = _RAW_OP_KEYS | {"inOff"}
_RAW_MEMBER_KEYS = frozenset(("kind", "doc", "client"))
_RAW_MEMBER_KEYS_OFF = _RAW_MEMBER_KEYS | {"inOff"}
_RAW_BOXCAR_KEYS = frozenset(("kind", "doc", "client", "ops"))
_RAW_BOXCAR_KEYS_OFF = _RAW_BOXCAR_KEYS | {"inOff"}
_SEQ_OP_KEYS = frozenset(("kind", "doc", "seq", "msn", "client",
                          "clientSeq", "refSeq", "type", "contents",
                          "inOff"))
_NACK_KEYS = frozenset(("kind", "doc", "client", "clientSeq", "code",
                        "reason", "inOff"))


class JsonBlob:
    """Pre-encoded JSON bytes that decode lazily.

    The zero-copy pass-through handle: a consumer that re-emits a
    record's `contents` into another columnar topic hands the raw blob
    straight back to the encoder — no decode, no re-encode. Compares
    (and reprs) by VALUE, so differential/digest comparisons treat it
    as the plain value it encodes."""

    __slots__ = ("raw", "_val", "_decoded")

    def __init__(self, raw: bytes):
        self.raw = bytes(raw)
        self._val = None
        self._decoded = False

    @property
    def value(self) -> Any:
        if not self._decoded:
            self._val = json.loads(self.raw)
            self._decoded = True
        return self._val

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, JsonBlob):
            return self.value == other.value
        return self.value == other

    def __hash__(self):
        return hash(self.raw)

    def __repr__(self) -> str:
        return repr(self.value)


def _json_default(o: Any) -> Any:
    if isinstance(o, JsonBlob):
        return o.value  # a blob NESTED in a generic record: by value
    raise TypeError(
        f"Object of type {o.__class__.__name__} is not JSON serializable"
    )


def _dumps(v: Any) -> bytes:
    """JSON-encode one blob value; a top-level JsonBlob passes through
    raw (zero re-encode), a nested one — a pass-through `contents`
    inside a record that fell to K_GENERIC (extra keys, e.g. a wire
    "tr" trace) — serializes by value."""
    if isinstance(v, JsonBlob):
        return v.raw
    return json.dumps(v, separators=(",", ":"),
                      default=_json_default).encode()


def _is_i64(v: Any) -> bool:
    return type(v) is int and _I64_MIN <= v <= _I64_MAX


def _metrics(kind: str, records: int, nbytes: int, seconds: float) -> None:
    from ..utils.metrics import get_registry

    m = get_registry()
    m.counter(f"codec_{kind}_records_total", codec="columnar").inc(records)
    m.counter(f"codec_{kind}_bytes_total", codec="columnar").inc(nbytes)
    m.histogram(f"codec_{kind}_ms", codec="columnar").observe(
        seconds * 1000.0
    )


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


_BOXCAR_OP_KEYS = frozenset(("clientSeq", "refSeq", "contents"))


def _classify(rec: Any) -> int:
    """The columnar kind for one record (K_GENERIC when it doesn't fit
    a schema exactly — the codec must round-trip arbitrary values)."""
    if not isinstance(rec, dict):
        return K_GENERIC
    kind = rec.get("kind")
    if not isinstance(rec.get("doc"), str):
        return K_GENERIC
    keys = rec.keys()  # dict_keys == set compares C-side, no new set
    if kind == "op":
        if (keys == _RAW_OP_KEYS
                or (keys == _RAW_OP_KEYS_OFF
                    and _is_i64(rec["inOff"]) and rec["inOff"] >= 0)) \
                and _is_i64(rec["client"]) \
                and _is_i64(rec["clientSeq"]) and _is_i64(rec["refSeq"]):
            return K_RAW_OP
        if keys == _SEQ_OP_KEYS and _is_i64(rec["client"]) \
                and _is_i64(rec["clientSeq"]) and _is_i64(rec["refSeq"]) \
                and _is_i64(rec["seq"]) and _is_i64(rec["msn"]) \
                and _is_i64(rec["inOff"]) \
                and rec["type"] in _TYPE_CODE:
            return K_SEQ_OP
        return K_GENERIC
    if kind == "join" and (keys == _RAW_MEMBER_KEYS
                           or (keys == _RAW_MEMBER_KEYS_OFF
                               and _is_i64(rec["inOff"]) and rec["inOff"] >= 0)) \
            and _is_i64(rec["client"]):
        return K_RAW_JOIN
    if kind == "leave" and (keys == _RAW_MEMBER_KEYS
                            or (keys == _RAW_MEMBER_KEYS_OFF
                                and _is_i64(rec["inOff"])
                                and rec["inOff"] >= 0)) \
            and _is_i64(rec["client"]):
        return K_RAW_LEAVE
    if kind == "boxcar" and (keys == _RAW_BOXCAR_KEYS
                             or (keys == _RAW_BOXCAR_KEYS_OFF
                                 and _is_i64(rec["inOff"]) and rec["inOff"] >= 0)) \
            and _is_i64(rec["client"]) and isinstance(rec["ops"], list):
        ok = all(
            isinstance(op, dict) and op.keys() == _BOXCAR_OP_KEYS
            and _is_i64(op["clientSeq"]) and _is_i64(op["refSeq"])
            for op in rec["ops"]
        )
        return K_RAW_BOXCAR if ok else K_GENERIC
    if kind == "nack" and keys == _NACK_KEYS and _is_i64(rec["client"]) \
            and _is_i64(rec["clientSeq"]) and _is_i64(rec["code"]) \
            and _is_i64(rec["inOff"]) and isinstance(rec["reason"], str):
        return K_NACK
    return K_GENERIC


# Per-kind revalidators for the homogeneous-run fast path: once a
# record's exact key set (and kind string) matched the previous
# record's, only the VALUE checks the _classify ladder would have run
# remain — the branch ladder itself is hoisted out of the run. Each
# entry mirrors its _classify branch exactly (the regression test
# compares frames against per-record classification).
def _rv_off(r):
    # Raw kinds' optional admission stamp: the key set already matched
    # the previous record's, so only the value check remains. MUST be
    # non-negative — the column encodes absence as -1, so a negative
    # value would silently drop the key on decode (lossless contract);
    # such records ride K_GENERIC instead.
    return "inOff" not in r or (_is_i64(r["inOff"]) and r["inOff"] >= 0)


def _rv_raw_op(r):
    return isinstance(r["doc"], str) and _is_i64(r["client"]) \
        and _is_i64(r["clientSeq"]) and _is_i64(r["refSeq"]) \
        and _rv_off(r)


def _rv_member(r):
    return isinstance(r["doc"], str) and _is_i64(r["client"]) \
        and _rv_off(r)


def _rv_boxcar(r):
    if not (isinstance(r["doc"], str) and _is_i64(r["client"])
            and isinstance(r["ops"], list) and _rv_off(r)):
        return False
    return all(
        isinstance(op, dict) and op.keys() == _BOXCAR_OP_KEYS
        and _is_i64(op["clientSeq"]) and _is_i64(op["refSeq"])
        for op in r["ops"]
    )


def _rv_seq_op(r):
    return isinstance(r["doc"], str) and _is_i64(r["client"]) \
        and _is_i64(r["clientSeq"]) and _is_i64(r["refSeq"]) \
        and _is_i64(r["seq"]) and _is_i64(r["msn"]) \
        and _is_i64(r["inOff"]) and r["type"] in _TYPE_CODE


def _rv_nack(r):
    return isinstance(r["doc"], str) and _is_i64(r["client"]) \
        and _is_i64(r["clientSeq"]) and _is_i64(r["code"]) \
        and _is_i64(r["inOff"]) and isinstance(r["reason"], str)


_REVALIDATE = {
    K_RAW_OP: _rv_raw_op,
    K_RAW_JOIN: _rv_member,
    K_RAW_LEAVE: _rv_member,
    K_RAW_BOXCAR: _rv_boxcar,
    K_SEQ_OP: _rv_seq_op,
    K_NACK: _rv_nack,
}

_BOX_HDR = struct.Struct("<I")


def _encode_boxcar_v2(ops: List[dict]) -> bytes:
    """The nested v2 K_RAW_BOXCAR blob: per-op ints as columns, per-op
    contents as raw slices of an inner heap — a boxcar rides through
    sequencing with its op blobs untouched."""
    n = len(ops)
    blobs = [_dumps(op["contents"]) for op in ops]
    cs = np.fromiter((op["clientSeq"] for op in ops), np.int64, n)
    rf = np.fromiter((op["refSeq"] for op in ops), np.int64, n)
    offs = np.zeros(n + 1, np.uint32)
    if n:
        offs[1:] = np.cumsum([len(b) for b in blobs])
    return b"".join([_BOX_HDR.pack(n), cs.tobytes(), rf.tobytes(),
                     offs.tobytes(), *blobs])


def _decode_boxcar_v2(blob) -> Tuple[np.ndarray, np.ndarray,
                                     np.ndarray, memoryview]:
    """(clientSeq[n], refSeq[n], off[n+1], contents heap) views over a
    nested v2 boxcar blob."""
    view = memoryview(blob)
    (n,) = _BOX_HDR.unpack_from(view, 0)
    pos = _BOX_HDR.size
    cs = np.frombuffer(view, "<i8", n, pos)
    pos += 8 * n
    rf = np.frombuffer(view, "<i8", n, pos)
    pos += 8 * n
    offs = np.frombuffer(view, "<u4", n + 1, pos)
    pos += 4 * (n + 1)
    return cs, rf, offs, view[pos:]


class ColumnarRecords:
    """A batch of PRE-COLUMNIZED records: the emit twin of the decoded
    `RecordBatch` (same columns, same blob-heap layout, a batch-local
    doc dictionary), built by producers that already hold verdict
    columns — the kernel deli's emission, the fused durable+broadcast
    hop's frame pass-through. `encode_columns`/`encode_batch` splice it
    into a frame with zero per-record work; `record(i)`/iteration
    decode lazily for dict-path consumers (recovery replay, tests).

    K_RAW_BOXCAR rows are rejected: their blob layout is
    frame-VERSION-dependent, so a pass-through segment carrying one
    could silently splice a v1 blob into a v2 frame. (Nothing emits
    boxcars post-sequencing — the deli unpacks them — so the
    restriction costs no real producer anything.)"""

    __slots__ = ("n", "docs", "kind", "type_code", "doc_idx", "client",
                 "client_seq", "ref_seq", "seq", "msn", "in_off",
                 "blob_off", "heap")

    # Segments never carry a frame-level src themselves — the tag is
    # applied at append time (`append_many(src=...)`); the class attr
    # keeps the `_decode_record` column protocol uniform.
    src: Optional[str] = None

    def __init__(self, docs: Sequence[str], kind, type_code, doc_idx,
                 client, client_seq, ref_seq, seq, msn, in_off,
                 blob_off, heap: bytes):
        self.kind = np.ascontiguousarray(kind, np.uint8)
        self.n = int(self.kind.shape[0])
        if np.any(self.kind == K_RAW_BOXCAR):
            raise ValueError(
                "K_RAW_BOXCAR cannot ride a pre-columnized segment "
                "(version-dependent blob layout)"
            )
        self.docs = list(docs)
        self.type_code = np.ascontiguousarray(type_code, np.uint8)
        self.doc_idx = np.ascontiguousarray(doc_idx, np.int32)
        self.client = np.ascontiguousarray(client, np.int64)
        self.client_seq = np.ascontiguousarray(client_seq, np.int64)
        self.ref_seq = np.ascontiguousarray(ref_seq, np.int64)
        self.seq = np.ascontiguousarray(seq, np.int64)
        self.msn = np.ascontiguousarray(msn, np.int64)
        self.in_off = np.ascontiguousarray(in_off, np.int64)
        self.blob_off = np.ascontiguousarray(blob_off, np.uint32)
        self.heap = bytes(heap)

    @classmethod
    def from_batch(cls, rb: "RecordBatch", rows,
                   in_off) -> "ColumnarRecords":
        """Slice `rows` of a decoded `RecordBatch` into an emit segment
        with fresh input offsets (`in_off`: scalar base or per-row
        array) — the zero-decode pass-through a 1:1 consumer (the fused
        durable+broadcast hop) re-emits frames with. Blob bytes copy
        span-wise: consecutive rows share one memcpy."""
        rows = np.ascontiguousarray(rows, np.int64)
        n = rows.shape[0]
        off = rb._blob_off
        lens = off[rows + 1].astype(np.int64) - off[rows]
        new_off = np.zeros(n + 1, np.uint32)
        if n:
            new_off[1:] = np.cumsum(lens)
        heap = _gather_spans(rb._heap, off, rows)
        io = np.broadcast_to(np.asarray(in_off, np.int64), (n,)) \
            if np.ndim(in_off) == 0 else np.asarray(in_off, np.int64)
        return cls(
            rb.docs, rb.kind[rows], rb.type_code[rows],
            rb.doc_idx[rows], rb.client[rows], rb.client_seq[rows],
            rb.ref_seq[rows], rb.seq[rows], rb.msn[rows], io,
            new_off, heap,
        )

    def __len__(self) -> int:
        return self.n

    def blob(self, i: int) -> bytes:
        return bytes(self.heap[self.blob_off[i]:self.blob_off[i + 1]])

    def record(self, i: int) -> Any:
        """Record `i` as a plain Python value (the dict-path view)."""
        return _decode_record(self, i, DEFAULT_VERSION)

    def __iter__(self):
        return (self.record(i) for i in range(self.n))

    def records(self) -> List[Any]:
        return [self.record(i) for i in range(self.n)]


def _gather_spans(heap, off, rows) -> bytes:
    """Concatenate `rows`' blob slices out of `heap`, one copy per
    CONSECUTIVE-row span (the all-kept fast path is a single memcpy)."""
    n = rows.shape[0]
    if n == 0:
        return b""
    breaks = np.flatnonzero(np.diff(rows) != 1)
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks + 1, [n]))
    parts = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        parts.append(bytes(
            heap[off[rows[s]]:off[rows[e - 1] + 1]]
        ))
    return b"".join(parts)


def count_records(messages: Sequence[Any]) -> int:
    """Record count of a message list that may mix plain records and
    `ColumnarRecords` segments (what topic offsets advance by)."""
    n = 0
    for m in messages:
        n += m.n if isinstance(m, ColumnarRecords) else 1
    return n


def mask_runs(values) -> List[Tuple[Any, int, int]]:
    """Maximal constant runs of a 1-D array as ``[(value, lo, hi)]``
    (host-side numpy) — the span decomposition every columnar
    ingest/emit path shares: a homogeneous run vectorizes (one bulk
    ingest call, one verdict slice, one blob-heap memcpy), while
    category boundaries fall back to per-record handling without
    losing stream order. ONE definition so the run rule can never fork
    between the deli's columnar ingest, its verdict emission, and the
    fused durable+broadcast hop's frame pass-through."""
    v = np.asarray(values)
    n = v.shape[0]
    if n == 0:
        return []
    bounds = np.flatnonzero(np.diff(v.astype(np.int64))) + 1
    edges = [0, *bounds.tolist(), n]
    return [(v[lo].item(), lo, hi) for lo, hi in zip(edges, edges[1:])]


class _Part:
    """One assembled frame part: plain-loop columns or a spliced
    segment, in stream order."""

    __slots__ = ("docs", "kind", "type_code", "doc_idx", "i64",
                 "blob_off", "heap", "n", "from_columns")

    def __init__(self, docs, kind, type_code, doc_idx, i64, blob_off,
                 heap, n, from_columns):
        self.docs = docs
        self.kind = kind
        self.type_code = type_code
        self.doc_idx = doc_idx
        self.i64 = i64  # (6, n) int64: client/cseq/ref/seq/msn/inOff
        self.blob_off = blob_off  # (n+1,) uint32, part-local
        self.heap = heap
        self.n = n
        self.from_columns = from_columns


def _part_from_segment(seg: ColumnarRecords) -> _Part:
    i64 = np.empty((6, seg.n), np.int64)
    i64[0] = seg.client
    i64[1] = seg.client_seq
    i64[2] = seg.ref_seq
    i64[3] = seg.seq
    i64[4] = seg.msn
    i64[5] = seg.in_off
    return _Part(seg.docs, seg.kind, seg.type_code, seg.doc_idx, i64,
                 seg.blob_off, seg.heap, seg.n, from_columns=True)


def _assemble_frame(parts: List[_Part], fence: Optional[int],
                    owner: Optional[str], version: int,
                    src: Optional[str] = None) -> bytes:
    """Splice frame parts (doc dictionaries remapped VECTORIZED, blob
    heaps shifted as arrays) and wrap the header+CRC."""
    doc_ids: List[str] = []
    doc_of: Dict[str, int] = {}
    kind_a: List[np.ndarray] = []
    tc_a: List[np.ndarray] = []
    didx_a: List[np.ndarray] = []
    i64_a: List[np.ndarray] = []
    off_a: List[np.ndarray] = []
    heaps: List[bytes] = []
    n = 0
    heap_base = 0
    for p in parts:
        remap = np.empty(max(1, len(p.docs)), np.int32)
        for j, d in enumerate(p.docs):
            di = doc_of.get(d)
            if di is None:
                di = doc_of[d] = len(doc_ids)
                doc_ids.append(d)
            remap[j] = di
        kind_a.append(p.kind)
        tc_a.append(p.type_code)
        didx_a.append(remap[p.doc_idx] if len(p.docs) else p.doc_idx)
        i64_a.append(p.i64)
        off_a.append(p.blob_off[:-1].astype(np.uint32) + heap_base)
        heaps.append(p.heap)
        heap_base += int(p.blob_off[-1])
        n += p.n
    heap = b"".join(heaps)
    if len(parts) == 1:
        p = parts[0]
        kind_b = p.kind.tobytes()
        tc_b = tc_a[0].tobytes()
        didx_b = didx_a[0].tobytes()
        i64_b = p.i64.tobytes()
        offs = np.empty(n + 1, np.uint32)
        offs[:n] = off_a[0]
        offs[n] = heap_base
        offs_b = offs.tobytes()
    else:
        kind_b = np.concatenate(kind_a).tobytes() if parts else b""
        tc_b = np.concatenate(tc_a).tobytes() if parts else b""
        didx_b = np.concatenate(didx_a).tobytes() if parts else b""
        i64_b = (np.concatenate(i64_a, axis=1).tobytes()
                 if parts else b"")
        offs = np.empty(n + 1, np.uint32)
        if parts:
            offs[:n] = np.concatenate(off_a)
        offs[n] = heap_base
        offs_b = offs.tobytes()
    owner_b = (owner or "").encode()
    flags = 0
    src_parts: List[bytes] = []
    if src:
        flags |= FLAG_SRC
        src_b = src.encode()
        src_parts = [struct.pack("<H", len(src_b)), src_b]
    doc_parts = [struct.pack("<I", len(doc_ids))]
    for d in doc_ids:
        db = d.encode()
        doc_parts.append(struct.pack("<H", len(db)) + db)
    payload = b"".join([
        struct.pack("<H", len(owner_b)), owner_b, *src_parts,
        *doc_parts, kind_b, tc_b, didx_b, i64_b, offs_b, heap,
    ])
    if len(payload) > MAX_BATCH_BYTES:
        raise ValueError(f"record batch too large: {len(payload)} bytes")
    # The CRC covers the HEADER FIELDS (with the crc slot zeroed) as
    # well as the payload: a flipped record count, length or flag byte
    # would otherwise mis-frame a payload whose own CRC still matches.
    fence_i = int(fence or 0)
    hdr0 = HEADER.pack(MAGIC, version, flags, n, len(payload), 0, fence_i)
    crc = zlib.crc32(payload, zlib.crc32(hdr0))
    return HEADER.pack(
        MAGIC, version, flags, n, len(payload), crc, fence_i,
    ) + payload


def encode_columns(segments, fence: Optional[int] = None,
                   owner: Optional[str] = None,
                   version: Optional[int] = None,
                   src: Optional[str] = None) -> bytes:
    """One binary frame from pre-columnized records — the emit hot
    path: no per-record classification, no dict building, blob heaps
    spliced as whole byte runs. `segments` is one `ColumnarRecords` or
    a sequence of them (spliced in order). `src` stamps the
    frame-level ``inSrc`` tag (FLAG_SRC — every decoded record gains
    it), the pred-drain emit path's answer to per-record dict
    tagging."""
    t0 = time.perf_counter()
    ver = DEFAULT_VERSION if version is None else int(version)
    if ver not in SCHEMA_VERSIONS:
        raise ValueError(f"unknown record-batch version {ver}")
    if isinstance(segments, ColumnarRecords):
        segments = (segments,)
    parts = [_part_from_segment(s) for s in segments]
    frame = _assemble_frame(parts, fence, owner, ver, src=src)
    n = sum(p.n for p in parts)
    _metrics("encode", n, len(frame), time.perf_counter() - t0)
    if n:
        from ..utils.metrics import get_registry

        get_registry().counter(
            "codec_encode_columns_total", codec="columnar"
        ).inc(n)
    return frame


def encode_batch(records: Sequence[Any], fence: Optional[int] = None,
                 owner: Optional[str] = None,
                 version: Optional[int] = None,
                 src: Optional[str] = None) -> bytes:
    """One binary frame for `records` (arbitrary JSON values, plus
    `ColumnarRecords` segments spliced in stream order), stamped with
    the accepted (fence, owner). `version` picks the frame rev (the
    module default otherwise); only the K_RAW_BOXCAR blob layout
    differs between revs. `src` stamps the frame-level ``inSrc`` tag
    (see `encode_columns`); records that ALREADY carry an ``inSrc``
    key must not mix into a src frame (the frame tag would be
    ambiguous) — callers pick one mechanism per append."""
    if records and all(isinstance(r, ColumnarRecords) for r in records):
        # Segment-only batch (the columnar emit steady state: a fused
        # pass-through pump, a nack-free kernel pump): the pure-column
        # encoder, no per-record machinery at all.
        return encode_columns(records, fence=fence, owner=owner,
                              version=version, src=src)
    t0 = time.perf_counter()
    ver = DEFAULT_VERSION if version is None else int(version)
    if ver not in SCHEMA_VERSIONS:
        raise ValueError(f"unknown record-batch version {ver}")
    doc_ids: List[str] = []
    doc_of: Dict[str, int] = {}
    # Hot path: plain list appends per record, ONE numpy conversion per
    # column at the end (scalar ndarray stores cost ~10x a list append).
    kinds: List[int] = []
    type_codes: List[int] = []
    doc_idx: List[int] = []
    clients: List[int] = []
    cseqs: List[int] = []
    refs: List[int] = []
    seqs: List[int] = []
    msns: List[int] = []
    inoffs: List[int] = []
    blobs: List[bytes] = []
    blob_lens: List[int] = []
    parts: List[_Part] = []
    col_records = 0

    # One fused pass: the key-set comparison routes each record AND the
    # same lookups fill the columns (classification re-reads nothing).
    ka, ta, da, ca = (kinds.append, type_codes.append, doc_idx.append,
                      clients.append)
    qa, ra, sa, ma = (cseqs.append, refs.append, seqs.append,
                      msns.append)
    ia, ba, la = inoffs.append, blobs.append, blob_lens.append

    def flush_plain() -> None:
        # Close the current plain run into an ordered frame part
        # (segments must splice at their stream position).
        m = len(kinds)
        if not m:
            return
        i64 = np.array([clients, cseqs, refs, seqs, msns, inoffs],
                       np.int64)
        offs = np.zeros(m + 1, np.uint32)
        offs[1:] = np.cumsum(blob_lens)
        parts.append(_Part(
            doc_ids, np.array(kinds, np.uint8),
            np.array(type_codes, np.uint8),
            np.array(doc_idx, np.int32), i64, offs, b"".join(blobs),
            m, from_columns=False,
        ))
        for lst in (kinds, type_codes, doc_idx, clients, cseqs, refs,
                    seqs, msns, inoffs, blobs, blob_lens):
            lst.clear()
        # doc_ids/doc_of persist across plain runs: the dict remap in
        # _assemble_frame dedups identical ids anyway.

    def generic(rec):
        ka(K_GENERIC)
        ta(_NO_TYPE)
        da(0)
        ca(0)
        qa(0)
        ra(0)
        sa(0)
        ma(0)
        ia(-1)
        blob = _dumps(rec)
        ba(blob)
        la(len(blob))

    # Homogeneous-run classification hoist: consecutive records with
    # the SAME exact key set and kind string skip the _classify branch
    # ladder — only that kind's value checks rerun per record. Streams
    # are overwhelmingly single-schema runs (a deltas pump is K_SEQ_OP
    # wall-to-wall), so the ladder cost amortizes to once per run.
    prev_keys = None
    prev_kind_s = None
    prev_k = K_GENERIC
    prev_rv = None

    for rec in records:
        if isinstance(rec, ColumnarRecords):
            flush_plain()
            parts.append(_part_from_segment(rec))
            col_records += rec.n
            prev_keys = None
            continue
        if (type(rec) is dict and rec.keys() == prev_keys
                and rec.get("kind") == prev_kind_s):
            k = prev_k if prev_rv(rec) else K_GENERIC
        else:
            k = _classify(rec)
            if k != K_GENERIC and type(rec) is dict:
                prev_keys = rec.keys()
                prev_kind_s = rec.get("kind")
                prev_k = k
                prev_rv = _REVALIDATE[k]
            else:
                prev_keys = None
        if k == K_GENERIC:
            generic(rec)
            continue
        doc = rec["doc"]
        di = doc_of.get(doc)
        if di is None:
            di = doc_of[doc] = len(doc_ids)
            doc_ids.append(doc)
        ka(k)
        da(di)
        ca(rec["client"])
        if k == K_RAW_OP:
            qa(rec["clientSeq"])
            ra(rec["refSeq"])
            sa(0)
            ma(0)
            ia(rec.get("inOff", -1))
            ta(_NO_TYPE)
            blob = _dumps(rec["contents"])
        elif k == K_SEQ_OP:
            qa(rec["clientSeq"])
            ra(rec["refSeq"])
            sa(rec["seq"])
            ma(rec["msn"])
            ia(rec["inOff"])
            ta(_TYPE_CODE[rec["type"]])
            blob = _dumps(rec["contents"])
        elif k == K_NACK:
            qa(rec["clientSeq"])
            ra(0)
            sa(rec["code"])
            ma(0)
            ia(rec["inOff"])
            ta(_NO_TYPE)
            blob = _dumps(rec["reason"])
        else:
            qa(0)
            ra(0)
            sa(0)
            ma(0)
            ia(rec.get("inOff", -1))
            ta(_NO_TYPE)
            if k != K_RAW_BOXCAR:
                blob = b""
            elif ver >= SCHEMA_VERSION_2:
                blob = _encode_boxcar_v2(rec["ops"])
            else:
                blob = _dumps([
                    [op["clientSeq"], op["refSeq"], op["contents"]]
                    for op in rec["ops"]
                ])
        ba(blob)
        la(len(blob))

    flush_plain()
    frame = _assemble_frame(parts, fence, owner, ver, src=src)
    n = sum(p.n for p in parts)
    _metrics("encode", n, len(frame), time.perf_counter() - t0)
    if col_records:
        from ..utils.metrics import get_registry

        get_registry().counter(
            "codec_encode_columns_total", codec="columnar"
        ).inc(col_records)
    return frame


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class RecordBatch:
    """One decoded frame: columns up front, blobs/records lazily.

    `kind`/`type_code`/`doc_idx`/`client`/`client_seq`/`ref_seq`/
    `seq`/`msn`/`in_off` are numpy views over the payload — the
    zero-JSON ingest surface for the kernel deli. `records()` is the
    legacy path: full per-record decode into plain Python values.
    `version` is the frame's schema rev (it decides the K_RAW_BOXCAR
    blob layout `boxcar()` parses)."""

    __slots__ = ("n", "fence", "owner", "docs", "kind", "type_code",
                 "doc_idx", "client", "client_seq", "ref_seq", "seq",
                 "msn", "in_off", "_blob_off", "_heap", "_records",
                 "_frame_bytes", "version", "src")

    def __init__(self, n: int, fence: int, payload: memoryview,
                 version: int = SCHEMA_VERSION, flags: int = 0):
        self.n = n
        self.fence = fence
        self.version = version
        self._frame_bytes = HEADER.size + len(payload)
        pos = 0
        (olen,) = struct.unpack_from("<H", payload, pos)
        pos += 2
        self.owner = bytes(payload[pos:pos + olen]).decode() or None
        pos += olen
        self.src: Optional[str] = None
        if flags & FLAG_SRC:
            (slen,) = struct.unpack_from("<H", payload, pos)
            pos += 2
            self.src = bytes(payload[pos:pos + slen]).decode() or None
            pos += slen
        (ndocs,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        docs: List[str] = []
        for _ in range(ndocs):
            (dlen,) = struct.unpack_from("<H", payload, pos)
            pos += 2
            docs.append(bytes(payload[pos:pos + dlen]).decode())
            pos += dlen
        self.docs = docs
        self.kind = np.frombuffer(payload, np.uint8, n, pos)
        pos += n
        self.type_code = np.frombuffer(payload, np.uint8, n, pos)
        pos += n
        self.doc_idx = np.frombuffer(payload, "<i4", n, pos)
        pos += 4 * n
        i64 = np.frombuffer(payload, "<i8", 6 * n, pos).reshape(6, n)
        pos += 48 * n
        (self.client, self.client_seq, self.ref_seq,
         self.seq, self.msn, self.in_off) = i64
        self._blob_off = np.frombuffer(payload, "<u4", n + 1, pos)
        pos += 4 * (n + 1)
        self._heap = payload[pos:]
        self._records: Optional[List[Any]] = None

    def blob(self, i: int) -> bytes:
        """Record `i`'s raw JSON blob bytes (contents / boxcar ops /
        reason / whole generic record, per kind)."""
        return bytes(self._heap[self._blob_off[i]:self._blob_off[i + 1]])

    def boxcar(self, i: int) -> List[Tuple[int, int, Any]]:
        """Record `i`'s boxcar ops as ``[(clientSeq, refSeq,
        contents), ...]``. On a v2 frame `contents` is a lazy
        `JsonBlob` sliced straight off the nested heap — the
        pass-through handle a columnar emitter hands back untouched;
        on v1 it is the decoded plain value (one JSON parse per
        boxcar, the pre-rev cost)."""
        if self.version >= SCHEMA_VERSION_2:
            view = self._heap[self._blob_off[i]:self._blob_off[i + 1]]
            cs, rf, offs, heap = _decode_boxcar_v2(view)
            return [
                (int(cs[k]), int(rf[k]),
                 JsonBlob(bytes(heap[offs[k]:offs[k + 1]])))
                for k in range(cs.shape[0])
            ]
        return [(cs, rf, c) for cs, rf, c in json.loads(self.blob(i))]

    def record(self, i: int) -> Any:
        """Record `i` as a plain Python value (lazy, uncached)."""
        return _decode_record(self, i, self.version)

    def records(self) -> List[Any]:
        """All records, decoded once and cached (the legacy-consumer
        path: one batch at a time, plain values)."""
        if self._records is None:
            t0 = time.perf_counter()
            self._records = [self.record(i) for i in range(self.n)]
            _metrics("decode", self.n, self._frame_bytes,
                     time.perf_counter() - t0)
        return self._records


def _decode_record(obj, i: int, version: int) -> Any:
    """One record as a plain Python value, off any column holder
    (`RecordBatch` or `ColumnarRecords` — same column protocol). A
    frame-level `src` (FLAG_SRC) tags every decoded dict with
    ``inSrc``, reproducing the dict-path tagging exactly."""
    k = int(obj.kind[i])
    if k == K_GENERIC:
        rec = json.loads(obj.blob(i))
    else:
        doc = obj.docs[int(obj.doc_idx[i])]
        client = int(obj.client[i])
        if k == K_RAW_OP:
            rec = {"kind": "op", "doc": doc, "client": client,
                   "clientSeq": int(obj.client_seq[i]),
                   "refSeq": int(obj.ref_seq[i]),
                   "contents": json.loads(obj.blob(i))}
            if obj.in_off[i] >= 0:
                rec["inOff"] = int(obj.in_off[i])
        elif k == K_RAW_JOIN:
            rec = {"kind": "join", "doc": doc, "client": client}
            if obj.in_off[i] >= 0:
                rec["inOff"] = int(obj.in_off[i])
        elif k == K_RAW_LEAVE:
            rec = {"kind": "leave", "doc": doc, "client": client}
            if obj.in_off[i] >= 0:
                rec["inOff"] = int(obj.in_off[i])
        elif k == K_RAW_BOXCAR:
            rec = {"kind": "boxcar", "doc": doc, "client": client,
                   "ops": [
                       {"clientSeq": cs, "refSeq": rf,
                        "contents": c.value if isinstance(c, JsonBlob)
                        else c}
                       for cs, rf, c in obj.boxcar(i)
                   ]}
            if obj.in_off[i] >= 0:
                rec["inOff"] = int(obj.in_off[i])
        elif k == K_SEQ_OP:
            rec = {"kind": "op", "doc": doc,
                   "seq": int(obj.seq[i]), "msn": int(obj.msn[i]),
                   "client": client,
                   "clientSeq": int(obj.client_seq[i]),
                   "refSeq": int(obj.ref_seq[i]),
                   "type": _TYPES[int(obj.type_code[i])],
                   "contents": json.loads(obj.blob(i)),
                   "inOff": int(obj.in_off[i])}
        else:
            rec = {"kind": "nack", "doc": doc, "client": client,
                   "clientSeq": int(obj.client_seq[i]),
                   "code": int(obj.seq[i]),
                   "reason": json.loads(obj.blob(i)),
                   "inOff": int(obj.in_off[i])}
    src = getattr(obj, "src", None)
    if src and isinstance(rec, dict) and "inSrc" not in rec:
        rec["inSrc"] = src
    return rec


# Header-corruption resync probe budget: how many MAGIC candidates one
# `_resync_scan` call validates before sealing the probed region as
# junk and letting the scan continue from its far edge (pathological
# corruption only — e.g. payload bytes stuffed with false MAGICs).
MAX_RESYNC_CANDIDATES = 4096


def decode_batch(buf, pos: int = 0,
                 verify_crc: bool = True) -> Tuple[Optional[RecordBatch],
                                                   int, int]:
    """Parse one frame at `pos`. Returns ``(batch, end, n_records)``:

    - complete + CRC ok  → ``(RecordBatch, frame_end, n)``
    - complete + CRC bad → ``(None, frame_end, n)`` — the batch is
      skipped but its records stay COUNTED, so offsets are stable
      across every reader (the sealed-junk-line rule, batch-sized)
    - incomplete (torn tail) → ``(None, pos, -1)`` — not consumed;
      re-read complete on a later poll

    Raises ValueError when the bytes at `pos` are not a frame header
    at all (callers fall back to line-oriented parsing)."""
    view = memoryview(buf)
    if len(view) - pos < HEADER.size:
        if view[pos:pos + 4] == MAGIC:
            return None, pos, -1  # header itself still in flight
        raise ValueError("not a record-batch frame")
    magic, ver, flags, n, plen, crc, fence = HEADER.unpack_from(view, pos)
    if magic != MAGIC:
        raise ValueError("not a record-batch frame")
    if ver not in SCHEMA_VERSIONS or plen > MAX_BATCH_BYTES \
            or flags & ~_KNOWN_FLAGS:
        # Unknown version / flag / insane length: treat as a corrupt
        # frame of unknowable extent — callers skip the rest of the
        # file region the same way a junk JSON line is skipped.
        raise ValueError(
            f"bad record-batch header (ver={ver}, flags={flags}, "
            f"len={plen})"
        )
    end = pos + HEADER.size + plen
    if end > len(view):
        return None, pos, -1  # torn frame: an append in progress
    payload = view[pos + HEADER.size:end]
    hdr0 = HEADER.pack(MAGIC, ver, flags, n, plen, 0, fence)
    if zlib.crc32(payload, zlib.crc32(hdr0)) != crc:
        # Corrupt in place: skip, keep the count. (If the corruption
        # hit the header's count/length fields themselves, the skip
        # may land mid-junk — the walker then stops at the first
        # unparseable unit, the documented header-corruption floor.)
        return None, end, n
    return RecordBatch(n, fence, payload, version=ver,
                       flags=flags), end, n


def _resync_scan(data, pos: int) -> Optional[int]:
    """Find a trustworthy unit boundary past a poisoned region (a
    frame whose HEADER bytes were corrupted in place — version/length
    fields garbled, so the frame's extent is unknowable).

    Two boundary kinds are trustworthy: a MAGIC candidate whose header
    decodes AND whose frame is complete, and a newline-delimited,
    parseable JSON line (the mixed-history case: JSONL records after
    the poisoned frame). The scan probes every MAGIC occurrence within
    the longest extent any legitimate frame could have had
    (``HEADER + MAX_BATCH_BYTES`` — the true boundary, if one exists,
    must lie inside that window), then takes the EARLIEST confirmed
    boundary of either kind. Earliest-wins is what keeps the result a
    function of file content alone, never poll timing: an early reader
    that sees the next frame still torn and a late reader that sees it
    complete both resolve to the same earlier line boundary if one
    exists, so every reader computes the same record slotting (the
    cross-reader offset parity the exactly-once ``inOff`` scan rests
    on). A torn-but-plausible candidate may be an append IN PROGRESS:
    nothing at or past it is decided — return None (wait) unless an
    earlier confirmed boundary already exists.

    The scan always makes deterministic progress past settled bytes:
    when the probe budget (pathological false-MAGIC density) or the
    window is exhausted with more data beyond it, the probed region is
    itself sealed as junk and the scan continues from its far edge on
    the next unit, rather than stalling at the poison forever.

    Returns the resync byte offset, or None (wait for more data)."""
    window_end = pos + HEADER.size + MAX_BATCH_BYTES + 1
    i = data.find(MAGIC, pos + 1)
    probed = 0
    frame_at = None  # earliest confirmed complete-frame boundary
    torn_at = None  # first torn-but-plausible candidate (undecided)
    budget_at = None  # first unprobed candidate after budget exhaustion
    while 0 <= i < window_end:
        if probed >= MAX_RESYNC_CANDIDATES:
            budget_at = i
            break
        probed += 1
        try:
            _batch, _end, cnt = decode_batch(data, i)
        except ValueError:
            i = data.find(MAGIC, i + 1)
            continue
        if cnt < 0:
            torn_at = i
        else:
            frame_at = i
        break
    # Line scan: only bytes BEFORE the first undecided/confirmed point
    # are settled enough to search (everything earlier is fixed content
    # — data is append-only — so the earliest line there is final).
    stops = [min(len(data), window_end)]
    stops += [s for s in (frame_at, torn_at, budget_at) if s is not None]
    stop = min(stops)
    line_at = None
    j = data.find(b"\n", pos)
    while 0 <= j < stop:
        start = j + 1
        k = data.find(b"\n", start)
        if k < 0 or k >= stop:
            break
        line = data[start:k].strip()
        if line:
            try:
                json.loads(line)
                line_at = start
                break
            except ValueError:
                pass
        j = k
    if line_at is not None:
        return line_at
    if frame_at is not None:
        return frame_at
    if torn_at is not None:
        return None  # possibly the live append: wait for more bytes
    if budget_at is not None:
        # Probe budget exhausted with nothing confirmed: seal the
        # probed region and resume at the first unprobed candidate —
        # content-deterministic, and progress.
        return budget_at
    if len(data) > window_end:
        # Nothing parseable within the longest extent any legitimate
        # frame could have had, and the file continues past it: seal
        # the window as junk and keep scanning from its far edge.
        return window_end
    return None  # nothing confirmed: wait for more bytes


def iter_units(data, start_index: int = 0) -> Iterator[Tuple]:
    """Walk a mixed log region: binary record-batch frames AND JSONL
    lines in one byte string — THE shared scanner every reader of the
    columnar op-log family uses (topic reads, tail readers, journal
    replay, clean-length scans), so the torn-tail / CRC-skip /
    junk-line counting rules exist exactly once.

    Yields ``(kind, index, count, payload, end)`` per COMPLETE unit:

    - ``("batch", index, n_records, RecordBatch | None, end)`` —
      `None` payload means the frame's CRC failed; its records are
      skipped but still COUNT `n_records` toward offsets.
    - ``("line", index, 1, raw_line_bytes, end)`` — one newline-
      terminated line (possibly junk; callers parse/skip, the count
      always holds). A POISONED region (frame header corrupted in
      place — extent unknowable) is yielded in this form too, once a
      bounded magic-scan (`_resync_scan`) confirms the next unit
      boundary: the region is skipped but counts ONE record slot, so
      readers resume instead of stalling forever (the pre-resync
      behavior), at the cost of the poisoned frame's true record
      count (unknowable — its header is gone).

    `index` is the record offset of the unit's first record (starting
    at `start_index`); `end` is the byte offset just past the unit
    within `data`. Iteration stops at the first torn unit (incomplete
    frame, unterminated line, unconfirmed resync) — an append in
    progress, re-read complete on a later poll."""
    pos = 0
    idx = start_index
    n = len(data)
    while pos < n:
        if data[pos:pos + 4] == MAGIC:
            try:
                batch, end, cnt = decode_batch(data, pos)
            except ValueError:
                # Poisoned header: skip-but-count the region up to a
                # CONFIRMED resync boundary; without one, stop here
                # (the bytes may still be arriving).
                resync = _resync_scan(data, pos)
                if resync is None:
                    return
                yield "line", idx, 1, data[pos:resync], resync
                idx += 1
                pos = resync
                continue
            if cnt < 0:
                return  # torn frame
            yield "batch", idx, cnt, batch, end
            idx += cnt
            pos = end
        else:
            nl = data.find(b"\n", pos)
            if nl < 0:
                return  # torn line
            yield "line", idx, 1, data[pos:nl], nl + 1
            idx += 1
            pos = nl + 1
