"""The summary service: the supervised summarizer role and its readers.

Copied from fluidframework_tpu/server/summarizer.py: the environment
defaults (:94-150), `open_summary_store` (:153), `SummarizerRole`
(:423-837) over the port's `supervisor._Role`, and the read side,
`SummaryIndex` (:845), `SummaryReplica` (:920), `state_digest`
(:1003), `_tail_records_reverse` (:1020) and `read_catchup` (:1096).
The role's fold and emission (engine decision, triggers, round
grouping, freeze, emit) are `summary_fold.SummaryEmitter`, shared with
`SummaryFolder`. `summarize_document` (:1196) is not ported: it needs
the loader and the container runtime (ROADMAP.md Queue 1 item 4).

`SummarizerRole` consumes the sequenced **deltas** topic under a
fenced lease and, every `summary_ops` records of a document, emits a
fenced summary record:

- the summary **blob**, a replayable per-document state snapshot,
  content-addressed into the shared `castore.ContentAddressedStore`
  behind a `historian.HistorianCache`;
- a small **manifest** ``{kind, doc, seq, msn, count, form, handle,
  bytes, off, byteOff, byteTopic, inOff}`` appended to the
  ``summaries`` topic, so readers find the newest summary at or below
  a seq by tailing one topic (`SummaryIndex`).

Blobs, manifests, checkpoints and pin files are byte for byte the
reference's, so a role of either package takes over from the other.

Differences from the reference, each loud:

- **No backend fallback.** ``overlay`` runs kernel A on the card and
  its plain version on the CPU; ``kernel`` the scan kernel, likewise.
  ``FLUID_FOLD_INTERPRET`` and ``fold_interpret`` are not read, and
  ``summary_fold_backend_fallbacks_total`` stays registered at 0.
- **The device plane** (``device_plane=``, else ``FLUID_DEVICE_PLANE``,
  resolved at the first fold as the reference resolves it) is a
  `parallel.device_plane.DevicePlane` of entries of the role's device:
  the overlay backend lays each stacked round over every entry, the
  kernel backend over the plane's ``docs`` axis, each document's table
  whole on its entry (the reference also splits a table's rows over
  ``model``: that waits for a row-split scan, ROADMAP.md Queue 1 item
  3). Every fold over a plane counts in ``summary_plane_folds_total``;
  the bytes are those of a run without one.
- **The device** is an argument (``device=``, ``cuda`` when None; an
  explicit ``"cpu"`` runs the plain versions), for the role and for
  every `SummaryReplica`.

Safety argument (why summary + tail == full replay): the fold point of
a summary at record k uses record k's stamped ``msn``. Every op
sequenced after k carries ``refSeq >= msn_k`` (deli nacks stale
refSeqs and msn is monotone), so a tombstone removed at or below
``msn_k`` is invisible to every later perspective and a row inserted
at or below it visible to every one: the zamboni contract
`KernelReplica.compact` rests on, applied at a recorded point.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..parallel.device_plane import PLANE_ENV, resolve_plane
from ..testing.digest import char_spans
from ..utils.devices import DeviceLike, resolve_device
from .castore import ContentAddressedStore
from .columnar_log import (
    ColumnarFileTopic,
    make_tail_reader,
    make_topic,
    tail_records_reverse,
)
from .historian import HistorianCache
from .queue import partition_suffix
from .retention import PIN_TTL_S, clear_pin, write_pin
from .summary_fold import (
    DEFAULT_SUMMARY_OPS,
    SummaryEmitter,
    _boot_mergetree,
    _decode_mt_op,
    _encode_fold,
    _fold_jobs,
)
from .supervisor import _Role, canonical_record

__all__ = [
    "FOLD_BACKENDS",
    "FOLD_BACKEND_ENV",
    "PLANE_ENV",
    "SUMMARY_OPS_ENV",
    "SummarizerRole",
    "SummaryIndex",
    "SummaryReplica",
    "open_summary_store",
    "read_catchup",
    "state_digest",
]

# Default emission cadence: one summary per doc every N sequenced
# records (override per role via summary_ops=, or process-wide via the
# env).
SUMMARY_OPS_ENV = "FLUID_SUMMARY_OPS"
# Merge-tree fold backend (`fold_backend=` / env), the reference's
# order and default ("kernel"; `SummaryFolder` defaults to "overlay").
FOLD_BACKEND_ENV = "FLUID_FOLD_BACKEND"
FOLD_BACKENDS = ("kernel", "overlay")


def _summary_ops_default() -> int:
    try:
        return max(1, int(os.environ.get(SUMMARY_OPS_ENV, "")))
    except ValueError:
        return DEFAULT_SUMMARY_OPS


def _fold_backend_default() -> str:
    b = os.environ.get(FOLD_BACKEND_ENV, "").strip() or "kernel"
    if b not in FOLD_BACKENDS:
        raise ValueError(
            f"{FOLD_BACKEND_ENV}={b!r} not in {FOLD_BACKENDS}"
        )
    return b


_store_seq = 0


def open_summary_store(shared_dir: str,
                       budget_bytes: int = 64 * 1024 * 1024
                       ) -> HistorianCache:
    """The farm's summary store: a durable content-addressed store
    under ``<shared_dir>/store`` fronted by the historian cache (every
    process, summarizers and readers, opens the same directory). Each
    open gets its own metrics label: distinct caches must not fold
    into one gauge."""
    global _store_seq
    _store_seq += 1
    return HistorianCache(
        ContentAddressedStore(
            prefer_native=False,
            directory=os.path.join(shared_dir, "store"),
        ),
        blob_budget_bytes=budget_bytes,
        name=f"summary{_store_seq}",
    )


# ---------------------------------------------------------------------------
# the supervised role
# ---------------------------------------------------------------------------


class SummarizerRole(SummaryEmitter, _Role):
    """deltas → summaries: the summary lambda.

    The `_Role` machinery unchanged: fenced lease, heartbeat,
    checkpoint cadence and the exactly-once ``inOff`` recovery.
    Manifests are ordinary outputs of their trigger input line, so a
    crash between the manifest append and the checkpoint replays
    silently and re-emits only the clipped tail. Blob puts are
    content-addressed (idempotent), so a recovery that re-puts a blob
    gets the same handle: restarts cannot fork a summary.

    Runs per partition under `partitioned_role_class` (``deltas-p{k}``
    → ``summaries-p{k}``). Manifests carry ``byteOff``, the logical
    deltas-topic byte position at the start of the trigger's input
    batch (None when the emission came from recovery replay): a hard
    lower bound for the catch-up tail seek (`read_catchup`), stable
    under op-log truncation, in the byte space ``byteTopic`` names.

    Around each emission round the role PINS the summary store
    (`retention.write_pin`) until the round's manifests are durably
    appended: the retention sweep never removes a blob newer than the
    oldest live pin."""

    name = "summarizer"
    in_topic_name = "deltas"
    out_topic_name = "summaries"
    _log_name = "summarizer"

    def __init__(self, *a, summary_ops: Optional[int] = None,
                 store=None, historian_budget: int = 64 * 1024 * 1024,
                 fold_backend: Optional[str] = None, device_plane=None,
                 device: DeviceLike = None, **kw):
        backend = fold_backend or _fold_backend_default()
        if backend not in FOLD_BACKENDS:
            raise ValueError(
                f"fold_backend {backend!r} not in {FOLD_BACKENDS}"
            )
        ops = int(summary_ops or _summary_ops_default())
        if ops < 1:
            raise ValueError(f"summary_ops must be >= 1: {summary_ops}")
        # Resolved before any lease, topic or heartbeat file is made, so
        # a role that cannot run leaves nothing behind.
        dev = resolve_device(device)
        super().__init__(*a, **kw)
        labels = self._metric_labels()
        self._init_emitter(ops, backend, dev, self.metrics, labels)
        self.store = store if store is not None else open_summary_store(
            self.shared_dir, historian_budget
        )
        m = self.metrics
        self._m_build_ms = m.histogram("summary_build_ms", **labels)
        # The reference's instrument for its backend fallback:
        # registered, and 0 here (the port has none).
        self._m_backend_fallbacks = m.counter(
            "summary_fold_backend_fallbacks_total", **labels
        )
        self._m_plane_folds = m.counter("summary_plane_folds_total",
                                        **labels)
        m.gauge("summary_fold_backend", backend=backend, **labels).set(1)
        # The device plane: a spec or a DevicePlane, resolved at the
        # first fold (None falls back to PLANE_ENV then).
        self._plane_arg = device_plane
        self._plane_resolved = False
        self._plane = None
        self._pinned = False
        self._pin_t = self._pin_hb = 0.0

    def fold_backend(self) -> str:
        """The fold backend: the one asked for, always."""
        return self._backend

    def device_plane(self):
        """The farm's device plane (None when unconfigured): the
        explicit argument wins, else ``FLUID_DEVICE_PLANE`` (the
        supervisor's ``--device-plane`` child seam). A spec resolves to
        the process-wide plane of entries of the role's device; a plane
        on another kind of device raises ValueError."""
        if not self._plane_resolved:
            plane = resolve_plane(self._plane_arg, env=True,
                                  device=self.device)
            if plane is not None and plane.entries[0].type != \
                    self.device.type:
                raise ValueError(
                    f"device plane {plane.spec()} has "
                    f"{plane.entries[0].type} entries; the role runs on "
                    f"{self.device}")
            self._plane = plane
            self._plane_resolved = True
        return self._plane

    def _dispatch_fold(self, fold_jobs):
        plane = self.device_plane()
        if plane is not None:
            self._m_plane_folds.inc()
        return super()._dispatch_fold(fold_jobs, plane)

    # ------------------------------------------------------------ state

    def snapshot_state(self) -> Any:
        # A FLAT {doc: fold} map (the shape a ranged successor slices
        # by hash range in the reference's elastic fabric).
        return dict(self.docs)

    def restore_state(self, state: Any) -> None:
        state = dict(state or {})
        if set(state) == {"docs"} and isinstance(state["docs"], dict) \
                and all(isinstance(v, dict) and "count" in v
                        for v in state["docs"].values()):
            # Pre-retention checkpoint shape ({"docs": {...}}): unwrap.
            state = dict(state["docs"])
        self.docs = state
        self._reps = {}
        self._triggers = []

    # ------------------------------------------------------------- fold

    def process(self, line_idx: int, rec: Any, out: List[dict]) -> None:
        self._take(rec, line_idx, self._in_pos)

    def flush_batch(self, out: List[dict]) -> None:
        if not self._triggers:
            return
        # GC epoch pin: blobs put from here on may not be referenced by
        # a durable manifest yet; the sweep spares everything newer
        # than this instant until the pin clears (after this round's
        # outputs are appended, or on expiry if we die: recovery's
        # silent replay re-puts the blobs before the clipped manifests
        # are re-emitted).
        self._pin_t = write_pin(self.shared_dir, self.name)
        self._pin_hb = self._pin_t
        self._pinned = True
        t0 = time.perf_counter()
        self._emit_triggers(out)
        self._m_build_ms.observe((time.perf_counter() - t0) * 1000.0)

    def _round_start(self) -> None:
        self._refresh_pin()

    def _put_blob(self, payload: bytes) -> str:
        self._refresh_pin()
        return self._durable(lambda: self.store.put(payload))

    def _manifest(self, man: dict, line_idx: Optional[int],
                  byte_off: Optional[int]) -> dict:
        return {
            "kind": "summary", **man, "off": line_idx,
            # Byte-offset hint for the O(tail) catch-up seek (None:
            # recovery replay, and readers scan unbounded). byteTopic
            # names the byte space: readers use the floor only when
            # the topic they scan matches.
            "byteOff": byte_off,
            "byteTopic": self.in_topic_name,
            "inOff": line_idx,
        }

    def _refresh_pin(self) -> None:
        # Heartbeat the GC pin mid-round: rewriting with the ORIGINAL
        # floor keeps blobs put earlier in the round covered while the
        # file mtime proves this writer is alive. Time-gated: the
        # rewrite runs every TTL/4, not per blob put.
        if self._pinned:
            now = time.time()
            if now - self._pin_hb < PIN_TTL_S / 4.0:
                return
            self._pin_hb = now
            write_pin(self.shared_dir, self.name, self._pin_t)

    def _unpin(self) -> None:
        if self._pinned:
            clear_pin(self.shared_dir, self.name)
            self._pinned = False

    def _append_outputs(self, out: List[dict]) -> int:
        n = super()._append_outputs(out)
        # The round's manifests are durable: release the GC pin.
        self._unpin()
        return n

    def checkpoint(self) -> None:
        super().checkpoint()
        # Recovery appends outside `_append_outputs` and checkpoints
        # right after, so the pin never outlives the round however the
        # manifests landed.
        self._unpin()


# ---------------------------------------------------------------------------
# readers: manifest index, boot replica, catch-up
# ---------------------------------------------------------------------------


class SummaryIndex:
    """Tail of the ``summaries`` topic(s): newest manifest per doc at or
    below a requested seq. `partitions` adds the static fabric's
    ``summaries-p{k}`` siblings; `topics` names the manifest topics
    explicitly."""

    def __init__(self, shared_dir: str, log_format: Optional[str] = None,
                 partitions: int = 1,
                 topics: Optional[List[str]] = None):
        if topics is not None:
            names = list(topics)
        else:
            names = ["summaries"]
            if partitions > 1:
                names += [partition_suffix("summaries", k)
                          for k in range(partitions)]
        self._readers = [
            make_tail_reader(make_topic(
                os.path.join(shared_dir, "topics", f"{n}.jsonl"),
                log_format,
            ))
            for n in names
        ]
        # doc -> manifests sorted by seq. One index may be shared across
        # threads: the tail readers and the lists go under a lock.
        self.manifests: Dict[str, List[dict]] = {}
        self._lock = threading.Lock()

    def poll(self) -> int:
        n = 0
        with self._lock:
            for r in self._readers:
                for _, rec in r.poll():
                    if not isinstance(rec, dict) or \
                            rec.get("kind") != "summary":
                        continue
                    lst = self.manifests.setdefault(rec["doc"], [])
                    lst.append(rec)
                    if len(lst) > 1 and lst[-2]["seq"] > rec["seq"]:
                        lst.sort(key=lambda m: m["seq"])
                    n += 1
        return n

    def nearest(self, doc: str, seq: Optional[int] = None
                ) -> Optional[dict]:
        """Newest manifest for `doc` with ``manifest.seq <= seq`` (no
        bound: the newest overall)."""
        with self._lock:
            lst = list(self.manifests.get(doc) or ())
        if not lst:
            return None
        if seq is None:
            return lst[-1]
        best = None
        for m in lst:
            if m["seq"] <= seq:
                best = m
            else:
                break
        return best


class SummaryReplica:
    """A reader-side replica booted from a summary blob (or cold).

    The join path: boot from ``blob`` then ``apply_records(tail)`` must
    equal, per `state_digest`, a cold boot applying the full log. Cold
    boots decide their engine like the summarizer (first op's
    contents). Merge-tree documents fold on `device` (``cuda`` when
    None, where the scan kernel runs; ``"cpu"`` for its plain
    version)."""

    def __init__(self, blob: Optional[dict] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.form = blob["form"] if blob else None
        self.seq = int(blob["seq"]) if blob else 0
        self.msn = int(blob["msn"]) if blob else 0
        self.count = int(blob.get("count", 0)) if blob else 0
        self._rep = None
        self.records: List[dict] = []
        # Canonical records seen before the engine is decided (a cold
        # boot's joins/leaves ahead of the first op).
        self._prefix: List[dict] = []
        if blob is None:
            return
        if self.form == "mergetree":
            self._rep = _boot_mergetree(blob["rows"], self.msn,
                                        device=self.device)
        elif self.form == "ops":
            self.records = [dict(r) for r in blob["records"]]
        else:
            raise ValueError(f"unknown summary form {self.form!r}")

    def apply_records(self, records: List[dict]) -> int:
        """Apply sequenced wire records (kind == "op") past the boot
        point; duplicates at or below the current seq drop (the
        reader's half of the exactly-once boundary). Merge-tree folding
        batches the whole call into chunked kernel launches."""
        pending_mt: List[dict] = []
        n = 0
        for rec in records:
            if not isinstance(rec, dict) or rec.get("kind") != "op":
                continue
            if int(rec["seq"]) <= self.seq:
                continue
            c = canonical_record(rec)
            if self.form is None and rec.get("type") == "op":
                self.form = ("mergetree"
                             if _decode_mt_op(rec.get("contents"))
                             is not None else "ops")
                if self.form == "ops":
                    self.records.extend(self._prefix)
                else:
                    pending_mt.extend(self._prefix)
                self._prefix = []
            if self.form == "mergetree":
                pending_mt.append(c)
            elif self.form == "ops":
                self.records.append(c)
            else:  # undecided: joins/leaves before the first op
                self._prefix.append(c)
            self.seq = int(rec["seq"])
            self.msn = max(self.msn, int(rec["msn"]))
            self.count += 1
            n += 1
        if pending_mt:
            if self._rep is None:
                self._rep = _boot_mergetree([], 0, device=self.device)
            _encode_fold(self._rep, pending_mt)
            _fold_jobs([(self._rep, pending_mt)])
        return n

    # ------------------------------------------------------------ state

    def get_text(self) -> str:
        return self._rep.get_text() if self._rep is not None else ""

    def char_spans(self) -> List[tuple]:
        if self._rep is None:
            return []
        return char_spans(self._rep.annotated_spans())

    def state_digest(self) -> str:
        return state_digest(self)


def state_digest(replica: SummaryReplica) -> str:
    """The digest two boots are compared in: document state
    (char-level, so segmentation history is invisible) for merge-tree
    docs, the canonical record stream for generic docs, plus the (seq,
    msn, count) head so a tail boundary off by one can never hide."""
    if replica.form == "mergetree":
        body: Any = [replica.get_text(), replica.char_spans()]
    else:
        body = replica.records
    payload = json.dumps(
        [replica.seq, replica.msn, replica.count, replica.form, body],
        sort_keys=True, ensure_ascii=True, default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def _tail_records_reverse(path: str, doc: str, base: int,
                          upto: Optional[int],
                          stop_at: Optional[int] = None) -> List[dict]:
    """`doc`'s op records with ``base < seq [<= upto]`` read BACKWARD
    from the topic's end, O(tail + interleave): per-doc seqs are
    append-monotone, so the first own-doc record at or below `base`
    bounds the scan. JSONL topics only (`columnar_log.
    tail_records_reverse` is the frame twin); a final line without its
    newline is never consumed.

    ``stop_at`` (a manifest's ``byteOff``, a line boundary) floors the
    walk: every own-doc record below it is at or below `base`, so the
    seek is O(tail) even with no own-doc interleave."""
    stop = max(0, int(stop_at)) if isinstance(stop_at, int) else 0
    out: List[dict] = []
    try:
        f = open(path, "rb")
    except OSError:
        return out
    with f:
        f.seek(0, os.SEEK_END)
        pos = f.tell()
        stop = min(stop, pos)
        block = 1 << 16
        carry = b""
        first = True
        while pos > stop:
            step = min(block, pos - stop)
            pos -= step
            f.seek(pos)
            data = f.read(step) + carry
            parts = data.split(b"\n")
            carry = parts[0]  # partial first line: joins the next block
            lines = parts[1:]
            if first:
                first = False
                if lines and not data.endswith(b"\n"):
                    lines.pop()  # torn tail: invisible until complete
            for raw in reversed(lines):
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except ValueError:
                    continue  # sealed junk from a crashed writer
                if not isinstance(rec, dict) or rec.get("doc") != doc \
                        or rec.get("kind") != "op":
                    continue
                s = int(rec["seq"])
                if s <= base:
                    out.reverse()
                    return out
                if upto is None or s <= upto:
                    out.append(rec)
            block = min(block * 2, 1 << 22)
        # Floor reached (file start, or the byteOff line boundary):
        # carry is the (complete) first line of the scanned region; a
        # non-aligned stop leaves a partial line, which fails to parse
        # and is skipped (records below the floor are at or below
        # `base` by the byteOff contract anyway).
        raw = carry.strip()
        if raw:
            try:
                rec = json.loads(raw)
                if isinstance(rec, dict) and rec.get("doc") == doc \
                        and rec.get("kind") == "op" \
                        and int(rec["seq"]) > base \
                        and (upto is None or int(rec["seq"]) <= upto):
                    out.append(rec)
            except ValueError:
                pass
    out.reverse()
    return out


def read_catchup(shared_dir: str, doc: str,
                 log_format: Optional[str] = None,
                 seq: Optional[int] = None,
                 index: Optional[SummaryIndex] = None,
                 store=None,
                 deltas_topic: str = "deltas") -> dict:
    """Answer a cold join from the farm's topics: nearest summary at or
    below `seq` (manifest + blob) plus the op tail past it off the
    deltas topic. Returns ``{"manifest", "blob", "ops"}`` (manifest and
    blob None when no summary exists yet: the tail is then the whole
    log).

    With a summary the tail is read BACKWARD from the topic's end
    (O(tail), so the join cost is flat in log length) on both log
    formats: JSONL by the line scan, columnar by the frame-chaining
    scan (`columnar_log.tail_records_reverse`), which falls back to
    the forward skip from the manifest's `off` only when it cannot
    anchor."""
    idx = index or SummaryIndex(shared_dir, log_format)
    idx.poll()
    man = idx.nearest(doc, seq)
    blob = None
    swept = False
    if man is not None:
        st = store or open_summary_store(shared_dir)
        try:
            blob = json.loads(st.get(man["handle"]).decode())
        except KeyError:
            # The store's GC swept this manifest's blob: fall to the
            # full-replay path, honest only while the op log still
            # holds the doc's whole history (checked below).
            man, swept = None, True
    topic = make_topic(
        os.path.join(shared_dir, "topics", f"{deltas_topic}.jsonl"),
        log_format,
    )
    if man is None and (swept or seq is not None):
        # No usable summary at or below the requested seq. A replay
        # from logical 0 silently resumes at the truncation base, so if
        # the doc IS summarized and the log has a cut, partial state
        # would come back as if complete: refuse loudly instead.
        base_gone = (topic.base_offsets()[0] > 0
                     if hasattr(topic, "base_offsets") else False)
        if base_gone and (swept or idx.nearest(doc) is not None):
            raise LookupError(
                f"catchup({doc!r}, seq={seq}): state below the "
                f"retention horizon — the nearest summary blob was "
                f"garbage-collected and/or the covered op prefix was "
                f"truncated; only the newest summaries are retained"
            )
    base = int(man["seq"]) if man is not None else 0
    ops = None
    if man is not None:
        # The manifest's byteOff floors the backward walk, but ONLY in
        # the byte space it was stamped against (`byteTopic`): a
        # foreign offset would floor the walk wrongly and drop tail
        # ops, so a mismatch falls back to the unbounded scan.
        stop = man.get("byteOff")
        stop = (stop if isinstance(stop, int)
                and man.get("byteTopic") == deltas_topic else None)
        if isinstance(topic, ColumnarFileTopic):
            ops = tail_records_reverse(topic, doc, base, seq,
                                       stop_at=stop)
        else:
            ops = _tail_records_reverse(topic.path, doc, base, seq,
                                        stop_at=stop)
    if ops is None:
        # The manifest's `off` (its trigger's input line) bounds the
        # forward scan: records at or below it are covered.
        reader = make_tail_reader(
            topic, int(man["off"]) + 1 if man is not None else 0
        )
        ops = [
            rec for _, rec in reader.poll()
            if isinstance(rec, dict) and rec.get("kind") == "op"
            and rec.get("doc") == doc and int(rec["seq"]) > base
            and (seq is None or int(rec["seq"]) <= seq)
        ]
    return {"manifest": man, "blob": blob, "ops": ops}
