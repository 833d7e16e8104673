"""The summary service's fold-and-emit datapath, on both fold backends.

Copied from fluidframework_tpu/server/summarizer.py, the parts that
decide what a summary holds: `_decode_mt_op` (:179), `_boot_mergetree`
(:192), `_encode_fold` (:251), `_fold_jobs` (:308), `_canonical_rows`
(:371), the engine decision and cadence triggers of
`SummarizerRole.process` (:626-670), `_freeze` (:674), the round
grouping of `flush_batch` (:703-718) and `_emit_round` (:760-837). Two
fold backends, with byte-identical blobs by contract:

- ``overlay`` (`SummaryFolder`'s default): `core.overlay_fold`, every
  document that summarizes in one emission round stacked into one
  kernel A launch per chunk and window group;
- ``kernel`` (the role's default): the row-model `KernelReplica`
  (`_boot_mergetree`), its documents grouped by (capacity, chunk) and
  each group's chunk of every document applied by one launch of the
  scan kernel (`_fold_jobs`), serialized by `_canonical_rows`.

Both take the reference's ``plane=`` placement over a device plane
(`parallel.device_plane.DevicePlane`): the overlay backend lays a
window group over every entry (`core.overlay_fold.run_rounds`), the
kernel backend a capacity group's documents over the plane's ``docs``
axis (`_place_fold_stack`). A plane changes where documents run, never
a byte of what they produce.

`SummaryEmitter` holds the emission logic once: the engine decision,
the triggers, the round grouping, the fold dispatch, the freeze and
the emit. Two classes run it:

- `SummaryFolder`, the datapath alone: no fenced lease, heartbeat,
  checkpoint, topics, castore or metrics, and no environment knobs;
  its blobs go to a dict;
- `server.summarizer.SummarizerRole`, the supervised role over the
  port's `_Role`: blobs into the content-addressed store, manifests
  onto the ``summaries`` topic, the GC pin around each round.

For the same deltas records both emit the same summaries, with blob
bytes ``json.dumps(blob, sort_keys=True, separators=(",", ":"))`` and
the content-addressed handle the sha256 hex digest of those bytes
(`server/castore.py`).

Two blob forms, decided per document from its first op: ``mergetree``
(the op contents parse as merge-tree wire ops; the blob holds the
canonical rows at the fold point) and ``ops`` (generic contents; the
blob holds the canonical records). A merge-tree document whose stream
stops folding (an undecodable op, a kernel error flag, a prop-key
overflow) freezes: it emits no more summaries, never a wrong one.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.kernel_replica import (
    KernelReplica,
    TextArena,
    empty_columns,
    encode_op,
    encoded_columns,
    read_segment_table,
    upload_op_batch,
    upload_segment_table,
)
from ..core.overlay_fold import (
    boot_overlay,
    fold_jobs_overlay,
    merge_canonical_rows,
)
from ..ops.mergetree_kernel import (
    NOT_REMOVED,
    apply_op_batch,
    apply_op_batch_docs,
    raise_kernel_errors,
    stack_segment_tables,
)
from ..parallel.mesh import sharded_apply_docs
from ..protocol.constants import NO_CLIENT, UNIVERSAL_SEQ
from ..protocol.mergetree_ops import op_from_json
from ..protocol.messages import MessageType, SequencedMessage
from ..utils.devices import DeviceLike, resolve_device
from ..utils.metrics import NullRegistry
from .supervisor import canonical_record

__all__ = ["DEFAULT_SUMMARY_OPS", "FOLD_BACKENDS", "SummaryEmitter",
           "SummaryFolder", "canonical_record"]

# Default emission cadence: one summary per doc every N sequenced
# records (the role's default).
DEFAULT_SUMMARY_OPS = 256
FOLD_BACKENDS = ("overlay", "kernel")

# The kernel backend's shape knobs (uniform across documents, so that
# the stacked launch can group them).
_CHUNK = 128
_MIN_CAP = 512


def _pow2(n: int, lo: int = _MIN_CAP) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _decode_mt_op(contents: Any):
    """Merge-tree wire op, or None when the contents carry no
    merge-tree structure (the generic-doc detection rule)."""
    if not isinstance(contents, dict) or "type" not in contents:
        return None
    try:
        return op_from_json(contents)
    except (KeyError, ValueError, TypeError):
        return None


def _boot_mergetree(rows: List[list], msn: int,
                    device: DeviceLike = None) -> KernelReplica:
    """A live `KernelReplica` from serialized canonical rows: THE
    restart path, also run after every emission, so interrupted and
    uninterrupted summarizers proceed from the identical state. The
    table reaches the device in one copy."""
    rep = KernelReplica(initial="", chunk_size=_CHUNK, capacity=_MIN_CAP,
                        device=device)
    n = len(rows)
    cap = _pow2(n + 2 * _CHUNK + 8)
    cols = empty_columns(cap, rep.n_removers, rep.n_prop_keys)
    parts: List[str] = []
    off = 0
    for i, (seg, ins, icl, rem, rcl, prow) in enumerate(rows):
        cols["buf_start"][i] = off
        cols["length"][i] = len(seg)
        cols["ins_seq"][i] = ins
        cols["ins_client"][i] = icl
        if rem is not None:
            cols["rem_seq"][i] = rem
            cols["rem_clients"][i, : len(rcl)] = rcl
        if prow:
            for k, v in prow.items():
                cols["props"][i, rep.props.key_id(k)] = rep.props.value_id(v)
        parts.append(seg)
        off += len(seg)
    rep.arena = TextArena("".join(parts))
    rep.capacity = cap
    rep.table = upload_segment_table(cols, n, 0, rep.device)
    rep.min_seq = rep._applied_min_seq = int(msn)
    rep._pending_rows_bound = n
    return rep


def _place_fold_stack(K: int, capacity: int, plane):
    """The mesh a stacked kernel fold of K documents at `capacity` is
    laid over: the plane's ``docs`` axis (the entries of model column
    0), or None (no placement) unless ``K % plane.docs == 0`` and
    ``capacity % plane.model == 0``, the reference's condition
    (summarizer.py:274). The reference also splits each table's rows
    over ``model``; the port's scan kernel takes whole tables, so each
    document's table stays whole on its entry until a row-split scan
    exists (ROADMAP.md Queue 1 item 3)."""
    if K % plane.docs or capacity % plane.model:
        return None
    return plane.seq_mesh(0)


def _fold_jobs(jobs: List[tuple], plane=None) -> List[dict]:
    """Drain the pending encoded rows of several `KernelReplica`s
    through the scan, stacking the replicas of one (capacity, chunk)
    into one launch of the docs-form kernel per chunk: K summarizing
    documents cost one launch per chunk and group, not K. `jobs` holds
    ``(replica, records)`` pairs, as the role passes them. After each
    chunk a replica past its watermark compacts, as
    `KernelReplica._flush_chunks` does. With `plane` (a `DevicePlane`)
    a stacked group's documents are laid over the plane's ``docs`` axis
    where `_place_fold_stack` allows it: one launch per entry and chunk.

    Returns one summary per capacity group: ``{"capacity", "docs"
    (the most documents of one launch), "chunks" (the group's
    steps), "launches" (its scan launches, one an entry of a placed
    step), "device_ms"}``, where ``device_ms`` sums CUDA-event spans
    around the group's launches alone (a placed step's placement and
    gather included), after the tables are stacked and the ops
    uploaded (None on the CPU)."""
    reps = [rep for rep, _ in jobs]
    summary: Dict[int, dict] = {}
    timed = bool(reps) and reps[0].device.type == "cuda"
    events = []
    while any(r._encoded for r in reps):
        groups: Dict[tuple, list] = {}
        for r in reps:
            if not r._encoded:
                continue
            r._ensure_capacity()
            groups.setdefault((r.capacity, r.chunk_size), []).append(r)
        for (cap, chunk_b), grp in groups.items():
            chunks = []
            for r in grp:
                chunks.append(r._encoded[:chunk_b])
                del r._encoded[:chunk_b]
            g = summary.setdefault(cap, {"capacity": cap, "docs": 0,
                                         "chunks": 0, "launches": 0,
                                         "device_ms": None})
            g["docs"] = max(g["docs"], len(grp))
            g["chunks"] += 1
            mesh = None
            if len(grp) == 1:
                tables = grp[0].table
                ops = grp[0]._build_batch(chunks[0])
                apply = apply_op_batch
            else:
                cols = [np.stack(c) for c in zip(*(
                    encoded_columns(c, r.chunk_size, r.max_prop_pairs)
                    for r, c in zip(grp, chunks)))]
                tables = stack_segment_tables([r.table for r in grp])
                ops = upload_op_batch(cols, grp[0].device)
                apply = apply_op_batch_docs
                if plane is not None:
                    mesh = _place_fold_stack(len(grp), cap, plane)
                if mesh is not None:
                    apply = sharded_apply_docs(mesh)
            g["launches"] += 1 if mesh is None else mesh.size
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = apply(tables, ops)
            if timed:
                ev[1].record()
                events.append((cap, ev))
            if len(grp) == 1:
                grp[0].table = out
            else:
                for i, r in enumerate(grp):
                    r.table = out.doc(i)
            for r, c in zip(grp, chunks):
                r._applied_min_seq = c[-1][10]
                r._applied_since_compact = True
                if r._pending_rows_bound > r.capacity * r.compact_watermark:
                    # The zamboni watermark of `_flush_chunks`: without it
                    # a long fold accumulates tombstones and splits.
                    r.compact()
    if events:
        events[-1][1][1].synchronize()
        for cap, (e0, e1) in events:
            g = summary[cap]
            g["device_ms"] = (g["device_ms"] or 0.0) + e0.elapsed_time(e1)
    return list(summary.values())


def _canonical_rows(rep: KernelReplica, msn: int) -> List[list]:
    """The canonical serialized row form of a replica's table at fold
    msn `msn`, a pure function of the document's op prefix: tombstones
    removed at or below `msn` dropped, rows inserted at or below `msn`
    normalized to (UNIVERSAL_SEQ, NO_CLIENT), and adjacent rows whose
    semantic fields all match merged (`merge_canonical_rows`, shared
    with the overlay backend). Raises RuntimeError on a kernel error
    flag. Each row: ``[text, ins_seq, ins_client, rem_seq|None,
    rem_clients|None, props|None]``."""
    t = read_segment_table(rep.table)
    raise_kernel_errors(int(t.error))
    text = rep.arena.snapshot()
    raw: List[tuple] = []
    for i in range(int(t.n_rows)):
        rem = int(t.rem_seq[i])
        removed = rem != NOT_REMOVED
        if removed and rem <= msn:
            continue  # zamboni: tombstone below the window
        b = int(t.buf_start[i])
        seg = text[b: b + int(t.length[i])]
        ins = int(t.ins_seq[i])
        icl = int(t.ins_client[i])
        if ins <= msn:
            ins, icl = UNIVERSAL_SEQ, NO_CLIENT
        rcl = (sorted(int(c) for c in t.rem_clients[i]
                      if int(c) != NO_CLIENT) if removed else None)
        props = rep.props.decode_row(t.props[i])
        raw.append((seg, ins, icl, rem if removed else None, rcl, props))
    return merge_canonical_rows(raw)


def _encode_fold(rep, records: List[dict]) -> None:
    """Encode canonical op records into the replica's pending rows
    (`kernel_replica.encode_op`). Join/leave/noop records advance msn
    only."""
    for rec in records:
        if rec.get("type") == "op":
            op = _decode_mt_op(rec.get("contents"))
            if op is None:
                raise ValueError(f"non-mergetree contents at seq "
                                 f"{rec.get('seq')}")
            msg = SequencedMessage(
                int(rec["seq"]), int(rec["msn"]), int(rec["client"]),
                int(rec.get("clientSeq", 0)), int(rec.get("refSeq", 0)),
                MessageType.OP, op,
            )
            encode_op(rep, op, msg)
        rep.current_seq = int(rec["seq"])
        rep.min_seq = max(rep.min_seq, int(rec["msn"]))


class SummaryEmitter:
    """The summary service's emission logic, shared by `SummaryFolder`
    and `summarizer.SummarizerRole`: `_take` notes a trigger every
    `summary_ops` records of a document (as the role's `process`
    does), `_emit_triggers` folds and emits every pending trigger (the
    role's `flush_batch`).

    A subclass calls `_init_emitter` and may override three hooks:
    `_round_start` (before a round's folds), `_put_blob` (store the
    bytes, return the handle) and `_manifest` (the output record of one
    emission).
    Instruments are the role's, under the reference's names; the
    folder counts into a `NullRegistry`."""

    _log_name = "summary fold"

    def _init_emitter(self, summary_ops: int, fold_backend: str,
                      device: DeviceLike, metrics, labels: dict) -> None:
        if fold_backend not in FOLD_BACKENDS:
            raise ValueError(f"fold_backend {fold_backend!r} not in "
                             f"{FOLD_BACKENDS}")
        self.summary_ops = int(summary_ops)
        if self.summary_ops < 1:
            raise ValueError(f"summary_ops must be >= 1: {summary_ops}")
        self._backend = fold_backend
        self.device = resolve_device(device)
        # doc -> fold dict (JSON-serializable; live replicas cached
        # separately and rebuilt from the serialized rows).
        self.docs: Dict[str, dict] = {}
        self._reps: Dict[str, Any] = {}
        # (doc, line_idx, window_upto, records_upto, seq, msn, count,
        # byte_off): the pending emission points, folded and emitted
        # by `_emit_triggers`.
        self._triggers: List[tuple] = []
        self.frozen: Dict[str, str] = {}  # doc -> why
        m = metrics
        self._m_summaries = m.counter("summaries_emitted_total", **labels)
        self._m_blob_bytes = m.counter("summary_blob_bytes_total",
                                       **labels)
        self._m_fold_ops = m.counter("summary_fold_ops_total", **labels)
        self._m_stacked = m.counter("summary_stacked_folds_total",
                                    **labels)
        self._m_frozen = m.counter("summary_docs_frozen_total", **labels)
        self._m_docs = m.gauge("summary_docs", **labels)

    # ------------------------------------------------------------- hooks

    def _round_start(self) -> None:
        """Before each emission round."""

    def _put_blob(self, payload: bytes) -> str:
        raise NotImplementedError

    def _manifest(self, man: dict, line_idx: Optional[int],
                  byte_off: Optional[int]) -> dict:
        return man

    # ------------------------------------------------------------- fold

    def _fold(self, doc: str) -> dict:
        f = self.docs.get(doc)
        if f is None:
            f = self.docs[doc] = {
                "seq": 0, "msn": 0, "count": 0, "engine": None,
                "window": [], "records": [],
                "base": 0, "base_msn": 0, "rows": [],
                "last": None,
            }
            self._m_docs.set(len(self.docs))
        return f

    def _boot_rep(self, rows: List[list], msn: int):
        if self._backend == "overlay":
            return boot_overlay(rows, msn, device=self.device)
        return _boot_mergetree(rows, msn, device=self.device)

    def _rep(self, doc: str, f: dict):
        rep = self._reps.get(doc)
        if rep is None:
            rep = self._reps[doc] = self._boot_rep(f["rows"], f["base_msn"])
        return rep

    def _rows_of(self, rep, msn: int) -> List[list]:
        """Canonical rows at `msn`, identical bytes on either backend."""
        if self._backend == "overlay":
            return rep.canonical_rows(msn)
        return _canonical_rows(rep, msn)

    def _dispatch_fold(self, fold_jobs: List[Tuple[Any, list]],
                       plane=None) -> List[dict]:
        """Fold a round's jobs on the backend, over `plane` if given;
        its groups' summaries (`_fold_jobs` / `fold_jobs_overlay`:
        launches and device ms)."""
        if self._backend == "overlay":
            return fold_jobs_overlay(fold_jobs, plane)
        return _fold_jobs(fold_jobs, plane)

    def _take(self, rec: Any, line_idx: Optional[int],
              byte_off: Optional[int]) -> None:
        """One sequenced deltas record: anything but ``kind == "op"``
        records with a ``doc`` is ignored. `line_idx` is its input
        offset and `byte_off` the input batch's start byte (the role's;
        None for the folder)."""
        if not isinstance(rec, dict) or rec.get("kind") != "op" \
                or "doc" not in rec:
            return  # nacks / junk: summaries fold sequenced ops only
        f = self._fold(rec["doc"])
        f["seq"] = max(int(f["seq"]), int(rec["seq"]))
        f["msn"] = max(int(f["msn"]), int(rec["msn"]))
        f["count"] = int(f["count"]) + 1
        c = canonical_record(rec)
        if f["engine"] is None and rec.get("type") == "op":
            f["engine"] = ("mergetree"
                           if _decode_mt_op(rec.get("contents"))
                           is not None else "ops")
            if f["engine"] == "ops":
                # Generic doc: the whole history is the state.
                f["records"].extend(f["window"])
                f["window"] = []
        if f["engine"] == "ops":
            f["records"].append(c)
        else:  # mergetree / undecided / frozen: buffer the window
            f["window"].append(c)
        if f["engine"] in ("mergetree", "ops") and \
                f["count"] % self.summary_ops == 0:
            # Snapshot the fold-prefix lengths AT the trigger: records
            # after it belong to the NEXT summary, and a blob cut
            # anywhere else would depend on pump boundaries. A cadence
            # point reached while the engine is still undecided (only
            # joins/leaves so far) is skipped outright: deterministic,
            # and joins/leaves carry no state beyond the head.
            self._triggers.append((
                rec["doc"], line_idx, len(f["window"]),
                len(f["records"]), f["seq"], f["msn"], f["count"],
                byte_off,
            ))

    # ------------------------------------------------------- emission

    def _freeze(self, doc: str, f: dict, why: str) -> None:
        """A doc whose stream stopped folding (undecodable op, kernel
        error, prop overflow) stops emitting summaries: it falls back
        to longer tails, never to a wrong summary."""
        f["engine"] = "frozen"
        f["window"] = []
        f["rows"] = []
        self._reps.pop(doc, None)
        self.frozen[doc] = why
        self._m_frozen.inc()
        print(f"{self._log_name}: froze {doc} ({why})", flush=True)

    def _emit_triggers(self, out: List[dict]) -> None:
        """Fold and emit every pending trigger into `out`. Consecutive
        triggers of DISTINCT docs make one stacked fold round; a doc
        triggering twice starts a new round (its second fold depends
        on its first)."""
        triggers, self._triggers = self._triggers, []
        consumed: Dict[str, int] = {}
        i = 0
        while i < len(triggers):
            round_docs: set = set()
            j = i
            while j < len(triggers) and triggers[j][0] not in round_docs:
                round_docs.add(triggers[j][0])
                j += 1
            self._emit_round(triggers[i:j], consumed, out)
            i = j

    def _emit_round(self, round_jobs: List[tuple],
                    consumed: Dict[str, int], out: List[dict]) -> None:
        self._round_start()
        fold_jobs: List[Tuple[Any, list]] = []
        for doc, _line, upto, _rupto, _seq, _msn, _count, _bo \
                in round_jobs:
            f = self.docs[doc]
            if f["engine"] != "mergetree":
                continue
            done = consumed.get(doc, 0)
            take = f["window"][: upto - done]
            rep = self._rep(doc, f)
            try:
                _encode_fold(rep, take)
            except (ValueError, TypeError) as exc:
                self._freeze(doc, f, repr(exc))
                continue
            self._m_fold_ops.inc(len(take))
            fold_jobs.append((rep, take))
        if len(fold_jobs) > 1:
            self._m_stacked.inc(len(fold_jobs))
        if fold_jobs:
            self._dispatch_fold(fold_jobs)
        for doc, line_idx, upto, rec_upto, seq, msn, count, byte_off \
                in round_jobs:
            f = self.docs[doc]
            if f["engine"] == "frozen":
                continue
            done = consumed.get(doc, 0)
            if f["engine"] == "mergetree":
                rep = self._reps.get(doc)
                if rep is None:
                    continue  # froze mid-round
                try:
                    rows = self._rows_of(rep, msn)
                except RuntimeError as exc:  # kernel error flag
                    self._freeze(doc, f, repr(exc))
                    continue
                del f["window"][: upto - done]
                consumed[doc] = upto
                f["rows"] = rows
                f["base"] = seq
                f["base_msn"] = msn
                # Rebuild from the serialized form: the restart path,
                # exercised every cadence, so a restored summarizer can
                # never diverge from this one.
                self._reps[doc] = self._boot_rep(rows, msn)
                blob = {"form": "mergetree", "doc": doc, "seq": seq,
                        "msn": msn, "count": count, "rows": rows}
            elif f["engine"] == "ops":
                blob = {"form": "ops", "doc": doc, "seq": seq,
                        "msn": msn, "count": count,
                        "records": list(f["records"][:rec_upto])}
            else:
                continue  # undecided: nothing but joins/leaves yet
            payload = json.dumps(
                blob, sort_keys=True, separators=(",", ":")
            ).encode()
            handle = self._put_blob(payload)
            f["last"] = {"seq": seq, "handle": handle}
            self._m_summaries.inc()
            self._m_blob_bytes.inc(len(payload))
            out.append(self._manifest({
                "doc": doc, "seq": seq, "msn": msn, "count": count,
                "form": blob["form"], "handle": handle,
                "bytes": len(payload),
            }, line_idx, byte_off))


class SummaryFolder(SummaryEmitter):
    """deltas records in, summaries out: the summary role's fold and
    emission without its supervision, on the ``overlay`` fold backend
    (the default here) or the ``kernel`` one (the role's default), with
    the same blobs.

    `process(rec)` takes sequenced deltas records one at a time (as
    the role's `process` does; anything but ``kind == "op"`` records
    with a ``doc`` is ignored) and notes a trigger every
    `summary_ops` records of a document. `flush()` folds and emits
    every pending trigger (the role's `flush_batch`) and returns the
    manifests ``{doc, seq, msn, count, form, handle, bytes}`` in
    trigger order; `blobs` maps each handle to its bytes. `device` is
    ``cuda`` by default (raising when there is none) or an explicit
    ``"cpu"``."""

    def __init__(self, summary_ops: int = DEFAULT_SUMMARY_OPS,
                 device: DeviceLike = None, fold_backend: str = "overlay"):
        self._init_emitter(summary_ops, fold_backend, device,
                           NullRegistry(), {})
        self.fold_backend = fold_backend
        self.blobs: Dict[str, bytes] = {}

    def _put_blob(self, payload: bytes) -> str:
        handle = hashlib.sha256(payload).hexdigest()
        self.blobs[handle] = payload
        return handle

    def process(self, rec: Any) -> None:
        self._take(rec, None, None)

    def flush(self) -> List[dict]:
        """Fold and emit every pending trigger; the manifests in
        trigger order."""
        out: List[dict] = []
        self._emit_triggers(out)
        return out
