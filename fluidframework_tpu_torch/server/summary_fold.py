"""The summary service's fold-and-emit datapath, on the overlay engine.

Copied from fluidframework_tpu/server/summarizer.py, the parts that
decide what a summary holds: `_decode_mt_op` (:179), `_encode_fold`
(:251), the engine decision and cadence triggers of
`SummarizerRole.process` (:626-670), `_freeze` (:674), the round
grouping of `flush_batch` (:703-718) and `_emit_round` (:760-837), with
`supervisor.canonical_record` (:140). The fold runs on
`core.overlay_fold` (the role's ``overlay`` backend): every document
that summarizes in one emission round is stacked into one kernel
launch per chunk and window group.

`SummaryFolder` is that datapath without the role's supervision: no
fenced lease, heartbeat, checkpoint, topics, castore or metrics, and
no environment knobs (the role's ``FLUID_SUMMARY_OPS`` and
``FLUID_FOLD_*`` belong to the role). Its contract is the role's: for
the same deltas records it emits the same summaries, with blob bytes
``json.dumps(blob, sort_keys=True, separators=(",", ":"))`` and the
content-addressed handle the sha256 hex digest of those bytes
(`server/castore.py:53`).

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
from typing import Any, Dict, List, Tuple

from ..core.kernel_replica import encode_op
from ..core.overlay_fold import (
    OverlayFoldReplica,
    boot_overlay,
    fold_jobs_overlay,
)
from ..protocol.mergetree_ops import op_from_json
from ..protocol.messages import MessageType, SequencedMessage
from ..utils.devices import DeviceLike, resolve_device

__all__ = ["DEFAULT_SUMMARY_OPS", "SummaryFolder", "canonical_record"]

# Default emission cadence: one summary per doc every N sequenced
# records (the role's default).
DEFAULT_SUMMARY_OPS = 256


def canonical_record(rec: dict) -> dict:
    """A sequenced record minus transport bookkeeping (`inOff`, worker
    tags): the form digests and convergence checks compare."""
    return {
        k: rec[k]
        for k in ("kind", "doc", "seq", "msn", "client", "clientSeq",
                  "refSeq", "type", "contents")
        if k in rec
    }


def _decode_mt_op(contents: Any):
    """Merge-tree wire op, or None when the contents carry no
    merge-tree structure (the generic-doc detection rule)."""
    if not isinstance(contents, dict) or "type" not in contents:
        return None
    try:
        return op_from_json(contents)
    except (KeyError, ValueError, TypeError):
        return None


def _encode_fold(rep: OverlayFoldReplica, records: List[dict]) -> None:
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


class SummaryFolder:
    """deltas records in, summaries out: the summary role's fold and
    emission, on the overlay fold.

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
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.summary_ops = int(summary_ops)
        if self.summary_ops < 1:
            raise ValueError(f"summary_ops must be >= 1: {summary_ops}")
        # doc -> fold dict (JSON-serializable; live replicas cached
        # separately and rebuilt from the serialized rows).
        self.docs: Dict[str, dict] = {}
        self._reps: Dict[str, OverlayFoldReplica] = {}
        # (doc, window_upto, records_upto, seq, msn, count): the
        # pending emission points, folded and emitted by `flush`.
        self._triggers: List[tuple] = []
        self.blobs: Dict[str, bytes] = {}
        self.frozen: Dict[str, str] = {}  # doc -> why

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
        return f

    def _rep(self, doc: str, f: dict) -> OverlayFoldReplica:
        rep = self._reps.get(doc)
        if rep is None:
            rep = self._reps[doc] = boot_overlay(
                f["rows"], f["base_msn"], device=self.device
            )
        return rep

    def process(self, rec: Any) -> None:
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
            # after it belong to the NEXT summary. A cadence point
            # reached while the engine is still undecided (only
            # joins/leaves so far) is skipped, as the role does.
            self._triggers.append((
                rec["doc"], len(f["window"]), len(f["records"]),
                f["seq"], f["msn"], f["count"],
            ))

    # ------------------------------------------------------- emission

    def _freeze(self, doc: str, f: dict, why: str) -> None:
        """A doc whose stream stopped folding stops emitting summaries:
        it falls back to longer tails, never to a wrong summary."""
        f["engine"] = "frozen"
        f["window"] = []
        f["rows"] = []
        self._reps.pop(doc, None)
        self.frozen[doc] = why
        print(f"summary fold: froze {doc} ({why})", flush=True)

    def flush(self) -> List[dict]:
        """Fold and emit every pending trigger. Consecutive triggers of
        DISTINCT docs make one stacked fold round; a doc triggering
        twice starts a new round (its second fold depends on its
        first)."""
        triggers, self._triggers = self._triggers, []
        consumed: Dict[str, int] = {}
        out: List[dict] = []
        i = 0
        while i < len(triggers):
            round_docs: set = set()
            j = i
            while j < len(triggers) and triggers[j][0] not in round_docs:
                round_docs.add(triggers[j][0])
                j += 1
            self._emit_round(triggers[i:j], consumed, out)
            i = j
        return out

    def _emit_round(self, round_jobs: List[tuple],
                    consumed: Dict[str, int], out: List[dict]) -> None:
        fold_jobs: List[Tuple[OverlayFoldReplica, list]] = []
        for doc, upto, _rupto, _seq, _msn, _count in round_jobs:
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
            fold_jobs.append((rep, take))
        if fold_jobs:
            fold_jobs_overlay(fold_jobs)
        for doc, upto, rec_upto, seq, msn, count in round_jobs:
            f = self.docs[doc]
            if f["engine"] == "frozen":
                continue
            done = consumed.get(doc, 0)
            if f["engine"] == "mergetree":
                rep = self._reps.get(doc)
                if rep is None:
                    continue  # froze mid-round
                try:
                    rows = rep.canonical_rows(msn)
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
                self._reps[doc] = boot_overlay(rows, msn,
                                               device=self.device)
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
            handle = hashlib.sha256(payload).hexdigest()
            self.blobs[handle] = payload
            f["last"] = {"seq": seq, "handle": handle}
            out.append({
                "doc": doc, "seq": seq, "msn": msn, "count": count,
                "form": blob["form"], "handle": handle,
                "bytes": len(payload),
            })
