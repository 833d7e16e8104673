"""Overlay merge-tree: numpy reference semantics for the O(window) engine.

Copied from fluidframework_tpu/ops/overlay_ref.py (SETTLED_BASE,
merge_span_props, OverlayDoc, OverlayReplica), re-pointed at the
port's constants. `OverlayMessageReplica` (the numpy spec fed by
messages) is left out: the port's message-driven replica is
`core.overlay_replay.OverlayKernelMessageReplica`.

It is the executable spec of the overlay chunk kernel
(ops/overlay.py, csrc/overlay_chunk.cu) and the host readout of the
port's `core.overlay_replay.OverlayDeviceReplica`. See the source
module's docstring for the representation and its invariants.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..protocol.constants import NO_CLIENT
from .mergetree_kernel import (
    ERR_BAD_POS,
    ERR_REMOVERS,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
)

SETTLED_BASE = 1 << 30  # buf encoding for span rows: SETTLED_BASE + coord


def merge_span_props(seg_p: np.ndarray, row_p: np.ndarray) -> np.ndarray:
    """Resolve a span row's prop cells over a settled-props slice:
    PROP_DELETE tombstones clear the key, PROP_ABSENT leaves it, any
    other value overwrites. The ONE definition of span-prop
    resolution — used by fold, read-out, and log reconstruction."""
    out = seg_p.copy()
    for k in range(seg_p.shape[1]):
        if row_p[k] == PROP_DELETE:
            out[:, k] = PROP_ABSENT
        elif row_p[k] != PROP_ABSENT:
            out[:, k] = row_p[k]
    return out


class OverlayDoc:
    """Numpy reference overlay document (dynamic arrays, one op/call)."""

    def __init__(self, settled_text: np.ndarray, n_removers: int = 4,
                 n_prop_keys: int = 8):
        self.KR = n_removers
        self.KK = n_prop_keys
        # Settled state (host-side; the device engine keeps only S and
        # reconstructs text/props from the fold log).
        self.settled_text = np.asarray(settled_text, np.int32).copy()
        self.settled_props = np.full(
            (len(settled_text), n_prop_keys), PROP_ABSENT, np.int32
        )
        # Per-position insert-attribution keys (insert seq; 0 for
        # loaded content) — the attributionCollection.ts role carried
        # through folds (unsettled rows derive theirs from iseq).
        self.settled_attr = np.zeros(len(settled_text), np.int32)
        self.S = len(settled_text)
        # Overlay rows (length-n arrays, storage order == doc order).
        self.anchor = np.zeros(0, np.int32)
        self.buf = np.zeros(0, np.int32)
        self.length = np.zeros(0, np.int32)
        self.iseq = np.zeros(0, np.int32)
        self.iclient = np.zeros(0, np.int32)
        self.rseq = np.zeros(0, np.int32)
        self.rcl = np.zeros((0, n_removers), np.int32)
        self.props = np.zeros((0, n_prop_keys), np.int32)
        self.error = 0
        # Peak overlay occupancy (capacity planning for the kernel).
        self.peak_rows = 0
        self.max_gaps_per_op = 0

    # ------------------------------------------------------------ helpers

    @property
    def n(self) -> int:
        return len(self.anchor)

    def _is_span(self) -> np.ndarray:
        return self.buf >= SETTLED_BASE

    def _consume(self) -> np.ndarray:
        return np.where(self._is_span(), self.length, 0)

    def _visibility(self, ref_seq: int, client: int):
        """Per-row (skip, vis_len) at a perspective — the
        mergeTree.ts:916 nodeLength predicate, identical to
        mergetree_kernel._visibility minus the live mask."""
        removed = self.rseq != NOT_REMOVED
        tomb = removed & (self.rseq <= ref_seq)
        ins_vis = (self.iclient == client) | (self.iseq <= ref_seq)
        among = (self.rcl == client).any(axis=1) if self.n else np.zeros(0, bool)
        skip = tomb | (removed & ~ins_vis)
        visible = ~skip & ins_vis & ~(removed & among)
        vis_len = np.where(visible, self.length, 0)
        return skip, vis_len

    def _pre(self, vis_len: np.ndarray):
        delta = vis_len - self._consume()
        cum = np.cumsum(delta) - delta
        return self.anchor + cum, int(delta.sum())

    def _insert_row(self, at: int, anchor, buf, length, iseq, iclient,
                    rseq, rcl_row=None, props_row=None) -> None:
        def ins(a, v):
            return np.insert(a, at, v, axis=0)

        self.anchor = ins(self.anchor, anchor)
        self.buf = ins(self.buf, buf)
        self.length = ins(self.length, length)
        self.iseq = ins(self.iseq, iseq)
        self.iclient = ins(self.iclient, iclient)
        self.rseq = ins(self.rseq, rseq)
        self.rcl = ins(
            self.rcl,
            rcl_row if rcl_row is not None
            else np.full(self.KR, NO_CLIENT, np.int32),
        )
        self.props = ins(
            self.props,
            props_row if props_row is not None
            else np.full(self.KK, PROP_ABSENT, np.int32),
        )
        self.peak_rows = max(self.peak_rows, self.n)

    def _split(self, pos: int, ref_seq: int, client: int) -> None:
        """Boundary split (ensureIntervalBoundary, mergeTree.ts:1706):
        if visible position `pos` falls strictly inside a row, split it.
        Span-row tails advance their anchor with the offset (the tail
        covers later coordinates); text-row tails keep the anchor (both
        halves sit at the same point)."""
        skip, vis = self._visibility(ref_seq, client)
        pre, _ = self._pre(vis)
        inside = ~skip & (pre < pos) & (pre + vis > pos)
        if not inside.any():
            return
        j = int(np.argmax(inside))
        off = pos - int(pre[j])
        span = bool(self._is_span()[j])
        self._insert_row(
            j + 1,
            self.anchor[j] + (off if span else 0),
            self.buf[j] + off,
            self.length[j] - off,
            self.iseq[j], self.iclient[j], self.rseq[j],
            self.rcl[j].copy(), self.props[j].copy(),
        )
        self.length[j] = off

    def _coord_of(self, pos: int, pre: np.ndarray, delta_sum: int) -> int:
        """Settled coordinate of visible position `pos` (assumes any
        row strictly containing `pos` was already split)."""
        cand = pre >= pos
        if cand.any():
            j = int(np.argmax(cand))
            return int(self.anchor[j]) - (int(pre[j]) - pos)
        return pos - delta_sum

    # ------------------------------------------------------------- apply

    def apply(self, op_type: int, pos1: int, pos2: int, seq: int,
              ref_seq: int, client: int, buf_start: int, ins_len: int,
              prop_keys, prop_vals) -> None:
        if op_type == OP_INSERT:
            self._apply_insert(pos1, seq, ref_seq, client, buf_start,
                               ins_len, prop_keys, prop_vals)
        elif op_type in (OP_REMOVE, OP_ANNOTATE):
            self._apply_range(op_type, pos1, pos2, seq, ref_seq, client,
                              prop_keys, prop_vals)
        # NOOP: nothing.

    def _apply_insert(self, pos1, seq, ref_seq, client, buf_start,
                      ins_len, prop_keys, prop_vals) -> None:
        self._split(pos1, ref_seq, client)
        skip, vis = self._visibility(ref_seq, client)
        pre, delta_sum = self._pre(vis)
        total = self.S + delta_sum
        # Landing (insertingWalk + breakTie, mergeTree.ts:1740,:1719):
        # pre > pos1 means visible settled text intervenes — land
        # before that row regardless of tie-breaks; at pre == pos1 the
        # row-model walk applies (walk past skip rows and
        # zero-visibility rows that win the tie).
        land = (pre > pos1) | (
            (pre == pos1) & ~skip & ((vis > 0) | (seq > self.iseq))
        )
        if land.any():
            j = int(np.argmax(land))
            anchor_new = int(self.anchor[j]) - (int(pre[j]) - pos1)
        else:
            j = self.n
            if pos1 > total:
                self.error |= ERR_BAD_POS
            anchor_new = min(pos1 - delta_sum, self.S)
        props_row = np.full(self.KK, PROP_ABSENT, np.int32)
        for k, v in zip(prop_keys, prop_vals):
            if k >= 0:
                props_row[k] = PROP_ABSENT if v == PROP_DELETE else v
        self._insert_row(
            j, anchor_new, buf_start, ins_len, seq, client,
            NOT_REMOVED, None, props_row,
        )

    def _apply_range(self, op_type, pos1, pos2, seq, ref_seq, client,
                     prop_keys, prop_vals) -> None:
        self._split(pos1, ref_seq, client)
        self._split(pos2, ref_seq, client)
        skip, vis = self._visibility(ref_seq, client)
        pre, delta_sum = self._pre(vis)
        total = self.S + delta_sum
        if pos2 > total:
            self.error |= ERR_BAD_POS
        c1 = self._coord_of(pos1, pre, delta_sum)
        c2 = self._coord_of(pos2, pre, delta_sum)

        # Gap materialization: implicit settled coordinates covered by
        # [c1, c2) become span rows, one per storage gap (gap k sits
        # before row k; text anchors bound gaps, so materialized rows
        # never contain a foreign anchor strictly inside).
        consume = self._consume()
        glo = np.concatenate([[0], self.anchor + consume]).astype(np.int64)
        ghi = np.concatenate([self.anchor, [self.S]]).astype(np.int64)
        lo = np.maximum(glo, c1)
        hi = np.minimum(ghi, c2)
        mat = np.nonzero(lo < hi)[0]
        self.max_gaps_per_op = max(self.max_gaps_per_op, len(mat))
        for k in mat[::-1]:  # descending: indices stay valid
            self._insert_row(
                int(k), int(lo[k]), SETTLED_BASE + int(lo[k]),
                int(hi[k] - lo[k]), 0, NO_CLIENT, NOT_REMOVED,
            )

        # Covered-range updates (markRangeRemoved mergeTree.ts:1960 /
        # annotateRange :1895), identical to the row-model kernel.
        skip, vis = self._visibility(ref_seq, client)
        pre, _ = self._pre(vis)
        covered = ~skip & (vis > 0) & (pre >= pos1) & (pre + vis <= pos2)
        if op_type == OP_REMOVE:
            already = self.rseq != NOT_REMOVED
            upd = covered
            self.rseq = np.where(upd & ~already, seq, self.rseq)
            free = self.rcl == NO_CLIENT
            first_free = np.argmax(free, axis=1) if self.n else np.zeros(0, int)
            no_free = ~free.any(axis=1) if self.n else np.zeros(0, bool)
            slot = np.where(already, first_free, 0)
            write = upd & ~(already & no_free)
            for i in np.nonzero(write)[0]:
                self.rcl[i, slot[i]] = client
            if (upd & already & no_free).any():
                self.error |= ERR_REMOVERS
        else:  # annotate: last writer wins; deletes tombstone on spans
            is_span = self._is_span()
            for k, v in zip(prop_keys, prop_vals):
                if k < 0:
                    continue
                idx = np.nonzero(covered)[0]
                for i in idx:
                    if v == PROP_DELETE:
                        self.props[i, k] = (
                            PROP_DELETE if is_span[i] else PROP_ABSENT
                        )
                    else:
                        self.props[i, k] = v

    # -------------------------------------------------------------- fold

    def fold(self, msn: int) -> None:
        """Settle-merge under applied MSN `msn` (see module docstring)."""
        if self.n == 0:
            return
        removed = self.rseq != NOT_REMOVED
        is_span = self._is_span()
        drop = removed & (self.rseq <= msn)
        settle_text = ~removed & ~is_span & (self.iseq <= msn)
        settle_span = ~removed & is_span
        folding = drop | settle_text | settle_span
        if not folding.any():
            return

        exc_len = np.where(drop & is_span, self.length, 0)
        ins_len = np.where(settle_text, self.length, 0)
        exc_before = np.cumsum(exc_len) - exc_len
        ins_before = np.cumsum(ins_len) - ins_len

        # Rebuild settled text/props/attr in coordinate (== storage)
        # order.
        pieces_t: List[np.ndarray] = []
        pieces_p: List[np.ndarray] = []
        pieces_a: List[np.ndarray] = []
        cursor = 0

        def take_settled(upto: int) -> None:
            nonlocal cursor
            pieces_t.append(self.settled_text[cursor:upto])
            pieces_p.append(self.settled_props[cursor:upto])
            pieces_a.append(self.settled_attr[cursor:upto])
            cursor = upto

        for i in np.nonzero(folding)[0]:
            a = int(self.anchor[i])
            ln = int(self.length[i])
            if settle_text[i]:
                take_settled(a)
                pieces_t.append(self._row_text(i))
                pieces_p.append(np.broadcast_to(
                    self._fold_props_row(i, text_row=True), (ln, self.KK)
                ).copy())
                pieces_a.append(np.full(ln, self.iseq[i], np.int32))
            elif drop[i] and is_span[i]:
                take_settled(a)
                cursor = a + ln  # excise
            elif settle_span[i]:
                take_settled(a)
                pieces_t.append(self.settled_text[a: a + ln])
                pieces_p.append(merge_span_props(
                    self.settled_props[a: a + ln], self.props[i]
                ))
                pieces_a.append(self.settled_attr[a: a + ln])
                cursor = a + ln
            # drop & text row: nothing to do (just removed from overlay)
        take_settled(self.S)
        self.settled_text = np.concatenate(pieces_t) if pieces_t else (
            np.zeros(0, np.int32)
        )
        self.settled_props = np.concatenate(pieces_p) if pieces_p else (
            np.zeros((0, self.KK), np.int32)
        )
        self.settled_attr = np.concatenate(pieces_a) if pieces_a else (
            np.zeros(0, np.int32)
        )
        self.S = len(self.settled_text)

        keep = ~folding
        new_anchor = self.anchor - exc_before + ins_before
        self.anchor = new_anchor[keep].astype(np.int32)
        self.buf = np.where(
            is_span, SETTLED_BASE + new_anchor, self.buf
        )[keep].astype(np.int32)
        self.length = self.length[keep]
        self.iseq = self.iseq[keep]
        self.iclient = self.iclient[keep]
        self.rseq = self.rseq[keep]
        self.rcl = self.rcl[keep]
        self.props = self.props[keep]

    def _row_text(self, i: int) -> np.ndarray:
        """Codepoints of row i (overridden by the replica to resolve
        arena offsets; span rows read settled coordinates)."""
        if self.buf[i] >= SETTLED_BASE:
            a = int(self.buf[i]) - SETTLED_BASE
            return self.settled_text[a: a + int(self.length[i])]
        raise NotImplementedError("text rows need an arena resolver")

    def _fold_props_row(self, i: int, text_row: bool) -> np.ndarray:
        row = self.props[i].copy()
        if text_row:
            # Text rows are authoritative: ABSENT means absent.
            row[row == PROP_DELETE] = PROP_ABSENT
        return row

    # ----------------------------------------------------- verification

    def verify_invariants(self) -> None:
        """Structural invariants of the overlay representation (the
        partialLengths.ts:336 verifier role for this engine)."""
        assert (self.length > 0).all(), "zero/negative-length row"
        is_span = self._is_span()
        consume = self._consume()
        # Anchors non-decreasing; spans disjoint; anchors within bounds.
        end = self.anchor + consume
        assert (self.anchor >= 0).all() and (end <= self.S).all(), (
            "anchor out of settled range"
        )
        if self.n > 1:
            assert (self.anchor[1:] >= end[:-1]).all(), (
                "anchor order / span overlap violation"
            )
        # Span buf encoding stays in sync with anchors.
        assert (
            self.buf[is_span] - SETTLED_BASE == self.anchor[is_span]
        ).all(), "span buf/anchor desync"
        # Removal bookkeeping mirrors the row model.
        removed = self.rseq != NOT_REMOVED
        has_removers = (self.rcl != NO_CLIENT).any(axis=1)
        assert (removed == has_removers).all(), "removal/remover mismatch"
        # Span rows are settled content: universal insert identity.
        assert (self.iseq[is_span] == 0).all(), "span row with insert seq"


class OverlayReplica:
    """Stream-driven overlay replica (numpy reference engine).

    Consumes a `testing.synthetic.ColumnarStream` like
    `core.columnar_replay.ColumnarReplica`, folding every
    `fold_interval` ops. Exposes get_text()/annotated_spans() for
    digest comparison. Text rows resolve through the stream arena
    (offsets are rebased by STREAM_BASE like columnar_replay) or the
    initial document text.
    """

    def __init__(self, stream, initial_len: int = 0,
                 fold_interval: int = 2048, n_removers: int = 4,
                 n_prop_keys: int = 8):
        self.stream = stream
        self.fold_interval = fold_interval
        doc = OverlayDoc(
            np.asarray(stream.text[:initial_len], np.int32),
            n_removers, n_prop_keys,
        )
        stream_text = np.asarray(stream.text, np.int32)

        def row_text(i: int) -> np.ndarray:
            b = int(doc.buf[i])
            ln = int(doc.length[i])
            if b >= SETTLED_BASE:
                a = b - SETTLED_BASE
                return doc.settled_text[a: a + ln]
            return stream_text[b: b + ln]

        doc._row_text = row_text  # type: ignore[assignment]
        self.doc = doc

    def replay(self) -> None:
        s = self.stream
        d = self.doc
        n = len(s)
        for i in range(n):
            d.apply(
                int(s.op_type[i]), int(s.pos1[i]), int(s.pos2[i]),
                int(s.seq[i]), int(s.ref_seq[i]), int(s.client[i]),
                int(s.buf_start[i]), int(s.ins_len[i]),
                [int(s.prop_key[i])], [int(s.prop_val[i])],
            )
            if (i + 1) % self.fold_interval == 0 or i + 1 == n:
                d.fold(int(s.min_seq[i]))

    def check_errors(self) -> None:
        from .mergetree_kernel import raise_kernel_errors

        raise_kernel_errors(self.doc.error)

    # ------------------------------------------------------------ output

    def attribution_spans(self) -> List[Tuple[int, int]]:
        """(run_length, attribution key) runs over the visible
        document, adjacent equal keys merged — same surface as the
        scalar/native engines' attribution_spans (farm-gated); keys
        are insert seqs, 0 for initial content, carried through folds
        by `OverlayDoc.settled_attr`."""
        d = self.doc
        keys: List[np.ndarray] = []
        cursor = 0
        is_span = d._is_span()
        for i in range(d.n):
            a = int(d.anchor[i])
            if a > cursor:
                keys.append(d.settled_attr[cursor:a])
                cursor = a
            if int(d.rseq[i]) != NOT_REMOVED:
                if is_span[i]:
                    cursor = a + int(d.length[i])
                continue
            ln = int(d.length[i])
            if is_span[i]:
                keys.append(d.settled_attr[a: a + ln])
                cursor = a + ln
            else:
                keys.append(np.full(ln, int(d.iseq[i]), np.int32))
        keys.append(d.settled_attr[cursor:])
        out: List[Tuple[int, int]] = []
        for arr in keys:
            for k in np.asarray(arr).tolist():
                if out and out[-1][1] == k:
                    out[-1] = (out[-1][0] + 1, k)
                else:
                    out.append((1, k))
        return out

    def _doc_order(self) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """(codepoints, per-char props | None) pieces in doc order:
        implicit settled gaps interleaved with visible overlay rows."""
        d = self.doc
        out: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        cursor = 0
        is_span = d._is_span()
        for i in range(d.n):
            a = int(d.anchor[i])
            if a > cursor:
                out.append((
                    d.settled_text[cursor:a], d.settled_props[cursor:a]
                ))
                cursor = a
            if int(d.rseq[i]) != NOT_REMOVED:
                if is_span[i]:
                    cursor = a + int(d.length[i])
                continue
            ln = int(d.length[i])
            if is_span[i]:
                out.append((
                    d.settled_text[a: a + ln],
                    merge_span_props(d.settled_props[a: a + ln], d.props[i]),
                ))
                cursor = a + ln
            else:
                row_p = d.props[i].copy()
                row_p[row_p == PROP_DELETE] = PROP_ABSENT
                out.append((
                    d._row_text(i),
                    np.broadcast_to(row_p, (ln, d.KK)),
                ))
        if cursor < d.S:
            out.append((d.settled_text[cursor:], d.settled_props[cursor:]))
        return out

    def get_text(self) -> str:
        return "".join(
            "".join(map(chr, t)) for t, _ in self._doc_order()
        )

    def annotated_spans(self) -> List[Tuple[str, Optional[dict]]]:
        """Per-char span list in the synthetic stream's key naming
        (k<idx>), the same surface ColumnarReplica exposes for
        digest comparison."""
        spans: List[Tuple[str, Optional[dict]]] = []
        for text, props in self._doc_order():
            for j in range(len(text)):
                p = {
                    f"k{k}": int(props[j, k])
                    for k in range(self.doc.KK)
                    if props[j, k] != PROP_ABSENT
                }
                spans.append((chr(int(text[j])), p or None))
        return spans
