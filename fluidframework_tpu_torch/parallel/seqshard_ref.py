"""Sequence-sharded overlay: ONE document split across shards.

Copied whole from fluidframework_tpu/parallel/seqshard_ref.py (the
numpy spec `SeqShardedOverlay`), over the port's copy of
`ops.overlay_ref`.

SURVEY.md §2.6 row 3: the reference scales document LENGTH with
chunked snapshots (snapshotV1.ts:37) and the associative per-block
`PartialSequenceLengths` (partialLengths.ts:256 `combine`); the
TPU-native form shards the segment table along the sequence dimension
so a single pathological document with a huge live window spreads
across devices.

Model
-----
The settled coordinate space ``[0, S_total)`` partitions CONTIGUOUSLY:
shard ``d`` owns a slice of settled text (local coordinates
``[0, S_d)``) plus every overlay row anchored inside it — each shard
IS a standalone `ops.overlay_ref.OverlayDoc`. Cross-shard structure:

- **Position resolve** — per-op, each shard computes its visible
  length at the op's perspective (its local partial-lengths sum); the
  exclusive prefix over shards (the associative `combine`) gives each
  shard its global offset. On a mesh this is one tiny all-gather of D
  scalars per op batch over ICI.
- **Insert landing** — candidate shards (those whose visible range
  can contain the position) split locally, then evaluate the landing
  predicate (insertingWalk + breakTie, mergeTree.ts:1740,:1719)
  locally; the FIRST shard (document order) that lands takes the row.
  If none lands, the insert appends at the global storage end: the
  shard owning the target settled coordinate stores it.
- **Range ops** — each shard applies its clipped sub-range in local
  visible coordinates (splits, gap materialization, covered-row
  updates are all shard-local).
- **Fold** (zamboni role) — entirely shard-local: rows settle into or
  excise from the shard's own settled text; boundaries shift
  implicitly because they are DERIVED (B_d = sum of earlier shards'
  settled lengths), never stored.
- **Rebalance** — boundary segment exchange: straddling rows split at
  the new boundaries, then settled text + rows redistribute evenly.

This module is the executable semantic spec (numpy, one op at a
time), differentially gated against the single-doc OverlayDoc /
OverlayStreamReplica digests; `parallel.seqshard` is the compiled
shard_map form of exactly these semantics.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops.mergetree_kernel import (
    ERR_BAD_POS,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
)
from ..ops.overlay_ref import SETTLED_BASE, OverlayDoc, merge_span_props


class SeqShardedOverlay:
    """A single overlay document sequence-sharded over `n_shards`
    shard docs. Streams resolve text through the stream arena like
    OverlayStreamReplica (offsets into ``stream.text``)."""

    def __init__(self, stream, n_shards: int, initial_len: int = 0,
                 fold_interval: int = 2048, n_removers: int = 4,
                 n_prop_keys: int = 8):
        self.stream = stream
        self.D = n_shards
        self.fold_interval = fold_interval
        self.error = 0
        stream_text = np.asarray(stream.text, np.int32)
        self._stream_text = stream_text
        # Partition the initial settled text evenly.
        bounds = np.linspace(0, initial_len, n_shards + 1).astype(int)
        self.shards: List[OverlayDoc] = []
        for d in range(n_shards):
            doc = OverlayDoc(
                stream_text[bounds[d]:bounds[d + 1]].copy(),
                n_removers, n_prop_keys,
            )
            self._wire_row_text(doc)
            self.shards.append(doc)

    def _wire_row_text(self, doc: OverlayDoc) -> None:
        stream_text = self._stream_text

        def row_text(i: int) -> np.ndarray:
            b = int(doc.buf[i])
            ln = int(doc.length[i])
            if b >= SETTLED_BASE:
                a = b - SETTLED_BASE
                return doc.settled_text[a: a + ln]
            return stream_text[b: b + ln]

        doc._row_text = row_text  # type: ignore[assignment]

    # ------------------------------------------------------ partials

    def _partials(self, ref_seq: int, client: int):
        """Per-shard (visible_len, delta_sum) at a perspective plus
        the exclusive visible-offset prefix — the cross-shard
        associative partial-lengths combine."""
        vis = np.zeros(self.D, np.int64)
        delta = np.zeros(self.D, np.int64)
        for d, sh in enumerate(self.shards):
            _, vl = sh._visibility(ref_seq, client)
            _, ds = sh._pre(vl)
            delta[d] = ds
            vis[d] = sh.S + ds
        off = np.concatenate([[0], np.cumsum(vis)[:-1]])
        return vis, delta, off

    @property
    def S_total(self) -> int:
        return sum(sh.S for sh in self.shards)

    # --------------------------------------------------------- apply

    def apply(self, op_type: int, pos1: int, pos2: int, seq: int,
              ref_seq: int, client: int, buf_start: int, ins_len: int,
              prop_keys, prop_vals) -> None:
        if op_type == OP_INSERT:
            self._apply_insert(pos1, seq, ref_seq, client, buf_start,
                               ins_len, prop_keys, prop_vals)
        elif op_type in (OP_REMOVE, OP_ANNOTATE):
            self._apply_range(op_type, pos1, pos2, seq, ref_seq, client,
                              prop_keys, prop_vals)

    def _candidates(self, pos: int, vis, off):
        return [
            d for d in range(self.D)
            if off[d] <= pos <= off[d] + vis[d]
        ]

    def _props_row(self, prop_keys, prop_vals) -> np.ndarray:
        props_row = np.full(self.shards[0].KK, PROP_ABSENT, np.int32)
        for k, v in zip(prop_keys, prop_vals):
            if k >= 0:
                props_row[k] = PROP_ABSENT if v == PROP_DELETE else v
        return props_row

    def _owner_of(self, c: int) -> Tuple[int, int]:
        """(shard, shard base coordinate) owning settled coordinate
        `c`: half-open ranges, last shard owns its own end."""
        base = 0
        for d, sh in enumerate(self.shards):
            if c < base + sh.S or d == self.D - 1:
                return d, base
            base += sh.S
        return self.D - 1, base

    def _apply_insert(self, pos1, seq, ref_seq, client, buf_start,
                      ins_len, prop_keys, prop_vals) -> None:
        vis, delta, off = self._partials(ref_seq, client)
        # Splits are local: only a shard whose row strictly contains
        # the local position has anything to split (no-op elsewhere).
        for d in self._candidates(pos1, vis, off):
            self.shards[d]._split(int(pos1 - off[d]), ref_seq, client)
        # Landing walk over ALL shards in document order (a landing
        # row with pre > pos can live in a shard whose visible range
        # starts after the position — invisible-at-perspective content
        # pulls later rows' pre below their shard offset).
        bases = np.concatenate(
            [[0], np.cumsum([sh.S for sh in self.shards])]
        )
        for e, sh in enumerate(self.shards):
            q = int(pos1 - off[e])
            skip, vl = sh._visibility(ref_seq, client)
            pre, _ = sh._pre(vl)
            land = (pre > q) | (
                (pre == q) & ~skip & ((vl > 0) | (seq > sh.iseq))
            )
            if not land.any():
                continue
            j = int(np.argmax(land))
            # The landed row's target coordinate can precede this
            # shard: store at the OWNER shard's storage end then (the
            # walk guarantees every shard in between is rowless).
            c_global = int(sh.anchor[j]) + int(bases[e]) - (
                int(pre[j]) - q
            )
            if c_global >= bases[e]:
                sh._insert_row(
                    j, c_global - int(bases[e]), buf_start, ins_len,
                    seq, client, NOT_REMOVED, None,
                    self._props_row(prop_keys, prop_vals),
                )
            else:
                d, base = self._owner_of(c_global)
                own = self.shards[d]
                # Every non-landing row bounds the target coordinate
                # from below (c >= its anchor), so nothing can sit
                # between the owner's end and the landed row.
                assert j == 0 and all(
                    self.shards[f].n == 0 for f in range(d + 1, e)
                ), "rows between landing shard and owner"
                own._insert_row(
                    own.n, min(c_global - base, own.S), buf_start,
                    ins_len, seq, client, NOT_REMOVED, None,
                    self._props_row(prop_keys, prop_vals),
                )
            return
        # No landing row anywhere: append at the global storage end —
        # the shard owning the target settled coordinate stores it
        # (exact single-doc semantics: anchor = min(pos - delta, S)).
        total = int(off[-1] + vis[-1]) if self.D else 0
        if pos1 > total:
            self.error |= ERR_BAD_POS
        c = min(int(pos1 - delta.sum()), self.S_total)
        d, base = self._owner_of(c)
        own = self.shards[d]
        own._insert_row(
            own.n, min(c - base, own.S), buf_start, ins_len, seq,
            client, NOT_REMOVED, None,
            self._props_row(prop_keys, prop_vals),
        )

    def _apply_range(self, op_type, pos1, pos2, seq, ref_seq, client,
                     prop_keys, prop_vals) -> None:
        vis, delta, off = self._partials(ref_seq, client)
        total = int(off[-1] + vis[-1]) if self.D else 0
        if pos2 > total:
            self.error |= ERR_BAD_POS
        for d, sh in enumerate(self.shards):
            lo = max(int(pos1 - off[d]), 0)
            hi = min(int(pos2 - off[d]), int(vis[d]))
            if lo >= hi:
                continue
            sh._apply_range(op_type, lo, hi, seq, ref_seq, client,
                            prop_keys, prop_vals)
            self.error |= sh.error

    # ---------------------------------------------------------- fold

    def fold(self, msn: int) -> None:
        """Settle-merge: ENTIRELY shard-local (boundaries are derived,
        so a shard growing or shrinking needs no exchange)."""
        for sh in self.shards:
            sh.fold(msn)

    # ----------------------------------------------------- rebalance

    def rebalance(self) -> None:
        """Boundary segment exchange: split rows straddling the new
        even boundaries, then redistribute settled text and rows. (On
        a mesh: ppermute of boundary slices over ICI.)"""
        S_total = self.S_total
        new_bounds = np.linspace(0, S_total, self.D + 1).astype(int)
        # Split any span row straddling a new boundary at that
        # boundary (coordinate-space split: tail advances its anchor).
        base = 0
        for sh in self.shards:
            for b in new_bounds[1:-1]:
                lb = int(b) - base
                if lb <= 0 or lb >= sh.S:
                    continue
                is_span = sh._is_span()
                inside = (
                    is_span & (sh.anchor < lb)
                    & (sh.anchor + sh.length > lb)
                )
                if inside.any():
                    j = int(np.argmax(inside))
                    off_in = lb - int(sh.anchor[j])
                    sh._insert_row(
                        j + 1, lb, SETTLED_BASE + lb,
                        int(sh.length[j]) - off_in, sh.iseq[j],
                        sh.iclient[j], sh.rseq[j], sh.rcl[j].copy(),
                        sh.props[j].copy(),
                    )
                    sh.length[j] = off_in
            base += sh.S
        # Concatenate global state, then re-slice.
        g_text = np.concatenate([sh.settled_text for sh in self.shards])
        g_props = np.concatenate([sh.settled_props for sh in self.shards])
        g_attr = np.concatenate([sh.settled_attr for sh in self.shards])
        rows = []
        base = 0
        for sh in self.shards:
            for i in range(sh.n):
                rows.append((
                    int(sh.anchor[i]) + base, int(sh.buf[i]),
                    int(sh.length[i]), int(sh.iseq[i]),
                    int(sh.iclient[i]), int(sh.rseq[i]),
                    sh.rcl[i].copy(), sh.props[i].copy(),
                    bool(sh._is_span()[i]),
                ))
            base += sh.S
        KR, KK = self.shards[0].KR, self.shards[0].KK
        errors = [sh.error for sh in self.shards]
        new_shards: List[OverlayDoc] = []
        for d in range(self.D):
            blo, bhi = int(new_bounds[d]), int(new_bounds[d + 1])
            doc = OverlayDoc(g_text[blo:bhi].copy(), KR, KK)
            doc.settled_props = g_props[blo:bhi].copy()
            doc.settled_attr = g_attr[blo:bhi].copy()
            self._wire_row_text(doc)
            new_shards.append(doc)
        # Rows: anchor in [B_d, B_{d+1}) -> shard d; anchor == S_total
        # -> last shard. Storage order is preserved (rows were read in
        # document order; anchors are globally non-decreasing).
        for (a, buf, ln, iseq, icl, rseq, rcl, props, is_span) in rows:
            d = min(
                int(np.searchsorted(new_bounds[1:], a, side="right")),
                self.D - 1,
            )
            doc = new_shards[d]
            la = a - int(new_bounds[d])
            doc._insert_row(
                doc.n, la, SETTLED_BASE + la if is_span else buf, ln,
                iseq, icl, rseq, rcl, props,
            )
        self.shards = new_shards
        for sh, e in zip(self.shards, errors):
            sh.error |= e

    # -------------------------------------------------------- replay

    def replay(self) -> None:
        s = self.stream
        n = len(s)
        for i in range(n):
            self.apply(
                int(s.op_type[i]), int(s.pos1[i]), int(s.pos2[i]),
                int(s.seq[i]), int(s.ref_seq[i]), int(s.client[i]),
                int(s.buf_start[i]), int(s.ins_len[i]),
                [int(s.prop_key[i])], [int(s.prop_val[i])],
            )
            if (i + 1) % self.fold_interval == 0 or i + 1 == n:
                self.fold(int(s.min_seq[i]))

    def check_errors(self) -> None:
        from ..ops.mergetree_kernel import raise_kernel_errors

        err = self.error
        for sh in self.shards:
            err |= sh.error
        raise_kernel_errors(err)

    def verify_invariants(self) -> None:
        for sh in self.shards:
            sh.verify_invariants()

    # -------------------------------------------------------- output

    def _doc_order(self):
        out = []
        for sh in self.shards:
            cursor = 0
            is_span = sh._is_span()
            for i in range(sh.n):
                a = int(sh.anchor[i])
                if a > cursor:
                    out.append((
                        sh.settled_text[cursor:a],
                        sh.settled_props[cursor:a],
                    ))
                    cursor = a
                if int(sh.rseq[i]) != NOT_REMOVED:
                    if is_span[i]:
                        cursor = a + int(sh.length[i])
                    continue
                ln = int(sh.length[i])
                if is_span[i]:
                    out.append((
                        sh.settled_text[a: a + ln],
                        merge_span_props(
                            sh.settled_props[a: a + ln], sh.props[i]
                        ),
                    ))
                    cursor = a + ln
                else:
                    row_p = sh.props[i].copy()
                    row_p[row_p == PROP_DELETE] = PROP_ABSENT
                    out.append((
                        sh._row_text(i),
                        np.broadcast_to(row_p, (ln, sh.KK)),
                    ))
            if cursor < sh.S:
                out.append((
                    sh.settled_text[cursor:], sh.settled_props[cursor:]
                ))
        return out

    def get_text(self) -> str:
        return "".join(
            "".join(map(chr, t)) for t, _ in self._doc_order()
        )

    def annotated_spans(self) -> List[Tuple[str, Optional[dict]]]:
        spans: List[Tuple[str, Optional[dict]]] = []
        KK = self.shards[0].KK
        for text, props in self._doc_order():
            for j in range(len(text)):
                p = {
                    f"k{k}": int(props[j, k])
                    for k in range(KK)
                    if props[j, k] != PROP_ABSENT
                }
                spans.append((chr(int(text[j])), p or None))
        return spans

    def attribution_spans(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []

        def push(arr):
            for k in np.asarray(arr).tolist():
                if out and out[-1][1] == k:
                    out[-1] = (out[-1][0] + 1, k)
                else:
                    out.append((1, k))

        for sh in self.shards:
            cursor = 0
            is_span = sh._is_span()
            for i in range(sh.n):
                a = int(sh.anchor[i])
                if a > cursor:
                    push(sh.settled_attr[cursor:a])
                    cursor = a
                if int(sh.rseq[i]) != NOT_REMOVED:
                    if is_span[i]:
                        cursor = a + int(sh.length[i])
                    continue
                ln = int(sh.length[i])
                if is_span[i]:
                    push(sh.settled_attr[a: a + ln])
                    cursor = a + ln
                else:
                    push(np.full(ln, int(sh.iseq[i]), np.int32))
            push(sh.settled_attr[cursor:])
        return out
