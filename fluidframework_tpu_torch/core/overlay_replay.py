"""Overlay replay engine on PyTorch: the port of the bench.py main path.

Counterpart of fluidframework_tpu/core/overlay_replay.py.
`OverlayDeviceReplica` consumes a pre-decoded `ColumnarStream` and
converges on the final document: the stream uploads once
(`prepare`), then `replay` runs every chunk through the overlay chunk
kernel, the fold and the log append (ops/overlay.py) with no host sync
inside the loop; errors ride the table's error word and are checked
at the end. After the timed region the host rebuilds the settled
document from the fold log (`reconstruct_settled`, copied from the
source module) and reads it out through the numpy spec's
`OverlayReplica` (annotated spans, text, attribution).

A ``device=`` argument takes the place of the JAX version's
``interpret=``: ``cuda`` (the default) launches the CUDA kernel,
``"cpu"`` runs its plain PyTorch version.

`replay_streaming` feeds the stream from host segments, each copied to
the device while the previous one replays. `stack_replicas`,
`restore_shard` and `replay_docs` replay many documents together: one
kernel launch (one block per document) and one fold per chunk for all
of them, the one-card counterpart of
`parallel.mesh.sharded_overlay_replay_multi`.

`OverlayKernelMessageReplica` is the message-driven form: it encodes
`SequencedMessage`s with the host op encoder
(`core.kernel_replica.encode_op`) and flushes whole chunks through the
same kernel and fold, with the same readout.
"""

from __future__ import annotations

from dataclasses import fields
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.mergetree_kernel import (
    NO_KEY,
    OP_NOOP,
    PROP_ABSENT,
    PROP_DELETE,
    OpBatch,
    raise_kernel_errors,
)
from ..ops.overlay import (
    REC_DROP_SPAN,
    REC_NONE,
    REC_SETTLE_SPAN,
    REC_SETTLE_TEXT,
    OverlayTable,
    fold_device,
    kernel_geometry,
    make_overlay_table,
    overlay_apply_chunk,
    replay_chunk_step,
    replay_fused,
    stack_tables,
)
from ..ops.overlay_ref import (
    SETTLED_BASE,
    OverlayDoc,
    OverlayReplica,
    merge_span_props,
)
from ..protocol.constants import NO_CLIENT
from ..protocol.messages import MessageType
from ..testing.synthetic import ColumnarStream
from ..utils.devices import DeviceLike, resolve_device
from .kernel_replica import (
    EncoderState,
    PropInterner,
    TextArena,
    encode_op,
    encoded_columns,
)


def reconstruct_settled(
    initial_text: np.ndarray,
    stream_text: np.ndarray,
    log: np.ndarray,
    counts: List[int],
    n_prop_keys: int,
    initial_props: Optional[np.ndarray] = None,
    initial_attr: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replay the fold log into the final settled (text, props, attr).

    Each epoch's records are in storage (== coordinate) order with
    anchors in that epoch's settled space — exactly the walk
    `overlay_ref.OverlayDoc.fold` performs in-place; here it runs once
    per epoch over the logged rows instead (same codes, same
    PROP_DELETE tombstone semantics; `attr` carries each settled
    position's insert-attribution key, record column 4).

    `initial_props`/`initial_attr` seed the settled props/attr arrays
    (defaults: all-absent / zero) — the INCREMENTAL form
    `core.overlay_fold.OverlayFoldReplica` applies per emission round,
    where the initial settled state carries real props from earlier
    rounds instead of a fresh load."""
    KK = n_prop_keys
    settled_t = np.asarray(initial_text, np.int32)
    settled_p = (
        np.asarray(initial_props, np.int32).copy()
        if initial_props is not None
        else np.full((len(settled_t), KK), PROP_ABSENT, np.int32)
    )
    settled_a = (
        np.asarray(initial_attr, np.int32).copy()
        if initial_attr is not None
        else np.zeros(len(settled_t), np.int32)
    )
    off = 0
    for cnt in counts:
        recs = log[off: off + cnt]
        off += cnt
        if cnt == 0:
            continue
        pieces_t: List[np.ndarray] = []
        pieces_p: List[np.ndarray] = []
        pieces_a: List[np.ndarray] = []
        cursor = 0
        for r in recs:
            a = int(r[0])
            code = int(r[1])
            b = int(r[2])
            ln = int(r[3])
            iseq = int(r[4])
            props = r[5:]
            pieces_t.append(settled_t[cursor:a])
            pieces_p.append(settled_p[cursor:a])
            pieces_a.append(settled_a[cursor:a])
            cursor = a
            if code == REC_SETTLE_TEXT:
                pieces_t.append(stream_text[b: b + ln])
                row = props.copy()
                row[row == PROP_DELETE] = PROP_ABSENT
                pieces_p.append(np.broadcast_to(row, (ln, KK)).copy())
                pieces_a.append(np.full(ln, iseq, np.int32))
            elif code == REC_DROP_SPAN:
                cursor = a + ln
            elif code == REC_SETTLE_SPAN:
                pieces_t.append(settled_t[a: a + ln])
                pieces_p.append(
                    merge_span_props(settled_p[a: a + ln], props)
                )
                pieces_a.append(settled_a[a: a + ln])
                cursor = a + ln
            elif code == REC_NONE:
                pass  # dropped text row: reconstructs to nothing
            else:
                raise ValueError(f"bad fold-log code {code}")
        pieces_t.append(settled_t[cursor:])
        pieces_p.append(settled_p[cursor:])
        pieces_a.append(settled_a[cursor:])
        settled_t = np.concatenate(pieces_t) if pieces_t else (
            np.zeros(0, np.int32)
        )
        settled_p = (
            np.concatenate(pieces_p)
            if pieces_p else np.zeros((0, KK), np.int32)
        )
        settled_a = (
            np.concatenate(pieces_a)
            if pieces_a else np.zeros(0, np.int32)
        )
    return settled_t, settled_p, settled_a


class OverlayDeviceReplica:
    """Device-resident overlay replica driven by columnar op arrays.

    Same output surface as the JAX `OverlayDeviceReplica` and the numpy
    `OverlayReplica` (get_text / annotated_spans / check_errors), so the
    digest gates compare all engines directly. `device` is ``cuda`` by
    default (raising when there is none) or an explicit ``"cpu"``.
    """

    def __init__(
        self,
        stream: ColumnarStream,
        initial_len: int = 0,
        chunk_size: int = 2048,
        window: int = 8192,
        n_removers: int = 4,
        n_prop_keys: int = 8,
        device: DeviceLike = None,
        log_cap: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        kernel_geometry(window, n_removers, n_prop_keys)
        self.stream = stream
        self.chunk_size = chunk_size
        self.window = window
        self.n_removers = n_removers
        self.n_prop_keys = n_prop_keys
        self.initial_len = initial_len

        n = len(stream)
        self.n_chunks = -(-n // chunk_size) if n else 0
        # Every row ever created folds (or survives) exactly once; ~3
        # rows/op (insert + split tails / gap spans) bounds the log.
        self.log_cap = log_cap or (3 * n + 4 * window)
        self.table = make_overlay_table(
            window, n_removers, n_prop_keys, settled_len=initial_len,
            device=self.device,
        )
        self.log = torch.zeros(
            (self.log_cap, 5 + n_prop_keys), dtype=torch.int32,
            device=self.device,
        )
        self.counts = torch.zeros(
            max(self.n_chunks, 1), dtype=torch.int32, device=self.device
        )
        self.cursor = torch.zeros((), dtype=torch.int32, device=self.device)
        self.chunks_done = 0
        self._doc: Optional[OverlayDoc] = None
        self._dev: Optional[OpBatch] = None
        self._host: Optional[OpBatch] = None

    # -------------------------------------------------------------- replay

    def prepare(self) -> None:
        """Upload the (NOOP-padded) op stream and per-chunk MSN
        schedule to the device: the load phase, outside the timed
        replay region."""
        if self._dev is not None:
            return
        self.prepare_host()
        self._dev = OpBatch(*(
            torch.from_numpy(getattr(self._host, f.name)).to(self.device)
            for f in fields(OpBatch)))
        self._msn_by_chunk = torch.from_numpy(self._host_msn).to(self.device)

    def prepare_host(self) -> None:
        """Decode the stream into padded HOST arrays only (numpy, in an
        `OpBatch`): the load phase of `replay_streaming`, which touches
        no device."""
        if self._host is not None:
            return
        s = self.stream
        n = len(s)
        B = self.chunk_size
        pad = self.n_chunks * B

        def up(a: np.ndarray, fill: int = 0) -> np.ndarray:
            out = np.full(pad, fill, np.int32)
            out[:n] = a
            return out

        self._host = OpBatch(
            op_type=up(s.op_type, OP_NOOP),
            pos1=up(s.pos1), pos2=up(s.pos2),
            seq=up(s.seq), ref_seq=up(s.ref_seq),
            client=up(s.client, NO_CLIENT),
            buf_start=up(s.buf_start), ins_len=up(s.ins_len),
            prop_keys=up(s.prop_key, NO_KEY)[:, None],
            prop_vals=up(s.prop_val, PROP_ABSENT)[:, None],
        )
        # Applied MSN at each chunk's end (the fold perspective).
        ends = np.minimum(np.arange(1, self.n_chunks + 1) * B, n) - 1
        self._host_msn = s.min_seq[ends].astype(np.int32)

    def replay_streaming(self, n_segments: int = 8) -> None:
        """Replay with the ingest in the loop: the op stream stays on
        the host and feeds the device segment by segment, each
        segment's copy overlapping the previous segment's replay (the
        JAX `replay_streaming`). On CUDA a segment is packed into one
        pinned host buffer and copied on a side stream; the replay's
        stream waits on the copy's event before that segment, so
        segment k+1 is copied while segment k replays. On the CPU the
        same segments are copied one after another. Same result as
        `replay`."""
        self.prepare_host()
        if not self.n_chunks:
            return
        n_segments = max(1, min(n_segments, self.n_chunks))
        seg_chunks = -(-self.n_chunks // n_segments)
        n_live = -(-self.n_chunks // seg_chunks)
        B = self.chunk_size
        host = [getattr(self._host, f.name) for f in fields(OpBatch)]
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def stage(si: int):
            lo_c = si * seg_chunks
            hi_c = min(lo_c + seg_chunks, self.n_chunks)
            lo, hi = lo_c * B, hi_c * B
            packed = torch.from_numpy(np.concatenate(
                [a[lo:hi].reshape(-1) for a in host]
                + [self._host_msn[lo_c:hi_c]]))
            if not cuda:
                return lo_c, hi - lo, hi_c - lo_c, packed.clone(), None, None
            packed = packed.pin_memory()
            with torch.cuda.stream(side):
                buf = packed.to(self.device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            return lo_c, hi - lo, hi_c - lo_c, buf, copied, packed

        def unpack(buf: torch.Tensor, n_ops: int, n_ch: int):
            out, off = [], 0
            for a in host:
                width = a.shape[1] if a.ndim > 1 else 1
                f = buf[off:off + n_ops * width]
                out.append(f.view(n_ops, width) if a.ndim > 1 else f)
                off += n_ops * width
            return OpBatch(*out), buf[off:off + n_ch]

        nxt = stage(0)
        for si in range(n_live):
            lo_c, n_ops, n_ch, buf, copied, _pinned = nxt
            if si + 1 < n_live:
                nxt = stage(si + 1)  # its copy overlaps this replay
            if copied is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(copied)
                buf.record_stream(compute)
            ops, msns = unpack(buf, n_ops, n_ch)
            self.table, self.log, self.counts, self.cursor = replay_fused(
                self.table, ops, self.log, self.counts, msns,
                self.chunk_size, epoch0=lo_c,
            )
        self.chunks_done = self.n_chunks
        self._doc = None

    def replay(self, limit_chunks: Optional[int] = None) -> None:
        """Replay the stream. Full replays run `replay_fused` (one
        loop, no host sync inside); `limit_chunks` runs the per-chunk
        `replay_chunk_step` form for the first chunks instead."""
        self.prepare()
        if limit_chunks is None and self.n_chunks:
            self.table, self.log, self.counts, self.cursor = replay_fused(
                self.table, self._dev, self.log, self.counts,
                self._msn_by_chunk, self.chunk_size,
            )
            self.chunks_done = self.n_chunks
            self._doc = None
            return
        for ci in range(self.n_chunks):
            if limit_chunks is not None and ci >= limit_chunks:
                break
            self.table, self.log, self.counts, self.cursor = (
                replay_chunk_step(
                    self.table, self._dev, ci * self.chunk_size,
                    self.chunk_size, self._msn_by_chunk[ci], self.log,
                    self.counts, self.cursor, ci,
                )
            )
            self.chunks_done = ci + 1
        self._doc = None

    # ------------------------------------------------------------- output

    def check_errors(self) -> None:
        raise_kernel_errors(int(self.table.error))

    def _materialize(self) -> OverlayDoc:
        """Pull the table + fold log once and rebuild the final
        overlay document host-side (off the timed path)."""
        if self._doc is not None:
            return self._doc
        cursor = int(self.cursor)
        if cursor + self.window > self.log_cap:
            raise RuntimeError(
                f"fold log overflow ({cursor} + {self.window} rows > "
                f"cap {self.log_cap}); raise log_cap"
            )
        counts = self.counts.cpu().numpy()[: self.chunks_done].tolist()
        log = self.log[:cursor].cpu().numpy()
        settled_t, settled_p, settled_a = reconstruct_settled(
            self.stream.text[: self.initial_len], self.stream.text,
            log, counts, self.n_prop_keys,
        )
        doc = OverlayDoc(settled_t, self.n_removers, self.n_prop_keys)
        doc.settled_props = settled_p
        doc.settled_attr = settled_a
        t = self.table
        m = int(t.n_rows)

        def rows(a: torch.Tensor) -> np.ndarray:
            return a[:m].cpu().numpy()

        doc.anchor = rows(t.anchor)
        doc.buf = rows(t.buf_start)
        doc.length = rows(t.length)
        doc.iseq = rows(t.ins_seq)
        doc.iclient = rows(t.ins_client)
        doc.rseq = rows(t.rem_seq)
        doc.rcl = rows(t.rem_clients)
        doc.props = rows(t.props)
        doc.error = int(t.error)
        stream_text = np.asarray(self.stream.text, np.int32)

        def row_text(i: int) -> np.ndarray:
            b = int(doc.buf[i])
            ln = int(doc.length[i])
            if b >= SETTLED_BASE:
                a = b - SETTLED_BASE
                return doc.settled_text[a: a + ln]
            return stream_text[b: b + ln]

        doc._row_text = row_text  # type: ignore[assignment]
        self._doc = doc
        return doc

    def _shim(self) -> OverlayReplica:
        shim = OverlayReplica.__new__(OverlayReplica)
        shim.doc = self._materialize()
        shim.stream = self.stream
        return shim

    def get_text(self) -> str:
        return OverlayReplica.get_text(self._shim())

    def annotated_spans(self):
        return OverlayReplica.annotated_spans(self._shim())

    def attribution_spans(self):
        """(run_length, insert-attribution key) runs over the visible
        document: settled keys ride the fold log's ins_seq column,
        unsettled rows derive theirs from the table's ins_seq."""
        return OverlayReplica.attribution_spans(self._shim())

    def verify_invariants(self) -> None:
        self._materialize().verify_invariants()


def stack_replicas(reps: List[OverlayDeviceReplica]):
    """Stack replicas into the docs form of `replay_fused`:
    ``(tables, ops, logs, counts, msn_by_chunk)`` with tables and logs
    ``[D, ...]``, counts ``[D, n_chunks]``, and ops ``[n_chunks, D, B]``
    and msn_by_chunk ``[n_chunks, D]``, so that each chunk of every
    document is one contiguous slice (the JAX version stacks the ops
    and MSNs docs-first, for `lax.map`). Prepares each replica. The
    documents must share window, chunk size, remover slots, prop keys,
    chunk count, log rows and device, as `jnp.stack` requires of the
    reference's; a mismatch raises ValueError."""
    if not reps:
        raise ValueError("stack_replicas: no replicas")
    for name in ("window", "chunk_size", "n_removers", "n_prop_keys",
                 "n_chunks", "log_cap", "device"):
        got = {getattr(r, name) for r in reps}
        if len(got) > 1:
            raise ValueError(
                f"stack_replicas: the documents differ in {name}: "
                f"{sorted(map(str, got))}")
    for r in reps:
        r.prepare()
    n_chunks, B = reps[0].n_chunks, reps[0].chunk_size

    def chunked(a: torch.Tensor) -> torch.Tensor:
        return a.view(n_chunks, B, *a.shape[1:])

    ops = OpBatch(*(
        torch.stack([chunked(getattr(r._dev, f.name)) for r in reps], 1)
        for f in fields(OpBatch)))
    return (
        stack_tables([r.table for r in reps]),
        ops,
        torch.stack([r.log for r in reps]),
        torch.stack([r.counts for r in reps]),
        torch.stack([r._msn_by_chunk for r in reps], 1),
    )


def restore_shard(
    rep: OverlayDeviceReplica, out_tables: OverlayTable, out_logs,
    out_counts, cursors, d: int,
) -> OverlayDeviceReplica:
    """Load document `d`'s outputs of a docs replay (`replay_docs`) into
    `rep`, so that its host-side readout (get_text / annotated_spans /
    check_errors) reflects that run."""
    rep.table = out_tables.doc(d)
    rep.log = out_logs[d]
    rep.counts = out_counts[d]
    rep.cursor = cursors[d]
    rep.chunks_done = rep.n_chunks
    rep._doc = None
    return rep


def replay_docs(reps: List[OverlayDeviceReplica]):
    """Replay many documents at once on one device: the one-card
    counterpart of `parallel.mesh.sharded_overlay_replay_multi`. The
    replicas are stacked (`stack_replicas`) and every chunk of all of
    them is one kernel launch (one block per document) and one fold.

    Returns ``(tables, logs, counts, cursors, gmsn, gerr)`` as the
    reference does: the stacked outputs, the smallest final applied
    MSN over the documents, and the OR of their error bits. No host
    sync; `restore_shard` gives a replica its document's outputs."""
    tables, ops, logs, counts, msns = stack_replicas(reps)
    tables, logs, counts, cursors = replay_fused(
        tables, ops, logs, counts, msns, reps[0].chunk_size)
    gmsn = torch.min(msns[-1])
    bits = torch.arange(31, dtype=torch.int32, device=msns.device)
    err = torch.amax((tables.error[:, None] >> bits) & 1, 0)
    gerr = torch.sum(err << bits, dtype=torch.int32)
    return tables, logs, counts, cursors, gmsn, gerr


class OverlayKernelMessageReplica:
    """SequencedMessage-driven overlay replica: the overlay chunk kernel
    behind a message surface (counterpart of the JAX
    `OverlayKernelMessageReplica`, overlay_replay.py:454-612), so the
    farm differential tests (lagging refSeqs, tie-breaks, overlapping
    removes, multi-pair annotations) hold the kernel to the scalar
    oracle. Ops go through the host op encoder (text arena + prop
    interner). `device` is ``cuda`` by default (raising when there is
    none) or an explicit ``"cpu"``; it takes the place of the
    reference's ``interpret=True``."""

    def __init__(self, initial: str = "", chunk_size: int = 64,
                 window: int = 1024, n_removers: int = 4,
                 n_prop_keys: int = 8, max_prop_pairs: int = 4,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        kernel_geometry(window, n_removers, n_prop_keys)
        self.arena = TextArena("")
        self.props = PropInterner(n_prop_keys)
        self.chunk_size = chunk_size
        self.window = window
        self.n_removers = n_removers
        self.n_prop_keys = n_prop_keys
        self.max_prop_pairs = max_prop_pairs
        self.initial = initial
        self._initial_np = np.asarray([ord(c) for c in initial], np.int32)
        self.table = make_overlay_table(
            window, n_removers, n_prop_keys, settled_len=len(initial),
            device=self.device,
        )
        self._rows: List[tuple] = []
        self._epochs: List[np.ndarray] = []
        self._doc: Optional[OverlayDoc] = None

    def apply_messages(self, msgs) -> None:
        """Encode `msgs` and apply every whole chunk, then the rest as
        one short chunk; with nothing pending, one fold at the last
        MSN seen (a fold-only epoch)."""
        enc = EncoderState(self.arena, self.props, self.max_prop_pairs)
        msn = 0
        for msg in msgs:
            if msg.type == MessageType.OP and msg.contents is not None:
                encode_op(enc, msg.contents, msg)
                self._rows.extend(enc._encoded)
                if enc._encoded:
                    msn = enc._encoded[-1][10]
                enc._encoded = []
            else:
                msn = max(msn, msg.minimum_sequence_number)
            while len(self._rows) >= self.chunk_size:
                self._flush(self._rows[: self.chunk_size])
                self._rows = self._rows[self.chunk_size:]
        if self._rows:
            self._flush(self._rows)
            self._rows = []
        else:
            self._fold(msn)
        self._doc = None

    def _flush(self, rows: List[tuple]) -> None:
        """One chunk of encoded rows (NOOP-padded to the chunk size)
        through the kernel, then the fold at its last row's MSN."""
        batch = OpBatch(*(
            torch.from_numpy(a).to(self.device)
            for a in encoded_columns(rows, self.chunk_size,
                                     self.max_prop_pairs)))
        self.table = overlay_apply_chunk(self.table, batch)
        self._fold(rows[-1][10])

    def _fold(self, msn: int) -> None:
        self.table, records, n_rec = fold_device(self.table, msn)
        self._epochs.append(records[: int(n_rec)].cpu().numpy())

    # ------------------------------------------------------------- output

    def check_errors(self) -> None:
        raise_kernel_errors(int(self.table.error))

    def _materialize(self) -> OverlayDoc:
        if self._doc is not None:
            return self._doc
        arena_text = np.asarray(
            [ord(c) for c in self.arena.snapshot()], np.int32
        )
        counts = [len(r) for r in self._epochs]
        log = (
            np.concatenate(self._epochs) if self._epochs
            else np.zeros((0, 5 + self.n_prop_keys), np.int32)
        )
        settled_t, settled_p, settled_a = reconstruct_settled(
            self._initial_np, arena_text, log, counts, self.n_prop_keys
        )
        doc = OverlayDoc(settled_t, self.n_removers, self.n_prop_keys)
        doc.settled_props = settled_p
        doc.settled_attr = settled_a
        t = self.table
        m = int(t.n_rows)

        def rows(a: torch.Tensor) -> np.ndarray:
            return a[:m].cpu().numpy()

        doc.anchor = rows(t.anchor)
        doc.buf = rows(t.buf_start)
        doc.length = rows(t.length)
        doc.iseq = rows(t.ins_seq)
        doc.iclient = rows(t.ins_client)
        doc.rseq = rows(t.rem_seq)
        doc.rcl = rows(t.rem_clients)
        doc.props = rows(t.props)
        doc.error = int(t.error)

        def row_text(i: int) -> np.ndarray:
            b = int(doc.buf[i])
            ln = int(doc.length[i])
            if b >= SETTLED_BASE:
                a = b - SETTLED_BASE
                return doc.settled_text[a: a + ln]
            return arena_text[b: b + ln]

        doc._row_text = row_text  # type: ignore[assignment]
        self._doc = doc
        return doc

    def verify_invariants(self) -> None:
        self._materialize().verify_invariants()

    def _doc_order(self):
        shim = OverlayReplica.__new__(OverlayReplica)
        shim.doc = self._materialize()
        return OverlayReplica._doc_order(shim)

    def get_text(self) -> str:
        return "".join(
            "".join(map(chr, t)) for t, _ in self._doc_order()
        )

    def annotated_spans(self):
        spans: List[Tuple[str, Optional[dict]]] = []
        for text, props in self._doc_order():
            for j in range(len(text)):
                row = np.asarray(props[j])
                p = self.props.decode_row(
                    np.where(row == PROP_DELETE, PROP_ABSENT, row)
                )
                spans.append((chr(int(text[j])), p))
        return spans
