"""The row-model replica and the host op encoder.

Copied from fluidframework_tpu/core/kernel_replica.py: `TextArena`
(:69), `PropInterner` (:91), `KernelReplica` (:132-397), `EncoderState`
(:399) and `encode_op` (:413). Host responsibilities, outside every
kernel:

- text arena: inserted content is appended to a host-side arena and
  the kernels only move ``(buf_start, length)`` spans;
- dictionary encoding: property keys map to static columns and values
  to int ids (the columnar form of the reference's PropertySet JSON,
  packages/dds/merge-tree/src/properties.ts);
- one op becomes one row, or several: an insert or annotate with more
  than ``max_prop_pairs`` props splits into follow-up annotate rows at
  the same perspective, and a `GroupOp` encodes its ops in order;
  `encoded_columns` lays rows out as the kernels' op columns.

`KernelReplica` is the passive row-model replica: it encodes the
totally ordered sequenced messages, applies them a chunk at a time
through the row-model scan (`ops/mergetree_kernel.apply_op_batch`: the
hand-written kernel ``csrc/mergetree_scan.cu`` on the card, the plain
version on the CPU), grows the table ahead of need, and compacts it on
the host (zamboni and settled-run coalescing over a rewritten arena)
past a watermark, with the reference's chunk, capacity and watermark
rules. ``device`` is ``cuda`` by default (raising when there is none)
or an explicit ``"cpu"``.
"""

from __future__ import annotations

import json
from dataclasses import fields
from types import SimpleNamespace
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..ops.mergetree_kernel import (
    NO_KEY,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
    OpBatch,
    SegmentTable,
    apply_op_batch,
    grow_table,
    make_table,
    raise_kernel_errors,
)
from ..protocol.constants import NO_CLIENT, UNIVERSAL_SEQ
from ..protocol.mergetree_ops import (
    AnnotateOp,
    GroupOp,
    InsertOp,
    MergeTreeOp,
    RemoveOp,
)
from ..protocol.messages import MessageType, SequencedMessage
from ..utils.devices import DeviceLike, resolve_device


class TextArena:
    """Append-only host text arena addressed by code-point offset."""

    def __init__(self, initial: str = ""):
        self._parts: List[str] = [initial] if initial else []
        self._len = len(initial)

    def append(self, text: str) -> int:
        off = self._len
        self._parts.append(text)
        self._len += len(text)
        return off

    def __len__(self) -> int:
        return self._len

    def snapshot(self) -> str:
        if len(self._parts) != 1:
            self._parts = ["".join(self._parts)]
        return self._parts[0] if self._parts else ""


class PropInterner:
    """key → props column id; value → int id (None/delete is a sentinel)."""

    def __init__(self, max_keys: int):
        self.max_keys = max_keys
        self.key_ids: Dict[str, int] = {}
        self.values: List[Any] = []
        self._value_ids: Dict[str, int] = {}

    def key_id(self, key: str) -> int:
        kid = self.key_ids.get(key)
        if kid is None:
            kid = len(self.key_ids)
            if kid >= self.max_keys:
                raise ValueError(
                    f"more than {self.max_keys} distinct property keys; "
                    "raise n_prop_keys"
                )
            self.key_ids[key] = kid
        return kid

    def value_id(self, value: Any) -> int:
        if value is None:
            return PROP_DELETE
        token = json.dumps(value, sort_keys=True, default=repr)
        vid = self._value_ids.get(token)
        if vid is None:
            vid = len(self.values)
            self.values.append(value)
            self._value_ids[token] = vid
        return vid

    def decode_row(self, row: np.ndarray) -> Optional[dict]:
        out = {}
        for key, kid in self.key_ids.items():
            vid = int(row[kid])
            if vid != PROP_ABSENT:
                out[key] = self.values[vid]
        return out or None


def read_segment_table(table: SegmentTable) -> SimpleNamespace:
    """One document's table on the host, in one device-to-host copy: a
    namespace of int32 numpy arrays (``n_rows`` and ``error`` as 0-d
    arrays) under the `SegmentTable` field names."""
    C, KR = table.rem_clients.shape
    KK = table.props.shape[1]
    flat = torch.cat([getattr(table, f.name).reshape(-1)
                      for f in fields(SegmentTable)]).cpu().numpy()
    out, off = {}, 0
    for f in fields(SegmentTable):
        shape = {"n_rows": (), "error": (), "rem_clients": (C, KR),
                 "props": (C, KK)}.get(f.name, (C,))
        size = int(np.prod(shape))
        out[f.name] = flat[off: off + size].reshape(shape)
        off += size
    return SimpleNamespace(**out)


def upload_segment_table(cols: Dict[str, np.ndarray], n_rows: int,
                         error: int, device: torch.device) -> SegmentTable:
    """A `SegmentTable` on `device` from host columns (the seven
    `SegmentTable` columns by name), in one host-to-device copy: the
    fields are views of one buffer."""
    parts = [np.asarray([n_rows], np.int32)]
    names = [f.name for f in fields(SegmentTable)][1:-1]
    parts += [np.asarray(cols[k], np.int32).reshape(-1) for k in names]
    parts.append(np.asarray([error], np.int32))
    flat = torch.from_numpy(np.concatenate(parts)).to(device)
    views, off = {}, 0
    for f, p in zip(fields(SegmentTable), parts):
        shape = np.shape(cols[f.name]) if f.name in cols else ()
        views[f.name] = flat[off: off + p.size].view(shape)
        off += p.size
    return SegmentTable(**views)


def upload_op_batch(cols: List[np.ndarray], device: torch.device) -> OpBatch:
    """An `OpBatch` on `device` from its ten host columns in field order
    (`encoded_columns`; any leading shape), in one host-to-device copy."""
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.int32).reshape(-1) for a in cols])).to(device)
    views, off = [], 0
    for a in cols:
        views.append(flat[off: off + a.size].view(a.shape))
        off += a.size
    return OpBatch(*views)


class KernelReplica:
    """The passive row-model replica over the totally ordered op stream
    (the reference's `KernelReplica`, on the port's scan)."""

    def __init__(
        self,
        initial: str = "",
        chunk_size: int = 512,
        capacity: int = 4096,
        n_removers: int = 4,
        n_prop_keys: int = 8,
        max_prop_pairs: int = 4,
        compact_watermark: float = 0.65,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.chunk_size = chunk_size
        self.capacity = capacity
        self.n_removers = n_removers
        self.n_prop_keys = n_prop_keys
        self.max_prop_pairs = max_prop_pairs
        self.compact_watermark = compact_watermark

        self.arena = TextArena(initial)
        self.props = PropInterner(n_prop_keys)
        self.table = make_table(capacity, n_removers, n_prop_keys,
                                self.device)
        if initial:
            self.table.n_rows.fill_(1)
            self.table.length[0] = len(initial)
            self.table.ins_seq[0] = UNIVERSAL_SEQ
        self.min_seq = 0
        self.current_seq = 0
        # MSN as of the last op actually applied. Compaction must use
        # this (not self.min_seq): encoded-but-unapplied ops have refSeq
        # >= the MSN at their sequencing time >= this value, so
        # tombstones at or below it are skip for every pending op too.
        self._applied_min_seq = 0
        self._pending_rows_bound = 1 if initial else 0  # host row bound
        self._encoded: List[tuple] = []
        self._applied_since_compact = False

    # ------------------------------------------------------------- apply

    def apply_messages(self, msgs: Iterable[SequencedMessage]) -> None:
        for msg in msgs:
            if msg.type == MessageType.OP and msg.contents is not None:
                encode_op(self, msg.contents, msg)
            self.current_seq = msg.sequence_number
            self.min_seq = max(self.min_seq, msg.minimum_sequence_number)
            if len(self._encoded) >= self.chunk_size:
                self._flush_chunks(final=False)
        self._flush_chunks(final=True)

    def _flush_chunks(self, final: bool) -> None:
        while len(self._encoded) >= self.chunk_size or (
                final and self._encoded):
            chunk = self._encoded[: self.chunk_size]
            del self._encoded[: self.chunk_size]
            self._ensure_capacity()
            batch = self._build_batch(chunk)
            self.table = apply_op_batch(self.table, batch)
            self._applied_min_seq = chunk[-1][10]
            self._applied_since_compact = True
        if (self._applied_since_compact
                and self._pending_rows_bound
                > self.capacity * self.compact_watermark):
            # Only after ops were applied since the last compact: a
            # fresh compact can leave the bound above the watermark when
            # many rows stay unsettled, and compacting again on every
            # flush with nothing applied would rebuild the same table.
            self.compact()

    def _build_batch(self, chunk: list) -> OpBatch:
        """The chunk's encoded rows as an `OpBatch` of `chunk_size` ops
        (NOOP padding) on the replica's device, in one copy."""
        return upload_op_batch(
            encoded_columns(chunk, self.chunk_size, self.max_prop_pairs),
            self.device)

    # --------------------------------------------------------- capacity

    def _ensure_capacity(self) -> None:
        needed = self._pending_rows_bound + 2 * self.chunk_size + 8
        if needed <= self.capacity:
            return
        new_cap = self.capacity
        while new_cap < needed:
            new_cap *= 2
        self._grow(new_cap)

    def _grow(self, new_cap: int) -> None:
        self.table = grow_table(self.table, self.capacity, new_cap)
        self.capacity = new_cap

    # ------------------------------------------------------- compaction

    def compact(self) -> None:
        """Zamboni and settled-run coalescing over a rewritten arena.

        Safe because any future op's refSeq >= MSN (the deli nacks
        stale refSeqs): a tombstone with removal <= MSN is skip for
        every future perspective, and a settled row (ins_seq <= MSN,
        not removed) is visible to every future perspective, so runs of
        settled rows with identical props are indistinguishable from
        one loaded row."""
        t = read_segment_table(self.table)
        n = int(t.n_rows)
        text = self.arena.snapshot()
        msn = self._applied_min_seq

        # (text, ins_seq, ins_client, rem_seq, rem_clients, props)
        new_rows: List[tuple] = []
        run_parts: List[str] = []
        run_props: Optional[np.ndarray] = None

        def flush_run():
            nonlocal run_parts, run_props
            if run_parts:
                new_rows.append(("".join(run_parts), UNIVERSAL_SEQ,
                                 NO_CLIENT, None, None, run_props))
                run_parts = []
                run_props = None

        for i in range(n):
            rem = int(t.rem_seq[i])
            removed = rem != NOT_REMOVED
            if removed and rem <= msn:
                continue  # zamboni: tombstone below the window
            b = int(t.buf_start[i])
            seg_text = text[b: b + int(t.length[i])]
            if (not removed) and int(t.ins_seq[i]) <= msn:
                if run_props is not None and not np.array_equal(
                        run_props, t.props[i]):
                    flush_run()
                run_props = t.props[i].copy()
                run_parts.append(seg_text)
            else:
                flush_run()
                new_rows.append((seg_text, int(t.ins_seq[i]),
                                 int(t.ins_client[i]),
                                 rem if removed else None,
                                 t.rem_clients[i].copy(),
                                 t.props[i].copy()))
        flush_run()

        m = len(new_rows)
        cap = self.capacity
        while cap // 2 >= max(m + 2 * self.chunk_size + 8, 64) and cap > 64:
            cap //= 2
        cols = empty_columns(cap, self.n_removers, self.n_prop_keys)
        parts: List[str] = []
        off = 0
        for i, (seg_text, iseq, iclient, rseq, rclients, prow) in enumerate(
                new_rows):
            cols["buf_start"][i] = off
            cols["length"][i] = len(seg_text)
            cols["ins_seq"][i] = iseq
            cols["ins_client"][i] = iclient
            if rseq is not None:
                cols["rem_seq"][i] = rseq
                cols["rem_clients"][i] = rclients
            if prow is not None:
                cols["props"][i] = prow
            parts.append(seg_text)
            off += len(seg_text)
        self.arena = TextArena("".join(parts))
        self.capacity = cap
        # Encoded-but-unapplied ops still hold offsets into the old
        # arena; re-append their text to the new arena and remap.
        if self._encoded:
            remapped = []
            for row in self._encoded:
                if row[0] == OP_INSERT and row[7] > 0:
                    new_off = self.arena.append(text[row[6]: row[6] + row[7]])
                    row = row[:6] + (new_off,) + row[7:]
                remapped.append(row)
            self._encoded = remapped
        self.table = upload_segment_table(cols, m, int(t.error), self.device)
        self._pending_rows_bound = m + 2 * len(self._encoded)
        self._applied_since_compact = False

    # ------------------------------------------------------------ output

    def check_errors(self) -> None:
        raise_kernel_errors(int(self.table.error))

    def _visible_rows(self) -> List[Tuple[str, np.ndarray]]:
        self._flush_chunks(final=True)
        t = read_segment_table(self.table)
        text = self.arena.snapshot()
        out = []
        for i in range(int(t.n_rows)):
            if int(t.rem_seq[i]) == NOT_REMOVED:
                b = int(t.buf_start[i])
                out.append((text[b: b + int(t.length[i])], t.props[i]))
        return out

    def get_text(self) -> str:
        return "".join(seg for seg, _ in self._visible_rows())

    def annotated_spans(self) -> List[Tuple[str, Optional[dict]]]:
        return [(seg, self.props.decode_row(p))
                for seg, p in self._visible_rows()]


def empty_columns(capacity: int, n_removers: int,
                  n_prop_keys: int) -> Dict[str, np.ndarray]:
    """The seven host columns of an empty table (`make_table`'s fills)."""
    return dict(
        buf_start=np.zeros(capacity, np.int32),
        length=np.zeros(capacity, np.int32),
        ins_seq=np.zeros(capacity, np.int32),
        ins_client=np.full(capacity, NO_CLIENT, np.int32),
        rem_seq=np.full(capacity, NOT_REMOVED, np.int32),
        rem_clients=np.full((capacity, n_removers), NO_CLIENT, np.int32),
        props=np.full((capacity, n_prop_keys), PROP_ABSENT, np.int32),
    )


class EncoderState:
    """Minimal op-encoder state for the overlay replicas: a text arena +
    prop interner + the encode accumulators `encode_op` writes into."""

    def __init__(self, arena: TextArena, props: PropInterner,
                 max_prop_pairs: int):
        self.arena = arena
        self.props = props
        self.max_prop_pairs = max_prop_pairs
        self._encoded: List[tuple] = []
        self._pending_rows_bound = 0


def encode_op(state, op: MergeTreeOp, msg: SequencedMessage) -> None:
    """Encode one sequenced op into columnar rows
    ``(type, pos1, pos2, seq, ref, client, buf, len, keys, vals, msn)``
    appended to ``state._encoded``. `state` is a `KernelReplica`, an
    `EncoderState` or an `overlay_fold.OverlayFoldReplica` (anything
    with arena/props/max_prop_pairs and the two accumulators). Prop
    lists wider than max_prop_pairs split into follow-up annotate rows
    at the same perspective."""
    if isinstance(op, GroupOp):
        for sub in op.ops:
            encode_op(state, sub, msg)
        return
    seq, ref, cid = msg.sequence_number, msg.ref_seq, msg.client_id
    msn = msg.minimum_sequence_number
    pk = state.max_prop_pairs
    keys: List[int] = []
    vals: List[int] = []
    if isinstance(op, InsertOp):
        if op.seg is not None and not isinstance(op.seg, str):
            raise TypeError(
                "KernelReplica is a text engine; item sequences use "
                "ItemKernelReplica semantics (not yet vectorized)"
            )
        text = op.text if op.seg is None else op.seg
        off = state.arena.append(text)
        if op.props:
            for k, v in op.props.items():
                keys.append(state.props.key_id(k))
                vals.append(state.props.value_id(v))
        if len(keys) > pk:
            # Insert with the first PK props, then annotate the
            # inserted range with the rest at the same perspective
            # (at (ref, cid) after the insert, [pos, pos+len) covers
            # exactly the new segment).
            state._encoded.append(
                (OP_INSERT, op.pos, 0, seq, ref, cid, off, len(text),
                 keys[:pk], vals[:pk], msn)
            )
            state._pending_rows_bound += 2
            for i in range(pk, len(keys), pk):
                state._encoded.append(
                    (OP_ANNOTATE, op.pos, op.pos + len(text), seq, ref,
                     cid, 0, 0, keys[i:i + pk], vals[i:i + pk], msn)
                )
                state._pending_rows_bound += 2
            return
        row = (OP_INSERT, op.pos, 0, seq, ref, cid, off, len(text),
               keys, vals, msn)
    elif isinstance(op, RemoveOp):
        row = (OP_REMOVE, op.start, op.end, seq, ref, cid, 0, 0,
               keys, vals, msn)
    elif isinstance(op, AnnotateOp):
        for k, v in op.props.items():
            keys.append(state.props.key_id(k))
            vals.append(state.props.value_id(v))
        if len(keys) > pk:
            # Split into several annotate ops at the same perspective
            # (equivalent: same range, same seq stamps).
            for i in range(0, len(keys), pk):
                state._encoded.append(
                    (OP_ANNOTATE, op.start, op.end, seq, ref, cid, 0, 0,
                     keys[i:i + pk], vals[i:i + pk], msn)
                )
                state._pending_rows_bound += 2
            return
        row = (OP_ANNOTATE, op.start, op.end, seq, ref, cid, 0, 0,
               keys, vals, msn)
    else:
        raise TypeError(f"unknown op {op!r}")
    state._encoded.append(row)
    state._pending_rows_bound += 2


def encoded_columns(rows: List[tuple], size: int,
                    max_prop_pairs: int) -> List[np.ndarray]:
    """Encoded rows (`encode_op`'s tuples) as the ten int32 op columns
    of an `OpBatch`, in its field order, NOOP-padded to `size` entries:
    eight ``[size]`` columns, then prop keys and values ``[size,
    max_prop_pairs]`` (``NO_KEY`` / ``PROP_ABSENT`` padding)."""
    n = len(rows)
    cols = []
    for j, fill in enumerate((OP_NOOP, 0, 0, 0, 0, NO_CLIENT, 0, 0)):
        a = np.full(size, fill, np.int32)
        a[:n] = [r[j] for r in rows]
        cols.append(a)
    keys = np.full((size, max_prop_pairs), NO_KEY, np.int32)
    vals = np.full((size, max_prop_pairs), PROP_ABSENT, np.int32)
    for i, r in enumerate(rows):
        keys[i, : len(r[8])] = r[8]
        vals[i, : len(r[9])] = r[9]
    return cols + [keys, vals]
