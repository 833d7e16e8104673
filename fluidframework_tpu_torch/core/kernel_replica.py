"""The host op encoder: sequenced merge-tree ops to int32 op rows.

Copied from fluidframework_tpu/core/kernel_replica.py: `TextArena`
(:69), `PropInterner` (:91), `EncoderState` (:399) and `encode_op`
(:413). Host responsibilities, outside every kernel:

- text arena: inserted content is appended to a host-side arena and
  the kernels only move ``(buf_start, length)`` spans;
- dictionary encoding: property keys map to static columns and values
  to int ids (the columnar form of the reference's PropertySet JSON,
  packages/dds/merge-tree/src/properties.ts);
- one op becomes one row, or several: an insert or annotate with more
  than ``max_prop_pairs`` props splits into follow-up annotate rows at
  the same perspective, and a `GroupOp` encodes its ops in order;
  `encoded_columns` lays rows out as the kernels' op columns.

`KernelReplica` itself (the row-model replica) is not ported: it needs
the row-model scan.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..ops.mergetree_kernel import (
    NO_KEY,
    OP_ANNOTATE,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
)
from ..protocol.constants import NO_CLIENT
from ..protocol.mergetree_ops import (
    AnnotateOp,
    GroupOp,
    InsertOp,
    MergeTreeOp,
    RemoveOp,
)
from ..protocol.messages import SequencedMessage


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
    appended to ``state._encoded``. `state` is an EncoderState or an
    `overlay_fold.OverlayFoldReplica` (anything with arena/props/
    max_prop_pairs and the two accumulators). Prop lists wider than
    max_prop_pairs split into follow-up annotate rows at the same
    perspective."""
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
