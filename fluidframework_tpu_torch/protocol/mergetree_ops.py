"""Merge-tree (sequence CRDT) op schema.

Copied from fluidframework_tpu/protocol/mergetree_ops.py, whole:
`MergeTreeDeltaType`, the op dataclasses `InsertOp`, `RemoveOp`,
`AnnotateOp` and `GroupOp`, and their JSON wire form (`op_to_json`,
`op_from_json`). The op vocabulary mirrors reference
packages/dds/merge-tree/src/ops.ts:43 (INSERT / REMOVE / ANNOTATE /
GROUP); the host op encoder (`core.kernel_replica.encode_op`) lowers
these ops into the kernels' int32 columns.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Union


class MergeTreeDeltaType(enum.IntEnum):
    # Values match reference ops.ts:43 so recorded streams replay as-is.
    INSERT = 0
    REMOVE = 1
    ANNOTATE = 2
    GROUP = 3


@dataclass
class InsertOp:
    pos: int
    text: str = ""
    # Marker/atomic-segment payload (non-text DDSes reuse the sequence
    # kernel with opaque items, e.g. SharedMatrix permutation vectors).
    seg: Any = None
    props: Optional[dict] = None
    type: MergeTreeDeltaType = field(default=MergeTreeDeltaType.INSERT, init=False)


@dataclass
class RemoveOp:
    start: int
    end: int
    type: MergeTreeDeltaType = field(default=MergeTreeDeltaType.REMOVE, init=False)


@dataclass
class AnnotateOp:
    start: int
    end: int
    props: dict = field(default_factory=dict)
    type: MergeTreeDeltaType = field(default=MergeTreeDeltaType.ANNOTATE, init=False)


@dataclass
class GroupOp:
    ops: list = field(default_factory=list)
    type: MergeTreeDeltaType = field(default=MergeTreeDeltaType.GROUP, init=False)


MergeTreeOp = Union[InsertOp, RemoveOp, AnnotateOp, GroupOp]


def op_to_json(op: MergeTreeOp) -> dict:
    """Encode an op in a reference-compatible JSON shape.

    Reference wire shape: {type, pos1, pos2?, seg?, props?} (ops.ts
    IMergeTreeInsertMsg / IMergeTreeRemoveMsg / IMergeTreeAnnotateMsg).
    """
    if isinstance(op, InsertOp):
        out = {"type": int(MergeTreeDeltaType.INSERT), "pos1": op.pos}
        if op.seg is not None:
            out["seg"] = op.seg
        else:
            out["seg"] = op.text
        if op.props:
            out["props"] = op.props
        return out
    if isinstance(op, RemoveOp):
        return {"type": int(MergeTreeDeltaType.REMOVE), "pos1": op.start, "pos2": op.end}
    if isinstance(op, AnnotateOp):
        return {
            "type": int(MergeTreeDeltaType.ANNOTATE),
            "pos1": op.start,
            "pos2": op.end,
            "props": op.props,
        }
    if isinstance(op, GroupOp):
        return {"type": int(MergeTreeDeltaType.GROUP), "ops": [op_to_json(o) for o in op.ops]}
    raise TypeError(f"unknown op {op!r}")


def op_from_json(data: dict) -> MergeTreeOp:
    t = data["type"]
    if t == MergeTreeDeltaType.INSERT:
        seg = data.get("seg")
        if isinstance(seg, str):
            return InsertOp(pos=data["pos1"], text=seg, props=data.get("props"))
        return InsertOp(pos=data["pos1"], seg=seg, props=data.get("props"))
    if t == MergeTreeDeltaType.REMOVE:
        return RemoveOp(start=data["pos1"], end=data["pos2"])
    if t == MergeTreeDeltaType.ANNOTATE:
        return AnnotateOp(start=data["pos1"], end=data["pos2"], props=data["props"])
    if t == MergeTreeDeltaType.GROUP:
        return GroupOp(ops=[op_from_json(o) for o in data["ops"]])
    raise ValueError(f"unknown op type {t}")
