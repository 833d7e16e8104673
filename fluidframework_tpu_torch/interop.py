"""Carry state between the JAX package and the port, as numpy arrays.

The port imports nothing of the JAX package, so state crosses as
plain numpy: a dict of the JAX `OverlayTable` / `SegmentTable` /
`OpBatch` fields (or any object with those attributes, e.g.
``table._asdict()`` or the NamedTuple itself), any object with the
`ColumnarStream` fields, and the deli's `SequencerState`. With these a
table (or a sequencer state) that the JAX engine produced mid-replay
can be continued by the port, and the other way round. Every
converter keeps a leading ``[D]`` axis: a stacked JAX `SegmentTable` /
`OpBatch` (the docs form's inputs, ``jax.tree_util.tree_map(np.stack,
...)``) comes across as the port's stacked table or batch, and back.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .ops.mergetree_kernel import OpBatch, SegmentTable
from .ops.overlay import OverlayTable
from .ops.sequencer_kernel import SequencerState
from .testing.synthetic import ColumnarStream
from .utils.devices import DeviceLike, resolve_device

Fields = Union[Mapping[str, Any], Any]


def _get(src: Fields, name: str) -> np.ndarray:
    v = src[name] if isinstance(src, Mapping) else getattr(src, name)
    return np.asarray(v)


def _tensors(cls, src: Fields, device: DeviceLike):
    dev = resolve_device(device)
    return cls(**{
        f.name: torch.from_numpy(
            np.array(_get(src, f.name), dtype=np.int32)).to(dev)
        for f in fields(cls)
    })


def table_from_numpy(src: Fields, device: DeviceLike = None) -> OverlayTable:
    """The port's `OverlayTable` from the JAX table's fields (numpy
    arrays or anything `np.asarray` takes), on `device`."""
    return _tensors(OverlayTable, src, device)


def table_to_numpy(table: OverlayTable) -> Dict[str, np.ndarray]:
    """The table's fields as int32 numpy arrays, keyed like the JAX
    `OverlayTable` (``jax OverlayTable(**d)`` rebuilds it there)."""
    return {
        f.name: getattr(table, f.name).cpu().numpy()
        for f in fields(OverlayTable)
    }


def segment_table_from_numpy(src: Fields,
                             device: DeviceLike = None) -> SegmentTable:
    """The port's row-model `SegmentTable` from the JAX table's fields,
    on `device`."""
    return _tensors(SegmentTable, src, device)


def segment_table_to_numpy(table: SegmentTable) -> Dict[str, np.ndarray]:
    """The table's fields as int32 numpy arrays, keyed like the JAX
    `SegmentTable` (``jax SegmentTable(**d)`` rebuilds it there)."""
    return {
        f.name: getattr(table, f.name).cpu().numpy()
        for f in fields(SegmentTable)
    }


def opbatch_from_numpy(src: Fields, device: DeviceLike = None) -> OpBatch:
    """The port's `OpBatch` from the JAX batch's fields."""
    return _tensors(OpBatch, src, device)


def opbatch_to_numpy(ops: OpBatch) -> Dict[str, np.ndarray]:
    """The batch's fields as int32 numpy arrays, keyed like the JAX
    `OpBatch` (``jax OpBatch(**d)`` rebuilds it there)."""
    return {f.name: getattr(ops, f.name).cpu().numpy()
            for f in fields(OpBatch)}


def stream_from_numpy(src: Fields) -> ColumnarStream:
    """The port's `ColumnarStream` (host numpy arrays) from the JAX
    package's stream, or any object with the same fields."""
    return ColumnarStream(**{
        f.name: np.array(_get(src, f.name), dtype=np.int32)
        for f in fields(ColumnarStream)
    })


def sequencer_state_from_numpy(src: Fields,
                               device: DeviceLike = None) -> SequencerState:
    """The port's `SequencerState` from the JAX state's fields (numpy
    arrays or anything `np.asarray` takes), on `device`: ``connected``
    as bool, the rest int32."""
    dev = resolve_device(device)
    return SequencerState(**{
        name: torch.from_numpy(np.array(
            _get(src, name),
            dtype=bool if name == "connected" else np.int32)).to(dev)
        for name in SequencerState._fields
    })


def sequencer_state_to_numpy(state: SequencerState) -> Dict[str, np.ndarray]:
    """The state's fields as numpy arrays (``connected`` bool, the rest
    int32), keyed like the JAX `SequencerState` (``jax
    SequencerState(**d)`` rebuilds it there)."""
    return {name: getattr(state, name).cpu().numpy()
            for name in SequencerState._fields}
