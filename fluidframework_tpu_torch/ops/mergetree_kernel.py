"""Merge-tree op encoding and the row-model segment table.

The constants, `raise_kernel_errors`, the op batch and segment table
layouts, `make_table`, `grow_table` and `verify_table_invariants` are
copied from fluidframework_tpu/ops/mergetree_kernel.py (lines 58-147
and 412-437); `OpBatch` and `SegmentTable` are dataclasses of int32
tensors in place of the JAX NamedTuples. The row-model scan
(`_apply_one`, `apply_op_batch` and its docs form) is not ported; the
chunk kernel that replaces it on the replay path is
`ops/mergetree_chunk.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..protocol.constants import INT32_MAX, NO_CLIENT
from ..utils.devices import DeviceLike, resolve_device

# Sentinels (int32 table encoding).
NOT_REMOVED = INT32_MAX  # rem_seq value for live segments
PROP_ABSENT = -1  # props cell: key not set on this segment
PROP_DELETE = -2  # op value: delete the key (reference: null prop value)
NO_KEY = -1  # op key slot unused

# Op type codes (match protocol.mergetree_ops.MergeTreeDeltaType).
OP_INSERT = 0
OP_REMOVE = 1
OP_ANNOTATE = 2
OP_NOOP = 3

# Error bit flags accumulated in a table's error word.
ERR_CAPACITY = 1  # table overflow
ERR_BAD_POS = 2  # op position beyond visible length
ERR_REMOVERS = 4  # more concurrent removers than KR slots


@dataclass
class OpBatch:
    """A chunk of sequenced ops in ascending sequence-number order."""

    op_type: torch.Tensor  # int32[B]
    pos1: torch.Tensor  # int32[B] insert pos / range start
    pos2: torch.Tensor  # int32[B] range end (exclusive)
    seq: torch.Tensor  # int32[B]
    ref_seq: torch.Tensor  # int32[B]
    client: torch.Tensor  # int32[B]
    buf_start: torch.Tensor  # int32[B] arena offset of inserted text
    ins_len: torch.Tensor  # int32[B]
    prop_keys: torch.Tensor  # int32[B, PK] (NO_KEY padding)
    prop_vals: torch.Tensor  # int32[B, PK]

    def slice(self, lo: int, hi: int) -> "OpBatch":
        """Ops [lo, hi) as views (no copy, no device sync)."""
        return OpBatch(*(getattr(self, f.name)[lo:hi] for f in fields(self)))

    def to(self, device) -> "OpBatch":
        return OpBatch(
            *(getattr(self, f.name).to(device) for f in fields(self))
        )


@dataclass
class SegmentTable:
    """SoA segment table for one document replica (rows in doc order;
    rows ``[0, n_rows)`` are live)."""

    n_rows: torch.Tensor  # int32 scalar
    buf_start: torch.Tensor  # int32[C] offset into the text arenas
    length: torch.Tensor  # int32[C]
    ins_seq: torch.Tensor  # int32[C] (UNIVERSAL_SEQ=0 for loaded content)
    ins_client: torch.Tensor  # int32[C]
    rem_seq: torch.Tensor  # int32[C] (NOT_REMOVED if live)
    rem_clients: torch.Tensor  # int32[C, KR] (NO_CLIENT padding)
    props: torch.Tensor  # int32[C, KK] (PROP_ABSENT default)
    error: torch.Tensor  # int32 scalar, ERR_* bit flags

    def to(self, device) -> "SegmentTable":
        return SegmentTable(
            *(getattr(self, f.name).to(device) for f in fields(self))
        )


def make_table(capacity: int, n_removers: int, n_prop_keys: int,
               device: DeviceLike = None) -> SegmentTable:
    """An empty table with static shapes (C, KR, KK)."""
    dev = resolve_device(device)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    return SegmentTable(
        n_rows=full((), 0),
        buf_start=full((capacity,), 0),
        length=full((capacity,), 0),
        ins_seq=full((capacity,), 0),
        ins_client=full((capacity,), NO_CLIENT),
        rem_seq=full((capacity,), NOT_REMOVED),
        rem_clients=full((capacity, n_removers), NO_CLIENT),
        props=full((capacity, n_prop_keys), PROP_ABSENT),
        error=full((), 0),
    )


def grow_table(table: SegmentTable, old_cap: int, new_cap: int) -> SegmentTable:
    """Pad a table to a larger capacity with the empty-row fills."""
    pad = new_cap - old_cap

    def pad1(a, fill):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    return SegmentTable(
        n_rows=table.n_rows,
        buf_start=pad1(table.buf_start, 0),
        length=pad1(table.length, 0),
        ins_seq=pad1(table.ins_seq, 0),
        ins_client=pad1(table.ins_client, NO_CLIENT),
        rem_seq=pad1(table.rem_seq, NOT_REMOVED),
        rem_clients=pad1(table.rem_clients, NO_CLIENT),
        props=pad1(table.props, PROP_ABSENT),
        error=table.error,
    )


def raise_kernel_errors(error: int) -> None:
    """Raise if any ERR_* bit is set in an error-flag word."""
    problems = []
    if error & ERR_CAPACITY:
        problems.append("segment table capacity overflow")
    if error & ERR_BAD_POS:
        problems.append("op position beyond visible length")
    if error & ERR_REMOVERS:
        problems.append("removing-client slots exhausted")
    if problems:
        raise RuntimeError("kernel error: " + "; ".join(problems))


def verify_table_invariants(host_table: dict, capacity: int) -> None:
    """Exhaustive host-side verification of an unpacked segment table
    (a dict of numpy arrays): raises AssertionError on violations."""
    n = host_table["n_rows"]
    assert 0 <= n <= capacity, f"n_rows {n} out of range"
    length = host_table["length"][:n]
    rem_seq = host_table["rem_seq"][:n]
    rem_clients = host_table["rem_clients"][:n]
    ins_seq = host_table["ins_seq"][:n]
    assert (length > 0).all(), "zero/negative-length live row"
    removed = rem_seq != NOT_REMOVED
    has_removers = (rem_clients != NO_CLIENT).any(axis=1)
    assert (removed == has_removers).all(), "removal/remover mismatch"
    # Remover slots fill left-to-right (first-free-slot append).
    free = rem_clients == NO_CLIENT
    first_free = np.argmax(free, axis=1)
    for k in range(rem_clients.shape[1]):
        after_free = free.any(axis=1) & (k > first_free)
        bad = after_free & (rem_clients[:, k] != NO_CLIENT)
        assert not bad.any(), "remover slot gap"
    assert (rem_seq[removed] >= ins_seq[removed]).all(), (
        "removed before inserted"
    )
