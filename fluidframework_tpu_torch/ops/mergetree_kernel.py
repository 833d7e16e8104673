"""Merge-tree op encoding, the row-model segment table and its scan.

The constants, `raise_kernel_errors`, the op batch and segment table
layouts, `make_table`, `grow_table` and `verify_table_invariants` are
copied from fluidframework_tpu/ops/mergetree_kernel.py (lines 58-147
and 412-437); `OpBatch` and `SegmentTable` are dataclasses of int32
tensors in place of the JAX NamedTuples.

The row-model scan is that module's `_visibility` (:155), `_prefix`
(:176), `_shift_rows` (:188), `_write_row` (:224), `_op_props_row`
(:246), `_split_at` (:255) and `_apply_one` (:289), translated
literally into PyTorch on int32 tensors: every op runs the same masked
passes (split at pos1, split at pos2, the insert's landing, shift and
write, the covered-range update), with no data-dependent branch and no
host read. `apply_op_batch_ref` applies the ops of one chunk one after
another (the reference's `lax.scan`, :383) and
`apply_op_batch_docs_ref` does so for each document of tables and ops
with a leading ``[D]`` axis (the reference's vmapped form, :404-409).

`apply_op_batch` and `apply_op_batch_docs` dispatch by the table's
device: a CUDA table goes to the hand-written kernel
``csrc/mergetree_scan.cu`` (`ops/mergetree_scan.py`, one launch of D
blocks for a chunk of every document) or the call raises; a CPU table
goes to the plain version; any other device raises. Compare results on
``n_rows``, ``error`` and rows ``[:min(n_rows, C)]``: the rows above
are scratch (the plain version rolls the whole capacity, the kernel
moves only live rows), and ``n_rows`` may exceed C once
``ERR_CAPACITY`` is set, as in the reference.

The chunk kernel that replaces the Pallas kernel on the
`ColumnarReplica` path is `ops/mergetree_chunk.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List

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

    def doc(self, d: int) -> "OpBatch":
        """Entry `d` of every field's leading axis (views): document d
        of a stacked chunk, or op d of one chunk."""
        return OpBatch(*(getattr(self, f.name)[d] for f in fields(self)))


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

    def doc(self, d: int) -> "SegmentTable":
        """Document `d` of a stacked table (views)."""
        return SegmentTable(
            *(getattr(self, f.name)[d] for f in fields(self)))


def stack_segment_tables(tables: List[SegmentTable]) -> SegmentTable:
    """Documents' tables of one shape stacked on a leading ``[D]`` axis
    (the docs form of the scan)."""
    return SegmentTable(*(torch.stack([getattr(t, f.name) for t in tables])
                          for f in fields(SegmentTable)))


def stack_op_batches(batches: List[OpBatch]) -> OpBatch:
    """Documents' chunks of one shape stacked on a leading ``[D]`` axis."""
    return OpBatch(*(torch.stack([getattr(b, f.name) for b in batches])
                     for f in fields(OpBatch)))


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


# ----------------------------------------------------------------------
# The row-model scan, translated literally (reference :150-409).

I32 = torch.int32


def _flag(cond: torch.Tensor, bit: int) -> torch.Tensor:
    """An int32 error word holding `bit` where `cond` holds."""
    return cond.to(I32) * bit


def _visibility(table: SegmentTable, ref_seq, client):
    """Per-row (skip, vis_len) at perspective (ref_seq, client)
    (reference :155, mergeTree.ts:916 nodeLength)."""
    capacity = table.length.shape[0]
    live = torch.arange(capacity, dtype=I32,
                        device=table.length.device) < table.n_rows
    removed = table.rem_seq != NOT_REMOVED
    tomb = removed & (table.rem_seq <= ref_seq)
    ins_vis = (table.ins_client == client) | (table.ins_seq <= ref_seq)
    among_removers = (table.rem_clients == client).any(1)
    skip = (~live) | tomb | (removed & ~ins_vis)
    visible = (~skip) & ins_vis & ~(removed & among_removers)
    vis_len = torch.where(visible, table.length, 0)
    return skip, vis_len


def _prefix(vis_len: torch.Tensor) -> torch.Tensor:
    """Exclusive int32 prefix sum of visible lengths (reference :176)."""
    return torch.cumsum(vis_len, 0, dtype=I32) - vis_len


def _shift_rows(table: SegmentTable, at, shift) -> SegmentTable:
    """Open `shift` in {0, 1} rows at index `at` by rolling the suffix
    one row up (reference :188); `at >= capacity` or ``shift == 0`` is
    an identity. ``ERR_CAPACITY`` whenever ``n_rows + shift`` exceeds
    the capacity."""
    capacity = table.length.shape[0]
    j = torch.arange(capacity, dtype=I32, device=table.length.device)
    keep = (j < at) | (shift == 0)

    def g(a):
        moved = torch.roll(a, 1, 0)
        return torch.where(keep if a.dim() == 1 else keep[:, None], a, moved)

    return SegmentTable(
        n_rows=table.n_rows + shift,
        buf_start=g(table.buf_start), length=g(table.length),
        ins_seq=g(table.ins_seq), ins_client=g(table.ins_client),
        rem_seq=g(table.rem_seq), rem_clients=g(table.rem_clients),
        props=g(table.props),
        error=table.error | _flag(table.n_rows + shift > capacity,
                                  ERR_CAPACITY),
    )


def _write_row(table: SegmentTable, at, buf_start, length, ins_seq,
               ins_client, rem_seq, rem_clients_row,
               props_row) -> SegmentTable:
    """Overwrite row `at` with the given field values (reference :224);
    ``at >= capacity`` writes nothing."""
    capacity = table.length.shape[0]
    here = torch.arange(capacity, dtype=I32,
                        device=table.length.device) == at

    def w(a, v):
        if a.dim() == 1:
            return torch.where(here, v, a)
        return torch.where(here[:, None], v[None, :], a)

    return SegmentTable(
        n_rows=table.n_rows,
        buf_start=w(table.buf_start, buf_start),
        length=w(table.length, length),
        ins_seq=w(table.ins_seq, ins_seq),
        ins_client=w(table.ins_client, ins_client),
        rem_seq=w(table.rem_seq, rem_seq),
        rem_clients=w(table.rem_clients, rem_clients_row),
        props=w(table.props, props_row),
        error=table.error,
    )


def _op_props_row(op: OpBatch, n_prop_keys: int) -> torch.Tensor:
    """The props row of a newly inserted segment (reference :246):
    ``PROP_DELETE`` becomes ``PROP_ABSENT``, and the keys scatter as
    ``row.at[keys].set(vals, mode="drop")`` does on the JAX CPU backend:
    ``NO_KEY`` is dropped, any other negative key counts from the end
    once (``key + KK``), a key still outside ``[0, KK)`` is dropped, and
    of repeated keys the last slot wins."""
    dev = op.prop_keys.device
    cols = torch.arange(n_prop_keys, dtype=I32, device=dev)
    row = torch.full((n_prop_keys,), PROP_ABSENT, dtype=I32, device=dev)
    vals = torch.where(op.prop_vals == PROP_DELETE, PROP_ABSENT,
                       op.prop_vals)
    keys = torch.where(op.prop_keys == NO_KEY, n_prop_keys, op.prop_keys)
    keys = torch.where(keys < 0, keys + n_prop_keys, keys)
    for p in range(keys.shape[0]):
        row = torch.where(cols == keys[p], vals[p], row)
    return row


def _split_at(table: SegmentTable, pos, ref_seq, client,
              enable) -> SegmentTable:
    """Masked ensure-boundary (reference :255, mergeTree.ts:1706): if
    `enable` and visible position `pos` falls strictly inside a row,
    split that row; the tail inherits every field."""
    capacity = table.length.shape[0]
    dev = table.length.device
    skip, vis_len = _visibility(table, ref_seq, client)
    prefix = _prefix(vis_len)
    inside = (~skip) & (prefix < pos) & (prefix + vis_len > pos)
    found = inside.any() & enable
    idx = torch.argmax(inside.to(I32)).to(I32)  # garbage unless found
    off = pos - prefix[idx]
    cap = torch.tensor(capacity, dtype=I32, device=dev)
    at = torch.where(found, idx + 1, cap)
    head = (table.buf_start[idx], table.length[idx], table.ins_seq[idx],
            table.ins_client[idx], table.rem_seq[idx],
            table.rem_clients[idx], table.props[idx])
    t = _shift_rows(table, at, found.to(I32))
    t = _write_row(t, at, head[0] + off, head[1] - off, head[2], head[3],
                   head[4], head[5], head[6])
    head_at = torch.where(found, idx, cap)
    j = torch.arange(capacity, dtype=I32, device=dev)
    t.length = torch.where(j == head_at, off, t.length)
    return t


def _apply_one(table: SegmentTable, op: OpBatch) -> SegmentTable:
    """Apply one sequenced op of any type as straight-line masked code
    (reference :289): splits at pos1 and pos2, the insert's landing
    (first non-skip row at or after pos1 that is visible or loses the
    tie-break ``op.seq > ins_seq``), shift and write, then the covered
    range's remove (earliest rem_seq kept, the client in the first free
    slot, ``ERR_REMOVERS`` when none is free) or annotate (last writer
    wins, ``PROP_DELETE`` clears)."""
    capacity = table.length.shape[0]
    dev = table.length.device
    n_removers = table.rem_clients.shape[1]
    n_prop_keys = table.props.shape[1]
    is_ins = op.op_type == OP_INSERT
    is_rem = op.op_type == OP_REMOVE
    is_ann = op.op_type == OP_ANNOTATE
    is_range = is_rem | is_ann

    t = _split_at(table, op.pos1, op.ref_seq, op.client, is_ins | is_range)
    t = _split_at(t, op.pos2, op.ref_seq, op.client, is_range)

    skip, vis_len = _visibility(t, op.ref_seq, op.client)
    prefix = _prefix(vis_len)
    total = vis_len.sum(dtype=I32)
    land = ((~skip) & (prefix >= op.pos1)
            & ((vis_len > 0) | (op.seq > t.ins_seq)))
    land_found = land.any()
    insert_at = torch.where(land_found,
                            torch.argmax(land.to(I32)).to(I32), t.n_rows)
    at = torch.where(is_ins, insert_at,
                     torch.tensor(capacity, dtype=I32, device=dev))
    t = _shift_rows(t, at, is_ins.to(I32))
    t = _write_row(
        t, at, op.buf_start, op.ins_len, op.seq, op.client,
        torch.tensor(NOT_REMOVED, dtype=I32, device=dev),
        torch.full((n_removers,), NO_CLIENT, dtype=I32, device=dev),
        _op_props_row(op, n_prop_keys),
    )
    bad = is_ins & (~land_found) & (op.pos1 > total)

    skip, vis_len = _visibility(t, op.ref_seq, op.client)
    prefix = _prefix(vis_len)
    covered = ((~skip) & (vis_len > 0) & (prefix >= op.pos1)
               & (prefix + vis_len <= op.pos2))
    bad = bad | (is_range & (op.pos2 > vis_len.sum(dtype=I32)))

    upd_rem = covered & is_rem
    already = t.rem_seq != NOT_REMOVED
    new_rem_seq = torch.where(upd_rem & ~already, op.seq, t.rem_seq)
    free = t.rem_clients == NO_CLIENT
    first_free = torch.argmax(free.to(I32), 1).to(I32)
    no_free = ~free.any(1)
    slot = torch.where(already, first_free, 0)
    write = upd_rem & ~(already & no_free)
    slot_onehot = (torch.arange(n_removers, dtype=I32, device=dev)[None, :]
                   == slot[:, None])
    new_rem_clients = torch.where(write[:, None] & slot_onehot, op.client,
                                  t.rem_clients)
    overflow = (upd_rem & already & no_free).any()

    upd_ann = covered & is_ann
    props = t.props
    cols = torch.arange(n_prop_keys, dtype=I32, device=dev)
    for p in range(op.prop_keys.shape[0]):
        key = op.prop_keys[p]
        val = op.prop_vals[p]
        valid = key != NO_KEY
        newv = torch.where(val == PROP_DELETE, PROP_ABSENT, val)
        props = torch.where(valid & upd_ann[:, None] & (cols == key)[None, :],
                            newv, props)

    return SegmentTable(
        n_rows=t.n_rows, buf_start=t.buf_start, length=t.length,
        ins_seq=t.ins_seq, ins_client=t.ins_client, rem_seq=new_rem_seq,
        rem_clients=new_rem_clients, props=props,
        error=t.error | _flag(bad, ERR_BAD_POS)
        | _flag(overflow, ERR_REMOVERS),
    )


def apply_op_batch_ref(table: SegmentTable, ops: OpBatch) -> SegmentTable:
    """Apply a chunk of sequenced ops in order, `_apply_one` after
    `_apply_one` (the reference's ``lax.scan``, :383): the plain
    version of ``csrc/mergetree_scan.cu``. Runs on the tensors' device
    with no host read; for the CPU tests and for holding the kernel
    to, not for speed."""
    for i in range(ops.op_type.shape[0]):
        table = _apply_one(table, ops.doc(i))
    return table


def apply_op_batch_docs_ref(tables: SegmentTable,
                            ops: OpBatch) -> SegmentTable:
    """The docs form (reference :404-409): tables and ops with a
    leading ``[D]`` axis, each document's chunk applied by
    `apply_op_batch_ref`, one document after another."""
    return stack_segment_tables([
        apply_op_batch_ref(tables.doc(d), ops.doc(d))
        for d in range(tables.n_rows.shape[0])])


def apply_op_batch(table: SegmentTable, ops: OpBatch) -> SegmentTable:
    """Apply a chunk of ops to one table: a CUDA table goes to the
    hand-written kernel (or the call raises), a CPU table to the plain
    version; no other device is taken."""
    kind = table.length.device.type
    if kind == "cuda":
        from .mergetree_scan import mergetree_scan_kernel

        return mergetree_scan_kernel(table, ops)
    if kind == "cpu":
        return apply_op_batch_ref(table, ops)
    raise ValueError(f"apply_op_batch: unsupported device {kind}")


def apply_op_batch_docs(tables: SegmentTable, ops: OpBatch) -> SegmentTable:
    """The docs form of `apply_op_batch`: on CUDA one kernel launch of D
    blocks for the chunk of every document, on the CPU the plain
    version document by document."""
    kind = tables.length.device.type
    if kind == "cuda":
        from .mergetree_scan import mergetree_scan_kernel

        return mergetree_scan_kernel.docs(tables, ops)
    if kind == "cpu":
        return apply_op_batch_docs_ref(tables, ops)
    raise ValueError(f"apply_op_batch_docs: unsupported device {kind}")
