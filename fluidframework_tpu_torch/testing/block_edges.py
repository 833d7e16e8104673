"""Chunks that put the row-model kernel's work on its blocks' edges.

The CUDA kernel (``csrc/mergetree_chunk.cu``) spreads the table over a
grid whose block b owns rows ``[b*R, (b+1)*R)``. These chunks put a
split row, a landing row or the start of a shift exactly on such an
edge, land at row 0, and fill the table to ``C - 1`` and ``C`` rows, so
that the kernel is held to its plain version where a cross-block
hand-off can go wrong. Each case is a table and a chunk of ops as dicts
of int32 numpy arrays (the `SegmentTable` / `OpBatch` fields), so the
CPU tests can give them to the JAX package too. Every table row holds
2 characters, so row i starts at visible position 2*i.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops.mergetree_kernel import (
    NO_CLIENT,
    NO_KEY,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_NOOP,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
)

ROW_LEN = 2
OP_FIELDS = ("op_type", "pos1", "pos2", "seq", "ref_seq", "client",
             "buf_start", "ins_len")


def edge_table(capacity: int, KR: int, KK: int, n: int) -> Dict[str, np.ndarray]:
    """n live rows of ROW_LEN characters, inserted at seqs 1..n by
    clients 0..2; the rest of the capacity empty."""
    C = capacity
    rows = np.arange(C)
    live = rows < n
    return dict(
        n_rows=np.int32(n),
        buf_start=np.where(live, rows * ROW_LEN, 0).astype(np.int32),
        length=np.where(live, ROW_LEN, 0).astype(np.int32),
        ins_seq=np.where(live, rows + 1, 0).astype(np.int32),
        ins_client=np.where(live, rows % 3, NO_CLIENT).astype(np.int32),
        rem_seq=np.full(C, NOT_REMOVED, np.int32),
        rem_clients=np.full((C, KR), NO_CLIENT, np.int32),
        props=np.full((C, KK), PROP_ABSENT, np.int32),
        error=np.int32(0),
    )


def edge_ops(specs, seq0: int, B: int, PK: int) -> Dict[str, np.ndarray]:
    """A chunk of B ops from (type, pos1, pos2, client, ref_seq,
    [(key, val), ...]) tuples at seqs seq0, seq0+1, ...; the rest
    NOOP."""
    d = {f: np.zeros(B, np.int32) for f in OP_FIELDS}
    d["op_type"][:] = OP_NOOP
    d["client"][:] = NO_CLIENT
    d["prop_keys"] = np.full((B, PK), NO_KEY, np.int32)
    d["prop_vals"] = np.full((B, PK), PROP_ABSENT, np.int32)
    for i, (typ, p1, p2, cl, ref, props) in enumerate(specs):
        d["op_type"][i] = typ
        d["pos1"][i], d["pos2"][i] = p1, p2
        d["seq"][i] = seq0 + i
        d["ref_seq"][i] = ref
        d["client"][i] = cl
        d["buf_start"][i] = 1_000_000 + 5 * i
        d["ins_len"][i] = 3 if typ == OP_INSERT else 0
        for p, (k, v) in enumerate(props[:PK]):
            d["prop_keys"][i, p], d["prop_vals"][i, p] = k, v
    return d


def block_edge_chunks(R: int, capacity: int, KR: int, KK: int, PK: int,
                      B: int) -> List[dict]:
    """The block-edge cases for blocks of R rows: a list of dicts with
    ``name``, ``table``, ``ops`` and ``pallas_drops`` (True where the
    Pallas kernel drops a full-table end insert without the
    ERR_CAPACITY flag that the port raises). Needs capacity >= 4*R."""
    C = capacity
    if C < 4 * R or R < 4:
        raise ValueError("block_edge_chunks needs capacity >= 4*R, R >= 4")
    n0 = min(3 * R + 5, C - 8)
    L = ROW_LEN
    cases = []

    def add(name, n, specs, drops=False):
        s = n + 1  # the first op's seq: every row is older
        specs = [(t, p1, p2, cl, s + ref, pr)
                 for t, p1, p2, cl, ref, pr in specs]
        cases.append(dict(name=name, table=edge_table(C, KR, KK, n),
                          ops=edge_ops(specs, s, B, PK), pallas_drops=drops))

    # ref offsets are relative to the first op's seq: -1 sees only the
    # table, 0 sees the chunk's first op, and so on.
    add("split_at_R-1", n0, [
        # pos1 inside row R-1: its tail opens row R, the next block's
        # first row; pos2 then splits the old row R, now at R+1.
        (OP_REMOVE, L * (R - 1) + 1, L * R + 1, 4, -1, []),
        (OP_ANNOTATE, L * R - 3, L * R + 2, 5, 0, [(0, 7)]),
        (OP_INSERT, L * R - 1, 0, 6, 1, [(1, 2)]),
    ])
    add("split_at_R", n0, [
        (OP_ANNOTATE, L * R + 1, L * R + 3, 4, -1, [(1, 3)]),
        (OP_INSERT, L * R + 1, 0, 5, 0, []),
        (OP_REMOVE, L * R, L * R + 4, 6, -1, []),
    ])
    add("land_at_R", n0, [
        # Lands on row R, the first row of block 1; the second insert
        # did not see the first and lands before it (the tie-break).
        (OP_INSERT, L * R, 0, 4, -1, [(2, 9)]),
        (OP_INSERT, L * R, 0, 5, -1, []),
        (OP_REMOVE, L * R - 1, L * R + 5, 6, 1, []),
    ])
    add("land_at_end_2R", 2 * R, [
        # n = 2R: the end insert lands on row n, block 2's first row.
        (OP_INSERT, L * 2 * R, 0, 4, -1, []),
        (OP_INSERT, L * 2 * R, 0, 5, -1, [(0, PROP_DELETE)]),
        (OP_INSERT, L * 2 * R + 3, 0, 6, 1, []),
    ])
    add("shift_from_2R", n0, [
        # Lands on row 2R-1: the shift starts at row 2R, block 2's first.
        (OP_INSERT, L * (2 * R - 1), 0, 4, -1, []),
        # A split at row 2R-1 (the inserted row): its tail opens row 2R.
        (OP_ANNOTATE, L * (2 * R - 1) + 1, L * (2 * R + 2), 4, 0, [(0, 1)]),
    ])
    add("removed_at_edge", n0, [
        # Rows R-2..R removed; a client that did not see the removal
        # still sees them, one that did skips them.
        (OP_REMOVE, L * (R - 2), L * (R + 1), 4, -1, []),
        (OP_INSERT, L * (R - 2), 0, 5, -1, []),
        (OP_INSERT, L * (R - 2), 0, 6, 1, []),
        (OP_REMOVE, L * (R - 2) - 1, L * (R - 2) + 2, 7, -1, []),
    ])
    add("insert_at_row0", n0, [
        (OP_INSERT, 0, 0, 4, -1, [(0, 5)]),
        (OP_INSERT, 0, 0, 5, -1, []),  # concurrent: lands before it
        (OP_REMOVE, 1, 4, 4, 1, []),
    ])
    add("n_C-1", C - 1, [
        # The first insert fills the table; a later split pushes the
        # live row C-1 off the end (ERR_CAPACITY).
        (OP_INSERT, L * R, 0, 4, -1, []),
        (OP_REMOVE, L * (R - 1) + 1, L * R + 1, 5, -1, []),
    ])
    add("n_C_middle", C, [
        (OP_INSERT, L * (2 * R), 0, 4, -1, []),
        (OP_ANNOTATE, L * (R - 1) + 1, L * (C // 2) + 1, 5, -1, [(1, 4)]),
        # pos1 inside the last row: no tail row, no flag.
        (OP_REMOVE, L * (C - 1) + 1, L * C, 6, -1, []),
    ])
    add("n_C_end_insert", C, [
        (OP_INSERT, L * C, 0, 4, -1, []),
    ], drops=True)
    return cases
