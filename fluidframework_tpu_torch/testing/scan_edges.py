"""Edge chunks for the row-model scan (`ops/mergetree_kernel._apply_one`).

Each case is a table and a chunk of ops as dicts of int32 numpy arrays
(the `SegmentTable` / `OpBatch` fields, tables from
`block_edges.edge_table`: row i holds 2 characters at visible position
2*i), so the CPU tests can give the same inputs to the JAX package and
the card's tests and smoke to the CUDA kernel. The cases are where the
scan's semantics are easy to get wrong:

- full tables: an insert at the document's end, a split of the last row
  (its tail falls off), an insert and a range split that push the top
  row off, and a table already past its capacity (``n_rows > C``) that
  a NOOP chunk flags;
- positions past the document (``ERR_BAD_POS`` for an insert and a
  range op);
- a row removed by more clients than it has remover slots
  (``ERR_REMOVERS``);
- repeated, negative and out-of-range prop keys on an insert and on an
  annotate, and ``PROP_DELETE``;
- all-NOOP padding, a chunk of one op, inserts into an empty table and
  the insert tie-break on rows of zero visibility.

Then the cases of the kernel's one pass an op (a split and the rows
that open decided before any row moves):

- an insert strictly inside a row (its split and its landing in one
  row); a remove and an annotate with pos1 and pos2 in one row, in
  adjacent rows, and with pos2 below pos1; a range op across rows of
  zero visibility and tombstones; inserts at 0 and at the visible total;
- tables of C - 3, C - 2 and C - 1 rows, whose first ops take the one
  pass and whose later ones the step-by-step branch of a table that can
  overflow;
- 31, 32, 33, 255, 256 and 257 live rows (where the capacity holds
  them), and a chunk that grows its table across row 256 (row 32 below
  C 512), the first row of a warp's second segment.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..ops.mergetree_kernel import (
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    PROP_DELETE,
)
from .block_edges import ROW_LEN, edge_ops, edge_table

LIVE_ROWS = (31, 32, 33, 255, 256, 257)
# `random_chunk` cases of B 128 for each op loop of the kernel, which a
# block takes from the rows its chunk can reach, min(C, n + 2B):
# (capacity, live rows n, (rows a thread, warps) that the block reports).
OP_LOOP_CASES = (
    (2048, 200, (1, 15)),    # 456 reachable rows: one a thread
    (2048, 700, (2, 15)),    # 956: two a thread
    (2048, 1500, (4, 14)),   # 1756: the swept loop, two steps of 2
    (4096, 2200, (6, 13)),   # 2456: swept, three steps
    (4096, 3500, (8, 15)),   # 3756: swept, four steps
    (16384, 1500, (4, 14)),  # hot columns in global memory: swept
)


def long_rows_table(capacity: int, KR: int, KK: int, n: int,
                    row_len: int) -> dict:
    """`edge_table` with rows of `row_len` characters: row i holds
    visible positions [row_len*i, row_len*(i + 1))."""
    t = edge_table(capacity, KR, KK, n)
    live = np.arange(capacity) < n
    t["buf_start"] = np.where(live, np.arange(capacity) * row_len,
                              0).astype(np.int32)
    t["length"] = np.where(live, row_len, 0).astype(np.int32)
    return t


def scan_edge_chunks(capacity: int, KR: int, KK: int, PK: int,
                     B: int) -> List[dict]:
    """The scan's edge cases at one geometry: a list of dicts with
    ``label``, ``table`` and ``ops`` (every chunk B ops but the one-op
    chunk). Needs capacity >= 64, KR >= 1, KK >= 4, PK >= 4 and
    B >= max(KR + 2, 12)."""
    C = capacity
    end = ROW_LEN * C
    K = KK
    cases = []

    def add(label, n, specs, seq0=None, chunk=B, table=None):
        # A ref_seq of None sees every earlier op of the chunk.
        t = edge_table(C, KR, KK, n) if table is None else table
        s0 = seq0 or C + 10
        specs = [(ty, p1, p2, cl, s0 + j - 1 if r is None else r, pr)
                 for j, (ty, p1, p2, cl, r, pr) in enumerate(specs)]
        cases.append(dict(label=label, table=t,
                          ops=edge_ops(specs, s0, chunk, PK)))

    ref = C + 5  # every row of an edge table is seen
    add("full table: insert at the end", C,
        [(OP_INSERT, end, 0, 1, ref, [])])
    add("full table: split of the last row", C,
        [(OP_INSERT, end - 1, 0, 2, ref, [])])
    add("full table: insert at row 1 pushes the top row off", C,
        [(OP_INSERT, ROW_LEN, 0, 1, ref, [])])
    add("full table: remove splitting two rows", C,
        [(OP_REMOVE, 3, 7, 1, ref, [])])
    over = edge_table(C, KR, KK, C)
    over["n_rows"] = np.int32(C + 3)
    add("n_rows past the capacity, error 0: NOOP chunk", C, [],
        table=over)
    add("positions past the document", 10,
        [(OP_INSERT, 100, 0, 1, ref, []),
         (OP_REMOVE, 5, 100, 2, ref, []),
         (OP_ANNOTATE, 100, 105, 1, ref, [(0, 3)])])
    # Row 2 (positions 4..5) removed by KR + 1 clients that do not see
    # each other's removes (their ref_seq is below every remove's seq).
    add("a remover row with no free slot", 10,
        [(OP_REMOVE, 4, 6, c, ref, []) for c in range(1, KR + 2)])
    add("repeated, negative and out-of-range keys on inserts", 4,
        [(OP_INSERT, 2, 0, 1, ref, [(1, 5), (1, 6), (-1, 7), (3, 8)]),
         (OP_INSERT, 0, 0, 2, ref, [(2, 5), (-2, PROP_DELETE), (K + 1, 7),
                                    (2, 9)]),
         (OP_INSERT, 4, 0, 1, ref, [(-3, 1), (-K - 1, 2), (K - 1, 3),
                                    (0, 4)]),
         (OP_INSERT, 6, 0, 2, ref, [(0, 1), (0, 2), (0, 3), (0, 4)])])
    add("repeated, negative and out-of-range keys on annotates", 6,
        [(OP_ANNOTATE, 1, 9, 1, ref, [(1, 5), (1, 6), (-2, 7), (K, 8)]),
         (OP_ANNOTATE, 0, 4, 2, ref, [(2, 3), (K + 3, 1), (2, 4), (-1, 9)]),
         (OP_ANNOTATE, 3, 12, 1, ref, [(1, PROP_DELETE), (0, 2), (0, 1),
                                       (3, 3)])])
    add("PROP_DELETE on an insert and an annotate", 4,
        [(OP_ANNOTATE, 0, 8, 1, ref, [(0, 4), (1, 5)]),
         (OP_ANNOTATE, 2, 6, 2, ref, [(0, PROP_DELETE)]),
         (OP_INSERT, 3, 0, 1, ref, [(1, PROP_DELETE), (2, 6)]),
         (OP_ANNOTATE, 0, 8, 2, ref, [(1, PROP_DELETE), (2, PROP_DELETE)])])
    add("all-NOOP padding", 12, [])
    add("a chunk of one op", 12, [(OP_REMOVE, 5, 9, 1, ref, [])], chunk=1)
    add("inserts into an empty table", 0,
        [(OP_INSERT, 0, 0, 1, 0, []),
         (OP_INSERT, 0, 0, 2, 0, [(0, 1)]),
         (OP_INSERT, 3, 0, 1, C + 11, []),
         (OP_INSERT, 50, 0, 2, C + 11, [])])
    # Rows inserted after a client's ref_seq by another client have no
    # visibility for it; an insert at their position lands before them
    # only when its seq is above theirs (the tie-break).
    unseen = edge_table(C, KR, KK, 8)
    unseen["ins_seq"][:8] = np.arange(8, dtype=np.int32) * 3 + 20
    add("insert tie-break on rows of zero visibility", 8,
        [(OP_INSERT, 0, 0, 5, 10, []),
         (OP_INSERT, 0, 0, 6, 25, []),
         (OP_REMOVE, 0, 2, 5, 30, []),
         (OP_INSERT, 2, 0, 7, 26, [])],
        seq0=24, table=unseen)

    # ---- one pass an op (each op sees the chunk's earlier ones)
    add("an insert strictly inside a row", 12,
        [(OP_INSERT, 3, 0, 1, None, []),
         (OP_INSERT, 12, 0, 2, None, [(0, 4)])])
    six = long_rows_table(C, KR, KK, 8, 6)  # row i: [6i, 6i + 6)
    add("a remove and an annotate inside one row", 8,
        [(OP_ANNOTATE, 19, 22, 1, None, [(0, 5)]),
         (OP_REMOVE, 7, 10, 2, None, [])], table=six)
    add("a remove and an annotate across adjacent rows", 8,
        [(OP_ANNOTATE, 33, 39, 1, None, [(1, 6)]),
         (OP_REMOVE, 9, 15, 2, None, [])], table=six)
    add("range ops with pos2 below pos1", 8,
        [(OP_REMOVE, 10, 7, 1, None, []),
         (OP_ANNOTATE, 27, 21, 2, None, [(0, 3)])], table=six)
    # Rows 3-4 inserted by client 7 after the ops' ref_seq 50 (zero
    # visibility), rows 6-7 removed at seq 20 (tombstones); visible:
    # rows 0-2 at 0..5, row 5 at 6..7, rows 8-11 at 8..15.
    hidden = edge_table(C, KR, KK, 12)
    hidden["ins_seq"][3:5] = (100, 101)
    hidden["ins_client"][3:5] = 7
    hidden["rem_seq"][6:8] = 20
    hidden["rem_clients"][6:8, 0] = 2
    add("a range op across rows of zero visibility and tombstones", 12,
        [(OP_REMOVE, 3, 9, 1, 50, []),
         (OP_ANNOTATE, 1, 11, 2, 50, [(0, 2)]),
         (OP_INSERT, 4, 0, 1, 50, [])],
        seq0=200, table=hidden)
    add("inserts at 0 and at the visible total", 10,
        [(OP_INSERT, 0, 0, 1, None, []),
         (OP_INSERT, 23, 0, 2, None, []),
         (OP_INSERT, 26, 0, 1, None, [(2, 2)])])
    for k in (3, 2, 1):
        n = C - k
        add(f"n = C - {k}: one pass, then step by step", n,
            [(OP_INSERT, 3, 0, 1, None, []),
             (OP_REMOVE, 5, 9, 2, None, []),
             (OP_ANNOTATE, 1, 12, 1, None, [(0, 1)]),
             (OP_INSERT, 2 * n - 1, 0, 2, None, []),
             (OP_INSERT, 0, 0, 1, None, [])])
    for n in LIVE_ROWS:
        if n + 16 > C:
            continue
        end = ROW_LEN * n
        add(f"{n} live rows", n,
            [(OP_INSERT, end - 1, 0, 1, None, []),
             (OP_REMOVE, end - 7, end + 1, 2, None, []),
             (OP_INSERT, ROW_LEN * (n // 2) + 1, 0, 1, None, [(1, 1)]),
             (OP_ANNOTATE, ROW_LEN * (n // 2) - 3, end - 2, 2, None,
              [(0, 7)]),
             (OP_INSERT, 0, 0, 2, None, [])])
    n0 = 250 if C >= 512 else 28
    end = ROW_LEN * n0
    add("a chunk that grows its table across a warp's rows", n0,
        [(OP_INSERT, end + 3 * j, 0, 1 + j % 2, None, []) for j in range(8)]
        + [(OP_INSERT, end - 3, 0, 1, None, []),
           (OP_REMOVE, end - 9, end + 4, 2, None, []),
           (OP_INSERT, end + 1, 0, 1, None, [(0, 2)]),
           (OP_ANNOTATE, end - 13, end + 13, 2, None, [(1, 3)])])
    return cases


def random_chunk(n: int, B: int, PK: int, seed: int) -> dict:
    """B inserts, removes and annotates at random positions of an
    `edge_table` of n rows (2n visible characters), each op seeing every
    earlier one, all within the document: ops as a dict of int32 numpy
    arrays (the kernel's op loops at a chosen number of live rows)."""
    rng = np.random.default_rng(seed)
    vis, specs = ROW_LEN * n, []
    for _ in range(B):
        typ = int(rng.integers(0, 3)) if vis > 8 else OP_INSERT
        cl = int(rng.integers(1, 5))
        if typ == OP_INSERT:
            specs.append((typ, int(rng.integers(0, vis + 1)), 0, cl, []))
            vis += 3  # `edge_ops` inserts 3 characters
            continue
        p1 = int(rng.integers(0, vis - 1))
        p2 = min(vis, p1 + int(rng.integers(1, 9)))
        props = [(int(rng.integers(0, 8)), int(rng.integers(0, 9)))]
        specs.append((typ, p1, p2, cl, props if typ == OP_ANNOTATE else []))
        if typ == OP_REMOVE:
            vis -= p2 - p1
    s0 = ROW_LEN * n + 10
    return edge_ops([(t, p1, p2, cl, s0 + j - 1, pr)
                     for j, (t, p1, p2, cl, pr) in enumerate(specs)],
                    s0, B, PK)
