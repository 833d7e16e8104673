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


def scan_edge_chunks(capacity: int, KR: int, KK: int, PK: int,
                     B: int) -> List[dict]:
    """The scan's edge cases at one geometry: a list of dicts with
    ``label``, ``table`` and ``ops`` (every chunk B ops but the one-op
    chunk). Needs capacity >= 64, KR >= 1, KK >= 4, PK >= 4 and
    B >= KR + 2."""
    C = capacity
    end = ROW_LEN * C
    K = KK
    cases = []

    def add(label, n, specs, seq0=None, chunk=B, table=None):
        t = edge_table(C, KR, KK, n) if table is None else table
        cases.append(dict(label=label, table=t,
                          ops=edge_ops(specs, seq0 or C + 10, chunk, PK)))

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
    return cases
