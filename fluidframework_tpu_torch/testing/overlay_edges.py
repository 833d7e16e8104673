"""Chunks that put the overlay kernel's shifts and slot heap on edges.

The CUDA kernel (``csrc/overlay_chunk.cu``) keeps each row's remover
slots and props in a heap behind a ``slot`` column: a shift moves the
slots, a split tail takes a fresh heap row copied from its split row, a
new row or gap row takes a fresh one, and the rows pushed off the top of
the window give theirs back. These chunks drive each of those paths to
its edge: split inserts at row 0, at row 1023 (the edge of the global
layout's first segment) and at the top of a nearly full window, a gap
loop of many steps and one that overflows the window mid-loop, split
halves whose removers and props then diverge, ops whose every prop
slot is filled (a key repeated, deletes among sets, keys out of range),
a removed row with every remover slot taken, and a chunk that creates
and drops more than a window of rows. Each case is a table and a chunk of ops as
dicts of int32 numpy arrays (the `OverlayTable` / `OpBatch` fields), so
the CPU tests can give them to the JAX package too.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.mergetree_kernel import (
    NO_CLIENT,
    NO_KEY,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
    OpBatch,
)
from .block_edges import edge_ops


def overlay_table(W: int, KR: int, KK: int, anchors: Sequence[int],
                  lengths: Sequence[int], settled_len: int) -> Dict[str, np.ndarray]:
    """Text rows (unsettled inserts, seqs 1..n by clients 0..2) at the
    given settled anchors and lengths; rows >= n as `make_overlay_table`
    leaves them."""
    n = len(anchors)
    j = np.arange(n)
    t = dict(
        n_rows=np.int32(n),
        anchor=np.zeros(W, np.int32),
        buf_start=np.zeros(W, np.int32),
        length=np.zeros(W, np.int32),
        ins_seq=np.zeros(W, np.int32),
        ins_client=np.full(W, NO_CLIENT, np.int32),
        rem_seq=np.full(W, NOT_REMOVED, np.int32),
        rem_clients=np.full((W, KR), NO_CLIENT, np.int32),
        props=np.full((W, KK), PROP_ABSENT, np.int32),
        settled_len=np.int32(settled_len),
        error=np.int32(0),
    )
    t["anchor"][:n] = anchors
    t["buf_start"][:n] = 10 * j
    t["length"][:n] = lengths
    t["ins_seq"][:n] = j + 1
    t["ins_client"][:n] = j % 3
    return t


def overlay_edge_chunks(W: int, KR: int, KK: int, PK: int, B: int,
                        seed: int = 7) -> List[dict]:
    """The edge cases for a window of W rows, KR remover slots (>= 2),
    KK prop keys (>= 3) and chunks of B ops (>= 48) with PK prop slots:
    a list of dicts with ``name``, ``table`` and ``ops``."""
    if W < 64 or KR < 2 or KK < 3 or PK < 1 or B < 48:
        raise ValueError("overlay_edge_chunks needs W >= 64, KR >= 2, "
                         "KK >= 3, PK >= 1, B >= 48")
    cases = []

    def add(name, table, specs):
        # The ops' seqs follow every table row's insert (seqs 1..n) and
        # a removal at n + 1. A ref k >= 0 sees the chunk's ops up to op
        # k; -1 sees the table and the removal (ref n + 1); -2 the table
        # only (ref n).
        seq0 = int(table["n_rows"]) + 10
        specs = [(t, p1, p2, cl, seq0 + ref if ref >= 0 else seq0 - 8 + ref,
                  pr) for t, p1, p2, cl, ref, pr in specs]
        cases.append(dict(name=name, table=table,
                          ops=edge_ops(specs, seq0, B, PK)))

    text = lambda n, ln: overlay_table(W, KR, KK, [0] * n, [ln] * n, 0)

    add("split_insert_row0", text(40, 2), [
        (OP_INSERT, 1, 0, 4, -1, [(0, 5)]),   # splits row 0: tail at row 2
        (OP_INSERT, 0, 0, 5, -1, []),         # lands at row 0: the shift from 1
        (OP_INSERT, 0, 0, 6, 1, [(1, 8)]),
        (OP_REMOVE, 1, 6, 4, 2, []),
        (OP_ANNOTATE, 0, 3, 5, 3, [(2, 1)]),
    ])
    add("split_insert_top", text(W - 2, 2), [
        # Inside row W-3: the new row at W-2, the tail at W-1 (full).
        (OP_INSERT, 2 * (W - 3) + 1, 0, 4, -1, []),
        # Inside that new row (3 long, at 2(W-3)+1): the new row at W-1,
        # the tail past the window (ERR_CAPACITY).
        (OP_INSERT, 2 * (W - 3) + 2, 0, 4, 0, [(0, 3)]),
        (OP_ANNOTATE, 2 * (W - 6) + 1, 2 * (W - 3) + 3, 5, 1, [(1, 2)]),
        (OP_REMOVE, 2 * (W - 4), 2 * (W - 3) + 1, 6, 2, []),
    ])
    add("split_insert_last_row", text(W, 2), [
        # Inside row W-1 of a full window: the new row and the tail fall
        # past the window, the head stays.
        (OP_INSERT, 2 * (W - 1) + 1, 0, 4, -1, []),
        (OP_INSERT, 2 * (W - 2) + 1, 0, 5, -1, [(0, 6)]),
        (OP_REMOVE, 2 * (W - 3) + 1, 2 * (W - 1), 6, 1, []),
    ])

    # A split at row 1023 (at the window's top when W is 1024): its new
    # row and tail open the next block of 1024 rows, where the kernel's
    # global layout starts a new segment, and a remove spans the edge.
    r = min(1023, W - 3)
    add("split_insert_row_1023", text(min(W - 2, r + 40), 2), [
        (OP_INSERT, 2 * r + 1, 0, 4, -1, [(0, 5)]),
        (OP_INSERT, 2 * r + 3, 0, 5, 0, []),
        (OP_REMOVE, 2 * r - 3, 2 * r + 9, 6, 1, []),
        (OP_ANNOTATE, 2 * r, 2 * r + 4, 4, 2, [(1, 2)]),
    ])

    # Settled text with unsettled rows anchored apart: each range over
    # them materializes the gaps between them as span rows.
    n = 12
    gapped = overlay_table(W, KR, KK, [20 * (j + 1) for j in range(n)],
                           [2] * n, 300)
    add("gap_loop_13_steps", gapped, [
        (OP_REMOVE, 5, 20 * n + 2 * n + 30, 4, -1, []),
        (OP_ANNOTATE, 2, 40, 5, -1, [(0, 6)]),
        (OP_INSERT, 3, 0, 6, 1, []),          # splits a span row
        (OP_ANNOTATE, 1, 30, 7, 2, [(1, 9)]),
    ])

    n = W - 4
    crowd = overlay_table(W, KR, KK, [2 * (j + 1) for j in range(n)],
                          [1] * n, 2 * W + 8)
    total = 2 * W + 8 + n
    add("gap_loop_overflows", crowd, [
        # ~W gaps with 4 free rows: the window overflows in the loop.
        (OP_REMOVE, 1, total - 1, 4, -1, []),
        (OP_INSERT, 7, 0, 5, -1, []),
        (OP_ANNOTATE, 3, 40, 6, -1, [(2, 4)]),
    ])

    # A removed row with removers and props, and a row with props, each
    # split; then the halves are edited apart.
    div = text(20, 4)
    div["rem_seq"][5] = 21  # removed at n + 1 by client 1
    div["rem_clients"][5, 0] = 1
    div["props"][5, 0] = 7
    div["props"][8, 1] = 3
    add("split_halves_diverge", div, [
        # Client 2 sees row 5 (its ref precedes the removal).
        (OP_INSERT, 22, 0, 2, -2, [(2, 4)]),
        (OP_REMOVE, 22, 24, 3, -2, []),       # only the tail (client 3)
        (OP_ANNOTATE, 20, 22, 2, -2, [(1, 9)]),  # only the head
        (OP_ANNOTATE, 33, 35, 4, 2, [(2, 5)]),   # splits row 8
        (OP_REMOVE, 31, 33, 4, 3, []),        # only row 8's head
    ])

    # Every prop slot of an op filled: a key repeated within one op (the
    # later slot wins), a delete before and after a set of the same key,
    # keys out of range, on inserts and on annotates over text rows and
    # materialized span rows (a delete clears a text row's prop and
    # tombstones a span row's). With PK slots only the first PK apply.
    n = 8
    slots = overlay_table(W, KR, KK, [20 * (j + 1) for j in range(n)],
                          [2] * n, 200)
    slots["props"][:n, 0] = 3
    add("prop_slots_full", slots, [
        (OP_INSERT, 150, 0, 4, -1,
         [(0, 11), (1, 12), (0, 13), (2, PROP_DELETE)]),
        (OP_ANNOTATE, 1, 70, 5, 0,
         [(1, 21), (2, PROP_DELETE), (1, 22), (0, 23)]),
        (OP_ANNOTATE, 30, 90, 6, 1,
         [(2, PROP_DELETE), (2, 5), (NO_KEY, 9), (KK + 1, 7)]),
        (OP_ANNOTATE, 10, 50, 4, 2,
         [(0, 31), (0, PROP_DELETE), (1, PROP_DELETE), (1, 32)]),
        (OP_INSERT, 45, 0, 5, 3,
         [(2, 41), (2, PROP_DELETE), (1, 42), (1, 43)]),
        (OP_REMOVE, 60, 66, 6, 4, [(0, 51), (1, 52), (2, 53), (0, 54)]),
        (OP_ANNOTATE, 0, 120, 7, 5,
         [(KK + 3, 1), (2, 61), (0, 62), (0, PROP_DELETE)]),
        (OP_ANNOTATE, 100, 140, 4, 6,
         [(1, PROP_DELETE), (1, 71), (1, 72), (1, PROP_DELETE)]),
    ])

    full = text(10, 2)
    full["rem_seq"][3] = 11
    full["rem_clients"][3, :] = 100 + np.arange(KR)
    add("removers_full", full, [
        (OP_REMOVE, 6, 8, 5, -2, []),         # ERR_REMOVERS
        (OP_REMOVE, 4, 10, 6, -2, []),
        (OP_REMOVE, 6, 7, 7, -2, []),         # splits the full row
    ])

    # More than W rows created and dropped in one chunk: two halves of a
    # crowded window materialized (the second half's rows mostly pushed
    # off by the first), then split inserts and edits near the front.
    n = W - 8
    crowd = overlay_table(W, KR, KK, [2 * (j + 1) for j in range(n)],
                          [1] * n, 2 * W)
    total = 2 * W + n
    rng = np.random.default_rng(seed)
    specs = [(OP_REMOVE, 1, total // 2, 1, -1, []),
             (OP_REMOVE, total // 2, total - 1, 2, -1, [])]
    for k in range(44):
        p = int(rng.integers(0, total // 4))
        kind = (OP_INSERT, OP_INSERT, OP_REMOVE, OP_ANNOTATE)[k % 4]
        specs.append((kind, p, p + int(rng.integers(1, 6)), 3, -1,
                      [(k % KK, k)]))
    add("recycle_more_than_W", crowd, specs)
    return cases


def widen_prop_slots(ops: OpBatch, PK: int) -> OpBatch:
    """A chunk of ops with one prop slot per op (as a stream's chunks
    are) given PK prop slots: the extra slots are empty (NO_KEY,
    PROP_ABSENT), so the chunk means the same."""
    B = ops.prop_keys.shape[0]
    extra = PK - ops.prop_keys.shape[1]

    def widen(a, fill):
        pad = torch.full((B, extra), fill, dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], 1)

    return OpBatch(
        ops.op_type, ops.pos1, ops.pos2, ops.seq, ops.ref_seq, ops.client,
        ops.buf_start, ops.ins_len, widen(ops.prop_keys, NO_KEY),
        widen(ops.prop_vals, PROP_ABSENT))
