"""Tables for the overlay fold (`ops/overlay.fold_device` and its append
form `fold_append`).

Each case is an overlay table as a dict of int32 numpy arrays (the
`OverlayTable` fields, one document or a stack of D), the MSN to fold
it under (an int, or ``[D]`` per document) and a log cursor and
capacity for the append form, so that the CPU tests can give the same
inputs to the JAX `fold_device`, the port's plain version and the
kernel's host emulation, and the card's tests and smoke to the CUDA
kernel. The fold is a function of the whole table, dead rows
included, so the tables fill every row, not only the live ones.

`random_table` draws any mix of text rows, span rows (buf at or above
SETTLED_BASE), removed rows and insert seqs around the MSN.
`edge_cases` are where the fold is easy to get wrong: no live row;
every row live; every live row folding; none folding; dropped spans
beside settled text; an MSN below every seq (only live spans settle);
``n_rows`` above W and below 0; anchors and lengths that wrap int32;
a cursor the append must clamp; the docs form with an MSN per
document. Then the edges of the kernel's tiles (a cluster of G CTAs a
document, CTA c owning rows [c T, c T + T), T = W / G rounded up to 4):
``n_rows`` on a tile edge at every G and on the first tile's edge at G
8; every kept row in the first eighth of the rows (the first tile at G
8); every folding row in the last eighth; a W that 8 does not divide
(W - 24: 1000 at 1024); and a W of 9 rows, whose tiles at G 8 are 4
rows and three of them empty (the last two cases are other windows
than W, and rows that are not a multiple of 4 take the kernel's 4-byte
copies).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np

from ..ops.mergetree_kernel import NO_CLIENT, NOT_REMOVED, PROP_ABSENT
from ..ops.overlay_ref import SETTLED_BASE

MSN = 50  # the cases' applied MSN (seqs are drawn in [1, 100))
I32_MAX = 2**31 - 1


class FoldCase(NamedTuple):
    name: str
    table: Dict[str, np.ndarray]
    msn: Union[int, np.ndarray]
    cursor: Union[int, np.ndarray]  # for the append form
    cap: int  # the log's rows for the append form


def random_table(rng: np.random.Generator, W: int, KR: int, KK: int,
                 D: Optional[int] = None, n_rows=None, span_p: float = 0.3,
                 removed_p: float = 0.3) -> Dict[str, np.ndarray]:
    """A table of W rows (a stack of D with `D`) with every row drawn:
    text or span rows, removed rows with remover clients, insert seqs
    and removal seqs in [1, 100), anchors and lengths small. `n_rows`
    (an int, or None for a draw in [0, W]) sets the live rows."""
    lead = () if D is None else (D,)
    sh = lead + (W,)

    def r(lo, hi, shape=sh):
        return rng.integers(lo, hi, shape).astype(np.int32)

    span = rng.random(sh) < span_p
    removed = rng.random(sh) < removed_p
    rows = (r(0, W + 1, lead) if n_rows is None
            else np.full(lead, n_rows, np.int32))
    return {
        "n_rows": rows,
        "anchor": np.sort(r(0, 20 * W), axis=-1).astype(np.int32),
        "buf_start": np.where(span, SETTLED_BASE + r(0, 20 * W),
                              r(0, 20 * W)).astype(np.int32),
        "length": r(1, 40),
        "ins_seq": np.where(span, 0, r(1, 100)).astype(np.int32),
        "ins_client": r(NO_CLIENT, 16),
        "rem_seq": np.where(removed, r(1, 100), NOT_REMOVED).astype(np.int32),
        "rem_clients": np.where(removed[..., None], r(0, 16, sh + (KR,)),
                                NO_CLIENT).astype(np.int32),
        "props": r(PROP_ABSENT, 12, sh + (KK,)),
        "settled_len": r(0, 20 * W, lead),
        "error": r(0, 4, lead),
    }


def edge_cases(W: int = 1024, KR: int = 4, KK: int = 8,
               seed: int = 0) -> List[FoldCase]:
    """The edge cases at window W (see the module docstring), each
    table drawn from `seed`."""
    rng = np.random.default_rng(seed)
    cap = W + W // 2
    cases: List[FoldCase] = []

    def add(name, t, msn=MSN, cursor=W // 4):
        cases.append(FoldCase(name, t, msn, cursor, cap))

    add("no_live_row", random_table(rng, W, KR, KK, n_rows=0))
    add("every_row_live", random_table(rng, W, KR, KK, n_rows=W))
    t = random_table(rng, W, KR, KK, n_rows=W - 3, removed_p=0.0)
    t["ins_seq"][:] = np.where(t["buf_start"] >= SETTLED_BASE, 0, 1)
    add("every_live_row_folding", t)
    t = random_table(rng, W, KR, KK, n_rows=W // 2, span_p=0.0,
                     removed_p=0.0)
    t["ins_seq"][:] = MSN + 1 + rng.integers(0, 40, W).astype(np.int32)
    add("none_folding", t)
    t = random_table(rng, W, KR, KK, n_rows=W - 1, span_p=0.0,
                     removed_p=0.0)
    odd = np.arange(W) % 2 == 1
    t["buf_start"][odd] = SETTLED_BASE + t["buf_start"][odd]
    t["rem_seq"][odd] = 10
    t["rem_clients"][odd, 0] = 3
    t["ins_seq"][odd] = 0
    t["ins_seq"][~odd] = 20
    add("dropped_spans_beside_settled_text", t)
    t = random_table(rng, W, KR, KK, n_rows=W - 100)
    add("msn_below_every_seq", t, msn=0)
    add("n_rows_above_window", random_table(rng, W, KR, KK, n_rows=W + 5))
    add("n_rows_negative", random_table(rng, W, KR, KK, n_rows=-2))
    t = random_table(rng, W, KR, KK, n_rows=W - 7, removed_p=0.6)
    t["anchor"][:] = I32_MAX - 5 - np.arange(W, dtype=np.int32)
    t["length"][:] = I32_MAX // 3
    t["settled_len"] = np.int32(I32_MAX - 1)
    add("int32_wraparound", t)
    add("cursor_clamps", random_table(rng, W, KR, KK), cursor=cap - W // 3)
    add("cursor_past_capacity", random_table(rng, W, KR, KK),
        cursor=I32_MAX - 2 * W)
    D = 3
    add("docs_msn_per_document", random_table(rng, W, KR, KK, D=D),
        msn=np.asarray([0, MSN, 99], np.int32),
        cursor=np.asarray([0, cap - W, cap], np.int32))
    # The kernel's tile edges.
    eighth = W // 8
    add("n_rows_on_tile_edge", random_table(rng, W, KR, KK, n_rows=W // 2))
    add("n_rows_on_first_tile_edge",
        random_table(rng, W, KR, KK, n_rows=eighth))
    t = random_table(rng, W, KR, KK, n_rows=W - 5, span_p=0.0,
                     removed_p=0.0)
    t["ins_seq"][:eighth] = MSN + 1 + rng.integers(0, 40, eighth)
    t["ins_seq"][eighth:] = rng.integers(1, MSN + 1, W - eighth)
    add("kept_rows_in_first_tile_only", t)
    t = random_table(rng, W, KR, KK, n_rows=W, span_p=0.0, removed_p=0.0)
    t["ins_seq"][:] = MSN + 1 + rng.integers(0, 40, W)
    tail = np.arange(W - eighth, W)
    t["buf_start"][tail[::2]] += SETTLED_BASE  # spans: they settle
    t["ins_seq"][tail[::2]] = 0
    t["ins_seq"][tail[1::2]] = rng.integers(1, MSN + 1, len(tail[1::2]))
    drop = tail[1::4]
    t["rem_seq"][drop] = rng.integers(1, MSN + 1, len(drop))
    t["rem_clients"][drop, 0] = 3
    add("folding_rows_in_last_tile_only", t)
    for name, w in (("w_not_divided_by_cluster", W - 24),
                    ("empty_tile", 9)):
        cases.append(FoldCase(name, random_table(rng, w, KR, KK), MSN,
                              w // 4, w + w // 2))
    return cases
