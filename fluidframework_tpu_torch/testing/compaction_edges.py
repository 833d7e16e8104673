"""Edge tables for the chunk path's compaction
(`ops/zamboni.compact_gather_text`).

Each case is a segment table as a dict of int32 numpy arrays (the
`SegmentTable` fields), the MSN to compact it under, and the two text
arrays (``doc_arena`` [A], ``stream_text`` [S]), so that the CPU tests
can give the same inputs to the JAX `compact_gather_text`, the port's
plain version and the kernel's source under the host emulation, and the
card's tests and smoke to the CUDA kernel. Every case lies in the
domain where the plain version's text move is a function of the table
(see `compact_gather_text_ref`): surviving spans are disjoint, each
inside the doc arena ``[0, A)``, inside the stream region
``[STREAM_BASE, STREAM_BASE + S)`` or in neither, with non-negative
lengths whose sum fits in int32. The cases are where the compaction is
easy to get wrong:

- nothing dropped, and everything dropped; no live row; ``n_rows`` past
  C (every row live); MSN 0;
- spans in both regions and spans in neither (between the regions, and
  below 0), zero-length rows;
- runs across the kernel's tiles of `TILE` rows (where the capacity has
  more than one), with kept / dropped rows at the tile edges and one
  tile dropped inside a run;
- props that differ in one key only;
- settled neighbours with equal props whose text is not contiguous:
  the compaction merges them all (maximal coalescing), where the
  zamboni's contiguity test would split every pair;
- int32 length sums near the wrap: rows of ~2^29 characters in neither
  region, one run of length near 2^31 - 1;
- every row kept, each a run of one character: every tile's text as
  long as its row count, every row a start;
- random tables mixing all of these, from a seed;
- for the single-pass kernel's look-back over tiles: three tiles that
  keep nothing between two kept rows of one run, and of two runs; a run
  that starts in one tile and ends four tiles later; the last live tile
  keeping nothing; one kept row whose text is longer than several
  blocks' worth of elements (and than a tile's staged text); a total
  text length of 0, and of exactly A; ``n_rows`` at the int32 maximum;
- tables with many prop keys (`wide_prop_cases`), whose staged props
  take a block past 48 KB of shared memory.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops.mergetree_kernel import NO_CLIENT, NOT_REMOVED, PROP_ABSENT
from ..ops.zamboni import STREAM_BASE
from ..ops.zamboni_kernel import TEXT_CAP, THREADS, TILE

MSN = 1000  # the cases' applied MSN
NEITHER = 1 << 27  # a buf_start between the regions


def empty_table(C: int, KR: int, KK: int, n: int) -> Dict[str, np.ndarray]:
    """A table of `n` live rows (n_rows), every field at its empty-row
    fill, for the cases to fill in."""
    return {
        "n_rows": np.int32(n),
        "buf_start": np.zeros(C, np.int32),
        "length": np.zeros(C, np.int32),
        "ins_seq": np.zeros(C, np.int32),
        "ins_client": np.full(C, NO_CLIENT, np.int32),
        "rem_seq": np.full(C, NOT_REMOVED, np.int32),
        "rem_clients": np.full((C, KR), NO_CLIENT, np.int32),
        "props": np.full((C, KK), PROP_ABSENT, np.int32),
        "error": np.int32(0),
    }


def place(rng: np.random.Generator, lengths: np.ndarray, region: int,
          base: int) -> np.ndarray:
    """buf_starts for spans of `lengths` laid out disjoint, in a random
    order with random gaps, inside a region of `region` elements whose
    first has address `base`."""
    order = rng.permutation(len(lengths))
    room = region - int(lengths.sum())
    if room < 0:
        raise ValueError("the spans do not fit in the region")
    gaps = rng.multinomial(room, np.ones(len(lengths) + 1) / (len(lengths)
                                                              + 1))[:-1]
    starts = np.empty(len(lengths), np.int64)
    at = 0
    for j, g in zip(order, gaps):
        at += int(g)
        starts[j] = at
        at += int(lengths[j])
    return (starts + base).astype(np.int32)


def random_case(C: int, KR: int, KK: int, n: int, seed: int, A: int, S: int,
                drop_share: float = 1 / 6, zero_len: bool = True) -> dict:
    """`n` live rows drawn from `seed`: lengths 1-8 (some 0 with
    `zero_len`), spans in the doc arena (half), the stream region (two
    fifths) and neither, a share `drop_share` removed at or below the
    MSN and as many above it, insert seqs on both sides of the MSN, props
    from a palette of 3 rows."""
    rng = np.random.default_rng(seed)
    t = empty_table(C, KR, KK, n)
    m = min(n, C)
    length = rng.integers(1, 9, m).astype(np.int32)
    if zero_len:
        length[rng.random(m) < 0.02] = 0
    where = rng.random(m)
    doc, stream = where < 0.5, (where >= 0.5) & (where < 0.9)
    buf = np.full(m, NEITHER, np.int32)
    buf[doc] = place(rng, length[doc], A, 0)
    buf[stream] = place(rng, length[stream], S, STREAM_BASE)
    buf[~doc & ~stream & (rng.random(m) < 0.5)] = -50
    t["buf_start"][:m], t["length"][:m] = buf, length
    t["ins_seq"][:m] = rng.integers(0, 2 * MSN, m)
    t["ins_seq"][:m][rng.random(m) < 0.6] = rng.integers(0, MSN + 1)
    t["ins_client"][:m] = rng.integers(0, 9, m)
    r = rng.random(m)
    removed = r < 2 * drop_share
    t["rem_seq"][:m] = np.where(
        r < drop_share, rng.integers(0, MSN + 1, m),
        np.where(removed, rng.integers(MSN + 1, 2 * MSN, m), NOT_REMOVED))
    for k in range(KR):
        t["rem_clients"][:m, k] = np.where(
            removed & (rng.random(m) < 0.7 ** k), rng.integers(0, 9, m),
            NO_CLIENT)
    palette = rng.integers(-1, 4, (3, KK))
    t["props"][:m] = palette[rng.integers(0, 3, m)]
    return case_of(t, MSN, rng, A, S)


def case_of(t: dict, msn: int, rng: np.random.Generator, A: int,
            S: int) -> dict:
    """A case: the table, the MSN and random text arrays of A and S
    codepoints."""
    return {"table": t, "min_seq": msn,
            "doc_arena": rng.integers(32, 127, A).astype(np.int32),
            "stream_text": rng.integers(32, 127, S).astype(np.int32)}


def settled_run(C: int, KR: int, KK: int, n: int, seed: int, A: int,
                S: int) -> dict:
    """`n` live settled rows with equal props, spans scattered over both
    regions (never contiguous in order): one run under the compaction's
    maximal coalescing."""
    rng = np.random.default_rng(seed)
    t = empty_table(C, KR, KK, n)
    m = min(n, C)
    t["length"][:m] = rng.integers(1, 6, m)
    doc = rng.random(m) < 0.5
    t["buf_start"][:m][doc] = place(rng, t["length"][:m][doc], A, 0)
    t["buf_start"][:m][~doc] = place(rng, t["length"][:m][~doc], S,
                                     STREAM_BASE)
    t["ins_seq"][:m] = rng.integers(0, MSN + 1, m)
    t["ins_client"][:m] = rng.integers(0, 5, m)
    if KK:
        t["props"][:m, 0] = 5
    return case_of(t, MSN, rng, A, S)


def packed_case(C: int, KR: int, KK: int, n: int, seed: int,
                long_row: int = -1, long_len: int = 0) -> dict:
    """`n` live rows, none removed, lengths 1-8 (row `long_row` of
    `long_len`), every span in the doc arena, which they fill with no gap:
    the total text length is exactly A. Insert seqs on both sides of the
    MSN, props from a palette of 2 rows."""
    rng = np.random.default_rng(seed)
    t = empty_table(C, KR, KK, n)
    m = min(n, C)
    length = rng.integers(1, 9, m).astype(np.int32)
    if 0 <= long_row < m:
        length[long_row] = long_len
    A = int(length.sum())
    t["buf_start"][:m] = place(rng, length, A, 0)
    t["length"][:m] = length
    t["ins_seq"][:m] = np.where(rng.random(m) < 0.7,
                                rng.integers(0, MSN + 1, m),
                                rng.integers(MSN + 1, 2 * MSN, m))
    t["ins_client"][:m] = rng.integers(0, 9, m)
    palette = rng.integers(-1, 4, (2, KK))
    t["props"][:m] = palette[rng.integers(0, 2, m)]
    return case_of(t, MSN, rng, A, 3 * C + 8)


def compaction_edge_cases(C: int, KR: int, KK: int) -> List[dict]:
    """The cases at capacity C: dicts with ``label``, ``table``,
    ``min_seq``, ``doc_arena`` and ``stream_text``."""
    cases = []
    A, S = 4196 + 8 * C, 6 * C + 50

    def case(label, c):
        c["label"] = label
        cases.append(c)

    n = C - C // 8
    c = random_case(C, KR, KK, 0, 1, A, S)
    case("no live row", c)
    c = random_case(C, KR, KK, n, 2, A, S, drop_share=0)
    case("nothing dropped", c)
    c = random_case(C, KR, KK, n, 3, A, S)
    c["table"]["rem_seq"][:] = MSN // 2
    case("everything dropped", c)
    case("n_rows past C", random_case(C, KR, KK, C + 3, 4, A, S))
    c = random_case(C, KR, KK, n, 5, A, S)
    c["min_seq"] = 0
    case("MSN 0", c)
    for seed in (6, 7):
        case(f"random {seed}", random_case(C, KR, KK, n, seed, A, S))
    c = random_case(C, KR, KK, n, 8, A, S)
    t = c["table"]
    t["buf_start"][:n][t["buf_start"][:n] == -50] = NEITHER
    t["buf_start"][3], t["length"][3] = -7, 5  # below 0: neither region
    case("spans in both regions and in neither", c)
    c = settled_run(C, KR, KK, n, 9, A, S)
    case("settled, not contiguous: one run", c)
    c = settled_run(C, KR, KK, n, 10, A, S)
    if KK:
        c["table"]["props"][2:n:5, KK - 1] = 9
    case("props differ in one key", c)
    c = settled_run(C, KR, KK, n, 11, A, S)
    t = c["table"]
    big = 1 << 29
    t["length"][[1, 2, 3]] = big
    t["buf_start"][[1, 2, 3]] = NEITHER
    t["length"][4] = (1 << 31) - 1 - 3 * big - int(t["length"][:n].sum()
                                                   - t["length"][4]
                                                   - 3 * big) - 5
    t["buf_start"][4] = NEITHER
    case("length sums near the int32 wrap", c)
    if C <= TILE:
        return cases
    edges = [r for T in range(TILE, C, TILE) for r in (T - 1, T, T + 1)]
    c = settled_run(C, KR, KK, C, 12, A, S)
    c["table"]["rem_seq"][edges] = MSN
    case("a run across the tile edges, dropped at them", c)
    c = settled_run(C, KR, KK, C, 13, A, S)
    c["table"]["ins_seq"][edges] = MSN + 1
    case("run starts at the tile edges", c)
    c = settled_run(C, KR, KK, C - 1, 14, A, S)
    c["table"]["rem_seq"][TILE:2 * TILE] = MSN
    case("a tile dropped inside one run", c)
    rng = np.random.default_rng(15)
    t = empty_table(C, KR, KK, C)
    t["length"][:] = 1
    t["buf_start"][:] = place(rng, t["length"], C + 40, 0)
    t["ins_seq"][:] = MSN + 1  # unsettled: a run a row
    case("every row a run of one character",
         case_of(t, MSN, rng, A, S))
    if C <= 5 * TILE:
        return cases
    # the single-pass kernel's look-back over tiles
    c = settled_run(C, KR, KK, C, 16, A, S)
    c["table"]["rem_seq"][TILE:4 * TILE] = MSN
    case("three empty tiles inside one run", c)
    c = settled_run(C, KR, KK, C, 17, A, S)
    c["table"]["rem_seq"][TILE:4 * TILE] = MSN
    if KK:
        c["table"]["props"][4 * TILE:, KK - 1] = 9
    case("three empty tiles between two runs", c)
    c = settled_run(C, KR, KK, C, 18, A, S)
    c["table"]["ins_seq"][:TILE - 5] = MSN + 1
    c["table"]["ins_seq"][5 * TILE + 4:] = MSN + 1
    case("a run from one tile to four tiles later", c)
    c = random_case(C, KR, KK, 4 * TILE + 100, 19, A, S)
    c["table"]["rem_seq"][4 * TILE - 30:4 * TILE + 100] = MSN
    case("the last live tile keeps nothing", c)
    return cases


def text_edge_cases(C: int, KR: int, KK: int) -> List[dict]:
    """Cases at capacity C (at least 64) on the text's bounds, each with
    its own text arrays: dicts as `compaction_edge_cases` gives."""
    cases = []
    n = C - C // 8

    def case(label, c):
        c["label"] = label
        cases.append(c)

    long_len = 4 * TEXT_CAP + 5 * THREADS + 17
    case("one kept row longer than several blocks' worth of elements",
         packed_case(C, KR, KK, n, 20, long_row=2, long_len=long_len))
    c = random_case(C, KR, KK, n, 21, 4196 + 8 * C, 6 * C + 50)
    c["table"]["length"][:] = 0
    case("total text length 0", c)
    case("total text length exactly A", packed_case(C, KR, KK, n, 22))
    c = packed_case(C, KR, KK, C, 23)
    c["table"]["n_rows"] = np.int32((1 << 31) - 1)
    case("n_rows at the int32 maximum", c)
    return cases


def wide_prop_cases(C: int, KR: int, KK: int) -> List[dict]:
    """Cases at capacity C with KK prop keys, each run split by its last
    key only: a random table, a settled run whose last key changes every
    seventh row, and one that changes at each tile's edge. Dicts as
    `compaction_edge_cases` gives."""
    cases = []
    A, S = 4196 + 8 * C, 6 * C + 50
    n = C - C // 8

    def case(label, c):
        c["label"] = label
        cases.append(c)

    case(f"random, {KK} keys", random_case(C, KR, KK, n, 24, A, S))
    c = settled_run(C, KR, KK, n, 25, A, S)
    c["table"]["props"][3:n:7, KK - 1] = 9
    case(f"settled, the last of {KK} keys differs every 7th row", c)
    c = settled_run(C, KR, KK, C, 26, A, S)
    c["table"]["props"][:, KK - 1] = np.arange(C) // TILE
    case(f"settled, the last of {KK} keys differs at the tile edges", c)
    return cases
