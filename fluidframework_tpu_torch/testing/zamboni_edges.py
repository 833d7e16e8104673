"""Edge tables for the row-model zamboni (`ops/zamboni.zamboni_device`).

Each case is a segment table as a dict of int32 numpy arrays (the
`SegmentTable` fields) and the MSN to compact it under, so that the CPU
tests can give the same inputs to the JAX `zamboni_device` and the
port's plain version, and the card's tests and smoke to the CUDA
kernel. Row i of a base table is settled, its text the 7 characters
after row i - 1's (one contiguous run), unless a case says otherwise.
The cases are where the compaction is easy to get wrong:

- no live row; every row dropped; the whole table one settled run;
- settled neighbours whose text is not contiguous; props that differ
  in one key only; rows removed above the MSN (kept, never merged);
  rows inserted above the MSN (kept, never merged);
- ``n_rows`` above C (every row live);
- around the kernel's tiles of `TILE` rows (where the capacity has more
  than one): kept / dropped rows and run starts at rows T - 1, T and
  T + 1; one run across several tiles; a tile whose every row is
  dropped, with the run before it going on after it;
- random tables mixing all of these (removed rows with remover
  clients, props from a small palette, contiguity drawn per row).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..ops.mergetree_kernel import NO_CLIENT, NOT_REMOVED, PROP_ABSENT
from ..ops.zamboni_kernel import TILE

MSN = 1000  # the cases' applied MSN
ROW_LEN = 7


def base_table(C: int, KR: int, KK: int, n: int) -> Dict[str, np.ndarray]:
    """`n` live settled rows (insert seqs below the MSN, not removed,
    props key 0 set to 5) whose text is one contiguous run; rows at and
    above n hold the empty-row fills."""
    m = min(n, C)
    t = {
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
    t["length"][:m] = ROW_LEN
    t["buf_start"][:m] = ROW_LEN * np.arange(m, dtype=np.int32) + 100
    t["ins_seq"][:m] = np.arange(m, dtype=np.int32) % MSN
    t["ins_client"][:m] = np.arange(m, dtype=np.int32) % 5
    if KK:
        t["props"][:m, 0] = 5
    return t


def drop(t: Dict[str, np.ndarray], rows) -> None:
    """Mark `rows` removed at the MSN by client 3 (dropped), and close
    the text gap they leave so that the kept rows around them stay
    contiguous."""
    rows = np.asarray(rows)
    t["rem_seq"][rows] = MSN
    if t["rem_clients"].shape[1]:
        t["rem_clients"][rows, 0] = 3
    restitch(t)


def restitch(t: Dict[str, np.ndarray]) -> None:
    """Lay the text of the kept rows out contiguously (dropped rows'
    text left where it was)."""
    n = min(int(t["n_rows"]), len(t["length"]))
    kept = t["rem_seq"][:n] > MSN
    lens = np.where(kept, t["length"][:n], 0)
    t["buf_start"][:n] = np.where(kept, 100 + np.cumsum(lens) - lens,
                                  t["buf_start"][:n])


def random_table(C: int, KR: int, KK: int, n: int,
                 seed: int) -> Dict[str, np.ndarray]:
    """`n` live rows drawn from `seed`: a third removed (half of them
    at or below the MSN), insert seqs on both sides of the MSN, props
    from a palette of 3 rows, text contiguous with the row before for
    two rows in three."""
    rng = np.random.default_rng(seed)
    t = base_table(C, KR, KK, n)
    m = min(n, C)
    t["length"][:m] = rng.integers(1, 9, m)
    gaps = np.where(rng.random(m) < 2 / 3, 0, rng.integers(1, 50, m))
    t["buf_start"][:m] = (100 + np.cumsum(gaps) + np.cumsum(t["length"][:m])
                          - t["length"][:m])
    t["ins_seq"][:m] = rng.integers(0, 2 * MSN, m)
    t["ins_seq"][:m][rng.random(m) < 0.6] = rng.integers(0, MSN + 1)
    removed = rng.random(m) < 1 / 3
    t["rem_seq"][:m] = np.where(
        removed, rng.integers(MSN // 2, 3 * MSN // 2, m), NOT_REMOVED)
    for k in range(KR):
        t["rem_clients"][:m, k] = np.where(
            removed & (rng.random(m) < 0.7 ** k), rng.integers(0, 9, m),
            NO_CLIENT)
    if KR:
        t["rem_clients"][:m, 0] = np.where(removed, t["rem_clients"][:m, 0]
                                           % 9, NO_CLIENT)
    palette = rng.integers(-1, 4, (3, KK))
    t["props"][:m] = palette[rng.integers(0, 3, m)]
    return t


def zamboni_edge_tables(C: int, KR: int, KK: int) -> List[dict]:
    """The cases at capacity C: dicts with ``label``, ``table`` and
    ``min_seq``."""
    cases = []

    def case(label, t, msn=MSN):
        cases.append({"label": label, "table": t, "min_seq": msn})

    n = C - C // 8
    case("no live row", base_table(C, KR, KK, 0))
    t = base_table(C, KR, KK, n)
    drop(t, np.arange(n))
    case("every row dropped", t)
    case("one contiguous settled run", base_table(C, KR, KK, n))
    t = base_table(C, KR, KK, n)
    t["buf_start"][1:n:3] += 1
    case("settled neighbours not contiguous", t)
    t = base_table(C, KR, KK, n)
    if KK:
        t["props"][2:n:5, KK - 1] = 9
    case("props differ in one key", t)
    t = base_table(C, KR, KK, n)
    t["rem_seq"][3:n:4] = MSN + 1
    if KR:
        t["rem_clients"][3:n:4, 0] = 2
    case("removed above the MSN", t)
    t = base_table(C, KR, KK, n)
    t["ins_seq"][5:n:6] = MSN + 1
    case("inserted above the MSN", t)
    t = base_table(C, KR, KK, C)
    t["n_rows"] = np.int32(C + 3)
    drop(t, np.arange(0, C, 7))
    t["ins_seq"][4::9] = MSN + 2
    case("n_rows above C", t)
    case("MSN 0", random_table(C, KR, KK, n, 11), 0)
    for seed in (1, 2):
        case(f"random {seed}", random_table(C, KR, KK, n, seed))
    case("random, n_rows above C", random_table(C, KR, KK, C + 5, 3))
    if C <= TILE:
        return cases
    edges = [r for T in range(TILE, C, TILE) for r in (T - 1, T, T + 1)]
    t = base_table(C, KR, KK, C)
    drop(t, edges)
    case("dropped at the tile edges", t)
    t = base_table(C, KR, KK, C)
    t["buf_start"][edges] += 1
    case("run starts at the tile edges", t)
    t = base_table(C, KR, KK, C)
    drop(t, [r for r in edges if r % TILE == TILE - 1])
    t["ins_seq"][[r for r in edges if r % TILE == 1]] = MSN + 1
    case("dropped before, unsettled after the tile edges", t)
    t = base_table(C, KR, KK, C - 1)
    drop(t, np.arange(TILE, 2 * TILE))
    case("a tile dropped inside one run", t)
    if C >= 3 * TILE:
        t = base_table(C, KR, KK, C)
        drop(t, np.arange(TILE // 2, 2 * TILE + 7))
        t["buf_start"][TILE // 3] += 1
        case("a run across dropped tiles", t)
    return cases
