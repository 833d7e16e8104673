"""Inputs for the batched rebase, and BASELINE config 4's run.

- `config4_inputs` copies the draw of `config4_tree_rebase`
  (tools/bench_configs.py:187-233): N = 100,000 pending ops over a trunk
  window of M = 64, from ``np.random.default_rng(4)``, with the same
  RNG calls in the same order (kinds 0..2, index 0..99,999, count 1..3,
  a move's dst 0..99,999 and 0 otherwise).
- `random_streams` copies the differential streams of
  tests/test_tree_depth.py:226-286, drawn with `random.Random` as there:
  seeds 0-9 (insert/remove, N 64, M 16, three columns) and 1000 + seed
  (with moves, N 64, M 12).
- `edge_streams` are the edge cases of the kernel: empty windows and
  branches, a branch that is not a multiple of the block, a window
  longer than one shared-memory tile, only moves (identity moves on both
  sides), removes split twice, kind values outside 0..2, and positions
  at both ends of int32; then the cases of its grouping by kind: one
  kind only, runs of kinds across warp and block edges, branches of 1,
  31, 33 and one more than a block of ops, and kinds outside 0..2
  within one warp.
- `run_config4` runs config 4 through `rebase_ops_columnar` on a device
  and times the call by the host clock: the port's counterpart of
  `config4_tree_rebase`.
- `array_digest` is the SHA-256 that tree_golden.json pins.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from typing import Dict, List, Tuple

import numpy as np

from ..tree.rebase_kernel import (
    K_INSERT,
    K_MOVE,
    K_REMOVE,
    THREADS,
    TILE,
    TIME_STAGES,
    rebase_ops_columnar,
)

CONFIG4_PENDING, CONFIG4_WINDOW, CONFIG4_SEED = 100_000, 64, 4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "tree_golden.json")

Stream = Tuple[str, np.ndarray, np.ndarray]


def config4_inputs(scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """(ops [N, 4], base [M, 4]) int32 of BASELINE config 4 at
    ``BC_SCALE`` = `scale` (the tool's draw, call for call)."""
    n_pending = int(CONFIG4_PENDING * scale)
    window = CONFIG4_WINDOW
    rng = np.random.default_rng(CONFIG4_SEED)
    kinds = rng.integers(0, 3, n_pending)
    ops = np.stack(
        [kinds, rng.integers(0, 100_000, n_pending),
         rng.integers(1, 4, n_pending),
         np.where(kinds == 2, rng.integers(0, 100_000, n_pending), 0)],
        axis=1,
    ).astype(np.int32)
    bkinds = rng.integers(0, 3, window)
    base = np.stack(
        [bkinds, rng.integers(0, 100_000, window),
         rng.integers(1, 4, window),
         np.where(bkinds == 2, rng.integers(0, 100_000, window), 0)],
        axis=1,
    ).astype(np.int32)
    return ops, base


def _insert_remove_stream(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = random.Random(seed)
    n, m = 64, 16
    ops = np.array([(rng.choice([K_INSERT, K_REMOVE]), rng.randint(0, 30),
                     rng.randint(1, 4)) for _ in range(n)], np.int32)
    base = np.array([(rng.choice([K_INSERT, K_REMOVE]), rng.randint(0, 30),
                      rng.randint(1, 4)) for _ in range(m)], np.int32)
    return ops, base


def _move_stream(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    rng = random.Random(1000 + seed)
    n, m = 64, 12

    def row():
        kind = rng.choice([K_INSERT, K_REMOVE, K_MOVE])
        return (kind, rng.randint(0, 30), rng.randint(1, 4),
                rng.randint(0, 30) if kind == K_MOVE else 0)

    ops = np.array([row() for _ in range(n)], np.int32)
    base = np.array([row() for _ in range(m)], np.int32)
    return ops, base


def random_streams() -> List[Stream]:
    """The 20 differential streams: ("ins_rem_<seed>", ops [64, 3],
    base [16, 3]) for seeds 0-9, then ("moves_<seed>", ops [64, 4],
    base [12, 4]) drawn from 1000 + seed."""
    out = []
    for seed in range(10):
        out.append((f"ins_rem_{seed}", *_insert_remove_stream(seed)))
    for seed in range(10):
        out.append((f"moves_{seed}", *_move_stream(seed)))
    return out


def _rows(rng: np.random.Generator, n: int, kinds, span: int,
          max_cnt: int) -> np.ndarray:
    """n rows of the given kinds over [0, span), counts 1..max_cnt, a
    move's dst in [0, span)."""
    return _rows_of(rng, rng.choice(np.asarray(kinds), n), span, max_cnt)


def _rows_of(rng: np.random.Generator, k: np.ndarray, span: int,
             max_cnt: int) -> np.ndarray:
    """Rows of the kinds `k` over [0, span), counts 1..max_cnt, a
    move's dst in [0, span)."""
    n = len(k)
    idx = rng.integers(0, span, n)
    cnt = rng.integers(1, max_cnt + 1, n)
    dst = np.where(k == K_MOVE, rng.integers(0, span, n), 0)
    return np.stack([k, idx, cnt, dst], axis=1).astype(np.int32)


def _identity_moves(rng: np.random.Generator, n: int, span: int) -> np.ndarray:
    """Moves whose dst lies in [index, index + count]: no-ops."""
    idx = rng.integers(0, span, n)
    cnt = rng.integers(1, 6, n)
    dst = idx + rng.integers(0, cnt + 1)
    return np.stack([np.full(n, K_MOVE), idx, cnt, dst],
                    axis=1).astype(np.int32)


def edge_streams() -> List[Stream]:
    """The kernel's edge set, ("name", ops [N, 4], base [M, 4])."""
    rng = np.random.default_rng(11)
    mixed = (K_INSERT, K_REMOVE, K_MOVE)
    out: List[Stream] = []
    out.append(("window_0", _rows(rng, 50, mixed, 40, 4),
                np.zeros((0, 4), np.int32)))
    out.append(("branch_0", np.zeros((0, 4), np.int32),
                _rows(rng, 10, mixed, 40, 4)))
    out.append(("both_0", np.zeros((0, 4), np.int32),
                np.zeros((0, 4), np.int32)))
    out.append(("ragged_301", _rows(rng, 301, mixed, 60, 4),
                _rows(rng, 40, mixed, 60, 4)))
    # a window of ~5 tiles of base ops over a short branch
    out.append(("long_window", _rows(rng, 200, mixed, 400, 5),
                _rows(rng, 5 * TILE - 120, mixed, 400, 3)))
    # only moves, with identity moves on both sides mixed in
    ops = np.concatenate([_rows(rng, 96, (K_MOVE,), 50, 5),
                          _identity_moves(rng, 64, 50)])
    base = np.concatenate([_rows(rng, 12, (K_MOVE,), 50, 4),
                           _identity_moves(rng, 12, 50)])
    out.append(("moves_only", ops[rng.permutation(len(ops))],
                base[rng.permutation(len(base))]))
    # long removes under many small attaches: the spare is taken, then
    # a second split (of the head or of the tail) flags
    ops = _rows(rng, 256, (K_REMOVE,), 200, 20)
    base = _rows(rng, 16, (K_INSERT, K_INSERT, K_INSERT, K_MOVE), 200, 2)
    out.append(("double_split", ops, base))
    # kind values outside 0..2 on both sides (computed as the reference
    # computes them)
    out.append(("odd_kinds", _rows(rng, 160, (-1, 0, 1, 2, 3), 40, 4),
                _rows(rng, 24, (-1, 0, 1, 2, 3, 7), 40, 4)))
    # positions at both ends of int32, where the sums wrap (as the
    # reference's int32 arithmetic wraps)
    out.append(("int32_ends", _int32_ends(rng, 320), _int32_ends(rng, 40)))
    return out + _grouping_streams()


# Run lengths of one kind that straddle the kernel's warp (32) and block
# (THREADS) edges.
KIND_RUNS = (31, 33, THREADS + 1)


def _grouping_streams() -> List[Stream]:
    """The cases of the kernel's grouping of a block's ops by kind."""
    rng = np.random.default_rng(12)
    mixed = (K_INSERT, K_REMOVE, K_MOVE)
    out: List[Stream] = []
    # one kind only: every warp runs that kind's step
    out.append(("inserts_only", _rows(rng, 600, (K_INSERT,), 80, 4),
                _rows(rng, 40, mixed, 80, 4)))
    out.append(("removes_only", _rows(rng, 600, (K_REMOVE,), 80, 8),
                _rows(rng, 40, mixed, 80, 4)))
    # runs of 31, 33 and 257 of each kind, in turn, across four blocks
    runs = [KIND_RUNS[(i + i // 3) % 3] for i in range(9)]
    kinds = np.concatenate([np.full(r, i % 3) for i, r in enumerate(runs)])
    out.append(("kind_runs", _rows_of(rng, kinds, 120, 4),
                _rows(rng, 48, mixed, 120, 4)))
    # branches of one op, a warp less one, a warp and one, a block and one
    for n in (1, 31, 33, THREADS + 1):
        out.append((f"n_{n}", _rows(rng, n, mixed, 60, 4),
                    _rows(rng, 32, mixed, 60, 4)))
    # kinds outside 0..2 among the lanes of one warp: one odd lane in a
    # warp of inserts, two in one of removes, moves alternating with an
    # odd kind, and a warp of one odd kind only
    kinds = np.concatenate([
        np.where(np.arange(32) == 7, -1, K_INSERT),
        np.select([np.arange(32) == 0, np.arange(32) == 31], [3, 7],
                  K_REMOVE),
        np.where(np.arange(32) % 2 == 0, K_MOVE, -2),
        np.full(32, 5)])
    out.append(("odd_in_warp", _rows_of(rng, kinds, 40, 4),
                _rows(rng, 24, (-1, 0, 1, 2, 3), 40, 4)))
    return out


def _int32_ends(rng: np.random.Generator, n: int) -> np.ndarray:
    """n mixed rows (counts 1..4) whose index and dst lie within 40 of
    the int32 maximum, or (dst apart) of the minimum."""
    rows = _rows(rng, n, (K_INSERT, K_REMOVE, K_MOVE), 40, 4).astype(np.int64)
    top, bottom = np.int64(2**31 - 1), np.int64(-2**31)
    low = rng.random(n) < 0.5
    rows[:, 1] = np.where(low, bottom + rows[:, 1], top - rows[:, 1])
    rows[:, 3] = np.where(rows[:, 0] == K_MOVE, top - rows[:, 3], 0)
    return rows.astype(np.int32)


def all_streams() -> List[Stream]:
    """The 20 random streams, then the edge set."""
    return random_streams() + edge_streams()


def array_digest(a: np.ndarray) -> str:
    """SHA-256 over an array's dtype, shape and bytes (C order)."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(f"{a.dtype.str}{tuple(a.shape)}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def rebase_counts(rebased: np.ndarray, spares: np.ndarray,
                  flagged: np.ndarray) -> Dict[str, int]:
    """What config 4 reports: ops flagged for the scalar path, native
    splits (a live spare on an unflagged op, as the tool counts them),
    and muted ops (count 0 on an unflagged op)."""
    return {
        "flagged": int(flagged.sum()),
        "native_splits": int(((spares[:, 2] > 0) & ~flagged).sum()),
        "muted": int(((rebased[:, 2] == 0) & ~flagged).sum()),
    }


def digests(rebased: np.ndarray, spares: np.ndarray,
            flagged: np.ndarray) -> Dict[str, str]:
    return {"rebased": array_digest(rebased), "spares": array_digest(spares),
            "flagged": array_digest(flagged)}


def load_tree_golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def run_config4(device) -> dict:
    """Config 4 through `rebase_ops_columnar` on `device` (the port's
    `config4_tree_rebase`): one call timed by the host clock, its split
    into TIME_STAGES, `op_rebases_per_sec` = N * M / seconds, the counts
    and the three digests; ``outputs`` holds (rebased, spares,
    flagged)."""
    ops, base = config4_inputs()
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    out = rebase_ops_columnar(ops, base, device, times=times)
    seconds = time.perf_counter() - t0
    rebases = ops.shape[0] * base.shape[0]
    return {
        "pending_ops": ops.shape[0], "window": base.shape[0],
        "seconds": seconds,
        "op_rebases_per_sec": rebases / seconds,
        "stage_seconds": {k: times[k] for k in TIME_STAGES},
        **rebase_counts(*out),
        "digests": digests(*out),
        "outputs": out,
    }
