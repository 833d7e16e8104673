"""Synthetic totally-ordered op streams in columnar form.

Copied from fluidframework_tpu/testing/synthetic.py (`ColumnarStream`,
`generate_stream`, `generate_lagged_stream`; `as_messages` is left
out), re-pointed at the port's constants and its copy of the native
engine. For the same parameters the arrays equal the JAX package's
exactly (tests/test_torch_overlay_replay.py checks it).

- `generate_stream`: ops use ``ref_seq = seq - 1``.
- `generate_lagged_stream`: the headline bench stream. Each client's
  ``ref_seq`` trails the head by a random lag up to the collaboration
  window, and positions are drawn within the visible length at that
  lagging perspective, queried from the native C++ engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.mergetree_kernel import NO_KEY, OP_ANNOTATE, OP_INSERT, OP_REMOVE


@dataclass
class ColumnarStream:
    """A sequenced op stream as parallel numpy arrays (one row per op)."""

    op_type: np.ndarray  # int32[N]
    pos1: np.ndarray  # int32[N]
    pos2: np.ndarray  # int32[N]
    seq: np.ndarray  # int32[N]
    ref_seq: np.ndarray  # int32[N]
    client: np.ndarray  # int32[N]
    buf_start: np.ndarray  # int32[N] (offset into `text`)
    ins_len: np.ndarray  # int32[N]
    prop_key: np.ndarray  # int32[N] (NO_KEY when no annotation)
    prop_val: np.ndarray  # int32[N]
    min_seq: np.ndarray  # int32[N] MSN as of this op
    text: np.ndarray  # int32[S] codepoint arena for all inserted text

    def __len__(self) -> int:
        return len(self.op_type)


def generate_stream(
    n_ops: int,
    n_clients: int = 1024,
    seed: int = 0,
    window: int = 1024,
    insert_weight: float = 0.55,
    remove_weight: float = 0.25,
    annotate_weight: float = 0.20,
    max_insert_len: int = 8,
    max_range_len: int = 16,
    n_prop_keys: int = 8,
    n_prop_vals: int = 16,
    initial_len: int = 64,
) -> ColumnarStream:
    """Generate `n_ops` mixed ops from `n_clients` round-robin clients.

    The MSN trails the head by `window` (the collaboration-window size
    deli would maintain for caught-up clients), so replay engines can
    compact tombstones exactly as they would in a live session.
    """
    rng = np.random.default_rng(seed)
    # Pre-draw all randomness (keeps the Python loop light).
    type_u = rng.random(n_ops)
    pos_u = rng.random(n_ops)
    len_draw = rng.integers(1, max_insert_len + 1, n_ops).astype(np.int64)
    range_draw = rng.integers(1, max_range_len + 1, n_ops).astype(np.int64)
    keys = rng.integers(0, n_prop_keys, n_ops).astype(np.int32)
    vals = rng.integers(0, n_prop_vals, n_ops).astype(np.int32)
    codepoints = rng.integers(ord("a"), ord("z") + 1, int(np.sum(len_draw))).astype(
        np.int32
    )

    w_total = insert_weight + remove_weight + annotate_weight
    t_ins = insert_weight / w_total
    t_rem = t_ins + remove_weight / w_total

    op_type = np.empty(n_ops, np.int32)
    pos1 = np.empty(n_ops, np.int32)
    pos2 = np.zeros(n_ops, np.int32)
    buf_start = np.zeros(n_ops, np.int32)
    ins_len = np.zeros(n_ops, np.int32)
    prop_key = np.full(n_ops, NO_KEY, np.int32)
    prop_val = np.zeros(n_ops, np.int32)

    length = initial_len  # visible length before op i (ref_seq = seq-1 view)
    arena_off = initial_len
    for i in range(n_ops):
        u = type_u[i]
        if u < t_ins or length == 0:
            n = int(len_draw[i])
            op_type[i] = OP_INSERT
            pos1[i] = int(pos_u[i] * (length + 1))
            buf_start[i] = arena_off
            ins_len[i] = n
            arena_off += n
            length += n
        else:
            start = int(pos_u[i] * length)
            end = min(length, start + int(range_draw[i]))
            assert end > start  # pos_u < 1.0 and range_draw >= 1
            if u < t_rem:
                op_type[i] = OP_REMOVE
                length -= end - start
            else:
                op_type[i] = OP_ANNOTATE
                prop_key[i] = keys[i]
                prop_val[i] = vals[i]
            pos1[i] = start
            pos2[i] = end

    seq = np.arange(1, n_ops + 1, dtype=np.int32)
    initial_text = rng.integers(ord("a"), ord("z") + 1, initial_len).astype(np.int32)
    text = np.concatenate([initial_text, codepoints[: arena_off - initial_len]])
    return ColumnarStream(
        op_type=op_type,
        pos1=pos1,
        pos2=pos2,
        seq=seq,
        ref_seq=seq - 1,
        client=(np.arange(n_ops, dtype=np.int32) % n_clients) + 1,
        buf_start=buf_start,
        ins_len=ins_len,
        prop_key=prop_key,
        prop_val=prop_val,
        min_seq=np.maximum(0, seq - window).astype(np.int32),
        text=text,
    )


def generate_lagged_stream(
    n_ops: int,
    n_clients: int = 1024,
    seed: int = 0,
    window: int = 1024,
    lag_zero_frac: float = 0.35,
    insert_weight: float = 0.55,
    remove_weight: float = 0.25,
    annotate_weight: float = 0.20,
    max_insert_len: int = 8,
    max_range_len: int = 16,
    n_prop_keys: int = 8,
    n_prop_vals: int = 16,
    initial_len: int = 64,
    cache_dir: str | None = None,
) -> ColumnarStream:
    """Generate `n_ops` mixed ops whose refSeqs lag the head.

    Per op: `lag_zero_frac` of ops are caught up (``ref_seq = seq-1``,
    the well-synced client); the rest draw a lag uniform in
    ``[1, window-1]``, clamped so ``ref_seq >= MSN`` (deli nacks staler
    refSeqs, deli/lambda.ts:967) and per-client non-decreasing (a
    client cannot unsee ops). Positions are valid *in the emitting
    client's view*: the visible length at ``(ref_seq, client)`` is
    queried from the native C++ engine — which includes the client's
    own earlier ops and excludes concurrent ops it has not seen — so a
    replay engine resolving these ops performs genuine lagging-
    perspective work (insert tie-breaks against concurrent inserts,
    tombstone skips for unseen removes; mergeTree.ts:1740 insertingWalk
    at a non-head perspective).

    The generation-time engine replay makes this ~10x slower than
    `generate_stream`; pass `cache_dir` to memoize the arrays on disk
    keyed by all parameters.
    """
    import ctypes

    params = (
        n_ops, n_clients, seed, window, round(lag_zero_frac, 6),
        round(insert_weight, 6), round(remove_weight, 6),
        round(annotate_weight, 6), max_insert_len, max_range_len,
        n_prop_keys, n_prop_vals, initial_len,
    )
    cache_path = None
    if cache_dir:
        import hashlib
        import os

        key = hashlib.sha256(repr(params).encode()).hexdigest()[:16]
        cache_path = os.path.join(cache_dir, f"lagged_{key}.npz")
        if os.path.exists(cache_path):
            z = np.load(cache_path)
            return ColumnarStream(**{k: z[k] for k in z.files})

    from ..native import load_hostmerge
    from ..protocol.constants import NO_CLIENT

    lib = load_hostmerge()
    if lib is None:
        raise RuntimeError(
            "generate_lagged_stream needs the native hostmerge engine "
            "(no C++ compiler available)"
        )

    rng = np.random.default_rng(seed)
    type_u = rng.random(n_ops)
    pos_u = rng.random(n_ops)
    lag_u = rng.random(n_ops)
    lag_draw = rng.integers(1, max(window - 1, 1) + 1, n_ops)
    len_draw = rng.integers(1, max_insert_len + 1, n_ops).astype(np.int64)
    range_draw = rng.integers(1, max_range_len + 1, n_ops).astype(np.int64)
    keys = rng.integers(0, n_prop_keys, n_ops).astype(np.int32)
    vals = rng.integers(0, n_prop_vals, n_ops).astype(np.int32)
    arena = np.ascontiguousarray(
        rng.integers(
            ord("a"), ord("z") + 1, initial_len + int(np.sum(len_draw))
        ).astype(np.int32)
    )

    w_total = insert_weight + remove_weight + annotate_weight
    t_ins = insert_weight / w_total
    t_rem = t_ins + remove_weight / w_total

    op_type = np.empty(n_ops, np.int32)
    pos1 = np.empty(n_ops, np.int32)
    pos2 = np.zeros(n_ops, np.int32)
    ref_seq = np.empty(n_ops, np.int32)
    buf_start = np.zeros(n_ops, np.int32)
    ins_len = np.zeros(n_ops, np.int32)
    prop_key = np.full(n_ops, NO_KEY, np.int32)
    prop_val = np.zeros(n_ops, np.int32)
    last_ref = np.zeros(n_clients + 1, np.int32)

    # The generator's view oracle: a passive native replica with an
    # identity no stream client uses, so every op takes the remote
    # path (hostmerge.cpp vis()).
    h = ctypes.c_void_p(lib.hm_new(NO_CLIENT))
    try:
        ip = ctypes.POINTER(ctypes.c_int32)
        arena_p = arena.ctypes.data_as(ctypes.c_void_p).value
        isz = ctypes.sizeof(ctypes.c_int32)
        lib.hm_load(h, arena.ctypes.data_as(ip), initial_len)
        arena_off = initial_len
        hm_insert = lib.hm_insert
        hm_remove = lib.hm_remove
        hm_vislen = lib.hm_visible_length
        for i in range(n_ops):
            seq = i + 1
            c = (i % n_clients) + 1
            msn = seq - window
            if msn < 0:
                msn = 0
            if lag_u[i] < lag_zero_frac:
                r = seq - 1
            else:
                r = seq - 1 - int(lag_draw[i])
            if r < msn:
                r = msn
            lr = last_ref[c]
            if r < lr:
                r = int(lr)
            last_ref[c] = r
            ref_seq[i] = r
            L = hm_vislen(h, r, c)
            u = type_u[i]
            if u < t_ins or L == 0:
                n = int(len_draw[i])
                op_type[i] = OP_INSERT
                p = int(pos_u[i] * (L + 1))
                pos1[i] = p
                buf_start[i] = arena_off
                ins_len[i] = n
                rc = hm_insert(
                    h, p,
                    ctypes.cast(arena_p + arena_off * isz, ip),
                    n, r, c, seq, None, None, 0,
                )
                arena_off += n
            else:
                start = int(pos_u[i] * L)
                end = min(L, start + int(range_draw[i]))
                pos1[i] = start
                pos2[i] = end
                if u < t_rem:
                    op_type[i] = OP_REMOVE
                    rc = hm_remove(h, start, end, r, c, seq)
                else:
                    # Annotate never changes visible lengths; the view
                    # oracle can skip it.
                    op_type[i] = OP_ANNOTATE
                    prop_key[i] = keys[i]
                    prop_val[i] = vals[i]
                    rc = 0
            if rc != 0:
                raise AssertionError(
                    f"generator emitted invalid op at seq {seq}"
                )
            if (i & 255) == 255:
                lib.hm_set_current_seq(h, seq)
                lib.hm_update_min_seq(h, msn)
                # Passive replica: merge adjacent settled segments so
                # the per-op view walk stays O(collab window), not
                # O(total inserts) (zamboni.ts:19 packParent role).
                lib.hm_pack_settled(h)
    finally:
        lib.hm_free(h)

    seqs = np.arange(1, n_ops + 1, dtype=np.int32)
    stream = ColumnarStream(
        op_type=op_type,
        pos1=pos1,
        pos2=pos2,
        seq=seqs,
        ref_seq=ref_seq,
        client=(np.arange(n_ops, dtype=np.int32) % n_clients) + 1,
        buf_start=buf_start,
        ins_len=ins_len,
        prop_key=prop_key,
        prop_val=prop_val,
        min_seq=np.maximum(0, seqs - window).astype(np.int32),
        text=arena[:arena_off],
    )
    if cache_path:
        import os

        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
        np.savez(
            tmp,
            **{
                f: getattr(stream, f)
                for f in stream.__dataclass_fields__
            },
        )
        os.replace(tmp, cache_path)
    return stream
