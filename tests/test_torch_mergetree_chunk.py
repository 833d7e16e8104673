"""Differential tests: the port's row-model chunk ops vs the JAX package's.

The same int32 inputs, made with numpy from seeds, go through the JAX
functions (the Pallas chunk kernel in interpret mode, as
tests/test_columnar_replay.py runs it) and through the port's plain
PyTorch versions on the CPU. Tolerance 0: everything is int32.

- `apply_chunk_ref` vs `mergetree_pallas.apply_chunk` chunk by chunk
  over seeded streams at four table geometries, with
  `compact_gather_text` (port vs JAX, whole table and arena) between
  chunks;
- crafted chunks: the row-0 landing (the roll's wrap), NOOP padding,
  remover-slot exhaustion, positions past the end, and inserts into a
  full table;
- the one intended difference: an insert at the end of a full table
  flags ERR_CAPACITY as the scan kernel `apply_op_batch_jit` does,
  where the Pallas kernel drops it silently; the table is the Pallas
  kernel's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_pallas as jmp
from fluidframework_tpu.ops.mergetree_kernel import OpBatch as JOpBatch
from fluidframework_tpu.ops.mergetree_kernel import SegmentTable as JTable
from fluidframework_tpu.ops.mergetree_kernel import apply_op_batch_jit
from fluidframework_tpu.ops.zamboni import compact_gather_text as j_compact
from fluidframework_tpu.testing.synthetic import (
    generate_lagged_stream,
    generate_stream,
)
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops.mergetree_chunk import apply_chunk_ref
from fluidframework_tpu_torch.ops.mergetree_kernel import (
    ERR_BAD_POS,
    ERR_CAPACITY,
    ERR_REMOVERS,
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
from fluidframework_tpu_torch.ops.zamboni import (
    STREAM_BASE,
    compact_gather_text,
)

TABLE_FIELDS = ("n_rows", "buf_start", "length", "ins_seq", "ins_client",
                "rem_seq", "rem_clients", "props", "error")
OP_FIELDS = ("op_type", "pos1", "pos2", "seq", "ref_seq", "client",
             "buf_start", "ins_len", "prop_keys", "prop_vals")
INITIAL = 16
B = 128  # stream chunk
CB = 16  # crafted chunk


@pytest.fixture(autouse=True)
def _one_thread():
    # The plain version issues many small tensor ops; threads only add
    # overhead at these sizes.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _empty(C, KR, KK):
    return dict(
        n_rows=np.int32(0), buf_start=np.zeros(C, np.int32),
        length=np.zeros(C, np.int32), ins_seq=np.zeros(C, np.int32),
        ins_client=np.full(C, NO_CLIENT, np.int32),
        rem_seq=np.full(C, NOT_REMOVED, np.int32),
        rem_clients=np.full((C, KR), NO_CLIENT, np.int32),
        props=np.full((C, KK), PROP_ABSENT, np.int32), error=np.int32(0),
    )


def _jt(d):
    return JTable(**{k: jnp.asarray(v) for k, v in d.items()})


def _jops(d):
    return JOpBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def _np(jtable):
    return {f: np.asarray(getattr(jtable, f)) for f in TABLE_FIELDS}


def _assert_rows_equal(j, t, where):
    """n_rows, error and rows [:n_rows] (rows beyond are scratch)."""
    t = interop.segment_table_to_numpy(t)
    assert int(j["n_rows"]) == int(t["n_rows"]), where
    assert int(j["error"]) == int(t["error"]), where
    m = min(int(j["n_rows"]), j["length"].shape[0])
    for f in TABLE_FIELDS[1:-1]:
        np.testing.assert_array_equal(j[f][:m], t[f][:m],
                                      err_msg=f"{where} {f}")


def _assert_all_equal(j, t, where):
    t = interop.segment_table_to_numpy(t)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(j[f], t[f], err_msg=f"{where} {f}")


def _stream_chunks(stream, PK, seed):
    """NOOP-padded host op chunks of B ops (dicts of int32 arrays) and
    the applied MSN at each chunk's end. PK > 1 adds key slots drawn
    from `seed` (some NO_KEY, some PROP_DELETE)."""
    n = len(stream)
    nch = -(-n // B)

    def pad(a, fill):
        out = np.full(nch * B, fill, np.int32)
        out[:n] = a
        return out

    rng = np.random.default_rng(seed)
    kk = int(stream.prop_key.max()) + 1
    keys = [pad(stream.prop_key, NO_KEY)]
    vals = [pad(stream.prop_val, PROP_ABSENT)]
    for _ in range(PK - 1):
        k = rng.integers(0, kk, nch * B).astype(np.int32)
        keys.append(np.where(rng.random(nch * B) < 0.5, k, NO_KEY)
                    .astype(np.int32))
        v = rng.integers(0, 16, nch * B).astype(np.int32)
        vals.append(np.where(rng.random(nch * B) < 0.2, PROP_DELETE, v)
                    .astype(np.int32))
    cols = dict(
        op_type=pad(stream.op_type, OP_NOOP), pos1=pad(stream.pos1, 0),
        pos2=pad(stream.pos2, 0), seq=pad(stream.seq, 0),
        ref_seq=pad(stream.ref_seq, 0), client=pad(stream.client, NO_CLIENT),
        buf_start=pad(stream.buf_start + STREAM_BASE, 0),
        ins_len=pad(stream.ins_len, 0),
        prop_keys=np.stack(keys, 1), prop_vals=np.stack(vals, 1),
    )
    for ci in range(nch):
        sl = slice(ci * B, (ci + 1) * B)
        msn = int(stream.min_seq[min((ci + 1) * B, n) - 1])
        yield {k: v[sl].copy() for k, v in cols.items()}, msn


def _padded(a, grid=1024):
    out = np.zeros(-(-(len(a) + 1) // grid) * grid, np.int32)
    out[: len(a)] = a
    return out


# (capacity, KR, KK, PK, stream kind): one Pallas compile per shape.
GEOMETRIES = [
    (1024, 4, 1, 1, "plain"),
    (1024, 2, 2, 2, "lagged"),
    (2048, 24, 8, 1, "lagged"),
    (2048, 8, 4, 1, "plain"),
]


@pytest.mark.parametrize("C,KR,KK,PK,kind", GEOMETRIES,
                         ids=[f"c{g[0]}-kr{g[1]}-kk{g[2]}-pk{g[3]}-{g[4]}"
                              for g in GEOMETRIES])
def test_stream_chunks_match_pallas(C, KR, KK, PK, kind):
    gen = generate_lagged_stream if kind == "lagged" else generate_stream
    stream = gen(5 * B, n_clients=16, seed=C + KR + KK, window=64,
                 initial_len=INITIAL, n_prop_keys=KK)
    d = _empty(C, KR, KK)
    d["n_rows"] = np.int32(1)
    d["length"][0] = INITIAL
    jt = _jt(d)
    tt = interop.segment_table_from_numpy(d, "cpu")
    arena = np.zeros(1024 + len(stream.text), np.int32)
    arena[:INITIAL] = stream.text[:INITIAL]
    stext = _padded(stream.text)
    j_arena, j_stext = jnp.asarray(arena), jnp.asarray(stext)
    t_arena, t_stext = torch.from_numpy(arena), torch.from_numpy(stext)
    saw_rows = 0
    for ci, (chunk, msn) in enumerate(_stream_chunks(stream, PK, seed=C)):
        jt = jmp.apply_chunk(jt, _jops(chunk), interpret=True)
        tt = apply_chunk_ref(tt, interop.opbatch_from_numpy(chunk, "cpu"))
        _assert_rows_equal(_np(jt), tt, f"chunk {ci}")
        saw_rows = max(saw_rows, int(tt.n_rows))
        jt, j_arena = j_compact(jt, jnp.int32(msn), j_arena, j_stext)
        tt, t_arena = compact_gather_text(tt, msn, t_arena, t_stext)
        _assert_all_equal(_np(jt), tt, f"compaction after chunk {ci}")
        np.testing.assert_array_equal(np.asarray(j_arena), t_arena.numpy())
    assert saw_rows > 20, "the chunks must build a real table"


# ---------------------------------------------------------------- crafted

CK, CKR, CKK, CPK = 1024, 2, 2, 2  # one Pallas compile for every crafted chunk


def _rows(n, length=2):
    """n live rows of `length`, inserted at seqs 1..n by clients 0..2."""
    d = _empty(CK, CKR, CKK)
    d["n_rows"] = np.int32(n)
    d["buf_start"][:n] = np.arange(n) * length
    d["length"][:n] = length
    d["ins_seq"][:n] = np.arange(1, n + 1)
    d["ins_client"][:n] = np.arange(n) % 3
    return d


def _ops(specs, seq0, noop_seed=None):
    """A chunk of CB ops from (type, pos1, pos2, client, ref_seq,
    [(key, val), ...]) tuples at seqs seq0, seq0+1, ...; the rest NOOP
    (with random fields when `noop_seed` is given)."""
    rng = np.random.default_rng(noop_seed or 0)
    d = {f: np.zeros(CB, np.int32) for f in OP_FIELDS[:8]}
    d["op_type"][:] = OP_NOOP
    d["client"][:] = NO_CLIENT
    d["prop_keys"] = np.full((CB, CPK), NO_KEY, np.int32)
    d["prop_vals"] = np.full((CB, CPK), PROP_ABSENT, np.int32)
    if noop_seed is not None:
        for f in ("pos1", "pos2", "seq", "ref_seq", "client", "ins_len"):
            d[f][:] = rng.integers(0, 50, CB)
        d["prop_keys"][:] = rng.integers(0, CKK, (CB, CPK))
    for i, (typ, p1, p2, cl, ref, props) in enumerate(specs):
        d["op_type"][i] = typ
        d["pos1"][i], d["pos2"][i] = p1, p2
        d["seq"][i] = seq0 + i
        d["ref_seq"][i] = ref
        d["client"][i] = cl
        d["buf_start"][i] = STREAM_BASE + 7 * i
        d["ins_len"][i] = 3 if typ == OP_INSERT else 0
        d["prop_keys"][i] = NO_KEY
        d["prop_vals"][i] = PROP_ABSENT
        for p, (k, v) in enumerate(props):
            d["prop_keys"][i, p], d["prop_vals"][i, p] = k, v
    return d


def _crafted(case):
    """(table dict, ops dict, error bits the chunk must raise)."""
    n = 10
    if case == "insert_at_row0":
        s = n + 1
        return _rows(n), _ops([
            (OP_INSERT, 0, 0, 4, s - 1, [(0, 5), (1, PROP_DELETE)]),
            (OP_INSERT, 0, 0, 5, s - 1, [(1, 2), (1, 3)]),  # concurrent
            (OP_REMOVE, 1, 4, 4, s + 1, []),
            (OP_ANNOTATE, 2, 9, 6, s + 2, [(1, 8), (0, PROP_DELETE)]),
        ], s), 0
    if case == "noop_padded":
        s = n + 1
        return _rows(n), _ops([
            (OP_INSERT, 5, 0, 4, s - 1, []),
            (OP_ANNOTATE, 3, 12, 4, s, [(0, 1), (NO_KEY, 9)]),
            (OP_REMOVE, 7, 11, 5, s - 1, []),
        ], s, noop_seed=3), 0
    if case == "removers_exhausted":
        s = n + 1
        return _rows(n), _ops([
            (OP_REMOVE, 2, 8, 4 + c, s - 1, []) for c in range(4)
        ], s), ERR_REMOVERS
    if case == "insert_past_end":
        s = n + 1
        return _rows(n), _ops([
            (OP_INSERT, 2 * n + 5, 0, 4, s - 1, []),
        ], s), ERR_BAD_POS
    if case == "range_past_end":
        s = n + 1
        return _rows(n), _ops([
            (OP_REMOVE, 2 * n - 1, 2 * n + 3, 4, s - 1, []),
            (OP_ANNOTATE, 0, 2 * n + 1, 4, s, [(0, 2)]),
        ], s), ERR_BAD_POS
    if case == "full_table_middle_insert":
        s = CK + 1
        return _rows(CK, 1), _ops([
            (OP_INSERT, CK // 2, 0, 4, s - 1, []),
            (OP_REMOVE, 3, 9, 4, s, []),
        ], s), ERR_CAPACITY
    raise ValueError(case)


CRAFTED = ["insert_at_row0", "noop_padded", "removers_exhausted",
           "insert_past_end", "range_past_end", "full_table_middle_insert"]


@pytest.mark.parametrize("case", CRAFTED)
def test_crafted_chunk_matches_pallas(case):
    table, ops, must = _crafted(case)
    jt = jmp.apply_chunk(_jt(table), _jops(ops), interpret=True)
    tt = apply_chunk_ref(interop.segment_table_from_numpy(table, "cpu"),
                         interop.opbatch_from_numpy(ops, "cpu"))
    j = _np(jt)
    _assert_rows_equal(j, tt, case)
    assert int(j["error"]) & must == must
    if case == "insert_at_row0":
        # both inserts landed at row 0 (the second breaks the tie with
        # the first, which it did not see), over the wrapped-in row
        assert int(tt.ins_seq[0]) == 12


@pytest.mark.parametrize("where", ["end", "inside_last_row"])
def test_full_table_end_insert_flags_capacity(where):
    """The Pallas kernel drops an insert into a full table without a
    flag when no row can take it: at the document's end, or inside the
    last row (whose split tail falls off the end). The port raises
    ERR_CAPACITY there, as the scan kernel does, and leaves the table
    as the Pallas kernel does."""
    s = CK + 1
    table = _rows(CK, 2)
    pos = 2 * CK if where == "end" else 2 * CK - 1
    ops = _ops([(OP_INSERT, pos, 0, 4, s - 1, [])], s)
    j = _np(jmp.apply_chunk(_jt(table), _jops(ops), interpret=True))
    tt = apply_chunk_ref(interop.segment_table_from_numpy(table, "cpu"),
                         interop.opbatch_from_numpy(ops, "cpu"))
    scan = apply_op_batch_jit(_jt(table), _jops(ops))
    assert int(j["error"]) == 0 and int(j["n_rows"]) == CK
    assert int(scan.error) == ERR_CAPACITY
    assert int(tt.error) == int(scan.error)
    j["error"] = np.int32(ERR_CAPACITY)
    _assert_rows_equal(j, tt, "full-table end insert")


# ------------------------------------------------------------- compaction

@pytest.mark.parametrize("msn_at", ["zero", "middle", "last"])
def test_compact_gather_text_matches_jax(msn_at):
    """A table taken mid-replay (three chunks, no compaction yet: many
    tombstones and split rows) compacts identically, whole table and
    arena, at several MSNs."""
    C, KR, KK = 1024, 4, 2
    stream = generate_lagged_stream(3 * B, n_clients=16, seed=4, window=64,
                                    initial_len=INITIAL, n_prop_keys=KK)
    d = _empty(C, KR, KK)
    d["n_rows"] = np.int32(1)
    d["length"][0] = INITIAL
    tt = interop.segment_table_from_numpy(d, "cpu")
    for chunk, msn in _stream_chunks(stream, 1, seed=0):
        tt = apply_chunk_ref(tt, interop.opbatch_from_numpy(chunk, "cpu"))
    assert int(tt.error) == 0 and int(tt.n_rows) > 100
    msn = {"zero": 0, "middle": int(stream.min_seq[len(stream) // 2]),
           "last": msn}[msn_at]
    arena = np.zeros(1024 + len(stream.text), np.int32)
    arena[:INITIAL] = stream.text[:INITIAL]
    stext = _padded(stream.text)
    host = interop.segment_table_to_numpy(tt)
    jt, ja = j_compact(_jt(host), jnp.int32(msn), jnp.asarray(arena),
                       jnp.asarray(stext))
    got, ga = compact_gather_text(tt, msn, torch.from_numpy(arena),
                                  torch.from_numpy(stext))
    _assert_all_equal(_np(jt), got, f"msn {msn}")
    np.testing.assert_array_equal(np.asarray(ja), ga.numpy())
    if msn_at == "last":
        assert int(got.n_rows) < int(tt.n_rows)
