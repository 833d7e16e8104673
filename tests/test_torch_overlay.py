"""Differential tests: the port's overlay ops vs the JAX package's.

The same int32 inputs, made with numpy from seeds, go through the JAX
functions (the Pallas chunk kernel in interpret mode, as
tests/test_overlay_pallas.py runs it) and through the port's plain
PyTorch versions on the CPU. Tolerance 0: everything is int32.

- `overlay_apply_chunk_ref` vs `overlay_pallas.overlay_apply_chunk`
  chunk by chunk (n_rows, error, rows [:n_rows] of every column);
- `fold_device` vs its JAX counterpart (whole table, records[:n_rec],
  n_rec) at every chunk boundary and over a sweep of MSNs;
- `zamboni.pack_partition` vs `zamboni._pack_partition`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import overlay_pallas as jov
from fluidframework_tpu.ops.mergetree_kernel import OpBatch as JOpBatch
from fluidframework_tpu.ops.zamboni import _pack_partition
from fluidframework_tpu.testing.synthetic import (
    generate_lagged_stream,
    generate_stream,
)
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.ops.mergetree_kernel import (
    ERR_BAD_POS,
    ERR_CAPACITY,
    ERR_REMOVERS,
    OP_INSERT,
    OP_REMOVE,
)
from fluidframework_tpu_torch.ops.zamboni import pack_partition

TABLE_FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
                "ins_client", "rem_seq", "rem_clients", "props",
                "settled_len", "error")
INITIAL = 64


def _chunks(stream, B):
    """The stream as NOOP-padded host op chunks (dicts of int32 arrays),
    with the applied MSN at each chunk's end."""
    n = len(stream)
    nch = -(-n // B)

    def pad(a, fill):
        out = np.full(nch * B, fill, np.int32)
        out[:n] = a
        return out

    cols = dict(
        op_type=pad(stream.op_type, 3), pos1=pad(stream.pos1, 0),
        pos2=pad(stream.pos2, 0), seq=pad(stream.seq, 0),
        ref_seq=pad(stream.ref_seq, 0), client=pad(stream.client, -3),
        buf_start=pad(stream.buf_start, 0), ins_len=pad(stream.ins_len, 0),
        prop_keys=pad(stream.prop_key, -1)[:, None],
        prop_vals=pad(stream.prop_val, -1)[:, None],
    )
    for ci in range(nch):
        sl = slice(ci * B, (ci + 1) * B)
        msn = int(stream.min_seq[min((ci + 1) * B, n) - 1])
        yield {k: v[sl].copy() for k, v in cols.items()}, msn


def _jax_table(W, KR, KK=8, settled=INITIAL):
    return jov.make_overlay_table(W, KR, KK, settled_len=settled)


def _np(table):
    return {f: np.asarray(getattr(table, f)) for f in TABLE_FIELDS}


def _assert_rows_equal(jt, tt, where):
    j = _np(jt)
    t = interop.table_to_numpy(tt)
    assert int(j["n_rows"]) == int(t["n_rows"]), where
    assert int(j["error"]) == int(t["error"]), where
    assert int(j["settled_len"]) == int(t["settled_len"]), where
    m = min(int(j["n_rows"]), j["length"].shape[0])
    for f in TABLE_FIELDS[1:-2]:
        np.testing.assert_array_equal(j[f][:m], t[f][:m], err_msg=f"{where} {f}")


def _assert_fold_equal(jout, tout, where):
    jt, jrec, jn = jout
    tt, trec, tn = tout
    assert int(jn) == int(tn), where
    n = int(tn)
    np.testing.assert_array_equal(np.asarray(jrec)[:n], trec.numpy()[:n],
                                  err_msg=f"{where} records")
    j = _np(jt)
    t = interop.table_to_numpy(tt)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(j[f], t[f], err_msg=f"{where} {f}")


def _replay_both(stream, W, KR, B, *, fold=True, mutate=None):
    """Step JAX and the port chunk by chunk from one start state,
    comparing after every apply and every fold. Returns the last
    (JAX table, port table) after apply."""
    jt = _jax_table(W, KR)
    tt = interop.table_from_numpy(_np(jt), device="cpu")
    for ci, (host, msn) in enumerate(_chunks(stream, B)):
        if mutate is not None:
            mutate(ci, host)
        jt = jov.overlay_apply_chunk(
            jt, JOpBatch(**{k: jnp.asarray(v) for k, v in host.items()}),
            True)
        tt = tov.overlay_apply_chunk(
            tt, interop.opbatch_from_numpy(host, device="cpu"))
        _assert_rows_equal(jt, tt, f"chunk {ci}")
        if fold:
            jf = jov.fold_device(jt, jnp.int32(msn))
            tf = tov.fold_device(tt, msn)
            _assert_fold_equal(jf, tf, f"fold {ci}")
            jt, tt = jf[0], tf[0]
    return jt, tt


STREAMS = {
    "synthetic": lambda: generate_stream(
        1200, n_clients=64, seed=3, initial_len=INITIAL, window=256),
    "lagged": lambda: generate_lagged_stream(
        1500, n_clients=32, seed=11, window=512, initial_len=INITIAL),
    "lagged_narrow_window": lambda: generate_lagged_stream(
        1000, n_clients=8, seed=2, window=128, initial_len=INITIAL),
    "remove_heavy": lambda: generate_lagged_stream(
        1200, n_clients=16, seed=5, window=256, initial_len=INITIAL,
        insert_weight=0.45, remove_weight=0.45, annotate_weight=0.10),
    "annotate_heavy": lambda: generate_lagged_stream(
        1200, n_clients=16, seed=6, window=256, initial_len=INITIAL,
        insert_weight=0.35, remove_weight=0.10, annotate_weight=0.55),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("KR,B", [(4, 128), (8, 64)])
def test_chunk_ref_matches_jax(name, KR, B):
    # Error flags are compared like every column: with 4 remover slots
    # the lagged and remove-heavy streams exhaust them (ERR_REMOVERS).
    stream = STREAMS[name]()
    jt, tt = _replay_both(stream, 1024, KR, B)
    assert int(tt.n_rows) > 0


def test_remover_slots_exhausted_matches_jax():
    jt, tt = _replay_both(STREAMS["remove_heavy"](), 1024, 4, 128)
    assert int(tt.error) == ERR_REMOVERS


def test_capacity_overflow_matches_jax():
    # No folds (the MSN never advances past the stream): rows pile up
    # past the window and the kernel keeps going with n_rows > W.
    stream = generate_stream(1500, n_clients=64, seed=3,
                             initial_len=INITIAL, window=4096)
    jt, tt = _replay_both(stream, 1024, 4, 128, fold=False)
    assert int(tt.error) & ERR_CAPACITY
    assert int(tt.n_rows) > 1024


def test_bad_position_matches_jax():
    stream = generate_lagged_stream(600, n_clients=16, seed=9,
                                    window=256, initial_len=INITIAL)

    def mutate(ci, host):
        if ci == 2:
            types = host["op_type"].tolist()
            host["pos1"][types.index(OP_INSERT)] += 100_000
            host["pos2"][types.index(OP_REMOVE)] += 100_000

    jt, tt = _replay_both(stream, 1024, 4, 128, mutate=mutate)
    assert int(tt.error) & ERR_BAD_POS


@pytest.mark.parametrize("msn_frac", [0.0, 0.3, 0.7, 1.0])
def test_fold_device_matches_jax(msn_frac):
    stream = generate_lagged_stream(700, n_clients=16, seed=4,
                                    window=512, initial_len=INITIAL)
    jt, tt = _replay_both(stream, 1024, 4, 128, fold=False)
    assert int(tt.n_rows) > 100
    msn = int(msn_frac * len(stream))
    _assert_fold_equal(jov.fold_device(jt, jnp.int32(msn)),
                       tov.fold_device(tt, msn), f"msn {msn}")


@pytest.mark.parametrize("case", ["random", "all_kept", "all_dropped",
                                  "alternating", "sparse"])
def test_pack_partition_matches_jax(case):
    W = 1024
    rng = np.random.default_rng(len(case))
    drop = {
        "random": rng.random(W) < 0.5,
        "all_kept": np.zeros(W, bool),
        "all_dropped": np.ones(W, bool),
        "alternating": np.arange(W) % 2 == 1,
        "sparse": rng.random(W) < 0.03,
    }[case]
    cols = rng.integers(-2**31, 2**31 - 1, (5, W), dtype=np.int64).astype(
        np.int32)
    want = np.stack(_pack_partition(jnp.asarray(drop),
                                    tuple(jnp.asarray(c) for c in cols)))
    got = pack_partition(torch.from_numpy(drop), torch.from_numpy(cols))
    np.testing.assert_array_equal(want, got.numpy())
    got_seq = pack_partition(torch.from_numpy(drop),
                             [torch.from_numpy(c) for c in cols])
    np.testing.assert_array_equal(want, got_seq.numpy())


def test_make_overlay_table_matches_jax():
    j = _np(jov.make_overlay_table(1024, 4, 8, settled_len=17))
    t = interop.table_to_numpy(
        tov.make_overlay_table(1024, 4, 8, settled_len=17, device="cpu"))
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(j[f], t[f], err_msg=f)
        assert t[f].dtype == np.int32
