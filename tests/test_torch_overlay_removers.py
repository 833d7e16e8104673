"""The docs stream that overflows the remover slots: the port vs JAX.

Of the 32 distinct streams that `chip_smoke.py` replays as many
documents (the headline prefix and the lagged streams of
`testing/golden.DOC_SEEDS`, 100k ops each, at the bench geometry:
window 2048, 24 remover slots, 8 prop keys, chunks of 256), the stream
of seed 124 is the one whose replay flags ERR_REMOVERS: in its chunk 3
a row that 24 clients have removed is removed by one more. Its first 4
chunks go through the port on the CPU (alone, and in `replay_docs`
beside a clean stream of as many ops, seed 101) and through the JAX replica (Pallas in
interpret mode). Tolerance 0: the error words, tables, logs and
readouts agree exactly, and chunk 3 is the first to flag.
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

from fluidframework_tpu.core.overlay_replay import (
    OverlayDeviceReplica as JaxReplica,
)
from fluidframework_tpu.testing import synthetic as jsyn
from fluidframework_tpu.testing.digest import state_digest as jax_digest
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.overlay_replay import (
    OverlayDeviceReplica,
    replay_docs,
    restore_shard,
)
from fluidframework_tpu_torch.ops.mergetree_kernel import ERR_REMOVERS
from fluidframework_tpu_torch.testing.digest import state_digest
from fluidframework_tpu_torch.testing.golden import load_golden

TABLE_FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
                "ins_client", "rem_seq", "rem_clients", "props",
                "settled_len", "error")
SEED, CLEAN_SEED, DOC_OPS, N_CHUNKS, FIRST_ERR = 124, 101, 100_000, 4, 3
GEOM = dict(chunk_size=256, window=2048, n_removers=24, n_prop_keys=8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, n_ops):
    """A lagged stream with the headline's generator parameters."""
    p = load_golden()["params"]
    return jsyn.generate_lagged_stream(
        n_ops, n_clients=p["n_clients"], seed=seed, window=p["window"],
        initial_len=p["initial_len"])


def _prefix(seed):
    """The first N_CHUNKS chunks of the seed's 100k-op stream (a shorter
    generated stream is not a prefix of a longer one, so the whole
    stream is generated)."""
    s = _stream(seed, DOC_OPS)
    n = N_CHUNKS * GEOM["chunk_size"]
    return type(s)(**{f.name: getattr(s, f.name) if f.name == "text"
                      else getattr(s, f.name)[:n] for f in fields(s)})


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        initial_len = load_golden()["params"]["initial_len"]
        streams = [_prefix(SEED),
                   _stream(CLEAN_SEED, N_CHUNKS * GEOM["chunk_size"])]
        jrep = JaxReplica(streams[0], initial_len=initial_len,
                          interpret=True, **GEOM)
        jrep.replay()

        def port_rep(s):
            return OverlayDeviceReplica(interop.stream_from_numpy(s),
                                        initial_len=initial_len,
                                        device="cpu", **GEOM)

        errors = []
        for k in range(1, N_CHUNKS):
            first_k = port_rep(streams[0])
            first_k.replay(limit_chunks=k)
            errors.append(int(first_k.table.error))
        single = port_rep(streams[0])
        single.replay()
        errors.append(int(single.table.error))
        clean = port_rep(streams[1])
        clean.replay()
        docs = replay_docs([port_rep(s) for s in streams])
        docs_rep = restore_shard(port_rep(streams[0]), *docs[:4], 0)
    finally:
        torch.set_num_threads(n)
    return jrep, single, errors, clean, docs, docs_rep


def test_removers_overflow_first_flags_at_chunk_3(runs):
    _, _, errors, clean, _, _ = runs
    assert errors == [0] * FIRST_ERR + [ERR_REMOVERS] * (N_CHUNKS - FIRST_ERR)
    assert int(clean.table.error) == 0


def test_removers_overflow_matches_jax(runs):
    jrep, single, _, _, _, docs_rep = runs
    assert int(jrep.table.error) == ERR_REMOVERS
    for rep in (single, docs_rep):
        t = interop.table_to_numpy(rep.table)
        for f in TABLE_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(jrep.table, f)), t[f], err_msg=f)
        c = int(jrep.cursor)
        assert int(rep.cursor) == c
        np.testing.assert_array_equal(np.asarray(jrep.counts),
                                      rep.counts.numpy())
        np.testing.assert_array_equal(np.asarray(jrep.log[:c]),
                                      rep.log[:c].numpy())
        assert state_digest(rep.annotated_spans()) == jax_digest(
            jrep.annotated_spans())


def test_docs_replay_ors_the_removers_flag(runs):
    """The docs replay's error bits are the OR of its documents': the
    overflowing stream's ERR_REMOVERS, the clean stream's none."""
    _, _, _, clean, (tables, logs, counts, cursors, gmsn, gerr), _ = runs
    assert int(gerr) == ERR_REMOVERS
    assert [int(e) for e in tables.error] == [ERR_REMOVERS, 0]
    assert torch.equal(tables.length[1], clean.table.length)
    assert int(cursors[1]) == int(clean.cursor)
