"""The port's row-model replica vs the JAX package's, end to end.

`fluidframework_tpu_torch.core.columnar_replay.ColumnarReplica` on the
CPU (the plain chunk kernel + `compact_gather_text`) against the JAX
`ColumnarReplica(engine="pallas", interpret=True)` and the scalar
oracle `replay_passive`, tolerance 0:

- a seeded lagged stream: final table rows [:n_rows], arena,
  compaction count, text and state digest;
- the tiered capacity growth case of tests/test_columnar_replay.py;
- a JAX table handed over mid-replay through `interop` and finished
  by the port gives the same digest.
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.core.columnar_replay import ColumnarReplica as JReplica
from fluidframework_tpu.core.mergetree import replay_passive
from fluidframework_tpu.testing.digest import state_digest
from fluidframework_tpu.testing.synthetic import (
    generate_lagged_stream,
    generate_stream,
)
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
from fluidframework_tpu_torch.testing.digest import state_digest as t_digest

INITIAL = 64
KW = dict(initial_len=INITIAL, chunk_size=128, capacity=2048, n_removers=8,
          n_prop_keys=8, sync_interval=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lagged():
    """The seeded stream and the JAX replica's full replay of it."""
    stream = generate_lagged_stream(2000, n_clients=64, seed=5, window=256,
                                    initial_len=INITIAL)
    ref = JReplica(stream, engine="pallas", interpret=True, **KW)
    ref.replay()
    ref.check_errors()
    return stream, ref


def _oracle(stream, initial):
    return replay_passive(
        stream.as_messages(),
        initial="".join(map(chr, stream.text[:initial])),
    )


def test_replica_matches_jax_and_oracle(lagged):
    stream, ref = lagged
    rep = ColumnarReplica(interop.stream_from_numpy(stream), device="cpu",
                          **KW)
    rep.replay()
    rep.check_errors()
    rep.verify_invariants()
    assert rep.compactions == ref.compactions > 0
    got = interop.segment_table_to_numpy(rep.table)
    m = int(ref.table.n_rows)
    assert int(got["n_rows"]) == m > 100
    for f in ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
              "rem_clients", "props"):
        np.testing.assert_array_equal(got[f][:m],
                                      np.asarray(getattr(ref.table, f))[:m],
                                      err_msg=f)
    np.testing.assert_array_equal(rep.doc_text, np.asarray(ref.doc_text))
    oracle = _oracle(stream, INITIAL)
    assert rep.get_text() == ref.get_text() == oracle.get_text()
    digest = t_digest(rep.annotated_spans())
    assert digest == state_digest(ref.annotated_spans())
    assert digest == state_digest(oracle.annotated_spans())


@pytest.mark.parametrize("sync", [1, 4])
def test_tiered_capacity_growth(sync):
    """The case of tests/test_columnar_replay.py:97 (capacity 1024,
    chunk 128, sync 1: 256 rows of sync-window margin, enough), and
    with sync 4, whose 1024-row margin makes the table double."""
    initial = 16
    stream = generate_stream(
        1200, n_clients=8, seed=11, window=32, initial_len=initial,
        insert_weight=0.8, remove_weight=0.1, annotate_weight=0.1,
    )
    rep = ColumnarReplica(interop.stream_from_numpy(stream),
                          initial_len=initial, chunk_size=128, capacity=1024,
                          sync_interval=sync, device="cpu")
    rep.replay()
    rep.check_errors()
    assert rep.capacity == (2048 if sync == 4 else 1024)
    assert rep.table.length.shape[0] == rep.capacity
    assert rep.get_text() == _oracle(stream, initial).get_text()


def test_jax_table_continued_by_port(lagged):
    """The JAX replica stops after 6 chunks; its table and arena
    cross through interop and the port replays the rest."""
    stream, ref = lagged
    half = JReplica(stream, engine="pallas", interpret=True, **KW)
    half.replay(limit_chunks=6)
    rep = ColumnarReplica(interop.stream_from_numpy(stream), device="cpu",
                          **KW)
    rep.table = interop.segment_table_from_numpy(half.table._asdict(), "cpu")
    rep.capacity = half.capacity
    rep.arena = torch.from_numpy(np.array(half.doc_text, np.int32))
    rep.chunks_done = 6
    rep.replay()
    rep.check_errors()
    assert t_digest(rep.annotated_spans()) == state_digest(
        ref.annotated_spans())


def test_stop_on_sync_boundary_keeps_schedule(lagged):
    """A replay stopped on a multiple of `sync_interval` and resumed
    compacts exactly where an uninterrupted one does; a stop off the
    boundary compacts off that schedule (here once more). All reach
    the same state."""
    stream, ref = lagged
    port_stream = interop.stream_from_numpy(stream)
    runs = {}
    for stop in (None, 8, 7):
        rep = ColumnarReplica(port_stream, device="cpu", **KW)
        if stop is not None:
            rep.replay(limit_chunks=stop)
            assert rep.chunks_done == stop
        rep.replay()
        runs[stop] = rep
    assert runs[8].compactions == runs[None].compactions == ref.compactions
    assert runs[7].compactions == ref.compactions + 1
    want = state_digest(ref.annotated_spans())
    for rep in runs.values():
        assert t_digest(rep.annotated_spans()) == want
