"""The port's row-model scan engine vs the JAX package's, end to end.

`ColumnarReplica(engine="scan", device="cpu")` (the plain scan
`apply_op_batch_ref` a chunk, the host `compact()`) against the JAX
`ColumnarReplica(engine="scan")` and the scalar oracle
`replay_passive`, tolerance 0:

- the cases of tests/test_columnar_replay.py (four seeds with
  compaction, the emergency compact-and-grow, compaction at every
  chunk): ``n_rows``, ``error``, rows ``[:n_rows]``, ``capacity``,
  ``compactions``, ``_rows_bound``, ``doc_text`` and the text, with the
  oracle's text;
- a lagged stream at 8 remover slots and 8 prop keys: its digest equals
  the JAX scan engine's, the oracle's and the port's own chunk path's
  (``engine="pallas"``) on the same stream;
- a JAX scan replica handed over mid-stream (table, ``doc_text``,
  capacity, ``_rows_bound``, the applied MSN) through `interop` and
  finished by the port gives the same state;
- a replay stopped with ``limit_chunks`` and resumed equals one
  uninterrupted replay.
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

COLS = ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
        "rem_clients", "props")
INITIAL = 16
LAGGED_INITIAL = 64
LAGGED_KW = dict(initial_len=LAGGED_INITIAL, chunk_size=128, capacity=2048,
                 n_removers=8, n_prop_keys=8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(stream, initial):
    return replay_passive(
        stream.as_messages(),
        initial="".join(map(chr, stream.text[:initial])),
    )


def _port(stream, **kw) -> ColumnarReplica:
    return ColumnarReplica(interop.stream_from_numpy(stream), engine="scan",
                           device="cpu", **kw)


def _assert_same_replica(rep: ColumnarReplica, ref: JReplica) -> None:
    """Table rows [:n_rows], n_rows, error, capacity, compactions, the
    row bound, the applied MSN, the document text and the text."""
    assert (rep.capacity, rep.compactions, rep._rows_bound,
            rep._applied_min_seq) == (ref.capacity, ref.compactions,
                                      ref._rows_bound, ref._applied_min_seq)
    got = interop.segment_table_to_numpy(rep.table)
    m = int(ref.table.n_rows)
    assert (int(got["n_rows"]), int(got["error"])) == (m,
                                                       int(ref.table.error))
    assert rep.table.length.shape[0] == rep.capacity
    for f in COLS:
        np.testing.assert_array_equal(got[f][:m],
                                      np.asarray(getattr(ref.table, f))[:m],
                                      err_msg=f)
    np.testing.assert_array_equal(rep.doc_text, np.asarray(ref.doc_text))
    assert rep.get_text() == ref.get_text()


CASES = {
    # tests/test_columnar_replay.py:24, :38 and :54.
    **{f"seed{seed}": (dict(n_ops=1500, n_clients=16, seed=seed, window=64),
                       dict(chunk_size=128, capacity=1024,
                            compact_watermark=0.5))
       for seed in (0, 1, 2, 3)},
    "emergency_growth": (
        dict(n_ops=600, n_clients=8, seed=9, window=32, insert_weight=0.9,
             remove_weight=0.05, annotate_weight=0.05),
        dict(chunk_size=64, capacity=128, compact_watermark=0.9)),
    "mid_stream": (dict(n_ops=800, n_clients=4, seed=5, window=16),
                   dict(chunk_size=32, capacity=512, compact_watermark=0.1)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_scan_engine_matches_jax_and_oracle(name):
    gen, kw = CASES[name]
    stream = generate_stream(gen.pop("n_ops"), initial_len=INITIAL, **gen)
    ref = JReplica(stream, initial_len=INITIAL, engine="scan", **kw)
    ref.replay()
    ref.check_errors()
    rep = _port(stream, initial_len=INITIAL, **kw)
    rep.replay()
    rep.check_errors()
    rep.verify_invariants()
    assert rep.compactions > 0
    if name == "emergency_growth":
        assert rep.capacity > kw["capacity"]
    _assert_same_replica(rep, ref)
    assert rep.get_text() == _oracle(stream, INITIAL).get_text()


@pytest.fixture(scope="module")
def lagged():
    """The lagged stream and the JAX scan replica's whole replay."""
    stream = generate_lagged_stream(2000, n_clients=64, seed=5, window=256,
                                    initial_len=LAGGED_INITIAL)
    ref = JReplica(stream, engine="scan", **LAGGED_KW)
    ref.replay()
    ref.check_errors()
    return stream, ref


@pytest.fixture(scope="module")
def lagged_port(lagged):
    stream, _ = lagged
    rep = _port(stream, **LAGGED_KW)
    rep.replay()
    rep.check_errors()
    return rep


def test_lagged_stream_engines_converge(lagged, lagged_port):
    stream, ref = lagged
    _assert_same_replica(lagged_port, ref)
    assert lagged_port.compactions > 0
    digest = t_digest(lagged_port.annotated_spans())
    assert digest == state_digest(ref.annotated_spans())
    assert digest == state_digest(_oracle(stream, LAGGED_INITIAL)
                                  .annotated_spans())
    chunk = ColumnarReplica(interop.stream_from_numpy(stream),
                            engine="pallas", sync_interval=2, device="cpu",
                            **LAGGED_KW)
    chunk.replay()
    chunk.check_errors()
    assert t_digest(chunk.annotated_spans()) == digest


def test_jax_scan_replica_handed_over_mid_stream(lagged, lagged_port):
    """The JAX scan replica stops after 9 chunks (past its first
    compaction); its table, document text, capacity, row bound and
    applied MSN cross through interop and the port replays the rest."""
    stream, ref = lagged
    half = JReplica(stream, engine="scan", **LAGGED_KW)
    half.replay(limit_chunks=9)
    assert half.compactions > 0
    rep = _port(stream, **LAGGED_KW)
    rep.table = interop.segment_table_from_numpy(half.table._asdict(), "cpu")
    rep.doc_text = np.asarray(half.doc_text)
    rep.capacity = half.capacity
    rep._rows_bound = half._rows_bound
    rep._applied_min_seq = half._applied_min_seq
    rep.compactions = half.compactions
    rep.chunks_done = 9
    rep.replay()
    rep.check_errors()
    _assert_same_replica(rep, ref)
    assert t_digest(rep.annotated_spans()) == t_digest(
        lagged_port.annotated_spans())


@pytest.mark.parametrize("stop", [5, 9])
def test_stop_and_resume_equals_one_replay(lagged, lagged_port, stop):
    """Any stop keeps the scan path's schedule: the table, compactions
    and text equal one uninterrupted replay's."""
    stream, ref = lagged
    rep = _port(stream, **LAGGED_KW)
    rep.replay(limit_chunks=stop)
    assert rep.chunks_done == stop
    rep.replay()
    assert rep.chunks_done == rep.n_chunks
    _assert_same_replica(rep, ref)
    assert rep.compactions == lagged_port.compactions
