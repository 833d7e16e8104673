"""The port's replica entry points beyond `replay` vs the JAX package.

The same seeded streams go through the port on the CPU (plain versions
of the kernel, `device="cpu"`) and through the JAX package (the Pallas
kernel in interpret mode). Tolerance 0: everything is int32.

- `replay_streaming` with 1, 3 and 8 segments (the stream of
  tests/test_overlay_pallas.py's streaming case) against the port's
  pre-staged `replay` and against the JAX `replay_streaming`: table,
  fold log, counts, cursor and digest;
- a replica at window 3072 (the overlay fold's first grown window, three
  rows a thread in the kernel's shared layout) and chunk 128 against
  the JAX replica.
"""

import numpy as np
import pytest
import torch

from fluidframework_tpu.core.overlay_replay import (
    OverlayDeviceReplica as JaxReplica,
)
from fluidframework_tpu.testing import synthetic as jsyn
from fluidframework_tpu.testing.digest import state_digest as jax_digest
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.overlay_replay import OverlayDeviceReplica
from fluidframework_tpu_torch.testing.digest import state_digest

TABLE_FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
                "ins_client", "rem_seq", "rem_clients", "props",
                "settled_len", "error")
GEOM = dict(initial_len=16, chunk_size=64, window=1024, n_removers=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    return jsyn.generate_lagged_stream(600, n_clients=6, seed=88, window=48,
                                       initial_len=16)


@pytest.fixture(scope="module")
def jax_streamed(stream):
    """The JAX replica fed in 8 segments (its own test holds its
    segment counts to its pre-staged replay)."""
    rep = JaxReplica(stream, interpret=True, **GEOM)
    rep.replay_streaming(n_segments=8)
    rep.check_errors()
    return rep


@pytest.fixture(scope="module")
def prestaged(stream):
    rep = OverlayDeviceReplica(interop.stream_from_numpy(stream),
                               device="cpu", **GEOM)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rep.replay()
    finally:
        torch.set_num_threads(n)
    rep.check_errors()
    return rep


def _assert_same_state(got, want_table, want_log, want_counts, want_cursor):
    c = int(want_cursor)
    assert int(got.cursor) == c > 0
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(got.log[:c].numpy(),
                                  np.asarray(want_log[:c]))
    t = interop.table_to_numpy(got.table)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(t[f], np.asarray(getattr(want_table, f)),
                                      err_msg=f)


@pytest.mark.parametrize("n_segments", [1, 3, 8])
def test_streaming_matches_prestaged_and_jax(stream, prestaged, jax_streamed,
                                             n_segments):
    rep = OverlayDeviceReplica(interop.stream_from_numpy(stream),
                               device="cpu", **GEOM)
    rep.replay_streaming(n_segments=n_segments)
    rep.check_errors()
    assert rep.chunks_done == rep.n_chunks
    _assert_same_state(rep, prestaged.table, prestaged.log,
                       prestaged.counts, prestaged.cursor)
    _assert_same_state(rep, jax_streamed.table, jax_streamed.log,
                       jax_streamed.counts, jax_streamed.cursor)
    digest = state_digest(rep.annotated_spans())
    assert digest == state_digest(prestaged.annotated_spans())
    assert digest == jax_digest(jax_streamed.annotated_spans())


def test_prepare_host_touches_no_device(stream):
    rep = OverlayDeviceReplica(interop.stream_from_numpy(stream),
                               device="cpu", **GEOM)
    rep.prepare_host()
    assert rep._dev is None
    assert isinstance(rep._host.op_type, np.ndarray)
    assert rep._host.op_type.shape == (rep.n_chunks * GEOM["chunk_size"],)
    assert rep._host_msn.shape == (rep.n_chunks,)


def test_replica_window_3072_matches_jax():
    """Window 3072 (the overlay fold's first grown window: three rows a
    thread in the kernel's shared layout) at chunk 128."""
    stream = jsyn.generate_lagged_stream(384, n_clients=16, seed=31,
                                         window=128, initial_len=64)
    geom = dict(initial_len=64, chunk_size=128, window=3072, n_removers=4)
    jrep = JaxReplica(stream, interpret=True, **geom)
    jrep.replay()
    trep = OverlayDeviceReplica(interop.stream_from_numpy(stream),
                                device="cpu", **geom)
    trep.replay()
    trep.check_errors()
    _assert_same_state(trep, jrep.table, jrep.log, jrep.counts, jrep.cursor)
    assert state_digest(trep.annotated_spans()) == jax_digest(
        jrep.annotated_spans())
