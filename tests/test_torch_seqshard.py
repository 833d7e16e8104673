"""The port's sequence-sharded replay against the JAX package's.

- the copied numpy spec (`parallel.seqshard_ref.SeqShardedOverlay`)
  against the JAX package's, shard by shard, and against the
  single-document overlay engine;
- `run_sequence_sharded` on 2, 4 and 8 CPU entries against the JAX
  package's on the conftest's virtual devices: every shard's rows, its
  live-row count n, its error word, the OR of the error words and the
  digest, exactly;
- the window that exceeds one device's capacity and the skewed
  boundaries of tests/test_seqshard.py:136-167;
- a capacity overflow flagged alike in both.
"""

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops.mergetree_kernel import ERR_CAPACITY
from fluidframework_tpu.ops.overlay_ref import OverlayReplica
from fluidframework_tpu.parallel import mesh as jmesh
from fluidframework_tpu.parallel import seqshard as jss
from fluidframework_tpu.parallel.seqshard_ref import (
    SeqShardedOverlay as JaxSpec,
)
from fluidframework_tpu.testing.digest import state_digest as jax_digest
from fluidframework_tpu.testing.synthetic import generate_lagged_stream
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.parallel import mesh as tmesh
from fluidframework_tpu_torch.parallel import seqshard as tss
from fluidframework_tpu_torch.parallel.seqshard_ref import SeqShardedOverlay
from fluidframework_tpu_torch.testing.digest import state_digest

SHARD_FIELDS = ("anchor", "buf", "length", "iseq", "iclient", "rseq", "rcl",
                "props")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} (virtual) devices")


def _single(stream, initial_len):
    ref = OverlayReplica(stream, initial_len=initial_len, fold_interval=2048,
                         n_removers=10)
    ref.replay()
    ref.check_errors()
    return ref


def _same_shards(got, want):
    """Two spec objects (port, JAX) hold the same shards."""
    assert len(got.shards) == len(want.shards)
    for d, (a, b) in enumerate(zip(got.shards, want.shards)):
        assert a.n == b.n and a.S == b.S and a.error == b.error, d
        for f in SHARD_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f"shard {d} {f}")
        np.testing.assert_array_equal(a.settled_text, b.settled_text)


@pytest.mark.parametrize("seed,n_shards", [(0, 2), (1, 4), (2, 3), (3, 4)])
def test_copied_spec_matches_jax_spec(seed, n_shards):
    n_ops, initial = 300, 40
    stream = generate_lagged_stream(n_ops, n_clients=6, seed=300 + seed,
                                    window=48, initial_len=initial)
    want = JaxSpec(stream, n_shards, initial_len=initial, fold_interval=64,
                   n_removers=10)
    want.replay()
    got = SeqShardedOverlay(interop.stream_from_numpy(stream), n_shards,
                            initial_len=initial, fold_interval=64,
                            n_removers=10)
    got.replay()
    got.check_errors()
    got.verify_invariants()
    _same_shards(got, want)
    assert state_digest(got.annotated_spans()) == jax_digest(
        _single(stream, initial).annotated_spans())


@pytest.mark.parametrize("n_entries", [2, 4, 8])
def test_run_sequence_sharded_matches_jax(n_entries):
    _need(n_entries)
    initial = 36
    stream = generate_lagged_stream(220, n_clients=6, seed=77, window=40,
                                    initial_len=initial)
    want, jerr = jss.run_sequence_sharded(
        stream, jmesh.make_docs_mesh(n_entries, axis="seq"), initial,
        capacity=2048)
    got, gerr = tss.run_sequence_sharded(
        interop.stream_from_numpy(stream),
        tmesh.make_docs_mesh(n_entries, "cpu", axis="seq"), initial,
        capacity=2048)
    assert gerr == jerr == 0
    _same_shards(got, want)
    digest = state_digest(got.annotated_spans())
    assert digest == jax_digest(want.annotated_spans())
    assert digest == jax_digest(_single(stream, initial).annotated_spans())


def test_window_exceeds_single_device():
    """The live window (fold-free rows) exceeds one shard's capacity:
    only the sharded replay can hold it."""
    _need(4)
    initial = 48
    stream = generate_lagged_stream(600, n_clients=8, seed=13, window=64,
                                    initial_len=initial)
    cap = 448  # more than any one shard's rows, less than the window
    want, jerr = jss.run_sequence_sharded(
        stream, jmesh.make_docs_mesh(4, axis="seq"), initial, capacity=cap)
    got, gerr = tss.run_sequence_sharded(
        interop.stream_from_numpy(stream),
        tmesh.make_docs_mesh(4, "cpu", axis="seq"), initial, capacity=cap)
    assert gerr == jerr == 0
    assert sum(sh.n for sh in got.shards) > cap
    _same_shards(got, want)
    assert state_digest(got.annotated_spans()) == jax_digest(
        _single(stream, initial).annotated_spans())


@pytest.mark.parametrize("n_shards", [2, 5, 8])
def test_skewed_boundaries(n_shards):
    """All edits land in one shard's range: the spec and the sharded
    replay still converge to the single document."""
    n_ops, initial = 200, 100
    stream = generate_lagged_stream(n_ops, n_clients=4, seed=7, window=24,
                                    initial_len=initial)
    want = jax_digest(_single(stream, initial).annotated_spans())
    tstream = interop.stream_from_numpy(stream)
    spec = SeqShardedOverlay(tstream, n_shards, initial_len=initial,
                             n_removers=10)
    spec.replay()
    spec.check_errors()
    assert state_digest(spec.annotated_spans()) == want
    got, gerr = tss.run_sequence_sharded(
        tstream, tmesh.make_docs_mesh(n_shards, "cpu", axis="seq"), initial,
        capacity=1024)
    assert gerr == 0
    assert state_digest(got.annotated_spans()) == want


def test_capacity_overflow_flagged_alike():
    """Shards too small for the window: both flag ERR_CAPACITY, in the
    same shards, with the same rows kept."""
    _need(2)
    initial = 40
    stream = generate_lagged_stream(160, n_clients=6, seed=5, window=48,
                                    initial_len=initial)
    want, jerr = jss.run_sequence_sharded(
        stream, jmesh.make_docs_mesh(2, axis="seq"), initial, capacity=48)
    got, gerr = tss.run_sequence_sharded(
        interop.stream_from_numpy(stream),
        tmesh.make_docs_mesh(2, "cpu", axis="seq"), initial, capacity=48)
    assert gerr == jerr and gerr & ERR_CAPACITY
    _same_shards(got, want)


def test_replay_surface():
    """`sequence_sharded_replay` takes one state per entry and returns
    the states stacked (a leading shard axis) with the OR of the error
    words; a state count other than the mesh's raises."""
    initial = 24
    stream = interop.stream_from_numpy(generate_lagged_stream(
        60, n_clients=4, seed=9, window=16, initial_len=initial))
    mesh = tmesh.make_docs_mesh(2, "cpu", axis="seq")
    ops = {k: getattr(stream, k) for k in tss.OP_FIELDS}
    states = [tss.make_shard_state(initial // 2, 256, 10, 8, "cpu")
              for _ in range(2)]
    replay = tss.sequence_sharded_replay(mesh, 256, 10, 8)
    out, err = replay(states, ops)
    assert int(err) == 0
    assert out.anchor.shape == (2, 256) and out.n.shape == (2,)
    assert int(out.n.sum()) > 0 and out.S.tolist() == [12, 12]
    with pytest.raises(ValueError, match="3 shards"):
        replay(states + states[:1], ops)


def test_masked_path_on_cpu_matches():
    """The masked form, which CPU and card entries alike run (every
    shard does the masked work of every op), keeps the same shards, row
    for row, as the JAX package's on 3 entries, a count the cases above
    leave out, and the single document's digest."""
    _need(3)
    initial = 30
    stream = generate_lagged_stream(120, n_clients=5, seed=21, window=32,
                                    initial_len=initial)
    want, werr = jss.run_sequence_sharded(
        stream, jmesh.make_docs_mesh(3, axis="seq"), initial, capacity=512)
    got, gerr = tss.run_sequence_sharded(
        interop.stream_from_numpy(stream),
        tmesh.make_docs_mesh(3, "cpu", axis="seq"), initial, capacity=512)
    assert gerr == werr == 0
    _same_shards(got, want)
    assert state_digest(got.annotated_spans()) == jax_digest(
        _single(stream, initial).annotated_spans())
