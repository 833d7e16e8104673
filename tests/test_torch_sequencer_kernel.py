"""The port's sequencer (`fluidframework_tpu_torch.ops.sequencer_kernel`,
plain version on the CPU) against the JAX package's, tolerance 0.

Same inputs, made from a seed with `random.Random` and numpy, go
through the JAX `sequence_batch` / `_sequence_batch_impl` scan
(``JAX_PLATFORMS=cpu``) and the port's `sequence_batch` /
`sequence_batch_grouped` (``device="cpu"``); the new state, the abort
tracker and all four verdict planes must be equal. Covers the random
traffic of tests/test_sequencer_kernel.py (every nack code), every
case of that file, the abort tracker threaded across chunks with and
without dedup, `pack_submissions` on spilling input, and `interop`
moving a JAX state into the port and back.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import sequencer_kernel as jsk
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
from fluidframework_tpu_torch.testing.deli_streams import (
    edge_chunks,
    gen_traffic,
    traffic_batch,
)

CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _jax_impl(dedup):
    return jax.jit(functools.partial(jsk._sequence_batch_impl, dedup=dedup))


def _jax_chunk(jstate, jaborted, cols, dedup):
    kind, client, cseq, ref, groups = (jnp.asarray(c) for c in cols)
    return _jax_impl(dedup)(jstate, jaborted,
                            jsk.SeqBatch(kind, client, cseq, ref), groups)


def _port_chunk(state, aborted, cols, dedup):
    kind, client, cseq, ref, groups = (torch.from_numpy(c) for c in cols)
    return tsk.sequence_batch_grouped(
        state, tsk.SeqBatch(kind, client, cseq, ref), groups, dedup, aborted)


def _assert_state_equal(port, jax_state):
    got = interop.sequencer_state_to_numpy(port)
    for name in tsk.SequencerState._fields:
        want = np.asarray(getattr(jax_state, name))
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def _assert_result_equal(port, jres):
    for name in tsk.SeqResult._fields:
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(jres, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _both(n_docs, n_clients, cols, dedup=False):
    """One chunk from a fresh state through both packages."""
    state = tsk.make_state(n_docs, n_clients, CPU)
    jstate = jsk.make_state(n_docs, n_clients)
    aborted = tsk.no_aborts(n_docs, CPU)
    st, ab, res = _port_chunk(state, aborted, cols, dedup)
    jst, jab, jres = _jax_chunk(jstate, jsk.no_aborts(n_docs), cols, dedup)
    _assert_state_equal(st, jst)
    _assert_result_equal(res, jres)
    np.testing.assert_array_equal(ab.numpy(), np.asarray(jab))
    return st, res


def _cols(kind, client, cseq, ref, groups=None):
    kind = np.asarray(kind, np.int32)
    if groups is None:
        groups = np.full(kind.shape, jsk.NO_GROUP, np.int32)
    return [kind, np.asarray(client, np.int32), np.asarray(cseq, np.int32),
            np.asarray(ref, np.int32), np.asarray(groups, np.int32)]


@pytest.mark.parametrize("seed,dedup", [(0, False), (1, False), (2, False),
                                        (3, True), (4, True)])
def test_random_traffic_matches_jax(seed, dedup):
    rng = random.Random(seed)
    n_docs, n_clients, n_ops = 8, 8, 200
    traffic = [gen_traffic(rng, n_ops, n_clients) for _ in range(n_docs)]
    st, res = _both(n_docs, n_clients, _cols(*traffic_batch(traffic)), dedup)
    nacks = set(res.nack.flatten().tolist())
    if not dedup:
        assert {400, 403, 416, 422} <= nacks, nacks


def test_sequence_batch_matches_jax_entry():
    """The port's `sequence_batch` (fresh tracker, default groups)
    equals the JAX `sequence_batch` on the same batch."""
    rng = random.Random(11)
    traffic = [gen_traffic(rng, 64, 4) for _ in range(5)]
    kind, client, cseq, ref = traffic_batch(traffic)
    st, res = tsk.sequence_batch(
        tsk.make_state(5, 4, CPU),
        tsk.SeqBatch(*(torch.from_numpy(a) for a in (kind, client, cseq,
                                                     ref))))
    jst, jres = jsk.sequence_batch(
        jsk.make_state(5, 4),
        jsk.SeqBatch(*(jnp.asarray(a) for a in (kind, client, cseq, ref))))
    _assert_state_equal(st, jst)
    _assert_result_equal(res, jres)


def test_boxcar_group_nack_masks_tail():
    cols = _cols([[jsk.SUB_JOIN] + [jsk.SUB_OP] * 4], [[1] * 5],
                 [[0, 1, 5, 2, 2]], [[0] * 5],
                 [[jsk.NO_GROUP, 0, 0, 0, 1]])
    st, res = _both(1, 4, cols)
    assert res.nack[0].tolist() == [0, 0, tsk.NACK_OUT_OF_ORDER, 0, 0]
    assert res.skipped[0].tolist() == [False, False, False, True, False]
    assert res.seq[0].tolist() == [1, 2, 0, 0, 3]
    assert int(st.seq[0]) == 3


def test_dedup_mode_drops_resubmissions_silently():
    cols = _cols([[jsk.SUB_JOIN] + [jsk.SUB_OP] * 4], [[1, 1, 1, 1, 2]],
                 [[0, 1, 1, 2, 1]], [[0] * 5])
    _, res = _both(1, 4, cols, dedup=True)
    assert res.skipped[0].tolist() == [False, False, True, False, False]
    assert res.nack[0].tolist() == [0, 0, 0, 0, tsk.NACK_UNKNOWN_CLIENT]
    assert res.seq[0].tolist() == [1, 2, 0, 3, 0]


def test_system_stamp_bypasses_validation():
    cols = _cols([[jsk.SUB_SYSTEM, jsk.SUB_JOIN, jsk.SUB_SYSTEM]],
                 [[0, 2, 0]], [[0, 0, 0]], [[0, 0, 0]])
    st, res = _both(1, 4, cols)
    assert res.seq[0].tolist() == [1, 2, 3]
    assert res.min_seq[0].tolist() == [1, 1, 1]
    assert not bool(st.connected[0, 0])


def test_grow_state_preserves_and_pads():
    cols = _cols([[jsk.SUB_JOIN], [jsk.SUB_JOIN]], [[1], [0]], [[0], [0]],
                 [[0], [0]])
    st, _ = _both(2, 2, cols)
    grown = tsk.grow_state(st, 4, 8)
    jst = jsk.make_state(2, 2)
    jst, _ = jsk.sequence_batch(jst, jsk.SeqBatch(
        *(jnp.asarray(c) for c in cols[:4])))
    _assert_state_equal(grown, jsk.grow_state(jst, 4, 8))
    assert grown.connected.shape == (4, 8)
    assert grown.seq.tolist() == [1, 1, 0, 0]
    assert bool(grown.connected[0, 1]) and bool(grown.connected[1, 0])
    assert not bool(grown.connected[2, 0])
    assert tsk.grow_state(grown, 3, 4) is grown


def test_empty_doc_msn_trails_head():
    cols = _cols([[jsk.SUB_JOIN, jsk.SUB_OP, jsk.SUB_LEAVE]], [[2, 2, 2]],
                 [[0, 1, 0]], [[0, 1, 0]])
    st, _ = _both(1, 4, cols)
    assert int(st.seq[0]) == 3
    assert int(st.min_seq[0]) == 3


@pytest.mark.parametrize("seed,dedup", [(0, False), (1, True), (2, True)])
def test_aborted_threads_across_chunks(seed, dedup):
    """Grouped edge traffic (boxcars spanning chunk boundaries, dedup
    resubmissions, system stamps, out-of-range client slots) in chunks
    of 8: state, tracker and verdicts equal after every chunk."""
    n_docs, n_clients = 13, 8
    chunks = edge_chunks(seed, n_docs, n_clients, 96, 8)
    state = tsk.make_state(n_docs, n_clients, CPU)
    aborted = tsk.no_aborts(n_docs, CPU)
    jstate, jaborted = jsk.make_state(n_docs, n_clients), jsk.no_aborts(n_docs)
    carried = 0
    for cols in chunks:
        # a group still open from the last chunk, already aborted
        carried += int(((cols[4] >= 0)
                        & (cols[4] == aborted.numpy()[:, None])).sum())
        state, aborted, res = _port_chunk(state, aborted, cols, dedup)
        jstate, jaborted, jres = _jax_chunk(jstate, jaborted, cols, dedup)
        _assert_state_equal(state, jstate)
        _assert_result_equal(res, jres)
        np.testing.assert_array_equal(aborted.numpy(), np.asarray(jaborted))
    assert carried > 0, "no boxcar abort crossed a chunk boundary"


def test_pack_submissions_matches_jax_on_spilling_input():
    rng = np.random.default_rng(3)
    n = 300
    slot = rng.integers(0, 7, n)
    kind = rng.integers(0, 5, n)
    client = rng.integers(-2, 9, n)
    cseq = rng.integers(0, 50, n)
    ref = rng.integers(-1, 50, n)
    grp = rng.integers(-1, 4, n)
    port = list(tsk.pack_submissions(slot, kind, client, cseq, ref, grp,
                                     n_docs=9, max_cols=8))
    ref_chunks = list(jsk.pack_submissions(slot, kind, client, cseq, ref,
                                           grp, n_docs=9, max_cols=8))
    assert len(port) == len(ref_chunks) > 1
    for a, b in zip(port, ref_chunks):
        for x, y in zip(a, b):
            if isinstance(x, slice):
                assert x == y
            else:
                np.testing.assert_array_equal(x, y)
                assert np.asarray(x).dtype == np.asarray(y).dtype


def test_interop_moves_jax_state_in_and_back():
    """A state the JAX sequencer left mid-stream continues in the port
    exactly as in JAX, and the port's state goes back to JAX."""
    rng = random.Random(21)
    traffic = [gen_traffic(rng, 48, 8) for _ in range(6)]
    kind, client, cseq, ref = traffic_batch(traffic)
    first = _cols(kind[:, :24], client[:, :24], cseq[:, :24], ref[:, :24])
    second = _cols(kind[:, 24:], client[:, 24:], cseq[:, 24:], ref[:, 24:])
    jst, jab, _ = _jax_chunk(jsk.make_state(6, 8), jsk.no_aborts(6), first,
                             False)
    st = interop.sequencer_state_from_numpy(jst._asdict(), CPU)
    _assert_state_equal(st, jst)
    st, ab, res = _port_chunk(st, torch.from_numpy(np.array(jab)), second,
                              False)
    jst, jab, jres = _jax_chunk(jst, jab, second, False)
    _assert_state_equal(st, jst)
    _assert_result_equal(res, jres)
    back = jsk.SequencerState(**{k: jnp.asarray(v) for k, v in
                                 interop.sequencer_state_to_numpy(st).items()})
    for name in jsk.SequencerState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jst, name)))


def test_plain_version_takes_cpu_tensors_only():
    state = tsk.make_state(2, 4, CPU)
    batch = tsk.SeqBatch(*(torch.zeros((2, 8), dtype=torch.int32)
                           for _ in range(4)))
    groups = torch.full((2, 8), tsk.NO_GROUP, dtype=torch.int32)
    meta = tsk.SequencerState(*(t.to("meta") for t in state))
    with pytest.raises(ValueError, match="CPU tensors only"):
        tsk.sequence_batch_ref(meta, tsk.no_aborts(2, CPU).to("meta"),
                               batch, groups)
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.sequence_batch(meta, tsk.SeqBatch(*(t.to("meta")
                                                for t in batch)))
