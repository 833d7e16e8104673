"""The port's whole overlay replay slice vs the JAX package's.

- `generate_stream` / `generate_lagged_stream` of the port give the
  JAX package's arrays exactly;
- `OverlayDeviceReplica(device="cpu")` of the port vs the JAX
  `OverlayDeviceReplica(interpret=True)`: counts, cursor, log[:cursor],
  the final table, text and digest, and the digest against the scalar
  oracle `core.mergetree.replay_passive`;
- interop: a table the JAX engine produced mid-replay is continued by
  the port (and the other way round) to the same final digest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.core.mergetree import replay_passive
from fluidframework_tpu.core.overlay_replay import (
    OverlayDeviceReplica as JaxReplica,
)
from fluidframework_tpu.ops import overlay_pallas as jov
from fluidframework_tpu.testing import synthetic as jsyn
from fluidframework_tpu.testing.digest import state_digest as jax_digest
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.overlay_replay import (
    OverlayDeviceReplica,
    reconstruct_settled,
)
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.testing import synthetic as tsyn
from fluidframework_tpu_torch.testing.digest import (
    normalize_spans,
    state_digest,
)

INITIAL = 64
GEOM = dict(initial_len=INITIAL, chunk_size=128, window=1024,
            n_removers=8)
TABLE_FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
                "ins_client", "rem_seq", "rem_clients", "props",
                "settled_len", "error")


def _assert_streams_equal(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_lagged_stream_equals_jax():
    kw = dict(n_clients=64, seed=7, window=1024, initial_len=INITIAL)
    _assert_streams_equal(jsyn.generate_lagged_stream(5000, **kw),
                          tsyn.generate_lagged_stream(5000, **kw))


def test_stream_equals_jax():
    kw = dict(n_clients=32, seed=3, window=256, initial_len=INITIAL)
    _assert_streams_equal(jsyn.generate_stream(3000, **kw),
                          tsyn.generate_stream(3000, **kw))


def test_lagged_stream_cache_roundtrip(tmp_path):
    kw = dict(n_clients=16, seed=2, window=128, initial_len=INITIAL,
              cache_dir=str(tmp_path))
    first = tsyn.generate_lagged_stream(400, **kw)
    assert list(tmp_path.iterdir())
    _assert_streams_equal(first, tsyn.generate_lagged_stream(400, **kw))


@pytest.fixture(scope="module")
def lagged():
    """A ~2k-op lagged stream and both engines' replicas of it."""
    jstream = jsyn.generate_lagged_stream(
        2048, n_clients=64, seed=5, window=512, initial_len=INITIAL)
    jrep = JaxReplica(jstream, interpret=True, **GEOM)
    jrep.replay()
    trep = OverlayDeviceReplica(
        interop.stream_from_numpy(jstream), device="cpu", **GEOM)
    trep.replay()
    return jstream, jrep, trep


def test_replica_log_and_table_match_jax(lagged):
    _, jrep, trep = lagged
    jrep.check_errors()
    trep.check_errors()
    assert int(jrep.cursor) == int(trep.cursor) > 0
    np.testing.assert_array_equal(np.asarray(jrep.counts),
                                  trep.counts.numpy())
    c = int(trep.cursor)
    np.testing.assert_array_equal(np.asarray(jrep.log[:c]),
                                  trep.log[:c].numpy())
    t = interop.table_to_numpy(trep.table)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jrep.table, f)),
                                      t[f], err_msg=f)


def test_replica_readout_matches_jax_and_oracle(lagged):
    jstream, jrep, trep = lagged
    trep.verify_invariants()
    assert trep.get_text() == jrep.get_text()
    spans = trep.annotated_spans()
    digest = state_digest(spans)
    assert digest == jax_digest(jrep.annotated_spans())
    assert trep.attribution_spans() == jrep.attribution_spans()
    oracle = replay_passive(
        jstream.as_messages(),
        initial="".join(map(chr, jstream.text[:INITIAL])),
    )
    assert trep.get_text() == oracle.get_text()
    assert digest == jax_digest(oracle.annotated_spans())
    assert normalize_spans(spans)


def test_replica_incremental_matches_fused(lagged):
    jstream, _, trep = lagged
    inc = OverlayDeviceReplica(
        interop.stream_from_numpy(jstream), device="cpu", **GEOM)
    inc.replay(limit_chunks=inc.n_chunks)
    assert inc.chunks_done == trep.chunks_done
    assert int(inc.cursor) == int(trep.cursor)
    assert state_digest(inc.annotated_spans()) == state_digest(
        trep.annotated_spans())


def test_capacity_overflow_raises():
    stream = tsyn.generate_stream(1500, n_clients=64, seed=3,
                                  initial_len=INITIAL, window=2048)
    rep = OverlayDeviceReplica(stream, initial_len=INITIAL,
                               chunk_size=256, window=1024, device="cpu")
    rep.replay()
    with pytest.raises(RuntimeError, match="capacity overflow"):
        rep.check_errors()


def _jax_state(rep):
    return ({f: np.asarray(getattr(rep.table, f)) for f in TABLE_FIELDS},
            np.asarray(rep.log), np.asarray(rep.counts), int(rep.cursor))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_interop_mid_replay_handoff(lagged, direction):
    jstream, jrep, _ = lagged
    want = jax_digest(jrep.annotated_spans())
    k = 7  # chunks replayed by the first engine
    if direction == "jax_to_torch":
        first = JaxReplica(jstream, interpret=True, **GEOM)
        first.replay(limit_chunks=k)
        table, log, counts, cursor = _jax_state(first)
        rep = OverlayDeviceReplica(
            interop.stream_from_numpy(jstream), device="cpu", **GEOM)
        rep.prepare()
        rep.table = interop.table_from_numpy(table, device="cpu")
        rep.log = torch.from_numpy(log.copy())
        rep.counts = torch.from_numpy(counts.copy())
        rep.cursor = torch.tensor(cursor, dtype=torch.int32)
        for ci in range(k, rep.n_chunks):
            rep.table, rep.log, rep.counts, rep.cursor = (
                tov.replay_chunk_step(
                    rep.table, rep._dev, ci * rep.chunk_size,
                    rep.chunk_size, rep._msn_by_chunk[ci], rep.log,
                    rep.counts, rep.cursor, ci))
        rep.chunks_done = rep.n_chunks
        got = state_digest(rep.annotated_spans())
    else:
        first = OverlayDeviceReplica(
            interop.stream_from_numpy(jstream), device="cpu", **GEOM)
        first.replay(limit_chunks=k)
        rep = JaxReplica(jstream, interpret=True, **GEOM)
        rep.prepare()
        rep.table = jov.OverlayTable(**{
            f: jnp.asarray(v)
            for f, v in interop.table_to_numpy(first.table).items()})
        rep.log = jnp.asarray(first.log.numpy())
        rep.counts = jnp.asarray(first.counts.numpy())
        rep.cursor = jnp.int32(int(first.cursor))
        for ci in range(k, rep.n_chunks):
            rep.table, rep.log, rep.counts, rep.cursor = (
                jov.replay_chunk_step(
                    rep.table, rep._dev, jnp.int32(ci * rep.chunk_size),
                    rep.chunk_size, rep._msn_by_chunk[ci], rep.log,
                    rep.counts, rep.cursor, jnp.int32(ci), True))
        rep.chunks_done = rep.n_chunks
        got = jax_digest(rep.annotated_spans())
    assert got == want


def test_reconstruct_settled_empty_log():
    text = np.arange(97, 107, dtype=np.int32)
    t, p, a = reconstruct_settled(text, text, np.zeros((0, 13), np.int32),
                                  [0, 0], 8)
    np.testing.assert_array_equal(t, text)
    assert p.shape == (10, 8) and (p == -1).all()
    assert (a == 0).all()
