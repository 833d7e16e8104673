"""Many documents through the port's overlay replay vs the JAX package.

The same seeded streams go through the port on the CPU (plain versions
of the kernel, `device="cpu"`) and through the JAX package (the Pallas
kernel in interpret mode, as tests/test_multichip.py runs it). Tolerance
0: everything is int32.

- `replay_docs` of 4 documents against each document's JAX
  `OverlayDeviceReplica(interpret=True).replay()`: tables field by
  field, logs[:cursor], counts, cursors, the smallest final MSN and the
  OR of the error bits;
- `restore_shard` readouts (text, digest) against the JAX replicas;
- the docs forms of `fold_device`, `pack_partition` and
  `overlay_apply_chunk` against their per-document forms;
- `kernel_geometry` takes every multiple of 1024 and refuses what the
  reference refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.core.overlay_replay import (
    OverlayDeviceReplica as JaxReplica,
)
from fluidframework_tpu.ops import overlay_pallas as jov
from fluidframework_tpu.ops.mergetree_kernel import OpBatch as JOpBatch
from fluidframework_tpu.testing import synthetic as jsyn
from fluidframework_tpu.testing.digest import state_digest as jax_digest
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.overlay_replay import (
    OverlayDeviceReplica,
    replay_docs,
    restore_shard,
    stack_replicas,
)
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.ops.mergetree_kernel import OpBatch
from fluidframework_tpu_torch.ops.zamboni import pack_partition
from fluidframework_tpu_torch.testing.digest import state_digest

TABLE_FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
                "ins_client", "rem_seq", "rem_clients", "props",
                "settled_len", "error")
# As tests/test_multichip.py drives `sharded_overlay_replay`.
N_DOCS, N_OPS, CHUNK, WINDOW = 4, 256, 64, 1024
GEOM = dict(initial_len=12, chunk_size=CHUNK, window=WINDOW, n_removers=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams():
    return [jsyn.generate_lagged_stream(N_OPS, n_clients=6, seed=200 + d,
                                        window=48, initial_len=12)
            for d in range(N_DOCS)]


def _port_rep(stream, **kw):
    return OverlayDeviceReplica(interop.stream_from_numpy(stream),
                                device="cpu", **{**GEOM, **kw})


@pytest.fixture(scope="module")
def docs():
    """The 4 documents: each JAX replica replayed on its own, and the
    port's `replay_docs` of all of them."""
    streams = _streams()
    jreps = []
    for s in streams:
        r = JaxReplica(s, interpret=True, **GEOM)
        r.replay()
        jreps.append(r)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = replay_docs([_port_rep(s) for s in streams])
    finally:
        torch.set_num_threads(n)
    return streams, jreps, out


def test_replay_docs_matches_jax_replicas(docs):
    _, jreps, (tables, logs, counts, cursors, gmsn, gerr) = docs
    assert tables.length.shape == (N_DOCS, WINDOW)
    assert logs.shape[0] == counts.shape[0] == cursors.shape[0] == N_DOCS
    for d, jr in enumerate(jreps):
        t = interop.table_to_numpy(tables.doc(d))
        for f in TABLE_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(jr.table, f)), t[f], err_msg=f"{d} {f}")
        c = int(jr.cursor)
        assert int(cursors[d]) == c > 0
        np.testing.assert_array_equal(np.asarray(jr.counts),
                                      counts[d].numpy())
        np.testing.assert_array_equal(np.asarray(jr.log[:c]),
                                      logs[d, :c].numpy())
    assert int(gmsn) == min(int(np.asarray(jr._msn_by_chunk)[-1])
                            for jr in jreps)
    want_err = 0
    for jr in jreps:
        want_err |= int(jr.table.error)
    assert int(gerr) == want_err == 0


def test_restore_shard_readout_matches_jax(docs):
    streams, jreps, out = docs
    for d, (s, jr) in enumerate(zip(streams, jreps)):
        rep = restore_shard(_port_rep(s), *out[:4], d)
        rep.check_errors()
        rep.verify_invariants()
        assert rep.chunks_done == rep.n_chunks
        assert rep.get_text() == jr.get_text()
        assert state_digest(rep.annotated_spans()) == jax_digest(
            jr.annotated_spans())


def test_stack_replicas_layout():
    """Ops ``[n_chunks, D, B]`` (each chunk one contiguous slice) and
    MSNs ``[n_chunks, D]``, holding each replica's own arrays."""
    reps = [_port_rep(s) for s in _streams()[:2]]
    tables, ops, logs, counts, msns = stack_replicas(reps)
    n_chunks = reps[0].n_chunks
    assert ops.op_type.shape == (n_chunks, 2, CHUNK)
    assert ops.prop_keys.shape == (n_chunks, 2, CHUNK, 1)
    assert ops.seq[1].is_contiguous()
    assert msns.shape == (n_chunks, 2)
    for d, r in enumerate(reps):
        assert torch.equal(ops.pos1[:, d].reshape(-1), r._dev.pos1)
        assert torch.equal(msns[:, d], r._msn_by_chunk)
        assert torch.equal(logs[d], r.log) and torch.equal(counts[d], r.counts)
        assert torch.equal(tables.settled_len[d], r.table.settled_len)


@pytest.mark.parametrize("field,other", [
    ("window", dict(window=2048)), ("chunk_size", dict(chunk_size=32)),
    ("n_removers", dict(n_removers=4)), ("n_prop_keys", dict(n_prop_keys=4))])
def test_stack_replicas_refuses_mismatched_documents(field, other):
    s0, s1 = _streams()[:2]
    with pytest.raises(ValueError, match=field):
        stack_replicas([_port_rep(s0), _port_rep(s1, **other)])


def _mid_replay_tables(streams, k):
    """Each document's table after k chunks, and the chunk k ops."""
    tables, chunks, msns = [], [], []
    for s in streams:
        r = _port_rep(s)
        r.replay(limit_chunks=k)
        tables.append(r.table)
        chunks.append(r._dev.slice(k * CHUNK, (k + 1) * CHUNK))
        msns.append(r._msn_by_chunk[k])
    return tables, chunks, msns


def test_stacked_fold_matches_per_document():
    streams = _streams()
    tables, chunks, msns = _mid_replay_tables(streams, 2)
    applied = [tov.overlay_apply_chunk_ref(t, c)
               for t, c in zip(tables, chunks)]
    stacked = tov.stack_tables(applied)
    out, records, n_rec = tov.fold_device(stacked, torch.stack(msns))
    assert records.shape == (N_DOCS, WINDOW, 5 + 8)
    for d, (t, m) in enumerate(zip(applied, msns)):
        o1, r1, n1 = tov.fold_device(t, m)
        assert int(n_rec[d]) == int(n1)
        torch.testing.assert_close(records[d], r1, rtol=0, atol=0)
        for f in TABLE_FIELDS:
            assert torch.equal(getattr(out, f)[d], getattr(o1, f)), f


def test_stacked_apply_chunk_matches_per_document():
    streams = _streams()
    tables, chunks, _ = _mid_replay_tables(streams, 1)
    stacked_ops = OpBatch(*(
        torch.stack([getattr(c, f) for c in chunks])
        for f in chunks[0].__dataclass_fields__))
    out = tov.overlay_apply_chunk(tov.stack_tables(tables), stacked_ops)
    for d, (t, c) in enumerate(zip(tables, chunks)):
        want = tov.overlay_apply_chunk_ref(t, c)
        got = out.doc(d)
        m = int(want.n_rows)
        assert int(got.n_rows) == m and int(got.error) == int(want.error)
        for f in TABLE_FIELDS[1:-2]:
            assert torch.equal(getattr(got, f)[:m], getattr(want, f)[:m]), f


@pytest.mark.parametrize("C", [1, 7])
def test_stacked_pack_partition_matches_per_document(C):
    rng = np.random.default_rng(17 + C)
    drop = torch.from_numpy(rng.random((3, 1024)) < 0.4)
    cols = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (3, C, 1024), dtype=np.int64)
        .astype(np.int32))
    got = pack_partition(drop, cols)
    for d in range(3):
        assert torch.equal(got[d], pack_partition(drop[d], cols[d]))
    rows = [cols[:, c] for c in range(C)]
    assert torch.equal(pack_partition(drop, rows), got)


def test_kernel_geometry_takes_every_multiple_of_1024():
    for k in range(1, 65):
        assert tov.kernel_geometry(1024 * k, 24, 8) == (k, 32)
    assert tov.kernel_geometry(2048, 1, 1023) == (2, 1024)


def test_kernel_geometry_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        tov.kernel_geometry(1536, 24, 8)
    with pytest.raises(ValueError):
        tov.kernel_geometry(2048, 0, 8)
    with pytest.raises(ValueError):
        OverlayDeviceReplica(interop.stream_from_numpy(_streams()[0]),
                             device="cpu", **{**GEOM, "window": 1536})
    # The reference refuses the window too, before running anything.
    W = 1536
    table = {f: jnp.zeros((W,) if f not in ("n_rows", "settled_len", "error")
                          else (), jnp.int32)
             for f in TABLE_FIELDS if f not in ("rem_clients", "props")}
    table["rem_clients"] = jnp.zeros((W, 4), jnp.int32)
    table["props"] = jnp.zeros((W, 8), jnp.int32)
    ops = JOpBatch(*([jnp.zeros((8,), jnp.int32)] * 8
                     + [jnp.zeros((8, 1), jnp.int32)] * 2))
    with pytest.raises(AssertionError, match="multiple of 1024"):
        jov.overlay_apply_chunk(jov.OverlayTable(**table), ops, True)
