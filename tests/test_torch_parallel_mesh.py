"""The port's docs mesh against the JAX package's `parallel.mesh`.

The same seeded streams go through the port on CPU entries
(``make_docs_mesh(4, "cpu")``: the plain versions of the kernels) and
through the JAX package on the conftest's virtual CPU devices
(``make_docs_mesh(4)``, the Pallas kernel in interpret mode, as
tests/test_multichip.py runs it). Tolerance 0: everything is int32.

- `sharded_overlay_replay_multi` at 4 and 8 documents of 256 ops
  (chunk 64, window 1024), and at 4 documents of 1024 ops (chunk 256)
  where document 0's stream never lets its MSN advance and overflows
  the window (no 256-op stream can: the kernel's smallest window is
  1024 rows), so ``gerr`` is non-zero in both: tables, logs, counts,
  cursors, ``gmsn`` and ``gerr``;
- `sharded_pipeline_step` on 8 documents over 4 entries;
- a docs axis that is not a multiple of the mesh size raises, and
  ``make_docs_mesh()`` with no CUDA raises;
- the mesh's surface (round-robin entries, equality, the shared cache)
  and the collectives (per-bit OR over bits 0..30, min, max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.core.overlay_replay import (
    OverlayDeviceReplica as JaxReplica,
    stack_replicas as jax_stack,
)
from fluidframework_tpu.ops import mergetree_kernel as jmk
from fluidframework_tpu.parallel import mesh as jmesh
from fluidframework_tpu.testing import synthetic as jsyn
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.overlay_replay import (
    OverlayDeviceReplica,
    stack_replicas,
)
from fluidframework_tpu_torch.ops.mergetree_kernel import (
    SegmentTable,
    make_table,
    stack_op_batches,
)
from fluidframework_tpu_torch.parallel import collectives
from fluidframework_tpu_torch.parallel import mesh as tmesh
from fluidframework_tpu_torch.protocol.constants import NO_CLIENT
from fluidframework_tpu_torch.utils import devices

TABLE_FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
                "ins_client", "rem_seq", "rem_clients", "props",
                "settled_len", "error")
SEG_FIELDS = ("n_rows", "buf_start", "length", "ins_seq", "ins_client",
              "rem_seq", "rem_clients", "props", "error")
N_ENTRIES = 4

# (documents, ops per document, chunk, document 0's lag window)
CASES = {
    "4x256": (4, 256, 64, 48),
    "8x256": (8, 256, 64, 48),
    "overflow": (4, 1024, 256, 2000),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} (virtual) devices")


def _streams(D, n_ops, lag0):
    return [jsyn.generate_lagged_stream(
        n_ops, n_clients=6, seed=200 + d, window=lag0 if d == 0 else 48,
        initial_len=12) for d in range(D)]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_overlay_replay_multi_matches_jax(case):
    _need(N_ENTRIES)
    D, n_ops, chunk, lag0 = CASES[case]
    streams = _streams(D, n_ops, lag0)
    geom = dict(initial_len=12, chunk_size=chunk, window=1024, n_removers=10)

    jreps = [JaxReplica(s, interpret=True, **geom) for s in streams]
    for r in jreps:
        r.prepare()
    jstep = jmesh.sharded_overlay_replay_multi(
        jmesh.make_docs_mesh(N_ENTRIES), chunk, interpret=True)
    jt, jlog, jcnt, jcur, jgmsn, jgerr = jstep(*jax_stack(jreps))

    reps = [OverlayDeviceReplica(interop.stream_from_numpy(s), device="cpu",
                                 **geom) for s in streams]
    step = tmesh.sharded_overlay_replay_multi(
        tmesh.make_docs_mesh(N_ENTRIES, "cpu"), chunk)
    tables, logs, counts, cursors, gmsn, gerr = step(*stack_replicas(reps))

    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jt, f)), getattr(tables, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jcur), cursors.numpy())
    np.testing.assert_array_equal(np.asarray(jcnt), counts.numpy())
    for d in range(D):
        c = int(cursors[d])
        np.testing.assert_array_equal(np.asarray(jlog[d, :c]),
                                      logs[d, :c].numpy(), err_msg=str(d))
    assert int(gmsn) == int(jgmsn)
    assert int(gerr) == int(jgerr)
    if case == "overflow":
        assert int(gerr) & jmk.ERR_CAPACITY
        assert int(tables.n_rows[0]) == 1024
    else:
        assert int(gerr) == 0


def _tiny_stream(n_ops, seed):
    return jsyn.generate_stream(n_ops, n_clients=4, seed=seed, window=8,
                                initial_len=8)


def test_sharded_pipeline_step_matches_jax():
    """8 documents of one 16-op chunk each over 4 entries, from the
    table the reference's dry run starts from (one 8-character row)."""
    _need(N_ENTRIES)
    D, n_ops = 8, 16
    streams = [_tiny_stream(n_ops, d) for d in range(D)]
    dmins = [int(s.min_seq[n_ops - 1]) for s in streams]

    one = jmk.make_table(capacity=128, n_removers=4, n_prop_keys=8)
    one = one._replace(n_rows=jnp.int32(1), length=one.length.at[0].set(8),
                       ins_client=one.ins_client.at[0].set(NO_CLIENT))
    jtables = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (D,) + a.shape), one)

    def jbatch(s):
        return jmk.OpBatch(
            op_type=jnp.asarray(s.op_type[:n_ops]),
            pos1=jnp.asarray(s.pos1[:n_ops]), pos2=jnp.asarray(s.pos2[:n_ops]),
            seq=jnp.asarray(s.seq[:n_ops]),
            ref_seq=jnp.asarray(s.ref_seq[:n_ops]),
            client=jnp.asarray(s.client[:n_ops]),
            buf_start=jnp.asarray(s.buf_start[:n_ops]),
            ins_len=jnp.asarray(s.ins_len[:n_ops]),
            prop_keys=jnp.asarray(s.prop_key[:n_ops, None]),
            prop_vals=jnp.asarray(s.prop_val[:n_ops, None]))

    jmesh_ = jmesh.make_docs_mesh(N_ENTRIES)
    jops = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *[jbatch(s) for s in streams])
    jout, jgmin, jerr = jmesh.sharded_pipeline_step(jmesh_)(
        jmesh.shard_tables(jtables, jmesh_), jops,
        jnp.asarray(dmins, jnp.int32))

    t1 = make_table(capacity=128, n_removers=4, n_prop_keys=8, device="cpu")
    t1.n_rows = torch.tensor(1, dtype=torch.int32)
    t1.length[0] = 8
    t1.ins_client[0] = NO_CLIENT
    tables = SegmentTable(*(getattr(t1, f).expand(
        (D,) + getattr(t1, f).shape).contiguous() for f in SEG_FIELDS))
    ops = stack_op_batches([interop.opbatch_from_numpy(dict(
        op_type=s.op_type[:n_ops], pos1=s.pos1[:n_ops], pos2=s.pos2[:n_ops],
        seq=s.seq[:n_ops], ref_seq=s.ref_seq[:n_ops],
        client=s.client[:n_ops], buf_start=s.buf_start[:n_ops],
        ins_len=s.ins_len[:n_ops], prop_keys=s.prop_key[:n_ops, None],
        prop_vals=s.prop_val[:n_ops, None]), "cpu") for s in streams])
    mesh = tmesh.make_docs_mesh(N_ENTRIES, "cpu")
    out, gmin, err = tmesh.sharded_pipeline_step(mesh)(
        tmesh.shard_tables(tables, mesh), ops,
        torch.tensor(dmins, dtype=torch.int32))
    for f in SEG_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jout, f)),
                                      getattr(out, f).numpy(), err_msg=f)
    assert int(gmin) == int(jgmin) == min(dmins)
    assert int(err) == int(jerr) == 0
    assert bool(torch.all(out.n_rows > 1))


@pytest.mark.parametrize("what", ["replay", "pipeline", "tensor"])
def test_docs_axis_not_a_multiple_raises(what):
    mesh = tmesh.make_docs_mesh(4, "cpu")
    if what == "tensor":
        with pytest.raises(ValueError, match="not a multiple"):
            mesh.shard(torch.zeros(6, 3))
        return
    if what == "replay":
        streams = [interop.stream_from_numpy(s)
                   for s in _streams(3, 128, 48)]
        reps = [OverlayDeviceReplica(s, initial_len=12, chunk_size=64,
                                     window=1024, device="cpu")
                for s in streams]
        with pytest.raises(ValueError, match="not a multiple"):
            tmesh.sharded_overlay_replay_multi(mesh, 64)(
                *stack_replicas(reps))
        return
    t1 = make_table(capacity=16, n_removers=2, n_prop_keys=2, device="cpu")
    tables = SegmentTable(*(getattr(t1, f).expand(
        (6,) + getattr(t1, f).shape).contiguous() for f in SEG_FIELDS))
    with pytest.raises(ValueError, match="not a multiple"):
        tmesh.sharded_pipeline_step(mesh)(tables, None,
                                          torch.zeros(6, dtype=torch.int32))


def test_make_docs_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmesh.make_docs_mesh(),
                 lambda: tmesh.make_docs_mesh(4),
                 lambda: tmesh.shared_docs_mesh(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tmesh.make_docs_mesh(3, "cpu").platform == "cpu"


def test_mesh_surface(monkeypatch):
    mesh = tmesh.make_docs_mesh(3, "cpu", axis="seq")
    assert mesh.size == 3 and mesh.axis == "seq"
    assert mesh.describe() == {"axis": "seq", "size": 3, "platform": "cpu",
                               "entries": ["cpu"] * 3, "cards": ["cpu"]}
    assert mesh == tmesh.DocsMesh(["cpu"] * 3, "seq")
    assert hash(mesh) == hash(tmesh.DocsMesh(["cpu"] * 3, "seq"))
    assert mesh != tmesh.DocsMesh(["cpu"] * 3, "docs")
    assert tmesh.shared_docs_mesh(2, "cpu") is tmesh.shared_docs_mesh(
        2, "cpu")
    with pytest.raises(ValueError):
        tmesh.DocsMesh([])
    with pytest.raises(ValueError):
        tmesh.DocsMesh(["cpu", "meta"])
    # Round-robin over the visible cards (no card is touched to build
    # the entries).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m5 = tmesh.make_docs_mesh(5)
    assert [str(e) for e in m5.entries] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:0"]
    assert m5.describe()["cards"] == ["cuda:0", "cuda:1"]
    assert tmesh.make_docs_mesh().size == 2
    assert set(tmesh.make_docs_mesh(3, "cuda:1").entries) == {
        torch.device("cuda", 1)}


def test_shard_and_gather_round_trip():
    mesh = tmesh.make_docs_mesh(4, "cpu")
    x = torch.arange(24, dtype=torch.int32).reshape(8, 3)
    slabs = mesh.shard(x)
    assert len(slabs) == 4 and all(s.shape == (2, 3) for s in slabs)
    assert mesh.shard(slabs) is slabs
    assert torch.equal(mesh.gather(slabs), x)
    y = torch.arange(16).reshape(2, 8)
    assert torch.equal(mesh.gather(mesh.shard(y, dim=1), dim=1), y)
    slabs[0][0, 0] = 99  # slabs are copies, not views of the input
    assert int(x[0, 0]) == 0


@pytest.mark.parametrize("words", [
    [[0, 1], [4, 0]], [[2 ** 30], [3, 2 ** 31 - 1]], [[0], [0], [0]],
    [[-1], [0]]])
def test_collectives(words):
    parts = [torch.tensor(w, dtype=torch.int32) for w in words]
    want = 0
    for w in words:
        for v in w:
            want |= v & (2 ** 31 - 1)  # bits 0..30, as the reference
    assert int(collectives.por(parts)) == want
    mins = [torch.tensor(min(w), dtype=torch.int32) for w in words]
    assert int(collectives.pmin(mins)) == min(min(w) for w in words)
    assert int(collectives.pmax(mins)) == max(min(w) for w in words)
    g = collectives.all_gather(mins)
    assert g.tolist() == [min(w) for w in words]


@pytest.mark.parametrize("cuda,cards,cores", [
    (False, 0, 4), (False, 0, 1), (True, 1, 64), (True, 4, 64)])
def test_visible_devices_and_parity_skip_reason(monkeypatch, cuda, cards,
                                                cores):
    """Cards where CUDA is available, else cores; and a reason to skip a
    scaling figure exactly where the mesh has more entries than that."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(devices.os, "cpu_count", lambda: cores)
    platform, count = devices.visible_devices()
    assert (platform, count) == (("cuda", cards) if cuda else ("cpu", cores))
    unit = "card" if cuda else "core"
    for n in (1, count, count + 1, 8):
        reason = devices.parity_skip_reason(n)
        if n <= count:
            assert reason is None
        else:
            assert reason.startswith(f"{n} mesh entries on {count} {unit}")
            assert "not a multi-device scaling figure" in reason
