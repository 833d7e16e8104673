"""The port's device plane against the JAX package's
`parallel.device_plane`.

- spec parsing and its errors, equal to the JAX package's;
- the process-wide cache, `resolve_plane` and `PLANE_ENV`;
- `plane_column_of` equal to the JAX package's for ints and strings;
- the typed slices: `seq_mesh(column)` takes model column ``column %
  model`` in the docs-major entry order the JAX plane uses, the fold
  placement covers the whole plane docs-major, and a plane with no
  CUDA and no explicit ``"cpu"`` raises;
- the sequencer on a plane slice (`mesh_for_plane`, partition-key
  routing) gives the single-device pool's verdicts.
"""

import random

import jax
import pytest
import torch

from fluidframework_tpu.parallel import device_plane as jdp
from fluidframework_tpu_torch.ops.sequencer_kernel import (
    NO_GROUP,
    SUB_JOIN,
    SUB_OP,
)
from fluidframework_tpu_torch.parallel import device_plane as tdp
from fluidframework_tpu_torch.server.deli_kernel import (
    PackedDeliCore,
    mesh_for_plane,
)

SPECS = ["2x2", "4X2", "2*3", (3, 1), " 1x8", "8x1"]
BAD_SPECS = ["4", "0x2", "2x0", "axb", "2x2x2", (0, 1)]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_plane_spec_matches_jax(spec):
    assert tdp.parse_plane_spec(spec) == jdp.parse_plane_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_plane_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jdp.parse_plane_spec(spec)
    with pytest.raises(ValueError) as got:
        tdp.parse_plane_spec(spec)
    assert str(got.value) == str(want.value)


def test_shared_plane_cache_and_resolve():
    plane = tdp.shared_plane(2, 2, "cpu")
    assert tdp.shared_plane(2, 2, "cpu") is plane
    assert tdp.resolve_plane("2x2", device="cpu") is plane
    assert tdp.resolve_plane((2, 2), device="cpu") is plane
    assert tdp.resolve_plane(plane) is plane
    assert tdp.resolve_plane(None) is None
    assert tdp.shared_plane(2, 1, "cpu") is not plane
    assert plane.size == 4 and plane.spec() == "2x2"
    d = plane.describe()
    assert (d["docs"], d["model"], d["devices"], d["platform"]) == (
        2, 2, 4, "cpu")


def test_plane_env(monkeypatch):
    assert tdp.PLANE_ENV == jdp.PLANE_ENV == "FLUID_DEVICE_PLANE"
    monkeypatch.setenv(tdp.PLANE_ENV, "2x2")
    assert tdp.resolve_plane(None, env=True, device="cpu") is \
        tdp.shared_plane(2, 2, "cpu")
    assert tdp.resolve_plane(None, env=False, device="cpu") is None
    monkeypatch.setenv(tdp.PLANE_ENV, "")
    assert tdp.resolve_plane(None, env=True, device="cpu") is None
    monkeypatch.delenv(tdp.PLANE_ENV)
    assert tdp.resolve_plane(None, env=True, device="cpu") is None


@pytest.mark.parametrize("model", [1, 2, 3, 4, 7])
def test_plane_column_of_matches_jax(model):
    keys = [0, 1, 2, 3, 9, 17, 2 ** 31 - 1, True, "w1", "deli-r0-7fffffff",
            "doc-42", "", "partition/3"]
    for key in keys:
        assert tdp.plane_column_of(key, model) == jdp.plane_column_of(
            key, model), key
    assert tdp.plane_column_of(5, 0) == jdp.plane_column_of(5, 0) == 0


@pytest.mark.parametrize("docs,model", [(2, 2), (2, 3), (4, 2), (1, 4)])
def test_seq_mesh_columns_match_jax(docs, model):
    """Each column's entries, in the JAX plane's docs-major order: the
    port plane over labelled devices against the JAX plane over the
    conftest's virtual devices, compared by entry index."""
    if len(jax.devices()) < docs * model:
        pytest.skip(f"needs {docs * model} (virtual) devices")
    jplane = jdp.DevicePlane(docs, model)
    jidx = {d.id: i for i, d in enumerate(jplane.mesh.devices.flat)}
    labels = [torch.device("cuda", i) for i in range(docs * model)]
    plane = tdp.DevicePlane(docs, model, devices=labels)
    for col in range(model + 2):
        mesh = plane.seq_mesh(col)
        assert mesh is plane.seq_mesh(col)  # cached per column
        assert mesh.axis == "docs" and mesh.size == docs
        want = [jidx[d.id] for d in jplane.seq_mesh(col).devices.flat]
        assert [e.index for e in mesh.entries] == want
    # The columns tile the plane with no overlap.
    cols = [set(plane.seq_mesh(c).entries) for c in range(model)]
    assert set().union(*cols) == set(labels)
    assert sum(map(len, cols)) == len(labels)
    fold = plane.fold_sharding()
    assert fold.entries == tuple(labels) and fold.size == plane.size
    assert plane.doc_sharding() is fold
    assert (plane.fold_spec(),) == tuple(jplane.fold_spec())


def test_plane_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.DevicePlane(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.resolve_plane("3x1")
    with pytest.raises(ValueError, match="needs 4 entries"):
        tdp.DevicePlane(2, 2, devices=["cpu"] * 3)


def _drive(core, seed, pumps=3, per_pump=60, docs=6, clients=4):
    rng = random.Random(seed)
    out = []
    for _ in range(pumps):
        core.begin()
        for _ in range(per_pump):
            h = core.touch(f"doc{rng.randrange(docs)}")
            if rng.random() < 0.2:
                core.add(h["slot"], SUB_JOIN, core.pool.col_of_join(
                    h, rng.randrange(1, clients + 1)))
            else:
                core.add(h["slot"], SUB_OP, rng.randrange(0, clients + 1),
                         rng.randrange(1, 6), rng.randrange(0, 4), NO_GROUP)
        res = core.run()
        out.append((res.seq, res.msn, res.nack, res.skipped))
    return out


def test_plane_slice_core_and_partition_routing():
    single = _drive(PackedDeliCore(dedup=True, device="cpu"), 51)
    plane = tdp.shared_plane(2, 2, "cpu")
    for key in (0, 1, "w1"):
        mesh = mesh_for_plane("2x2", partition_key=key, device="cpu")
        assert mesh is plane.seq_mesh(tdp.plane_column_of(key, 2))
        core = PackedDeliCore(dedup=True, mesh=mesh)
        assert _drive(core, 51) == single
        assert core.pool._n_shards == 2
    assert mesh_for_plane("2x2", plane_column=1, device="cpu") is \
        plane.seq_mesh(1)
    assert mesh_for_plane(None) is None
