"""The summary service's folds over the device plane: the port's
`SummarizerRole(device_plane=...)` against the JAX role with the same
plane, and against itself without one.

On the CPU (``device="cpu"``: the plain versions of kernel A, the fold
and the scan; the plane's entries are CPU entries, the JAX plane's the
conftest's virtual devices), the tolerance exact (bytes):

- both fold backends with a ``2x2`` and a ``4x2`` plane over columnar
  topics: the ``summaries`` topic, every blob file and the checkpoint
  are byte for byte those of the port's role without a plane and of the
  JAX role (kernel backend) with the same plane; the stacked rounds go
  through the placed paths (the overlay backend's dummy-padded
  `sharded_overlay_replay_multi`, the kernel backend's
  `sharded_apply_docs` where the reference's condition holds) and ``summary_plane_folds_total``
  counts them;
- stacks of 3 documents (not a multiple of either plane's size) and of
  4;
- ``FLUID_DEVICE_PLANE`` as the fallback when no plane is passed;
- the supervisor's child seams: ``--device-plane`` reaches the
  summarizer and the kernel deli, ``--deli-devices`` the kernel deli,
  and the reference's conflicts stay loud.
"""

import json
import os

import pytest
import torch

from fluidframework_tpu.server import summarizer as jsum
from fluidframework_tpu_torch.core import overlay_fold as tof
from fluidframework_tpu_torch.parallel.device_plane import PLANE_ENV
from fluidframework_tpu_torch.server import summary_fold as tsf
from fluidframework_tpu_torch.server import supervisor as tsup
from fluidframework_tpu_torch.server.deli_kernel import KernelDeliRole
from fluidframework_tpu_torch.server.summarizer import SummarizerRole
from fluidframework_tpu_torch.testing.catchup_streams import write_deltas
from fluidframework_tpu_torch.testing.fold_streams import (
    build_mergetree_stream,
)

FMT = "columnar"
PLANES = ("2x2", "4x2")


def _interleave(*streams):
    out = []
    for i in range(max(len(s) for s in streams)):
        out += [s[i] for s in streams if i < len(s)]
    return out


STREAMS = {
    "stacked3": (lambda: _interleave(*(
        build_mergetree_stream(70, n_clients=2, seed=s, doc=f"d{s}")
        for s in (5, 6, 7))), 24),
    "stacked4": (lambda: _interleave(*(
        build_mergetree_stream(60, n_clients=3, seed=s, doc=f"e{s}")
        for s in (21, 22, 23, 24))), 32),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _role(pkg, shared, summary_ops, plane=None, backend="kernel"):
    kw = dict(owner="t", ttl_s=3600.0, batch=64, ckpt_interval_s=0.0,
              log_format=FMT, summary_ops=summary_ops)
    if plane is not None:
        kw["device_plane"] = plane
    if pkg == "jax":
        return jsum.SummarizerRole(shared, fold_backend="kernel", **kw)
    return SummarizerRole(shared, fold_backend=backend, device="cpu", **kw)


def _drain(role, max_steps=10_000):
    for _ in range(max_steps):
        moved = role.step(idle_sleep=0.005)
        if role.fence is not None and not moved:
            return role
    raise AssertionError("the role never drained its input")


def _files(shared):
    """The summary service's durable bytes: the manifest topic, every
    blob file and the checkpoint (loaded)."""
    out = {}
    for sub in ("topics", "store"):
        for root, _dirs, names in os.walk(os.path.join(shared, sub)):
            for n in names:
                p = os.path.join(root, n)
                rel = os.path.relpath(p, shared)
                if rel.startswith(os.path.join("topics", "deltas")) or \
                        ".bell" in rel:
                    continue
                with open(p, "rb") as f:
                    out[rel] = f.read()
    with open(os.path.join(shared, "checkpoints",
                           "summarizer.ckpt.json")) as f:
        out["checkpoint"] = json.load(f)
    return out


def _run(pkg, root, name, plane=None, backend="kernel"):
    """(the drained role, its files, the plane folds it counted: the
    registry's counters are per process, so the run's own share)."""
    make, ops = STREAMS[name]
    shared = str(root / f"{pkg}-{name}-{plane}-{backend}")
    write_deltas(shared, make(), FMT, frame=50)
    role = _role(pkg, shared, ops, plane, backend)
    folds0 = role._m_plane_folds.value
    _drain(role)
    return role, _files(shared), role._m_plane_folds.value - folds0


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-plane")
    return {(name, plane): _run("jax", root, name, plane)[1]
            for name in STREAMS for plane in PLANES}


@pytest.fixture(scope="module")
def plain_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("port-no-plane")
    return {(name, backend): _run("port", root, name, None, backend)[1]
            for name in STREAMS for backend in ("kernel", "overlay")}


def _spy(monkeypatch, module, attr):
    calls = []
    real = getattr(module, attr)

    def spy(mesh, *a):
        calls.append(mesh.size)
        return real(mesh, *a)

    monkeypatch.setattr(module, attr, spy)
    return calls


def _assert_files_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k] == want[k], f"{what}: {k}"


@pytest.mark.parametrize("backend", ["kernel", "overlay"])
@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("name", list(STREAMS))
def test_plane_matches_jax_and_no_plane(jax_runs, plain_runs, tmp_path,
                                        monkeypatch, name, plane, backend):
    placed_replay = _spy(monkeypatch, tof, "sharded_overlay_replay_multi")
    placed_apply = _spy(monkeypatch, tsf, "sharded_apply_docs")
    role, got, folds = _run("port", tmp_path, name, plane, backend)
    assert role.device_plane().spec() == plane
    assert role.device_plane().entries[0].type == "cpu"
    _assert_files_equal(got, plain_runs[(name, backend)], "vs no plane")
    _assert_files_equal(got, jax_runs[(name, plane)], "vs the JAX role")
    assert folds > 0
    size = role.device_plane().size
    if backend == "overlay":  # every stacked group, dummy-padded
        assert placed_replay and set(placed_replay) == {size}
        assert not placed_apply
    else:  # the docs axis, where K and the capacity divide the plane
        assert not placed_replay
        assert set(placed_apply) <= {role.device_plane().docs}
        if name == "stacked4" and plane == "2x2":
            assert placed_apply


@pytest.mark.parametrize("backend", ["kernel", "overlay"])
def test_plane_from_env(plain_runs, tmp_path, monkeypatch, backend):
    monkeypatch.setenv(PLANE_ENV, "2x2")
    role, got, folds = _run("port", tmp_path, "stacked4", None, backend)
    assert role.device_plane().spec() == "2x2"
    assert folds > 0
    _assert_files_equal(got, plain_runs[("stacked4", backend)], "env plane")


def test_no_plane_counts_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv(PLANE_ENV, raising=False)
    role, _, folds = _run("port", tmp_path, "stacked3", None, "overlay")
    assert role.device_plane() is None
    assert folds == 0


def test_overlay_dummy_jobs_pad_to_the_plane(tmp_path):
    """A window group of 3 on a 2x2 plane runs as 4 (one dummy) and
    applies only the 3 real documents' outputs."""
    from fluidframework_tpu_torch.core.overlay_fold import (
        OverlayFoldReplica,
        run_rounds,
    )
    from fluidframework_tpu_torch.parallel.device_plane import shared_plane
    from fluidframework_tpu_torch.server.summary_fold import _encode_fold

    docs = {s: build_mergetree_stream(40, n_clients=2, seed=s,
                                      doc=f"p{s}") for s in (1, 2, 3)}
    outs = []
    for plane in (None, shared_plane(2, 2, "cpu")):
        jobs = []
        for recs in docs.values():
            rep = OverlayFoldReplica(device="cpu")
            _encode_fold(rep, recs)
            jobs.append(rep.build_round())
        summary = run_rounds(jobs, plane)
        assert [g["docs"] for g in summary] == [3]
        assert [g["entries"] for g in summary] == [1 if plane is None else 4]
        outs.append([(j["rep"].settled_t.tolist(), int(j["rep"].table.n_rows))
                     for j in jobs])
    assert outs[0] == outs[1]


class _Stop(Exception):
    pass


def test_supervisor_seams(tmp_path, monkeypatch):
    seen = {}

    def summarizer_step(self, *a, **kw):
        seen["plane"] = self.device_plane()
        raise _Stop

    def deli_step(self, *a, **kw):
        seen["mesh"] = self.mesh
        raise _Stop

    monkeypatch.setattr(SummarizerRole, "step", summarizer_step)
    monkeypatch.setattr(KernelDeliRole, "step", deli_step)
    shared = str(tmp_path / "farm")
    with pytest.raises(_Stop):
        tsup.main(["--role", "summarizer", "--dir", shared, "--device",
                   "cpu", "--device-plane", "2x2"])
    assert seen.pop("plane").spec() == "2x2"
    with pytest.raises(_Stop):
        tsup.main(["--role", "deli", "--impl", "kernel", "--dir", shared,
                   "--device", "cpu", "--deli-devices", "2"])
    assert seen.pop("mesh").size == 2
    with pytest.raises(_Stop):
        tsup.main(["--role", "deli", "--impl", "kernel", "--dir", shared,
                   "--device", "cpu", "--device-plane", "4x2"])
    assert seen.pop("mesh").size == 4  # the plane's docs slice
    with pytest.raises(ValueError, match="DOCSxMODEL"):  # at the 1st fold
        tsup.serve_role(shared, "summarizer", "x", device="cpu",
                        device_plane="2y2")
    # Refused: as the reference refuses them.
    for kw, match in (
            (dict(role="summarizer", deli_devices=2), "deli_devices=2"),
            (dict(role="deli", deli_impl="scalar", device_plane="2x2"),
             "device_plane"),
            (dict(role="scribe", device_plane="2x2"), "device_plane"),
            (dict(role="deli", deli_devices=2, device_plane="2x2"),
             "exclusive"),
            (dict(role="deli", device_plane="2y2"), "DOCSxMODEL")):
        role = kw.pop("role")
        with pytest.raises(ValueError, match=match):
            tsup.serve_role(shared, role, "x", device="cpu", **kw)
    with pytest.raises(SystemExit):
        tsup.main(["--role", "deli", "--dir", shared, "--deli-devices",
                   "two"])
