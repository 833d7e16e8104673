"""The port stands alone and runs on the GPU unless told otherwise.

- every module of `fluidframework_tpu_torch` imports with ``jax`` and
  ``fluidframework_tpu`` blocked, and no source of the port (nor
  ``chip_smoke.py``) imports either;
- without CUDA, the entry points given no device raise instead of
  running on the CPU, and a non-CPU tensor never reaches the plain
  version of the kernel.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import fluidframework_tpu_torch
from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
from fluidframework_tpu_torch.core.overlay_fold import (
    OverlayFoldReplica,
    boot_overlay,
)
from fluidframework_tpu_torch.core.overlay_replay import (
    OverlayDeviceReplica,
    OverlayKernelMessageReplica,
)
from fluidframework_tpu_torch.ops import mergetree_chunk as tmc
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.ops.mergetree_kernel import make_table
from fluidframework_tpu_torch.server import castore as tcas
from fluidframework_tpu_torch.server import historian as thist
from fluidframework_tpu_torch.server import retention as tret
from fluidframework_tpu_torch.server import summarizer as tsum
from fluidframework_tpu_torch.server.summary_fold import SummaryFolder
from fluidframework_tpu_torch.testing import catchup_streams as tcatch
from fluidframework_tpu_torch.testing.synthetic import generate_stream
from fluidframework_tpu_torch.utils.devices import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(fluidframework_tpu_torch.__file__).resolve().parent


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("check", ["subprocess_import", "ast_scan"])
def test_port_imports_no_jax(check):
    if check == "subprocess_import":
        mods = _port_modules()
        assert len(mods) >= 15
        code = (
            "import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['fluidframework_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in [k.split('.')[0] for k, v in sys.modules.items() if v is not None]\n"
            "print('ok')\n"
        )
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "ok"
    else:
        files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        for path in files:
            for name in _imported_names(path):
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "fluidframework_tpu"), (
                    f"{path} imports {name}")


def test_no_silent_cpu_fallback(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    stream = generate_stream(64, n_clients=4, seed=1, initial_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OverlayDeviceReplica(stream, initial_len=8, window=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tov.make_overlay_table(1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OverlayKernelMessageReplica()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OverlayFoldReplica()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        boot_overlay([["abc", 0, -3, None, None, None]], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SummaryFolder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.table_from_numpy(
            interop.table_to_numpy(tov.make_overlay_table(1024, device="cpu")))

    # overlay_apply_chunk reaches the plain version only for CPU
    # tensors: a tensor on another device raises, and the CUDA wrapper
    # refuses CPU tensors rather than computing anything.
    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    table = tov.make_overlay_table(1024, device="cpu")
    rep = OverlayDeviceReplica(stream, initial_len=8, window=1024,
                               chunk_size=64, device="cpu")
    rep.prepare()
    ops = rep._dev
    monkeypatch.setattr(tov, "overlay_apply_chunk_ref", boom)
    with pytest.raises(ValueError, match="unsupported device"):
        tov.overlay_apply_chunk(table.to("meta"), ops.to("meta"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tov.overlay_chunk_kernel(table, ops)
    assert tov.overlay_chunk_kernel.launches == 0
    with pytest.raises(AssertionError, match="the plain version ran"):
        tov.overlay_apply_chunk(table, ops)


def test_row_model_no_silent_cpu_fallback(monkeypatch):
    """The row-model path: entry points given no device raise without
    CUDA; `apply_chunk` sends a CPU table only to the plain version and
    any other table never reaches it."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    stream = generate_stream(64, n_clients=4, seed=1, initial_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColumnarReplica(stream, initial_len=8, capacity=1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_table(1024, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.segment_table_from_numpy(
            interop.segment_table_to_numpy(make_table(1024, 4, 8, "cpu")))

    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    table = make_table(1024, 4, 8, device="cpu")
    rep = ColumnarReplica(stream, initial_len=8, capacity=1024,
                          chunk_size=64, device="cpu")
    ops = rep.op_segment(0, len(stream)).slice(0, 64)
    monkeypatch.setattr(tmc, "apply_chunk_ref", boom)
    with pytest.raises(ValueError, match="unsupported device"):
        tmc.apply_chunk(table.to("meta"), ops.to("meta"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tmc.mergetree_chunk_kernel(table, ops)
    assert tmc.mergetree_chunk_kernel.launches == 0
    with pytest.raises(AssertionError, match="the plain version ran"):
        tmc.apply_chunk(table, ops)


def test_deli_no_silent_cpu_fallback(monkeypatch):
    """The deli: `KernelDeliLambda`, `SeqPool`, `PackedDeliCore` and the
    sequencer's state makers given no device raise without CUDA;
    `sequence_batch` sends CPU state only to the plain version, and the
    CUDA wrapper refuses CPU tensors without launching."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
    from fluidframework_tpu_torch.server.deli_kernel import (
        KernelDeliLambda,
        PackedDeliCore,
        SeqPool,
    )
    from fluidframework_tpu_torch.server.log import MessageLog

    for make in (lambda: KernelDeliLambda(MessageLog()), SeqPool,
                 PackedDeliCore, lambda: tsk.make_state(4, 8),
                 lambda: tsk.no_aborts(4),
                 lambda: interop.sequencer_state_from_numpy(
                     interop.sequencer_state_to_numpy(
                         tsk.make_state(2, 2, "cpu")))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    state = tsk.make_state(3, 4, device="cpu")
    batch = tsk.SeqBatch(*(torch.zeros((3, 8), dtype=torch.int32)
                           for _ in range(4)))
    groups = torch.full((3, 8), tsk.NO_GROUP, dtype=torch.int32)
    aborted = tsk.no_aborts(3, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tsk.sequencer_step_kernel(state, aborted, batch, groups)
    assert tsk.sequencer_step_kernel.launches == 0
    meta = tsk.SequencerState(*(t.to("meta") for t in state))
    with pytest.raises(ValueError, match="CPU tensors only"):
        tsk.sequence_batch_ref(meta, aborted.to("meta"), batch, groups)
    monkeypatch.setattr(tsk, "sequence_batch_ref", boom)
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.sequence_batch_grouped(
            meta, tsk.SeqBatch(*(t.to("meta") for t in batch)),
            groups.to("meta"), aborted=aborted.to("meta"))
    with pytest.raises(AssertionError, match="the plain version ran"):
        tsk.sequence_batch_grouped(state, batch, groups, aborted=aborted)


def test_rebase_no_silent_cpu_fallback(monkeypatch):
    """The rebase: `rebase_ops_columnar` given no device raises without
    CUDA; `rebase_batch` sends CPU tensors only to the plain version,
    a tensor on another device never reaches it, and the CUDA wrapper
    refuses CPU tensors without launching."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    import numpy as np

    from fluidframework_tpu_torch.testing import tree_streams as ts
    from fluidframework_tpu_torch.tree import rebase_kernel as trk

    ops, base = ts.random_streams()[10][1:]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trk.rebase_ops_columnar(ops, base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.run_config4(None)

    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    cols = [torch.from_numpy(np.ascontiguousarray(a[:, j]))
            for a in (ops, base) for j in range(4)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trk.rebase_kernel(*cols)
    assert trk.rebase_kernel.launches == 0
    meta = [c.to("meta") for c in cols]
    with pytest.raises(ValueError, match="CPU tensors only"):
        trk.rebase_batch_ref(*meta)
    monkeypatch.setattr(trk, "rebase_batch_ref", boom)
    with pytest.raises(ValueError, match="unsupported device"):
        trk.rebase_batch(*meta)
    with pytest.raises(AssertionError, match="the plain version ran"):
        trk.rebase_batch(*cols)
    assert trk.rebase_kernel.launches == 0


def test_scan_no_silent_cpu_fallback(monkeypatch):
    """The row-model scan: `KernelReplica`, the summary fold's kernel
    backend and its boot given no device raise without CUDA;
    `apply_op_batch` and `apply_op_batch_docs` send CPU tables only to
    the plain version, another device never reaches it, and the CUDA
    wrapper refuses CPU tensors without launching."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    from fluidframework_tpu_torch.core.kernel_replica import KernelReplica
    from fluidframework_tpu_torch.ops import mergetree_kernel as tmk
    from fluidframework_tpu_torch.ops import mergetree_scan as tms
    from fluidframework_tpu_torch.server.summary_fold import _boot_mergetree
    from fluidframework_tpu_torch.testing.scan_edges import scan_edge_chunks

    for make in (KernelReplica, lambda: _boot_mergetree([], 0),
                 lambda: SummaryFolder(fold_backend="kernel"),
                 lambda: interop.opbatch_from_numpy(
                     scan_edge_chunks(64, 4, 8, 4, 16)[0]["ops"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()

    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    case = scan_edge_chunks(64, 4, 8, 4, 16)[5]
    table = interop.segment_table_from_numpy(case["table"], "cpu")
    ops = interop.opbatch_from_numpy(case["ops"], "cpu")
    tables = tmk.stack_segment_tables([table, table])
    batches = tmk.stack_op_batches([ops, ops])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tms.mergetree_scan_kernel(table, ops)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tms.mergetree_scan_kernel.docs(tables, batches)
    assert tms.mergetree_scan_kernel.launches == 0
    monkeypatch.setattr(tmk, "apply_op_batch_ref", boom)
    monkeypatch.setattr(tmk, "apply_op_batch_docs_ref", boom)
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.apply_op_batch(table.to("meta"), ops.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tmk.apply_op_batch_docs(tables.to("meta"), batches.to("meta"))
    with pytest.raises(AssertionError, match="the plain version ran"):
        tmk.apply_op_batch(table, ops)
    with pytest.raises(AssertionError, match="the plain version ran"):
        tmk.apply_op_batch_docs(tables, batches)


def test_zamboni_and_scan_engine_no_silent_cpu_fallback(monkeypatch):
    """The scan engine and the zamboni: `ColumnarReplica(engine="scan")`
    given no device raises without CUDA; `zamboni_device` sends a CPU
    table only to the plain version, another device never reaches it,
    and the CUDA wrapper refuses CPU tensors without launching."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    from fluidframework_tpu_torch.ops import zamboni as tz
    from fluidframework_tpu_torch.ops import zamboni_kernel as tzk

    stream = generate_stream(64, n_clients=4, seed=1, initial_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColumnarReplica(stream, initial_len=8, capacity=1024, engine="scan")
    with pytest.raises(ValueError, match="engine"):
        ColumnarReplica(stream, initial_len=8, engine="auto", device="cpu")

    def boom(*a, **k):
        raise AssertionError("the plain version ran")

    table = make_table(1024, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tzk.zamboni_kernel(table, 0)
    assert tzk.zamboni_kernel.launches == 0
    monkeypatch.setattr(tz, "zamboni_device_ref", boom)
    with pytest.raises(ValueError, match="unsupported device"):
        tz.zamboni_device(table.to("meta"), 0)
    with pytest.raises(AssertionError, match="the plain version ran"):
        tz.zamboni_device(table, 0)
    assert tzk.zamboni_kernel.launches == 0


def test_deli_role_no_silent_cpu_fallback(tmp_path):
    """The supervised deli: `KernelDeliRole` and the port's `main`
    given no device raise without CUDA, before any lease, topic or
    heartbeat file is made."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    from fluidframework_tpu_torch.server import supervisor as tsup
    from fluidframework_tpu_torch.server.deli_kernel import KernelDeliRole

    shared = str(tmp_path / "farm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelDeliRole(shared, owner="x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelDeliRole(shared, owner="x", log_format="columnar")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsup.main(["--role", "deli", "--impl", "kernel", "--dir", shared,
                   "--log-format", "columnar"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsup.serve_role(shared, "deli", "x")
    assert not os.path.exists(shared)


def test_multi_device_no_silent_cpu_fallback(tmp_path):
    """The multi-device layer: its modules import with ``jax`` and
    ``fluidframework_tpu`` blocked; a mesh, a plane, the dry run and the
    sharded delis given no device raise without CUDA (the role before
    any file is made) instead of running their entries on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    mods = [m for m in _port_modules() if ".parallel" in m]
    assert {"fluidframework_tpu_torch.parallel.mesh",
            "fluidframework_tpu_torch.parallel.collectives",
            "fluidframework_tpu_torch.parallel.seqshard",
            "fluidframework_tpu_torch.parallel.device_plane",
            "fluidframework_tpu_torch.parallel.dryrun"} <= set(mods)
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['fluidframework_tpu'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    from fluidframework_tpu_torch.parallel import device_plane as tdp
    from fluidframework_tpu_torch.parallel import dryrun as tdry
    from fluidframework_tpu_torch.parallel import mesh as tmesh
    from fluidframework_tpu_torch.parallel import seqshard as tss
    from fluidframework_tpu_torch.server.deli_kernel import (
        KernelDeliLambda,
        KernelDeliRole,
        PackedDeliCore,
    )
    from fluidframework_tpu_torch.server.log import MessageLog

    shared = str(tmp_path / "farm")
    for make in (lambda: tmesh.make_docs_mesh(),
                 lambda: tmesh.make_docs_mesh(4),
                 lambda: tmesh.shared_docs_mesh(2),
                 lambda: tdp.DevicePlane(2, 2),
                 lambda: tdp.resolve_plane("2x2"),
                 lambda: tss.make_shard_state(8, 16, 2, 2),
                 lambda: tdry.dryrun_multichip(2),
                 lambda: KernelDeliLambda(MessageLog(), deli_devices=2),
                 lambda: KernelDeliLambda(MessageLog(), device_plane="2x2"),
                 lambda: KernelDeliRole(shared, owner="x", deli_devices=2),
                 lambda: KernelDeliRole(shared, owner="x",
                                        device_plane="2x2")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not os.path.exists(shared)
    # An explicit CPU mesh is honoured, entry by entry.
    core = PackedDeliCore(mesh=tmesh.make_docs_mesh(2, "cpu"))
    assert core.pool.device.type == "cpu" and core.pool._n_shards == 2


def test_summary_service_no_silent_cpu_fallback(tmp_path):
    """The summary service: the role (and its child entry), the reader
    replica and config10's loop given no device raise without CUDA, the
    role before it makes a lease, heartbeat or topic file; the store
    refuses the native backend instead of falling back; the pins and
    the historian need no device."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    from fluidframework_tpu_torch.server import supervisor as tsup

    shared = str(tmp_path / "farm")
    for make in (lambda: tsum.SummarizerRole(shared, owner="x"),
                 lambda: tsum.SummarizerRole(shared, owner="x",
                                             fold_backend="overlay"),
                 lambda: tsup.serve_role(shared, "summarizer", "x"),
                 lambda: tsum.SummaryReplica(None),
                 lambda: tcatch.run_catchup((64,), work_dir=shared)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not os.path.exists(os.path.join(shared, "hb"))
    with pytest.raises(ValueError, match="not ported"):
        tcas.ContentAddressedStore(prefer_native=True)
    cache = thist.HistorianCache(tcas.ContentAddressedStore(), name="iso")
    assert cache.get(cache.put(b"x")) == b"x"
    assert tret.live_pin_floor(shared) is None
