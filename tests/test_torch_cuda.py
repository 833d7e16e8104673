"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a host without a CUDA device every test here skips
with the reason. On the GPU run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: the repository's conftest imports JAX, which the
GPU host need not have; this file imports only the port.)
"""

import pytest
import torch

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
from fluidframework_tpu_torch.core.overlay_replay import OverlayDeviceReplica
from fluidframework_tpu_torch.ops import mergetree_chunk as tmc
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.ops.mergetree_kernel import make_table
from fluidframework_tpu_torch.ops.zamboni import compact_gather_text
from fluidframework_tpu_torch.testing.block_edges import block_edge_chunks
from fluidframework_tpu_torch.testing.digest import state_digest
from fluidframework_tpu_torch.testing.overlay_edges import overlay_edge_chunks
from fluidframework_tpu_torch.testing.synthetic import generate_lagged_stream
from fluidframework_tpu_torch.utils.devices import cuda_skip_reason

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    reason = cuda_skip_reason()
    if reason:
        pytest.skip(reason)
    return torch.device("cuda")


def _stream():
    return generate_lagged_stream(3000, n_clients=64, seed=5, window=512,
                                  initial_len=64)


OVERLAY_FIELDS = ("anchor", "buf_start", "length", "ins_seq", "ins_client",
                  "rem_seq", "rem_clients", "props")


def _assert_overlay_equal(got, want):
    m = int(want.n_rows)
    assert int(got.n_rows) == m and int(got.error) == int(want.error)
    for f in OVERLAY_FIELDS:
        assert torch.equal(getattr(got, f)[:m], getattr(want, f)[:m]), f


@pytest.mark.parametrize("window,n_removers", [(1024, 8), (2048, 24),
                                               (4096, 4)])
def test_kernel_matches_plain_per_chunk(cuda, window, n_removers):
    rep = OverlayDeviceReplica(_stream(), initial_len=64, chunk_size=256,
                               window=window, n_removers=n_removers,
                               device=cuda)
    rep.prepare()
    table = rep.table
    for ci in range(rep.n_chunks):
        ops = rep._dev.slice(ci * 256, (ci + 1) * 256)
        got = tov.overlay_chunk_kernel(table, ops)
        _assert_overlay_equal(got, tov.overlay_apply_chunk_ref(table, ops))
        table, _, _ = tov.fold_device(got, rep._msn_by_chunk[ci])


def test_overlay_kernel_edge_chunks(cuda):
    """The edge chunks of `testing/overlay_edges.py` at the bench
    geometry (window 2048, 24 remover slots, 8 prop keys, chunks of
    256): split inserts at row 0 and at the window's top, long and
    overflowing gap loops, diverging split halves, a full remover row
    and more than a window of rows created and dropped."""
    for case in overlay_edge_chunks(2048, 24, 8, 1, 256):
        table = interop.table_from_numpy(case["table"], cuda)
        ops = interop.opbatch_from_numpy(case["ops"], cuda)
        _assert_overlay_equal(tov.overlay_chunk_kernel(table, ops),
                              tov.overlay_apply_chunk_ref(table, ops))


def test_overlay_kernel_leaves_its_input(cuda):
    """Two launches on one input table give the same output, and the
    input is unchanged (the kernel edits a heap and the outputs only)."""
    rep = OverlayDeviceReplica(_stream(), initial_len=64, chunk_size=256,
                               window=2048, n_removers=24, device=cuda)
    rep.prepare()
    table = rep.table
    for ci in range(3):
        out = tov.overlay_chunk_kernel(
            table, rep._dev.slice(ci * 256, (ci + 1) * 256))
        table, _, _ = tov.fold_device(out, rep._msn_by_chunk[ci])
    batch = rep._dev.slice(3 * 256, 4 * 256)
    names = OVERLAY_FIELDS + ("n_rows", "error", "settled_len")
    before = [getattr(table, f).clone() for f in names]
    first = tov.overlay_chunk_kernel(table, batch)
    second = tov.overlay_chunk_kernel(table, batch)
    for f, b in zip(names, before):
        assert torch.equal(getattr(table, f), b), f
    _assert_overlay_equal(second, first)
    _assert_overlay_equal(first, tov.overlay_apply_chunk_ref(table, batch))


def test_overlay_kernel_geometry_on_the_card(cuda):
    """The block at the bench geometry, with the shared bytes the
    kernel's library works out, and a clear error rather than a refused
    launch for a chunk whose ops do not fit beside the rows."""
    kernel = tov.OverlayChunkKernel()
    R, KRP, smem = kernel.geometry(2048, 24, 8, 256, 1)
    assert (R, KRP) == (2, 32) and 9 * 2048 * 4 < smem <= tov.SMEM_OPTIN
    with pytest.raises(ValueError, match="shared bytes"):
        kernel.geometry(4096, 24, 8, 4096, 4)


def test_cuda_replay_matches_cpu_replay(cuda):
    stream = _stream()
    kw = dict(initial_len=64, chunk_size=256, window=2048, n_removers=24)
    gpu = OverlayDeviceReplica(stream, device=cuda, **kw)
    before = tov.overlay_chunk_kernel.launches
    gpu.replay()
    assert tov.overlay_chunk_kernel.launches - before == gpu.n_chunks
    cpu = OverlayDeviceReplica(stream, device="cpu", **kw)
    cpu.replay()
    assert int(gpu.cursor) == int(cpu.cursor)
    assert state_digest(gpu.annotated_spans()) == state_digest(
        cpu.annotated_spans())


# ---------------------------------------------------------------- row model

ROW_FIELDS = ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
              "rem_clients", "props")


@pytest.mark.parametrize("capacity", [1024, 8192, 131072, 262144])
def test_mergetree_kernel_matches_plain_per_chunk(cuda, capacity):
    """Kernel B vs `apply_chunk_ref` on every chunk of a lagged stream,
    with the replica's compaction between chunks. The capacities give
    grids of 1, 8 and 128 blocks of 1024 rows, and at 262144 (on 132
    SMs) 131 blocks of 2016 rows with a ragged last block."""
    stream = _stream()
    rep = ColumnarReplica(stream, initial_len=64, chunk_size=256,
                          capacity=capacity, n_removers=24, device=cuda)
    rep._prepare_text()
    ops = rep.op_segment(0, len(stream))
    table = make_table(capacity, 24, 8, device=cuda)
    table.n_rows.fill_(1)
    table.length[0] = 64
    arena = rep.arena
    for ci in range(rep.n_chunks):
        batch = ops.slice(ci * 256, (ci + 1) * 256)
        got = tmc.mergetree_chunk_kernel(table, batch)
        want = tmc.apply_chunk_ref(table, batch)
        m = int(want.n_rows)
        assert int(got.n_rows) == m and int(got.error) == int(want.error)
        for f in ROW_FIELDS:
            assert torch.equal(getattr(got, f)[:m], getattr(want, f)[:m]), f
        msn = int(stream.min_seq[min((ci + 1) * 256, len(stream)) - 1])
        table, arena = compact_gather_text(got, msn, arena, rep.stream_text)


def test_cuda_row_replay_matches_cpu_replay(cuda):
    stream = _stream()
    kw = dict(initial_len=64, chunk_size=256, capacity=8192, n_removers=24,
              sync_interval=4)
    gpu = ColumnarReplica(stream, device=cuda, **kw)
    before = tmc.mergetree_chunk_kernel.launches
    gpu.replay()
    assert tmc.mergetree_chunk_kernel.launches - before == gpu.n_chunks
    cpu = ColumnarReplica(stream, device="cpu", **kw)
    cpu.replay()
    assert gpu.compactions == cpu.compactions
    assert state_digest(gpu.annotated_spans()) == state_digest(
        cpu.annotated_spans())


def _assert_row_tables_equal(got, want):
    m = int(want.n_rows)
    assert int(got.n_rows) == m and int(got.error) == int(want.error)
    for f in ROW_FIELDS:
        assert torch.equal(getattr(got, f)[:m], getattr(want, f)[:m]), f


def test_mergetree_kernel_block_edges(cuda):
    """The block-edge chunks at the bench geometry (capacity 131072, 24
    remover slots, 8 prop keys, chunks of 256): splits, landings and
    shifts on the edges of the kernel's 1024-row blocks, row 0, and
    tables of C-1 and C rows."""
    C = 131072
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, R, _ = tmc.kernel_geometry(C, 24, 8, 256, 1, n_sms)
    for case in block_edge_chunks(R, C, 24, 8, 1, 256):
        table = interop.segment_table_from_numpy(case["table"], cuda)
        ops = interop.opbatch_from_numpy(case["ops"], cuda)
        got = tmc.mergetree_chunk_kernel(table, ops)
        _assert_row_tables_equal(got, tmc.apply_chunk_ref(table, ops))


def test_mergetree_kernel_leaves_its_input(cuda):
    """Two launches on one input table give the same output, and the
    input is unchanged (the kernel edits a heap and the outputs only)."""
    stream = _stream()
    rep = ColumnarReplica(stream, initial_len=64, chunk_size=256,
                          capacity=8192, n_removers=24, device=cuda)
    rep._prepare_text()
    ops = rep.op_segment(0, len(stream))
    table = rep.table
    for ci in range(3):
        table = tmc.mergetree_chunk_kernel(table, ops.slice(ci * 256,
                                                             (ci + 1) * 256))
    batch = ops.slice(3 * 256, 4 * 256)
    before = [getattr(table, f).clone() for f in ROW_FIELDS + ("n_rows",
                                                               "error")]
    first = tmc.mergetree_chunk_kernel(table, batch)
    second = tmc.mergetree_chunk_kernel(table, batch)
    for f, b in zip(ROW_FIELDS + ("n_rows", "error"), before):
        assert torch.equal(getattr(table, f), b), f
    _assert_row_tables_equal(second, first)
    _assert_row_tables_equal(first, tmc.apply_chunk_ref(table, batch))
