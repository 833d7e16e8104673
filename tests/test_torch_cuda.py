"""The CUDA kernels against their plain PyTorch versions, on the card,
and the port's paths on the card against the same paths on the CPU (the
replays, the summary fold rounds, the message-driven replica, the
summary folder against fold_golden.json on both fold backends, the
deli, config 4's rebase against tree_golden.json, `KernelReplica`, and
the row model's scan engine).

Marked ``cuda``: on a host without a CUDA device every test here skips
with the reason. On the GPU run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: the repository's conftest imports JAX, which the
GPU host need not have; this file imports only the port.)
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
from fluidframework_tpu_torch.core.overlay_fold import (
    boot_overlay,
    fold_jobs_overlay,
)
from fluidframework_tpu_torch.core.overlay_replay import (
    OverlayDeviceReplica,
    OverlayKernelMessageReplica,
    replay_docs,
)
from fluidframework_tpu_torch.ops import mergetree_chunk as tmc
from fluidframework_tpu_torch.ops import overlay as tov
from fluidframework_tpu_torch.core.kernel_replica import KernelReplica
from fluidframework_tpu_torch.ops import mergetree_kernel as tmk
from fluidframework_tpu_torch.ops import mergetree_scan as tms
from fluidframework_tpu_torch.ops.mergetree_kernel import OpBatch, make_table
from fluidframework_tpu_torch.ops import zamboni_kernel as tzk
from fluidframework_tpu_torch.ops.zamboni import (
    compact_gather_text,
    compact_gather_text_ref,
    zamboni_device,
    zamboni_device_ref,
)
from fluidframework_tpu_torch.server.summary_fold import (
    SummaryFolder,
    _boot_mergetree,
    _encode_fold,
)
from fluidframework_tpu_torch.testing.compaction_edges import (
    compaction_edge_cases,
    random_case,
    text_edge_cases,
    wide_prop_cases,
)
from fluidframework_tpu_torch.testing.block_edges import (
    block_edge_chunks,
    edge_table,
)
from fluidframework_tpu_torch.testing.digest import state_digest
from fluidframework_tpu_torch.testing.fold_streams import (
    as_messages,
    build_mergetree_stream,
    golden_streams,
    load_fold_golden,
    run_fold_sweep,
)
from fluidframework_tpu_torch.testing.scan_edges import (
    OP_LOOP_CASES,
    random_chunk,
    scan_edge_chunks,
)
from fluidframework_tpu_torch.testing.overlay_edges import (
    overlay_edge_chunks,
    widen_prop_slots,
)
from fluidframework_tpu_torch.testing.synthetic import generate_lagged_stream
from fluidframework_tpu_torch.testing.tree_streams import all_streams
from fluidframework_tpu_torch.testing.zamboni_edges import zamboni_edge_tables
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
    """The launcher's plan: the shared layout while the hot columns and
    the chunk's ops fit a block's shared memory, the global layout (a
    hot scratch of 9 x W ints per document) otherwise, whatever W."""
    kernel = tov.OverlayChunkKernel()
    plan = kernel.plan(2048, 24, 8, 256, 1)
    assert plan == ("shared", 2, 32, 4 * (9 * 2048 + 285 + 256 * 10), 0)
    assert kernel.plan(6144, 24, 8, 128, 4).layout == "shared"
    assert kernel.plan(4096, 24, 8, 2048, 1).layout == "shared"
    for shape in ((6144, 24, 8, 256, 1), (4096, 24, 8, 4096, 4),
                  (8192, 24, 8, 2048, 1), (7168, 4, 8, 128, 4)):
        plan = kernel.plan(*shape)
        assert plan.layout == "global" and plan.scratch_ints == 9 * shape[0]
    with pytest.raises(ValueError):
        kernel.plan(1536, 24, 8, 256, 1)


def test_overlay_kernel_forced_layout_plan(cuda):
    """A caller may ask for either layout: the global one at any shape,
    the shared one only where it fits (else the launcher refuses)."""
    kernel = tov.OverlayChunkKernel()
    plan = kernel.plan(2048, 24, 8, 256, 1, layout="global")
    assert plan.layout == "global" and plan.scratch_ints == 9 * 2048
    assert kernel.plan(2048, 24, 8, 256, 1, layout="shared") == kernel.plan(
        2048, 24, 8, 256, 1)
    with pytest.raises(RuntimeError):
        kernel.plan(8192, 24, 8, 2048, 1, layout="shared")
    with pytest.raises(ValueError):
        kernel.plan(2048, 24, 8, 256, 1, layout="texture")


def _layouts(W, B, KR, KK, PK):
    """The layouts the launcher takes at this shape."""
    out = ["global"]
    try:
        tov.overlay_chunk_kernel.plan(W, KR, KK, B, PK, layout="shared")
        out.append("shared")
    except RuntimeError:
        pass
    return out


# The shapes of chip_smoke.py's layout phase, (W, B, KR, KK, PK), and
# the widest heap row the kernel takes (KR + KK = 1024).
LAYOUT_SHAPES = [(3072, 128, 4, 8, 4), (6144, 128, 24, 8, 4),
                 (6144, 256, 24, 8, 1), (8192, 2048, 24, 8, 1),
                 (2048, 256, 64, 8, 1), (1024, 64, 1000, 24, 2)]


@pytest.mark.parametrize("W,B,KR,KK,PK", LAYOUT_SHAPES)
def test_kernel_layouts_match_plain(cuda, W, B, KR, KK, PK):
    """Every layout the launcher takes at the windows and chunks of the
    smoke's layout phase: the first stream chunks (ops widened to PK
    prop slots) and the edge chunks (the one that fills every prop slot
    included), exactly."""
    rep = OverlayDeviceReplica(_stream(), initial_len=64, chunk_size=B,
                               window=W, n_removers=KR, n_prop_keys=KK,
                               device=cuda)
    rep.prepare()
    table = rep.table
    layouts = _layouts(W, B, KR, KK, PK)
    for ci in range(min(2, rep.n_chunks)):
        ops = widen_prop_slots(rep._dev.slice(ci * B, (ci + 1) * B), PK)
        want = tov.overlay_apply_chunk_ref(table, ops)
        for layout in layouts:
            got = tov.overlay_chunk_kernel(table, ops, layout)
            _assert_overlay_equal(got, want)
        table, _, _ = tov.fold_device(got, rep._msn_by_chunk[ci])
    for case in overlay_edge_chunks(W, KR, KK, PK, B):
        table = interop.table_from_numpy(case["table"], cuda)
        ops = interop.opbatch_from_numpy(case["ops"], cuda)
        want = tov.overlay_apply_chunk_ref(table, ops)
        for layout in layouts:
            _assert_overlay_equal(
                tov.overlay_chunk_kernel(table, ops, layout), want)


@pytest.mark.parametrize("W,B", [(2048, 256), (8192, 2048)])
def test_kernel_stacked_documents_match_plain(cuda, W, B):
    """Three documents of different streams in one launch (one block
    each), in each layout, against the plain version per document."""
    reps = [OverlayDeviceReplica(
        generate_lagged_stream(2 * B, n_clients=64, seed=seed, window=512,
                               initial_len=64),
        initial_len=64, chunk_size=B, window=W, n_removers=24, device=cuda)
        for seed in (5, 6, 7)]
    for r in reps:
        r.prepare()
    tables = [r.table for r in reps]
    for ci in range(2):
        chunks = [r._dev.slice(ci * B, (ci + 1) * B) for r in reps]
        stacked = OpBatch(*(torch.stack([getattr(c, f) for c in chunks])
                            for f in chunks[0].__dataclass_fields__))
        wants = [tov.overlay_apply_chunk_ref(t, c)
                 for t, c in zip(tables, chunks)]
        for layout in _layouts(W, B, 24, 8, 1):
            before = tov.overlay_chunk_kernel.launches
            got = tov.overlay_chunk_kernel(tov.stack_tables(tables), stacked,
                                           layout)
            assert tov.overlay_chunk_kernel.launches - before == 1
            for d, want in enumerate(wants):
                _assert_overlay_equal(got.doc(d), want)
        tables = [tov.fold_device(got.doc(d), r._msn_by_chunk[ci])[0]
                  for d, r in enumerate(reps)]


def test_cuda_docs_replay_matches_cpu_docs_replay(cuda):
    streams = [generate_lagged_stream(1500, n_clients=64, seed=seed,
                                      window=512, initial_len=64)
               for seed in (5, 6, 7)]
    kw = dict(initial_len=64, chunk_size=256, window=2048, n_removers=24)
    gpu = [OverlayDeviceReplica(s, device=cuda, **kw) for s in streams]
    before = tov.overlay_chunk_kernel.launches
    g_out = replay_docs(gpu)
    assert tov.overlay_chunk_kernel.launches - before == gpu[0].n_chunks
    c_out = replay_docs([OverlayDeviceReplica(s, device="cpu", **kw)
                         for s in streams])
    (gt, glog, gcnt, gcur, gmsn, gerr) = g_out
    (ct, clog, ccnt, ccur, cmsn, cerr) = c_out
    assert torch.equal(gcur.cpu(), ccur) and torch.equal(gcnt.cpu(), ccnt)
    assert int(gmsn) == int(cmsn) and int(gerr) == int(cerr) == 0
    for d in range(3):
        c = int(ccur[d])
        assert torch.equal(glog[d, :c].cpu(), clog[d, :c])
        _assert_overlay_equal(gt.doc(d).to("cpu"), ct.doc(d))


def test_cuda_streaming_matches_prestaged(cuda):
    stream = _stream()
    kw = dict(initial_len=64, chunk_size=256, window=2048, n_removers=24)
    pre = OverlayDeviceReplica(stream, device=cuda, **kw)
    pre.replay()
    for n_segments in (1, 3, 8):
        rep = OverlayDeviceReplica(stream, device=cuda, **kw)
        before = tov.overlay_chunk_kernel.launches
        rep.replay_streaming(n_segments)
        assert tov.overlay_chunk_kernel.launches - before == rep.n_chunks
        c = int(pre.cursor)
        assert int(rep.cursor) == c
        assert torch.equal(rep.counts, pre.counts)
        assert torch.equal(rep.log[:c], pre.log[:c])
        _assert_overlay_equal(rep.table, pre.table)


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



# ------------------------------------------------------ summary fold path


def test_cuda_fold_rounds_match_cpu(cuda):
    """Three documents through the fold bench's emission loop, every
    round one stacked `fold_jobs_overlay` call: the canonical rows of
    every emission on the card equal the CPU run's, and kernel A runs
    once per chunk of each window group."""
    streams = {f"doc{i}": build_mergetree_stream(600, n_clients=4,
                                                 seed=70 + i, doc=f"doc{i}")
               for i in range(3)}
    before = tov.overlay_chunk_kernel.launches
    gpu = run_fold_sweep(streams, 150, cuda)
    launches = tov.overlay_chunk_kernel.launches - before
    cpu = run_fold_sweep(streams, 150, "cpu")
    assert gpu["digests"] == cpu["digests"]
    assert len(gpu["digests"]["doc0"]) == 5
    assert launches == sum(r["chunks"] for r in gpu["rounds"])
    assert all(r["device_ms"] > 0 for r in gpu["rounds"])


def test_cuda_fold_window_groups_match_cpu(cuda):
    """One fold call whose documents have two windows (one booted over
    1,100 unsettled rows): one stacked launch per chunk of each window
    group on the card, and the same tables and rows as the CPU run."""
    big = [["x" * 3, 5, 1, None, None, {"k": i % 7}] for i in range(1100)]
    recs = [build_mergetree_stream(300, n_clients=4, seed=80 + i,
                                   doc=f"doc{i}") for i in range(3)]
    runs = []
    for dev in (cuda, "cpu"):
        reps = [boot_overlay(rows, 0, device=dev)
                for rows in ([], big, [])]
        for rep, r in zip(reps, recs):
            _encode_fold(rep, r)
        before = tov.overlay_chunk_kernel.launches
        groups = fold_jobs_overlay([(rep, None) for rep in reps])
        runs.append((reps, groups, tov.overlay_chunk_kernel.launches
                     - before))
    (gpu, g_groups, g_launches), (cpu, c_groups, _) = runs
    assert [(g["window"], g["docs"]) for g in g_groups] == [
        (2048, 2), (3072, 1)]
    assert [(g["window"], g["docs"], g["chunks"]) for g in g_groups] == [
        (g["window"], g["docs"], g["chunks"]) for g in c_groups]
    assert g_launches == sum(g["chunks"] for g in g_groups)
    for a, b in zip(gpu, cpu):
        _assert_overlay_equal(a.table.to("cpu"), b.table)
        assert a.canonical_rows(304) == b.canonical_rows(304)


def test_cuda_message_replica_matches_cpu(cuda):
    for seed in (71, 72):
        msgs = as_messages(build_mergetree_stream(900, n_clients=4,
                                                  seed=seed))
        reps = []
        for dev in (cuda, "cpu"):
            rep = OverlayKernelMessageReplica(chunk_size=64, window=1024,
                                              device=dev)
            rep.apply_messages(msgs)
            reps.append(rep)
        gpu, cpu = reps
        assert int(gpu.table.error) == int(cpu.table.error) == 0
        assert gpu.get_text() == cpu.get_text()
        assert gpu.annotated_spans() == cpu.annotated_spans()


def test_cuda_summary_folder_meets_fold_golden(cuda):
    golden = load_fold_golden()
    step = golden["params"]["summary_ops"]
    folder = SummaryFolder(summary_ops=step, device=cuda)
    streams = golden_streams(golden, 4)
    for lo in range(0, len(streams["doc0"]), step):
        for recs in streams.values():
            for rec in recs[lo:lo + step]:
                folder.process(rec)
        folder.flush()
    got = {}
    for handle, payload in folder.blobs.items():
        blob = json.loads(payload)
        got.setdefault(blob["doc"], []).append(
            [blob["seq"], blob["count"], handle])
    for doc, want in golden["manifests"].items():
        assert sorted(got[doc]) == want, doc


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
    before_c = tzk.compaction_kernel.launches
    gpu.replay()
    assert tmc.mergetree_chunk_kernel.launches - before == gpu.n_chunks
    # Every compaction ran on the compaction kernel.
    assert tzk.compaction_kernel.launches - before_c == (
        gpu.compactions * tzk.compaction_kernel.LAUNCHES)
    cpu = ColumnarReplica(stream, device="cpu", **kw)
    cpu.replay()
    assert gpu.compactions == cpu.compactions
    _assert_whole_table_equal(gpu.table, cpu.table, "final table")
    assert torch.equal(gpu.arena.cpu(), cpu.arena)
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


# -------------------------------------------------------------------- deli

def _seq_plain(state, aborted, cols, dedup):
    """The plain version on CPU copies of the card's inputs."""
    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk

    cpu = [c.cpu() for c in cols]
    return tsk.sequence_batch_ref(
        tsk.SequencerState(*(t.cpu() for t in state)), aborted.cpu(),
        tsk.SeqBatch(*cpu[:4]), cpu[4], dedup)


def _assert_seq_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu(), b), (a, b)


@pytest.mark.parametrize("C,layout", [(8, None), (8, "global"),
                                      (128, None), (2048, None),
                                      (2048, "shared")])
@pytest.mark.parametrize("dedup", [False, True])
def test_sequencer_kernel_matches_plain(cuda, C, layout, dedup):
    """The sequencer kernel vs `sequence_batch_ref` on grouped edge
    traffic, chunk by chunk with the abort tracker carried, at an odd D
    (13 documents: a block of 4 warps with one live), both layouts."""
    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
    from fluidframework_tpu_torch.testing.deli_streams import edge_chunks

    D = 13
    state = tsk.make_state(D, C, cuda)
    aborted = tsk.no_aborts(D, cuda)
    before = tsk.sequencer_step_kernel.launches
    chunks = edge_chunks(5 + C, D, min(C, 8), 96, 32)
    for cols in chunks:
        cols = [torch.from_numpy(c).to(cuda) for c in cols]
        want = _seq_plain(state, aborted, cols, dedup)
        state, aborted, res = tsk.sequencer_step_kernel(
            state, aborted, tsk.SeqBatch(*cols[:4]), cols[4], dedup,
            layout=layout)
        torch.cuda.synchronize()
        _assert_seq_equal(state, want[0])
        _assert_seq_equal([aborted], [want[1]])
        _assert_seq_equal(res, want[2])
    assert tsk.sequencer_step_kernel.launches - before == len(chunks)


def test_cuda_deli_matches_cpu_deli(cuda):
    """`KernelDeliLambda` on the card and on the CPU give the same
    deltas and checkpoints: random traffic in small pumps and chunks
    under a resident budget, and churn that grows the columns to 2048
    in one pump."""
    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
    from fluidframework_tpu_torch.server.deli_kernel import KernelDeliLambda
    from fluidframework_tpu_torch.server.log import MessageLog
    from fluidframework_tpu_torch.testing.deli_streams import (
        checkpoint_digest,
        churn_raws,
        gen_raw_traffic,
        norm_entry,
    )

    cases = [(gen_raw_traffic(7, n=400, docs=9),
              dict(max_pump=37, max_cols=8, n_docs=5, max_resident=6)),
             (churn_raws(3, 1100, seed=2), dict(max_pump=10**6, n_docs=5))]
    for recs, kw in cases:
        outs = []
        for dev in (cuda, "cpu"):
            log = MessageLog()
            log.topic("rawdeltas").append_many(recs)
            deli = KernelDeliLambda(log, device=dev, **kw)
            before = tsk.sequencer_step_kernel.launches
            while deli.pump():
                pass
            if dev != "cpu":
                assert (tsk.sequencer_step_kernel.launches - before
                        == deli.core.pool.chunks)
            outs.append(([norm_entry(e) for e in log.topic("deltas").read(0)],
                         checkpoint_digest(deli.checkpoint())))
        assert outs[0] == outs[1]


def _rebase_streams():
    return {name: (ops, base) for name, ops, base in all_streams()}


@pytest.mark.parametrize("name", [n for n, _, _ in all_streams()]
                         + ["config4"])
def test_rebase_kernel_matches_plain(cuda, name):
    """The rebase kernel vs `rebase_batch_ref` on CPU copies of the same
    inputs, all eight outputs exactly; the inputs are left untouched and
    each launch is counted (N = 0 launches nothing)."""
    from fluidframework_tpu_torch.testing.tree_streams import config4_inputs
    from fluidframework_tpu_torch.tree import rebase_kernel as trk

    ops, base = (config4_inputs() if name == "config4"
                 else _rebase_streams()[name])
    ops, base = trk._pad(ops), trk._pad(base)
    cols = [torch.from_numpy(np.ascontiguousarray(a[:, j]))
            for a in (ops, base) for j in range(4)]
    dev_cols = [c.to(cuda) for c in cols]
    before = trk.rebase_kernel.launches
    got = trk.rebase_batch(*dev_cols)
    torch.cuda.synchronize()
    assert trk.rebase_kernel.launches - before == (1 if len(ops) else 0)
    want = trk.rebase_batch_ref(*cols)
    for field, a, b in zip(trk.OUT_FIELDS, got, want):
        assert a.dtype == b.dtype and a.device.type == "cuda", field
        assert torch.equal(a.cpu(), b), field
    for d, c in zip(dev_cols, cols):
        assert torch.equal(d.cpu(), c)


def test_cuda_config4_meets_tree_golden(cuda):
    """Config 4 through `rebase_ops_columnar` on the card: one launch,
    the digests and counts of tree_golden.json."""
    from fluidframework_tpu_torch.testing import tree_streams as ts
    from fluidframework_tpu_torch.tree import rebase_kernel as trk

    golden = ts.load_tree_golden()
    before = trk.rebase_kernel.launches
    run = ts.run_config4(cuda)
    assert trk.rebase_kernel.launches - before == 1
    assert run["digests"] == {k: golden[f"{k}_sha256"]
                              for k in ("rebased", "spares", "flagged")}
    for key in ("flagged", "native_splits", "muted"):
        assert run[key] == golden[key], key


# ----------------------------------------------------------- row-model scan


def _assert_scan_equal(got, want, label=""):
    """Stacked tables equal per document on n_rows, error and rows
    [:min(n_rows, C)] (the rows above are scratch)."""
    for d in range(want.n_rows.shape[0]):
        g, w = got.doc(d), want.doc(d)
        n = int(w.n_rows)
        assert int(g.n_rows) == n and int(g.error) == int(w.error), (label, d)
        m = min(n, w.length.shape[0])
        for f in ROW_FIELDS:
            assert torch.equal(getattr(g, f)[:m].cpu(),
                               getattr(w, f)[:m].cpu()), (label, d, f)


def _stack(cases, key):
    return {k: np.stack([c[key][k] for c in cases]) for k in cases[0][key]}


@pytest.mark.parametrize("C", [64, 512, 2048, 8192, 16384])
def test_scan_kernel_edge_chunks(cuda, C):
    """Every edge chunk of `testing/scan_edges.py` alone (one block) and
    the chunks of 128 ops stacked in one launch, against the plain
    version on CPU copies (C 8192: the hot columns in shared memory, the
    full tables on the swept op loop, the heap global; C 16384: the
    global layout)."""
    cases = scan_edge_chunks(C, 4, 8, 4, 128)
    before = tms.mergetree_scan_kernel.launches
    for case in cases:
        t = interop.segment_table_from_numpy(case["table"], cuda)
        o = interop.opbatch_from_numpy(case["ops"], cuda)
        got = tms.mergetree_scan_kernel(t, o)
        want = tmk.apply_op_batch_ref(t.to("cpu"), o.to("cpu"))
        _assert_scan_equal(tmk.stack_segment_tables([got]),
                           tmk.stack_segment_tables([want]), case["label"])
    full = [c for c in cases if c["ops"]["op_type"].shape[0] == 128]
    t = interop.segment_table_from_numpy(_stack(full, "table"), cuda)
    o = interop.opbatch_from_numpy(_stack(full, "ops"), cuda)
    got = tmk.apply_op_batch_docs(t, o)
    _assert_scan_equal(got, tmk.apply_op_batch_docs_ref(t.to("cpu"),
                                                        o.to("cpu")))
    assert tms.mergetree_scan_kernel.launches - before == len(cases) + 1


@pytest.mark.parametrize("C", [512, 1024, 2048])
def test_scan_kernel_fold_chunks(cuda, C):
    """Config15 fold chunks of 4 documents stacked (seeds 40..43, their
    first round from empty tables), chunk after chunk from the kernel's
    own output, against the plain version."""
    golden = load_fold_golden()
    reps = []
    for recs in golden_streams(golden, 4).values():
        rep = _boot_mergetree([], 0, device=cuda)
        _encode_fold(rep, recs[:375])
        reps.append(rep)
    tables = tmk.stack_segment_tables([
        tmk.grow_table(r.table, r.capacity, C) for r in reps])
    for k in range(3):
        ops = tmk.stack_op_batches([
            r._build_batch(r._encoded[k * 128:(k + 1) * 128]) for r in reps])
        got = tms.mergetree_scan_kernel.docs(tables, ops)
        _assert_scan_equal(got, tmk.apply_op_batch_docs_ref(
            tables.to("cpu"), ops.to("cpu")), f"C {C} chunk {k}")
        assert int(got.error.max()) == 0
        tables = got


def test_scan_kernel_leaves_its_input(cuda):
    case = scan_edge_chunks(512, 4, 8, 4, 128)[7]
    t = interop.segment_table_from_numpy(case["table"], cuda)
    o = interop.opbatch_from_numpy(case["ops"], cuda)
    before = interop.segment_table_to_numpy(t)
    first = tms.mergetree_scan_kernel(t, o)
    second = tms.mergetree_scan_kernel(t, o)
    after = interop.segment_table_to_numpy(t)
    assert all(np.array_equal(before[k], after[k]) for k in before)
    _assert_scan_equal(tmk.stack_segment_tables([second]),
                       tmk.stack_segment_tables([first]))
    # No capacity ceiling: a full table of 8193 rows (hot columns in
    # shared memory, the heap global, the swept op loop).
    big = interop.segment_table_from_numpy(
        scan_edge_chunks(8193, 4, 8, 4, 128)[0]["table"], cuda)
    g = tms.scan_geometry(8193, 128, 4)
    assert (g.hot, g.removers, g.props) == ("shared", "global", "global")
    got = tms.mergetree_scan_kernel(big, o)
    want = tmk.apply_op_batch_ref(big.to("cpu"), o.to("cpu"))
    _assert_scan_equal(tmk.stack_segment_tables([got]),
                       tmk.stack_segment_tables([want]))
    # What still raises: a chunk's ops that do not fit in shared memory.
    wide = OpBatch(*(torch.cat([getattr(o, f.name)] * 32)
                     for f in dataclasses.fields(OpBatch)))
    with pytest.raises(ValueError, match="shared bytes"):
        tms.mergetree_scan_kernel(t, wide)


@pytest.mark.parametrize("C, n, loop", OP_LOOP_CASES)
def test_scan_kernel_op_loops(cuda, C, n, loop):
    """Each op loop, chosen by the block from the rows its chunk can
    reach (min(C, n + 2B), B 128), as the card reports it (rows a
    thread, warps), on a chunk of random ops against the plain
    version."""
    t = interop.segment_table_from_numpy(edge_table(C, 4, 8, n), cuda)
    o = interop.opbatch_from_numpy(random_chunk(n, 128, 4, C + n), cuda)
    kernel = tms.MergetreeScanKernel()
    got = kernel(t, o)
    assert tuple(kernel.last_geometry[0].tolist()) == loop
    want = tmk.apply_op_batch_ref(t.to("cpu"), o.to("cpu"))
    assert int(want.error) == 0 and int(want.n_rows) > n
    _assert_scan_equal(tmk.stack_segment_tables([got]),
                       tmk.stack_segment_tables([want]), f"C {C} n {n}")
    assert kernel.launches == 1


def test_cuda_kernel_fold_meets_fold_golden(cuda):
    golden = load_fold_golden()
    streams = golden_streams(golden, 4)
    before = tms.mergetree_scan_kernel.launches
    out = run_fold_sweep(streams, golden["params"]["summary_ops"], cuda,
                         backend="kernel")
    launches = tms.mergetree_scan_kernel.launches - before
    assert launches == sum(r["chunks"] for r in out["rounds"])
    want = {d["doc"]: d["rows_sha256"] for d in golden["docs"]}
    assert out["digests"] == {d: want[d] for d in streams}
    assert all(r["device_ms"] is not None for r in out["rounds"])


def test_cuda_summary_folder_kernel_backend_meets_fold_golden(cuda):
    golden = load_fold_golden()
    step = golden["params"]["summary_ops"]
    folder = SummaryFolder(summary_ops=step, device=cuda,
                           fold_backend="kernel")
    streams = golden_streams(golden, 4)
    for lo in range(0, len(streams["doc0"]), step):
        for recs in streams.values():
            for rec in recs[lo:lo + step]:
                folder.process(rec)
        folder.flush()
    got = {}
    for handle, payload in folder.blobs.items():
        blob = json.loads(payload)
        got.setdefault(blob["doc"], []).append(
            [blob["seq"], blob["count"], handle])
    for doc, want in golden["manifests"].items():
        assert sorted(got[doc]) == want, doc


def test_cuda_kernel_replica_matches_cpu(cuda):
    msgs = as_messages(build_mergetree_stream(1500, n_clients=4, seed=41))
    kw = dict(chunk_size=128, capacity=512)
    gpu = KernelReplica(device=cuda, **kw)
    before = tms.mergetree_scan_kernel.launches
    gpu.apply_messages(msgs)
    n_ops = sum(1 for m in msgs if m.type.value == "op")
    assert tms.mergetree_scan_kernel.launches - before == -(-n_ops // 128)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = KernelReplica(device="cpu", **kw)
        cpu.apply_messages(msgs)
    finally:
        torch.set_num_threads(threads)
    assert int(gpu.table.error) == int(cpu.table.error) == 0
    assert gpu.capacity == cpu.capacity
    assert gpu.get_text() == cpu.get_text()
    assert gpu.annotated_spans() == cpu.annotated_spans()


def test_cuda_kernel_replica_above_the_old_ceiling_matches_cpu(cuda):
    """KernelReplica at capacity 16384 (the scan kernel's global layout)
    over a config15 stream, against the same replica on the CPU."""
    golden = load_fold_golden()
    msgs = as_messages(next(iter(golden_streams(golden, 1).values())))
    kw = dict(chunk_size=512, capacity=16384)
    assert tms.scan_geometry(16384, 512, 4).hot == "global"
    gpu = KernelReplica(device=cuda, **kw)
    before = tms.mergetree_scan_kernel.launches
    gpu.apply_messages(msgs)
    n_ops = sum(1 for m in msgs if m.type.value == "op")
    assert tms.mergetree_scan_kernel.launches - before == -(-n_ops // 512)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = KernelReplica(device="cpu", **kw)
        cpu.apply_messages(msgs)
    finally:
        torch.set_num_threads(threads)
    assert int(gpu.table.error) == int(cpu.table.error) == 0
    assert gpu.capacity == cpu.capacity == 16384
    assert gpu.get_text() == cpu.get_text()
    assert gpu.annotated_spans() == cpu.annotated_spans()


def _assert_whole_table_equal(got, want, label=""):
    """Every field of the whole table (the zamboni writes every row)."""
    for f in ("n_rows", "error") + ROW_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), (
            f"{label}: {f}")


@pytest.mark.parametrize("C,KR", [(1024, 4), (16384, 8), (131072, 24)])
def test_zamboni_kernel_edge_tables(cuda, C, KR):
    """Every edge table of `testing/zamboni_edges.py` (the tile edges at
    C 16384 and 131072) through the kernel, against the plain version on
    CPU copies, exactly; the input is left as it was."""
    before = tzk.zamboni_kernel.launches
    cases = zamboni_edge_tables(C, KR, 8)
    for case in cases:
        t = interop.segment_table_from_numpy(case["table"], cuda)
        copy = interop.segment_table_from_numpy(case["table"], cuda)
        got = zamboni_device(t, case["min_seq"])
        want = zamboni_device_ref(t.to("cpu"), case["min_seq"])
        _assert_whole_table_equal(got, want, case["label"])
        _assert_whole_table_equal(t, copy, case["label"] + " (input)")
    assert tzk.zamboni_kernel.launches - before == (
        len(cases) * tzk.zamboni_kernel.LAUNCHES)


@pytest.mark.parametrize("C,KR", [(1024, 8), (131072, 24)])
def test_compaction_kernel_edge_cases(cuda, C, KR):
    """Every edge case of `testing/compaction_edges.py` (the tile edges,
    the look-back over tiles that keep nothing, the text's bounds at C
    131072) through the compaction kernel, one call after another on the
    wrapper's scratch, the MSN an int and a tensor on the card, against
    the plain version on CPU copies, exactly: the whole table and the
    whole new arena; the inputs are left as they were."""
    before = tzk.compaction_kernel.launches
    cases = compaction_edge_cases(C, KR, 8) + text_edge_cases(C, KR, 8)
    for i, case in enumerate(cases):
        t = interop.segment_table_from_numpy(case["table"], cuda)
        copy = interop.segment_table_from_numpy(case["table"], cuda)
        doc = torch.from_numpy(case["doc_arena"]).to(cuda)
        text = torch.from_numpy(case["stream_text"]).to(cuda)
        msn = case["min_seq"]
        if i % 2:
            msn = torch.tensor(msn, dtype=torch.int32, device=cuda)
        got, arena = compact_gather_text(t, msn, doc, text)
        want, want_arena = compact_gather_text_ref(
            t.to("cpu"), case["min_seq"], doc.cpu(), text.cpu())
        _assert_whole_table_equal(got, want, case["label"])
        assert torch.equal(arena.cpu(), want_arena), case["label"]
        _assert_whole_table_equal(t, copy, case["label"] + " (input)")
        assert torch.equal(doc.cpu(), torch.from_numpy(case["doc_arena"]))
    assert tzk.compaction_kernel.launches - before == (
        len(cases) * tzk.compaction_kernel.LAUNCHES)


@pytest.mark.parametrize("C", [1024, 131072])
def test_compaction_kernel_wide_props(cuda, C):
    """16 prop keys, which take a compaction block past 48 KB of shared
    memory (the launch opts in to more), against the plain version on
    CPU copies, exactly; one key past the most the wrapper takes raises
    before any launch."""
    before = tzk.compaction_kernel.launches
    cases = wide_prop_cases(C, 8, 16)
    for case in cases:
        t = interop.segment_table_from_numpy(case["table"], cuda)
        doc = torch.from_numpy(case["doc_arena"]).to(cuda)
        text = torch.from_numpy(case["stream_text"]).to(cuda)
        got, arena = compact_gather_text(t, case["min_seq"], doc, text)
        want, want_arena = compact_gather_text_ref(
            t.to("cpu"), case["min_seq"], doc.cpu(), text.cpu())
        _assert_whole_table_equal(got, want, case["label"])
        assert torch.equal(arena.cpu(), want_arena), case["label"]
    assert tzk.compaction_kernel.launches - before == len(cases)
    wide = interop.segment_table_from_numpy(random_case(
        64, 4, tzk.COMPACTION_MAX_KK + 1, 50, 27, 600, 400)["table"], cuda)
    with pytest.raises(ValueError, match="prop keys"):
        tzk.compaction_kernel(wide, 0, doc[:600], text[:400])
    assert tzk.compaction_kernel.launches - before == len(cases)


def test_zamboni_kernel_on_a_scan_replica(cuda):
    """The table a scan-engine replay leaves with no host compaction, at
    its last MSN and at MSN 0 (the MSN a tensor on the card), against
    the plain version; the text stays and no row is added."""
    rep = ColumnarReplica(_stream(), initial_len=64, chunk_size=256,
                          capacity=16384, n_removers=24,
                          compact_watermark=1.1, engine="scan", device=cuda)
    rep.replay()
    rep.check_errors()
    assert rep.compactions == 0
    before = rep.get_text()
    n = int(rep.table.n_rows)
    for msn in (rep._applied_min_seq, 0):
        got = tzk.zamboni_kernel(
            rep.table, torch.tensor(msn, dtype=torch.int32, device=cuda))
        want = zamboni_device_ref(rep.table.to("cpu"), msn)
        _assert_whole_table_equal(got, want, f"MSN {msn}")
    rep.table = zamboni_device(rep.table, rep._applied_min_seq)
    assert rep.get_text() == before
    assert int(rep.table.n_rows) < n


def test_cuda_scan_engine_matches_cpu(cuda):
    """The scan engine on the card (the scan kernel, one block a chunk)
    against the same replica on the CPU, on the lagged 2000-op stream:
    table rows, capacity, compactions, row bound, text and digest; one
    launch a chunk."""
    stream = generate_lagged_stream(2000, n_clients=64, seed=5, window=256,
                                    initial_len=64)
    kw = dict(initial_len=64, chunk_size=128, capacity=2048, n_removers=8,
              n_prop_keys=8, engine="scan")
    gpu = ColumnarReplica(stream, device=cuda, **kw)
    before = tms.mergetree_scan_kernel.launches
    gpu.replay()
    assert tms.mergetree_scan_kernel.launches - before == gpu.n_chunks
    cpu = ColumnarReplica(stream, device="cpu", **kw)
    cpu.replay()
    assert gpu.compactions == cpu.compactions > 0
    assert (gpu.capacity, gpu._rows_bound) == (cpu.capacity, cpu._rows_bound)
    _assert_row_tables_equal(gpu.table.to("cpu"), cpu.table)
    assert np.array_equal(gpu.doc_text, cpu.doc_text)
    assert state_digest(gpu.annotated_spans()) == state_digest(
        cpu.annotated_spans())



# -------------------------------------------------------- the deli's role


def _role_deltas(shared, fmt):
    import os

    from fluidframework_tpu_torch.server.columnar_log import make_topic
    from fluidframework_tpu_torch.testing.deli_streams import (
        canonical_role_record,
    )

    return [canonical_role_record(r) for r in make_topic(
        os.path.join(shared, "topics", "deltas.jsonl"), fmt).read_from(0)]


def _role_run(shared, recs, dev, fmt, frame, batch):
    """`KernelDeliRole` on `dev` over `recs` written as the raw topic of
    `shared`: (deltas, final snapshot, sequencer launches)."""
    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
    from fluidframework_tpu_torch.server.deli_kernel import KernelDeliRole
    from fluidframework_tpu_torch.testing.deli_streams import write_raw_topic

    write_raw_topic(shared, recs, frame, fmt)
    role = KernelDeliRole(shared, owner="t", ttl_s=3600.0, batch=batch,
                          log_format=fmt, device=dev)
    before = tsk.sequencer_step_kernel.launches
    while role.step():
        pass
    launches = tsk.sequencer_step_kernel.launches - before
    if dev != "cpu":
        assert launches == role.core.pool.chunks > 0
    return (_role_deltas(shared, fmt), role.snapshot_state(), launches,
            dict(role.planned))


@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_cuda_deli_role_matches_cpu_role(cuda, fmt, tmp_path):
    """`KernelDeliRole` on the card and on the CPU over the role's wire
    traffic (duplicate joins, resubmissions, junk, unknown clients,
    boxcars with aborts, long op runs with nacks): the same deltas and
    snapshots, on JSON and columnar topics."""
    from fluidframework_tpu_torch.testing.deli_streams import (
        gen_boxcar_wire,
        gen_wire_traffic,
    )

    recs = gen_wire_traffic(31, docs=4, clients=4, ops=30) + \
        gen_boxcar_wire(3)
    recs.insert(200, dict(recs[199], clientSeq=recs[199].get(
        "clientSeq", 0) + 9))
    gpu = _role_run(str(tmp_path / "gpu"), recs, cuda, fmt, 64, 256)
    cpu = _role_run(str(tmp_path / "cpu"), recs, "cpu", fmt, 64, 256)
    assert gpu[0] == cpu[0] and gpu[1] == cpu[1] and gpu[3] == cpu[3]
    if fmt == "columnar":
        assert gpu[3]["run"] > 0


def test_cuda_deli_role_config5_first_pump(cuda, tmp_path):
    """The first pump of BASELINE config 5 (16,384 records, one frame)
    through the role on the card and on the CPU: the same deltas and
    snapshot, one launch."""
    from fluidframework_tpu_torch.testing.deli_streams import (
        build_pipeline_workload,
    )

    recs = build_pipeline_workload(10_000, 64, 1, seed=5, limit=16384)
    gpu = _role_run(str(tmp_path / "gpu"), recs, cuda, "columnar", 16384,
                    16384)
    cpu = _role_run(str(tmp_path / "cpu"), recs, "cpu", "columnar", 16384,
                    16384)
    assert gpu[2] == 1
    assert len(gpu[0]) == 16384
    assert gpu[0] == cpu[0] and gpu[1] == cpu[1]


# -------------------------------------------------- the summarizer's role


def _summary_files(shared):
    import os

    out = {}
    for sub in ("topics", "store", "checkpoints"):
        for root, _dirs, names in os.walk(os.path.join(shared, sub)):
            for n in names:
                rel = os.path.relpath(os.path.join(root, n), shared)
                if ".bell" in rel or rel.endswith(".lock"):
                    continue
                with open(os.path.join(root, n), "rb") as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("backend", ["kernel", "overlay"])
@pytest.mark.parametrize("fmt", ["json", "columnar"])
def test_cuda_summarizer_role_matches_cpu_role(cuda, fmt, backend, tmp_path):
    """`SummarizerRole` stepped on the card and on the CPU over three
    interleaved merge-tree documents (stacked rounds): the same
    manifests, blobs and checkpoint, and the card's launches."""
    from fluidframework_tpu_torch.ops.mergetree_scan import (
        mergetree_scan_kernel,
    )
    from fluidframework_tpu_torch.ops.overlay import overlay_chunk_kernel
    from fluidframework_tpu_torch.server.summarizer import SummarizerRole
    from fluidframework_tpu_torch.testing.catchup_streams import write_deltas
    from fluidframework_tpu_torch.testing.fold_streams import (
        build_mergetree_stream,
    )

    streams = [build_mergetree_stream(400, n_clients=3, seed=s,
                                      doc=f"d{s}") for s in (1, 2, 3)]
    recs = [r for i in range(max(map(len, streams))) for r in
            (s[i] for s in streams if i < len(s))]
    files = {}
    for dev in (cuda, "cpu"):
        shared = str(tmp_path / str(dev))
        write_deltas(shared, recs, fmt, frame=128)
        role = SummarizerRole(shared, owner="t", ttl_s=3600.0, batch=256,
                              ckpt_interval_s=0.0, log_format=fmt,
                              summary_ops=100, fold_backend=backend,
                              device=dev)
        kernel = (mergetree_scan_kernel if backend == "kernel"
                  else overlay_chunk_kernel)
        before = kernel.launches
        while role.step() or role.fence is None:
            pass
        if dev is cuda:
            assert kernel.launches > before
        files[str(dev)] = _summary_files(shared)
    assert files[str(cuda)] == files["cpu"]


def test_cuda_summary_join_matches_cpu(cuda, tmp_path):
    """config10's loop at a small size on the card: every length's
    manifests and digest equal the CPU run's."""
    from fluidframework_tpu_torch.testing.catchup_streams import run_catchup

    got = [run_catchup((600, 1200), log_format="columnar", device=dev,
                       warm=False, work_dir=str(tmp_path / str(dev)))
           for dev in (cuda, "cpu")]
    for a, b in zip(*(g["runs"] for g in got)):
        assert (a["manifests"], a["digest"]) == (b["manifests"],
                                                 b["digest"])
        assert a["launches"]["role"]["scan"] > 0


# --------------------------------------------------- the multi-device layer


def _mesh_replay(device, streams, chunk=256, window=2048, entries=4):
    from fluidframework_tpu_torch.core.overlay_replay import stack_replicas
    from fluidframework_tpu_torch.parallel.mesh import (
        make_docs_mesh,
        sharded_overlay_replay_multi,
    )

    reps = [OverlayDeviceReplica(s, initial_len=64, chunk_size=chunk,
                                 window=window, n_removers=24, device=device)
            for s in streams]
    step = sharded_overlay_replay_multi(
        make_docs_mesh(entries, device), chunk)
    return step(*stack_replicas(reps)), reps[0].n_chunks


def _assert_replay_outputs_equal(got, want):
    tables, logs, counts, cursors, gmsn, gerr = got
    for f in dataclasses.fields(tables):
        assert torch.equal(getattr(tables, f.name).cpu(),
                           getattr(want[0], f.name)), f.name
    assert torch.equal(cursors.cpu(), want[3])
    assert torch.equal(counts.cpu(), want[2])
    for d in range(cursors.shape[0]):
        c = int(cursors[d])
        assert torch.equal(logs[d, :c].cpu(), want[1][d, :c]), d
    assert int(gmsn) == int(want[4]) and int(gerr) == int(want[5])


def test_cuda_sharded_replay_matches_cpu_entries(cuda):
    """8 lagged documents of 3000 ops on 4 entries of the card against
    the same call on 4 CPU entries: every output, exactly; kernel A
    launched once per entry per chunk."""
    streams = [generate_lagged_stream(3000, n_clients=64, seed=5 + d,
                                      window=512, initial_len=64)
               for d in range(8)]
    before = tov.overlay_chunk_kernel.launches
    got, n_chunks = _mesh_replay(cuda, streams)
    torch.cuda.synchronize()
    assert tov.overlay_chunk_kernel.launches - before == 4 * n_chunks
    want, _ = _mesh_replay("cpu", streams)
    _assert_replay_outputs_equal(got, want)


def _pipeline(device):
    """The dry run's row-model step: 8 documents over 4 entries."""
    from fluidframework_tpu_torch.parallel import dryrun
    from fluidframework_tpu_torch.parallel.mesh import (
        make_docs_mesh,
        sharded_pipeline_step,
    )

    one = make_table(128, 4, 8, device)
    one.n_rows.fill_(1)
    one.length[0] = 8
    one.ins_client[0] = -1
    tables = tmk.SegmentTable(*(getattr(one, f.name).expand(
        (8,) + getattr(one, f.name).shape).contiguous()
        for f in dataclasses.fields(tmk.SegmentTable)))
    streams = [dryrun._tiny_stream(16, seed=d) for d in range(8)]
    ops = tmk.stack_op_batches([dryrun._batch_from_stream(s, 16, device)
                                for s in streams])
    dmins = torch.tensor([int(s.min_seq[15]) for s in streams],
                         dtype=torch.int32, device=device)
    return sharded_pipeline_step(make_docs_mesh(4, device))(tables, ops,
                                                            dmins)


def test_cuda_mesh_entries_on_their_own_streams(cuda):
    """Each entry runs on a stream of its own, none of them the
    caller's. Three sharded replays, a pipeline step and a sharded
    deli's pumps are queued back to back, their inputs dropped as they
    go, and the card is synchronised only at the end: every result
    equals the CPU entries'."""
    from fluidframework_tpu_torch.parallel.mesh import make_docs_mesh
    from fluidframework_tpu_torch.server.deli_kernel import PackedDeliCore

    mesh = make_docs_mesh(4, cuda)
    streams = mesh._entry_streams()
    assert len({s.cuda_stream for s in streams}) == 4
    assert torch.cuda.current_stream().cuda_stream not in {
        s.cuda_stream for s in streams}
    with mesh.parallel():
        for i in range(4):
            with mesh.on(i):
                assert torch.cuda.current_stream() == streams[i]
    docs = [generate_lagged_stream(1500, n_clients=16, seed=40 + d,
                                   window=256, initial_len=64)
            for d in range(4)]
    torch.cuda.synchronize()
    outs = [_mesh_replay(cuda, docs)[0] for _ in range(3)]
    pipe = _pipeline(cuda)
    core = PackedDeliCore(dedup=True, mesh=mesh)
    verdicts = _drive_core(core, 7)
    torch.cuda.synchronize()
    want, _ = _mesh_replay("cpu", docs)
    for got in outs:
        _assert_replay_outputs_equal(got, want)
    want_pipe = _pipeline("cpu")
    n_rows = want_pipe[0].n_rows
    assert torch.equal(pipe[0].n_rows.cpu(), n_rows)
    assert torch.equal(pipe[0].error.cpu(), want_pipe[0].error)
    for f in ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
              "rem_clients", "props"):  # rows [:n_rows]; the rest is scratch
        for d in range(8):
            m = int(n_rows[d])
            assert torch.equal(getattr(pipe[0], f)[d, :m].cpu(),
                               getattr(want_pipe[0], f)[d, :m]), (f, d)
    assert int(pipe[1]) == int(want_pipe[1])
    assert int(pipe[2]) == int(want_pipe[2]) == 0
    cpu_core = PackedDeliCore(dedup=True, mesh=make_docs_mesh(4, "cpu"))
    assert verdicts == _drive_core(cpu_core, 7)
    assert core.pool._phys.tolist() == cpu_core.pool._phys.tolist()


def _drive_core(core, seed, pumps=5, per_pump=120, clients=5):
    """Seeded deli traffic into a core, growing its documents pump by
    pump so that a placed pool grows: joins, leaves, boxcars, system
    stamps, invalid ops, resubmissions. Returns the verdicts."""
    import random

    from fluidframework_tpu_torch.ops.sequencer_kernel import (
        NO_GROUP, SUB_JOIN, SUB_LEAVE, SUB_OP, SUB_SYSTEM,
    )

    rng = random.Random(seed)
    out, recent = [], []
    for k in range(pumps):
        core.begin()
        for _ in range(per_pump):
            h = core.touch(f"doc{rng.randrange(4 + 12 * k)}")
            slot, r = h["slot"], rng.random()
            if r < 0.15:
                core.add(slot, SUB_JOIN, core.pool.col_of_join(
                    h, rng.randrange(1, clients + 1)))
            elif r < 0.22:
                core.add(slot, SUB_LEAVE,
                         h["cmap"].get(rng.randrange(1, clients + 1), 0))
            elif r < 0.27:
                core.add(slot, SUB_SYSTEM)
            elif r < 0.4:
                g = core.new_group(slot)
                col = rng.randrange(0, clients + 1)
                for _ in range(rng.randrange(2, 5)):
                    core.add(slot, SUB_OP, col, rng.randrange(1, 9),
                             rng.randrange(0, 5), g)
            elif r < 0.5 and recent:
                core.add(*rng.choice(recent))
            else:
                sub = (slot, SUB_OP, rng.randrange(0, clients + 1),
                       rng.randrange(1, 9), rng.randrange(0, 5), NO_GROUP)
                recent = (recent + [sub])[-32:]
                core.add(*sub)
        res = core.run()
        out.append((res.seq, res.msn, res.nack, res.skipped))
    return out


def test_cuda_sharded_deli_core_matches_cpu_entries(cuda):
    """The sharded pool on 4 entries of the card against 4 CPU entries:
    verdicts, the slot map after growth while placed, the checkpoint;
    one sequencer launch per entry per chunk."""
    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
    from fluidframework_tpu_torch.parallel.mesh import make_docs_mesh
    from fluidframework_tpu_torch.server.deli_kernel import PackedDeliCore

    gpu = PackedDeliCore(n_docs=4, dedup=True, mesh=make_docs_mesh(4, cuda))
    cpu = PackedDeliCore(n_docs=4, dedup=True,
                         mesh=make_docs_mesh(4, "cpu"))
    before = tsk.sequencer_step_kernel.launches
    got = _drive_core(gpu, 3)
    assert tsk.sequencer_step_kernel.launches - before == \
        4 * gpu.pool.chunks > 0
    assert got == _drive_core(cpu, 3)
    assert gpu.pool._phys.tolist() == cpu.pool._phys.tolist()
    assert gpu.pool._phys.tolist() != list(range(gpu.pool.n_docs))
    assert gpu.pool.checkpoint_docs() == cpu.pool.checkpoint_docs()
    assert all(s.seq.device.type == "cuda" for s in gpu.pool.state)


def test_cuda_seqshard_matches_cpu_entries(cuda):
    """One document sequence-sharded over 4 entries of the card (the
    masked form, no host sync per op) against 4 CPU entries: every
    shard's rows, n, error and the digest."""
    from fluidframework_tpu_torch.ops.overlay_ref import OverlayReplica
    from fluidframework_tpu_torch.parallel.mesh import make_docs_mesh
    from fluidframework_tpu_torch.parallel.seqshard import (
        run_sequence_sharded,
    )

    initial = 48
    stream = generate_lagged_stream(600, n_clients=8, seed=13, window=64,
                                    initial_len=initial)
    got, gerr = run_sequence_sharded(
        stream, make_docs_mesh(4, cuda, axis="seq"), initial, capacity=448)
    want, werr = run_sequence_sharded(
        stream, make_docs_mesh(4, "cpu", axis="seq"), initial, capacity=448)
    assert gerr == werr == 0
    for a, b in zip(got.shards, want.shards):
        assert (a.n, a.S, a.error) == (b.n, b.S, b.error)
        for f in ("anchor", "buf", "length", "iseq", "iclient", "rseq",
                  "rcl", "props"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    ref = OverlayReplica(stream, initial_len=initial, fold_interval=2048,
                         n_removers=10)
    ref.replay()
    assert state_digest(got.annotated_spans()) == state_digest(
        ref.annotated_spans())


# ---------------------------------------------------------------------------
# the overlay fold kernel (csrc/overlay_fold.cu)


FOLD_FIELDS = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
               "ins_client", "rem_seq", "rem_clients", "props",
               "settled_len", "error")


def _assert_fold_equal(got, want, label):
    for f in FOLD_FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), (
            f"{label}: {f}")
    for i, name in ((1, "records"), (2, "n_rec")):
        assert torch.equal(got[i], want[i]), f"{label}: {name}"


def _hold_fold_append(table, msn, cursor, cap, label, epoch=1,
                      cluster=None):
    """The append form against `fold_append_ref` on the same CUDA
    inputs: the whole log, counts, the cursor and the table; the kernel
    at the cluster size the wrapper picks, or at `cluster`."""
    KK = table.props.shape[-1]
    lead = tuple(table.length.shape[:-1])
    g = torch.Generator().manual_seed(cap)
    log0 = torch.randint(-50, 50, lead + (cap, 5 + KK), generator=g,
                         dtype=torch.int32).to(table.device)
    counts0 = torch.zeros(lead + (3,), dtype=torch.int32,
                          device=table.device)
    cur = torch.as_tensor(np.broadcast_to(np.asarray(cursor, np.int32),
                                          lead).copy()).to(table.device)
    outs = []
    kernel = tov.fold_append if cluster is None else (
        lambda *a: tov.overlay_fold_kernel.append(*a, cluster=cluster))
    for fn in (kernel, tov.fold_append_ref):
        log, counts = log0.clone(), counts0.clone()
        t, c = fn(table, msn, log, counts, cur, epoch)
        outs.append((t, log, counts, c))
    (t1, l1, c1, k1), (t2, l2, c2, k2) = outs
    for f in FOLD_FIELDS:
        assert torch.equal(getattr(t1, f), getattr(t2, f)), f"{label}: {f}"
    assert torch.equal(l1, l2), f"{label}: log"
    assert torch.equal(c1, c2), f"{label}: counts"
    assert torch.equal(k1, k2), f"{label}: cursor"


@pytest.mark.parametrize("W", [1024, 2048, 8192])
def test_fold_kernel_edge_tables(cuda, W):
    """Every table of `testing/fold_edges.py` through the fold kernel and
    its append form (cursors that fit, clamp and pass the capacity),
    against the plain versions on the same CUDA inputs, exactly: the
    whole table, records, n_rec, log, counts and cursor; the MSN an int
    and a tensor on the card; the input left as it was."""
    from fluidframework_tpu_torch.testing.fold_edges import edge_cases

    before = tov.overlay_fold_kernel.launches
    cases = edge_cases(W, 4, 8, seed=W)
    for i, case in enumerate(cases):
        t = interop.table_from_numpy(case.table, cuda)
        copy = interop.table_from_numpy(case.table, cuda)
        msn = case.msn
        if np.ndim(msn) or i % 2:
            msn = torch.as_tensor(np.asarray(msn, np.int32)).to(cuda)
        _assert_fold_equal(tov.fold_device(t, msn),
                           tov.fold_device_ref(t, msn), case.name)
        _hold_fold_append(t, msn, case.cursor, case.cap, case.name)
        for f in FOLD_FIELDS:
            assert torch.equal(getattr(t, f), getattr(copy, f)), case.name
    assert tov.overlay_fold_kernel.launches - before == 2 * len(cases)


@pytest.mark.parametrize("D,W,KR,KK", [(132, 2048, 4, 8), (1, 8192, 24, 8),
                                        (132, 2048, 24, 8)])
def test_fold_kernel_random_stacks(cuda, D, W, KR, KK):
    """Random tables at the docs replay's and the fold's shapes (D = 132)
    and the replica's default window, an MSN per document."""
    from fluidframework_tpu_torch.testing.fold_edges import random_table

    rng = np.random.default_rng(D + W + KR)
    t = interop.table_from_numpy(
        random_table(rng, W, KR, KK, D=None if D == 1 else D), cuda)
    msn = torch.as_tensor(rng.integers(0, 100, (D,) if D > 1 else ())
                          .astype(np.int32)).to(cuda)
    _assert_fold_equal(tov.fold_device(t, msn), tov.fold_device_ref(t, msn),
                       f"D{D} W{W}")
    _hold_fold_append(t, msn, W // 3, 2 * W, f"D{D} W{W} append")
    _hold_fold_append(t, msn, 2 * W, 2 * W, f"D{D} W{W} clamped")


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_fold_kernel_cluster_sizes(cuda, G):
    """The fold kernel with its cluster size forced to G: every table
    of `testing/fold_edges.py` (the tile-boundary cases among them) at
    W 1024 and 2048, and random stacks of D = 8 and 132 at the bench
    geometry, both forms, against the plain versions on the same CUDA
    inputs, exactly; one launch a call."""
    from fluidframework_tpu_torch.testing.fold_edges import (
        edge_cases, random_table,
    )

    before = tov.overlay_fold_kernel.launches
    n = 0
    for W in (1024, 2048):
        for case in edge_cases(W, 4, 8, seed=W + G):
            t = interop.table_from_numpy(case.table, cuda)
            msn = torch.as_tensor(np.asarray(case.msn, np.int32)).to(cuda)
            label = f"{case.name} W{W} G{G}"
            _assert_fold_equal(tov.overlay_fold_kernel(t, msn, cluster=G),
                               tov.fold_device_ref(t, msn), label)
            _hold_fold_append(t, msn, case.cursor, case.cap, label,
                              cluster=G)
            n += 2
    rng = np.random.default_rng(G)
    for D in (8, 132):
        t = interop.table_from_numpy(random_table(rng, 2048, 24, 8, D=D),
                                     cuda)
        msn = torch.as_tensor(rng.integers(0, 100, D).astype(np.int32)
                              ).to(cuda)
        _assert_fold_equal(tov.overlay_fold_kernel(t, msn, cluster=G),
                           tov.fold_device_ref(t, msn), f"D{D} G{G}")
        _hold_fold_append(t, msn, 2048, 4096, f"D{D} G{G} append",
                          cluster=G)
        n += 2
    assert tov.overlay_fold_kernel.launches - before == n


def test_fold_kernel_picked_cluster_sizes(cuda):
    """The cluster size the wrapper picks for D = 1, 4, 8, 32 and 132
    documents of 2048 rows on this card (8, 8, 8, 4, 1 on 132 SMs),
    each fold exact against the plain version; an empty launch of the
    same shape is accepted and not counted."""
    from fluidframework_tpu_torch.testing.fold_edges import random_table

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rng = np.random.default_rng(5)
    for D in (1, 4, 8, 32, 132):
        t = interop.table_from_numpy(random_table(
            rng, 2048, 24, 8, D=None if D == 1 else D), cuda)
        msn = torch.as_tensor(rng.integers(0, 100, (D,) if D > 1 else ())
                              .astype(np.int32)).to(cuda)
        _assert_fold_equal(tov.fold_device(t, msn),
                           tov.fold_device_ref(t, msn), f"D{D}")
        if sms == 132:
            assert tov.fold_cluster(D, 2048, 8, sms) == {
                1: 8, 4: 8, 8: 8, 32: 4, 132: 1}[D]
        before = tov.overlay_fold_kernel.launches
        tov.overlay_fold_kernel.launch_empty(cuda, D, 2048, 8)
        torch.cuda.synchronize()
        assert tov.overlay_fold_kernel.launches == before


def test_fold_kernel_on_replay_chunks(cuda):
    """The fold kernel after each chunk of kernel A on a lagged stream,
    against the plain version on the same table, exactly."""
    rep = OverlayDeviceReplica(_stream(), initial_len=64, chunk_size=256,
                               window=2048, n_removers=24, device=cuda)
    rep.prepare()
    table = rep.table
    for ci in range(rep.n_chunks):
        ops = rep._dev.slice(ci * 256, (ci + 1) * 256)
        table = tov.overlay_chunk_kernel(table, ops)
        got = tov.fold_device(table, rep._msn_by_chunk[ci])
        _assert_fold_equal(got, tov.fold_device_ref(
            table, rep._msn_by_chunk[ci]), f"chunk {ci}")
        table = got[0]


def test_replay_is_two_launches_a_chunk(cuda):
    """`replay_fused` on the card: kernel A and the fold kernel once a
    chunk each, for one document and for the docs form; the results
    equal the CPU replay's."""
    stream = _stream()
    kw = dict(initial_len=64, chunk_size=256, window=2048, n_removers=24)
    a0 = tov.overlay_chunk_kernel.launches
    f0 = tov.overlay_fold_kernel.launches
    rep = OverlayDeviceReplica(stream, device=cuda, **kw)
    rep.replay()
    torch.cuda.synchronize()
    n = rep.n_chunks
    assert tov.overlay_chunk_kernel.launches - a0 == n
    assert tov.overlay_fold_kernel.launches - f0 == n
    cpu = OverlayDeviceReplica(stream, device="cpu", **kw)
    cpu.replay()
    assert int(rep.cursor) == int(cpu.cursor)
    assert torch.equal(rep.counts.cpu(), cpu.counts)
    c = int(cpu.cursor)
    assert torch.equal(rep.log[:c].cpu(), cpu.log[:c])
    reps = [OverlayDeviceReplica(stream, device=cuda, **kw) for _ in range(3)]
    for r in reps:
        r.prepare()
    a0 = tov.overlay_chunk_kernel.launches
    f0 = tov.overlay_fold_kernel.launches
    _tables, _logs, counts, cursors, _gmsn, _gerr = replay_docs(reps)
    torch.cuda.synchronize()
    assert tov.overlay_chunk_kernel.launches - a0 == n
    assert tov.overlay_fold_kernel.launches - f0 == n
    assert torch.equal(cursors.cpu(), torch.full((3,), c, dtype=torch.int32))
    assert torch.equal(counts[1].cpu(), cpu.counts)
