"""The row-model scan kernel's own source, run on the CPU.

`fluidframework_tpu_torch/testing/scan_host_emu.py` compiles
``csrc/mergetree_scan.cu`` with g++ against a host emulation of the
CUDA features it uses (a thread per CUDA thread, barriers, warp
exchanges), so these tests hold the kernel's logic -- its op loops, its
layouts, its copies of the live rows -- against the plain version
`apply_op_batch_ref` (tolerance 0 on n_rows, error and rows
[:min(n_rows, C)]) without a card. They say nothing of its speed; the
card's tests (`tests/test_torch_cuda.py`) run the same cases on the
real kernel.
"""

import shutil

import numpy as np
import pytest

from fluidframework_tpu_torch import interop
from fluidframework_tpu_torch.ops import mergetree_kernel as tmk
from fluidframework_tpu_torch.testing import scan_host_emu
from fluidframework_tpu_torch.testing.block_edges import edge_table
from fluidframework_tpu_torch.testing.scan_edges import (
    OP_LOOP_CASES,
    random_chunk,
    scan_edge_chunks,
)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host emulation is built with g++")

ROW_FIELDS = ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
              "rem_clients", "props")


def _assert_equal(got, want, label):
    for d in range(want.n_rows.shape[0]):
        n = int(want.n_rows[d])
        assert (int(got.n_rows[d]), int(got.error[d])) == (
            n, int(want.error[d])), (label, d)
        m = min(n, want.length.shape[1])
        for f in ROW_FIELDS:
            assert np.array_equal(getattr(got, f)[d, :m].numpy(),
                                  getattr(want, f)[d, :m].numpy()), (
                label, d, f)


def _stacked(table, ops):
    return (tmk.stack_segment_tables([table]), tmk.stack_op_batches([ops]))


# The edge chunks run at C 16384 (the hot columns and the heap in global
# memory, the swept loop): the one-pass op's cases, a full table and the
# live-row counts around a warp's rows. Every case runs at C 512.
GLOBAL_LAYOUT_LABELS = (
    "full table: remove splitting two rows",
    "an insert strictly inside a row",
    "a remove and an annotate inside one row",
    "a remove and an annotate across adjacent rows",
    "a range op across rows of zero visibility and tombstones",
    "33 live rows",
    "255 live rows",
    "a chunk that grows its table across a warp's rows",
)


@pytest.mark.parametrize("C", [512, 16384])
def test_emulated_scan_edge_chunks(C):
    """The edge chunks alone, and the chunks of 128 ops stacked in one
    launch (C 512: every case, the register-resident op loops; C 16384:
    `GLOBAL_LAYOUT_LABELS`, the hot columns and the heap in global
    memory, the swept loop)."""
    cases = scan_edge_chunks(C, 4, 8, 4, 128)
    if C > 512:
        cases = [c for c in cases if c["label"] in GLOBAL_LAYOUT_LABELS]
        assert len(cases) == len(GLOBAL_LAYOUT_LABELS)
    for case in cases:
        t, o = _stacked(interop.segment_table_from_numpy(case["table"], "cpu"),
                        interop.opbatch_from_numpy(case["ops"], "cpu"))
        got, _ = scan_host_emu.run_docs(t, o)
        _assert_equal(got, tmk.apply_op_batch_docs_ref(t, o), case["label"])
    full = [c for c in cases if c["ops"]["op_type"].shape[0] == 128]
    t = interop.segment_table_from_numpy({k: np.stack(
        [c["table"][k] for c in full]) for k in full[0]["table"]}, "cpu")
    o = interop.opbatch_from_numpy({k: np.stack(
        [c["ops"][k] for c in full]) for k in full[0]["ops"]}, "cpu")
    got, geometry = scan_host_emu.run_docs(t, o)
    _assert_equal(got, tmk.apply_op_batch_docs_ref(t, o), "stacked")
    assert geometry.shape == (len(full), 2)


@pytest.mark.parametrize("C, n, loop", OP_LOOP_CASES)
def test_emulated_scan_op_loops(C, n, loop):
    """Each op loop, as the block reports it, on a chunk of random ops."""
    t, o = _stacked(
        interop.segment_table_from_numpy(edge_table(C, 4, 8, n), "cpu"),
        interop.opbatch_from_numpy(random_chunk(n, 128, 4, C + n), "cpu"))
    got, geometry = scan_host_emu.run_docs(t, o)
    assert tuple(geometry[0].tolist()) == loop
    want = tmk.apply_op_batch_docs_ref(t, o)
    assert int(want.error[0]) == 0 and int(want.n_rows[0]) > n
    _assert_equal(got, want, f"C {C} n {n}")
