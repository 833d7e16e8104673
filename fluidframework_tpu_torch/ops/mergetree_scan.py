"""The row-model scan's hand-written CUDA kernel and its launcher.

`MergetreeScanKernel` launches ``csrc/mergetree_scan.cu``: a chunk of
B sequenced ops applied to the segment tables of D documents, one
block per document, all D documents in one launch. It replaces the XLA
scan `_apply_one` under `apply_op_batch` and `apply_op_batch_docs_jit`
(fluidframework_tpu/ops/mergetree_kernel.py:289, :383, :404-409). Its
plain version is `mergetree_kernel.apply_op_batch_ref` /
`apply_op_batch_docs_ref`; the dispatchers `apply_op_batch` and
`apply_op_batch_docs` send CUDA tables here.

`scan_geometry` gives a block's threads, rows per thread and shared
bytes, and raises ValueError above the capacity ceiling (8192 rows,
within the 227 KB of opt-in shared memory with the chunk's ops).
"""

from __future__ import annotations

import ctypes
from dataclasses import fields

import torch

from . import _build
from .mergetree_kernel import OpBatch, SegmentTable

I32 = torch.int32

# These constants must match csrc/mergetree_scan.cu.
MAX_THREADS = 1024
MAX_ROWS_PER_THREAD = 8
MAX_CAPACITY = MAX_THREADS * MAX_ROWS_PER_THREAD  # 8192 rows
HOT_COLS = 6  # buf_start, length, ins_seq, ins_client, rem_seq, slot
OP_COLS = 8  # op_type, pos1, pos2, seq, ref_seq, client, buf, len
SMEM_MISC = 1024  # bytes of the block's scan and min scratch
SMEM_OPTIN = 232448  # an H100 block's opt-in dynamic shared memory (227 KB)


def scan_geometry(capacity: int, B: int, PK: int):
    """The kernel's block for tables of `capacity` rows and chunks of B
    ops with PK prop slots: (NT threads, R rows per thread, dynamic
    shared bytes). NT is `capacity` rounded up to a warp, at most 1024;
    thread t owns rows [t*R, t*R + R). Raises ValueError above the
    ceiling: capacity <= 8192 (R <= 8) and the six hot columns plus
    the chunk's ops within the opt-in shared memory."""
    if capacity < 1 or B < 0 or PK < 0:
        raise ValueError("scan_geometry: bad table or chunk sizes")
    if capacity > MAX_CAPACITY:
        raise ValueError(
            f"capacity {capacity} is above the scan kernel's ceiling of "
            f"{MAX_CAPACITY} rows ({MAX_ROWS_PER_THREAD} rows a thread at "
            f"{MAX_THREADS} threads)")
    NT = min(MAX_THREADS, -(-capacity // 32) * 32)
    R = -(-capacity // NT)
    cols = 4 * (HOT_COLS * capacity + OP_COLS * B + 2 * B * PK)
    smem = -(-cols // 16) * 16 + SMEM_MISC
    if smem > SMEM_OPTIN:
        raise ValueError(
            f"the scan kernel needs {smem} shared bytes for capacity "
            f"{capacity} and chunks of {B} ops x {PK} prop slots; the "
            f"ceiling is {SMEM_OPTIN}")
    return NT, R, smem


class MergetreeScanKernel:
    """Launches ``csrc/mergetree_scan.cu`` for one chunk of ops on D
    documents' tables.

    ``launches`` counts the kernel launches this wrapper made; it is
    incremented where the kernel is launched and nowhere else. `docs`
    takes tables and ops with a leading ``[D]`` axis and makes one
    launch of D blocks; calling the wrapper on one table launches one
    block. The wrapper checks device, dtype, shape and capacity,
    allocates the output tables and the per-document cold-row heap
    (``[D, C + 2B, KR + KK]``), launches on PyTorch's current stream
    without synchronising, and raises if the launch was refused: there
    is no fallback. The inputs are never written. Rows at and above
    ``n_rows`` of the output are scratch."""

    name = "mergetree_scan"
    source = "fluidframework_tpu_torch/csrc/mergetree_scan.cu"
    replaces = "fluidframework_tpu/ops/mergetree_kernel.py:289"

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = _build.load(self.name)
            fn = lib.mergetree_scan_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 11 + [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def __call__(self, table: SegmentTable, ops: OpBatch) -> SegmentTable:
        stacked = self.docs(
            SegmentTable(*(getattr(table, f.name)[None]
                           for f in fields(SegmentTable))),
            OpBatch(*(getattr(ops, f.name)[None] for f in fields(OpBatch))))
        return stacked.doc(0)

    def docs(self, tables: SegmentTable, ops: OpBatch) -> SegmentTable:
        dev = tables.length.device
        if dev.type != "cuda":
            raise ValueError(
                f"the mergetree scan CUDA kernel needs CUDA tensors, got {dev}")
        if tables.length.dim() != 2 or tables.rem_clients.dim() != 3:
            raise ValueError("mergetree scan: tables must be stacked [D, C]")
        D, C = tables.length.shape
        KR = tables.rem_clients.shape[2]
        KK = tables.props.shape[2]
        if ops.prop_keys.dim() != 3:
            raise ValueError("mergetree scan: ops must be stacked [D, B]")
        B, PK = ops.prop_keys.shape[1:]
        if KR < 1:
            raise ValueError("the table needs at least one remover slot")
        if D < 1:
            raise ValueError("mergetree scan: no documents")
        ins = [tables.n_rows, tables.error, tables.buf_start, tables.length,
               tables.ins_seq, tables.ins_client, tables.rem_seq,
               tables.rem_clients, tables.props,
               ops.op_type, ops.pos1, ops.pos2, ops.seq, ops.ref_seq,
               ops.client, ops.buf_start, ops.ins_len, ops.prop_keys,
               ops.prop_vals]
        for t in ins:
            if t.device != dev or t.dtype != I32:
                raise ValueError(
                    "mergetree scan kernel inputs must be int32 tensors on "
                    f"{dev}; got {t.dtype} on {t.device}")
        shapes = ([(D,)] * 2 + [(D, C)] * 5 + [(D, C, KR), (D, C, KK)]
                  + [(D, B)] * 8 + [(D, B, PK)] * 2)
        for t, shape in zip(ins, shapes):
            if tuple(t.shape) != shape:
                raise ValueError(f"mergetree scan kernel: shape "
                                 f"{tuple(t.shape)} where {shape} was "
                                 f"expected")
        NT, R, smem = scan_geometry(C, B, PK)
        ins = [t.contiguous() for t in ins]
        out = SegmentTable(
            n_rows=torch.empty_like(ins[0]), error=torch.empty_like(ins[1]),
            buf_start=torch.empty_like(ins[2]), length=torch.empty_like(ins[3]),
            ins_seq=torch.empty_like(ins[4]),
            ins_client=torch.empty_like(ins[5]),
            rem_seq=torch.empty_like(ins[6]),
            rem_clients=torch.empty_like(ins[7]),
            props=torch.empty_like(ins[8]))
        heap = torch.empty((D, C + 2 * B, KR + KK), dtype=I32, device=dev)
        outs = [out.buf_start, out.length, out.ins_seq, out.ins_client,
                out.rem_seq, out.rem_clients, out.props, out.n_rows,
                out.error]
        _build.launch(self.name, self._entry(), dev,
                      (D, C, KR, KK, B, PK, NT, R, smem),
                      ins + outs + [heap])
        self.launches += 1
        return out


mergetree_scan_kernel = MergetreeScanKernel()
