"""The row-model scan's hand-written CUDA kernel and its launcher.

`MergetreeScanKernel` launches ``csrc/mergetree_scan.cu``: a chunk of
B sequenced ops applied to the segment tables of D documents, one
block per document, all D documents in one launch. It replaces the XLA
scan `_apply_one` under `apply_op_batch` and `apply_op_batch_docs_jit`
(fluidframework_tpu/ops/mergetree_kernel.py:289, :383, :404-409). Its
plain version is `mergetree_kernel.apply_op_batch_ref` /
`apply_op_batch_docs_ref`; the dispatchers `apply_op_batch` and
`apply_op_batch_docs` send CUDA tables here.

`scan_geometry` gives a block's threads, layout and shared bytes: the
chunk's ops always in shared memory, then the hot columns, the cold
heap's remover half and its props half each in shared memory where it
still fits (else in global memory, the hot columns in a per-document
scratch). It raises only where a chunk's ops cannot fit in shared
memory; there is no capacity ceiling. Each block picks its op loop's
rows a thread and warps from its own n_rows on the card and reports
them (`MergetreeScanKernel.last_geometry`).
"""

from __future__ import annotations

import ctypes
from dataclasses import fields
from typing import NamedTuple, Optional

import torch

from . import _build
from .mergetree_kernel import OpBatch, SegmentTable

I32 = torch.int32

# These constants must match csrc/mergetree_scan.cu.
THREADS = 512
HOT_COLS = 6  # buf_start, length, ins_seq, ins_client, rem_seq, slot
OP_COLS = 8  # op_type, pos1, pos2, seq, ref_seq, client, buf, len
SMEM_MISC = 2048  # bytes of the block's scan and search slots
SMEM_OPTIN = 232448  # an H100 block's opt-in dynamic shared memory (227 KB)
# `layout` bits: the part lies in shared memory.
LAYOUT_HOT, LAYOUT_REMOVERS, LAYOUT_PROPS = 1, 2, 4


class ScanGeometry(NamedTuple):
    """A launch's block: threads, where the hot columns, the remover
    half and the props half of the cold heap lie ("shared" or
    "global"), and the dynamic shared bytes."""

    threads: int
    hot: str
    removers: str
    props: str
    smem: int

    @property
    def layout(self) -> int:
        return ((LAYOUT_HOT if self.hot == "shared" else 0)
                | (LAYOUT_REMOVERS if self.removers == "shared" else 0)
                | (LAYOUT_PROPS if self.props == "shared" else 0))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def scan_geometry(capacity: int, B: int, PK: int, KR: int = 4,
                  KK: int = 8) -> ScanGeometry:
    """The kernel's block for tables of `capacity` rows with KR remover
    and KK prop columns, and chunks of B ops with PK prop slots.

    The block has 512 threads, all of which copy the live rows in and
    out. The hot columns take shared memory first (rows permuted within
    each 32-row group) where they fit beside the ops, else a
    per-document scratch in global memory; then the remover half of the
    cold heap (C + 2B rows of KR ints) and its props half (KK ints) each
    take shared memory where it still fits. Each block takes its op
    loop from the rows its chunk can reach, min(C, n_rows + 2B): one or
    two rows a thread in registers up to 512 or 1024 of them with the
    hot columns in shared memory, else the swept loop (the fewest even
    number of rows a thread at which its 16 warps hold them), on the
    warps those rows need. Raises ValueError only where the chunk's ops
    do not fit in shared memory."""
    if capacity < 1 or B < 0 or PK < 0 or KR < 1 or KK < 0:
        raise ValueError("scan_geometry: bad table or chunk sizes")
    C = capacity
    smem = SMEM_MISC + 4 * (OP_COLS * B + 2 * B * PK)
    if smem > SMEM_OPTIN:
        raise ValueError(
            f"the scan kernel needs {smem} shared bytes for chunks of {B} "
            f"ops x {PK} prop slots alone; a block has {SMEM_OPTIN}")
    hot_bytes = 4 * HOT_COLS * _ceil(C, 32) * 32
    hot = "shared" if smem + hot_bytes <= SMEM_OPTIN else "global"
    if hot == "shared":
        smem += hot_bytes
    parts = []
    for cols in (KR, KK):
        part = 4 * (C + 2 * B) * cols
        parts.append("shared" if smem + part <= SMEM_OPTIN else "global")
        if parts[-1] == "shared":
            smem += part
    return ScanGeometry(THREADS, hot, parts[0], parts[1], smem)


class MergetreeScanKernel:
    """Launches ``csrc/mergetree_scan.cu`` for one chunk of ops on D
    documents' tables.

    ``launches`` counts the kernel launches this wrapper made; it is
    incremented where the kernel is launched and nowhere else. `docs`
    takes tables and ops with a leading ``[D]`` axis and makes one
    launch of D blocks; calling the wrapper on one table launches one
    block. The wrapper checks device, dtype and shape, takes the block
    from `scan_geometry`, allocates the output tables, the per-document
    cold-row heap (``[D, C + 2B, KR + KK]``, where a half of it lies in
    global memory) and the hot scratch (``[D, 6, C rounded up to 32]``,
    where the hot columns do), launches on PyTorch's current stream
    without synchronising, and raises if the launch was refused: there
    is no fallback. The inputs are never written. Rows at and above
    ``n_rows`` of the output are scratch (not written).
    ``last_geometry`` is the last launch's ``[D, 2]`` int32 output on
    the card: the rows a thread and the warps of each block's op
    loop."""

    name = "mergetree_scan"
    source = "fluidframework_tpu_torch/csrc/mergetree_scan.cu"
    replaces = "fluidframework_tpu/ops/mergetree_kernel.py:289"

    def __init__(self) -> None:
        self.launches = 0
        self.last_geometry: Optional[torch.Tensor] = None
        self._fn = None

    @staticmethod
    def bind(lib: ctypes.CDLL):
        """The C entry of a loaded kernel library, typed."""
        fn = lib.mergetree_scan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 10 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        return fn

    def _entry(self):
        if self._fn is None:
            self._fn = self.bind(_build.load(self.name))
        return self._fn

    def __call__(self, table: SegmentTable, ops: OpBatch) -> SegmentTable:
        stacked = self.docs(
            SegmentTable(*(getattr(table, f.name)[None]
                           for f in fields(SegmentTable))),
            OpBatch(*(getattr(ops, f.name)[None] for f in fields(OpBatch))))
        return stacked.doc(0)

    def docs(self, tables: SegmentTable, ops: OpBatch) -> SegmentTable:
        """One launch for a chunk of every document."""
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
        g = scan_geometry(C, B, PK, KR, KK)
        ins = [t.contiguous() for t in ins]
        out = SegmentTable(
            n_rows=torch.empty_like(ins[0]), error=torch.empty_like(ins[1]),
            buf_start=torch.empty_like(ins[2]), length=torch.empty_like(ins[3]),
            ins_seq=torch.empty_like(ins[4]),
            ins_client=torch.empty_like(ins[5]),
            rem_seq=torch.empty_like(ins[6]),
            rem_clients=torch.empty_like(ins[7]),
            props=torch.empty_like(ins[8]))
        global_heap = "global" in (g.removers, g.props)
        heap = torch.empty((D, C + 2 * B, KR + KK) if global_heap else (1,),
                           dtype=I32, device=dev)
        hot = torch.empty((D, HOT_COLS, _ceil(C, 32) * 32)
                          if g.hot == "global" else (1,),
                          dtype=I32, device=dev)
        geometry = torch.empty((D, 2), dtype=I32, device=dev)
        outs = [out.buf_start, out.length, out.ins_seq, out.ins_client,
                out.rem_seq, out.rem_clients, out.props, out.n_rows,
                out.error]
        _build.launch(self.name, self._entry(), dev,
                      (D, C, KR, KK, B, PK, g.layout, g.smem),
                      ins + outs + [heap, hot, geometry])
        self.launches += 1
        self.last_geometry = geometry
        return out


mergetree_scan_kernel = MergetreeScanKernel()
