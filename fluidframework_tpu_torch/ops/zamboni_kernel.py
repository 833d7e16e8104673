"""The row-model zamboni's hand-written CUDA kernel and its launcher.

`ZamboniKernel` launches ``csrc/zamboni.cu``: the compaction of one
segment table under an applied MSN (tombstones removed at or below it
dropped, settled neighbours contiguous in the arena merged), in five
launches of one block a tile of `TILE` rows on PyTorch's current
stream, with no host sync. It replaces the XLA function
`zamboni_device` (fluidframework_tpu/ops/zamboni.py:42); its plain
version is `ops/zamboni.zamboni_device_ref`, and the dispatcher
`ops/zamboni.zamboni_device` sends CUDA tables here.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .mergetree_kernel import SegmentTable

I32 = torch.int32

# These constants must match csrc/zamboni.cu.
THREADS = 256
TILE = 1024  # rows a block: 4 a thread


def tiles(capacity: int) -> int:
    """The blocks of each of the kernel's launches for a table of
    `capacity` rows."""
    return -(-capacity // TILE)


def scratch_ints(capacity: int) -> int:
    """The int32 scratch of one launch: three values a tile (kept rows,
    run starts, lengths), four a row (source rows, start flags, run
    firsts, run prefixes) and two totals."""
    return 3 * tiles(capacity) + 4 * capacity + 2


class ZamboniKernel:
    """Launches ``csrc/zamboni.cu`` on one table.

    ``launches`` counts the calls that launched the kernel (one call is
    the kernel's five launches); it is incremented where the kernel is
    launched and nowhere else. The wrapper checks device, dtype, shape
    and contiguity, allocates the output table and the scratch, puts the
    MSN on the card (a tensor stays where it is; an int is copied), and
    raises if a launch was refused: there is no fallback. The input is
    never written. Every output row is written (rows at and above the
    output's ``n_rows`` hold the empty-row fills)."""

    name = "zamboni"
    source = "fluidframework_tpu_torch/csrc/zamboni.cu"
    replaces = "fluidframework_tpu/ops/zamboni.py:42"

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    @staticmethod
    def bind(lib: ctypes.CDLL):
        """The C entry of a loaded kernel library, typed."""
        fn = lib.zamboni_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        return fn

    def _entry(self):
        if self._fn is None:
            self._fn = self.bind(_build.load(self.name))
        return self._fn

    @staticmethod
    def check(table: SegmentTable, min_seq: torch.Tensor) -> tuple:
        """(C, KR, KK) of a table the kernel takes; raises ValueError on
        any other."""
        dev = table.length.device
        C = table.length.shape[0] if table.length.dim() == 1 else -1
        if C < 1 or table.rem_clients.dim() != 2 or table.props.dim() != 2:
            raise ValueError("zamboni kernel: one table of [C] and [C, K] "
                             "columns is taken")
        KR, KK = table.rem_clients.shape[1], table.props.shape[1]
        shapes = {"n_rows": (), "error": (), "buf_start": (C,),
                  "length": (C,), "ins_seq": (C,), "ins_client": (C,),
                  "rem_seq": (C,), "rem_clients": (C, KR), "props": (C, KK)}
        for name, shape in shapes.items():
            t = getattr(table, name)
            if t.device != dev or t.dtype != I32:
                raise ValueError(
                    f"zamboni kernel inputs must be int32 tensors on {dev}; "
                    f"{name} is {t.dtype} on {t.device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"zamboni kernel: {name} has shape "
                                 f"{tuple(t.shape)} where {shape} was "
                                 f"expected")
            if not t.is_contiguous():
                raise ValueError(f"zamboni kernel: {name} is not contiguous")
        if (min_seq.device != dev or min_seq.dtype != I32
                or min_seq.numel() != 1):
            raise ValueError("zamboni kernel: min_seq must be one int32 on "
                             f"{dev}")
        return C, KR, KK

    def __call__(self, table: SegmentTable, min_seq) -> SegmentTable:
        dev = table.length.device
        if dev.type != "cuda":
            raise ValueError(
                f"the zamboni CUDA kernel needs CUDA tensors, got {dev}")
        min_seq = torch.as_tensor(min_seq, dtype=I32, device=dev)
        C, KR, KK = self.check(table, min_seq)
        out = SegmentTable(*(torch.empty_like(t) for t in (
            table.n_rows, table.buf_start, table.length, table.ins_seq,
            table.ins_client, table.rem_seq, table.rem_clients, table.props,
            table.error)))
        scratch = torch.empty(scratch_ints(C), dtype=I32, device=dev)
        _build.launch(self.name, self._entry(), dev,
                      (C, KR, KK, tiles(C)),
                      [table.n_rows, table.error, min_seq.reshape(()),
                       table.buf_start, table.length, table.ins_seq,
                       table.ins_client, table.rem_seq, table.rem_clients,
                       table.props,
                       out.buf_start, out.length, out.ins_seq,
                       out.ins_client, out.rem_seq, out.rem_clients,
                       out.props, out.n_rows, out.error, scratch])
        self.launches += 1
        return out


zamboni_kernel = ZamboniKernel()
