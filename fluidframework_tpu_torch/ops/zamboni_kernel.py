"""The row model's compaction kernels (``csrc/zamboni.cu``) and their
launchers.

The source holds one device-wide, stable compaction of a segment table
under an applied MSN (tombstones removed at or below it dropped, settled
neighbours merged), with blocks of `TILE` rows on PyTorch's current
stream and no host sync, behind two C entries:

- `ZamboniKernel` (``zamboni_launch``) replaces the XLA function
  `zamboni_device` (fluidframework_tpu/ops/zamboni.py:42): neighbours
  merge only where their text is contiguous in the arena. Its plain
  version is `ops/zamboni.zamboni_device_ref`; the dispatcher
  `ops/zamboni.zamboni_device` sends CUDA tables here.
- `CompactionKernel` (``compaction_launch``) replaces the XLA function
  `compact_gather_text` (fluidframework_tpu/ops/zamboni.py:185), the
  chunk path's compaction: every settled neighbour pair with equal props
  merges, and the kept rows' text moves into a new arena, in one launch
  (tiles ordered by a ticket, a decoupled look-back over their
  aggregates, each tile moving its own text). Its plain version is
  `ops/zamboni.compact_gather_text_ref`; the dispatcher
  `ops/zamboni.compact_gather_text` sends CUDA tables here.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build
from .mergetree_kernel import SegmentTable

I32 = torch.int32

# These constants must match csrc/zamboni.cu.
THREADS = 256
TILE = 512  # rows a tile: 2 a thread
TILE_INTS = 7 + 2 * 16  # a tile's aggregate and its keep and start words
COUNTER_INTS = 32  # the compaction's ticket and done counters
RECORD_INTS = 16  # a tile's status word, aggregate and inclusive prefix
TEXT_CAP = 3072  # text ints a compaction tile reads before its look-back
EPOCHS = 1 << 30  # the compaction's status words carry the epoch mod this
SMEM_FIXED = 7528  # a compaction block's shared ints before its props
SMEM_OPT_IN = 227 * 1024  # bytes of shared memory a block may opt in to

LIB = "zamboni"  # csrc/zamboni.cu, both entries
SOURCE = "fluidframework_tpu_torch/csrc/zamboni.cu"


def tiles(capacity: int) -> int:
    """The tiles of a table of `capacity` rows."""
    return -(-capacity // TILE)


def scratch_ints(capacity: int) -> int:
    """The zamboni's int32 scratch of one call: `TILE_INTS` a tile."""
    return TILE_INTS * tiles(capacity)


def compaction_scratch_ints(capacity: int) -> int:
    """The compaction's int32 scratch: its two counters (in
    `COUNTER_INTS`) and a record of `RECORD_INTS` a tile. It must start
    zeroed; every call leaves the counters at 0."""
    return COUNTER_INTS + RECORD_INTS * tiles(capacity)


def compaction_smem(kk: int) -> int:
    """The dynamic shared memory of a compaction block at `kk` prop
    keys, in bytes: the fixed part and the tile's props with the row
    before it."""
    return 4 * (SMEM_FIXED + (TILE + 1) * kk)


# The most prop keys a compaction takes: a block's shared memory stays
# within what sm_90 lets it opt in to (98).
COMPACTION_MAX_KK = (SMEM_OPT_IN // 4 - SMEM_FIXED) // (TILE + 1)


def next_epoch(epoch: int) -> int:
    """The epoch of the call after one with `epoch` on the same scratch:
    1 to EPOCHS - 1, never 0 (a zeroed status word's)."""
    return epoch % (EPOCHS - 1) + 1


def check_table(table: SegmentTable, who: str) -> Tuple[int, int, int]:
    """(C, KR, KK) of a table the kernels take; raises ValueError on any
    other."""
    dev = table.length.device
    C = table.length.shape[0] if table.length.dim() == 1 else -1
    if C < 1 or table.rem_clients.dim() != 2 or table.props.dim() != 2:
        raise ValueError(f"{who} kernel: one table of [C] and [C, K] "
                         "columns is taken")
    KR, KK = table.rem_clients.shape[1], table.props.shape[1]
    shapes = {"n_rows": (), "error": (), "buf_start": (C,),
              "length": (C,), "ins_seq": (C,), "ins_client": (C,),
              "rem_seq": (C,), "rem_clients": (C, KR), "props": (C, KK)}
    for name, shape in shapes.items():
        t = getattr(table, name)
        if t.device != dev or t.dtype != I32:
            raise ValueError(
                f"{who} kernel inputs must be int32 tensors on {dev}; "
                f"{name} is {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{who} kernel: {name} has shape "
                             f"{tuple(t.shape)} where {shape} was expected")
        if not t.is_contiguous():
            raise ValueError(f"{who} kernel: {name} is not contiguous")
    return C, KR, KK


def msn_arg(min_seq, dev: torch.device, who: str):
    """(value, tensor or None) of the MSN for the C entry: an int is
    passed by value (nothing is copied to the card), a tensor by its
    pointer (one int32 on the table's device)."""
    if isinstance(min_seq, torch.Tensor):
        if (min_seq.device != dev or min_seq.dtype != I32
                or min_seq.numel() != 1):
            raise ValueError(f"{who} kernel: min_seq must be an int or one "
                             f"int32 on {dev}")
        return 0, min_seq.reshape(())
    return int(min_seq), None


def empty_like_table(table: SegmentTable, fill=None) -> SegmentTable:
    """An output table shaped like `table` (filled with `fill` if given,
    else uninitialised)."""
    make = (torch.empty_like if fill is None
            else lambda t: torch.full_like(t, fill))
    return SegmentTable(*(make(t) for t in (
        table.n_rows, table.buf_start, table.length, table.ins_seq,
        table.ins_client, table.rem_seq, table.rem_clients, table.props,
        table.error)))


def table_ptrs(table: SegmentTable, msn, out: SegmentTable) -> list:
    """The C entries' 19 table pointers: the input table (the MSN's
    tensor, or None, third), then the output table."""
    return [table.n_rows, table.error, msn, table.buf_start, table.length,
            table.ins_seq, table.ins_client, table.rem_seq,
            table.rem_clients, table.props,
            out.buf_start, out.length, out.ins_seq, out.ins_client,
            out.rem_seq, out.rem_clients, out.props, out.n_rows, out.error]


class _Launcher:
    """What both entries share: the library, the launch count and the
    scratch. ``launches`` counts kernel launches (`LAUNCHES` a call); it
    is incremented where the kernels are launched and nowhere else. The
    scratch is one zeroed buffer per (device, stream, capacity), reused by
    every call on that stream: calls on one stream run in order, and a
    call's scratch is dead once its last launch ends; calls on two streams
    never share one."""

    name = ""
    replaces = ""
    source = SOURCE
    LAUNCHES = 0

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None
        self._scratch: Dict[Tuple[str, int, int], list] = {}

    def _entry(self):
        if self._fn is None:
            self._fn = self.bind(_build.load(LIB))
        return self._fn

    def scratch_ints(self, capacity: int) -> int:
        return scratch_ints(capacity)

    def scratch(self, dev: torch.device,
                capacity: int) -> Tuple[torch.Tensor, int]:
        """The scratch of (dev, its current stream, capacity), zeroed when
        it is made, and this call's epoch on it: the last call's
        `next_epoch`, 1 at first."""
        key = (str(dev), torch.cuda.current_stream(dev).cuda_stream,
               capacity)
        entry = self._scratch.get(key)
        if entry is None:
            entry = self._scratch[key] = [torch.zeros(
                self.scratch_ints(capacity), dtype=I32, device=dev), 0]
        entry[1] = next_epoch(entry[1])
        return entry[0], entry[1]

    def _launch(self, dev, ints, ptrs) -> None:
        _build.launch(self.name, self._entry(), dev, ints, ptrs)
        self.launches += self.LAUNCHES


class ZamboniKernel(_Launcher):
    """Launches ``zamboni_launch`` on one table.

    The wrapper checks device, dtype, shape and contiguity, allocates
    the output table, and raises if a launch was refused: there is no
    fallback. The input is never written. Every output row is written
    (rows at and above the output's ``n_rows`` hold the empty-row
    fills)."""

    name = "zamboni"
    replaces = "fluidframework_tpu/ops/zamboni.py:42"
    LAUNCHES = 2  # keep counts and start flags; the rows

    @staticmethod
    def bind(lib: ctypes.CDLL):
        """The C entry of a loaded kernel library, typed."""
        fn = lib.zamboni_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        return fn

    def __call__(self, table: SegmentTable, min_seq) -> SegmentTable:
        dev = table.length.device
        if dev.type != "cuda":
            raise ValueError(
                f"the zamboni CUDA kernel needs CUDA tensors, got {dev}")
        C, KR, KK = check_table(table, "zamboni")
        msn, msn_t = msn_arg(min_seq, dev, "zamboni")
        out = empty_like_table(table)
        self._launch(dev, (C, KR, KK, tiles(C), msn),
                     table_ptrs(table, msn_t, out)
                     + [self.scratch(dev, C)[0]])
        return out


class CompactionKernel(_Launcher):
    """Launches ``compaction_launch``: the chunk path's compaction of one
    table with its text moved into a new arena.

    The wrapper checks the table as `ZamboniKernel` does and the two
    text arrays (int32, 1-D, contiguous, on the table's device),
    allocates the output table and the new arena (``doc_arena``'s
    length), and raises if a launch was refused: there is no fallback.
    It takes at most `COMPACTION_MAX_KK` prop keys (a tile's props are
    staged in shared memory) and raises ValueError past that before it
    reaches the C entry. The inputs are never written; every output row and every arena
    element is written once. The epoch goes to the kernel by value, so
    a call is not to be captured into a CUDA graph and replayed."""

    name = "compact_gather_text"
    replaces = "fluidframework_tpu/ops/zamboni.py:185"
    LAUNCHES = 1  # one single-pass launch

    def scratch_ints(self, capacity: int) -> int:
        return compaction_scratch_ints(capacity)

    @staticmethod
    def bind(lib: ctypes.CDLL):
        """The C entry of a loaded kernel library, typed."""
        fn = lib.compaction_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 10 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        return fn

    @staticmethod
    def check_text(dev: torch.device, doc_arena: torch.Tensor,
                   stream_text: torch.Tensor) -> Tuple[int, int]:
        """(A, S) of the text arrays; raises ValueError unless both are
        contiguous 1-D int32 tensors on `dev`."""
        for name, t in (("doc_arena", doc_arena),
                        ("stream_text", stream_text)):
            if (t.device != dev or t.dtype != I32 or t.dim() != 1
                    or not t.is_contiguous()):
                raise ValueError(
                    f"compaction kernel: {name} must be a contiguous 1-D "
                    f"int32 tensor on {dev}")
        if doc_arena.shape[0] < 1:
            raise ValueError("compaction kernel: doc_arena is empty")
        return doc_arena.shape[0], stream_text.shape[0]

    @staticmethod
    def check_kk(kk: int) -> None:
        """Raises ValueError where `kk` prop keys pass the shared memory
        a block may have (`COMPACTION_MAX_KK`)."""
        if kk > COMPACTION_MAX_KK:
            raise ValueError(
                f"compaction kernel: {kk} prop keys need "
                f"{compaction_smem(kk)} bytes of shared memory a block, "
                f"past the {SMEM_OPT_IN} a block may have; at most "
                f"{COMPACTION_MAX_KK} keys")

    def __call__(self, table: SegmentTable, min_seq, doc_arena: torch.Tensor,
                 stream_text: torch.Tensor) -> Tuple[SegmentTable,
                                                     torch.Tensor]:
        dev = table.length.device
        if dev.type != "cuda":
            raise ValueError(
                f"the compaction CUDA kernel needs CUDA tensors, got {dev}")
        C, KR, KK = check_table(table, "compaction")
        self.check_kk(KK)
        A, S = self.check_text(dev, doc_arena, stream_text)
        msn, msn_t = msn_arg(min_seq, dev, "compaction")
        out = empty_like_table(table)
        arena = torch.empty_like(doc_arena)
        scratch, epoch = self.scratch(dev, C)
        self._launch(dev, (C, KR, KK, tiles(C), A, S, msn, epoch),
                     table_ptrs(table, msn_t, out)
                     + [scratch, doc_arena, stream_text, arena])
        return out, arena


zamboni_kernel = ZamboniKernel()
compaction_kernel = CompactionKernel()
