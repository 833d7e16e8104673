"""The row model's compaction kernels' CUDA source run on the host, for
CPU tests.

`scan_host_emu.build` compiles ``csrc/zamboni.cu``, rewritten by
`translate`, with g++ against that module's emulation header (every
CUDA thread of a block an OS thread, ``__syncthreads`` a counting
barrier, warp shuffles and ballots exchanges behind a barrier of the
warp's 32 threads; blocks one after another, which is all the kernels'
launches need: no block reads another's results inside a launch, and
they use no atomics). Only the shared-memory declarations, the launch
site and the launch-control instructions of its programmatic dependent
launches are rewritten (`translate`); the tests hold the kernels' own
tiling, scans, writes and text gather against the plain versions
without a card.
Outputs and scratch start as garbage, as on the card. Timing means
nothing here.

`run` (the zamboni) and `run_compaction` (`compact_gather_text`)
launch the emulated kernels through the same C entries and the same
allocations as `ops/zamboni_kernel`'s launchers, on CPU tensors.
"""

from __future__ import annotations

import ctypes
import re
from typing import Tuple

import torch

from ..ops import zamboni_kernel as tzk
from ..ops.mergetree_kernel import SegmentTable
from . import scan_host_emu
from .scan_host_emu import GARBAGE


# The launch-control instructions of its programmatic dependent
# launches: the emulation header's `cudaLaunchKernelEx` runs a launch's
# blocks once the launch before has ended, so they do nothing.
PDL_ASM = ('asm volatile("griddepcontrol.launch_dependents;");',
           'asm volatile("griddepcontrol.wait;" ::: "memory");')


def translate(src: str) -> str:
    """The kernel source with its shared-memory declarations, its launch
    site and its two launch-control instructions rewritten for
    `EMU_HEADER`; raises if they are not found."""
    decl = "extern __shared__ __align__(16) int smem[];"
    if decl not in src or any(asm not in src for asm in PDL_ASM):
        raise ValueError("zamboni_host_emu: the shared memory or the launch "
                         "control was not found")
    src = src.replace(decl, "int* smem = emu_smem;")
    for asm in PDL_ASM:
        src = src.replace(asm, "")
    src, n = re.subn(r"(\w+)<<<\s*(\w+),\s*(\w+),\s*(\(size_t\)smem),\s*\w+"
                     r">>>\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \5);", src)
    if n != 1 or "asm" in src or "<<<" in src:  # the one launch site
        raise ValueError("zamboni_host_emu: the source has untranslated parts")
    return src


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(scan_host_emu.build("zamboni", translate))
    return _lib


def _call(fn, ints, ts) -> None:
    ptrs = (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))
    rc = fn(0, *ints, len(ts), ptrs, None)
    if rc != 0:
        raise RuntimeError(f"the emulated kernel refused the launch ({rc})")


def _msn(min_seq, by_pointer: bool):
    """(value, tensor or None): the MSN by value, or by the pointer of a
    one-int tensor as a caller holding it on the card passes it."""
    if by_pointer:
        return 0, torch.tensor(int(min_seq), dtype=torch.int32)
    return int(min_seq), None


def run(table: SegmentTable, min_seq: int,
        by_pointer: bool = False) -> SegmentTable:
    """The emulated zamboni on a CPU table: the output table."""
    C, KR, KK = tzk.check_table(table, "zamboni")
    msn, msn_t = _msn(min_seq, by_pointer)
    out = tzk.empty_like_table(table, GARBAGE)
    scratch = torch.full((tzk.scratch_ints(C),), GARBAGE, dtype=torch.int32)
    _call(tzk.ZamboniKernel.bind(_library()),
          (C, KR, KK, tzk.tiles(C), msn),
          tzk.table_ptrs(table, msn_t, out) + [scratch])
    return out


def run_compaction(table: SegmentTable, min_seq: int, doc_arena: torch.Tensor,
                   stream_text: torch.Tensor, by_pointer: bool = False
                   ) -> Tuple[SegmentTable, torch.Tensor]:
    """The emulated compaction on a CPU table and CPU text arrays: the
    output table and the new arena."""
    C, KR, KK = tzk.check_table(table, "compaction")
    A, S = tzk.CompactionKernel.check_text(table.length.device, doc_arena,
                                           stream_text)
    msn, msn_t = _msn(min_seq, by_pointer)
    out = tzk.empty_like_table(table, GARBAGE)
    arena = torch.full_like(doc_arena, GARBAGE)
    scratch = torch.full((tzk.scratch_ints(C, A),), GARBAGE,
                         dtype=torch.int32)
    _call(tzk.CompactionKernel.bind(_library()),
          (C, KR, KK, tzk.tiles(C), A, S, msn),
          tzk.table_ptrs(table, msn_t, out)
          + [scratch, doc_arena, stream_text, arena])
    return out, arena
