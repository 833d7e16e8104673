"""The zamboni kernel's CUDA source run on the host, for CPU tests.

`scan_host_emu.build` compiles ``csrc/zamboni.cu``, rewritten by
`translate`, with g++ against that module's emulation header (every
CUDA thread of a block an OS thread, ``__syncthreads`` a counting
barrier, warp shuffles exchanges behind a barrier of the warp's 32
threads; blocks one after another, which is all the kernel's launches
need: no block reads another's results inside a launch). Only its
shared-memory declaration and its five launches are rewritten; the
tests hold the kernel's own tiling, scans and writes against the plain
version without a card. Outputs and scratch start as garbage, as on the
card. Timing means nothing here.

`run` launches the emulated kernel through the same C entry and the
same allocations as `ops/zamboni_kernel.ZamboniKernel`, on CPU tensors.
"""

from __future__ import annotations

import ctypes
import re

import torch

from ..ops import zamboni_kernel as tzk
from ..ops.mergetree_kernel import SegmentTable
from . import scan_host_emu
from .scan_host_emu import GARBAGE


def translate(src: str) -> str:
    """The kernel source with its shared-memory declaration and its
    launches rewritten for `EMU_HEADER`; raises if they are not
    found."""
    decl = "extern __shared__ __align__(16) int smem[];"
    if decl not in src:
        raise ValueError("zamboni_host_emu: the shared memory was not found")
    src = src.replace(decl, "int* smem = emu_smem;")
    src, n = re.subn(r"(\w+)<<<\s*(\w+),\s*(\w+),\s*(\(size_t\)smem),\s*\w+"
                     r">>>\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \5);", src)
    if n != 5 or "asm" in src or "<<<" in src:
        raise ValueError("zamboni_host_emu: the source has untranslated parts")
    return src


_fn = None


def run(table: SegmentTable, min_seq: int) -> SegmentTable:
    """The emulated kernel on a CPU table: the output table."""
    global _fn
    if _fn is None:
        _fn = tzk.ZamboniKernel.bind(ctypes.CDLL(
            scan_host_emu.build("zamboni", translate)))
    msn = torch.tensor(min_seq, dtype=torch.int32)
    C, KR, KK = tzk.ZamboniKernel.check(table, msn)
    out = SegmentTable(*(torch.full_like(t, GARBAGE) for t in (
        table.n_rows, table.buf_start, table.length, table.ins_seq,
        table.ins_client, table.rem_seq, table.rem_clients, table.props,
        table.error)))
    scratch = torch.full((tzk.scratch_ints(C),), GARBAGE, dtype=torch.int32)
    ts = [table.n_rows, table.error, msn, table.buf_start, table.length,
          table.ins_seq, table.ins_client, table.rem_seq, table.rem_clients,
          table.props, out.buf_start, out.length, out.ins_seq,
          out.ins_client, out.rem_seq, out.rem_clients, out.props,
          out.n_rows, out.error, scratch]
    ptrs = (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    rc = _fn(0, C, KR, KK, tzk.tiles(C), len(ts), ptrs, None)
    if rc != 0:
        raise RuntimeError(f"the emulated zamboni refused the launch ({rc})")
    return out
