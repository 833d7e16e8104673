"""The row model's compaction kernels' CUDA source run on the host, for
CPU tests.

`scan_host_emu.build` compiles ``csrc/zamboni.cu``, rewritten by
`translate`, with g++ against that module's emulation header: every
CUDA thread of a block is an OS thread, ``__syncthreads`` a counting
barrier, warp shuffles and ballots exchanges behind a barrier of the
warp's 32 threads; the blocks run one after another, in blockIdx order
or in its reverse, or all at once (``order``). The compaction's ticket
(``atomicAdd``) and its status words' release stores and acquire loads
go through the header's atomic mutex, the bulk copy and ``cp.async`` are
a copy plus its arrival on the mbarrier, and the zamboni's programmatic
dependent launch runs once the launch before has ended. Run one after
another, a block finds every status it looks back on ready, in either
order: the tile order comes from the ticket, so the result must not
depend on the order. Run all at once, blocks spin on each other's
statuses as on the card, and the look-back meets aggregates and
statuses not yet written in this call. Only the
shared-memory declarations, the block of PTX primitives and the launch
site are rewritten (`translate`); the tests hold the kernels' own
tiling, scans, look-back, writes and text move against the plain
versions without a card. With ``aggregates_only=True`` the compaction's
tiles publish no inclusive prefix, so every look-back combines
aggregates all the way back to the first tile (junctions over runs of
tiles that keep nothing, windows of 32 tiles). Outputs start as
garbage, as on the card, and the scratch as the wrapper makes it
(zeroed). Timing means nothing here.

`run` (the zamboni) and `run_compaction` (`compact_gather_text`)
launch the emulated kernels through the same C entries and the same
allocations as `ops/zamboni_kernel`'s launchers, on CPU tensors.
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict, Optional, Tuple

import torch

from ..ops import zamboni_kernel as tzk
from ..ops.mergetree_kernel import SegmentTable
from . import scan_host_emu
from .scan_host_emu import GARBAGE

PTX_BEGIN = ("// ---- Hopper primitives (PTX; the host emulation replaces "
             "this block) ----")
PTX_END = "// ---- end of the PTX ----"

# The primitives of the PTX block over `scan_host_emu.EMU_HEADER`. The
# launch-control instructions of the zamboni's programmatic dependent
# launch do nothing: the header's `cudaLaunchKernelEx` runs a launch's
# blocks once the launch before has ended.
PTX_SHIM = """
inline void launch_dependents() {}
inline void wait_for_prior_launch() {}
inline void mbar_init(unsigned long long* b, unsigned n) { emu_mbar_init(b, n); }
inline void mbar_arrive_tx(unsigned long long* b, unsigned bytes) {
    emu_mbar_arrive_tx(b, bytes);
}
inline void mbar_wait(unsigned long long* b, unsigned parity) {
    emu_mbar_wait(b, parity);
}
inline void fence_proxy_async() {}
inline void bulk_load(int* dst, const int* src, unsigned bytes,
                      unsigned long long* b) {
    emu_bulk_copy(dst, src, bytes, b);
}
inline void cp_async4(int* dst, const int* src) { emu_cp_async(dst, src, 4); }
inline void cp_async_wait_all() {}
inline int ld_acquire(const int* p) { return emu_ld_acquire(p); }
inline void st_release(int* p, int v) { emu_st_release(p, v); }
inline int ld_cg(const int* p) { return *p; }
inline void st_stream(int* p, int v) { *p = v; }
inline void st_stream(int4* p, int4 v) { *p = v; }
inline int4 ld_cg4(const int* p) { return *reinterpret_cast<const int4*>(p); }
"""

# The compaction tile's publication of its inclusive prefix.
PUBLISH_PREFIX = ("publish(a, t, combine(a, e, own, msn), REC_PREFIX, "
                  "ST_PREFIX);")


def translate(src: str, aggregates_only: bool = False) -> str:
    """The kernel source with its shared-memory declarations, its block
    of PTX primitives and its launch site rewritten for `EMU_HEADER`
    (and, with `aggregates_only`, without the compaction's inclusive
    prefixes); raises if any of them is not found."""
    decl = "extern __shared__ __align__(16) int smem[];"
    if (decl not in src or PTX_BEGIN not in src or PTX_END not in src
            or src.count(PUBLISH_PREFIX) != 1):
        raise ValueError("zamboni_host_emu: the shared memory, the PTX block "
                         "or the prefix's publication was not found")
    i = src.index(PTX_BEGIN)
    j = src.index(PTX_END) + len(PTX_END)
    src = src[:i] + PTX_SHIM + src[j:]
    src = src.replace(decl, "int* smem = emu_smem;")
    if aggregates_only:
        src = src.replace(PUBLISH_PREFIX, "")
    src, n = re.subn(r"(\w+)<<<\s*(\w+),\s*(\w+),\s*(\(size_t\)smem),\s*\w+"
                     r">>>\((\w+)\);", r"emu_launch(\1, \2, \3, \4, \5);", src)
    if n != 1 or "asm" in src or "<<<" in src:  # the one launch site
        raise ValueError("zamboni_host_emu: the source has untranslated parts")
    return src


_libs: Dict[bool, ctypes.CDLL] = {}


def _library(aggregates_only: bool = False) -> ctypes.CDLL:
    if aggregates_only not in _libs:
        _libs[aggregates_only] = ctypes.CDLL(scan_host_emu.build(
            "zamboni", lambda s: translate(s, aggregates_only)))
    return _libs[aggregates_only]


def compaction_smem_bytes(kk: int) -> int:
    """The source's dynamic shared memory of a compaction block at `kk`
    prop keys (its ``compaction_smem_bytes``), in bytes."""
    fn = _library().compaction_smem_bytes
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int]
    return fn(kk)


ORDERS = {"in order": 0, "reverse": 1, "at once": 2}


def _call(lib: ctypes.CDLL, fn, ints, ts, order: str) -> None:
    ptrs = (ctypes.c_void_p * len(ts))(
        *(None if t is None else t.data_ptr() for t in ts))
    lib.emu_set_order(ORDERS[order])
    try:
        rc = fn(0, *ints, len(ts), ptrs, None)
    finally:
        lib.emu_set_order(0)
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
    lib = _library()
    _call(lib, tzk.ZamboniKernel.bind(lib), (C, KR, KK, tzk.tiles(C), msn),
          tzk.table_ptrs(table, msn_t, out) + [scratch], "in order")
    return out


class CompactionScratch:
    """The compaction's scratch as `CompactionKernel` keeps it for one
    device, stream and capacity: zeroed when made, reused by every call,
    with the epoch advanced on each."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.ints = torch.zeros(tzk.compaction_scratch_ints(capacity),
                                dtype=torch.int32)
        self.epoch = 0

    def next(self) -> int:
        self.epoch = tzk.next_epoch(self.epoch)
        return self.epoch


def run_compaction(table: SegmentTable, min_seq: int, doc_arena: torch.Tensor,
                   stream_text: torch.Tensor, by_pointer: bool = False,
                   scratch: Optional[CompactionScratch] = None,
                   order: str = "in order", aggregates_only: bool = False
                   ) -> Tuple[SegmentTable, torch.Tensor]:
    """The emulated compaction on a CPU table and CPU text arrays: the
    output table and the new arena. `scratch` (else a new one) is the
    scratch the call uses; `order` is how the blocks run (in blockIdx
    order, in reverse, or all at once, see `ORDERS`); `aggregates_only`
    publishes no inclusive prefix."""
    C, KR, KK = tzk.check_table(table, "compaction")
    A, S = tzk.CompactionKernel.check_text(table.length.device, doc_arena,
                                           stream_text)
    msn, msn_t = _msn(min_seq, by_pointer)
    out = tzk.empty_like_table(table, GARBAGE)
    arena = torch.full_like(doc_arena, GARBAGE)
    if scratch is None:
        scratch = CompactionScratch(C)
    if scratch.capacity != C:
        raise ValueError("run_compaction: the scratch is for another capacity")
    lib = _library(aggregates_only)
    _call(lib, tzk.CompactionKernel.bind(lib),
          (C, KR, KK, tzk.tiles(C), A, S, msn, scratch.next()),
          tzk.table_ptrs(table, msn_t, out)
          + [scratch.ints, doc_arena, stream_text, arena], order)
    return out, arena
