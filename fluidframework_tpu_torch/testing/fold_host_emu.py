"""The overlay fold kernel's CUDA source run on the host, for CPU tests.

`scan_host_emu.build` compiles ``csrc/overlay_fold.cu``, rewritten by
`translate`, with g++ against that module's emulation header: every
CUDA thread of a CTA is an OS thread, ``__syncthreads`` a counting
barrier, the warp shuffles and ballots exchanges behind a barrier of
the warp's 32 threads. The G CTAs of a document's cluster run at once,
each with its own shared memory, and the clusters (documents) one
after another; the cluster barrier counts the threads of all G CTAs,
distributed shared memory reads the other rank's emulated shared
memory, and the bulk copy and ``cp.async`` are a copy plus its arrival
on the mbarrier. The header's ``cudaLaunchKernelEx`` takes the cluster
size from the launch's cluster dimension, so the emulated launch gets
G from the wrapper's arguments as the card does. Only the
shared-memory declaration and the block of PTX primitives are
rewritten, so the tests hold the kernel's own tiles, segments, warp
scans, cluster exchange, maps, copies and clamped log append against
the plain versions without a card. Outputs start as garbage, as on the
card. Timing means nothing here.

`run` (the fold) and `run_append` (the fold with the log append)
launch the emulated kernel through the same C entry and the same
arguments as `ops/overlay.OverlayFoldKernel`, on CPU tensors, at the
cluster size and segment the wrapper would pick or at forced ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.overlay import OverlayFoldKernel, OverlayTable
from . import scan_host_emu
from .scan_host_emu import GARBAGE

NAME = "overlay_fold"
PTX_BEGIN = ("// ---- Hopper primitives (PTX; the host emulation replaces "
             "this block) ----")
PTX_END = "// ---- end of the PTX ----"

# The primitives of the PTX block over `scan_host_emu.EMU_HEADER`.
PTX_SHIM = """
inline unsigned cluster_rank() { return emu_cluster_rank(); }
inline void cluster_arrive() { emu_cluster_arrive(); }
inline void cluster_wait() { emu_cluster_wait(); }
inline int dsmem_load(const int* p, unsigned rank) { return *emu_dsmem(p, rank); }
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
"""


def translate(src: str) -> str:
    """The kernel source with its shared-memory declaration and its
    block of PTX primitives rewritten for `scan_host_emu.EMU_HEADER`;
    raises if either, or the cluster launch, is not found."""
    decl = "extern __shared__ __align__(16) int smem[];"
    launch = "cudaLaunchKernelEx(&cfg, kernel, a)"
    if (decl not in src or launch not in src or PTX_BEGIN not in src
            or PTX_END not in src):
        raise ValueError("fold_host_emu: the shared memory, the PTX block or "
                         "the launch was not found")
    i = src.index(PTX_BEGIN)
    j = src.index(PTX_END) + len(PTX_END)
    src = src[:i] + PTX_SHIM + src[j:]
    src = src.replace(decl, "int* smem = emu_smem;")
    if "asm" in src or "<<<" in src:
        raise ValueError("fold_host_emu: the source has untranslated parts")
    return src


_fn = None


def _entry():
    global _fn
    if _fn is None:
        _fn = OverlayFoldKernel.bind(
            ctypes.CDLL(scan_host_emu.build(NAME, translate)))
    return _fn


def _garbage(shape, dtype, device):
    return torch.full(shape, GARBAGE, dtype=dtype, device=device)


def _call(ints, tensors) -> None:
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    rc = _entry()(0, *ints, len(tensors), ptrs, None)
    if rc != 0:
        raise RuntimeError(f"the emulated fold refused the launch ({rc})")


def run(table: OverlayTable, msn, cluster: Optional[int] = None,
        segment: Optional[int] = None) -> Tuple[OverlayTable, torch.Tensor,
                                                torch.Tensor]:
    """The emulated fold of a CPU table (one document or a stack):
    ``(table', records, n_rec)``, in clusters of `cluster` CTAs staging
    `segment` rows at once (None: the wrapper's choice)."""
    ints, tensors, result = OverlayFoldKernel.args(
        table, msn, cluster=cluster, segment=segment, empty=_garbage)
    _call(ints, tensors)
    return result


def run_append(table: OverlayTable, msn, log: torch.Tensor,
               counts: torch.Tensor, cursor: torch.Tensor, epoch: int,
               cluster: Optional[int] = None,
               segment: Optional[int] = None) -> Tuple[OverlayTable,
                                                       torch.Tensor]:
    """The emulated fold with its log append on CPU tensors: ``(table',
    cursor')``, `log` and `counts` written in place."""
    ints, tensors, result = OverlayFoldKernel.args(
        table, msn, log, counts, cursor, epoch, cluster=cluster,
        segment=segment, empty=_garbage)
    _call(ints, tensors)
    return result
