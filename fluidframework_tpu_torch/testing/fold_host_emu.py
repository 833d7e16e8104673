"""The overlay fold kernel's CUDA source run on the host, for CPU tests.

`scan_host_emu.build` compiles ``csrc/overlay_fold.cu``, rewritten by
`translate`, with g++ against that module's emulation header: every
CUDA thread of a block is an OS thread, ``__syncthreads`` a counting
barrier, the warp shuffles exchanges behind a barrier of the warp's 32
threads, and the blocks (documents) run one after another, which is
all the kernel needs (no block reads another's results). Only the
shared-memory declaration and the launch site are rewritten, so the
tests hold the kernel's own row ranges, warp and block scans, computed
destinations and clamped log append against the plain versions
without a card. Outputs start as garbage, as on the card. Timing means
nothing here.

`run` (the fold) and `run_append` (the fold with the log append)
launch the emulated kernel through the same C entry and the same
arguments as `ops/overlay.OverlayFoldKernel`, on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops.overlay import OverlayFoldKernel, OverlayTable
from . import scan_host_emu
from .scan_host_emu import GARBAGE

NAME = "overlay_fold"


def translate(src: str) -> str:
    """The kernel source with its shared-memory declaration and its
    launch site rewritten for `scan_host_emu.EMU_HEADER`; raises if
    either is not found."""
    decl = "extern __shared__ __align__(16) int smem[];"
    launch = ("overlay_fold_kernel<<<n_docs, NT, (size_t)smem, "
              "(cudaStream_t)stream>>>(a);")
    if decl not in src or launch not in src:
        raise ValueError("fold_host_emu: the shared memory or the launch "
                         "was not found")
    src = src.replace(decl, "int* smem = emu_smem;")
    src = src.replace(launch, "emu_launch(overlay_fold_kernel, n_docs, NT, "
                              "(size_t)smem, a);")
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


def run(table: OverlayTable, msn) -> Tuple[OverlayTable, torch.Tensor,
                                           torch.Tensor]:
    """The emulated fold of a CPU table (one document or a stack):
    ``(table', records, n_rec)``."""
    ints, tensors, result = OverlayFoldKernel.args(table, msn,
                                                   empty=_garbage)
    _call(ints, tensors)
    return result


def run_append(table: OverlayTable, msn, log: torch.Tensor,
               counts: torch.Tensor, cursor: torch.Tensor,
               epoch: int) -> Tuple[OverlayTable, torch.Tensor]:
    """The emulated fold with its log append on CPU tensors: ``(table',
    cursor')``, `log` and `counts` written in place."""
    ints, tensors, result = OverlayFoldKernel.args(
        table, msn, log, counts, cursor, epoch, empty=_garbage)
    _call(ints, tensors)
    return result
