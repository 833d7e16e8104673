"""The overlay merge-tree engine on PyTorch: O(collab window) work per op.

Counterpart of fluidframework_tpu/ops/overlay_pallas.py, with exactly
the semantics of `ops.overlay_ref.OverlayDoc` (the numpy spec). The
table holds only UNSETTLED rows; settled content is the coordinate
space ``[0, S)`` whose text and props live in the fold log.

Per chunk of B sequenced ops:

1. `overlay_apply_chunk` applies the ops one after another. On a CUDA
   tensor it launches the hand-written kernel
   ``csrc/overlay_chunk.cu`` (one thread block per document; the
   counterpart of the Pallas `_overlay_chunk_kernel`); on a CPU tensor
   it runs `overlay_apply_chunk_ref`, the plain PyTorch version, one
   op at a time and vectorized over rows. No other device is taken,
   and a CUDA tensor never falls back to the plain version.
2. `fold_device` settles rows under the chunk's MSN and emits the fold
   records (the JAX package does this in XLA). On a CUDA tensor it
   launches the hand-written kernel ``csrc/overlay_fold.cu`` (one block
   per document); on a CPU tensor it runs `fold_device_ref`, the plain
   PyTorch version in tensor ops.
3. `replay_chunk_step` folds and appends the records to a preallocated
   log in place (`fold_append`: the same kernel's append form, or
   `fold_append_ref`), so a replay step is two launches on the card.
   `replay_fused` runs every chunk in one Python loop with no host sync
   inside it.

Names, column layout (``[W]`` columns, ``rem_clients[W, KR]``,
``props[W, KK]``) and sentinels are those of the JAX package, so the
tests compare the two like with like. All state is int32.

Each step also takes many documents at once (the docs form, the
one-card counterpart of `parallel.mesh.sharded_overlay_replay_multi`):
every table field with a leading ``[D]`` axis and ops of ``[D, B]``.
A chunk of all D documents is one launch of each kernel (one block per
document).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..protocol.constants import NO_CLIENT
from ..utils.devices import DeviceLike, resolve_device
from . import _build
from .mergetree_kernel import (
    ERR_BAD_POS,
    ERR_CAPACITY,
    ERR_REMOVERS,
    NO_KEY,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
    OpBatch,
)
from .overlay_ref import SETTLED_BASE
from .zamboni import pack_partition

# Fold-record type codes (column 1 of a log record).
REC_NONE = 0  # dropped text row: nothing to reconstruct
REC_SETTLE_TEXT = 1  # unsettled insert becomes settled text at anchor
REC_DROP_SPAN = 2  # settled coords [anchor, anchor+len) excised
REC_SETTLE_SPAN = 3  # props merge into settled [anchor, anchor+len)

LANES = 128  # the JAX kernel's lane width (its gap staging tiles by it)
I32 = torch.int32


@dataclass
class OverlayTable:
    """Overlay state: unsettled rows + the settled length."""

    n_rows: torch.Tensor  # int32 scalar
    anchor: torch.Tensor  # int32[W] settled coordinate the row sits at
    buf_start: torch.Tensor  # int32[W]; >= SETTLED_BASE marks span rows
    length: torch.Tensor  # int32[W]
    ins_seq: torch.Tensor  # int32[W] (0 for span rows)
    ins_client: torch.Tensor  # int32[W]
    rem_seq: torch.Tensor  # int32[W] (NOT_REMOVED if live)
    rem_clients: torch.Tensor  # int32[W, KR]
    props: torch.Tensor  # int32[W, KK]
    settled_len: torch.Tensor  # int32 scalar: S
    error: torch.Tensor  # int32 scalar ERR_* flags

    @property
    def device(self) -> torch.device:
        return self.length.device

    def to(self, device) -> "OverlayTable":
        return OverlayTable(
            *(getattr(self, f.name).to(device) for f in fields(self))
        )

    def doc(self, d: int) -> "OverlayTable":
        """Document `d` of a stacked table (views)."""
        return OverlayTable(*(getattr(self, f.name)[d] for f in fields(self)))


def stack_tables(tables: List[OverlayTable]) -> OverlayTable:
    """Documents' tables of one shape stacked on a leading ``[D]`` axis
    (the docs form of `OverlayChunkKernel`, `fold_device` and
    `replay_fused`)."""
    return OverlayTable(*(
        torch.stack([getattr(t, f.name) for t in tables])
        for f in fields(OverlayTable)))


def ops_at(ops: OpBatch, i: int) -> OpBatch:
    """Entry `i` of every field's leading axis (views): document i of a
    stacked chunk of ops, or chunk i of a docs-form stream."""
    return OpBatch(*(getattr(ops, f.name)[i] for f in fields(ops)))


def make_overlay_table(
    window: int, n_removers: int = 4, n_prop_keys: int = 8,
    settled_len: int = 0, device: DeviceLike = None,
) -> OverlayTable:
    dev = resolve_device(device)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    return OverlayTable(
        n_rows=full((), 0),
        anchor=full((window,), 0),
        buf_start=full((window,), 0),
        length=full((window,), 0),
        ins_seq=full((window,), 0),
        ins_client=full((window,), NO_CLIENT),
        rem_seq=full((window,), NOT_REMOVED),
        rem_clients=full((window, n_removers), NO_CLIENT),
        props=full((window, n_prop_keys), PROP_ABSENT),
        settled_len=full((), settled_len),
        error=full((), 0),
    )


def pad_window(table: OverlayTable, window: int) -> OverlayTable:
    """One document's live table widened to `window` rows, a multiple
    of 1024 no smaller than its own: the new rows take each column's
    empty-row sentinel (0, ``NO_CLIENT``, ``NOT_REMOVED``,
    ``PROP_ABSENT``), as `make_overlay_table` fills them, so rows
    ``[:n_rows]`` and every scalar are unchanged. The role of
    `OverlayFoldReplica._ensure_window` (overlay_fold.py:183-214)."""
    W = table.length.shape[-1]
    if window % 1024 or window < W:
        raise ValueError(
            f"pad_window: {window} is not a multiple of 1024 at least "
            f"the table's {W} rows")
    pad = window - W

    def grow(a: torch.Tensor, fill: int) -> torch.Tensor:
        tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=I32,
                          device=a.device)
        return torch.cat([a, tail])

    return OverlayTable(
        n_rows=table.n_rows,
        anchor=grow(table.anchor, 0),
        buf_start=grow(table.buf_start, 0),
        length=grow(table.length, 0),
        ins_seq=grow(table.ins_seq, 0),
        ins_client=grow(table.ins_client, NO_CLIENT),
        rem_seq=grow(table.rem_seq, NOT_REMOVED),
        rem_clients=grow(table.rem_clients, NO_CLIENT),
        props=grow(table.props, PROP_ABSENT),
        settled_len=table.settled_len,
        error=table.error,
    )


def _check_geometry(table: OverlayTable, ops: OpBatch) -> None:
    window = table.length.shape[-1]
    if window % (8 * LANES):
        raise ValueError("window must be a multiple of 1024")
    if ops.prop_keys.shape[:-1] != ops.pos1.shape:
        raise ValueError("prop_keys must be [B, PK] ([D, B, PK] stacked)")


def _i32(x: int) -> int:
    """Wrap a Python int to int32, as the kernels' arithmetic does."""
    return ((x + 2**31) % 2**32) - 2**31


# ----------------------------------------------------------------------
# The plain PyTorch version of the chunk kernel.


def overlay_apply_chunk_ref(table: OverlayTable, ops: OpBatch) -> OverlayTable:
    """Apply a chunk of sequenced ops, one after another, in plain
    PyTorch: the same steps as the Pallas `_overlay_chunk_kernel`
    (overlay_pallas.py:118), vectorized over the W rows of a stacked
    [8+KR+KK, W] table. Op scalars and the block-uniform decisions are
    Python ints (one host read per reduction), so this version is for
    the CPU tests and for holding the CUDA kernel to; it is no
    yardstick of speed. Rows ``[:n_rows]`` of its result equal the
    JAX kernel's; rows beyond are scratch."""
    _check_geometry(table, ops)
    dev = table.length.device
    W = table.length.shape[0]
    KR = table.rem_clients.shape[1]
    KK = table.props.shape[1]
    PK = ops.prop_keys.shape[1]

    A_, B_, L_, IS_, IC_, RS_ = 0, 1, 2, 3, 4, 5
    RC0 = 6
    PP0 = RC0 + KR
    PRE_ = PP0 + KK
    VIS_ = PRE_ + 1

    T = torch.cat([
        torch.stack([table.anchor, table.buf_start, table.length,
                     table.ins_seq, table.ins_client, table.rem_seq]),
        table.rem_clients.t(), table.props.t(),
        torch.zeros((2, W), dtype=I32, device=dev),
    ]).to(I32).contiguous()
    flat = torch.arange(W, dtype=I32, device=dev)
    S = int(table.settled_len)
    nlive = int(table.n_rows)
    err = int(table.error)

    cols = [getattr(ops, n).tolist() for n in (
        "op_type", "pos1", "pos2", "seq", "ref_seq", "client",
        "buf_start", "ins_len")]
    pkeys = ops.prop_keys.tolist()
    pvals = ops.prop_vals.tolist()

    def at(ci: int, j: int) -> int:
        return int(T[ci, min(j, W - 1)])

    def first_idx(mask: torch.Tensor) -> int:
        return int(torch.where(mask, flat, W).min())

    def set1(ci: int, j: int, val: int) -> None:
        if 0 <= j < W:
            T[ci, j] = _i32(val)

    def roll_from(thr: int) -> None:
        """Row j takes row j-1 for j >= thr, over the whole stack (the
        flat roll wraps: row 0 takes row W-1 when thr is 0; callers
        overwrite that row)."""
        if thr >= W:
            return
        T.copy_(torch.where(flat >= thr, torch.roll(T, 1, 1), T))

    def clear_new_row(j: int) -> None:
        if 0 <= j < W:
            T[RC0:PP0, j] = NO_CLIENT
            T[PP0:PRE_, j] = PROP_ABSENT

    def vis_pass(r: int, c: int) -> Tuple[torch.Tensor, int]:
        live = flat < nlive
        rseq = T[RS_]
        removed = rseq != NOT_REMOVED
        tomb = removed & (rseq <= r)
        ins_vis = (T[IC_] == c) | (T[IS_] <= r)
        among = (T[RC0:PP0] == c).any(0)
        skip = (~live) | tomb | (removed & ~ins_vis)
        visible = (~skip) & ins_vis & ~(removed & among)
        vis = torch.where(visible, T[L_], 0)
        consume = torch.where(live & (T[B_] >= SETTLED_BASE), T[L_], 0)
        delta = vis - consume
        inc = torch.cumsum(delta, 0, dtype=I32)
        T[PRE_] = T[A_] + (inc - delta)
        T[VIS_] = vis
        return skip, int(inc[-1])

    for i in range(ops.pos1.shape[0]):
        (otype, pos1, pos2, oseq, orefseq, oclient, obuf,
         oilen) = (col[i] for col in cols)

        if otype == OP_INSERT:
            skip, dsum = vis_pass(orefseq, oclient)
            nl = nlive
            live = flat < nl
            pre = T[PRE_]
            vis = T[VIS_]
            total = S + dsum
            inside = (pre < pos1) & (pre + vis > pos1)
            land = live & (
                (pre > pos1)
                | ((pre == pos1) & (~skip) & ((vis > 0) | (oseq > T[IS_])))
            )
            j0 = first_idx(inside | land)
            preX, visX = at(PRE_, j0), at(VIS_, j0)
            ancX, bufX = at(A_, j0), at(B_, j0)
            has_split = j0 < W and preX < pos1 and preX + visX > pos1
            land_dead = j0 >= nl
            span_s = bufX >= SETTLED_BASE
            off = pos1 - preX
            if has_split:
                aval = ancX + (off if span_s else 0)
            elif land_dead:
                aval = min(pos1 - dsum, S)
            else:
                aval = ancX - (preX - pos1)
            t1 = j0 + 1 if has_split else min(j0, nl)
            n_new = 2 if has_split else 1
            if not has_split and land_dead and total < pos1:
                err |= ERR_BAD_POS
            if nl + n_new > W:
                err |= ERR_CAPACITY
            roll_from(t1)
            if has_split:
                roll_from(t1)
                set1(L_, t1 - 1, off)
                set1(VIS_, t1 - 1, off)
                t = t1 + 1  # tail: a raw copy of the split row
                if t < W:
                    set1(B_, t, at(B_, t) + off)
                    set1(L_, t, at(L_, t) - off)
                    if span_s:
                        set1(A_, t, at(A_, t) + off)
                    set1(PRE_, t, pos1)
                    set1(VIS_, t, at(VIS_, t) - off)
            for ci, v in ((A_, aval), (B_, obuf), (L_, oilen), (IS_, oseq),
                          (IC_, oclient), (RS_, NOT_REMOVED)):
                set1(ci, t1, v)
            clear_new_row(t1)
            for key, val in zip(pkeys[i], pvals[i]):
                if key != NO_KEY and 0 <= key < KK:
                    set1(PP0 + key, t1,
                         PROP_ABSENT if val == PROP_DELETE else val)
            set1(PRE_, t1, pos1)
            set1(VIS_, t1, oilen)
            nlive = nl + n_new

        elif otype in (OP_REMOVE, OP_ANNOTATE):
            skip, dsum = vis_pass(orefseq, oclient)
            nl = nlive
            live = flat < nl
            pre = T[PRE_]
            vis = T[VIS_]
            if S + dsum < pos2:
                err |= ERR_BAD_POS
            j1 = first_idx((pre < pos1) & (pre + vis > pos1))
            j2 = first_idx((pre < pos2) & (pre + vis > pos2))
            has1, has2 = j1 < W, j2 < W
            pre1, anc1, buf1 = at(PRE_, j1), at(A_, j1), at(B_, j1)
            pre2, anc2, buf2 = at(PRE_, j2), at(A_, j2), at(B_, j2)
            off1, off2 = pos1 - pre1, pos2 - pre2
            span1, span2 = buf1 >= SETTLED_BASE, buf2 >= SETTLED_BASE
            jc1 = first_idx(live & (pre >= pos1))
            jc2 = first_idx(live & (pre >= pos2))
            if has1:
                c1 = anc1 + (off1 if span1 else 0)
            elif jc1 < W:
                c1 = at(A_, jc1) - (at(PRE_, jc1) - pos1)
            else:
                c1 = pos1 - dsum
            if has2:
                c2 = anc2 + (off2 if span2 else 0)
            elif jc2 < W:
                c2 = at(A_, jc2) - (at(PRE_, jc2) - pos2)
            else:
                c2 = pos2 - dsum
            r1 = j1 + 1 if has1 else (j2 + 1 if has2 else W)
            if nl + has1 + has2 > W:
                err |= ERR_CAPACITY
            if has1 or has2:
                roll_from(r1)
            if has1 and has2:
                roll_from(j2 + 2)
            if has1:
                set1(L_, j1, off1)
                set1(VIS_, j1, off1)
                t = j1 + 1
                if t < W:
                    set1(B_, t, at(B_, t) + off1)
                    set1(L_, t, at(L_, t) - off1)
                    if span1:
                        set1(A_, t, at(A_, t) + off1)
                    set1(PRE_, t, pos1)
                    set1(VIS_, t, at(VIS_, t) - off1)
            if has2:
                d2 = j2 + int(has1)
                base = off1 if (has1 and j1 == j2) else 0
                set1(L_, d2, off2 - base)
                set1(VIS_, d2, off2 - base)
                # tail2 is a raw copy of the ORIGINAL row j2
                t = d2 + 1
                if t < W:
                    set1(B_, t, at(B_, t) + off2)
                    set1(L_, t, at(L_, t) - off2)
                    if span2:
                        set1(A_, t, at(A_, t) + off2)
                    set1(PRE_, t, pos2)
                    set1(VIS_, t, at(VIS_, t) - off2)
            nlive = nl + int(has1) + int(has2)

            # Gap materialization: span rows for the settled
            # coordinates [c1, c2) covers. The count is taken once;
            # each step recomputes the gaps on the shifted table.
            def gaps():
                live = flat < nlive
                consume = torch.where(
                    live & (T[B_] >= SETTLED_BASE), T[L_], 0)
                glo = torch.where(flat == 0, 0, torch.roll(T[A_] + consume, 1))
                ghi = torch.where(live, T[A_], S)
                prev_live = (flat == 0) | torch.roll(live, 1)
                lo = torch.clamp(glo, min=c1)
                hi = torch.clamp(ghi, max=c2)
                return (live | prev_live) & (lo < hi), lo, hi, ghi

            n_mat = int(gaps()[0].sum())
            for _ in range(n_mat):
                mat, lo, hi, ghi = gaps()
                nl = nlive
                j = first_idx(mat)
                # the JAX kernel stages gap bounds in (W/128, 128) tiles
                # and reads them with a clamped tile index
                jg = min(j // LANES, W // LANES - 1) * LANES + j % LANES
                lo_j, hi_j, ghi_j = int(lo[jg]), int(hi[jg]), int(ghi[jg])
                pre_new = (at(PRE_, j) if j < nl else S + dsum) - (ghi_j - lo_j)
                if nl + 1 > W:
                    err |= ERR_CAPACITY
                roll_from(j)
                for ci, v in ((A_, lo_j), (B_, SETTLED_BASE + lo_j),
                              (L_, hi_j - lo_j), (IS_, 0),
                              (IC_, NO_CLIENT), (RS_, NOT_REMOVED)):
                    set1(ci, j, v)
                clear_new_row(j)
                set1(PRE_, j, pre_new)
                set1(VIS_, j, hi_j - lo_j)
                nlive = nl + 1

            # Covered-range updates (markRangeRemoved / annotateRange).
            pre = T[PRE_]
            vis = T[VIS_]
            covered = ((vis > 0) & (pre >= pos1) & (pre + vis <= pos2)
                       & (flat < nlive))
            if otype == OP_REMOVE:
                rcl = T[RC0:PP0]
                already = T[RS_] != NOT_REMOVED
                T[RS_] = torch.where(covered & ~already, oseq, T[RS_])
                iota_k = torch.arange(KR, dtype=I32, device=dev)[:, None]
                first_free = torch.where(
                    rcl == NO_CLIENT, iota_k, KR).amin(0)
                no_free = first_free == KR
                slot = torch.where(already, first_free, 0)
                write = covered & ~(already & no_free)
                T[RC0:PP0] = torch.where(
                    write[None] & (iota_k == slot[None]), oclient, rcl)
                if bool((covered & already & no_free).any()):
                    err |= ERR_REMOVERS
            else:
                # Last writer wins; a delete tombstones on span rows
                # but clears on text rows.
                is_span = T[B_] >= SETTLED_BASE
                for key, val in zip(pkeys[i], pvals[i]):
                    if not 0 <= key < KK:
                        continue
                    if val == PROP_DELETE:
                        newv = torch.where(is_span, PROP_DELETE, PROP_ABSENT)
                    else:
                        newv = torch.full_like(is_span, val, dtype=I32)
                    T[PP0 + key] = torch.where(covered, newv, T[PP0 + key])

    def scalar(v: int) -> torch.Tensor:
        return torch.tensor(v, dtype=I32, device=dev)

    return OverlayTable(
        n_rows=scalar(nlive),
        anchor=T[A_].clone(), buf_start=T[B_].clone(),
        length=T[L_].clone(), ins_seq=T[IS_].clone(),
        ins_client=T[IC_].clone(), rem_seq=T[RS_].clone(),
        rem_clients=T[RC0:PP0].t().contiguous(),
        props=T[PP0:PRE_].t().contiguous(),
        settled_len=table.settled_len.clone(),
        error=scalar(err),
    )


# ----------------------------------------------------------------------
# The CUDA kernel's wrapper.


# The CUDA kernel's block: KERNEL_THREADS threads, and a heap row of
# KR + KK ints rounded up to 4 for 16-byte loads, filled one int per
# thread. Where the hot columns live (shared memory or a scratch in
# device memory) is the launcher's choice: `OverlayChunkKernel.plan`
# reads it from csrc/overlay_chunk.cu.
KERNEL_THREADS = 1024
LAYOUTS = ("shared", "global")


class KernelPlan(NamedTuple):
    """A launch's geometry: the layout of the hot columns, rows per
    thread R (W / KERNEL_THREADS: one block of R-row threads in the
    shared layout, R segments of one row per thread in the global one),
    heap row ints KRP, dynamic shared bytes of a block, and the
    hot-scratch ints a document needs (0 in the shared layout)."""

    layout: str
    rows_per_thread: int
    heap_ints: int
    smem_bytes: int
    scratch_ints: int


def kernel_geometry(window: int, KR: int, KK: int) -> Tuple[int, int]:
    """The CUDA kernel's rows per thread R and heap row ints KRP for a
    window of W rows, KR remover slots and KK prop keys. Raises
    ValueError on what the reference refuses too (a window that is not
    a positive multiple of 1024, KR < 1) and on a heap row wider than
    the block (KR + KK > KERNEL_THREADS). Any chunk size is taken."""
    if window <= 0 or window % KERNEL_THREADS:
        raise ValueError(
            f"the overlay window must be a positive multiple of "
            f"{KERNEL_THREADS}; got {window}")
    if KR < 1 or KK < 0 or KR + KK > KERNEL_THREADS:
        raise ValueError(
            f"the overlay kernel's heap rows take 1 <= n_removers and "
            f"n_removers + n_prop_keys <= {KERNEL_THREADS}; got {KR} + {KK}")
    return window // KERNEL_THREADS, -(-(KR + KK) // 4) * 4


def _force(layout: Optional[str]) -> int:
    """The launcher's `force` argument: -1 (its own choice) for None,
    else the index of `layout` in LAYOUTS."""
    if layout is None:
        return -1
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}; got {layout!r}")
    return LAYOUTS.index(layout)


def _doc_shape(table: OverlayTable) -> Tuple[int, ...]:
    """() for one document's table, (D,) for a stack of D documents."""
    return tuple(table.length.shape[:-1])


class OverlayChunkKernel:
    """Launches ``csrc/overlay_chunk.cu`` for one chunk of ops.

    Replaces the Pallas `_overlay_chunk_kernel`
    (fluidframework_tpu/ops/overlay_pallas.py:118). Takes one document
    (a table of ``[W]`` columns, ops of ``[B]``) or a stack of D
    documents (a leading ``[D]`` axis on every table field, n_rows,
    error and settled_len included, and ops of ``[D, B]``): either is
    ONE launch, one block per document. ``launches`` counts the kernel
    launches this wrapper made, not documents; it is incremented where
    the kernel is launched and nowhere else. The wrapper checks device,
    dtype, shape and contiguity, reads the launch's `plan` (worked out
    once per shape), allocates the output table, the cold-row heap and
    the hot scratch the plan asks for, launches on PyTorch's current
    stream without synchronising, and raises if the launch was refused.
    The input table is never written.
    """

    name = "overlay_chunk"
    source = "fluidframework_tpu_torch/csrc/overlay_chunk.cu"
    replaces = "fluidframework_tpu/ops/overlay_pallas.py:118"

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._plans = {}

    def _entry(self):
        if self._lib is None:
            lib = _build.load(self.name)
            lib.overlay_chunk_launch.restype = ctypes.c_int
            lib.overlay_chunk_launch.argtypes = [ctypes.c_int] * 10 + [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
            lib.overlay_chunk_plan.restype = ctypes.c_int
            lib.overlay_chunk_plan.argtypes = [ctypes.c_int] * 8 + [
                ctypes.POINTER(ctypes.c_int)]
            self._lib = lib
        return self._lib

    def plan(self, W: int, KR: int, KK: int, B: int, PK: int,
             device: DeviceLike = None,
             layout: Optional[str] = None) -> KernelPlan:
        """The launch's `KernelPlan` at window W, KR remover slots, KK
        prop keys and chunks of B ops x PK prop slots on `device` (the
        current CUDA device by default), as the kernel's library decides
        it. `layout` ("shared" or "global") asks the library for that
        layout instead of its choice, to hold both layouts against the
        plain version or time them on the same chunks; no replay path
        passes it. Raises ValueError on a shape `kernel_geometry`
        refuses, and RuntimeError where the library refuses the plan (a
        shared layout that does not fit)."""
        dev = torch.device("cuda" if device is None else device)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        key = (index, W, KR, KK, B, PK, layout)
        plan = self._plans.get(key)
        if plan is None:
            R, KRP = kernel_geometry(W, KR, KK)
            out = (ctypes.c_int * 3)()
            rc = self._entry().overlay_chunk_plan(
                index, W, KR, KK, KRP, B, PK, _force(layout), out)
            if rc != 0:
                raise RuntimeError(
                    f"overlay_chunk_plan refused the {layout or 'chosen'} "
                    f"layout at W {W}, B {B}, PK {PK} (CUDA error {rc})")
            plan = self._plans[key] = KernelPlan(
                LAYOUTS[out[0]], R, KRP, out[1], out[2])
        return plan

    def __call__(self, table: OverlayTable, ops: OpBatch,
                 layout: Optional[str] = None) -> OverlayTable:
        """One launch for the chunk `ops` on `table` (one document or a
        stack). `layout` forces a layout as in `plan`."""
        _check_geometry(table, ops)
        dev = table.length.device
        if dev.type != "cuda":
            raise ValueError(
                f"the overlay CUDA kernel needs CUDA tensors, got {dev}")
        lead = _doc_shape(table)
        D = lead[0] if lead else 1
        W = table.length.shape[-1]
        KR = table.rem_clients.shape[-1]
        KK = table.props.shape[-1]
        B, PK = ops.prop_keys.shape[-2:]
        plan = self.plan(W, KR, KK, B, PK, dev, layout)
        ins = [table.n_rows, table.error, table.settled_len,
               table.anchor, table.buf_start, table.length, table.ins_seq,
               table.ins_client, table.rem_seq, table.rem_clients,
               table.props,
               ops.op_type, ops.pos1, ops.pos2, ops.seq, ops.ref_seq,
               ops.client, ops.buf_start, ops.ins_len, ops.prop_keys,
               ops.prop_vals]
        shapes = ([lead] * 3 + [lead + (W,)] * 6
                  + [lead + (W, KR), lead + (W, KK)] + [lead + (B,)] * 8
                  + [lead + (B, PK)] * 2)
        for t, shape in zip(ins, shapes):
            if t.device != dev or t.dtype != I32:
                raise ValueError(
                    "overlay kernel inputs must be int32 tensors on "
                    f"{dev}; got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"overlay kernel: shape {tuple(t.shape)} "
                                 f"where {shape} was expected")
        ins = [t.contiguous() for t in ins]
        heap = torch.empty(lead + (W, plan.heap_ints), dtype=I32, device=dev)
        hot = torch.empty((D, plan.scratch_ints), dtype=I32, device=dev)
        out = OverlayTable(
            n_rows=torch.empty(lead, dtype=I32, device=dev),
            anchor=torch.empty_like(ins[3]),
            buf_start=torch.empty_like(ins[4]),
            length=torch.empty_like(ins[5]),
            ins_seq=torch.empty_like(ins[6]),
            ins_client=torch.empty_like(ins[7]),
            rem_seq=torch.empty_like(ins[8]),
            rem_clients=torch.empty_like(ins[9]),
            props=torch.empty_like(ins[10]),
            settled_len=table.settled_len,
            error=torch.empty(lead, dtype=I32, device=dev),
        )
        outs = [out.anchor, out.buf_start, out.length, out.ins_seq,
                out.ins_client, out.rem_seq, out.rem_clients, out.props,
                out.n_rows, out.error]
        _build.launch(self.name, self._entry().overlay_chunk_launch, dev,
                      (D, W, KR, KK, plan.heap_ints, B, PK, _force(layout)),
                      ins + outs + [heap, hot])
        self.launches += 1
        return out


overlay_chunk_kernel = OverlayChunkKernel()


def overlay_apply_chunk(table: OverlayTable, ops: OpBatch) -> OverlayTable:
    """Apply a chunk of sequenced ops (ascending seq order) to the
    overlay: one document, or a stack of D (leading ``[D]`` axis, ops
    ``[D, B]``). A CUDA table goes to the hand-written kernel (or
    raises), one launch for all documents; a CPU table to the plain
    version, document by document. Bit-identical on rows ``[:n_rows]``
    to the JAX `overlay_apply_chunk` of each document."""
    kind = table.length.device.type
    if kind == "cuda":
        return overlay_chunk_kernel(table, ops)
    if kind == "cpu":
        if not _doc_shape(table):
            return overlay_apply_chunk_ref(table, ops)
        return stack_tables([
            overlay_apply_chunk_ref(table.doc(d), ops_at(ops, d))
            for d in range(table.length.shape[0])])
    raise ValueError(f"overlay_apply_chunk: unsupported device {kind}")


# ----------------------------------------------------------------------
# The fold: its plain PyTorch version, its CUDA kernel's wrapper, and the
# dispatchers that pick one by device.


def fold_device_ref(table: OverlayTable, msn) -> Tuple[
        OverlayTable, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the fold kernel: settle-merge under
    applied MSN `msn` (overlay_ref.fold; the zamboni role), in tensor ops
    with no host sync. `fold_device` runs it on CPU tables.

    Returns ``(table', records, n_rec)``: one stable partition packs
    surviving rows to the front (re-anchored) and the folding rows to
    the back, which then rotate to the front of the ``(W, 5+KK)``
    record block ``[anchor, code, buf, len, ins_seq, props...]``
    (pre-fold anchors; ``code == REC_NONE`` rows reconstruct to
    nothing). Same result as the JAX `fold_device`.

    Docs form: a stacked table (leading ``[D]`` axis) and `msn` of
    ``[D]`` fold every document in the same tensor ops (scans along
    the rows, a batched partition and rotate); records are then
    ``[D, W, 5+KK]`` and n_rec ``[D]``."""
    W = table.length.shape[-1]
    KR = table.rem_clients.shape[-1]
    KK = table.props.shape[-1]
    dev = table.length.device
    msn = torch.as_tensor(msn, dtype=I32, device=dev)[..., None]
    idx = torch.arange(W, dtype=I32, device=dev)
    live = idx < table.n_rows[..., None]
    is_span = live & (table.buf_start >= SETTLED_BASE)
    removed = live & (table.rem_seq != NOT_REMOVED)
    drop = removed & (table.rem_seq <= msn)
    settle_text = live & ~removed & ~is_span & (table.ins_seq <= msn)
    settle_span = live & ~removed & is_span
    folding = drop | settle_text | settle_span

    exc = torch.where(drop & is_span, table.length, 0)
    ins = torch.where(settle_text, table.length, 0)
    exc_b = torch.cumsum(exc, -1, dtype=I32) - exc
    ins_b = torch.cumsum(ins, -1, dtype=I32) - ins
    new_anchor = table.anchor - exc_b + ins_b
    new_s = (table.settled_len + torch.sum(ins, -1, dtype=I32)
             - torch.sum(exc, -1, dtype=I32))

    keep = live & ~folding
    n_new = torch.sum(keep, -1, dtype=I32)
    n_rec = torch.sum(folding, -1, dtype=I32)
    new_buf = torch.where(is_span, SETTLED_BASE + new_anchor, table.buf_start)
    code = torch.where(
        settle_text, REC_SETTLE_TEXT,
        torch.where(drop & is_span, REC_DROP_SPAN,
                    torch.where(settle_span, REC_SETTLE_SPAN, REC_NONE)),
    ).to(I32)
    stack = torch.cat([
        torch.stack([new_anchor, new_buf, table.length, table.ins_seq,
                     table.ins_client, table.rem_seq], -2),
        table.rem_clients.transpose(-1, -2), table.props.transpose(-1, -2),
        torch.stack([table.anchor, code], -2),
    ], -2)
    packed = pack_partition(~keep, stack)
    valid = idx < n_new[..., None]

    def fill(c, f):
        return torch.where(valid, packed[..., c, :], f)

    def fill_rows(lo, hi, f):
        return torch.where(valid[..., None], packed[..., lo:hi, :]
                           .transpose(-1, -2), f).contiguous()

    out = OverlayTable(
        n_rows=n_new,
        anchor=fill(0, 0),
        buf_start=fill(1, 0),
        length=fill(2, 0),
        ins_seq=fill(3, 0),
        ins_client=fill(4, NO_CLIENT),
        rem_seq=fill(5, NOT_REMOVED),
        rem_clients=fill_rows(6, 6 + KR, NO_CLIENT),
        props=fill_rows(6 + KR, 6 + KR + KK, PROP_ABSENT),
        settled_len=new_s.to(I32),
        error=table.error,
    )
    # The back of the partition holds the folding rows in storage
    # order, then dead rows; rotate them to the front of the block.
    rec = torch.cat([
        packed[..., 6 + KR + KK:6 + KR + KK + 2, :], packed[..., 1:4, :],
        packed[..., 6 + KR:6 + KR + KK, :],
    ], -2).transpose(-1, -2)
    rot = torch.remainder(idx.to(torch.int64) + n_new[..., None], W)
    records = torch.gather(rec, -2, rot[..., None].expand(rec.shape))
    return out, records, n_rec


def fold_append_ref(table: OverlayTable, msn, log: torch.Tensor,
                    counts: torch.Tensor, cursor: torch.Tensor,
                    epoch: int) -> Tuple[OverlayTable, torch.Tensor]:
    """The plain PyTorch version of the fold kernel's append form: the
    fold (`fold_device_ref`), then the log step of a replay chunk
    (`_chunk_step_body`'s): the whole ``[W, 5+KK]`` record block into
    `log` at `cursor` (clamped so that it fits), ``counts[..., epoch] =
    n_rec``. `log` and `counts` are updated in place; returns ``(table',
    cursor + n_rec)``."""
    table, records, n_rec = fold_device_ref(table, msn)
    W = records.shape[-2]
    if log.shape[-2] < W:
        raise ValueError(f"fold log of {log.shape[-2]} rows < window {W}")
    # lax.dynamic_update_slice clamps the start so the block fits.
    start = torch.clamp(cursor, 0, log.shape[-2] - W).to(torch.int64)
    rows = start[..., None] + torch.arange(W, dtype=torch.int64,
                                           device=log.device)
    log.scatter_(-2, rows[..., None].expand(records.shape), records)
    counts.select(-1, epoch).copy_(n_rec)
    return table, cursor + n_rec


# The fold kernel's geometry (csrc/overlay_fold.cu): a cluster of G CTAs
# a document, each staging at most `fold_max_segment(KK)` rows at once.
FOLD_CLUSTERS = (1, 2, 4, 8)  # the portable cluster sizes
FOLD_MIN_TILE = 128  # rows a CTA at least, where G > 1
FOLD_MAX_SEGMENT = 4096
FOLD_SMEM = 232448  # an sm_90 block's dynamic shared memory, bytes
FOLD_SMS = 132  # an H100 SXM's SMs, where no card is asked


def fold_max_segment(KK: int) -> int:
    """The most rows a CTA of the fold stages at once: FOLD_MAX_SEGMENT,
    or fewer where 36 + 4 KK bytes a row (nine columns and the props)
    and the 96 bytes of its head would not fit in FOLD_SMEM; a multiple
    of 4."""
    return min(FOLD_MAX_SEGMENT, (FOLD_SMEM - 96) // (36 + 4 * KK) // 4 * 4)


def fold_cluster(D: int, W: int, KK: int, sms: int = FOLD_SMS) -> int:
    """The cluster size the fold kernel's wrapper picks for D documents
    of W rows with KK prop keys: the largest G of `FOLD_CLUSTERS` with
    D G <= `sms` and at least FOLD_MIN_TILE rows a CTA, then doubled
    (up to 8) while a CTA's tile would not fit in one segment."""
    G = 1
    while (2 * G <= FOLD_CLUSTERS[-1] and D * 2 * G <= sms
           and -(-W // (2 * G)) >= FOLD_MIN_TILE):
        G *= 2
    while (2 * G <= FOLD_CLUSTERS[-1]
           and -(-W // G) > fold_max_segment(KK)):
        G *= 2
    return G


class OverlayFoldKernel:
    """Launches ``csrc/overlay_fold.cu``: the fold of one document's
    table (``[W]`` columns) or a stack of D documents (a leading
    ``[D]`` axis on every field), one launch of D clusters of G CTAs
    (`fold_cluster` picks G from D, W and the card's SMs; a caller may
    force it with ``cluster=``).

    Replaces the XLA functions `fold_device`
    (fluidframework_tpu/ops/overlay_pallas.py:703) and, in its append
    form, `fold_device` with the log step of `_chunk_step_body` (:836).
    ``launches`` counts the kernel launches this wrapper made; it is
    incremented where the kernel is launched and nowhere else. The
    wrapper checks device, dtype, shape and contiguity, allocates the
    output table (and the records, or the new cursor), launches on
    PyTorch's current stream without synchronising, and raises if the
    launch was refused: there is no fallback. The input table is never
    written; the append form writes `log` and `counts` in place. The MSN
    is an int (passed by value) or an int32 tensor on the table's device
    of one int or ``[D]`` (read by the kernel: no host sync)."""

    name = "overlay_fold"
    source = "fluidframework_tpu_torch/csrc/overlay_fold.cu"
    replaces = "fluidframework_tpu/ops/overlay_pallas.py:703"

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    @staticmethod
    def bind(lib: ctypes.CDLL):
        """The C entry of a loaded kernel library, typed."""
        fn = lib.overlay_fold_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 15 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        return fn

    @staticmethod
    def geometry(D: int, W: int, KK: int, cluster: Optional[int] = None,
                 segment: Optional[int] = None,
                 sms: int = FOLD_SMS) -> Tuple[int, int]:
        """``(G, S)``: the cluster size (`fold_cluster` unless forced) and
        the rows a CTA stages at once: its whole tile (W / G rounded up
        to 4 rows) up to `fold_max_segment`, or `segment` (rounded up to
        4 rows, capped at the tile) where a test forces more segments.
        Raises ValueError on a size the kernel does not take."""
        if fold_max_segment(KK) < 4:
            raise ValueError(f"overlay fold kernel: {KK} prop keys leave no "
                             "room for a segment in shared memory")
        G = fold_cluster(D, W, KK, sms) if cluster is None else int(cluster)
        if G not in FOLD_CLUSTERS:
            raise ValueError(f"overlay fold kernel: cluster size {G} not in "
                             f"{FOLD_CLUSTERS}")
        S = min((-(-W // G) + 3) // 4 * 4, fold_max_segment(KK))
        if segment is not None:
            if not 1 <= segment <= fold_max_segment(KK):
                raise ValueError(f"overlay fold kernel: segment {segment} "
                                 f"not in [1, {fold_max_segment(KK)}]")
            S = min(S, (int(segment) + 3) // 4 * 4)
        return G, S

    def _entry(self):
        if self._fn is None:
            self._fn = self.bind(_build.load(self.name))
        return self._fn

    @classmethod
    def args(cls, table: OverlayTable, msn,
             log: Optional[torch.Tensor] = None,
             counts: Optional[torch.Tensor] = None,
             cursor: Optional[torch.Tensor] = None, epoch: int = 0,
             cluster: Optional[int] = None, segment: Optional[int] = None,
             sms: int = FOLD_SMS, empty=torch.empty):
        """The launch of one call on `table`'s device, whatever it is:
        ``(ints, tensors, result)`` for the C entry (``ints`` after the
        device index, ``tensors`` the 26 pointers' tensors, None for a
        null) and what the call returns, ``(table', records, n_rec)``,
        or ``(table', cursor')`` when `log` is given (the append form).
        `cluster`, `segment` and `sms` go to `geometry`. Outputs are
        made by `empty` (the host emulation fills them with garbage);
        the kernel needs no scratch. Raises ValueError on what the
        kernel does not take."""
        dev = table.length.device
        lead = _doc_shape(table)
        D = lead[0] if lead else 1
        W = table.length.shape[-1]
        KR = table.rem_clients.shape[-1]
        KK = table.props.shape[-1]
        G, S = cls.geometry(D, W, KK, cluster, segment, sms)
        ins = [table.n_rows, table.settled_len, table.anchor,
               table.buf_start, table.length, table.ins_seq,
               table.ins_client, table.rem_seq, table.rem_clients,
               table.props]
        shapes = ([lead] * 2 + [lead + (W,)] * 6
                  + [lead + (W, KR), lead + (W, KK)])
        for t, shape in zip(ins, shapes):
            if t.device != dev or t.dtype != I32:
                raise ValueError(
                    "overlay fold kernel inputs must be int32 tensors on "
                    f"{dev}; got {t.dtype} on {t.device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"overlay fold kernel: shape "
                                 f"{tuple(t.shape)} where {shape} was "
                                 "expected")
        ins = [t.contiguous() for t in ins]
        if isinstance(msn, torch.Tensor):
            if (msn.device != dev or msn.dtype != I32
                    or msn.numel() not in (1, D)):
                raise ValueError(
                    f"overlay fold kernel: msn must be an int or int32 of "
                    f"one or {D} ints on {dev}")
            msn_t, msn_v, msn_stride = msn.contiguous(), 0, int(
                msn.numel() > 1)
        else:
            msn_t, msn_v, msn_stride = None, _i32(int(msn)), 0
        out = OverlayTable(
            n_rows=empty(lead, dtype=I32, device=dev),
            anchor=empty((*lead, W), dtype=I32, device=dev),
            buf_start=empty((*lead, W), dtype=I32, device=dev),
            length=empty((*lead, W), dtype=I32, device=dev),
            ins_seq=empty((*lead, W), dtype=I32, device=dev),
            ins_client=empty((*lead, W), dtype=I32, device=dev),
            rem_seq=empty((*lead, W), dtype=I32, device=dev),
            rem_clients=empty((*lead, W, KR), dtype=I32, device=dev),
            props=empty((*lead, W, KK), dtype=I32, device=dev),
            settled_len=empty(lead, dtype=I32, device=dev),
            error=table.error,
        )
        outs = [out.n_rows, out.settled_len, out.anchor, out.buf_start,
                out.length, out.ins_seq, out.ins_client, out.rem_seq,
                out.rem_clients, out.props]
        if log is None:
            records = empty((*lead, W, 5 + KK), dtype=I32, device=dev)
            n_rec = empty(lead, dtype=I32, device=dev)
            return ((D, W, KR, KK, G, S, msn_v, msn_stride, 0, 0, 0, 0, 0),
                    ins + [msn_t] + outs + [records, n_rec, None, None, None],
                    (out, records, n_rec))
        cap = log.shape[-2]
        if cap < W:
            raise ValueError(f"fold log of {cap} rows < window {W}")
        n_epochs = counts.shape[-1]
        if not 0 <= epoch < n_epochs:
            raise IndexError(f"epoch {epoch} out of range for counts of "
                             f"{n_epochs} epochs")
        for name, t, shape in (("log", log, lead + (cap, 5 + KK)),
                               ("counts", counts, lead + (n_epochs,))):
            if (t.device != dev or t.dtype != I32
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(
                    f"overlay fold kernel: {name} must be a contiguous "
                    f"int32 tensor of shape {shape} on {dev}")
        if (not isinstance(cursor, torch.Tensor) or cursor.device != dev
                or cursor.dtype != I32 or cursor.numel() not in (1, D)):
            raise ValueError(f"overlay fold kernel: cursor must be int32 of "
                             f"one or {D} ints on {dev}")
        new_cursor = empty(lead, dtype=I32, device=dev)
        return ((D, W, KR, KK, G, S, msn_v, msn_stride, 1, cap, n_epochs,
                 epoch, int(cursor.numel() > 1)),
                ins + [msn_t] + outs + [log, None, cursor.contiguous(),
                                        new_cursor, counts],
                (out, new_cursor))

    @staticmethod
    def _cuda(dev: torch.device) -> None:
        if dev.type != "cuda":
            raise ValueError(
                f"the overlay fold CUDA kernel needs CUDA tensors, got {dev}")

    _sms: dict = {}

    @classmethod
    def sm_count(cls, dev: torch.device) -> int:
        """The SMs of the card `dev` (a CUDA device), asked once."""
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        if index not in cls._sms:
            cls._sms[index] = torch.cuda.get_device_properties(
                index).multi_processor_count
        return cls._sms[index]

    def _launch(self, table: OverlayTable, *args, cluster=None):
        dev = table.length.device
        self._cuda(dev)
        ints, tensors, result = self.args(table, *args, cluster=cluster,
                                          sms=self.sm_count(dev))
        _build.launch(self.name, self._entry(), dev, ints, tensors)
        self.launches += 1
        return result

    def __call__(self, table: OverlayTable, msn,
                 cluster: Optional[int] = None) -> Tuple[
                     OverlayTable, torch.Tensor, torch.Tensor]:
        """The fold of `table` under `msn`: ``(table', records,
        n_rec)``, as `fold_device_ref` returns them; `cluster` forces
        the cluster size."""
        return self._launch(table, msn, cluster=cluster)

    def append(self, table: OverlayTable, msn, log: torch.Tensor,
               counts: torch.Tensor, cursor: torch.Tensor, epoch: int,
               cluster: Optional[int] = None) -> Tuple[OverlayTable,
                                                       torch.Tensor]:
        """The fold and the log append of one replay step: ``(table',
        cursor')``, `log` and `counts` written in place, as
        `fold_append_ref` does; `cluster` forces the cluster size."""
        return self._launch(table, msn, log, counts, cursor, epoch,
                            cluster=cluster)

    def launch_empty(self, dev: torch.device, D: int, W: int, KK: int,
                     cluster: Optional[int] = None) -> None:
        """An empty kernel with the grid, clusters and shared memory of
        the fold of D documents of W rows with KK prop keys, on
        PyTorch's current stream: the launch floor beside the fold's
        time. Not a fold launch: ``launches`` does not count it."""
        self._cuda(dev)
        fn = _build.load(self.name).overlay_fold_empty_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        _build.launch(f"{self.name} empty", fn, dev,
                      (D, W, KK, *self.geometry(D, W, KK, cluster,
                                                sms=self.sm_count(dev))), [])


overlay_fold_kernel = OverlayFoldKernel()


def fold_device(table: OverlayTable, msn) -> Tuple[
        OverlayTable, torch.Tensor, torch.Tensor]:
    """Settle-merge under applied MSN `msn`: ``(table', records,
    n_rec)`` (see `fold_device_ref`), one document or a stack of D. A
    CUDA table goes to the hand-written kernel (`OverlayFoldKernel`, one
    launch, or it raises); a CPU table to the plain version. Same
    result as the JAX `fold_device`."""
    kind = table.length.device.type
    if kind == "cuda":
        return overlay_fold_kernel(table, msn)
    if kind == "cpu":
        return fold_device_ref(table, msn)
    raise ValueError(f"fold_device: unsupported device {kind}")


def fold_append(table: OverlayTable, msn, log: torch.Tensor,
                counts: torch.Tensor, cursor: torch.Tensor,
                epoch: int) -> Tuple[OverlayTable, torch.Tensor]:
    """The fold and the log append of one replay step (see
    `fold_append_ref`): a CUDA table goes to the kernel's append form
    (one launch, or it raises), a CPU table to the plain version."""
    kind = table.length.device.type
    if kind == "cuda":
        return overlay_fold_kernel.append(table, msn, log, counts, cursor,
                                          epoch)
    if kind == "cpu":
        return fold_append_ref(table, msn, log, counts, cursor, epoch)
    raise ValueError(f"fold_append: unsupported device {kind}")


def _chunk_ops(table: OverlayTable, stream_ops: OpBatch, lo: int,
               chunk: int) -> OpBatch:
    """Ops ``[lo, lo+chunk)`` of the stream (views). Docs form (a
    stacked table): the stream's fields are ``[n_chunks, D, B]``, so a
    chunk is one contiguous ``[D, B]`` slice."""
    if _doc_shape(table):
        return ops_at(stream_ops, lo // chunk)
    return stream_ops.slice(lo, lo + chunk)


def replay_chunk_step(
    table: OverlayTable, stream_ops: OpBatch, lo: int, chunk: int, msn,
    log: torch.Tensor, counts: torch.Tensor, cursor: torch.Tensor,
    epoch: int,
):
    """One replay step: ops ``[lo, lo+chunk)`` through the chunk kernel,
    then the fold at the chunk boundary with the append of its records
    to the log at ``cursor`` (`fold_append`). ``log`` and ``counts`` are
    updated IN PLACE (the JAX version donates them). No host sync; on
    the card two launches, kernel A and the fold.

    Returns ``(table', log, counts, cursor')``; ``counts[epoch]`` holds
    this epoch's record count. Docs form: a stacked table, stream ops
    ``[n_chunks, D, B]`` (`lo` a multiple of `chunk`), `msn` ``[D]``,
    log ``[D, cap, 5+KK]``, counts ``[D, n_chunks]`` and cursor
    ``[D]``: one launch of each kernel for all documents."""
    table = overlay_apply_chunk(table, _chunk_ops(table, stream_ops, lo,
                                                  chunk))
    table, cursor = fold_append(table, msn, log, counts, cursor, epoch)
    return table, log, counts, cursor


def replay_fused(
    table: OverlayTable, stream_ops: OpBatch, log: torch.Tensor,
    counts: torch.Tensor, msn_by_chunk: torch.Tensor, chunk: int,
    epoch0: int = 0,
):
    """The whole replay: every chunk of `stream_ops` through
    `replay_chunk_step`, in one Python loop with no host sync inside
    it (on the card two launches a chunk: kernel A and the fold).

    `msn_by_chunk[ci]` is the applied MSN at chunk ci's end. `epoch0`
    numbers the first chunk globally, and the log cursor resumes where
    ``counts[:epoch0]`` left it. Returns ``(table, log, counts,
    cursor)``. Docs form (see `replay_chunk_step`): `msn_by_chunk` is
    ``[n_chunks, D]`` and every document advances in the same launches."""
    n_chunks = msn_by_chunk.shape[0]
    cursor = torch.sum(counts[..., :epoch0], -1, dtype=I32)
    for ci in range(n_chunks):
        table, log, counts, cursor = replay_chunk_step(
            table, stream_ops, ci * chunk, chunk, msn_by_chunk[ci], log,
            counts, cursor, epoch0 + ci,
        )
    return table, log, counts, cursor
