"""Batched changeset rebase on PyTorch: BASELINE config 4's device work.

Counterpart of fluidframework_tpu/tree/rebase_kernel.py, with the same
names. A pending branch of N single-field ops (kind, index, count, dst)
is rebased over a trunk window of M base ops, applied in order; each
base op adjusts EVERY pending op by the same closed-form rules
(insert-over-insert shifts with the sequenced-earlier tie, removes
clipped against base removes, gap travel with a base move's block,
attach-adjacency ties, move-absorb, full mutes), keeps one spare piece
for a remove split by an attach, and flags what is beyond that budget
for the scalar changeset path. The step reads only the pending op and
the current base op: there is no reduction across the pending axis.

- `_rebase_step_ref` is the plain PyTorch version of one step for all N
  pending ops at once (the JAX `_rebase_step`), and `rebase_batch_ref`
  its loop over the M base ops (the JAX `lax.scan` in `rebase_batch`).
  Everything stays int32 and the two flag columns ``torch.bool``; no
  ``where`` or ``sum`` widens to int64.
- `RebaseKernel` launches the hand-written CUDA kernel
  ``csrc/rebase_batch.cu``: one thread per pending op walks the whole
  window, the window staged in shared memory; each block groups its
  ops by kind so that a warp runs one kind's step; one launch per
  rebase. `warp_steps` counts the warps by the step they run.
- `rebase_batch` sends CUDA tensors to the kernel (or raises) and CPU
  tensors to the plain version; no other device is taken.
- `rebase_ops_columnar` is the numpy entry point (config 4's), with one
  upload, one launch and one read-back, and the reference's numpy
  sequentialization of the spare tails.

Like the reference, the rebase is functional: its inputs are left as
they were, and the outputs are new tensors.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import _build
from ..utils.devices import DeviceLike, resolve_device

I32 = torch.int32

# Op kinds (fluidframework_tpu/tree/rebase_kernel.py:39-41).
K_INSERT = 0
K_REMOVE = 1
K_MOVE = 2

# The eight outputs, in the reference's order: six int32, two bool.
OUT_FIELDS = ("kind", "idx", "cnt", "dst", "spare_idx", "spare_cnt",
              "spare_active", "flagged")


# ----------------------------------------------------------------------
# The plain PyTorch version. Base values are 0-d int32 tensors (one
# element of the base columns), pending values int32 [N] tensors.


def _attach_gap(bi, bn, bj):
    """A base move's attach gap in its own POST-DETACH frame
    (changeset._attach_gap, single field)."""
    return torch.where(bj >= bi + bn, bj - bn, torch.where(bj > bi, bi, bj))


def _gap_over(g, bk, bi, bn, bg):
    """Adjust an insertion GAP over one base op (base sequenced
    earlier: ties shift); `bg` is the base move's post-detach attach
    gap (ignored unless bk == K_MOVE)."""
    g_ins = torch.where(bi <= g, g + bn, g)
    g_rem = torch.where(g < bi, g, torch.maximum(bi, g - bn))
    # base move: strictly-inside gaps TRAVEL with the block; boundary
    # gaps keep their adjacency side on attach ties.
    inside = (bi < g) & (g < bi + bn)
    travel = bg + (g - bi)
    before = g == bi
    g1 = g_rem  # detach slide: same rule as a base remove
    shift_attach = (bg < g1) | ((bg == g1) & ~before)
    g_mv = torch.where(inside, travel, torch.where(shift_attach, g1 + bn, g1))
    return torch.where(bk == K_INSERT, g_ins,
                       torch.where(bk == K_REMOVE, g_rem, g_mv))


def _remove_over_rm(idx, cnt, bi, bn):
    """Clip a range against a base REMOVE [bi, bi+bn): the overlap is
    already gone (changeset._range_over_base remove branch)."""
    lo = torch.maximum(idx, bi)
    hi = torch.minimum(idx + cnt, bi + bn)
    overlap = (hi - lo).clamp(min=0)
    new_cnt = cnt - overlap
    new_idx = torch.where(idx < bi, idx, torch.maximum(bi, idx - bn))
    return new_idx, new_cnt


def _rebase_step_ref(state, base):
    """Adjust all pending ops over ONE base op: the JAX `_rebase_step`
    (rebase_kernel.py:83-259). state: (kind, index, count, dst,
    spare_idx, spare_cnt, spare_act, flag), each [N]; base: (kind,
    index, count, dst_gap), each a 0-d int32 tensor. Muted ops end with
    count 0. A base attach strictly inside a pending remove splits it:
    the head keeps the primary slot, the tail takes the spare slot (one
    native split per op); a second split, a remove partly over a base
    move's block, competing move claims and mutual containment flag."""
    kind, idx, cnt, dst, s_idx, s_cnt, s_act, flag = state
    bk, bi, bn, bj = base
    bg = _attach_gap(bi, bn, bj)
    # An identity base move applies as a no-op and adjusts nothing.
    base_noop = (bk == K_MOVE) & (bi <= bj) & (bj <= bi + bn)

    is_ins = kind == K_INSERT
    is_rem = kind == K_REMOVE
    is_mv = kind == K_MOVE
    live = cnt > 0
    # A pending identity move rebases to nothing (judged on the
    # pre-step index, count and dst).
    op_noop = is_mv & (idx <= dst) & (dst <= idx + cnt)

    # pending INSERT: a pure gap.
    ins_idx = _gap_over(idx, bk, bi, bn, bg)

    # pending REMOVE [idx, idx+cnt): shift or split over a base insert,
    # clip against a base remove, relocate on full containment in a
    # base move's block (partial overlap flags).
    rm_ins_idx = torch.where(bi <= idx, idx + bn, idx)
    clip_idx, clip_cnt = _remove_over_rm(idx, cnt, bi, bn)
    ov_lo = torch.maximum(idx, bi)
    ov_hi = torch.minimum(idx + cnt, bi + bn)
    mv_overlap = (ov_hi - ov_lo).clamp(min=0) > 0
    full_inside = (idx >= bi) & (idx + cnt <= bi + bn)
    rm_mv_idx0 = torch.where(idx >= bi + bn, idx - bn, idx)
    rm_mv_idx = torch.where(full_inside, bg + (idx - bi), rm_mv_idx0)
    new_idx = torch.where(bk == K_INSERT, rm_ins_idx,
                          torch.where(bk == K_REMOVE, clip_idx, rm_mv_idx))
    new_cnt = torch.where(bk == K_REMOVE, clip_cnt, cnt)

    # pending MOVE: src range + dst gap. A base insert strictly inside
    # the block is absorbed; a base move's attach likewise.
    mv_ins_absorb = (bi > idx) & (bi < idx + cnt)
    mv_ins_idx = torch.where(bi <= idx, idx + bn, idx)
    mv_ins_cnt = torch.where(mv_ins_absorb, cnt + bn, cnt)
    mv_mv_idx0 = torch.where(idx >= bi + bn, idx - bn, idx)
    mv_mv_absorb = (bg > mv_mv_idx0) & (bg < mv_mv_idx0 + cnt)
    mv_mv_idx = torch.where(bg <= mv_mv_idx0, mv_mv_idx0 + bn, mv_mv_idx0)
    mv_mv_cnt = torch.where(mv_mv_absorb, cnt + bn, cnt)
    mv_idx = torch.where(bk == K_INSERT, mv_ins_idx,
                         torch.where(bk == K_REMOVE, clip_idx, mv_mv_idx))
    mv_cnt = torch.where(bk == K_INSERT, mv_ins_cnt,
                         torch.where(bk == K_REMOVE, clip_cnt, mv_mv_cnt))
    new_dst = _gap_over(dst, bk, bi, bn, bg)

    # flags (beyond the vector budget).
    flag_rm_partial = (bk == K_MOVE) & is_rem & live & mv_overlap \
        & ~full_inside
    mv_src_overlap = (bk == K_MOVE) & is_mv & live \
        & (torch.maximum(idx, bi) < torch.minimum(idx + cnt, bi + bn))
    mutual = (bk == K_MOVE) & is_mv & live & (bi < dst) \
        & (dst < bi + bn) & (idx < bj) & (bj < idx + cnt)

    # splits of a pending remove around an attach (a base insert's bi,
    # or a base move's bg in the post-detach frame).
    att = torch.where(bk == K_INSERT, bi, bg)
    att_base = torch.where(bk == K_INSERT, idx, rm_mv_idx0)
    splittable = is_rem & live & (
        (bk == K_INSERT) | ((bk == K_MOVE) & ~mv_overlap & ~base_noop))
    split_p = splittable & (att > att_base) & (att < att_base + cnt)
    sp_att_base = torch.where(
        bk == K_INSERT, s_idx,
        torch.where(s_idx >= bi + bn, s_idx - bn, s_idx))
    split_s = s_act & (s_cnt > 0) \
        & ((bk == K_INSERT) | ((bk == K_MOVE) & ~base_noop)) \
        & (att > sp_att_base) & (att < sp_att_base + s_cnt)
    sp_mv_overlap = s_act & (s_cnt > 0) & (bk == K_MOVE) & ~base_noop \
        & (torch.maximum(s_idx, bi) < torch.minimum(s_idx + s_cnt, bi + bn))
    # Both read the PRE-step s_act; s_act changes only below.
    use_spare = split_p & ~s_act
    new_flag = flag | (split_p & s_act) | split_s | sp_mv_overlap \
        | flag_rm_partial | mv_src_overlap | mutual

    # remove with no node overlap vs base MOVE: attach shift when at or
    # before the slid range.
    rm_att_shift = is_rem & live & (bk == K_MOVE) & ~mv_overlap \
        & ~base_noop & (att <= att_base)
    new_idx = torch.where(rm_att_shift, new_idx + bn, new_idx)

    # the spare piece (a remove), adjusted whether active or not.
    sp_clip_idx, sp_clip_cnt = _remove_over_rm(s_idx, s_cnt, bi, bn)
    sp_idx1 = torch.where(
        bk == K_INSERT, torch.where(bi <= s_idx, s_idx + bn, s_idx),
        torch.where(bk == K_REMOVE, sp_clip_idx,
                    torch.where(att <= sp_att_base, sp_att_base + bn,
                                sp_att_base)))
    sp_cnt1 = torch.where(bk == K_REMOVE, sp_clip_cnt, s_cnt)

    # select per pending kind.
    out_idx = torch.where(is_ins, ins_idx, torch.where(is_mv, mv_idx, new_idx))
    out_cnt = torch.where(is_ins, cnt, torch.where(is_mv, mv_cnt, new_cnt))
    out_dst = torch.where(is_mv, new_dst, dst)

    # the tail of a fresh split, in post-base coordinates.
    tail_idx = att + bn
    tail_cnt = (att_base + cnt) - att
    out_cnt = torch.where(use_spare, att - att_base, out_cnt)
    out_idx = torch.where(use_spare, att_base, out_idx)
    sp_idx1 = torch.where(use_spare, tail_idx, sp_idx1)
    sp_cnt1 = torch.where(use_spare, tail_cnt, sp_cnt1)
    new_act = s_act | use_spare

    # A pending identity move mutes; an identity BASE op leaves every
    # field as it was, the spare's activity and the flag included.
    out_cnt = out_cnt.masked_fill(op_noop, 0)
    keep = base_noop
    out_idx = torch.where(keep, idx, out_idx)
    out_cnt = torch.where(keep, cnt, out_cnt)
    out_dst = torch.where(keep, dst, out_dst)
    sp_idx1 = torch.where(keep, s_idx, sp_idx1)
    sp_cnt1 = torch.where(keep, s_cnt, sp_cnt1)
    new_act = torch.where(keep, s_act, new_act)
    new_flag = torch.where(keep, flag, new_flag)
    return (kind, out_idx, out_cnt, out_dst, sp_idx1, sp_cnt1, new_act,
            new_flag)


def _check_inputs(ts, device=None) -> Tuple[int, int]:
    """The eight columns: int32, 1-D, on one device, the pending four of
    one length N and the base four of one length M. Returns (N, M)."""
    if len(ts) != 8:
        raise ValueError(f"rebase: expected 8 columns, got {len(ts)}")
    dev = ts[0].device if device is None else device
    for t in ts:
        if t.dtype != I32 or t.dim() != 1 or t.device != dev:
            raise ValueError(
                f"rebase: got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"where int32 1-D on {dev} was expected")
    n, m = ts[0].shape[0], ts[4].shape[0]
    if any(t.shape[0] != n for t in ts[:4]) or \
            any(t.shape[0] != m for t in ts[4:]):
        raise ValueError("rebase: the pending columns (or the base "
                         "columns) differ in length")
    return n, m


def rebase_batch_ref(kinds, idxs, cnts, dsts, base_kinds, base_idxs,
                     base_cnts, base_dsts):
    """The plain version: `_rebase_step_ref` over the M base ops in
    order (the JAX `lax.scan`). CPU tensors only. Returns ``(kind, idx,
    cnt, dst, spare_idx, spare_cnt, spare_active, flagged)``: int32 × 6
    and bool × 2, each [N]; M = 0 gives the inputs back with zero
    spares and no flags."""
    cols = (kinds, idxs, cnts, dsts, base_kinds, base_idxs, base_cnts,
            base_dsts)
    if any(t.device.type != "cpu" for t in cols):
        raise ValueError("rebase_batch_ref takes CPU tensors only; got "
                         f"{kinds.device}")
    _check_inputs(cols)
    n = kinds.shape[0]
    zeros = torch.zeros(n, dtype=I32)
    state = (kinds, idxs, cnts, dsts, zeros, zeros,
             torch.zeros(n, dtype=torch.bool),
             torch.zeros(n, dtype=torch.bool))
    for m in range(base_kinds.shape[0]):
        state = _rebase_step_ref(state, (base_kinds[m], base_idxs[m],
                                         base_cnts[m], base_dsts[m]))
    # new tensors throughout, as the reference returns new arrays
    return tuple(t.clone() for t in state)


# ----------------------------------------------------------------------
# The CUDA kernel's wrapper.

THREADS = 256  # pending ops per block (BLOCK in the .cu file)
TILE = 1024  # base ops staged in shared memory at a time; the .cu file's
WARP = 32
# The step a warp of the kernel runs: one kind's, or every kind's.
WARP_STEPS = ("insert", "remove", "move", "generic")


def warp_steps(kinds, block: int = THREADS) -> Dict[str, int]:
    """The kernel's warps counted by the step they run, for the
    pending kind column `kinds`: in each block of `block` ops, the ops
    are ordered stably by class (insert, remove, move, then any kind
    outside 0..2), and a warp of 32 of those slots that holds an op runs
    its ops' kind's step when they all share one kind of 0..2, and the
    generic step (every kind's branches) otherwise."""
    k = np.asarray(kinds, np.int64).ravel()
    out = dict.fromkeys(WARP_STEPS, 0)
    for b0 in range(0, len(k), block):
        kb = k[b0:b0 + block]
        kb = kb[np.argsort(np.where((kb >= 0) & (kb <= 2), kb, 3),
                           kind="stable")]
        for w0 in range(0, len(kb), WARP):
            w = kb[w0:w0 + WARP]
            same = bool((w == w[0]).all()) and 0 <= w[0] <= 2
            out[WARP_STEPS[w[0]] if same else "generic"] += 1
    return out


def alloc_result(n: int, device) -> Tuple[torch.Tensor, tuple]:
    """One flat buffer for the eight outputs of a rebase of n pending
    ops and their views into it (six int32 planes, then the two bool
    columns as bytes), so that they come back to the host in one copy
    (`read_result`)."""
    buf = torch.empty(6 * n + (2 * n + 3) // 4, dtype=I32, device=device)
    planes = buf[:6 * n].view(6, n)
    flags = buf[6 * n:].view(torch.uint8)[:2 * n].view(torch.bool).view(2, n)
    return buf, (*planes, flags[0], flags[1])


def read_result(buf: torch.Tensor, n: int) -> tuple:
    """The eight outputs of an `alloc_result` buffer as numpy arrays
    (one device-to-host copy)."""
    host = buf.cpu().numpy()
    planes = host[:6 * n].reshape(6, n)
    flags = host[6 * n:].view(np.uint8)[:2 * n].view(bool).reshape(2, n)
    return (*planes, flags[0], flags[1])


class RebaseKernel:
    """Launches ``csrc/rebase_batch.cu`` for one rebase.

    Replaces the JAX package's `_rebase_step` under the `rebase_batch`
    scan (fluidframework_tpu/tree/rebase_kernel.py:83 and :262), an XLA
    scan rather than a Pallas kernel. ``launches`` counts the kernel
    launches this wrapper made; it is incremented where the kernel is
    launched and nowhere else. The wrapper checks device, dtype, shape
    and contiguity, allocates the outputs unless `out` is given (eight
    contiguous [N] tensors, e.g. from `alloc_result`), launches on
    PyTorch's current stream without synchronising, and raises if the
    launch was refused: there is no fallback. N = 0 launches nothing
    (the outputs are empty); M = 0 launches, and the kernel copies the
    inputs out with zero spares and no flags."""

    name = "rebase_batch"
    source = "fluidframework_tpu_torch/csrc/rebase_batch.cu"
    replaces = "fluidframework_tpu/tree/rebase_kernel.py::_rebase_step"

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = _build.load(self.name)
            fn = lib.rebase_batch_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 4 + [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def __call__(self, kinds, idxs, cnts, dsts, base_kinds, base_idxs,
                 base_cnts, base_dsts, out: Optional[tuple] = None):
        ins = (kinds, idxs, cnts, dsts, base_kinds, base_idxs, base_cnts,
               base_dsts)
        dev = kinds.device
        if dev.type != "cuda":
            raise ValueError(
                f"the rebase CUDA kernel needs CUDA tensors, got {dev}")
        n, m = _check_inputs(ins, dev)
        if out is None:
            _, out = alloc_result(n, dev)
        for t, dt in zip(out, (I32,) * 6 + (torch.bool,) * 2):
            if (t.device != dev or t.dtype != dt or tuple(t.shape) != (n,)
                    or not t.is_contiguous()):
                raise ValueError("rebase kernel: bad output buffer")
        if n == 0:
            return tuple(out)
        ins = [t.contiguous() for t in ins]
        _build.launch(self.name, self._entry(), dev, (n, m),
                      list(ins) + list(out))
        self.launches += 1
        return tuple(out)


rebase_kernel = RebaseKernel()


def rebase_batch(kinds, idxs, cnts, dsts, base_kinds, base_idxs, base_cnts,
                 base_dsts, out: Optional[tuple] = None):
    """Rebase N pending ops over M base ops (applied in order). CUDA
    tensors go to the kernel (one launch), CPU tensors to the plain
    version; any other device raises. `out` takes the eight output
    tensors (`alloc_result`). Returns ``(kind, idx, cnt, dst,
    spare_idx, spare_cnt, spare_active, flagged)``, int32 × 6 and bool
    × 2: a split remove occupies its primary slot (head) plus its spare
    slot (tail); `flagged` marks ops for the scalar changeset path."""
    ins = (kinds, idxs, cnts, dsts, base_kinds, base_idxs, base_cnts,
           base_dsts)
    kind = kinds.device.type
    if kind == "cuda":
        return rebase_kernel(*ins, out=out)
    if kind != "cpu":
        raise ValueError(f"rebase_batch: unsupported device {kind}")
    res = rebase_batch_ref(*ins)
    if out is None:
        return res
    for dst, src in zip(out, res):
        dst.copy_(src)
    return tuple(out)


TIME_STAGES = ("upload", "launch", "read", "sequentialize")


def _pad(a) -> np.ndarray:
    a = np.asarray(a, np.int32)
    if a.shape[1] == 3:
        a = np.concatenate([a, np.zeros((a.shape[0], 1), np.int32)], axis=1)
    return a


def rebase_ops_columnar(ops: np.ndarray, base: np.ndarray,
                        device: DeviceLike = None,
                        times: Optional[Dict[str, float]] = None):
    """numpy entry point (rebase_kernel.py:284-326): ops is [N, 3-or-4]
    and base is [M, 3-or-4], rows of (kind, index, count[, dst]); dst
    is a move's attach gap, padded 0 when the 3-column form is passed.
    One upload of both, one `rebase_batch`, one read-back. Returns
    (rebased [N, 4] int32, spares [N, 3] int32 with count 0 for unsplit
    ops, flagged [N] bool): flagged ops reroute through the scalar
    changeset path (count 0 = muted). Spare pieces are SEQUENTIALIZED
    like the scalar path's multi bundles: a split remove's tail index
    assumes its head applied first. `times`, if given, gets the host
    seconds of the TIME_STAGES added (the read waits for the device)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    ops, base = _pad(ops), _pad(base)
    n, m = ops.shape[0], base.shape[0]
    host = np.concatenate([ops.T.ravel(), base.T.ravel()])
    buf = torch.from_numpy(host).to(dev)
    cols = buf[:4 * n].view(4, n)
    bcols = buf[4 * n:].view(4, m)
    t1 = time.perf_counter()
    res_buf, res = alloc_result(n, dev)
    rebase_batch(*cols, *bcols, out=res)
    t2 = time.perf_counter()
    k, i, c, d, si, sc, sa, f = read_result(res_buf, n)
    t3 = time.perf_counter()
    out = np.stack([k, i, c, d], axis=1)
    # Sequentialize: the tail applies AFTER the head, so it shifts down
    # by the head's count, but only while it still sits at or past the
    # head (a later base move can relocate the head above the tail).
    sp_idx = np.where(sa, np.where(si >= out[:, 1], si - out[:, 2], si), 0)
    spares = np.stack(
        [np.full(n, K_REMOVE, np.int32), sp_idx, np.where(sa, sc, 0)],
        axis=1)
    flagged = f.copy()
    if times is not None:
        t4 = time.perf_counter()
        for key, dt in zip(TIME_STAGES, (t1 - t0, t2 - t1, t3 - t2,
                                         t4 - t3)):
            times[key] = times.get(key, 0.0) + dt
    return out, spares, flagged
