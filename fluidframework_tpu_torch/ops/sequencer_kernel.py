"""The deli's batched multi-document sequencer on PyTorch.

Counterpart of fluidframework_tpu/ops/sequencer_kernel.py, with the
same names. Documents are the data-parallel axis and a ``[D, B]``
batch holds each document's next B submissions in order. Per
submission and document: the validation ladder (unknown client 403,
stale refSeq 400, future refSeq 416, clientSeq gap 422, first failing
rule wins), join / leave / system stamps, boxcar abort (a nack masks
the rest of its group, tracked across chunks by `aborted`), optional
resubmission dedup (checked before the ladder, for known clients
only), and the MSN: the min over connected clients' refSeqs,
recomputed only on a stamp, monotone, trailing the head when no client
is connected. The dense ``[D, C]`` client table replaces the
reference's per-document heap (clientSeqManager.ts:22).

- `_step_one_doc_ref` is the plain PyTorch version of one step for all
  D documents at once (``[D]`` and ``[D, C]`` torch ops), and
  `sequence_batch_ref` its loop over the B columns: the JAX package's
  `_step_one_doc` and `_sequence_batch_impl` scan. Everything stays
  int32: ``INT32_MAX`` is the masked-min sentinel, and no int32
  ``cumsum`` or ``sum`` (which would widen to int64) is taken.
- `SequencerStepKernel` launches the hand-written CUDA kernel
  ``csrc/sequencer_step.cu``: one warp per document over the whole
  chunk, one launch per chunk.
- `sequence_batch` / `sequence_batch_grouped` send CUDA state to the
  kernel (or raise) and CPU state to the plain version; no other
  device is taken.
- `sharded_sequence_fn` runs a pool whose ``[D, C]`` rows are split
  over the entries of a `parallel.mesh.DocsMesh`: one launch per entry
  slab per chunk, on the entry's stream, with no collective.

The state is a NamedTuple of tensors: ``connected`` and the result's
``skipped`` are ``torch.bool``, every other field int32. The kernel is
functional like the reference: it writes a new state and leaves its
inputs as they were.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..protocol.constants import INT32_MAX
from ..utils.devices import DeviceLike, resolve_device
from . import _build

I32 = torch.int32

# Submission kinds (SeqBatch.kind).
SUB_OP = 0  # ordinary client message (op/noop/...): validate + stamp
SUB_JOIN = 1  # client join: admit into the MSN set, stamp a join message
SUB_LEAVE = 2  # client leave: evict, stamp a leave message
SUB_PAD = 3  # padding: no effect, no stamp
SUB_SYSTEM = 4  # server-originated control: stamp unconditionally,
#                 bypassing client validation (deli's system-message
#                 path: summary ack/nack from scribe)

# Boxcar group sentinel (the `groups` batch column): submissions with
# group >= 0 belong to an atomic boxcar; -1 means standalone.
NO_GROUP = -1

# Nack codes (0 = accepted); the values of server/sequencer.py.
ACCEPT = 0
NACK_STALE_REFSEQ = 400
NACK_UNKNOWN_CLIENT = 403
NACK_FUTURE_REFSEQ = 416
NACK_OUT_OF_ORDER = 422

# The abort tracker's "no group aborted" value.
NO_ABORT = -2


class SequencerState(NamedTuple):
    """Per-document sequencer state, documents on the leading axis;
    slot index = the client's dense column within the document."""

    seq: torch.Tensor  # int32[D] last assigned sequence number
    min_seq: torch.Tensor  # int32[D] minimum sequence number (MSN)
    connected: torch.Tensor  # bool[D, C]
    ref_seq: torch.Tensor  # int32[D, C] last seen refSeq per client
    client_seq: torch.Tensor  # int32[D, C] last accepted clientSeq per client


class SeqBatch(NamedTuple):
    """A batch of submissions: one column per step, [D, B] int32."""

    kind: torch.Tensor  # SUB_*
    client: torch.Tensor  # client slot, clipped to [0, C)
    client_seq: torch.Tensor
    ref_seq: torch.Tensor


class SeqResult(NamedTuple):
    """Per-submission verdicts, [D, B]."""

    seq: torch.Tensor  # int32: assigned sequence number (0 if not stamped)
    min_seq: torch.Tensor  # int32: MSN as of this submission
    nack: torch.Tensor  # int32: ACCEPT or NACK_* code
    # bool: masked out with no stamp AND no nack: the tail of an
    # aborted boxcar or a deduped resubmission.
    skipped: torch.Tensor


def make_state(n_docs: int, max_clients: int,
               device: DeviceLike = None) -> SequencerState:
    dev = resolve_device(device)
    return SequencerState(
        seq=torch.zeros(n_docs, dtype=I32, device=dev),
        min_seq=torch.zeros(n_docs, dtype=I32, device=dev),
        connected=torch.zeros((n_docs, max_clients), dtype=torch.bool,
                              device=dev),
        ref_seq=torch.zeros((n_docs, max_clients), dtype=I32, device=dev),
        client_seq=torch.zeros((n_docs, max_clients), dtype=I32, device=dev),
    )


def grow_state(state: SequencerState, n_docs: Optional[int] = None,
               n_clients: Optional[int] = None) -> SequencerState:
    """Zero-pad the packed state to [n_docs, n_clients] on its device
    (new rows are empty documents, new columns never-connected
    clients)."""
    d, c = state.connected.shape
    nd = d if n_docs is None else max(d, n_docs)
    nc = c if n_clients is None else max(c, n_clients)
    if (nd, nc) == (d, c):
        return state

    def pad(t: torch.Tensor) -> torch.Tensor:
        shape = (nd,) if t.dim() == 1 else (nd, nc)
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        if t.dim() == 1:
            out[:d] = t
        else:
            out[:d, :c] = t
        return out

    return SequencerState(*(pad(t) for t in state))


def no_aborts(n_docs: int, device: DeviceLike = None) -> torch.Tensor:
    """A fresh boxcar-abort tracker ([D], no group aborted)."""
    return torch.full((n_docs,), NO_ABORT, dtype=I32,
                      device=resolve_device(device))


def pack_submissions(slot, kind, client, client_seq, ref_seq, groups,
                     n_docs: int, max_cols: int):
    """Pack pre-columnized 1-D submission arrays into dense ``[D, B]``
    chunks (host-side, vectorized numpy).

    Copied from fluidframework_tpu/ops/sequencer_kernel.py:256-315.
    Inputs are six equal-length 1-D arrays, one entry per submission in
    stream order. A submission's column is its rank within its
    document (a stable argsort and a running count keep per-document
    order equal to record order); documents with more than `max_cols`
    submissions spill into further chunks (the boxcar-abort tracker
    threads across them). B is the smallest power of two >= 8 that
    holds the chunk's deepest document.

    Yields ``(sel, sl, ic, kind2, client2, cseq2, ref2, grp2)`` per
    chunk: `sel` indexes the original arrays (slice or bool mask),
    ``[sl, ic]`` gathers that chunk's verdicts out of the ``[D, B]``
    result, and the five dense int32 arrays are the `SeqBatch` and
    groups input."""
    slot = np.asarray(slot, np.int64)
    n = slot.shape[0]
    if n == 0:
        return
    kind = np.asarray(kind)
    client = np.asarray(client)
    client_seq = np.asarray(client_seq)
    ref_seq = np.asarray(ref_seq)
    groups = np.asarray(groups)
    ar = np.arange(n)
    order = np.argsort(slot, kind="stable")
    ss = slot[order]
    first = np.empty(n, bool)
    first[0] = True
    first[1:] = ss[1:] != ss[:-1]
    col_sorted = ar - np.maximum.accumulate(np.where(first, ar, 0))
    col = np.empty(n, np.int64)
    col[order] = col_sorted
    n_chunks = int(col.max()) // max_cols + 1
    for k in range(n_chunks):
        if n_chunks == 1:
            sel = slice(None)
            sl, ic = slot, col
        else:
            sel = (col // max_cols) == k
            sl, ic = slot[sel], col[sel] - k * max_cols
        b = 8
        top = int(ic.max()) + 1
        while b < top:
            b <<= 1
        kind2 = np.full((n_docs, b), SUB_PAD, np.int32)
        client2 = np.zeros((n_docs, b), np.int32)
        cseq2 = np.zeros((n_docs, b), np.int32)
        ref2 = np.zeros((n_docs, b), np.int32)
        grp2 = np.full((n_docs, b), NO_GROUP, np.int32)
        kind2[sl, ic] = kind[sel]
        client2[sl, ic] = client[sel]
        cseq2[sl, ic] = client_seq[sel]
        ref2[sl, ic] = ref_seq[sel]
        grp2[sl, ic] = groups[sel]
        yield sel, sl, ic, kind2, client2, cseq2, ref2, grp2


# ----------------------------------------------------------------------
# The plain PyTorch version.


def _step_one_doc_ref(state: SequencerState, aborted: torch.Tensor,
                      kind, client, client_seq, ref_seq, group,
                      dedup: bool = False):
    """One submission for every document at once: the JAX
    `_step_one_doc` (ops/sequencer_kernel.py:123-228) with its vmap
    written out as a leading ``[D]`` axis. Returns (state, aborted,
    SeqResult of ``[D]`` columns)."""
    D, C = state.connected.shape
    dev = state.seq.device
    slot = client.clamp(0, C - 1).long()
    rows = torch.arange(D, device=dev)
    onehot = torch.arange(C, device=dev)[None, :] == slot[:, None]

    is_join = kind == SUB_JOIN
    is_leave = kind == SUB_LEAVE
    is_sys = kind == SUB_SYSTEM

    known = state.connected[rows, slot]
    last_cseq = state.client_seq[rows, slot]
    in_box = group >= 0
    box_dead = in_box & (group == aborted)
    if dedup:
        dup = (kind == SUB_OP) & known & (client_seq <= last_cseq)
    else:
        dup = torch.zeros_like(box_dead)
    skipped = box_dead | dup
    is_op = (kind == SUB_OP) & ~skipped

    # Validation ladder, first failing rule wins: unknown -> stale ->
    # future -> gap (built from the last rule up).
    nack = torch.where(is_op & (client_seq != last_cseq + 1),
                       NACK_OUT_OF_ORDER, ACCEPT).to(I32)
    nack = torch.where(is_op & (ref_seq > state.seq), NACK_FUTURE_REFSEQ,
                       nack)
    nack = torch.where(is_op & (ref_seq < state.min_seq), NACK_STALE_REFSEQ,
                       nack)
    nack = torch.where(is_op & ~known, NACK_UNKNOWN_CLIENT, nack)

    ok_op = is_op & (nack == ACCEPT)
    live = ~box_dead
    do_join = is_join & live
    ok_leave = is_leave & known & live  # unknown leave stamps nothing
    do_sys = is_sys & live
    stamped = ok_op | do_join | ok_leave | do_sys
    new_seq = state.seq + stamped.to(I32)

    # Client-table updates (system stamps bypass the table).
    connected = torch.where(
        onehot & do_join[:, None], True,
        torch.where(onehot & ok_leave[:, None], False, state.connected))
    # A join admits at ref_seq = head seq *before* its own stamp.
    new_ref = torch.where(do_join, state.seq, ref_seq)
    ref_row = torch.where(onehot & (ok_op | do_join)[:, None],
                          new_ref[:, None], state.ref_seq)
    cseq_row = torch.where(
        onehot & do_join[:, None], 0,
        torch.where(onehot & ok_op[:, None], client_seq[:, None],
                    state.client_seq)).to(I32)

    # MSN: min over connected clients' refSeqs; an empty set trails the
    # head; monotone; recomputed only when a message is stamped.
    masked = torch.where(connected, ref_row, INT32_MAX)
    any_conn = connected.any(dim=1)
    candidate = torch.where(any_conn, masked.min(dim=1).values, new_seq)
    new_min = torch.where(stamped, torch.maximum(state.min_seq, candidate),
                          state.min_seq)

    # A nack aborts the rest of its boxcar.
    new_aborted = torch.where(in_box & (nack != ACCEPT), group, aborted)

    out = SeqResult(seq=torch.where(stamped, new_seq, 0).to(I32),
                    min_seq=new_min, nack=nack, skipped=skipped)
    return (SequencerState(new_seq, new_min, connected, ref_row, cseq_row),
            new_aborted, out)


def sequence_batch_ref(state: SequencerState, aborted: torch.Tensor,
                       batch: SeqBatch, groups: torch.Tensor,
                       dedup: bool = False):
    """The plain version of one chunk: `_step_one_doc_ref` over the B
    columns in order (the JAX `lax.scan`). CPU tensors only. Returns
    (state, aborted, SeqResult[D, B])."""
    if state.seq.device.type != "cpu":
        raise ValueError("sequence_batch_ref takes CPU tensors only; "
                         f"got {state.seq.device}")
    cols = []
    for b in range(batch.kind.shape[1]):
        state, aborted, out = _step_one_doc_ref(
            state, aborted, batch.kind[:, b], batch.client[:, b],
            batch.client_seq[:, b], batch.ref_seq[:, b], groups[:, b],
            dedup)
        cols.append(out)
    return state, aborted, SeqResult(
        *(torch.stack([getattr(c, f) for c in cols], dim=1)
          for f in SeqResult._fields))


# ----------------------------------------------------------------------
# The CUDA kernel's wrapper.

WARPS_PER_BLOCK = 4  # documents per block; must match the .cu file
SMEM_DEFAULT = 48 * 1024  # shared bytes a block takes without opt-in
SMEM_OPTIN = 232448  # an H100 block's opt-in dynamic shared memory
LAYOUTS = ("shared", "global")


def row_bytes(C: int) -> int:
    """Shared bytes of one document's row in the shared layout: C
    refSeqs, C clientSeqs and C connected bytes, padded to 16."""
    return (9 * C + 15) // 16 * 16


def alloc_result(D: int, B: int, device) -> Tuple[torch.Tensor, SeqResult]:
    """One flat buffer for a chunk's verdicts and the `SeqResult` views
    into it (seq, min_seq, nack as int32 planes, then skipped as
    bytes), so that the verdicts come back to the host in one copy
    (`read_result`)."""
    n = D * B
    buf = torch.empty(3 * n + (n + 3) // 4, dtype=I32, device=device)
    planes = buf[:3 * n].view(3, D, B)
    skipped = buf[3 * n:].view(torch.uint8)[:n].view(torch.bool).view(D, B)
    return buf, SeqResult(planes[0], planes[1], planes[2], skipped)


def read_result(buf: torch.Tensor, D: int, B: int) -> SeqResult:
    """The verdicts of an `alloc_result` buffer as numpy arrays (one
    device-to-host copy)."""
    return decode_result(buf.cpu().numpy(), D, B)


def decode_result(host: np.ndarray, D: int, B: int) -> SeqResult:
    """The verdicts of an `alloc_result` buffer already on the host."""
    n = D * B
    planes = host[:3 * n].reshape(3, D, B)
    skipped = host[3 * n:].view(np.uint8)[:n].view(bool).reshape(D, B)
    return SeqResult(planes[0], planes[1], planes[2], skipped)


class SequencerStepKernel:
    """Launches ``csrc/sequencer_step.cu`` for one ``[D, B]`` chunk.

    Replaces the JAX package's `_step_one_doc` under the
    `_sequence_batch_impl` scan (fluidframework_tpu/ops/
    sequencer_kernel.py:123 and :231), an XLA scan rather than a Pallas
    kernel. ``launches`` counts the kernel launches this wrapper made;
    it is incremented where the kernel is launched and nowhere else.
    The wrapper checks device, dtype, shape and contiguity, allocates
    the new state, the new abort tracker and (unless `out` is given)
    the verdicts, launches on PyTorch's current stream without
    synchronising, and raises if the launch was refused: there is no
    fallback. `plan` picks the layout: each document's row in shared
    memory when four rows fit a block's default 48 KB (C <= 1024), else
    the row worked on in place in the new state (global layout). Every
    C, D and B the reference takes runs; `layout` forces one of the two
    (a shared row above the opt-in limit is refused), so that
    chip_smoke.py phase 17 checks and times both on the same chunks
    (PERF.md records the gap that keeps the shared layout)."""

    name = "sequencer_step"
    source = "fluidframework_tpu_torch/csrc/sequencer_step.cu"
    replaces = ("fluidframework_tpu/ops/sequencer_kernel.py::_step_one_doc "
                "(+ _sequence_batch_impl scan)")

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = _build.load(self.name)
            fn = lib.sequencer_step_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 7 + [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
            self._fn = fn
        return self._fn

    @staticmethod
    def plan(C: int, layout: Optional[str] = None) -> str:
        if layout is not None:
            if layout not in LAYOUTS:
                raise ValueError(
                    f"layout must be one of {LAYOUTS}; got {layout!r}")
            if layout == "shared" and \
                    WARPS_PER_BLOCK * row_bytes(C) > SMEM_OPTIN:
                raise ValueError(
                    f"a shared-layout block of C {C} needs "
                    f"{WARPS_PER_BLOCK * row_bytes(C)} bytes, above "
                    f"{SMEM_OPTIN}")
            return layout
        if WARPS_PER_BLOCK * row_bytes(C) <= SMEM_DEFAULT:
            return "shared"
        return "global"

    def __call__(self, state: SequencerState, aborted: torch.Tensor,
                 batch: SeqBatch, groups: torch.Tensor, dedup: bool = False,
                 out: Optional[SeqResult] = None,
                 layout: Optional[str] = None):
        dev = state.seq.device
        if dev.type != "cuda":
            raise ValueError(
                f"the sequencer CUDA kernel needs CUDA tensors, got {dev}")
        D, C = state.connected.shape
        B = batch.kind.shape[1] if batch.kind.dim() == 2 else -1
        if D < 1 or C < 1 or B < 1:
            raise ValueError(f"sequencer kernel: empty shape D {D} C {C} B {B}")
        if out is None:
            _, out = alloc_result(D, B, dev)
        ins = [*state, aborted, *batch, groups]
        shapes = ([(D,), (D,), (D, C), (D, C), (D, C), (D,)]
                  + [(D, B)] * 5)
        dtypes = [I32, I32, torch.bool, I32, I32, I32] + [I32] * 5
        for t, shape, dt in zip(ins, shapes, dtypes):
            if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
                raise ValueError(
                    f"sequencer kernel: got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device} where {dt} {shape} on {dev} was expected")
        for t, dt in zip(out, (I32, I32, I32, torch.bool)):
            if (t.device != dev or t.dtype != dt or tuple(t.shape) != (D, B)
                    or not t.is_contiguous()):
                raise ValueError("sequencer kernel: bad verdict buffer")
        ins = [t.contiguous() for t in ins]
        new_state = SequencerState(*(torch.empty_like(t) for t in ins[:5]))
        new_aborted = torch.empty_like(ins[5])
        lay = LAYOUTS.index(self.plan(C, layout))
        ptrs = ins + list(new_state) + [new_aborted] + list(out)
        _build.launch(self.name, self._entry(), dev,
                      (D, B, C, int(bool(dedup)), lay), ptrs)
        self.launches += 1
        return new_state, new_aborted, out


sequencer_step_kernel = SequencerStepKernel()


def _run(state, aborted, batch, groups, dedup, out=None):
    kind = state.seq.device.type
    if kind == "cuda":
        return sequencer_step_kernel(state, aborted, batch, groups, dedup,
                                     out=out)
    if kind == "cpu":
        new_state, new_aborted, res = sequence_batch_ref(
            state, aborted, batch, groups, dedup)
        if out is None:
            return new_state, new_aborted, res
        for dst, src in zip(out, res):
            dst.copy_(src)
        return new_state, new_aborted, out
    raise ValueError(f"sequence_batch: unsupported device {kind}")


def sequence_batch(state: SequencerState, batch: SeqBatch, groups=None,
                   dedup: bool = False):
    """Sequence a [D, B] submission batch from a fresh abort tracker.
    `groups` (int32[D, B], optional) assigns submissions to atomic
    boxcars (NO_GROUP = standalone); `dedup` drops resubmissions
    silently. Returns (new_state, SeqResult[D, B])."""
    if groups is None:
        groups = torch.full(batch.kind.shape, NO_GROUP, dtype=I32,
                            device=batch.kind.device)
    aborted = torch.full((state.seq.shape[0],), NO_ABORT, dtype=I32,
                         device=state.seq.device)
    new_state, _, out = _run(state, aborted, batch, groups, dedup)
    return new_state, out


def sequence_batch_grouped(state: SequencerState, batch: SeqBatch, groups,
                           dedup: bool = False, aborted=None,
                           out: Optional[SeqResult] = None):
    """The live deli's entry: boxcar groups and optional dedup.
    `aborted` (from `no_aborts` or a previous chunk's return) threads
    the abort tracker across the chunks of one pump, so boxcars may
    span chunk boundaries (group ids unique per doc per pump). `out`
    takes preallocated verdict tensors (`alloc_result`). Returns
    (new_state, new_aborted, SeqResult)."""
    if aborted is None:
        aborted = torch.full((state.seq.shape[0],), NO_ABORT, dtype=I32,
                             device=state.seq.device)
    return _run(state, aborted, batch, groups, dedup, out)


_SHARDED_FN_CACHE: dict = {}


def sharded_sequence_fn(mesh, dedup: bool = False, axis: str = "docs"):
    """The grouped sequencer over a pool whose document rows are split
    over `mesh` (a `parallel.mesh.DocsMesh`).

    Counterpart of fluidframework_tpu/ops/sequencer_kernel.py:365.
    Verdicts, boxcar aborts and resubmission dedup are all per-document
    state, so each entry sequences its own slab of rows and no
    collective runs: one launch of ``csrc/sequencer_step.cu`` per entry
    slab per chunk on the card (the plain version on CPU entries), on
    the entry's stream.

    Returns ``fn(state, aborted, batch, groups, out=None) -> (state',
    aborted', results)`` over lists with one slab per entry, on its
    entry: the states and abort trackers (``D / mesh.size`` rows each;
    the tracker is per slab, threaded across a pump's chunks by the
    caller as in the single-device path), the `SeqBatch`es and groups
    of the chunk's rows, and optional verdict buffers (`alloc_result`).
    The results are per-entry `SeqResult`s. Cached per (mesh, dedup,
    axis)."""
    key = (mesh, bool(dedup), axis)
    fn = _SHARDED_FN_CACHE.get(key)
    if fn is not None:
        return fn

    def fn(state, aborted, batch, groups, out=None):
        n = mesh.size
        if len(state) != n or len(aborted) != n:
            raise ValueError(f"sharded sequencer: {len(state)} state slabs "
                             f"and {len(aborted)} trackers for a mesh of {n}")
        new_state, new_aborted, results = [], [], []
        with mesh.parallel():
            for i in range(n):
                with mesh.on(i):
                    s2, a2, r2 = _run(state[i], aborted[i], batch[i],
                                      groups[i], dedup,
                                      None if out is None else out[i])
                new_state.append(s2)
                new_aborted.append(a2)
                results.append(r2)
        return new_state, new_aborted, results

    _SHARDED_FN_CACHE[key] = fn
    return fn
