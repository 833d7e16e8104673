"""The row-model merge-tree chunk kernel on PyTorch.

Counterpart of fluidframework_tpu/ops/mergetree_pallas.py: a chunk of
B sequenced insert/remove/annotate ops applied in order to the full
segment table (rows in document order, ``[0, n_rows)`` live). Per op:
a boundary split at pos1; one merged structural pass that does the
pos2 split of a range op or the landing shift of an insert; then the
covered-range removal (first free remover slot) or last-writer-wins
annotate; sticky ``ERR_*`` flags in the error word.

- `apply_chunk_ref` is the plain PyTorch version: the Pallas kernel's
  vector body (mergetree_pallas.py:125-358) translated literally over
  the whole capacity, with the same masks (``torch.cumsum`` for
  `_cumsum_excl`, ``torch.sum`` for `_allreduce_sum`, ``torch.roll``
  for `_roll1_flat`).
- `MergetreeChunkKernel` launches the hand-written CUDA kernel
  ``csrc/mergetree_chunk.cu``.
- `apply_chunk` sends a CUDA table to the kernel (or raises) and a CPU
  table to the plain version; no other device is taken.

One deliberate difference from the Pallas kernel: an insert that finds
no landing row in a FULL table (every row live; the insert at the
document's end, or inside the last row, whose split tail falls off the
end) raises ``ERR_CAPACITY`` here, as the scan kernel
`mergetree_kernel._apply_one` does, where the Pallas kernel drops the
insert without a flag (its landing boundary is "the first non-live
row", and a full table has none). The table and ``n_rows`` stay what
the Pallas kernel gives (the insert is not applied).

Rows at and above ``n_rows`` of a result are scratch: the plain
version rolls the whole capacity as the Pallas kernel does, the CUDA
kernel leaves them alone, and nothing reads them (the compaction masks
rows ``>= n_rows``). Compare results on ``n_rows``, ``error`` and rows
``[:n_rows]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .mergetree_kernel import (
    ERR_BAD_POS,
    ERR_CAPACITY,
    ERR_REMOVERS,
    NO_CLIENT,
    NO_KEY,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
    OpBatch,
    SegmentTable,
)

I32 = torch.int32
ROW_ALIGN = 1024  # the Pallas kernel's (8, 128) tiling; the CUDA kernel's int4 rows


def _check_geometry(table: SegmentTable, ops: OpBatch) -> None:
    if table.length.shape[0] % ROW_ALIGN:
        raise ValueError(f"capacity must be a multiple of {ROW_ALIGN}")
    if table.rem_clients.shape[1] < 1:
        raise ValueError("the table needs at least one remover slot")
    if ops.prop_keys.shape[0] != ops.pos1.shape[0]:
        raise ValueError("prop_keys must be [B, PK]")


def _insert_props(keys, vals, kk: int):
    """The props row of an inserted segment: a later key slot wins,
    and PROP_DELETE becomes PROP_ABSENT (mergetree_pallas.py:291-298)."""
    row = [PROP_ABSENT] * kk
    for key, val in zip(keys, vals):
        if 0 <= key < kk:
            row[key] = PROP_ABSENT if val == PROP_DELETE else val
    return row


# ----------------------------------------------------------------------
# The plain PyTorch version.


def apply_chunk_ref(table: SegmentTable, ops: OpBatch) -> SegmentTable:
    """Apply a chunk of sequenced ops (ascending seq order), one after
    another, in plain PyTorch: the Pallas `_mergetree_chunk_kernel`
    body over a stacked ``[5+KR+KK, C]`` table and a live mask. Op
    scalars are Python ints and the flag decisions read one bool per
    op, so this version is for the CPU tests and for holding the CUDA
    kernel to, not for speed. NOOP ops are skipped: every mask of the
    Pallas body is empty for them."""
    _check_geometry(table, ops)
    dev = table.length.device
    C = table.length.shape[0]
    KR = table.rem_clients.shape[1]
    KK = table.props.shape[1]
    BUF, LEN, ISEQ, ICL, RSEQ = range(5)
    RC0, PP0 = 5, 5 + KR

    T = torch.cat([
        torch.stack([table.buf_start, table.length, table.ins_seq,
                     table.ins_client, table.rem_seq]),
        table.rem_clients.t(), table.props.t(),
    ]).to(I32).contiguous()
    flat = torch.arange(C, dtype=I32, device=dev)
    last = flat == C - 1
    live = flat < table.n_rows
    err = int(table.error)

    def cumsum_excl(v: torch.Tensor) -> torch.Tensor:
        return torch.cumsum(v, 0, dtype=I32) - v

    def roll1(v: torch.Tensor) -> torch.Tensor:
        return torch.roll(v, 1, -1)

    def visibility(ref_seq: int, client: int):
        rseq = T[RSEQ]
        removed = rseq != NOT_REMOVED
        tomb = removed & (rseq <= ref_seq)
        ins_vis = (T[ICL] == client) | (T[ISEQ] <= ref_seq)
        among = (T[RC0:PP0] == client).any(0)
        skip = (~live) | tomb | (removed & ~ins_vis)
        visible = (~skip) & ins_vis & ~(removed & among)
        return skip, torch.where(visible, T[LEN], 0)

    def shift_cols(keep: torch.Tensor) -> None:
        nonlocal live, err
        if bool((last & live & ~keep).any()):
            err |= ERR_CAPACITY
        T.copy_(torch.where(keep, T, roll1(T)))
        live = torch.where(keep, live, roll1(live))

    def split_fixup(keep, prefix, pos, inside):
        at = (~keep) & roll1(keep) & (flat > 0)
        off = pos - roll1(prefix)
        T[BUF] = torch.where(at, T[BUF] + off, T[BUF])
        T[LEN] = torch.where(at, T[LEN] - off, T[LEN])
        T[LEN] = torch.where(inside > 0, pos - prefix, T[LEN])

    def split_at(pos: int, ref_seq: int, client: int) -> None:
        skip, vis = visibility(ref_seq, client)
        prefix = cumsum_excl(vis)
        inside = ((~skip) & (prefix < pos) & (prefix + vis > pos)).to(I32)
        keep = cumsum_excl(inside) == 0
        shift_cols(keep)
        split_fixup(keep, prefix, pos, inside)

    cols = [getattr(ops, n).tolist() for n in (
        "op_type", "pos1", "pos2", "seq", "ref_seq", "client",
        "buf_start", "ins_len")]
    pkeys = ops.prop_keys.tolist()
    pvals = ops.prop_vals.tolist()

    for i in range(ops.pos1.shape[0]):
        otype, pos1, pos2, oseq, orefseq, oclient, obuf, oilen = (
            c[i] for c in cols)
        is_ins = otype == OP_INSERT
        is_range = otype in (OP_REMOVE, OP_ANNOTATE)
        if not (is_ins or is_range):
            continue

        split_at(pos1, orefseq, oclient)

        # The merged structural pass: the pos2 split of a range op or
        # the insert's landing shift (one suffix shift either way).
        skip, vis = visibility(orefseq, oclient)
        prefix = cumsum_excl(vis)
        live_pre = live
        if is_range:
            inside2 = ((~skip) & (prefix < pos2)
                       & (prefix + vis > pos2)).to(I32)
            keep = cumsum_excl(inside2) == 0
            shift_cols(keep)
            split_fixup(keep, prefix, pos2, inside2)
        else:
            total = int(torch.sum(vis, dtype=I32))
            land = ((~skip) & (prefix >= pos1)
                    & ((vis > 0) | (oseq > T[ISEQ]))) | ~live_pre
            landi = land.to(I32)
            open_excl = cumsum_excl(landi)
            ft = land & (open_excl == 0)
            if not bool(ft.any()):
                # A full table and no live landing row: the insert
                # would open row C (see the module docstring).
                err |= ERR_CAPACITY
            shift_cols((open_excl + landi) == 0)
            if total < pos1 and bool((ft & ~live_pre).any()):
                err |= ERR_BAD_POS
            new_row = [obuf, oilen, oseq, oclient, NOT_REMOVED]
            new_row += [NO_CLIENT] * KR
            new_row += _insert_props(pkeys[i], pvals[i], KK)
            T.copy_(torch.where(
                ft, torch.tensor(new_row, dtype=I32, device=dev)[:, None], T))
            live = live | ft
            continue

        # Covered-range updates, visibility recomputed after the shifts.
        skip, vis = visibility(orefseq, oclient)
        prefix = cumsum_excl(vis)
        covered = ((~skip) & (vis > 0) & (prefix >= pos1)
                   & (prefix + vis <= pos2))
        if int(torch.sum(vis, dtype=I32)) < pos2:
            err |= ERR_BAD_POS
        if otype == OP_REMOVE:
            # Earliest sequenced rem_seq wins; the removing client goes
            # to the first free slot.
            already = T[RSEQ] != NOT_REMOVED
            T[RSEQ] = torch.where(covered & ~already, oseq, T[RSEQ])
            rcl = T[RC0:PP0]
            iota_k = torch.arange(KR, dtype=I32, device=dev)[:, None]
            first_free = torch.where(rcl == NO_CLIENT, iota_k, KR).amin(0)
            no_free = first_free == KR
            slot = torch.where(already, first_free, 0)
            write = covered & ~(already & no_free)
            T[RC0:PP0] = torch.where(
                write[None] & (iota_k == slot[None]), oclient, rcl)
            if bool((covered & already & no_free).any()):
                err |= ERR_REMOVERS
        else:
            # Last writer wins, PROP_DELETE clears.
            for key, val in zip(pkeys[i], pvals[i]):
                if key == NO_KEY or not 0 <= key < KK:
                    continue
                newv = PROP_ABSENT if val == PROP_DELETE else val
                T[PP0 + key] = torch.where(covered, newv, T[PP0 + key])

    def scalar(v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=I32, device=dev)

    return SegmentTable(
        n_rows=torch.sum(live, dtype=I32),
        buf_start=T[BUF].clone(), length=T[LEN].clone(),
        ins_seq=T[ISEQ].clone(), ins_client=T[ICL].clone(),
        rem_seq=T[RSEQ].clone(),
        rem_clients=T[RC0:PP0].t().contiguous(),
        props=T[PP0:].t().contiguous(),
        error=scalar(err),
    )


# ----------------------------------------------------------------------
# The CUDA kernel's wrapper.


class MergetreeChunkKernel:
    """Launches ``csrc/mergetree_chunk.cu`` for one chunk of ops.

    Replaces the Pallas `_mergetree_chunk_kernel`
    (fluidframework_tpu/ops/mergetree_pallas.py:125). ``launches``
    counts the kernel launches this wrapper made; it is incremented
    where the kernel is launched and nowhere else. The wrapper checks
    device, dtype, shape, contiguity and capacity, allocates the output
    table, launches on PyTorch's current stream without synchronising,
    and raises if the launch was refused. Rows ``>= n_rows`` of the
    output are scratch (see the module docstring).
    """

    name = "mergetree_chunk"
    source = "fluidframework_tpu_torch/csrc/mergetree_chunk.cu"
    replaces = "fluidframework_tpu/ops/mergetree_pallas.py:125"

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = _build.load(self.name)
            fn = lib.mergetree_chunk_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 7 + [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def __call__(self, table: SegmentTable, ops: OpBatch) -> SegmentTable:
        _check_geometry(table, ops)
        dev = table.length.device
        if dev.type != "cuda":
            raise ValueError(
                f"the mergetree CUDA kernel needs CUDA tensors, got {dev}")
        C = table.length.shape[0]
        KR = table.rem_clients.shape[1]
        KK = table.props.shape[1]
        B, PK = ops.prop_keys.shape
        ins = [table.n_rows, table.error, table.buf_start, table.length,
               table.ins_seq, table.ins_client, table.rem_seq,
               table.rem_clients, table.props,
               ops.op_type, ops.pos1, ops.pos2, ops.seq, ops.ref_seq,
               ops.client, ops.buf_start, ops.ins_len, ops.prop_keys,
               ops.prop_vals]
        for t in ins:
            if t.device != dev or t.dtype != I32:
                raise ValueError(
                    "mergetree kernel inputs must be int32 tensors on "
                    f"{dev}; got {t.dtype} on {t.device}")
        ins = [t.contiguous() for t in ins]
        shapes = ([()] * 2 + [(C,)] * 5 + [(C, KR), (C, KK)]
                  + [(B,)] * 8 + [(B, PK)] * 2)
        for t, shape in zip(ins, shapes):
            if tuple(t.shape) != shape:
                raise ValueError(f"mergetree kernel: shape {tuple(t.shape)} "
                                 f"where {shape} was expected")
        out = SegmentTable(
            n_rows=torch.empty((), dtype=I32, device=dev),
            buf_start=torch.empty_like(ins[2]),
            length=torch.empty_like(ins[3]),
            ins_seq=torch.empty_like(ins[4]),
            ins_client=torch.empty_like(ins[5]),
            rem_seq=torch.empty_like(ins[6]),
            rem_clients=torch.empty_like(ins[7]),
            props=torch.empty_like(ins[8]),
            error=torch.empty((), dtype=I32, device=dev),
        )
        outs = [out.buf_start, out.length, out.ins_seq, out.ins_client,
                out.rem_seq, out.rem_clients, out.props, out.n_rows,
                out.error]
        _build.launch(self.name, self._entry(), dev, (C, KR, KK, B, PK),
                      ins + outs)
        self.launches += 1
        return out


mergetree_chunk_kernel = MergetreeChunkKernel()


def apply_chunk(table: SegmentTable, ops: OpBatch) -> SegmentTable:
    """Apply a chunk of sequenced ops (ascending seq order) to the
    table. A CUDA table goes to the hand-written kernel (or raises); a
    CPU table to the plain version. Equal on ``n_rows``, ``error`` and
    rows ``[:n_rows]`` to the JAX `mergetree_pallas.apply_chunk`, but
    for the full-table end insert (module docstring)."""
    kind = table.length.device.type
    if kind == "cuda":
        return mergetree_chunk_kernel(table, ops)
    if kind == "cpu":
        return apply_chunk_ref(table, ops)
    raise ValueError(f"apply_chunk: unsupported device {kind}")


def apply_chunk_at(table: SegmentTable, stream_ops: OpBatch, lo: int,
                   chunk: int) -> SegmentTable:
    """Apply ops ``[lo, lo+chunk)`` of a device-resident op stream: the
    chunk is a view (no copy, no host transfer). As JAX's
    ``dynamic_slice`` does, a start past the end is clamped so that
    the chunk fits."""
    lo = max(0, min(lo, stream_ops.pos1.shape[0] - chunk))
    return apply_chunk(table, stream_ops.slice(lo, lo + chunk))
