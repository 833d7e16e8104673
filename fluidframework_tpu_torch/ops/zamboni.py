"""Device-side compaction ops: the stable partition and the zamboni.

Counterparts in fluidframework_tpu/ops/zamboni.py:

- `pack_partition` of `_pack_partition` (line 129). The JAX version is
  built from log-shift masked rolls because a gather is slow on the
  TPU; here the destination of every row comes straight from two int32
  prefix sums and one scatter moves all columns (of every document,
  given a leading docs axis). The result is
  bit-identical: both place kept rows at the front and dropped rows at
  the back, each group in its original order. It is also exactly the
  JAX `_pack_sort` (line 123) on a 0/1 key, which is how
  `compact_gather_text` uses it.
- `compact_gather_text_ref` of `compact_gather_text` (line 185): the
  row-model replay's full compaction with the text re-gather, in int32
  tensor ops with no host sync, bit-identical to the JAX function. The
  dispatcher `compact_gather_text` sends a CUDA table to the
  hand-written kernel ``csrc/zamboni.cu`` (`ops/zamboni_kernel.py`,
  one launch) or raises, and a CPU table to the plain version. The
  chunk path of `core/columnar_replay.py` runs it every `sync_interval`
  chunks.
- `zamboni_device_ref` of `zamboni_device` (line 42): the compaction
  without the text re-gather (tombstones removed at or below the MSN
  dropped, settled neighbours merged where their text is contiguous in
  the arena), in int32 tensor ops with no host sync. The dispatcher
  `zamboni_device` sends a CUDA table to the hand-written kernel
  ``csrc/zamboni.cu`` (`ops/zamboni_kernel.py`) or raises, and a CPU
  table to the plain version. No path of the reference calls
  `zamboni_device` (only its test does); the port's replays do not
  either.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..protocol.constants import NO_CLIENT
from .mergetree_kernel import NOT_REMOVED, PROP_ABSENT, SegmentTable

STREAM_BASE = 1 << 28  # stream-arena offsets start here (columnar_replay)
I32 = torch.int32


def pack_partition(
    drop: torch.Tensor, cols: Union[torch.Tensor, Sequence[torch.Tensor]]
) -> torch.Tensor:
    """Stable binary partition of ``cols`` (a [C, W] stack, or C
    tensors of [W]) by the bool mask ``drop``: rows with drop False
    pack to the front, dropped rows to the back, both in order.
    Returns the packed [C, W] stack. No host sync. With a leading docs
    axis (``drop`` [D, W], ``cols`` [D, C, W] or C tensors of [D, W])
    each document is partitioned on its own, in the same launches."""
    stack = cols if isinstance(cols, torch.Tensor) else torch.stack(
        list(cols), -2
    )
    di = drop.to(torch.int32)
    keep = 1 - di
    keep_rank = torch.cumsum(keep, -1, dtype=torch.int32) - keep
    drop_rank = torch.cumsum(di, -1, dtype=torch.int32) - di
    n_keep = torch.sum(keep, -1, keepdim=True, dtype=torch.int32)
    dest = torch.where(drop, n_keep + drop_rank, keep_rank).to(torch.int64)
    out = torch.empty_like(stack)
    if stack.dim() == 2:
        out.index_copy_(1, dest, stack)
    else:  # index_copy_ takes one index for all rows: scatter per document
        out.scatter_(-1, dest[..., None, :].expand(stack.shape), stack)
    return out


def _drop_tombstones(table: SegmentTable, min_seq):
    """The tombstone drop that both compactions start with: rows
    ``idx < n_rows`` are live (every row, when n_rows passes C); a live
    row survives unless it was removed at or below the MSN; a stable
    partition packs the survivors to the front. Returns ``(min_seq as
    an int32 tensor, idx, packed, valid, length)``: `packed` is the
    ``[5 + KR + KK, C]`` stack of the packed columns (buf_start,
    length, ins_seq, ins_client, rem_seq, the removers, the props),
    `valid` marks the packed survivors and `length` is their lengths,
    0 past them."""
    C = table.length.shape[0]
    dev = table.length.device
    min_seq = torch.as_tensor(min_seq, dtype=I32, device=dev)
    idx = torch.arange(C, dtype=I32, device=dev)
    live = idx < table.n_rows
    removed = table.rem_seq != NOT_REMOVED
    keep = live & ~(removed & (table.rem_seq <= min_seq))
    packed = pack_partition(~keep, torch.cat([
        torch.stack([table.buf_start, table.length, table.ins_seq,
                     table.ins_client, table.rem_seq]),
        table.rem_clients.t(), table.props.t(),
    ]))
    valid = idx < torch.sum(keep, dtype=I32)
    return min_seq, idx, packed, valid, torch.where(valid, packed[1], 0)


def compact_gather_text_ref(
    table: SegmentTable,
    min_seq,
    doc_arena: torch.Tensor,
    stream_text: torch.Tensor,
) -> Tuple[SegmentTable, torch.Tensor]:
    """Full compaction of a row-model table under applied MSN
    `min_seq`, with the text re-gather, in tensor ops with no host
    sync: the plain version of the ``compaction_launch`` entry of
    ``csrc/zamboni.cu``. Same result as the JAX `compact_gather_text`,
    table and arena both:

    1. tombstone drop: rows removed at or below the MSN go; a stable
       partition packs the survivors to the front;
    2. text move: every surviving span ``[buf, buf+len)`` lands at its
       new contiguous offset in a fresh doc arena. Per source region
       (the doc arena, then the stream text at STREAM_BASE) the
       per-element offset comes from +/-delta events at span
       boundaries (``index_add_``) and one cumsum; one ``index_copy_``
       moves the elements. JAX drops out-of-range scatter indices; here
       they go to one spare slot past the end, which is cut off;
    3. coalescing: settled neighbours (insert seq <= MSN, not removed)
       with equal props merge; a second stable partition packs the run
       starts to the front, and run lengths are differences of the new
       text offsets.

    The text move is a function of the table (and so equal to the
    kernel's text move: kept row k's destination ``[new_off, new_off +
    length)`` reads its span of the region its buf_start lies in, every
    other element 0) on tables whose surviving spans are disjoint and
    lie inside one region or in neither, with non-negative lengths
    summing to at most 2^31 - 1: every table the replay produces (its
    spans are disjoint pieces of the document's text). Elsewhere the
    result depends on the scatter order.

    Returns ``(table, new_doc_arena)``."""
    A = doc_arena.shape[0]
    S = stream_text.shape[0]
    KR = table.rem_clients.shape[1]
    KK = table.props.shape[1]
    dev = table.length.device

    # ---- 1. tombstone drop
    min_seq, idx, packed, valid, length = _drop_tombstones(table, min_seq)
    buf, _, iseq, iclient, rseq = packed[:5]
    rcl = packed[5:5 + KR]
    props = packed[5 + KR:]

    # ---- 2. text move
    new_off = torch.cumsum(length, 0, dtype=I32) - length
    total = torch.sum(length, dtype=I32)

    def sweep_region(region_len: int, base: int, arena_vals: torch.Tensor,
                     out: torch.Tensor) -> None:
        dead = A + region_len + 2
        in_region = valid & (buf >= base) & (buf < base + region_len)
        rbuf = buf - base
        delta = new_off - rbuf
        n_ev = region_len + 2

        def event_index(at: torch.Tensor) -> torch.Tensor:
            # JAX mode="drop": out-of-range indices land on the spare
            # slot n_ev, which is cut off below.
            at = torch.where(in_region, at, region_len + 1)
            ok = (at >= 0) & (at < n_ev)
            return torch.where(ok, at, n_ev).to(torch.int64)

        ev = torch.zeros(n_ev + 1, dtype=I32, device=dev)
        ev.index_add_(0, event_index(rbuf), delta - dead)
        ev.index_add_(0, event_index(rbuf + length), dead - delta)
        per_elem = dead + torch.cumsum(ev[:n_ev], 0, dtype=I32)[:region_len]
        dest = torch.arange(region_len, dtype=I32, device=dev) + per_elem
        ok = (dest >= 0) & (dest < A)
        out.index_copy_(0, torch.where(ok, dest, A).to(torch.int64),
                        arena_vals)

    new_arena = torch.zeros(A + 1, dtype=I32, device=dev)
    sweep_region(A, 0, doc_arena, new_arena)
    sweep_region(S, STREAM_BASE, stream_text, new_arena)
    new_arena = new_arena[:A]
    buf = new_off

    # ---- 3. maximal coalescing
    settled = valid & (rseq == NOT_REMOVED) & (iseq <= min_seq)
    prev_settled = torch.cat([settled.new_zeros(1), settled[:-1]])
    same_props = torch.cat([
        settled.new_zeros(1), (props[:, 1:] == props[:, :-1]).all(0)])
    start = valid & ~(settled & prev_settled & same_props)
    m = torch.sum(start, dtype=I32)
    packed2 = pack_partition(~start, torch.cat([
        torch.stack([buf, iseq, iclient, rseq]), rcl, props,
        new_off[None]]))
    fbuf, fiseq, ficlient, frseq = packed2[:4]
    frcl = packed2[4:4 + KR]
    fprops = packed2[4 + KR:4 + KR + KK]
    f_off = packed2[-1]
    final_valid = idx < m
    next_off = torch.cat([f_off[1:], f_off.new_zeros(1)])
    next_off = torch.where(idx == m - 1, total, next_off)
    run_len = torch.where(final_valid, next_off - f_off, 0)

    out = SegmentTable(
        n_rows=m,
        buf_start=torch.where(final_valid, fbuf, 0),
        length=run_len,
        ins_seq=torch.where(final_valid, fiseq, 0),
        ins_client=torch.where(final_valid, ficlient, NO_CLIENT),
        rem_seq=torch.where(final_valid, frseq, NOT_REMOVED),
        rem_clients=torch.where(
            final_valid[:, None], frcl.t(), NO_CLIENT).contiguous(),
        props=torch.where(
            final_valid[:, None], fprops.t(), PROP_ABSENT).contiguous(),
        error=table.error,
    )
    return out, new_arena


def zamboni_device_ref(table: SegmentTable, min_seq) -> SegmentTable:
    """Compact `table` under the applied MSN `min_seq` (an int or an
    int32 scalar tensor) without touching text: the plain version of
    ``csrc/zamboni.cu``, equal to the JAX `zamboni_device` on every row,
    ``n_rows`` and ``error``. No host sync.

    1. Rows ``idx < n_rows`` are live (every row, when n_rows passes
       C); a live row survives unless it was removed at or below the
       MSN. Survivors pack to the front in order.
    2. A packed row is settled when it is not removed and was inserted
       at or below the MSN. A settled row merges into the packed row
       before it when that row is settled too, their props are equal
       in every key, and the previous row's text ends where this row's
       starts (``buf_start + length``, int32). Each run keeps its first
       row's fields and the int32 sum of its rows' lengths.
    3. Rows at and above the run count ``m`` take the empty-row fills;
       ``n_rows`` is ``m``, ``error`` passes through."""
    C = table.length.shape[0]
    KR = table.rem_clients.shape[1]
    dev = table.length.device

    # ---- 1. tombstone drop (stable pack of the survivors)
    min_seq, idx, packed, valid, length = _drop_tombstones(table, min_seq)
    buf, _, iseq, _, rseq = packed[:5]

    # ---- 2. coalescing of settled runs contiguous in the arena
    settled = valid & (rseq == NOT_REMOVED) & (iseq <= min_seq)
    props = packed[5 + KR:]
    same_props = (props[:, 1:] == props[:, :-1]).all(0)
    contiguous = (buf + length)[:-1] == buf[1:]
    merge = torch.cat([settled.new_zeros(1),
                       settled[1:] & settled[:-1] & same_props & contiguous])
    start = valid & ~merge
    m = torch.sum(start, dtype=I32)
    run_id = torch.cumsum(start, 0, dtype=I32) - 1
    run_len = torch.zeros(C + 1, dtype=I32, device=dev)
    run_len.index_add_(0, torch.where(valid, run_id, C).to(torch.int64),
                       length)
    firsts = pack_partition(~start, packed)
    final = idx < m

    def take(row: torch.Tensor, fill: int) -> torch.Tensor:
        return torch.where(final, row, fill)

    def take2(rows: torch.Tensor, fill: int) -> torch.Tensor:
        return torch.where(final[:, None], rows.t(), fill).contiguous()

    return SegmentTable(
        n_rows=m,
        buf_start=take(firsts[0], 0),
        length=take(run_len[:C], 0),
        ins_seq=take(firsts[2], 0),
        ins_client=take(firsts[3], NO_CLIENT),
        rem_seq=take(firsts[4], NOT_REMOVED),
        rem_clients=take2(firsts[5:5 + KR], NO_CLIENT),
        props=take2(firsts[5 + KR:], PROP_ABSENT),
        error=table.error,
    )


def compact_gather_text(
    table: SegmentTable,
    min_seq,
    doc_arena: torch.Tensor,
    stream_text: torch.Tensor,
) -> Tuple[SegmentTable, torch.Tensor]:
    """`compact_gather_text_ref`'s compaction by the table's device: a
    CUDA table goes to the hand-written kernel (``compaction_launch`` of
    ``csrc/zamboni.cu``, or the call raises), a CPU table to the plain
    version; no other device is taken."""
    kind = table.length.device.type
    if kind == "cuda":
        from .zamboni_kernel import compaction_kernel

        return compaction_kernel(table, min_seq, doc_arena, stream_text)
    if kind == "cpu":
        return compact_gather_text_ref(table, min_seq, doc_arena,
                                       stream_text)
    raise ValueError(f"compact_gather_text: unsupported device {kind}")


def zamboni_device(table: SegmentTable, min_seq) -> SegmentTable:
    """`zamboni_device_ref`'s compaction by the table's device: a CUDA
    table goes to the hand-written kernel ``csrc/zamboni.cu`` (or the
    call raises), a CPU table to the plain version; no other device is
    taken."""
    kind = table.length.device.type
    if kind == "cuda":
        from .zamboni_kernel import zamboni_kernel

        return zamboni_kernel(table, min_seq)
    if kind == "cpu":
        return zamboni_device_ref(table, min_seq)
    raise ValueError(f"zamboni_device: unsupported device {kind}")
