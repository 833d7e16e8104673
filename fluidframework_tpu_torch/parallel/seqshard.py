"""Sequence-sharded overlay replay over a single-controller mesh.

Counterpart of fluidframework_tpu/parallel/seqshard.py: the executable
form of `parallel.seqshard_ref.SeqShardedOverlay` (the numpy spec, held
against the single-document overlay engine). ONE document's settled
coordinate space is split contiguously across the mesh's ``seq`` axis;
entry d holds shard d's settled slice and its overlay rows.

Per op, the only traffic between entries is small all-gathers
(`parallel.collectives`):

- each shard's (visible length, delta) at the op's perspective, whose
  exclusive prefix gives each shard its offset (the associative
  partial-lengths combine);
- insert landing: per-shard landing bits and target coordinates; the
  first landing shard (document order) wins, and the shard owning the
  target coordinate stores the row.

Range ops (remove / annotate) need no arbitration: every shard applies
its clipped local sub-range (splits, gap materialization, covered-row
updates are shard-local).

The JAX package compiles a ``lax.scan`` over the ops under
``shard_map``; here one process walks the ops. The op arrays are
replicated host data, so each op's kind is branched on in Python;
device values (landing bits, the winner, the target coordinate, a
range's clipped ends) stay on the device as masks, and ``lax.cond`` on
a device value becomes a masked select. No host sync happens inside
the replay, and CPU entries run the same masked code. This is an XLA
function in the reference, not
a Pallas kernel: plain torch ops carry it, on the CPU and on the card
alike, and every shard runs on the caller's stream (each op
all-gathers, so the entries could not run ahead of each other).

This build runs fold-free, as the reference's does: rows accumulate
and the window is the whole replay. States extract back into the numpy
spec for digest comparison (`run_sequence_sharded`).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..ops.mergetree_kernel import (
    ERR_BAD_POS,
    ERR_CAPACITY,
    ERR_REMOVERS,
    NOT_REMOVED,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    PROP_ABSENT,
    PROP_DELETE,
)
from ..ops.overlay_ref import SETTLED_BASE
from ..protocol.constants import NO_CLIENT
from ..utils.devices import DeviceLike, resolve_device
from . import collectives
from .mesh import DocsMesh

I32 = torch.int32

__all__ = [
    "ShardState",
    "make_shard_state",
    "run_sequence_sharded",
    "sequence_sharded_replay",
]


class ShardState(NamedTuple):
    """One sequence shard's overlay rows (capacity C) and settled len."""

    anchor: torch.Tensor  # [C] int32, local settled coordinate
    buf: torch.Tensor  # [C] int32, arena offset | SETTLED_BASE+coord
    length: torch.Tensor  # [C] int32
    iseq: torch.Tensor  # [C] int32
    iclient: torch.Tensor  # [C] int32
    rseq: torch.Tensor  # [C] int32
    rcl: torch.Tensor  # [C, KR] int32
    props: torch.Tensor  # [C, KK] int32
    n: torch.Tensor  # [] int32 live rows
    S: torch.Tensor  # [] int32 settled length (static: fold-free)
    error: torch.Tensor  # [] int32


def make_shard_state(settled_len: int, capacity: int, n_removers: int,
                     n_prop_keys: int, device: DeviceLike = None
                     ) -> ShardState:
    dev = resolve_device(device)
    C = capacity

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    return ShardState(
        anchor=full((C,), 0), buf=full((C,), 0), length=full((C,), 0),
        iseq=full((C,), 0), iclient=full((C,), 0),
        rseq=full((C,), NOT_REMOVED),
        rcl=full((C, n_removers), NO_CLIENT),
        props=full((C, n_prop_keys), PROP_ABSENT),
        n=full((), 0), S=full((), settled_len), error=full((), 0),
    )


def _i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=I32, device=dev)


def _at(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``a[j]`` for a device scalar index, with no host read."""
    return a.index_select(0, j.reshape(1).long())[0]


def _first(mask: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.argmax`` of a bool mask: the first True, 0 if none."""
    return torch.argmax(mask.to(I32), dim=dim).to(I32)


def _expand(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return mask[:, None] if a.dim() > 1 else mask


def _row_insert(st: ShardState, j, anchor, buf, length, iseq, iclient,
                rseq, rcl_row, props_row, do) -> ShardState:
    """Insert one row at local index j (rows at and after j shift
    right), masked by `do`. Capacity overflow raises the error bit."""
    C = st.anchor.shape[0]
    dev = st.anchor.device
    idx = torch.arange(C, dtype=I32, device=dev)
    full = st.n >= C
    overflow = do & full  # the error observes the unmasked intent
    do = do & ~full

    def shift(a, val):
        rolled = torch.roll(a, 1, 0)
        keep = _expand((idx < j) | ~do, a)
        at = _expand((idx == j) & do, a)
        return torch.where(keep, a, torch.where(at, _i32(val, dev), rolled))

    return ShardState(
        anchor=shift(st.anchor, anchor),
        buf=shift(st.buf, buf),
        length=shift(st.length, length),
        iseq=shift(st.iseq, iseq),
        iclient=shift(st.iclient, iclient),
        rseq=shift(st.rseq, rseq),
        rcl=shift(st.rcl, rcl_row),
        props=shift(st.props, props_row),
        n=st.n + do.to(I32),
        S=st.S,
        error=st.error | torch.where(overflow, ERR_CAPACITY, 0).to(I32),
    )


def _visibility(st: ShardState, ref_seq: int, client: int):
    C = st.anchor.shape[0]
    idx = torch.arange(C, dtype=I32, device=st.anchor.device)
    live = idx < st.n
    is_span = live & (st.buf >= SETTLED_BASE)
    consume = torch.where(is_span, st.length, 0)
    removed = live & (st.rseq != NOT_REMOVED)
    tomb = removed & (st.rseq <= ref_seq)
    ins_vis = (st.iclient == client) | (st.iseq <= ref_seq)
    among = (st.rcl == client).any(dim=1)
    skip = tomb | (removed & ~ins_vis)
    visible = live & ~skip & ins_vis & ~(removed & among)
    vis_len = torch.where(visible, st.length, 0)
    delta = torch.where(live, vis_len - consume, 0)
    cum = torch.cumsum(delta, 0, dtype=I32) - delta
    pre = st.anchor + cum
    return live, is_span, skip, vis_len, delta, pre


def _split(st: ShardState, q, ref_seq: int, client: int) -> ShardState:
    """Boundary split at local visible position q (no-op when no row
    strictly contains q)."""
    live, is_span, skip, vis, _, pre = _visibility(st, ref_seq, client)
    inside = live & ~skip & (pre < q) & (pre + vis > q)
    do = inside.any()
    j = _first(inside)
    off = q - _at(pre, j)
    tail_anchor = _at(st.anchor, j) + torch.where(_at(is_span, j), off, 0)
    st2 = _row_insert(
        st, j + 1, tail_anchor, _at(st.buf, j) + off,
        _at(st.length, j) - off, _at(st.iseq, j), _at(st.iclient, j),
        _at(st.rseq, j), _at(st.rcl, j), _at(st.props, j), do,
    )
    C = st.anchor.shape[0]
    rows = torch.arange(C, dtype=I32, device=st.anchor.device)
    new_len = torch.where((rows == j) & do, off, st2.length).to(I32)
    return st2._replace(length=new_len)


def _select(cond: torch.Tensor, a: ShardState, b: ShardState) -> ShardState:
    """``lax.cond(cond, ...)`` on a device value: a where cond, else b."""
    return ShardState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _partials(st: ShardState, ref_seq: int, client: int):
    _, _, _, _, delta, _ = _visibility(st, ref_seq, client)
    ds = torch.sum(delta, dtype=I32)
    return st.S + ds, ds


def _insert(shards: List[ShardState], op, kr: int, kk: int
            ) -> List[ShardState]:
    (_, pos1, _, seq, ref_seq, client, buf_start, ins_len, pk, pv) = op
    D = len(shards)
    devs = [st.anchor.device for st in shards]
    S_all = collectives.all_gather([st.S for st in shards])
    bases = torch.cumsum(S_all, 0, dtype=I32) - S_all
    S_total = torch.sum(S_all, dtype=I32)
    parts = [_partials(st, ref_seq, client) for st in shards]
    v_all = collectives.all_gather([v for v, _ in parts])
    d_all = collectives.all_gather([d for _, d in parts])
    off = torch.cumsum(v_all, 0, dtype=I32) - v_all
    lands, cands, js = [], [], []
    for r, st in enumerate(shards):
        q = pos1 - off.to(devs[r])[r]
        my_base = bases.to(devs[r])[r]
        st = shards[r] = _split(st, q, ref_seq, client)
        live, is_span, skip, vis, delta, pre = _visibility(
            st, ref_seq, client)
        land = live & ((pre > q) | ((pre == q) & ~skip
                                    & ((vis > 0) | (seq > st.iseq))))
        j = _first(land)
        js.append(j)
        lands.append(land.any())
        cands.append(_at(st.anchor, j) + my_base - (_at(pre, j) - q))
    land_all = collectives.all_gather(lands)
    c_all = collectives.all_gather(cands)
    exists = land_all.any()
    winner = _first(land_all)
    c_land = _at(c_all, winner)
    total = off[-1] + v_all[-1]
    delta_total = torch.sum(d_all, dtype=I32)
    c_append = torch.minimum(pos1 - delta_total, S_total)
    c_final = torch.where(exists, c_land, c_append)
    # The shard owning coordinate c_final (half-open; the last shard
    # owns its own end): searchsorted(bases[1:], c, "right").
    owner = torch.clamp(torch.sum(bases[1:] <= c_final, dtype=I32),
                        max=D - 1)
    winner_stores = exists & (c_land >= _at(bases, winner))
    storer = torch.where(winner_stores, winner, owner)
    err = torch.where(~exists & (pos1 > total), ERR_BAD_POS, 0).to(I32)
    props_row = np.full(kk, PROP_ABSENT, np.int32)
    if 0 <= pk < kk:
        props_row[pk] = PROP_ABSENT if pv == PROP_DELETE else pv
    rcl_row = np.full(kr, NO_CLIENT, np.int32)
    for r, st in enumerate(shards):
        dev = devs[r]
        g_storer, g_stores, g_winner, g_c, g_base, g_err = (
            t.to(dev) for t in (storer, winner_stores, winner, c_final,
                                bases[r], err))
        i_store = g_storer == r
        at_j = g_stores & (g_winner == r)
        local_pos = torch.where(at_j, js[r], st.n)
        local_anchor = torch.minimum(torch.clamp(g_c - g_base, min=0), st.S)
        st = _row_insert(
            st, local_pos, local_anchor, buf_start, ins_len, seq, client,
            NOT_REMOVED, torch.from_numpy(rcl_row).to(dev),
            torch.from_numpy(props_row).to(dev), i_store,
        )
        shards[r] = st._replace(error=st.error | g_err)
    return shards


def _gap_scatter(a: torch.Tensor, gap_vals, row_at: torch.Tensor,
                 gap_at: torch.Tensor) -> torch.Tensor:
    """The reference's two ``.at[...].set(..., mode="drop")``: old rows
    to `row_at`, the materialized gap rows to `gap_at`; an index of C or
    more is dropped (written to a spare row that is cut off)."""
    C = a.shape[0]
    out = torch.zeros((C + 1,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    gv = torch.broadcast_to(_i32(gap_vals, a.device), a.shape)
    out.index_put_((torch.clamp(row_at, max=C).long(),), a)
    out.index_put_((torch.clamp(gap_at, max=C).long(),), gv)
    return out[:C]


def _apply_local(st: ShardState, lo, hi, op, kr: int, kk: int
                 ) -> ShardState:
    (op_type, _, _, seq, ref_seq, client, _, _, pk, pv) = op
    st = _split(st, lo, ref_seq, client)
    st = _split(st, hi, ref_seq, client)
    C = st.anchor.shape[0]
    dev = st.anchor.device
    idx = torch.arange(C, dtype=I32, device=dev)
    live, is_span, skip, vis, delta, pre = _visibility(st, ref_seq, client)
    dsum = torch.sum(delta, dtype=I32)

    def coord_of(p):
        # Settled coordinate of a clipped range end.
        cand = live & (pre >= p)
        k = _first(cand)
        return torch.where(cand.any(), _at(st.anchor, k) - (_at(pre, k) - p),
                           p - dsum)

    c1 = coord_of(lo)
    c2 = coord_of(hi)
    # Gap materialization: gap k sits before row k (gap n is the tail up
    # to S). Materialized gaps become span rows via one scatter remap.
    consume = torch.where(is_span, st.length, 0)
    ends = st.anchor + consume
    prev_end = torch.where(idx == 0, 0, torch.roll(ends, 1))
    glo = torch.where(idx < st.n, prev_end, 0)
    ghi = torch.where(idx < st.n, st.anchor, 0)
    last_end = torch.where(st.n > 0,
                           _at(ends, torch.clamp(st.n - 1, min=0)), 0)
    glo = torch.where(idx == st.n, last_end, glo)
    ghi = torch.where(idx == st.n, st.S, ghi)
    in_gap = idx <= st.n
    mlo = torch.maximum(glo, c1)
    mhi = torch.minimum(ghi, c2)
    mat = in_gap & (mlo < mhi)
    n_mat = torch.sum(mat, dtype=I32)
    # Remap: old row i -> i + (# materialized gaps <= i).
    mat_incl = torch.cumsum(mat.to(I32), 0, dtype=I32)
    row_at = torch.where(idx < st.n, idx + mat_incl, C)
    gap_at = torch.where(mat, idx + mat_incl - 1, C)

    def scatter(a, gap_vals):
        return _gap_scatter(a, gap_vals, row_at, gap_at)

    overflow = st.n + n_mat > C
    st2 = ShardState(
        anchor=scatter(st.anchor, mlo),
        buf=scatter(st.buf, SETTLED_BASE + mlo),
        length=scatter(st.length, mhi - mlo),
        iseq=scatter(st.iseq, 0),
        iclient=scatter(st.iclient, NO_CLIENT),
        rseq=scatter(st.rseq, NOT_REMOVED),
        rcl=scatter(st.rcl, NO_CLIENT),
        props=scatter(st.props, PROP_ABSENT),
        n=torch.clamp(st.n + n_mat, max=C),
        S=st.S,
        error=st.error | torch.where(overflow, ERR_CAPACITY, 0).to(I32),
    )
    # Covered-row updates.
    live, is_span, skip, vis, delta, pre = _visibility(st2, ref_seq, client)
    covered = live & ~skip & (vis > 0) & (pre >= lo) & (pre + vis <= hi)
    if op_type == OP_REMOVE:
        already = st2.rseq != NOT_REMOVED
        new_rseq = torch.where(covered & ~already, seq, st2.rseq).to(I32)
        free = st2.rcl == NO_CLIENT
        first_free = _first(free, 1)
        no_free = ~free.any(dim=1)
        slot = torch.where(already, first_free, 0)
        write_rcl = covered & ~(already & no_free)
        kr_idx = torch.arange(kr, dtype=I32, device=dev)
        new_rcl = torch.where(
            write_rcl[:, None] & (kr_idx[None, :] == slot[:, None]),
            client, st2.rcl).to(I32)
        err2 = torch.where((covered & already & no_free).any(),
                           ERR_REMOVERS, 0).to(I32)
        return st2._replace(rseq=new_rseq, rcl=new_rcl,
                            error=st2.error | err2)
    # Annotate: last writer per key; deletes tombstone on spans and
    # clear on text rows.
    if not 0 <= pk < kk:
        return st2
    if pv == PROP_DELETE:
        an_val = torch.where(is_span, PROP_DELETE, PROP_ABSENT).to(I32)
    else:
        an_val = _i32(pv, dev)
    col = st2.props[:, pk]
    props = st2.props.clone()
    props[:, pk] = torch.where(covered, an_val, col)
    return st2._replace(props=props)


def _range(shards: List[ShardState], op, kr: int, kk: int
           ) -> List[ShardState]:
    (_, pos1, pos2, _, ref_seq, client, _, _, _, _) = op
    parts = [_partials(st, ref_seq, client) for st in shards]
    v_all = collectives.all_gather([v for v, _ in parts])
    off = torch.cumsum(v_all, 0, dtype=I32) - v_all
    total = off[-1] + v_all[-1]
    err = torch.where(pos2 > total, ERR_BAD_POS, 0).to(I32)
    for r, st in enumerate(shards):
        dev = st.anchor.device
        v_loc = parts[r][0]
        o = off.to(dev)[r]
        lo = torch.minimum(torch.clamp(pos1 - o, min=0), v_loc)
        hi = torch.minimum(torch.clamp(pos2 - o, min=0), v_loc)
        st = st._replace(error=st.error | err.to(dev))
        shards[r] = _select(lo < hi, _apply_local(st, lo, hi, op, kr, kk),
                            st)
    return shards


OP_FIELDS = ("op_type", "pos1", "pos2", "seq", "ref_seq", "client",
             "buf_start", "ins_len", "prop_key", "prop_val")


def sequence_sharded_replay(mesh: DocsMesh, capacity: int, n_removers: int,
                            n_prop_keys: int):
    """The sequence-sharded replay over `mesh`.

    Returns ``replay(states, ops) -> (states', error)``: `states` holds
    one ShardState per entry, on the entry's device, `ops` is a dict of
    replicated op arrays [N] (op_type, pos1, pos2, seq, ref_seq, client,
    buf_start, ins_len, prop_key, prop_val: numpy or tensors). The new
    states come back stacked on the first entry (a leading shard axis,
    as the reference returns them), and `error` is the per-bit OR of
    the shards' error words (an int32 scalar there)."""

    def replay(states, ops):
        shards = list(states)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size} entries")
        cols = [np.asarray(ops[k].cpu() if torch.is_tensor(ops[k])
                           else ops[k]).astype(np.int64).tolist()
                for k in OP_FIELDS]
        for op in zip(*cols):
            if op[0] == OP_INSERT:
                shards = _insert(shards, op, n_removers, n_prop_keys)
            elif op[0] in (OP_REMOVE, OP_ANNOTATE):
                shards = _range(shards, op, n_removers, n_prop_keys)
        gerr = collectives.por([st.error for st in shards])
        stacked = ShardState(*(collectives.all_gather(list(col))
                               for col in zip(*shards)))
        return stacked, gerr

    return replay


def run_sequence_sharded(stream, mesh: DocsMesh, initial_len: int,
                         capacity: int = 4096, n_removers: int = 10,
                         n_prop_keys: int = 8):
    """Replay `stream` sequence-sharded over `mesh`; returns the numpy
    spec object `SeqShardedOverlay` rebuilt from the final states (for
    digest and text comparison) and the OR of the error words."""
    from .seqshard_ref import SeqShardedOverlay

    D = mesh.size
    bounds = np.linspace(0, initial_len, D + 1).astype(int)
    states = [
        make_shard_state(int(bounds[d + 1] - bounds[d]), capacity,
                         n_removers, n_prop_keys, mesh.entries[d])
        for d in range(D)
    ]
    ops = {k: np.asarray(getattr(stream, k), np.int32)
           for k in ("op_type", "pos1", "pos2", "seq", "ref_seq", "client",
                     "buf_start", "ins_len", "prop_key", "prop_val")}
    replay = sequence_sharded_replay(mesh, capacity, n_removers,
                                     n_prop_keys)
    out, gerr = replay(states, ops)
    out = ShardState(*(t.cpu().numpy() for t in out))
    sharded = SeqShardedOverlay(
        stream, D, initial_len=initial_len, n_removers=n_removers,
        n_prop_keys=n_prop_keys,
    )
    for d, sh in enumerate(sharded.shards):
        n = int(out.n[d])
        sh.anchor = out.anchor[d, :n].copy()
        sh.buf = out.buf[d, :n].copy()
        sh.length = out.length[d, :n].copy()
        sh.iseq = out.iseq[d, :n].copy()
        sh.iclient = out.iclient[d, :n].copy()
        sh.rseq = out.rseq[d, :n].copy()
        sh.rcl = out.rcl[d, :n].copy()
        sh.props = out.props[d, :n].copy()
        sh.error = int(out.error[d])
    return sharded, int(gerr)
