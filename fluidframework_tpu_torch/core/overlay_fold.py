"""The summary service's fold on the overlay engine.

Counterpart of fluidframework_tpu/core/overlay_fold.py (the
``overlay`` fold backend of `server.summarizer.SummarizerRole`).
`merge_canonical_rows` is copied whole; `OverlayFoldReplica`,
`boot_overlay` and `fold_jobs_overlay` are ported onto the port's
overlay ops:

- **boot from canonical rows** (`boot_overlay`), the restart path run
  after every emission: settled rows (insert normalized to
  UNIVERSAL_SEQ, not removed) become the settled text/props space;
  every other row (unsettled inserts, tombstones above the window)
  boots as an overlay TEXT row over a fresh arena.
- **fold rounds**: the encoded rows of a round run through
  `ops.overlay.replay_fused` (the chunk kernel, then the fold at each
  chunk's MSN), and the fold records are applied to the host settled
  state (`reconstruct_settled`, incremental form). All documents of a
  round that share a window are stacked into ONE docs-form replay:
  one launch of kernel A and one of the fold kernel (one block per
  document each) per chunk for all of them. Documents with different windows make one such
  group each.
- **canonical serialization** (`canonical_rows`): byte-identical to
  the kernel backend's `summarizer._canonical_rows` by contract, so
  blob bytes and content-addressed handles do not depend on the
  engine.

- **the device plane** (`run_rounds(plane=)`, `fold_jobs_overlay(
  plane=)`; the reference's `_stacked_fold_fn` :550, `_run_rounds`
  :605 and `_dummy_job` :716): a window group is padded with empty
  dummy jobs (`_dummy_job`) to a multiple of the plane's size, its
  stacked doc axis laid over `DevicePlane.fold_sharding()` (every
  entry, docs-major), and each entry's slab runs the docs-form
  `replay_fused` under `DocsMesh.on`; the outputs are gathered back
  and applied to the real replicas only. Each document's result does
  not depend on its slab, so a plane changes no byte of a summary.

The availability probe `overlay_available` (:90) is not ported: it
decides the role's fallback to its kernel backend, and the port has no
fallback. Given no device the fold runs on ``cuda`` (kernel A and the
fold kernel) or raises; ``device="cpu"`` runs their plain versions.

Host syncs per round, as in the reference: per document one read of
``n_rows`` (`build_round`) and of ``settled_len`` (`apply_round`'s
desync check); per window group one read of the fold counts and one
of the used log rows; then per document at serialization the fold's
record count, its records, ``settled_len`` and one read of the table.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.mergetree_kernel import (
    NO_KEY,
    NOT_REMOVED,
    OP_NOOP,
    PROP_ABSENT,
    PROP_DELETE,
    OpBatch,
    raise_kernel_errors,
)
from ..ops.overlay import (
    OverlayTable,
    fold_device,
    make_overlay_table,
    pad_window,
    replay_fused,
    stack_tables,
)
from ..ops.overlay_ref import SETTLED_BASE, merge_span_props
from ..parallel.mesh import sharded_overlay_replay_multi
from ..protocol.constants import NO_CLIENT, UNIVERSAL_SEQ
from ..utils.devices import DeviceLike, resolve_device
from .kernel_replica import PropInterner, TextArena, encoded_columns
from .overlay_replay import reconstruct_settled

__all__ = [
    "OverlayFoldReplica",
    "boot_overlay",
    "fold_jobs_overlay",
    "group_jobs",
    "merge_canonical_rows",
    "run_rounds",
    "stack_jobs",
]

# Fold-engine shape knobs (the reference's): chunk mirrors the
# summarizer's kernel-fold chunk; the window is the overlay table's
# unsettled-row capacity, a multiple of 1024, grown ahead of need.
_CHUNK = 128
_MIN_WINDOW = 1024
_PK = 4  # max prop pairs per encoded op
_KR = 4  # removers per row
_KK = 8  # prop keys
_TABLE_COLS = ("anchor", "buf_start", "length", "ins_seq", "ins_client",
               "rem_seq")


def merge_canonical_rows(raw_rows) -> List[list]:
    """THE canonical-row merge rule, shared by both fold backends:
    adjacent rows whose semantic fields all match coalesce into
    maximal runs, erasing split/chunk/engine history from the bytes.
    `raw_rows` yields ``(text, ins, icl, rem|None, rcl|None, props)``
    tuples in document order."""
    out: List[list] = []
    last_key: Optional[tuple] = None
    for seg, ins, icl, rem, rcl, props in raw_rows:
        key = (ins, icl, rem, tuple(rcl) if rcl else None,
               json.dumps(props, sort_keys=True))
        if key == last_key and out:
            out[-1][0] += seg
        else:
            out.append([seg, ins, icl, rem, rcl, props])
            last_key = key
    return out


def _flatten(n_rows, settled_len, error, cols: dict) -> list:
    """A table's fields in the order of one flat int32 buffer: the three
    scalars, the six ``[W]`` columns, then ``rem_clients`` and
    ``props`` row-major (numpy arrays or tensors alike)."""
    return ([n_rows, settled_len, error] + [cols[c] for c in _TABLE_COLS]
            + [cols["rem_clients"].reshape(-1), cols["props"].reshape(-1)])


def _unflatten(flat, W: int) -> dict:
    """The fields of a flat buffer laid out by `_flatten` (views)."""
    out = dict(n_rows=flat[0], settled_len=flat[1], error=flat[2])
    off = 3
    for c in _TABLE_COLS:
        out[c] = flat[off: off + W]
        off += W
    out["rem_clients"] = flat[off: off + W * _KR].reshape(W, _KR)
    out["props"] = flat[off + W * _KR:].reshape(W, _KK)
    return out


def _read_table(table: OverlayTable) -> SimpleNamespace:
    """One document's table on the host, in one device-to-host copy:
    a namespace of int32 numpy arrays (scalars as 0-d arrays) under
    the `OverlayTable` field names."""
    parts = _flatten(table.n_rows, table.settled_len, table.error,
                     vars(table))
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    return SimpleNamespace(**_unflatten(flat, table.length.shape[0]))


def _upload_table(cols: Dict[str, np.ndarray], n_rows: int,
                  settled_len: int, device: torch.device) -> OverlayTable:
    """An `OverlayTable` on `device` from host columns, in one
    host-to-device copy (the fields are views of one buffer)."""
    parts = _flatten(n_rows, settled_len, 0, cols)
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(p, np.int32).reshape(-1) for p in parts])).to(device)
    return OverlayTable(**_unflatten(flat, len(cols["length"])))


# ---------------------------------------------------------------------------
# the replica
# ---------------------------------------------------------------------------


class OverlayFoldReplica:
    """One document's summary fold state on the overlay engine: the
    host op encoder's surface (`kernel_replica.encode_op` writes into
    `_encoded` through the arena/prop-interner attributes), the
    boot-from-rows restart contract and the canonical serialization.
    `device` is ``cuda`` by default (raising when there is none) or an
    explicit ``"cpu"``."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.chunk_size = _CHUNK
        self.max_prop_pairs = _PK
        self.n_removers = _KR
        self.n_prop_keys = _KK
        self.window = _MIN_WINDOW
        self.arena = TextArena("")
        self.props = PropInterner(_KK)
        self.table = make_overlay_table(self.window, _KR, _KK,
                                        device=self.device)
        # Host settled state (text/props/attr as np arrays of
        # codepoints / interned ids), advanced per round from the fold
        # records: the `reconstruct_settled` walk in incremental form.
        self.settled_t = np.zeros(0, np.int32)
        self.settled_p = np.zeros((0, _KK), np.int32)
        self.settled_a = np.zeros(0, np.int32)
        # encode_op contract fields.
        self._encoded: List[tuple] = []
        self._pending_rows_bound = 0
        # _encode_fold contract fields.
        self.min_seq = 0
        self.current_seq = 0
        self._applied_min_seq = 0

    # --------------------------------------------------------- capacity

    def _ensure_window(self, need: int) -> None:
        """Grow the table's row capacity ahead of a round, in 1024-row
        steps, keeping every column's empty-row sentinel
        (`ops.overlay.pad_window`)."""
        if need <= self.window:
            return
        new_w = self.window
        while new_w < need:
            new_w += _MIN_WINDOW
        self.table = pad_window(self.table, new_w)
        self.window = new_w

    # ------------------------------------------------------------ round

    def build_round(self) -> Optional[dict]:
        """Drain `_encoded` into one padded fold-round job: columnar op
        host arrays (NOOP-padded to whole chunks), the per-chunk MSN
        fold schedule (each chunk folds at its last real row's msn), a
        fresh per-round fold log size, and the window sized so that
        ERR_CAPACITY cannot fire for this round's row bound. Returns
        None when nothing is pending."""
        rows = self._encoded
        if not rows:
            return None
        self._encoded = []
        n = len(rows)
        B = self.chunk_size
        n_chunks = -(-n // B)
        self._ensure_window(int(self._rows_now()) + 4 * n + 64)
        batch = tuple(encoded_columns(rows, n_chunks * B, _PK))
        # Each chunk folds at its last real row's msn.
        msns = np.asarray([rows[min((c + 1) * B, n) - 1][10]
                           for c in range(n_chunks)], np.int32)
        self._applied_min_seq = rows[-1][10]
        self._pending_rows_bound = 0
        return {
            "rep": self,
            "window": self.window,
            "n": n,
            "n_chunks": n_chunks,
            "batch": batch,
            "msns": msns,
            # Worst case: every fold emits at most `window` records
            # (only table rows fold), one fold per chunk.
            "log_cap": (n_chunks + 1) * self.window,
        }

    def _rows_now(self) -> int:
        return int(self.table.n_rows)

    def apply_round(self, table: OverlayTable, log: np.ndarray,
                    counts) -> None:
        """Fold a finished round's outputs back into this replica:
        adopt the table and replay the round's fold records (host
        arrays) into the host settled state (one reconstruct epoch per
        chunk). A settled length that differs between host and device
        raises; it is never corrected."""
        self.table = table
        counts_l = [int(c) for c in np.asarray(counts)]
        total = sum(counts_l)
        if total:
            stream_text = np.frombuffer(
                self.arena.snapshot().encode("utf-32-le"), np.uint32
            ).astype(np.int32)
            self.settled_t, self.settled_p, self.settled_a = \
                reconstruct_settled(
                    self.settled_t, stream_text,
                    np.asarray(log)[:total], counts_l, _KK,
                    initial_props=self.settled_p,
                    initial_attr=self.settled_a,
                )
        if len(self.settled_t) != int(self.table.settled_len):
            raise RuntimeError(
                f"overlay fold settled desync: host "
                f"{len(self.settled_t)} != device "
                f"{int(self.table.settled_len)}"
            )

    def fold_pending(self) -> None:
        """Single-replica round (the defensive flush `canonical_rows`
        takes if encoded rows are still pending)."""
        job = self.build_round()
        if job is not None:
            run_rounds([job])

    # -------------------------------------------------- serialization

    def _check_invariants(self, t) -> None:
        """Host-side structural invariants of the overlay table (`t`,
        host arrays), checked BEFORE every serialization: a corrupt
        table must freeze the doc loudly (RuntimeError), never ship a
        wrong content-addressed blob."""
        n = int(t.n_rows)
        if n < 0 or n > self.window:
            raise RuntimeError(f"overlay n_rows corrupt: {n}")
        if n == 0:
            return
        length = t.length[:n]
        anchor = t.anchor[:n]
        is_span = t.buf_start[:n] >= SETTLED_BASE
        removed = t.rem_seq[:n] != NOT_REMOVED
        has_removers = (t.rem_clients[:n] != NO_CLIENT).any(axis=1)
        S = int(t.settled_len)
        consume = np.where(is_span, length, 0)
        end = anchor + consume
        bad = (
            (length <= 0).any()
            or (anchor < 0).any() or (end > S).any()
            or (n > 1 and (anchor[1:] < end[:-1]).any())
            or bool((removed != has_removers).any())
            or (t.ins_seq[:n] < 0).any()
            or (t.ins_client[:n] < NO_CLIENT).any()
        )
        if bad:
            raise RuntimeError(
                "overlay table failed structural invariants at "
                "serialization (corrupt row state); freezing the doc "
                "rather than shipping a wrong summary"
            )

    def canonical_rows(self, msn: int) -> List[list]:
        """The canonical serialized row form at fold msn `msn`:
        byte-identical to the kernel backend's `_canonical_rows` for
        the same op prefix (the backend-invariance contract the
        content-addressed handles rest on). Runs the final fold at
        `msn` first, so the table holds only rows the window still
        needs."""
        self.fold_pending()
        self.table, records, n_rec = fold_device(self.table, msn)
        n = int(n_rec)
        self.apply_round(self.table, records[:n].cpu().numpy(), [n])
        t = _read_table(self.table)
        raise_kernel_errors(int(t.error))
        self._check_invariants(t)
        arena_text = self.arena.snapshot()
        decode = self.props.decode_row
        settled_t, settled_p = self.settled_t, self.settled_p
        raw: List[tuple] = []

        def emit_settled(lo: int, hi: int) -> None:
            # Settled content: ins normalized by construction; split
            # into maximal equal-prop runs (the canonical merge below
            # re-merges across row boundaries with the full key).
            i = lo
            while i < hi:
                j = i + 1
                while j < hi and np.array_equal(settled_p[j],
                                                settled_p[i]):
                    j += 1
                raw.append((
                    "".join(map(chr, settled_t[i:j].tolist())),
                    UNIVERSAL_SEQ, NO_CLIENT, None, None,
                    decode(settled_p[i]),
                ))
                i = j

        cursor = 0
        for i in range(int(t.n_rows)):
            a = int(t.anchor[i])
            if a > cursor:
                emit_settled(cursor, a)
                cursor = a
            rem = int(t.rem_seq[i])
            removed = rem != NOT_REMOVED
            ln = int(t.length[i])
            is_span = int(t.buf_start[i]) >= SETTLED_BASE
            if removed and rem <= msn:
                # Tombstone below the window: zamboni (the final fold
                # above dropped these; defensive for exactness).
                if is_span:
                    cursor = a + ln
                continue
            rcl = (sorted(int(c) for c in t.rem_clients[i]
                          if int(c) != NO_CLIENT) if removed else None)
            if is_span:
                # Removed settled text (a live span cannot survive the
                # fold): per-position merged props split into runs,
                # insert identity is settled == universal.
                merged = merge_span_props(
                    settled_p[a: a + ln], t.props[i]
                )
                k = 0
                while k < ln:
                    k2 = k + 1
                    while k2 < ln and np.array_equal(merged[k2],
                                                     merged[k]):
                        k2 += 1
                    raw.append((
                        "".join(map(chr,
                                    settled_t[a + k: a + k2].tolist())),
                        UNIVERSAL_SEQ, NO_CLIENT, rem, rcl,
                        decode(merged[k]),
                    ))
                    k = k2
                cursor = a + ln
            else:
                b = int(t.buf_start[i])
                seg = arena_text[b: b + ln]
                ins = int(t.ins_seq[i])
                icl = int(t.ins_client[i])
                if ins <= msn:
                    ins, icl = UNIVERSAL_SEQ, NO_CLIENT
                row_p = np.asarray(t.props[i]).copy()
                row_p[row_p == PROP_DELETE] = PROP_ABSENT
                raw.append((seg, ins, icl, rem if removed else None,
                            rcl, decode(row_p)))
        emit_settled(cursor, len(settled_t))
        return merge_canonical_rows(raw)


def boot_overlay(rows: List[list], msn: int,
                 device: DeviceLike = None) -> OverlayFoldReplica:
    """Build a live overlay fold replica from serialized canonical
    rows: THE restart path, run after every emission exactly like the
    kernel backend's `_boot_mergetree`, so interrupted and
    uninterrupted summarizers proceed from the identical state. The
    table reaches the device in one copy."""
    rep = OverlayFoldReplica(device=device)
    n = len(rows)
    W = _MIN_WINDOW
    while W < n + 2 * _CHUNK + 8:
        W += _MIN_WINDOW
    cols = dict(
        anchor=np.zeros(W, np.int32),
        buf_start=np.zeros(W, np.int32),
        length=np.zeros(W, np.int32),
        ins_seq=np.zeros(W, np.int32),
        ins_client=np.full(W, NO_CLIENT, np.int32),
        rem_seq=np.full(W, NOT_REMOVED, np.int32),
        rem_clients=np.full((W, _KR), NO_CLIENT, np.int32),
        props=np.full((W, _KK), PROP_ABSENT, np.int32),
    )
    settled_t: List[int] = []
    settled_p: List[np.ndarray] = []
    m = 0
    for seg, ins, icl, rem, rcl, prow in rows:
        prow_ids = np.full(_KK, PROP_ABSENT, np.int32)
        if prow:
            for k, v in prow.items():
                prow_ids[rep.props.key_id(k)] = rep.props.value_id(v)
        if rem is None and ins <= msn:
            # Settled run: text/props join the settled space directly
            # (ins is UNIVERSAL_SEQ in canonical form; <= msn keeps
            # the rule identical to the kernel boot's semantics).
            settled_t.extend(ord(c) for c in seg)
            settled_p.extend([prow_ids] * len(seg))
            continue
        # Window TEXT row: unsettled insert or an above-window
        # tombstone; anchor = current settled position, text in the
        # arena. Normalized-identity tombstones keep
        # (UNIVERSAL_SEQ, NO_CLIENT): visible to every perspective,
        # exactly the settled-content rule.
        cols["anchor"][m] = len(settled_t)
        cols["buf_start"][m] = rep.arena.append(seg)
        cols["length"][m] = len(seg)
        cols["ins_seq"][m] = UNIVERSAL_SEQ if ins <= msn else ins
        cols["ins_client"][m] = NO_CLIENT if ins <= msn else icl
        if rem is not None:
            cols["rem_seq"][m] = rem
            if rcl:
                cols["rem_clients"][m, : len(rcl)] = rcl
        cols["props"][m] = prow_ids
        m += 1
    rep.window = W
    rep.settled_t = np.asarray(settled_t, np.int32)
    rep.settled_p = (
        np.stack(settled_p) if settled_p
        else np.zeros((0, _KK), np.int32)
    )
    rep.settled_a = np.zeros(len(settled_t), np.int32)
    rep.table = _upload_table(cols, m, len(settled_t), rep.device)
    rep.min_seq = rep._applied_min_seq = int(msn)
    rep._pending_rows_bound = m
    return rep


# ---------------------------------------------------------------------------
# stacked rounds: one docs-form replay per window group
# ---------------------------------------------------------------------------


def group_jobs(jobs: List[dict]) -> Dict[int, List[dict]]:
    """Fold-round jobs grouped by window (the shape stacking needs to
    be uniform), in order of first appearance."""
    groups: Dict[int, List[dict]] = {}
    for job in jobs:
        groups.setdefault(job["window"], []).append(job)
    return groups


def stack_jobs(grp: List[dict]):
    """The docs-form inputs of one window group's replay:
    ``(tables, ops, logs, counts, msns)`` with the tables stacked
    ``[D, ...]``, ops ``[n_chunks, D, B]`` (each chunk of all documents
    one contiguous slice), fresh logs ``[D, log_cap, 5+KK]`` and counts
    ``[D, n_chunks]``, and MSNs ``[n_chunks, D]``. Jobs with fewer
    chunks are padded with NOOP chunks that fold again at their last
    MSN (nothing new settles or drops), as the reference pads them;
    the ops and MSNs reach the device in one copy. A dummy job
    (`_dummy_job`) brings its own empty table."""
    D = len(grp)
    n_chunks = max(j["n_chunks"] for j in grp)
    log_cap = max(j["log_cap"] for j in grp)
    dev = grp[0]["rep"].device
    pad = n_chunks * _CHUNK
    fills = (OP_NOOP, 0, 0, 0, 0, NO_CLIENT, 0, 0, NO_KEY, PROP_ABSENT)
    cols = []
    for f, fill in enumerate(fills):
        a = np.full((D, pad) + grp[0]["batch"][f].shape[1:], fill,
                    np.int32)
        for d, j in enumerate(grp):
            a[d, : len(j["batch"][f])] = j["batch"][f]
        a = a.reshape((D, n_chunks, _CHUNK) + a.shape[2:])
        cols.append(np.ascontiguousarray(a.swapaxes(0, 1)))
    cols.append(np.stack([
        np.concatenate([j["msns"], np.full(n_chunks - j["n_chunks"],
                                           j["msns"][-1], np.int32)])
        for j in grp], 1))
    flat = torch.from_numpy(np.concatenate(
        [a.reshape(-1) for a in cols])).to(dev)
    views, off = [], 0
    for a in cols:
        views.append(flat[off: off + a.size].view(a.shape))
        off += a.size
    return (
        stack_tables([j["rep"].table if j["rep"] is not None
                      else j["table"] for j in grp]),
        OpBatch(*views[:-1]),
        torch.zeros((D, log_cap, 5 + _KK), dtype=torch.int32, device=dev),
        torch.zeros((D, n_chunks), dtype=torch.int32, device=dev),
        views[-1],
    )


def _dummy_job(like: dict) -> dict:
    """An empty padding job shaped like `like` (``rep`` None: its
    outputs are dropped): an empty table of the window, no ops (the
    stack fills NOOPs), every chunk folding at MSN 0."""
    return {
        "rep": None,
        "table": make_overlay_table(like["window"], _KR, _KK,
                                    device=like["rep"].device),
        "window": like["window"],
        "n": 0,
        "n_chunks": like["n_chunks"],
        "batch": tuple(np.zeros((0,) + a.shape[1:], np.int32)
                       for a in like["batch"]),
        "msns": np.zeros(like["n_chunks"], np.int32),
        "log_cap": like["log_cap"],
    }


def run_rounds(jobs: List[dict], plane=None) -> List[dict]:
    """Execute fold-round jobs (`OverlayFoldReplica.build_round`): each
    window group is stacked (`stack_jobs`) and run as ONE docs-form
    `replay_fused` call, one launch of kernel A and one of the fold
    kernel per chunk for all its documents. With `plane` (a
    `parallel.device_plane.DevicePlane`) the group is padded with empty
    dummy jobs to a multiple of the plane's size and laid over
    `plane.fold_sharding()` by `parallel.mesh.sharded_overlay_replay_multi`:
    the docs-form replay of each entry's slab, the entries interleaved
    chunk by chunk on their own streams. One read of the counts and one of the used log rows per
    group; the outputs unstack into each real replica.

    Returns one summary per group: ``{"window", "docs" (the real
    documents), "entries" (1, or the plane's size), "chunks",
    "device_ms"}``, where ``device_ms`` is the CUDA-event time from the
    group's first launch (its placement included) to its last op (None
    on the CPU)."""
    mesh = plane.fold_sharding() if plane is not None else None
    summary = []
    for window, grp in group_jobs(jobs).items():
        real = len(grp)
        if mesh is not None:
            while len(grp) % mesh.size:
                grp.append(_dummy_job(grp[0]))
        tables, ops, logs, counts, msns = stack_jobs(grp)
        timed = tables.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        if mesh is None:
            out_tables, out_logs, out_counts, _cursors = replay_fused(
                tables, ops, logs, counts, msns, _CHUNK)
        else:
            out_tables, out_logs, out_counts = sharded_overlay_replay_multi(
                mesh, _CHUNK)(tables, ops, logs, counts, msns)[:3]
        if timed:
            ev1.record()
        counts_h = out_counts.cpu().numpy()
        used = int(counts_h.sum(1).max())
        logs_h = out_logs[:, :used].cpu().numpy()
        for d, j in enumerate(grp[:real]):
            j["rep"].apply_round(out_tables.doc(d), logs_h[d], counts_h[d])
        summary.append({
            "window": window, "docs": real,
            "entries": 1 if mesh is None else mesh.size,
            "chunks": msns.shape[0],
            "device_ms": ev0.elapsed_time(ev1) if timed else None,
        })
    return summary


def fold_jobs_overlay(jobs: List[Tuple[Any, list]],
                      plane=None) -> List[dict]:
    """Drain the pending encoded rows of several overlay replicas (the
    kernel backend's `summarizer._fold_jobs` twin): replicas that share
    a window stack into one docs-form replay, so K summarizing
    documents of one window cost one launch of each kernel per chunk,
    not K; with `plane` the stack is laid over the plane's entries
    (`run_rounds`). `jobs` holds ``(replica, records)`` pairs, as the
    role passes them. Returns the per-group summaries of `run_rounds`
    (empty when nothing was pending)."""
    round_jobs: List[dict] = []
    for rep, _take in jobs:
        job = rep.build_round()
        if job is not None:
            round_jobs.append(job)
    return run_rounds(round_jobs, plane) if round_jobs else []
