"""Row-model replay engine on PyTorch: the chunk path and the scan path.

Counterpart of fluidframework_tpu/core/columnar_replay.py, both of its
engines. `ColumnarReplica` consumes a pre-decoded `ColumnarStream` and
keeps the whole document as a `SegmentTable` on the device (rows in
document order, one row per segment).

- ``engine="pallas"`` (the default; the name is the reference's): the
  NOOP-padded op stream uploads in segments; each chunk of ops is one
  `apply_chunk_at` (the hand-written CUDA kernel
  ``csrc/mergetree_chunk.cu`` on the card, its plain PyTorch version on
  the CPU), and every `sync_interval` chunks `compact_gather_text`
  (the hand-written kernel ``csrc/zamboni.cu``, one launch, on the
  card; its plain version on the CPU) drops settled tombstones,
  re-gathers the live text into a fresh device arena and coalesces
  settled runs. The host reads ``n_rows``
  and the error word once per sync window (the capacity check);
  nothing else leaves the device inside the loop.
- ``engine="scan"`` (`bench.py`'s ``BENCH_ENGINE=scan``): each chunk is
  one `OpBatch` upload and one `apply_op_batch` (the scan kernel
  ``csrc/mergetree_scan.cu`` with one block on the card, the plain scan
  on the CPU). A host bound on the live rows (2 an op) decides when to
  compact: past `compact_watermark` of the capacity, and before a
  chunk that could overflow (compact, then grow to max(2 C, 2 need)).
  `compact()` is the reference's host compaction: one device-to-host
  pull of the table, a numpy drop of the settled tombstones and
  coalescing of settled rows with equal props (no contiguity test: the
  text is re-gathered into a new host document text), and one
  host-to-device push.

Two text address spaces share the int32 offset coordinate: compacted
document text lives at ``[0, STREAM_BASE)`` (the device arena of the
chunk path, the host `doc_text` of the scan path) and the immutable
stream-insert text at ``[STREAM_BASE, ...)``.

A ``device=`` argument takes the place of the JAX version's ``auto``
engine choice and ``interpret=``: ``cuda`` (the default) launches the
kernels, ``"cpu"`` runs the plain versions. ``interpret=`` (the Pallas
interpreter) and ``arena_cap=`` (a fixed TPU arena size) have no
counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.mergetree_chunk import apply_chunk_at
from ..ops.mergetree_kernel import (
    NO_CLIENT,
    NO_KEY,
    NOT_REMOVED,
    OP_NOOP,
    PROP_ABSENT,
    OpBatch,
    SegmentTable,
    apply_op_batch,
    grow_table,
    make_table,
    raise_kernel_errors,
    verify_table_invariants,
)
from ..ops.zamboni import STREAM_BASE, compact_gather_text
from ..protocol.constants import UNIVERSAL_SEQ
from ..testing.synthetic import ColumnarStream
from ..utils.devices import DeviceLike, resolve_device

# Shape grids of the JAX engine (columnar_replay.py:246-247): op
# segments of ~2^18 ops, text padded to multiples of 2^18.
SEG_OPS = 1 << 18
TXT_GRID = 1 << 18
ENGINES = ("pallas", "scan")


def _pack_table(t: SegmentTable) -> torch.Tensor:
    """The whole table as one int32 vector, so a device-to-host pull
    is one transfer."""
    return torch.cat([
        t.buf_start, t.length, t.ins_seq, t.ins_client, t.rem_seq,
        t.rem_clients.reshape(-1), t.props.reshape(-1),
        torch.stack([t.n_rows, t.error]),
    ])


def _unpack_table(flat: np.ndarray, capacity: int, kr: int, kk: int) -> dict:
    """Host-side view of a packed table (numpy, no copies)."""
    c = capacity
    out = {}
    off = 0
    for name in ("buf_start", "length", "ins_seq", "ins_client", "rem_seq"):
        out[name] = flat[off: off + c]
        off += c
    out["rem_clients"] = flat[off: off + c * kr].reshape(c, kr)
    off += c * kr
    out["props"] = flat[off: off + c * kk].reshape(c, kk)
    off += c * kk
    out["n_rows"] = int(flat[off])
    out["error"] = int(flat[off + 1])
    return out


def _device_table(host: dict, capacity: int, device) -> SegmentTable:
    """Push a host table (the fields of `_unpack_table`) as one
    host-to-device transfer; the fields are views of it."""
    flat = np.concatenate([
        host["buf_start"], host["length"], host["ins_seq"],
        host["ins_client"], host["rem_seq"], host["rem_clients"].ravel(),
        host["props"].ravel(),
        np.asarray([host["n_rows"], host["error"]], np.int32),
    ]).astype(np.int32)
    kr = host["rem_clients"].shape[1]
    kk = host["props"].shape[1]
    dev = torch.from_numpy(flat).to(device)
    c = capacity
    cols = torch.split(dev, [c] * 5 + [c * kr, c * kk, 1, 1])
    return SegmentTable(
        n_rows=cols[7][0], buf_start=cols[0], length=cols[1],
        ins_seq=cols[2], ins_client=cols[3], rem_seq=cols[4],
        rem_clients=cols[5].view(c, kr), props=cols[6].view(c, kk),
        error=cols[8][0],
    )


class ColumnarReplica:
    """Device-resident row-model replica driven by columnar op arrays.

    Same output surface as the JAX `ColumnarReplica` (get_text /
    annotated_spans / check_errors), so the digest gates compare the
    engines directly. `engine` is ``"pallas"`` (the chunk path, the
    default) or ``"scan"``; each runs on `device`, ``cuda`` by default
    (raising when there is none) or an explicit ``"cpu"``. `sync_interval`
    is the chunk path's, `compact_watermark` the scan path's.
    """

    def __init__(
        self,
        stream: ColumnarStream,
        initial_len: int = 0,
        chunk_size: int = 1024,
        capacity: int = 16384,
        n_removers: int = 4,
        n_prop_keys: int = 8,
        compact_watermark: float = 0.7,
        engine: str = "pallas",
        sync_interval: int = 4,
        device: DeviceLike = None,
    ):
        if engine not in ENGINES:
            raise ValueError(f"engine {engine!r}: one of {ENGINES}")
        self.device = resolve_device(device)
        self.stream = stream
        self.chunk_size = chunk_size
        self.capacity = capacity
        self.n_removers = n_removers
        self.n_prop_keys = n_prop_keys
        self.compact_watermark = compact_watermark
        self.engine = engine
        self.sync_interval = sync_interval

        # Document text: compacted text (region [0, STREAM_BASE)), on the
        # host; the chunk path moves it into a device arena.
        self._host_text = np.asarray(stream.text[:initial_len], np.int32)
        self.table = make_table(capacity, n_removers, n_prop_keys,
                                device=self.device)
        if initial_len:
            self.table.n_rows.fill_(1)
            self.table.length[0] = initial_len
            self.table.ins_seq[0] = UNIVERSAL_SEQ
            self.table.ins_client[0] = NO_CLIENT
        # The scan path's bound on the live rows (2 an op since the last
        # compaction), read on the host only.
        self._rows_bound = 1 if initial_len else 0
        self._applied_min_seq = 0
        self.compactions = 0
        self.chunks_done = 0
        self.arena: Optional[torch.Tensor] = None
        self.stream_text: Optional[torch.Tensor] = None

    @property
    def n_chunks(self) -> int:
        return -(-len(self.stream) // self.chunk_size)

    @property
    def doc_text(self) -> np.ndarray:
        """The document text on the host: the scan path's own, which
        `compact()` replaces; on the chunk path the initial text until
        the device arena exists, then a pull of it."""
        if self.engine == "scan" or self.arena is None:
            return self._host_text
        return self.arena.cpu().numpy()

    @doc_text.setter
    def doc_text(self, text: np.ndarray) -> None:
        """The scan path's document text (as a hand-over from another
        replica sets it); the chunk path keeps its text in `arena`."""
        if self.engine != "scan":
            raise AttributeError("the chunk path's document text is its "
                                 "device arena (`arena`)")
        self._host_text = np.asarray(text, np.int32)

    # -------------------------------------------------------------- replay

    def op_segment(self, lo: int, hi: int) -> OpBatch:
        """Ops ``[lo, hi)`` on the device, NOOP-padded to whole
        segments (the chunk path's upload)."""
        seg = -(-SEG_OPS // self.chunk_size) * self.chunk_size
        return self._padded_ops(lo, hi, max(1, -(-(hi - lo) // seg)) * seg)

    def chunk_ops(self, lo: int, hi: int) -> OpBatch:
        """Ops ``[lo, hi)`` on the device, NOOP-padded to one chunk (the
        scan path's upload)."""
        return self._padded_ops(lo, hi, self.chunk_size)

    def _padded_ops(self, lo: int, hi: int, size: int) -> OpBatch:
        """Ops ``[lo, hi)`` NOOP-padded to `size` ops with one prop
        slot (insert offsets rebased into the stream region), in one
        host-to-device copy; the fields are views of it."""
        s = self.stream
        host = np.empty((10, size), np.int32)
        for row, (a, fill) in enumerate((
                (s.op_type, OP_NOOP), (s.pos1, 0), (s.pos2, 0), (s.seq, 0),
                (s.ref_seq, 0), (s.client, NO_CLIENT), (s.buf_start, 0),
                (s.ins_len, 0), (s.prop_key, NO_KEY),
                (s.prop_val, PROP_ABSENT))):
            host[row, : hi - lo] = a[lo:hi]
            host[row, hi - lo:] = fill
        host[6, : hi - lo] += STREAM_BASE
        dev = torch.from_numpy(host).to(self.device)
        return OpBatch(*dev[:8], prop_keys=dev[8][:, None],
                       prop_vals=dev[9][:, None])

    def _prepare_text(self) -> None:
        """The device doc arena (sized initial_len + len(stream text),
        which no live document can exceed, so it never grows) and the
        padded stream text."""
        s = self.stream
        if self.arena is None:
            init = self._host_text
            arena_cap = -(-(len(init) + len(s.text) + 1) // TXT_GRID) * TXT_GRID
            arena = np.zeros(arena_cap, np.int32)
            arena[: len(init)] = init
            self.arena = torch.from_numpy(arena).to(self.device)
        if self.stream_text is not None:
            return
        txt_pad = -(-max(len(s.text), 1) // TXT_GRID) * TXT_GRID
        st = np.zeros(txt_pad, np.int32)
        st[: len(s.text)] = s.text
        self.stream_text = torch.from_numpy(st).to(self.device)

    def replay(self, limit_chunks: Optional[int] = None) -> None:
        """Replay the stream from the first chunk not yet applied.
        `limit_chunks` stops once that many chunks (counted from the
        stream's start) are done; a later call goes on from there.

        Each chunk is one `apply_chunk_at`; every `sync_interval`
        chunks, and at the stop, one `compact_gather_text` runs and
        the host reads ``n_rows`` and the error word (growing the
        table, doubling, when a full sync window of worst-case growth,
        2 rows per op, would not fit). A stop on a multiple of
        `sync_interval` leaves the schedule of one uninterrupted
        replay.

        The scan path applies each chunk with `_apply_chunk`, whose
        compactions depend only on the host's row bound, so any stop
        keeps the schedule of one uninterrupted replay."""
        if self.engine == "scan":
            while self.chunks_done < self.n_chunks:
                if (limit_chunks is not None
                        and self.chunks_done >= limit_chunks):
                    break
                lo = self.chunks_done * self.chunk_size
                self._apply_chunk(lo, min(lo + self.chunk_size,
                                          len(self.stream)))
                self.chunks_done += 1
            return
        s = self.stream
        n = len(s)
        B = self.chunk_size
        self._ensure_window_capacity(int(self.table.n_rows), B)
        self._prepare_text()
        seg = -(-SEG_OPS // B) * B
        dev_ops, seg_lo = None, -1
        chunks_since = 0
        while self.chunks_done < self.n_chunks:
            if limit_chunks is not None and self.chunks_done >= limit_chunks:
                break
            lo = self.chunks_done * B
            if lo // seg * seg != seg_lo:
                seg_lo = lo // seg * seg
                dev_ops = self.op_segment(seg_lo, min(seg_lo + seg, n))
            hi = min(lo + B, n)
            self.table = apply_chunk_at(self.table, dev_ops, lo - seg_lo, B)
            self._applied_min_seq = int(s.min_seq[hi - 1])
            chunks_since += 1
            self.chunks_done += 1
            done = hi >= n or (
                limit_chunks is not None and self.chunks_done >= limit_chunks
            )
            if chunks_since >= self.sync_interval or done:
                chunks_since = 0
                self.table, self.arena = compact_gather_text(
                    self.table, self._applied_min_seq, self.arena,
                    self.stream_text,
                )
                self.compactions += 1
                n_rows = int(self.table.n_rows)
                self.check_errors()
                self._ensure_window_capacity(n_rows, B)

    # ---------------------------------------------------------- scan path

    def _apply_chunk(self, lo: int, hi: int) -> None:
        """One chunk of the scan path (the reference's `_apply_chunk`):
        the emergency compaction (and growth to max(2 C, 2 need)) when
        the chunk could overflow, the upload, one scan launch, and the
        compaction past the watermark."""
        m = hi - lo
        self._rows_bound += 2 * m
        if self._rows_bound + 2 > self.capacity:
            self.compact()  # emergency compact before overflow
            need = self._rows_bound + 2 * m + 2
            if need > self.capacity:
                self._grow(max(self.capacity * 2, 2 * need))
            self._rows_bound += 2 * m
        self.table = apply_op_batch(self.table, self.chunk_ops(lo, hi))
        self._applied_min_seq = int(self.stream.min_seq[hi - 1])
        if self._rows_bound > self.capacity * self.compact_watermark:
            self.compact()

    def compact(self) -> None:
        """The scan path's host compaction (the reference's `compact()`):
        one pull of the table; tombstones removed at or below the
        applied MSN dropped; runs of settled rows (inserted at or below
        it, not removed) with equal props coalesced, whatever their
        text's place; the kept text re-gathered into a new host document
        text; one push of the new table at the same capacity."""
        t = self._host_table()
        n = t["n_rows"]
        msn = self._applied_min_seq
        live = np.arange(len(t["length"])) < n
        removed = t["rem_seq"] != NOT_REMOVED
        keep = live & ~(removed & (t["rem_seq"] <= msn))
        idx = np.nonzero(keep)[0]
        k = len(idx)

        buf = t["buf_start"][idx]
        lens = t["length"][idx].astype(np.int64)
        props = t["props"][idx]
        settled = (~removed[idx]) & (t["ins_seq"][idx] <= msn)

        # Consecutive settled rows with identical props coalesce; every
        # unsettled row is its own run.
        if k:
            prev_settled = np.concatenate([[False], settled[:-1]])
            same_props = np.concatenate(
                [[False], (props[1:] == props[:-1]).all(axis=1)])
            start_run = ~(settled & prev_settled & same_props)
            start_run[0] = True
            run_id = np.cumsum(start_run) - 1
            m = int(run_id[-1]) + 1
        else:
            start_run = np.zeros(0, bool)
            run_id = np.zeros(0, np.int64)
            m = 0

        new_text, new_off = self._gather_text(buf, lens)
        first = np.nonzero(start_run)[0]
        run_len = np.bincount(run_id, weights=lens,
                              minlength=m).astype(np.int32)

        cap = self.capacity
        host = {
            "buf_start": np.zeros(cap, np.int32),
            "length": np.zeros(cap, np.int32),
            "ins_seq": np.zeros(cap, np.int32),
            "ins_client": np.full(cap, NO_CLIENT, np.int32),
            "rem_seq": np.full(cap, NOT_REMOVED, np.int32),
            "rem_clients": np.full((cap, self.n_removers), NO_CLIENT,
                                   np.int32),
            "props": np.full((cap, self.n_prop_keys), PROP_ABSENT, np.int32),
            "n_rows": m, "error": t["error"],
        }
        if m:
            rows = idx[first]
            host["buf_start"][:m] = new_off[first]
            host["length"][:m] = run_len[:m]
            for f in ("ins_seq", "ins_client", "rem_seq", "rem_clients"):
                host[f][:m] = t[f][rows]
            host["props"][:m] = props[first]
        self._host_text = new_text
        self.table = _device_table(host, cap, self.device)
        self._rows_bound = m
        self.compactions += 1

    # ----------------------------------------------------------- capacity

    def _grow(self, new_cap: int) -> None:
        self.table = grow_table(self.table, self.capacity, new_cap)
        self.capacity = new_cap

    def _ensure_window_capacity(self, n_rows: int, B: int) -> None:
        """Grow (doubling) until `n_rows` plus a full sync window's
        worst-case growth (2 rows/op) fits."""
        margin = 2 * B * self.sync_interval
        if n_rows + margin <= self.capacity:
            return
        new_cap = self.capacity
        while n_rows + margin > new_cap:
            new_cap *= 2
        self._grow(new_cap)

    # ------------------------------------------------------------- output

    def _host_table(self) -> dict:
        flat = _pack_table(self.table).cpu().numpy()  # ONE device->host pull
        return _unpack_table(flat, self.capacity, self.n_removers,
                             self.n_prop_keys)

    def _gather_text(self, buf: np.ndarray,
                     lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate the spans (buf[i], lens[i]) from both arenas into
        one contiguous array; returns (text, new_offsets)."""
        total = int(lens.sum())
        new_off = np.cumsum(lens) - lens
        if total == 0:
            return np.empty(0, np.int32), new_off.astype(np.int32)
        flat_src = np.repeat(buf, lens) + (
            np.arange(total) - np.repeat(new_off, lens)
        )
        out = np.empty(total, np.int32)
        in_stream = flat_src >= STREAM_BASE
        out[~in_stream] = self.doc_text[flat_src[~in_stream]]
        out[in_stream] = self.stream.text[flat_src[in_stream] - STREAM_BASE]
        return out, new_off.astype(np.int32)

    def _visible_rows(self, t: dict) -> np.ndarray:
        live = (np.arange(len(t["length"])) < t["n_rows"]) & (
            t["rem_seq"] == NOT_REMOVED
        )
        return np.nonzero(live)[0]

    def check_errors(self) -> None:
        raise_kernel_errors(int(self.table.error))

    def verify_invariants(self) -> None:
        verify_table_invariants(self._host_table(), self.capacity)

    def get_text(self) -> str:
        t = self._host_table()
        idx = self._visible_rows(t)
        text, _ = self._gather_text(
            t["buf_start"][idx], t["length"][idx].astype(np.int64)
        )
        return "".join(map(chr, text))

    def annotated_spans(self):
        """(text, props) per visible row, dictionary-decoded to the
        synthetic stream's key naming (k<idx>): the surface the scalar
        oracle's annotated_spans exposes, for digest comparison."""
        t = self._host_table()
        idx = self._visible_rows(t)
        text, offs = self._gather_text(
            t["buf_start"][idx], t["length"][idx].astype(np.int64)
        )
        spans = []
        lens = t["length"][idx]
        props = t["props"][idx]
        for i in range(len(idx)):
            chunk = "".join(map(chr, text[offs[i]: offs[i] + lens[i]]))
            p = {
                f"k{k}": int(props[i, k])
                for k in range(self.n_prop_keys)
                if props[i, k] != PROP_ABSENT
            }
            spans.append((chunk, p or None))
        return spans
