"""Row-model replay engine on PyTorch: the chunk-kernel path.

Counterpart of fluidframework_tpu/core/columnar_replay.py, engine
``pallas``. `ColumnarReplica` consumes a pre-decoded `ColumnarStream`
and keeps the whole document as a `SegmentTable` on the device (rows
in document order, one row per segment). The NOOP-padded op stream
uploads in segments; each chunk of ops is one `apply_chunk_at` (the
hand-written CUDA kernel ``csrc/mergetree_chunk.cu`` on the card, its
plain PyTorch version on the CPU), and every `sync_interval` chunks
`compact_gather_text` drops settled tombstones, re-gathers the live
text into a fresh arena and coalesces settled runs. The host reads
``n_rows`` and the error word once per sync window (the capacity
check); nothing else leaves the device inside the loop.

Two text address spaces share the int32 offset coordinate: compacted
document text lives at ``[0, STREAM_BASE)`` (the device arena) and the
immutable stream-insert text at ``[STREAM_BASE, ...)``.

A ``device=`` argument takes the place of the JAX version's
``engine=`` / ``interpret=``: ``cuda`` (the default) launches the
kernel, ``"cpu"`` runs the plain version. Not ported: the ``scan``
engine, `_apply_chunk`, the host `compact()` and `compact_watermark`
(all of them need the scan kernel `apply_op_batch`).
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


class ColumnarReplica:
    """Device-resident row-model replica driven by columnar op arrays.

    Same output surface as the JAX `ColumnarReplica` (get_text /
    annotated_spans / check_errors), so the digest gates compare the
    engines directly. `device` is ``cuda`` by default (raising when
    there is none) or an explicit ``"cpu"``.
    """

    def __init__(
        self,
        stream: ColumnarStream,
        initial_len: int = 0,
        chunk_size: int = 1024,
        capacity: int = 16384,
        n_removers: int = 4,
        n_prop_keys: int = 8,
        sync_interval: int = 4,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.stream = stream
        self.chunk_size = chunk_size
        self.capacity = capacity
        self.n_removers = n_removers
        self.n_prop_keys = n_prop_keys
        self.sync_interval = sync_interval

        # Document arena: compacted text (region [0, STREAM_BASE)).
        self._initial_text = np.asarray(stream.text[:initial_len], np.int32)
        self.table = make_table(capacity, n_removers, n_prop_keys,
                                device=self.device)
        if initial_len:
            self.table.n_rows.fill_(1)
            self.table.length[0] = initial_len
            self.table.ins_seq[0] = UNIVERSAL_SEQ
            self.table.ins_client[0] = NO_CLIENT
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
        """The document arena on the host: the initial text until the
        device arena exists, then a pull of it."""
        if self.arena is None:
            return self._initial_text
        return self.arena.cpu().numpy()

    # -------------------------------------------------------------- replay

    def op_segment(self, lo: int, hi: int) -> OpBatch:
        """Ops ``[lo, hi)`` on the device, NOOP-padded to whole
        segments (insert offsets rebased into the stream region): one
        upload per column."""
        s = self.stream
        seg = -(-SEG_OPS // self.chunk_size) * self.chunk_size
        size = max(1, -(-(hi - lo) // seg)) * seg
        fills = {"op_type": OP_NOOP, "client": NO_CLIENT,
                 "prop_key": NO_KEY, "prop_val": PROP_ABSENT}

        def up(name: str, a: np.ndarray) -> torch.Tensor:
            out = np.full(size, fills.get(name, 0), np.int32)
            out[: hi - lo] = a[lo:hi]
            return torch.from_numpy(out).to(self.device)

        return OpBatch(
            op_type=up("op_type", s.op_type),
            pos1=up("pos1", s.pos1), pos2=up("pos2", s.pos2),
            seq=up("seq", s.seq), ref_seq=up("ref_seq", s.ref_seq),
            client=up("client", s.client),
            buf_start=up("buf", s.buf_start + STREAM_BASE),
            ins_len=up("ins_len", s.ins_len),
            prop_keys=up("prop_key", s.prop_key)[:, None],
            prop_vals=up("prop_val", s.prop_val)[:, None],
        )

    def _prepare_text(self) -> None:
        """The device doc arena (sized initial_len + len(stream text),
        which no live document can exceed, so it never grows) and the
        padded stream text."""
        s = self.stream
        if self.arena is None:
            init = self._initial_text
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
        replay."""
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
