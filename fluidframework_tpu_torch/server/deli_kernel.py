"""The batched deli on one GPU: the sequencer kernel in the in-proc
ordering pipeline.

Copied from fluidframework_tpu/server/deli_kernel.py: `_pow2` (:96),
`_nack_reason` (:142), `SeqPool` (:158-652), `_FlatResults` (:654),
`PackedDeliCore` (:672-841) and `KernelDeliLambda` (:849-1030), on one
card. Left out: the mesh paths (``mesh=``, `_place`, `_grow_placed`,
`_scatter_rows_placed`, `mesh_for_devices`, `mesh_for_plane`,
``deli_devices``, ``device_plane``), the supervised `KernelDeliRole`
with its columnar emit, and the ``utils/metrics`` instruments; see
ROADMAP.md Queue 1 items 9 and 10.

The scalar deli tickets one raw record at a time through a per-document
`DocumentSequencer`. Here a pump drains the raw topic in micro-batches,
maps string doc ids to dense document slots, packs the submissions
into ``[D, B]`` chunks, runs each chunk as one launch of the sequencer
kernel (`ops.sequencer_kernel`), reads the verdicts back in one copy,
and appends the stamped messages and nacks with one `append_many` per
pump.

Division of labour, as in the reference:

- decisions on the device: stamp / nack / skip verdicts, boxcar aborts
  included, come from the kernel;
- bookkeeping from results: the host keeps a per-document mirror (head
  seq, MSN, connected clients' ref/client seqs) updated only from
  verdicts. Checkpoints are pure host work in
  `DocumentSequencer.checkpoint()` format, so the scalar deli, the JAX
  kernel deli and this one restore each other's checkpoints.

Document slots grow by doubling and evict for free: parking a document
frees its slot (the mirror is authoritative for parked documents);
touching it again queues its row for the one batched scatter before
the next launch.

`SeqPool.times`, when set to a dict, accumulates the host time of each
stage of a pump (plan, prepare, pack, upload, launch, read, emit; in
seconds, by the host clock); None (the default) measures nothing. The
launch stage is the launch call's host time (on the CPU the plain
version's); the kernel's device time is not a stage here: a profiler
reads it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import sequencer_kernel as _sk
from ..ops.sequencer_kernel import (
    NO_GROUP,
    SUB_JOIN,
    SUB_LEAVE,
    SUB_OP,
    SUB_SYSTEM,
)
from ..protocol.messages import (
    MessageType,
    NackMessage,
    SequencedMessage,
    trace_submit_ts,
)
from ..utils.devices import DeviceLike, resolve_device
from .log import LogConsumer, MessageLog
from .sequencer import (
    NACK_FUTURE_REFSEQ,
    NACK_STALE_REFSEQ,
    NACK_UNKNOWN_CLIENT,
    future_refseq_reason,
    out_of_order_reason,
    stale_refseq_reason,
    unwrap_ranged_state,
)

__all__ = ["KernelDeliLambda", "PackedDeliCore", "SeqPool"]

SYSTEM_CLIENT = -1  # the scalar deli's system client id

TIME_KEYS = ("plan_s", "prepare_s", "pack_s", "upload_s", "launch_s",
             "read_s", "emit_s")


def new_times() -> Dict[str, float]:
    """A zeroed stage-time accumulator for `SeqPool.times`."""
    return dict.fromkeys(TIME_KEYS, 0.0)


def _pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def _nack_reason(code: int, ref: int, msn: int, head: int, cseq: int,
                 expected: Optional[int]) -> str:
    """The scalar sequencer's nack wording, rebuilt from the kernel
    verdict and the host mirror (codes are the contract; text is for
    humans)."""
    if code == NACK_UNKNOWN_CLIENT:
        return "unknown client"
    if code == NACK_STALE_REFSEQ:
        return stale_refseq_reason(ref, msn)
    if code == NACK_FUTURE_REFSEQ:
        return future_refseq_reason(ref, head)
    if expected is not None:
        return out_of_order_reason(cseq, expected)
    return f"clientSeq {cseq} out of order"


class SeqPool:
    """Dense [D, C] kernel-state pool with doc-slot grow/evict and
    scalar-format checkpoints, on one device.

    The device state is authoritative for verdicts; `docs` is the host
    mirror (seq head, MSN, per-client ref/client seqs) maintained from
    verdicts, authoritative for checkpoints and for parked (evicted)
    documents. Slots are recycled: parking costs nothing (the row is
    overwritten on the next load), touching a parked doc queues a row
    scatter that runs in one batched write before the next launch.
    """

    def __init__(self, n_docs: int = 8, n_clients: int = 8,
                 max_resident: Optional[int] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.n_docs = max(1, n_docs)
        self.n_clients = _pow2(max(2, n_clients), lo=2)
        self.state = _sk.make_state(self.n_docs, self.n_clients, self.device)
        self.max_resident = max_resident
        # doc_id -> {"slot": int|None, "seq", "min_seq",
        #            "clients": {cid: [ref_seq, client_seq]}, "cmap", "t"}
        self.docs: Dict[str, dict] = {}
        self.slot_owner: Dict[int, str] = {}
        self.free: List[int] = list(range(self.n_docs - 1, -1, -1))
        self._loads: List[Tuple[int, dict]] = []
        self._need_clients = self.n_clients
        self._clock = 0
        self._active: set = set()
        self.chunks = 0  # chunks run (one kernel launch each on the card)
        self.max_cols_seen = 0  # the widest chunk's B
        self.times: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------ slots

    def begin(self) -> None:
        self._active.clear()

    def touch(self, doc_id: str) -> dict:
        """Resident host-mirror entry for `doc_id` (its ``"slot"`` is
        the kernel row; ``"cmap"`` maps client ids to dense columns:
        column 0 is the never-connected scratch column that ops from
        unknown or foreign client ids address, so any id gets the
        oracle's unknown-client verdict without aliasing a real
        client's state)."""
        h = self.docs.get(doc_id)
        if h is None:
            h = {"slot": None, "seq": 0, "min_seq": 0, "clients": {},
                 "cmap": {}, "t": 0}
            self.docs[doc_id] = h
        elif len(h["cmap"]) > 2 * len(h["clients"]) + 8:
            # A high-churn doc whose column map has outgrown its live
            # clients reclaims departed clients' columns. Safe here:
            # touch() runs once per doc per pump, before any of this
            # pump's submissions read the map.
            self.compact_doc(doc_id)
        if h["slot"] is None:
            slot = self._alloc()
            h["slot"] = slot
            self.slot_owner[slot] = doc_id
            self._loads.append((slot, h))
        self._clock += 1
        h["t"] = self._clock
        self._active.add(doc_id)
        return h

    def col_of_join(self, h: dict, cid) -> int:
        """The client's dense column, assigned on first join (columns
        are per-doc monotone, like the scalar per-doc client dict)."""
        cmap = h["cmap"]
        col = cmap.get(cid)
        if col is None:
            col = cmap[cid] = len(cmap) + 1  # col 0 is scratch
        return col

    def _alloc(self) -> int:
        # Soft resident budget: once resident docs reach max_resident,
        # every new residency first parks the coldest doc not touched
        # this pump and reuses its slot (actives cannot be parked; the
        # pool grows to cover a pump whose active set exceeds the cap).
        if (self.max_resident is not None
                and len(self.slot_owner) >= self.max_resident):
            # Victim: a doc whose MSN has caught its head (quiescent)
            # goes before any still-lagging doc; LRU by pump breaks ties
            # and is the fallback when nothing is cold.
            victim = None
            victim_key = None
            for doc_id, h in self.docs.items():
                if h["slot"] is None or doc_id in self._active:
                    continue
                key = (not h["min_seq"] >= h["seq"], h["t"])
                if victim_key is None or key < victim_key:
                    victim, victim_key = doc_id, key
            if victim is not None:
                self.park(victim)
        if not self.free:
            old = self.n_docs
            self.n_docs = max(8, old * 2)
            self.free.extend(range(self.n_docs - 1, old - 1, -1))
        return self.free.pop()

    def park(self, doc_id: str) -> None:
        """Evict a document's slot. Free: the host mirror is complete,
        so the stale device row is abandoned until the slot's next
        occupant scatters over it."""
        h = self.docs[doc_id]
        slot = h["slot"]
        if slot is None:
            return
        h["slot"] = None
        self.slot_owner.pop(slot, None)
        self.free.append(slot)
        if self._loads:
            # Drop any queued reload for the freed slot: its next
            # occupant queues its own, and a stale one would race it in
            # the batched scatter (duplicate indices).
            self._loads = [(s, hh) for s, hh in self._loads if s != slot]

    # ------------------------------------------------- column compaction

    def compact_doc(self, doc_id: str) -> int:
        """Reclaim departed clients' columns in this doc's client-id to
        column map: the map is rebuilt over live clients only (relative
        order kept), and a resident doc queues a full row reload so the
        device row matches the new layout before the next launch.
        Returns the number of columns reclaimed."""
        h = self.docs.get(doc_id)
        if h is None:
            return 0
        cmap = h["cmap"]
        live = h["clients"]
        reclaimed = len(cmap) - len(live)
        if reclaimed <= 0:
            return 0
        h["cmap"] = {
            cid: i + 1  # col 0 stays the never-connected scratch column
            for i, cid in enumerate(sorted(live, key=cmap.__getitem__))
        }
        if h["slot"] is not None:
            self._loads.append((h["slot"], h))
        return reclaimed

    def compact_all(self) -> int:
        """Checkpoint-time sweep: compact every doc's column map."""
        return sum(self.compact_doc(d) for d in list(self.docs))

    def resident_docs(self) -> int:
        return len(self.slot_owner)

    def note_client(self, client_id: int) -> None:
        if client_id >= self._need_clients:
            self._need_clients = client_id + 1

    # -------------------------------------------------------- device ops

    def prepare(self) -> None:
        """Grow the state to the logical (D, C) and write the queued
        doc rows in one batched scatter (`index_put_` on the device)."""
        need_c = _pow2(self._need_clients, self.n_clients)
        d, c = self.state.connected.shape
        if self.n_docs != d or need_c != c:
            self.state = _sk.grow_state(self.state, self.n_docs, need_c)
            self.n_clients = need_c
        if not self._loads:
            return
        n, C = len(self._loads), self.n_clients
        idx = np.empty(n, np.int64)
        seqv = np.empty(n, np.int32)
        minv = np.empty(n, np.int32)
        conn = np.zeros((n, C), bool)
        ref = np.zeros((n, C), np.int32)
        cseq = np.zeros((n, C), np.int32)
        for i, (slot, h) in enumerate(self._loads):
            idx[i] = slot
            seqv[i] = h["seq"]
            minv[i] = h["min_seq"]
            cmap = h["cmap"]
            for cid, (r, cs) in h["clients"].items():
                col = cmap[cid]
                conn[i, col] = True
                ref[i, col] = r
                cseq[i, col] = cs
        self._loads = []
        dev = self.device
        at = (torch.from_numpy(idx).to(dev),)
        for field, vals in zip(self.state, (seqv, minv, conn, ref, cseq)):
            field.index_put_(at, torch.from_numpy(vals).to(dev))

    def run_chunk(self, kind, client, cseq, ref, groups, dedup: bool,
                  aborted=None):
        """One launch: upload the five [D, B] columns in one copy, run
        the kernel (the plain version on the CPU), read the verdicts
        back in one copy. `aborted` threads the boxcar-abort tracker
        (a device tensor) across a pump's chunks. Returns (SeqResult
        as numpy, tracker)."""
        t = self.times
        dev = self.device
        D, B = kind.shape
        if t is not None:
            t0 = time.perf_counter()
        cols = torch.from_numpy(
            np.stack((kind, client, cseq, ref, groups))).to(dev)
        if aborted is None:
            aborted = _sk.no_aborts(self.n_docs, dev)
        buf, out = _sk.alloc_result(D, B, dev)
        if t is not None:
            t1 = time.perf_counter()
            t["upload_s"] += t1 - t0
        self.state, aborted, _ = _sk.sequence_batch_grouped(
            self.state, _sk.SeqBatch(*cols[:4]), cols[4], dedup, aborted,
            out=out)
        if t is not None:
            t2 = time.perf_counter()
            t["launch_s"] += t2 - t1
        res = _sk.read_result(buf, D, B)
        if t is not None:
            t["read_s"] += time.perf_counter() - t2
        self.chunks += 1
        self.max_cols_seen = max(self.max_cols_seen, B)
        return res, aborted

    # ---------------------------------------------------- verdict mirror

    def head(self, doc_id: str) -> int:
        return self.docs[doc_id]["seq"]

    def expected_cseq(self, doc_id: str, client_id: int) -> Optional[int]:
        st = self.docs[doc_id]["clients"].get(client_id)
        return st[1] + 1 if st is not None else None

    def apply_join(self, doc_id: str, cid: int, seq: int, msn: int) -> None:
        h = self.docs[doc_id]
        h["clients"][cid] = [seq - 1, 0]
        h["seq"], h["min_seq"] = seq, msn

    def apply_leave(self, doc_id: str, cid: int, seq: int, msn: int) -> None:
        h = self.docs[doc_id]
        h["clients"].pop(cid, None)
        h["seq"], h["min_seq"] = seq, msn

    def apply_op(self, doc_id: str, cid: int, seq: int, msn: int,
                 cseq: int, ref: int) -> None:
        h = self.docs[doc_id]
        h["clients"][cid] = [ref, cseq]
        h["seq"], h["min_seq"] = seq, msn

    def apply_stamp(self, doc_id: str, seq: int, msn: int) -> None:
        h = self.docs[doc_id]
        h["seq"], h["min_seq"] = seq, msn

    # -------------------------------------------------------- checkpoint

    def checkpoint_docs(self) -> dict:
        """Per-doc state in `DocumentSequencer.checkpoint()` format."""
        return {
            doc_id: {
                "doc_id": doc_id,
                "seq": h["seq"],
                "min_seq": h["min_seq"],
                "clients": {
                    str(cid): {
                        "ref_seq": rc[0], "client_seq": rc[1],
                        "last_update": 0.0,
                    }
                    for cid, rc in h["clients"].items()
                },
            }
            for doc_id, h in self.docs.items()
        }

    def restore_docs(self, docs: Optional[dict]) -> None:
        for doc_id, st in (docs or {}).items():
            clients = {
                int(cid): [int(v["ref_seq"]), int(v["client_seq"])]
                for cid, v in st["clients"].items()
            }
            self.docs[doc_id] = {
                "slot": None, "seq": int(st["seq"]),
                "min_seq": int(st["min_seq"]), "clients": clients,
                "cmap": {cid: i + 1 for i, cid in enumerate(clients)},
                "t": 0,
            }
            self.note_client(len(clients) + 1)


class _FlatResults:
    """Kernel verdicts for one pump, aligned with the submission index
    `add()`/`add_columns()` returned: flat Python lists, or numpy
    arrays with ``run(as_arrays=True)``."""

    __slots__ = ("seq", "msn", "nack", "skipped")

    def __init__(self, seq, msn, nack, skipped):
        self.seq = seq
        self.msn = msn
        self.nack = nack
        self.skipped = skipped


class PackedDeliCore:
    """Pack, launch, gather: the engine under the deli frontend.

    Per pump: `begin()`, then `touch`/`add` append submissions to flat
    columnar segments (a few list appends per record); `run()` does the
    rest vectorized (per-doc column assignment, [D, B] scatter, verdict
    gather), runs the chunks in order (the boxcar-abort tracker threads
    across chunks, so groups may span them), and returns verdicts
    aligned with the submission indices."""

    def __init__(self, n_docs: int = 8, n_clients: int = 8,
                 max_resident: Optional[int] = None, max_cols: int = 256,
                 dedup: bool = False, device: DeviceLike = None):
        self.pool = SeqPool(n_docs, n_clients, max_resident, device=device)
        self.max_cols = max(8, max_cols)
        self.dedup = dedup
        # Ordered segments: lists of per-record tuples (`add`)
        # interleaved with pre-columnized (n, 6) arrays (`add_columns`).
        self._segments: List[Any] = []
        self._n_subs = 0
        self._gctr: Dict[int, int] = {}

    def begin(self) -> None:
        self.pool.begin()
        self._segments = []
        self._n_subs = 0
        self._gctr = {}

    def touch(self, doc_id: str) -> dict:
        """The doc's host-mirror entry (slot + client column map)."""
        return self.pool.touch(doc_id)

    def add(self, slot: int, kind: int, client: int = 0, cseq: int = 0,
            ref: int = 0, group: int = NO_GROUP) -> int:
        """Queue one submission; `client` is the doc's dense column
        (from the cmap / `col_of_join`, 0 = scratch). Returns the
        submission's verdict index."""
        pool = self.pool
        if client >= pool._need_clients:
            pool._need_clients = client + 1
        segs = self._segments
        if not segs or not isinstance(segs[-1], list):
            segs.append([])
        segs[-1].append((slot, kind, client, cseq, ref, group))
        j = self._n_subs
        self._n_subs = j + 1
        return j

    def add_columns(self, slot, kind, client, cseq, ref,
                    group=NO_GROUP) -> int:
        """Bulk-queue pre-columnized submissions: equal-length 1-D
        sequences (or scalars, broadcast) of doc slots, SUB_* kinds,
        dense client columns, clientSeqs and refSeqs. Returns the first
        verdict index (submission i's verdict is at return + i)."""
        slot = np.asarray(slot, np.int64)
        n = slot.shape[0]
        cols = np.empty((n, 6), np.int64)
        cols[:, 0] = slot
        cols[:, 1] = kind
        cols[:, 2] = client
        cols[:, 3] = cseq
        cols[:, 4] = ref
        cols[:, 5] = group
        if n:
            self.pool.note_client(int(cols[:, 2].max()))
        self._segments.append(cols)
        j = self._n_subs
        self._n_subs = j + n
        return j

    def new_group(self, slot: int) -> int:
        """A fresh boxcar group id, unique per doc within this pump."""
        g = self._gctr.get(slot, 0)
        self._gctr[slot] = g + 1
        return g

    def add_boxcar(self, slot: int, ops: List[Tuple[int, int, int]]):
        """Pack one atomic boxcar: `ops` is [(column, cseq, ref)]; a
        nack masks out the group's tail. Returns the verdict indices."""
        g = self.new_group(slot)
        add = self.add
        return [add(slot, SUB_OP, col, cs, rf, g) for col, cs, rf in ops]

    def run(self, as_arrays: bool = False) -> _FlatResults:
        pool = self.pool
        t = pool.times
        if t is not None:
            t0 = time.perf_counter()
        pool.prepare()
        if t is not None:
            t1 = time.perf_counter()
            t["prepare_s"] += t1 - t0
            inner0 = t["upload_s"] + t["launch_s"] + t["read_s"]
        n = self._n_subs
        if n == 0:
            if as_arrays:
                z32 = np.zeros(0, np.int32)
                return _FlatResults(z32, z32, z32, np.zeros(0, bool))
            return _FlatResults([], [], [], [])
        parts = [
            np.asarray(s, np.int64).reshape(-1, 6) for s in self._segments
        ]
        cols6 = parts[0] if len(parts) == 1 else np.concatenate(parts)
        self._segments = []
        self._n_subs = 0
        self._gctr = {}
        seq_o = np.empty(n, np.int32)
        msn_o = np.empty(n, np.int32)
        nack_o = np.empty(n, np.int32)
        skip_o = np.empty(n, bool)
        aborted = None
        for sel, sl, ic, kind, client, cseq, ref, grp in \
                _sk.pack_submissions(
                    cols6[:, 0], cols6[:, 1], cols6[:, 2], cols6[:, 3],
                    cols6[:, 4], cols6[:, 5], pool.n_docs, self.max_cols,
                ):
            res, aborted = pool.run_chunk(
                kind, client, cseq, ref, grp, self.dedup, aborted
            )
            seq_o[sel] = res.seq[sl, ic]
            msn_o[sel] = res.min_seq[sl, ic]
            nack_o[sel] = res.nack[sl, ic]
            skip_o[sel] = res.skipped[sl, ic]
        if as_arrays:
            out = _FlatResults(seq_o, msn_o, nack_o, skip_o)
        else:
            out = _FlatResults(seq_o.tolist(), msn_o.tolist(),
                               nack_o.tolist(), skip_o.tolist())
        if t is not None:
            inner = t["upload_s"] + t["launch_s"] + t["read_s"] - inner0
            t["pack_s"] += time.perf_counter() - t1 - inner
        return out


# ---------------------------------------------------------------------------
# in-proc frontend
# ---------------------------------------------------------------------------


class KernelDeliLambda:
    """Drop-in for the scalar in-proc `DeliLambda`: same topics, same
    deltas entries (`SequencedMessage` / `NackMessage`), same
    checkpoint shape; sequencing decisions on the device. Runs on
    ``cuda`` unless given ``device="cpu"`` (the plain version)."""

    def __init__(self, log: MessageLog, checkpoint: Optional[dict] = None,
                 max_pump: int = 8192, n_docs: int = 8, n_clients: int = 8,
                 max_resident: Optional[int] = None, max_cols: int = 256,
                 raw_topic: str = "rawdeltas", device: DeviceLike = None):
        """`raw_topic` names the ingress topic (the sharded server's
        per-partition ``rawdeltas-p{k}`` form). The checkpoint shape is
        the scalar deli's, so restores interoperate across the scalar,
        the JAX kernel and this deli."""
        self.core = PackedDeliCore(
            n_docs, n_clients, max_resident, max_cols, dedup=False,
            device=device,
        )
        offset = 0
        if checkpoint:
            offset = checkpoint["offset"]
            self.core.pool.restore_docs(
                unwrap_ranged_state(checkpoint["docs"])
            )
        self.consumer = LogConsumer(log.topic(raw_topic), offset)
        self.deltas = log.topic("deltas")
        self.max_pump = max_pump

    def pump(self, max_count: Optional[int] = None) -> int:
        """Drain up to `max_count` raw records (micro-batch cap: a deep
        backlog yields between pumps instead of starving the caller)."""
        cap = self.max_pump if max_count is None else max_count
        raws = self.consumer.poll(cap)
        if not raws:
            return 0
        out = self._process(raws)
        if out:
            self.deltas.append_many(out)
        return len(raws)

    def _process(self, raws: List[dict]) -> List[dict]:
        core = self.core
        pool = core.pool
        t = pool.times
        if t is not None:
            t0 = time.perf_counter()
        core.begin()
        touch, add, col_of_join = core.touch, core.add, pool.col_of_join
        docs_cache: Dict[str, tuple] = {}  # touch once per doc per pump
        plan: List[tuple] = []
        append = plan.append
        for raw in raws:
            if not isinstance(raw, dict) or not raw.get("doc"):
                continue  # journal LOST_RECORD placeholder / junk
            doc_id = raw["doc"]
            ent = docs_cache.get(doc_id)
            if ent is None:
                h = touch(doc_id)
                ent = docs_cache[doc_id] = (h["slot"], h)
            slot, h = ent
            cmap = h["cmap"]
            kind = raw["kind"]
            if kind == "join":
                cid = raw["client"]
                append((doc_id, add(slot, SUB_JOIN, col_of_join(h, cid)),
                        "join", cid, None))
            elif kind == "leave":
                cid = raw["client"]
                # Unknown client -> scratch column -> nothing stamped.
                append((doc_id, add(slot, SUB_LEAVE, cmap.get(cid, 0)),
                        "leave", cid, None))
            elif kind == "control":
                append((doc_id, add(slot, SUB_SYSTEM), "sys",
                        raw["type"], raw["contents"]))
            elif kind == "boxcar":
                cid = raw["client"]
                msgs = raw["msgs"]
                col = cmap.get(cid, 0)
                handles = core.add_boxcar(
                    slot, [(col, m.client_seq, m.ref_seq) for m in msgs]
                )
                for hd, m in zip(handles, msgs):
                    append((doc_id, hd, "op", cid, m))
            else:  # client op; unknown -> scratch column -> 403 nack
                cid = raw["client"]
                msg = raw["msg"]
                append((doc_id, add(slot, SUB_OP, cmap.get(cid, 0),
                                    msg.client_seq, msg.ref_seq),
                        "op", cid, msg))
        if t is not None:
            t["plan_s"] += time.perf_counter() - t0
        res = core.run()
        if t is not None:
            t0 = time.perf_counter()

        out: List[dict] = []
        emit = out.append
        seqs, msns, nacks, skips = res.seq, res.msn, res.nack, res.skipped
        apply_op = pool.apply_op
        ts = time.time()
        for doc_id, handle, tag, a, b in plan:
            if tag == "op":
                if skips[handle]:
                    continue
                seq, msn, nack = seqs[handle], msns[handle], nacks[handle]
                if nack:
                    reason = _nack_reason(
                        nack, b.ref_seq, msn, pool.head(doc_id),
                        b.client_seq, pool.expected_cseq(doc_id, a),
                    )
                    emit({"doc": doc_id, "kind": "nack", "client": a,
                          "msg": NackMessage(a, b.client_seq, nack, reason)})
                    continue
                apply_op(doc_id, a, seq, msn, b.client_seq, b.ref_seq)
                # The scalar deli's op-lifecycle trace (observability
                # only: excluded from every digest form).
                tr = [("stamp", ts)]
                sub = trace_submit_ts(b.metadata)
                if sub is not None:
                    tr.insert(0, ("submit", sub))
                emit({"doc": doc_id, "kind": "op",
                      "msg": SequencedMessage(
                          seq, msn, a, b.client_seq, b.ref_seq,
                          b.type, b.contents, b.metadata, b.address, ts,
                          tr)})
            elif tag == "join":
                seq, msn = seqs[handle], msns[handle]
                pool.apply_join(doc_id, a, seq, msn)
                emit({"doc": doc_id, "kind": "op",
                      "msg": SequencedMessage(
                          seq, msn, a, 0, seq - 1,
                          MessageType.CLIENT_JOIN, a, None, None, ts,
                          [("stamp", ts)])})
            elif tag == "leave":
                seq, msn = seqs[handle], msns[handle]
                if seq == 0:
                    continue  # unknown client: oracle stamps nothing
                pool.apply_leave(doc_id, a, seq, msn)
                emit({"doc": doc_id, "kind": "op",
                      "msg": SequencedMessage(
                          seq, msn, a, 0, seq - 1,
                          MessageType.CLIENT_LEAVE, a, None, None, ts,
                          [("stamp", ts)])})
            else:  # sys
                seq, msn = seqs[handle], msns[handle]
                pool.apply_stamp(doc_id, seq, msn)
                emit({"doc": doc_id, "kind": "op",
                      "msg": SequencedMessage(
                          seq, msn, SYSTEM_CLIENT, 0, seq - 1,
                          a, b, None, None, ts, [("stamp", ts)])})
        if t is not None:
            t["emit_s"] += time.perf_counter() - t0
        return out

    def checkpoint(self) -> dict:
        """Same shape as the scalar `DeliLambda.checkpoint()` (offset +
        per-doc `DocumentSequencer` states). Checkpoint time is also the
        column-compaction sweep: the state written never names departed
        clients."""
        self.core.pool.compact_all()
        return {
            "offset": self.consumer.checkpoint(),
            "docs": self.core.pool.checkpoint_docs(),
        }
