"""The batched deli on the GPU: the sequencer kernel in the in-proc
ordering pipeline and in the supervised farm's deli role.

Copied from fluidframework_tpu/server/deli_kernel.py: `_pow2` (:96),
`_mul_of` (:103), `mesh_for_devices` (:109), `mesh_for_plane` (:122),
`_nack_reason` (:142), `SeqPool` (:158-652) with its sharded pool
(``mesh=``, `_place`, `_grow_placed`, `_scatter_rows_placed`),
`_FlatResults` (:654), `PackedDeliCore` (:672-841), `KernelDeliLambda`
(:849-1030), `_ScalarEmit` (:1043-1120) and `KernelDeliRole`
(:1122-1639), with the pool's, core's and role's ``utils.metrics``
instruments. The supervisor's ``--deli-devices`` / ``--device-plane``
child seams reach the role through `supervisor.serve_role`. Left out:
the farm wiring around the role (the other roles and
`ServiceSupervisor`: ROADMAP.md Queue 1 item 4).

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

Two frontends wrap the shared `PackedDeliCore`:

- `KernelDeliLambda`, the in-proc deli: same deltas entries
  (`SequencedMessage` / `NackMessage`) and checkpoint shape as the
  scalar `DeliLambda`;
- `KernelDeliRole`, the supervised farm's deli (`supervisor._Role`):
  the scalar `DeliRole`'s wire records, each with its input offset
  (``inOff``), so the role's fenced exactly-once recovery holds. Over
  a columnar topic it takes whole `RecordBatch` frames, plans runs of
  plain ops as arrays, and emits `ColumnarRecords` parts whose op
  contents pass through as the input's JSON bytes.

Document slots grow by doubling and evict for free: parking a document
frees its slot (the mirror is authoritative for parked documents);
touching it again queues its row for the one batched scatter before
the next launch.

A pool given a mesh (`parallel.mesh.DocsMesh`: ``deli_devices=N`` or
a device plane's sequencer slice) splits its ``[D, C]`` rows into one
slab per entry, and each chunk is one sequencer launch per slab on the
entry's stream (`ops.sequencer_kernel.sharded_sequence_fn`). The host
mirror, slot allocation, grow / evict / park and the checkpoint format
are the single-device pool's: sharding changes only where slot rows
live, so checkpoints restore across topologies.

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
from ..protocol import record_batch as _rb
from ..protocol.messages import (
    MessageType,
    NackMessage,
    SequencedMessage,
    trace_submit_ts,
)
from ..utils.devices import DeviceLike, resolve_device
from ..utils.metrics import get_registry
from .columnar_log import ColumnarFileTopic
from .log import LogConsumer, MessageLog
from .sequencer import (
    NACK_FUTURE_REFSEQ,
    NACK_STALE_REFSEQ,
    NACK_UNKNOWN_CLIENT,
    future_refseq_reason,
    out_of_order_reason,
    stale_refseq_reason,
)
from .supervisor import _Role, unwrap_ranged_state

__all__ = ["KernelDeliLambda", "KernelDeliRole", "PackedDeliCore",
           "SeqPool"]

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


def _mul_of(n: int, m: int) -> int:
    """n rounded up to a multiple of m (the docs-axis constraint: every
    entry owns the same number of slot rows)."""
    return n if m <= 1 else ((n + m - 1) // m) * m


def mesh_for_devices(deli_devices: Optional[int],
                     device: DeviceLike = None):
    """The mesh a ``deli_devices=N`` option resolves to: None for the
    single-device pool (N absent or 1), else the process-wide shared
    docs mesh of N entries on `device` (None: CUDA, raising where there
    is none)."""
    if deli_devices is None or int(deli_devices) <= 1:
        return None
    from ..parallel.mesh import shared_docs_mesh

    return shared_docs_mesh(int(deli_devices), device)


def mesh_for_plane(device_plane, plane_column: Optional[int] = None,
                   partition_key=None, env: bool = False,
                   device: DeviceLike = None):
    """The sequencer's slice of a device plane
    (`parallel.device_plane.DevicePlane`): a docs mesh over one model
    column (one partition = one worker = one mesh slice). The column is
    `plane_column`, else derived from the partition key (stable hash),
    else 0; ``env=True`` lets farm children inherit the supervisor's
    plane from ``FLUID_DEVICE_PLANE``. None when no plane is set."""
    from ..parallel.device_plane import plane_column_of, resolve_plane

    plane = resolve_plane(device_plane, env=env, device=device)
    if plane is None:
        return None
    if plane_column is None:
        plane_column = (plane_column_of(partition_key, plane.model)
                        if partition_key is not None else 0)
    return plane.seq_mesh(plane_column)


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
    scalar-format checkpoints, on one device or over a mesh.

    The device state is authoritative for verdicts; `docs` is the host
    mirror (seq head, MSN, per-client ref/client seqs) maintained from
    verdicts, authoritative for checkpoints and for parked (evicted)
    documents. Slots are recycled: parking costs nothing (the row is
    overwritten on the next load), touching a parked doc queues a row
    scatter that runs in one batched write before the next launch.
    """

    def __init__(self, n_docs: int = 8, n_clients: int = 8,
                 max_resident: Optional[int] = None,
                 device: DeviceLike = None, mesh=None):
        """`mesh` (a `parallel.mesh.DocsMesh`) splits the pool over its
        entries: `n_docs` is kept a multiple of ``mesh.size`` and the
        state becomes one slab per entry at the first `prepare`;
        `device` is then the first entry's. Without a mesh the pool
        lives on `device` (None: CUDA, raising where there is none)."""
        self.mesh = mesh
        self._n_shards = mesh.size if mesh is not None else 1
        self.device = (mesh.entries[0] if mesh is not None
                       else resolve_device(device))
        self.n_docs = _mul_of(max(1, n_docs), self._n_shards)
        self.n_clients = _pow2(max(2, n_clients), lo=2)
        # The whole state until placed; then a list of per-entry slabs
        # (sharded pools), kept so between pumps.
        self.state = _sk.make_state(self.n_docs, self.n_clients, self.device)
        self._placed = False
        # Logical slot -> physical state row. Identity until a placed
        # grow: growing a sharded pool pads each entry's slab on that
        # entry, which renumbers the row space per slab; the mirror and
        # free list keep stable logical slots and this map translates
        # at the kernel boundary (pack and row scatter).
        self._phys = np.arange(self.n_docs, dtype=np.int64)
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
        # Pool instruments: per-event counters here; the occupancy
        # gauges are refreshed once per pump by the core.
        m = get_registry()
        self._m_grows = m.counter("deli_pool_grows_total")
        self._m_evicts = m.counter("deli_pool_evictions_total")
        # Which policy picked each eviction victim, how cold the
        # resident set looked at decision time, and how many client
        # columns compaction reclaimed.
        self._m_evict_policy = {
            p: m.counter("deli_pool_evictions_by_policy_total", policy=p)
            for p in ("msn_cold", "lru")
        }
        self._m_cold = m.gauge("deli_pool_cold_resident_docs")
        self._m_reclaims = m.counter("deli_pool_col_reclaims_total")
        self._m_compactions = m.counter("deli_pool_compactions_total")

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
            cold_resident = 0
            for doc_id, h in self.docs.items():
                if h["slot"] is None:
                    continue
                cold = h["min_seq"] >= h["seq"]
                if cold:
                    cold_resident += 1
                if doc_id in self._active:
                    continue
                key = (not cold, h["t"])
                if victim_key is None or key < victim_key:
                    victim, victim_key = doc_id, key
            self._m_cold.set(cold_resident)
            if victim is not None:
                self.park(
                    victim,
                    policy="lru" if victim_key[0] else "msn_cold",
                )
        if not self.free:
            old = self.n_docs
            self.n_docs = _mul_of(max(8, old * 2), self._n_shards)
            self.free.extend(range(self.n_docs - 1, old - 1, -1))
            self._m_grows.inc()
        return self.free.pop()

    def park(self, doc_id: str, policy: Optional[str] = None) -> None:
        """Evict a document's slot. Free: the host mirror is complete,
        so the stale device row is abandoned until the slot's next
        occupant scatters over it. `policy` records which rule picked
        the victim (msn_cold / lru) for the pool's counters."""
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
        self._m_evicts.inc()
        if policy is not None:
            self._m_evict_policy[policy].inc()

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
        self._m_reclaims.inc(reclaimed)
        self._m_compactions.inc()
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

    def _shape(self) -> Tuple[int, int]:
        """(rows, client columns) of the state, placed or not."""
        if self._placed:
            return (sum(sl.seq.shape[0] for sl in self.state),
                    self.state[0].connected.shape[1])
        return tuple(self.state.connected.shape)

    def _place(self, state) -> List[_sk.SequencerState]:
        """Split the whole state into one slab of rows per entry."""
        return list(self.mesh.shard(state))

    def _grow_placed(self, old_d: int, old_c: int, new_c: int) -> None:
        """Grow a placed pool in place: each entry pads its own slab
        with empty rows and columns on its stream; no slab moves. The
        row space renumbers per slab (slab s owns physical rows
        [s*r1, (s+1)*r1) after the grow), so `_phys` maps every logical
        slot to its new row on its old slab, and the new logical slots
        [old_d, new_d) fill each slab's fresh rows [r0, r1)."""
        S, mesh = self._n_shards, self.mesh
        new_d = self.n_docs
        r0, r1 = old_d // S, new_d // S
        with mesh.parallel():
            for i in range(S):
                with mesh.on(i):
                    self.state[i] = _sk.grow_state(self.state[i], r1, new_c)
        phys = self._phys[:old_d]
        new_phys = np.empty(new_d, np.int64)
        new_phys[:old_d] = (phys // r0) * r1 + (phys % r0)
        grow_per = r1 - r0
        for i in range(S):
            base = old_d + i * grow_per
            new_phys[base:base + grow_per] = np.arange(i * r1 + r0,
                                                       (i + 1) * r1)
        self._phys = new_phys

    def _scatter_rows_placed(self, idx: np.ndarray, updates) -> None:
        """Write the loaded rows into a placed pool: only the slabs that
        own a loaded row are written (in place, on their entries'
        streams); every other slab is left as it is."""
        rows = self.n_docs // self._n_shards
        by_slab: Dict[int, List[int]] = {}
        for i, row in enumerate(idx):
            by_slab.setdefault(int(row) // rows, []).append(i)
        mesh = self.mesh
        with mesh.parallel():
            for sl, sel in by_slab.items():
                with mesh.on(sl):
                    dev = mesh.entries[sl]
                    at = (torch.from_numpy(idx[sel] - sl * rows).to(dev),)
                    for field, vals in zip(self.state[sl], updates):
                        field.index_put_(at, torch.from_numpy(vals[sel])
                                         .to(dev))

    def prepare(self) -> None:
        """Grow the state to the logical (D, C) and write the queued
        doc rows in one batched scatter (`index_put_` on the device).
        A sharded pool is placed on its mesh here the first time; once
        placed, a grow pads each slab on its entry and a scatter
        touches only the slabs that own a loaded row."""
        need_c = _pow2(self._need_clients, self.n_clients)
        d, c = self._shape()
        if self.n_docs != d or need_c != c:
            if self._placed:
                self._grow_placed(d, c, need_c)
            else:
                # The appended rows are the new physical tail, so the
                # logical map extends as identity.
                self.state = _sk.grow_state(self.state, self.n_docs, need_c)
                if len(self._phys) < self.n_docs:
                    self._phys = np.concatenate([
                        self._phys,
                        np.arange(len(self._phys), self.n_docs,
                                  dtype=np.int64),
                    ])
            self.n_clients = need_c
        if self._loads:
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
            idx = self._phys[idx]  # logical slots -> physical state rows
            updates = (seqv, minv, conn, ref, cseq)
            if self._placed:
                self._scatter_rows_placed(idx, updates)
                return
            dev = self.device
            at = (torch.from_numpy(idx).to(dev),)
            for field, vals in zip(self.state, updates):
                field.index_put_(at, torch.from_numpy(vals).to(dev))
        if self.mesh is not None and not self._placed:
            self.state = self._place(self.state)
            self._placed = True

    def run_chunk(self, kind, client, cseq, ref, groups, dedup: bool,
                  aborted=None):
        """One chunk: upload the five [D, B] columns in one copy (one
        per entry slab on a mesh), launch the kernel (the plain version
        on the CPU; once per slab on a mesh), read the verdicts back in
        one copy. `aborted` threads the boxcar-abort tracker (a device
        tensor; a list of per-slab trackers on a mesh) across a pump's
        chunks. Returns (SeqResult as numpy, tracker)."""
        if self.mesh is not None:
            return self._run_chunk_sharded(kind, client, cseq, ref, groups,
                                           dedup, aborted)
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

    def _run_chunk_sharded(self, kind, client, cseq, ref, groups,
                           dedup: bool, aborted):
        t = self.times
        mesh = self.mesh
        S = self._n_shards
        D, B = kind.shape
        r = D // S
        if t is not None:
            t0 = time.perf_counter()
        host = np.stack((kind, client, cseq, ref, groups))
        batches, groups_s, bufs, outs = [], [], [], []
        fresh = aborted is None
        if fresh:
            aborted = []
        with mesh.parallel():
            for i, dev in enumerate(mesh.entries):
                with mesh.on(i):
                    cols = torch.from_numpy(np.ascontiguousarray(
                        host[:, i * r:(i + 1) * r])).to(dev)
                    batches.append(_sk.SeqBatch(*cols[:4]))
                    groups_s.append(cols[4])
                    buf, out = _sk.alloc_result(r, B, dev)
                    bufs.append(buf)
                    outs.append(out)
                    if fresh:
                        aborted.append(_sk.no_aborts(r, dev))
        if t is not None:
            t1 = time.perf_counter()
            t["upload_s"] += t1 - t0
        fn = _sk.sharded_sequence_fn(mesh, dedup=bool(dedup))
        self.state, aborted, _ = fn(self.state, aborted, batches, groups_s,
                                    out=outs)
        if t is not None:
            t2 = time.perf_counter()
            t["launch_s"] += t2 - t1
        # One device-to-host copy of every slab's verdicts.
        flat = torch.cat([b.to(self.device, non_blocking=True) for b in bufs])
        host_res = flat.cpu().numpy()
        n = bufs[0].numel()
        parts = [_sk.decode_result(host_res[i * n:(i + 1) * n], r, B)
                 for i in range(S)]
        res = _sk.SeqResult(*(np.concatenate([getattr(p, f) for p in parts])
                              for f in _sk.SeqResult._fields))
        if t is not None:
            t["read_s"] += time.perf_counter() - t2
        self.chunks += 1
        self.max_cols_seen = max(self.max_cols_seen, B)
        return res, aborted

    # ---------------------------------------------------- verdict mirror

    def head(self, doc_id: str) -> int:
        return self.docs[doc_id]["seq"]

    def connected_clients(self, doc_id: str) -> set:
        h = self.docs.get(doc_id)
        return set(h["clients"]) if h else set()

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
                 dedup: bool = False, device: DeviceLike = None,
                 mesh=None):
        self.pool = SeqPool(n_docs, n_clients, max_resident, device=device,
                            mesh=mesh)
        self.max_cols = max(8, max_cols)
        self.dedup = dedup
        # Ordered segments: lists of per-record tuples (`add`)
        # interleaved with pre-columnized (n, 6) arrays (`add_columns`).
        self._segments: List[Any] = []
        self._n_subs = 0
        self._gctr: Dict[int, int] = {}
        # Kernel-path instruments: one histogram observation and a
        # handful of gauge and counter updates per pump, never per
        # record.
        m = get_registry()
        self._m_pump = m.histogram(
            "deli_pump_records",
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384),
            impl="kernel",
        )
        self._m_nacks = m.counter("deli_nacks_total", impl="kernel")
        self._m_skips = m.counter("deli_dedup_skips_total", impl="kernel")
        self._m_resident = m.gauge("deli_pool_resident_docs")
        self._m_slots = m.gauge("deli_pool_doc_slots")
        self._m_fill = m.gauge("deli_pool_fill_ratio")
        self._m_cols = m.gauge("deli_pool_client_cols")
        self._m_devices = m.gauge("deli_pool_devices")

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
                    # Logical doc slots -> physical state rows (identity
                    # until a sharded pool grows).
                    pool._phys[cols6[:, 0]],
                    cols6[:, 1], cols6[:, 2], cols6[:, 3],
                    cols6[:, 4], cols6[:, 5], pool.n_docs, self.max_cols,
                ):
            res, aborted = pool.run_chunk(
                kind, client, cseq, ref, grp, self.dedup, aborted
            )
            seq_o[sel] = res.seq[sl, ic]
            msn_o[sel] = res.min_seq[sl, ic]
            nack_o[sel] = res.nack[sl, ic]
            skip_o[sel] = res.skipped[sl, ic]
        self._m_pump.observe(n)
        nacks = int(np.count_nonzero(nack_o))
        if nacks:
            self._m_nacks.inc(nacks)
        skips = int(np.count_nonzero(skip_o))
        if skips:
            self._m_skips.inc(skips)
        resident = pool.resident_docs()
        self._m_resident.set(resident)
        self._m_slots.set(pool.n_docs)
        self._m_fill.set(resident / pool.n_docs if pool.n_docs else 0.0)
        self._m_cols.set(pool.n_clients)
        self._m_devices.set(pool._n_shards)
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
                 raw_topic: str = "rawdeltas", device: DeviceLike = None,
                 deli_devices: Optional[int] = None, device_plane=None,
                 plane_column: Optional[int] = None):
        """`raw_topic` names the ingress topic (the sharded server's
        per-partition ``rawdeltas-p{k}`` form). ``deli_devices=N`` splits
        the doc-slot pool over a mesh of N entries on `device`;
        `device_plane` instead takes the sequencer's slice of the shared
        plane (model column `plane_column`). The checkpoint shape is the
        scalar deli's and topology-free, so restores interoperate across
        the scalar, the JAX kernel and this deli, sharded or not."""
        if device_plane is not None and deli_devices is not None \
                and int(deli_devices) > 1:
            raise ValueError(
                "deli_devices and device_plane are exclusive: the "
                "plane's seq_mesh IS the deli's device slice"
            )
        mesh = mesh_for_devices(deli_devices, device)
        if mesh is None:
            mesh = mesh_for_plane(device_plane, plane_column, device=device)
        self.core = PackedDeliCore(
            n_docs, n_clients, max_resident, max_cols, dedup=False,
            device=device, mesh=mesh,
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
        self._m_stage = get_registry().histogram(
            "op_stage_ms", stage="submit_to_stamp"
        )

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
        observe_stage = self._m_stage.observe
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
                    observe_stage((ts - sub) * 1000.0)
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


# ---------------------------------------------------------------------------
# supervised-farm frontend (exactly-once recovery)
# ---------------------------------------------------------------------------

# Wire `type` codes the emit columns stamp (the K_SEQ_OP type column).
_TC_OP = _rb._TYPE_CODE["op"]
_TC_JOIN = _rb._TYPE_CODE["join"]
_TC_LEAVE = _rb._TYPE_CODE["leave"]


class _ScalarEmit:
    """Scalar-record accumulator for the columnar emission path: the
    records that still need per-record handling (nacks with their
    reason text, joins/leaves, dict-ingested strays, boxcar members)
    land as COLUMNS in stream order, so one pump's whole output is
    `ColumnarRecords` parts end to end — never a per-record wire
    dict. `flush()` closes the current accumulation into a part
    appended to `out` (called before every vectorized span so parts
    splice back in exact stream order)."""

    __slots__ = ("docs", "doc_of", "kind", "tc", "didx", "client",
                 "cseq", "ref", "seq", "msn", "inoff", "blobs")

    def __init__(self):
        self.docs: List[str] = []
        self.doc_of: Dict[str, int] = {}
        self.kind: List[int] = []
        self.tc: List[int] = []
        self.didx: List[int] = []
        self.client: List[int] = []
        self.cseq: List[int] = []
        self.ref: List[int] = []
        self.seq: List[int] = []
        self.msn: List[int] = []
        self.inoff: List[int] = []
        self.blobs: List[bytes] = []

    def _doc(self, doc: str) -> int:
        di = self.doc_of.get(doc)
        if di is None:
            di = self.doc_of[doc] = len(self.docs)
            self.docs.append(doc)
        return di

    def op(self, doc: str, tc: int, cid: int, cseq: int, ref: int,
           seq: int, msn: int, inoff: int, contents: Any) -> None:
        self.kind.append(_rb.K_SEQ_OP)
        self.tc.append(tc)
        self.didx.append(self._doc(doc))
        self.client.append(cid)
        self.cseq.append(cseq)
        self.ref.append(ref)
        self.seq.append(seq)
        self.msn.append(msn)
        self.inoff.append(inoff)
        self.blobs.append(_rb._dumps(contents))  # JsonBlob rides raw

    def member(self, doc: str, tc: int, cid: int, seq: int, msn: int,
               inoff: int) -> None:
        # join/leave wire shape: clientSeq 0, refSeq seq-1, contents=cid
        self.op(doc, tc, cid, 0, seq - 1, seq, msn, inoff, cid)

    def nack(self, doc: str, cid: int, cseq: int, code: int,
             reason: str, inoff: int) -> None:
        self.kind.append(_rb.K_NACK)
        self.tc.append(_rb._NO_TYPE)
        self.didx.append(self._doc(doc))
        self.client.append(cid)
        self.cseq.append(cseq)
        self.ref.append(0)
        self.seq.append(code)  # code rides the seq column
        self.msn.append(0)
        self.inoff.append(inoff)
        self.blobs.append(_rb._dumps(reason))

    def flush(self, out: List[Any]) -> None:
        n = len(self.kind)
        if not n:
            return
        blob_off = np.zeros(n + 1, np.uint32)
        blob_off[1:] = np.cumsum([len(b) for b in self.blobs])
        out.append(_rb.ColumnarRecords(
            self.docs, self.kind, self.tc, self.didx, self.client,
            self.cseq, self.ref, self.seq, self.msn, self.inoff,
            blob_off, b"".join(self.blobs),
        ))
        self.__init__()


class KernelDeliRole(_Role):
    """The supervised farm's deli with the sequencing on the device: a
    drop-in for the scalar `DeliRole`.

    `process()` buffers validated records; `flush_batch()` (called by
    the supervision step and by the recovery gap replay) packs them,
    runs the sequencer, and emits the scalar role's wire records, each
    carrying its input offset (``inOff``), so the fenced exactly-once
    recovery holds unchanged: a restart mid-batch scans the durable
    output prefix and silently replays the gap through the same
    kernel path without re-emitting.

    Over a columnar op-log (``log_format="columnar"``) the role ingests
    whole `RecordBatch` frames (`process_batch`): doc ids come from the
    batch dictionary, the int fields straight off the codec's columns,
    and standalone ops' ``contents`` stay pre-encoded JSON blobs end to
    end when the output topic is columnar too. Wire boxcar records
    sequence atomically through the kernel's group machinery, matching
    the scalar role bit for bit.

    The role runs on ``cuda`` unless given ``device="cpu"`` (the plain
    sequencer); given no device where there is no CUDA it raises.
    `mesh` (a ready `parallel.mesh.DocsMesh`) or ``deli_devices=N`` (the
    shared mesh of N entries on `device`) splits the pool over mesh
    entries; `device_plane` / `plane_column` instead take the
    sequencer's slice of the shared plane (the column defaults to a
    stable hash of the partition key), and with neither the plane comes
    from ``FLUID_DEVICE_PLANE``. The wire records, the ``inOff``
    recovery contract and the checkpoint format are the same either
    way."""

    name = "deli"
    in_topic_name = "rawdeltas"
    out_topic_name = "deltas"
    ingest_batches = True  # _Role.step feeds RecordBatch frames whole

    def __init__(self, *a, device: DeviceLike = None, mesh=None,
                 deli_devices: Optional[int] = None, device_plane=None,
                 plane_column: Optional[int] = None, **kw):
        if device_plane is not None and deli_devices is not None \
                and int(deli_devices) > 1:
            raise ValueError(
                "deli_devices and device_plane are exclusive: the "
                "plane's seq_mesh IS the deli's device slice"
            )
        # Resolved before any lease, topic or heartbeat file is made, so
        # a role that cannot run leaves nothing behind.
        if mesh is not None:
            from ..parallel.mesh import DocsMesh

            if not isinstance(mesh, DocsMesh):
                raise ValueError(f"KernelDeliRole(mesh=...) takes a "
                                 f"parallel.mesh.DocsMesh, got "
                                 f"{type(mesh).__name__}")
            self.device = mesh.entries[0]
        else:
            self.device = resolve_device(device)
            mesh = mesh_for_devices(deli_devices, device)
            if mesh is None and (deli_devices is None
                                 or int(deli_devices) <= 1):
                mesh = mesh_for_plane(device_plane, plane_column,
                                      partition_key=self.partition,
                                      env=True, device=device)
        self.mesh = mesh
        super().__init__(*a, **kw)
        self.core = PackedDeliCore(dedup=True, device=self.device,
                                   mesh=self.mesh)
        self._pending: List[tuple] = []  # ("rec", off, dict) |
        #                                 ("cols", start_off, RecordBatch)
        # Blob pass-through is only legal when the output topic can
        # carry raw JSON bytes (a columnar sibling); a JSON out topic
        # needs decoded values for its json.dumps.
        self.out_columnar = isinstance(self.out_topic, ColumnarFileTopic)
        # Input records planned by each path: "run" through
        # `_plan_op_run`'s arrays, "record" one by one.
        self.planned = {"run": 0, "record": 0}

    # ------------------------------------------------------------ state

    def snapshot_state(self) -> Any:
        # Checkpoint time doubles as the column-compaction sweep: the
        # snapshot never names departed clients.
        self.core.pool.compact_all()
        return self.core.pool.checkpoint_docs()

    def restore_state(self, state: Any) -> None:
        core = PackedDeliCore(dedup=True, device=self.device, mesh=self.mesh)
        core.pool.restore_docs(unwrap_ranged_state(state))
        core.pool.times = self.core.pool.times  # the caller's accumulator
        self.core = core

    # ------------------------------------------------------------- pump

    def process(self, line_idx: int, rec: Any, out: List[dict]) -> None:
        if not isinstance(rec, dict) or "doc" not in rec:
            return  # foreign/junk record: consume and move on
        if rec.get("kind") not in ("join", "leave", "op", "boxcar"):
            return
        self._pending.append(("rec", line_idx, rec))

    def process_batch(self, start_line: int, batch: Any,
                      out: List[dict]) -> None:
        """Columnar ingest: queue one `RecordBatch` whole (records
        numbered start_line..start_line+n-1)."""
        self._pending.append(("cols", start_line, batch))

    def _plan_op(self, plan, add, line_idx, doc, slot, col, cid, cseq,
                 ref, contents, group=NO_GROUP, sub_ts=None,
                 adm_ts=None):
        # `sub_ts`/`adm_ts` thread the client submit stamp (ingress
        # "tr_sub") and the front door's admission stamp ("tr_adm")
        # through the plan tuple so wire-trace mode can stamp and
        # observe at emit time, as the scalar role does.
        plan.append((line_idx, doc, "op",
                     (cid, cseq, ref, contents, sub_ts, adm_ts),
                     add(slot, SUB_OP, col, cseq, ref, group)))

    def flush_batch(self, out: List[dict]) -> None:
        if not self._pending:
            return
        core = self.core
        pool = core.pool
        t = pool.times
        if t is not None:
            t0 = time.perf_counter()
        core.begin()
        touch, add, col_of_join = core.touch, core.add, pool.col_of_join
        docs_cache: Dict[str, tuple] = {}  # touch once per doc per pump
        plan: List[tuple] = []
        shadow: Dict[str, set] = {}
        # Columnar emission (the pre-columnized emit path): legal when
        # the out topic carries raw frames and nothing downstream needs
        # per-record wire dicts — wire tracing adds a side "tr" key
        # (generic schema), recovery's silent replay and the ranged
        # fabric's predecessor drains post-process dict records
        # (inOff filters, inSrc tags).
        emit_cols = (self.out_columnar and not self.trace_wire
                     and not self._recovering and not self._dict_emit)

        def doc_entry(doc):
            ent = docs_cache.get(doc)
            if ent is None:
                h = touch(doc)
                ent = docs_cache[doc] = (h["slot"], h)
            return ent

        def plan_record(line_idx, rec):
            doc = rec["doc"]
            slot, h = doc_entry(doc)
            kind = rec["kind"]
            cid = rec["client"]
            if kind == "op":
                # Unknown/foreign client id -> scratch column -> the
                # oracle's unknown-client nack, no state aliasing.
                self._plan_op(
                    plan, add, line_idx, doc, slot,
                    h["cmap"].get(cid, 0), cid, rec["clientSeq"],
                    rec.get("refSeq", 0), rec.get("contents"),
                    sub_ts=rec.get("tr_sub"),
                    adm_ts=rec.get("tr_adm"),
                )
            elif kind == "boxcar":
                plan_boxcar(line_idx, doc, slot, h, cid, [
                    (op["clientSeq"], op.get("refSeq", 0),
                     op.get("contents"))
                    for op in rec.get("ops") or []
                ], sub_ts=rec.get("tr_sub"),
                    adm_ts=rec.get("tr_adm"))
            elif kind == "join":
                conn = shadow.get(doc)
                if conn is None:
                    conn = shadow[doc] = pool.connected_clients(doc)
                if cid in conn:
                    return  # duplicate join (at-least-once ingress)
                conn.add(cid)
                plan.append((line_idx, doc, "join", cid,
                             add(slot, SUB_JOIN, col_of_join(h, cid))))
            else:  # leave
                conn = shadow.get(doc)
                if conn is None:
                    conn = shadow[doc] = pool.connected_clients(doc)
                conn.discard(cid)
                plan.append((line_idx, doc, "leave", cid,
                             add(slot, SUB_LEAVE, h["cmap"].get(cid, 0))))

        def plan_boxcar(line_idx, doc, slot, h, cid, ops, sub_ts=None,
                        adm_ts=None):
            # One atomic group: a nack masks the group's tail in-kernel
            # (resubmission dedup stays per-op and silent).
            col = h["cmap"].get(cid, 0)
            g = core.new_group(slot)
            for cseq, ref, contents in ops:
                self._plan_op(plan, add, line_idx, doc, slot, col, cid,
                              cseq, ref, contents, group=g,
                              sub_ts=sub_ts, adm_ts=adm_ts)

        passthrough = self.out_columnar
        for ent in self._pending:
            if ent[0] == "rec":
                self.planned["record"] += 1
                plan_record(ent[1], ent[2])
                continue
            self._plan_cols(plan, ent[2], ent[1], doc_entry,
                            plan_record, plan_boxcar, passthrough)
        self._pending = []
        if t is not None:
            t["plan_s"] += time.perf_counter() - t0
        res = core.run(as_arrays=emit_cols)
        if t is not None:
            t0 = time.perf_counter()
        if emit_cols:
            self._emit_columns(plan, res, out)
        else:
            self._emit_dicts(plan, res, out)
        if t is not None:
            t["emit_s"] += time.perf_counter() - t0

    # ------------------------------------------------- columnar ingest

    # Below this, a K_RAW_OP run takes the per-record tuple path: the
    # per-run fixed cost (unique-doc touch, array builds, one emit
    # part per span) only amortizes over real runs — a join-interleaved
    # stream decomposes into length-1 "runs" that would otherwise pay
    # it per record.
    MIN_OP_RUN = 16

    def _plan_cols(self, plan, rb, base, doc_entry, plan_record,
                   plan_boxcar, passthrough) -> None:
        """Queue one ingested `RecordBatch`: homogeneous K_RAW_OP runs
        (at least `MIN_OP_RUN` long) go through
        `PackedDeliCore.add_columns` as arrays (doc slots via one
        touch per unique doc, dense client columns via one cmap probe
        per record — no plan tuples, no per-record blob handles),
        everything else (joins/leaves/boxcars/generic strays, short op
        runs) through the per-record plan."""
        n = rb.n
        if n == 0:
            return
        docs = rb.docs
        kinds_l = None
        cseqs_l = refs_l = None
        for run_is_op, lo, hi in _rb.mask_runs(rb.kind == _rb.K_RAW_OP):
            if run_is_op and hi - lo >= self.MIN_OP_RUN:
                self.planned["run"] += hi - lo
                self._plan_op_run(plan, rb, lo, hi, base, doc_entry)
                continue
            self.planned["record"] += hi - lo
            if kinds_l is None:
                kinds_l = rb.kind.tolist()
                doci = rb.doc_idx.tolist()
                clients = rb.client.tolist()
            for i in range(lo, hi):
                k = kinds_l[i]
                if k == _rb.K_RAW_OP:
                    if cseqs_l is None:
                        cseqs_l = rb.client_seq.tolist()
                        refs_l = rb.ref_seq.tolist()
                    doc = docs[doci[i]]
                    slot, h = doc_entry(doc)
                    cid = clients[i]
                    contents: Any = _rb.JsonBlob(rb.blob(i))
                    if not passthrough:
                        contents = contents.value
                    self._plan_op(
                        plan, self.core.add, base + i, doc, slot,
                        h["cmap"].get(cid, 0), cid, cseqs_l[i],
                        refs_l[i], contents,
                    )
                elif k == _rb.K_RAW_BOXCAR:
                    doc = docs[doci[i]]
                    slot, h = doc_entry(doc)
                    # v2 frames: per-op ints off the nested columns,
                    # per-op contents as raw-blob handles end to end.
                    ops = rb.boxcar(i)
                    if not passthrough:
                        ops = [
                            (cs, rf, c.value
                             if isinstance(c, _rb.JsonBlob) else c)
                            for cs, rf, c in ops
                        ]
                    plan_boxcar(base + i, doc, slot, h, clients[i],
                                ops)
                elif k in (_rb.K_RAW_JOIN, _rb.K_RAW_LEAVE):
                    plan_record(base + i, {
                        "kind": "join" if k == _rb.K_RAW_JOIN
                        else "leave",
                        "doc": docs[doci[i]], "client": clients[i],
                    })
                else:
                    # Generic / foreign record inside the frame: decode
                    # this one record and route it the legacy way.
                    rec = rb.record(i)
                    if isinstance(rec, dict) and "doc" in rec and \
                            rec.get("kind") in ("join", "leave", "op",
                                                "boxcar"):
                        plan_record(base + i, rec)

    def _plan_op_run(self, plan, rb, lo, hi, base, doc_entry) -> None:
        """Bulk-queue one contiguous K_RAW_OP run [lo, hi) through
        `add_columns` — the pre-columnized ingest half finally on the
        live path."""
        docs = rb.docs
        doci = rb.doc_idx[lo:hi]
        slot_of: Dict[int, int] = {}
        h_of: Dict[int, dict] = {}
        for d in np.unique(doci).tolist():
            slot, h = doc_entry(docs[d])
            slot_of[d] = slot
            h_of[d] = h
        m = hi - lo
        doci_l = doci.tolist()
        clients_l = rb.client[lo:hi].tolist()
        slots = np.fromiter((slot_of[d] for d in doci_l), np.int64, m)
        cols = np.fromiter(
            (h_of[d]["cmap"].get(c, 0)
             for d, c in zip(doci_l, clients_l)),
            np.int64, m,
        )
        j0 = self.core.add_columns(
            slots, SUB_OP, cols, rb.client_seq[lo:hi],
            rb.ref_seq[lo:hi],
        )
        plan.append((base, None, "run", (j0, rb, lo, hi, h_of), None))

    # ----------------------------------------------------- emission

    def _emit_dicts(self, plan, res, out: List[dict]) -> None:
        """The per-record wire-dict emission (the differential-oracle
        shape, and the path recovery / tracing / ranged drains use)."""
        pool = self.core.pool
        emit = out.append
        seqs, msns, nacks, skips = res.seq, res.msn, res.nack, res.skipped
        apply_op = pool.apply_op
        # Wire-trace stamps: ONE clock read per flush (the kernel
        # role's whole-pump philosophy — KernelDeliLambda stamps the
        # same way), serving both the record stamp and the
        # submit_to_stamp observe so the two surfaces agree exactly.
        trace = self.trace_wire
        now = time.time() if trace else 0.0

        def emit_op(line_idx, doc, cid, cseq, ref, contents, sub_ts,
                    adm_ts, handle):
            if skips[handle]:
                return  # deduped resubmission / aborted boxcar tail
            seq, msn, nack = seqs[handle], msns[handle], nacks[handle]
            if nack:
                emit({"kind": "nack", "doc": doc, "client": cid,
                      "clientSeq": cseq, "code": nack,
                      "reason": _nack_reason(
                          nack, ref, msn, pool.head(doc), cseq,
                          pool.expected_cseq(doc, cid)),
                      "inOff": line_idx})
                return
            apply_op(doc, cid, seq, msn, cseq, ref)
            rec = {"kind": "op", "doc": doc, "seq": seq, "msn": msn,
                   "client": cid, "clientSeq": cseq, "refSeq": ref,
                   "type": "op", "contents": contents,
                   "inOff": line_idx}
            if trace:
                tr = {"stamp": now}
                if isinstance(sub_ts, (int, float)):
                    tr["sub"] = sub_ts
                    if not self._recovering:
                        # Recovery's silent replay must not be
                        # re-observed (crash-spanning durations) —
                        # the scalar role's rule, kernel-side.
                        self._observe_stage(
                            "submit_to_stamp",
                            (now - sub_ts) * 1000.0,
                        )
                if isinstance(adm_ts, (int, float)):
                    # The front door's admission stamp: same flush
                    # clock read, same recovery-silent rule — the
                    # scalar role's admit_to_stamp, kernel-side.
                    tr["adm"] = adm_ts
                    if not self._recovering:
                        self._observe_stage(
                            "admit_to_stamp",
                            (now - adm_ts) * 1000.0,
                        )
                rec["tr"] = tr
            emit(rec)

        for line_idx, doc, tag, payload, handle in plan:
            if tag == "op":
                cid, cseq, ref, contents, sub_ts, adm_ts = payload
                emit_op(line_idx, doc, cid, cseq, ref, contents,
                        sub_ts, adm_ts, handle)
            elif tag == "run":
                j0, rb, lo, hi, _h_of = payload
                docs = rb.docs
                doci = rb.doc_idx
                clients = rb.client
                cseqs = rb.client_seq
                refs = rb.ref_seq
                for i in range(lo, hi):
                    contents: Any = _rb.JsonBlob(rb.blob(i))
                    if not self.out_columnar:
                        contents = contents.value
                    emit_op(line_idx + i, docs[int(doci[i])],
                            int(clients[i]), int(cseqs[i]),
                            int(refs[i]), contents, None, None,
                            j0 + i - lo)
            elif tag == "join":
                seq, msn = seqs[handle], msns[handle]
                pool.apply_join(doc, payload, seq, msn)
                rec = {"kind": "op", "doc": doc, "seq": seq, "msn": msn,
                       "client": payload, "clientSeq": 0,
                       "refSeq": seq - 1,
                       "type": "join", "contents": payload,
                       "inOff": line_idx}
                if trace:
                    rec["tr"] = {"stamp": now}
                emit(rec)
            else:  # leave
                seq, msn = seqs[handle], msns[handle]
                if seq == 0:
                    continue  # unknown client: nothing stamped
                pool.apply_leave(doc, payload, seq, msn)
                rec = {"kind": "op", "doc": doc, "seq": seq, "msn": msn,
                       "client": payload, "clientSeq": 0,
                       "refSeq": seq - 1,
                       "type": "leave", "contents": payload,
                       "inOff": line_idx}
                if trace:
                    rec["tr"] = {"stamp": now}
                emit(rec)

    def _emit_columns(self, plan, res, out: List[Any]) -> None:
        """The pre-columnized emission: verdict arrays flow into
        `ColumnarRecords` parts (ingest blob bytes pass through as
        whole heap spans), appended to `out` in exact stream order —
        `ColumnarFileTopic.append_many` splices them into one frame
        with zero per-record classification. The host mirror updates
        from flat column lists (bookkeeping-from-results, no wire
        dicts); nack reasons stay per-record (rare, text-only)."""
        pool = self.core.pool
        seqs, msns, nacks, skips = res.seq, res.msn, res.nack, res.skipped
        sc = _ScalarEmit()
        for line_idx, doc, tag, payload, handle in plan:
            if tag == "run":
                self._emit_run(payload, res, sc, out, line_idx)
            elif tag == "op":
                if skips[handle]:
                    continue
                seq = int(seqs[handle])
                msn = int(msns[handle])
                nack = int(nacks[handle])
                cid, cseq, ref, contents, _sub, _adm = payload
                if nack:
                    sc.nack(doc, cid, cseq, nack, _nack_reason(
                        nack, ref, msn, pool.head(doc), cseq,
                        pool.expected_cseq(doc, cid)), line_idx)
                    continue
                pool.apply_op(doc, cid, seq, msn, cseq, ref)
                sc.op(doc, _TC_OP, cid, cseq, ref, seq, msn, line_idx,
                      contents)
            elif tag == "join":
                seq = int(seqs[handle])
                msn = int(msns[handle])
                pool.apply_join(doc, payload, seq, msn)
                sc.member(doc, _TC_JOIN, payload, seq, msn, line_idx)
            else:  # leave
                seq = int(seqs[handle])
                msn = int(msns[handle])
                if seq == 0:
                    continue  # unknown client: nothing stamped
                pool.apply_leave(doc, payload, seq, msn)
                sc.member(doc, _TC_LEAVE, payload, seq, msn, line_idx)
        sc.flush(out)

    def _emit_run(self, payload, res, sc: _ScalarEmit, out: List[Any],
                  base: int) -> None:
        """Emit one ingested K_RAW_OP run: contiguous ACCEPTED spans
        become `ColumnarRecords` parts — verdict columns sliced
        straight off the kernel result, contents blobs one heap memcpy
        per span — while nacked records (rare) take the scalar path in
        place, so the output order is exactly the scalar role's."""
        j0, rb, lo, hi, h_of = payload
        m = hi - lo
        seqs = res.seq[j0:j0 + m]
        msns = res.msn[j0:j0 + m]
        nacks = res.nack[j0:j0 + m]
        skips = res.skipped[j0:j0 + m]
        # 0 = dropped (dedup), 1 = accepted, 2 = nacked.
        cat = np.where(skips, 0,
                       np.where(nacks == 0, 1, 2)).astype(np.int8)
        pool = self.core.pool
        for c, a, b in _rb.mask_runs(cat):
            if c == 0:
                continue  # deduped resubmissions: nothing emitted
            rows = slice(lo + a, lo + b)
            if c == 1:
                off = rb._blob_off[lo + a:lo + b + 1]
                heap = bytes(rb._heap[off[0]:off[-1]])
                seq64 = seqs[a:b].astype(np.int64)
                msn64 = msns[a:b].astype(np.int64)
                w = b - a
                part = _rb.ColumnarRecords(
                    rb.docs,
                    np.full(w, _rb.K_SEQ_OP, np.uint8),
                    np.full(w, _TC_OP, np.uint8),
                    rb.doc_idx[rows],
                    rb.client[rows], rb.client_seq[rows],
                    rb.ref_seq[rows],
                    seq64, msn64,
                    np.arange(base + lo + a, base + lo + b,
                              dtype=np.int64),
                    (off - off[0]).astype(np.uint32), heap,
                )
                sc.flush(out)  # strays before this span keep order
                out.append(part)
                # Mirror update from flat columns (last write wins per
                # (doc, client) — order-equivalent within a span of
                # plain ops, and spans run in stream order).
                for d, cl, cs, rf, sq, mn in zip(
                        rb.doc_idx[rows].tolist(),
                        rb.client[rows].tolist(),
                        rb.client_seq[rows].tolist(),
                        rb.ref_seq[rows].tolist(),
                        seq64.tolist(), msn64.tolist()):
                    h = h_of[d]
                    h["clients"][cl] = [rf, cs]
                    h["seq"] = sq
                    h["min_seq"] = mn
            else:
                docs = rb.docs
                for i in range(lo + a, lo + b):
                    j = i - lo
                    doc = docs[int(rb.doc_idx[i])]
                    cid = int(rb.client[i])
                    cseq = int(rb.client_seq[i])
                    ref = int(rb.ref_seq[i])
                    nk = int(nacks[j])
                    msn = int(msns[j])
                    sc.nack(doc, cid, cseq, nk, _nack_reason(
                        nk, ref, msn, pool.head(doc), cseq,
                        pool.expected_cseq(doc, cid)), base + i)
