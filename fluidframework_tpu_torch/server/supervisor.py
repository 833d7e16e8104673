"""The supervised role: a fenced, exactly-once consume / transform /
append loop over shared file topics, and the child-process entry that
serves the kernel deli in it.

Copied from fluidframework_tpu/server/supervisor.py: `EXIT_DEPOSED`,
`EXIT_FENCED` (:101-102), `trace_wire_enabled` (:112-118),
`_topic_path` (:121), `unwrap_ranged_state` (:125), `canonical_record`
(:140), `_Role` (:156-685, whole), `partitioned_role_class` (:1296),
and `serve_role` (:1323) and `main` (:1964) cut to the one role the
port has: ``--role deli --impl kernel`` (`deli_kernel.KernelDeliRole`),
with a new ``--device`` (default ``cuda``). Every other role, the
scalar deli, ``--deli-devices`` and ``--device-plane`` are refused with
a ValueError that names the ROADMAP.md item that ports them.
`ServiceSupervisor` is not copied.

A role holds a FENCED lease on its name (`queue.LeaseManager`), renews
it while alive and writes a liveness heartbeat each step. Every output
record carries the input offset it was produced from (``inOff``); on
recovery the role scans its output topic for the largest durable
``inOff``, reprocesses the checkpoint-to-``inOff`` input gap without
emitting (rebuilding its state deterministically), re-emits the
missing tail of a partially durable input, and only then resumes.
Output appends and checkpoint writes are both fenced, so a deposed
owner is rejected at the write path with `FencedError`. Lease,
heartbeat, checkpoint and topic files are in the reference's formats,
so a role of either package takes over from the other.

Run the kernel deli on the card::

    python -c "from fluidframework_tpu_torch.server.supervisor import main; main()" \
        --role deli --impl kernel --dir DIR --log-format columnar
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from .columnar_log import (
    LOG_FORMATS,
    default_log_format,
    make_tail_reader,
    make_topic,
)
from .queue import (
    FencedCheckpointStore,
    FencedError,
    LeaseManager,
    TailReader,
    TopicDoorbell,
    doorbells_enabled,
    partition_suffix,
    retry_durable,
)

__all__ = [
    "EXIT_DEPOSED",
    "EXIT_FENCED",
    "canonical_record",
    "main",
    "partitioned_role_class",
    "serve_role",
    "trace_wire_enabled",
    "unwrap_ranged_state",
]

EXIT_DEPOSED = 4  # lease renew failed: a successor owns the role
EXIT_FENCED = 3  # write-path fence rejection: we are a zombie

# Opt-in WIRE tracing for the supervised farm: with FLUID_TRACE_WIRE
# set, the deli stamps per-stage wall-clock timestamps into a "tr" dict
# on its output records and scriptorium/broadcaster extend it — the
# farm twin of the in-proc `SequencedMessage.traces`. Off by default:
# timestamps differ run to run, so any bit-identity comparison that
# keeps all record keys must run untraced. Digest/convergence forms are
# safe either way (`canonical_record` keeps a fixed key set that
# excludes "tr").
TRACE_WIRE_ENV = "FLUID_TRACE_WIRE"


def trace_wire_enabled() -> bool:
    return os.environ.get(TRACE_WIRE_ENV, "").lower() not in (
        "", "0", "off", "no"
    )


def _topic_path(shared_dir: str, name: str) -> str:
    return os.path.join(shared_dir, "topics", f"{name}.jsonl")


def unwrap_ranged_state(state: Any) -> Any:
    """Deli checkpoint states come in two shapes: the classic per-doc
    `DocumentSequencer` map, and the elastic fabric's ranged envelope
    (``{"__ranged__": 1, "docs": {...}, "preds": {...}}`` — per-doc
    map plus predecessor catch-up cursors, written by the reference's
    `server/shard_fabric.py`).
    Every deli restore path unwraps through here, so a checkpoint
    written by a ranged role stays restorable by ANY frontend (scalar,
    kernel, in-proc) — the cursors only mean something to a ranged
    successor, the doc states mean the same thing everywhere."""
    if (isinstance(state, dict) and state.get("__ranged__")
            and "docs" in state):
        return state.get("docs") or {}
    return state


def canonical_record(rec: dict) -> dict:
    """A sequenced record minus transport bookkeeping (`inOff`, worker
    tags) — the form digests and convergence checks compare."""
    return {
        k: rec[k]
        for k in ("kind", "doc", "seq", "msn", "client", "clientSeq",
                  "refSeq", "type", "contents")
        if k in rec
    }


# ---------------------------------------------------------------------------
# Roles
# ---------------------------------------------------------------------------


class _Role:
    """One supervised lambda: fenced lease + heartbeat + exactly-once
    consume/transform/append loop over shared file topics."""

    name: str = ""
    in_topic_name: str = ""
    out_topic_name: Optional[str] = None
    # Roles that ingest columnar `RecordBatch` frames whole (the deli
    # family) set this; everyone else reads decoded records.
    ingest_batches: bool = False
    # Sharded-fabric identity (`partitioned_role_class`): the partition
    # this role instance owns, and the base role name its metrics are
    # labeled with. None = the classic single-partition farm.
    partition: Optional[int] = None
    role_base: Optional[str] = None
    # Set True around a flush whose output records will be
    # POST-PROCESSED as wire dicts (the ranged fabric's predecessor
    # drains tag `inSrc` onto each record): columnar-emitting roles
    # (the kernel deli) then fall back to per-record dict emission for
    # that flush. Recovery and wire tracing force the dict path on
    # their own flags.
    _dict_emit: bool = False
    # LOGICAL input-topic byte position at the START of the batch being
    # processed (captured off the incremental reader before each poll;
    # None during recovery replay and predecessor drains, where no such
    # anchor exists). The summarizer stamps it into its manifests as
    # ``byteOff`` — a hard lower bound for the catch-up tail seek,
    # stable under op-log truncation.
    _in_pos: Optional[int] = None

    def _metric_labels(self) -> Dict[str, str]:
        """Metric label set: single-partition roles keep the historic
        {role: name}; partitioned roles label {role: base, partition: k}
        so the supervisor scrape can aggregate across the fabric while
        per-partition series stay distinguishable."""
        if self.partition is None:
            return {"role": self.name}
        return {"role": self.role_base or self.name,
                "partition": str(self.partition)}

    def __init__(self, shared_dir: str, owner: str, ttl_s: float = 1.0,
                 batch: int = 512, ckpt_interval_s: float = 0.25,
                 ckpt_bytes: int = 256 * 1024,
                 log_format: Optional[str] = None,
                 ckpt_duty: float = 0.2):
        """`ckpt_interval_s` / `ckpt_bytes`: checkpoint cadence —
        a checkpoint is written when EITHER bound is crossed since the
        last one (at 10k-doc scale a per-step JSON snapshot would
        dwarf the batch). Correctness is cadence-independent: exactly-once
        recovery scans the output topic for the durable `inOff` prefix
        and silently replays the checkpoint→prefix gap, however wide.
        `ckpt_interval_s=0` restores every-step checkpointing.

        `log_format` ("json" | "columnar", default env
        ``FLUID_LOG_FORMAT``) picks the topic wire form: JSONL lines or
        binary record batches (`server.columnar_log`). Columnar
        readers parse both, so a JSONL farm may UPGRADE to columnar
        across a restart and resume the same topics mid-stream (the
        reverse needs drained topics — JSON readers cannot parse
        frames).

        `ckpt_duty` is the checkpoint-STORM guard: once state grows to
        where one snapshot costs S seconds (a 10k-doc deli checkpoint
        runs to tens of MB), a cadence that fires every pump would
        spend most of the wall clock checkpointing — so a snapshot
        costing S runs at most every ``S / ckpt_duty`` seconds,
        bounding checkpoint work to that fraction of wall time however
        large the state gets. Recovery granularity widens with it;
        correctness does not (the inOff scan replays any gap).
        Explicit every-step mode (``ckpt_interval_s=0``) bypasses the
        guard."""
        self.shared_dir = shared_dir
        self.owner = owner
        self.batch = batch
        self.ckpt_interval_s = ckpt_interval_s
        self.ckpt_bytes = ckpt_bytes
        self.ckpt_duty = ckpt_duty
        self.log_format = default_log_format(log_format)
        self.leases = LeaseManager(
            os.path.join(shared_dir, "leases"), owner, ttl_s,
            claim_ttl_s=max(0.25, ttl_s / 2),
        )
        self.ckpt = FencedCheckpointStore(
            os.path.join(shared_dir, "checkpoints")
        )
        self.in_topic = make_topic(
            _topic_path(shared_dir, self.in_topic_name), self.log_format
        )
        self.out_topic = (
            make_topic(_topic_path(shared_dir, self.out_topic_name),
                       self.log_format)
            if self.out_topic_name else None
        )
        self.fence: Optional[int] = None
        self.offset = 0
        # Storage degradation flag: True while a durable write (topic
        # append, checkpoint) is inside its bounded-retry backoff
        # budget (ENOSPC, stalled volume). Rides the heartbeat so the
        # supervisor's health surface can show a limping-but-live
        # role; cleared by the next durable write that lands.
        self.degraded = False
        self._reader: Optional[TailReader] = None
        self._last_renew = 0.0
        # Event-driven idle: instead of sleeping the poll interval
        # blind, the idle branch waits on the input topic's doorbell
        # (queue.TopicDoorbell) with the SAME bounded timeout — an
        # append wakes the role immediately, and a missed ring only
        # costs the old poll latency. Created lazily on first idle so
        # bench-driven roles (which never idle) register no FIFO.
        self._bell: Optional[TopicDoorbell] = None
        self._doorbell_ok = doorbells_enabled()
        # Wire tracing (off by default — see TRACE_WIRE_ENV) and the
        # per-stage histogram cache it feeds. `_recovering` gates the
        # OBSERVATION side off during recovery's silent replay:
        # replayed records would otherwise be observed a second time,
        # with a "latency" that spans the crash — phantom multi-second
        # slow ops in the very evidence surface this exists for.
        self.trace_wire = trace_wire_enabled()
        self._recovering = False
        self._stage_hists: Dict[str, Any] = {}
        self._hb_path = os.path.join(shared_dir, "hb", f"{self.name}.json")
        os.makedirs(os.path.dirname(self._hb_path), exist_ok=True)
        # Checkpoint-cadence state + role metrics. The registry is
        # per-process; `heartbeat()` snapshots it into the hb file so
        # the supervisor can merge children's metrics for /metrics.
        self._ckpt_dirty = False
        self._ckpt_last_t = time.time()
        self._ckpt_last_s = 0.0
        self._ckpt_pending_bytes = 0
        self._hb_t = 0.0
        from ..utils.metrics import get_registry

        self.metrics = get_registry()
        m = self.metrics
        labels = self._metric_labels()
        self._m_pump = m.histogram(
            "role_pump_records",
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384),
            **labels,
        )
        self._m_records = m.counter("role_records_total", **labels)
        self._m_ckpt_writes = m.counter(
            "checkpoint_writes_total", **labels
        )
        self._m_ckpt_bytes = m.counter(
            "checkpoint_bytes_total", **labels
        )
        self._m_ckpt_ms = m.histogram("checkpoint_ms", **labels)
        self._m_fenced = m.counter("fence_rejections_total", **labels)
        self._m_disk_retries = m.counter("disk_retries_total", **labels)
        self._m_degraded = m.gauge("role_degraded", **labels)

    # ------------------------------------------------------------ state

    def snapshot_state(self) -> Any:
        return None

    def restore_state(self, state: Any) -> None:
        pass

    def process(self, line_idx: int, rec: Any,
                out: List[dict]) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def flush_batch(self, out: List[dict]) -> None:
        """End-of-batch hook: batching roles (the kernel deli) buffer
        in `process` and emit here; scalar roles emit per record."""

    def _append_outputs(self, out: List[dict]) -> int:
        """The fenced durable output append for one step's batch
        (fused roles extend it to several topics — each leg wraps its
        OWN retry budget, so a retried leg can never re-append a leg
        that already landed). Returns bytes written."""
        return self._durable(lambda: self.out_topic.append_many(
            out, fence=self.fence, owner=self.owner
        ))

    def _absorb_predecessors(self) -> None:
        """Recovery hook between the output fence bind and the
        own-topic durable scan: the elastic fabric's ranged roles
        (the reference's `shard_fabric._RangedMixin`) absorb their
        predecessor ranges' tails here. Classic roles have no
        predecessors."""

    # -------------------------------------------------------- doorbells

    def doorbell(self) -> Optional[TopicDoorbell]:
        """This role's input-topic doorbell (created lazily; None when
        doorbells are disabled or the FIFO cannot be made — the caller
        then falls back to the plain poll sleep)."""
        if not self._doorbell_ok:
            return None
        if self._bell is None:
            try:
                self._bell = TopicDoorbell(self.in_topic.path)
            except OSError:
                self._doorbell_ok = False
                return None
        return self._bell

    def close_doorbell(self) -> None:
        """Release the FIFO (a worker dropping a deposed partition
        role must not leave its bell absorbing rings forever)."""
        if self._bell is not None:
            self._bell.close()
            self._bell = None

    # With a live bell the idle timeout stretches to this (still
    # bounded — the poll fallback): rings are retained in the FIFO
    # even while the role is mid-step, so the only append a wait can
    # "miss" predates the bell's creation, and that one costs at most
    # this. Meanwhile idle churn (a heartbeat write per poll tick)
    # drops ~5x, which is itself tail latency on a contended host.
    bell_wait_s: float = 0.05

    def _idle_wait(self, timeout_s: float) -> None:
        """The idle quantum: event wake on new input, bounded by the
        poll fallback that keeps every correctness property
        doorbell-independent."""
        if timeout_s <= 0:
            return
        bell = self.doorbell()
        if bell is None:
            time.sleep(timeout_s)
        else:
            bell.wait(max(timeout_s, self.bell_wait_s))

    def _observe_stage(self, stage: str, ms: float) -> None:
        """Fold one wire-trace stage latency into `op_stage_ms` (the
        same histogram family the in-proc pipeline feeds; instruments
        cached per stage). Partitioned/ranged roles label the series
        with their partition too — the worker heartbeat then carries
        per-partition stage histograms, the supervisor scrape merges
        them, and the `_q` quantile gauges come out labeled
        ``{partition=k}`` (the per-range p99 the autoscale policy's
        `p99_per_partition` trigger reads). Classic single-partition
        roles keep the historic label set."""
        h = self._stage_hists.get(stage)
        if h is None:
            labels = {"stage": stage}
            if self.partition is not None:
                labels["partition"] = str(self.partition)
            h = self._stage_hists[stage] = self.metrics.histogram(
                "op_stage_ms", **labels
            )
        h.observe(ms)

    # -------------------------------------------------------- lifecycle

    # Minimum seconds between heartbeat file writes (0 = every call —
    # the classic farm's liveness contract, where THIS file is what the
    # supervisor watches). The shard fabric raises it on its embedded
    # roles: worker-level heartbeats are the fabric's liveness/metrics
    # channel, so per-partition role heartbeats would otherwise be
    # O(partitions) registry-snapshot writes per pump that nothing
    # reads.
    hb_interval_s: float = 0.0

    def heartbeat(self, force: bool = False) -> None:
        now = time.time()
        if (not force and self.hb_interval_s > 0
                and now - self._hb_t < self.hb_interval_s):
            return
        self._hb_t = now
        tmp = self._hb_path + f".tmp.{os.getpid()}"
        hb = {
            "pid": os.getpid(), "owner": self.owner, "t": time.time(),
            "fence": self.fence, "offset": self.offset,
            "degraded": self.degraded,
            # Metrics report UP through the existing heartbeat
            # channel: the supervisor merges these snapshots into
            # its /metrics registry (per-process registries, one
            # explicit merge point).
            "metrics": self.metrics.snapshot(),
        }
        if self.trace_wire:
            # Slow-op flight-recorder spans ride the same channel (the
            # supervisor's /traces merges them); only in wire-trace
            # mode — nothing feeds the recorder otherwise.
            from ..utils.metrics import get_flight_recorder

            spans = get_flight_recorder().snapshot()
            if spans:
                hb["slow_ops"] = spans
        with open(tmp, "w") as f:
            json.dump(hb, f)
        os.replace(tmp, self._hb_path)

    def _durable(self, fn):
        """Run one durable write under the storage-fault budget:
        bounded-retry jittered backoff on OSError (ENOSPC, EIO, a
        stalled volume), flagging the role `degraded` — and force-
        heartbeating, so liveness AND the flag stay visible while it
        waits — for as long as the retry budget lasts. A write that
        lands clears the flag; a spent budget re-raises (hard-fail:
        the record was never acknowledged, so the supervisor restart
        loses nothing). `FencedError` passes straight through — a
        deposed writer must die, not loop."""
        def note(attempt, exc, delay):
            self.degraded = True
            self._m_degraded.set(1.0)
            self._m_disk_retries.inc()
            self.heartbeat(force=True)  # export the flag while limping

        out = retry_durable(fn, on_retry=note)
        if self.degraded:
            self.degraded = False
            self._m_degraded.set(0.0)
            self.heartbeat(force=True)  # recovery is news too
        return out

    def _renew_or_die(self, now: Optional[float] = None) -> None:
        """Lease upkeep (every ttl/3): a failed renewal means a
        successor owns the role — stand down loudly. ONE helper for
        every pump path (base step, ranged step, predecessor drains)
        so deposed handling can never fork."""
        now = time.time() if now is None else now
        if now - self._last_renew <= self.leases.ttl_s / 3:
            return
        if not self.leases.renew(self.name):
            print(f"DEPOSED {self.name} {self.owner}", flush=True)
            raise SystemExit(EXIT_DEPOSED)
        self._last_renew = now

    def _recover(self) -> None:
        """Resume from the durable checkpoint, then close the
        append-vs-checkpoint crash window: deterministically reprocess
        (silently) every input whose output is already durable."""
        self._recovering = True
        try:
            self._recover_inner()
        finally:
            self._recovering = False

    def _recover_inner(self) -> None:
        env = self.ckpt.load(self.name)
        self.offset = 0
        if env is not None:
            st = env["state"]
            self.offset = int(st.get("offset", 0))
            self.restore_state(st.get("state"))
        else:
            self.restore_state(None)
        if self.out_topic is None:
            return
        # Bind our fence on the output topic BEFORE scanning it: from
        # this append on, a deposed predecessor's in-flight batch is
        # rejected (FencedError), so the scan below sees the final
        # durable prefix and no zombie write can land after it — the
        # write-path half of the takeover contract.
        self._durable(lambda: self.out_topic.append_many(
            [], fence=self.fence, owner=self.owner
        ))
        # Ranged successors absorb their predecessors' tails HERE —
        # after our fence is bound, before the own-topic scan: a doc's
        # own-topic records always postdate its predecessor records,
        # so this is the per-document input order (no-op otherwise).
        self._absorb_predecessors()
        done_counts = self._durable_done_counts(self.out_topic)
        if not done_counts:
            return
        max_done = max(done_counts)
        gap, next_off = self.in_topic.read_entries(self.offset)
        sink: List[dict] = []
        for line_idx, rec in gap:
            if line_idx > max_done:
                next_off = line_idx
                break
            self.process(line_idx, rec, sink)  # silent: already durable
        else:
            next_off = max(self.offset, max_done + 1, next_off)
        self.flush_batch(sink)  # batching roles rebuild state here
        # Re-emit the missing tail of max_done's outputs, if the crash
        # clipped them: deterministic replay regenerates the exact
        # records, so emitting from the durable count onward completes
        # the input without duplicating its prefix.
        tail = [r for r in sink if r.get("inOff") == max_done]
        tail = tail[done_counts[max_done]:]
        if tail:
            self._durable(lambda: self.out_topic.append_many(
                tail, fence=self.fence, owner=self.owner
            ))
        self.offset = next_off
        self._reader = None  # re-anchor the tail at the new offset
        # The replayed records MUST match what is already on disk —
        # that is the determinism claim this service rests on.
        # (Checked cheaply: counts; the chaos harness checks digests.)
        self.checkpoint()

    def _durable_done_counts(self, topic) -> Dict[int, int]:
        """Durable outputs per input offset on `topic`: one input may
        emit SEVERAL outputs (a wire boxcar), and a crash mid-append
        can leave a durable PREFIX of them — outputs land in input
        order, so only the LAST durable input (max over the keys) can
        be partial; everything below it is complete. Records tagged
        `inSrc` live in a PREDECESSOR's offset space (a ranged
        successor's absorbed catch-up in the reference's elastic fabric) — their
        inOff would collide with ours, so the predecessor scan owns
        them, not this one."""
        entries, _ = topic.read_entries(0)
        done: Dict[int, int] = {}
        for _, r in entries:
            if (isinstance(r, dict) and r.get("inSrc") is None
                    and r.get("inOff", -1) >= self.offset):
                off = r["inOff"]
                done[off] = done.get(off, 0) + 1
        return done

    def checkpoint(self) -> None:
        t0 = time.perf_counter()
        n_bytes = self._durable(lambda: self.ckpt.save(
            self.name,
            {"offset": self.offset, "state": self.snapshot_state()},
            fence=self.fence, owner=self.owner,
        ))
        self._m_ckpt_writes.inc()
        self._m_ckpt_bytes.inc(n_bytes)
        self._ckpt_last_s = time.perf_counter() - t0
        self._m_ckpt_ms.observe(self._ckpt_last_s * 1000.0)
        self._ckpt_dirty = False
        self._ckpt_pending_bytes = 0
        self._ckpt_last_t = time.time()

    def maybe_checkpoint(self) -> bool:
        """Write a checkpoint iff the cadence says so (dirty AND the
        time or byte bound crossed), subject to the checkpoint-storm
        guard: a snapshot whose last write cost S seconds runs at most
        every ``S / ckpt_duty`` seconds, so huge states cannot turn
        the cadence into a wall-clock sink (the 10k-doc deli snapshot
        is tens of MB — every-pump writes would dominate the pipeline
        end-to-end). Returns whether one was written."""
        if not self._ckpt_dirty:
            return False
        now = time.time()
        if (self._ckpt_pending_bytes < self.ckpt_bytes
                and now - self._ckpt_last_t < self.ckpt_interval_s):
            return False
        if (self.ckpt_interval_s > 0 and self.ckpt_duty > 0
                and self._ckpt_last_s > 0
                and now - self._ckpt_last_t
                < self._ckpt_last_s / self.ckpt_duty):
            # Storm guard (ckpt_interval_s=0 — every-step mode — and
            # ckpt_duty=0 — guard disabled — both bypass it).
            return False
        self.checkpoint()
        return True

    def step(self, idle_sleep: float = 0.01) -> int:
        """One supervision quantum: lease upkeep, one input batch,
        fenced append + checkpoint, heartbeat. Returns records moved."""
        now = time.time()
        if self.fence is None:
            fence = self.leases.try_acquire(self.name)
            self.heartbeat()
            if fence is None:
                time.sleep(idle_sleep)
                return 0
            self.fence = fence
            self._last_renew = now
            self._recover()
        else:
            self._renew_or_die(now)
        # Micro-batch cap (threaded into the read): a deep input
        # backlog yields between steps, so lease renewal + heartbeat
        # stay live no matter how far behind the role is. The tail is
        # read incrementally (TailReader) — re-reading the whole topic
        # per step is O(topic²) over a role's lifetime.
        if self._reader is None or self._reader.next_line != self.offset:
            self._reader = make_tail_reader(self.in_topic, self.offset)
        # Batch-start input byte anchor (see `_in_pos`): every record
        # of the coming poll sits at/after this logical position.
        self._in_pos = getattr(self._reader, "_pos", None)
        out: List[dict] = []
        moved = 0
        if self.ingest_batches and hasattr(self._reader, "poll_batches"):
            # Columnar zero-decode path: whole RecordBatch frames go to
            # process_batch; stray decoded records (a migrated JSONL
            # history) take the per-record path.
            for unit in self._reader.poll_batches(self.batch):
                if unit[0] == "batch":
                    moved += unit[2].n
                    self.process_batch(unit[1], unit[2], out)
                else:
                    moved += 1
                    self.process(unit[1], unit[2], out)
        else:
            entries = self._reader.poll(self.batch)
            moved = len(entries)
            for line_idx, rec in entries:
                self.process(line_idx, rec, out)
        next_off = self._reader.next_line
        if not moved:
            if next_off != self.offset:
                self.offset = next_off  # junk-only progress still counts
                self._ckpt_dirty = True
            try:
                # Idle flush: progress folded since the last
                # checkpoint goes durable once the interval elapses
                # (a quiescent stream must not pin state in memory).
                self.maybe_checkpoint()
            except FencedError as exc:
                self._m_fenced.inc()
                self.heartbeat(force=True)  # export the rejection before dying
                print(f"FENCED {self.name} {self.owner}: {exc}", flush=True)
                raise SystemExit(EXIT_FENCED)
            self.heartbeat()
            self._idle_wait(idle_sleep)
            return 0
        self.flush_batch(out)
        try:
            if self.out_topic is not None:
                # Append THEN checkpoint; the recovery scan makes the
                # crash window between them exactly-once, whatever the
                # checkpoint cadence. Durable = retried under the
                # storage-fault budget (degraded, not dead, through a
                # transient ENOSPC).
                self._ckpt_pending_bytes += self._append_outputs(out)
            self.offset = next_off
            self._ckpt_dirty = True
            self.maybe_checkpoint()
        except FencedError as exc:
            self._m_fenced.inc()
            self.heartbeat(force=True)  # export the rejection before dying
            print(f"FENCED {self.name} {self.owner}: {exc}", flush=True)
            raise SystemExit(EXIT_FENCED)
        self._m_pump.observe(moved)
        self._m_records.inc(moved)
        self.heartbeat()
        return moved



def partitioned_role_class(base: type, partition: int) -> type:
    """The sharded-fabric form of a role class: same code, partition-
    suffixed identity. Lease key, heartbeat file, checkpoint key and
    topic pair all become per-partition (`deli-p3` over
    `rawdeltas-p3` → `deltas-p3`), so N partitions of one role are N
    independent fenced exactly-once pipelines over disjoint slices of
    the document space (the reference's `server/shard_fabric.py` owns
    the slicing)."""
    p = int(partition)
    if p < 0:
        raise ValueError(f"partition must be >= 0, got {partition}")
    attrs = {
        "name": partition_suffix(base.name, p),
        "in_topic_name": partition_suffix(base.in_topic_name, p),
        "out_topic_name": (
            partition_suffix(base.out_topic_name, p)
            if base.out_topic_name else None
        ),
        "partition": p,
        "role_base": base.name,
    }
    # A second output leg (the fused durable+broadcast consumer)
    # partitions along with the primary pair.
    if getattr(base, "bc_topic_name", None):
        attrs["bc_topic_name"] = partition_suffix(base.bc_topic_name, p)
    return type(f"{base.__name__}P{p}", (base,), attrs)

# Where the roles, impls and options that the port does not serve yet
# are to be ported (ROADMAP.md Queue 1).
_NOT_PORTED_ROLE = (
    "the port serves only --role deli --impl kernel; the other roles "
    "(summarizer, scriptorium, scribe, broadcaster, ingress, retention) "
    "are ROADMAP.md Queue 1 item 4"
)
_NOT_PORTED_DEVICES = (
    "is the multi-device layer, ROADMAP.md Queue 1 item 3; the port's "
    "deli runs on one device (--device)"
)


def serve_role(shared_dir: str, role: str, owner: str,
               ttl_s: float = 1.0, batch: int = 512,
               deli_impl: str = "kernel",
               ckpt_interval_s: float = 0.25,
               ckpt_bytes: int = 256 * 1024,
               log_format: Optional[str] = None,
               ckpt_duty: float = 0.2,
               partition: Optional[int] = None,
               deli_devices: Optional[int] = None,
               hb_interval_s: Optional[float] = None,
               device_plane: Optional[str] = None,
               device: Optional[str] = None) -> None:
    """Child-process entry: run the kernel deli until killed, deposed
    or fenced. With `partition`, the role serves that partition's topic
    pair under its partition-suffixed lease. `device` is the torch
    device the sequencer runs on (None: ``cuda``, which raises where
    there is none). Raises ValueError for a role, impl or device option
    the port does not serve."""
    if role != "deli" or deli_impl != "kernel":
        raise ValueError(
            f"role={role!r} impl={deli_impl!r}: {_NOT_PORTED_ROLE}"
        )
    if deli_devices is not None:
        raise ValueError(f"deli_devices={deli_devices} "
                         f"{_NOT_PORTED_DEVICES}")
    if device_plane is not None:
        raise ValueError(f"device_plane={device_plane!r} "
                         f"{_NOT_PORTED_DEVICES}")
    from .deli_kernel import KernelDeliRole

    cls = KernelDeliRole
    if partition is not None:
        cls = partitioned_role_class(cls, partition)
    r = cls(
        shared_dir, owner, ttl_s=ttl_s, batch=batch,
        ckpt_interval_s=ckpt_interval_s, ckpt_bytes=ckpt_bytes,
        log_format=log_format, ckpt_duty=ckpt_duty, device=device,
    )
    if hb_interval_s is not None:
        r.hb_interval_s = hb_interval_s
    print(f"READY {r.name} {owner}", flush=True)
    while True:
        try:
            r.step()
        except FencedError as exc:
            # Recovery-path rejection (step() handles its own): a
            # successor owns the fence. Stand down loudly.
            r._m_fenced.inc()
            r.heartbeat()  # export the rejection before dying
            print(f"FENCED {role} {owner}: {exc}", flush=True)
            raise SystemExit(EXIT_FENCED)


# ---------------------------------------------------------------------------
# child entry
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)

    def _take(flag: str, default: Optional[str] = None) -> Optional[str]:
        if flag in args:
            i = args.index(flag)
            val = args[i + 1]
            del args[i:i + 2]
            return val
        return default

    role = _take("--role")
    shared_dir = _take("--dir")
    owner = _take("--owner") or f"{role}-pid{os.getpid()}"
    ttl = float(_take("--ttl", "1.0"))
    batch = int(_take("--batch", "512"))
    impl = _take("--impl") or os.environ.get("FLUID_DELI", "kernel")
    log_format = _take("--log-format")
    ckpt_interval = float(_take("--ckpt-interval", "0.25"))
    ckpt_bytes = int(_take("--ckpt-bytes", str(256 * 1024)))
    ckpt_duty = float(_take("--ckpt-duty", "0.2"))
    partition_s = _take("--partition")
    devices_s = _take("--deli-devices")
    hb_interval_s = _take("--hb-interval")
    device_plane_s = _take("--device-plane")
    device = _take("--device", "cuda")
    if (role is None or shared_dir is None or args
            or (log_format is not None and log_format not in LOG_FORMATS)
            or (partition_s is not None and not partition_s.isdigit())
            or (devices_s is not None and not devices_s.isdigit())):
        print(
            "usage: python -c \"from fluidframework_tpu_torch.server."
            "supervisor import main; main()\" --role deli --impl kernel "
            "--dir D [--owner O] [--ttl S] [--batch N] "
            "[--log-format json|columnar] [--partition K] "
            "[--device cuda|cpu] [--hb-interval S] "
            "[--ckpt-interval S] [--ckpt-bytes N] [--ckpt-duty F]",
            file=sys.stderr,
        )
        raise SystemExit(2)
    serve_role(shared_dir, role, owner, ttl_s=ttl, batch=batch,
               deli_impl=impl, ckpt_interval_s=ckpt_interval,
               ckpt_bytes=ckpt_bytes, log_format=log_format,
               ckpt_duty=ckpt_duty,
               partition=int(partition_s) if partition_s else None,
               deli_devices=int(devices_s) if devices_s else None,
               hb_interval_s=float(hb_interval_s)
               if hb_interval_s else None,
               device_plane=device_plane_s, device=device)
