"""Cross-process topics, doorbells, fenced leases and checkpoints.

Copied from fluidframework_tpu/server/queue.py: `FencedError` (:37),
`_check_fence` (:45), `flock_exclusive` (:60), `check_disk_fault`
(:105), `retry_durable` (:131), `fsync_file` (:196), `SharedFileTopic`
(:207), the doorbells (`doorbells_enabled`, `TopicDoorbell`,
`wait_doorbells`, :448-546), `TailReader` (:547), `LeaseManager`
(:651), `FencedCheckpointStore` (:914) and `partition_suffix` (:1225).
Left out: the producer/consumer protocols, the range leases and the
partition topology (ROADMAP.md Queue 1 item 4). The file formats
(topic lines, the ``.fence`` sidecar, lease and checkpoint JSON) are
the reference's, so roles of either package share one directory.

- `SharedFileTopic` is a cross-process topic: multi-writer appends
  under an OS file lock, consumers tail from a checkpointed offset.
- `LeaseManager` is partition ownership with expiry-based failover:
  an owner acquires a lease with a fresh fencing token, renews it
  while alive, and a peer takes over a lease that expires.
- `FencedCheckpointStore` keeps one checkpoint per key, written
  atomically and refused from a fence older than the last accepted.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import random
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, \
    Tuple


class FencedError(RuntimeError):
    """A write carried a fencing token older than (or tied with but not
    bound to) the one the target has already accepted: the writer is a
    deposed owner and its write must not land (the zookeeper/Kafka
    fencing contract — exactly-once rests on deposed owners being
    REJECTED at the write path, not merely asked to stand down)."""


def _check_fence(cur_fence: int, cur_owner: Optional[str],
                 fence: int, owner: Optional[str], what: str) -> None:
    """THE fence-gate rule, shared by every fenced write path: reject a
    fence below the highest accepted, or an equal fence from a
    different owner than the one it first bound to (ties broken by
    first binder — the guard for the pathological same-fence split)."""
    if fence < cur_fence or (fence == cur_fence and cur_owner is not None
                             and owner != cur_owner):
        raise FencedError(
            f"{what}: fence {fence} ({owner}) rejected; already bound "
            f"to {cur_fence} ({cur_owner})"
        )


@contextlib.contextmanager
def flock_exclusive(f, lock_timeout_s: Optional[float],
                    path: str) -> Iterator[None]:
    """Exclusive flock on `f` for one append critical section. With a
    timeout, acquisition is bounded (LOCK_NB polling) so a takeover
    successor never wedges behind a stalled — e.g. SIGSTOPped —
    writer's lock: it times out, has the zombie killed (the
    supervisor's stale-heartbeat role), and retries. Shared by every
    topic flavor so the takeover protocol cannot fork."""
    import fcntl

    if lock_timeout_s is None:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
    else:
        deadline = time.time() + lock_timeout_s
        while True:
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError(
                        f"append lock on {path} held past "
                        f"{lock_timeout_s}s"
                    )
                time.sleep(0.005)
    try:
        yield
    finally:
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)


# ---------------------------------------------------------------------------
# storage-fault seam (the chaos harness's disk fault class)
# ---------------------------------------------------------------------------

# Path of a JSON fault-spec file; when set, every durable write path
# (topic append, checkpoint save) consults it right before fsync. The
# chaos harness points CHILD processes at a spec it toggles mid-run:
#   {"mode": "enospc"}                -> the write raises OSError(ENOSPC)
#   {"mode": "stall", "stall_s": S}   -> the fsync stalls S seconds
#   optional "kinds": ["topic", ...]  -> restrict to those write paths
# Unset (production) the check is a single dict lookup.
DISK_FAULT_ENV = "FLUID_DISK_FAULT"


def check_disk_fault(kind: str) -> None:
    """Injection point for the storage failure classes a real deli farm
    meets (volume full, device write stall): called with the write
    about to go durable, so an injected ENOSPC aborts BEFORE bytes land
    — exactly where the real error surfaces — and a stall sits where a
    slow fsync would."""
    spec_path = os.environ.get(DISK_FAULT_ENV)
    if not spec_path:
        return
    try:
        with open(spec_path) as f:
            spec = json.load(f)
    except (OSError, ValueError):
        return  # no/garbled spec: no fault
    if not isinstance(spec, dict):
        return
    kinds = spec.get("kinds")
    if kinds and kind not in kinds:
        return
    mode = spec.get("mode")
    if mode == "enospc":
        raise OSError(errno.ENOSPC, f"injected ENOSPC on {kind} write")
    if mode == "stall":
        time.sleep(float(spec.get("stall_s", 0.25)))


def retry_durable(fn: Callable[[], Any], attempts: int = 8,
                  base_s: float = 0.02, cap_s: float = 0.5,
                  on_retry: Optional[Callable[[int, BaseException, float],
                                              None]] = None) -> Any:
    """Bounded-retry jittered backoff for DURABLE writes (topic append,
    checkpoint save) under transient storage failure — ENOSPC, EIO, a
    stalled volume. Graceful degradation, not masking: `on_retry` fires
    per attempt so the caller can flag itself degraded (heartbeat,
    metrics) while it waits, and once the budget is spent the error
    surfaces (hard-fail — the supervisor's restart is the next line of
    defense). `FencedError` is a RuntimeError, not an OSError, so a
    deposed writer is never retried back to life."""
    k = 0
    while True:
        try:
            return fn()
        except OSError as exc:
            if k >= attempts - 1:
                raise
            delay = min(cap_s, base_s * (1 << k))
            delay *= 0.5 + random.random() * 0.5  # jitter: desync peers
            if on_retry is not None:
                on_retry(k, exc, delay)
            time.sleep(delay)
            k += 1


def fsync_file(f, kind: str = "topic") -> None:
    """One counted fsync: every durable-write fsync on the hot path
    routes through here so `topic_fsyncs_total{kind=}` reports the
    per-record durability floor the fused-hop work attacks (the
    bench's fsyncs-per-record evidence)."""
    os.fsync(f.fileno())
    from ..utils.metrics import get_registry

    get_registry().counter("topic_fsyncs_total", kind=kind).inc()


class SharedFileTopic:
    """A cross-process topic over one JSONL file.

    Appends take an OS file lock (multi-writer safe); consumers tail
    the file from a LINE offset, re-reading anything new on each poll
    — the minimal faithful form of a shared Kafka partition. Entries
    are plain JSON values.

    Robustness contract (the chaos-harness substrate):

    - **Torn tail** — a reader never consumes a final line lacking its
      trailing newline (an append in progress, or a writer that died
      mid-write); the line is re-read complete on the next poll. The
      next append SEALS a crash-torn tail with a newline first, so the
      junk remnant becomes one unparseable line instead of corrupting
      the following record; readers skip (but still count) lines that
      fail to parse.
    - **Fencing** — appends may carry a ``fence`` token (+ owner). The
      topic remembers the highest accepted (fence, owner) in a sidecar
      file, updated under the same append lock; a lower fence — or an
      equal fence from a different owner than the one it first bound
      to — raises :class:`FencedError` and writes nothing. This is
      what makes a deposed lease holder's post-takeover writes
      *demonstrably rejected* rather than merely discouraged.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "a"):
                pass
        # Doorbell producer state: cached write fds into registered
        # consumer bells (re-listed per ring — see _ring_doorbells).
        self._bell_wfds: Dict[str, int] = {}

    def __del__(self):
        # Short-lived topic objects (probes, one-shot appenders) must
        # not leak the ring fds they cached.
        for fd in (getattr(self, "_bell_wfds", None) or {}).values():
            try:
                os.close(fd)
            except Exception:
                pass

    # -------------------------------------------------------- doorbells

    def _ring_doorbells(self) -> None:
        """Wake every doorbell-registered consumer of this topic (one
        byte per bell). Costs a single failed stat when no consumer
        ever registered; rings AFTER the append went durable, outside
        the append lock, so waking consumers never contend with the
        writer. Purely advisory — any failure here degrades to the
        consumer's bounded-timeout poll."""
        d = self.path + ".bells"
        try:
            names = {n for n in os.listdir(d) if not n.startswith(".")}
        except OSError:
            return  # no consumer ever registered: one failed syscall
        # Re-list per ring rather than caching on the dir mtime: write
        # fds are still cached (the per-ring cost is one listdir next
        # to an append that already paid open+flock+fsync), but
        # DISCOVERY never trusts directory attributes — network/
        # passthrough filesystems (v9fs CI containers) cache those
        # across processes, and a bell registered after the first scan
        # would stay invisible to the ringer forever.
        cache = self._bell_wfds
        for name in list(cache):
            if name not in names:
                try:
                    os.close(cache.pop(name))
                except OSError:
                    cache.pop(name, None)
        for name in names:
            if name in cache:
                continue
            try:
                cache[name] = os.open(
                    os.path.join(d, name),
                    os.O_WRONLY | os.O_NONBLOCK,
                )
            except OSError as exc:
                # ENXIO alone means "no live reader" — the consumer
                # died (its O_RDWR fd vanished with it); reap the bell
                # so a churned farm can't accumulate dead FIFOs. Any
                # OTHER error (EMFILE, EACCES...) is a PRODUCER-side
                # problem: unlinking would permanently sever a live
                # consumer with no re-registration path — leave it for
                # a later ring to open.
                if exc.errno == errno.ENXIO:
                    try:
                        os.unlink(os.path.join(d, name))
                    except OSError:
                        pass
        for name, fd in list(cache.items()):
            try:
                os.write(fd, b"!")
            except BlockingIOError:
                pass  # pipe full: a wake is already pending
            except OSError:
                # Reader went away since we opened (EPIPE): drop the
                # fd; the next ring's listing reaps the file.
                try:
                    os.close(fd)
                except OSError:
                    pass
                cache.pop(name, None)

    # ------------------------------------------------------------ fence

    def _fence_path(self) -> str:
        return self.path + ".fence"

    def latest_fence(self) -> Tuple[int, Optional[str]]:
        """The highest (fence, owner) this topic has accepted."""
        try:
            with open(self._fence_path()) as f:
                d = json.load(f)
            return int(d.get("fence", 0)), d.get("owner")
        except (OSError, ValueError):
            return 0, None

    def _gate_fence(self, fence: Optional[int],
                    owner: Optional[str]) -> None:
        """Check-and-advance the fence sidecar. Caller holds the
        append lock, so read-modify-write is race-free."""
        if fence is None:
            return
        cur, cur_owner = self.latest_fence()
        _check_fence(cur, cur_owner, fence, owner,
                     os.path.basename(self.path))
        if fence > cur or cur_owner is None:
            tmp = self._fence_path() + f".tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"fence": fence, "owner": owner}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._fence_path())

    # ----------------------------------------------------------- append

    def append(self, message: Any, fence: Optional[int] = None,
               owner: Optional[str] = None) -> int:
        return self.append_many([message], fence=fence, owner=owner)

    def append_many(self, messages: List[Any],
                    fence: Optional[int] = None,
                    owner: Optional[str] = None,
                    lock_timeout_s: Optional[float] = None,
                    fsync: bool = True) -> int:
        """Append a batch under the OS lock; returns the payload bytes
        written (the byte-based checkpoint-cadence signal).

        ``fsync=False`` skips the data fsync: the append is ordered
        and torn-tail-safe (readers never consume an incomplete line)
        but not crash-durable — for DERIVED feeds whose records are
        deterministically regenerable from an upstream durable topic
        (the fused hop's broadcast leg), where exactly-once recovery
        re-emits anything the page cache lost."""
        # An empty batch still gates: a deposed owner must learn it is
        # deposed even when it has nothing to write.
        payload = b"".join(
            json.dumps(m).encode() + b"\n" for m in messages
        )
        with open(self.path, "r+b") as f:
            with flock_exclusive(f, lock_timeout_s, self.path):
                self._gate_fence(fence, owner)
                f.seek(0, os.SEEK_END)
                pos = f.tell()
                if pos > 0:
                    f.seek(pos - 1)
                    if f.read(1) != b"\n":
                        # A writer died mid-append: seal its torn line
                        # so our record starts on a fresh line and the
                        # remnant parses (and is skipped) as one junk
                        # line.
                        f.write(b"\n")
                check_disk_fault("topic")
                f.write(payload)
                f.flush()
                if fsync:
                    fsync_file(f, "topic")
        if messages:
            self._ring_doorbells()
        return len(payload)

    # ------------------------------------------------------------- read

    def read_entries(self, offset: int,
                     max_count: Optional[int] = None
                     ) -> Tuple[List[Tuple[int, Any]], int]:
        """Parse lines from line-index `offset`. Returns
        ``([(line_index, value), ...], next_offset)``.

        A final line without a trailing newline is NOT consumed (it is
        an append in progress — complete on the next poll); a complete
        line that fails to parse (sealed torn remnant) is skipped but
        still counted, so offsets stay stable across all readers.

        `max_count` caps the PARSED entries taken (micro-batch bound:
        consumers yield between batches instead of swallowing a whole
        backlog); next_offset then resumes right after the last entry
        taken, with skipped junk lines staying counted."""
        with open(self.path, "rb") as f:
            data = f.read()
        if not data:
            return [], offset
        lines = data.split(b"\n")
        # Drop the final element either way: it is the '' split
        # artifact of a newline-terminated file, or a torn
        # (in-progress) line that must be re-read complete next poll.
        lines.pop()
        out: List[Tuple[int, Any]] = []
        for i in range(offset, len(lines)):
            if max_count is not None and len(out) >= max_count:
                return out, (out[-1][0] + 1 if out else offset)
            line = lines[i].strip()
            if not line:
                continue
            try:
                out.append((i, json.loads(line)))
            except ValueError:
                continue  # sealed junk from a crashed writer
        return out, max(offset, len(lines))

    def read_from(self, offset: int) -> List[Any]:
        return [v for _, v in self.read_entries(offset)[0]]


# ---------------------------------------------------------------------------
# topic doorbells (event-driven new-records wakeup)
# ---------------------------------------------------------------------------

# Kill switch: FLUID_DOORBELL=0 keeps every consumer on the pure poll
# loop (the latency bench's baseline variant; also the escape hatch on
# a platform where FIFOs misbehave).
DOORBELL_ENV = "FLUID_DOORBELL"

_bell_seq = 0


def doorbells_enabled() -> bool:
    """Whether event-driven topic wakeups are available AND wanted.
    Doorbells are advisory only — with them off (or unsupported: no
    ``os.mkfifo``), every consumer falls back to the bounded-timeout
    poll loop it always had, so fencing/torn-read semantics never
    depend on this answer."""
    return (os.environ.get(DOORBELL_ENV, "1").lower()
            not in ("0", "off", "no")
            and hasattr(os, "mkfifo"))


class TopicDoorbell:
    """One consumer's wakeup line for one topic.

    A FIFO under ``<topic path>.bells/``: `append_many` writes one
    byte into every registered bell after its records are durable, and
    the consumer waits on its bell with a BOUNDED timeout — so the
    idle-poll interval stack that dominates low-load end-to-end
    latency collapses to an event wake, while the timeout keeps poll
    as the correctness fallback (a bell rung between the consumer's
    empty poll and its wait, a lost FIFO, a disabled platform: all
    degrade to exactly the old behavior).

    The consumer holds the FIFO open O_RDWR (nonblocking): the
    always-present reader means a producer's O_WRONLY|O_NONBLOCK open
    succeeds while the consumer lives (ENXIO = consumer died, the
    producer garbage-collects the bell), and the always-present writer
    means the read end never signals EOF-readable to select — no busy
    wake. The FIFO is created under a dot-name and renamed into place
    only after the read end is open, so a producer can never observe a
    bell without a live reader and wrongly reap it."""

    def __init__(self, topic_path: str):
        global _bell_seq
        self.dir = topic_path + ".bells"
        os.makedirs(self.dir, exist_ok=True)
        _bell_seq += 1
        name = f"{os.getpid()}-{_bell_seq}.bell"
        tmp = os.path.join(self.dir, f".{name}.tmp")
        self.path = os.path.join(self.dir, name)
        os.mkfifo(tmp)
        self._fd = os.open(tmp, os.O_RDWR | os.O_NONBLOCK)
        os.rename(tmp, self.path)

    def fileno(self) -> int:
        return self._fd

    def drain(self) -> bool:
        """Consume pending ring bytes; True iff any were pending."""
        rang = False
        try:
            while os.read(self._fd, 4096):
                rang = True
        except (BlockingIOError, OSError):
            pass
        return rang

    def wait(self, timeout_s: float) -> bool:
        return wait_doorbells([self], timeout_s)

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        try:
            os.unlink(self.path)
        except OSError:
            pass


def wait_doorbells(bells: List["TopicDoorbell"],
                   timeout_s: float) -> bool:
    """Sleep until ANY of `bells` rings or `timeout_s` elapses (the
    poll fallback); returns whether a ring woke us. Rings that arrived
    while the consumer was busy processing are still pending in the
    pipe, so the next wait returns immediately — a wakeup is never
    lost, only (harmlessly) early."""
    import select

    fds = [b._fd for b in bells if b is not None and b._fd is not None]
    if not fds:
        time.sleep(timeout_s)
        return False
    try:
        ready, _, _ = select.select(fds, [], [], timeout_s)
    except OSError:
        time.sleep(timeout_s)
        return False
    if not ready:
        return False
    for b in bells:
        if b is not None and b._fd in ready:
            b.drain()
    return True


class TailReader:
    """Incremental reader over a `SharedFileTopic`: remembers the byte
    position of the last fully-consumed line, so each poll reads only
    NEW bytes instead of re-reading (and re-splitting) the whole file —
    `read_entries` is O(file) per call, which makes a long-lived
    consumer O(file²) over its lifetime; the lambda roles and the
    pipeline bench tail topics through this instead.

    Same robustness contract as `read_entries`: a final line without
    its trailing newline is not consumed (byte position stays before
    it), junk lines are skipped but still counted, and line indices
    (`next_line`) stay identical to `read_entries` offsets — so
    checkpointed line offsets and `inOff` bookkeeping are unchanged."""

    def __init__(self, topic: SharedFileTopic, line_offset: int = 0):
        self.topic = topic
        self.next_line = line_offset
        self._pos = 0
        # Lines the caller's offset is AHEAD of the file (a checkpoint
        # taken against a longer topic): consumed silently as they
        # appear, never delivered — matching read_entries(offset),
        # which returns nothing below the requested offset.
        self._behind = 0
        if line_offset > 0:
            # One O(file) skip to translate the line offset into a byte
            # position; everything after is incremental.
            with open(topic.path, "rb") as f:
                data = f.read()
            lines = data.split(b"\n")
            lines.pop()
            take = min(line_offset, len(lines))
            self._pos = sum(len(l) + 1 for l in lines[:take])
            self._behind = line_offset - take

    def poll(self, max_count: Optional[int] = None
             ) -> List[Tuple[int, Any]]:
        """Parse up to `max_count` new complete entries; returns
        [(line_index, value), ...] and advances past them."""
        with open(self.topic.path, "rb") as f:
            f.seek(self._pos)
            data = f.read()
        if not data:
            return []
        end = data.rfind(b"\n")
        if end < 0:
            return []  # torn tail only: re-read complete next poll
        lines = data[:end].split(b"\n")
        out: List[Tuple[int, Any]] = []
        pos = self._pos
        line_no = self.next_line
        loads = json.loads
        for raw in lines:
            if self._behind:
                # Below the requested offset: swallow without delivery
                # (next_line already accounts for these lines).
                self._behind -= 1
                pos += len(raw) + 1
                continue
            if max_count is not None and len(out) >= max_count:
                break
            pos += len(raw) + 1
            line = raw.strip()
            if line:
                try:
                    out.append((line_no, loads(line)))
                except ValueError:
                    pass  # sealed junk from a crashed writer
            line_no += 1
        self._pos = pos
        self.next_line = line_no
        return out



class _ClaimBusy(Exception):
    """Another worker holds the arbitration claim right now."""


class LeaseManager:
    """Expiry-based partition leases over a shared directory.

    A lease is a JSON file `<dir>/<partition>.lease` holding
    ``{"owner", "expires", "fence"}``. All mutations — acquire, renew,
    release — are arbitrated under an ``O_CREAT|O_EXCL`` claim file
    (`<partition>.lease.claim`): exactly one worker can create it, so
    the read-decide-write sequence is a critical section and two
    workers racing for an expired lease can no longer both "win" with
    the same fence (a read-back arbitration would let racer A read
    back before racer B renamed over it).

    Fences are allocated from a monotonic counter file
    (`<partition>.lease.fencecounter`) updated only inside the claim,
    so every ownership change gets a strictly larger token even if the
    lease file itself is deleted. Claimant liveness is carried by a
    kernel flock held on the claim fd for the whole critical section:
    a crashed claimant's claim is broken immediately (its lock died
    with it), while a live-but-stalled claimant's claim is never
    broken — so two arbitrators can't coexist and fences can't split.
    Belt-and-braces, the WRITE path still enforces tokens: fenced
    topics/checkpoints bind each fence value to the first owner that
    uses it and reject any other (`SharedFileTopic` appends /
    `FencedCheckpointStore.save` raise `FencedError`).
    """

    def __init__(self, directory: str, owner: str, ttl_s: float = 2.0,
                 claim_ttl_s: float = 1.0,
                 fence_scope: Optional[str] = None):
        """`fence_scope` names a SHARED monotonic fence counter all of
        this manager's partitions allocate from (file
        ``<dir>/<scope>.fencecounter``) instead of the default
        per-partition counter. The elastic fabric needs it: after a
        range split/merge the successor binds its fence on the
        PREDECESSOR's topics, so fences must be comparable across
        lease keys — one fabric-wide counter makes every ownership
        change anywhere strictly newer than everything before it."""
        self.dir = directory
        self.owner = owner
        self.ttl_s = ttl_s
        self.claim_ttl_s = claim_ttl_s
        self.fence_scope = fence_scope
        os.makedirs(directory, exist_ok=True)

    def _path(self, partition: str) -> str:
        return os.path.join(self.dir, f"{partition}.lease")

    def _read(self, partition: str) -> Optional[dict]:
        try:
            with open(self._path(partition)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write(self, partition: str, lease: dict) -> None:
        tmp = self._path(partition) + f".tmp.{self.owner}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(lease, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(partition))

    # -------------------------------------------------------- the claim

    @contextlib.contextmanager
    def _claim(self, partition: str,
               timeout_s: Optional[float] = None) -> Iterator[None]:
        """O_CREAT|O_EXCL mutual exclusion for lease arbitration.
        Raises `_ClaimBusy` if the claim stays foreign past
        `timeout_s` (default: claim_ttl_s).

        Holder liveness is probed through a kernel flock the claimant
        holds on its claim fd for the whole critical section: a dead
        claimant's lock vanishes with the process (so its claim is
        safely broken by whichever single breaker wins the lock), a
        live-but-stopped claimant's lock persists (so its claim is
        NEVER broken and the two-winners split cannot happen, unlike
        mtime-staleness breaking). It also makes release trivially
        safe: our claim can only have been broken if this process
        died, so the final unlink is always our own file."""
        import fcntl

        path = self._path(partition) + ".claim"
        deadline = time.time() + (
            self.claim_ttl_s if timeout_s is None else timeout_s
        )
        fd: Optional[int] = None
        while True:
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR)
            except FileExistsError:
                try:
                    probe = os.open(path, os.O_RDWR)
                except OSError:
                    continue  # released between EEXIST and open; retry
                try:
                    try:
                        fcntl.flock(probe, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    except OSError:
                        # A live holder (possibly stopped) — wait.
                        if time.time() > deadline:
                            raise _ClaimBusy(partition)
                        time.sleep(0.002)
                        continue
                    # Lock acquired: the holder died before releasing.
                    # Racing breakers serialize on this lock, and while
                    # we hold it no new claimant can unlink the path,
                    # so break it only if it still names our inode.
                    try:
                        if os.stat(path).st_ino == os.fstat(probe).st_ino:
                            os.unlink(path)
                    except OSError:
                        pass
                finally:
                    os.close(probe)
                continue
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                # A prober grabbed the lock on our just-created claim
                # before we could (and will break it as holderless).
                # Stand down and retry.
                os.close(fd)
                fd = None
                if time.time() > deadline:
                    raise _ClaimBusy(partition)
                continue
            # Close the create→flock window: a breaker that saw our
            # claim unlocked may have unlinked it; if the path no
            # longer names our inode, stand down and retry.
            try:
                same = os.stat(path).st_ino == os.fstat(fd).st_ino
            except OSError:
                same = False
            if not same:
                os.close(fd)
                fd = None
                continue
            break
        try:
            os.write(fd, f"{self.owner} {os.getpid()}".encode())
            yield
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass
            os.close(fd)  # releases the liveness lock

    def _next_fence(self, partition: str, cur: Optional[dict]) -> int:
        """Allocate the next fencing token from the monotonic counter
        (called only inside the claim). max() with the lease's own
        fence heals a lost/stale counter file.

        A scoped (shared) counter is serialized by its own flock: the
        per-partition claim no longer covers it, and two DIFFERENT
        keys' claims racing the read-modify-write could mint TIED
        fences — which the write-path tie rule would then reject for
        whichever owner binds second, livelocking a legitimate
        successor (the split-children race)."""
        if self.fence_scope is not None:
            cpath = os.path.join(
                self.dir, f"{self.fence_scope}.fencecounter"
            )
            lock = open(cpath + ".lock", "a+")
        else:
            cpath = self._path(partition) + ".fencecounter"
            lock = None
        try:
            if lock is not None:
                with flock_exclusive(lock, None, cpath):
                    return self._bump_fence(cpath, cur)
            return self._bump_fence(cpath, cur)
        finally:
            if lock is not None:
                lock.close()

    def _bump_fence(self, cpath: str, cur: Optional[dict]) -> int:
        try:
            with open(cpath) as f:
                counter = int(f.read().strip() or 0)
        except (OSError, ValueError):
            counter = 0
        fence = max(counter, int(cur.get("fence", 0)) if cur else 0) + 1
        tmp = cpath + f".tmp.{self.owner}.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(fence))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, cpath)
        return fence

    # ------------------------------------------------------- operations

    def try_acquire(self, partition: str,
                    now: Optional[float] = None) -> Optional[int]:
        """Acquire `partition` if unowned, expired, or already ours.
        Returns the fencing token on success, None otherwise."""
        now = time.time() if now is None else now
        try:
            with self._claim(partition):
                cur = self._read(partition)
                if cur is not None:
                    if cur.get("owner") == self.owner:
                        return int(cur.get("fence", 0))
                    if float(cur.get("expires", 0)) > now:
                        return None  # live foreign lease
                fence = self._next_fence(partition, cur)
                self._write(partition, {
                    "owner": self.owner, "expires": now + self.ttl_s,
                    "fence": fence,
                })
                return fence
        except _ClaimBusy:
            return None  # a peer is arbitrating; try again next sweep

    def renew(self, partition: str,
              now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        try:
            with self._claim(partition):
                cur = self._read(partition)
                if cur is None or cur.get("owner") != self.owner:
                    return False  # deposed
                self._write(partition, {**cur, "expires": now + self.ttl_s})
                return True
        except _ClaimBusy:
            # Can't prove ownership right now; claiming failure is the
            # safe answer (the worker stands down, fencing protects
            # anything it had in flight).
            return False

    def release(self, partition: str) -> None:
        try:
            with self._claim(partition):
                cur = self._read(partition)
                if cur is not None and cur.get("owner") == self.owner:
                    self._write(partition, {**cur, "expires": 0})
        except _ClaimBusy:
            pass  # lease will expire on its own

    def owner_of(self, partition: str,
                 now: Optional[float] = None) -> Optional[str]:
        info = self.lease_info(partition, now)
        return info["owner"] if info is not None else None

    def lease_info(self, partition: str,
                   now: Optional[float] = None) -> Optional[dict]:
        """The live lease as ``{"owner", "fence", "expires"}`` (None if
        unowned/expired). The fence is what lets a READER tell a stale
        pre-takeover (or pre-split) owner from the live one — owner
        strings alone cannot, since a restarted worker reuses its
        slot name while the fence strictly advances."""
        now = time.time() if now is None else now
        cur = self._read(partition)
        if cur is None or float(cur.get("expires", 0)) <= now:
            return None
        return {"owner": cur.get("owner"),
                "fence": int(cur.get("fence", 0)),
                "expires": float(cur.get("expires", 0))}


class FencedCheckpointStore:
    """Durable lambda checkpoints whose writes REJECT deposed owners.

    The reference's deli checkpoints to Mongo with the partition
    epoch as the fencing token; here each key is a JSON file
    ``{"fence", "owner", "state"}`` and `save` is a read-gate-write
    critical section under an OS file lock. A writer carrying a fence
    lower than the stored one — or an equal fence under a different
    owner than the one that first bound it — gets `FencedError`, so a
    deposed lease holder can never roll a successor's checkpoint back
    (the exactly-once recovery contract).
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.ckpt.json")

    def load(self, key: str) -> Optional[dict]:
        """The checkpoint envelope ({"fence", "owner", "state"}) or
        None."""
        try:
            with open(self._path(key)) as f:
                d = json.load(f)
            return d if isinstance(d, dict) and "state" in d else None
        except (OSError, ValueError):
            return None

    def save(self, key: str, state: Any, fence: int,
             owner: Optional[str] = None,
             lock_timeout_s: Optional[float] = None) -> int:
        """Fenced write; returns the serialized envelope size in bytes
        (the checkpoint-bytes metric's source)."""
        import fcntl

        lock_path = self._path(key) + ".lock"
        with open(lock_path, "a+") as lk:
            if lock_timeout_s is None:
                fcntl.flock(lk.fileno(), fcntl.LOCK_EX)
            else:
                deadline = time.time() + lock_timeout_s
                while True:
                    try:
                        fcntl.flock(
                            lk.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB
                        )
                        break
                    except OSError:
                        if time.time() > deadline:
                            raise TimeoutError(
                                f"checkpoint lock {key!r} held past "
                                f"{lock_timeout_s}s"
                            )
                        time.sleep(0.005)
            try:
                cur = self.load(key)
                if cur is not None:
                    _check_fence(
                        int(cur.get("fence", 0)), cur.get("owner"),
                        fence, owner, f"checkpoint {key!r}",
                    )
                tmp = self._path(key) + f".tmp.{os.getpid()}"
                payload = json.dumps(
                    {"fence": fence, "owner": owner, "state": state}
                )
                check_disk_fault("checkpoint")
                with open(tmp, "w") as f:
                    f.write(payload)
                    f.flush()
                    fsync_file(f, "checkpoint")
                os.replace(tmp, self._path(key))
            finally:
                fcntl.flock(lk.fileno(), fcntl.LOCK_UN)
        return len(payload)


def partition_suffix(name: str, partition: int) -> str:
    """THE partition naming rule: `name` sliced to partition `k` is
    ``{name}-p{k}`` — topics (``rawdeltas-p3`` → ``deltas-p3``), lease
    keys, checkpoint keys and role names all derive from this one
    function, so the fabric's identities can never drift apart."""
    return f"{name}-p{int(partition)}"
