"""config10's catch-up loop on the port: summarize a deltas log, then
join it cold both ways.

Copied from fluidframework_tpu/testing/deli_bench.py: `_drive_summarizer`
(:1562) and the loop of `run_catchup_bench` (:1658-1778; its broadcast
fan-out leg, `run_fanout_bench`, is not ported), on the port's
`server.summarizer` and `testing.fold_streams.build_mergetree_stream`.
config10 (tools/bench_configs.py:729) runs it at the defaults: prefixes
of 10,000, 30,000 and 100,000 ops of one stream from 4 clients, a
summary every 2,000 records.

For each log length L: write the prefix as the deltas topic, run the
summarizer role over it, then join cold by full-log replay
(`SummaryReplica(None)`) and by nearest summary + op tail
(`read_catchup` + blob boot); both joins must land on the same
`state_digest`.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Tuple

from .fold_streams import build_mergetree_stream

__all__ = ["catchup_summary_ops", "drive_summarizer", "kernel_launches",
           "manifests_of", "run_catchup", "write_deltas"]

LOG_LENGTHS = (10_000, 30_000, 100_000)
SUMMARY_OPS = 2000
N_CLIENTS = 4


def catchup_summary_ops(summary_ops: int, min_len: int) -> int:
    """`run_catchup_bench`'s clamp: every swept length must emit
    several summaries (full scale: 2000 < 10000 // 4, unchanged)."""
    return max(16, min(int(summary_ops), min_len // 4))


def kernel_launches() -> dict:
    """The launch counts of the two kernels this path runs: the scan
    (``kernel`` backend, every `SummaryReplica`) and kernel A
    (``overlay`` backend)."""
    from ..ops.mergetree_scan import mergetree_scan_kernel
    from ..ops.overlay import overlay_chunk_kernel

    return {"scan": mergetree_scan_kernel.launches,
            "overlay": overlay_chunk_kernel.launches}


def _since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


def manifests_of(shared: str, log_format: str,
                 name: str = "summaries") -> List[dict]:
    """The summary records of a manifest topic, in order."""
    from ..server.columnar_log import make_topic

    topic = make_topic(os.path.join(shared, "topics", f"{name}.jsonl"),
                       log_format)
    return [r for r in topic.read_from(0)
            if isinstance(r, dict) and r.get("kind") == "summary"]


def write_deltas(shared: str, records: List[dict], log_format: str,
                 frame: int = 16384) -> None:
    """`records` as the deltas topic of `shared`, appended in frames of
    `frame` (the bench's appends)."""
    from ..server.columnar_log import make_topic

    os.makedirs(os.path.join(shared, "topics"), exist_ok=True)
    deltas = make_topic(os.path.join(shared, "topics", "deltas.jsonl"),
                        log_format)
    for lo in range(0, len(records), frame):
        deltas.append_many(records[lo:lo + frame])


def drive_summarizer(shared: str, log_format: str, summary_ops: int,
                     batch: int = 4096, device=None,
                     fold_backend: str = "kernel",
                     setup: Optional[Callable] = None,
                     device_plane=None) -> dict:
    """Run the summarizer ROLE datapath (deltas → summaries + blobs) to
    quiescence over an already written deltas topic: the fold/emit
    path the supervised child runs, minus lease upkeep (no
    checkpoints; manifests carry ``byteOff`` None, as the reference's
    `_drive_summarizer` leaves them). `setup(role)` runs before the
    first read (instrumentation); `device_plane` is the role's.
    Returns ``seconds``, ``poll_s`` (the reads and their decode),
    ``records``, ``summaries``, the kernels' ``launches`` and the
    ``role``."""
    from ..server.columnar_log import make_tail_reader, make_topic
    from ..server.summarizer import SummarizerRole

    deltas = make_topic(
        os.path.join(shared, "topics", "deltas.jsonl"), log_format
    )
    role = SummarizerRole(shared, owner="bench-summ", ttl_s=3600.0,
                          log_format=log_format, summary_ops=summary_ops,
                          fold_backend=fold_backend, device=device,
                          device_plane=device_plane)
    role.fence = 1
    if setup is not None:
        setup(role)
    reader = make_tail_reader(deltas)
    # The counter is process-global (shared registry labels): report
    # THIS run's delta.
    summ0 = int(role._m_summaries.value)
    before = kernel_launches()
    n, poll_s = 0, 0.0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        entries = reader.poll(batch)
        poll_s += time.perf_counter() - t
        if not entries:
            break
        out: List[dict] = []
        for line_idx, rec in entries:
            role.process(line_idx, rec, out)
        role.flush_batch(out)
        if out:
            role.out_topic.append_many(out, fence=1, owner="bench-summ")
        role.offset = reader.next_line
        n += len(entries)
    return {"seconds": time.perf_counter() - t0, "poll_s": poll_s,
            "records": n,
            "summaries": int(role._m_summaries.value) - summ0,
            "launches": _since(before), "role": role}


def run_catchup(log_lengths: Tuple[int, ...] = LOG_LENGTHS,
                summary_ops: int = SUMMARY_OPS, n_clients: int = N_CLIENTS,
                log_format: str = "json", device=None,
                fold_backend: str = "kernel", warm: bool = True,
                setup: Optional[Callable] = None,
                cold: Optional[dict] = None,
                work_dir: Optional[str] = None) -> dict:
    """Cold-join latency against log length, with and without
    summaries (`run_catchup_bench`'s loop). Raises AssertionError when
    the summary join and the full replay disagree at any L. Returns
    per L ``full_replay_ms``, ``summary_join_ms`` and its
    ``join_split_ms`` (the index poll, the blob get with the reverse
    tail read, the boot, the tail's apply with the digest),
    ``speedup``, ``summary_seq``, ``tail_ops``, ``blob_bytes``,
    ``summarize_s``, ``poll_s``, ``records``, ``summaries``, the
    ``manifests``, the cold ``digest`` and the kernels' ``launches`` in
    the role, the cold replay and the join; and ``speedup`` and
    ``join_flatness`` over the sweep. Each join is timed to a readable
    state (its digest). `warm` runs the
    reference's untimed mini-cycle first; `setup(role, L)` runs before
    each timed role reads (instrumentation). The full replay reads no
    topic, so a sweep on the other format may pass the first sweep's
    result as `cold`: its full replays (time, digest, launches) stand
    for this one's, and are not run again."""
    from ..server.summarizer import (
        SummaryIndex,
        SummaryReplica,
        open_summary_store,
        read_catchup,
    )

    scratch = work_dir or tempfile.mkdtemp(prefix="catchup-")
    try:
        lengths = tuple(sorted(set(int(x) for x in log_lengths)))
        summary_ops = catchup_summary_ops(summary_ops, lengths[0])
        stream = build_mergetree_stream(max(lengths), n_clients=n_clients)
        joins = n_clients  # the join records ride ahead of the ops
        if warm:
            warm_L = min(1024, lengths[0])
            warm_dir = os.path.join(scratch, "warm")
            warm_prefix = stream[: joins + warm_L]
            write_deltas(warm_dir, warm_prefix, log_format)
            drive_summarizer(warm_dir, log_format,
                             max(64, min(summary_ops, warm_L // 2)),
                             device=device, fold_backend=fold_backend)
            SummaryReplica(None, device=device).apply_records(warm_prefix)
            wcu = read_catchup(warm_dir, "doc0", log_format,
                               store=open_summary_store(warm_dir))
            SummaryReplica(wcu["blob"], device=device).apply_records(
                wcu["ops"])
        runs: List[dict] = []
        for L in lengths:
            ldir = os.path.join(scratch, f"L{L}")
            prefix = stream[: joins + L]
            write_deltas(ldir, prefix, log_format)
            summ = drive_summarizer(
                ldir, log_format, summary_ops, device=device,
                fold_backend=fold_backend,
                setup=None if setup is None else lambda r: setup(r, L))
            store = open_summary_store(ldir)

            if cold is None:
                before = kernel_launches()
                t0 = time.perf_counter()
                full = SummaryReplica(None, device=device)
                full.apply_records(prefix)
                digest = full.state_digest()
                cold_s = time.perf_counter() - t0
                cold_launches = _since(before)
            else:
                prev = next(r for r in cold["runs"] if r["log_len"] == L)
                digest, cold_s = prev["digest"], prev["full_replay_ms"] / 1e3
                cold_launches = prev["launches"]["cold"]

            before = kernel_launches()
            t = [time.perf_counter()]
            idx = SummaryIndex(ldir, log_format)
            idx.poll()
            t.append(time.perf_counter())
            cu = read_catchup(ldir, "doc0", log_format, index=idx,
                              store=store)
            t.append(time.perf_counter())
            boot = SummaryReplica(cu["blob"], device=device)
            t.append(time.perf_counter())
            boot.apply_records(cu["ops"])
            got = boot.state_digest()
            t.append(time.perf_counter())
            warm_s = t[-1] - t[0]
            join_launches = _since(before)

            assert cu["manifest"] is not None, f"no summary at L={L}"
            assert got == digest, (
                f"summary+tail boot diverges from full replay at L={L}"
            )
            runs.append({
                "log_len": L,
                "full_replay_ms": cold_s * 1000.0,
                "summary_join_ms": warm_s * 1000.0,
                "join_split_ms": dict(zip(
                    ("index_poll", "blob_get_and_tail", "boot",
                     "tail_apply"),
                    ((b - a) * 1000.0 for a, b in zip(t, t[1:])))),
                "speedup": cold_s / warm_s,
                "summary_seq": cu["manifest"]["seq"],
                "tail_ops": len(cu["ops"]),
                "blob_bytes": cu["manifest"]["bytes"],
                "summarize_s": summ["seconds"],
                "poll_s": summ["poll_s"],
                "records": summ["records"],
                "summaries": summ["summaries"],
                "manifests": manifests_of(ldir, log_format),
                "digest": digest,
                "launches": {"role": summ["launches"],
                             "cold": cold_launches,
                             "join": join_launches},
            })
        lo, hi = runs[0], runs[-1]
        return {
            "log_format": log_format, "summary_ops": summary_ops,
            "runs": runs, "speedup": hi["speedup"],
            "join_flatness": hi["summary_join_ms"]
            / max(1e-9, lo["summary_join_ms"]),
        }
    finally:
        if work_dir is None:
            shutil.rmtree(scratch, ignore_errors=True)
