#!/usr/bin/env python3
"""Write the summary service's golden file, computed by the JAX
package's summarizer role and readers.

    JAX_PLATFORMS=cpu python3 tools/summary_role_golden.py

config10 (`tools/bench_configs.py:729`) at its full size, as
`testing/deli_bench.run_catchup_bench` (:1658-1778) runs it: one
`build_mergetree_stream(100000, n_clients=4)` stream (seed 10, window
64, target length 400), its prefixes of L = 10,000, 30,000 and
100,000 ops (plus the 4 joins), a summary every 2000 records, on both
topic formats (``json``, ``columnar``), written as a deltas topic in
appends of 16384 records.

The JAX `SummarizerRole` (kernel fold backend) runs through the
reference's `_drive_summarizer` (:1562, reads of 4096), on each format
over the whole 100k log and, separately, over the 10k prefix's own
topic. A summary is a pure function of its document's op prefix (the
service's no-fork contract), so the manifests of the L-prefix are the
100k run's with ``count <= L + 4``; the 10k run checks that. Then the
JAX readers join each L both ways on the 100k topic with ``seq = L +
4``: the full replay (`SummaryReplica(None)` over the prefix, one
replay stepped through the three lengths in appends of 2000 records)
and the nearest summary + tail (`read_catchup(seq=)` + blob boot),
which must agree.

Records, per format and L: every manifest (all fields), the tail's
length, the newest summary's seq and the cold `state_digest`. Writes
fluidframework_tpu_torch/testing/summary_role_golden.json, in about
11 minutes on three CPU cores (three processes: each format's role and
the cold replay).
The topics live in a temporary directory that is removed afterwards.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                   "summary_role_golden.json")
LOG_LENGTHS = (10_000, 30_000, 100_000)
SUMMARY_OPS, N_CLIENTS, SEED, WINDOW, TARGET_LEN = 2000, 4, 10, 64, 400
APPEND = 16384  # the bench's append size
BATCH = 4096  # `_drive_summarizer`'s reads
FORMATS = ("json", "columnar")
sys.path.insert(0, ROOT)  # the spawned workers import the packages too


def manifests_of(shared: str, log_format: str):
    from fluidframework_tpu.server.columnar_log import make_topic

    topic = make_topic(os.path.join(shared, "topics", "summaries.jsonl"),
                       log_format)
    return [r for r in topic.read_from(0)
            if isinstance(r, dict) and r.get("kind") == "summary"]


def stream():
    from fluidframework_tpu.testing.deli_bench import build_mergetree_stream

    return build_mergetree_stream(max(LOG_LENGTHS), n_clients=N_CLIENTS,
                                  seed=SEED, window=WINDOW,
                                  target_len=TARGET_LEN)


def summarize(shared: str, records, log_format: str) -> list:
    """The deltas topic of `records`, the JAX role over it; its
    manifests."""
    from fluidframework_tpu.server.columnar_log import make_topic
    from fluidframework_tpu.testing.deli_bench import _drive_summarizer

    os.makedirs(os.path.join(shared, "topics"), exist_ok=True)
    deltas = make_topic(os.path.join(shared, "topics", "deltas.jsonl"),
                        log_format)
    for lo in range(0, len(records), APPEND):
        deltas.append_many(records[lo:lo + APPEND])
    _drive_summarizer(shared, log_format, SUMMARY_OPS, batch=BATCH)
    return manifests_of(shared, log_format)


def format_run(log_format: str) -> dict:
    """One format: the role over 100k and over the 10k prefix, then the
    summary joins at every L (tail length, summary seq, digest)."""
    from fluidframework_tpu.server.summarizer import (
        SummaryIndex,
        SummaryReplica,
        open_summary_store,
        read_catchup,
    )

    recs = stream()
    out = {}
    with tempfile.TemporaryDirectory(prefix="summary-role-golden-") as tmp:
        t0 = time.perf_counter()
        full = summarize(os.path.join(tmp, "full"), recs, log_format)
        t1 = time.perf_counter()
        short = summarize(os.path.join(tmp, "short"),
                          recs[: N_CLIENTS + LOG_LENGTHS[0]], log_format)
        if short != [m for m in full
                     if m["count"] <= N_CLIENTS + LOG_LENGTHS[0]]:
            raise AssertionError(f"{log_format}: the 10k run's manifests "
                                 f"are not the 100k run's prefix")
        shared = os.path.join(tmp, "full")
        idx = SummaryIndex(shared, log_format)
        store = open_summary_store(shared)
        for L in LOG_LENGTHS:
            top = N_CLIENTS + L
            cu = read_catchup(shared, "doc0", log_format, seq=top,
                              index=idx, store=store)
            boot = SummaryReplica(cu["blob"])
            boot.apply_records(cu["ops"])
            out[str(L)] = {
                "manifests": [m for m in full if m["count"] <= top],
                "tail_ops": len(cu["ops"]),
                "summary_seq": cu["manifest"]["seq"],
                "join_digest": boot.state_digest(),
            }
        print(f"{log_format}: role over {LOG_LENGTHS[-1]} ops in "
              f"{t1 - t0:.1f}s, {len(full)} manifests; the {LOG_LENGTHS[0]} "
              f"run and the joins in {time.perf_counter() - t1:.1f}s",
              flush=True)
    return out


def cold_run(_=None) -> dict:
    """The cold full replay stepped through the lengths: {L: digest}.
    The records go in appends of SUMMARY_OPS: a replica's state is a
    pure function of the records it applied, not of how they were
    batched, and one call over the whole log encodes every op before
    the first chunk, so its table grows to 262,144 rows and the replay
    runs for far longer (it had not finished after 20 minutes on a
    CPU)."""
    from fluidframework_tpu.server.summarizer import SummaryReplica

    recs = stream()
    cold = SummaryReplica(None)
    out, lo = {}, 0
    t0 = time.perf_counter()
    for L in LOG_LENGTHS:
        for hi in range(lo + SUMMARY_OPS, N_CLIENTS + L + SUMMARY_OPS,
                        SUMMARY_OPS):
            cold.apply_records(recs[lo: min(hi, N_CLIENTS + L)])
            lo = min(hi, N_CLIENTS + L)
        out[str(L)] = cold.state_digest()
    print(f"cold replay of {LOG_LENGTHS[-1]} ops in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return out


def main() -> int:
    import multiprocessing

    assert SUMMARY_OPS == max(16, min(SUMMARY_OPS, LOG_LENGTHS[0] // 4))
    t_all = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(FORMATS) + 1) as pool:
        fut = {fmt: pool.apply_async(format_run, (fmt,)) for fmt in FORMATS}
        cold = pool.apply_async(cold_run).get()
        runs = {fmt: fut[fmt].get() for fmt in FORMATS}
    for fmt in FORMATS:
        for L in LOG_LENGTHS:
            r = runs[fmt][str(L)]
            if r.pop("join_digest") != cold[str(L)]:
                raise AssertionError(f"{fmt} L={L}: summary join and full "
                                     f"replay disagree")
            r["digest"] = cold[str(L)]
    golden = {
        "source": "tools/summary_role_golden.py: the JAX SummarizerRole "
                  "(kernel fold backend) and readers over config10's "
                  "catch-up sweep",
        "params": {"log_lengths": list(LOG_LENGTHS),
                   "summary_ops": SUMMARY_OPS, "n_clients": N_CLIENTS,
                   "seed": SEED, "window": WINDOW,
                   "target_len": TARGET_LEN, "append": APPEND,
                   "batch": BATCH, "fold_backend": "kernel",
                   "formats": list(FORMATS), "doc": "doc0"},
        "runs": runs,
    }
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {OUT} in {time.perf_counter() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
