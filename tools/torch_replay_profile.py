#!/usr/bin/env python3
"""Where the port's replay spends device time (one GPU).

    python3 tools/torch_replay_profile.py [--engine overlay|row] [--ops N]
                                          [--docs D [--entries E]]
                                          [--root DIR]

Replays the first N ops (default 1000000, the headline) of the seed-7
lagged 1M-op stream at the bench geometry through
`fluidframework_tpu_torch` under `torch.profiler`:

- ``overlay`` (default): `OverlayDeviceReplica(device="cuda")`, window
  2048 (the ``bench.py`` main path);
- ``row``: `ColumnarReplica(device="cuda")`, capacity 131072, sync
  every 4 chunks (``bench.py`` with ``BENCH_ENGINE=pallas``). The
  replay runs in stages of 100000 ops (rounded up to whole chunks)
  and prints, per stage, the host wall time (profiler on), the
  stage's ops/s and the live rows at its end: the cost curve as the
  document grows. When N is a GOLDEN.json stage, the final digest is
  checked against it.

For the overlay engine it first times, without the profiler, the whole
replay (ops/s) and the host's side of one chunk: the microseconds one
call of kernel A's wrapper and one `fold_device` (the fold kernel's
wrapper, or a parent's torch ops) take on the host's clock (256 and 16
calls on the first chunk, queued without a synchronise: fewer launches
than the device's queue holds), then the same two under the profiler.

``--docs D`` (overlay engine) replays D documents of N ops each at the
bench geometry through `replay_docs` instead (one kernel launch per
chunk for all of them): doc 0 is the headline prefix, the others lagged
streams of `testing/golden.py`'s DOC_SEEDS with the headline's
generator parameters (generated in worker processes), the 32 tiled over
the D documents, as `chip_smoke.py` lays them out. It times the docs replay without the
profiler too, and checks doc 0's digest. With ``--entries E`` the D
documents replay sharded over a mesh of E entries of the card
(`parallel.mesh.sharded_overlay_replay_multi`, each entry on its own
stream, E kernel A launches a chunk), as `chip_smoke.py` phase 30 (b)
runs them.

``--root DIR`` imports the port from the checkout at DIR (a `git
archive` of another commit, say) instead of this one, so that one call
can compare two trees with the same measurement.

Prints the card's name and power limit, host wall time of the replay,
device time per kernel name (summed over the run), the device-busy
share of the replay window (union of all device activity from first to
last device event), the idle share, the overlap (``overlap_ms``: the
sum of every device event's time, copies and torch ops included, less
the union: the device time hidden by concurrency, 0 when no two events
ran at once), and the replay kernels' concurrency
(``replay_kernel_ms``: the summed time of kernel A and the fold
kernel; ``concurrent_kernel_ms``: the part of it that ran while
another of them ran. One entry's kernels share its stream, so with
``--entries`` that is kernel time beside another entry's). Writes the JSON summary as
``torch_replay_profile_<engine>.json`` into the run-output directory
(see ``out_dir``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GOLDEN = 1_000_000
CHUNK = 256
STAGE_OPS = 100_000  # the GOLDEN stage size
# kernel A's and the fold's CUDA kernels (csrc/overlay_chunk.cu,
# csrc/overlay_fold.cu), as the profiler names them
REPLAY_KERNELS = ("overlay_chunk_kernel", "overlay_fold_kernel")


def concurrent_time(spans) -> float:
    """The summed time of `spans` ((start, end) pairs) that ran while
    another of them ran: each interval where k >= 2 are active counts k
    times its length."""
    edges = sorted([(s, 1) for s, _ in spans] + [(e, -1) for _, e in spans])
    active, last, total = 0, 0.0, 0.0
    for t, step in edges:
        if active >= 2:
            total += active * (t - last)
        active += step
        last = t
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("overlay", "row"), default="overlay")
    ap.add_argument("--ops", type=int, default=N_GOLDEN)
    ap.add_argument("--docs", type=int, default=0,
                    help="replay this many documents together (overlay)")
    ap.add_argument("--entries", type=int, default=0,
                    help="with --docs: shard them over this many mesh "
                         "entries of the card")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose fluidframework_tpu_torch is measured")
    args = ap.parse_args()
    if args.docs and args.engine != "overlay":
        ap.error("--docs replays the overlay engine")
    if args.entries and not args.docs:
        ap.error("--entries shards the --docs replay")

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
    from fluidframework_tpu_torch.core.overlay_replay import (
        OverlayDeviceReplica,
    )
    if args.docs:
        from fluidframework_tpu_torch.core.overlay_replay import (
            replay_docs, restore_shard, stack_replicas,
        )
        from fluidframework_tpu_torch.parallel.mesh import (
            make_docs_mesh, sharded_overlay_replay_multi,
        )

        def run_docs(reps):
            if not args.entries:
                return replay_docs(reps)
            step = sharded_overlay_replay_multi(
                make_docs_mesh(args.entries, "cuda"), CHUNK)
            return step(*stack_replicas(reps))
    from fluidframework_tpu_torch.ops.overlay import (
        fold_device, overlay_chunk_kernel,
    )
    from fluidframework_tpu_torch.testing.digest import state_digest
    from fluidframework_tpu_torch.testing.golden import (
        DOC_SEEDS, golden_digest, headline_stream, lagged_stream, load_golden,
        stream_prefix,
    )

    golden = load_golden()
    stream = stream_prefix(headline_stream(golden), args.ops)
    doc_streams = [stream]
    if args.docs:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            n = len(DOC_SEEDS)
            doc_streams += list(pool.map(
                lagged_stream, DOC_SEEDS, [args.ops] * n,
                [golden["params"]] * n))

    def replica(s=stream):
        if args.engine == "row":
            return ColumnarReplica(stream, initial_len=64, chunk_size=CHUNK,
                                   capacity=131072, n_removers=24,
                                   n_prop_keys=8, sync_interval=4,
                                   device="cuda")
        return OverlayDeviceReplica(s, initial_len=64, chunk_size=CHUNK,
                                    window=2048, n_removers=24,
                                    n_prop_keys=8, device="cuda")

    warm = replica()
    warm.replay(limit_chunks=8)  # build + first launches outside the window
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    host = {}

    def docs_replicas():
        reps = [replica(doc_streams[d % len(doc_streams)])
                for d in range(args.docs)]
        for r in reps:
            r.prepare()
        torch.cuda.synchronize()
        return reps

    if args.docs:
        reps = docs_replicas()
        t0 = time.perf_counter()
        run_docs(reps)
        torch.cuda.synchronize()
        host["replay_s"] = time.perf_counter() - t0
        host["replay_ops_per_s"] = args.docs * args.ops / host["replay_s"]
        print(f"docs replay without the profiler: {args.docs} x {args.ops} "
              f"ops in {host['replay_s']:.3f} s = "
              f"{host['replay_ops_per_s']:,.0f} ops/s", flush=True)
        del reps
    elif args.engine == "overlay":
        timed = replica()
        timed.prepare()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.replay()
        torch.cuda.synchronize()
        host["replay_s"] = time.perf_counter() - t0
        host["replay_ops_per_s"] = args.ops / host["replay_s"]
        table, batch = warm.table, warm._dev.slice(0, CHUNK)
        out = overlay_chunk_kernel(table, batch)
        msn = warm._msn_by_chunk[0]

        def per_call_us(fn, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            return dt * 1e6 / n

        for tag in ("", "_profiled"):
            with (torch.profiler.profile(activities=acts) if tag
                  else contextlib.nullcontext()):
                host["wrapper_us" + tag] = per_call_us(
                    lambda: overlay_chunk_kernel(table, batch), 256)
                host["fold_us" + tag] = per_call_us(
                    lambda: fold_device(out, msn), 16)
        print(f"replay without the profiler: {host['replay_s']:.3f} s = "
              f"{host['replay_ops_per_s']:,.0f} ops/s; host us per call: "
              f"wrapper {host['wrapper_us']:.1f} ({host['wrapper_us_profiled']:.1f} "
              f"profiled), fold {host['fold_us']:.1f} "
              f"({host['fold_us_profiled']:.1f} profiled)", flush=True)
    rep = replica()
    if args.engine == "overlay":
        rep.prepare()
    if args.docs:
        reps = docs_replicas()
    torch.cuda.synchronize()
    stages = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if args.docs:
            out = run_docs(reps)
        elif args.engine == "row":
            per = -(-STAGE_OPS // CHUNK)
            while rep.chunks_done < rep.n_chunks:
                ts = time.perf_counter()
                c0 = rep.chunks_done
                rep.replay(limit_chunks=c0 + per)
                torch.cuda.synchronize()
                dt = time.perf_counter() - ts
                ops = min(rep.chunks_done * CHUNK, args.ops) - c0 * CHUNK
                stages.append({
                    "ops_done": min(rep.chunks_done * CHUNK, args.ops),
                    "stage_s": dt, "stage_ops_per_s": ops / dt,
                    "ms_per_chunk": dt * 1e3 / (rep.chunks_done - c0),
                    "rows": int(rep.table.n_rows),
                    "capacity": rep.capacity})
                st = stages[-1]
                print(f"  stage to {st['ops_done']:>8} ops: "
                      f"{dt:8.3f} s, {st['stage_ops_per_s']:10.1f} ops/s, "
                      f"{st['ms_per_chunk']:8.3f} ms/chunk, rows "
                      f"{st['rows']} of {st['capacity']}", flush=True)
        else:
            rep.replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.docs:
        rep = restore_shard(reps[0], *out[:4], 0)
    rep.check_errors()

    by_name = defaultdict(lambda: [0.0, 0])
    spans, kspans = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
        if any(k in e.name for k in REPLAY_KERNELS):
            kspans.append((e.time_range.start, e.time_range.end))
    gpu = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    summary = {"gpu": gpu, "nvidia_smi": smi, "engine": args.engine,
               "root": os.path.abspath(args.root), "ops": args.ops,
               "docs": args.docs, "entries": args.entries,
               "distinct": len(doc_streams),
               "chunks": rep.n_chunks, "wall_s": wall, "stages": stages,
               **host}
    if not spans:
        print("torch.profiler recorded no device time on this machine")
        summary["device_events"] = 0
    else:
        spans.sort()
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - spans[0][0]
        total = sum(e - s for s, e in spans)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        summary.update({
            "device_window_ms": window / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_sum_ms": total / 1e3,
            "overlap_ms": (total - busy) / 1e3,
            "replay_kernel_ms": sum(e - s for s, e in kspans) / 1e3,
            "concurrent_kernel_ms": concurrent_time(kspans) / 1e3,
            "idle_share": 1 - busy / window,
            "kernels": [{"name": n[:120], "total_ms": t / 1e3, "count": c}
                        for n, (t, c) in top[:15]],
        })
        docs = f" x {args.docs} documents" if args.docs else ""
        docs += f" on {args.entries} mesh entries" if args.entries else ""
        print(f"{gpu}: {args.engine} engine, {args.ops} ops{docs}, "
              f"{rep.n_chunks} chunks, replay wall {wall:.3f}s (profiled)")
        print(f"device window {window / 1e3:.1f} ms, busy {busy / 1e3:.1f} "
              f"ms, idle share {1 - busy / window:.4f}; device events summed "
              f"{total / 1e3:.1f} ms, overlap (hidden by concurrency) "
              f"{(total - busy) / 1e3:.1f} ms; kernel A and the fold "
              f"{summary['replay_kernel_ms']:.1f} ms, of which "
              f"{summary['concurrent_kernel_ms']:.1f} ms ran beside another "
              f"of them")
        for n, (t, c) in top[:15]:
            print(f"  {t / 1e3:10.2f} ms  {c:7d}x  {n[:100]}")
    want = golden_digest(golden, args.ops)
    if want is not None:
        digest = state_digest(rep.annotated_spans())
        summary["digest_matches_golden"] = digest == want
        print(f"digest {digest}: "
              f"{'matches' if digest == want else 'DIFFERS FROM'} GOLDEN.json "
              f"at {args.ops} ops")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tag = "" if args.root == ROOT else "_" + os.path.basename(
        os.path.abspath(args.root))
    tag += f"_docs{args.docs}" if args.docs else ""
    tag += f"_entries{args.entries}" if args.entries else ""
    path = os.path.join(out_dir,
                        f"torch_replay_profile_{args.engine}{tag}.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0 if summary.get("digest_matches_golden", True) else 1


if __name__ == "__main__":
    sys.exit(main())
