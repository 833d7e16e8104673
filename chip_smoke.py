#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--ops N]

Drives the port's replay paths on the card, through
``fluidframework_tpu_torch`` only -- it imports nothing of JAX or of
``fluidframework_tpu``: the overlay merge-tree replay that ``bench.py``
measures on the JAX package, the row-model replay (``ColumnarReplica``,
``bench.py`` with ``BENCH_ENGINE=pallas``), the summary service's fold,
the message-driven overlay replica, the deli sequencer (BASELINE
config 5), SharedTree's batched rebase (BASELINE config 4), the
row-model scan under `KernelReplica` and the summary fold's ``kernel``
backend, the row model's zamboni, the row model's scan engine
(``bench.py`` with ``BENCH_ENGINE=scan``), the deli's supervised
role over columnar and JSON file topics (BASELINE config 5), the
summary service's supervised role with its catch-up read (config10,
and config15's documents through the role), the multi-device layer
on mesh entries of the card (the dry run, many documents sharded over
entries, the deli's sharded pool), and the summary role's folds on a
device plane of the card.
Phases, in order; any failure exits non-zero:

1. the device, and the card's name and power limit from nvidia-smi;
2. builds the seven CUDA kernels (nvcc, sm_90a) and the native stream
   engine (g++) from the checkout's sources, in parallel, and generates
   the headline stream in a worker process beside them (set-up);
3. holds the overlay chunk kernel against its plain PyTorch version on
   the card at the bench geometry (window 2048, 24 remover slots, 8 prop
   keys, chunks of 256 ops): the first 16 chunks of the seed-7 lagged
   stream, a chunk that overflows the window (ERR_CAPACITY) and a chunk
   with positions past the document (ERR_BAD_POS), and the edge chunks
   of `testing/overlay_edges.py` (split inserts at row 0 and at the
   window's top, long and overflowing gap loops, diverging split
   halves, a full remover row, more than a window of rows created and
   dropped); the comparison is exact (int32, tolerance 0) on n_rows,
   error and rows [:n_rows]; then times the kernel and the plain version
   on the checked chunks;
3 (b). the fold kernel (`csrc/overlay_fold.cu`) against its plain
   versions `fold_device_ref` and `fold_append_ref` on the same CUDA
   inputs, exactly (int32, tolerance 0) on every output (the whole
   table, the whole record block, n_rec; the append form's whole log,
   counts and cursor): after each of phase 3's checked chunks, on the
   edge tables of `testing/fold_edges.py` (the tile-boundary cases
   among them) at the bench geometry and at the summary fold's
   (cursors that fit, clamp and pass the capacity), and on D = 132
   stacks at both, at the cluster size the wrapper picks (and on phase
   3's tables tiled to D = 4, 8 and 32), then at each cluster size 1,
   2, 4 and 8 forced; then the append form's time per launch by CUDA
   events behind a spin (D = 1, 8 and 132) beside its bytes bound and
   the time of an empty launch of the same grid and clusters, and the
   plain version's by CUDA events back to back;
4. the main path: `OverlayDeviceReplica(device="cuda")` replays the
   seed-7 lagged stream (1024 clients, collab window 1024, initial
   length 64; the first 500k of its 1M ops by default, cut to keep the
   whole smoke inside its time limit since phase 29; `--ops 1000000`
   replays it whole) with the kernel launch counts reset just before;
   kernel A's and the fold kernel's launches must each equal the chunk
   count (two launches a chunk), and the final
   state's digest must equal GOLDEN.json (the full digest at 1M ops,
   else the native stage digest of that prefix length);
5. holds the row-model chunk kernel against `apply_chunk_ref` on the
   card at the bench geometry (capacity 131072, 24 remover slots, 8
   prop keys, chunks of 256 ops), exactly (tolerance 0) on n_rows,
   error and rows [:n_rows]: the first 16 chunks of the same stream
   with a compaction every 4 chunks as the replica runs it (each one
   the compaction kernel, `compact_gather_text`'s one launch of
   `csrc/zamboni.cu`, held against its plain version
   `compact_gather_text_ref` on the card, exactly: the whole table,
   n_rows, error and the whole new arena), a
   full-table chunk (ERR_CAPACITY, the insert at the document's end
   included), a chunk with positions past the document (ERR_BAD_POS),
   and the block-edge chunks of `testing/block_edges.py` for the
   kernel's grid (G blocks of R rows from `kernel_geometry`: splits at
   rows R-1 and R, landings at row R and at row n = 2R, a shift from row
   2R, removed rows across an edge, an insert at row 0, tables of C-1
   and C rows);
6. the row-model path: `ColumnarReplica(device="cuda")` at the same
   geometry (sync every 4 chunks) replays the first ROW_OPS ops (or
   --ops, if fewer) with the kernel launch count reset just before; it
   runs as ``replay(limit_chunks=k)`` then ``replay()``, where k is the
   last multiple of 4 chunks at least 4 chunks before the end: the
   stop falls where the replay compacts anyway, so the timed run keeps
   the schedule of one uninterrupted replay (plus one scalar read when
   it resumes), and the table the first call leaves is kept. The
   launches must equal the chunk count, the compaction kernel's
   launches the compactions times one, and the digest must equal
   GOLDEN.json's stage digest at that depth;
7. the chunks from k to the end of that replay, on the kept table
   (tens of thousands of rows), kernel against plain version again,
   exactly; both are timed there. Then the replay's compaction after
   chunk k + 4: the compaction kernel against its plain version again,
   exactly, and both timed (the kernel behind a spin, and both by CUDA
   events around back-to-back calls) beside the kernel's bound and the
   earlier three-launch design's time.

8. (in the background, from here on) lagged streams of 100k ops for
   many documents: the DOC_SEEDS of `testing/golden.py` with the
   headline's generator parameters, in worker processes;
9. kernel A's two layouts (the launcher picks the shared one when the
   hot columns and the chunk's ops fit a block's shared memory, else
   the global one) against the plain version, exactly, on the first
   stream chunks (prop slots widened to PK) and the edge chunks at each
   of LAYOUT_SHAPES, in the launcher's layout and, where the launcher
   takes it, the other one; on the 16 bench chunks again at window
   8192 (global layout); each layout's ms per chunk by CUDA events;
   then both layouts on the same chunks (stream chunks with few live
   rows, and a crowded window) at every R = W / 1024 the shared layout
   takes, exactly and timed;
10. `OverlayDeviceReplica` at its defaults (window 8192, chunk 2048: the
   global layout) with the bench's 24 remover slots and 8 prop keys on
   the 100k headline prefix, gated on GOLDEN.json's stage digest;
11. many documents (`replay_docs`: one kernel launch per chunk for all
   of them) at the bench geometry, 100k ops each: doc 0 is the headline
   prefix, the others the 31 streams of phase 8, tiled (32 distinct
   streams); each distinct stream first replays alone; at D = 132 the
   docs path's stacked launches are held against the plain version per
   document, exactly (all 132 on the first chunk, 8 on the last, and
   each document on the chunk where its error word first turns
   non-zero, with the seed named); then D = 1, 8, 32 and 132 documents
   replay together, with the launches equal to the chunk count, the
   error bits equal to the OR of the single replays', and at D = 132
   every document's final table, log, counts and cursor equal to its
   single replay's, exactly (so its digest and error word; doc 0's
   digest read out at every D); aggregate ops/s and ms per chunk at
   each D;
12. `replay_streaming` in 8 host segments on the 100k prefix, gated on
   GOLDEN.json;
13. the summary service's fold (`server/summary_fold.SummaryFolder`,
   summaries every 375 records, the emission loop of config15's fold:
   streams of 3000 ops from 4 clients, seeds 40 + i) over config15's 4
   documents, fed in slices of 375 records: every manifest's seq,
   count and handle must equal the JAX summarizer role's in
   `fluidframework_tpu_torch/testing/fold_golden.json`, and the launches
   the chunk count (after one untimed warm-up of the fold loop);
14. the fold's own stacked launches held against the plain version per
   document, exactly: all 132 documents on the first chunk of round 0,
   and 8 documents on every chunk of the last 2 rounds; kernel A's ms
   per launch at the fold's shape, 132 documents and one;
15. the fold bench's emission loop (`testing/fold_streams.run_fold_sweep`:
   boot, encode, one stacked `fold_jobs_overlay` per round, canonical
   rows, reboot) at D = 4 and 132 documents, every emission's digest
   gated on fold_golden.json, the launches equal to the chunks summed
   over rounds and window groups; emissions/s, fold ops/s and seconds
   per round split into encode, fold (with its device time by CUDA
   events) and serialization + reboot;
16. `OverlayKernelMessageReplica` on 4 documents' records as messages
   (chunks of 64, window 1024), launches equal to the chunks, text,
   spans and error word equal to the same replica on the CPU;
17. the sequencer kernel (`csrc/sequencer_step.cu`) against its plain
   version `sequence_batch_ref`, run on CPU copies of the same inputs,
   exactly (int32/bool, tolerance 0) on the new state, the abort tracker
   and the four verdict planes: the chunks of config 5's first 4 and
   last 2 pumps (timed there: the kernel by CUDA events behind a spin,
   the plain version by host clock), grouped edge traffic (boxcars
   across chunk edges, dedup on and off, system stamps, out-of-range
   client slots, every nack code) at D 13 in both layouts, random
   in-proc traffic through `KernelDeliLambda` in pumps of 37 and chunks
   of 8 under a resident budget (eviction), and churn that grows the
   client columns to 1024 and 2048 at D 5, each chunk in both layouts;
18. the deli's main path: BASELINE config 5 at the reference's bench
   defaults (`build_pipeline_workload(10_000, 64, 1)`: 1,280,000 raw
   records) through `KernelDeliLambda(device="cuda", max_pump=16384)`
   until it drains (79 pumps), after a warm-up over the first 4 pumps in
   a separate log; launches equal to the chunks, the normalized deltas
   digest, stamp and nack counts and the final checkpoint's digest equal
   to `fluidframework_tpu_torch/testing/deli_golden.json` (the JAX
   scalar deli's, `tools/deli_golden.py`); records/s by the host clock,
   ms per pump split into plan, prepare, pack, upload, launch, read,
   emit and the kernel (CUDA events), and the pool's D, C and B;
19. restore: a fresh lambda checkpoints at the stream's midpoint, a new
   one restores from it and drains the rest (under `torch.profiler`:
   the kernel's device time in the path and the device's busy share);
   the concatenated deltas and the final checkpoint equal the golden;
20. the rebase kernel (`csrc/rebase_batch.cu`) against its plain version
   `rebase_batch_ref`, run on CPU copies of the same inputs, exactly
   (int32/bool, tolerance 0) on all eight outputs: the 20 differential
   streams and the edge set of `testing/tree_streams.py` (empty window
   and branch, a ragged branch, a window of ~5 shared-memory tiles,
   only moves with identity moves on both sides, double splits, kinds
   outside 0..2, and the cases of the kernel's grouping by kind: one
   kind only, runs of kinds across warp and block edges, branches of 1,
   31, 33 and a block and one, kinds outside 0..2 within a warp) and
   config 4 whole; the inputs are checked unchanged and the launches
   equal the calls;
21. the rebase's main path: BASELINE config 4 (100,000 pending ops over
   a 64-op trunk window, `tools/bench_configs.py:187-233`) through
   `rebase_ops_columnar(device="cuda")` after a warm-up call: one
   launch, the three output digests and the flagged / split / muted
   counts equal to `fluidframework_tpu_torch/testing/tree_golden.json`
   (the JAX package's, `tools/tree_golden.py`); the call's host-clock
   time split into upload, launch, read and sequentialize,
   op_rebases_per_sec (and REBASE_REPEATS more calls), the kernel's
   time per launch by CUDA events behind a spin and under the profiler
   in the path, and both bounds (bytes; operations, the larger of the
   ALU's and the issue's) with the share reached; the kernel's time
   over no base op and with every pending op of one kind; and, computed
   rather than read from the card (a log line, not in the kernels
   line), the kernel's grouping: ops a block, the warps by the step
   they run (one kind's, or generic in a warp of mixed kinds) and the
   mixed-warp share by `warp_steps`, and the instructions a step by
   REBASE_OPS of a warp of one kind against a mixed one;
22. the row-model scan kernel (`csrc/mergetree_scan.cu`, one block per
   document, one pass an op) against its plain version
   `apply_op_batch_ref`, run on CPU copies of the same inputs in worker
   processes, exactly (int32, tolerance 0) on n_rows, error and rows
   [:min(n_rows, C)]: the edge chunks of `testing/scan_edges.py` at C
   512, 1024, 2048 and 16384 (the global layout), each alone and all
   stacked in one launch; then the launches of an untimed kernel-backend
   fold sweep at D = 132 (config15's fold, as in phase 15): 8 documents
   on every launch of rounds 0 (C 1024), 4 (C 2048) and the last (C
   512), and all 132 on round 4's first launch; then the kernel's time
   per launch by CUDA events behind a spin at C 512 (round 0's first
   launch), 1024 and 2048 (round 4's first launch), D = 132 and one
   document, each beside its bound (the live rows in and out), with the
   active warps and rows a thread that the blocks report from the card
   (the kernels line) and the launcher's layout, computed (the log line
   only); then its parts on round 4's first launch: all NOOP (the live
   rows' copies alone), each op kind alone (the others made NOOP, 2
   documents of each held), us an op by kind, and KernelReplica's
   launches of doc 0 at C 4096 and 8192 (B 512, held whole), each with
   its op loop as the card reports it;
23. `SummaryFolder(fold_backend="kernel")` over config15's 4 documents:
   every manifest's seq, count and handle equal the JAX role's in
   fold_golden.json, and its scan launches equal those of phase 24's
   D = 4 sweep over the whole rounds;
24. `run_fold_sweep(backend="kernel")` at D = 4 and 132: every
   emission's digest equal to fold_golden.json, the launches equal to
   the fold's chunks summed over rounds and capacity groups; emissions/s,
   fold ops/s, the per-round split (encode, fold with its device time,
   serialization + reboot) and the kernel-over-overlay time against
   phase 15's overlay sweep;
25. `KernelReplica(device="cuda")` (chunks of 512, capacity 4096) on 4
   documents' records as messages: launches equal to the chunks, text,
   spans and error word equal to the same replica on the CPU (worker
   processes), and text and spans (equal-prop runs) to the overlay
   message replica's;
26. the zamboni kernel (`csrc/zamboni.cu`, two launches of one block a
   tile of 512 rows) against its plain version `zamboni_device_ref`,
   run on CPU copies of the same inputs in worker processes, exactly
   (int32, tolerance 0) on every field of the whole output table,
   n_rows and error: the table that a scan-engine replay of the first
   ZAMBONI_OPS headline ops leaves at bench.py's scan geometry with no
   host compaction (watermark 1.1), at that replay's last MSN and at
   MSN 0, and the edge tables of `testing/zamboni_edges.py` at C 1024,
   16384 and 131072 (kept / dropped rows and run starts at rows T - 1,
   T and T + 1 of the kernel's tile T, one run across several tiles, a
   tile with every row dropped, n_rows above C, random tables); then its
   time per call on the replica's table by CUDA events behind a spin,
   beside its bound (bytes: rem_seq of the live rows, the merge test's
   columns of the kept rows, the wide columns of the run firsts alone,
   every row out) and the plain version's CPU time; and on the replica, the text unchanged and
   n_rows not larger after it;
27. the row model's scan engine: `ColumnarReplica(engine="scan",
   device="cuda")` at bench.py's scan geometry (`BENCH_ENGINE=scan`:
   capacity 131072, chunks of 256, 24 remover slots, 8 prop keys,
   compaction watermark 0.7) replays the SCAN_ENGINE_OPS headline
   prefix with the scan and zamboni launch counts set to 0 just before:
   the scan launches must equal the chunk count, the zamboni's are
   read (0: the reference's scan path never calls it), and the digest
   must equal GOLDEN.json's stage digest; ops/s by the host clock, the
   host compactions and the final capacity; the scan kernel against
   `apply_op_batch_ref` on CPU copies, exactly, on the replay's first
   chunk and on its last chunk with the table it was applied to; and a
   second run, its stages wrapped from outside the replica with the
   device synchronised around each, split into uploads, the scan
   launches (CUDA events) and compact()'s pull, numpy work and push;
28. the deli's supervised role: BASELINE config 5's 1,280,000 raw
   records written as a columnar raw topic in frames of 16384 (set-up)
   in a temporary directory, then `KernelDeliRole(device="cuda",
   log_format="columnar", batch=16384)` stepped until the topic is
   drained, with the sequencer's launch count set to 0 just before: the
   launches must equal the chunks (one a step), and the deltas digest
   and counts and the final checkpoint's digest must equal
   `fluidframework_tpu_torch/testing/deli_role_golden.json` (the JAX
   scalar role's, `tools/deli_role_golden.py`); records/s by the host
   clock, the split per step (polls and parse, `flush_batch` with
   `SeqPool.times`' stages, the append, the checkpoint, the rest) and
   how many records each plan took; then a crash run on a fresh topic
   (the first owner stops after ROLE_CRASH_STEPS steps and releases the
   lease, a second owner recovers and finishes; its first
   ROLE_HELD_CHUNKS chunks held against the plain sequencer on CPU
   copies, exactly) against the same digests, and the JSON-topic form
   on the first 4 pumps' records against the prefix digest;
29. the summary service's role (`server/summarizer.SummarizerRole`),
   with the scan and kernel A's launch counts set to 0 just before each
   role run: (a) config10's catch-up (`testing/catchup_streams.
   run_catchup`: prefixes of 10k, 30k and 100k ops of
   `build_mergetree_stream(100000, n_clients=4)`, a summary every 2000
   records, reads of 4096) on JSON and columnar topics with the kernel
   backend, every manifest field, the summary join's tail and the cold
   replay's digest equal to `fluidframework_tpu_torch/testing/
   summary_role_golden.json` (the JAX role's and readers',
   `tools/summary_role_golden.py`); per L and format the full replay's
   and the summary join's ms, the speedup, the join's flatness, the
   role's records/s and its ms per round split into process, encode,
   fold (with its device time by CUDA events), canonical rows, reboot,
   put, append and checkpoint; (b) the 100k columnar run on the overlay
   backend, every manifest equal to the same golden; (c) config15's 132
   documents (3000 ops from 4 clients, `fold_golden.json`'s seeds)
   interleaved record by record into one columnar deltas topic, through
   the role on both backends with a summary every 375 records: every
   blob's rows equal to `fold_golden.json`, 8 rounds of 132 stacked
   documents, emissions/s and the split; (d) a crash: a first owner
   checkpoints at a quarter of (a)'s 100k columnar topic and is
   abandoned near half, a second recovers after the lease's TTL and
   finishes: (a)'s manifests but their byteOff, no (doc, seq) twice,
   and every summary plus a tail of SUMMARY_TAIL ops (the last one's
   to the log's end) equal to the cold replay there; the full replay
   of (a) runs on the JSON sweep and stands for both formats (it reads
   no topic); (e) the first stacked round of (c) on each
   backend held against the plain versions on the CPU (worker
   processes), exactly: the tables, fold records and error words;
30. the multi-device layer (`fluidframework_tpu_torch/parallel/`) on
   mesh entries of the card, each entry on a CUDA stream of its own:
   (a) `parallel.dryrun.dryrun_multichip(8)` at scale 1.0, the sections
   of the reference's `__graft_entry__._dryrun_impl` (one document an
   entry, 32 documents chained behind the sequencer, one document
   sequence-sharded over all 8, the row model's pipeline step), every
   digest equal to its single-entry run's, the error words 0, kernel A
   launched entries x chunks in each replay section, the sequencer
   once, the scan once an entry; (b) phase 11's first 32 documents
   (100k ops each, the bench geometry) through
   `sharded_overlay_replay_multi` on 4 entries (8 documents an entry):
   entry 0's first chunk held against the plain version per document,
   exactly, then the replay with kernel A's count set to 0 just before
   (4 launches a chunk), every document's final table, log, counts
   and cursor equal to its phase-11 single replay's exactly (so its
   digest and error word; doc 0's digest read out against GOLDEN.json),
   gmsn the min of the final MSNs and gerr the OR of the error words; aggregate ops/s and ms/chunk beside
   phase 11's D = 32 (one launch a chunk), with `parity_skip_reason`'s
   text (one card: not a scaling figure); (c) config 5 through
   `KernelDeliLambda(deli_devices=4)` with the sequencer's count set to
   0 just before: deltas and checkpoint digests equal to
   deli_golden.json, launches 4 times phase 18's, records/s;
31. the summary service's folds on a device plane: config15's 4
   documents (fold_golden.json's seeds, a summary every 375 records)
   interleaved into one columnar deltas topic, through
   `SummarizerRole(device_plane="4x2")` on PLANE_SPEC entries of the card
   and without a plane, on both backends: every blob's rows and every
   manifest equal fold_golden.json, the plane's blobs and manifests those
   of the plane-less run byte for byte, ``summary_plane_folds_total``
   nonzero with the plane and 0 without, each run's launches read.
   Phases 11 and 30 (b) hold every document's outputs to its single
   replay's exactly instead of reading each one out: the readout of 132
   documents took 20-38 s, and equal outputs give equal digests.

Phases 28, 30 (c) and 29 (c, e) run in a worker process that starts
after phase 12: phases 28 and 30 (c) (host-bound, launching only the
sequencer's 20 µs kernel) beside phases 13-27, and phase 29 (c, e),
whose rounds make many small copies, only once the main process's
timed phases are done, beside phase 29 (a, b, d) and 30 (a); their log
lines follow phase 30 (a)'s, and phase 30 (b) runs after them.

ROW_OPS is the largest 100k multiple of ops (up to 1M) that the card
replays in at most 300 s; it is 1M (see the constant), and phase 6
replays min(ROW_OPS, --ops). Every path
(phases 4, 6, 10, 11, 12, 13, 15, 16, 18, 19, 21, 23, 24, 25, 27, 28,
29's role runs, 30 and 31) is driven with kernel launch counts set to 0
just before it (or read just before it) and read just after (phase 30
(a) also counts each section's sharded call on its own). On every
overlay path the fold kernel launches with kernel A: once a chunk (an
entry a chunk on the mesh), and on the summary fold once more per
emission (`canonical_rows`' fold), on the message replica once more per
fold-only epoch.

Prints the kernel A geometry line (layout, threads, rows per thread,
shared bytes, heap rows), the kernel B grid line (G, R, shared bytes per
block, grid barriers per op), the kernels line (JSON; kernel A's entry
also lists every layout it checked, the two layouts' times on the same
chunks, the launches of each path, and the fold's window groups with
their layout; the sequencer's lists its checked chunks, the deli's
per-pump split and records/s, and the role's records/s, split and
launches; the rebase's, both bounds, the call's split and
op_rebases_per_sec; the scan's, its times at each capacity and D, the
launches of each path, the kernel fold's runs, the scan engine's run
and split, and the summary role's runs (phase 29; kernel A's entry has
their overlay launches); the zamboni's, its launches on the scan
engine's path and in the smoke; the compaction's, its launches on the
row replay, one a compaction; phase 30's sharded paths in the
path_launches of kernel A, the sequencer and the scan, with kernel A's
entry holding the dry run's report and the sharded docs replay's
timing, the sequencer's the sharded deli's; the fold kernel's, its
shape, the tables it was held on, its time at D = 132 and the launches
of every overlay path, with the plane's runs), the nvidia-smi line, and
last the
``{"ok": true, "device": ...}`` line. Exits 2 without a CUDA device or
outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import dataclasses
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Bench geometry (bench.py: BENCH_WINDOW, BENCH_REMOVERS, BENCH_CHUNK).
WINDOW, N_REMOVERS, N_PROP_KEYS, CHUNK = 2048, 24, 8, 256
SEED = 7  # of the crafted chunks
CHECK_CHUNKS = 16  # stream chunks held against the plain version
# Row-model geometry (bench.py with BENCH_ENGINE=pallas).
ROW_CAPACITY, ROW_SYNC = 131072, 4
# Row-model replay depth: all 1M ops, since an H100 (700 W) replays
# them in 19.7 s, well under the 300 s this phase may take (PERF.md
# section 5).
ROW_OPS = 1_000_000
DEEP_CHUNKS = 4  # at least this many last chunks of the row replay are
# held against the plain version
# Kernel A's layouts: (W, B, KR, KK, PK) of the overlay fold's grown
# window (3072, chunks of 128 x 4 prop slots), the widest shared layout
# (6144, R 6), the global layout at 6144 (its ops overflow the shared
# bytes) and at the replica's default 8192 / 2048, and a heap row wider
# than 64 ints (KR + KK = 72).
LAYOUT_SHAPES = ((3072, 128, 4, 8, 4), (6144, 128, 24, 8, 4),
                 (6144, 256, 24, 8, 1), (8192, 2048, 24, 8, 1),
                 (2048, 256, 64, 8, 1))
GLOBAL_W = 8192  # the bench chunks again in the global layout (W 8192)
# Both layouts on the same chunks at each R = W / 1024 of LAYOUT_SWEEP_R
# that the shared layout takes: SWEEP_CHUNKS stream chunks and one
# crowded window, chunks of SWEEP_B ops.
LAYOUT_SWEEP_R = range(1, 7)
SWEEP_B, SWEEP_CHUNKS = 128, 4
# The replica's defaults (core/overlay_replay.py, as in the reference).
DEFAULT_WINDOW, DEFAULT_CHUNK = 8192, 2048
# Many documents: each replays DOC_OPS ops at the bench geometry; doc 0
# is the headline prefix, the others lagged streams of the DOC_SEEDS of
# testing/golden.py (the headline's generator parameters), tiled to the
# largest count.
DOC_OPS = 100_000
DOC_COUNTS = (1, 8, 32, 132)
LATE_DOCS = 8  # documents (distinct streams) held to plain on the last chunk
STREAM_STEPS = 8  # segments of the streaming replay
# The summary service's fold at the reference's accelerator shape:
# config15's fold (tools/bench_configs.py:1070) through the emission
# loop of `run_fold_backend_bench` (testing/deli_bench.py:603-640):
# 3000 ops a document from 4 clients, a summary every max(64, 3000 // 8)
# = 375 records, seeds 40 + i; fold_golden.json pins every emission.
# D = 4 is config15's fold_docs, 132 one document per SM.
FOLD_DOCS = (4, 132)
FOLD_LATE_DOCS = 8  # documents whose last FOLD_LATE_ROUNDS rounds are held
FOLD_LATE_ROUNDS = 2
# The message-driven replica: 4 documents' records, chunks of 64 ops in
# a window of 1024 (the reference's defaults).
MSG_DOCS, MSG_CHUNK, MSG_WINDOW = 4, 64, 1024

# H100 SXM peaks: the HBM3 rate from NVIDIA's data sheet, and the int32
# ALU's rate (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost clock),
# half the data sheet's non-FMA fp32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 64 * 132 * 1.98e9
# Instruction issue: one warp instruction per clock in each of an SM's
# four schedulers, 128 lanes an SM, whatever the pipe.
PEAK_ISSUE_S = 128 * 132 * 1.98e9
INT_OPS_PER_ROW = 16  # visibility, prefix sum and landing tests per row per op
# Row model: int32 work per live row of one pass of an op over the
# table (mergetree_pallas.py:160-185, `vis_tile` in
# csrc/mergetree_chunk.cu): the visibility of the row -- removed,
# rem_seq <= ref, tomb, ins_client == client, ins_seq <= ref, their or,
# removed and not visible-insert, skip, visible, the length select
# (10) --, the prefix add (1), and the row's test against the position
# -- its end prefix, two compares, the and (4). The remover-slot reads
# of removed rows are left out.
INT_OPS_PER_PASS_B = 15
# Passes per op: an insert splits at pos1 and lands; a remove or an
# annotate splits at pos1 and at pos2 and walks the covered range.
PASSES_INSERT_B, PASSES_RANGE_B = 2, 3
# The sequencer step's int32 work (csrc/sequencer_step.cu): per
# submission, the slot clip, the dedup and boxcar tests, the four-rung
# nack ladder, the stamp decision, the slot's update and the tracker
# (about 32); per stamp, the MSN's masked min over the client columns
# (a connected test and a min per column).
SEQ_OPS_PER_SUB, SEQ_OPS_PER_COL = 32, 2
# The rebase step's int32 work (csrc/rebase_batch.cu) per pending op
# per base op, by the staged code of the base op and the pending op's
# kind (0 insert, 1 remove, 2 move, -1 any other value): the integer
# instructions that kind's own branch needs, as nvcc can fuse them. One
# each for a comparison (with one && or || of another predicate folded
# in), an add or subtract (a three-term sum is one), a min or max, and a
# select. Not counted: the base op's own terms (its end, attach gap and
# code, the same for every pending op: the kernel makes them once per
# tile entry), shared-memory loads, the loop and branches, and the other
# kinds' branches, which a warp of mixed kinds runs but an op does not
# need. Per piece: a shift at a gap (compare, add, select) 3; a gap
# over a remove 4; a gap over a move (`gap_move`: inside 2, travel 1,
# the remove slide 4, the tie 3, the attach add and two selects 3) 13;
# a range's clip (end, min, max, difference, clamp, subtract) 6; the
# spare's detach slide and attach shift under a move 6; a pending
# move's mute (its two tests and the select) 3; a remove's split take
# (four selects, the take and `sact`) 6 and the flag's or 1.
# Insert code: insert / other 6 (index and spare shifts); move 17
# (+ end, inside 2, absorb 2, dst shift 3, mute 3); remove 23 (+ end,
# split test 3, head and tail 2, the spare's second-split test 4, flag
# 1, take 6). Remove code: insert 8 (index and spare slides); other 14
# (+ clip); remove 20 (+ clip, spare clip); move 21 (+ clip, dst slide,
# mute). Move code: insert 19 (`gap_move` and spare); other 14 (detach
# slide 3, end and full 3, travel select 2, spare 6); move 44 (detach
# slide and end 4, index shift 3, absorb 4, `gap_move` of dst 13, the
# claim flags 10, flag 1, mute 3, spare 6); remove 44 (detach slide,
# end, full and travel 8, live 1, overlap 4, partial flag 1, attach
# shift 3, split test 3, head and tail 2, the spare's flags 9, flag 1,
# take 6, spare 6). Kinds outside 0..2 in the base: as a move's
# positions with none of its flags (move 34 with no claim flags; others
# as a non-flagging remove, 14; insert 19). An identity base move skips
# the step: 0. Then each entry is lowered to the SASS instructions of the
# kernel's step specialised to that base code and pending kind, where
# that needs fewer (tools/rebase_sass.py compiles one probe kernel for
# each pair and counts; nvcc fuses an add with a min or max, and folds
# more predicates into a comparison): insert code, move 17 -> 16; remove
# code, remove 20 -> 14; move code, insert 19 -> 17, move 44 -> 40, other
# 14 -> 13; other code, insert 19 -> 17, remove 14 -> 13, move 34 -> 31,
# other 14 -> 13. Where the SASS needs more (remove code, insert 10; move
# code, remove 46) the count stays: the table counts the function's work,
# not the kernel's.
REBASE_OPS = {
    "insert": {0: 6, 1: 23, 2: 16, -1: 6},
    "remove": {0: 8, 1: 14, 2: 21, -1: 14},
    "move": {0: 17, 1: 44, 2: 40, -1: 13},
    "other": {0: 17, 1: 13, 2: 31, -1: 13},
    "noop": {0: 0, 1: 0, 2: 0, -1: 0},
}
# Of each entry, the instructions that only the integer ALU can issue:
# comparisons, selects, min / max (fused with an add or not), logic. The
# rest of an entry is adds, subtracts and moves, which nvcc issues as
# IMAD on the FMA pipe or as IADD3 on the ALU, as it balances the two.
# Each entry is the specialised step's ALU-only SASS instructions
# (tools/rebase_sass.py, "by pipe"), capped at the REBASE_OPS entry
# (remove code, pending insert: 9 in the SASS, 8). Over config 4's base
# mix they are 0.78 of REBASE_OPS (7.50 / 19.69 / 18.19 a step against
# 9.38 / 25.44 / 23.56 for an insert / remove / move), so the ALU bounds
# the step and the issue rate (PEAK_ISSUE_S) does not: a pending op's
# step needs at least its ALU-only work over the ALU's 64 lanes and all
# its work over the 128 issue slots.
REBASE_ALU_OPS = {
    "insert": {0: 4, 1: 17, 2: 11, -1: 4},
    "remove": {0: 8, 1: 12, 2: 18, -1: 12},
    "move": {0: 13, 1: 34, 2: 31, -1: 8},
    "other": {0: 13, 1: 8, 2: 22, -1: 8},
    "noop": {0: 0, 1: 0, 2: 0, -1: 0},
}
# Host-clock repeats of config 4's call after the main path's one, for
# the spread of op_rebases_per_sec; as many again run under the profiler.
REBASE_REPEATS = 5
# Draws the dst of config 4's pending ops when phase 21 times them all as
# moves.
CONFIG4_ONE_KIND_SEED = 5
# The row-model scan (csrc/mergetree_scan.cu) at the kernel fold's shape
# (summary_fold: chunks of 128, KR 4, KK 8, PK 4): edge chunks at each
# capacity the fold reaches and at 16384 (the kernel's global layout,
# above the first design's ceiling); the fold's launches of round 0, round
# SCAN_TIMED_ROUND (timed, all its documents held) and the last round
# held; SCAN_TIME_REPS launches a timing.
FOLD_CHUNK = 128
SCAN_EDGE_CAPACITIES = (512, 1024, 2048, 16384)
SCAN_TIMED_ROUND = 4
SCAN_TIME_REPS = 20
SCAN_COLS = ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
             "rem_clients", "props")
# The scan's int32 work per live row of one pass (`Doc::pass` and the
# tests after it in csrc/mergetree_scan.cu): the visibility -- the live
# test, removed, rem_seq <= ref, tomb, ins_client == client, ins_seq <=
# ref, their or, skip, visible, the length select (10) --, the thread
# sum's and the prefix's adds (2), and the row's test against the
# position -- its end prefix, two compares, the and (4). The remover
# reads of removed rows are left out. One pass an op of any kind but
# NOOP: the kernel decides an op's splits, landing and covered rows
# from one pass (an earlier design's 2 passes an insert and 3 a range
# op were its own, not the function's least work).
SCAN_OPS_PER_PASS = 16
# KernelReplica on the card (phase 25): the reference's defaults.
REPLICA_CHUNK, REPLICA_CAPACITY = 512, 4096
# The scan's parts (phase 22, `scan_part_times`): each op kind alone
# (op codes of ops/mergetree_kernel.py), and KernelReplica's launches
# of doc 0 at its two capacities: launch 1 at C 4096 (521 live rows)
# and launch 3 at C 8192 (1633; the replica grows its table after its
# second chunk), chunks of 512.
SCAN_KINDS = (("insert", 0), ("remove", 1), ("annotate", 2))
OP_NOOP_CODE = 3
SCAN_REPLICA_LAUNCHES = {"replica_c4096": (1, 4096),
                         "replica_c8192": (3, 8192)}
FOLD_PARTS_DOCS = 2  # documents of each timed variant held to plain
# The row model's scan engine (bench.py with BENCH_ENGINE=scan,
# bench.py:95-104: ROW_CAPACITY, chunks of CHUNK, N_REMOVERS, N_PROP_KEYS,
# the reference's compaction watermark): phase 27 replays the
# SCAN_ENGINE_OPS headline prefix (deeper, the reference's schedule
# compacts after every chunk once the live rows pass the watermark;
# tools/scan_engine_replay.py runs it alone at any depth).
SCAN_ENGINE_OPS = 100_000
SCAN_ENGINE_WATERMARK = 0.7
# Phase 26: the zamboni kernel on the table that a scan-engine replay of
# the first ZAMBONI_OPS headline ops leaves with no host compaction
# (watermark 1.1: tombstones and split pieces stay), and on the edge
# tables of testing/zamboni_edges.py at ZAMBONI_EDGE_CAPACITIES.
ZAMBONI_OPS = 20_000
ZAMBONI_EDGE_CAPACITIES = (1024, 16384, 131072)
# The zamboni's int32 work: per live row the keep test (live, removed,
# rem_seq <= MSN, and, not: 5); per kept row, besides its KK prop
# compares, the pack's prefix add (1), settled (two compares, and: 3),
# the merge test's end add, compare and ands (4) and the run and length
# prefix adds (2); per run the length's subtract (1); and one select per
# output int.
ZAMBONI_OPS_LIVE, ZAMBONI_OPS_KEPT, ZAMBONI_OPS_RUN = 5, 10, 1
# Phase 7's deep compaction under the compaction's earlier design (three
# launches: zb_tiles, zb_rows and a text gather reading the kept rows'
# offsets back from a global scratch), ms a call behind a spin on an
# NVIDIA H100 80GB HBM3 at 700 W, printed beside this run's time.
COMPACTION_THREE_LAUNCH_MS = 0.030549
# The scan engine's stages that phase 27's split run times from outside
# the replica (`scan_engine_run(split=True)`): the chunk's upload, the
# scan launch, and compact() with its pull and push.
SCAN_STAGES = ("upload", "launch", "compact", "compact_pull",
               "compact_push")
# GPU cycles of the spin that holds the stream while the host enqueues
# timed sequencer launches (~25 ms at 1.98 GHz; doubled when short).
SPIN_CYCLES = 50_000_000
# Phase 28, the supervised deli role: the steps the first owner of the
# crash run takes before it "crashes", the role's stages that the phase
# times from outside the role, and how many of the successor's chunks
# are held against the plain sequencer.
ROLE_CRASH_STEPS = 20
ROLE_STAGES = ("poll_parse", "flush", "append", "checkpoint", "other")
ROLE_HELD_CHUNKS = 2
# phase 29, the summary service's role (config10's catch-up, config15's
# documents through the role, a crash, the first stacked round held)
SUMMARY_STAGES = ("poll", "process", "encode", "fold", "canonical_rows",
                  "reboot", "put", "append", "checkpoint", "other")
SUMMARY_BATCH = 4096  # `_drive_summarizer`'s reads, and the crash run's
SUMMARY_STACK_DOCS = 132
SUMMARY_CRASH_TTL = 2.0  # the first owner's lease, waited out
SUMMARY_TAIL = 256  # ops of tail each summary of the crash run boots with
SUMMARY_PLAIN_WORKERS = 3  # (e)'s CPU workers, beside the main process
# Phase 30, the multi-device layer on mesh entries of the one card: the
# dry run on MESH_DRYRUN_ENTRIES entries (the reference's validation
# shape, __graft_entry__.dryrun_multichip(8)); phase 11's first
# MESH_DOCS documents (100k ops each, the bench geometry) sharded over
# MESH_ENTRIES entries; and config 5 through a deli pool split over
# MESH_ENTRIES entries.
MESH_DRYRUN_ENTRIES, MESH_DRYRUN_SCALE = 8, 1.0
MESH_ENTRIES = 4
MESH_DOCS = 32
# Phase 31: config15's fold through the summarizer role on a device plane
# of entries of the one card (the reference's config15_device_plane,
# tools/bench_configs.py:1070, lays it on a 4x2 plane).
PLANE_SPEC = "4x2"


def log(msg: str) -> None:
    print(msg, flush=True)


def spin_time(launch, reps: int) -> float:
    """Device ms per call of `launch` (which enqueues one kernel launch)
    over `reps` calls, CUDA events, after one warm-up call. A spin
    kernel (`torch.cuda._sleep`) holds the stream while the host
    enqueues the launches, so the span holds no host gap; the spin
    doubles until it outlasts the enqueue."""
    import torch

    launch()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            launch()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        cycles *= 2
    raise AssertionError("spin_time: the spin never outlasted the host's "
                         "enqueue")


def timed_call(fn, *args):
    """(fn(*args), its seconds by the host clock): for a worker process,
    whose time the caller cannot see."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    t = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t


def build_and_stream(golden: dict, log):
    """Phase 2: the seven CUDA kernels (one nvcc each) and the native
    stream engine (g++) built in parallel from the checkout's sources,
    with GOLDEN.json's headline stream generated beside them in a
    worker process (the generator is a Python loop over the native
    engine; the builds leave the host's cores to it). Returns the
    stream."""
    from fluidframework_tpu_torch.native import load_hostmerge
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.ops.mergetree_chunk import (
        mergetree_chunk_kernel,
    )
    from fluidframework_tpu_torch.ops.mergetree_scan import (
        mergetree_scan_kernel,
    )
    from fluidframework_tpu_torch.ops.overlay import (
        overlay_chunk_kernel, overlay_fold_kernel,
    )
    from fluidframework_tpu_torch.ops.sequencer_kernel import (
        sequencer_step_kernel,
    )
    from fluidframework_tpu_torch.ops.zamboni_kernel import zamboni_kernel
    from fluidframework_tpu_torch.testing.golden import headline_stream
    from fluidframework_tpu_torch.tree.rebase_kernel import rebase_kernel

    t0 = time.perf_counter()
    cuda_names = (overlay_chunk_kernel.name, mergetree_chunk_kernel.name,
                  sequencer_step_kernel.name, rebase_kernel.name,
                  mergetree_scan_kernel.name, zamboni_kernel.name,
                  overlay_fold_kernel.name)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as gen, \
            concurrent.futures.ThreadPoolExecutor(len(cuda_names) + 1) as ex:
        f_stream = gen.submit(timed_call, headline_stream, golden)
        f_cuda = [ex.submit(_build.load, name) for name in cuda_names]
        f_host = ex.submit(load_hostmerge)
        for f in f_cuda:
            f.result()
        if f_host.result() is None:
            raise RuntimeError("g++ build of the native stream engine failed")
        log(f"build: {time.perf_counter() - t0:.2f}s (nvcc x{len(cuda_names)} "
            f"+ g++ in parallel)")
        full, t_gen = f_stream.result()
    for name in cuda_names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"stream: {golden['params']['n_ops']} lagged ops generated in "
        f"{t_gen:.2f}s (in a worker beside the build; "
        f"{time.perf_counter() - t0:.2f}s from the build's start)")
    return full


def output_diff(out, d: int, single) -> str:
    """The first field in which document `d` of a docs replay's outputs
    `out` (stacked tables, logs, counts, cursors) differs from `single`,
    one document's replay outputs (table, log, counts, cursor): the
    cursor, the log to it, the counts, then the final table whole (the
    fold fills the rows past n_rows). '' when they are all equal, and
    then so are the document's digest and error word, which its readout
    makes of these alone."""
    import torch

    tables, logs, counts, cursors = out[:4]
    table, log_, counts_, cursor = single
    cur = int(cursors[d])
    if cur != int(cursor):
        return "cursor"
    if not torch.equal(logs[d, :cur], log_[:cur]):
        return "log"
    if not torch.equal(counts[d], counts_):
        return "counts"
    tab = tables.doc(d)
    for f in dataclasses.fields(tab):
        if not torch.equal(getattr(tab, f.name), getattr(table, f.name)):
            return f"table.{f.name}"
    return ""


def fold_phases(dev, hold, time_chunks, log) -> dict:
    """Phases 13-16, the summary service's fold and the message-driven
    replica, on `dev`. `hold(out, tin, ops, label)` holds one
    document's kernel output against the plain version and
    `time_chunks(pairs)` gives kernel A's ms per launch over
    ``(table, ops)`` pairs. Raises on any mismatch; returns what the
    kernels line reports of these paths."""
    import torch

    from fluidframework_tpu_torch.core.kernel_replica import (
        EncoderState, PropInterner, TextArena, encode_op,
    )
    from fluidframework_tpu_torch.core.overlay_fold import (
        boot_overlay, group_jobs, run_rounds, stack_jobs,
    )
    from fluidframework_tpu_torch.core.overlay_replay import (
        OverlayKernelMessageReplica,
    )
    from fluidframework_tpu_torch.ops.mergetree_kernel import OP_NOOP
    from fluidframework_tpu_torch.ops.overlay import (
        fold_device, ops_at, overlay_apply_chunk, overlay_chunk_kernel,
        overlay_fold_kernel,
    )
    from fluidframework_tpu_torch.server.summary_fold import (
        SummaryFolder, _encode_fold,
    )
    from fluidframework_tpu_torch.testing import fold_streams as fs

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    golden = fs.load_fold_golden()
    step = golden["params"]["summary_ops"]
    t0 = time.perf_counter()
    streams = fs.golden_streams(golden, max(FOLD_DOCS))
    docs = list(streams)
    want = {d["doc"]: d["rows_sha256"] for d in golden["docs"]}
    n_rounds = len(want[docs[0]])
    seeds = [d["seed"] for d in golden["docs"][:len(docs)]]
    log(f"fold: {len(docs)} record streams of {golden['params']['n_ops']} "
        f"ops (seeds {seeds[0]}..{seeds[-1]}) in "
        f"{time.perf_counter() - t0:.2f}s; {n_rounds} rounds of {step} "
        f"records")

    def gate(digests, label):
        for doc, got in digests.items():
            if got != want[doc][:len(got)]:
                k = next(i for i, (a, b) in enumerate(zip(got, want[doc]))
                         if a != b)
                raise AssertionError(
                    f"{label}: {doc} emission {k} rows differ from "
                    f"fold_golden.json")

    def sweep(n_docs, label):
        """The fold sweep over `n_docs` documents: (its result, kernel A's
        launches, the fold kernel's). A round's fold launches are its
        chunks (the replay's, one with each kernel A launch) and its
        emissions (each `canonical_rows` folds once more)."""
        sub = {d: streams[d] for d in docs[:n_docs]}
        sync()
        overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
        out = fs.run_fold_sweep(sub, step, dev)
        sync()
        launches = overlay_chunk_kernel.launches
        launches_f = overlay_fold_kernel.launches
        chunks = sum(r["chunks"] for r in out["rounds"])
        emissions = sum(r["emissions"] for r in out["rounds"])
        if dev.type == "cuda" and (launches != chunks
                                   or launches_f != chunks + emissions):
            raise AssertionError(
                f"{label}: kernel A launches {launches} != chunks {chunks} "
                f"or fold launches {launches_f} != chunks + emissions "
                f"{chunks + emissions}")
        if any(sum(g["chunks"] for g in r["groups"]) != r["chunks"]
               for r in out["rounds"]):
            raise AssertionError(f"{label}: the fold's groups disagree "
                                 f"with the replicas' chunks")
        gate(out["digests"], label)
        if any(len(v) != n_rounds for v in out["digests"].values()):
            raise AssertionError(f"{label}: not every round emitted")
        return out, launches, launches_f

    # ---- 13. the summary folder, config15's documents -------------------
    warm, _, _ = sweep(FOLD_DOCS[0], "fold warm-up")
    folder = SummaryFolder(summary_ops=step, device=dev)
    sync()
    overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
    t0 = time.perf_counter()
    manifests = []
    for lo in range(0, len(streams[docs[0]]), step):
        for d in docs[:FOLD_DOCS[0]]:
            for rec in streams[d][lo:lo + step]:
                folder.process(rec)
        manifests += folder.flush()
    sync()
    t_folder = time.perf_counter() - t0
    launches_folder = overlay_chunk_kernel.launches
    launches_folder_f = overlay_fold_kernel.launches
    # The folder emits at every whole `step` records: the sweep's rounds
    # but its last, short one.
    n_whole = len(streams[docs[0]]) // step
    want_chunks = sum(r["chunks"] for r in warm["rounds"][:n_whole])
    if dev.type == "cuda" and launches_folder != want_chunks:
        raise AssertionError(f"summary folder: kernel launches "
                             f"{launches_folder} != chunks {want_chunks}")
    if dev.type == "cuda" and \
            launches_folder_f != launches_folder + len(manifests):
        raise AssertionError(f"summary folder: fold launches "
                             f"{launches_folder_f} != chunks + emissions "
                             f"{launches_folder + len(manifests)}")
    got = {}
    for m in manifests:
        got.setdefault(m["doc"], []).append([m["seq"], m["count"],
                                             m["handle"]])
    if got != {d: golden["manifests"][d] for d in docs[:FOLD_DOCS[0]]} \
            or folder.frozen:
        raise AssertionError("summary folder: manifests differ from the "
                             "JAX summarizer role's (fold_golden.json)")
    log(f"summary folder: {len(manifests)} summaries of {FOLD_DOCS[0]} "
        f"documents in {t_folder:.3f}s (kernel A launches {launches_folder}, "
        f"one per chunk and window group; fold launches {launches_folder_f}, "
        f"one more per emission); seq, count and handle of every "
        f"manifest equal the JAX summarizer role's")

    # ---- 14. the fold's stacked launches vs the plain version ----------
    held = 0
    reps = {d: boot_overlay([], 0, device=dev) for d in docs}
    for d in docs:
        _encode_fold(reps[d], streams[d][:step])
    jobs = [reps[d].build_round() for d in docs]
    chunk_ms, chunk_bound = {}, {}
    for grp in group_jobs(jobs).values():
        tables, ops, _, _, msns = stack_jobs(grp)
        out = overlay_apply_chunk(tables, ops_at(ops, 0))
        for k in range(len(grp)):
            hold(out.doc(k), tables.doc(k), ops_at(ops_at(ops, 0), k),
                 f"fold D {len(grp)} W {grp[0]['window']}: doc {k} round 0 "
                 f"chunk 0")
            held += 1
        if len(grp) == len(docs):
            pairs, tin = [], tables
            for ci in range(msns.shape[0]):
                pairs.append((tin, ops_at(ops, ci)))
                tin = fold_device(overlay_apply_chunk(tin, pairs[-1][1]),
                                  msns[ci])[0]
            chunk_ms[len(docs)] = time_chunks(pairs)
            chunk_ms[1] = time_chunks([(t.doc(0), ops_at(c, 0))
                                       for t, c in pairs])
            fold_shape = dict(W=grp[0]["window"], B=ops.op_type.shape[-1],
                              KR=tables.rem_clients.shape[-1],
                              KK=tables.props.shape[-1],
                              PK=ops.prop_keys.shape[-1])
            # Least time for the same work, as for the bench chunks:
            # each document's table in and out once and its ops in once
            # over the HBM rate; INT_OPS_PER_ROW per live row per op.
            f = fold_shape
            for n_d in (len(docs), 1):
                nbytes = n_d * 4 * (2 * (f["W"] * (6 + f["KR"] + f["KK"]) + 3)
                                    + f["B"] * (8 + 2 * f["PK"]))
                n_int = sum(
                    int((t.n_rows[:n_d] * (c.op_type[:n_d] != OP_NOOP)
                         .sum(-1)).sum()) for t, c in pairs
                ) * INT_OPS_PER_ROW / len(pairs)
                b_s, o_s = nbytes / PEAK_BYTES_S, n_int / PEAK_OPS_S
                chunk_bound[n_d] = (max(b_s, o_s) * 1e3,
                                    "bytes" if b_s >= o_s else "operations")
    if not chunk_ms:
        raise AssertionError("fold round 0: the documents' windows differ")
    late = docs[:FOLD_LATE_DOCS]
    reps = {d: boot_overlay([], 0, device=dev) for d in late}
    msn = {d: 0 for d in late}
    digests = {d: [] for d in late}
    for r in range(n_rounds):
        for d in late:
            take = streams[d][r * step:(r + 1) * step]
            _encode_fold(reps[d], take)
            msn[d] = max(msn[d], max(x["msn"] for x in take))
        jobs = [reps[d].build_round() for d in late]
        if r >= n_rounds - FOLD_LATE_ROUNDS:
            for grp in group_jobs(jobs).values():
                tables, ops, _, _, msns = stack_jobs(grp)
                for ci in range(msns.shape[0]):
                    chunk = ops_at(ops, ci)
                    out = overlay_apply_chunk(tables, chunk)
                    for k in range(len(grp)):
                        hold(out.doc(k), tables.doc(k), ops_at(chunk, k),
                             f"fold D {len(grp)}: doc {k} round {r} "
                             f"chunk {ci}")
                        held += 1
                    tables = fold_device(out, msns[ci])[0]
        run_rounds(jobs)
        for d in late:
            rows = reps[d].canonical_rows(msn[d])
            digests[d].append(hashlib.sha256(
                json.dumps(rows, sort_keys=True).encode()).hexdigest())
            reps[d] = boot_overlay(rows, msn[d], device=dev)
    gate(digests, "fold held rounds")
    log(f"fold: the stacked launch == plain on {held} (document, chunk) "
        f"pairs: all {len(docs)} documents on round 0's first chunk, "
        f"{len(late)} on every chunk of the last {FOLD_LATE_ROUNDS} rounds; "
        f"kernel A at the fold's shape {fold_shape}: "
        f"{chunk_ms[len(docs)]:.4f} ms per launch of {len(docs)} blocks "
        f"(bound {chunk_bound[len(docs)][0]:.6f} ms, "
        f"{chunk_bound[len(docs)][1]}), {chunk_ms[1]:.4f} ms for one "
        f"document (bound {chunk_bound[1][0]:.6f} ms, {chunk_bound[1][1]}; "
        f"CUDA events, round 0's chunks)")

    # ---- 15. the fold, timed, at each D ---------------------------------
    runs = []
    layouts = {}
    for D in FOLD_DOCS:
        out, launches, launches_f = sweep(D, f"fold D {D}")
        rounds = out["rounds"]
        n_em = sum(r["emissions"] for r in rounds)
        enc = sum(r["encode_s"] for r in rounds)
        fold = sum(r["fold_s"] for r in rounds)
        ser = sum(r["serialize_s"] for r in rounds)
        dev_s = (sum(r["device_ms"] for r in rounds) / 1e3
                 if dev.type == "cuda" else None)
        for r in rounds:
            for g in r["groups"]:
                key = (g["window"], g["docs"])
                layouts[key] = layouts.get(key, 0) + g["chunks"]
        run = dict(D=D, seconds=out["seconds"], emissions=n_em,
                   rounds=len(rounds), launches=launches,
                   fold_launches=launches_f,
                   emissions_per_s=n_em / out["seconds"],
                   fold_ops_per_s=out["op_records"] / out["seconds"],
                   encode_s_per_round=enc / len(rounds),
                   fold_s_per_round=fold / len(rounds),
                   device_s_per_round=(None if dev_s is None
                                       else dev_s / len(rounds)),
                   serialize_s_per_round=ser / len(rounds),
                   windows=sorted({g["window"] for r in rounds
                                   for g in r["groups"]}))
        runs.append(run)
        dev_txt = ("not measured" if dev_s is None
                   else f"{run['device_s_per_round']:.4f}s")
        log(f"fold D {D}: {n_em} emissions ({len(rounds)} rounds) in "
            f"{out['seconds']:.3f}s = {run['emissions_per_s']:,.1f} "
            f"emissions/s, {run['fold_ops_per_s']:,.0f} fold ops/s; per "
            f"round: encode {run['encode_s_per_round']:.4f}s, fold "
            f"{run['fold_s_per_round']:.4f}s (device {dev_txt}, CUDA events "
            f"around the stacked replays), serialization + reboot "
            f"{run['serialize_s_per_round']:.4f}s; kernel A launches "
            f"{launches} (one per chunk and window group; windows "
            f"{run['windows']}), fold launches {launches_f} (and one an "
            f"emission); every digest equals fold_golden.json")

    # ---- 16. the message-driven replica, card vs CPU --------------------
    launches_msg, launches_msg_f, t_msg, n_msg = 0, 0, 0.0, 0
    threads = torch.get_num_threads()
    for d in docs[:MSG_DOCS]:
        msgs = fs.as_messages(streams[d])
        enc = EncoderState(TextArena(""), PropInterner(8), 4)
        for m in msgs:
            if m.contents is not None and m.type.value == "op":
                encode_op(enc, m.contents, m)
        rep = OverlayKernelMessageReplica(chunk_size=MSG_CHUNK,
                                          window=MSG_WINDOW, device=dev)
        sync()
        overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
        t0 = time.perf_counter()
        rep.apply_messages(msgs)
        sync()
        t_msg += time.perf_counter() - t0
        n_msg += len(enc._encoded)
        launches = overlay_chunk_kernel.launches
        launches_f = overlay_fold_kernel.launches
        want_launches = -(-len(enc._encoded) // MSG_CHUNK)
        # A fold a chunk, and a fold-only epoch when no rows are left
        # after the last whole chunk.
        want_f = want_launches + (len(enc._encoded) % MSG_CHUNK == 0)
        if dev.type == "cuda" and (launches != want_launches
                                   or launches_f != want_f):
            raise AssertionError(f"message replica {d}: kernel A launches "
                                 f"{launches} != chunks {want_launches} or "
                                 f"fold launches {launches_f} != {want_f}")
        launches_msg += launches
        launches_msg_f += launches_f
        torch.set_num_threads(1)
        try:
            cpu = OverlayKernelMessageReplica(chunk_size=MSG_CHUNK,
                                              window=MSG_WINDOW,
                                              device="cpu")
            cpu.apply_messages(msgs)
        finally:
            torch.set_num_threads(threads)
        if (int(rep.table.error), rep.get_text(), rep.annotated_spans()) != (
                int(cpu.table.error), cpu.get_text(), cpu.annotated_spans()):
            raise AssertionError(f"message replica {d}: the card's text, "
                                 f"spans or error word differ from the CPU's")
        if int(rep.table.error):
            raise AssertionError(f"message replica {d}: error "
                                 f"{int(rep.table.error)}")
    log(f"message replica: {MSG_DOCS} documents, {n_msg} ops (chunks of "
        f"{MSG_CHUNK}, window {MSG_WINDOW}) in {t_msg:.3f}s = "
        f"{n_msg / t_msg:,.0f} ops/s one document at a time (kernel A "
        f"launches {launches_msg}, fold launches {launches_msg_f}); text, "
        f"spans and error word equal the CPU run's")
    return dict(
        summary_folder=launches_folder, message_replica=launches_msg,
        fold_sweep={str(r["D"]): r["launches"] for r in runs},
        fold_kernel_paths=dict(
            summary_folder=launches_folder_f,
            fold={str(r["D"]): r["fold_launches"] for r in runs},
            message_replica=launches_msg_f),
        fold_runs=runs, fold_held_pairs=held,
        fold_groups=[dict(W=w, D=n, chunks=c,
                          layout=(overlay_chunk_kernel.plan(
                              w, fold_shape["KR"], fold_shape["KK"],
                              fold_shape["B"], fold_shape["PK"]).layout
                              if dev.type == "cuda" else None))
                     for (w, n), c in sorted(layouts.items())],
        fold_shape=fold_shape,
        fold_chunk_ms={str(k): v for k, v in chunk_ms.items()},
        fold_chunk_bound_ms={str(k): v[0] for k, v in chunk_bound.items()},
    )


def deli_phases(dev, log) -> dict:
    """Phases 17-19, the deli sequencer, on `dev`: the sequencer kernel
    against its plain version (on CPU copies of the same inputs,
    exactly), BASELINE config 5's stream through `KernelDeliLambda`
    timed and gated on deli_golden.json, and a checkpoint restore.
    Raises on any mismatch; returns what the kernels line reports."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
    from fluidframework_tpu_torch.server.deli_kernel import (
        TIME_KEYS, KernelDeliLambda, new_times,
    )
    from fluidframework_tpu_torch.server.log import MessageLog
    from fluidframework_tpu_torch.testing import deli_streams as ds

    kernel = tsk.sequencer_step_kernel
    with open(os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                           "deli_golden.json")) as f:
        golden = json.load(f)
    p = golden["params"]
    t0 = time.perf_counter()
    raws = ds.to_inproc(ds.build_pipeline_workload(
        p["n_docs"], p["n_clients"], p["ops_per_client"], seed=p["seed"]))
    pump = p["max_pump"]
    log(f"deli: {len(raws)} raw records ({p['n_docs']} documents x "
        f"{p['n_clients']} clients x {p['ops_per_client']} op) built in "
        f"{time.perf_counter() - t0:.2f}s; pumps of {pump}")

    max_err = 0
    held = {"chunks": 0, "shared": 0, "global": 0}  # chunks; outputs per layout

    def to_cpu(ts):
        return [t.cpu() for t in ts]

    def compare(got, want, label):
        """A launch's (state, tracker, verdicts) against the plain
        version's, exactly; the verdicts may be numpy arrays."""
        nonlocal max_err
        pairs = [*zip(tsk.SequencerState._fields, got[0], want[0]),
                 ("aborted", got[1], want[1]),
                 *zip(tsk.SeqResult._fields, got[2], want[2])]
        for name, a, b in pairs:
            a = torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a)
                                           else a))
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{label}: {name} is {a.dtype} "
                                     f"{tuple(a.shape)}, plain {b.dtype} "
                                     f"{tuple(b.shape)}")
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
                if a.numel() else 0
            max_err = max(max_err, diff)
            if diff:
                raise AssertionError(f"{label}: {name} differs from the "
                                     f"plain version by {diff}")

    def hold(st_in, ab_in, cols, dedup, got, label, layouts=()):
        """The kernel's (state, tracker, verdicts) `got` on one chunk
        against the plain version on CPU copies of its inputs; each of
        `layouts` is launched again on the same inputs and held too.
        Returns the plain version's seconds."""
        t0 = time.perf_counter()
        want = tsk.sequence_batch_ref(
            tsk.SequencerState(*to_cpu(st_in)), ab_in.cpu(),
            tsk.SeqBatch(*to_cpu(cols[:4])), cols[4].cpu(), dedup)
        plain_s = time.perf_counter() - t0
        compare(got, want, label)
        held["chunks"] += 1
        held[kernel.plan(st_in.connected.shape[1])] += 1
        for lay in layouts:
            again = kernel(st_in, ab_in, tsk.SeqBatch(*cols[:4]), cols[4],
                           dedup, layout=lay)
            torch.cuda.synchronize()
            compare(again, want, f"{label} ({lay})")
            held[lay] += 1
        return plain_s

    def time_kernel(st_in, ab_in, cols, dedup, layout, reps=20) -> float:
        """The kernel's device ms per launch in `layout` over `reps`
        launches on the same inputs (the state stays in L2, as between
        the path's pumps): `spin_time`."""
        batch = tsk.SeqBatch(*cols[:4])
        return spin_time(lambda: kernel(st_in, ab_in, batch, cols[4], dedup,
                                        layout=layout), reps)

    def bound(D, C, B, stamps):
        """Least time for a launch: the state row in and out once
        (seq, min_seq, tracker: 12 bytes; C connected bytes, C refSeqs,
        C clientSeqs), the batch in (5 int32) and the verdicts out (3
        int32 + 1 byte) once, over the HBM rate; against the int32 work,
        SEQ_OPS_PER_SUB per submission and SEQ_OPS_PER_COL per client
        column per stamp (the MSN's masked min), over the int32 rate."""
        nbytes = 2 * D * (12 + 9 * C) + D * B * (20 + 13)
        ops = D * B * SEQ_OPS_PER_SUB + stamps * C * SEQ_OPS_PER_COL
        b_ms, o_ms = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
        return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")

    def checked_lambda(recs, label, check_chunks=None, layouts=(),
                       timed=None, **kw):
        """Drain `recs` through a `KernelDeliLambda` on the card whose
        chunks (all, or the indices in `check_chunks`) are held against
        the plain version; `timed` collects per-chunk times. Returns
        (normalized deltas, checkpoint digest, the deli)."""
        lg = MessageLog()
        lg.topic("rawdeltas").append_many(recs)
        deli = KernelDeliLambda(lg, device=dev, **kw)
        pool = deli.core.pool
        run_chunk = pool.run_chunk

        def checked(kind, client, cseq, ref, groups, dedup, aborted=None):
            i = pool.chunks
            if check_chunks is not None and i not in check_chunks:
                return run_chunk(kind, client, cseq, ref, groups, dedup,
                                 aborted)
            if aborted is None:
                aborted = tsk.no_aborts(pool.n_docs, dev)
            st_in, ab_in = pool.state, aborted
            res, ab = run_chunk(kind, client, cseq, ref, groups, dedup,
                                aborted)
            torch.cuda.synchronize()
            cols = [torch.from_numpy(c).to(dev)
                    for c in (kind, client, cseq, ref, groups)]
            plain_s = hold(st_in, ab_in, cols, dedup, (pool.state, ab, res),
                           f"{label} chunk {i}", layouts)
            if timed is not None:
                D, C = st_in.connected.shape
                B = kind.shape[1]
                stamps = int((res.seq > 0).sum())
                b_ms, by = bound(D, C, B, stamps)
                # Both layouts on the same inputs, in the order shared,
                # global, global, shared; each one's mean.
                both = {lay: [] for lay in tsk.LAYOUTS}
                for lay in tsk.LAYOUTS + tsk.LAYOUTS[::-1]:
                    both[lay].append(time_kernel(st_in, ab_in, cols, dedup,
                                                 lay))
                both = {lay: sum(v) / len(v) for lay, v in both.items()}
                timed.append(dict(
                    chunk=i, D=D, C=C, B=B, stamps=stamps,
                    layout=kernel.plan(C), ms=both[kernel.plan(C)],
                    layout_ms=both, plain_ms=plain_s * 1e3, bound_ms=b_ms,
                    bound_by=by))
            return res, ab

        pool.run_chunk = checked
        while deli.pump():
            pass
        entries = [ds.norm_entry(e) for e in lg.topic("deltas").read(0)]
        return entries, ds.checkpoint_digest(deli.checkpoint()), deli

    # ---- 17. the sequencer kernel vs its plain version ----------------
    t17 = time.perf_counter()
    # (a) the main path's chunks: the first 4 pumps and the last 2, with
    # the kernel timed there in both layouts (CUDA events) and the plain
    # version (host clock, on the CPU).
    n_pumps = p["pumps"]
    timed = []
    _, cp_digest, deli = checked_lambda(
        raws, "main path", check_chunks={0, 1, 2, 3, n_pumps - 2,
                                         n_pumps - 1},
        timed=timed, max_pump=pump)
    if deli.core.pool.chunks != n_pumps or cp_digest != \
            golden["checkpoint_sha256"]:
        raise AssertionError(
            f"phase 17 main path: {deli.core.pool.chunks} chunks, "
            f"checkpoint {cp_digest} (golden {golden['checkpoint_sha256']})")
    for r in timed:
        log(f"  sequencer_step main-path chunk {r['chunk']}: D {r['D']} "
            f"C {r['C']} B {r['B']} ({r['stamps']} stamps): kernel "
            f"{r['ms']:.6f} ms ({r['layout']} layout, planned; shared "
            f"{r['layout_ms']['shared']:.6f}, global "
            f"{r['layout_ms']['global']:.6f} = "
            f"{r['layout_ms']['global'] / r['layout_ms']['shared']:.3f}x), "
            f"plain (CPU) {r['plain_ms']:.2f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    del deli
    # (b) edge traffic, sequencer level: grouped chunks of 32 with
    # boxcars across chunk edges, dedup on and off, system stamps,
    # unknown / negative / huge client slots, every nack code, D 13
    # (a block with one live warp of four), both layouts at C 8 and 128.
    nacks = set()
    for C in (8, 128):
        for dedup in (False, True):
            D = 13
            st = tsk.make_state(D, C, dev)
            ab = tsk.no_aborts(D, dev)
            for ci, cols in enumerate(ds.edge_chunks(C + dedup, D, 8, 256,
                                                     32)):
                cols = [torch.from_numpy(c).to(dev) for c in cols]
                got = kernel(st, ab, tsk.SeqBatch(*cols[:4]), cols[4], dedup)
                torch.cuda.synchronize()
                other = "global" if kernel.plan(C) == "shared" else "shared"
                hold(st, ab, cols, dedup, got,
                     f"edge C {C} dedup {dedup} chunk {ci}", (other,))
                nacks |= set(got[2].nack.flatten().tolist())
                st, ab = got[0], got[1]
    if not {400, 403, 416, 422} <= nacks:
        raise AssertionError(f"edge traffic missed a nack code: {nacks}")
    # (b') the deli on random traffic: pumps of 37, chunks of 8, five
    # slots under a resident budget of 6 (eviction), every chunk held.
    for seed in (0, 1, 2):
        recs = ds.gen_raw_traffic(seed, n=400, docs=9)
        kw = dict(max_pump=37, max_cols=8, n_docs=5, max_resident=6)
        got = checked_lambda(recs, f"traffic seed {seed}", **kw)
        lg = MessageLog()
        lg.topic("rawdeltas").append_many(recs)
        cpu = KernelDeliLambda(lg, device="cpu", **kw)
        while cpu.pump():
            pass
        if got[0] != [ds.norm_entry(e) for e in lg.topic("deltas").read(0)]:
            raise AssertionError(f"traffic seed {seed}: the card's deltas "
                                 f"differ from the CPU deli's")
    # (c) churn: 1000 and 1100 distinct clients per document in one pump
    # grow the columns to C 1024 (shared layout) and 2048 (global), at
    # D 5; each chunk is held in the other layout too.
    for n_clients, want_c in ((1000, 1024), (1100, 2048)):
        recs = ds.churn_raws(3, n_clients, seed=n_clients)
        other = "global" if want_c == 1024 else "shared"
        _, _, deli = checked_lambda(recs, f"churn C {want_c}",
                                    layouts=(other,), max_pump=len(recs),
                                    n_docs=5)
        pool = deli.core.pool
        if (pool.n_clients, pool.n_docs) != (want_c, 5):
            raise AssertionError(f"churn: pool reached C {pool.n_clients} "
                                 f"D {pool.n_docs}")
    log(f"sequencer_step vs plain: {held['shared'] + held['global']} "
        f"kernel outputs on {held['chunks']} chunks exact (tolerance 0; "
        f"{held['shared']} in the shared layout, {held['global']} in the "
        f"global one), max_abs_err {max_err}, nack codes {sorted(nacks)}; "
        f"phase 17 {time.perf_counter() - t17:.2f}s")

    # ---- 18. the main path -------------------------------------------
    warm = MessageLog()
    warm.topic("rawdeltas").append_many(raws[:4 * pump])
    deli = KernelDeliLambda(warm, device=dev, max_pump=pump)
    while deli.pump():
        pass
    del deli, warm
    lg = MessageLog()
    lg.topic("rawdeltas").append_many(raws)
    deli = KernelDeliLambda(lg, device=dev, max_pump=pump)
    pool = deli.core.pool
    pool.times = new_times()
    torch.cuda.synchronize()
    kernel.launches = 0
    pumps = 0
    t0 = time.perf_counter()
    while deli.pump():
        pumps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    if launches != pool.chunks or pumps != n_pumps:
        raise AssertionError(f"main path: {launches} launches, "
                             f"{pool.chunks} chunks, {pumps} pumps")
    digest = ds.StreamDigest().update(lg.topic("deltas").read(0))
    cp = ds.checkpoint_digest(deli.checkpoint())
    if (digest.hexdigest(), digest.stamps, digest.nacks, cp) != (
            golden["deltas_sha256"], golden["stamps"], golden["nacks"],
            golden["checkpoint_sha256"]):
        raise AssertionError(
            f"main path: deltas {digest.hexdigest()} ({digest.stamps} "
            f"stamps, {digest.nacks} nacks), checkpoint {cp} differ from "
            f"deli_golden.json")
    times = pool.times
    split = {k.rsplit("_", 1)[0]: times[k] * 1e3 / pumps for k in TIME_KEYS}
    log(f"deli main path: {len(raws)} records in {pumps} pumps in "
        f"{wall:.3f}s = {len(raws) / wall:,.0f} records/s (host clock); "
        f"kernel launches {launches} = chunks; pool D {pool.n_docs} C "
        f"{pool.n_clients} B {pool.max_cols_seen}; deltas and checkpoint "
        f"digests match deli_golden.json ({digest.stamps} stamps, "
        f"{digest.nacks} nacks)")
    log("  ms per pump (host clock): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items())
        + " (launch: the launch call; the kernel's device time: phase 19)")
    del deli, lg

    # ---- 19. restore --------------------------------------------------
    half = len(raws) // 2
    first = MessageLog()
    first.topic("rawdeltas").append_many(raws[:half])
    deli = KernelDeliLambda(first, device=dev, max_pump=pump)
    kernel.launches = 0
    while deli.pump():
        pass
    cp = deli.checkpoint()
    digest = ds.StreamDigest().update(first.topic("deltas").read(0))
    del deli, first
    second = MessageLog()
    second.topic("rawdeltas").append_many(raws)
    deli = KernelDeliLambda(second, cp, device=dev, max_pump=pump)
    # The second half under the profiler (device activity only): the
    # kernel's own device time in the path, and the device's busy share.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while deli.pump():
            pass
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    launches_restore = kernel.launches
    seq_us, seq_n, busy_us = 0.0, 0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        busy_us += us
        if "sequencer_step" in e.key:
            seq_us += us
            seq_n += e.count
    prof_kernel_ms = seq_us / 1e3 / seq_n if seq_n else None
    busy_share = busy_us / 1e6 / wall_prof
    # The kernel's stage of a pump: its device time under the profiler,
    # per launch, times the main path's launches per pump.
    split["kernel"] = (prof_kernel_ms * launches / pumps if seq_n
                       else None)
    log(f"deli second half under the profiler: {wall_prof:.3f}s; "
        f"sequencer_step {seq_n} launches, "
        + (f"{prof_kernel_ms:.6f} ms each (device) = "
           f"{split['kernel']:.6f} ms per main-path pump" if seq_n else
           "no device time seen (not measured)")
        + f"; all device work {busy_us / 1e3:.3f} ms, busy share "
        f"{busy_share:.6f}")
    digest.update(second.topic("deltas").read(0))
    cp2 = ds.checkpoint_digest(deli.checkpoint())
    if (digest.hexdigest(), cp2) != (golden["deltas_sha256"],
                                     golden["checkpoint_sha256"]):
        raise AssertionError("restore: the concatenated deltas or the final "
                             "checkpoint differ from deli_golden.json")
    log(f"deli restore: checkpoint at record {half}, restored into a new "
        f"lambda, drained; concatenated deltas and final checkpoint match "
        f"deli_golden.json (kernel launches {launches_restore})")
    del deli, second

    last = [r for r in timed if r["C"] == timed[-1]["C"]]
    n = len(last)
    return dict(
        launches=launches,
        max_abs_err=max_err,
        ms=sum(r["ms"] for r in last) / n,
        plain_ms=sum(r["plain_ms"] for r in last) / n,
        bound_ms=sum(r["bound_ms"] for r in last) / n,
        bound_by=last[-1]["bound_by"],
        layout_ms={lay: sum(r["layout_ms"][lay] for r in last) / n
                   for lay in tsk.LAYOUTS},
        checked_chunks=timed,
        profiled_ms_per_launch=prof_kernel_ms,
        profiled_busy_share=busy_share,
        path_launches={"deli_main_path": launches,
                       "deli_restore": launches_restore},
        pump_ms=split,
        records_per_s=len(raws) / wall,
        pool={"D": pool.n_docs, "C": pool.n_clients,
              "B": pool.max_cols_seen},
        held_chunks=held,
    )


def tree_phases(dev, log) -> dict:
    """Phases 20-21, SharedTree's batched rebase (BASELINE config 4), on
    `dev`: the rebase kernel against its plain version (on CPU copies of
    the same inputs, exactly), then config 4 through
    `rebase_ops_columnar` gated on tree_golden.json and timed. Raises on
    any mismatch; returns what the kernels line reports."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fluidframework_tpu_torch.testing import tree_streams as ts
    from fluidframework_tpu_torch.tree import rebase_kernel as trk

    kernel = trk.rebase_kernel
    golden = ts.load_tree_golden()

    def columns(ops, base):
        ops, base = trk._pad(ops), trk._pad(base)
        return [torch.from_numpy(np.ascontiguousarray(a[:, j]))
                for a in (ops, base) for j in range(4)]

    # ---- 20. the rebase kernel vs its plain version ------------------
    t20 = time.perf_counter()
    max_err, held, calls = 0, 0, 0
    plain_ms = None
    before = kernel.launches
    cases = ts.all_streams() + [("config4", *ts.config4_inputs())]
    for name, ops, base in cases:
        cols = columns(ops, base)
        dev_cols = [c.to(dev) for c in cols]
        got = trk.rebase_batch(*dev_cols)
        torch.cuda.synchronize()
        calls += 1 if len(ops) else 0  # N = 0 launches nothing
        t0 = time.perf_counter()
        want = trk.rebase_batch_ref(*cols)
        plain_s = time.perf_counter() - t0
        if name == "config4":
            plain_ms = plain_s * 1e3
        for field, a, b in zip(trk.OUT_FIELDS, got, want):
            a = a.cpu()
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"rebase {name}: {field} is {a.dtype} "
                                     f"{tuple(a.shape)}, plain {b.dtype} "
                                     f"{tuple(b.shape)}")
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
                if a.numel() else 0
            max_err = max(max_err, diff)
            if diff:
                raise AssertionError(f"rebase {name}: {field} differs from "
                                     f"the plain version by {diff}")
            held += 1
        for d, c in zip(dev_cols, cols):
            if not torch.equal(d.cpu(), c):
                raise AssertionError(f"rebase {name}: the kernel changed "
                                     f"an input")
    if kernel.launches - before != calls:
        raise AssertionError(f"rebase: {kernel.launches - before} launches "
                             f"for {calls} calls")
    log(f"rebase_batch vs plain: {held} outputs of {len(cases)} rebases "
        f"exact (tolerance 0; 20 streams, {len(cases) - 21} edge cases, "
        f"config 4), inputs unchanged, launches {calls} = calls, "
        f"max_abs_err {max_err}; plain (CPU) config 4 {plain_ms:.2f} ms; "
        f"phase 20 {time.perf_counter() - t20:.2f}s")

    # ---- 21. config 4 through rebase_ops_columnar ---------------------
    ts.run_config4(dev)  # warm-up: allocator, first launch
    torch.cuda.synchronize()
    kernel.launches = 0
    run = ts.run_config4(dev)
    launches = kernel.launches
    counts = {k: run[k] for k in ("flagged", "native_splits", "muted")}
    want_digests = {k: golden[f"{k}_sha256"]
                    for k in ("rebased", "spares", "flagged")}
    if launches != 1 or run["digests"] != want_digests or \
            counts != {k: golden[k] for k in counts}:
        raise AssertionError(f"config 4: {launches} launches, digests "
                             f"{run['digests']}, counts {counts} differ "
                             f"from tree_golden.json")
    repeats = [ts.run_config4(dev)["op_rebases_per_sec"]
               for _ in range(REBASE_REPEATS)]
    # The kernel's device time: spin-held events over queued launches on
    # config 4's inputs, and under the profiler in the path.
    ops, base = ts.config4_inputs()
    n, m = ops.shape[0], base.shape[0]
    dev_cols = [c.to(dev) for c in columns(ops, base)]
    _, out = trk.alloc_result(n, dev)
    ms = spin_time(lambda: kernel(*dev_cols, out=out), 50)
    # Where a launch's time goes: the same pending ops over no base op
    # (loads, partition, stores), and config 4's window with every pending
    # op of one kind (that kind's step in every warp; a move's dst drawn).
    ms_no_window = spin_time(
        lambda: kernel(*dev_cols[:4], *(c[:0] for c in dev_cols[4:]),
                       out=out), 50)
    rng = np.random.default_rng(CONFIG4_ONE_KIND_SEED)
    ms_one_kind = {}
    for k, name in enumerate(trk.WARP_STEPS[:3]):
        one = ops.copy()
        one[:, 0] = k
        one[:, 3] = rng.integers(0, 100_000, n) if k == trk.K_MOVE else 0
        one_cols = [c.to(dev) for c in columns(one, base)]
        ms_one_kind[name] = spin_time(lambda: kernel(*one_cols, out=out), 50)
    torch.cuda.synchronize()
    # Several calls: a profiler session that follows another one in the
    # process (phase 19's) can miss the device work of its first
    # milliseconds, so the mean is over the launches it saw.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REBASE_REPEATS):
            ts.run_config4(dev)
        torch.cuda.synchronize()
    prof_us, prof_n = 0.0, 0
    for e in prof.key_averages():
        if "rebase_batch" in e.key:
            prof_us += getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
            prof_n += e.count
    prof_ms = prof_us / 1e3 / prof_n if prof_n else None
    # Least time: the pending columns in (16 bytes an op) and the outputs
    # out (6 int32 + 2 bytes) once, the base once, over the HBM rate;
    # against this run's int32 work, by each base op's code and each
    # pending op's kind: REBASE_ALU_OPS over the ALU's rate, REBASE_OPS
    # over the issue rate, whichever takes longer.
    bk, bi, bn, bj = (base[:, j].astype(np.int64) for j in range(4))
    noop = (bk == 2) & (bi <= bj) & (bj <= bi + bn)
    codes = np.where(bk == 0, "insert", np.where(
        bk == 1, "remove", np.where(bk == 2, np.where(noop, "noop", "move"),
                                    "other")))
    pk = ops[:, 0]
    kinds = {k: int((pk == k).sum()) for k in (0, 1, 2)}
    kinds[-1] = n - sum(kinds.values())
    op_count = sum(REBASE_OPS[c][k] * nk for c in codes
                   for k, nk in kinds.items())
    # What a warp issues a step by the table: its kind's branch when its
    # ops share one kind, every kind's in a warp of mixed kinds.
    all_kinds = sum(REBASE_OPS[c][k] for c in codes for k in (0, 1, 2)) / m
    steps = trk.warp_steps(pk)
    n_warps = sum(steps.values())
    mixed_share = steps["generic"] / n_warps
    uniform = {trk.WARP_STEPS[k]: sum(REBASE_OPS[c][k] for c in codes) / m
               for k in (0, 1, 2)}
    mean_step = (sum(uniform[k] * steps[k] for k in uniform)
                 + all_kinds * steps["generic"]) / n_warps
    # By pipe: the ALU-only work over the ALU's rate, all of it over the
    # issue rate (adds and moves may go to the FMA pipe as IMADs).
    alu_count = sum(REBASE_ALU_OPS[c][k] * nk for c in codes
                    for k, nk in kinds.items())
    nbytes = n * (16 + 26) + m * 16
    b_ms = nbytes / PEAK_BYTES_S * 1e3
    alu_ms = alu_count / PEAK_OPS_S * 1e3
    issue_ms = op_count / PEAK_ISSUE_S * 1e3
    o_ms = max(alu_ms, issue_ms)
    bound_ms, bound_by = (b_ms, "bytes") if b_ms >= o_ms else (
        o_ms, "operations")
    split = {k: v * 1e3 for k, v in run["stage_seconds"].items()}
    log(f"nvidia-smi: {smi_line()}")
    log(f"config 4 rebase: {n} pending ops over {m} trunk ops in "
        f"{run['seconds'] * 1e3:.3f} ms (host clock) = "
        f"{run['op_rebases_per_sec']:,.0f} op-rebases/s (repeats: "
        + ", ".join(f"{r:,.0f}" for r in repeats)
        + f"); kernel launches {launches}; digests and counts match "
        f"tree_golden.json ({counts['flagged']} flagged, "
        f"{counts['native_splits']} native splits, {counts['muted']} "
        f"muted)")
    log("  ms of the call (host clock): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    log(f"  rebase_batch per launch: {ms * 1e3:.3f} us (CUDA events behind "
        f"a spin, 50 launches), "
        + (f"{prof_ms * 1e3:.3f} us in the path (profiler, {prof_n} of "
           f"{REBASE_REPEATS} calls' launches seen)" if prof_n
           else "in the path not measured (no device time seen)")
        + f"; bounds: bytes {b_ms * 1e3:.3f} us ({nbytes} B), operations "
        f"{o_ms * 1e3:.3f} us, the larger of the ALU's {alu_ms * 1e3:.3f} "
        f"us ({alu_count} ALU-only int32 ops) and the issue's "
        f"{issue_ms * 1e3:.3f} us ({op_count} int32 ops, "
        f"{op_count / (n * m):.2f} per op-rebase, {all_kinds:.2f} a step "
        f"for a warp of all three kinds; base codes "
        + ", ".join(f"{c} {int((codes == c).sum())}" for c in REBASE_OPS)
        + "; pending kinds "
        + ", ".join(f"{k} {nk}" for k, nk in kinds.items())
        + f"); share of the bound {bound_ms / ms:.4f} ({bound_by})")
    log(f"  grouping (computed, not read from the card): {trk.THREADS} "
        f"ops a block; by `warp_steps`, the kernel's partition rule, "
        f"{n_warps} warps by step: "
        + ", ".join(f"{k} {v}" for k, v in steps.items())
        + f", mixed-warp share {mixed_share:.4f}; instructions a step by "
        "the REBASE_OPS table: a warp of one kind "
        + ", ".join(f"{k} {v:.2f}" for k, v in uniform.items())
        + f", a mixed warp {all_kinds:.2f}, the grid's mean "
        f"{mean_step:.2f}")
    log(f"  per launch: {ms_no_window * 1e3:.3f} us over no base op (loads, "
        f"partition, stores), so {(ms - ms_no_window) * 1e3 / m:.4f} us a "
        "step over config 4's window; every pending op of one kind: "
        + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in ms_one_kind.items())
        + " (CUDA events behind a spin, 50 launches)")
    return dict(
        launches=launches,
        max_abs_err=max_err,
        ms=ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        bound_ms_bytes=b_ms,
        bound_ms_operations=o_ms,
        bound_ms_alu=alu_ms,
        bound_ms_issue=issue_ms,
        profiled_ms_per_launch=prof_ms,
        profiled_launches_seen=prof_n,
        path_launches={"config4_rebase": launches},
        call_ms=run["seconds"] * 1e3,
        call_split_ms=split,
        op_rebases_per_sec=run["op_rebases_per_sec"],
        op_rebases_per_sec_repeats=repeats,
        held_outputs=held,
        counts=counts,
        ms_no_window=ms_no_window,
        ms_one_kind=ms_one_kind,
    )


def scan_plain(table: dict, ops: dict):
    """The row-model scan's plain version on the CPU for one document's
    chunk (run in a worker process, one torch thread): (the output
    table's fields as numpy arrays, seconds by the host clock)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        apply_op_batch_ref,
    )

    torch.set_num_threads(1)
    t = interop.segment_table_from_numpy(table, "cpu")
    o = interop.opbatch_from_numpy(ops, "cpu")
    t0 = time.perf_counter()
    out = apply_op_batch_ref(t, o)
    return interop.segment_table_to_numpy(out), time.perf_counter() - t0


def replica_on_cpu(records: list, chunk: int, capacity: int):
    """`KernelReplica(device="cpu")` over one document's records as
    messages (run in a worker process): (text, spans, error word)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from fluidframework_tpu_torch.core.kernel_replica import KernelReplica
    from fluidframework_tpu_torch.testing.fold_streams import as_messages

    torch.set_num_threads(1)
    rep = KernelReplica(chunk_size=chunk, capacity=capacity, device="cpu")
    rep.apply_messages(as_messages(records))
    return rep.get_text(), rep.annotated_spans(), int(rep.table.error)


def prop_runs(spans) -> list:
    """Annotated spans with adjacent equal-prop spans merged: the form in
    which two engines that split rows differently agree."""
    out = []
    for seg, props in spans:
        if out and out[-1][1] == props:
            out[-1][0] += seg
        else:
            out.append([seg, props])
    return out


def _stacked(x):
    """One document's table or ops with a leading [1] axis."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as tmk

    if isinstance(x, tmk.SegmentTable):
        return tmk.stack_segment_tables([x])
    return tmk.stack_op_batches([x])


def cut_docs(x, n: int):
    """The first n documents of a stacked table or op batch (views)."""
    return type(x)(*(getattr(x, f.name)[:n] for f in dataclasses.fields(x)))


def record_fold_launches(streams: dict, step: int, dev):
    """`run_fold_sweep(backend="kernel")` over `streams` on `dev`,
    keeping each scan launch's stacked (tables, ops, output): returns
    (the launches in order, the sweep's result)."""
    from fluidframework_tpu_torch.server import summary_fold as sf
    from fluidframework_tpu_torch.testing import fold_streams as fs

    launches = []
    real_docs, real_one = sf.apply_op_batch_docs, sf.apply_op_batch

    def rec_docs(tables, ops):
        out = real_docs(tables, ops)
        launches.append((tables, ops, out))
        return out

    def rec_one(table, ops):
        out = real_one(table, ops)
        launches.append(tuple(_stacked(x) for x in (table, ops, out)))
        return out

    sf.apply_op_batch_docs, sf.apply_op_batch = rec_docs, rec_one
    try:
        warm = fs.run_fold_sweep(streams, step, dev, backend="kernel")
    finally:
        sf.apply_op_batch_docs, sf.apply_op_batch = real_docs, real_one
    return launches, warm


def record_replica_launches(records: list, dev) -> list:
    """`KernelReplica` (chunks of REPLICA_CHUNK, capacity
    REPLICA_CAPACITY) over one document's records as messages on `dev`,
    keeping each scan launch's stacked (table, ops, output)."""
    from fluidframework_tpu_torch.core import kernel_replica as kr
    from fluidframework_tpu_torch.testing.fold_streams import as_messages

    launches = []
    real = kr.apply_op_batch

    def rec(table, ops):
        out = real(table, ops)
        launches.append(tuple(_stacked(x) for x in (table, ops, out)))
        return out

    kr.apply_op_batch = rec
    try:
        rep = kr.KernelReplica(chunk_size=REPLICA_CHUNK,
                               capacity=REPLICA_CAPACITY, device=dev)
        rep.apply_messages(as_messages(records))
    finally:
        kr.apply_op_batch = real
    return launches


def scan_variants(ops) -> dict:
    """The timed variants of one launch's ops (the op columns of the
    other kinds set to NOOP in place): ``noop`` (the tables' copies in
    and out alone), and ``insert``, ``remove`` and ``annotate``, each
    kind alone."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as tmk

    noop = torch.full_like(ops.op_type, tmk.OP_NOOP)
    out = {"noop": dataclasses.replace(ops, op_type=noop)}
    for name, k in SCAN_KINDS:
        out[name] = dataclasses.replace(
            ops, op_type=torch.where(ops.op_type == k, ops.op_type, noop))
    return out


def replica_timed_launches(records: list, dev) -> dict:
    """KernelReplica's launches of SCAN_REPLICA_LAUNCHES over one
    document's records on `dev`, by name: stacked (table, ops, output),
    each checked to be at its capacity with chunks of REPLICA_CHUNK."""
    rec = record_replica_launches(records, dev)
    out = {}
    for name, (k, C) in SCAN_REPLICA_LAUNCHES.items():
        t, o, got = rec[k]
        if (t.length.shape[1], o.op_type.shape[1]) != (C, REPLICA_CHUNK):
            raise AssertionError(f"KernelReplica's launch {k} is at C "
                                 f"{t.length.shape[1]}, B "
                                 f"{o.op_type.shape[1]}; {name} expected "
                                 f"C {C}, B {REPLICA_CHUNK}")
        out[name] = (t, o, got)
    return out


def scan_part_times(launch, fold, extra: dict,
                    reps: int = SCAN_TIME_REPS) -> dict:
    """The scan's parts by CUDA events behind a spin (`spin_time`), for
    `launch(tables, ops)`: ms a launch of `fold` (a stacked (tables,
    ops) pair) as it is, of its all-NOOP variant and of each kind alone
    (`scan_variants`), and of each named (tables, ops) of `extra`; and
    us an op of each kind and of the mix, (ms - NOOP ms) over the most
    ops of that kind in one document (the launch lasts as long as its
    slowest block)."""
    tables, ops = fold
    t = ops.op_type
    out = {"fold_ms": spin_time(lambda: launch(tables, ops), reps)}
    for name, o in scan_variants(ops).items():
        out[f"{name}_ms"] = spin_time(lambda o=o: launch(tables, o), reps)
    for name, (tt, oo) in extra.items():
        out[f"{name}_ms"] = spin_time(lambda tt=tt, oo=oo: launch(tt, oo),
                                      reps)
    us = {}
    for name, k in SCAN_KINDS + (("mix", None),):
        live = (t != OP_NOOP_CODE) if k is None else (t == k)
        most = int(live.sum(1).max())
        ms = out["fold_ms" if k is None else f"{name}_ms"]
        us[name] = (ms - out["noop_ms"]) * 1e3 / most if most else None
    out["us_per_op"] = us
    return out


def scan_phases(dev, log, overlay_runs=None) -> dict:
    """Phases 22-25, the row-model scan (`csrc/mergetree_scan.cu`) and
    its paths, on `dev`: the kernel against its plain version (on CPU
    copies of the same inputs, in worker processes, exactly), the
    summary folder and the fold sweep on the ``kernel`` backend gated on
    fold_golden.json, and `KernelReplica` on the card against its CPU
    run and the overlay message replica. `overlay_runs` are phase 15's
    fold runs (the ratio's denominator); without them the overlay sweep
    runs here. Raises on any mismatch; returns what the kernels line
    reports."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.core.kernel_replica import KernelReplica
    from fluidframework_tpu_torch.core.overlay_replay import (
        OverlayKernelMessageReplica,
    )
    from fluidframework_tpu_torch.ops import mergetree_kernel as tmk
    from fluidframework_tpu_torch.ops.mergetree_scan import (
        mergetree_scan_kernel as kernel,
        scan_geometry,
    )
    from fluidframework_tpu_torch.server import summary_fold as sf
    from fluidframework_tpu_torch.testing import fold_streams as fs
    from fluidframework_tpu_torch.testing.scan_edges import scan_edge_chunks

    t22 = time.perf_counter()
    golden = fs.load_fold_golden()
    step = golden["params"]["summary_ops"]
    streams = fs.golden_streams(golden, max(FOLD_DOCS))
    docs = list(streams)
    want = {d["doc"]: d["rows_sha256"] for d in golden["docs"]}
    n_rounds = len(want[docs[0]])
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    # Phase 25's CPU runs, started first so that they overlap the card.
    f_rep = [pool.submit(replica_on_cpu, streams[d], REPLICA_CHUNK,
                         REPLICA_CAPACITY) for d in docs[:MSG_DOCS]]

    # ---- 22. the scan kernel vs its plain version -----------------------
    pending = []  # (label, future, the card's output of that document)

    def hold(tables, ops, out, label, which=None):
        t_np = interop.segment_table_to_numpy(tables)
        o_np = interop.opbatch_to_numpy(ops)
        g_np = interop.segment_table_to_numpy(out)
        for d in range(t_np["n_rows"].shape[0]) if which is None else which:
            pending.append((f"{label} doc {d}", pool.submit(
                scan_plain, {k: v[d] for k, v in t_np.items()},
                {k: v[d] for k, v in o_np.items()}),
                {k: v[d] for k, v in g_np.items()}))

    def settle() -> tuple:
        """Waits for every held document; returns (pairs, max |card -
        plain| over the compared fields, plain seconds by label)."""
        err, secs = 0, {}
        for label, fut, got in pending:
            plain, s = fut.result()
            secs[label] = s
            n = int(plain["n_rows"])
            if (int(got["n_rows"]), int(got["error"])) != (
                    n, int(plain["error"])):
                raise AssertionError(
                    f"scan {label}: n_rows / error {int(got['n_rows'])} / "
                    f"{int(got['error'])} != plain {n} / "
                    f"{int(plain['error'])}")
            m = min(n, plain["length"].shape[0])
            for f in SCAN_COLS:
                diff = np.abs(got[f][:m].astype(np.int64)
                              - plain[f][:m].astype(np.int64))
                err = max(err, int(diff.max()) if diff.size else 0)
            if err:
                raise AssertionError(f"scan {label}: rows differ from the "
                                     f"plain version (max |diff| {err})")
        n = len(pending)
        pending.clear()
        return n, err, secs

    # The edge chunks, each alone and all of one chunk size stacked.
    edge_flags = 0
    for C in SCAN_EDGE_CAPACITIES:
        cases = scan_edge_chunks(C, 4, 8, 4, FOLD_CHUNK)
        for case in cases:
            t = interop.segment_table_from_numpy(case["table"], dev)
            o = interop.opbatch_from_numpy(case["ops"], dev)
            out = kernel(t, o)
            edge_flags |= int(out.error)
            hold(tmk.stack_segment_tables([t]), tmk.stack_op_batches([o]),
                 tmk.stack_segment_tables([out]), f"C {C} {case['label']}")
        same_b = [c for c in cases if c["ops"]["op_type"].shape[0]
                  == FOLD_CHUNK]
        t = interop.segment_table_from_numpy({k: np.stack(
            [c["table"][k] for c in same_b]) for k in same_b[0]["table"]}, dev)
        o = interop.opbatch_from_numpy({k: np.stack(
            [c["ops"][k] for c in same_b]) for k in same_b[0]["ops"]}, dev)
        hold(t, o, kernel.docs(t, o), f"C {C} edge chunks stacked")
    if edge_flags != tmk.ERR_CAPACITY | tmk.ERR_BAD_POS | tmk.ERR_REMOVERS:
        raise AssertionError(f"scan edge chunks flagged {edge_flags}")
    n_edge, _, _ = settle()

    # The fold's own launches: a warm-up sweep of the kernel backend at
    # D = 132 (untimed) keeps each launch's stacked inputs and output.
    launches_rec, warm = record_fold_launches(streams, step, dev)
    torch.cuda.synchronize()
    first = np.cumsum([0] + [r["chunks"] for r in warm["rounds"]])
    if first[-1] != len(launches_rec):
        raise AssertionError(f"fold warm-up: {len(launches_rec)} launches "
                             f"!= the rounds' chunks {first[-1]}")
    held_rounds = (0, SCAN_TIMED_ROUND, n_rounds - 1)
    caps = set()
    for r in held_rounds:
        for k in range(first[r], first[r + 1]):
            tables, ops, out = launches_rec[k]
            C = tables.length.shape[1]
            caps.add(C)
            which = range(min(FOLD_LATE_DOCS, tables.length.shape[0]))
            if (r, k) == (SCAN_TIMED_ROUND, first[r]):
                which = None  # every document of the timed launch
            hold(tables, ops, out, f"fold round {r} launch {k} C {C}",
                 which)
    n_fold, max_err, secs = settle()
    timed_tables, timed_ops, _ = launches_rec[first[SCAN_TIMED_ROUND]]
    D = timed_tables.length.shape[0]
    plain_ms = 1e3 * sum(s for lab, s in secs.items()
                         if lab.startswith(f"fold round {SCAN_TIMED_ROUND} "
                                           f"launch {first[SCAN_TIMED_ROUND]} "))
    if sorted(caps) != [512, 1024, 2048] or D != max(FOLD_DOCS):
        raise AssertionError(f"fold launches held at capacities "
                             f"{sorted(caps)} and D {D}")
    log(f"mergetree_scan == plain on {n_edge + n_fold} (document, chunk) "
        f"pairs, exactly: the {len(cases)} edge chunks at C "
        f"{SCAN_EDGE_CAPACITIES} alone and stacked, and the D = "
        f"{max(FOLD_DOCS)} fold's launches of rounds {held_rounds} (C "
        f"{sorted(caps)}; {FOLD_LATE_DOCS} documents each, all {D} on "
        f"round {SCAN_TIMED_ROUND}'s first)")

    def bound(tables, ops, n_out):
        """Least time for one launch's work: each document's live rows
        in (min(C, n_rows)), its live rows out (min(C, n_out), `n_out`
        the launch's output n_rows), its n_rows and error word in and
        out and its ops in, once, over the HBM rate (the rows above are
        scratch, read and written by no one), against SCAN_OPS_PER_PASS
        int32 operations per live row for each op but NOOPs (one pass
        an op) over the ALU rate, live rows taken at the chunk's
        start."""
        Dn, C = tables.length.shape
        KR, KK = tables.rem_clients.shape[2], tables.props.shape[2]
        B, PK = ops.prop_keys.shape[1:]
        live = torch.clamp(tables.n_rows, 0, C).to(torch.int64)
        live_out = torch.clamp(n_out, 0, C).to(torch.int64)
        rows = int(live.sum()) + int(live_out.sum())
        nbytes = 4 * (rows * (5 + KR + KK) + Dn * (4 + B * (8 + 2 * PK)))
        t = ops.op_type
        passes = ((t == tmk.OP_INSERT) | (t == tmk.OP_REMOVE)
                  | (t == tmk.OP_ANNOTATE)).to(torch.int64)
        n_int = int((passes.sum(1) * live).sum()) * SCAN_OPS_PER_PASS
        b_s, o_s = nbytes / PEAK_BYTES_S, n_int / PEAK_OPS_S
        return max(b_s, o_s) * 1e3, "bytes" if b_s >= o_s else "operations"

    def geometry(tables, ops):
        """One launch's op loops as the card's blocks report them
        (`last_geometry`): ((rows a thread min, max), (warps min, max)),
        and the launch's output."""
        out = kernel.docs(tables, ops)
        g = kernel.last_geometry.cpu()
        return ((int(g[:, 0].min()), int(g[:, 0].max())),
                (int(g[:, 1].min()), int(g[:, 1].max()))), out

    def cut(tables, C):
        """The stacked tables' first C rows (rows at and above n_rows
        are scratch)."""
        return tmk.SegmentTable(*(
            a[:, :C].contiguous() if a.dim() > 1 else a
            for a in (getattr(tables, f.name)
                      for f in dataclasses.fields(tmk.SegmentTable))))

    # Per launch at the fold's shape: C 512 on round 0's first launch
    # (empty tables), C 1024 and 2048 on round SCAN_TIMED_ROUND's first
    # (hundreds of live rows); D = 132 and doc 0 alone.
    times = {}
    r0_tables, r0_ops, _ = launches_rec[0]
    for C, (tab, ops) in ((512, (r0_tables, r0_ops)),
                          (1024, (timed_tables, timed_ops)),
                          (2048, (timed_tables, timed_ops))):
        if tab.length.shape[1] > C:
            tab = cut(tab, C)
        if C > tab.length.shape[1]:
            raise AssertionError(f"no fold launch at C {C} to time")
        if int(tab.n_rows.max()) + 2 * ops.op_type.shape[1] > C:
            raise AssertionError(f"the timed tables do not fit C {C}")
        one = (tab.doc(0), ops.doc(0))
        loops, out = geometry(tab, ops)
        if C == 2048:
            timed_loops = loops
        for n_d, fn in ((tab.length.shape[0], lambda: kernel.docs(tab, ops)),
                        (1, lambda: kernel(*one))):
            ms = spin_time(fn, SCAN_TIME_REPS)
            sub = (tab, ops, out.n_rows) if n_d > 1 else (
                cut_docs(tab, 1), cut_docs(ops, 1), out.n_rows[:1])
            b_ms, b_by = bound(*sub)
            times[f"C{C}_D{n_d}"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
    head = times[f"C2048_D{D}"]
    geom = scan_geometry(2048, FOLD_CHUNK, 4, 4, 8)
    (rpt_lo, rpt_hi), (w_lo, w_hi) = timed_loops
    log(f"mergetree_scan per launch (CUDA events behind a spin, "
        f"{SCAN_TIME_REPS} launches; C 512 on round 0's first launch, 1024 "
        f"and 2048 on round {SCAN_TIMED_ROUND}'s; B {FOLD_CHUNK}, KR 4, KK "
        f"8, PK 4): "
        + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.6f}, "
                    f"{v['bound_by']})" for k, v in times.items())
        + f"; the plain version {plain_ms:.2f} ms for round "
        f"{SCAN_TIMED_ROUND}'s launch of {D} documents (CPU, one thread "
        f"a document, summed); at C 2048 the launcher's block (computed, "
        f"`scan_geometry`): {geom.threads} threads, hot columns {geom.hot}, "
        f"remover half {geom.removers}, props half {geom.props}, "
        f"{geom.smem} shared bytes; the blocks' op loops (read from the "
        f"card): {w_lo}-{w_hi} active warps at {rpt_lo}-{rpt_hi} rows a "
        f"thread on the timed launch ({int(timed_tables.n_rows.min())}"
        f"-{int(timed_tables.n_rows.max())} live rows); the share of the "
        f"bound at C 2048, D {D}: {head['bound_ms'] / head['ms']:.4f}; "
        f"phase 22 {time.perf_counter() - t22:.2f}s")
    # The parts: the timed C 2048 launch of all D documents as it is,
    # all NOOP and each kind alone, and KernelReplica's launches at C
    # 4096 and 8192 (B 512, one document); each variant held on
    # FOLD_PARTS_DOCS documents, the replica's launches whole.
    reps = replica_timed_launches(streams[docs[0]], dev)
    for name, (rt, ro, rg) in reps.items():
        hold(rt, ro, rg, name)
    for name, o in scan_variants(timed_ops).items():
        hold(timed_tables, o, kernel.docs(timed_tables, o),
             f"{name} variant", range(FOLD_PARTS_DOCS))
    n_parts, _, _ = settle()
    parts = scan_part_times(kernel.docs, (timed_tables, timed_ops),
                            {k: v[:2] for k, v in reps.items()})
    rep_loops = {}
    for name, (rt, ro, rg) in reps.items():
        parts[f"{name}_bound_ms"], _ = bound(rt, ro, rg.n_rows)
        rep_loops[name], _ = geometry(rt, ro)
    log(f"mergetree_scan parts at C 2048, D {D} (CUDA events behind a "
        f"spin; {n_parts} variant launches held exactly): as it is "
        f"{parts['fold_ms']:.4f} ms, all NOOP {parts['noop_ms']:.4f}, "
        f"inserts only {parts['insert_ms']:.4f}, removes only "
        f"{parts['remove_ms']:.4f}, annotates only "
        f"{parts['annotate_ms']:.4f}; us an op (over the most ops of the "
        f"kind in one document, NOOP launch taken off): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts["us_per_op"].items()
                    if v is not None)
        + "; KernelReplica's launches of doc 0 (B "
        f"{REPLICA_CHUNK}): " + ", ".join(
            f"{name} {parts[name + '_ms']:.4f} ms (bound "
            f"{parts[name + '_bound_ms']:.6f}, "
            f"{int(reps[name][0].n_rows[0])} live rows, "
            f"{rep_loops[name][0][0]} rows a thread on "
            f"{rep_loops[name][1][0]} warps, read from the card)"
            for name in reps))

    # ---- 23. the summary folder on the kernel backend ------------------
    folder = sf.SummaryFolder(summary_ops=step, device=dev,
                              fold_backend="kernel")
    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    manifests = []
    for lo in range(0, len(streams[docs[0]]), step):
        for d in docs[:FOLD_DOCS[0]]:
            for rec in streams[d][lo:lo + step]:
                folder.process(rec)
        manifests += folder.flush()
    torch.cuda.synchronize()
    t_folder = time.perf_counter() - t0
    launches_folder = kernel.launches
    got = {}
    for m in manifests:
        got.setdefault(m["doc"], []).append([m["seq"], m["count"],
                                             m["handle"]])
    if got != {d: golden["manifests"][d] for d in docs[:FOLD_DOCS[0]]} \
            or folder.frozen:
        raise AssertionError("summary folder (kernel backend): manifests "
                             "differ from the JAX summarizer role's")
    log(f"summary folder, kernel backend: {len(manifests)} summaries of "
        f"{FOLD_DOCS[0]} documents in {t_folder:.3f}s (scan launches "
        f"{launches_folder}, one per chunk and capacity group); seq, count "
        f"and handle of every manifest equal the JAX summarizer role's")

    # ---- 24. the fold sweep on the kernel backend, timed ----------------
    runs = []
    for D_run in FOLD_DOCS:
        sub = {d: streams[d] for d in docs[:D_run]}
        torch.cuda.synchronize()
        kernel.launches = 0
        out = fs.run_fold_sweep(sub, step, dev, backend="kernel")
        torch.cuda.synchronize()
        launches = kernel.launches
        rounds = out["rounds"]
        chunks = sum(r["chunks"] for r in rounds)
        if launches != chunks or any(r["chunks"] < r["steps"]
                                     for r in rounds):
            raise AssertionError(f"kernel fold D {D_run}: launches "
                                 f"{launches} != chunks {chunks}")
        for doc, dg in out["digests"].items():
            if dg != want[doc]:
                raise AssertionError(f"kernel fold D {D_run}: {doc} rows "
                                     f"differ from fold_golden.json")
        n_em = sum(r["emissions"] for r in rounds)
        per = {k: sum(r[k] for r in rounds) / len(rounds)
               for k in ("encode_s", "fold_s", "serialize_s")}
        dev_s = sum(r["device_ms"] for r in rounds) / 1e3 / len(rounds)
        over = None
        if overlay_runs is not None:
            over = next(r["seconds"] for r in overlay_runs if r["D"] == D_run)
        else:
            over = fs.run_fold_sweep(sub, step, dev)["seconds"]
        run = dict(D=D_run, seconds=out["seconds"], emissions=n_em,
                   rounds=len(rounds), launches=launches,
                   emissions_per_s=n_em / out["seconds"],
                   fold_ops_per_s=out["op_records"] / out["seconds"],
                   encode_s_per_round=per["encode_s"],
                   fold_s_per_round=per["fold_s"],
                   device_s_per_round=dev_s,
                   serialize_s_per_round=per["serialize_s"],
                   capacities=sorted({g["capacity"] for r in rounds
                                      for g in r["groups"]}),
                   overlay_seconds=over,
                   fold_backend_speedup=out["seconds"] / over)
        runs.append(run)
        n_whole = len(streams[docs[0]]) // step
        if D_run == FOLD_DOCS[0] and launches_folder != sum(
                r["chunks"] for r in rounds[:n_whole]):
            raise AssertionError(f"summary folder (kernel backend): "
                                 f"{launches_folder} launches, the sweep's "
                                 f"{n_whole} whole rounds took "
                                 f"{sum(r['chunks'] for r in rounds[:n_whole])}")
        log(f"kernel fold D {D_run}: {n_em} emissions ({len(rounds)} rounds) "
            f"in {out['seconds']:.3f}s = {run['emissions_per_s']:,.1f} "
            f"emissions/s, {run['fold_ops_per_s']:,.0f} fold ops/s; per "
            f"round: encode {per['encode_s']:.4f}s, fold "
            f"{per['fold_s']:.4f}s (device {dev_s:.4f}s, CUDA events around "
            f"the launches), serialization + reboot {per['serialize_s']:.4f}s; "
            f"scan launches {launches} (one per chunk and capacity group; "
            f"capacities {run['capacities']}); every digest equals "
            f"fold_golden.json; kernel / overlay time "
            f"{run['fold_backend_speedup']:.3f} (overlay {over:.3f}s)")

    # ---- 25. KernelReplica on the card vs its CPU run -------------------
    launches_rep, t_rep, n_rep = 0, 0.0, 0
    for d, f in zip(docs[:MSG_DOCS], f_rep):
        msgs = fs.as_messages(streams[d])
        rep = KernelReplica(chunk_size=REPLICA_CHUNK,
                            capacity=REPLICA_CAPACITY, device=dev)
        torch.cuda.synchronize()
        kernel.launches = 0
        t0 = time.perf_counter()
        rep.apply_messages(msgs)
        torch.cuda.synchronize()
        t_rep += time.perf_counter() - t0
        launches = kernel.launches
        n_ops = sum(1 for m in msgs if m.type.value == "op")
        if launches != -(-n_ops // REPLICA_CHUNK):
            raise AssertionError(f"kernel replica {d}: launches {launches} "
                                 f"!= chunks of {n_ops} ops")
        launches_rep += launches
        n_rep += n_ops
        card = (rep.get_text(), rep.annotated_spans(), int(rep.table.error))
        if card != f.result():
            raise AssertionError(f"kernel replica {d}: the card's text, spans "
                                 f"or error word differ from the CPU run's")
        ov = OverlayKernelMessageReplica(chunk_size=MSG_CHUNK,
                                         window=MSG_WINDOW, device=dev)
        ov.apply_messages(msgs)
        if (card[0], prop_runs(card[1])) != (
                ov.get_text(), prop_runs(ov.annotated_spans())) or card[2]:
            raise AssertionError(f"kernel replica {d}: text or spans differ "
                                 f"from the overlay message replica's")
    pool.shutdown()
    log(f"kernel replica: {MSG_DOCS} documents, {n_rep} ops (chunks of "
        f"{REPLICA_CHUNK}, capacity {REPLICA_CAPACITY} grown as needed) in "
        f"{t_rep:.3f}s = {n_rep / t_rep:,.0f} ops/s one document at a time "
        f"(scan launches {launches_rep}); text, spans and error word equal "
        f"the CPU run's and the overlay message replica's")
    b_ms, b_by = bound(timed_tables, timed_ops,
                       launches_rec[first[SCAN_TIMED_ROUND]][2].n_rows)
    return dict(
        launches=runs[-1]["launches"],
        max_abs_err=max_err,
        ms=head["ms"],
        plain_ms=plain_ms,
        bound_ms=b_ms,
        bound_by=b_by,
        path_launches={
            "summary_folder_kernel": launches_folder,
            "fold_kernel": {str(r["D"]): r["launches"] for r in runs},
            "kernel_replica": launches_rep,
        },
        times=times,
        parts=parts,
        us_per_op=parts["us_per_op"],
        rows_per_thread=[rpt_lo, rpt_hi],
        active_warps=[w_lo, w_hi],
        held_pairs=n_edge + n_fold,
        fold_kernel_runs=runs,
    )


def zamboni_plain(table: dict, min_seq: int):
    """The zamboni's plain version on the CPU for one table (run in a
    worker process, one torch thread): (the output table's fields as
    numpy arrays, seconds by the host clock)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.ops.zamboni import zamboni_device_ref

    torch.set_num_threads(1)
    t = interop.segment_table_from_numpy(table, "cpu")
    t0 = time.perf_counter()
    out = zamboni_device_ref(t, min_seq)
    return interop.segment_table_to_numpy(out), time.perf_counter() - t0


def scan_engine_replica(stream, initial_len: int, dev, **kw):
    """`ColumnarReplica(engine="scan")` at bench.py's scan geometry
    (`BENCH_ENGINE=scan`, bench.py:95-104): capacity ROW_CAPACITY,
    chunks of CHUNK, N_REMOVERS remover slots, N_PROP_KEYS prop keys."""
    from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica

    return ColumnarReplica(stream, initial_len=initial_len, chunk_size=CHUNK,
                           capacity=ROW_CAPACITY, n_removers=N_REMOVERS,
                           n_prop_keys=N_PROP_KEYS, engine="scan",
                           device=dev, **kw)


def scan_engine_run(stream, initial_len: int, dev, want, keep=None,
                    split: bool = False) -> dict:
    """One scan-engine replay of `stream` on `dev` (`scan_engine_replica`,
    watermark SCAN_ENGINE_WATERMARK) with the scan and zamboni kernels'
    launch counts set to 0 just before and read just after; raises
    unless the scan launches equal the chunks and the digest equals
    `want` (None: not gated). `keep`, a dict, gets the (table, ops,
    output) of the first and the last scan launch. With `split`, the
    replica's stages are wrapped from outside, the device synchronised
    around each, and their host-clock seconds returned as `stage_s`
    (SCAN_STAGES; compact()'s numpy work is its time less the pull and
    the push), with the scan launches' device time by CUDA events as
    `launch_device_s`."""
    import torch

    from fluidframework_tpu_torch.core import columnar_replay as cr
    from fluidframework_tpu_torch.ops.mergetree_scan import (
        mergetree_scan_kernel,
    )
    from fluidframework_tpu_torch.ops.zamboni_kernel import zamboni_kernel
    from fluidframework_tpu_torch.testing.digest import state_digest

    rep = scan_engine_replica(stream, initial_len, dev,
                              compact_watermark=SCAN_ENGINE_WATERMARK)
    real_launch, real_push = cr.apply_op_batch, cr._device_table
    stage_s = dict.fromkeys(SCAN_STAGES, 0.0)
    events = []

    def staged(name, fn):
        def run(*args):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize(dev)
            stage_s[name] += time.perf_counter() - t0
            return out
        return run

    def launch(table, ops):
        if split:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out = real_launch(table, ops)
        if split:
            ev[1].record()
            events.append(ev)
        if keep is not None:
            keep.setdefault("first", (table, ops, out))
            keep["last"] = (table, ops, out)
        return out

    wrapped = ("chunk_ops", "_host_table", "compact")
    if split:
        rep.chunk_ops = staged("upload", rep.chunk_ops)
        rep._host_table = staged("compact_pull", rep._host_table)
        rep.compact = staged("compact", rep.compact)
        cr._device_table = staged("compact_push", real_push)
    cr.apply_op_batch = staged("launch", launch) if split else launch
    torch.cuda.synchronize()
    mergetree_scan_kernel.launches = 0
    zamboni_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        rep.replay()
    finally:
        cr.apply_op_batch, cr._device_table = real_launch, real_push
        for name in wrapped:
            rep.__dict__.pop(name, None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, z_launches = mergetree_scan_kernel.launches, zamboni_kernel.launches
    rep.check_errors()
    if launches != rep.n_chunks:
        raise AssertionError(f"scan engine: {launches} scan launches != "
                             f"{rep.n_chunks} chunks")
    digest = state_digest(rep.annotated_spans())
    if want is not None and digest != want:
        raise AssertionError(f"scan engine digest {digest} != GOLDEN.json "
                             f"{want}")
    out = dict(ops=len(stream), seconds=seconds,
               ops_per_s=len(stream) / seconds, launches=launches,
               zamboni_launches=z_launches, compactions=rep.compactions,
               capacity=rep.capacity, n_rows=int(rep.table.n_rows),
               digest=digest, replica=rep)
    if split:
        stage_s["compact_numpy"] = (stage_s.pop("compact")
                                    - stage_s["compact_pull"]
                                    - stage_s["compact_push"])
        out["stage_s"] = stage_s
        out["launch_device_s"] = sum(a.elapsed_time(b)
                                     for a, b in events) / 1e3
    return out


def row_scan_phases(dev, log, full=None, golden=None) -> tuple:
    """Phases 26-27, the zamboni kernel (`csrc/zamboni.cu`) and the row
    model's scan engine on `dev`: the kernel against its plain version
    (on CPU copies, in worker processes, exactly, on the whole table)
    and timed; the scan engine at bench.py's scan geometry on the
    SCAN_ENGINE_OPS headline prefix, gated on GOLDEN.json, with the scan
    kernel held against its plain version on its first and last chunk.
    `full` is the 1M headline stream (generated here when None). Raises
    on any mismatch; returns (the zamboni's kernels entry, the scan
    engine's numbers for the scan's entry)."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch import interop
    from fluidframework_tpu_torch.ops import mergetree_kernel as tmk
    from fluidframework_tpu_torch.ops.zamboni import zamboni_device
    from fluidframework_tpu_torch.ops.zamboni_kernel import zamboni_kernel
    from fluidframework_tpu_torch.testing.golden import (
        golden_digest, headline_stream, load_golden, stream_prefix,
    )
    from fluidframework_tpu_torch.testing.zamboni_edges import (
        zamboni_edge_tables,
    )

    t26 = time.perf_counter()
    golden = golden or load_golden()
    full = full if full is not None else headline_stream(golden)
    initial_len = golden["params"]["initial_len"]
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))

    # ---- 26. the zamboni kernel vs its plain version --------------------
    rep = scan_engine_replica(stream_prefix(full, ZAMBONI_OPS), initial_len,
                              dev, compact_watermark=1.1)
    rep.replay()
    rep.check_errors()
    if rep.compactions or rep.capacity != ROW_CAPACITY:
        raise AssertionError("phase 26's scan replica compacted or grew")
    msn = rep._applied_min_seq
    replay_np = interop.segment_table_to_numpy(rep.table)
    tables = [(f"{ZAMBONI_OPS // 1000}k scan replica, MSN {msn}", replay_np,
               msn),
              (f"{ZAMBONI_OPS // 1000}k scan replica, MSN 0", replay_np, 0)]
    for C in ZAMBONI_EDGE_CAPACITIES:
        tables += [(f"C {C} {c['label']}", c["table"], c["min_seq"])
                   for c in zamboni_edge_tables(C, N_REMOVERS, N_PROP_KEYS)]
    zamboni_kernel.launches = 0
    held = []
    for label, table, m in tables:
        got = zamboni_device(interop.segment_table_from_numpy(table, dev), m)
        held.append((label, pool.submit(zamboni_plain, table, m),
                     interop.segment_table_to_numpy(got)))
    smoke_launches = zamboni_kernel.launches
    plain_s, max_err = None, 0
    for label, fut, got in held:
        want, secs = fut.result()
        if plain_s is None:  # the replica's table at its last MSN
            plain_s, runs = secs, int(want["n_rows"])
        for f in want:
            diff = np.abs(got[f].astype(np.int64) - want[f].astype(np.int64))
            max_err = max(max_err, int(diff.max()) if diff.size else 0)
            if max_err:
                raise AssertionError(f"zamboni {label}: {f} differs from the "
                                     f"plain version (max |diff| {max_err})")
    text = rep.get_text()
    n_before = int(rep.table.n_rows)
    msn_dev = torch.tensor(msn, dtype=torch.int32, device=dev)
    ms = spin_time(lambda: zamboni_kernel(rep.table, msn_dev), SCAN_TIME_REPS)
    rep.table = zamboni_device(rep.table, msn_dev)
    n_after = int(rep.table.n_rows)
    if rep.get_text() != text or n_after > n_before:
        raise AssertionError("zamboni on the scan replica changed its text "
                             "or added rows")
    # The bound counts what this table needs: rem_seq of every live row
    # (the keep test), buf_start, length, ins_seq and the props of the
    # kept rows (the merge test), ins_client and the removers of the
    # run firsts alone, all C rows written, and n_rows, error and the
    # MSN in, n_rows and error out. `runs` is the plain version's n_rows.
    C, KR, KK = ROW_CAPACITY, N_REMOVERS, N_PROP_KEYS
    live = min(n_before, C)
    cols = 5 + KR + KK
    rem = replay_np["rem_seq"][:live]
    kept = int(np.count_nonzero((rem == tmk.NOT_REMOVED) | (rem > msn)))
    if runs != n_after:
        raise AssertionError(f"zamboni on the scan replica: {n_after} rows, "
                             f"the plain version {runs}")
    b_s = 4 * (live + kept * (3 + KK) + runs * (1 + KR) + C * cols
               + 5) / PEAK_BYTES_S
    o_s = (ZAMBONI_OPS_LIVE * live + (ZAMBONI_OPS_KEPT + KK) * kept
           + ZAMBONI_OPS_RUN * runs + C * cols) / PEAK_OPS_S
    b_ms = max(b_s, o_s) * 1e3
    b_by = "bytes" if b_s >= o_s else "operations"
    log(f"zamboni == plain on {len(held)} tables, exactly (every field of "
        f"the whole table, n_rows, error): the {ZAMBONI_OPS}-op scan replica's "
        f"table (C {C}, KR {KR}, KK {KK}, {n_before} live rows, no host "
        f"compaction) at MSN {msn} and 0, and the edge tables at C "
        f"{ZAMBONI_EDGE_CAPACITIES}; on the replica: {n_before} -> {n_after} "
        f"rows, the text unchanged")
    log(f"zamboni per call ({zamboni_kernel.LAUNCHES} launches; CUDA events "
        f"behind a "
        f"spin, "
        f"{SCAN_TIME_REPS} calls) on the {ZAMBONI_OPS}-op table: {ms:.4f} ms "
        f"(bound {b_ms:.6f}, {b_by}: {live} live rows, {kept} kept, "
        f"{runs} runs in ({n_before} -> {n_after} rows), {C} rows out; "
        f"share {b_ms / ms:.4f}); the plain version {plain_s * 1e3:.2f} ms "
        f"(CPU, one thread); phase 26 {time.perf_counter() - t26:.2f}s")

    # ---- 27. the scan engine at bench.py's scan geometry -----------------
    t27 = time.perf_counter()
    stream = stream_prefix(full, SCAN_ENGINE_OPS)
    want = golden_digest(golden, SCAN_ENGINE_OPS)
    keep = {}
    run = scan_engine_run(stream, initial_len, dev, want, keep=keep)
    holds = []
    for name in ("first", "last"):
        t, o, got = keep[name]
        holds.append((name, pool.submit(
            scan_plain, interop.segment_table_to_numpy(t),
            interop.opbatch_to_numpy(o)), interop.segment_table_to_numpy(got),
            int(t.n_rows)))
    split = scan_engine_run(stream, initial_len, dev, want, split=True)
    for name, fut, got, n_in in holds:
        want_t, _ = fut.result()
        n = int(want_t["n_rows"])
        if (int(got["n_rows"]), int(got["error"])) != (
                n, int(want_t["error"])):
            raise AssertionError(f"scan engine's {name} chunk: n_rows / error "
                                 f"differ from the plain version")
        m = min(n, ROW_CAPACITY)
        for f in SCAN_COLS:
            if not np.array_equal(got[f][:m], want_t[f][:m]):
                raise AssertionError(f"scan engine's {name} chunk: {f} "
                                     f"differs from the plain version")
    pool.shutdown()
    st = split["stage_s"]
    log(f"scan engine (bench.py BENCH_ENGINE=scan: capacity {ROW_CAPACITY}, "
        f"chunks of {CHUNK}, KR {N_REMOVERS}, KK {N_PROP_KEYS}, watermark "
        f"{SCAN_ENGINE_WATERMARK}): {SCAN_ENGINE_OPS} ops in "
        f"{run['seconds']:.3f}s = {run['ops_per_s']:,.0f} ops/s (host clock; "
        f"scan launches {run['launches']} = the chunks, zamboni launches "
        f"{run['zamboni_launches']}); {run['compactions']} host compactions, "
        f"final capacity {run['capacity']}, {run['n_rows']} live rows; digest "
        f"{run['digest'][:8]}, GOLDEN.json's at {SCAN_ENGINE_OPS}; the scan "
        f"kernel == plain "
        f"exactly on the first chunk ({holds[0][3]} rows in) and the last "
        f"({holds[1][3]} rows in)")
    log(f"scan engine split (a second, timed run: the device synchronised "
        f"between stages; {split['seconds']:.3f}s): uploads "
        f"{st['upload']:.3f}s, scan launches {split['launch_device_s']:.3f}s "
        f"on the card (CUDA events; the launch calls {st['launch']:.3f}s on "
        f"the host), compact() pull {st['compact_pull']:.3f}s, numpy "
        f"{st['compact_numpy']:.3f}s, push {st['compact_push']:.3f}s; "
        f"phase 27 {time.perf_counter() - t27:.2f}s")
    zamboni = dict(
        launches=run["zamboni_launches"],
        max_abs_err=max_err,
        ms=ms,
        plain_ms=plain_s * 1e3,
        plain_on="cpu",
        bound_ms=b_ms,
        bound_by=b_by,
        path_launches={"scan_engine": run["zamboni_launches"],
                       "smoke": smoke_launches},
        held_tables=len(held),
    )
    engine = {k: v for k, v in run.items() if k not in ("replica", "digest")}
    engine["split"] = dict(st, launch_device_s=split["launch_device_s"],
                           seconds=split["seconds"])
    return zamboni, engine


def deli_role_phases(dev, log) -> dict:
    """Phase 28, the supervised deli, on `dev`: BASELINE config 5's
    raw topic (columnar, frames of 16384) through `KernelDeliRole`
    stepped until drained, gated on deli_role_golden.json (the deltas
    digest and counts, the final checkpoint's digest); a crash after
    ROLE_CRASH_STEPS steps taken over by a new owner, gated the same
    way, with the successor's first ROLE_HELD_CHUNKS chunks held
    against the plain sequencer on CPU copies; the JSON-topic form on
    the first 4 pumps' records against the prefix digest. The topics
    live in a temporary directory that is removed afterwards. Raises on
    any mismatch; returns what the kernels line reports."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fluidframework_tpu_torch.ops import sequencer_kernel as tsk
    from fluidframework_tpu_torch.server import deli_kernel as tdk
    from fluidframework_tpu_torch.server import supervisor as tsup
    from fluidframework_tpu_torch.server.columnar_log import (
        make_tail_reader, make_topic,
    )
    from fluidframework_tpu_torch.testing import deli_streams as ds

    kernel = tsk.sequencer_step_kernel
    cuda = dev.type == "cuda"
    with open(os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                           "deli_role_golden.json")) as f:
        golden = json.load(f)
    p = golden["params"]
    batch, frame = p["batch"], p["frame"]
    prefix = p["prefix_pumps"] * frame
    t0 = time.perf_counter()
    recs = ds.build_pipeline_workload(p["n_docs"], p["n_clients"],
                                      p["ops_per_client"], seed=p["seed"])
    log(f"deli role: {len(recs)} raw records built in "
        f"{time.perf_counter() - t0:.2f}s; batch {batch}, frames of "
        f"{frame}")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def make_role(shared, owner, fmt):
        return tdk.KernelDeliRole(shared, owner=owner, ttl_s=3600.0,
                                  batch=batch, log_format=fmt, device=dev)

    def drive(role, max_steps=None) -> dict:
        """`step()` until a step moves nothing (or `max_steps`), each
        ROLE_STAGES stage wrapped from outside the role: the tail
        reader's polls, `flush_batch`, the fenced output append and the
        checkpoint; "other" is the rest of the steps (lease, heartbeat,
        the idle wait)."""
        stage = dict.fromkeys(ROLE_STAGES, 0.0)

        def timed(fn, key):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    stage[key] += time.perf_counter() - t
            return run

        make_reader = tsup.make_tail_reader

        def reader(topic, offset):
            r = make_reader(topic, offset)
            for name in ("poll", "poll_batches"):
                if hasattr(r, name):
                    setattr(r, name, timed(getattr(r, name), "poll_parse"))
            return r

        role.flush_batch = timed(role.flush_batch, "flush")
        role._append_outputs = timed(role._append_outputs, "append")
        role.checkpoint = timed(role.checkpoint, "checkpoint")
        tsup.make_tail_reader = reader
        steps = pumps = moved = 0
        t = time.perf_counter()
        try:
            while max_steps is None or steps < max_steps:
                n = role.step()
                steps += 1
                if not n:
                    break
                pumps += 1
                moved += n
            sync()
        finally:
            tsup.make_tail_reader = make_reader
        wall = time.perf_counter() - t
        stage["other"] = wall - sum(stage.values())
        return dict(steps=steps, pumps=pumps, records=moved, wall_s=wall,
                    stage_s=stage)

    def digest_of(shared, fmt) -> "ds.RoleDigest":
        dg = ds.RoleDigest(prefix_off=prefix)
        reader = make_tail_reader(make_topic(
            os.path.join(shared, "topics", "deltas.jsonl"), fmt), 0)
        while True:
            got = reader.poll(frame)
            if not got:
                return dg
            dg.update(r for _, r in got)

    def gate(role, shared, label):
        dg = digest_of(shared, "columnar")
        cp = ds.checkpoint_digest({"offset": role.offset,
                                   "docs": role.snapshot_state()})
        if (dg.hexdigest(), dg.counts, cp) != (
                golden["deltas_sha256"], golden["counts"],
                golden["checkpoint_sha256"]):
            raise AssertionError(
                f"{label}: deltas {dg.hexdigest()} {dg.counts}, checkpoint "
                f"{cp} differ from deli_role_golden.json")
        return dg

    held = {"chunks": 0, "max_abs_err": 0}
    run_chunk = tdk.SeqPool.run_chunk

    def holding(pool, kind, client, cseq, ref, groups, dedup, aborted=None):
        """`SeqPool.run_chunk` with the first ROLE_HELD_CHUNKS chunks
        held against the plain sequencer on CPU copies, exactly."""
        if not cuda or held["chunks"] >= ROLE_HELD_CHUNKS:
            return run_chunk(pool, kind, client, cseq, ref, groups, dedup,
                             aborted)
        if aborted is None:
            aborted = tsk.no_aborts(pool.n_docs, pool.device)
        st_in, ab_in = pool.state, aborted
        res, ab = run_chunk(pool, kind, client, cseq, ref, groups, dedup,
                            aborted)
        sync()
        want = tsk.sequence_batch_ref(
            tsk.SequencerState(*(t.cpu() for t in st_in)), ab_in.cpu(),
            tsk.SeqBatch(*(torch.from_numpy(c)
                           for c in (kind, client, cseq, ref))),
            torch.from_numpy(groups), dedup)
        pairs = [*zip(tsk.SequencerState._fields, pool.state, want[0]),
                 ("aborted", ab, want[1]),
                 *zip(tsk.SeqResult._fields, res, want[2])]
        for name, a, b in pairs:
            a = torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a)
                                           else a))
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"role chunk: {name} is {a.dtype} "
                                     f"{tuple(a.shape)}, plain {b.dtype} "
                                     f"{tuple(b.shape)}")
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
                if a.numel() else 0
            held["max_abs_err"] = max(held["max_abs_err"], diff)
            if diff:
                raise AssertionError(f"role chunk {held['chunks']}: {name} "
                                     f"differs from the plain version by "
                                     f"{diff}")
        held["chunks"] += 1
        return res, ab

    t28 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-deli-role-") as tmp:
        # ---- (a) the main path: columnar topics at both ends --------
        shared = os.path.join(tmp, "main")
        t0 = time.perf_counter()
        ds.write_raw_topic(shared, recs, frame, "columnar")
        t_write = time.perf_counter() - t0
        role = make_role(shared, "smoke-main", "columnar")
        role.core.pool.times = tdk.new_times()
        ck0 = role._m_ckpt_writes.value
        sync()
        kernel.launches = 0
        run = drive(role)
        launches = kernel.launches
        pool = role.core.pool
        if run["records"] != len(recs) or pool.chunks != p["steps"] \
                or run["pumps"] != p["steps"] or (
                cuda and launches != pool.chunks):
            raise AssertionError(
                f"deli role: {run['records']} records, {pool.chunks} "
                f"chunks, {launches} launches")
        times = pool.times
        planned = dict(role.planned)
        ckpt_writes = int(role._m_ckpt_writes.value - ck0)
        gate(role, shared, "deli role")
        del role, pool
        log(f"deli role main path: {len(recs)} records in {run['steps']} "
            f"steps in {run['wall_s']:.3f}s = "
            f"{len(recs) / run['wall_s']:,.0f} records/s (host clock; raw "
            f"topic written in {t_write:.2f}s, set-up); sequencer launches "
            f"{launches} = chunks; planned per record "
            f"{planned['record']}, as runs {planned['run']}; "
            f"{ckpt_writes} checkpoints; deltas ({golden['counts']}) and "
            f"checkpoint digests match deli_role_golden.json")
        split = {k: v * 1e3 / run["pumps"] for k, v in
                 run["stage_s"].items()}
        pool_split = {k.rsplit("_", 1)[0]: v * 1e3 / run["pumps"]
                      for k, v in times.items()}
        log(f"  ms per pump ({run['pumps']} steps that moved records; host "
            f"clock): " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items())
            + "; flush by SeqPool.times: " + ", ".join(
                f"{k} {v:.4f}" for k, v in pool_split.items()))

        # ---- (b) a crash and a new owner -----------------------------
        # on a copy of the main run's raw topic (its data file and
        # committed-length sidecar; not the doorbell FIFOs)
        topics = os.path.join(shared, "topics")
        shared = os.path.join(tmp, "crash")
        os.makedirs(os.path.join(shared, "topics"))
        for name in os.listdir(topics):
            src = os.path.join(topics, name)
            if name.startswith("rawdeltas.jsonl") and os.path.isfile(src):
                shutil.copyfile(src, os.path.join(shared, "topics", name))
        kernel.launches = 0
        first = make_role(shared, "smoke-g1", "columnar")
        crash = drive(first, max_steps=ROLE_CRASH_STEPS)
        env = first.ckpt.load(first.name)
        ckpt_off = env["state"]["offset"] if env else 0
        crashed_at, fence1 = first.offset, first.fence
        first.leases.release(first.name)
        del first
        tdk.SeqPool.run_chunk = holding
        try:
            second = make_role(shared, "smoke-g2", "columnar")
            rest = drive(second)
        finally:
            tdk.SeqPool.run_chunk = run_chunk
        launches_crash = kernel.launches
        if second.fence <= fence1 or (cuda and held["chunks"]
                                      != ROLE_HELD_CHUNKS):
            raise AssertionError(f"crash run: fence {second.fence} after "
                                 f"{fence1}, {held['chunks']} chunks held")
        gate(second, shared, "deli role crash run")
        del second
        log(f"deli role crash run: the first owner stopped after "
            f"{crash['steps']} steps at input offset {crashed_at} "
            f"(checkpoint at {ckpt_off}); the second owner recovered and "
            f"finished in {rest['steps']} steps ({rest['wall_s']:.3f}s); "
            f"sequencer launches {launches_crash}; {held['chunks']} of the "
            f"second owner's chunks exact against the plain version "
            f"(max_abs_err {held['max_abs_err']}); digests match "
            f"deli_role_golden.json")

        # ---- (c) JSON topics on the first pumps ----------------------
        shared = os.path.join(tmp, "json")
        ds.write_raw_topic(shared, recs[:prefix], frame, "json")
        role = make_role(shared, "smoke-json", "json")
        kernel.launches = 0
        js = drive(role)
        launches_json = kernel.launches
        dg = digest_of(shared, "json")
        want_counts = {"ops": prefix // 2, "joins": prefix // 2,
                       "leaves": 0, "nacks": 0}
        if (dg.hexdigest(), dg.counts) != (golden["prefix_sha256"],
                                           want_counts):
            raise AssertionError(f"deli role JSON prefix: {dg.hexdigest()} "
                                 f"{dg.counts} differ from "
                                 f"deli_role_golden.json's prefix")
        del role
        log(f"deli role JSON topics: {prefix} records in {js['steps']} "
            f"steps in {js['wall_s']:.3f}s = {prefix / js['wall_s']:,.0f} "
            f"records/s; sequencer launches {launches_json}; digest "
            f"matches the golden prefix; phase 28 "
            f"{time.perf_counter() - t28:.2f}s")
    return dict(
        launches=launches,
        launches_crash=launches_crash,
        launches_json=launches_json,
        max_abs_err=held["max_abs_err"],
        held_chunks=held["chunks"],
        records_per_s=len(recs) / run["wall_s"],
        json_records_per_s=prefix / js["wall_s"],
        pump_ms=split,
        flush_ms=pool_split,
        pumps=run["pumps"],
        checkpoints=ckpt_writes,
        planned=planned,
    )


def summary_round_plain(backend: str, inputs: list) -> tuple:
    """One emission round of the summarizer's fold through the plain
    versions on the CPU (run in a worker process, one torch thread):
    each ``(doc, rows, msn, records)`` of `inputs` booted from its
    canonical rows, its records encoded, all folded in one stacked
    call, as `SummaryEmitter._emit_round` folds them. Returns ({doc:
    its state, `summary_state`}, seconds by the host clock)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from fluidframework_tpu_torch.core.overlay_fold import (
        OverlayFoldReplica, boot_overlay, fold_jobs_overlay,
    )
    from fluidframework_tpu_torch.server import summary_fold as sf

    torch.set_num_threads(1)
    boot = boot_overlay if backend == "overlay" else sf._boot_mergetree
    jobs, docs = [], []
    for doc, rows, msn, take in inputs:
        rep = boot(rows, msn, device="cpu")
        sf._encode_fold(rep, take)
        jobs.append((rep, take))
        docs.append(doc)
    records = {}
    apply_round = OverlayFoldReplica.apply_round

    def keep(rep, table, log, counts):
        records[id(rep)] = fold_records(log, counts)
        return apply_round(rep, table, log, counts)

    t0 = time.perf_counter()
    if backend == "overlay":
        OverlayFoldReplica.apply_round = keep
        try:
            fold_jobs_overlay(jobs)
        finally:
            OverlayFoldReplica.apply_round = apply_round
    else:
        sf._fold_jobs(jobs)
    secs = time.perf_counter() - t0
    return ({d: summary_state(rep, records.get(id(rep)))
             for d, (rep, _) in zip(docs, jobs)}, secs)


def fold_records(log, counts) -> dict:
    """An overlay fold round's records: the used rows of its log and
    the count a chunk."""
    import numpy as np

    counts = np.asarray(counts).copy()
    return {"counts": counts, "log": np.asarray(log)[:int(counts.sum())]
            .copy()}


def summary_state(rep, records=None) -> dict:
    """A summarizer fold replica's state as host arrays: its table's
    counts, error word and rows [:n_rows] (the `KernelReplica` table,
    or the overlay table with its settled length and the host settled
    text, props and attribution), its arena text, and the round's fold
    records (overlay)."""
    import numpy as np

    from fluidframework_tpu_torch.core.kernel_replica import (
        read_segment_table,
    )
    from fluidframework_tpu_torch.core.overlay_fold import _read_table

    overlay = hasattr(rep, "settled_t")
    t = vars((_read_table if overlay else read_segment_table)(rep.table))
    n = int(t["n_rows"])
    out = {k: (np.asarray(v) if np.ndim(v) == 0 else np.asarray(v)[:n])
           for k, v in t.items()}
    out["text"] = rep.arena.snapshot()
    if overlay:
        out.update(settled_t=rep.settled_t, settled_p=rep.settled_p,
                   settled_a=rep.settled_a)
        if records is not None:
            out.update(fold_counts=records["counts"],
                       fold_log=records["log"])
    return out


class RoleSplits:
    """Phase 29's per-round split of summarizer roles: `instrument`
    wraps each SUMMARY_STAGES stage of a role from outside (the role's
    `process`, `summary_fold._encode_fold`, the fold dispatch with its
    CUDA-event device time, the canonical rows, the reboots, the store's
    puts, the output appends and the checkpoints) and counts its
    emission rounds; `per_round` gives ms a round; `restore` puts the
    module's encoder back."""

    def __init__(self):
        from fluidframework_tpu_torch.server import summary_fold as sf

        self.sf = sf
        self.encode = sf._encode_fold
        self.splits: dict = {}

    def instrument(self, role, key) -> None:
        from fluidframework_tpu_torch.ops.mergetree_scan import (
            mergetree_scan_kernel,
        )
        from fluidframework_tpu_torch.ops.overlay import overlay_chunk_kernel

        sp = self.splits[key] = {
            "s": dict.fromkeys(SUMMARY_STAGES[:-1], 0.0), "rounds": 0,
            "device_ms": 0.0}
        # the path's launch counts start at 0 just before each role run
        mergetree_scan_kernel.launches = overlay_chunk_kernel.launches = 0

        def timed(fn, stage):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    sp["s"][stage] += time.perf_counter() - t
            return run

        for attr, stage in (("process", "process"),
                            ("_rows_of", "canonical_rows"),
                            ("_boot_rep", "reboot"),
                            ("checkpoint", "checkpoint")):
            setattr(role, attr, timed(getattr(role, attr), stage))
        role.store.put = timed(role.store.put, "put")
        role.out_topic.append_many = timed(role.out_topic.append_many,
                                           "append")
        self.sf._encode_fold = timed(self.encode, "encode")
        dispatch, emit_round = timed(role._dispatch_fold, "fold"), \
            role._emit_round

        def fold(jobs):
            groups = dispatch(jobs)
            sp["device_ms"] += sum(g["device_ms"] or 0.0 for g in groups)
            return groups

        def emit(*a):
            sp["rounds"] += 1
            return emit_round(*a)

        role._dispatch_fold, role._emit_round = fold, emit

    def restore(self) -> None:
        self.sf._encode_fold = self.encode

    def per_round(self, key, wall_s, poll_s=0.0) -> dict:
        """ms a round of each stage (`poll_s`: the reads, timed by the
        drive), "other" the rest of `wall_s`."""
        self.restore()
        sp = self.splits[key]
        sp["s"]["poll"] = poll_s
        n = max(1, sp["rounds"])
        ms = {k: v * 1e3 / n for k, v in sp["s"].items()}
        ms["other"] = (wall_s - sum(sp["s"].values())) * 1e3 / n
        ms["fold_device"] = sp["device_ms"] / n
        return ms

    def rounds(self, key) -> int:
        return self.splits[key]["rounds"]


def fmt_split(ms) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in ms.items())


def first_diff(got, want) -> str:
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            keys = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
            return f"manifest {i}: {keys} {a} != {b}"
    return f"{len(got)} manifests, {len(want)} in the golden"


def load_summary_golden() -> dict:
    with open(os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                           "summary_role_golden.json")) as f:
        return json.load(f)


def summary_catchup_phases(dev, log) -> dict:
    """Phase 29 (a), (b) and (d), the summary service's role on config10's
    log, on `dev`: (a) config10's catch-up (`testing/catchup_streams.
    run_catchup`) at 10k, 30k and 100k ops on JSON and columnar topics,
    kernel backend, gated on summary_role_golden.json (every manifest
    field, the tail length, the cold digest of both joins); (b) the 100k
    columnar run on the overlay backend, the same manifests; (d) a crash
    near half of (a)'s 100k columnar topic and a new owner after the
    lease's TTL: (a)'s manifests but ``byteOff``, and every manifest's
    summary + a SUMMARY_TAIL-op tail equal to the cold replay there. The
    topics live in a temporary directory that is removed afterwards.
    Raises on any mismatch; returns what the kernels line reports."""
    import shutil
    import tempfile

    import torch

    from fluidframework_tpu_torch.server.summarizer import (
        SummarizerRole, SummaryReplica, open_summary_store, read_catchup,
    )
    from fluidframework_tpu_torch.testing import catchup_streams as cs
    from fluidframework_tpu_torch.testing import fold_streams as fs

    cuda = dev.type == "cuda"
    t29 = time.perf_counter()
    golden = load_summary_golden()
    p = golden["params"]
    lengths = tuple(p["log_lengths"])
    top = lengths[-1]
    rs = RoleSplits()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-summary-role-")
    try:
        # ---- (a) config10's catch-up, kernel backend, both formats ------
        catchup, first = {}, None
        for fmt in p["formats"]:
            # the full replay reads no topic: run once, on the first
            # format, and stands for both
            res = first = cs.run_catchup(
                lengths, p["summary_ops"], p["n_clients"], fmt, device=dev,
                fold_backend="kernel",
                setup=lambda role, L, fmt=fmt: rs.instrument(role, (fmt, L)),
                cold=first, work_dir=os.path.join(tmp, f"catchup-{fmt}"))
            rows = []
            for r in res["runs"]:
                L = r["log_len"]
                g = golden["runs"][fmt][str(L)]
                if r["manifests"] != g["manifests"]:
                    raise AssertionError(
                        f"catch-up {fmt} L={L}: "
                        f"{first_diff(r['manifests'], g['manifests'])}")
                if (r["digest"], r["tail_ops"], r["summary_seq"]) != (
                        g["digest"], g["tail_ops"], g["summary_seq"]):
                    raise AssertionError(
                        f"catch-up {fmt} L={L}: digest {r['digest']}, tail "
                        f"{r['tail_ops']}, summary seq {r['summary_seq']} "
                        f"differ from summary_role_golden.json")
                lr = r["launches"]
                if cuda and (lr["role"]["scan"] < r["summaries"]
                             or lr["cold"]["scan"] < 1
                             or lr["join"]["scan"] < 1
                             or any(v["overlay"] for v in lr.values())):
                    raise AssertionError(f"catch-up {fmt} L={L}: launches "
                                         f"{lr}")
                split = rs.per_round((fmt, L), r["summarize_s"], r["poll_s"])
                shared_cold = ("" if fmt == p["formats"][0] else
                               f"; the {p['formats'][0]} run's")
                rows.append(dict(
                    log_len=L, full_replay_ms=r["full_replay_ms"],
                    summary_join_ms=r["summary_join_ms"],
                    join_split_ms=r["join_split_ms"],
                    speedup=r["speedup"], tail_ops=r["tail_ops"],
                    blob_bytes=r["blob_bytes"], summaries=r["summaries"],
                    role_s=r["summarize_s"],
                    role_records_per_s=r["records"] / r["summarize_s"],
                    rounds=rs.rounds((fmt, L)), round_ms=split,
                    launches=lr))
                log(f"summary role {fmt} L={L}: {r['records']} records in "
                    f"{r['summarize_s']:.3f}s = "
                    f"{r['records'] / r['summarize_s']:,.0f} records/s, "
                    f"{r['summaries']} summaries (scan launches "
                    f"{lr['role']['scan']}); full replay "
                    f"{r['full_replay_ms']:.2f} ms (scan launches "
                    f"{lr['cold']['scan']}{shared_cold}), summary join "
                    f"{r['summary_join_ms']:.2f} ms ({r['tail_ops']} tail "
                    f"ops, {r['blob_bytes']} blob bytes; scan launches "
                    f"{lr['join']['scan']}), speedup {r['speedup']:.2f}; "
                    f"manifests, tail and digests equal "
                    f"summary_role_golden.json")
                log(f"  ms per round ({rs.rounds((fmt, L))} rounds; host "
                    f"clock, fold_device by CUDA events): "
                    f"{fmt_split(split)}; the join's ms: "
                    f"{fmt_split(r['join_split_ms'])}")
            catchup[fmt] = dict(runs=rows, speedup=res["speedup"],
                                join_flatness=res["join_flatness"])
            log(f"summary catch-up {fmt}: speedup {res['speedup']:.2f} at "
                f"{top} ops, join flatness {res['join_flatness']:.3f} "
                f"({lengths[0]} to {top})")

        # ---- (b) the 100k run on the overlay backend ---------------------
        records = fs.build_mergetree_stream(
            top, n_clients=p["n_clients"], seed=p["seed"],
            window=p["window"], target_len=p["target_len"])
        shared = os.path.join(tmp, "overlay")
        cs.write_deltas(shared, records, "columnar")
        r = cs.drive_summarizer(
            shared, "columnar", p["summary_ops"], batch=p["batch"],
            device=dev, fold_backend="overlay",
            setup=lambda role: rs.instrument(role, ("overlay", top)))
        mans = cs.manifests_of(shared, "columnar")
        want = golden["runs"]["columnar"][str(top)]["manifests"]
        if mans != want:
            raise AssertionError(f"overlay backend at {top}: "
                                 f"{first_diff(mans, want)}")
        lr = r["launches"]
        if cuda and (lr["overlay"] < r["summaries"] or lr["scan"]):
            raise AssertionError(f"overlay backend: role launches {lr}")
        split = rs.per_round(("overlay", top), r["seconds"], r["poll_s"])
        overlay_run = dict(
            log_len=top, role_s=r["seconds"],
            role_records_per_s=r["records"] / r["seconds"],
            summaries=r["summaries"], launches=lr,
            rounds=rs.rounds(("overlay", top)), round_ms=split)
        log(f"summary role overlay backend, columnar L={top}: "
            f"{r['records']} records in {r['seconds']:.3f}s = "
            f"{r['records'] / r['seconds']:,.0f} records/s (kernel A "
            f"launches {lr['overlay']}, scan 0); every manifest, handles "
            f"included, equals the kernel backend's golden")
        log(f"  ms per round ({overlay_run['rounds']} rounds): "
            f"{fmt_split(split)}")

        # ---- (d) a crash and a new owner on the 100k columnar topic -------
        # (a)'s 100k columnar deltas topic (its data file and sidecars)
        shared = os.path.join(tmp, "crash")
        os.makedirs(os.path.join(shared, "topics"))
        src = os.path.join(tmp, "catchup-columnar", f"L{top}", "topics")
        for name in os.listdir(src):
            if name.startswith("deltas.jsonl") and os.path.isfile(
                    os.path.join(src, name)):
                shutil.copyfile(os.path.join(src, name),
                                os.path.join(shared, "topics", name))

        def owner(name, **kw):
            role = SummarizerRole(
                shared, owner=name, ttl_s=SUMMARY_CRASH_TTL,
                batch=SUMMARY_BATCH, log_format="columnar",
                summary_ops=p["summary_ops"], fold_backend="kernel",
                device=dev, **kw)
            rs.instrument(role, ("crash", name))
            return role

        # The first owner checkpoints once, at a quarter of the topic, and
        # stops near half: the new owner restores the checkpoint and
        # replays the quarter after it silently before it goes on.
        first = owner("smoke-s1", ckpt_interval_s=3600.0,
                      ckpt_bytes=1 << 40)
        before = cs.kernel_launches()
        t0 = time.perf_counter()
        while first.offset < len(records) * 0.45:
            first.step()
            if first.offset >= len(records) // 4 and first.ckpt.load(
                    first.name) is None:
                first.checkpoint()
        t_first = time.perf_counter() - t0
        env = first.ckpt.load(first.name)
        ckpt_off = env["state"]["offset"] if env else 0
        crashed_at, fence1 = first.offset, first.fence
        del first  # abandoned: its lease runs out
        time.sleep(SUMMARY_CRASH_TTL + 0.25)
        second = owner("smoke-s2")
        t0 = time.perf_counter()
        deadline = time.time() + 600
        while second.fence is None or second.offset < len(records):
            second.step()
            if time.time() > deadline:
                raise AssertionError("crash run: the new owner never "
                                     "finished")
        if cuda:
            torch.cuda.synchronize(dev)
        t_second = time.perf_counter() - t0
        rs.restore()
        after = cs.kernel_launches()
        launches_crash = {k: after[k] - before[k] for k in after}
        mans = cs.manifests_of(shared, "columnar")

        def but_byte_off(ms):
            return [{k: v for k, v in m.items() if k != "byteOff"}
                    for m in ms]

        keys = [(m["doc"], m["seq"]) for m in mans]
        if but_byte_off(mans) != but_byte_off(want) \
                or len(set(keys)) != len(keys) or second.fence <= fence1:
            raise AssertionError(
                f"crash run: "
                f"{first_diff(but_byte_off(mans), but_byte_off(want))}; "
                f"fences {fence1} then {second.fence}")
        floors = sum(isinstance(m["byteOff"], int) for m in mans)
        store = open_summary_store(shared)
        cold = SummaryReplica(None, device=dev)
        seqs = [m["seq"] for m in mans]
        t0 = time.perf_counter()
        lo = 0
        tails = 0
        for k, m in enumerate(mans):
            # each summary boots with a tail of SUMMARY_TAIL ops (the
            # last one's, read by `read_catchup`, runs to the log's end)
            last = k + 1 == len(mans)
            hi = (len(records) if last else
                  min(seqs[k + 1] - 1, m["seq"] + SUMMARY_TAIL))
            cold.apply_records(records[lo:hi])  # record i has seq i + 1
            lo = hi
            if last:
                cu = read_catchup(shared, "doc0", "columnar", store=store)
                blob, tail = cu["blob"], cu["ops"]
                if cu["manifest"]["seq"] != m["seq"]:
                    raise AssertionError("crash run: read_catchup found "
                                         "another summary than the last")
            else:
                blob = json.loads(store.get(m["handle"]).decode())
                tail = records[m["seq"]:hi]
            boot = SummaryReplica(blob, device=dev)
            boot.apply_records(tail)
            tails += len(tail)
            if boot.state_digest() != cold.state_digest():
                raise AssertionError(f"crash run: the summary at seq "
                                     f"{m['seq']} + its tail to {hi} "
                                     f"differs from the cold replay")
        if cold.state_digest() != golden["runs"]["columnar"][str(top)][
                "digest"]:
            raise AssertionError("crash run: the cold replay's digest "
                                 "differs from summary_role_golden.json")
        t_boots = time.perf_counter() - t0
        crash = dict(crashed_at=crashed_at, checkpoint_at=ckpt_off,
                     first_s=t_first, second_s=t_second,
                     manifests=len(mans), byte_off_floors=floors,
                     launches=launches_crash, boots_s=t_boots,
                     tail_ops=tails)
        log(f"summary role crash run (columnar, {len(records)} records): "
            f"the first owner stopped at input offset {crashed_at} "
            f"(checkpoint at {ckpt_off}) after {t_first:.3f}s; the second "
            f"owner recovered after the lease's {SUMMARY_CRASH_TTL}s and "
            f"finished in {t_second:.3f}s; scan launches "
            f"{launches_crash['scan']}; {len(mans)} manifests equal (a)'s "
            f"but byteOff ({floors} carry one), no (doc, seq) repeated; "
            f"every summary + its tail (up to {SUMMARY_TAIL} ops, the last "
            f"one's to the log's end; {tails} tail ops in all) equals the "
            f"cold replay there ({t_boots:.2f}s)")
    finally:
        rs.restore()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 29 (a, b, d) {time.perf_counter() - t29:.2f}s")
    return dict(catchup=catchup, overlay=overlay_run, crash=crash)


def summary_stack_phases(dev, log, workers: int) -> dict:
    """Phase 29 (c) and (e) on `dev`: (c) config15's 132 documents
    interleaved record by record into one columnar deltas topic, through
    the summarizer role on both backends, every blob's rows gated on
    fold_golden.json; (e) the first stacked round of (c) on each backend
    held against the plain versions on the CPU (`workers` worker
    processes), exactly: tables, fold records, error words. The topics
    live in a temporary directory that is removed afterwards. Raises on
    any mismatch; returns what the kernels line reports."""
    import shutil
    import tempfile

    import numpy as np

    from fluidframework_tpu_torch.server.summarizer import open_summary_store
    from fluidframework_tpu_torch.testing import catchup_streams as cs
    from fluidframework_tpu_torch.testing import fold_streams as fs

    cuda = dev.type == "cuda"
    t29 = time.perf_counter()
    rs = RoleSplits()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-summary-stack-")
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        fgold = fs.load_fold_golden()
        step = fgold["params"]["summary_ops"]
        streams = fs.golden_streams(fgold, SUMMARY_STACK_DOCS)
        want_rows = {d["doc"]: d["rows_sha256"] for d in fgold["docs"]}
        inter = []
        for i in range(max(len(v) for v in streams.values())):
            inter.extend(v[i] for v in streams.values() if i < len(v))
        n_whole = min(len(v) for v in streams.values()) // step
        stacked, plain_jobs = {}, {}
        t0 = time.perf_counter()
        stack_topics = os.path.join(tmp, "stack-topics")
        cs.write_deltas(stack_topics, inter, "columnar")
        t_write = time.perf_counter() - t0
        for backend in ("kernel", "overlay"):
            shared = os.path.join(tmp, f"stack-{backend}")
            shutil.copytree(stack_topics, shared,
                            ignore=shutil.ignore_patterns("*.bells"))
            held: dict = {}

            def setup(role, backend=backend, held=held):
                rs.instrument(role, ("stack", backend))
                hold_first_round(role, held)

            run = cs.drive_summarizer(shared, "columnar", step,
                                      batch=SUMMARY_BATCH, device=dev,
                                      fold_backend=backend, setup=setup)
            split = rs.per_round(("stack", backend), run["seconds"],
                                 run["poll_s"])
            mans = cs.manifests_of(shared, "columnar")
            store = open_summary_store(shared)
            got_rows, got_man = {}, {}
            for m in mans:
                blob = json.loads(store.get(m["handle"]).decode())
                got_rows.setdefault(m["doc"], []).append(hashlib.sha256(
                    json.dumps(blob["rows"], sort_keys=True).encode())
                    .hexdigest())
                got_man.setdefault(m["doc"], []).append(
                    [m["seq"], m["count"], m["handle"]])
            for doc in streams:
                if got_rows.get(doc) != want_rows[doc][:n_whole]:
                    raise AssertionError(f"stacked role {backend}: {doc}'s "
                                         f"blob rows differ from "
                                         f"fold_golden.json")
            for doc, ms in fgold["manifests"].items():
                if doc in streams and got_man[doc] != ms:
                    raise AssertionError(f"stacked role {backend}: {doc}'s "
                                         f"manifests differ from "
                                         f"fold_golden.json")
            lr = run["launches"]
            kernel_key = "scan" if backend == "kernel" else "overlay"
            rounds = rs.rounds(("stack", backend))
            if rounds != n_whole or (cuda and not lr[kernel_key]) \
                    or "inputs" not in held:
                raise AssertionError(f"stacked role {backend}: {rounds} "
                                     f"rounds, launches {lr}")
            stacked[backend] = dict(
                docs=len(streams), records=run["records"],
                emissions=len(mans), seconds=run["seconds"],
                emissions_per_s=len(mans) / run["seconds"],
                records_per_s=run["records"] / run["seconds"],
                launches=lr, rounds=rounds, round_ms=split,
                first_round_launches=held["launches"])
            log(f"summary role stacked, {backend} backend: "
                f"{len(streams)} documents x {len(inter) // len(streams)} "
                f"records interleaved ({run['records']} records, columnar "
                f"topic written in {t_write:.2f}s, set-up) in "
                f"{run['seconds']:.3f}s = "
                f"{len(mans) / run['seconds']:.1f} emissions/s, "
                f"{run['records'] / run['seconds']:,.0f} records/s; "
                f"{rounds} rounds of {len(streams)} stacked documents, "
                f"{kernel_key} launches {lr[kernel_key]} "
                f"({held['launches'][kernel_key]} in the first round); every "
                f"blob's rows and the first {len(fgold['manifests'])} "
                f"documents' manifests equal fold_golden.json")
            log(f"  ms per round: {fmt_split(split)}")
            # (e), the CPU half: the first stacked round's inputs
            # through the plain versions, in worker processes
            ins = held["inputs"]
            plain_jobs[backend] = (held, [
                pool.submit(summary_round_plain, backend, ins[w::workers])
                for w in range(workers)])

        # ---- (e) the first stacked round vs the plain versions ------------
        plain = {}
        for backend, (held, futs) in plain_jobs.items():
            cpu, secs = {}, 0.0
            for fut in futs:
                states, s = fut.result()
                cpu.update(states)
                secs += s
            err = 0
            for doc, want_st in cpu.items():
                got = held["device"][doc]
                if set(got) != set(want_st):
                    raise AssertionError(f"first round {backend} {doc}: "
                                         f"fields {sorted(got)}")
                for key, b in want_st.items():
                    a = got[key]
                    if key == "text":
                        if a != b:
                            raise AssertionError(f"first round {backend} "
                                                 f"{doc}: text differs")
                        continue
                    a, b = np.asarray(a), np.asarray(b)
                    if a.shape != b.shape or a.dtype != b.dtype:
                        raise AssertionError(
                            f"first round {backend} {doc}: {key} is "
                            f"{a.dtype} {a.shape}, plain {b.dtype} "
                            f"{b.shape}")
                    d = int(np.abs(a.astype(np.int64)
                                   - b.astype(np.int64)).max()) \
                        if a.size else 0
                    err = max(err, d)
                    if d:
                        raise AssertionError(f"first round {backend} "
                                             f"{doc}: {key} differs from "
                                             f"the plain version by {d}")
            if len(cpu) != len(held["device"]):
                raise AssertionError(f"first round {backend}: "
                                     f"{len(cpu)} documents held")
            plain[backend] = dict(docs=len(cpu), max_abs_err=err,
                                  plain_s=secs,
                                  launches=held["launches"])
            log(f"summary role first stacked round, {backend} backend: "
                f"{len(cpu)} documents' tables, error words"
                + (", settled state and fold records" if backend ==
                   "overlay" else "")
                + f" equal the plain version's on the CPU (max_abs_err "
                f"{err}; plain {secs:.2f}s summed over {workers} worker "
                f"processes)")
    finally:
        rs.restore()
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 29 (c, e) {time.perf_counter() - t29:.2f}s")
    return dict(stacked=stacked, first_round=plain)


def side_phases(go, out) -> None:
    """Phases 28 and 30 (c), then phase 29 (c, e) once `go` is set, in a
    worker process that the smoke starts after phase 12. Phases 28 and
    30 (c) are host-bound and launch only the sequencer's 20 µs kernel,
    so they run beside the main process's phases 13-27 without
    disturbing their kernel timings; phase 29 (c, e) folds 132 documents
    a round (many small copies), so the main process sets `go` only when
    its timed phases are done, and it runs beside phase 29 (a, b, d) and
    30 (a). Puts ("ok", phase 28's result, 29 (c, e)'s, 30 (c)'s, the
    log lines) on `out`, or ("error", the traceback, None, None, the
    lines so far)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    lines = []
    try:
        import torch

        dev = torch.device("cuda", 0)  # kernels load at first launch
        t = time.perf_counter()
        role = deli_role_phases(dev, lines.append)
        lines.append(f"phase 28 in the worker process "
                     f"{time.perf_counter() - t:.2f}s")
        deli_mesh = mesh_deli_phase(dev, lines.append)
        go.wait()
        stack = summary_stack_phases(dev, lines.append,
                                     SUMMARY_PLAIN_WORKERS)
        out.put(("ok", role, stack, deli_mesh, lines))
    except BaseException:
        import traceback

        out.put(("error", traceback.format_exc(), None, None, lines))
        raise


def side_result(proc, out) -> tuple:
    """`side_phases`'s message from `out`, raising if it failed or its
    process died without one."""
    import queue

    while True:
        try:
            status, a, b, c, lines = out.get(timeout=5)
            break
        except queue.Empty:
            if not proc.is_alive():
                raise RuntimeError(f"the worker process of phases 28, 29 "
                                   f"(c, e) and 30 (c) died (exit code "
                                   f"{proc.exitcode})")
    proc.join()
    if status != "ok":
        for line in lines:
            log(line)
        raise RuntimeError(f"phases 28 / 29 (c, e) / 30 (c) failed in the "
                           f"worker process:\n{a}")
    return a, b, c, lines


def hold_first_round(role, held: dict) -> None:
    """Wrap `role._dispatch_fold` so that its first stacked round (two
    or more documents) keeps in `held` its inputs (each document's
    canonical rows, MSN and records), its launches, and each document's
    state after the fold (`summary_state`, with the fold records of an
    overlay round); later rounds pass through."""
    from fluidframework_tpu_torch.core.overlay_fold import (
        OverlayFoldReplica,
    )
    from fluidframework_tpu_torch.testing.catchup_streams import (
        kernel_launches,
    )

    dispatch = role._dispatch_fold

    def first(fold_jobs):
        if "inputs" in held or len(fold_jobs) < 2:
            return dispatch(fold_jobs)
        doc_of = {id(rep): doc for doc, rep in role._reps.items()}
        held["inputs"] = [
            (doc_of[id(rep)], role.docs[doc_of[id(rep)]]["rows"],
             role.docs[doc_of[id(rep)]]["base_msn"], list(take))
            for rep, take in fold_jobs]
        records = {}
        apply_round = OverlayFoldReplica.apply_round

        def keep(rep, table, log, counts):
            records[id(rep)] = fold_records(log, counts)
            return apply_round(rep, table, log, counts)

        before = kernel_launches()
        OverlayFoldReplica.apply_round = keep
        try:
            groups = dispatch(fold_jobs)
        finally:
            OverlayFoldReplica.apply_round = apply_round
        after = kernel_launches()
        held["launches"] = {k: after[k] - before[k] for k in after}
        held["device"] = {doc_of[id(rep)]: summary_state(
            rep, records.get(id(rep))) for rep, _ in fold_jobs}
        return groups

    role._dispatch_fold = first


def mesh_dryrun_phase(dev, log) -> dict:
    """Phase 30 (a): the dry run on MESH_DRYRUN_ENTRIES mesh entries of
    `dev`, with every kernel's launch count set to 0 just before; each
    section's sharded call launched kernel A and the fold entries x
    chunks, the sequencer once, the scan once an entry. Raises on any mismatch;
    returns the dry run's report and the launches in all."""
    import torch

    from fluidframework_tpu_torch.ops.mergetree_scan import (
        mergetree_scan_kernel,
    )
    from fluidframework_tpu_torch.ops.overlay import (
        overlay_chunk_kernel, overlay_fold_kernel,
    )
    from fluidframework_tpu_torch.ops.sequencer_kernel import (
        sequencer_step_kernel,
    )
    from fluidframework_tpu_torch.parallel.dryrun import dryrun_multichip

    kernels = (overlay_chunk_kernel, overlay_fold_kernel,
               sequencer_step_kernel, mergetree_scan_kernel)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    report = dryrun_multichip(MESH_DRYRUN_ENTRIES, device=dev,
                              scale=MESH_DRYRUN_SCALE)
    t_dry = time.perf_counter() - t0
    n = MESH_DRYRUN_ENTRIES
    want = {
        "one_doc": {"overlay_chunk": n * report["one_doc"]["chunks"],
                    "overlay_fold": n * report["one_doc"]["chunks"],
                    "sequencer_step": 0, "mergetree_scan": 0},
        "multi_doc": {"overlay_chunk": n * report["multi_doc"]["chunks"],
                      "overlay_fold": n * report["multi_doc"]["chunks"],
                      "sequencer_step": 1, "mergetree_scan": 0},
        "pipeline": {"overlay_chunk": 0, "overlay_fold": 0,
                     "sequencer_step": 0, "mergetree_scan": n},
    }
    for sec, counts in want.items():
        if report[sec]["launches"] != counts or report[sec]["gerr"]:
            raise AssertionError(
                f"phase 30 (a) {sec}: launches {report[sec]['launches']} "
                f"(want {counts}), error bits {report[sec]['gerr']}")
    if report["seqshard"]["gerr"]:
        raise AssertionError("phase 30 (a): seqshard error bits "
                             f"{report['seqshard']['gerr']}")
    dry_total = {k.name: k.launches for k in kernels}
    log(f"mesh dry run on {n} entries of {dev} (scale {MESH_DRYRUN_SCALE}, "
        f"{t_dry:.2f}s): one document an entry ({report['one_doc']['ops']} "
        f"ops, {report['one_doc']['chunks']} chunks: kernel A and fold "
        f"launches {report['one_doc']['launches']['overlay_chunk']} and "
        f"{report['one_doc']['launches']['overlay_fold']} = entries x "
        f"chunks), {report['multi_doc']['docs']} documents chained behind "
        f"the sequencer ({report['multi_doc']['launches']}), one document "
        f"sequence-sharded ({report['seqshard']['ops']} ops, "
        f"{report['seqshard']['seconds']:.2f}s), the row model's pipeline "
        f"step ({report['pipeline']['launches']['mergetree_scan']} scan "
        f"launches); every digest equals its single-entry run's, gmsn as "
        f"the reference's, error words 0; launches in all "
        f"{dry_total} (the single-entry references' included)")
    return dict(report=report, launches=dry_total)


def mesh_docs_phase(dev, log, hold, doc_replica, distinct, single,
                    single_out, docs_d32, digest0) -> dict:
    """Phase 30 (b): MESH_DOCS documents of phase 11 (`distinct`, whose
    single replays gave `single`, their error words, and `single_out`,
    their final (table, log, counts, cursor); doc 0's digest `digest0`)
    sharded over
    MESH_ENTRIES entries of `dev`: entry 0's first chunk held to the
    plain version by `hold`, kernel A's count set to 0 just before the
    replay, every document's outputs held to its single replay's
    exactly, timed beside phase 11's D = 32 run (`docs_d32`).
    `doc_replica` makes phase 11's replica of a stream on `dev`. Raises
    on any mismatch; returns what the kernels line reports."""
    import torch

    from fluidframework_tpu_torch.core.overlay_replay import (
        restore_shard, stack_replicas,
    )
    from fluidframework_tpu_torch.ops.overlay import (
        ops_at, overlay_apply_chunk, overlay_chunk_kernel,
        overlay_fold_kernel,
    )
    from fluidframework_tpu_torch.parallel.mesh import (
        make_docs_mesh, sharded_overlay_replay_multi,
    )
    from fluidframework_tpu_torch.testing.digest import state_digest
    from fluidframework_tpu_torch.utils.devices import parity_skip_reason

    reps = [doc_replica(distinct[d % len(distinct)])
            for d in range(MESH_DOCS)]
    want_err = 0
    for d in range(MESH_DOCS):
        want_err |= single[d % len(distinct)]
    tables, ops, logs, counts, msns = stack_replicas(reps)
    n_chunks = reps[0].n_chunks
    mesh = make_docs_mesh(MESH_ENTRIES, dev)
    step = sharded_overlay_replay_multi(mesh, CHUNK)
    per = MESH_DOCS // MESH_ENTRIES
    # Entry 0's slab on the first chunk: the launch the path makes
    # there, held against the plain version per document.
    slab_t, slab_o = mesh.shard(tables)[0], mesh.shard(ops, dim=1)[0]
    chunk0 = ops_at(slab_o, 0)
    out0 = overlay_apply_chunk(slab_t, chunk0)
    for d in range(per):
        hold(out0.doc(d), slab_t.doc(d), ops_at(chunk0, d),
             f"phase 30 (b) entry 0 doc {d} chunk 0")
    del slab_t, slab_o, chunk0, out0
    torch.cuda.synchronize()
    overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
    t0 = time.perf_counter()
    out = step(tables, ops, logs, counts, msns)
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    launches_mesh = overlay_chunk_kernel.launches
    launches_mesh_f = overlay_fold_kernel.launches
    if launches_mesh != MESH_ENTRIES * n_chunks or \
            launches_mesh_f != MESH_ENTRIES * n_chunks:
        raise AssertionError(f"phase 30 (b): kernel A / fold launches "
                             f"{launches_mesh} / {launches_mesh_f} != "
                             f"{MESH_ENTRIES} x {n_chunks}")
    gmsn, gerr = int(out[4]), int(out[5])
    if gerr != want_err or gmsn != int(msns[-1].min()):
        raise AssertionError(f"phase 30 (b): gerr {gerr} (want {want_err}), "
                             f"gmsn {gmsn} (want {int(msns[-1].min())})")
    # Every document's outputs equal its single replay's, exactly (the
    # final table whole, the log to the cursor, the counts): so do its
    # digest and error word. Doc 0's digest is read out (GOLDEN.json's
    # stage digest at DOC_OPS).
    t0 = time.perf_counter()
    for d in range(MESH_DOCS):
        diff = output_diff(out, d, single_out[d % len(single_out)])
        if diff:
            raise AssertionError(f"phase 30 (b): doc {d}'s {diff} differs "
                                 f"from its single replay's")
    r0 = restore_shard(doc_replica(distinct[0]), *out[:4], 0)
    got0 = (state_digest(r0.annotated_spans()), int(r0.table.error))
    if got0 != (digest0, single[0]):
        raise AssertionError(f"phase 30 (b): doc 0 (digest, error) {got0} "
                             f"!= {(digest0, single[0])}")
    t_read = time.perf_counter() - t0
    del reps, tables, ops, logs, counts, msns, out, r0
    ms_chunk = t_mesh * 1e3 / n_chunks
    skip = parity_skip_reason(MESH_ENTRIES)
    docs_mesh = dict(D=MESH_DOCS, entries=MESH_ENTRIES, seconds=t_mesh,
                     launches=launches_mesh, fold_launches=launches_mesh_f,
                     ops_per_s=MESH_DOCS * DOC_OPS / t_mesh,
                     ms_per_chunk=ms_chunk,
                     single_launch_ms_per_chunk=docs_d32["ms_per_chunk"],
                     ratio=ms_chunk / docs_d32["ms_per_chunk"],
                     not_a_scaling_figure=skip, gerr=gerr, gmsn=gmsn)
    log(f"mesh docs replay: {MESH_DOCS} x {DOC_OPS} ops on {MESH_ENTRIES} "
        f"entries of {dev} ({per} documents an entry, each on its own "
        f"stream) in {t_mesh:.3f}s = {MESH_DOCS * DOC_OPS / t_mesh:,.0f} "
        f"ops/s aggregate, {ms_chunk:.4f} ms/chunk (kernel A and fold "
        f"launches {launches_mesh} and {launches_mesh_f} = {MESH_ENTRIES} x "
        f"{n_chunks} each); phase 11's D = "
        f"{MESH_DOCS} in one launch a chunk: "
        f"{docs_d32['ms_per_chunk']:.4f} ms/chunk, ratio "
        f"{docs_mesh['ratio']:.3f}; every document's final table, log, "
        f"counts and cursor equal its single replay's exactly, so its "
        f"digest and error word do (doc 0's digest read out: GOLDEN.json "
        f"at {DOC_OPS}; {t_read:.2f}s), gerr "
        f"{gerr} = the OR of theirs, gmsn {gmsn}; entry 0's first chunk == "
        f"plain for its {per} documents. Not a scaling figure: {skip}")
    return docs_mesh


def mesh_deli_phase(dev, log) -> dict:
    """Phase 30 (c): config 5 through a deli pool split over
    MESH_ENTRIES entries of `dev`, the sequencer's count set to 0 just
    before: the deltas and checkpoint digests equal to deli_golden.json
    and one launch an entry a chunk (the caller holds the launches to
    MESH_ENTRIES times phase 18's). Host-bound like phase 28, so it runs
    in the worker process beside the main process's phases 13-27.
    Raises on any mismatch; returns what the kernels line reports."""
    import torch

    from fluidframework_tpu_torch.ops.sequencer_kernel import (
        sequencer_step_kernel,
    )
    from fluidframework_tpu_torch.server.deli_kernel import KernelDeliLambda
    from fluidframework_tpu_torch.server.log import MessageLog
    from fluidframework_tpu_torch.testing import deli_streams as ds

    t30 = time.perf_counter()
    with open(os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                           "deli_golden.json")) as f:
        golden = json.load(f)
    p = golden["params"]
    raws = ds.to_inproc(ds.build_pipeline_workload(
        p["n_docs"], p["n_clients"], p["ops_per_client"], seed=p["seed"]))
    lg = MessageLog()
    lg.topic("rawdeltas").append_many(raws)
    deli = KernelDeliLambda(lg, device=dev, max_pump=p["max_pump"],
                            deli_devices=MESH_ENTRIES)
    pool = deli.core.pool
    torch.cuda.synchronize()
    sequencer_step_kernel.launches = 0
    pumps = 0
    t0 = time.perf_counter()
    while deli.pump():
        pumps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_deli = sequencer_step_kernel.launches
    digest = ds.StreamDigest().update(lg.topic("deltas").read(0))
    cp = ds.checkpoint_digest(deli.checkpoint())
    if (digest.hexdigest(), digest.stamps, digest.nacks, cp) != (
            golden["deltas_sha256"], golden["stamps"], golden["nacks"],
            golden["checkpoint_sha256"]):
        raise AssertionError("phase 30 (c): the deltas or the checkpoint "
                             "differ from deli_golden.json")
    if launches_deli != MESH_ENTRIES * pool.chunks:
        raise AssertionError(
            f"phase 30 (c): {launches_deli} sequencer launches for "
            f"{pool.chunks} chunks on {MESH_ENTRIES} entries")
    deli_mesh = dict(entries=MESH_ENTRIES, records=len(raws), pumps=pumps,
                     seconds=wall, records_per_s=len(raws) / wall,
                     launches=launches_deli, chunks=pool.chunks,
                     pool={"D": pool.n_docs, "C": pool.n_clients,
                           "B": pool.max_cols_seen,
                           "slab_rows": pool.n_docs // MESH_ENTRIES})
    log(f"mesh deli: config 5's {len(raws)} records in {pumps} pumps "
        f"through KernelDeliLambda(deli_devices={MESH_ENTRIES}) on {dev} in "
        f"{wall:.3f}s = {len(raws) / wall:,.0f} records/s (host clock); "
        f"sequencer launches {launches_deli} = {MESH_ENTRIES} x "
        f"{pool.chunks} chunks; pool D {pool.n_docs} ({pool.n_docs // MESH_ENTRIES}"
        f" rows a slab) C {pool.n_clients} B {pool.max_cols_seen}; deltas and "
        f"checkpoint digests match deli_golden.json; phase 30 (c) "
        f"{time.perf_counter() - t30:.2f}s")
    return deli_mesh


def events_ms(fn, reps: int) -> float:
    """Device ms per call of `fn` by CUDA events around `reps`
    back-to-back calls after one warm-up: the host's enqueue is inside
    the span wherever it is slower than the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def fold_bytes(table, n_new, append: bool) -> int:
    """The bytes the fold must move for this table (one document or a
    docs-form stack of W rows each), computed from its data: anchor,
    buf_start, length, ins_seq and the KK props of every row (each row,
    dead ones too, reaches the record block), rem_seq of the live rows
    only, ins_client and the KR rem_clients of the n_new kept rows only
    (`n_new`: the output's n_rows); the whole output table (6 + KR + KK
    ints a row) and the whole record block (5 + KK); a document's
    n_rows, settled_len and MSN in, n_rows and settled_len out; n_rec,
    or in the append form the cursor in, the new cursor and
    counts[epoch] out."""
    W = table.length.shape[-1]
    KR, KK = table.rem_clients.shape[-1], table.props.shape[-1]
    D = table.n_rows.numel()
    live = int(table.n_rows.clamp(0, W).sum())
    kept = int(n_new.sum())
    ints = (D * W * (4 + KK) + live + kept * (1 + KR)
            + D * W * (6 + KR + KK) + D * W * (5 + KK)
            + D * (5 + (3 if append else 1)))
    return 4 * ints


def fold_kernel_phase(dev, chunk_outs, log) -> dict:
    """Phase 3 (b): the fold kernel (``csrc/overlay_fold.cu``) against
    its plain versions `fold_device_ref` and `fold_append_ref` on the
    same CUDA inputs, exactly (int32, tolerance 0) on every output: the
    whole table, the whole record block and n_rec; in the append form
    the whole log, counts and the cursor. `chunk_outs` are phase 3's
    (kernel A output, MSN) pairs of its checked chunks. Held at the
    cluster size the wrapper picks: each of them (both forms, the MSN
    read from the card), the edge tables of `testing/fold_edges.py` (the
    tile-boundary cases among them) at the bench geometry and at the
    summary fold's (cursors that fit, clamp and pass the capacity), D =
    132 stacks at both (phase 3's tables tiled, and random tables, an
    MSN per document), and phase 3's tables tiled to D = 4, 8 and 32.
    Then the chunks, the edge tables and the tiled D = 132 stack again
    at each cluster size G = 1, 2, 4, 8 forced. Then the append form's
    time by CUDA events behind a spin at D = 1 (the checked chunks, the
    main path's launch), 8 and 132 (phase 3's tables tiled), each beside
    its bytes bound and the time of an empty launch of the same grid,
    clusters and shared memory, and the plain version's by CUDA events
    back to back. Raises on any mismatch; returns what the kernels line
    reports."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.interop import table_from_numpy
    from fluidframework_tpu_torch.ops.overlay import (
        FOLD_CLUSTERS, fold_append_ref, fold_cluster, fold_device_ref,
        overlay_fold_kernel, stack_tables,
    )
    from fluidframework_tpu_torch.testing.fold_edges import (
        edge_cases, random_table,
    )

    t0 = time.perf_counter()
    fields = ("n_rows", "anchor", "buf_start", "length", "ins_seq",
              "ins_client", "rem_seq", "rem_clients", "props",
              "settled_len", "error")
    max_err, held = 0, 0
    sms = overlay_fold_kernel.sm_count(dev)

    def same(a, b, what):
        nonlocal max_err
        d = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0
        max_err = max(max_err, d)
        if d or a.shape != b.shape:
            raise AssertionError(f"fold kernel {what} differs from the plain "
                                 f"version (max |diff| {d})")

    def hold(table, msn, cursor, cap, label, cluster=None):
        nonlocal held
        label = f"{label} G {cluster or 'picked'}"
        got = overlay_fold_kernel(table, msn, cluster=cluster)
        want = fold_device_ref(table, msn)
        for f in fields:
            same(getattr(got[0], f), getattr(want[0], f), f"{label}: {f}")
        same(got[1], want[1], f"{label}: records")
        same(got[2], want[2], f"{label}: n_rec")
        lead = tuple(table.length.shape[:-1])
        KK = table.props.shape[-1]
        g = torch.Generator().manual_seed(cap)
        log0 = torch.randint(-9, 9, lead + (cap, 5 + KK), generator=g,
                             dtype=torch.int32).to(dev)
        cur = torch.as_tensor(np.broadcast_to(
            np.asarray(cursor, np.int32), lead).copy()).to(dev)
        outs = []
        for fn in (lambda *a: overlay_fold_kernel.append(*a, cluster=cluster),
                   fold_append_ref):
            lg = log0.clone()
            counts = torch.zeros(lead + (4,), dtype=torch.int32, device=dev)
            t, c = fn(table, msn, lg, counts, cur, 2)
            outs.append((t, c, lg, counts))
        for f in fields:
            same(getattr(outs[0][0], f), getattr(outs[1][0], f),
                 f"{label} append: {f}")
        for i, what in ((1, "cursor"), (2, "log"), (3, "counts")):
            same(outs[0][i], outs[1][i], f"{label} append: {what}")
        held += 1

    W, KR, KK = WINDOW, N_REMOVERS, N_PROP_KEYS
    edges = []
    for shape in ((W, KR, KK), (1024, 4, 8)):
        for case in edge_cases(*shape, seed=shape[0]):
            msn = case.msn
            if np.ndim(msn) or len(edges) % 2:
                msn = torch.as_tensor(np.asarray(msn, np.int32)).to(dev)
            edges.append((table_from_numpy(case.table, dev), msn,
                          case.cursor, case.cap,
                          f"edge {case.name} W {shape[0]} KR {shape[1]}"))

    def tiled(D):
        """Phase 3's tables tiled to D documents, with their MSNs."""
        return (stack_tables([chunk_outs[d % len(chunk_outs)][0]
                              for d in range(D)]),
                torch.stack([chunk_outs[d % len(chunk_outs)][1]
                             for d in range(D)]).contiguous())

    D = max(DOC_COUNTS)
    stack_d, msn_d = tiled(D)

    def hold_all(cluster):
        for ci, (out, msn) in enumerate(chunk_outs):
            hold(out, msn, 64 * ci, 2 * W, f"chunk {ci}", cluster)
        for edge in edges:
            hold(*edge, cluster)
        hold(stack_d, msn_d, torch.arange(D, dtype=torch.int32) * 97, 2 * W,
             f"D {D} bench geometry", cluster)

    hold_all(None)
    rng = np.random.default_rng(D)
    fold_kr = 4  # the summary fold's remover slots (core/overlay_fold.py)
    rand = table_from_numpy(random_table(rng, W, fold_kr, KK, D=D), dev)
    rand_msn = torch.as_tensor(rng.integers(0, 100, D).astype(np.int32)
                               ).to(dev)
    hold(rand, rand_msn, W, 2 * W, f"D {D} fold shape (KR {fold_kr})")
    picked = {1: fold_cluster(1, W, KK, sms), D: fold_cluster(D, W, KK, sms)}
    for n in (4, 8, 32):
        t, m = tiled(n)
        hold(t, m, torch.arange(n, dtype=torch.int32) * 31, 2 * W,
             f"D {n} bench geometry")
        picked[n] = fold_cluster(n, W, KK, sms)
    held_picked = held
    for G in FOLD_CLUSTERS:
        hold_all(G)
    log(f"overlay_fold == plain (fold_device_ref, fold_append_ref) on "
        f"{held} tables, both forms, exactly (the whole table, records, "
        f"n_rec, log, counts, cursor): {held_picked} at the cluster size "
        f"the wrapper picks (phase 3's {len(chunk_outs)} chunks, "
        f"{len(edges)} edge tables, D = {D} at the bench geometry and at "
        f"the fold's shape, D = 4, 8, 32 tiled; G picked by D: "
        f"{dict(sorted(picked.items()))}), then the chunks, the edge tables "
        f"and the D = {D} stack at each G of {FOLD_CLUSTERS} forced; "
        f"{time.perf_counter() - t0:.2f}s")

    # Times: the append form, as replay_chunk_step launches it.
    def append_call(table, msn):
        lead = tuple(table.length.shape[:-1])
        lg = torch.zeros(lead + (2 * W, 5 + KK), dtype=torch.int32,
                         device=dev)
        counts = torch.zeros(lead + (1,), dtype=torch.int32, device=dev)
        cur = torch.zeros(lead, dtype=torch.int32, device=dev)
        return (table, msn, lg, counts, cur, 0)

    one = [append_call(t, m) for t, m in chunk_outs]
    k = [0]

    def launch_one():
        overlay_fold_kernel.append(*one[k[0] % len(one)])
        k[0] += 1

    ms = spin_time(launch_one, 64)
    k[0] = 0

    def plain_one():
        fold_append_ref(*one[k[0] % len(one)])
        k[0] += 1

    plain_ms = events_ms(plain_one, len(one))
    # The bounds from this run's tables: the one-document bound is the
    # mean over the chunks the timed launches cycle through.
    b1 = sum(fold_bytes(t, fold_device_ref(t, m)[0].n_rows, True)
             for t, m in chunk_outs) / len(chunk_outs) / PEAK_BYTES_S * 1e3
    # int32 work: ~24 operations a row (the tests, the prefix adds, the
    # destinations and selects): far below the bytes at these shapes.
    o1 = 24 * W / PEAK_OPS_S * 1e3
    bound_ms, bound_by = max(b1, o1), "bytes" if b1 >= o1 else "operations"
    empty = {1: spin_time(lambda: overlay_fold_kernel.launch_empty(dev, 1, W, KK),
                          64)}
    times = {}
    for n, reps in ((8, 32), (D, 16)):
        t, m = tiled(n)
        call = append_call(t, m)
        times[n] = dict(
            ms=spin_time(lambda: overlay_fold_kernel.append(*call), reps),
            plain_ms=events_ms(lambda: fold_append_ref(*call), 4),
            bound_ms=fold_bytes(t, fold_device_ref(t, m)[0].n_rows, True)
            / PEAK_BYTES_S * 1e3)
        empty[n] = spin_time(
            lambda: overlay_fold_kernel.launch_empty(dev, n, W, KK), reps)
    log(f"overlay_fold per launch (append form, W {W}, KR {KR}, KK {KK}; "
        f"CUDA events behind a spin; the empty launch has the same grid, "
        f"clusters and shared memory): one document (G {picked[1]}, "
        f"phase 3's chunks) {ms:.6f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}), share {bound_ms / ms:.4f}, empty launch "
        f"{empty[1]:.6f} ms; the plain version (torch ops on the card) "
        f"{plain_ms:.6f} ms back to back")
    for n in (8, D):
        r = times[n]
        log(f"overlay_fold per launch at D = {n} (G {fold_cluster(n, W, KK, sms)},"
            f" phase 3's tables tiled): {r['ms']:.6f} ms, bound "
            f"{r['bound_ms']:.6f} ms (bytes), share "
            f"{r['bound_ms'] / r['ms']:.4f}, empty launch {empty[n]:.6f} ms;"
            f" plain {r['plain_ms']:.6f} ms back to back")
    return dict(max_abs_err=max_err, held=held, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                empty_ms=empty[1], clusters=picked,
                ms_d8=times[8]["ms"], bound_ms_d8=times[8]["bound_ms"],
                plain_ms_d8=times[8]["plain_ms"], empty_ms_d8=empty[8],
                ms_d132=times[D]["ms"], plain_ms_d132=times[D]["plain_ms"],
                bound_ms_d132=times[D]["bound_ms"], empty_ms_d132=empty[D],
                shape=dict(W=W, KR=KR, KK=KK, append=True))


def plane_phase(dev, log) -> dict:
    """Phase 31: config15's fold (its 4 documents, fold_golden.json's
    seeds, a summary every 375 records) through `SummarizerRole` on a
    PLANE_SPEC device plane of entries of `dev`, on both backends, and
    without a plane: every blob's rows equal fold_golden.json, the
    manifests its, the plane's blobs and manifests byte for byte the
    plane-less run's, ``summary_plane_folds_total`` counts the plane's
    folds. The launches of each run are read from the kernels' counts
    just before and after it. Raises on any mismatch; returns what the
    kernels line reports."""
    import shutil
    import tempfile

    from fluidframework_tpu_torch.ops.overlay import overlay_fold_kernel
    from fluidframework_tpu_torch.server.summarizer import open_summary_store
    from fluidframework_tpu_torch.testing import catchup_streams as cs
    from fluidframework_tpu_torch.testing import fold_streams as fs

    t31 = time.perf_counter()
    fgold = fs.load_fold_golden()
    step = fgold["params"]["summary_ops"]
    streams = fs.golden_streams(fgold, FOLD_DOCS[0])
    inter = []
    for i in range(max(len(v) for v in streams.values())):
        inter.extend(v[i] for v in streams.values() if i < len(v))
    n_whole = min(len(v) for v in streams.values()) // step
    want_rows = {d["doc"]: d["rows_sha256"][:n_whole] for d in fgold["docs"]}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-plane-")
    runs = {}
    try:
        topics = os.path.join(tmp, "topics")
        cs.write_deltas(topics, inter, "columnar")
        for backend in ("kernel", "overlay"):
            files = {}
            for plane in (None, PLANE_SPEC):
                shared = os.path.join(tmp, f"{backend}-{plane}")
                shutil.copytree(topics, shared,
                                ignore=shutil.ignore_patterns("*.bells"))
                folds = {}

                def setup(role, folds=folds):
                    folds["before"] = role._m_plane_folds.value
                    folds["launches"] = overlay_fold_kernel.launches

                r = cs.drive_summarizer(shared, "columnar", step,
                                        batch=SUMMARY_BATCH, device=dev,
                                        fold_backend=backend, setup=setup,
                                        device_plane=plane)
                r["launches"]["fold"] = (overlay_fold_kernel.launches
                                         - folds["launches"])
                role = r["role"]
                n_plane = role._m_plane_folds.value - folds["before"]
                mans = cs.manifests_of(shared, "columnar")
                store = open_summary_store(shared)
                rows, man = {}, {}
                for m in mans:
                    blob = store.get(m["handle"])
                    rows.setdefault(m["doc"], []).append(hashlib.sha256(
                        json.dumps(json.loads(blob.decode())["rows"],
                                   sort_keys=True).encode()).hexdigest())
                    man.setdefault(m["doc"], []).append(
                        [m["seq"], m["count"], m["handle"]])
                label = f"phase 31 {backend} plane {plane}"
                for doc in streams:
                    if rows.get(doc) != want_rows[doc]:
                        raise AssertionError(f"{label}: {doc}'s blob rows "
                                             f"differ from fold_golden.json")
                    if doc in fgold["manifests"] and \
                            man[doc] != fgold["manifests"][doc]:
                        raise AssertionError(f"{label}: {doc}'s manifests "
                                             f"differ from fold_golden.json")
                if (n_plane > 0) != (plane is not None):
                    raise AssertionError(f"{label}: summary_plane_folds_"
                                         f"total counted {n_plane}")
                files[plane] = (mans, {m["handle"]: store.get(m["handle"])
                                       for m in mans})
                p = role.device_plane()
                runs[f"{backend}_{plane or 'none'}"] = dict(
                    seconds=r["seconds"], summaries=len(mans),
                    records=r["records"], launches=r["launches"],
                    plane_folds=n_plane,
                    plane=None if p is None else p.describe())
            if files[None] != files[PLANE_SPEC]:
                raise AssertionError(f"phase 31 {backend}: the plane's "
                                     f"manifests or blobs differ from the "
                                     f"plane-less run's")
            a, b = (runs[f"{backend}_none"],
                    runs[f"{backend}_{PLANE_SPEC}"])
            log(f"summary role on a {PLANE_SPEC} device plane of {dev} "
                f"({backend} backend): config15's {len(streams)} documents, "
                f"{b['records']} records, {b['summaries']} summaries in "
                f"{b['seconds']:.3f}s (without a plane {a['seconds']:.3f}s); "
                f"every blob and manifest byte for byte the plane-less "
                f"run's and fold_golden.json's; summary_plane_folds_total "
                f"{b['plane_folds']:.0f}; launches {b['launches']} "
                f"(without a plane {a['launches']})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 31 {time.perf_counter() - t31:.2f}s")
    return runs


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=500_000,
                    help="ops of the main-path and row-model replays (a "
                         "multiple of 100000 below 1M is gated on its "
                         "stage digest; 1000000 replays the whole stream)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "fluidframework_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(fluidframework_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
    from fluidframework_tpu_torch.core.overlay_replay import (
        OverlayDeviceReplica, replay_docs, restore_shard, stack_replicas,
    )
    from fluidframework_tpu_torch.interop import (
        opbatch_from_numpy, segment_table_from_numpy,
        segment_table_to_numpy as interop_segment, table_from_numpy,
    )
    from fluidframework_tpu_torch.ops.mergetree_chunk import (
        apply_chunk_ref, kernel_geometry, mergetree_chunk_kernel,
    )
    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        ERR_BAD_POS, ERR_CAPACITY, NO_CLIENT, NO_KEY, NOT_REMOVED,
        OP_ANNOTATE, OP_INSERT, OP_NOOP, OP_REMOVE, PROP_ABSENT, OpBatch,
        SegmentTable,
    )
    from fluidframework_tpu_torch.ops.overlay import (
        KERNEL_THREADS, OverlayTable, fold_device, make_overlay_table,
        ops_at, overlay_apply_chunk, overlay_apply_chunk_ref,
        overlay_chunk_kernel, overlay_fold_kernel,
    )
    from fluidframework_tpu_torch.ops.mergetree_scan import (
        mergetree_scan_kernel,
    )
    from fluidframework_tpu_torch.ops.sequencer_kernel import (
        sequencer_step_kernel,
    )
    from fluidframework_tpu_torch.ops.zamboni import (
        STREAM_BASE as STREAM_BASE_C, compact_gather_text_ref,
    )
    from fluidframework_tpu_torch.ops.zamboni_kernel import (
        compaction_kernel, zamboni_kernel,
    )
    from fluidframework_tpu_torch.tree.rebase_kernel import rebase_kernel
    from fluidframework_tpu_torch.testing.block_edges import block_edge_chunks
    from fluidframework_tpu_torch.testing.digest import state_digest
    from fluidframework_tpu_torch.testing.overlay_edges import (
        overlay_edge_chunks, widen_prop_slots,
    )
    from fluidframework_tpu_torch.testing.golden import (
        DOC_SEEDS, golden_digest, lagged_stream, load_golden, stream_prefix,
    )

    # ---- 1. device ---------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    golden = load_golden()
    initial_len = golden["params"]["initial_len"]
    row_ops = min(args.ops, ROW_OPS)
    want, want_row = golden_digest(golden, args.ops), golden_digest(
        golden, row_ops)
    if want is None or want_row is None:
        raise AssertionError(
            f"GOLDEN.json pins no digest at {args.ops} or {row_ops} ops")

    # ---- 2. build, and the headline stream beside it -----------------
    full = build_and_stream(golden, log)
    stream = stream_prefix(full, args.ops)

    def replica() -> OverlayDeviceReplica:
        return OverlayDeviceReplica(
            stream, initial_len=initial_len, chunk_size=CHUNK,
            window=WINDOW, n_removers=N_REMOVERS,
            n_prop_keys=N_PROP_KEYS, device=dev,
        )

    # ---- 3. kernel vs its plain version ------------------------------
    max_err = 0

    def compare(tin: OverlayTable, ops: OpBatch, label: str,
                layout: str = None):
        """Kernel A (in the launcher's layout, or the one asked for) on
        one document against its plain version, exactly."""
        return hold(overlay_chunk_kernel(tin, ops, layout), tin, ops, label)

    def hold(out_k: OverlayTable, tin: OverlayTable, ops: OpBatch,
             label: str):
        """One document's kernel output `out_k` against the plain
        version on the same inputs: n_rows, error and rows [:n_rows]."""
        nonlocal max_err
        out_r = overlay_apply_chunk_ref(tin, ops)
        torch.cuda.synchronize()
        n_k, n_r = int(out_k.n_rows), int(out_r.n_rows)
        e_k, e_r = int(out_k.error), int(out_r.error)
        if (n_k, e_k) != (n_r, e_r):
            raise AssertionError(
                f"{label}: kernel n_rows/error {n_k}/{e_k} != plain "
                f"{n_r}/{e_r}")
        m = min(n_r, tin.length.shape[-1])
        for name in ("anchor", "buf_start", "length", "ins_seq",
                     "ins_client", "rem_seq", "rem_clients", "props"):
            a = getattr(out_k, name)[:m].to(torch.int64)
            b = getattr(out_r, name)[:m].to(torch.int64)
            diff = int((a - b).abs().max()) if m else 0
            max_err = max(max_err, diff)
            if diff:
                row = int((a != b).reshape(m, -1).any(1).nonzero()[0])
                raise AssertionError(
                    f"{label}: column {name} differs first at row {row}")
        return out_k, n_r, e_r

    rep = replica()
    rep.prepare()
    ops_all = rep._dev
    table = rep.table
    checked, chunk_outs = [], []
    for ci in range(min(CHECK_CHUNKS, rep.n_chunks)):
        batch = ops_all.slice(ci * CHUNK, (ci + 1) * CHUNK)
        out, n, e = compare(table, batch, f"chunk {ci}")
        checked.append((table, batch))
        chunk_outs.append((out, rep._msn_by_chunk[ci]))
        if e:
            raise AssertionError(f"chunk {ci}: error flags {e} on a valid stream")
        table, _, _ = fold_device(out, rep._msn_by_chunk[ci])
    log(f"kernel == plain on {len(checked)} stream chunks "
        f"(rows up to {max(int(t.n_rows) for t, _ in checked)} in)")

    def crowded_chunk(W: int, base: int, B: int, KR: int, KK: int):
        """`base` one-character text rows in a window of W, and a chunk
        of B ops: three inserts to one remove at random positions, each
        op seeing the ones before it."""
        g = torch.Generator().manual_seed(SEED)
        cols = dict(
            anchor=torch.zeros(W, dtype=torch.int32),
            buf_start=torch.arange(W, dtype=torch.int32),
            length=torch.ones(W, dtype=torch.int32),
            ins_seq=torch.arange(1, W + 1, dtype=torch.int32),
            ins_client=torch.ones(W, dtype=torch.int32),
            rem_seq=torch.full((W,), NOT_REMOVED, dtype=torch.int32),
        )
        table = OverlayTable(
            n_rows=torch.tensor(base, dtype=torch.int32),
            rem_clients=torch.full((W, KR), -3, dtype=torch.int32),
            props=torch.full((W, KK), -1, dtype=torch.int32),
            settled_len=torch.tensor(0, dtype=torch.int32),
            error=torch.tensor(0, dtype=torch.int32), **cols,
        ).to(dev)
        i = torch.arange(B, dtype=torch.int32)
        kinds = torch.where(i % 4 == 3, OP_REMOVE, OP_INSERT).to(torch.int32)
        pos = (torch.rand(B, generator=g) * base).to(torch.int32)
        ops = OpBatch(
            op_type=kinds, pos1=pos, pos2=pos + 2,
            seq=base + 1 + i, ref_seq=base + i, client=2 + i % 3,
            buf_start=torch.zeros(B, dtype=torch.int32),
            ins_len=torch.ones(B, dtype=torch.int32),
            prop_keys=torch.full((B, 1), -1, dtype=torch.int32),
            prop_vals=torch.full((B, 1), -1, dtype=torch.int32),
        ).to(dev)
        return table, ops

    # A window that overflows: W-8 text rows, then inserts and removes.
    W = WINDOW
    over_table, over_ops = crowded_chunk(W, W - 8, CHUNK, N_REMOVERS,
                                         N_PROP_KEYS)
    _, n, e = compare(over_table, over_ops, "capacity chunk")
    if not e & ERR_CAPACITY:
        raise AssertionError("capacity chunk did not raise ERR_CAPACITY")
    log(f"kernel == plain on the overflow chunk (n_rows {n} > window "
        f"{W}, error {e})")

    # Positions past the visible length: the next stream chunk with one
    # insert and one remove pushed out of range.
    ci = len(checked)
    bad = ops_all.slice(ci * CHUNK, (ci + 1) * CHUNK)
    bad = OpBatch(*(getattr(bad, f).clone() for f in bad.__dataclass_fields__))
    types = bad.op_type.tolist()
    k_ins = types.index(OP_INSERT)
    k_rem = types.index(OP_REMOVE)
    bad.pos1[k_ins] += 1_000_000
    bad.pos2[k_rem] += 1_000_000
    _, n, e = compare(table, bad, "bad-position chunk")
    if not e & ERR_BAD_POS:
        raise AssertionError("bad-position chunk did not raise ERR_BAD_POS")
    log(f"kernel == plain on the bad-position chunk (error {e})")

    # The slot heap's edges: shifts at row 0 and at the window's top,
    # gap loops, split halves, rows created and dropped.
    edges = overlay_edge_chunks(W, N_REMOVERS, N_PROP_KEYS, 1, CHUNK)
    for case in edges:
        tin = table_from_numpy(case["table"], dev)
        ops = opbatch_from_numpy(case["ops"], dev)
        compare(tin, ops, f"edge chunk {case['name']}")
    log(f"kernel == plain on the {len(edges)} edge chunks")

    # Time the kernel and the plain version on the checked chunks.
    plan = overlay_chunk_kernel.plan(W, N_REMOVERS, N_PROP_KEYS, CHUNK, 1)
    log(f"overlay_chunk geometry: {plan.layout} layout, {KERNEL_THREADS} "
        f"threads x {plan.rows_per_thread} rows, {plan.smem_bytes} shared "
        f"bytes, heap {W} rows x {plan.heap_ints} ints")

    def time_overlay(pairs, reps: int, layout: str = None) -> float:
        """Kernel A's mean ms per launch over `pairs`, CUDA events (in
        the launcher's layout, or the one asked for)."""
        for tin, batch in pairs:  # warm-up
            overlay_chunk_kernel(tin, batch, layout)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(reps):
            for tin, batch in pairs:
                overlay_chunk_kernel(tin, batch, layout)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / (reps * len(pairs))

    kernel_ms = time_overlay(checked, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tin, batch in checked[:4]:
        overlay_apply_chunk_ref(tin, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / min(4, len(checked))
    # Least time for the same work: the table in and out once and the
    # ops in once, against the HBM rate; the per-row int32 work of each
    # op over the live rows, against the vector rate.
    KRK = N_REMOVERS + N_PROP_KEYS
    nbytes = 4 * (2 * (W * (6 + KRK) + 3) + CHUNK * (8 + 2))
    n_ops_int = sum(
        int(t.n_rows) * int((b.op_type != 3).sum()) * INT_OPS_PER_ROW
        for t, b in checked) / len(checked)
    bound_ms = max(nbytes / PEAK_BYTES_S, n_ops_int / PEAK_OPS_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= n_ops_int / PEAK_OPS_S \
        else "operations"
    log(f"overlay_chunk: {kernel_ms:.4f} ms/chunk (kernel, CUDA events), "
        f"plain {plain_ms:.2f} ms/chunk, bound {bound_ms:.6f} ms "
        f"({bound_by})")

    # ---- 3 (b). the fold kernel vs its plain versions -------------------
    fold_k = fold_kernel_phase(dev, chunk_outs, log)
    del chunk_outs

    # ---- 4. the main path --------------------------------------------
    rep = replica()
    rep.prepare()
    torch.cuda.synchronize()
    overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
    t0 = time.perf_counter()
    rep.replay()
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    launches = overlay_chunk_kernel.launches
    launches_f = overlay_fold_kernel.launches
    if launches != rep.n_chunks or launches_f != rep.n_chunks:
        raise AssertionError(
            f"kernel A launches {launches}, fold launches {launches_f} != "
            f"chunks {rep.n_chunks}")
    rep.check_errors()
    log(f"replay: {args.ops} ops in {t_replay:.3f}s = "
        f"{args.ops / t_replay:,.0f} ops/s, "
        f"{t_replay * 1e3 / rep.n_chunks:.4f} ms/chunk over "
        f"{rep.n_chunks} chunks (launches: kernel A {launches}, the fold "
        f"{launches_f}: two a chunk); residual "
        f"rows {int(rep.table.n_rows)}, settled len "
        f"{int(rep.table.settled_len)}, fold records {int(rep.cursor)}")
    t0 = time.perf_counter()
    rep.verify_invariants()
    digest = state_digest(rep.annotated_spans())
    log(f"readout: {time.perf_counter() - t0:.2f}s; digest {digest}")
    if digest != want:
        raise AssertionError(
            f"digest {digest} != GOLDEN.json {want} at {args.ops} ops")
    log(f"digest matches GOLDEN.json at {args.ops} ops")

    # ---- 5. row-model kernel vs its plain version --------------------
    row_stream = stream_prefix(full, row_ops)
    max_err_b = 0

    def row_replica() -> ColumnarReplica:
        return ColumnarReplica(
            row_stream, initial_len=initial_len, chunk_size=CHUNK,
            capacity=ROW_CAPACITY, n_removers=N_REMOVERS,
            n_prop_keys=N_PROP_KEYS, sync_interval=ROW_SYNC, device=dev,
        )

    def compare_row(tin: SegmentTable, ops: OpBatch, label: str):
        nonlocal max_err_b
        out_k = mergetree_chunk_kernel(tin, ops)
        out_r = apply_chunk_ref(tin, ops)
        torch.cuda.synchronize()
        n_k, n_r = int(out_k.n_rows), int(out_r.n_rows)
        e_k, e_r = int(out_k.error), int(out_r.error)
        if (n_k, e_k) != (n_r, e_r):
            raise AssertionError(
                f"{label}: kernel n_rows/error {n_k}/{e_k} != plain "
                f"{n_r}/{e_r}")
        for name in ("buf_start", "length", "ins_seq", "ins_client",
                     "rem_seq", "rem_clients", "props"):
            a = getattr(out_k, name)[:n_r].to(torch.int64)
            b = getattr(out_r, name)[:n_r].to(torch.int64)
            diff = int((a - b).abs().max()) if n_r else 0
            max_err_b = max(max_err_b, diff)
            if diff:
                row = int((a != b).reshape(n_r, -1).any(1).nonzero()[0])
                raise AssertionError(
                    f"{label}: column {name} differs first at row {row}")
        return out_k, n_r, e_r

    max_err_c, held_c = 0, 0

    def compare_compaction(tin: SegmentTable, msn: int, arena_in, text,
                           label: str):
        """The compaction kernel against `compact_gather_text_ref` on the
        card, exactly: every field of the whole table (the kernel writes
        every row), n_rows, error and the whole new arena."""
        nonlocal max_err_c, held_c
        out_k, arena_k = compaction_kernel(tin, msn, arena_in, text)
        out_r, arena_r = compact_gather_text_ref(tin, msn, arena_in, text)
        torch.cuda.synchronize()
        for name in ("n_rows", "error", "buf_start", "length", "ins_seq",
                     "ins_client", "rem_seq", "rem_clients", "props"):
            a = getattr(out_k, name).to(torch.int64)
            b = getattr(out_r, name).to(torch.int64)
            diff = int((a - b).abs().max()) if a.numel() else 0
            max_err_c = max(max_err_c, diff)
            if diff:
                raise AssertionError(f"{label}: {name} differs from the "
                                     f"plain version (max |diff| {diff})")
        diff = int((arena_k.to(torch.int64) - arena_r).abs().max())
        max_err_c = max(max_err_c, diff)
        if diff:
            at = int((arena_k != arena_r).nonzero()[0])
            raise AssertionError(f"{label}: the new arena differs from the "
                                 f"plain version first at element {at}")
        held_c += 1
        return out_k, arena_k

    rrep = row_replica()
    rrep._prepare_text()
    row_ops_dev = rrep.op_segment(0, row_ops)  # NOOP-padded past row_ops

    def row_chunk(ci: int) -> OpBatch:
        return row_ops_dev.slice(ci * CHUNK, (ci + 1) * CHUNK)

    table_b, arena = rrep.table, rrep.arena
    early = []
    for ci in range(min(CHECK_CHUNKS, rrep.n_chunks)):
        batch = row_chunk(ci)
        out, n, e = compare_row(table_b, batch, f"row chunk {ci}")
        early.append((table_b, batch))
        if e:
            raise AssertionError(f"row chunk {ci}: error flags {e}")
        table_b = out
        if (ci + 1) % ROW_SYNC == 0:
            msn = int(row_stream.min_seq[(ci + 1) * CHUNK - 1])
            table_b, arena = compare_compaction(
                table_b, msn, arena, rrep.stream_text,
                f"compaction after row chunk {ci}")
    log(f"row kernel == plain on {len(early)} stream chunks (rows up to "
        f"{max(int(t.n_rows) for t, _ in early)} in); compaction kernel == "
        f"compact_gather_text_ref on the card at its {held_c} compactions, "
        f"exactly (the whole table, n_rows, error and the whole arena of "
        f"{arena.shape[0]} ints)")

    # A full table: C rows of one character, then inserts at the end
    # (no landing row: the Pallas kernel's silent drop, flagged here)
    # and in the middle, and a remove.
    C = ROW_CAPACITY
    i_c = torch.arange(C, dtype=torch.int32)
    full_table = SegmentTable(
        n_rows=torch.tensor(C, dtype=torch.int32),
        buf_start=i_c.clone(), length=torch.ones(C, dtype=torch.int32),
        ins_seq=i_c + 1, ins_client=i_c % 5,
        rem_seq=torch.full((C,), NOT_REMOVED, dtype=torch.int32),
        rem_clients=torch.full((C, N_REMOVERS), NO_CLIENT, dtype=torch.int32),
        props=torch.full((C, N_PROP_KEYS), PROP_ABSENT, dtype=torch.int32),
        error=torch.tensor(0, dtype=torch.int32),
    ).to(dev)
    i = torch.arange(CHUNK, dtype=torch.int32)
    kinds = torch.full((CHUNK,), OP_NOOP, dtype=torch.int32)
    kinds[:3] = torch.tensor([OP_INSERT, OP_INSERT, OP_REMOVE])
    full_ops = OpBatch(
        op_type=kinds, pos1=torch.tensor([C, C // 2, 10] + [0] * (CHUNK - 3),
                                         dtype=torch.int32),
        pos2=torch.tensor([0, 0, 20] + [0] * (CHUNK - 3), dtype=torch.int32),
        seq=C + 1 + i, ref_seq=C + i, client=7 + i % 3,
        buf_start=torch.zeros(CHUNK, dtype=torch.int32),
        ins_len=torch.ones(CHUNK, dtype=torch.int32),
        prop_keys=torch.full((CHUNK, 1), NO_KEY, dtype=torch.int32),
        prop_vals=torch.full((CHUNK, 1), PROP_ABSENT, dtype=torch.int32),
    ).to(dev)
    _, n, e = compare_row(full_table, full_ops, "row full-table chunk")
    if not e & ERR_CAPACITY:
        raise AssertionError("row full-table chunk: no ERR_CAPACITY")
    end_only = OpBatch(*(getattr(full_ops, f).clone()
                         for f in full_ops.__dataclass_fields__))
    end_only.op_type[1:] = OP_NOOP
    _, n2, e2 = compare_row(full_table, end_only, "row full-table end insert")
    if e2 != ERR_CAPACITY or n2 != C:
        raise AssertionError(
            f"row end insert into a full table: error {e2}, n_rows {n2}")
    log(f"row kernel == plain on the full-table chunks (n_rows {n}, error "
        f"{e}; the end insert alone: error {e2})")

    # Positions past the visible length: the next stream chunk with one
    # insert and one remove pushed out of range.
    bad = row_chunk(len(early))
    bad = OpBatch(*(getattr(bad, f).clone() for f in bad.__dataclass_fields__))
    types = bad.op_type.tolist()
    bad.pos1[types.index(OP_INSERT)] += 1_000_000
    bad.pos2[types.index(OP_REMOVE)] += 1_000_000
    _, n, e = compare_row(table_b, bad, "row bad-position chunk")
    if not e & ERR_BAD_POS:
        raise AssertionError("row bad-position chunk did not raise ERR_BAD_POS")
    log(f"row kernel == plain on the bad-position chunk (error {e})")

    # The block edges of the kernel's grid at the bench geometry.
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_g, grid_r, grid_smem = kernel_geometry(
        C, N_REMOVERS, N_PROP_KEYS, CHUNK, 1, n_sms)
    edge_cases = block_edge_chunks(grid_r, C, N_REMOVERS, N_PROP_KEYS, 1,
                                   CHUNK)
    for case in edge_cases:
        tin = segment_table_from_numpy(case["table"], dev)
        ops = opbatch_from_numpy(case["ops"], dev)
        _, n, e = compare_row(tin, ops, f"row block-edge chunk {case['name']}")
        n_in = int(case["table"]["n_rows"])
        if n_in >= C - 1:
            if not e & ERR_CAPACITY:
                raise AssertionError(
                    f"block-edge chunk {case['name']}: no ERR_CAPACITY")
        elif e or n <= n_in:
            raise AssertionError(
                f"block-edge chunk {case['name']}: error {e}, n_rows {n}")
    log(f"row kernel == plain on the {len(edge_cases)} block-edge chunks "
        f"(R = {grid_r})")

    # ---- 6. the row-model path ----------------------------------------
    rrep = row_replica()
    n_chunks_b = rrep.n_chunks
    deep_lo = (n_chunks_b - DEEP_CHUNKS) // ROW_SYNC * ROW_SYNC
    torch.cuda.synchronize()
    mergetree_chunk_kernel.launches = 0
    compaction_kernel.launches = 0
    t0 = time.perf_counter()
    rrep.replay(limit_chunks=deep_lo)
    deep_table, deep_arena = rrep.table, rrep.arena
    rrep.replay()
    torch.cuda.synchronize()
    t_row = time.perf_counter() - t0
    launches_b = mergetree_chunk_kernel.launches
    launches_c = compaction_kernel.launches
    if launches_b != n_chunks_b:
        raise AssertionError(
            f"row kernel launches {launches_b} != chunks {n_chunks_b}")
    if (launches_c != rrep.compactions * compaction_kernel.LAUNCHES
            or not launches_c):
        raise AssertionError(
            f"compaction kernel launches {launches_c} != {rrep.compactions} "
            f"compactions x {compaction_kernel.LAUNCHES}")
    rrep.check_errors()
    log(f"row replay: {row_ops} ops in {t_row:.3f}s = "
        f"{row_ops / t_row:,.0f} ops/s, {t_row * 1e3 / n_chunks_b:.4f} "
        f"ms/chunk over {n_chunks_b} chunks (kernel launches {launches_b}, "
        f"compactions {rrep.compactions}, compaction kernel launches "
        f"{launches_c} = {compaction_kernel.LAUNCHES} a compaction); final "
        f"rows "
        f"{int(rrep.table.n_rows)} of capacity {rrep.capacity}; {smi}")
    t0 = time.perf_counter()
    rrep.verify_invariants()
    digest_b = state_digest(rrep.annotated_spans())
    log(f"row readout: {time.perf_counter() - t0:.2f}s; digest {digest_b}")
    if digest_b != want_row:
        raise AssertionError(
            f"row digest {digest_b} != GOLDEN.json {want_row} at {row_ops} ops")
    log(f"row digest matches GOLDEN.json at {row_ops} ops")

    # ---- 7. the deep chunks: kernel vs plain, timed ---------------------
    deep = []
    table_b = deep_table
    comp_at = min(deep_lo + ROW_SYNC, n_chunks_b)  # the replay compacts here
    for ci in range(deep_lo, n_chunks_b):
        batch = row_chunk(ci)
        out, n, e = compare_row(table_b, batch, f"row deep chunk {ci}")
        deep.append((table_b, batch))
        if e:
            raise AssertionError(f"row deep chunk {ci}: error flags {e}")
        table_b = out
        if ci + 1 == comp_at:
            comp_in = table_b
    log(f"row kernel == plain on the last {len(deep)} chunks (rows "
        f"{int(deep[0][0].n_rows)} in)")

    def time_kernel(pairs, reps):
        for tin, batch in pairs:  # warm-up
            mergetree_chunk_kernel(tin, batch)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for _ in range(reps):
            for tin, batch in pairs:
                mergetree_chunk_kernel(tin, batch)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / (reps * len(pairs))

    kernel_ms_b = time_kernel(deep, 3)
    early_ms_b = time_kernel(early, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tin, batch in deep:
        apply_chunk_ref(tin, batch)
    torch.cuda.synchronize()
    plain_ms_b = (time.perf_counter() - t0) * 1e3 / len(deep)
    # Least time for the same work: the live table in and out once and
    # the ops in once, against the HBM rate; the int32 work of each op's
    # passes over the live rows, against the int32 rate.
    width = 5 + N_REMOVERS + N_PROP_KEYS
    nbytes_b = sum(4 * (2 * int(t.n_rows) * width + CHUNK * 10)
                   for t, _ in deep) / len(deep)

    def passes(b: OpBatch) -> int:
        n_ins = int((b.op_type == OP_INSERT).sum())
        n_range = int(((b.op_type == OP_REMOVE)
                       | (b.op_type == OP_ANNOTATE)).sum())
        return PASSES_INSERT_B * n_ins + PASSES_RANGE_B * n_range

    n_int_b = sum(int(t.n_rows) * passes(b) * INT_OPS_PER_PASS_B
                  for t, b in deep) / len(deep)
    bound_ms_b = max(nbytes_b / PEAK_BYTES_S, n_int_b / PEAK_OPS_S) * 1e3
    bound_by_b = ("bytes" if nbytes_b / PEAK_BYTES_S >= n_int_b / PEAK_OPS_S
                  else "operations")
    log(f"mergetree_chunk: {kernel_ms_b:.4f} ms/chunk on the last "
        f"{len(deep)} chunks (kernel, CUDA events; {early_ms_b:.4f} ms on "
        f"the first {len(early)}), plain {plain_ms_b:.2f} ms/chunk, bound "
        f"{bound_ms_b:.6f} ms ({bound_by_b})")

    # The replay's compaction after the first deep chunks: kernel against
    # the plain version again, then each timed (the kernel behind a spin;
    # both also by CUDA events around back-to-back calls, the host's
    # enqueue included, as on the path).
    comp_msn = int(row_stream.min_seq[min(comp_at * CHUNK, row_ops) - 1])
    comp_args = (comp_in, comp_msn, deep_arena, rrep.stream_text)
    comp_out, _ = compare_compaction(*comp_args,
                                     f"deep compaction after chunk {comp_at}")

    comp_ms = spin_time(lambda: compaction_kernel(*comp_args), SCAN_TIME_REPS)
    comp_path_ms = events_ms(lambda: compaction_kernel(*comp_args),
                             SCAN_TIME_REPS)
    comp_plain_ms = events_ms(lambda: compact_gather_text_ref(*comp_args),
                              SCAN_TIME_REPS)
    comp_launches_per_call = compaction_kernel.LAUNCHES
    host_in = interop_segment(comp_in)
    live_c = min(int(host_in["n_rows"]), ROW_CAPACITY)
    rem_c = host_in["rem_seq"][:live_c]
    kept_mask = (rem_c == NOT_REMOVED) | (rem_c > comp_msn)
    kept_c = int(np.count_nonzero(kept_mask))
    runs_c = int(comp_out.n_rows)
    buf_c = host_in["buf_start"][:live_c][kept_mask].astype(np.int64)
    len_c = host_in["length"][:live_c][kept_mask].astype(np.int64)
    A_c, S_c = deep_arena.shape[0], rrep.stream_text.shape[0]
    in_doc = (buf_c >= 0) & (buf_c < A_c)
    in_st = (buf_c >= STREAM_BASE_C) & (buf_c < STREAM_BASE_C + S_c)
    moved_c = int(np.minimum(len_c, A_c - buf_c)[in_doc].sum()
                  + np.minimum(len_c, STREAM_BASE_C + S_c - buf_c)[in_st]
                  .sum())
    cols_c = 5 + N_REMOVERS + N_PROP_KEYS
    b_c = 4 * (live_c + kept_c * (3 + N_PROP_KEYS) + runs_c
               * (1 + N_REMOVERS) + ROW_CAPACITY * cols_c + moved_c + A_c
               + 5) / PEAK_BYTES_S
    o_c = (ZAMBONI_OPS_LIVE * live_c + (ZAMBONI_OPS_KEPT + N_PROP_KEYS)
           * kept_c + ZAMBONI_OPS_RUN * runs_c + ROW_CAPACITY * cols_c
           + A_c) / PEAK_OPS_S
    comp_bound_ms = max(b_c, o_c) * 1e3
    comp_bound_by = "bytes" if b_c >= o_c else "operations"
    log(f"compaction per call (compact_gather_text, {comp_launches_per_call} "
        f"launches; the replay's compaction after chunk {comp_at}: C "
        f"{ROW_CAPACITY}, {live_c} live rows, {kept_c} kept, {runs_c} runs, "
        f"{moved_c} text ints moved into an arena of {A_c}): kernel "
        f"{comp_ms:.6f} ms (CUDA events behind a spin, {SCAN_TIME_REPS} "
        f"calls), {comp_path_ms:.6f} ms back to back; the plain version "
        f"(torch ops on the card, the parent's path) {comp_plain_ms:.6f} ms "
        f"back to back; bound {comp_bound_ms:.6f} ms ({comp_bound_by}), "
        f"share {comp_bound_ms / comp_ms:.4f}; the three-launch design "
        f"{COMPACTION_THREE_LAUNCH_MS:.6f} ms; {smi}")

    n_ins_d = sum(int((b.op_type == OP_INSERT).sum()) for _, b in deep)
    n_rng_d = sum(int(((b.op_type == OP_REMOVE)
                       | (b.op_type == OP_ANNOTATE)).sum()) for _, b in deep)
    log(f"mergetree_chunk grid: G {grid_g} blocks x R {grid_r} rows "
        f"({n_sms} SMs), {grid_smem} shared bytes per block, grid barriers "
        f"per op 2 (insert) / 3 (remove, annotate): "
        f"{(2 * n_ins_d + 3 * n_rng_d) / max(1, n_ins_d + n_rng_d):.3f} "
        f"per op on the deep chunks")

    # ---- 8. many documents' streams, generated in the background -----
    params = golden["params"]
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    f_docs = [pool.submit(lagged_stream, seed, DOC_OPS, params)
              for seed in DOC_SEEDS]
    t_gen = time.perf_counter()

    # ---- 9. kernel A's layouts vs its plain version -------------------
    layouts = []

    def layouts_at(W, B, KR, KK, PK):
        """The launcher's layout at this shape first, then the other one
        where the launcher takes it (the shared layout only fits up to
        R_SHARED_MAX rows a thread and the block's shared bytes)."""
        chosen = overlay_chunk_kernel.plan(W, KR, KK, B, PK).layout
        other = "global" if chosen == "shared" else "shared"
        try:
            overlay_chunk_kernel.plan(W, KR, KK, B, PK, layout=other)
        except RuntimeError:
            return [chosen]
        return [chosen, other]

    def check_layout(W, B, KR, KK, PK, n_check):
        """The first stream chunks (prop slots widened to PK) and the
        edge chunks, kernel vs plain, exactly, in every layout the
        launcher takes at this shape; then each layout's time on the
        same stream chunks."""
        rep = OverlayDeviceReplica(
            stream_prefix(full, n_check * B), initial_len=initial_len,
            chunk_size=B, window=W, n_removers=KR, n_prop_keys=KK,
            device=dev)
        rep.prepare()
        which = layouts_at(W, B, KR, KK, PK)
        pairs, tin = [], rep.table
        for ci in range(rep.n_chunks):
            ops = widen_prop_slots(rep._dev.slice(ci * B, (ci + 1) * B), PK)
            for lay in which:
                out, _, _ = compare(tin, ops, f"W {W} B {B} chunk {ci} {lay}",
                                    lay)
            pairs.append((tin, ops))
            tin, _, _ = fold_device(out, rep._msn_by_chunk[ci])
        edges = overlay_edge_chunks(W, KR, KK, PK, B)
        for case in edges:
            for lay in which:
                compare(table_from_numpy(case["table"], dev),
                        opbatch_from_numpy(case["ops"], dev),
                        f"W {W} B {B} edge chunk {case['name']} {lay}", lay)
        for lay in which:
            plan = overlay_chunk_kernel.plan(W, KR, KK, B, PK, layout=lay)
            ms = time_overlay(pairs, 5, lay)
            layouts.append(dict(W=W, B=B, KR=KR, KK=KK, PK=PK,
                                layout=lay, chosen=lay == which[0],
                                smem_bytes=plan.smem_bytes,
                                ms=ms, us_per_op=1e3 * ms / B,
                                checked_chunks=len(pairs) + len(edges)))
            log(f"overlay_chunk W {W} B {B} KR {KR} KK {KK} PK {PK}: "
                f"{lay} layout{' (chosen)' if lay == which[0] else ''} "
                f"({plan.smem_bytes} shared bytes), kernel == plain on "
                f"{len(pairs)} stream + {len(edges)} edge chunks; "
                f"{ms:.4f} ms/chunk = {1e3 * ms / B:.3f} us/op (CUDA events)")

    for W_, B_, KR_, KK_, PK_ in LAYOUT_SHAPES:
        check_layout(W_, B_, KR_, KK_, PK_, max(2, min(4, 4096 // B_)))

    # Both layouts on the same chunks at every R = W / 1024 the shared
    # layout takes: the first stream chunks (few live rows) and a window
    # filled to W - 2B rows, exactly and timed.
    sweep = []
    for R in LAYOUT_SWEEP_R:
        W_ = 1024 * R
        if layouts_at(W_, SWEEP_B, N_REMOVERS, N_PROP_KEYS, 1) != [
                "shared", "global"]:
            continue
        rep_s = OverlayDeviceReplica(
            stream_prefix(full, SWEEP_CHUNKS * SWEEP_B),
            initial_len=initial_len, chunk_size=SWEEP_B, window=W_,
            n_removers=N_REMOVERS, n_prop_keys=N_PROP_KEYS, device=dev)
        rep_s.prepare()
        few, tin = [], rep_s.table
        for ci in range(rep_s.n_chunks):
            ops = rep_s._dev.slice(ci * SWEEP_B, (ci + 1) * SWEEP_B)
            for lay in ("shared", "global"):
                out, _, _ = compare(tin, ops, f"sweep W {W_} chunk {ci} {lay}",
                                    lay)
            few.append((tin, ops))
            tin, _, _ = fold_device(out, rep_s._msn_by_chunk[ci])
        crowd = [crowded_chunk(W_, W_ - 2 * SWEEP_B, SWEEP_B, N_REMOVERS,
                               N_PROP_KEYS)]
        for lay in ("shared", "global"):
            _, _, e = compare(*crowd[0], f"sweep W {W_} crowded {lay}", lay)
            if e:
                raise AssertionError(f"sweep W {W_} crowded chunk: error {e}")
        row = dict(W=W_, R=R, B=SWEEP_B, live_rows_few=max(
            int(t.n_rows) for t, _ in few), live_rows_crowded=W_ - 2 * SWEEP_B)
        for lay in ("shared", "global"):
            row[f"{lay}_ms_few"] = time_overlay(few, 5, lay)
            row[f"{lay}_ms_crowded"] = time_overlay(crowd, 20, lay)
        sweep.append(row)
        log(f"layouts at W {W_} (R {R}), B {SWEEP_B}, same chunks: "
            f"{len(few)} stream chunks (up to {row['live_rows_few']} rows) "
            f"shared {row['shared_ms_few']:.4f} / global "
            f"{row['global_ms_few']:.4f} ms/chunk; crowded ({W_ - 2 * SWEEP_B}"
            f" rows) shared {row['shared_ms_crowded']:.4f} / global "
            f"{row['global_ms_crowded']:.4f} ms/chunk (CUDA events)")

    # The bench chunks again with the hot columns in the global layout
    # (W 8192 at chunks of 256 does not fit a block's shared memory):
    # the same ops over the same live rows as `kernel_ms`.
    glob_pairs = []
    tin = make_overlay_table(GLOBAL_W, N_REMOVERS, N_PROP_KEYS,
                             settled_len=initial_len, device=dev)
    for ci, (_, batch) in enumerate(checked):
        out, _, _ = compare(tin, batch, f"global bench chunk {ci}")
        glob_pairs.append((tin, batch))
        tin, _, _ = fold_device(out, rep._msn_by_chunk[ci])
    glob_plan = overlay_chunk_kernel.plan(GLOBAL_W, N_REMOVERS, N_PROP_KEYS,
                                          CHUNK, 1)
    glob_ms = time_overlay(glob_pairs, 20)
    layouts.append(dict(W=GLOBAL_W, B=CHUNK, KR=N_REMOVERS, KK=N_PROP_KEYS,
                        PK=1, layout=glob_plan.layout,
                        smem_bytes=glob_plan.smem_bytes, ms=glob_ms,
                        us_per_op=1e3 * glob_ms / CHUNK,
                        checked_chunks=len(glob_pairs)))
    log(f"overlay_chunk on the {len(checked)} bench chunks: shared layout "
        f"(W {WINDOW}) {kernel_ms:.4f} ms/chunk, {glob_plan.layout} layout "
        f"(W {GLOBAL_W}) {glob_ms:.4f} ms/chunk = {glob_ms / kernel_ms:.2f}x")

    # ---- 10. the replica at its default window and chunk ---------------
    golden_100k = golden_digest(golden, DOC_OPS)
    head = stream_prefix(full, DOC_OPS)
    drep = OverlayDeviceReplica(
        head, initial_len=initial_len, chunk_size=DEFAULT_CHUNK,
        window=DEFAULT_WINDOW, n_removers=N_REMOVERS,
        n_prop_keys=N_PROP_KEYS, device=dev)
    drep.prepare()
    torch.cuda.synchronize()
    overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
    t0 = time.perf_counter()
    drep.replay()
    torch.cuda.synchronize()
    t_def = time.perf_counter() - t0
    launches_def = overlay_chunk_kernel.launches
    launches_def_f = overlay_fold_kernel.launches
    if launches_def != drep.n_chunks or launches_def_f != drep.n_chunks:
        raise AssertionError(
            f"default replica: launches {launches_def} / {launches_def_f} "
            f"!= chunks {drep.n_chunks}")
    drep.check_errors()
    digest = state_digest(drep.annotated_spans())
    if digest != golden_100k:
        raise AssertionError(
            f"default replica digest {digest} != GOLDEN.json {golden_100k}")
    log(f"default replica (window {DEFAULT_WINDOW}, chunk {DEFAULT_CHUNK}, "
        f"{overlay_chunk_kernel.plan(DEFAULT_WINDOW, N_REMOVERS, N_PROP_KEYS, DEFAULT_CHUNK, 1).layout} "
        f"layout): {DOC_OPS} ops in {t_def:.3f}s = {DOC_OPS / t_def:,.0f} "
        f"ops/s, {t_def * 1e3 / drep.n_chunks:.4f} ms/chunk (kernel A "
        f"launches {launches_def}, fold launches {launches_def_f}); digest "
        f"matches GOLDEN.json at {DOC_OPS}")

    # ---- 11. many documents, one launch per chunk ----------------------
    t0 = time.perf_counter()
    distinct = [head] + [f.result() for f in f_docs]
    log(f"docs: {len(distinct) - 1} lagged streams of {DOC_OPS} ops "
        f"(seeds {DOC_SEEDS[0]}..{DOC_SEEDS[-1]}) generated in "
        f"{time.perf_counter() - t_gen:.2f}s ({time.perf_counter() - t0:.2f}s "
        f"waited); {len(distinct)} distinct streams tiled over "
        f"{max(DOC_COUNTS)} documents")

    def doc_replica(s) -> OverlayDeviceReplica:
        return OverlayDeviceReplica(
            s, initial_len=initial_len, chunk_size=CHUNK, window=WINDOW,
            n_removers=N_REMOVERS, n_prop_keys=N_PROP_KEYS, device=dev)

    # Each distinct stream's single-document replay: its error word and
    # outputs (table, log, counts, cursor), to which the docs replays
    # (here and phase 30 (b)) are held; doc 0's digest is read out. A
    # stream may have a row removed by more clients than the 24 remover
    # slots hold (seed 124's does, from its chunk 3); the replay flags
    # ERR_REMOVERS there as the JAX replica does
    # (tests/test_torch_overlay_removers.py), and the docs replay must
    # flag it alike.
    single, single_out = [], []
    for s_ in distinct:
        r = doc_replica(s_)
        r.replay()
        single.append(int(r.table.error))
        single_out.append((r.table, r.log, r.counts, r.cursor))
        if len(single) == 1:
            digest0 = state_digest(r.annotated_spans())
    if (digest0, single[0]) != (golden_100k, 0):
        raise AssertionError(f"doc 0 single replay (digest, error) "
                             f"{(digest0, single[0])} != GOLDEN.json "
                             f"{golden_100k}")
    n_flagged = sum(1 for e in single if e)
    log(f"single-document replays of the {len(single)} distinct streams: "
        f"{n_flagged} flag ERR_REMOVERS (more removers of a row than "
        f"{N_REMOVERS} slots); doc 0 has no error and matches GOLDEN.json")

    def hold_stacked(reps_d):
        """The docs path's own launches (one per chunk, all documents,
        as `replay_chunk_step`'s docs form makes them) held against the
        plain version per document, exactly: every document on the
        first chunk, LATE_DOCS distinct streams on the last chunk, and
        each document on the chunk where its error word first turns
        non-zero. Returns {stream index: (first error chunk, error)}."""
        tables, ops_st, _, _, msns = stack_replicas(reps_d)
        D, n_ch = len(reps_d), reps_d[0].n_chunks
        tin, flagged, held = tables, {}, 0
        err_seen = torch.zeros(D, dtype=torch.int32, device=dev)
        for ci in range(n_ch):
            chunk = ops_at(ops_st, ci)
            out = overlay_apply_chunk(tin, chunk)
            new = torch.nonzero((out.error != 0) & (err_seen == 0))
            new = new.flatten().tolist()
            for d in new:
                flagged.setdefault(d % len(distinct), (ci, int(out.error[d])))
            docs = set(new)
            if ci == 0:
                docs |= set(range(D))
            elif ci == n_ch - 1:
                docs |= set(range(min(LATE_DOCS, D)))
            for d in sorted(docs):
                hold(out.doc(d), tin.doc(d), ops_at(chunk, d),
                     f"docs D {D}: doc {d} chunk {ci}")
                held += 1
            err_seen = err_seen | out.error
            tin, _, _ = fold_device(out, msns[ci])
        log(f"docs D {D}: the stacked launch == plain on {held} "
            f"(document, chunk) pairs: all {D} documents on chunk 0, "
            f"{min(LATE_DOCS, D)} on chunk {n_ch - 1}, and each document "
            f"where its error first shows")
        return flagged

    docs_runs = []
    for D in DOC_COUNTS:
        reps_d = [doc_replica(distinct[d % len(distinct)]) for d in range(D)]
        for r in reps_d:
            r.prepare()
        if D == max(DOC_COUNTS):
            flagged = hold_stacked(reps_d)
            for k, (ci, e) in sorted(flagged.items()):
                seed = "7 (headline)" if k == 0 else DOC_SEEDS[k - 1]
                log(f"docs: the stream of seed {seed} first flags error "
                    f"{e} at chunk {ci} (ops {ci * CHUNK}..{(ci + 1) * CHUNK - 1})")
            if set(flagged) != {k for k, e in enumerate(single) if e}:
                raise AssertionError(
                    f"docs D {D}: the streams that flag errors {flagged} "
                    f"differ from the single replays'")
        torch.cuda.synchronize()
        overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
        t0 = time.perf_counter()
        out = replay_docs(reps_d)
        torch.cuda.synchronize()
        t_docs = time.perf_counter() - t0
        launches_docs = overlay_chunk_kernel.launches
        launches_docs_f = overlay_fold_kernel.launches
        n_ch = reps_d[0].n_chunks
        if launches_docs != n_ch or launches_docs_f != n_ch:
            raise AssertionError(
                f"docs replay D {D}: launches {launches_docs} / "
                f"{launches_docs_f} != chunks {n_ch}")
        want_err = 0
        for d in range(D):
            want_err |= single[d % len(distinct)]
        if int(out[5]) != want_err:
            raise AssertionError(f"docs replay D {D}: error bits "
                                 f"{int(out[5])} != {want_err}")
        if int(out[4]) != min(int(r._msn_by_chunk[-1]) for r in reps_d):
            raise AssertionError(f"docs replay D {D}: gmsn {int(out[4])}")
        # Every document's outputs at the largest D equal its single
        # replay's (so its digest and error word do); doc 0's digest
        # read out at every D.
        t0 = time.perf_counter()
        if D == max(DOC_COUNTS):
            for d in range(D):
                diff = output_diff(out, d, single_out[d % len(distinct)])
                if diff:
                    raise AssertionError(
                        f"docs replay D {D}: doc {d}'s {diff} differs from "
                        f"its single-document replay's")
        r = restore_shard(reps_d[0], *out[:4], 0)
        got = (state_digest(r.annotated_spans()), int(r.table.error))
        if got != (golden_100k, 0):
            raise AssertionError(
                f"docs replay D {D}: doc 0 (digest, error) {got} != "
                f"GOLDEN.json's {golden_100k}")
        t_read = time.perf_counter() - t0
        # Documents whose stream flags an error replay into an error
        # state; the aggregate of the others is given beside the whole.
        n_clean = sum(1 for d in range(D) if not single[d % len(distinct)])
        docs_runs.append(dict(D=D, seconds=t_docs, launches=launches_docs,
                              fold_launches=launches_docs_f,
                              ops_per_s=D * DOC_OPS / t_docs,
                              clean_docs=n_clean,
                              clean_ops_per_s=n_clean * DOC_OPS / t_docs,
                              ms_per_chunk=t_docs * 1e3 / n_ch))
        log(f"docs replay D {D}: {D} x {DOC_OPS} ops in {t_docs:.3f}s = "
            f"{D * DOC_OPS / t_docs:,.0f} ops/s aggregate "
            f"({n_clean * DOC_OPS / t_docs:,.0f} over the {n_clean} documents "
            f"with no error), "
            f"{t_docs * 1e3 / n_ch:.4f} ms/chunk (kernel A launches "
            f"{launches_docs}, fold launches {launches_docs_f}, one each per "
            f"chunk; error bits {int(out[5])}); "
            + ("every document's final table, log, counts and cursor equal "
               "its single replay's exactly, so its digest and error word "
               "do; " if D == max(DOC_COUNTS) else "")
            + f"doc 0's digest and error word equal its single replay's "
            f"(GOLDEN.json at {DOC_OPS}); check {t_read:.2f}s")
        del reps_d, out

    pool.shutdown()

    # ---- 12. streaming replay -------------------------------------------
    srep = doc_replica(head)
    srep.prepare_host()
    torch.cuda.synchronize()
    overlay_chunk_kernel.launches = overlay_fold_kernel.launches = 0
    t0 = time.perf_counter()
    srep.replay_streaming(STREAM_STEPS)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    launches_stream = overlay_chunk_kernel.launches
    launches_stream_f = overlay_fold_kernel.launches
    if launches_stream != srep.n_chunks or launches_stream_f != srep.n_chunks:
        raise AssertionError(
            f"streaming: launches {launches_stream} / {launches_stream_f} "
            f"!= chunks {srep.n_chunks}")
    srep.check_errors()
    digest = state_digest(srep.annotated_spans())
    if digest != golden_100k:
        raise AssertionError(
            f"streaming digest {digest} != GOLDEN.json {golden_100k}")
    log(f"streaming replay: {DOC_OPS} ops in {STREAM_STEPS} host segments "
        f"in {t_stream:.3f}s = {DOC_OPS / t_stream:,.0f} ops/s (copies "
        f"included; kernel A launches {launches_stream}, fold launches "
        f"{launches_stream_f}); digest matches "
        f"GOLDEN.json at {DOC_OPS}")

    # ---- 28, 29 (c, e): a worker process beside phases 13-29 ----------
    ctx = multiprocessing.get_context("spawn")
    side_go, side_out = ctx.Event(), ctx.Queue()
    side = ctx.Process(target=side_phases, args=(side_go, side_out))
    side.start()

    def stop_side():  # a failing phase must not leave it running
        if side.is_alive():
            side.terminate()
            side.join()

    atexit.register(stop_side)

    # ---- 13-16. the summary service's fold, the message replica -------
    fold = fold_phases(dev, hold, lambda pairs: time_overlay(pairs, 5), log)

    # ---- 17-19. the deli sequencer --------------------------------------
    deli = deli_phases(dev, log)

    # ---- 20-21. SharedTree's batched rebase ---------------------------
    tree = tree_phases(dev, log)

    # ---- 22-25. the row-model scan, the kernel fold, KernelReplica -----
    scan = scan_phases(dev, log, fold["fold_runs"])

    # ---- 26-27. the zamboni kernel, the row model's scan engine ---------
    zamboni, scan_engine = row_scan_phases(dev, log, full, golden)
    scan["path_launches"]["scan_engine"] = scan_engine["launches"]
    scan["scan_engine"] = scan_engine

    # ---- 29 (a, b, d) and 30 (a), with 29 (c, e) in the worker process --
    side_go.set()  # the timed phases are done
    summary = summary_catchup_phases(dev, log)
    dry = mesh_dryrun_phase(dev, log)

    # ---- 28, 29 (c, e), 30 (c) from the worker process -----------------------
    t0 = time.perf_counter()
    role, stack, deli_mesh, lines = side_result(side, side_out)
    log(f"phases 28 and 30 (c) (beside phases 13-27) and phase 29 (c, e) "
        f"(beside 29 (a, b, d) and 30 (a)), run in a worker process (waited "
        f"{time.perf_counter() - t0:.2f}s for it here):")
    for line in lines:
        log(line)
    summary.update(stack)
    deli["path_launches"].update(role=role["launches"],
                                 role_crash=role["launches_crash"],
                                 role_json=role["launches_json"])
    summary_paths = {
        f"summary_{fmt}_{r['log_len']}": r["launches"]
        for fmt, c in summary["catchup"].items() for r in c["runs"]}
    summary_paths["summary_overlay_100000"] = {
        "role": summary["overlay"]["launches"]}
    for backend, st in summary["stacked"].items():
        summary_paths[f"summary_stacked_{backend}"] = st["launches"]
    summary_paths["summary_crash"] = summary["crash"]["launches"]
    scan["path_launches"].update({
        k: {stage: v[stage]["scan"] for stage in v}
        if "role" in v else v["scan"] for k, v in summary_paths.items()})
    scan["summary_role"] = summary
    scan["max_abs_err"] = max(scan["max_abs_err"],
                              summary["first_round"]["kernel"]["max_abs_err"])

    # ---- 30 (b), and (c)'s launches against phase 18's -------------------
    docs_mesh = mesh_docs_phase(
        dev, log, hold, doc_replica, distinct, single, single_out,
        next(r for r in docs_runs if r["D"] == MESH_DOCS), golden_100k)
    del single_out
    if deli_mesh["launches"] != MESH_ENTRIES * deli["launches"]:
        raise AssertionError(
            f"phase 30 (c): {deli_mesh['launches']} sequencer launches, not "
            f"{MESH_ENTRIES} x phase 18's {deli['launches']}")
    log(f"phase 30 (c): sequencer launches {deli_mesh['launches']} = "
        f"{MESH_ENTRIES} x phase 18's {deli['launches']}; records/s "
        f"{deli_mesh['records_per_s']:,.0f} (worker process, beside phases "
        f"13-27) against phase 18's {deli['records_per_s']:,.0f} (main "
        f"process, beside phase 28)")
    report = dry["report"]
    deli["path_launches"].update(
        mesh_dryrun_multi_doc=report["multi_doc"]["launches"]["sequencer_step"],
        mesh_deli_main_path=deli_mesh["launches"])
    deli["mesh_deli"] = deli_mesh
    scan["path_launches"]["mesh_dryrun_pipeline"] = \
        report["pipeline"]["launches"]["mergetree_scan"]

    # ---- 31. the summary service's fold on a device plane --------------
    plane = plane_phase(dev, log)
    plane_paths = {f"plane_{k}": v["launches"] for k, v in plane.items()}
    scan["path_launches"].update({
        k: v["scan"] for k, v in plane_paths.items() if "kernel" in k})
    scan["plane_runs"] = {k: v for k, v in plane.items() if "kernel" in k}

    def plane_overlay_paths(key):
        """The overlay backend's plane runs' launches of one kernel
        (`key`: "overlay" kernel A, "fold" the fold kernel)."""
        return {k: v[key] for k, v in plane_paths.items() if "overlay" in k}

    kernels = [{
        "name": overlay_chunk_kernel.name,
        "route": "cuda",
        "source": overlay_chunk_kernel.source,
        "replaces": overlay_chunk_kernel.replaces,
        "launches": launches,
        "max_abs_err": max(max_err,
                           summary["first_round"]["overlay"]["max_abs_err"]),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "check": "exact",
        "layouts": layouts,
        "layout_sweep": sweep,
        "path_launches": {
            "overlay_replay": launches,
            "default_window_replica": launches_def,
            "docs_replay": {str(r["D"]): r["launches"] for r in docs_runs},
            "streaming_replay": launches_stream,
            "summary_folder": fold["summary_folder"],
            "fold": fold["fold_sweep"],
            "message_replica": fold["message_replica"],
            "mesh_dryrun_one_doc":
                report["one_doc"]["launches"]["overlay_chunk"],
            "mesh_dryrun_multi_doc":
                report["multi_doc"]["launches"]["overlay_chunk"],
            "mesh_docs_replay": docs_mesh["launches"],
            **{k: {stage: v[stage]["overlay"] for stage in v}
               if "role" in v else v["overlay"]
               for k, v in summary_paths.items()},
            **plane_overlay_paths("overlay"),
        },
        "fold_groups": fold["fold_groups"],
        "fold_shape": fold["fold_shape"],
        "fold_chunk_ms": fold["fold_chunk_ms"],
        "fold_chunk_bound_ms": fold["fold_chunk_bound_ms"],
        "fold_runs": fold["fold_runs"],
        "mesh_docs": docs_mesh,
        "mesh_dryrun": report,
        "mesh_dryrun_launches": dry["launches"],
    }, {
        "name": overlay_fold_kernel.name,
        "route": "cuda",
        "source": overlay_fold_kernel.source,
        "replaces": overlay_fold_kernel.replaces,
        "launches": launches_f,
        "max_abs_err": fold_k["max_abs_err"],
        "ms": fold_k["ms"],
        "plain_ms": fold_k["plain_ms"],
        "bound_ms": fold_k["bound_ms"],
        "bound_by": fold_k["bound_by"],
        "library_ms": None,
        "check": "exact",
        "plain_on": "cuda",
        "shape": fold_k["shape"],
        "held_tables": fold_k["held"],
        "ms_d132": fold_k["ms_d132"],
        "plain_ms_d132": fold_k["plain_ms_d132"],
        "bound_ms_d132": fold_k["bound_ms_d132"],
        "ms_d8": fold_k["ms_d8"],
        "plain_ms_d8": fold_k["plain_ms_d8"],
        "bound_ms_d8": fold_k["bound_ms_d8"],
        "empty_launch_ms": {"1": fold_k["empty_ms"],
                            "8": fold_k["empty_ms_d8"],
                            "132": fold_k["empty_ms_d132"]},
        "clusters": {str(k): v for k, v in fold_k["clusters"].items()},
        "path_launches": {
            "overlay_replay": launches_f,
            "default_window_replica": launches_def_f,
            "docs_replay": {str(r["D"]): r["fold_launches"]
                            for r in docs_runs},
            "streaming_replay": launches_stream_f,
            **fold["fold_kernel_paths"],
            "mesh_dryrun_one_doc":
                report["one_doc"]["launches"]["overlay_fold"],
            "mesh_dryrun_multi_doc":
                report["multi_doc"]["launches"]["overlay_fold"],
            "mesh_docs_replay": docs_mesh["fold_launches"],
            **plane_overlay_paths("fold"),
        },
        "plane_runs": {k: v for k, v in plane.items() if "overlay" in k},
    }, {
        "name": mergetree_chunk_kernel.name,
        "route": "cuda",
        "source": mergetree_chunk_kernel.source,
        "replaces": mergetree_chunk_kernel.replaces,
        "launches": launches_b,
        "max_abs_err": max_err_b,
        "ms": kernel_ms_b,
        "plain_ms": plain_ms_b,
        "bound_ms": bound_ms_b,
        "bound_by": bound_by_b,
        "library_ms": None,
        "check": "exact",
    }, {
        "name": sequencer_step_kernel.name,
        "route": "cuda",
        "source": sequencer_step_kernel.source,
        "replaces": sequencer_step_kernel.replaces,
        "launches": deli["launches"],
        "max_abs_err": max(deli["max_abs_err"], role["max_abs_err"]),
        "ms": deli["ms"],
        "plain_ms": deli["plain_ms"],
        "bound_ms": deli["bound_ms"],
        "bound_by": deli["bound_by"],
        "library_ms": None,
        "check": "exact",
        "plain_on": "cpu",
        "layout_ms": deli["layout_ms"],
        "path_launches": deli["path_launches"],
        "profiled_ms_per_launch": deli["profiled_ms_per_launch"],
        "profiled_busy_share": deli["profiled_busy_share"],
        "checked_chunks": deli["checked_chunks"],
        "held_chunks": deli["held_chunks"],
        "pool": deli["pool"],
        "pump_ms": deli["pump_ms"],
        "records_per_s": deli["records_per_s"],
        "role": role,
    }, {
        "name": rebase_kernel.name,
        "route": "cuda",
        "source": rebase_kernel.source,
        "replaces": rebase_kernel.replaces,
        "library_ms": None,
        "check": "exact",
        "plain_on": "cpu",
        **tree,
    }, {
        "name": mergetree_scan_kernel.name,
        "route": "cuda",
        "source": mergetree_scan_kernel.source,
        "replaces": mergetree_scan_kernel.replaces,
        "library_ms": None,
        "check": "exact",
        "plain_on": "cpu",
        **scan,
    }, {
        "name": zamboni_kernel.name,
        "route": "cuda",
        "source": zamboni_kernel.source,
        "replaces": zamboni_kernel.replaces,
        "library_ms": None,
        "check": "exact",
        **zamboni,
    }, {
        "name": compaction_kernel.name,
        "route": "cuda",
        "source": compaction_kernel.source,
        "replaces": compaction_kernel.replaces,
        "launches": launches_c,
        "max_abs_err": max_err_c,
        "ms": comp_ms,
        "plain_ms": comp_plain_ms,
        "bound_ms": comp_bound_ms,
        "bound_by": comp_bound_by,
        "library_ms": None,
        "check": "exact",
        "plain_on": "cuda",
        "ms_back_to_back": comp_path_ms,
        "launches_per_call": comp_launches_per_call,
        "design": "one launch: tiles by ticket, a decoupled look-back, "
                  "each tile moving its own text",
        "path_launches": {"row_replay": launches_c},
        "compactions": rrep.compactions,
        "held_compactions": held_c,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
