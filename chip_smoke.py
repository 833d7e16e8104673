#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--ops N]

Drives the port's two replay paths on the card, through
``fluidframework_tpu_torch`` only -- it imports nothing of JAX or of
``fluidframework_tpu``: the overlay merge-tree replay that ``bench.py``
measures on the JAX package, and the row-model replay
(``ColumnarReplica``, ``bench.py`` with ``BENCH_ENGINE=pallas``).
Phases, in order; any failure exits non-zero:

1. the device, and the card's name and power limit from nvidia-smi;
2. builds both CUDA kernels (nvcc, sm_90a) and the native stream engine
   (g++) from the checkout's sources, in parallel;
3. holds the overlay chunk kernel against its plain PyTorch version on
   the card at the bench geometry (window 2048, 24 remover slots, 8 prop
   keys, chunks of 256 ops): the first 16 chunks of the seed-7 lagged
   stream, a chunk that overflows the window (ERR_CAPACITY) and a chunk
   with positions past the document (ERR_BAD_POS); the comparison is
   exact (int32, tolerance 0) on n_rows, error and rows [:n_rows];
   then times both on the checked chunks;
4. the main path: `OverlayDeviceReplica(device="cuda")` replays the
   seed-7 lagged stream (1024 clients, collab window 1024, initial
   length 64; 1M ops by default) with the kernel launch count reset
   just before; the launches must equal the chunk count, and the final
   state's digest must equal GOLDEN.json (the full digest at 1M ops,
   else the native stage digest of that prefix length);
5. holds the row-model chunk kernel against `apply_chunk_ref` on the
   card at the bench geometry (capacity 131072, 24 remover slots, 8
   prop keys, chunks of 256 ops), exactly (tolerance 0) on n_rows,
   error and rows [:n_rows]: the first 16 chunks of the same stream
   with `compact_gather_text` every 4 chunks as the replica runs it, a
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
   launches must equal the chunk count and the digest must equal
   GOLDEN.json's stage digest at that depth;
7. the chunks from k to the end of that replay, on the kept table
   (tens of thousands of rows), kernel against plain version again,
   exactly; both are timed there.

ROW_OPS is the largest 100k multiple of ops (up to 1M) that the card
replays in at most 300 s; it is 1M (see the constant).

Prints the kernel B grid line (G, R, shared bytes per block, grid
barriers per op), the kernels line (JSON), the nvidia-smi line, and
last the
``{"ok": true, "device": ...}`` line. Exits 2 without a CUDA device or
outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
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

# H100 SXM peaks: the HBM3 rate from NVIDIA's data sheet, and the int32
# issue rate (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost clock),
# half the data sheet's non-FMA fp32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 64 * 132 * 1.98e9
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


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=1_000_000,
                    help="ops of the main-path replay (a multiple of "
                         "100000 below 1M is gated on its stage digest)")
    args = ap.parse_args()

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
        OverlayDeviceReplica,
    )
    from fluidframework_tpu_torch.native import load_hostmerge
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.interop import (
        opbatch_from_numpy, segment_table_from_numpy,
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
        OverlayTable, fold_device, overlay_apply_chunk_ref,
        overlay_chunk_kernel,
    )
    from fluidframework_tpu_torch.ops.zamboni import compact_gather_text
    from fluidframework_tpu_torch.testing.block_edges import block_edge_chunks
    from fluidframework_tpu_torch.testing.digest import state_digest
    from fluidframework_tpu_torch.testing.golden import (
        golden_digest, headline_stream, load_golden, stream_prefix,
    )

    # ---- 1. device ---------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    cuda_names = (overlay_chunk_kernel.name, mergetree_chunk_kernel.name)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        f_cuda = [ex.submit(_build.load, name) for name in cuda_names]
        f_host = ex.submit(load_hostmerge)
        for f in f_cuda:
            f.result()
        if f_host.result() is None:
            raise RuntimeError("g++ build of the native stream engine failed")
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc x2 + g++ in parallel)")
    for name in cuda_names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- stream ------------------------------------------------------
    golden = load_golden()
    n_golden = golden["params"]["n_ops"]
    initial_len = golden["params"]["initial_len"]
    row_ops = min(args.ops, ROW_OPS)
    want, want_row = golden_digest(golden, args.ops), golden_digest(
        golden, row_ops)
    if want is None or want_row is None:
        raise AssertionError(
            f"GOLDEN.json pins no digest at {args.ops} or {row_ops} ops")

    t0 = time.perf_counter()
    full = headline_stream(golden)
    stream = stream_prefix(full, args.ops)
    log(f"stream: {n_golden} lagged ops generated in "
        f"{time.perf_counter() - t0:.2f}s; replaying the first {args.ops}")

    def replica() -> OverlayDeviceReplica:
        return OverlayDeviceReplica(
            stream, initial_len=initial_len, chunk_size=CHUNK,
            window=WINDOW, n_removers=N_REMOVERS,
            n_prop_keys=N_PROP_KEYS, device=dev,
        )

    # ---- 3. kernel vs its plain version ------------------------------
    max_err = 0

    def compare(tin: OverlayTable, ops: OpBatch, label: str):
        nonlocal max_err
        out_k = overlay_chunk_kernel(tin, ops)
        out_r = overlay_apply_chunk_ref(tin, ops)
        torch.cuda.synchronize()
        n_k, n_r = int(out_k.n_rows), int(out_r.n_rows)
        e_k, e_r = int(out_k.error), int(out_r.error)
        if (n_k, e_k) != (n_r, e_r):
            raise AssertionError(
                f"{label}: kernel n_rows/error {n_k}/{e_k} != plain "
                f"{n_r}/{e_r}")
        m = min(n_r, WINDOW)
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
    checked = []
    for ci in range(min(CHECK_CHUNKS, rep.n_chunks)):
        batch = ops_all.slice(ci * CHUNK, (ci + 1) * CHUNK)
        out, n, e = compare(table, batch, f"chunk {ci}")
        checked.append((table, batch))
        if e:
            raise AssertionError(f"chunk {ci}: error flags {e} on a valid stream")
        table, _, _ = fold_device(out, rep._msn_by_chunk[ci])
    log(f"kernel == plain on {len(checked)} stream chunks "
        f"(rows up to {max(int(t.n_rows) for t, _ in checked)} in)")

    # A window that overflows: W-8 text rows, then inserts and removes.
    W = WINDOW
    base = WINDOW - 8
    g = torch.Generator().manual_seed(SEED)
    cols = dict(
        anchor=torch.zeros(W, dtype=torch.int32),
        buf_start=torch.arange(W, dtype=torch.int32),
        length=torch.ones(W, dtype=torch.int32),
        ins_seq=torch.arange(1, W + 1, dtype=torch.int32),
        ins_client=torch.ones(W, dtype=torch.int32),
        rem_seq=torch.full((W,), NOT_REMOVED, dtype=torch.int32),
    )
    over_table = OverlayTable(
        n_rows=torch.tensor(base, dtype=torch.int32),
        rem_clients=torch.full((W, N_REMOVERS), -3, dtype=torch.int32),
        props=torch.full((W, N_PROP_KEYS), -1, dtype=torch.int32),
        settled_len=torch.tensor(0, dtype=torch.int32),
        error=torch.tensor(0, dtype=torch.int32), **cols,
    ).to(dev)
    i = torch.arange(CHUNK, dtype=torch.int32)
    kinds = torch.where(i % 4 == 3, OP_REMOVE, OP_INSERT).to(torch.int32)
    pos = (torch.rand(CHUNK, generator=g) * base).to(torch.int32)
    over_ops = OpBatch(
        op_type=kinds, pos1=pos, pos2=pos + 2,
        seq=base + 1 + i, ref_seq=base + i, client=2 + i % 3,
        buf_start=torch.zeros(CHUNK, dtype=torch.int32),
        ins_len=torch.ones(CHUNK, dtype=torch.int32),
        prop_keys=torch.full((CHUNK, 1), -1, dtype=torch.int32),
        prop_vals=torch.full((CHUNK, 1), -1, dtype=torch.int32),
    ).to(dev)
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

    # Time the kernel and the plain version on the checked chunks.
    reps = 20
    for tin, batch in checked:  # warm-up
        overlay_chunk_kernel(tin, batch)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        for tin, batch in checked:
            overlay_chunk_kernel(tin, batch)
    ev1.record()
    torch.cuda.synchronize()
    kernel_ms = ev0.elapsed_time(ev1) / (reps * len(checked))
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

    # ---- 4. the main path --------------------------------------------
    rep = replica()
    rep.prepare()
    torch.cuda.synchronize()
    overlay_chunk_kernel.launches = 0
    t0 = time.perf_counter()
    rep.replay()
    torch.cuda.synchronize()
    t_replay = time.perf_counter() - t0
    launches = overlay_chunk_kernel.launches
    if launches != rep.n_chunks:
        raise AssertionError(
            f"kernel launches {launches} != chunks {rep.n_chunks}")
    rep.check_errors()
    log(f"replay: {args.ops} ops in {t_replay:.3f}s = "
        f"{args.ops / t_replay:,.0f} ops/s, "
        f"{t_replay * 1e3 / rep.n_chunks:.4f} ms/chunk over "
        f"{rep.n_chunks} chunks (kernel launches {launches}); residual "
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
            table_b, arena = compact_gather_text(
                table_b, msn, arena, rrep.stream_text)
    log(f"row kernel == plain on {len(early)} stream chunks (rows up to "
        f"{max(int(t.n_rows) for t, _ in early)} in)")

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
    t0 = time.perf_counter()
    rrep.replay(limit_chunks=deep_lo)
    deep_table = rrep.table
    rrep.replay()
    torch.cuda.synchronize()
    t_row = time.perf_counter() - t0
    launches_b = mergetree_chunk_kernel.launches
    if launches_b != n_chunks_b:
        raise AssertionError(
            f"row kernel launches {launches_b} != chunks {n_chunks_b}")
    rrep.check_errors()
    log(f"row replay: {row_ops} ops in {t_row:.3f}s = "
        f"{row_ops / t_row:,.0f} ops/s, {t_row * 1e3 / n_chunks_b:.4f} "
        f"ms/chunk over {n_chunks_b} chunks (kernel launches {launches_b}, "
        f"compactions {rrep.compactions}); final rows "
        f"{int(rrep.table.n_rows)} of capacity {rrep.capacity}")
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
    for ci in range(deep_lo, n_chunks_b):
        batch = row_chunk(ci)
        out, n, e = compare_row(table_b, batch, f"row deep chunk {ci}")
        deep.append((table_b, batch))
        if e:
            raise AssertionError(f"row deep chunk {ci}: error flags {e}")
        table_b = out
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

    n_ins_d = sum(int((b.op_type == OP_INSERT).sum()) for _, b in deep)
    n_rng_d = sum(int(((b.op_type == OP_REMOVE)
                       | (b.op_type == OP_ANNOTATE)).sum()) for _, b in deep)
    log(f"mergetree_chunk grid: G {grid_g} blocks x R {grid_r} rows "
        f"({n_sms} SMs), {grid_smem} shared bytes per block, grid barriers "
        f"per op 2 (insert) / 3 (remove, annotate): "
        f"{(2 * n_ins_d + 3 * n_rng_d) / max(1, n_ins_d + n_rng_d):.3f} "
        f"per op on the deep chunks")

    kernels = [{
        "name": overlay_chunk_kernel.name,
        "route": "cuda",
        "source": overlay_chunk_kernel.source,
        "replaces": overlay_chunk_kernel.replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "check": "exact",
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
