#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py [--ops N]

Drives the port's main path (the overlay merge-tree replay that
``bench.py`` measures on the JAX package) on the card, through
``fluidframework_tpu_torch`` only -- it imports nothing of JAX or of
``fluidframework_tpu``. Phases, in order; any failure exits non-zero:

1. the device, and the card's name and power limit from nvidia-smi;
2. builds the CUDA kernel (nvcc, sm_90a) and the native stream engine
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
   else the native stage digest of that prefix length).

Prints the kernels line (JSON), the nvidia-smi line, and last the
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
N_CLIENTS, SEED, COLLAB_WINDOW, INITIAL_LEN = 1024, 7, 1024, 64
CHECK_CHUNKS = 16  # stream chunks held against the plain version

# H100 SXM peaks: the HBM3 rate from NVIDIA's data sheet, and the int32
# issue rate (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost clock),
# half the data sheet's non-FMA fp32 rate.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 64 * 132 * 1.98e9
INT_OPS_PER_ROW = 16  # visibility, prefix sum and landing tests per row per op


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

    from fluidframework_tpu_torch.core.overlay_replay import (
        OverlayDeviceReplica,
    )
    from fluidframework_tpu_torch.native import load_hostmerge
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        ERR_BAD_POS, ERR_CAPACITY, NOT_REMOVED, OP_INSERT, OP_REMOVE,
        OpBatch,
    )
    from fluidframework_tpu_torch.ops.overlay import (
        OverlayTable, fold_device, overlay_apply_chunk_ref,
        overlay_chunk_kernel,
    )
    from fluidframework_tpu_torch.testing.digest import state_digest
    from fluidframework_tpu_torch.testing.synthetic import (
        generate_lagged_stream,
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
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        f_cuda = ex.submit(_build.load, overlay_chunk_kernel.name)
        f_host = ex.submit(load_hostmerge)
        f_cuda.result()
        if f_host.result() is None:
            raise RuntimeError("g++ build of the native stream engine failed")
    log(f"build: {time.perf_counter() - t0:.2f}s (nvcc + g++ in parallel)")
    for line in _build.build_logs.get(overlay_chunk_kernel.name, "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- stream ------------------------------------------------------
    with open(os.path.join(ROOT, "GOLDEN.json")) as f:
        golden = json.load(f)
    n_golden = golden["params"]["n_ops"]
    if args.ops == n_golden:
        want = golden["digest"]
    else:
        want = golden["chain"]["native_stage_digests"][str(args.ops)]

    # The golden stages are prefixes of the full stream (the generator
    # draws whole arrays, so a shorter stream is not its prefix).
    t0 = time.perf_counter()
    full = generate_lagged_stream(
        n_golden, n_clients=N_CLIENTS, seed=SEED, window=COLLAB_WINDOW,
        initial_len=INITIAL_LEN,
    )
    stream = type(full)(**{
        f: getattr(full, f) if f == "text" else getattr(full, f)[:args.ops]
        for f in full.__dataclass_fields__})
    log(f"stream: {n_golden} lagged ops generated in "
        f"{time.perf_counter() - t0:.2f}s; replaying the first {args.ops}")

    def replica() -> OverlayDeviceReplica:
        return OverlayDeviceReplica(
            stream, initial_len=INITIAL_LEN, chunk_size=CHUNK,
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
