#!/usr/bin/env python3
"""Versions of the row-model scan kernel timed against each other.

    python3 tools/scan_ab.py --rev REV
    python3 tools/scan_ab.py FIRST.cu [SECOND.cu ...] [--rounds 8]

With ``--rev`` (in a git checkout, no card needed) it writes revision
REV's fluidframework_tpu_torch/csrc/mergetree_scan.cu to
build/scan_ab/mergetree_scan-REV.cu and prints the path, so that a
parent's kernel can be timed beside the tree's.

With sources (a card and nvcc needed) it compiles each with the port's
nvcc flags (`ops/_build.NVCC_FLAGS`, all at once) into build/scan_ab/
and times them on the same launches: config15's kernel fold at D = 132
(fold_golden.json's streams) is run once with the package's kernel to
record its launches; the first launch of round SCAN_TIMED_ROUND (C 2048,
B 128, all 132 documents) is timed as it is, all NOOP and with each op
kind alone (`chip_smoke.scan_variants`), and KernelReplica's launches
of doc 0 at C 4096 and 8192 (B 512, `chip_smoke.SCAN_REPLICA_LAUNCHES`).
Every version's outputs must equal the first's on every timed launch,
and the first's must equal the plain version on doc 0 of the fold launch
and on the replica's launches. Then the versions run in rounds: each round times every version
on every launch once (CUDA events behind a spin, `chip_smoke.spin_time`),
the versions in an order that rotates from round to round. Prints the
card, each version's median ms a launch and spread for each launch, its
us an op by kind from the medians (as `chip_smoke.scan_part_times`
computes them), and for each version after the first the rounds in which
its fold launch was faster than the first's.

A source without the `mergetree_scan_abi` symbol is taken as the first
design's kernel (29 pointers, no layout argument; its block geometry is
recomputed here); one with it is launched through
`ops/mergetree_scan.MergetreeScanKernel`, whose interface it must have.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "scan_ab")
SOURCE = "fluidframework_tpu_torch/csrc/mergetree_scan.cu"
LAUNCHES = ("fold", "noop", "insert", "remove", "annotate", "replica_c4096",
            "replica_c8192")


def extract(rev: str) -> str:
    """Revision `rev`'s kernel source, written under build/scan_ab/."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src = subprocess.run(["git", "show", f"{rev}:{SOURCE}"], cwd=ROOT,
                         check=True, capture_output=True).stdout
    path = os.path.join(OUT_DIR, f"mergetree_scan-{rev}.cu")
    with open(path, "wb") as f:
        f.write(src)
    return path


def build_all(sources):
    """{source: library path}, compiled in parallel where not built."""
    from fluidframework_tpu_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    libs, procs = {}, []
    for src in sources:
        with open(src, "rb") as f:
            key = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS)
                                 .encode()).hexdigest()[:16]
        lib = os.path.join(OUT_DIR, f"mergetree_scan-{key}.so")
        libs[src] = lib
        if not os.path.exists(lib):
            procs.append((src, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    return libs


def first_design_launcher(fn, dev):
    """`launch(tables, ops)` for a kernel of the first design: one block
    of min(1024, C rounded up to 32) threads, R = ceil(C / threads),
    the hot columns and the ops in shared memory, a heap
    [D, C + 2B, KR + KK]."""
    import torch

    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.ops.mergetree_kernel import SegmentTable

    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 11 + [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]

    def launch(tables, ops):
        D, C = tables.length.shape
        KR, KK = tables.rem_clients.shape[2], tables.props.shape[2]
        B, PK = ops.prop_keys.shape[1:]
        NT = min(1024, -(-C // 32) * 32)
        R = -(-C // NT)
        smem = -(-4 * (6 * C + 8 * B + 2 * B * PK) // 16) * 16 + 1024
        ins = [tables.n_rows, tables.error, tables.buf_start, tables.length,
               tables.ins_seq, tables.ins_client, tables.rem_seq,
               tables.rem_clients, tables.props, ops.op_type, ops.pos1,
               ops.pos2, ops.seq, ops.ref_seq, ops.client, ops.buf_start,
               ops.ins_len, ops.prop_keys, ops.prop_vals]
        out = SegmentTable(*(torch.empty_like(t) for t in (
            ins[0], ins[2], ins[3], ins[4], ins[5], ins[6], ins[7], ins[8],
            ins[1])))
        heap = torch.empty((D, C + 2 * B, KR + KK), dtype=torch.int32,
                           device=dev)
        outs = [out.buf_start, out.length, out.ins_seq, out.ins_client,
                out.rem_seq, out.rem_clients, out.props, out.n_rows,
                out.error]
        _build.launch("mergetree_scan", fn, dev,
                      (D, C, KR, KK, B, PK, NT, R, smem),
                      ins + outs + [heap])
        return out

    return launch


def same(a, b, label):
    """Stacked outputs equal per document on n_rows, error and rows
    [:min(n_rows, C)]."""
    import torch

    from chip_smoke import SCAN_COLS

    for d in range(b.n_rows.shape[0]):
        n = int(b.n_rows[d])
        if (int(a.n_rows[d]), int(a.error[d])) != (n, int(b.error[d])):
            raise AssertionError(f"{label} doc {d}: n_rows / error differ")
        m = min(n, b.length.shape[1])
        for f in SCAN_COLS:
            if not torch.equal(getattr(a, f)[d, :m].cpu(),
                               getattr(b, f)[d, :m].cpu()):
                raise AssertionError(f"{label} doc {d}: {f} differs")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--rev", help="write this revision's kernel source "
                                  "under build/scan_ab/ and exit")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if args.rev:
        print(extract(args.rev))
        return 0
    if not args.sources:
        ap.error("give --rev or one source or more")
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from fluidframework_tpu_torch.ops import mergetree_kernel as tmk
    from fluidframework_tpu_torch.ops.mergetree_scan import (
        MergetreeScanKernel,
    )
    from fluidframework_tpu_torch.testing import fold_streams as fs

    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_all(sorted(set(args.sources)))

    golden = fs.load_fold_golden()
    streams = fs.golden_streams(golden, max(cs.FOLD_DOCS))
    step = golden["params"]["summary_ops"]
    rec, warm = cs.record_fold_launches(streams, step, dev)
    first = sum(r["chunks"] for r in warm["rounds"][:cs.SCAN_TIMED_ROUND])
    tables, ops, _ = rec[first]
    reps = cs.replica_timed_launches(streams[next(iter(streams))], dev)
    inputs = {"fold": (tables, ops)}
    inputs.update({k: (tables, o) for k, o in cs.scan_variants(ops).items()})
    inputs.update({k: v[:2] for k, v in reps.items()})
    print(f"card: {cs.smi_line()}")
    print(f"fold launch: D {tables.length.shape[0]}, C "
          f"{tables.length.shape[1]}, B {ops.op_type.shape[1]}, live rows "
          f"{int(tables.n_rows.min())}-{int(tables.n_rows.max())}; "
          + ", ".join(f"{k}: live rows {int(v[0].n_rows[0])}"
                      for k, v in reps.items()))

    launchers, want = {}, {}
    for src in args.sources:
        cdll = ctypes.CDLL(libs[src])
        if hasattr(cdll, "mergetree_scan_abi"):
            k = MergetreeScanKernel()
            k._fn = k.bind(cdll)
            launch = k.docs
        else:
            launch = first_design_launcher(cdll.mergetree_scan_launch, dev)
        for name in LAUNCHES:
            got = launch(*inputs[name])
            torch.cuda.synchronize()
            if name in want:
                same(got, want[name], f"{os.path.basename(src)} {name}")
            else:
                want[name] = got
        launchers[src] = launch
    for name in ("fold", *reps):
        t, o = inputs[name]
        plain = tmk.apply_op_batch_docs_ref(
            *(x.to("cpu") for x in (cs.cut_docs(t, 1), cs.cut_docs(o, 1))))
        same(cs.cut_docs(want[name], 1), plain, f"plain {name}")
    print(f"every version equals the first on the {len(LAUNCHES)} launches; "
          f"the first equals the plain version on doc 0 of the fold launch "
          f"and on the replica's launches")

    names = list(launchers)
    ms = {s: {k: [] for k in LAUNCHES} for s in names}
    for r in range(args.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for s in order:
            for k in LAUNCHES:
                t, o = inputs[k]
                ms[s][k].append(cs.spin_time(
                    lambda t=t, o=o, s=s: launchers[s](t, o),
                    cs.SCAN_TIME_REPS))
        print(f"round {r}: " + ", ".join(
            f"{os.path.basename(s)} {ms[s]['fold'][r]:.4f}" for s in names))
    t = ops.op_type
    for s in names:
        med = {k: statistics.median(v) for k, v in ms[s].items()}
        us = []
        for name, code in cs.SCAN_KINDS + (("mix", None),):
            live = (t != cs.OP_NOOP_CODE) if code is None else (t == code)
            most = int(live.sum(1).max())
            run = med["fold" if code is None else name]
            us.append(f"{name} {(run - med['noop']) * 1e3 / most:.3f}")
        line = (f"{os.path.basename(s)}: median ms " + ", ".join(
            f"{k} {med[k]:.4f} (spread {max(ms[s][k]) - min(ms[s][k]):.4f})"
            for k in LAUNCHES) + "; us an op " + ", ".join(us))
        if s != names[0]:
            wins = sum(a < b for a, b in zip(ms[s]["fold"],
                                             ms[names[0]]["fold"]))
            line += (f"; fold launch faster than "
                     f"{os.path.basename(names[0])} in {wins} of "
                     f"{args.rounds} rounds")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
