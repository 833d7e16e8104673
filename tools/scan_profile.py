#!/usr/bin/env python3
"""Where the row-model scan kernel's cycles go, by part of an op.

    python3 tools/scan_profile.py [--out FILE]

Needs a card and nvcc. Builds fluidframework_tpu_torch/csrc/mergetree_scan.cu
with -DSCAN_PROFILE (the port's nvcc flags otherwise) into
build/scan_profile/: thread 0 of each block then writes the clock64()
cycles of each part of its op loop into the [D, 8] int64 tensor that
the build's own entry `mergetree_scan_profile_into` names. Records
config15's kernel fold at D = 132 (fold_golden.json's streams, with the
package's regular kernel) and KernelReplica's launches of doc 0
(`chip_smoke.replica_timed_launches`), and runs the profiling build on
round SCAN_TIMED_ROUND's first launch (C 2048, B 128), on its variants
of one op kind each (`chip_smoke.scan_variants`) and on the replica's
launches, each output equal to the regular kernel's. Prints, for each,
the cycles an op (summed over the documents, over their ops but NOOPs)
of each part, as warp 0 sees them:

  pass1   the visibility of the thread's rows and the warp scan
  b1      the wait at the pass's barrier
  pass2   the cross-warp scan and the walk of the rows with their prefixes
          (searches, a range op's covered rows)
  search  the searches' publication, their barrier and their reading
  prep    the split rows read, cold rows copied or made
  move    the suffix's move (reads, its barrier, writes)
  write   the opened rows' writes and the closing barrier
  loop    the rest (op dispatch, the capacity test, NOOPs)

and the SM clock that nvidia-smi reads after the runs.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("pass1", "b1", "pass2", "search", "prep", "move", "write", "loop")


def build() -> str:
    from fluidframework_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "scan_profile")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "mergetree_scan_profile.so")
    src = os.path.join(_build.CSRC_DIR, "mergetree_scan.cu")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSCAN_PROFILE", "-o", lib,
         src], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the table to this file")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from fluidframework_tpu_torch.ops.mergetree_scan import (
        MergetreeScanKernel,
        mergetree_scan_kernel,
    )
    from fluidframework_tpu_torch.testing import fold_streams as fs
    from tools.scan_ab import same

    if not torch.cuda.is_available():
        print("scan_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = ctypes.CDLL(build())
    lib.mergetree_scan_profile_into.restype = ctypes.c_int
    lib.mergetree_scan_profile_into.argtypes = [ctypes.c_void_p]
    k = MergetreeScanKernel()
    k._fn = k.bind(lib)

    golden = fs.load_fold_golden()
    streams = fs.golden_streams(golden, max(cs.FOLD_DOCS))
    step = golden["params"]["summary_ops"]
    rec, warm = cs.record_fold_launches(streams, step, dev)
    first = sum(r["chunks"] for r in warm["rounds"][:cs.SCAN_TIMED_ROUND])
    tables, ops, _ = rec[first]
    inputs = {"fold": (tables, ops)}
    inputs.update({n: (tables, o) for n, o in cs.scan_variants(ops).items()
                   if n != "noop"})
    reps = cs.replica_timed_launches(streams[next(iter(streams))], dev)
    inputs.update({n: v[:2] for n, v in reps.items()})

    lines = [f"card: {cs.smi_line()}",
             "launch: cycles an op by part (" + ", ".join(PARTS) + "); "
             "total"]
    for name, (t, o) in inputs.items():
        prof = torch.zeros((t.length.shape[0], len(PARTS)),
                           dtype=torch.int64, device=dev)
        if lib.mergetree_scan_profile_into(prof.data_ptr()):
            raise RuntimeError("mergetree_scan_profile_into failed")
        got = k.docs(t, o)
        same(got, mergetree_scan_kernel.docs(t, o), f"profile {name}")
        n_ops = int((o.op_type != cs.OP_NOOP_CODE).sum())
        per = prof.sum(0).double().cpu() / max(n_ops, 1)
        lines.append(f"{name}: " + ", ".join(
            f"{p} {v:.0f}" for p, v in zip(PARTS, per.tolist()))
            + f"; total {float(per.sum()):.0f} over {n_ops} ops")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    lines.append(f"SM clock after the runs (now, max): {clocks}")
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
