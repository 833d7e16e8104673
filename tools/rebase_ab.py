#!/usr/bin/env python3
"""Versions of the rebase kernel timed against each other at config 4.

    python3 tools/rebase_ab.py FIRST.cu SECOND.cu [MORE.cu ...] [--rounds 12]

Needs a card and nvcc. Each source is a version of
fluidframework_tpu_torch/csrc/rebase_batch.cu with the same C entry
(`rebase_batch_launch`); each is compiled with the port's nvcc flags
(`ops/_build.NVCC_FLAGS`, all at once) into build/rebase_ab/. Every
version must give the plain version's outputs exactly on config 4's
inputs (BASELINE config 4, `testing/tree_streams.config4_inputs`).
Then the versions run in rounds: each round times every version once,
in an order that rotates from round to round (first, second, ... then
second, ..., first), each time the mean of 50 launches by CUDA events
behind a spin (`chip_smoke.spin_time`). Prints the card, every round,
then each version's median and spread (max - min) in microseconds, and
for each version after the first the rounds in which it was faster than
the first and the difference of the medians.
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


def build_all(sources):
    """{source: library path}, compiled in parallel where not built."""
    from fluidframework_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "rebase_ab")
    os.makedirs(out_dir, exist_ok=True)
    libs, procs = {}, []
    for src in sources:
        with open(src, "rb") as f:
            key = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS)
                                 .encode()).hexdigest()[:16]
        lib = os.path.join(out_dir, f"rebase_batch-{key}.so")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args()
    if len(args.sources) < 2:
        ap.error("give two sources or more")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from chip_smoke import smi_line, spin_time
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.testing.tree_streams import config4_inputs
    from fluidframework_tpu_torch.tree import rebase_kernel as trk

    if not torch.cuda.is_available():
        print("rebase_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_all(args.sources)
    ops, base = config4_inputs()
    n, m = ops.shape[0], base.shape[0]
    cols = [torch.from_numpy(np.ascontiguousarray(a[:, j]))
            for a in (trk._pad(ops), trk._pad(base)) for j in range(4)]
    want = trk.rebase_batch_ref(*cols)
    ins = [c.to(dev) for c in cols]
    _, out = trk.alloc_result(n, dev)

    launchers = {}
    for src, lib in libs.items():
        fn = ctypes.CDLL(lib).rebase_batch_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        launch = (lambda fn=fn: _build.launch(
            "rebase_batch", fn, dev, (n, m), (*ins, *out)))
        launch()
        torch.cuda.synchronize()
        for field, a, b in zip(trk.OUT_FIELDS, out, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{src}: {field} differs from the "
                                     f"plain version on config 4")
        launchers[src] = launch

    print(f"card: {smi_line()}")
    names = list(launchers)
    us = {s: [] for s in names}
    for r in range(args.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for s in order:
            us[s].append(spin_time(launchers[s], 50) * 1e3)
        print(f"round {r}: " + ", ".join(f"{os.path.basename(s)} "
                                         f"{us[s][r]:.3f}" for s in names))
    first = names[0]
    med0 = statistics.median(us[first])
    for s in names:
        med, spread = statistics.median(us[s]), max(us[s]) - min(us[s])
        line = (f"{os.path.basename(s)}: median {med:.3f} us, spread "
                f"{spread:.3f} us over {args.rounds} rounds")
        if s != first:
            wins = sum(a < b for a, b in zip(us[s], us[first]))
            line += (f"; faster than {os.path.basename(first)} in {wins} of "
                     f"{args.rounds} rounds, medians {med - med0:+.3f} us")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
