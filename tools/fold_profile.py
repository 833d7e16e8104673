#!/usr/bin/env python3
"""Where the overlay fold kernel's cycles go, by part.

    python3 tools/fold_profile.py

Needs a card and nvcc. Builds a copy of
fluidframework_tpu_torch/csrc/overlay_fold.cu into build/fold_profile/
(the port's nvcc flags) with, at the end of each part, a barrier and a
clock64() stamp of thread 0 written to a device array, which the
copy's own entry `read_fold_profile` copies out (`instrument` inserts
them at fixed lines of the source and raises where one is missing).
Runs the append form, as `replay_chunk_step` launches it, on kernel
A's outputs of the first 16 chunks of the headline stream at the bench
geometry (W 2048, KR 24, KK 8): one document (chunk 3) and the 16
tiled to D = 8 and 132, at the cluster size the wrapper picks and at
G = 1, each output equal to the plain version's. Prints the ms a launch
of the regular build and of the stamped one (CUDA events behind a
spin) and the cycles of each part, averaged over the CTAs:

  stage     the tile's columns and props into shared memory
  scan      the warp scans of pass 1 and their barrier
  exchange  the map and codes, the cluster barrier, the other ranks'
            totals over distributed shared memory
  finalize  the new anchors and bufs
  narrow    the kept rows' six narrow columns
  remcl     the kept rows' rem_clients (the gather from device memory)
  props     the kept rows' props
  records   the record block
  fill      the fill rows
  end       the document's scalars
  cwait     the closing cluster barrier

The stamps' barriers keep the parts from overlapping, so the parts sum
to a little more than the regular build's time. Then the SM clock that
nvidia-smi reads.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("stage", "scan", "exchange", "finalize", "narrow", "remcl",
         "props", "records", "fill", "end", "cwait")
MAX_CTAS = 2048
STAMP = f"""
__device__ long long fold_stamps[{MAX_CTAS}][16];
#define STAMP(k) {{ __syncthreads(); if (threadIdx.x == 0 && blockIdx.x < {MAX_CTAS}) \\
    fold_stamps[blockIdx.x][k] = clock64(); }}
"""
READ = """
extern "C" int read_fold_profile(void* host) {
    return (int)cudaMemcpyFromSymbol(host, fold_stamps, sizeof(fold_stamps));
}
"""
# (a line of the kernel's source, the line with the part's stamp)
MARKS = (
    ("namespace {\n", "namespace {\n" + STAMP),
    ("    if (threadIdx.x == 0) mbar_init((unsigned long long*)smem, 1);\n",
     "    if (threadIdx.x == 0) mbar_init((unsigned long long*)smem, 1);\n"
     "    STAMP(0)\n"),
    ("        stage(a, c, s0, m);\n        sc = scan_segment(a, c, s0, m);\n"
     "        kt += sc.kseg;",
     "        stage(a, c, s0, m);\n        STAMP(1)\n"
     "        sc = scan_segment(a, c, s0, m);\n        STAMP(2)\n"
     "        kt += sc.kseg;"),
    ("    cluster_arrive();  // this CTA has read the other ranks' totals\n",
     "    cluster_arrive();  // this CTA has read the other ranks' totals\n"
     "    STAMP(3)\n"),
    ("        finalize_segment(a, c, s0, m, sc, Db);\n",
     "        finalize_segment(a, c, s0, m, sc, Db);\n        STAMP(4)\n"),
    ("    copy_rows(a.o_rem_clients + out0 * a.KR,",
     "    STAMP(5)\n    copy_rows(a.o_rem_clients + out0 * a.KR,"),
    ("    copy_rows(a.o_props + out0 * a.KK, sprops(c, a), perm, ks, a.KK);\n",
     "    STAMP(6)\n"
     "    copy_rows(a.o_props + out0 * a.KK, sprops(c, a), perm, ks, a.KK);\n"
     "    STAMP(7)\n"),
    ("    write_records(a, c, rec, m, ks, a.W - n_new + Kb, Jb);\n",
     "    write_records(a, c, rec, m, ks, a.W - n_new + Kb, Jb);\n"
     "    STAMP(8)\n"),
    ("    if (c.rank == 0 && threadIdx.x == 0) {\n",
     "    STAMP(9)\n    if (c.rank == 0 && threadIdx.x == 0) {\n"),
    ("    cluster_wait();  // the other ranks are done with this CTA's totals\n",
     "    STAMP(10)\n"
     "    cluster_wait();  // the other ranks are done with this CTA's totals\n"
     "    STAMP(11)\n"),
)


def instrument(src: str) -> str:
    """The kernel's source with the stamps and `read_fold_profile`;
    raises where a line of MARKS is not found once."""
    for old, new in MARKS:
        if src.count(old) != 1:
            raise ValueError(f"fold_profile: no single line {old!r} in the "
                             "kernel's source")
        src = src.replace(old, new)
    return src + READ


def build() -> ctypes.CDLL:
    from fluidframework_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "fold_profile")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, "overlay_fold.cu")) as f:
        src = instrument(f.read())
    cu = os.path.join(out_dir, "overlay_fold_profile.cu")
    lib = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                           cu], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(lib)


def main() -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("fold_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fluidframework_tpu_torch.core.overlay_replay import (
        OverlayDeviceReplica,
    )
    from fluidframework_tpu_torch.ops import overlay as tov
    from fluidframework_tpu_torch.testing.golden import (
        headline_stream, load_golden, stream_prefix,
    )

    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    lib = build()
    stamped = tov.OverlayFoldKernel()
    stamped._fn = tov.OverlayFoldKernel.bind(lib)
    W, KR, KK, chunk = cs.WINDOW, cs.N_REMOVERS, cs.N_PROP_KEYS, cs.CHUNK
    rep = OverlayDeviceReplica(
        stream_prefix(headline_stream(load_golden()), 100_000),
        initial_len=64, chunk_size=chunk, window=W, n_removers=KR,
        n_prop_keys=KK, device=dev)
    rep.prepare()
    table, outs = rep.table, []
    for ci in range(16):
        out = tov.overlay_chunk_kernel(
            table, rep._dev.slice(ci * chunk, (ci + 1) * chunk))
        outs.append((out, rep._msn_by_chunk[ci]))
        table = tov.fold_device(out, rep._msn_by_chunk[ci])[0]

    def inputs(D):
        if D == 1:
            return outs[3]
        return (tov.stack_tables([outs[d % 16][0] for d in range(D)]),
                torch.stack([outs[d % 16][1] for d in range(D)]).contiguous())

    def call(t, m):
        lead = tuple(t.length.shape[:-1])
        return (t, m, torch.zeros(lead + (2 * W, 5 + KK), dtype=torch.int32,
                                  device=dev),
                torch.zeros(lead + (1,), dtype=torch.int32, device=dev),
                torch.zeros(lead, dtype=torch.int32, device=dev), 0)

    sms = tov.OverlayFoldKernel.sm_count(dev)
    for D in (1, 8, 132):
        t, m = inputs(D)
        for G in sorted({tov.fold_cluster(D, W, KK, sms), 1}, reverse=True):
            want = call(t, m)
            want_out = tov.fold_append_ref(*want)
            got = call(t, m)
            got_out = stamped.append(*got, cluster=G)
            same = (all(torch.equal(getattr(got_out[0], f.name),
                                    getattr(want_out[0], f.name))
                        for f in dataclasses.fields(got_out[0]))
                    and torch.equal(got_out[1], want_out[1])
                    and torch.equal(got[2], want[2])
                    and torch.equal(got[3], want[3]))
            if not same:
                raise AssertionError(f"the stamped fold differs from the "
                                     f"plain version at D {D}, G {G}")
            args = call(t, m)
            ms = cs.spin_time(
                lambda: tov.overlay_fold_kernel.append(*args, cluster=G), 32)
            ms_stamped = cs.spin_time(lambda: stamped.append(*args, cluster=G),
                                      32)
            stamped.append(*args, cluster=G)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (MAX_CTAS * 16))()
            if lib.read_fold_profile(buf) != 0:
                raise RuntimeError("fold_profile: reading the stamps failed")
            n = min(D * G, MAX_CTAS)
            parts = [sum(buf[b * 16 + k + 1] - buf[b * 16 + k]
                         for b in range(n)) / n for k in range(len(PARTS))]
            print(f"D {D} G {G}: {ms:.6f} ms a launch ({ms_stamped:.6f} "
                  f"stamped); cycles a CTA {sum(parts):.0f}: "
                  + ", ".join(f"{p} {c:.0f}" for p, c in zip(PARTS, parts)),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
