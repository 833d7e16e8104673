#!/usr/bin/env python3
"""Where the compaction kernel's cycles go, by part.

    python3 tools/compaction_profile.py [--ops 500000]

Needs a card and nvcc. Builds a copy of
fluidframework_tpu_torch/csrc/zamboni.cu into build/compaction_profile/
(the port's nvcc flags) with, at the end of each part of the
compaction's one launch (`zb_compact`), a barrier and a clock64() stamp
of thread 0 written to a device array, with the block's ticket; the
copy's own entry `read_compaction_profile` copies them out
(`instrument` inserts them at fixed lines of the source and raises
where one is missing). The look-back's stamp takes no barrier: warp 0
looks back while the other warps read the tile's text. Runs it on phase
7's table (`compaction_timing.deep_compaction`: the chunk path's table
before its compaction after the first 4 of its last chunks of `--ops`
headline ops), the output equal to the plain version's, and prints the
ms a call of the regular build and of the stamped one (CUDA events
behind a spin), then the cycles of each part, the mean and the largest
over the blocks of each kind. A tile block (a ticket up to the last live
row's tile):

  stage     the tile's columns and props into shared memory (the bulk
            copies and 4-byte cp.async), and the kept row before it
  scan      the keep and start flags, the local offsets, the aggregate
  fills     its output rows at and above the live rows (the last tile)
  lookback  warp 0's look-back over the tiles before it, to its prefix
  text_rd   what the text's read into shared memory takes past that
  rows      each run's narrow columns, rem_clients and props
  text_mv   the tile's text into the new arena

A free block (every later ticket):

  tile      the fills of its tile, where its ticket is a tile past the
            last live row's
  total     the look-back to the last tile for the text length alone
            (the tiles' aggregates summed)
  tail      its share of the arena's tail past that length
  prefix    the look-back to the last tile for the run count m
  rows      its share of the rows [m, live)

The stamps' barriers keep the parts from overlapping, so the parts sum
to a little more than the regular build's time. Then the SM clock that
nvidia-smi reads.

Last, an A/B of the text's read beside the look-back: a second copy
built with TEXT_CAP 0 (`without_text_read`), where warps 1-7 read no
text while warp 0 looks back and the whole text moves after it, held
equal to the plain version and timed against the regular build in one
process, in the order regular, copy, copy, regular.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_PARTS = ("stage", "scan", "fills", "lookback", "text_rd", "rows",
              "text_mv")
FREE_PARTS = ("tile", "total", "tail", "prefix", "rows")
MAX_BLOCKS = 4096
SLOTS = 16  # stamps 0 .. 14 a block, its ticket in the last
STAMP = f"""
__device__ long long comp_stamps[{MAX_BLOCKS}][{SLOTS}];
#define STAMP_NB(k) {{ if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) \\
    comp_stamps[blockIdx.x][k] = clock64(); }}
#define STAMP(k) {{ __syncthreads(); STAMP_NB(k) }}
"""
READ = """
extern "C" int read_compaction_profile(void* host) {
    return (int)cudaMemcpyFromSymbol(host, comp_stamps, sizeof(comp_stamps));
}
"""
# (a piece of the kernel's source, the piece with the part's stamp)
MARKS = (
    ("namespace {\n\nconstexpr int NT", "namespace {\n" + STAMP
     + "\nconstexpr int NT"),
    ("    const int ticket = misc[M_TICKET];\n",
     "    const int ticket = misc[M_TICKET];\n    STAMP(0)\n"
     f"    if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) "
     f"comp_stamps[blockIdx.x][{SLOTS - 1}] = ticket;\n"),
    ("    mbar_wait((unsigned long long*)(smem + SC_BAR), 0);\n"
     "    __syncthreads();\n",
     "    mbar_wait((unsigned long long*)(smem + SC_BAR), 0);\n"
     "    __syncthreads();\n    STAMP(1)\n"),
    ("    // 3. the fills at and above L;",
     "    STAMP(2)\n    // 3. the fills at and above L;"),
    ("    fill_rows(a, imax(L, tile0), imin(a.C, tile0 + TILE));\n",
     "    fill_rows(a, imax(L, tile0), imin(a.C, tile0 + TILE));\n"
     "    STAMP(3)\n"),
    ("        const Agg e = look_back(a, t, msn);\n",
     "        const Agg e = look_back(a, t, msn);\n        STAMP_NB(4)\n"),
    ("    // 4. the runs' rows and the text\n",
     "    // 4. the runs' rows and the text\n    STAMP(5)\n"),
    ("    const long long base = (int)len0;\n",
     "    STAMP(6)\n    const long long base = (int)len0;\n"),
    (": tile_text(a, smem, kt, (int)i);\n}\n",
     ": tile_text(a, smem, kt, (int)i);\n    STAMP(7)\n}\n"),
    ("        fill_rows(a, imax(L, ticket * TILE), imin(a.C, (ticket + 1) "
     "* TILE));\n",
     "        fill_rows(a, imax(L, ticket * TILE), imin(a.C, (ticket + 1) "
     "* TILE));\n    STAMP(1)\n"),
    ("        if (threadIdx.x == 0) misc[M_TOTAL] = (int)total;\n    }\n"
     "    __syncthreads();\n",
     "        if (threadIdx.x == 0) misc[M_TOTAL] = (int)total;\n    }\n"
     "    __syncthreads();\n    STAMP(2)\n"),
    ("    fill_range(a.arena_out, z + tail * w / W, z + tail * (w + 1) / W, "
     "0);\n",
     "    fill_range(a.arena_out, z + tail * w / W, z + tail * (w + 1) / W, "
     "0);\n    STAMP(3)\n"),
    ("    const int m = misc[M_M];\n",
     "    const int m = misc[M_M];\n    STAMP(4)\n"),
    ("    if (w == 0 && threadIdx.x == 0) {\n",
     "    STAMP(5)\n    if (w == 0 && threadIdx.x == 0) {\n"),
)


def instrument(src: str) -> str:
    """The kernel's source with the stamps and `read_compaction_profile`;
    raises where a piece of MARKS is not found once."""
    for old, new in MARKS:
        if src.count(old) != 1:
            raise ValueError(f"compaction_profile: no single piece {old!r} "
                             "in the kernel's source")
        src = src.replace(old, new)
    return src + READ


TEXT_CAP_LINE = "constexpr int TEXT_CAP = 3072;"


def without_text_read(src: str) -> str:
    """The kernel's source with TEXT_CAP 0: no text read into shared
    memory beside the look-back; raises where the line is not found
    once."""
    if src.count(TEXT_CAP_LINE) != 1:
        raise ValueError("compaction_profile: no single TEXT_CAP line in the "
                         "kernel's source")
    return src.replace(TEXT_CAP_LINE, "constexpr int TEXT_CAP = 0;")


def build(variants: dict) -> dict:
    """{name: the loaded library} of each {name: source}, compiled by
    one nvcc each, all started together."""
    from fluidframework_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "compaction_profile")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu = os.path.join(out_dir, f"zamboni_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (cu[:-3] + ".so", subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", cu[:-3] + ".so",
             cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def check_exact(kernel, comp_args, want, want_arena, what: str) -> None:
    """Raises unless `kernel` on `comp_args` gives the plain version's
    table and arena."""
    got, got_arena = kernel(*comp_args)
    for f in ("n_rows", "error", "buf_start", "length", "ins_seq",
              "ins_client", "rem_seq", "rem_clients", "props"):
        if not (getattr(got, f) == getattr(want, f)).all():
            raise AssertionError(f"the {what} compaction differs from the "
                                 f"plain version in {f}")
    if not (got_arena == want_arena).all():
        raise AssertionError(f"the {what} compaction's arena differs from "
                             "the plain version's")


def split(stamps, n_blocks: int, t_last: int) -> tuple:
    """Per part, (mean, max) cycles over the tile blocks, then over the
    free blocks, from the stamps of a launch of `n_blocks`."""
    tiles, free = [], []
    for b in range(min(n_blocks, MAX_BLOCKS)):
        row = stamps[b * SLOTS:(b + 1) * SLOTS]
        if row[SLOTS - 1] <= t_last:
            tiles.append([row[k + 1] - row[k] for k in range(len(TILE_PARTS))])
        else:
            free.append([row[k + 1] - row[k] for k in range(len(FREE_PARTS))])

    def stats(rows, n):
        return [(sum(r[k] for r in rows) / max(len(rows), 1),
                 max((r[k] for r in rows), default=0)) for k in range(n)]

    return (len(tiles), stats(tiles, len(TILE_PARTS)), len(free),
            stats(free, len(FREE_PARTS)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=500_000,
                    help="headline ops of the chunk-path replay whose deep "
                         "compaction is profiled")
    args = ap.parse_args()
    for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    if not torch.cuda.is_available():
        print("compaction_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from compaction_timing import deep_compaction
    from fluidframework_tpu_torch.ops import zamboni_kernel as tzk
    from fluidframework_tpu_torch.ops.zamboni import compact_gather_text_ref
    from fluidframework_tpu_torch.testing.golden import (
        headline_stream, load_golden,
    )

    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    from fluidframework_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "zamboni.cu")) as f:
        src = f.read()
    libs = build({"profile": instrument(src),
                  "no_text_read": without_text_read(src)})
    lib = libs["profile"]
    stamped, late = tzk.CompactionKernel(), tzk.CompactionKernel()
    stamped._fn = tzk.CompactionKernel.bind(lib)
    late._fn = tzk.CompactionKernel.bind(libs["no_text_read"])
    golden = load_golden()
    comp_args = deep_compaction(headline_stream(golden),
                                golden["params"]["initial_len"], args.ops, dev)
    table = comp_args[0]
    want, want_arena = compact_gather_text_ref(*comp_args)
    check_exact(stamped, comp_args, want, want_arena, "stamped")
    check_exact(late, comp_args, want, want_arena, "TEXT_CAP 0")
    ms = cs.spin_time(lambda: tzk.compaction_kernel(*comp_args), 32)
    ms_stamped = cs.spin_time(lambda: stamped(*comp_args), 32)
    stamped(*comp_args)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (MAX_BLOCKS * SLOTS))()
    if lib.read_compaction_profile(buf) != 0:
        raise RuntimeError("compaction_profile: reading the stamps failed")
    C = table.length.shape[0]
    G = tzk.tiles(C)
    n_blocks = G + min(max(G // 8, 1), 32)
    live = min(max(int(table.n_rows), 0), C)
    t_last = (live - 1) // tzk.TILE if live else -1
    n_t, tile_parts, n_f, free_parts = split(list(buf), n_blocks, t_last)
    print(f"compaction at {args.ops} ops (C {C}, {live} live rows, "
          f"{int(want.n_rows)} runs, arena {comp_args[2].shape[0]}): "
          f"{ms:.6f} ms a call ({ms_stamped:.6f} stamped), {n_blocks} "
          f"blocks", flush=True)
    print(f"tile blocks ({n_t}), cycles mean / max: " + ", ".join(
        f"{p} {m:.0f} / {x}" for p, (m, x) in zip(TILE_PARTS, tile_parts)))
    print(f"free blocks ({n_f}), cycles mean / max: " + ", ".join(
        f"{p} {m:.0f} / {x}" for p, (m, x) in zip(FREE_PARTS, free_parts)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    regular = lambda: tzk.compaction_kernel(*comp_args)  # noqa: E731
    no_read = lambda: late(*comp_args)  # noqa: E731
    abba = [cs.spin_time(fn, 32) for fn in (regular, no_read, no_read,
                                            regular)]
    print(f"the text's read beside the look-back, ms a call: TEXT_CAP "
          f"3072 (regular) {abba[0]:.6f}, {abba[3]:.6f}; TEXT_CAP 0 "
          f"{abba[1]:.6f}, {abba[2]:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
