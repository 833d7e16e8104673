#!/usr/bin/env python3
"""The row model's scan engine alone on the card, at any depth.

    python3 tools/scan_engine_replay.py [--ops N] [--timed]

Replays the first N ops (default 1,000,000) of the headline stream
(GOLDEN.json's seed-7 lagged stream) through
`ColumnarReplica(engine="scan", device="cuda")` at bench.py's scan
geometry (`BENCH_ENGINE=scan`: capacity 131072, chunks of 256, 24
remover slots, 8 prop keys, compaction watermark 0.7), the path of
`chip_smoke.py` phase 27 (`chip_smoke.scan_engine_run`): the scan
kernel's launches equal the chunks, and the digest equals GOLDEN.json's
(the full digest at 1M ops, the stage digest at a multiple of 100k,
else it is printed ungated). Prints the card, the seconds and ops/s by
the host clock, the host compactions, the final capacity and live rows,
and the chunks at which each compaction ran, as one JSON line last.
``--timed`` wraps the replica's stages from outside, synchronises the
device around each and adds the split into uploads, scan launches (CUDA
events) and compact()'s pull, numpy work and push.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=1_000_000)
    ap.add_argument("--timed", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("scan_engine_replay: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from fluidframework_tpu_torch.core import columnar_replay as cr
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.testing.golden import (
        golden_digest, headline_stream, load_golden, stream_prefix,
    )

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    _build.load("mergetree_scan")
    _build.load("zamboni")
    golden = load_golden()
    stream = stream_prefix(headline_stream(golden), args.ops)
    want = golden_digest(golden, args.ops)
    compacted_at = []
    real = cr.ColumnarReplica.compact

    def compact(rep):
        compacted_at.append(rep.chunks_done)
        return real(rep)

    cr.ColumnarReplica.compact = compact
    run = chip_smoke.scan_engine_run(stream, golden["params"]["initial_len"],
                                     dev, want, split=args.timed)
    run.pop("replica")
    run.update(gated=want is not None, compacted_at_chunk=compacted_at,
               device=torch.cuda.get_device_name(0), smi=smi)
    print(f"{args.ops} ops in {run['seconds']:.3f}s = "
          f"{run['ops_per_s']:,.0f} ops/s; {run['compactions']} compactions, "
          f"capacity {run['capacity']}, {run['n_rows']} live rows; digest "
          f"{run['digest'][:8]} "
          + ("== GOLDEN.json" if want else "(no GOLDEN.json entry)"))
    print(json.dumps(run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
