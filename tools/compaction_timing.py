#!/usr/bin/env python3
"""Device time of the row model's compaction kernels (one GPU).

    python3 tools/compaction_timing.py [--depths 100000,500000] [--reps 20]

Times the two entries of ``fluidframework_tpu_torch/csrc/zamboni.cu``
on the tables `chip_smoke.py` holds them to, without the rest of the
smoke:

- the zamboni (`zamboni_kernel`) on phase 26's table: a scan-engine
  replay of the first 20,000 headline ops with no host compaction;
- the compaction (`compaction_kernel`, one launch a call) on the chunk
  path's table at each depth: the replica's table before its compaction
  after the first 4 of its last chunks (phase 7's at 500k ops), against
  the plain version `compact_gather_text_ref` on the card.

For each: ms a call by CUDA events behind a spin (`chip_smoke.spin_time`),
three times; for the compaction also by events around back-to-back
calls, the host's enqueue included, for the kernel and the plain
version; and each kernel launch's mean device time under
`torch.profiler`, with the launches a call. Prints the card's name and
power limit first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def events_ms(fn, reps: int) -> float:
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


def per_launch_us(fn, reps: int) -> dict:
    """Mean device microseconds of each kernel `fn` launches."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / e.count
            for e in prof.key_averages() if e.device_time_total > 0}


def deep_compaction(full, initial_len: int, ops: int, dev) -> tuple:
    """The arguments of phase 7's compaction on the first `ops` ops of
    the headline stream `full`: the chunk path's table before its
    compaction after the first 4 of its last chunks, its MSN, the arena
    and the stream text."""
    import chip_smoke as cs
    from fluidframework_tpu_torch.core.columnar_replay import ColumnarReplica
    from fluidframework_tpu_torch.ops.mergetree_chunk import apply_chunk_at
    from fluidframework_tpu_torch.testing.golden import stream_prefix

    s = stream_prefix(full, ops)
    r = ColumnarReplica(s, initial_len=initial_len, chunk_size=cs.CHUNK,
                        capacity=cs.ROW_CAPACITY, n_removers=cs.N_REMOVERS,
                        n_prop_keys=cs.N_PROP_KEYS,
                        sync_interval=cs.ROW_SYNC, device=dev)
    lo = (r.n_chunks - cs.DEEP_CHUNKS) // cs.ROW_SYNC * cs.ROW_SYNC
    r.replay(limit_chunks=lo)
    t, dev_ops = r.table, r.op_segment(0, ops)
    hi = min(lo + cs.ROW_SYNC, r.n_chunks)
    for ci in range(lo, hi):
        t = apply_chunk_at(t, dev_ops, ci * cs.CHUNK, cs.CHUNK)
    m = int(s.min_seq[min(hi * cs.CHUNK, ops) - 1])
    return t, m, r.arena, r.stream_text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="100000,500000",
                    help="ops of the chunk-path replays whose deep "
                         "compaction is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("compaction_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from fluidframework_tpu_torch.ops.zamboni import compact_gather_text_ref
    from fluidframework_tpu_torch.ops.zamboni_kernel import (
        compaction_kernel, zamboni_kernel,
    )
    from fluidframework_tpu_torch.testing.golden import (
        headline_stream, load_golden, stream_prefix,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    golden = load_golden()
    initial_len = golden["params"]["initial_len"]
    full = headline_stream(golden)

    rep = cs.scan_engine_replica(stream_prefix(full, cs.ZAMBONI_OPS),
                                 initial_len, dev, compact_watermark=1.1)
    rep.replay()
    msn = torch.tensor(rep._applied_min_seq, dtype=torch.int32, device=dev)
    zam = lambda: zamboni_kernel(rep.table, msn)  # noqa: E731
    print(f"zamboni, {cs.ZAMBONI_OPS}-op scan table ({int(rep.table.n_rows)} "
          f"rows): ms a call " + ", ".join(
              f"{cs.spin_time(zam, args.reps):.6f}" for _ in range(3)))
    for name, us in per_launch_us(zam, args.reps).items():
        print(f"  {us:8.3f} us  {name[:70]}")

    for ops in (int(x) for x in args.depths.split(",")):
        comp_args = deep_compaction(full, initial_len, ops, dev)
        t, arena = comp_args[0], comp_args[2]
        comp = lambda: compaction_kernel(*comp_args)  # noqa: E731
        plain = lambda: compact_gather_text_ref(*comp_args)  # noqa: E731
        print(f"compaction at {ops} ops ({int(t.n_rows)} rows, arena "
              f"{arena.shape[0]}; {compaction_kernel.LAUNCHES} launch a "
              f"call): ms a call " + ", ".join(
                  f"{cs.spin_time(comp, args.reps):.6f}" for _ in range(3))
              + f"; back to back {events_ms(comp, args.reps):.6f}, the "
              f"plain version {events_ms(plain, args.reps):.6f}")
        for name, us in per_launch_us(comp, args.reps).items():
            print(f"  {us:8.3f} us  {name[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
