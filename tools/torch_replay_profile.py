#!/usr/bin/env python3
"""Where the port's overlay replay spends device time (one GPU).

    python3 tools/torch_replay_profile.py [--ops N]

Replays N ops (default 1000000, the headline) of the seed-7 lagged stream at
the bench geometry through `fluidframework_tpu_torch`'s
`OverlayDeviceReplica(device="cuda")` under `torch.profiler`, and
prints: the card's name and power limit, host wall time of the replay, device time per kernel name
(summed over the run), the device-busy share of the replay window
(union of all device activity over the window from first to last
device event) and the idle share. Writes the JSON summary to
``chiprun_out/torch_replay_profile.json``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ops", type=int, default=1_000_000)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fluidframework_tpu_torch.core.overlay_replay import (
        OverlayDeviceReplica,
    )
    from fluidframework_tpu_torch.testing.synthetic import (
        generate_lagged_stream,
    )

    stream = generate_lagged_stream(args.ops, n_clients=1024, seed=7,
                                    window=1024, initial_len=64)

    def replica():
        return OverlayDeviceReplica(stream, initial_len=64, chunk_size=256,
                                    window=2048, n_removers=24,
                                    n_prop_keys=8, device="cuda")

    warm = replica()
    warm.replay(limit_chunks=8)  # build + first launches outside the window
    rep = replica()
    rep.prepare()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rep.replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rep.check_errors()

    by_name = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    gpu = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    summary = {"gpu": gpu, "nvidia_smi": smi, "ops": args.ops,
               "chunks": rep.n_chunks, "wall_s": wall}
    if not spans:
        print("torch.profiler recorded no device time on this machine")
        summary["device_events"] = 0
    else:
        spans.sort()
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - spans[0][0]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        summary.update({
            "device_window_ms": window / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / window,
            "kernels": [{"name": n[:120], "total_ms": t / 1e3, "count": c}
                        for n, (t, c) in top[:15]],
        })
        print(f"{gpu}: {args.ops} ops, {rep.n_chunks} chunks, replay wall "
              f"{wall:.3f}s (profiled)")
        print(f"device window {window / 1e3:.1f} ms, busy {busy / 1e3:.1f} "
              f"ms, idle share {1 - busy / window:.4f}")
        for n, (t, c) in top[:15]:
            print(f"  {t / 1e3:10.2f} ms  {c:7d}x  {n[:100]}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_replay_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
