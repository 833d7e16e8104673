#!/usr/bin/env python3
"""Write the batched rebase's golden file, computed by the JAX package.

    JAX_PLATFORMS=cpu python3 tools/tree_golden.py

Runs the reference's `rebase_ops_columnar`
(fluidframework_tpu/tree/rebase_kernel.py) over BASELINE config 4's
inputs (`config4_tree_rebase`, tools/bench_configs.py:187-233, at
``BC_SCALE=1``: 100,000 pending ops over a 64-op trunk window from
``np.random.default_rng(4)``; drawn here by the port's copy of that
draw, `testing/tree_streams.config4_inputs`). Records:

- ``rebased_sha256``, ``spares_sha256``, ``flagged_sha256``: the
  SHA-256 of each output's dtype, shape and bytes
  (`tree_streams.array_digest`);
- ``flagged``, ``native_splits``, ``muted``: the counts that config 4
  reports (`tree_streams.rebase_counts`);
- ``params``: the generator's parameters.

Writes fluidframework_tpu_torch/testing/tree_golden.json (a few seconds).
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    from fluidframework_tpu.tree.rebase_kernel import rebase_ops_columnar
    from fluidframework_tpu_torch.testing import tree_streams as ts

    ops, base = ts.config4_inputs()
    t0 = time.perf_counter()
    out = rebase_ops_columnar(ops, base)
    print(f"JAX rebase_ops_columnar: {ops.shape[0]} ops over "
          f"{base.shape[0]} in {time.perf_counter() - t0:.2f}s "
          f"(compile included)", flush=True)
    golden = {
        "params": {"pending_ops": ts.CONFIG4_PENDING,
                   "window": ts.CONFIG4_WINDOW, "seed": ts.CONFIG4_SEED,
                   "scale": 1.0, "kinds": [0, 1, 2],
                   "index_range": [0, 100_000], "count_range": [1, 4],
                   "dst_range": [0, 100_000]},
        **{f"{k}_sha256": v for k, v in ts.digests(*out).items()},
        **ts.rebase_counts(*out),
    }
    with open(ts.GOLDEN, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(golden))
    return 0


if __name__ == "__main__":
    sys.exit(main())
