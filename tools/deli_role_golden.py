#!/usr/bin/env python3
"""Write the supervised deli role's golden file, computed by the JAX
package's scalar role.

    JAX_PLATFORMS=cpu python3 tools/deli_role_golden.py

Runs the reference's scalar `DeliRole`
(fluidframework_tpu/server/supervisor.py:687, pure Python) over
BASELINE config 5's stream at the reference's pipeline-bench defaults
(testing/deli_bench.py:238-267): `build_pipeline_workload(10_000, 64,
1)`, 1,280,000 raw records, written as a columnar raw topic in frames
of 16384 (`deli_streams.write_raw_topic`), read with ``batch=16384``
and emitted to a columnar deltas topic, stepping the role until the
topic is drained. Records:

- ``deltas_sha256``: `deli_streams.RoleDigest` over the deltas topic's
  records in canonical form (``reason`` dropped, ``inOff`` kept; one
  ``json.dumps(..., sort_keys=True)`` line each);
- ``prefix_sha256``: the same digest over the outputs of the first
  ``prefix_pumps`` frames' inputs (``inOff`` below 4 x 16384);
- ``counts``: ops, joins, leaves and nacks in the deltas;
- ``checkpoint_sha256``: `deli_streams.checkpoint_digest` of the
  role's offset and final `snapshot_state()`.

Writes fluidframework_tpu_torch/testing/deli_role_golden.json. The
topics live in a temporary directory that is removed afterwards; the
deltas are hashed frame by frame as they are read back.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                   "deli_role_golden.json")
N_DOCS, N_CLIENTS, OPS_PER_CLIENT, SEED = 10_000, 64, 1, 5
BATCH = 16384  # the role's read cap and the raw topic's frame
PREFIX_PUMPS = 4


def main() -> int:
    sys.path.insert(0, ROOT)
    from fluidframework_tpu.server.columnar_log import (
        ColumnarFileTopic,
        ColumnarTailReader,
    )
    from fluidframework_tpu.server.supervisor import DeliRole
    from fluidframework_tpu_torch.testing.deli_streams import (
        RoleDigest,
        build_pipeline_workload,
        checkpoint_digest,
        write_raw_topic,
    )

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    recs = build_pipeline_workload(N_DOCS, N_CLIENTS, OPS_PER_CLIENT,
                                   seed=SEED)
    n = len(recs)
    with tempfile.TemporaryDirectory(prefix="deli-role-golden-") as shared:
        write_raw_topic(shared, recs, BATCH, "columnar")
        del recs
        print(f"raw topic: {n} records in {time.perf_counter() - t0:.1f}s",
              flush=True)
        role = DeliRole(shared, owner="golden", ttl_s=3600.0, batch=BATCH,
                        log_format="columnar")
        t0 = time.perf_counter()
        steps = 0
        while role.step():
            steps += 1
        print(f"scalar role: {steps} steps in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        digest = RoleDigest(prefix_off=PREFIX_PUMPS * BATCH)
        reader = ColumnarTailReader(ColumnarFileTopic(
            os.path.join(shared, "topics", "deltas.jsonl")), 0)
        while True:
            got = reader.poll(BATCH)
            if not got:
                break
            digest.update(r for _, r in got)
        cp = checkpoint_digest({"offset": role.offset,
                                "docs": role.snapshot_state()})
    golden = {
        "params": {"n_docs": N_DOCS, "n_clients": N_CLIENTS,
                   "ops_per_client": OPS_PER_CLIENT, "seed": SEED,
                   "batch": BATCH, "frame": BATCH, "records": n,
                   "steps": steps, "prefix_pumps": PREFIX_PUMPS,
                   "log_format": "columnar"},
        "deltas_sha256": digest.hexdigest(),
        "prefix_sha256": digest.prefix_hexdigest(),
        "counts": digest.counts,
        "checkpoint_sha256": cp,
    }
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(golden))
    print(f"total {time.perf_counter() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
