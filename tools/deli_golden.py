#!/usr/bin/env python3
"""Write the deli's golden file, computed by the JAX package's scalar deli.

    JAX_PLATFORMS=cpu python3 tools/deli_golden.py

Runs the reference's scalar in-proc `DeliLambda`
(fluidframework_tpu/server/lambdas.py) over BASELINE config 5's stream
at the reference's bench defaults (testing/deli_bench.py:238-240):
`build_pipeline_workload(10_000, 64, 1)`, 1,280,000 raw records (a
join and one op per client per document, round robin over documents),
as in-proc raws (`testing/deli_streams.to_inproc`), pumped with
``max_pump=16384`` over an in-memory log until it drains. Records:

- ``deltas_sha256``: the digest of the whole deltas stream's
  normalized entries (`deli_streams.StreamDigest`: no timestamps);
- ``stamps`` and ``nacks``: its entry counts;
- ``checkpoint_sha256``: the final checkpoint's digest
  (`deli_streams.checkpoint_digest`: no ``last_update`` times);
- ``pump4_sha256``: the digest of the deltas after the first 4 pumps.

Writes fluidframework_tpu_torch/testing/deli_golden.json. The stream is
fed to the log one pump at a time and each pump's deltas are hashed and
dropped, so the run holds the raws but not the deltas.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                   "deli_golden.json")
N_DOCS, N_CLIENTS, OPS_PER_CLIENT, SEED = 10_000, 64, 1, 5
MAX_PUMP = 16384
PUMPS_PREFIX = 4


def main() -> int:
    sys.path.insert(0, ROOT)
    from fluidframework_tpu.server.lambdas import DeliLambda
    from fluidframework_tpu.server.log import MessageLog
    from fluidframework_tpu_torch.testing.deli_streams import (
        StreamDigest,
        build_pipeline_workload,
        checkpoint_digest,
        to_inproc,
    )

    t0 = time.perf_counter()
    raws = to_inproc(build_pipeline_workload(N_DOCS, N_CLIENTS,
                                             OPS_PER_CLIENT, seed=SEED))
    print(f"workload: {len(raws)} records in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    log = MessageLog()
    deli = DeliLambda(log, max_pump=MAX_PUMP)
    raw_topic, deltas = log.topic("rawdeltas"), log.topic("deltas")
    digest = StreamDigest()
    pump4 = None
    pumps = 0
    t0 = time.perf_counter()
    for lo in range(0, len(raws), MAX_PUMP):
        raw_topic.append_many(raws[lo:lo + MAX_PUMP])
        mark = deltas.head
        deli.pump()
        pumps += 1
        digest.update(deltas.read(mark))
        # drop the pump's deltas (nothing reads them again)
        deltas._messages[mark:] = [None] * (deltas.head - mark)
        if pumps == PUMPS_PREFIX:
            pump4 = digest.hexdigest()
    print(f"scalar deli: {pumps} pumps in {time.perf_counter() - t0:.1f}s",
          flush=True)
    golden = {
        "params": {"n_docs": N_DOCS, "n_clients": N_CLIENTS,
                   "ops_per_client": OPS_PER_CLIENT, "seed": SEED,
                   "max_pump": MAX_PUMP, "records": len(raws),
                   "pumps": pumps, "prefix_pumps": PUMPS_PREFIX},
        "deltas_sha256": digest.hexdigest(),
        "stamps": digest.stamps,
        "nacks": digest.nacks,
        "checkpoint_sha256": checkpoint_digest(deli.checkpoint()),
        "pump4_sha256": pump4,
    }
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(golden))
    return 0


if __name__ == "__main__":
    sys.exit(main())
