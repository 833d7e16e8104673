#!/usr/bin/env python3
"""Write the summary fold's golden file, computed by the JAX package.

    JAX_PLATFORMS=cpu python3 tools/fold_golden.py [--docs N]

Runs the summary service's emission loop of the reference's fold bench
(`testing/deli_bench.run_fold_backend_bench`, the fold half of config15
in tools/bench_configs.py) with the JAX **kernel** fold backend (the
row-model scan, no Pallas) over the streams of
`build_mergetree_stream(3000, n_clients=4, seed=40 + i)` for i < N
(default 132; the first four are config15's), at the bench's cadence
of max(64, 3000 // 8) = 375 records: every round boots each document
from its last canonical rows, encodes the next 375 records, folds all
documents (`_fold_jobs`), serializes (`_canonical_rows`) and reboots.
For each emission it records the sha256 of
``json.dumps(rows, sort_keys=True)``, as the bench's digest gate does.

For the first four documents it also drives the JAX `SummarizerRole`
itself (kernel backend, ``summary_ops`` 375, over a deltas topic in a
temporary directory) and records each manifest's
``(seq, count, handle)``.

The overlay and kernel fold backends are byte-identical by contract
(tests/test_device_plane.py), so these are the reference's answers for
the port's overlay fold. Writes
fluidframework_tpu_torch/testing/fold_golden.json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "fluidframework_tpu_torch", "testing",
                   "fold_golden.json")
OPS, CLIENTS, SEED0, HANDLE_DOCS = 3000, 4, 40, 4
SUMMARY_OPS = max(64, OPS // 8)


def emission_digests(streams):
    """{doc: [sha256 of each emission's canonical rows]} from the
    bench's emission loop on the kernel backend."""
    from fluidframework_tpu.server.summarizer import (
        _boot_mergetree,
        _canonical_rows,
        _encode_fold,
        _fold_jobs,
    )

    reps, state = {}, {d: ([], 0) for d in streams}
    msn_run = {d: 0 for d in streams}
    digests = {d: [] for d in streams}
    rec_len = max(len(r) for r in streams.values())
    for lo in range(0, rec_len, SUMMARY_OPS):
        jobs, triggers = [], []
        for doc, recs in streams.items():
            take = recs[lo: lo + SUMMARY_OPS]
            if not take:
                continue
            rep = reps.get(doc)
            if rep is None:
                rep = reps[doc] = _boot_mergetree(*state[doc])
            _encode_fold(rep, take)
            msn_run[doc] = max(msn_run[doc], max(r["msn"] for r in take))
            jobs.append((rep, take))
            triggers.append((doc, rep, msn_run[doc]))
        _fold_jobs(jobs)
        for doc, rep, msn in triggers:
            rows = _canonical_rows(rep, msn)
            digests[doc].append(hashlib.sha256(
                json.dumps(rows, sort_keys=True).encode()).hexdigest())
            state[doc] = (rows, msn)
            reps[doc] = _boot_mergetree(rows, msn)
        print(f"  records {lo}..{lo + SUMMARY_OPS - 1}: "
              f"{len(triggers)} emissions", flush=True)
    return digests


def role_manifests(streams):
    """{doc: [[seq, count, handle], ...]} from the JAX summarizer role
    (kernel backend) over the documents' records, interleaved in
    slices of SUMMARY_OPS records as the bench feeds them."""
    from fluidframework_tpu.server.columnar_log import (
        make_tail_reader,
        make_topic,
    )
    from fluidframework_tpu.server.summarizer import SummarizerRole

    recs = []
    rec_len = max(len(r) for r in streams.values())
    for lo in range(0, rec_len, SUMMARY_OPS):
        for r in streams.values():
            recs.extend(r[lo: lo + SUMMARY_OPS])
    with tempfile.TemporaryDirectory() as shared:
        os.makedirs(os.path.join(shared, "topics"))
        deltas = make_topic(os.path.join(shared, "topics", "deltas.jsonl"),
                            "json")
        deltas.append_many(recs)
        role = SummarizerRole(shared, owner="fold-golden", ttl_s=3600.0,
                              log_format="json", summary_ops=SUMMARY_OPS,
                              fold_backend="kernel")
        role.fence = 1
        reader = make_tail_reader(deltas)
        out_all = {d: [] for d in streams}
        while True:
            entries = reader.poll(4096)
            if not entries:
                break
            out = []
            for line_idx, rec in entries:
                role.process(line_idx, rec, out)
            role.flush_batch(out)
            if out:
                role.out_topic.append_many(out, fence=1, owner="fold-golden")
            for m in out:
                out_all[m["doc"]].append([m["seq"], m["count"], m["handle"]])
            role.offset = reader.next_line
    return out_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=132)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from fluidframework_tpu.testing.deli_bench import build_mergetree_stream

    seeds = [SEED0 + i for i in range(args.docs)]
    streams = {f"doc{i}": build_mergetree_stream(
        OPS, n_clients=CLIENTS, seed=s, doc=f"doc{i}")
        for i, s in enumerate(seeds)}
    t0 = time.perf_counter()
    digests = emission_digests(streams)
    print(f"emission loop: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    first = dict(list(streams.items())[:HANDLE_DOCS])
    manifests = role_manifests(first)
    print(f"summarizer role: {time.perf_counter() - t0:.1f}s", flush=True)
    golden = {
        "source": ("tools/fold_golden.py: the JAX kernel fold backend "
                   "(server/summarizer.py) over build_mergetree_stream"),
        "params": {"n_ops": OPS, "n_clients": CLIENTS,
                   "summary_ops": SUMMARY_OPS,
                   "digest": "sha256(json.dumps(rows, sort_keys=True))"},
        "docs": [{"doc": d, "seed": s, "rows_sha256": digests[d]}
                 for d, s in zip(streams, seeds)],
        "manifests": manifests,
    }
    with open(OUT, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}: {args.docs} documents x "
          f"{len(digests['doc0'])} emissions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
