"""fold_golden.json stays the reference's answer, and the port meets it.

`fluidframework_tpu_torch/testing/fold_golden.json` (written by
tools/fold_golden.py with the JAX kernel fold backend) pins the digest
of every emission of the fold bench's loop and the JAX summary role's
manifests; the card is held to it without JAX. Here, on the CPU:

- the JAX kernel backend recomputes the first two documents' first
  three emissions, so the file cannot drift from the reference
  silently;
- the port's `run_fold_sweep` (``device="cpu"``) reaches the same
  digests;
- the port's `SummaryFolder` gives the first document's first two
  manifests (seq, count, handle) of the file.
"""

import hashlib
import json

import pytest
import torch

from fluidframework_tpu.server.summarizer import (
    _boot_mergetree,
    _canonical_rows,
    _encode_fold,
    _fold_jobs,
)
from fluidframework_tpu.testing.deli_bench import build_mergetree_stream
from fluidframework_tpu_torch.server.summary_fold import SummaryFolder
from fluidframework_tpu_torch.testing import fold_streams

N_DOCS, N_EMISSIONS = 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return fold_streams.load_fold_golden()


def _streams(golden, n_records):
    p = golden["params"]
    return {d["doc"]: build_mergetree_stream(
        p["n_ops"], n_clients=p["n_clients"], seed=d["seed"],
        doc=d["doc"])[:n_records] for d in golden["docs"][:N_DOCS]}


def test_golden_parameters(golden):
    p = golden["params"]
    assert (p["n_ops"], p["n_clients"], p["summary_ops"]) == (3000, 4, 375)
    assert [d["seed"] for d in golden["docs"]] == list(range(40, 172))
    assert all(len(d["rows_sha256"]) == 9 for d in golden["docs"])
    assert sorted(golden["manifests"]) == ["doc0", "doc1", "doc2", "doc3"]
    assert all(len(m) == 8 for m in golden["manifests"].values())
    # The port's generator copy builds the reference's streams.
    assert fold_streams.golden_streams(golden, 1)["doc0"] == \
        build_mergetree_stream(3000, n_clients=4, seed=40, doc="doc0")


def test_jax_kernel_backend_recomputes_golden(golden):
    step = golden["params"]["summary_ops"]
    streams = _streams(golden, step * N_EMISSIONS)
    reps = {d: _boot_mergetree([], 0) for d in streams}
    msn = {d: 0 for d in streams}
    got = {d: [] for d in streams}
    for lo in range(0, step * N_EMISSIONS, step):
        jobs = []
        for doc, recs in streams.items():
            take = recs[lo: lo + step]
            _encode_fold(reps[doc], take)
            msn[doc] = max(msn[doc], max(r["msn"] for r in take))
            jobs.append((reps[doc], take))
        _fold_jobs(jobs)
        for doc in streams:
            rows = _canonical_rows(reps[doc], msn[doc])
            got[doc].append(hashlib.sha256(
                json.dumps(rows, sort_keys=True).encode()).hexdigest())
            reps[doc] = _boot_mergetree(rows, msn[doc])
    for d in golden["docs"][:N_DOCS]:
        assert got[d["doc"]] == d["rows_sha256"][:N_EMISSIONS]


def test_port_sweep_meets_golden(golden):
    step = golden["params"]["summary_ops"]
    out = fold_streams.run_fold_sweep(_streams(golden, step * N_EMISSIONS),
                                      step, "cpu")
    for d in golden["docs"][:N_DOCS]:
        assert out["digests"][d["doc"]] == d["rows_sha256"][:N_EMISSIONS]
    assert len(out["rounds"]) == N_EMISSIONS
    for r in out["rounds"]:
        assert r["emissions"] == N_DOCS and r["device_ms"] is None
        assert r["chunks"] == sum(g["chunks"] for g in r["groups"]) >= 3


def test_port_summary_folder_meets_golden_handles(golden):
    step = golden["params"]["summary_ops"]
    folder = SummaryFolder(summary_ops=step, device="cpu")
    for rec in _streams(golden, 2 * step)["doc0"]:
        folder.process(rec)
    got = [[m["seq"], m["count"], m["handle"]] for m in folder.flush()]
    assert got == golden["manifests"]["doc0"][:2]
