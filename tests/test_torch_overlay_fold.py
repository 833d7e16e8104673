"""The port's summary fold (`core/overlay_fold.py`) vs the JAX package.

The summarizer's emission loop (boot from rows, encode, fold,
canonical serialization, reboot: tests/test_device_plane.py:313-358)
runs on the port with ``device="cpu"`` (the kernel's plain version)
and on the JAX package's two fold backends: the overlay fold with the
Pallas kernel in interpret mode, and the row-model kernel fold. The
canonical rows must be equal at every emission (tolerance 0), which is
what makes blob bytes and handles engine-invariant.

Also: boot-then-serialize is a fixed point; three documents folded in
one stacked round equal their single folds; documents of different
windows fold as one group per window. The growing window is in
tests/test_torch_overlay_fold_window.py.
"""

import json

import pytest
import torch

from fluidframework_tpu.core import overlay_fold as jfold
from fluidframework_tpu.server.summarizer import (
    _boot_mergetree,
    _canonical_rows,
    _encode_fold as jax_encode_fold,
    _fold_jobs,
)
from fluidframework_tpu.testing.deli_bench import build_mergetree_stream
from fluidframework_tpu_torch.core.overlay_fold import (
    OverlayFoldReplica,
    boot_overlay,
    fold_jobs_overlay,
    merge_canonical_rows,
)
from fluidframework_tpu_torch.server.summary_fold import _encode_fold

@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _backend(name):
    """(boot, encode, fold, rows) of one fold backend."""
    if name == "port":
        return (lambda rows, msn: boot_overlay(rows, msn, device="cpu"),
                _encode_fold, lambda jobs: fold_jobs_overlay(jobs),
                lambda rep, msn: rep.canonical_rows(msn))
    if name == "jax_overlay":
        return (lambda rows, msn: jfold.boot_overlay(rows, msn,
                                                     interpret=True),
                jax_encode_fold,
                lambda jobs: jfold.fold_jobs_overlay(jobs, interpret=True),
                lambda rep, msn: rep.canonical_rows(msn))
    return (_boot_mergetree, jax_encode_fold, _fold_jobs, _canonical_rows)


def _emission_sweep(name, streams, summary_ops):
    """The summarizer's emission loop over one or more documents: all
    documents that reach a cadence point in the same record slice fold
    in one call (one stacked round). Returns {doc: [rows, ...]}."""
    boot, encode, fold, canon = _backend(name)
    state = {d: ([], 0) for d in streams}
    out = {d: [] for d in streams}
    n = max(len(r) for r in streams.values())
    for hi in range(summary_ops, n + 1, summary_ops):
        jobs = []
        for doc, recs in streams.items():
            if len(recs) < hi:
                continue
            rows, base_msn = state[doc]
            rep = boot(rows, base_msn)
            encode(rep, recs[hi - summary_ops: hi])
            jobs.append((doc, rep, max(r["msn"] for r in recs[:hi])))
        fold([(rep, None) for _, rep, _ in jobs])
        for doc, rep, msn in jobs:
            rows = canon(rep, msn)
            out[doc].append(rows)
            state[doc] = (rows, msn)
    return out


def _dumps(x):
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("seed,cadence", [(10, 60), (11, 25)])
def test_port_fold_canonical_rows_equal_both_jax_backends(seed, cadence):
    streams = {"doc0": build_mergetree_stream(300, n_clients=4, seed=seed)}
    port = _emission_sweep("port", streams, cadence)["doc0"]
    kernel = _emission_sweep("jax_kernel", streams, cadence)["doc0"]
    overlay = _emission_sweep("jax_overlay", streams, cadence)["doc0"]
    assert len(port) == 304 // cadence
    assert _dumps(port) == _dumps(kernel)
    assert _dumps(port) == _dumps(overlay)


def test_boot_then_serialize_is_a_fixed_point():
    recs = build_mergetree_stream(200, n_clients=3, seed=12)
    rows = _emission_sweep("jax_kernel", {"d": recs}, 100)["d"][-1]
    msn = max(r["msn"] for r in recs[:200])
    assert boot_overlay(rows, msn, device="cpu").canonical_rows(msn) == rows
    assert boot_overlay([], 0, device="cpu").canonical_rows(0) == []


def test_stacked_round_equals_single_folds():
    streams = {f"doc{i}": build_mergetree_stream(120, n_clients=3,
                                                 seed=30 + i, doc=f"doc{i}")
               for i in range(3)}
    stacked = _emission_sweep("port", streams, 60)
    for doc, recs in streams.items():
        single = _emission_sweep("port", {doc: recs}, 60)[doc]
        assert _dumps(stacked[doc]) == _dumps(single)
    kernel = _emission_sweep("jax_kernel", streams, 60)
    assert _dumps(stacked) == _dumps(kernel)


def test_stacked_round_is_one_group_per_window():
    """Three documents whose windows differ (one booted over many rows)
    fold in one call as two window groups, each one docs-form replay;
    the outputs equal the documents folded one at a time."""
    recs = {f"doc{i}": build_mergetree_stream(60, n_clients=3, seed=50 + i,
                                              doc=f"doc{i}")
            for i in range(3)}
    big = [["x" * 3, 0, -3, None, None, {"k": i}] for i in range(1100)]

    def reps():
        out = [boot_overlay([], 0, device="cpu"),
               boot_overlay(big, 0, device="cpu"),
               boot_overlay([], 0, device="cpu")]
        for rep, r in zip(out, recs.values()):
            _encode_fold(rep, r)
        return out

    together = reps()
    groups = fold_jobs_overlay([(r, None) for r in together])
    assert sorted((g["window"], g["docs"], g["chunks"]) for g in groups) == [
        (1024, 2, 1), (2048, 1, 1)]
    assert all(g["device_ms"] is None for g in groups)
    alone = reps()
    for r in alone:
        fold_jobs_overlay([(r, None)])
    for a, b in zip(together, alone):
        assert a.window == b.window
        assert a.canonical_rows(64) == b.canonical_rows(64)


def test_build_round_matches_jax():
    """A round's job (op columns, per-chunk MSNs, window, chunk count,
    log size) equals the JAX replica's, wide prop lists included."""
    recs = build_mergetree_stream(300, n_clients=4, seed=13)
    recs[40] = dict(recs[40], contents={
        "type": 0, "pos1": 0, "seg": "wide",
        "props": {f"k{i}": i for i in range(5)}})
    port = boot_overlay([], 0, device="cpu")
    jax_rep = jfold.boot_overlay([], 0, interpret=True)
    _encode_fold(port, recs)
    jax_encode_fold(jax_rep, recs)
    got, want = port.build_round(), jax_rep.build_round()
    for key in ("window", "n", "n_chunks", "log_cap"):
        assert got[key] == want[key], key
    assert got["msns"].tolist() == want["msns"].tolist()
    assert len(got["batch"]) == len(want["batch"]) == 10
    for a, b in zip(got["batch"], want["batch"]):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    assert port.build_round() is None


def test_merge_canonical_rows_matches_jax():
    raw = [("a", 0, -3, None, None, None), ("b", 0, -3, None, None, None),
           ("c", 5, 1, None, None, {"k": 1}), ("d", 5, 1, None, None,
                                                {"k": 1}),
           ("e", 5, 1, 7, [2, 1], None), ("f", 5, 1, 7, [2, 1], None),
           ("g", 5, 1, 7, [1], None), ("h", 0, -3, None, None, None)]
    assert merge_canonical_rows(raw) == jfold.merge_canonical_rows(raw)
    assert len(merge_canonical_rows(raw)) == 5


def test_corrupt_table_refuses_to_serialize():
    rep = boot_overlay([["abc", 7, 1, None, None, None]], 0, device="cpu")
    rep.table.length[0] = 0
    with pytest.raises(RuntimeError, match="structural invariants"):
        rep.canonical_rows(0)
    fresh = OverlayFoldReplica(device="cpu")
    assert fresh.window == 1024 and fresh.canonical_rows(0) == []
