"""Sequenced merge-tree record streams for the summary fold.

Copied from fluidframework_tpu/testing/deli_bench.py:1504-1559
(`build_mergetree_stream`): the reference's own generator for its fold
bench (`run_fold_backend_bench`, :603, the fold half of config15 in
tools/bench_configs.py). Each record is a sequenced deltas record
(``kind``, ``doc``, ``seq``, ``msn``, ``client``, ``clientSeq``,
``refSeq``, ``type``, ``contents``) whose ``contents`` is a merge-tree
wire op (`protocol.mergetree_ops.op_to_json` form).

`run_fold_sweep` is the emission loop of that bench on either of the
port's fold backends (``overlay`` or ``kernel``), `compare_fold_backends`
runs both over identical streams and requires every emission's digest
to agree before it reports a time, and fold_golden.json
(tools/fold_golden.py) pins the reference's digest of every emission
for the smoke's documents.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List


def build_mergetree_stream(n_ops: int, n_clients: int = 4,
                           seed: int = 10, doc: str = "doc0",
                           window: int = 64,
                           target_len: int = 400) -> List[dict]:
    """A deterministic SEQUENCED deltas stream of merge-tree wire ops:
    joins, then `n_ops` sequential insert/remove/annotate ops whose
    positions are valid at their refSeq (= seq-1) perspective, with
    the msn trailing by `window` (so summaries stay window-bounded)
    and document length hovering around `target_len` (so per-op kernel
    cost — O(live rows) — is flat and the log-length axis isolates
    replay cost, the thing summaries remove). A PREFIX of the stream
    is itself a valid stream, so one build serves every swept log
    length."""
    import random
    import string

    rng = random.Random(seed)
    recs: List[dict] = []
    seq = 0
    for c in range(1, n_clients + 1):
        seq += 1
        recs.append({"kind": "op", "doc": doc, "seq": seq, "msn": 0,
                     "client": c, "clientSeq": 0, "refSeq": seq - 1,
                     "type": "join", "contents": c})
    length = 0
    cseq = {c: 0 for c in range(1, n_clients + 1)}
    for _ in range(n_ops):
        c = rng.randint(1, n_clients)
        seq += 1
        cseq[c] += 1
        msn = max(0, seq - window)
        r = rng.random()
        p_ins = 0.45 if length < target_len else 0.25
        if length == 0 or r < p_ins:
            pos = rng.randint(0, length)
            text = "".join(
                rng.choices(string.ascii_lowercase, k=rng.randint(1, 6))
            )
            contents: dict = {"type": 0, "pos1": pos, "seg": text}
            length += len(text)
        elif r < p_ins + 0.35:
            a = rng.randint(0, length - 1)
            b = min(length, a + rng.randint(1, 6))
            contents = {"type": 1, "pos1": a, "pos2": b}
            length -= b - a
        else:
            a = rng.randint(0, length - 1)
            b = min(length, a + rng.randint(1, 8))
            contents = {"type": 2, "pos1": a, "pos2": b,
                        "props": {rng.choice(["bold", "color", "size"]):
                                  rng.choice([1, 2, "x", None])}}
        recs.append({"kind": "op", "doc": doc, "seq": seq, "msn": msn,
                     "client": c, "clientSeq": cseq[c],
                     "refSeq": seq - 1, "type": "op",
                     "contents": contents})
    return recs


# ---------------------------------------------------------------------------
# The fold bench's emission loop on the port, and its golden file
# ---------------------------------------------------------------------------

FOLD_GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "fold_golden.json")


def load_fold_golden() -> dict:
    """fold_golden.json: the reference's digests of every emission of
    the fold bench's loop (and the JAX summarizer role's manifests for
    the first documents), written by tools/fold_golden.py."""
    with open(FOLD_GOLDEN_PATH) as f:
        return json.load(f)


def golden_streams(golden: dict, n_docs: int) -> Dict[str, List[dict]]:
    """The first `n_docs` documents' record streams of fold_golden.json,
    generated again from its parameters."""
    p = golden["params"]
    return {
        d["doc"]: build_mergetree_stream(
            p["n_ops"], n_clients=p["n_clients"], seed=d["seed"],
            doc=d["doc"])
        for d in golden["docs"][:n_docs]
    }


def run_fold_sweep(streams: Dict[str, List[dict]], summary_ops: int,
                   device, backend: str = "overlay", plane=None) -> dict:
    """The emission loop of the reference's fold bench
    (`run_fold_backend_bench`, deli_bench.py:603-690) on one of the
    port's fold backends: for each slice of `summary_ops` records, every
    document boots from its last canonical rows, encodes the slice, all
    documents fold in one call (``overlay``: `fold_jobs_overlay`;
    ``kernel``: `summary_fold._fold_jobs`), and each one serializes its
    canonical rows and reboots. `plane` (a `DevicePlane`) lays each
    round's stacked fold over its entries, as the role's
    ``device_plane`` does.

    Returns ``digests`` (doc -> sha256 of each emission's rows, the
    bench's digest), ``seconds``, ``op_records`` (the merge-tree ops
    folded) and per round ``rounds``: ``encode_s``, ``fold_s``,
    ``serialize_s`` (serialization and reboot) by the host clock,
    ``device_ms`` (CUDA events around the round's launches; None on the
    CPU), ``groups`` (the fold's window or capacity groups) and
    ``chunks``: the kernel launches the round needs. For ``overlay``
    they are worked out from the replicas (per window, the most chunks
    of encoded rows of one document); for ``kernel`` they are the
    fold's own count of (chunk, capacity group) steps, since a replica
    may grow or compact between chunks, and ``steps``, the most chunks
    of one document, bounds them from below."""
    from ..core.overlay_fold import boot_overlay, fold_jobs_overlay
    from ..server.summary_fold import (
        _boot_mergetree,
        _canonical_rows,
        _encode_fold,
        _fold_jobs,
    )

    if backend == "overlay":
        def boot(rows, msn):
            return boot_overlay(rows, msn, device=device)

        fold = fold_jobs_overlay

        def rows_of(rep, msn):
            return rep.canonical_rows(msn)
    elif backend == "kernel":
        def boot(rows, msn):
            return _boot_mergetree(rows, msn, device=device)

        fold, rows_of = _fold_jobs, _canonical_rows
    else:
        raise ValueError(f"unknown fold backend {backend!r}")

    reps: Dict[str, object] = {}
    state = {d: ([], 0) for d in streams}
    msn_run = {d: 0 for d in streams}
    digests: Dict[str, List[str]] = {d: [] for d in streams}
    rounds = []
    n_ops = 0
    rec_len = max(len(r) for r in streams.values())
    t_all = time.perf_counter()
    for lo in range(0, rec_len, summary_ops):
        t0 = time.perf_counter()
        jobs, triggers = [], []
        for doc, recs in streams.items():
            take = recs[lo: lo + summary_ops]
            if not take:
                continue
            rep = reps.get(doc)
            if rep is None:
                rep = reps[doc] = boot(*state[doc])
            _encode_fold(rep, take)
            n_ops += sum(1 for r in take if r.get("type") == "op")
            msn_run[doc] = max(msn_run[doc], max(r["msn"] for r in take))
            jobs.append((rep, take))
            triggers.append((doc, rep, msn_run[doc]))
        pending = [(rep, len(rep._encoded)) for rep, _ in jobs]
        t1 = time.perf_counter()
        groups = fold(jobs, plane)
        t2 = time.perf_counter()
        steps = max((-(-n // rep.chunk_size) for rep, n in pending),
                    default=0)
        if backend == "overlay":
            per_window: Dict[int, int] = {}
            for rep, n in pending:
                if n:
                    per_window[rep.window] = max(
                        per_window.get(rep.window, 0),
                        -(-n // rep.chunk_size))
            chunks = sum(per_window.values())
        else:
            chunks = sum(g["chunks"] for g in groups)
        for doc, rep, msn in triggers:
            rows = rows_of(rep, msn)
            digests[doc].append(hashlib.sha256(
                json.dumps(rows, sort_keys=True).encode()).hexdigest())
            state[doc] = (rows, msn)
            reps[doc] = boot(rows, msn)
        t3 = time.perf_counter()
        dev_ms = [g["device_ms"] for g in groups]
        rounds.append(dict(
            emissions=len(triggers), encode_s=t1 - t0, fold_s=t2 - t1,
            serialize_s=t3 - t2, groups=groups, chunks=chunks, steps=steps,
            device_ms=None if None in dev_ms else sum(dev_ms)))
    return dict(digests=digests, rounds=rounds, op_records=n_ops,
                seconds=time.perf_counter() - t_all)


def compare_fold_backends(streams: Dict[str, List[dict]], summary_ops: int,
                          device) -> dict:
    """Both fold backends over identical streams, as the reference's
    `run_fold_backend_bench` runs them: the canonical rows of every
    emission must be byte-identical across backends (AssertionError
    naming the first document and emission that differ) before any
    time is reported. Returns each backend's `run_fold_sweep` result
    under its name and ``fold_backend_speedup``, kernel seconds over
    overlay seconds (the reference's name for that ratio)."""
    out = {b: run_fold_sweep(streams, summary_ops, device, backend=b)
           for b in ("kernel", "overlay")}
    for doc in streams:
        got, want = out["kernel"]["digests"][doc], \
            out["overlay"]["digests"][doc]
        if got != want:
            k = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            raise AssertionError(
                f"fold backends differ: {doc} emission {k}")
    out["fold_backend_speedup"] = (out["kernel"]["seconds"]
                                   / out["overlay"]["seconds"])
    return out


def as_messages(records: List[dict]) -> list:
    """Sequenced deltas records as `SequencedMessage`s, the contents of
    an ``op`` record parsed from the wire form (`op_from_json`), for the
    message-driven replicas."""
    from ..protocol.mergetree_ops import op_from_json
    from ..protocol.messages import MessageType, SequencedMessage

    out = []
    for r in records:
        kind = MessageType(r["type"])
        contents = r.get("contents")
        if kind == MessageType.OP:
            contents = op_from_json(contents)
        out.append(SequencedMessage(
            int(r["seq"]), int(r["msn"]), int(r["client"]),
            int(r.get("clientSeq", 0)), int(r.get("refSeq", 0)), kind,
            contents))
    return out
