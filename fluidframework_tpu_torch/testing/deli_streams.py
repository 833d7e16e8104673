"""Deli traffic and digests for the port's sequencer and in-proc deli.

Copies, so that the card can use them without the JAX package:

- `build_pipeline_workload` from fluidframework_tpu/testing/
  deli_bench.py:42-71 (BASELINE config 5's raw stream: a join and
  ``ops_per_client`` ops per client per document, round robin over
  documents), without its `doc_names` override and with a `limit` that
  stops after that many records (the prefix is the full stream's);
- `gen_raw_traffic` from tests/test_deli_kernel.py:40-113 (in-proc raw
  records: joins, leaves, controls, boxcars, ops, with invalid
  submissions sprinkled in);
- `gen_traffic` from tests/test_sequencer_kernel.py:37-83 (one
  document's submission list for the sequencer itself);
- `norm_entry` from tests/test_deli_kernel.py:116-124.

New here: `to_inproc` (the wire dicts as the in-proc deli reads them),
`edge_chunks` (grouped, chunked sequencer traffic with every nack
code, dedup resubmissions, system stamps and out-of-range client
slots), `churn_raws` (a client-column set grown by churn), and the
digests: `StreamDigest` over normalized deltas entries (no timestamps)
and `checkpoint_digest` over a deli checkpoint without its
``last_update`` times.
"""

from __future__ import annotations

import hashlib
import json
import random
from typing import Iterable, List, Optional

import numpy as np

from ..ops.sequencer_kernel import (
    NO_GROUP,
    SUB_JOIN,
    SUB_LEAVE,
    SUB_OP,
    SUB_PAD,
    SUB_SYSTEM,
)
from ..protocol.messages import DocumentMessage, MessageType, SequencedMessage


def build_pipeline_workload(n_docs: int, n_clients: int,
                            ops_per_client: int, seed: int = 5,
                            limit: Optional[int] = None) -> List[dict]:
    """Deterministic raw-topic stream (wire dicts), round robin across
    docs. Each client's join rides immediately before its first op, so
    any prefix carries the stream's join:op mix. `limit` stops after
    that many records."""
    rng = random.Random(seed)
    docs = [f"doc{d}" for d in range(n_docs)]
    recs: List[dict] = []
    for i in range(ops_per_client):
        for c in range(1, n_clients + 1):
            for doc in docs:
                if limit is not None and len(recs) >= limit:
                    return recs[:limit]
                if i == 0:
                    recs.append({"kind": "join", "doc": doc, "client": c})
                recs.append({
                    "kind": "op", "doc": doc, "client": c,
                    "clientSeq": i + 1, "refSeq": 0,
                    "contents": {"v": rng.randint(0, 999), "i": i},
                })
    return recs if limit is None else recs[:limit]


def to_inproc(records: Iterable[dict]) -> List[dict]:
    """Wire dicts as the in-proc delis read them: joins and leaves as
    ``{"doc", "kind", "client"}``, ops as ``{"doc", "kind": "op",
    "client", "msg": DocumentMessage(clientSeq, refSeq, contents)}``."""
    out = []
    for r in records:
        kind = r["kind"]
        if kind in ("join", "leave"):
            out.append({"doc": r["doc"], "kind": kind, "client": r["client"]})
        elif kind == "op":
            out.append({"doc": r["doc"], "kind": "op", "client": r["client"],
                        "msg": DocumentMessage(
                            client_seq=r["clientSeq"], ref_seq=r["refSeq"],
                            contents=r.get("contents"))})
        else:
            raise ValueError(f"to_inproc: unsupported record kind {kind!r}")
    return out


def gen_raw_traffic(seed: int, n: int = 300, docs: int = 3,
                    clients: int = 4) -> List[dict]:
    """In-proc raw records: joins/leaves/controls/boxcars/ops with
    deliberately invalid submissions (clientSeq gaps, future/stale
    refSeqs, unknown clients) sprinkled in. A shadow model only shapes
    plausibility; correctness is judged by the oracle."""
    rng = random.Random(seed)
    recs = []
    state = {}
    conn = {d: set() for d in range(docs)}
    seqg = {d: 0 for d in range(docs)}
    for _ in range(n):
        d = rng.randrange(docs)
        doc = f"doc{d}"
        r = rng.random()
        if r < 0.10 or not conn[d]:
            c = rng.randrange(1, clients + 1)
            recs.append({"doc": doc, "kind": "join", "client": c})
            conn[d].add(c)
            state[(d, c)] = 0
            seqg[d] += 1
        elif r < 0.15:
            c = rng.randrange(1, clients + 1)
            was = c in conn[d]
            recs.append({"doc": doc, "kind": "leave", "client": c})
            conn[d].discard(c)
            if was:
                seqg[d] += 1
        elif r < 0.20:
            recs.append({"doc": doc, "kind": "control",
                         "type": MessageType.SUMMARY_ACK,
                         "contents": {"handle": "h", "n": rng.randrange(9)}})
            seqg[d] += 1
        elif r < 0.35:
            c = rng.choice(sorted(conn[d]))
            msgs = []
            for _ in range(rng.randrange(2, 6)):
                cs = state[(d, c)] + 1
                ref = rng.randint(max(0, seqg[d] - 3), seqg[d])
                bad = rng.random()
                if bad < 0.15:
                    cs += rng.randint(1, 2)  # clientSeq gap -> nack
                elif bad < 0.22:
                    ref = seqg[d] + rng.randint(1, 4)  # future refSeq
                msgs.append(DocumentMessage(client_seq=cs, ref_seq=ref,
                                            contents={"b": 1}))
                if cs == state[(d, c)] + 1 and 0 <= ref <= seqg[d]:
                    state[(d, c)] = cs
                    seqg[d] += 1
                else:
                    break  # shadow: the rest of the boxcar aborts
            recs.append({"doc": doc, "kind": "boxcar", "client": c,
                         "msgs": msgs})
        else:
            c = rng.choice(sorted(conn[d]))
            cs = state[(d, c)] + 1
            ref = rng.randint(max(0, seqg[d] - 3), seqg[d])
            bad = rng.random()
            if bad < 0.06:
                cs += 1
            elif bad < 0.10:
                ref = seqg[d] + 2
            elif bad < 0.14:
                c2 = rng.randrange(1, clients + 1)
                if c2 not in conn[d]:
                    c = c2  # unknown client
            recs.append({"doc": doc, "kind": "op", "client": c,
                         "msg": DocumentMessage(
                             client_seq=cs, ref_seq=ref,
                             contents={"v": rng.randrange(99)})})
            if (c in conn[d] and cs == state.get((d, c), -10) + 1
                    and 0 <= ref <= seqg[d]):
                state[(d, c)] = cs
                seqg[d] += 1
    return recs


def gen_traffic(rng: random.Random, n_ops: int, n_clients: int):
    """One document's submission list: (kind, client, client_seq,
    ref_seq), with stale/future refSeqs, clientSeq gaps, unknown
    clients and pads. A shadow model only shapes plausibility."""
    subs = []
    connected: dict = {}  # client -> client_seq counter
    seq_guess = 0  # tracks stamps to produce plausible ref_seqs
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.08 or not connected:
            c = rng.randrange(n_clients)
            subs.append((SUB_JOIN, c, 0, 0))
            connected[c] = 0
            seq_guess += 1
        elif r < 0.12:
            c = rng.randrange(n_clients)
            was = c in connected
            subs.append((SUB_LEAVE, c, 0, 0))
            connected.pop(c, None)
            if was:
                seq_guess += 1
        elif r < 0.16:
            subs.append((SUB_PAD, 0, 0, 0))
        else:
            c = rng.choice(list(connected.keys()))
            cs = connected[c] + 1
            ref = rng.randint(max(0, seq_guess - 4), seq_guess)
            bad = rng.random()
            if bad < 0.05:
                cs += rng.randint(1, 3)  # clientSeq gap
            elif bad < 0.08:
                ref = seq_guess + rng.randint(1, 5)  # future refSeq
            elif bad < 0.11:
                ref = -1 if rng.random() < 0.5 else 0  # often stale
            elif bad < 0.13:
                c2 = rng.randrange(n_clients)
                if c2 not in connected:
                    c = c2  # unknown client
            subs.append((SUB_OP, c, cs, ref))
            # only advance the shadow counter when plausibly valid
            if cs == connected.get(c, -10) + 1 and 0 <= ref <= seq_guess:
                connected[c] = cs
                seq_guess += 1
    return subs


def traffic_batch(traffic) -> List[np.ndarray]:
    """Equal-length per-document submission lists as four ``[D, B]``
    int32 arrays (kind, client, client_seq, ref_seq)."""
    a = np.asarray(traffic, np.int32)  # [D, B, 4]
    return [np.ascontiguousarray(a[:, :, i]) for i in range(4)]


def edge_chunks(seed: int, n_docs: int, n_clients: int, n_cols: int,
                chunk: int) -> List[List[np.ndarray]]:
    """Sequencer traffic over the edges of the step, cut into ``[D,
    chunk]`` pieces: `gen_traffic` per document, then system stamps in
    place of some pads, resubmissions of accepted-looking ops (for
    dedup), client slots outside ``[0, C)`` (negative, huge: the step
    clips them), and boxcar groups of 2-5 consecutive ops whose ids
    are unique per document over the whole stream, so that groups
    span chunk boundaries and the abort tracker must carry them.
    Returns ``[kind, client, client_seq, ref_seq, groups]`` per
    chunk."""
    rng = random.Random(seed)
    kinds = np.empty((n_docs, n_cols), np.int32)
    clients = np.empty((n_docs, n_cols), np.int32)
    cseqs = np.empty((n_docs, n_cols), np.int32)
    refs = np.empty((n_docs, n_cols), np.int32)
    groups = np.full((n_docs, n_cols), NO_GROUP, np.int32)
    for d in range(n_docs):
        subs = [list(s) for s in gen_traffic(rng, n_cols, n_clients)]
        for i, s in enumerate(subs):
            r = rng.random()
            if s[0] == SUB_PAD and r < 0.5:
                s[0] = SUB_SYSTEM
            elif s[0] == SUB_OP and r < 0.04:
                s[1] = rng.choice((-1, -7, n_clients + 3, 1 << 20))
            elif s[0] == SUB_OP and r < 0.12 and i > 0:
                prev = subs[rng.randrange(i)]
                if prev[0] == SUB_OP:  # resubmission of an earlier op
                    s[1:] = prev[1:]
        for i, s in enumerate(subs):
            kinds[d, i], clients[d, i], cseqs[d, i], refs[d, i] = s
        g, i = 0, 0
        while i < n_cols:
            if kinds[d, i] == SUB_OP and rng.random() < 0.25:
                n = rng.randint(2, 5)
                j = i
                while j < n_cols and j < i + n and kinds[d, j] == SUB_OP:
                    groups[d, j] = g
                    j += 1
                g += 1
                i = j
            else:
                i += 1
    return [[np.ascontiguousarray(a[:, lo:lo + chunk])
             for a in (kinds, clients, cseqs, refs, groups)]
            for lo in range(0, n_cols, chunk)]


def churn_raws(n_docs: int, n_clients: int, seed: int = 0) -> List[dict]:
    """In-proc raws in which each document sees `n_clients` distinct
    client ids join (so one pump that holds them all grows the pool's
    client columns past `n_clients`), a few ops from each, leaves of
    most of them, and more ops from the survivors."""
    rng = random.Random(seed)
    recs: List[dict] = []
    cseq = {}
    for d in range(n_docs):
        doc = f"churn{d}"
        ids = list(range(1, n_clients + 1))
        rng.shuffle(ids)
        for c in ids:
            recs.append({"doc": doc, "kind": "join", "client": c})
            cseq[(d, c)] = 0
        for c in ids[:: max(1, n_clients // 64)]:
            cseq[(d, c)] += 1
            recs.append({"doc": doc, "kind": "op", "client": c,
                         "msg": DocumentMessage(client_seq=cseq[(d, c)],
                                                ref_seq=rng.randint(0, 8),
                                                contents={"c": c})})
        keep = set(ids[: max(2, n_clients // 16)])
        for c in ids:
            if c not in keep:
                recs.append({"doc": doc, "kind": "leave", "client": c})
        for c in sorted(keep):
            cseq[(d, c)] += 1
            recs.append({"doc": doc, "kind": "op", "client": c,
                         "msg": DocumentMessage(client_seq=cseq[(d, c)],
                                                ref_seq=n_clients,
                                                contents={"k": c})})
    return recs


def norm_entry(e):
    """Deltas entry minus the timestamp (wall-clock differs by impl)."""
    m = e["msg"]
    if isinstance(m, SequencedMessage) or hasattr(m, "sequence_number"):
        return (e["doc"], e["kind"], m.sequence_number,
                m.minimum_sequence_number, m.client_id, m.client_seq,
                m.ref_seq, str(m.type), repr(m.contents))
    return (e["doc"], e["kind"], e["client"], m.client_seq, m.code)


class StreamDigest:
    """sha256 over a deltas stream's normalized entries (`norm_entry`,
    one ``repr`` line each), fed in any number of pieces; also counts
    stamps (``kind`` "op") and nacks."""

    def __init__(self):
        self._h = hashlib.sha256()
        self.stamps = 0
        self.nacks = 0

    def update(self, entries: Iterable[dict]) -> "StreamDigest":
        h = self._h
        for e in entries:
            h.update(repr(norm_entry(e)).encode())
            h.update(b"\n")
            if e["kind"] == "op":
                self.stamps += 1
            else:
                self.nacks += 1
        return self

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def checkpoint_digest(cp: dict) -> str:
    """sha256 of a deli checkpoint (offset and per-doc sequencer
    states) as canonical JSON, without the clients' ``last_update``
    times (wall clock in the scalar deli, 0.0 in the kernel delis)."""
    docs = {
        doc: {
            "doc_id": st["doc_id"], "seq": int(st["seq"]),
            "min_seq": int(st["min_seq"]),
            "clients": {str(cid): [int(v["ref_seq"]), int(v["client_seq"])]
                        for cid, v in st["clients"].items()},
        }
        for doc, st in cp["docs"].items()
    }
    body = {"offset": int(cp["offset"]), "docs": docs}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()
