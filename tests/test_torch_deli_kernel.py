"""The port's in-proc deli (`KernelDeliLambda(device="cpu")`) against
the JAX package's scalar `DeliLambda` and JAX `KernelDeliLambda`.

Identical raw traffic (made from a seed with `random.Random`) goes
through all three; the normalized deltas entries (stamps, nack codes,
MSNs, contents; no timestamps) must be equal, tolerance 0. Also:
checkpoints restore across all three in every direction, doc slots grow
and evict under ``max_resident`` with the msn-cold victim first, churn
compaction bounds the client columns, foreign and negative client ids
get the oracle's verdicts, `add_columns` equals per-record `add`, and
BASELINE config 5's workload builder (cut to 64 documents x 8 clients x
2 ops) flows through `to_inproc`.
"""

import random

import numpy as np
import pytest
import torch

from fluidframework_tpu.server.deli_kernel import (
    KernelDeliLambda as JaxKernelDeli,
)
from fluidframework_tpu.server.lambdas import DeliLambda
from fluidframework_tpu.server.log import MessageLog as JaxLog
from fluidframework_tpu.testing.deli_bench import (
    build_pipeline_workload as jax_workload,
)
from fluidframework_tpu_torch.ops.sequencer_kernel import SUB_JOIN, SUB_OP
from fluidframework_tpu_torch.protocol.messages import (
    DocumentMessage,
    MessageType,
)
from fluidframework_tpu_torch.server.deli_kernel import (
    KernelDeliLambda,
    PackedDeliCore,
    SeqPool,
)
from fluidframework_tpu_torch.server.log import MessageLog
from fluidframework_tpu_torch.testing.deli_streams import (
    build_pipeline_workload,
    checkpoint_digest,
    churn_raws,
    gen_raw_traffic,
    norm_entry,
    to_inproc,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(log, cp=None, **kw):
    return KernelDeliLambda(log, cp, device="cpu", **kw)


IMPLS = {
    "scalar": (DeliLambda, JaxLog),
    "jax_kernel": (JaxKernelDeli, JaxLog),
    "port": (_port, MessageLog),
}


def run(impl, recs, checkpoint=None, prefix=(), **kw):
    """Drain `recs` through one impl; `prefix` records sit before them
    on the raw topic (a restored consumer starts past them). Returns
    (normalized deltas written by this run, the deli)."""
    make, log_cls = IMPLS[impl]
    log = log_cls()
    raw = log.topic("rawdeltas")
    for r in list(prefix) + list(recs):
        raw.append(r)
    deli = make(log, checkpoint, **kw)
    while deli.pump():
        pass
    return [norm_entry(e) for e in log.topic("deltas").read(0)], deli


def three_way(recs, port_kw=(), jax_kw=()):
    a, _ = run("scalar", recs)
    b, _ = run("jax_kernel", recs, **dict(jax_kw))
    c, deli = run("port", recs, **dict(port_kw))
    assert a == b == c
    assert a, "no outputs"
    return a, deli


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_pump", [37, 8192])
def test_random_traffic_matches_scalar_and_jax_kernel(seed, max_pump):
    out, _ = three_way(gen_raw_traffic(seed), {"max_pump": max_pump},
                       {"max_pump": max_pump})
    kinds = {e[1] for e in out}
    assert kinds == {"op", "nack"}


def test_boxcar_abort_and_control_messages():
    # refSeq 1: the control's stamp left the MSN at 1
    msgs = [DocumentMessage(client_seq=1, ref_seq=1),
            DocumentMessage(client_seq=5, ref_seq=1),  # gap -> nack 422
            DocumentMessage(client_seq=2, ref_seq=1)]  # masked out
    recs = [
        {"doc": "d", "kind": "control", "type": MessageType.SUMMARY_ACK,
         "contents": {"handle": "x"}},
        {"doc": "d", "kind": "join", "client": 1},
        {"doc": "d", "kind": "boxcar", "client": 1, "msgs": msgs},
        {"doc": "d", "kind": "op", "client": 1,
         "msg": DocumentMessage(client_seq=2, ref_seq=1)},
        {"doc": "d", "kind": "control", "type": MessageType.SUMMARY_NACK,
         "contents": {"message": "no"}},
    ]
    out, _ = three_way(recs)
    assert [e[1] for e in out] == ["op", "op", "op", "nack", "op", "op"]
    assert out[0][4] == -1 and out[0][2] == 1  # system stamp, seq 1


@pytest.mark.parametrize("seed", [3, 4])
def test_checkpoint_restore_across_all_three(seed):
    """Half the stream through each impl, checkpoint, restore into each
    impl, finish: all nine paths emit the same tail, and the three
    checkpoints have the same digest."""
    recs = gen_raw_traffic(seed, n=240)
    half = len(recs) // 2
    cps = {}
    for impl in IMPLS:
        _, deli = run(impl, recs[:half])
        cps[impl] = deli.checkpoint()
    assert len({checkpoint_digest(cp) for cp in cps.values()}) == 1
    tails = []
    for cp in cps.values():
        for impl in IMPLS:
            full, _ = run(impl, recs[half:], checkpoint=cp,
                          prefix=recs[:half])
            tails.append(full)
    assert all(t == tails[0] for t in tails)
    assert tails[0]


def test_doc_slot_grow_and_evict():
    rng = random.Random(9)
    recs = [{"doc": f"doc{d}", "kind": "join", "client": 1}
            for d in range(40)]
    for i in range(6):
        for d in rng.sample(range(40), 25):
            recs.append({"doc": f"doc{d}", "kind": "op", "client": 1,
                         "msg": DocumentMessage(client_seq=i + 1, ref_seq=0,
                                                contents=i)})
    kw = {"max_pump": 16, "n_docs": 4, "max_resident": 8}
    _, deli = three_way(recs, kw, kw)
    pool = deli.core.pool
    assert len(pool.docs) == 40
    assert pool.resident_docs() < 40
    assert len(deli.checkpoint()["docs"]) == 40


def test_eviction_prefers_msn_cold_docs():
    pool = SeqPool(n_docs=2, n_clients=4, max_resident=2, device="cpu")
    pool.begin()
    pool.touch("lagging")
    pool.touch("cold")
    pool.docs["lagging"].update(seq=5, min_seq=0, clients={1: [0, 2]})
    pool.docs["cold"].update(seq=5, min_seq=5, clients={1: [5, 2]})
    pool.begin()
    pool.touch("newdoc")
    assert pool.docs["cold"]["slot"] is None
    assert pool.docs["lagging"]["slot"] is not None
    # with nothing cold, the least recently touched goes
    pool.docs["newdoc"].update(seq=3, min_seq=1, clients={2: [1, 1]})
    pool.begin()
    pool.touch("another")
    assert pool.docs["lagging"]["slot"] is None
    assert pool.docs["newdoc"]["slot"] is not None
    assert pool.n_docs == 2 and pool.resident_docs() == 2


def test_churn_compaction_bounds_client_columns():
    recs = []
    for wave in range(60):  # 120 distinct client ids, 2 live at a time
        a, b = 2 * wave + 1, 2 * wave + 2
        for c in (a, b):
            recs.append({"doc": "hot", "kind": "join", "client": c})
        for i in range(3):
            for c in (a, b):
                recs.append({"doc": "hot", "kind": "op", "client": c,
                             "msg": DocumentMessage(client_seq=i + 1,
                                                    ref_seq=0,
                                                    contents=wave)})
        for c in (a, b):
            recs.append({"doc": "hot", "kind": "leave", "client": c})
    _, deli = three_way(recs, {"max_pump": 16}, {"max_pump": 16})
    pool = deli.core.pool
    assert len(pool.docs["hot"]["cmap"]) <= 16
    assert pool.n_clients <= 32, pool.n_clients
    cp = deli.checkpoint()
    assert cp["docs"]["hot"]["clients"] == {}
    assert pool.docs["hot"]["cmap"] == {}


def test_churn_in_one_pump_grows_columns_past_1024():
    """Without a pump boundary to compact at, 1100 distinct ids grow the
    column axis to 2048 (the kernel's global layout on the card); the
    verdicts stay the oracle's, at an odd D."""
    recs = churn_raws(3, 1100, seed=1)
    kw = {"max_pump": len(recs), "n_docs": 5}
    _, deli = three_way(recs, kw, kw)
    assert deli.core.pool.n_clients == 2048
    assert deli.core.pool.n_docs == 5


def test_compaction_of_resident_doc_reloads_row():
    recs = [{"doc": "d", "kind": "join", "client": 50}]
    for c in range(1, 20):
        recs.append({"doc": "d", "kind": "join", "client": c})
        recs.append({"doc": "d", "kind": "leave", "client": c})
    for i in range(4):
        recs.append({"doc": "d", "kind": "op", "client": 50,
                     "msg": DocumentMessage(client_seq=i + 1, ref_seq=0,
                                            contents=i)})
    _, deli = three_way(recs, {"max_pump": 7}, {"max_pump": 7})
    cmap = deli.core.pool.docs["d"]["cmap"]
    assert cmap[50] == 1 and len(cmap) <= 12
    deli.checkpoint()
    assert deli.core.pool.docs["d"]["cmap"] == {50: 1}


def test_foreign_and_negative_client_ids():
    recs = [
        {"doc": "d", "kind": "join", "client": 1},
        {"doc": "d", "kind": "op", "client": 1,
         "msg": DocumentMessage(client_seq=1, ref_seq=0)},
        {"doc": "d", "kind": "op", "client": -1,
         "msg": DocumentMessage(client_seq=1, ref_seq=0)},
        {"doc": "d", "kind": "op", "client": 10**6,
         "msg": DocumentMessage(client_seq=1, ref_seq=0)},
        {"doc": "d", "kind": "leave", "client": -7},
        {"doc": "d", "kind": "op", "client": 1,
         "msg": DocumentMessage(client_seq=2, ref_seq=1)},
        {"doc": "d", "kind": "join", "client": -3},
        {"doc": "d", "kind": "op", "client": -3,
         "msg": DocumentMessage(client_seq=1, ref_seq=0)},
        {"doc": "d", "kind": "boxcar", "client": -9, "msgs": [
            DocumentMessage(client_seq=1, ref_seq=0),
            DocumentMessage(client_seq=2, ref_seq=0),
        ]},
        {"doc": "d", "kind": "leave", "client": -3},
        {"doc": "d", "kind": "op", "client": 1,
         "msg": DocumentMessage(client_seq=3, ref_seq=2)},
    ]
    out, _ = three_way(recs, {"max_pump": 3}, {"max_pump": 3})
    assert sum(e[1] == "nack" for e in out) == 4  # three 403s, one 400


def test_add_columns_matches_per_record_add():
    def drive(bulk):
        core = PackedDeliCore(device="cpu")
        core.begin()
        slot = core.touch("d")["slot"]
        core.add(slot, SUB_JOIN, 1)
        core.add(slot, SUB_JOIN, 2)
        pairs = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 3), (1, 9))
        if bulk:
            j = core.add_columns(
                np.full(6, slot), SUB_OP, np.array([c for c, _ in pairs]),
                np.array([q for _, q in pairs]), np.zeros(6, np.int64))
            handles = list(range(j, j + 6))
        else:
            handles = [core.add(slot, SUB_OP, c, q, 0) for c, q in pairs]
        res = core.run()
        return [(res.seq[h], res.msn[h], res.nack[h]) for h in handles]

    got = drive(True)
    assert got == drive(False)
    assert got[-1][2] == 422


def test_pipeline_workload_through_to_inproc():
    """BASELINE config 5's builder, cut to 64 docs x 8 clients x 2 ops:
    the copy gives the reference's records, and all three delis
    sequence them alike (pumps of 256 records)."""
    wire = build_pipeline_workload(64, 8, 2)
    assert wire == jax_workload(64, 8, 2)
    assert build_pipeline_workload(64, 8, 2, limit=100) == wire[:100]
    kw = {"max_pump": 256}
    out, deli = three_way(to_inproc(wire), kw, kw)
    assert len(out) == len(wire)  # every join and op stamped, no nack
    assert deli.core.pool.n_clients == 16 and deli.core.pool.n_docs == 64
