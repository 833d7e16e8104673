"""The port's `KernelReplica` vs the JAX one and the oracle.

The farm cases of tests/test_kernel_vs_oracle.py (real concurrency:
lagging refSeqs, insert tie-breaks, overlapping removes, multi-pair
annotations): each farm's sequenced stream replays through the scalar
oracle (`core.mergetree.replay_passive`), the JAX `KernelReplica` (its
XLA scan) and the port's (``device="cpu"``: the scan's plain version),
the messages converted to the port's types through the wire form. Text,
character spans, the error word, the capacity and the table rows
``[:n_rows]`` must agree exactly, also right after a compaction
mid-stream.
"""

import random
import string

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.core.kernel_replica import KernelReplica as JaxReplica
from fluidframework_tpu.core.mergetree import CollabClient, replay_passive
from fluidframework_tpu.protocol.mergetree_ops import op_to_json
from fluidframework_tpu.server.sequencer import DocumentSequencer
from fluidframework_tpu.testing.farm import (
    FarmConfig,
    char_spans,
    run_sharedstring_farm,
)
from fluidframework_tpu_torch.core.kernel_replica import (
    KernelReplica,
    read_segment_table,
)
from fluidframework_tpu_torch.protocol.mergetree_ops import (
    InsertOp,
    op_from_json,
)
from fluidframework_tpu_torch.protocol.messages import (
    MessageType,
    SequencedMessage,
)

COLS = ("buf_start", "length", "ins_seq", "ins_client", "rem_seq",
        "rem_clients", "props")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_message(m):
    """A JAX package SequencedMessage as the port's, through the wire
    form of its op."""
    contents = m.contents
    if m.type.value == "op" and contents is not None:
        contents = op_from_json(op_to_json(contents))
    return SequencedMessage(
        m.sequence_number, m.minimum_sequence_number, m.client_id,
        m.client_seq, m.ref_seq, MessageType(m.type.value), contents)


def _assert_tables_equal(port, ref):
    t = read_segment_table(port.table)
    j = jax.tree_util.tree_map(np.asarray, ref.table)
    n = int(j.n_rows)
    assert int(t.n_rows) == n and int(t.error) == int(j.error)
    assert port.capacity == ref.capacity == t.length.shape[0]
    for f in COLS:
        assert np.array_equal(getattr(t, f)[:n], getattr(j, f)[:n]), f
    assert port.arena.snapshot() == ref.arena.snapshot()
    assert port._pending_rows_bound == ref._pending_rows_bound


CASES = {
    **{f"small{s}": (FarmConfig(num_clients=3, rounds=8,
                                ops_per_client_per_round=3, seed=s),
                     dict(chunk_size=16, capacity=256))
       for s in range(6)},
    **{f"more_clients{s}": (FarmConfig(num_clients=8, rounds=6,
                                       ops_per_client_per_round=4,
                                       seed=500 + s),
                            dict(chunk_size=64, capacity=512, n_removers=8))
       for s in range(3)},
    "insert_heavy": (FarmConfig(num_clients=4, rounds=10,
                                ops_per_client_per_round=5, seed=11,
                                insert_weight=0.85, remove_weight=0.1,
                                annotate_weight=0.05, initial_text=""),
                     dict(chunk_size=32, capacity=512)),
    "remove_heavy": (FarmConfig(
        num_clients=4, rounds=10, ops_per_client_per_round=4, seed=12,
        insert_weight=0.35, remove_weight=0.55, annotate_weight=0.1,
        initial_text="the quick brown fox jumps over the lazy dog"),
        dict(chunk_size=32, capacity=512)),
    "tiny_chunks": (FarmConfig(num_clients=3, rounds=4,
                               ops_per_client_per_round=2, seed=3),
                    dict(chunk_size=1, capacity=256)),
    "compaction": (FarmConfig(num_clients=4, rounds=12,
                              ops_per_client_per_round=4, seed=77),
                   dict(chunk_size=16, capacity=128, compact_watermark=0.3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_replica_matches_jax_and_oracle(case):
    cfg, kw = CASES[case]
    farm = run_sharedstring_farm(cfg)
    oracle = replay_passive(farm.stream, cfg.initial_text)
    ref = JaxReplica(initial=cfg.initial_text, **kw)
    ref.apply_messages(farm.stream)
    port = KernelReplica(initial=cfg.initial_text, device="cpu", **kw)
    port.apply_messages([port_message(m) for m in farm.stream])
    port.check_errors()
    assert port.get_text() == ref.get_text() == farm.final_text
    spans = char_spans(port.annotated_spans())
    assert spans == char_spans(ref.annotated_spans())
    assert spans == char_spans(oracle.annotated_spans())
    assert port.annotated_spans() == ref.annotated_spans()
    _assert_tables_equal(port, ref)


@pytest.mark.parametrize("case", ["compaction", "remove_heavy", "small2"])
def test_kernel_replica_table_after_a_compaction_mid_stream(case):
    """Half the stream, a compaction, the other half: the table, arena
    and capacity equal the JAX replica's after each step."""
    cfg, kw = CASES[case]
    farm = run_sharedstring_farm(cfg)
    half = len(farm.stream) // 2
    ref = JaxReplica(initial=cfg.initial_text, **kw)
    port = KernelReplica(initial=cfg.initial_text, device="cpu", **kw)
    msgs = [port_message(m) for m in farm.stream]
    ref.apply_messages(farm.stream[:half])
    port.apply_messages(msgs[:half])
    _assert_tables_equal(port, ref)
    ref.compact()
    port.compact()
    _assert_tables_equal(port, ref)
    ref.apply_messages(farm.stream[half:])
    port.apply_messages(msgs[half:])
    _assert_tables_equal(port, ref)
    assert port.get_text() == farm.final_text


def test_kernel_replica_insert_with_none_prop():
    msg = SequencedMessage(1, 0, 1, 1, 0, MessageType.OP,
                           InsertOp(pos=0, text="abc",
                                    props={"k": None, "b": 1}))
    rep = KernelReplica(chunk_size=4, capacity=64, device="cpu")
    rep.apply_messages([msg])
    rep.check_errors()
    assert rep.get_text() == "abc"
    assert rep.annotated_spans() == [("abc", {"b": 1})]


def test_kernel_replica_sequential_inserts_grow_the_table():
    """One writer typing: the table grows from capacity 64 to hold every
    segment, as the JAX replica's does."""
    seqr = DocumentSequencer("d")
    client = CollabClient(1)
    seqr.join(1)
    client.engine.current_seq = seqr.seq
    stream = []
    rng = random.Random(5)
    for _ in range(200):
        text = "".join(rng.choice(string.ascii_lowercase) for _ in range(3))
        pos = rng.randint(0, len(client.get_text()))
        out = seqr.sequence(1, client.insert_local(pos, text))
        client.apply_msg(out)
        stream.append(out)
    ref = JaxReplica(chunk_size=64, capacity=64)
    ref.apply_messages(stream)
    port = KernelReplica(chunk_size=64, capacity=64, device="cpu")
    port.apply_messages([port_message(m) for m in stream])
    port.check_errors()
    assert port.get_text() == client.get_text() == ref.get_text()
    _assert_tables_equal(port, ref)
    assert port.capacity > 64
