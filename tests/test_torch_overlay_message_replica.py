"""The port's `OverlayKernelMessageReplica` vs the JAX one and the oracle.

The farm cases of tests/test_overlay_pallas.py:99-130 (real
concurrency: lagging refSeqs, insert tie-breaks, overlapping removes,
multi-pair annotations): each farm's sequenced stream replays through
the scalar oracle (`core.mergetree.replay_passive`), the JAX
`OverlayKernelMessageReplica` (the Pallas kernel in interpret mode) and
the port's (``device="cpu"``: the kernel's plain version), the messages
converted to the port's types through the wire form. Text, character
spans, structural invariants and the error word must agree exactly.
"""

import pytest
import torch

from fluidframework_tpu.core.mergetree import replay_passive
from fluidframework_tpu.core.overlay_replay import (
    OverlayKernelMessageReplica as JaxMessageReplica,
)
from fluidframework_tpu.protocol.mergetree_ops import op_to_json
from fluidframework_tpu.testing.farm import (
    FarmConfig,
    char_spans,
    run_sharedstring_farm,
)
from fluidframework_tpu_torch.core.overlay_replay import (
    OverlayKernelMessageReplica,
)
from fluidframework_tpu_torch.protocol.mergetree_ops import op_from_json
from fluidframework_tpu_torch.protocol.messages import (
    MessageType,
    SequencedMessage,
)


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


CASES = {
    **{f"seed{s}": (FarmConfig(num_clients=3, rounds=6,
                               ops_per_client_per_round=3, seed=s), 64)
       for s in range(4)},
    "more_clients": (FarmConfig(num_clients=8, rounds=5,
                                ops_per_client_per_round=4, seed=501), 32),
    "remove_heavy": (FarmConfig(
        num_clients=4, rounds=8, ops_per_client_per_round=4, seed=12,
        insert_weight=0.35, remove_weight=0.55, annotate_weight=0.1,
        initial_text="the quick brown fox jumps over the lazy dog"), 64),
    "annotate_heavy": (FarmConfig(
        num_clients=6, rounds=8, ops_per_client_per_round=4, seed=99,
        insert_weight=0.2, remove_weight=0.2, annotate_weight=0.6,
        initial_text="annotation heavy doc " * 4), 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_message_replica_matches_jax_and_oracle(case):
    cfg, chunk = CASES[case]
    farm = run_sharedstring_farm(cfg)
    oracle = replay_passive(farm.stream, cfg.initial_text)
    jax_rep = JaxMessageReplica(initial=cfg.initial_text, chunk_size=chunk,
                                window=1024, interpret=True)
    jax_rep.apply_messages(farm.stream)
    port = OverlayKernelMessageReplica(initial=cfg.initial_text,
                                       chunk_size=chunk, window=1024,
                                       device="cpu")
    port.apply_messages([port_message(m) for m in farm.stream])
    port.check_errors()
    port.verify_invariants()
    assert int(port.table.error) == int(jax_rep.table.error) == 0
    assert port.get_text() == jax_rep.get_text() == oracle.get_text()
    spans = char_spans(port.annotated_spans())
    assert spans == char_spans(jax_rep.annotated_spans())
    assert spans == char_spans(oracle.annotated_spans())
    assert int(port.table.n_rows) == int(jax_rep.table.n_rows)
    assert int(port.table.settled_len) == int(jax_rep.table.settled_len)


def test_message_replica_in_several_batches_and_fold_only():
    """Messages applied in several calls (each ending in a short chunk),
    and a call with nothing to encode (a fold-only epoch), equal one
    call with every message."""
    cfg, chunk = CASES["seed1"]
    farm = run_sharedstring_farm(cfg)
    msgs = [port_message(m) for m in farm.stream]
    whole = OverlayKernelMessageReplica(initial=cfg.initial_text,
                                        chunk_size=chunk, device="cpu")
    whole.apply_messages(msgs)
    parts = OverlayKernelMessageReplica(initial=cfg.initial_text,
                                        chunk_size=chunk, device="cpu")
    for lo in range(0, len(msgs), 17):
        parts.apply_messages(msgs[lo:lo + 17])
    noop = SequencedMessage(msgs[-1].sequence_number + 1,
                            msgs[-1].sequence_number, 1, 0,
                            msgs[-1].sequence_number, MessageType.NOOP)
    parts.apply_messages([noop])
    parts.verify_invariants()
    assert parts.get_text() == whole.get_text()
    assert char_spans(parts.annotated_spans()) == char_spans(
        whole.annotated_spans())
    assert int(parts.table.settled_len) == len(parts.get_text())
