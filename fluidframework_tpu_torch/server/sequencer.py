"""Nack codes and wording of the deli.

Copied from fluidframework_tpu/server/sequencer.py (:29-52: the nack
codes and the three reason helpers). The scalar `DocumentSequencer` is
not copied: the tests hold the port's deli against the reference's.
The checkpoint unwrap, `unwrap_ranged_state`, lives in
`server.supervisor`.
"""

from __future__ import annotations

NACK_STALE_REFSEQ = 400
NACK_UNKNOWN_CLIENT = 403
NACK_OUT_OF_ORDER = 422
NACK_FUTURE_REFSEQ = 416


# Nack reason wording, the same for the scalar sequencer and the
# kernel deli wherever the host mirror has the inputs (codes are the
# wire contract; reasons are for humans and logs).

def stale_refseq_reason(ref_seq: int, min_seq: int) -> str:
    return f"refSeq {ref_seq} below MSN {min_seq}"


def future_refseq_reason(ref_seq: int, head_seq: int) -> str:
    return f"refSeq {ref_seq} ahead of head {head_seq}"


def out_of_order_reason(client_seq: int, expected: int) -> str:
    return f"clientSeq {client_seq}, expected {expected}"

