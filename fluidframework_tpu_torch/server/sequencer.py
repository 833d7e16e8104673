"""Nack codes and wording of the deli, and the checkpoint unwrap.

Copied from fluidframework_tpu/server/sequencer.py (:29-52: the nack
codes and the three reason helpers) and from
fluidframework_tpu/server/supervisor.py (:125-137: `unwrap_ranged_state`,
the one piece of the supervisor that an in-proc restore needs). The
scalar `DocumentSequencer` is not copied: the tests hold the port's
deli against the reference's.
"""

from __future__ import annotations

from typing import Any

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


def unwrap_ranged_state(state: Any) -> Any:
    """Deli checkpoint states come in two shapes: the classic per-doc
    `DocumentSequencer` map, and the elastic fabric's ranged envelope
    (``{"__ranged__": 1, "docs": {...}, "preds": {...}}``: the per-doc
    map plus predecessor catch-up cursors). Every deli restore unwraps
    through here, so a checkpoint written by a ranged role restores in
    any frontend: the doc states mean the same thing everywhere."""
    if (isinstance(state, dict) and state.get("__ranged__")
            and "docs" in state):
        return state.get("docs") or {}
    return state
