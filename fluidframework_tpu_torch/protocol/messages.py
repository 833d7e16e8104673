"""Wire message types.

Copied from fluidframework_tpu/protocol/messages.py: `MessageType`
(:19), `DocumentMessage` (:35), `SequencedMessage` (:48),
`trace_submit_ts` (:65) and `NackMessage` (:99), the part that the
host op encoder, the message-driven replica and the deli read. The
class names and enum values are the reference's, so ``str(m.type)``
and ``m.type.value`` compare equal across the packages. A client submits a
message carrying (clientSequenceNumber, referenceSequenceNumber, type,
contents); the ordering service stamps (sequenceNumber,
minimumSequenceNumber) to produce a SequencedMessage that every replica
applies in order (reference: common/lib/protocol-definitions/src/
protocol.ts:133 and :212).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Optional


class MessageType(str, enum.Enum):
    # Reference: protocol-definitions/src/protocol.ts MessageType
    OP = "op"
    NOOP = "noop"
    CLIENT_JOIN = "join"
    CLIENT_LEAVE = "leave"
    PROPOSE = "propose"
    REJECT = "reject"
    SUMMARIZE = "summarize"
    SUMMARY_ACK = "summaryAck"
    SUMMARY_NACK = "summaryNack"
    NO_CLIENT = "noClient"
    CONTROL = "control"


@dataclass
class DocumentMessage:
    """A client-originated, not-yet-sequenced message."""

    client_seq: int  # clientSequenceNumber: per-client monotone counter
    ref_seq: int  # referenceSequenceNumber: last sequenced seq the client saw
    type: MessageType = MessageType.OP
    contents: Any = None
    metadata: Any = None
    # Which datastore / channel this op addresses (runtime envelope).
    address: Optional[str] = None


@dataclass
class SequencedMessage:
    """A message stamped with a total order by the sequencing service."""

    sequence_number: int
    minimum_sequence_number: int
    client_id: int  # integer client id (quorum-assigned slot)
    client_seq: int
    ref_seq: int
    type: MessageType = MessageType.OP
    contents: Any = None
    metadata: Any = None
    address: Optional[str] = None
    timestamp: float = 0.0
    # Trace annotations (reference: ISequencedDocumentMessage.traces).
    traces: list = field(default_factory=list)


def trace_submit_ts(metadata: Any) -> Optional[float]:
    """The submitting client's timestamp riding op metadata under
    "tr_sub" (foreign producers simply omit it)."""
    if isinstance(metadata, dict):
        ts = metadata.get("tr_sub")
        if isinstance(ts, (int, float)):
            return float(ts)
    return None


@dataclass
class NackMessage:
    """Rejection from the sequencing service (stale refSeq, unknown
    client, ...). Reference: deli nacks at server/routerlicious/
    packages/lambdas/src/deli/lambda.ts:967-982."""

    client_id: int
    client_seq: int
    code: int
    reason: str
