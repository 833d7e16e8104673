"""Wire message types.

Copied from fluidframework_tpu/protocol/messages.py: `MessageType`
(:19) and `SequencedMessage` (:48) only, the part that the host op
encoder and the message-driven replica read. A client submits a
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
