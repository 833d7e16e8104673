"""In-process ordered message log: the Kafka stand-in.

Copied from fluidframework_tpu/server/log.py (:141-272), in memory
only: `LogTopic`, `MessageLog` and `LogConsumer`, without the file
journal (a topic's `path`, a log's `directory` and the columnar
format) and without push subscriptions, which no port caller uses. It plays the role the reference's `LocalKafka`
(server/routerlicious/packages/memory-orderer/src/localKafka.ts:17)
plays for the in-proc pipeline: an append-only log per topic with
offset-addressed reads. Consumers pull from an offset they own
(checkpointed), so a restarted lambda resumes exactly where it left
off.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class LogTopic:
    """One append-only, offset-addressed message log."""

    def __init__(self, name: str):
        self.name = name
        self._messages: List[Any] = []

    def append(self, message: Any) -> int:
        """Append; returns the message's offset."""
        return self.append_many([message])

    def append_many(self, messages: List[Any]) -> int:
        """Append a batch (the lambdas' per-pump output flush). Returns
        the first offset."""
        off = len(self._messages)
        self._messages.extend(messages)
        return off

    def read(self, from_offset: int,
             max_count: Optional[int] = None) -> List[Any]:
        end = len(self._messages)
        if max_count is not None:
            end = min(end, from_offset + max_count)
        return self._messages[from_offset:end]

    @property
    def head(self) -> int:
        return len(self._messages)


class MessageLog:
    """Named topics (the broker)."""

    def __init__(self):
        self.topics: Dict[str, LogTopic] = {}

    def topic(self, name: str) -> LogTopic:
        if name not in self.topics:
            self.topics[name] = LogTopic(name)
        return self.topics[name]


class LogConsumer:
    """An offset-owning reader of one topic (the rdkafka consumer role,
    services-ordering-rdkafka/src/rdkafkaConsumer.ts:37). `offset` is
    the consumer's checkpoint state."""

    def __init__(self, topic: LogTopic, offset: int = 0):
        self.topic = topic
        self.offset = offset

    def poll(self, max_count: Optional[int] = None) -> List[Any]:
        msgs = self.topic.read(self.offset, max_count)
        self.offset += len(msgs)
        return msgs

    def checkpoint(self) -> int:
        return self.offset
