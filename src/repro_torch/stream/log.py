"""In-process event log: topics, partitions, consumer groups, retention.
A copy of the JAX package's ``stream/log.py`` (stdlib only): a key routes
to the same partition in both packages.

The shape is Kafka's, shrunk to one process and zero dependencies:

  - a *topic* is N append-only partitions; a record's partition is
    ``hash(key) % N`` so per-key order is preserved;
  - every record gets a monotonically increasing *offset* within its
    partition and a ``t_append`` wall-less timestamp (``time.monotonic``)
    stamped by the log — the freshness SLO measures from this instant;
  - *consumer groups* commit offsets per (group, topic, partition);
    ``poll`` resumes from the committed position, ``seek`` rewinds for
    replay;
  - *retention* is bounded per partition (``retention`` newest records);
    truncation advances the partition's base offset.  A consumer whose
    committed position has been truncated gets a typed
    :class:`OffsetTruncatedError` carrying the earliest offset still
    available — data loss is loud, never silent.

Thread-safety: one lock per topic guards appends, truncation, and group
commits, so multi-producer interleaving preserves per-partition offset
density (0,1,2,... from the base, no gaps, no duplicates).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable


class UnknownTopicError(KeyError):
    """Raised when a topic name has not been created."""


class OffsetTruncatedError(RuntimeError):
    """A consumer's position fell behind the retention window.

    Carries ``earliest`` — the first offset still held — so the consumer
    can decide: ``seek(earliest)`` and accept the (counted) gap, or
    abort.  The log never silently skips records.
    """

    def __init__(self, topic: str, partition: int, requested: int,
                 earliest: int):
        super().__init__(
            f"offset {requested} truncated from {topic}[{partition}] "
            f"(earliest retained: {earliest})")
        self.topic = topic
        self.partition = partition
        self.requested = requested
        self.earliest = earliest


@dataclass(frozen=True)
class Event:
    """One log record.  ``t_append`` is stamped by the log at append."""
    topic: str
    partition: int
    offset: int
    key: int
    kind: str
    payload: Any
    t_append: float


class _Partition:
    __slots__ = ("base", "records")

    def __init__(self):
        self.base = 0            # offset of records[0]
        self.records: list[Event] = []

    @property
    def end(self) -> int:        # next offset to be assigned
        return self.base + len(self.records)


class _Topic:
    def __init__(self, name: str, partitions: int, retention: int):
        self.name = name
        self.retention = retention
        self.lock = threading.Lock()            # guards everything below
        self.partitions = [_Partition() for _ in range(partitions)]
        # committed offsets: {group: [next_offset per partition]}
        # guarded-by: lock
        self.committed: dict[str, list[int]] = {}


class EventLog:
    """Named topics of append-only partitioned logs with bounded retention."""

    def __init__(self):
        self._topics: dict[str, _Topic] = {}
        self._lock = threading.Lock()   # guards the topic map only

    # -- topology ---------------------------------------------------------

    def create_topic(self, name: str, partitions: int = 1,
                     retention: int = 1 << 30) -> None:
        if partitions < 1:
            raise ValueError("partitions must be >= 1")
        if retention < 1:
            raise ValueError("retention must be >= 1")
        with self._lock:
            if name in self._topics:
                raise ValueError(f"topic {name!r} already exists")
            self._topics[name] = _Topic(name, partitions, retention)

    def _topic(self, name: str) -> _Topic:
        with self._lock:
            try:
                return self._topics[name]
            except KeyError:
                raise UnknownTopicError(name) from None

    def topics(self) -> list[str]:
        with self._lock:
            return sorted(self._topics)

    def n_partitions(self, topic: str) -> int:
        return len(self._topic(topic).partitions)

    # -- producing --------------------------------------------------------

    def append(self, topic: str, key: int, kind: str,
               payload: Any = None) -> Event:
        """Append one record; returns it with offset and t_append stamped."""
        t = self._topic(topic)
        pid = hash(key) % len(t.partitions)
        with t.lock:
            part = t.partitions[pid]
            ev = Event(topic, pid, part.end, key, kind, payload,
                       time.monotonic())
            part.records.append(ev)
            if len(part.records) > t.retention:
                drop = len(part.records) - t.retention
                del part.records[:drop]
                part.base += drop
            return ev

    def append_many(self, topic: str, records: Iterable[tuple[int, str, Any]],
                    ) -> list[Event]:
        return [self.append(topic, k, kind, p) for k, kind, p in records]

    # -- offsets ----------------------------------------------------------

    def earliest(self, topic: str, partition: int) -> int:
        t = self._topic(topic)
        with t.lock:
            return t.partitions[partition].base

    def end_offset(self, topic: str, partition: int) -> int:
        t = self._topic(topic)
        with t.lock:
            return t.partitions[partition].end

    def backlog(self, topic: str, group: str) -> int:
        """Total records between the group's committed position and the end."""
        t = self._topic(topic)
        with t.lock:
            pos = t.committed.get(group)
            total = 0
            for pid, part in enumerate(t.partitions):
                at = part.base if pos is None else max(pos[pid], part.base)
                total += part.end - at
            return total

    def latest(self, topic: str, partition: int = 0) -> Event | None:
        """Peek the newest record (snapshot-style topics, e.g. trending)."""
        t = self._topic(topic)
        with t.lock:
            recs = t.partitions[partition].records
            return recs[-1] if recs else None

    # -- consuming --------------------------------------------------------

    def _positions(self, t: _Topic, group: str) -> list[int]:
        # guarded-by: t.lock
        pos = t.committed.get(group)
        if pos is None:
            pos = [p.base for p in t.partitions]
            t.committed[group] = pos
        return pos

    def poll(self, topic: str, group: str, max_records: int = 256,
             ) -> list[Event]:
        """Read up to ``max_records`` from the group's committed position.

        Does NOT advance the commit — call :meth:`commit` with the events
        after processing them (at-least-once).  Raises
        :class:`OffsetTruncatedError` if any partition's committed
        position has been truncated out of retention.
        """
        t = self._topic(topic)
        out: list[Event] = []
        with t.lock:
            pos = self._positions(t, group)
            for pid, part in enumerate(t.partitions):
                if pos[pid] < part.base:
                    raise OffsetTruncatedError(topic, pid, pos[pid],
                                               part.base)
                take = part.records[pos[pid] - part.base:]
                room = max_records - len(out)
                out.extend(take[:room])
                if len(out) >= max_records:
                    break
        return out

    def commit(self, topic: str, group: str, events: list[Event]) -> None:
        """Advance the group's position past the given consumed events."""
        if not events:
            return
        t = self._topic(topic)
        with t.lock:
            pos = self._positions(t, group)
            for ev in events:
                if ev.offset + 1 > pos[ev.partition]:
                    pos[ev.partition] = ev.offset + 1

    def seek(self, topic: str, group: str, offset: int,
             partition: int | None = None) -> None:
        """Set the group's position (all partitions, or just one)."""
        t = self._topic(topic)
        with t.lock:
            pos = self._positions(t, group)
            pids = range(len(pos)) if partition is None else [partition]
            for pid in pids:
                pos[pid] = max(offset, 0)

    def position(self, topic: str, group: str, partition: int) -> int:
        t = self._topic(topic)
        with t.lock:
            return self._positions(t, group)[partition]
