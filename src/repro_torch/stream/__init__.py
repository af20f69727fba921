"""stream — in-process event-log subsystem and streaming update pipeline,
copied from the JAX package's ``stream/`` (numpy and stdlib only).

Kafka-shaped but dependency-free: named topics, append-only partitioned
logs, consumer groups with committed offsets, bounded retention, and
replay-from-offset (`log.py`).  On top of it, the lambda fast path the
paper's serving architecture assumes (`pipeline.py`): a sessionized
traffic source (`source.py`) appends impression/click events; a
streaming trainer consumes them in micro-batches and publishes per-step
deltas through the FeatureService API; a windowed-EMA updater maintains
user-profile features; and a trending-items aggregator keeps a top-k
fallback lane fresh for cold-start users.

This package imports neither torch nor the card — the launcher
(`repro_torch.launch.realtime`) injects the real `train_step` as a plain
``step_fn(events) -> upserts`` callable.
"""
from repro_torch.stream.log import (
    Event,
    EventLog,
    OffsetTruncatedError,
    UnknownTopicError,
)
from repro_torch.stream.pipeline import (
    ProfileEMAUpdater,
    StreamingTrainer,
    StreamSnapshot,
    StreamStats,
    TrendingAggregator,
    VersionedPublisher,
)
from repro_torch.stream.source import SessionizedSource

__all__ = [
    "Event",
    "EventLog",
    "OffsetTruncatedError",
    "UnknownTopicError",
    "ProfileEMAUpdater",
    "SessionizedSource",
    "StreamSnapshot",
    "StreamStats",
    "StreamingTrainer",
    "TrendingAggregator",
    "VersionedPublisher",
]
