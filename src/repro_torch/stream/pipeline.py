"""Streaming update pipeline: trainer, profile EMA, trending, freshness.
A copy of the JAX package's ``stream/pipeline.py`` (numpy and stdlib).

The lambda fast path on top of :mod:`repro_torch.stream.log`:

  - :class:`VersionedPublisher` — the ONE place stream stages allocate
    store versions.  ``VersionWindow.publish`` does not enforce
    monotonicity, so concurrent publishers (trainer + profile + trending)
    must serialize version allocation with the publish itself; the
    publisher's lock does that, and stamps every covered event's
    append→servable freshness the instant the publish returns.
  - :class:`StreamingTrainer` — consumes event micro-batches, calls an
    injected ``step_fn(events) -> upserts`` (the launcher wires the real
    ``train_step``'s delta emission on the card; tests wire numpy),
    publishes the resulting delta.  A backlog beyond ``max_backlog`` is
    shed oldest-first (bounded staleness, counted, never a crash); a
    truncated committed offset is recovered by seeking to the earliest
    retained record (counted — the log already made the loss loud).
  - :class:`ProfileEMAUpdater` — windowed EMA of per-user engagement,
    flushed as ``user_profile`` upserts.
  - :class:`TrendingAggregator` — decayed impression/click counts,
    recomputed top-k appended to a snapshot topic and upserted as the
    cold-start fallback row.

All stages are :class:`StreamStage` threads (pull loop + stop event +
captured error) and count into one :class:`StreamStats` silo, bridged to
the obs registry by ``obs.bridge.bridge_stream_stats``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.stream.log import Event, EventLog, OffsetTruncatedError

__all__ = [
    "ProfileEMAUpdater",
    "StreamSnapshot",
    "StreamStage",
    "StreamStats",
    "StreamingTrainer",
    "TrendingAggregator",
    "VersionedPublisher",
]

_FRESHNESS_RESERVOIR = 8192     # newest samples kept for p50/p99


@dataclass(frozen=True)
class StreamSnapshot:
    """One consistent read of the pipeline's counters (the metrics silo —
    every field here is catalogued in ``obs/bridge.STREAM_METRICS``)."""
    events_consumed: int
    trainer_steps: int
    deltas_published: int
    rows_upserted: int
    profile_flushes: int
    trending_refreshes: int
    events_shed: int
    truncations_recovered: int
    staleness_violations: int
    min_version_violations: int
    freshness_samples: int
    freshness_p50_ms: float
    freshness_p99_ms: float
    updates_per_s: float


class StreamStats:
    """Thread-safe counter silo + freshness reservoir for the pipeline.

    ``slo_budget_s`` defines the staleness bound: any event whose
    append→servable latency exceeds it counts as a staleness violation.
    ``on_freshness`` (set by the obs bridge) additionally streams every
    sample into a registry histogram.
    """

    def __init__(self, slo_budget_s: float = 2.0):
        self.slo_budget_s = float(slo_budget_s)
        self.on_freshness: Optional[Callable[[float], None]] = None
        self._lock = threading.Lock()       # guards everything below
        self._t0 = time.monotonic()
        # guarded-by: _lock
        self._counts = {
            "events_consumed": 0, "trainer_steps": 0,
            "deltas_published": 0, "rows_upserted": 0,
            "profile_flushes": 0, "trending_refreshes": 0,
            "events_shed": 0, "truncations_recovered": 0,
            "staleness_violations": 0, "min_version_violations": 0,
            "freshness_samples": 0,
        }
        self._fresh: list[float] = []        # guarded-by: _lock

    def inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._counts[field] += n

    def observe_freshness(self, seconds: float) -> None:
        with self._lock:
            self._counts["freshness_samples"] += 1
            if seconds > self.slo_budget_s:
                self._counts["staleness_violations"] += 1
            self._fresh.append(seconds)
            if len(self._fresh) > _FRESHNESS_RESERVOIR:
                del self._fresh[:len(self._fresh) - _FRESHNESS_RESERVOIR]
        hook = self.on_freshness
        if hook is not None:
            hook(seconds)

    def snapshot(self) -> StreamSnapshot:
        with self._lock:
            counts = dict(self._counts)
            fresh = np.asarray(self._fresh, dtype=np.float64)
            elapsed = max(time.monotonic() - self._t0, 1e-9)
        p50 = float(np.percentile(fresh, 50) * 1e3) if fresh.size else 0.0
        p99 = float(np.percentile(fresh, 99) * 1e3) if fresh.size else 0.0
        return StreamSnapshot(
            freshness_p50_ms=p50, freshness_p99_ms=p99,
            updates_per_s=counts["deltas_published"] / elapsed, **counts)


class VersionedPublisher:
    """Serialize version allocation with the publish it names.

    ``client`` is a :class:`repro_torch.api.FeatureClient`; ``start_version``
    the store's current version.  ``publish`` allocates ``current + 1``,
    ships the delta, then (still inside the lock, so ``version`` never
    runs ahead of servability) stamps freshness for every covered event.
    """

    def __init__(self, client, start_version: int, stats: StreamStats):
        self._client = client
        self._stats = stats
        # optional (version, t0, t1, rows) hook — the launcher records a
        # publish span per delta through it
        self.on_publish: Optional[Callable[[int, float, float, int],
                                           None]] = None
        self._lock = threading.Lock()
        self._version = int(start_version)   # guarded-by: _lock

    @property
    def version(self) -> int:
        """Latest version known servable (safe for ``min_version`` reads)."""
        with self._lock:
            return self._version

    def publish(self, upserts: dict, events: tuple | list = ()) -> int:
        rows = sum(len(k) for k, _ in upserts.values())
        with self._lock:
            t0 = time.monotonic()
            v = self._version + 1
            self._client.update(v, upserts=upserts)
            self._version = v
            now = time.monotonic()
            for ev in events:
                self._stats.observe_freshness(now - ev.t_append)
        self._stats.inc("deltas_published")
        self._stats.inc("rows_upserted", rows)
        hook = self.on_publish
        if hook is not None:
            hook(v, t0, now, rows)
        return v

    def publish_full(self, *, scalars=(), embeddings=()) -> int:
        """Rolling batch-layer publish (full tables) under the same lock,
        so the batch and speed layers share one version sequence."""
        with self._lock:
            v = self._version + 1
            self._client.update(v, scalars=scalars, embeddings=embeddings)
            self._version = v
        return v


class StreamStage(threading.Thread):
    """A pull-loop stage: ``tick()`` every ``period_s`` until stopped.

    A tick that raises stops the stage and captures the exception in
    ``self.error`` — the launcher checks it instead of losing the
    traceback to a daemon thread.
    """

    def __init__(self, name: str, period_s: float = 0.01):
        super().__init__(name=name, daemon=True)
        self.period_s = float(period_s)
        self.error: Optional[BaseException] = None
        self._stop_ev = threading.Event()

    def run(self) -> None:
        while not self._stop_ev.wait(self.period_s):
            try:
                self.tick()
            except BaseException as e:  # noqa: BLE001 — surfaced to launcher
                self.error = e
                return

    def tick(self) -> None:
        raise NotImplementedError

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_ev.set()
        if self.is_alive():
            self.join(timeout)

    # -- shared consumer plumbing --------------------------------------

    def _poll(self, log: EventLog, topic: str, group: str,
              stats: StreamStats, max_records: int) -> list[Event]:
        """Poll, recovering a truncated offset by seeking to earliest."""
        try:
            return log.poll(topic, group, max_records=max_records)
        except OffsetTruncatedError as e:
            log.seek(topic, group, e.earliest, e.partition)
            stats.inc("truncations_recovered")
            return []


class StreamingTrainer(StreamStage):
    """Micro-batch consumer: events -> ``step_fn`` -> published delta.

    ``step_fn(events) -> upserts | None`` keeps this package free of
    torch: the realtime launcher passes a closure over the real
    ``train_step``'s delta emission; tests pass numpy.
    """

    def __init__(self, log: EventLog, topic: str,
                 publisher: VersionedPublisher, stats: StreamStats,
                 step_fn: Callable[[list[Event]], Optional[dict]], *,
                 group: str = "trainer", batch_events: int = 64,
                 max_backlog: int = 4096, period_s: float = 0.005):
        super().__init__("stream-trainer", period_s)
        self.log = log
        self.topic = topic
        self.publisher = publisher
        self.stats = stats
        self.step_fn = step_fn
        self.group = group
        self.batch_events = int(batch_events)
        self.max_backlog = int(max_backlog)

    def _shed_backlog(self) -> None:
        """Drop oldest events beyond ``max_backlog`` (bounded staleness:
        degrade to fresher data rather than training further behind)."""
        backlog = self.log.backlog(self.topic, self.group)
        if backlog <= self.max_backlog:
            return
        n_parts = self.log.n_partitions(self.topic)
        keep = max(self.max_backlog // n_parts, 1)
        shed = 0
        for pid in range(n_parts):
            pos = self.log.position(self.topic, self.group, pid)
            target = max(pos, self.log.end_offset(self.topic, pid) - keep)
            if target > pos:
                self.log.seek(self.topic, self.group, target, pid)
                shed += target - pos
        if shed:
            self.stats.inc("events_shed", shed)

    def tick(self) -> None:
        self._shed_backlog()
        events = self._poll(self.log, self.topic, self.group, self.stats,
                            self.batch_events)
        if not events:
            return
        upserts = self.step_fn(events)
        self.stats.inc("trainer_steps")
        if upserts:
            self.publisher.publish(upserts, events=events)
        self.log.commit(self.topic, self.group, events)
        self.stats.inc("events_consumed", len(events))


class ProfileEMAUpdater(StreamStage):
    """Windowed EMA of per-user engagement -> ``user_profile`` upserts.

    Each event folds into its user's profile vector with weight ``alpha``
    (an exponential window — recent sessions dominate); every tick that
    consumed events flushes the touched users' rows as one delta.
    """

    def __init__(self, log: EventLog, topic: str,
                 publisher: VersionedPublisher, stats: StreamStats, *,
                 table: str = "user_profile", dim: int = 8,
                 alpha: float = 0.2, group: str = "profile",
                 batch_events: int = 256, period_s: float = 0.01):
        super().__init__("stream-profile", period_s)
        self.log = log
        self.topic = topic
        self.publisher = publisher
        self.stats = stats
        self.table = table
        self.dim = int(dim)
        self.alpha = float(alpha)
        self.group = group
        self.batch_events = int(batch_events)
        self._ema_lock = threading.Lock()
        self._ema: dict[int, np.ndarray] = {}   # guarded-by: _ema_lock

    def profile(self, user: int) -> Optional[np.ndarray]:
        with self._ema_lock:
            vec = self._ema.get(int(user))
            return None if vec is None else vec.copy()

    def all_profiles(self) -> dict[int, np.ndarray]:
        """Consistent copy of every user's EMA vector (the rolling batch
        layer rebuilds the full ``user_profile`` table from this)."""
        with self._ema_lock:
            return {u: v.copy() for u, v in self._ema.items()}

    def tick(self) -> None:
        events = self._poll(self.log, self.topic, self.group, self.stats,
                            self.batch_events)
        if not events:
            return
        touched: set[int] = set()
        with self._ema_lock:
            for ev in events:
                vec = self._ema.get(ev.key)
                if vec is None:
                    vec = self._ema[ev.key] = np.zeros(self.dim, np.float32)
                x = np.zeros(self.dim, np.float32)
                x[0] = 1.0                                   # activity
                if ev.kind == "click":
                    x[1] = 1.0                               # engagement
                item = (ev.payload or {}).get("item", 0)
                x[2 + item % (self.dim - 2)] = 1.0           # interest bucket
                vec *= 1.0 - self.alpha
                vec += self.alpha * x
                touched.add(ev.key)
            users = sorted(touched)
            flushed = np.stack([self._ema[u] for u in users])
        keys = np.asarray(users, dtype=np.uint64) + np.uint64(1)
        rows = np.ascontiguousarray(flushed).view(np.uint8)
        self.publisher.publish({self.table: (keys, rows)}, events=events)
        self.stats.inc("profile_flushes")
        self.log.commit(self.topic, self.group, events)
        self.stats.inc("events_consumed", len(events))


class TrendingAggregator(StreamStage):
    """Decayed popularity counts -> top-k snapshot topic + fallback row.

    Cold-start users (no profile yet) are served from the single
    ``trending`` table row: ``top_k`` item ids packed as uint64 bytes
    under key 1, republished every tick that saw traffic.  The same
    top-k is appended to ``out_topic`` so any consumer can replay how
    the trend evolved.
    """

    def __init__(self, log: EventLog, topic: str,
                 publisher: VersionedPublisher, stats: StreamStats, *,
                 out_topic: str = "trending", table: str = "trending",
                 top_k: int = 8, decay: float = 0.95,
                 click_weight: float = 3.0, group: str = "trending",
                 batch_events: int = 512, period_s: float = 0.02):
        super().__init__("stream-trending", period_s)
        self.log = log
        self.topic = topic
        self.publisher = publisher
        self.stats = stats
        self.out_topic = out_topic
        self.table = table
        self.top_k = int(top_k)
        self.decay = float(decay)
        self.click_weight = float(click_weight)
        self.group = group
        self.batch_events = int(batch_events)
        self._score: dict[int, float] = {}

    def top(self) -> list[int]:
        ranked = sorted(self._score.items(), key=lambda kv: (-kv[1], kv[0]))
        return [item for item, _ in ranked[:self.top_k]]

    @staticmethod
    def decode_row(row: np.ndarray) -> list[int]:
        """Inverse of the fallback-row packing (uint8 row -> item ids)."""
        return [int(x) for x in
                np.ascontiguousarray(row, dtype=np.uint8).view(np.uint64)]

    def tick(self) -> None:
        events = self._poll(self.log, self.topic, self.group, self.stats,
                            self.batch_events)
        if not events:
            return
        for item in self._score:
            self._score[item] *= self.decay
        for ev in events:
            item = (ev.payload or {}).get("item")
            if item is None:
                continue
            w = self.click_weight if ev.kind == "click" else 1.0
            self._score[item] = self._score.get(item, 0.0) + w
        top = self.top()
        padded = (top + [0] * self.top_k)[:self.top_k]
        row = np.asarray(padded, dtype=np.uint64).view(np.uint8)
        version = self.publisher.publish(
            {self.table: (np.asarray([1], dtype=np.uint64),
                          row.reshape(1, -1))},
            events=events)
        self.log.append(self.out_topic, 0, "topk",
                        {"items": top, "version": version})
        self.stats.inc("trending_refreshes")
        self.log.commit(self.topic, self.group, events)
        self.stats.inc("events_consumed", len(events))
