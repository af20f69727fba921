"""QoS-laned, deadline-aware micro-batching scheduler for the QueryServer.

Many concurrent clients each carry a small per-request key set, a latency
budget, and — since API v2 — a **QoS class** (``RANKING > RETRIEVAL >
PREFETCH``).  The scheduler turns the concurrent stream into fused
micro-batches while keeping the classes' contracts distinct:

  - **One admission lane per class.**  Lanes are served by smooth weighted
    round-robin (default weights 4/2/1), so RANKING drains fastest under
    load but PREFETCH never starves outright.
  - **Class-aware shedding.**  The admission bound
    (``BatchPolicy.max_queue_requests``) spans all lanes; when it is hit,
    a higher-class arrival evicts the newest request from the lowest
    non-empty lane below it (PREFETCH shed first) instead of being turned
    away — only a request with nothing below it sheds itself.  Budget
    checks against the service-time EWMA shed per request, as before.
  - **Per-class close rules.**  Each lane forms batches under its own
    ``BatchPolicy`` override (key/request budgets, ``max_wait_s``); a
    forming batch's wait is bounded by the earliest deadline queued in ANY
    lane, so a PREFETCH batch never holds a deadline-carrying RANKING
    arrival past its slack.
  - **Version grouping** is per lane and unchanged: only requests resolved
    to the same ``(version, strict)`` pin coalesce, so every micro-batch
    pins exactly one engine build for its lifetime — no batch mixes
    versions, in any lane, even while ``publish``/``publish_delta`` run
    concurrently.

``ServerStats`` reports totals plus per-class p50/p99/shed so the QoS
contract is observable, not aspirational.

A copy of the JAX package's ``serve/scheduler.py``: host code (numpy and
the standard library), nothing of it runs on the card.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.api.types import Consistency, QoSClass
from repro_torch.core.query_types import QueryResult, TableResult


# ---------------------------------------------------------------------------
# typed shed / admission errors
# ---------------------------------------------------------------------------
class ShedError(RuntimeError):
    """Base class: the server refused or dropped the request by policy."""


class QueueFullError(ShedError):
    """Admission at capacity — shed outright, or evicted from the queue by
    a higher-QoS arrival (backpressure)."""


class DeadlineError(ShedError):
    """The latency budget cannot be met (at admission) or has already
    expired (in queue) — serving it would only burn capacity on a result
    the client will discard."""


class ServerClosedError(ShedError):
    """Submitted to a server that is shutting down."""


DEFAULT_LANE_WEIGHTS = {QoSClass.RANKING: 4.0,
                        QoSClass.RETRIEVAL: 2.0,
                        QoSClass.PREFETCH: 1.0}


# ---------------------------------------------------------------------------
# policy + stats
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    max_batch_keys: int = 8192        # fused key budget per micro-batch
    max_batch_requests: int = 64
    max_queue_requests: int = 256     # admission bound, across all lanes
    max_wait_s: float = 2e-3          # close rule for deadline-less traffic
    service_time_init_s: float = 3e-3  # EWMA seed for the slack computation
    service_time_alpha: float = 0.2   # EWMA weight when service gets SLOWER
    service_time_alpha_down: float = 0.5  # weight when it gets faster — a
    # transient stall (a first kernel build, publish burst) must not keep
    # admission shedding long after service recovers
    latency_reservoir: int = 200_000  # completed-request latencies kept

    def __post_init__(self):
        # satellite: misconfiguration is a construction-time ValueError,
        # never a serve-time hang/shed storm
        for field, least in (("max_batch_keys", 1),
                             ("max_batch_requests", 1),
                             ("max_queue_requests", 1),
                             ("latency_reservoir", 1)):
            v = getattr(self, field)
            if not isinstance(v, int) or v < least:
                raise ValueError(f"{field} must be an int >= {least}, "
                                 f"got {v!r}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, "
                             f"got {self.max_wait_s}")
        if not self.service_time_init_s > 0:
            raise ValueError(f"service_time_init_s must be > 0, "
                             f"got {self.service_time_init_s}")
        for field in ("service_time_alpha", "service_time_alpha_down"):
            a = getattr(self, field)
            if not 0 < a <= 1:
                raise ValueError(f"{field} must be in (0, 1], got {a}")


def _pctiles(latencies_s: np.ndarray) -> tuple[float, float]:
    """(p50_ms, p99_ms); nan/nan on an empty window — callers format, they
    never branch (satellite: 0- and 1-sample snapshots must not raise)."""
    if not len(latencies_s):
        return float("nan"), float("nan")
    return (float(np.percentile(latencies_s, 50) * 1e3),
            float(np.percentile(latencies_s, 99) * 1e3))


@dataclasses.dataclass
class ClassSnapshot:
    """Per-QoS-class slice of a StatsSnapshot."""
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0
    # cumulative completed-request latency: unlike the reservoir
    # percentiles this is delta-able, so monitors (and the traffic
    # controller) can derive a true *interval* mean latency
    latency_sum_ms: float = 0.0
    p50_ms: float = float("nan")
    p99_ms: float = float("nan")
    shed_rate: float = 0.0

    @property
    def shed(self) -> int:
        return self.shed_queue_full + self.shed_deadline


@dataclasses.dataclass
class StatsSnapshot:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0
    batches: int = 0
    launches: int = 0
    keys_requested: int = 0
    keys_deviceside: int = 0
    # cumulative begin->finish wall time across micro-batches; with
    # ``batches`` it yields a delta-able *interval* mean service time
    # per batch (reservoir percentiles can't be deltaed)
    service_sum_ms: float = 0.0
    deadline_hits: int = 0
    deadline_misses: int = 0
    p50_ms: float = float("nan")
    p99_ms: float = float("nan")
    mean_occupancy: float = 0.0       # requests per micro-batch
    coalesce_rate: float = 0.0        # keys eliminated before the device
    shed_rate: float = 0.0
    per_class: dict[str, ClassSnapshot] = dataclasses.field(
        default_factory=dict)

    def summary(self) -> str:
        line = (f"{self.completed}/{self.submitted} served "
                f"p50={self.p50_ms:.2f}ms p99={self.p99_ms:.2f}ms "
                f"occupancy={self.mean_occupancy:.1f} req/batch "
                f"coalesce={self.coalesce_rate:.0%} "
                f"shed={self.shed_rate:.1%} "
                f"({self.shed_queue_full} queue-full, "
                f"{self.shed_deadline} deadline)")
        for name, c in self.per_class.items():
            if c.submitted:
                line += (f" | {name} {c.completed}/{c.submitted} "
                         f"p99={c.p99_ms:.2f}ms shed={c.shed_rate:.1%}")
        return line


class _LatencyRing:
    """Fixed-size ring of the most recent latencies: percentiles track
    current behavior, not the first N requests."""

    def __init__(self, capacity: int):
        self._cap = capacity
        self._buf: list[float] = []
        self._next = 0

    def add(self, latency_s: float) -> None:
        if len(self._buf) < self._cap:
            self._buf.append(latency_s)
        else:
            self._buf[self._next] = latency_s
            self._next = (self._next + 1) % self._cap

    def array(self) -> np.ndarray:
        return np.asarray(self._buf, dtype=np.float64)


class ServerStats:
    """Thread-safe counters + latency reservoirs behind ``snapshot()`` —
    totals plus one ``ClassSnapshot`` per QoS class."""

    def __init__(self, policy: BatchPolicy):
        self._lock = threading.Lock()
        self._policy = policy
        self._c = StatsSnapshot()     # guarded-by: _lock (strict)
        self._lat = _LatencyRing(
            policy.latency_reservoir)  # guarded-by: _lock (strict)
        # guarded-by: _lock (strict)
        self._cls = {q: ClassSnapshot() for q in QoSClass}
        # guarded-by: _lock (strict)
        self._cls_lat = {q: _LatencyRing(min(policy.latency_reservoir,
                                             50_000)) for q in QoSClass}

    def on_submit(self, qos: QoSClass = QoSClass.RANKING) -> None:
        with self._lock:
            self._c.submitted += 1
            self._cls[qos].submitted += 1

    def on_shed(self, kind: str, qos: QoSClass = QoSClass.RANKING) -> None:
        with self._lock:
            if kind == "queue_full":
                self._c.shed_queue_full += 1
                self._cls[qos].shed_queue_full += 1
            else:
                self._c.shed_deadline += 1
                self._cls[qos].shed_deadline += 1

    def on_batch(self, n_requests: int, keys_requested: int,
                 keys_deviceside: int, launches: int,
                 service_s: float = 0.0) -> None:
        with self._lock:
            self._c.batches += 1
            self._c.launches += launches
            self._c.keys_requested += keys_requested
            self._c.keys_deviceside += keys_deviceside
            self._c.service_sum_ms += service_s * 1e3

    def on_complete(self, latency_s: float, deadline_met: Optional[bool],
                    qos: QoSClass = QoSClass.RANKING) -> None:
        with self._lock:
            self._c.completed += 1
            self._cls[qos].completed += 1
            self._cls[qos].latency_sum_ms += latency_s * 1e3
            if deadline_met is not None:
                if deadline_met:
                    self._c.deadline_hits += 1
                else:
                    self._c.deadline_misses += 1
            self._lat.add(latency_s)
            self._cls_lat[qos].add(latency_s)

    def on_failure(self, n: int = 1,
                   qos: Optional[QoSClass] = None) -> None:
        with self._lock:
            self._c.failed += n
            if qos is not None:
                self._cls[qos].failed += n

    def snapshot(self) -> StatsSnapshot:
        # copy under the lock, crunch percentiles outside it: a monitoring
        # thread's numpy work must not stall every client's on_submit/
        # on_complete (and thereby inflate the very p99 being measured)
        with self._lock:
            s = dataclasses.replace(self._c)
            lats = self._lat.array()
            per_class = {}
            cls_lats = {}
            for q in QoSClass:
                per_class[q.name] = dataclasses.replace(self._cls[q])
                cls_lats[q.name] = self._cls_lat[q].array()
        for name, c in per_class.items():
            c.p50_ms, c.p99_ms = _pctiles(cls_lats[name])
            if c.submitted:
                c.shed_rate = c.shed / c.submitted
        s.p50_ms, s.p99_ms = _pctiles(lats)
        if s.batches:
            s.mean_occupancy = s.completed / s.batches
        if s.keys_requested:
            s.coalesce_rate = 1.0 - s.keys_deviceside / s.keys_requested
        shed = s.shed_queue_full + s.shed_deadline
        if s.submitted:
            s.shed_rate = shed / s.submitted
        s.per_class = per_class
        return s


# ---------------------------------------------------------------------------
# tickets + pending requests
# ---------------------------------------------------------------------------
class Ticket:
    """Client-side handle: blocks on ``result()`` until the micro-batch the
    request rode in finishes (or the request is shed in queue)."""

    def __init__(self, deadline: Optional[float]):
        self._event = threading.Event()
        # settlement is first-write-wins: close() failing an in-flight
        # request can race the finish worker completing it, and whichever
        # settles first must stick — the loser's write would otherwise
        # mutate a result the client may already be reading
        self._settle_lock = threading.Lock()
        self._result: Optional[QueryResult] = None   # guarded-by: _settle_lock
        self._error: Optional[BaseException] = None  # guarded-by: _settle_lock
        self.deadline = deadline
        self.batch_id: Optional[int] = None     # guarded-by: _settle_lock
        self.latency_s: Optional[float] = None  # guarded-by: _settle_lock

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> QueryResult:
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    # server-side faces -------------------------------------------------
    def _complete(self, result: QueryResult, batch_id: int,
                  latency_s: float) -> bool:
        """Settle with a result; returns False if already settled."""
        with self._settle_lock:
            if self._event.is_set():
                return False
            self._result = result
            self.batch_id = batch_id
            self.latency_s = latency_s
            self._event.set()
            return True

    def _fail(self, error: BaseException) -> bool:
        """Settle with an error; returns False if already settled."""
        with self._settle_lock:
            if self._event.is_set():
                return False
            self._error = error
            self._event.set()
            return True


@dataclasses.dataclass
class _Pending:
    tables: dict[str, np.ndarray]
    n_keys: int
    t_submit: float
    deadline: Optional[float]         # monotonic; None = no budget
    version: Optional[int]            # resolved consistency pin
    strict: bool
    qos: QoSClass
    consistency: Consistency          # checked against the served build
    ticket: Ticket
    # tracing context (obs/trace.py) for a sampled request: at least
    # {"trace_id": ...}; None on the untraced hot path — the server's
    # span emission keys off this being non-None
    trace: Optional[dict] = None

    @property
    def group(self) -> tuple:
        """Requests coalesce only within one (version, strict) group —
        the single-version-per-micro-batch invariant."""
        return (self.version, self.strict)


# ---------------------------------------------------------------------------
# coalesce / scatter-back
# ---------------------------------------------------------------------------
def coalesce(batch: list[_Pending]) -> tuple[dict[str, np.ndarray],
                                             list[dict[str, tuple[int, int]]]]:
    """Fuse per-request key sets into one engine request; returns the fused
    ``{table: keys}`` dict plus, per request, its ``{table: (lo, hi)}``
    spans for scatter-back.  The engine dedups the fused arrays, so overlap
    ACROSS requests is eliminated exactly like overlap within one."""
    parts: dict[str, list[np.ndarray]] = {}
    lens: dict[str, int] = {}
    spans: list[dict[str, tuple[int, int]]] = []
    for req in batch:
        mine: dict[str, tuple[int, int]] = {}
        for name, keys in req.tables.items():
            lo = lens.get(name, 0)
            parts.setdefault(name, []).append(keys)
            lens[name] = lo + len(keys)
            mine[name] = (lo, lens[name])
        spans.append(mine)
    fused = {name: np.concatenate(ps) for name, ps in parts.items()}
    return fused, spans


def scatter(result: QueryResult,
            span: dict[str, tuple[int, int]]) -> QueryResult:
    """Slice one request's rows back out of the fused result (same version
    tag: every request in the batch was answered from the one pinned
    build)."""
    tables: dict[str, TableResult] = {}
    for name, (lo, hi) in span.items():
        tr = result.tables[name]
        tables[name] = TableResult(
            found=tr.found[lo:hi],
            payloads=None if tr.payloads is None else tr.payloads[lo:hi],
            values=None if tr.values is None else tr.values[lo:hi])
    return QueryResult(version=result.version, tables=tables)


# ---------------------------------------------------------------------------
# the micro-batcher
# ---------------------------------------------------------------------------
# only the close rules are lane-scoped; the admission bound, EWMA params,
# and reservoir stay global
LANE_POLICY_FIELDS = ("max_batch_keys", "max_batch_requests", "max_wait_s")


def _check_lane_policy(q: QoSClass, pol, base: BatchPolicy) -> None:
    """A lane policy may differ from the base only on the close rules.
    A value deliberately set on a non-lane field (differing from both the
    base policy and the dataclass default) would be silently ignored —
    reject it instead.  Shared by construction-time ``class_policies`` and
    runtime ``set_lane_policy`` so a retune can't smuggle in a global."""
    if not isinstance(pol, BatchPolicy):
        raise ValueError(f"class policy for {q.name} must be a "
                         f"BatchPolicy, got {type(pol).__name__}")
    defaults = BatchPolicy()
    for f in dataclasses.fields(BatchPolicy):
        if f.name in LANE_POLICY_FIELDS:
            continue
        v = getattr(pol, f.name)
        if v != getattr(defaults, f.name) \
                and v != getattr(base, f.name):
            raise ValueError(
                f"class policy for {q.name} sets {f.name}={v}, but "
                f"only {LANE_POLICY_FIELDS} are per-lane; the rest are "
                f"global (set them on the server's base policy)")


class _Lane:
    """One QoS class's admission queue + service credit (smooth WRR)."""

    def __init__(self, qos: QoSClass, policy: BatchPolicy, weight: float):
        self.qos = qos
        self.policy = policy          # per-class close-rule overrides
        self.weight = weight
        self.queue: deque[_Pending] = deque()
        self.credit = 0.0


class MicroBatcher:
    """Per-class bounded admission + deadline-aware batch formation.

    ``admit`` is called from client threads; ``next_batch`` from the single
    scheduler thread.  Expired requests are shed (their tickets fail with
    ``DeadlineError``) during formation, never silently dropped."""

    def __init__(self, policy: BatchPolicy, stats: ServerStats,
                 class_policies: Optional[dict] = None,
                 lane_weights: Optional[dict] = None):
        self.policy = policy
        self.stats = stats
        weights = dict(DEFAULT_LANE_WEIGHTS)
        for name, w in (lane_weights or {}).items():
            q = QoSClass.parse(name)          # unknown names -> ValueError
            if not w > 0:
                raise ValueError(f"lane weight for {q.name} must be > 0, "
                                 f"got {w}")
            weights[q] = float(w)
        overrides = {}
        for name, pol in (class_policies or {}).items():
            q = QoSClass.parse(name)
            _check_lane_policy(q, pol, policy)
            overrides[q] = pol
        # priority order: RANKING first (smaller enum value = higher class)
        self._lanes = {q: _Lane(q, overrides.get(q, policy), weights[q])
                       for q in sorted(QoSClass)}
        self._cond = threading.Condition()
        self._closed = False            # guarded-by: _cond (strict)
        # non-strict: the service_time_s property is a benign racy
        # float read for telemetry; every admission decision reads it
        # under _cond
        self._service_time_s = policy.service_time_init_s  # guarded-by: _cond
        self._last_observe = time.monotonic()   # guarded-by: _cond

    # ------------------------------------------------------------------
    @property
    def service_time_s(self) -> float:
        return self._service_time_s

    def observe_service_time(self, seconds: float) -> None:
        with self._cond:        # pool workers report concurrently; a lost
            # fast-side update would keep admission shedding after a stall
            a = (self.policy.service_time_alpha_down
                 if seconds < self._service_time_s
                 else self.policy.service_time_alpha)
            self._service_time_s = ((1 - a) * self._service_time_s
                                    + a * seconds)
            self._last_observe = time.monotonic()

    def _estimate(self, now: float) -> float:   # lock-held: _cond
        """Admission-time service estimate.  The EWMA only refreshes when
        batches complete, so with EVERY request being shed there would be
        no observations and a stale stall reading would wedge admission
        into permanent shedding; instead the estimate decays toward the
        policy seed (halving every 250 ms of observation silence)."""
        idle = now - self._last_observe
        if idle <= 0.25:
            return self._service_time_s
        # floor at min(seed, ewma): decay pulls a stalled-high estimate
        # back DOWN toward the seed but must never raise an estimate that
        # is already below it (a fast engine's tight-budget traffic would
        # otherwise shed forever after one idle gap)
        floor = min(self.policy.service_time_init_s, self._service_time_s)
        return max(floor, self._service_time_s * 0.5 ** (idle / 0.25 - 1.0))

    def depth(self) -> int:
        with self._cond:
            return sum(len(l.queue) for l in self._lanes.values())

    def lane_depths(self) -> dict[str, int]:
        with self._cond:
            return {q.name: len(l.queue) for q, l in self._lanes.items()}

    # -- runtime retuning (a traffic controller's knobs) ---------------
    def lane_policy(self, qos) -> BatchPolicy:
        with self._cond:
            return self._lanes[QoSClass.parse(qos)].policy

    def lane_policies(self) -> dict[str, BatchPolicy]:
        with self._cond:
            return {q.name: l.policy for q, l in self._lanes.items()}

    def set_lane_policy(self, qos, policy: BatchPolicy) -> None:
        """Swap one lane's close rules at runtime.  Same validation as
        construction-time ``class_policies`` (lane fields only); wakes the
        forming wait so a shrunk ``max_wait_s`` takes effect on the batch
        currently forming, not one batch late."""
        q = QoSClass.parse(qos)
        _check_lane_policy(q, policy, self.policy)
        with self._cond:
            self._lanes[q].policy = policy
            self._cond.notify_all()

    # ------------------------------------------------------------------
    def _evict_below(self, qos: QoSClass) -> bool:  # lock-held: _cond
        # Class-aware backpressure: free one slot by
        # shedding the newest request from the LOWEST non-empty lane
        # strictly below ``qos`` (PREFETCH before RETRIEVAL before never-
        # RANKING); newest-first because it has waited least — the oldest
        # is closest to being served, evicting it wastes the most queueing
        for lane in reversed(self._lanes.values()):
            if lane.qos <= qos:
                break
            if lane.queue:
                victim = lane.queue.pop()
                self.stats.on_shed("queue_full", victim.qos)
                victim.ticket._fail(QueueFullError(
                    f"evicted from the {victim.qos.name} lane by a "
                    f"{qos.name} arrival under backpressure"))
                return True
        return False

    def admit(self, req: _Pending) -> None:
        now = time.monotonic()
        with self._cond:
            if self._closed:
                raise ServerClosedError("server is shutting down")
            # the arrival's own admissibility first: a request that can
            # only miss its budget must never evict an innocent victim for
            # a slot it will not use
            est = self._estimate(now)
            if req.deadline is not None and req.deadline - now < est:
                self.stats.on_shed("deadline", req.qos)
                raise DeadlineError(
                    f"budget {max(req.deadline - now, 0) * 1e3:.2f}ms < "
                    f"estimated service time {est * 1e3:.2f}ms")
            depth = sum(len(l.queue) for l in self._lanes.values())
            if depth >= self.policy.max_queue_requests \
                    and not self._evict_below(req.qos):
                self.stats.on_shed("queue_full", req.qos)
                raise QueueFullError(
                    f"admission queue full "
                    f"({self.policy.max_queue_requests} requests) and no "
                    f"lane below {req.qos.name} to shed from")
            self._lanes[req.qos].queue.append(req)
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> list[_Pending]:
        """Pop every still-queued request (after close, when no scheduler
        thread exists to serve them) so the caller can fail their tickets
        instead of leaving result() waiters hanging."""
        with self._cond:
            out = []
            for lane in self._lanes.values():
                out.extend(lane.queue)
                lane.queue.clear()
            return out

    # ------------------------------------------------------------------
    def _shed_expired(self, now: float) -> None:   # lock-held: _cond
        for lane in self._lanes.values():
            if not lane.queue:
                continue
            live: deque[_Pending] = deque()
            for req in lane.queue:
                if req.deadline is not None and now > req.deadline:
                    self.stats.on_shed("deadline", req.qos)
                    req.ticket._fail(DeadlineError(
                        "deadline expired while queued"))
                else:
                    live.append(req)
            lane.queue = live

    def _nonempty(self) -> list[_Lane]:
        return [l for l in self._lanes.values() if l.queue]

    def _pick_lane(self) -> _Lane:              # lock-held: _cond
        # smooth weighted round-robin over the
        # non-empty lanes: every lane gains its weight, the richest serves
        # and pays back the round's total — RANKING gets ~4/7 of contended
        # service slots by default, yet PREFETCH still cycles in (weighted
        # service without starvation).  Ties break toward the higher class
        lanes = self._nonempty()
        if len(lanes) == 1:
            return lanes[0]
        total = sum(l.weight for l in lanes)
        for lane in lanes:
            lane.credit += lane.weight
        best = max(lanes, key=lambda l: (l.credit, -l.qos))
        best.credit -= total
        return best

    def _collect(self, lane: _Lane
                 ) -> tuple[list[_Pending], bool]:  # lock-held: _cond
        # head-of-line request picks the group.
        # ``saturated`` reports that a matching request exists but could
        # not fit — the batch is as full as it can get, so the caller must
        # close it now rather than wait out max_wait_s for riders that can
        # never join
        pol = lane.policy
        head = lane.queue[0]
        batch, n_keys, saturated = [], 0, False
        for req in lane.queue:
            if req.group != head.group:
                continue
            if batch and (n_keys + req.n_keys > pol.max_batch_keys
                          or len(batch) >= pol.max_batch_requests):
                saturated = True
                break
            batch.append(req)
            n_keys += req.n_keys
        return batch, saturated

    def next_batch(self) -> Optional[list[_Pending]]:
        """Blocks until a micro-batch closes; ``None`` once the batcher is
        closed and drained.  Every request in a returned batch shares one
        QoS class and one (version, strict) group."""
        with self._cond:
            while True:
                # wait for at least one live request in any lane
                while True:
                    self._shed_expired(time.monotonic())
                    if self._nonempty():
                        break
                    if self._closed:
                        return None
                    self._cond.wait(timeout=0.05)

                lane = self._pick_lane()
                pol = lane.policy
                t_open = time.monotonic()
                batch: list[_Pending] = []
                while True:
                    batch, saturated = self._collect(lane)
                    n_keys = sum(r.n_keys for r in batch)
                    if (saturated
                            or n_keys >= pol.max_batch_keys
                            or len(batch) >= pol.max_batch_requests
                            or self._closed):
                        break
                    # earliest deadline across EVERY lane, not just this
                    # batch: any queued request — including a higher-class
                    # arrival — is blocked until this batch closes, so its
                    # slack must bound the wait.  (Closing lower-class
                    # batches the moment a higher lane goes non-empty was
                    # tried and collapses occupancy under steady RANKING
                    # traffic: every PREFETCH batch shrinks to one rider
                    # and the flood of tiny launches slows ALL lanes.)
                    deadlines = [r.deadline
                                 for other in self._lanes.values()
                                 for r in other.queue
                                 if r.deadline is not None]
                    close_at = t_open + pol.max_wait_s
                    if deadlines:
                        # earliest deadline's slack, net of the service cost
                        close_at = min(close_at,
                                       min(deadlines) - self._service_time_s)
                    now = time.monotonic()
                    if now >= close_at:
                        break
                    self._cond.wait(timeout=min(close_at - now, 0.01))
                    self._shed_expired(time.monotonic())
                    if not lane.queue:
                        batch = []
                        break       # lane drained mid-wait — start over
                if not batch:
                    continue
                members = set(map(id, batch))
                lane.queue = deque(r for r in lane.queue
                                   if id(r) not in members)
                return batch
