"""Open-loop replay of a traffic schedule against a ``QueryServer``.

Closed loops lie about overload: when the server slows down, a
fire-wait-fire client slows its own offered rate and the measured p99
flatters the system.  ``OpenLoopDriver`` fires each
:class:`~repro_torch.traffic.loadgen.RequestEvent` at its scheduled offer
time regardless of how the server is doing — sheds and deadline misses land
as recorded outcomes, not reduced load — which is what makes the
flash-crowd numbers honest.

The driver owns a :class:`TrafficStats` silo (offered / completed / shed
/ failed, per-class latency reservoirs, SLO attainment, dispatcher lag)
exposed through the obs registry by ``obs.bridge.bridge_traffic_stats``,
keeps every per-request :class:`Sample` for burst-window percentile
analysis, and renders a machine-readable SLO report per run
(:func:`slo_report`).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.api.types import QoSClass, QueryRequest
from repro_torch.serve.scheduler import ShedError
from repro_torch.traffic.loadgen import (RequestEvent, TrafficPattern,
                                         burst_windows, generate_schedule)

__all__ = [
    "ClassTraffic", "OpenLoopDriver", "Sample", "TrafficSnapshot",
    "TrafficStats", "burst_p99_ms", "slo_report",
]

_RESERVOIR = 4096


def _percentile_ms(samples_s: Sequence[float], q: float) -> float:
    if not samples_s:
        return float("nan")
    return float(np.percentile(np.asarray(samples_s), q) * 1e3)


# ---------------------------------------------------------------------------
# stats silo
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClassTraffic:
    """One QoS class's slice of a :class:`TrafficSnapshot`."""

    offered: int = 0
    completed: int = 0
    shed: int = 0
    failed: int = 0
    slo_hits: int = 0
    slo_misses: int = 0
    attainment: float = float("nan")
    p50_ms: float = float("nan")
    p99_ms: float = float("nan")


@dataclasses.dataclass
class TrafficSnapshot:
    """Point-in-time totals for one load-generator run.

    ``attainment`` counts sheds and failures as SLO misses (the user saw
    nothing, which is worse than seeing it late); budget-less requests
    (PREFETCH by default) hit their SLO by completing at all.
    ``dispatch_lag_ms`` is the worst lateness of any fire relative to its
    scheduled offer time — the open-loop fidelity check."""

    offered: int = 0
    completed: int = 0
    shed: int = 0
    failed: int = 0
    slo_hits: int = 0
    slo_misses: int = 0
    attainment: float = float("nan")
    offered_rps: float = 0.0
    dispatch_lag_ms: float = 0.0
    p50_ms: float = float("nan")
    p99_ms: float = float("nan")
    per_class: dict = dataclasses.field(default_factory=dict)


class TrafficStats:
    """Thread-safe accumulator shared by the dispatcher and reapers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None
        self._dispatch_lag_s = 0.0
        self._counts = {q: ClassTraffic() for q in QoSClass}
        self._lat: dict[QoSClass, list[float]] = {q: [] for q in QoSClass}

    # -- recording ------------------------------------------------------
    def on_offer(self, qos: QoSClass, lag_s: float, now: float) -> None:
        with self._lock:
            if self._t_start is None:
                self._t_start = now
            self._t_last = now
            c = self._counts[qos]
            c.offered += 1
            if lag_s > self._dispatch_lag_s:
                self._dispatch_lag_s = lag_s

    def on_outcome(self, qos: QoSClass, outcome: str,
                   latency_s: float, slo_met: bool) -> None:
        with self._lock:
            c = self._counts[qos]
            if outcome == "completed":
                c.completed += 1
                lat = self._lat[qos]
                if len(lat) < _RESERVOIR:
                    lat.append(latency_s)
            elif outcome == "shed":
                c.shed += 1
            else:
                c.failed += 1
            if slo_met:
                c.slo_hits += 1
            else:
                c.slo_misses += 1

    # -- reading --------------------------------------------------------
    def snapshot(self) -> TrafficSnapshot:
        with self._lock:
            snap = TrafficSnapshot()
            all_lat: list[float] = []
            for q in QoSClass:
                c = self._counts[q]
                lat = self._lat[q]
                cls = ClassTraffic(
                    offered=c.offered, completed=c.completed, shed=c.shed,
                    failed=c.failed, slo_hits=c.slo_hits,
                    slo_misses=c.slo_misses,
                    attainment=(c.slo_hits / c.offered
                                if c.offered else float("nan")),
                    p50_ms=_percentile_ms(lat, 50.0),
                    p99_ms=_percentile_ms(lat, 99.0))
                snap.per_class[q.name] = cls
                snap.offered += c.offered
                snap.completed += c.completed
                snap.shed += c.shed
                snap.failed += c.failed
                snap.slo_hits += c.slo_hits
                snap.slo_misses += c.slo_misses
                all_lat.extend(lat)
            snap.attainment = (snap.slo_hits / snap.offered
                               if snap.offered else float("nan"))
            wall = ((self._t_last - self._t_start)
                    if self._t_start is not None and self._t_last is not None
                    else 0.0)
            snap.offered_rps = snap.offered / wall if wall > 0 else 0.0
            snap.dispatch_lag_ms = self._dispatch_lag_s * 1e3
            snap.p50_ms = _percentile_ms(all_lat, 50.0)
            snap.p99_ms = _percentile_ms(all_lat, 99.0)
            return snap


# ---------------------------------------------------------------------------
# per-request record
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sample:
    """One request's fate, keyed by its *scheduled* offer time so burst
    windows can be sliced out of the run afterwards."""

    t_s: float                 # scheduled offer time (pattern clock)
    qos: QoSClass
    outcome: str               # "completed" | "shed" | "failed"
    latency_s: float           # NaN unless completed
    budget_s: Optional[float]

    @property
    def slo_met(self) -> bool:
        if self.outcome != "completed":
            return False
        return self.budget_s is None or self.latency_s <= self.budget_s


def burst_p99_ms(samples: Sequence[Sample],
                 windows: Sequence[tuple[float, float]],
                 qos: QoSClass = QoSClass.RANKING,
                 ceiling_s: float = 1.0) -> float:
    """Goodput-aware p99 (ms) over requests *offered during* the burst
    windows: completions count at their measured latency, a shed or
    failed request counts at ``ceiling_s`` (a penalty well above any
    plausible completion) — shedding everything must not look like a
    latency win, and configs that complete late must still be
    distinguishable from each other below the ceiling."""
    lats = []
    for s in samples:
        if s.qos is not qos:
            continue
        if not any(lo <= s.t_s < hi for lo, hi in windows):
            continue
        lats.append(min(s.latency_s, ceiling_s)
                    if s.outcome == "completed" else ceiling_s)
    return _percentile_ms(lats, 99.0)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
class OpenLoopDriver:
    """Replays a schedule against a live server at wall-clock fidelity.

    One dispatcher thread walks the (time-sorted) schedule, sleeping until
    each event's offer time and submitting asynchronously; ``reapers``
    worker threads collect ticket results so a slow tail never blocks the
    dispatcher.  ``time_scale`` stretches (>1) or compresses (<1) the
    schedule clock — smoke runs replay a long pattern fast."""

    def __init__(self, server, pattern: TrafficPattern, *,
                 keys: Optional[dict[str, np.ndarray]] = None,
                 stats: Optional[TrafficStats] = None,
                 schedule: Optional[list[RequestEvent]] = None,
                 time_scale: float = 1.0,
                 reapers: int = 4,
                 result_timeout_s: float = 10.0):
        if not time_scale > 0:
            raise ValueError(f"time_scale must be > 0, got {time_scale}")
        if reapers < 1:
            raise ValueError(f"reapers must be >= 1, got {reapers}")
        self.server = server
        self.pattern = pattern
        self.keys = keys or {}
        self.stats = stats or TrafficStats()
        self.schedule = (schedule if schedule is not None
                         else generate_schedule(pattern))
        self.time_scale = time_scale
        self.reapers = reapers
        self.result_timeout_s = result_timeout_s
        self.samples: list[Sample] = []
        self._samples_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _event_tables(self, ev: RequestEvent) -> dict[str, np.ndarray]:
        """Map zipfian ranks to actual table keys — identity (rank == key)
        when no key universe was provided."""
        out = {}
        for name, ranks in ev.ranks.items():
            universe = self.keys.get(name)
            if universe is None:
                out[name] = ranks.astype(np.uint64)
            else:
                out[name] = np.asarray(universe)[ranks % len(universe)]
        return out

    def _record(self, ev: RequestEvent, outcome: str,
                latency_s: float) -> None:
        sample = Sample(t_s=ev.t_s, qos=ev.qos, outcome=outcome,
                        latency_s=latency_s, budget_s=ev.budget_s)
        with self._samples_lock:
            self.samples.append(sample)
        self.stats.on_outcome(ev.qos, outcome, latency_s, sample.slo_met)

    def _reap(self, pending: "queue.Queue") -> None:
        while True:
            item = pending.get()
            if item is None:
                return
            ev, ticket, t_submit = item
            try:
                resp = ticket.result(self.result_timeout_s)
            except ShedError:
                self._record(ev, "shed", float("nan"))
            except Exception:
                self._record(ev, "failed", float("nan"))
            else:
                # the server's own submit->scatter measurement: reapers
                # drain a FIFO of tickets that settle out of order, so
                # wall clock here would charge one slow ticket's wait to
                # every fast ticket queued behind it
                lat = getattr(resp, "latency_s", None)
                self._record(ev, "completed",
                             lat if lat is not None
                             else time.monotonic() - t_submit)

    def run(self) -> TrafficSnapshot:
        """Replay the full schedule; returns the final snapshot (the
        per-request :attr:`samples` stay on the driver)."""
        pending: "queue.Queue" = queue.Queue()
        workers = [threading.Thread(target=self._reap, args=(pending,),
                                    name=f"traffic-reaper-{i}", daemon=True)
                   for i in range(self.reapers)]
        for w in workers:
            w.start()
        t0 = time.monotonic()
        try:
            for ev in self.schedule:
                due = t0 + ev.t_s * self.time_scale
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                now = time.monotonic()
                self.stats.on_offer(ev.qos, max(0.0, now - due), now)
                request = QueryRequest(tables=self._event_tables(ev),
                                       qos=ev.qos, budget_s=ev.budget_s)
                try:
                    ticket = self.server.submit(request)
                except ShedError:
                    self._record(ev, "shed", float("nan"))
                except Exception:
                    self._record(ev, "failed", float("nan"))
                else:
                    pending.put((ev, ticket, now))
        finally:
            for _ in workers:
                pending.put(None)
            for w in workers:
                w.join()
        return self.stats.snapshot()


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def slo_report(pattern: TrafficPattern, snapshot: TrafficSnapshot,
               samples: Sequence[Sample] = (), *,
               controller: Optional[dict] = None) -> dict:
    """The machine-readable SLO report a run emits: offered load, totals,
    per-class attainment/latency, burst-window goodput-p99 per class, and
    (when adaptive) the controller's decision record."""
    windows = burst_windows(pattern)
    report = {
        "pattern": {
            "duration_s": pattern.duration_s,
            "base_session_rate": pattern.base_session_rate,
            "seed": pattern.seed,
            "vocab": pattern.vocab,
            "zipf_skew": pattern.zipf_skew,
            "bursts": [[b.start_s, b.duration_s, b.multiplier]
                       for b in pattern.bursts],
        },
        "offered": snapshot.offered,
        "completed": snapshot.completed,
        "shed": snapshot.shed,
        "failed": snapshot.failed,
        "offered_rps": round(snapshot.offered_rps, 2),
        "dispatch_lag_ms": round(snapshot.dispatch_lag_ms, 3),
        "attainment": (round(snapshot.attainment, 4)
                       if snapshot.offered else None),
        "p50_ms": round(snapshot.p50_ms, 3),
        "p99_ms": round(snapshot.p99_ms, 3),
        "per_class": {},
        "burst": {},
    }
    for name, cls in snapshot.per_class.items():
        report["per_class"][name] = {
            "offered": cls.offered, "completed": cls.completed,
            "shed": cls.shed, "failed": cls.failed,
            "attainment": (round(cls.attainment, 4)
                           if cls.offered else None),
            "p50_ms": round(cls.p50_ms, 3),
            "p99_ms": round(cls.p99_ms, 3),
        }
    if windows and samples:
        for q in QoSClass:
            report["burst"][q.name] = {
                "goodput_p99_ms": round(
                    burst_p99_ms(samples, windows, qos=q), 3),
            }
    if controller is not None:
        report["controller"] = controller
    return report
