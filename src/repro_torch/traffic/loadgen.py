"""Deterministic, seedable traffic generation — what production offers.

A closed loop of fixed shape (N threads, fire-wait-fire) is not what
production offers: key popularity is zipfian, offered load swings through
diurnal cycles and flash crowds, and requests arrive in *sessions* — a user's
retrieval is followed by ranking calls and speculative prefetches with
think-time gaps — open-loop, indifferent to whether the server keeps up.

This module turns a :class:`TrafficPattern` into that offered stream,
**offline and reproducibly**: ``generate_schedule(pattern)`` computes the
full event timeline (absolute offer times, per-request QoS class, key
ranks, latency budget) from a single seeded ``np.random.Generator`` with
no wall-clock reads, so the same seed yields the byte-identical timeline
— the property the distribution tests pin — and two runs against
different server configs are offered *exactly* the same load.

Pieces:

  - :class:`ZipfianPopularity` — rank-frequency law with configurable
    skew and an **analytic pmf** (bounded support, unlike
    ``np.random.zipf``), so empirical frequencies are testable against
    closed form;
  - :class:`DiurnalCurve` — raised-cosine rate multiplier between trough
    (1.0) and peak;
  - :class:`FlashCrowd` — a burst window multiplying the offered rate
    (the paper's update-storm / hot-event regime);
  - :class:`QoSMix` + :class:`RequestShape` — per-class request mix,
    key-set sizes, and latency budgets;
  - :class:`TrafficPattern.rate` — the composed sessions/s curve;
    session arrivals are a non-homogeneous Poisson process (thinning),
    requests within a session follow exponential think times.

``repro_torch.traffic.driver`` replays a schedule open-loop against a
``QueryServer``; ``repro_torch.traffic.controller`` closes the loop back into
``BatchPolicy``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.api.types import QoSClass

__all__ = [
    "DiurnalCurve", "FlashCrowd", "QoSMix", "RequestEvent", "RequestShape",
    "TrafficPattern", "ZipfianPopularity", "burst_windows",
    "generate_schedule", "offered_per_window",
]


# ---------------------------------------------------------------------------
# key popularity
# ---------------------------------------------------------------------------
class ZipfianPopularity:
    """Zipf rank-frequency law over a *bounded* vocabulary.

    ``p(rank r) ∝ (r + 1) ** -skew`` for ranks ``0..vocab-1`` — the
    classic content-popularity model (skew ~0.9–1.2 for item catalogs).
    Unlike ``np.random.zipf`` the support is bounded and the pmf is
    available in closed form, so tests can check empirical frequencies
    against ``pmf()`` exactly instead of against a truncated
    approximation.  ``skew=0`` degenerates to uniform."""

    def __init__(self, vocab: int, skew: float = 1.1):
        if not isinstance(vocab, int) or vocab < 1:
            raise ValueError(f"vocab must be an int >= 1, got {vocab!r}")
        if skew < 0:
            raise ValueError(f"skew must be >= 0, got {skew}")
        self.vocab = vocab
        self.skew = float(skew)
        weights = np.arange(1, vocab + 1, dtype=np.float64) ** -self.skew
        self._pmf = weights / weights.sum()
        self._cdf = np.cumsum(self._pmf)
        self._cdf[-1] = 1.0          # guard the fp tail: u=0.999.. must land

    def pmf(self) -> np.ndarray:
        """Analytic probability of each rank (rank 0 = hottest)."""
        return self._pmf.copy()

    def sample(self, rng: np.random.Generator, size) -> np.ndarray:
        """Ranks drawn by inverse-CDF — one uniform per draw, so the
        consumed rng stream length is shape-deterministic."""
        return np.searchsorted(self._cdf, rng.random(size),
                               side="right").astype(np.int64)


# ---------------------------------------------------------------------------
# load curves
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DiurnalCurve:
    """Raised-cosine daily cycle: multiplier 1.0 at the trough,
    ``peak_to_trough`` at the peak, period ``period_s``.  ``phase_frac``
    slides where t=0 sits in the cycle (0.0 = trough, 0.5 = peak)."""

    period_s: float = 86_400.0
    peak_to_trough: float = 4.0
    phase_frac: float = 0.0

    def __post_init__(self):
        if not self.period_s > 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")
        if not self.peak_to_trough >= 1.0:
            raise ValueError(f"peak_to_trough must be >= 1, "
                             f"got {self.peak_to_trough}")

    def multiplier(self, t_s):
        t = np.asarray(t_s, dtype=np.float64)
        x = 0.5 - 0.5 * np.cos(2 * np.pi * (t / self.period_s
                                            + self.phase_frac))
        return 1.0 + (self.peak_to_trough - 1.0) * x


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    """One burst window: offered rate multiplied by ``multiplier`` for
    ``[start_s, start_s + duration_s)`` — a hot event / push notification
    / retry storm."""

    start_s: float
    duration_s: float
    multiplier: float = 4.0

    def __post_init__(self):
        if self.start_s < 0 or not self.duration_s > 0:
            raise ValueError(f"burst window invalid: start={self.start_s} "
                             f"duration={self.duration_s}")
        if not self.multiplier >= 1.0:
            raise ValueError(f"burst multiplier must be >= 1, "
                             f"got {self.multiplier}")

    def active(self, t_s) -> np.ndarray:
        t = np.asarray(t_s, dtype=np.float64)
        return (t >= self.start_s) & (t < self.start_s + self.duration_s)


# ---------------------------------------------------------------------------
# request mix + shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QoSMix:
    """Relative request weights per QoS class within a session trace —
    PREFETCH-heavy by default (speculative warming outweighs user-facing
    calls in offered volume, the realistic shape)."""

    ranking: float = 1.0
    retrieval: float = 1.0
    prefetch: float = 2.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if getattr(self, f.name) < 0:
                raise ValueError(f"{f.name} weight must be >= 0")
        if not (self.ranking + self.retrieval + self.prefetch) > 0:
            raise ValueError("QoSMix needs at least one positive weight")

    def fractions(self) -> dict[QoSClass, float]:
        total = self.ranking + self.retrieval + self.prefetch
        return {QoSClass.RANKING: self.ranking / total,
                QoSClass.RETRIEVAL: self.retrieval / total,
                QoSClass.PREFETCH: self.prefetch / total}


@dataclasses.dataclass(frozen=True)
class RequestShape:
    """Per-class request template: ``{table: n_keys}`` drawn zipfian per
    request, and the latency budget (None = deadline-less)."""

    tables: tuple[tuple[str, int], ...]
    budget_s: Optional[float] = None

    def __post_init__(self):
        if not self.tables:
            raise ValueError("RequestShape needs at least one table")
        for name, n in self.tables:
            if not isinstance(name, str) or not name:
                raise ValueError(f"bad table name {name!r}")
            if not isinstance(n, int) or n < 1:
                raise ValueError(f"n_keys for {name!r} must be int >= 1")
        if self.budget_s is not None and not self.budget_s > 0:
            raise ValueError(f"budget_s must be > 0, got {self.budget_s}")


def default_shapes(table: str = "item_attr") -> dict[QoSClass, RequestShape]:
    """Single-table defaults mirroring the serving benches: RANKING is
    small + tight-budget, RETRIEVAL wider, PREFETCH widest + budget-less."""
    return {
        QoSClass.RANKING: RequestShape(((table, 96),), budget_s=0.050),
        QoSClass.RETRIEVAL: RequestShape(((table, 128),), budget_s=0.100),
        QoSClass.PREFETCH: RequestShape(((table, 192),), budget_s=None),
    }


# ---------------------------------------------------------------------------
# the pattern + schedule
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RequestEvent:
    """One offered request: ``t_s`` is the absolute offer time from run
    start (open-loop — the driver fires at this time whether or not the
    server kept up); ``ranks`` are zipfian key ranks per table, mapped to
    actual key ids by the driver."""

    t_s: float
    session: int
    qos: QoSClass
    ranks: dict[str, np.ndarray]
    budget_s: Optional[float]

    @property
    def n_keys(self) -> int:
        return sum(len(r) for r in self.ranks.values())


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    """Everything that determines the offered stream.  Frozen + seeded:
    the schedule is a pure function of this object."""

    duration_s: float = 10.0
    base_session_rate: float = 20.0      # sessions/s at the diurnal trough
    seed: int = 0
    vocab: int = 100_000
    zipf_skew: float = 1.1
    diurnal: Optional[DiurnalCurve] = None
    bursts: tuple[FlashCrowd, ...] = ()
    mix: QoSMix = dataclasses.field(default_factory=QoSMix)
    requests_per_session: tuple[int, int] = (2, 6)
    think_time_s: float = 0.040          # mean exponential think gap
    shapes: Optional[dict] = None        # {QoSClass: RequestShape}

    def __post_init__(self):
        if not self.duration_s > 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if not self.base_session_rate > 0:
            raise ValueError(f"base_session_rate must be > 0, "
                             f"got {self.base_session_rate}")
        lo, hi = self.requests_per_session
        if not (isinstance(lo, int) and isinstance(hi, int)
                and 1 <= lo <= hi):
            raise ValueError(f"requests_per_session must be ints "
                             f"1 <= lo <= hi, got {lo, hi}")
        if self.think_time_s < 0:
            raise ValueError(f"think_time_s must be >= 0, "
                             f"got {self.think_time_s}")

    # ------------------------------------------------------------------
    def resolved_shapes(self) -> dict[QoSClass, RequestShape]:
        return dict(self.shapes) if self.shapes else default_shapes()

    def rate(self, t_s):
        """Offered session rate at ``t_s`` (sessions/s): base × diurnal ×
        every active burst's multiplier."""
        t = np.asarray(t_s, dtype=np.float64)
        out = np.full(t.shape, self.base_session_rate, dtype=np.float64)
        if self.diurnal is not None:
            out = out * self.diurnal.multiplier(t)
        for burst in self.bursts:
            out = np.where(burst.active(t), out * burst.multiplier, out)
        return out if out.shape else float(out)

    def peak_rate(self) -> float:
        """Upper bound on ``rate`` over the run (thinning envelope)."""
        peak = self.base_session_rate
        if self.diurnal is not None:
            peak *= self.diurnal.peak_to_trough
        for burst in self.bursts:
            peak *= burst.multiplier        # overlapping bursts compound
        return peak


def burst_windows(pattern: TrafficPattern) -> list[tuple[float, float]]:
    """The ``[start, end)`` burst windows, clipped to the run."""
    return [(b.start_s, min(b.start_s + b.duration_s, pattern.duration_s))
            for b in pattern.bursts if b.start_s < pattern.duration_s]


def _session_arrivals(pattern: TrafficPattern,
                      rng: np.random.Generator) -> np.ndarray:
    """Non-homogeneous Poisson session starts over ``[0, duration_s)`` by
    thinning against the peak-rate envelope."""
    lam_max = pattern.peak_rate()
    out = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= pattern.duration_s:
            break
        if rng.random() * lam_max < pattern.rate(t):
            out.append(t)
    return np.asarray(out, dtype=np.float64)


def generate_schedule(pattern: TrafficPattern) -> list[RequestEvent]:
    """The full offered timeline, sorted by offer time.

    Pure function of ``pattern`` (single seeded generator, no wall clock):
    identical patterns yield byte-identical schedules.  Sessions spill
    their think-time tails past ``duration_s`` naturally — a user mid-
    session at the end of the window finishes it."""
    rng = np.random.default_rng(pattern.seed)
    zipf = ZipfianPopularity(pattern.vocab, pattern.zipf_skew)
    shapes = pattern.resolved_shapes()
    fracs = pattern.mix.fractions()
    classes = [q for q in QoSClass if fracs[q] > 0 and q in shapes]
    if not classes:
        raise ValueError("QoSMix × shapes leaves no usable QoS class")
    weights = np.asarray([fracs[q] for q in classes], dtype=np.float64)
    weights /= weights.sum()
    cdf = np.cumsum(weights)
    cdf[-1] = 1.0

    lo, hi = pattern.requests_per_session
    events: list[RequestEvent] = []
    for sid, t0 in enumerate(_session_arrivals(pattern, rng)):
        n_req = int(rng.integers(lo, hi + 1))
        t = float(t0)
        for i in range(n_req):
            qos = classes[int(np.searchsorted(cdf, rng.random(),
                                              side="right"))]
            shape = shapes[qos]
            ranks = {name: zipf.sample(rng, n)
                     for name, n in shape.tables}
            events.append(RequestEvent(t_s=t, session=sid, qos=qos,
                                       ranks=ranks,
                                       budget_s=shape.budget_s))
            if i + 1 < n_req:
                t += float(rng.exponential(pattern.think_time_s)) \
                    if pattern.think_time_s else 0.0
    events.sort(key=lambda ev: (ev.t_s, ev.session))
    return events


def offered_per_window(events: Sequence[RequestEvent],
                       window_s: float) -> np.ndarray:
    """Offered requests/s per ``window_s`` bucket — the offered-load curve
    a report or test compares against the pattern's analytic rate."""
    if not window_s > 0:
        raise ValueError(f"window_s must be > 0, got {window_s}")
    if not events:
        return np.zeros(0, dtype=np.float64)
    ts = np.asarray([ev.t_s for ev in events], dtype=np.float64)
    n_bins = int(np.floor(ts.max() / window_s)) + 1
    counts = np.bincount((ts / window_s).astype(np.int64),
                         minlength=n_bins)
    return counts / window_s
