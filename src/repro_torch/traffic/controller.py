"""Online control plane: live telemetry → ``BatchPolicy`` / tier knobs.

The scheduler already publishes everything a controller needs
(``ServerStats``: per-class p99 and shed rates; ``TierStats``: hit rate
and garbage fraction) — this module closes the loop the way Monolith
tunes serving against real-time load instead of static configs.

Per lane, :class:`AdaptiveController` applies an AIMD-flavored rule with
a hysteresis band over the lane's latency budget.  The latency signal is
the **interval mean** — ``latency_sum_ms`` / ``completed`` deltas
between ticks — because the snapshot percentiles are cumulative
reservoirs: one warmup spike would pin a cumulative p99 above the high
water forever and wedge the controller in shrink.  Deltas of monotone
counters are the only honest per-interval read ``ServerStats`` offers.

  - **pressure** (interval shed above ``shed_pressure``, or interval
    mean latency above ``lat_high_frac`` of budget) is *directional*:
    batch-query serving sits on a throughput curve with an interior
    optimum (per-launch overhead amortizes with batch size until wide
    gathers go superlinear), so the right move depends on which side
    the server is on.  The interval mean **service time per batch**
    (``service_sum_ms``/``batches`` deltas) is the side detector: when
    batches are cheap, pressure means the close rules are starving
    amortization → **grow** ``max_batch_keys``/``max_wait_s``; when a
    batch already costs more than ``svc_high_frac`` of the budget (or
    no batch finished all interval — a stalled wide collect), growing
    made them too expensive → **shrink**;
  - **slack** (interval mean below ``lat_low_frac`` of budget and zero
    shed) → grow, but only while the key cap is actually *binding*
    (interval mean batch occupancy at least ``bind_frac`` of the cap) —
    growing a cap that idle traffic never fills just parks the knobs
    somewhere untested and poisons the next overload;
  - in between → hold.  The dead band is what prevents oscillation; the
    ``[low, high]`` gap must out-span one grow/shrink step or the
    controller would chase its own tail.

Store knobs ride the same tick: the hot-tier fraction chases a target
hit rate, and the compaction threshold relaxes under serve pressure
(compaction competes for the same cores) and tightens when calm.

Every knob write goes through the constructors' validation —
``QueryServer.retune_lane`` rebuilds the lane's ``BatchPolicy`` (its
``__post_init__`` is the oracle) and the store setters re-validate — so
a buggy rule fails loudly instead of configuring garbage.

Decisions are pure functions of (config, stats deltas): tests inject
synthetic snapshot sequences via ``stats_fn`` and step :meth:`tick` on a
simulated clock, no sleeps.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from repro_torch.api.types import QoSClass

__all__ = ["AdaptiveController", "ControllerConfig", "ControllerSnapshot",
           "LaneKnobs"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Tuning rules + hard knob bounds (all validated at construction)."""

    # hysteresis band on the interval mean latency, as fractions of the
    # lane's latency budget
    lat_low_frac: float = 0.25
    lat_high_frac: float = 0.60
    # interval shed fraction that counts as pressure regardless of
    # latency
    shed_pressure: float = 0.02
    # pressure direction: shrink only when the interval mean service
    # time per batch exceeds this fraction of the lane budget (batches
    # themselves too expensive); cheaper batches mean pressure is a
    # capacity problem and the cure is amortization, i.e. grow
    svc_high_frac: float = 0.5
    # slack growth requires the key cap to be binding: interval mean
    # batch occupancy at least this fraction of the current cap
    bind_frac: float = 0.5
    # multiplicative step sizes (AIMD-ish: gentle up, sharp down)
    grow_factor: float = 1.4
    shrink_factor: float = 0.6
    # hard bounds the knobs may never leave
    min_batch_keys: int = 256
    max_batch_keys: int = 65_536
    min_wait_s: float = 2e-4
    max_wait_s: float = 8e-3
    # ticks to hold a lane after changing it (0 = react every tick)
    cooldown_ticks: int = 0
    # a lane needs this many interval submissions before its stats count
    min_samples: int = 16
    # hot-tier rule: chase this hit rate within [min, max] fraction
    hot_target_hit_rate: float = 0.85
    hot_step: float = 0.05
    min_hot_fraction: float = 0.05
    max_hot_fraction: float = 0.60
    # compaction threshold: tight when calm, relaxed under serve pressure
    compact_calm: float = 0.25
    compact_pressure: float = 0.60

    def __post_init__(self):
        if not 0 < self.lat_low_frac < self.lat_high_frac <= 1.0:
            raise ValueError(
                f"need 0 < lat_low_frac < lat_high_frac <= 1, got "
                f"{self.lat_low_frac}, {self.lat_high_frac}")
        if not 0 < self.shed_pressure < 1:
            raise ValueError(f"shed_pressure must be in (0, 1), "
                             f"got {self.shed_pressure}")
        if not 0 < self.svc_high_frac <= 1:
            raise ValueError(f"svc_high_frac must be in (0, 1], "
                             f"got {self.svc_high_frac}")
        if not 0 < self.bind_frac <= 1:
            raise ValueError(f"bind_frac must be in (0, 1], "
                             f"got {self.bind_frac}")
        if not self.grow_factor > 1.0:
            raise ValueError(f"grow_factor must be > 1, "
                             f"got {self.grow_factor}")
        if not 0 < self.shrink_factor < 1.0:
            raise ValueError(f"shrink_factor must be in (0, 1), "
                             f"got {self.shrink_factor}")
        if not (isinstance(self.min_batch_keys, int)
                and isinstance(self.max_batch_keys, int)
                and 1 <= self.min_batch_keys <= self.max_batch_keys):
            raise ValueError(
                f"need ints 1 <= min_batch_keys <= max_batch_keys, got "
                f"{self.min_batch_keys}, {self.max_batch_keys}")
        if not 0 < self.min_wait_s <= self.max_wait_s:
            raise ValueError(f"need 0 < min_wait_s <= max_wait_s, got "
                             f"{self.min_wait_s}, {self.max_wait_s}")
        if self.cooldown_ticks < 0 or self.min_samples < 1:
            raise ValueError("cooldown_ticks must be >= 0 and "
                             "min_samples >= 1")
        if not 0 < self.hot_target_hit_rate < 1:
            raise ValueError(f"hot_target_hit_rate must be in (0, 1), "
                             f"got {self.hot_target_hit_rate}")
        if not 0 < self.hot_step < 1:
            raise ValueError(f"hot_step must be in (0, 1), "
                             f"got {self.hot_step}")
        if not (0 < self.min_hot_fraction <= self.max_hot_fraction <= 1):
            raise ValueError(
                f"need 0 < min_hot_fraction <= max_hot_fraction <= 1, got "
                f"{self.min_hot_fraction}, {self.max_hot_fraction}")
        for name in ("compact_calm", "compact_pressure"):
            v = getattr(self, name)
            if not 0 < v <= 1:
                raise ValueError(f"{name} must be in (0, 1], got {v}")


@dataclasses.dataclass
class LaneKnobs:
    """One lane's live close rules (for the obs bridge; label: qos)."""

    max_batch_keys: int = 0
    max_batch_requests: int = 0
    max_wait_ms: float = 0.0


@dataclasses.dataclass
class ControllerSnapshot:
    """The controller's own telemetry — how often it acted, and where the
    store knobs currently sit."""

    ticks: int = 0
    grows: int = 0
    shrinks: int = 0
    holds: int = 0
    hot_adjustments: int = 0
    compact_adjustments: int = 0
    hot_fraction: float = float("nan")
    compact_threshold: float = float("nan")
    per_lane: dict = dataclasses.field(default_factory=dict)


class AdaptiveController:
    """Periodically reads stats deltas and retunes the serving knobs.

    ``budgets`` maps the lanes under control to their latency budgets
    (seconds); lanes without a budget (PREFETCH) are left alone — their
    close rules are whatever slack the static policy gives them.
    ``stores`` are ``HybridKVStore``-like objects exposing
    ``set_hot_fraction`` / ``set_compaction_threshold`` /
    ``stats_snapshot``; pass none to control batching only.  Single
    writer by design: one controller per server."""

    def __init__(self, server, budgets: dict, *,
                 config: Optional[ControllerConfig] = None,
                 stores: tuple = (),
                 stats_fn: Optional[Callable] = None):
        if not budgets:
            raise ValueError("budgets must map at least one QoS class to "
                             "a latency budget in seconds")
        self.server = server
        self.config = config or ControllerConfig()
        self.budgets = {QoSClass.parse(q): float(b)
                        for q, b in budgets.items()}
        for q, b in self.budgets.items():
            if not b > 0:
                raise ValueError(f"budget for {q.name} must be > 0, got {b}")
        self.stores = tuple(stores)
        self._stats_fn = stats_fn or server.stats_snapshot
        self._last = self._stats_fn()
        self._last_tiers = self._tier_totals()
        self._cooldown = {q: 0 for q in self.budgets}
        self._lock = threading.Lock()
        self._snap = ControllerSnapshot()
        self.history: list[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the request cap is a close rule too: a grown key budget is
        # useless if batches still close at the old request count.  Keep
        # each lane's requests-per-key shape from its starting policy
        # and scale both caps together.
        self._req_ratio = {}
        for name, pol in self.server.lane_policies().items():
            q = QoSClass.parse(name)
            self._req_ratio[q] = (pol.max_batch_requests
                                  / max(pol.max_batch_keys, 1))
        # clamp whatever the server starts with into our bounds so the
        # monotone-approach invariant holds from tick zero
        for q in self.budgets:
            cur = self.server.lane_policies()[q.name]
            self._apply(q, cur.max_batch_keys, cur.max_wait_s)

    # ------------------------------------------------------------------
    def _tier_totals(self) -> dict:
        tot = {"hot_hits": 0, "cold_misses": 0}
        for store in self.stores:
            st = store.stats_snapshot()
            tot["hot_hits"] += st.hot_hits
            tot["cold_misses"] += st.cold_misses
        return tot

    def _clamp(self, keys: float, wait: float) -> tuple[int, float]:
        cfg = self.config
        keys_i = int(min(max(int(round(keys)), cfg.min_batch_keys),
                         cfg.max_batch_keys))
        wait_f = float(min(max(wait, cfg.min_wait_s), cfg.max_wait_s))
        return keys_i, wait_f

    def _apply(self, q: QoSClass, keys: float, wait: float) -> dict:
        keys_i, wait_f = self._clamp(keys, wait)
        # the request cap scales with the key cap at the lane's initial
        # requests-per-key ratio: both are close rules, and a batch that
        # hits the stale request count never reaches the grown key budget
        reqs_i = max(int(round(keys_i * self._req_ratio.get(q, 1.0))), 1)
        # BatchPolicy.__post_init__ is the validation oracle: the
        # rebuilt policy raises before anything reaches the scheduler
        pol = self.server.retune_lane(q, max_batch_keys=keys_i,
                                      max_batch_requests=reqs_i,
                                      max_wait_s=wait_f)
        return {"max_batch_keys": pol.max_batch_keys,
                "max_batch_requests": pol.max_batch_requests,
                "max_wait_s": pol.max_wait_s}

    def _lane_decision(self, q: QoSClass, cur, prev,
                       svc_ms: Optional[float],
                       batch_keys: Optional[float],
                       cap_keys: int) -> tuple[str, str]:
        """(action, reason) for one lane from the interval stats deltas.

        ``svc_ms``/``batch_keys`` are the server-wide interval mean
        service time and key occupancy per micro-batch (None when no
        batch finished in the interval); ``cap_keys`` is the lane's
        live ``max_batch_keys``."""
        cfg = self.config
        budget = self.budgets[q]
        d_submitted = cur.submitted - prev.submitted
        d_shed = cur.shed - prev.shed
        if self._cooldown[q] > 0:
            self._cooldown[q] -= 1
            return "hold", "cooldown"
        if d_submitted < cfg.min_samples:
            return "hold", "too few interval samples"
        shed_frac = d_shed / d_submitted
        d_completed = cur.completed - prev.completed
        mean_ms = ((cur.latency_sum_ms - prev.latency_sum_ms) / d_completed
                   if d_completed > 0 else None)
        pressure = shed_frac > cfg.shed_pressure or (
            mean_ms is not None and mean_ms * 1e-3
            > cfg.lat_high_frac * budget)
        if pressure:
            # which side of the throughput optimum are we on?  no
            # finished batch all interval counts as expensive: a wide
            # collect is stalling the pipeline
            if svc_ms is None or svc_ms * 1e-3 > cfg.svc_high_frac * budget:
                svc = "none" if svc_ms is None else f"{svc_ms:.1f}ms"
                return "shrink", (f"pressure (shed {shed_frac:.1%}) with "
                                  f"expensive batches (svc {svc})")
            return "grow", (f"pressure (shed {shed_frac:.1%}, mean "
                            f"{mean_ms or float('nan'):.1f}ms) with cheap "
                            f"batches (svc {svc_ms:.1f}ms)")
        if mean_ms is None:
            # submissions but no completions and no sheds: everything is
            # queued — no latency read yet, don't thrash
            return "hold", "no interval completions"
        if mean_ms * 1e-3 < cfg.lat_low_frac * budget and shed_frac == 0.0:
            if batch_keys is not None and batch_keys \
                    >= cfg.bind_frac * cap_keys:
                return "grow", f"mean {mean_ms:.1f}ms under low water"
            return "hold", "slack but key cap not binding"
        return "hold", "in band"

    # ------------------------------------------------------------------
    def tick(self) -> dict:
        """One control step: read stats, decide per lane, actuate."""
        cfg = self.config
        snap = self._stats_fn()
        record: dict = {"lanes": {}, "stores": {}}
        any_pressure = False
        d_batches = snap.batches - self._last.batches
        svc_ms = ((snap.service_sum_ms - self._last.service_sum_ms)
                  / d_batches if d_batches > 0 else None)
        batch_keys = ((snap.keys_requested - self._last.keys_requested)
                      / d_batches if d_batches > 0 else None)
        with self._lock:
            self._snap.ticks += 1
            for q in sorted(self.budgets):
                cur = snap.per_class.get(q.name)
                prev = self._last.per_class.get(q.name)
                if cur is None or prev is None:
                    continue
                live_cap = self.server.lane_policies()[q.name]
                action, reason = self._lane_decision(
                    q, cur, prev, svc_ms, batch_keys,
                    live_cap.max_batch_keys)
                keys, wait = live_cap.max_batch_keys, live_cap.max_wait_s
                if action == "shrink":
                    any_pressure = True
                    knobs = self._apply(q, keys * cfg.shrink_factor,
                                        wait * cfg.shrink_factor)
                    self._snap.shrinks += 1
                    if (knobs["max_batch_keys"], knobs["max_wait_s"]) \
                            != (keys, wait):
                        self._cooldown[q] = cfg.cooldown_ticks
                elif action == "grow":
                    knobs = self._apply(q, keys * cfg.grow_factor,
                                        wait * cfg.grow_factor)
                    self._snap.grows += 1
                    if (knobs["max_batch_keys"], knobs["max_wait_s"]) \
                            != (keys, wait):
                        self._cooldown[q] = cfg.cooldown_ticks
                else:
                    knobs = {"max_batch_keys": keys,
                             "max_batch_requests":
                                 live_cap.max_batch_requests,
                             "max_wait_s": wait}
                    self._snap.holds += 1
                record["lanes"][q.name] = {"action": action,
                                           "reason": reason, **knobs}
            self._follow_uncontrolled(record)
            record["stores"] = self._store_tick(any_pressure)
            self._last = snap
            self.history.append(record)
        return record

    def _follow_uncontrolled(self, record: dict) -> None:  # lock-held: _lock
        """Budget-less lanes (PREFETCH) track the *widest* controlled
        lane.  They have no deadline to protect — but their batches
        share the serve pipeline, so leaving them on a stale tiny close
        rule floods it with unamortized launches and starves the lanes
        that do have budgets."""
        live = self.server.lane_policies()
        widest_keys = widest_wait = None
        for q in self.budgets:
            pol = live.get(q.name)
            if pol is None:
                continue
            widest_keys = pol.max_batch_keys if widest_keys is None \
                else max(widest_keys, pol.max_batch_keys)
            widest_wait = pol.max_wait_s if widest_wait is None \
                else max(widest_wait, pol.max_wait_s)
        if widest_keys is None:
            return
        for q in QoSClass:
            if q in self.budgets or q.name not in live:
                continue
            pol = live[q.name]
            if (pol.max_batch_keys, pol.max_wait_s) \
                    == (widest_keys, widest_wait):
                continue
            knobs = self._apply(q, widest_keys, widest_wait)
            record["lanes"][q.name] = {"action": "follow",
                                       "reason": "widest controlled lane",
                                       **knobs}

    def _store_tick(self, pressure: bool) -> dict:
        """Hot-tier fraction chases the target hit rate; compaction
        threshold follows the serve-pressure regime."""
        cfg = self.config
        out: dict = {}
        if not self.stores:
            return out
        tiers = self._tier_totals()
        d_hits = tiers["hot_hits"] - self._last_tiers["hot_hits"]
        d_miss = tiers["cold_misses"] - self._last_tiers["cold_misses"]
        self._last_tiers = tiers
        threshold = cfg.compact_pressure if pressure else cfg.compact_calm
        hit_rate = d_hits / (d_hits + d_miss) \
            if (d_hits + d_miss) >= cfg.min_samples else None
        fractions = []
        for store in self.stores:
            if store.compaction_threshold != threshold:
                store.set_compaction_threshold(threshold)
                self._snap.compact_adjustments += 1
            frac = store.hot_fraction
            if hit_rate is not None:
                if hit_rate < cfg.hot_target_hit_rate:
                    target = min(frac + cfg.hot_step, cfg.max_hot_fraction)
                elif hit_rate > 0.98:
                    target = max(frac - cfg.hot_step, cfg.min_hot_fraction)
                else:
                    target = frac
                if abs(target - frac) > 1e-9:
                    store.set_hot_fraction(target)
                    self._snap.hot_adjustments += 1
                    frac = store.hot_fraction
            fractions.append(frac)
        self._snap.hot_fraction = (sum(fractions) / len(fractions)
                                   if fractions else float("nan"))
        self._snap.compact_threshold = threshold
        out["hit_rate"] = hit_rate
        out["compact_threshold"] = threshold
        out["hot_fraction"] = self._snap.hot_fraction
        return out

    # ------------------------------------------------------------------
    def snapshot(self) -> ControllerSnapshot:
        with self._lock:
            snap = dataclasses.replace(
                self._snap, per_lane={})
            for q in self.budgets:
                pol = self.server.lane_policies()[q.name]
                snap.per_lane[q.name] = LaneKnobs(
                    max_batch_keys=pol.max_batch_keys,
                    max_batch_requests=pol.max_batch_requests,
                    max_wait_ms=pol.max_wait_s * 1e3)
            return snap

    def decisions(self) -> dict:
        """Compact summary for the SLO report."""
        snap = self.snapshot()
        return {
            "ticks": snap.ticks, "grows": snap.grows,
            "shrinks": snap.shrinks, "holds": snap.holds,
            "hot_adjustments": snap.hot_adjustments,
            "compact_adjustments": snap.compact_adjustments,
            "lanes": {name: {"max_batch_keys": k.max_batch_keys,
                             "max_batch_requests": k.max_batch_requests,
                             "max_wait_ms": round(k.max_wait_ms, 3)}
                      for name, k in snap.per_lane.items()},
        }

    # -- background loop ------------------------------------------------
    def start(self, period_s: float = 0.25) -> None:
        """Idempotent background tick loop (real clock)."""
        if not period_s > 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(period_s):
                self.tick()

        self._thread = threading.Thread(target=loop,
                                        name="adaptive-controller",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
