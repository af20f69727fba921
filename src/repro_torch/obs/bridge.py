"""Bridges: the repo's existing stat silos -> the metrics registry.
A copy of the JAX package's ``obs/bridge.py``: every catalog equals the
JAX package's key for key, so both packages expose the same names.

Each silo (``ServerStats``, ``FabricMetrics``, ``TierStats``,
``VersionWindow``) stays the single source of truth for its counters;
a bridge registers a *collector* on the registry that pulls a fresh
snapshot at scrape time and pushes it into registry metrics.  Between
scrapes the silos pay nothing.

The ``*_METRICS`` module-level dict literals are the catalog: silo field
-> exposition name.  The JAX package's metrics-coverage checker holds its
copy to every silo field, unique names and ``docs/observability.md``;
``tests/test_torch_observability.py`` holds this copy equal to it.

Naming convention (load-bearing): names ending ``_total`` render as
Prometheus counters; everything else renders as a gauge.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

from repro_torch.obs.metrics import Registry

# -- catalog: silo field -> exposition name ---------------------------------
# serve/scheduler.StatsSnapshot (one QueryServer's totals)
SERVER_STATS_METRICS = {
    "submitted": "repro_server_requests_submitted_total",
    "completed": "repro_server_requests_completed_total",
    "failed": "repro_server_requests_failed_total",
    "shed_queue_full": "repro_server_shed_queue_full_total",
    "shed_deadline": "repro_server_shed_deadline_total",
    "batches": "repro_server_batches_total",
    "launches": "repro_server_launches_total",
    "keys_requested": "repro_server_keys_requested_total",
    "keys_deviceside": "repro_server_keys_deviceside_total",
    "service_sum_ms": "repro_server_service_time_ms_total",
    "deadline_hits": "repro_server_deadline_hits_total",
    "deadline_misses": "repro_server_deadline_misses_total",
    "p50_ms": "repro_server_latency_p50_ms",
    "p99_ms": "repro_server_latency_p99_ms",
    "mean_occupancy": "repro_server_batch_occupancy",
    "coalesce_rate": "repro_server_coalesce_rate",
    "shed_rate": "repro_server_shed_rate",
}

# serve/scheduler.ClassSnapshot (per-QoS slice; label: qos)
CLASS_STATS_METRICS = {
    "submitted": "repro_server_class_requests_submitted_total",
    "completed": "repro_server_class_requests_completed_total",
    "failed": "repro_server_class_requests_failed_total",
    "shed_queue_full": "repro_server_class_shed_queue_full_total",
    "shed_deadline": "repro_server_class_shed_deadline_total",
    "latency_sum_ms": "repro_server_class_latency_sum_ms_total",
    "p50_ms": "repro_server_class_latency_p50_ms",
    "p99_ms": "repro_server_class_latency_p99_ms",
    "shed_rate": "repro_server_class_shed_rate",
}

# serve/fabric.FabricCounts (the router's counter set)
FABRIC_METRICS = {
    "queries": "repro_fabric_queries_total",
    "sub_queries": "repro_fabric_sub_queries_total",
    "updates": "repro_fabric_updates_total",
    "consistent_batches": "repro_fabric_consistent_batches_total",
    "mixed_version_averted": "repro_fabric_mixed_version_averted_total",
    "version_retries": "repro_fabric_version_retries_total",
    "failovers": "repro_fabric_failovers_total",
    "replica_failures": "repro_fabric_replica_failures_total",
    "respawns": "repro_fabric_respawns_total",
    "snapshots": "repro_fabric_snapshots_total",
}

# core/tiering.TierStats (per hybrid hot/cold table; label: table)
TIER_STATS_METRICS = {
    "lookups": "repro_tier_lookups_total",
    "hot_hits": "repro_tier_hot_hits_total",
    "cold_misses": "repro_tier_cold_misses_total",
    "not_found": "repro_tier_not_found_total",
    "admissions": "repro_tier_admissions_total",
    "evictions": "repro_tier_evictions_total",
    "cold_bytes_read": "repro_tier_cold_bytes_read_total",
    "hot_bytes_read": "repro_tier_hot_bytes_read_total",
    "garbage_bytes": "repro_tier_garbage_bytes",
    "cold_file_bytes": "repro_tier_cold_file_bytes",
    "compactions": "repro_tier_compactions_total",
    "compaction_rows_rewritten": "repro_tier_compaction_rows_rewritten_total",
    "compaction_bytes_reclaimed": "repro_tier_compaction_bytes_reclaimed_total",
}

# derived from TierStats fields at scrape time (ratios the paper quotes)
TIER_DERIVED_METRICS = {
    "hit_rate": "repro_tier_hot_hit_rate",
    "garbage_fraction": "repro_tier_garbage_fraction",
}

# core/versioning.VersionWindow protocol counters
WINDOW_METRICS = {
    "pins": "repro_version_pin_served_total",
    "nacks": "repro_version_pin_nacks_total",
    "publishes": "repro_version_window_publishes_total",
    "evictions": "repro_version_window_evictions_total",
}

# stream/pipeline.StreamSnapshot (the streaming update pipeline's silo)
STREAM_METRICS = {
    "events_consumed": "repro_stream_events_consumed_total",
    "trainer_steps": "repro_stream_trainer_steps_total",
    "deltas_published": "repro_stream_deltas_published_total",
    "rows_upserted": "repro_stream_rows_upserted_total",
    "profile_flushes": "repro_stream_profile_flushes_total",
    "trending_refreshes": "repro_stream_trending_refreshes_total",
    "events_shed": "repro_stream_events_shed_total",
    "truncations_recovered": "repro_stream_truncations_recovered_total",
    "staleness_violations": "repro_stream_staleness_violations_total",
    "min_version_violations": "repro_stream_min_version_violations_total",
    "freshness_samples": "repro_stream_freshness_samples",
    "freshness_p50_ms": "repro_stream_freshness_p50_ms",
    "freshness_p99_ms": "repro_stream_freshness_p99_ms",
    "updates_per_s": "repro_stream_updates_per_s",
}

# the event-append -> servable-version latency distribution (observed by
# StreamStats.on_freshness, wired in bridge_stream_stats)
STREAM_HISTOGRAM_METRICS = {
    "freshness_seconds": "repro_stream_freshness_seconds",
}

# traffic/driver.TrafficSnapshot (one load-generator run's totals)
TRAFFIC_METRICS = {
    "offered": "repro_traffic_requests_offered_total",
    "completed": "repro_traffic_requests_completed_total",
    "shed": "repro_traffic_requests_shed_total",
    "failed": "repro_traffic_requests_failed_total",
    "slo_hits": "repro_traffic_slo_hits_total",
    "slo_misses": "repro_traffic_slo_misses_total",
    "attainment": "repro_traffic_slo_attainment",
    "offered_rps": "repro_traffic_offered_rps",
    "dispatch_lag_ms": "repro_traffic_dispatch_lag_ms",
    "p50_ms": "repro_traffic_latency_p50_ms",
    "p99_ms": "repro_traffic_latency_p99_ms",
}

# traffic/driver.ClassTraffic (per-QoS slice; label: qos)
TRAFFIC_CLASS_METRICS = {
    "offered": "repro_traffic_class_requests_offered_total",
    "completed": "repro_traffic_class_requests_completed_total",
    "shed": "repro_traffic_class_requests_shed_total",
    "failed": "repro_traffic_class_requests_failed_total",
    "slo_hits": "repro_traffic_class_slo_hits_total",
    "slo_misses": "repro_traffic_class_slo_misses_total",
    "attainment": "repro_traffic_class_slo_attainment",
    "p50_ms": "repro_traffic_class_latency_p50_ms",
    "p99_ms": "repro_traffic_class_latency_p99_ms",
}

# traffic/controller.ControllerSnapshot (the adaptive control plane)
CONTROLLER_METRICS = {
    "ticks": "repro_traffic_ctl_ticks_total",
    "grows": "repro_traffic_ctl_grows_total",
    "shrinks": "repro_traffic_ctl_shrinks_total",
    "holds": "repro_traffic_ctl_holds_total",
    "hot_adjustments": "repro_traffic_ctl_hot_adjustments_total",
    "compact_adjustments": "repro_traffic_ctl_compact_adjustments_total",
    "hot_fraction": "repro_traffic_ctl_hot_fraction",
    "compact_threshold": "repro_traffic_ctl_compact_threshold",
}

# traffic/controller.LaneKnobs (per-lane live close rules; label: qos)
LANE_KNOB_METRICS = {
    "max_batch_keys": "repro_traffic_ctl_lane_max_batch_keys",
    "max_batch_requests": "repro_traffic_ctl_lane_max_batch_requests",
    "max_wait_ms": "repro_traffic_ctl_lane_max_wait_ms",
}


def _emit(registry: Registry, mapping: Dict[str, str], data: Dict,
          labels: Dict[str, str]) -> None:
    """Push one snapshot dict through a field->name mapping.  ``_total``
    names render as counters (via the bridge-only ``set_total`` face),
    the rest as gauges."""
    labelnames = tuple(sorted(labels))
    for field, name in mapping.items():
        value = data.get(field)
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        if name.endswith("_total"):
            if math.isnan(value):
                continue              # a counter can't adopt NaN
            registry.counter(name, labelnames=labelnames) \
                .set_total(value, **labels)
        else:
            registry.gauge(name, labelnames=labelnames) \
                .set(value, **labels)


def _as_dict(snap) -> Dict:
    return snap if isinstance(snap, dict) else dataclasses.asdict(snap)


def _emit_server(registry: Registry, snap,
                 labels: Dict[str, str]) -> None:
    data = _as_dict(snap)
    _emit(registry, SERVER_STATS_METRICS, data, labels)
    for qos, cls in (data.get("per_class") or {}).items():
        _emit(registry, CLASS_STATS_METRICS, _as_dict(cls),
              {**labels, "qos": str(qos)})


def _emit_tiers(registry: Registry, tiers: Dict[str, Dict],
                labels: Dict[str, str]) -> None:
    for table, data in tiers.items():
        data = _as_dict(data)
        tl = {**labels, "table": str(table)}
        _emit(registry, TIER_STATS_METRICS, data, tl)
        lookups = data.get("lookups") or 0
        total = data.get("cold_file_bytes") or 0
        derived = {
            "hit_rate": (data.get("hot_hits", 0) / lookups)
            if lookups else 0.0,
            "garbage_fraction": (data.get("garbage_bytes", 0) / total)
            if total else 0.0,
        }
        _emit(registry, TIER_DERIVED_METRICS, derived, tl)


# -- bridge registrations ----------------------------------------------------
def bridge_server_stats(registry: Registry,
                        snapshot_fn: Callable[[], object],
                        labels: Optional[Dict[str, str]] = None
                        ) -> Callable[[], None]:
    """Bridge a ``QueryServer``'s stats (``snapshot_fn`` returning a
    ``StatsSnapshot``/dict, or None to skip a scrape)."""
    fixed = dict(labels or {})

    def collect() -> None:
        snap = snapshot_fn()
        if snap is not None:
            _emit_server(registry, snap, fixed)

    registry.register_collector(collect)
    return collect


def bridge_tier_stats(registry: Registry,
                      stats_fn: Callable[[], Dict[str, Dict]],
                      labels: Optional[Dict[str, str]] = None
                      ) -> Callable[[], None]:
    """Bridge per-table ``TierStats`` (``stats_fn`` returning
    ``{table: {field: value}}`` — e.g. ``StoreBackend.tier_stats``)."""
    fixed = dict(labels or {})

    def collect() -> None:
        tiers = stats_fn()
        if tiers:
            _emit_tiers(registry, tiers, fixed)

    registry.register_collector(collect)
    return collect


def bridge_version_window(registry: Registry, window
                          ) -> Callable[[], None]:
    """Bridge a ``VersionWindow``'s protocol counters (pins served, NACKs,
    publishes, retention evictions)."""

    def collect() -> None:
        _emit(registry, WINDOW_METRICS, window.counters(), {})

    registry.register_collector(collect)
    return collect


def bridge_stream_stats(registry: Registry, stats
                        ) -> Callable[[], None]:
    """Bridge a streaming pipeline's ``StreamStats`` silo: its snapshot
    counters at scrape time, plus every freshness sample streamed into
    the ``repro_stream_freshness_seconds`` histogram as it is observed
    (the silo's ``on_freshness`` hook)."""
    hist = registry.histogram(
        STREAM_HISTOGRAM_METRICS["freshness_seconds"],
        help="event-append -> servable-version latency (s)")
    stats.on_freshness = hist.observe

    def collect() -> None:
        _emit(registry, STREAM_METRICS,
              dataclasses.asdict(stats.snapshot()), {})

    registry.register_collector(collect)
    return collect


def bridge_traffic_stats(registry: Registry,
                         snapshot_fn: Callable[[], object],
                         labels: Optional[Dict[str, str]] = None
                         ) -> Callable[[], None]:
    """Bridge a load-generator run's ``TrafficStats`` (``snapshot_fn``
    returning a ``TrafficSnapshot``/dict): run totals plus the per-QoS
    slices under the ``qos`` label — offered load and SLO attainment as
    the *client* saw them, the counterpart to the server-side silo."""
    fixed = dict(labels or {})

    def collect() -> None:
        snap = snapshot_fn()
        if snap is None:
            return
        data = _as_dict(snap)
        _emit(registry, TRAFFIC_METRICS, data, fixed)
        for qos, cls in (data.get("per_class") or {}).items():
            _emit(registry, TRAFFIC_CLASS_METRICS, _as_dict(cls),
                  {**fixed, "qos": str(qos)})

    registry.register_collector(collect)
    return collect


def bridge_controller(registry: Registry, controller,
                      labels: Optional[Dict[str, str]] = None
                      ) -> Callable[[], None]:
    """Bridge an ``AdaptiveController``: decision counters, store knobs,
    and each lane's live close rules under the ``qos`` label — a scrape
    shows where the control plane has steered the serving config."""
    fixed = dict(labels or {})

    def collect() -> None:
        snap = controller.snapshot()
        data = _as_dict(snap)
        _emit(registry, CONTROLLER_METRICS, data, fixed)
        for qos, knobs in (data.get("per_lane") or {}).items():
            _emit(registry, LANE_KNOB_METRICS, _as_dict(knobs),
                  {**fixed, "qos": str(qos)})

    registry.register_collector(collect)
    return collect


def bridge_fabric_metrics(registry: Registry, metrics
                          ) -> Callable[[], None]:
    """Bridge a router's ``FabricMetrics`` counter set alone (the full
    fabric view including shard-side silos is ``bridge_router``)."""

    def collect() -> None:
        _emit(registry, FABRIC_METRICS,
              dataclasses.asdict(metrics.snapshot()), {})

    registry.register_collector(collect)
    return collect


def bridge_router(registry: Registry, router,
                  stats_timeout_s: float = 5.0) -> Callable[[], None]:
    """The fabric's whole metrics surface behind one parent-side registry:
    the router's own counters plus, via the KIND_STATS RPC, every live
    replica's serving stats (label ``shard``, per-QoS under ``qos``) and
    tier counters (labels ``shard``, ``table``).  A scrape mid-failover
    degrades to whatever replicas answer — it never raises."""

    def collect() -> None:
        _emit(registry, FABRIC_METRICS,
              dataclasses.asdict(router.metrics.snapshot()), {})
        try:
            shards = router.collect_shard_stats(timeout_s=stats_timeout_s)
        except Exception:
            return                     # router mid-close; keep the scrape
        for shard_key, silo in shards.items():
            labels = {"shard": str(shard_key)}
            if silo.get("server"):
                _emit_server(registry, silo["server"], labels)
            if silo.get("tiers"):
                _emit_tiers(registry, silo["tiers"], labels)

    registry.register_collector(collect)
    return collect
