"""Realistic traffic harness + adaptive batching control plane.

``loadgen`` turns a seeded :class:`TrafficPattern` (zipfian popularity,
diurnal curves, flash crowds, mixed-QoS sessions) into a deterministic
offered-load timeline; ``driver`` replays it open-loop against a
``QueryServer`` and emits a machine-readable SLO report; ``controller``
closes the loop from live ``ServerStats``/``TierStats`` back into
``BatchPolicy`` close rules, compaction thresholds, and the hot-tier
fraction.  A copy of the JAX package's ``traffic/`` (host code: numpy
and threads, no device work), its imports pointed at the port, so the
same seed gives the same schedule and the same scripted stats give the
same decisions in both packages.
"""
from repro_torch.traffic.controller import (AdaptiveController,
                                            ControllerConfig,
                                            ControllerSnapshot, LaneKnobs)
from repro_torch.traffic.driver import (ClassTraffic, OpenLoopDriver, Sample,
                                        TrafficSnapshot, TrafficStats,
                                        burst_p99_ms, slo_report)
from repro_torch.traffic.loadgen import (DiurnalCurve, FlashCrowd, QoSMix,
                                         RequestEvent, RequestShape,
                                         TrafficPattern, ZipfianPopularity,
                                         burst_windows, default_shapes,
                                         generate_schedule,
                                         offered_per_window)

__all__ = [
    "AdaptiveController", "ClassTraffic", "ControllerConfig",
    "ControllerSnapshot", "DiurnalCurve", "FlashCrowd", "LaneKnobs",
    "OpenLoopDriver", "QoSMix", "RequestEvent", "RequestShape", "Sample",
    "TrafficPattern", "TrafficSnapshot", "TrafficStats",
    "ZipfianPopularity", "burst_p99_ms", "burst_windows", "default_shapes",
    "generate_schedule", "offered_per_window", "slo_report",
]
