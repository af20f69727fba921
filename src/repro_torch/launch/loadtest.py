"""End-to-end load test: realistic traffic against a live QueryServer.

Builds a hybrid-store-backed server, replays a seeded
:class:`TrafficPattern` (zipfian keys, optional diurnal curve, flash
crowds, mixed-QoS sessions) open-loop through ``OpenLoopDriver``, and —
with ``--adaptive`` — runs the :class:`AdaptiveController` loop that
retunes the lane close rules, compaction threshold, and hot-tier
fraction from live stats while the load runs.

Everything lands in one obs registry (server, tiers, offered traffic,
controller knobs; ``--metrics-port`` serves Prometheus /metrics live)
and the run emits a machine-readable SLO report line::

    PYTHONPATH=src python -m repro_torch.launch.loadtest --smoke --adaptive

Exit code is nonzero when the run is *broken* — requests failing with
real errors (sheds are an outcome, not a failure) or an offered stream
that never materialized — and when ``--min-attainment`` is given, when
overall SLO attainment lands below it.

The JAX package's ``launch/loadtest.py`` with the same arguments and
report.  As there, the server's backend is a ``StoreBackend`` over a host
``HybridKVStore``: the load test does no device work and takes no
``--device``.  ``main(argv)`` parses ``argv`` (default: the command line),
so it also runs in-process; it ends in ``SystemExit`` with the exit code.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.api.backends import StoreBackend
from repro_torch.core.hybrid_store import HybridKVStore
from repro_torch.obs.bridge import (bridge_controller, bridge_server_stats,
                                    bridge_tier_stats, bridge_traffic_stats)
from repro_torch.obs.exporter import MetricsServer, snapshot
from repro_torch.obs.metrics import Registry
from repro_torch.serve.scheduler import BatchPolicy
from repro_torch.serve.server import QueryServer
from repro_torch.traffic import (AdaptiveController, ControllerConfig,
                                 DiurnalCurve, FlashCrowd, OpenLoopDriver,
                                 TrafficPattern, default_shapes, slo_report)

TABLE = "item_attr"


def parse_burst(spec: str) -> FlashCrowd:
    """``start:duration:multiplier`` (seconds, seconds, ×)."""
    try:
        start, dur, mult = (float(x) for x in spec.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"burst must be start:duration:multiplier, got {spec!r}")
    return FlashCrowd(start, dur, mult)


def build_server(args) -> tuple[QueryServer, HybridKVStore]:
    rng = np.random.default_rng(args.seed)
    keys = np.arange(args.vocab, dtype=np.uint64)
    values = rng.integers(0, 255, (args.vocab, args.value_bytes),
                          dtype=np.uint8)
    store = HybridKVStore(keys, values, hot_fraction=args.hot_fraction)
    backend = StoreBackend({TABLE: store})
    server = QueryServer(backend,
                         BatchPolicy(max_batch_keys=args.max_batch_keys,
                                     max_wait_s=args.max_wait_ms * 1e-3))
    return server, store


def build_pattern(args) -> TrafficPattern:
    diurnal = None
    if args.diurnal_ratio > 1.0:
        # one full cycle across the run, peak mid-run
        diurnal = DiurnalCurve(period_s=args.duration_s,
                               peak_to_trough=args.diurnal_ratio)
    return TrafficPattern(duration_s=args.duration_s,
                          base_session_rate=args.rate,
                          seed=args.seed, vocab=args.vocab,
                          zipf_skew=args.zipf_skew, diurnal=diurnal,
                          bursts=tuple(args.burst),
                          shapes=default_shapes(TABLE))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized: short run, small store")
    ap.add_argument("--duration-s", type=float, default=8.0)
    ap.add_argument("--rate", type=float, default=60.0,
                    help="base session arrival rate (sessions/s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--value-bytes", type=int, default=32)
    ap.add_argument("--zipf-skew", type=float, default=1.1)
    ap.add_argument("--diurnal-ratio", type=float, default=2.0,
                    help="peak/trough load ratio over one run-length "
                         "cycle (1 disables)")
    ap.add_argument("--burst", type=parse_burst, action="append",
                    default=None, metavar="START:DUR:MULT",
                    help="flash-crowd window (repeatable); default one "
                         "4x burst mid-run")
    ap.add_argument("--hot-fraction", type=float, default=0.1)
    ap.add_argument("--max-batch-keys", type=int, default=8192)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--adaptive", action="store_true",
                    help="run the AdaptiveController loop during the run")
    ap.add_argument("--controller-period-s", type=float, default=0.25)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="stretch (>1) or compress (<1) the schedule clock")
    ap.add_argument("--min-attainment", type=float, default=None,
                    help="fail the run if overall SLO attainment is below")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics on this port while "
                         "driving (0 = ephemeral; the bound URL is printed)")
    ap.add_argument("--record", default=None,
                    help="write a BENCH-style JSON record (SLO report + "
                         "metrics snapshot) to this path on exit")
    args = ap.parse_args(argv)
    if args.smoke:
        args.duration_s = min(args.duration_s, 2.0)
        args.rate = min(args.rate, 40.0)
        args.vocab = min(args.vocab, 4000)
    if args.burst is None:
        third = args.duration_s / 3.0
        args.burst = [FlashCrowd(third, third / 2.0, 4.0)]

    registry = Registry()
    metrics_srv = None
    if args.metrics_port is not None:
        metrics_srv = MetricsServer(registry, port=args.metrics_port).start()
        print(f"metrics: serving {metrics_srv.url}", flush=True)

    server, store = build_server(args)
    pattern = build_pattern(args)
    driver = OpenLoopDriver(server, pattern,
                            keys={TABLE: np.arange(args.vocab,
                                                   dtype=np.uint64)},
                            time_scale=args.time_scale)
    bridge_server_stats(registry, server.stats_snapshot)
    bridge_tier_stats(registry, server.backend.tier_stats)
    bridge_traffic_stats(registry, driver.stats.snapshot)

    controller = None
    if args.adaptive:
        shapes = pattern.resolved_shapes()
        budgets = {q: s.budget_s for q, s in shapes.items()
                   if s.budget_s is not None}
        controller = AdaptiveController(server, budgets,
                                        config=ControllerConfig(),
                                        stores=(store,))
        bridge_controller(registry, controller)

    t_start = time.time()
    rc = 0
    try:
        if controller is not None:
            controller.start(args.controller_period_s)
        snap = driver.run()
        if controller is not None:
            controller.stop()
        report = slo_report(
            pattern, snap, driver.samples,
            controller=controller.decisions() if controller else None)
        print("loadtest SLO report: " + json.dumps(report, sort_keys=True),
              flush=True)
        if snap.offered == 0 or snap.failed > 0:
            print(f"loadtest: FAILED offered={snap.offered} "
                  f"failed={snap.failed}", flush=True)
            rc = 1
        if (args.min_attainment is not None
                and not snap.attainment >= args.min_attainment):
            print(f"loadtest: FAILED attainment {snap.attainment:.4f} < "
                  f"{args.min_attainment}", flush=True)
            rc = 1
        if args.record:
            record = {
                "alias": "loadtest",
                "unix_time": int(t_start),
                "duration_s": round(time.time() - t_start, 3),
                "ok": rc == 0,
                "report": report,
                "metrics": snapshot(registry),
            }
            with open(args.record, "w") as f:
                json.dump(record, f, indent=1)
            print(f"record: wrote {args.record}", flush=True)
    finally:
        if controller is not None:
            controller.stop()
        server.close()
        store.close()
        if metrics_srv is not None:
            metrics_srv.close()
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
