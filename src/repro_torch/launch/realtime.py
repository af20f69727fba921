"""Realtime launcher for the port: the streaming online-learning loop, end
to end, with DIN's train step on the card.

    PYTHONPATH=src python -m repro_torch.launch.realtime --smoke \
        [--device cuda|cpu]

The counterpart of the JAX package's ``launch/realtime.py``, with the same
options and defaults.  One process runs the whole lambda loop the paper's
serving architecture assumes, concurrently:

  - sessionized traffic threads append impression/click events to the
    in-process event log (``repro_torch.stream``) and query features
    through ``FeatureClient`` -> ``QueryServer`` on the RANKING lane —
    every N-th query demands ``min_version`` read-your-writes against the
    newest published version;
  - a streaming trainer consumes the events in micro-batches, runs DIN's
    dense ``train_step`` (delta emission) on ``--device``, and publishes
    the touched embedding rows as incremental deltas;
  - a windowed-EMA updater maintains ``user_profile`` rows; a trending
    aggregator keeps the cold-start fallback row fresh (users with no
    profile yet are served the decayed top-k);
  - a rolling batch layer republishes the full tables every few seconds
    through the same serialized version sequence.

A step's batch is drawn on the host by ``synthetic.recsys_batch`` (its
``target_item`` and ``label`` overwritten from the events) and goes to
the card in one copy; the step's delta ids come back once a step, and the
touched rows' bytes are read from the card's ``item_table`` after the
step.  The batch layer copies one step's ``item_table`` rows to the host
with a synchronous copy on the trainer's (default) stream, so it reads
only what a finished step wrote.

Event-append -> servable-version latency lands in the obs registry as
the ``repro_stream_freshness_seconds`` histogram (plus publish spans via
``--trace-sample``), and the run exits with a per-run SLO report:
freshness p50/p99, staleness violations, updates/s, qps.  Exit is
nonzero on any ``min_version`` violation, served-version regression, or
pipeline-stage crash.

The model and the engine run on ``--device`` (default ``cuda``; there is
no fallback to the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time

import numpy as np
import torch

from repro_torch.api import Consistency, ConsistencyError, FeatureClient
from repro_torch.configs import din
from repro_torch.core import convert
from repro_torch.core.engine import EmbeddingTable, MultiTableEngine
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.models import recsys as rec
from repro_torch.obs.bridge import bridge_server_stats, bridge_stream_stats
from repro_torch.obs.exporter import MetricsServer, snapshot
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import Tracer
from repro_torch.serve.scheduler import BatchPolicy, ShedError
from repro_torch.serve.serve_step import _upload
from repro_torch.serve.server import QueryServer
from repro_torch.stream import (EventLog, ProfileEMAUpdater,
                                SessionizedSource, StreamStats,
                                StreamingTrainer, TrendingAggregator,
                                VersionedPublisher)
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

EVENTS_TOPIC = "events"
TRENDING_TOPIC = "trending"
PROFILE_DIM = 8


def _rows_as_bytes(table: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """``table``'s ``rows`` as float32 bytes on the host: gathered where the
    table lies, then one synchronous copy."""
    idx = torch.as_tensor(rows, dtype=torch.int64, device=table.device)
    return np.ascontiguousarray(
        table[idx].float().cpu().numpy()).view(np.uint8)


def _leading_rows_as_bytes(table: torch.Tensor, n: int) -> np.ndarray:
    """``table[:n]`` as float32 bytes on the host, in one synchronous copy
    (never the whole table)."""
    return np.ascontiguousarray(
        table[:n].float().cpu().numpy()).view(np.uint8)


def build_engine(args, item_table: torch.Tensor) -> MultiTableEngine:
    """Seed the serving tier: trained item rows, zeroed user profiles,
    an empty trending fallback row."""
    item_keys = np.arange(1, args.n_items + 1, dtype=np.uint64)
    item_vals = _leading_rows_as_bytes(item_table, args.n_items)
    user_keys = np.arange(1, args.n_users + 1, dtype=np.uint64)
    user_vals = np.zeros((args.n_users, PROFILE_DIM * 4), dtype=np.uint8)
    trend_vals = np.zeros((1, args.top_k * 8), dtype=np.uint8)
    return MultiTableEngine(embeddings=[
        EmbeddingTable("item_table", item_keys, item_vals,
                       hot_fraction=0.5),
        EmbeddingTable("user_profile", user_keys, user_vals,
                       hot_fraction=0.5),
        EmbeddingTable(TRENDING_TOPIC,
                       np.asarray([1], dtype=np.uint64), trend_vals),
    ], max_shard_bytes=1 << 18, version=1, device=item_table.device)


def make_step_fn(args, cfg, params):
    """The streaming trainer's ``step_fn``: fold the micro-batch's events
    into a DIN batch frame, run the real dense ``train_step`` with delta
    emission on the parameters' device, return the touched rows as an
    upsert."""
    ocfg = opt.OptConfig(lr=0.003)
    state = opt.init_opt_state(params, ocfg)
    step = ts.make_train_step(
        ts.recsys_loss_fn(cfg), ocfg,
        delta_ids_fn=lambda b: {"item_table": torch.cat(
            [b["hist_items"].reshape(-1), b["target_item"].reshape(-1)])})
    device = params["item_table"].device
    rng = np.random.default_rng(1234)
    holder = {"params": params, "state": state, "step": 0}

    def step_fn(events):
        batch = synthetic.recsys_batch(rng, cfg, args.train_batch)
        items = np.asarray([(ev.payload or {}).get("item", 0)
                            for ev in events], dtype=np.int64)
        clicks = np.asarray([ev.kind == "click" for ev in events],
                            dtype=np.float32)
        n = min(len(items), args.train_batch)
        batch["target_item"][:n] = items[:n] % cfg.item_vocab
        batch["label"][:n] = clicks[:n]
        p, s, st, metrics = step(holder["params"], holder["state"],
                                 holder["step"], _upload(batch, device))
        holder.update(params=p, state=s, step=st)
        ids = metrics["delta_ids"]["item_table"].cpu().numpy().reshape(-1)
        rows = np.unique(ids[(ids >= 0) & (ids < args.n_items)])
        if not len(rows):
            return None
        return {"item_table": (rows.astype(np.uint64) + np.uint64(1),
                               _rows_as_bytes(p["item_table"], rows))}

    return step_fn, holder


def full_tables(args, item_table: torch.Tensor, profiles, trending
                ) -> list[EmbeddingTable]:
    """The batch layer's full table set: ``item_table``'s first
    ``n_items`` rows (one step's parameters), every user's EMA profile
    and the trending top-k."""
    user_vals = np.zeros((args.n_users, PROFILE_DIM * 4), np.uint8)
    for u, vec in profiles.all_profiles().items():
        if 0 <= u < args.n_users:
            user_vals[u] = vec.astype(np.float32).view(np.uint8)
    top = (trending.top() + [0] * args.top_k)[:args.top_k]
    return [
        EmbeddingTable("item_table",
                       np.arange(1, args.n_items + 1, dtype=np.uint64),
                       _leading_rows_as_bytes(item_table, args.n_items),
                       hot_fraction=0.5),
        EmbeddingTable("user_profile",
                       np.arange(1, args.n_users + 1, dtype=np.uint64),
                       user_vals, hot_fraction=0.5),
        EmbeddingTable(TRENDING_TOPIC, np.asarray([1], dtype=np.uint64),
                       np.asarray(top, dtype=np.uint64)
                       .view(np.uint8).reshape(1, -1)),
    ]


def drive(args, registry_obj, tracer, cfg=None) -> tuple[int, dict]:
    """Run the loop once; -> (exit code, SLO report).  ``cfg`` is the DIN
    config to train (default: the JAX loop's, DIN ``SMOKE`` with
    ``item_vocab=n_items`` and ``seq_len=10``)."""
    if cfg is None:
        cfg = dataclasses.replace(din.SMOKE, item_vocab=args.n_items,
                                  seq_len=10)
    device = ops.resolve_device(args.device)
    params = convert.params_of(rec.recsys_init(cfg, seed=0, device=device))

    engine = build_engine(args, params["item_table"])
    server = QueryServer(engine, BatchPolicy(max_batch_keys=4096),
                         tracer=tracer)
    client = FeatureClient(server, default_budget_s=2.0)

    log = EventLog()
    log.create_topic(EVENTS_TOPIC, partitions=4, retention=args.retention)
    log.create_topic(TRENDING_TOPIC, partitions=1, retention=64)

    stats = StreamStats(slo_budget_s=args.slo_s)
    bridge_stream_stats(registry_obj, stats)
    bridge_server_stats(registry_obj, server.stats_snapshot)
    publisher = VersionedPublisher(client, engine.latest_version, stats)

    def publish_span(version, t0, t1, rows):
        tid = tracer.sample()
        if tid is not None:
            tracer.span(tid, "publish_delta", t0, t1,
                        tags={"version": version, "rows": rows})

    publisher.on_publish = publish_span

    step_fn, holder = make_step_fn(args, cfg, params)
    # two steps on synthetic batches before any event's clock starts (the
    # JAX loop's compiles; here the CUDA context and the GEMM libraries)
    step_fn([])
    step_fn([])
    trainer = StreamingTrainer(log, EVENTS_TOPIC, publisher, stats, step_fn,
                               batch_events=args.train_batch,
                               max_backlog=args.max_backlog)
    profiles = ProfileEMAUpdater(log, EVENTS_TOPIC, publisher, stats,
                                 dim=PROFILE_DIM)
    trending = TrendingAggregator(log, EVENTS_TOPIC, publisher, stats,
                                  out_topic=TRENDING_TOPIC,
                                  top_k=args.top_k)
    stages = [trainer, profiles, trending]

    qlat: list[float] = []
    counters = {"queries": 0, "shed": 0, "fallback_served": 0,
                "ryw_checked": 0, "version_regressions": 0}
    clock = threading.Lock()
    stop = threading.Event()

    def traffic(cid: int):
        src = SessionizedSource(log, EVENTS_TOPIC, n_users=args.n_users,
                                n_items=args.n_items, seed=500 + cid)
        last_version = 0
        for i in range(args.requests):
            if stop.is_set():
                return
            user = src.pick_user()
            events = src.emit_session(user)
            item_keys = np.unique(np.asarray(
                [(ev.payload or {}).get("item", 0) for ev in events],
                dtype=np.uint64) + np.uint64(1))
            q = {"user_profile": np.asarray([user + 1], dtype=np.uint64),
                 TRENDING_TOPIC: np.asarray([1], dtype=np.uint64),
                 "item_table": item_keys}
            consistency = None
            if args.ryw_every and i % args.ryw_every == 0:
                # read-your-writes: demand at least the newest version
                # this process knows to be servable
                consistency = Consistency.min_version(publisher.version)
            t0 = time.perf_counter()
            try:
                res = client.query(q, qos="RANKING",
                                   consistency=consistency)
            except ConsistencyError:
                stats.inc("min_version_violations")
                continue
            except ShedError:
                with clock:
                    counters["shed"] += 1
                continue
            with clock:
                qlat.append((time.perf_counter() - t0) * 1e3)
                counters["queries"] += 1
                if consistency is not None:
                    counters["ryw_checked"] += 1
                if res.version < last_version:
                    counters["version_regressions"] += 1
            last_version = res.version
            prof = res.tables["user_profile"]
            if not prof.found[0] or not prof.values[0].any():
                # cold-start: no profile signal yet -> trending fallback
                trow = res.tables[TRENDING_TOPIC]
                if trow.found[0]:
                    TrendingAggregator.decode_row(trow.values[0])
                    with clock:
                        counters["fallback_served"] += 1

    def batch_layer():
        """Rolling full republish: the lambda batch layer, sharing the
        speed layer's serialized version sequence."""
        while not stop.wait(args.batch_publish_s):
            # one step's table (the step returns new tensors), read once
            item_tab = holder["params"]["item_table"]
            publisher.publish_full(embeddings=full_tables(
                args, item_tab, profiles, trending))

    t_run = time.perf_counter()
    for s in stages:
        s.start()
    batcher = threading.Thread(target=batch_layer, daemon=True)
    batcher.start()
    workers = [threading.Thread(target=traffic, args=(c,))
               for c in range(args.clients)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    # drain: let the pipeline catch up on the tail of the event stream
    deadline = time.monotonic() + args.drain_s
    while time.monotonic() < deadline \
            and log.backlog(EVENTS_TOPIC, "trainer") > 0 \
            and all(s.error is None for s in stages):
        time.sleep(0.02)
    stop.set()
    for s in stages:
        s.stop()
    batcher.join(timeout=5.0)
    elapsed = time.perf_counter() - t_run
    server.close()

    snap = stats.snapshot()
    stage_errors = {s.name: repr(s.error) for s in stages
                    if s.error is not None}
    report = {
        "freshness_p50_ms": round(snap.freshness_p50_ms, 3),
        "freshness_p99_ms": round(snap.freshness_p99_ms, 3),
        "freshness_samples": snap.freshness_samples,
        "staleness_violations": snap.staleness_violations,
        "updates_per_s": round(snap.updates_per_s, 2),
        "qps": round(counters["queries"] / max(elapsed, 1e-9), 2),
        "query_p50_ms": round(float(np.percentile(qlat, 50)), 3)
        if qlat else 0.0,
        "query_p99_ms": round(float(np.percentile(qlat, 99)), 3)
        if qlat else 0.0,
        "queries": counters["queries"],
        "shed": counters["shed"],
        "ryw_checked": counters["ryw_checked"],
        "min_version_violations": snap.min_version_violations,
        "version_regressions": counters["version_regressions"],
        "fallback_served": counters["fallback_served"],
        "deltas_published": snap.deltas_published,
        "trainer_steps": snap.trainer_steps,
        "events_consumed": snap.events_consumed,
        "events_shed": snap.events_shed,
        "final_version": publisher.version,
        "stage_errors": stage_errors,
    }
    rc = 0
    if snap.min_version_violations or counters["version_regressions"]:
        print("FAIL: consistency violated under concurrent publishing")
        rc = 1
    if stage_errors:
        print(f"FAIL: pipeline stage crashed: {stage_errors}")
        rc = 1
    if not snap.deltas_published or not counters["queries"]:
        print("FAIL: the loop did not actually run "
              f"(deltas={snap.deltas_published} "
              f"queries={counters['queries']})")
        rc = 1
    return rc, report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized: few users/requests, small model")
    ap.add_argument("--n-items", type=int, default=2000)
    ap.add_argument("--n-users", type=int, default=256)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=60,
                    help="sessions (each: events appended + one query) "
                         "per client thread")
    ap.add_argument("--train-batch", type=int, default=32)
    ap.add_argument("--retention", type=int, default=50_000)
    ap.add_argument("--max-backlog", type=int, default=4096)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--ryw-every", type=int, default=2,
                    help="every N-th query demands min_version "
                         "read-your-writes (0 disables)")
    ap.add_argument("--batch-publish-s", type=float, default=2.0,
                    help="rolling full-republish period (the batch layer)")
    ap.add_argument("--drain-s", type=float, default=5.0,
                    help="max seconds to let the pipeline drain the tail")
    ap.add_argument("--slo-s", type=float, default=2.0,
                    help="freshness SLO budget: event-append -> servable "
                         "above this counts as a staleness violation")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics on this port while "
                         "driving (0 = ephemeral; the bound URL is printed)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="fraction of queries/publishes to trace [0,1]")
    ap.add_argument("--record", default=None,
                    help="write a BENCH-style JSON record (SLO report + "
                         "metrics snapshot) to this path on exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.smoke:
        args.n_items = min(args.n_items, 500)
        args.n_users = min(args.n_users, 64)
        args.clients = min(args.clients, 2)
        args.requests = min(args.requests, 12)
    return args


def main(argv=None):
    args = parse_args(argv)
    ops.resolve_device(args.device)     # no card: raise before any thread
    registry_obj = Registry()
    tracer = Tracer(sample_rate=args.trace_sample, proc="realtime")
    metrics_srv = None
    if args.metrics_port is not None:
        metrics_srv = MetricsServer(registry_obj,
                                    port=args.metrics_port).start()
        print(f"metrics: serving {metrics_srv.url}", flush=True)
    t_start = time.time()
    try:
        rc, report = drive(args, registry_obj, tracer)
        print("realtime SLO report: "
              + json.dumps(report, sort_keys=True), flush=True)
        if args.record:
            record = {
                "alias": "realtime",
                "unix_time": int(t_start),
                "duration_s": round(time.time() - t_start, 3),
                "ok": rc == 0,
                "report": report,
                "metrics": snapshot(registry_obj),
            }
            with open(args.record, "w") as f:
                json.dump(record, f, indent=1)
            print(f"record: wrote {args.record}", flush=True)
    finally:
        if metrics_srv is not None:
            metrics_srv.close()
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
