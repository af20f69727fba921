"""Fabric launcher: bring up the multi-process serving fabric and drive it.

    PYTHONPATH=src python -m repro_torch.launch.fabric --smoke

builds synthetic embedding tables, partitions them across shard-server
processes (2 shards x 2 replicas by default), then runs concurrent client
threads through ``FeatureClient -> FabricBackend -> Router`` while:

  - a publisher lands delta updates mid-traffic (every response stays
    single-version — the router NACK/retry protocol is exercised live);
  - ``--chaos`` kills one replica per second; queries fail over to the
    survivor and the health checker respawns the victim from the latest
    snapshot (+ update-log replay).

The JAX package's ``launch/fabric.py`` with the same flags, output and
``--record`` format (``alias``, ``ok``, the ``metrics`` snapshot).  The
fabric does no device work and takes no ``--device``: this module and the
whole fabric stack under it import without torch, and the launcher is the
torch-free ``__main__`` the spawned shard servers re-run (see
serve/fabric.py).  ``main(argv)`` parses ``argv`` (default: the command
line), so it also runs in-process; it ends in ``SystemExit`` with the exit
code.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time

import numpy as np

from repro_torch.api import FeatureClient, UpdateRequest, as_backend
from repro_torch.core.query_types import EmbeddingTable
from repro_torch.obs.bridge import bridge_router
from repro_torch.obs.exporter import MetricsServer, snapshot
from repro_torch.obs.metrics import Registry
from repro_torch.serve.fabric import FabricConfig, FabricError, Router


def build_router(args, snapshot_root: str) -> Router:
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 1 << 62, args.n_keys * 2,
                                  dtype=np.uint64))[:args.n_keys]
    values = rng.integers(0, 256, size=(len(keys), args.value_bytes),
                          dtype=np.uint8)
    tables = [EmbeddingTable("emb", keys, values, hot_fraction=0.5,
                             variant=args.variant)]
    cfg = FabricConfig(n_shards=args.shards, n_replicas=args.replicas,
                       snapshot_root=snapshot_root,
                       health_period_s=0.25, snapshot_every=4,
                       trace_sample_rate=args.trace_sample)
    t0 = time.perf_counter()
    router = Router.build(tables, cfg)
    print(f"fabric: {args.shards} shards x {args.replicas} replicas up in "
          f"{time.perf_counter() - t0:.2f}s "
          f"({len(keys)} keys, snapshots at {snapshot_root})")
    return router


def drive(args, router: Router) -> int:
    client = FeatureClient(as_backend(router), default_budget_s=5.0)
    # same generator seed as build_router: drive the keys the tables
    # actually hold, so hit-rate/tier metrics reflect real traffic
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 1 << 62, args.n_keys * 2,
                                  dtype=np.uint64))[:args.n_keys]
    lat: list[float] = []
    errors = [0]
    lock = threading.Lock()

    def worker(cid: int):
        wrng = np.random.default_rng(100 + cid)
        for _ in range(args.requests):
            q = keys[wrng.integers(0, len(keys), args.batch_keys)]
            t0 = time.perf_counter()
            try:
                client.query({"emb": q})
            except FabricError:
                with lock:
                    errors[0] += 1
                continue
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)

    stop = threading.Event()

    def publisher():
        version = router.fleet_version
        prng = np.random.default_rng(7)
        while not stop.wait(0.2):
            version += 1
            up = keys[prng.integers(0, len(keys), 128)]
            rows = prng.integers(0, 256, size=(len(up), args.value_bytes),
                                 dtype=np.uint8)
            try:
                router.apply_update(UpdateRequest(
                    version=version, upserts={"emb": (up, rows)}))
            except (FabricError, ValueError):
                pass

    def chaos():
        crng = np.random.default_rng(13)
        while not stop.wait(1.0):
            s = int(crng.integers(0, router.cfg.n_shards))
            r = int(crng.integers(0, router.cfg.n_replicas))
            handle = router.replicas[s][r]
            if handle is not None and handle.alive:
                print(f"chaos: killing shard {s} replica {r}")
                handle.kill()

    threads = [threading.Thread(target=worker, args=(c,))
               for c in range(args.clients)]
    aux = [threading.Thread(target=publisher, daemon=True)]
    if args.chaos:
        aux.append(threading.Thread(target=chaos, daemon=True))
    for t in threads + aux:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    for t in aux:
        t.join()

    m = router.metrics
    if lat:
        line = (f"p50={np.percentile(lat, 50):.2f}ms "
                f"p99={np.percentile(lat, 99):.2f}ms")
    else:
        line = "no requests served"
    print(f"fabric: {args.clients} clients x {args.requests} requests, "
          f"{line} errors={errors[0]}")
    print(f"  metrics: queries={m.queries} sub={m.sub_queries} "
          f"updates={m.updates} retries={m.version_retries} "
          f"failovers={m.failovers} respawns={m.respawns} "
          f"mixed_averted={m.mixed_version_averted}")
    if m.mixed_version_averted:
        print("  WARNING: merge saw mixed versions (averted, but a bug)")
        return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small tables, few requests (CI-sized)")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--n-keys", type=int, default=20000)
    ap.add_argument("--value-bytes", type=int, default=32)
    ap.add_argument("--variant", default="neighborhash")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--batch-keys", type=int, default=512)
    ap.add_argument("--chaos", action="store_true",
                    help="kill a random replica every second while serving")
    ap.add_argument("--snapshot-root", default=None,
                    help="snapshot directory (default: a temp dir)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics on this port while "
                         "driving (0 = ephemeral; the bound URL is printed)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="fraction of queries to trace end-to-end [0,1]")
    ap.add_argument("--record", default=None,
                    help="write a BENCH-style JSON record (counters + "
                         "metrics snapshot) to this path on exit")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n_keys = min(args.n_keys, 8000)
        args.requests = min(args.requests, 15)

    own_tmp = args.snapshot_root is None
    root = args.snapshot_root or tempfile.mkdtemp(prefix="fabric-snap-")
    t_start = time.time()
    router = build_router(args, root)
    registry = Registry()
    bridge_router(registry, router)
    metrics_srv = None
    if args.metrics_port is not None:
        metrics_srv = MetricsServer(registry,
                                    port=args.metrics_port).start()
        print(f"metrics: serving {metrics_srv.url}", flush=True)
    try:
        rc = drive(args, router)
        if args.record:
            record = {
                "alias": "fabric_chaos" if args.chaos else "fabric_smoke",
                "unix_time": int(t_start),
                "duration_s": round(time.time() - t_start, 3),
                "ok": rc == 0,
                "shards": args.shards, "replicas": args.replicas,
                "metrics": snapshot(registry),
            }
            with open(args.record, "w") as f:
                json.dump(record, f, indent=1)
            print(f"record: wrote {args.record}", flush=True)
    finally:
        if metrics_srv is not None:
            metrics_srv.close()
        router.close()
        if own_tmp:
            import shutil
            shutil.rmtree(root, ignore_errors=True)
    raise SystemExit(rc)


if __name__ == "__main__":
    main()
