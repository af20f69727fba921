"""Multi-process serving fabric: router over shard-server processes.

``ClusterSim`` (core/cluster_sim.py) models the paper's fleet as threads in
one process; this module is the graduation to real processes — the
deployment shape Monolith's fault-tolerance story implies (periodic
parameter snapshots + fast replica respawn) over the repo's own storage:

  - **shard-server process** — ``_shard_server_main``: restores a
    ``StoreBackend`` from an on-disk snapshot (``HybridKVStore.load``,
    bitwise) and serves it through a full ``QueryServer`` (QoS lanes,
    micro-batching) behind the framed wire protocol (api/wire.py).  The
    import path is deliberately torch-free (numpy and the standard
    library), so a replica boots in fractions of a second and no CUDA
    state ever reaches a child process.
  - **replica groups** — each shard runs ``n_replicas`` identical
    processes restored from the same snapshot; queries round-robin across
    the live ones, updates fan to all of them.
  - **router** — partitions each ``QueryRequest``'s keys by the shared
    hash (``hashcore.hash64``), fans sub-queries out pinned to ONE fleet
    version, merges sub-responses, and re-resolves + retries on a version
    NACK — the one-pinned-version-per-batch rule holds across process
    boundaries: no batch is ever answered from mixed versions.
  - **failover + respawn** — a dead replica's in-flight sub-queries fail
    over to a surviving replica of the same group; the health checker
    respawns the dead process from the latest snapshot and replays the
    update log past it, so the rejoined replica serves the current
    version.  In-flight client requests are never lost: they either
    complete from a survivor or fail with a typed ``FabricError``.

Transport is ``multiprocessing.Pipe`` with the spawn start method (fork
would duplicate CUDA and thread state into children); message payloads are
the pickle-free codec in api/wire.py.  Under spawn every child first
re-runs its parent's ``__main__`` file, so drive a ``Router`` from a
``__main__`` that imports no torch (``python -m repro_torch.launch.fabric``,
or ``python -c``, which has no file to re-run) — or every shard pays the
torch import.

The JAX package's ``serve/fabric.py`` with the same names, wire frames,
snapshots and counters: the two routers answer a script alike, bitwise.
"""
from __future__ import annotations

import dataclasses
import itertools
import multiprocessing
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Optional, Sequence

import numpy as np

from repro_torch.api import wire
from repro_torch.api.backends import StoreBackend
from repro_torch.api.types import (Consistency, QoSClass, QueryRequest,
                                   QueryResponse, UpdateRequest)
from repro_torch.core.hybrid_store import HybridKVStore
from repro_torch.core.query_types import (EmbeddingTable, QueryResult,
                                          TableResult, VersionEvictedError)
from repro_torch.obs.trace import Span, Tracer, new_id

__all__ = ["FabricConfig", "FabricCounts", "FabricError", "FabricMetrics",
           "NoReplicaError", "ReplicaDeadError", "ReplicaHandle", "Router",
           "shard_of_keys"]


class FabricError(RuntimeError):
    """Base class for fabric serving failures (always typed, never a hang:
    a client request either completes or raises one of these)."""


class ReplicaDeadError(FabricError):
    """The shard process died (or its pipe broke) with work outstanding."""


class NoReplicaError(FabricError):
    """A shard's whole replica group is down — nothing left to fail over
    to (the respawner may still bring one back; retry later)."""


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    n_shards: int = 2
    n_replicas: int = 2               # replica group size per shard
    snapshot_root: str = ""           # required: where snapshots live
    health_period_s: float = 0.25     # health-check / respawn cadence
    snapshot_every: int = 8           # updates between periodic snapshots
    call_timeout_s: float = 30.0      # per-RPC budget (query/update/health)
    spawn_timeout_s: float = 60.0     # replica boot-to-ready budget
    respawn: bool = True              # health checker respawns dead replicas
    version_retries: int = 8          # NACK -> re-resolve attempts per query
    server_workers: int = 2           # QueryServer finish workers per shard
    max_wait_s: float = 0.0           # shard-side micro-batch close rule
    trace_sample_rate: float = 0.0    # fraction of queries traced end-to-end

    def __post_init__(self):
        if self.n_shards < 1 or self.n_replicas < 1:
            raise ValueError("n_shards and n_replicas must be >= 1")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(f"trace_sample_rate must be in [0, 1], got "
                             f"{self.trace_sample_rate}")
        if not self.snapshot_root:
            raise ValueError("snapshot_root is required (snapshots are the "
                             "respawn substrate, not an optional extra)")


@dataclasses.dataclass
class FabricCounts:
    """The router's counter set — a plain record so ``snapshot()`` can
    hand out consistent copies and the metrics bridge (obs/bridge.py) can
    enumerate the fields."""
    queries: int = 0
    sub_queries: int = 0
    updates: int = 0
    consistent_batches: int = 0       # merged under one version
    mixed_version_averted: int = 0    # merge saw >1 version -> retried
    version_retries: int = 0          # pinned sub-query NACK -> re-resolve
    failovers: int = 0                # sub-query moved to a survivor
    replica_failures: int = 0         # processes observed dead
    respawns: int = 0
    snapshots: int = 0


class FabricMetrics:
    """Thread-safe fabric counters.  The old dataclass was bumped bare
    (``metrics.queries += 1``) from client threads, the health checker,
    and finish workers at once — increments raced and lost.  Writes now go
    through ``inc`` under a lock; reads keep working attribute-style
    (``router.metrics.respawns``) via ``__getattr__``, each one a locked
    point read of the live counts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c = FabricCounts()      # guarded-by: _lock (strict)

    def inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self._c, field, getattr(self._c, field) + n)

    def snapshot(self) -> FabricCounts:
        with self._lock:
            return dataclasses.replace(self._c)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        with self._lock:
            return getattr(self._c, name)


# the repo-wide mix hash (hashcore's numpy flavour), restated here so the
# partition rule every snapshot and respawn depends on reads in one place,
# with nothing but numpy under it.  test_torch_fabric.py asserts
# bit-identity against hashcore.hash64_np and the JAX package's router.
_C1, _C2, _SEED = np.uint32(0x85EBCA6B), np.uint32(0xC2B2AE35), \
    np.uint32(0x9E3779B9)


def _mix32(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32, copy=True)
    h ^= h >> np.uint32(16)
    h *= _C1
    h ^= h >> np.uint32(13)
    h *= _C2
    h ^= h >> np.uint32(16)
    return h


def shard_of_keys(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Owning shard per key — the same mix hash the tables themselves use
    (and the same routing as ``ClusterSim``), so the partition is stable
    across processes and restarts."""
    keys = np.asarray(keys, dtype=np.uint64).ravel()
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = keys.astype(np.uint32)
    h = _mix32(_mix32(lo ^ _SEED) ^ hi)
    return (h % np.uint32(n_shards)).astype(np.int32)


# ---------------------------------------------------------------------------
# shard-server child process
# ---------------------------------------------------------------------------
def _shard_server_main(conn, shard_id: int, replica_id: int,
                       snapshot_dir: str, options: dict) -> None:
    """Entry point of one shard-server process (spawn target; must stay
    top-level picklable).  Protocol: restore backend from snapshot, send
    the ready frame (request id 0), then serve frames until SHUTDOWN or
    pipe EOF (parent death).  Every request is answered — a response, a
    typed error, or process death the parent's reader detects."""
    from repro_torch.serve.scheduler import BatchPolicy
    from repro_torch.serve.server import QueryServer

    send_lock = threading.Lock()

    def send(kind: int, rid: int, payload: bytes) -> None:
        with send_lock:
            try:
                conn.send_bytes(wire.pack_frame(kind, rid, payload))
            except (OSError, ValueError, BrokenPipeError):
                pass                  # parent gone; recv loop exits on EOF

    try:
        backend = StoreBackend.load_snapshot(snapshot_dir)
    except BaseException as e:  # noqa: BLE001
        send(wire.KIND_ERROR, 0, wire.encode_error(e))
        return
    # sample_rate 0: the shard never ORIGINATES traces, but requests that
    # arrive carrying a trace context (sampled at the router edge) are
    # recorded, and their spans ride back on the wire response
    tracer = Tracer(sample_rate=0.0,
                    proc=f"shard{shard_id}/r{replica_id}")
    server = QueryServer(
        backend,
        BatchPolicy(max_wait_s=float(options.get("max_wait_s", 0.0))),
        workers=int(options.get("server_workers", 2)),
        tracer=tracer)
    pool = ThreadPoolExecutor(max_workers=4,
                              thread_name_prefix=f"reply-s{shard_id}")
    send(wire.KIND_OK, 0, wire.encode_tree(
        {"shard": shard_id, "replica": replica_id,
         "version": backend.latest_version}))

    running = True
    while running:
        try:
            data = conn.recv_bytes()
        except (EOFError, OSError):
            break
        try:
            kind, rid, payload = wire.unpack_frame(data)
        except wire.WireError:
            continue
        if kind == wire.KIND_QUERY:
            try:
                ticket = server.submit(wire.decode_request(payload))
            except BaseException as e:  # noqa: BLE001
                send(wire.KIND_ERROR, rid, wire.encode_error(e))
                continue

            def reply(rid=rid, ticket=ticket):
                try:
                    res = ticket.result(timeout=60.0)
                except BaseException as e:  # noqa: BLE001
                    send(wire.KIND_ERROR, rid, wire.encode_error(e))
                else:
                    send(wire.KIND_RESPONSE, rid, wire.encode_response(res))

            pool.submit(reply)
        elif kind == wire.KIND_UPDATE:
            try:
                version, upserts, deletes = wire.decode_update(payload)
                if upserts or deletes:
                    backend.apply_update(UpdateRequest(
                        version=version, upserts=upserts, deletes=deletes))
                else:
                    # this shard's partition of the fleet delta is empty:
                    # adopt the fleet version anyway (membership/epoch
                    # semantics) or pinned sub-queries here NACK forever
                    backend.bump_version(version)
                send(wire.KIND_OK, rid, wire.encode_tree(
                    {"version": backend.latest_version}))
            except BaseException as e:  # noqa: BLE001
                send(wire.KIND_ERROR, rid, wire.encode_error(e))
        elif kind == wire.KIND_HEALTH:
            send(wire.KIND_OK, rid, wire.encode_tree(
                {"version": backend.latest_version,
                 "tables": backend.table_names}))
        elif kind == wire.KIND_STATS:
            # observability scrape: this replica's stat silos as one tree
            # (serving counters/percentiles + per-table tier counters)
            try:
                send(wire.KIND_OK, rid, wire.encode_stats({
                    "shard": shard_id, "replica": replica_id,
                    "version": backend.latest_version,
                    "server": dataclasses.asdict(server.stats_snapshot()),
                    "tiers": backend.tier_stats()}))
            except BaseException as e:  # noqa: BLE001
                send(wire.KIND_ERROR, rid, wire.encode_error(e))
        elif kind == wire.KIND_SNAPSHOT:
            try:
                target = wire.decode_tree(payload)["dir"]
                v = backend.snapshot_to(target)
                send(wire.KIND_OK, rid,
                     wire.encode_tree({"dir": target, "version": v}))
            except BaseException as e:  # noqa: BLE001
                send(wire.KIND_ERROR, rid, wire.encode_error(e))
        elif kind == wire.KIND_SHUTDOWN:
            send(wire.KIND_OK, rid, wire.encode_tree({}))
            running = False
        else:
            send(wire.KIND_ERROR, rid, wire.encode_error(
                ValueError(f"unknown frame kind {kind}")))
    # drain in-flight replies while the server still serves them, THEN
    # close the server (its close() fails anything the drain left behind)
    pool.shutdown(wait=True)
    server.close(timeout=5.0)
    try:
        conn.close()
    except OSError:                                # pragma: no cover
        pass


# ---------------------------------------------------------------------------
# parent-side replica handle: one process + multiplexed RPC
# ---------------------------------------------------------------------------
class ReplicaHandle:
    """One shard-server process as seen by the router: a pipe, a reader
    thread demultiplexing responses to per-request futures, and a liveness
    flag.  Death (EOF, broken pipe, failed send) fails every pending
    future with ``ReplicaDeadError`` — callers fail over, nothing hangs."""

    def __init__(self, process, conn, shard_id: int, replica_id: int):
        self.process = process
        self.conn = conn
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.alive = True               # guarded-by: _plock
        # strict: _mark_dead clears the dict while failing the futures,
        # so even a point lookup must serialize with the sweep
        self._pending: dict[int, Future] = {}  # guarded-by: _plock (strict)
        self._plock = threading.Lock()
        self._send_lock = threading.Lock()
        self._ids = itertools.count(1)
        # the ready frame arrives as request id 0
        self.ready: Future = Future()
        self._pending[0] = self.ready
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"fabric-read-s{shard_id}r{replica_id}")
        self._reader.start()

    @classmethod
    def spawn(cls, ctx, shard_id: int, replica_id: int, snapshot_dir: str,
              cfg: FabricConfig) -> "ReplicaHandle":
        """Start a shard-server from a snapshot and wait for its ready
        frame (which proves the snapshot restored and the server is
        accepting)."""
        parent_conn, child_conn = ctx.Pipe()
        options = {"max_wait_s": cfg.max_wait_s,
                   "server_workers": cfg.server_workers}
        process = ctx.Process(
            target=_shard_server_main,
            args=(child_conn, shard_id, replica_id, snapshot_dir, options),
            daemon=True, name=f"fabric-s{shard_id}r{replica_id}")
        process.start()
        child_conn.close()
        handle = cls(process, parent_conn, shard_id, replica_id)
        try:
            kind, payload = handle.ready.result(cfg.spawn_timeout_s)
        except FutureTimeoutError:
            handle.destroy()
            raise FabricError(
                f"shard {shard_id} replica {replica_id} did not become "
                f"ready within {cfg.spawn_timeout_s}s")
        except BaseException:
            handle.destroy()
            raise
        return handle

    # -- RPC -----------------------------------------------------------
    def submit(self, kind: int, payload: bytes) -> Future:
        if not self.alive:
            raise ReplicaDeadError(
                f"shard {self.shard_id} replica {self.replica_id} is dead")
        rid = next(self._ids)
        fut: Future = Future()
        with self._plock:
            if not self.alive:
                raise ReplicaDeadError(
                    f"shard {self.shard_id} replica {self.replica_id} "
                    f"is dead")
            self._pending[rid] = fut
        try:
            with self._send_lock:
                self.conn.send_bytes(wire.pack_frame(kind, rid, payload))
        except (OSError, ValueError, BrokenPipeError):
            self._mark_dead()
            raise ReplicaDeadError(
                f"shard {self.shard_id} replica {self.replica_id} died "
                f"on send")
        return fut

    def call(self, kind: int, payload: bytes,
             timeout: Optional[float] = None) -> tuple[int, bytes]:
        """Round trip; raises the decoded typed error on a KIND_ERROR
        response and ``ReplicaDeadError``/``FabricError`` on death or
        timeout."""
        fut = self.submit(kind, payload)
        try:
            return fut.result(timeout)
        except FutureTimeoutError:
            raise FabricError(
                f"shard {self.shard_id} replica {self.replica_id} did not "
                f"answer within {timeout}s")

    # -- lifecycle -----------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                data = self.conn.recv_bytes()
                kind, rid, payload = wire.unpack_frame(data)
                with self._plock:
                    fut = self._pending.pop(rid, None)
                if fut is None:
                    continue
                if kind == wire.KIND_ERROR:
                    fut.set_exception(wire.decode_error(payload))
                else:
                    fut.set_result((kind, bytes(payload)))
        except (EOFError, OSError, wire.WireError):
            pass
        finally:
            self._mark_dead()

    def _mark_dead(self) -> None:
        with self._plock:
            self.alive = False
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(ReplicaDeadError(
                    f"shard {self.shard_id} replica {self.replica_id} died "
                    f"with the request in flight"))

    def kill(self) -> None:
        """Hard-kill the process (the failure-injection face tests use)."""
        self.process.terminate()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Graceful stop: SHUTDOWN frame, join, then escalate."""
        if self.alive:
            try:
                self.call(wire.KIND_SHUTDOWN, wire.encode_tree({}),
                          timeout=timeout)
            except (FabricError, ReplicaDeadError):
                pass
        self.destroy(join_timeout=timeout)

    def destroy(self, join_timeout: float = 5.0) -> None:
        self.process.join(join_timeout)
        if self.process.is_alive():
            self.process.terminate()
            self.process.join(1.0)
        self._mark_dead()
        try:
            self.conn.close()
        except OSError:                            # pragma: no cover
            pass


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
class Router:
    """Fan-out / merge / failover over shard replica groups.

    Build one with ``Router.build(embeddings, cfg)`` — it partitions the
    tables by key hash, snapshots each shard's ``StoreBackend`` to disk,
    and spawns ``n_shards * n_replicas`` shard-server processes from those
    snapshots (the same path a respawn takes: bootstrap IS restore).

    The consistency contract mirrors ``StoreBackend`` fleet-wide: the
    fleet retains one version; every sub-query is pinned strict to the
    fleet version resolved at dispatch, so a racing fleet update NACKs
    the sub-query (typed ``VersionEvictedError``) and the router
    re-resolves + retries — a merged response is always single-version.
    """

    def __init__(self, cfg: FabricConfig, table_names: Sequence[str],
                 snapshots: Sequence[tuple[str, int]], version: int):
        self.cfg = cfg
        self._table_names = sorted(table_names)
        self._ctx = multiprocessing.get_context("spawn")
        # non-strict: query_ex pins the version with one benign racy
        # read (an update landing mid-read just means the batch pins
        # the pre-update version, which stays servable)
        self._fleet_version = int(version)  # guarded-by: _update_lock
        # (dir, version) of each shard's latest snapshot — the respawn
        # substrate; updated by snapshot_now()
        # guarded-by: _update_lock (strict)
        self._snapshots: list[tuple[str, int]] = list(snapshots)
        # update log PAST the snapshots: (version, per-shard payloads);
        # a respawned replica restores the snapshot then replays these
        # guarded-by: _update_lock (strict)
        self._update_log: list[tuple[int, list[bytes]]] = []
        self._updates_since_snapshot = 0  # guarded-by: _update_lock (strict)
        # serializes updates, snapshots, and respawn catch-up: a replica
        # must never join mid-update or replay a half-logged delta
        self._update_lock = threading.RLock()
        self.metrics = FabricMetrics()
        # edge tracer: query_ex samples here, shard children record under
        # the propagated context, and the merged cross-process timeline
        # lands back in this tracer (and on the response)
        self.tracer = Tracer(sample_rate=cfg.trace_sample_rate,
                             proc="router")
        self._rr = [itertools.count() for _ in range(cfg.n_shards)]
        # non-strict: the query fan-out reads handles lock-free; a
        # respawn swapping a handle mid-read at worst routes one call
        # to the dying replica, which fails typed and is retried
        self.replicas: list[list[Optional[ReplicaHandle]]] = []  # guarded-by: _update_lock
        try:
            for s in range(cfg.n_shards):
                group = [ReplicaHandle.spawn(self._ctx, s, r,
                                             self._snapshots[s][0], cfg)
                         for r in range(cfg.n_replicas)]
                self.replicas.append(group)
        except BaseException:
            self.close()
            raise
        self._health_stop = threading.Event()
        # serializes health-checker start/stop (same check-then-act
        # race class as QueryServer.start: two concurrent starts used
        # to be able to spawn two health loops)
        self._health_lock = threading.Lock()
        # guarded-by: _health_lock (strict)
        self._health_thread: Optional[threading.Thread] = None
        self._closed = False
        if cfg.respawn:
            self.start_health_checker()

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, embeddings: Sequence[EmbeddingTable],
              cfg: FabricConfig, *, version: int = 1) -> "Router":
        """Partition + snapshot + spawn.  Each table's keys are routed by
        ``shard_of_keys``; each shard's partition becomes a
        ``HybridKVStore`` inside a ``StoreBackend`` snapshotted to
        ``<snapshot_root>/shard<k>/v<version>`` — then the builder stores
        are closed and every replica boots from disk, proving at
        construction time the restore path a failure will later rely on."""
        if not embeddings:
            raise ValueError("need at least one table")
        names = [t.name for t in embeddings]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate table names in {names}")
        os.makedirs(cfg.snapshot_root, exist_ok=True)
        owners = {t.name: shard_of_keys(t.keys, cfg.n_shards)
                  for t in embeddings}
        snapshots = []
        for s in range(cfg.n_shards):
            stores = {}
            for t in embeddings:
                mask = owners[t.name] == s
                if not mask.any():
                    raise ValueError(
                        f"table {t.name!r} routed no keys to shard {s}; "
                        f"use fewer shards or more keys")
                keys = np.asarray(t.keys, dtype=np.uint64)[mask]
                values = np.asarray(t.values)[mask]
                stores[t.name] = HybridKVStore(
                    keys, values, hot_fraction=t.hot_fraction,
                    variant=t.variant)
            backend = StoreBackend(stores, version=version)
            path = os.path.join(cfg.snapshot_root, f"shard{s}",
                                f"v{version}")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            backend.snapshot_to(path)
            for store in stores.values():
                store.close()
            snapshots.append((path, version))
        return cls(cfg, names, snapshots, version)

    # -- protocol faces --------------------------------------------------
    @property
    def fleet_version(self) -> int:
        return self._fleet_version

    @property
    def table_names(self) -> list[str]:
        return list(self._table_names)

    def query(self, request: QueryRequest) -> QueryResponse:
        return self.query_ex(request)[0]

    def query_ex(self, request: QueryRequest
                 ) -> tuple[QueryResponse, dict]:
        """Fan out one request, merge one single-version response; returns
        ``(response, {"keys_deviceside", "launches"})`` for the backend's
        coalesce stats.  Raises only typed errors: consistency NACKs
        (``VersionEvictedError``/``ConsistencyError``), shard-side shed
        errors, or ``FabricError`` when retries/replicas are exhausted."""
        if self._closed:
            raise FabricError("router is closed")
        t0 = time.monotonic()
        # dedup + partition once; the retry loop redispatches the same
        # sub-requests under a re-resolved version
        parts = {}                    # name -> (uniq, inverse, owners)
        sub_tables: dict[int, dict[str, np.ndarray]] = {}
        deviceside = 0
        for name, keys in request.tables.items():
            uniq, inverse = np.unique(keys, return_inverse=True)
            owner = shard_of_keys(uniq, self.cfg.n_shards)
            parts[name] = (uniq, inverse, owner)
            deviceside += len(uniq)
            for s in np.unique(owner):
                sub_tables.setdefault(int(s), {})[name] = uniq[owner == s]
        info = {"keys_deviceside": deviceside, "launches": len(sub_tables)}
        self.metrics.inc("queries")

        # edge sampling: an incoming context propagates; otherwise the
        # router's tracer decides.  Sub-queries carry the context with the
        # route span as parent, so shard-side timelines merge under it.
        tctx = request.trace
        if tctx is None:
            tid = self.tracer.sample()
            if tid is not None:
                tctx = {"trace_id": tid}
        route_sid = new_id() if tctx is not None else None
        sub_trace = None if tctx is None else \
            {"trace_id": tctx["trace_id"], "parent_id": route_sid}

        last_error: Optional[BaseException] = None
        for attempt in range(self.cfg.version_retries):
            if attempt:
                self.metrics.inc("version_retries")
                time.sleep(0.001 * attempt)       # let the update settle
            v = self._fleet_version
            if request.consistency.mode == "pinned" \
                    and request.consistency.version != v:
                raise VersionEvictedError(
                    f"version {request.consistency.version} not retained; "
                    f"the fleet serves only [{v}]")
            try:
                responses, rpc_spans = self._fan_out(
                    sub_tables, v, request.qos, trace=sub_trace)
            except VersionEvictedError as e:
                last_error = e        # stale pin: re-resolve and retry
                continue
            versions = {r.version for r in responses.values()}
            if len(versions) > 1:                  # pragma: no cover
                # strict pins make this unreachable; belt + braces so a
                # future bug turns into a retry, never a mixed answer
                self.metrics.inc("mixed_version_averted")
                last_error = FabricError(
                    f"sub-responses spanned versions {sorted(versions)}")
                continue
            served = versions.pop() if versions else v
            request.consistency.check(served)     # min_version post-check
            self.metrics.inc("consistent_batches")
            merged = self._merge(parts, responses, served)
            trace_wire = None
            if tctx is not None:
                trace_wire = self._merge_trace(
                    tctx, route_sid, t0, rpc_spans, responses, served,
                    attempt)
            return (QueryResponse.from_result(
                merged, qos=request.qos,
                latency_s=time.monotonic() - t0,
                trace=trace_wire), info)
        raise FabricError(
            f"query failed after {self.cfg.version_retries} attempts"
            ) from last_error

    def _merge_trace(self, tctx: dict, route_sid: str, t0: float,
                     rpc_spans: list, responses: dict, version: int,
                     attempt: int) -> list:
        """One cross-process timeline: the router's ``route`` root + its
        per-shard ``shard_rpc`` spans + every span the shard servers
        recorded (admission ... scatter, stamped on the shared
        CLOCK_MONOTONIC timebase).  Recorded in the router tracer and
        returned as wire dicts on the response."""
        tid = tctx["trace_id"]
        spans = [Span(tid, "route", t0, time.monotonic(),
                      parent_id=tctx.get("parent_id"), span_id=route_sid,
                      proc=self.tracer.proc,
                      tags={"version": version, "attempts": attempt + 1,
                            "shards": sorted(responses)})]
        spans.extend(rpc_spans)
        for res in responses.values():
            if res.trace:
                spans.extend(Span.from_wire(d) for d in res.trace)
        self.tracer.record(spans)
        return [s.to_wire() for s in spans]

    def _fan_out(self, sub_tables: dict, version: int, qos: QoSClass,
                 trace: Optional[dict] = None) -> tuple[dict, list]:
        """Dispatch every shard's sub-query pinned strict to ``version``,
        with per-shard failover to surviving replicas; returns
        ``({shard: QueryResult}, [shard_rpc Span, ...])`` (the span list
        is empty for untraced queries)."""
        payloads = {}
        for s, tables in sub_tables.items():
            payloads[s] = wire.encode_request(QueryRequest(
                tables=tables, qos=qos,
                consistency=Consistency.pinned(version),
                trace=trace))
        t_dispatch = time.monotonic()
        futures = {}
        for s, payload in payloads.items():
            futures[s] = self._submit_shard(s, payload)
            self.metrics.inc("sub_queries")
        responses = {}
        rpc_spans: list = []
        first_error: Optional[BaseException] = None
        for s, fut in futures.items():
            payload = payloads[s]
            while True:
                try:
                    _, data = fut.result(self.cfg.call_timeout_s)
                    responses[s] = wire.decode_response(data)
                    if trace is not None:
                        rpc_spans.append(Span(
                            trace["trace_id"], "shard_rpc", t_dispatch,
                            time.monotonic(),
                            parent_id=trace.get("parent_id"),
                            proc=self.tracer.proc, tags={"shard": s}))
                    break
                except FutureTimeoutError:
                    first_error = first_error or FabricError(
                        f"shard {s} did not answer within "
                        f"{self.cfg.call_timeout_s}s")
                    break
                except ReplicaDeadError:
                    # the replica died mid-flight: the request is NOT
                    # lost — re-dispatch the identical pinned sub-query
                    # to a survivor (NoReplicaError if none remain)
                    self.metrics.inc("failovers")
                    try:
                        fut = self._submit_shard(s, payload)
                        self.metrics.inc("sub_queries")
                    except NoReplicaError as e:
                        first_error = first_error or e
                        break
                except VersionEvictedError:
                    raise                  # caller re-resolves + retries
                except BaseException as e:  # noqa: BLE001
                    first_error = first_error or e
                    break
        if first_error is not None:
            raise first_error
        return responses, rpc_spans

    def _submit_shard(self, shard: int, payload: bytes) -> Future:
        group = self.replicas[shard]
        for _ in range(len(group)):
            handle = group[next(self._rr[shard]) % len(group)]
            if handle is None or not handle.alive:
                continue
            try:
                return handle.submit(wire.KIND_QUERY, payload)
            except ReplicaDeadError:
                self.metrics.inc("replica_failures")
                continue
        raise NoReplicaError(f"shard {shard} has no live replica")

    def _merge(self, parts: dict, responses: dict,
               version: int) -> QueryResult:
        """Stitch per-shard unique-key results back to request order."""
        tables = {}
        for name, (uniq, inverse, owner) in parts.items():
            found_u = np.zeros(len(uniq), dtype=bool)
            values_u: Optional[np.ndarray] = None
            for s, res in responses.items():
                if name not in res.tables:
                    continue
                tr = res.tables[name]
                pos = np.flatnonzero(owner == s)
                found_u[pos] = tr.found
                if tr.values is not None:
                    if values_u is None:
                        values_u = np.zeros(
                            (len(uniq), tr.values.shape[1]), dtype=np.uint8)
                    values_u[pos] = tr.values
            if values_u is None:
                values_u = np.zeros((len(uniq), 0), dtype=np.uint8)
            tables[name] = TableResult(found=found_u[inverse],
                                       values=values_u[inverse])
        return QueryResult(version=version, tables=tables)

    # -- updates ---------------------------------------------------------
    def apply_update(self, update: UpdateRequest) -> None:
        """Partition a fleet delta by shard and fan it to EVERY live
        replica; the fleet version advances once all live replicas acked
        (dead ones catch up from the log at respawn).  Shards whose
        partition is empty get a bare version bump — every shard serves
        the new fleet version, or pinned sub-queries would NACK forever."""
        if not update.is_delta:
            raise ValueError("the fabric's stores mutate in place; only "
                             "delta updates (upserts/deletes) apply")
        for name in set(update.upserts) | set(update.deletes):
            if name not in self._table_names:
                raise KeyError(f"unknown table {name!r}; fleet serves "
                               f"{self._table_names}")
        with self._update_lock:
            if update.version <= self._fleet_version:
                raise ValueError(
                    f"update version {update.version} must exceed the "
                    f"fleet version {self._fleet_version}")
            payloads = self._partition_update(update)
            # log BEFORE sending: a replica that dies mid-send respawns
            # from snapshot + log and must find this delta there
            self._update_log.append((update.version, payloads))
            acks = []
            for s, group in enumerate(self.replicas):
                for handle in group:
                    if handle is None or not handle.alive:
                        continue
                    try:
                        acks.append(
                            (s, handle,
                             handle.submit(wire.KIND_UPDATE, payloads[s])))
                    except ReplicaDeadError:
                        self.metrics.inc("replica_failures")
            acked_shards = set()
            for s, handle, fut in acks:
                try:
                    fut.result(self.cfg.call_timeout_s)
                    acked_shards.add(s)
                except (ReplicaDeadError, FutureTimeoutError):
                    self.metrics.inc("replica_failures")
                # a typed application error (bad rows) re-raises: the
                # update was validated identically everywhere, so one
                # replica failing it means they all would
            if acked_shards != set(range(self.cfg.n_shards)):
                missing = sorted(set(range(self.cfg.n_shards))
                                 - acked_shards)
                raise FabricError(
                    f"update {update.version} not acked by any replica of "
                    f"shards {missing}; fleet version stays "
                    f"{self._fleet_version}")
            self._fleet_version = update.version
            self.metrics.inc("updates")
            self._updates_since_snapshot += 1
            due = self._updates_since_snapshot >= self.cfg.snapshot_every
        if due:
            self.snapshot_now()

    def _partition_update(self, update: UpdateRequest) -> list[bytes]:
        per_up: list[dict] = [{} for _ in range(self.cfg.n_shards)]
        per_del: list[dict] = [{} for _ in range(self.cfg.n_shards)]
        for name, (keys, rows) in update.upserts.items():
            keys = np.asarray(keys, dtype=np.uint64).ravel()
            rows = np.asarray(rows)
            owner = shard_of_keys(keys, self.cfg.n_shards)
            for s in np.unique(owner):
                mask = owner == s
                per_up[int(s)][name] = (keys[mask], rows[mask])
        for name, keys in update.deletes.items():
            keys = np.asarray(keys, dtype=np.uint64).ravel()
            owner = shard_of_keys(keys, self.cfg.n_shards)
            for s in np.unique(owner):
                per_del[int(s)][name] = keys[owner == s]
        return [wire.encode_update(update.version, per_up[s], per_del[s])
                for s in range(self.cfg.n_shards)]

    # -- snapshots + respawn ---------------------------------------------
    def snapshot_now(self) -> None:
        """Ask one live replica per shard to snapshot, record the new
        generation, truncate the replayed log, and drop the superseded
        snapshot dirs."""
        import shutil
        with self._update_lock:
            v = self._fleet_version
            old = []
            for s in range(self.cfg.n_shards):
                path = os.path.join(self.cfg.snapshot_root, f"shard{s}",
                                    f"v{v}")
                handle = self._any_alive(s)
                if handle is None:
                    continue          # shard fully down; keep old snapshot
                try:
                    handle.call(wire.KIND_SNAPSHOT,
                                wire.encode_tree({"dir": path}),
                                timeout=self.cfg.call_timeout_s)
                except (FabricError, ReplicaDeadError):
                    continue
                if self._snapshots[s][0] != path:
                    old.append(self._snapshots[s][0])
                self._snapshots[s] = (path, v)
            floor = min(sv for _, sv in self._snapshots)
            self._update_log = [e for e in self._update_log if e[0] > floor]
            self._updates_since_snapshot = 0
            self.metrics.inc("snapshots")
        for path in old:
            shutil.rmtree(path, ignore_errors=True)

    def _any_alive(self, shard: int) -> Optional[ReplicaHandle]:
        for handle in self.replicas[shard]:
            if handle is not None and handle.alive:
                return handle
        return None

    # -- observability ----------------------------------------------------
    def collect_shard_stats(self, timeout_s: float = 5.0) -> dict:
        """Scrape every live replica's stat silos over KIND_STATS:
        ``{"shard<k>/r<j>": {"server": ..., "tiers": ..., ...}}``.  Dead
        or unresponsive replicas are simply absent — a scrape must degrade,
        never raise, mid-failover (the metrics endpoint calls this)."""
        out: dict[str, dict] = {}
        ping = wire.encode_stats({})
        for s, group in enumerate(self.replicas):
            for r, handle in enumerate(group):
                if handle is None or not handle.alive:
                    continue
                try:
                    _, data = handle.call(wire.KIND_STATS, ping,
                                          timeout=timeout_s)
                    out[f"shard{s}/r{r}"] = wire.decode_stats(data)
                except (FabricError, ReplicaDeadError):
                    continue
        return out

    def respawn(self, shard: int, replica: int) -> None:
        """Bring a dead replica back: boot from the shard's latest
        snapshot, replay the update log past it (all under the update
        lock, so no fleet delta lands mid-catch-up), then swap the handle
        live.  The health checker calls this; tests may too."""
        with self._update_lock:
            old = self.replicas[shard][replica]
            if old is not None and old.alive:
                return
            if old is not None:
                old.destroy(join_timeout=1.0)
            snap_dir, snap_v = self._snapshots[shard]
            handle = ReplicaHandle.spawn(self._ctx, shard, replica,
                                         snap_dir, self.cfg)
            try:
                for v, payloads in self._update_log:
                    if v <= snap_v:
                        continue
                    handle.call(wire.KIND_UPDATE, payloads[shard],
                                timeout=self.cfg.call_timeout_s)
            except BaseException:
                handle.destroy()
                raise
            self.replicas[shard][replica] = handle
            self.metrics.inc("respawns")

    # -- health ----------------------------------------------------------
    def start_health_checker(self) -> None:
        with self._health_lock:
            if self._health_thread is not None:
                return
            self._health_stop.clear()
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True, name="fabric-health")
            self._health_thread.start()

    def stop_health_checker(self) -> None:
        # join under the lock: the loop never takes _health_lock (respawn
        # uses _update_lock), and holding it through the join means a
        # concurrent start cannot interleave with a half-stopped loop and
        # resurrect the Event mid-shutdown
        with self._health_lock:
            if self._health_thread is None:
                return
            self._health_stop.set()
            self._health_thread.join()
            self._health_thread = None

    def _health_loop(self) -> None:
        ping = wire.encode_tree({})
        while not self._health_stop.wait(self.cfg.health_period_s):
            for s, group in enumerate(self.replicas):
                for r, handle in enumerate(group):
                    if self._health_stop.is_set():
                        return
                    if handle is None or not handle.alive:
                        self.metrics.inc("replica_failures")
                        if self.cfg.respawn:
                            try:
                                self.respawn(s, r)
                            except BaseException:  # noqa: BLE001
                                pass   # next tick retries
                        continue
                    try:
                        handle.call(wire.KIND_HEALTH, ping,
                                    timeout=self.cfg.call_timeout_s)
                    except (FabricError, ReplicaDeadError):
                        pass           # reader marked it; next tick respawns

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        if getattr(self, "_health_thread", None) is not None:
            self.stop_health_checker()
        for group in getattr(self, "replicas", []):
            for handle in group:
                if handle is not None:
                    handle.shutdown()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
