"""QueryServer — concurrent batch-query serving over any BatchQueryBackend.

The paper's headline is answering batch queries "within milliseconds" under
heavy concurrent traffic; a backend (api/backends.py — the fused
MultiTableEngine, standalone HybridKVStore tables, or a replica fleet)
supplies the version-pinned split-phase query, and this module
supplies the serving layer in front of it:

  - many concurrent clients submit typed ``QueryRequest``s (per-table key
    sets + QoS class + consistency + optional latency budget);
  - the scheduler (serve/scheduler.py) runs one admission lane per QoS
    class — weighted service, class-aware shedding (PREFETCH before
    RANKING), per-class ``BatchPolicy`` overrides — and coalesces each
    lane's stream into deadline-aware micro-batches;
  - each micro-batch pins exactly one backend version for its whole
    lifetime (``backend.begin`` resolves the build once), so concurrent
    ``publish``/``publish_delta`` calls can never produce a mixed-version
    batch, in any lane;
  - launch/finish are double-buffered: the single scheduler thread stages +
    launches batch i+1 while the worker pool blocks on batch i's results
    and scatters ``QueryResponse`` slices back to each request's ticket.

Example::

    server = QueryServer(engine, BatchPolicy(max_batch_keys=4096))
    client = FeatureClient(server)
    res = client.query({"item_attr": ids}, qos="RANKING", budget_s=0.050)
    print(server.stats_snapshot().summary())     # totals + per-class
    server.close()

On the card (the port's ``MultiTableEngine`` behind ``EngineBackend``): the
scheduler thread's ``begin`` enqueues each micro-batch's query copy, its
probe launches and its copy-back on the engine's own CUDA stream and
records an event there; a finish worker waits on that event alone, so the
next batch stages and launches meanwhile.  A batch's pinned build and its
pinned host buffers belong to that batch until its event has passed, so a
delta published mid-flight never reaches it.  ``close`` joins the
scheduler and the finish workers, so no thread of the server touches the
card after it returns.

A copy of the JAX package's ``serve/server.py``, with that join added.

``submit`` takes a ``QueryRequest`` only; callers go through
``FeatureClient``.  Shedding surfaces as typed errors (``QueueFullError``,
``DeadlineError``) from ``submit``/``Ticket.result``.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from repro_torch.api.backends import as_backend
from repro_torch.api.types import (ConsistencyError, QueryRequest, QueryResponse)
from repro_torch.obs.trace import Span, Tracer
from repro_torch.serve.scheduler import (BatchPolicy, MicroBatcher, ServerStats,
                                   ServerClosedError, StatsSnapshot, Ticket,
                                   _Pending, coalesce, scatter)


class QueryServer:
    """Admission + QoS-laned micro-batching + double-buffered execution in
    front of a ``BatchQueryBackend``.  Thread-safe: ``submit``/``query``
    may be called from any number of client threads; updates
    (``publish``/``publish_delta``/``apply_update``) may run concurrently
    from an updater thread."""

    def __init__(self, backend, policy: Optional[BatchPolicy] = None, *,
                 class_policies: Optional[dict] = None,
                 lane_weights: Optional[dict] = None,
                 workers: int = 2, pipeline_depth: int = 2,
                 tracer: Optional[Tracer] = None,
                 start: bool = True):
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        # optional request tracing (obs/trace.py): with no tracer the only
        # per-request cost is `is None` checks; with one, the tracer's
        # sample() decides which fresh requests get a span timeline, and
        # requests arriving with a trace context are always recorded
        self.tracer = tracer
        self.backend = as_backend(backend)
        # legacy face: engine-backed servers keep their .engine attribute
        self.engine = getattr(self.backend, "engine", None)
        self.policy = policy or BatchPolicy()
        self.stats = ServerStats(self.policy)
        # MicroBatcher validates class_policies / lane_weights (unknown QoS
        # names, non-BatchPolicy overrides, non-positive weights all raise
        # ValueError at construction)
        self._batcher = MicroBatcher(self.policy, self.stats,
                                     class_policies=class_policies,
                                     lane_weights=lane_weights)
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="qs-finish")
        # bounds batches between launch and finish: depth 2 is the classic
        # double buffer (one in flight on device, one being finished)
        self._inflight = threading.BoundedSemaphore(pipeline_depth)
        # batches between launch and ticket settlement, keyed by batch id
        # (one dict op per batch — this sits on the serial launch path):
        # close() waits these out under its timeout, then fails whatever
        # remains — a caller blocked in result() must never hang on a
        # server that shut down
        # plain dict, no lock: batch-id keyed stores/pops are atomic
        # under the GIL, and close()'s sweep tolerates racing pops (ticket
        # settlement is first-write-wins) — the launch path stays free of
        # lock traffic
        self._inflight_reqs: dict[int, list] = {}
        self._batch_ids = itertools.count()
        # serializes start()/close() thread management: an unguarded
        # check-then-act in start() let two concurrent callers each see
        # _scheduler=None and spawn two scheduler threads draining the
        # same lanes
        self._lifecycle_lock = threading.Lock()
        # guarded-by: _lifecycle_lock
        self._scheduler: Optional[threading.Thread] = None
        self._closed = False
        if start:
            self.start()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        with self._lifecycle_lock:
            if self._scheduler is not None:
                return
            self._scheduler = threading.Thread(
                target=self._run, name="qs-scheduler", daemon=True)
            self._scheduler.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain every lane, join the pipeline — all under
        one ``timeout`` budget.  Three places a request can be stranded,
        all handled:

          - queued but never batched (any lane): drained here and failed
            with ``ServerClosedError``;
          - launched but not finished: waited out under the remaining
            budget, then failed with ``ServerClosedError`` if the pool is
            wedged (settlement is first-write-wins, so a late finish that
            does land is simply ignored);
          - scheduler never started / join timed out: same drain + fail.

        No caller blocked in ``Ticket.result()`` is ever left hanging."""
        deadline = time.monotonic() + timeout
        self._closed = True
        self._batcher.close()
        # detach the thread handle under the lock, join outside it: a
        # concurrent start() must not block on our (bounded but long)
        # join, and a post-close start() spawns a scheduler that exits
        # immediately against the closed batcher
        with self._lifecycle_lock:
            scheduler, self._scheduler = self._scheduler, None
        if scheduler is not None:
            scheduler.join(max(deadline - time.monotonic(), 0.0))
        for req in self._batcher.drain():
            self.stats.on_failure(1, req.qos)
            req.ticket._fail(ServerClosedError("server closed before the "
                                               "request was served"))
        # the former shutdown(wait=True) ignored the timeout outright: a
        # backend wedged in finish() hung close() — and the caller —
        # forever.  Wait without blocking, bounded by what is left of the
        # budget, then fail the stragglers.
        self._pool.shutdown(wait=False)
        while self._inflight_reqs and time.monotonic() < deadline:
            time.sleep(0.002)
        leftovers = []
        while True:
            try:
                leftovers.extend(self._inflight_reqs.popitem()[1])
            except KeyError:
                break
        for req in leftovers:
            # first-write-wins: only count the failure if close actually
            # settled the ticket (a finish worker may have just beaten us)
            if req.ticket._fail(ServerClosedError(
                    "server close timed out with the request in flight")):
                self.stats.on_failure(1, req.qos)
        if not leftovers and (scheduler is None or not scheduler.is_alive()):
            # nothing in flight and nothing left to launch: the finish
            # workers are idle, so joining them is bounded; a server closed
            # so leaves no thread that could touch the card afterwards
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # client faces
    # ------------------------------------------------------------------
    def submit(self, request: QueryRequest) -> Ticket:
        """Enqueue one request and return its ticket.

        Takes a ``QueryRequest`` alone — QoS, consistency, and budget
        travel inside it; callers build one through ``FeatureClient``.

        Raises ``QueueFullError`` / ``DeadlineError`` / ``ServerClosedError``
        at admission time when the request is shed by policy."""
        if self._closed:
            raise ServerClosedError("server is closed")
        if not isinstance(request, QueryRequest):
            raise TypeError(
                "QueryServer.submit takes a QueryRequest; raw "
                "{table: keys} dicts go through FeatureClient.query/submit")
        req = request
        pin_version, pin_strict = req.consistency.pin_args()
        tracer = self.tracer
        tctx = None
        if tracer is not None:
            if req.trace is not None:
                tctx = dict(req.trace)   # propagated edge decision
            else:
                tid = tracer.sample()    # rate 0 short-circuits
                if tid is not None:
                    tctx = {"trace_id": tid}
        now = time.monotonic()
        deadline = None if req.budget_s is None else now + req.budget_s
        ticket = Ticket(deadline)
        pending = _Pending(
            tables=req.tables, n_keys=req.n_keys, t_submit=now,
            deadline=deadline, version=pin_version, strict=pin_strict,
            qos=req.qos, consistency=req.consistency, ticket=ticket,
            trace=tctx)
        self.stats.on_submit(req.qos)
        try:
            self._batcher.admit(pending)   # raises the typed shed errors
        except ServerClosedError:
            # keep the snapshot reconcilable (submitted == completed +
            # failed + shed): a close() racing this submit is a failure,
            # not a silently vanished request
            self.stats.on_failure(1, req.qos)
            raise
        if tctx is not None:
            # stamped post-admit; the scheduler may already be batching
            # this request, so span emission falls back to t_submit when
            # it wins that race
            tctx["t_admit"] = time.monotonic()
        return ticket

    def query(self, request: QueryRequest, *,
              timeout: Optional[float] = None) -> QueryResponse:
        """Synchronous convenience: submit + wait.  Exceptions that failed
        the micro-batch (e.g. ``VersionEvictedError`` under a pinned
        consistency) or shed the request re-raise here."""
        return self.submit(request).result(timeout)

    def apply_update(self, update) -> None:
        """Publish through the backend while serving continues (micro-
        batches pin their build at begin time, so this never mixes
        versions into an in-flight batch)."""
        self.backend.apply_update(update)

    def stats_snapshot(self) -> StatsSnapshot:
        return self.stats.snapshot()

    def reset_stats(self) -> None:
        """Fresh counters/latencies — start a measurement window after
        warmup (first kernel builds and launches otherwise dominate the
        percentiles)."""
        self.stats = ServerStats(self.policy)
        self._batcher.stats = self.stats

    @property
    def queue_depth(self) -> int:
        return self._batcher.depth()

    @property
    def lane_depths(self) -> dict[str, int]:
        return self._batcher.lane_depths()

    # ------------------------------------------------------------------
    # runtime retuning (a traffic controller closes the loop here)
    # ------------------------------------------------------------------
    def lane_policies(self) -> dict[str, BatchPolicy]:
        """The live per-lane close rules (post any runtime retunes)."""
        return self._batcher.lane_policies()

    def retune_lane(self, qos, **changes) -> BatchPolicy:
        """Retune one lane's close rules while serving.

        ``changes`` may touch only the lane-scoped fields
        (``max_batch_keys``, ``max_batch_requests``, ``max_wait_s``);
        the new policy is rebuilt through ``BatchPolicy`` so its
        ``__post_init__`` validation is the oracle — a bad knob raises
        here and the lane keeps its old policy.  Single-writer by
        design (one controller per server); returns the applied policy."""
        lane_fields = {"max_batch_keys", "max_batch_requests", "max_wait_s"}
        unknown = set(changes) - lane_fields
        if unknown:
            raise ValueError(f"retune_lane can only change "
                             f"{sorted(lane_fields)}, got {sorted(unknown)}")
        current = self._batcher.lane_policy(qos)
        new = dataclasses.replace(current, **changes)
        self._batcher.set_lane_policy(qos, new)
        return new

    # ------------------------------------------------------------------
    # scheduler pipeline
    # ------------------------------------------------------------------
    def _run(self) -> None:
        while True:
            batch = self._batcher.next_batch()
            if batch is None:
                return
            self._inflight.acquire()
            batch_id = next(self._batch_ids)
            # batch-level trace timestamps, shared by every traced rider
            # (coalesce/pin/begin/device/finish happen once per batch)
            tinfo = None
            if self.tracer is not None \
                    and any(r.trace is not None for r in batch):
                tinfo = {"formed": time.monotonic()}
            fused, spans = coalesce(batch)
            if tinfo is not None:
                tinfo["coalesced"] = time.monotonic()
            t_launch = time.monotonic()
            # in-flight BEFORE begin: a request stalled inside a slow
            # backend.begin() must be visible to close()'s drain, or a
            # bounded close times out believing nothing is outstanding and
            # strands the ticket
            self._inflight_reqs[batch_id] = batch
            try:
                # begin pins ONE version for the whole micro-batch; the
                # build reference keeps that version's tables alive even if
                # a concurrent publish evicts it from the window mid-flight
                inflight = self.backend.begin(
                    fused, version=batch[0].version, strict=batch[0].strict)
                if tinfo is not None:
                    tinfo["begun"] = time.monotonic()
            except BaseException as e:  # noqa: BLE001
                self._inflight.release()
                self._inflight_reqs.pop(batch_id, None)
                if len(batch) == 1:
                    self.stats.on_failure(1, batch[0].qos)
                    batch[0].ticket._fail(e)
                else:
                    # a request-specific fault (e.g. one rider's unknown
                    # table name) must not fail its co-batched riders:
                    # retry each request as its own batch so only the
                    # offender errors
                    for req in batch:
                        self._serve_single(req)
                continue
            # the pool blocks on backend results + scatters back while this
            # thread loops on to stage/launch the next micro-batch
            try:
                self._pool.submit(self._finish_batch, batch_id, batch,
                                  spans, inflight, t_launch, tinfo)
            except RuntimeError:
                # pool already shut down (close() raced a long drain):
                # finish inline so no ticket is ever left hanging
                self._finish_batch(batch_id, batch, spans, inflight,
                                   t_launch, tinfo)

    def _serve_single(self, req: _Pending) -> None:
        """Rare fallback: serve one request as its own micro-batch, inline
        on the scheduler thread (used when a fused begin() failed, to
        isolate a request-specific fault to its origin)."""
        tinfo = None
        if self.tracer is not None and req.trace is not None:
            tinfo = {"formed": time.monotonic()}
        fused, spans = coalesce([req])
        if tinfo is not None:
            tinfo["coalesced"] = time.monotonic()
        t_launch = time.monotonic()
        try:
            inflight = self.backend.begin(fused, version=req.version,
                                          strict=req.strict)
            if tinfo is not None:
                tinfo["begun"] = time.monotonic()
                tinfo["finish_start"] = tinfo["begun"]
            result = self.backend.finish(inflight)
        except BaseException as e:  # noqa: BLE001
            self.stats.on_failure(1, req.qos)
            req.ticket._fail(e)
            return
        now = time.monotonic()
        if tinfo is not None:
            tinfo["launch"] = t_launch
            tinfo["finish_end"] = now
        self._batcher.observe_service_time(now - t_launch)
        self.stats.on_batch(1, inflight.keys_requested,
                            inflight.keys_deviceside, inflight.launches)
        self._deliver(req, result, spans[0], next(self._batch_ids), now,
                      tinfo)

    def _trace_spans(self, req: _Pending, tinfo: Optional[dict],
                     version: int, batch_id: int, t_scatter: float,
                     t_end: float) -> list:
        """Build this request's span timeline (obs/trace.py taxonomy:
        admission -> lane_wait -> coalesce -> version_pin -> begin ->
        device -> finish -> scatter under a ``serve`` root), record it in
        the tracer, and return the spans."""
        tracer = self.tracer
        ctx = req.trace
        tid = ctx["trace_id"]
        proc = tracer.proc
        root = Span(tid, "serve", req.t_submit, t_end,
                    parent_id=ctx.get("parent_id"), proc=proc,
                    tags={"qos": req.qos.name, "batch_id": batch_id,
                          "version": version, "n_keys": req.n_keys})
        pid = root.span_id
        # submit() stamps t_admit after admit() returns; a fast scheduler
        # can deliver before that lands — fall back to the submit stamp
        t_admit = ctx.get("t_admit", req.t_submit)
        out = [root, Span(tid, "admission", req.t_submit, t_admit,
                          parent_id=pid, proc=proc)]
        if tinfo is not None:
            chain = (("lane_wait", t_admit, tinfo["formed"]),
                     ("coalesce", tinfo["formed"], tinfo["coalesced"]),
                     ("version_pin", tinfo["coalesced"], tinfo["launch"]),
                     ("begin", tinfo["launch"], tinfo["begun"]),
                     ("device", tinfo["begun"], tinfo["finish_start"]),
                     ("finish", tinfo["finish_start"],
                      tinfo["finish_end"]))
            for name, t0, t1 in chain:
                tags = {"version": version} if name == "version_pin" \
                    else None
                out.append(Span(tid, name, t0, t1, parent_id=pid,
                                proc=proc, tags=tags))
        out.append(Span(tid, "scatter", t_scatter, t_end, parent_id=pid,
                        proc=proc))
        tracer.record(out)
        return out

    def _deliver(self, req: _Pending, result, span, batch_id: int,
                 now: float, tinfo: Optional[dict] = None) -> None:
        """Scatter one request's slice out of a finished batch, enforce its
        ``min_version`` requirement, record stats, wake the ticket."""
        latency = now - req.t_submit
        try:
            req.consistency.check(result.version)
        except ConsistencyError as e:
            self.stats.on_failure(1, req.qos)
            req.ticket._fail(e)
            return
        traced = self.tracer is not None and req.trace is not None
        t_scatter = time.monotonic() if traced else 0.0
        sliced = scatter(result, span)
        met = None if req.deadline is None else now <= req.deadline
        # stats BEFORE waking the ticket: a client observing its result
        # (e.g. warmup join followed by reset_stats) must never find its
        # own completion still unrecorded
        self.stats.on_complete(latency, met, req.qos)
        trace_wire = None
        if traced:
            spans = self._trace_spans(req, tinfo, result.version, batch_id,
                                      t_scatter, time.monotonic())
            trace_wire = [s.to_wire() for s in spans]
        req.ticket._complete(
            QueryResponse.from_result(sliced, qos=req.qos,
                                      latency_s=latency, batch_id=batch_id,
                                      trace=trace_wire),
            batch_id, latency)

    def _finish_batch(self, batch_id: int, batch: list, spans: list,
                      inflight, t_launch: float,
                      tinfo: Optional[dict] = None) -> None:
        try:
            try:
                if tinfo is not None:
                    tinfo["finish_start"] = time.monotonic()
                result = self.backend.finish(inflight)
            except BaseException as e:  # noqa: BLE001
                for req in batch:
                    self.stats.on_failure(1, req.qos)
                    req.ticket._fail(e)
                return
            finally:
                self._inflight.release()
            now = time.monotonic()
            if tinfo is not None:
                tinfo["launch"] = t_launch
                tinfo["finish_end"] = now
            self._batcher.observe_service_time(now - t_launch)
            self.stats.on_batch(len(batch), inflight.keys_requested,
                                inflight.keys_deviceside, inflight.launches,
                                service_s=now - t_launch)
            for req, span in zip(batch, spans):
                self._deliver(req, result, span, batch_id, now, tinfo)
        finally:
            # whatever path settled (or raised), this batch is no longer
            # in flight — close() must not wait on or re-fail it
            self._inflight_reqs.pop(batch_id, None)
