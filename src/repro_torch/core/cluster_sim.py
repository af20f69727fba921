"""Deterministic discrete-event simulator of the serving cluster (paper §2.2).

Models the parts of the paper's architecture that have no on-chip analogue:
replica fleets per shard, a naming service with propagation delay, rolling
updates, stragglers, node failures, and the two client designs under test —
naming-service-driven version discovery (baseline) vs. version metadata in the
query protocol (the paper's): Fig 10's experiment (``run_update_experiment``)
and the fault-tolerance tests.  With a data plane, the fleet's answers come
from a real ``MultiTableEngine`` on ``device`` (default ``"cuda"``).

Time is integer microseconds; all randomness is seeded.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional

import numpy as np

from repro_torch.core import hashcore as hc
from repro_torch.core.versioning import VersionWindow


@dataclasses.dataclass(order=True)
class _Event:
    time: int
    seq: int
    fn: Callable = dataclasses.field(compare=False)


class Sim:
    def __init__(self):
        self.now = 0
        self._q: list[_Event] = []
        self._seq = 0

    def at(self, t: int, fn: Callable):
        heapq.heappush(self._q, _Event(int(t), self._seq, fn))
        self._seq += 1

    def after(self, dt: int, fn: Callable):
        self.at(self.now + int(dt), fn)

    def run_until(self, t_end: int):
        while self._q and self._q[0].time <= t_end:
            ev = heapq.heappop(self._q)
            self.now = ev.time
            ev.fn()
        self.now = max(self.now, t_end)


@dataclasses.dataclass
class SimConfig:
    n_shards: int = 8
    n_replicas: int = 3
    retain_versions: int = 2
    rpc_latency_us: tuple[int, int] = (200, 800)       # uniform range
    straggler_prob: float = 0.02
    straggler_latency_us: int = 50_000
    hedge_deadline_us: int = 5_000                     # backup request fire
    naming_propagation_us: int = 2_000_000             # metadata staleness
    load_seconds_us: int = 3_000_000                   # replica reload time
    update_interval_us: int = 60_000_000               # publish cadence
    fail_prob_per_update: float = 0.0                  # replica crash chance
    repair_us: int = 30_000_000                        # node replacement time
    compact_garbage_threshold: float = 0.3             # cold-store reclaim
    seed: int = 0


class Replica:
    """Version bookkeeping delegates to the same VersionWindow the real
    query services use (core/versioning.py) — the sim replica is the
    metadata shadow of a MultiTableEngine build set."""

    def __init__(self, shard: int, idx: int, retain: int):
        self.shard = shard
        self.idx = idx
        self.window = VersionWindow(retain)
        self.window.publish(0, None)
        self.serving = True
        self.alive = True

    @property
    def versions(self) -> list[int]:
        return self.window.versions

    @versions.setter
    def versions(self, vs: list[int]):
        self.window.reset({int(v): None for v in vs})

    def publish(self, v: int):
        self.window.publish(v, None)

    def has(self, v: int) -> bool:
        return self.alive and self.serving and v in self.window.versions

    @property
    def latest(self) -> int:
        return self.window.latest


@dataclasses.dataclass
class ClusterMetrics:
    queries: int = 0
    sub_queries: int = 0
    failures: int = 0
    mixed_version_batches: int = 0
    consistent_batches: int = 0
    hedges: int = 0
    p_latencies_us: list = dataclasses.field(default_factory=list)
    update_wall_us: int = 0
    compactions: int = 0
    compaction_bytes_reclaimed: int = 0

    @property
    def mixed_rate(self) -> float:
        tot = self.mixed_version_batches + self.consistent_batches
        return self.mixed_version_batches / tot if tot else 0.0

    def latency_quantile(self, q: float) -> float:
        if not self.p_latencies_us:
            return 0.0
        return float(np.quantile(np.array(self.p_latencies_us), q))


class ClusterSim:
    """The full fleet.  ``protocol='paper'`` pins one version per batch using
    metadata carried in replies (strong consistency, immediate serve-after-
    ready); ``protocol='naming'`` trusts the (stale) naming-service view —
    each shard answers from whatever version its chosen replica has.
    ``device`` places the data plane's engine (default ``"cuda"``)."""

    def __init__(self, cfg: SimConfig, protocol: str = "paper",
                 tables_for_version: Optional[Callable] = None,
                 deltas_for_version: Optional[Callable] = None,
                 use_query_server: bool = False,
                 server_policy=None, device=None):
        assert protocol in ("paper", "naming")
        self.cfg = cfg
        self.protocol = protocol
        self.sim = Sim()
        self.rng = np.random.default_rng(cfg.seed)
        self.replicas = [[Replica(s, r, cfg.retain_versions)
                          for r in range(cfg.n_replicas)]
                         for s in range(cfg.n_shards)]
        self.metrics = ClusterMetrics()
        # the naming service's *believed* latest version per shard (stale)
        self.naming_view = [0] * cfg.n_shards
        self.current_version = 0
        # optional real data plane: ``tables_for_version(v) -> (scalars,
        # embeddings)``; the fleet then answers queries through an actual
        # MultiTableEngine whose retention window mirrors the replicas'.
        # ``deltas_for_version(v) -> (upserts, deletes) | None`` lets a
        # rolling update ship a *delta generation* (engine.publish_delta)
        # instead of a full rebuild — the incremental-learning cadence
        self.tables_for_version = tables_for_version
        self.deltas_for_version = deltas_for_version
        if deltas_for_version is not None and tables_for_version is None:
            raise ValueError(
                "deltas_for_version requires tables_for_version: the engine "
                "data plane needs a base build to apply deltas to")
        self.engine = None
        self.query_server = None
        self.feature_client = None
        if use_query_server and tables_for_version is None:
            raise ValueError("use_query_server needs a data plane: pass "
                             "tables_for_version")
        if tables_for_version is not None:
            from repro_torch.api.client import FeatureClient
            from repro_torch.core.engine import MultiTableEngine
            scalars, embeddings = tables_for_version(0)
            # the shared engine stands in for every replica's copy, so its
            # window must span the *union* of the staggered per-replica
            # windows (replica waves lag each other by one build)
            self.engine = MultiTableEngine(
                scalars, embeddings,
                retain=cfg.retain_versions + cfg.n_replicas, version=0,
                device=device)
            if use_query_server:
                # replicas front their data plane with the concurrent
                # serving layer: every sim query rides a QueryServer
                # micro-batch (one pinned version per batch) while rolling
                # updates publish new builds into the same engine.  The
                # sim issues queries one at a time and blocks on each, so
                # the default close rule's max_wait would be pure idle
                # time — close immediately instead
                from repro_torch.serve.scheduler import BatchPolicy
                from repro_torch.serve.server import QueryServer
                self.query_server = QueryServer(
                    self.engine,
                    policy=server_policy or BatchPolicy(max_wait_s=0.0))
            # the data plane speaks API v2: one FeatureClient session,
            # whether queries ride the QueryServer's lanes or hit the
            # engine backend directly
            self.feature_client = FeatureClient(
                self.query_server if self.query_server is not None
                else self.engine)

    def close(self) -> None:
        """Shut down the query-server pipeline (no-op without one); the
        feature client falls back to the direct engine backend so a
        late query still answers instead of hitting a closed server."""
        if self.query_server is not None:
            self.query_server.close()
            self.query_server = None
            if self.engine is not None:
                from repro_torch.api.client import FeatureClient
                self.feature_client = FeatureClient(self.engine)

    # ------------------------------------------------------------------
    # update machinery
    # ------------------------------------------------------------------
    def start_rolling_update(self, version: int,
                             on_done: Optional[Callable] = None):
        """One replica index at a time across all shards (paper's +1/n)."""
        t_begin = self.sim.now
        cfg = self.cfg

        def update_replica_wave(rep_idx: int):
            if rep_idx >= cfg.n_replicas:
                self.current_version = version
                self.metrics.update_wall_us = self.sim.now - t_begin
                if on_done:
                    on_done()
                return
            for s in range(cfg.n_shards):
                rep = self.replicas[s][rep_idx]
                if not rep.alive:
                    continue
                rep.serving = False
                if self.rng.random() < cfg.fail_prob_per_update:
                    rep.alive = False       # crash during reload ...
                    self._schedule_repair(rep)   # ... replacement provisioned
                    continue

            def finish(rep_idx=rep_idx):
                if rep_idx == 0 and self.engine is not None:
                    # first wave ready: the new build exists in the fleet —
                    # as a delta generation when the publisher ships one
                    delta = (self.deltas_for_version(version)
                             if self.deltas_for_version is not None else None)
                    if delta is not None:
                        upserts, deletes = delta
                        self.engine.publish_delta(version, upserts, deletes)
                        # replicas reclaim cold-store garbage as part of
                        # the rollout: copy-on-write delta generations
                        # append superseded rows to the shared cold files,
                        # and the reload window is exactly when background
                        # IO is cheapest (the replica is out of rotation)
                        r = self.engine.compact(
                            cfg.compact_garbage_threshold)
                        self.metrics.compactions += r["stores_compacted"]
                        self.metrics.compaction_bytes_reclaimed += \
                            r["reclaimed_bytes"]
                    else:
                        scalars, embeddings = self.tables_for_version(version)
                        self.engine.publish(version, scalars, embeddings)
                for s in range(cfg.n_shards):
                    rep = self.replicas[s][rep_idx]
                    if not rep.alive:
                        continue
                    rep.publish(version)
                    rep.serving = True
                # naming service learns about it later
                self.sim.after(cfg.naming_propagation_us,
                               lambda: self._naming_learn(version))
                if self.protocol == "paper":
                    # metadata travels in the query protocol: next wave can
                    # start as soon as replicas are ready
                    self.sim.after(1, lambda: update_replica_wave(rep_idx + 1))
                else:
                    # baseline must wait for client/naming convergence before
                    # the next wave or clients lose the version they query
                    self.sim.after(cfg.naming_propagation_us,
                                   lambda: update_replica_wave(rep_idx + 1))

            self.sim.after(cfg.load_seconds_us, finish)

        update_replica_wave(0)

    def _naming_learn(self, version: int):
        for s in range(self.cfg.n_shards):
            self.naming_view[s] = max(self.naming_view[s], version)

    def fail_replica(self, shard: int, idx: int):
        self.replicas[shard][idx].alive = False

    def _schedule_repair(self, rep: Replica):
        """Node replacement: after repair_us a fresh replica comes up with
        the shard's current generations (fault tolerance — without this the
        fleet bleeds replicas under a per-update crash rate)."""
        def revive():
            rep.versions = sorted({self.current_version,
                                   max(self.current_version - 1, 0)})
            rep.alive = True
            rep.serving = True
        self.sim.after(self.cfg.repair_us, revive)

    # ------------------------------------------------------------------
    # query path
    # ------------------------------------------------------------------
    def _rpc_latency(self) -> int:
        lo, hi = self.cfg.rpc_latency_us
        lat = int(self.rng.integers(lo, hi))
        if self.rng.random() < self.cfg.straggler_prob:
            lat += self.cfg.straggler_latency_us
        return lat

    def _pick_replica(self, shard: int, need_version: Optional[int]
                      ) -> Optional[Replica]:
        reps = [r for r in self.replicas[shard] if r.alive and r.serving]
        if need_version is not None:
            reps = [r for r in reps if need_version in r.versions]
        if not reps:
            return None
        return reps[int(self.rng.integers(0, len(reps)))]

    def _common_version(self) -> int:
        per_shard = []
        for s in range(self.cfg.n_shards):
            vs = set()
            for r in self.replicas[s]:
                if r.alive and r.serving:
                    vs |= set(r.versions)
            if not vs:
                return -1
            per_shard.append(vs)
        common = set.intersection(*per_shard)
        return max(common) if common else -1

    def _shard_of_keys(self, keys: np.ndarray) -> np.ndarray:
        hi, lo = hc.key_split_np(np.asarray(keys, dtype=np.uint64))
        return (hc.hash64_np(hi, lo) % np.uint32(self.cfg.n_shards)).astype(
            np.int32)

    def _fetch_data(self, request: dict, versions: list[int]) -> dict:
        """Answer ``request`` with real rows, each sim-shard's keys served
        from the version that shard's chosen replica used.  Under the paper
        protocol all shards share one pin; under the naming baseline the
        per-shard versions can differ — and the returned batch then really
        does contain mixed-version rows (Fig 10 at the data level)."""
        from repro_torch.api.types import Consistency
        items = {name: np.asarray(keys, dtype=np.uint64).ravel()
                 for name, keys in request.items()}
        shard_ids = {name: self._shard_of_keys(k)
                     for name, k in items.items()}
        found = {name: np.zeros(len(k), dtype=bool)
                 for name, k in items.items()}
        data: dict = {name: None for name in items}   # payloads or rows
        # one fused engine query per version, spanning ALL tables — the
        # coalescing is the whole point of routing through the engine
        for v in sorted(set(versions)):
            shards_v = [s for s, vv in enumerate(versions) if vv == v]
            sub, masks = {}, {}
            for name, keys in items.items():
                mask = np.isin(shard_ids[name], shards_v)
                if mask.any():
                    sub[name] = keys[mask]
                    masks[name] = mask
            if not sub:
                continue
            # pinned consistency: a replica that claims version v really
            # holds it; silently substituting a newer build would hide the
            # very mixing this data plane exists to expose
            res = self.feature_client.query(
                sub, consistency=Consistency.pinned(v))
            for name, mask in masks.items():
                tr = res[name]
                found[name][mask] = tr.found
                if tr.payloads is not None:          # scalar table
                    if data[name] is None:
                        data[name] = np.zeros(len(items[name]),
                                              dtype=np.uint64)
                    data[name][mask] = tr.payloads
                else:                                # embedding table
                    if data[name] is None:
                        data[name] = np.zeros(
                            (len(items[name]), tr.values.shape[1]),
                            dtype=np.uint8)
                    data[name][mask] = tr.values
        return {name: (found[name],
                       data[name] if data[name] is not None
                       else np.zeros(len(items[name]), dtype=np.uint64))
                for name in items}

    def query_batch(self, request: Optional[dict] = None):
        """One ranking request fanning out to all shards.

        Returns (ok, versions_used_per_shard, latency_us); with ``request``
        (a ``{table: keys}`` dict, requires the engine data plane) a fourth
        element carries ``{table: (found, payloads)}``.  Hedged requests:
        if a sub-query exceeds hedge_deadline_us, a backup goes to another
        replica and the faster answer wins (straggler mitigation)."""
        m = self.metrics
        m.queries += 1
        versions = []
        worst = 0
        pin = self._common_version() if self.protocol == "paper" else None
        for s in range(self.cfg.n_shards):
            m.sub_queries += 1
            if self.protocol == "paper":
                rep = self._pick_replica(s, pin)
                if rep is None:
                    # NACK path: re-pin from live metadata and retry once
                    pin = self._common_version()
                    rep = self._pick_replica(s, pin)
                    if rep is None:
                        m.failures += 1
                        return ((False, versions, worst, None)
                                if request is not None
                                else (False, versions, worst))
                v = pin
            else:
                # baseline: ask for naming service's believed version; the
                # replica answers from its *latest* if that is gone (this is
                # where mixed versions leak in)
                want = self.naming_view[s]
                rep = self._pick_replica(s, None)
                if rep is None:
                    m.failures += 1
                    return ((False, versions, worst, None)
                            if request is not None
                            else (False, versions, worst))
                v = want if want in rep.versions else rep.latest
            lat = self._rpc_latency()
            if lat > self.cfg.hedge_deadline_us:
                backup = self._pick_replica(s, v if self.protocol == "paper"
                                            else None)
                if backup is not None:
                    m.hedges += 1
                    lat = min(lat, self.cfg.hedge_deadline_us
                              + self._rpc_latency())
            worst = max(worst, lat)
            versions.append(v)
        if len(set(versions)) > 1:
            m.mixed_version_batches += 1
        else:
            m.consistent_batches += 1
        m.p_latencies_us.append(worst)
        if request is not None:
            if self.engine is None:
                raise ValueError("query_batch(request=...) needs a data "
                                 "plane: pass tables_for_version")
            return True, versions, worst, self._fetch_data(request, versions)
        return True, versions, worst


def run_update_experiment(update_interval_s: float, protocol: str,
                          duration_s: float = 600.0, qps: float = 50.0,
                          seed: int = 0, cfg: Optional[SimConfig] = None
                          ) -> ClusterMetrics:
    """Fig-10-style run: queries at ``qps`` while rolling updates arrive every
    ``update_interval_s``.  Returns the metrics (mixed_rate is the headline)."""
    cfg = cfg or SimConfig(seed=seed)
    cfg = dataclasses.replace(
        cfg, update_interval_us=int(update_interval_s * 1e6), seed=seed)
    c = ClusterSim(cfg, protocol=protocol)
    t_end = int(duration_s * 1e6)
    v = 1

    def schedule_update(version: int):
        c.start_rolling_update(version)
        c.sim.after(cfg.update_interval_us,
                    lambda: schedule_update(version + 1))

    c.sim.after(cfg.update_interval_us, lambda: schedule_update(v))
    step = int(1e6 / qps)
    t = step
    while t < t_end:
        c.sim.at(t, c.query_batch)
        t += step
    c.sim.run_until(t_end)
    return c.metrics
