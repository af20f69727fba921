"""``BatchQueryBackend`` — the storage protocol under the FeatureService.

A backend is anything that can answer a fused ``{table: keys}`` batch in
two phases (``begin`` pins one version and dispatches, ``finish`` blocks
and gathers) and absorb ``UpdateRequest`` mutations.  The split-phase shape
is what lets ``serve/server.QueryServer`` double-buffer any backend the
same way it double-buffers the engine.

Three implementations ship:

  - ``EngineBackend``  — the fused ``MultiTableEngine`` (the paper's query
                         service proper);
  - ``StoreBackend``   — standalone ``HybridKVStore`` value tables with no
                         engine in front (the hybrid hot/cold tier served
                         directly, retention window of one version);
  - ``ClusterBackend`` — a ``ClusterSim`` replica fleet: version pinning
                         resolves against live replica metadata, data comes
                         from the fleet's shared engine data plane.

``begin`` must return an object exposing ``keys_requested`` /
``keys_deviceside`` / ``launches`` so the server's coalesce stats stay
backend-agnostic.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.api.types import (Consistency, QueryRequest, QueryResult,
                                   TableResult, UpdateRequest)
# NOT repro_torch.core.engine: backends must import torch-free so a
# shard-server process can serve a StoreBackend without the engine's torch
# import (CUDA does not survive fork); EngineBackend takes a built engine
from repro_torch.core.query_types import VersionEvictedError
from repro_torch.core.hybrid_store import HybridKVStore

__all__ = ["BatchQueryBackend", "ClusterBackend", "EngineBackend",
           "FabricBackend", "StoreBackend", "as_backend"]


@runtime_checkable
class BatchQueryBackend(Protocol):
    """What the serving layer requires of a storage face."""

    name: str

    @property
    def latest_version(self) -> int: ...

    @property
    def table_names(self) -> list[str]: ...

    def begin(self, tables: dict[str, np.ndarray], *,
              version: Optional[int] = None, strict: bool = False): ...

    def finish(self, inflight) -> QueryResult: ...

    def apply_update(self, update: UpdateRequest) -> None: ...


# ---------------------------------------------------------------------------
# MultiTableEngine
# ---------------------------------------------------------------------------
class EngineBackend:
    """The fused multi-table engine behind the protocol — a thin adapter,
    since the engine already speaks split-phase version-pinned batches."""

    name = "engine"

    def __init__(self, engine):
        self.engine = engine

    @property
    def latest_version(self) -> int:
        return self.engine.latest_version

    @property
    def table_names(self) -> list[str]:
        return self.engine.table_names

    def begin(self, tables, *, version=None, strict=False):
        return self.engine.begin(tables, version=version, strict=strict)

    def finish(self, inflight) -> QueryResult:
        return self.engine.finish(inflight)

    def apply_update(self, update: UpdateRequest) -> None:
        if update.is_delta:
            self.engine.publish_delta(update.version, update.upserts,
                                      update.deletes)
        else:
            self.engine.publish(update.version, update.scalars,
                                update.embeddings)


# ---------------------------------------------------------------------------
# standalone HybridKVStore tables
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _StoreInflight:
    version: int                         # resolved at begin; finish re-pins
    strict: bool                         # a strict pin may NOT re-pin
    staged: dict[str, tuple[np.ndarray, np.ndarray]]  # name -> (uniq, inv)
    keys_requested: int
    keys_deviceside: int
    launches: int


class StoreBackend:
    """Hybrid hot/cold value tables served without an engine in front.

    Updates are in-place (``upsert_batch``/``delete_batch``), so the
    retention window is exactly one version: a strict pin to anything but
    the current version NACKs with ``VersionEvictedError``, a hinted pin
    re-pins to current — the same protocol surface as the engine, with a
    degenerate window.  Because there is no retained build to keep an
    in-flight batch on, ``finish`` gathers every table under the update
    lock and re-pins to the version current at gather time: an update
    landing between begin and finish moves the whole batch forward to the
    new version, it can never produce rows from one version labelled with
    another.  Dedup mirrors the engine's: each table's keys are uniqued
    before the store probe and inverse-gathered back."""

    name = "store"

    def __init__(self, stores: dict[str, HybridKVStore], *, version: int = 1,
                 compact_threshold: float = 0.3):
        if not stores:
            raise ValueError("StoreBackend needs at least one named store")
        for name, store in stores.items():
            if not isinstance(store, HybridKVStore):
                raise ValueError(f"table {name!r} is not a HybridKVStore")
        if not 0.0 < compact_threshold <= 1.0:
            raise ValueError(f"compact_threshold must be in (0, 1], got "
                             f"{compact_threshold}")
        self.stores = dict(stores)
        # strict: a version read racing apply_update could pair freshly
        # updated rows with the pre-update version tag — the torn
        # (rows, version) state this class exists to prevent — so even
        # the latest_version property reads under the lock
        self._version = int(version)    # guarded-by: _update_lock (strict)
        # deletes orphan cold rows in place; once a store's garbage
        # fraction crosses this, apply_update triggers a compaction pass
        # after the delta lands (outside the update lock — in-flight
        # gathers are protected by the store's own seqlock)
        self.compact_threshold = compact_threshold
        # serializes gathers against updates: the window-of-one store has
        # no immutable build for a batch to hold, so atomicity of (rows,
        # version tag) comes from this lock instead
        self._update_lock = threading.Lock()

    @property
    def latest_version(self) -> int:
        with self._update_lock:
            return self._version

    @property
    def table_names(self) -> list[str]:
        return sorted(self.stores)

    def begin(self, tables, *, version=None, strict=False):
        with self._update_lock:
            current = self._version     # read once — an update racing this
            # begin must either NACK here or at finish's re-check, never
            # slip a newer version under a strict pin unnoticed
        if version is not None and version != current:
            if strict:
                raise VersionEvictedError(
                    f"version {version} not retained; store backend holds "
                    f"only [{current}]")
            # NACK -> re-pin to the single live version
        staged = {}
        requested = deviceside = 0
        for name, keys in tables.items():
            if name not in self.stores:
                raise KeyError(f"unknown table {name!r}; backend serves "
                               f"{self.table_names}")
            keys = np.asarray(keys, dtype=np.uint64).ravel()
            uniq, inverse = np.unique(keys, return_inverse=True)
            requested += len(keys)
            deviceside += len(uniq)
            staged[name] = (uniq, inverse)
        # a strict pin records the REQUESTED version: if an update slipped
        # in since `current` was read, finish's version != pin re-check
        # NACKs instead of serving newer rows under the demanded pin
        pin = version if strict and version is not None else current
        return _StoreInflight(version=pin, strict=strict,
                              staged=staged, keys_requested=requested,
                              keys_deviceside=deviceside,
                              launches=len(staged))

    def finish(self, inflight: _StoreInflight) -> QueryResult:
        with self._update_lock:
            version = self._version     # re-pin: rows below match THIS
            if inflight.strict and version != inflight.version:
                raise VersionEvictedError(
                    f"version {inflight.version} was replaced by {version} "
                    f"while the batch was in flight (store backend retains "
                    f"one version)")
            tables = {}
            for name, (uniq, inverse) in inflight.staged.items():
                found_u, vals_u = self.stores[name].get_batch(uniq)
                tables[name] = TableResult(found=found_u[inverse],
                                           values=vals_u[inverse])
        return QueryResult(version=version, tables=tables)

    def apply_update(self, update: UpdateRequest) -> None:
        if not update.is_delta:
            raise ValueError("StoreBackend tables mutate in place; only "
                             "delta updates (upserts/deletes) apply")
        # validate EVERYTHING before mutating ANYTHING: stores update in
        # place, so a mid-apply failure (bad rows for the second table
        # after the first already upserted) would leave new rows under the
        # old version tag — the torn state this class exists to prevent
        upserts, deletes = {}, {}
        for name in set(update.upserts) | set(update.deletes):
            if name not in self.stores:
                raise KeyError(f"unknown table {name!r}; backend serves "
                               f"{self.table_names}")
        for name, (keys, rows) in update.upserts.items():
            keys = np.asarray(keys, dtype=np.uint64).ravel()
            rows = np.asarray(rows)
            vb = self.stores[name].value_bytes
            if rows.dtype != np.uint8 or rows.ndim != 2 \
                    or rows.shape != (len(keys), vb):
                raise ValueError(
                    f"upsert for table {name!r} must be uint8 "
                    f"[{len(keys)}, {vb}], got {rows.dtype} {rows.shape}")
            upserts[name] = (keys, rows)
        for name, keys in update.deletes.items():
            # uint64 coercion can itself raise (negative / oversized keys)
            # — that too must happen before any store mutates
            deletes[name] = np.asarray(keys, dtype=np.uint64).ravel()
        with self._update_lock:
            # versions move forward only, like the engine's VersionWindow —
            # a replayed/out-of-order delta must not regress latest_version
            # (min_version read-your-writes would break for rows already
            # live); checked under the lock, or two concurrent updates
            # could both pass and apply in either order
            if update.version <= self._version:
                raise ValueError(
                    f"update version {update.version} must exceed the live "
                    f"version {self._version} (versions are monotonic)")
            for name, (keys, rows) in upserts.items():
                self.stores[name].upsert_batch(keys, rows)
            for name, keys in deletes.items():
                self.stores[name].delete_batch(keys)
            self._version = update.version
        # threshold-driven compaction AFTER the delta (and after releasing
        # the update lock so finish() gathers aren't stalled behind the
        # rewrite): a no-op below the threshold, a full live-row rewrite +
        # atomic swap above it.  Concurrent apply_updates may both get
        # here; the second pass sees a freshly-reset garbage fraction and
        # skips.
        for name in set(update.upserts) | set(update.deletes):
            self.stores[name].compact(
                min_garbage_fraction=self.compact_threshold)

    def set_compact_threshold(self, threshold: float) -> None:
        """Retune the post-delta compaction trigger at runtime (the
        adaptive controller relaxes it under serve pressure) and push it
        down to every store's async-compaction loop.  Same validation as
        the constructor argument."""
        if not 0.0 < threshold <= 1.0:
            raise ValueError(f"compact_threshold must be in (0, 1], got "
                             f"{threshold}")
        self.compact_threshold = float(threshold)
        for store in self.stores.values():
            store.set_compaction_threshold(threshold)

    def bump_version(self, version: int) -> None:
        """Adopt a newer version with no local data change.  A sharded
        fleet needs this: a fleet-wide delta may route zero rows to some
        shard, yet every shard must still serve the new fleet version or
        pinned sub-queries to it would NACK forever.  Plain ``UpdateRequest``
        deliberately rejects the empty delta — the phantom-generation
        guard — so the epoch adoption is its own explicit face."""
        version = int(version)
        with self._update_lock:
            if version <= self._version:
                raise ValueError(
                    f"bump to {version} must exceed the live version "
                    f"{self._version} (versions are monotonic)")
            self._version = version

    def tier_stats(self) -> dict[str, dict]:
        """Per-table tier-counter snapshots (``{table: {field: value}}``)
        for the observability bridge and the fabric's KIND_STATS scrape —
        each store's counters copied atomically under its stats lock."""
        return {name: dataclasses.asdict(store.stats_snapshot())
                for name, store in self.stores.items()}

    # -- snapshot/restore (the fabric's respawn substrate) ---------------
    SNAPSHOT_FORMAT = 1

    def snapshot_to(self, path: str) -> int:
        """Write an atomic on-disk snapshot: one ``table_<name>`` store
        snapshot per table plus ``meta.json`` carrying the version the
        rows belong to.  Taken under the update lock, so the (rows,
        version) pair is exactly what a query at that instant would have
        been served.  Returns the snapshotted version.

        The write lands in ``<path>.tmp`` and renames into place, so a
        crash mid-snapshot can never leave a half-written directory where
        a respawning replica would look."""
        path = os.fspath(path)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with self._update_lock:
            version = self._version
            for name, store in self.stores.items():
                store.save(os.path.join(tmp, f"table_{name}"))
            meta = {"format": self.SNAPSHOT_FORMAT, "version": version,
                    "tables": sorted(self.stores)}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        return version

    @classmethod
    def load_snapshot(cls, path: str, *,
                      compact_threshold: float = 0.3) -> "StoreBackend":
        """Reconstruct a backend from ``snapshot_to`` output: every table
        round-trips bitwise (see ``HybridKVStore.load``) and the backend
        resumes at the snapshotted version."""
        path = os.fspath(path)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format") != cls.SNAPSHOT_FORMAT:
            raise ValueError(f"unsupported snapshot format "
                             f"{meta.get('format')!r} at {path}")
        stores = {name: HybridKVStore.load(os.path.join(path,
                                                        f"table_{name}"))
                  for name in meta["tables"]}
        return cls(stores, version=meta["version"],
                   compact_threshold=compact_threshold)


# ---------------------------------------------------------------------------
# ClusterSim replica fleets
# ---------------------------------------------------------------------------
class ClusterBackend:
    """A replica fleet (``core/cluster_sim.ClusterSim``, with its engine
    data plane) as a backend: the consistency pin resolves against
    live replica *metadata* (a strict pin needs every shard to hold a live
    replica with that version; latest pins the fleet's newest common
    version), then the rows come from the fleet's shared engine data plane
    pinned strict to that choice — a replica that claimed a version must
    really serve it."""

    name = "cluster"

    def __init__(self, sim):
        if getattr(sim, "engine", None) is None:
            raise ValueError("ClusterBackend needs a ClusterSim with a data "
                             "plane (pass tables_for_version)")
        self.sim = sim
        # begin() runs on every caller's thread when the client is direct
        # (no QueryServer in front); the sim's metric counters, shared rng
        # (_pick_replica draws from it), and replica version windows are
        # all unsynchronized sim state, so resolution + accounting
        # serialize here
        self._sim_lock = threading.Lock()

    @property
    def latest_version(self) -> int:
        return self.sim.engine.latest_version

    @property
    def table_names(self) -> list[str]:
        return self.sim.engine.table_names

    def _resolve(self, version: Optional[int], strict: bool) -> int:
        sim = self.sim
        if version is not None:
            live = all(sim._pick_replica(s, version) is not None
                       for s in range(sim.cfg.n_shards))
            if live:
                return version
            if strict:
                raise VersionEvictedError(
                    f"no full replica set still serves version {version}")
        v = sim._common_version()
        if v < 0:
            raise RuntimeError("no common version across live replicas")
        return v

    def begin(self, tables, *, version=None, strict=False):
        sim = self.sim
        with self._sim_lock:
            v = self._resolve(version, strict)
            sim.metrics.queries += 1
            sim.metrics.sub_queries += sim.cfg.n_shards
            sim.metrics.consistent_batches += 1
            # the engine pin happens under the SAME lock as resolution and
            # as apply_update's publish: otherwise a publish burst between
            # resolve and begin could evict v and turn a latest/hinted
            # query — modes that may never NACK — into VersionEvictedError
            return sim.engine.begin(tables, version=v, strict=True)

    def finish(self, inflight) -> QueryResult:
        return self.sim.engine.finish(inflight)

    def apply_update(self, update: UpdateRequest) -> None:
        """An instantaneous rolling update: the shared data plane publishes
        the build, then every live replica's metadata window learns the
        version (sim-time update waves belong to ``start_rolling_update``;
        this face is for callers driving the fleet as a plain backend)."""
        sim = self.sim
        # the whole publish — engine build install AND replica metadata
        # flip — happens under the lock begin() resolves and pins with: a
        # concurrent query must never observe a half-published fleet, nor
        # have its freshly-resolved version evicted from the engine window
        # before its pin lands
        with self._sim_lock:
            if update.is_delta:
                sim.engine.publish_delta(update.version, update.upserts,
                                         update.deletes)
            else:
                sim.engine.publish(update.version, update.scalars,
                                   update.embeddings)
            for shard in sim.replicas:
                for rep in shard:
                    if rep.alive:
                        rep.publish(update.version)
            sim.current_version = update.version


# ---------------------------------------------------------------------------
# multi-process fabric (serve/fabric.Router)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _FabricInflight:
    future: object                       # Future[(QueryResponse, fan info)]
    keys_requested: int
    # filled by finish() from the router's fan-out accounting; the server
    # reads them only after finish returns
    keys_deviceside: int = 0
    launches: int = 0


class FabricBackend:
    """A ``serve/fabric.Router`` behind the protocol, so a ``QueryServer``
    (or a direct ``FeatureClient``) can front a whole multi-process shard
    fleet exactly like it fronts one engine.  ``begin`` dispatches the
    router fan-out on a pool thread (the router blocks on shard-process
    round trips — that wait must not serialize the caller's pipeline);
    ``finish`` blocks on the merged response.

    Duck-typed against the router (``query_ex``/``apply_update``/
    ``fleet_version``/``table_names``) rather than importing it: ``api``
    must not depend on ``serve``."""

    name = "fabric"

    def __init__(self, router, *, workers: int = 4):
        for attr in ("query_ex", "apply_update", "fleet_version",
                     "table_names"):
            if not hasattr(router, attr):
                raise TypeError(f"router lacks .{attr}; expected a "
                                f"serve.fabric.Router")
        self.router = router
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="fabric-begin")

    @property
    def latest_version(self) -> int:
        return self.router.fleet_version

    @property
    def table_names(self) -> list[str]:
        return self.router.table_names

    def begin(self, tables, *, version=None, strict=False):
        if version is None:
            consistency = Consistency.latest()
        elif strict:
            consistency = Consistency.pinned(version)
        else:
            consistency = Consistency.hinted(version)
        req = QueryRequest(tables=tables, consistency=consistency)
        return _FabricInflight(
            future=self._pool.submit(self.router.query_ex, req),
            keys_requested=req.n_keys)

    def finish(self, inflight: _FabricInflight) -> QueryResult:
        response, info = inflight.future.result()
        inflight.keys_deviceside = info.get("keys_deviceside",
                                            inflight.keys_requested)
        inflight.launches = info.get("launches", 1)
        return QueryResult(version=response.version,
                           tables=response.tables)

    def apply_update(self, update: UpdateRequest) -> None:
        self.router.apply_update(update)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
def as_backend(target) -> BatchQueryBackend:
    """Coerce a storage object to the protocol: engines and sims wrap in
    their adapters; anything already satisfying the protocol passes
    through.  Bare ``HybridKVStore``s need an explicit ``StoreBackend``
    (the protocol needs a table name the store doesn't carry)."""
    # engine check via sys.modules, not an import: if the engine module was
    # never imported in this process, target cannot be an engine — and
    # importing it here would drag torch into torch-free shard servers
    eng_mod = sys.modules.get("repro_torch.core.engine")
    if eng_mod is not None and isinstance(target, eng_mod.MultiTableEngine):
        return EngineBackend(target)
    if isinstance(target, HybridKVStore):
        raise TypeError("wrap bare stores with a name: "
                        "StoreBackend({'table_name': store})")
    if hasattr(target, "replicas") and getattr(target, "engine", None) \
            is not None:
        return ClusterBackend(target)
    if hasattr(target, "fleet_version") and hasattr(target, "query"):
        return FabricBackend(target)          # serve/fabric.Router
    if isinstance(target, BatchQueryBackend):
        return target
    raise TypeError(f"{type(target).__name__} is not a BatchQueryBackend "
                    "(needs begin/finish/apply_update/latest_version)")
