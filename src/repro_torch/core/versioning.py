"""Multi-version tables + the batch-query consistency protocol (paper §2.2.2).

Semantics implemented:

  - **strong-version** tables (model embedding tables): values are only
    comparable within one training publish; a batch query MUST be answered
    entirely from a single version or the ranking is corrupted (paper Fig 10:
    ~3% of unprotected queries read mixed versions, measurably hurting CTR).
  - **weak-version** tables (most attribute tables): per-key freshest wins.

Protocol (paper Figures 7/8): the naming service only tracks instance
interfaces (ip:port); shard count and version metadata travel *inside* the
query protocol.  A client sends its pinned version with each sub-query; a
replica answers from its copy of that version if retained, else NACKs with the
versions it does hold; the client then re-pins to the highest version every
shard can serve and retries the NACKed sub-queries.  Servers retain the
previous generation during a rolling update, so a consistent answer always
exists without waiting for naming-service convergence.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np


class VersionStrength:
    STRONG = "strong"
    WEAK = "weak"


class VersionWindow:
    """Retention window over published states — the one place the
    strong-version rule lives.

    A *state* is whatever a publisher deems one consistent version: a single
    shard's Generation (ShardReplica) or a whole fused multi-table build
    (core/engine.MultiTableEngine).  ``get(v)`` implements the protocol's
    reply semantics: ok=False is the NACK (requested version not retained),
    with the retained versions available so the caller can re-pin.

    Thread-safe: concurrent publishers (the Update Subsystem) and pinners
    (QueryServer micro-batches) go through one lock, so a ``get`` can never
    observe the window between "latest moved" and "old state evicted" — the
    (ok, version, state) triple it returns is always one atomic snapshot."""

    def __init__(self, retain: int = 2):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.retain = retain
        # strict: the retention sweep in publish() mutates the dict, so
        # even a point read (max/membership) must serialize with it
        self._states: dict[int, object] = {}  # guarded-by: _lock (strict)
        self._lock = threading.Lock()
        # protocol counters for the observability bridge: pins served,
        # NACKs issued, publishes/evictions seen; bumped under the same
        # lock the protocol itself runs under
        # guarded-by: _lock (strict)
        self._counters = {"pins": 0, "nacks": 0, "publishes": 0,
                          "evictions": 0}

    def counters(self) -> dict[str, int]:
        """A consistent copy of the window's protocol counters."""
        with self._lock:
            return dict(self._counters)

    @property
    def versions(self) -> list[int]:
        with self._lock:
            return sorted(self._states)

    @property
    def latest(self) -> int:
        with self._lock:
            return max(self._states) if self._states else -1

    def publish(self, version: int, state) -> None:
        with self._lock:
            self._states[version] = state
            self._counters["publishes"] += 1
            while len(self._states) > self.retain:
                del self._states[min(self._states)]
                self._counters["evictions"] += 1

    def reset(self, versions_to_states: dict) -> None:
        """Replace the whole window (node repair / replica revive); the
        retain bound still applies."""
        with self._lock:
            self._states = {int(v): s for v, s in versions_to_states.items()}
            while len(self._states) > self.retain:
                del self._states[min(self._states)]

    def get(self, version: Optional[int] = None
            ) -> tuple[bool, int, Optional[object]]:
        """-> (ok, version_served, state).  ``version=None`` pins latest."""
        with self._lock:
            if not self._states:
                self._counters["nacks"] += 1
                return False, -1, None
            v = max(self._states) if version is None else version
            if v not in self._states:
                # NACK + best retained hint
                self._counters["nacks"] += 1
                return False, max(self._states), None
            self._counters["pins"] += 1
            return True, v, self._states[v]


@dataclasses.dataclass
class Generation:
    """One published version of one shard's data."""
    version: int
    keys: np.ndarray           # uint64 [n]
    values: np.ndarray         # [n, ...] any dtype
    _index: Optional[dict] = None

    def index(self) -> dict:
        if self._index is None:
            self._index = {int(k): i for i, k in enumerate(self.keys)}
        return self._index


class ShardReplica:
    """One replica of one shard.  Retains up to ``retain`` generations so
    in-flight batches pinned to the previous version still succeed during a
    rolling update."""

    def __init__(self, shard_id: int, replica_id: int, retain: int = 2):
        self.shard_id = shard_id
        self.replica_id = replica_id
        self.retain = retain
        self.window = VersionWindow(retain)
        self.serving = True

    @property
    def versions(self) -> list[int]:
        return self.window.versions

    @property
    def latest(self) -> int:
        return self.window.latest

    def publish(self, gen: Generation):
        self.window.publish(gen.version, gen)

    def query(self, keys: np.ndarray, version: Optional[int]
              ) -> tuple[bool, int, Optional[np.ndarray], Optional[np.ndarray]]:
        """-> (ok, version_served, found_mask, values).

        ok=False is the NACK: requested version not retained (the caller reads
        .versions from the reply and re-pins) — metadata-in-protocol, not via
        the naming service."""
        if not self.serving:
            return False, -1, None, None
        ok, v, gen = self.window.get(version)
        if not ok:
            return False, v, None, None
        idx = gen.index()
        found = np.zeros(len(keys), dtype=bool)
        out = np.zeros((len(keys),) + gen.values.shape[1:],
                       dtype=gen.values.dtype)
        for i, k in enumerate(np.asarray(keys, dtype=np.uint64)):
            j = idx.get(int(k))
            if j is not None:
                found[i] = True
                out[i] = gen.values[j]
        return True, v, found, out


@dataclasses.dataclass
class ConsistencyReport:
    attempts: int = 0
    repins: int = 0
    failures: int = 0
    versions_used: list = dataclasses.field(default_factory=list)

    @property
    def mixed_version_batches(self) -> int:
        return sum(1 for vs in self.versions_used if len(set(vs)) > 1)


class ConsistentBatchClient:
    """Client-side strong-version batch query over one table's shards.

    ``replicas[shard_id]`` is the list of available replicas for that shard.
    With ``enforce=False`` it mimics the naive client (each shard answers from
    its own latest version) — the paper's A/B baseline for Fig 10."""

    def __init__(self, replicas: list[list[ShardReplica]],
                 shard_of, enforce: bool = True):
        self.replicas = replicas
        self.shard_of = shard_of
        self.enforce = enforce
        self.report = ConsistencyReport()
        self._value_spec = None     # (row shape, dtype) seen on last success

    def _common_version(self) -> int:
        """Highest version every shard can serve (ask the shards, not the
        naming service)."""
        per_shard = []
        for reps in self.replicas:
            vs = set()
            for r in reps:
                if r.serving:
                    vs |= set(r.versions)
            if not vs:
                return -1
            per_shard.append(vs)
        common = set.intersection(*per_shard) if per_shard else set()
        return max(common) if common else -1

    def query(self, keys: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """-> (found, values, versions_per_shard_used)."""
        keys = np.asarray(keys, dtype=np.uint64)
        shard_ids = np.array([self.shard_of(int(k)) for k in keys],
                             dtype=np.int32)
        n_shards = len(self.replicas)
        pin = self._common_version() if self.enforce else None
        found = np.zeros(len(keys), dtype=bool)
        values = None
        versions_used = []
        self.report.attempts += 1
        for s in range(n_shards):
            mask = shard_ids == s
            if not mask.any():
                continue
            sub = keys[mask]
            ok = False
            for attempt, rep in enumerate(self._alive(s)):
                ok, v, f, vals = rep.query(sub, pin)
                if not ok and self.enforce and v >= 0:
                    # NACK: re-pin to a version this replica and everyone else
                    # still retains, retry (bounded)
                    self.report.repins += 1
                    pin = self._common_version()
                    ok, v, f, vals = rep.query(sub, pin)
                if ok:
                    break
            if not ok:
                # Fail the whole batch *consistently*: earlier shards may
                # already have gathered rows, and returning them against
                # zeroed values (or a (n, 1) float64 array that ignores the
                # table's real value shape/dtype) would hand the caller
                # found=True rows paired with garbage.  Clear the found
                # mask, keep the gathered array's shape/dtype for the
                # zeros, and record an EMPTY versions entry — the batch
                # answered from no version at all — so the report's
                # len(versions_used) == attempts invariant holds without
                # the partial list inflating mixed_version_batches.
                self.report.failures += 1
                self.report.versions_used.append([])
                found[:] = False
                if values is not None:
                    values = np.zeros_like(values)
                elif self._value_spec is not None:
                    # nothing gathered this time, but an earlier success
                    # told us the table's real row shape/dtype
                    shape, dtype = self._value_spec
                    values = np.zeros((len(keys),) + shape, dtype)
                else:
                    values = np.zeros((len(keys), 1))
                return found, values, []
            if values is None:
                values = np.zeros((len(keys),) + vals.shape[1:], vals.dtype)
                self._value_spec = (vals.shape[1:], vals.dtype)
            found[mask] = f
            values[mask] = vals
            versions_used.append(v)
        self.report.versions_used.append(versions_used)
        if values is None:
            values = np.zeros((len(keys), 1))
        return found, values, versions_used

    def _alive(self, shard_id: int) -> list[ShardReplica]:
        return [r for r in self.replicas[shard_id] if r.serving]


def rolling_update(replicas: list[list[ShardReplica]], new_gens,
                   steps_per_replica: int = 1):
    """Generator that performs a rolling update — one replica out of service
    at a time (the paper's +1/n-resources scheme) — yielding after each step
    so tests/simulations can interleave queries mid-update.

    ``new_gens[shard_id]`` is the Generation to publish to that shard."""
    n_replicas = max(len(reps) for reps in replicas)
    for rep_idx in range(n_replicas):
        for shard_id, reps in enumerate(replicas):
            if rep_idx >= len(reps):
                continue
            rep = reps[rep_idx]
            rep.serving = False                # drained
            yield ("draining", shard_id, rep_idx)
            rep.publish(new_gens[shard_id])    # load new generation
            rep.serving = True                 # back in rotation
            yield ("updated", shard_id, rep_idx)
