"""Delta publishing: the Update Subsystem's path from training steps to the
serving tier (paper Fig 7).

``DeltaPublisher`` accumulates touched rows between publishes, cuts a new
generation per shard, and pushes it through a rolling update so in-flight
strong-version batches stay consistent (core/versioning.py).  A training
loop feeds it; the serving side reads through ConsistentBatchClient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.sharding import ShardPlan
from repro_torch.core.versioning import (Generation, ShardReplica,
                                         rolling_update)


@dataclasses.dataclass
class PublishStats:
    publishes: int = 0
    rows_published: int = 0
    rolling_steps: int = 0


class DeltaPublisher:
    """Accumulate touched row ids; publish value snapshots as versioned
    generations across a replicated shard fleet."""

    def __init__(self, plan: ShardPlan, replicas: list[list[ShardReplica]],
                 start_version: int = 1):
        self.plan = plan
        self.replicas = replicas
        self.version = start_version
        self._touched: set[int] = set()
        self.stats = PublishStats()

    def touch(self, ids: np.ndarray):
        ids = np.asarray(ids).reshape(-1)
        self._touched.update(int(i) for i in ids[ids >= 0])

    @property
    def pending(self) -> int:
        return len(self._touched)

    def publish(self, values_for_rows, interleave=None) -> int:
        """Cut version+1 from the current parameters.

        ``values_for_rows(rows) -> np.ndarray`` reads current values for the
        touched rows (e.g. a slice of the embedding table).  ``interleave``
        is an optional callable invoked after every rolling-update step
        (e.g. to serve queries mid-update in tests).  Returns the new
        version."""
        if not self._touched:
            return self.version
        rows = np.fromiter(self._touched, dtype=np.int64)
        vals = np.asarray(values_for_rows(rows))
        self.version += 1
        owners = self.plan.shard_of_np(rows.astype(np.uint64))
        gens = []
        for s in range(self.plan.n_shards):
            sel = owners == s
            gens.append(Generation(self.version,
                                   rows[sel].astype(np.uint64), vals[sel]))
        for ev in rolling_update(self.replicas, gens):
            self.stats.rolling_steps += 1
            if interleave is not None:
                interleave(ev)
        self.stats.publishes += 1
        self.stats.rows_published += len(rows)
        self._touched.clear()
        return self.version
