"""Automatic sharding of attribute/embedding tables (paper §2.2.1).

The subsystem is organized per-table: each table maps to a query service with
its own shard count, chosen so no shard exceeds a configured byte budget
(smaller shards start faster, migrate faster, recover faster).  When a table
grows or shrinks past the bound during an update cycle, the next publish
re-shards and the movement plan is synchronized to the live cluster.

Key->shard assignment is hash-based (the same 32-bit mix the index uses), so
clients can route without consulting a directory — only the shard *count* per
version is needed, which travels in the query protocol (core/versioning.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import hashcore as hc


@dataclasses.dataclass(frozen=True)
class TableSpec:
    name: str
    n_rows: int
    bytes_per_row: int

    @property
    def total_bytes(self) -> int:
        return self.n_rows * self.bytes_per_row


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    table: TableSpec
    n_shards: int
    max_shard_bytes: int
    version: int = 0

    @property
    def rows_per_shard_estimate(self) -> int:
        return math.ceil(self.table.n_rows / self.n_shards)

    def shard_of_np(self, keys: np.ndarray) -> np.ndarray:
        hi, lo = hc.key_split_np(np.asarray(keys, dtype=np.uint64))
        return (hc.hash64_np(hi, lo) % np.uint32(self.n_shards)).astype(
            np.int32)

    def shard_of(self, key: int) -> int:
        hi, lo = hc.key_split_int(int(key))
        return hc.hash64_int(hi, lo) % self.n_shards

    def partition(self, keys: np.ndarray) -> list[np.ndarray]:
        """Row indices per shard (build-time partitioning of a key set)."""
        s = self.shard_of_np(keys)
        return [np.flatnonzero(s == i) for i in range(self.n_shards)]


def plan_shards(table: TableSpec, max_shard_bytes: int,
                version: int = 0) -> ShardPlan:
    """The paper's config-driven sizing: smallest shard count such that the
    expected shard stays under the byte budget (with 10% skew headroom)."""
    if max_shard_bytes <= 0:
        raise ValueError("max_shard_bytes must be positive")
    raw = table.total_bytes / max_shard_bytes
    n = max(1, math.ceil(raw * 1.1))
    return ShardPlan(table=table, n_shards=n, max_shard_bytes=max_shard_bytes,
                     version=version)


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """Movement plan between two shard layouts of one table."""
    old: ShardPlan
    new: ShardPlan
    moved_fraction: float
    moves: Optional[np.ndarray] = None    # [n_sampled] (old_shard, new_shard)

    def describe(self) -> str:
        return (f"{self.old.table.name}: {self.old.n_shards} -> "
                f"{self.new.n_shards} shards, ~{self.moved_fraction:.1%} "
                f"rows move")


def plan_reshard(old: ShardPlan, new_table: TableSpec, max_shard_bytes: int,
                 sample_keys: Optional[np.ndarray] = None) -> ReshardPlan:
    """Next-update-cycle re-sharding (paper: 're-sharding occurs during the
    next update cycle, with updated metadata synchronized')."""
    new = plan_shards(new_table, max_shard_bytes, version=old.version + 1)
    if sample_keys is None:
        rng = np.random.default_rng(0)
        sample_keys = rng.integers(0, 2**63, size=min(65536,
                                                      max(new_table.n_rows, 1)),
                                   dtype=np.uint64)
    so = old.shard_of_np(sample_keys)
    sn = new.shard_of_np(sample_keys)
    # shard counts differ => same hash, different modulus
    moved = float(np.mean((so % min(old.n_shards, new.n_shards))
                          != (sn % min(old.n_shards, new.n_shards)))
                  if old.n_shards != new.n_shards else 0.0)
    if old.n_shards != new.n_shards:
        moved = float(np.mean(so != sn))
    return ReshardPlan(old=old, new=new, moved_fraction=moved,
                       moves=np.stack([so, sn], axis=1))


def shards_to_mesh_axis(n_shards: int, axis_size: int) -> np.ndarray:
    """Round-robin placement of table shards onto mesh 'model' slots."""
    return np.arange(n_shards, dtype=np.int32) % axis_size
