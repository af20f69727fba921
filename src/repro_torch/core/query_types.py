"""Table specs + query result records, jax-free (the serving data plane).

These types used to live in ``core/engine.py``; the fabric pulled them out
so a shard-server process can import the whole serving path —
``HybridKVStore`` -> ``StoreBackend`` -> ``QueryServer`` -> wire codec —
without paying the engine's jax import (seconds of spawn latency per
replica, and a dependency a storage-only process has no use for).
``core.engine`` re-exports every name, so existing imports keep working.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# table specs (what a publish installs)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScalarTable:
    """Attribute table: uint64 key -> <=52-bit payload."""
    name: str
    keys: np.ndarray
    payloads: np.ndarray
    variant: str = "neighborhash"
    load_factor: float = 0.8


@dataclasses.dataclass(frozen=True)
class EmbeddingTable:
    """Value table: uint64 key -> uint8[value_bytes] row.  ``hot_fraction``
    1.0 keeps every row in memory; below 1.0 the tail lives in the simulated
    NVMe tier (core/hybrid_store.py)."""
    name: str
    keys: np.ndarray
    values: np.ndarray            # uint8 [n, value_bytes]
    hot_fraction: float = 1.0
    variant: str = "neighborhash"


# ---------------------------------------------------------------------------
# query results (what every backend returns)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TableResult:
    found: np.ndarray             # bool [n_request_keys]
    payloads: Optional[np.ndarray] = None   # uint64, scalar tables
    values: Optional[np.ndarray] = None     # uint8 [n, vb], embedding tables


@dataclasses.dataclass
class QueryResult:
    version: int
    tables: dict[str, TableResult]

    def __getitem__(self, name: str) -> TableResult:
        return self.tables[name]


class VersionEvictedError(KeyError):
    """Strict query pinned a version no longer in the retention window."""
