"""Single-host batch-query orchestration (paper Fig 2, query side).

Composes: automatic sharding (core/sharding.py) -> per-shard NeighborHash
tables -> batched device lookup (core/lookup.py) -> merge, with the strong-
version pinning protocol layered on top by core/versioning.py.  Each shard's
table is line-packed on the device once, when the service is built, and
every batch after moves only its queries.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import hashcore as hc
from repro_torch.core import lookup as lk
from repro_torch.core import neighborhash as nh
from repro_torch.core.sharding import ShardPlan, TableSpec, plan_shards
from repro_torch.kernels import neighbor_lookup as nl
from repro_torch.kernels import ops


@dataclasses.dataclass
class QueryStats:
    batches: int = 0
    keys: int = 0
    hits: int = 0
    dropped: int = 0


class BatchQueryService:
    """One table's query service: N shards, each a NeighborHash index over
    that shard's rows, answering merged batch queries on ``device``
    (default ``"cuda"``; ``"cpu"`` runs the plain probe)."""

    def __init__(self, keys: np.ndarray, payloads: np.ndarray, *,
                 name: str = "table", max_shard_bytes: int = 1 << 22,
                 variant: str = "neighborhash", load_factor: float = 0.8,
                 plan: Optional[ShardPlan] = None, device=None):
        keys = np.asarray(keys, dtype=np.uint64)
        payloads = np.asarray(payloads, dtype=np.uint64)
        spec = TableSpec(name=name, n_rows=len(keys), bytes_per_row=16)
        self.plan = plan or plan_shards(spec, max_shard_bytes)
        self.device = ops.resolve_device(device)
        self.shards: list[nh.HashTable] = []
        parts = self.plan.partition(keys)
        for rows in parts:
            self.shards.append(
                nh.build(keys[rows], payloads[rows], variant=variant,
                         load_factor=load_factor))
        # each shard's arrays on the device, and its probe, which packs
        # them into lines at its first call and keeps them (they never
        # change after the build)
        self._arrays = [{k: nl.to_device(v, self.device)
                         for k, v in t.device_arrays().items()}
                        for t in self.shards]
        self._probe = [lk.make_lookup_fn(t) for t in self.shards]
        self.stats = QueryStats()

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    def query(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Route keys to owning shards, batch-query each shard on device,
        merge results back into request order."""
        keys = np.asarray(keys, dtype=np.uint64)
        owners = self.plan.shard_of_np(keys)
        found = np.zeros(len(keys), dtype=bool)
        payloads = np.zeros(len(keys), dtype=np.uint64)
        for s in range(self.n_shards):
            mask = owners == s
            if not mask.any():
                continue
            q_hi, q_lo = hc.key_split_np(keys[mask])
            f, p_hi, p_lo = self._probe[s](self._arrays[s], q_hi, q_lo)
            found[mask] = f.cpu().numpy()
            payloads[mask] = (p_hi.cpu().numpy().astype(np.uint64)
                              << np.uint64(32)) | \
                p_lo.cpu().numpy().astype(np.uint64)
        self.stats.batches += 1
        self.stats.keys += len(keys)
        self.stats.hits += int(found.sum())
        return found, payloads
