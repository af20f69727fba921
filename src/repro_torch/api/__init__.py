"""FeatureService API v2 — the single serving surface, over the torch engine.

One typed request/response protocol over every storage face:

  - ``types``    — ``QueryRequest`` / ``QueryResponse`` / ``UpdateRequest``
                   dataclasses carrying per-request QoS class
                   (``RANKING > RETRIEVAL > PREFETCH``) and consistency
                   requirement (``latest`` / ``pinned`` / ``hinted`` /
                   ``min_version``);
  - ``backends`` — the ``BatchQueryBackend`` protocol plus its four
                   implementations: ``EngineBackend`` (MultiTableEngine),
                   ``StoreBackend`` (standalone HybridKVStore tables),
                   ``ClusterBackend`` (replica fleets), and
                   ``FabricBackend`` (a multi-process serving fabric's
                   router);
  - ``client``   — ``FeatureClient``, the session object every caller
                   uses; it fronts either a server (QoS-laned concurrent
                   micro-batching) or a bare backend (direct calls).
"""
from repro_torch.api.types import (Consistency, ConsistencyError, QoSClass,
                                   QueryRequest, QueryResponse, UpdateRequest)
from repro_torch.api.backends import (BatchQueryBackend, ClusterBackend,
                                      EngineBackend, FabricBackend,
                                      StoreBackend, as_backend)
from repro_torch.api.client import FeatureClient

__all__ = [
    "BatchQueryBackend", "ClusterBackend", "Consistency", "ConsistencyError",
    "EngineBackend", "FabricBackend", "FeatureClient", "QoSClass",
    "QueryRequest", "QueryResponse", "StoreBackend", "UpdateRequest",
    "as_backend",
]
