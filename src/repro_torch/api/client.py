"""``FeatureClient`` — the one session object callers query features with.

A client fronts either a ``serve/server.QueryServer`` (requests ride the
QoS-laned concurrent micro-batcher) or a bare ``BatchQueryBackend``
(direct, synchronous).  Either way the caller speaks ``QueryRequest`` in
and ``QueryResponse`` out; no raw ``{table: keys}`` dict ever reaches a
server ``submit`` again.

Example::

    client = FeatureClient(server, default_qos=QoSClass.RANKING)
    res = client.query({"item_attr": ids}, budget_s=0.050)
    t = client.submit({"item_emb": ids}, qos="PREFETCH")   # async ticket
    client.update(version=7, upserts={"item_attr": (ids, payloads)})
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.api.backends import as_backend
from repro_torch.api.types import (Consistency, QoSClass, QueryRequest,
                                   QueryResponse, UpdateRequest)

__all__ = ["FeatureClient"]


class _DoneTicket:
    """Completed-at-submit handle a direct (serverless) client returns, so
    callers see one ticket shape whichever face they talk to — including
    the server Ticket's public ``batch_id``/``latency_s``/``deadline``
    attributes (batch_id -1: the request rode no micro-batch)."""

    def __init__(self, result: Optional[QueryResponse] = None,
                 error: Optional[BaseException] = None):
        self._result = result
        self._error = error
        self.deadline: Optional[float] = None
        self.batch_id: int = -1
        self.latency_s: Optional[float] = (
            result.latency_s if result is not None else None)

    def done(self) -> bool:
        return True

    def result(self, timeout: Optional[float] = None) -> QueryResponse:
        if self._error is not None:
            raise self._error
        return self._result


class FeatureClient:
    """Session over a QueryServer or a bare backend.

    Per-call ``qos`` / ``consistency`` / ``budget_s`` override the session
    defaults; ``tables`` may be a raw ``{table: keys}`` dict (normalized
    into a ``QueryRequest`` here) or a prebuilt ``QueryRequest``."""

    def __init__(self, target, *,
                 default_qos: QoSClass = QoSClass.RANKING,
                 default_consistency: Optional[Consistency] = None,
                 default_budget_s: Optional[float] = None):
        # a QueryServer exposes the laned submit + its backend; anything
        # else must satisfy (or coerce to) the backend protocol
        if hasattr(target, "submit") and hasattr(target, "backend"):
            self.server = target
            self.backend = target.backend
        else:
            self.server = None
            self.backend = as_backend(target)
        self.default_qos = QoSClass.parse(default_qos)
        self.default_consistency = default_consistency or Consistency()
        self.default_budget_s = default_budget_s

    # ------------------------------------------------------------------
    def _build(self, tables, qos, consistency, budget_s) -> QueryRequest:
        if isinstance(tables, QueryRequest):
            if qos is not None or consistency is not None \
                    or budget_s is not None:
                raise ValueError("pass overrides inside the QueryRequest, "
                                 "not alongside it")
            return tables
        return QueryRequest(
            tables=tables,
            qos=self.default_qos if qos is None else qos,
            consistency=(self.default_consistency if consistency is None
                         else consistency),
            budget_s=(self.default_budget_s if budget_s is None
                      else budget_s))

    def submit(self, tables, *, qos=None,
               consistency: Optional[Consistency] = None,
               budget_s: Optional[float] = None):
        """Async face: returns a ticket whose ``result()`` yields a
        ``QueryResponse`` (or re-raises the typed shed / consistency
        error).  Direct-backend clients execute inline and return an
        already-done ticket — budgets only mean something with a server's
        admission queue in front."""
        req = self._build(tables, qos, consistency, budget_s)
        if self.server is not None:
            return self.server.submit(req)
        version, strict = req.consistency.pin_args()
        t0 = time.monotonic()
        try:
            inflight = self.backend.begin(req.tables, version=version,
                                          strict=strict)
            result = self.backend.finish(inflight)
            req.consistency.check(result.version)
        except BaseException as e:  # noqa: BLE001 — delivered via ticket
            return _DoneTicket(error=e)
        return _DoneTicket(QueryResponse.from_result(
            result, qos=req.qos, latency_s=time.monotonic() - t0))

    def query(self, tables, *, qos=None,
              consistency: Optional[Consistency] = None,
              budget_s: Optional[float] = None,
              timeout: Optional[float] = None) -> QueryResponse:
        """Synchronous face: submit + wait."""
        return self.submit(tables, qos=qos, consistency=consistency,
                           budget_s=budget_s).result(timeout)

    # ------------------------------------------------------------------
    def update(self, version: int, *, upserts: Optional[dict] = None,
               deletes: Optional[dict] = None, scalars=(), embeddings=()
               ) -> None:
        """Publish through the protocol: a delta (upserts/deletes) or a
        full table set, whichever the ``UpdateRequest`` carries."""
        self.backend.apply_update(UpdateRequest(
            version=version, upserts=upserts or {}, deletes=deletes or {},
            scalars=scalars, embeddings=embeddings))

    @property
    def latest_version(self) -> int:
        return self.backend.latest_version

    @property
    def table_names(self) -> list[str]:
        return self.backend.table_names

    def stats_snapshot(self):
        """Server-side stats (None for a direct backend client)."""
        return (self.server.stats_snapshot()
                if self.server is not None else None)
