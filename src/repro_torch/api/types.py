"""Typed request/response protocol for the FeatureService (API v2).

Every query against the batch-query architecture — whatever storage answers
it — is a ``QueryRequest``: per-table key sets, a QoS class, a consistency
requirement, and an optional latency budget.  Every answer is a
``QueryResponse`` (a ``core.engine.QueryResult`` plus serving metadata), and
every data mutation is an ``UpdateRequest`` covering both the full-publish
and incremental-delta paths.

QoS classes order the serving lanes: ``RANKING`` (the user-facing scoring
request, Monolith's "predict" class) outranks ``RETRIEVAL`` (candidate
generation) outranks ``PREFETCH`` (speculative cache warming).  Under
backpressure the scheduler sheds PREFETCH before RANKING and serves lanes
by weight, so the paper's millisecond answer survives overload for the
traffic that needs it.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np

# torch-free on purpose: shard-server processes import the protocol types
# without dragging in the engine (core/query_types.py)
from repro_torch.core.query_types import (EmbeddingTable, QueryResult,
                                          ScalarTable, TableResult)

__all__ = [
    "Consistency", "ConsistencyError", "QoSClass", "QueryRequest",
    "QueryResponse", "TableResult", "UpdateRequest",
]


class ConsistencyError(RuntimeError):
    """The served version cannot satisfy the request's consistency
    requirement (e.g. ``min_version`` newer than anything published)."""


class QoSClass(enum.IntEnum):
    """Per-request service class; smaller value = higher priority."""

    RANKING = 0     # user-facing scoring — never shed while lower waits
    RETRIEVAL = 1   # candidate generation — latency-sensitive, sheddable
    PREFETCH = 2    # speculative warming — first to shed under pressure

    @classmethod
    def parse(cls, value) -> "QoSClass":
        """Coerce a class or its name; unknown names are a ``ValueError``
        (satellite: misconfigured policies fail at construction, not at
        serve time)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            try:
                return cls[value.upper()]
            except KeyError:
                pass
        raise ValueError(
            f"unknown QoS class {value!r}; expected one of "
            f"{[c.name for c in cls]}")


@dataclasses.dataclass(frozen=True)
class Consistency:
    """What version the rows must come from.

    - ``latest()``          — newest retained build (the default);
    - ``pinned(v)``         — exactly ``v``; ``VersionEvictedError`` if the
                              retention window dropped it (the strict pin);
    - ``hinted(v)``         — prefer ``v``, accept the protocol NACK ->
                              re-pin to newest (the paper's client design);
    - ``min_version(v)``    — any build ``>= v``: read-your-writes after a
                              ``publish_delta``, ``ConsistencyError`` if
                              nothing that new is published.
    """

    mode: str = "latest"
    version: Optional[int] = None

    _MODES = ("latest", "pinned", "hinted", "min_version")

    def __post_init__(self):
        if self.mode not in self._MODES:
            raise ValueError(f"unknown consistency mode {self.mode!r}; "
                             f"expected one of {self._MODES}")
        if self.mode == "latest":
            if self.version is not None:
                raise ValueError("latest consistency takes no version")
        elif self.version is None:
            raise ValueError(f"{self.mode} consistency requires a version")

    # -- constructors ---------------------------------------------------
    @classmethod
    def latest(cls) -> "Consistency":
        return cls()

    @classmethod
    def pinned(cls, version: int) -> "Consistency":
        return cls("pinned", int(version))

    @classmethod
    def hinted(cls, version: int) -> "Consistency":
        return cls("hinted", int(version))

    @classmethod
    def min_version(cls, version: int) -> "Consistency":
        return cls("min_version", int(version))

    # -- resolution to the engine's (version, strict) pin ---------------
    def pin_args(self) -> tuple[Optional[int], bool]:
        """The ``(version, strict)`` pair the storage layer pins with;
        ``min_version`` pins latest and is checked via ``check``."""
        if self.mode == "pinned":
            return self.version, True
        if self.mode == "hinted":
            return self.version, False
        return None, False

    def check(self, served_version: int) -> None:
        """Post-serve check for ``min_version`` (the pin itself guarantees
        the other modes)."""
        if self.mode == "min_version" and served_version < self.version:
            raise ConsistencyError(
                f"min_version={self.version} but the query was answered "
                f"from version {served_version} (a build that new may have "
                f"published after this query pinned — retry)")


def _coerce_tables(tables: dict) -> dict[str, np.ndarray]:
    if not isinstance(tables, dict) or not tables:
        raise ValueError("request needs a non-empty {table: keys} mapping")
    out = {}
    for name, keys in tables.items():
        if not isinstance(name, str) or not name:
            raise ValueError(f"table names must be non-empty str, "
                             f"got {name!r}")
        out[name] = np.asarray(keys, dtype=np.uint64).ravel()
    return out


@dataclasses.dataclass
class QueryRequest:
    """One typed query: per-table key sets + QoS + consistency + budget.

    ``trace`` is the optional tracing context (``{"trace_id": ...,
    "parent_id": ...}``) stamped at the sampling edge; servers that see
    it record spans for this request (obs/trace.py) and carry it across
    the wire, so a fabric query yields one cross-process timeline."""

    tables: dict[str, np.ndarray]
    qos: QoSClass = QoSClass.RANKING
    consistency: Consistency = dataclasses.field(default_factory=Consistency)
    budget_s: Optional[float] = None
    trace: Optional[dict] = None

    def __post_init__(self):
        self.tables = _coerce_tables(self.tables)
        self.qos = QoSClass.parse(self.qos)
        if not isinstance(self.consistency, Consistency):
            raise ValueError("consistency must be a Consistency, e.g. "
                             "Consistency.pinned(v)")
        if self.budget_s is not None and not self.budget_s > 0:
            raise ValueError(f"budget_s must be positive, "
                             f"got {self.budget_s}")
        if self.trace is not None and (
                not isinstance(self.trace, dict)
                or not isinstance(self.trace.get("trace_id"), str)):
            raise ValueError("trace must be None or a dict with a "
                             "'trace_id' str")

    @property
    def n_keys(self) -> int:
        return sum(len(k) for k in self.tables.values())


@dataclasses.dataclass
class QueryResponse(QueryResult):
    """A ``QueryResult`` plus serving metadata — what the protocol returns
    everywhere a raw engine result used to leak through.  ``version`` is
    the ONE build every row of every table came from."""

    qos: QoSClass = QoSClass.RANKING
    latency_s: float = float("nan")
    batch_id: int = -1                 # -1: direct (unbatched) backend call
    # spans recorded for this request (list of Span.to_wire dicts) when it
    # carried a trace context; the router merges shard-side lists here
    trace: Optional[list] = None

    @classmethod
    def from_result(cls, result: QueryResult, *, qos: QoSClass,
                    latency_s: float, batch_id: int = -1,
                    trace: Optional[list] = None) -> "QueryResponse":
        return cls(version=result.version, tables=result.tables, qos=qos,
                   latency_s=latency_s, batch_id=batch_id, trace=trace)


@dataclasses.dataclass
class UpdateRequest:
    """One data mutation: a full publish (``scalars``/``embeddings``) or an
    incremental delta (``upserts``/``deletes``), never both."""

    version: int
    upserts: dict = dataclasses.field(default_factory=dict)
    deletes: dict = dataclasses.field(default_factory=dict)
    scalars: Sequence[ScalarTable] = ()
    embeddings: Sequence[EmbeddingTable] = ()

    def __post_init__(self):
        self.version = int(self.version)
        full = bool(self.scalars) or bool(self.embeddings)
        delta = bool(self.upserts) or bool(self.deletes)
        if full and delta:
            raise ValueError("an UpdateRequest is a full publish OR a "
                             "delta, not both")
        if not full and not delta:
            raise ValueError(
                "empty UpdateRequest: pass upserts/deletes (delta) or "
                "scalars/embeddings (full publish) — bumping the live "
                "version with zero data change would publish a phantom "
                "generation")

    @property
    def is_delta(self) -> bool:
        return not (self.scalars or self.embeddings)
