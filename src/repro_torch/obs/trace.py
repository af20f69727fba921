"""Sampled per-request spans across the serving pipeline, copied from the
JAX package's ``obs/trace.py`` (stdlib only).

Span taxonomy for one request through a ``QueryServer`` (names are part
of the contract — the JAX package's ``docs/observability.md`` documents
them, and ``tests/test_torch_query_server.py`` asserts the full chain in
both packages):

    admission -> lane_wait -> coalesce -> version_pin -> begin
              -> device -> finish -> scatter

under a per-request ``serve`` root span.  In the port's server, ``begin``
is the engine's host staging plus the enqueue of its copies and probe
launches on the card, ``device`` the wait until a finish worker picks the
batch up, and ``finish`` the wait for the batch's event plus the inverse
gather and the hybrid store.  A multi-process fabric (not ported yet) adds
``route`` and per-shard ``shard_rpc`` spans and merges the shard-side span
lists carried back in the wire response into one cross-process timeline.

Timestamps are ``time.monotonic()``: CLOCK_MONOTONIC on Linux is a
system-wide clock, so spans stamped in different processes on the same
host share a comparable timebase.

Sampling: a tracer decides at the *edge* (``sample()``) whether a fresh
request gets a trace context.  Downstream tracers (``sample_rate=0``)
still record spans for requests that arrive with a context — the decision
is made once, at the outermost entry point.
"""
from __future__ import annotations

import collections
import os
import random
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple


def new_id() -> str:
    """A 64-bit random hex id (trace or span)."""
    return os.urandom(8).hex()


def now() -> float:
    return time.monotonic()


class Span:
    """One timed section of one request.  Plain record, wire-friendly."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "proc",
                 "t0", "t1", "tags")

    def __init__(self, trace_id: str, name: str, t0: float, t1: float,
                 parent_id: Optional[str] = None, proc: str = "",
                 span_id: Optional[str] = None,
                 tags: Optional[Dict[str, object]] = None):
        self.trace_id = trace_id
        self.span_id = span_id if span_id is not None else new_id()
        self.parent_id = parent_id
        self.name = name
        self.proc = proc
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.tags = dict(tags) if tags else {}

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_wire(self) -> Dict[str, object]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "proc": self.proc, "t0": self.t0, "t1": self.t1,
                "tags": self.tags}

    @classmethod
    def from_wire(cls, d: Dict[str, object]) -> "Span":
        return cls(trace_id=str(d["trace_id"]), name=str(d["name"]),
                   t0=float(d["t0"]), t1=float(d["t1"]),
                   parent_id=d.get("parent_id"),  # type: ignore[arg-type]
                   proc=str(d.get("proc", "")),
                   span_id=str(d["span_id"]),
                   tags=d.get("tags") or {})  # type: ignore[arg-type]

    def __repr__(self) -> str:
        return (f"Span({self.name!r} proc={self.proc!r} "
                f"[{self.t0:.6f},{self.t1:.6f}] trace={self.trace_id})")


class Tracer:
    """Collects finished spans per trace id, bounded by ``capacity``
    traces (oldest evicted first)."""

    def __init__(self, sample_rate: float = 0.0, capacity: int = 256,
                 proc: str = "main"):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(f"sample_rate {sample_rate} not in [0, 1]")
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self.proc = proc
        self._rng = random.Random(os.urandom(8))
        self._lock = threading.Lock()
        self._spans: Dict[str, List[Span]] = {}  # guarded-by: _lock (strict)
        self._order: Deque[str] = collections.deque()  # guarded-by: _lock (strict)
        self._sampled_total = 0  # guarded-by: _lock (strict)

    def sample(self) -> Optional[str]:
        """Edge decision: a fresh trace id if this request is sampled,
        else None.  ``sample_rate == 0`` short-circuits — this is the
        only tracing cost on an untraced hot path."""
        rate = self.sample_rate
        if rate <= 0.0:
            return None
        if rate < 1.0 and self._rng.random() >= rate:
            return None
        tid = new_id()
        with self._lock:
            self._sampled_total += 1
        return tid

    @property
    def sampled_total(self) -> int:
        with self._lock:
            return self._sampled_total

    def span(self, trace_id: str, name: str, t0: float, t1: float,
             parent_id: Optional[str] = None,
             span_id: Optional[str] = None,
             tags: Optional[Dict[str, object]] = None) -> Span:
        """Create a finished span and record it."""
        s = Span(trace_id, name, t0, t1, parent_id=parent_id,
                 proc=self.proc, span_id=span_id, tags=tags)
        self.record([s])
        return s

    def record(self, spans: List[Span]) -> None:
        with self._lock:
            for s in spans:
                bucket = self._spans.get(s.trace_id)
                if bucket is None:
                    bucket = []
                    self._spans[s.trace_id] = bucket
                    self._order.append(s.trace_id)
                bucket.append(s)
            while len(self._order) > self.capacity:
                evicted = self._order.popleft()
                self._spans.pop(evicted, None)

    def take(self, trace_id: str) -> List[Span]:
        """Remove and return all spans recorded for *trace_id*."""
        with self._lock:
            spans = self._spans.pop(trace_id, [])
            if spans:
                try:
                    self._order.remove(trace_id)
                except ValueError:
                    pass
        return spans

    def peek(self, trace_id: str) -> List[Span]:
        with self._lock:
            return list(self._spans.get(trace_id, ()))

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._order)


def sort_timeline(spans: List[Span]) -> List[Span]:
    """Spans ordered by start time — the merged cross-process view."""
    return sorted(spans, key=lambda s: (s.t0, s.t1))
