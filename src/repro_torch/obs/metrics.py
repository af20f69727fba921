"""Process-wide metrics registry: thread-safe Counter / Gauge / Histogram.
A copy of the JAX package's ``obs/metrics.py``.

Deliberately tiny and stdlib-only (no prometheus_client, no numpy, no
torch) so a process that serves only metrics need not load the device
runtime.  The exposition side lives in :mod:`repro_torch.obs.exporter`.

Concurrency contract: every metric owns a
lock guarding its label→value map, and the registry owns a lock guarding
the name→metric map plus the collector list.  Collectors are snapshotted
under the lock but *invoked outside it*, so a collector may itself create
metrics or set values without deadlocking.
"""
from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Seconds-scale latency buckets: 0.1 ms .. 10 s, roughly log-spaced.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0, float("inf"))

# One exposition sample: (suffix appended to the metric name, extra
# labels merged over the series labels, value).
Sample = Tuple[str, Tuple[Tuple[str, str], ...], float]


def _check_name(name: str) -> str:
    if not _METRIC_NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _check_labelnames(labelnames: Sequence[str]) -> Tuple[str, ...]:
    out = tuple(labelnames)
    for ln in out:
        if not _LABEL_NAME_RE.match(ln) or ln.startswith("__"):
            raise ValueError(f"invalid label name {ln!r}")
    if len(set(out)) != len(out):
        raise ValueError(f"duplicate label names in {out!r}")
    return out


class Metric:
    """Base: one named family of labelled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = _check_labelnames(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}  # guarded-by: _lock (strict)

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _labelpairs(self, key: Tuple[str, ...]) -> Tuple[Tuple[str, str], ...]:
        return tuple(zip(self.labelnames, key))

    def samples(self) -> List[Sample]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing count.

    ``inc`` is the write face for code that owns the count; ``set_total``
    is the bridge face for scrape-time collectors that adopt a monotonic
    total maintained elsewhere (e.g. a stats-silo snapshot).
    """

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter decrease ({amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(self._series.get(key, 0.0)) + amount

    def set_total(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels: object) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def samples(self) -> List[Sample]:
        with self._lock:
            items = sorted(self._series.items())
        return [("", self._labelpairs(k), float(v)) for k, v in items]


class Gauge(Metric):
    """A value that can go up and down."""

    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(self._series.get(key, 0.0)) + amount

    def dec(self, amount: float = 1.0, **labels: object) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: object) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def samples(self) -> List[Sample]:
        with self._lock:
            items = sorted(self._series.items())
        return [("", self._labelpairs(k), float(v)) for k, v in items]


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics).

    Per-series state is ``[count_b0, count_b1, ..., sum]`` with
    *non*-cumulative per-bucket counts; ``samples()`` renders the
    cumulative ``le`` view plus ``_sum`` and ``_count``.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{name}: empty bucket list")
        if bs[-1] != float("inf"):
            bs.append(float("inf"))
        if len(set(bs)) != len(bs):
            raise ValueError(f"{name}: duplicate buckets")
        self.buckets: Tuple[float, ...] = tuple(bs)

    def observe(self, value: float, **labels: object) -> None:
        v = float(value)
        key = self._key(labels)
        i = 0
        for i, ub in enumerate(self.buckets):  # noqa: B007 — small tuple
            if v <= ub:
                break
        with self._lock:
            buf = self._series.get(key)
            if buf is None:
                buf = [0] * len(self.buckets) + [0.0]
                self._series[key] = buf
            buf[i] += 1
            buf[-1] += v

    def samples(self) -> List[Sample]:
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._series.items())
        out: List[Sample] = []
        for key, buf in items:
            base = self._labelpairs(key)
            running = 0
            for ub, n in zip(self.buckets, buf[:-1]):
                running += n
                le = "+Inf" if ub == float("inf") else format(ub, "g")
                out.append(("_bucket", base + (("le", le),), float(running)))
            out.append(("_count", base, float(running)))
            out.append(("_sum", base, float(buf[-1])))
        return out


class Registry:
    """Get-or-create home for metrics plus scrape-time collectors.

    A *collector* is a zero-arg callable run at the top of every
    ``collect()``; bridges use it to pull a fresh snapshot out of an
    existing stats silo and push it into registry metrics, so the silo
    stays the single source of truth and pays nothing between scrapes.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}  # guarded-by: _lock (strict)
        self._collectors: List[Callable[[], None]] = []  # guarded-by: _lock (strict)

    def _get_or_create(self, cls: type, name: str, help: str,
                       labelnames: Sequence[str],
                       **kwargs: object) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise ValueError(
                f"{name}: registered as {m.kind}, requested {cls.kind}")
        if tuple(labelnames) != m.labelnames:
            raise ValueError(
                f"{name}: registered with labels {m.labelnames}, "
                f"requested {tuple(labelnames)}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Metric]:
        """Run collectors, then return metrics sorted by name."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()   # outside the lock: collectors may create/set metrics
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]


# Process-default registry.  Library code takes a Registry parameter and
# defaults to this, so tests can use private registries.
REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY
