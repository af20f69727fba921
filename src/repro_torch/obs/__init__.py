"""Dependency-free observability for the port, copied from the JAX
package's ``obs/``: the metrics registry (``metrics``), its Prometheus text
exposition and ``/metrics`` endpoint (``exporter``), the bridges from the
stats silos into the registry (``bridge``) and sampled per-request tracing
(``trace``).  Stdlib only."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     REGISTRY, get_registry)
from repro_torch.obs.trace import Span, Tracer, sort_timeline

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "get_registry", "Span", "Tracer", "sort_timeline",
]
