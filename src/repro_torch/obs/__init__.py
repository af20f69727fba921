"""Dependency-free observability for the port: sampled per-request
tracing (``trace``), copied from the JAX package's ``obs/``.  Stdlib only.
The metrics registry, its exposition and bridges wait (ROADMAP queue 1,
item 12)."""
from repro_torch.obs.trace import Span, Tracer, sort_timeline

__all__ = ["Span", "Tracer", "sort_timeline"]
