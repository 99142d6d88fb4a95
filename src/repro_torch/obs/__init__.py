"""Observability for the port: timer aliases, spans and the metrics
registry (the same schema as the JAX package's ``repro.obs``)."""
from . import clock, metrics, trace
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Span, Tracer, capture, enabled, event, span

__all__ = ["clock", "metrics", "trace", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "Span", "Tracer", "capture", "enabled",
           "event", "span"]
