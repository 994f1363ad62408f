"""Serving telemetry of the port (``repro.obs``'s counterpart): clock-driven
tracing, the closed metrics catalog, and Prometheus / JSON / Perfetto
exporters.

Dark by default: ``NULL_TRACER`` and ``metrics=None`` are the defaults
everywhere, and then nothing reads a clock.  Attach a ``Tracer`` (bound to
a ``serve.clock.Clock``) and a ``MetricsRegistry`` to light it up.
"""
from repro_torch.obs.metrics import (
    CATALOG,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ServingInstruments,
    default_registry,
)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer
from repro_torch.obs import export

__all__ = [
    "CATALOG",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ServingInstruments",
    "default_registry",
    "NULL_TRACER",
    "NullTracer",
    "Span",
    "Tracer",
    "export",
]
