"""Observability for the port: span tracing and typed metrics.

``obs.trace``
    Span tracer (context-manager API, monotonic clocks, parent/child nesting)
    plus a Chrome trace-event exporter; ``fence`` waits on the card, and a
    span is mirrored as a ``torch.profiler`` range while one records.
``obs.metrics``
    Typed counter / gauge / histogram registry; ``QueryEngine.dev_stats`` is
    a read-only view over the engine's registry.
"""

from .trace import (Span, Tracer, get_tracer, set_tracer, enable_tracing,
                    to_chrome_trace, trace_coverage)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DevStatsView, nearest_rank, LABEL_KEYS)

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "enable_tracing",
    "to_chrome_trace", "trace_coverage",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DevStatsView",
    "nearest_rank", "LABEL_KEYS",
]
