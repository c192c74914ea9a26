"""Observability for the port: span tracing and typed metrics.

``obs.trace``
    Span tracer (context-manager API, monotonic clocks, parent/child nesting)
    plus a Chrome trace-event exporter; ``fence`` waits on the card.
``obs.metrics``
    Typed counter / gauge / histogram registry; ``QueryEngine.dev_stats`` is
    a read-only view over the engine's registry.
``obs.regress``
    The perf-regression gate over ``BENCH_*.json`` reports, a copy of the
    JAX package's (per-metric tolerances and hard invariants).
"""

from .trace import (Span, Tracer, get_tracer, set_tracer, enable_tracing,
                    to_chrome_trace, trace_coverage)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DevStatsView, nearest_rank, LABEL_KEYS)
from .regress import (GateResult, Violation, compare_reports,
                      check_invariants, run_gate, synthesize_regression)

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "enable_tracing",
    "to_chrome_trace", "trace_coverage",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DevStatsView",
    "nearest_rank", "LABEL_KEYS",
    "GateResult", "Violation", "compare_reports", "check_invariants",
    "run_gate", "synthesize_regression",
]
