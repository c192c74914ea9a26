"""Typed counter / gauge / histogram registry with Prometheus exposition.

A copy of the JAX package's ``obs/metrics.py`` (which the port may not
import): backs the ``dev_stats`` view of
:class:`~repro_torch.index.engine.QueryEngine` (a read-only compatibility
view, :class:`DevStatsView`).

Design points:

* **Typed metrics.**  A :class:`MetricsRegistry` owns named metrics, each
  one of three kinds: :class:`Counter` (monotone ``inc``), :class:`Gauge`
  (``set``), :class:`Histogram` (``observe`` into fixed buckets).
  Registering the same name twice raises — the registry lint
  (``tools/registry_lint.py lint_metrics``) checks that, plus snake_case
  names and consistent label sets across engine instances.

* **Labels.**  The label vocabulary is fixed: :data:`LABEL_KEYS` =
  ``(engine, shard, placement, mode, codec, tenant, outcome)``.  A registry
  carries constant labels (e.g. ``engine="q3", shard="s1"``) stamped on
  every exposition line; individual metrics may declare extra per-sample
  label names (e.g. a latency histogram labelled by ``placement``).

* **Scoped sampling.**  Counters accumulate for the life of their owner —
  there is deliberately no ``reset()`` (resetting under a live server would
  tear half-formed deltas).  Per-call assertions use ``scoped()``::

      with engine.metrics.scoped() as s:
          engine.execute(plan)
      assert s.delta("worklist_decodes") == 0

* **Prometheus text exposition.**  ``to_prometheus()`` renders the 0.0.4
  text format (``# HELP`` / ``# TYPE`` + one line per label set; histograms
  expose ``_bucket`` / ``_sum`` / ``_count``), wired into
  ``ServerStats.snapshot(prometheus=True)`` and ``launch.serve
  --metrics-out``.
"""

from __future__ import annotations

import math
import threading
from typing import Mapping

# the full label vocabulary — lint rejects metrics labelled outside it
LABEL_KEYS = ("engine", "shard", "placement", "mode", "codec", "tenant",
              "outcome")

_DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                    500.0, 1000.0, 2500.0, float("inf"))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._vals: dict = {}

    def _key(self, labels: Mapping) -> tuple:
        if labels and set(labels) - set(self.labelnames):
            extra = sorted(set(labels) - set(self.labelnames))
            raise ValueError(
                f"metric {self.name!r} has no label(s) {extra}; declared: "
                f"{list(self.labelnames)}")
        return tuple(str(labels.get(k, "")) for k in self.labelnames)

    def samples(self) -> list:
        """[(labels_tuple, value)] snapshot."""
        with self._lock:
            return list(self._vals.items())

    def total(self) -> float:
        """Sum across label sets (counters/gauges)."""
        with self._lock:
            return sum(self._vals.values())


class Counter(_Metric):
    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease by {n}")
        key = self._key(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._vals.get(self._key(labels), 0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._vals[self._key(labels)] = v

    def value(self, **labels) -> float:
        with self._lock:
            return self._vals.get(self._key(labels), 0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(b) or b[-1] != float("inf"):
            raise ValueError(
                f"histogram {name!r} buckets must be ascending and end at "
                f"+Inf, got {b}")
        self.buckets = b

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            st = self._vals.get(key)
            if st is None:
                st = self._vals[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0, "n": 0}
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    st["counts"][i] += 1
                    break
            st["sum"] += v
            st["n"] += 1

    def total(self) -> float:
        with self._lock:
            return sum(st["n"] for st in self._vals.values())


class ScopedSample:
    """Counter deltas over a ``with`` block (or since entry, if still
    open) — the replacement for hand-rolled before/after subtraction."""

    def __init__(self, registry: "MetricsRegistry"):
        self._reg = registry
        self._start: dict = {}
        self._end: dict = None

    def _totals(self) -> dict:
        return {name: m.total() for name, m in self._reg.metrics().items()
                if m.kind == "counter"}

    def __enter__(self) -> "ScopedSample":
        self._start = self._totals()
        self._end = None
        return self

    def __exit__(self, *exc):
        self._end = self._totals()
        return False

    def delta(self, name: str) -> float:
        """Counter ``name``'s increase across the scope (current value if
        the scope is still open; 0 baseline for counters created inside)."""
        end = self._end if self._end is not None else self._totals()
        if name not in end:
            raise KeyError(f"no counter {name!r} in registry "
                           f"{self._reg.describe()}")
        d = end[name] - self._start.get(name, 0)
        return int(d) if float(d).is_integer() else d

    def deltas(self) -> dict:
        end = self._end if self._end is not None else self._totals()
        return {k: v - self._start.get(k, 0) for k, v in end.items()}


class MetricsRegistry:
    """One owner's metric namespace (an engine, a server).  ``const_labels``
    are stamped on every exposition line; per-metric ``labelnames`` add
    sample-time dimensions.  Duplicate registration raises."""

    def __init__(self, namespace: str = "repro",
                 const_labels: Mapping = None):
        self.namespace = namespace
        self.const_labels = dict(const_labels or {})
        bad = set(self.const_labels) - set(LABEL_KEYS)
        if bad:
            raise ValueError(f"unknown const label(s) {sorted(bad)}; "
                             f"vocabulary: {LABEL_KEYS}")
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def describe(self) -> str:
        lbl = ",".join(f"{k}={v}" for k, v in sorted(self.const_labels.items()))
        return f"{self.namespace}{{{lbl}}}"

    def relabel(self, **const_labels) -> "MetricsRegistry":
        """Update constant labels (e.g. stamping a sub-engine's shard)."""
        bad = set(const_labels) - set(LABEL_KEYS)
        if bad:
            raise ValueError(f"unknown const label(s) {sorted(bad)}; "
                             f"vocabulary: {LABEL_KEYS}")
        self.const_labels.update(const_labels)
        return self

    def _register(self, cls, name: str, help: str, labelnames: tuple,
                  **kw) -> _Metric:
        bad = set(labelnames) - set(LABEL_KEYS)
        if bad:
            raise ValueError(f"metric {name!r} labelled outside the "
                             f"vocabulary: {sorted(bad)}; allowed: "
                             f"{LABEL_KEYS}")
        if name in self._metrics:
            raise ValueError(f"metric {name!r} already registered in "
                             f"{self.describe()}")
        m = cls(name, help, tuple(labelnames), self._lock, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def metrics(self) -> dict:
        return dict(self._metrics)

    def inc(self, name: str, n: float = 1, **labels) -> None:
        """Increment counter ``name`` — the engine hot-path shorthand."""
        self._metrics[name].inc(n, **labels)

    def value(self, name: str, **labels) -> float:
        m = self._metrics[name]
        if labels:
            return m.value(**labels)
        return m.total()

    def scoped(self) -> ScopedSample:
        return ScopedSample(self)

    # ---- exposition ------------------------------------------------------- #

    @staticmethod
    def _fmt_labels(pairs) -> str:
        body = ",".join(f'{k}="{v}"' for k, v in pairs if v != "")
        return f"{{{body}}}" if body else ""

    @staticmethod
    def _fmt_val(v: float) -> str:
        if v == float("inf"):
            return "+Inf"
        return repr(int(v)) if float(v).is_integer() else repr(float(v))

    def to_prometheus(self) -> str:
        """Prometheus 0.0.4 text exposition of every metric."""
        const = sorted(self.const_labels.items())
        out = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            full = f"{self.namespace}_{name}"
            out.append(f"# HELP {full} {m.help or name}")
            out.append(f"# TYPE {full} {m.kind}")
            for key, val in sorted(m.samples()):
                pairs = const + list(zip(m.labelnames, key))
                if m.kind == "histogram":
                    cum = 0
                    for ub, c in zip(m.buckets, val["counts"]):
                        cum += c
                        bl = self._fmt_labels(
                            pairs + [("le", self._fmt_val(ub))])
                        out.append(f"{full}_bucket{bl} {cum}")
                    lbl = self._fmt_labels(pairs)
                    out.append(f"{full}_sum{lbl} {self._fmt_val(val['sum'])}")
                    out.append(f"{full}_count{lbl} {val['n']}")
                else:
                    lbl = self._fmt_labels(pairs)
                    out.append(f"{full}{lbl} {self._fmt_val(val)}")
        return "\n".join(out) + "\n"

    def schema(self) -> dict:
        """{name: (kind, labelnames)} — what the lint compares across
        instances for label-set consistency."""
        return {n: (m.kind, m.labelnames) for n, m in self._metrics.items()}


class DevStatsView(Mapping):
    """Read-only mapping view over a registry's counters — the
    ``QueryEngine.dev_stats`` compatibility surface.  Reads are live
    (``view["worklist_decodes"]`` is the counter's current total);
    writes raise ``TypeError`` like any :class:`Mapping`."""

    def __init__(self, registry: MetricsRegistry, names: tuple):
        self._reg = registry
        self._names = tuple(names)

    def __getitem__(self, k: str):
        if k not in self._names:
            raise KeyError(k)
        v = self._reg.get(k).total()
        return int(v) if float(v).is_integer() else v

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __repr__(self):
        return f"DevStatsView({dict(self)!r})"


def nearest_rank(sorted_vals, q: float) -> float:
    """Deterministic percentile for tiny samples: the nearest-rank method
    with clamping — ``sorted_vals[min(max(ceil(q/100 * n), 1), n) - 1]``.

    Rule (documented contract, tested at n in {1, 2, 10}):

    * never interpolates and never indexes past the sample — every returned
      value is an observed one;
    * n == 1 -> the single sample for every q;
    * monotone in q, so p50 <= p99 <= p999 always holds;
    * q = 100 -> the maximum.
    """
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("nearest_rank of an empty sample")
    r = min(max(int(math.ceil(q / 100.0 * n)), 1), n)
    return float(sorted_vals[r - 1])
