"""Span tracer for the serving stack, with a Perfetto-loadable exporter.

One :class:`Tracer` holds a bounded buffer of finished :class:`Span` records.
Spans are stamped with ``time.monotonic()`` — the same clock family as every
``TraceRecord`` stage stamp in the serving layer, so server lifecycle
spans and deep engine spans land on one comparable timeline.

Two usage styles:

* **Context manager** (nesting tracked per thread)::

      with tracer.span("and/round", lane="engine", r=2):
          ...                         # children opened here nest under it

* **Detached begin/end** for spans that cross threads or whose endpoints are
  externally stamped (the serving request lifecycle: a request span begins
  on the event loop at admission and ends on the executor thread at
  delivery)::

      sp = tracer.begin("serve/request", lane="serve", rid=7)
      ...
      tracer.end(sp, outcome="served")

The **disabled fast path** costs one attribute check: ``span()`` returns a
shared no-op context manager and ``begin()/end()`` return/accept ``None``.
Deep engine and kernel span sites go through the process-global tracer
(:func:`get_tracer`), disabled by default, so the serving hot path is
untouched unless tracing is explicitly enabled (``enable_tracing()`` or
``launch.serve --trace-out``).  The codec layer's spans come one per
encode and per whole-list decode call (four a Group-PFD list, one an
index block encoded at build), far more than the engine's, so they have
a switch of their own: ``enable_tracing(codec=True)``
(:func:`codec_tracer`).

**Fenced device timing** (off by default): ``tracer.fenced = True`` makes
``tracer.fence(x)`` call ``torch.cuda.synchronize`` for CUDA tensors inside
round spans, so a span's duration attributes device wall-clock to the kernel
that produced it instead of to whichever later op happens to force the value.

**One clock with the device trace.** While the tracer is enabled and a
``torch.profiler`` is recording, each context-manager span also opens a
``torch.profiler.record_function`` range of its name, so the profiler
stamps the span on its own clock, beside the kernels it launched (a
user-annotation event).  Whether a profiler records is one flag test; no
range is opened otherwise (a range costs more host time than its span).
Detached :meth:`Tracer.begin` / :meth:`Tracer.end` spans are not mirrored.

Counterpart of the JAX package's ``obs/trace.py``: the same spans and
exporter, with the two device hooks in torch.

Span taxonomy (the names emitted across the stack):

=====================  =====================================================
``serve/request``      admission -> delivery, one per request (detached)
``serve/close``        batch forming: seed pop -> batch close
``serve/batch``        batch close -> results stamped (executor thread)
``serve/plan``         ``engine.plan`` inside a served batch
``serve/execute``      ``engine.execute`` inside a served batch
``serve/deliver``      result split + trace records inside a served batch
``engine/plan``        plan resolution (any caller)
``engine/execute``     planned execution (any caller)
``and/seed``           resident AND round 0 (seed scatter)
``and/round``          one resident AND round (args: r, plain/fused/dense)
``and/tomb_gate``      live-bitmap AND of the seed (tombstone gating)
``ranked/round``       one ranked accumulate round (args: r, splits)
``ranked/tomb_gate``   OR-mode live-row gate upload
``ranked/rescore``     the exact float tail
``sharded/merge``      the one top-k merge collective per ranked batch
``decode/<codec>``     one per-codec arena decode call (work-list group)
``kernel/extract_ids`` final bitmap -> sorted docid extraction
``kernel/topk``        k-th threshold / top-k stats reduction
``decode_list/<codec>`` one whole-list ``Codec.torch.vec`` call (args: n,
                       and exc where the codec has exceptions); not an
                       arena decode: never summed with ``decode/<codec>``
``decode_list/widths`` Group-PFD's per-quad bit widths, inside the above
``decode_list/unpack`` Group-PFD's unpack of the four streams, inside it
``decode_list/patch`` Group-PFD's exception patch, inside it (opened when
                       the list has no exception too); these three on
                       the plain path alone (a CPU tensor): on the card a
                       list is one launch of kernel PFD
``encode/<codec>``     one ``Codec.encode`` call (args: n)
                       (these five with ``codec=True`` alone)
=====================  =====================================================

Engine spans carry ``lane="engine"`` (sub-engines: ``shard0``, ``shard1``,
...), serving spans ``lane="serve"``, arena and whole-list decodes
``lane="device"``, encodes ``lane="host"`` — the exporter gives each lane
its own named track.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_now = time.monotonic


class Span:
    """One finished (or in-flight) span.  ``t1`` is None until ended."""

    __slots__ = ("sid", "name", "lane", "t0", "t1", "parent_sid", "args")

    def __init__(self, sid: int, name: str, lane: str, t0: float,
                 parent_sid: int, args: dict):
        self.sid = sid
        self.name = name
        self.lane = lane
        self.t0 = t0
        self.t1 = None
        self.parent_sid = parent_sid
        self.args = args

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def __repr__(self):
        return (f"Span({self.name!r}, lane={self.lane!r}, sid={self.sid}, "
                f"parent={self.parent_sid}, t0={self.t0:.6f}, "
                f"dur={self.dur * 1e3:.3f}ms)")


class _Noop:
    """Shared do-nothing context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _profiler_range(name: str):
    """An entered ``torch.profiler.record_function`` range named ``name``
    where a ``torch.profiler`` is recording, else None (one flag test)."""
    if not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _SpanCM:
    """Context-manager span: nesting tracked on the tracer's per-thread
    stack, so children opened inside automatically parent to it; mirrored
    by a profiler range while a profiler records (module docstring)."""

    __slots__ = ("_tr", "_name", "_lane", "_args", "_span", "_range")

    def __init__(self, tr: "Tracer", name: str, lane: str, args: dict):
        self._tr = tr
        self._name = name
        self._lane = lane
        self._args = args
        self._span = None
        self._range = None

    def __enter__(self) -> Span:
        tr = self._tr
        self._range = _profiler_range(self._name)
        stack = tr._stack()
        parent = stack[-1].sid if stack else 0
        sp = Span(next(tr._ids), self._name, self._lane, _now(), parent,
                  self._args)
        stack.append(sp)
        self._span = sp
        return sp

    def __exit__(self, *exc):
        sp = self._span
        sp.t1 = _now()
        stack = self._tr._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        self._tr._record(sp)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Tracer:
    """Bounded, thread-safe span collector (see the module docstring)."""

    def __init__(self, enabled: bool = False, max_spans: int = 200_000,
                 fenced: bool = False, codec: bool = False):
        self.enabled = enabled
        self.fenced = fenced
        self.codec = codec
        self.max_spans = max_spans
        self.dropped = 0
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    # ---- recording ------------------------------------------------------- #

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(sp)
            else:
                self.dropped += 1

    def span(self, name: str, lane: str = "main", **args):
        """A context-manager span; no-op (and allocation-free beyond the
        call itself) when the tracer is disabled."""
        if not self.enabled:
            return _NOOP
        return _SpanCM(self, name, lane, args)

    def begin(self, name: str, lane: str = "main", parent: Span = None,
              t0: float = None, **args):
        """Open a detached span (not on the nesting stack — safe to end from
        another thread).  ``t0`` overrides the start stamp for spans whose
        boundary was clocked elsewhere.  Returns None when disabled."""
        if not self.enabled:
            return None
        sp = Span(next(self._ids), name, lane, _now() if t0 is None else t0,
                  parent.sid if parent is not None else 0, args)
        return sp

    def end(self, sp, t1: float = None, **args) -> None:
        """Close a span from :meth:`begin` (None-safe).  ``t1`` overrides
        the end stamp; extra kwargs merge into the span's args."""
        if sp is None:
            return
        sp.t1 = _now() if t1 is None else t1
        if args:
            sp.args.update(args)
        self._record(sp)

    # ---- device fencing --------------------------------------------------- #

    def fence(self, *values) -> None:
        """With ``fenced`` sampling on, wait for the card to finish the work
        behind the given CUDA tensors, so the enclosing span's duration is
        the kernel's true wall-clock rather than launch time.  A no-op
        otherwise (and for CPU tensors, which are computed eagerly) — the
        resident paths' zero-sync discipline is untouched by default."""
        if not (self.enabled and self.fenced):
            return
        for v in values:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                torch.cuda.synchronize(v.device)

    # ---- access ----------------------------------------------------------- #

    def spans(self) -> list:
        """Snapshot of the finished spans (chronological by completion)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


# process-global tracer for deep engine / kernel spans; disabled by default
_TRACER = Tracer(enabled=False)
_OFF = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER


def codec_tracer() -> Tracer:
    """The tracer the codec layer's per-call spans go to: the process-global
    one where its ``codec`` switch is on, else a disabled one."""
    return _TRACER if _TRACER.codec else _OFF


def set_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer


def enable_tracing(enabled: bool = True, fenced: bool = False,
                   codec: bool = False) -> Tracer:
    """Toggle the process-global tracer (engine + kernel spans; with
    ``codec`` the codec layer's per-call spans too)."""
    _TRACER.enabled = enabled
    _TRACER.fenced = fenced
    _TRACER.codec = codec
    return _TRACER


# --------------------------------------------------------------------------- #
# Chrome trace-event export (Perfetto-loadable)
# --------------------------------------------------------------------------- #

def _iter_spans(sources) -> list:
    out = []
    for src in sources:
        out.extend(src.spans() if isinstance(src, Tracer) else src)
    return [sp for sp in out if sp.t1 is not None]


def to_chrome_trace(*sources) -> dict:
    """Export spans (from :class:`Tracer` objects and/or span iterables)
    as Chrome trace-event JSON — load the dumped file directly at
    https://ui.perfetto.dev.

    Schema (the documented contract the JAX package's ``tests/test_obs.py`` round-trips):

    * top level: ``{"traceEvents": [...], "displayTimeUnit": "ms"}``
    * one complete event (``"ph": "X"``) per span: ``name``, ``cat`` (the
      span name's first ``/`` segment), ``ts`` / ``dur`` (microseconds,
      ``ts`` relative to the earliest span), ``pid`` (always 1), ``tid``
      (one lane — shard / placement / serve — per thread track), and
      ``args`` carrying the span's kwargs plus ``sid`` / ``parent_sid``.
    * one metadata event (``"ph": "M"``) naming the process and each lane's
      thread track.
    """
    spans = _iter_spans(sources)
    events = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
               "args": {"name": "repro-index-serving"}}]
    lanes = sorted({sp.lane for sp in spans})
    tid_of = {lane: i + 1 for i, lane in enumerate(lanes)}
    for lane in lanes:
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid_of[lane], "args": {"name": lane}})
    t_base = min((sp.t0 for sp in spans), default=0.0)
    for sp in sorted(spans, key=lambda s: s.t0):
        args = {str(k): v for k, v in sp.args.items()}
        args["sid"] = sp.sid
        args["parent_sid"] = sp.parent_sid
        events.append({
            "name": sp.name,
            "cat": sp.name.split("/", 1)[0],
            "ph": "X",
            "ts": round((sp.t0 - t_base) * 1e6, 3),
            "dur": round(sp.dur * 1e6, 3),
            "pid": 1,
            "tid": tid_of[sp.lane],
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_coverage(spans, parent: str = "serve/batch",
                   children: tuple = ("serve/plan", "serve/execute",
                                      "serve/deliver")) -> float:
    """Fraction of total ``parent``-span wall-clock covered by the given
    child span names (children attributed by ``parent_sid``).  The smoke
    gate asserts this >= 0.9: the exported trace accounts for at least 90%
    of measured batch wall-clock."""
    spans = _iter_spans([spans])
    parents = {sp.sid: sp for sp in spans if sp.name == parent}
    total = sum(sp.dur for sp in parents.values())
    if total <= 0.0:
        return 0.0
    covered = sum(sp.dur for sp in spans
                  if sp.name in children and sp.parent_sid in parents)
    return min(covered / total, 1.0)
