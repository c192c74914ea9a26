"""Reading a traced part of the window: the device's activity from a
``torch.profiler`` record, the host's from the program's spans.

A profiled part is reduced once, when it ends, to a plain record (kernel
times by name, busy and idle seconds, idle time by what the host was
doing: the innermost program span open, else whether it was inside a
request), which the per-layer readers in ``portbench/metrics/`` read.  The
program's spans are stamped by ``time.monotonic``; the profiler's events
by its own clock, in microseconds from the trace's start.  A
``record_function`` range opened by the harness right after a monotonic
stamp ties the two together.
"""

from __future__ import annotations

ANCHOR = "portbench/profiled"
HOST_IDLE = "between requests"     # the gaps no request or span covers
IN_REQUEST = "in a request"         # inside a request, no program span open


def raw_events(prof) -> list:
    """(name, on the device, start_us, end_us, annotation) of every event of
    a finished ``torch.profiler.profile``, microseconds from the trace's
    start.  Read from the profiler's raw (kineto) record: building its
    ``events()`` takes minutes for the million events of a launch-bound
    part, this seconds."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
             e.is_user_annotation()) for e in res.events()]


def device_events(events: list) -> list:
    """(name, start_us, end_us) of each operation the device ran: kernels,
    copies and memsets, without the profiler's mirrored annotations."""
    return [(n, s, e) for n, dev, s, e, note in events
            if dev and not note and n != ANCHOR]


def anchor_us(events: list) -> float:
    """The start, on the profiler's clock, of the harness's anchor range."""
    for n, dev, s, _, _ in events:
        if n == ANCHOR and not dev:
            return s
    raise RuntimeError(f"the profiler's record holds no {ANCHOR!r} range")


def busy_and_gaps(ops: list, lo: float, hi: float) -> tuple:
    """(busy microseconds, idle gaps as (start, end)) of the device over
    [lo, hi]: the union of the operations' intervals, and its complement."""
    busy, gaps, cur = 0.0, [], lo
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def host_label(spans: list, t_us: float, offset_us: float) -> str:
    """The innermost program span open at ``t_us`` (profiler clock), or
    :data:`HOST_IDLE`.  ``spans``: (name, t0, t1, sid, parent_sid, args),
    monotonic seconds; ``offset_us`` maps them onto the profiler's clock."""
    best = None
    for name, t0, t1, *_ in spans:
        a, b = t0 * 1e6 + offset_us, t1 * 1e6 + offset_us
        if a <= t_us < b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else HOST_IDLE


def summarize(events: list, anchor_mono_s: float, window_s: float,
              spans: list) -> dict:
    """The profiled part's plain record: ``busy_s``, ``window_s``,
    ``kernels`` {name: [count, seconds]} (copies and memsets included),
    ``launches`` (kernels alone) and ``idle_by_host`` {label: seconds}."""
    ops = device_events(events)
    lo = anchor_us(events)
    hi = lo + window_s * 1e6
    busy, gaps = busy_and_gaps(ops, lo, hi)
    offset = lo - anchor_mono_s * 1e6
    idle = {}
    for s, e in gaps:
        label = host_label(spans, (s + e) / 2, offset)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    kernels = {}
    for name, s, e in ops:
        c = kernels.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (e - s) / 1e6
    launches = sum(c[0] for n, c in kernels.items()
                   if not n.startswith(("Memcpy", "Memset")))
    return {"busy_s": busy / 1e6, "window_s": window_s, "kernels": kernels,
            "launches": launches, "idle_by_host": idle}


def top(table: dict, n: int = 10, key=lambda v: v) -> list:
    """The ``n`` largest entries of ``table`` as [name, value] pairs."""
    return [[k, key(v)] for k, v in
            sorted(table.items(), key=lambda kv: -key(kv[1]))[:n]]


def span_rows(spans) -> list:
    """The program's ``Span`` objects as plain tuples (name, t0, t1, sid,
    parent_sid, args)."""
    return [(s.name, s.t0, s.t1, s.sid, s.parent_sid, dict(s.args))
            for s in spans if s.t1 is not None]


# --------------------------------------------------------------------------- #
# readings of a traced window's record (the per-layer readers' helpers)
# --------------------------------------------------------------------------- #


def idle_pct(rec: dict):
    """The share of the profiled part in which the device ran nothing."""
    prof = rec.get("profiled")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def peak_gib(rec: dict):
    b = rec.get("peak_bytes")
    return None if b is None else b / 2**30
